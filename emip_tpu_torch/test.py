"""Short-term batch inference on the port: dump per-video PNG masks.

    python -m emip_tpu_torch.test --config configs/emip.yaml \
        [--ckpt DIR] [--save_path ./predictions] \
        [--data NAME=PATH ...] [--batch_size 8] [--device cuda]

    torchrun --nproc_per_node N -m emip_tpu_torch.test --multi_host ...

Mirrors the repository's ``test.py`` for the JAX package. The model is
``model`` of the config, at ``val_dataset.inp_size``. Its weights are, in
order: seeded random ones (``seed``), the checkpoints of the config's
``load`` block where the files exist (``path``: a full EMIP snapshot,
``flow_path``: a GMFlow one), and with ``--ckpt`` the model of the
``ckpt.pt`` that ``python -m emip_tpu_torch.train`` writes into that
directory. Without ``--data`` the config's validation split is predicted
as ``MoCA_test``; a dataset whose name holds ``CAD`` is read as CAD,
others as ``val_dataset.dataset_type``. Predictions are written to
``<save_path>/<dataset>/<video>/<frame>.png``. The model computes in the
config's ``compute_dtype`` (bfloat16 when the key is missing, as in the
JAX package; kernels A-D in their bf16 forwards) or float32. It runs on
the GPU (``--device``, default ``cuda``; without a GPU it raises) and on
the CPU, through the plain versions, only with ``--device cpu``. With
``--multi_host`` it joins the process group of a torchrun (or SLURM)
launch, one process per card, and each rank predicts and writes its share
of the pairs (:func:`emip_tpu_torch.infer.predict_pairs`); without a
rendezvous it raises.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["parse_args", "load_short_model", "main"]


def parse_args(argv=None):
    from emip_tpu_torch.device import add_device_flag
    from emip_tpu_torch.parallel import add_multi_host_flag

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/emip.yaml")
    p.add_argument("--save_path", default="./predictions")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory written by "
                        "python -m emip_tpu_torch.train (holds ckpt.pt)")
    p.add_argument("--data", nargs="*", default=None, metavar="NAME=PATH",
                   help="datasets to predict, e.g. MoCA_test=/data/MoCA")
    p.add_argument("--batch_size", type=int, default=8)
    add_multi_host_flag(p)
    add_device_flag(p)
    return p.parse_args(argv)


def load_short_model(cfg, ckpt, device):
    """The eval-mode ``EMIPShort`` of ``cfg`` on ``device``, computing in
    ``cfg.compute_dtype``: seeded weights, then the config's ``load``
    block, then ``<ckpt>/ckpt.pt`` when ``ckpt`` names a directory (the
    fp32 state dict either way)."""
    import torch

    from emip_tpu_torch.convert import SHORT_LOAD, load_configured_weights
    from emip_tpu_torch.dtypes import dtype_named
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.loops import CKPT_NAME

    model = seeded_init_(
        EMIPShort(cfg.model, dtype=dtype_named(cfg.compute_dtype)), cfg.seed)
    load_configured_weights(model, cfg.load, SHORT_LOAD)
    if ckpt:
        state = torch.load(os.path.join(ckpt, CKPT_NAME), map_location="cpu")
        model.load_state_dict(state["model"])
        print(f">>> restored checkpoint epoch {state['epoch']} from {ckpt}")
    return model.to(device).eval()


def main(argv=None):
    from emip_tpu_torch.parallel import init_distributed, shutdown_distributed

    args = parse_args(argv)
    device = init_distributed(args.device, multi_host=args.multi_host)
    try:
        _predict(args, device)
    finally:
        shutdown_distributed()


def _predict(args, device) -> None:
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.infer import predict_pairs

    cfg = load_config(args.config)
    model = load_short_model(cfg, args.ckpt, device)

    datasets = {}
    if args.data:
        for spec in args.data:
            name, root = spec.split("=", 1)
            datasets[name] = root
    else:
        datasets["MoCA_test"] = cfg.val_dataset.image_path
    for name, root in datasets.items():
        out = os.path.join(args.save_path, name)
        print(f">>> predicting {name} from {root} -> {out} on {device}")
        predict_pairs(model, root, out, size=cfg.val_dataset.inp_size,
                      dataset_type=(name if "CAD" in name
                                    else cfg.val_dataset.dataset_type),
                      batch_size=args.batch_size, device=device)


if __name__ == "__main__":
    main()
