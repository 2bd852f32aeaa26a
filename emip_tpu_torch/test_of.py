"""Optical-flow visualisation on the port: the short model's forward flow
of every frame pair as a colour-wheel JPG.

    python -m emip_tpu_torch.test_of --config configs/emip.yaml \
        [--ckpt DIR] [--save_path ./flow_viz] [--data_root DIR] \
        [--dataset_type MoCA] [--device cuda]

    torchrun --nproc_per_node N -m emip_tpu_torch.test_of --multi_host ...

Mirrors the repository's ``test_of.py`` for the JAX package (the
reference's ``test_of.py``), plus ``--device``. The model and its weights
are those of ``python -m emip_tpu_torch.test`` (seeded, the config's
``load`` block, then ``<ckpt>/ckpt.pt``), at ``val_dataset.inp_size``;
without ``--data_root`` the config's validation split is read; the model
computes in the config's ``compute_dtype`` (bfloat16 when it is missing).
``infer.predict_pairs`` runs every pair (its masks go to
``<save_path>/_masks``) and returns the flows; each is rendered by
:func:`emip_tpu_torch.utils.flow_viz.flow_to_image` into
``<save_path>/<video>/<frame>.jpg``. It runs on the GPU (``--device``,
default ``cuda``; without a GPU it raises before it writes anything), on
the CPU only with ``--device cpu``. With ``--multi_host`` it joins the
process group of a torchrun (or SLURM) launch: each rank predicts its
share of the pairs and writes their masks, every rank receives every
flow, and the first rank alone writes the flow images.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    from emip_tpu_torch.device import add_device_flag
    from emip_tpu_torch.parallel import add_multi_host_flag

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/emip.yaml")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory written by "
                        "python -m emip_tpu_torch.train (holds ckpt.pt)")
    p.add_argument("--save_path", default="./flow_viz")
    p.add_argument("--data_root", default=None)
    p.add_argument("--dataset_type", default="MoCA")
    add_multi_host_flag(p)
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of flow images written (by this rank)."""
    from emip_tpu_torch.parallel import (
        init_distributed,
        is_primary,
        shutdown_distributed,
    )

    args = parse_args(argv)
    device = init_distributed(args.device, multi_host=args.multi_host)
    try:
        flows = _render(args, device)  # every rank: a collective
        return len(flows) if is_primary() else 0
    finally:
        shutdown_distributed()


def _render(args, device) -> list:
    """Predict every pair (each rank its share, in a process group), write
    the masks and, on the first rank, the flow images; returns
    ``predict_pairs``' flows, the whole list on every rank."""
    from PIL import Image

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.infer import predict_pairs
    from emip_tpu_torch.parallel import is_primary
    from emip_tpu_torch.test import load_short_model
    from emip_tpu_torch.utils.flow_viz import flow_to_image

    cfg = load_config(args.config)
    model = load_short_model(cfg, args.ckpt, device)
    root = args.data_root or cfg.val_dataset.image_path
    flows = predict_pairs(model, root, os.path.join(args.save_path, "_masks"),
                          size=cfg.val_dataset.inp_size,
                          dataset_type=args.dataset_type, device=device,
                          return_flow=True)
    if not is_primary():
        return flows
    for video, name, flow in flows:
        out_dir = os.path.join(args.save_path, video)
        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(flow_to_image(flow)).save(
            os.path.join(out_dir, name + ".jpg"))
        print(f">>> flow viz saved: {video}/{name}.jpg")
    return flows


if __name__ == "__main__":
    main()
