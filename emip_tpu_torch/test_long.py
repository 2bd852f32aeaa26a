"""Long-term streaming inference on the port: per-video PNG masks with the
memory carried.

    python -m emip_tpu_torch.test_long --config configs/emip.yaml \
        [--ckpt DIR] [--save_path ./predictions_long] \
        [--data NAME=PATH ...] [--device cuda]

Mirrors the repository's ``test_long.py`` for the JAX package: frame 0
takes the short-term prediction (paired with frame 1); frames 1..T-1 take
the memory-prompted long head with the rolling key / value buffer carried
across steps. ``--ckpt`` is a checkpoint directory written by
``python -m emip_tpu_torch.train_long``; without it the model runs on the
config's ``load.long_path`` snapshot where that file exists, else on
seeded random weights (``seed``). Without
``--data`` the config's validation split is predicted. Runs on the GPU
(``--device``, default ``cuda``; without a GPU it raises), on the CPU only
with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    from emip_tpu_torch.device import add_device_flag

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/emip.yaml")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory of the trained long model")
    p.add_argument("--save_path", default="./predictions_long")
    p.add_argument("--data", nargs="*", default=None, metavar="NAME=PATH")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.infer import predict_clips_long
    from emip_tpu_torch.train.long import build_long_model
    from emip_tpu_torch.train.loops import CKPT_NAME

    args = parse_args(argv)
    cfg = load_config(args.config)
    # seeded weights, then load.long_path where it exists
    model, _ = build_long_model(cfg, device=args.device)
    if args.ckpt:
        state = torch.load(os.path.join(args.ckpt, CKPT_NAME),
                           map_location=args.device)
        model.load_state_dict(state["model"])
        print(f">>> restored long checkpoint epoch {state['epoch']}")
    model.eval()

    datasets = {}
    if args.data:
        for spec in args.data:
            name, path = spec.split("=", 1)
            datasets[name] = path
    else:
        datasets["MoCA_test"] = cfg.val_dataset.image_path

    frames = 0
    for name, root in datasets.items():
        out = os.path.join(args.save_path, name)
        print(f">>> long inference {name} from {root} -> {out} on "
              f"{args.device}")
        frames += predict_clips_long(
            model, root, out, size=cfg.val_dataset.inp_size,
            dataset_type=(name if "CAD" in name
                          else cfg.val_dataset.dataset_type),
            device=args.device)
    return frames


if __name__ == "__main__":
    main()
