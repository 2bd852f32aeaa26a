"""Short-term two-stream training on the port.

    python -m emip_tpu_torch.train --config configs/emip.yaml \
        [--resume] [--save_path DIR] [--max_steps_per_epoch N] \
        [--device cuda]

Mirrors the repository's ``train.py`` for the JAX package (its
``--multi_host`` flag has no counterpart: the port trains on one card).
The repository holds no checkpoint, so the model starts from seeded
random weights (``seed`` in the config). The model computes in the
config's ``compute_dtype`` (bfloat16 when the key is missing). The log goes to
``<save_path>/train_log.log`` and the scalars to ``scalars.jsonl``. Runs
on the GPU (``--device``,
default ``cuda``; without a GPU it raises), on the CPU only with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    from emip_tpu_torch.device import add_device_flag

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/emip.yaml")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint (incl. "
                        "optimizer state)")
    p.add_argument("--save_path", default=None,
                   help="override config save_path")
    p.add_argument("--max_steps_per_epoch", type=int, default=None,
                   help="debug: cap steps per epoch")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.device import resolve_device
    from emip_tpu_torch.train.loops import train_short

    args = parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = load_config(args.config)
    if args.save_path:
        cfg.save_path = args.save_path
    _, summary = train_short(cfg, resume=args.resume,
                             max_steps_per_epoch=args.max_steps_per_epoch,
                             device=device)
    print(f">>> training done: {summary}")
    return summary


if __name__ == "__main__":
    main()
