"""Short-term two-stream training on the port.

    python -m emip_tpu_torch.train --config configs/emip.yaml \
        [--resume] [--save_path DIR] [--max_steps_per_epoch N]

Mirrors the repository's ``train.py`` for the JAX package (its
``--multi_host`` flag has no counterpart: the port trains on one card).
The repository holds no checkpoint, so the model starts from seeded
random weights (``seed`` in the config). Runs on the GPU when one is
present, else on the CPU.
"""

from __future__ import annotations

import argparse
import logging

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/emip.yaml")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint (incl. "
                        "optimizer state)")
    p.add_argument("--save_path", default=None,
                   help="override config save_path")
    p.add_argument("--max_steps_per_epoch", type=int, default=None,
                   help="debug: cap steps per epoch")
    return p.parse_args(argv)


def main(argv=None):
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.train.loops import train_short

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    cfg = load_config(args.config)
    if args.save_path:
        cfg.save_path = args.save_path
    _, summary = train_short(cfg, resume=args.resume,
                             max_steps_per_epoch=args.max_steps_per_epoch)
    print(f">>> training done: {summary}")
    return summary


if __name__ == "__main__":
    main()
