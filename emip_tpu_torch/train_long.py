"""Long-term (space-time-memory) training on the port.

    python -m emip_tpu_torch.train_long --config configs/emip.yaml \
        [--short_ckpt DIR] [--save_path DIR] [--device cuda] \
        [--max_videos_per_epoch N] [--max_frames_per_video N]

Mirrors the repository's ``train_long.py`` for the JAX package: the
short-term net is loaded under the frozen ``short_term`` subtree
(``--short_ckpt``: a checkpoint directory written by
``python -m emip_tpu_torch.train``; without it the seeded random weights
stay, since the repository holds no checkpoint) and the LTM and long
decoder heads train frame by frame over whole videos with a rolling,
detached memory, computing in the config's ``compute_dtype`` (bfloat16
when the key is missing; parameters, optimizer state and checkpoints stay
fp32). The log goes to ``<save_path>/train_long_log.log``.
Runs on the GPU (``--device``, default ``cuda``; without
a GPU it raises), on the CPU only with ``--device cpu``. Under ``torchrun
--nproc_per_node N`` (or SLURM) it joins the launch's process group and
trains data-parallel, each rank on its shard of the clips
(:mod:`emip_tpu_torch.parallel`).
"""

from __future__ import annotations

import argparse
import logging
import os

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    from emip_tpu_torch.device import add_device_flag

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/emip.yaml")
    p.add_argument("--short_ckpt", default=None,
                   help="checkpoint directory of the trained short-term "
                        "model")
    p.add_argument("--save_path", default=None,
                   help="override config save_path")
    p.add_argument("--max_videos_per_epoch", type=int, default=None,
                   help="debug: cap videos per epoch")
    p.add_argument("--max_frames_per_video", type=int, default=None,
                   help="debug: cap frames per video")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.parallel import init_distributed, shutdown_distributed
    from emip_tpu_torch.train.long import train_long
    from emip_tpu_torch.train.loops import CKPT_NAME

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = init_distributed(args.device)  # the launch's group, if any
    try:
        cfg = load_config(args.config)
        if args.save_path:
            cfg.save_path = args.save_path
        short = None
        if args.short_ckpt:
            state = torch.load(os.path.join(args.short_ckpt, CKPT_NAME),
                               map_location="cpu")
            short = state["model"]
            print(f">>> loaded short-term checkpoint epoch {state['epoch']}")
        _, summary = train_long(cfg, short, args.max_videos_per_epoch,
                                args.max_frames_per_video, device=device)
    finally:
        shutdown_distributed()
    print(f">>> long training done: {summary}")
    return summary


if __name__ == "__main__":
    main()
