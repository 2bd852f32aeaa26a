"""Short-term two-stream training on the port.

    python -m emip_tpu_torch.train --config configs/emip.yaml \
        [--resume] [--save_path DIR] [--max_steps_per_epoch N] \
        [--multi_host] [--device cuda]

    torchrun --nproc_per_node N -m emip_tpu_torch.train --multi_host \
        --config configs/emip.yaml

Mirrors the repository's ``train.py`` for the JAX package. With
``--multi_host`` it joins the process group that torchrun (or SLURM, or
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``) describes,
one process per card on ``cuda:LOCAL_RANK`` over NCCL, and trains
data-parallel (:mod:`emip_tpu_torch.parallel`): each rank its shard at the
config's ``batch_size``; without a rendezvous it raises. A multi-process
environment forms the group without the flag too, never N independent
runs. The repository holds no checkpoint, so the model starts from seeded
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
    p.add_argument("--multi_host", action="store_true",
                   help="join the process group of a torchrun / SLURM "
                        "launch (data parallelism, one process per card); "
                        "raises without a rendezvous")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.parallel import init_distributed, shutdown_distributed
    from emip_tpu_torch.train.loops import train_short

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = init_distributed(args.device, multi_host=args.multi_host)
    try:
        cfg = load_config(args.config)
        if args.save_path:
            cfg.save_path = args.save_path
        _, summary = train_short(cfg, resume=args.resume,
                                 max_steps_per_epoch=args.max_steps_per_epoch,
                                 device=device)
    finally:
        shutdown_distributed()
    print(f">>> training done: {summary}")
    return summary


if __name__ == "__main__":
    main()
