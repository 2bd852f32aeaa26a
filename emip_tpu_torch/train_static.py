"""Static-image pretraining of the segmentation stream on the port.

    python -m emip_tpu_torch.train_static --config configs/emip.yaml \
        --data_root DIR [--save_path DIR] [--max_steps_per_epoch N] \
        [--device cuda]

Mirrors the repository's ``train_static.py`` for the JAX package, plus
``--device``: :func:`emip_tpu_torch.train.static.train_static` on a
COD10K-style root (``Imgs/`` + ``GT/``) at ``model.inp_size``, batch
``train_dataset.batch_size``, computing in ``compute_dtype`` (bfloat16
when the key is missing). The default ``--save_path`` is
``<save_path of the config>/static``; checkpoints go to its ``ckpt/``.
Runs on the GPU (``--device``, default ``cuda``; without a GPU it raises
before it writes anything), on the CPU only with ``--device cpu``. Under
``torchrun --nproc_per_node N`` (or SLURM) it joins the launch's process
group and trains data-parallel (:mod:`emip_tpu_torch.parallel`).
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
    p.add_argument("--data_root", required=True,
                   help="COD10K-style root with Imgs/ + GT/")
    p.add_argument("--save_path", default=None)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.parallel import init_distributed, shutdown_distributed
    from emip_tpu_torch.train.static import train_static

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = init_distributed(args.device)  # the launch's group, if any
    try:
        cfg = load_config(args.config)
        save_path = args.save_path or os.path.join(cfg.save_path, "static")
        _, summary = train_static(cfg, args.data_root, save_path,
                                  args.max_steps_per_epoch, device=device)
    finally:
        shutdown_distributed()
    print(f">>> static pretrain done: {summary}")
    return summary


if __name__ == "__main__":
    main()
