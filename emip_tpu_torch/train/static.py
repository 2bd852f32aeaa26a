"""Static-image pretraining of the segmentation stream.

Counterpart of the repository's root ``train_static.py`` for the JAX
package (BASELINE.json configuration #2: the segmentation stream on a
COD10K-style image / GT tree, no flow stream): :class:`SegNetwork` from
seeded weights, the hybrid-E loss, the element-wise clamp + AdamW of the
short trainer, and a cosine LR set once per epoch over the reference's
``range(1, epoch)``. One ``ckpt.pt`` (model and optimizer) is written per
epoch under ``<save_path>/ckpt``; the log goes to
``train_static_log.log`` and the scalars ``loss/static`` and
``time/epoch_s`` to ``scalars.jsonl``. The model computes in the config's
``compute_dtype`` (bfloat16 by default, as the JAX package's trainer
builds ``SegNetwork(dtype=...)``); parameters, optimizer state and
checkpoints stay fp32. On the card the backbone runs kernel A forward and
backward, in that dtype (and J where ``fused_ffn`` asks for it: fp32
only). Under data parallelism (:mod:`emip_tpu_torch.parallel`) each rank
takes its shard of every epoch through ``DistributedDataParallel``, with
the BatchNorm statistics of the whole batch; the first rank alone writes.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from emip_tpu_torch.config import Config, warn_fsdp_ignored
from emip_tpu_torch.data import StaticImageLoader
from emip_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from emip_tpu_torch.dtypes import dtype_named
from emip_tpu_torch.losses.seg import hybrid_e_loss
from emip_tpu_torch.models.emip_short import SegNetwork
from emip_tpu_torch.models.init import seeded_init_
from emip_tpu_torch.parallel import (
    all_reduce_mean,
    barrier,
    data_parallel,
    default_shard,
    is_primary,
)
from emip_tpu_torch.train.loops import _to_device, save_checkpoint
from emip_tpu_torch.train.state import (
    ClampAdamW,
    cosine_epoch_lr,
    set_learning_rate,
)
from emip_tpu_torch.utils.logging import ScalarLogger, setup_logging

__all__ = ["build_seg_model", "static_train_step", "train_static"]

log = logging.getLogger("emip_tpu_torch")


def build_seg_model(cfg: Config, device) -> SegNetwork:
    """The config's backbone and ``channel`` as a seeded SegNetwork on
    ``device``, computing in the config's ``compute_dtype``."""
    m = cfg.model
    model = SegNetwork(m.backbone_name, m.channel, fused_ffn=m.fused_ffn,
                       ffn_dwconv=m.ffn_dwconv,
                       dtype=dtype_named(cfg.compute_dtype))
    return seeded_init_(model, cfg.seed).to(device)


def static_train_step(model, opt, batch: dict, generator=None
                      ) -> torch.Tensor:
    """One optimisation step on NCHW ``image`` / ``gt``; returns the
    detached loss (no host sync)."""
    model.train()
    loss = hybrid_e_loss(model(batch["image"], generator), batch["gt"])
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train_static(cfg: Config, data_root: str, save_path: str,
                 max_steps_per_epoch: int | None = None,
                 device: torch.device | str = DEFAULT_DEVICE
                 ) -> tuple[SegNetwork, dict]:
    """Pretrain for epochs ``1..cfg.epoch - 1`` on ``device`` (default:
    the GPU; raises without one); returns the model and a summary. In a
    process group of more than one rank each rank steps its shard through
    ``DistributedDataParallel`` and the first rank alone writes."""
    device = resolve_device(device)
    primary = is_primary()
    if primary:
        setup_logging(save_path, "train_static_log.log")
        warn_fsdp_ignored(cfg, "train_static")
    model = build_seg_model(cfg, device)
    opt = ClampAdamW(model.parameters(), cfg.lr, cfg.weight_decay, cfg.clip)
    step_model = data_parallel(model)
    loader = StaticImageLoader(data_root, cfg.train_dataset.batch_size,
                               size=cfg.model.inp_size, seed=cfg.seed,
                               shard=default_shard())
    lr_fn = cosine_epoch_lr(cfg.lr, cfg.lr_min, cfg.epoch_max)
    gen_device = device if device.type == "cuda" else "cpu"
    generator = torch.Generator(device=gen_device).manual_seed(cfg.seed)
    steps, loss = 0, None
    with ScalarLogger(save_path, enabled=primary) as scalars:
        for epoch in range(1, cfg.epoch):
            set_learning_rate(opt, lr_fn(epoch))
            t0 = time.perf_counter()
            for i, batch in enumerate(loader, start=1):
                if max_steps_per_epoch and i > max_steps_per_epoch:
                    break
                batch = {k: _to_device(v, device) for k, v in batch.items()}
                loss = static_train_step(step_model, opt, batch, generator)
                steps += 1
                if i % 20 == 0 or i == 1:
                    shown = float(all_reduce_mean(loss))  # over the ranks
                    log.info("[Static] epoch %d step %d loss %.4f", epoch, i,
                             shown)
                    scalars.scalar("loss/static", shown, epoch * 100000 + i)
            scalars.scalar("time/epoch_s", time.perf_counter() - t0, epoch)
            if primary:
                save_checkpoint(os.path.join(save_path, "ckpt"), model, opt,
                                epoch)
            barrier()
    return model, dict(steps=steps,
                       last_loss=None if loss is None else float(loss))
