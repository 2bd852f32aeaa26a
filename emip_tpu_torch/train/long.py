"""Long-term model training: per-frame steps with the rolling memory.

Counterpart of :mod:`emip_tpu.train.long` (reference ``train_long.py``):
the short-term net is fully frozen; the LTM heads and the fresh
injector / decoder train frame by frame over whole videos, with the
memory's keys and values detached between frames (truncated
backpropagation) and an optimizer step per frame. The model is selected
best-by-S-measure.

One step is one frame of every clip in the group; the frames of a clip
stream in order, the batch axis carries ``clips_per_step`` clips (default
1, what the JAX trainer does on one device). The step goes through
:meth:`EMIPLong.step_cached`: the previous frame's frozen encoding is
carried, so each frame is encoded once. The JAX package's
``make_long_train_scan_step`` (K frames per dispatch under ``lax.scan``)
has no counterpart: PyTorch runs eagerly, and the config's
``long_frames_per_dispatch`` is ignored.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from emip_tpu_torch.config import Config, DatasetConfig, snapshot_config
from emip_tpu_torch.convert import LONG_LOAD, load_configured_weights
from emip_tpu_torch.data import ClipLoader, frames_subdir
from emip_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from emip_tpu_torch.losses.seg import hybrid_e_loss
from emip_tpu_torch.models.emip_long import EMIPLong
from emip_tpu_torch.models.init import seeded_init_
from emip_tpu_torch.train.loops import (
    _to_device,
    save_checkpoint,
    score_logits,
)
from emip_tpu_torch.train.state import (
    build_long_optimizer,
    cosine_epoch_lr,
    set_learning_rate,
)

__all__ = ["build_long_model", "long_train_step", "validate_long",
           "train_long"]

log = logging.getLogger("emip_tpu_torch")


def build_long_model(cfg: Config, short_state_dict: dict | None = None,
                     device: torch.device | str = DEFAULT_DEVICE):
    """(EMIPLong on ``device``, its optimizer) with the short-term net
    frozen.

    The model starts from seeded random weights (``cfg.seed``), then
    takes the config's ``load.long_path`` snapshot where the file exists;
    ``short_state_dict``, the ``state_dict`` of a trained ``EMIPShort``,
    is loaded over it under ``short_term.`` (the reference's
    ``'short_term.' + k`` remap, train_long.py:391-402): keys the target
    has, as in the JAX package.
    """
    device = resolve_device(device)
    model = seeded_init_(EMIPLong(cfg.model, cfg.memory_size), cfg.seed)
    load_configured_weights(model, cfg.load, LONG_LOAD)
    if short_state_dict is not None:
        own = model.short_term.state_dict()
        model.short_term.load_state_dict(
            {k: v for k, v in short_state_dict.items() if k in own},
            strict=False)
    model = model.to(device)
    opt = build_long_optimizer(model, cfg.lr, cfg.weight_decay, cfg.clip)
    return model, opt


def long_train_step(model: EMIPLong, opt, enc_prev: dict,
                    image_cur: torch.Tensor, gt: torch.Tensor, state):
    """One frame: forward in train mode (the short-term net stays in eval
    mode and takes no gradient), hybrid-E loss on the long mask, backward
    over the long heads (through kernel F's backward on the card),
    clamp + AdamW. Returns (detached metrics, enc_cur, the memory with the
    frame pushed detached)."""
    model.train()
    mask_long, enc_cur, new_state = model.step_cached(enc_prev, image_cur,
                                                      state)
    loss = hybrid_e_loss(mask_long, gt)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return dict(loss=loss.detach()), enc_cur, new_state


@torch.no_grad()
def validate_long(model: EMIPLong, cfg: Config, device,
                  max_items: int | None = None,
                  dataset: DatasetConfig | None = None) -> dict:
    """Per-frame long-model validation: Sm / wFm / MAE over the frames
    from frame 1 of every clip, at the native GT resolution
    (:func:`score_logits`, as the short validation).
    ``dataset`` overrides the val split (the CAD pass)."""
    ds = dataset if dataset is not None else cfg.val_dataset
    loader = ClipLoader(ds.image_path, ds.gt_path, size=ds.inp_size,
                        dataset_type=ds.dataset_type)
    model.eval()
    scores = []
    for ci, clip in enumerate(loader):
        if max_items is not None and ci >= max_items:
            break
        frames = _to_device(clip["frames"], device)
        mem = model.init_memory(1)
        enc = model.encode_frame(frames[0:1])
        for t in range(1, len(frames)):
            mask, enc, mem = model.step_cached(enc, frames[t:t + 1], mem)
            scores.append(score_logits(mask[0, 0].float().cpu().numpy(),
                                       clip["gts"][t]))
    if not scores:
        # an empty split (e.g. the wrong frames subdir for the dataset
        # type) is reported, not averaged to NaN
        log.warning("validate_long: 0 clips under %s (dataset_type=%s "
                    "expects a '%s' frames subdir); skipping metrics",
                    ds.image_path, ds.dataset_type,
                    frames_subdir(ds.dataset_type))
        return {}
    return {k: float(np.mean([s[k] for s in scores]))
            for k in ("Sm", "wFm", "MAE")}


def _clip_groups(loader, group: int, max_videos: int | None,
                 max_frames: int | None):
    """Stacked clip groups (frames [group, T_min, S, S, 3], masks
    [group, T_min, S, S, 1]): the clips of a group are cut to its shortest
    so that the frame loop runs in lockstep; with ``group == 1`` this is
    the reference's clip-by-clip schedule. A trailing partial group is
    dropped."""
    buf = []
    for vi, clip in enumerate(loader):
        if max_videos is not None and vi >= max_videos:
            break
        buf.append(clip)
        if len(buf) == group:
            t_min = min(len(c["frames"]) for c in buf)
            if max_frames is not None:
                t_min = min(t_min, max_frames)
            yield (np.stack([c["frames"][:t_min] for c in buf]),
                   np.stack([c["masks"][:t_min] for c in buf]))
            buf = []
    if buf:
        log.info("train_long: dropping %d trailing clip(s) (< group of %d)",
                 len(buf), group)


def train_long(cfg: Config, short_state_dict: dict | None = None,
               max_videos_per_epoch: int | None = None,
               max_frames_per_video: int | None = None,
               clips_per_step: int = 1,
               device: torch.device | str = DEFAULT_DEVICE
               ) -> tuple[EMIPLong, dict]:
    """Train the long heads for epochs ``1..cfg.epoch - 1`` on ``device``
    (default: the GPU; raises without one): cosine LR per epoch, one
    optimizer step per frame, a checkpoint per ``epoch_save`` under
    ``ckpt_long`` and the best-by-S-measure one under ``ckpt_long_best``.
    Returns the model and a summary."""
    device = resolve_device(device)
    snapshot_config(cfg, cfg.save_path)
    scalars = open(os.path.join(cfg.save_path, "scalars.jsonl"), "a")
    model, opt = build_long_model(cfg, short_state_dict, device)
    td = cfg.train_dataset
    loader = ClipLoader(td.image_path, td.gt_path, size=td.inp_size,
                        dataset_type=td.dataset_type, shuffle=True,
                        seed=cfg.seed)
    lr_fn = cosine_epoch_lr(cfg.lr, cfg.lr_min, cfg.epoch_max)
    ckpt_dir = os.path.join(cfg.save_path, "ckpt_long")
    best_dir = os.path.join(cfg.save_path, "ckpt_long_best")

    def record(**kv):
        scalars.write(json.dumps(kv) + "\n")
        scalars.flush()

    best_sm, best_epoch, steps = -1.0, 0, 0
    for epoch in range(1, cfg.epoch):
        lr = lr_fn(epoch)
        set_learning_rate(opt, lr)
        t0 = time.perf_counter()
        for frames, masks in _clip_groups(loader, clips_per_step,
                                          max_videos_per_epoch,
                                          max_frames_per_video):
            mem = model.init_memory(clips_per_step)
            enc = model.encode_frame(_to_device(frames[:, 0], device))
            for t in range(1, frames.shape[1]):
                metrics, enc, mem = long_train_step(
                    model, opt, enc, _to_device(frames[:, t], device),
                    _to_device(masks[:, t], device), mem)
                steps += 1
            record(epoch=epoch, step=steps, lr=lr,
                   loss_long=float(metrics["loss"]))
        record(epoch=epoch, epoch_s=time.perf_counter() - t0)

        if cfg.epoch_save and epoch % cfg.epoch_save == 0:
            save_checkpoint(ckpt_dir, model, opt, epoch)
        if cfg.epoch_val and epoch % cfg.epoch_val == 0:
            val = validate_long(model, cfg, device)
            record(epoch=epoch, **{f"val_long_{k}": v
                                   for k, v in val.items()})
            log.info("[Val-long] epoch %d %s", epoch, val)
            if cfg.val_dataset_cad is not None:
                cad = validate_long(model, cfg, device,
                                    dataset=cfg.val_dataset_cad)
                record(epoch=epoch, **{f"val_long_cad_{k}": v
                                       for k, v in cad.items()})
                log.info("[Val-long-CAD] epoch %d %s", epoch, cad)
            if val.get("Sm", float("-inf")) > best_sm:
                best_sm, best_epoch = val["Sm"], epoch
                save_checkpoint(best_dir, model, opt, epoch)
    scalars.close()
    return model, dict(best_sm=best_sm, best_epoch=best_epoch, steps=steps)
