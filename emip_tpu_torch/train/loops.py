"""Short-term training loop with in-loop validation.

Counterpart of :mod:`emip_tpu.train.loops` (reference ``train.py``):
per-epoch cosine LR (stepped before the epoch), per-step loss logging,
validation computing wFm / Sm / MAE over the val split at native GT
resolution, best-by-MAE checkpointing, ``torch.save`` checkpoints with
optimizer state and resume, and a save on interrupt. Runs on the GPU
unless the caller names another device; without a GPU the default raises.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from emip_tpu_torch.config import Config, snapshot_config
from emip_tpu_torch.convert import SHORT_LOAD, load_configured_weights
from emip_tpu_torch.data import PairEvalLoader, PairTrainLoader
from emip_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from emip_tpu_torch.infer import _linear_weights
from emip_tpu_torch.losses.seg import hybrid_e_loss
from emip_tpu_torch.metrics import frame_scores
from emip_tpu_torch.models.emip_short import EMIPShort
from emip_tpu_torch.models.init import seeded_init_
from emip_tpu_torch.train.short import short_eval_step, short_train_step
from emip_tpu_torch.train.state import (
    build_optimizer,
    cosine_epoch_lr,
    set_learning_rate,
)

__all__ = ["save_checkpoint", "load_checkpoint", "score_logits",
           "validate_short", "train_short"]

log = logging.getLogger("emip_tpu_torch")

CKPT_NAME = "ckpt.pt"
VAL_BATCH = 8  # validation pairs per forward


def save_checkpoint(directory: str, model, opt, epoch: int) -> None:
    """Model + optimizer state; written to a temporary name, then renamed,
    so an interrupted save leaves the previous checkpoint whole."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CKPT_NAME)
    torch.save(dict(model=model.state_dict(), optimizer=opt.state_dict(),
                    epoch=epoch), path + ".tmp")
    os.replace(path + ".tmp", path)


def load_checkpoint(directory: str, model, opt) -> int:
    """Restore model and optimizer state; returns the saved epoch."""
    state = torch.load(os.path.join(directory, CKPT_NAME),
                       map_location=next(model.parameters()).device)
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    return int(state["epoch"])


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                            ).to(device)


def score_logits(logits_hw: np.ndarray, gt: np.ndarray) -> dict:
    """wFm / Sm / MAE of one frame: the logits resized (bilinear,
    align_corners=False) to the native GT size, passed through a sigmoid
    and min-max normalised, as in the reference (train.py:131-137)."""
    up = _linear_weights(logits_hw.shape[0], gt.shape[0]) @ logits_hw @ \
        _linear_weights(logits_hw.shape[1], gt.shape[1]).T
    pred = 1.0 / (1.0 + np.exp(-up))
    pred = (pred - pred.min()) / (pred.max() - pred.min() + 1e-8)
    return frame_scores(pred * 255.0, gt)


def validate_short(model, cfg: Config, device) -> dict:
    """wFm / Sm / MAE / val-loss over the validation split.

    Each frame is scored by :func:`score_logits`; the metrics are those of
    :mod:`emip_tpu_torch.metrics`.
    """
    vd = cfg.val_dataset
    loader = PairEvalLoader(vd.image_path, vd.gt_path, size=vd.inp_size,
                            dataset_type=vd.dataset_type)
    val_loss, n, chunk, scores = 0.0, 0, [], []

    def flush(chunk):
        nonlocal val_loss, n
        k = len(chunk)
        img1 = np.stack([r["image1"] for r in chunk])
        img2 = np.stack([r["image2"] for r in chunk])
        if k < VAL_BATCH:  # pad to the batch size
            img1 = np.concatenate([img1, img1[-1:].repeat(VAL_BATCH - k, 0)])
            img2 = np.concatenate([img2, img2[-1:].repeat(VAL_BATCH - k, 0)])
        logits = short_eval_step(model, _to_device(img1, device),
                                 _to_device(img2, device))[:k].float().cpu()
        gts = torch.from_numpy(np.stack([r["gt_resized"] for r in chunk])
                               ).permute(0, 3, 1, 2)
        for i in range(k):
            val_loss += float(hybrid_e_loss(logits[i:i + 1], gts[i:i + 1]))
        n += k
        for rec, lg in zip(chunk, logits[:, 0].numpy()):
            scores.append(score_logits(lg, rec["gt"]))

    for rec in loader:
        chunk.append(rec)
        if len(chunk) == VAL_BATCH:
            flush(chunk)
            chunk = []
    if chunk:
        flush(chunk)
    out = {k: float(np.mean([s[k] for s in scores])) for k in
           ("wFm", "Sm", "MAE")}
    return dict(out, val_loss=val_loss / max(n, 1))


def train_short(cfg: Config, resume: bool = False,
                max_steps_per_epoch: int | None = None,
                device: torch.device | str = DEFAULT_DEVICE
                ) -> tuple[EMIPShort, dict]:
    """Train for epochs ``start..cfg.epoch - 1`` (the reference's
    ``range(1, epoch)``) on ``device`` (default: the GPU; raises without
    one); returns the model and a summary. The model starts from seeded
    random weights, then takes the checkpoints the config's ``load`` block
    names (``path``, ``flow_path``) where the files exist."""
    device = resolve_device(device)
    snapshot_config(cfg, cfg.save_path)
    scalars = open(os.path.join(cfg.save_path, "scalars.jsonl"), "a")
    model = seeded_init_(EMIPShort(cfg.model), cfg.seed)
    load_configured_weights(model, cfg.load, SHORT_LOAD)
    model = model.to(device)
    opt = build_optimizer(model, cfg.lr, cfg.weight_decay, cfg.clip)
    ckpt_dir = os.path.join(cfg.save_path, "ckpt")
    best_dir = os.path.join(cfg.save_path, "ckpt_best")
    start_epoch = 1
    if resume and os.path.exists(os.path.join(ckpt_dir, CKPT_NAME)):
        start_epoch = load_checkpoint(ckpt_dir, model, opt) + 1
        log.info("resumed from epoch %d", start_epoch - 1)

    td = cfg.train_dataset
    loader = PairTrainLoader(td.image_path, td.gt_path, td.batch_size,
                             size=td.inp_size, dataset_type=td.dataset_type,
                             seed=cfg.seed, augment=td.augment)
    lr_fn = cosine_epoch_lr(cfg.lr, cfg.lr_min, cfg.epoch_max)
    gen_device = device if device.type == "cuda" else "cpu"
    generator = torch.Generator(device=gen_device).manual_seed(cfg.seed)

    def record(**kv):
        scalars.write(json.dumps(kv) + "\n")
        scalars.flush()

    best_mae, best_epoch, steps, last = float("inf"), 0, 0, {}
    for epoch in range(start_epoch, cfg.epoch):
        lr = lr_fn(epoch)
        set_learning_rate(opt, lr)
        t0, epoch_loss, epoch_steps = time.perf_counter(), None, 0
        try:
            for i, batch in enumerate(loader, start=1):
                if max_steps_per_epoch is not None and i > max_steps_per_epoch:
                    break
                batch = dict(image1=_to_device(batch["image1"], device),
                             image2=_to_device(batch["image2"], device),
                             gt=_to_device(batch["gt"], device))
                metrics = short_train_step(model, opt, batch, generator)
                steps += 1
                epoch_steps += 1
                epoch_loss = (metrics["loss"] if epoch_loss is None
                              else epoch_loss + metrics["loss"])
                if i % 20 == 0 or i == 1:
                    last = {k: float(v) for k, v in metrics.items()}
                    log.info("[Train] epoch %d step %d loss %.4f pred %.4f "
                             "flow %.4f", epoch, i, last["loss"],
                             last["loss_pred"], last["loss_flow"])
                    record(epoch=epoch, step=steps, lr=lr, **last)
        except KeyboardInterrupt:
            save_checkpoint(ckpt_dir, model, opt, epoch)
            raise
        dt = time.perf_counter() - t0
        if epoch_steps:
            record(epoch=epoch, epoch_mean_loss=float(epoch_loss) / epoch_steps,
                   epoch_s=dt, steps_per_s=epoch_steps / dt)
        if cfg.epoch_save and epoch % cfg.epoch_save == 0:
            save_checkpoint(ckpt_dir, model, opt, epoch)
        if cfg.epoch_val and epoch % cfg.epoch_val == 0:
            val = validate_short(model, cfg, device)
            record(epoch=epoch, **{f"val_{k}": v for k, v in val.items()})
            log.info("[Val] epoch %d %s", epoch, val)
            if val["MAE"] < best_mae:
                best_mae, best_epoch = val["MAE"], epoch
                save_checkpoint(best_dir, model, opt, epoch)
    scalars.close()
    return model, dict(best_mae=best_mae, best_epoch=best_epoch, steps=steps,
                       last=last)
