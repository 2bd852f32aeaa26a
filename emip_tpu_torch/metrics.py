"""Validation metrics of the short-term training loop (numpy / scipy).

S-measure (Fan et al. 2017), weighted F-measure (Margolin et al. 2014) and
MAE over one frame, with the conventions of the JAX package's
:mod:`emip_tpu.metrics` and of the reference's ``eval/metrics.py``: the GT
is binarised at > 128 on the 0..255 scale, the prediction is scaled to
[0, 1] and min-max normalised per frame, and everything runs in float64
on the host. The port carries its own copy because the port imports
nothing of the JAX package; ``tests/test_torch_train.py`` holds it
against :mod:`emip_tpu.metrics`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["prepare", "s_measure", "weighted_fmeasure", "mae",
           "frame_scores"]

_EPS = np.spacing(1)
_ALPHA = 0.5  # S-measure: weight of the object term against the region term
_BETA = 1.0   # weighted F-measure: F_beta with beta = 1


def prepare(pred: np.ndarray, gt: np.ndarray) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """(pred in [0, 1] min-max normalised, gt > 128) from 0..255 maps."""
    pred = np.asarray(pred, np.float64) / 255.0
    lo, hi = pred.min(), pred.max()
    if hi != lo:
        pred = (pred - lo) / (hi - lo)
    return pred, np.asarray(gt) > 128


def _region_ssim(pred: np.ndarray, gt: np.ndarray) -> float:
    n = pred.size
    mx, my = pred.mean(), gt.mean()
    vx = ((pred - mx) ** 2).sum() / (n - 1)
    vy = ((gt - my) ** 2).sum() / (n - 1)
    cxy = ((pred - mx) * (gt - my)).sum() / (n - 1)
    num = 4 * mx * my * cxy
    den = (mx * mx + my * my) * (vx + vy)
    if num != 0:
        return num / (den + _EPS)
    return 1.0 if den == 0 else 0.0


def _object_score(vals: np.ndarray) -> float:
    if vals.size == 0:
        return 0.0
    m = vals.mean()
    sd = vals.std(ddof=1) if vals.size > 1 else 0.0
    return 2 * m / (m * m + 1 + sd + _EPS)


def s_measure(pred: np.ndarray, gt: np.ndarray) -> float:
    """Structure measure: object term plus region term over the four
    quadrants split at the GT centroid (+1, the reference's rounding)."""
    fg = gt.mean()
    if fg == 0:
        return 1 - pred.mean()
    if fg == 1:
        return pred.mean()
    s_obj = (fg * _object_score(pred[gt])
             + (1 - fg) * _object_score(1 - pred[~gt]))
    h, w = gt.shape
    total = gt.sum()
    cx = int(round((gt.sum(axis=0) * np.arange(w)).sum() / total)) + 1
    cy = int(round((gt.sum(axis=1) * np.arange(h)).sum() / total)) + 1
    g = gt.astype(np.float64)
    area = h * w
    weights = [cx * cy / area, cy * (w - cx) / area, (h - cy) * cx / area]
    weights.append(1 - sum(weights))
    rows = (slice(0, cy), slice(0, cy), slice(cy, h), slice(cy, h))
    cols = (slice(0, cx), slice(cx, w), slice(0, cx), slice(cx, w))
    s_reg = sum(wt * _region_ssim(pred[r, c], g[r, c])
                for wt, r, c in zip(weights, rows, cols))
    return max(0.0, _ALPHA * s_obj + (1 - _ALPHA) * s_reg)


def _gauss7(sigma: float = 5.0) -> np.ndarray:
    g = np.exp(-np.arange(-3, 4, dtype=np.float64) ** 2 / (2 * sigma**2))
    k = np.outer(g, g)
    k[k < np.finfo(np.float64).eps * k.max()] = 0
    return k / k.sum()


def weighted_fmeasure(pred: np.ndarray, gt: np.ndarray) -> float:
    """Weighted F_beta: background errors take the error of the nearest
    foreground pixel, are Gaussian-smoothed, and weigh more the farther
    they lie from the object."""
    from scipy.ndimage import convolve, distance_transform_edt

    if not gt.any():
        return 0.0
    bg = ~gt
    dist, (iy, ix) = distance_transform_edt(bg, return_indices=True)
    err = np.abs(pred - gt)
    nearest = err[iy, ix]
    smoothed = convolve(np.where(bg, nearest, err), _gauss7(),
                        mode="constant", cval=0)
    err = np.where(gt & (smoothed < err), smoothed, err)
    err = err * np.where(bg, 2 - np.exp(np.log(0.5) / 5 * dist), 1.0)
    tp = gt.sum() - err[gt].sum()
    fp = err[bg].sum()
    recall = 1 - err[gt].mean()
    precision = tp / (tp + fp + _EPS)
    return ((1 + _BETA) * recall * precision
            / (recall + _BETA * precision + _EPS))


def mae(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.abs(pred - gt).mean())


def frame_scores(pred255: np.ndarray, gt255: np.ndarray) -> dict:
    """wFm, Sm and MAE of one frame from 0..255 prediction and GT maps."""
    pred, gt = prepare(pred255, gt255)
    return dict(wFm=weighted_fmeasure(pred, gt), Sm=s_measure(pred, gt),
                MAE=mae(pred, gt))
