"""Segmentation metrics (numpy / scipy, on the host, float64).

S-measure (Fan et al. 2017), weighted F-measure (Margolin et al. 2014),
MAE, E-measure (Fan et al. 2018; adaptive threshold and the 256-threshold
curve), F-measure (adaptive, curve, precision / recall), the Medical
threshold sweep (Sen / Spe / Dice / IoU curves) and soft Dice / IoU, with
the conventions of the JAX package's :mod:`emip_tpu.metrics` and of the
reference's ``eval/metrics.py`` / ``eval/eval_vcod/metrics.py``: the GT is
binarised at > 128 on the 0..255 scale, the prediction is scaled to
[0, 1] and min-max normalised per frame, and the sums run in float64
(the prediction in float32 where it comes so, as in the JAX package).
Each metric is a function over one frame and a streaming class with
``step(pred, gt)`` / ``get_results()``, as the offline evaluator
(:mod:`emip_tpu_torch.eval_offline`) drives them. There is no device
kernel here. The port carries its own copy because it imports nothing of
the JAX package; ``tests/test_torch_eval.py`` holds every class against
:mod:`emip_tpu.metrics`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["prepare_pred_gt", "s_measure", "weighted_fmeasure", "mae",
           "frame_scores", "Smeasure", "WeightedFmeasure", "MAE",
           "Emeasure", "Fmeasure", "Dice", "Medical", "IoU"]

_EPS = np.spacing(1)
_ALPHA = 0.5  # S-measure: weight of the object term against the region term
_BETA = 1.0   # weighted F-measure: F_beta with beta = 1


def prepare_pred_gt(pred: np.ndarray, gt: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(pred in [0, 1] min-max normalised, gt > 128) from 0..255 maps. The
    prediction keeps a float dtype it comes in, as in the JAX package: the
    evaluator reads float64, a prediction resized to its GT's size is
    float32."""
    pred = np.asarray(pred) / 255.0
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
    pred, gt = prepare_pred_gt(pred255, gt255)
    return dict(wFm=weighted_fmeasure(pred, gt), Sm=s_measure(pred, gt),
                MAE=mae(pred, gt))


# ------------------------------------------------------ streaming classes


class _Streaming:
    """Per-frame scores; their mean on ``get_results``."""

    def __init__(self):
        self._scores = []

    def _push(self, value):
        self._scores.append(value)

    def _mean(self):
        return np.mean(np.asarray(self._scores, np.float64), axis=0)


class Smeasure(_Streaming):
    def step(self, pred: np.ndarray, gt: np.ndarray):
        self._push(s_measure(*prepare_pred_gt(pred, gt)))

    def get_results(self):
        return dict(sm=self._mean())


class WeightedFmeasure(_Streaming):
    def step(self, pred: np.ndarray, gt: np.ndarray):
        self._push(weighted_fmeasure(*prepare_pred_gt(pred, gt)))

    def get_results(self):
        return dict(wfm=self._mean())


class MAE(_Streaming):
    def step(self, pred: np.ndarray, gt: np.ndarray):
        pred, gt = prepare_pred_gt(pred, gt)
        self._push(np.abs(pred - gt).mean())

    def get_results(self):
        return dict(mae=self._mean())


def _em_from_counts(fg_fg, fg_bg, gt_fg_count, gt_size):
    """Enhanced-alignment measure from the counts of a binarised
    prediction inside (``fg_fg``) and outside (``fg_bg``) the GT; scalars
    or 256-threshold vectors alike."""
    pred_fg = fg_fg + fg_bg
    pred_bg = gt_size - pred_fg
    if gt_fg_count == 0:
        enhanced_total = pred_bg
    elif gt_fg_count == gt_size:
        enhanced_total = pred_fg
    else:
        bg_fg = gt_fg_count - fg_fg
        bg_bg = pred_bg - bg_fg
        mean_pred = pred_fg / gt_size
        mean_gt = gt_fg_count / gt_size
        combos = ((1 - mean_pred, 1 - mean_gt), (1 - mean_pred, 0 - mean_gt),
                  (0 - mean_pred, 1 - mean_gt), (0 - mean_pred, 0 - mean_gt))
        enhanced_total = 0.0
        for part, (dp, dg) in zip((fg_fg, fg_bg, bg_fg, bg_bg), combos):
            align = 2 * dp * dg / (dp**2 + dg**2 + _EPS)
            enhanced_total = enhanced_total + ((align + 1) ** 2 / 4) * part
    return enhanced_total / (gt_size - 1 + _EPS)


def _threshold_histograms(pred: np.ndarray, gt: np.ndarray):
    """Counts of pixels with uint8 prediction >= t inside / outside the GT
    for t = 255..0 (reversed cumulative histograms)."""
    pred_u8 = (pred * 255).astype(np.uint8)
    bins = np.arange(257)
    fg_hist, _ = np.histogram(pred_u8[gt], bins=bins)
    bg_hist, _ = np.histogram(pred_u8[~gt], bins=bins)
    return np.cumsum(fg_hist[::-1]), np.cumsum(bg_hist[::-1])


def _adaptive_binary(pred: np.ndarray) -> np.ndarray:
    """The prediction at the adaptive threshold min(2 * mean, 1)."""
    return pred >= min(2 * pred.mean(), 1.0)


class Emeasure:
    """E-measure at the adaptive threshold and over 256 thresholds."""

    def __init__(self):
        self.adaptive = []
        self.curves = []

    def step(self, pred: np.ndarray, gt: np.ndarray):
        pred, gt = prepare_pred_gt(pred, gt)
        gt_fg = int(np.count_nonzero(gt))
        binar = _adaptive_binary(pred)
        self.adaptive.append(_em_from_counts(
            np.count_nonzero(binar & gt), np.count_nonzero(binar & ~gt),
            gt_fg, gt.size))
        fg_w, bg_w = _threshold_histograms(pred, gt)
        self.curves.append(_em_from_counts(
            fg_w.astype(np.float64), bg_w.astype(np.float64), gt_fg,
            gt.size))

    def get_results(self):
        return dict(em=dict(
            adp=np.mean(np.asarray(self.adaptive, np.float64)),
            curve=np.mean(np.asarray(self.curves, np.float64), axis=0)))


class Fmeasure:
    """F-measure (beta^2 = 0.3) at the adaptive threshold and over 256
    thresholds, with the precision / recall curves."""

    def __init__(self, beta: float = 0.3):
        self.beta = beta
        self.adaptive = []
        self.precisions = []
        self.recalls = []
        self.curves = []

    def step(self, pred: np.ndarray, gt: np.ndarray):
        pred, gt = prepare_pred_gt(pred, gt)
        binar = _adaptive_binary(pred)
        inter = np.count_nonzero(binar & gt)
        if inter == 0:
            self.adaptive.append(0.0)
        else:
            prec = inter / np.count_nonzero(binar)
            rec = inter / np.count_nonzero(gt)
            self.adaptive.append((1 + self.beta) * prec * rec
                                 / (self.beta * prec + rec))
        tp, bg = _threshold_histograms(pred, gt)
        precision = tp / np.maximum(tp + bg, 1)
        recall = tp / max(np.count_nonzero(gt), 1)
        numer = (1 + self.beta) * precision * recall
        denom = np.where(numer == 0, 1, self.beta * precision + recall)
        self.precisions.append(precision)
        self.recalls.append(recall)
        self.curves.append(numer / denom)

    def get_results(self):
        def mean(xs):
            return np.mean(np.asarray(xs, np.float64), axis=0)

        return dict(fm=dict(adp=mean(self.adaptive), curve=mean(self.curves)),
                    pr=dict(p=mean(self.precisions), r=mean(self.recalls)))


class Dice(_Streaming):
    """Soft Dice distance (1 - Dice) over the raw maps, as the reference's
    ``DICE`` (eval/metrics.py:400-426), which takes normalised maps."""

    def step(self, pred: np.ndarray, gt: np.ndarray):
        p, g = pred.ravel(), gt.ravel()
        dice = 2 * ((p * g).sum() + 1.0) / (p.sum() + g.sum() + 1.0)
        self._push(1 - dice)
        return self._scores[-1]

    def get_results(self):
        return self._mean()


class Medical:
    """Sen / Spe / Dice / IoU curves over 256 thresholds from 1 to 0 (the
    offline evaluator's Medical metric, eval/eval_vcod/metrics.py:399-465);
    the counts come from ``searchsorted`` on the sorted prediction inside
    and outside the GT. A threshold with no true positive scores 0 in all
    four (the reference's ``NumAnd == 0`` rule). Mean against max over a
    curve is the caller's choice (:func:`emip_tpu_torch.eval_offline.
    evaluate_dataset`)."""

    def __init__(self):
        self.thresholds = np.linspace(1, 0, 256)
        self.sen, self.spe, self.dice, self.iou = [], [], [], []

    def step(self, pred: np.ndarray, gt: np.ndarray):
        pred, gt = prepare_pred_gt(pred, gt)
        pos = np.sort(pred[gt].ravel())
        neg = np.sort(pred[~gt].ravel())
        n_pos, n_neg = pos.size, neg.size
        thr = np.minimum(self.thresholds, 1.0)
        tp = n_pos - np.searchsorted(pos, thr, side="left")
        fp = n_neg - np.searchsorted(neg, thr, side="left")
        fn = n_pos - tp
        tn = n_neg - fp
        with np.errstate(divide="ignore", invalid="ignore"):
            self.sen.append(np.where(tp > 0, tp / max(n_pos, 1), 0.0))
            self.spe.append(np.where(tp > 0, tn / np.maximum(tn + fp, 1), 0.0))
            self.dice.append(np.where(
                tp > 0, 2 * tp / np.maximum(n_pos + tp + fp, 1), 0.0))
            self.iou.append(np.where(
                tp > 0, tp / np.maximum(fn + tp + fp, 1), 0.0))

    def get_results(self):
        return {k: np.mean(np.asarray(getattr(self, k), np.float64), axis=0)
                for k in ("sen", "spe", "dice", "iou")}


class IoU(_Streaming):
    """Soft IoU over the raw maps (reference eval/metrics.py:488-492)."""

    def step(self, pred: np.ndarray, gt: np.ndarray):
        inter = (gt * pred).sum()
        union = gt.sum() + pred.sum() - inter
        self._push(inter / union if union > 0 else 0.0)
        return self._scores[-1]

    def get_results(self):
        return self._mean()
