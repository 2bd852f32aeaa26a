"""Offline VCOD evaluation: saved prediction PNGs against the GT.

    python -m emip_tpu_torch.eval_offline --gt_root DIR --pred_root DIR \
        --data MoCA_test [CAD_eval ...] [--method NAME] \
        [--metrics Smeasure wFmeasure ...] [--out ./eval_results]

Counterpart of :mod:`emip_tpu.eval_offline` and of the repository's root
``eval_offline.py`` (the reference's ``eval/eval_vcod`` pipeline,
``moca_evaluator.py:62-157``), with the same flags. For each dataset,
``<gt_root>/<dataset>/<sequence>/GT/*.png`` is scored against
``<pred_root>/<dataset>/<sequence>/<frame>.png``: a prediction of another
size is resized (bilinear) to its GT's; the metrics are averaged per
sequence, then across sequences, and a ``max*`` metric takes the maximum
of that mean over its 256-threshold curve. The frame-exclusion rules are
the reference's: a MoCA-style dataset drops its last two GT frames, CAD
keeps all, VPS drops the first and the last. One table per dataset is
printed and appended to ``<out>/<dataset>_eval.txt``. It runs no model,
so it takes no ``--device``: the metrics are host numpy in float64
(:mod:`emip_tpu_torch.metrics`).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from emip_tpu_torch.metrics import (
    MAE,
    Emeasure,
    Fmeasure,
    Medical,
    Smeasure,
    WeightedFmeasure,
)
from emip_tpu_torch.ops.image import resize_bilinear_np

__all__ = ["DEFAULT_METRICS", "frame_exclusion", "evaluate_sequence",
           "evaluate_dataset", "format_table", "parse_args", "main"]

_METRIC_MODULES = {
    "Smeasure": Smeasure,
    "wFmeasure": WeightedFmeasure,
    "MAE": MAE,
    "adpEm": Emeasure,
    "meanEm": Emeasure,
    "maxEm": Emeasure,
    "adpFm": Fmeasure,
    "meanFm": Fmeasure,
    "maxFm": Fmeasure,
    "meanSen": Medical,
    "maxSen": Medical,
    "meanSpe": Medical,
    "maxSpe": Medical,
    "meanDice": Medical,
    "maxDice": Medical,
    "meanIoU": Medical,
    "maxIoU": Medical,
}

DEFAULT_METRICS = ("Smeasure", "wFmeasure", "meanEm", "MAE", "meanDice",
                   "meanIoU")


def _read_gray(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float64)


def _metric_value(name: str, results: dict):
    """The metric ``name`` from its class's results: a scalar, or the
    256-threshold curve of a mean* / max* metric."""
    if name == "Smeasure":
        return results["sm"]
    if name == "wFmeasure":
        return results["wfm"]
    if name == "MAE":
        return results["mae"]
    if name.endswith("Em"):
        return results["em"]["adp" if name == "adpEm" else "curve"]
    if name.endswith("Fm"):
        return results["fm"]["adp" if name == "adpFm" else "curve"]
    # Medical: meanSen / maxSen -> "sen"; mean against max is applied
    # after the cross-sequence mean (evaluate_dataset)
    return results[name.removeprefix("mean").removeprefix("max").lower()]


def frame_exclusion(gt_list: list[str], dataset_name: str) -> list[str]:
    """The GT frames scored: VPS drops the first and last, CAD keeps all,
    any other (MoCA-style) dataset drops the last two."""
    if "VPS" in dataset_name:
        return gt_list[1:-1]
    if "CAD" in dataset_name:
        return gt_list
    return gt_list[:-2]


def _sort_key(path: str):
    stem = os.path.basename(path).rsplit(".", 1)[0]
    tail = stem.split("_")[-1]
    return (0, int(tail)) if tail.isdigit() else (1, stem)


def evaluate_sequence(gt_paths: list[str], pred_paths: list[str],
                      metrics=DEFAULT_METRICS) -> dict:
    """Per-sequence results of ``metrics`` (scalars and curves); one
    metric class instance serves every metric that reads it."""
    if len(gt_paths) != len(pred_paths):
        raise ValueError(f"{len(gt_paths)} GT frames against "
                         f"{len(pred_paths)} predictions")
    modules = {}
    for m in metrics:
        cls = _METRIC_MODULES[m]
        modules.setdefault(cls.__name__, cls())
    for gt_path, pred_path in zip(gt_paths, pred_paths):
        gt = _read_gray(gt_path)
        pred = _read_gray(pred_path)
        if pred.shape != gt.shape:
            pred = resize_bilinear_np(pred, gt.shape, align_corners=False)
        for mod in modules.values():
            mod.step(pred, gt)
    results = {n: mod.get_results() for n, mod in modules.items()}
    return {m: _metric_value(m, results[_METRIC_MODULES[m].__name__])
            for m in metrics}


def evaluate_dataset(gt_root: str, pred_root: str, dataset_name: str,
                     metrics=DEFAULT_METRICS,
                     verbose: bool = True) -> dict[str, float]:
    """Sequence means, then the cross-sequence mean (the maximum over the
    curve for max* metrics) for one dataset."""
    sequences = sorted(d for d in os.listdir(gt_root)
                       if os.path.isdir(os.path.join(gt_root, d)))
    per_seq: list[dict] = []
    for seq in sequences:
        gt_list = sorted(glob.glob(os.path.join(gt_root, seq, "GT", "*.png")),
                         key=_sort_key)
        gt_list = frame_exclusion(gt_list, dataset_name)
        if not gt_list:
            continue
        pred_list = [os.path.join(pred_root, seq, os.path.basename(g))
                     for g in gt_list]
        missing = [p for p in pred_list if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(f"{seq}: {len(missing)} missing "
                                    f"predictions, e.g. {missing[0]}")
        per_seq.append(evaluate_sequence(gt_list, pred_list, metrics))
        if verbose:
            print(f"  sequence {seq}: done ({len(gt_list)} frames)")

    out: dict[str, float] = {}
    for m in metrics:
        seq_mean = np.asarray([np.asarray(s[m], np.float64)
                               for s in per_seq]).mean(axis=0)
        out[m] = float(np.max(seq_mean) if m.startswith("max")
                       else np.mean(seq_mean))
    return out


def format_table(rows: list[tuple], metrics=DEFAULT_METRICS) -> str:
    """PrettyTable where it is installed, tab-separated text otherwise."""
    header = ["Dataset", "Method"] + list(metrics)
    try:
        import prettytable as pt
    except ImportError:
        return "\n".join(["\t".join(header)]
                         + ["\t".join(str(c) for c in row) for row in rows])
    tb = pt.PrettyTable()
    tb.field_names = header
    for row in rows:
        tb.add_row(list(row))
    return str(tb)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gt_root", required=True,
                   help="root containing <dataset>/<sequence>/GT/*.png")
    p.add_argument("--pred_root", required=True,
                   help="root containing <dataset>/<sequence>/*.png")
    p.add_argument("--data", nargs="+", required=True,
                   help="dataset names, e.g. MoCA_test CAD_eval")
    p.add_argument("--method", default="EMIP-TPU")
    p.add_argument("--metrics", nargs="+", default=list(DEFAULT_METRICS))
    p.add_argument("--out", default="./eval_results")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, dict[str, float]]:
    """Score every dataset of ``--data``; returns {dataset: {metric:
    value}} beside the printed tables."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    scores = {}
    for name in args.data:
        print("#" * 20, "Dataset:", name, "#" * 20)
        scores[name] = evaluate_dataset(
            gt_root=os.path.join(args.gt_root, name),
            pred_root=os.path.join(args.pred_root, name),
            dataset_name=name, metrics=tuple(args.metrics))
        row = [name, args.method] + [f"{scores[name][m]:.3f}"
                                     for m in args.metrics]
        table = format_table([tuple(row)], tuple(args.metrics))
        print(table)
        with open(os.path.join(args.out, f"{name}_eval.txt"), "a+") as f:
            f.write(table + "\n")
    return scores


if __name__ == "__main__":
    main()
