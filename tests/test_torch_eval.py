"""The port's offline evaluation and flow visualisation against the JAX
package's, on the CPU: every metric class of :mod:`emip_tpu_torch.metrics`
against :mod:`emip_tpu.metrics` on seeded maps (an empty GT, a full GT and
a constant prediction among them), ``evaluate_dataset`` and
``format_table`` for all 17 metric names on one seeded PNG tree under
MoCA, CAD and VPS naming, the colour wheel, and ``python -m
emip_tpu_torch.test_of`` on the tiny configuration. The metrics are host
float64 in both packages: tolerance 1e-12, images bit-equal.
"""

import os
import re

import numpy as np
import pytest
from PIL import Image

from tests import torch_helpers as th

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_TOL = dict(rtol=1e-12, atol=1e-12)


def _maps(seed, h=24, w=32):
    """Seeded (pred, gt) pairs in 0..255 float64 (as the evaluator reads
    PNGs): blobs, an empty GT, a full GT, a constant prediction, a
    prediction that misses the object, and a uint8 pair."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(3):
        cy, cx = rng.integers(5, h - 5), rng.integers(5, w - 5)
        gt = (((yy - cy) ** 2 + (xx - cx) ** 2) <= 25) * 255.0
        pred = np.clip(gt * rng.uniform(0.5, 1.0)
                       + rng.normal(0, 40, (h, w)), 0, 255)
        out.append((pred, gt))
    noise = rng.uniform(0, 255, (h, w))
    out += [(noise, np.zeros((h, w))),
            (noise, np.full((h, w), 255.0)),
            (np.full((h, w), 77.0), out[0][1]),
            (np.where(out[0][1] > 0, 0.0, 200.0), out[0][1]),
            (rng.integers(0, 256, (h, w)).astype(np.uint8),
             (out[1][1]).astype(np.uint8))]
    return out


def _assert_tree_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k])
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   **METRIC_TOL)


@pytest.mark.parametrize("name", ["Smeasure", "WeightedFmeasure", "MAE",
                                  "Emeasure", "Fmeasure", "Dice", "Medical",
                                  "IoU"])
def test_metric_class_matches_jax(name):
    """Each frame's value (Dice / IoU, which return it) and the stream's
    results: adaptive values, 256-threshold curves, precision / recall,
    Medical's four curves."""
    import emip_tpu.metrics.metrics as jm
    import emip_tpu_torch.metrics as tm

    got, want = getattr(tm, name)(), getattr(jm, name)()
    for pred, gt in _maps(3):
        if name in ("Dice", "IoU"):
            # soft metrics over the raw maps (the reference feeds them
            # normalised maps)
            pred, gt = pred / 255.0, gt / 255.0
        g, w = got.step(pred, gt), want.step(pred, gt)
        if w is not None:
            np.testing.assert_allclose(g, w, **METRIC_TOL)
    _assert_tree_close(got.get_results(), want.get_results())


def test_frame_scores_are_the_stream_classes_per_frame():
    """The training loop's ``frame_scores`` and the evaluator's classes
    give the same numbers on the same frame."""
    import emip_tpu_torch.metrics as tm

    for pred, gt in _maps(5):
        s = tm.frame_scores(pred, gt)
        for cls, key, out in ((tm.Smeasure, "Sm", "sm"),
                              (tm.WeightedFmeasure, "wFm", "wfm"),
                              (tm.MAE, "MAE", "mae")):
            m = cls()
            m.step(pred, gt)
            assert m.get_results()[out] == s[key]


def test_resize_bilinear_np_matches_jax():
    from emip_tpu.ops.image import resize_bilinear_np as jax_resize

    from emip_tpu_torch.ops.image import resize_bilinear_np

    rng = np.random.default_rng(7)
    for shape, out_hw in (((13, 17), (20, 9)), ((8, 6, 3), (16, 12)),
                          ((5, 1), (3, 4))):
        x = rng.uniform(0, 255, shape)
        for ac in (False, True):
            np.testing.assert_array_equal(
                resize_bilinear_np(x, out_hw, align_corners=ac),
                jax_resize(x, out_hw, align_corners=ac))


# ------------------------------------------------------ the evaluator

ALL_METRICS = ("Smeasure", "wFmeasure", "MAE", "adpEm", "meanEm", "maxEm",
               "adpFm", "meanFm", "maxFm", "meanSen", "maxSen", "meanSpe",
               "maxSpe", "meanDice", "maxDice", "meanIoU", "maxIoU")
DATASETS = ("MoCA_test", "CAD_eval", "VPS_val")


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """GT and prediction PNGs of three sequences (6, 5 and 4 frames, frame
    names with and without an underscore index) under each dataset name;
    one prediction is at another size than its GT."""
    base = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(11)
    h, w = 30, 40
    yy, xx = np.mgrid[0:h, 0:w]
    for d in DATASETS:
        for seq, n in (("seq_a", 6), ("seq_b", 5), ("seq_c", 4)):
            gdir = base / "gt" / d / seq / "GT"
            pdir = base / "pred" / d / seq
            gdir.mkdir(parents=True)
            pdir.mkdir(parents=True)
            for t in range(n):
                name = f"frame_{t}.png" if seq == "seq_b" else f"{t:05d}.png"
                cy, cx = rng.integers(6, h - 6), rng.integers(6, w - 6)
                gt = ((((yy - cy) ** 2 + (xx - cx) ** 2) <= 30) * 255
                      ).astype(np.uint8)
                if t == 1 and seq == "seq_c":
                    gt[:] = 0  # an empty GT
                pred = np.clip(gt * 0.8 + rng.normal(30, 40, (h, w)), 0, 255
                               ).astype(np.uint8)
                Image.fromarray(gt).save(gdir / name)
                img = Image.fromarray(pred)
                if t == 0 and seq == "seq_a":
                    img = img.resize((w + 7, h - 5), Image.BILINEAR)
                img.save(pdir / name)
    return base


@pytest.mark.parametrize("dataset", DATASETS)
def test_evaluate_dataset_matches_jax(png_tree, dataset):
    """All 17 metrics, the frame exclusions of MoCA, CAD and VPS naming,
    the numeric frame order and a resized prediction."""
    import emip_tpu.eval_offline as je

    import emip_tpu_torch.eval_offline as te

    gt = str(png_tree / "gt" / dataset)
    pred = str(png_tree / "pred" / dataset)
    got = te.evaluate_dataset(gt, pred, dataset, ALL_METRICS, verbose=False)
    want = je.evaluate_dataset(gt, pred, dataset, ALL_METRICS, verbose=False)
    assert list(got) == list(want) == list(ALL_METRICS)
    for m in ALL_METRICS:
        np.testing.assert_allclose(got[m], want[m], **METRIC_TOL, err_msg=m)
    row = [(dataset, "m") + tuple(f"{got[m]:.3f}" for m in ALL_METRICS)]
    assert te.format_table(row, ALL_METRICS) == je.format_table(
        row, ALL_METRICS)


def test_frame_exclusion_and_sort_key_match_jax():
    import emip_tpu.eval_offline as je

    import emip_tpu_torch.eval_offline as te

    paths = [f"/x/GT/{n}.png" for n in ("img_10", "img_2", "b", "a", "7")]
    assert sorted(paths, key=te._sort_key) == sorted(paths, key=je._sort_key)
    for name in DATASETS + ("MoCA-Mask", "CAD2016"):
        assert te.frame_exclusion(paths, name) == je.frame_exclusion(
            paths, name)
    assert te._METRIC_MODULES.keys() == je._METRIC_MODULES.keys()
    assert te.DEFAULT_METRICS == je.DEFAULT_METRICS


def test_eval_offline_cli_writes_the_tables(png_tree, tmp_path, capsys):
    """``python -m emip_tpu_torch.eval_offline`` (in process) over two
    datasets: its scores are ``evaluate_dataset``'s and each table lands
    in ``<out>/<dataset>_eval.txt``."""
    import emip_tpu_torch.eval_offline as te

    out = tmp_path / "res"
    scores = te.main(["--gt_root", str(png_tree / "gt"), "--pred_root",
                      str(png_tree / "pred"), "--data", "MoCA_test",
                      "CAD_eval", "--method", "port", "--out", str(out)])
    printed = capsys.readouterr().out
    for d in ("MoCA_test", "CAD_eval"):
        want = te.evaluate_dataset(str(png_tree / "gt" / d),
                                   str(png_tree / "pred" / d), d,
                                   verbose=False)
        assert scores[d] == want
        text = (out / f"{d}_eval.txt").read_text()
        assert f"{want['Smeasure']:.3f}" in text and text.strip() in printed
    assert "sequence seq_a: done (4 frames)" in printed  # MoCA drops 2


def _root_flags(script):
    with open(os.path.join(REPO, script)) as f:
        return set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))


@pytest.mark.parametrize("module,script,extra,required", [
    ("eval_offline", "eval_offline.py", set(),
     ["--gt_root", "g", "--pred_root", "p", "--data", "MoCA_test"]),
    ("test_of", "test_of.py", {"--device", "--multi_host"}, []),
    ("train_static", "train_static.py", {"--device"}, ["--data_root", "r"]),
])
def test_cli_flags_mirror_root_scripts(module, script, extra, required):
    """The root script's flags, plus --device (default: the card) where a
    model runs, and --multi_host where inference shards over a torchrun
    launch (off by default); the evaluator runs none and takes no
    --device."""
    import importlib

    mod = importlib.import_module(f"emip_tpu_torch.{module}")
    args = mod.parse_args(required)
    assert {f"--{k}" for k in vars(args)} == _root_flags(script) | extra
    assert getattr(args, "device", "cuda") == "cuda"
    assert not getattr(args, "multi_host", False)


# ------------------------------------------------ flow visualisation


def test_colorwheel_and_flow_to_image_match_jax():
    from emip_tpu.utils.flow_viz import flow_to_image as jax_f2i
    from emip_tpu.utils.flow_viz import make_colorwheel as jax_wheel

    from emip_tpu_torch.utils.flow_viz import flow_to_image, make_colorwheel

    np.testing.assert_array_equal(make_colorwheel(), jax_wheel())
    rng = np.random.default_rng(2)
    flow = (rng.standard_normal((23, 31, 2)) * 6).astype(np.float32)
    for f, clip in ((flow, None), (flow, 3.0), (np.zeros((5, 7, 2)), None),
                    (flow[:, :, ::-1].copy(), 50.0)):
        got = flow_to_image(f, clip=clip)
        assert got.dtype == np.uint8 and got.shape == f.shape[:2] + (3,)
        np.testing.assert_array_equal(got, jax_f2i(f, clip=clip))


def test_test_of_entry_point_writes_the_flow_images(tmp_path):
    """``python -m emip_tpu_torch.test_of --device cpu`` (in process) on
    the tiny configuration: one JPG per frame pair, each the JAX package's
    ``flow_to_image`` of the flow ``predict_pairs`` returns for the same
    model, through the same JPEG encoder."""
    from emip_tpu.utils.flow_viz import flow_to_image as jax_f2i

    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.data import make_synthetic_video_root
    from emip_tpu_torch.infer import predict_pairs
    from emip_tpu_torch.test import load_short_model
    from emip_tpu_torch.test_of import main as test_of_main

    root = make_synthetic_video_root(str(tmp_path / "data"), num_videos=2,
                                     frames_per_video=3, size=(56, 64))
    cfg = th.tiny_yaml(tmp_path / "tiny.yaml", root, str(tmp_path / "run"))
    out = tmp_path / "viz"
    n = test_of_main(["--config", cfg, "--data_root", root, "--save_path",
                      str(out), "--device", "cpu"])
    model = load_short_model(load_config(cfg), None, "cpu")
    flows = predict_pairs(model, root, str(tmp_path / "masks"), size=th.SIZE,
                          device="cpu", return_flow=True)
    assert n == len(flows) == 4
    for video, name, flow in flows:
        assert flow.shape == (th.SIZE, th.SIZE, 2)
        want = tmp_path / "want.jpg"
        Image.fromarray(jax_f2i(flow)).save(want)
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / video / f"{name}.jpg")),
            np.asarray(Image.open(want)))
        assert (out / "_masks" / video / f"{name}.png").is_file()
