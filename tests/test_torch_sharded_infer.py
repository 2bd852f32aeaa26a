"""Sharded inference of the port (``emip_tpu_torch/infer.py:
predict_pairs`` in a process group, ``python -m emip_tpu_torch.test`` and
``... test_of`` with ``--multi_host``) on the CPU.

Two ranks are spawned once for the module
(``tests/torch_shard_helpers.py:infer_worker``); each joins torchrun-style
groups through the entry points' ``--multi_host`` and predicts its share
of a synthetic root of 5 frame pairs (so that ``shard_order``'s wrap
padding repeats one pair on one rank) in batches of 2. While they run,
this process makes the same calls with no group, and JAX's
``predict_pairs`` on a 2-device CPU mesh. The ranks' PNGs are disjoint and
together the one-process set byte for byte; ``return_flow`` gives every
rank the one-process list bit for bit; ``test_of``'s first rank alone
writes the flow images, those of one process. JAX writes the same file
names, its masks within one 8-bit level of the port's.
"""

import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from tests import torch_helpers as th
from tests import torch_shard_helpers as sh

JOIN_S = 180
PAIRS = 5
B0_DEPTHS = (2, 2, 2, 2)  # the YAML's pvt_v2_b0, which the entry points build


def _files(root, ext):
    """{relative path: bytes} of the ``ext`` files under ``root``."""
    root = str(root)
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs if f.endswith(ext)}


def _root(path):
    """Three videos of 3, 3 and 2 frames: 5 pairs."""
    from emip_tpu_torch.data import make_synthetic_video_root

    root = make_synthetic_video_root(str(path), num_videos=3,
                                     frames_per_video=3, size=(56, 64))
    for sub in ("Imgs", "GT"):
        d = os.path.join(root, "video_02", sub)
        os.remove(os.path.join(d, sorted(os.listdir(d))[-1]))
    return root


def _jax_predict(variables, root, out):
    """JAX's ``predict_pairs`` with a 2-device mesh on the same weights."""
    import jax
    from jax.sharding import Mesh

    from emip_tpu.infer import predict_pairs

    jm, _ = th.jax_tiny_short(drop_path_rate=0.0, depths=B0_DEPTHS)
    state = type("State", (), dict(params=variables["params"], frozen={},
                                   batch_stats=variables["batch_stats"]))
    mesh = Mesh(np.asarray(jax.devices()[:sh.WORLD]).reshape(sh.WORLD, 1),
                ("data", "model"))
    predict_pairs(jm, state, root, out, size=th.SIZE, batch_size=2,
                  mesh=mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.convert import state_dict_from_flax
    from emip_tpu_torch.infer import predict_pairs
    from emip_tpu_torch.test import load_short_model
    from emip_tpu_torch.test import main as test_main
    from emip_tpu_torch.test_of import main as test_of_main

    tmp = tmp_path_factory.mktemp("sharded_infer")
    root = _root(tmp / "videos")
    jm, _ = th.jax_tiny_short(drop_path_rate=0.0, depths=B0_DEPTHS)
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    variables = th.random_variables(jm, img, img, seed=21)
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    torch.save(dict(model=state_dict_from_flax(variables, B0_DEPTHS,
                                               th.NUM_LAYERS), epoch=0),
               ckpt / "ckpt.pt")
    config = th.tiny_yaml(tmp / "infer.yaml", root, str(tmp / "unused"))
    raw = yaml.safe_load(open(config))
    raw["model"]["args"]["include_dead_modules"] = True
    with open(config, "w") as f:
        yaml.safe_dump(raw, f)
    procs = sh.spawn_ranks(sh.infer_worker, str(tmp), root, config,
                           str(ckpt))
    try:  # one process, and JAX, while the ranks run
        common = ["--config", config, "--ckpt", str(ckpt), "--device", "cpu"]
        test_main(common + ["--save_path", str(tmp / "test_one"), "--data",
                            f"MoCA_test={root}", "--batch_size", "2"])
        n_jpg = test_of_main(common + ["--save_path", str(tmp / "of_one"),
                                       "--data_root", root])
        model = load_short_model(load_config(config), str(ckpt), "cpu")
        flows = predict_pairs(model, root, str(tmp / "flows_one"),
                              size=th.SIZE, batch_size=2, device="cpu",
                              return_flow=True)
        _jax_predict(variables, root, str(tmp / "jax"))
    finally:
        got = sh.join_ranks(procs, JOIN_S, tmp)
    return dict(ranks=got, tmp=tmp, flows=flows, jpgs=n_jpg)


@pytest.mark.parametrize("run", ["test", "flows", "of"])
def test_ranks_write_disjoint_shares_of_the_one_process_pngs(runs, run):
    """``test --multi_host``, ``predict_pairs`` in a group and ``test_of
    --multi_host``'s masks: each rank writes its share, one rank's share
    holds a pair that the wrap padding repeats and that it predicts
    without writing, and the union is the one-process output byte for
    byte."""
    tmp = runs["tmp"]
    sub = "_masks" if run == "of" else ""
    one = _files(tmp / f"{run}_one" / sub, ".png")
    shares = [_files(tmp / f"{run}{r}" / sub, ".png")
              for r in range(sh.WORLD)]
    assert len(one) == PAIRS
    assert sorted(len(s) for s in shares) == [2, 3]  # 3 + 3 predicted
    assert not set(shares[0]) & set(shares[1])
    assert {**shares[0], **shares[1]} == one


def test_return_flow_gives_every_rank_the_one_process_list(runs):
    want = runs["flows"]
    assert len(want) == PAIRS
    for r in runs["ranks"]:
        got = r["flows"]
        assert [g[:2] for g in got] == [w[:2] for w in want]
        assert all(np.array_equal(g[2], w[2]) for g, w in zip(got, want))


def test_of_first_rank_alone_writes_the_flow_images(runs):
    """``test_of --multi_host``: the first rank writes every flow image,
    those of one process byte for byte; the others write none."""
    tmp = runs["tmp"]
    one = _files(tmp / "of_one", ".jpg")
    assert runs["jpgs"] == len(one) == PAIRS
    assert [r["jpgs"] for r in runs["ranks"]] == [PAIRS, 0]
    assert _files(tmp / "of0", ".jpg") == one
    assert _files(tmp / "of1", ".jpg") == {}


def test_jax_predict_pairs_on_a_2_device_mesh_agrees(runs):
    """JAX's ``predict_pairs`` with its batch on a 2-device mesh writes the
    same file names, and each of its masks is the port's to one 8-bit
    level (the rounding of the PNG's ``convert("L")``; the logits agree
    within the tiny slice's tolerance, tests/test_torch_slice.py)."""
    tmp = runs["tmp"]
    port = _files(tmp / "test_one" / "MoCA_test", ".png")
    assert _files(tmp / "jax", ".png").keys() == port.keys()
    for name in port:
        a = np.asarray(Image.open(tmp / "jax" / name), np.int16)
        b = np.asarray(Image.open(tmp / "test_one" / "MoCA_test" / name),
                       np.int16)
        assert np.abs(a - b).max() <= 1, name
