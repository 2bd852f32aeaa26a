"""The GPipe pipeline of the port (``emip_tpu_torch/pipeline.py``) on the
CPU: the counterparts of ``tests/test_pipeline.py`` at S = 2 stages, two
ranks of a gloo group spawned once for the module
(``tests/torch_shard_helpers.py:pipeline_worker``).

The pipelined stack is the plain block loop, values and grads (the
parameters of each stage and the input, from sum(y^2)), and JAX's
``pipeline_blocks`` on a (1, 2) mesh at JAX's own tolerances: 1e-6 on the
toy MLP's values (of their scale: across frameworks 1e-6 absolute is one
ulp there), 1e-5 on a 4-block ``PVTBlock`` stack's (C 32, 2 heads), grads
to 1e-4 of each tensor's scale. Each rank holds L / S blocks, and
both of JAX's refusals hold, in its words.
"""

import numpy as np
import pytest
import torch

from tests import torch_helpers as th
from tests import torch_shard_helpers as sh

JOIN_S = 180
B, L, C, HEADS = 4, 4, 32, 2
N = sh.PP_H * sh.PP_W


def _mlp_params():
    """The toy stack of tests/test_pipeline.py: 8 layers, width 16,
    hidden 32, from seeded numpy draws."""
    rng = np.random.default_rng(0)
    return {"w1": (0.3 * rng.standard_normal((8, 16, 32))).astype(np.float32),
            "b1": (0.1 * rng.standard_normal((8, 32))).astype(np.float32),
            "w2": (0.3 * rng.standard_normal((8, 32, 16))).astype(np.float32)}


def _pvt_params():
    """Four seeded flax ``PVTBlock`` trees stacked as ``nn.scan`` stacks
    them, and the port's per-block state dicts of the same weights."""
    import jax

    from emip_tpu.models.pvt_v2 import PVTBlock

    from emip_tpu_torch.convert import state_dict_from_flax_pvt_blocks

    block = PVTBlock(dim=C, num_heads=HEADS, mlp_ratio=2, sr_ratio=1)
    x = np.zeros((B, sh.PP_H, sh.PP_W, C), np.float32)
    per = [th.random_variables(block, x, 0.0, deterministic=True,
                               seed=40 + i)["params"]
           for i in range(L)]
    stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *per)
    return block, stacked, state_dict_from_flax_pvt_blocks(stacked)


def _inputs():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((8, 16)).astype(np.float32),
            rng.standard_normal((B, sh.PP_H, sh.PP_W, C)).astype(np.float32))


def _jax_references(block, stacked, x_mlp, x_pvt):
    """JAX's ``pipeline_blocks`` on a (1, 2) mesh: the toy MLP's output and
    grads of sum(y^2) (parameters and input), and the PVT stack's
    output."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from emip_tpu.parallel.pipeline import pipeline_blocks

    mesh = Mesh(np.asarray(jax.devices()[:sh.WORLD]).reshape(1, sh.WORLD),
                ("data", "model"))

    def mlp(p, x):
        return x + jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]

    def loss(p, x):
        return jnp.sum(pipeline_blocks(mlp, p, x, mesh,
                                       num_microbatches=4) ** 2)

    params = jax.tree_util.tree_map(jnp.asarray, _mlp_params())
    y = pipeline_blocks(mlp, params, jnp.asarray(x_mlp), mesh,
                        num_microbatches=4)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x_mlp))

    def pvt(p, a):
        return block.apply({"params": p}, a, 0.0, True)[0]

    y_pvt = pipeline_blocks(pvt, stacked, jnp.asarray(x_pvt), mesh,
                            num_microbatches=2)
    return dict(mlp_y=np.asarray(y), mlp_gx=np.asarray(gx),
                mlp_gp={k: np.asarray(v) for k, v in gp.items()},
                pvt_y=np.asarray(y_pvt))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    block, stacked, states = _pvt_params()
    x_mlp, x_pvt = _inputs()
    tokens = torch.from_numpy(x_pvt.reshape(B, N, C))
    cases = {"mlp": dict(mlp=_mlp_params(), x=torch.from_numpy(x_mlp),
                         micro=4),
             "pvt": dict(states=states, x=tokens, micro=2,
                         dtype=torch.float32),
             "pvt_bf16": dict(states=states, x=tokens.bfloat16(), micro=2,
                              dtype=torch.bfloat16)}
    torch.save(cases, tmp / "cases.pt")
    procs = sh.spawn_ranks(sh.pipeline_worker, str(tmp / "rendezvous"),
                           str(tmp), str(tmp / "cases.pt"))
    try:  # the references while the ranks run
        plain = {(name, mode): sh.run_pipeline(
            sh.mlp_stack(c["mlp"]) if "mlp" in c else
            sh.pvt_stack(c["states"], dtype=c["dtype"]), c["x"], c["micro"],
            mode) for name, c in cases.items() for mode in ("loop", "micro")}
        jax_ref = _jax_references(block, stacked, x_mlp, x_pvt)
    finally:
        got = sh.join_ranks(procs, JOIN_S, tmp)
    return dict(ranks=got, plain=plain, jax=jax_ref)


def _close_to_scale(got, want, rel, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1.0),
                               err_msg=label)


def _merged_grads(ranks, name):
    """Each block's grads from the rank that holds it."""
    merged = []
    for held in zip(*(r[name]["grads"] for r in ranks)):
        own = [g for g in held if g is not None]
        assert len(own) == 1  # exactly one stage holds the block
        merged.append(own[0])
    return merged


@pytest.mark.parametrize("name", ["mlp", "pvt", "pvt_bf16"])
def test_pipeline_matches_the_plain_loop(ranks, name):
    """Values (the same on every rank) and grads of every stage's
    parameters and of the input, against the plain block loop in one
    process: fp32 to 1e-6 of the values' scale and 1e-4 of each grad's;
    bf16 (each block rounds its output) bit for bit in the values and
    within 1e-2 of each grad's scale."""
    want = ranks["plain"][name, "loop"]
    value_rel, grad_rel = (0.0, 1e-2) if name == "pvt_bf16" else (1e-6, 1e-4)
    for r in ranks["ranks"]:
        got = r[name]
        assert got["y"].dtype == want["y"].dtype
        _close_to_scale(got["y"].float(), want["y"].float(), value_rel, "y")
        _close_to_scale(got["gx"].float(), want["gx"].float(), grad_rel,
                        "input grad")
    for i, (g, w) in enumerate(zip(_merged_grads(ranks["ranks"], name),
                                   want["grads"])):
        for k in w:
            _close_to_scale(g[k].float(), w[k].float(), grad_rel, f"{i}.{k}")


@pytest.mark.parametrize("name", ["mlp", "pvt", "pvt_bf16"])
def test_pipeline_matches_the_loop_on_its_microbatches(ranks, name):
    """Against the plain block loop in one process on the same
    microbatches, each one's backward run in the pipeline's order: the
    values, the input's grad and every stage's parameter grads bit for
    bit, in fp32 and in bf16."""
    want = ranks["plain"][name, "micro"]
    for r in ranks["ranks"]:
        assert torch.equal(r[name]["y"], want["y"])
        assert torch.equal(r[name]["gx"], want["gx"])
    for i, (g, w) in enumerate(zip(_merged_grads(ranks["ranks"], name),
                                   want["grads"])):
        for k in w:
            assert torch.equal(g[k], w[k]), (i, k)


def test_pipeline_matches_jax_on_the_toy_mlp(ranks):
    """JAX's ``pipeline_blocks`` over 8 toy blocks, 4 microbatches: values
    to 1e-6 of their scale (max|y| ~10, where 1e-6 absolute, JAX's bound
    for its pipeline against its own loop, is one fp32 ulp: the two
    frameworks' tanh and products part by a few), grads of the parameters
    and the input to 1e-4 of scale."""
    want = ranks["jax"]
    grads = _merged_grads(ranks["ranks"], "mlp")
    for r in ranks["ranks"]:
        _close_to_scale(r["mlp"]["y"], want["mlp_y"], 1e-6, "y")
        _close_to_scale(r["mlp"]["gx"], want["mlp_gx"], 1e-4, "input grad")
    for k in ("w1", "b1", "w2"):
        _close_to_scale(np.stack([g[k].numpy() for g in grads]),
                        want["mlp_gp"][k], 1e-4, k)


def test_pipeline_matches_jax_on_a_pvt_stack(ranks):
    """JAX's ``pipeline_blocks`` over the 4 flax ``PVTBlock``s (their
    ``nn.scan`` stacks converted block by block), 2 microbatches: the
    values to 1e-5."""
    want = ranks["jax"]["pvt_y"].reshape(B, N, C)
    for r in ranks["ranks"]:
        np.testing.assert_allclose(r["pvt"]["y"].numpy(), want, atol=1e-5)


def test_each_stage_holds_its_blocks(ranks):
    """Rank s holds blocks [sK, (s+1)K), K = L / S, and only they take
    grads there."""
    for s, r in enumerate(ranks["ranks"]):
        for name, depth in (("mlp", 8), ("pvt", L)):
            k = depth // sh.WORLD
            assert r[name]["held"] == k
            took = [i for i, g in enumerate(r[name]["grads"])
                    if g is not None]
            assert took == list(range(s * k, (s + 1) * k)), (name, took)


def test_pipeline_refusals(ranks):
    """JAX's two refusals in its words: a depth that does not divide over
    the stages, a batch that does not divide into the microbatches."""
    for r in ranks["ranks"]:
        assert r["refusals"] == [
            "depth 3 not divisible by 2 stages",
            "local batch 3 not divisible by 2 microbatches"]


def test_one_stage_is_the_plain_loop():
    """Without a process group the pipeline is the loop over the
    microbatches of the whole stack."""
    from emip_tpu_torch.pipeline import pipeline_blocks, stage_blocks

    blocks = sh.mlp_stack(_mlp_params())
    x = torch.from_numpy(_inputs()[0])
    assert len(stage_blocks(blocks)) == 8
    parts = []
    for part in x.chunk(4):
        for blk in blocks:
            part = blk(part, 0, 0)
        parts.append(part)
    assert torch.equal(pipeline_blocks(blocks, x, 0, 0, 4), torch.cat(parts))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_blocks(blocks, x[:3], 0, 0, 2)
