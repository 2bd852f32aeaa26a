"""The alternate encoders' train steps, the two-stream model on them and
DGNet against the JAX package, fp32, on the CPU: ``SegNetwork`` on the
linear PVTv2, PVT-v1, Res2Net-50 v1b and EfficientNet-B1 at test depth
(one train step's hybrid-E loss, every leaf's grad and the BatchNorm
statistics after it), ``EMIPShort`` on the linear PVTv2 and on PVT-v1
(mask logits and flows), and DGNet on EfficientNet-B1 (both outputs, eval
and train mode), each on weights carried by ``emip_tpu_torch.convert``.

Tolerances: the loss rel 1e-4, grads by the scale-floored relative max at
5e-3 (tests/test_torch_static.py); the two-stream outputs by the slice's
(mask atol 1e-2, flow atol 2e-2); outputs rtol 1e-3 / atol 1e-2. After a
train-mode call the statistics are held to 1e-4 of max|ref|: with batch
statistics over the /32 map of two 64^2 images (8 elements a channel) the
train-mode forward moves by ~1e-4 of its scale under a 1e-6 nudge of its
input (tests/test_torch_backbones.py holds one call's to 1e-5 where the
forward is steady).
"""

import functools

import numpy as np
import pytest
import torch

from tests import torch_helpers as th

TOL = dict(rtol=1e-3, atol=1e-2)
GRAD_REL = 5e-3
STATS_REL_AFTER_STEP = 1e-4
STATS = ("running_mean", "running_var")
# the CNNs' train steps at 96^2: at 64^2 their /32 BatchNorms see 8
# elements a channel, and Res2Net's grads part from JAX's (with the exact
# variance) by up to 8e-3 (3e-4 at 96^2, 18 elements a channel)
TRAIN_SIZE = {"res2net50_26w_4s": 96, "efficientnet_b1": 96}
# a grad below this share of the largest is held to be as small on the
# port's side, not relatively: EfficientNet's last BatchNorm bias in a
# block whose output reaches the loss only through the next block's expand
# conv and train-mode BatchNorm, which removes any per-channel shift, so
# that its true grad is zero and both sides give rounding noise
ZERO_GRAD = 1e-5


@pytest.fixture(scope="module", params=th.ALTERNATES)
def seg_pair(request):
    return (request.param, *th.alternate_seg_pair(request.param))


@pytest.fixture
def exact_flax_variance(monkeypatch):
    """flax's BatchNorm with its variance taken as E[(x - E[x])^2]: its
    default, E[x^2] - E[x]^2 in fp32, cancels where a channel's mean is
    large against its spread, which moves the train step's grads by up to
    6% in Res2Net at 96^2 (the same to 3e-4 with this fixture)."""
    import flax.linen as nn

    monkeypatch.setattr(nn, "BatchNorm", functools.partial(
        nn.BatchNorm, use_fast_variance=False))


def test_seg_network_train_step_matches_jax(seg_pair, exact_flax_variance):
    """Train mode (batch statistics, drop path off): the hybrid-E loss,
    d(loss)/d(every leaf), and the BatchNorm statistics after the step;
    the JAX side's BatchNorm variance exact (``exact_flax_variance``)."""
    import jax

    from emip_tpu.losses.seg import hybrid_e_loss as jax_loss

    from emip_tpu_torch.convert import state_dict_from_flax_seg
    from emip_tpu_torch.losses.seg import hybrid_e_loss

    name, jm, variables, port = seg_pair
    x, gt = th.seg_images(size=TRAIN_SIZE.get(name, th.SIZE), seed=8)

    def loss_fn(params, x):
        logits, upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, rngs={"droppath": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jax_loss(logits, gt), upd["batch_stats"]

    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"], x)
    want = state_dict_from_flax_seg(
        {"params": jax.tree_util.tree_map(np.asarray, grads_j),
         "batch_stats": variables["batch_stats"]})
    model = port.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = hybrid_e_loss(model(th.nchw(x)), th.nchw(gt))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-4)
    scale = max(float(want[n].abs().max()) for n in names)
    worst, zero = (0.0, ""), []
    for n, g in zip(names, grads):
        ref = float(want[n].abs().max())
        if ref <= ZERO_GRAD * scale:
            zero.append((float(g.abs().max()) / scale, n))
        else:
            worst = max(worst, (float((g - want[n]).abs().max())
                                / max(ref, 1e-6 * scale), n))
    assert set(names) == {k for k in want
                          if not k.endswith(STATS + ("num_batches_tracked",))}
    assert worst[0] <= GRAD_REL, worst
    assert all(r <= ZERO_GRAD for r, _ in zero), max(zero)
    if variables["batch_stats"]:
        after = state_dict_from_flax_seg(th.with_batch_stats(variables, stats_j))
        rel = th.stats_relmax(model, after)
        assert rel[0] <= STATS_REL_AFTER_STEP, rel
    model.load_state_dict(before)
    model.eval()


# ------------------------------------------------------------ two-stream


@pytest.mark.parametrize("name", ["pvt_v2_b2_li", "pvt_small"])
def test_emip_short_on_alternate_matches_jax(name):
    """The two-stream model on a backbone with GMFlow's 128-wide /8 stage:
    mask logits and both flows at 64^2."""
    import jax

    from emip_tpu.models.emip_short import EMIPShort as JaxShort
    from emip_tpu.models.emip_short import EMIPShortConfig as JaxCfg
    from emip_tpu.models.gmflow import GMFlowConfig as JaxGM

    from emip_tpu_torch.convert import state_dict_from_flax
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.gmflow import GMFlowConfig

    gm = dict(feature_channels=128, num_transformer_layers=th.NUM_LAYERS)
    jm = JaxShort(config=JaxCfg(backbone_name=th.jax_alternate(name),
                                channel=th.CHANNEL, inp_size=th.SIZE,
                                gmflow=JaxGM(**gm)))
    port = EMIPShort(EMIPShortConfig(
        backbone_name=th.torch_alternate(name), channel=th.CHANNEL,
        inp_size=th.SIZE, gmflow=GMFlowConfig(**gm)))
    rng = np.random.default_rng(31)
    f1, f2 = (rng.standard_normal((1, th.SIZE, th.SIZE, 3)).astype(
        np.float32) for _ in range(2))
    variables = th.random_variables(jm, f1, f2, seed=32, train=False)
    port.load_state_dict(state_dict_from_flax(
        variables, num_layers=th.NUM_LAYERS), strict=True)
    mask, fw, bw = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
        variables, f1, f2)
    with torch.no_grad():
        got = port.eval()(th.nchw(f1), th.nchw(f2))
    np.testing.assert_allclose(th.nhwc(got[0]), np.asarray(mask),
                               rtol=1e-3, atol=1e-2)
    for g, w in ((got[1][-1], fw[-1]), (got[2][-1], bw[-1])):
        np.testing.assert_allclose(th.nhwc(g), np.asarray(w), rtol=1e-3,
                                   atol=2e-2)


# ------------------------------------------------------------ DGNet


@pytest.mark.parametrize("train", [False, True])
def test_dgnet_matches_jax(train):
    """DGNet on EfficientNet-B1 at 64^2: both outputs, and in train mode
    the BatchNorm statistics after the call."""
    import jax

    from emip_tpu.models.dgnet import DGNet as JaxDGNet

    from emip_tpu_torch.convert import state_dict_from_flax_dgnet
    from emip_tpu_torch.models.dgnet import DGNet

    jm = JaxDGNet(arc="efficientnet_b1")
    x, _ = th.seg_images(seed=13)
    variables = th.random_variables(jm, x[:1], seed=33, train=False)
    port = DGNet(arc="efficientnet_b1")
    port.load_state_dict(state_dict_from_flax_dgnet(variables), strict=True)
    out, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=train, mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        got = port.train(train)(th.nchw(x))
    for g, w in zip(got, out):
        assert g.shape == (2, 1, th.SIZE, th.SIZE) and g.dtype == torch.float32
        np.testing.assert_allclose(th.nhwc(g), np.asarray(w), **TOL)
    if train:
        want = state_dict_from_flax_dgnet(th.with_batch_stats(variables,
                                                      upd["batch_stats"]))
        rel = th.stats_relmax(port, want)
        assert rel[0] <= STATS_REL_AFTER_STEP, rel
