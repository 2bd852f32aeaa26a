"""The alternate encoders in the bf16 band against the JAX package in bf16,
on the CPU: ``SegNetwork`` on the linear PVTv2 (kernel A's plain bf16
version on 49 pooled keys, the Pallas kernel in interpret mode on the JAX
side), PVT-v1 (its own attention, fp32 residual stream), Res2Net-50 v1b and
EfficientNet-B1 at test depth, eval and train mode (batch statistics). Same
weights through ``emip_tpu_torch.convert``, the same fp32 images on both
sides. The two-stream model and DGNet in bf16 are in
tests/test_torch_bf16_backbones_models.py.

The slice's bf16 rule (:func:`tests.torch_helpers.assert_bf16_band`): the
port's bf16 output lies within twice the larger of the port's and JAX's
bf16-vs-fp32 gaps of JAX's bf16 output, and both gaps are above zero.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from tests import torch_helpers as th

BF16 = torch.bfloat16


@pytest.fixture(scope="module", params=th.ALTERNATES)
def seg_outputs(request):
    """(name, {(side, dtype, train): logits}) of ``SegNetwork`` on one set
    of seeded variables: both packages, fp32 and bf16, eval and train mode
    (one JAX compilation a dtype for both modes)."""
    from emip_tpu.models.emip_short import SegNetwork as JaxSeg

    from emip_tpu_torch.convert import state_dict_from_flax_seg
    from emip_tpu_torch.models.emip_short import SegNetwork

    name = request.param
    reg = th.jax_alternate(name)
    x, _ = th.seg_images(seed=16)
    variables = th.random_variables(JaxSeg(backbone_name=reg,
                                           channel=th.CHANNEL), x[:1],
                                    seed=27, train=False)
    sd = state_dict_from_flax_seg(variables)
    out = {}
    for dt, jdt in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        jm = JaxSeg(backbone_name=reg, channel=th.CHANNEL, dtype=jdt)

        def both(v, x):
            train, _ = jm.apply(v, x, train=True, mutable=["batch_stats"],
                                rngs={"droppath": jax.random.PRNGKey(0)})
            return jm.apply(v, x, train=False), train

        for train, logits in zip((False, True), jax.jit(both)(variables, x)):
            out[("jax", dt, train)] = logits
        port = SegNetwork(th.torch_alternate(name), th.CHANNEL, dtype=dt)
        port.load_state_dict(sd, strict=True)
        for train in (False, True):
            with torch.no_grad():
                got = port.train(train)(th.nchw(x))
            assert got.dtype == torch.float32
            out[("port", dt, train)] = th.nhwc(got)
    return name, out


@pytest.mark.parametrize("train", [False, True])
def test_seg_network_bf16_matches_jax(seg_outputs, train):
    name, out = seg_outputs
    th.assert_bf16_band(*(out[(side, dt, train)] for side, dt in (
        ("port", BF16), ("port", torch.float32), ("jax", BF16),
        ("jax", torch.float32))), f"{name} train={train}")
