"""The two-stream model on the alternate encoders and DGNet in the bf16
band against the JAX package in bf16, on the CPU: ``EMIPShort`` on the
linear PVTv2 (kernel A's plain bf16 version on 49 pooled keys against the
Pallas kernel in interpret mode) and on PVT-v1 (mask logits and the last
forward flow), DGNet on EfficientNet-B1 (both outputs), at test depth and
64^2, on weights carried by ``emip_tpu_torch.convert``, held by the
slice's bf16 rule (:func:`tests.torch_helpers.assert_bf16_band`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

BF16 = torch.bfloat16


@pytest.mark.parametrize("name", ["pvt_v2_b2_li", "pvt_small"])
def test_emip_short_bf16_on_alternate_matches_jax(name):
    """Mask logits and the last forward flow of the two-stream model."""
    from emip_tpu.models.emip_short import EMIPShort as JaxShort
    from emip_tpu.models.emip_short import EMIPShortConfig as JaxCfg
    from emip_tpu.models.gmflow import GMFlowConfig as JaxGM

    from emip_tpu_torch.convert import state_dict_from_flax
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.gmflow import GMFlowConfig

    gm = dict(feature_channels=128, num_transformer_layers=th.NUM_LAYERS)
    jcfg = JaxCfg(backbone_name=th.jax_alternate(name), channel=th.CHANNEL,
                  inp_size=th.SIZE, gmflow=JaxGM(**gm))
    cfg = EMIPShortConfig(backbone_name=th.torch_alternate(name),
                          channel=th.CHANNEL, inp_size=th.SIZE,
                          gmflow=GMFlowConfig(**gm))
    f1, f2 = th.seg_images(1, seed=41)[0], th.seg_images(1, seed=42)[0]
    variables = th.random_variables(JaxShort(config=jcfg), f1, f2, seed=43,
                                    train=False)
    sd = state_dict_from_flax(variables, num_layers=th.NUM_LAYERS)
    out = {}
    for dt, jdt in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        jm = JaxShort(config=jcfg, dtype=jdt)
        mask, fw, _ = jax.jit(lambda v, a, b: jm.apply(
            v, a, b, train=False))(variables, f1, f2)
        out[("jax", dt)] = (np.asarray(mask), np.asarray(fw[-1]))
        port = EMIPShort(cfg, dtype=dt)
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            m, f, _ = port.eval()(th.nchw(f1), th.nchw(f2))
        out[("port", dt)] = (th.nhwc(m), th.nhwc(f[-1]))
    for i, label in enumerate(("mask", "flow_fw")):
        th.assert_bf16_band(*(out[k][i] for k in (("port", BF16), ("port", torch.float32),
                                    ("jax", BF16), ("jax", torch.float32))),
              f"{name} {label}")


def test_dgnet_bf16_matches_jax():
    from emip_tpu.models.dgnet import DGNet as JaxDGNet

    from emip_tpu_torch.convert import state_dict_from_flax_dgnet
    from emip_tpu_torch.models.dgnet import DGNet

    x, _ = th.seg_images(seed=44)
    variables = th.random_variables(JaxDGNet(arc="efficientnet_b1"), x[:1],
                                    seed=45, train=False)
    sd = state_dict_from_flax_dgnet(variables)
    out = {}
    for dt, jdt in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        jm = JaxDGNet(arc="efficientnet_b1", dtype=jdt)
        out[("jax", dt)] = [np.asarray(o) for o in jax.jit(
            lambda v, x: jm.apply(v, x, train=False))(variables, x)]
        port = DGNet(arc="efficientnet_b1", dtype=dt)
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out[("port", dt)] = [th.nhwc(o) for o in port.eval()(th.nchw(x))]
    for i, label in enumerate(("context", "texture")):
        th.assert_bf16_band(*(out[k][i] for k in (("port", BF16), ("port", torch.float32),
                                    ("jax", BF16), ("jax", torch.float32))),
              label)
