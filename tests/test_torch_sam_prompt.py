"""The SAM prompt heads of the port against the JAX package, on the CPU.

Each class of ``emip_tpu_torch/models/sam_transformer.py`` and
``sam_prompt.py`` against its flax module (un-jitted ``apply``) on the
same seeded numpy weights and inputs, at a small size: image and flow
[2, 16, 16, 128] (the heads' published width, 128 channels and 8 heads, on
a 16 x 16 grid, ``inp_size`` 128), ``PromptGenBlock`` shrinking its 96^2
bank to 16^2 (the resize antialiases, as ``jax.image.resize`` does). The
heads' weights go from flax to the port through
``emip_tpu_torch.convert.state_dict_from_flax_sam`` and back through the
JAX package's ``convert_sam_prompt_state``, which must give the flax
params back, every registered-but-unused module included.

fp32: max|port - JAX| within 1e-5 of max|JAX|. bf16 (flax's rule on both
sides): within twice the larger of the port's and JAX's own bf16-vs-fp32
gaps (``torch_helpers.assert_bf16_band``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_helpers as th

from emip_tpu_torch.dtypes import set_compute_dtype

REL = 1e-5
B, H, C = 2, 16, 128
INP = 128  # inp_size: the 16 x 16 grid of patch 8
BF16 = torch.bfloat16


def _leaf(rng, path, shape):
    name = str(getattr(path[-1], "key", path[-1]))
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1])) or 1
        v = rng.standard_normal(shape) / np.sqrt(fan_in)
    elif name == "scale":
        v = rng.uniform(0.7, 1.3, shape)
    elif name == "bias":
        v = rng.normal(0.0, 0.05, shape)
    elif name == "prompt_param":
        v = rng.uniform(0.0, 1.0, shape)
    else:  # tokens, the positional matrix
        v = rng.standard_normal(shape)
    return v.astype(np.float32)


def _params(module, *args, seed=0):
    """Seeded numpy values for every param of a flax ``module`` (the
    shapes of ``init``, which registers the unused modules too)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)
    return th.to_numpy_tree(jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(rng, p, s.shape), shapes))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _generic_state(params, rename=(), transposed=()) -> dict:
    """flax params -> torch keys by the layout rules (Dense kernel
    transposed, Conv kernel [kh, kw, I, O] -> [O, I, kh, kw], scale ->
    weight, ``layer{i}`` / ``layers_{j}`` -> ``layers.{i}``) for the
    sub-blocks that have no carrier of their own; ``rename`` maps path
    prefixes, ``transposed`` names the transposed convolutions."""
    import re

    from emip_tpu_torch.convert import _conv, _conv_t, _lin

    sd = {}
    for path, v in _flat(params).items():
        mod, leaf = path.rsplit("/", 1)
        for a, b in rename:
            mod = mod.replace(a, b)
        key = re.sub(r"layers?_?(\d+)", r"layers.\1", mod).replace("/", ".")
        if leaf == "kernel":
            v = (_conv_t(v) if mod in transposed
                 else _conv(v) if v.ndim == 4 else _lin(v))
        sd[f"{key}.{'bias' if leaf == 'bias' else 'weight'}"] = \
            torch.from_numpy(np.ascontiguousarray(v))
    return sd


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().float()
        return x.permute(0, 2, 3, 1).numpy() if x.dim() == 4 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(port_fn, jax_fn, label):
    """fp32 within REL of max|JAX|; bf16 within the band."""
    got32, want32 = _np(port_fn(torch.float32)), _np(jax_fn(jnp.float32))
    assert got32.shape == want32.shape, (got32.shape, want32.shape)
    err = np.abs(got32 - want32).max() / np.abs(want32).max()
    assert err <= REL, (label, err)
    got16, want16 = _np(port_fn(BF16)), _np(jax_fn(jnp.bfloat16))
    th.assert_bf16_band(got16, got32, want16, want32, label)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((B, H, H, C)).astype(np.float32)
    flow = rng.standard_normal((B, H, H, C)).astype(np.float32)
    tokens = rng.standard_normal((B, 7, C)).astype(np.float32)
    return img, flow, tokens


def _module_pair(jax_cls, port, args, seed, **rules):
    """(flax params, ``apply`` in a dtype, the port module in a dtype):
    the port module takes the params through :func:`_generic_state`."""
    params = _params(jax_cls(), *args, seed=seed)
    port.load_state_dict(_generic_state(params, **rules), strict=True)

    def jax_apply(dtype, *a):
        return jax_cls(dtype=dtype).apply({"params": params}, *a)

    def port_in(dtype):
        set_compute_dtype(port, dtype)
        return port

    return jax_apply, port_in


# ------------------------------------------------ sam_transformer.py


@pytest.mark.parametrize("rate", [1, 2])
def test_downsampled_attention_matches_jax(inputs, rate):
    from emip_tpu.models.sam_transformer import DownsampledAttention as J

    from emip_tpu_torch.models.sam_transformer import DownsampledAttention

    img, _, tok = inputs
    keys = img.reshape(B, H * H, C)
    jcls = lambda dtype=jnp.float32: J(C, 8, rate, dtype=dtype)  # noqa
    jax_apply, port = _module_pair(jcls, DownsampledAttention(C, 8, rate),
                                   (tok, keys, keys), seed=1)
    tt, kt = torch.from_numpy(tok), torch.from_numpy(keys)
    _check(lambda dt: port(dt)(tt, kt, kt),
           lambda dt: jax_apply(dt, tok, keys, keys), "attention")


def test_mlp_block_matches_jax(inputs):
    from emip_tpu.models.sam_transformer import MLPBlock as J

    from emip_tpu_torch.models.sam_transformer import MLPBlock

    _, _, tok = inputs
    jcls = lambda dtype=jnp.float32: J(C, 256, dtype=dtype)  # noqa: E731
    jax_apply, port = _module_pair(jcls, MLPBlock(C, 256), (tok,), seed=2)
    t = torch.from_numpy(tok)
    _check(lambda dt: port(dt)(t), lambda dt: jax_apply(dt, tok), "mlp")


@pytest.mark.parametrize("skip", [True, False])
def test_two_way_attention_block_matches_jax(inputs, skip):
    from emip_tpu.models.sam_transformer import TwoWayAttentionBlock as J

    from emip_tpu_torch.models.sam_transformer import TwoWayAttentionBlock

    img, _, tok = inputs
    keys = img.reshape(B, H * H, C)
    pe = np.cos(keys)
    jcls = lambda dtype=jnp.float32: J(C, 8, 512, 2, skip,  # noqa: E731
                                       dtype=dtype)
    jax_apply, port = _module_pair(jcls, TwoWayAttentionBlock(C, 8, 512, 2,
                                                              skip),
                                   (tok, keys, tok, pe), seed=3)
    args = [torch.from_numpy(a) for a in (tok, keys, tok, pe)]
    for i in range(2):  # queries and keys
        _check(lambda dt: port(dt)(*args)[i],
               lambda dt: jax_apply(dt, tok, keys, tok, pe)[i],
               f"block {i}")


def test_two_way_transformer_matches_jax(inputs):
    from emip_tpu.models.sam_transformer import TwoWayTransformer as J

    from emip_tpu_torch.models.sam_transformer import TwoWayTransformer

    img, flow, tok = inputs
    jcls = lambda dtype=jnp.float32: J(2, C, 8, 512, dtype=dtype)  # noqa
    jax_apply, port = _module_pair(jcls, TwoWayTransformer(2, C, 8, 512),
                                   (img, flow, tok), seed=4,
                                   rename=(("layer0", "layers_0"),
                                           ("layer1", "layers_1")))
    args = (_nchw(img), _nchw(flow), torch.from_numpy(tok))
    for i in range(2):
        _check(lambda dt: port(dt)(*args)[i],
               lambda dt: jax_apply(dt, img, flow, tok)[i],
               f"transformer {i}")


# ------------------------------------------------------- sam_prompt.py


def test_mlp_matches_jax(inputs):
    from emip_tpu.models.sam_prompt import MLP as J

    from emip_tpu_torch.models.sam_prompt import MLP

    _, _, tok = inputs
    jcls = lambda dtype=jnp.float32: J(C, 16, 3, dtype=dtype)  # noqa: E731
    jax_apply, port = _module_pair(jcls, MLP(C, C, 16, 3), (tok,), seed=5)
    t = torch.from_numpy(tok)
    _check(lambda dt: port(dt)(t), lambda dt: jax_apply(dt, tok), "MLP")


@pytest.mark.parametrize("size", [16, 44])
def test_position_embedding_matches_jax(size):
    """The grid in the reference's (x, y) order; fp32 in both bands."""
    from emip_tpu.models.sam_prompt import PositionEmbeddingRandom as J

    from emip_tpu_torch.models.sam_prompt import PositionEmbeddingRandom

    params = _params(J(64), size, seed=6)
    want = np.asarray(J(64).apply({"params": params}, size))
    port = PositionEmbeddingRandom(64)
    port.load_state_dict({"positional_encoding_gaussian_matrix":
                          torch.from_numpy(params[
                              "positional_encoding_gaussian_matrix"])})
    got = port(size).permute(1, 2, 0).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert not port.positional_encoding_gaussian_matrix.requires_grad


def test_patch_embed_matches_jax(inputs):
    from emip_tpu.models.sam_prompt import PatchEmbed as J

    from emip_tpu_torch.models.sam_prompt import PatchEmbed

    _, flow, _ = inputs
    jcls = lambda dtype=jnp.float32: J(8, C, dtype=dtype)  # noqa: E731
    jax_apply, port = _module_pair(jcls, PatchEmbed(8, C, C), (flow,),
                                   seed=7)
    f = _nchw(flow)
    _check(lambda dt: port(dt)(f), lambda dt: jax_apply(dt, flow),
           "patch embed")


def test_flow_head_matches_jax(inputs):
    from emip_tpu.models.sam_prompt import FlowHead as J

    from emip_tpu_torch.convert import state_dict_from_flax_flow_head
    from emip_tpu_torch.models.sam_prompt import FlowHead

    img, _, _ = inputs
    params = _params(J(64), img, seed=8)
    port = {dt: FlowHead(C, 64, dtype=dt) for dt in (torch.float32, BF16)}
    for m in port.values():
        m.load_state_dict(state_dict_from_flax_flow_head(params), strict=True)
    x = _nchw(img)
    _check(lambda dt: port[dt](x),
           lambda dt: J(64, dtype=dt).apply({"params": params}, img),
           "flow head")


def test_prompt_gen_block_matches_jax():
    """The bank's softmax mix, resized 96 -> 16 with antialiasing
    (``jax.image.resize``; a resize without it is off by ~3e-2 here),
    then the 3x3 conv."""
    from emip_tpu.models.sam_prompt import PromptGenBlock as J

    from emip_tpu_torch.convert import state_dict_from_flax_prompt_gen
    from emip_tpu_torch.models.sam_prompt import PromptGenBlock

    x = np.random.default_rng(9).standard_normal(
        (B, H, H, 192)).astype(np.float32)
    params = _params(J(C, 5, 96, 192), x, seed=9)
    port = {dt: PromptGenBlock(C, 5, 96, 192, dtype=dt)
            for dt in (torch.float32, BF16)}
    for m in port.values():
        m.load_state_dict(state_dict_from_flax_prompt_gen(params),
                          strict=True)
    xt = _nchw(x)
    _check(lambda dt: port[dt](xt),
           lambda dt: J(C, 5, 96, 192, dtype=dt).apply({"params": params},
                                                       x),
           "prompt gen")


def test_mask_downscaling_and_output_upscaling_match_jax(inputs):
    """The conv / channel-LayerNorm / GELU pyramid (/8) and the transposed
    x4 upscaler, its kernels mirrored by the carrier's layout rule."""
    from emip_tpu.models.sam_prompt import _MaskDownscaling, _OutputUpscaling

    from emip_tpu_torch.models.sam_prompt import (
        _mask_downscaling,
        _output_upscaling,
    )

    img, _, _ = inputs
    masks = img[..., :4] * 3
    down = lambda dtype=jnp.float32: _MaskDownscaling(16, C,  # noqa: E731
                                                      dtype=dtype)
    jax_apply, port = _module_pair(
        down, _mask_downscaling(4, 16, C), (masks,), seed=10,
        rename=(("conv0", "0"), ("ln0", "1"), ("conv1", "3"), ("ln1", "4"),
                ("conv2", "6")))
    m = _nchw(masks)
    _check(lambda dt: port(dt)(m), lambda dt: jax_apply(dt, masks),
           "mask downscaling")
    up = lambda dtype=jnp.float32: _OutputUpscaling(C, dtype=dtype)  # noqa
    small = img[:, :8, :8]
    jax_apply, port = _module_pair(
        up, _output_upscaling(C), (small,), seed=11,
        rename=(("deconv0", "0"), ("ln", "1"), ("deconv1", "3")),
        transposed=("0", "3"))
    x = _nchw(small)
    _check(lambda dt: port(dt)(x), lambda dt: jax_apply(dt, small),
           "output upscaling")


@pytest.mark.parametrize("head", ["PromptInteract", "Interact"])
def test_heads_match_jax(inputs, head):
    """The heads on the image and flow embeddings; their weights through
    the carrier (flax -> port) and back through the JAX package's
    ``convert_sam_prompt_state`` (port -> flax), which gives the flax params
    back: every registered module, the unused ones included."""
    import emip_tpu.models.sam_prompt as jsam
    from emip_tpu.convert.torch_import import convert_sam_prompt_state

    import emip_tpu_torch.models.sam_prompt as sam
    from emip_tpu_torch.convert import state_dict_from_flax_sam

    img, flow, _ = inputs
    depth = 2 if head == "PromptInteract" else 1
    jcls = getattr(jsam, head)
    params = _params(jcls(inp_size=INP), img, flow, seed=12)
    sd = state_dict_from_flax_sam(params, depth)
    port = {dt: getattr(sam, head)(inp_size=INP, dtype=dt)
            for dt in (torch.float32, BF16)}
    for m in port.values():
        m.load_state_dict(sd, strict=True)
    back = _flat(convert_sam_prompt_state(port[torch.float32].state_dict(),
                                          depth))
    want = _flat(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    args = (_nchw(img), _nchw(flow))
    _check(lambda dt: port[dt](*args),
           lambda dt: jcls(inp_size=INP, dtype=dt).apply({"params": params},
                                                         img, flow),
           head)
