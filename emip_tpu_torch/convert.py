"""Weights into the port's models.

JAX package variables -> the port's ``state_dict``: the inverse of
:func:`emip_tpu.convert.torch_import.convert_emip_short_state` and
``convert_emip_long_state`` (which map the reference's torch keys to
flax variables): the same key space, the layout rules undone, and the
depth-stacked PVT ``stage{i}`` params un-stacked into ``block{i}.{j}``.
Input is the ``params`` and ``batch_stats`` trees as nested dicts of
arrays; nothing here imports jax or flax.

torch checkpoints of the reference (the YAML's ``load`` block) -> the
port's models: :func:`load_torch_weights`, the counterpart of
``maybe_load_reference_weights`` and ``maybe_load_reference_weights_long``.
The port keeps the reference's key space, so a snapshot loads as it is
once the reference's own load-time remaps are applied
(:func:`normalize_reference_keys`), with the keys the model lacks left out
and a key of another shape an error.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "state_dict_from_flax_long",
           "normalize_reference_keys", "load_torch_weights",
           "load_configured_weights", "SHORT_LOAD", "LONG_LOAD"]

log = logging.getLogger("emip_tpu_torch")

# fields of the config's ``load`` block: (wrapping key, prefix of the keys
# in the model, whether the reference's load-time remaps apply). ``path``
# and ``long_path`` are full snapshots of the reference's short and long
# models; ``flow_path`` is an upstream GMFlow checkpoint, whose weights sit
# under the short model's GMFlow.
_LOAD_FIELDS = {"path": ("state_dict", "", True),
                "flow_path": ("model", "GMFlow.", False),
                "long_path": ("state_dict", "", True)}
SHORT_LOAD = ("path", "flow_path")
LONG_LOAD = ("long_path",)


def normalize_reference_keys(sd: dict) -> dict:
    """The reference's load-time key remaps (its ``train.py``): the
    ``module.`` of a DataParallel snapshot dropped, and the legacy
    ``backbone.pvtv2_en`` moved under ``backbone.feat_net``."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if "backbone.pvtv2_en" in k and "feat_net" not in k:
            k = k.replace("backbone.pvtv2_en", "backbone.feat_net.pvtv2_en")
        out[k] = v
    return out


def load_torch_weights(model: torch.nn.Module, path: str | None,
                       unwrap: str = "state_dict", prefix: str = "",
                       remap: bool = True) -> None:
    """Load the torch checkpoint at ``path`` into ``model``.

    Nothing happens when ``path`` is null or not a file. Otherwise the
    checkpoint is read on the CPU, its ``unwrap`` entry taken where it has
    one, its keys remapped by :func:`normalize_reference_keys` (with
    ``remap``) and put under ``prefix``, and the tensors whose key the
    model has loaded (``strict=False``); a tensor of another shape than the
    model's raises ``ValueError``. One log line gives the count loaded and,
    with a few names each, the keys the model lacks (left out) and the
    model's keys under ``prefix`` that the file lacks.
    """
    if not path or not os.path.isfile(path):
        return
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and isinstance(ckpt.get(unwrap), dict):
        ckpt = ckpt[unwrap]
    if remap:
        ckpt = normalize_reference_keys(ckpt)
    own = model.state_dict()
    loaded, unexpected = {}, []
    for key, value in ckpt.items():
        key = prefix + key
        if key not in own:
            unexpected.append(key)
        elif tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{path}: shape mismatch at {key}: "
                             f"{tuple(own[key].shape)} vs {tuple(value.shape)}")
        else:
            loaded[key] = value
    missing = [k for k in own if k.startswith(prefix) and k not in loaded]
    model.load_state_dict(loaded, strict=False)
    log.info("loaded %d tensors from %s; %d unexpected left out %s; "
             "%d missing %s", len(loaded), path, len(unexpected),
             unexpected[:4], len(missing), missing[:4])


def load_configured_weights(model: torch.nn.Module, load, fields) -> None:
    """The checkpoints that ``load`` (the config's ``load`` block) names
    in ``fields`` (:data:`SHORT_LOAD` for ``EMIPShort``,
    :data:`LONG_LOAD` for ``EMIPLong``) into ``model``, in that order."""
    for field in fields:
        unwrap, prefix, remap = _LOAD_FIELDS[field]
        load_torch_weights(model, getattr(load, field), unwrap, prefix, remap)


def _conv(k) -> np.ndarray:
    """flax Conv kernel [kh, kw, I, O] -> torch Conv2d weight [O, I, kh, kw]."""
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _conv_t(k) -> np.ndarray:
    """flax ConvTranspose [kh, kw, I, O] -> torch [I, O, kh, kw], mirrored."""
    return np.ascontiguousarray(
        np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))


def _lin(k) -> np.ndarray:
    """flax Dense kernel [in, out] -> torch Linear weight [out, in]."""
    return np.ascontiguousarray(np.asarray(k).T)


class _Out:
    """Accumulates torch key -> array."""

    def __init__(self, params: dict, stats: dict):
        self.params = params
        self.stats = stats
        self.sd: dict[str, np.ndarray] = {}

    @staticmethod
    def _node(tree, path: str):
        for part in path.split("/"):
            tree = tree[part]
        return tree

    def p(self, path):
        return self._node(self.params, path)

    def has(self, path) -> bool:
        try:
            self.p(path)
        except KeyError:
            return False
        return True

    def conv(self, dst, src, transpose=False):
        node = self.p(src)
        self.sd[f"{dst}.weight"] = (_conv_t if transpose else _conv)(
            node["kernel"])
        if "bias" in node:
            self.sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def dense(self, dst, src, node=None):
        node = self.p(src) if node is None else node
        self.sd[f"{dst}.weight"] = _lin(node["kernel"])
        if "bias" in node:
            self.sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def ln(self, dst, src, node=None):
        node = self.p(src) if node is None else node
        self.sd[f"{dst}.weight"] = np.asarray(node["scale"])
        if "bias" in node:
            self.sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def bn(self, dst, src):
        self.ln(dst, src)
        st = self._node(self.stats, src)
        self.sd[f"{dst}.running_mean"] = np.asarray(st["mean"])
        self.sd[f"{dst}.running_var"] = np.asarray(st["var"])
        self.sd[f"{dst}.num_batches_tracked"] = np.asarray(0, np.int64)

    def convbr(self, dst, src):
        self.conv(f"{dst}.conv", f"{src}/conv")
        self.bn(f"{dst}.bn", f"{src}/bn")

    def dimred(self, dst, src):
        self.convbr(f"{dst}.reduce.0", f"{src}/reduce0")
        self.convbr(f"{dst}.reduce.1", f"{src}/reduce1")


def _index(tree, j):
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def _pvt_into(o: _Out, base: str, depths):
    dst = "backbone.feat_net.pvtv2_en"
    for i in range(1, len(depths) + 1):
        o.conv(f"{dst}.patch_embed{i}.proj", f"{base}/patch_embed{i}/proj")
        o.ln(f"{dst}.patch_embed{i}.norm", f"{base}/patch_embed{i}/norm")
        o.ln(f"{dst}.norm{i}", f"{base}/norm{i}")
        stage = o.p(f"{base}/stage{i}")
        for j in range(depths[i - 1]):
            blk = _index(stage, j)
            d = f"{dst}.block{i}.{j}"
            o.ln(f"{d}.norm1", None, blk["norm1"])
            o.ln(f"{d}.norm2", None, blk["norm2"])
            for name in ("q", "kv", "proj"):
                o.dense(f"{d}.attn.{name}", None, blk["attn"][name])
            if "sr" in blk["attn"]:
                o.sd[f"{d}.attn.sr.weight"] = _conv(blk["attn"]["sr"]["kernel"])
                o.sd[f"{d}.attn.sr.bias"] = np.asarray(
                    blk["attn"]["sr"]["bias"])
                o.ln(f"{d}.attn.norm", None, blk["attn"]["norm"])
            o.dense(f"{d}.mlp.fc1", None, blk["mlp"]["fc1"])
            o.sd[f"{d}.mlp.dwconv.dwconv.weight"] = _conv(
                blk["mlp"]["dwconv"]["kernel"])
            o.sd[f"{d}.mlp.dwconv.dwconv.bias"] = np.asarray(
                blk["mlp"]["dwconv"]["bias"])
            o.dense(f"{d}.mlp.fc2", None, blk["mlp"]["fc2"])


def _gmflow_into(o: _Out, base: str, num_layers: int):
    dst = "GMFlow"
    bb = f"{base}/backbone"
    o.conv(f"{dst}.backbone.conv1", f"{bb}/conv1")
    for L in (1, 2, 3):
        for j in (0, 1):
            blk = f"{bb}/layer{L}_{j}"
            d = f"{dst}.backbone.layer{L}.{j}"
            o.conv(f"{d}.conv1", f"{blk}/conv1")
            o.conv(f"{d}.conv2", f"{blk}/conv2")
            if o.has(f"{blk}/downsample"):
                o.conv(f"{d}.downsample.0", f"{blk}/downsample")
    o.conv(f"{dst}.backbone.conv2", f"{bb}/conv2")
    for name in ("dwconv64", "dwconv96", "dwconv128", "dwconv", "dwconv_pre",
                 "dwconv_post"):
        if o.has(f"{bb}/{name}"):
            o.conv(f"{dst}.backbone.{name}", f"{bb}/{name}")
    _transformer_into(o, f"{base}/transformer", f"{dst}.transformer",
                      num_layers)
    o.dense(f"{dst}.feature_flow_attn.q_proj", f"{base}/feature_flow_attn/q_proj")
    o.dense(f"{dst}.feature_flow_attn.k_proj", f"{base}/feature_flow_attn/k_proj")
    o.conv(f"{dst}.upsampler.0", f"{base}/upsampler_conv1")
    o.conv(f"{dst}.upsampler.2", f"{base}/upsampler_conv2")


def _transformer_into(o: _Out, base: str, dst: str, num_layers: int):
    for i in range(num_layers):
        for half in ("self_attn", "cross_attn_ffn"):
            src = f"{base}/layer{i}/{half}"
            d = f"{dst}.layers.{i}.{half}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                o.dense(f"{d}.{proj}", f"{src}/{proj}")
            o.ln(f"{d}.norm1", f"{src}/norm1")
            if o.has(f"{src}/mlp0"):
                o.dense(f"{d}.mlp.0", f"{src}/mlp0")
                o.dense(f"{d}.mlp.2", f"{src}/mlp2")
                o.ln(f"{d}.norm2", f"{src}/norm2")
            if o.has(f"{src}/adaptor_fc1"):
                o.dense(f"{d}.adaptor_fc1", f"{src}/adaptor_fc1")
                o.dense(f"{d}.adaptor_fc2", f"{src}/adaptor_fc2")


def _injector_into(o: _Out, name: str):
    d = f"{name}.transformer"
    for n in ("norm1", "norm2", "norm3"):
        o.ln(f"{d}.{n}.body", f"{name}/{n}")
    o.sd[f"{d}.attn.temperature"] = np.asarray(o.p(f"{name}/attn/temperature"))
    for conv in ("q", "q_dwconv", "kv", "kv_dwconv", "project_out"):
        o.conv(f"{d}.attn.{conv}", f"{name}/attn/{conv}")
    for conv in ("project_in", "dwconv", "project_out"):
        o.conv(f"{d}.ffn.{conv}", f"{name}/ffn/{conv}")


def _as_tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _decoder_into(o: _Out, dst: str, src: str):
    for name in ("conv_upsample1", "conv_upsample2", "conv_upsample3",
                 "conv_upsample4", "conv_upsample5", "conv_concat2",
                 "conv_concat3", "conv4"):
        o.convbr(f"{dst}.{name}", f"{src}/{name}")
    o.conv(f"{dst}.conv5", f"{src}/conv5")


def state_dict_from_flax(variables: dict, depths=(3, 6, 40, 3),
                         num_layers: int = 6) -> dict[str, torch.Tensor]:
    """JAX ``EMIPShort`` variables -> :class:`EMIPShort` ``state_dict``.

    ``depths`` are the PVT stage depths and ``num_layers`` the flow
    transformer's block count. Dead modules are converted when present.
    """
    o = _Out(variables["params"], variables.get("batch_stats", {}))
    _pvt_into(o, "backbone", depths)
    _gmflow_into(o, "gmflow", num_layers)
    _injector_into(o, "injector")
    _injector_into(o, "injector1")
    o.conv("conv_corr.0", "conv_corr_0")
    o.bn("conv_corr.1", "conv_corr_bn")
    o.conv("conv_corr.3", "conv_corr_1")
    for dr in ("dr1", "dr2", "dr3"):
        o.dimred(dr, dr)
    _decoder_into(o, "decoder", "decoder")
    if o.has("dr2_new"):
        o.conv("dr2_new", "dr2_new")
        o.conv("dr3_new.0", "dr3_new_conv0")
        o.bn("dr3_new.1", "dr3_new_bn0")
        o.conv("dr3_new.3", "dr3_new_conv1")
        o.bn("dr3_new.4", "dr3_new_bn1")
        o.conv("downscaling1.0", "downscaling1_conv")
        o.ln("downscaling1.1", "downscaling1_ln")
        o.conv("upscaling4.0", "upscaling4_conv0", transpose=True)
        o.ln("upscaling4.1", "upscaling4_ln")
        o.conv("upscaling4.3", "upscaling4_conv1", transpose=True)
        o.conv("upscaling3.0", "upscaling3_conv", transpose=True)
        o.ln("upscaling3.1", "upscaling3_ln")
    return _as_tensors(o.sd)


def state_dict_from_flax_long(variables: dict, depths=(3, 6, 40, 3),
                              num_layers: int = 6
                              ) -> dict[str, torch.Tensor]:
    """JAX ``EMIPLong`` variables -> :class:`EMIPLong` ``state_dict``.

    Inverse of ``convert_emip_long_state``: the frozen short-term net under
    ``short_term.`` (through :func:`state_dict_from_flax`), the LTM's
    key / value heads and prompt fusion, and the long head (``long_dr``,
    ``injector1``, ``dr1``, ``decoder``).
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    short = state_dict_from_flax(
        dict(params=params["short_term"],
             batch_stats=stats.get("short_term", {})), depths, num_layers)
    sd = {f"short_term.{k}": v for k, v in short.items()}
    o = _Out(params, stats)
    o.conv("LTM.KV_M_r4.Key", "ltm/kv_memory/key")
    o.conv("LTM.KV_M_r4.Value", "ltm/kv_memory/value")
    o.conv("LTM.KV_Q_r4.Key", "ltm/kv_query/key")
    o.conv("LTM.KV_Q_r4.Value", "ltm/kv_query/value")
    o.conv("LTM.fusion.conv1_fusion.0", "ltm/fuse/expand")
    o.bn("LTM.fusion.conv1_fusion.1", "ltm/fuse/bn")
    o.conv("LTM.fusion.conv1_fusion.3", "ltm/fuse/project")
    o.dimred("long_dr", "long_dr")
    _injector_into(o, "injector1")
    o.dimred("dr1", "dr1")
    _decoder_into(o, "decoder", "decoder")
    sd.update(_as_tensors(o.sd))
    return sd
