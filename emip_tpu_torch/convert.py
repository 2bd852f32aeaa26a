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
           "state_dict_from_flax_seg", "state_dict_from_flax_dgnet",
           "state_dict_from_flax_sam", "state_dict_from_flax_prompt_gen",
           "state_dict_from_flax_flow_head", "state_dict_from_flax_pvt_blocks",
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


def _stacked_depths(o: _Out, base: str, probe: str) -> tuple[int, ...]:
    """Blocks per stage of a scanned PVT: the leading axis of each stage's
    ``probe`` leaf."""
    node = o.p(base)
    return tuple(int(np.shape(o._node(node[f"stage{i}"], probe))[0])
                 for i in range(1, 5) if f"stage{i}" in node)


def _pvt_into(o: _Out, base: str, depths=None,
              dst: str = "backbone.feat_net.pvtv2_en"):
    """PVTv2 (plain or linear: every linear stage has ``sr`` and
    ``norm``); ``depths`` None reads them from the stacked params."""
    if depths is None:
        depths = _stacked_depths(o, base, "norm1/scale")
    for i in range(1, len(depths) + 1):
        o.conv(f"{dst}.patch_embed{i}.proj", f"{base}/patch_embed{i}/proj")
        o.ln(f"{dst}.patch_embed{i}.norm", f"{base}/patch_embed{i}/norm")
        o.ln(f"{dst}.norm{i}", f"{base}/norm{i}")
        stage = o.p(f"{base}/stage{i}")
        for j in range(depths[i - 1]):
            _pvt_block_into(o, f"{dst}.block{i}.{j}", _index(stage, j))


def _pvt_block_into(o: _Out, d: str, blk: dict):
    """One PVTv2 block's flax params ``blk`` under the torch prefix
    ``d``."""
    o.ln(f"{d}.norm1", None, blk["norm1"])
    o.ln(f"{d}.norm2", None, blk["norm2"])
    for name in ("q", "kv", "proj"):
        o.dense(f"{d}.attn.{name}", None, blk["attn"][name])
    if "sr" in blk["attn"]:
        o.sd[f"{d}.attn.sr.weight"] = _conv(blk["attn"]["sr"]["kernel"])
        o.sd[f"{d}.attn.sr.bias"] = np.asarray(blk["attn"]["sr"]["bias"])
        o.ln(f"{d}.attn.norm", None, blk["attn"]["norm"])
    o.dense(f"{d}.mlp.fc1", None, blk["mlp"]["fc1"])
    o.sd[f"{d}.mlp.dwconv.dwconv.weight"] = _conv(
        blk["mlp"]["dwconv"]["kernel"])
    o.sd[f"{d}.mlp.dwconv.dwconv.bias"] = np.asarray(
        blk["mlp"]["dwconv"]["bias"])
    o.dense(f"{d}.mlp.fc2", None, blk["mlp"]["fc2"])


def state_dict_from_flax_pvt_blocks(stacked: dict
                                    ) -> list[dict[str, torch.Tensor]]:
    """A PVTv2 stage's stacked block params (the JAX package's ``nn.scan``
    layout: each leaf with a leading depth axis) -> one ``PVTBlock`` state
    dict a block, in order."""
    depth = int(np.shape(stacked["norm1"]["scale"])[0])
    out = []
    for j in range(depth):
        o = _Out(stacked, {})
        _pvt_block_into(o, "blk", _index(stacked, j))
        out.append({k[len("blk."):]: v for k, v in _as_tensors(o.sd).items()})
    return out


def _pvt_v1_into(o: _Out, base: str, dst: str):
    """PVT-v1: patch embeddings, position tables ([N, C] -> [1, N, C]) and
    the depth-stacked blocks of ``lib/pvt.py``."""
    node = o.p(base)
    for i, depth in enumerate(_stacked_depths(o, base, "norm1/scale"), 1):
        o.conv(f"{dst}.patch_embed{i}.proj", f"{base}/patch_embed{i}_proj")
        o.ln(f"{dst}.patch_embed{i}.norm", f"{base}/patch_embed{i}_norm")
        o.sd[f"{dst}.pos_embed{i}"] = np.asarray(node[f"pos_embed{i}"])[None]
        stage = node[f"stage{i}"]
        for j in range(depth):
            blk = _index(stage, j)
            d = f"{dst}.block{i}.{j}"
            o.ln(f"{d}.norm1", None, blk["norm1"])
            o.ln(f"{d}.norm2", None, blk["norm2"])
            for name in ("q", "kv", "proj"):
                o.dense(f"{d}.attn.{name}", None, blk[name])
            if "sr" in blk:
                o.sd[f"{d}.attn.sr.weight"] = _conv(blk["sr"]["kernel"])
                o.sd[f"{d}.attn.sr.bias"] = np.asarray(blk["sr"]["bias"])
                o.ln(f"{d}.attn.norm", None, blk["norm"])
            o.dense(f"{d}.mlp.fc1", None, blk["fc1"])
            o.dense(f"{d}.mlp.fc2", None, blk["fc2"])


def _res2net_into(o: _Out, base: str, dst: str):
    """Res2Net-50 v1b: the deep stem as ``conv1.{0,1,3,4,6}`` and ``bn1``,
    the blocks' convs, splits and v1b shortcut (``downsample.1/.2``)."""
    for i, (conv, bn) in enumerate((("0", "1"), ("3", "4"), ("6", None))):
        o.conv(f"{dst}.conv1.{conv}", f"{base}/stem{i}")
        o.bn(f"{dst}.conv1.{bn}" if bn else f"{dst}.bn1",
             f"{base}/stem_bn{i}")
    blocks = sorted((tuple(int(v) for v in k[len("layer"):].split("_")), k)
                    for k in o.p(base) if k.startswith("layer"))
    for (stage, j), name in blocks:
        src, d = f"{base}/{name}", f"{dst}.layer{stage}.{j}"
        o.conv(f"{d}.conv1", f"{src}/conv1")
        o.bn(f"{d}.bn1", f"{src}/bn1")
        i = 0
        while o.has(f"{src}/convs{i}"):
            o.conv(f"{d}.convs.{i}", f"{src}/convs{i}")
            o.bn(f"{d}.bns.{i}", f"{src}/bns{i}")
            i += 1
        o.conv(f"{d}.conv3", f"{src}/conv3")
        o.bn(f"{d}.bn3", f"{src}/bn3")
        if o.has(f"{src}/down_conv"):
            o.conv(f"{d}.downsample.1", f"{src}/down_conv")
            o.bn(f"{d}.downsample.2", f"{src}/down_bn")


def _efficientnet_into(o: _Out, base: str, dst: str):
    """EfficientNet: ``_conv_stem``, ``_bn0`` and the MBConv blocks
    numbered across stages (flax ``block{stage}_{repeat}`` in order)."""
    o.conv(f"{dst}._conv_stem", f"{base}/stem")
    o.bn(f"{dst}._bn0", f"{base}/stem_bn")
    blocks = sorted((tuple(int(v) for v in k[len("block"):].split("_")), k)
                    for k in o.p(base) if k.startswith("block"))
    for n, (_, name) in enumerate(blocks):
        src, d = f"{base}/{name}", f"{dst}._blocks.{n}"
        if o.has(f"{src}/expand_conv"):
            o.conv(f"{d}._expand_conv", f"{src}/expand_conv")
            o.bn(f"{d}._bn0", f"{src}/bn0")
        o.conv(f"{d}._depthwise_conv", f"{src}/dwconv")
        o.bn(f"{d}._bn1", f"{src}/bn1")
        o.conv(f"{d}._se_reduce", f"{src}/se_reduce")
        o.conv(f"{d}._se_expand", f"{src}/se_expand")
        o.conv(f"{d}._project_conv", f"{src}/project_conv")
        o.bn(f"{d}._bn2", f"{src}/bn2")


def _encoder_into(o: _Out, base: str, prefix: str = "backbone.feat_net",
                  depths=None):
    """Any backbone of the registry, told apart by its flax names, under
    ``prefix.<the encoder's feat_net_key>``."""
    from emip_tpu_torch.models.efficientnet import EfficientNetBackbone
    from emip_tpu_torch.models.pvt_v1 import PVTv1
    from emip_tpu_torch.models.pvt_v2 import PVTv2
    from emip_tpu_torch.models.res2net import Res2Net50V1b

    node = o.p(base)
    if "patch_embed1" in node:
        _pvt_into(o, base, depths, f"{prefix}.{PVTv2.feat_net_key}")
    elif "patch_embed1_proj" in node:
        _pvt_v1_into(o, base, f"{prefix}.{PVTv1.feat_net_key}")
    elif "stem0" in node:
        _res2net_into(o, base, f"{prefix}.{Res2Net50V1b.feat_net_key}")
    elif "stem" in node:
        _efficientnet_into(o, base,
                           f"{prefix}.{EfficientNetBackbone.feat_net_key}")
    else:
        raise KeyError(f"{base}: not a backbone of the registry")


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


def state_dict_from_flax(variables: dict, depths=None,
                         num_layers: int = 6) -> dict[str, torch.Tensor]:
    """JAX ``EMIPShort`` variables -> :class:`EMIPShort` ``state_dict``.

    ``depths`` are the PVTv2 stage depths (None: read from the stacked
    params) and ``num_layers`` the flow transformer's block count. Dead
    modules are converted when present.
    """
    o = _Out(variables["params"], variables.get("batch_stats", {}))
    _encoder_into(o, "backbone", depths=depths)
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


def state_dict_from_flax_seg(variables: dict, depths=None
                             ) -> dict[str, torch.Tensor]:
    """JAX ``SegNetwork`` variables -> :class:`SegNetwork` ``state_dict``,
    for any backbone of the registry (``depths``: as
    :func:`state_dict_from_flax`'s).

    The flax module names its backbone itself (``PVTv2_0``,
    ``Res2Net50V1b_0``, ...): the one top-level entry that is not
    ``dr1``-``dr3`` or ``decoder``.
    """
    params = variables["params"]
    o = _Out(params, variables.get("batch_stats", {}))
    heads = ("dr1", "dr2", "dr3", "decoder")
    (backbone,) = [k for k in params if k not in heads]
    _encoder_into(o, backbone, depths=depths)
    for dr in heads[:3]:
        o.dimred(dr, dr)
    _decoder_into(o, "decoder", "decoder")
    return _as_tensors(o.sd)


def state_dict_from_flax_dgnet(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ``DGNet`` variables -> :class:`DGNet` ``state_dict``: the
    context encoder (the flax module's unnamed ``EfficientNetBackbone_0``)
    under ``context_encoder``, ``dr3``-``dr5``, the texture encoder, the
    transition's grouped convs and the NCD."""
    params = variables["params"]
    o = _Out(params, variables.get("batch_stats", {}))
    heads = ("dr3", "dr4", "dr5", "texture", "git", "ncd")
    (encoder,) = [k for k in params if k not in heads]
    _efficientnet_into(o, encoder, "context_encoder")
    for dr in heads[:3]:
        o.dimred(dr, dr)
    for name in ("conv1", "conv2", "conv3", "conv_out"):
        o.convbr(f"texture_encoder.{name}", f"texture/{name}")
    for i in (3, 4, 5):
        for j in (1, 2, 3):
            o.conv(f"git.sgs{i}.g_conv{j}", f"git/sgs{i}/g_conv{j}")
    _decoder_into(o, "ncd", "ncd")
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


def _sam_attention_into(o: _Out, dst: str, src: str):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        o.dense(f"{dst}.{proj}", f"{src}/{proj}")


def state_dict_from_flax_sam(params: dict, depth: int = 2
                             ) -> dict[str, torch.Tensor]:
    """JAX ``PromptInteract`` (``depth`` 2) or ``Interact`` (``depth`` 1)
    params -> the port's ``state_dict``: the inverse of
    ``convert_sam_prompt_state``, the modules the forward never runs
    included (flow head, motion tokens; on ``Interact`` the flow and mask
    tokens, the upscaler, the hypernetwork MLPs and the mask
    downscaler)."""
    o = _Out(params, {})
    for name in ("mask_tokens", "flow_tokens"):
        if name in params:
            o.sd[f"{name}.weight"] = np.asarray(params[name])
    o.sd["motion_tokens"] = np.asarray(params["motion_tokens"])
    o.sd["pe_layer.positional_encoding_gaussian_matrix"] = np.asarray(
        o.p("pe_layer/positional_encoding_gaussian_matrix"))
    o.conv("PatchEmbed.proj", "PatchEmbed/proj")
    for i in range(depth):
        dst, src = f"transformer.layers.{i}", f"transformer/layer{i}"
        for attn in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            _sam_attention_into(o, f"{dst}.{attn}", f"{src}/{attn}")
        for n in ("norm1", "norm2", "norm3", "norm4"):
            o.ln(f"{dst}.{n}", f"{src}/{n}")
        o.dense(f"{dst}.mlp.lin1", f"{src}/mlp/lin1")
        o.dense(f"{dst}.mlp.lin2", f"{src}/mlp/lin2")
    _sam_attention_into(o, "transformer.final_attn_token_to_image",
                        "transformer/final_attn_token_to_image")
    o.ln("transformer.norm_final_attn", "transformer/norm_final_attn")
    o.conv("output_upscaling.0", "output_upscaling/deconv0", transpose=True)
    o.ln("output_upscaling.1", "output_upscaling/ln")
    o.conv("output_upscaling.3", "output_upscaling/deconv1", transpose=True)
    for name, node in params.items():
        if name.startswith("output_hypernetworks_mlps_"):
            i = name.rsplit("_", 1)[1]
            for layer in node:
                o.dense(f"output_hypernetworks_mlps.{i}.layers."
                        f"{layer.split('_')[1]}", f"{name}/{layer}")
    for layer in params["flow_head"]:
        o.dense(f"flow_head.layers.{layer.split('_')[1]}",
                f"flow_head/{layer}")
    for dst, src in (("0", "conv0"), ("3", "conv1"), ("6", "conv2")):
        o.conv(f"mask_downscaling.{dst}", f"mask_downscaling/{src}")
    o.ln("mask_downscaling.1", "mask_downscaling/ln0")
    o.ln("mask_downscaling.4", "mask_downscaling/ln1")
    return _as_tensors(o.sd)


def state_dict_from_flax_prompt_gen(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``PromptGenBlock`` params -> the port's: the prompt bank [L, S,
    S, C] as the reference's [1, L, C, S, S]."""
    o = _Out(params, {})
    o.sd["prompt_param"] = np.asarray(params["prompt_param"]).transpose(
        0, 3, 1, 2)[None]
    o.dense("linear_layer", "linear_layer")
    o.conv("conv3x3", "conv3x3")
    return _as_tensors(o.sd)


def state_dict_from_flax_flow_head(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``FlowHead`` params -> the port's."""
    o = _Out(params, {})
    o.conv("conv1", "conv1")
    o.conv("conv2", "conv2")
    return _as_tensors(o.sd)
