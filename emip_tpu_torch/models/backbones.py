"""Backbone factory: name (or PVTv2 configuration) -> (module, channels).

Counterpart of :mod:`emip_tpu.models.backbones`. The PVTv2 variants are
ported; the other encoders of the JAX zoo (PVT-v1, Res2Net, EfficientNet,
the linear PVTv2) raise :class:`NotImplementedError` until their slice
lands. A :class:`PVTv2Config` may be passed in place of a name (reduced
depths in tests); there is no mutable registry.
"""

from __future__ import annotations

import torch.nn as nn

from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS, PVTv2, PVTv2Config

__all__ = ["create_backbone", "available_backbones"]

_NOT_PORTED = ("pvt_v2_b2_li", "pvt_v1_tiny", "pvt_v1_small", "pvt_v1_medium",
               "pvt_v1_large", "res2net50_26w_4s", "efficientnet_b1",
               "efficientnet_b4")


def create_backbone(name: str | PVTv2Config) -> tuple[nn.Module,
                                                      tuple[int, ...]]:
    """Returns (module, stage_channels); the module maps NCHW images to a
    tuple of NCHW stage features, of which the last three are used."""
    if isinstance(name, PVTv2Config):
        return PVTv2(name), tuple(name.embed_dims)
    if name in PVT_V2_VARIANTS:
        cfg = PVT_V2_VARIANTS[name]
        return PVTv2(cfg), tuple(cfg.embed_dims)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backbone '{name}' is not ported to PyTorch yet")
    raise ValueError(f"unknown backbone '{name}'; available: "
                     f"{available_backbones()}")


def available_backbones() -> list[str]:
    return sorted(PVT_V2_VARIANTS)
