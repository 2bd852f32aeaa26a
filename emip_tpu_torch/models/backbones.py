"""Backbone factory: name (or configuration) -> (module, stage channels).

Counterpart of :mod:`emip_tpu.models.backbones`, under the JAX package's
names: the PVTv2 variants ``pvt_v2_b0``-``b5`` and the linear
``pvt_v2_b2_li``, PVT-v1's ``pvt_tiny``, ``pvt_small``, ``pvt_medium`` and
``pvt_large``, ``res2net50_26w_4s``, ``efficientnet_b1`` and
``efficientnet_b4``. Each module maps NCHW images to a tuple of four NCHW
stage features (/4, /8, /16, /32), of which the last three are used. A
family's configuration (:class:`PVTv2Config`, :class:`PVTv1Config`,
:class:`Res2NetConfig`, :class:`EfficientNetConfig`) may be passed in
place of a name (reduced depths in tests); there is no mutable registry.
"""

from __future__ import annotations

import dataclasses

import torch.nn as nn

from emip_tpu_torch.models.efficientnet import (
    EFFICIENTNET_VARIANTS,
    EfficientNetBackbone,
    EfficientNetConfig,
)
from emip_tpu_torch.models.pvt_v1 import PVT_V1_VARIANTS, PVTv1, PVTv1Config
from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS, PVTv2, PVTv2Config
from emip_tpu_torch.models.res2net import (
    RES2NET_VARIANTS,
    Res2Net50V1b,
    Res2NetConfig,
)

__all__ = ["create_backbone", "available_backbones", "BackboneConfig"]

BackboneConfig = PVTv2Config | PVTv1Config | Res2NetConfig | EfficientNetConfig

_VARIANTS = {**PVT_V2_VARIANTS, **PVT_V1_VARIANTS, **RES2NET_VARIANTS,
             **EFFICIENTNET_VARIANTS}
_MODULES = {PVTv2Config: PVTv2, PVTv1Config: PVTv1,
            Res2NetConfig: Res2Net50V1b, EfficientNetConfig: EfficientNetBackbone}


def create_backbone(name: str | BackboneConfig, **overrides
                    ) -> tuple[nn.Module, tuple[int, ...]]:
    """Returns (module, stage_channels). ``overrides`` replace fields of a
    PVTv2 configuration (the MixFFN switches ``fused_ffn``,
    ``ffn_dwconv``); a value of None leaves the field as it is, and any
    other value raises for the backbones that have no MixFFN."""
    if isinstance(name, str):
        if name not in _VARIANTS:
            raise ValueError(f"unknown backbone '{name}'; available: "
                             f"{available_backbones()}")
        cfg = _VARIANTS[name]
    else:
        cfg = name
    overrides = {k: v for k, v in overrides.items() if v is not None}
    if overrides:
        if not isinstance(cfg, PVTv2Config):
            raise ValueError(f"{sorted(overrides)} set the PVTv2 MixFFN; "
                             f"backbone {name!r} has none")
        cfg = dataclasses.replace(cfg, **overrides)
    module = _MODULES[type(cfg)](cfg)
    return module, module.stage_channels


def available_backbones() -> list[str]:
    return sorted(_VARIANTS)
