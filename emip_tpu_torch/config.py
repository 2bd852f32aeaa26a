"""YAML run configuration for the port (no jax).

Reads the same keys as :func:`emip_tpu.utils.config.load_config` (which
imports the flax models and so cannot be used here) into the port's own
dataclasses, ``memory_size`` and ``val_dataset_cad`` of the long-term
model included. Keys that only steer the JAX package (``parallel``,
``compute_dtype``, ``long_frames_per_dispatch``) are read and ignored: the
port trains on one card in fp32, one frame per step.
"""

from __future__ import annotations

import dataclasses
import os

from emip_tpu_torch.models.emip_short import EMIPShortConfig
from emip_tpu_torch.models.gmflow import GMFlowConfig

__all__ = ["DatasetConfig", "Config", "load_config", "snapshot_config"]


@dataclasses.dataclass
class DatasetConfig:
    image_path: str = ""
    gt_path: str = ""
    inp_size: int = 352
    batch_size: int = 6
    dataset_type: str = "MoCA"
    augment: bool = True


@dataclasses.dataclass
class Config:
    train_dataset: DatasetConfig
    val_dataset: DatasetConfig
    model: EMIPShortConfig
    lr: float = 1.0e-5
    weight_decay: float = 1.0e-7
    lr_min: float = 1.0e-6
    epoch_max: int = 30
    epoch: int = 100
    epoch_val: int = 1
    epoch_save: int = 1
    clip: float = 0.5
    seed: int = 123
    save_path: str = "./snapshots/emip_tpu_torch/"
    memory_size: int = 5  # slots of the long-term model's rolling memory
    val_dataset_cad: DatasetConfig | None = None
    raw: dict | None = None


def _dataset(d: dict | None) -> DatasetConfig | None:
    if d is None:
        return None
    return DatasetConfig(
        image_path=d.get("image_path", ""),
        gt_path=d.get("gt_path", d.get("image_path", "")),
        inp_size=int(d.get("inp_size", 352)),
        batch_size=int(d.get("batch_size", 6)),
        dataset_type=str(d.get("dataset_type", "MoCA")),
        augment=bool(d.get("augment", True)),
    )


def _model(d: dict) -> EMIPShortConfig:
    args = d.get("args", d)
    gm = args.get("GMFlow", {})
    gmflow = GMFlowConfig(
        num_scales=int(gm.get("num_scales", 1)),
        upsample_factor=int(gm.get("upsample_factor", 8)),
        feature_channels=int(gm.get("feature_channels", 128)),
        num_transformer_layers=int(gm.get("num_transformer_layers", 6)),
        ffn_dim_expansion=int(gm.get("ffn_dim_expansion", 4)),
        attn_splits_list=tuple(gm.get("attn_splits_list", [2])),
        corr_radius_list=tuple(gm.get("corr_radius_list", [-1])),
        prop_radius_list=tuple(gm.get("prop_radius_list", [-1])),
        pred_bidir_flow=bool(gm.get("pred_bidir_flow", True)),
    )
    return EMIPShortConfig(
        backbone_name=str(args.get("backbone_name", "pvt_v2_b5")),
        channel=int(args.get("channel", 32)),
        inp_size=int(args.get("inp_size", 352)),
        gmflow=gmflow,
        include_dead_modules=bool(args.get("include_dead_modules", True)),
    )


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    opt = raw.get("optimizer", {}) or {}
    cfg = Config(
        train_dataset=_dataset(raw.get("train_dataset") or {}),
        val_dataset=_dataset(raw.get("val_dataset") or {}),
        val_dataset_cad=_dataset(raw.get("val_dataset_cad")),
        memory_size=int(raw.get("memory_size", 5)),
        model=_model(raw.get("model", {})),
        lr=float(opt.get("lr", 1.0e-5)),
        weight_decay=float(opt.get("weight_decay", 1.0e-7)),
        lr_min=float(raw.get("lr_min", 1.0e-6)),
        epoch_max=int(raw.get("epoch_max", 30)),
        epoch=int(raw.get("epoch", 100)),
        epoch_val=int(raw.get("epoch_val", 1)),
        epoch_save=int(raw.get("epoch_save", 1)),
        clip=float(raw.get("clip", 0.5)),
        seed=int(raw.get("seed", 123)),
        save_path=str(raw.get("save_path", "./snapshots/emip_tpu_torch/")),
        raw=raw,
    )
    if cfg.model.inp_size % 32 != 0:
        raise ValueError("inp_size must be divisible by 32")
    return cfg


def snapshot_config(cfg: Config, save_path: str) -> None:
    """Dump the raw config next to the checkpoints."""
    import yaml

    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg.raw, f, sort_keys=False)
