"""Shared setup for the PyTorch-port parity tests (tests/test_torch_*.py).

Importing this module caps torch's intra-op threads: the suite runs in
several pytest-xdist workers on one host. Inputs come from numpy seeds and
go to both frameworks as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)

SIZE = 64  # tiny slice: 64^2 frames, 8x8 flow features, 4x4 windows
DEPTHS = (1, 1, 1, 1)
NUM_LAYERS = 2
FDIM = 64  # = pvt_v2_b0's /8 width
CHANNEL = 8


def jax_tiny_short(drop_path_rate: float = 0.1, size: int = SIZE, *,
                   pvt: dict | None = None):
    """(JAX EMIPShort, its config) at b0 widths, reduced depth and size,
    exact GELU (a plain PVTv2Config) and the fused Pallas attention;
    ``pvt`` sets further PVTv2Config fields (the MixFFN switches)."""
    from emip_tpu.models.backbones import register_backbone
    from emip_tpu.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu.models.gmflow import GMFlowConfig
    from emip_tpu.models.pvt_v2 import PVTv2, PVTv2Config

    pvt = pvt or {}
    b0 = PVTv2Config((32, 64, 160, 256), (1, 2, 5, 8), (8, 8, 4, 4), DEPTHS,
                     (8, 4, 2, 1), drop_path_rate=drop_path_rate,
                     remat=False, fused_attn="always", **pvt)
    # one registry name per rate and switch: the registry is global to the
    # process
    name = f"pvt_v2_b0_port_parity_dp{drop_path_rate}" + "".join(
        f"_{k}{v}" for k, v in sorted(pvt.items()))
    register_backbone(name, lambda dtype: PVTv2(config=b0, dtype=dtype),
                      b0.embed_dims)
    cfg = EMIPShortConfig(
        backbone_name=name, channel=CHANNEL,
        inp_size=size,
        gmflow=GMFlowConfig(feature_channels=FDIM,
                            num_transformer_layers=NUM_LAYERS))
    return EMIPShort(config=cfg), cfg


def torch_tiny_short(include_dead_modules: bool = True,
                     drop_path_rate: float = 0.1, size: int = SIZE,
                     dtype: torch.dtype = torch.float32, *,
                     pvt: dict | None = None, **gmflow):
    """The port's EMIPShort at the same configuration, computing in
    ``dtype``; ``gmflow`` sets further :class:`GMFlowConfig` fields and
    ``pvt`` further :class:`PVTv2Config` fields (the kernel switches)."""
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.gmflow import GMFlowConfig
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS

    b0 = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b0"], depths=DEPTHS,
                             drop_path_rate=drop_path_rate, **(pvt or {}))
    cfg = EMIPShortConfig(
        backbone_name=b0, channel=CHANNEL, inp_size=size,
        gmflow=GMFlowConfig(feature_channels=FDIM,
                            num_transformer_layers=NUM_LAYERS, **gmflow),
        include_dead_modules=include_dead_modules)
    return EMIPShort(cfg, dtype=dtype).eval()


MEMORY_SIZE = 3  # slots of the tiny long model's ring


def jax_tiny_long(drop_path_rate: float = 0.0, size: int = SIZE,
                  dtype=None):
    """JAX EMIPLong around :func:`jax_tiny_short`'s configuration, with a
    3-slot memory, computing in ``dtype`` (None: fp32)."""
    import jax.numpy as jnp

    from emip_tpu.models.emip_long import EMIPLong

    _, cfg = jax_tiny_short(drop_path_rate, size)
    return EMIPLong(config=cfg, memory_size=MEMORY_SIZE,
                    dtype=jnp.float32 if dtype is None else dtype)


def torch_tiny_long(drop_path_rate: float = 0.0, size: int = SIZE,
                    dtype: torch.dtype = torch.float32, **gmflow):
    """The port's EMIPLong at the same configuration, computing in
    ``dtype``."""
    from emip_tpu_torch.models.emip_long import EMIPLong

    cfg = torch_tiny_short(True, drop_path_rate, size, **gmflow).config
    return EMIPLong(cfg, memory_size=MEMORY_SIZE, dtype=dtype).eval()


def random_variables(module, *args, seed: int = 0, **kwargs) -> dict:
    """Seeded numpy values for every variable of a flax ``module``.

    Shapes come from ``jax.eval_shape`` of ``module.init`` (no forward is
    executed). Kernels get fan-in scaled normals, norm scales and
    temperatures values near 1, biases small normals, BatchNorm statistics
    non-trivial means and positive variances, so every leaf is exercised.
    """
    import jax

    # keyword arguments are closed over, so they stay static Python values
    shapes = jax.eval_shape(lambda key, *a: module.init(key, *a, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) or 1
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "mean":
            v = rng.normal(0.0, 0.2, shape)
        elif name in ("var", "scale", "temperature"):
            v = rng.uniform(0.7, 1.3, shape)
        elif name == "bias":
            v = rng.normal(0.0, 0.05, shape)
        else:
            raise KeyError(f"no init rule for variable {name}")
        return v.astype(np.float32)

    return to_numpy_tree(jax.tree_util.tree_map_with_path(leaf, shapes))


def to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def tiny_yaml(path, root, save, **extra) -> str:
    """The tiny configuration as the entry points' YAML (train and val on
    the dataset root ``root``, checkpoints under ``save``); ``extra``
    replaces or adds top-level keys. Returns the file's path."""
    import yaml

    ds = dict(image_path=root, gt_path=root, inp_size=SIZE, batch_size=2)
    cfg = dict(
        train_dataset=ds, val_dataset=dict(ds, batch_size=1),
        model=dict(args=dict(
            inp_size=SIZE, channel=CHANNEL, backbone_name="pvt_v2_b0",
            include_dead_modules=False,
            GMFlow=dict(feature_channels=FDIM,
                        num_transformer_layers=NUM_LAYERS))),
        optimizer=dict(lr=1e-4, weight_decay=1e-7), compute_dtype="float32",
        seed=5, epoch=2, epoch_val=1, epoch_save=1, save_path=save)
    cfg.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)
