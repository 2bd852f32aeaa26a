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
                   pvt: dict | None = None, depths=DEPTHS):
    """(JAX EMIPShort, its config) at b0 widths, reduced depth (``depths``
    blocks a stage) and size, exact GELU (a plain PVTv2Config) and the
    fused Pallas attention; ``pvt`` sets further PVTv2Config fields (the
    MixFFN switches)."""
    from emip_tpu.models.backbones import register_backbone
    from emip_tpu.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu.models.gmflow import GMFlowConfig
    from emip_tpu.models.pvt_v2 import PVTv2, PVTv2Config

    pvt = pvt or {}
    b0 = PVTv2Config((32, 64, 160, 256), (1, 2, 5, 8), (8, 8, 4, 4), depths,
                     (8, 4, 2, 1), drop_path_rate=drop_path_rate,
                     remat=False, fused_attn="always", **pvt)
    # one registry name per rate, depth and switch: the registry is global
    # to the process
    name = f"pvt_v2_b0_port_parity_dp{drop_path_rate}" + "".join(
        f"_{k}{v}" for k, v in sorted(pvt.items())) + (
        "" if tuple(depths) == DEPTHS else f"_depths{tuple(depths)}")
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


# the alternate encoders at test depths: PVTs (1, 1, 1, 1) blocks a stage,
# Res2Net one Bottle2neck a stage, EfficientNet-B1 as it is
ALTERNATES = ("pvt_v2_b2_li", "pvt_small", "res2net50_26w_4s",
              "efficientnet_b1")


def jax_alternate(name: str) -> str:
    """Registers the JAX package's ``name`` at test depth (drop path off,
    exact GELU and the fused Pallas attention for the linear PVTv2) under
    a name of its own, and returns that name."""
    from emip_tpu.models import efficientnet, pvt_v1, pvt_v2, res2net
    from emip_tpu.models.backbones import register_backbone

    reg = f"{name}_port_parity"
    if name == "pvt_v2_b2_li":
        cfg = pvt_v2.PVTv2Config((64, 128, 320, 512), (1, 2, 5, 8),
                                 (8, 8, 4, 4), DEPTHS, (8, 4, 2, 1),
                                 drop_path_rate=0.0, linear=True,
                                 remat=False, fused_attn="always")
        register_backbone(reg, lambda dtype: pvt_v2.PVTv2(config=cfg,
                                                          dtype=dtype),
                          cfg.embed_dims)
    elif name == "pvt_small":
        cfg = pvt_v1.PVTv1Config(depths=DEPTHS, drop_path_rate=0.0)
        register_backbone(reg, lambda dtype: pvt_v1.PVTv1(config=cfg,
                                                          dtype=dtype),
                          cfg.embed_dims)
    elif name == "res2net50_26w_4s":
        register_backbone(reg, lambda dtype: res2net.Res2Net50V1b(
            layers=DEPTHS, dtype=dtype), (256, 512, 1024, 2048))
    else:
        register_backbone(reg, lambda dtype: efficientnet.EfficientNetBackbone(
            variant=name, dtype=dtype),
            efficientnet.EfficientNetBackbone.stage_channels(name))
    return reg


def torch_alternate(name: str):
    """The port's configuration of :func:`jax_alternate`'s backbone."""
    from emip_tpu_torch.models import pvt_v1, pvt_v2, res2net

    if name == "pvt_v2_b2_li":
        return dataclasses.replace(pvt_v2.PVT_V2_VARIANTS[name], depths=DEPTHS,
                                   drop_path_rate=0.0)
    if name == "pvt_small":
        return pvt_v1.PVTv1Config(depths=DEPTHS, drop_path_rate=0.0)
    if name == "res2net50_26w_4s":
        return res2net.Res2NetConfig(layers=DEPTHS)
    return name


def alternate_seg_pair(name: str, size: int = SIZE):
    """(flax SegNetwork, its seeded variables, the port's SegNetwork with
    the same weights) on the alternate encoder ``name`` at test depth."""
    from emip_tpu.models.emip_short import SegNetwork as JaxSeg

    from emip_tpu_torch.convert import state_dict_from_flax_seg
    from emip_tpu_torch.models.emip_short import SegNetwork

    jm = JaxSeg(backbone_name=jax_alternate(name), channel=CHANNEL)
    img = np.zeros((1, size, size, 3), np.float32)
    variables = random_variables(jm, img, seed=23, train=False)
    port = SegNetwork(torch_alternate(name), CHANNEL)
    port.load_state_dict(state_dict_from_flax_seg(variables), strict=True)
    return jm, variables, port


def seg_images(n: int = 2, size: int = SIZE, seed: int = 6):
    """Seeded images [n, size, size, 3] and binary GT [n, size, size, 1]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            (rng.uniform(size=(n, size, size, 1)) > 0.6).astype(np.float32))


def with_batch_stats(variables, updated) -> dict:
    """``variables``' params with the ``batch_stats`` a mutable apply
    returned, as numpy."""
    import jax

    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map(np.asarray, updated)}


def stats_relmax(port: torch.nn.Module, want: dict) -> tuple[float, str]:
    """Worst max|port - flax| / max|flax| over the BatchNorm buffers of a
    converted state dict ``want``, and its key."""
    own = port.state_dict()
    return max(((float((own[k] - v).abs().max() / v.abs().max()), k)
                for k, v in want.items()
                if k.endswith(("running_mean", "running_var"))),
               default=(0.0, ""))


def assert_bf16_band(port16, port32, jax16, jax32, label: str = "") -> None:
    """The slice's bf16 rule: with gap(X) = max|X in bf16 - X in fp32| on
    the same side, the port's bf16 output lies within twice the larger of
    the port's and JAX's gaps of JAX's bf16 output, and both gaps are above
    zero (both sides compute in bf16)."""
    port16, port32 = np.asarray(port16), np.asarray(port32)
    jax16, jax32 = np.asarray(jax16), np.asarray(jax32)
    gap_port = np.abs(port16 - port32).max()
    gap_jax = np.abs(jax16 - jax32).max()
    err = np.abs(port16 - jax16).max()
    assert gap_port > 0 and gap_jax > 0, (label, gap_port, gap_jax)
    assert err <= 2 * max(gap_port, gap_jax), (label, err, gap_port, gap_jax)


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
        elif name.startswith("pos_embed"):  # PVT-v1's position tables
            v = rng.normal(0.0, 0.5, shape)
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


# ------------------------------------------------ data parallelism
# tests/test_torch_ddp.py: the same cases run in one process on the whole
# batch and in each rank of a gloo group on its rows (ddp_worker)

DDP_DEPTHS = (1, 1, 2, 1)
DDP_BATCH = 4  # global batch: 2 rows a rank on 2 ranks
DDP_SEED = 11
DDP_LR = 1e-3
# case -> (model, compute dtype, drop path rate, steps)
DDP_CASES = {"short_fp32": ("short", torch.float32, 0.0, 1),
             "short_fp32_dp": ("short", torch.float32, 0.1, 1),
             "short_bf16": ("short", torch.bfloat16, 0.0, 1),
             "static": ("static", torch.float32, 0.1, 1),
             "long": ("long", torch.float32, 0.0, 1)}


def ddp_model(kind: str, dtype, drop_path_rate: float):
    """The case's seeded model: the two-stream model at b0 widths, PVT
    depths (1, 1, 2, 1), 64^2, with the dead modules (they take no grad);
    SegNetwork on that backbone; or the long model around it."""
    from emip_tpu_torch.models.emip_long import EMIPLong
    from emip_tpu_torch.models.emip_short import (
        EMIPShort,
        EMIPShortConfig,
        SegNetwork,
    )
    from emip_tpu_torch.models.gmflow import GMFlowConfig
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS

    b0 = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b0"], depths=DDP_DEPTHS,
                             drop_path_rate=drop_path_rate)
    cfg = EMIPShortConfig(
        backbone_name=b0, channel=CHANNEL, inp_size=SIZE,
        gmflow=GMFlowConfig(feature_channels=FDIM,
                            num_transformer_layers=NUM_LAYERS))
    model = {"short": lambda: EMIPShort(cfg, dtype=dtype),
             "static": lambda: SegNetwork(b0, CHANNEL, dtype=dtype),
             "long": lambda: EMIPLong(cfg, MEMORY_SIZE, dtype=dtype)}[kind]()
    return seeded_init_(model, DDP_SEED)


def ddp_batch(rows: slice) -> dict:
    """``rows`` of the seeded global batch, NCHW: two frames (ImageNet
    scale), a binary GT and, for the long model, a 2-frame clip a row."""
    rng = np.random.default_rng(DDP_SEED)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    n, s = DDP_BATCH, SIZE
    full = dict(image1=f(n, 3, s, s), image2=f(n, 3, s, s),
                gt=(rng.uniform(size=(n, 1, s, s)) > 0.6).astype(np.float32),
                clip=f(n, 2, 3, s, s),
                masks=(rng.uniform(size=(n, 2, 1, s, s)) > 0.6
                       ).astype(np.float32))
    return {k: torch.from_numpy(v[rows].copy()) for k, v in full.items()}


def _bn_buffers(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def ddp_case(case: str, rows: slice) -> dict:
    """Run ``case`` of :data:`DDP_CASES` on ``rows`` of the global batch
    through the trainers' own step functions (wrapped in
    ``DistributedDataParallel`` when a group of more than one rank is
    active); returns each step's loss, the last step's grads as AdamW
    reads them before its clamp, the BatchNorm buffers, the trainable
    parameters and their AdamW moments after the steps."""
    from emip_tpu_torch.parallel import data_parallel
    from emip_tpu_torch.train.long import CachedStep, long_train_step
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import (
        ClampAdamW,
        build_long_optimizer,
        build_optimizer,
    )
    from emip_tpu_torch.train.static import static_train_step

    kind, dtype, rate, steps = DDP_CASES[case]
    model = ddp_model(kind, dtype, rate)
    if kind == "short":
        opt = build_optimizer(model, DDP_LR)
    elif kind == "long":
        opt = build_long_optimizer(model, DDP_LR)
    else:
        opt = ClampAdamW(model.parameters(), DDP_LR, 1e-7, 0.5)
    names = {id(p): k for k, p in model.named_parameters()}
    grads = {}
    opt.register_step_pre_hook(lambda o, a, kw: grads.update(
        {names[id(p)]: p.grad.clone() for g in o.param_groups
         for p in g["params"] if p.grad is not None}))
    step_model = data_parallel(CachedStep(model) if kind == "long"
                               else model)
    gen = torch.Generator().manual_seed(DDP_SEED)
    batch = ddp_batch(rows)
    losses = []
    for _ in range(steps):
        if kind == "short":
            loss = short_train_step(step_model, opt, batch, gen)["loss"]
        elif kind == "static":
            loss = static_train_step(step_model, opt, dict(
                image=batch["image1"], gt=batch["gt"]), gen)
        else:
            clip, masks = batch["clip"], batch["masks"]
            enc = model.encode_frame(clip[:, 0])
            loss = long_train_step(step_model, opt, enc, clip[:, 1],
                                   masks[:, 1],
                                   model.init_memory(len(clip)))[0]["loss"]
        losses.append(float(loss))
    return dict(loss=losses, grads=grads, buffers=_bn_buffers(model),
                params={k: p.detach().clone()
                        for k, p in model.named_parameters()
                        if p.requires_grad},
                moments={names[id(p)]: {k: st[k].clone()
                                        for k in ("exp_avg", "exp_avg_sq")}
                         for p, st in opt.state.items()})


def ddp_bn_case(rows: slice) -> dict:
    """The port's BatchNorm2d in train mode on ``rows`` of a seeded
    [8, 6, 5, 7] input (channel means away from 0), the loss sum(y *
    cot): output, input grad, this rank's weight and bias grads and the
    updated buffers."""
    from emip_tpu_torch.dtypes import BatchNorm2d

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((8, 6, 5, 7)) * 2 + 1.5).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 6)))
    xt = torch.from_numpy(x[rows].copy()).requires_grad_(True)
    y = bn.train()(xt)
    (y * torch.from_numpy(cot[rows].copy())).sum().backward()
    return dict(y=y.detach(), dx=xt.grad, dw=bn.weight.grad,
                db=bn.bias.grad, mean=bn.running_mean.clone(),
                var=bn.running_var.clone())


def ddp_photometric_inputs() -> dict:
    """Seeded NHWC target and reconstruction [4, 12, 10, 3] and an
    occlusion mask [4, 12, 10, 1] in [0, 1]."""
    rng = np.random.default_rng(8)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return dict(target=f(4, 12, 10, 3), recons=f(4, 12, 10, 3),
                occ=f(4, 12, 10, 1))


def ddp_photometric_case(rows: slice) -> dict:
    """The port's photometric term on ``rows``, and its grads to the
    reconstruction and the mask."""
    from emip_tpu_torch.losses.flow import UnsupFlowLossConfig, _photometric

    ins = {k: torch.from_numpy(v[rows].copy()).requires_grad_(k != "target")
           for k, v in ddp_photometric_inputs().items()}
    loss = _photometric(UnsupFlowLossConfig(), ins["target"], ins["recons"],
                        ins["occ"])
    loss.backward()
    return dict(loss=loss.detach(), d_recons=ins["recons"].grad,
                d_occ=ins["occ"].grad)


def ddp_worker(rank: int, world_size: int, init_file: str, out_dir: str,
               cases, trainers: dict | None = None) -> None:
    """One rank of a gloo group (``file://`` rendezvous, 60 s timeout):
    each of ``cases`` (:data:`DDP_CASES` names, ``"bn"``, ``"bn_uneven"``
    (3 and 5 rows), ``"photometric"``) on this rank's rows, saved as
    ``<out_dir>/<case>_<rank>.pt``; then, with ``trainers``, the
    trainers themselves (``train_short`` and ``train_long`` on a YAML each,
    ``train_static`` on a root), their summaries saved as
    ``<out_dir>/trainers_<rank>.pt``."""
    import datetime
    import os

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for case in cases:
            n = {"bn": 8, "bn_uneven": 8,
                 "photometric": 4}.get(case, DDP_BATCH)
            per = n // world_size
            rows = slice(rank * per, (rank + 1) * per)
            if case == "bn_uneven":  # 3 rows on the first rank, 5 on the other
                rows = slice(0, 3) if rank == 0 else slice(3, 8)
            fn = {"bn": ddp_bn_case, "bn_uneven": ddp_bn_case,
                  "photometric": ddp_photometric_case}.get(case)
            out = fn(rows) if fn else ddp_case(case, rows)
            torch.save(out, os.path.join(out_dir, f"{case}_{rank}.pt"))
        if trainers:
            torch.save(run_trainers(**trainers),
                       os.path.join(out_dir, f"trainers_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_trainers(short_yaml: str, long_yaml: str, static_yaml: str,
                 static_root: str) -> dict:
    """``train_short`` (1 step), ``train_long`` (every clip, at most 4
    frames) and ``train_static`` (1 step) on the CPU from their YAMLs;
    their summaries and a digest of each model's parameters."""
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.train.long import train_long
    from emip_tpu_torch.train.loops import train_short
    from emip_tpu_torch.train.static import train_static

    def params(model):
        return torch.cat([p.detach().flatten().double()
                          for p in model.parameters()])

    out = {}
    model, out["short"] = train_short(load_config(short_yaml),
                                      max_steps_per_epoch=1, device="cpu")
    out["short_params"] = params(model)
    model, out["long"] = train_long(load_config(long_yaml),
                                    max_frames_per_video=4, device="cpu")
    out["long_params"] = params(model)
    cfg = load_config(static_yaml)
    model, out["static"] = train_static(cfg, static_root, cfg.save_path,
                                        max_steps_per_epoch=1, device="cpu")
    out["static_params"] = params(model)
    return out
