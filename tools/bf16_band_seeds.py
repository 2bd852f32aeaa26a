#!/usr/bin/env python3
"""How the gates of the switched bf16 train steps read over variable seeds.

    JAX_PLATFORMS=cpu python tools/bf16_band_seeds.py CONFIG SEED [SEED ...]

CONFIG is one of ``none`` (the default configuration), ``G/H``
(``fused_block_max_t`` 8), ``I`` (read-corr matching) or ``J``
(``fused_ffn="always"``). For each SEED it runs, on the CPU, what the
``switched_runs`` fixture of ``tests/test_torch_bf16_512.py`` runs: the
tiny EMIPShort of both packages on variables from that seed, three clamp +
AdamW steps on batches from ``SEED + 1000`` in fp32 and bf16 (JAX's
``make_short_train_step``, the port's ``short_train_step``). It prints one
JSON line per seed with the first step's four losses and each gate's
reading over its limit's factor (pass at <= 2): ``loss`` |port bf16 - JAX
bf16| / |JAX bf16 - JAX fp32|, ``grads_max`` and ``grads_mean`` the same
over all trainable leaves' grads, ``ab`` the three steps' largest |delta
loss| against JAX's. The JAX steps compile once per configuration and
dtype; each further seed takes seconds. The test holds the grads at each
of seeds 1-6 and the loss and the A/B pooled over them; this prints what
each seed reads. Run with ``XLA_FLAGS=--xla_allow_excess_precision=false``
the JAX steps keep every bf16 rounding their kernels' source writes (JAX's
bf16 block then gives its G then H's bits; see
``test_jax_bf16_block_and_layers_differ_only_by_excess_precision``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's GMFlow and PVT switches, the JAX package's environment knobs
# and PVT switches
CONFIGS = {
    "none": ({}, {}, {}, {}),
    "G/H": (dict(fused_block_max_t=8), {}, {"EMIP_FUSED_BLOCK_MAX_T": "8"},
            {}),
    "I": (dict(global_match_qk_fused=False), {},
          {"EMIP_GLOBAL_MATCH_QK": "0"}, {}),
    "J": ({}, dict(fused_ffn="always"), {}, dict(fused_ffn="always")),
}


def main(argv) -> int:
    conf, seeds = argv[0], [int(s) for s in argv[1:]]
    gm, pvt, env, jpvt = CONFIGS[conf]
    os.environ.update(env)  # read by the JAX package when it traces
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from emip_tpu.models.emip_short import EMIPShort as JaxEMIPShort
    from emip_tpu.train.short import make_short_train_step
    from emip_tpu.train.state import (
        GMFLOW_FREEZE,
        TrainState,
        build_optimizer,
        merge_params,
    )
    from emip_tpu_torch.convert import state_dict_from_flax
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer as port_optimizer
    from tests import torch_helpers as th

    keep = optax.GradientTransformation(  # each step's raw grads
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, state, params=None: (g, g))
    tx = optax.chain(keep, build_optimizer(learning_rate=1e-3,
                                           weight_decay=1e-7, clip_value=0.5))
    jm32, cfg = th.jax_tiny_short(drop_path_rate=0.0, pvt=jpvt)
    steps = {"jax32": make_short_train_step(jm32, tx, donate=False),
             "jax16": make_short_train_step(
                 JaxEMIPShort(config=cfg, dtype=jnp.bfloat16), tx,
                 donate=False)}
    img = np.zeros((1, th.SIZE, th.SIZE, 3), np.float32)
    for seed in seeds:
        variables = th.random_variables(jm32, img, img, seed=seed)
        rng = np.random.default_rng(seed + 1000)
        shape = (2, th.SIZE, th.SIZE)
        batches = [(rng.standard_normal(shape + (3,)).astype(np.float32),
                    rng.standard_normal(shape + (3,)).astype(np.float32),
                    (rng.uniform(size=shape + (1,)) > 0.5).astype(np.float32))
                   for _ in range(3)]
        losses, grads = {}, {}
        for name, step in steps.items():
            state = TrainState.create(variables, tx, GMFLOW_FREEZE)
            losses[name], first = [], None
            for i, (a, b, gt) in enumerate(batches):
                state, metrics = step(state, dict(image1=a, image2=b, gt=gt),
                                      jax.random.PRNGKey(i))
                losses[name].append(float(metrics["loss"]))
                first = state.opt_state[0] if first is None else first
            full = merge_params(jax.tree_util.tree_map(np.asarray, first),
                                jax.tree_util.tree_map(np.zeros_like,
                                                       state.frozen))
            grads[name] = state_dict_from_flax(
                {"params": full, "batch_stats": variables["batch_stats"]},
                th.DEPTHS, th.NUM_LAYERS)
        sd = state_dict_from_flax(variables, th.DEPTHS, th.NUM_LAYERS)
        for name, dtype in (("port32", torch.float32),
                            ("port16", torch.bfloat16)):
            model = th.torch_tiny_short(drop_path_rate=0.0, dtype=dtype,
                                        pvt=pvt, **gm)
            model.load_state_dict(sd, strict=True)
            opt = port_optimizer(model, 1e-3, 1e-7, 0.5)
            grads[name], clamp_and_step = {}, opt.step

            def step(closure=None, g=grads[name], m=model,
                     real=clamp_and_step):  # the grads before the clamp
                if not g:
                    g.update({n: p.grad.clone()
                              for n, p in m.named_parameters()
                              if p.requires_grad and p.grad is not None})
                return real(closure)

            opt.step = step
            losses[name] = [float(short_train_step(model, opt, dict(
                image1=th.nchw(a), image2=th.nchw(b),
                gt=th.nchw(gt)))["loss"]) for a, b, gt in batches]
        names = [n for n, p in model.named_parameters() if p.requires_grad]

        def vec(run):
            return np.concatenate([
                np.asarray(grads[run][n], np.float64).ravel()
                if n in grads[run] else
                np.zeros(np.shape(grads["jax32"][n])).ravel() for n in names])

        v = {run: vec(run) for run in grads}
        gap = np.abs(v["jax16"] - v["jax32"])
        err = np.abs(v["port16"] - v["jax16"])
        first = {k: x[0] for k, x in losses.items()}
        ab = (np.abs(np.subtract(losses["port16"], losses["jax16"])).max()
              / np.abs(np.subtract(losses["jax16"], losses["jax32"])).max())
        print(json.dumps(dict(
            config=conf, seed=seed, losses=first,
            loss=abs(first["port16"] - first["jax16"])
            / abs(first["jax16"] - first["jax32"]),
            grads_max=err.max() / gap.max(),
            grads_mean=err.mean() / gap.mean(), ab=float(ab))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
