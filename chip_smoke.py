#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and ``nvcc``. It
needs one card and no arguments, and it imports nothing of JAX. In order:

1. requires ``torch.cuda.is_available()`` and prints the card's
   ``nvidia-smi`` name and power limit;
2. builds the CUDA kernels from ``emip_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and prints the build time;
3. turns TF32 off for matmuls and cuDNN convolutions (fp32 comparisons);
   then the 3xTF32 GEMM of kernels A, B, G and H alone at every shape the
   352^2 train step gives it in B and A, and at two ragged shapes, against
   the fp64 product and beside ``torch.matmul`` (one log line each; a
   second call must give the same bits); the wgmma product of B's and H's
   bf16 forwards alone (``gemm_wgmma``, ``csrc/gemm_wgmma.cuh``) at the
   forms those kernels run (q, k, v from two bf16 sources, W0's two halves
   with GELU, W2 with its LayerNorm) at B's rows at 352^2 and H's at 512^2
   with one clip, and a ragged check, each against fp64 (``GEMM_REL_TOL``),
   the same bits twice, timed in turns beside the 3xTF32 GEMM and
   ``torch.matmul`` with its TFLOP/s (``gemm_wgmma`` lines), and the input
   grads dy W of G's and H's bf16 backwards, each product kernel's device
   time in turns against the 3xTF32 GEMM's with the same epilogue; and the
   tensor-core forward attention of A, B, G and H alone
   (``kernels/attention.py``) at the
   shapes those kernels give it (A's four PVT stages at 352^2 and at 512^2,
   B's 64 windows of 484 tokens without and with the shift mask, G's and
   H's windows of 1024 tokens at 1 and 4 clips, and pvt_v2_b0's widths, A
   at 32 and B at 64), against the fp64 product and beside
   ``scaled_dot_product_attention`` (the mask as its ``attn_mask``), one
   ``attention`` log line each and a line with their sums (a second call
   must give the same bits); and the bf16 attention of C, G and B's self
   layer alone (``csrc/attention_bf16.cu``: C's [16,1936,128] and
   [8,4096,128] with 2-wide fp32 v, G's [32,1024,128] with and without the
   shift mask, B's [64,484,128] with it), against its plain bf16 version
   and fp64 (the bf16 gates of phase 7), the same bits twice, its event
   and device ms beside ``scaled_dot_product_attention`` in bf16, its
   bound at the bf16 rate, its exponentials and their MUFU floor, and
   TFLOP/s (``attention_bf16`` lines);
4. kernel phase: each forward kernel A-D and F-J against its plain PyTorch
   version on the same seeded CUDA tensors, at the production shapes of
   the 352^2 path (A at all four PVT stages, B with and without the shift
   mask, at batch 8; A also at the linear PVTv2's four stages with M = 49
   pooled keys, forward and backward, fp32 and bf16, with device times,
   kept out of its rows' sums; F at 1 and 4 clips with 1, 3 and 5 written slots,
   with every slot empty at a small size, and at the 512^2 shape; J at the
   four MixFFN stages; I at [8, 1936, 1936]) and of the 512^2 path (A with
   256 reduced keys, C at L = 4096, D at 64 x 64, I at [4, 4096, 4096], G
   with and without the residual and H at windows of 1024 tokens, with and
   without the mask, at 1 and 4 clips, and once at 484 tokens; C also at a
   ragged token count at channel widths 128 and 64, and J at 512^2 stage 1
   and on a 7 x 13 map, from inputs of their own and kept out of their
   kernel's summed row), with the tolerance stated, and
   CUDA-event times of the kernel, the plain version and, where one
   PyTorch call computes the same function
   (``scaled_dot_product_attention`` for C and F), that call. A, B, G and
   H have no such call (the ``attention`` lines of phase 3 time their
   attention beside one); for I (``softmax`` then ``matmul``) and J
   (``conv2d`` then ``gelu``) it would take two, so they have none either.
   The forwards of A, B, C, F, G, H and J must give the same bits on a
   second call;
5. backward phase: each backward kernel A-D and F-J against
   torch.autograd.grad of the plain version on the same seeded cotangent,
   at the train steps' shapes (B, G and H with input grads alone and with
   their weight grads, C also with dv, F with all three grads and with dq
   alone, I with dcorr alone and with dvalues, J with gu, tap and bias
   grads), with the tolerance stated and CUDA-event times of the backward
   alone; C and F also at the 512^2 train steps' shapes ([4, 4096, 128];
   [1, 4096, 128] x [1, 20480, 128]) and at a small ragged one each (F's
   with every slot empty), J at its two checks of phase 4 (kept out of its
   summed row), I at ragged N and past its register tile (kept out of its
   summed row); for C, F, I, J and the tensor-core backward of A, B, G and
   H a second call on the same inputs must give the same bits;
   kernel E against its plain scatter_add_ version (density atol and the
   fraction of occlusion-mask bits that flip), the same bits on a second
   call, a grad_fn and its gradient against autograd of the plain version,
   at the train step's shape and, kept out of its summed row, on a
   coherent field, on uniform-random targets and at 512^2; D, E, I and J
   also read their device time per call (``device_ms``); the
   cost of the transpose that read-corr matching hands kernel I and of the
   row statistics kernel C's forward keeps for its backward;
6. tiny phase: the configuration of the CPU tests (pvt_v2_b0 at 64^2,
   64-d flow features: A at head width 32, B, C and F at width 64) on
   seeded weights: a short forward, one pair's seg-loss grads, one short
   train step and a 3-frame clip and one frame's head grads of the long
   model, each against the CPU's plain versions with the slice's
   tolerances, and launch counts that show A-D (and F) ran;
7. slice phase: the full pvt_v2_b5 EMIPShort at 352^2 on seeded random
   weights runs ``predict_arrays`` on batches of 8 seeded frame pairs; the
   kernel launch counts of that run must equal what the model structure
   implies; one pair's mask logits and forward flow are compared with the
   same weights run on the CPU through the plain versions; frames/s
   (median of CUDA-event timed batches) and peak memory are printed. Then
   the bf16 band of short inference: the bf16 forwards of A-D at the same
   shapes (bf16 tokens and weights for A, bf16 windows with fp32
   parameters for B, bf16 q and k with fp32 values for C, bf16 logits for
   D) against their plain bf16 versions (max|err| <= 1e-2 of max|ref|)
   and against an fp64 evaluation on the same bf16-rounded inputs (no
   larger than 1.5x the plain version's own error there, errors under 1e-5
   of max|ref| counting as 1e-5), bit-equal on a second call, timed beside
   the plain version and ``scaled_dot_product_attention`` in bf16 (for
   A's and B's attention as ``sdpa_ms``), with their bound (bf16 products
   at 989 TFLOP/s, B's fp32 cross layer and FFN at a third of the TF32
   peak, bytes at their storage sizes); the bf16 GEMM alone at A's and B's
   bf16 shapes beside ``torch.matmul`` in bf16; and the same b5 model and
   frames as ``EMIPShort(cfg, dtype=bfloat16)`` through
   ``predict_arrays``: launches of the four bf16 forwards only (A 104, B
   6, C 3, D 1 a batch), peak memory beside the fp32 one, frames/s of
   bf16 and fp32 timed in turns (fp32, bf16, bf16, fp32), and one pair
   card bf16 against CPU plain bf16 within twice the card's
   bf16-vs-fp32 gap on that pair (a gap above zero). The bf16 kernel lines
   also hold F's bf16 forward (bf16 q against the fp32 ring: 1 and 4
   clips, every slot written, and 512^2) and G's and H's (bf16 windows of
   1024 tokens at 1 and 4 clips, with the shift mask, once without), with
   F beside ``scaled_dot_product_attention`` on bf16 q, k, v and the bias
   as its ``attn_mask``, each product bound at the rate its operands
   allow (F's as three bf16 products each: a bf16 side against the fp32
   ring in three exact bf16 parts, as its kernel takes them; H's
   projections of the bf16 x and t at 2xTF32, its other products at
   3xTF32; G's at the bf16 rate), F's with its device time and launches
   per call and its digests, J's bf16 forward (bf16 u and taps, fp32
   bias) at the four
   MixFFN stages beside the library's bf16 depthwise convolution and
   ``F.gelu`` (bound by its bytes at two a bf16 element), and, kept out of
   their rows' sums, A, C and D at their 512^2 shapes, F with every slot
   empty, G without the residual and J at 512^2 stage 1 and on a 7 x 13
   map;
8. train phase: first one pair, the seeded weights on the card and on the
   CPU: loss values and the seg-loss grads of every trainable leaf. Then
   the same model takes 1 + 5 train steps at batch 8 (drop path 0.1 from a
   seeded generator, GMFlow frozen, clamp + AdamW); the launch counts per
   step must match the structure (forward as above; backward A 61, B 6,
   C 3, D 1; E 2); GMFlow must stay bit-identical, every trainable leaf
   with a grad must move, the losses must be finite; median ms/step,
   pairs/s and peak memory are printed. Then the bf16 train step: the
   bf16 backwards of A-D at the train step's shapes against the fp32 plain
   version's VJP at the upcast inputs on the card (the bf16 gates of phase
   7 grad by grad: rel, the error against fp64 with a floor of 1e-5 for a
   bf16 grad and 2e-4 for an fp32 one, the same bits twice; the bound
   counts the fp32 recompute and the backward, each product at the rate
   its operands allow (see PEAK_BF16_FLOPS); C beside
   SDPA's backward on the upcast inputs); two pairs, each from its own
   seed, drop path off, card bf16 against CPU plain bf16 at b5's widths and
   PVT depths (1, 1, 2, 1), with the fp32 model run on both sides: both
   losses within twice the card's bf16-vs-fp32 gap (gap > 0), each
   trainable leaf's seg-loss grad within twice the larger of the card's and
   the CPU's gaps on that leaf, and all leaves' grads taken together (max
   and mean) within twice the card's gap and twice the CPU's (the bf16
   backward lines also hold F's bf16 backward at 1 and 4 clips, every
   grad and dq alone, against the same backward of the plain version from
   the kernel forward's output, and at 512^2 kept out of its sum; G's and
   H's bf16 backwards at the 512^2 train step's windows, [4, 4, 1024, 128]
   masked with gx gt alone and with every parameter grad and [2, 4, 1024,
   128] unmasked, beside SDPA's bf16 backward on their attention alone,
   [16, 4, 484, 128] kept out; J's at the four stages (gu, taps, bias)
   beside the backward of the library's bf16 convolution and GELU and its
   fp32 backward's device time at the same shape from phase 5
   (``fp32_device_ms``), its two checks kept out; and, kept out of their
   rows, A's, C's and D's bf16
   backwards at the 512^2 train step's shapes); the same card-vs-CPU
   comparison with the block switch at 400 tokens, so that G and H
   (forward and backward, in bf16) run in place of B as at 512^2, over six
   pairs (the losses of the four beyond the first two held pooled: the
   sum of |card - CPU| within twice the sum of the card's gaps); then the
   full b5 model in bf16 on the fp32
   phase's weights: 1 + 2 steps counted from zero launches (A-D's bf16
   forwards and backwards, E, no fp32 A-D), timed in turns with the fp32
   model (fp32, bf16, bf16, fp32), device-busy time per step of each, peak
   memory, GMFlow bit-identical, every leaf with a grad moved;
9. kernel-switch phases, each beside the default configuration on the same
   weights and inputs, in turns: read-corr matching
   (``global_match_qk_fused=False``: I 2 per forward and C 1, I backward 2
   per train step) and the fused MixFFN (``fused_ffn="always"``: J 104 per
   forward; ``ffn_dwconv="bwd_fused"``: J backward 61 per train step);
   mask, flow and train losses must equal the default's within the slice
   and loss tolerances; frames/s and ms/step of both are printed. Then
   both switches in the bf16 band, beside the bf16 default on the same
   weights and inputs in turns: read-corr matching (I reads the fp32
   volume: 2 per forward, its backward 2 per train step) and the fused
   MixFFN (J's bf16 forward 104 per forward; train steps with
   ``fused_ffn="always"``, J's bf16 forward 104 and backward 61 a step,
   and with ``ffn_dwconv="bwd_fused"``, the library's bf16 forward and J's
   bf16 backward 61), launches per forward and step against the
   structure, finite losses; one pair under each switch, card bf16 against
   CPU plain bf16 at b5's widths and PVT depths (1, 1, 2, 1), within twice
   the larger of the two bf16-vs-fp32 gaps; and each switched train step
   held to the CPU as the bf16 train step is (two pairs: losses and each
   leaf's seg-loss grad within twice the larger gap, all leaves together
   within twice each gap);
10. entry-point phase: ``python -m emip_tpu_torch.train`` (in process) on
    a synthetic dataset the port writes, b5 at 352^2, batch 8, fp32, one
    epoch of 2 steps, validation and a checkpoint. Before this and every later
    entry point's call both TF32 switches are turned on (cuDNN's is on by
    torch's default), and after it they must read off: each entry point
    turns them off through ``device.resolve_device``, not this script;
11. static phase: ``SegNetwork`` (static-image pretraining: pvt_v2_b5,
    352^2, channel 32) on seeded weights; one image's hybrid-E loss and
    every leaf's grad, card against CPU; then 1 + 3 ``static_train_step``s
    at batch 8: A forward and backward 52 each per step and no other
    launch, finite losses, every leaf moved, ms/step and peak memory; then
    SegNetwork in bf16 against its fp32 twin in turns: A's bf16 forward and
    backward 52 each a step and nothing else, ms/step, peak memory; then
    the backbones phase: SegNetwork on each alternate encoder
    (pvt_v2_b2_li, pvt_small, res2net50_26w_4s, efficientnet_b1 and _b4)
    at full width and depth, 352^2, batch 8, fp32 and bf16 (ms, frames/s,
    peak memory; A's forward once a block for the linear PVTv2, nothing
    for the others), two images card against CPU (fp32 1e-3 of max|ref|,
    bf16 within twice the larger bf16-vs-fp32 gap), one fp32 train step on
    one image card against CPU (loss, every leaf's grad by 8e-2 or twice
    what three 1e-6 nudges of the CPU's image move it, BatchNorm statistics
    1e-4); DGNet (EfficientNet-B4) at batch 8 card against CPU; and the
    two-stream model on pvt_v2_b2_li (A 32, B 6, C 3, D 1 a batch) and
    pvt_small (A none) through the slice phases of item 7, fp32 and bf16;
12. entry chain on phase 10's root and checkpoint: ``python -m
    emip_tpu_torch.test`` (a PNG per pair), ``... eval_offline`` (17
    metrics finite in [0, 1], 8 of 10 GT frames a video scored, S-measure,
    wFm and MAE equal to the training loop's ``frame_scores`` means to
    1e-12, the GT against itself perfect), ``... test_of`` (a JPG per
    pair) and ``... train_static`` (one epoch of 2 steps at batch 8 on 16
    synthetic images, checkpoint and log); then ``... test`` once more
    with the YAML saying ``compute_dtype: bfloat16``: a PNG per pair,
    launches of the bf16 forwards of A-D and none of their fp32 ones; and
    ``... train`` and ``... train_static`` with the YAMLs saying bfloat16:
    2 steps each, bf16 kernels only, a checkpoint of fp32 tensors that
    loads into an fp32 model (TF32 and cuBLAS's bf16 reduced-precision
    reduction are turned on before every entry point's call, and must read
    off after it); and ``... train_static`` from a YAML naming
    res2net50_26w_4s with ``compute_dtype: bfloat16`` (one step, no kernel
    of the port, an fp32 checkpoint);
13. long inference phase: the full EMIPLong (b5, 352^2, 5 memory slots) on
    seeded weights streams seeded clips through ``step_cached``, one clip
    at a time and four side by side; launch counts against the structure
    (A 52 per encoded frame, B 6, C 3, D 1 per pair, F 1 per read);
    frames/s with the ring full and peak memory; one 3-frame clip's short
    mask, long masks and memory against the CPU plain versions;
14. long train phase: one frame's loss and head grads, card against CPU,
    on the seeded weights; then 1 + 5 per-frame train steps at 4 clips and
    at 1: F forward and backward once per step and no backward launch of
    A-D; every ``short_term`` tensor and buffer bit-identical afterwards,
    every trainable leaf moved, finite losses; ms/frame and peak memory;
    Then the bf16 long model (``EMIPLong(cfg, 5, dtype=bfloat16)``) on the
    same weights, in turns with the fp32 model: streaming on a full ring at
    1 and 4 clips (launches of the bf16 forwards of A-D and F's bf16
    forward only), the long train step at 4 clips (adds F's bf16 backward;
    short_term bit-identical, every trainable leaf moved): frames/s or
    ms/frame, the device's busy time and idle share, peak memory; then the
    card's bf16 long model against the CPU's plain bf16 versions at b5's
    widths and PVT depths (1, 1, 2, 1), the fp32 model on both sides: a
    3-frame clip's short mask, long masks and ring, and one train frame's
    loss and head grads on two seeds, each within twice the larger of the
    card's and the CPU's bf16-vs-fp32 gaps (all leaves together within
    twice each gap);
15. long entry points: ``python -m emip_tpu_torch.train_long`` and
    ``python -m emip_tpu_torch.test_long`` (in process) on a synthetic
    root, fp32: 4 per-frame steps, validation, checkpoints, 12 PNGs; then
    both with the YAML saying ``compute_dtype: bfloat16``: the same, fp32
    checkpoints, launches of the bf16 kernels only (A-D forward, F forward
    and backward); then ``python -m emip_tpu_torch.train`` on the train
    phase's YAML at 512^2, batch 2, saying bfloat16: one step and
    validation, the bf16 kernels of the 512^2 path only (A, C, D, G and H,
    forward and backward; no B), an fp32 checkpoint;
16. 512^2 phases, where a swin window holds 1024 tokens and the flow
    transformer runs kernels G and H in place of B: 1 + 2 short train steps
    at batch 2 (G and H forward and backward 6 each per step, none of B;
    the checks of phase 8), the bf16 short train step at batch 2 on the
    same weights in turns with the fp32 one (8 steps a turn; A, C, D, G
    and H forward and backward in bf16, 6 each of G and H a step, E; the
    fp32 / bf16 ratio of the medians beside those of the first two and the
    last two turns, the step spread, busy time, idle share, peak memory;
    GMFlow bit-identical, every leaf moved), short inference in bf16 at
    batch 4 in turns
    with fp32 (G's and H's bf16 forwards 6 each a batch, no B), then the
    long inference phase at 512^2 (G 6, H 6, B 0 per step; card against
    CPU as in phase 13) and the bf16 long streaming of phase 14 at 512^2;
17. ddp phase (run after phase 10, on its YAML and root): data
    parallelism on the one card. Two spawned ranks join through
    ``init_distributed`` on torchrun's variables over gloo (NCCL refuses
    two ranks on one device; the backend is an argument, not a fallback),
    b5 at 352^2, global batch 8 (4 rows a rank), drop path 0.1, one fp32
    and one bf16 short train step each in ``DistributedDataParallel``
    (launches per step against the structure, the ranks' grads, BatchNorm
    buffers and parameters equal by digest), one step of ``train_short``
    on phase 10's YAML at 4 rows a rank with its validation (the ranks'
    parameters and buffers equal by digest, checkpoints and scalars
    written by the first rank alone), then, the group left, the
    one-process steps on the same 8 rows and weights: fp32 held by the
    train step's gates (the loss by TRAIN_LOSS_RTOL, every trainable
    leaf's grad before the clamp by the scale-floored SEG_GRAD_RTOL or
    twice its nudge band, the BatchNorm buffers by BN_STATS_REL, the
    parameters after AdamW to DDP_PARAM_ATOL where AdamW's step
    saturates), bf16 within twice the one-process bf16-vs-fp32 gap (the
    loss; all grads and all buffers by max and by mean); each rank's
    seconds, step ms and peak memory; then one ``torchrun --standalone
    --nproc_per_node 1 -m emip_tpu_torch.train --multi_host`` step on
    phase 10's YAML (no validation) over NCCL (rc 0, the group joined
    over NCCL, one step, a checkpoint). The same two ranks go on in the
    same group: FSDP (``fully_sharded``), the fp32 and bf16 steps again
    with the model sharded, held to the same one-process steps by the same
    gates (the nudge band grown until neither run's leaves are past it),
    each rank's peak memory beside DDP's, one step of ``train_short`` with
    ``parallel.fsdp`` (validation on every rank, the first writing; its
    checkpoint loads into a one-process model and optimizer and equals the
    DDP run's: parameters within one AdamW step, AdamW moments under the
    same integer keys to the grads' SEG_GRAD_RTOL); sharded inference
    (the bodies of ``python -m emip_tpu_torch.test`` and ``... test_of``
    on phase 10's
    YAML, checkpoint and root, each rank its share: the ranks' PNGs
    disjoint and together one process's byte for byte, the first rank
    alone writing the flow images, every rank's flows one process's bit
    for bit); the GPipe pipeline over b5's stage 3 (40 blocks, C 320, 5
    heads, 22 x 22 tokens, sr 2: kernel A on 121 keys), batch 8 in 4
    microbatches, 20 blocks a rank, fp32 and bf16, values and grads held
    on each rank to the plain block loop on the same microbatches (1e-5
    of the values' scale and 1e-4 of each grad's, JAX's bounds, in both
    dtypes; the bit-equal tensors counted) and to the loop on the whole
    batch (fp32 to the same bounds, bf16 within twice that loop's
    bf16-vs-fp32 gap), kernel A forward and backward 80 times a rank;
18. sam heads phase: ``PromptInteract``, ``Interact`` and
    ``PromptGenBlock`` (``emip_tpu_torch/models/sam_prompt.py``) at their
    published width on seeded weights, image and flow [8, 128, 44, 44]
    (``inp_size`` 352), the prompt block on [8, 192, 44, 44]: card against
    CPU in fp32 (1e-3 of max|CPU|, TF32 off) and in bf16 (within twice the
    larger of the two sides' bf16-vs-fp32 gaps), the card's ms; no kernel
    of the port launched.

It prints one JSON line with thirty-five rows, the nineteen kernels' and
the bf16 forwards of A-D, F, G, H and J and backwards of A-D, F, G, H and
J (with their worst ``fp64_ratio``; A-D's bf16 forwards' launches are the
bf16 slice's, F's the bf16 long streaming step's, G's and H's the bf16
512^2 streaming step's, J's the bf16 fused-MixFFN run's, the backwards'
the bf16 train steps' (G's and H's at 512^2, J's under its switch);
per kernel:
launches in the phase that is its main path, the largest max_abs_err of
its cases, and ``ms`` / ``plain_ms`` / ``library_ms`` / ``bound_ms`` summed
over its cases, one call each; ``bound_ms`` is the larger of the case's
operations over the card's peak for them and its bytes over the memory
rate, ``bound_by`` says which, and no case may take less. Products on the
CUDA cores count at the fp32 peak; A, B, C, F, G and H, forward and
backward, run all theirs on the tensor cores as 3xTF32, at a third of the
TF32 peak (``bound_rate: "tf32x3"``); a bf16 row counts each product at
the rate its operands allow (a bf16 operand is exact in TF32: two TF32
products for one, the bf16 peak for two; F's forward three bf16 products
against its ring's three exact bf16 parts, a third of the bf16 peak;
``bound_rate`` names them), and these rows carry the CUDA cores' figure
for all their operations as ``fp32_bound_ms``),
and as its last line ``{"ok": true, "device":
{...}}``. Before the JSON line it prints a ``digests {...}`` line: for every
case of the fp32 backward rows of A, B, C, F, G and H, of the bf16 ones of
A, B, C, F, G and H, of J's fp32 and bf16 backwards and of the bf16
forwards of A, B, C, F, G and H (``DIGEST_KERNELS``)
the sha256 of its grads' or output's bytes and its device launches per
call, so that two trees can be shown to give the same bits at the same
seeds. Any failure raises and the exit code is non-zero,
with no result line. Details also go to ``chiprun_out/chip_smoke.json``. ``--kernels
NAMES`` is a development aid: the kernel phases alone, for the kernels
whose name contains one of the comma-separated NAMES (``gemm`` adds the
GEMM lines of phase 3, ``gemm_wgmma`` its wgmma lines alone,
``attention_fwd`` its attention lines, ``attention_fwd_bf16`` the
``attention_bf16`` lines alone, ``backbones`` the backbones phase and its
entry point, ``ddp`` phase 10 and the ddp phase, ``sam`` the sam heads
phase, ``bf16`` the
bf16 kernel, GEMM and backward lines; a bf16 forward row's name, such as
``sr_attention_bf16``, that row's kernel lines).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 8            # frame pairs per batch
SIZE = 352
SIZE_512 = 512       # the second published size: windows of 1024 tokens
TRAIN_BATCH_512 = 2
TIMED_STEPS_512 = 2
VARIANT_TIMED = 3    # timed batches / steps of a kernel-switch variant
TIMED_BATCHES = 5
TIMED_STEPS = 5
KERNEL_REPS = 10
SEED = 0
# multi-scale GMFlow at full width: the published refinement model (Xu et
# al., CVPR 2022, haofeixu/gmflow's "with refinement" evaluation: num_scales
# 2, upsample_factor 4, attn_splits_list 2 8, corr_radius_list -1 4,
# prop_radius_list -1 1) on 128 channels, 6 blocks, FFN x4
GMFLOW_SCALES = dict(num_scales=2, upsample_factor=4, feature_channels=128,
                     num_transformer_layers=6, ffn_dim_expansion=4,
                     attn_splits_list=(2, 8), corr_radius_list=(-1, 4),
                     prop_radius_list=(-1, 1))
GMFLOW_SCALES_TIMED = 5
GMFLOW_SCALES_TOL = dict(rtol=1e-3, atol=2e-2)
# the relative nudge of the CPU's inputs that measures how far fp32
# rounding alone moves each output (see gmflow_scales_phase)
GMFLOW_SCALES_NUDGE = 1e-6

# per-kernel tolerances (kernel vs. plain PyTorch, both fp32 on the card):
# sums run in another order, through softmax, LayerNorm and FFN chains
KERNEL_TOL = {
    "sr_attention": dict(rtol=1e-3, atol=1e-3),
    "window_attention_block": dict(rtol=1e-3, atol=2e-3),
    "window_attention_layer": dict(rtol=1e-3, atol=2e-3),
    "window_attention_ffn_layer": dict(rtol=1e-3, atol=2e-3),
    "flow_attention": dict(rtol=1e-3, atol=2e-3),
    "convex_upsample": dict(rtol=1e-4, atol=1e-3),
    # outputs are pixel coordinates up to 63; the kernel's exp is the fast
    # intrinsic (relative error ~1e-6 of each weight)
    "softmax_expectation": dict(rtol=1e-4, atol=1e-3),
    # nine products per output against cuDNN's order of the same sum
    "dwconv_gelu": dict(rtol=1e-4, atol=1e-5),
    # outputs are softmax-weighted means of unit normals (|out| ~ 0.1-1)
    "memory_attention": dict(rtol=1e-3, atol=2e-5),
}
# card (CUDA kernels) vs. CPU (plain versions), same weights, one pair:
# the tolerances of tests/test_full_model_parity.py, and besides
# max|err| <= SLICE_REL_MAX * max|ref|, because with zero biases the seeded
# mask logits are small (|ref| ~ 0.06) and atol alone would not see a fault
SLICE_TOL = {"mask": dict(rtol=1e-3, atol=1e-2),
             "flow_fw": dict(rtol=1e-3, atol=2e-2)}
SLICE_REL_MAX = 1e-3
# train step, card vs CPU on one pair: loss values (fp32 through the whole
# model and both losses) and seg-loss grads per trainable leaf by
# max|err| / max(max|ref|, 1e-6 * largest leaf), the tolerance of
# tests/test_grad_parity.py. At b5 this is close to what fp32 allows: a
# BatchNorm output within rounding of 0 takes the other side of the next
# ReLU, which moves that BatchNorm's bias grad (a sum that nearly cancels)
# by several percent (for the seeded pair, conv_corr.1.bias differs by
# 8.2e-2 between the CPU's fp32 and fp64 grads, by 5.2e-2 between card and
# CPU). The comparison runs on the seeded weights, before any step: the
# card's grads then repeat to 1e-4 from run to run, whereas after the steps
# the weights depend on the order of atomic adds and the reading varied
# from 2.8e-2 to 7.0e-2
TRAIN_LOSS_RTOL = 1e-3
SEG_GRAD_RTOL = 8e-2

# backward kernels vs. torch.autograd.grad of the plain version: the
# largest max|err| / max|plain| over a case's grads (fp32 sums in another
# order; weight grads sum over ~10^5 rows)
BWD_REL_TOL = 1e-3
# kernel E: its fixed-point sum against the plain version's fp32
# scatter_add_ (last-bit differences of a density of order 1), and the 0.2
# occlusion threshold may flip a few bits
SPLAT_ATOL = 1e-5
SPLAT_FLIP_MAX = 1e-4
# kernel E's coordinate fields: (batch, size, kind, summed). The first is
# the summed row's (the train step's shape: pixel grid + seeded noise of 4
# px); the others are checks kept out of its sum: a coherent field (a
# shift of (2.5, -1.25) px and a 2 degree rotation about the centre, the
# corners' targets off the image), targets uniform over the image and a
# margin, and the 512^2 shape
SPLAT_CASES = ((BATCH, SIZE, "noise", True), (BATCH, SIZE, "coherent", False),
               (2, SIZE, "uniform", False), (2, SIZE_512, "noise", False))
# kernel I's backward checks kept out of its summed row: N no multiple of
# 4 (single-float loads), and past the register tile of 4096 floats (the
# streaming instantiation): (batch, N)
SOFTMAX_BWD_CHECKS = ((2, 91), (2, 1001), (2, 4100))

# kernel A at the four PVT stages of pvt_v2_b5 at 352^2: N, M, C, heads
SR_STAGES = ((7744, 121, 64, 1), (1936, 121, 128, 2), (484, 121, 320, 5),
             (121, 121, 512, 8))
# the same at 512^2 (M = 256 reduced keys)
SR_STAGES_512 = ((16384, 256, 64, 1), (4096, 256, 128, 2),
                 (1024, 256, 320, 5), (256, 256, 512, 8))
# pvt_v2_b0's stage 3 at 352^2 (head width 32): A's bf16 check at that width
SR_B0_CHECK = (484, 121, 160, 5)
# the linear PVTv2 (pvt_v2_b2_li) at 352^2: every stage's keys pooled to
# 7 x 7, so M = 49 (checks kept out of A's rows' sums, with device times)
SR_STAGES_LINEAR = ((7744, 49, 64, 1), (1936, 49, 128, 2), (484, 49, 320, 5),
                    (121, 49, 512, 8))
LINEAR = "linear"  # the label that starts those cases
BATCH_512 = 4        # clips streamed side by side at 512^2
# kernel J at the four MixFFN stages of pvt_v2_b5 at 352^2: side, hidden
FFN_STAGES = ((88, 256), (44, 512), (22, 1280), (11, 2048))
# J's checks kept out of its summed rows: 512^2 stage 1, and a map that is
# not square and whose sides are no multiple of a tile: (batch, h, w, F)
FFN_CHECKS = ((2, 128, 128, 256), (2, 7, 13, 256))
FWD_KERNELS = ("sr_attention", "window_attention_block", "flow_attention",
               "convex_upsample")
WIN_SELF = ("wq", "wk", "wv", "wm", "s1", "b1")
WIN_CROSS = WIN_SELF + ("w0", "w2", "s2", "b2")

KERNEL_INFO = {
    "sr_attention": ("emip_tpu_torch/csrc/sr_attention.cu",
                     "emip_tpu/ops/pallas/sr_attention.py:201"),
    "window_attention_block": ("emip_tpu_torch/csrc/window_attention.cu",
                               "emip_tpu/ops/pallas/window_attention.py:1251"),
    "flow_attention": ("emip_tpu_torch/csrc/flow_attention.cu",
                       "emip_tpu/ops/pallas/corr_softmax.py:204"),
    "convex_upsample": ("emip_tpu_torch/csrc/convex_upsample.cu",
                        "emip_tpu/ops/pallas/convex_upsample.py:85"),
    "window_attention_layer": ("emip_tpu_torch/csrc/window_attention.cu",
                               "emip_tpu/ops/pallas/window_attention.py:231"),
    "window_attention_ffn_layer": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:812"),
    "softmax_expectation": ("emip_tpu_torch/csrc/softmax_expectation.cu",
                            "emip_tpu/ops/pallas/corr_softmax.py:86"),
    "dwconv_gelu": ("emip_tpu_torch/csrc/dwconv_gelu.cu",
                    "emip_tpu/ops/pallas/mixffn.py:167"),
    "sr_attention_bwd": ("emip_tpu_torch/csrc/sr_attention.cu",
                         "emip_tpu/ops/pallas/sr_attention.py:236"),
    "window_attention_block_bwd": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:1269"),
    "flow_attention_bwd": ("emip_tpu_torch/csrc/flow_attention.cu",
                           "emip_tpu/ops/pallas/corr_softmax.py:279"),
    "convex_upsample_bwd": ("emip_tpu_torch/csrc/convex_upsample.cu",
                            "emip_tpu/ops/pallas/convex_upsample.py:178"),
    "splat_density": ("emip_tpu_torch/csrc/splat.cu",
                      "emip_tpu/ops/pallas/splat.py:89"),
    "memory_attention": ("emip_tpu_torch/csrc/memory_attention.cu",
                         "emip_tpu/ops/pallas/memory_attention.py:78"),
    "memory_attention_bwd": ("emip_tpu_torch/csrc/memory_attention.cu",
                             "emip_tpu/ops/pallas/memory_attention.py:159"),
    "window_attention_layer_bwd": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:389"),
    "window_attention_ffn_layer_bwd": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:835"),
    "softmax_expectation_bwd": ("emip_tpu_torch/csrc/softmax_expectation.cu",
                                "emip_tpu/ops/pallas/corr_softmax.py:142"),
    "dwconv_gelu_bwd": ("emip_tpu_torch/csrc/dwconv_gelu.cu",
                        "emip_tpu/ops/pallas/mixffn.py:181"),
}

# the card's published peaks (NVIDIA H100 SXM data sheet): fp32 outside the
# tensor cores, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# dense TF32 on the tensor cores; a 3xTF32 product spends three of them
PEAK_TF32_FLOPS = 495e12
# dense bf16 on the tensor cores (the bf16 band's products)
PEAK_BF16_FLOPS = 989e12
# The bf16 rows count each product at the rate its operands allow. A
# 3xTF32 product splits both fp32 operands into a TF32 high and low part
# and takes three TF32 products; a bf16 value is exact in TF32 (its low
# part is zero), so a product with one bf16 operand needs two
# ("tf32x2", at half the TF32 peak), and one of two bf16 operands, summed
# in fp32, is the bf16 tensor cores' own ("bf16"). F's bf16 forward splits
# its fp32 side (the ring) exactly into three bf16 parts and takes three
# bf16 products for each of its products ("bf16x3", at a third of the bf16
# peak).
# the kernels that run all their products on the tensor cores as 3xTF32 (A,
# B, C, F, G and H, forward and backward): their bound counts the
# operations at a third of the TF32 peak; the CUDA cores' fp32 figure, the
# bound of the other rows and of these before their redesign, stands beside
# it. None uses atomics: a second call must give the same bits
TENSOR_CORE_KERNELS = ("sr_attention", "sr_attention_bwd",
                       "window_attention_block", "window_attention_block_bwd",
                       "window_attention_layer", "window_attention_layer_bwd",
                       "window_attention_ffn_layer",
                       "window_attention_ffn_layer_bwd",
                       "flow_attention", "flow_attention_bwd",
                       "memory_attention", "memory_attention_bwd")
# kernels whose cases also read the device's busy time per call
# (``device_ms``): the CUDA-core kernels D, E, I and J, whose calls take the
# device about as long as, or less than, the host's launch path, which the
# CUDA-event time then reads
# (device_ms), and the bf16 backwards of A, B, C and F and A's bf16
# forward, whose launches per call the redesign of their bf16 form cut
# and the bf16 forwards of B and H and the bf16 backwards of G and H, whose
# redesign cut theirs too, and the bf16 forwards of C, G and F on the wgmma
# attention (G's layer in three launches; F's a launch for the ring's bf16
# parts beside it)
DEVICE_TIMED = ("convex_upsample", "convex_upsample_bwd", "splat_density",
                "softmax_expectation", "softmax_expectation_bwd",
                "dwconv_gelu", "dwconv_gelu_bwd", "convex_upsample_bf16",
                "convex_upsample_bwd_bf16", "dwconv_gelu_bf16",
                "dwconv_gelu_bwd_bf16", "sr_attention_bwd_bf16",
                "flow_attention_bwd_bf16", "window_attention_block_bwd_bf16",
                "memory_attention_bwd_bf16", "sr_attention_bf16",
                "window_attention_block_bf16",
                "window_attention_ffn_layer_bf16",
                "window_attention_layer_bwd_bf16",
                "window_attention_ffn_layer_bwd_bf16", "flow_attention_bf16",
                "window_attention_layer_bf16", "memory_attention_bf16")
# kernels held to the same bits on a second call on the same inputs: the
# tensor-core ones, J and I's backward, which add their per-block partials
# in a fixed order, and E, whose sum is in integers
BIT_EQUAL_KERNELS = TENSOR_CORE_KERNELS + (
    "dwconv_gelu", "dwconv_gelu_bwd", "softmax_expectation_bwd",
    "splat_density", "window_attention_layer_bwd_bf16",
    "window_attention_ffn_layer_bwd_bf16", "dwconv_gelu_bf16",
    "dwconv_gelu_bwd_bf16", "sr_attention_bwd_bf16",
    "flow_attention_bwd_bf16", "window_attention_block_bwd_bf16",
    "memory_attention_bwd_bf16", "window_attention_block_bf16",
    "window_attention_ffn_layer_bf16", "flow_attention_bf16",
    "window_attention_layer_bf16")
# the rows whose digests (sha256 of their grads' or output's bytes, per
# case) are printed on a line of their own: the bf16 and fp32 backwards of
# the kernels on the tensor cores' attention backward and GEMM, and the
# bf16 forwards of A, B, C, F, G and H, so that two trees can be shown to
# give the same bits at the same seeds (or, for B's and H's forwards and
# G's and H's bf16 backwards, whose products moved to the wgmma product,
# and C's, G's and F's forwards, whose attention did, that they moved);
# and J's backwards, whose bf16 walk keeps its loads and window as loaded
# (the same sums in the same order), and J's bf16 forward, whose staged
# walk keeps the sums and their order
DIGEST_KERNELS = ("sr_attention_bwd", "window_attention_block_bwd",
                  "window_attention_layer_bwd",
                  "window_attention_ffn_layer_bwd", "flow_attention_bwd",
                  "memory_attention_bwd", "sr_attention_bwd_bf16",
                  "flow_attention_bwd_bf16", "window_attention_block_bwd_bf16",
                  "memory_attention_bwd_bf16", "sr_attention_bf16",
                  "window_attention_block_bf16", "flow_attention_bf16",
                  "window_attention_ffn_layer_bf16",
                  "window_attention_layer_bwd_bf16",
                  "window_attention_ffn_layer_bwd_bf16",
                  "window_attention_layer_bf16", "memory_attention_bf16",
                  "dwconv_gelu_bwd", "dwconv_gelu_bwd_bf16",
                  "dwconv_gelu_bf16")
DIGESTS = {}
# J's fp32 backward's device ms per call by its u's shape, read beside its
# bf16 backward's at the same shape (bf16_backward_phase)
J_FP32_DEVICE_MS = {}
# the 3xTF32 GEMM alone against the fp64 product: max|err| / max|ref| (fp32
# rounding of sums over up to 61,952 rows)
GEMM_REL_TOL = 1e-5
# the tensor-core attention of A, B, G and H alone against the fp64
# product: max|err| / max|ref| (3xTF32 products, fp32 sums over up to 1024
# keys, the fast exp intrinsic)
ATTN_REL_TOL = 1e-5


# the bf16 band of short inference: the bf16 forwards of A-D (their own
# launch counters), each held to its plain bf16 version on the card and,
# against an fp64 evaluation of the same function on the same
# bf16-rounded inputs and weights, to no more than BF16_FP64_RATIO times
# the plain version's own error there; an error below BF16_FP64_FLOOR of
# max|ref| (the fp32 grade of the GEMM and attention checks above) counts
# as that floor, so that C and D, whose arithmetic after the bf16 inputs is
# fp32 on both sides, compare their bf16 rounding and not fp32 noise. All
# four are called twice and held bit-equal.
# The bf16 long model and 512^2 add F's bf16 forward (bf16 q against the
# fp32 ring) and G's and H's bf16 forwards to these rows, the fused MixFFN
# J's bf16 forward (bf16 u and taps, fp32 bias).
BF16_FWD_KERNELS = FWD_KERNELS + ("memory_attention", "window_attention_layer",
                                  "window_attention_ffn_layer", "dwconv_gelu")
BF16_KERNEL_INFO = {
    name + "_bf16": KERNEL_INFO[name] for name in BF16_FWD_KERNELS}
BF16_KERNEL_REL = 1e-2
BF16_FP64_RATIO = 1.5
BF16_FP64_FLOOR = 1e-5
# the bf16 train step: the bf16 backwards of A-D, held to the same gates
# grad by grad (their plain version is the fp32 plain version's VJP at the
# upcast inputs, each grad rounded to its input's dtype, as the JAX kernels
# compute it); their bound counts the recompute's products and the
# backward's, each at the rate its operands allow. A grad that stays fp32
# (A's biases', B's parameters', C's dv, D's gflow) is not rounded itself,
# so its floor
# against fp64 is BF16_FP32_GRAD_FLOOR of its max|ref|: above what both
# sides read on an H100 (B's parameter grads up to 1.4e-4, the kernel's and
# the plain version's alike: x1's bf16 rounding flips where fp32 and fp64
# round apart, passed through; A's bias grads, C's dv and D's gflow under
# 4e-6) and below the ~1e-3 that a backward reusing the bf16 forward's
# rounded buffers, or products not in 3xTF32, would show
BF16_FP32_GRAD_FLOOR = 2e-4
# the kernels that read fp32 in the bf16 band too, as the JAX package's: E
# (the occlusion masks' splat) and I (read-corr matching on the fp32
# correlation volume)
FP32_IN_BOTH_BANDS = ("splat_density", "softmax_expectation",
                      "softmax_expectation_bwd")
# G and H in bf16, forward and backward: what the 512^2 train step runs in
# place of B
GH_BF16 = ("window_attention_layer_bf16", "window_attention_layer_bwd_bf16",
           "window_attention_ffn_layer_bf16",
           "window_attention_ffn_layer_bwd_bf16")
# the bf16 train step's card-vs-CPU comparison: b5's widths at these PVT
# depths (the CPU's bf16 at full depth would not fit the time limit), one
# pair from each seed
BF16_COMPARE_DEPTHS = (1, 1, 2, 1)
BF16_COMPARE_SEEDS = (SEED + 9, SEED + 10)
# the G/H comparison (the 512^2 train step's path) over more pairs: its
# worst leaf reads close to the limit of 2 (the losses of the pairs beyond
# BF16_COMPARE_SEEDS are held pooled)
BF16_COMPARE_SEEDS_GH = tuple(SEED + 9 + i for i in range(6))
BF16_BWD_INFO = {
    "sr_attention_bwd_bf16": ("emip_tpu_torch/csrc/sr_attention.cu",
                              "emip_tpu/ops/pallas/sr_attention.py:253"),
    "window_attention_block_bwd_bf16": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:1279"),
    "flow_attention_bwd_bf16": ("emip_tpu_torch/csrc/flow_attention.cu",
                                "emip_tpu/ops/pallas/corr_softmax.py:287"),
    "convex_upsample_bwd_bf16": ("emip_tpu_torch/csrc/convex_upsample.cu",
                                 "emip_tpu/ops/pallas/convex_upsample.py:196"),
    "memory_attention_bwd_bf16": ("emip_tpu_torch/csrc/memory_attention.cu",
                                  "emip_tpu/ops/pallas/memory_attention.py:159"),
    # the bf16 train step at 512^2 (G and H) and the fused MixFFN (J)
    "window_attention_layer_bwd_bf16": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:411"),
    "window_attention_ffn_layer_bwd_bf16": (
        "emip_tpu_torch/csrc/window_attention.cu",
        "emip_tpu/ops/pallas/window_attention.py:843"),
    "dwconv_gelu_bwd_bf16": ("emip_tpu_torch/csrc/dwconv_gelu.cu",
                             "emip_tpu/ops/pallas/mixffn.py:185"),
}


def bound_rate(name: str) -> str:
    """The rates at which a row's bound counts its products (see
    PEAK_BF16_FLOPS), "+"-joined."""
    return {
        # bf16 q and P against the fp32 ring in three exact bf16 parts
        "memory_attention_bf16": "bf16x3",
        # products with the bf16 q (q k^T, dS^T q) and the rest
        "memory_attention_bwd_bf16": "tf32x2+tf32x3",
        # bf16 x and t into H's fp32 layer
        "window_attention_ffn_layer_bf16": "tf32x2+tf32x3",
        # a bf16 self layer, then H's layer on its bf16 output
        "window_attention_block_bf16": "bf16+tf32x2+tf32x3",
        # the fp32 recompute and backward on bf16 inputs (C: bf16 q, k;
        # A: bf16 weights too; B: bf16 x, t and x1)
        "sr_attention_bwd_bf16": "bf16+tf32x2+tf32x3",
        "window_attention_block_bwd_bf16": "tf32x2+tf32x3",
        "window_attention_layer_bwd_bf16": "tf32x2+tf32x3",
        "window_attention_ffn_layer_bwd_bf16": "tf32x2+tf32x3",
        "flow_attention_bwd_bf16": "bf16+tf32x2+tf32x3",
        "convex_upsample_bf16": "fp32",
        "convex_upsample_bwd_bf16": "fp32",
        # J: the stencil and GELU on the CUDA cores, storage bf16
        "dwconv_gelu_bf16": "fp32",
        "dwconv_gelu_bwd_bf16": "fp32",
    }.get(name, "bf16" if name.endswith("_bf16") else
          "tf32x3" if name in TENSOR_CORE_KERNELS else "fp32")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(fn):
    """(``fn()``, its CUDA-event milliseconds)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, reps: int, split: dict | None = None) -> float:
    """Milliseconds per call that the device is busy: the union of the
    intervals of the CUDA kernels and copies ``torch.profiler`` records over
    ``reps`` calls, after one warm-up. Host time between launches does not
    count, so a call shorter than the host's launch path reads its own
    time here and the host's in ``cuda_ms``. ``split``, where given, gets
    each kernel's (or memset's) own milliseconds per call by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiling session now and then comes back without its device
    # events (once in 35 sessions of a run on torch 2.11; in the whole
    # script, after some hundred sessions, three in a row for a call of one
    # small launch, while larger sessions lost part of theirs): such a
    # session is taken again with twice the calls, at most four times, and
    # the fifth empty one fails
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(ev, "is_user_annotation", False)]
        if events:
            break
        log(f"device_ms: torch.profiler recorded no device event over "
            f"{reps} calls; again over {2 * reps}")
        reps *= 2
    else:
        raise AssertionError("torch.profiler recorded no device time")
    if split is not None:
        for ev in events:
            name = _kernel_name(ev.name)
            split[name] = split.get(name, 0.0) + (
                ev.time_range.end - ev.time_range.start) / 1e3 / reps
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events)
    busy, reach = 0.0, -float("inf")  # us
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy / 1e3 / reps


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (any dtype)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def launches_per_call(fn) -> float:
    """Device kernels (and copies, memsets) one call of ``fn`` launches,
    from ``torch.profiler`` over two calls after a warm-up. A session now
    and then loses some of its device events (an unchanged fp32 case read 0
    launches in one run and 10 in another), so three are taken and the
    largest count kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(
            1 for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)) / 2)
    return max(counts)


def record_digest(name: str, label: str, grads, fn) -> dict:
    """The digest and launches per call of a case of a ``DIGEST_KERNELS``
    row (``grads``: its grads, or its output; logged, and kept for the
    digests line)."""
    if name not in DIGEST_KERNELS:
        return {}
    out = dict(digest=digest(grads), launches_per_call=launches_per_call(fn))
    DIGESTS[f"{name} {label}"] = out
    log(f"digest {name} {label}: sha256={out['digest']} launches/call="
        f"{out['launches_per_call']:g}")
    return out


def _kernel_name(name: str) -> str:
    """A profiler kernel name without its namespaces, return type and
    arguments: "void ns::(anonymous namespace)::k<4, 2>(float*)" -> "k<4,
    2>"."""
    base = name.replace("(anonymous namespace)", "").split("(")[0]
    head, sep, tmpl = base.partition("<")
    return head.split("::")[-1].split()[-1] + sep + tmpl


def device_times(name: str, kernel, plain, reps: int,
                 label: str = "") -> dict:
    """device_ms and plain_device_ms of a case of a ``DEVICE_TIMED``
    kernel or of kernel A's linear-PVTv2 checks (``label``), and
    ``device_split_ms``: the kernel side's device time by the name of each
    kernel it launches; else nothing."""
    if name not in DEVICE_TIMED and not label.startswith(LINEAR):
        return {}
    split = {}
    return dict(device_ms=device_ms(kernel, reps, split),
                plain_device_ms=device_ms(plain, reps),
                device_split_ms=split)


def fmt_dev(dev: dict) -> str:
    """The device times of a case for its log line."""
    out = "".join(f"{k}={v:.4f} " for k, v in dev.items()
                  if isinstance(v, float))
    if dev.get("device_split_ms"):
        out += "split[" + " ".join(
            f"{k}={v:.4f}" for k, v in dev["device_split_ms"].items()) + "] "
    return out


def device_sums(results: dict) -> None:
    """The device times of each ``DEVICE_TIMED`` row summed over its summed
    cases, beside its ms, plain_ms and bound_ms."""
    for name in DEVICE_TIMED:
        entry = results.get(name)
        if not entry:
            continue
        main = [c for c in entry["cases"] if c.get("summed", True)]
        keys = ["device_ms", "plain_device_ms"]
        if main and all("fp32_device_ms" in c for c in main):
            keys.append("fp32_device_ms")  # J's bf16 backward
        for k in keys:
            entry[k] = sum(c[k] for c in main)
        log(f"kernel {name}: its {len(main)} summed cases: "
            + " ".join(f"{k}={entry[k]:.4f}" for k in (
                "ms", "plain_ms", *keys, "bound_ms")))


def alternate_ms(kernel, plain, reps: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain,
    each the mean of its two turns."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def record(results: dict, name: str, label: str, err: float, ms: float,
           plain_ms: float, work: tuple[float, float, float],
           library_ms: float | None = None, summed: bool = True,
           **extra) -> None:
    """Add one case to its kernel's entry: the largest max_abs_err, and
    ms / plain_ms / library_ms / bound_ms summed over the cases (a case
    with ``summed`` false is listed in ``cases`` and counts in
    max_abs_err, but adds nothing to the sums). ``work`` is the case's
    (operations on the tensor cores, operations on the CUDA cores, bytes):
    the bound is the larger of the operations' time (3xTF32 products at a
    third of the TF32 peak, the others at the fp32 peak) and the bytes'
    time at the memory rate. No case may take less than its bound. Rows
    whose products are not all fp32 also carry ``bound_rate`` and the
    CUDA cores' figure for all their operations, ``fp32_bound_ms``. A
    fourth, fifth and sixth element of ``work``, where given, are the
    operations of products on two bf16 operands, at the bf16 peak, on
    one, at half the TF32 peak (2xTF32), and on a bf16 operand against an
    fp32 one taken in three bf16 parts, at a third of the bf16 peak."""
    tc_ops, cc_ops, nbytes, *more = work
    bf16_ops, x2_ops, x3b_ops = (list(more) + [0.0, 0.0, 0.0])[:3]
    rate = bound_rate(name)
    entry = results.setdefault(name, dict(
        max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
        ops_ms=0.0, bytes_ms=0.0, cases=[]))
    ops_ms = (tc_ops / (PEAK_TF32_FLOPS / 3) + x2_ops / (PEAK_TF32_FLOPS / 2)
              + bf16_ops / PEAK_BF16_FLOPS + x3b_ops / (PEAK_BF16_FLOPS / 3)
              + cc_ops / PEAK_FP32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    if ms < bound:
        raise AssertionError(f"{name} ({label}): {ms} ms is below the bound "
                             f"{bound} ms")
    fp32_ms = max((tc_ops + cc_ops + bf16_ops + x2_ops + x3b_ops)
                  / PEAK_FP32_FLOPS * 1e3, bytes_ms)
    if rate != "fp32":
        entry.setdefault("fp32_bound_ms", 0.0)
        entry["bound_rate"] = rate
        extra = dict(extra, fp32_bound_ms=fp32_ms, bound_rate=rate)
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["cases"].append(dict(
        case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        **({} if summed else dict(summed=False)), **extra))
    if not summed:
        return
    if rate != "fp32":
        entry["fp32_bound_ms"] += fp32_ms
    entry["ms"] += ms
    entry["plain_ms"] += plain_ms
    entry["bound_ms"] += bound
    entry["ops_ms"] += ops_ms
    entry["bytes_ms"] += bytes_ms
    entry["bound_by"] = ("operations" if entry["ops_ms"] >= entry["bytes_ms"]
                         else "bytes")
    if library_ms is not None:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + library_ms


def wanted(only: str, name: str) -> bool:
    """Whether kernel ``name`` is among the comma-separated substrings of
    ``only`` (every kernel when ``only`` is empty)."""
    return any(part in name for part in only.split(","))


def transpose_cost(batch: int, device, reps: int) -> dict:
    """ms of the contiguous transpose of the stored correlation that the
    read-corr matching hands kernel I for the backward flow (the kernel
    reads rows only), at the 352^2 and 512^2 shapes."""
    import torch

    out = {}
    for b, n in ((batch, 1936), (BATCH_512, 4096)):
        corr = torch.randn(b, n, n, device=device)
        out[f"[{b},{n},{n}]"] = cuda_ms(
            lambda: corr.transpose(1, 2).contiguous(), reps)
    log("read-corr matching: contiguous transpose of corr "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def stats_cost(batch: int, device, reps: int) -> dict:
    """ms of kernel C's forward without and with the row statistics it
    keeps for its backward (inputs that require a gradient), in turns, at
    the 352^2 and 512^2 shapes."""
    from emip_tpu_torch import kernels as K

    r = seeded_randn(SEED + 13, device)
    out = {}
    for b, n in ((2 * batch, 1936), (2 * BATCH_512, 4096)):
        q, k, v = r(b, n, 128), r(b, n, 128), r(b, n, 2, scale=10.0)
        qg = q.clone().requires_grad_(True)
        kept, bare = alternate_ms(lambda: K.fused_flow_attention(qg, k, v),
                                  lambda: K.fused_flow_attention(q, k, v),
                                  reps)
        out[f"[{b},{n},128]"] = dict(ms=bare, with_stats_ms=kept)
    log("flow_attention forward without / with kept row statistics: "
        + ", ".join(f"{k} {v['ms']:.4f} / {v['with_stats_ms']:.4f} ms"
                    for k, v in out.items()))
    return out


def fmt_ms(ms: float | None) -> str:
    return "none" if ms is None else f"{ms:.4f}"


def numel(*tensors) -> int:
    """Elements of the tensors among the arguments (dicts are searched)."""
    import torch

    n = 0
    for t in tensors:
        if isinstance(t, dict):
            n += numel(*t.values())
        elif torch.is_tensor(t):
            n += t.numel()
    return n


def _window_dims(name: str, args):
    """(rows, tokens per window, C, F or 0, layers) of a B, G or H call;
    args as the kernel cases pass them (dicts) or the backward cases
    (flat parameters)."""
    x = args[0]
    rows, tok, c = x.numel() // x.shape[-1], x.shape[-2], x.shape[-1]
    if name == "window_attention_block":
        w0 = (args[3]["w0"] if isinstance(args[3], dict)
              else args[2 + len(WIN_SELF) + WIN_CROSS.index("w0")])
        return rows, tok, c, w0.shape[0], 2
    if name == "window_attention_ffn_layer":
        w0 = args[2]["w0"] if isinstance(args[2], dict) else args[2 + 6]
        return rows, tok, c, w0.shape[0], 1
    return rows, tok, c, 0, 1


def forward_products(name: str, args) -> float:
    """Operations of one forward call of A, B, G or H (its GEMMs and its
    attention), multiply-adds counted as 2."""
    if name == "sr_attention":
        x, kv = args[0], args[1]
        (b, n, c), m = x.shape, kv.shape[1]
        return (2 * b * n * c * c * 2 + 2 * b * m * c * 2 * c
                + 4 * b * n * m * c)
    rows, tok, c, f, layers = _window_dims(name, args)
    gemm = layers * 4 * 2 * rows * c * c + 2 * rows * f * (2 * c + c)
    return gemm + layers * 4 * rows * tok * c


def forward_work(name: str, args, out) -> tuple[float, float, float]:
    """(tensor-core operations, CUDA-core operations, bytes) one forward
    call of a kernel must do: the products' multiply-adds counted as 2,
    every input read and the output written once in fp32."""
    nbytes = 4.0 * (numel(*args) + out.numel())
    tc = 0
    if name in ("sr_attention", "window_attention_block",
                "window_attention_layer", "window_attention_ffn_layer"):
        tc, ops = forward_products(name, args), 0
    elif name == "softmax_expectation":
        # per corr element: max, exp, sum and two multiply-adds
        ops = args[0].numel() * 8
    elif name == "dwconv_gelu":
        # per element: nine multiply-adds, bias, erf and the GELU product
        ops = args[0].numel() * 28
    elif name == "flow_attention":
        b, l, c = args[0].shape
        tc, ops = 2 * b * l * l * (c + args[2].shape[-1]), 0
    elif name == "memory_attention":
        (b, m, c), n = args[0].shape, args[1].shape[1]
        tc, ops = 4 * b * m * n * c, 0
    elif name == "convex_upsample":
        # per fine pixel: softmax over 9 taps and two 9-term sums
        ops = out.numel() // 2 * (9 * 4 + 9 * 2 * 2)
    elif name == "splat_density":
        ops = args[0].numel() // 2 * 16  # four bilinear corners per pixel
    else:
        raise KeyError(name)
    return float(tc), float(ops), nbytes


def _message_bwd_ops(rows: int, tok: int, c: int, want_q: bool,
                     want_kv: bool, wq: bool, wk: bool, wv: bool,
                     wm: bool, gxq: bool, gt: bool) -> float:
    """Products of one attention layer's backward as window_attention.cu's
    message_bwd computes them: each weight grad only when asked; the
    attention's scores and dO v^T once, and one product per grad it
    computes (dq for the q side, dk and dv for the k / v side)."""
    lin = 2.0 * rows * c * c
    att = 2.0 * rows * tok * c
    ops = lin * (wq + wk + wv + wm)
    if not (want_q or want_kv):
        return ops
    ops += lin  # gm Wm
    ops += att * (2 + want_q + 2 * want_kv)
    return ops + lin * (gxq + 2 * gt)


def backward_work(name: str, args, which, out) -> tuple[float, float, float]:
    """(tensor-core operations, CUDA-core operations, bytes) of a backward
    call. Attention is counted product by product as its kernels compute
    it: the scores and dO v^T, which every grad needs (the probabilities
    are no input, so they are recomputed), and one product per grad
    computed. A linear layer costs one input-grad product where its input's
    grad is needed and one weight-grad product only where that grad is
    asked for. Inputs and the cotangent are read once, the grads asked for
    written once. Every backward kernel but D's, E's, I's and J's runs all
    its products on the tensor cores."""
    base = name.removesuffix("_bwd")
    flat = list(args)
    nbytes = 4.0 * (numel(*args) + out.numel()
                    + numel(*(flat[i] for i in which)))
    w = set(which)
    if base == "memory_attention":
        (b, m, c), n = args[0].shape, args[1].shape[1]
        return 2.0 * b * m * n * c * (2 + len(which)), 0.0, nbytes
    if base == "flow_attention":
        (b, l, c), dv = args[0].shape, args[2].shape[-1]
        big, small = 2.0 * b * l * l * c, 2.0 * b * l * l * dv
        return (big + small + big * sum(i in w for i in (0, 1))
                + small * (2 in w)), 0.0, nbytes
    if base == "sr_attention":
        x, kv = args[0], args[1]
        (b, n, c), m = x.shape, kv.shape[1]
        want_q, want_kv = bool(w & {0, 2, 3}), bool(w & {1, 4, 5})
        q_lin, kv_lin = 2.0 * b * n * c * c, 2.0 * b * m * 2 * c * c
        att = 2.0 * b * n * m * c
        ops = q_lin * (6 in w)  # Wp grad
        if want_q or want_kv:
            ops += q_lin  # g Wp
            ops += att * (2 + want_q + 2 * want_kv)
            ops += q_lin * ((2 in w) + (0 in w))
            ops += kv_lin * ((4 in w) + (1 in w))
        return ops, 0.0, nbytes
    if base in ("window_attention_layer", "window_attention_ffn_layer",
                "window_attention_block"):
        rows, tok, c, f, _ = _window_dims(base, args)
        gx, gt = 0 in w, 1 in w
        if base == "window_attention_layer":
            p = {k: 2 + i in w for i, k in enumerate(WIN_SELF)}
            return _message_bwd_ops(
                rows, tok, c, gx or p["wq"], gt or p["wk"] or p["wv"],
                p["wq"], p["wk"], p["wv"], p["wm"], gx, gt), 0.0, nbytes
        off = 2 + (len(WIN_SELF) if base == "window_attention_block" else 0)
        cp = {k: off + i in w for i, k in enumerate(WIN_CROSS)}
        # the FFN: gh = gz W2 (GELU' fused), g_cat = gh W0 in two halves
        ffn = 2.0 * rows * c * f
        # (B forms the grad of x1 = the FFN's x whatever is asked)
        ops = ffn * (cp["w2"] + 2 * cp["w0"] + 2
                     + (gx or base == "window_attention_block"))
        if base == "window_attention_ffn_layer":
            return ops + _message_bwd_ops(
                rows, tok, c, gx or cp["wq"], gt or cp["wk"] or cp["wv"],
                cp["wq"], cp["wk"], cp["wv"], cp["wm"], gx, gt), 0.0, nbytes
        # B: the cross layer (q from x1, whose grad is always formed), then
        # the self layer (q, k and v from x)
        sp = {k: 2 + i in w for i, k in enumerate(WIN_SELF)}
        ops += _message_bwd_ops(rows, tok, c, True,
                                gt or cp["wk"] or cp["wv"], cp["wq"],
                                cp["wk"], cp["wv"], cp["wm"], True, gt)
        ops += _message_bwd_ops(rows, tok, c, gx or sp["wq"],
                                gx or sp["wk"] or sp["wv"], sp["wq"],
                                sp["wk"], sp["wv"], sp["wm"], gx, gx)
        return ops, 0.0, nbytes
    # D, E, I, J: two gradient products per forward product
    tc, cc, _ = forward_work(base, args, out)
    return 0.0, 2.0 * (tc + cc), nbytes


# ------------------------------------------------------------ kernels


def seeded_randn(seed: int, device):
    """r(*shape, scale=1.0): fp32 normal tensors on ``device`` from one
    numpy generator."""
    import torch

    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(device)

    return r


def sr_args(r, batch: int, n: int, m: int, c: int, heads: int) -> tuple:
    s = c**-0.5
    return (r(batch, n, c), r(batch, m, c), r(c, c, scale=s),
            r(c, scale=0.1), r(2 * c, c, scale=s), r(2 * c, scale=0.1),
            r(c, c, scale=s), r(c, scale=0.1), heads)


def window_params(r, c: int = 128, f: int = 1024) -> tuple[dict, dict]:
    """Self-layer and cross-layer (with FFN) parameters of one block."""
    s = c**-0.5

    def layer():
        return dict(wq=r(c, c, scale=s), wk=r(c, c, scale=s),
                    wv=r(c, c, scale=s), wm=r(c, c, scale=s),
                    s1=1.0 + r(c, scale=0.1), b1=r(c, scale=0.1))

    sp, cp = layer(), layer()
    cp.update(w0=r(f, 2 * c, scale=(2 * c)**-0.5), w2=r(c, f, scale=f**-0.5),
              s2=1.0 + r(c, scale=0.1), b2=r(c, scale=0.1))
    return sp, cp


def kernel_cases(batch: int, device):
    """(kernel, case label, kernel fn, plain fn, args) at the 352^2 shapes."""
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED, device)
    cases = []
    for n, m, c, heads in SR_STAGES:
        cases.append(("sr_attention", f"N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      sr_args(r, batch, n, m, c, heads)))

    c, tok, k2 = 128, 484, 4
    x, t = r(2 * batch, k2, tok, c), r(2 * batch, k2, tok, c)
    sp, cp = window_params(r, c)
    mask = shifted_window_mask(44, 44, 2, device=device)
    for label, msk in (("unshifted", None), ("shifted mask", mask)):
        cases.append(("window_attention_block",
                      f"[{2 * batch},{k2},{tok},{c}] {label}",
                      K.fused_window_attention_block,
                      K.fused_window_attention_block_reference,
                      (x, t, sp, cp, msk)))

    L = 1936
    cases.append(("flow_attention", f"[{2 * batch},{L},128] v=[...,2]",
                  K.fused_flow_attention, K.fused_flow_attention_reference,
                  (r(2 * batch, L, 128), r(2 * batch, L, 128),
                   r(2 * batch, L, 2, scale=10.0))))
    cases.append(("convex_upsample", f"flow [{2 * batch},44,44,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * batch, 44, 44, 2, scale=3.0),
                   r(2 * batch, 44, 44, 576), 8)))
    cases += [("memory_attention", label, K.masked_memory_attention,
               K.masked_memory_attention_reference, args)
              for label, args in memory_cases(r, MEMORY_FWD_CASES)]

    # ---- the 512^2 shapes of A, C and D, and kernels G-J
    for n, m, c, heads in SR_STAGES_512:
        cases.append(("sr_attention",
                      f"512^2 N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      sr_args(r, BATCH_512, n, m, c, heads)))
    L = 4096
    cases.append(("flow_attention", f"[{2 * BATCH_512},{L},128] v=[...,2]",
                  K.fused_flow_attention, K.fused_flow_attention_reference,
                  (r(2 * BATCH_512, L, 128), r(2 * BATCH_512, L, 128),
                   r(2 * BATCH_512, L, 2, scale=10.0))))
    cases.append(("convex_upsample", f"flow [{2 * BATCH_512},64,64,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * BATCH_512, 64, 64, 2, scale=3.0),
                   r(2 * BATCH_512, 64, 64, 576), 8)))
    # G and H at the 512^2 window (T = 1024: 1 and 4 clips, both flow
    # directions on the batch axis) and once at the 352^2 window (T = 484)
    c, k2 = 128, 4
    for b2, side in ((2, 64), (2 * BATCH_512, 64), (2 * batch, 44)):
        tok = (side // 2) ** 2
        x, t = r(b2, k2, tok, c), r(b2, k2, tok, c)
        sp, cp = window_params(r, c)
        mask = shifted_window_mask(side, side, 2, device=device)
        for label, msk in (("unshifted", None), ("shifted mask", mask)):
            if tok == 484 and msk is None:
                continue
            shape = f"[{b2},{k2},{tok},{c}] {label}"
            cases.append(("window_attention_layer", shape + " + x",
                          K.fused_window_attention_layer,
                          K.fused_window_attention_layer_reference,
                          (x, t, sp, msk, True)))
            if b2 == 2:
                cases.append(("window_attention_layer", shape + " message",
                              K.fused_window_attention_layer,
                              K.fused_window_attention_layer_reference,
                              (x, t, sp, msk, False)))
            cases.append(("window_attention_ffn_layer", shape,
                          K.fused_window_attention_ffn_layer,
                          K.fused_window_attention_ffn_layer_reference,
                          (x, t, cp, msk)))
    for b, n in ((batch, 1936), (BATCH_512, 4096)):
        cases.append(("softmax_expectation", f"corr [{b},{n},{n}]",
                      K.softmax_expectation, K.softmax_expectation_reference,
                      (r(b, n, n, scale=3.0), r(n, 2, scale=20.0))))
    for side, f in FFN_STAGES:
        cases.append(("dwconv_gelu", f"u [{batch},{side * side},{f}]",
                      K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
                      ffn_args(r, batch, side, side, f)))
    return cases


def check_cases(device):
    """Cases held and timed like kernel_cases' but kept out of their
    kernel's summed row (listed in its ``cases`` only), from a generator of
    their own so that kernel_cases' inputs stay as they were: C at a ragged
    token count (1000 = 31 key tiles of 32 + 8), at channel width 128 and
    at pvt_v2_b0's 64; J at ``FFN_CHECKS``."""
    from emip_tpu_torch import kernels as K

    r = seeded_randn(SEED + 15, device)
    cases = [("flow_attention", f"[2,1000,{c}] v=[...,2] ragged",
              K.fused_flow_attention, K.fused_flow_attention_reference,
              (r(2, 1000, c), r(2, 1000, c), r(2, 1000, 2, scale=10.0)))
             for c in (128, 64)]
    cases += [("dwconv_gelu", f"u [{b},{h * w},{f}] {h}x{w}",
               K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
               ffn_args(r, b, h, w, f)) for b, h, w, f in FFN_CHECKS]
    return (cases + scales_cases(device, bf16=False)
            + linear_sr_cases(device, SEED + 17, bf16=False))


def linear_sr_cases(device, seed: int, bf16: bool) -> list:
    """Kernel A at the linear PVTv2's four stages at 352^2, batch 8
    (``SR_STAGES_LINEAR``: 49 keys), from a generator of its own: (kernel,
    label, kernel fn, plain fn, args); ``bf16``: bf16 tokens and weights,
    fp32 biases."""
    import torch

    from emip_tpu_torch import kernels as K

    r = seeded_randn(seed, device)
    cases = []
    for n, m, c, heads in SR_STAGES_LINEAR:
        args = sr_args(r, BATCH, n, m, c, heads)
        if bf16:
            args = tuple(a.to(torch.bfloat16) if i in (0, 1, 2, 4, 6) else a
                         for i, a in enumerate(args))
        cases.append(("sr_attention" + ("_bf16" if bf16 else ""),
                      f"{LINEAR} N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      args))
    return cases


def scales_cases(device, bf16: bool):
    """The shapes multi-scale GMFlow (GMFLOW_SCALES) gives B and D at
    352^2, batch 8, from a generator of their own and kept out of the
    rows' sums: B on the fine scale's windows, 88^2 split 8 ways into 64
    windows of 121 tokens, both directions and both frames on the batch
    axis ([32, 64, 121, 128]), without and with the shift mask (in bf16
    the mask's rows read padded to 124); D at x4 (flow [16, 88, 88, 2],
    logits [16, 88, 88, 144]). ``bf16``: bf16 windows and logits."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + (47 if bf16 else 45), device)
    dt = torch.bfloat16 if bf16 else torch.float32
    tag = "_bf16" if bf16 else ""
    b2, k2, tok, c = 4 * BATCH, 64, 121, 128
    x, t = r(b2, k2, tok, c).to(dt), r(b2, k2, tok, c).to(dt)
    sp, cp = window_params(r, c)
    mask = shifted_window_mask(88, 88, 8, device=device)
    cases = [("window_attention_block" + tag,
              f"multi-scale [{b2},{k2},{tok},{c}] {label}",
              K.fused_window_attention_block,
              K.fused_window_attention_block_reference, (x, t, sp, cp, msk))
             for label, msk in (("unshifted", None), ("shifted mask", mask))]
    cases.append(("convex_upsample" + tag,
                  f"multi-scale flow [{2 * BATCH},88,88,2] x4",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * BATCH, 88, 88, 2, scale=3.0),
                   r(2 * BATCH, 88, 88, 144).to(dt), 4)))
    return cases


def ffn_args(r, b: int, h: int, w: int, f: int) -> tuple:
    """Kernel J's arguments: u, taps, bias, h, w."""
    return (r(b, h * w, f), r(3, 3, f, scale=0.3), r(f, scale=0.1), h, w)


# kernel F: (clips, query pixels, slots, written slots)
MEMORY_FWD_CASES = ((1, 1936, 5, 1), (1, 1936, 5, 3), (1, 1936, 5, 5),
                    (4, 1936, 5, 1), (4, 1936, 5, 3), (4, 1936, 5, 5),
                    (2, 100, 3, 0),       # every slot empty: mean of values
                    (1, 4096, 5, 5))      # the 512^2 shape
MEMORY_BWD_CASES = ((1, 1936, 5, 2), (4, 1936, 5, 5), (4, 1936, 5, 1))
MEMORY_BWD_CASES_MORE = ((1, 4096, 5, 5), (2, 100, 3, 0))


def memory_cases(r, shapes):
    """(label, (q, k, v, bias)) of the memory read: the ring flattened
    slot-major, oldest slot first, the written slots last (as
    ``MemoryState.push`` fills it), bias -1e9 on the empty ones."""
    import torch

    for b, m, slots, valid in shapes:
        q = r(b, m, 128, scale=2.0)
        k, v = r(b, slots * m, 128), r(b, slots * m, 128)
        bias = torch.zeros(b, slots, m, device=q.device)
        bias[:, :slots - valid] = -1e9
        yield (f"[{b},{m},128] x [{b},{slots * m},128] {valid}/{slots} slots",
               (q, k, v, bias.reshape(b, slots * m)))


def kernel_phase(batch: int, device, reps: int, only: str = "") -> dict:
    import torch

    results = {}
    cases = [(True, *case) for case in kernel_cases(batch, device)]
    cases += [(False, *case) for case in check_cases(device)]
    for summed, name, label, fn, ref, args in cases:
        if not wanted(only, name):
            continue
        got = fn(*args)
        torch.cuda.synchronize()
        want = ref(*args)
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL[name]
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, **tol)
        if name in BIT_EQUAL_KERNELS and not torch.equal(fn(*args), got):
            raise AssertionError(f"{name} ({label}): two calls on the same "
                                 f"inputs differ")
        ms, plain_ms = alternate_ms(lambda: fn(*args), lambda: ref(*args),
                                    reps)
        lib_ms = library_ms(name, args, reps)
        dev = device_times(name, lambda: fn(*args), lambda: ref(*args), reps,
                           label)
        log(f"kernel {name:24s} {label:32s} max_abs_err={err:.3e} "
            f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={fmt_ms(lib_ms)} "
            + fmt_dev(dev)
            + ("ok" if ok else "MISMATCH"))
        if not ok:
            raise AssertionError(f"{name} ({label}) disagrees with its plain "
                                 f"version: max_abs_err={err}, tol={tol}")
        record(results, name, label, err, ms, plain_ms,
               forward_work(name, args, got), lib_ms, summed=summed, **dev)
        del got, want
    device_sums(results)
    return results


def library_ms(name: str, args, reps: int, which=None) -> float | None:
    """Time of the one PyTorch call that computes the same function, where
    there is one: ``scaled_dot_product_attention`` for the flow-valued
    attention (if it takes a 2-wide value) and, with the bias as its
    ``attn_mask``, for the memory read; for J cuDNN's fp32 depthwise
    convolution and ``F.gelu`` (:func:`dwconv_library`, TF32 off), as its
    bf16 rows read theirs. With ``which``, the time of its backward alone.
    A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    base = name.removesuffix("_bwd")
    if base == "dwconv_gelu":
        if which is None:
            return cuda_ms(lambda: dwconv_library(args), reps)
        gen = torch.Generator(device=args[0].device).manual_seed(SEED + 3)
        _, _, rerun = _grads(lambda *a: dwconv_library(a), args, which,
                             lambda out: torch.randn(
                                 out.shape, generator=gen, device=out.device))
        return cuda_ms(rerun, reps)
    if base not in ("flow_attention", "memory_attention"):
        return None
    mask = args[3][:, None, :] if base == "memory_attention" else None

    def call(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    try:
        if which is None:
            return cuda_ms(lambda: call(*args[:3]), reps)
        gen = torch.Generator(device=args[0].device).manual_seed(SEED + 3)
        _, _, rerun = _grads(call, args[:3], which, lambda out: torch.randn(
            out.shape, generator=gen, device=out.device))
        return cuda_ms(rerun, reps)
    except RuntimeError as e:  # no backend takes these shapes
        log(f"library call for {name} refused: {str(e).splitlines()[0]}")
        return None


# ---------------------------------------------------- backward kernels


def backward_cases(batch: int, device):
    """The cases (kernel, label, kernel fn, plain fn, args, indices of the
    args that take a gradient) at the shapes of the 352^2 train step and a
    few more, the indices of C's and F's cases at 352^2, and the indices of
    the checks kept out of their kernel's summed row (J at
    ``FFN_CHECKS``, from a generator of their own)."""
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + 2, device)
    cases, at_352 = [], set()
    for n, m, c, heads in SR_STAGES:
        cases.append(("sr_attention_bwd", f"N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      sr_args(r, batch, n, m, c, heads), tuple(range(8))))

    c, tok, k2 = 128, 484, 4
    x, t = r(2 * batch, k2, tok, c), r(2 * batch, k2, tok, c)
    sp, cp = window_params(r, c)
    mask = shifted_window_mask(44, 44, 2, device=device)

    def block(x, t, *p, mask=None):
        return K.fused_window_attention_block(
            x, t, dict(zip(WIN_SELF, p[:6])), dict(zip(WIN_CROSS, p[6:])),
            mask)

    def block_ref(x, t, *p, mask=None):
        return K.fused_window_attention_block_reference(
            x, t, dict(zip(WIN_SELF, p[:6])), dict(zip(WIN_CROSS, p[6:])),
            mask)

    params = [sp[k] for k in WIN_SELF] + [cp[k] for k in WIN_CROSS]
    for label, msk in (("unshifted", None), ("shifted mask", mask)):
        for wgrads in (False, True):
            fn = functools.partial(block, mask=msk)
            ref = functools.partial(block_ref, mask=msk)
            which = tuple(range(2 + len(params))) if wgrads else (0, 1)
            cases.append((
                "window_attention_block_bwd",
                f"[{2 * batch},{k2},{tok},{c}] {label}, "
                f"{'x t + weight' if wgrads else 'x t'} grads",
                fn, ref, (x, t, *params), which))

    L = 1936
    for b, label, which in ((batch, "matching", (0, 1)),
                            (2 * batch, "propagation", (0, 1)),
                            (2 * batch, "propagation with dv", (0, 1, 2))):
        at_352.add(len(cases))
        cases.append(("flow_attention_bwd", f"[{b},{L},128] v=[...,2] {label}",
                      K.fused_flow_attention,
                      K.fused_flow_attention_reference,
                      (r(b, L, 128), r(b, L, 128), r(b, L, 2, scale=10.0)),
                      which))
    # the 512^2 train step's shape (batch 2, both directions) and a small
    # ragged one (1000 = 15 tiles of 64 + 40)
    for b, L, label, which in ((2 * TRAIN_BATCH_512, 4096, "512^2 matching",
                                (0, 1)), (2, 1000, "ragged dq dk dv",
                                          (0, 1, 2))):
        cases.append(("flow_attention_bwd", f"[{b},{L},128] v=[...,2] {label}",
                      K.fused_flow_attention,
                      K.fused_flow_attention_reference,
                      (r(b, L, 128), r(b, L, 128), r(b, L, 2, scale=10.0)),
                      which))
    cases.append(("convex_upsample_bwd", f"flow [{2 * batch},44,44,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * batch, 44, 44, 2, scale=3.0),
                   r(2 * batch, 44, 44, 576), 8), (0, 1)))
    for label, args in memory_cases(r, MEMORY_BWD_CASES):
        for which, what in (((0, 1, 2), "dq dk dv"), ((0,), "dq")):
            at_352.add(len(cases))
            cases.append(("memory_attention_bwd", f"{label} {what}",
                          K.masked_memory_attention,
                          K.masked_memory_attention_reference, args, which))
    # the 512^2 long train step's shape, and a ragged one with every slot
    # empty (row max -1e9, uniform weights)
    for label, args in memory_cases(r, MEMORY_BWD_CASES_MORE):
        cases.append(("memory_attention_bwd", f"{label} dq dk dv",
                      K.masked_memory_attention,
                      K.masked_memory_attention_reference, args, (0, 1, 2)))

    # ---- G and H at the 512^2 train step's window (batch 2 pairs, both
    # directions) and at T = 484; I; J
    def layer_fns(kernel, plain, keys, **kw):
        return (lambda x, t, *p: kernel(x, t, dict(zip(keys, p)), **kw),
                lambda x, t, *p: plain(x, t, dict(zip(keys, p)), **kw))

    for b2, side in ((4, 64), (2 * batch, 44)):
        tok = (side // 2) ** 2
        x, t = r(b2, k2, tok, c), r(b2, k2, tok, c)
        sp, cp = window_params(r, c)
        mask = shifted_window_mask(side, side, 2, device=device)
        sflat, cflat = [sp[k] for k in WIN_SELF], [cp[k] for k in WIN_CROSS]
        for label, msk in (("unshifted", None), ("shifted mask", mask)):
            if tok == 484 and msk is None:
                continue
            for wgrads in (False, True):
                what = "x t + weight" if wgrads else "x t"
                shape = f"[{b2},{k2},{tok},{c}] {label}, {what} grads"
                for res in ((True, False) if tok == 1024 and wgrads
                            else (True,)):
                    fn, ref = layer_fns(
                        K.fused_window_attention_layer,
                        K.fused_window_attention_layer_reference, WIN_SELF,
                        mask=msk, add_residual=res)
                    cases.append((
                        "window_attention_layer_bwd",
                        shape + (" (+ x)" if res else " (message)"), fn, ref,
                        (x, t, *sflat),
                        tuple(range(2 + len(sflat))) if wgrads else (0, 1)))
                fn, ref = layer_fns(
                    K.fused_window_attention_ffn_layer,
                    K.fused_window_attention_ffn_layer_reference, WIN_CROSS,
                    mask=msk)
                cases.append((
                    "window_attention_ffn_layer_bwd", shape, fn, ref,
                    (x, t, *cflat),
                    tuple(range(2 + len(cflat))) if wgrads else (0, 1)))
    for b, n in ((batch, 1936), (2, 4096)):
        for which, what in (((0,), "dcorr"), ((0, 1), "dcorr dvalues")):
            cases.append(("softmax_expectation_bwd",
                          f"corr [{b},{n},{n}] {what}",
                          K.softmax_expectation,
                          K.softmax_expectation_reference,
                          (r(b, n, n, scale=3.0), r(n, 2, scale=20.0)),
                          which))
    for side, f in FFN_STAGES:
        cases.append(("dwconv_gelu_bwd",
                      f"u [{batch},{side * side},{f}] gu taps bias",
                      K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
                      ffn_args(r, batch, side, side, f), (0, 1, 2)))
    r = seeded_randn(SEED + 16, device)
    checks = set()
    for b, h, w, f in FFN_CHECKS:
        checks.add(len(cases))
        cases.append(("dwconv_gelu_bwd",
                      f"u [{b},{h * w},{f}] {h}x{w} gu taps bias",
                      K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
                      ffn_args(r, b, h, w, f), (0, 1, 2)))
    for b, n in SOFTMAX_BWD_CHECKS:
        checks.add(len(cases))
        cases.append(("softmax_expectation_bwd",
                      f"corr [{b},{n},{n}] dcorr dvalues",
                      K.softmax_expectation, K.softmax_expectation_reference,
                      (r(b, n, n, scale=3.0), r(n, 2, scale=20.0)), (0, 1)))
    for _, label, fn, ref, args in linear_sr_cases(device, SEED + 18,
                                                   bf16=False):
        checks.add(len(cases))
        cases.append(("sr_attention_bwd", label, fn, ref, args,
                      tuple(range(8))))
    return cases, at_352, checks


def _grads(fn, args, which, cot):
    """(forward output, fn's grads w.r.t. args[which] for cotangent cot,
    a callable that reruns the backward only)."""
    import torch

    leaves = [a.detach().requires_grad_(i in which) if torch.is_tensor(a)
              else a for i, a in enumerate(args)]
    wrt = [leaves[i] for i in which]
    out = fn(*leaves)
    gcot = cot(out)
    grads = torch.autograd.grad(out, wrt, gcot, retain_graph=True)

    def rerun():
        return torch.autograd.grad(out, wrt, gcot, retain_graph=True)

    return out, grads, rerun


def backward_phase(batch: int, device, reps: int, only: str = "") -> dict:
    """Each backward kernel against torch.autograd.grad of its plain
    version on the same seeded inputs and cotangent; CUDA-event times of
    the backward alone (the graph is built once and kept)."""
    import torch

    results = {}
    cases, at_352, checks = backward_cases(batch, device)
    for i, (name, label, fn, ref, args, which) in enumerate(cases):
        if not wanted(only, name):
            continue
        gen = torch.Generator(device=device).manual_seed(SEED + 3)

        def cot(out):
            return torch.randn(out.shape, generator=gen, device=device)

        out_k, got, rerun_k = _grads(fn, args, which, cot)
        gen.manual_seed(SEED + 3)
        out_p, want, rerun_p = _grads(ref, args, which, cot)
        if out_k.grad_fn is None:
            raise AssertionError(f"{name}: the CUDA output has no grad_fn")
        torch.cuda.synchronize()
        # largest over the grads of max|err| / max|plain|: weight grads sum
        # over ~10^5 rows, so an absolute tolerance has no fixed scale
        rel, err = 0.0, 0.0
        for g, w in zip(got, want):
            e = (g - w).abs().max().item()
            err = max(err, e)
            rel = max(rel, e / max(w.abs().max().item(), 1e-30))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ok = finite and rel <= BWD_REL_TOL
        if name in BIT_EQUAL_KERNELS:
            # no atomics: a second call on the same inputs gives the same bits
            again = rerun_k()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} ({label}): two calls on the "
                                     f"same inputs differ")
            del again
        dig = record_digest(name, label, got, rerun_k)
        ms, plain_ms = alternate_ms(rerun_k, rerun_p, reps)
        lib_ms = library_ms(name, args, reps, which)
        dev = device_times(name, rerun_k, rerun_p, reps, label)
        if name == "dwconv_gelu_bwd":
            J_FP32_DEVICE_MS[tuple(args[0].shape)] = dev["device_ms"]
        log(f"kernel {name:28s} {label:44s} max_abs_err={err:.3e} "
            f"max_rel={rel:.3e} (tol {BWD_REL_TOL}) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={fmt_ms(lib_ms)} "
            + fmt_dev(dev)
            + ("ok" if ok else "MISMATCH"))
        if not ok:
            raise AssertionError(f"{name} ({label}) disagrees with the plain "
                                 f"backward: max_rel={rel}")
        record(results, name, label, err, ms, plain_ms,
               backward_work(name, args, which, out_k), lib_ms,
               summed=i not in checks, max_rel=rel, at_352=i in at_352,
               **dev, **dig)
        del out_k, out_p, got, want, rerun_k, rerun_p
    for name in TENSOR_CORE_KERNELS:
        # the 352^2 cases apart from the 512^2 and ragged ones
        main = [c for c in results.get(name, {}).get("cases", ())
                if c["at_352"]]
        if main:
            tot = {k: sum(c[k] or 0.0 for c in main) for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "fp32_bound_ms")}
            results[name]["main_cases"] = tot
            log(f"kernel {name}: its {len(main)} cases at 352^2 sum to "
                + " ".join(f"{k}={v:.4f}" for k, v in tot.items())
                + " (bound_ms: 3xTF32 operations; fp32_bound_ms: fp32)")
    if wanted(only, "splat_density"):
        splat_cases(results, device, reps)
    device_sums(results)
    return results


def gemm_shapes(batch: int) -> list:
    """(label, M, K, N, form) of every GEMM kernels B and A run on the 352^2
    train step, and two ragged checks. form: "x W^T" (a row-major, b a
    Linear weight read transposed), "dy W" (both row-major; "dy W0" reads
    half of W0's columns), "dY^T X" (a read transposed, K split: a weight
    gradient over all rows)."""
    rows, c, f = 2 * batch * 4 * 484, 128, 1024
    shapes = [("B q k v m", rows, c, c, "x W^T"),
              ("B cat W0^T", rows, 2 * c, f, "x W^T"),
              ("B u W2^T", rows, f, c, "x W^T"),
              ("B gm Wm", rows, c, c, "dy W"),
              ("B gz W2", rows, c, f, "dy W"),
              ("B gh W0", rows, f, c, "dy W0"),
              ("B dWq", c, rows, c, "dY^T X"),
              ("B dW2", c, rows, f, "dY^T X"),
              ("B dW0", f, rows, 2 * c, "dY^T X")]
    for n, m, c, _ in SR_STAGES:
        bn, bm = batch * n, batch * m
        shapes += [(f"A N={n} q proj", bn, c, c, "x W^T"),
                   (f"A N={n} kv", bm, c, 2 * c, "x W^T"),
                   (f"A N={n} g Wp", bn, c, c, "dy W"),
                   (f"A N={n} gkv Wkv", bm, 2 * c, c, "dy W"),
                   (f"A N={n} dWq", c, bn, c, "dY^T X"),
                   (f"A N={n} dWkv", 2 * c, bm, c, "dY^T X")]
    # rows of 90 floats (4-byte copies) and ragged M, N, K tiles
    shapes += [("check ragged", 1000, 90, 70, "x W^T"),
               ("check ragged dW", 70, 999, 90, "dY^T X")]
    return shapes


def wgmma_shapes(batch: int) -> list:
    """(label, rows, C, F, form) of the wgmma product's lines (a ``dyW``
    form's: label, rows, K, N, form): the forms B's
    and H's bf16 forwards run, at B's rows at 352^2 and H's at 512^2 with
    one clip ([2, 4, 1024, 128]: 64 row tiles of 128, so the 64-row
    blocks), and a ragged check; then the input grads dy W of G's and H's
    bf16 backwards at the 512^2 train step's rows ([4, 4, 1024, 128];
    ``dyW`` forms, :func:`wgmma_dyw_line`: gm Wm, [gk | gv] [Wk; Wv] with gt
    rounded and gh W0, which the backwards run on the wgmma product; gq Wq
    with g's bf16 addend and gx rounded and gz W2 times gelu'(h), which
    they run on ``gemm_tf32.cuh``, where the card ran them faster) and a
    ragged check."""
    rb, rh, c, f = 2 * batch * 4 * 484, 2 * 4 * 1024, 128, 1024
    rg = 2 * rh
    return [("B q k v", rb, c, f, "qkv"), ("B x|msg W0^T", rb, c, f, "w0"),
            ("B u W2^T LN", rb, c, f, "w2"), ("H q k v", rh, c, f, "qkv"),
            ("H x|msg W0^T", rh, c, f, "w0"), ("H u W2^T LN", rh, c, f, "w2"),
            ("check ragged", 1000, 100, 70, "ragged"),
            ("G/H gm Wm", rg, c, c, "dyW"), ("G g + gq Wq", rg, c, c,
                                             "dyW+g"),
            ("G/H gkv Wkv", rg, 2 * c, c, "dyW16"),
            ("H gz W2 gelu'", rg, c, f, "dyWgg"),
            ("H gh W0", rg, f, 2 * c, "dyW"),
            ("check ragged dyW", 1000, 100, 70, "dyW")]


def wgmma_line(r, label: str, m: int, c: int, f: int, form: str,
               reps: int) -> dict:
    """One line of the wgmma product (``gemm_wgmma``): its error against
    the fp64 evaluation, bit equality on a second call, and its time in
    turns with the 3xTF32 GEMM of ``gemm_tf32.cuh`` and ``torch.matmul``
    (fp32, TF32 off), each on the same product with the fp32 (upcast)
    operands, no epilogue (q, k, v: one source over the stacked weight);
    the bound counts a bf16 source's products at two TF32 terms, an fp32
    one's at three."""
    import torch

    from emip_tpu_torch.kernels.gemm import (
        gemm,
        gemm_wgmma,
        gemm_wgmma_reference,
    )

    bf = torch.bfloat16
    if form == "qkv":  # q from x, k and v from t, two terms each
        kw = dict(a=r(m, c).to(bf), a2=r(m, c).to(bf), n_switch=c,
                  w=r(3 * c, c) / c ** 0.5)
        a32, k, n, x2_k = kw["a"].float(), c, 3 * c, c
    elif form == "w0":  # bf16 x, then fp32 msg, along K; GELU
        kw = dict(a=r(m, c).to(bf), a2=r(m, c), w=r(f, 2 * c) / 16,
                  epilogue="gelu")
        a32 = torch.cat([kw["a"].float(), kw["a2"]], -1)
        k, n, x2_k = 2 * c, f, c
    elif form == "w2":  # fp32 u, LayerNorm epilogue
        kw = dict(a=r(m, f), w=r(c, f) / 32, epilogue="layernorm",
                  gamma=1 + 0.1 * r(c), beta=0.1 * r(c))
        a32, k, n, x2_k = kw["a"], f, c, 0
    else:  # ragged M, N and K tiles, fp32
        kw = dict(a=r(m, c), w=r(f, c) / 10)
        a32, k, n, x2_k = kw["a"], c, f, 0
    got = gemm_wgmma(**kw)
    want = gemm_wgmma_reference(
        **{key: v.double() if torch.is_tensor(v) else v
           for key, v in kw.items()})
    err = ((got.double() - want).abs().max() / want.abs().max()).item()
    del want
    if not torch.equal(gemm_wgmma(**kw), got):
        raise AssertionError(f"gemm_wgmma ({label}): two calls differ")
    b = kw["w"].T
    turns = [cuda_ms(lambda: gemm(a32, b), reps),
             cuda_ms(lambda: a32 @ b, reps), cuda_ms(lambda: gemm_wgmma(**kw),
                                                      reps)]
    turns += [cuda_ms(lambda: gemm_wgmma(**kw), reps),
              cuda_ms(lambda: a32 @ b, reps), cuda_ms(lambda: gemm(a32, b),
                                                      reps)]
    ms, mm_ms = (turns[2] + turns[3]) / 2, (turns[1] + turns[4]) / 2
    tf32_ms = (turns[0] + turns[5]) / 2
    ops = 2.0 * m * n * k
    x2_ops = 2.0 * m * n * x2_k  # products of a bf16 source
    size = nbytes(*kw.values(), got)
    bound = max(x2_ops / (PEAK_TF32_FLOPS / 2)
                + (ops - x2_ops) / (PEAK_TF32_FLOPS / 3),
                size / PEAK_BYTES_PER_S) * 1e3
    ok = err <= GEMM_REL_TOL and ms >= bound
    log(f"gemm_wgmma {label:16s} {form:6s} [{m},{k}]x[{k},{n}] "
        f"rel_err={err:.2e} (tol {GEMM_REL_TOL}) ms={ms:.4f} "
        f"({ops / ms / 1e9:.1f} TFLOP/s) gemm_tf32_ms={tf32_ms:.4f} "
        f"({ops / tf32_ms / 1e9:.1f}) matmul_ms={mm_ms:.4f} "
        f"({ops / mm_ms / 1e9:.1f}) bound_ms={bound:.4f} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"gemm_wgmma ({label}): rel_err={err}, ms={ms} "
                             f"against bound {bound}")
    return dict(m=m, k=k, n=n, form=form, rel_err=err, ms=ms,
                gemm_tf32_ms=tf32_ms, matmul_ms=mm_ms, bound_ms=bound,
                tflops=ops / ms / 1e9, gemm_tf32_tflops=ops / tf32_ms / 1e9,
                matmul_tflops=ops / mm_ms / 1e9)


def wgmma_dyw_line(r, label: str, m: int, k: int, n: int, form: str,
                   reps: int) -> dict:
    """A ``gemm_wgmma`` line of an input grad dy W [m, k] x [k, n] of G's
    and H's bf16 backwards (``gemm_dy_w``): on the wgmma product (the
    weight split transposed) against the fp64 evaluation, fp32 within
    ``GEMM_REL_TOL`` of max|ref| (``dyWgg``: times gelu'(h)), a bf16 output
    (``dyW+g``: plus a bf16 addend, ``dyW16``) within one bf16 rounding
    more, 2^-8 of max|ref|; the same bits twice. Its product kernel's
    device time (``torch.profiler``, the split launch apart) in turns with
    ``gemm_tf32.cuh``'s on the same product and epilogue (which decides
    where the product runs in the backwards), and ``torch.matmul``'s dy W
    (fp32, no epilogue) beside them; CUDA-event ms as :func:`wgmma_line`."""
    import torch

    from emip_tpu_torch.kernels.gemm import gemm_dy_w, gemm_dy_w_reference

    bf = torch.bfloat16
    kw = dict(dy=r(m, k), w=r(k, n) / k ** 0.5)
    if form == "dyWgg":
        kw.update(epilogue="gelu_grad", aux=r(m, n))
    elif form == "dyW+g":
        kw.update(add=r(m, n).to(bf), out_dtype=bf)
    elif form == "dyW16":
        kw.update(out_dtype=bf)
    got = gemm_dy_w(**kw)
    want = gemm_dy_w_reference(
        **{key: v.double() if torch.is_tensor(v) else v
           for key, v in kw.items() if key != "out_dtype"})
    err = ((got.double() - want).abs().max() / want.abs().max()).item()
    tol = GEMM_REL_TOL + (0.0 if got.dtype == torch.float32 else 2.0 ** -8)
    tf32_err = ((gemm_dy_w(**kw, wgmma=False).double() - want).abs().max()
                / want.abs().max()).item()
    del want
    if not torch.equal(gemm_dy_w(**kw), got):
        raise AssertionError(f"gemm_wgmma ({label}): two calls differ")

    def wg():
        return gemm_dy_w(**kw)

    def tf():
        return gemm_dy_w(**kw, wgmma=False)

    def product_ms(fn, prefix):
        split = {}
        device_ms(fn, reps, split)
        return sum(v for key, v in split.items() if key.startswith(prefix))

    a32, b = kw["dy"], kw["w"]
    dev = [product_ms(tf, "gemm_tc_kernel"), product_ms(wg, "wg_gemm_kernel"),
           product_ms(wg, "wg_gemm_kernel"), product_ms(tf, "gemm_tc_kernel")]
    mm_dev = device_ms(lambda: a32 @ b, reps)
    turns = [cuda_ms(tf, reps), cuda_ms(wg, reps), cuda_ms(wg, reps),
             cuda_ms(tf, reps)]
    ms, tf32_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    mm_ms = cuda_ms(lambda: a32 @ b, reps)
    dev_ms, tf32_dev = (dev[1] + dev[2]) / 2, (dev[0] + dev[3]) / 2
    ops = 2.0 * m * n * k
    size = nbytes(*(v for v in kw.values() if torch.is_tensor(v)), got)
    bound = max(ops / (PEAK_TF32_FLOPS / 3), size / PEAK_BYTES_PER_S) * 1e3
    ok = err <= tol and tf32_err <= tol and dev_ms >= bound
    log(f"gemm_wgmma {label:16s} {form:6s} [{m},{k}]x[{k},{n}] "
        f"rel_err={err:.2e} (gemm_tf32 {tf32_err:.2e}, tol {tol:.1e}) "
        f"device ms in turns gemm_tf32 / wgmma / wgmma / gemm_tf32 "
        + " / ".join(f"{d:.4f}" for d in dev)
        + f" ({ops / dev_ms / 1e9:.1f} against {ops / tf32_dev / 1e9:.1f} "
        f"TFLOP/s; {'wgmma' if dev_ms < tf32_dev else 'gemm_tf32'} faster) "
        f"matmul_device_ms={mm_dev:.4f} ({ops / mm_dev / 1e9:.1f}) "
        f"ms={ms:.4f} gemm_tf32_ms={tf32_ms:.4f} matmul_ms={mm_ms:.4f} "
        f"bound_ms={bound:.4f} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"gemm_wgmma ({label}): rel_err={err}, "
                             f"{tf32_err}, device ms {dev_ms} against bound "
                             f"{bound}")
    return dict(m=m, k=k, n=n, form=form, rel_err=err,
                gemm_tf32_rel_err=tf32_err, device_ms=dev,
                matmul_device_ms=mm_dev, ms=ms, gemm_tf32_ms=tf32_ms,
                matmul_ms=mm_ms, bound_ms=bound, tflops=ops / dev_ms / 1e9,
                gemm_tf32_tflops=ops / tf32_dev / 1e9,
                matmul_tflops=ops / mm_dev / 1e9)


def gemm_phase(batch: int, device, reps: int,
               wgmma_only: bool = False) -> dict:
    """The 3xTF32 GEMM alone at each shape kernels B and A give it: the
    error of it and of ``torch.matmul`` (fp32, TF32 off) against the fp64
    product, their times in turns, and the bound at the 3xTF32 rate; then
    the wgmma product of B's and H's bf16 forwards at their forms
    (``wgmma_line``). One log line per shape; not part of the result
    line. ``wgmma_only``: the wgmma lines alone."""
    import torch

    from emip_tpu_torch.kernels.gemm import gemm

    out = {}
    r = seeded_randn(SEED + 22, device)
    for label, m, c, f, form in wgmma_shapes(batch):
        line = wgmma_dyw_line if form.startswith("dyW") else wgmma_line
        out["wgmma " + label] = line(r, label, m, c, f, form, reps)
    if wgmma_only:
        return out
    r = seeded_randn(SEED + 21, device)
    for label, m, k, n, form in gemm_shapes(batch):
        if form == "x W^T":
            a, b = r(m, k), r(n, k).T
        elif form == "dy W":
            a, b = r(m, k), r(k, n)
        elif form == "dy W0":
            a, b = r(m, k), r(k, 2 * n)[:, :n]
        else:
            a, b = r(k, m).T, r(k, n)
        split = form == "dY^T X"
        got = gemm(a, b, split_k=split)
        ref = a.double() @ b.double()
        scale = ref.abs().max().item()
        err = (got.double() - ref).abs().max().item() / scale
        mm_err = ((a @ b).double() - ref).abs().max().item() / scale
        if not torch.equal(gemm(a, b, split_k=split), got):
            raise AssertionError(f"gemm ({label}): two calls differ")
        del ref
        ms, mm_ms = alternate_ms(lambda: gemm(a, b, split_k=split),
                                 lambda: a @ b, reps)
        ops = 2.0 * m * n * k
        bound = max(ops / (PEAK_TF32_FLOPS / 3),
                    4.0 * (m * k + k * n + m * n) / PEAK_BYTES_PER_S) * 1e3
        ok = err <= GEMM_REL_TOL and ms >= bound
        log(f"gemm {label:20s} {form:7s} [{m},{k}]x[{k},{n}] "
            f"rel_err={err:.2e} (matmul {mm_err:.2e}, tol {GEMM_REL_TOL}) "
            f"ms={ms:.4f} matmul_ms={mm_ms:.4f} bound_ms={bound:.4f} "
            f"{ops / ms / 1e9:.1f} TFLOP/s {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"gemm ({label}): rel_err={err}, "
                                 f"ms={ms} against bound {bound}")
        out[label] = dict(m=m, k=k, n=n, form=form, rel_err=err,
                          matmul_rel_err=mm_err, ms=ms, matmul_ms=mm_ms,
                          bound_ms=bound)
        del a, b, got
    return out


def attention_shapes(batch: int) -> list:
    """(label, B, Nq, Nk, C, heads, windows, masked) of the forward
    attention inside A, B, G and H: A's four PVT stages at 352^2 and at
    512^2, B's windows at 352^2, G's and H's at 512^2 (1 and 4 clips, both
    flow directions), and pvt_v2_b0's widths (A 32, B 64)."""
    shapes = [(f"A N={n} M={m} C={c} heads={h}", batch, n, m, c, h, False,
               False) for n, m, c, h in SR_STAGES]
    shapes += [(f"A 512^2 N={n} M={m} C={c} heads={h}", BATCH_512, n, m, c,
                h, False, False) for n, m, c, h in SR_STAGES_512]
    windows = 2 * batch * 4
    shapes += [(f"B [{windows},484,128]", windows, 484, 484, 128, 1, True,
                False),
               (f"B [{windows},484,128] mask", windows, 484, 484, 128, 1,
                True, True)]
    shapes += [(f"G H [{w},1024,128] mask", w, 1024, 1024, 128, 1, True,
                True) for w in (2 * 4, 2 * BATCH_512 * 4)]
    shapes += [("b0 A N=7744 M=121 C=32 heads=1", batch, 7744, 121, 32, 1,
                False, False),
               ("b0 A N=121 M=121 C=256 heads=8", batch, 121, 121, 256, 8,
                False, False),
               (f"b0 B [{windows},484,64] mask", windows, 484, 484, 64, 1,
                True, True)]
    return shapes


def attention_phase(batch: int, device, reps: int) -> dict:
    """The tensor-core forward attention of A, B, G and H alone at each
    shape of :func:`attention_shapes`: its error and that of
    ``scaled_dot_product_attention`` (fp32, the mask as its ``attn_mask``)
    against the fp64 product, their times in turns, and the bound at the
    3xTF32 rate. One log line per shape and one with the sums; not part of
    the result line."""
    import torch
    import torch.nn.functional as F

    from emip_tpu_torch.kernels.attention import attention
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + 23, device)
    out, sums = {}, dict(ms=0.0, sdpa_ms=0.0, bound_ms=0.0)
    for label, b, nq, nk, c, heads, windows, masked in attention_shapes(
            batch):
        ch = c // heads
        q = r(b, nq, c)
        if windows:
            k, v = r(b, nk, c), r(b, nk, c)
        else:  # kernel A reads the two halves of its [k | v] buffer
            kv = r(b, nk, 2 * c)
            k, v = kv[..., :c], kv[..., c:]
        mask = None
        if masked:
            side = 2 * int(round(nq ** 0.5))
            mask = shifted_window_mask(side, side, 2, device=device)
        got = attention(q, k, v, heads, mask, windows)
        if not torch.equal(attention(q, k, v, heads, mask, windows), got):
            raise AssertionError(f"attention ({label}): two calls differ")
        def heads_of(x):
            return x.reshape(b, -1, heads, ch).transpose(1, 2)

        bias = (None if mask is None else
                mask[torch.arange(b, device=device) % mask.shape[0]][:, None])

        def sdpa():
            return F.scaled_dot_product_attention(
                heads_of(q), heads_of(k), heads_of(v), attn_mask=bias)

        s = heads_of(q).double() @ heads_of(k).double().transpose(-1, -2)
        s = s / ch ** 0.5 + (0.0 if bias is None else bias.double())
        ref = (torch.softmax(s, -1) @ heads_of(v).double()).transpose(
            1, 2).reshape(b, nq, c)
        del s
        scale = ref.abs().max().item()
        err = (got.double() - ref).abs().max().item() / scale
        lib = sdpa().transpose(1, 2).reshape(b, nq, c)
        lib_err = (lib.double() - ref).abs().max().item() / scale
        del ref, lib
        ms, sdpa_ms = alternate_ms(
            lambda: attention(q, k, v, heads, mask, windows), sdpa, reps)
        ops = 4.0 * b * nq * nk * c
        # q and out, k and v, the mask: each read or written once
        nbytes = 4.0 * (2 * b * nq * c + 2 * b * nk * c
                        + (0 if mask is None else mask.numel()))
        bound = max(ops / (PEAK_TF32_FLOPS / 3),
                    nbytes / PEAK_BYTES_PER_S) * 1e3
        ok = err <= ATTN_REL_TOL and ms >= bound
        log(f"attention {label:32s} rel_err={err:.2e} (sdpa {lib_err:.2e}, "
            f"tol {ATTN_REL_TOL}) ms={ms:.4f} sdpa_ms={sdpa_ms:.4f} "
            f"bound_ms={bound:.4f} {ops / ms / 1e9:.1f} TFLOP/s "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"attention ({label}): rel_err={err}, "
                                 f"ms={ms} against bound {bound}")
        out[label] = dict(rel_err=err, sdpa_rel_err=lib_err, ms=ms,
                          sdpa_ms=sdpa_ms, bound_ms=bound)
        sums["ms"] += ms
        sums["sdpa_ms"] += sdpa_ms
        sums["bound_ms"] += bound
        del q, k, v, got
    log(f"attention: its {len(out)} shapes sum to ms={sums['ms']:.4f} "
        f"sdpa_ms={sums['sdpa_ms']:.4f} bound_ms={sums['bound_ms']:.4f}")
    out["sum"] = sums
    return out


# the MUFU's exponentials: 16 a clock on each of the 132 SMs at the
# H100 SXM's top clock of 1.98 GHz (a floor beside the bound, not in it)
MUFU_EXP_PER_S = 16 * 132 * 1.98e9


def attention_bf16_shapes(batch: int) -> list:
    """(label, B, N, D, windows, masked) of the bf16 attention of C, G and
    B's self layer: C's at 352^2 and 512^2 (2-wide fp32 v), G's windows of
    1024 tokens at 512^2 and 4 clips and B's of 484 tokens at 352^2, each
    with and without the shift mask."""
    return [(f"C [{2 * batch},1936,128] v=[...,2]", 2 * batch, 1936, 128,
             False, False),
            (f"C 512^2 [{2 * BATCH_512},4096,128] v=[...,2]", 2 * BATCH_512,
             4096, 128, False, False),
            (f"G [{8 * BATCH_512},1024,128] mask", 8 * BATCH_512, 1024, 128,
             True, True),
            (f"G [{8 * BATCH_512},1024,128]", 8 * BATCH_512, 1024, 128, True,
             False),
            (f"B [{8 * batch},484,128] mask", 8 * batch, 484, 128, True,
             True),
            (f"B [{8 * batch},484,128]", 8 * batch, 484, 128, True, False)]


def attention_bf16_phase(batch: int, device, reps: int) -> dict:
    """The bf16 attention of C, G and B's self layer alone
    (``kernels/attention.py:attention_bf16``, ``csrc/attention_bf16.cu``)
    at each shape of :func:`attention_bf16_shapes`: against its plain bf16
    version (BF16_KERNEL_REL) and, beside it, against the fp64 function on
    the same bf16 inputs (BF16_FP64_RATIO, BF16_FP64_FLOOR); the same bits
    twice; its event ms in turns with ``scaled_dot_product_attention`` in
    bf16 (the windows' mask as its ``attn_mask``; C's v cast to bf16), the
    device ms of both, the bound (the products at the bf16 rate, C's P v at
    the fp32 rate, the bytes once), the exponentials and their MUFU floor,
    TFLOP/s by device time, and with a mask the share of its [128, 64]
    tiles (a block's query rows by a key tile) that are all zero, which the
    kernel neither loads nor adds (``mask_zero_tiles``). One log line per
    shape; not part of the result line."""
    import torch
    import torch.nn.functional as F

    from emip_tpu_torch.kernels.attention import (
        attention_bf16,
        attention_bf16_reference,
        mask_zero_tiles,
    )
    from emip_tpu_torch.ops.window import shifted_window_mask

    bf = torch.bfloat16
    r = seeded_randn(SEED + 37, device)
    out = {}
    for label, b, n, d, windows, masked in attention_bf16_shapes(batch):
        q, k = r(b, n, d).to(bf), r(b, n, d).to(bf)
        v = r(b, n, d).to(bf) if windows else r(b, n, 2, scale=10.0)
        mask = None
        if masked:
            side = 2 * int(round(n ** 0.5))
            mask = shifted_window_mask(side, side, 2, device=device)
        with torch.no_grad():
            got = attention_bf16(q, k, v, mask)
            if not torch.equal(attention_bf16(q, k, v, mask), got):
                raise AssertionError(f"attention_bf16 ({label}): two calls "
                                     f"differ")
            want = attention_bf16_reference(q, k, v, mask)
            s = q.double() @ k.double().transpose(-1, -2) / d ** 0.5
            if mask is not None:
                s += mask[torch.arange(b, device=device)
                          % mask.shape[0]].double()
            ref64 = torch.softmax(s, -1) @ v.double()
            del s
        rel = ((got.float() - want.float()).abs().max().item()
               / want.float().abs().max().item())
        scale = ref64.abs().max().item()
        e_k = (got.double() - ref64).abs().max().item() / scale
        e_p = (want.double() - ref64).abs().max().item() / scale
        ratio = max(e_k, BF16_FP64_FLOOR) / max(e_p, BF16_FP64_FLOOR)
        del ref64, want
        nw = 1 if mask is None else mask.shape[0]
        hq, hk = q.view(b // nw, nw, n, d), k.view(b // nw, nw, n, d)
        hv = (v if windows else v.to(bf)).view(b // nw, nw, n, -1)
        bias = None if mask is None else mask.to(bf)

        def sdpa():
            return F.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias)

        ms, sdpa_ms = alternate_ms(lambda: attention_bf16(q, k, v, mask),
                                   sdpa, reps)
        dev = device_ms(lambda: attention_bf16(q, k, v, mask), reps)
        sdpa_dev = device_ms(sdpa, reps)
        zero_tiles = (None if mask is None else
                      mask_zero_tiles(mask).float().mean().item())
        products = (4.0 if windows else 2.0) * b * n * n * d
        fp32_ops = 0.0 if windows else 4.0 * b * n * n  # C's P v
        exps = float(b * n * n)
        size = float(nbytes(q, k, v, got, mask))
        bound = max(products / PEAK_BF16_FLOPS + fp32_ops / PEAK_FP32_FLOPS,
                    size / PEAK_BYTES_PER_S) * 1e3
        mufu = exps / MUFU_EXP_PER_S * 1e3
        ok = (bool(torch.isfinite(got).all()) and rel <= BF16_KERNEL_REL
              and ratio <= BF16_FP64_RATIO and dev >= bound)
        log(f"attention_bf16 {label:34s} rel={rel:.2e} (tol "
            f"{BF16_KERNEL_REL}) fp64 err kernel {e_k:.2e} plain {e_p:.2e} "
            f"ratio {ratio:.3f} (limit {BF16_FP64_RATIO}) ms={ms:.4f} "
            f"device_ms={dev:.4f} sdpa_ms={sdpa_ms:.4f} "
            f"sdpa_device_ms={sdpa_dev:.4f}"
            f"{'' if windows else ' (v cast to bf16)'} bound_ms={bound:.4f} "
            f"exps={exps:.3g} mufu_ms={mufu:.4f} "
            f"{products / dev / 1e9:.1f} TFLOP/s"
            f"{'' if zero_tiles is None else f' zero_tiles={zero_tiles:.4f}'}"
            f" {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"attention_bf16 ({label}): rel={rel}, "
                                 f"fp64 ratio={ratio}, device_ms={dev} "
                                 f"against bound {bound}")
        out[label] = dict(rel_err=rel, fp64_err=e_k, plain_fp64_err=e_p,
                          fp64_ratio=ratio, ms=ms, device_ms=dev,
                          sdpa_ms=sdpa_ms, sdpa_device_ms=sdpa_dev,
                          bound_ms=bound, exps=exps, mufu_ms=mufu,
                          zero_tiles=zero_tiles)
        del q, k, v, got
    return out


def splat_coords(batch: int, size: int, kind: str, rng):
    """[batch, size, size, 2] (x, y) targets of kernel E: the pixel grid
    plus seeded noise of 4 px ("noise", as the occlusion mask builds its
    input from a flow), a coherent field ("coherent"), or targets uniform
    over the image and a 4 px margin ("uniform")."""
    import torch

    from emip_tpu_torch.ops.geometry import coords_grid

    grid = coords_grid(size, size)[None]
    if kind == "noise":
        return grid + torch.from_numpy(
            (rng.standard_normal((batch, size, size, 2)) * 4).astype(
                np.float32))
    if kind == "uniform":
        return torch.from_numpy(rng.uniform(
            -4.0, size + 4.0, (batch, size, size, 2)).astype(np.float32))
    c, th = (size - 1) / 2, np.deg2rad(2.0)
    gx, gy = grid[..., 0] - c, grid[..., 1] - c
    x = c + np.cos(th) * gx - np.sin(th) * gy + 2.5
    y = c + np.sin(th) * gx + np.cos(th) * gy - 1.25
    return torch.stack((x, y), -1).expand(batch, -1, -1, -1).contiguous()


def splat_cases(results: dict, device, reps: int) -> None:
    """Kernel E against its plain scatter_add_ version at ``SPLAT_CASES``:
    density max_abs_err, the fraction of occlusion bits (density clipped to
    [0, 1] < 0.2) that flip, the same bits on a second call, a grad_fn on
    the output when coords requires a grad, and the gradient against
    autograd of the plain version (max|err| / max|plain|). Every case is
    logged and recorded before a failure of any is raised."""
    import torch

    from emip_tpu_torch import kernels as K

    occ = lambda d: torch.clamp(d, 0.0, 1.0) < 0.2  # noqa: E731
    failed = []
    for i, (batch, size, kind, summed) in enumerate(SPLAT_CASES):
        # the summed case keeps the inputs it has always had
        rng = np.random.default_rng(SEED + 4 if i == 0 else SEED + 17 + i)
        coords = splat_coords(batch, size, kind, rng).to(device)
        got = K.splat_density(coords)
        want = K.splat_density_reference(coords)
        same = torch.equal(K.splat_density(coords), got)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        flips = (occ(got) != occ(want)).float().mean().item()
        leaf = coords.clone().requires_grad_(True)
        out = K.splat_density(leaf)
        has_fn = out.grad_fn is not None
        cot = torch.randn(out.shape, device=device, generator=torch.Generator(
            device=device).manual_seed(SEED + 5))
        g_k = torch.autograd.grad(out, leaf, cot)[0] if has_fn else None
        g_p = torch.autograd.grad(K.splat_density_reference(leaf), leaf,
                                  cot)[0]
        rel = (float("inf") if g_k is None else
               (g_k - g_p).abs().max().item()
               / max(g_p.abs().max().item(), 1e-30))
        del leaf, out, g_k, g_p
        ms, plain_ms = alternate_ms(lambda: K.splat_density(coords),
                                    lambda: K.splat_density_reference(coords),
                                    reps)
        dev = device_times("splat_density", lambda: K.splat_density(coords),
                           lambda: K.splat_density_reference(coords), reps)
        ok = (bool(torch.isfinite(got).all()) and err <= SPLAT_ATOL
              and flips <= SPLAT_FLIP_MAX and same and has_fn
              and rel <= BWD_REL_TOL)
        label = f"coords [{batch},{size},{size},2] {kind}"
        log(f"kernel {'splat_density':28s} {label:44s} max_abs_err={err:.3e} "
            f"(atol {SPLAT_ATOL}) mask flips={flips:.3e} (limit "
            f"{SPLAT_FLIP_MAX}) second call {'same' if same else 'DIFFERS'} "
            f"grad_fn={has_fn} grad max_rel={rel:.3e} (tol {BWD_REL_TOL}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            + fmt_dev(dev)
            + ("ok" if ok else "MISMATCH"))
        if not ok:
            failed.append(label)
        record(results, "splat_density", label, err, ms, plain_ms,
               forward_work("splat_density", (coords,), got), summed=summed,
               mask_flips=flips, bit_equal=same, grad_max_rel=rel, **dev)
        del coords, got, want
    if failed:
        raise AssertionError(f"splat_density disagrees with its plain "
                             f"version, differs on a second call or has no "
                             f"gradient at: {failed}")


# --------------------------------------------------------------- slice


def seg_encoder(model):
    """(the segmentation encoder of ``model``, its PVTv2 configuration or
    None for the encoders without kernel A)."""
    feat = model.backbone.feat_net
    encoder = getattr(feat, feat.key)
    return encoder, encoder.config if feat.key == "pvtv2_en" else None


def pvt_kernels(pvt, blocks_fwd: int, blocks_bwd: int) -> dict:
    """Launches of A and J for a PVTv2 (configuration ``pvt``, None for
    another encoder) whose blocks run ``blocks_fwd`` times forward and
    ``blocks_bwd`` times backward: J's forward under ``fused_ffn`` outside
    the linear variant (the JAX package's gate), its backward under either
    switch."""
    if pvt is None:
        return {}
    fwd_j = pvt.fused_ffn == "always" and not pvt.linear
    bwd_j = fwd_j or pvt.ffn_dwconv == "bwd_fused"
    return dict(sr_attention=blocks_fwd, sr_attention_bwd=blocks_bwd,
                dwconv_gelu=blocks_fwd if fwd_j else 0,
                dwconv_gelu_bwd=blocks_bwd if bwd_j else 0)


def expected_launches(model, train: bool = False) -> dict:
    """Kernel launches per forward (``train``: per train step) implied by
    the model's structure and its configuration's kernel switches."""
    from emip_tpu_torch import kernels as K

    _, pvt = seg_encoder(model)
    depths = pvt.depths if pvt is not None else (0, 0, 0, 0)
    gm = model.GMFlow.config
    layers = len(model.GMFlow.transformer.layers)
    tok = (model.config.inp_size // 8 // gm.attn_splits_list[0]) ** 2
    whole_block = tok <= gm.fused_block_max_t
    directions = 2 if gm.pred_bidir_flow else 1
    n = {k: 0 for k in K.LAUNCHES}
    # every PVT block, both frames
    n.update(pvt_kernels(pvt, 2 * sum(depths), 0))
    n.update(window_attention_block=layers if whole_block else 0,
             window_attention_layer=0 if whole_block else layers,
             window_attention_ffn_layer=0 if whole_block else layers,
             # matching per direction (kernel C, or I on the stored
             # correlation) and one propagation
             flow_attention=1 + (directions if gm.global_match_qk_fused
                                 else 0),
             softmax_expectation=(0 if gm.global_match_qk_fused
                                  else directions),
             convex_upsample=1)
    if train:
        # backward: every block of frame 1; of frame 2 only the stages up
        # to /8, whose output feeds the camouflage feeder (its /16 and /32
        # features do not reach the loss)
        n.update(pvt_kernels(pvt, 2 * sum(depths),
                             sum(depths) + depths[0] + depths[1]))
        n.update(convex_upsample_bwd=1,
                 splat_density=2,  # occlusion masks of both directions
                 **{k + "_bwd": n[k] for k in (
                     "window_attention_block", "window_attention_layer",
                     "window_attention_ffn_layer", "flow_attention",
                     "softmax_expectation")})
    return n


def seeded_frames(rng, n: int, size: int) -> np.ndarray:
    from emip_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

    img = rng.uniform(0.0, 1.0, (n, 3, size, size)).astype(np.float32)
    mean = np.asarray(IMAGENET_MEAN, np.float32)[:, None, None]
    std = np.asarray(IMAGENET_STD, np.float32)[:, None, None]
    return (img - mean) / std


def slice_phase(model, batch: int, size: int, device, timed: int,
                label: str = "b5") -> dict:
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.infer import predict_arrays

    rng = np.random.default_rng(SEED + 1)
    n_batches = 1 + timed  # one warm-up batch, then the timed ones
    frames = [(torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
               torch.from_numpy(seeded_frames(rng, batch, size)).to(device))
              for _ in range(n_batches)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)

    K.reset_launches()
    times, outputs = [], []
    for i, (a, b) in enumerate(frames):
        (mask, flow), ms = timed_call(lambda: predict_arrays(model, a, b))
        if i > 0:
            times.append(ms)
        outputs.append((mask, flow))
    launches = dict(K.LAUNCHES)

    per_fwd = expected_launches(model)
    want = {k: v * n_batches for k, v in per_fwd.items()}
    log(f"slice {label} launches {launches} (expected {want})")
    # A runs in every PVTv2; B, C and D in every two-stream model
    if launches != want or min(launches[k] for k in FWD_KERNELS[1:]) == 0:
        raise AssertionError(f"kernel launch counts {launches} != {want}")
    for mask, flow in outputs:
        if tuple(mask.shape) != (batch, 1, size, size):
            raise AssertionError(f"mask shape {tuple(mask.shape)}")
        if tuple(flow.shape) != (batch, 2, size, size):
            raise AssertionError(f"flow shape {tuple(flow.shape)}")
        if not (torch.isfinite(mask).all() and torch.isfinite(flow).all()):
            raise AssertionError("non-finite outputs")
    median_ms = statistics.median(times)
    fps = batch / (median_ms / 1e3)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"slice {label} {size}^2 bs={batch} fp32: median {median_ms:.3f} "
        f"ms/batch "
        f"over {len(times)} batches -> {fps:.3f} frames/s; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB above "
        f"what was allocated before the run)")

    # the same weights on the CPU, through the plain versions, one pair
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    a, b = frames[0]
    ref_mask, ref_flow = predict_arrays(cpu_model, a[:1].cpu(), b[:1].cpu())
    cmp = {}
    for name, got, ref in (("mask", outputs[0][0][:1], ref_mask),
                           ("flow_fw", outputs[0][1][:1], ref_flow)):
        got = got.cpu()
        diff = (got - ref).abs()
        tol = SLICE_TOL[name]
        # worst |err| / (atol + rtol |ref|): the comparison passes at <= 1
        worst = (diff / (tol["atol"] + tol["rtol"] * ref.abs())).max().item()
        err, ref_max = diff.max().item(), ref.abs().max().item()
        rel = err / ref_max if ref_max > 0 else float("inf")
        ok = torch.allclose(got, ref, **tol) and rel <= SLICE_REL_MAX
        cmp[name] = dict(max_abs_err=err, ref_max_abs=ref_max,
                         worst_tol_ratio=worst, rel_to_max=rel, tol=tol,
                         rel_max=SLICE_REL_MAX, ok=ok)
        log(f"slice {label} {name} card vs CPU plain: max_abs_err={err:.3e} "
            f"(|ref| max {ref_max:.3e}) tol={tol} worst err/tol={worst:.3f}; "
            f"max|err|/max|ref|={rel:.3e} (limit {SLICE_REL_MAX}) "
            f"{'ok' if ok else 'MISMATCH'}")
    log(f"CPU reference pair took {time.perf_counter() - t0:.1f} s")
    bad = [k for k, v in cmp.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"card disagrees with the CPU reference: {bad}")
    return dict(launches=launches, expected=want, median_ms=median_ms,
                batch_ms=times, frames_per_s=fps, peak_bytes=peak,
                working_bytes=peak - resident, compare=cmp)


# ----------------------------------------------------------- bf16 band


def gmflow_scales_phase(device, timed: int) -> dict:
    """The port's GMFlow alone at GMFLOW_SCALES on seeded features at
    352^2's two scales ([8, 128, 44, 44] and [8, 128, 88, 88] a frame),
    fp32 then bf16 (bf16 features, the same fp32 weights): launches a call
    (B 12, C 3, D 1, or their bf16 names, nothing else), ms a call (CUDA
    events), device busy a call (torch.profiler), peak memory; the shapes
    and finiteness of every output; then one pair against the CPU's plain
    versions on the same weights. fp32: each flow of the training lists
    and the correlation volume by GMFLOW_SCALES_TOL and max|err|/max|ref|
    <= SLICE_REL_MAX, or, where fp32 rounding alone moves an output further,
    within twice what it moves on the CPU: the CPU runs again on inputs
    nudged by GMFLOW_SCALES_NUDGE (relative, seeded), and on seeded noise
    features the fine scale's flows move by about 1e-3 of max|ref| so (the
    coarse flow warps feature1, whose values change a whole unit from one
    pixel to the next, so a flow error of 1e-3 pixel becomes a feature error
    of 1e-3). bf16: within twice the larger of the card's and the CPU's
    bf16-vs-fp32 gaps on each output (:func:`_gap_check`)."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.dtypes import set_compute_dtype
    from emip_tpu_torch.models.gmflow import GMFlow, GMFlowConfig
    from emip_tpu_torch.models.init import seeded_init_

    model = GMFlow(GMFlowConfig(**GMFLOW_SCALES))
    seeded_init_(model, SEED)
    model = model.to(device).eval()
    model16 = copy.deepcopy(model)
    set_compute_dtype(model16, torch.bfloat16)
    r = seeded_randn(SEED + 61, device)
    c, side = GMFLOW_SCALES["feature_channels"], SIZE // 8
    feats = [[r(BATCH, c, side * 2**s, side * 2**s) for s in range(2)]
             for _ in range(2)]
    layers = GMFLOW_SCALES["num_transformer_layers"]

    def outputs(got) -> dict:
        fws, bws, corr = got
        out = {f"flow_fw{i}": f for i, f in enumerate(fws)}
        out.update({f"flow_bw{i}": f for i, f in enumerate(bws)})
        out["corr"] = corr
        return out

    res, card, cpu = {}, {}, {}
    for band, net, dt in (("fp32", model, torch.float32),
                          ("bf16", model16, torch.bfloat16)):
        f0, f1 = ([f.to(dt) for f in fs] for fs in feats)
        tag = "_bf16" if dt == torch.bfloat16 else ""

        def call(train=False, net=net, f0=f0, f1=f1):
            with torch.no_grad():
                return net(f0, f1, training=train)

        call()
        torch.cuda.synchronize()
        K.reset_launches()
        got = outputs(call(True))
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        want = {"window_attention_block" + tag: 2 * layers,
                "flow_attention" + tag: 3, "convex_upsample" + tag: 1}
        log(f"gmflow scales {band} launches a call {launches} (expected "
            f"{want})")
        if launches != want:
            raise AssertionError(f"gmflow scales {band}: launches "
                                 f"{launches} != {want}")
        # the training lists: each scale's flow before and (but the last)
        # after propagation, upsampled to the frame, then the final one
        shapes = {f"flow_{d}{i}": (BATCH, 2, SIZE, SIZE)
                  for d in ("fw", "bw") for i in range(4)}
        shapes["corr"] = (BATCH, side, side, side * side)
        for name, shape in shapes.items():
            if tuple(got[name].shape) != shape:
                raise AssertionError(f"gmflow scales {band} {name}: shape "
                                     f"{tuple(got[name].shape)} != {shape}")
        if not all(bool(torch.isfinite(t).all()) for t in got.values()):
            raise AssertionError(f"gmflow scales {band}: non-finite outputs")
        ms = cuda_ms(call, timed)
        busy = device_ms(call, timed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        log(f"gmflow scales {band} bs={BATCH} {side}^2+{2 * side}^2 "
            f"features: "
            f"{ms:.3f} ms a call (CUDA events, {timed} calls), device busy "
            f"{busy:.3f} ms a call ({busy / ms:.3f} of it), peak memory "
            f"{peak / 2**30:.3f} GiB ({(peak - resident) / 2**30:.3f} GiB "
            f"above what was allocated before the call)")
        res[band] = dict(launches=launches, ms=ms, device_busy_ms=busy,
                         peak_gib=peak / 2**30,
                         call_gib=(peak - resident) / 2**30)
        card[band] = {k: v[:1] for k, v in got.items()}
        # the same weights and the first pair on the CPU, plain versions
        cpu_net = copy.deepcopy(net).cpu()
        with torch.no_grad():
            cpu[band] = outputs(cpu_net([f[:1].cpu() for f in f0],
                                        [f[:1].cpu() for f in f1],
                                        training=True))
        del cpu_net, got
    # fp32: the CPU once more on nudged inputs
    gen = torch.Generator().manual_seed(SEED + 62)
    nudged = [[(f[:1].cpu() * (1 + GMFLOW_SCALES_NUDGE * torch.randn(
        f[:1].shape, generator=gen))) for f in fs] for fs in feats]
    with torch.no_grad():
        moved = outputs(copy.deepcopy(model).cpu()(*nudged, training=True))
    cmp, bad = {}, []
    for name, ref in cpu["fp32"].items():
        g = card["fp32"][name].cpu()
        err, ref_max = (g - ref).abs().max().item(), ref.abs().max().item()
        nudge = (moved[name] - ref).abs().max().item()
        ok_tol = (torch.allclose(g, ref, **GMFLOW_SCALES_TOL)
                  and err <= SLICE_REL_MAX * ref_max)
        ok = bool(torch.isfinite(g).all()) and (ok_tol or err <= 2 * nudge)
        cmp[name] = dict(max_abs_err=err, ref_max_abs=ref_max,
                         rel_to_max=err / ref_max, nudge_abs=nudge,
                         within_tol=ok_tol, ok=ok)
        log(f"gmflow scales fp32 {name} card vs CPU plain: max_abs_err="
            f"{err:.3e} (|ref| max {ref_max:.3e}, max|err|/max|ref| "
            f"{err / ref_max:.3e}); tol {GMFLOW_SCALES_TOL} and "
            f"{SLICE_REL_MAX} of max|ref|: {'met' if ok_tol else 'missed'}; "
            f"the CPU's own move under a {GMFLOW_SCALES_NUDGE:g} nudge "
            f"{nudge:.3e} (limit twice it) " + ("ok" if ok else "MISMATCH"))
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"gmflow scales fp32: card disagrees with the "
                             f"CPU reference: {bad}")
    res["fp32_vs_cpu"] = cmp
    cmp, bad = _gap_check("gmflow scales bf16", card["bf16"], cpu["bf16"],
                          card["fp32"], cpu["fp32"])
    for name, v in cmp.items():
        log(f"gmflow scales bf16 {name} card vs CPU plain: |err| max "
            f"{v['err']:.3e}, bf16-vs-fp32 gap card {v['card_gap']:.3e} CPU "
            f"{v['cpu_gap']:.3e}, ratio {v['ratio']:.3f} (limit 2) "
            + ("ok" if v["ok"] else "MISMATCH"))
    if bad:
        raise AssertionError(f"gmflow scales bf16: card disagrees with the "
                             f"CPU beyond the band: {bad}")
    res["bf16_vs_cpu"] = cmp
    del model, model16
    torch.cuda.empty_cache()
    return res


def nbytes(*tensors) -> int:
    """Bytes of the tensors among the arguments at their storage sizes
    (dicts are searched)."""
    import torch

    n = 0
    for t in tensors:
        if isinstance(t, dict):
            n += nbytes(*t.values())
        elif torch.is_tensor(t):
            n += t.numel() * t.element_size()
    return n


def bf16_kernel_cases(batch: int, device):
    """(kernel, label, kernel fn, plain fn, args) of the bf16 forwards of
    A-D at the 352^2 shapes of bf16 inference: A at the four PVT stages
    (bf16 tokens and weights, fp32 biases), B on [2B, 4, 484, 128] bf16
    windows without and with the shift mask (fp32 parameters), C on bf16 q,
    k [2B, 1936, 128] with fp32 values, D on bf16 logits; then F, G and H
    at the bf16 long model's and 512^2's shapes."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + 31, device)
    bf = torch.bfloat16
    cases = []
    for n, m, c, heads in SR_STAGES:
        x, kv, wq, bq, wkv, bkv, wp, bp, _ = sr_args(r, batch, n, m, c, heads)
        cases.append(("sr_attention_bf16", f"N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      (x.to(bf), kv.to(bf), wq.to(bf), bq, wkv.to(bf), bkv,
                       wp.to(bf), bp, heads)))
    c, tok, k2 = 128, 484, 4
    x, t = r(2 * batch, k2, tok, c).to(bf), r(2 * batch, k2, tok, c).to(bf)
    sp, cp = window_params(r, c)
    mask = shifted_window_mask(44, 44, 2, device=device)
    for label, msk in (("unshifted", None), ("shifted mask", mask)):
        cases.append(("window_attention_block_bf16",
                      f"[{2 * batch},{k2},{tok},{c}] {label}",
                      K.fused_window_attention_block,
                      K.fused_window_attention_block_reference,
                      (x, t, sp, cp, msk)))
    L = 1936
    cases.append(("flow_attention_bf16", f"[{2 * batch},{L},128] v=[...,2]",
                  K.fused_flow_attention, K.fused_flow_attention_reference,
                  (r(2 * batch, L, 128).to(bf), r(2 * batch, L, 128).to(bf),
                   r(2 * batch, L, 2, scale=10.0))))
    cases.append(("convex_upsample_bf16", f"flow [{2 * batch},44,44,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(2 * batch, 44, 44, 2, scale=3.0),
                   r(2 * batch, 44, 44, 576).to(bf), 8)))
    # the bf16 long model: F on bf16 q against the fp32 ring (1 and 4
    # clips, every slot written; the 512^2 shape); G and H on bf16 windows
    # of 1024 tokens (512^2, 1 and 4 clips with both flow directions on the
    # batch axis, with the shift mask, once without)
    for label, (q, k, v, bias) in memory_cases(
            r, ((1, 1936, 5, 5), (4, 1936, 5, 5), (1, 4096, 5, 5))):
        cases.append(("memory_attention_bf16", label,
                      K.masked_memory_attention,
                      K.masked_memory_attention_reference,
                      (q.to(bf), k, v, bias)))
    c, tok, k2 = 128, 1024, 4
    mask = shifted_window_mask(64, 64, 2, device=device)
    for b2, msk in ((2, None), (2, mask), (2 * BATCH_512, mask)):
        x, t = r(b2, k2, tok, c).to(bf), r(b2, k2, tok, c).to(bf)
        sp, cp = window_params(r, c)
        shape = (f"[{b2},{k2},{tok},{c}] "
                 + ("unshifted" if msk is None else "shifted mask"))
        cases.append(("window_attention_layer_bf16", shape + " + x",
                      K.fused_window_attention_layer,
                      K.fused_window_attention_layer_reference,
                      (x, t, sp, msk, True)))
        cases.append(("window_attention_ffn_layer_bf16", shape,
                      K.fused_window_attention_ffn_layer,
                      K.fused_window_attention_ffn_layer_reference,
                      (x, t, cp, msk)))
    # J on bf16 u and taps (fp32 bias) at the four MixFFN stages
    for side, f in FFN_STAGES:
        cases.append(("dwconv_gelu_bf16", f"[{batch},{side}x{side},{f}]",
                      K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
                      ffn_args_bf16(r, batch, side, side, f)))
    return cases


def ffn_args_bf16(r, b: int, h: int, w: int, f: int) -> tuple:
    """Kernel J's bf16 arguments: u and taps bf16 (the model casts its
    taps), the bias fp32."""
    import torch

    u, taps, bias, h, w = ffn_args(r, b, h, w, f)
    return (u.to(torch.bfloat16), taps.to(torch.bfloat16), bias, h, w)


def bf16_check_cases(device):
    """bf16 cases held and timed like bf16_kernel_cases' but kept out of
    their rows' sums, from a generator of their own: A, C and D at their
    512^2 shapes (4 clips), F with every slot empty (the plain mean of the
    values) at a ragged size, G without the residual, J's checks, A at
    pvt_v2_b0's head width (its stage 3 at 352^2, batch 8), and B and H at
    b0's GMFlow width (352^2 and 512^2 windows, masked)."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + 35, device)
    bf = torch.bfloat16
    cases = []
    for n, m, c, heads in SR_STAGES_512:
        x, kv, wq, bq, wkv, bkv, wp, bp, _ = sr_args(r, BATCH_512, n, m, c,
                                                     heads)
        cases.append(("sr_attention_bf16",
                      f"512^2 N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention, K.fused_sr_attention_reference,
                      (x.to(bf), kv.to(bf), wq.to(bf), bq, wkv.to(bf), bkv,
                       wp.to(bf), bp, heads)))
    L, b = 4096, 2 * BATCH_512
    cases.append(("flow_attention_bf16", f"512^2 [{b},{L},128] v=[...,2]",
                  K.fused_flow_attention, K.fused_flow_attention_reference,
                  (r(b, L, 128).to(bf), r(b, L, 128).to(bf),
                   r(b, L, 2, scale=10.0))))
    cases.append(("convex_upsample_bf16", f"512^2 flow [{b},64,64,2] x8",
                  K.convex_upsample, K.convex_upsample_reference,
                  (r(b, 64, 64, 2, scale=3.0), r(b, 64, 64, 576).to(bf), 8)))
    for label, (q, k, v, bias) in memory_cases(r, ((2, 100, 3, 0),)):
        cases.append(("memory_attention_bf16", label + " ragged",
                      K.masked_memory_attention,
                      K.masked_memory_attention_reference,
                      (q.to(bf), k, v, bias)))
    x, t = r(2, 4, 1024, 128).to(bf), r(2, 4, 1024, 128).to(bf)
    sp, _ = window_params(r, 128)
    cases.append(("window_attention_layer_bf16",
                  "[2,4,1024,128] shifted mask message",
                  K.fused_window_attention_layer,
                  K.fused_window_attention_layer_reference,
                  (x, t, sp, shifted_window_mask(64, 64, 2, device=device),
                   False)))
    for b, h, w, f in FFN_CHECKS:
        cases.append(("dwconv_gelu_bf16", f"[{b},{h}x{w},{f}] check",
                      K.fused_dwconv_gelu, K.fused_dwconv_gelu_reference,
                      ffn_args_bf16(r, b, h, w, f)))
    # A at b0's head width (32), drawn last so that the cases above keep
    # their inputs
    n, m, c, heads = SR_B0_CHECK
    x, kv, wq, bq, wkv, bkv, wp, bp, _ = sr_args(r, BATCH, n, m, c, heads)
    cases.append(("sr_attention_bf16", f"b0 N={n} M={m} C={c} heads={heads}",
                  K.fused_sr_attention, K.fused_sr_attention_reference,
                  (x.to(bf), kv.to(bf), wq.to(bf), bq, wkv.to(bf), bkv,
                   wp.to(bf), bp, heads)))
    # B and H at b0's GMFlow width (C 64, F 512: the wgmma product's 64-column
    # tiles), drawn after A's so that the cases above keep their inputs
    c, f = 64, 512
    x, t = r(BATCH, 4, 484, c).to(bf), r(BATCH, 4, 484, c).to(bf)
    sp, cp = window_params(r, c, f)
    cases.append(("window_attention_block_bf16",
                  f"b0 [{BATCH},4,484,{c}] shifted mask",
                  K.fused_window_attention_block,
                  K.fused_window_attention_block_reference,
                  (x, t, sp, cp,
                   shifted_window_mask(44, 44, 2, device=device))))
    x, t = r(2, 4, 1024, c).to(bf), r(2, 4, 1024, c).to(bf)
    _, cp = window_params(r, c, f)
    cases.append(("window_attention_ffn_layer_bf16",
                  f"b0 [2,4,1024,{c}] shifted mask",
                  K.fused_window_attention_ffn_layer,
                  K.fused_window_attention_ffn_layer_reference,
                  (x, t, cp, shifted_window_mask(64, 64, 2, device=device))))
    return (cases + scales_cases(device, bf16=True)
            + linear_sr_cases(device, SEED + 37, bf16=True))


def bf16_fp64(name: str, args):
    """The function of a bf16 case evaluated in fp64 on the same
    bf16-rounded inputs and weights (B's self-layer weights rounded as the
    kernel rounds them, its cross layer's fp32 ones as they are), with no
    rounding after the inputs."""
    import torch

    from emip_tpu_torch import kernels as K

    def d(a):
        return a.double() if torch.is_tensor(a) else a

    def rounded(p):  # the weights the bf16 self layer casts to bf16
        return {k: (v.to(torch.bfloat16) if k in ("wq", "wk", "wv", "wm")
                    else v).double() for k, v in p.items()}

    if name == "window_attention_block_bf16":
        x, t, sp, cp, mask = args
        return K.fused_window_attention_block_reference(
            d(x), d(t), rounded(sp), {k: d(v) for k, v in cp.items()},
            d(mask))
    if name == "window_attention_layer_bf16":
        x, t, sp, mask, add_residual = args
        return K.fused_window_attention_layer_reference(
            d(x), d(t), rounded(sp), d(mask), add_residual)
    if name == "window_attention_ffn_layer_bf16":
        x, t, cp, mask = args
        return K.fused_window_attention_ffn_layer_reference(
            d(x), d(t), {k: d(v) for k, v in cp.items()}, d(mask))
    if name == "memory_attention_bf16":
        # an empty slot's key scores -1e9 exactly, as in fp32, where the
        # bias absorbs the score (a ring with no slot written reads the
        # plain mean of the values); fp64 would keep the score beside it
        q, k, v, bias = (d(a) for a in args)
        scores = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
        scores = torch.where(bias[:, None, :] < 0, bias[:, None, :], scores)
        return torch.softmax(scores, dim=-1) @ v
    fn = {"sr_attention_bf16": K.fused_sr_attention_reference,
          "flow_attention_bf16": K.fused_flow_attention_reference,
          "convex_upsample_bf16": K.convex_upsample_reference,
          "dwconv_gelu_bf16": K.fused_dwconv_gelu_reference}[name]
    return fn(*(d(a) for a in args))


def _cross_ffn_x2(rows: int, c: int, f: int) -> float:
    """Operations of H's layer on bf16 x and t (B's cross layer and FFN on
    its bf16 x1) whose products have one bf16 operand: x Wq, t Wk, t Wv
    and x's half of the FFN's first product."""
    return 3 * 2.0 * rows * c * c + 2.0 * rows * f * c


def bf16_work(name: str, args, out) -> tuple:
    """(3xTF32 operations, CUDA-core operations, bytes at their storage
    sizes, operations of products of two bf16 operands, of one, of one
    against three bf16 parts of an fp32 one) of one bf16 forward call."""
    size = float(nbytes(*args) + nbytes(out))
    if name == "sr_attention_bf16":
        return 0.0, 0.0, size, forward_products("sr_attention", args), 0.0
    if name == "window_attention_block_bf16":
        rows, tok, c, f, _ = _window_dims("window_attention_block", args)
        layer = 4 * 2 * rows * c * c + 4 * rows * tok * c
        x2 = _cross_ffn_x2(rows, c, f)
        return (layer + 2.0 * rows * f * 3 * c - x2, 0.0, size,
                float(layer), x2)
    if name == "flow_attention_bf16":
        b, l, c = args[0].shape
        return 0.0, float(4 * b * l * l), size, float(2 * b * l * l * c), 0.0
    if name == "memory_attention_bf16":
        # q k^T and P v, each a bf16 side against the ring's three parts
        return (0.0, 0.0, size, 0.0, 0.0,
                forward_work("memory_attention", args, out)[0])
    if name == "window_attention_layer_bf16":
        return (0.0, 0.0, size,
                float(forward_products("window_attention_layer", args)), 0.0)
    if name == "window_attention_ffn_layer_bf16":
        rows, _, c, f, _ = _window_dims("window_attention_ffn_layer", args)
        x2 = _cross_ffn_x2(rows, c, f)
        return (forward_products("window_attention_ffn_layer", args) - x2,
                0.0, size, 0.0, x2)
    if name == "dwconv_gelu_bf16":
        return 0.0, forward_work("dwconv_gelu", args, out)[1], size, 0.0, 0.0
    return (0.0, float(out.numel() // 2 * (9 * 4 + 9 * 2 * 2)), size, 0.0,
            0.0)


def dwconv_library(args):
    """J's function as the library computes it in u's dtype (bf16 or fp32):
    cuDNN's depthwise convolution on the channels-last tokens (a view, no
    copy) with the bias in that dtype, then ``F.gelu``; a yardstick only."""
    import torch.nn.functional as F

    u, taps, bias, h, w = args
    b, _, f = u.shape
    x = u.view(b, h, w, f).permute(0, 3, 1, 2)
    weight = taps.permute(2, 0, 1)[:, None]
    return F.gelu(F.conv2d(x, weight, bias.to(u.dtype), padding=1,
                           groups=f))


def bf16_library_ms(name: str, args, reps: int) -> tuple:
    """(library_ms, sdpa_ms): ``scaled_dot_product_attention`` in bf16 on
    C's inputs (its values cast to bf16) computes C's function; for A and B
    it computes only their attention (sdpa_ms, on bf16 tensors of the
    shapes of their q, k, v), and no one call computes the rest. A
    yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    try:
        if name == "flow_attention_bf16":
            q, k, v = args
            v = v.to(torch.bfloat16)
            return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                           reps), None
        if name == "sr_attention_bf16":
            x, kv, heads = args[0], args[1], args[-1]
            (b, n, c), m = x.shape, kv.shape[1]
            q = x.reshape(b, n, heads, c // heads).transpose(1, 2)
            k = kv.reshape(b, m, heads, c // heads).transpose(1, 2)
            return None, cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, k), reps)
        if name == "memory_attention_bf16":
            q, k, v, bias = args
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            mask = bias[:, None, :].to(torch.bfloat16)
            return cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), reps), None
        if name == "dwconv_gelu_bf16":
            return cuda_ms(lambda: dwconv_library(args), reps), None
        if name in ("window_attention_block_bf16",
                    "window_attention_layer_bf16",
                    "window_attention_ffn_layer_bf16"):
            x = args[0]
            mask = args[4] if name == "window_attention_block_bf16" else args[3]
            attn_mask = None if mask is None else mask.to(x.dtype)
            return None, cuda_ms(lambda: F.scaled_dot_product_attention(
                x, x, x, attn_mask=attn_mask), reps)
    except RuntimeError as e:  # no backend takes these shapes
        log(f"library call for {name} refused: {str(e).splitlines()[0]}")
    return None, None


def bf16_kernel_phase(batch: int, device, reps: int, only: str = "") -> dict:
    """The bf16 forwards of A-D against their plain bf16 versions on the
    card and against fp64 (see BF16_FP64_RATIO), held bit-equal on a second
    call, timed beside the plain version and the library, with their bound
    (each product at the rate its operands allow: see PEAK_BF16_FLOPS;
    bytes at their storage sizes); the digests of the ``DIGEST_KERNELS``
    rows. ``only``: the rows whose name contains one of its comma-separated
    names (every row when empty)."""
    import torch

    results = {}
    cases = [(True, *case) for case in bf16_kernel_cases(batch, device)]
    cases += [(False, *case) for case in bf16_check_cases(device)]
    with torch.no_grad():
        for summed, name, label, fn, ref, args in cases:
            if not wanted(only, name):
                continue
            got = fn(*args)
            torch.cuda.synchronize()
            want = ref(*args)
            ref64 = bf16_fp64(name, args)
            if got.dtype != want.dtype:
                raise AssertionError(f"{name}: {got.dtype} != {want.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            scale = ref64.abs().max().item()
            e_k = (got.double() - ref64).abs().max().item() / scale
            e_p = (want.double() - ref64).abs().max().item() / scale
            ratio = max(e_k, BF16_FP64_FLOOR) / max(e_p, BF16_FP64_FLOOR)
            del ref64
            if not torch.equal(fn(*args), got):
                raise AssertionError(f"{name} ({label}): two calls on the "
                                     f"same inputs differ")
            dig = record_digest(name, label, (got,), lambda: fn(*args))
            ms, plain_ms = alternate_ms(lambda: fn(*args),
                                        lambda: ref(*args), reps)
            lib_ms, sdpa_ms = bf16_library_ms(name, args, reps)
            dev = device_times(name, lambda: fn(*args), lambda: ref(*args),
                               reps, label)
            ok = (bool(torch.isfinite(got).all()) and rel <= BF16_KERNEL_REL
                  and ratio <= BF16_FP64_RATIO)
            log(f"kernel {name:28s} {label:28s} max_abs_err={err:.3e} "
                f"rel={rel:.2e} (tol {BF16_KERNEL_REL}) fp64 err kernel "
                f"{e_k:.2e} plain {e_p:.2e} ratio {ratio:.3f} (limit "
                f"{BF16_FP64_RATIO}, floor {BF16_FP64_FLOOR}) ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={fmt_ms(lib_ms)} "
                f"sdpa_ms={fmt_ms(sdpa_ms)} " + fmt_dev(dev)
                + (f"launches/call={dig['launches_per_call']:g} " if dig
                   else "")
                + ("ok" if ok else "MISMATCH"))
            if not ok:
                raise AssertionError(f"{name} ({label}): rel={rel}, fp64 "
                                     f"ratio={ratio}")
            record(results, name, label, err, ms, plain_ms,
                   bf16_work(name, args, got), lib_ms, summed=summed,
                   rel_err=rel, fp64_err=e_k, plain_fp64_err=e_p,
                   fp64_ratio=ratio,
                   **({} if sdpa_ms is None else dict(sdpa_ms=sdpa_ms)),
                   **dev, **dig)
            del got, want
    for entry in results.values():
        entry["fp64_ratio"] = max(c["fp64_ratio"] for c in entry["cases"])
        sdpa = [c["sdpa_ms"] for c in entry["cases"]
                if "sdpa_ms" in c and c.get("summed", True)]
        if sdpa:
            entry["sdpa_ms"] = sum(sdpa)
    device_sums(results)
    return results


def bf16_gemm_phase(batch: int, device, reps: int) -> dict:
    """The bf16 GEMM alone at each ``x W^T`` shape bf16 inference gives it
    (A's projections) and a ragged check:
    against the plain bf16 version, against fp64 (BF16_FP64_RATIO), bit
    equality, its time beside the plain version and ``torch.matmul`` in
    bf16 (reduced-precision reduction off), and its bound at the bf16
    peak. One log line per shape; not part of the result line."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.kernels.gemm import gemm, gemm_reference

    r = seeded_randn(SEED + 33, device)
    bf = torch.bfloat16
    shapes = [s for s in gemm_shapes(batch)
              if s[4] == "x W^T" and s[0].startswith("A ")]
    shapes.append(("check ragged", 1000, 88, 70, "x W^T"))
    out = {}
    with torch.no_grad():
        for label, m, k, n, _ in shapes:
            a = r(m, k).to(bf)
            b = r(n, k, scale=k**-0.5).to(bf).t()
            bias = r(n, scale=0.1)
            before = K.LAUNCHES["gemm_bf16"]
            got = gemm(a, b, bias)
            want = gemm_reference(a, b, bias)
            ref64 = a.double() @ b.double() + bias.double()
            scale = ref64.abs().max().item()
            rel = ((got.float() - want.float()).abs().max().item()
                   / want.float().abs().max().item())
            e_k = (got.double() - ref64).abs().max().item() / scale
            e_p = (want.double() - ref64).abs().max().item() / scale
            ratio = max(e_k, BF16_FP64_FLOOR) / max(e_p, BF16_FP64_FLOOR)
            del ref64
            if not torch.equal(gemm(a, b, bias), got):
                raise AssertionError(f"gemm_bf16 ({label}): two calls differ")
            if K.LAUNCHES["gemm_bf16"] != before + 2:
                raise AssertionError(f"gemm_bf16 ({label}) did not launch")
            ms, plain_ms = alternate_ms(lambda: gemm(a, b, bias),
                                        lambda: gemm_reference(a, b, bias),
                                        reps)
            mm_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
            ops = 2.0 * m * n * k
            bound = max(ops / PEAK_BF16_FLOPS,
                        (2.0 * (m * k + k * n + m * n) + 4.0 * n)
                        / PEAK_BYTES_PER_S) * 1e3
            ok = (rel <= BF16_KERNEL_REL and ratio <= BF16_FP64_RATIO
                  and ms >= bound)
            log(f"gemm_bf16 {label:20s} [{m},{k}]x[{k},{n}] rel={rel:.2e} "
                f"fp64 err kernel {e_k:.2e} plain {e_p:.2e} ratio "
                f"{ratio:.3f} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"matmul_ms={mm_ms:.4f} bound_ms={bound:.4f} "
                f"{ops / ms / 1e9:.1f} TFLOP/s {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"gemm_bf16 ({label}): rel={rel}, "
                                     f"ratio={ratio}, ms={ms} < {bound}?")
            out[label] = dict(m=m, k=k, n=n, rel_err=rel, fp64_err=e_k,
                              plain_fp64_err=e_p, fp64_ratio=ratio, ms=ms,
                              plain_ms=plain_ms, matmul_ms=mm_ms,
                              bound_ms=bound)
            del a, b, got, want
    return out


def bf16_backward_cases(batch: int, device):
    """(kernel, label, kernel fn, plain grads, args, indices of the args
    that take a gradient, summed) of the bf16 backwards of A-D at the bf16
    train step's shapes: A at the four PVT stages (bf16 tokens and weights,
    fp32 biases; every grad), B on [2B, 4, 484, 128] bf16 windows without
    and with the shift mask (gx, gt and every parameter grad; and gx gt
    alone, the train step's case, kept out of the row's sum), C on bf16 q,
    k with fp32 values (dq dk at [B] and [2B], dq dk dv at [2B], and a
    ragged [2, 1000] dq dk dv kept out of the row's sum), D on bf16 logits
    (gflow and gmask), F on bf16 q against the fp32 ring (dq dk dv, and dq
    alone); G and H at the 512^2 train step's windows (gx gt, and with
    every parameter grad), J at the four MixFFN stages (gu, taps, bias),
    and checks of A, C and D at their 512^2 train shapes, of G and H at
    484 tokens and of J at 512^2 and on a 7 x 13 map, kept out of their
    rows' sums. ``plain grads`` is a callable (args, which, cot, dtype, out):
    for A-D :func:`vjp_grads` of the function the JAX backward
    differentiates, the fp32 plain version (B's with x1's rounding passed
    straight through); for F its plain backward itself
    (:func:`_memory_bwd_bf16`), which reads the forward's output."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.kernels.window_attention import _block_recompute_bf16
    from emip_tpu_torch.ops.window import shifted_window_mask

    r = seeded_randn(SEED + 41, device)
    bf = torch.bfloat16
    cases = []
    for n, m, c, heads in SR_STAGES:
        x, kv, wq, bq, wkv, bkv, wp, bp, _ = sr_args(r, batch, n, m, c, heads)
        cases.append(("sr_attention_bwd_bf16",
                      f"N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention,
                      vjp_grads(K.fused_sr_attention_reference),
                      (x.to(bf), kv.to(bf), wq.to(bf), bq, wkv.to(bf), bkv,
                       wp.to(bf), bp, heads), tuple(range(8)), True))
    c, tok, k2 = 128, 484, 4
    x, t = r(2 * batch, k2, tok, c).to(bf), r(2 * batch, k2, tok, c).to(bf)
    sp, cp = window_params(r, c)
    params = [sp[k] for k in WIN_SELF] + [cp[k] for k in WIN_CROSS]
    mask = shifted_window_mask(44, 44, 2, device=device)

    def block(fn):
        def call(x, t, *p, mask=None):
            return fn(x, t, dict(zip(WIN_SELF, p[:6])),
                      dict(zip(WIN_CROSS, p[6:])), mask)
        return call

    def layer(fn, keys):  # G (with the residual) or H on flat parameters
        def call(x, t, *p, mask=None):
            return fn(x, t, dict(zip(keys, p)), mask)
        return call

    # with every parameter grad (the row's sum), and gx gt alone: the bf16
    # train step's case (GMFlow frozen), kept out of the sum
    for label, msk in (("unshifted", None), ("shifted mask", mask)):
        for wgrads in (True, False):
            cases.append((
                "window_attention_block_bwd_bf16",
                f"[{2 * batch},{k2},{tok},{c}] {label}, x t"
                + (" + weight grads" if wgrads else " alone"),
                functools.partial(block(K.fused_window_attention_block),
                                  mask=msk),
                vjp_grads(functools.partial(block(_block_recompute_bf16),
                                            mask=msk)),
                (x, t, *params),
                tuple(range(2 + len(params))) if wgrads else (0, 1), wgrads))
    L = 1936
    for b, label, which in ((batch, "matching dq dk", (0, 1)),
                            (2 * batch, "propagation dq dk", (0, 1)),
                            (2 * batch, "propagation dq dk dv", (0, 1, 2))):
        cases.append(("flow_attention_bwd_bf16", f"[{b},{L},128] {label}",
                      K.fused_flow_attention,
                      vjp_grads(K.fused_flow_attention_reference),
                      (r(b, L, 128).to(bf), r(b, L, 128).to(bf),
                       r(b, L, 2, scale=10.0)), which, True))
    rc = seeded_randn(SEED + 42, device)
    cases.append(("flow_attention_bwd_bf16", "[2,1000,128] ragged dq dk dv",
                  K.fused_flow_attention,
                  vjp_grads(K.fused_flow_attention_reference),
                  (rc(2, 1000, 128).to(bf), rc(2, 1000, 128).to(bf),
                   rc(2, 1000, 2, scale=10.0)), (0, 1, 2), False))
    cases.append(("convex_upsample_bwd_bf16",
                  f"flow [{2 * batch},44,44,2] x8 gflow gmask",
                  K.convex_upsample, vjp_grads(K.convex_upsample_reference),
                  (r(2 * batch, 44, 44, 2, scale=3.0),
                   r(2 * batch, 44, 44, 576).to(bf), 8), (0, 1), True))
    # the 512^2 train step's shapes, kept out of their rows' sums (first
    # run there by the bf16 train step at 512^2, batch 2): A at the four
    # stages with M = 256 (both frames of 2 pairs), C's matching dq dk at
    # [4, 4096, 128] (both flow directions), D at [4, 64, 64, 2]
    r5 = seeded_randn(SEED + 45, device)
    for n, m, c, heads in SR_STAGES_512:
        x, kv, wq, bq, wkv, bkv, wp, bp, _ = sr_args(r5, 2 * TRAIN_BATCH_512,
                                                     n, m, c, heads)
        cases.append(("sr_attention_bwd_bf16",
                      f"512^2 N={n} M={m} C={c} heads={heads}",
                      K.fused_sr_attention,
                      vjp_grads(K.fused_sr_attention_reference),
                      (x.to(bf), kv.to(bf), wq.to(bf), bq, wkv.to(bf), bkv,
                       wp.to(bf), bp, heads), tuple(range(8)), False))
    b5 = 2 * TRAIN_BATCH_512
    cases.append(("flow_attention_bwd_bf16", f"512^2 [{b5},4096,128] dq dk",
                  K.fused_flow_attention,
                  vjp_grads(K.fused_flow_attention_reference),
                  (r5(b5, 4096, 128).to(bf), r5(b5, 4096, 128).to(bf),
                   r5(b5, 4096, 2, scale=10.0)), (0, 1), False))
    cases.append(("convex_upsample_bwd_bf16",
                  f"512^2 flow [{b5},64,64,2] x8 gflow gmask",
                  K.convex_upsample, vjp_grads(K.convex_upsample_reference),
                  (r5(b5, 64, 64, 2, scale=3.0),
                   r5(b5, 64, 64, 576).to(bf), 8), (0, 1), False))
    # G and H at the 512^2 train step's windows (2 pairs, both flow
    # directions: [4, 4, 1024, 128], masked; gx gt, and with every weight
    # grad), unmasked at [2, 4, 1024, 128]; a 352^2 window shape kept out
    rg = seeded_randn(SEED + 46, device)
    mask512 = shifted_window_mask(64, 64, 2, device=device)
    for b, tok, msk, with_w, summed in (
            (4, 1024, mask512, False, True), (4, 1024, mask512, True, True),
            (2, 1024, None, False, True),
            (16, 484, shifted_window_mask(44, 44, 2, device=device), False,
             False)):
        x, t = rg(b, 4, tok, 128).to(bf), rg(b, 4, tok, 128).to(bf)
        sp, cp = window_params(rg, 128)
        label = (f"[{b},4,{tok},128] "
                 + ("unshifted" if msk is None else "shifted mask")
                 + (" x t + weight grads" if with_w else " x t"))
        for name, keys, p, fn, ref in (
                ("window_attention_layer_bwd_bf16", WIN_SELF, sp,
                 K.fused_window_attention_layer,
                 K.fused_window_attention_layer_reference),
                ("window_attention_ffn_layer_bwd_bf16", WIN_CROSS, cp,
                 K.fused_window_attention_ffn_layer,
                 K.fused_window_attention_ffn_layer_reference)):
            params = [p[k] for k in keys]
            which = tuple(range(2 + len(params) if with_w else 2))
            cases.append((name, label,
                          functools.partial(layer(fn, keys), mask=msk),
                          vjp_grads(functools.partial(layer(ref, keys),
                                                      mask=msk)),
                          (x, t, *params), which, summed))
    # J at the four MixFFN stages (gu, taps and bias), and its two checks
    rj = seeded_randn(SEED + 47, device)
    for b, h, w, f, summed in (
            [(batch, side, side, f, True) for side, f in FFN_STAGES]
            + [(*c, False) for c in FFN_CHECKS]):
        cases.append(("dwconv_gelu_bwd_bf16",
                      f"[{b},{h}x{w},{f}] gu taps bias",
                      K.fused_dwconv_gelu,
                      vjp_grads(K.fused_dwconv_gelu_reference),
                      ffn_args_bf16(rj, b, h, w, f), (0, 1, 2), summed))
    # F at the bf16 long train step's shapes (1 and 4 clips, every slot
    # written: dq dk dv, and dq alone), the 512^2 shape kept out of the sum
    rf = seeded_randn(SEED + 44, device)
    for label, (q, k, v, bias) in memory_cases(
            rf, ((1, 1936, 5, 5), (4, 1936, 5, 5), (1, 4096, 5, 5))):
        for which, what in (((0, 1, 2), "dq dk dv"), ((0,), "dq")):
            if what == "dq" and q.shape[0] == 1:
                continue
            cases.append(("memory_attention_bwd_bf16", f"{label} {what}",
                          K.masked_memory_attention, _memory_bwd_bf16,
                          (q.to(bf), k, v, bias), which,
                          q.shape[1] == 1936))
    cases += [("sr_attention_bwd_bf16", label, fn, vjp_grads(ref), args,
               tuple(range(8)), False)
              for _, label, fn, ref, args in linear_sr_cases(
                  device, SEED + 48, bf16=True)]
    return cases


def _memory_bwd_bf16(args, which, cot, dtype, out):
    """The grads of F's bf16 backward (args[which]) as the JAX kernel
    computes them from the forward's output ``out`` (in delta): P
    recomputed from the upcast q, dq rounded to bf16 (with ``dtype``
    float64: every input, ``out`` and the cotangent in fp64, nothing
    rounded)."""
    from emip_tpu_torch.kernels.memory_attention import (
        masked_memory_attention_bwd_reference,
    )

    q, k, v, bias = args
    if dtype is not None:
        q, k, v, bias, out, cot = (a.to(dtype)
                                   for a in (q, k, v, bias, out, cot))
    grads = masked_memory_attention_bwd_reference(
        q, k, v, bias, out, cot, [i in which for i in range(3)])
    return [grads[i] for i in which]


def vjp_grads(plain):
    """The plain grads of a backward case whose plain version is a forward
    (A-D): a callable (args, which, cot, dtype, out) giving the VJP of
    ``plain`` w.r.t. args[which] for cotangent ``cot`` at the inputs upcast
    to fp32 (``dtype`` float64: to fp64, cotangent too), each grad rounded
    to its input's dtype (not with ``dtype``: the fp64 reference is not
    rounded); ``out`` is not read."""
    import torch

    from emip_tpu_torch.kernels import _common as cm

    def grads(args, which, cot, dtype=None, out=None):
        tensors = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        inputs = [args[i] for i in tensors]
        needs = [i in which for i in tensors]

        def fn(*ts):
            full = list(args)
            for i, t in zip(tensors, ts):
                full[i] = t
            return plain(*full)

        if dtype is None:
            got = cm.plain_vjp_fp32(fn, inputs, needs, cot)
        else:
            got = cm.plain_vjp(fn, [a.to(dtype) for a in inputs], needs,
                               cot.to(dtype))
        return [g for g, n in zip(got, needs) if n]

    return grads


def bf16_bwd_work(name: str, args, which, out, grads) -> tuple:
    """(3xTF32 operations, CUDA-core operations, bytes at their storage
    sizes, operations of products of two bf16 operands, of one) of one
    bf16 backward call: the fp32 recompute of the forward and the fp32
    backward's products (C and D as their fp32 rows count them), every
    input and the cotangent read once, the grads written once. The bf16
    operands: A's x, kv_in, weights and cotangent; B's x, t and x1
    (rounded in its forward); G's and H's x and t; C's q and k; F's q. J
    and D count their CUDA-core work: the recompute and two gradient
    products per forward product."""
    base = name.removesuffix("_bwd_bf16")
    size = float(nbytes(*args) + 2 * nbytes(out) + nbytes(*grads))
    w = set(which)
    bwd = backward_work(base + "_bwd", args, which, out)[0]
    if base == "memory_attention":  # the forward's statistics: no recompute
        (b, m, c), n = args[0].shape, args[1].shape[1]
        x2 = 2.0 * b * m * n * c * (1 + (1 in w))  # q k^T, dS^T q
        return bwd - x2, 0.0, size, 0.0, x2
    if base in ("convex_upsample", "dwconv_gelu"):
        tc, cc, _ = forward_work(base, args, out)
        return 0.0, 3.0 * (tc + cc), size, 0.0, 0.0
    if base == "flow_attention":
        b, l, c = args[0].shape
        big = 2.0 * b * l * l * c
        fwd = big + 2.0 * b * l * l * args[2].shape[-1]
        # q k^T in the recompute and the backward; dS k and dS^T q
        bf2, x2 = 2 * big, big * ((0 in w) + (1 in w))
        return fwd + bwd - bf2 - x2, 0.0, size, bf2, x2
    fwd = float(forward_products(base, args))
    if base == "sr_attention":
        (b, n, c), m = args[0].shape, args[1].shape[1]
        q_lin, kv_lin = 2.0 * b * n * c * c, 2.0 * b * m * 2 * c * c
        # x Wq, kv Wkv and g Wp^T (where any grad but Wp's is asked)
        bf2 = q_lin + kv_lin + q_lin * bool(w & {0, 1, 2, 3, 4, 5})
        # o Wp, the weight grads x^T gq, kv^T gkv, o^T g, and gq Wq^T,
        # gkv Wkv^T
        x2 = q_lin * (1 + (6 in w) + (2 in w) + (0 in w)) + kv_lin * (
            (4 in w) + (1 in w))
        return fwd + bwd - bf2 - x2, 0.0, size, bf2, x2
    rows, _, c, f, _ = _window_dims(base, args)
    lin, ffn = 2.0 * rows * c * c, 2.0 * rows * c * f
    if base in ("window_attention_layer", "window_attention_ffn_layer"):
        # G: x Wq, t Wk, t Wv in the recompute and those weights' grads; H
        # also x's half of W0 and of its grad
        asked = sum(i in w for i in (2, 3, 4))
        x2 = 3 * lin + lin * asked
        if base == "window_attention_ffn_layer":
            x2 += ffn * (1 + (2 + WIN_CROSS.index("w0") in w))
        return fwd + bwd - x2, 0.0, size, 0.0, x2
    # B: x Wq, x Wk, x Wv, x1 Wq, t Wk, t Wv and x1's half of W0 in the
    # recompute, and the grads of those weights
    off = 2 + len(WIN_SELF)
    asked = sum(i in w for i in (2, 3, 4, off, off + 1, off + 2))
    w0 = off + WIN_CROSS.index("w0")
    x2 = 6 * lin + ffn + lin * asked + ffn * (w0 in w)
    return fwd + bwd - x2, 0.0, size, 0.0, x2


def bf16_backward_phase(batch: int, device, reps: int,
                        only: str = "") -> dict:
    """The bf16 backwards of A-D against their plain versions on the card
    (rel <= BF16_KERNEL_REL of max|plain| per grad), against an fp64
    evaluation of the same VJP on the same bf16 inputs (each grad's error
    relative to its max|ref| no more than BF16_FP64_RATIO times the plain
    version's, errors below the floor counted as the floor:
    BF16_FP64_FLOOR for a grad rounded to bf16, BF16_FP32_GRAD_FLOOR for
    one that stays fp32), each grad in its input's dtype, the same bits on
    a second call; CUDA-event times of the backward alone beside the plain
    VJP (which recomputes the forward, as the kernel does) and, for C,
    scaled_dot_product_attention's backward on the upcast inputs; the bound
    of the recompute and the backward, each product at the rate its
    operands allow. ``only``: the rows whose name contains one of its
    comma-separated names (every row when empty)."""
    import torch

    results = {}
    for name, label, fn, plain, args, which, summed in bf16_backward_cases(
            batch, device):
        if not wanted(only, name):
            continue
        gen = torch.Generator(device=device).manual_seed(SEED + 43)

        def cot(out):
            return torch.randn(out.shape, generator=gen, device=device
                               ).to(out.dtype)

        out_k, got, rerun_k = _grads(fn, args, which, cot)
        if out_k.grad_fn is None:
            raise AssertionError(f"{name}: the CUDA output has no grad_fn")
        gen.manual_seed(SEED + 43)
        g = cot(out_k)  # the cotangent _grads drew
        torch.cuda.synchronize()

        def plain_grads(dtype=None):
            return plain(args, which, g, dtype, out_k.detach())

        want = plain_grads()
        ref64 = plain_grads(torch.float64)
        rel, err, e_ks, e_ps = 0.0, 0.0, [], []
        worst = {torch.bfloat16: (0.0, None), torch.float32: (0.0, None)}
        for i, gk, gp, g64 in zip(which, got, want, ref64):
            if gk.dtype != args[i].dtype or gp.dtype != args[i].dtype:
                raise AssertionError(f"{name} ({label}): grad {i} is "
                                     f"{gk.dtype}, its input {args[i].dtype}")
            e = (gk.float() - gp.float()).abs().max().item()
            err = max(err, e)
            rel = max(rel, e / max(gp.float().abs().max().item(), 1e-30))
            scale = max(g64.abs().max().item(), 1e-30)
            e_k = (gk.double() - g64).abs().max().item() / scale
            e_p = (gp.double() - g64).abs().max().item() / scale
            e_ks.append(e_k)
            e_ps.append(e_p)
            floor = (BF16_FP64_FLOOR if gk.dtype == torch.bfloat16
                     else BF16_FP32_GRAD_FLOOR)
            worst[gk.dtype] = max(worst[gk.dtype],
                                  (max(e_k, floor) / max(e_p, floor), i))
        del ref64
        ratio = max(r for r, _ in worst.values())
        again = rerun_k()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} ({label}): two calls on the same "
                                 f"inputs differ")
        del again
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        dig = record_digest(name, label, got, rerun_k)
        ms, plain_ms = alternate_ms(rerun_k, plain_grads, reps)
        lib_ms, sdpa_ms = bf16_bwd_library_ms(name, fn, args, which, reps)
        dev = device_times(name, rerun_k, plain_grads, reps, label)
        fp32_dev = (J_FP32_DEVICE_MS.get(tuple(args[0].shape))
                    if name == "dwconv_gelu_bwd_bf16" else None)
        if fp32_dev is not None:  # the fp32 row's, same shape, same call
            dev["fp32_device_ms"] = fp32_dev
        ok = finite and rel <= BF16_KERNEL_REL and ratio <= BF16_FP64_RATIO
        per = " ".join(f"{str(dt)[6:]} {r:.3f} (arg {i})"
                       for dt, (r, i) in worst.items() if i is not None)
        log(f"kernel {name:32s} {label:44s} max_abs_err={err:.3e} "
            f"rel={rel:.2e} (tol {BF16_KERNEL_REL}) fp64 err kernel "
            f"{max(e_ks):.2e} plain {max(e_ps):.2e}; fp64 ratio per grad at "
            f"most {per} (limit {BF16_FP64_RATIO}, floors "
            f"{BF16_FP64_FLOOR} bf16, {BF16_FP32_GRAD_FLOOR} fp32) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={fmt_ms(lib_ms)} " + fmt_dev(dev)
            + ("ok" if ok else "MISMATCH"))
        if not ok:
            raise AssertionError(f"{name} ({label}): rel={rel}, fp64 "
                                 f"ratio={ratio} ({per}), finite={finite}")
        record(results, name, label, err, ms, plain_ms,
               bf16_bwd_work(name, args, which, out_k, got), lib_ms,
               summed=summed, rel_err=rel, fp64_err=max(e_ks),
               plain_fp64_err=max(e_ps), fp64_ratio=ratio,
               fp64_ratio_bf16_grads=worst[torch.bfloat16][0],
               fp64_ratio_fp32_grads=worst[torch.float32][0],
               fp64_err_per_grad=e_ks, plain_fp64_err_per_grad=e_ps,
               **({} if sdpa_ms is None else dict(sdpa_ms=sdpa_ms)), **dev,
               **dig)
        del out_k, got, want, rerun_k
    for entry in results.values():
        entry["fp64_ratio"] = max(c["fp64_ratio"] for c in entry["cases"])
        sdpa = [c["sdpa_ms"] for c in entry["cases"]
                if "sdpa_ms" in c and c.get("summed", True)]
        if sdpa:
            entry["sdpa_ms"] = sum(sdpa)
    device_sums(results)
    return results


def bf16_bwd_library_ms(name: str, fn, args, which, reps: int) -> tuple:
    """(library_ms, sdpa_ms) of a bf16 backward case: for C and F the
    backward of ``scaled_dot_product_attention`` on the upcast inputs
    (:func:`library_ms`); for J the backward of the library's bf16
    depthwise convolution and GELU (:func:`dwconv_library`) on the same
    inputs; for G and H (no call computes their layer) the backward of
    ``scaled_dot_product_attention`` in bf16 on their attention alone,
    q, k, v of the windows' shape, with the case's mask (the keyword of
    its ``fn``), as ``sdpa_ms``. The backward alone, its graph kept; a
    yardstick only."""
    import torch
    import torch.nn.functional as F

    if name in ("flow_attention_bwd_bf16", "memory_attention_bwd_bf16"):
        return library_ms(name.removesuffix("_bf16"),
                          [a.float() for a in args], reps, which), None
    gen = torch.Generator(device=args[0].device).manual_seed(SEED + 3)

    def cot(out):
        return torch.randn(out.shape, generator=gen, device=out.device
                           ).to(out.dtype)

    try:
        if name == "dwconv_gelu_bwd_bf16":
            _, _, rerun = _grads(lambda *a: dwconv_library(a), args, which,
                                 cot)
            return cuda_ms(rerun, reps), None
        if name in ("window_attention_layer_bwd_bf16",
                    "window_attention_ffn_layer_bwd_bf16"):
            x = args[0]
            mask = fn.keywords["mask"]
            attn_mask = None if mask is None else mask.to(x.dtype)
            _, _, rerun = _grads(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask), (x, x, x), (0, 1, 2), cot)
            return None, cuda_ms(rerun, reps)
    except RuntimeError as e:  # no backend takes these shapes
        log(f"library call for {name} refused: {str(e).splitlines()[0]}")
    return None, None


def expected_launches_bf16(model, train: bool = False) -> dict:
    """Launches per bf16 forward (``train``: per bf16 train step): the bf16
    instantiation of each kernel the fp32 model launches (A-D, G, H and J,
    forward and backward) where it launches it, E and I (which read fp32 in
    both bands, as the JAX package's) where it launches them, and nothing
    else."""
    per32 = expected_launches(model, train)
    n = {k: 0 for k in per32}
    for name in BF16_FWD_KERNELS:
        n[name + "_bf16"] = per32[name]
        n[name + "_bwd_bf16"] = per32[name + "_bwd"]
    for name in FP32_IN_BOTH_BANDS:
        n[name] = per32[name]
    return n


def bf16_slice_phase(model, batch: int, size: int, device, timed: int,
                     fp32: dict, label: str = "b5") -> tuple:
    """The same b5 model and seeded frames as the fp32 slice phase, in
    bf16 (``EMIPShort(cfg, dtype=bfloat16)`` on the same weights) through
    ``predict_arrays``: launch counts over 1 + ``timed`` batches (the four
    bf16 forwards, no fp32 kernel) and peak memory, beside the fp32 phase's;
    frames/s of bf16 and fp32 timed in turns (fp32, bf16, bf16, fp32,
    ``timed`` batches each; the medians of each model's batches); then one
    pair through the plain bf16 versions on the CPU against the card, and
    the card's bf16 against its fp32 on that pair. The gate: card bf16 vs
    CPU bf16 within twice the bf16-vs-fp32 gap, which is above zero.
    Returns (result, the bf16 model)."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_short import EMIPShort

    model16 = EMIPShort(model.config, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    model16 = model16.to(device).eval()
    rng = np.random.default_rng(SEED + 1)  # the fp32 slice's frames
    n_batches = 1 + timed
    frames = [(torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
               torch.from_numpy(seeded_frames(rng, batch, size)).to(device))
              for _ in range(n_batches)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    # both models' fp32 parameters are resident; what the run adds (the
    # bf16 weight copies, made at the first batch, and the activations) is
    # the peak above this
    resident = torch.cuda.memory_allocated(device)
    K.reset_launches()
    outputs = [predict_arrays(model16, a, b) for a, b in frames]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    work = peak - resident
    want = {k: v * n_batches
            for k, v in expected_launches_bf16(model16).items()}
    log(f"bf16 slice {label} launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"bf16 launch counts {launches} != {want}")
    for mask, flow in outputs:
        if (tuple(mask.shape) != (batch, 1, size, size)
                or tuple(flow.shape) != (batch, 2, size, size)
                or mask.dtype != torch.float32 or flow.dtype != torch.float32
                or not (torch.isfinite(mask).all()
                        and torch.isfinite(flow).all())):
            raise AssertionError("bf16 outputs: shape, dtype or finiteness")

    def batch_times(m) -> list:
        return [timed_call(lambda: predict_arrays(m, a, b))[1]
                for a, b in frames[1:]]

    t32 = batch_times(model)
    t16 = batch_times(model16) + batch_times(model16)
    t32 += batch_times(model)
    ms16, ms32 = statistics.median(t16), statistics.median(t32)
    fps, fps32 = batch / (ms16 / 1e3), batch / (ms32 / 1e3)
    log(f"slice {label} {size}^2 bs={batch} bf16: median {ms16:.3f} "
        f"ms/batch -> "
        f"{fps:.3f} frames/s; fp32 in the same turns {ms32:.3f} ms/batch -> "
        f"{fps32:.3f} frames/s (x{fps / fps32:.3f}); peak memory "
        f"{peak / 2**30:.3f} GiB, {work / 2**30:.3f} GiB above what was "
        f"allocated before the run (the fp32 slice: peak "
        f"{fp32['peak_bytes'] / 2**30:.3f} GiB, "
        f"{fp32['working_bytes'] / 2**30:.3f} above)")

    # one pair: the card's bf16 against the CPU's plain bf16 versions, and
    # against the card's fp32 on the same pair
    t0 = time.perf_counter()
    a, b = frames[0]
    card16 = outputs[0]
    card32 = predict_arrays(model, a[:1], b[:1])
    cpu16 = predict_arrays(copy.deepcopy(model16).cpu(), a[:1].cpu(),
                           b[:1].cpu())
    cmp = {}
    for i, name in enumerate(("mask", "flow_fw")):
        got = card16[i][:1].cpu()
        err = (got - cpu16[i]).abs().max().item()
        gap = (got - card32[i].cpu()).abs().max().item()
        ok = gap > 0 and err <= 2 * gap
        cmp[name] = dict(card_vs_cpu_bf16=err, bf16_vs_fp32_gap=gap,
                         limit=2 * gap, ok=ok,
                         ref_max_abs=cpu16[i].abs().max().item())
        log(f"bf16 slice {label} {name}: card bf16 vs CPU plain bf16 "
            f"max_abs_err="
            f"{err:.3e}; card bf16 vs card fp32 gap {gap:.3e} (limit 2 x gap "
            f"= {2 * gap:.3e}, |ref| max {cmp[name]['ref_max_abs']:.3e}) "
            f"{'ok' if ok else 'MISMATCH'}")
    log(f"bf16 CPU reference pair took {time.perf_counter() - t0:.1f} s")
    bad = [k for k, v in cmp.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"bf16 card disagrees with the CPU: {bad}")
    return dict(launches=launches, expected=want, median_ms=ms16,
                batch_ms=t16, frames_per_s=fps, fp32_median_ms=ms32,
                fp32_batch_ms=t32, fp32_frames_per_s=fps32, peak_bytes=peak,
                working_bytes=work, fp32_peak_bytes=fp32["peak_bytes"],
                fp32_working_bytes=fp32["working_bytes"], compare=cmp), model16


def bf16_entry_phase(entry: dict, size: int) -> dict:
    """``python -m emip_tpu_torch.test`` (in process) with the train
    phase's YAML saying ``compute_dtype: bfloat16``, on its synthetic root
    and checkpoint at b5 ``size``: TF32 and the bf16 reduced-precision
    reduction on before the call and checked off after it, the bf16
    forwards of A-D launched and none of their fp32 ones, a PNG per
    pair."""
    import yaml

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.test import main as test_main

    work, root = entry["work"], entry["root"]
    with open(entry["config"]) as f:
        raw = yaml.safe_load(f)
    raw["compute_dtype"] = "bfloat16"
    cfg = os.path.join(work, "test_bf16.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    name = os.path.basename(os.path.normpath(root))
    pairs = sum(len(os.listdir(os.path.join(root, v, "GT"))) - 1
                for v in os.listdir(root))
    pred = os.path.join(work, "pred_bf16")
    K.reset_launches()
    tf32_on()
    t0 = time.perf_counter()
    test_main(["--config", cfg, "--ckpt", entry["ckpt"], "--save_path", pred,
               "--data", f"{name}={root}"])
    dt = time.perf_counter() - t0
    tf32_checked_off("entry python -m emip_tpu_torch.test (bf16)")
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    pngs = _count_files(os.path.join(pred, name), ".png")
    ok = (pngs == pairs
          and all(K.LAUNCHES[k + "_bf16"] > 0 for k in FWD_KERNELS)
          and not any(K.LAUNCHES[k] for k in FWD_KERNELS))
    log(f"entry python -m emip_tpu_torch.test compute_dtype=bfloat16 b5 "
        f"{size}^2: {pngs} PNGs for {pairs} pairs, launches {launches}, "
        f"{dt:.1f} s {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"bf16 test entry point: {pngs} PNGs, "
                             f"launches {launches}")
    return dict(pngs=pngs, pairs=pairs, launches=launches, seconds=dt)


# --------------------------------------------------------------- train


def seeded_batch(rng, batch: int, size: int, device) -> dict:
    import torch

    gt = (rng.uniform(size=(batch, 1, size, size)) > 0.5).astype(np.float32)
    return dict(
        image1=torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
        image2=torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
        gt=torch.from_numpy(gt).to(device))


# what the default short train step launches: A-D forward and backward, E
TRAIN_KERNELS = ("sr_attention", "sr_attention_bwd", "window_attention_block",
                 "window_attention_block_bwd", "flow_attention",
                 "flow_attention_bwd", "convex_upsample",
                 "convex_upsample_bwd", "splat_density")
# at 512^2 the windows hold 1024 tokens: G and H in place of B
TRAIN_KERNELS_512 = tuple(
    k for k in TRAIN_KERNELS if "window" not in k) + (
    "window_attention_layer", "window_attention_layer_bwd",
    "window_attention_ffn_layer", "window_attention_ffn_layer_bwd")


def train_phase(model, batch: int, size: int, device, timed: int,
                must_run=TRAIN_KERNELS) -> dict:
    """Train steps of the full model: 1 warm-up, then ``timed`` steps
    timed with CUDA events; kernel launch counts per step against the
    structure (and none of ``must_run`` idle); GMFlow untouched; every
    trainable leaf with a grad moved."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    opt = build_optimizer(model)  # lr 1e-5, wd 1e-7, clamp 0.5; GMFlow frozen
    gmflow0 = {k: v.clone() for k, v in model.GMFlow.state_dict().items()}
    trainable0 = {n: p.detach().clone() for n, p in model.named_parameters()
                  if p.requires_grad}
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    if not frozen or any(not n.startswith("GMFlow.") for n in frozen):
        raise AssertionError("the frozen set is not exactly GMFlow")
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 5)
    steps = 1 + timed
    batches = [seeded_batch(rng, batch, size, device) for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    K.reset_launches()
    times, losses = [], []
    for i, b in enumerate(batches):
        metrics, ms = timed_call(lambda: short_train_step(model, opt, b, gen))
        if i > 0:
            times.append(ms)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = dict(K.LAUNCHES)
    want = {k: v * steps for k, v in expected_launches(model, True).items()}
    log(f"train launches {launches} (expected {want})")
    idle = [k for k in must_run if launches[k] == 0]
    if launches != want or idle:
        raise AssertionError(f"train launch counts {launches} != {want}; "
                             f"not launched: {idle}")

    for i, m in enumerate(losses):
        log(f"train step {i}: " + " ".join(f"{k}={v:.6f}"
                                            for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite losses at step {i}: {m}")
    gm = model.GMFlow.state_dict()
    if any(not torch.equal(gm[k], v) for k, v in gmflow0.items()):
        raise AssertionError("a frozen GMFlow tensor changed")
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None
             and torch.equal(p.detach(), trainable0[n])]
    with_grad = sum(p.requires_grad and p.grad is not None
                    for p in model.parameters())
    if still or with_grad == 0:
        raise AssertionError(f"trainable leaves with a grad that did not "
                             f"move: {still[:8]}")
    median_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(device)
    log(f"train b5 {size}^2 bs={batch} fp32: median {median_ms:.3f} ms/step "
        f"over {len(times)} steps -> {batch / (median_ms / 1e3):.3f} pairs/s; "
        f"peak memory {peak / 2**30:.3f} GiB; {with_grad} trainable leaves "
        f"with grads all moved, {len(frozen)} GMFlow tensors bit-identical")
    del opt
    return dict(launches=launches, expected=want, median_ms=median_ms,
                step_ms=times, pairs_per_s=batch / (median_ms / 1e3),
                peak_bytes=peak, losses=losses,
                leaves_with_grad=with_grad)


def variant_phase(label: str, model, infer_cfg, train_cfgs, batch: int,
                  size: int, device, timed: int, must_run,
                  bf16: bool = False, seg_kernels=()) -> dict:
    """The short model under another kernel configuration, beside the
    default one on ``model``'s weights and the same inputs, in fp32 or
    (``bf16``) in the bf16 band.

    Inference with ``infer_cfg``: ``predict_arrays`` on seeded batches, in
    turns default, variant, variant, default; launch counts of the variant
    per forward against its structure (:func:`expected_launches`, in bf16
    :func:`expected_launches_bf16`). In fp32 mask and flow of the first
    batch equal to the default's within the slice tolerance; in bf16 every
    mask and flow finite fp32, and the card held to the CPU below. Then
    train steps of the default and of each of ``train_cfgs`` (name,
    config), each model from the same weights with its own optimizer and
    the same seeded drop-path bits: launch counts per step, the first
    step's losses equal to the default's within the loss tolerance, every
    step's finite. In bf16 then the card against the CPU: under
    ``infer_cfg`` one pair through the bf16 and fp32 models at b5's widths
    and PVT depths BF16_COMPARE_DEPTHS on both sides, the mask and the flow
    each within twice the larger of the card's and the CPU's bf16-vs-fp32
    gaps (:func:`_gap_check`); under each of ``train_cfgs`` the losses and
    the seg-loss grads of every trainable leaf
    (:func:`bf16_train_compare_phase`), whose card run must launch those
    of ``seg_kernels`` (the switch's kernels on the seg loss's path) that
    the train steps under that configuration launched. ``must_run`` names
    the kernels the variant's runs must have launched between them. Times
    are medians of CUDA-event timed batches / steps."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    band = " bf16" if bf16 else ""
    expected = expected_launches_bf16 if bf16 else expected_launches

    def twin(cfg):
        m = EMIPShort(cfg, dtype=torch.bfloat16 if bf16 else torch.float32)
        m.load_state_dict(model.state_dict(), strict=True)  # the same keys
        return m.to(device)

    def timed_run(fn, n):
        """(results, ms of each call after the first)."""
        outs, times = [], []
        for i in range(n):
            out, ms = timed_call(lambda: fn(i))
            outs.append(out)
            if i > 0:
                times.append(ms)
        return outs, times

    rng = np.random.default_rng(SEED + 11)
    n = 1 + timed
    frames = [(torch.from_numpy(seeded_frames(rng, batch, size)).to(device),
               torch.from_numpy(seeded_frames(rng, batch, size)).to(device))
              for _ in range(n)]
    models = dict(default=twin(model.config) if bf16 else model,
                  variant=twin(infer_cfg))
    want = {k: v * n for k, v in expected(models["variant"]).items()}
    runs, launched = {}, {}
    for who in ("default", "variant", "variant", "default"):
        m = models[who].eval()
        K.reset_launches()
        outs, times = timed_run(lambda i: predict_arrays(m, *frames[i]), n)
        runs.setdefault(who, dict(outs=outs, times=[]))["times"] += times
        if who == "variant":
            if dict(K.LAUNCHES) != want:
                raise AssertionError(f"{label}{band}: launch counts "
                                     f"{dict(K.LAUNCHES)} != {want}")
            launched["infer"] = dict(K.LAUNCHES)
    cmp = {}
    if bf16:
        for who, r in runs.items():
            if not all(o.dtype == torch.float32 and bool(torch.isfinite(
                    o).all()) for pair in r["outs"] for o in pair):
                raise AssertionError(f"{label} bf16 ({who}): mask or flow "
                                     f"not finite fp32")
    else:
        for name, got, ref in zip(("mask", "flow_fw"),
                                  runs["variant"]["outs"][0],
                                  runs["default"]["outs"][0]):
            tol = SLICE_TOL[name]
            err = (got - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            ok = (bool(torch.isfinite(got).all())
                  and torch.allclose(got, ref, **tol)
                  and rel <= SLICE_REL_MAX)
            cmp[name] = dict(max_abs_err=err, rel_to_max=rel, ok=ok)
            log(f"{label} {name} vs default configuration: max_abs_err="
                f"{err:.3e} tol={tol}; max|err|/max|ref|={rel:.3e} (limit "
                f"{SLICE_REL_MAX}) {'ok' if ok else 'MISMATCH'}")
    ms = {who: statistics.median(r["times"]) for who, r in runs.items()}
    per_fwd = {k: v // n for k, v in launched["infer"].items() if v}
    log(f"{label}{band} inference b5 {size}^2 bs={batch}: launches per "
        f"forward {per_fwd}; median {ms['variant']:.3f} ms/batch -> "
        f"{batch / ms['variant'] * 1e3:.3f} frames/s ({band.strip() or 'fp32'}"
        f" default configuration in the same turns: {ms['default']:.3f} "
        f"ms/batch -> {batch / ms['default'] * 1e3:.3f} frames/s)")
    if not all(c["ok"] for c in cmp.values()):
        raise AssertionError(f"{label}: outputs differ from the default "
                             f"configuration's: {cmp}")
    out = dict(infer=dict(launches=launched["infer"], ms=ms, compare=cmp,
                          frames_per_s={k: batch / v * 1e3
                                        for k, v in ms.items()}))
    del models, runs
    torch.cuda.empty_cache()

    # ---- train steps, each model from the same weights
    rng = np.random.default_rng(SEED + 12)
    batches = [seeded_batch(rng, batch, size, device) for _ in range(n)]
    res = {}
    for who, cfg in (("default", model.config), *train_cfgs):
        m = twin(cfg)
        opt = build_optimizer(m)
        gen = torch.Generator(device=device).manual_seed(SEED)
        K.reset_launches()
        metrics, times = timed_run(
            lambda i: short_train_step(m, opt, batches[i], gen), n)
        want = {k: v * n for k, v in expected(m, True).items()}
        if dict(K.LAUNCHES) != want:
            raise AssertionError(f"{label}{band} train ({who}): launch "
                                 f"counts {dict(K.LAUNCHES)} != {want}")
        res[who] = dict(launches=dict(K.LAUNCHES),
                        ms=statistics.median(times),
                        losses=[{k: float(v) for k, v in mt.items()}
                                for mt in metrics])
        del m, opt
        torch.cuda.empty_cache()
    # the first step starts from the same weights; after it the two runs'
    # weights differ in their last bits (kernel E's atomics) and the flow
    # loss, piecewise constant in the warp, moves in its 3rd-4th digit. In
    # bf16 a switch rounds elsewhere (J's fp32 stencil against cuDNN's bf16
    # convolution), so its steps are held to the CPU below, not to the
    # default's
    bad = []
    for who, _ in train_cfgs:
        a, b = res[who]["losses"][0], res["default"]["losses"][0]
        wrong = [] if bf16 else [
            (who, k, a[k], b[k]) for k in a
            if not abs(a[k] - b[k]) <= TRAIN_LOSS_RTOL * abs(b[k])]
        wrong += [(who, i, m) for i, m in enumerate(res[who]["losses"])
                  if not all(np.isfinite(v) for v in m.values())]
        per_step = {k: v // n for k, v in res[who]["launches"].items()
                    if v and (bf16 or k.endswith("_bwd"))}
        held = ("" if bf16 else f"first step's losses within rel "
                f"{TRAIN_LOSS_RTOL} of the default's, ")
        log(f"{label}{band} train ({who}) b5 {size}^2 bs={batch}: "
            f"{'launches' if bf16 else 'backward launches'} per step "
            f"{per_step}; first step's loss {a['loss']:.7f} (default "
            f"configuration {b['loss']:.7f}); median {res[who]['ms']:.3f} "
            f"ms/step (default configuration: {res['default']['ms']:.3f}); "
            f"{held}all {n} steps finite: "
            f"{'ok' if not wrong else 'MISMATCH'}")
        bad += wrong
    if bad:
        raise AssertionError(f"{label}{band}: train losses differ from the "
                             f"default configuration's: {bad[:4]}")
    idle = [k for k in must_run
            if not launched["infer"].get(k)
            and not any(res[who]["launches"].get(k) for who, _ in train_cfgs)]
    if idle:
        raise AssertionError(f"{label}{band}: never launched: {idle}")
    out["train"] = res
    if not bf16:
        return out

    # the card against the CPU under infer_cfg, at reduced depth
    t0 = time.perf_counter()
    pvt = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b5"],
                              depths=BF16_COMPARE_DEPTHS, drop_path_rate=0.0)
    cfg = dataclasses.replace(infer_cfg, backbone_name=pvt)
    fp32 = seeded_init_(EMIPShort(cfg), SEED)
    card16 = EMIPShort(cfg, dtype=torch.bfloat16)
    card16.load_state_dict(fp32.state_dict())
    a, b = (torch.from_numpy(seeded_frames(np.random.default_rng(
        SEED + 13 + i), 1, size)) for i in range(2))
    got = {}
    for name, m, dev in (("card16", card16, device), ("card32", fp32, device),
                         ("cpu16", copy.deepcopy(card16), "cpu"),
                         ("cpu32", copy.deepcopy(fp32), "cpu")):
        m = m.to(dev).eval()
        with torch.no_grad():
            mask, flow = predict_arrays(m, a.to(dev), b.to(dev))
        got[name] = dict(mask=mask, flow_fw=flow)
    cmp, bad = _gap_check(label, got["card16"], got["cpu16"],
                          got["card32"], got["cpu32"])
    for k, v in cmp.items():
        log(f"{label} bf16 {k}: card bf16 vs CPU plain bf16 max_abs_err="
            f"{v['err']:.3e}; bf16-vs-fp32 gap card {v['card_gap']:.3e} CPU "
            f"{v['cpu_gap']:.3e}: {v['ratio']:.3f} x the larger (limit 2; "
            f"b5 widths, PVT depths {BF16_COMPARE_DEPTHS}, "
            f"{time.perf_counter() - t0:.1f} s) "
            f"{'ok' if v['ok'] else 'MISMATCH'}")
    if bad:
        raise AssertionError(f"{label} bf16: card disagrees with the CPU: "
                             f"{bad}")
    out["compare"] = cmp
    del got, fp32, card16
    # each switched train step's losses and grads, card against the CPU
    out["train_compare"] = {
        who: bf16_train_compare_phase(
            model, size, device, f"{label} bf16 train ({who})",
            [k for k in seg_kernels if res[who]["launches"].get(k)],
            config=cfg, loss_larger_gap=True)
        for who, cfg in train_cfgs}
    return out


def grad_relmax(grads_c: dict, grads_p: dict) -> tuple[dict, list]:
    """Per leaf, max|card - CPU| / max|CPU|, the denominator floored at
    1e-6 of the largest CPU grad (tests/test_grad_parity.py); and the five
    worst leaves."""
    if set(grads_c) != set(grads_p):
        raise AssertionError("card and CPU grads cover different leaves")
    floor = 1e-6 * max(g.abs().max().item() for g in grads_p.values())
    rels = {n: (grads_c[n] - grads_p[n]).abs().max().item()
            / max(grads_p[n].abs().max().item(), floor) for n in grads_p}
    return rels, sorted(rels.items(), key=lambda kv: -kv[1])[:5]


def _seg_grads(model, batch) -> tuple[dict, dict]:
    """Loss values and d(seg loss)/d(trainable leaves) of one train-mode
    forward (no optimizer step)."""
    import torch

    from emip_tpu_torch.train.short import short_losses

    model.train()
    out = short_losses(model, batch)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(out["loss_pred"], params, allow_unused=True)
    return ({k: float(v.detach()) for k, v in out.items()},
            {n: g.detach().cpu() for n, g in zip(names, grads)
             if g is not None})


def train_compare_phase(model, size: int, device,
                        label: str = "train") -> dict:
    """One pair, the seeded weights, card kernels vs CPU plain versions:
    loss values, and the seg-loss grads of every trainable leaf (GMFlow
    frozen) by the scale-floored relative max of
    tests/test_grad_parity.py. Drop path is off (the two devices'
    generators differ)."""
    from emip_tpu_torch.train.state import freeze_gmflow

    freeze_gmflow(model)
    pvt_cfg = model.backbone.feat_net.pvtv2_en.config
    model.backbone.feat_net.pvtv2_en.config = dataclasses.replace(
        pvt_cfg, drop_path_rate=0.0)
    rng = np.random.default_rng(SEED + 6)
    batch = seeded_batch(rng, 1, size, device)
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    loss_c, grads_c = _seg_grads(model, batch)
    loss_p, grads_p = _seg_grads(cpu_model, {k: v.cpu()
                                             for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    model.backbone.feat_net.pvtv2_en.config = pvt_cfg
    del cpu_model

    bad = []
    for k in ("loss_pred", "loss_flow"):
        rel = abs(loss_c[k] - loss_p[k]) / max(abs(loss_p[k]), 1e-30)
        log(f"{label} {k} card {loss_c[k]:.7f} vs CPU {loss_p[k]:.7f}: "
            f"rel {rel:.3e} (tol {TRAIN_LOSS_RTOL})")
        if not rel <= TRAIN_LOSS_RTOL:
            bad.append(k)
    rels, worst = grad_relmax(grads_c, grads_p)
    log(f"{label} seg-loss grads card vs CPU over {len(rels)} leaves: worst "
        f"relmax {worst[0][1]:.3e} (tol {SEG_GRAD_RTOL}); top: "
        + ", ".join(f"{n}={r:.2e}" for n, r in worst)
        + f"; CPU side took {cpu_s:.1f} s")
    bad += [n for n, r in rels.items() if not r <= SEG_GRAD_RTOL]
    if bad:
        raise AssertionError(f"card disagrees with the CPU reference: "
                             f"{bad[:8]}")
    return dict(losses_card=loss_c, losses_cpu=loss_p, leaves=len(rels),
                worst=worst, cpu_seconds=cpu_s)


def tf32_on() -> None:
    """Both TF32 switches and cuBLAS's reduced-precision reduction of bf16
    products on before an entry point runs: cuDNN's TF32 and the bf16
    reduction are on by torch's default, the matmul TF32 one is turned on
    too so that the check covers it. The entry point must turn all three off
    itself (``emip_tpu_torch.device.resolve_device``);
    :func:`tf32_checked_off` holds it to that."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True


def tf32_checked_off(label: str) -> None:
    import torch

    matmul = torch.backends.cuda.matmul
    on = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
          matmul.allow_bf16_reduced_precision_reduction)
    log(f"{label}: TF32 switches and bf16 reduced-precision reduction "
        f"after the call (cudnn, matmul, bf16) = {on}")
    if any(on):
        raise AssertionError(f"{label} ran with TF32 or the bf16 "
                             f"reduced-precision reduction on: {on}")


def entry_phase(batch: int, size: int) -> dict:
    """``python -m emip_tpu_torch.train`` (in process) on a synthetic root
    that the port writes: b5 at 352^2, 1 epoch of 2 steps, validation
    over the root's pairs, a checkpoint written. TF32 is on before the
    call and must be off after it."""
    import yaml

    from emip_tpu_torch.data import make_synthetic_video_root
    from emip_tpu_torch.train.__main__ import main as train_main

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    # under a dataset's name, so that the offline evaluator finds its GT
    root = make_synthetic_video_root(os.path.join(work, "data", "MoCA_test"),
                                     num_videos=2, frames_per_video=10,
                                     seed=SEED)
    cfg = dict(
        train_dataset=dict(image_path=root, gt_path=root, inp_size=size,
                           batch_size=batch, dataset_type="MoCA"),
        val_dataset=dict(image_path=root, gt_path=root, inp_size=size,
                         batch_size=1, dataset_type="MoCA"),
        model=dict(args=dict(inp_size=size, backbone_name="pvt_v2_b5",
                             channel=32)),
        optimizer=dict(lr=1.0e-5, weight_decay=1.0e-7),
        clip=0.5, seed=SEED, epoch=2, epoch_val=1, epoch_save=1,
        compute_dtype="float32", save_path=os.path.join(work, "run"))
    os.makedirs(work, exist_ok=True)
    cfg_path = os.path.join(work, "train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    tf32_on()
    t0 = time.perf_counter()
    summary = train_main(["--config", cfg_path, "--max_steps_per_epoch",
                          "2"])
    dt = time.perf_counter() - t0
    tf32_checked_off("entry python -m emip_tpu_torch.train")
    ckpt = os.path.join(work, "run", "ckpt", "ckpt.pt")
    ok = (summary["steps"] == 2 and os.path.exists(ckpt)
          and np.isfinite(summary["best_mae"]))
    log(f"entry python -m emip_tpu_torch.train: {summary['steps']} steps, "
        f"val MAE {summary['best_mae']:.5f}, checkpoint "
        f"{'written' if os.path.exists(ckpt) else 'MISSING'}, {dt:.1f} s "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"train entry point failed: {summary}")
    return dict(summary=summary, seconds=dt, work=work, root=root,
                config=cfg_path, ckpt=os.path.dirname(ckpt))


# ------------------------------------------- static pretrain + entry chain

STATIC_TIMED = 3  # timed static train steps after one warm-up
# timed bf16 train / static steps per turn (fp32, bf16, bf16, fp32)
BF16_TIMED_STEPS = 2


def static_expected(model) -> dict:
    """Kernel launches per static train step implied by SegNetwork's
    structure: A forward and backward once per PVT block of the one frame
    (every stage reaches the loss, through dr1-dr3 or the stages after
    it), J where the backbone's configuration asks for it, nothing else
    (and nothing at all for an encoder without kernel A)."""
    from emip_tpu_torch import kernels as K

    _, pvt = seg_encoder(model)
    blocks = sum(pvt.depths) if pvt is not None else 0
    n = {k: 0 for k in K.LAUNCHES}
    n.update(pvt_kernels(pvt, blocks, blocks))
    return n


def _static_grads(model, batch) -> tuple[float, dict]:
    import torch

    from emip_tpu_torch.losses.seg import hybrid_e_loss

    model.train()
    loss = hybrid_e_loss(model(batch["image"]), batch["gt"])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), {n: g.detach().cpu()
                                  for n, g in zip(names, grads)}


def static_phase(batch: int, size: int, device, timed: int) -> dict:
    """Static-image pretraining's model (``SegNetwork``: pvt_v2_b5,
    channel 32) at full width and depth on seeded weights. One image, drop
    path off: the hybrid-E loss and every leaf's grad, card against the
    CPU's plain versions, as :func:`train_compare_phase` holds them. Then
    1 + ``timed`` train steps (``static_train_step``: drop path 0.1 from a
    seeded generator, clamp 0.5 + AdamW) at ``batch``: launch counts per
    step against :func:`static_expected`, finite losses, every leaf moved,
    median ms/step and peak memory."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.models.emip_short import SegNetwork
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.state import ClampAdamW
    from emip_tpu_torch.train.static import static_train_step

    model = seeded_init_(SegNetwork("pvt_v2_b5", 32), SEED).to(device)
    pvt = model.backbone.feat_net.pvtv2_en
    pvt_cfg = pvt.config
    pvt.config = dataclasses.replace(pvt_cfg, drop_path_rate=0.0)
    rng = np.random.default_rng(SEED + 8)
    one = seeded_batch(rng, 1, size, device)
    one = dict(image=one["image1"], gt=one["gt"])
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    loss_c, grads_c = _static_grads(model, one)
    loss_p, grads_p = _static_grads(cpu_model, {k: v.cpu()
                                                for k, v in one.items()})
    cpu_s = time.perf_counter() - t0
    pvt.config = pvt_cfg
    del cpu_model
    rel = abs(loss_c - loss_p) / max(abs(loss_p), 1e-30)
    rels, worst = grad_relmax(grads_c, grads_p)
    log(f"static loss card {loss_c:.7f} vs CPU {loss_p:.7f}: rel {rel:.3e} "
        f"(tol {TRAIN_LOSS_RTOL}); grads over {len(rels)} leaves: worst "
        f"relmax {worst[0][1]:.3e} (tol {SEG_GRAD_RTOL}); top: "
        + ", ".join(f"{n}={r:.2e}" for n, r in worst)
        + f"; CPU side took {cpu_s:.1f} s")
    bad = [n for n, r in rels.items() if not r <= SEG_GRAD_RTOL]
    if not rel <= TRAIN_LOSS_RTOL or bad:
        raise AssertionError(f"static card disagrees with the CPU: loss rel "
                             f"{rel:.3e}, leaves {bad[:8]}")

    opt = ClampAdamW(model.parameters(), 1e-5, 1e-7, 0.5)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    batches = []
    for _ in range(1 + timed):
        b = seeded_batch(rng, batch, size, device)
        batches.append(dict(image=b["image1"], gt=b["gt"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    times, losses = [], []
    for i, b in enumerate(batches):
        loss, ms = timed_call(lambda: static_train_step(model, opt, b, gen))
        if i > 0:
            times.append(ms)
        losses.append(float(loss))
    launches = dict(K.LAUNCHES)
    want = {k: v * len(batches) for k, v in static_expected(model).items()}
    log(f"static train launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"static launch counts {launches} != {want}")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still or not all(np.isfinite(losses)):
        raise AssertionError(f"static steps: losses {losses}, leaves that "
                             f"did not move {still[:8]}")
    median_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(device)
    per_step = {k: v // len(batches) for k, v in launches.items() if v}
    log(f"static train b5 {size}^2 bs={batch} fp32: losses "
        + " ".join(f"{v:.6f}" for v in losses)
        + f"; median {median_ms:.3f} ms/step over {len(times)} steps -> "
        f"{batch / (median_ms / 1e3):.3f} images/s; peak memory "
        f"{peak / 2**30:.3f} GiB; launches per step {per_step}; "
        f"{len(before)} leaves all moved")
    del opt, model
    return dict(loss_card=loss_c, loss_cpu=loss_p, loss_rel=rel,
                leaves=len(rels), worst=worst, cpu_seconds=cpu_s,
                launches=launches, expected=want, median_ms=median_ms,
                step_ms=times, peak_bytes=peak, losses=losses)


def bf16_train_compare_phase(model, size: int, device,
                             label: str = "bf16 train", must_run=(),
                             config=None, seeds=BF16_COMPARE_SEEDS,
                             loss_larger_gap: bool = False) -> dict:
    """One pair from each of ``seeds``, drop path off, GMFlow
    frozen: the loss values and the seg-loss grads of the trainable leaves
    of the card's bf16 model against the CPU's plain bf16 versions on the
    same weights. At each of BF16_COMPARE_SEEDS each loss within twice the
    card's own bf16-vs-fp32 gap (above zero); over further seeds a single
    loss's gap can fall near zero by chance (G/H at one seed: 1.2e-5 for
    an error of 2.0e-4), so the losses of all pairs are held pooled too:
    the sum of |card bf16 - CPU bf16| within twice the sum of the card's
    gaps. With ``loss_larger_gap`` (the kernel switches' steps) each loss
    is held, as each leaf is, against the larger of the card's and the
    CPU's gaps: a loss is a leaf of one element, and the flow loss,
    piecewise constant in the warp, differs between the card's and the
    CPU's fp32 runs by as much as the card's bf16 gap (J at one seed:
    8.4e-5 against 1.3e-4). Each leaf's max|card bf16 - CPU bf16| within twice the
    larger of the card's and the CPU's own bf16-vs-fp32 gaps on that leaf
    (above zero): the two bf16 runs round apart, and by the triangle
    inequality their difference is at most the sum of their distances from
    fp32 plus the fp32 card-vs-CPU difference, so a leaf of one element
    cannot be held to one run's gap alone. The grads of all leaves taken
    together, by their largest and their mean |difference|, within twice
    the card's gap and within twice the CPU's, which no card kernel
    touches (as tests/test_torch_bf16_train.py holds the port to the JAX
    package). Every leaf above twice the card's gap alone is logged with
    the CPU's gap and the fp32 card-vs-CPU difference. At b5's widths with
    PVT depths BF16_COMPARE_DEPTHS: the CPU's bf16 at full depth takes
    longer than this script's share of the time limit; the timed steps run
    the full b5. ``config`` (by default ``model``'s) gives the kernel
    switches: ``fused_block_max_t`` below the window's tokens runs G and H
    in place of B, the 512^2 train step's path at a size the CPU can
    afford. The card's bf16 runs must launch each kernel of ``must_run``
    and nothing in fp32 but E and I."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS
    from emip_tpu_torch.train.state import freeze_gmflow

    pvt = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b5"],
                              depths=BF16_COMPARE_DEPTHS, drop_path_rate=0.0)
    cfg = dataclasses.replace(config or model.config, backbone_name=pvt)
    t0 = time.perf_counter()
    fp32 = seeded_init_(EMIPShort(cfg), SEED)
    card16 = EMIPShort(cfg, dtype=torch.bfloat16)
    card16.load_state_dict(fp32.state_dict())
    models = dict(card32=(fp32, device), card16=(card16, device),
                  cpu16=(copy.deepcopy(card16), "cpu"),
                  cpu32=(copy.deepcopy(fp32), "cpu"))
    for m, dev in models.values():
        freeze_gmflow(m)
        m.to(dev)
    out, bad = [], []
    pooled_losses = {k: dict(err=0.0, gap=0.0)
                     for k in ("loss_pred", "loss_flow")}
    for seed in seeds:
        batch = seeded_batch(np.random.default_rng(seed), 1, size, device)
        runs = {}
        for name, (m, dev) in models.items():
            K.reset_launches()
            runs[name] = _seg_grads(m, {k: v.to(dev)
                                        for k, v in batch.items()})
            if name == "card16":
                torch.cuda.synchronize()
                launched = {k: v for k, v in K.LAUNCHES.items() if v}
                fp32 = [k for k in launched if not k.endswith("_bf16")
                        and k not in FP32_IN_BOTH_BANDS]
                idle = [k for k in must_run if k not in launched]
                if fp32 or idle:
                    raise AssertionError(f"{label}: the card's bf16 run "
                                         f"launched {launched}: fp32 {fp32}, "
                                         f"not {idle}")
        losses = {n: r[0] for n, r in runs.items()}
        for k in ("loss_pred", "loss_flow"):
            a, b, c, d = (losses[n][k]
                          for n in ("card16", "cpu16", "card32", "cpu32"))
            gap = max(abs(a - c), abs(b - d)) if loss_larger_gap else abs(
                a - c)
            pooled_losses[k]["err"] += abs(a - b)
            pooled_losses[k]["gap"] += gap
            gated = seed in BF16_COMPARE_SEEDS
            log(f"{label} seed {seed} {k}: card bf16 {a:.7f} CPU bf16 "
                f"{b:.7f} card fp32 {c:.7f} CPU fp32 {d:.7f}: |card - CPU| "
                f"{abs(a - b):.3e}, card gap {abs(a - c):.3e}, CPU gap "
                f"{abs(b - d):.3e} ({'limit 2 x the ' if gated else 'pooled '}"
                f"{'larger' if loss_larger_gap else 'card'} gap)")
            if gated and not (gap > 0 and abs(a - b) <= 2 * gap):
                bad.append(f"seed {seed} {k}")
        g16, gp16, g32, gp32 = (runs[n][1] for n in ("card16", "cpu16",
                                                     "card32", "cpu32"))
        if not set(g16) == set(gp16) == set(g32) == set(gp32):
            raise AssertionError("bf16 card, CPU and fp32 grads cover "
                                 "different leaves")

        def amax(a, b):
            return (a - b).abs().max().item()

        leaves = {n: dict(err=amax(g16[n], gp16[n]), card=amax(g16[n],
                                                               g32[n]),
                          cpu=amax(gp16[n], gp32[n]), fp32=amax(g32[n],
                                                                gp32[n]))
                  for n in g16}
        for v in leaves.values():
            v["ratio"] = v["err"] / max(v["card"], v["cpu"], 1e-30)
            v["card_ratio"] = v["err"] / max(v["card"], 1e-30)
            v["cpu_ratio"] = v["err"] / max(v["cpu"], 1e-30)
        held = [n for n, v in leaves.items()
                if not (max(v["card"], v["cpu"]) > 0 and v["ratio"] <= 2)]
        bad += [f"seed {seed} {n}" for n in held]
        pooled, pbad = pooled_gaps(f"seed {seed}", g16, gp16, g32, gp32)
        bad += pbad

        def top(key, k=3):
            return ", ".join(f"{n}={leaves[n][key]:.2f}" for n in sorted(
                leaves, key=lambda n: -leaves[n][key])[:k])

        log(f"{label} seed {seed} seg-loss grads over {len(leaves)} "
            f"leaves (b5 widths, PVT depths {BF16_COMPARE_DEPTHS}): all "
            f"together |card bf16 - CPU bf16| max {pooled['err_max']:.3e} "
            f"mean {pooled['err_mean']:.3e}; card gap max "
            f"{pooled['card_max']:.3e} mean {pooled['card_mean']:.3e}; CPU "
            f"gap max {pooled['cpu_max']:.3e} mean {pooled['cpu_mean']:.3e} "
            f"(limit 2 x each). Per leaf against the larger gap (limit 2): "
            f"{top('ratio')}; against the card's alone: {top('card_ratio')};"
            f" against the CPU's alone: {top('cpu_ratio')}")
        for n, v in sorted(leaves.items(), key=lambda kv: -kv[1]["ratio"]):
            if v["card_ratio"] > 2:
                log(f"  leaf {n} above 2 x the card's gap: |card bf16 - CPU "
                    f"bf16| {v['err']:.3e}, card gap {v['card']:.3e}, CPU gap "
                    f"{v['cpu']:.3e}, |card fp32 - CPU fp32| "
                    f"{v['fp32']:.3e}: {v['ratio']:.3f} x the larger gap")
        worst = sorted(leaves.items(), key=lambda kv: -kv[1]["ratio"])[:5]
        out.append(dict(seed=seed, losses=losses, grads=pooled,
                        leaves=len(leaves), worst=worst,
                        above_card_2x={n: v for n, v in leaves.items()
                                       if v["card_ratio"] > 2}))
    for k, v in pooled_losses.items():
        v["ratio"] = v["err"] / max(v["gap"], 1e-30)
        log(f"{label} {k} pooled over {len(seeds)} pairs: sum |card bf16 - "
            f"CPU bf16| {v['err']:.3e}, sum of the "
            f"{'larger' if loss_larger_gap else 'card'} gaps {v['gap']:.3e}: "
            f"{v['ratio']:.3f} x (limit 2)")
        if not (v["gap"] > 0 and v["ratio"] <= 2):
            bad.append(f"{k} pooled")
    seconds = time.perf_counter() - t0
    log(f"{label} card against CPU: {len(seeds)} pairs in "
        f"{seconds:.1f} s, card launches {launched} "
        f"{'MISMATCH' if bad else 'ok'}")
    del models, fp32, card16
    if bad:
        raise AssertionError(f"{label}: bf16 card disagrees with the CPU: "
                             f"{bad[:8]}")
    return dict(pairs=out, seconds=seconds, depths=BF16_COMPARE_DEPTHS,
                seeds=list(seeds), pooled_losses=pooled_losses,
                launches=launched)


def pooled_gaps(label: str, card16: dict, cpu16: dict, card32: dict,
                cpu32: dict) -> tuple[dict, list]:
    """All leaves' grads taken together: the largest and the mean |card
    bf16 - CPU bf16| against twice those of the card's and of the CPU's
    own bf16-vs-fp32 gaps (each above zero)."""
    import torch

    pooled, bad = {}, []
    for key, (a, b) in dict(err=(card16, cpu16), card=(card16, card32),
                            cpu=(cpu16, cpu32)).items():
        diff = torch.cat([(a[n].float().cpu() - b[n].float().cpu()).abs()
                          .flatten() for n in card16])
        pooled[key + "_max"] = diff.max().item()
        pooled[key + "_mean"] = diff.mean().item()
    for gap in ("card", "cpu"):
        if not (pooled[gap + "_max"] > 0
                and pooled["err_max"] <= 2 * pooled[gap + "_max"]
                and pooled["err_mean"] <= 2 * pooled[gap + "_mean"]):
            bad.append(f"{label} all leaves against the {gap} gap")
    return pooled, bad


def bf16_step_turns(label: str, step16, step32, timed: int, device,
                    want: dict) -> dict:
    """One warm-up fp32 step, then ``timed`` steps of each in turns (fp32,
    bf16, bf16, fp32; CUDA-event ms each, medians); the first bf16 turn and
    one warm-up bf16 step before it counted from zero launches, which must
    equal ``want``, with that run's peak memory. ``speedup`` is the fp32
    median over the bf16 one, ``speedup_halves`` the same from the first
    two turns and from the last two: where the three do not lie on one
    side of 1 the call does not tell which band is faster."""
    import torch

    from emip_tpu_torch import kernels as K

    def turn(step):
        return [timed_call(step)[1] for _ in range(timed)]

    step32()
    t32 = turn(step32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    step16()
    t16 = turn(step16)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    t16 += turn(step16)
    t32 += turn(step32)
    log(f"{label} launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches} != {want}")
    med = statistics.median
    halves = (med(t32[:timed]) / med(t16[:timed]),
              med(t32[timed:]) / med(t16[timed:]))
    return dict(launches=launches, expected=want,
                median_ms=med(t16), step_ms=t16,
                fp32_median_ms=med(t32), fp32_step_ms=t32,
                speedup=med(t32) / med(t16), speedup_halves=halves,
                peak_bytes=peak)


def bf16_steps_moved(label: str, model, before: dict, losses: list) -> int:
    """Finite losses, every parameter still fp32, and every leaf of
    ``before`` that has a grad moved from its value there; the number of
    such leaves."""
    import torch

    if not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    moved = [(n, not torch.equal(p.detach(), before[n]))
             for n, p in model.named_parameters()
             if n in before and p.grad is not None]
    still = [n for n, ok in moved if not ok]
    if still or not moved:
        raise AssertionError(f"{label}: leaves with a grad that did not "
                             f"move: {still[:8]}")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError(f"{label}: a parameter is not fp32")
    return len(moved)


def bf16_train_phase(model, batch: int, size: int, device,
                     timed: int) -> dict:
    """The full b5 EMIPShort in bf16 (``EMIPShort(cfg, dtype=bfloat16)`` on
    the fp32 train phase's weights) takes train steps at ``batch``, in
    turns with the fp32 model's (:func:`bf16_step_turns`; the bf16 forwards
    and backwards of A-D, at 512^2 of A, C, D, G and H, and E's, no fp32
    kernel but E), each model with its own clamp + AdamW and seeded drop
    path; then the device's busy time per step of each (two profiled
    steps). GMFlow stays bit-identical, every trainable leaf with a grad
    moves, the losses are finite."""
    import torch

    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    model16 = EMIPShort(model.config, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    model16 = model16.to(device)
    opt16, opt32 = build_optimizer(model16), build_optimizer(model)
    gmflow0 = {k: v.clone() for k, v in model16.GMFlow.state_dict().items()}
    trainable0 = {n: p.detach().clone()
                  for n, p in model16.named_parameters() if p.requires_grad}
    gen16 = torch.Generator(device=device).manual_seed(SEED)
    gen32 = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED + 5)  # the fp32 train phase's batches
    batches = [seeded_batch(rng, batch, size, device) for _ in range(2)]
    next16, next32 = itertools.cycle(batches), itertools.cycle(batches)
    losses = []

    def step16():
        m = short_train_step(model16, opt16, next(next16), gen16)
        losses.append({k: float(v) for k, v in m.items()})

    def step32():
        short_train_step(model, opt32, next(next32), gen32)

    want = {k: v * (1 + timed)
            for k, v in expected_launches_bf16(model16, True).items()}
    res = bf16_step_turns("bf16 train", step16, step32, timed, device, want)
    busy16 = device_ms(step16, 2)
    busy32 = device_ms(step32, 2)
    with_grad = bf16_steps_moved("bf16 train", model16, trainable0,
                                 [v for m in losses for v in m.values()])
    gm = model16.GMFlow.state_dict()
    if any(not torch.equal(gm[k], v) for k, v in gmflow0.items()):
        raise AssertionError("bf16 train: a frozen GMFlow tensor changed")
    ms16 = res["median_ms"]
    log(f"train b5 {size}^2 bs={batch} bf16: losses "
        + " ".join(f"{m['loss']:.6f}" for m in losses)
        + f"; median {ms16:.3f} ms/step -> {batch / (ms16 / 1e3):.3f} "
        f"pairs/s; " + _busy_line(res, busy16, busy32)
        + f"; {with_grad} trainable leaves with grads all moved, GMFlow "
        f"bit-identical")
    del opt16, opt32, model16
    return dict(res, device_busy_ms=busy16, fp32_device_busy_ms=busy32,
                pairs_per_s=batch / (ms16 / 1e3), losses=losses,
                leaves_with_grad=with_grad)


def bf16_static_phase(batch: int, size: int, device, timed: int) -> dict:
    """SegNetwork (pvt_v2_b5, channel 32) in bf16 and fp32 on the same
    seeded weights: bf16 static train steps in turns with the fp32 model's
    (:func:`bf16_step_turns`; A's bf16 forward and backward 52 each a step,
    nothing else); finite losses, every leaf moved, fp32 parameters."""
    import torch

    from emip_tpu_torch.models.emip_short import SegNetwork
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.state import ClampAdamW
    from emip_tpu_torch.train.static import static_train_step

    m32 = seeded_init_(SegNetwork("pvt_v2_b5", 32), SEED)
    m16 = SegNetwork("pvt_v2_b5", 32, dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    m32, m16 = m32.to(device), m16.to(device)
    opt16 = ClampAdamW(m16.parameters(), 1e-5, 1e-7, 0.5)
    opt32 = ClampAdamW(m32.parameters(), 1e-5, 1e-7, 0.5)
    before = {n: p.detach().clone() for n, p in m16.named_parameters()}
    rng = np.random.default_rng(SEED + 8)
    batches = []
    for _ in range(2):
        b = seeded_batch(rng, batch, size, device)
        batches.append(dict(image=b["image1"], gt=b["gt"]))
    gen16 = torch.Generator(device=device).manual_seed(SEED)
    gen32 = torch.Generator(device=device).manual_seed(SEED)
    next16, next32 = itertools.cycle(batches), itertools.cycle(batches)
    losses = []

    def step16():
        losses.append(float(static_train_step(m16, opt16, next(next16),
                                              gen16)))

    def step32():
        static_train_step(m32, opt32, next(next32), gen32)

    per32 = static_expected(m16)
    want = {k: 0 for k in per32}
    want.update(sr_attention_bf16=per32["sr_attention"] * (1 + timed),
                sr_attention_bwd_bf16=per32["sr_attention_bwd"] * (1 + timed))
    res = bf16_step_turns("bf16 static train", step16, step32, timed, device,
                          want)
    moved = bf16_steps_moved("bf16 static steps", m16, before, losses)
    if moved != len(before):
        raise AssertionError(f"bf16 static steps: {len(before) - moved} "
                             f"leaves have no grad")
    ms16, ms32 = res["median_ms"], res["fp32_median_ms"]
    per_step = {k: v // (1 + timed) for k, v in res["launches"].items() if v}
    log(f"static train b5 {size}^2 bs={batch} bf16: losses "
        + " ".join(f"{v:.6f}" for v in losses)
        + f"; median {ms16:.3f} ms/step -> {batch / (ms16 / 1e3):.3f} "
        f"images/s; fp32 in the same turns {ms32:.3f} ms/step; bf16 peak "
        f"memory {res['peak_bytes'] / 2**30:.3f} GiB; launches per step "
        f"{per_step}; {moved} leaves all moved")
    del opt16, opt32, m16, m32
    return dict(res, losses=losses)


# the alternate encoders at full published width and depth: SegNetwork at
# 352^2 on seeded weights, then the two-stream model on the two with
# GMFlow's 128-wide /8 stage, DGNet on EfficientNet-B4 and the static
# trainer's entry point on Res2Net in bf16
BACKBONES = ("pvt_v2_b2_li", "pvt_small", "res2net50_26w_4s",
             "efficientnet_b1", "efficientnet_b4")
TWO_STREAM_BACKBONES = ("pvt_v2_b2_li", "pvt_small")
BACKBONE_TIMED = 3      # timed inference batches a band, after a warm-up
BACKBONE_TIMED_SLICE = 2  # the same for the two-stream model
BACKBONE_CPU_BATCH = 2  # images of the card-vs-CPU inference comparison
# card vs CPU: fp32 logits and DGNet's outputs by max|err| / max|ref|;
# the BatchNorm statistics after a train step by max|err| over each
# buffer's scale (_stats_rel)
BACKBONE_REL_MAX = 1e-3
BN_STATS_REL = 1e-4
# the relative nudge of the CPU's image that measures how far fp32
# rounding alone moves each grad of the train step (backbone_seg_phase)
BACKBONE_NUDGE = 1e-6
STATS = ("running_mean", "running_var")


def _bn_stats(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.endswith(STATS)}


def _rel_max(got, ref) -> float:
    return ((got - ref).abs().max().item()
            / max(ref.abs().max().item(), 1e-30))


def _stats_rel(got: dict, ref: dict, key: str) -> float:
    """max|err| of a BatchNorm buffer over its scale: a variance's own
    max|ref|; a mean's the larger of its max|ref| and the square root of
    its layer's largest variance (a centred feature's mean is near zero
    and has no scale of its own: in EfficientNet a running mean of ~1e-7
    takes an error of 2x itself)."""
    err = (got[key] - ref[key]).abs().max().item()
    scale = ref[key].abs().max().item()
    if key.endswith("running_mean"):
        var = ref[key[:-len("running_mean")] + "running_var"]
        scale = max(scale, var.max().item() ** 0.5)
    return err / max(scale, 1e-30)


def backbone_seg_phase(name: str, device, timed: int) -> dict:
    """``SegNetwork(name, 32)`` at 352^2 on seeded weights, fp32 and bf16 on
    the same weights: 1 + ``timed`` batches of 8 a band (launches: A's
    forward, fp32 or bf16, once per block for a PVTv2, nothing else), ms,
    frames/s and peak memory; the first two images card against CPU (fp32
    by BACKBONE_REL_MAX, bf16 within twice the larger of the card's and
    the CPU's bf16-vs-fp32 gaps); then one fp32 train step on one image,
    drop path off, card against CPU: the loss (TRAIN_LOSS_RTOL), every
    leaf's grad (SEG_GRAD_RTOL, scale-floored, or where larger twice the
    most that three nudges of the CPU's image by BACKBONE_NUDGE move that
    grad: at seeded weights the full-depth Res2Net's train-mode grads move
    by up to 26% under one, 4% taken all together) and the BatchNorm
    statistics after it (BN_STATS_REL)."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.models.emip_short import SegNetwork
    from emip_tpu_torch.models.init import seeded_init_

    m32 = seeded_init_(SegNetwork(name, 32), SEED)
    m16 = SegNetwork(name, 32, dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    m32, m16 = m32.to(device).eval(), m16.to(device).eval()
    _, pvt = seg_encoder(m32)
    blocks = sum(pvt.depths) if pvt is not None else 0
    rng = np.random.default_rng(SEED + 50)
    images = [torch.from_numpy(seeded_frames(rng, BATCH, SIZE)).to(device)
              for _ in range(1 + timed)]
    res, first = {}, {}
    for band, model, a_name in (("fp32", m32, "sr_attention"),
                                ("bf16", m16, "sr_attention_bf16")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        K.reset_launches()
        times = []
        with torch.no_grad():
            for i, x in enumerate(images):
                out, ms = timed_call(lambda: model(x))
                if (tuple(out.shape) != (BATCH, 1, SIZE, SIZE)
                        or out.dtype != torch.float32
                        or not torch.isfinite(out).all()):
                    raise AssertionError(f"{name} {band}: logits shape, "
                                         f"dtype or finiteness")
                if i == 0:
                    first[band] = out[:BACKBONE_CPU_BATCH].cpu()
                else:
                    times.append(ms)
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        want = {a_name: blocks * len(images)} if blocks else {}
        if launches != want:
            raise AssertionError(f"{name} {band} launches {launches} != "
                                 f"{want}")
        median_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(device)
        res[band] = dict(median_ms=median_ms, batch_ms=times,
                         frames_per_s=BATCH / (median_ms / 1e3),
                         peak_bytes=peak, launches=launches)
        log(f"backbone {name} SegNetwork {SIZE}^2 bs={BATCH} {band}: median "
            f"{median_ms:.3f} ms/batch over {len(times)} batches -> "
            f"{res[band]['frames_per_s']:.3f} frames/s; peak memory "
            f"{peak / 2**30:.3f} GiB; launches {launches}")

    t0 = time.perf_counter()
    x = images[0][:BACKBONE_CPU_BATCH].cpu()
    with torch.no_grad():
        cpu = {band: copy.deepcopy(m).cpu()(x)
               for band, m in (("fp32", m32), ("bf16", m16))}
    rel32 = _rel_max(first["fp32"], cpu["fp32"])
    gap_card = (first["bf16"] - first["fp32"]).abs().max().item()
    gap_cpu = (cpu["bf16"] - cpu["fp32"]).abs().max().item()
    err16 = (first["bf16"] - cpu["bf16"]).abs().max().item()
    ok = (rel32 <= BACKBONE_REL_MAX and gap_card > 0 and gap_cpu > 0
          and err16 <= 2 * max(gap_card, gap_cpu))
    res["compare"] = dict(fp32_rel_to_max=rel32, bf16_card_vs_cpu=err16,
                          bf16_gap_card=gap_card, bf16_gap_cpu=gap_cpu,
                          cpu_seconds=time.perf_counter() - t0, ok=ok)
    log(f"backbone {name} card vs CPU ({BACKBONE_CPU_BATCH} images): fp32 "
        f"max|err|/max|ref| {rel32:.3e} (limit {BACKBONE_REL_MAX}); bf16 "
        f"max|err| {err16:.3e}, bf16-vs-fp32 gaps card {gap_card:.3e} CPU "
        f"{gap_cpu:.3e} (limit 2 x the larger) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: card disagrees with the CPU: "
                             f"{res['compare']}")
    del m16

    encoder, _ = seg_encoder(m32)
    if hasattr(encoder.config, "drop_path_rate"):
        encoder.config = dataclasses.replace(encoder.config,
                                             drop_path_rate=0.0)
    b = seeded_batch(rng, 1, SIZE, device)
    one = dict(image=b["image1"], gt=b["gt"])
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(m32).cpu()
    cpu_one = {k: v.cpu() for k, v in one.items()}
    # the CPU's grads from the image scaled by 1 + nudge, 1 - nudge and
    # 1 + nudge x (a seeded normal per pixel)
    noise = torch.from_numpy(rng.standard_normal(
        tuple(cpu_one["image"].shape)).astype(np.float32))
    moves = []
    for factor in (1 + BACKBONE_NUDGE, 1 - BACKBONE_NUDGE,
                   1 + BACKBONE_NUDGE * noise):
        moves.append(_static_grads(copy.deepcopy(cpu_model), dict(
            cpu_one, image=cpu_one["image"] * factor))[1])
    loss_c, grads_c = _static_grads(m32, one)
    loss_p, grads_p = _static_grads(cpu_model, cpu_one)
    stats_c, stats_p = _bn_stats(m32), _bn_stats(cpu_model)
    rel = abs(loss_c - loss_p) / max(abs(loss_p), 1e-30)
    rels, worst = grad_relmax(grads_c, grads_p)
    moves = [grad_relmax(g, grads_p)[0] for g in moves]
    moved = {n: max(m[n] for m in moves) for n in rels}
    limit = {n: max(SEG_GRAD_RTOL, 2 * moved[n]) for n in rels}
    stats = max(((_stats_rel(stats_c, stats_p, k), k) for k in stats_p),
                default=(0.0, ""))
    bad = [n for n, r in rels.items() if not r <= limit[n]]
    banded = sorted(((rels[n], moved[n], n) for n in rels
                     if rels[n] > SEG_GRAD_RTOL), reverse=True)
    ok = rel <= TRAIN_LOSS_RTOL and not bad and stats[0] <= BN_STATS_REL
    res["train_compare"] = dict(loss_card=loss_c, loss_cpu=loss_p,
                                loss_rel=rel, leaves=len(rels), worst=worst,
                                nudge_worst=max(moved.values()),
                                above_tol_in_nudge_band=banded,
                                bn_buffers=len(stats_p), bn_worst=stats,
                                cpu_seconds=time.perf_counter() - t0, ok=ok)
    log(f"backbone {name} train step card vs CPU (1 image): loss "
        f"{loss_c:.7f} vs {loss_p:.7f} rel {rel:.3e} (tol "
        f"{TRAIN_LOSS_RTOL}); grads over {len(rels)} leaves: worst relmax "
        f"{worst[0][1]:.3e} (tol {SEG_GRAD_RTOL}, or 2 x the most three "
        f"{BACKBONE_NUDGE} nudges move it, worst move "
        f"{max(moved.values()):.3e}) top "
        + ", ".join(f"{n}={r:.2e}" for n, r in worst)
        + f"; {len(banded)} leaves above {SEG_GRAD_RTOL} within their "
        f"nudge band"
        + "".join(f", {n} {r:.2e} (moved {m:.2e})"
                  for r, m, n in banded[:3])
        + f"; {len(stats_p)} BatchNorm buffers after the step: worst "
        f"{stats[0]:.3e} {stats[1]} (tol {BN_STATS_REL}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name} train step: card disagrees with the "
                             f"CPU: loss rel {rel:.3e}, leaves {bad[:8]}, "
                             f"statistics {stats}")
    return res


def dgnet_phase(device) -> dict:
    """DGNet (EfficientNet-B4, channel 32) at 352^2, batch 8, on seeded
    weights: one timed forward after a warm-up (no kernel of the port),
    and both outputs card against CPU by BACKBONE_REL_MAX."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.models.dgnet import DGNet
    from emip_tpu_torch.models.init import seeded_init_

    model = seeded_init_(DGNet(), SEED).to(device).eval()
    rng = np.random.default_rng(SEED + 51)
    x = torch.from_numpy(seeded_frames(rng, BATCH, SIZE)).to(device)
    K.reset_launches()
    with torch.no_grad():
        model(x)
        got, ms = timed_call(lambda: model(x))
        t0 = time.perf_counter()
        ref = copy.deepcopy(model).cpu()(x.cpu())
    cpu_s = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    rels = [_rel_max(g.cpu(), r) for g, r in zip(got, ref)]
    ok = (not launches and all(r <= BACKBONE_REL_MAX for r in rels)
          and all(tuple(g.shape) == (BATCH, 1, SIZE, SIZE) for g in got))
    log(f"dgnet efficientnet_b4 {SIZE}^2 bs={BATCH} fp32: {ms:.3f} ms a "
        f"forward; card vs CPU max|err|/max|ref| context {rels[0]:.3e}, "
        f"texture {rels[1]:.3e} (limit {BACKBONE_REL_MAX}); launches "
        f"{launches}; CPU side {cpu_s:.1f} s {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"DGNet: card vs CPU {rels}, launches "
                             f"{launches}")
    return dict(ms=ms, rel_to_max=rels, cpu_seconds=cpu_s)


def backbones_phase(device) -> dict:
    """The alternate encoders (BACKBONES) in SegNetwork, DGNet, and the
    two-stream model on TWO_STREAM_BACKBONES through the slice phases
    (fp32 and bf16 inference at 352^2, batch 8: A 32, B 6, C 3, D 1 a
    batch for the linear PVTv2, A none for PVT-v1; one pair card against
    CPU in each band)."""
    import torch

    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_

    t0 = time.perf_counter()
    out = {name: backbone_seg_phase(name, device, BACKBONE_TIMED)
           for name in BACKBONES}
    torch.cuda.empty_cache()
    out["dgnet"] = dgnet_phase(device)
    for name in TWO_STREAM_BACKBONES:
        model = seeded_init_(EMIPShort(EMIPShortConfig(
            backbone_name=name, inp_size=SIZE)), SEED).to(device).eval()
        fp32 = slice_phase(model, BATCH, SIZE, device, BACKBONE_TIMED_SLICE,
                           name)
        bf16, model16 = bf16_slice_phase(model, BATCH, SIZE, device,
                                         BACKBONE_TIMED_SLICE, fp32, name)
        out[f"two_stream_{name}"] = dict(fp32=fp32, bf16=bf16)
        del model, model16
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"backbones phase took {out['seconds']:.1f} s")
    return out


def backbone_entry_phase(size: int) -> dict:
    """``python -m emip_tpu_torch.train_static`` (in process) from a YAML
    naming ``res2net50_26w_4s`` with ``compute_dtype: bfloat16``: one step
    at batch 8 on synthetic images, TF32 and the bf16 reduction on before
    the call and off after it, no kernel of the port launched (Res2Net has
    none), a checkpoint of fp32 tensors that loads into an fp32 model."""
    import torch
    import yaml

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.data import make_synthetic_static_root
    from emip_tpu_torch.models.emip_short import SegNetwork
    from emip_tpu_torch.train_static import main as static_main

    work = os.path.join(ROOT, "build", "chip_smoke_backbone")
    root = make_synthetic_static_root(os.path.join(work, "data"),
                                      num_images=BATCH, seed=SEED)
    cfg = os.path.join(work, "static.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(dict(
            train_dataset=dict(image_path=root, inp_size=size,
                               batch_size=BATCH),
            model=dict(args=dict(inp_size=size,
                                 backbone_name="res2net50_26w_4s",
                                 channel=32)),
            optimizer=dict(lr=1.0e-5, weight_decay=1.0e-7), clip=0.5,
            compute_dtype="bfloat16", seed=SEED, epoch=2,
            save_path=os.path.join(work, "run")), f)
    K.reset_launches()
    tf32_on()
    t0 = time.perf_counter()
    summary = static_main(["--config", cfg, "--data_root", root,
                           "--max_steps_per_epoch", "1"])
    dt = time.perf_counter() - t0
    tf32_checked_off("entry python -m emip_tpu_torch.train_static "
                     "res2net50_26w_4s (bf16)")
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    state = torch.load(os.path.join(work, "run", "static", "ckpt",
                                    "ckpt.pt"), map_location="cpu")["model"]
    fp32_state = all(v.dtype in (torch.float32, torch.int64)
                     for v in state.values())
    SegNetwork("res2net50_26w_4s", 32).load_state_dict(state)
    ok = (summary["steps"] == 1 and np.isfinite(summary["last_loss"])
          and fp32_state and not launches)
    log(f"entry python -m emip_tpu_torch.train_static res2net50_26w_4s "
        f"compute_dtype=bfloat16 {size}^2 bs={BATCH}: {summary['steps']} "
        f"step, loss {summary['last_loss']:.6f}, checkpoint of fp32 tensors "
        f"loads into an fp32 model, launches {launches}, {dt:.1f} s "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"res2net bf16 train_static entry: {summary}, "
                             f"launches {launches}")
    return dict(summary=summary, seconds=dt)


def bf16_train_entry_phase(entry: dict, chain: dict, size: int) -> dict:
    """``python -m emip_tpu_torch.train`` and ``... train_static`` (in
    process) with the YAMLs saying ``compute_dtype: bfloat16``, on the
    train phase's synthetic root and the entry chain's static root, b5 at
    ``size``: each with TF32 and the bf16 reduced-precision reduction on
    before the call and checked off after it, launching the bf16 kernels of
    its model and none of their fp32 ones, and writing a checkpoint of fp32
    tensors that loads into an fp32 model."""
    import torch
    import yaml

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.train.__main__ import main as train_main
    from emip_tpu_torch.train_static import main as static_main

    work = entry["work"]
    out = {}
    for label, src, kernels in (
            ("train", entry["config"], FWD_KERNELS),
            ("train_static", chain["static_config"], ("sr_attention",))):
        with open(src) as f:
            raw = yaml.safe_load(f)
        raw["compute_dtype"] = "bfloat16"
        raw["save_path"] = os.path.join(work, f"run_{label}_bf16")
        cfg = os.path.join(work, f"{label}_bf16.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump(raw, f)
        K.reset_launches()
        tf32_on()
        t0 = time.perf_counter()
        if label == "train":
            summary = train_main(["--config", cfg, "--max_steps_per_epoch",
                                  "2"])
            ckpt = os.path.join(raw["save_path"], "ckpt", "ckpt.pt")
        else:
            summary = static_main(["--config", cfg, "--data_root",
                                   chain["static_root"],
                                   "--max_steps_per_epoch", "2"])
            ckpt = os.path.join(raw["save_path"], "static", "ckpt",
                                "ckpt.pt")
        dt = time.perf_counter() - t0
        tf32_checked_off(f"entry python -m emip_tpu_torch.{label} (bf16)")
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        state = torch.load(ckpt, map_location="cpu")["model"]
        fp32_state = all(v.dtype in (torch.float32, torch.int64)
                         for v in state.values())
        _, unexpected = EMIPShort(load_config(cfg).model).load_state_dict(
            state, strict=label == "train")
        ok = (summary["steps"] == 2 and fp32_state and not unexpected
              and all(K.LAUNCHES[k + "_bf16"] > 0 for k in kernels)
              and all(K.LAUNCHES[k + "_bwd_bf16"] > 0 for k in kernels)
              and not any(K.LAUNCHES[k] or K.LAUNCHES[k + "_bwd"]
                          for k in FWD_KERNELS))
        log(f"entry python -m emip_tpu_torch.{label} compute_dtype=bfloat16 "
            f"b5 {size}^2: {summary['steps']} steps, checkpoint of fp32 "
            f"tensors {'loads' if ok else 'FAILED'} into an fp32 model, "
            f"launches {launches}, {dt:.1f} s {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"bf16 {label} entry point: {summary}, "
                                 f"launches {launches}")
        out[label] = dict(summary=summary, launches=launches, seconds=dt)
    return out


def bf16_train512_entry_phase(entry: dict) -> dict:
    """``python -m emip_tpu_torch.train`` (in process) with the train
    phase's YAML at 512^2 (the model's and both datasets' ``inp_size``,
    batch TRAIN_BATCH_512) saying ``compute_dtype: bfloat16``, on its
    synthetic root: one step, validation, TF32 and the bf16
    reduced-precision reduction on before the call and checked off after
    it; the bf16 kernels of the 512^2 path launched (A, C, D, G and H,
    forward and backward), none of their fp32 ones and no B; a checkpoint
    of fp32 tensors that loads into an fp32 model."""
    import torch
    import yaml

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.train.__main__ import main as train_main

    work = entry["work"]
    with open(entry["config"]) as f:
        raw = yaml.safe_load(f)
    raw["compute_dtype"] = "bfloat16"
    raw["model"]["args"]["inp_size"] = SIZE_512
    for ds in ("train_dataset", "val_dataset"):
        raw[ds]["inp_size"] = SIZE_512
    raw["train_dataset"]["batch_size"] = TRAIN_BATCH_512
    raw["save_path"] = os.path.join(work, "run_train_bf16_512")
    cfg = os.path.join(work, "train_bf16_512.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    K.reset_launches()
    tf32_on()
    t0 = time.perf_counter()
    summary = train_main(["--config", cfg, "--max_steps_per_epoch", "1"])
    dt = time.perf_counter() - t0
    tf32_checked_off("entry python -m emip_tpu_torch.train (bf16, 512^2)")
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    state = torch.load(os.path.join(raw["save_path"], "ckpt", "ckpt.pt"),
                       map_location="cpu")["model"]
    fp32_state = all(v.dtype in (torch.float32, torch.int64)
                     for v in state.values())
    EMIPShort(load_config(cfg).model).load_state_dict(state)
    path = [k for k in FWD_KERNELS if k != "window_attention_block"] + [
        "window_attention_layer", "window_attention_ffn_layer"]
    fp32 = [k for k in launches if not k.endswith("_bf16")
            and k not in FP32_IN_BOTH_BANDS]
    ok = (summary["steps"] == 1 and np.isfinite(summary["best_mae"])
          and fp32_state and not fp32
          and all(K.LAUNCHES[k + "_bf16"] and K.LAUNCHES[k + "_bwd_bf16"]
                  for k in path)
          and not K.LAUNCHES["window_attention_block_bf16"])
    log(f"entry python -m emip_tpu_torch.train compute_dtype=bfloat16 b5 "
        f"{SIZE_512}^2 bs={TRAIN_BATCH_512}: {summary['steps']} step, val "
        f"MAE {summary['best_mae']:.5f}, checkpoint of fp32 tensors "
        f"{'loads' if fp32_state else 'FAILED'} into an fp32 model, launches "
        f"{launches}, {dt:.1f} s {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"bf16 train entry point at 512^2: {summary}, "
                             f"launches {launches}")
    return dict(summary=summary, launches=launches, seconds=dt)


def _count_files(path: str, ext: str) -> int:
    return sum(f.endswith(ext) for _, _, fs in os.walk(path) for f in fs)


def entry_chain_phase(entry: dict, batch: int, size: int) -> dict:
    """train -> test -> evaluate, the flow images and the static trainer,
    each through its ``python -m`` entry point (in process), with TF32 on
    before each call that runs a model and checked off after it (the
    evaluator runs none: host numpy). On :func:`entry_phase`'s
    root and checkpoint: ``emip_tpu_torch.test`` writes a PNG per pair;
    ``emip_tpu_torch.eval_offline`` scores them (all 17 metrics finite and
    in [0, 1]; ``frames - 2`` GT frames a video, MoCA's rule; S-measure,
    wFm and MAE equal to the means of ``metrics.frame_scores`` on the same
    files to 1e-12) and the GT against itself (S-measure 1, MAE 0, and
    Dice and IoU 1 at their best threshold); ``emip_tpu_torch.test_of``
    writes a JPG per pair. Then ``emip_tpu_torch.train_static`` takes one
    epoch of 2 steps on a 16-image synthetic COD10K-style root at b5,
    ``size``, ``batch``, writing a checkpoint and its log."""
    import contextlib
    import io
    import re
    import shutil

    import yaml
    from PIL import Image

    from emip_tpu_torch.data import make_synthetic_static_root
    from emip_tpu_torch.eval_offline import (
        _METRIC_MODULES,
        frame_exclusion,
    )
    from emip_tpu_torch.eval_offline import main as eval_main
    from emip_tpu_torch.metrics import frame_scores
    from emip_tpu_torch.test import main as test_main
    from emip_tpu_torch.test_of import main as test_of_main
    from emip_tpu_torch.train_static import main as static_main

    work, root, cfg = entry["work"], entry["root"], entry["config"]
    name = os.path.basename(os.path.normpath(root))
    videos = sorted(os.listdir(root))
    frames = {v: len(os.listdir(os.path.join(root, v, "GT"))) for v in videos}
    pairs = sum(n - 1 for n in frames.values())
    out, secs = {}, {}

    def timed(label, fn, *args, runs_a_model=True):
        if runs_a_model:
            tf32_on()
        t0 = time.perf_counter()
        res = fn(*args)
        secs[label] = time.perf_counter() - t0
        if runs_a_model:
            tf32_checked_off(f"entry python -m emip_tpu_torch.{label}")
        return res

    pred = os.path.join(work, "pred")
    timed("test", test_main, ["--config", cfg, "--ckpt", entry["ckpt"],
                              "--save_path", pred, "--data",
                              f"{name}={root}"])
    out["pngs"] = _count_files(os.path.join(pred, name), ".png")
    metrics = list(_METRIC_MODULES)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        scores = timed("eval_offline", eval_main, [
            "--gt_root", os.path.dirname(root.rstrip(os.sep)), "--pred_root",
            pred, "--data", name, "--metrics", *metrics, "--out",
            os.path.join(work, "eval")], runs_a_model=False)[name]
    printed = text.getvalue()
    log(printed.rstrip())
    scored = dict(re.findall(r"sequence (\S+): done \((\d+) frames\)",
                             printed))
    # the means of the training loop's per-frame scores over the same files
    per_video = []
    for v in videos:
        gts = frame_exclusion(sorted(os.listdir(os.path.join(root, v, "GT"))),
                              name)
        per_video.append(np.mean([list(frame_scores(
            np.asarray(Image.open(os.path.join(pred, name, v, g)).convert(
                "L"), np.float64),
            np.asarray(Image.open(os.path.join(root, v, "GT", g)).convert(
                "L"), np.float64)).values()) for g in gts], axis=0))
    wfm, sm, mae = np.mean(per_video, axis=0)
    diffs = {"Smeasure": abs(scores["Smeasure"] - sm),
             "wFmeasure": abs(scores["wFmeasure"] - wfm),
             "MAE": abs(scores["MAE"] - mae)}
    # the GT as its own prediction
    self_pred = os.path.join(work, "gt_as_pred", name)
    for v in videos:
        shutil.copytree(os.path.join(root, v, "GT"),
                        os.path.join(self_pred, v), dirs_exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        self_scores = eval_main([
            "--gt_root", os.path.dirname(root.rstrip(os.sep)), "--pred_root",
            os.path.dirname(self_pred), "--data", name, "--metrics",
            "Smeasure", "MAE", "meanDice", "maxDice", "meanIoU", "maxIoU",
            "--out", os.path.join(work, "eval_self")])[name]
    viz = os.path.join(work, "flow_viz")
    out["jpgs"] = timed("test_of", test_of_main, [
        "--config", cfg, "--ckpt", entry["ckpt"], "--data_root", root,
        "--save_path", viz])
    on_disk = _count_files(viz, ".jpg")

    static_work = os.path.join(ROOT, "build", "chip_smoke_static")
    static_root = make_synthetic_static_root(
        os.path.join(static_work, "data"), num_images=2 * batch, seed=SEED)
    static_cfg = os.path.join(static_work, "static.yaml")
    with open(static_cfg, "w") as f:
        yaml.safe_dump(dict(
            train_dataset=dict(image_path=static_root, inp_size=size,
                               batch_size=batch),
            model=dict(args=dict(inp_size=size, backbone_name="pvt_v2_b5",
                                 channel=32)),
            optimizer=dict(lr=1.0e-5, weight_decay=1.0e-7), clip=0.5,
            compute_dtype="float32", seed=SEED, epoch=2,
            save_path=os.path.join(static_work, "run")), f)
    static = timed("train_static", static_main, [
        "--config", static_cfg, "--data_root", static_root,
        "--max_steps_per_epoch", "2"])
    static_dir = os.path.join(static_work, "run", "static")
    static_ok = (static["steps"] == 2 and np.isfinite(static["last_loss"])
                 and os.path.isfile(os.path.join(static_dir, "ckpt",
                                                 "ckpt.pt"))
                 and os.path.isfile(os.path.join(static_dir,
                                                 "train_static_log.log")))

    bad = []
    if out["pngs"] != pairs:
        bad.append(f"{out['pngs']} PNGs for {pairs} pairs")
    if not all(np.isfinite(x) and 0.0 <= x <= 1.0 for x in scores.values()):
        bad.append(f"scores {scores}")
    if scored != {v: str(frames[v] - 2) for v in videos}:
        bad.append(f"frames scored {scored}, GT frames {frames}")
    if max(diffs.values()) > 1e-12:
        bad.append(f"evaluator against frame_scores {diffs}")
    if not (abs(self_scores["Smeasure"] - 1) < 1e-9
            and self_scores["MAE"] == 0.0 and self_scores["maxDice"] == 1.0
            and self_scores["maxIoU"] == 1.0):
        bad.append(f"GT against itself {self_scores}")
    if not out["jpgs"] == on_disk == pairs:
        bad.append(f"{out['jpgs']} flow images ({on_disk} on disk) for "
                   f"{pairs} pairs")
    if not static_ok:
        bad.append(f"static trainer {static}")
    log(f"entry chain python -m emip_tpu_torch.test: {out['pngs']} PNGs "
        f"({secs['test']:.1f} s); eval_offline over {len(metrics)} metrics "
        f"({secs['eval_offline']:.1f} s): "
        + ", ".join(f"{k} {v:.6f}" for k, v in scores.items())
        + f"; frames scored {scored}; |evaluator - frame_scores| "
        + ", ".join(f"{k} {v:.1e}" for k, v in diffs.items())
        + "; GT against itself " + ", ".join(
            f"{k} {v:.6f}" for k, v in self_scores.items())
        + f"; test_of: {out['jpgs']} JPGs ({secs['test_of']:.1f} s); "
        f"train_static: {static['steps']} steps, loss "
        f"{static['last_loss']:.6f}, checkpoint and log "
        f"{'written' if static_ok else 'MISSING'} "
        f"({secs['train_static']:.1f} s) {'FAILED' if bad else 'ok'}")
    if bad:
        raise AssertionError(f"entry chain failed: {bad}")
    return dict(scores=scores, self_scores=self_scores, frames=scored,
                frame_scores_diff=diffs, seconds=secs, static=static,
                static_root=static_root, static_config=static_cfg, **out)


# ----------------------------------------------------------- long model

LONG_CLIPS = (1, 4)   # clips streamed side by side: the reference protocol
#                       (one video at a time) and the trainer's group of 4
LONG_TIMED = 5


def long_expected(model, frames_encoded: int, pairs: int, reads: int,
                  backward_reads: int = 0) -> dict:
    """Kernel launches of the long model's frozen short-term net and its
    memory read: A (and J) per encoded frame, B or G + H, C, I and D per
    frame pair, F per read (and F's backward per train step); never a
    backward of the short-term net's kernels."""
    per = expected_launches(model.short_term)
    per_frame = ("sr_attention", "dwconv_gelu")  # counted for two frames
    n = {k: v // 2 * frames_encoded if k in per_frame else v * pairs
         for k, v in per.items()}
    n.update(memory_attention=reads, memory_attention_bwd=backward_reads)
    return n


def seeded_clip(rng, clips: int, frames: int, size: int, device):
    """[clips, frames, 3, size, size] normalized seeded frames."""
    import torch

    return torch.from_numpy(
        seeded_frames(rng, clips * frames, size).reshape(
            clips, frames, 3, size, size)).to(device)


def long_infer_phase(model, size: int, device, timed: int) -> dict:
    """Streaming inference of the full EMIPLong: per clip group, frame 0's
    mask from the short-term pair (f0, f1), then ``step_cached`` per frame
    with the encoding and the memory carried; launch counts against the
    structure; frames/s (median of CUDA-event timed steps) and peak
    memory. Then one 3-frame clip on the card against the same weights on
    the CPU through the plain versions: the short mask of frame 0, both
    long masks and the final memory."""
    import torch

    from emip_tpu_torch import kernels as K

    model.eval()
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for clips in LONG_CLIPS:
        steps = 1 + timed + model.memory_size  # fills the ring, then timed
        video = seeded_clip(rng, clips, steps + 1, size, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        K.reset_launches()
        times = []
        with torch.inference_mode():
            enc_prev = model.encode_frame(video[:, 0])
            enc = model.encode_frame(video[:, 1])
            mask0 = model.short_term.pair_from_encodings(enc_prev,
                                                         enc)["mask"]
            mask, state = model.step_encoded(enc_prev, enc,
                                             model.init_memory(clips))
            masks = [mask0, mask]
            for t in range(2, steps + 1):
                (mask, enc, state), ms = timed_call(
                    lambda: model.step_cached(enc, video[:, t], state))
                if t - 1 >= model.memory_size:  # every slot written
                    times.append(ms)
                masks.append(mask)
        launches = dict(K.LAUNCHES)
        want = long_expected(model, steps + 1, steps + 1, steps)
        log(f"long inference clips={clips} launches {launches} "
            f"(expected {want})")
        if launches != want or launches["memory_attention"] == 0:
            raise AssertionError(f"launch counts {launches} != {want}")
        for m in masks:
            if tuple(m.shape) != (clips, 1, size, size) or not bool(
                    torch.isfinite(m).all()):
                raise AssertionError("long mask: wrong shape or non-finite")
        if not bool(state.valid.all()):
            raise AssertionError("the memory ring did not fill")
        median_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(device)
        log(f"long inference b5 {size}^2 clips={clips} fp32: median "
            f"{median_ms:.3f} ms/step over {len(times)} steps (ring full) "
            f"-> {clips / (median_ms / 1e3):.3f} frames/s; peak memory "
            f"{peak / 2**30:.3f} GiB")
        out[f"clips{clips}"] = dict(
            launches=launches, expected=want, median_ms=median_ms,
            step_ms=times, frames_per_s=clips / (median_ms / 1e3),
            peak_bytes=peak)

    # card vs CPU plain versions, one 3-frame clip
    t0 = time.perf_counter()
    video = seeded_clip(np.random.default_rng(SEED + 8), 1, 3, size, device)
    cpu_model = copy.deepcopy(model).cpu()
    got, ref = long_clip(model, video), long_clip(cpu_model, video.cpu())
    out["compare"] = held_to_cpu("long", got, ref)
    log(f"CPU reference clip took {time.perf_counter() - t0:.1f} s")
    return out


def long_clip(model, video) -> dict:
    """Frames 0-2 of ``video`` [1, 3, ...] through the long model: frame 0's
    short mask from the pair (f0, f1), the long masks of frames 1 and 2,
    and the memory's last two slots after them (3 frames encoded, 3 pairs,
    2 memory reads)."""
    import torch

    with torch.inference_mode():
        enc_prev = model.encode_frame(video[:, 0])
        enc = model.encode_frame(video[:, 1])
        mask0 = model.short_term.pair_from_encodings(enc_prev, enc)["mask"]
        mask1, state = model.step_encoded(enc_prev, enc,
                                          model.init_memory(1))
        mask2, _, state = model.step_cached(enc, video[:, 2], state)
    return dict(mask0=mask0, mask_long1=mask1, mask_long2=mask2,
                memory_keys=state.keys[:, -2:],
                memory_values=state.values[:, -2:])


def held_to_cpu(label: str, got: dict, ref: dict, tols=None) -> dict:
    """Each output of the card (``got``) against the CPU's plain versions
    (``ref``) by the slice tolerance (``tols[name]``, else the mask's) and
    max|err| <= SLICE_REL_MAX * max|ref|; raises on a mismatch."""
    import torch

    cmp = {}
    for name in got:
        g, r = got[name].cpu(), ref[name]
        tol = (tols or {}).get(name, SLICE_TOL["mask"])
        err, ref_max = (g - r).abs().max().item(), r.abs().max().item()
        rel = err / ref_max if ref_max > 0 else float("inf")
        ok = (bool(torch.isfinite(g).all()) and torch.allclose(g, r, **tol)
              and rel <= SLICE_REL_MAX)
        cmp[name] = dict(max_abs_err=err, ref_max_abs=ref_max, rel_to_max=rel,
                         tol=tol, rel_max=SLICE_REL_MAX, ok=ok)
        log(f"{label} {name} card vs CPU plain: max_abs_err={err:.3e} (|ref| "
            f"max {ref_max:.3e}) tol={tol}; max|err|/max|ref|={rel:.3e} "
            f"(limit {SLICE_REL_MAX}) {'ok' if ok else 'MISMATCH'}")
    bad = [k for k, v in cmp.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"{label}: card disagrees with the CPU "
                             f"reference: {bad}")
    return cmp


def _long_frame(model, batch: dict):
    """One train-mode frame on a memory that holds the frame before:
    (loss, grads of the trainable leaves)."""
    import torch

    from emip_tpu_torch.losses.seg import hybrid_e_loss

    with torch.no_grad():
        model.eval()
        _, _, state = model.step(batch["f0"], batch["f1"],
                                 model.init_memory(1))
        enc = model.encode_frame(batch["f1"])
    model.train()
    mask, _, _ = model.step_cached(enc, batch["f2"], state)
    loss = hybrid_e_loss(mask, batch["gt"])
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(
        loss, [p for p in model.parameters() if p.requires_grad])
    return float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)}


def long_train_compare_phase(model, size: int, device,
                             label: str = "long train") -> dict:
    """One frame, the seeded weights, card kernels vs CPU plain versions:
    the loss and the grads of every trainable leaf of the long heads
    (through kernel F's backward), by the scale-floored relative max."""
    import torch

    rng = np.random.default_rng(SEED + 9)
    video = seeded_clip(rng, 1, 3, size, device)
    gt = torch.from_numpy((rng.uniform(size=(1, 1, size, size)) > 0.5
                           ).astype(np.float32)).to(device)
    batch = dict(f0=video[:, 0], f1=video[:, 1], f2=video[:, 2], gt=gt)
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    loss_c, grads_c = _long_frame(model, batch)
    loss_p, grads_p = _long_frame(cpu_model,
                                  {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    rel = abs(loss_c - loss_p) / max(abs(loss_p), 1e-30)
    log(f"{label} loss card {loss_c:.7f} vs CPU {loss_p:.7f}: rel "
        f"{rel:.3e} (tol {TRAIN_LOSS_RTOL})")
    rels, worst = grad_relmax(grads_c, grads_p)
    log(f"{label} head grads card vs CPU over {len(rels)} leaves: worst "
        f"relmax {worst[0][1]:.3e} (tol {SEG_GRAD_RTOL}); top: "
        + ", ".join(f"{n}={r:.2e}" for n, r in worst)
        + f"; CPU side took {cpu_s:.1f} s")
    bad = [n for n, r in rels.items() if not r <= SEG_GRAD_RTOL]
    if not rel <= TRAIN_LOSS_RTOL or bad:
        raise AssertionError(f"card disagrees with the CPU reference: loss "
                             f"rel {rel}, leaves {bad[:8]}")
    return dict(loss_card=loss_c, loss_cpu=loss_p, leaves=len(rels),
                worst=worst, cpu_seconds=cpu_s)


def long_train_phase(model, size: int, device, timed: int) -> dict:
    """Per-frame long train steps of the full model, 1 warm-up + ``timed``
    steps per clip group, timed with CUDA events: launch counts per step
    against the structure (one frame encoded, one pair, one memory read
    and its backward; no backward of A-D); every ``short_term`` tensor and
    buffer bit-identical afterwards; every trainable leaf moved."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.train.long import CachedStep, long_train_step
    from emip_tpu_torch.train.state import build_long_optimizer

    opt = build_long_optimizer(model)  # lr 1e-5, wd 1e-7, clamp 0.5
    step = CachedStep(model)
    short0 = {k: v.clone() for k, v in model.short_term.state_dict().items()}
    trainable0 = {n: p.detach().clone() for n, p in model.named_parameters()
                  if p.requires_grad}
    if not trainable0 or any(n.startswith("short_term.") for n in trainable0):
        raise AssertionError("the frozen set is not exactly short_term")
    rng = np.random.default_rng(SEED + 10)
    out = {}
    for clips in reversed(LONG_CLIPS):
        steps = 1 + timed
        video = seeded_clip(rng, clips, steps + 1, size, device)
        gts = torch.from_numpy(
            (rng.uniform(size=(clips, steps + 1, 1, size, size)) > 0.5
             ).astype(np.float32)).to(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        K.reset_launches()
        times, losses = [], []
        state = model.init_memory(clips)
        enc = model.encode_frame(video[:, 0])
        for t in range(1, steps + 1):
            (metrics, enc, state), ms = timed_call(
                lambda: long_train_step(step, opt, enc, video[:, t],
                                        gts[:, t], state))
            if t > 1:
                times.append(ms)
            losses.append(float(metrics["loss"]))
        launches = dict(K.LAUNCHES)
        want = long_expected(model, steps + 1, steps, steps, steps)
        log(f"long train clips={clips} launches {launches} (expected {want})")
        if launches != want or 0 in (launches["memory_attention"],
                                     launches["memory_attention_bwd"]):
            raise AssertionError(f"launch counts {launches} != {want}")
        log(f"long train clips={clips} losses "
            + " ".join(f"{v:.6f}" for v in losses))
        if not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite long losses: {losses}")
        median_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(device)
        log(f"long train b5 {size}^2 clips={clips} fp32: median "
            f"{median_ms:.3f} ms/step over {len(times)} steps -> "
            f"{median_ms / clips:.3f} ms/frame; peak memory "
            f"{peak / 2**30:.3f} GiB")
        out[f"clips{clips}"] = dict(
            launches=launches, expected=want, median_ms=median_ms,
            step_ms=times, ms_per_frame=median_ms / clips, peak_bytes=peak,
            losses=losses)
    short = model.short_term.state_dict()
    changed = [k for k, v in short0.items() if not torch.equal(short[k], v)]
    still = [n for n, p in model.named_parameters()
             if p.requires_grad and torch.equal(p.detach(), trainable0[n])]
    if changed or still or model.short_term.training:
        raise AssertionError(f"short_term tensors changed: {changed[:8]}; "
                             f"trainable leaves that did not move: "
                             f"{still[:8]}")
    log(f"long train: {len(trainable0)} trainable leaves all moved, "
        f"{len(short0)} short_term tensors and buffers bit-identical")
    out["leaves"] = len(trainable0)
    out["short_term_tensors"] = len(short0)
    return out


def long_entry_phase(size: int) -> dict:
    """``python -m emip_tpu_torch.train_long`` and ``... test_long`` (in
    process) on a synthetic root that the port writes: b5 at 352^2, one
    epoch over 2 videos x 3 frames (4 per-frame steps), validation,
    checkpoints; then streaming prediction of both videos from the
    checkpoint. TF32 is on before each call and must be off after it."""
    import yaml

    from emip_tpu_torch.data import make_synthetic_video_root
    from emip_tpu_torch.test_long import main as test_long_main
    from emip_tpu_torch.train_long import main as train_long_main

    work = os.path.join(ROOT, "build", "chip_smoke_long")
    root = make_synthetic_video_root(os.path.join(work, "data"),
                                     num_videos=2, frames_per_video=6,
                                     seed=SEED)
    ds = dict(image_path=root, gt_path=root, inp_size=size, batch_size=1,
              dataset_type="MoCA")
    cfg = dict(train_dataset=ds, val_dataset=ds,
               model=dict(args=dict(inp_size=size,
                                    backbone_name="pvt_v2_b5", channel=32)),
               optimizer=dict(lr=1.0e-5, weight_decay=1.0e-7), clip=0.5,
               memory_size=5, seed=SEED, epoch=2, epoch_val=1, epoch_save=1,
               compute_dtype="float32", save_path=os.path.join(work, "run"))
    os.makedirs(work, exist_ok=True)
    cfg_path = os.path.join(work, "long.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    tf32_on()
    t0 = time.perf_counter()
    summary = train_long_main(["--config", cfg_path,
                               "--max_frames_per_video", "3"])
    t1 = time.perf_counter()
    tf32_checked_off("entry python -m emip_tpu_torch.train_long")
    ckpt = os.path.join(work, "run", "ckpt_long")
    pred = os.path.join(work, "pred")
    tf32_on()
    frames = test_long_main(["--config", cfg_path, "--ckpt", ckpt,
                             "--save_path", pred, "--data",
                             f"MoCA_test={root}"])
    t2 = time.perf_counter()
    tf32_checked_off("entry python -m emip_tpu_torch.test_long")
    pngs = sum(f.endswith(".png") for _, _, fs in os.walk(pred) for f in fs)
    ok = (summary["steps"] == 4 and 0.0 <= summary["best_sm"] <= 1.0
          and os.path.exists(os.path.join(ckpt, "ckpt.pt"))
          and frames == pngs == 12)
    log(f"entry python -m emip_tpu_torch.train_long: {summary['steps']} "
        f"steps, val Sm {summary['best_sm']:.5f}, {t1 - t0:.1f} s; "
        f"python -m emip_tpu_torch.test_long: {frames} frames, {pngs} PNGs, "
        f"{t2 - t1:.1f} s {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"long entry points failed: {summary}, "
                             f"{frames} frames, {pngs} PNGs")
    return dict(summary=summary, train_seconds=t1 - t0,
                predict_seconds=t2 - t1, frames=frames, work=work,
                config=cfg_path, root=root)


# ------------------------------------------------- bf16 long model, 512^2

# timed steps of each model in each turn: host-bound steps spread (352^2
# at 1 clip: 32-57 ms over five), so eight a turn
LONG_BF16_TIMED = 8


def long_expected_bf16(model, frames_encoded: int, pairs: int, reads: int,
                       backward_reads: int = 0) -> dict:
    """Launches of the bf16 long model: the bf16 forwards of A-D (G and H
    for B at 512^2) of its frozen short-term net, F's bf16 forward per read
    and its bf16 backward per train step, and nothing else (no fp32 kernel,
    no backward of the short-term net's kernels)."""
    per = expected_launches_bf16(model.short_term)
    n = {k: v // 2 * frames_encoded if k == "sr_attention_bf16"
         else v * pairs for k, v in per.items()}
    n.update(memory_attention_bf16=reads,
             memory_attention_bwd_bf16=backward_reads)
    return n


def bf16_long_model(model, device):
    """``EMIPLong(cfg, memory_size, dtype=bfloat16)`` on ``model``'s
    weights, on ``device``, in eval mode."""
    import torch

    from emip_tpu_torch.models.emip_long import EMIPLong

    model16 = EMIPLong(model.config, model.memory_size, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    return model16.to(device).eval()


def _busy_line(res: dict, busy16: float, busy32: float) -> str:
    ms16, ms32 = res["median_ms"], res["fp32_median_ms"]
    t16, t32 = res["step_ms"], res["fp32_step_ms"]
    lo, hi = res["speedup_halves"]
    sides = {r > 1 for r in (lo, hi, res["speedup"])}
    return (f"device busy {busy16:.3f} ms/step (idle {1 - busy16 / ms16:.3f})"
            f"; fp32 in the same turns {ms32:.3f} ms/step, busy "
            f"{busy32:.3f} (idle {1 - busy32 / ms32:.3f}); bf16 peak memory "
            f"{res['peak_bytes'] / 2**30:.3f} GiB; fp32 / bf16 "
            f"x{res['speedup']:.3f} (first turns x{lo:.3f}, last x{hi:.3f}"
            f"{'' if len(sides) == 1 else ': unresolved'}; steps "
            f"bf16 {min(t16):.3f}-{max(t16):.3f}, fp32 {min(t32):.3f}-"
            f"{max(t32):.3f} ms)")


def long_bf16_stream_phase(model, size: int, device, timed: int) -> dict:
    """Streaming inference of the full EMIPLong in bf16 on the fp32 model's
    weights, one clip and four side by side: each model's ring filled by
    ``memory_size`` steps, then ``step_cached`` on the full ring with the
    carried encoding in turns with the fp32 model (:func:`bf16_step_turns`:
    launches counted over 1 + ``timed`` bf16 steps must be the bf16
    forwards of A-D, or of A, C, D, G and H at 512^2, and F's bf16 forward
    once a step, nothing else), ms/step -> frames/s, the device's busy time
    and idle share of each, peak memory; fp32 masks of the right shape,
    finite, and a fp32 ring."""
    import torch

    model16 = bf16_long_model(model, device)
    rng = np.random.default_rng(SEED + 17)
    out = {}
    for clips in LONG_CLIPS:
        video = seeded_clip(rng, clips, model.memory_size + 2, size, device)

        def full(m):
            with torch.inference_mode():
                state = m.init_memory(clips)
                enc = m.encode_frame(video[:, 0])
                for t in range(1, model.memory_size + 1):
                    _, enc, state = m.step_cached(enc, video[:, t], state)
            return enc, state

        (enc16, st16), (enc32, st32) = full(model16), full(model)
        cur, masks = video[:, -1], []

        def step16():
            with torch.inference_mode():
                masks[:] = [model16.step_cached(enc16, cur, st16)[0]]

        def step32():
            with torch.inference_mode():
                model.step_cached(enc32, cur, st32)

        label = f"bf16 long inference b5 {size}^2 clips={clips}"
        want = {k: v * (1 + timed)
                for k, v in long_expected_bf16(model16, 1, 1, 1).items()}
        res = bf16_step_turns(label, step16, step32, timed, device, want)
        busy16, busy32 = device_ms(step16, 2), device_ms(step32, 2)
        mask = masks[0]
        if (tuple(mask.shape) != (clips, 1, size, size)
                or mask.dtype != torch.float32
                or not bool(torch.isfinite(mask).all())
                or st16.keys.dtype != torch.float32
                or not bool(st16.valid.all())):
            raise AssertionError(f"{label}: mask shape, dtype or "
                                 f"finiteness, or the ring")
        ms16 = res["median_ms"]
        log(f"{label}: median {ms16:.3f} ms/step (ring full) -> "
            f"{clips / (ms16 / 1e3):.3f} frames/s (fp32 "
            f"{clips / (res['fp32_median_ms'] / 1e3):.3f}); "
            + _busy_line(res, busy16, busy32))
        out[f"clips{clips}"] = dict(
            res, frames_per_s=clips / (ms16 / 1e3),
            fp32_frames_per_s=clips / (res["fp32_median_ms"] / 1e3),
            device_busy_ms=busy16, fp32_device_busy_ms=busy32)
    del model16
    return out


def long_bf16_train_phase(model, size: int, device, timed: int) -> dict:
    """The full EMIPLong in bf16 on the fp32 long train phase's weights
    takes per-frame train steps at 4 clips, each model on a ring that holds
    one frame and with the frame before encoded, in turns with the fp32
    model (:func:`bf16_step_turns`; per step one frame encoded and one pair
    in the bf16 forwards of A-D, F's bf16 forward and backward once,
    nothing else), each with its own clamp + AdamW; ms/frame, the device's
    busy time and idle share, peak memory. Every ``short_term`` tensor and
    buffer of the bf16 model bit-identical afterwards, every trainable leaf
    moved, finite losses, fp32 parameters."""
    import torch

    from emip_tpu_torch.train.long import CachedStep, long_train_step
    from emip_tpu_torch.train.state import build_long_optimizer

    clips = max(LONG_CLIPS)
    model16 = bf16_long_model(model, device)
    opt16, opt32 = build_long_optimizer(model16), build_long_optimizer(model)
    short0 = {k: v.clone() for k, v in model16.short_term.state_dict().items()}
    trainable0 = {n: p.detach().clone() for n, p in model16.named_parameters()
                  if p.requires_grad}
    rng = np.random.default_rng(SEED + 18)
    video = seeded_clip(rng, clips, 3, size, device)
    gt = torch.from_numpy((rng.uniform(size=(clips, 1, size, size)) > 0.5
                           ).astype(np.float32)).to(device)

    def primed(m):
        with torch.no_grad():
            m.eval()
            _, _, state = m.step(video[:, 0], video[:, 1],
                                 m.init_memory(clips))
            return m.encode_frame(video[:, 1]), state

    (enc16, st16), (enc32, st32) = primed(model16), primed(model)
    losses = []

    def step16():
        metrics, _, _ = long_train_step(CachedStep(model16), opt16, enc16,
                                        video[:, 2], gt, st16)
        losses.append(float(metrics["loss"]))

    def step32():
        long_train_step(CachedStep(model), opt32, enc32, video[:, 2], gt,
                        st32)

    label = f"bf16 long train b5 {size}^2 clips={clips}"
    want = {k: v * (1 + timed)
            for k, v in long_expected_bf16(model16, 1, 1, 1, 1).items()}
    res = bf16_step_turns(label, step16, step32, timed, device, want)
    busy16, busy32 = device_ms(step16, 2), device_ms(step32, 2)
    moved = bf16_steps_moved(label, model16, trainable0, losses)
    short = model16.short_term.state_dict()
    changed = [k for k, v in short0.items() if not torch.equal(short[k], v)]
    if changed or len(trainable0) != moved:
        raise AssertionError(f"{label}: short_term tensors changed "
                             f"{changed[:8]}, {moved} of {len(trainable0)} "
                             f"trainable leaves moved")
    ms16 = res["median_ms"]
    log(f"{label}: losses " + " ".join(f"{v:.6f}" for v in losses)
        + f"; median {ms16:.3f} ms/step -> {ms16 / clips:.3f} ms/frame "
        f"(fp32 {res['fp32_median_ms'] / clips:.3f}); "
        + _busy_line(res, busy16, busy32)
        + f"; {moved} trainable leaves all moved, {len(short0)} short_term "
        f"tensors and buffers bit-identical")
    del opt16, opt32, model16
    return dict(res, ms_per_frame=ms16 / clips,
                fp32_ms_per_frame=res["fp32_median_ms"] / clips,
                device_busy_ms=busy16, fp32_device_busy_ms=busy32,
                losses=losses, leaves=moved, short_term_tensors=len(short0))


def _gap_check(label: str, got16: dict, cpu16: dict, got32: dict,
               cpu32: dict) -> tuple[dict, list]:
    """Per name: |card bf16 - CPU bf16| max against twice the larger of
    the card's and the CPU's own bf16-vs-fp32 gaps on it (above zero): the
    two bf16 runs round apart, so their difference can reach the sum of
    their distances from fp32 (and the fp32 card-vs-CPU difference)."""
    out, bad = {}, []
    for n in got16:
        err = (got16[n].float().cpu() - cpu16[n].float()).abs().max().item()
        card = (got16[n].float() - got32[n].float()).abs().max().item()
        cpu = (cpu16[n].float() - cpu32[n].float()).abs().max().item()
        ratio = err / max(card, cpu, 1e-30)
        ok = max(card, cpu) > 0 and ratio <= 2
        out[n] = dict(err=err, card_gap=card, cpu_gap=cpu, ratio=ratio,
                      ok=ok)
        if not ok:
            bad.append(f"{label} {n}")
    return out, bad


def long_bf16_compare_phase(size: int, device) -> dict:
    """The card's bf16 long model against the CPU's plain bf16 versions at
    b5's widths and PVT depths BF16_COMPARE_DEPTHS (drop path off), with
    the fp32 model on both sides from the same seeded weights: a 3-frame
    clip (frame 0's short mask, the two long masks, the ring's last two
    slots of keys and values), then one train frame's loss and every
    trainable leaf's grad (through F's bf16 backward) on each of
    BF16_COMPARE_SEEDS. Each output, the loss and each leaf within twice
    the larger of the card's and the CPU's bf16-vs-fp32 gaps on it (as the
    bf16 short train step's gate); all leaves together (max and mean)
    within twice each gap."""
    import torch

    from emip_tpu_torch.models.emip_long import EMIPLong
    from emip_tpu_torch.models.emip_short import EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.models.pvt_v2 import PVT_V2_VARIANTS

    t0 = time.perf_counter()
    pvt = dataclasses.replace(PVT_V2_VARIANTS["pvt_v2_b5"],
                              depths=BF16_COMPARE_DEPTHS, drop_path_rate=0.0)
    cfg = EMIPShortConfig(backbone_name=pvt, inp_size=size)
    fp32 = seeded_init_(EMIPLong(cfg, 5), SEED)
    card16 = EMIPLong(cfg, 5, dtype=torch.bfloat16)
    card16.load_state_dict(fp32.state_dict())
    models = dict(card32=(fp32, device), card16=(card16, device),
                  cpu16=(copy.deepcopy(card16), "cpu"),
                  cpu32=(copy.deepcopy(fp32), "cpu"))
    for m, dev in models.values():
        m.to(dev).eval()
    video = seeded_clip(np.random.default_rng(SEED + 19), 1, 3, size, device)
    clip = {n: long_clip(m, video.to(dev)) for n, (m, dev) in models.items()}
    out = dict(clip=None, seeds=[])
    out["clip"], bad = _gap_check("clip", clip["card16"], clip["cpu16"],
                                  clip["card32"], clip["cpu32"])
    for n, v in out["clip"].items():
        log(f"bf16 long {n}: card bf16 vs CPU plain bf16 max_abs_err="
            f"{v['err']:.3e}; bf16-vs-fp32 gap card {v['card_gap']:.3e} CPU "
            f"{v['cpu_gap']:.3e}: {v['ratio']:.3f} x the larger (limit 2) "
            f"{'ok' if v['ok'] else 'MISMATCH'}")
    for seed in BF16_COMPARE_SEEDS:
        rng = np.random.default_rng(seed)
        vid = seeded_clip(rng, 1, 3, size, device)
        gt = torch.from_numpy((rng.uniform(size=(1, 1, size, size)) > 0.5
                               ).astype(np.float32)).to(device)
        batch = dict(f0=vid[:, 0], f1=vid[:, 1], f2=vid[:, 2], gt=gt)
        runs = {n: _long_frame(m, {k: v.to(dev) for k, v in batch.items()})
                for n, (m, dev) in models.items()}
        loss = {n: torch.tensor([r[0]]) for n, r in runs.items()}
        lcheck, lbad = _gap_check(f"seed {seed} loss", dict(loss=loss[
            "card16"]), dict(loss=loss["cpu16"]), dict(loss=loss["card32"]),
            dict(loss=loss["cpu32"]))
        leaves, gbad = _gap_check(f"seed {seed}", runs["card16"][1],
                                  runs["cpu16"][1], runs["card32"][1],
                                  runs["cpu32"][1])
        pooled, pbad = pooled_gaps(f"seed {seed}", *(
            runs[n][1] for n in ("card16", "cpu16", "card32", "cpu32")))
        bad += lbad + gbad + pbad
        worst = sorted(leaves.items(), key=lambda kv: -kv[1]["ratio"])[:5]
        log(f"bf16 long train seed {seed}: loss card bf16 "
            f"{runs['card16'][0]:.7f} CPU bf16 {runs['cpu16'][0]:.7f} card "
            f"fp32 {runs['card32'][0]:.7f} CPU fp32 {runs['cpu32'][0]:.7f} "
            f"({lcheck['loss']['ratio']:.3f} x the larger gap); head grads "
            f"over {len(leaves)} leaves: all together |card bf16 - CPU bf16|"
            f" max {pooled['err_max']:.3e} mean {pooled['err_mean']:.3e}; "
            f"card gap max {pooled['card_max']:.3e} mean "
            f"{pooled['card_mean']:.3e}; CPU gap max {pooled['cpu_max']:.3e}"
            f" mean {pooled['cpu_mean']:.3e} (limit 2 x each); per leaf "
            f"against the larger gap (limit 2): "
            + ", ".join(f"{n}={v['ratio']:.2f}" for n, v in worst))
        out["seeds"].append(dict(seed=seed, loss=lcheck["loss"],
                                 grads=pooled, leaves=len(leaves),
                                 worst=worst))
    seconds = time.perf_counter() - t0
    log(f"bf16 long card against CPU: a clip and {len(BF16_COMPARE_SEEDS)} "
        f"train frames in {seconds:.1f} s {'MISMATCH' if bad else 'ok'}")
    del models, fp32, card16
    if bad:
        raise AssertionError(f"bf16 long card disagrees with the CPU: "
                             f"{bad[:8]}")
    out.update(seconds=seconds, depths=BF16_COMPARE_DEPTHS)
    return out


def bf16_short512_phase(model, batch: int, device, timed: int) -> dict:
    """Short inference at 512^2 in bf16: ``EMIPShort(cfg, dtype=bfloat16)``
    on the fp32 512^2 model's weights through ``predict_arrays`` on one
    seeded batch, in turns with the fp32 model (:func:`bf16_step_turns`:
    the bf16 forwards of A, C, D, G and H, none of B and nothing in fp32),
    frames/s, the device's busy time, peak memory; fp32 mask and flow of
    the right shape, finite."""
    import torch

    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_short import EMIPShort

    size = model.config.inp_size
    model16 = EMIPShort(model.config, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    model16 = model16.to(device).eval()
    model.eval()
    rng = np.random.default_rng(SEED + 20)
    a, b = (torch.from_numpy(seeded_frames(rng, batch, size)).to(device)
            for _ in range(2))
    outs = []

    def step16():
        outs[:] = predict_arrays(model16, a, b)

    def step32():
        predict_arrays(model, a, b)

    label = f"bf16 slice b5 {size}^2 bs={batch}"
    want = {k: v * (1 + timed)
            for k, v in expected_launches_bf16(model16).items()}
    if want["window_attention_block_bf16"] or not (
            want["window_attention_layer_bf16"]
            and want["window_attention_ffn_layer_bf16"]):
        raise AssertionError(f"{label}: the structure asks for no G and H")
    res = bf16_step_turns(label, step16, step32, timed, device, want)
    busy16, busy32 = device_ms(step16, 2), device_ms(step32, 2)
    mask, flow = outs
    if (tuple(mask.shape) != (batch, 1, size, size)
            or tuple(flow.shape) != (batch, 2, size, size)
            or mask.dtype != torch.float32 or flow.dtype != torch.float32
            or not (torch.isfinite(mask).all() and torch.isfinite(flow).all())):
        raise AssertionError(f"{label}: shape, dtype or finiteness")
    ms16 = res["median_ms"]
    log(f"{label}: median {ms16:.3f} ms/batch -> {batch / (ms16 / 1e3):.3f} "
        f"frames/s (fp32 {batch / (res['fp32_median_ms'] / 1e3):.3f}); "
        + _busy_line(res, busy16, busy32))
    del model16
    return dict(res, frames_per_s=batch / (ms16 / 1e3),
                fp32_frames_per_s=batch / (res["fp32_median_ms"] / 1e3),
                device_busy_ms=busy16, fp32_device_busy_ms=busy32)


def long_bf16_entry_phase(long_entry: dict, size: int) -> dict:
    """``python -m emip_tpu_torch.train_long`` and ``... test_long`` (in
    process) with the long entry phase's YAML saying ``compute_dtype:
    bfloat16``, on its root: TF32 and the bf16 reduced-precision reduction
    on before each call and checked off after it; 4 per-frame steps,
    validation, a checkpoint of fp32 tensors (model and AdamW state), one
    PNG per frame; the bf16 forwards of A-D and F's bf16 forward and
    backward launched, none of their fp32 ones."""
    import torch
    import yaml

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.test_long import main as test_long_main
    from emip_tpu_torch.train.loops import CKPT_NAME
    from emip_tpu_torch.train_long import main as train_long_main

    work, root = long_entry["work"], long_entry["root"]
    with open(long_entry["config"]) as f:
        raw = yaml.safe_load(f)
    raw.update(compute_dtype="bfloat16", save_path=os.path.join(work,
                                                                "run_bf16"))
    cfg = os.path.join(work, "long_bf16.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    K.reset_launches()
    tf32_on()
    t0 = time.perf_counter()
    summary = train_long_main(["--config", cfg, "--max_frames_per_video",
                               "3"])
    t1 = time.perf_counter()
    tf32_checked_off("entry python -m emip_tpu_torch.train_long (bf16)")
    ckpt_dir = os.path.join(raw["save_path"], "ckpt_long")
    ckpt = torch.load(os.path.join(ckpt_dir, CKPT_NAME), map_location="cpu")
    fp32 = all(v.dtype == torch.float32 for v in ckpt["model"].values()
               if v.is_floating_point()) and all(
        v.dtype == torch.float32 for st in ckpt["optimizer"]["state"].values()
        for v in st.values() if torch.is_tensor(v) and v.is_floating_point())
    pred = os.path.join(work, "pred_bf16")
    tf32_on()
    frames = test_long_main(["--config", cfg, "--ckpt", ckpt_dir,
                             "--save_path", pred, "--data",
                             f"MoCA_test={root}"])
    t2 = time.perf_counter()
    tf32_checked_off("entry python -m emip_tpu_torch.test_long (bf16)")
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    pngs = _count_files(pred, ".png")
    fp32_kernels = [k for k in FWD_KERNELS + ("memory_attention",
                                              "memory_attention_bwd")
                    if K.LAUNCHES[k]]
    ok = (summary["steps"] == 4 and 0.0 <= summary["best_sm"] <= 1.0 and fp32
          and frames == pngs == 12 and not fp32_kernels
          and all(K.LAUNCHES[k + "_bf16"] for k in FWD_KERNELS)
          and K.LAUNCHES["memory_attention_bf16"]
          and K.LAUNCHES["memory_attention_bwd_bf16"])
    log(f"entry python -m emip_tpu_torch.train_long compute_dtype=bfloat16 "
        f"b5 {size}^2: {summary['steps']} steps, val Sm "
        f"{summary['best_sm']:.5f}, fp32 checkpoint {fp32}, {t1 - t0:.1f} s;"
        f" python -m emip_tpu_torch.test_long: {frames} frames, {pngs} PNGs, "
        f"{t2 - t1:.1f} s; launches {launches} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"bf16 long entry points: {summary}, {frames} "
                             f"frames, {pngs} PNGs, fp32 checkpoint {fp32}, "
                             f"fp32 launches {fp32_kernels}")
    return dict(summary=summary, train_seconds=t1 - t0,
                predict_seconds=t2 - t1, frames=frames, launches=launches)


# ------------------------------------------------- tiny configuration

TINY_SIZE = 64
TINY_BATCH = 2


def tiny_phase(device) -> dict:
    """The configuration of the CPU tests' YAML on the card: pvt_v2_b0 at
    64^2 with 64-d flow features and 2 flow transformer blocks, so kernel
    A at head width 32 and B, C and F at channel width 64, on seeded
    weights. A short forward (launch counts against the structure; mask
    and flow against the CPU's plain versions), the seg-loss grads of one
    pair against the CPU's, one short train step (launch counts: A-D
    forward and backward, E), then the long model: a 3-frame clip (F's
    forward on every read) and one frame's head grads (F's backward),
    each against the CPU's."""
    import torch
    import yaml

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.infer import predict_arrays
    from emip_tpu_torch.models.emip_long import EMIPLong
    from emip_tpu_torch.models.emip_short import EMIPShort
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer

    work = os.path.join(ROOT, "build", "chip_smoke_tiny")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(model=dict(args=dict(
            inp_size=TINY_SIZE, channel=8, backbone_name="pvt_v2_b0",
            include_dead_modules=False,
            GMFlow=dict(feature_channels=64, num_transformer_layers=2))),
            memory_size=5, compute_dtype="float32", seed=SEED), f)
    cfg = load_config(path)
    model = seeded_init_(EMIPShort(cfg.model), SEED).to(device).eval()
    rng = np.random.default_rng(SEED + 14)
    a, b = (torch.from_numpy(seeded_frames(rng, TINY_BATCH, TINY_SIZE)
                             ).to(device) for _ in range(2))
    out = {}

    K.reset_launches()
    mask, flow = predict_arrays(model, a, b)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = expected_launches(model)
    log(f"tiny b0 {TINY_SIZE}^2 forward launches {launches} (expected "
        f"{want})")
    if launches != want or min(launches[k] for k in FWD_KERNELS) == 0:
        raise AssertionError(f"tiny launch counts {launches} != {want}")
    cpu = copy.deepcopy(model).cpu()
    ref_mask, ref_flow = predict_arrays(cpu, a.cpu(), b.cpu())
    out["forward"] = dict(launches=launches, compare=held_to_cpu(
        "tiny", dict(mask=mask, flow_fw=flow),
        dict(mask=ref_mask, flow_fw=ref_flow), SLICE_TOL))
    del cpu

    out["train_compare"] = train_compare_phase(model, TINY_SIZE, device,
                                               "tiny train")
    opt = build_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = seeded_batch(rng, TINY_BATCH, TINY_SIZE, device)
    K.reset_launches()
    metrics = short_train_step(model, opt, batch, gen)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = expected_launches(model, True)
    losses = {k: float(v) for k, v in metrics.items()}
    log(f"tiny train step launches {launches} (expected {want}); losses "
        + " ".join(f"{k}={v:.6f}" for k, v in losses.items()))
    idle = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if launches != want or idle or not all(
            np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"tiny train step: launches {launches} != "
                             f"{want}, not launched {idle}, losses {losses}")
    out["train"] = dict(launches=launches, losses=losses)
    del model, opt

    long_model = seeded_init_(EMIPLong(cfg.model, cfg.memory_size), SEED)
    long_model = long_model.to(device).eval()
    video = seeded_clip(rng, 1, 3, TINY_SIZE, device)
    K.reset_launches()
    got = long_clip(long_model, video)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = long_expected(long_model, 3, 3, 2)
    log(f"tiny long clip launches {launches} (expected {want})")
    if launches != want or 0 in (launches[k] for k in FWD_KERNELS + (
            "memory_attention",)):
        raise AssertionError(f"tiny long launch counts {launches} != {want}")
    ref = long_clip(copy.deepcopy(long_model).cpu(), video.cpu())
    out["long"] = dict(launches=launches,
                       compare=held_to_cpu("tiny long", got, ref))
    out["long_train_compare"] = long_train_compare_phase(
        long_model, TINY_SIZE, device, "tiny long train")
    return out


# ---------------------------------------------------------------- main


# ------------------------------------------------------- data parallelism

DDP_WORLD = 2        # ranks of the ddp phase, both on the one card
DDP_BATCH = 8        # the global batch: 4 rows a rank
DDP_LR = 1e-5
DDP_ADAM_SATURATED = 1e-6  # |grad| above which AdamW's first step is +-lr
DDP_PARAM_ATOL = 1e-6
DDP_NUDGES = 3       # at most, one-process steps on frames nudged by
DDP_NUDGE = 1e-6     # (taken until no leaf is past twice their band)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _whole(t):
    """A sharded tensor gathered whole (a collective), else ``t``."""
    from emip_tpu_torch.parallel import gather_whole

    return gather_whole(t)


def _ddp_step(base: dict, dtype, rows: slice, device,
              nudge_seed: int | None = None, fsdp: bool = False) -> dict:
    """One short train step of the seeded b5 model (``base``, its state
    dict) in ``dtype`` on ``rows`` of the seeded global batch (its frames
    nudged by DDP_NUDGE times a normal draw from ``nudge_seed``), through
    ``short_train_step`` (in ``DistributedDataParallel`` when a group of
    more than one rank is active, or, with ``fsdp``, sharded by
    ``fully_sharded`` before the optimizer is built): the loss, the grads
    as AdamW reads them before its clamp, the BatchNorm buffers, the
    trainable parameters after AdamW (sharded ones gathered whole), the
    launches against the structure, the step's ms, the peak memory and
    the memory held just before the step; with ``fsdp`` also the bytes of
    the root's own parameters and of the largest unit."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.parallel import (
        data_parallel,
        fsdp_units,
        fully_sharded,
    )
    from emip_tpu_torch.train.short import short_train_step
    from emip_tpu_torch.train.state import build_optimizer, freeze_gmflow

    cfg = EMIPShortConfig(backbone_name="pvt_v2_b5", inp_size=SIZE)
    with torch.device(device):
        model = EMIPShort(cfg, dtype=dtype)
    model.load_state_dict(base)
    if fsdp:
        model = fully_sharded(freeze_gmflow(model))
    opt = build_optimizer(model, DDP_LR)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}
    opt.register_step_pre_hook(lambda o, a, kw: grads.update(
        {names[id(p)]: _whole(p.grad).clone() for g in o.param_groups
         for p in g["params"] if p.grad is not None}))
    step_model = model if fsdp else data_parallel(model)
    batch = seeded_batch(np.random.default_rng(SEED + 30), DDP_BATCH, SIZE,
                         device)
    if nudge_seed is not None:
        gen = torch.Generator(device=device).manual_seed(nudge_seed)
        for k in ("image1", "image2"):
            batch[k] = batch[k] + DDP_NUDGE * torch.randn(
                batch[k].shape, generator=gen, device=device)
    batch = {k: v[rows] for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)  # the state before the step
    K.reset_launches()
    metrics, ms = timed_call(lambda: short_train_step(step_model, opt, batch,
                                                      gen))
    launches = dict(K.LAUNCHES)
    want = (expected_launches(model, True) if dtype == torch.float32
            else expected_launches_bf16(model, True))
    if launches != want:
        raise AssertionError(f"ddp step {dtype} launches {launches} != "
                             f"{want}")
    out = dict(loss=float(metrics["loss"]), grads=grads,
               buffers={k: v.clone() for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))},
               params={n: _whole(p).detach().clone()
                       for n, p in model.named_parameters()
                       if p.requires_grad},
               launches=launches, ms=ms,
               peak=torch.cuda.max_memory_allocated(device), held=held)
    if fsdp:  # what FSDP all-gathers: the root's own parameters, each unit
        units = [sum(p.numel() * p.element_size() for p in u.parameters())
                 for u in fsdp_units(model)]
        out.update(root_bytes=sum(p.numel() * p.element_size()
                                  for p in model.parameters())
                   - sum(units), unit_max_bytes=max(units))
    del step_model, model, opt
    torch.cuda.empty_cache()
    return out


def _ddp_banded(got: dict, ref: dict, band: dict):
    """Each leaf's grad error relative to its scale (``grad_relmax``) and,
    for the leaves past SEG_GRAD_RTOL, their error over twice
    ``band[leaf]``."""
    rels, worst = grad_relmax(got["grads"], ref["grads"])
    scale = {n: r * max(ref["grads"][n].abs().max().item(), 1e-30)
             for n, r in rels.items()}  # the leaf's error, max|ddp - ref|
    banded = {n: e / max(2 * band[n], 1e-30) for n, e in scale.items()
              if rels[n] > SEG_GRAD_RTOL}
    return rels, worst, banded


def _ddp_compare(got: dict, ref: dict, band: dict, label: str) -> dict:
    """fp32: the loss by TRAIN_LOSS_RTOL; each leaf's grad by the
    scale-floored SEG_GRAD_RTOL or, where larger, twice ``band[leaf]``:
    how far one-process steps on frames nudged by DDP_NUDGE move that
    grad (at seeded weights a few b5 leaves, an injector's attention
    temperature first, turn rounding into percents; the rule of the
    backbones phase); each BatchNorm buffer by BN_STATS_REL; the
    parameters after AdamW to DDP_PARAM_ATOL where |grad| is at least
    DDP_ADAM_SATURATED and twice the leaf's grad error, and within the
    bound of one step (2 lr) elsewhere."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    rels, worst, banded = _ddp_banded(got, ref, band)
    over = {n: r for n, r in banded.items() if r > 1.0}
    buf = max(((v - got["buffers"][k]).abs().max().item()
               / max(v.abs().max().item(), 1e-30), k)
              for k, v in ref["buffers"].items())
    sat_err, flipped, total = 0.0, 0, 0
    for n, v in ref["params"].items():
        diff = (got["params"][n] - v).abs()
        g = ref["grads"].get(n)
        if g is None:
            if diff.max().item() != 0.0:
                raise AssertionError(f"{label}: {n} took no grad but moved")
            continue
        gerr = (got["grads"][n] - g).abs().max().item()
        sat = (g.abs() >= max(DDP_ADAM_SATURATED, 2 * gerr))
        if sat.any():
            sat_err = max(sat_err, diff[sat].max().item())
        flipped += int((diff > DDP_PARAM_ATOL).sum())
        total += diff.numel()
        if diff.max().item() > 2 * DDP_LR + DDP_PARAM_ATOL:
            raise AssertionError(f"{label}: {n} moved by more than a step")
    log(f"{label}: loss rel {loss_rel:.3e} (tol {TRAIN_LOSS_RTOL}); grads "
        f"over {len(rels)} leaves worst relmax {worst[0][1]:.3e} at "
        f"{worst[0][0]} (tol {SEG_GRAD_RTOL}); {len(banded)} leaves past it "
        f"held by twice their nudge band: "
        + ", ".join(f"{n}={r:.2f}" for n, r in banded.items())
        + f"; BatchNorm buffers worst rel {buf[0]:.3e} at {buf[1]} (tol "
        f"{BN_STATS_REL}); params after AdamW: saturated elements within "
        f"{sat_err:.3e} (tol {DDP_PARAM_ATOL}), {flipped} of {total} "
        f"elements apart by more")
    if not (loss_rel <= TRAIN_LOSS_RTOL and not over
            and buf[0] <= BN_STATS_REL and sat_err <= DDP_PARAM_ATOL):
        raise AssertionError(f"{label}: the 2-rank step disagrees with the "
                             f"one-process step: {over}")
    return dict(loss_rel=loss_rel, worst_grads=worst, banded=banded,
                worst_buffer=buf, params_saturated_err=sat_err,
                params_apart=flipped, params_total=total)


def _ddp_band(got16: dict, ref16: dict, ref32: dict, label: str) -> dict:
    """The bf16 step within twice its one-process bf16-vs-fp32 gap (> 0):
    the loss, and all leaves' grads and all BatchNorm buffers taken
    together, by max and by mean."""
    import torch

    out = {}
    gap = abs(ref16["loss"] - ref32["loss"])
    err = abs(got16["loss"] - ref16["loss"])
    out["loss"] = (err, gap)
    ok = 0 < gap and err <= 2 * gap
    for key in ("grads", "buffers"):
        names = sorted(ref16[key])

        def cat(d):
            return torch.cat([d[k].flatten().double() for k in names])

        e = (cat(got16[key]) - cat(ref16[key])).abs()
        g = (cat(ref16[key]) - cat(ref32[key])).abs()
        out[key] = dict(max=(e.max().item(), g.max().item()),
                        mean=(e.mean().item(), g.mean().item()))
        ok = ok and g.max().item() > 0 and e.max().item() <= 2 * g.max(
        ).item() and e.mean().item() <= 2 * g.mean().item()
    log(f"{label}: (error, one-process bf16-vs-fp32 gap) loss "
        f"{out['loss']}, grads {out['grads']}, BatchNorm buffers "
        f"{out['buffers']}: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: outside twice its bf16 gap")
    return out


def _ddp_rank(rank: int, port: int, out_path: str, trainer_yaml: str,
              fsdp_yaml: str, infer: dict) -> None:
    """One rank of the ``ddp`` phase, a spawned process on the card. It
    joins a gloo group of DDP_WORLD ranks through the port's own entry
    (``init_distributed`` on torchrun's variables, every rank on
    ``cuda:0``), takes the fp32 and the bf16 short train steps on its rows
    (every rank's state checked equal by digest), then one epoch of one
    step of ``train_short`` on ``trainer_yaml`` (``{rank}`` in it: each
    rank's own ``save_path``), its parameters and buffers checked equal
    by digest. The same ranks then take the fp32 and bf16 steps again
    with the model sharded (FSDP), one step of ``train_short`` on
    ``fsdp_yaml`` (``parallel.fsdp``), sharded inference
    (``_sharded_infer_rank``) and the pipeline over b5's stage 3
    (``_pipeline_rank``). Then, the group left, rank 0 takes both steps on
    all the rows in one process and holds the 2-rank steps, DDP and FSDP,
    to them, holds the FSDP run's checkpoint to the DDP run's, and the
    ranks' predictions to one process's. Each rank writes its readings to
    ``out_path`` (``{rank}`` in it)."""
    import faulthandler

    import torch

    sys.path.insert(0, ROOT)
    from emip_tpu_torch.config import load_config
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.parallel import (
        init_distributed,
        shutdown_distributed,
        world,
    )
    from emip_tpu_torch.train.loops import train_short

    faulthandler.enable()  # a crash in a collective names its frames
    t0 = time.perf_counter()
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(DDP_WORLD), RANK=str(rank),
                      LOCAL_RANK="0")
    device = init_distributed("cuda", backend="gloo")
    if device != torch.device("cuda", 0) or world() != (rank, DDP_WORLD):
        raise AssertionError(f"ddp rank {rank}: joined as {world()} on "
                             f"{device}")
    base = seeded_init_(EMIPShort(EMIPShortConfig(
        backbone_name="pvt_v2_b5", inp_size=SIZE)), SEED).state_dict()
    per = DDP_BATCH // DDP_WORLD
    rows = slice(rank * per, (rank + 1) * per)
    res, rec = {}, dict(rank=rank)

    def same_on_every_rank(mine, what: str) -> None:
        every = [None] * DDP_WORLD
        torch.distributed.all_gather_object(every, mine)
        if any(d != every[0] for d in every):
            raise AssertionError(f"ddp: the ranks' {what} differ")

    def kept() -> int:
        """Bytes of the earlier steps' readings held on the card for the
        checks (a step's ``held`` counts them)."""
        return sum(t.numel() * t.element_size() for r in res.values()
                   for k in ("grads", "buffers", "params")
                   for t in r[k].values() if t.is_cuda)

    try:
        for name, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            before = kept()
            res[name] = r = _ddp_step(base, dtype, rows, device)
            # one flat copy a collection (a grad's strides may differ
            # from its parameter's)
            same_on_every_rank(
                [digest([torch.cat([r[k][n].reshape(-1)
                                    for n in sorted(r[k])])])
                 for k in ("grads", "buffers", "params")],
                f"{name} grads, buffers or params")
            loss = torch.tensor([r["loss"]], dtype=torch.float64)
            torch.distributed.all_reduce(loss)
            r["loss"] = loss.item() / DDP_WORLD
            rec[name] = dict(loss=r["loss"], step_ms=r["ms"],
                             peak_bytes=r["peak"], held_bytes=r["held"],
                             kept_bytes=before, launches=r["launches"])
        t1 = time.perf_counter()
        model, summary = train_short(
            load_config(trainer_yaml.format(rank=rank)),
            max_steps_per_epoch=1, device=device)
        same_on_every_rank(digest([v.reshape(-1) for v in
                                   model.state_dict().values()]),
                           "parameters and buffers after train_short")
        same_on_every_rank(summary["steps"], "train_short steps")
        rec["train_short"] = dict(summary, seconds=time.perf_counter() - t1)
        del model
        torch.cuda.empty_cache()
        # FSDP on the same ranks, rows and weights
        for name, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            before = kept()
            res["fsdp_" + name] = r = _ddp_step(base, dtype, rows, device,
                                                fsdp=True)
            same_on_every_rank(
                [digest([torch.cat([r[k][n].reshape(-1)
                                    for n in sorted(r[k])])])
                 for k in ("grads", "buffers", "params")],
                f"fsdp {name} grads, buffers or params")
            loss = torch.tensor([r["loss"]], dtype=torch.float64)
            torch.distributed.all_reduce(loss)
            r["loss"] = loss.item() / DDP_WORLD
            rec["fsdp_" + name] = dict(loss=r["loss"], step_ms=r["ms"],
                                       peak_bytes=r["peak"],
                                       held_bytes=r["held"],
                                       kept_bytes=before,
                                       root_bytes=r["root_bytes"],
                                       unit_max_bytes=r["unit_max_bytes"],
                                       launches=r["launches"])
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        model, summary = train_short(
            load_config(fsdp_yaml.format(rank=rank)),
            max_steps_per_epoch=1, device=device)
        same_on_every_rank(digest([_whole(v).reshape(-1) for v in
                                   model.state_dict().values()]),
                           "parameters and buffers after FSDP train_short")
        rec["fsdp_train_short"] = dict(
            summary, seconds=time.perf_counter() - t1,
            peak_bytes=torch.cuda.max_memory_allocated(device))
        del model
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec["sharded_infer"], flows = _sharded_infer_rank(
            rank, device, infer, same_on_every_rank)
        rec["sharded_infer"]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        rec["pipeline"] = _pipeline_rank(rank, device)
        torch.cuda.empty_cache()
    finally:
        shutdown_distributed()
    if rank == 0:  # no group now: the one-process steps on all the rows
        ref = {name: _ddp_step(base, dtype, slice(0, DDP_BATCH), device)
               for name, dtype in (("fp32", torch.float32),
                                   ("bf16", torch.bfloat16))}
        rec["one_process"] = {k: dict(loss=v["loss"], step_ms=v["ms"],
                                      peak_bytes=v["peak"])
                              for k, v in ref.items()}
        # the nudge band grows with each nudge: stop once no leaf is past
        # twice it, which DDP_NUDGES nudges would hold too
        band = {n: 0.0 for n in ref["fp32"]["grads"]}
        nudges = 0
        while nudges < DDP_NUDGES and any(
                r > 1.0 for got in (res["fp32"], res["fsdp_fp32"])
                for r in _ddp_banded(got, ref["fp32"], band)[2].values()):
            nudged = _ddp_step(base, torch.float32, slice(0, DDP_BATCH),
                               device, nudge_seed=SEED + 50 + nudges)["grads"]
            for n, g in ref["fp32"]["grads"].items():
                band[n] = max(band[n], (nudged[n] - g).abs().max().item())
            del nudged
            nudges += 1
        rec["nudges"] = nudges
        rec["fp32_check"] = _ddp_compare(res["fp32"], ref["fp32"], band,
                                         "ddp fp32 2 ranks vs 1 process")
        rec["bf16_check"] = _ddp_band(res["bf16"], ref["bf16"], ref["fp32"],
                                      "ddp bf16 2 ranks vs 1 process")
        rec["fsdp_fp32_check"] = _ddp_compare(
            res["fsdp_fp32"], ref["fp32"], band,
            "fsdp fp32 2 ranks vs 1 process")
        rec["fsdp_bf16_check"] = _ddp_band(
            res["fsdp_bf16"], ref["bf16"], ref["fp32"],
            "fsdp bf16 2 ranks vs 1 process")
        del res, ref
        torch.cuda.empty_cache()
        rec["fsdp_ckpt_check"] = _fsdp_ckpt_check(trainer_yaml, fsdp_yaml,
                                                  rec)
        rec["sharded_infer_check"] = _sharded_infer_check(device, infer,
                                                          rec, flows)
    rec["seconds"] = time.perf_counter() - t0
    with open(out_path.format(rank=rank), "w") as f:
        json.dump(rec, f, default=str)


def _own_peak(step: dict) -> int:
    """A step's peak memory above the earlier steps' kept readings: its
    model, optimizer and transient alone."""
    return step["peak_bytes"] - step["kept_bytes"]


def _fsdp_ckpt_check(trainer_yaml: str, fsdp_yaml: str, rec: dict) -> dict:
    """The first rank's checkpoint of the FSDP ``train_short`` step loads
    into a one-process model (strict) and its optimizer, and equals the DDP
    run's within the gates a step without its grads allows: the logged
    loss by TRAIN_LOSS_RTOL, every parameter within one AdamW step (2 lr)
    and within DDP_PARAM_ATOL for all but 1e-3 of the elements, the
    BatchNorm buffers by BN_STATS_REL, and the AdamW moments, each under
    the integer key of the same parameter in both, as the grads are held
    (``grad_relmax`` within SEG_GRAD_RTOL; the first step's ``exp_avg``
    and ``sqrt(exp_avg_sq)`` are the clamped grad scaled)."""
    import torch
    import yaml

    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.train.state import build_optimizer

    def ckpt(path):
        with open(path.format(rank=0)) as f:
            save = yaml.safe_load(f)["save_path"]
        return torch.load(os.path.join(save, "ckpt", "ckpt.pt"),
                          map_location="cpu")

    ddp, fsdp = ckpt(trainer_yaml), ckpt(fsdp_yaml)
    model = EMIPShort(EMIPShortConfig(backbone_name="pvt_v2_b5",
                                      inp_size=SIZE))
    model.load_state_dict(fsdp["model"])  # strict: one process loads it
    build_optimizer(model, DDP_LR).load_state_dict(fsdp["optimizer"])
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    if fsdp["optimizer"]["state"].keys() != ddp["optimizer"]["state"].keys():
        raise AssertionError("fsdp train_short checkpoint: the optimizer "
                             "holds other parameters than the ddp run's")
    moments = {}
    for key, view in (("exp_avg", lambda t: t),
                      ("exp_avg_sq", torch.sqrt)):
        got, want = ({names[i]: view(st[key].double())
                      for i, st in ck["optimizer"]["state"].items()}
                     for ck in (fsdp, ddp))
        moments[key] = grad_relmax(got, want)[1][0]
    loss = (rec["fsdp_train_short"]["last"]["loss"],
            rec["train_short"]["last"]["loss"])
    loss_rel = abs(loss[0] - loss[1]) / abs(loss[1])
    params = {n for n, _ in model.named_parameters()}
    worst, apart, total, buf = 0.0, 0, 0, (0.0, "")
    for k, v in ddp["model"].items():
        diff = (fsdp["model"][k].double() - v.double()).abs()
        if k in params:
            worst = max(worst, diff.max().item())
            apart += int((diff > DDP_PARAM_ATOL).sum())
            total += diff.numel()
        elif k.endswith(STATS):
            buf = max(buf, (diff.max().item()
                            / max(v.abs().max().item(), 1e-30), k))
    ok = (loss_rel <= TRAIN_LOSS_RTOL and worst <= 2 * DDP_LR + DDP_PARAM_ATOL
          and apart <= 1e-3 * total and buf[0] <= BN_STATS_REL
          and all(r <= SEG_GRAD_RTOL for _, r in moments.values())
          and ddp["epoch"] == fsdp["epoch"] == 1)
    log(f"fsdp train_short checkpoint: loads into one process; against the "
        f"ddp run's: loss rel {loss_rel:.3e} (tol {TRAIN_LOSS_RTOL}), "
        f"parameters worst {worst:.3e} (one step {2 * DDP_LR:.1e}), {apart} "
        f"of {total} elements apart by more than {DDP_PARAM_ATOL}, "
        f"BatchNorm buffers worst rel {buf[0]:.3e} at {buf[1]} (tol "
        f"{BN_STATS_REL}), AdamW moments over "
        f"{len(fsdp['optimizer']['state'])} keys worst relmax (leaf, rel) "
        f"{moments} (tol {SEG_GRAD_RTOL}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("fsdp train_short checkpoint disagrees with "
                             "the ddp run's")
    return dict(loss_rel=loss_rel, worst=worst, apart=apart, total=total,
                worst_buffer=buf, moments=moments)


def _infer_args(infer: dict, rank) -> tuple:
    """The parsed arguments of ``python -m emip_tpu_torch.test`` and
    ``... test_of`` on the entry phase's YAML, checkpoint and root, each
    run's own ``--save_path`` (``rank`` None: one process)."""
    from emip_tpu_torch.test import parse_args as test_args
    from emip_tpu_torch.test_of import parse_args as of_args

    tag = "one" if rank is None else f"rank{rank}"
    common = ["--config", infer["config"], "--ckpt", infer["ckpt"]]
    return (test_args(common + [
                "--save_path", os.path.join(infer["out"], "test", tag),
                "--data", f"MoCA_test={infer['root']}"]),
            of_args(common + [
                "--save_path", os.path.join(infer["out"], "of", tag),
                "--data_root", infer["root"]]))


def _sharded_infer_rank(rank: int, device, infer: dict,
                        same_on_every_rank) -> dict:
    """Sharded inference on one rank of the group: the bodies of
    ``python -m emip_tpu_torch.test`` and ``... test_of`` (their
    ``--multi_host`` runs less the group's forming, which here is gloo's)
    on the entry phase's YAML, checkpoint and root; every rank's flows
    equal by digest."""
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.test import _predict
    from emip_tpu_torch.test_of import _render

    test_args, of_args = _infer_args(infer, rank)
    K.reset_launches()
    _predict(test_args, device)
    flows = _render(of_args, device)
    same_on_every_rank(digest(_flow_tensors(flows)), "flows")
    return dict(flows=len(flows), launches={k: v for k, v in
                                            K.LAUNCHES.items() if v}), flows


def _flow_tensors(flows) -> list:
    import torch

    return [torch.from_numpy(np.ascontiguousarray(f)) for _, _, f in flows]


def _files(root: str, ext: str) -> dict:
    """{relative path: bytes} of the ``ext`` files under ``root``."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(ext):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _sharded_infer_check(device, infer: dict, rec: dict, got) -> dict:
    """The same ``test`` and ``test_of`` bodies in one process (no group)
    on the first rank: the ranks' PNGs (masks of both) are disjoint and
    together the one-process files byte for byte, the first rank alone
    wrote the flow images, those of one process, and its flows (``got``)
    are the one-process flows bit for bit. A file that differs is
    named."""
    from emip_tpu_torch.test import _predict
    from emip_tpu_torch.test_of import _render

    test_args, of_args = _infer_args(infer, None)
    _predict(test_args, device)
    flows = _render(of_args, device)
    ranks = range(DDP_WORLD)
    out, differ = {}, []
    for run, sub, ext in (("test", "", ".png"), ("of", "_masks", ".png"),
                          ("of", "", ".jpg")):
        one = _files(os.path.join(infer["out"], run, "one", sub), ext)
        shares = [_files(os.path.join(infer["out"], run, f"rank{r}", sub),
                         ext) for r in ranks]
        if ext == ".jpg":  # the flow images: the first rank alone
            union, overlap = shares[0], sum(len(s) for s in shares[1:])
        else:
            union = {k: v for s in shares for k, v in s.items()}
            overlap = sum(len(s) for s in shares) - len(union)
        differ += [f"{run}/{sub}/{k}" for k in set(one) | set(union)
                   if one.get(k) != union.get(k)]
        out[f"{run}{sub}{ext}"] = dict(one=len(one),
                                       shares=[len(s) for s in shares],
                                       overlap=overlap)
    same_flows = (len(got) == len(flows) and all(
        g[:2] == w[:2] and np.array_equal(g[2], w[2])
        for g, w in zip(got, flows)))
    counts = ", ".join(f"{k}: {v['one']} = {' + '.join(map(str, v['shares']))}"
                       for k, v in out.items())
    ok = (not differ and same_flows and len(flows) > 0
          and all(v["overlap"] == 0 and v["one"] > 0 for v in out.values()))
    log(f"sharded infer {DDP_WORLD} ranks (gloo) vs 1 process on the entry "
        f"phase's root and checkpoint: files one process = ranks' "
        f"({counts}), byte for byte {not differ}, flows bit for bit "
        f"{same_flows} ({len(flows)}), launches a rank "
        f"{rec['sharded_infer']['launches']} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"sharded inference differs from one process: "
                             f"{sorted(differ)[:20]} {out}")
    return dict(files=out, flows=len(flows))


# the pipeline phase: b5's stage 3 at 352^2 over the ddp phase's ranks
PIPE_DEPTH, PIPE_DIM, PIPE_HEADS, PIPE_SR, PIPE_MLP = 40, 320, 5, 2, 4
PIPE_SIDE = SIZE // 16   # 22 x 22 tokens; sr 2 gives kernel A 121 keys
PIPE_MICRO = 4
PIPE_VALUE_REL = 1e-5    # JAX's bound for its PVT stack's values
PIPE_GRAD_REL = 1e-4     # and for grads, of each tensor's scale


def _pipeline_stack(device) -> list:
    """b5's stage-3 blocks on seeded weights, eval mode."""
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.models.pvt_v2 import PVTBlock

    return [seeded_init_(PVTBlock(PIPE_DIM, PIPE_HEADS, PIPE_MLP, PIPE_SR),
                         SEED + 60 + i).to(device).eval()
            for i in range(PIPE_DEPTH)]


def _stack_copy(blocks, dtype) -> list:
    """A copy of ``blocks`` computing in ``dtype``."""
    import copy

    from emip_tpu_torch.dtypes import set_compute_dtype

    out = [copy.deepcopy(b) for b in blocks]
    for b in out:
        set_compute_dtype(b, dtype)
    return out


def _pipeline_run(blocks, x, cot, mode: str) -> dict:
    """<y, cot> of the stack on ``x`` and its grads, run three ways
    (``mode``): ``pipe`` pipelined over the group in PIPE_MICRO
    microbatches; ``micro`` the plain block loop on the same
    microbatches, each one's backward run in the pipeline's order (last
    microbatch first); ``loop`` the plain loop on the whole batch. Returns
    y, the input's grad, each held block's parameter grads, kernel A's
    launches and the CUDA-event ms."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.pipeline import pipeline_blocks

    x = x.clone().requires_grad_(True)

    def loop(t):
        for blk in blocks:
            t = blk(t, PIPE_SIDE, PIPE_SIDE)
        return t

    def run():
        if mode == "pipe":
            y = pipeline_blocks(blocks, x, PIPE_SIDE, PIPE_SIDE, PIPE_MICRO)
        elif mode == "loop":
            y = loop(x)
        else:
            parts = [p.detach().requires_grad_(True)
                     for p in x.chunk(PIPE_MICRO)]
            outs = [loop(p) for p in parts]
            # d<y, cot>/dy as the pipeline's backward receives it
            gy = cot.to(outs[0].dtype).chunk(PIPE_MICRO)
            for m in reversed(range(PIPE_MICRO)):
                torch.autograd.backward(outs[m], gy[m])
            x.grad = torch.cat([p.grad for p in parts])
            return torch.cat(outs)
        (y.float() * cot).sum().backward()
        return y

    torch.cuda.synchronize()
    K.reset_launches()
    y, ms = timed_call(run)
    return dict(y=y.detach(), gx=x.grad, ms=ms,
                launches={k: v for k, v in K.LAUNCHES.items() if v},
                grads=[None if all(p.grad is None for p in b.parameters())
                       else [p.grad.clone() for p in b.parameters()]
                       for b in blocks])


def _pipeline_rank(rank: int, device) -> dict:
    """The pipeline over the group's ranks (each holding PIPE_DEPTH /
    DDP_WORLD consecutive blocks) at batch 8, fp32 and bf16, held on this
    rank in one process to the plain block loop on the same microbatches
    (values to PIPE_VALUE_REL of their scale, the input's and every held
    parameter's grad to PIPE_GRAD_REL of its scale, in both dtypes; the
    tensors equal bit for bit counted) and to the plain loop on the whole
    batch: fp32 to the same tolerances, bf16 within twice that loop's
    bf16-vs-fp32 gap (by max and by mean over the values, and over all
    grads). Kernel A forward and backward PIPE_MICRO times a held block,
    and no other kernel."""
    import torch

    from emip_tpu_torch.pipeline import stage_blocks

    gen = torch.Generator(device=device).manual_seed(SEED + 70)
    n = PIPE_SIDE * PIPE_SIDE
    x = torch.randn(BATCH, n, PIPE_DIM, generator=gen, device=device)
    cot = torch.randn(BATCH, n, PIPE_DIM, generator=gen, device=device)
    out, runs, seeded = {}, {}, _pipeline_stack(device)
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        blocks = _stack_copy(seeded, dtype)
        xin = x.to(dtype)
        runs[name] = {mode: _pipeline_run(
            blocks if mode == "pipe" else _stack_copy(seeded, dtype), xin,
            cot, mode) for mode in ("pipe", "micro", "loop")}
        held = len(stage_blocks(blocks))
        suffix = "" if dtype == torch.float32 else "_bf16"
        want = {f"sr_attention{suffix}": held * PIPE_MICRO,
                f"sr_attention_bwd{suffix}": held * PIPE_MICRO}
        got = runs[name]["pipe"]["launches"]
        if got != want:
            raise AssertionError(f"pipeline {name} rank {rank}: launches "
                                 f"{got} != {want}")
        out[name] = dict(held=held, launches=got,
                         ms=runs[name]["pipe"]["ms"],
                         plain_ms=runs[name]["loop"]["ms"])

    def pairs(pipe, plain):
        """(got, want) of the values, the input's grad and the held
        blocks' grads."""
        yield pipe["y"], plain["y"]
        yield pipe["gx"], plain["gx"]
        for g, w in zip(pipe["grads"], plain["grads"]):
            if g is not None:
                yield from zip(g, w)

    def rels(pipe, plain):
        """(values rel, worst grad rel, tensors equal bit for bit, of
        how many)."""
        got = list(pairs(pipe, plain))
        rel = [((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-30)).item()
               for g, w in got]
        return (rel[0], max(rel[1:]),
                sum(bool(torch.equal(g, w)) for g, w in got), len(got))

    checks, ok = {}, True
    for name in ("fp32", "bf16"):
        r = runs[name]
        checks[name + "_micro"] = rels(r["pipe"], r["micro"])
        if name == "fp32":
            checks["fp32_loop"] = rels(r["pipe"], r["loop"])
    for key, (vrel, grel, _, _) in checks.items():
        ok = ok and vrel <= PIPE_VALUE_REL and grel <= PIPE_GRAD_REL

    def cat(ts):
        return torch.cat([t.double().flatten() for t in ts])

    band = {}
    p16, l16 = runs["bf16"]["pipe"], runs["bf16"]["loop"]
    p32, l32 = runs["fp32"]["pipe"], runs["fp32"]["loop"]
    for part, idx in (("values", slice(0, 1)), ("grads", slice(1, None))):
        got = cat([g for g, _ in pairs(p16, l16)][idx])
        want = cat([w for _, w in pairs(p16, l16)][idx])
        ref = cat([w for _, w in pairs(p32, l32)][idx])
        err, gap = (got - want).abs(), (want - ref).abs()
        band[part] = dict(max=(err.max().item(), gap.max().item()),
                          mean=(err.mean().item(), gap.mean().item()))
    ok = ok and all(v["max"][1] > 0 and v["max"][0] <= 2 * v["max"][1]
                    and v["mean"][0] <= 2 * v["mean"][1]
                    for v in band.values())
    log(f"pipeline rank {rank}: b5 stage 3 ({PIPE_DEPTH} blocks, C "
        f"{PIPE_DIM}, {PIPE_SIDE}x{PIPE_SIDE} tokens, sr {PIPE_SR}), batch "
        f"{BATCH}, {PIPE_MICRO} microbatches, {out['fp32']['held']} blocks "
        f"held; (values rel, grads worst rel, tensors bit-equal, of) "
        f"against the plain loop on the same microbatches: fp32 "
        f"{checks['fp32_micro']}, bf16 {checks['bf16_micro']}; fp32 "
        f"against the loop on the whole batch {checks['fp32_loop']} (tol "
        f"{PIPE_VALUE_REL}, {PIPE_GRAD_REL}); bf16 against the whole-batch "
        f"loop (error, that loop's bf16-vs-fp32 gap; within twice it) "
        f"{band}; launches fp32 {out['fp32']['launches']} bf16 "
        f"{out['bf16']['launches']}; ms fp32 {out['fp32']['ms']:.1f} (loop "
        f"{out['fp32']['plain_ms']:.1f}), bf16 {out['bf16']['ms']:.1f} "
        f"(loop {out['bf16']['plain_ms']:.1f}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"pipeline rank {rank} disagrees with the "
                             f"plain loop")
    return dict(out, checks=checks, bf16=band)


def ddp_phase(entry: dict, card: str) -> dict:
    """Data parallelism on the one card: DDP_WORLD spawned ranks over gloo
    (NCCL refuses two ranks on one device), b5 at 352^2, global batch 8
    with drop path 0.1, one fp32 and one bf16 short train step each held
    to the one-process step on the same rows and weights, and one step of
    ``train_short`` on the entry phase's YAML and root at 4 rows a rank,
    with its validation (``_ddp_rank``): the ranks end equal, and the first
    rank alone writes the scalars and checkpoints. Beside them one
    ``torchrun --standalone --nproc_per_node 1 -m emip_tpu_torch.train
    --multi_host`` step on the entry phase's YAML (without its validation)
    and root, over NCCL. Both run at once: the card has room for the three
    processes, and the steps are checked, not timed. The same ranks then
    run FSDP (the steps again, sharded, and ``train_short`` with
    ``parallel.fsdp``), sharded inference on the entry phase's YAML,
    checkpoint and root, and the pipeline over b5's stage 3
    (``_ddp_rank``)."""
    import shutil

    import torch
    import torch.multiprocessing as mp
    import yaml

    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "ddp")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "rank{rank}.json")
    torch.cuda.empty_cache()

    save = os.path.join(entry["work"], "ddp_run")
    with open(entry["config"]) as f:
        raw = yaml.safe_load(f)
    config = os.path.join(entry["work"], "ddp.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(dict(raw, epoch_val=0), f)
    # train_short on the ranks: each its own save_path, so that what the
    # other rank wrote shows; the global batch that of the entry phase
    rank_saves = [os.path.join(entry["work"], "ddp_ranks", f"rank{r}")
                  for r in range(DDP_WORLD)]
    shutil.rmtree(os.path.dirname(rank_saves[0]), ignore_errors=True)
    trainer_yaml = os.path.join(entry["work"], "ddp_rank{rank}.yaml")
    fsdp_yaml = os.path.join(entry["work"], "fsdp_rank{rank}.yaml")
    fsdp_saves = [os.path.join(entry["work"], "fsdp_ranks", f"rank{r}")
                  for r in range(DDP_WORLD)]
    shutil.rmtree(os.path.dirname(fsdp_saves[0]), ignore_errors=True)
    per = raw["train_dataset"]["batch_size"] // DDP_WORLD
    for r, path in enumerate(rank_saves):
        with open(trainer_yaml.format(rank=r), "w") as f:
            yaml.safe_dump(dict(raw, save_path=path, train_dataset=dict(
                raw["train_dataset"], batch_size=per)), f)
        with open(fsdp_yaml.format(rank=r), "w") as f:
            yaml.safe_dump(dict(raw, save_path=fsdp_saves[r],
                                parallel=dict(fsdp=True),
                                train_dataset=dict(raw["train_dataset"],
                                                   batch_size=per)), f)
    # sharded inference: the entry phase's YAML, checkpoint and root
    infer = dict(config=entry["config"], ckpt=entry["ckpt"],
                 root=entry["root"],
                 out=os.path.join(entry["work"], "sharded_infer"))
    shutil.rmtree(infer["out"], ignore_errors=True)
    launcher = shutil.which("torchrun")
    cmd = ([launcher] if launcher else
           [sys.executable, "-m", "torch.distributed.run"]) + [
        "--standalone", "--nproc_per_node", "1", "-m", "emip_tpu_torch.train",
        "--multi_host", "--config", config, "--save_path", save,
        "--max_steps_per_epoch", "1"]
    # its output to files: a pipe left unread while the ranks run could
    # fill and stall it
    logs = [os.path.join(out_dir, f"torchrun.{n}") for n in ("out", "err")]
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        torchrun = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err)

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_ddp_rank,
                         args=(r, port, out_path, trainer_yaml, fsdp_yaml,
                               infer))
             for r in range(DDP_WORLD)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(900)
        torchrun.wait(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if torchrun.poll() is None:
            torchrun.kill()
            torchrun.wait()
    seconds = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0] * DDP_WORLD:
        raise AssertionError(f"ddp ranks exited with {codes}")
    ranks = []
    for r in range(DDP_WORLD):
        with open(out_path.format(rank=r)) as f:
            ranks.append(json.load(f))
    for rec in ranks:
        log(f"ddp rank {rec['rank']}: {rec['seconds']:.1f} s; first (cold) "
            f"step fp32 {rec['fp32']['step_ms']:.1f} ms, bf16 "
            f"{rec['bf16']['step_ms']:.1f} ms; peak memory fp32 "
            f"{rec['fp32']['peak_bytes'] / 2**30:.3f} GiB, bf16 "
            f"{rec['bf16']['peak_bytes'] / 2**30:.3f} GiB ({card})")
    one = ranks[0]["one_process"]
    log(f"ddp one process, 8 rows: first (cold) step fp32 "
        f"{one['fp32']['step_ms']:.1f} ms, bf16 "
        f"{one['bf16']['step_ms']:.1f} ms; peak memory fp32 "
        f"{one['fp32']['peak_bytes'] / 2**30:.3f} GiB, bf16 "
        f"{one['bf16']['peak_bytes'] / 2**30:.3f} GiB ({card})")
    log(f"ddp fp32 nudge band from {ranks[0]['nudges']} of at most "
        f"{DDP_NUDGES} nudged one-process steps")

    # train_short on the ranks: equal by digest inside _ddp_rank; the
    # first rank alone wrote, each scalar record once
    first, other = rank_saves[0], rank_saves[1:]
    with open(os.path.join(first, "scalars.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    wrote = [p for p in other if os.path.exists(p) and os.listdir(p)]
    summary = ranks[0]["train_short"]
    ok = (all(rec["train_short"]["steps"] == 1 for rec in ranks)
          and os.path.isfile(os.path.join(first, "ckpt", "ckpt.pt"))
          and os.path.isfile(os.path.join(first, "ckpt_best", "ckpt.pt"))
          and tags.count("learning_rate") == 1 and "val/MAE" in tags
          and np.isfinite(summary["best_mae"]) and not wrote)
    log(f"ddp train_short on {DDP_WORLD} ranks, {per} rows a rank: steps "
        f"{[rec['train_short']['steps'] for rec in ranks]}, val MAE "
        f"{summary['best_mae']:.5f}, ranks equal, checkpoints and "
        f"{len(tags)} scalar records by the first rank only "
        f"{'ok' if ok else 'FAILED'}, {summary['seconds']:.1f} s ({card})")
    if not ok:
        raise AssertionError(f"ddp train_short: {tags}, other ranks "
                             f"wrote {wrote}")

    # FSDP on the same ranks: the steps held inside _ddp_rank; here the
    # memory beside DDP's and what train_short wrote
    for rec in ranks:
        log(f"fsdp rank {rec['rank']}: first (cold) step fp32 "
            f"{rec['fsdp_fp32']['step_ms']:.1f} ms, bf16 "
            f"{rec['fsdp_bf16']['step_ms']:.1f} ms; peak memory fp32 "
            f"{rec['fsdp_fp32']['peak_bytes'] / 2**30:.3f} GiB (ddp "
            f"{rec['fp32']['peak_bytes'] / 2**30:.3f}), bf16 "
            f"{rec['fsdp_bf16']['peak_bytes'] / 2**30:.3f} GiB (ddp "
            f"{rec['bf16']['peak_bytes'] / 2**30:.3f}); held before the "
            f"step fp32 {rec['fsdp_fp32']['held_bytes'] / 2**30:.3f} GiB, "
            f"bf16 {rec['fsdp_bf16']['held_bytes'] / 2**30:.3f} (ddp "
            f"{rec['fp32']['held_bytes'] / 2**30:.3f}, "
            f"{rec['bf16']['held_bytes'] / 2**30:.3f}), of it the earlier "
            f"steps' readings kept for the checks "
            f"{rec['fsdp_fp32']['kept_bytes'] / 2**30:.3f}, "
            f"{rec['fsdp_bf16']['kept_bytes'] / 2**30:.3f} (ddp "
            f"{rec['fp32']['kept_bytes'] / 2**30:.3f}, "
            f"{rec['bf16']['kept_bytes'] / 2**30:.3f}); peak less those "
            f"readings fp32 "
            f"{_own_peak(rec['fsdp_fp32']) / 2**30:.3f} GiB (ddp "
            f"{_own_peak(rec['fp32']) / 2**30:.3f}), bf16 "
            f"{_own_peak(rec['fsdp_bf16']) / 2**30:.3f} (ddp "
            f"{_own_peak(rec['bf16']) / 2**30:.3f}); all-gathered "
            f"whole: the root's own parameters "
            f"{rec['fsdp_fp32']['root_bytes'] / 2**30:.3f} GiB, the largest "
            f"unit {rec['fsdp_fp32']['unit_max_bytes'] / 2**30:.3f} GiB; "
            f"train_short step "
            f"and validation {rec['fsdp_train_short']['seconds']:.1f} s, "
            f"peak {rec['fsdp_train_short']['peak_bytes'] / 2**30:.3f} GiB "
            f"({card})")
    with open(os.path.join(fsdp_saves[0], "scalars.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    wrote = [p for p in fsdp_saves[1:] if os.path.exists(p) and os.listdir(p)]
    summary = ranks[0]["fsdp_train_short"]
    ok = (all(rec["fsdp_train_short"]["steps"] == 1 for rec in ranks)
          and os.path.isfile(os.path.join(fsdp_saves[0], "ckpt_best",
                                          "ckpt.pt"))
          and tags.count("learning_rate") == 1 and "val/MAE" in tags
          and np.isfinite(summary["best_mae"]) and not wrote)
    log(f"fsdp train_short (parallel.fsdp) on {DDP_WORLD} ranks, {per} rows "
        f"a rank: steps {[rec['fsdp_train_short']['steps'] for rec in ranks]}"
        f", val MAE {summary['best_mae']:.5f} (ddp "
        f"{ranks[0]['train_short']['best_mae']:.5f}), validation on every "
        f"rank, ranks equal, checkpoints and {len(tags)} scalar records by "
        f"the first rank only {'ok' if ok else 'FAILED'} ({card})")
    if not ok:
        raise AssertionError(f"fsdp train_short: {tags}, other ranks "
                             f"wrote {wrote}")
    for rec in ranks:
        log(f"sharded infer rank {rec['rank']}: "
            f"{rec['sharded_infer']['flows']} flows received, "
            f"{rec['sharded_infer']['seconds']:.1f} s, launches "
            f"{rec['sharded_infer']['launches']} ({card})")

    with open(logs[0]) as out, open(logs[1]) as err:
        stdout, stderr = out.read(), err.read()
    joined = "over nccl on cuda:0" in stderr + stdout
    done = [line for line in stdout.splitlines()
            if line.startswith(">>> training done")]
    ok = (torchrun.returncode == 0 and joined and done
          and "'steps': 1" in done[0]
          and os.path.isfile(os.path.join(save, "ckpt", "ckpt.pt")))
    log(f"ddp torchrun --standalone --nproc_per_node 1 -m "
        f"emip_tpu_torch.train --multi_host: rc {torchrun.returncode}, "
        f"joined over NCCL {joined}, {done[0] if done else 'no summary'} "
        f"{'ok' if ok else 'FAILED'} ({card})")
    if not ok:
        raise AssertionError(f"torchrun entry step failed: {stderr[-3000:]}")
    log(f"ddp phase: {seconds:.1f} s ({card})")
    return dict(ranks=ranks, seconds=seconds)


# ------------------------------------------------------ the SAM prompt heads

SAM_BATCH = 8
SAM_REL = 1e-3
SAM_REPS = 5


def sam_phase(device, card: str) -> dict:
    """The SAM prompt heads at their published width on seeded weights:
    ``PromptInteract`` and ``Interact`` on image and flow embeddings [8,
    128, 44, 44] (``inp_size`` 352) and ``PromptGenBlock`` on [8, 192, 44,
    44] (its 96^2 bank shrunk to 44^2); card against CPU in fp32 (SAM_REL
    of max|CPU|, TF32 off) and in bf16 (within twice the larger of the
    card's and the CPU's bf16-vs-fp32 gaps, both above zero); CUDA-event
    ms of each on the card. No kernel of the port runs."""
    import torch

    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.models.init import seeded_init_
    from emip_tpu_torch.models.sam_prompt import (
        Interact,
        PromptGenBlock,
        PromptInteract,
    )

    rng = np.random.default_rng(SEED + 40)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    img, flow = f(SAM_BATCH, 128, 44, 44), f(SAM_BATCH, 128, 44, 44)
    cases = (("PromptInteract", PromptInteract, (img, flow)),
             ("Interact", Interact, (img, flow)),
             ("PromptGenBlock", PromptGenBlock,
              (f(SAM_BATCH, 192, 44, 44),)))
    out = {}
    K.reset_launches()
    for name, cls, args in cases:
        torch.manual_seed(SEED)  # the positional matrix's draw
        state = seeded_init_(cls(), SEED).state_dict()
        if "prompt_param" in state:  # the bank in [0, 1), as built
            state["prompt_param"] = torch.rand(
                state["prompt_param"].shape,
                generator=torch.Generator().manual_seed(SEED))
        got, ms = {}, {}
        for dt in (torch.float32, torch.bfloat16):
            for dev in (device, torch.device("cpu")):
                with torch.device(dev):
                    m = cls(dtype=dt)
                m.load_state_dict(state)
                a = [x.to(dev) for x in args]
                with torch.no_grad():
                    got[dt, dev.type] = m(*a).float().cpu()
                    if dev.type == "cuda":
                        ms[str(dt)] = cuda_ms(lambda: m(*a), SAM_REPS)
        c32, p32 = got[torch.float32, "cuda"], got[torch.float32, "cpu"]
        c16, p16 = got[torch.bfloat16, "cuda"], got[torch.bfloat16, "cpu"]
        rel = ((c32 - p32).abs().max() / p32.abs().max()).item()
        gaps = ((c16 - c32).abs().max().item(),
                (p16 - p32).abs().max().item())
        err16 = (c16 - p16).abs().max().item()
        ok = (rel <= SAM_REL and min(gaps) > 0
              and err16 <= 2 * max(gaps) and torch.isfinite(c16).all())
        log(f"sam {name} {tuple(c32.shape)}: fp32 card vs CPU rel {rel:.3e} "
            f"(tol {SAM_REL}); bf16 card vs CPU {err16:.3e} against gaps "
            f"card {gaps[0]:.3e} / CPU {gaps[1]:.3e}; card ms fp32 "
            f"{ms['torch.float32']:.3f}, bf16 {ms['torch.bfloat16']:.3f} "
            f"({card}) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"sam {name}: card disagrees with the CPU")
        out[name] = dict(fp32_rel=rel, bf16_err=err16, bf16_gaps=gaps,
                         ms=ms, shape=list(c32.shape))
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"the SAM heads launched a kernel of the "
                             f"port: {dict(K.LAUNCHES)}")
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=None, metavar="NAMES",
                    help="development aid: only the kernel phases, and of "
                         "them only the kernels whose name contains one of "
                         "the comma-separated NAMES; prints no result line")
    opts = ap.parse_args(argv)

    # keep CUPTI set up between the script's several hundred profiler
    # sessions (torch's own setting where it profiles CUDA graphs, whose
    # re-initialisation after a teardown it does not trust)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from emip_tpu_torch import kernels as K
    from emip_tpu_torch.kernels._build import build_seconds
    from emip_tpu_torch.models.emip_short import EMIPShort, EMIPShortConfig
    from emip_tpu_torch.models.init import seeded_init_

    device = torch.device("cuda:0")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    K.library()
    log(f"kernel build + load: {build_seconds():.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    if opts.kernels is not None:
        if wanted(opts.kernels, "bf16"):
            bf16_kernel_phase(BATCH, device, KERNEL_REPS)
            bf16_gemm_phase(BATCH, device, KERNEL_REPS)
            bf16_backward_phase(BATCH, device, KERNEL_REPS)
            log("digests " + json.dumps(DIGESTS))
            return 0
        if any(wanted(opts.kernels, name) for name in BF16_KERNEL_INFO):
            bf16_kernel_phase(BATCH, device, KERNEL_REPS, opts.kernels)
        if wanted(opts.kernels, "gemm"):
            gemm_phase(BATCH, device, KERNEL_REPS)
        elif wanted(opts.kernels, "gemm_wgmma"):
            gemm_phase(BATCH, device, KERNEL_REPS, wgmma_only=True)
        if wanted(opts.kernels, "attention_fwd"):
            attention_phase(BATCH, device, KERNEL_REPS)
        if "attention_fwd_bf16" in opts.kernels.split(","):
            attention_bf16_phase(BATCH, device, KERNEL_REPS)
        kernel_phase(BATCH, device, KERNEL_REPS, opts.kernels)
        backward_phase(BATCH, device, KERNEL_REPS, opts.kernels)
        if any(wanted(opts.kernels, name) for name in BF16_BWD_INFO):
            bf16_backward_phase(BATCH, device, KERNEL_REPS, opts.kernels)
        if wanted(opts.kernels, "flow_attention"):
            stats_cost(BATCH, device, KERNEL_REPS)
        if "gmflow_scales" in opts.kernels.split(","):
            gmflow_scales_phase(device, GMFLOW_SCALES_TIMED)
        if "backbones" in opts.kernels.split(","):
            backbones_phase(device)
            backbone_entry_phase(SIZE)
        if "ddp" in opts.kernels.split(","):
            ddp_phase(entry_phase(BATCH, SIZE), card)
        if "sam" in opts.kernels.split(","):
            sam_phase(device, card)
        log("digests " + json.dumps(DIGESTS))
        return 0
    gemm_res = gemm_phase(BATCH, device, KERNEL_REPS)
    attention_res = attention_phase(BATCH, device, KERNEL_REPS)
    attention16_res = attention_bf16_phase(BATCH, device, KERNEL_REPS)
    kernels = kernel_phase(BATCH, device, KERNEL_REPS)
    kernels.update(backward_phase(BATCH, device, KERNEL_REPS))
    transpose_ms = transpose_cost(BATCH, device, KERNEL_REPS)
    stats_ms = stats_cost(BATCH, device, KERNEL_REPS)
    tiny = tiny_phase(device)
    torch.cuda.empty_cache()

    cfg = EMIPShortConfig(backbone_name="pvt_v2_b5", inp_size=SIZE)
    model = EMIPShort(cfg)
    seeded_init_(model, SEED)
    model = model.to(device).eval()
    slice_res = slice_phase(model, BATCH, SIZE, device, TIMED_BATCHES)
    # the bf16 band of short inference
    bf16_kernels = bf16_kernel_phase(BATCH, device, KERNEL_REPS)
    bf16_gemm = bf16_gemm_phase(BATCH, device, KERNEL_REPS)
    bf16_slice, model16 = bf16_slice_phase(model, BATCH, SIZE, device,
                                           TIMED_BATCHES, slice_res)
    del model16
    torch.cuda.empty_cache()
    # multi-scale GMFlow (GMFLOW_SCALES): B on 121-token windows, D at x4
    scales_res = gmflow_scales_phase(device, GMFLOW_SCALES_TIMED)
    compare_res = train_compare_phase(model, SIZE, device)
    train_res = train_phase(model, BATCH, SIZE, device, TIMED_STEPS)
    # the bf16 train step: its backward kernels, the card against the CPU,
    # then the timed steps on the fp32 phase's weights
    bf16_bwd = bf16_backward_phase(BATCH, device, KERNEL_REPS)
    bf16_compare = bf16_train_compare_phase(model, SIZE, device)
    # the 512^2 bf16 train step's path (G and H, forward and backward, in
    # place of B) held to the CPU at 352^2 with the block switch below its
    # windows' 484 tokens
    bf16_compare_gh = bf16_train_compare_phase(
        model, SIZE, device, "bf16 train G/H", GH_BF16,
        dataclasses.replace(cfg, gmflow=dataclasses.replace(
            cfg.gmflow, fused_block_max_t=400)), BF16_COMPARE_SEEDS_GH)
    bf16_train = bf16_train_phase(model, BATCH, SIZE, device,
                                  BF16_TIMED_STEPS)
    torch.cuda.empty_cache()
    read_corr_cfg = dataclasses.replace(cfg, gmflow=dataclasses.replace(
        cfg.gmflow, global_match_qk_fused=False))
    always = dataclasses.replace(cfg, fused_ffn="always")
    bwd_fused = dataclasses.replace(cfg, ffn_dwconv="bwd_fused")
    read_corr = variant_phase(
        "read-corr matching", model, read_corr_cfg,
        [("read-corr", read_corr_cfg)], BATCH, SIZE, device, VARIANT_TIMED,
        ("softmax_expectation", "softmax_expectation_bwd"))
    fused_ffn = variant_phase(
        "fused MixFFN", model, always, [("ffn_dwconv=bwd_fused", bwd_fused)],
        BATCH, SIZE, device, VARIANT_TIMED, ("dwconv_gelu", "dwconv_gelu_bwd"))
    # the same two switches in the bf16 band; the seg loss's grads do not
    # pass I (the mask reads the correlation volume, not the flow)
    read_corr16 = variant_phase(
        "read-corr matching", model, read_corr_cfg,
        [("read-corr", read_corr_cfg)], BATCH, SIZE, device, VARIANT_TIMED,
        ("softmax_expectation", "softmax_expectation_bwd"), bf16=True,
        seg_kernels=("softmax_expectation",))
    fused_ffn16 = variant_phase(
        "fused MixFFN", model, always,
        [("fused_ffn=always", always), ("ffn_dwconv=bwd_fused", bwd_fused)],
        BATCH, SIZE, device, VARIANT_TIMED,
        ("dwconv_gelu_bf16", "dwconv_gelu_bwd_bf16"), bf16=True,
        seg_kernels=("dwconv_gelu_bf16", "dwconv_gelu_bwd_bf16"))
    del model
    torch.cuda.empty_cache()
    entry_res = entry_phase(BATCH, SIZE)
    # data parallelism: two ranks on the card against one process, then
    # the torchrun entry step; the SAM prompt heads
    ddp_res = ddp_phase(entry_res, card)
    sam_res = sam_phase(device, card)
    torch.cuda.empty_cache()
    static_res = static_phase(BATCH, SIZE, device, STATIC_TIMED)
    bf16_static = bf16_static_phase(BATCH, SIZE, device, BF16_TIMED_STEPS)
    torch.cuda.empty_cache()
    # the alternate encoders, DGNet and the two-stream model on them
    backbones_res = backbones_phase(device)
    torch.cuda.empty_cache()
    chain_res = entry_chain_phase(entry_res, BATCH, SIZE)
    bf16_entry = bf16_entry_phase(entry_res, SIZE)
    bf16_train_entry = bf16_train_entry_phase(entry_res, chain_res, SIZE)
    backbone_entry = backbone_entry_phase(SIZE)
    torch.cuda.empty_cache()

    from emip_tpu_torch.models.emip_long import EMIPLong

    long_model = EMIPLong(cfg, memory_size=5)
    seeded_init_(long_model, SEED)
    long_model = long_model.to(device).eval()
    long_infer = long_infer_phase(long_model, SIZE, device, LONG_TIMED)
    long_compare = long_train_compare_phase(long_model, SIZE, device)
    long_train = long_train_phase(long_model, SIZE, device, LONG_TIMED)
    # the bf16 long model on the same weights, in turns with them
    long16 = long_bf16_stream_phase(long_model, SIZE, device,
                                    LONG_BF16_TIMED)
    long16_train = long_bf16_train_phase(long_model, SIZE, device,
                                         LONG_BF16_TIMED)
    del long_model
    torch.cuda.empty_cache()
    long16_compare = long_bf16_compare_phase(SIZE, device)
    torch.cuda.empty_cache()
    long_entry = long_entry_phase(SIZE)
    long16_entry = long_bf16_entry_phase(long_entry, SIZE)
    torch.cuda.empty_cache()
    train512_entry = bf16_train512_entry_phase(entry_res)
    torch.cuda.empty_cache()

    # 512^2: windows of 1024 tokens, so kernels G and H in place of B
    cfg512 = dataclasses.replace(cfg, inp_size=SIZE_512)
    model512 = EMIPShort(cfg512)
    seeded_init_(model512, SEED)
    model512 = model512.to(device)
    train512 = train_phase(model512, TRAIN_BATCH_512, SIZE_512, device,
                           TIMED_STEPS_512, TRAIN_KERNELS_512)
    # the bf16 short train step at 512^2 on the same weights, in turns
    # with the fp32 steps
    train512_16 = bf16_train_phase(model512, TRAIN_BATCH_512, SIZE_512,
                                   device, LONG_BF16_TIMED)
    per_step = {k: v // (1 + LONG_BF16_TIMED)
                for k, v in train512_16["launches"].items()}
    layers = len(model512.GMFlow.transformer.layers)
    if (any(per_step[k] != layers for k in GH_BF16)
            or per_step["window_attention_block_bf16"]
            or per_step["window_attention_block_bwd_bf16"]):
        raise AssertionError(f"the 512^2 bf16 train step did not run G and "
                             f"H {layers} times each, forward and backward, "
                             f"in place of B: {per_step}")
    short512_16 = bf16_short512_phase(model512, BATCH_512, device,
                                      LONG_BF16_TIMED)
    del model512
    torch.cuda.empty_cache()
    long512 = EMIPLong(cfg512, memory_size=5)
    seeded_init_(long512, SEED)
    long512 = long512.to(device).eval()
    long_infer512 = long_infer_phase(long512, SIZE_512, device, LONG_TIMED)
    long16_512 = long_bf16_stream_phase(long512, SIZE_512, device,
                                        LONG_BF16_TIMED)
    for clips in LONG_CLIPS:
        for got, g, h, b in (
                (long_infer512[f"clips{clips}"]["launches"],
                 "window_attention_layer", "window_attention_ffn_layer",
                 "window_attention_block"),
                (long16_512[f"clips{clips}"]["launches"],
                 "window_attention_layer_bf16",
                 "window_attention_ffn_layer_bf16",
                 "window_attention_block_bf16")):
            if got[b] or not got[g] or not got[h]:
                raise AssertionError(f"512^2 streaming did not run G and H: "
                                     f"{got}")
    del long512
    torch.cuda.empty_cache()

    # launches on the main paths, each counted from 0 just before its run:
    # the short train step's; for the memory read the long train steps';
    # for G and H the 512^2 train steps'; for I and J the read-corr and
    # fused-MixFFN runs'
    runs = (train_res["launches"], long_train["clips4"]["launches"],
            train512["launches"], read_corr["train"]["read-corr"]["launches"],
            fused_ffn["infer"]["launches"],
            fused_ffn["train"]["ffn_dwconv=bwd_fused"]["launches"])
    launches = {name: next((r[name] for r in runs if r[name]), 0)
                for name in KERNEL_INFO}
    # the bf16 forwards of A-D: the bf16 slice's run, of F: the bf16 long
    # streaming run at 4 clips, of G and H: the bf16 long streaming run at
    # 512^2 and 4 clips; the bf16 backwards of A-D: the bf16 train steps'
    # run, of F: the bf16 long train steps'
    launches.update({name + "_bf16": bf16_slice["launches"][name + "_bf16"]
                     for name in FWD_KERNELS})
    launches["memory_attention_bf16"] = long16["clips4"]["launches"][
        "memory_attention_bf16"]
    for name in ("window_attention_layer_bf16",
                 "window_attention_ffn_layer_bf16"):
        launches[name] = long16_512["clips4"]["launches"][name]
    launches.update({name: bf16_train["launches"][name]
                     for name in BF16_BWD_INFO})
    launches["memory_attention_bwd_bf16"] = long16_train["launches"][
        "memory_attention_bwd_bf16"]
    # G's and H's bf16 backwards: the bf16 512^2 train steps' run; J's bf16
    # forward: the bf16 fused-MixFFN inference run, its backward: that
    # switch's bf16 train run
    for name in ("window_attention_layer_bwd_bf16",
                 "window_attention_ffn_layer_bwd_bf16"):
        launches[name] = train512_16["launches"][name]
    launches["dwconv_gelu_bf16"] = fused_ffn16["infer"]["launches"][
        "dwconv_gelu_bf16"]
    launches["dwconv_gelu_bwd_bf16"] = fused_ffn16["train"][
        "fused_ffn=always"]["launches"]["dwconv_gelu_bwd_bf16"]
    kernels.update(bf16_kernels)
    kernels.update(bf16_bwd)
    info = dict(KERNEL_INFO, **BF16_KERNEL_INFO, **BF16_BWD_INFO)
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    # the shapes of multi-scale GMFlow (scales_cases), listed in their rows
    scales = {name: [{k: c[k] for k in ("case", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "device_ms")
                      if k in c}
                     for c in kernels[name]["cases"]
                     if c["case"].startswith("multi-scale")]
              for name in info}
    line = {"kernels": [
        dict(name=name, route="cuda", source=info[name][0],
             replaces=info[name][1], launches=launches[name],
             max_abs_err=kernels[name]["max_abs_err"],
             ms=kernels[name]["ms"], plain_ms=kernels[name]["plain_ms"],
             bound_ms=kernels[name]["bound_ms"],
             bound_by=kernels[name]["bound_by"],
             library_ms=kernels[name]["library_ms"],
             **({"fp32_bound_ms": kernels[name]["fp32_bound_ms"],
                 "bound_rate": kernels[name]["bound_rate"]}
                if "bound_rate" in kernels[name] else {}),
             **{k: kernels[name][k] for k in ("fp64_ratio", "sdpa_ms",
                                              "device_ms")
                if k in kernels[name]},
             **({"multiscale": scales[name]} if scales[name] else {}))
        for name in info]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, gemm=gemm_res, attention=attention_res,
                       attention_bf16=attention16_res,
                       kernels=kernels,
                       slice=slice_res,
                       train=train_res, train_compare=compare_res,
                       entry=entry_res, static=static_res,
                       entry_chain=chain_res, long_infer=long_infer,
                       long_train_compare=long_compare,
                       long_train=long_train, long_entry=long_entry,
                       read_corr=read_corr, fused_ffn=fused_ffn,
                       read_corr_transpose_ms=transpose_ms,
                       flow_attention_stats_ms=stats_ms, tiny=tiny,
                       train_512=train512, long_infer_512=long_infer512,
                       bf16_gemm=bf16_gemm, bf16_slice=bf16_slice,
                       bf16_entry=bf16_entry, bf16_compare=bf16_compare,
                       bf16_train=bf16_train, bf16_static=bf16_static,
                       bf16_train_entry=bf16_train_entry,
                       bf16_long_infer=long16, bf16_long_train=long16_train,
                       bf16_long_compare=long16_compare,
                       bf16_long_entry=long16_entry,
                       bf16_short_512=short512_16,
                       bf16_long_infer_512=long16_512,
                       bf16_compare_gh=bf16_compare_gh,
                       bf16_train_512=train512_16,
                       bf16_read_corr=read_corr16, bf16_fused_ffn=fused_ffn16,
                       bf16_train_512_entry=train512_entry,
                       gmflow_scales=scales_res, backbones=backbones_res,
                       backbone_entry=backbone_entry, ddp=ddp_res,
                       sam_heads=sam_res, digests=DIGESTS),
                  f, indent=1, default=str)
    log("digests " + json.dumps(DIGESTS))
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
