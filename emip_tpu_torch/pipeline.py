"""GPipe pipeline parallelism over a stack of PVT blocks.

Counterpart of :func:`emip_tpu.parallel.pipeline.pipeline_blocks`: ``L``
blocks of one width split over the ``S`` ranks of a process group (the
mesh's stage axis), rank ``s`` holding blocks ``[sK, (s+1)K)`` with ``K =
L / S``, and ``M`` microbatches streamed through the stages. The result is
the sequential block loop's, values and grads: sharding changes
communication, never arithmetic. Each block runs whole on a rank, at the
microbatch's rows, so every kernel keeps the shapes and bits it has in
one process at that batch.

Schedule (plain GPipe): stage ``s`` takes microbatch ``m`` from stage
``s - 1`` (stage 0 from the input), runs its blocks and hands the result
to stage ``s + 1``; the last stage's outputs are published on every rank.
The backward runs the microbatches in reverse, the grads flowing from
stage ``s + 1`` back to ``s``. The transport is point-to-point send /
recv, each message tagged with its microbatch; over gloo a CUDA tensor is
staged through host memory (gloo's send / recv take host tensors only),
over NCCL it goes from card to card.

Microbatching is exact for blocks that treat each sample alone (LayerNorm,
attention within a sample): the blocks run at drop path 0 (deterministic),
as the JAX package's test runs them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["stage_blocks", "pipeline_blocks"]


def _stages() -> tuple[int, int]:
    """(this rank's stage, stage count): the rank and size of the process
    group, (0, 1) without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def stage_blocks(blocks: Sequence[torch.nn.Module]) -> list[torch.nn.Module]:
    """This rank's contiguous ``L / S`` of the ``L`` ``blocks``; raises
    ``ValueError`` when ``L`` is not a multiple of the stage count."""
    stage, count = _stages()
    depth = len(blocks)
    if depth % count != 0:
        raise ValueError(f"depth {depth} not divisible by {count} stages")
    k = depth // count
    return list(blocks[stage * k:(stage + 1) * k])


def _staged(t: torch.Tensor) -> bool:
    """True where ``t`` must go through host memory: a CUDA tensor over
    a gloo group."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _send(t: torch.Tensor, stage: int, tag: int) -> None:
    t = t.detach().contiguous()
    if _staged(t):
        t = t.cpu()
    dist.send(t, stage, tag=tag)


def _recv(like: torch.Tensor, stage: int, tag: int) -> torch.Tensor:
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _staged(like) else like.device)
    dist.recv(buf, stage, tag=tag)
    return buf.to(like.device)


class _Pipeline(torch.autograd.Function):
    """The whole schedule as one autograd node on every rank: the forward
    runs this stage's blocks on each microbatch under autograd of their
    own and keeps their graphs; the backward runs them in reverse."""

    @staticmethod
    def forward(ctx, x, h, w, blocks, micro, grad, *anchor):
        stage, count = _stages()
        parts = x.chunk(micro)
        kept, outs = [], []
        for m, part in enumerate(parts):
            inp = part if stage == 0 else _recv(part, stage - 1, m)
            inp = inp.detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                out = _run(blocks, inp, h, w)
            if stage < count - 1:
                _send(out, stage + 1, m)
            kept.append((inp, out))
            outs.append(out.detach())
        y = torch.cat(outs) if stage == count - 1 else torch.empty_like(x)
        ctx.kept, ctx.stage, ctx.count = kept, stage, count
        dist.broadcast(y, count - 1)
        return y

    @staticmethod
    def backward(ctx, gy):
        stage, count = ctx.stage, ctx.count
        # every rank computed its loss from the published output: the
        # last stage takes the mean of the ranks' cotangents
        gy = gy.contiguous().clone()
        dist.all_reduce(gy)
        parts = (gy / count).chunk(len(ctx.kept))
        gx = []
        for m in reversed(range(len(ctx.kept))):
            inp, out = ctx.kept[m]
            g = parts[m] if stage == count - 1 else _recv(out, stage + 1, m)
            torch.autograd.backward(out, g)
            gin = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if stage > 0:
                _send(gin, stage - 1, m)
            gx.append(gin)
        ctx.kept = None
        # the input's grad lives on the first stage: publish it
        gx = torch.cat(gx[::-1]) if stage == 0 else torch.empty_like(gy)
        dist.broadcast(gx, 0)
        return (gx,) + (None,) * (len(ctx.needs_input_grad) - 1)


def pipeline_blocks(blocks: Sequence[torch.nn.Module], x: torch.Tensor,
                    h: int, w: int, num_microbatches: int) -> torch.Tensor:
    """Apply the ``L`` PVT ``blocks`` to the tokens ``x`` [B, h * w, C],
    pipelined over the ranks of the process group:
    the same value as ``for blk in blocks: x = blk(x, h, w)``, published on
    every rank, and differentiable: a backward from every rank's loss on
    the output gives each stage's parameters their grads and every rank
    the input's grad (the grad of the mean of the ranks' losses, which is
    the loss itself where every rank computes the same one).

    Every rank passes the whole list; it runs only its own stage
    (:func:`stage_blocks`), so the others' blocks take no grad there. The
    blocks run at drop path 0. ``B`` must divide into
    ``num_microbatches`` (``ValueError`` otherwise, as ``L`` that does not
    divide over the stages). With one rank it is the plain loop over the
    microbatches."""
    local = stage_blocks(blocks)
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(f"local batch {b} not divisible by "
                         f"{num_microbatches} microbatches")
    if _stages()[1] == 1:
        return torch.cat([_run(local, part, h, w)
                          for part in x.chunk(num_microbatches)])
    grad = torch.is_grad_enabled()
    # an anchor that needs grad on every rank under autograd, so that every
    # rank's backward reaches the node (its collectives need every rank)
    anchor = torch.empty(0, device=x.device, requires_grad=grad)
    return _Pipeline.apply(x, h, w, local, num_microbatches, grad, anchor)


def _run(blocks, x, h, w):
    for blk in blocks:
        x = blk(x, h, w)
    return x
