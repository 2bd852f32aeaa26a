"""Kernel D: RAFT convex x K flow upsampling, forward and backward.

Port of :func:`emip_tpu.ops.pallas.convex_upsample.convex_upsample_pallas`;
the CUDA source is ``csrc/convex_upsample.cu``. :func:`convex_upsample` is
one ``torch.autograd.Function``: CPU tensors take the plain version (and
its autograd backward), CUDA tensors the forward and backward kernels.
In the bf16 band the mask logits are bf16 (flow fp32): the forward kernel
reads them as bf16 and computes in fp32 (``emip_convex_upsample_bf16``),
writing fp32, and the backward kernel (``emip_convex_upsample_bwd_bf16``)
reads them as bf16 and writes their grad in bf16 (the flow's in fp32), as
the JAX kernel's backward upcasts its logits and rounds their grad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["convex_upsample", "convex_upsample_reference"]

_NAME = "convex_upsample"


def convex_upsample_reference(flow, mask_logits, k: int = 8) -> torch.Tensor:
    """Plain PyTorch version of :func:`convex_upsample` (bf16 logits are
    upcast, everything after is fp32)."""
    if mask_logits.dtype == torch.bfloat16:
        mask_logits = mask_logits.float()
    b, h, w, _ = flow.shape
    pad = F.pad(flow * k, (0, 0, 1, 1, 1, 1))
    nb = torch.stack([pad[:, dy:dy + h, dx:dx + w, :]
                      for dy in range(3) for dx in range(3)], dim=3)
    weights = torch.softmax(mask_logits.reshape(b, h, w, 9, k, k), dim=3)
    up = torch.einsum("bhwnkl,bhwnc->bhwklc", weights, nb)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * k, w * k, 2)


def _check_shapes(flow, mask_logits, k) -> None:
    if flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"{_NAME}: flow must be [B, h, w, 2]")
    if not 1 <= k <= 32:
        raise ValueError(f"{_NAME}: factor {k} not in [1, 32]")
    b, h, w, _ = flow.shape
    cm.check_shape(_NAME, "mask_logits", mask_logits, (b, h, w, 9 * k * k))


class _ConvexUpsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flow, mask_logits, k, keep):
        ctx.k = k
        ctx.cpu = cm.on_cpu(_NAME, flow, mask_logits)
        if keep:
            ctx.save_for_backward(flow, mask_logits)
        if ctx.cpu:
            return convex_upsample_reference(flow, mask_logits, k)
        cm.check_kernel_args(_NAME, flow=flow, mask_logits=mask_logits)
        _check_shapes(flow, mask_logits, k)
        b, h, w, _ = flow.shape
        out = torch.empty((b, h * k, w * k, 2), device=flow.device,
                          dtype=flow.dtype)
        rc = library().emip_convex_upsample(
            flow.data_ptr(), mask_logits.data_ptr(), out.data_ptr(), b, h, w,
            k, cm.stream_handle(flow.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["convex_upsample"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:2]
        flow, mask_logits = ctx.saved_tensors
        if ctx.cpu:
            return (*cm.plain_vjp(convex_upsample_reference,
                                  (flow, mask_logits), needs, g, ctx.k),
                    None, None)
        g = g.contiguous()
        b, h, w, _ = flow.shape
        gflow = torch.empty_like(flow)
        gmask = torch.empty_like(mask_logits)
        gnb = torch.empty((b, h, w, 9, 2), device=flow.device,
                          dtype=flow.dtype)
        rc = library().emip_convex_upsample_bwd(
            flow.data_ptr(), mask_logits.data_ptr(), g.data_ptr(),
            gflow.data_ptr(), gmask.data_ptr(), gnb.data_ptr(), b, h, w,
            ctx.k, cm.stream_handle(flow.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["convex_upsample_bwd"] += 1
        return (gflow if needs[0] else None, gmask if needs[1] else None,
                None, None)


class _ConvexUpsampleBf16(torch.autograd.Function):
    """The bf16 band: bf16 mask logits, fp32 flow and output."""

    @staticmethod
    def forward(ctx, flow, mask_logits, k, keep):
        ctx.k = k
        ctx.cpu = cm.on_cpu(_NAME, flow, mask_logits)
        if keep:
            ctx.save_for_backward(flow, mask_logits)
        if ctx.cpu:
            return convex_upsample_reference(flow, mask_logits, k)
        cm.check_kernel_args(_NAME, flow=flow)
        cm.check_kernel_args(_NAME, torch.bfloat16, mask_logits=mask_logits)
        _check_shapes(flow, mask_logits, k)
        b, h, w, _ = flow.shape
        out = torch.empty((b, h * k, w * k, 2), device=flow.device,
                          dtype=torch.float32)
        rc = library().emip_convex_upsample_bf16(
            flow.data_ptr(), mask_logits.data_ptr(), out.data_ptr(), b, h, w,
            k, cm.stream_handle(flow.device))
        cm.raise_on_error(_NAME + " (bf16)", rc)
        cm.LAUNCHES["convex_upsample_bf16"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:2]
        flow, mask_logits = ctx.saved_tensors
        if ctx.cpu:
            return (*cm.plain_vjp_fp32(convex_upsample_reference,
                                       (flow, mask_logits), needs, g, ctx.k),
                    None, None)
        g = g.contiguous()
        b, h, w, _ = flow.shape
        gflow = torch.empty_like(flow)
        gmask = torch.empty_like(mask_logits)
        gnb = torch.empty((b, h, w, 9, 2), device=flow.device,
                          dtype=torch.float32)
        rc = library().emip_convex_upsample_bwd_bf16(
            flow.data_ptr(), mask_logits.data_ptr(), g.data_ptr(),
            gflow.data_ptr(), gmask.data_ptr(), gnb.data_ptr(), b, h, w,
            ctx.k, cm.stream_handle(flow.device))
        cm.raise_on_error(_NAME + " backward (bf16)", rc)
        cm.LAUNCHES["convex_upsample_bwd_bf16"] += 1
        return (gflow if needs[0] else None, gmask if needs[1] else None,
                None, None)


def convex_upsample(flow: torch.Tensor, mask_logits: torch.Tensor,
                    k: int = 8) -> torch.Tensor:
    """Convex-combination flow upsample by ``k``.

    flow: [B, h, w, 2]; mask_logits: [B, h, w, 9*k*k] with channels ordered
    (neighbour, sub_row, sub_col). Returns [B, h*k, w*k, 2] (fp32).
    Differentiable in flow and mask_logits. bf16 mask logits take the bf16
    kernels (the logits' grad bf16).
    """
    fn = (_ConvexUpsampleBf16 if mask_logits.dtype == torch.bfloat16
          else _ConvexUpsample)
    return fn.apply(flow, mask_logits, k, cm.grad_wanted(flow, mask_logits))
