"""Kernel J: gelu_exact(dwconv3x3(u) + b) of the PVTv2 MixFFN on flat
channel-last tokens, forward and backward.

Port of :func:`emip_tpu.ops.pallas.mixffn.fused_dwconv_gelu` and
:func:`emip_tpu.ops.pallas.mixffn.dwconv_gelu_bwd_fused` (exact GELU; the
polynomial GELUs of the JAX package are not ported); the CUDA source is
``csrc/dwconv_gelu.cu``. :func:`fused_dwconv_gelu` is one
``torch.autograd.Function``: CPU tensors take the plain version (and its
autograd backward), CUDA tensors the forward and backward kernels. With
``library_forward`` the CUDA forward is the library's grouped convolution
and GELU and only the backward is the kernel, as ``dwconv_gelu_bwd_fused``
keeps XLA's forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["fused_dwconv_gelu", "fused_dwconv_gelu_reference"]

_NAME = "fused_dwconv_gelu"
# kDwMaxChunks of csrc/dwconv_gelu.cu: pixel runs of the tap-grad partials,
# 10 columns (9 taps and the bias) per channel each
_PARTIAL_FLOATS_PER_CHANNEL = 256 * 10


def fused_dwconv_gelu_reference(u, wdw, bdw, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_dwconv_gelu`."""
    b, hw, f = u.shape
    x = u.transpose(1, 2).reshape(b, f, h, w)
    y = F.conv2d(x, wdw.permute(2, 0, 1)[:, None], bdw, padding=1, groups=f)
    return F.gelu(y).flatten(2).transpose(1, 2)


def _check(u, wdw, bdw, h, w) -> None:
    cm.check_kernel_args(_NAME, u=u, wdw=wdw, bdw=bdw)
    if u.dim() != 3:
        raise ValueError(f"{_NAME}: u must be [B, H*W, F]")
    b, hw, f = u.shape
    if hw != h * w or min(b, h, w, f) < 1:
        raise ValueError(f"{_NAME}: u has {hw} tokens, expected {h} x {w}")
    cm.check_shape(_NAME, "wdw", wdw, (3, 3, f))
    cm.check_shape(_NAME, "bdw", bdw, (f,))


class _DWConvGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, wdw, bdw, h, w, keep, library_forward):
        ctx.cpu = cm.on_cpu(_NAME, u, wdw, bdw)
        ctx.hw = (h, w)
        if keep:
            ctx.save_for_backward(u, wdw, bdw)
        if ctx.cpu:
            return fused_dwconv_gelu_reference(u, wdw, bdw, h, w)
        _check(u, wdw, bdw, h, w)
        if library_forward:
            return fused_dwconv_gelu_reference(u, wdw, bdw, h,
                                               w).contiguous()
        out = torch.empty_like(u)
        rc = library().emip_dwconv_gelu(
            u.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), out.data_ptr(),
            u.shape[0], h, w, u.shape[2], cm.stream_handle(u.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["dwconv_gelu"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        u, wdw, bdw = ctx.saved_tensors
        h, w = ctx.hw
        if ctx.cpu:
            grads = cm.plain_vjp(
                lambda *a: fused_dwconv_gelu_reference(*a, h, w),
                (u, wdw, bdw), needs, g)
            return (*grads, None, None, None, None)
        g = g.contiguous()
        f = u.shape[2]
        gu, gwdw, gbdw = (cm.empty_if(nd, t)
                          for nd, t in zip(needs, (u, wdw, bdw)))
        ws = cm.workspace(u.device,
                          u.numel() + _PARTIAL_FLOATS_PER_CHANNEL * f)
        rc = library().emip_dwconv_gelu_bwd(
            u.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), g.data_ptr(),
            cm.ptr(gu), cm.ptr(gwdw), cm.ptr(gbdw), ws.data_ptr(),
            ws.numel(), u.shape[0], h, w, f, cm.stream_handle(u.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["dwconv_gelu_bwd"] += 1
        return gu, gwdw, gbdw, None, None, None, None


def fused_dwconv_gelu(u: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor,
                      h: int, w: int,
                      library_forward: bool = False) -> torch.Tensor:
    """u: [B, H*W, F] tokens of an H x W image; wdw: [3, 3, F] depthwise
    taps (cross-correlation, zero padding); bdw: [F]. Returns [B, H*W, F].

    Differentiable in u, wdw and bdw; the backward recomputes the
    pre-activation and computes only the grads that are asked for. With
    ``library_forward`` a CUDA forward runs the library's convolution and
    GELU instead of the kernel; the backward is the kernel either way.
    """
    return _DWConvGelu.apply(u, wdw, bdw, h, w, cm.grad_wanted(u, wdw, bdw),
                             bool(library_forward))
