"""Kernel I: softmax(corr, -1) @ values over a stored correlation volume,
forward and backward.

Port of :func:`emip_tpu.ops.pallas.corr_softmax.softmax_expectation`; the
CUDA source is ``csrc/softmax_expectation.cu``. :func:`softmax_expectation`
is one ``torch.autograd.Function``: CPU tensors take the plain version (and
its autograd backward), CUDA tensors the forward and backward kernels. The
kernels read rows: a caller that wants the expectation along corr's other
axis passes a contiguous transpose.
"""

from __future__ import annotations

import torch

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["softmax_expectation", "softmax_expectation_reference"]

_NAME = "softmax_expectation"
_VALUE_WIDTH = 2
# kSeBwdBlocks of csrc/softmax_expectation.cu: blocks of the backward, each
# with its own [N, 2] partial of dvalues
_PARTIAL_BLOCKS = 4 * 132


def softmax_expectation_reference(corr, values) -> torch.Tensor:
    """Plain PyTorch version of :func:`softmax_expectation`."""
    return torch.softmax(corr, dim=-1) @ values


def _check(corr, values) -> None:
    cm.check_kernel_args(_NAME, corr=corr, values=values)
    if corr.dim() != 3:
        raise ValueError(f"{_NAME}: corr must be [B, M, N]")
    if corr.shape[-1] == 0:
        raise ValueError(f"{_NAME}: empty softmax axis")
    cm.check_shape(_NAME, "values", values, (corr.shape[-1], _VALUE_WIDTH))


class _SoftmaxExpectation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr, values, keep):
        ctx.cpu = cm.on_cpu(_NAME, corr, values)
        if keep:
            ctx.save_for_backward(corr, values)
        if ctx.cpu:
            return softmax_expectation_reference(corr, values)
        _check(corr, values)
        b, m, n = corr.shape
        out = torch.empty((b, m, _VALUE_WIDTH), device=corr.device,
                          dtype=corr.dtype)
        rc = library().emip_softmax_expectation(
            corr.data_ptr(), values.data_ptr(), out.data_ptr(), b * m, n,
            cm.stream_handle(corr.device))
        cm.raise_on_error(_NAME, rc)
        cm.LAUNCHES["softmax_expectation"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:2]
        corr, values = ctx.saved_tensors
        if ctx.cpu:
            return (*cm.plain_vjp(softmax_expectation_reference,
                                  (corr, values), needs, g), None)
        g = g.contiguous()
        b, m, n = corr.shape
        dcorr, dvalues = (cm.empty_if(nd, t)
                          for nd, t in zip(needs, (corr, values)))
        ws = cm.workspace(corr.device,
                          _PARTIAL_BLOCKS * n * 2 if needs[1] else 0)
        rc = library().emip_softmax_expectation_bwd(
            corr.data_ptr(), values.data_ptr(), g.data_ptr(), cm.ptr(dcorr),
            cm.ptr(dvalues), ws.data_ptr(), ws.numel(), b * m, n,
            cm.stream_handle(corr.device))
        cm.raise_on_error(_NAME + " backward", rc)
        cm.LAUNCHES["softmax_expectation_bwd"] += 1
        return dcorr, dvalues, None


def softmax_expectation(corr: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """corr: [B, M, N]; values: [N, 2]. Returns [B, M, 2] (fp32).

    Differentiable in corr and values; the backward recomputes the
    probabilities and computes only the grads that are asked for.
    """
    return _SoftmaxExpectation.apply(corr, values,
                                     cm.grad_wanted(corr, values))
