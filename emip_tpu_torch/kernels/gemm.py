"""The GEMM cores of kernels A, B, G and H, called alone.

On the model's paths the GEMM runs inside the entry points of
``csrc/sr_attention.cu`` and ``csrc/window_attention.cu``; :func:`gemm`
exposes the same device code so that ``chip_smoke.py`` and the ``cuda``
tests can hold it against ``torch.matmul`` and time it at the shapes those
kernels give it: fp32 operands take the 3xTF32 GEMM
(``csrc/gemm_tf32.cuh``), bf16 ones the bf16 GEMM of the bf16 band
(``csrc/gemm_bf16.cuh``, A's projections and B's self layer), both through
``csrc/gemm.cu``. :func:`gemm_wgmma` is the forward product of B's and
H's bf16 forwards (``csrc/gemm_wgmma.cuh``: 3xTF32 on wgmma, two terms for
a bf16 operand) with its two-source forms and epilogues, and
:func:`gemm_dy_w` the input grads of G's and H's bf16 backwards (dy W on
the transposed weight, or on the 3xTF32 GEMM with the same epilogue).
CPU tensors take the plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emip_tpu_torch.kernels import _common as cm
from emip_tpu_torch.kernels._build import library

__all__ = ["gemm", "gemm_reference", "gemm_wgmma", "gemm_wgmma_reference",
           "gemm_dy_w", "gemm_dy_w_reference"]

_NAME = "gemm"


def gemm_reference(a, b, bias=None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm`. bf16 operands: their exact
    products summed in fp32, the fp32 bias added, then one rounding to
    ``out_dtype`` (bf16 unless given)."""
    if a.dtype == torch.bfloat16:
        out = a.float() @ b.float()
        if bias is not None:
            out = out + bias.float()
        return out.to(out_dtype or torch.bfloat16)
    out = a @ b
    return out if bias is None else out + bias


def _unit_stride(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or 1 not in t.stride():
        raise ValueError(f"{_NAME}: {name} must be 2-D with one unit stride "
                         f"(row-major or a transposed view), got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _gemm_bf16(a, b, bias, split_k, out_dtype) -> torch.Tensor:
    """The bf16 GEMM: ``b`` a transposed view of a row-major weight."""
    name = _NAME + " (bf16)"
    out_dtype = out_dtype or torch.bfloat16
    if out_dtype not in (torch.bfloat16, torch.float32) or split_k:
        raise ValueError(f"{name}: writes bf16 or fp32, without split_k")
    if b.dtype != torch.bfloat16:
        raise TypeError(f"{name}: b must be bfloat16 as a is")
    if a.dim() != 2 or a.stride(1) != 1 or b.dim() != 2 or b.stride(0) != 1:
        raise ValueError(f"{name}: a must be row-major [M, K] and b [K, N] "
                         f"a transposed view of a row-major [N, K] weight")
    if bias is not None:
        cm.check_kernel_args(name, bias=bias)
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"{name}: inner dimensions {k} and {b.shape[0]}")
    if bias is not None:
        cm.check_shape(name, "bias", bias, (n,))
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    rc = library().emip_gemm_bf16(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(1), cm.ptr(bias),
        out.data_ptr(), n, m, n, k, int(out_dtype == torch.bfloat16),
        cm.stream_handle(a.device))
    cm.raise_on_error(name, rc)
    cm.LAUNCHES["gemm_bf16"] += 1
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
         split_k: bool = False,
         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a @ b (+ bias)`` -> [M, N].

    fp32 a: [M, K], b: [K, N], each row-major or a transposed view (the
    kernel reads both orientations in place); bias [N] or None; the result
    fp32. ``split_k`` splits K across blocks as a weight gradient's product
    does (no bias then). bf16 a (row-major) and b (a transposed view of a
    row-major [N, K] weight, as ``w.t()``), fp32 bias: the bf16 GEMM, fp32
    sums rounded once to ``out_dtype`` (bf16 unless given; fp32 too). Not
    differentiable: a check of the kernels' GEMMs, not a layer.
    """
    tensors = [a, b] + ([] if bias is None else [bias])
    if cm.on_cpu(_NAME, *tensors):
        return gemm_reference(a, b, bias, out_dtype)
    if a.dtype == torch.bfloat16:
        return _gemm_bf16(a, b, bias, split_k, out_dtype)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{_NAME}: {name} must be float32")
        _unit_stride(name, t)
    if bias is not None:
        cm.check_kernel_args(_NAME, bias=bias)
        if split_k:
            raise ValueError(f"{_NAME}: split_k takes no bias")
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"{_NAME}: inner dimensions {k} and {b.shape[0]}")
    if bias is not None:
        cm.check_shape(_NAME, "bias", bias, (n,))
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    ws = cm.workspace(a.device, 0)
    rc = library().emip_gemm(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), cm.ptr(bias), out.data_ptr(), n, m, n, k, int(split_k),
        ws.data_ptr(), ws.numel(), cm.stream_handle(a.device))
    cm.raise_on_error(_NAME, rc)
    cm.LAUNCHES["gemm"] += 1
    return out


_WG = "gemm_wgmma"
_WG_EPILOGUES = {None: 0, "gelu": 1, "layernorm": 2}


def gemm_wgmma_reference(a, w, a2=None, n_switch=None, epilogue=None,
                         gamma=None, beta=None, eps=1e-6) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm_wgmma`, in ``w``'s dtype."""
    a = a.to(w.dtype)
    if a2 is None:
        y = a @ w.T
    elif n_switch is None:
        k0 = a.shape[1]
        y = a @ w[:, :k0].T + a2.to(w.dtype) @ w[:, k0:].T
    else:
        y = torch.cat([a @ w[:n_switch].T, a2.to(w.dtype) @ w[n_switch:].T],
                      -1)
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "layernorm":
        return F.layer_norm(y, (y.shape[-1],), gamma, beta, eps)
    return y


def gemm_wgmma(a: torch.Tensor, w: torch.Tensor,
               a2: torch.Tensor | None = None, n_switch: int | None = None,
               epilogue: str | None = None, gamma: torch.Tensor | None = None,
               beta: torch.Tensor | None = None,
               eps: float = 1e-6) -> torch.Tensor:
    """``epilogue(a w^T)`` [M, N] fp32 on the wgmma product of kernels B's
    and H's bf16 forwards, for an fp32 ``nn.Linear`` weight ``w`` [N, K].

    The forms those kernels run: fp32 ``a`` [M, K] with no epilogue or with
    ``"layernorm"`` over the row (``gamma``, ``beta`` [N], N 64 or 128: Wm's
    and W2's); bf16 ``a`` [M, k0] and fp32 ``a2`` [M, K - k0] summed along
    K with ``"gelu"`` (W0's two halves); bf16 ``a`` and ``a2`` [M, K] with
    columns at or past ``n_switch`` from ``a2`` (q from x, k and v from t).
    Rows row-major, 16-byte aligned. Not differentiable: a check of the
    kernels' product, not a layer.
    """
    tensors = [a, w] + [x for x in (a2, gamma, beta) if x is not None]
    if cm.on_cpu(_WG, *tensors):
        return gemm_wgmma_reference(a, w, a2, n_switch, epilogue, gamma,
                                    beta, eps)
    if epilogue not in _WG_EPILOGUES:
        raise ValueError(f"{_WG}: epilogue {epilogue!r} not in "
                         f"{tuple(_WG_EPILOGUES)}")
    cm.check_kernel_args(_WG, w=w, **({} if gamma is None else
                                       dict(gamma=gamma, beta=beta)))
    for name, t in (("a", a), ("a2", a2)):
        if t is not None and (t.dim() != 2 or t.stride(1) != 1):
            raise ValueError(f"{_WG}: {name} must be row-major [M, K]")
    m, n = a.shape[0], w.shape[0]
    k0 = a.shape[1]
    k1 = 0 if a2 is None or n_switch is not None else a2.shape[1]
    bits = int(a.dtype == torch.bfloat16) + 2 * int(
        a2 is not None and a2.dtype == torch.bfloat16)
    if w.shape[1] != k0 + k1 or (a2 is not None and a2.shape[0] != m):
        raise ValueError(f"{_WG}: w {tuple(w.shape)} does not take a "
                         f"{tuple(a.shape)}"
                         + ("" if a2 is None else f" and {tuple(a2.shape)}"))
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    wsplit = torch.empty(2 * w.numel(), device=a.device, dtype=torch.float32)
    rc = library().emip_gemm_wgmma(
        a.data_ptr(), a.stride(0), k0, cm.ptr(a2),
        0 if a2 is None else a2.stride(0), k1,
        n if n_switch is None else n_switch, bits, w.data_ptr(),
        wsplit.data_ptr(), m, n, _WG_EPILOGUES[epilogue], cm.ptr(gamma),
        cm.ptr(beta), out.data_ptr(), n, eps, cm.stream_handle(a.device))
    cm.raise_on_error(_WG, rc)
    cm.LAUNCHES[_WG] += 1
    return out



_DYW = "gemm_dy_w"


def gemm_dy_w_reference(dy, w, epilogue=None, aux=None, add=None,
                        out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`gemm_dy_w`, in ``w``'s dtype
    (``out_dtype`` where given)."""
    y = dy.to(w.dtype) @ w
    if epilogue == "gelu_grad":
        a = aux.to(w.dtype)
        y = y * (0.5 * (1.0 + torch.erf(a * 0.7071067811865476))
                 + a * torch.exp(-0.5 * a * a) * 0.3989422804014327)
    if add is not None:
        y = add.to(w.dtype) + y
    return y if out_dtype is None else y.to(out_dtype)


def gemm_dy_w(dy: torch.Tensor, w: torch.Tensor, epilogue: str | None = None,
              aux: torch.Tensor | None = None,
              add: torch.Tensor | None = None,
              out_dtype: torch.dtype = torch.float32,
              wgmma: bool = True) -> torch.Tensor:
    """The input grad ``dy w`` [M, N] of G's and H's bf16 backwards for an
    fp32 ``nn.Linear`` weight ``w`` [K, N]: on the wgmma product
    (``wgmma``: ``w`` split transposed once, the K-major ``dy (w^T)^T``),
    or on the 3xTF32 GEMM of ``gemm_tf32.cuh`` with the same epilogue, so
    that the two can be compared at one shape.

    fp32 ``dy`` [M, K] row-major; ``epilogue`` None or ``"gelu_grad"``
    (times the GELU derivative at ``aux`` [M, N] fp32: H's gh); ``add``
    [M, N] (fp32 or bf16) added last and the result fp32 or rounded once to
    bf16 (``out_dtype``: G's gx, gt). Not differentiable: a check of the
    kernels' products, not a layer.
    """
    tensors = [dy, w] + [x for x in (aux, add) if x is not None]
    if cm.on_cpu(_DYW, *tensors):
        return gemm_dy_w_reference(dy, w, epilogue, aux, add, out_dtype)
    if epilogue not in (None, "gelu_grad") or (
            epilogue == "gelu_grad") == (aux is None):
        raise ValueError(f"{_DYW}: epilogue None, or 'gelu_grad' with aux")
    if epilogue and (add is not None or out_dtype != torch.float32):
        raise ValueError(f"{_DYW}: 'gelu_grad' takes no add, fp32 out")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{_DYW}: writes fp32 or bf16")
    cm.check_kernel_args(_DYW, dy=dy, w=w)
    (m, k), n = dy.shape, w.shape[1]
    if dy.dim() != 2 or dy.stride(1) != 1 or w.shape[0] != k:
        raise ValueError(f"{_DYW}: dy {tuple(dy.shape)} does not take w "
                         f"{tuple(w.shape)}")
    for name, x in (("aux", aux), ("add", add)):
        if x is not None:
            cm.check_shape(_DYW, name, x, (m, n))
            if not x.is_contiguous():
                raise ValueError(f"{_DYW}: {name} must be contiguous")
    if aux is not None and aux.dtype != torch.float32:
        raise TypeError(f"{_DYW}: aux must be float32")
    out = torch.empty((m, n), device=dy.device, dtype=out_dtype)
    wsplit = (torch.empty(2 * w.numel(), device=dy.device,
                          dtype=torch.float32) if wgmma else None)
    rc = library().emip_gemm_dyw(
        dy.data_ptr(), dy.stride(0), k, w.data_ptr(), cm.ptr(wsplit), m, n,
        6 if epilogue else 7, cm.ptr(aux), cm.ptr(add),
        int(add is not None and add.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), out.data_ptr(), n, int(wgmma),
        cm.stream_handle(dy.device))
    cm.raise_on_error(_DYW, rc)
    cm.LAUNCHES[_DYW] += 1
    return out
