"""Argument checks, launch counters and the CPU backward shared by the
kernel wrappers."""

from __future__ import annotations

import torch

# kernel launches, one per call of a wrapper's CUDA path (forward, or the
# backward of an autograd Function); the CPU path counts nothing
LAUNCHES = {
    "sr_attention": 0,
    "sr_attention_bwd": 0,
    "window_attention_block": 0,
    "window_attention_block_bwd": 0,
    "window_attention_layer": 0,
    "window_attention_layer_bwd": 0,
    "window_attention_ffn_layer": 0,
    "window_attention_ffn_layer_bwd": 0,
    "flow_attention": 0,
    "flow_attention_bwd": 0,
    "convex_upsample": 0,
    "convex_upsample_bwd": 0,
    "splat_density": 0,
    "memory_attention": 0,
    "memory_attention_bwd": 0,
    "softmax_expectation": 0,
    "softmax_expectation_bwd": 0,
    "dwconv_gelu": 0,
    "dwconv_gelu_bwd": 0,
    # the GEMM core and the forward attention of A, B, G and H called alone
    # (kernels/gemm.py, kernels/attention.py: checks)
    "gemm": 0,
    "attention": 0,
    # the wgmma product of B's and H's bf16 forwards alone, and the input
    # grads of G's and H's bf16 backwards alone (kernels/gemm.py)
    "gemm_wgmma": 0,
    "gemm_dy_w": 0,
    # the bf16 attention of B, C and G alone (kernels/attention.py)
    "attention_bf16": 0,
    # the bf16 band of short inference: the bf16 forwards of A-D and the
    # bf16 GEMM alone
    "sr_attention_bf16": 0,
    "window_attention_block_bf16": 0,
    "flow_attention_bf16": 0,
    "convex_upsample_bf16": 0,
    "gemm_bf16": 0,
    # the bf16 train step: the bf16 backwards of A-D
    "sr_attention_bwd_bf16": 0,
    "window_attention_block_bwd_bf16": 0,
    "flow_attention_bwd_bf16": 0,
    "convex_upsample_bwd_bf16": 0,
    # the bf16 long model and 512^2: F forward and backward, G and H
    # forward
    "memory_attention_bf16": 0,
    "memory_attention_bwd_bf16": 0,
    "window_attention_layer_bf16": 0,
    "window_attention_ffn_layer_bf16": 0,
    # the rest of the bf16 band: G and H backward (the train step at
    # 512^2), J forward and backward (the fused MixFFN switches)
    "window_attention_layer_bwd_bf16": 0,
    "window_attention_ffn_layer_bwd_bf16": 0,
    "dwconv_gelu_bf16": 0,
    "dwconv_gelu_bwd_bf16": 0,
}

# floats of split-K / column-sum / attention-partial workspace a backward
# kernel may use beyond what it states itself (16 MiB; the kernels choose
# fewer splits when it is short)
WORKSPACE_FLOATS = 1 << 22


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs).

    False when every tensor lies on one CUDA device (the kernel runs).
    Anything else raises: there is no fallback between the two.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                         f"one CUDA device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    return False


def check_kernel_args(name: str, dtype: torch.dtype = torch.float32,
                      **tensors: torch.Tensor) -> None:
    """Every tensor the kernel reads or writes: ``dtype`` and contiguous.

    A bf16 tensor where the kernel has only its fp32 instantiation (E, I)
    is named as such.
    """
    for arg, t in tensors.items():
        if t.dtype != dtype:
            if t.dtype == torch.bfloat16:
                raise TypeError(f"{name}: {arg} is bfloat16, and {name} has "
                                f"no bfloat16 instantiation (only its "
                                f"{dtype} one)")
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_shape(name: str, arg: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def ptr(t: torch.Tensor | None) -> int:
    """Device pointer of ``t``, or 0 (NULL: not wanted) for None."""
    return 0 if t is None else t.data_ptr()


def numel(t: torch.Tensor | None) -> int:
    """Elements of ``t``, or 0 for None."""
    return 0 if t is None else t.numel()


def grad_wanted(*tensors) -> bool:
    """Whether a forward must keep what its backward reads."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def empty_if(wanted: bool, like: torch.Tensor) -> torch.Tensor | None:
    return torch.empty_like(like) if wanted else None


def workspace(device: torch.device, floats: int) -> torch.Tensor:
    """fp32 scratch of ``floats`` plus :data:`WORKSPACE_FLOATS`."""
    return torch.empty(floats + WORKSPACE_FLOATS, device=device,
                       dtype=torch.float32)


def plain_vjp(fn, inputs, needs, grad_out, *args) -> list:
    """Grads of ``fn(*inputs, *args)`` through the plain PyTorch version.

    The CPU backward of every kernel Function: the plain forward is rerun
    under autograd and differentiated for the inputs whose ``needs`` flag
    is set; the others get None.
    """
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(bool(n)) for x, n in
                  zip(inputs, needs)]
        out = fn(*leaves, *args)
        want = [x for x, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(out, want, grad_out,
                                       allow_unused=True) if want else ())
    grads = []
    for x, n in zip(leaves, needs):
        g = next(got) if n else None
        grads.append(torch.zeros_like(x) if n and g is None else g)
    return grads


def plain_vjp_fp32(fn, inputs, needs, grad_out, *args) -> list:
    """The CPU backward of a bf16 kernel Function, as the JAX kernels'
    backward computes it: the grads of the fp32 plain version ``fn`` at the
    inputs upcast to fp32 (each JAX backward kernel upcasts its bf16
    operands and recomputes its forward in fp32, so its grads are not those
    of the bf16 forward's rounded intermediates), each rounded once to its
    input's dtype."""
    up = [x.float() if x.dtype == torch.bfloat16 else x for x in inputs]
    grads = plain_vjp(fn, up, needs, grad_out.float(), *args)
    return [g if g is None else g.to(x.dtype) for g, x in zip(grads, inputs)]
