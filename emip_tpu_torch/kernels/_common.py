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


def check_kernel_args(name: str, **tensors: torch.Tensor) -> None:
    """Every tensor the kernel reads or writes: fp32 and contiguous."""
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
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
