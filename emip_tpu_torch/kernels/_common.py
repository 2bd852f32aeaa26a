"""Argument checks and launch counters shared by the kernel wrappers."""

from __future__ import annotations

import torch

LAUNCHES = {
    "sr_attention": 0,
    "window_attention_block": 0,
    "flow_attention": 0,
    "convex_upsample": 0,
}


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
