"""The device an entry point runs on, and the precision it runs in there.

Every entry point of the port takes a ``device`` whose default is the
card. It never falls back: asked for ``cuda`` (the default) on a machine
without a GPU it raises, and the CPU is used only when the caller asks
for it, as the CPU tests do.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "add_device_flag"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a GPU and
    ``torch.cuda.is_available()`` is false.

    For a GPU it also turns TF32 off for cuDNN's convolutions and for
    matmuls, process-wide, before it returns. The port's fp32 band
    computes in fp32 (its kernels run their products as 3xTF32, within
    1e-5 of fp64); torch's default lets cuDNN run every convolution in TF32
    (``torch.backends.cudnn.allow_tf32`` is True), which would take the
    patch embeds, the flow encoder, the injectors, ``conv_corr`` and the
    decoder off that band. It turns off cuBLAS's reduced-precision
    reduction of bf16 products too
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
    True by torch's default): the bf16 band's library matmuls (the PVT
    MixFFN's linears) then sum in fp32, as XLA does. Every entry point
    that runs a model on the card comes through here first. Only the
    legacy ``allow_tf32`` switches are set: torch refuses to read them
    back once they are mixed with the newer ``fp32_precision`` ones.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for but "
                "torch.cuda.is_available() is false; there is no fallback "
                "to the CPU (pass device='cpu' / --device cpu to run there)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    return device


def add_device_flag(parser) -> None:
    """The ``--device`` flag every command-line entry point that runs a
    model has beside the flags of the repository's root script it
    mirrors."""
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device (default: the GPU; raises "
                             "without one; 'cpu' runs the plain versions)")
