"""The device an entry point runs on.

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
    ``torch.cuda.is_available()`` is false."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but "
            "torch.cuda.is_available() is false; there is no fallback to "
            "the CPU (pass device='cpu' / --device cpu to run there)")
    return device


def add_device_flag(parser) -> None:
    """The ``--device`` flag every command-line entry point has beside the
    flags of the repository's root script it mirrors."""
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device (default: the GPU; raises "
                             "without one; 'cpu' runs the plain versions)")
