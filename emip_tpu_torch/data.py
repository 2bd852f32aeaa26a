"""Frame-pair listing and image loading for inference (no jax).

Same directory rules as :mod:`emip_tpu.data.manifest` (which cannot be
imported without jax, because its package imports the JAX pipeline):

  <root>/<video>/<frames_subdir>/*.{jpg,png}   (sorted)

pair i is (frame_i, frame_{i+1}) and is named after frame_i; the frames
subdir is 'Imgs' for MoCA, 'frames' for CAD, 'Frame' for pseudo-labeled
MoCA. Preprocessing matches the JAX loader: PIL bilinear resize to the
square input size, [0, 1] scaling, ImageNet normalization.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from emip_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["PairItem", "frames_subdir", "scan_pairs", "load_frame"]

_IMG_EXT = (".jpg", ".png")


@dataclasses.dataclass(frozen=True)
class PairItem:
    image1: str
    image2: str
    video: str
    frame_name: str


def frames_subdir(dataset_type: str) -> str:
    if "CAD" in dataset_type:
        return "frames"
    if "pseudo" in dataset_type:
        return "Frame"
    return "Imgs"


def scan_pairs(images_root: str, dataset_type: str = "MoCA") -> list[PairItem]:
    """Consecutive-frame pairs over all videos under ``images_root``."""
    sub = frames_subdir(dataset_type)
    items = []
    for video in sorted(os.listdir(images_root)):
        fdir = os.path.join(images_root, video, sub)
        if not os.path.isdir(fdir):
            continue
        frames = sorted(os.path.join(fdir, f) for f in os.listdir(fdir)
                        if f.lower().endswith(_IMG_EXT))
        for a, b in zip(frames, frames[1:]):
            items.append(PairItem(a, b, video,
                                  os.path.splitext(os.path.basename(a))[0]))
    return items


def load_frame(path: str, size: int) -> tuple[np.ndarray, tuple[int, int]]:
    """-> (normalized [size, size, 3] float32 frame, original (h, w))."""
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
    orig_hw = (img.height, img.width)
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (arr - mean) / std, orig_hw
