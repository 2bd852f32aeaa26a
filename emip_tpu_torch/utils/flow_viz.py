"""Optical-flow colour-wheel rendering (Middlebury convention, numpy).

Counterpart of :mod:`emip_tpu.utils.flow_viz` (Baker et al.'s flow-to-colour
rendering, which the reference's ``test_of.py`` uses). Flow is [H, W, 2]
with (u, v) = (x, y) displacement.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_colorwheel", "flow_to_image"]


def make_colorwheel() -> np.ndarray:
    """[55, 3] RGB wheel in 0..255 (floats): the RY / YG / GC / CB / BM /
    MR segments."""
    segments = (
        (15, (255, 0, 0), (255, 255, 0)),   # red -> yellow
        (6, (255, 255, 0), (0, 255, 0)),    # yellow -> green
        (4, (0, 255, 0), (0, 255, 255)),    # green -> cyan
        (11, (0, 255, 255), (0, 0, 255)),   # cyan -> blue
        (13, (0, 0, 255), (255, 0, 255)),   # blue -> magenta
        (6, (255, 0, 255), (255, 0, 0)),    # magenta -> red
    )
    rows = []
    for length, start, end in segments:
        t = np.arange(length)[:, None] / length
        rows.append(np.asarray(start) * (1 - t) + np.asarray(end) * t)
    return np.floor(np.concatenate(rows, axis=0))


def flow_to_image(flow: np.ndarray, clip: float | None = None) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 colour image; the magnitude is
    normalised by its maximum (after clipping each component to +-clip)."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    if clip is not None:
        u = np.clip(u, -clip, clip)
        v = np.clip(v, -clip, clip)
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u, v, rad = u / rad_max, v / rad_max, rad / rad_max

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.empty(u.shape + (3,), np.uint8)
    for c in range(3):
        col = (1 - f) * (wheel[k0, c] / 255.0) + f * (wheel[k1, c] / 255.0)
        # towards white inside the unit circle, darker outside it
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255.0 * col)
    return img
