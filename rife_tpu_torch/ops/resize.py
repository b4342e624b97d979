"""Bilinear resizes on (N, C, H, W) planes, torch-interpolate exact.

Port of rife_tpu/ops/resize.py.  The pyramid relies on the
align_corners=False convention (src = (dst + 0.5) * in/out - 0.5, clamped
below at 0); the integer-factor forms below are that convention written
as fixed 2-tap sums.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize (N, C, H, W) to out_hw, align_corners=False."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def scale_by(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Resize by a scale factor; output size = floor(in * factor)."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (int(math.floor(h * factor)),
                               int(math.floor(w * factor))))


def plane_up(p: torch.Tensor, f: int) -> torch.Tensor:
    """Integer-factor bilinear upsample: each of the f output phases on an
    axis is a fixed 2-tap lerp of the input and its shifted copy."""
    if f == 1:
        return p
    srcs = (np.arange(f) + 0.5) / f - 0.5
    i0 = np.floor(srcs).astype(int)  # -1 or 0
    lam = (srcs - i0).astype(np.float32)
    for axis in (2, 3):
        size = p.shape[axis]
        lo = torch.cat([p.narrow(axis, 0, 1), p.narrow(axis, 0, size - 1)], axis)
        hi = torch.cat([p.narrow(axis, 1, size - 1), p.narrow(axis, size - 1, 1)],
                       axis)
        phases = []
        for q in range(f):
            a, b = (lo, p) if i0[q] < 0 else (p, hi)
            wl = float(1.0 - lam[q])
            phases.append(a * wl + b * (1.0 - wl))
        st = torch.stack(phases, axis + 1)  # (..., size, f, ...)
        p = st.reshape(p.shape[:axis] + (size * f,) + p.shape[axis + 1:])
    return p


def plane_down_int(p: torch.Tensor, f: int) -> torch.Tensor:
    """Even-integer-factor bilinear downsample.  align_corners=False puts
    output i at f*i + f/2 - 0.5, so each axis is the mean of elements
    f*i + f/2 - 1 and f*i + f/2: a 2-tap, not an f x f mean (the two agree
    only for f == 2)."""
    if f == 1:
        return p
    if f % 2:
        raise ValueError(f"plane_down_int takes an even factor, got {f}")
    n, c, h, w = p.shape
    x = p.reshape(n, c, h // f, f, w)
    x = (x[:, :, :, f // 2 - 1] + x[:, :, :, f // 2]) * 0.5
    x = x.reshape(n, c, h // f, w // f, f)
    return (x[..., f // 2 - 1] + x[..., f // 2]) * 0.5


def plane_down2(p: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 mean (the x0.5 bilinear case)."""
    return F.avg_pool2d(p, 2)
