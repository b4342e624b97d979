"""Gaussian/Laplacian pyramid and the LapLoss training objective, on
(N, C, H, W) (port of rife_tpu/ops/pyramid.py).

The 5x5 kernel [1,4,6,4,1]^T [1,4,6,4,1] / 256 is separable: each blur is
two 5-tap passes of shifted slices under reflect padding 2, summed in the
reference's order.  Pyramid recursion: blur -> decimate by stride-2
slicing -> zero-stuff upsample -> blur with gain 4 -> difference.
LapLoss is the sum of per-level L1 means over `max_levels` levels
(default 5, the training loss).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_BINOMIAL5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _reflect_pad(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    """numpy's "reflect" padding along `axis`, which (unlike F.pad) also
    takes a pad as large as the axis: the 2x2 top of a 5-level pyramid of
    a 32x32 crop, as in the reference."""
    n = x.shape[axis]
    i = np.arange(-pad, n + pad)
    if n > 1:
        i = np.abs(i) % (2 * (n - 1))
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    else:
        i = np.zeros_like(i)
    return x.index_select(axis, torch.from_numpy(i).to(x.device))


def _conv5(x: torch.Tensor, axis: int, gain: float = 1.0) -> torch.Tensor:
    x = _reflect_pad(x, axis, 2)
    out_len = x.shape[axis] - 4
    acc = None
    for i, t in enumerate(_BINOMIAL5):
        # The tap rounded to f32 before the gain, as the reference does.
        tap = float(torch.tensor(t, dtype=torch.float32) * gain)
        term = x.narrow(axis, i, out_len) * tap
        acc = term if acc is None else acc + term
    return acc


def gauss_blur(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Separable 5x5 binomial blur; `gain` multiplies the full 2-D kernel
    (split as sqrt(gain) over the two passes)."""
    g = math.sqrt(gain)
    return _conv5(_conv5(x, 2, g), 3, g)


def _zero_stuff_up(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    up = torch.zeros(n, c, h, 2, w, 2, dtype=x.dtype, device=x.device)
    up[:, :, :, 0, :, 0] = x
    return up.reshape(n, c, 2 * h, 2 * w)


def laplacian_pyramid(img: torch.Tensor, max_levels: int = 3) -> list[torch.Tensor]:
    current = img
    pyr = []
    for _ in range(max_levels):
        down = gauss_blur(current)[:, :, ::2, ::2]
        up = gauss_blur(_zero_stuff_up(down), gain=4.0)
        pyr.append(current - up)
        current = down
    return pyr


def lap_loss(pred: torch.Tensor, target: torch.Tensor,
             max_levels: int = 5) -> torch.Tensor:
    pyr_p = laplacian_pyramid(pred, max_levels)
    pyr_t = laplacian_pyramid(target, max_levels)
    return sum((a - b).abs().mean() for a, b in zip(pyr_p, pyr_t))
