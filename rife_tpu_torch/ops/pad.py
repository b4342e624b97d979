"""Padding of NHWC frames to the pyramid's granularity, with the crop back.

Port of rife_tpu/ops/pad.py.  Like the engine's API, these work on NHWC
(or HWC) frames: right/bottom zero padding to a multiple (`pad_to_multiple`,
the CLI contract) or centered padding to max(min_size, multiple)
(`pad_centered`, the app contract).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Padding:
    top: int
    bottom: int
    left: int
    right: int
    orig_h: int
    orig_w: int

    @property
    def padded_h(self) -> int:
        return self.orig_h + self.top + self.bottom

    @property
    def padded_w(self) -> int:
        return self.orig_w + self.left + self.right

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        """Crop an NHWC (or HWC) tensor back to the original frame."""
        h_axis = x.dim() - 3
        return (x.narrow(h_axis, self.top, self.orig_h)
                 .narrow(h_axis + 1, self.left, self.orig_w))


def _ceil_to(v: int, mult: int) -> int:
    return ((v - 1) // mult + 1) * mult


def plan_pad_to_multiple(h: int, w: int, mult: int = 32) -> Padding:
    return Padding(0, _ceil_to(h, mult) - h, 0, _ceil_to(w, mult) - w, h, w)


def plan_pad_centered(h: int, w: int, mult: int = 32,
                      min_size: int = 512) -> Padding:
    th = max(min_size, _ceil_to(h, mult))
    tw = max(min_size, _ceil_to(w, mult))
    ph, pw = th - h, tw - w
    return Padding(ph // 2, ph - ph // 2, pw // 2, pw - pw // 2, h, w)


def _apply(x: torch.Tensor, p: Padding) -> torch.Tensor:
    # F.pad lists pads from the last axis backwards: C, then W, then H.
    return F.pad(x, (0, 0, p.left, p.right, p.top, p.bottom))


def pad_to_multiple(x: torch.Tensor, mult: int = 32
                    ) -> tuple[torch.Tensor, Padding]:
    h_axis = x.dim() - 3
    p = plan_pad_to_multiple(x.shape[h_axis], x.shape[h_axis + 1], mult)
    return _apply(x, p), p


def pad_centered(x: torch.Tensor, mult: int = 32, min_size: int = 512
                 ) -> tuple[torch.Tensor, Padding]:
    h_axis = x.dim() - 3
    p = plan_pad_centered(x.shape[h_axis], x.shape[h_axis + 1], mult, min_size)
    return _apply(x, p), p
