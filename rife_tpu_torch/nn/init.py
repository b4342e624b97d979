"""Parameter initialisation matching torch's defaults, from an explicit
generator (port of rife_tpu/nn/init.py).

Conv2d and ConvTranspose2d weights are U(-sqrt(1/fan_in), sqrt(1/fan_in))
(kaiming_uniform with a = sqrt(5)), biases U(-1/sqrt(fan_in),
1/sqrt(fan_in)), PReLU slopes 0.25.  As torch does, fan_in is computed
from the raw weight tensor, weight.shape[1] * kh * kw: for a transposed
conv, whose weight is (in, out, kh, kw), that is out * kh * kw.  The
draws differ from the reference's jax.random ones; the distributions are
the same.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn


@torch.no_grad()
def init_torch_default_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every conv and PReLU slope of `module` in place, in
    `named_modules` order, drawing from `generator`; returns `module`."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(_uniform(w.shape, math.sqrt(1.0 / fan_in), generator))
            if m.bias is not None:
                m.bias.copy_(_uniform(m.bias.shape, 1.0 / math.sqrt(fan_in),
                                      generator))
        alpha = getattr(m, "alpha", None)
        if isinstance(alpha, nn.Parameter):
            alpha.fill_(0.25)
    return module


def _uniform(shape, bound, generator):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)
