"""Conv and activation primitives on (N, C, H, W), and the ConvPReLU module.

Port of rife_tpu/nn/layers.py.  The convolutions go to cuDNN (or the CPU
backend) through F.conv2d / F.conv_transpose2d: they were XLA
convolutions in the reference, never Pallas kernels.  Weights use
PyTorch's layouts: conv (O, I, kh, kw), transposed conv (I, O, kh, kw);
`engine.checkpoint.state_dict_from_jax` converts the reference's.
Compute follows the input's dtype, as in the reference: weights, biases
and PReLU slopes are cast to `x.dtype` at each call (a no-op when they
already have it), so f32 master parameters train with bf16 activations.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _like(t, x):
    return None if t is None else t.to(x.dtype)


def conv2d(x, weight, bias=None, stride: int = 1):
    """torch Conv2d with padding (k - 1) // 2."""
    pad = (weight.shape[-1] - 1) // 2
    return F.conv2d(x, _like(weight, x), _like(bias, x), stride=stride, padding=pad)


def conv_transpose2d(x, weight, bias=None):
    """torch ConvTranspose2d(k=4, stride=2, padding=1): doubles H and W."""
    return F.conv_transpose2d(x, _like(weight, x), _like(bias, x), stride=2,
                              padding=1)


def prelu(x, alpha):
    """Per-channel PReLU, alpha of shape (C,)."""
    return torch.where(x >= 0, x, _like(alpha, x).view(1, -1, 1, 1) * x)


def leaky_relu(x, negative_slope: float = 0.2):
    """LeakyReLU (v4.25's activation; `nn.LeakyReLU(negative_slope)`)."""
    return F.leaky_relu(x, negative_slope)


def pixel_shuffle(x, r: int = 2):
    """(N, C*r*r, H, W) -> (N, C, H*r, W*r) in torch's channel order
    c_in = c * r^2 + dh * r + dw (`nn.PixelShuffle(r)`), which the
    reference's NHWC `pixel_shuffle` reproduces."""
    return F.pixel_shuffle(x, r)


def conv_prelu(x, weight, bias, alpha, stride: int = 1):
    """The reference's conv() block: Conv2d + PReLU."""
    return prelu(conv2d(x, weight, bias, stride), alpha)


class ConvPReLU(nn.Module):
    """3x3 Conv2d + PReLU; parameters `conv.weight`, `conv.bias`, `alpha`
    (the reference tree's conv/w, conv/b, alpha)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride, 1)
        self.alpha = nn.Parameter(torch.full((cout,), 0.25))

    def forward(self, x):
        return conv_prelu(x, self.conv.weight, self.conv.bias, self.alpha,
                          self.stride)


class DeconvPReLU(nn.Module):
    """k4 s2 p1 ConvTranspose2d + PReLU (`conv.weight`, `conv.bias`, `alpha`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 4, 2, 1)
        self.alpha = nn.Parameter(torch.full((cout,), 0.25))

    def forward(self, x):
        return prelu(conv_transpose2d(x, self.conv.weight, self.conv.bias),
                     self.alpha)
