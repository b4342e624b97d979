"""Conv and activation primitives on (N, C, H, W), and the ConvPReLU,
DeconvPReLU and SEResBlock modules.

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
    reference's NHWC `pixel_shuffle` reproduces.  A channels-last input
    gives a channels-last output (one copy, as `F.pixel_shuffle` makes);
    any other input goes to `F.pixel_shuffle`."""
    if x.is_contiguous() or not x.is_contiguous(memory_format=torch.channels_last):
        return F.pixel_shuffle(x, r)
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, c // (r * r), r, r)
    y = y.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r, c // (r * r))
    return y.permute(0, 3, 1, 2)


def conv_prelu(x, weight, bias, alpha, stride: int = 1):
    """The reference's conv() block: Conv2d + PReLU."""
    return prelu(conv2d(x, weight, bias, stride), alpha)


class ConvPReLU(nn.Module):
    """k x k Conv2d (3 x 3 unless given; padding (k - 1) // 2) + PReLU;
    parameters `conv.weight`, `conv.bias`, `alpha` (the reference tree's
    conv/w, conv/b, alpha)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, k: int = 3):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, k, stride, (k - 1) // 2)
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


class SEResBlock(nn.Module):
    """Squeeze-excite ResBlock of the legacy `hd` model (reference
    rife_tpu/models/legacy.py `_se_resblock`):

        y = conv0(x) (bias-free 3x3 shortcut; x itself at the same width
            and stride 1), h = conv2(conv1(x)) (k1 x k1 ConvPReLU, then a
            3x3 conv), w = sigmoid(fc2(prelu(fc1(mean_hw(h)), relu1)))
            (bias-free 1x1 convs, a single-slope PReLU),
        out = prelu(h * w + y, relu2).

    Parameters as the reference tree: `conv0.weight`, `conv1.*`,
    `conv2.weight`/`bias`, `relu1` (1,), `relu2` (C,), `fc1.weight`,
    `fc2.weight`."""

    def __init__(self, cin: int, cout: int, k1: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv0 = None if cin == cout and stride == 1 else \
            nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.conv1 = ConvPReLU(cin, cout, stride, k1)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.relu1 = nn.Parameter(torch.full((1,), 0.25))
        self.relu2 = nn.Parameter(torch.full((cout,), 0.25))
        self.fc1 = nn.Conv2d(cout, 16, 1, bias=False)
        self.fc2 = nn.Conv2d(16, cout, 1, bias=False)

    def forward(self, x):
        y = x if self.conv0 is None else conv2d(x, self.conv0.weight, None, self.stride)
        h = conv2d(self.conv1(x), self.conv2.weight, self.conv2.bias)
        w = prelu(conv2d(h.mean((2, 3), keepdim=True), self.fc1.weight), self.relu1)
        w = torch.sigmoid(conv2d(w, self.fc2.weight))
        return prelu(h * w + y, self.relu2)
