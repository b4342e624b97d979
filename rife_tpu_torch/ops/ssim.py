"""The SSIM family on NHWC tensors (port of rife_tpu/ops/ssim.py).

`ssim_matlab` treats an RGB image as a depth-3 volume blurred by an 11^3
Gaussian window under replicate padding (reference
pytorch_msssim/__init__.py:81-134); every benchmark reports it, and the
video pipeline's scene-change and static-frame gates compare it against
0.996 / 0.2 on 32x32 probes.  The 2-D and 3-D windows are outer products
of one 1-D Gaussian (sigma 1.5), so each blur is an 11-tap sum of
shifted slices per axis after an edge pad of 5, in the reference's tap
order.  Sums are taken in f32 (f64 for f64 inputs) and no `F.conv*` is
used: on the card a convolution would take TF32.

Quirk kept: the pad stays 5 a side even where the window shrinks for a
small input (real = min(11, H, W)), as the reference does.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _gaussian_1d(window_size: int, sigma: float = 1.5) -> np.ndarray:
    g = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2)) for x in range(window_size)],
        dtype=np.float64,
    )
    return (g / g.sum()).astype(np.float32)


def _edge_pad(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.arange(-pad, n + pad, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def _conv1d_valid(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Valid 1-D convolution along `axis` as a sum of shifted slices."""
    out_len = x.shape[axis] - len(taps) + 1
    acc = None
    for i, t in enumerate(taps):
        term = x.narrow(axis, i, out_len) * float(t)
        acc = term if acc is None else acc + term
    return acc


def _blur(x: torch.Tensor, axes: tuple[int, ...], window_size: int,
          pad: int = 5) -> torch.Tensor:
    taps = _gaussian_1d(window_size)
    for ax in axes:
        x = _conv1d_valid(_edge_pad(x, ax, pad), taps, ax)
    return x


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def _val_range(img1: torch.Tensor, val_range) -> torch.Tensor:
    if val_range is not None:
        return torch.tensor(float(val_range), dtype=img1.dtype, device=img1.device)
    one = torch.ones((), dtype=img1.dtype, device=img1.device)
    max_val = torch.where(img1.max() > 128, 255.0 * one, one)
    min_val = torch.where(img1.min() < -0.5, -one, 0.0 * one)
    return max_val - min_val


def _ssim_core(img1, img2, blur, L):
    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(img1 * img1) - mu1_sq
    sigma2_sq = blur(img2 * img2) - mu2_sq
    sigma12 = blur(img1 * img2) - mu1_mu2
    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    cs = torch.mean(v1 / v2)
    ssim_map = ((2 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return ssim_map, cs


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         val_range=None, full: bool = False):
    """Per-channel 2-D SSIM on NHWC images (reference ssim,
    pytorch_msssim/__init__.py:27-78) -> a 0-d tensor (and cs with
    full=True)."""
    img1, img2 = _acc(img1), _acc(img2)
    _, h, w, _ = img1.shape
    real = min(window_size, h, w)
    L = _val_range(img1, val_range)
    ssim_map, cs = _ssim_core(img1, img2, lambda x: _blur(x, (1, 2), real), L)
    ret = torch.mean(ssim_map)
    return (ret, cs) if full else ret


def ssim_matlab_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
                    val_range=None):
    """`ssim_matlab`'s map over (N, depth, H, W), and its cs."""
    img1, img2 = _acc(img1), _acc(img2)
    _, h, w, _ = img1.shape
    real = min(window_size, h, w)
    L = _val_range(img1, val_range)
    v1, v2 = img1.movedim(-1, 1), img2.movedim(-1, 1)
    return _ssim_core(v1, v2, lambda x: _blur(x, (1, 2, 3), real), L)


def ssim_matlab(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
                val_range=None, full: bool = False):
    """Volumetric ("MATLAB") SSIM on NHWC images: the channels become a
    depth axis and the separable blur runs over (depth, H, W)."""
    ssim_map, cs = ssim_matlab_map(img1, img2, window_size, val_range)
    ret = torch.mean(ssim_map)
    return (ret, cs) if full else ret


_MSSSIM_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], dtype=np.float32)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of NHWC, odd edges dropped; the four summed in
    row-major order, as the reference's mean over (2, 4) sums them (the
    5th level's SSIM on a 6x8 image moves by 3e-6 with a 1-ulp change of
    its pooled input)."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c)
    s = x[:, :, 0, :, 0] + x[:, :, 0, :, 1] + x[:, :, 1, :, 0] + x[:, :, 1, :, 1]
    return s / 4


def msssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
           val_range=None, normalize: bool = False) -> torch.Tensor:
    """Multi-scale SSIM, 5 levels of 2x average pooling (reference
    pytorch_msssim/__init__.py:137-163)."""
    img1, img2 = _acc(img1), _acc(img2)
    mssim, mcs = [], []
    for _ in range(len(_MSSSIM_WEIGHTS)):
        s, cs = ssim(img1, img2, window_size=window_size, val_range=val_range, full=True)
        mssim.append(s)
        mcs.append(cs)
        img1, img2 = _pool2(img1), _pool2(img2)
    mssim = torch.stack(mssim)
    mcs = torch.stack(mcs)
    if normalize:
        mssim = (mssim + 1) / 2
        mcs = (mcs + 1) / 2
    weights = torch.as_tensor(_MSSSIM_WEIGHTS, device=mssim.device).to(mssim.dtype)
    pow1 = mcs**weights
    pow2 = mssim**weights
    return torch.prod(pow1[:-1] * pow2[-1])
