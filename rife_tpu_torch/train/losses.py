"""Auxiliary training losses on (N, C, H, W) planes (port of
rife_tpu/train/losses.py; reference model/loss.py).

LapLoss, the paper objective, is `ops.pyramid.lap_loss`.  Here: the masked
endpoint error (`epe_loss`), the ternary census loss (`ternary_loss`,
the legacy objective's photometric term) and the Sobel gradient loss
(`sobel_loss`, v4.25's flow smoothness).  Plain PyTorch with the
reference's constants, the convolutions written as sums of shifted
slices of a zero-padded input, as the reference writes them; no kernel
(XLA fuses the reference's elementwise chain, and so does nothing here).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_LUMA = (0.2989, 0.587, 0.114)
_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = tuple(zip(*_SOBEL_X))


def epe_loss(flow: torch.Tensor, gt: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    """Masked endpoint error: flow and gt (N, 2, H, W), loss_mask
    (N, 1, H, W) -> (N, 1, H, W)."""
    err = torch.sqrt(((flow - gt) ** 2).sum(1, keepdim=True) + 1e-6)
    return err * loss_mask


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma of [0, 1] RGB planes, scaled to [0, 255] as the
    reference's census transform expects -> (N, 1, H, W)."""
    r, g, b = img[:, 0:1], img[:, 1:2], img[:, 2:3]
    return (_LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b) * 255.0


def _census_transform(gray: torch.Tensor, patch: int = 7) -> torch.Tensor:
    """The patch x patch neighbourhood differences of (N, 1, H, W), soft
    normalised -> (N, patch^2, H, W), neighbours in row-major order."""
    pad = patch // 2
    h, w = gray.shape[-2:]
    padded = F.pad(gray, (pad, pad, pad, pad))
    patches = torch.cat([padded[:, :, dy:dy + h, dx:dx + w]
                         for dy in range(patch) for dx in range(patch)], 1)
    diff = patches - gray
    return diff / torch.sqrt(0.81 + diff ** 2)


def _valid_mask(like: torch.Tensor, pad: int) -> torch.Tensor:
    n, _, h, w = like.shape
    inner = torch.ones(n, 1, h - 2 * pad, w - 2 * pad, dtype=like.dtype,
                       device=like.device)
    return F.pad(inner, (pad, pad, pad, pad))


def ternary_loss(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Census / ternary photometric distance of two (N, 3, H, W) images in
    [0, 1] -> a scalar: the mean over pixels of the summed soft Hamming
    distance, the 1-pixel border masked out."""
    t0 = _census_transform(_rgb_to_gray(img0))
    t1 = _census_transform(_rgb_to_gray(img1))
    dist = (t0 - t1) ** 2
    dist_sum = (dist / (0.1 + dist)).sum(1, keepdim=True)
    return (dist_sum * _valid_mask(img0, 1)).mean()


def _sobel_filter(x: torch.Tensor, k) -> torch.Tensor:
    """Cross-correlation of each plane of `x` with the 3x3 `k`, zero padded."""
    h, w = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1))
    acc = 0.0
    for dy in range(3):
        for dx in range(3):
            if k[dy][dx] != 0:
                acc = acc + k[dy][dx] * padded[:, :, dy:dy + h, dx:dx + w]
    return acc


def sobel_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean L1 between the Sobel gradients of each plane of pred and gt
    (N, C, H, W) -> a scalar; v4.25's update takes it of its last flow
    against zero (reference train_log/RIFE_HDv3.py:74)."""
    gx = (_sobel_filter(pred, _SOBEL_X) - _sobel_filter(gt, _SOBEL_X)).abs()
    gy = (_sobel_filter(pred, _SOBEL_Y) - _sobel_filter(gt, _SOBEL_Y)).abs()
    return (gx + gy).mean()
