"""Benchmark metric protocols (numpy only): the port's own copy of
rife_tpu/metrics/quality.py, which it may not import.

- Vimeo90K/UCF101 PSNR is computed on uint8-rounded output
  (benchmark/Vimeo90K.py:35-37) and SSIM on round(x*255)/255.
- MiddleBury reports IE = mean |pred - gt| on the 0-255 scale
  (benchmark/MiddleBury_Other.py:34-36).
- HD reports PSNR on the Y channel after RGB->YUV
  (benchmark/HD.py:80-83), with the skimage-compatible YCbCr matrix.
"""
from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((pred.astype(np.float64) - gt.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def psnr_uint8_protocol(pred01: np.ndarray, gt_u8: np.ndarray) -> float:
    """Round prediction to uint8 first (benchmark/Vimeo90K.py:35-37)."""
    pred_u8 = np.round(np.clip(pred01, 0, 1) * 255.0)
    return psnr(pred_u8, gt_u8.astype(np.float64), data_range=255.0)


def interpolation_error(pred01: np.ndarray, gt_u8: np.ndarray) -> float:
    """MiddleBury IE: mean abs error on 0-255 scale."""
    pred255 = np.round(np.clip(pred01, 0, 1) * 255.0)
    return float(np.mean(np.abs(pred255 - gt_u8.astype(np.float64))))


# skimage.color.rgb2yuv coefficients (benchmark/HD.py uses rgb2yuv).
_YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14714119, -0.28886916, 0.43601035],
     [0.61497538, -0.51496512, -0.10001026]], dtype=np.float64
)


def rgb_to_y(img01: np.ndarray) -> np.ndarray:
    """Luma plane in [0,1] from RGB in [0,1]."""
    return img01 @ _YUV[0]
