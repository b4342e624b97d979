"""Host-side scene-gate probe (port of rife_tpu/video/probe.py).

The reference gates every frame pair on ssim_matlab over 32x32 bilinear
downsamples of the padded model inputs (inference_video.py:226-228).  On
the device that is a blocking fetch per pair, so it runs here in numpy:
the frame padded as the prep step pads it, resized to 32x32 by the
port's `resize_bilinear` on the CPU (align_corners=False, half-pixel:
the convention rife_tpu's cv2.resize INTER_LINEAR shares, held to it in
tests/test_torch_video.py), then the port's volumetric SSIM,
ops.ssim_matlab, on the CPU.  No cv2.

The static-replacement branch probes on the device instead
(`video.pipeline.device_probe`): the candidate frame exists only there.
"""
from __future__ import annotations

import numpy as np
import torch

from rife_tpu_torch.ops.resize import resize_bilinear
from rife_tpu_torch.ops.ssim import ssim_matlab_map


def probe_small(frame: np.ndarray, pad_widths) -> np.ndarray:
    """(H, W, 3) uint8 or float frame -> padded -> (32, 32, 3) float32
    (u8 scaled to [0, 1])."""
    x = frame.astype(np.float32)
    if frame.dtype == np.uint8:
        x /= 255.0
    top, bottom, left, right = pad_widths
    if top or bottom or left or right:
        x = np.pad(x, ((top, bottom), (left, right), (0, 0)))
    planes = torch.from_numpy(x).permute(2, 0, 1)[None]
    return resize_bilinear(planes, (32, 32))[0].permute(1, 2, 0).contiguous().numpy()


def ssim_probe(small0: np.ndarray, small1: np.ndarray) -> float:
    """Volumetric SSIM (`ops.ssim_matlab`, L = 1) of two (32, 32, 3)
    float01 probes, on the CPU.  The map is the port's; its mean is taken
    by numpy, as rife_tpu's probe takes it: `torch.mean` sums in another
    order and lands 1 f32 ulp away on some pairs (6e-8 at 0.9449)."""
    ssim_map, _ = ssim_matlab_map(torch.from_numpy(small0)[None],
                                  torch.from_numpy(small1)[None], val_range=1.0)
    return float(np.mean(ssim_map.numpy()))
