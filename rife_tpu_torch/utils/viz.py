"""Training image panels (port of rife_tpu/utils/viz.py; reference
train.py:29-37, 75-87).

Every `--vis_interval` steps the trainer writes, for the first 5 samples
of the batch, `{i}/img` = teacher | student | gt side by side,
`{i}/flow` = the student's and the teacher's flow as colours, and
`{i}/mask` = both masks, to TensorBoard when it imports and always as
PNGs.  Host numpy only: the panels are built from arrays already fetched
from the device, as NHWC (`train.loop.vis_to_host`).  PIL and cv2 are
imported when a PNG is written.
"""
from __future__ import annotations

import os

import numpy as np


def flow_to_rgb(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2+) flow -> RGB in [0, 1], as the reference's flow2rgb:
    normalised by the largest |value| of all its channels, a white canvas
    shifted by (+u, -(u + v) / 2, +v) of the first two."""
    h, w = flow.shape[:2]
    flow = np.asarray(flow, np.float32)
    denom = np.abs(flow).max()
    nf = flow / (denom if denom > 0 else 1.0)
    rgb = np.ones((h, w, 3), np.float32)
    rgb[:, :, 0] += nf[:, :, 0]
    rgb[:, :, 1] -= 0.5 * (nf[:, :, 0] + nf[:, :, 1])
    rgb[:, :, 2] += nf[:, :, 1]
    return rgb.clip(0.0, 1.0)


def _u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(x, np.float32), 0.0, 1.0) * 255).astype(np.uint8)


def build_panels(vis: dict, n: int = 5) -> dict[str, np.ndarray]:
    """{tag: (H, W', 3) uint8} panels from a step's vis arrays, NHWC:
    pred, gt, merged_tea, mask and mask_tea (N, H, W, 1), flow and
    flow_tea (N, H, W, 2+)."""
    pred, gt, tea = (np.asarray(vis[k]) for k in ("pred", "gt", "merged_tea"))
    mask, mask_t = np.asarray(vis["mask"]), np.asarray(vis["mask_tea"])
    flow, flow_t = np.asarray(vis["flow"]), np.asarray(vis["flow_tea"])
    panels = {}
    for i in range(min(n, pred.shape[0])):
        panels[f"{i}/img"] = _u8(np.concatenate([tea[i], pred[i], gt[i]], 1))
        panels[f"{i}/flow"] = _u8(
            np.concatenate([flow_to_rgb(flow[i]), flow_to_rgb(flow_t[i])], 1))
        m = np.concatenate([mask[i], mask_t[i]], 1)
        panels[f"{i}/mask"] = np.repeat(_u8(m), 3, axis=-1)
    return panels


def dump_panels(logger, step: int, vis: dict, n: int = 5) -> list[str]:
    """Write the panels through a `MetricLogger` -> the PNG paths."""
    return [logger.log_image(tag, step, img) for tag, img in build_panels(vis, n).items()]


def save_png(path: str, img_u8: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB image as a PNG (PIL, else cv2)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        from PIL import Image
    except ImportError:
        import cv2

        if not cv2.imwrite(path, np.ascontiguousarray(img_u8[..., ::-1])):
            raise OSError(f"cv2 could not write {path}")
        return
    Image.fromarray(img_u8).save(path)
