"""Host-side image IO: PNG/JPG via cv2, EXR as half floats (port of
rife_tpu/utils/imageio.py; reference inference_img.py:48-60).

Images are HWC float32 RGB in [0, 1]; EXR files skip the /255 scaling
and are written back as half floats (cv2 reads and writes EXR only where
it was built with OpenEXR and `OPENCV_IO_ENABLE_OPENEXR` is set).  cv2 is
imported where it is used, so the port imports without it.
"""
from __future__ import annotations

import os

import numpy as np


def read_image(path: str) -> tuple[np.ndarray, bool]:
    """-> (HWC float32 RGB in [0, 1], or raw for EXR; whether it is EXR)."""
    import cv2

    if path.lower().endswith(".exr"):
        img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1].astype(np.float32), True
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img[..., ::-1].astype(np.float32) / 255.0, False


def write_image(path: str, img: np.ndarray, is_exr: bool = False):
    """img: HWC float RGB (in [0, 1] unless EXR)."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if is_exr or path.lower().endswith(".exr"):
        cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1].astype(np.float16)),
                    [cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_HALF])
    else:
        cv2.imwrite(path, to_uint8(img)[..., ::-1])


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8, rounded half to even (numpy's round)."""
    return (np.clip(np.asarray(img), 0, 1) * 255.0).round().astype(np.uint8)
