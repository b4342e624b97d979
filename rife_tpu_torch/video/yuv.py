"""Raw YUV420 planar sequence IO (port of rife_tpu/video/yuv.py; reference
benchmark/yuv_frame_io.py:13-124).

Used by the HD benchmarks: frames are stored as planar 4:2:0; chroma is
bilinearly upsampled to full resolution by `read_frame` (cv2.resize
INTER_LINEAR) and box-downsampled on write.  `read_rgb` is the reference's
exact RGB read: PIL's default (bicubic) chroma upsample, cv2's INTER_CUBIC
where PIL is missing (`rgb_chroma_route` says which runs), the numpy f32
matrix product and a truncation to uint8.  It stays in numpy: one ulp
anywhere flips a whole LSB of the ground truth.  cv2 and PIL are imported
where they are used.
"""
from __future__ import annotations

import importlib.util

import numpy as np


def rgb_chroma_route() -> str:
    """How `read_rgb` upsamples chroma on this host: "PIL" (the
    reference's) or "cv2 INTER_CUBIC" (where PIL is not installed)."""
    return "PIL" if importlib.util.find_spec("PIL") is not None else "cv2 INTER_CUBIC"


class YUV420Reader:
    def __init__(self, path: str, width: int, height: int):
        self.f = open(path, "rb")
        self.w, self.h = width, height
        self.frame_bytes = width * height * 3 // 2

    def _read_planes(self, index: int | None):
        if index is not None:
            self.f.seek(index * self.frame_bytes)
        buf = self.f.read(self.frame_bytes)
        if len(buf) < self.frame_bytes:
            return None
        w, h = self.w, self.h
        y = np.frombuffer(buf, np.uint8, w * h).reshape(h, w)
        u = np.frombuffer(buf, np.uint8, w * h // 4, w * h).reshape(h // 2, w // 2)
        v = np.frombuffer(buf, np.uint8, w * h // 4, w * h * 5 // 4).reshape(h // 2, w // 2)
        return y, u, v

    def read_frame(self, index: int | None = None) -> np.ndarray | None:
        """Returns (H, W, 3) float32 YUV in [0,1] with upsampled chroma
        (chroma channels NOT centered).  With `index`, seeks to that frame
        first (the HD benchmark reads frames by random access,
        benchmark/HD.py:47-51)."""
        import cv2

        planes = self._read_planes(index)
        if planes is None:
            return None
        y, u, v = planes
        w, h = self.w, self.h
        uu = cv2.resize(u, (w, h), interpolation=cv2.INTER_LINEAR)
        vv = cv2.resize(v, (w, h), interpolation=cv2.INTER_LINEAR)
        return np.stack([y, uu, vv], axis=-1).astype(np.float32) / 255.0

    def read_rgb(self, index: int | None = None) -> np.ndarray | None:
        """Frame as uint8 RGB — exact YUV_Read(toRGB=True) semantics
        (benchmark/yuv_frame_io.py:30-62): PIL default (bicubic) chroma
        upsample, chroma centered at 0, skimage yuv2rgb matrix, clip and
        TRUNCATE to uint8 (the reference uses astype, not rounding)."""
        planes = self._read_planes(index)
        if planes is None:
            return None
        y, u, v = planes
        w, h = self.w, self.h
        try:
            from PIL import Image

            uu = np.array(Image.fromarray(u).resize([w, h]))
            vv = np.array(Image.fromarray(v).resize([w, h]))
        except ImportError:
            import cv2

            uu = cv2.resize(u, (w, h), interpolation=cv2.INTER_CUBIC)
            vv = cv2.resize(v, (w, h), interpolation=cv2.INTER_CUBIC)
        yuv = np.stack(
            [y / 255.0, uu / 255.0 - 0.5, vv / 255.0 - 0.5], axis=-1
        ).astype(np.float32)
        rgb = yuv_to_rgb(yuv)
        return (255.0 * np.clip(rgb, 0.0, 1.0)).astype(np.uint8)

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                break
            yield fr
        self.f.close()

    def close(self):
        self.f.close()


class YUV420Writer:
    def __init__(self, path: str, width: int, height: int):
        self.f = open(path, "wb")
        self.w, self.h = width, height

    def write_frame(self, yuv01: np.ndarray):
        u8 = np.clip(yuv01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
        y = u8[..., 0]
        u = u8[::2, ::2, 1]
        v = u8[::2, ::2, 2]
        self.f.write(y.tobytes())
        self.f.write(u.tobytes())
        self.f.write(v.tobytes())

    def close(self):
        self.f.close()


def yuv_to_rgb(yuv01: np.ndarray) -> np.ndarray:
    """skimage-compatible yuv2rgb."""
    m = np.array(
        [[1.0, 0.0, 1.13988303],
         [1.0, -0.394642334, -0.58062185],
         [1.0, 2.03206185, 0.0]], dtype=np.float32
    )
    return yuv01 @ m.T


def rgb_to_yuv(rgb01: np.ndarray) -> np.ndarray:
    m = np.array(
        [[0.299, 0.587, 0.114],
         [-0.14714119, -0.28886916, 0.43601035],
         [0.61497538, -0.51496512, -0.10001026]], dtype=np.float32
    )
    return rgb01 @ m.T
