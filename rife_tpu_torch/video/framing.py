"""Frame extraction and boundary-frame quality heuristics (port of
rife_tpu/video/framing.py; reference rife_app/utils/framing.py:9-202).

Video info from cv2's properties, boundary-frame extraction that skips
black or overexposed frames, and the temporal-alignment check between two
videos.  The padding contract (centred, min 512, %32) is
`ops.pad.pad_centered`.  cv2 is imported where it is used.
"""
from __future__ import annotations

import os

import numpy as np


def get_video_info(path: str) -> dict:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
    codec = "".join(chr((fourcc >> (8 * i)) & 0xFF) for i in range(4)).strip("\x00")
    info = {
        "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        "fps": cap.get(cv2.CAP_PROP_FPS) or 25.0,
        "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        "codec": codec,
    }
    info["duration"] = info["frame_count"] / info["fps"] if info["fps"] else 0.0
    cap.release()
    return info


def frame_quality(frame_bgr: np.ndarray) -> dict:
    """Black/overexposed heuristics (framing.py:125-133)."""
    import cv2

    gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
    mean = float(gray.mean())
    return {
        "mean_brightness": mean,
        "is_black": mean < 10.0,
        "is_overexposed": mean > 245.0,
    }


def extract_boundary_frame(path: str, position: str = "last",
                           max_scan: int = 10) -> np.ndarray:
    """First/last frame that is neither black nor overexposed, scanning up
    to max_scan frames inward (framing.py:42-139), as HWC float32 RGB in
    [0, 1]."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    indices = range(min(max_scan, total)) if position == "first" else range(
        total - 1, max(-1, total - 1 - max_scan), -1
    )
    best = None
    for idx in indices:
        cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = cap.read()
        if not ok:
            continue
        if best is None:
            best = frame
        q = frame_quality(frame)
        if not q["is_black"] and not q["is_overexposed"]:
            cap.release()
            return frame[..., ::-1].astype(np.float32) / 255.0
    cap.release()
    if best is None:
        raise ValueError(f"no readable frames in {path}")
    return best[..., ::-1].astype(np.float32) / 255.0


def extract_frames(path: str, out_dir: str, limit: int | None = None) -> int:
    """Dump frames as numbered PNGs; returns count (framing.py:42-76)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok or (limit is not None and n >= limit):
            break
        cv2.imwrite(os.path.join(out_dir, f"{n:07d}.png"), frame)
        n += 1
    cap.release()
    return n


def validate_temporal_alignment(video_a: str, video_b: str,
                                fps_tol: float = 0.01) -> dict:
    """Check two videos are interpolation-compatible (framing.py:141-202)."""
    a, b = get_video_info(video_a), get_video_info(video_b)
    issues = []
    if (a["width"], a["height"]) != (b["width"], b["height"]):
        issues.append("resolution mismatch")
    if abs(a["fps"] - b["fps"]) > fps_tol * max(a["fps"], b["fps"]):
        issues.append("fps mismatch")
    return {"compatible": not issues, "issues": issues, "a": a, "b": b}
