"""Host-side interpolation schedules (port of rife_tpu/engine/schedule.py).

Recursive midpoint expansion (reference inference_video.py:178-188),
whole-list doubling (inference_img.py:95-103), ratio bisection
(inference_img.py:70-93) and direct timestep sampling for
timestep-conditioned models (benchmark/HD_multi_4X.py:43-48).  Each only
calls `engine.interpolate`, so they take any engine (and any frame type
that engine takes).
"""
from __future__ import annotations

from typing import List


def midpoint_tree(engine, img0, img1, n: int, tta: bool = False) -> List:
    """n intermediate frames by recursive midpoint bisection (in order)."""
    if n <= 0:
        return []
    if n == 1:
        return [engine.interpolate(img0, img1, 0.5, tta)]
    mid = engine.interpolate(img0, img1, 0.5, tta)
    first = midpoint_tree(engine, img0, mid, n // 2, tta)
    second = midpoint_tree(engine, mid, img1, n // 2, tta)
    if n % 2:
        return [*first, mid, *second]
    # Even n omits the midpoint (reference make_inference,
    # inference_video.py:186-188): n=2 yields t=0.25 and t=0.75.
    return [*first, *second]


def exp_doubling(engine, frames: List, passes: int, tta: bool = False) -> List:
    """2^passes densification by repeated whole-list midpoint insertion."""
    for _ in range(passes):
        out = []
        for a, b in zip(frames[:-1], frames[1:]):
            out.append(a)
            out.append(engine.interpolate(a, b, 0.5, tta))
        out.append(frames[-1])
        frames = out
    return frames


def bisect_to_ratio(engine, img0, img1, ratio: float, *, threshold: float = 0.02,
                    max_cycles: int = 8, tta: bool = False):
    """The frame at `ratio`: sampled directly by a timestep-conditioned
    engine, else the reference's binary search of midpoints, stopping
    within `threshold` of `ratio` or after `max_cycles`."""
    if engine.supports_timestep:
        return engine.interpolate(img0, img1, ratio, tta)
    if ratio <= threshold:
        return img0
    if ratio >= 1 - threshold:
        return img1
    tmp_img0, tmp_img1 = img0, img1
    lo, hi = 0.0, 1.0
    middle = None
    for _ in range(max_cycles):
        middle = engine.interpolate(tmp_img0, tmp_img1, 0.5, tta)
        mid_ratio = (lo + hi) / 2
        if abs(ratio - mid_ratio) < threshold:
            break
        if ratio > mid_ratio:
            tmp_img0 = middle
            lo = mid_ratio
        else:
            tmp_img1 = middle
            hi = mid_ratio
    return middle


def timestep_frames(engine, img0, img1, n: int, tta: bool = False) -> List:
    """n evenly spaced frames at t = i/(n+1) (the RIFE_m protocol).  A
    fixed-midpoint model would give the same t=0.5 frame n times, so it is
    refused."""
    if n > 1 and not engine.supports_timestep:
        raise ValueError(
            f"model '{engine.model_name}' is not timestep-conditioned; "
            f"timestep_frames(n={n}) would silently produce n copies of "
            "the midpoint. Use a rife_m-family checkpoint, or "
            "schedule.bisect_to_ratio per target t."
        )
    return [
        engine.interpolate(img0, img1, (i + 1) / (n + 1), tta) for i in range(n)
    ]
