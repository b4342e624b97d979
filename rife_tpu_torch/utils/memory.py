"""Device memory monitor (port of rife_tpu/utils/memory.py; reference
rife_app/utils/memory_monitor.py:36-364).

Reads the card's memory from `torch.cuda.memory_stats` (bytes held by
PyTorch's allocator, and its peak) and `torch.cuda.mem_get_info` (the
card's total), keeps a snapshot history with pressure levels
(75/85/95%), exports JSON, and offers a decorator that snapshots around a
call: the hooks the app uses to choose between the standard and the
disk-based interpolation.  `device=None` means the card (and raises
without one); an explicit CPU device reports zeros, as rife_tpu does on a
device without memory stats.
"""
from __future__ import annotations

import functools
import json
import time

import torch

from rife_tpu_torch.engine.inference import resolve_device


def hbm_stats(device=None) -> dict:
    d = resolve_device(device)
    in_use = limit = peak = 0
    if d.type == "cuda":
        stats = torch.cuda.memory_stats(d)
        in_use = stats.get("allocated_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", 0)
        limit = torch.cuda.mem_get_info(d)[1]
    return {
        "bytes_in_use": in_use,
        "bytes_limit": limit,
        "peak_bytes_in_use": peak,
        "utilization": (in_use / limit) if limit else 0.0,
    }


class MemoryMonitor:
    PRESSURE_LEVELS = (("critical", 0.95), ("high", 0.85), ("moderate", 0.75))

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.history: list[dict] = []

    def snapshot(self, label: str = "") -> dict:
        s = hbm_stats(self.device)
        s.update(time=time.time(), label=label, pressure=self.pressure(s["utilization"]))
        self.history.append(s)
        return s

    @classmethod
    def pressure(cls, utilization: float) -> str:
        for name, thresh in cls.PRESSURE_LEVELS:
            if utilization >= thresh:
                return name
        return "normal"

    def recommend_disk_based(self, frames: int, h: int, w: int,
                             bytes_per_px: int = 12) -> bool:
        """Heuristic mirror of the app's hierarchical-mode recommendation
        (memory_monitor.py:182-217): spill to disk when the projected
        working set would push the card into the high-pressure band."""
        s = hbm_stats(self.device)
        if not s["bytes_limit"]:
            return False
        projected = s["bytes_in_use"] + frames * h * w * bytes_per_px
        return projected / s["bytes_limit"] >= 0.85

    def export_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.history, f, indent=2)


def monitor_memory(label: str = "", device=None):
    """Decorator: snapshot the card's memory before/after the wrapped call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            mon = MemoryMonitor(device)
            mon.snapshot(f"{label or fn.__name__}:before")
            try:
                return fn(*a, **kw)
            finally:
                mon.snapshot(f"{label or fn.__name__}:after")

        return wrapper

    return deco
