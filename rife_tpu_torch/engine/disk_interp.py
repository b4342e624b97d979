"""O(1)-memory disk-spill interpolation (port of
rife_tpu/engine/disk_interp.py; reference
rife_app/utils/disk_based_interpolation.py:44-465).

Frames persist as PNGs and one pair at a time is on the device; midpoint
"waves" run until the target count is reached (at most MAX_WAVES), then a
uniform trim takes away the overshoot.  Frames are written through the
native `f32_to_u8` and read back through `u8_to_f32`, so each wave
interpolates the u8-rounded frames of the one before.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from rife_tpu_torch.native import f32_to_u8, u8_to_f32

MAX_WAVES = 10


@dataclass
class FrameRef:
    path: str
    index: float  # temporal position key (floats between sources)
    wave: int


class DiskInterpolator:
    def __init__(self, engine, workdir: str):
        self.engine = engine
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self._counter = 0

    def _save(self, arr01: np.ndarray, index: float, wave: int) -> FrameRef:
        import cv2

        path = os.path.join(self.workdir, f"f{self._counter:07d}.png")
        self._counter += 1
        cv2.imwrite(path, f32_to_u8(arr01)[..., ::-1])
        return FrameRef(path, index, wave)

    def _load(self, ref: FrameRef) -> np.ndarray:
        import cv2

        return u8_to_f32(cv2.imread(ref.path)[..., ::-1])

    def _on_device(self, ref: FrameRef) -> torch.Tensor:
        return torch.from_numpy(self._load(ref)[None]).to(self.engine.device)

    def interpolate(self, frames01: list[np.ndarray], target_count: int) -> list[np.ndarray]:
        """Densify `frames01` (HWC float32 in [0, 1], padded as the engine
        needs) to >= target_count frames by midpoint waves, then trim
        uniformly to exactly target_count."""
        refs = [self._save(f, float(i), 0) for i, f in enumerate(frames01)]
        wave = 0
        while len(refs) < target_count and wave < MAX_WAVES:
            wave += 1
            new_refs: list[FrameRef] = []
            for a, b in zip(refs[:-1], refs[1:]):
                new_refs.append(a)
                mid = self.engine.interpolate(self._on_device(a), self._on_device(b))
                mid = mid[0].float().cpu().numpy()
                new_refs.append(self._save(mid, (a.index + b.index) / 2, wave))
            new_refs.append(refs[-1])
            refs = new_refs
        if len(refs) > target_count:
            keep = np.linspace(0, len(refs) - 1, target_count).round().astype(int)
            refs = [refs[i] for i in keep]
        return [self._load(r) for r in refs]

    def cleanup(self):
        for f in os.listdir(self.workdir):
            if f.endswith(".png"):
                os.remove(os.path.join(self.workdir, f))
