"""Vimeo90K triplets and the synthetic triplets, numpy only (a copy of
the parts of rife_tpu/data/vimeo.py that training `rife` uses, so that
the port imports nothing of rife_tpu).

- `VimeoTriplets`: im1/im2/im3.png (448x256) listed in tri_trainlist.txt
  with the reference's 95/5 train/validation split; tri_testlist.txt for
  test.  Frames are read with cv2 (BGR, as the reference).
- `SyntheticTriplets`: linearly translating textured scenes (smooth
  multi-octave base plus sharp rectangles, cropped from a margin canvas
  at offsets (0, d/2, d), d even), so the midpoint is the exact t = 0.5
  frame: training and validation run without the dataset.
- `_augment`: the reference's train augmentation (random crop, channel
  reversal, vertical and horizontal flips, temporal swap, rotation).
- `batch_iterator`: one process, no threads; yields uint8 NHWC batches
  (the trainer divides by 255 on the device).  Shuffling and augment
  draws are those of the reference's iterator (per-(epoch, slot)
  generators), so for the same seed and crop it gives the reference's
  batches, which do not depend on its worker and prefetch settings.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np


class VimeoTriplets:
    def __init__(self, root: str, split: str = "train"):
        self.root = root
        self.image_root = os.path.join(root, "sequences")
        with open(os.path.join(root, "tri_trainlist.txt")) as f:
            trainlist = [line for line in f.read().splitlines() if line]
        cnt = int(len(trainlist) * 0.95)
        if split == "train":
            self.items = trainlist[:cnt]
        elif split == "validation":
            self.items = trainlist[cnt:]
        else:
            with open(os.path.join(root, "tri_testlist.txt")) as f:
                self.items = [line for line in f.read().splitlines() if line]
        self.split = split

    def __len__(self):
        return len(self.items)

    def load(self, index: int):
        import cv2

        p = os.path.join(self.image_root, self.items[index])
        frames = [cv2.imread(os.path.join(p, f"im{i}.png")) for i in (1, 2, 3)]
        if any(f is None for f in frames):
            raise FileNotFoundError(p)
        img0, gt, img1 = frames
        return img0, gt, img1, 0.5


def _textured_canvas(rng: np.random.Generator, h: int, w: int, m: int):
    """(h+2m, w+2m, 3) float canvas: multi-octave smoothed noise (coarse
    structure the 1/16-resolution level can match) plus sharp random
    colour rectangles (edges for the fine levels)."""
    H, W = h + 2 * m, w + 2 * m
    c = rng.random((H, W, 3), dtype=np.float32)
    for r in (1, 2, 4, 8):
        c = (c + np.roll(c, r, 0) + np.roll(c, -r, 0)
             + np.roll(c, r, 1) + np.roll(c, -r, 1)) / 5
    c -= c.min()
    c *= 175.0 / max(float(c.max()), 1e-6)
    c += 40.0  # mid-range base so the rectangles stand out both ways
    for _ in range(8):
        hh = int(rng.integers(6, max(8, H // 4)))
        ww = int(rng.integers(6, max(8, W // 4)))
        y0 = int(rng.integers(0, H - hh))
        x0 = int(rng.integers(0, W - ww))
        c[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, 3)
    return c


def _crop_at(canvas, m: int, h: int, w: int, dy: int, dx: int):
    return np.ascontiguousarray(canvas[m + dy:m + dy + h, m + dx:m + dx + w])


class SyntheticTriplets:
    """Linear-translation triplets for dataset-free training and
    validation: crops from one textured canvas at offsets (0, d/2, d)
    with d even, so the middle frame is exact and there is no wrap seam."""

    _MARGIN = 12  # covers |d| <= 12 px

    def __init__(self, n: int = 256, h: int = 256, w: int = 448, seed: int = 0):
        self.n, self.h, self.w = n, h, w
        self.seed = seed
        self.split = "train"
        self._cache: dict = {}

    def __len__(self):
        return self.n

    def _scene(self, index: int):
        """Canvas and motion of `index`, built once and kept as uint8."""
        hit = self._cache.get(index)
        if hit is None:
            rng = np.random.default_rng(self.seed * 100003 + index)
            canvas = _textured_canvas(
                rng, self.h, self.w, self._MARGIN).astype(np.uint8)
            dx, dy = (2 * int(v) for v in rng.integers(-6, 7, 2))
            hit = self._cache[index] = (canvas, dx, dy)
        return hit

    def load(self, index: int):
        h, w, m = self.h, self.w, self._MARGIN
        canvas, dx, dy = self._scene(index)
        frames = [_crop_at(canvas, m, h, w, dy * t // 2, dx * t // 2)
                  for t in (0, 1, 2)]
        return frames[0], frames[1], frames[2], 0.5


def _augment(img0, gt, img1, timestep, rng: np.random.Generator, crop: int = 224):
    ih, iw, _ = img0.shape
    x = rng.integers(0, ih - crop + 1)
    y = rng.integers(0, iw - crop + 1)
    img0 = img0[x:x + crop, y:y + crop]
    gt = gt[x:x + crop, y:y + crop]
    img1 = img1[x:x + crop, y:y + crop]
    if rng.random() < 0.5:
        img0, gt, img1 = img0[:, :, ::-1], gt[:, :, ::-1], img1[:, :, ::-1]
    if rng.random() < 0.5:
        img0, gt, img1 = img0[::-1], gt[::-1], img1[::-1]
    if rng.random() < 0.5:
        img0, gt, img1 = img0[:, ::-1], gt[:, ::-1], img1[:, ::-1]
    if rng.random() < 0.5:
        img0, img1 = img1, img0
        timestep = 1 - timestep
    p = rng.random()
    if p < 0.25:
        k = 3  # 90 degrees clockwise == rot90 k=3 (np.rot90 is counter-clockwise)
    elif p < 0.5:
        k = 2
    elif p < 0.75:
        k = 1
    else:
        k = 0
    if k:
        img0, gt, img1 = (np.rot90(a, k) for a in (img0, gt, img1))
    return img0, gt, img1, timestep


def batch_iterator(dataset, batch_size: int, *, seed: int = 1234, crop: int = 224,
                   epochs: int | None = None,
                   augment: bool | None = None) -> Iterator[dict]:
    """Yields {img0, img1, gt: (B, H, W, 3) uint8, timestep: (B,) f32}.

    Each epoch shuffles the indices with one generator seeded by `seed`;
    each item is augmented (by default on the train split) with its own
    generator keyed by (seed, epoch, slot).  Drops the last partial batch."""
    if augment is None:
        augment = dataset.split == "train"
    epoch = 0
    order_rng = np.random.default_rng(seed)
    while epochs is None or epoch < epochs:
        idx = np.arange(len(dataset))
        order_rng.shuffle(idx)
        for start in range(0, len(idx) - batch_size + 1, batch_size):
            items = []
            for slot in range(start, start + batch_size):
                img0, gt, img1, t = dataset.load(int(idx[slot]))
                if augment:
                    rng = np.random.default_rng([seed, 7919 + epoch, slot])
                    img0, gt, img1, t = _augment(img0, gt, img1, t, rng, crop)
                items.append((img0, gt, img1, t))
            b0, bg, b1, bt = zip(*items)
            yield {"img0": np.stack(b0), "img1": np.stack(b1), "gt": np.stack(bg),
                   "timestep": np.asarray(bt, np.float32)}
        epoch += 1
