"""Vimeo90K triplets and septuplets and their synthetic stand-ins, numpy
only (a copy of rife_tpu/data/vimeo.py, so that the port imports nothing
of rife_tpu).

- `VimeoTriplets`: im1/im2/im3.png (448x256) listed in tri_trainlist.txt
  with the reference's 95/5 train/validation split; tri_testlist.txt for
  test.  Frames are read with cv2 (BGR, as the reference).
- `VimeoSeptuplets`: im1..im7.png listed in sep_trainlist.txt (the same
  split); each visit picks 3 of the 7 frames, sorted, and the timestep
  t = (i1 - i0) / (i2 - i0 + 1e-6) (fractional-timestep training of
  `rife_m` and v4.25, the reference's commented-out dataset.py:59-68).
- `SyntheticTriplets` / `SyntheticSeptuplets`: linearly translating
  textured scenes (smooth multi-octave base plus sharp rectangles,
  cropped from a margin canvas at exact integer offsets), so the middle
  frame is exact at its timestep: training and validation run without
  the dataset.
- `_augment`: the reference's train augmentation (random crop, channel
  reversal, vertical and horizontal flips, temporal swap with t -> 1 - t,
  rotation).
- `batch_iterator`: yields uint8 NHWC batches (the trainer divides by 255
  on the device), process `process_index` of `process_count` taking every
  process_count-th index of each epoch's order, optionally loaded on a
  thread pool (`workers`) and assembled ahead on a background thread
  (`prefetch`), as the reference's iterator does.  Shuffling, the
  septuplets' frame picks and the augment draws are the reference's
  (per-(epoch, slot) generators), so for the same seed and crop it gives
  the reference's batches, for every worker and prefetch setting.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
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


def _pick(rng: np.random.Generator):
    """3 of the 7 frames, sorted, and the middle one's timestep."""
    ind = rng.permutation(7)[:3]
    ind.sort()
    return ind, float((ind[1] - ind[0]) / (ind[2] - ind[0] + 1e-6))


class VimeoSeptuplets:
    """Vimeo90K septuplets with a fresh pick of 3 frames per visit.

    `batch_iterator` hands `load` a pick generator keyed by (seed, epoch,
    slot) (`stochastic_pick`); without one a train item draws from
    (seed, index, ticket), a ticket per visit; the validation and test
    splits always pick by (seed, 13, index), so their PSNR is the same at
    every evaluation."""

    stochastic_pick = True

    def __init__(self, root: str, split: str = "train", seed: int = 0):
        self.root = root
        self.image_root = os.path.join(root, "sequences")
        with open(os.path.join(root, "sep_trainlist.txt")) as f:
            trainlist = [line for line in f.read().splitlines() if line]
        cnt = int(len(trainlist) * 0.95)
        if split == "train":
            self.items = trainlist[:cnt]
        elif split == "validation":
            self.items = trainlist[cnt:]
        else:
            with open(os.path.join(root, "sep_testlist.txt")) as f:
                self.items = [line for line in f.read().splitlines() if line]
        self.split = split
        self.seed = seed
        self._ticket = itertools.count()

    def __len__(self):
        return len(self.items)

    def _pick_rng(self, index: int, pick_rng):
        if self.split != "train":
            return np.random.default_rng([self.seed, 13, index])
        if pick_rng is not None:
            return pick_rng
        return np.random.default_rng([self.seed, index, next(self._ticket)])

    def load(self, index: int, pick_rng=None):
        import cv2

        ind, t = _pick(self._pick_rng(index, pick_rng))
        p = os.path.join(self.image_root, self.items[index])
        frames = [cv2.imread(os.path.join(p, f"im{i + 1}.png")) for i in ind]
        if any(f is None for f in frames):
            raise FileNotFoundError(p)
        img0, gt, img1 = frames
        return img0, gt, img1, t


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


class SyntheticSeptuplets:
    """7-frame linear-translation sequences with the septuplets' picks
    (t = (i1 - i0) / (i2 - i0)): fractional-timestep training and tests of
    `rife_m` and v4.25 without the dataset.  Frame i is the canvas shifted
    by i steps of (dy, dx), |dx|, |dy| <= 4 px, so the middle frame is
    exact at its timestep."""

    _MARGIN = 24  # covers 6 steps of |4| px
    stochastic_pick = True

    def __init__(self, n: int = 256, h: int = 256, w: int = 448, seed: int = 0):
        self.n, self.h, self.w = n, h, w
        self.seed = seed
        self.split = "train"
        self._ticket = itertools.count()
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
            dx, dy = (int(v) for v in rng.integers(-4, 5, 2))
            hit = self._cache[index] = (canvas, dx, dy)
        return hit

    _pick_rng = VimeoSeptuplets._pick_rng

    def load(self, index: int, pick_rng=None):
        h, w, m = self.h, self.w, self._MARGIN
        canvas, dx, dy = self._scene(index)
        ind, t = _pick(self._pick_rng(index, pick_rng))
        frames = [_crop_at(canvas, m, h, w, dy * int(i), dx * int(i)) for i in ind]
        return frames[0], frames[1], frames[2], t


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


class _PrefetchIterator:
    """Runs a batch generator on a daemon thread, `depth` batches ahead, so
    that decoding and augmenting overlap the device step.  The generator's
    exceptions reach the consumer; `close()` stops the thread."""

    _DONE = object()

    def __init__(self, gen, depth: int = 2):
        self._gen = gen
        self._done = False
        self._q = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rife-tpu-torch-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._gen:
                if not self._put(item):
                    return
            self._put(self._DONE)
        except BaseException as e:  # noqa: BLE001 - raised again in __next__
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        # After DONE or an exception the producer puts nothing more.
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item

    def close(self):
        self._stop.set()
        self._done = True
        # Join before closing the generator: closing it from here while its
        # frame runs on the producer thread would raise ValueError.
        self._thread.join(timeout=5.0)
        if not self._thread.is_alive():
            self._gen.close()


def batch_iterator(dataset, batch_size: int, *, seed: int = 1234, crop: int = 224,
                   process_index: int = 0, process_count: int = 1,
                   epochs: int | None = None, augment: bool | None = None,
                   workers: int = 0, prefetch: int = 0) -> Iterator[dict]:
    """Yields {img0, img1, gt: (B, H, W, 3) uint8, timestep: (B,) f32}.

    Each epoch shuffles the indices with one generator seeded by `seed`
    and keeps every `process_count`-th from `process_index` (this
    process's share, the reference's replacement of DistributedSampler);
    a dataset with `stochastic_pick` (the septuplets) picks each item's
    frames with a generator keyed by (seed, epoch, slot), and each item is
    augmented (by default on the train split) with its own generator keyed
    by (seed, epoch, slot).  Drops the last partial batch.
    workers > 0 loads and augments a batch's items on a pool of that many
    threads; prefetch > 0 assembles batches on a background thread that
    many ahead (a `_PrefetchIterator`; close it to stop the thread).  The
    per-(epoch, slot) draws make the batches the same for every setting."""
    gen = _batch_gen(dataset, batch_size, seed=seed, crop=crop,
                     process_index=process_index, process_count=process_count,
                     epochs=epochs, augment=augment, workers=workers)
    return _PrefetchIterator(gen, prefetch) if prefetch > 0 else gen


def _batch_gen(dataset, batch_size, *, seed, crop, process_index, process_count,
               epochs, augment, workers):
    if augment is None:
        augment = dataset.split == "train"
    pool = ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix="rife-tpu-torch-loader") \
        if workers > 0 else None
    try:
        epoch = 0
        order_rng = np.random.default_rng(seed)
        while epochs is None or epoch < epochs:
            idx = np.arange(len(dataset))
            order_rng.shuffle(idx)
            idx = idx[process_index::process_count]

            def load_one(slot, epoch=epoch, idx=idx):
                if getattr(dataset, "stochastic_pick", False):
                    pick = np.random.default_rng([seed, 104729 + epoch, slot])
                    img0, gt, img1, t = dataset.load(int(idx[slot]), pick_rng=pick)
                else:
                    img0, gt, img1, t = dataset.load(int(idx[slot]))
                if augment:
                    rng = np.random.default_rng([seed, 7919 + epoch, slot])
                    img0, gt, img1, t = _augment(img0, gt, img1, t, rng, crop)
                return img0, gt, img1, t

            for start in range(0, len(idx) - batch_size + 1, batch_size):
                slots = range(start, start + batch_size)
                items = list(pool.map(load_one, slots)) if pool \
                    else [load_one(s) for s in slots]
                b0, bg, b1, bt = zip(*items)
                yield {"img0": np.stack(b0), "img1": np.stack(b1),
                       "gt": np.stack(bg), "timestep": np.asarray(bt, np.float32)}
            epoch += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
