"""rife_tpu_torch's septuplet data and multi-process batch slicing
against rife_tpu's, on the CPU: the same seeds give the same uint8
batches and timesteps, for every loader setting."""
import os

import numpy as np
import pytest

from rife_tpu.data import SyntheticSeptuplets as JaxSyntheticSep
from rife_tpu.data import SyntheticTriplets as JaxSynthetic
from rife_tpu.data import VimeoSeptuplets as JaxVimeoSep
from rife_tpu.data import batch_iterator as jax_batches
from rife_tpu_torch.data import (SyntheticSeptuplets, SyntheticTriplets, VimeoSeptuplets,
                                 batch_iterator)


def _equal(x, y):
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype, k
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("workers,prefetch", [(0, 0), (2, 0), (0, 2), (2, 2)])
def test_septuplet_batches_equal_reference(workers, prefetch):
    """4 batches (crossing an epoch): the frame picks (keyed by seed,
    epoch and slot) and the augment draws are the reference's whatever
    the loader threads; the timesteps vary."""
    ref = jax_batches(JaxSyntheticSep(n=10, h=72, w=80, seed=3), 4, seed=6, crop=64,
                      workers=workers, prefetch=prefetch, u8=True)
    it = batch_iterator(SyntheticSeptuplets(n=10, h=72, w=80, seed=3), 4, seed=6,
                        crop=64, workers=workers, prefetch=prefetch)
    ts = set()
    try:
        for _ in range(4):
            x, y = next(ref), next(it)
            _equal(x, y)
            ts.update(float(t) for t in y["timestep"])
    finally:
        it.close() if prefetch else None
        ref.close() if prefetch else None
    assert len(ts) > 3 and all(0 < t < 1 for t in ts)


def test_synthetic_septuplet_frames_and_validation_picks():
    """Frames are the canvas shifted by whole steps (the middle frame exact
    at its timestep); a validation split picks the same frames every
    visit; a train item without a pick generator draws a fresh pick per
    visit, as the reference's."""
    mine, ref = SyntheticSeptuplets(n=4, h=40, w=48, seed=2), JaxSyntheticSep(n=4, h=40,
                                                                            w=48, seed=2)
    for i in range(4):
        for pick_seed in (0, 1):
            a = mine.load(i, pick_rng=np.random.default_rng(pick_seed))
            b = ref.load(i, pick_rng=np.random.default_rng(pick_seed))
            for u, v in zip(a[:3], b[:3]):
                np.testing.assert_array_equal(u, v)
            assert a[3] == b[3]
    first = [mine.load(0)[3] for _ in range(12)]
    again = [ref.load(0)[3] for _ in range(12)]
    assert first == again and len(set(first)) > 1
    mine.split = ref.split = "validation"
    assert len({mine.load(1)[3] for _ in range(5)}) == 1
    assert mine.load(1)[3] == ref.load(1)[3]


def test_vimeo_septuplets_match_reference(tmp_path):
    import cv2

    rng = np.random.default_rng(4)
    items = [f"{i:05d}/0001" for i in range(20)]
    for it in items:
        os.makedirs(tmp_path / "sequences" / it)
        for k in range(1, 8):
            cv2.imwrite(str(tmp_path / "sequences" / it / f"im{k}.png"),
                        rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    (tmp_path / "sep_trainlist.txt").write_text("\n".join(items) + "\n")
    (tmp_path / "sep_testlist.txt").write_text("\n".join(items[:3]) + "\n")
    for split in ("train", "validation", "test"):
        mine, ref = VimeoSeptuplets(str(tmp_path), split), JaxVimeoSep(str(tmp_path), split)
        assert mine.items == ref.items and len(mine) == len(ref)
        n = min(2, len(mine))  # the validation split holds one item
        x = next(jax_batches(ref, n, seed=9, crop=32, u8=True))
        y = next(batch_iterator(mine, n, seed=9, crop=32))
        _equal(x, y)
    os.remove(tmp_path / "sequences" / items[0] / "im1.png")
    os.remove(tmp_path / "sequences" / items[0] / "im2.png")
    ds = VimeoSeptuplets(str(tmp_path), "train")
    with pytest.raises(FileNotFoundError):
        for _ in range(20):  # a fresh pick each visit: some read a removed frame
            ds.load(0)


@pytest.mark.parametrize("count", [2, 3])
def test_process_shares_equal_reference(count):
    """Process i of `count` takes every count-th index of each epoch's
    order: its batches are the reference's, and the shares of one epoch
    are disjoint and together cover the indices once."""
    seen = []
    for index in range(count):
        ref = jax_batches(JaxSynthetic(n=12, h=40, w=40, seed=1), 2, seed=4, crop=32,
                          process_index=index, process_count=count, epochs=1, u8=True)
        mine = list(batch_iterator(SyntheticTriplets(n=12, h=40, w=40, seed=1), 2, seed=4,
                                   crop=32, process_index=index, process_count=count,
                                   epochs=1))
        want = list(ref)
        assert len(mine) == len(want) == 12 // count // 2
        for x, y in zip(want, mine):
            _equal(x, y)
        order = np.arange(12)
        np.random.default_rng(4).shuffle(order)
        seen.extend(order[index::count].tolist())
    assert sorted(seen) == list(range(12))
