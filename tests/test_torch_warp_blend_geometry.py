"""The launch geometry of K2, the fused pair warp + blend
(`ops/cuda/warp_blend.py` `k2_plan`), on the CPU.

The wrapper computes the kernel's grid, block and run size in Python and
passes them to the kernel, so these tests hold the arithmetic the kernel
is given: replaying the kernel's index formulas over the planned grid
(x0 = (blockIdx.x * tx + threadIdx.x) * ppt, pixels x0 .. x0 + ppt - 1 of
row y = blockIdx.y * ty + threadIdx.y of image blockIdx.z, every channel)
reaches every output pixel and channel exactly once, at ragged widths,
one row and the serving shapes, in every (image, flow, mask) dtype
triple; the vector runs are chosen only where W and the flow's, the
mask's and the outputs' addresses allow them, and then every run's
address is a multiple of its bytes; the plans are memoised and each call
gets its own copy; the shape limits raise.  Shapes come from meta tensors
(sizes without storage), so the served 720p shapes cost nothing.  No
JAX, no card.
"""
import itertools

import numpy as np
import pytest
import torch

from rife_tpu_torch.ops.cuda import warp_blend as cb

_TYPES = (torch.bfloat16, torch.float32)
# (image, flow, mask): the kernel's eight instantiated triples.
_TRIPLES = list(itertools.product(_TYPES, _TYPES, _TYPES))
_TRIPLE_IDS = ["-".join(str(t)[6:] for t in tr) for tr in _TRIPLES]
# Ragged widths (odd, narrower than a tile, around a run), one row, other
# channel counts, and the two serving launches (v4.25's 3x768x1280 and
# the paper model's 3x736x1280 at batch 4).
_SHAPES = [(1, 3, 1, 1), (2, 3, 3, 2), (1, 3, 5, 7), (3, 5, 9, 13), (1, 3, 1, 131),
           (2, 3, 67, 131), (1, 3, 2, 257), (1, 1, 4, 6), (2, 16, 3, 1029),
           (4, 3, 768, 1280), (4, 3, 736, 1280)]
_IDS = ["x".join(map(str, s)) for s in _SHAPES]


def _meta(n, c, h, w, triple=(torch.bfloat16,) * 3):
    dt, ft, mt = triple
    return (torch.empty((n, c, h, w), dtype=dt, device="meta"),
            torch.empty((n, 4, h, w), dtype=ft, device="meta"),
            torch.empty((n, 1, h, w), dtype=mt, device="meta"))


def _once(got, size):
    """Every index of range(size) exactly once."""
    got = np.sort(np.asarray(got).ravel())
    return np.array_equal(got, np.arange(size))


def _runs(p):
    """Each thread's first pixel along a row and its row, from the grid."""
    x0 = ((np.arange(p["gx"])[:, None] * p["tx"] + np.arange(p["tx"])[None]) * p["ppt"]).ravel()
    y = (np.arange(p["gy"])[:, None] * p["ty"] + np.arange(p["ty"])[None]).ravel()
    return x0, y


@pytest.mark.parametrize("triple", _TRIPLES, ids=_TRIPLE_IDS)
@pytest.mark.parametrize("n,c,h,w", _SHAPES, ids=_IDS)
def test_k2_plan_covers_every_output_element_once(n, c, h, w, triple):
    img, flow, mask = _meta(n, c, h, w, triple)
    for outs in ((0,), (0, 0, 0)):
        p = cb.k2_plan(img, flow, mask, outs)
        tx, ty, ppt = p["tx"], p["ty"], p["ppt"]
        assert ppt == cb.K2_PPT and p["threads"] == tx * ty <= cb.K2_THREADS
        units = -(-w // ppt)  # threads a row needs
        assert tx <= cb.K2_TX_MAX and ty >= 1 and p["gx"] == -(-units // cb.K2_TX_MAX)
        assert tx * (p["gx"] - 1) < units  # no tile wholly idle
        assert (p["gx"], p["gy"]) == (p["tiles"], p["rows"])
        assert p["blocks"] == p["gx"] * p["gy"] * n
        x0, y = _runs(p)
        x = (x0[x0 < w][:, None] + np.arange(ppt)[None]).ravel()
        assert _once(x[x < w], w) and _once(y[y < h], h)
        # A thread whose run starts past the row's end stores nothing; a
        # run's last pixels past it repeat the row's last and store nothing.
        assert x0.max() + ppt >= w and (p["gy"] - 1) * ty < h
        # Addresses at 0: vector runs exactly where W is a multiple of the run.
        assert p["vec"] == (w % ppt == 0)


@pytest.mark.parametrize("n,c,h,w", [(2, 3, 5, 7), (1, 5, 3, 10), (3, 3, 4, 1)])
def test_k2_replay_writes_every_output_element_once(n, c, h, w):
    """The kernel's flat output offsets plane + row + x0 + j (+ hw per
    channel), over the whole grid, are each element of (N, C, H, W) once."""
    p = cb.k2_plan(*_meta(n, c, h, w), (0,))
    hw = h * w
    x0, y = _runs(p)
    offs = []
    for img, yy, xb, ch, j in itertools.product(range(n), y, x0, range(c), range(p["ppt"])):
        if xb < w and yy < h and xb + j < w:
            offs.append(img * c * hw + yy * w + xb + j + ch * hw)
    assert _once(offs, n * c * h * w)


def _view(shape, dtype, offset):
    """A contiguous CPU tensor `offset` elements into its storage."""
    size = int(np.prod(shape))
    return torch.zeros(size + 8, dtype=dtype)[offset:offset + size].view(shape)


@pytest.mark.parametrize("triple", _TRIPLES, ids=_TRIPLE_IDS)
def test_k2_vector_runs_follow_the_addresses(triple):
    """vec only where W is even and the flow's, the mask's and every
    output's address lie on a run's bytes (views with a storage offset);
    then every vector access of the grid, flow runs (4 channels), mask run
    and output runs (each channel) lies on its bytes."""
    dt, ft, mt = triple
    n, c, h, w = 2, 3, 3, 6
    ppt = cb.K2_PPT
    img = torch.zeros(n, c, h, w, dtype=dt)
    esz = img.element_size()
    for f_off, m_off, o_off in itertools.product((0, 1), (0, 1), (0, 1)):
        flow = _view((n, 4, h, w), ft, f_off)
        mask = _view((n, 1, h, w), mt, m_off)
        base = 1 << 20
        outs = (base, base + o_off * esz, base + 2 * n * c * h * w * esz)
        for form in (outs[:1], outs):
            p = cb.k2_plan(img, flow, mask, form)
            aligned = (flow.data_ptr() % (ppt * flow.element_size()) == 0
                       and mask.data_ptr() % (ppt * mask.element_size()) == 0
                       and all(o % (ppt * esz) == 0 for o in form))
            assert p["vec"] == aligned
            assert p["vec"] == (f_off == 0 and m_off == 0 and (o_off == 0 or len(form) == 1))
            if not p["vec"]:
                continue
            x0, y = _runs(p)
            hw = h * w
            for img_i, yy, xb in itertools.product(range(n), y[y < h], x0[x0 < w]):
                for k in range(4):
                    at = flow.data_ptr() + ((4 * img_i + k) * hw + yy * w + xb) * flow.element_size()
                    assert at % (ppt * flow.element_size()) == 0
                at = mask.data_ptr() + (img_i * hw + yy * w + xb) * mask.element_size()
                assert at % (ppt * mask.element_size()) == 0
                for o, ch in itertools.product(form, range(c)):
                    assert (o + ((img_i * c + ch) * hw + yy * w + xb) * esz) % (ppt * esz) == 0
    odd = cb.k2_plan(torch.zeros(1, 3, 2, 7, dtype=dt), torch.zeros(1, 4, 2, 7, dtype=ft),
                     torch.zeros(1, 1, 2, 7, dtype=mt), (0,))
    assert not odd["vec"]  # W odd: value by value


def test_k2_serving_plans():
    """Both serving launches: 20 tiles of 32 threads over a 1280-wide row,
    two rows a block (64 threads), 2 pixels a thread, vector runs; a
    narrow row takes more rows a block, one row one."""
    for h in (768, 736):
        p = cb.k2_plan(*_meta(4, 3, h, 1280), (0, 0, 0))
        assert (p["tiles"], p["tx"], p["ty"], p["rows"], p["ppt"], p["vec"]) == \
            (20, 32, 2, h // 2, 2, True)
    assert cb.k2_plan(*_meta(2, 3, 40, 24), (0,))["ty"] == 5  # 12 threads a row
    assert cb.k2_plan(*_meta(2, 3, 1, 24), (0,))["ty"] == 1


def test_k2_plans_are_memoised_and_copied():
    img, flow, mask = _meta(4, 3, 736, 1280)
    first = cb.k2_plan(img, flow, mask, (0,))
    first["gx"] = -1
    again = cb.k2_plan(img, flow, mask, (0,))
    assert again["gx"] == 20 and again is not first
    assert cb._k2_plan(img, flow, mask, (0,)) is cb._k2_plan(img, flow, mask, (64, 128, 256))
    assert cb._k2_plan(img, flow, mask, (0,)) is not cb._k2_plan(img, flow, mask, (0, 2, 0))
    cb._k2_plan_of.cache_clear()
    cb.k2_plan(img, flow, mask, (0,))
    cb.k2_plan(img, flow, mask, (0,))
    assert cb._k2_plan_of.cache_info().misses == 1


def test_k2_shape_limits_raise_with_a_message():
    with pytest.raises(ValueError, match="in-plane offsets are 32-bit"):
        cb.k2_plan(*_meta(1, 3, 1 << 16, 1 << 15), (0,))
    cb.k2_plan(*_meta(1, 3, (1 << 16) - 1, 1 << 15), (0,))  # just below 2^31
    with pytest.raises(ValueError, match="K2's grid holds N and row blocks"):
        cb.k2_plan(*_meta(65536, 3, 2, 8), (0,))
    with pytest.raises(ValueError, match="K2's grid holds N and row blocks"):
        cb.k2_plan(*_meta(1, 3, 1 << 20, 1024), (0,))  # 2^20 row blocks of one row
    # Past 2^31 elements in all is fine: the planes' bases are 64-bit.
    assert 760 * 3 * 736 * 1280 > 2 ** 31
    assert cb.k2_plan(*_meta(760, 3, 736, 1280), (0,))["blocks"] == 20 * 368 * 760
