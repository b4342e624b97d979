"""The launch geometry of the NHWC warp kernels K3 (`ops/cuda/warp_nhwc.py`
`k3_plan`) and K6c, the cb = 1 probe (`ops/cuda/gather_probe.py`
`cb1_plan`), on the CPU.

The wrappers compute each kernel's grid, block and tile in Python and
pass them to the kernel, so these tests hold the arithmetic the kernel
is given: replaying the kernels' index formulas over the planned grid
reaches every pixel (K3) and every (pixel, channel) item (K6c) of a row
exactly once, and writes every output element of the row once; the
multiply-shift that maps a K6c item to its pixel is integer division for
every item index the wrapper admits, at every admitted C; the flow-pair
and 16-byte store decisions hold only where the addresses allow them;
the dimension limits raise.  Shapes come from meta tensors (strides and
sizes without storage), so the served 720p shapes cost nothing.
"""
import numpy as np
import pytest
import torch

from rife_tpu_torch.ops.cuda import gather_probe as cgp
from rife_tpu_torch.ops.cuda import warp_nhwc as cn


def _meta(n, h, w, c, stride=None, dtype=torch.float32, flow_stride=2):
    """An NHWC image (the first C of `stride` channels) and flow on the meta
    device: shapes and strides only."""
    img = torch.empty((n, h, w, stride or c), dtype=dtype, device="meta")[..., :c]
    flow = torch.empty((n, h, w, flow_stride), dtype=dtype, device="meta")[..., :2]
    return img, flow


# Ragged widths around the tile (1, 255-257, 511-513), one row, ragged N,
# hdv2's and hd's served K3 launches (pair, half-res frame of the
# 6-channel pair, frame), and channel counts off the served path.
_SHAPES = [(2, 3, 1, 3, None), (1, 1, 2, 3, None), (3, 1, 255, 3, None),
           (1, 2, 256, 3, None), (2, 1, 257, 3, None), (1, 1, 511, 3, None),
           (1, 1, 513, 3, None), (3, 5, 131, 3, 6), (8, 736, 1280, 3, None),
           (4, 368, 640, 3, 6), (4, 736, 1280, 3, None), (1, 2, 7, 1, None),
           (2, 3, 37, 5, None), (1, 2, 129, 16, 20), (1, 1, 70, 256, None)]
_IDS = ["x".join(map(str, s[:4])) + (f"s{s[4]}" if s[4] else "") for s in _SHAPES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,stride", _SHAPES, ids=_IDS)
def test_k3_plan_covers_every_pixel_and_output_element_once(n, h, w, c, stride, dtype):
    img, flow = _meta(n, h, w, c, stride, dtype)
    p = cn.k3_plan(img, flow, 0)
    tile, nt, ppt = p["tile_px"], p["threads"], p["ppt"]
    assert tile == nt * ppt and 1 <= nt <= 256 and tile & (tile - 1) == 0
    assert p["stage_bytes"] == tile * c * img.element_size() <= cn.K3_STAGE_BYTES
    # The kernel's pixels: x = blockIdx.x * tile + threadIdx.x + j * threads.
    bx, t, j = np.meshgrid(np.arange(p["tiles"]), np.arange(nt), np.arange(ppt), indexing="ij")
    x = (bx * tile + t + j * nt).ravel()
    assert np.array_equal(np.sort(x[x < w]), np.arange(w))
    # Each tile's span of the output row: npx * C elements from x0 * C.
    x0 = np.arange(p["tiles"]) * tile
    npx = np.minimum(tile, w - x0)
    assert (npx > 0).all() and npx.sum() == w
    starts = x0 * c
    assert np.array_equal(np.concatenate([s + np.arange(k * c) for s, k in zip(starts, npx)]),
                          np.arange(w * c))
    if p["vec_store"]:  # every tile of every row starts on 16 bytes
        rows = np.arange(n * h)[:, None] * w * c
        assert ((rows + starts[None]) * img.element_size() % 16 == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,stride", _SHAPES, ids=_IDS)
def test_cb1_plan_covers_every_item_once(n, h, w, c, stride, dtype):
    img, flow = _meta(n, h, w, c, stride, dtype)
    p = cgp.cb1_plan(img, flow, 0)
    tile, nt, m, s = p["tile_px"], p["threads"], p["m"], p["s"]
    per = 16 // img.element_size()  # items a thread takes at a time
    assert nt % 32 == 0 and nt <= cgp.CB1_MAX_THREADS and tile * c <= cgp.CB1_TILE_ITEMS
    got = []
    for bx in range(p["tiles"]):
        xb = bx * tile
        items = min(tile, w - xb) * c
        # Thread t takes l0 = t * J + k * threads * J (k = 0, 1, ...) while
        # l0 < items, and the J items l0 .. l0 + J - 1 below items.
        l0 = (np.arange(nt)[:, None] * per + np.arange(0, items, nt * per)[None]).ravel()
        l = (l0[l0 < items][:, None] + np.arange(per)[None]).ravel()
        l = np.sort(l[l < items])
        assert np.array_equal(l, np.arange(items))
        xl = (l.astype(np.uint64) * np.uint64(m)) >> np.uint64(s)
        got.append((xb + xl.astype(np.int64)) * c + (l - xl.astype(np.int64) * c))
    got = np.concatenate(got)
    assert np.array_equal(np.sort(got), np.arange(w * c))  # (pixel, channel) once each
    assert np.array_equal(got, np.arange(w * c))  # and at its own output element


def test_cb1_multiply_shift_is_division_for_every_admitted_item():
    """Every C the cb = 1 warp admits (1-256), every item index of the
    widest tile it plans for that C (narrower rows plan narrower tiles):
    (l * m) >> s == l // C, with l * m below 2^32."""
    for c in range(1, cgp.CB1_MAX_C + 1):
        img, flow = _meta(1, 1, 1 << 16, c)
        p = cgp.cb1_plan(img, flow, 0)
        assert p["tile_px"] * c <= cgp.CB1_TILE_ITEMS
        l = np.arange(p["tile_px"] * c, dtype=np.uint64)
        prod = l * np.uint64(p["m"])
        assert int(prod.max()) < 1 << 32, c
        assert np.array_equal(prod >> np.uint64(p["s"]), l // np.uint64(c)), c
        for w in (1, 3, 255, 257):  # a narrower row: a tile no wider
            assert cgp.cb1_plan(*_meta(1, 1, w, c), 0)["tile_px"] <= p["tile_px"]


def test_div_magic_finds_the_smallest_exact_shift():
    assert cgp.div_magic(1, 1000) == (1, 0)
    assert cgp.div_magic(4, 1000) == (1, 2)
    m, s = cgp.div_magic(3, 768)
    assert (m, s) == (683, 11)
    l = np.arange(768)
    assert np.array_equal((l * m) >> s, l // 3)
    assert not np.array_equal((l * m) >> (s - 1), l // 3)  # the shift below is not exact
    with pytest.raises(ValueError, match="multiply-shift"):
        cgp.div_magic(3, 1 << 31)


def test_flow_pairs_take_one_load_only_where_aligned():
    f32 = torch.zeros(2, 5, 7, 2)
    assert cn.flow_vector_loads(f32)
    assert cn.flow_vector_loads(f32.bfloat16())
    three = torch.zeros(2, 5, 7, 3)
    assert not cn.flow_vector_loads(three[..., :2])  # pixel stride 3
    four = torch.zeros(2, 5, 7, 4)
    assert cn.flow_vector_loads(four[..., 2:4])  # pixel stride 4, address +8 B
    assert not cn.flow_vector_loads(four[..., 1:3])  # address +4 B
    assert cn.flow_vector_loads(four.bfloat16()[..., 2:4])  # +4 B, a 4-byte pair
    assert not cn.flow_vector_loads(four.bfloat16()[..., 1:3])  # +2 B
    assert not cn.flow_vector_loads(torch.zeros(2 * 5 * 7 * 2 + 1)[1:].view(2, 5, 7, 2))
    odd_rows = torch.zeros(2, 5, 7 * 2 + 1)[..., :14].view(2, 5, 7, 2)  # y stride 15
    assert not cn.flow_vector_loads(odd_rows)


def test_stores_take_16_bytes_only_where_aligned():
    assert cn.vector_stores(1280, 3, 4, 256, 0)  # hdv2/hd f32 rows
    assert cn.vector_stores(640, 3, 2, 256, 0)  # hd's half-res frame, bf16
    assert not cn.vector_stores(131, 3, 4, 128, 0)  # rows 1572 bytes apart
    assert not cn.vector_stores(2, 3, 4, 2, 0)  # 24-byte rows and tiles
    assert not cn.vector_stores(1280, 3, 4, 256, 8)  # output 8 bytes off
    assert cn.vector_stores(136, 3, 2, 8, 0) and not cn.vector_stores(136, 3, 2, 4, 0)
    for plan in (cn.k3_plan, cgp.cb1_plan):
        assert plan(*_meta(8, 736, 1280, 3), 0)["vec_store"]
        assert not plan(*_meta(3, 37, 131, 3), 0)["vec_store"]
        assert plan(*_meta(8, 736, 1280, 3), 0)["flow_vec"]
        assert not plan(*_meta(8, 736, 1280, 3, flow_stride=3), 0)["flow_vec"]


@pytest.mark.parametrize("plan", [cn.k3_plan, cgp.cb1_plan], ids=["k3", "cb1"])
def test_dimension_limits_raise_with_a_message(plan):
    for shape, match in (((65536, 1, 8, 3), "grid holds N and H up to 65535"),
                         ((1, 65536, 8, 3), "grid holds N and H up to 65535"),
                         ((1, 1, 1 << 30, 3), "in-row offsets are 32-bit")):
        with pytest.raises(ValueError, match=match):
            plan(*_meta(*shape), 0)
    img = torch.empty_strided((1, 1, 1 << 20, 3), (0, 0, 1 << 12, 1), device="meta")
    with pytest.raises(ValueError, match="in-row offsets are 32-bit"):
        plan(img, torch.empty((1, 1, 1 << 20, 2), device="meta"), 0)
    assert plan(*_meta(65535, 1, 8, 3), 0)["tiles"] == 1


def test_channel_limits_raise_with_a_message():
    with pytest.raises(ValueError, match="at most 49152 bytes"):
        cn.k3_plan(*_meta(1, 1, 8, 6145), 0)
    assert cn.k3_plan(*_meta(1, 1, 8, 6144), 0)["threads"] == 1
    with pytest.raises(ValueError, match="up to 256 channels"):
        cgp.cb1_plan(*_meta(1, 1, 8, 257), 0)
