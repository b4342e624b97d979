"""The launch geometry of the plane warp K1 (`ops/cuda/warp.py` `k1_plan`)
and of its gradient (`bwd_plan`, `tap_merges`), on the CPU.

The wrappers compute each kernel's grid, block and tile in Python and
pass them to the kernel, so these tests hold the arithmetic the kernels
are given: replaying the kernels' index formulas over the planned grid
reaches every output pixel and channel exactly once (K1, C <= 4: a
thread's run of 2 pixels of a row tile, grid (row tile, row block,
image), all channels a block; K1 on feature maps: a pixel a thread of a
256-pixel block, grid (pixel block, channel group, image); the
gradient: a thread's pixel and channel group from masks and shifts of
threadIdx.x, a warp one channel group's pixels, grid (tile column, tile
row, image)); the vector-access decisions hold only where the addresses
allow them; the plans are memoised and each call gets its own copy; the
host's replay of which pixels hand their right taps of d_img to their
right neighbour follows the taps and the tiles and equals a plain loop;
the shape limits raise.  Shapes come from meta tensors (sizes without
storage), so the served 720p shapes cost nothing; the grid factorises
into its x, y and z axes, which are replayed one by one.  No JAX, no
card.
"""
import numpy as np
import pytest
import torch

from rife_tpu_torch.ops.cuda import warp as cw


def _meta(n, c, h, w, dtype=torch.bfloat16, flow_dtype=None):
    img = torch.empty((n, c, h, w), dtype=dtype, device="meta")
    flow = torch.empty((n, 2, h, w), dtype=flow_dtype or dtype, device="meta")
    return img, flow


def _once(got, size):
    """Every index of range(size) exactly once."""
    got = np.sort(np.asarray(got).ravel())
    return np.array_equal(got, np.arange(size))


# Ragged widths around the runs and tiles (W % 8 != 0, W below a tile),
# one row, the paper model's served launches (N = 8: the half- and
# full-resolution pairs and the four context levels), v4.25's 7-channel
# rung-1 launches, the training step's launches (N = 32), many channels
# off the served path.
_SHAPES = [(1, 3, 1, 1), (2, 3, 3, 2), (1, 3, 5, 7), (3, 5, 9, 13), (2, 19, 67, 131),
           (1, 3, 2, 257), (1, 16, 3, 1029), (8, 3, 368, 640), (8, 3, 736, 1280),
           (8, 16, 368, 640), (8, 32, 184, 320), (8, 64, 92, 160), (8, 128, 46, 80),
           (8, 7, 96, 160), (8, 7, 384, 640), (8, 7, 768, 1280), (32, 3, 224, 224),
           (32, 16, 112, 112), (32, 32, 56, 56), (32, 64, 28, 28), (32, 128, 14, 14),
           (1, 300, 5, 6)]
_IDS = ["x".join(map(str, s)) for s in _SHAPES]


# The dtype pairings (image, flow) the kernel is compiled for.
_DTYPES = [(a, b) for a in (torch.bfloat16, torch.float32) for b in (torch.bfloat16, torch.float32)]
_DTYPE_IDS = [f"{str(a)[6:]}-{str(b)[6:]}" for a, b in _DTYPES]


@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("n,c,h,w", _SHAPES, ids=_IDS)
def test_k1_plan_covers_every_output_element_once(n, c, h, w, dtype, flow_dtype):
    img, flow = _meta(n, c, h, w, dtype, flow_dtype)
    p = cw.k1_plan(img, flow, 0)
    tx, ty, cg, ppt = p["tx"], p["ty"], p["cg"], p["ppt"]
    assert p["threads"] == tx * ty <= cw.K1_THREADS and p["blocks"] == p["gx"] * p["gy"] * n
    if c <= cw.K1_RUN_MAX_C:
        # x0 = (blockIdx.x * tx + threadIdx.x) * 2, pixels x0, x0 + 1;
        # y = blockIdx.y * ty + threadIdx.y; every channel.
        assert p["layout"] == "run" and ppt == cw.K1_PPT == 2
        assert tx <= cw.K1_TX_MAX and (tx <= 32 or tx % 32 == 0) and p["gx"] == p["tiles"]
        first = ((np.arange(p["gx"])[:, None] * tx + np.arange(tx)[None]) * ppt).ravel()
        x = (first[:, None] + np.arange(ppt)[None]).ravel()
        assert _once(x[x < w], w)
        y = (np.arange(p["gy"])[:, None] * ty + np.arange(ty)[None]).ravel()
        assert _once(y[y < h], h) and cg == c
        # Both addresses at 0: vector runs exactly where W is even.
        assert p["vec"] == (w % 2 == 0) and p["mode"] == (1 if w % 2 == 0 else 0)
    else:
        # p = blockIdx.x * 256 + threadIdx.x; y = p / W, x = p - y * W;
        # channels blockIdx.y * cg .. + cg - 1.
        assert (p["layout"], ppt, ty, p["vec"], p["mode"]) == ("flat", 1, 1, False, 2)
        pix = (np.arange(p["gx"])[:, None] * tx + np.arange(tx)[None]).ravel()
        pix = pix[pix // w < h]
        assert _once(pix // w * w + pix % w, h * w)
        planes = [gi * cg + k for gi in range(p["gy"]) for k in range(cg) if gi * cg + k < c]
        assert _once(planes, c) and cg == min(c, cw.K1_CG)


def test_k1_layouts_by_default():
    """The C = 3 pairs take runs of 2 on row tiles, feature maps the flat
    layout with channel groups of 16."""
    pair = cw.k1_plan(*_meta(8, 3, 736, 1280), 0)
    assert (pair["layout"], pair["ppt"], pair["gy"], pair["tiles"], pair["tx"]) == \
        ("run", 2, 736, 4, 160)
    for c, groups in ((7, 1), (16, 1), (32, 2), (128, 8)):
        p = cw.k1_plan(*_meta(8, c, 46, 80), 0)
        assert (p["layout"], p["ppt"], p["gy"], p["gx"]) == \
            ("flat", 1, groups, -(-46 * 80 // 256))


def test_k1_vector_runs_follow_alignment():
    img, flow = _meta(8, 3, 736, 1280)
    assert cw.k1_plan(img, flow, 0)["vec"]
    assert cw.k1_plan(img, flow, 4)["mode"] == 1  # RUN_VEC: 4-byte bf16 runs
    assert not cw.k1_plan(img, flow, 2)["vec"]  # output off its run
    assert cw.k1_plan(img, flow, 2)["mode"] == 0  # RUN
    f32, f32_flow = _meta(8, 3, 736, 1280, torch.float32)
    assert cw.k1_plan(f32, f32_flow, 8)["vec"]  # 8-byte f32 runs
    assert not cw.k1_plan(f32, f32_flow, 4)["vec"]
    mixed = _meta(8, 3, 736, 1280, torch.bfloat16, torch.float32)
    assert cw.k1_plan(*mixed, 4)["vec"] and not cw.k1_plan(*mixed, 2)["vec"]
    for w in (131, 1279, 1283):  # W odd: value by value
        assert not cw.k1_plan(*_meta(2, 3, 5, w), 0)["vec"]
    assert cw.k1_plan(*_meta(2, 3, 5, 1278), 0)["vec"]
    assert not cw.k1_plan(*_meta(8, 16, 368, 640), 0)["vec"]  # flat: value by value


def test_k1_flow_runs_follow_the_flow_address():
    """A contiguous flow whose storage starts off the run's bytes (a view one
    element in) takes value-by-value loads."""
    img = torch.zeros(1, 3, 4, 8, dtype=torch.bfloat16)
    buf = torch.zeros(2 * 4 * 8 + 1, dtype=torch.bfloat16)
    off = buf[1:].view(1, 2, 4, 8)
    assert off.is_contiguous()
    assert not cw.k1_plan(img, off, 0)["vec"]
    assert cw.k1_plan(img, buf[:-1].view(1, 2, 4, 8), 0)["vec"]


def test_plans_are_memoised_and_copied():
    """A call plans a shape once: the wrappers read the memoised plan, and
    each public call returns its own copy, so a caller's edit reaches no
    later launch."""
    img, flow = _meta(8, 3, 736, 1280)
    first = cw.k1_plan(img, flow, 0)
    first["gx"] = -1
    again = cw.k1_plan(img, flow, 0)
    assert again["gx"] == 4 and again is not first
    assert cw._k1_plan(img, flow, 0) is cw._k1_plan(img, flow, 64)
    assert cw._k1_plan(img, flow, 0) is not cw._k1_plan(img, flow, 2)
    b = cw.bwd_plan((32, 16, 112, 112))
    b["groups"] = 0
    assert cw.bwd_plan((32, 16, 112, 112))["groups"] > 0
    assert cw._bwd_plan_of((32, 16, 112, 112)) is cw._bwd_plan_of((32, 16, 112, 112))


@pytest.mark.parametrize("n,c,h,w", _SHAPES, ids=_IDS)
def test_bwd_plan_covers_every_pixel_and_channel_once(n, c, h, w):
    p = cw.bwd_plan((n, c, h, w))
    tx, ty, pp, groups = p["tx"], p["ty"], p["p"], p["groups"]
    assert pp == tx * ty == cw.BWD_THREADS // groups and pp == 1 << p["p_shift"]
    assert tx == 1 << p["tx_shift"] and ty & (ty - 1) == 0
    assert groups <= max(1, min(c, cw.BWD_MAX_GROUPS)) and cw.BWD_MAX_GROUPS <= 8
    t = np.arange(cw.BWD_THREADS)
    pix, gi = t & (pp - 1), t >> p["p_shift"]
    # x = (blockIdx.x << tx_shift) + (p & (tx - 1)); y = (blockIdx.y <<
    # (p_shift - tx_shift)) + (p >> tx_shift); each (x, y) of a tile once
    # per channel group.
    lx, ly = pix & (tx - 1), pix >> p["tx_shift"]
    for g in range(groups):
        assert _once((ly * tx + lx)[gi == g], pp)
    x = (np.arange(p["tiles_x"])[:, None] * tx + np.arange(tx)[None]).ravel()
    y = (np.arange(p["tiles_y"])[:, None] * ty + np.arange(ty)[None]).ravel()
    assert _once(x[x < w], w) and _once(y[y < h], h)
    assert p["blocks"] == n * p["tiles_x"] * p["tiles_y"]
    # Channels: group g sums g, g + G, g + 2G, ...; every channel once.
    chans = [ch for g in range(groups) for ch in range(g, c, groups)]
    assert _once(chans, c)
    assert p["per_thread"] == -(-c // groups) == max(len(range(g, c, groups))
                                                     for g in range(groups))
    assert set(gi) == set(range(groups))
    # A warp's 32 threads are one channel group's pixels.
    assert pp >= 32 and all(len(set(gi[w:w + 32])) == 1 for w in range(0, cw.BWD_THREADS, 32))


def test_bwd_plan_adds_groups_only_where_the_grid_is_short():
    plan = lambda *s: cw.bwd_plan(s)  # noqa: E731
    assert plan(32, 3, 224, 224)["groups"] == 1  # 6272 tiles of 32 x 8
    assert plan(32, 3, 224, 224)["tx"] == 32 and plan(32, 3, 224, 224)["ty"] == 8
    for s in _SHAPES:
        p = plan(*s)
        if p["groups"] > 1:  # one group fewer would leave the grid short
            q = cw.BWD_THREADS * 2 // p["groups"]
            tx = min(cw.BWD_TX_MAX, cw.pow2_ceil(s[3]))
            assert s[0] * -(-s[3] // tx) * -(-s[2] // (q // tx)) < cw.BWD_MIN_BLOCKS, s
    assert plan(32, 128, 14, 14)["groups"] == cw.BWD_MAX_GROUPS
    assert plan(32, 128, 14, 14)["p"] == 32


def _merges_by_loop(flow, plan):
    """Each pixel's merge of its right taps, by a plain loop over the rows."""
    n, _, h, w = flow.shape
    f = flow.float().numpy()
    gave = 0
    for i in range(n):
        for y in range(h):
            ix = np.clip(np.arange(w, dtype=np.float32) + f[i, 0, y], 0, w - 1)
            iy = np.clip(np.float32(y) + f[i, 1, y], 0, h - 1)
            x0, y0 = np.floor(ix).astype(int), np.floor(iy).astype(int)
            x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
            for x in range(w - 1):
                gave += bool(x % plan["tx"] != plan["tx"] - 1 and x1[x] == x0[x + 1]
                             and y0[x] == y0[x + 1] and y1[x] == y1[x + 1])
    return gave * plan["groups"], (n * h * w - gave) * plan["groups"]


@pytest.mark.parametrize("c", [3, 16, 128])
def test_tap_merges_follow_the_taps_and_the_tiles(c):
    """A constant fractional shift: every pixel merges its right taps into
    its right neighbour's except at a tile's last column and the image's;
    a +-200 px random flow on the right half merges almost nowhere there;
    the replay equals a plain loop over the pixels, also with jitter."""
    n, h, w = 2, 13, 136  # a ragged last tile of 8 pixels
    p = cw.bwd_plan((n, c, h, w))
    assert p["tx"] == 32
    edges = len([x for x in range(w - 1) if x % 32 == 31])
    gave = n * h * (w - 1 - edges) * p["groups"]
    assert cw.tap_merges(torch.full((n, 2, h, w), 0.25), p) == \
        (gave, n * h * w * p["groups"] - gave)
    rng = np.random.default_rng(c)
    flow = torch.from_numpy(rng.uniform(-200, 200, (n, 2, h, w)).astype(np.float32))
    flow[..., : w // 2] = 0.25
    merged, kept = cw.tap_merges(flow, p)
    assert 0 < merged < gave and merged + kept == n * h * w * p["groups"]
    assert (merged, kept) == _merges_by_loop(flow, p)
    jitter = flow + torch.from_numpy(rng.normal(0, 0.3, (n, 2, h, w)).astype(np.float32))
    assert cw.tap_merges(jitter, p) == _merges_by_loop(jitter, p)
    narrow = cw.bwd_plan((n, c, h, 12))  # tiles 16 wide, two rows a warp
    assert narrow["tx"] == 16
    assert cw.tap_merges(torch.full((n, 2, h, 12), 0.25), narrow)[0] == \
        n * h * 11 * narrow["groups"]


def test_shape_limits_raise_with_a_message():
    with pytest.raises(ValueError, match="in-plane offsets are 32-bit"):
        cw.k1_plan(*_meta(1, 3, 1 << 16, 1 << 15), 0)
    with pytest.raises(ValueError, match="in-plane offsets are 32-bit"):
        cw.bwd_plan((1, 3, 1 << 16, 1 << 15))
    cw.k1_plan(*_meta(1, 3, (1 << 16) - 1, 1 << 15), 0)  # just below 2^31
    with pytest.raises(ValueError, match="K1's grid holds"):
        cw.k1_plan(*_meta(1, 3, 1 << 20, 1024), 0)  # 2^20 row blocks of one row
    with pytest.raises(ValueError, match="K1's grid holds"):
        cw.k1_plan(*_meta(65536, 3, 2, 8), 0)
    with pytest.raises(ValueError, match="K1's grid holds"):
        cw.k1_plan(*_meta(1, 16 * 65536, 2, 8), 0)  # 65536 channel groups
    with pytest.raises(ValueError, match="grid holds N up to 65535"):
        cw.bwd_plan((65536, 3, 2, 8))
    with pytest.raises(ValueError, match="grid holds ceil"):
        cw.bwd_plan((1, 3, 1 << 22, 256))  # 2^19 row tiles of 8
    # Past 2^31 elements in all is fine: the planes' bases are 64-bit.
    assert cw.k1_plan(*_meta(760, 3, 736, 1280), 0)["blocks"] == 4 * 736 * 760
    assert 760 * 3 * 736 * 1280 > 2 ** 31
