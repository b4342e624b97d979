"""ctypes bindings of `csrc/warp_planes.cu` and `csrc/warp_planes_bwd.cu`,
the hand-written CUDA warp (K1) and its gradient.

Counterparts of rife_tpu/ops/pallas/warp_v5.py (`warp_pallas_v5_pl`,
forward, and with `emit_grads=True` plus rife_tpu/ops/warp.py's
`_planes_diff_bwd`, the gradient).  Each library is built with nvcc at
first use (`_build.py`) and loaded once per process.  `launch` and
`launch_bwd` check what they are given, allocate the outputs and scratch,
launch on PyTorch's current stream without synchronising, and raise if a
launch was refused.

Both kernels' launch geometry is computed here, not in the kernels, so
the CPU tests hold the arithmetic the kernels are given, and each is
computed once per shape and alignment (memoised), so a call plans nothing:

- `k1_plan`: for the C <= 4 frame pairs a grid of (row tile, row block,
  image) blocks of (tx, ty) threads, 2 consecutive pixels a thread, and
  whether the flow and output runs are vector accesses; for feature maps
  a grid of (256-pixel block, channel group, image), a pixel a thread.
- `bwd_plan`: 256 threads a block over a TX x TY tile of one image's
  pixels and 256 / (TX x TY) channel groups.  `tap_merges` replays, on the
  host, which pixels of a launch hand their right taps to their right
  neighbour (one reduction for two taps of d_img).

The layouts and their sizes are the fastest measured on an H100
(`tools/warp_planes.py` and PERF.md); a sweep of other choices builds
its own variant rather than ship them.  Both raise, with a message, on a
shape their grid or their 32-bit in-plane offsets cannot hold.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build

SOURCES = ("warp_planes", "warp_planes_bwd")
_IMG_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_FLOW_TYPES = (torch.bfloat16, torch.float32)
I32 = 2 ** 31 - 1
GRID_YZ = 65535  # the largest grid.y and grid.z
NUM_SMS = 132  # H100 SXM

# K1's layouts: consecutive pixels of a row tile ("run", the C <= 4 frame
# pairs), or a pixel a thread of a flat pixel block ("flat", feature maps).
K1_RUN_MAX_C = 4
K1_PPT = 2  # pixels a thread of "run"; csrc/warp_planes.cu's PPT
K1_THREADS = 256  # threads a block (at most, for "run")
K1_TX_MAX = 256  # threads along a row at most
K1_CG = 16  # channels a block of the flat layout
_K1_MODES = {"run": 0, "run_vec": 1, "flat": 2}  # csrc/warp_planes.cu RUN, RUN_VEC, FLAT

BWD_THREADS = 256
BWD_TX_MAX = 32  # tile width at most (one warp along a row)
BWD_MAX_GROUPS = 8  # tiles of 32 pixels at least: a warp holds one channel group
BWD_MIN_BLOCKS = NUM_SMS * 32  # four waves at 8 resident blocks an SM


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("warp_planes").path))
    for t in _IMG_TYPES.values():
        f = getattr(lib, f"warp_planes_{t}")
        # Pointers and the stream as c_void_p: as plain ints ctypes would
        # pass them as 32-bit values and cut them.
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library_bwd() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("warp_planes_bwd").path))
    for t in _IMG_TYPES.values():
        f = getattr(lib, f"warp_planes_bwd_{t}")
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
        f.restype = ctypes.c_int
    return lib


def _check(img: torch.Tensor, flow: torch.Tensor) -> None:
    if img.device.type != "cuda" or flow.device != img.device:
        raise ValueError(f"warp kernel needs both tensors on one CUDA device, "
                         f"got {img.device} and {flow.device}")
    if img.dtype not in _IMG_TYPES or flow.dtype not in _FLOW_TYPES:
        raise TypeError(f"warp kernel takes bf16/f32 image and flow, got "
                        f"{img.dtype} and {flow.dtype}")
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError(f"warp kernel takes 4-d planes, got {tuple(img.shape)} "
                         f"and {tuple(flow.shape)}")
    n, c, h, w = img.shape
    if tuple(flow.shape) != (n, 2, h, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image "
                         f"{tuple(img.shape)}")
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp kernel takes contiguous tensors")
    if img.numel() == 0:
        raise ValueError(f"warp kernel cannot take empty shape {tuple(img.shape)}")


def _check_plane(shape) -> None:
    n, c, h, w = shape
    if h * w > I32:
        raise ValueError(f"warp kernels' in-plane offsets are 32-bit: H x W = {h * w} "
                         f"exceeds 2^31 - 1 (shape {tuple(shape)})")


def k1_row_tiles(units: int) -> tuple[int, int]:
    """(tiles, tx) for a row of `units` threads: tx at most K1_TX_MAX and a
    multiple of 32 where it exceeds 32; the fewest idle threads, then the
    fewest tiles."""
    best = None
    for tiles in range(-(-units // K1_TX_MAX), units + 1):
        tx = -(-units // tiles)
        if tx > 32:
            tx = -(-tx // 32) * 32
        if best is None or (tiles * tx - units, tiles) < best[0]:
            best = ((tiles * tx - units, tiles), (tiles, tx))
        if tx <= 32:
            return best[1]


def k1_plan(img: torch.Tensor, flow: torch.Tensor, out_ptr: int) -> dict:
    """K1's launch for `img` (N, C, H, W) and `flow` into a contiguous output
    at `out_ptr`: a grid of (gx, gy, N) blocks of (tx, ty) threads, `ppt`
    pixels a thread, `cg` channels a block.  The C <= 4 frame pairs take
    `layout` "run": `tiles` = gx row tiles of `tx` threads (a multiple of
    32 where a row needs more), `ty` rows a block, gy = `rows` row blocks,
    2 consecutive pixels a thread, all channels; `vec`: a run's dx/dy and
    outputs as vector accesses (W even, both addresses on the run's
    bytes).  Feature maps take "flat": gx blocks of the plane's next 256
    pixels, gy channel groups of K1_CG, a pixel a thread.  Raises on what
    the grid or the 32-bit in-plane offsets cannot hold.  A new dict each
    call; `launch` reads the memoised one."""
    return dict(_k1_plan(img, flow, out_ptr))


def _k1_plan(img: torch.Tensor, flow: torch.Tensor, out_ptr: int) -> dict:
    return _k1_plan_of(tuple(img.shape), flow.data_ptr() % (K1_PPT * flow.element_size()) == 0,
                       out_ptr % (K1_PPT * img.element_size()) == 0)


@functools.lru_cache(maxsize=256)
def _k1_plan_of(shape: tuple, flow_on_run: bool, out_on_run: bool) -> dict:
    """`k1_plan` by shape and by whether the flow's and the
    output's addresses are multiples of a run's bytes."""
    n, c, h, w = shape
    layout, ppt = ("run", K1_PPT) if c <= K1_RUN_MAX_C else ("flat", 1)
    _check_plane(shape)
    if layout == "run":
        tiles, tx = k1_row_tiles(-(-w // ppt))
        ty = max(1, min(K1_THREADS // tx, h))
        gx, gy, cg = tiles, -(-h // ty), c
    else:
        tiles, tx, ty = None, K1_THREADS, 1
        gx, gy, cg = -(-(h * w) // K1_THREADS), -(-c // K1_CG), min(c, K1_CG)
    if n > GRID_YZ or gy > GRID_YZ:
        raise ValueError(f"K1's grid holds N and {'rows' if layout == 'run' else 'groups'} "
                         f"up to {GRID_YZ}, got shape {shape}")
    vec = layout == "run" and w % ppt == 0 and flow_on_run and out_on_run
    return {"layout": layout, "ppt": ppt, "gx": gx, "gy": gy, "tx": tx, "ty": ty,
            "tiles": tiles, "cg": cg, "threads": tx * ty, "blocks": gx * gy * n, "vec": vec,
            "mode": _K1_MODES["run_vec" if vec else layout]}


def launch(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) bf16/f32 image x (N, 2, H, W) bf16/f32 flow on one
    CUDA device -> (N, C, H, W) warped image in the image's dtype."""
    _check(img, flow)
    n, c, h, w = img.shape
    out = torch.empty_like(img)
    p = _k1_plan(img, flow, out.data_ptr())
    fn = getattr(library(), f"warp_planes_{_IMG_TYPES[img.dtype]}")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w,
                 int(flow.dtype == torch.bfloat16), p["gx"], p["gy"], p["tx"], p["ty"],
                 p["ppt"], p["cg"], p["mode"], stream)
    if err != 0:
        raise RuntimeError(f"warp_planes kernel launch failed: CUDA error {err}")
    return out


def pow2_ceil(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def bwd_plan(shape) -> dict:
    """The gradient kernel's launch for an (N, C, H, W) image: tiles of
    `tx` x `ty` pixels (`tx` = the row's next power of two, at most 32;
    `p` = tx x ty >= 32 pixels, so a warp holds one channel group), 256 / p
    channel groups (a power of two, at most C and BWD_MAX_GROUPS), the
    fewest that give BWD_MIN_BLOCKS blocks.  Raises on what the grid or
    the 32-bit in-plane offsets cannot hold.  A new dict each call;
    `run_bwd` reads the memoised one."""
    return dict(_bwd_plan_of(tuple(shape)))


@functools.lru_cache(maxsize=256)
def _bwd_plan_of(shape: tuple) -> dict:
    n, c, h, w = shape
    _check_plane(shape)
    if n > GRID_YZ:
        raise ValueError(f"the gradient kernel's grid holds N up to {GRID_YZ}, "
                         f"got shape {shape}")
    tx = min(BWD_TX_MAX, pow2_ceil(w))
    groups = 1
    while (groups * 2 <= min(c, BWD_MAX_GROUPS)
           and n * -(-w // tx) * -(-h // (BWD_THREADS // groups // tx)) < BWD_MIN_BLOCKS):
        groups *= 2
    p = BWD_THREADS // groups
    ty = p // tx
    tiles_y = -(-h // ty)
    if tiles_y > GRID_YZ:
        raise ValueError(f"the gradient kernel's grid holds ceil(H / {ty}) rows up to "
                         f"{GRID_YZ}, got shape {shape}")
    return {"tx": tx, "ty": ty, "p": p, "groups": groups,
            "tx_shift": tx.bit_length() - 1, "p_shift": p.bit_length() - 1,
            "per_thread": -(-c // groups), "tiles_x": -(-w // tx), "tiles_y": tiles_y,
            "blocks": n * -(-w // tx) * tiles_y}


def tap_merges(flow: torch.Tensor, plan: dict) -> tuple[int, int]:
    """The gradient kernel's merges of adjacent taps, replayed on the host
    -> (pixels whose right taps go to their right neighbour, pixels that
    add them themselves), summed over the channel groups as the kernel
    counts them: a pixel merges where its right neighbour lies in the same
    row of the same tile and taps, as its left column, this pixel's right
    column on the same two rows (the kernel's f32 coordinates)."""
    n, _, h, w = flow.shape
    f = flow.detach().float().cpu()
    xs = torch.arange(w, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32).view(1, h, 1)
    x0 = (xs + f[:, 0]).clamp(0, w - 1).floor().long()
    y0 = (ys + f[:, 1]).clamp(0, h - 1).floor().long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    same = (x1[..., :-1] == x0[..., 1:]) & (y0[..., :-1] == y0[..., 1:]) \
        & (y1[..., :-1] == y1[..., 1:])
    same &= (torch.arange(w - 1) % plan["tx"] != plan["tx"] - 1)  # not a tile's last column
    gave = int(same.sum()) * plan["groups"]
    return gave, n * h * w * plan["groups"] - gave


def run_bwd(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
            d_img: torch.Tensor | None, d_flow: torch.Tensor | None,
            merges: torch.Tensor | None = None) -> None:
    """The gradient kernel alone: adds d_img into `d_img` (a zeroed f32
    (N, C, H, W) scratch, or None) and writes `d_flow` (the flow's shape
    and dtype, or None); `merges`: None, or a 2-element int32 CUDA tensor
    that the kernel adds its `tap_merges` counts into (where d_img is
    computed)."""
    n, c, h, w = img.shape
    for name, t, dtype in (("d_img", d_img, torch.float32), ("d_flow", d_flow, flow.dtype)):
        want = img.shape if name == "d_img" else flow.shape
        if t is not None and (t.shape != want or t.dtype != dtype
                              or t.device != img.device or not t.is_contiguous()):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not "
                             f"match {tuple(want)} {dtype} {img.device}, or is not "
                             f"contiguous")
    if merges is not None and (merges.dtype != torch.int32 or merges.numel() != 2
                               or merges.device != img.device):
        raise ValueError("merges takes a 2-element int32 tensor on the image's device")
    p = _bwd_plan_of(tuple(img.shape))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(library_bwd(), f"warp_planes_bwd_{_IMG_TYPES[img.dtype]}")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), flow.data_ptr(), g.data_ptr(), ptr(d_img), ptr(d_flow),
                 n, c, h, w, int(flow.dtype == torch.bfloat16), p["tx_shift"],
                 p["p_shift"], ptr(merges), stream)
    if err != 0:
        raise RuntimeError(f"warp_planes_bwd kernel launch failed: CUDA error {err}")


def launch_bwd(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
               need_img: bool, need_flow: bool, merges: torch.Tensor | None = None):
    """Gradient of `launch(img, flow)` for the cotangent `g` (the image's
    shape and dtype) -> (d_img or None, d_flow or None), d_img in the
    image's dtype (summed in a zeroed f32 scratch, then cast), d_flow in
    the flow's.  One kernel launch; `merges` as `run_bwd`'s."""
    _check(img, flow)
    if g.shape != img.shape or g.dtype != img.dtype or g.device != img.device \
            or not g.is_contiguous():
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} {g.device} does "
                         f"not match image {tuple(img.shape)} {img.dtype} "
                         f"{img.device}, or is not contiguous")
    if not (need_img or need_flow):
        raise ValueError("warp backward asked for no gradient")
    d_img = torch.zeros(img.shape, dtype=torch.float32, device=img.device) \
        if need_img else None
    d_flow = torch.empty_like(flow) if need_flow else None
    run_bwd(img, flow, g, d_img, d_flow, merges)
    if d_img is not None and img.dtype != torch.float32:
        d_img = d_img.to(img.dtype)
    return d_img, d_flow
