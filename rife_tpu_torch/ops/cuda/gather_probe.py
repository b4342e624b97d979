"""ctypes binding of `csrc/gather_probe.cu`, the hand-written CUDA gather
probes: the loop-carried recurrence (K6a `make`, K7 `micro`), the block
copy with a per-block source index (K6b `sel_kernel`), the per-element
tile gathers (K8 `make`) and the NHWC warp with one thread per channel
(K6c `warp_budget` at cb = 1).

Counterparts of tools/r3_exp1.py, tools/r3_exp2.py and tools/r3_exp21.py.
The library is built with nvcc at first use (`_build.py`) and loaded once
per process.  Each `launch_*` checks device, dtype, shape, contiguity and
alignment (the plain shape checks are in `ops/gather_probe.py`),
allocates the output, launches on PyTorch's current stream without
synchronising, and raises if the launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build
from rife_tpu_torch.ops.cuda import warp_nhwc as _nhwc

SOURCES = ("gather_probe",)
_IMG_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
MICRO_UNROLLS = (1, 32)  # the block form's instantiations: r3_exp1.py's loop, r3_exp2.py's
MICRO_WARP_UNROLLS = (1,)  # the warp form's
_ALIGN = 16
CB1_TILE_PX = 256  # pixels of a row per block at most
CB1_TILE_ITEMS = 32768  # a tile's (pixel, channel) items at most: the multiply-shift's domain
CB1_MAX_C = 256  # the widest image the cb = 1 warp takes (the port's widest warp)
CB1_MAX_THREADS = 256


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("gather_probe").path))
    # Pointers and the stream as c_void_p: as plain ints ctypes would pass
    # them as 32-bit values and cut them.
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.gather_probe_micro.argtypes = [vp] * 5 + [i32] * 4 + [f32] * 3 + [vp]
    lib.gather_probe_select_rows.argtypes = [vp] * 3 + [i32] * 2 + [i64, vp]
    lib.gather_probe_tile_gather.argtypes = [vp] * 3 + [i32] * 2 + [vp]
    strided = [vp] + [i64] * 3  # pointer, n/y/x strides
    for t in _IMG_TYPES.values():
        getattr(lib, f"gather_probe_warp_cb1_{t}").argtypes = \
            strided * 2 + [vp] + [i32] * 8 + [ctypes.c_uint32] + [i32] * 3 + [vp]
    for f in ("micro", "select_rows", "tile_gather", "warp_cb1_f32", "warp_cb1_bf16"):
        getattr(lib, f"gather_probe_{f}").restype = ctypes.c_int
    return lib


def _check_dense(name: str, *tensors: torch.Tensor) -> None:
    """One CUDA device, contiguous, 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} kernel needs every tensor on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} kernel takes contiguous, {_ALIGN}-byte aligned "
                             f"tensors, got strides {t.stride()} at {t.data_ptr():#x}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_micro(x, idx, idx0, w, body: int, steps: int, unroll: int, warp: bool,
                 decay: float, mix: float, gain: float) -> torch.Tensor:
    """One launch on the (8, 128) tile (shapes and dtypes checked by the
    caller): the block form, a block per group of the tile that the body's
    gathers close over (a row of 128 threads, or a warp of 4 columns or of
    32 elements), or with `warp` one warp holding the whole tile in
    registers -> acc (8, 128) f32 after steps x unroll iterations."""
    _check_dense("micro", x, idx, idx0, w)
    if unroll not in (MICRO_WARP_UNROLLS if warp else MICRO_UNROLLS):
        raise ValueError(f"micro kernel's {'warp' if warp else 'block'} form is built for "
                         f"unroll {MICRO_WARP_UNROLLS if warp else MICRO_UNROLLS}, got {unroll}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().gather_probe_micro(
            x.data_ptr(), idx.data_ptr(), idx0.data_ptr(), w.data_ptr(), out.data_ptr(),
            body, unroll, int(warp), steps, decay, mix, gain, _stream(x))
    _raise_on(err, "micro")
    return out


def launch_select_rows(x: torch.Tensor, sel: torch.Tensor, rows: int) -> torch.Tensor:
    """x (R, W) f32 in blocks of `rows` rows, sel (n,) int32 -> (n * rows,
    W) (shapes checked by the caller); the blocks' sizes a multiple of 4
    elements."""
    _check_dense("select_rows", x, sel)
    block = rows * x.shape[1]
    if block % 4 or x.numel() == 0 or sel.numel() == 0:
        raise ValueError(f"select_rows kernel copies blocks of a multiple of 4 elements, "
                         f"got {rows} x {x.shape[1]} and {sel.numel()} blocks")
    out = torch.empty((sel.numel() * rows, x.shape[1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = library().gather_probe_select_rows(
            x.data_ptr(), sel.data_ptr(), out.data_ptr(), sel.numel(), x.shape[0] // rows,
            block, _stream(x))
    _raise_on(err, "select_rows")
    return out


def launch_tile_gather(x: torch.Tensor, idx: torch.Tensor, kind: int) -> torch.Tensor:
    """x (NT, 8, 128) f32, idx (NT, 8, 128) int32 (checked by the caller)
    -> (NT, 8, 128) f32; kind 0 lane, 1 sublane, 2 bcast8."""
    _check_dense("tile_gather", x, idx)
    if x.shape[0] == 0:
        raise ValueError("tile_gather kernel cannot take 0 tiles")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = library().gather_probe_tile_gather(x.data_ptr(), idx.data_ptr(),
                                                 out.data_ptr(), x.shape[0], kind,
                                                 _stream(x))
    _raise_on(err, "tile_gather")
    return out


def div_magic(d: int, limit: int) -> tuple[int, int]:
    """(m, s) with (l * m) >> s == l // d for every 0 <= l < limit and
    l * m < 2^32, so that the kernel divides in 32-bit unsigned
    arithmetic: the smallest s for which m = ceil(2^s / d) keeps the
    error (limit - 1) * (m * d - 2^s) below 2^s (then no l < limit
    reaches the next multiple's floor) and (limit - 1) * m below 2^32."""
    for s in range(32):
        m = -(-(1 << s) // d)
        if (limit - 1) * (m * d - (1 << s)) < (1 << s) and (limit - 1) * m < 1 << 32:
            return m, s
    raise ValueError(f"no 32-bit multiply-shift divides by {d} below {limit}")


def cb1_plan(img: torch.Tensor, flow: torch.Tensor, out_ptr: int) -> dict:
    """The cb = 1 warp's launch for `img`/`flow` into a contiguous output at
    `out_ptr`: tiles of `tile_px` pixels (a power of two up to CB1_TILE_PX,
    no wider than the row's next power of two, and at most CB1_TILE_ITEMS
    items), `threads` (a multiple of 32, up to CB1_MAX_THREADS, each
    taking runs of 16 bytes of items until the tile's span ends), the
    multiply-shift (m, s) that maps a tile's item to its pixel, whether the
    flow pairs and the stores are vector accesses.  Raises on C above
    CB1_MAX_C and on what the grid cannot hold."""
    n, h, w, c = img.shape
    if c > CB1_MAX_C:
        raise ValueError(f"the cb = 1 warp takes up to {CB1_MAX_C} channels, got C = {c}")
    elem = img.element_size()
    tile = min(CB1_TILE_PX, 1 << (CB1_TILE_ITEMS // c).bit_length() - 1,
               _nhwc.pow2_ceil(w))
    _nhwc.check_extent(img, flow, tile)
    runs = -(-tile * c * elem // _ALIGN)
    m, sh = div_magic(c, tile * c)
    return {"tiles": -(-w // tile), "threads": min(CB1_MAX_THREADS, -(-runs // 32) * 32),
            "tile_px": tile, "m": m, "s": sh, "flow_vec": _nhwc.flow_vector_loads(flow),
            "vec_store": _nhwc.vector_stores(w, c, elem, tile, out_ptr)}


def launch_warp_cb1(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """As `warp_nhwc.launch_k3` (the same checks: bf16/f32, channel strides
    1, n/y/x strides read as given), each (pixel, channel) item computing
    its pixel's coordinate itself (`cb1_plan`)."""
    _nhwc._check(img, flow)
    n, h, w, c = img.shape
    out = _nhwc._out(img)
    p = cb1_plan(img, flow, out.data_ptr())
    fn = getattr(library(), f"gather_probe_warp_cb1_{_IMG_TYPES[img.dtype]}")
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), *img.stride()[:3], flow.data_ptr(), *flow.stride()[:3],
                 out.data_ptr(), n, h, w, c, int(flow.dtype == torch.bfloat16), p["tiles"],
                 p["threads"], p["tile_px"], p["m"], p["s"], int(p["flow_vec"]),
                 int(p["vec_store"]), _stream(img))
    _raise_on(err, "warp_cb1")
    return out
