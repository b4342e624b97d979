"""ctypes binding of `csrc/warp_blend.cu`, the hand-written CUDA fused pair
warp + sigmoid-mask blend (K2).

Counterpart of rife_tpu/ops/pallas/warp_blend.py (`warp_pair_blend_pl`).
The library is built with nvcc at first use (`_build.py`) and loaded once
per process.  `launch` checks what it is given, allocates the outputs,
launches on PyTorch's current stream without synchronising, and raises
if the launch was refused.

The launch geometry is computed here, not in the kernel, so the CPU tests
hold the arithmetic the kernel is given, once per shape and alignment
(memoised): `k2_plan`, K1's run layout (`ops/cuda/warp.py` `k1_plan`) in
blocks of 64 threads: a grid of (row tile, row block, image) blocks of
(tx, ty) threads, tx <= 32, K2_PPT consecutive pixels a thread, and
whether the flow, mask and output runs are single accesses.  The run size
and the block are the fastest measured on an H100 (PERF.md); to measure
another run size, build it as a variant (`_build.build("warp_blend",
("K2_PPT=4",))`, `tools/warp_blend.py`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build
from rife_tpu_torch.ops.cuda.warp import GRID_YZ, I32

SOURCES = ("warp_blend",)
_IMG_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SIDE_TYPES = (torch.bfloat16, torch.float32)  # flow and mask, each
K2_PPT = 2  # pixels a thread; csrc/warp_blend.cu's PPT
K2_THREADS = 64  # threads a block (the kernel takes up to 256)
K2_TX_MAX = 32  # threads along a row


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument and result types on a loaded library
    (the shipped build, or a variant)."""
    for t in _IMG_TYPES.values():
        f = getattr(lib, f"warp_blend_{t}")
        # Pointers and the stream as c_void_p (ctypes would cut plain ints).
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(_build.build("warp_blend").path)))


def _check(img0, img1, flow, mask) -> None:
    ts = (img0, img1, flow, mask)
    if img0.dtype not in _IMG_TYPES or img1.dtype != img0.dtype \
            or flow.dtype not in _SIDE_TYPES or mask.dtype not in _SIDE_TYPES:
        raise TypeError(f"warp_blend kernel takes bf16/f32 images of one dtype and "
                        f"a bf16/f32 flow and mask, got {[t.dtype for t in ts]}")
    if any(t.dim() != 4 for t in ts):
        raise ValueError(f"warp_blend kernel takes 4-d planes, got "
                         f"{[tuple(t.shape) for t in ts]}")
    n, c, h, w = img0.shape
    if tuple(img1.shape) != (n, c, h, w) or tuple(flow.shape) != (n, 4, h, w) \
            or tuple(mask.shape) != (n, 1, h, w):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]} are not "
                         f"(N, C, H, W) x2, (N, 4, H, W), (N, 1, H, W)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("warp_blend kernel takes contiguous tensors")
    if img0.numel() == 0:
        raise ValueError(f"warp_blend kernel cannot take empty shape {tuple(img0.shape)}")
    if img0.device.type != "cuda" or any(t.device != img0.device for t in ts):
        raise ValueError(f"warp_blend kernel needs all tensors on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")


def k2_plan(img: torch.Tensor, flow: torch.Tensor, mask: torch.Tensor,
            out_ptrs: tuple) -> dict:
    """K2's launch for `img` (N, C, H, W), its `flow` and `mask`, into
    contiguous outputs of the image's type at `out_ptrs` (the blend's, or
    the blend's, w0's and w1's): a grid of (gx, gy, N) blocks of (tx, ty)
    threads; gx = `tiles` row tiles of `tx` <= 32 threads (the fewest
    tiles, then the fewest idle threads), `ty` = 64 / tx rows a block (at
    most H), gy = `rows` row blocks, `ppt` consecutive pixels a thread,
    every channel; `vec`: the four flow runs, the mask run and the output
    runs as single accesses (W a multiple of ppt, the flow's, the mask's
    and every output's address on the run's bytes).  Raises on what the grid or the 32-bit in-plane
    offsets cannot hold.  A new dict each call; `launch` reads the
    memoised one."""
    return dict(_k2_plan(img, flow, mask, out_ptrs))


def on_run(ptr: int, elem: int, ppt: int = K2_PPT) -> bool:
    """Whether an address lies on a run's bytes (`ppt` values of `elem`
    bytes)."""
    return ptr % (ppt * elem) == 0


def _k2_plan(img, flow, mask, out_ptrs) -> dict:
    return _k2_plan_of(tuple(img.shape), on_run(flow.data_ptr(), flow.element_size()),
                       on_run(mask.data_ptr(), mask.element_size()),
                       all(on_run(p, img.element_size()) for p in out_ptrs))


@functools.lru_cache(maxsize=256)
def _k2_plan_of(shape: tuple, flow_on_run: bool, mask_on_run: bool,
                outs_on_run: bool) -> dict:
    """`k2_plan` by shape and by whether the flow's, the mask's and the
    outputs' addresses are multiples of a run's bytes."""
    n, c, h, w = shape
    ppt = K2_PPT
    if h * w > I32:
        raise ValueError(f"K2's in-plane offsets are 32-bit: H x W = {h * w} exceeds "
                         f"2^31 - 1 (shape {shape})")
    units = -(-w // ppt)
    tiles = -(-units // K2_TX_MAX)
    tx = -(-units // tiles)
    ty = max(1, min(K2_THREADS // tx, h))
    gy = -(-h // ty)
    if n > GRID_YZ or gy > GRID_YZ:
        raise ValueError(f"K2's grid holds N and row blocks up to {GRID_YZ}, got shape "
                         f"{shape} ({gy} row blocks of {ty})")
    vec = w % ppt == 0 and flow_on_run and mask_on_run and outs_on_run
    return {"ppt": ppt, "gx": tiles, "gy": gy, "tx": tx, "ty": ty, "tiles": tiles,
            "rows": gy, "threads": tx * ty, "blocks": tiles * gy * n, "vec": vec}


def run(img0, img1, flow, mask, outs: tuple, plan: dict, lib: ctypes.CDLL | None = None):
    """One launch of the kernel with `plan` into `outs` ((blend,) or
    (blend, w0, w1), contiguous, the images' shape and dtype), through
    `lib` (default: the shipped build); raises if it was refused."""
    n, c, h, w = img0.shape
    w0, w1 = (outs[1].data_ptr(), outs[2].data_ptr()) if len(outs) == 3 else (None, None)
    fn = getattr(lib or library(), f"warp_blend_{_IMG_TYPES[img0.dtype]}")
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img0.data_ptr(), img1.data_ptr(), flow.data_ptr(), mask.data_ptr(),
                 outs[0].data_ptr(), w0, w1, n, c, h, w,
                 int(flow.dtype == torch.bfloat16), int(mask.dtype == torch.bfloat16),
                 plan["gx"], plan["gy"], plan["tx"], plan["ty"], plan["ppt"],
                 int(plan["vec"]), stream)
    if err != 0:
        raise RuntimeError(f"warp_blend kernel launch failed: CUDA error {err}")


def launch(img0: torch.Tensor, img1: torch.Tensor, flow: torch.Tensor,
           mask: torch.Tensor, emit_pair: bool):
    """(N, C, H, W) bf16/f32 img0, img1; (N, 4, H, W) pair flow and
    (N, 1, H, W) pre-sigmoid mask, each bf16 or f32; on one CUDA device ->
    (blend, w0, w1) when emit_pair, else blend, in the images' dtype."""
    _check(img0, img1, flow, mask)
    outs = tuple(torch.empty_like(img0) for _ in range(3 if emit_pair else 1))
    run(img0, img1, flow, mask, outs,
        _k2_plan(img0, flow, mask, tuple(o.data_ptr() for o in outs)))
    return outs if emit_pair else outs[0]
