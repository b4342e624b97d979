"""ctypes binding of `csrc/warp_nhwc.cu`, the hand-written CUDA NHWC warps
K3 (C < 8) and K4 (C >= 8).

Counterparts of rife_tpu/ops/pallas/warp.py (`warp_pallas`, K3) and
rife_tpu/ops/pallas/warp_v4.py (`warp_pallas_v4`, K4), and in bf16 of
`warp_pallas_v5`'s NHWC front.  The library is built with nvcc at first
use (`_build.py`) and loaded once per process.  `launch_k3` and
`launch_k4` check what they are given, allocate the output, launch on
PyTorch's current stream without synchronising, and raise if a launch was
refused.  They read the image and the flow through their strides: the
channel stride must be 1 (a channels-last tensor, or a channel slice of
one, seen as NHWC); the output is a contiguous (N, H, W, C) tensor.

K3's launch geometry is computed here (`k3_plan`), not in the kernel, so
the CPU tests hold the arithmetic the kernel is given: a grid of
(tiles, H, N) blocks, each warping `K3_PPT * threads` pixels of one row,
a thread's pixels `threads` apart.  `k3_plan` raises on a shape whose
grid or 32-bit in-row offsets the kernel cannot hold.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build

SOURCES = ("warp_nhwc",)
_IMG_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_FLOW_TYPES = (torch.bfloat16, torch.float32)
_VEC_BYTES = 16
K3_PPT = 2  # pixels per thread (csrc/warp_nhwc.cu K3_PPT)
K3_TILE_PX = 128  # pixels per block at most
K3_STAGE_BYTES = 48 * 1024  # a block's staged outputs (static shared memory's limit)
GRID_YZ = 65535  # the largest grid.y (rows) and grid.z (images)
I32 = 2 ** 31 - 1


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("warp_nhwc").path))
    strided = [ctypes.c_void_p] + [ctypes.c_int64] * 3  # pointer, n/y/x strides
    for t in _IMG_TYPES.values():
        # Pointers and the stream as c_void_p: as plain ints ctypes would
        # pass them as 32-bit values and cut them.
        f = getattr(lib, f"warp_nhwc_k3_{t}")
        f.argtypes = strided * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        f = getattr(lib, f"warp_nhwc_k4_{t}")
        f.argtypes = strided * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


def _check(img: torch.Tensor, flow: torch.Tensor) -> None:
    if img.device.type != "cuda" or flow.device != img.device:
        raise ValueError(f"NHWC warp kernel needs both tensors on one CUDA "
                         f"device, got {img.device} and {flow.device}")
    if img.dtype not in _IMG_TYPES or flow.dtype not in _FLOW_TYPES:
        raise TypeError(f"NHWC warp kernel takes bf16/f32 image and flow, got "
                        f"{img.dtype} and {flow.dtype}")
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError(f"NHWC warp kernel takes 4-d (N, H, W, C) tensors, got "
                         f"{tuple(img.shape)} and {tuple(flow.shape)}")
    n, h, w, c = img.shape
    if tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match image "
                         f"{tuple(img.shape)}")
    if img.numel() == 0:
        raise ValueError(f"NHWC warp kernel cannot take empty shape {tuple(img.shape)}")
    for name, t in (("image", img), ("flow", flow)):
        if (t.shape[3] > 1 and t.stride(3) != 1) or min(t.stride()) < 0:
            raise ValueError(f"NHWC warp kernel takes {name} tensors with channel "
                             f"stride 1 (channels-last), got strides {t.stride()}")


def _launch(kernel: str, img: torch.Tensor, flow: torch.Tensor, out: torch.Tensor,
            *extra) -> torch.Tensor:
    n, h, w, c = img.shape
    fn = getattr(library(), f"warp_nhwc_{kernel}_{_IMG_TYPES[img.dtype]}")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), *img.stride()[:3], flow.data_ptr(),
                 *flow.stride()[:3], out.data_ptr(), n, h, w, c,
                 int(flow.dtype == torch.bfloat16), *extra, stream)
    if err != 0:
        raise RuntimeError(f"warp_nhwc_{kernel} kernel launch failed: CUDA error {err}")
    return out


def _out(img: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(img.shape), dtype=img.dtype, device=img.device)


def pow2_ceil(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def check_extent(img: torch.Tensor, flow: torch.Tensor, tile_px: int) -> None:
    """Raise unless the grid (tiles, H, N) and the kernels' 32-bit offsets
    within a row hold this shape: N and H at most 65535; each row's
    offsets (image, flow, and output including a tile past its end) and
    the y strides below 2^31."""
    n, h, w, c = img.shape
    if n > GRID_YZ or h > GRID_YZ:
        raise ValueError(f"NHWC warp kernel's grid holds N and H up to {GRID_YZ}, "
                         f"got shape {tuple(img.shape)}")
    in_row = {"image": (w - 1) * img.stride(2) + c, "flow": (w - 1) * flow.stride(2) + 2,
              "output": (w + tile_px) * c, "image y stride": img.stride(1),
              "flow y stride": flow.stride(1)}
    big = {k: v for k, v in in_row.items() if v > I32}
    if big:
        raise ValueError(f"NHWC warp kernel's in-row offsets are 32-bit: {big} "
                         f"exceed 2^31 - 1 (shape {tuple(img.shape)})")


def flow_vector_loads(flow: torch.Tensor) -> bool:
    """Whether a pixel's flow pair may be read with one load of both
    values (8 bytes f32, 4 bf16): the n/y/x strides even and the address
    a multiple of the pair's size (the channel stride is 1)."""
    pair = 2 * flow.element_size()
    return all(s % 2 == 0 for s in flow.stride()[:3]) and flow.data_ptr() % pair == 0


def vector_stores(w: int, c: int, elem: int, tile_px: int, out_ptr: int) -> bool:
    """Whether a block may write its tile's span of a contiguous output
    row with 16-byte stores: every tile's start (rows w x c elements
    apart, tiles tile_px x c) a multiple of 16 bytes."""
    return ((w * c * elem) % _VEC_BYTES == 0 and (tile_px * c * elem) % _VEC_BYTES == 0
            and out_ptr % _VEC_BYTES == 0)


def k3_plan(img: torch.Tensor, flow: torch.Tensor, out_ptr: int) -> dict:
    """K3's launch for `img`/`flow` into a contiguous output at `out_ptr`:
    a tile of up to K3_TILE_PX pixels (a power of two, no wider than the
    row's next power of two, halved while its C channels would stage more
    than K3_STAGE_BYTES), `threads` = tile / K3_PPT, `tiles` per row;
    whether the flow pairs and the stores are vector accesses.  Raises on
    what the grid cannot hold."""
    n, h, w, c = img.shape
    elem = img.element_size()
    tile = min(K3_TILE_PX, max(K3_PPT, pow2_ceil(w)))
    while tile > K3_PPT and tile * c * elem > K3_STAGE_BYTES:
        tile //= 2
    if tile * c * elem > K3_STAGE_BYTES:
        raise ValueError(f"K3 stages {K3_PPT} pixels of C channels a thread in at most "
                         f"{K3_STAGE_BYTES} bytes, got C = {c}")
    check_extent(img, flow, tile)
    return {"tiles": -(-w // tile), "threads": tile // K3_PPT, "ppt": K3_PPT,
            "tile_px": tile, "stage_bytes": tile * c * elem,
            "flow_vec": flow_vector_loads(flow),
            "vec_store": vector_stores(w, c, elem, tile, out_ptr)}


def launch_k3(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) bf16/f32 image x (N, H, W, 2) bf16/f32 flow on one CUDA
    device, channel strides 1 -> (N, H, W, C) warped image in the image's
    dtype.  A block per tile of a row's pixels (`k3_plan`): meant for
    C < 8."""
    _check(img, flow)
    out = _out(img)
    p = k3_plan(img, flow, out.data_ptr())
    return _launch("k3", img, flow, out, p["tiles"], p["threads"], p["ppt"],
                   int(p["flow_vec"]), int(p["vec_store"]))


def vector_loads(img: torch.Tensor) -> bool:
    """Whether K4 may read `img` in 16-byte runs of channels: C, the n/y/x
    strides and the address all multiples of 16 bytes."""
    per = _VEC_BYTES // img.element_size()
    return (img.shape[3] % per == 0 and all(s % per == 0 for s in img.stride()[:3])
            and img.data_ptr() % _VEC_BYTES == 0)


def launch_k4(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """As `launch_k3`, for C >= 8: one thread per pixel and 16-byte run of
    channels (4 f32, 8 bf16), with 16-byte loads where `vector_loads`."""
    _check(img, flow)
    return _launch("k4", img, flow, _out(img), int(vector_loads(img)))
