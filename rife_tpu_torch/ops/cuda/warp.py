"""ctypes bindings of `csrc/warp_planes.cu` and `csrc/warp_planes_bwd.cu`,
the hand-written CUDA warp and its gradient.

Counterparts of rife_tpu/ops/pallas/warp_v5.py (`warp_pallas_v5_pl`,
forward, and with `emit_grads=True` plus rife_tpu/ops/warp.py's
`_planes_diff_bwd`, the gradient).  Each library is built with nvcc at
first use (`_build.py`) and loaded once per process.  `launch` and
`launch_bwd` check what they are given, allocate the outputs and scratch,
launch on PyTorch's current stream without synchronising, and raise if a
launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build

SOURCES = ("warp_planes", "warp_planes_bwd")
_IMG_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_FLOW_TYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("warp_planes").path))
    for t in _IMG_TYPES.values():
        f = getattr(lib, f"warp_planes_{t}")
        # Pointers and the stream as c_void_p: as plain ints ctypes would
        # pass them as 32-bit values and cut them.
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def library_bwd() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("warp_planes_bwd").path))
    for t in _IMG_TYPES.values():
        f = getattr(lib, f"warp_planes_bwd_{t}")
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.warp_planes_bwd_runs.argtypes = [ctypes.c_int]
    lib.warp_planes_bwd_runs.restype = ctypes.c_int
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


def launch(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) bf16/f32 image x (N, 2, H, W) bf16/f32 flow on one
    CUDA device -> (N, C, H, W) warped image in the image's dtype."""
    _check(img, flow)
    n, c, h, w = img.shape
    out = torch.empty_like(img)
    fn = getattr(library(), f"warp_planes_{_IMG_TYPES[img.dtype]}")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w,
                 int(flow.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"warp_planes kernel launch failed: CUDA error {err}")
    return out


def launch_bwd(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
               need_img: bool, need_flow: bool):
    """Gradient of `launch(img, flow)` for the cotangent `g` (the image's
    shape and dtype) -> (d_img or None, d_flow or None), d_img in the
    image's dtype (summed in an f32 scratch), d_flow in the flow's."""
    _check(img, flow)
    if g.shape != img.shape or g.dtype != img.dtype or g.device != img.device \
            or not g.is_contiguous():
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} {g.device} does "
                         f"not match image {tuple(img.shape)} {img.dtype} "
                         f"{img.device}, or is not contiguous")
    if not (need_img or need_flow):
        raise ValueError("warp backward asked for no gradient")
    n, c, h, w = img.shape
    lib = library_bwd()
    runs = lib.warp_planes_bwd_runs(c)  # channel runs, one partial d_flow each
    d_img = torch.zeros(img.shape, dtype=torch.float32, device=img.device) \
        if need_img else None
    part = torch.empty((n, runs, 2, h, w), dtype=torch.float32, device=img.device) \
        if need_flow else None
    d_flow = torch.empty_like(flow) if need_flow else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = getattr(lib, f"warp_planes_bwd_{_IMG_TYPES[img.dtype]}")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), flow.data_ptr(), g.data_ptr(), ptr(d_img),
                 ptr(part), ptr(d_flow), n, c, h, w,
                 int(flow.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"warp_planes_bwd kernel launch failed: CUDA error {err}")
    if d_img is not None and img.dtype != torch.float32:
        d_img = d_img.to(img.dtype)
    return d_img, d_flow
