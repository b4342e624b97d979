"""ctypes binding of `csrc/warp_blend.cu`, the hand-written CUDA fused pair
warp + sigmoid-mask blend.

Counterpart of rife_tpu/ops/pallas/warp_blend.py (`warp_pair_blend_pl`).
The library is built with nvcc at first use (`_build.py`) and loaded once
per process.  `launch` checks what it is given, allocates the outputs,
launches on PyTorch's current stream without synchronising, and raises
if the launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build

SOURCES = ("warp_blend",)
_IMG_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SIDE_TYPES = (torch.bfloat16, torch.float32)  # flow and mask, each


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("warp_blend").path))
    for t in _IMG_TYPES.values():
        f = getattr(lib, f"warp_blend_{t}")
        # Pointers and the stream as c_void_p (ctypes would cut plain ints).
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


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


def launch(img0: torch.Tensor, img1: torch.Tensor, flow: torch.Tensor,
           mask: torch.Tensor, emit_pair: bool):
    """(N, C, H, W) bf16/f32 img0, img1; (N, 4, H, W) pair flow and
    (N, 1, H, W) pre-sigmoid mask, each bf16 or f32; on one CUDA device ->
    (blend, w0, w1) when emit_pair, else blend, in the images' dtype."""
    _check(img0, img1, flow, mask)
    n, c, h, w = img0.shape
    outs = [torch.empty_like(img0) for _ in range(3 if emit_pair else 1)]
    w0, w1 = (outs[1].data_ptr(), outs[2].data_ptr()) if emit_pair else (None, None)
    fn = getattr(library(), f"warp_blend_{_IMG_TYPES[img0.dtype]}")
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img0.data_ptr(), img1.data_ptr(), flow.data_ptr(), mask.data_ptr(),
                 outs[0].data_ptr(), w0, w1, n, c, h, w,
                 int(flow.dtype == torch.bfloat16), int(mask.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"warp_blend kernel launch failed: CUDA error {err}")
    return tuple(outs) if emit_pair else outs[0]
