"""ctypes binding of `csrc/warp_planes.cu`, the hand-written CUDA warp.

Counterpart of rife_tpu/ops/pallas/warp_v5.py (`warp_pallas_v5_pl`,
forward).  The library is built with nvcc at first use (`_build.py`) and
loaded once per process.  `launch` checks what it is given, allocates
the output, launches on PyTorch's current stream without synchronising,
and raises if the launch was refused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build

_SOURCE = "warp_planes"
_IMG_TYPES = {torch.bfloat16: "warp_planes_bf16", torch.float32: "warp_planes_f32"}
_FLOW_TYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(_SOURCE).path))
    for fn in _IMG_TYPES.values():
        f = getattr(lib, fn)
        # Pointers and the stream as c_void_p: as plain ints ctypes would
        # pass them as 32-bit values and cut them.
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


def launch(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) bf16/f32 image x (N, 2, H, W) bf16/f32 flow on one
    CUDA device -> (N, C, H, W) warped image in the image's dtype."""
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
    out = torch.empty_like(img)
    fn = getattr(library(), _IMG_TYPES[img.dtype])
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w,
                 int(flow.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"warp_planes kernel launch failed: CUDA error {err}")
    return out
