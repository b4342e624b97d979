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


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("warp_nhwc").path))
    strided = [ctypes.c_void_p] + [ctypes.c_int64] * 3  # pointer, n/y/x strides
    for t in _IMG_TYPES.values():
        # Pointers and the stream as c_void_p: as plain ints ctypes would
        # pass them as 32-bit values and cut them.
        f = getattr(lib, f"warp_nhwc_k3_{t}")
        f.argtypes = strided * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 5 \
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


def _launch(kernel: str, img: torch.Tensor, flow: torch.Tensor, *extra) -> torch.Tensor:
    n, h, w, c = img.shape
    out = torch.empty((n, h, w, c), dtype=img.dtype, device=img.device)
    fn = getattr(library(), f"warp_nhwc_{kernel}_{_IMG_TYPES[img.dtype]}")
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), *img.stride()[:3], flow.data_ptr(),
                 *flow.stride()[:3], out.data_ptr(), n, h, w, c,
                 int(flow.dtype == torch.bfloat16), *extra, stream)
    if err != 0:
        raise RuntimeError(f"warp_nhwc_{kernel} kernel launch failed: CUDA error {err}")
    return out


def launch_k3(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) bf16/f32 image x (N, H, W, 2) bf16/f32 flow on one CUDA
    device, channel strides 1 -> (N, H, W, C) warped image in the image's
    dtype.  One thread per pixel: meant for C < 8."""
    _check(img, flow)
    return _launch("k3", img, flow)


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
    return _launch("k4", img, flow, int(vector_loads(img)))
