"""ctypes binding of `csrc/conv_chain.cu`, the hand-written CUDA kernel of
one stage of the IFBlock convblock chain (K5): 3x3 conv C -> C on tensor
cores + bias + PReLU, and on the last stage + x.

Counterpart of tools/r3_exp50_pallasconv.py (`pallas_core`,
`pallas_core_v2`).  The library is built with nvcc at first use
(`_build.py`) and loaded once per process.  `check` refuses what the
kernel does not take before anything is built, so it runs without a card;
`launch_stage` launches one stage on PyTorch's current stream without
synchronising and raises if the launch was refused.  `ops/conv_chain.py`
allocates the output and the scratch buffer and runs the stages.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build

SOURCES = ("conv_chain",)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build("conv_chain").path))
    strided = [ctypes.c_void_p] + [ctypes.c_int64] * 3  # pointer, n/y/x strides
    # Pointers and the stream as c_void_p: as plain ints ctypes would pass
    # them as 32-bit values and cut them.
    lib.conv_chain_stage_bf16.argtypes = (strided * 2 + [ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.conv_chain_stage_bf16.restype = ctypes.c_int
    return lib


def check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> None:
    """Raise unless the kernel takes these (shapes already checked by
    `ops/conv_chain.py`): bf16 x and weights, f32 biases and slopes, x's
    channel stride 1, contiguous parameters, all on one CUDA device."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv_chain kernel takes bf16 activations and weights, "
                        f"got {x.dtype} and {w.dtype}")
    if b.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"conv_chain kernel takes f32 biases and slopes, got "
                        f"{b.dtype} and {a.dtype}")
    if (x.shape[3] > 1 and x.stride(3) != 1) or min(x.stride()) < 0:
        raise ValueError(f"conv_chain kernel takes (N, H, W, C) tensors with channel "
                         f"stride 1 (channels-last), got strides {x.stride()}")
    if not all(t.is_contiguous() for t in (w, b, a)):
        raise ValueError("conv_chain kernel takes contiguous packed parameters")
    if x.numel() == 0:
        raise ValueError(f"conv_chain kernel cannot take shape {tuple(x.shape)}")
    if x.device.type != "cuda" or any(t.device != x.device for t in (w, b, a)):
        raise ValueError(f"conv_chain kernel needs every tensor on one CUDA device, "
                         f"got {x.device}, {w.device}, {b.device}, {a.device}")


def vector_width(x: torch.Tensor, w: torch.Tensor) -> int:
    """Channels per load: 8 (16 bytes) where C, x's n/y/x strides and both
    base addresses allow it, else 2 (4 bytes), else 1."""
    c = x.shape[3]
    for vec in (8, 2):
        if (c % vec == 0 and all(s % vec == 0 for s in x.stride()[:3])
                and x.data_ptr() % (2 * vec) == 0 and w.data_ptr() % (2 * vec) == 0):
            return vec
    return 1


def launch_stage(src: torch.Tensor, res: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 a: torch.Tensor, dst: torch.Tensor, vec: int, last: bool) -> None:
    """One stage: dst = PReLU(conv3x3(src, w) + b, a), rounded to bf16, and
    on the last stage + res.  src and res (N, H, W, C) with channel stride
    1; w (C, 9, C), b and a (C,); dst a contiguous (N, H, W, C) tensor that
    is neither src nor res."""
    n, h, wd, c = src.shape
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().conv_chain_stage_bf16(
            src.data_ptr(), *src.stride()[:3], res.data_ptr(), *res.stride()[:3],
            w.data_ptr(), b.data_ptr(), a.data_ptr(), dst.data_ptr(),
            n, h, wd, c, vec, int(last), stream)
    if err != 0:
        raise RuntimeError(f"conv_chain kernel launch failed: CUDA error {err}")
