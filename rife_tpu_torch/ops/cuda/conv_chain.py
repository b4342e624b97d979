"""ctypes binding of `csrc/conv_chain.cu`, the hand-written CUDA kernel of
one stage of the IFBlock convblock chain (K5): 3x3 conv C -> C on the
zero-bordered flat layout, wgmma tensor cores fed by TMA, + bias + PReLU,
and on the last stage + x.

Counterpart of tools/r3_exp50_pallasconv.py (`pallas_core`,
`pallas_core_v2`).  The library is built with nvcc at first use
(`_build.py`) and loaded once per process.  `check` refuses what the
kernel does not take before anything is built, so it runs without a card;
`launch_stage` launches one stage on PyTorch's current stream without
synchronising and raises if the launch was refused.  `ops/conv_chain.py`
lays out the flat buffers and padded parameters and runs the stages.
`tile_product` runs one (tap, chunk) product alone, for the card's tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rife_tpu_torch.ops.cuda import _build

SOURCES = ("conv_chain",)


PROFILE_DEFINES = ("CONV_CHAIN_PROFILE=1",)
PROF_FIELDS = 13  # per block, csrc/conv_chain.cu


@functools.lru_cache(maxsize=2)
def library(profile: bool = False) -> ctypes.CDLL:
    """The built library; `profile` the separate build whose stage kernel
    records clock64 marks (`launch_stage(..., prof=...)`)."""
    lib = ctypes.CDLL(str(_build.build("conv_chain",
                                       PROFILE_DEFINES if profile else ()).path))
    # Pointers and the stream as c_void_p: as plain ints ctypes would pass
    # them as 32-bit values and cut them.
    lib.conv_chain_stage_bf16.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                                          + [ctypes.c_void_p] * 2)
    lib.conv_chain_stage_bf16.restype = ctypes.c_int
    lib.conv_chain_tile_product_bf16.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 8
        + [ctypes.c_void_p] * 2)
    lib.conv_chain_tile_product_bf16.restype = ctypes.c_int
    lib.conv_chain_stage_config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.conv_chain_stage_config.restype = ctypes.c_int
    return lib


def stage_config(bn: int) -> tuple[int, int, int]:
    """(dynamic shared memory bytes, A ring slots, B ring slots) of the
    stage kernel at wgmma width bn, as the source sizes them."""
    out = (ctypes.c_int * 3)()
    _raise_on(library().conv_chain_stage_config(bn, out),
              f"conv_chain stage config of width {bn}")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`: the persistent
    grid's limit."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _raise_on(err: int, what: str) -> None:
    if err < 0:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a tensor map "
                           f"(CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def launch_stage(src: torch.Tensor, dst: torch.Tensor, xin: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, a: torch.Tensor, geom, stage: int, last: bool,
                 prof: torch.Tensor | None = None) -> None:
    """One stage on the flat layout of `geom` (`ops.conv_chain.Geometry`):
    src and xin (rows, ld) bf16; dst the next (rows, ld) buffer, or on the
    last stage the contiguous (N, H, W, C) output; w (S, 9, np, ld) bf16,
    b and a (S, np) f32 (`kernel_params`).  dst is neither src nor xin.
    With `prof`, an int64 (grid, PROF_FIELDS) tensor, the profiled build
    runs and fills it."""
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library(prof is not None).conv_chain_stage_bf16(
            src.data_ptr(), dst.data_ptr(), xin.data_ptr(), w.data_ptr(), b.data_ptr(),
            a.data_ptr(), geom.n, geom.h, geom.w, geom.c, geom.c8, geom.ld, geom.bn, geom.np,
            w.shape[0], stage, int(last), geom.grid,
            None if prof is None else prof.data_ptr(), stream)
    _raise_on(err, "conv_chain kernel launch")


def tile_product(a: torch.Tensor, b: torch.Tensor, c8: int, bn: int, m0: int, n0: int,
                 c0: int, dr: int = 0) -> torch.Tensor:
    """The stage kernel's building blocks alone: a (rows, ld) and b
    (rows_b, ld) contiguous bf16 on the card -> (128, bn) f32
    a[m0+dr:m0+dr+128, c0:c0+64] @ b[n0:n0+bn, c0:c0+64]^T, rows outside
    either and channels at or past c8 taken as zeros, through one A box
    (136 rows at m0, the product starting dr rows into it, as a tap dx = dr
    does) and one B box of the stage kernel's TMA and its bn-wide wgmma."""
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or not a.is_contiguous()
            or not b.is_contiguous() or a.shape[1] != b.shape[1] or a.shape[1] % 64
            or a.device.type != "cuda" or b.device != a.device):
        raise ValueError("tile_product takes contiguous bf16 (rows, ld) matrices on one "
                         "CUDA device with ld a multiple of 64")
    out = torch.empty((128, bn), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().conv_chain_tile_product_bf16(
            a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0], c8, a.shape[1], bn, m0, n0,
            c0, dr, out.data_ptr(), stream)
    _raise_on(err, "conv_chain tile product")
    return out
