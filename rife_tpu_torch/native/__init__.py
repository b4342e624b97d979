"""ctypes binding of the native frame ops, `native/frameops.cpp` (port of
rife_tpu/native/__init__.py), with their plain numpy versions.

The C source is built with g++ from where it is, at first use, into
`build/rife_tpu_torch/` at the root of the checkout, under a name that
carries a hash of the source, the command and the host's CPU (the build
is `-march=native`), through a temporary name and `os.replace` (test
workers build at the same time).  Where g++ is
present a failed build or load raises with the compiler's output; only a
machine without g++ runs the numpy versions.  `have_native()` says which
one runs.

The two agree bit for bit except in u8 -> f32, where the C code
multiplies by 1/255.0f and numpy divides by 255 (up to 1 ulp apart).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "frameops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rife_tpu_torch"
# rife_tpu's flags, and no contraction of a multiply and an add into an
# FMA (g++ contracts C++ by default where the host CPU has FMA): each
# operation rounds once, as the numpy versions do.  The two functions
# rife_tpu binds compute the same bits either way: u8 -> f32 is one
# multiply, and f32 -> u8 truncates s * 255 + 0.5, which the contraction
# cannot move across an integer.
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17")
_THREADS = min(8, os.cpu_count() or 1)
_STATE = {"lock": threading.Lock(), "tried": False, "lib": None}


def _build_and_load():
    """The loaded library, or None where there is no g++."""
    st = _STATE
    with st["lock"]:
        if st["tried"]:
            return st["lib"]
        cxx = shutil.which("g++")
        if cxx is not None:
            st["lib"] = _load(_build(cxx))
        st["tried"] = True
        return st["lib"]


def _host_cpu() -> bytes:
    """The CPU's model and flags: `-march=native` builds for them, so a
    library built on another host is not loaded here."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"\n".join(sorted({ln for ln in lines if ln.startswith((b"model name", b"flags"))}))


def _build(cxx: str) -> Path:
    cmd = (cxx, *CXX_FLAGS)
    key = hashlib.sha256(SRC.read_bytes() + " ".join(cmd).encode()
                         + _host_cpu()).hexdigest()[:16]
    lib = BUILD_DIR / f"libframeops_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libframeops_{key}.{os.getpid()}.{threading.get_ident()}.so"
    proc = subprocess.run([*cmd, "-o", str(tmp), str(SRC), "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.rife_u8_to_f32_pad.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    lib.rife_u8_to_f32_pad.restype = None
    lib.rife_f32_to_u8_crop.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    lib.rife_f32_to_u8_crop.restype = None
    lib.rife_yuv420_to_rgb.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.rife_yuv420_to_rgb.restype = None
    lib.rife_frameops_version.restype = ctypes.c_int
    if lib.rife_frameops_version() != 1:
        raise RuntimeError(f"{path}: frame-ops version "
                           f"{lib.rife_frameops_version()}, expected 1")
    return lib


def have_native() -> bool:
    return _build_and_load() is not None


def _hwc(a: np.ndarray, dtype) -> np.ndarray:
    if a.ndim != 3 or a.dtype != dtype:
        raise ValueError(f"expected an HWC {np.dtype(dtype)} array, got "
                         f"{a.dtype} {a.shape}")
    return np.ascontiguousarray(a)


def u8_to_f32_pad(frame_u8: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    """uint8 HWC -> float32 [0,1] zero-padded right and bottom to (pad_h,
    pad_w)."""
    src = _hwc(frame_u8, np.uint8)
    h, w, c = src.shape
    if pad_h < h or pad_w < w:
        raise ValueError(f"pad to {pad_h}x{pad_w} is smaller than {h}x{w}")
    lib = _build_and_load()
    if lib is None:
        return u8_to_f32_pad_ref(src, pad_h, pad_w)
    out = np.empty((pad_h, pad_w, c), np.float32)
    lib.rife_u8_to_f32_pad(src.ctypes.data, out.ctypes.data, h, w, c,
                           pad_h, pad_w, _THREADS)
    return out


def u8_to_f32_pad_ref(frame_u8: np.ndarray, pad_h: int, pad_w: int) -> np.ndarray:
    h, w, c = frame_u8.shape
    out = np.zeros((pad_h, pad_w, c), np.float32)
    out[:h, :w] = frame_u8.astype(np.float32) / 255.0
    return out


def u8_to_f32(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1], any leading dims over HWC (folded
    into rows: one threaded native call for a batch)."""
    shape = frames_u8.shape
    flat = np.ascontiguousarray(frames_u8).reshape(-1, shape[-2], shape[-1])
    return u8_to_f32_pad(flat, flat.shape[0], flat.shape[1]).reshape(shape)


def f32_to_u8(frames_f32: np.ndarray) -> np.ndarray:
    """float32 [0,1] -> clamped and rounded uint8, any leading dims over
    HWC."""
    shape = frames_f32.shape
    flat = np.ascontiguousarray(frames_f32, dtype=np.float32).reshape(
        -1, shape[-2], shape[-1])
    return f32_to_u8_crop(flat, flat.shape[0], flat.shape[1]).reshape(shape)


def f32_to_u8_crop(frame_f32: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    """float32 HWC [0,1] -> clamped and rounded uint8, cropped from the
    origin to (dst_h, dst_w)."""
    src = _hwc(np.asarray(frame_f32, np.float32), np.float32)
    src_h, src_w, c = src.shape
    if dst_h > src_h or dst_w > src_w:
        raise ValueError(f"crop to {dst_h}x{dst_w} is larger than {src_h}x{src_w}")
    lib = _build_and_load()
    if lib is None:
        return f32_to_u8_crop_ref(src, dst_h, dst_w)
    out = np.empty((dst_h, dst_w, c), np.uint8)
    lib.rife_f32_to_u8_crop(src.ctypes.data, out.ctypes.data, src_h, src_w,
                            dst_h, dst_w, c, _THREADS)
    return out


def f32_to_u8_crop_ref(frame_f32: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    return (np.clip(frame_f32[:dst_h, :dst_w], 0, 1) * 255.0 + 0.5).astype(np.uint8)


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planar YUV420 (BT.601 full range, skimage's yuv2rgb matrix; chroma
    replicated 2x2) -> interleaved uint8 RGB, rounded and clamped.  y is
    (H, W), u and v (H // 2, W // 2), all uint8; H and W even."""
    h, w = y.shape
    if h % 2 or w % 2 or u.shape != (h // 2, w // 2) or v.shape != u.shape \
            or not y.dtype == u.dtype == v.dtype == np.uint8:
        raise ValueError(f"expected uint8 planes (H, W) with even H, W and "
                         f"(H/2, W/2) chroma, got {y.shape} {u.shape} {v.shape}")
    lib = _build_and_load()
    if lib is None:
        return yuv420_to_rgb_ref(y, u, v)
    planes = [np.ascontiguousarray(p) for p in (y, u, v)]
    out = np.empty((h, w, 3), np.uint8)
    lib.rife_yuv420_to_rgb(*(p.ctypes.data for p in planes), out.ctypes.data, h, w)
    return out


def yuv420_to_rgb_ref(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """numpy version of `yuv420_to_rgb`: the C code's float32 operations in
    its order, each rounded once."""
    f = np.float32
    up = lambda p: np.repeat(np.repeat(p, 2, 0), 2, 1)  # noqa: E731
    Y = y.astype(f) / f(255.0)
    U = up(u).astype(f) / f(255.0) - f(0.5)
    V = up(v).astype(f) / f(255.0) - f(0.5)
    rgb = np.stack([Y + f(1.13988303) * V,
                    Y - f(0.394642334) * U - f(0.58062185) * V,
                    Y + f(2.03206185) * U], -1)
    return np.clip(rgb * f(255.0) + f(0.5), 0, 255).astype(np.uint8)
