"""Build the port's CUDA sources with nvcc into plain-C shared libraries.

Each `csrc/<name>.cu` exposes `extern "C"` functions and is compiled by
hand (no `torch.utils.cpp_extension`, no ninja: a source without
PyTorch's headers builds in seconds) into `build/rife_tpu_torch/` at the
root of the checkout, at first use; `build_all` runs one nvcc per source
in parallel.  The file name carries a hash of the source, of the shared
headers (`csrc/*.cuh`) and of the nvcc command (compiler path and flags),
so an edited source, header or flag rebuilds and a stale library is never
loaded.  The library is written to a temporary
name and moved into place with `os.replace`, so a build cut off half way
leaves nothing that looks finished.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rife_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300


@dataclass(frozen=True)
class Built:
    """A compiled library: its path, the seconds nvcc took (0.0 when it
    was already built) and nvcc's `-Xptxas -v` report (registers, shared
    memory and spills of each kernel)."""
    path: Path
    seconds: float
    ptxas_log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build(name: str, defines: tuple = ()) -> Built:
    """Compile `csrc/<name>.cu` (if not built yet) and return the library;
    `defines` ("NAME=VALUE", ...) become -D flags of a separate build."""
    src = CSRC / f"{name}.cu"
    nvcc = _nvcc()
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join((nvcc,) + flags)
                         .encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A `lock` left by an interrupted build tool would block a later one.
    (BUILD_DIR / "lock").unlink(missing_ok=True)
    lib = BUILD_DIR / f"{name}_{key}.so"
    log = BUILD_DIR / f"{name}_{key}.ptxas.txt"
    if lib.exists():
        return Built(lib, 0.0, log.read_text() if log.exists() else "")
    tmp = BUILD_DIR / f".{name}_{key}.{os.getpid()}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return Built(lib, seconds, proc.stdout + proc.stderr)


def build_all(names) -> dict[str, Built]:
    """Build several sources at once, one nvcc process each, all started
    together; raises the first failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))
