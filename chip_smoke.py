#!/usr/bin/env python3
"""Smoke run of rife_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each timed against its own budget:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles the CUDA warp kernel for sm_90a into
   build/rife_tpu_torch/ (registers and spills from -Xptxas -v);
3. kernels: the kernel against its plain PyTorch version, on the card, at
   the shapes one forward of the main path gives it (bf16), plus one f32
   shape and a +-200 px per-8x8-block flow that leaves the frame; kernel,
   plain-version and F.grid_sample times beside the memory bound;
4. main path: InferenceEngine("rife", fast=1, bf16) with the r5 weights
   serves 3 requests of 4 pairs of 720p content (padded to 736x1280); the
   kernel must be launched 7 times per forward; the output must be finite,
   in [0, 1], >= 40 dB PSNR against the port's own f32 output, and the f32
   engine on the card must agree with the CPU path at 128x192.

Prints a `kernels` JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero, without that last line,
when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "train_log_r5", "flownet.rtpu")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TOTAL_BUDGET_S = 300
HARD_STOP_S = 900
BUDGET_S = {"device": 30, "build": 60, "kernels": 120, "main path": 150}
BATCH, FRAME_H, FRAME_W, PAN = 4, 720, 1280, 32
TIMED_LAUNCHES = 20
# One forward of the rung-1 main path at batch 4 (736x1280): each launch
# warps a batch-concatenated pair (N = 8).  (name, C, H, W, launches).
MAIN_PATH_WARPS = [
    ("level-1 pair, half res", 3, 368, 640, 1),
    ("level-1 and level-2 pairs, full res", 3, 736, 1280, 2),
    ("context level 0", 16, 368, 640, 1),
    ("context level 1", 32, 184, 320, 1),
    ("context level 2", 64, 92, 160, 1),
    ("context level 3", 128, 46, 80, 1),
]
LAUNCHES_PER_FORWARD = sum(m[-1] for m in MAIN_PATH_WARPS)


def log(*a):
    print(*a, flush=True)


class Phase:
    """Times a phase and fails it when it overruns its budget."""

    def __init__(self, name):
        self.name, self.budget = name, BUDGET_S[name]

    def __enter__(self):
        log(f"== {self.name} (budget {self.budget} s)")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        dt = time.perf_counter() - self.t0
        log(f"== {self.name}: {dt:.2f} s")
        if exc_type is None and dt > self.budget:
            raise RuntimeError(f"phase {self.name} took {dt:.1f} s, over its "
                               f"budget of {self.budget} s")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    mag = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def smooth_flow(n, h, w, amp, gen, dev, dtype):
    """Smooth flow field of about `amp` px plus a little noise."""
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    ph = torch.rand(n, 1, 1, device=dev, generator=gen) * 6.28
    dx = amp * torch.sin(yy / (0.11 * h) + ph) + 0.5 * amp * torch.cos(xx / (0.07 * w))
    dy = 0.7 * amp * torch.cos(xx / (0.13 * w) + ph) - 0.3 * amp * torch.sin(yy / (0.05 * h))
    f = torch.stack([dx, dy], 1)
    f = f + 0.25 * torch.randn(f.shape, device=dev, generator=gen)
    return f.to(dtype).contiguous()


def block_flow(n, h, w, gen, dev, dtype):
    """+-200 px, random per 8x8 block, partly out of frame."""
    blk = (torch.rand(n, 2, -(-h // 8), -(-w // 8), device=dev, generator=gen)
           * 400 - 200)
    f = blk.repeat_interleave(8, 2).repeat_interleave(8, 3)[:, :, :h, :w]
    f = f + torch.rand(f.shape, device=dev, generator=gen) * 2 - 1
    return f.to(dtype).contiguous()


def device_ms(fn, inputs) -> float:
    """Device time of one call of fn(*inputs[i]), from CUDA events around
    a captured CUDA graph of TIMED_LAUNCHES calls (no host launch cost in
    the window).  The calls cycle over `inputs`, copies that together
    exceed the 50 MB L2, so each call finds its operands in device memory
    as the main path mostly does."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in inputs[:2]:
            fn(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(TIMED_LAUNCHES):
            fn(*inputs[i % len(inputs)])
    graph.replay()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIMED_LAUNCHES


def grid_for(flow):
    """grid_sample's normalised grid (align_corners=True) for a pixel flow."""
    n, _, h, w = flow.shape
    f = flow.float()
    xs = torch.arange(w, device=f.device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=f.device, dtype=torch.float32).view(1, h, 1)
    gx = (xs + f[:, 0]) * (2.0 / max(w - 1, 1)) - 1
    gy = (ys + f[:, 1]) * (2.0 / max(h - 1, 1)) - 1
    return torch.stack([gx, gy], -1).contiguous()


def check_and_time_kernel(warp_mod, dev):
    """Phase 3: returns the per-shape records and the largest error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records, worst = [], 0.0

    def compare(img, flow, label):
        nonlocal worst
        got = warp_mod.warp_planes(img, flow)
        want = warp_mod.warp_planes_ref(img, flow)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if img.dtype == torch.float32:
            tol, ok = "1e-5 abs", bool((err <= 1e-5).all())
        else:
            tol, ok = "1 bf16 ulp", bool((err <= bf16_ulp(want)).all())
        e = float(err.max())
        worst = max(worst, e)
        log(f"  {label}: max |kernel - plain| = {e:.3g} ({tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {label}")
        return e

    for name, c, h, w, count in MAIN_PATH_WARPS:
        n = 2 * BATCH
        amp = 8.0 * w / 1280
        img = torch.rand(n, c, h, w, device=dev, generator=gen).to(torch.bfloat16)
        if c > 3:  # context features: signed, larger
            img = (torch.randn(n, c, h, w, device=dev, generator=gen) * 3).to(torch.bfloat16)
        flow = smooth_flow(n, h, w, amp, gen, dev, torch.bfloat16)
        err = compare(img, flow, f"{name} {tuple(img.shape)} bf16")
        nbytes = 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size()
        flops = 9 * img.numel()  # 6 multiplies, 3 adds per output element
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        copies = max(1, math.ceil(160e6 / nbytes))
        inputs = [(img.clone(), flow.clone()) for _ in range(copies)]
        ms = device_ms(warp_mod.warp_planes, inputs)
        plain_ms = device_ms(warp_mod.warp_planes_ref, inputs)
        lib_inputs = [(a.float(), grid_for(f)) for a, f in inputs]
        lib = lambda a, g: F.grid_sample(a, g, mode="bilinear",  # noqa: E731
                                         padding_mode="border", align_corners=True)
        lib_err = float((lib(*lib_inputs[0]) - warp_mod.warp_planes_ref(
            img.float(), flow)).abs().max())
        library_ms = device_ms(lib, lib_inputs)
        rec = {"launch": name, "img": [n, c, h, w], "dtype": "bf16",
               "launches_per_forward": count, "bytes": nbytes,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_s * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
               else "operations",
               "max_abs_err": err, "grid_sample_f32_max_abs_vs_plain": lib_err}
        records.append(rec)
        log(f"  {name}: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"grid_sample(f32) {library_ms * 1e3:.1f} us, bound {bound_s * 1e6:.1f} us "
            f"({nbytes / 1e6:.1f} MB) -> {bound_s * 1e3 / ms:.1%} of the bound")
        del inputs, lib_inputs

    n, h, w = 2 * BATCH, 368, 640
    img32 = torch.rand(n, 3, h, w, device=dev, generator=gen)
    compare(img32, smooth_flow(n, h, w, 4.0, gen, dev, torch.float32),
            f"f32 {tuple(img32.shape)}")
    big = torch.rand(n, 3, 736, 1280, device=dev, generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        compare(big.to(dtype), block_flow(n, 736, 1280, gen, dev, dtype),
                f"+-200 px 8x8-block flow {tuple(big.shape)} {dtype}")
    return records, worst


def smooth_pair(batch, h, w, shift, seed=7):
    """Textured smooth content panned by `shift` px on both axes (the
    recipe of bench.py's smooth_pair), as NHWC f32 numpy."""
    rng = np.random.default_rng(seed)
    m = max(128, shift + 32)
    base = rng.random((batch, h + 2 * m, w + 2 * m, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)
                + np.roll(base, 2, 1) + np.roll(base, 2, 2)) / 5
    a = base[:, m:m + h, m:m + w]
    b = base[:, m + shift:m + shift + h, m + shift:m + shift + w]
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def main_path(dev, warp_mod):
    from rife_tpu_torch.engine import (InferenceEngine, load_checkpoint,
                                       state_dict_from_jax)
    from rife_tpu_torch.ops import pad_to_multiple

    t0 = time.perf_counter()
    name, tree = load_checkpoint(CKPT)
    sd = state_dict_from_jax(tree)
    a, b = smooth_pair(BATCH, FRAME_H, FRAME_W, PAN)
    a, pad = pad_to_multiple(torch.from_numpy(a), 32)
    b, _ = pad_to_multiple(torch.from_numpy(b), 32)
    a, b = a.to(dev), b.to(dev)
    log(f"  weights ({name}, r5) and a {tuple(a.shape)} pair ready in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = InferenceEngine("rife", sd, compute_dtype=torch.bfloat16, fast=1,
                          device=dev)
    t0 = time.perf_counter()
    eng.warmup(tuple(a.shape))
    log(f"  warm-up request: {time.perf_counter() - t0:.2f} s")

    requests = 3
    warp_mod.warp_planes.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(requests):
        out = eng.interpolate(a, b)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / requests
    launches = warp_mod.warp_planes.launches
    log(f"  {requests} requests: {dt * 1e3:.2f} ms/request, "
        f"{BATCH / dt:.2f} interpolated frames/s; warp launches {launches}")
    if launches != LAUNCHES_PER_FORWARD * requests:
        raise AssertionError(f"expected {LAUNCHES_PER_FORWARD * requests} kernel "
                             f"launches, counted {launches}")
    if tuple(out.shape) != tuple(a.shape) or out.dtype != torch.bfloat16:
        raise AssertionError(f"output {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()) or float(out.min()) < 0 or float(out.max()) > 1:
        raise AssertionError("output not finite or outside [0, 1]")

    eng32 = InferenceEngine("rife", sd, compute_dtype=torch.float32, fast=1,
                            device=dev)
    out32 = eng32.interpolate(a, b)
    quality = psnr(pad.crop(out).float(), pad.crop(out32))
    log(f"  bf16 vs the port's own f32 (TF32 off): {quality:.2f} dB PSNR (>= 40)")
    if not quality >= 40.0:
        raise AssertionError(f"bf16 output at {quality:.2f} dB against f32")

    sa, sb = smooth_pair(2, 128, 192, 6, seed=11)
    on_card = eng32.interpolate(sa, sb).cpu()
    on_cpu = InferenceEngine("rife", sd, fast=1, device="cpu").interpolate(sa, sb)
    diff = float((on_card - on_cpu).abs().max())
    log(f"  f32 on the card vs the CPU path at 128x192: max |diff| = {diff:.3g} (<= 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError("the card's f32 result disagrees with the CPU path")
    return {"launches": launches, "ms_per_request": dt * 1e3,
            "frames_per_s": BATCH / dt, "psnr_bf16_vs_f32_db": quality,
            "f32_card_vs_cpu_max_abs": diff}


def main() -> int:
    t_start = time.perf_counter()
    signal.alarm(HARD_STOP_S)  # SIGALRM ends the run if anything hangs
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    from rife_tpu_torch.ops import warp as warp_mod
    from rife_tpu_torch.ops.cuda import _build
    from rife_tpu_torch.ops.cuda import warp as cuda_warp

    dev = torch.device("cuda", 0)
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
            f"nvidia-smi: {smi}; device count {torch.cuda.device_count()}")

    with Phase("build"):
        built = _build.build("warp_planes")
        log(f"  nvcc: {built.seconds:.2f} s -> {os.path.relpath(built.path, ROOT)}")
        for line in built.ptxas_log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                log(f"  ptxas: {line.strip()}")
        cuda_warp.library()

    with Phase("kernels"):
        records, worst = check_and_time_kernel(warp_mod, dev)

    with Phase("main path"):
        main = main_path(dev, warp_mod)

    per_fwd = lambda key: sum(r[key] * r["launches_per_forward"]  # noqa: E731
                              for r in records)
    log(json.dumps({"kernels": [{
        "name": "warp_planes", "route": "cuda",
        "source": "rife_tpu_torch/csrc/warp_planes.cu",
        "replaces": "rife_tpu/ops/pallas/warp_v5.py:337",
        "launches": main["launches"], "max_abs_err": worst,
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in records)
                     else "operations"),
        "library_ms": per_fwd("library_ms"),
        "per_launch": records, "main_path": main,
        "card": smi}]}))
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {TOTAL_BUDGET_S} s)")
    if total > TOTAL_BUDGET_S:
        raise RuntimeError(f"run took {total:.1f} s, over its budget")
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
