#!/usr/bin/env python3
"""Where the time of a serving request of the port goes, on one NVIDIA card.

    python3 profile_torch.py [--model rife|v4.25|hdv2|hd] [--rung 1]
                             [--dtype bfloat16|float32] [--requests 10]

Serves the chip_smoke.py workload (4 pairs of 720p content, inputs
already on the card; bf16 unless --dtype float32, which runs with TF32
off): `rife` with the r5 weights padded to 736x1280, `v4.25` with the
in-repo v4.25 weights padded to 768x1280, or a legacy model (`hdv2`,
`hd`) with chip_smoke.py's seeded weights (flow heads scaled) padded to
736x1280; rung 1 by default (the legacy models have no rungs).  Prints:

- request time from CUDA events (device) and from the host clock, with
  cudnn.benchmark off (the port's setting) and on;
- a torch.profiler breakdown of the device time of 3 requests by kernel
  and by class (the hand-written CUDA kernels, convolutions, everything
  else), and the share of the window in which the device ran no kernel.

Exits non-zero without a card.  Writes nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from collections import Counter, defaultdict

import torch

from chip_smoke import (BATCH, CKPT, CKPT_V425, FRAME_H, FRAME_W, PAN, V425_PAD,
                        legacy_state_dict, smooth_pair)

_CONV_MARKS = ("conv", "cudnn", "xmma", "implicit", "gemm", "dgrad", "wgrad",
               "sm90_", "cutlass")


def classify(name: str) -> str:
    low = name.lower()
    if "warp_planes_kernel" in low:
        return "warp kernel (CUDA, hand-written)"
    if "warp_blend_kernel" in low:
        return "fused warp + blend kernel (CUDA, hand-written)"
    if "warp_nhwc_k3_kernel" in low:
        return "NHWC warp K3 (CUDA, hand-written)"
    if "warp_nhwc_k4_kernel" in low:
        return "NHWC warp K4 (CUDA, hand-written)"
    if any(m in low for m in _CONV_MARKS):
        return "convolutions (cuDNN)"
    return "other (elementwise, concat, resizes, copies)"


def request_ms(eng, a, b, n):
    """(device ms, host ms) per request over n requests."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        eng.interpolate(a, b)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, (time.perf_counter() - t0) * 1e3 / n


@contextlib.contextmanager
def cudnn_mode(mode: str):
    """"default" (the port's setting), "search" (cudnn.benchmark over every
    algorithm cuDNN offers) or "off" (PyTorch's own convolutions)."""
    b = torch.backends.cudnn
    saved = (b.enabled, b.benchmark, b.benchmark_limit)
    b.enabled, b.benchmark = mode != "off", mode == "search"
    b.benchmark_limit = 0
    try:
        yield
    finally:
        b.enabled, b.benchmark, b.benchmark_limit = saved


def conv_table(eng, a, b) -> None:
    """Each distinct convolution of one request, timed alone (CUDA events
    over 5 calls after 2 warm-up calls, random inputs of its shape and the
    engine's dtype, TF32 off for f32): with input and weight in
    channels-last and in contiguous (NCHW) memory under the port's cuDNN
    settings, and channels-last with cuDNN searching every algorithm
    (cudnn.benchmark) and with cuDNN off: which layout and which choice of
    algorithm serve each layer better."""
    import torch.nn.functional as F

    from rife_tpu_torch.engine.inference import full_f32

    orig = {"conv2d": F.conv2d, "conv_transpose2d": F.conv_transpose2d}
    seen = Counter()

    def recorder(name):
        def call(x, w, bias=None, stride=1, padding=0, **kw):
            seen[(name, tuple(x.shape), tuple(w.shape), bias is not None, stride,
                  padding)] += 1
            return orig[name](x, w, bias, stride, padding, **kw)
        return call

    F.conv2d, F.conv_transpose2d = recorder("conv2d"), recorder("conv_transpose2d")
    try:
        eng.interpolate(a, b)
    finally:
        F.conv2d, F.conv_transpose2d = orig["conv2d"], orig["conv_transpose2d"]
    dtype, rows = eng.compute_dtype, []
    for (name, xs, ws, has_bias, stride, padding), n in seen.items():
        x = torch.randn(xs, device=a.device, dtype=dtype)
        w = torch.randn(ws, device=a.device, dtype=dtype) * 0.05
        bias = torch.zeros(ws[1] if name == "conv_transpose2d" else ws[0], device=a.device,
                           dtype=dtype) if has_bias else None
        ms = []
        for fmt, mode in ((torch.channels_last, "default"), (torch.contiguous_format, "default"),
                          (torch.channels_last, "search"), (torch.channels_last, "off")):
            xf, wf = x.contiguous(memory_format=fmt), w.contiguous(memory_format=fmt)
            with (full_f32() if dtype == torch.float32 else contextlib.nullcontext()), \
                    cudnn_mode(mode):
                for _ in range(2):
                    orig[name](xf, wf, bias, stride, padding)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    orig[name](xf, wf, bias, stride, padding)
                end.record()
                end.synchronize()
            ms.append(start.elapsed_time(end) / 5)
        rows.append((n * ms[0], n, name, xs, ws, stride, ms))
    rows.sort(reverse=True)
    total = [sum(r[1] * r[6][i] for r in rows) for i in range(4)]
    cols = "channels-last, NCHW, channels-last searched, cuDNN off"
    print(f"\n{len(rows)} distinct convolutions, {sum(r[1] for r in rows)} per request, "
          f"ms per request each timed alone ({cols}): "
          + ", ".join(f"{t:.3f}" for t in total))
    for _, n, name, xs, ws, stride, t in rows:
        print(f"  {n:3d}x {name:16s} x{list(xs)} w{list(ws)} s{stride}: "
              + " ".join(f"{v:9.3f}" for v in t) + f" ms ({cols})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("rife", "v4.25", "hdv2", "hd"), default="rife")
    ap.add_argument("--rung", type=int, default=1)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--convs", action="store_true",
                    help="only time each distinct convolution in both layouts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
    from rife_tpu_torch.ops import pad_to_multiple

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    if args.model in ("hdv2", "hd"):
        sd, pad = legacy_state_dict(args.model), 32
    else:
        ckpt, pad = (CKPT, 32) if args.model == "rife" else (CKPT_V425, V425_PAD)
        sd = state_dict_from_jax(load_checkpoint(ckpt)[1])
    a, b = smooth_pair(BATCH, FRAME_H, FRAME_W, PAN)
    a = pad_to_multiple(torch.from_numpy(a), pad)[0].cuda()
    b = pad_to_multiple(torch.from_numpy(b), pad)[0].cuda()
    dtype = getattr(torch, args.dtype)
    eng = InferenceEngine(args.model, sd, compute_dtype=dtype, fast=args.rung)
    print(f"{args.model} rung {args.rung}, {tuple(a.shape)} {args.dtype}", flush=True)
    if args.convs:
        conv_table(eng, a, b)
        return 0

    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for _ in range(2):
            eng.interpolate(a, b)  # warm-up (and cuDNN's search when on)
        dev_ms, host_ms = request_ms(eng, a, b, args.requests)
        print(f"cudnn.benchmark={bench}: {dev_ms:.3f} ms/request on the device "
              f"(CUDA events), {host_ms:.3f} ms/request on the host clock, "
              f"{BATCH * 1e3 / dev_ms:.2f} frames/s, over {args.requests} requests",
              flush=True)
    torch.backends.cudnn.benchmark = False
    eng.interpolate(a, b)
    dev_ms, _ = request_ms(eng, a, b, args.requests)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.interpolate(a, b)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_name, by_class, calls = defaultdict(float), defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:  # kernels, copies, memsets
            by_name[ev.name] += ev.time_range.elapsed_us()
            calls[ev.name] += 1
    total = sum(by_name.values())
    if total <= 0:
        print("torch.profiler reported no device time", flush=True)
        return 1
    for k, v in by_name.items():
        by_class[classify(k)] += v
    print(f"\nprofiled 3 requests: {total / 3e3:.3f} ms of kernel time per request; "
          f"window {window_us / 3e3:.3f} ms per request; device idle "
          f"{max(0.0, 1 - total / window_us):.1%} of the profiled window, "
          f"{max(0.0, 1 - total / 3e3 / dev_ms):.1%} of the unprofiled request "
          f"({dev_ms:.3f} ms by CUDA events)")
    for k, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {v / 3e3:8.3f} ms/request  {v / total:6.1%}  {k}")
    print("\ntop kernels (device time per request, launches per request):")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {v / 3e3:8.3f} ms  {calls[k] / 3:6.1f}  {k[:110]}")
    print(f"peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
