"""Profiling: where the device time of a function goes on one CUDA card,
a torch.profiler trace around any region, and wall-clock stage timers
(port of rife_tpu/utils/profiling.py, plus the card's breakdowns).

`trace(logdir)` writes a Chrome trace of the region (host and, on a card,
device activity) into `logdir`, and does nothing when `logdir` is falsy.
`StageTimer` sums the host seconds of named stages (decode, infer,
encode).

`device_breakdown(fn, calls)` runs `fn()` `calls` times under
torch.profiler and sums the device time of every kernel, copy and memset
by class: the port's warp kernels (forward, backward), convolutions, the
layout transposes cuDNN puts around them, the optimizer's multi-tensor
kernels and the elementwise glue (everything else); the device-side
spans of user annotations are left out, as they overlap the kernels.  It
also gives the share of the profiled window in which the device ran
nothing (the profiler slows the host, so that share is an upper bound).
`graph_ms(fn, inputs, calls)` is the device time of one call of a
function by CUDA events around a captured CUDA graph.  Measured only on a
card; without one they raise.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_CONV_MARKS = ("conv", "cudnn", "xmma", "implicit", "gemm", "dgrad", "wgrad",
               "sm90_", "cutlass")
CLASSES = ("warp forward (CUDA, hand-written)", "warp backward (CUDA, hand-written)",
           "cuDNN layout transposes", "convolutions (cuDNN)", "optimizer (AdamW)",
           "glue (elementwise, concat, resizes, losses, copies)")


def classify(name: str) -> str:
    low = name.lower()
    if "warp_planes_bwd_kernel" in low:
        return CLASSES[1]
    if "warp_planes_kernel" in low or "warp_planes_flat_kernel" in low:
        return CLASSES[0]
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return CLASSES[2]
    if any(m in low for m in _CONV_MARKS):
        return CLASSES[3]
    if "multi_tensor_apply" in low or "adam" in low:
        return CLASSES[4]
    return CLASSES[5]


def graph_ms(fn, inputs, calls: int) -> float:
    """Device time of one call of fn(*inputs[i]), from CUDA events around a
    captured CUDA graph of `calls` calls cycling over `inputs` (no host
    launch cost in the window), after a warm-up outside the capture.  Give
    copies that together exceed the 50 MB L2 where the real caller finds
    its operands in device memory."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in inputs[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    graph.replay()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_breakdown(fn, calls: int = 3) -> dict:
    """Profile `calls` calls of `fn()` (already warmed up) -> {"ms_per_call":
    {class: ms}, "kernel_ms_per_call", "launches_per_call",
    "window_ms_per_call", "idle_share", "top": [[name, ms per call,
    launches per call], ...]}."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_breakdown measures a CUDA card; there is none")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_name, launches = defaultdict(float), defaultdict(int)
    for ev in prof.events():
        # Kernels, copies and memsets; not the device-side spans of user
        # annotations (such as Optimizer.step), which overlap the kernels.
        if ev.device_type == DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            by_name[ev.name] += ev.time_range.elapsed_us()
            launches[ev.name] += 1
    total = sum(by_name.values())
    if total <= 0:
        raise RuntimeError("torch.profiler reported no device time")
    by_class = dict.fromkeys(CLASSES, 0.0)
    for k, v in by_name.items():
        by_class[classify(k)] += v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"ms_per_call": {k: v / calls / 1e3 for k, v in by_class.items()},
            "kernel_ms_per_call": total / calls / 1e3,
            "launches_per_call": sum(launches.values()) / calls,
            "window_ms_per_call": window_us / calls / 1e3,
            "idle_share": max(0.0, 1 - total / window_us),
            "top": [[k[:100], v / calls / 1e3, launches[k] / calls] for k, v in top]}


@contextlib.contextmanager
def trace(logdir: str | None):
    """torch.profiler over the region, its Chrome trace written to
    `logdir/trace_<pid>_<ns>.json`; no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(self.totals[name] / max(1, self.counts[name]) * 1e3, 3),
            }
            for name in self.totals
        }
