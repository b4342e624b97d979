#!/usr/bin/env python3
"""Smoke run of rife_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each timed against its own budget:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles the two CUDA sources for sm_90a, the warp and its
   gradient, one process each in parallel, into build/rife_tpu_torch/
   (registers and spills from -Xptxas -v);
3. kernels: the warp kernel against its plain PyTorch version, on the
   card, at the shapes one forward of the main path gives it (bf16), plus
   one f32 shape and a +-200 px per-8x8-block flow that leaves the frame;
   kernel, plain-version and F.grid_sample times beside the memory bound;
4. main path: InferenceEngine("rife", fast=1, bf16) with the r5 weights
   serves 3 requests of 4 pairs of 720p content (padded to 736x1280); the
   kernel must be launched 7 times per forward and the gradient kernel
   never; the output must be finite, in [0, 1], >= 40 dB PSNR against the
   port's own f32 output, and the f32 engine on the card must agree with
   the CPU path at 128x192;
5. train: the gradient kernel against its plain version at the 8 warp
   shapes of one training step (batch 16, 224x224 crops, N = 32) in bf16,
   once in f32 and once with the +-200 px block flow, timed beside its
   bytes bound, the plain version and grid_sampler_2d_backward; then the
   training path: the r5 run resumed (params, AdamW state, step 16000)
   trains one warm-up and 10 timed bf16 steps on SyntheticTriplets
   (ms/step, samples/s; 8 forward and 8 backward warp launches per step;
   finite losses; every parameter moves), a profiled device-time
   breakdown of a step, the bf16 step's gradients against the f32 step's
   (cosine >= 0.99 per block), one f32 step on the card against the CPU
   path at 2x64x64 (loss <= 1e-4 relative, gradients <= 1e-3 relative
   norm per parameter), and from a random init at lr 2e-4 30 steps whose
   loss must fall below its start and 20 steps on one fixed batch whose
   loss must fall by 10%.

Prints a `kernels` JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero, without that last line,
when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import contextlib
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
TOTAL_BUDGET_S = 600
HARD_STOP_S = 1100
BUDGET_S = {"device": 30, "build": 60, "kernels": 120, "main path": 150,
            "train": 300}
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
# One bf16 training step at batch 16 on 224x224 crops: 8 warps, each a
# batch-concatenated pair (N = 32) of bf16 planes, each with a backward
# launch.  The teacher's flow is f32 (ifnet.py sums it in f32); the
# others are bf16.  d_img is needed only where the warped tensor has a
# gradient (the context features).  The warm-up step checks that these
# are the launches the step makes.
# (name, C, H, W, launches, flow dtype, need_img).
TRAIN_BATCH, TRAIN_CROP = 16, 224
TRAIN_STEP_WARPS = [
    ("level 0-2 pairs", 3, 224, 224, 3, torch.bfloat16, False),
    ("teacher pair", 3, 224, 224, 1, torch.float32, False),
    ("context level 0", 16, 112, 112, 1, torch.bfloat16, True),
    ("context level 1", 32, 56, 56, 1, torch.bfloat16, True),
    ("context level 2", 64, 28, 28, 1, torch.bfloat16, True),
    ("context level 3", 128, 14, 14, 1, torch.bfloat16, True),
]
LAUNCHES_PER_STEP = sum(m[4] for m in TRAIN_STEP_WARPS)
TRAIN_TIMED_STEPS = 10
R5_STEPS = 16000  # the r5 run's length, its cosine horizon
SMOKE_DTYPE = torch.bfloat16


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


def check_fwd(warp_mod, img, flow, label) -> float:
    """The warp kernel against its plain version on one input: within
    1e-5 for an f32 image, 1 bf16 ulp for a bf16 one (the same f32 blend,
    rounded once).  Returns the largest error."""
    got = warp_mod.warp_planes(img, flow)
    want = warp_mod.warp_planes_ref(img, flow)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if img.dtype == torch.float32:
        tol, ok = "1e-5 abs", bool((err <= 1e-5).all())
    else:
        tol, ok = "1 bf16 ulp", bool((err <= bf16_ulp(want)).all())
    e = float(err.max())
    log(f"  {label}: max |kernel - plain| = {e:.3g} ({tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return e


def dtypes_label(img, flow) -> str:
    name = lambda t: str(t.dtype).replace("torch.", "")  # noqa: E731
    return name(img) if img.dtype == flow.dtype else f"{name(img)} ({name(flow)} flow)"


def check_and_time_kernel(warp_mod, dev):
    """Phase 3: returns the per-shape records and the largest error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records, worst = [], 0.0

    def compare(img, flow, label):
        nonlocal worst
        e = check_fwd(warp_mod, img, flow, label)
        worst = max(worst, e)
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


def check_and_time_bwd_kernel(warp_mod, dev):
    """Both kernels against their plain versions at the 8 launches of one
    bf16 training step (batch TRAIN_BATCH, crop TRAIN_CROP), with the
    image and flow dtypes the step passes; the backward also once in f32
    and with a +-200 px per-8x8-block flow in each dtype pairing; and the
    backward's time beside its bytes bound, the plain version's and
    grid_sampler_2d_backward's.  Returns the per-shape records, the
    backward's largest error and the forward's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    records, worst, worst_fwd = [], 0.0, 0.0

    def compare(img, flow, g, need_img, label):
        nonlocal worst
        got = warp_mod.warp_planes_bwd(img, flow, g, need_img, True)
        want32 = warp_mod.warp_planes_bwd_ref(img.float(), flow.float(), g.float(),
                                              need_img, True)
        mags = warp_mod._bwd_term_scale(img, flow, g)
        torch.cuda.synchronize()
        errs = []
        for name, k, w32, mag in zip(("d_img", "d_flow"), got, want32, mags):
            if w32 is None:
                if k is not None:
                    raise AssertionError(f"{label}: {name} computed though not asked for")
                continue
            err = (k.float() - w32).abs()
            # f32: the summation order (channels, atomics) moves a result by
            # at most ~1e-7 of the sum of its terms' magnitudes; 1e-5 of it
            # is the bound.  bf16: one rounding of the f32 sum, 1 bf16 ulp,
            # plus that order term.
            lim = 1e-5 * mag
            if k.dtype == torch.bfloat16:
                lim = lim + bf16_ulp(w32)
            if k.dtype != (img.dtype if name == "d_img" else flow.dtype):
                raise AssertionError(f"{label}: {name} is {k.dtype}")
            if not bool((err <= lim).all()):
                raise AssertionError(
                    f"backward kernel disagrees with its plain version: {label} "
                    f"{name}, max |diff| {float(err.max()):.3g}, worst excess "
                    f"{float((err - lim).max()):.3g}")
            errs.append(float(err.max()))
            worst = max(worst, errs[-1])
        tol = "1e-5 x sum|terms|, + 1 bf16 ulp for a bf16 result"
        log(f"  {label}: backward max |kernel - plain| = {max(errs):.3g} ({tol}) ok")
        return max(errs)

    def inputs_for(n, c, h, w, dtype, flow):
        img = torch.rand(n, c, h, w, device=dev, generator=gen)
        if c > 3:  # context features: signed, larger
            img = torch.randn(n, c, h, w, device=dev, generator=gen) * 3
        g = torch.randn(n, c, h, w, device=dev, generator=gen) * 1e-3
        return img.to(dtype), flow, g.to(dtype)

    n = 2 * TRAIN_BATCH
    for name, c, h, w, count, flow_dtype, need_img in TRAIN_STEP_WARPS:
        flow = smooth_flow(n, h, w, 8.0 * w / TRAIN_CROP, gen, dev, flow_dtype)
        img, flow, g = inputs_for(n, c, h, w, torch.bfloat16, flow)
        label = f"{name} {tuple(img.shape)} {dtypes_label(img, flow)}"
        worst_fwd = max(worst_fwd, check_fwd(warp_mod, img, flow, label + " forward"))
        err = compare(img, flow, g, need_img, label)
        esz = img.element_size()
        nbytes = (2 * img.numel() * esz + 2 * flow.numel() * flow.element_size()
                  + (img.numel() * esz if need_img else 0))
        # d_flow: 2 x 12 flops, d_img: 4 x 2 flops, per element of g.
        flops = (24 + (8 if need_img else 0)) * img.numel()
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        copies = max(1, math.ceil(160e6 / nbytes))
        inputs = [(img.clone(), flow.clone(), g.clone(), need_img, True)
                  for _ in range(copies)]
        ms = device_ms(warp_mod.warp_planes_bwd, inputs)
        plain_ms = device_ms(warp_mod.warp_planes_bwd_ref, inputs)
        mask = [need_img, True]
        lib_inputs = [(b.float(), a.float(), grid_for(f), 0, 1, True, mask)
                      for a, f, b, _, _ in inputs]
        library_ms = device_ms(torch.ops.aten.grid_sampler_2d_backward, lib_inputs)
        records.append({
            "launch": name, "img": [n, c, h, w], "dtype": "bf16",
            "flow_dtype": str(flow_dtype).replace("torch.", ""), "need_img": need_img, "launches_per_step": count, "bytes": nbytes,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
            else "operations", "max_abs_err": err})
        log(f"  {name}: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"grid_sampler_2d_backward(f32) {library_ms * 1e3:.1f} us, bound "
            f"{bound_s * 1e6:.1f} us ({nbytes / 1e6:.1f} MB) -> "
            f"{bound_s * 1e3 / ms:.1%} of the bound")
        del inputs, lib_inputs

    c, h, w = 16, TRAIN_CROP // 2, TRAIN_CROP // 2
    f32 = inputs_for(n, c, h, w, torch.float32,
                     smooth_flow(n, h, w, 4.0, gen, dev, torch.float32))
    compare(*f32, True, f"f32 {tuple(f32[0].shape)}")
    h = w = TRAIN_CROP
    for dtype, flow_dtype in ((torch.bfloat16, torch.bfloat16),
                              (torch.float32, torch.float32),
                              (torch.bfloat16, torch.float32)):
        big = inputs_for(n, 3, h, w, dtype, block_flow(n, h, w, gen, dev, flow_dtype))
        compare(*big, True, f"+-200 px 8x8-block flow {tuple(big[0].shape)} "
                f"{dtypes_label(big[0], big[1])}")
    return records, worst, worst_fwd


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
    warp_mod.warp_planes.launches = warp_mod.warp_planes_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(requests):
        out = eng.interpolate(a, b)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / requests
    launches = warp_mod.warp_planes.launches
    bwd_launches = warp_mod.warp_planes_bwd.launches
    log(f"  {requests} requests: {dt * 1e3:.2f} ms/request, "
        f"{BATCH / dt:.2f} interpolated frames/s; warp launches {launches}")
    if launches != LAUNCHES_PER_FORWARD * requests or bwd_launches:
        raise AssertionError(f"expected {LAUNCHES_PER_FORWARD * requests} kernel "
                             f"launches and no backward, counted {launches} and "
                             f"{bwd_launches}")
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
    return {"launches": launches, "bwd_launches": bwd_launches,
            "ms_per_request": dt * 1e3,
            "frames_per_s": BATCH / dt, "psnr_bf16_vs_f32_db": quality,
            "f32_card_vs_cpu_max_abs": diff}


def _grads(model) -> dict:
    return {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}


def grad_cosines(model, batch, model_def) -> dict:
    """Cosine of the bf16 step's gradient with the f32 step's, per block
    (each block's parameters flattened into one vector), in f64."""
    from rife_tpu_torch.engine.inference import full_f32
    from rife_tpu_torch.train import loss_fn

    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        model.zero_grad(set_to_none=True)
        with full_f32():
            loss, _ = loss_fn(model, batch, model_def, dtype)
            loss.backward()
        grads[dtype] = _grads(model)
    model.zero_grad(set_to_none=True)
    cos = {}
    for block in ("block0", "block1", "block2", "block_tea", "contextnet", "unet"):
        a, b = (torch.cat([g[k].flatten() for k in g if k.startswith(block + ".")])
                .double() for g in (grads[torch.bfloat16], grads[torch.float32]))
        cos[block] = float(torch.dot(a, b) / (a.norm() * b.norm()))
    return cos


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@contextlib.contextmanager
def recorded_launches(cuda_warp):
    """Inside: every launch of either kernel also records (N, C, H, W,
    image dtype, flow dtype, need_img) in the yielded lists, "fwd" and "bwd"
    (need_img None for a forward)."""
    seen = {"fwd": [], "bwd": []}
    launch, launch_bwd = cuda_warp.launch, cuda_warp.launch_bwd

    def key(img, flow, need_img=None):
        return (*img.shape, img.dtype, flow.dtype, need_img)

    def fwd(img, flow):
        seen["fwd"].append(key(img, flow))
        return launch(img, flow)

    def bwd(img, flow, g, need_img, need_flow):
        seen["bwd"].append(key(img, flow, need_img))
        return launch_bwd(img, flow, g, need_img, need_flow)

    cuda_warp.launch, cuda_warp.launch_bwd = fwd, bwd
    try:
        yield seen
    finally:
        cuda_warp.launch, cuda_warp.launch_bwd = launch, launch_bwd


def train_path(dev, warp_mod, cuda_warp):
    """Phase 5: training through both kernels (see the module docstring).
    Returns the records of the run."""
    from rife_tpu_torch.data import SyntheticTriplets, batch_iterator
    from rife_tpu_torch.engine import load_checkpoint, state_dict_from_jax
    from rife_tpu_torch.engine.inference import full_f32
    from rife_tpu_torch.models import get_model_def
    from rife_tpu_torch.train import (loss_fn, restore_checkpoint, train_init,
                                      train_step)
    from rife_tpu_torch.utils.profiling import device_breakdown

    model_def = get_model_def("rife")
    rec = {}
    # (d) Resume the r5 run (16000 steps, its cosine horizon) and train on.
    t0 = time.perf_counter()
    state = train_init(model_def, total_steps=R5_STEPS,
                       world_scale=TRAIN_BATCH / 64.0, device=dev)
    restore_checkpoint(state, CKPT)
    ds = SyntheticTriplets(n=4 * TRAIN_BATCH, h=TRAIN_CROP + 8, w=TRAIN_CROP + 8)
    it = batch_iterator(ds, TRAIN_BATCH, crop=TRAIN_CROP)
    batches = [next(it) for _ in range(TRAIN_TIMED_STEPS + 1)]
    log(f"  r5 state (step {state.step}) and {len(batches)} batches of "
        f"{TRAIN_BATCH}x{TRAIN_CROP}x{TRAIN_CROP} ready in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with recorded_launches(cuda_warp) as seen:
        train_step(state, batches[0], torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  warm-up step: {time.perf_counter() - t0:.2f} s")
    # The kernels' checks above covered exactly the launches a step makes.
    bwd = sorted([(2 * TRAIN_BATCH, c, h, w, torch.bfloat16, fd, ni)
                  for _, c, h, w, k, fd, ni in TRAIN_STEP_WARPS for _ in range(k)], key=str)
    want = {"fwd": sorted([x[:6] + (None,) for x in bwd], key=str), "bwd": bwd}
    for kind in want:
        if sorted(seen[kind], key=str) != want[kind]:
            raise AssertionError(f"the step's {kind} launches {seen[kind]} are not "
                                 f"the checked {want[kind]}")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    warp_mod.warp_planes.launches = warp_mod.warp_planes_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(state, b, torch.bfloat16)["loss"] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    fwd, bwd = warp_mod.warp_planes.launches, warp_mod.warp_planes_bwd.launches
    losses = [float(x) for x in losses]
    log(f"  {TRAIN_TIMED_STEPS} bf16 steps: {dt * 1e3:.2f} ms/step, "
        f"{TRAIN_BATCH / dt:.2f} samples/s; warp launches {fwd} forward, "
        f"{bwd} backward; losses {losses[0]:.5f} .. {losses[-1]:.5f}")
    want = LAUNCHES_PER_STEP * TRAIN_TIMED_STEPS
    if fwd != want or bwd != want:
        raise AssertionError(f"expected {want} forward and {want} backward launches, "
                             f"counted {fwd} and {bwd}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    still = [k for k, v in state.model.state_dict().items() if torch.equal(v, before[k])]
    if still:
        raise AssertionError(f"{len(still)} parameters did not move, e.g. {still[:3]}")
    rec.update(ms_per_step=dt * 1e3, samples_per_s=TRAIN_BATCH / dt,
               fwd_launches=fwd, bwd_launches=bwd, losses=losses)
    del before

    prof = device_breakdown(lambda: train_step(state, batches[1], torch.bfloat16),
                            calls=3)
    idle = max(0.0, 1 - prof["kernel_ms_per_call"] / rec["ms_per_step"])
    log(f"  device time of one bf16 step: {prof['kernel_ms_per_call']:.3f} ms in "
        f"{prof['launches_per_call']:.0f} kernels, copies and memsets; idle "
        f"{idle:.1%} of an unprofiled step, {prof['idle_share']:.1%} of the profiled window "
        f"({prof['window_ms_per_call']:.3f} ms)")
    for k, v in sorted(prof["ms_per_call"].items(), key=lambda kv: -kv[1]):
        log(f"    {v:8.3f} ms  {v / prof['kernel_ms_per_call']:6.1%}  {k}")
    for name, ms, n in prof["top"][:8]:
        log(f"    top: {ms:8.3f} ms  {n:5.1f}x  {name}")
    rec["breakdown"] = {**prof, "idle_share_unprofiled": idle}

    # (f) The bf16 step's gradients against the port's own f32 step's, on
    # one batch of the run: asserted from a random init (seed 0), where the
    # gradients are far above bf16's rounding; at the converged r5 weights
    # the f32 gradient is near that floor (bf16 alone moves the loss there
    # by ~15% on the CPU at 4x128x128), so its cosines are only reported.
    cos_r5 = grad_cosines(state.model, batches[1], model_def)
    del state
    fresh = train_init(model_def, total_steps=R5_STEPS, seed=0, device=dev)
    cos = grad_cosines(fresh.model, batches[1], model_def)
    del fresh
    fmt = lambda c: ", ".join(f"{k} {v:.5f}" for k, v in c.items())  # noqa: E731
    log(f"  bf16 vs f32 gradient cosine per block, random init (>= 0.99): {fmt(cos)}")
    log(f"  the same at the r5 weights (reported only): {fmt(cos_r5)}")
    if not all(v >= 0.99 for v in cos.values()):
        raise AssertionError(f"bf16 gradients stray from f32: {cos}")
    rec["grad_cosine_bf16_vs_f32"] = {"random_init": cos, "r5": cos_r5}

    # (e) One f32 step on the card against the CPU path, 2x64x64.
    small = next(batch_iterator(SyntheticTriplets(n=4, h=72, w=72, seed=3), 2,
                                seed=3, crop=64))
    sd = state_dict_from_jax(load_checkpoint(CKPT)[1])

    def f32_step(where):
        st = train_init(model_def, total_steps=R5_STEPS, params=sd, device=where)
        with full_f32():
            loss, _ = loss_fn(st.model, small, model_def, torch.float32)
            loss.backward()
        return loss.item(), {k: v.cpu() for k, v in _grads(st.model).items()}

    (lc, gc), (lh, gh) = f32_step(dev), f32_step(torch.device("cpu"))
    loss_rel = abs(lc - lh) / abs(lh)
    worst = max((_rel(gc[k], gh[k]), k) for k in gh)
    log(f"  f32 step on the card vs the CPU path at 2x64x64: loss {lc:.7f} vs "
        f"{lh:.7f} (rel {loss_rel:.2e} <= 1e-4), worst gradient rel norm "
        f"{worst[0]:.2e} ({worst[1]}, <= 1e-3)")
    if not (loss_rel <= 1e-4 and worst[0] <= 1e-3):
        raise AssertionError("the card's f32 step disagrees with the CPU path")
    rec.update(f32_loss_rel_card_vs_cpu=loss_rel, f32_grad_worst_rel=worst[0])

    # (g) Loss-decrease smoke from a random init, fixed lr: over a stream
    # of batches (the per-batch losses are noisy, so this alone would pass
    # a zero or wrong-sign update), then on one fixed batch, where the mean
    # of the last 5 of 20 losses must sit 10% below that of the first 5
    # (tests/test_torch_train_smoke.py holds the same check on the CPU, and
    # shows that a zeroed or negated gradient fails it).
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    st = train_init(model_def, total_steps=30, schedule=lambda step: 2e-4, seed=0,
                    device=dev)
    it = batch_iterator(SyntheticTriplets(n=16, h=72, w=72), 2, crop=64)
    curve = [float(train_step(st, next(it), SMOKE_DTYPE)["loss"]) for _ in range(30)]
    ok = min(curve[5:]) < mean(curve[:3])
    log(f"  30 steps from a random init ({SMOKE_DTYPE}, lr 2e-4, 2x64x64): "
        f"first 3 mean {mean(curve[:3]):.5f}, min after 5 {min(curve[5:]):.5f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"loss did not decrease: {curve}")
    st = train_init(model_def, total_steps=20, schedule=lambda step: 2e-4, seed=0,
                    device=dev)
    fixed = next(batch_iterator(SyntheticTriplets(n=16, h=72, w=72), 2, crop=64))
    fixed_curve = [float(train_step(st, fixed, SMOKE_DTYPE)["loss"]) for _ in range(20)]
    ratio = mean(fixed_curve[-5:]) / mean(fixed_curve[:5])
    log(f"  20 steps on one fixed batch, the same settings: mean of the last 5 "
        f"{mean(fixed_curve[-5:]):.5f} / first 5 {mean(fixed_curve[:5]):.5f} = "
        f"{ratio:.4f} (<= 0.9) {'ok' if ratio <= 0.9 else 'FAIL'}")
    if not ratio <= 0.9:
        raise AssertionError(f"loss did not fall on a fixed batch: {fixed_curve}")
    rec.update(smoke_losses=curve, fixed_batch_losses=fixed_curve)
    return rec


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
        t0 = time.perf_counter()
        built = _build.build_all(cuda_warp.SOURCES)  # one nvcc each, in parallel
        log(f"  both sources built in {time.perf_counter() - t0:.2f} s")
        for b in built.values():
            log(f"  nvcc: {b.seconds:.2f} s -> {os.path.relpath(b.path, ROOT)}")
            for line in b.ptxas_log.splitlines():
                if any(k in line for k in ("registers", "spill", "Compiling entry")):
                    log(f"  ptxas: {line.strip()}")
        cuda_warp.library()
        cuda_warp.library_bwd()

    with Phase("kernels"):
        records, worst = check_and_time_kernel(warp_mod, dev)

    with Phase("main path"):
        main = main_path(dev, warp_mod)

    with Phase("train"):
        bwd_records, bwd_worst, fwd_worst_train = check_and_time_bwd_kernel(warp_mod, dev)
        train = train_path(dev, warp_mod, cuda_warp)

    per_fwd = lambda key: sum(r[key] * r["launches_per_forward"]  # noqa: E731
                              for r in records)
    per_step = lambda key: sum(r[key] * r["launches_per_step"]  # noqa: E731
                               for r in bwd_records)
    bound_by = lambda recs: ("bytes" if all(r["bound_by"] == "bytes"  # noqa: E731
                                            for r in recs) else "operations")
    log(json.dumps({"kernels": [{
        "name": "warp_planes", "route": "cuda",
        "source": "rife_tpu_torch/csrc/warp_planes.cu",
        "replaces": "rife_tpu/ops/pallas/warp_v5.py:337",
        "launches": main["launches"] + train["fwd_launches"],
        "launches_by_path": {"serve": main["launches"], "train": train["fwd_launches"]},
        "max_abs_err": max(worst, fwd_worst_train),
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"), "bound_by": bound_by(records),
        "library_ms": per_fwd("library_ms"), "times_are": "per serving forward",
        "per_launch": records, "main_path": main, "card": smi}, {
        "name": "warp_planes_bwd", "route": "cuda",
        "source": "rife_tpu_torch/csrc/warp_planes_bwd.cu",
        "replaces": "rife_tpu/ops/pallas/warp_v5.py:337",
        "replaces_also": "rife_tpu/ops/warp.py:274 (_planes_diff_bwd)",
        "launches": train["bwd_launches"],
        "launches_by_path": {"serve": main["bwd_launches"], "train": train["bwd_launches"]},
        "max_abs_err": bwd_worst,
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"), "bound_by": bound_by(bwd_records),
        "library_ms": per_step("library_ms"), "times_are": "per training step",
        "per_launch": bwd_records, "train_path": train, "card": smi}]}))
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
