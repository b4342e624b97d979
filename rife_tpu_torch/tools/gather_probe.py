"""K6-K8, the round-3 gather probes: each kernel held against its plain
version at the TPU experiments' sizes, then timed beside its bound and a
library call.

    python -m rife_tpu_torch.tools.gather_probe               # on the card
    python -m rife_tpu_torch.tools.gather_probe --device cpu  # plain versions, tiny sizes

Counterpart of tools/r3_exp1.py, r3_exp2.py and r3_exp21.py, in three
sections named after them.  Inputs come from a seeded numpy generator
(`jax.random`'s numbers cannot be had here), at the scripts' sizes:

- exp1: the recurrence (`ops.gather_probe.micro`) for r3_exp1.py's 8
  bodies at R = 4000, in ns per step, in both forms (the tile split into
  the groups a step's gathers close over, a block each, and the whole
  tile in one warp's registers); `select_rows` at the script's size
  (64x256, sel = [3, 0, 5, 1]) and where the bytes count (a seeded
  permutation of the 8-row blocks of a 16x3x736x1280 f32 stack, 181 MB,
  over three times the 50 MB L2); the channel-block sweep: K3 (cb = C)
  against `warp_nhwc_cb1` (cb = 1) on a 4x736x1280x3 bf16 image and the
  script's flow (23x40 normal x 3, bilinear-resized, bf16), 10 chained
  warps, and one warp on a +-200 px block flow;
- exp2: the recurrence for r3_exp2.py's 7 bodies at 40000 x 32 (the
  block form), in ns per body; then its five 720p warp shapes (bf16 image, f32 flow), the
  "current" warp (K3 for C < 8, K4 otherwise) against K1 through the
  planes (v5's counterpart: NHWC to planes, K1, back), 20 chained each;
- exp21: the lane, sublane and 8-row-broadcast tile gathers at NT = 512
  (the script's size) and NT = 32768 (402 MB in all, where the bytes
  bound exceeds the launch overhead).

Checks (a failure raises): the recurrence bit-equal to its plain version
(the plain version on the host, in worker processes; it stops exactly at
the fixed point the contracting bodies reach); the chaotic `unpack`
bodies bit-equal over 4 steps, and over the whole run the elements whose
bits or NaN-ness differ are counted, not gated; the gathers and block
copies exact, against the plain version and the library call; the warps
bit-equal to each other and to `warp_ref`.  Times are device times by
CUDA events around captured CUDA graphs (`utils.profiling.graph_ms`); the
recurrence's plain version is timed on the host.  The recurrence's bound
is latency: its floor (`chain_floor_ms`) is the dependent chain of a
step at the SM clock, with assumed latencies (ALU_CYCLES,
SMEM_LOAD_CYCLES), the least time a serial recurrence can take on any
number of SMs; the card-wide operations and bytes stand beside it.  A
body measured under its floor shows the assumed latencies too long
(`under_floor`).  One JSON line a section.  `chip_smoke.py` imports
these functions (its phase 10).

On the CPU the wrappers run their plain versions: the sections run at
tiny sizes, as a rehearsal of the control flow, and time nothing.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from rife_tpu_torch.ops import gather_probe as gp
from rife_tpu_torch.ops.cuda.gather_probe import cb1_plan
from rife_tpu_torch.ops.resize import resize_bilinear
from rife_tpu_torch.ops.warp import warp_nhwc_k3, warp_nhwc_k4, warp_planes, warp_ref
from rife_tpu_torch.utils.profiling import graph_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
# Assumed dependent latencies on Hopper, in SM cycles, for the recurrence's
# floor: an f32 FMA/ALU op, and a shared-memory load or a shuffle (the
# warp's synchronisation before it not counted).
ALU_CYCLES = 4
SMEM_LOAD_CYCLES = 30
# Per body: (dependent ALU ops per step, whether a step waits on a shared-
# memory load, operations per element and step).  The chain: the inner
# FMA, the body's ops, the outer FMA.
BODY_COST = {"base": (2, False, 4), "mul": (3, False, 5), "lane": (2, True, 4),
             "lane2": (3, True, 5), "sublane": (2, True, 4), "unpack": (4, False, 7),
             "v4row": (4, True, 7), "v5row": (5, True, 9)}
EXP1_R = 4000
EXP2_OUTER, EXP2_UNROLL = 40000, 32
SEL_ROWS = 8
SEL_BIG = (16 * 3 * 736, 1280)
WARP_B, WARP_H, WARP_W = 4, 736, 1280
EXP1_CHAIN, EXP2_CHAIN = 10, 20
# r3_exp2.py:101-107: (name, (N, H, W, C), flow scale).
EXP2_CASES = (("img 3ch 736x1280 b4", (4, 736, 1280, 3), 1.0),
              ("feat 16ch 368x640 b8", (8, 368, 640, 16), 0.5),
              ("feat 32ch 184x320 b8", (8, 184, 320, 32), 0.25),
              ("feat 64ch 92x160 b8", (8, 92, 160, 64), 0.125),
              ("feat 128ch 46x80 b8", (8, 46, 80, 128), 0.0625))
TILES = (512, 32768)
TIMED = 20
MICRO_TIMED = 1  # a 40000 x 32 launch takes tens to hundreds of ms
# Counted launches of one `drive` (what chip_smoke.py's phase 10 checks).
DRIVE_LAUNCHES = {
    "micro": len(gp.FORMS) * len(gp.EXP1_BODIES) + len(gp.EXP2_BODIES), "select_rows": 2,
    "tile_gather": len(gp.GATHER_KINDS) * len(TILES), "warp_nhwc_cb1": EXP1_CHAIN,
    "warp_nhwc_k3": EXP1_CHAIN + EXP2_CHAIN,
    "warp_nhwc_k4": EXP2_CHAIN * sum(c[1][3] >= 8 for c in EXP2_CASES),
    "warp_planes": EXP2_CHAIN * len(EXP2_CASES)}


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30,
                          check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs

def micro_inputs(seed: int, idx_hi: int) -> tuple:
    """x, w uniform f32 (8, 128); idx int32 in [0, idx_hi) (r3_exp1.py 128,
    r3_exp2.py 127); idx0 in [0, 8): numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.random((8, 128), dtype=np.float32),
            rng.integers(0, idx_hi, (8, 128)).astype(np.int32),
            rng.integers(0, 8, (8, 128)).astype(np.int32),
            rng.random((8, 128), dtype=np.float32))


def _dev(arrays, device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def script_flow(rng, n: int, h: int, w: int, coarse_hw: tuple, scale: float = 1.0,
                dtype=torch.float32, device="cpu", repeat: bool = False) -> torch.Tensor:
    """The scripts' flow: normal (n, *coarse_hw, 2) x 3, bilinearly resized
    (align_corners=False) to (n, h, w, 2), times `scale`.  `repeat`: one
    coarse field for all n (r3_exp2.py's `coarse[:1].repeat(n, 0)`)."""
    coarse = rng.normal(0, 1, (1 if repeat else n, 2) + tuple(coarse_hw)) * 3
    planes = torch.from_numpy(coarse.astype(np.float32)).to(device)
    flow = resize_bilinear(planes, (h, w)).permute(0, 2, 3, 1) * scale
    return flow.expand(n, -1, -1, -1).to(dtype).contiguous()


def block_flow(rng, n: int, h: int, w: int, dtype, device) -> torch.Tensor:
    """+-200 px, random per 8x8 block, plus up to 1 px: partly out of frame."""
    blk = rng.uniform(-200, 200, (n, -(-h // 8), -(-w // 8), 2))
    f = np.repeat(np.repeat(blk, 8, 1), 8, 2)[:, :h, :w] + rng.uniform(-1, 1, (n, h, w, 2))
    return torch.from_numpy(f.astype(np.float32)).to(device, dtype)


def exp1_inputs(device, tiny: bool = False) -> dict:
    rng = np.random.default_rng(11)
    b, h, w = (1, 16, 64) if tiny else (WARP_B, WARP_H, WARP_W)
    rows, width = (96, 128) if tiny else SEL_BIG
    big = rng.random((rows, width), dtype=np.float32)
    return {"micro": micro_inputs(1, 128), "steps": 64 if tiny else EXP1_R,
            "sel_small": (torch.arange(64 * 256, dtype=torch.float32, device=device)
                          .reshape(64, 256),
                          torch.tensor([3, 0, 5, 1], dtype=torch.int32, device=device)),
            "sel_big": (torch.from_numpy(big).to(device),
                        torch.from_numpy(rng.permutation(rows // SEL_ROWS)
                                         .astype(np.int32)).to(device)),
            "img": torch.from_numpy(rng.random((b, h, w, 3), dtype=np.float32))
            .to(device, torch.bfloat16),
            "flow": script_flow(rng, b, h, w, (max(2, h // 32), max(2, w // 32)),
                                dtype=torch.bfloat16, device=device),
            "block_flow": block_flow(rng, b, h, w, torch.bfloat16, device)}


def exp2_inputs(device, tiny: bool = False) -> dict:
    rng = np.random.default_rng(12)
    cases = []
    for name, (n, h, w, c), scale in EXP2_CASES:
        if tiny:
            n, h, w = 2, max(8, h // 32), max(8, w // 32)
        img = torch.from_numpy(rng.random((n, h, w, c), dtype=np.float32)).to(
            device, torch.bfloat16)
        coarse_hw = (2, 2) if tiny else (WARP_H // 32, WARP_W // 32)
        cases.append((name, img, script_flow(rng, n, h, w, coarse_hw, scale, device=device,
                                             repeat=True)))
    return {"micro": micro_inputs(2, 127),
            "steps": (2, 4) if tiny else (EXP2_OUTER, EXP2_UNROLL), "cases": cases}


def exp21_inputs(device, tiny: bool = False) -> dict:
    rng = np.random.default_rng(13)
    out = {}
    for nt in ((4,) if tiny else TILES):
        x = torch.from_numpy(rng.random((nt, 8, 128), dtype=np.float32)).to(device)
        idx_l = torch.from_numpy(rng.integers(0, 128, (nt, 8, 128)).astype(np.int32))
        idx_s = torch.from_numpy(rng.integers(0, 8, (nt, 8, 128)).astype(np.int32))
        out[nt] = (x, idx_l.to(device), idx_s.to(device))
    return out


# ---------------------------------------------------------- the probe path

def chained(fn, img, flow, k):
    """`k` warps by `fn`, each of the last one's output by `flow`."""
    v = img
    for _ in range(k):
        v = fn(v, flow)
    return v


def planes_route(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """v5's NHWC front: NHWC to planes, K1 (`warp_planes`), back."""
    out = warp_planes(img.permute(0, 3, 1, 2).contiguous(), flow.permute(0, 3, 1, 2).contiguous())
    return out.permute(0, 2, 3, 1).contiguous()


def current_warp(img, flow):
    """r3_exp2.py's "current" NHWC warp: K3 for C < 8, K4 otherwise."""
    return (warp_nhwc_k3 if img.shape[-1] < 8 else warp_nhwc_k4)(img, flow)


def drive(e1: dict, e2: dict, e21: dict) -> dict:
    """One run of every probe kernel at the sections' sizes (the launches
    `DRIVE_LAUNCHES` counts on the card) -> the outputs.  On the CPU the
    wrappers run their plain versions (and K1/K3/K4 are the card's: the
    warp sweep runs `warp_ref` there)."""
    dev = e1["img"].device
    on_card = dev.type == "cuda"
    x1 = _dev(e1["micro"], dev)
    x2 = _dev(e2["micro"], dev)
    out = {"exp1_micro": {(b, f): gp.micro(*x1, b, e1["steps"], 1, f)
                          for b in gp.EXP1_BODIES for f in gp.FORMS},
           "sel_small": gp.select_rows(*e1["sel_small"], SEL_ROWS),
           "sel_big": gp.select_rows(*e1["sel_big"], SEL_ROWS),
           "cb1_chain": chained(gp.warp_nhwc_cb1, e1["img"], e1["flow"], EXP1_CHAIN),
           "k3_chain": chained(warp_nhwc_k3 if on_card else warp_ref, e1["img"], e1["flow"],
                              EXP1_CHAIN),
           "exp2_micro": {(b, "block"): gp.micro(*x2, b, *e2["steps"])
                          for b in gp.EXP2_BODIES},
           "exp2_warps": [(chained(current_warp if on_card else warp_ref, img, fl, EXP2_CHAIN),
                           chained(planes_route if on_card else warp_ref, img, fl, EXP2_CHAIN))
                          for _, img, fl in e2["cases"]],
           "tiles": {(nt, kind): gp.tile_gather(x, idx_l if kind == "lane" else idx_s, kind)
                     for nt, (x, idx_l, idx_s) in e21.items() for kind in gp.GATHER_KINDS}}
    if on_card:
        torch.cuda.synchronize()
    return out


# ----------------------------------------------------------------- checks

def _plain_micro_job(arrays, body: str, steps: int, unroll: int):
    """A worker process's job: the plain recurrence on the host, one
    thread -> (acc as numpy, seconds)."""
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    acc = gp.micro_ref(*(torch.from_numpy(a) for a in arrays), body, steps, unroll)
    return acc.numpy(), time.perf_counter() - t0


def plain_pool(workers: int = 8) -> ProcessPoolExecutor:
    """Worker processes (spawned: the parent holds CUDA) for the plain
    recurrences, which run for seconds to minutes on the host."""
    return ProcessPoolExecutor(max_workers=max(1, min(workers, os.cpu_count() or 1)),
                               mp_context=multiprocessing.get_context("spawn"))


def submit_section(pool, section: str, arrays, steps: tuple, chaotic_outer: int) -> dict:
    """The plain recurrences of one section's bodies on `arrays`, submitted
    to `pool`: (outer, unroll) steps, the chaotic bodies `chaotic_outer`
    x unroll -> {(section, body): future}, the longest first."""
    outer, unroll = steps
    bodies = gp.EXP1_BODIES if section == "exp1" else gp.EXP2_BODIES
    jobs = {(section, b): (arrays, b, chaotic_outer if b in gp.CHAOTIC else outer, unroll)
            for b in bodies}
    order = sorted(jobs, key=lambda k: -(jobs[k][2] * jobs[k][3]))
    return {k: pool.submit(_plain_micro_job, *jobs[k]) for k in order}


def submit_plain(pool, e1: dict, e2: dict, chaotic_outer: int) -> dict:
    """The plain recurrences the checks need: every exp1 body at its R;
    exp2's contracting bodies at the full run, its chaotic ones at
    `chaotic_outer` x unroll (the full run is EXP2_OUTER)."""
    return {**submit_section(pool, "exp2", e2["micro"], e2["steps"], chaotic_outer),
            **submit_section(pool, "exp1", e1["micro"], (e1["steps"], 1), e1["steps"])}


def differing(got: torch.Tensor, want) -> int:
    """Elements whose bits differ, or whose NaN-ness differs (NaN payloads
    are not compared: the card's NaN is canonical)."""
    g = got.detach().cpu().float()
    w = torch.as_tensor(want).float()
    gn, wn = torch.isnan(g), torch.isnan(w)
    bits = g.view(torch.int32) != w.view(torch.int32)
    return int(((gn != wn) | (bits & ~gn & ~wn)).sum())


def check_micro(section: str, outs: dict, arrays, steps: tuple, plain: dict,
                chaotic_outer: int) -> list[dict]:
    """The kernel's outputs {(body, form): acc} against the plain
    recurrences: contracting bodies bit-equal over the whole run; chaotic
    bodies bit-equal over 4 steps (a launch each, not counted), and over
    `chaotic_outer` x unroll steps (the whole run in the tool) the
    differing elements counted."""
    outer, unroll = steps
    recs = []
    for (body, form), got in outs.items():
        want, seconds = plain[(section, body)].result()
        rec = {"section": section, "body": body, "form": form, "steps": outer,
               "unroll": unroll, "plain_s": seconds}
        if body in gp.CHAOTIC:
            x = _dev(arrays, got.device)
            if chaotic_outer != outer:
                got = gp.micro(*x, body, chaotic_outer, unroll, form)
            four = differing(gp.micro(*x, body, 4, 1, form),
                             gp.micro_ref(*_dev(arrays, "cpu"), body, 4, 1))
            rec.update(differ_after_4_steps=four, compared_steps=chaotic_outer * unroll,
                       differ=differing(got, want), nan_kernel=int(torch.isnan(got).sum()),
                       nan_plain=int(np.isnan(want).sum()))
            ok = four == 0
            note = (f"4 steps: {four} differ (gate 0); {chaotic_outer * unroll} steps: "
                    f"{rec['differ']} of 1024 differ (counted), NaN {rec['nan_kernel']} "
                    f"kernel / {rec['nan_plain']} plain")
        else:
            rec["differ"] = differing(got, want)
            rec["max_abs_err"] = float((got.cpu().float() - torch.from_numpy(want)).abs().max())
            ok = rec["differ"] == 0
            note = f"{rec['differ']} of 1024 differ (gate: bit-equal)"
        print(f"  {section} micro {body}, {form} form ({outer} x {unroll}): {note}; plain "
              f"{seconds:.2f} s {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"micro kernel disagrees with its plain version: "
                                 f"{section} {body}, {form} form")
        recs.append(rec)
    return recs


def _exact(label: str, got: torch.Tensor, *wants) -> dict:
    errs = [float((got.float() - w.float()).abs().max()) for w in wants]
    same = all(torch.equal(got, w) for w in wants)
    print(f"  {label}: max |diff| {max(errs):.3g} against {len(wants)} references "
          f"(gate: equal) {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError(f"{label}: kernel is not its reference bit for bit")
    return {"check": label, "max_abs_err": max(errs)}


def check_exp1(e1: dict, outs: dict) -> list[dict]:
    """select_rows against its plain version and index_select * 2; the
    chained cb = 1 warps against K3's and the plain chain; one warp on the
    block flow."""
    recs = []
    for key in ("sel_small", "sel_big"):
        x, sel = e1[key]
        blocks = x.reshape(-1, SEL_ROWS * x.shape[1])
        lib = (blocks.index_select(0, sel) * 2.0).reshape(-1, x.shape[1])
        recs.append(_exact(f"select_rows {key} {tuple(x.shape)} -> {tuple(outs[key].shape)}",
                           outs[key], gp.select_rows_ref(x, sel, SEL_ROWS), lib))
    img, flow = e1["img"], e1["flow"]
    plain = chained(warp_ref, img, flow, EXP1_CHAIN)
    recs.append(_exact(f"warp cb = 1, {EXP1_CHAIN} chained, {tuple(img.shape)} bf16",
                       outs["cb1_chain"], outs["k3_chain"], plain))
    bf = e1["block_flow"]
    k3 = warp_nhwc_k3 if img.is_cuda else warp_ref
    recs.append(_exact("warp cb = 1, +-200 px block flow", gp.warp_nhwc_cb1(img, bf),
                       k3(img, bf), warp_ref(img, bf)))
    return recs


def check_exp2_warps(e2: dict, outs: dict) -> list[dict]:
    """Each case's chained current warp and K1 route bit-equal to each
    other; each one's max error against the plain chain."""
    recs = []
    for (name, img, fl), (cur, k1) in zip(e2["cases"], outs["exp2_warps"]):
        plain = chained(warp_ref, img, fl, EXP2_CHAIN)
        rec = _exact(f"exp2 {name}, {EXP2_CHAIN} chained: current vs K1 route", cur, k1)
        rec["current_max_abs_vs_plain"] = float((cur.float() - plain.float()).abs().max())
        rec["k1_max_abs_vs_plain"] = float((k1.float() - plain.float()).abs().max())
        print(f"    max |diff| against warp_ref's chain: current "
              f"{rec['current_max_abs_vs_plain']:.3g}, K1 route {rec['k1_max_abs_vs_plain']:.3g}",
              flush=True)
        recs.append(rec)
    return recs


def check_exp21(e21: dict, outs: dict) -> list[dict]:
    recs = []
    for nt, (x, idx_l, idx_s) in e21.items():
        for kind in gp.GATHER_KINDS:
            idx = idx_l if kind == "lane" else idx_s
            lib = torch.gather(x, 2 if kind == "lane" else 1, idx.long())
            recs.append(_exact(f"tile_gather {kind} NT = {nt}", outs["tiles"][(nt, kind)],
                               gp.tile_gather_ref(x, idx, kind), lib))
    return recs


# ------------------------------------------------------------------ times

def _bytes_rec(ms: float, nbytes: int, **extra) -> dict:
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ms": ms, "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
            "of_bound": bound / ms, **extra}


def time_micro(section: str, arrays, steps: tuple, plain: dict, clock_mhz: float) -> list:
    """Each body's kernel time (ns per body; at unroll 1 in both forms)
    beside its bound, the dependent chain at the SM clock
    (`chain_floor_ms`, `bound_by` "latency"), and beside that the card-wide
    floors: its operations over the card's f32 rate and its bytes; and the
    plain version's host time (from the checks' worker run; for exp2's
    chaotic bodies that run covers the steps compared)."""
    outer, unroll = steps
    n = outer * unroll
    x = _dev(arrays, "cuda")
    calls = TIMED if n <= EXP1_R else MICRO_TIMED
    recs = []
    for body in (gp.EXP1_BODIES if section == "exp1" else gp.EXP2_BODIES):
        alu, smem, ops = BODY_COST[body]
        chain_ms = n * (alu * ALU_CYCLES + smem * SMEM_LOAD_CYCLES) / (clock_mhz * 1e3)
        ops_ms = n * 1024 * ops / F32_FLOPS_PER_S * 1e3
        bytes_ms = 5 * 1024 * 4 / HBM_BYTES_PER_S * 1e3  # x, idx, idx0, w, out
        forms = gp.FORMS if unroll == 1 else ("block",)
        ms = {f: graph_ms(lambda *a, b=body, f=f: gp.micro(*a, b, outer, unroll, f), [x],
                          calls) for f in forms}
        rec = {"section": section, "body": body, "bodies": n, "ms": ms["block"],
               "ns_per_body": ms["block"] * 1e6 / n, "bound_ms": chain_ms,
               "bound_by": "latency", "chain_floor_ms": chain_ms,
               "chain_floor_ns_per_body": chain_ms * 1e6 / n,
               "share_of_floor": chain_ms / ms["block"], "under_floor": ms["block"] < chain_ms,
               "alu_cycles": ALU_CYCLES, "smem_load_cycles": SMEM_LOAD_CYCLES,
               "sm_clock_mhz": clock_mhz, "operations_ms": ops_ms, "bytes_ms": bytes_ms,
               "plain_ms": plain[(section, body)].result()[1] * 1e3, "library_ms": None}
        warp = ""
        if "warp" in ms:
            rec.update(warp_form_ms=ms["warp"], warp_form_ns_per_body=ms["warp"] * 1e6 / n)
            warp = f", warp form {rec['warp_form_ns_per_body']:.2f}"
        under = " (under it: the assumed latencies are too long)" if rec["under_floor"] else ""
        print(f"  {section} micro {body}: block form {rec['ns_per_body']:.2f} ns/body{warp} "
              f"({n} bodies); floor: dependent chain {chain_ms * 1e6 / n:.2f} ns at "
              f"{clock_mhz:.0f} MHz ({rec['share_of_floor']:.1%}){under}; the card's "
              f"operations {ops_ms * 1e6 / n:.4f} ns", flush=True)
        recs.append(rec)
    return recs


def _copies(t: tuple, nbytes: int) -> list:
    """Copies of the inputs `t` that together exceed the L2 three times
    over, at most one per timed call."""
    copies = max(1, min(TIMED, -(-160_000_000 // nbytes)))
    return [tuple(a.clone() for a in t) for _ in range(copies)]


def time_select(e1: dict) -> list[dict]:
    recs = []
    for key in ("sel_small", "sel_big"):
        x, sel = e1[key]
        width = x.shape[1]
        nbytes = 2 * sel.numel() * SEL_ROWS * width * 4 + sel.numel() * 4
        inputs = _copies((x, sel), nbytes)

        def lib(a, s):
            return (a.reshape(-1, SEL_ROWS * width).index_select(0, s) * 2.0).reshape(-1, width)
        rec = _bytes_rec(graph_ms(lambda a, s: gp.select_rows(a, s, SEL_ROWS), inputs, TIMED),
                         nbytes, shape=key, x=list(x.shape), blocks=sel.numel(),
                         plain_ms=graph_ms(lambda a, s: gp.select_rows_ref(a, s, SEL_ROWS),
                                           inputs, TIMED),
                         library_ms=graph_ms(lib, inputs, TIMED),
                         library="index_select, then a multiply (two calls)")
        print(f"  select_rows {key}: kernel {rec['ms'] * 1e3:.1f} us ({rec['of_bound']:.1%} of "
              f"{rec['bound_ms'] * 1e3:.3f} us), plain {rec['plain_ms'] * 1e3:.1f}, "
              f"index_select + mul {rec['library_ms'] * 1e3:.1f}", flush=True)
        recs.append(rec)
    return recs


def _grid(flow: torch.Tensor) -> torch.Tensor:
    """grid_sample's grid (align_corners=True) for an NHWC pixel flow."""
    n, h, w, _ = flow.shape
    f = flow.float()
    xs = torch.arange(w, device=f.device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=f.device, dtype=torch.float32).view(1, h, 1)
    return torch.stack([(xs + f[..., 0]) * (2.0 / max(w - 1, 1)) - 1,
                        (ys + f[..., 1]) * (2.0 / max(h - 1, 1)) - 1], -1).contiguous()


def per_warp_ms(fn, img: torch.Tensor, flow: torch.Tensor, k: int) -> float:
    """Device time of one warp of `k` chained (`chained`), from two chains
    in a captured graph."""
    return graph_ms(lambda a, f: chained(fn, a, f, k), [(img, flow)], 2) / k


def _warp_bytes(img: torch.Tensor, flow: torch.Tensor) -> int:
    return 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size()


def time_budget(e1: dict) -> dict:
    """Per warp of the 10-chain: cb = 1 and K3 (cb = C); the plain version
    and F.grid_sample (f32 copies: its grid cannot be bf16 at 1280 px) one
    call each."""
    img, flow = e1["img"], e1["flow"]
    lib_in = [(img.permute(0, 3, 1, 2).float().contiguous(), _grid(flow))]
    rec = _bytes_rec(per_warp_ms(gp.warp_nhwc_cb1, img, flow, EXP1_CHAIN),
                     _warp_bytes(img, flow), shape=list(img.shape), dtype="bf16",
                     k3_ms=per_warp_ms(warp_nhwc_k3, img, flow, EXP1_CHAIN),
                     plain_ms=graph_ms(warp_ref, [(img, flow)], 2),
                     library_ms=graph_ms(lambda a, g: F.grid_sample(
                         a, g, mode="bilinear", padding_mode="border", align_corners=True),
                         lib_in, 2),
                     library="F.grid_sample, f32", plan=cb1_plan(img, flow, 0))
    rec["k3_of_bound"] = rec["bound_ms"] / rec["k3_ms"]
    print(f"  warp budget sweep {tuple(img.shape)} bf16, per warp of {EXP1_CHAIN} chained: "
          f"cb = 1 {rec['ms'] * 1e3:.1f} us ({rec['of_bound']:.1%}), K3 (cb = C) "
          f"{rec['k3_ms'] * 1e3:.1f} us ({rec['k3_of_bound']:.1%}) of {rec['bound_ms'] * 1e3:.1f} "
          f"us; plain {rec['plain_ms'] * 1e3:.1f}, grid_sample f32 "
          f"{rec['library_ms'] * 1e3:.1f}", flush=True)
    return rec


def time_exp2_warps(e2: dict) -> list[dict]:
    recs = []
    for name, img, fl in e2["cases"]:
        rec = _bytes_rec(per_warp_ms(current_warp, img, fl, EXP2_CHAIN), _warp_bytes(img, fl),
                         case=name, shape=list(img.shape),
                         current="K3" if img.shape[-1] < 8 else "K4",
                         k1_route_ms=per_warp_ms(planes_route, img, fl, EXP2_CHAIN))
        print(f"  exp2 {name}: per warp of {EXP2_CHAIN} chained, {rec['current']} "
              f"{rec['ms'] * 1e3:.1f} us ({rec['of_bound']:.1%} of {rec['bound_ms'] * 1e3:.1f}), "
              f"K1 route {rec['k1_route_ms'] * 1e3:.1f} us", flush=True)
        recs.append(rec)
    return recs


def time_tiles(e21: dict) -> list[dict]:
    recs = []
    for nt, (x, idx_l, idx_s) in e21.items():
        for kind in gp.GATHER_KINDS:
            idx = idx_l if kind == "lane" else idx_s
            dim = 2 if kind == "lane" else 1
            nbytes = 3 * x.numel() * 4
            inputs = _copies((x, idx), nbytes)
            rec = _bytes_rec(graph_ms(lambda a, i, k=kind: gp.tile_gather(a, i, k), inputs,
                                      TIMED), nbytes, kind=kind, tiles=nt,
                             plain_ms=graph_ms(lambda a, i, k=kind: gp.tile_gather_ref(a, i, k),
                                               inputs, TIMED),
                             library_ms=graph_ms(lambda a, i, d=dim: torch.gather(a, d, i.long()),
                                                 inputs, TIMED),
                             library=f"torch.gather(dim={dim}), with the index's int64 cast")
            print(f"  tile_gather {kind} NT = {nt}: kernel {rec['ms'] * 1e3:.2f} us "
                  f"({rec['of_bound']:.1%} of {rec['bound_ms'] * 1e3:.2f}), plain "
                  f"{rec['plain_ms'] * 1e3:.2f}, torch.gather {rec['library_ms'] * 1e3:.2f}",
                  flush=True)
            recs.append(rec)
    return recs


# ------------------------------------------------------------------- main

def run(device, tiny: bool, chaotic_outer: int | None = None, before_drive=None,
        after_drive=None) -> dict:
    """The three sections: drive, check, and on the card time -> records.
    `chaotic_outer`: the steps over which exp2's chaotic bodies are
    compared (default: the whole run).  `before_drive` and `after_drive`,
    if given, are called just before and just after `drive` (chip_smoke.py
    counts the launches between them)."""
    e1, e2, e21 = exp1_inputs(device, tiny), exp2_inputs(device, tiny), exp21_inputs(device, tiny)
    chaotic_outer = chaotic_outer or e2["steps"][0]
    with plain_pool() as pool:
        plain = submit_plain(pool, e1, e2, chaotic_outer)
        if before_drive:
            before_drive()
        outs = drive(e1, e2, e21)
        if after_drive:
            after_drive()
        recs = {"exp1": {"micro": check_micro("exp1", outs["exp1_micro"], e1["micro"],
                                              (e1["steps"], 1), plain, e1["steps"]),
                         "checks": check_exp1(e1, outs)},
                "exp2": {"warp_checks": check_exp2_warps(e2, outs)},
                "exp21": {"checks": check_exp21(e21, outs)}}
        recs["exp2"]["micro"] = check_micro("exp2", outs["exp2_micro"], e2["micro"],
                                            e2["steps"], plain, chaotic_outer)
        del outs
        if torch.device(device).type == "cuda":
            clock = float(nvidia_smi("clocks.max.sm").split()[0])
            recs["exp1"].update(micro_times=time_micro("exp1", e1["micro"], (e1["steps"], 1),
                                                       plain, clock),
                                select_times=time_select(e1), budget_times=time_budget(e1),
                                sm_clock_mhz=clock)
            recs["exp2"].update(micro_times=time_micro("exp2", e2["micro"], e2["steps"], plain,
                                                       clock),
                                warp_times=time_exp2_warps(e2))
            recs["exp21"]["times"] = time_tiles(e21)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the plain versions", file=sys.stderr)
        return 1
    card = "cpu (plain versions, tiny sizes)"
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = nvidia_smi("name,power.limit")
        print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)
    recs = run(torch.device(args.device), tiny=args.device == "cpu")
    for section in ("exp1", "exp2", "exp21"):
        print(json.dumps({"section": section, "card": card, **recs[section]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
