"""The round-3 gather probes: a loop-carried (8, 128) f32 recurrence with a
gather in its body, a block copy whose source block is chosen per output
block, per-element gathers inside (8, 128) tiles, and the image warp with
one thread per channel.

Port of K6-K8, the TPU experiments tools/r3_exp1.py (`make`,
`sel_kernel`, `warp_budget`), tools/r3_exp2.py (`micro`) and
tools/r3_exp21.py (`make`).  No served or training path calls them: they
measure what one tap gather costs on the card beside a plain arithmetic
op, the questions the port's warp kernels raise.

Each function has a plain PyTorch version (`*_ref`) and a wrapper that
dispatches on the device: a CPU tensor goes to the plain version, a CUDA
tensor to the hand-written kernel (`ops/cuda/gather_probe.py`,
`csrc/gather_probe.cu`), which launches or raises.  Each wrapper counts
its kernel launches in `.launches`.

- `micro`: `acc <- acc * DECAY + body(x + acc * MIX, idx, idx0, w)` from
  acc = 0, `steps * unroll` times (r3_exp1.py runs R = 4000 steps of one
  body, r3_exp2.py 40000 steps of 32 unrolled bodies).  The bodies
  (`BODIES`) are those of both scripts.
- `select_rows`: out block i = 2 * x block sel[i], blocks of `rows` rows
  (r3_exp1.py's scalar-prefetched `sel_kernel`).
- `tile_gather`: per element of each (8, 128) tile, a lane gather
  y[t, s, l] = x[t, s, idx[t, s, l]], a sublane gather
  y[t, s, l] = x[t, idx[t, s, l], l], or the sublane gather built from 8
  masked row broadcasts (`bcast8`) (r3_exp21.py).
- `warp_nhwc_cb1`: the NHWC warp with one thread per (pixel, channel),
  the counterpart of `warp_budget`'s channel block cb = 1; K3 (one thread
  per pixel, looping over the channels) is cb = C.  Its plain version is
  `ops.warp.warp_ref`.
"""
from __future__ import annotations

import numpy as np
import torch

from rife_tpu_torch.ops.cuda import gather_probe as _cuda
from rife_tpu_torch.ops.warp import warp_ref

TILE = (8, 128)
BODIES = ("base", "mul", "lane", "lane2", "sublane", "unpack", "v4row", "v5row")
EXP1_BODIES = BODIES  # tools/r3_exp1.py:67-84, in its order
EXP2_BODIES = ("base", "mul", "lane", "sublane", "unpack", "v4row", "v5row")  # r3_exp2.py:71-80
# Bodies whose recurrence is chaotic: `unpack` turns the low mantissa bits
# of the carried sum into exponent bits, so one rounding apart at any step
# becomes any value (NaN included) a few steps later.
CHAOTIC = ("unpack", "v5row")
GATHER_KINDS = ("lane", "sublane", "bcast8")
# The recurrence kernel's two forms: "block", the tile split into the
# groups a step's gathers close over (rows, columns or single elements),
# one warp a group, each its own block; "warp", one warp with the whole
# tile in registers, gathering by shuffles.
FORMS = ("block", "warp")
# The scripts' Python constants, as the f32 values a jnp f32 array times a
# Python float uses.
DECAY = float(np.float32(0.9999))
MIX = float(np.float32(1e-6))
GAIN = float(np.float32(1.0001))
_HI16 = -(1 << 16)  # 0xFFFF0000 as an int32
_MID29 = 0x10000000  # bits 0-28 of an f64 that lies halfway between two f32
_LOW29 = 0x1FFFFFFF
_F32_NORMAL_BITS = 897 << 52  # |f64 bits| below this: |v| < 2**-126


def _fma_exact(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 rounding of the exact p + c (f64 p, c) by round-to-odd: the f64
    sum s and its error e (TwoSum, s + e == p + c); where e != 0 and s's
    last bit is even, s moves one f64 ulp towards e.  53 >= 24 + 2 bits,
    so rounding that to f32 is the one rounding of p + c."""
    s = p + c
    bb = s - p
    e = torch.nan_to_num((p - (s - bb)) + (c - bb), nan=0.0)
    bits = s.view(torch.int64)
    step = (torch.sign(e) * torch.sign(s)).to(torch.int64) * (1 - (bits & 1))
    step = torch.where(torch.isfinite(s), step, 0)
    return (bits + step).view(torch.float64).float()


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors a, c and b an f32 tensor or a Python float
    that holds an f32 value, rounded once to f32: IEEE fma, CUDA's
    `__fmaf_rn`.  The product is exact in f64 (24 + 24 bits); the f64 sum
    rounds once, and rounding it to f32 is then right unless it lies
    exactly halfway between two f32 values or in f32's subnormal range,
    where `_fma_exact` rounds the exact sum."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    c = c.double()
    s = p + c
    bits = s.view(torch.int64)
    if bool(((bits & _LOW29) == _MID29).any()) or \
            bool(((bits & 0x7FFFFFFFFFFFFFFF) < _F32_NORMAL_BITS).any()):
        return _fma_exact(p, c)
    return s.float()


def _unpack(g: torch.Tensor):
    """The two halves of an f32's bits as f32 values: low 16 bits moved to
    the top (`u << 16`), and the top 16 bits (`u & 0xFFFF0000`)."""
    u = g.view(torch.int32)
    return (u << 16).view(torch.float32), (u & _HI16).view(torch.float32)


def _body(name: str, s: torch.Tensor, idx: torch.Tensor, idx2: torch.Tensor,
          idx0: torch.Tensor, w: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """One body on s (8, 128) f32.  Where the reference's XLA computes
    `a * b + c`, it emits one fused multiply-add (interpret mode on the
    CPU, tested), so those are `fma_f32`; `sum(unpack(s))` is
    `v0 + v1` (XLA drops the `0 +`)."""
    if name == "base":
        return s
    if name == "mul":
        return s * GAIN
    if name == "lane":
        return torch.gather(s, 1, idx)
    if name == "lane2":
        return torch.gather(s, 1, idx) + torch.gather(s, 1, idx2)
    if name == "sublane":
        return torch.gather(s, 0, idx0)
    if name == "unpack":
        lo, hi = _unpack(s)
        return lo + hi
    if name == "v4row":
        return fma_f32(torch.gather(s, 1, idx), w, torch.gather(s, 1, idx2) * wc)
    if name == "v5row":
        lo, hi = _unpack(torch.gather(s, 1, idx))
        return fma_f32(lo, w, hi * wc)
    raise ValueError(f"unknown body {name!r}; bodies are {BODIES}")


def _check_micro(x, idx, idx0, w, body, steps, unroll) -> None:
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; bodies are {BODIES}")
    for name, t, dt in (("x", x, torch.float32), ("idx", idx, torch.int32),
                        ("idx0", idx0, torch.int32), ("w", w, torch.float32)):
        if tuple(t.shape) != TILE or t.dtype != dt:
            raise ValueError(f"micro takes {name} as an {TILE} {dt} tile, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if steps < 0 or unroll < 1:
        raise ValueError(f"micro takes steps >= 0 and unroll >= 1, got {steps}, {unroll}")


def micro_ref(x: torch.Tensor, idx: torch.Tensor, idx0: torch.Tensor, w: torch.Tensor,
              body: str, steps: int, unroll: int = 1) -> torch.Tensor:
    """Plain version of the recurrence on (8, 128) tiles: x and w f32, idx
    (lane, in [0, 128)) and idx0 (sublane, in [0, 8)) int32.  Each of the
    `steps * unroll` iterations (the unroll changes nothing but the
    kernel's code) computes s = x + acc * MIX, then
    acc = acc * DECAY + body(s); -> acc, f32.

    Roundings as the reference's interpret mode on the CPU computes them
    (bit for bit, `tests/test_torch_gather_probe.py`): both
    `x + acc * MIX` and `acc * DECAY + body` are one fused multiply-add
    each; `v4row` is fma(lane(idx), w, lane(idx2) * (1 - w)) with
    idx2 = clip(idx + 1, 0, 127), `v5row` the same on the two halves of
    one gathered value; the rest round op by op.

    The map from one acc to the next is deterministic, so once an
    iteration leaves acc's bits unchanged every later one does: the loop
    stops there, exactly (the contracting bodies reach such a fixed point
    after some 80-100 thousand iterations)."""
    _check_micro(x, idx, idx0, w, body, steps, unroll)
    idx, idx0 = idx.long(), idx0.long()
    idx2 = (idx + 1).clamp(0, 127)
    wc = 1 - w
    acc = torch.zeros(TILE, dtype=torch.float32, device=x.device)
    for _ in range(steps * unroll):
        s = fma_f32(acc, MIX, x)
        new = fma_f32(acc, DECAY, _body(body, s, idx, idx2, idx0, w, wc))
        if torch.equal(new.view(torch.int32), acc.view(torch.int32)):
            break
        acc = new
    return acc


def micro(x: torch.Tensor, idx: torch.Tensor, idx0: torch.Tensor, w: torch.Tensor,
          body: str, steps: int, unroll: int = 1, form: str = "block") -> torch.Tensor:
    """The recurrence (`micro_ref`).  CPU tensors: the plain version.  CUDA
    tensors: one launch of the kernel in `form` (`FORMS`; the block form
    built for unroll 1 and 32, the warp form for 1), counted in
    `micro.launches`; an index out of range gives NaN where the plain
    version raises."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; forms are {FORMS}")
    if x.device.type == "cpu":
        return micro_ref(x, idx, idx0, w, body, steps, unroll)
    _check_micro(x, idx, idx0, w, body, steps, unroll)
    out = _cuda.launch_micro(x, idx, idx0, w, BODIES.index(body), steps, unroll,
                             form == "warp", DECAY, MIX, GAIN)
    micro.launches += 1
    return out


micro.launches = 0


def _check_select(x: torch.Tensor, sel: torch.Tensor, rows: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"select_rows takes a 2-d f32 x, got {tuple(x.shape)} {x.dtype}")
    if rows < 1 or x.shape[0] % rows:
        raise ValueError(f"select_rows: {x.shape[0]} rows are not blocks of {rows}")
    if sel.dim() != 1 or sel.dtype != torch.int32:
        raise ValueError(f"select_rows takes a 1-d int32 sel, got {tuple(sel.shape)} "
                         f"{sel.dtype}")


def select_rows_ref(x: torch.Tensor, sel: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain version: x (R, W) f32 seen as R / rows blocks of `rows` rows;
    sel (n,) int32 -> (n * rows, W), block i = 2 * x's block sel[i]."""
    _check_select(x, sel, rows)
    blocks = x.reshape(-1, rows, x.shape[1])
    return (blocks[sel.long()] * 2.0).reshape(-1, x.shape[1])


def select_rows(x: torch.Tensor, sel: torch.Tensor, rows: int) -> torch.Tensor:
    """`select_rows_ref`.  CUDA tensors: one launch, one block of threads
    per output block, which reads its own sel[i] (Hopper has no scalar
    prefetch); counted in `select_rows.launches`.  A block index out of
    range gives a NaN block where the plain version raises."""
    if x.device.type == "cpu":
        return select_rows_ref(x, sel, rows)
    _check_select(x, sel, rows)
    out = _cuda.launch_select_rows(x, sel, rows)
    select_rows.launches += 1
    return out


select_rows.launches = 0


def _check_tiles(x: torch.Tensor, idx: torch.Tensor, kind: str) -> None:
    if kind not in GATHER_KINDS:
        raise ValueError(f"unknown gather {kind!r}; kinds are {GATHER_KINDS}")
    if x.dim() != 3 or tuple(x.shape[1:]) != TILE or x.dtype != torch.float32:
        raise ValueError(f"tile_gather takes (NT, 8, 128) f32 tiles, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if idx.shape != x.shape or idx.dtype != torch.int32:
        raise ValueError(f"tile_gather takes an int32 index of x's shape, got "
                         f"{tuple(idx.shape)} {idx.dtype}")


def tile_gather_ref(x: torch.Tensor, idx: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain version on (NT, 8, 128) f32 tiles and int32 indices: `lane`
    y[t, s, l] = x[t, s, idx[t, s, l]]; `sublane` y[t, s, l] =
    x[t, idx[t, s, l], l]; `bcast8` the sum over the 8 rows s' of
    where(idx == s', row s' broadcast, 0), in that order (r3_exp21.py's
    `broadcast8`: the sublane gather for indices in [0, 8), 0 elsewhere)."""
    _check_tiles(x, idx, kind)
    if kind == "lane":
        return torch.gather(x, 2, idx.long())
    if kind == "sublane":
        return torch.gather(x, 1, idx.long())
    acc = torch.zeros_like(x)
    for s in range(TILE[0]):
        acc = acc + torch.where(idx == s, x[:, s:s + 1, :], 0.0)
    return acc


def tile_gather(x: torch.Tensor, idx: torch.Tensor, kind: str) -> torch.Tensor:
    """`tile_gather_ref`.  CUDA tensors: one launch, one block of threads
    per tile staged in shared memory; counted in `tile_gather.launches`.
    A lane or sublane index out of range gives NaN where the plain version
    raises."""
    if x.device.type == "cpu":
        return tile_gather_ref(x, idx, kind)
    _check_tiles(x, idx, kind)
    out = _cuda.launch_tile_gather(x, idx, GATHER_KINDS.index(kind))
    tile_gather.launches += 1
    return out


tile_gather.launches = 0


def warp_nhwc_cb1(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The NHWC warp of (N, H, W, C) by (N, H, W, 2) pixel flow
    (`ops.warp.warp_ref` semantics).  CPU tensors: `warp_ref`.  CUDA
    tensors: one launch with one thread per (pixel, channel), each
    computing the pixel's coordinate and weights itself; bit for bit K3
    (`ops.warp.warp_nhwc_k3`).  Counted in `warp_nhwc_cb1.launches`."""
    if img.device.type == "cpu":
        return warp_ref(img, flow)
    out = _cuda.launch_warp_cb1(img, flow)
    warp_nhwc_cb1.launches += 1
    return out


warp_nhwc_cb1.launches = 0
