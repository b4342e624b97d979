"""The IFBlock convblock chain on NHWC tensors: 8 x (3x3 conv C -> C, + bias,
PReLU), then + x.

Port of K5, tools/r3_exp50_pallasconv.py (`pallas_core`, `pallas_core_v2`;
`xla_core` is the same chain through XLA's convs), which computes
rife_tpu's `ifblock_conv_core` inner loop (rife_tpu/models/ifnet.py) and
the port's `IFBlock.forward` loop over `convblock` (models/ifnet.py).  Each
stage sums the 9 taps of the zero-padded input times the weights in f32,
adds the bias, applies PReLU in f32 and rounds once to the input's dtype;
after the last stage `+ x` is computed in f32 and rounded once.

Packed parameters (`pack_chain`, `chain_params_from_jax`): weights
(S, Cout, 9, Cin) in the compute dtype, tap t = 3 * ky + kx (PyTorch's
(Cout, Cin, 3, 3) permuted to (Cout, 3, 3, Cin)); biases and PReLU slopes
(S, C) in f32.

`conv_chain` dispatches on the device: a CPU tensor goes to the plain
version `conv_chain_ref`, a CUDA tensor to the hand-written kernel
(`ops/cuda/conv_chain.py`, bf16 only), one launch per stage, which
launches or raises.  The served model's `IFBlock` keeps cuDNN: nothing in
the forward calls this module.

The kernel works on the zero-bordered flat layout of `pallas_core`: the
activation as an (N * (H+2) * (W+2), ld) matrix (`to_flat`), border rows
and pad channels zero, so that tap (dy, dx) of row m is row
m + (dy-1)(W+2) + (dx-1).  The row stride `ld` is C rounded up to 64, so
that every row starts on a 128-byte line and the kernel's TMA boxes of 64
channels never cross a row's end (on the H100 rows only 16 bytes apart,
or boxes cut at the row's end, made its loads much slower); its products
read the first c8 channels (C rounded up to 8), rounded up to 16.  The
parameters are zero-padded to `ld` input and `np` output channels
(`pad_params`, `kernel_params`), which keeps the pad channels of every
stage exactly 0.  `geometry` and `tile_schedule` give the kernel's tiles:
128 flat rows by `bn` output channels, walked by a persistent grid of at
most one block per SM.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from rife_tpu_torch.ops.cuda import conv_chain as _cuda


def _check_params(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  a: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv_chain takes an (N, H, W, C) tensor, got {tuple(x.shape)}")
    c = x.shape[3]
    s = w.shape[0]
    if tuple(w.shape) != (s, c, 9, c) or s < 1:
        raise ValueError(f"weights {tuple(w.shape)} are not (stages, {c}, 9, {c})")
    for name, t in (("biases", b), ("alphas", a)):
        if tuple(t.shape) != (s, c):
            raise ValueError(f"{name} {tuple(t.shape)} are not ({s}, {c})")


def conv_stage_ref(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One stage of the plain version on y (N, H, W, C) with one stage's
    w (C, 9, C), b and a (C,): one f32 matmul of the im2col matrix
    (N*H*W, 9*C) of the zero-padded input with the (9*C, C) weights, + b,
    PReLU, rounded once to `dtype` -> f32 (N, H, W, C).

    Not `F.conv2d`: cuDNN picks an FFT route for some f32 3x3 convs at
    these widths (hundreds of ms a call) and TF32 for others.  A CUDA
    matmul must be full f32, so a CUDA tensor is refused while
    `torch.backends.cuda.matmul.allow_tf32` is on."""
    if y.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("conv_chain_ref needs full-f32 CUDA matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    n, h, wd, c = y.shape
    yp = F.pad(y.float(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([yp[:, ky:ky + h, kx:kx + wd] for ky in range(3)
                      for kx in range(3)], -1).reshape(n * h * wd, 9 * c)
    acc = cols @ w.float().reshape(c, 9 * c).t() + b.float()
    acc = torch.where(acc >= 0, acc, acc * a.float())
    return acc.to(dtype).float().reshape(n, h, wd, c)


def conv_chain_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   a: torch.Tensor) -> torch.Tensor:
    """Plain version: `conv_stage_ref` per stage, each rounded to x's
    dtype, then + x in f32, rounded once."""
    _check_params(x, w, b, a)
    y = x
    for s in range(w.shape[0]):
        y = conv_stage_ref(y, w[s], b[s], a[s], x.dtype)
    return (y + x.float()).to(x.dtype)


BM, BK = 128, 64  # the kernel's flat rows per tile and channels per TMA box
WIDTHS = (16, 96, 152, 240)  # its wgmma widths for C8 up to 240: one tile along N
WIDE = 128  # its width past that: tiles of whole 64-channel boxes along N


@dataclass(frozen=True)
class Geometry:
    """The kernel's layout of an (n, h, w, c) chain: `rows` flat rows `ld`
    channels apart, of which the products read c8 (rounded up to 16);
    tiles of BM rows by `bn` output channels (`n_tiles` along the
    channels, `np` = n_tiles * bn padded output channels); `grid`
    persistent blocks."""
    n: int
    h: int
    w: int
    c: int
    c8: int
    ld: int
    bn: int
    n_tiles: int
    np: int
    rows: int
    m_tiles: int
    tiles: int
    grid: int

    @property
    def waves(self) -> float:
        """Tiles per block: the schedule's longest block takes ceil(waves)."""
        return self.tiles / self.grid


def geometry(n: int, h: int, w: int, c: int, sms: int = 132) -> Geometry:
    """Tiles of the chain at (n, h, w, c) on a card of `sms` SMs: one tile
    along the channels of the narrowest width of WIDTHS that covers c8, or
    tiles of WIDE channels."""
    c8 = -(-c // 8) * 8
    ld = -(-c // BK) * BK
    if c8 <= WIDTHS[-1]:
        bn, n_tiles = next(b for b in WIDTHS if b >= c8), 1
    else:
        bn, n_tiles = WIDE, -(-c8 // WIDE)
    rows = n * (h + 2) * (w + 2)
    m_tiles = -(-rows // BM)
    tiles = m_tiles * n_tiles
    return Geometry(n, h, w, c, c8, ld, bn, n_tiles, n_tiles * bn, rows, m_tiles, tiles,
                    min(tiles, sms))


def tile_schedule(g: Geometry) -> list:
    """Block b's tiles in the order it computes them, as (first flat row,
    first output channel): tiles b, b + grid, ..., tile i being row tile
    i // n_tiles and channel tile i % n_tiles (the kernel's walk)."""
    return [[((i // g.n_tiles) * BM, (i % g.n_tiles) * g.bn)
             for i in range(blk, g.tiles, g.grid)] for blk in range(g.grid)]


def to_flat(x: torch.Tensor, ld: int) -> torch.Tensor:
    """(N, H, W, C) -> the zero-bordered flat (N * (H+2) * (W+2), ld), a
    new contiguous tensor in x's dtype: border rows and channels C.. zero."""
    n, h, w, c = x.shape
    flat = x.new_zeros((n, h + 2, w + 2, ld))
    dst = flat[:, 1:-1, 1:-1, :c]
    if x.element_size() == 2 and c % 2 == 0 and x.stride(3) == 1 and all(
            v % 2 == 0 for v in x.stride()[:3] + (x.storage_offset(),)):
        # Channel pairs as one 4-byte element: half the elements to copy.
        dst, x = dst.view(torch.int32), x.view(torch.int32)
    dst.copy_(x)
    return flat.view(n * (h + 2) * (w + 2), ld)


def from_flat(flat: torch.Tensor, n: int, h: int, w: int, c: int) -> torch.Tensor:
    """The interior of a flat buffer as an (N, H, W, C) view."""
    return flat.view(n, h + 2, w + 2, -1)[:, 1:-1, 1:-1, :c]


def pad_params(w: torch.Tensor, b: torch.Tensor, a: torch.Tensor, cols: int, rows: int):
    """Packed (w (S, C, 9, C), b, a (S, C)) zero-padded to w (S, rows, 9,
    cols) and b, a (S, rows): pad output channels get zero weights, bias
    and slope, so they compute exactly 0 from any input."""
    s, c = w.shape[:2]
    return (F.pad(w, (0, cols - c, 0, 0, 0, rows - c)), F.pad(b, (0, rows - c)),
            F.pad(a, (0, rows - c)))


def kernel_params(w: torch.Tensor, b: torch.Tensor, a: torch.Tensor, g: Geometry):
    """The kernel's parameters, zero-padded as `pad_params` pads them to
    (ld, np), the weights laid out as (S, 9, np, ld), so that tap t's B
    box of stage s is rows (9 s + t) np + n0 ... of one (S * 9 * np, ld)
    matrix (written in place: one copy, where padding then transposing
    takes two)."""
    s, c = w.shape[:2]
    wp = w.new_zeros((s, 9, g.np, g.ld))
    wp[:, :, :c, :c] = w.transpose(1, 2)
    return wp, F.pad(b, (0, g.np - c)), F.pad(a, (0, g.np - c))


def conv_chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """The chain on x (N, H, W, C) with packed parameters (w, b, a).

    CPU tensors: `conv_chain_ref`.  CUDA tensors: the kernel (bf16 x and
    weights, f32 biases and slopes, x's channel stride 1): x is copied once
    into the flat layout (`to_flat`) and the parameters padded
    (`kernel_params`), then one launch per stage ping-pongs between two
    flat buffers, the last stage writing the interior + x to a new
    contiguous (N, H, W, C) tensor; `conv_chain.launches` counts the
    launches.  Anything else raises."""
    if x.device.type == "cpu":
        return conv_chain_ref(x, w, b, a)
    _check_params(x, w, b, a)
    _cuda.check(x, w, b, a)
    g = geometry(*x.shape, _cuda.sm_count(x.device.index or 0))
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    run_stages(to_flat(x, g.ld), *kernel_params(w, b, a, g), g, out)
    return out


def run_stages(xin: torch.Tensor, kw: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor,
               g: Geometry, out: torch.Tensor) -> None:
    """The kernel's launches of one chain: xin the flat input (`to_flat`),
    (kw, kb, ka) from `kernel_params`, out the contiguous (N, H, W, C)
    result; one launch per stage, each counted in `conv_chain.launches`."""
    stages = kw.shape[0]
    bufs = [torch.empty_like(xin) for _ in range(min(2, stages - 1))]
    src = xin
    for s in range(stages):
        last = s == stages - 1
        dst = out if last else bufs[s % 2]
        _cuda.launch_stage(src, dst, xin, kw, kb, ka, g, s, last)
        conv_chain.launches += 1
        src = dst


conv_chain.launches = 0


def pack_chain(convs, dtype: torch.dtype = torch.bfloat16):
    """A sequence of the port's `ConvPReLU` (3x3, stride 1, C -> C; an
    `IFBlock.convblock`) -> packed (w (S, C, 9, C) in `dtype`, b (S, C) f32,
    a (S, C) f32) on the modules' device.  Pack once, not per call."""
    ws, bs, alphas = [], [], []
    for m in convs:
        wt = m.conv.weight.detach()
        cout, cin, kh, kw = wt.shape
        if (kh, kw) != (3, 3) or cin != cout or m.stride != 1 or m.conv.padding != (1, 1):
            raise ValueError(f"pack_chain takes 3x3 stride-1 C -> C convs, got "
                             f"{tuple(wt.shape)} stride {m.stride}")
        ws.append(wt.permute(0, 2, 3, 1).reshape(cout, 9, cin))
        bs.append(m.conv.bias.detach())
        alphas.append(m.alpha.detach())
    return (torch.stack(ws).to(dtype).contiguous(), torch.stack(bs).float().contiguous(),
            torch.stack(alphas).float().contiguous())


def chain_params_from_jax(params, dtype: torch.dtype = torch.bfloat16, device=None):
    """rife_tpu's list of `conv_prelu_params` dicts (numpy or JAX arrays:
    conv.w HWIO (3, 3, C, C), conv.b (C,), alpha (C,)) -> the packed form
    of `pack_chain`."""
    w = np.stack([np.asarray(p["conv"]["w"], np.float32).transpose(3, 0, 1, 2)
                  .reshape(-1, 9, np.shape(p["conv"]["w"])[2]) for p in params])
    b = np.stack([np.asarray(p["conv"]["b"], np.float32) for p in params])
    a = np.stack([np.asarray(p["alpha"], np.float32) for p in params])
    return (torch.from_numpy(np.ascontiguousarray(w)).to(device, dtype),
            torch.from_numpy(b).to(device), torch.from_numpy(a).to(device))
