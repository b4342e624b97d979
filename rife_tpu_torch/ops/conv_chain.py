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
"""
from __future__ import annotations

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


def conv_chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """The chain on x (N, H, W, C) with packed parameters (w, b, a).

    CPU tensors: `conv_chain_ref`.  CUDA tensors: the kernel, one launch
    per stage (bf16 x and weights, f32 biases and slopes, x's channel
    stride 1), ping-ponging between the output and one scratch buffer so
    that the last stage lands in the output; `conv_chain.launches` counts
    the launches.  Anything else raises."""
    if x.device.type == "cpu":
        return conv_chain_ref(x, w, b, a)
    _check_params(x, w, b, a)
    _cuda.check(x, w, b, a)
    stages = w.shape[0]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    scratch = torch.empty_like(out) if stages > 1 else None
    vec = _cuda.vector_width(x, w)
    src = x
    for s in range(stages):
        dst = out if (stages - 1 - s) % 2 == 0 else scratch
        _cuda.launch_stage(src, x, w[s], b[s], a[s], dst, vec, s == stages - 1)
        conv_chain.launches += 1
        src = dst
    return out


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
