"""Backward bilinear warp on (N, C, H, W) planes (the RIFE sampling primitive).

Port of rife_tpu/ops/warp.py.  `warp_planes(img, flow)` samples each
plane at (x + dx, y + dy) in pixels, clamped to [0, W-1] x [0, H-1],
with x1 = min(x0 + 1, W - 1) and y1 = min(y0 + 1, H - 1) (the reference's
grid_sample(align_corners=True, padding_mode="border") in pixel units).
Flow channels are [dx, dy]; a pair flow holds t->0 in [:, 0:2] and t->1
in [:, 2:4].  Coordinates are always f32, even for a bf16 flow; the blend
is computed in f32 and rounded once to the image's dtype.

`warp_planes` is differentiable in the image and the flow (a
`torch.autograd.Function`) and dispatches on the tensor's device: a CPU
tensor goes to the plain versions `warp_planes_ref` and
`warp_planes_bwd_ref`, a CUDA tensor to the hand-written kernels
(`ops/cuda/warp.py`), which launch or raise.

`warp2_blend_planes`, the final level's pair warp and sigmoid-mask blend,
takes the fused kernel (`ops/cuda/warp_blend.py`; plain version
`warp2_blend_planes_ref`) while `use_fuse_blend` is on, and the composed
pair warp plus a torch blend (`warp2_blend_composed`) while it is off.

`warp` and `warp2` are the same warp on NHWC tensors, (N, H, W, C) x
(N, H, W, 2) (rife_tpu.ops.warp's `warp`/`warp2`, which the legacy models
call): plain version `warp_ref` on CPU tensors, on CUDA tensors the
hand-written NHWC kernels (`ops/cuda/warp_nhwc.py`), `warp_nhwc_k3` for
C < 8 and `warp_nhwc_k4` for C >= 8, as rife_tpu's `warp_pallas_auto`
splits its f32 inputs.  Their gradient (`warp_nhwc_bwd`) is the plane
warp's on the permuted planes: `warp_planes_bwd_ref` on CPU tensors, K1's
gradient kernel on NCHW-contiguous copies on CUDA tensors (rife_tpu
differentiates `warp_xla` there, `warp_pallas_diff`; no kernel of its own).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from rife_tpu_torch.ops.cuda import warp as _cuda_warp
from rife_tpu_torch.ops.cuda import warp_blend as _cuda_blend
from rife_tpu_torch.ops.cuda import warp_nhwc as _cuda_nhwc


def to_planes(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW (contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous()


def from_planes(p: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC (contiguous)."""
    return p.permute(0, 2, 3, 1).contiguous()


def _sample(img: torch.Tensor, flow: torch.Tensor):
    """What the warp and its gradient share: the four flat tap indices
    (N, 1, H*W) each, the weights' fractions fx, fy (N, 1, H, W), and the
    masks of raw coordinates strictly inside the frame (N, H, W), in the
    compute type (f32, f64 for an f64 image)."""
    n, c, h, w = img.shape
    acc = torch.float64 if img.dtype == torch.float64 else torch.float32
    f = flow.to(acc)
    xs = torch.arange(w, device=img.device, dtype=acc).view(1, 1, w)
    ys = torch.arange(h, device=img.device, dtype=acc).view(1, h, 1)
    rawx = xs + f[:, 0]
    rawy = ys + f[:, 1]
    ix = rawx.clamp(0.0, w - 1)
    iy = rawy.clamp(0.0, h - 1)
    x0 = ix.floor()
    y0 = iy.floor()
    fx = (ix - x0).unsqueeze(1)
    fy = (iy - y0).unsqueeze(1)
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    lin = [(yi * w + xi).reshape(n, 1, h * w)
           for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i))]
    inx = (rawx > 0) & (rawx < w - 1)
    iny = (rawy > 0) & (rawy < h - 1)
    return lin, fx, fy, inx, iny


def _taps(img, lin, acc):
    """The four gathered taps (v00, v01, v10, v11), (N, C, H, W) in `acc`."""
    n, c, h, w = img.shape
    flat = img.reshape(n, c, h * w)
    return [torch.gather(flat, 2, i.expand(n, c, h * w)).reshape(n, c, h, w).to(acc)
            for i in lin]


def warp_planes_ref(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp: (N, C, H, W) x (N, 2, H, W) -> (N, C, H, W).

    The reference the kernel is held to, and the CPU path's forward."""
    lin, fx, fy, _, _ = _sample(img, flow)
    v00, v01, v10, v11 = _taps(img, lin, fx.dtype)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return (top * (1 - fy) + bot * fy).to(img.dtype)


def warp_planes_bwd_ref(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                        need_img: bool = True, need_flow: bool = True):
    """Plain PyTorch gradient of `warp_planes_ref` for the cotangent `g`
    -> (d_img or None, d_flow or None), written out (not autograd):

    - d_flow[:, 0] = sum_c g * ((v01 - v00)(1 - fy) + (v11 - v10) fy), and
      d_flow[:, 1] = sum_c g * ((v10 - v00)(1 - fx) + (v11 - v01) fx), each
      zeroed where the raw coordinate was clamped (strictly 0 < x + dx <
      W - 1, as rife_tpu's `_planes_diff_bwd`);
    - d_img = the adjoint of the 4-tap gather with the flow held constant
      (`scatter_add_`).

    Sums in f32 (f64 for f64 inputs), rounded once to the input's dtype.
    The CPU path's backward, and the reference the CUDA kernel is held to."""
    n, c, h, w = img.shape
    lin, fx, fy, inx, iny = _sample(img, flow)
    acc = fx.dtype
    gf = g.to(acc)
    gx, gy = 1 - fx, 1 - fy
    d_img = d_flow = None
    if need_flow:
        v00, v01, v10, v11 = _taps(img, lin, acc)
        dx = (gf * ((v01 - v00) * gy + (v11 - v10) * fy)).sum(1)
        dy = (gf * ((v10 - v00) * gx + (v11 - v01) * fx)).sum(1)
        d_flow = torch.stack([dx * inx, dy * iny], 1).to(flow.dtype)
    if need_img:
        flat = torch.zeros(n, c, h * w, dtype=acc, device=img.device)
        for i, wt in zip(lin, (gx * gy, fx * gy, gx * fy, fx * fy)):
            flat.scatter_add_(2, i.expand(n, c, h * w),
                              (gf * wt).reshape(n, c, h * w))
        d_img = flat.reshape(n, c, h, w).to(img.dtype)
    return d_img, d_flow


def _bwd_term_scale(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor):
    """For each output of `warp_planes_bwd_ref(img, flow, g)`, the sum of
    the magnitudes of its terms -> (d_img, d_flow) in f32: the scale of the
    error that summing in another order (channel runs, atomics) makes,
    which the kernel's checks hold it to."""
    lin, fx, fy, inx, iny = _sample(img, flow)
    v00, v01, v10, v11 = _taps(img, lin, torch.float32)
    ga = g.float().abs()
    mx = (ga * ((v01 - v00).abs() * (1 - fy) + (v11 - v10).abs() * fy)).sum(1)
    my = (ga * ((v10 - v00).abs() * (1 - fx) + (v11 - v01).abs() * fx)).sum(1)
    m_img, _ = warp_planes_bwd_ref(img.float(), flow.float(), ga, True, False)
    return m_img, torch.stack([mx * inx, my * iny], 1)


class _WarpPlanes(torch.autograd.Function):
    """`warp_planes` with its gradient: the plain versions on CPU tensors,
    the CUDA kernels on CUDA tensors.  Only `img` and `flow` are saved;
    the backward recomputes the taps."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        if img.device.type == "cpu":
            return warp_planes_ref(img, flow)
        out = _cuda_warp.launch(img, flow)
        warp_planes.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        need_img, need_flow = ctx.needs_input_grad
        return warp_planes_bwd(img, flow, g.to(img.dtype).contiguous(),
                               need_img, need_flow)


def warp_planes(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `img` (N, C, H, W) by `flow` (N, 2, H, W); differentiable in
    both.

    `warp_planes.launches` counts the forward kernel's launches (CUDA
    tensors only); `warp_planes_bwd.launches` the backward's."""
    return _WarpPlanes.apply(img, flow)


warp_planes.launches = 0


def warp_planes_bwd(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                    need_img: bool = True, need_flow: bool = True):
    """Gradient of `warp_planes` for the cotangent `g`: `warp_planes_bwd_ref`
    on CPU tensors, the CUDA kernel (`ops/cuda/warp.py`) on CUDA tensors,
    which launches or raises.  -> (d_img or None, d_flow or None)."""
    if img.device.type == "cpu":
        return warp_planes_bwd_ref(img, flow, g, need_img, need_flow)
    out = _cuda_warp.launch_bwd(img, flow, g, need_img, need_flow)
    warp_planes_bwd.launches += 1
    return out


warp_planes_bwd.launches = 0


def warp2_planes(img_a, img_b, flow_a, flow_b):
    """Warp an img0/img1 pair with one launch (batch-concatenated)."""
    n = img_a.shape[0]
    both = warp_planes(torch.cat([img_a, img_b], 0),
                       torch.cat([flow_a, flow_b], 0))
    return both[:n], both[n:]


# On by default: the fused final level won chip_smoke.py's interleaved
# A/B of both models' rung-1 requests on an H100 (PERF.md, section 6).
# rife_tpu ships its fusion off, because it lost its A/B on the TPU.
_FUSE_BLEND = contextvars.ContextVar("rife_tpu_torch_fuse_blend", default=True)


@contextlib.contextmanager
def use_fuse_blend(flag: bool):
    """Inside: `warp2_blend_planes` takes the fused kernel (True) or the
    composed ops (False).  A context variable, so a thread that sets it
    leaves every other thread's value as it was."""
    tok = _FUSE_BLEND.set(bool(flag))
    try:
        yield
    finally:
        _FUSE_BLEND.reset(tok)


def warp2_blend_composed(img_a, img_b, flow, mask):
    """Pair warp (one `warp2_planes` launch) and a torch blend with the
    sigmoid of `mask` -> (blend, w0, w1).  The switch's off route, and
    the formulation the fused route differentiates through."""
    w0, w1 = warp2_planes(img_a, img_b, flow[:, 0:2], flow[:, 2:4])
    sig = torch.sigmoid(mask)
    return w0 * sig + w1 * (1 - sig), w0, w1


def warp2_blend_planes_ref(img_a, img_b, flow, mask, need_pair: bool = True):
    """Plain PyTorch version of the fused kernel -> (blend, w0, w1) when
    need_pair, else blend, in the images' dtype.  w0 and w1 are
    `warp_planes_ref`'s; the sigmoid is taken in f32 and rounded to the
    images' dtype; the blend is computed in f32 and rounded once.  The
    reference the kernel is held to, and the CPU path's forward."""
    acc = torch.float64 if img_a.dtype == torch.float64 else torch.float32
    n = img_a.shape[0]
    both = warp_planes_ref(torch.cat([img_a, img_b], 0),
                           torch.cat([flow[:, 0:2], flow[:, 2:4]], 0))
    w0, w1 = both[:n], both[n:]
    sig = torch.sigmoid(mask.to(acc)).to(img_a.dtype).to(acc)
    blend = (w0.to(acc) * sig + w1.to(acc) * (1 - sig)).to(img_a.dtype)
    return (blend, w0, w1) if need_pair else blend


class _WarpBlend(torch.autograd.Function):
    """The fused pair warp + blend: the plain version on CPU tensors, the
    CUDA kernel on CUDA tensors.  The backward differentiates the composed
    formulation (`warp2_blend_composed`: the warp's gradient kernel on the
    card, autograd for the blend), as rife_tpu's `_wbp_bwd`/`_wbo_bwd` do."""

    @staticmethod
    def forward(ctx, img_a, img_b, flow, mask, need_pair):
        ctx.save_for_backward(img_a, img_b, flow, mask)
        ctx.need_pair = need_pair
        ctx.set_materialize_grads(False)
        if img_a.device.type == "cpu":
            return warp2_blend_planes_ref(img_a, img_b, flow, mask, need_pair)
        out = _cuda_blend.launch(img_a, img_b, flow, mask, need_pair)
        warp2_blend_planes.launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(nd) for t, nd in zip(ctx.saved_tensors, needs)]
            outs = warp2_blend_composed(*xs)[:3 if ctx.need_pair else 1]
            used = [(o, g.to(o.dtype)) for o, g in zip(outs, grads) if g is not None]
            wanted = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in used], wanted,
                                           [g for _, g in used], allow_unused=True)
                       if used else [None] * len(wanted))
        return (*(next(got) if nd else None for nd in needs), None)


def warp2_blend_planes(img_a, img_b, flow, mask, need_pair: bool = True):
    """Final-level pair warp and sigmoid-mask blend.

    flow: (N, 4, H, W), [:, 0:2] warps img_a and [:, 2:4] img_b; mask:
    (N, 1, H, W) pre-sigmoid.  Returns (blend, w0, w1) when need_pair,
    else blend.  Differentiable in all four inputs.  While
    `use_fuse_blend` is on (the default), one fused launch
    (`warp2_blend_planes.launches` counts it, CUDA tensors only);
    otherwise `warp2_blend_composed`, one `warp_planes` launch and the
    blend's elementwise kernels."""
    if _FUSE_BLEND.get():
        return _WarpBlend.apply(img_a.contiguous(), img_b.contiguous(),
                                flow.contiguous(), mask.contiguous(), need_pair)
    out = warp2_blend_composed(img_a, img_b, flow, mask)
    return out if need_pair else out[0]


warp2_blend_planes.launches = 0


def warp_ref(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch NHWC warp: (N, H, W, C) x (N, H, W, 2) -> contiguous
    (N, H, W, C) in the image's dtype, with rife_tpu's `warp_xla` semantics
    (border clamp, pixel units, f32 coordinates): `warp_planes_ref` on
    the permuted views, whatever the strides.  The reference K3 and K4 are
    held to, and the CPU path's warp."""
    out = warp_planes_ref(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).contiguous()


def warp_nhwc_k3(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors (C < 8 on the legacy models' path); counts its
    launches in `warp_nhwc_k3.launches`."""
    out = _cuda_nhwc.launch_k3(img, flow)
    warp_nhwc_k3.launches += 1
    return out


warp_nhwc_k3.launches = 0


def warp_nhwc_k4(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors (C >= 8); counts its launches in
    `warp_nhwc_k4.launches`."""
    out = _cuda_nhwc.launch_k4(img, flow)
    warp_nhwc_k4.launches += 1
    return out


warp_nhwc_k4.launches = 0


def warp_nhwc_bwd(img: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                  need_img: bool = True, need_flow: bool = True):
    """Gradient of the NHWC warp for the cotangent `g` (N, H, W, C) ->
    (d_img (N, H, W, C) or None, d_flow (N, H, W, 2) or None), in the
    dtypes of img and flow: `warp_planes_bwd` of the permuted planes, copied
    NCHW-contiguous (K1's gradient kernel takes no other strides; one
    launch, counted in `warp_planes_bwd.launches`).  The results are
    (N, H, W, C) views of NCHW memory."""
    planes = lambda t: t.permute(0, 3, 1, 2).contiguous()  # noqa: E731
    d_img, d_flow = warp_planes_bwd(planes(img), planes(flow), planes(g),
                                    need_img, need_flow)
    nhwc = lambda t: None if t is None else t.permute(0, 2, 3, 1)  # noqa: E731
    return nhwc(d_img), nhwc(d_flow)


class _WarpNHWC(torch.autograd.Function):
    """The NHWC warp: the plain version on CPU tensors, K3 (C < 8) or K4
    (C >= 8) on CUDA tensors.  The backward is `warp_nhwc_bwd`: the plain
    gradient on CPU tensors, K1's gradient kernel on CUDA tensors (which
    launches or raises)."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        if img.device.type == "cpu":
            return warp_ref(img, flow)
        return (warp_nhwc_k3 if img.shape[-1] < 8 else warp_nhwc_k4)(img, flow)

    @staticmethod
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        need_img, need_flow = ctx.needs_input_grad
        return warp_nhwc_bwd(img, flow, g.to(img.dtype), need_img, need_flow)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `img` (N, H, W, C) by `flow` (N, H, W, 2) -> contiguous
    (N, H, W, C) in the image's dtype.  On a CUDA tensor the channel
    stride of both must be 1 (channels-last); K3/K4 raise otherwise."""
    return _WarpNHWC.apply(img, flow)


def warp2(img_a, img_b, flow_a, flow_b):
    """Warp an img0/img1 pair of NHWC tensors with one launch
    (batch-concatenated)."""
    n = img_a.shape[0]
    both = warp(torch.cat([img_a, img_b], 0), torch.cat([flow_a, flow_b], 0))
    return both[:n], both[n:]
