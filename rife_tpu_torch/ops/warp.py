"""Backward bilinear warp on (N, C, H, W) planes (the RIFE sampling primitive).

Port of rife_tpu/ops/warp.py.  `warp_planes(img, flow)` samples each
plane at (x + dx, y + dy) in pixels, clamped to [0, W-1] x [0, H-1],
with x1 = min(x0 + 1, W - 1) and y1 = min(y0 + 1, H - 1) (the reference's
grid_sample(align_corners=True, padding_mode="border") in pixel units).
Flow channels are [dx, dy]; a pair flow holds t->0 in [:, 0:2] and t->1
in [:, 2:4].  Coordinates are always f32, even for a bf16 flow; the blend
is computed in f32 and rounded once to the image's dtype.

`warp_planes` dispatches on the tensor's device: a CPU tensor goes to the
plain version `warp_planes_ref`, a CUDA tensor to the hand-written kernel
(`ops/cuda/warp.py`), which launches or raises.
"""
from __future__ import annotations

import torch

from rife_tpu_torch.ops.cuda import warp as _cuda_warp


def to_planes(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW (contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous()


def from_planes(p: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC (contiguous)."""
    return p.permute(0, 2, 3, 1).contiguous()


def warp_planes_ref(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp: (N, C, H, W) x (N, 2, H, W) -> (N, C, H, W).

    The reference the kernel is held to, and the CPU path."""
    n, c, h, w = img.shape
    f = flow.float()
    xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1)
    ix = (xs + f[:, 0]).clamp(0.0, w - 1)
    iy = (ys + f[:, 1]).clamp(0.0, h - 1)
    x0 = ix.floor()
    y0 = iy.floor()
    fx = (ix - x0).unsqueeze(1)
    fy = (iy - y0).unsqueeze(1)
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = img.reshape(n, c, h * w)

    def gather(yi, xi):
        lin = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        return torch.gather(flat, 2, lin).reshape(n, c, h, w).float()

    top = gather(y0i, x0i) * (1 - fx) + gather(y0i, x1i) * fx
    bot = gather(y1i, x0i) * (1 - fx) + gather(y1i, x1i) * fx
    return (top * (1 - fy) + bot * fy).to(img.dtype)


def warp_planes(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `img` (N, C, H, W) by `flow` (N, 2, H, W).

    `warp_planes.launches` counts the kernel launches (CUDA tensors only)."""
    if img.device.type == "cpu":
        return warp_planes_ref(img, flow)
    out = _cuda_warp.launch(img, flow)
    warp_planes.launches += 1
    return out


warp_planes.launches = 0


def warp2_planes(img_a, img_b, flow_a, flow_b):
    """Warp an img0/img1 pair with one launch (batch-concatenated)."""
    n = img_a.shape[0]
    both = warp_planes(torch.cat([img_a, img_b], 0),
                       torch.cat([flow_a, flow_b], 0))
    return both[:n], both[n:]


def warp2_blend_planes(img_a, img_b, flow, mask, need_pair: bool = True):
    """Final-level pair warp and sigmoid-mask blend, composed.

    flow: (N, 4, H, W) both directions; mask: (N, 1, H, W) pre-sigmoid.
    Returns (blend, w0, w1) when need_pair, else blend.  (The fused
    warp+blend kernel of the reference is off by default there and is
    not ported yet.)"""
    w0, w1 = warp2_planes(img_a, img_b, flow[:, 0:2], flow[:, 2:4])
    sig = torch.sigmoid(mask)
    blend = w0 * sig + w1 * (1 - sig)
    return (blend, w0, w1) if need_pair else blend
