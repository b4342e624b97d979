"""The legacy RIFE models `hdv2` (v2) and `hd` (v1), inference only.

Port of rife_tpu/models/legacy.py (`hdv2_apply`, `hd_apply`; reference
model/oldmodel/IFNet_HDv2.py + RIFE_HDv2.py and IFNet_HD.py + RIFE_HD.py).

- `HDv2`: 4 IFBlocks at scales 8/4/2/1 (c = 192/128/96/48, 2c inside),
  each emitting a 4-channel bidirectional flow residual at half its
  input's resolution; a ContextNet (c = 32 to 8c) whose features at 1/4 to
  1/32 are warped by the flow; a FusionNet U-Net over the warped pair,
  the flow and both context pyramids, ending in a transposed conv to a
  3-channel residual and a blend mask.
- `HD`: the same outline with squeeze-excite ResBlocks (`SEResBlock`), 5x5
  stems, PixelShuffle flow heads and a unidirectional 2-channel flow (img1
  is warped by -flow, each side by its own `warp`); the flownet runs on
  the pair downsampled by 0.5.  Its BatchNorms are folded into the convs
  when a checkpoint is loaded (`engine.checkpoint`).

`scale_list[0]` is the divisor d of the engine's convention (the
reference's `scale` knob is 1/d).  The models take no timestep.

Layout: activations are (N, C, H, W) tensors in `torch.channels_last`
memory from the input to the output, so cuDNN runs without layout
transposes and every warp reads an NHWC view (`x.permute(0, 2, 3, 1)`)
without a copy: the NHWC warp `ops.warp.warp` (K3 for C < 8, K4 for
C >= 8 on the card), as rife_tpu's models call `rife_tpu.ops.warp.warp`.
The inputs are made channels-last on entry (a no-op when they are).
Warp launches per forward: `hdv2` 4 K3 (block 1-3 pairs and the final
pair, N = 2B) + 8 K4 (both sides' context, 4 levels); `hd` 8 K3 (6 at
half resolution, 2 at full) + 8 K4.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from rife_tpu_torch.nn import (ConvPReLU, DeconvPReLU, SEResBlock, conv2d,
                               conv_transpose2d, pixel_shuffle)
from rife_tpu_torch.ops import scale_by
from rife_tpu_torch.ops.warp import warp, warp2


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _warp(x, flow):
    """`ops.warp.warp` on (N, C, H, W) tensors, through NHWC views."""
    return _nchw(warp(_nhwc(x), _nhwc(flow)))


def _warp2(a, b, flow_a, flow_b):
    """`ops.warp.warp2` on (N, C, H, W) tensors: one launch for the pair."""
    w0, w1 = warp2(_nhwc(a), _nhwc(b), _nhwc(flow_a), _nhwc(flow_b))
    return _nchw(w0), _nchw(w1)


def _fuse(warped0, warped1, refine) -> tuple:
    """The output head (RIFE_HDv2.py:188-193): a residual sigmoid * 2 - 1
    and a sigmoid blend mask from the 4 refine channels -> (mask, blend,
    the blend plus the residual clamped to [0, 1])."""
    res = torch.sigmoid(refine[:, :3]) * 2 - 1
    mask = torch.sigmoid(refine[:, 3:4])
    merged = warped0 * mask + warped1 * (1 - mask)
    return mask, merged, (merged + res).clamp(0.0, 1.0)


# --------------------------------------------------------------------------
# v2 ("hdv2")
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class HDv2Config:
    block_channels: tuple = (192, 128, 96, 48)
    block_scales: tuple = (8.0, 4.0, 2.0, 1.0)
    block_in: tuple = (6, 10, 10, 10)
    ctx_c: int = 32


class HDv2Block(nn.Module):
    """IFBlock (IFNet_HDv2.py:24-53): two stride-2 ConvPReLUs, 6 more, a
    k4s2 transposed conv to 4 flow channels at half the input's
    resolution."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv0 = nn.ModuleList([ConvPReLU(cin, c, 2), ConvPReLU(c, 2 * c, 2)])
        self.convblock = nn.ModuleList([ConvPReLU(2 * c, 2 * c) for _ in range(6)])
        self.conv1 = nn.ConvTranspose2d(2 * c, 4, 4, 2, 1)

    def forward(self, x, scale: float):
        if scale != 1:
            x = scale_by(x, 1.0 / scale)
        for m in (*self.conv0, *self.convblock):
            x = m(x)
        flow = conv_transpose2d(x, self.conv1.weight, self.conv1.bias)
        return scale_by(flow, scale) if scale != 1 else flow


class Conv2(nn.Module):
    """Two ConvPReLUs, the first of stride 2 (RIFE_HDv2.py Conv2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = ConvPReLU(cin, cout, 2)
        self.conv2 = ConvPReLU(cout, cout)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class HDv2ContextNet(nn.Module):
    """RIFE_HDv2.py:50-77: two stride-2 stages, then at each of 1/4 to
    1/32 the features warped by the flow (halved and rescaled per level)
    before the next stage."""

    def __init__(self, c: int):
        super().__init__()
        widths = [(3, c), (c, c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c)]
        for i, (ci, co) in enumerate(widths):
            self.add_module(f"conv{i}", Conv2(ci, co))

    def forward(self, img, flow_half):
        x = self.conv1(self.conv0(img))
        feats, flow = [], flow_half
        for name in ("conv2", "conv3", "conv4", None):
            flow = scale_by(flow, 0.5) * 0.5
            feats.append(_warp(x, flow))
            if name is not None:
                x = getattr(self, name)(x)
        return feats


class HDv2FusionNet(nn.Module):
    """RIFE_HDv2.py:80-120: the U-Net over (warped0, warped1, flow) and
    both context pyramids; a k4s2 transposed conv to 4 channels."""

    def __init__(self, c: int):
        super().__init__()
        for name, ci, co in (("conv0", 10, c), ("down0", c, 2 * c),
                             ("down1", 4 * c, 4 * c), ("down2", 8 * c, 8 * c),
                             ("down3", 16 * c, 16 * c)):
            self.add_module(name, Conv2(ci, co))
        self.up0 = DeconvPReLU(32 * c, 8 * c)
        self.up1 = DeconvPReLU(16 * c, 4 * c)
        self.up2 = DeconvPReLU(8 * c, 2 * c)
        self.up3 = DeconvPReLU(4 * c, c)
        self.conv = nn.ConvTranspose2d(c, 4, 4, 2, 1)

    def forward(self, warped0, warped1, flow, c0, c1):
        cat = torch.cat
        s = self.conv0(cat([warped0, warped1, flow], 1))
        s0 = self.down0(s)
        s1 = self.down1(cat([s0, c0[0], c1[0]], 1))
        s2 = self.down2(cat([s1, c0[1], c1[1]], 1))
        s3 = self.down3(cat([s2, c0[2], c1[2]], 1))
        u = self.up0(cat([s3, c0[3], c1[3]], 1))
        u = self.up1(cat([u, s2], 1))
        u = self.up2(cat([u, s1], 1))
        u = self.up3(cat([u, s0], 1))
        return conv_transpose2d(u, self.conv.weight, self.conv.bias)


class HDv2(nn.Module):
    """Full v2 inference (RIFE_HDv2.py:176-199; rife_tpu `hdv2_apply`)."""

    def __init__(self, cfg: HDv2Config = HDv2Config()):
        super().__init__()
        self.cfg = cfg
        for i, (cin, c) in enumerate(zip(cfg.block_in, cfg.block_channels)):
            self.add_module(f"block{i}", HDv2Block(cin, c))
        self.contextnet = HDv2ContextNet(cfg.ctx_c)
        self.fusionnet = HDv2FusionNet(cfg.ctx_c)

    def forward(self, img0, img1, scale_list=(1.0,)):
        """img0, img1: (N, 3, H, W), H and W multiples of 32 / scale.
        Returns flow_list (each block's accumulated (N, 4, H/2, W/2)
        flow), mask and merged [blend, output frame]."""
        cat = torch.cat
        img0, img1 = _cl(img0), _cl(img1)
        d = scale_list[0]
        x = cat([img0, img1], 1)
        xs = scale_by(x, 1.0 / d) if d != 1 else x
        flow = self.block0(xs, self.cfg.block_scales[0])
        flow_list = [flow]
        for i in (1, 2, 3):
            f_large = scale_by(flow, 2.0) * 2.0
            w0, w1 = _warp2(xs[:, :3], xs[:, 3:], f_large[:, 0:2], f_large[:, 2:4])
            res = getattr(self, f"block{i}")(cat([w0, w1, f_large], 1),
                                             self.cfg.block_scales[i])
            flow = flow + res
            flow_list.append(flow)
        if d != 1:
            flow = scale_by(flow, d) * d
            flow_list = [scale_by(f, d) * d for f in flow_list]

        c0 = self.contextnet(img0, flow[:, 0:2])
        c1 = self.contextnet(img1, flow[:, 2:4])
        flow_full = scale_by(flow, 2.0) * 2.0
        warped0, warped1 = _warp2(img0, img1, flow_full[:, 0:2], flow_full[:, 2:4])
        refine = self.fusionnet(warped0, warped1, flow_full, c0, c1)
        mask, merged, pred = _fuse(warped0, warped1, refine)
        return {"flow_list": flow_list, "mask": mask, "merged": [merged, pred]}


# --------------------------------------------------------------------------
# v1 ("hd")
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class HDConfig:
    block_channels: tuple = (192, 128, 96, 48)
    block_scales: tuple = (8.0, 4.0, 2.0, 1.0)
    block_in: tuple = (6, 8, 8, 8)  # later blocks see (w0, w1, flow2ch)
    ctx_c: int = 32


class HDBlock(nn.Module):
    """IFBlock (IFNet_HD.py:53-81): a 5x5 stride-2 stem, 6 SE ResBlocks,
    a 3x3 conv to 8 channels and PixelShuffle(2): a 2-channel flow at the
    input's resolution (interpolated, not rescaled, across the block's own
    resize)."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv0 = ConvPReLU(cin, c, 2, k=5)
        for i in range(6):
            self.add_module(f"res{i}", SEResBlock(c, c, 5, 1))
        self.conv1 = nn.Conv2d(c, 8, 3, 1, 1)

    def forward(self, x, scale: float):
        if scale != 1:
            x = scale_by(x, 1.0 / scale)
        x = self.conv0(x)
        for i in range(6):
            x = getattr(self, f"res{i}")(x)
        flow = pixel_shuffle(conv2d(x, self.conv1.weight, self.conv1.bias), 2)
        return scale_by(flow, scale) if scale != 1 else flow


class HDContextNet(nn.Module):
    """RIFE_HD.py:65-91: img at full resolution, flow at 1/2; the features
    at 1/4 to 1/32, each warped by the flow halved and rescaled."""

    def __init__(self, c: int):
        super().__init__()
        self.conv0 = ConvPReLU(3, c, 2)
        for i, (ci, co) in enumerate([(c, c), (c, 2 * c), (2 * c, 4 * c),
                                      (4 * c, 8 * c)]):
            self.add_module(f"conv{i + 1}", SEResBlock(ci, co, 3, 2))

    def forward(self, img, flow):
        x = self.conv0(img)
        feats = []
        for i in (1, 2, 3, 4):
            x = getattr(self, f"conv{i}")(x)
            flow = scale_by(flow, 0.5) * 0.5
            feats.append(_warp(x, flow))
        return feats


class HDFusionNet(nn.Module):
    """RIFE_HD.py:94-127: the U-Net with SE ResBlocks going down, a 3x3
    conv to 16 channels and PixelShuffle(2) at the end."""

    def __init__(self, c: int):
        super().__init__()
        self.conv0 = ConvPReLU(8, c, 2)
        for i, (ci, co) in enumerate([(c, 2 * c), (4 * c, 4 * c), (8 * c, 8 * c),
                                      (16 * c, 16 * c)]):
            self.add_module(f"down{i}", SEResBlock(ci, co, 3, 2))
        self.up0 = DeconvPReLU(32 * c, 8 * c)
        self.up1 = DeconvPReLU(16 * c, 4 * c)
        self.up2 = DeconvPReLU(8 * c, 2 * c)
        self.up3 = DeconvPReLU(4 * c, c)
        self.conv = nn.Conv2d(c, 16, 3, 1, 1)

    def forward(self, warped0, warped1, flow, c0, c1):
        cat = torch.cat
        h = self.conv0(cat([warped0, warped1, flow], 1))
        s0 = self.down0(h)
        s1 = self.down1(cat([s0, c0[0], c1[0]], 1))
        s2 = self.down2(cat([s1, c0[1], c1[1]], 1))
        s3 = self.down3(cat([s2, c0[2], c1[2]], 1))
        u = self.up0(cat([s3, c0[3], c1[3]], 1))
        u = self.up1(cat([u, s2], 1))
        u = self.up2(cat([u, s1], 1))
        u = self.up3(cat([u, s0], 1))
        return pixel_shuffle(conv2d(u, self.conv.weight, self.conv.bias), 2)


class HD(nn.Module):
    """Full v1 inference (RIFE_HD.py:192-214; rife_tpu `hd_apply`)."""

    def __init__(self, cfg: HDConfig = HDConfig()):
        super().__init__()
        self.cfg = cfg
        for i, (cin, c) in enumerate(zip(cfg.block_in, cfg.block_channels)):
            self.add_module(f"block{i}", HDBlock(cin, c))
        self.contextnet = HDContextNet(cfg.ctx_c)
        self.fusionnet = HDFusionNet(cfg.ctx_c)

    def forward(self, img0, img1, scale_list=(1.0,)):
        """img0, img1: (N, 3, H, W), H and W multiples of 32 / scale.
        Returns flow_list (each block's accumulated (N, 2, H/2, W/2)
        flow), mask and merged [blend, output frame]."""
        cat = torch.cat
        img0, img1 = _cl(img0), _cl(img1)
        s = 1.0 / scale_list[0]
        x = scale_by(cat([img0, img1], 1), 0.5 * s)
        flow = self.block0(x, self.cfg.block_scales[0])
        flow_list = [flow]
        for i in (1, 2, 3):
            # Unidirectional: +flow warps img0, -flow img1, one launch each.
            w0 = _warp(x[:, :3], flow)
            w1 = _warp(x[:, 3:], -flow)
            res = getattr(self, f"block{i}")(cat([w0, w1, flow], 1),
                                             self.cfg.block_scales[i])
            flow = flow + res
            flow_list.append(flow)
        if s != 1:
            flow = scale_by(flow, 1.0 / s) / s
            flow_list = [scale_by(f, 1.0 / s) / s for f in flow_list]

        c0 = self.contextnet(img0, flow)
        c1 = self.contextnet(img1, -flow)
        flow_full = scale_by(flow, 2.0) * 2.0
        warped0 = _warp(img0, flow_full)
        warped1 = _warp(img1, -flow_full)
        refine = self.fusionnet(warped0, warped1, flow_full, c0, c1)
        mask, merged, pred = _fuse(warped0, warped1, refine)
        return {"flow_list": flow_list, "mask": mask, "merged": [merged, pred]}
