"""RIFE v4.25 ("HDv3"), the Practical-RIFE network, on (N, C, H, W) planes.

Port of rife_tpu/models/v425.py (`v425_apply`, fastmode inference;
reference train_log/IFNet_HDv3.py).  Against the paper model:

- a `Head` encoder (3 convs + a k4s2 deconv -> 4 feature channels), run
  once over the batch-concatenated pair; each later block also sees the
  encoder features warped by the current flow;
- 5 blocks (c = 192/128/96/64/32) over the scale list (16, 8, 4, 2, 1);
  a block's conv stack is 8 ResConvs (conv * beta + x) with LeakyReLU 0.2,
  and its head a deconv to 52 channels + PixelShuffle(2) -> 13 channels:
  4 flow, 1 mask, 8 features carried to the next level;
- an always-on timestep plane; the mask is *replaced* per level (not
  accumulated); no context net or U-Net: the output is the final level's
  sigmoid-mask blend of the two warps (`warp2_blend_planes`, blend only).

Images and features are warped together as one 7-channel plane pair
([img | feat] per side), one warp launch per level.  Each block's input
is concatenated in the reference's natural order [w0, w1, wf0, wf1, t,
mask, feat, flow], so the stem weights are used as stored (rife_tpu
permutes them to absorb a TPU packing, `_perm_stem`; the outputs are the
same).  `fast_level0` (rung 1, inference only, approximate) warps each
level with s != 1 at its working resolution 1/s instead of warping at
full resolution and downsampling.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from rife_tpu_torch.nn import conv2d, conv_transpose2d, leaky_relu, pixel_shuffle
from rife_tpu_torch.ops import (plane_down_int, plane_up, warp2_blend_planes,
                                warp_planes)


@dataclass(frozen=True)
class V425Config:
    block_channels: tuple = (192, 128, 96, 64, 32)
    fast_level0: bool = False

    @property
    def block_in(self) -> tuple:
        # block0: img0, img1 (6) + f0, f1 (8) + t (1); later: the warped
        # images (6) and features (8), t, mask, feat (8) and flow (4).
        return (15,) + (28,) * (len(self.block_channels) - 1)


class Head(nn.Module):
    """Feature encoder: 3 convs (the first of stride 2) with LeakyReLU, then
    a k4s2 deconv to 4 channels at the input resolution."""

    def __init__(self):
        super().__init__()
        self.cnn0 = nn.Conv2d(3, 16, 3, 2, 1)
        self.cnn1 = nn.Conv2d(16, 16, 3, 1, 1)
        self.cnn2 = nn.Conv2d(16, 16, 3, 1, 1)
        self.cnn3 = nn.ConvTranspose2d(16, 4, 4, 2, 1)

    def forward(self, x):
        x = leaky_relu(conv2d(x, self.cnn0.weight, self.cnn0.bias, 2))
        x = leaky_relu(conv2d(x, self.cnn1.weight, self.cnn1.bias))
        x = leaky_relu(conv2d(x, self.cnn2.weight, self.cnn2.bias))
        return conv_transpose2d(x, self.cnn3.weight, self.cnn3.bias)


class ResConv(nn.Module):
    """x -> lrelu(conv(x) * beta + x); beta (C,) in the activation's dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)
        self.beta = nn.Parameter(torch.ones(c))

    def forward(self, x):
        y = conv2d(x, self.conv.weight, self.conv.bias)
        return leaky_relu(y * self.beta.to(x.dtype).view(1, -1, 1, 1) + x)


class V425Block(nn.Module):
    """Two stride-2 stem convs, 8 ResConvs, a deconv to 52 channels and
    PixelShuffle(2): 13 channels at the input resolution."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv0 = nn.ModuleList([nn.Conv2d(cin, c // 2, 3, 2, 1),
                                    nn.Conv2d(c // 2, c, 3, 2, 1)])
        self.convblock = nn.ModuleList([ResConv(c) for _ in range(8)])
        self.lastconv = nn.ConvTranspose2d(c, 4 * 13, 4, 2, 1)

    def forward(self, x):
        for conv in self.conv0:
            x = leaky_relu(conv2d(x, conv.weight, conv.bias, 2))
        for rc in self.convblock:
            x = rc(x)
        return pixel_shuffle(conv_transpose2d(x, self.lastconv.weight,
                                              self.lastconv.bias), 2)


def _level_scale(s) -> int:
    if float(s) != int(s) or (int(s) != 1 and int(s) % 2):
        raise ValueError(f"v4.25 takes scales of 1 or even integers, got {s}")
    return int(s)


class V425(nn.Module):
    def __init__(self, cfg: V425Config = V425Config()):
        super().__init__()
        self.cfg = cfg
        for i, (cin, c) in enumerate(zip(cfg.block_in, cfg.block_channels)):
            self.add_module(f"block{i}", V425Block(cin, c))
        self.encode = Head()

    def forward(self, img0, img1, timestep=0.5,
                scale_list=(16.0, 8.0, 4.0, 2.0, 1.0)):
        """img0, img1: (N, 3, H, W) planes, H and W multiples of the pad
        granularity; timestep: a float or a per-pair (N,) tensor.  Returns
        flow_list (each level's (N, 4, H, W) flow), mask (the last level's
        pre-sigmoid mask) and merged: per level the (w0, w1) warps the next
        level consumed, or None where it warped at its own resolution
        (rung 1) and at the last level, whose entry is the output frame."""
        cat = torch.cat
        n, _, h, w = img0.shape
        t = torch.as_tensor(timestep, dtype=img0.dtype, device=img0.device)
        t = t.reshape(-1, 1, 1, 1).expand(n, 1, h, w)
        pair = cat([img0, img1], 0)
        feats = self.encode(pair)  # one encoder pass over both frames
        f0, f1 = feats[:n], feats[n:]
        srcs = cat([pair, feats], 1)  # (2N, 7): [img | feat] per side
        fast = self.cfg.fast_level0

        def pair_warp(src, fl):
            """Warp both sides' [img | feat] by the pair flow: one launch."""
            return warp_planes(src, cat([fl[:, 0:2], fl[:, 2:4]], 0))

        def ordered(wp):
            """The two sides' warps in the natural order [w0, w1, wf0, wf1]."""
            return [wp[:n, :3], wp[n:, :3], wp[:n, 3:], wp[n:, 3:]]

        flow = mask = feat = wp = None
        flow_list, merged = [], []
        nlev = len(scale_list)
        for i, s in enumerate(scale_list):
            s = _level_scale(s)
            if flow is None:
                x = plane_down_int(cat([img0, img1, f0, f1, t], 1), s)
            elif fast and s != 1:
                # Warp the downsampled inputs at the block's resolution.
                fl = plane_down_int(flow, s) * (1.0 / s)
                wps = pair_warp(plane_down_int(srcs, s), fl)
                rest = plane_down_int(cat([t, mask, feat], 1), s)
                x = cat([*ordered(wps), rest, fl.to(rest.dtype)], 1)
            else:
                fl = plane_down_int(flow, s) * (1.0 / s) if s != 1 else flow
                x = plane_down_int(cat([*ordered(wp), t, mask, feat], 1), s)
                x = cat([x, fl.to(x.dtype)], 1)
            tmp = plane_up(getattr(self, f"block{i}")(x), s)
            flow = tmp[:, :4] * s if flow is None else flow + tmp[:, :4] * s
            mask, feat = tmp[:, 4:5], tmp[:, 5:]
            flow_list.append(flow)
            if i + 1 == nlev:
                merged.append(warp2_blend_planes(img0, img1, flow, mask,
                                                 need_pair=False))
            elif not fast or _level_scale(scale_list[i + 1]) == 1:
                # The next level reads full-resolution warps of the images
                # and the features by this flow.
                wp = pair_warp(srcs, flow)
                merged.append((wp[:n, :3], wp[n:, :3]))
            else:
                merged.append(None)
        return {"flow_list": flow_list, "mask": mask, "merged": merged}
