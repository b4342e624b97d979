"""IFNet (paper model): coarse-to-fine intermediate flow estimation, NCHW.

Port of rife_tpu/models/ifnet.py, variant "rife".  Ported: the student
loop of the exact graph (rung 0) and of fast rung 1 (`fast_level0`: the
level-1 block input is built at its working resolution, so level 0
needs no full-resolution warp), for scale lists of 1 and even integers,
and the refine stage.  Not ported yet (ROADMAP A4): `rife_m`, the "2R"
half-resolution variant, rungs 2-4 and the teacher/distillation branch
(`gt`).  Flow planes are (N, 4, H, W) in output-resolution pixels,
[:, 0:2] = t->0 and [:, 2:4] = t->1; the mask logit accumulates across
levels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from rife_tpu_torch.models.refine import ContextNet, UNet
from rife_tpu_torch.nn import ConvPReLU, conv_transpose2d
from rife_tpu_torch.ops import (plane_down2, plane_down_int, plane_up,
                                warp2_blend_planes, warp2_planes)

_TODO = "not ported yet (ROADMAP.md, queue A item 4)"


@dataclass(frozen=True)
class IFNetConfig:
    block_channels: tuple = (240, 150, 90)
    # Fast rung 1 (inference only, not exact): see the module docstring.
    fast_level0: bool = False


# block0 sees (img0, img1); later blocks add 2 warps + mask + 4 flow.
_BLOCK_IN = (6, 17, 17)


class IFBlock(nn.Module):
    """Stem (two stride-2 ConvPReLU) + 8 ConvPReLU + k4s2 deconv to 5 ch."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv0 = nn.ModuleList([ConvPReLU(cin, c // 2, 2),
                                    ConvPReLU(c // 2, c, 2)])
        self.convblock = nn.ModuleList([ConvPReLU(c, c) for _ in range(8)])
        self.lastconv = nn.ConvTranspose2d(c, 5, 4, 2, 1)

    def forward(self, x):
        """Working-resolution input -> raw 5-channel output at half of it
        (reference ifblock_conv_core)."""
        x = self.conv0[1](self.conv0[0](x))
        y = x
        for conv in self.convblock:
            y = conv(y)
        return conv_transpose2d(y + x, self.lastconv.weight, self.lastconv.bias)


def _is_even_int(s) -> bool:
    return float(s) == int(s) and int(s) % 2 == 0


def _check_scale(s) -> None:
    if s != 1 and not _is_even_int(s):
        raise NotImplementedError(f"scale {s}: only 1 and even integers are "
                                  f"ported; the general resize path is {_TODO}")


def _down(p, s):
    """x(1/s) of planes at a level after block0: x0.5 is the exact 2x2 mean,
    other even factors the 2-tap (reference ifnet_apply's choices)."""
    if s == 1:
        return p
    return plane_down2(p) if s == 2 else plane_down_int(p, int(s))


class IFNet(nn.Module):
    def __init__(self, cfg: IFNetConfig = IFNetConfig()):
        super().__init__()
        self.cfg = cfg
        for i, (cin, c) in enumerate(zip(_BLOCK_IN, cfg.block_channels)):
            self.add_module(f"block{i}", IFBlock(cin, c))
        self.contextnet = ContextNet()
        self.unet = UNet()

    def _block_out(self, i, x, s):
        """Run block i; return its flow and mask residuals upsampled to
        full resolution."""
        tmp = plane_up(getattr(self, f"block{i}")(x), int(s * 2))
        return tmp[:, :4] * (s * 2), tmp[:, 4:5]

    def forward(self, img0, img1, scale_list=(4.0, 2.0, 1.0), gt=None):
        """img0, img1: (N, 3, H, W) planes, H and W multiples of the pad
        granularity.  Returns flow_list, mask_list (sigmoid) and merged,
        each a list of 3 (N, C, H, W) tensors."""
        if gt is not None:
            raise NotImplementedError(f"the teacher/distillation branch is {_TODO}")
        for s in scale_list:
            _check_scale(s)
        cat = torch.cat
        fast0 = self.cfg.fast_level0 and scale_list[1] != 1
        fast1 = fast0 and scale_list[2] != 1
        flow_list, mask_list, merged = [], [], []
        for i, s in enumerate(scale_list):
            if i == 0:
                # The reference downsamples block0's input with the 2-tap
                # form even for s == 2.
                x = cat([img0, img1], 1)
                if s != 1:
                    x = plane_down_int(x, int(s))
                flow, mask = self._block_out(0, x, s)
            elif (fast0 and i == 1) or (fast1 and i == 2):
                # Build this block's input at its working resolution: warp
                # the downsampled images by the downsampled flow.
                img0s, img1s = _down(img0, s), _down(img1, s)
                flow_s = _down(flow, s) * (1.0 / s)
                mask_s = _down(mask, s)
                w0s, w1s = warp2_planes(img0s, img1s, flow_s[:, 0:2],
                                        flow_s[:, 2:4])
                x = cat([img0s, img1s, w0s, w1s, mask_s, flow_s], 1)
                flow_d, mask_d = self._block_out(i, x, s)
                flow, mask = flow + flow_d, mask + mask_d
            else:
                stack = _down(cat([img0, img1, w0, w1, mask], 1), s)
                fl = _down(flow, s) * (1.0 / s) if s != 1 else flow
                flow_d, mask_d = self._block_out(i, cat([stack, fl], 1), s)
                flow, mask = flow + flow_d, mask + mask_d
            mask_list.append(torch.sigmoid(mask))
            flow_list.append(flow)
            if i == 2:
                blend, w0, w1 = warp2_blend_planes(img0, img1, flow, mask)
                merged.append(blend)
                continue
            if (fast0 and i == 0) or (fast1 and i == 1):
                # Consumed only by the next block, which warps at its own
                # resolution: merged[i] blends the unwarped pair.
                a, b = img0, img1
            else:
                w0, w1 = warp2_planes(img0, img1, flow[:, 0:2], flow[:, 2:4])
                a, b = w0, w1
            merged.append(a * mask_list[i] + b * (1 - mask_list[i]))

        c0, c1 = self.contextnet.forward_pair(img0, img1, flow[:, 0:2],
                                              flow[:, 2:4])
        res = self.unet(cat([img0, img1, w0, w1, mask, flow], 1), c0, c1)
        merged[2] = torch.clamp(merged[2] + (res * 2 - 1), 0.0, 1.0)
        return {"flow_list": flow_list, "mask_list": mask_list,
                "merged": merged}
