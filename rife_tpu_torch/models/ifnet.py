"""IFNet (paper model): coarse-to-fine intermediate flow estimation, NCHW.

Port of rife_tpu/models/ifnet.py, the whole family:

- variant "rife": the paper IFNet; variant "rife_m": a constant timestep
  plane concatenated into every block input (reference IFNet_m);
- `half_res`, the "2R" contract: each block's first conv runs at stride 1
  and its output upsamples by `s` instead of `2s` (reference IFNet_2R);
- any scale list: even-integer levels take the fixed 2-tap resizes
  (`plane_down_int`, `plane_up`), x0.5 the exact 2x2 mean, every other
  factor the general bilinear resize `scale_by`;
- the inference ladder: rung 1 `fast_level0` (the next block's input is
  built at its working resolution, so the level before it needs no
  full-resolution warp), rung 2 `fast_refine` (the refine stage one
  octave down), rung 3 the engine's scale list (4, 2, 2), rung 4
  `refine` off (a blend with no residual and no clamp);
- the teacher/distillation branch that training runs when `gt` is given
  (which always takes the exact graph).

Flow planes are (N, 4, H, W) in output-resolution pixels, [:, 0:2] =
t->0 and [:, 2:4] = t->1; the mask logit accumulates across levels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from rife_tpu_torch.models.refine import ContextNet, UNet
from rife_tpu_torch.nn import ConvPReLU, conv_transpose2d
from rife_tpu_torch.ops import (plane_down2, plane_down_int, plane_up,
                                scale_by, warp2_blend_planes, warp2_planes)


@dataclass(frozen=True)
class IFNetConfig:
    variant: str = "rife"  # "rife" | "rife_m"
    half_res: bool = False  # the "2R" stride/upsample contract
    block_channels: tuple = (240, 150, 90)
    teacher_channels: int = 90
    refine: bool = True  # the context pyramid + U-Net residual stage
    # Inference only, not exact (the module docstring's rungs 1 and 2).
    fast_level0: bool = False
    fast_refine: bool = False

    @property
    def timestep_plane(self) -> bool:
        return self.variant == "rife_m"

    @property
    def block_in(self) -> tuple:
        # block0 sees (img0, img1 [, t]); later blocks add 2 warps + mask + 4 flow.
        t = 1 if self.timestep_plane else 0
        return (6 + t, 17 + t, 17 + t)

    @property
    def teacher_in(self) -> int:
        # (img0, img1 [, t], 2 warps, mask, gt) + 4 flow.
        return 20 + (1 if self.timestep_plane else 0)


class IFBlock(nn.Module):
    """Stem (two ConvPReLU, the first of stride 2, or 1 under `half_res`)
    + 8 ConvPReLU + k4s2 deconv to 5 ch."""

    def __init__(self, cin: int, c: int, half_res: bool = False):
        super().__init__()
        self.conv0 = nn.ModuleList([ConvPReLU(cin, c // 2, 1 if half_res else 2),
                                    ConvPReLU(c // 2, c, 2)])
        self.convblock = nn.ModuleList([ConvPReLU(c, c) for _ in range(8)])
        self.lastconv = nn.ConvTranspose2d(c, 5, 4, 2, 1)

    def forward(self, x):
        """Working-resolution input -> raw 5-channel output at half of it,
        or at it under `half_res` (reference ifblock_conv_core)."""
        x = self.conv0[1](self.conv0[0](x))
        y = x
        for conv in self.convblock:
            y = conv(y)
        return conv_transpose2d(y + x, self.lastconv.weight, self.lastconv.bias)


def _is_even_int(s) -> bool:
    return float(s) == int(s) and int(s) % 2 == 0


def _down(p, s):
    """x(1/s) of planes at a level after block0: x0.5 is the exact 2x2 mean,
    other even factors the 2-tap, any other factor the general resize
    (reference ifnet_apply's choices)."""
    if s == 1:
        return p
    if s == 2:
        return plane_down2(p)
    return plane_down_int(p, int(s)) if _is_even_int(s) else scale_by(p, 1.0 / s)


class IFNet(nn.Module):
    def __init__(self, cfg: IFNetConfig = IFNetConfig()):
        super().__init__()
        self.cfg = cfg
        for i, (cin, c) in enumerate(zip(cfg.block_in, cfg.block_channels)):
            self.add_module(f"block{i}", IFBlock(cin, c, cfg.half_res))
        self.block_tea = IFBlock(cfg.teacher_in, cfg.teacher_channels, cfg.half_res)
        # Without the refine stage the reference's tree has no such keys.
        self.contextnet = ContextNet(cfg.half_res) if cfg.refine else None
        self.unet = UNet(cfg.half_res) if cfg.refine else None

    def _block_out(self, i, x, s):
        """Run block i; return its flow and mask residuals upsampled to
        full resolution (integer factors by `plane_up`, others by the
        general resize)."""
        up = s if self.cfg.half_res else s * 2
        tmp = getattr(self, f"block{i}")(x)
        if up != 1:
            tmp = plane_up(tmp, int(up)) if float(up) == int(up) else scale_by(tmp, up)
        return tmp[:, :4] * up, tmp[:, 4:5]

    def forward(self, img0, img1, scale_list=(4.0, 2.0, 1.0), timestep=0.5,
                gt=None, refine=None):
        """img0, img1: (N, 3, H, W) planes, H and W multiples of the pad
        granularity; timestep: a scalar or an (N,) tensor, read by `rife_m`
        only (cast to the images' dtype, then broadcast to a plane); gt:
        the (N, 3, H, W) middle frame, which turns on the teacher and the
        distillation loss (reference ifnet_apply); refine: overrides the
        config's.  Returns flow_list, mask_list (sigmoid) and merged, each
        a list of 3 (N, C, H, W) tensors, and flow_teacher, merged_teacher
        and the scalar loss_distill (all three None without gt)."""
        cfg, cat = self.cfg, torch.cat
        do_refine = cfg.refine if refine is None else refine
        tplane = None
        if cfg.timestep_plane:
            n, _, h, w = img0.shape
            t = torch.as_tensor(timestep, device=img0.device).to(img0.dtype)
            tplane = t.reshape(-1, 1, 1, 1).expand(n, 1, h, w)
        tparts = [] if tplane is None else [tplane]
        # The fast rungs serve inference only: with gt, the exact graph.
        # The 2R contract has neither.
        fast0 = (cfg.fast_level0 and gt is None and not cfg.half_res
                 and scale_list[1] != 1)
        fast1 = fast0 and scale_list[2] != 1
        fastr = cfg.fast_refine and gt is None and not cfg.half_res
        flow_list, mask_list, merged = [], [], []
        for i, s in enumerate(scale_list):
            if i == 0:
                # The reference downsamples block0's input with the 2-tap
                # form even for s == 2.
                x = cat([img0, img1, *tparts], 1)
                if _is_even_int(s):
                    x = plane_down_int(x, int(s))
                elif s != 1:
                    x = scale_by(x, 1.0 / s)
                flow, mask = self._block_out(0, x, s)
            elif (fast0 and i == 1) or (fast1 and i == 2):
                # Build this block's input at its working resolution: warp
                # the downsampled images by the downsampled flow.
                img0s, img1s = _down(img0, s), _down(img1, s)
                flow_s = _down(flow, s) * (1.0 / s)
                mask_s = _down(mask, s)
                w0s, w1s = warp2_planes(img0s, img1s, flow_s[:, 0:2],
                                        flow_s[:, 2:4])
                ts = [] if tplane is None else [scale_by(tplane, 1.0 / s)]
                x = cat([img0s, img1s, *ts, w0s, w1s, mask_s, flow_s], 1)
                flow_d, mask_d = self._block_out(i, x, s)
                flow, mask = flow + flow_d, mask + mask_d
            else:
                stack = _down(cat([img0, img1, *tparts, w0, w1, mask], 1), s)
                fl = _down(flow, s) * (1.0 / s) if s != 1 else flow
                flow_d, mask_d = self._block_out(i, cat([stack, fl], 1), s)
                flow, mask = flow + flow_d, mask + mask_d
            mask_list.append(torch.sigmoid(mask))
            flow_list.append(flow)
            if i == 2 and gt is None:
                # Inference: the pair warp and the blend in one launch while
                # `use_fuse_blend` is on, w0 and w1 stored only where the
                # full-resolution U-Net reads them.  Training (with gt) takes
                # the composed pair warp and blend below, as rife_tpu does.
                need_pair = do_refine and not fastr
                out = warp2_blend_planes(img0, img1, flow, mask, need_pair)
                if need_pair:
                    out, w0, w1 = out
                merged.append(out)
                continue
            if (fast0 and i == 0) or (fast1 and i == 1):
                # Consumed only by the next block, which warps at its own
                # resolution: merged[i] blends the unwarped pair.
                a, b = img0, img1
            else:
                w0, w1 = warp2_planes(img0, img1, flow[:, 0:2], flow[:, 2:4])
                a, b = w0, w1
            merged.append(a * mask_list[i] + b * (1 - mask_list[i]))

        flow_teacher = merged_teacher = loss_distill = None
        if gt is not None:
            flow_teacher, merged_teacher = self._teacher(
                cat([img0, img1, *tparts, w0, w1, mask, gt, flow], 1),
                img0, img1, mask, flow)
            loss_distill = _distill(merged, flow_list, gt, flow_teacher,
                                    merged_teacher)

        if do_refine:
            if fastr:
                # The refine stage one octave down; res * 2 - 1 is affine, so
                # it commutes with the upsample of the residual.
                img0, img1 = plane_down2(img0), plane_down2(img1)
                flow, mask = plane_down2(flow) * 0.5, plane_down2(mask)
                w0, w1 = warp2_planes(img0, img1, flow[:, 0:2], flow[:, 2:4])
            c0, c1 = self.contextnet.forward_pair(img0, img1, flow[:, 0:2],
                                                  flow[:, 2:4])
            res = self.unet(cat([img0, img1, w0, w1, mask, flow], 1), c0, c1)
            if fastr:
                res = plane_up(res, 2)
            merged[2] = torch.clamp(merged[2] + (res * 2 - 1), 0.0, 1.0)
        return {"flow_list": flow_list, "mask_list": mask_list,
                "merged": merged, "flow_teacher": flow_teacher,
                "merged_teacher": merged_teacher, "loss_distill": loss_distill}

    def _teacher(self, x, img0, img1, mask, flow):
        """The privileged teacher block at full resolution (reference
        ifblock_apply at scale 1) on its input `x`: its output comes back
        up through the general bilinear resize (not under `half_res`), as
        in the reference, and the teacher's flow warps the pair once more."""
        up = 1.0 if self.cfg.half_res else 2.0
        tmp = self.block_tea(x)
        if up != 1:
            tmp = scale_by(tmp, up)
        # Summed in f32 whatever the compute dtype: in bf16 a residual below
        # half an ulp of the flow vanishes in the sum, the teacher's flow
        # then equals the student's at that pixel, and the distillation's
        # sqrt at 0 gives a NaN gradient to every block (rife_tpu's bf16
        # step does so on the CPU; its TPU run trained, presumably because
        # XLA kept the sum and the difference in f32 inside one fusion).
        # The warp takes the f32 flow as it is.
        flow_teacher = flow.float() + tmp[:, :4].float() * up
        w0t, w1t = warp2_planes(img0, img1, flow_teacher[:, 0:2],
                                flow_teacher[:, 2:4])
        mask_teacher = torch.sigmoid(mask + tmp[:, 4:5])
        return flow_teacher, w0t * mask_teacher + w1t * (1 - mask_teacher)


def _distill(merged, flow_list, gt, flow_teacher, merged_teacher):
    """Privileged distillation (reference IFNet.py:100-102): supervise each
    level's flow by the teacher's where the teacher reconstructs gt better
    by more than 0.01.  The mask and the teacher's flow carry no gradient.
    The distances are taken in the teacher flow's f32.  (Where a level's
    flow equals the teacher's exactly, sqrt's gradient at 0 is NaN, as in
    the reference.)"""
    err_t = (merged_teacher - gt).abs().mean(1, keepdim=True)
    ft = flow_teacher.detach()
    total = 0.0
    for m, f in zip(merged, flow_list):
        err_s = (m - gt).abs().mean(1, keepdim=True)
        loss_mask = (err_s > err_t + 0.01).to(ft.dtype).detach()
        dist = ((ft - f.to(ft.dtype)) ** 2).mean(1, keepdim=True).sqrt()
        total = total + (dist * loss_mask).mean()
    return total
