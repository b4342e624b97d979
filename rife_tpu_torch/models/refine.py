"""Context pyramid and fusion U-Net (the refinement stage), on NCHW.

Port of rife_tpu/models/refine.py: the paper nets and the
half-resolution "2R" variant (`half_res`).  ContextNet extracts a 4-level
feature pyramid from an image and warps each level by the progressively
halved flow; UNet fuses images, warps, mask, flow and both pyramids into
a sigmoid residual image.  With `half_res`, ContextNet's conv1 runs at
stride 1 and its first warp takes the flow unscaled, and UNet's down0
runs at stride 1 and its last conv at stride 2 (reference refine_2R.py).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from rife_tpu_torch.nn import ConvPReLU, DeconvPReLU, conv2d
from rife_tpu_torch.ops import plane_down2, warp_planes

_C = 16  # base channel width (reference refine.py:35)


class Conv2Block(nn.Module):
    """Two ConvPReLU, the first with `stride` (reference refine.py Conv2)."""

    def __init__(self, cin: int, cout: int, stride: int = 2):
        super().__init__()
        self.conv1 = ConvPReLU(cin, cout, stride)
        self.conv2 = ConvPReLU(cout, cout, 1)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class ContextNet(nn.Module):
    def __init__(self, half_res: bool = False):
        super().__init__()
        self.half_res = half_res
        self.conv1 = Conv2Block(3, _C, 1 if half_res else 2)
        self.conv2 = Conv2Block(_C, 2 * _C)
        self.conv3 = Conv2Block(2 * _C, 4 * _C)
        self.conv4 = Conv2Block(4 * _C, 8 * _C)

    def forward(self, img, flow):
        """img (N, 3, H, W), flow (N, 2, H, W) -> 4 warped feature levels."""
        feats = []
        x = img
        for i, conv in enumerate((self.conv1, self.conv2, self.conv3, self.conv4)):
            x = conv(x)
            if i or not self.half_res:
                flow = plane_down2(flow) * 0.5
            feats.append(warp_planes(x, flow))
        return feats

    def forward_pair(self, img0, img1, flow0, flow1):
        """Both pyramids as one batch-concatenated pass, so each level's two
        warps are one launch (reference contextnet_apply_pair)."""
        n = img0.shape[0]
        feats = self(torch.cat([img0, img1], 0), torch.cat([flow0, flow1], 0))
        return [f[:n] for f in feats], [f[n:] for f in feats]


class UNet(nn.Module):
    def __init__(self, half_res: bool = False):
        super().__init__()
        self.half_res = half_res
        self.down0 = Conv2Block(17, 2 * _C, 1 if half_res else 2)
        self.down1 = Conv2Block(4 * _C, 4 * _C)
        self.down2 = Conv2Block(8 * _C, 8 * _C)
        self.down3 = Conv2Block(16 * _C, 16 * _C)
        self.up0 = DeconvPReLU(32 * _C, 8 * _C)
        self.up1 = DeconvPReLU(16 * _C, 4 * _C)
        self.up2 = DeconvPReLU(8 * _C, 2 * _C)
        self.up3 = DeconvPReLU(4 * _C, _C)
        self.conv = nn.Conv2d(_C, 3, 3, 1, 1)

    def forward(self, x17, c0, c1):
        """x17 = [img0, img1, warped0, warped1, mask, flow] (17 ch) ->
        sigmoid 3-channel residual."""
        cat = torch.cat
        s0 = self.down0(x17)
        s1 = self.down1(cat([s0, c0[0], c1[0]], 1))
        s2 = self.down2(cat([s1, c0[1], c1[1]], 1))
        s3 = self.down3(cat([s2, c0[2], c1[2]], 1))
        x = self.up0(cat([s3, c0[3], c1[3]], 1))
        x = self.up1(cat([x, s2], 1))
        x = self.up2(cat([x, s1], 1))
        x = self.up3(cat([x, s0], 1))
        return torch.sigmoid(conv2d(x, self.conv.weight, self.conv.bias,
                                    2 if self.half_res else 1))
