"""Ops on (N, C, H, W) planes: the warp (plain version and CUDA kernel),
the pyramid's resizes and frame padding; and the SSIM family on NHWC.

The NHWC warp of the legacy models is `rife_tpu_torch.ops.warp.warp`
(and `warp2`), and the 2-D SSIM `rife_tpu_torch.ops.ssim.ssim`; neither is
re-exported here, where the names `warp` and `ssim` are the submodules."""
from rife_tpu_torch.ops.pad import (Padding, pad_centered, pad_to_multiple,
                                    plan_pad_centered, plan_pad_to_multiple)
from rife_tpu_torch.ops.resize import (plane_down2, plane_down_int, plane_up,
                                       resize_bilinear, scale_by)
from rife_tpu_torch.ops.ssim import msssim, ssim_matlab
from rife_tpu_torch.ops.warp import (from_planes, to_planes, use_fuse_blend,
                                     warp2_blend_composed, warp2_blend_planes,
                                     warp2_blend_planes_ref,
                                     warp2_planes, warp_nhwc_k3, warp_nhwc_k4,
                                     warp_planes, warp_planes_bwd,
                                     warp_planes_bwd_ref, warp_planes_ref,
                                     warp_ref)

__all__ = [
    "Padding", "pad_centered", "pad_to_multiple", "plan_pad_centered",
    "plan_pad_to_multiple", "plane_down2", "plane_down_int", "plane_up",
    "resize_bilinear", "scale_by", "msssim", "ssim_matlab", "from_planes", "to_planes",
    "use_fuse_blend", "warp2_blend_composed",
    "warp2_blend_planes", "warp2_blend_planes_ref", "warp2_planes",
    "warp_nhwc_k3", "warp_nhwc_k4", "warp_planes", "warp_planes_bwd",
    "warp_planes_bwd_ref", "warp_planes_ref", "warp_ref",
]
