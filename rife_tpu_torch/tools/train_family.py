"""What the training checks of every preset share: chip_smoke.py's phase
16 trains these on the card, and tests/test_torch_train_{objectives,hdv2,
hd,resume}.py hold the same weights and counts against rife_tpu on the CPU.

`TRAIN_FAMILY_LAUNCHES` is each preset's launches per training step
(forward and backward) of K1, K1's gradient, K2, K3 and K4, as the CPU
tests count the plain versions.  The paper family trains through the
composed final level (8 pair warps, each with its gradient); v4.25's final
level is K2 (blend only), whose backward recomputes the composed pair (one
more K1 and its gradient); the legacy models' NHWC warps (K3 for C < 8, K4
for C >= 8) each take one gradient launch of K1's kernel.
"""
from __future__ import annotations

import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT_V425 = os.path.join(ROOT, "train_log_r5_v425", "flownet.rtpu")

TRAIN_FAMILY_LAUNCHES = {
    "rife_m": {"warp_planes": 8, "warp_planes_bwd": 8, "warp_blend": 0,
               "warp_nhwc_k3": 0, "warp_nhwc_k4": 0},
    "rife_2r": {"warp_planes": 8, "warp_planes_bwd": 8, "warp_blend": 0,
                "warp_nhwc_k3": 0, "warp_nhwc_k4": 0},
    "v4.25": {"warp_planes": 5, "warp_planes_bwd": 5, "warp_blend": 1,
              "warp_nhwc_k3": 0, "warp_nhwc_k4": 0},
    "hdv2": {"warp_planes": 0, "warp_planes_bwd": 12, "warp_blend": 0,
             "warp_nhwc_k3": 4, "warp_nhwc_k4": 8},
    "hd": {"warp_planes": 0, "warp_planes_bwd": 16, "warp_blend": 0,
           "warp_nhwc_k3": 8, "warp_nhwc_k4": 8},
}
TRAIN_FAMILY = tuple(TRAIN_FAMILY_LAUNCHES)
# Each block's flow head is scaled by this gain so the flows reach a few
# px (at random init, and in v4.25's checkpoint, they stay near or under
# one and leave the warps idle).  `hd`'s heads take 4, not the serving
# checks' 20: at 20 its flows reach 30-45 px (a fifth to a half of a
# 64-224 px crop), most taps clamp to the border, and the bf16 flows (0.25
# px apart there) and the legacy objective's census term make its bf16
# and f32 gradients point apart (block cosines 0.24-0.76 on the CPU at
# 2x128x128).
TRAIN_FAMILY_FLOW_GAIN = {"rife_m": 4.0, "rife_2r": 4.0, "v4.25": 10.0, "hdv2": 20.0,
                          "hd": 4.0}


def train_family_weights(model: str, seed: int = 0) -> dict:
    """`model`'s start weights for the training checks (a state dict on
    the CPU): v4.25's in-repo checkpoint, the others `ModelDef.init(seed)`,
    each block's flow head scaled by TRAIN_FAMILY_FLOW_GAIN (the paper
    family's and v4.25's head outputs 0-3, which v4.25's deconv to 52
    channels holds in its first 16 before PixelShuffle(2); the legacy
    models' whole `block{i}.conv1`)."""
    from rife_tpu_torch.engine import load_checkpoint, state_dict_from_jax
    from rife_tpu_torch.models import get_model_def

    if model == "v4.25":
        sd = state_dict_from_jax(load_checkpoint(CKPT_V425)[1], model=model)
    else:
        sd = get_model_def(model).init(torch.Generator().manual_seed(seed))
    gain = TRAIN_FAMILY_FLOW_GAIN[model]
    for k, v in sd.items():
        if model in ("hd", "hdv2"):
            if k.startswith("block") and k.split(".")[1:2] == ["conv1"] and k.count(".") == 2:
                v.mul_(gain)
        elif k.endswith(("lastconv.weight", "lastconv.bias")):
            n = 16 if model == "v4.25" else 4
            (v[:, :n] if v.dim() == 4 else v[:n]).mul_(gain)
    return sd
