"""VGG19 perceptual loss on (N, 3, H, W) planes (port of
rife_tpu/train/perceptual.py; reference model/loss.py:83-121).

Feature distances after the ReLUs of VGG19's convs 1, 3, 5, 9 and 13
(torchvision's `features` indices 2, 7, 12, 21, 30), weighted 1/2.6,
1/4.8, 1/3.7, 1/5.6 and 10/1.5, each times 0.1, of the ImageNet
mean/std-normalised images, the target detached.  The reference builds it
and never wires it into training; neither does this package.

No pretrained weights ship with the repo, so the caller gives them:

    params = load_vgg19_features("vgg19.npz")           # the reference's .npz
    params = import_torchvision_vgg19(state_dict)       # torchvision's features
    loss = vgg_perceptual_loss(params, pred, target)

`params` is a list of 13 {"weight": (O, I, 3, 3), "bias": (O,)} f32
tensors.  The `.npz` file keeps the reference's layout: w0..w12 HWIO,
b0..b12, so either package reads what the other wrote.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rife_tpu_torch.nn import conv2d

# The conv indices of torchvision's vgg19().features up to index 30.
_VGG19_CONVS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)
_TAP_AFTER_CONV = (1, 3, 5, 9, 13)
_POOL_AFTER_CONV = (2, 4, 8, 12)
_WEIGHTS = (1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10.0 / 1.5)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def import_torchvision_vgg19(sd: dict) -> list[dict]:
    """torchvision `vgg19().features` state dict -> the loss's params."""
    return [{"weight": torch.as_tensor(sd[f"features.{i}.weight"]).detach()
             .to("cpu", torch.float32).clone(),
             "bias": torch.as_tensor(sd[f"features.{i}.bias"]).detach()
             .to("cpu", torch.float32).clone()} for i in _VGG19_CONVS]


def load_vgg19_features(path: str) -> list[dict]:
    """Read the reference's `.npz` (w{i} HWIO, b{i})."""
    with np.load(path) as data:
        return [{"weight": torch.from_numpy(np.ascontiguousarray(
                    data[f"w{i}"].transpose(3, 2, 0, 1), np.float32)),
                 "bias": torch.from_numpy(np.asarray(data[f"b{i}"], np.float32))}
                for i in range(len(_VGG19_CONVS))]


def save_vgg19_features(path: str, params: list[dict]) -> None:
    """Write params as the reference's `.npz` (w{i} HWIO, b{i})."""
    arrays = {}
    for i, p in enumerate(params):
        w = p["weight"].detach().to("cpu", torch.float32).numpy()
        arrays[f"w{i}"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        arrays[f"b{i}"] = p["bias"].detach().to("cpu", torch.float32).numpy()
    np.savez(path, **arrays)


def _features(params, x) -> list[torch.Tensor]:
    feats = []
    for n, p in enumerate(params, 1):
        w = p["weight"].to(x.device)
        x = F.relu(conv2d(x, w) + p["bias"].to(x.device, x.dtype).view(1, -1, 1, 1))
        if n in _TAP_AFTER_CONV:
            feats.append(x)
        if n in _POOL_AFTER_CONV:
            x = F.max_pool2d(x, 2, 2)
    return feats


def vgg_perceptual_loss(params, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Weighted L1 over the VGG19 feature taps of pred and target, both
    (N, 3, H, W) in [0, 1] -> an f32 scalar; the target is detached."""
    mean = torch.tensor(_MEAN, dtype=pred.dtype, device=pred.device).view(1, 3, 1, 1)
    std = torch.tensor(_STD, dtype=pred.dtype, device=pred.device).view(1, 3, 1, 1)
    fp = _features(params, (pred - mean) / std)
    ft = _features(params, (target.detach() - mean) / std)
    loss = torch.zeros((), dtype=torch.float32, device=pred.device)
    for w, a, b in zip(_WEIGHTS, fp, ft):
        loss = loss + 0.1 * w * (a.float() - b.detach().float()).abs().mean()
    return loss
