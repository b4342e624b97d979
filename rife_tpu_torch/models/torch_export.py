"""Export to the reference's PyTorch state dicts (port of
rife_tpu/models/torch_export.py): the inverse of the `.pkl` importers in
engine/checkpoint.py, for the paper family (`rife`, `rife_m`, `rife_2r`),
so weights trained or converted here load in the reference's
`Model.load_model` (model/RIFE.py:42-50).

Layouts, from the reference's parameter tree (numpy):
- conv: (kh, kw, cin, cout) -> torch (cout, cin, kh, kw);
- transposed conv: stored pre-flipped as (kh, kw, cin, cout) -> torch's
  (cin, cout, kh, kw), flipped back;
- PReLU alpha: (c,) either way.

A state dict of this package's modules goes through
`engine.checkpoint.jax_tree_from_state_dict` first.
"""
from __future__ import annotations

import numpy as np
import torch


def _conv_w_out(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _deconv_w_out(w) -> np.ndarray:
    w = np.asarray(w, np.float32).transpose(2, 3, 0, 1)  # (kh,kw,I,O)->(I,O,kh,kw)
    return np.ascontiguousarray(np.flip(w, (2, 3)))


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32))


def _conv_prelu_out(sd, prefix, p, weight=_conv_w_out):
    sd[f"{prefix}.0.weight"] = weight(p["conv"]["w"])
    sd[f"{prefix}.0.bias"] = _f32(p["conv"]["b"])
    sd[f"{prefix}.1.weight"] = _f32(p["alpha"])


def _conv2_out(sd, prefix, p):
    _conv_prelu_out(sd, f"{prefix}.conv1", p["conv1"])
    _conv_prelu_out(sd, f"{prefix}.conv2", p["conv2"])


def _ifblock_out(sd, prefix, p):
    for j in range(2):
        _conv_prelu_out(sd, f"{prefix}.conv0.{j}", p["conv0"][j])
    for k in range(8):
        _conv_prelu_out(sd, f"{prefix}.convblock.{k}", p["convblock"][k])
    sd[f"{prefix}.lastconv.weight"] = _deconv_w_out(p["lastconv"]["w"])
    sd[f"{prefix}.lastconv.bias"] = _f32(p["lastconv"]["b"])


def export_ifnet(params) -> dict:
    """The reference's parameter tree of the paper family -> the
    reference's IFNet / IFNet_m / 2R state dict (numpy values), with the
    teacher and the refine stage where the tree has them."""
    sd: dict = {}
    for i in range(3):
        _ifblock_out(sd, f"block{i}", params[f"block{i}"])
    if "block_tea" in params:
        _ifblock_out(sd, "block_tea", params["block_tea"])
    if "contextnet" in params:
        for n in range(1, 5):
            _conv2_out(sd, f"contextnet.conv{n}", params["contextnet"][f"conv{n}"])
        unet = params["unet"]
        for n in range(4):
            _conv2_out(sd, f"unet.down{n}", unet[f"down{n}"])
        for n in range(4):
            _conv_prelu_out(sd, f"unet.up{n}", unet[f"up{n}"], _deconv_w_out)
        sd["unet.conv.weight"] = _conv_w_out(unet["conv"]["w"])
        sd["unet.conv.bias"] = _f32(unet["conv"]["b"])
    return sd


def save_torch_pickle(path: str, sd: dict):
    """Write a state dict of numpy arrays as a `torch.save` pickle of
    tensors (what the reference's loader reads)."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
