"""`.rtpu` checkpoint reader and writer (numpy only) and the weight carrier.

The `.rtpu` format (rife_tpu/engine/checkpoint.py): 8-byte magic, a
little-endian u64 header length, a JSON header {"meta", "tensors": {key:
{"dtype", "shape"}}}, then the raw tensors in sorted key order.  Keys are
"/"-joined tree paths; all-digit levels are lists.  Training checkpoints
hold {"params", "opt_state", "step"}; serving needs "params" only.  The
reference trainer's optimizer is optax.adamw, whose state is
(ScaleByAdamState(count, mu, nu), EmptyState(), ScaleByScheduleState(
count)): keys opt_state/0/0 (int32 count), opt_state/0/1/... (mu, laid
out like params), opt_state/0/2/... (nu), opt_state/2/0 (the schedule's
int32 count); "step" is int64.

`state_dict_from_jax` carries a reference parameter tree (or a mu or nu
tree) into this package's module names and PyTorch's weight layouts;
`jax_tree_from_state_dict` carries it back.

`load_checkpoint` also reads the reference's own PyTorch checkpoints into
the reference's parameter tree, with numpy copies of the importers of
rife_tpu/models/torch_import.py: a single `flownet.pkl` of the paper
family or of v4.25 (`import_ifnet`, `import_v425`; rife_tpu/engine/
checkpoint.py:128-135), and the legacy models' three-file checkpoints (a
directory holding `flownet.pkl`, `contextnet.pkl` and `unet.pkl`,
rife_tpu/engine/checkpoint.py:105-117; `import_hdv2`, and `import_hd`
with eval-mode BatchNorm folded into its bias-free convs).
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_MAGIC = b"RIFETPU1"
# Transposed convs (the paper model's block heads and U-Net decoder, v4.25's
# block heads and encoder head, the legacy models' U-Net decoders): stored
# as the equivalent forward conv.
_DECONV_PARENTS = ("lastconv", "up0.conv", "up1.conv", "up2.conv", "up3.conv",
                   "encode.cnn3")
# The same names are plain convs in `hd` and transposed convs in `hdv2`: its
# flow heads and its U-Net's last layer.
_MODEL_DECONV_PARENTS = {"hdv2": ("block0.conv1", "block1.conv1", "block2.conv1",
                                  "block3.conv1", "fusionnet.conv")}


def _is_deconv(parent: str, model: str) -> bool:
    return parent.endswith(_DECONV_PARENTS + _MODEL_DECONV_PARENTS.get(model, ()))


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            # Gaps are leafless entries of the saved tuple; keep the order.
            return [listify(node[str(i)]) if str(i) in node else {}
                    for i in range(max(int(k) for k in keys) + 1)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_params(path: str, prefix: str = ""):
    """Read an `.rtpu` file -> (tree of numpy arrays, meta).  Only tensors
    whose key starts with `prefix` are read; the others are skipped."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path} is not an .rtpu checkpoint")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        flat = {}
        for k in sorted(header["tensors"]):
            info = header["tensors"][k]
            dt = np.dtype(info["dtype"])
            nbytes = int(np.prod(info["shape"], dtype=np.int64)) * dt.itemsize
            if not k.startswith(prefix):
                f.seek(nbytes, 1)
                continue
            buf = f.read(nbytes)
            if len(buf) != nbytes:
                raise ValueError(f"{path} is truncated at tensor {k}")
            flat[k] = np.frombuffer(buf, dtype=dt).reshape(info["shape"]).copy()
    return _unflatten(flat), header["meta"]


def load_checkpoint(path: str, model: str | None = None):
    """-> (model name, parameter tree of numpy arrays).  `path` is an
    `.rtpu` file (the optimizer state of a training checkpoint is
    dropped; the model from its meta), a reference `flownet.pkl` (the
    model detected from its keys), or a directory holding a legacy trio
    (`hd` or `hdv2`, detected).  `model` overrides the meta or the
    detection of a file (`rife_2r`'s keys are `rife`'s)."""
    if os.path.isdir(path):
        return load_trio(path)
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            return load_pickle(path, model)
        (hlen,) = struct.unpack("<Q", f.read(8))
        keys = json.loads(f.read(hlen))["tensors"]
    full = any(k.startswith("opt_state/") for k in keys) and \
        any(k.startswith("params/") for k in keys)
    tree, meta = load_params(path, "params/" if full else "")
    return model or meta.get("model", "rife"), tree["params"] if full else tree


def find_checkpoint(model_dir: str) -> str | None:
    """`model_dir` itself, or its `flownet.rtpu`, then its `flownet.pkl`
    (rife_tpu/cli/interp_img.py:59-64); None where there is no such
    file."""
    ckpt = model_dir
    if os.path.isdir(ckpt):
        for cand in ("flownet.rtpu", "flownet.pkl"):
            p = os.path.join(ckpt, cand)
            if os.path.exists(p):
                ckpt = p
                break
    return ckpt if os.path.isfile(ckpt) else None


def load_pickle(path: str, model: str | None = None):
    """A reference `flownet.pkl` (a state dict saved by `torch.save`) ->
    (model name, parameter tree): read with `torch.load(weights_only=True)`,
    "module." stripped, the model detected from its keys unless `model`
    names it, then imported (`import_ifnet` for the paper family,
    `import_v425`)."""
    from rife_tpu_torch.models.registry import detect_model_from_state_dict

    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = strip_ddp({k: v.numpy() for k, v in sd.items()})
    name = model or detect_model_from_state_dict(sd)
    if name in ("hd", "hdv2"):
        raise ValueError(f"{path}: a single .pkl of {name!r}; the legacy models "
                         f"load from a directory holding the trio")
    return name, _IMPORTERS[name](sd)


def load_trio(path: str):
    """A legacy three-file checkpoint -> (`hd` or `hdv2`, parameter tree):
    `flownet.pkl`, `contextnet.pkl` and `unet.pkl` read with
    `torch.load(weights_only=True)`, "module." stripped, merged under the
    prefixes "flownet.", "contextnet." and "fusionnet.", then imported."""
    from rife_tpu_torch.models.registry import detect_model_from_state_dict

    sd = {}
    for prefix, fname in (("flownet", "flownet.pkl"), ("contextnet", "contextnet.pkl"),
                          ("fusionnet", "unet.pkl")):
        part = torch.load(os.path.join(path, fname), map_location="cpu",
                          weights_only=True)
        sd.update({f"{prefix}.{k}": v.numpy() for k, v in strip_ddp(part).items()})
    name = detect_model_from_state_dict(sd)
    if name not in ("hd", "hdv2"):
        raise ValueError(f"{path}: a trio of {name!r}, not of a legacy model")
    return name, _IMPORTERS[name](sd)


def strip_ddp(sd: dict) -> dict:
    """The one rule for DDP prefixes, used by every loader: where any key
    starts with "module.", the prefixed keys, stripped, and the others
    dropped (rife_tpu/models/torch_import.py:43-44, as the reference's
    `convert` keeps only "module." keys); any other dict unchanged."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items() if k.startswith("module.")}
    return sd


def _conv_w(t) -> np.ndarray:
    """Conv2d weight OIHW -> HWIO."""
    return np.ascontiguousarray(np.asarray(t).transpose(2, 3, 1, 0))


def _deconv_w(t) -> np.ndarray:
    """ConvTranspose2d weight (I, O, kh, kw) -> the flipped HWIO of the
    equivalent forward conv."""
    return np.ascontiguousarray(np.flip(np.asarray(t), (2, 3)).transpose(2, 3, 0, 1))


def _conv_prelu(sd, prefix, weight=_conv_w) -> dict:
    """A torch `Sequential(conv, PReLU)` at `prefix` (`weight` maps the
    conv's weight: `_deconv_w` for a transposed conv)."""
    return {"conv": {"w": weight(sd[f"{prefix}.0.weight"]),
                     "b": np.asarray(sd[f"{prefix}.0.bias"])},
            "alpha": np.asarray(sd[f"{prefix}.1.weight"]).reshape(-1)}


def _conv2(sd, prefix) -> dict:
    return {"conv1": _conv_prelu(sd, f"{prefix}.conv1"),
            "conv2": _conv_prelu(sd, f"{prefix}.conv2")}


def _ifblock(sd, prefix) -> dict:
    return {"conv0": [_conv_prelu(sd, f"{prefix}.conv0.{j}") for j in range(2)],
            "convblock": [_conv_prelu(sd, f"{prefix}.convblock.{k}") for k in range(8)],
            "lastconv": {"w": _deconv_w(sd[f"{prefix}.lastconv.weight"]),
                         "b": np.asarray(sd[f"{prefix}.lastconv.bias"])}}


def import_ifnet(sd: dict) -> dict:
    """A paper IFNet / IFNet_m / 2R state dict (model/IFNet*.py) -> the
    reference's parameter tree (rife_tpu `import_ifnet`): the teacher and
    the refine stage where the state dict has them."""
    params = {f"block{i}": _ifblock(sd, f"block{i}") for i in range(3)}
    if "block_tea.conv0.0.0.weight" in sd:
        params["block_tea"] = _ifblock(sd, "block_tea")
    if "contextnet.conv1.conv1.0.weight" in sd:
        params["contextnet"] = {f"conv{n}": _conv2(sd, f"contextnet.conv{n}")
                                for n in range(1, 5)}
        unet = {f"down{n}": _conv2(sd, f"unet.down{n}") for n in range(4)}
        unet.update({f"up{n}": _conv_prelu(sd, f"unet.up{n}", _deconv_w) for n in range(4)})
        unet["conv"] = {"w": _conv_w(sd["unet.conv.weight"]),
                        "b": np.asarray(sd["unet.conv.bias"])}
        params["unet"] = unet
    return params


def _v425_block(sd, prefix) -> dict:
    conv = lambda key, weight=_conv_w: {  # noqa: E731
        "w": weight(sd[f"{key}.weight"]), "b": np.asarray(sd[f"{key}.bias"])}
    return {"conv0": [conv(f"{prefix}.conv0.{j}.0") for j in range(2)],
            "convblock": [{"conv": conv(f"{prefix}.convblock.{k}.conv"),
                           "beta": np.asarray(sd[f"{prefix}.convblock.{k}.beta"]).reshape(-1)}
                          for k in range(8)],
            "lastconv": conv(f"{prefix}.lastconv.0", _deconv_w)}


def import_v425(sd: dict) -> dict:
    """A v4.25 / HDv3 state dict (train_log/IFNet_HDv3.py) -> the
    reference's parameter tree (rife_tpu `import_v425`); the teacher and
    caltime keys are ignored, as the reference's loader does."""
    from rife_tpu_torch.models.v425 import V425Config

    params = {f"block{i}": _v425_block(sd, f"block{i}")
              for i in range(len(V425Config().block_channels))}
    params["encode"] = {
        name: {"w": (_deconv_w if name == "cnn3" else _conv_w)(sd[f"encode.{name}.weight"]),
               "b": np.asarray(sd[f"encode.{name}.bias"])}
        for name in ("cnn0", "cnn1", "cnn2", "cnn3")}
    return params


def import_hdv2(sd: dict) -> dict:
    """The merged v2 trio (oldmodel/RIFE_HDv2.py:152-168) -> the reference's
    `hdv2` parameter tree (rife_tpu `import_hdv2`)."""
    params = {}
    for i in range(4):
        pre = f"flownet.block{i}"
        params[f"block{i}"] = {
            "conv0": [_conv_prelu(sd, f"{pre}.conv0.{j}") for j in range(2)],
            "convblock": [_conv_prelu(sd, f"{pre}.convblock.{k}") for k in range(6)],
            "conv1": {"w": _deconv_w(sd[f"{pre}.conv1.weight"]),
                      "b": np.asarray(sd[f"{pre}.conv1.bias"])}}
    params["contextnet"] = {f"conv{i}": _conv2(sd, f"contextnet.conv{i}")
                            for i in range(5)}
    fus = {name: _conv2(sd, f"fusionnet.{name}")
           for name in ("conv0", "down0", "down1", "down2", "down3")}
    fus.update({f"up{n}": _conv_prelu(sd, f"fusionnet.up{n}", _deconv_w) for n in range(4)})
    fus["conv"] = {"w": _deconv_w(sd["fusionnet.conv.weight"]),
                   "b": np.asarray(sd["fusionnet.conv.bias"])}
    params["fusionnet"] = fus
    return params


def _fold_bn(sd, conv_key: str, bn_key: str) -> dict:
    """Eval-mode BatchNorm2d folded into the bias-free conv before it, in
    f64: w' = w * gamma / sqrt(var + 1e-5) per output channel, b' = beta -
    mean * that scale (rife_tpu `_fold_bn`; exact for inference)."""
    w = _conv_w(sd[f"{conv_key}.weight"])  # HWIO; O is the last axis
    g, b, m, v = (np.asarray(sd[f"{bn_key}.{k}"], np.float64)
                  for k in ("weight", "bias", "running_mean", "running_var"))
    scale = g / np.sqrt(v + 1e-5)
    return {"w": (w * scale).astype(np.float32), "b": (b - m * scale).astype(np.float32)}


def _se_gates(sd, prefix) -> dict:
    return {"relu1": np.asarray(sd[f"{prefix}.relu1.weight"]).reshape(-1),
            "relu2": np.asarray(sd[f"{prefix}.relu2.weight"]).reshape(-1),
            "fc1": {"w": _conv_w(sd[f"{prefix}.fc1.weight"])},
            "fc2": {"w": _conv_w(sd[f"{prefix}.fc2.weight"])}}


def _se_res_hd_flow(sd, prefix) -> dict:
    """IFNet_HD.ResBlock: conv1 5x5 + BN + PReLU, conv2 3x3 + BN, the SE
    gate; no shortcut conv (same width, stride 1)."""
    return {"conv1": {"conv": _fold_bn(sd, f"{prefix}.conv1.0", f"{prefix}.conv1.1"),
                      "alpha": np.asarray(sd[f"{prefix}.conv1.2.weight"]).reshape(-1)},
            "conv2": _fold_bn(sd, f"{prefix}.conv2.0", f"{prefix}.conv2.1"),
            **_se_gates(sd, prefix)}


def _se_res_hd(sd, prefix) -> dict:
    """RIFE_HD.ResBlock: stride 2, biased convs, no BN, a 3x3 shortcut conv."""
    return {"conv0": {"w": _conv_w(sd[f"{prefix}.conv0.weight"])},
            "conv1": _conv_prelu(sd, f"{prefix}.conv1"),
            "conv2": {"w": _conv_w(sd[f"{prefix}.conv2.0.weight"]),
                      "b": np.asarray(sd[f"{prefix}.conv2.0.bias"])},
            **_se_gates(sd, prefix)}


def import_hd(sd: dict) -> dict:
    """The merged v1 trio (oldmodel/RIFE_HD.py:167-189) -> the reference's
    `hd` parameter tree, BatchNorm folded (rife_tpu `import_hd`)."""
    params = {}
    for i in range(4):
        pre = f"flownet.block{i}"
        blk = {"conv0": {"conv": _fold_bn(sd, f"{pre}.conv0.0", f"{pre}.conv0.1"),
                         "alpha": np.asarray(sd[f"{pre}.conv0.2.weight"]).reshape(-1)},
               "conv1": {"w": _conv_w(sd[f"{pre}.conv1.weight"]),
                         "b": np.asarray(sd[f"{pre}.conv1.bias"])}}
        for j in range(6):
            blk[f"res{j}"] = _se_res_hd_flow(sd, f"{pre}.res{j}")
        params[f"block{i}"] = blk
    ctx = {"conv0": _conv_prelu(sd, "contextnet.conv0")}
    ctx.update({f"conv{i}": _se_res_hd(sd, f"contextnet.conv{i}") for i in range(1, 5)})
    params["contextnet"] = ctx
    fus = {"conv0": _conv_prelu(sd, "fusionnet.conv0")}
    fus.update({f"down{i}": _se_res_hd(sd, f"fusionnet.down{i}") for i in range(4)})
    fus.update({f"up{n}": _conv_prelu(sd, f"fusionnet.up{n}", _deconv_w) for n in range(4)})
    fus["conv"] = {"w": _conv_w(sd["fusionnet.conv.weight"]),
                   "b": np.asarray(sd["fusionnet.conv.bias"])}
    params["fusionnet"] = fus
    return params


_IMPORTERS = {"rife": import_ifnet, "rife_m": import_ifnet, "rife_2r": import_ifnet,
              "v4.25": import_v425, "hd": import_hd, "hdv2": import_hdv2}


def _flatten(tree, prefix="", sep="."):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}{sep}", sep)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}{sep}", sep)
    else:
        yield prefix[:-1], np.asarray(tree)


def state_dict_from_jax(params, model: str = "rife") -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy or JAX arrays) of `model` -> state
    dict of this package's modules.  Any model of the registry: `rife_m`
    (block inputs 7/18/18, teacher 21) and `rife_2r` carry like `rife`,
    and a tree without the refine stage (`refine=False`) gives a state
    dict without `contextnet.`/`unet.` keys.

    - conv "w" HWIO -> "weight" OIHW; "b" -> "bias";
    - transposed conv "w", stored pre-flipped as (kh, kw, I, O) -> torch's
      (I, O, kh, kw), flipped back (which layers are transposed depends on
      the model: `block{i}.conv1` and `fusionnet.conv` are in `hdv2` only);
    - PReLU "alpha" (C,), `hd`'s "relu1"/"relu2" and v4.25's ResConv "beta"
      (C,) unchanged."""
    sd = {}
    for key, v in _flatten(params):
        parent, _, leaf = key.rpartition(".")
        v = np.array(v, np.float32)  # a writable copy
        if leaf == "w" and _is_deconv(parent, model):
            v = np.flip(v.transpose(2, 3, 0, 1), (2, 3))
        elif leaf == "w":
            v = v.transpose(3, 2, 0, 1)
        name = {"w": "weight", "b": "bias"}.get(leaf, leaf)
        sd[f"{parent}.{name}" if parent else name] = \
            torch.from_numpy(np.ascontiguousarray(v))
    return sd


def jax_tree_from_state_dict(sd, model: str = "rife") -> dict:
    """Inverse of `state_dict_from_jax`: a dict of tensors with the state
    dict keys of `model` -> the reference's parameter tree of f32 numpy
    arrays ("weight" OIHW -> "w" HWIO; a transposed conv's (I, O, kh, kw)
    -> flipped (kh, kw, I, O); "bias" -> "b")."""
    flat = {}
    for key, t in sd.items():
        parent, _, leaf = key.rpartition(".")
        v = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and _is_deconv(parent, model):
            v = np.flip(v, (2, 3)).transpose(2, 3, 0, 1)
        elif leaf == "weight":
            v = v.transpose(2, 3, 1, 0)
        name = {"weight": "w", "bias": "b"}.get(leaf, leaf)
        path = parent.replace(".", "/")
        flat[f"{path}/{name}" if path else name] = np.ascontiguousarray(v)
    return _unflatten(flat)


def save_params(path: str, tree, meta: dict | None = None) -> None:
    """Write a tree of arrays as `.rtpu`, as rife_tpu's `save_params` does
    (leafless nodes write nothing), through a temporary file and an
    atomic rename."""
    flat = dict(_flatten(tree, sep="/"))
    header = {"meta": meta or {},
              "tensors": {k: {"dtype": str(v.dtype), "shape": list(v.shape)}
                          for k, v in flat.items()}}
    hb = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for k in sorted(flat):
            f.write(np.ascontiguousarray(flat[k]).tobytes())
    os.replace(tmp, path)


def train_tree(params: dict, mu: dict, nu: dict, step: int, model: str = "rife") -> dict:
    """The reference trainer's checkpoint tree from state dicts of
    `model`'s parameters and AdamW's two moments after `step` updates
    (Adam's count, the schedule's count and the trainer's step are all
    `step`), each in the reference's layouts for that model."""
    count = np.asarray(step, np.int32)
    tree = lambda sd: jax_tree_from_state_dict(sd, model=model)  # noqa: E731
    return {"params": tree(params),
            "opt_state": [[count, tree(mu), tree(nu)], {}, [count]],
            "step": np.asarray(step, np.int64)}


def load_train_tree(path: str):
    """Read a training checkpoint -> (model name, params, mu, nu state
    dicts, step), carried by the layouts of the model its meta names.
    Adam's count, the schedule's count and the step must agree, as the
    reference trainer keeps them."""
    tree, meta = load_params(path)
    adam, _, sched = tree["opt_state"]
    counts = {int(adam[0]), int(sched[0]), int(tree["step"])}
    if len(counts) != 1:
        raise ValueError(f"{path}: Adam count {int(adam[0])}, schedule count "
                         f"{int(sched[0])} and step {int(tree['step'])} differ")
    model = meta.get("model", "rife")
    sd = lambda t: state_dict_from_jax(t, model=model)  # noqa: E731
    return model, sd(tree["params"]), sd(adam[1]), sd(adam[2]), counts.pop()
