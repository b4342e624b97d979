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
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_MAGIC = b"RIFETPU1"
# Transposed convs (the paper model's block heads and U-Net decoder, v4.25's
# block heads and encoder head): stored as the equivalent forward conv.
_DECONV_PARENTS = ("lastconv", "up0.conv", "up1.conv", "up2.conv", "up3.conv",
                   "encode.cnn3")


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


def load_checkpoint(path: str):
    """-> (model name, parameter tree of numpy arrays), dropping the
    optimizer state of a training checkpoint."""
    with open(path, "rb") as f:
        f.seek(8)
        (hlen,) = struct.unpack("<Q", f.read(8))
        keys = json.loads(f.read(hlen))["tensors"]
    full = any(k.startswith("opt_state/") for k in keys) and \
        any(k.startswith("params/") for k in keys)
    tree, meta = load_params(path, "params/" if full else "")
    return meta.get("model", "rife"), tree["params"] if full else tree


def _flatten(tree, prefix="", sep="."):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}{sep}", sep)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}{sep}", sep)
    else:
        yield prefix[:-1], np.asarray(tree)


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy or JAX arrays) -> state dict of this
    package's modules.

    - conv "w" HWIO -> "weight" OIHW; "b" -> "bias";
    - transposed conv "w", stored pre-flipped as (kh, kw, I, O) -> torch's
      (I, O, kh, kw), flipped back;
    - PReLU "alpha" (C,) and v4.25's ResConv "beta" (C,) unchanged."""
    sd = {}
    for key, v in _flatten(params):
        parent, _, leaf = key.rpartition(".")
        v = np.array(v, np.float32)  # a writable copy
        if leaf == "w" and parent.endswith(_DECONV_PARENTS):
            v = np.flip(v.transpose(2, 3, 0, 1), (2, 3))
        elif leaf == "w":
            v = v.transpose(3, 2, 0, 1)
        name = {"w": "weight", "b": "bias"}.get(leaf, leaf)
        sd[f"{parent}.{name}" if parent else name] = \
            torch.from_numpy(np.ascontiguousarray(v))
    return sd


def jax_tree_from_state_dict(sd) -> dict:
    """Inverse of `state_dict_from_jax`: a dict of tensors with a state
    dict's keys -> the reference's parameter tree of f32 numpy
    arrays ("weight" OIHW -> "w" HWIO; a transposed conv's (I, O, kh, kw)
    -> flipped (kh, kw, I, O); "bias" -> "b")."""
    flat = {}
    for key, t in sd.items():
        parent, _, leaf = key.rpartition(".")
        v = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and parent.endswith(_DECONV_PARENTS):
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


def train_tree(params: dict, mu: dict, nu: dict, step: int) -> dict:
    """The reference trainer's checkpoint tree from state dicts of the
    parameters and AdamW's two moments after `step` updates (Adam's count,
    the schedule's count and the trainer's step are all `step`)."""
    count = np.asarray(step, np.int32)
    return {"params": jax_tree_from_state_dict(params),
            "opt_state": [[count, jax_tree_from_state_dict(mu),
                           jax_tree_from_state_dict(nu)], {}, [count]],
            "step": np.asarray(step, np.int64)}


def load_train_tree(path: str):
    """Read a training checkpoint -> (model name, params, mu, nu state
    dicts, step).  Adam's count, the schedule's count and the step must
    agree, as the reference trainer keeps them."""
    tree, meta = load_params(path)
    adam, _, sched = tree["opt_state"]
    counts = {int(adam[0]), int(sched[0]), int(tree["step"])}
    if len(counts) != 1:
        raise ValueError(f"{path}: Adam count {int(adam[0])}, schedule count "
                         f"{int(sched[0])} and step {int(tree['step'])} differ")
    return (meta.get("model", "rife"), state_dict_from_jax(tree["params"]),
            state_dict_from_jax(adam[1]), state_dict_from_jax(adam[2]),
            counts.pop())
