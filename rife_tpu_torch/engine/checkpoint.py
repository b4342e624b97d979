"""`.rtpu` checkpoint reader (numpy only) and the weight carrier.

The `.rtpu` format (rife_tpu/engine/checkpoint.py): 8-byte magic, a
little-endian u64 header length, a JSON header {"meta", "tensors": {key:
{"dtype", "shape"}}}, then the raw tensors in sorted key order.  Keys are
"/"-joined tree paths; all-digit levels are lists.  Training checkpoints
hold {"params", "opt_state", "step"}; serving needs "params" only.

`state_dict_from_jax` carries a reference parameter tree into this
package's module names and PyTorch's weight layouts.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

_MAGIC = b"RIFETPU1"
# Transposed convs of the paper model: stored as the equivalent forward conv.
_DECONV_PARENTS = ("lastconv", "up0.conv", "up1.conv", "up2.conv", "up3.conv")


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


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy or JAX arrays) -> state dict of this
    package's modules.

    - conv "w" HWIO -> "weight" OIHW; "b" -> "bias";
    - transposed conv "w", stored pre-flipped as (kh, kw, I, O) -> torch's
      (I, O, kh, kw), flipped back;
    - PReLU "alpha" (C,) unchanged."""
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
