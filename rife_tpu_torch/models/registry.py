"""Model presets (port of rife_tpu/models/registry.py: every entry, `rife`,
`rife_m`, `rife_2r`, `v4.25`, `hd` and `hdv2`, and the checkpoint
detection).

The repo holds no weights of `rife_m`, `rife_2r`, `hd` or `hdv2`; they
run and train from `ModelDef.init`."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from rife_tpu_torch.models.ifnet import IFNet, IFNetConfig
from rife_tpu_torch.models.legacy import HD, HDConfig, HDv2, HDv2Config
from rife_tpu_torch.models.v425 import V425, V425Config
from rife_tpu_torch.nn import init_torch_default_


@dataclass(frozen=True)
class ModelDef:
    name: str
    config: IFNetConfig | V425Config | HDConfig | HDv2Config
    build: type
    scale_list: tuple  # per-level divisors before the /scale knob
    pad_multiple: int = 32  # spatial granularity the pyramid requires

    def init(self, generator: torch.Generator) -> dict:
        """A state dict of torch-default initial parameters (f32, on the
        CPU) drawn from `generator` (reference ModelDef.init)."""
        return init_torch_default_(self.build(self.config), generator).state_dict()


MODEL_REGISTRY: dict[str, ModelDef] = {
    "rife": ModelDef("rife", IFNetConfig(), IFNet, (4.0, 2.0, 1.0)),
    "rife_m": ModelDef("rife_m", IFNetConfig(variant="rife_m"), IFNet, (4.0, 2.0, 1.0)),
    "rife_2r": ModelDef("rife_2r", IFNetConfig(half_res=True), IFNet, (4.0, 2.0, 1.0)),
    # The scale-16 level halves twice more inside its block: pad to 64.
    "v4.25": ModelDef("v4.25", V425Config(), V425, (16.0, 8.0, 4.0, 2.0, 1.0),
                      pad_multiple=64),
    # The legacy models: scale_list[0] is their divisor (1 / the scale knob).
    "hd": ModelDef("hd", HDConfig(), HD, (1.0,)),
    "hdv2": ModelDef("hdv2", HDv2Config(), HDv2, (1.0,)),
}


def get_model_def(name: str) -> ModelDef:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; the models: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def detect_model_from_state_dict(sd) -> str:
    """The model of a checkpoint's state dict (reference keys, "module."
    prefixes allowed), from its keys and shapes (rife_tpu's
    `detect_model_from_state_dict`): `v4.25`, `hd` (SE ResBlocks res0..),
    `hdv2` (a merged trio, or a bare flownet with a 6-conv body), `rife_m`
    (block0 takes 7 channels) or `rife`.  Accepts a dict of tensors or
    arrays, or an iterable of keys."""
    shapes = {}
    if hasattr(sd, "items") and sd and not isinstance(next(iter(sd)), int):
        shapes = {k: tuple(getattr(v, "shape", ())) for k, v in sd.items()}
    keys = set(sd)
    if any(k.startswith("module.") for k in keys):
        keys = {k.replace("module.", "", 1) for k in keys}
        shapes = {k.replace("module.", "", 1): v for k, v in shapes.items()}
    if "encode.cnn0.weight" in keys or "block4.conv0.0.0.weight" in keys:
        return "v4.25"
    if any(".res0." in k for k in keys):
        return "hd"
    if any(k.startswith("flownet.block0.conv1.") for k in keys):
        return "hdv2"
    if "block0.conv1.weight" in keys and "block0.convblock.6.0.weight" not in keys:
        return "hdv2"
    if "block0.conv0.0.0.weight" in keys:
        shp = shapes.get("block0.conv0.0.0.weight")
        return "rife_m" if shp and len(shp) == 4 and shp[1] == 7 else "rife"
    raise ValueError("unrecognized checkpoint format")
