"""Model presets (port of rife_tpu/models/registry.py, the `rife` and
`v4.25` entries).

`rife_m`, `rife_2r`, `hd` and `hdv2` are not ported yet (ROADMAP.md,
queue A items 4 and 16)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from rife_tpu_torch.models.ifnet import IFNet, IFNetConfig
from rife_tpu_torch.models.v425 import V425, V425Config
from rife_tpu_torch.nn import init_torch_default_


@dataclass(frozen=True)
class ModelDef:
    name: str
    config: IFNetConfig | V425Config
    build: type
    scale_list: tuple  # per-level divisors before the /scale knob
    pad_multiple: int = 32  # spatial granularity the pyramid requires

    def init(self, generator: torch.Generator) -> dict:
        """A state dict of torch-default initial parameters (f32, on the
        CPU) drawn from `generator` (reference ModelDef.init)."""
        return init_torch_default_(self.build(self.config), generator).state_dict()


MODEL_REGISTRY: dict[str, ModelDef] = {
    "rife": ModelDef("rife", IFNetConfig(), IFNet, (4.0, 2.0, 1.0)),
    # The scale-16 level halves twice more inside its block: pad to 64.
    "v4.25": ModelDef("v4.25", V425Config(), V425, (16.0, 8.0, 4.0, 2.0, 1.0),
                      pad_multiple=64),
}


def get_model_def(name: str) -> ModelDef:
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  f"(ROADMAP.md, queue A); ported: "
                                  f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
