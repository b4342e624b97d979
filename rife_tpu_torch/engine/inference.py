"""Pair-interpolation engine (port of rife_tpu/engine/inference.py).

`interpolate` takes a padded NHWC pair in [0, 1] and returns the NHWC
middle frame in the compute dtype, like the reference, so callers can
swap packages.  The engine runs on `cuda` unless `device="cpu"` is
given; without a card it raises rather than carry on on the CPU.
PyTorch runs eagerly, so there is no per-shape compile cache.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from rife_tpu_torch.models.registry import ModelDef, get_model_def
from rife_tpu_torch.ops import from_planes, to_planes


def resolve_device(device=None) -> torch.device:
    """`None` means the card; a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return device


@contextlib.contextmanager
def full_f32():
    """f32 convs and matmuls in full f32 (no TF32), like the reference's
    Precision.HIGHEST; bf16 work is not affected."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class InferenceEngine:
    def __init__(self, model: str, params: dict, *,
                 compute_dtype: torch.dtype = torch.float32, scale: float = 1.0,
                 fast: bool | int = False, device=None):
        """params: a state dict of the model (see
        engine.checkpoint.state_dict_from_jax).  fast: the approximation
        rung, 0 (exact graph) or 1 (the serving default, fast_level0)."""
        self.model_def: ModelDef = get_model_def(model)
        self.model_name = model
        rung = int(fast)
        if rung not in (0, 1):
            raise NotImplementedError(f"fast rung {rung} is not ported yet "
                                      f"(ROADMAP.md, queue A item 4)")
        if rung == 1:
            self.model_def = dataclasses.replace(
                self.model_def, config=dataclasses.replace(
                    self.model_def.config, fast_level0=True))
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.scale = scale
        self.scale_list = tuple(s / scale for s in self.model_def.scale_list)
        net = self.model_def.build(self.model_def.config)
        net.load_state_dict(params)  # strict: the checkpoint holds every key
        net.block_tea = None  # the training-only teacher stays off the card
        self.model = net.to(self.device, compute_dtype).eval()

    @torch.inference_mode()
    def interpolate(self, img0, img1, timestep: float = 0.5,
                    tta: bool = False) -> torch.Tensor:
        """Middle frame for a padded NHWC pair in [0, 1].  `timestep` is
        ignored: no ported model takes one (as for `rife` in the
        reference)."""
        if tta:
            raise NotImplementedError("the TTA flip ensemble is not ported yet "
                                      "(ROADMAP.md, queue A item 5)")
        a = to_planes(torch.as_tensor(img0, device=self.device)
                      .to(self.compute_dtype))
        b = to_planes(torch.as_tensor(img1, device=self.device)
                      .to(self.compute_dtype))
        with full_f32():
            out = self.model(a, b, scale_list=self.scale_list)
        return from_planes(out["merged"][-1])

    def interpolate_batch(self, pairs0, pairs1, timestep=0.5, tta=False):
        """Batched pairs stacked along N."""
        return self.interpolate(pairs0, pairs1, timestep, tta)

    @property
    def pad_multiple(self) -> int:
        """Spatial padding granularity: max(m, m / scale)."""
        m = self.model_def.pad_multiple
        return int(max(m, m / self.scale))

    @property
    def supports_timestep(self) -> bool:
        return False  # the timestep models (rife_m, v4.25) are not ported

    def warmup(self, shape, tta: bool = False):
        """Run one pair of zeros of NHWC `shape` (cuDNN picks its kernels)."""
        z = torch.zeros(shape, dtype=self.compute_dtype, device=self.device)
        self.interpolate(z, z, 0.5, tta)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
