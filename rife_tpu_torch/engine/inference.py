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
import threading

import torch

from rife_tpu_torch.models.ifnet import IFNetConfig
from rife_tpu_torch.models.legacy import HDConfig, HDv2Config
from rife_tpu_torch.models.registry import ModelDef, get_model_def
from rife_tpu_torch.ops import from_planes, to_planes

_CHANNELS_LAST = (HDConfig, HDv2Config)


def resolve_device(device=None) -> torch.device:
    """`None` means the card; a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return device


_F32 = {"lock": threading.Lock(), "inside": 0, "saved": None}


@contextlib.contextmanager
def full_f32():
    """f32 convs and matmuls in full f32 (no TF32) inside, like the
    reference's Precision.HIGHEST.

    The TF32 flags are process-wide, so the entries of every thread are
    counted together: the first turns TF32 off, the last to leave restores
    what the first found, and no thread's exit turns TF32 back on while
    another thread is still inside.  bf16 work neither needs nor enters
    it."""
    st = _F32
    with st["lock"]:
        if st["inside"] == 0:
            st["saved"] = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        st["inside"] += 1
    try:
        yield
    finally:
        with st["lock"]:
            st["inside"] -= 1
            if st["inside"] == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = st["saved"]


class InferenceEngine:
    def __init__(self, model: str, params: dict, *,
                 compute_dtype: torch.dtype = torch.float32, scale: float = 1.0,
                 fast: bool | int = False, device=None):
        """params: a state dict of the model (see
        engine.checkpoint.state_dict_from_jax).  fast: the approximation
        rung, as in the reference: 0 is the exact graph, 1 the serving
        default (fast_level0).  v4.25 has nothing more to approximate, so
        its rungs 1-4 all mean fast_level0; the legacy models (`hd`,
        `hdv2`) have no rungs and take every rung as the exact graph; the
        paper model's rungs 2-4 are not ported yet.  scale: the reference's
        knob, each level's divisor over it (the legacy models' divisor
        scale_list[0] = 1 / scale)."""
        self.model_def: ModelDef = get_model_def(model)
        self.model_name = model
        rung = int(fast)
        if not 0 <= rung <= 4:
            raise ValueError(f"fast rung {rung}: the rungs are 0-4")
        if rung >= 2 and isinstance(self.model_def.config, IFNetConfig):
            raise NotImplementedError(f"fast rung {rung} is not ported yet "
                                      f"(ROADMAP.md, queue A item 4)")
        if rung >= 1 and hasattr(self.model_def.config, "fast_level0"):
            self.model_def = dataclasses.replace(
                self.model_def, config=dataclasses.replace(
                    self.model_def.config, fast_level0=True))
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.scale = scale
        self.scale_list = tuple(s / scale for s in self.model_def.scale_list)
        net = self.model_def.build(self.model_def.config)
        net.load_state_dict(params)  # strict: the checkpoint holds every key
        if hasattr(net, "block_tea"):
            net.block_tea = None  # the training-only teacher stays off the card
        # The legacy models keep their activations (and so their weights)
        # channels-last; the others take planes.
        self.channels_last = isinstance(self.model_def.config, _CHANNELS_LAST)
        net = net.to(self.device, compute_dtype)
        if self.channels_last:
            net = net.to(memory_format=torch.channels_last)
        self.model = net.eval()

    @torch.inference_mode()
    def interpolate(self, img0, img1, timestep=0.5,
                    tta: bool = False) -> torch.Tensor:
        """The frame at `timestep` (a float or a per-pair (N,) array) for
        a padded NHWC pair in [0, 1].  Models without a timestep input
        (`rife`) give the midpoint whatever it is, as in the reference."""
        if tta:
            raise NotImplementedError("the TTA flip ensemble is not ported yet "
                                      "(ROADMAP.md, queue A item 5)")
        a, b = (self._input(x) for x in (img0, img1))
        kw = {}
        if self.supports_timestep:
            kw["timestep"] = torch.as_tensor(timestep, dtype=torch.float32,
                                             device=self.device)
        with (full_f32() if self.compute_dtype == torch.float32
              else contextlib.nullcontext()):
            out = self.model(a, b, scale_list=self.scale_list, **kw)
        return from_planes(out["merged"][-1])

    def _input(self, img) -> torch.Tensor:
        """An NHWC frame batch -> (N, 3, H, W) in the compute dtype on the
        device: channels-last (a view of the NHWC data, converted once) for
        the legacy models, contiguous planes for the others."""
        x = torch.as_tensor(img, device=self.device).to(self.compute_dtype)
        if self.channels_last:
            return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return to_planes(x)

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
        return self.model_name in ("rife_m", "v4.25")

    def warmup(self, shape, tta: bool = False):
        """Run one pair of zeros of NHWC `shape` (cuDNN picks its kernels)."""
        z = torch.zeros(shape, dtype=self.compute_dtype, device=self.device)
        self.interpolate(z, z, 0.5, tta)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
