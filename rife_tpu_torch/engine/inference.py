"""Pair-interpolation engine (port of rife_tpu/engine/inference.py).

`interpolate` takes a padded NHWC pair in [0, 1] and returns the NHWC
middle frame in the compute dtype, like the reference, so callers can
swap packages; `forward` also returns the final flow on request.  The
engine runs on `cuda` unless `device="cpu"` is given; without a card it
raises rather than carry on on the CPU.
PyTorch runs eagerly, so there is no per-shape compile cache.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import torch

from rife_tpu_torch.engine.checkpoint import load_checkpoint, state_dict_from_jax
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
    def __init__(self, model: str = "rife", params: dict | None = None, *,
                 compute_dtype: torch.dtype = torch.float32, scale: float = 1.0,
                 seed: int = 0, fast: bool | int = False, device=None):
        """params: a state dict of the model (see
        engine.checkpoint.state_dict_from_jax), or None for torch-default
        initial weights drawn from `torch.Generator().manual_seed(seed)`
        (`ModelDef.init`; not the reference's draws).  fast: the
        approximation rung, as in the reference: 0 is the exact graph, 1
        the serving default (fast_level0), 2 adds the half-resolution
        refine stage (fast_refine), 3 the final flow level at half
        resolution (scale list (4, 2, 1) -> (4, 2, 2)), 4 the refine stage
        off.  v4.25 has only fast_level0 to turn on, so its rungs 1-4 all
        mean that; the legacy models (`hd`, `hdv2`) have no rungs and take
        every rung as the exact graph.  scale: the reference's knob, each
        level's divisor over it (the legacy models' divisor scale_list[0]
        = 1 / scale)."""
        self.model_def: ModelDef = get_model_def(model)
        self.model_name = model
        rung = int(fast)
        if not 0 <= rung <= 4:
            raise ValueError(f"fast rung {rung}: the rungs are 0-4")
        cfg = self.model_def.config
        if rung >= 1 and hasattr(cfg, "fast_level0"):
            repl = {"fast_level0": True}
            if rung >= 2 and hasattr(cfg, "fast_refine"):
                repl["fast_refine"] = True
            if rung >= 4 and hasattr(cfg, "refine"):
                repl["refine"] = False
            self.model_def = dataclasses.replace(
                self.model_def, config=dataclasses.replace(cfg, **repl))
            if rung >= 3 and tuple(self.model_def.scale_list) == (4.0, 2.0, 1.0):
                self.model_def = dataclasses.replace(self.model_def,
                                                     scale_list=(4.0, 2.0, 2.0))
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.scale = scale
        self.scale_list = tuple(s / scale for s in self.model_def.scale_list)
        cfg = self.model_def.config
        if params is None:
            params = self.model_def.init(torch.Generator().manual_seed(seed))
        # Rung 4 reads no refine stage, but a full checkpoint carries one:
        # load it all (strictly) and drop the stage after.
        full = (isinstance(cfg, IFNetConfig) and not cfg.refine
                and any(k.startswith("unet.") for k in params))
        net = self.model_def.build(dataclasses.replace(cfg, refine=True) if full else cfg)
        net.load_state_dict(params)  # strict: the checkpoint holds every key
        if hasattr(net, "block_tea"):
            net.block_tea = None  # the training-only teacher stays off the card
        if full:
            net.cfg, net.contextnet, net.unet = cfg, None, None
        # The legacy models keep their activations (and so their weights)
        # channels-last; the others take planes.
        self.channels_last = isinstance(cfg, _CHANNELS_LAST)
        net = net.to(self.device, compute_dtype)
        if self.channels_last:
            net = net.to(memory_format=torch.channels_last)
        self.model = net.eval()

    @torch.inference_mode()
    def forward(self, img0, img1, timestep=0.5, tta: bool = False,
                with_flow: bool = False):
        """The frame at `timestep` (a float or a per-pair (N,) array) for a
        padded NHWC pair in [0, 1], in the compute dtype (reference
        `_forward`).  Models without a timestep input (`rife`, `rife_2r`)
        give the midpoint whatever it is, as in the reference.  tta: the
        reference's ensemble, (mid + flip(mid of the flipped pair)) / 2 in
        the compute dtype, the flip reversing both H and W.  with_flow:
        also return the final level's flow, NHWC (of the unflipped pair),
        which the spatial shard's motion guard reads."""
        a, b = (self._input(x) for x in (img0, img1))
        kw = {}
        if self.supports_timestep:
            kw["timestep"] = torch.as_tensor(timestep, dtype=torch.float32,
                                             device=self.device)
        with (full_f32() if self.compute_dtype == torch.float32
              else contextlib.nullcontext()):
            out = self.model(a, b, scale_list=self.scale_list, **kw)
            mid = from_planes(out["merged"][-1])
            if tta:
                # torch.flip copies, so the kernels get contiguous planes.
                out2 = self.model(torch.flip(a, (2, 3)), torch.flip(b, (2, 3)),
                                  scale_list=self.scale_list, **kw)
                mid = (mid + torch.flip(from_planes(out2["merged"][-1]), (1, 2))) / 2
        return (mid, from_planes(out["flow_list"][-1])) if with_flow else mid

    def interpolate(self, img0, img1, timestep=0.5, tta: bool = False) -> torch.Tensor:
        """The NHWC frame at `timestep` for a padded NHWC pair (`forward`)."""
        return self.forward(img0, img1, timestep, tta)

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


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_engine(model_path: str | None, model: str | None, scale: float = 1.0,
                 dtype: str = "float32", fast: bool | int = False,
                 device=None) -> InferenceEngine:
    """The engine of a checkpoint (`.rtpu`, a reference `.pkl` or a trio
    directory; `model` overrides its detected model), or of `model`'s
    seeded initial weights (default `rife`) where there is no such path."""
    if model_path and os.path.exists(model_path):
        name, tree = load_checkpoint(model_path, model)
        params = state_dict_from_jax(tree, model=name)
    else:
        name, params = (model or "rife"), None
    return InferenceEngine(name, params, compute_dtype=DTYPES[dtype], scale=scale,
                           fast=fast, device=device)
