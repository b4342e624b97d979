"""Training of the paper model `rife` (port of rife_tpu/train/loop.py).

One step: forward with the teacher branch, LapLoss student + LapLoss
teacher + 0.01 * distillation (reference model/RIFE.py:76-83), backward,
AdamW (betas 0.9/0.999, eps 1e-8, weight decay 1e-3 on every parameter,
as optax.adamw).  Parameters and optimizer state stay f32; with a bf16
`compute_dtype` the activations are bf16 (the layers cast the weights).
The lr of update k is `schedule(k)`, k the updates done before (optax's
count, which the reference trainer's step equals), so the warmup
schedule's first update has lr 0.  Every step runs
with TF32 off, like the reference's f32 Precision.HIGHEST.

Not ported: the v4.25 and legacy objectives (ROADMAP A13; the legacy
models are served, not trained) and `make_train_step_chained`, which
hides a TPU runtime's per-call dispatch cost and has no use here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from rife_tpu_torch.engine.checkpoint import load_train_tree, save_params, train_tree
from rife_tpu_torch.engine.inference import full_f32
from rife_tpu_torch.models.registry import ModelDef
from rife_tpu_torch.ops.pyramid import lap_loss
from rife_tpu_torch.train.lr import warmup_cosine_schedule


@dataclass
class TrainState:
    model_def: ModelDef
    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0  # optimizer updates done: the lr index (optax's count)


def train_init(model_def: ModelDef, *, total_steps: int, seed: int = 1234,
               world_scale: float = 1.0, weight_decay: float = 1e-3,
               peak_lr: float = 3e-4, schedule=None, params: dict | None = None,
               device="cuda") -> TrainState:
    """A model with torch-default initial parameters drawn from `seed`
    (or `params`, a state dict), on `device`, and its AdamW optimizer.
    The default schedule is the reference's warmup + cosine."""
    if model_def.name != "rife":
        raise NotImplementedError(f"training {model_def.name!r} is not ported yet "
                                  f"(ROADMAP.md, queue A item 13)")
    if schedule is None:
        schedule = warmup_cosine_schedule(total_steps, peak=peak_lr,
                                          world_scale=world_scale)
    if params is None:
        params = model_def.init(torch.Generator().manual_seed(seed))
    model = model_def.build(model_def.config)
    model.load_state_dict(params)
    model.to(device).train()
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    return TrainState(model_def, model, opt, schedule)


def _moments(state: TrainState) -> tuple[dict, dict]:
    """AdamW's first and second moments as two state dicts (zeros before
    the first update)."""
    mu, nu = {}, {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    return mu, nu


def _set_moments(state: TrainState, mu: dict, nu: dict, step: int) -> None:
    """Give every parameter AdamW state: the moments `mu`, `nu` (state
    dicts) after `step` updates."""
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, torch.float32).clone(),
            "exp_avg_sq": nu[name].to(p.device, torch.float32).clone()}
    state.step = step


def save_checkpoint(state: TrainState, path: str) -> None:
    """The reference trainer's `.rtpu` checkpoint: params, optax.adamw's
    state and the step, readable by rife_tpu's `load_params` and resumable
    by either trainer."""
    mu, nu = _moments(state)
    save_params(path, train_tree(state.model.state_dict(), mu, nu, state.step),
                meta={"model": state.model_def.name, "step": state.step})


def restore_checkpoint(state: TrainState, path: str) -> None:
    """Resume from a training checkpoint of either trainer."""
    name, params, mu, nu, step = load_train_tree(path)
    if name != state.model_def.name:
        raise ValueError(f"{path} holds model {name!r}, not {state.model_def.name!r}")
    state.model.load_state_dict(params)
    _set_moments(state, mu, nu, step)


def dev01(batch: dict, device) -> dict:
    """A host batch of NHWC frames (uint8, or float in [0, 1]) -> f32 [0, 1]
    (N, 3, H, W) planes on `device` (reference _dev01: /255 on the device,
    the same values as on the host)."""
    out = {}
    for k in ("img0", "img1", "gt"):
        v = torch.as_tensor(batch[k]).to(device).permute(0, 3, 1, 2)
        v = v.float() / 255.0 if v.dtype == torch.uint8 else v.float()
        out[k] = v.contiguous()
    return out


def loss_fn(model, batch: dict, model_def: ModelDef, compute_dtype=torch.float32):
    """The `rife` objective (reference _loss_fn) -> (loss, metrics), the
    metrics detached 0-d f32 tensors."""
    b = dev01(batch, next(model.parameters()).device)
    img0, img1, gt = (b[k].to(compute_dtype) for k in ("img0", "img1", "gt"))
    out = model(img0, img1, scale_list=model_def.scale_list, gt=gt)
    gt32 = gt.float()
    loss_l1 = lap_loss(out["merged"][-1].float(), gt32)
    loss_tea = lap_loss(out["merged_teacher"].float(), gt32)
    loss_distill = out["loss_distill"].float()
    loss = loss_l1 + loss_tea + 0.01 * loss_distill
    metrics = {"loss": loss, "loss_l1": loss_l1, "loss_tea": loss_tea,
               "loss_distill": loss_distill}
    return loss, {k: v.detach() for k, v in metrics.items()}


def apply_gradients(state: TrainState) -> float:
    """One AdamW update from the parameters' `.grad`, at lr
    `schedule(step)`; returns that lr."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return lr


def train_step(state: TrainState, batch: dict, compute_dtype=torch.float32) -> dict:
    """One AdamW update on `batch`; returns the metrics (0-d tensors on the
    device: reading them waits for the step) and the lr used."""
    state.optimizer.zero_grad(set_to_none=True)
    with full_f32():
        loss, metrics = loss_fn(state.model, batch, state.model_def, compute_dtype)
        loss.backward()
    return {**metrics, "lr": apply_gradients(state)}


@torch.no_grad()
def eval_step(model, batch: dict, model_def: ModelDef,
              compute_dtype=torch.float32) -> dict:
    """Validation (reference make_eval_step): per-sample PSNR of the
    student's and the teacher's frames against gt, and the prediction."""
    b = dev01(batch, next(model.parameters()).device)
    img0, img1, gt = (b[k].to(compute_dtype) for k in ("img0", "img1", "gt"))
    with full_f32():
        out = model(img0, img1, scale_list=model_def.scale_list, gt=gt)
    pred = out["merged"][-1].float()
    tea = out["merged_teacher"].float()

    def psnr(a, ref):
        return -10.0 * torch.log10(((a - ref) ** 2).mean((1, 2, 3)) + 1e-12)

    return {"psnr": psnr(pred, b["gt"]), "psnr_tea": psnr(tea, b["gt"]), "pred": pred}
