"""Training of every preset (port of rife_tpu/train/loop.py).

One step: the model's objective, backward, AdamW (betas 0.9/0.999, eps
1e-8, the weight decay on every parameter, as optax.adamw).  The
objective follows the model, as the reference's `_loss_fn` dispatches:

- `rife`, `rife_m`, `rife_2r`: forward with the teacher branch, LapLoss
  student + LapLoss teacher + 0.01 * distillation (reference
  model/RIFE.py:76-83);
- `v4.25`: L1 + 0.1 * the Sobel smoothness of the last flow
  (`_loss_fn_v425`; the evident intent of the reference's unrunnable
  train_log/RIFE_HDv3.py:62-88);
- `hd`, `hdv2`: Charbonnier L1 + ternary census, plus 0.01 * EPE of every
  block's flow against the batch's `flow_gt` (half resolution, 4
  channels) where it has one (`_loss_fn_legacy`; oldmodel/RIFE_HD.py,
  RIFE_HDv2.py).

The batch's `timestep` reaches the models that read one (`rife_m`,
v4.25; the paper family takes it and ignores it), the legacy models take
none.  Parameters and optimizer state stay f32; with a bf16
`compute_dtype` the activations are bf16 (the layers cast the weights).
The lr of update k is `schedule(k)`, k the updates done before (optax's
count, which the reference trainer's step equals), so the warmup
schedule's first update has lr 0.  Every step runs with TF32 off, like
the reference's f32 Precision.HIGHEST.  Each objective also returns the
panel tensors of the reference's image panels (`vis`), detached and left
on the device; `vis_to_host` fetches them on a panel step.

Not ported: `make_train_step_chained`, which hides a TPU runtime's
per-call dispatch cost and has no use here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from rife_tpu_torch.engine.checkpoint import load_train_tree, save_params, train_tree
from rife_tpu_torch.engine.inference import full_f32
from rife_tpu_torch.models.registry import ModelDef
from rife_tpu_torch.ops.pyramid import lap_loss
from rife_tpu_torch.train.losses import epe_loss, sobel_loss, ternary_loss
from rife_tpu_torch.train.lr import warmup_cosine_schedule

PAPER_FAMILY = ("rife", "rife_m", "rife_2r")
LEGACY = ("hd", "hdv2")


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
    The default schedule is the reference's warmup + cosine; the legacy
    presets' trainer passes the cyclic one."""
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
    state and the step, in the model's reference layouts, readable by
    rife_tpu's `load_params` and resumable by either trainer."""
    mu, nu = _moments(state)
    name = state.model_def.name
    save_params(path, train_tree(state.model.state_dict(), mu, nu, state.step, model=name),
                meta={"model": name, "step": state.step})


def restore_checkpoint(state: TrainState, path: str) -> None:
    """Resume from a training checkpoint of either trainer."""
    name, params, mu, nu, step = load_train_tree(path)
    if name != state.model_def.name:
        raise ValueError(f"{path} holds model {name!r}, not {state.model_def.name!r}")
    state.model.load_state_dict(params)
    _set_moments(state, mu, nu, step)


def dev01(batch: dict, device) -> dict:
    """A host batch -> tensors on `device` (reference _dev01): the NHWC
    frames (uint8, or float in [0, 1]) as f32 [0, 1] (N, 3, H, W) planes
    (/255 on the device, the same values as on the host), `flow_gt` where
    the batch has one as f32 (N, 4, H/2, W/2) planes, `timestep` as f32
    (N,) (0.5 where the batch has none)."""
    out = {}
    for k in ("img0", "img1", "gt", "flow_gt"):
        if k not in batch:
            continue
        v = torch.as_tensor(batch[k]).to(device).permute(0, 3, 1, 2)
        v = v.float() / 255.0 if v.dtype == torch.uint8 else v.float()
        out[k] = v.contiguous()
    ts = batch.get("timestep")
    out["timestep"] = torch.full((out["img0"].shape[0],), 0.5, device=device) \
        if ts is None else torch.as_tensor(ts).to(device, torch.float32)
    return out


def _paper_loss(model, b, model_def, compute_dtype):
    img0, img1, gt = (b[k].to(compute_dtype) for k in ("img0", "img1", "gt"))
    out = model(img0, img1, scale_list=model_def.scale_list, timestep=b["timestep"],
                gt=gt)
    gt32 = gt.float()
    pred = out["merged"][-1].float()
    tea = out["merged_teacher"].float()
    loss_l1 = lap_loss(pred, gt32)
    loss_tea = lap_loss(tea, gt32)
    loss_distill = out["loss_distill"].float()
    loss = loss_l1 + loss_tea + 0.01 * loss_distill
    metrics = {"loss": loss, "loss_l1": loss_l1, "loss_tea": loss_tea,
               "loss_distill": loss_distill}
    mask = out["mask_list"][-1].float()
    vis = {"pred": pred, "gt": gt32, "merged_tea": tea, "mask": mask, "mask_tea": mask,
           "flow": out["flow_list"][-1][:, :2].float(),
           "flow_tea": out["flow_teacher"].float()}
    return loss, metrics, vis


def _loss_fn_v425(model, b, model_def, compute_dtype):
    """L1 + 0.1 * sobel_loss(last flow, 0) (reference _loss_fn_v425)."""
    img0, img1 = (b[k].to(compute_dtype) for k in ("img0", "img1"))
    gt = b["gt"]
    out = model(img0, img1, timestep=b["timestep"], scale_list=model_def.scale_list)
    pred = out["merged"][-1].float()
    flow = out["flow_list"][-1].float()
    loss_l1 = (pred - gt).abs().mean()
    loss_smooth = sobel_loss(flow, torch.zeros_like(flow))
    loss = loss_l1 + 0.1 * loss_smooth
    metrics = {"loss": loss, "loss_l1": loss_l1, "loss_smooth": loss_smooth}
    mask = torch.sigmoid(out["mask"].float())
    vis = {"pred": pred, "gt": gt, "merged_tea": pred, "mask": mask, "mask_tea": mask,
           "flow": flow[:, :2], "flow_tea": flow[:, :2]}
    return loss, metrics, vis


def _loss_fn_legacy(model, b, model_def, compute_dtype):
    """Charbonnier L1 + ternary + 0.01 * EPE against `flow_gt` where the
    batch has one (reference _loss_fn_legacy).  `hd`'s flow is one
    direction, 2 channels: f against flow_gt[:, :2] and -f against
    [:, 2:4]; `hdv2`'s 4 channels slice against slice."""
    img0, img1 = (b[k].to(compute_dtype) for k in ("img0", "img1"))
    gt = b["gt"]
    out = model(img0, img1, scale_list=model_def.scale_list)
    pred = out["merged"][-1].float()
    loss_l1 = torch.sqrt((pred - gt) ** 2 + 1e-6).mean()
    loss_ter = ternary_loss(pred, gt).mean()
    loss_cons = torch.zeros((), dtype=torch.float32, device=pred.device)
    if "flow_gt" in b:
        fgt = b["flow_gt"]
        ones = torch.ones_like(fgt[:, :1])
        for f in out["flow_list"]:
            f = f.float()
            if f.shape[1] == 2:
                loss_cons = loss_cons + epe_loss(f, fgt[:, :2], ones).mean()
                loss_cons = loss_cons + epe_loss(-f, fgt[:, 2:4], ones).mean()
            else:
                loss_cons = loss_cons + epe_loss(f[:, :2], fgt[:, :2], ones).mean()
                loss_cons = loss_cons + epe_loss(f[:, 2:4], fgt[:, 2:4], ones).mean()
        loss_cons = loss_cons * 0.01
    loss = loss_l1 + loss_cons + loss_ter
    metrics = {"loss": loss, "loss_l1": loss_l1, "loss_ter": loss_ter,
               "loss_cons": loss_cons}
    mask = out["mask"].float()
    flow = out["flow_list"][-1][:, :2].float()
    vis = {"pred": pred, "gt": gt, "merged_tea": pred, "mask": mask, "mask_tea": mask,
           "flow": flow, "flow_tea": flow}
    return loss, metrics, vis


def loss_fn(model, batch: dict, model_def: ModelDef, compute_dtype=torch.float32):
    """The model's objective (reference _loss_fn) -> (loss, metrics, vis):
    the metrics detached 0-d f32 tensors, vis the panel tensors (f32
    planes: pred, gt, merged_tea, mask, mask_tea, flow, flow_tea),
    detached, on the device."""
    b = dev01(batch, next(model.parameters()).device)
    if model_def.name == "v4.25":
        objective = _loss_fn_v425
    elif model_def.name in LEGACY:
        objective = _loss_fn_legacy
    else:
        objective = _paper_loss
    loss, metrics, vis = objective(model, b, model_def, compute_dtype)
    return (loss, {k: v.detach() for k, v in metrics.items()},
            {k: v.detach() for k, v in vis.items()})


def vis_to_host(vis: dict) -> dict:
    """Fetch a step's panel tensors -> NHWC f32 numpy arrays, as
    `utils.viz.build_panels` takes them."""
    return {k: v.float().permute(0, 2, 3, 1).cpu().numpy() for k, v in vis.items()}


def apply_gradients(state: TrainState) -> float:
    """One AdamW update from the parameters' `.grad`, at lr
    `schedule(step)`; returns that lr."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return lr


def train_step(state: TrainState, batch: dict, compute_dtype=torch.float32,
               with_vis: bool = False):
    """One AdamW update on `batch` -> the metrics (0-d tensors on the
    device: reading them waits for the step) and the lr used; with
    `with_vis`, (metrics, vis) (reference make_train_step)."""
    state.optimizer.zero_grad(set_to_none=True)
    with full_f32():
        loss, metrics, vis = loss_fn(state.model, batch, state.model_def, compute_dtype)
        loss.backward()
    metrics = {**metrics, "lr": apply_gradients(state)}
    return (metrics, vis) if with_vis else metrics


@torch.no_grad()
def eval_step(model, batch: dict, model_def: ModelDef,
              compute_dtype=torch.float32) -> dict:
    """Validation (reference make_eval_step): per-sample PSNR of the
    student's frame against gt, and of the teacher's (the paper family,
    which alone takes gt) or the student's again (the teacherless
    presets), and the prediction."""
    b = dev01(batch, next(model.parameters()).device)
    img0, img1 = (b[k].to(compute_dtype) for k in ("img0", "img1"))
    kw = {}
    if model_def.name in PAPER_FAMILY:
        kw["gt"] = b["gt"].to(compute_dtype)
    if model_def.name not in LEGACY:
        kw["timestep"] = b["timestep"]
    with full_f32():
        out = model(img0, img1, scale_list=model_def.scale_list, **kw)
    pred = out["merged"][-1].float()
    tea = out.get("merged_teacher")
    tea = pred if tea is None else tea.float()

    def psnr(a, ref):
        return -10.0 * torch.log10(((a - ref) ** 2).mean((1, 2, 3)) + 1e-12)

    return {"psnr": psnr(pred, b["gt"]), "psnr_tea": psnr(tea, b["gt"]), "pred": pred}
