"""Training CLI of the port (port of rife_tpu/cli/train.py), every preset.

    python -m rife_tpu_torch.cli.train --data vimeo_triplet --epoch 300 --batch_size 16
    python -m rife_tpu_torch.cli.train --synthetic --steps 16050 --batch_size 16 \\
        --crop 224 --dtype bfloat16 --resume train_log_r5/flownet.rtpu
    python -m rife_tpu_torch.cli.train --model v4.25 --septuplet --synthetic --steps 100
    python -m rife_tpu_torch.cli.train --model hdv2 --synthetic --steps 100 --device cpu

Runs on the CUDA card (`--device cuda`, the default; it raises without
one) or, asked for, on the CPU through the plain versions of the kernels.
One process, one device.  `--model` takes `rife`, `rife_m`, `rife_2r`,
`v4.25`, `hd` or `hdv2`, each with the reference's objective
(`train.loop.loss_fn`), its AdamW weight decay (1e-4 for v4.25 and the
legacy models, 1e-3 otherwise, unless `--weight_decay` is given), its
schedule (warmup + cosine scaled by batch / 64, as the reference's
world_size / 4; the legacy models' cyclic one) and a crop snapped down to
its pad multiple (v4.25: 224 -> 192).  `--septuplet` trains on 3 of 7
frames at a fractional timestep (Vimeo septuplets under `--data`, or
synthetic ones); only `rife_m` and v4.25 read the timestep, and the
others are told so.  `--steps N` is the run's total step count, as in
the reference: the cosine ends at step N and training stops there, so the
second example resumes the r5 run (step 16000) for 50 steps near its
final lr; a horizon at or below the resumed step trains one step at the
peak lr.  Logs the scalars of step 1 and of every 200th step (with the lr
the schedule gives that step, as the reference logs it), image panels
(`utils.viz`) on the first step and every `--vis_interval` steps, and
validation PSNR every `--val_interval` epochs, to {log_dir}/metrics.jsonl
and {log_dir}/panels/ (and TensorBoard when it imports); saves
{log_dir}/flownet.rtpu (params, AdamW state, step: the reference
trainer's format, resumable by either trainer) every epoch and, unlike
the reference, also when the run stops.  Batches are loaded on
`--workers` threads and assembled `--prefetch` batches ahead, as in the
reference; `--warp_impl` is accepted and every value takes the port's
kernels.

Refused: `--steps_per_call > 1` (the reference's chained steps hide a TPU
runtime's dispatch cost; the card has no such cost, ROADMAP "Not ported,
by design").
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from rife_tpu_torch.data import (SyntheticSeptuplets, SyntheticTriplets,
                                 VimeoSeptuplets, VimeoTriplets, batch_iterator)
from rife_tpu_torch.engine.inference import resolve_device
from rife_tpu_torch.models.registry import MODEL_REGISTRY, get_model_def
from rife_tpu_torch.train import (cyclic_lr_schedule, eval_step, restore_checkpoint,
                                  save_checkpoint, train_init, train_step, vis_to_host)
from rife_tpu_torch.utils.logging import MetricLogger
from rife_tpu_torch.utils.viz import dump_panels

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train RIFE with rife_tpu_torch.")
    ap.add_argument("--epoch", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--data", type=str, default="vimeo_triplet",
                    help="Vimeo90K root (tri_trainlist.txt or, with --septuplet, "
                         "sep_trainlist.txt, and sequences/)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic triplets or septuplets (no dataset needed)")
    ap.add_argument("--synthetic_n", type=int, default=None,
                    help="synthetic dataset size (default 4*batch, min 64; sets "
                         "the epoch length and thus the checkpoint cadence)")
    ap.add_argument("--septuplet", action="store_true",
                    help="fractional-timestep training on septuplets (3 of 7 "
                         "frames, t = (i1 - i0) / (i2 - i0)); --data should point "
                         "at vimeo_septuplet")
    ap.add_argument("--steps", type=int, default=None,
                    help="total steps (a resumed run counts from its step): "
                         "the lr schedule's horizon and where training stops")
    ap.add_argument("--model", type=str, default="rife", choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--weight_decay", type=float, default=None,
                    help="AdamW weight decay (default 1e-4 for v4.25, hd and "
                         "hdv2, 1e-3 otherwise)")
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--log_dir", type=str, default="train_log")
    ap.add_argument("--resume", type=str, default=None,
                    help="a training checkpoint (.rtpu) of either trainer")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--workers", type=int, default=8,
                    help="loader threads per batch (0 = on the step's thread)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches assembled ahead on a background thread "
                         "(0 = synchronous)")
    ap.add_argument("--warp_impl", type=str, default="auto",
                    choices=["auto", "xla", "pallas"],
                    help="accepted for the reference's command lines: every "
                         "value takes the port's warp kernels, which are exact "
                         "for every flow (the plain versions on the CPU)")
    ap.add_argument("--dtype", type=str, default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="only 1: chained steps are not ported (ROADMAP.md, "
                         "\"Not ported, by design\")")
    ap.add_argument("--vis_interval", type=int, default=1000,
                    help="image-panel cadence in steps (0 disables)")
    ap.add_argument("--val_interval", type=int, default=5,
                    help="validation cadence in epochs")
    ap.add_argument("--val_batches", type=int, default=None,
                    help="cap validation batches (default: the whole 5%% split)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.steps_per_call != 1:
        raise NotImplementedError("--steps_per_call > 1 is not ported (ROADMAP.md, "
                                  "\"Not ported, by design\")")
    return args


def _datasets(args):
    if args.synthetic:
        cls = SyntheticSeptuplets if args.septuplet else SyntheticTriplets
        train_ds = cls(n=args.synthetic_n or max(args.batch_size * 4, 64),
                       h=args.crop + 8, w=args.crop + 8)
        # Validation frames are not cropped: size them at the crop itself.
        val_ds = cls(n=args.batch_size, h=args.crop, w=args.crop, seed=7)
        val_ds.split = "validation"
        return train_ds, val_ds
    cls = VimeoSeptuplets if args.septuplet else VimeoTriplets
    return cls(args.data, "train"), cls(args.data, "validation")


def _validate(state, args, val_ds, dtype) -> dict | None:
    psnrs, psnrs_tea = [], []
    for i, vb in enumerate(batch_iterator(val_ds, args.batch_size, crop=args.crop,
                                          augment=False, epochs=1)):
        if args.val_batches is not None and i >= args.val_batches:
            break
        out = eval_step(state.model, vb, state.model_def, dtype)
        psnrs.append(out["psnr"].cpu())
        psnrs_tea.append(out["psnr_tea"].cpu())
    if not psnrs:
        return None
    return {"psnr": float(torch.cat(psnrs).mean()),
            "psnr_tea": float(torch.cat(psnrs_tea).mean())}


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    model_def = get_model_def(args.model)
    pm = model_def.pad_multiple
    if args.crop % pm:
        new_crop = max(pm, args.crop // pm * pm)
        print(f"crop {args.crop} -> {new_crop} ({args.model} needs %{pm})")
        args.crop = new_crop
    if args.septuplet and args.model not in ("rife_m", "v4.25"):
        print(f"note: --septuplet varies the timestep but --model {args.model} "
              "has no timestep input (use rife_m or v4.25)")
    os.makedirs(args.log_dir, exist_ok=True)
    train_ds, val_ds = _datasets(args)
    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    total_steps = args.steps or steps_per_epoch * args.epoch
    dtype = _DTYPES[args.dtype]
    world_scale = args.batch_size / 64.0  # the reference's 4 ranks x batch 16 => x1
    legacy = args.model in ("hd", "hdv2")
    wd = args.weight_decay
    if wd is None:  # train_log/RIFE_HDv3.py and oldmodel/RIFE_HD.py: 1e-4
        wd = 1e-4 if legacy or args.model == "v4.25" else 1e-3
    # The legacy presets' CyclicLR 1e-6 <-> 1e-3, 8000 steps up.
    schedule = cyclic_lr_schedule(world_scale=world_scale) if legacy else None
    state = train_init(model_def, total_steps=total_steps, seed=args.seed,
                       world_scale=world_scale, weight_decay=wd, schedule=schedule,
                       device=device)
    if args.resume:
        restore_checkpoint(state, args.resume)
        print(f"resumed from {args.resume} at step {state.step}")

    logger = MetricLogger(args.log_dir)
    step = state.step
    batches = batch_iterator(train_ds, args.batch_size, seed=args.seed,
                             crop=args.crop, workers=args.workers,
                             prefetch=args.prefetch)
    t0 = time.perf_counter()
    try:
        for batch in batches:
            t1 = time.perf_counter()
            metrics, vis = train_step(state, batch, dtype, with_vis=True)
            step_before, step = step, step + 1
            if step % 200 == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the step
                # The reference logs the schedule at the step just finished,
                # not the lr its update used (schedule(step - 1)).
                m.update(step=step, lr=float(state.schedule(step)),
                         t_data=round(t1 - t0, 4),
                         t_train=round(time.perf_counter() - t1, 4))
                logger.log("train", step, m)
                print(json.dumps(m), flush=True)
            if args.vis_interval > 0 and (step_before == 0 or step % args.vis_interval == 0):
                dump_panels(logger, step, vis_to_host(vis))
            del vis
            epoch_done = step_before // steps_per_epoch != step // steps_per_epoch
            if epoch_done:
                save_checkpoint(state, os.path.join(args.log_dir, "flownet.rtpu"))
            if epoch_done and (step // steps_per_epoch) % args.val_interval == 0:
                val = _validate(state, args, val_ds, dtype)
                if val is not None:
                    logger.log("validate", step, val)
                    print(f"validation psnr: {val['psnr']:.4f} "
                          f"(teacher {val['psnr_tea']:.4f})", flush=True)
            if step >= total_steps:
                if not epoch_done:  # the run's last state is saved too
                    save_checkpoint(state, os.path.join(args.log_dir, "flownet.rtpu"))
                break
            t0 = time.perf_counter()
    finally:
        batches.close()  # stops the prefetch thread and the loader pool
        logger.close()
    print(f"training done at step {step}")


if __name__ == "__main__":
    main()
