"""Training CLI of the port (port of rife_tpu/cli/train.py, model `rife`).

    python -m rife_tpu_torch.cli.train --data vimeo_triplet --epoch 300 --batch_size 16
    python -m rife_tpu_torch.cli.train --synthetic --steps 16050 --batch_size 16 \\
        --crop 224 --dtype bfloat16 --resume train_log_r5/flownet.rtpu

Runs on the CUDA card (`--device cuda`, the default; it raises without
one) or, asked for, on the CPU through the plain versions of the kernels.
One process, one device.  LR = warmup + cosine scaled by batch / 64, as
the reference's world_size / 4.  `--steps N` is the run's total step
count, as in the reference: the cosine ends at step N and training stops
there, so the second example resumes the r5 run (step 16000) for 50
steps near its final lr; a horizon at or below the resumed step trains
one step at the peak lr.  Logs the scalars of step 1 and of every 200th
step (with the lr the schedule gives that step, as the reference logs
it), and validation PSNR every `--val_interval` epochs, to
{log_dir}/metrics.jsonl (and TensorBoard when it imports); saves
{log_dir}/flownet.rtpu (params, AdamW state, step: the reference
trainer's format, resumable by either trainer) every epoch and, unlike
the reference, also when the run stops.  Batches are loaded on
`--workers` threads and assembled `--prefetch` batches ahead, as in the
reference; `--warp_impl` is accepted and every value takes the port's
kernels.

Not ported yet, and refused: models other than `rife` (ROADMAP A13; the
legacy models `hd` and `hdv2` are served, not trained),
`--septuplet` (A13), `--vis_interval > 0` (image panels, A13) and
`--steps_per_call > 1` (the reference's chained steps hide a TPU
runtime's dispatch cost; A13 records why they are not ported).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from rife_tpu_torch.data import SyntheticTriplets, VimeoTriplets, batch_iterator
from rife_tpu_torch.engine.inference import resolve_device
from rife_tpu_torch.models.registry import get_model_def
from rife_tpu_torch.train import (eval_step, restore_checkpoint, save_checkpoint,
                                  train_init, train_step)
from rife_tpu_torch.utils.logging import MetricLogger

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train RIFE with rife_tpu_torch.")
    ap.add_argument("--epoch", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--data", type=str, default="vimeo_triplet",
                    help="Vimeo90K triplet root (tri_trainlist.txt, sequences/)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic triplets (no dataset needed)")
    ap.add_argument("--synthetic_n", type=int, default=None,
                    help="synthetic dataset size (default 4*batch, min 64; sets "
                         "the epoch length and thus the checkpoint cadence)")
    ap.add_argument("--septuplet", action="store_true",
                    help="not ported yet (ROADMAP A13)")
    ap.add_argument("--steps", type=int, default=None,
                    help="total steps (a resumed run counts from its step): "
                         "the lr schedule's horizon and where training stops")
    ap.add_argument("--model", type=str, default="rife")
    ap.add_argument("--weight_decay", type=float, default=1e-3)
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
                    help="only 1: chained steps are not ported (ROADMAP A13)")
    ap.add_argument("--vis_interval", type=int, default=0,
                    help="only 0: image panels are not ported yet (ROADMAP A13)")
    ap.add_argument("--val_interval", type=int, default=5,
                    help="validation cadence in epochs")
    ap.add_argument("--val_batches", type=int, default=None,
                    help="cap validation batches (default: the whole 5%% split)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.model != "rife":
        raise NotImplementedError(f"--model {args.model}: training is ported for "
                                  f"rife only (ROADMAP.md, queue A item 13)")
    if args.septuplet:
        raise NotImplementedError("--septuplet is not ported yet (ROADMAP.md, "
                                  "queue A item 13)")
    if args.vis_interval > 0:
        raise NotImplementedError("--vis_interval > 0: image panels are not ported "
                                  "yet (ROADMAP.md, queue A item 13)")
    if args.steps_per_call != 1:
        raise NotImplementedError("--steps_per_call > 1 is not ported (ROADMAP.md, "
                                  "queue A item 13)")
    return args


def _datasets(args):
    if args.synthetic:
        train_ds = SyntheticTriplets(n=args.synthetic_n or max(args.batch_size * 4, 64),
                                     h=args.crop + 8, w=args.crop + 8)
        # Validation frames are not cropped: size them at the crop itself.
        val_ds = SyntheticTriplets(n=args.batch_size, h=args.crop, w=args.crop, seed=7)
        val_ds.split = "validation"
        return train_ds, val_ds
    return VimeoTriplets(args.data, "train"), VimeoTriplets(args.data, "validation")


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
    os.makedirs(args.log_dir, exist_ok=True)
    train_ds, val_ds = _datasets(args)
    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    total_steps = args.steps or steps_per_epoch * args.epoch
    dtype = _DTYPES[args.dtype]
    state = train_init(model_def, total_steps=total_steps, seed=args.seed,
                       world_scale=args.batch_size / 64.0,
                       weight_decay=args.weight_decay, device=device)
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
            metrics = train_step(state, batch, dtype)
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
