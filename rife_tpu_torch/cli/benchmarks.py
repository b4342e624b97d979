"""Benchmark harness of the port (rife_tpu/cli/benchmarks.py): the
Vimeo90K triplet protocol, with the reference's metric rules.

    python -m rife_tpu_torch.cli.benchmarks vimeo90k --root vimeo_triplet \
        --modelDir train_log_r5 [--dtype bfloat16] [--fast 2] [--device cpu]

PSNR is taken on the uint8-rounded frame and SSIM (`ssim_matlab`) on
round(pred * 255) / 255 against the ground truth (benchmark/Vimeo90K.py:
34-37).  Frames are read with cv2 and fed in its BGR order, as the
reference does.  The other benchmarks of the reference (ucf101,
middlebury, hd, hd4x, atd12k, testtime) are not ported yet (ROADMAP.md,
queue A item 12b) and raise.
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from rife_tpu_torch.engine import DTYPES, InferenceEngine, build_engine, find_checkpoint
from rife_tpu_torch.ops import ssim_matlab

NOT_PORTED = ("ucf101", "middlebury", "hd", "hd4x", "atd12k", "testtime")


def _engine(args) -> InferenceEngine:
    """The engine of `--modelDir` (a checkpoint file, or a directory
    holding `flownet.rtpu` or `flownet.pkl`; the model from the checkpoint
    unless `--model` names one), or seeded initial weights of `--model`
    (default `rife`) when there is no such file, as the reference's
    `_engine`."""
    return build_engine(find_checkpoint(args.modelDir), args.model, args.scale,
                        args.dtype, fast=args.fast, device=args.device)


def _ssim_rounded(gt01: np.ndarray, pred01: np.ndarray, device=None) -> float:
    """ssim_matlab(gt, round(pred*255)/255) (benchmark/Vimeo90K.py:34); the
    rounding in f32 on the host, the SSIM on `device`."""
    pred_r = np.round(np.clip(pred01, 0, 1) * 255.0) / 255.0
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x[None])).to(device)  # noqa: E731
    return float(ssim_matlab(as_t(gt01), as_t(pred_r), val_range=1.0))


def _triplet_bench(engine, triplets):
    """Shared PSNR/SSIM loop; triplets yields (img0, gt, img1) float01 HWC."""
    psnr_list, ssim_list = [], []
    for i, (i0, gt, i1) in enumerate(triplets):
        pred = engine.interpolate(i0[None], i1[None]).float().cpu().numpy()[0]
        ssim_list.append(_ssim_rounded(gt, pred, engine.device))
        pred_r = np.round(np.clip(pred, 0, 1) * 255.0) / 255.0
        mse = float(np.mean((gt - pred_r) ** 2))
        psnr_list.append(-10 * math.log10(mse) if mse > 0 else 100.0)
        if (i + 1) % 50 == 0:
            print(f"[{i+1}] Avg PSNR: {np.mean(psnr_list):.4f} SSIM: {np.mean(ssim_list):.4f}")
    return float(np.mean(psnr_list)), float(np.mean(ssim_list))


def read_vimeo90k(root: str):
    """The triplets of a Vimeo90K test directory (tri_testlist.txt,
    sequences/<item>/im1-3.png) as float01 BGR HWC arrays."""
    import cv2

    with open(os.path.join(root, "tri_testlist.txt")) as f:
        items = [line for line in f.read().splitlines() if line]
    for item in items:
        p = os.path.join(root, "sequences", item)
        i0, gt, i1 = (cv2.imread(os.path.join(p, f"im{k}.png")).astype(np.float32) / 255.0
                      for k in (1, 2, 3))
        yield i0, gt, i1  # BGR like the reference feeds cv2 arrays


def run_vimeo90k(args):
    """Vimeo90K triplet test (benchmark/Vimeo90K.py:14-40)."""
    p, s = _triplet_bench(engine=_engine(args), triplets=read_vimeo90k(args.root))
    print(json.dumps({"benchmark": "vimeo90k", "psnr": p, "ssim": s}))


def _not_ported(name):
    def run(args):
        raise NotImplementedError(f"the {name} benchmark is not ported yet "
                                  f"(ROADMAP.md, queue A item 12b)")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description="rife_tpu_torch benchmark harness")
    sub = ap.add_subparsers(dest="bench", required=True)
    p = sub.add_parser("vimeo90k")
    p.add_argument("--root", type=str, default=".")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--modelDir", type=str, default="train_log")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--dtype", type=str, default="float32", choices=sorted(DTYPES))
    p.add_argument("--fast", type=int, nargs="?", const=1, default=0,
                   help="measure the fast serving graph at this rung (benchmarks "
                        "default to the exact graph for protocol parity)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    p.set_defaults(fn=run_vimeo90k)
    for name in NOT_PORTED:
        sub.add_parser(name).set_defaults(fn=_not_ported(name))
    args, rest = ap.parse_known_args(argv)
    if rest and args.bench == "vimeo90k":  # the others' flags are the reference's
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.fn(args)


if __name__ == "__main__":
    main()
