"""Benchmark harness of the port (rife_tpu/cli/benchmarks.py): the
reference's de-facto regression suite (benchmark/*.py) as one CLI with
exact metric protocols.

    python -m rife_tpu_torch.cli.benchmarks vimeo90k   --root vimeo_triplet
    python -m rife_tpu_torch.cli.benchmarks ucf101     --root UCF101/ucf101_interp_ours
    python -m rife_tpu_torch.cli.benchmarks middlebury --root other-data --gt other-gt-interp
    python -m rife_tpu_torch.cli.benchmarks hd         --root HD_dataset
    python -m rife_tpu_torch.cli.benchmarks hd4x       --root HD_dataset
    python -m rife_tpu_torch.cli.benchmarks atd12k     --root datasets/test_2k_540p
    python -m rife_tpu_torch.cli.benchmarks testtime

Each takes `--modelDir`, `--model`, `--scale`, `--dtype`, `--fast` and
`--device` (default: the card; `cpu` runs the plain PyTorch path).  PSNR
is taken on the uint8-rounded frame and SSIM (`ssim_matlab`) on
round(pred * 255) / 255 against the ground truth (benchmark/Vimeo90K.py:
34-37).  PNG frames are read with cv2 and fed in its BGR order, as the
reference does; the HD clips are raw YUV420 (`video.yuv`).  Each prints
one JSON line with the reference's keys.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from rife_tpu_torch.engine import DTYPES, InferenceEngine, build_engine, find_checkpoint
from rife_tpu_torch.metrics import interpolation_error, rgb_to_y
from rife_tpu_torch.ops import ssim_matlab


def _engine(args, default_model: str | None = None) -> InferenceEngine:
    """The engine of `--modelDir` (a checkpoint file, or a directory
    holding `flownet.rtpu` or `flownet.pkl`; the model from the checkpoint
    unless `--model` names one), or seeded initial weights of `--model`
    when there is no such file, else of `default_model` (else `rife`).
    `default_model` applies only when no checkpoint file resolves, so hd4x
    can refuse a loaded fixed-midpoint model instead of forcing rife_m
    onto its weights (the reference's `_engine`)."""
    ckpt = find_checkpoint(args.modelDir)
    model = args.model if args.model else (None if ckpt else default_model)
    return build_engine(ckpt, model, args.scale, args.dtype, fast=args.fast,
                        device=args.device)


def _ssim_rounded(gt01: np.ndarray, pred01: np.ndarray, device=None) -> float:
    """ssim_matlab(gt, round(pred*255)/255) (benchmark/Vimeo90K.py:34); the
    rounding in f32 on the host, the SSIM on `device`."""
    pred_r = np.round(np.clip(pred01, 0, 1) * 255.0) / 255.0
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x[None])).to(device)  # noqa: E731
    return float(ssim_matlab(as_t(gt01), as_t(pred_r), val_range=1.0))


def _fetch(frame: torch.Tensor) -> np.ndarray:
    """A frame (cropped on the device) as float32 numpy on the host."""
    return frame.float().cpu().numpy()


def _psnr_rounded(gt01: np.ndarray, pred01: np.ndarray) -> float:
    pred_r = np.round(np.clip(pred01, 0, 1) * 255.0) / 255.0
    mse = float(np.mean((gt01 - pred_r) ** 2))
    return -10 * math.log10(mse) if mse > 0 else 100.0


def _triplet_bench(engine, triplets):
    """Shared PSNR/SSIM loop; triplets yields (img0, gt, img1) float01 HWC."""
    psnr_list, ssim_list = [], []
    for i, (i0, gt, i1) in enumerate(triplets):
        pred = _fetch(engine.interpolate(i0[None], i1[None])[0])
        ssim_list.append(_ssim_rounded(gt, pred, engine.device))
        psnr_list.append(_psnr_rounded(gt, pred))
        if (i + 1) % 50 == 0:
            print(f"[{i+1}] Avg PSNR: {np.mean(psnr_list):.4f} SSIM: {np.mean(ssim_list):.4f}")
    return float(np.mean(psnr_list)), float(np.mean(ssim_list))


def _imread01(path: str) -> np.ndarray:
    import cv2

    return cv2.imread(path).astype(np.float32) / 255.0


def read_vimeo90k(root: str):
    """The triplets of a Vimeo90K test directory (tri_testlist.txt,
    sequences/<item>/im1-3.png) as float01 BGR HWC arrays."""
    with open(os.path.join(root, "tri_testlist.txt")) as f:
        items = [line for line in f.read().splitlines() if line]
    for item in items:
        p = os.path.join(root, "sequences", item)
        i0, gt, i1 = (_imread01(os.path.join(p, f"im{k}.png")) for k in (1, 2, 3))
        yield i0, gt, i1  # BGR like the reference feeds cv2 arrays


def run_vimeo90k(args):
    """Vimeo90K triplet test (benchmark/Vimeo90K.py:14-40)."""
    p, s = _triplet_bench(engine=_engine(args), triplets=read_vimeo90k(args.root))
    print(json.dumps({"benchmark": "vimeo90k", "psnr": p, "ssim": s}))


def run_ucf101(args):
    """UCF101 DVF pairs (benchmark/UCF101.py:19-39)."""
    dirs = sorted(os.listdir(args.root))

    def gen():
        for d in dirs:
            p = os.path.join(args.root, d)
            i0 = _imread01(os.path.join(p, "frame_00.png"))
            i1 = _imread01(os.path.join(p, "frame_02.png"))
            gt = _imread01(os.path.join(p, "frame_01_gt.png"))
            yield i0, gt, i1

    p, s = _triplet_bench(engine=_engine(args), triplets=gen())
    print(json.dumps({"benchmark": "ucf101", "psnr": p, "ssim": s}))


_MIDDLEBURY = ["Beanbags", "Dimetrodon", "DogDance", "Grove2", "Grove3", "Hydrangea",
               "MiniCooper", "RubberWhale", "Urban2", "Urban3", "Venus", "Walking"]


def run_middlebury(args):
    """MiddleBury OTHER IE (benchmark/MiddleBury_Other.py:19-37): inputs are
    zero-padded into a fixed 640x480 canvas, IE on the cropped output."""
    import cv2

    engine = _engine(args)
    ie_list = []
    for name in _MIDDLEBURY:
        i0 = _imread01(os.path.join(args.root, name, "frame10.png"))
        i1 = _imread01(os.path.join(args.root, name, "frame11.png"))
        gt = cv2.imread(os.path.join(args.gt, name, "frame10i11.png"))
        h, w = i0.shape[:2]
        c0 = np.zeros((480, 640, 3), np.float32)
        c1 = np.zeros((480, 640, 3), np.float32)
        c0[:h, :w] = i0
        c1[:h, :w] = i1
        pred = _fetch(engine.interpolate(c0[None], c1[None])[0, :h, :w])
        ie_list.append(interpolation_error(pred, gt))
        print(f"{name}: running IE {np.mean(ie_list):.4f}")
    print(json.dumps({"benchmark": "middlebury_other", "ie": float(np.mean(ie_list))}))


def _hd_clips(root):
    # (path, height, width) list (benchmark/HD.py:21-33).
    return [
        (os.path.join(root, "HD720p_GT", n), 720, 1280)
        for n in ("parkrun_1280x720_50.yuv", "shields_1280x720_60.yuv", "stockholm_1280x720_60.yuv")
    ] + [
        (os.path.join(root, "HD1080p_GT", n), 1080, 1920)
        for n in ("BlueSky.yuv", "Kimono1_1920x1080_24.yuv", "ParkScene_1920x1080_24.yuv",
                  "sunflower_1080p25.yuv")
    ] + [
        (os.path.join(root, "HD544p_GT", n), 544, 1280)
        for n in ("Sintel_Alley2_1280x544.yuv", "Sintel_Market5_1280x544.yuv",
                  "Sintel_Temple1_1280x544.yuv", "Sintel_Temple2_1280x544.yuv")
    ]


def _replication_pad_h(img01: np.ndarray, pad: int) -> np.ndarray:
    return np.pad(img01, ((pad, pad), (0, 0), (0, 0)), mode="edge")


def _clip_list(args):
    """--clips "path:h:w,..." overrides the canonical HD clip table
    (benchmark/HD.py:21-33) — used for protocol tests on synthetic clips."""
    if getattr(args, "clips", None):
        out = []
        for spec in args.clips.split(","):
            path, h, w = spec.rsplit(":", 2)
            out.append((path, int(h), int(w)))
        return out
    return _hd_clips(args.root)


def _hd_pad(h: int) -> int:
    return 24 if h == 720 else (4 if h == 1080 else 16)


def _y_psnr(gt_u8: np.ndarray, pred01: np.ndarray) -> float:
    """The HD protocol's Y-PSNR: the prediction rounded to uint8, both
    frames' luma on the 0-255 scale (benchmark/HD.py:70-80)."""
    out = np.round(np.clip(pred01, 0, 1) * 255.0).astype(np.uint8)
    diff = rgb_to_y(gt_u8 / 255.0) * 255 - rgb_to_y(out / 255.0) * 255
    return 20 * math.log10(255.0 / math.sqrt(float(np.mean(diff**2))))


def run_hd(args):
    """HD 2X midframe Y-PSNR (benchmark/HD.py:21-89): evens->odd midframe
    over the first 100 frames; ReplicationPad 24/4/16 rows by height."""
    from rife_tpu_torch.video.yuv import YUV420Reader

    engine = _engine(args)
    tot = []
    for path, h, w in _clip_list(args):
        if not os.path.exists(path):
            print(f"skip missing {path}")
            continue
        reader = YUV420Reader(path, w, h)
        pad = _hd_pad(h)
        psnr_list = []
        for index in range(0, 100, 2):
            f0 = reader.read_rgb(index)
            gt = reader.read_rgb(index + 1)
            f2 = reader.read_rgb(index + 2)
            if f2 is None or gt is None:
                break
            i0 = _replication_pad_h(f0.astype(np.float32) / 255.0, pad)
            i1 = _replication_pad_h(f2.astype(np.float32) / 255.0, pad)
            pred = _fetch(engine.interpolate(i0[None], i1[None])[0, pad:-pad])
            psnr_list.append(_y_psnr(gt, pred))
        reader.close()
        m = float(np.mean(psnr_list))
        print(f"{os.path.basename(path)}: {m:.4f}")
        tot.append(m)
    print(json.dumps({"benchmark": "hd", "psnr_y": float(np.mean(tot))}))


def run_hd4x(args):
    """HD multi-4X with the timestep model (benchmark/HD_multi_4X.py:16-105):
    frames i..i+4, predictions at t=1/4, 2/4, 3/4 vs ground truth."""
    from rife_tpu_torch.video.yuv import YUV420Reader

    engine = _engine(args, default_model="rife_m")
    if not engine.supports_timestep:
        # A checkpoint that auto-detects as plain "rife" would compute the
        # midpoint for every t=k/4 (the model ignores the timestep): fail
        # loudly instead of publishing a wrong protocol number.
        raise SystemExit(
            f"hd4x needs a timestep-conditioned model; loaded "
            f"'{engine.model_name}' is fixed-midpoint. Pass --model "
            "rife_m with a matching checkpoint."
        )
    groups = {}
    for path, h, w in _clip_list(args):
        if not os.path.exists(path):
            print(f"skip missing {path}")
            continue
        reader = YUV420Reader(path, w, h)
        pad = _hd_pad(h)
        psnr_list = []
        for index in range(0, 100, 4):
            f0 = reader.read_rgb(index)
            f4 = reader.read_rgb(index + 4)
            if f4 is None:
                break
            i0 = _replication_pad_h(f0.astype(np.float32) / 255.0, pad)
            i1 = _replication_pad_h(f4.astype(np.float32) / 255.0, pad)
            for k in (1, 2, 3):
                gt = reader.read_rgb(index + k)
                if gt is None:
                    break
                pred = _fetch(engine.interpolate(i0[None], i1[None],
                                                 timestep=k / 4)[0, pad:-pad])
                psnr_list.append(_y_psnr(gt, pred))
        reader.close()
        groups.setdefault(h, []).append(float(np.mean(psnr_list)))
        print(f"{os.path.basename(path)}: {groups[h][-1]:.4f}")
    result = {f"psnr_{k}p": float(np.mean(v)) for k, v in groups.items() if v}
    print(json.dumps({"benchmark": "hd_multi_4x", **result}))


def run_atd12k(args):
    """ATD12K anime triplets (benchmark/ATD12K.py:19-42): ReplicationPad
    [0,0,2,2] rows, crop back before metrics."""
    engine = _engine(args)
    dirs = sorted(os.listdir(args.root))
    psnr_list, ssim_list = [], []
    for d in dirs:
        p = os.path.join(args.root, d)
        i0 = _imread01(os.path.join(p, "frame1.png"))
        gt = _imread01(os.path.join(p, "frame2.png"))
        i1 = _imread01(os.path.join(p, "frame3.png"))
        i0p = _replication_pad_h(i0, 2)
        i1p = _replication_pad_h(i1, 2)
        pred = _fetch(engine.interpolate(i0p[None], i1p[None])[0, 2:-2])
        ssim_list.append(_ssim_rounded(gt, pred, engine.device))
        psnr_list.append(_psnr_rounded(gt, pred))
    print(json.dumps({
        "benchmark": "atd12k",
        "psnr": float(np.mean(psnr_list)),
        "ssim": float(np.mean(ssim_list)),
    }))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_testtime(args):
    """Latency probe (benchmark/testtime.py:9-29): `--warmup` then
    `--iters` timed single-pair inferences at 480x640 (already %32).  The
    host clock runs between two device synchronisations, so it times the
    forwards, not the launch queue."""
    engine = _engine(args)
    i0 = torch.zeros((1, 480, 640, 3), dtype=engine.compute_dtype, device=engine.device)
    i1 = torch.zeros((1, 480, 640, 3), dtype=engine.compute_dtype, device=engine.device)
    for _ in range(args.warmup):
        engine.interpolate(i0, i1)
    _sync(engine.device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        engine.interpolate(i0, i1)
    _sync(engine.device)
    dt = (time.perf_counter() - t0) / args.iters
    print(json.dumps({"benchmark": "testtime", "seconds_per_frame": dt,
                      "fps": 1.0 / dt}))


BENCHMARKS = {
    "vimeo90k": run_vimeo90k,
    "ucf101": run_ucf101,
    "middlebury": run_middlebury,
    "hd": run_hd,
    "hd4x": run_hd4x,
    "atd12k": run_atd12k,
    "testtime": run_testtime,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="rife_tpu_torch benchmark harness")
    sub = ap.add_subparsers(dest="bench", required=True)
    for name, fn in BENCHMARKS.items():
        p = sub.add_parser(name)
        p.add_argument("--root", type=str, default=".")
        p.add_argument("--gt", type=str, default="other-gt-interp")
        p.add_argument("--model", type=str, default=None)
        p.add_argument("--modelDir", type=str, default="train_log")
        p.add_argument("--scale", type=float, default=1.0)
        p.add_argument("--dtype", type=str, default="float32", choices=sorted(DTYPES))
        p.add_argument("--fast", type=int, nargs="?", const=1, default=0,
                       help="measure the fast serving graph at this rung (benchmarks "
                            "default to the exact graph for protocol parity)")
        p.add_argument("--clips", type=str, default=None,
                       help="override HD clip table: 'path:h:w,...'")
        p.add_argument("--warmup", type=int, default=100)
        p.add_argument("--iters", type=int, default=100)
        p.add_argument("--device", type=str, default=None,
                       help="torch device (default: the card)")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
