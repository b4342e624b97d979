"""Evaluate a checkpoint through the port's Vimeo90K protocol at every
serving configuration of the paper model's ladder (the nine labels of
tools/r4_eval_checkpoint.py), on the card or the CPU.

    python tools/port_eval_checkpoint.py train_log_r5 [--device cpu]
        [--reference] [--configs exact-f32,fast2-f32] [--n 32]
        [--write-root DIR] [--out results.json]

The fixture is r4's: 32 held-out synthetic triplets (the port's
`SyntheticTriplets`, 256x448, seed 777), in memory by default (so the
card's machine needs no cv2), or written as a Vimeo90K directory with
cv2 (`--write-root`) and read back through the protocol's reader; a PNG
round trip is lossless, so both give the same arrays.  Each row is
printed with its PSNR/SSIM, its delta to the port's exact-f32 row and its
delta to the checkpoint's `eval_protocol.json` (written by r4's tool on a
TPU v5e, whose f32 warp rounds its taps to bf16: a reference point, not a
gate).  `--reference` also runs rife_tpu's own protocol
(`rife_tpu.cli.benchmarks.run_vimeo90k`) on the CPU over the same
fixture written to a temporary directory, for the f32 rows; it needs JAX
and is the only part of this tool that imports rife_tpu.  The results
are written to `--out` after each stage (the port's rows, rife_tpu's),
before any delta is computed.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# (label, dtype, rung): tools/r4_eval_checkpoint.py:64-78.
CONFIGS = (
    ("exact-f32", "float32", 0), ("exact-bf16", "bfloat16", 0),
    ("fast-f32", "float32", 1), ("fast-bf16", "bfloat16", 1),
    ("fast2-f32", "float32", 2), ("fast2-bf16", "bfloat16", 2),
    ("fast3-f32", "float32", 3), ("fast3-bf16", "bfloat16", 3),
    ("fast4-bf16", "bfloat16", 4),
)
SEED = 777  # r4's fixture


def fixture_u8(n: int = 32, seed: int = SEED):
    """r4's fixture as uint8 (img0, gt, img1) triplets, HWC, in the order
    the reference's writer saves them as im1, im2, im3."""
    from rife_tpu_torch.data.vimeo import SyntheticTriplets

    ds = SyntheticTriplets(n=n, h=256, w=448, seed=seed)
    return [ds.load(i)[:3] for i in range(n)]


def fixture(n: int = 32, seed: int = SEED):
    """The fixture as the protocol reads it: float01 (img0, gt, img1)."""
    return [tuple(f.astype(np.float32) / 255.0 for f in t) for t in fixture_u8(n, seed)]


def write_fixture(root: str, n: int = 32, seed: int = SEED) -> None:
    """The fixture as a Vimeo90K test directory (tools/r4_eval_checkpoint.py
    `build_fixture`'s layout)."""
    import cv2

    items = []
    for i, frames in enumerate(fixture_u8(n, seed)):
        d = os.path.join(root, "sequences", f"{i:05d}", "0001")
        os.makedirs(d, exist_ok=True)
        for name, img in zip(("im1", "im2", "im3"), frames):
            cv2.imwrite(os.path.join(d, f"{name}.png"), img)
        items.append(f"{i:05d}/0001")
    with open(os.path.join(root, "tri_testlist.txt"), "w") as f:
        f.write("\n".join(items) + "\n")


def port_rows(ckpt: str, triplets, labels, device=None, log=print) -> dict:
    """The port's protocol for each configuration in `labels` -> {label:
    {"psnr", "ssim", "seconds"}}."""
    import torch

    from rife_tpu_torch.cli.benchmarks import _triplet_bench
    from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax

    name, tree = load_checkpoint(ckpt)
    sd = state_dict_from_jax(tree, model=name)
    rows = {}
    for label, dtype, rung in CONFIGS:
        if label not in labels:
            continue
        t0 = time.perf_counter()
        eng = InferenceEngine(name, sd, compute_dtype=getattr(torch, dtype), fast=rung,
                              device=device)
        p, s = _triplet_bench(eng, triplets)
        rows[label] = {"psnr": p, "ssim": s, "seconds": time.perf_counter() - t0}
        log(f"  port {label}: PSNR {p:.4f} dB, SSIM {s:.6f} "
            f"({rows[label]['seconds']:.1f} s)")
        del eng
    return rows


def reference_rows(ckpt_dir: str, labels, n: int, log=print) -> dict:
    """rife_tpu's own Vimeo90K protocol on the CPU over the fixture written
    to a temporary directory, for each f32 configuration in `labels`."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from rife_tpu.cli.benchmarks import run_vimeo90k

    rows = {}
    with tempfile.TemporaryDirectory() as root:
        write_fixture(root, n)
        for label, dtype, rung in CONFIGS:
            if label not in labels or dtype != "float32":
                continue
            args = argparse.Namespace(root=root, modelDir=ckpt_dir, model=None, scale=1.0,
                                      dtype=dtype, fast=rung)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                run_vimeo90k(args)
            line = [x for x in buf.getvalue().splitlines() if x.startswith("{")][-1]
            r = json.loads(line)
            rows[label] = {"psnr": r["psnr"], "ssim": r["ssim"],
                           "seconds": time.perf_counter() - t0}
            log(f"  rife_tpu (CPU) {label}: PSNR {r['psnr']:.4f} dB, SSIM {r['ssim']:.6f}")
    return rows


def deltas(results: dict, tpu: dict) -> dict:
    """Each port row against the port's exact-f32 (when that row was run),
    rife_tpu's CPU row and the TPU JSON's row, where those exist."""
    port, ref = results["port"], results.get("reference_cpu", {})
    out = {}
    for label, row in port.items():
        d = {}
        for name, other in (("vs_port_exact_f32", port.get("exact-f32")),
                            ("vs_rife_tpu_cpu", ref.get(label)),
                            ("vs_tpu_json", tpu.get(label))):
            if other is not None:
                d[name] = {"psnr": row["psnr"] - other["psnr"],
                           "ssim": row["ssim"] - other["ssim"]}
        out[label] = d
    return out


def _write(path, results):
    if path:
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
            f.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt_dir", help="a directory holding flownet.rtpu (and, for the "
                                     "TPU rows, eval_protocol.json)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of the labels (default: all nine)")
    ap.add_argument("--reference", action="store_true",
                    help="also run rife_tpu's protocol on the CPU for the f32 rows")
    ap.add_argument("--write-root", default=None,
                    help="write the fixture as a Vimeo90K directory here and read it "
                         "back with cv2 (default: in memory)")
    ap.add_argument("--out", default=None, help="write the results JSON here")
    args = ap.parse_args(argv)
    labels = [c[0] for c in CONFIGS]
    if args.configs:
        unknown = set(args.configs.split(",")) - set(labels)
        if unknown:
            ap.error(f"unknown labels {sorted(unknown)}; the labels: {labels}")
        labels = [x for x in labels if x in args.configs.split(",")]
    ckpt = os.path.join(args.ckpt_dir, "flownet.rtpu")
    tpu_path = os.path.join(args.ckpt_dir, "eval_protocol.json")
    tpu = {}
    if os.path.exists(tpu_path):
        with open(tpu_path) as f:
            tpu = json.load(f)

    if args.write_root:
        from rife_tpu_torch.cli.benchmarks import read_vimeo90k

        write_fixture(args.write_root, args.n)
        triplets = list(read_vimeo90k(args.write_root))
    else:
        triplets = fixture(args.n)
    results = {"fixture": {"kind": "SyntheticTriplets", "n": args.n, "h": 256, "w": 448,
                           "seed": SEED,
                           "form": "directory" if args.write_root else "memory"},
               "checkpoint": ckpt, "device": args.device or "cuda", "port": {}}
    results["port"] = port_rows(ckpt, triplets, labels, args.device)
    _write(args.out, results)
    if args.reference:
        results["reference_cpu"] = reference_rows(args.ckpt_dir, labels, args.n)
        _write(args.out, results)
    results["tpu_json"] = {k: {"psnr": v["psnr"], "ssim": v["ssim"]} for k, v in tpu.items()}
    results["deltas"] = deltas(results, tpu)
    for label, d in results["deltas"].items():
        row = results["port"][label]
        parts = [f"{k} {v['psnr']:+.4f} dB / {v['ssim']:+.6f}" for k, v in d.items()]
        print(f"{label}: PSNR {row['psnr']:.4f} dB, SSIM {row['ssim']:.6f}; "
              + "; ".join(parts), flush=True)
    _write(args.out, results)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
