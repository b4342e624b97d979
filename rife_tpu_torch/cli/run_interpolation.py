"""Headless pair -> video wrapper (port of rife_tpu/cli/run_interpolation.py;
reference rife_app/run_interpolation.py:14-49).

    python -m rife_tpu_torch.cli.run_interpolation img0.png img1.png out.mp4 \
        --passes 4 [--disk-based] [--modelDir train_log] [--device cpu]

The serving engine (`serve.app.load_engine`: bf16 at the configured
rung) on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("img0")
    ap.add_argument("img1")
    ap.add_argument("output")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--disk-based", action="store_true")
    ap.add_argument("--modelDir", default="train_log")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from rife_tpu_torch.engine import resolve_device
    from rife_tpu_torch.serve.app import load_engine
    from rife_tpu_torch.serve.services import interpolate_pair_to_video
    from rife_tpu_torch.utils.imageio import read_image

    engine = load_engine(args.modelDir, device=resolve_device(args.device))
    if engine is None:
        raise SystemExit("model failed to load")
    img0, _ = read_image(args.img0)
    img1, _ = read_image(args.img1)
    stats = interpolate_pair_to_video(
        engine, img0, img1, args.output,
        passes=args.passes, fps=args.fps, disk_based=args.disk_based,
    )
    print(stats)


if __name__ == "__main__":
    main()
