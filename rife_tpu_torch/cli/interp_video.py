"""Video interpolation CLI (port of rife_tpu/cli/interp_video.py;
reference inference_video.py:56-297).

    python -m rife_tpu_torch.cli.interp_video --video in.mp4 --exp 1
    python -m rife_tpu_torch.cli.interp_video --img framedir/ --exp 2 --png

The reference's flags: --video/--img, --exp or --fps, --scale (--UHD
means 0.5), --png, --montage, --skip (a no-op kept for compatibility),
--ext, --output, --tta, --model, --modelDir, --dtype (bfloat16) and the
fast rung (--fast, default 1; --exact is rung 0).  The default output
name is {base}_{2^exp}X_{fps}fps.{ext}; the audio is carried over only
when --fps is not given (inference_video.py:128-131, 151).  --device
picks the torch device (default: the card; `cpu` runs the plain PyTorch
path).
"""
from __future__ import annotations

import argparse
import os

from rife_tpu_torch.engine import DTYPES, build_engine, find_checkpoint
from rife_tpu_torch.models.registry import MODEL_REGISTRY
from rife_tpu_torch.video import (PngDirReader, PngDirWriter, VideoJob, VideoReader,
                                  VideoWriter, interpolate_video, transfer_audio)


def main(argv=None):
    ap = argparse.ArgumentParser(description="interpolation for a video")
    ap.add_argument("--video", type=str, default=None)
    ap.add_argument("--img", type=str, default=None, help="numbered-png frame directory")
    ap.add_argument("--output", type=str, default=None)
    ap.add_argument("--montage", action="store_true")
    ap.add_argument("--UHD", action="store_true", help="support 4k video; implies --scale 0.5")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--skip", action="store_true",
                    help="deprecated flag kept for compatibility (no-op)")
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--png", action="store_true", help="write png frames instead of video")
    ap.add_argument("--ext", type=str, default="mp4")
    ap.add_argument("--exp", type=int, default=1)
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--model", type=str, default=None, choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--modelDir", type=str, default="train_log")
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--fast", dest="fast", type=int, nargs="?", const=1, default=1,
                    help="fast-rung ladder: 1 = coarse-level warps at consumer "
                         "resolution (default), 2 = + half-res refine")
    ap.add_argument("--exact", dest="fast", action="store_const", const=0,
                    help="the exact full-resolution graph (reference parity mode)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.video is None and args.img is None:
        ap.error("need --video or --img")
    if args.UHD and args.scale == 1.0:
        args.scale = 0.5
    if args.scale not in (0.25, 0.5, 1.0, 2.0, 4.0):
        ap.error(f"--scale {args.scale}: one of 0.25, 0.5, 1.0, 2.0, 4.0")
    if args.skip:
        print("--skip is abandoned (a no-op kept for compatibility).")

    engine = build_engine(find_checkpoint(args.modelDir), args.model, args.scale,
                          args.dtype, fast=args.fast, device=args.device)

    if args.video:
        try:
            reader = VideoReader(args.video)
        except FileNotFoundError:
            ap.error(f"cannot open video: {args.video}")
        base = os.path.splitext(os.path.basename(args.video))[0]
    else:
        reader = PngDirReader(args.img)
        base = "frames"
        args.png = True

    mult = 1 << args.exp
    out_fps = args.fps if args.fps else reader.fps * mult
    if args.output:
        out_path = args.output
    elif args.png:
        out_path = "vid_out"
    else:
        out_path = f"{base}_{mult}X_{int(round(out_fps))}fps.{args.ext}"

    if args.png:
        writer = PngDirWriter(out_path)
    else:
        # A montage frame is the source's centre half beside the output of
        # the centre half: 2 * (width // 2) wide.
        w = 2 * (reader.width // 2) if args.montage else reader.width
        writer = VideoWriter(out_path, out_fps, w, reader.height)

    job = VideoJob(exp=args.exp, montage=args.montage, tta=args.tta,
                   use_timestep=engine.supports_timestep)
    stats = interpolate_video(engine, reader, writer, job)
    writer.close()

    if args.video and not args.png and args.fps is None:
        print(transfer_audio(args.video, out_path))
    print(stats)


if __name__ == "__main__":
    main()
