"""Image-pair interpolation CLI (port of rife_tpu/cli/interp_img.py;
reference inference_img.py).

    python -m rife_tpu_torch.cli.interp_img --img a.png b.png --exp 4
    python -m rife_tpu_torch.cli.interp_img --img a.png b.png --ratio 0.375

The reference's flags: --exp gives 2^exp - 1 frames between the two by
whole-list midpoint doubling, --ratio bisects to an arbitrary t
(--rthreshold, --rmaxcycles; inference_img.py:70-93).  EXR pairs are
processed and written as half floats.  --device picks the torch device
(default: the card; `cpu` runs the plain PyTorch path).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from rife_tpu_torch.engine import (DTYPES, bisect_to_ratio, build_engine, exp_doubling,
                                   find_checkpoint)
from rife_tpu_torch.models.registry import MODEL_REGISTRY
from rife_tpu_torch.ops import pad_to_multiple
from rife_tpu_torch.utils.imageio import read_image, write_image


def main(argv=None):
    ap = argparse.ArgumentParser(description="frame interpolation for a pair of images")
    ap.add_argument("--img", nargs=2, required=True)
    ap.add_argument("--exp", type=int, default=4)
    ap.add_argument("--ratio", type=float, default=0.0,
                    help="inference ratio between two images with 0 - 1 range")
    ap.add_argument("--rthreshold", type=float, default=0.02,
                    help="returns image when actual ratio falls in given range threshold")
    ap.add_argument("--rmaxcycles", type=int, default=8,
                    help="limit max number of bisectional cycles")
    ap.add_argument("--model", type=str, default=None,
                    choices=sorted(MODEL_REGISTRY), help="model preset")
    ap.add_argument("--modelDir", type=str, default="train_log",
                    help="directory or file with trained model checkpoint")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--dtype", type=str, default="float32", choices=sorted(DTYPES))
    ap.add_argument("--output", type=str, default="output")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    engine = build_engine(find_checkpoint(args.modelDir), args.model, args.scale,
                          args.dtype, device=args.device)

    try:
        img0_np, exr0 = read_image(args.img[0])
        img1_np, exr1 = read_image(args.img[1])
    except FileNotFoundError as e:
        ap.error(f"cannot read input image: {e}")
    is_exr = exr0 and exr1
    mult = engine.pad_multiple
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x[None])).to(engine.device)  # noqa: E731
    img0, pad = pad_to_multiple(as_t(img0_np), mult)
    img1, _ = pad_to_multiple(as_t(img1_np), mult)

    if args.ratio:
        mid = bisect_to_ratio(engine, img0, img1, args.ratio,
                              threshold=args.rthreshold, max_cycles=args.rmaxcycles)
        img_list = [img0, mid, img1]
    else:
        img_list = exp_doubling(engine, [img0, img1], args.exp)

    os.makedirs(args.output, exist_ok=True)
    for i, im in enumerate(img_list):
        out = pad.crop(im)[0].float().cpu().numpy()
        name = os.path.join(args.output, f"img{i}.exr" if is_exr else f"img{i}.png")
        write_image(name, out, is_exr)
    print(f"wrote {len(img_list)} frames to {args.output}/")


if __name__ == "__main__":
    main()
