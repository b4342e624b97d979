"""Minimal demo through the PyTorch/CUDA port (the counterpart of
examples/demo.py): interpolate a midpoint between two frames and write a
side-by-side strip plus a small slow-motion mp4.

    python examples/demo_torch.py I0.png I1.png [--out demo_out] [--device cpu]

Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("img0")
    ap.add_argument("img1")
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--modelDir", default="train_log")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from rife_tpu_torch.engine import build_engine, exp_doubling, find_checkpoint
    from rife_tpu_torch.ops import pad_to_multiple
    from rife_tpu_torch.utils.imageio import read_image, write_image

    engine = build_engine(find_checkpoint(args.modelDir), None, device=args.device)

    i0, _ = read_image(args.img0)
    i1, _ = read_image(args.img1)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x[None])).to(engine.device)  # noqa: E731
    a, pad = pad_to_multiple(as_t(i0), engine.pad_multiple)
    b, _ = pad_to_multiple(as_t(i1), engine.pad_multiple)
    fetch = lambda f: pad.crop(f)[0].float().cpu().numpy()  # noqa: E731

    mid = fetch(engine.interpolate(a, b))
    os.makedirs(args.out, exist_ok=True)
    write_image(os.path.join(args.out, "mid.png"), mid)
    strip = np.concatenate([i0, mid, i1], axis=1)
    write_image(os.path.join(args.out, "strip.png"), strip)

    frames = exp_doubling(engine, [a, b], 3)
    try:
        from rife_tpu_torch.serve.services import _encode_frames

        _encode_frames([fetch(f) for f in frames], os.path.join(args.out, "slomo.mp4"), fps=8)
        print(f"wrote {args.out}/mid.png, strip.png, slomo.mp4")
    except Exception as e:
        print(f"wrote {args.out}/mid.png, strip.png (video encode unavailable: {e})")


if __name__ == "__main__":
    main()
