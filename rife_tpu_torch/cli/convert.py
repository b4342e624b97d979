"""Checkpoint converter (port of rife_tpu/cli/convert.py): weights move
between this package's `.rtpu` files and the reference's PyTorch
checkpoints in either direction.

    # reference flownet.pkl (or a legacy trio directory) -> .rtpu
    python -m rife_tpu_torch.cli.convert --input train_log/flownet.pkl \\
        --output rife.rtpu

    # .rtpu -> reference flownet.pkl (the paper family only)
    python -m rife_tpu_torch.cli.convert --input rife.rtpu \\
        --output flownet.pkl --to torch

Import reads every format `engine.checkpoint.load_checkpoint` knows (the
paper family, v4.25, the `hdv2` and `hd` trio directories); export covers
the paper family (`models.torch_export.export_ifnet`).  Runs on the CPU.
"""
from __future__ import annotations

import argparse

PAPER_FAMILY = ("rife", "rife_m", "rife_2r")


def main(argv=None):
    ap = argparse.ArgumentParser(description="convert checkpoints")
    ap.add_argument("--input", required=True,
                    help="an .rtpu file, a torch .pkl, or a legacy trio directory")
    ap.add_argument("--output", required=True)
    ap.add_argument("--to", choices=("native", "torch"), default="native")
    ap.add_argument("--model", default=None,
                    help="model name override (default: auto-detect)")
    args = ap.parse_args(argv)

    from rife_tpu_torch.engine.checkpoint import load_checkpoint, save_params

    name, params = load_checkpoint(args.input, model=args.model)

    if args.to == "native":
        save_params(args.output, params, meta={"model": name})
        print(f"wrote {args.output} (model={name})")
        return

    if name not in PAPER_FAMILY:
        raise SystemExit(
            f"torch export supports the paper family (rife/rife_m/rife_2r); "
            f"checkpoint is '{name}'")
    from rife_tpu_torch.models.torch_export import export_ifnet, save_torch_pickle

    save_torch_pickle(args.output, export_ifnet(params))
    print(f"wrote {args.output} (reference state dict, model={name})")


if __name__ == "__main__":
    main()
