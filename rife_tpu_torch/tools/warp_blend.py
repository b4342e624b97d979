"""K2, the fused pair warp + sigmoid-mask blend, on the card: held against
its plain version, then timed at its two serving launches in both forms
with the launch plan the wrapper chooses.

    python -m rife_tpu_torch.tools.warp_blend [--ppt 2 4] [--blocks 32x2 160x1]
                                              [--out FILE.json]

The launches (batch 4, bf16 images, flow and mask): v4.25's final level
(3x768x1280) and the paper model's (3x736x1280), each in the blend-only
form (v4.25's) and the form that also writes w0 and w1 (`rife`'s), on a
smooth flow of the served size (8 px at 1280 wide, plus 0.25 px of
noise), seeded.  Checks (a failure raises): w0 and w1 equal to the plain
warp, the blend's differing elements against the plain version counted
(phase 3 of `chip_smoke.py` gates them).  Times are device times by CUDA
events around captured graphs over copies larger than L2
(`utils.profiling.graph_ms`), beside the bytes bound (each input read
once, each output written once, over 3.35 TB/s).  `--ppt` also builds
and times variants with other pixels a thread (`-DK2_PPT=...`, a separate
library; the shipped one is `ops/cuda/warp_blend.py` K2_PPT), `--blocks`
other blocks of tx x ty threads (the plan's grid redrawn for them; the
shipped plan's block is 32 x 2 at these widths), all in turns in one
process.  Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys

import torch

from rife_tpu_torch.ops import warp as tw
from rife_tpu_torch.ops.cuda import _build
from rife_tpu_torch.ops.cuda import warp_blend as cb
from rife_tpu_torch.tools.warp_planes import smooth_flow
from rife_tpu_torch.utils.profiling import graph_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CALLS = 20
L2_BYTES = 160e6  # copies of the inputs that together exceed the 50 MB L2
# (name, N, C, H, W)
LAUNCHES = [("v4.25 final level", 4, 3, 768, 1280), ("rife final level", 4, 3, 736, 1280)]


def inputs(gen, n, c, h, w):
    a, b = (torch.rand(n, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(2))
    flow = torch.cat([smooth_flow(n, h, w, gen, torch.bfloat16),
                      smooth_flow(n, h, w, gen, torch.bfloat16)], 1).contiguous()
    mask = (torch.randn(n, 1, h, w, device="cuda", generator=gen) * 3).to(torch.bfloat16)
    return a, b, flow, mask


def nbytes(a, flow, mask, pair: bool) -> int:
    return ((2 + (3 if pair else 1)) * a.numel() * a.element_size()
            + flow.numel() * flow.element_size() + mask.numel() * mask.element_size())


def variant(ppt: int) -> ctypes.CDLL:
    """The library built with `ppt` pixels a thread (the shipped one for
    K2_PPT)."""
    if ppt == cb.K2_PPT:
        return cb.library()
    return cb.bind(ctypes.CDLL(str(_build.build("warp_blend", (f"K2_PPT={ppt}",)).path)))


def plan_for(a, flow, mask, outs, ppt, block=None) -> dict:
    """The wrapper's plan, its grid redrawn for runs of `ppt` pixels and,
    with `block` (tx, ty), for blocks of that shape; vector runs where W
    and the addresses allow runs of `ppt`."""
    p = cb._k2_plan(a, flow, mask, outs)
    if ppt == cb.K2_PPT and block is None:
        return p
    tx, ty = block or (p["tx"], p["ty"])
    n, c, h, w = a.shape
    units = -(-w // ppt)  # threads a row needs
    vec = (w % ppt == 0 and cb.on_run(flow.data_ptr(), flow.element_size(), ppt)
           and cb.on_run(mask.data_ptr(), mask.element_size(), ppt)
           and all(cb.on_run(o, a.element_size(), ppt) for o in outs))
    gx, gy = -(-units // tx), -(-h // ty)
    return {"ppt": ppt, "gx": gx, "gy": gy, "tx": tx, "ty": ty, "tiles": gx, "rows": gy,
            "threads": tx * ty, "blocks": gx * gy * n, "vec": vec}


def call(lib, ppt, block=None):
    """K2 through `lib` with the plan for `ppt` (and `block`), as
    `cb.launch` does."""
    def fn(a, b, flow, mask, pair):
        outs = tuple(torch.empty_like(a) for _ in range(3 if pair else 1))
        cb.run(a, b, flow, mask, outs,
               plan_for(a, flow, mask, tuple(o.data_ptr() for o in outs), ppt, block), lib)
        return outs
    return fn


def records(gen, ppts, blocks=()) -> list:
    """Each launch and form: the shipped plan at each of `ppts`, then the
    shipped run size in each of `blocks`."""
    cases = [(p, None) for p in ppts] + [(cb.K2_PPT, b) for b in blocks]
    libs = {p: variant(p) for p, _ in cases}
    recs = []
    for name, n, c, h, w in LAUNCHES:
        a, b, flow, mask = inputs(gen, n, c, h, w)
        want = tw.warp2_blend_planes_ref(a, b, flow, mask, True)
        for pair in (False, True):
            size = nbytes(a, flow, mask, pair)
            copies = [(a.clone(), b.clone(), flow.clone(), mask.clone(), pair)
                      for _ in range(max(1, math.ceil(L2_BYTES / size)))]
            for p, block in cases:
                fn = call(libs[p], p, block)
                got = fn(a, b, flow, mask, pair)
                torch.cuda.synchronize()
                if pair and not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
                    raise AssertionError(f"K2 (ppt {p}, block {block}) w0/w1 differ from K1's "
                                         f"plain warp: {name}")
                differ = int((got[0] != want[0]).sum())
                plan = plan_for(a, flow, mask, (0,), p, block)
                rec = {"launch": name, "img": [n, c, h, w], "emit_pair": pair, "ppt": p,
                       "block": [plan["tx"], plan["ty"]],
                       "shipped": block is None and p == cb.K2_PPT, "plan": plan,
                       "bytes": size, "bound_ms": size / HBM_BYTES_PER_S * 1e3,
                       "blend_differ": differ, "ms": graph_ms(fn, copies, CALLS)}
                rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
                print(f"  {name} {'pair' if pair else 'blend only'} ppt {p} block "
                      f"{plan['tx']}x{plan['ty']}: {rec['ms'] * 1e3:.1f} us, bound "
                      f"{rec['bound_ms'] * 1e3:.1f} us ({rec['share_of_bound']:.1%}); {differ} "
                      f"blend elements differ from plain", flush=True)
                recs.append(rec)
            del copies
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ppt", type=int, nargs="+", default=[cb.K2_PPT],
                    help="pixels a thread to build and time (default: the shipped)")
    ap.add_argument("--blocks", nargs="+", default=[],
                    help="other blocks TXxTY to time at the shipped run size")
    ap.add_argument("--out", help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    blocks = [tuple(int(v) for v in b.split("x")) for b in args.blocks]
    if not torch.cuda.is_available():
        print("warp_blend: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print(f"== K2 ({torch.cuda.get_device_name(0)})", flush=True)
    out = {"device": torch.cuda.get_device_name(0), "records": records(gen, args.ppt, blocks)}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
