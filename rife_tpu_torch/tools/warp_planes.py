"""K1, the plane warp, and its gradient on the card: each held against
its plain version, then timed at the served and training launch shapes
with the launch plans the wrappers choose.

    python -m rife_tpu_torch.tools.warp_planes [--out FILE.json]

K1 (`ops/cuda/warp.py` `launch`) at the six launches of a rung-1 `rife`
forward (batch 4, 736x1280, N = 8 pairs, bf16) and v4.25's four rung-1
launches (768x1280, 7 channels), with its plan, beside the bytes bound.
The gradient (`run_bwd`) at the 8 launches of a bf16 training step
(batch 16, 224x224 crops, N = 32, with the step's flow dtypes and d_img
where the step needs it), its call split into the d_img scratch's
memset, the kernel and the cast to bf16, the kernel's time for each
output alone, d_img's on a noise-free flow too, and the share of pixels
that handed their right taps to their neighbour.  Smooth flows of the
served size (8 px at 1280 wide, plus 0.25 px of noise), seeded; times
are device times by CUDA events around captured graphs over copies
larger than L2 (`utils.profiling.graph_ms`), the memset and the cast
over scratch tensors larger than L2 too.  `chip_smoke.py` imports
`bwd_split_ms` and `merge_share`.  Needs a card; exits non-zero without
one.  The launch plans' other layouts, pixels a thread and channel
groups were measured and dropped (PERF.md); to measure one again, build
it as a variant (`_build.build(name, defines)`).
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from rife_tpu_torch.ops import warp as tw
from rife_tpu_torch.ops.cuda import warp as cw
from rife_tpu_torch.utils.profiling import graph_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CALLS = 20
L2_BYTES = 160e6  # copies of the inputs that together exceed the 50 MB L2
# (name, N, C, H, W)
FWD_LAUNCHES = [
    ("rife half-res pair", 8, 3, 368, 640), ("rife full-res pair", 8, 3, 736, 1280),
    ("rife context 0", 8, 16, 368, 640), ("rife context 1", 8, 32, 184, 320),
    ("rife context 2", 8, 64, 92, 160), ("rife context 3", 8, 128, 46, 80),
    ("v4.25 1/8", 8, 7, 96, 160), ("v4.25 1/4", 8, 7, 192, 320),
    ("v4.25 1/2", 8, 7, 384, 640), ("v4.25 full res", 8, 7, 768, 1280),
]
# (name, N, C, H, W, flow dtype, need_img)
BWD_LAUNCHES = [
    ("level 0-2 pairs", 32, 3, 224, 224, torch.bfloat16, False),
    ("teacher pair", 32, 3, 224, 224, torch.float32, False),
    ("context level 0", 32, 16, 112, 112, torch.bfloat16, True),
    ("context level 1", 32, 32, 56, 56, torch.bfloat16, True),
    ("context level 2", 32, 64, 28, 28, torch.bfloat16, True),
    ("context level 3", 32, 128, 14, 14, torch.bfloat16, True),
]


def smooth_flow(n, h, w, gen, dtype, dev="cuda", noise=0.25):
    """A smooth flow of about 8 px at 1280 wide, plus `noise` px of noise."""
    amp = 8.0 * w / 1280
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    ph = torch.rand(n, 1, 1, device=dev, generator=gen) * 6.28
    dx = amp * torch.sin(yy / (0.11 * h) + ph) + 0.5 * amp * torch.cos(xx / (0.07 * w))
    dy = 0.7 * amp * torch.cos(xx / (0.13 * w) + ph) - 0.3 * amp * torch.sin(yy / (0.05 * h))
    f = torch.stack([dx, dy], 1) + noise * torch.randn(n, 2, h, w, device=dev, generator=gen)
    return f.to(dtype).contiguous()


def _copies(nbytes: int) -> int:
    return max(1, math.ceil(L2_BYTES / nbytes))


def merge_share(img, flow, g, need_img: bool) -> float | None:
    """The share of a gradient launch's pixels that handed their right taps
    of d_img to their right neighbour (the kernel's own count); None where
    d_img is not asked for."""
    if not need_img:
        return None
    merges = torch.zeros(2, dtype=torch.int32, device=img.device)
    scratch = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    cw.run_bwd(img, flow, g, scratch, torch.empty_like(flow), merges)
    gave, kept = (int(v) for v in merges.tolist())
    return gave / (gave + kept)


def bwd_split_ms(img, flow, g, need_img: bool, need_flow: bool = True) -> dict:
    """The gradient call's device time split: the f32 scratch's memset, the
    kernel alone (into a scratch) and the cast of the scratch to the
    image's type (both 0 where d_img is not asked for), and the whole
    `launch_bwd` call.  The memset and the cast each cycle over scratch
    tensors (and cast outputs) that together exceed L2, as the kernel's
    and the call's inputs do."""
    nbytes = 3 * img.numel() * img.element_size()
    inputs = [(img.clone(), flow.clone(), g.clone()) for _ in range(_copies(nbytes))]
    scratch = [torch.zeros(img.shape, dtype=torch.float32, device=img.device)
               for _ in range(_copies(img.numel() * 4) if need_img else 0)]
    out = {"memset_ms": 0.0, "cast_ms": 0.0}
    if need_img:
        out["memset_ms"] = graph_ms(lambda s: s.zero_(), [(s,) for s in scratch], CALLS)
        casts = [(s, torch.empty_like(img)) for s in scratch]
        out["cast_ms"] = graph_ms(lambda s, o: o.copy_(s), casts, CALLS)
        del casts
    bufs = [(a, f, b, scratch[i % len(scratch)] if need_img else None,
             torch.empty_like(flow) if need_flow else None)
            for i, (a, f, b) in enumerate(inputs)]
    out["kernel_ms"] = graph_ms(cw.run_bwd, bufs, CALLS)
    out["call_ms"] = graph_ms(lambda a, f, b: cw.launch_bwd(a, f, b, need_img, need_flow),
                              inputs, CALLS)
    return out


def fwd_records(gen) -> list:
    recs = []
    for name, n, c, h, w in FWD_LAUNCHES:
        img = torch.rand(n, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
        flow = smooth_flow(n, h, w, gen, torch.bfloat16)
        if not torch.equal(cw.launch(img, flow), tw.warp_planes_ref(img, flow)):
            raise AssertionError(f"K1 differs from its plain version: {name}")
        nbytes = 2 * img.numel() * 2 + flow.numel() * 2
        inputs = [(img.clone(), flow.clone()) for _ in range(_copies(nbytes))]
        rec = {"launch": name, "img": [n, c, h, w], "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "plan": cw.k1_plan(img, flow, 0), "ms": graph_ms(cw.launch, inputs, CALLS)}
        print(f"  {name} {tuple(img.shape)}: {rec['ms'] * 1e3:.1f} us, bound "
              f"{rec['bound_ms'] * 1e3:.1f} us ({rec['plan']['layout']})", flush=True)
        recs.append(rec)
    return recs


def bwd_records(gen) -> list:
    recs = []
    for name, n, c, h, w, flow_dtype, need_img in BWD_LAUNCHES:
        img = (torch.randn(n, c, h, w, device="cuda", generator=gen) * 3).to(torch.bfloat16)
        flow = smooth_flow(n, h, w, gen, flow_dtype)
        smooth = smooth_flow(n, h, w, gen, flow_dtype, noise=0.0)
        g = (torch.randn(n, c, h, w, device="cuda", generator=gen) * 1e-3).to(torch.bfloat16)
        split = bwd_split_ms(img, flow, g, need_img)
        rec = {"launch": name, "img": [n, c, h, w], "need_img": need_img,
               "flow_dtype": str(flow_dtype).replace("torch.", ""),
               "plan": cw.bwd_plan(img.shape), **split,
               "merge_share": merge_share(img, flow, g, need_img)}
        if need_img:  # each output alone; d_img also on a noise-free flow
            rec["d_flow_only_ms"] = bwd_split_ms(img, flow, g, False)["kernel_ms"]
            rec["d_img_only_ms"] = bwd_split_ms(img, flow, g, True, False)["kernel_ms"]
            rec["d_img_only_noise_free_ms"] = bwd_split_ms(img, smooth, g, True,
                                                           False)["kernel_ms"]
            rec["merge_share_noise_free"] = merge_share(img, smooth, g, True)
        print(f"  {name} {tuple(img.shape)} groups {rec['plan']['groups']}: kernel "
              f"{split['kernel_ms'] * 1e3:.1f} us, memset {split['memset_ms'] * 1e3:.1f}, "
              f"cast {split['cast_ms'] * 1e3:.1f}, call {split['call_ms'] * 1e3:.1f}; "
              f"d_flow only {rec.get('d_flow_only_ms', 0) * 1e3:.1f}, d_img only "
              f"{rec.get('d_img_only_ms', 0) * 1e3:.1f} (noise-free flow "
              f"{rec.get('d_img_only_noise_free_ms', 0) * 1e3:.1f}); merged "
              f"{rec['merge_share']} (noise-free {rec.get('merge_share_noise_free')})",
              flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("warp_planes: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print(f"== K1 ({torch.cuda.get_device_name(0)})", flush=True)
    fwd = fwd_records(gen)
    print("== the gradient", flush=True)
    bwd = bwd_records(gen)
    out = {"device": torch.cuda.get_device_name(0), "fwd": fwd, "bwd": bwd}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
