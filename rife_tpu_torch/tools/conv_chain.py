"""K5, the IFBlock convblock chain kernel: held against its plain version
and timed beside cuDNN's chain and the tensor-core bound.

    python -m rife_tpu_torch.tools.conv_chain               # on the card
    python -m rife_tpu_torch.tools.conv_chain --device cpu  # plain version only
    python -m rife_tpu_torch.tools.conv_chain --profile     # where a stage's time goes

Counterpart of tools/r3_exp50_pallasconv.py's `main`.  On the CPU it runs
the plain version at a tiny shape against the port's own `ConvPReLU` loop
and exits.  On the card it prints the stage kernel's registers, spills
(nvcc -Xptxas -v), shared memory and ring slots per width, holds the
kernel to the plain version at the three convblock shapes of a served
`rife` request (batch 4, 720p padded to 736x1280, rung 1: block0
4x46x80x240, block1 4x92x160x150, block2 4x184x320x90) and at C = 12 on
2x7x9 (a channel tail), with 1 and 8 stages, on seeded weights and
inputs; then at the three served shapes it gives the kernel's tiles and
waves and times the whole `conv_chain` call, its parts (the copy of x
into the zero-bordered flat layout, the parameters' padding, the 8
launches alone), the same chain through cuDNN (the port's `ConvPReLU`
modules in bf16, channels-last and NCHW, and the convs alone without
their PReLU), the NCHW -> NHWC copy the model's planes would need, and
the plain version once, beside the tensor-core bound.  `chip_smoke.py`
imports these functions.  Times are device times by CUDA events
(`utils.profiling.graph_ms`).
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

from rife_tpu_torch.nn import ConvPReLU
from rife_tpu_torch.ops.conv_chain import (WIDE, WIDTHS, conv_chain, conv_chain_ref,
                                           conv_stage_ref, geometry, kernel_params,
                                           pack_chain, run_stages, to_flat)
from rife_tpu_torch.ops.cuda import _build
from rife_tpu_torch.ops.cuda import conv_chain as _cuda
from rife_tpu_torch.utils.profiling import graph_ms


def served_shapes(batch: int = 4, h: int = 736, w: int = 1280,
                  widths=(240, 150, 90)) -> tuple:
    """(name, N, H, W, C) of the convblock inputs of a rung-1 rife request
    on a padded h x w pair: block i works at 1/4, 1/2, 1 of the frame
    (scale list 4, 2, 1) and its two stride-2 stem convs halve that twice."""
    return tuple((f"block{i}", batch, h // (16 >> i), w // (16 >> i), c)
                 for i, c in enumerate(widths))


SERVED = served_shapes()
ODD = ("C = 12 tail", 2, 7, 9, 12)
STAGES = 8
TC_BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
TIMED_CHAINS = 20
COPY_BYTES = 160e6  # input copies per timing: over three times the 50 MB L2
ONE_STAGE_ORDER = 1e-5  # f32 summation-order term, of the sum of |terms|
PARITY = 1.05  # kernel's distance from the unrounded chain / the plain version's
CHAIN_MEAN_REL = 1e-3
R5_CKPT = Path(__file__).resolve().parents[2] / "train_log_r5" / "flownet.rtpu"


def random_convblock(c: int, stages: int, seed: int) -> nn.ModuleList:
    """`stages` seeded ConvPReLU(c, c) on the CPU in f32, every value a bf16
    value (so the bf16 modules and the packed f32 biases agree).  He-normal
    weights keep the activations' scale along the chain."""
    gen = torch.Generator().manual_seed(seed)
    convs = nn.ModuleList([ConvPReLU(c, c) for _ in range(stages)])
    with torch.no_grad():
        for m in convs:
            m.conv.weight.copy_(torch.randn(m.conv.weight.shape, generator=gen)
                                * math.sqrt(2.0 / (9 * c)))
            m.conv.bias.copy_(torch.randn(c, generator=gen) * 0.02)
            m.alpha.copy_(torch.rand(c, generator=gen) * 0.3 + 0.1)
            for p in m.parameters():
                p.copy_(p.to(torch.bfloat16).float())
    return convs.requires_grad_(False)


def random_input(n: int, h: int, w: int, c: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(n, h, w, c, generator=gen) * 0.5).to(device, torch.bfloat16)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    mag = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def chain_errors(got: torch.Tensor, x: torch.Tensor, params) -> tuple[dict, torch.Tensor]:
    """The kernel's output `got` on x against the plain version (rounded to
    bf16 at every stage, as the kernel) and against the unrounded f32
    chain (the plain version on f32 inputs) -> (record, plain output)."""
    w, b, a = params
    want = conv_chain_ref(x, *params)
    exact = conv_chain_ref(x.float(), w.float(), b, a)
    err = (got.float() - want.float()).abs()
    scale = exact.abs().mean()
    rec = {"shape": list(x.shape), "stages": w.shape[0], "max_abs_err": float(err.max()),
           "mean_rel": float(err.mean() / want.float().abs().mean()),
           "elements_differ": int((got != want).sum()),
           "kernel_vs_f32": float((got.float() - exact).abs().mean() / scale),
           "plain_vs_f32": float((want.float() - exact).abs().mean() / scale)}
    return rec, want


def check_chain(x: torch.Tensor, params, label: str, mean_rel: float | None = None) -> dict:
    """The kernel (x on the card) against the plain version; raises on a
    failure.

    One stage: every element within one bf16 ulp of the stage's output
    plus one of the residual sum, plus the f32 summation-order term
    (ONE_STAGE_ORDER of the sum of the conv's |terms|, times
    max(1, |alpha|)): both sum exact bf16 products in f32 and differ only
    in the order.  More stages: a one-ulp difference at one stage moves
    the next stage's sums and so its roundings, and on weights that keep
    the activations' scale (`random_convblock`) the differences spread
    until about half the elements differ by an ulp after 8 stages.  So the
    gate is that the kernel is as accurate as the plain version: its mean
    |diff| from the unrounded f32 chain within PARITY of the plain
    version's; and, where `mean_rel` is given (the r5 weights),
    mean |kernel - plain| / mean |plain| <= mean_rel as well."""
    w, b, a = params
    got = conv_chain(x, *params)
    if x.is_cuda:
        torch.cuda.synchronize()
    rec, want = chain_errors(got, x, params)
    rec["check"] = label
    if w.shape[0] == 1:
        err = (got.float() - want.float()).abs()
        y = conv_stage_ref(x, w[0], b[0], a[0], x.dtype)
        terms = conv_stage_ref(x.abs(), w[0].abs(), b[0].abs(), torch.ones_like(a[0]),
                               torch.float32)
        tol = (bf16_ulp(y) + bf16_ulp(want)
               + ONE_STAGE_ORDER * a[0].abs().clamp_min(1.0) * terms)
        rec["gate"] = "1 bf16 ulp of the stage + 1 of the residual sum + 1e-5 sum|terms|"
        rec["worst_of_tolerance"] = float((err / tol).max())
        ok = bool((err <= tol).all())
    else:
        rec["gate"] = f"kernel vs f32 chain <= {PARITY} x plain's"
        ok = rec["kernel_vs_f32"] <= PARITY * rec["plain_vs_f32"]
        if mean_rel is not None:
            rec["gate"] += f", mean rel <= {mean_rel}"
            ok = ok and rec["mean_rel"] <= mean_rel
    print(f"  {label} {tuple(x.shape)} x {w.shape[0]} stages: max |kernel - plain| "
          f"{rec['max_abs_err']:.4g}, mean rel {rec['mean_rel']:.3g}, "
          f"{rec['elements_differ']} of {got.numel()} differ; mean rel to the f32 chain: "
          f"kernel {rec['kernel_vs_f32']:.4g}, plain {rec['plain_vs_f32']:.4g} "
          f"({rec['gate']}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"conv_chain kernel disagrees with its plain version: "
                             f"{label}, {w.shape[0]} stages")
    return rec


def check_kernel(device, r5_convblocks=None) -> list[dict]:
    """`check_chain` at the served shapes and the odd one with seeded
    weights, 1 and 8 stages; with the r5 model's three convblocks (on
    `device`) also their 8-stage chains at the served shapes on seeded
    inputs, held to mean rel <= CHAIN_MEAN_REL as well."""
    recs = []
    for i, (name, n, h, w, c) in enumerate(SERVED + (ODD,)):
        for stages in (1, STAGES):
            convs = random_convblock(c, stages, seed=10 * i + stages)
            params = pack_chain(convs.to(device))
            recs.append(check_chain(random_input(n, h, w, c, i, device), params, name))
    for i, convs in enumerate(r5_convblocks or ()):
        name, n, h, w, c = SERVED[i]
        recs.append(check_chain(random_input(n, h, w, c, 20 + i, device), pack_chain(convs),
                                f"{name}, r5 weights", CHAIN_MEAN_REL))
    return recs


def r5_convblocks(device) -> list:
    """The r5 checkpoint's three IFBlock convblocks (bf16, on `device`)."""
    from rife_tpu_torch.engine import load_checkpoint, state_dict_from_jax
    from rife_tpu_torch.models import get_model_def

    model_def = get_model_def("rife")
    net = model_def.build(model_def.config)
    net.load_state_dict(state_dict_from_jax(load_checkpoint(R5_CKPT)[1]))
    return [getattr(net, f"block{i}").convblock.to(device, torch.bfloat16) for i in range(3)]


def cudnn_chain(convs, x: torch.Tensor) -> torch.Tensor:
    """IFBlock's own loop: y = conv(y) for each ConvPReLU, then y + x (x in
    NCHW shape, either memory format)."""
    y = x
    for m in convs:
        y = m(y)
    return y + x


def cudnn_convs_only(convs, x: torch.Tensor) -> torch.Tensor:
    """The same convs with their biases and without the PReLUs."""
    y = x
    for m in convs:
        y = F.conv2d(y, m.conv.weight, m.conv.bias, padding=1)
    return y + x


def once_ms(fn, *args) -> float:
    """Device time of one call by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bound(n: int, h: int, w: int, c: int, stages: int = STAGES) -> dict:
    """The least time of a chain: tensor-core flops (2 * 9 * C^2 per pixel
    and stage) over the bf16 peak, against bytes (input and output once,
    bf16 weights, f32 biases and slopes) over the memory rate."""
    flops = 2 * n * h * w * 9 * c * c * stages
    nbytes = 2 * (2 * n * h * w * c) + stages * (2 * 9 * c * c + 2 * 4 * c)
    t_ops, t_bytes = flops / TC_BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bytes_bound_ms": t_bytes * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def kernel_resources() -> list[dict]:
    """Per width of the stage kernel: registers and spill bytes from nvcc's
    -Xptxas -v report of the built library, dynamic shared memory and the
    A and B rings' slots as the source sizes them; any ptxas line about
    wgmma (a serialised wgmma costs its overlap) is kept with it."""
    log = _build.build("conv_chain").ptxas_log
    recs = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(conv_stage_kernel|tile_product_kernel)"
                      r"ILi(\d+)E", line)
        if m:
            entry = recs.setdefault((m.group(1), int(m.group(2))), {
                "kernel": f"{m.group(1)}<{m.group(2)}>", "ptxas": []})
            continue
        if entry is None:
            continue
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entry["spill_store_bytes"], entry["spill_load_bytes"] = map(int, m.groups())
        elif (m := re.search(r"Used (\d+) registers", line)):
            entry["registers"] = int(m.group(1))
        if "wgmma" in line:
            entry["ptxas"].append(line.strip())
    out = []
    for bn in sorted(WIDTHS + (WIDE,)):
        rec = recs.get(("conv_stage_kernel", bn), {"kernel": f"conv_stage_kernel<{bn}>"})
        rec["dynamic_smem_bytes"], rec["a_ring"], rec["b_ring"] = _cuda.stage_config(bn)
        out.append(rec)
    return out


def describe_resources(r: dict) -> str:
    """One line of `kernel_resources`' record of a width."""
    return (f"{r['kernel']}: {r.get('registers')} registers, spills "
            f"{r.get('spill_store_bytes')}/{r.get('spill_load_bytes')} bytes, "
            f"{r['dynamic_smem_bytes']} bytes of shared memory, rings of {r['a_ring']} A and "
            f"{r['b_ring']} B boxes {' '.join(r.get('ptxas', []))}")


def time_shape(name: str, n: int, h: int, w: int, c: int, device, seed: int = 0) -> dict:
    """Times of one chain of STAGES stages at (n, h, w, c), in ms."""
    convs = random_convblock(c, STAGES, seed).to(device, torch.bfloat16)
    params = pack_chain(convs)
    x = random_input(n, h, w, c, seed, device)
    copies = max(2, math.ceil(COPY_BYTES / (x.numel() * 2)))
    nhwc = [(x.clone(),) for _ in range(copies)]
    g = geometry(n, h, w, c, _cuda.sm_count(x.device.index or 0))
    rec = {"shape": name, "nhwc": [n, h, w, c], "stages": STAGES, **bound(n, h, w, c),
           "c8": g.c8, "ld": g.ld, "bn": g.bn, "flat_rows": g.rows, "tiles": g.tiles,
           "grid": g.grid, "waves": g.waves}
    rec["ms"] = graph_ms(lambda t: conv_chain(t, *params), nhwc, TIMED_CHAINS)
    # The call's parts: the copy into the flat layout, the parameters'
    # padding, and the 8 launches alone on a flat input.
    rec["input_copy_ms"] = graph_ms(lambda t: to_flat(t, g.ld), nhwc, TIMED_CHAINS)
    rec["params_ms"] = graph_ms(lambda: kernel_params(*params, g), [()], TIMED_CHAINS)
    kparams = kernel_params(*params, g)
    flats = [(to_flat(t, g.ld), torch.empty_like(t)) for (t,) in nhwc]
    rec["stages_ms"] = graph_ms(lambda f, o: run_stages(f, *kparams, g, o), flats,
                                TIMED_CHAINS)
    del flats
    # cuDNN channels-last: the NHWC data seen as NCHW, modules channels-last.
    convs_cl = copy.deepcopy(convs).to(memory_format=torch.channels_last)
    cl = [(t.permute(0, 3, 1, 2),) for (t,) in nhwc]
    rec["cudnn_channels_last_ms"] = graph_ms(lambda t: cudnn_chain(convs_cl, t), cl,
                                             TIMED_CHAINS)
    rec["cudnn_convs_only_channels_last_ms"] = graph_ms(
        lambda t: cudnn_convs_only(convs_cl, t), cl, TIMED_CHAINS)
    del cl, convs_cl
    nchw = [(t.permute(0, 3, 1, 2).contiguous(),) for (t,) in nhwc]
    rec["cudnn_nchw_ms"] = graph_ms(lambda t: cudnn_chain(convs, t), nchw, TIMED_CHAINS)
    rec["to_nhwc_ms"] = graph_ms(lambda t: t.permute(0, 2, 3, 1).contiguous(), nchw,
                                 TIMED_CHAINS)
    del nchw
    rec["plain_ms"] = once_ms(conv_chain_ref, x, *params)
    rec["library_ms"] = rec["cudnn_channels_last_ms"]
    rec["tflops"] = rec["flops"] / rec["ms"] / 1e9
    rec["of_bound"] = rec["bound_ms"] / rec["ms"]
    print(f"  {name} {n}x{h}x{w}x{c}, {STAGES} stages: kernel {rec['ms']:.3f} ms "
          f"({rec['tflops']:.1f} TF/s, {rec['of_bound']:.1%} of the bound "
          f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}; input copy "
          f"{rec['input_copy_ms']:.4f}, parameters {rec['params_ms']:.4f}, 8 launches "
          f"{rec['stages_ms']:.3f}; {g.tiles} tiles of 128 x {g.bn} on {g.grid} blocks, "
          f"{g.waves:.2f} waves); cuDNN channels-last "
          f"{rec['cudnn_channels_last_ms']:.3f} (convs alone "
          f"{rec['cudnn_convs_only_channels_last_ms']:.3f}), NCHW "
          f"{rec['cudnn_nchw_ms']:.3f}; NCHW -> NHWC copy {rec['to_nhwc_ms']:.3f}; "
          f"plain {rec['plain_ms']:.2f}", flush=True)
    return rec


def profile_shape(name: str, n: int, h: int, w: int, c: int, device, seed: int = 0) -> dict:
    """Where a stage's time goes at (n, h, w, c): the profiled build's
    clock64 marks for an inner stage and the last one, as microseconds
    per block (cycles scaled by the block's own globaltimer span): the
    producer's waits for a free ring slot, the first consumer's waits for
    a full one, its products (issue and the wait for the previous step's
    group), its epilogue and the epilogue's parts, the whole block, and on
    the last stage its storer warp's time storing (overlapping the next
    tile's products); means over blocks, and the longest block."""
    convs = random_convblock(c, STAGES, seed).to(device, torch.bfloat16)
    x = random_input(n, h, w, c, seed, device)
    g = geometry(n, h, w, c, _cuda.sm_count(x.device.index or 0))
    kw, kb, ka = kernel_params(*pack_chain(convs), g)
    xin = to_flat(x, g.ld)
    dst = torch.empty_like(xin)
    out = torch.empty_like(x)
    rec = {"shape": name, "nhwc": [n, h, w, c], "tiles": g.tiles, "grid": g.grid}
    fields = ("producer_wait_us", "consumer_wait_us", "products_us", "epilogue_us",
              "block_us", None, None, "storer_us", None, "epilogue_last_products_us",
              "epilogue_staging_wait_us", "epilogue_fragments_us", "epilogue_store_issue_us")
    for label, stage, last, target in (("inner", 1, False, dst), ("last", STAGES - 1, True,
                                                                   out)):
        prof = torch.zeros((g.grid, _cuda.PROF_FIELDS), dtype=torch.int64, device=device)
        for _ in range(2):  # the second run is the one read
            prof.zero_()
            _cuda.launch_stage(xin, target, xin, kw, kb, ka, g, stage, last, prof)
        torch.cuda.synchronize()
        q = prof.double().cpu()
        us_per_cycle = (q[:, 5] / q[:, 4]).mean().item() / 1e3  # the consumer's span
        q[:, 4] = torch.maximum(q[:, 4], q[:, 8])  # the block ends with its last role
        cyc = q * us_per_cycle
        rec[label] = {**{f: float(cyc[:, i].mean()) for i, f in enumerate(fields) if f},
                      "longest_block_us": float(cyc[:, 4].max()),
                      "tiles_per_block_max": int(q[:, 6].max()),
                      "ghz": 1e-3 / us_per_cycle}
        r = rec[label]
        print(f"  {name} {label} stage: block {r['block_us']:.1f} us (longest "
              f"{r['longest_block_us']:.1f}, {r['tiles_per_block_max']} tiles, "
              f"{r['ghz']:.2f} GHz): consumer waits {r['consumer_wait_us']:.1f}, products "
              f"{r['products_us']:.1f}, epilogue {r['epilogue_us']:.1f}; producer waits "
              f"{r['producer_wait_us']:.1f}; storer stores {r['storer_us']:.1f}; epilogue: "
              f"last products {r['epilogue_last_products_us']:.1f}, staging wait "
              f"{r['epilogue_staging_wait_us']:.1f}, fragments "
              f"{r['epilogue_fragments_us']:.1f}, store issue "
              f"{r['epilogue_store_issue_us']:.1f}", flush=True)
    return rec


def cpu_main() -> int:
    """The plain version at a tiny shape against the port's ConvPReLU loop
    in f32."""
    convs = random_convblock(12, STAGES, seed=0)
    x = torch.randn(1, 6, 8, 12, generator=torch.Generator().manual_seed(0))
    got = conv_chain(x, *pack_chain(convs, torch.float32))
    with torch.no_grad():
        want = cudnn_chain(convs, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    err = float((got - want).abs().max() / want.abs().max())
    print(f"cpu: plain conv chain (1, 6, 8, 12) x {STAGES} stages, f32, against the "
          f"ConvPReLU loop: max |diff| / max |ref| = {err:.3g} (<= 1e-5)")
    return 0 if err <= 1e-5 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="only the clock64 breakdown of a stage at the served shapes "
                         "(a separate, profiled build)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        return cpu_main()
    if not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the plain version", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    print(f"{torch.cuda.get_device_name(device)}; nvidia-smi: {smi}", flush=True)
    if args.profile:
        profiles = [profile_shape(*shape, device) for shape in SERVED]
        print(json.dumps({"card": smi, "profiles": profiles}))
        return 0
    resources = kernel_resources()
    for r in resources:
        print(f"  {describe_resources(r)}", flush=True)
    checks = check_kernel(device, r5_convblocks(device))
    times = [time_shape(name, n, h, w, c, device) for name, n, h, w, c in SERVED]
    print(json.dumps({"card": smi, "resources": resources, "checks": checks,
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
