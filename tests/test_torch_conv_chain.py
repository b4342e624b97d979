"""rife_tpu_torch's convblock chain (`ops.conv_chain`, K5's plain version)
against rife_tpu's, on the CPU.

The reference harness is tools/r3_exp50_pallasconv.py, loaded by path:
`xla_core` (the chain through XLA's convs), `pallas_core` and
`pallas_core_v2` (K5's two formulations, in interpret mode).  Inputs and
weights come from a seeded numpy generator; the weights go to the port
through `chain_params_from_jax`.  Tolerances:
- f32: `conv_chain_ref` within 1e-5 of max |ref| of `xla_core` at
  Precision.HIGHEST (the same sums in another order);
- bf16: within 1 bf16 ulp of max |ref| of both Pallas formulations, mean
  |diff| / mean |ref| <= 1e-3 (each stage rounds once to bf16 in both; the
  f32 sums differ in order);
- the r5 model's IFBlock convblock loop in f32 within 1e-5 of max |ref|.
"""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rife_tpu_torch.engine import load_checkpoint, state_dict_from_jax
from rife_tpu_torch.models import get_model_def
from rife_tpu_torch.ops import conv_chain as cc
from rife_tpu_torch.ops.cuda import conv_chain as cuda_cc

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "train_log_r5", "flownet.rtpu")


@functools.lru_cache(maxsize=1)
def _exp50():
    spec = importlib.util.spec_from_file_location(
        "r3_exp50_pallasconv", os.path.join(ROOT, "tools", "r3_exp50_pallasconv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _r5():
    return load_checkpoint(CKPT)[1]


def _params(rng, c, stages):
    """rife_tpu `conv_prelu_params` dicts (numpy f32, HWIO), He-normal so the
    activations keep their scale along the chain."""
    return [{"conv": {"w": rng.normal(0, np.sqrt(2 / (9 * c)), (3, 3, c, c)).astype(np.float32),
                      "b": rng.normal(0, 0.02, c).astype(np.float32)},
             "alpha": rng.uniform(0.1, 0.4, c).astype(np.float32)} for _ in range(stages)]


def _jax_params(params):
    return [{"conv": {k: jnp.asarray(v) for k, v in p["conv"].items()},
             "alpha": jnp.asarray(p["alpha"])} for p in params]


def _bf16_ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("c", [32, 10])
@pytest.mark.parametrize("stages", [3, 8])
def test_ref_matches_xla_core_f32(c, stages):
    rng = np.random.default_rng(100 * c + stages)
    params = _params(rng, c, stages)
    x = rng.normal(0, 0.5, (2, 14, 16, c)).astype(np.float32)
    want = np.asarray(_exp50().xla_core(jnp.asarray(x), _jax_params(params)))
    got = cc.conv_chain_ref(torch.from_numpy(x),
                            *cc.chain_params_from_jax(params, torch.float32)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("c", [32, 10])
@pytest.mark.parametrize("impl", ["pallas_core", "pallas_core_v2"])
def test_ref_matches_pallas_bf16(impl, c):
    # (H + 2) * (W + 2) = 288, a multiple of 8: pallas_core_v2's row chunk.
    rng = np.random.default_rng(7 + c)
    params = _params(rng, c, 3)
    x = rng.normal(0, 0.5, (2, 14, 16, c)).astype(np.float32)
    fn = getattr(_exp50(), impl)
    want = np.asarray(fn(jnp.asarray(x, jnp.bfloat16), _jax_params(params),
                         interpret=True), np.float32)
    got = cc.conv_chain_ref(torch.from_numpy(x).to(torch.bfloat16),
                            *cc.chain_params_from_jax(params, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= _bf16_ulp(np.abs(want).max())
    assert err.mean() / np.abs(want).mean() <= 1e-3


@pytest.mark.parametrize("block", [0, 1, 2])
def test_ref_matches_r5_ifblock_convblock(block):
    model_def = get_model_def("rife")
    net = model_def.build(model_def.config)
    net.load_state_dict(state_dict_from_jax(_r5()))
    convs = getattr(net, f"block{block}").convblock
    c = convs[0].conv.weight.shape[0]
    assert c == (240, 150, 90)[block]
    rng = np.random.default_rng(block)
    x = torch.from_numpy(rng.normal(0, 0.5, (1, c, 8, 12)).astype(np.float32))
    with torch.no_grad():
        y = x
        for conv in convs:  # IFBlock.forward's loop
            y = conv(y)
        want = (y + x).permute(0, 2, 3, 1)
        got = cc.conv_chain_ref(x.permute(0, 2, 3, 1).contiguous(),
                                *cc.pack_chain(convs, torch.float32))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("block", [0, 1, 2])
def test_chain_params_from_jax_is_pack_chain_of_the_loaded_model(block):
    """The r5 weights packed from rife_tpu's HWIO tree equal the packed
    modules after state_dict_from_jax's OIHW conversion, and index as
    w[s, co, 3 * ky + kx, ci] = HWIO[ky, kx, ci, co]."""
    tree = _r5()
    model_def = get_model_def("rife")
    net = model_def.build(model_def.config)
    net.load_state_dict(state_dict_from_jax(tree))
    jparams = tree[f"block{block}"]["convblock"]
    from_jax = cc.chain_params_from_jax(jparams, torch.float32)
    packed = cc.pack_chain(getattr(net, f"block{block}").convblock, torch.float32)
    for a, b in zip(from_jax, packed):
        assert a.shape == b.shape and torch.equal(a, b)
    w = np.asarray(jparams[5]["conv"]["w"])
    for ky, kx, ci, co in [(0, 0, 0, 0), (2, 1, 3, 7), (1, 2, w.shape[2] - 1, 11)]:
        assert from_jax[0][5, co, 3 * ky + kx, ci] == float(w[ky, kx, ci, co])
    bf = cc.chain_params_from_jax(jparams, torch.bfloat16)
    assert bf[0].dtype == torch.bfloat16 and bf[1].dtype == bf[2].dtype == torch.float32


def test_cpu_tensor_takes_the_plain_version_and_no_launch():
    rng = np.random.default_rng(0)
    params = cc.chain_params_from_jax(_params(rng, 12, 2), torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 0.5, (1, 5, 7, 12)).astype(np.float32)).to(torch.bfloat16)
    before = cc.conv_chain.launches
    got = cc.conv_chain(x, *params)
    assert cc.conv_chain.launches == before
    assert torch.equal(got, cc.conv_chain_ref(x, *params))


def test_cuda_entry_refuses_what_the_kernel_cannot_take():
    """`ops/cuda/conv_chain.check` runs before anything is built or
    launched, so it is exercised here on CPU tensors: f32, a layout whose
    channel stride is not 1 and f32-typed weights raise; a bf16
    channels-last tensor passes every check but the device's (no fallback
    to the plain version on the kernel's entry)."""
    rng = np.random.default_rng(1)
    w, b, a = cc.chain_params_from_jax(_params(rng, 16, 2), torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 6, 16)).astype(np.float32))
    with pytest.raises(TypeError, match="bf16"):
        cuda_cc.check(x, w, b, a)
    with pytest.raises(TypeError, match="bf16"):
        cuda_cc.check(x.to(torch.bfloat16), w.float(), b, a)
    with pytest.raises(TypeError, match="f32"):
        cuda_cc.check(x.to(torch.bfloat16), w, b.to(torch.bfloat16), a)
    planes = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert planes.shape == x.shape and planes.stride(3) != 1
    with pytest.raises(ValueError, match="channel stride 1"):
        cuda_cc.check(planes, w, b, a)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_cc.check(x.to(torch.bfloat16), w, b, a)
    with pytest.raises(ValueError, match="stages"):
        cc.conv_chain(x, w[:, :8], b, a)


@pytest.mark.parametrize("shape", [(1, 7, 9, 12), (2, 5, 3, 90), (1, 4, 6, 16)])
def test_flat_layout_round_trips_with_zero_borders_and_pad_channels(shape):
    n, h, w, c = shape
    g = cc.geometry(n, h, w, c)
    x = torch.from_numpy(np.random.default_rng(c).normal(0, 1, shape).astype(np.float32))
    x = x.to(torch.bfloat16)
    flat = cc.to_flat(x, g.ld)
    assert flat.shape == (g.rows, g.ld) and flat.is_contiguous()
    assert g.c8 % 8 == 0 and g.ld % 64 == 0 and g.c <= g.c8 <= g.ld
    assert torch.equal(cc.from_flat(flat, n, h, w, c), x)
    grid = flat.view(n, h + 2, w + 2, g.ld)
    interior = torch.zeros(n, h + 2, w + 2, g.ld, dtype=torch.bool)
    interior[:, 1:-1, 1:-1, :c] = True
    assert not grid[~interior].any()
    # A channels-last view of an NCHW tensor goes in as the same values.
    cl = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    assert torch.equal(cc.to_flat(cl.permute(0, 2, 3, 1), g.ld), flat)


@pytest.mark.parametrize("c", [12, 90])
def test_plain_version_on_padded_channels_equals_unpadded(c):
    """The kernel computes the chain on C8 channels with zero-padded
    parameters: the plain version on that padded problem gives the
    unpadded chain on channels 0..C-1 and exactly 0 on the pad channels."""
    rng = np.random.default_rng(c)
    w, b, a = cc.chain_params_from_jax(_params(rng, c, 3), torch.float32)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 5, 7, c)).astype(np.float32))
    c8 = cc.geometry(2, 5, 7, c).c8
    assert c8 > c
    wp, bp, ap = cc.pad_params(w, b, a, c8, c8)
    assert wp.shape == (3, c8, 9, c8) and bp.shape == ap.shape == (3, c8)
    got = cc.conv_chain_ref(F.pad(x, (0, c8 - c)), wp, bp, ap)
    want = cc.conv_chain_ref(x, w, b, a)
    assert float((got[..., :c] - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert not got[..., c:].any()
    g = cc.geometry(2, 5, 7, c)
    kw, kb, ka = cc.kernel_params(w, b, a, g)
    assert kw.shape == (3, 9, g.np, g.ld) and kw.is_contiguous()
    assert torch.equal(kw[1, 4, :c, :c], w[1, :, 4, :])
    assert not kw[:, :, c:].any() and not kw[..., c:].any() and not kb[:, c:].any()


@pytest.mark.parametrize("shape", [(1, 7, 9, 12), (4, 46, 80, 240), (1, 5, 6, 264)])
def test_tile_schedule_covers_every_flat_row_once(shape):
    n, h, w, c = shape
    g = cc.geometry(n, h, w, c)
    assert g.rows == n * (h + 2) * (w + 2) and g.grid <= 132
    assert g.np == g.n_tiles * g.bn >= g.c8 and g.bn in cc.WIDTHS + (cc.WIDE,)
    cover = np.zeros((g.rows, g.np), np.int32)
    blocks = cc.tile_schedule(g)
    assert len(blocks) == g.grid and max(map(len, blocks)) == -(-g.tiles // g.grid)
    for tiles in blocks:
        for m0, n0 in tiles:
            cover[m0:m0 + cc.BM, n0:n0 + g.bn] += 1
    assert (cover == 1).all()
    if shape == (4, 46, 80, 240):
        assert (g.m_tiles, g.grid, g.bn) == (123, 123, 240)


def test_row_offset_taps_on_the_schedule_compute_the_stage():
    """The kernel's arithmetic on the flat layout, emulated tile by tile in
    f32 along `tile_schedule`: tap t of row m is row m + off_t (rows
    outside the buffer zero), only the first c8 of each row's ld channels
    read (the rest never written, here NaN), border rows written as 0; the
    interior equals the plain version's stage on two stages, and the
    borders stay zero."""
    n, h, w, c = 2, 5, 6, 20
    rng = np.random.default_rng(5)
    wt, b, a = cc.chain_params_from_jax(_params(rng, c, 2), torch.float32)
    x = torch.from_numpy(rng.normal(0, 0.5, (n, h, w, c)).astype(np.float32))
    g = cc.geometry(n, h, w, c)
    kw, kb, ka = cc.kernel_params(wt, b, a, g)
    interior = cc.to_flat(torch.ones(n, h, w, 1), 1)[:, 0] > 0
    offs = [(dy - 1) * (w + 2) + (dx - 1) for dy in range(3) for dx in range(3)]
    src = cc.to_flat(x, g.ld)
    want = x
    for s in range(2):
        dst = torch.full((g.rows, g.ld), float("nan"))
        for m0, n0 in (t for blk in cc.tile_schedule(g) for t in blk):
            rows = torch.arange(m0, m0 + cc.BM)
            acc = torch.zeros(cc.BM, g.bn)
            for t, off in enumerate(offs):
                r = rows + off
                ok = (r >= 0) & (r < g.rows)
                tap = torch.where(ok[:, None], src[r.clamp(0, g.rows - 1), :g.c8], 0.0)
                acc += tap @ kw[s, t, n0:n0 + g.bn, :g.c8].t()
            acc += kb[s, n0:n0 + g.bn]
            acc = torch.where(acc >= 0, acc, acc * ka[s, n0:n0 + g.bn])
            keep = rows < g.rows
            cols = min(g.bn, g.c8 - n0)
            dst[rows[keep], n0:n0 + cols] = torch.where(
                interior[rows[keep], None], acc[keep, :cols], 0.0)
        want = cc.conv_stage_ref(want, wt[s], b[s], a[s], torch.float32)
        got = cc.from_flat(dst, n, h, w, c)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert not dst[~interior, :g.c8].any() and not dst[:, c:g.c8].any()
        src = dst
