"""rife_tpu_torch's fused pair warp + blend (K2) against rife_tpu, on the CPU.

The plain version `warp2_blend_planes_ref` is the CPU path and the oracle
the CUDA kernel is held to on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Here, from seeded numpy inputs: in f32 it is within
1e-5 of rife_tpu's composed `warp2_blend_planes` (both forms, smooth and
+-200 px block flows); in bf16 it is held to rife_tpu's Pallas kernel
`warp_pair_blend_pl`, run in interpret mode at the shapes of rife_tpu's
own test: w0 and w1 within one bf16 ulp of the value, the blend within
two (different tap order, one rounding each).  Through the switch, the
fused route's gradients are the composed route's.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.ops import resize_bilinear
from rife_tpu.ops.pallas.warp_blend import warp_pair_blend_pl
from rife_tpu.ops.warp import warp2_blend_planes as jax_warp2_blend
from rife_tpu_torch.ops import warp as tw
from rife_tpu_torch.ops.cuda import warp_blend as cuda_blend


def _flow(rng, n, h, w, kind):
    """(N, 2, H, W): a smooth field of a few px, or +-200 px per 8x8 block."""
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        ph = rng.uniform(0, 6.28, (n, 1, 1, 1)).astype(np.float32)
        f = np.stack([2.6 * np.sin(yy / 9.0 + ph[:, 0]) + 0.4,
                      -1.9 * np.cos(xx / 11.0 + ph[:, 0]) - 0.3], 1)
        return (f + rng.normal(0, 0.2, (n, 2, h, w))).astype(np.float32)
    blk = rng.uniform(-200, 200, (n, 2, -(-h // 8), -(-w // 8))).astype(np.float32)
    f = np.repeat(np.repeat(blk, 8, 2), 8, 3)[:, :, :h, :w]
    return f + rng.uniform(-1, 1, (n, 2, h, w)).astype(np.float32)


def _inputs(seed, n, c, h, w, kind):
    rng = np.random.default_rng(seed)
    a, b = (rng.random((n, c, h, w), np.float32) for _ in range(2))
    flow = np.concatenate([_flow(rng, n, h, w, kind), _flow(rng, n, h, w, kind)], 1)
    mask = rng.normal(0, 2, (n, 1, h, w)).astype(np.float32)
    return a, b, flow, mask


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("kind", ["smooth", "blocks"])
@pytest.mark.parametrize("need_pair", [True, False])
def test_plain_version_matches_reference_f32(kind, need_pair):
    x = _inputs(1, 2, 3, 40, 72, kind)
    want = jax_warp2_blend(*(jnp.asarray(v) for v in x), need_pair=need_pair)
    got = tw.warp2_blend_planes_ref(*(torch.from_numpy(v) for v in x),
                                    need_pair=need_pair)
    if not need_pair:
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,c,h,w", [(2, 3, 40, 136), (1, 3, 40, 512)])
def test_plain_version_matches_pallas_kernel_bf16(n, c, h, w):
    """rife_tpu's own test's shapes and flow (a coarse normal field of
    3 px resized from 32 px cells, within the kernel's window contract;
    the pair is [fl, -fl]).  tile_h=8, one of the kernel's static tilings,
    keeps the interpreter's trace and compile near 10 s a shape (the
    default 32 takes over 45 s); it changes no pixel's arithmetic."""
    rng = np.random.default_rng(2)
    a16, b16 = (jnp.asarray(rng.random((n, c, h, w), np.float32)).astype(jnp.bfloat16)
                for _ in range(2))
    coarse = rng.standard_normal((n, max(h // 32, 1), max(w // 32, 1), 2)) * 3.0
    fl = jnp.moveaxis(resize_bilinear(jnp.asarray(coarse, jnp.float32), (h, w)), -1, 1)
    flow = jnp.concatenate([fl, -fl], 1)
    mask = jnp.asarray((rng.random((n, 1, h, w), np.float32) - 0.5) * 4)
    blend, w0, w1 = warp_pair_blend_pl(a16, b16, flow, mask, emit_pair=True,
                                       interpret=True, tile_h=8)
    ta, tb, tf, tm = (torch.from_numpy(np.array(v.astype(jnp.float32)))
                      for v in (a16, b16, flow, mask))
    ta, tb = ta.bfloat16(), tb.bfloat16()
    got = tw.warp2_blend_planes_ref(ta, tb, tf, tm, need_pair=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, want, ulps in zip(got, (blend, w0, w1), (2, 1, 1)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(g.float().numpy() - want)
        assert np.all(err <= ulps * _bf16_ulp(want)), float(err.max())
    only = tw.warp2_blend_planes_ref(ta, tb, tf, tm, need_pair=False)
    assert torch.equal(only, got[0])


@pytest.mark.parametrize("need_pair", [True, False])
@pytest.mark.parametrize("kind", ["smooth", "blocks"])
def test_fused_route_gradients_are_the_composed_routes(need_pair, kind):
    x = _inputs(3, 2, 3, 24, 40, kind)
    rng = np.random.default_rng(4)
    cots = [torch.from_numpy(rng.normal(0, 1, (2, 3, 24, 40)).astype(np.float32))
            for _ in range(3 if need_pair else 1)]
    results = {}
    for fused in (True, False):
        ts = [torch.from_numpy(v).requires_grad_(True) for v in x]
        with tw.use_fuse_blend(fused):
            out = tw.warp2_blend_planes(*ts, need_pair=need_pair)
        out = out if need_pair else (out,)
        sum((o * g).sum() for o, g in zip(out, cots)).backward()
        results[fused] = ([o.detach() for o in out], [t.grad for t in ts])
    for k in (0, 1):
        for f, c in zip(results[True][k], results[False][k]):
            torch.testing.assert_close(f, c, rtol=0, atol=1e-5)


def test_switch_is_per_thread_context():
    seen = {}
    inside, release = threading.Event(), threading.Event()

    def other():
        with tw.use_fuse_blend(not tw._FUSE_BLEND.get()):
            seen["other"] = tw._FUSE_BLEND.get()
            inside.set()
            release.wait(10)

    default = tw._FUSE_BLEND.get()
    th = threading.Thread(target=other)
    th.start()
    assert inside.wait(10)
    seen["main"] = tw._FUSE_BLEND.get()
    release.set()
    th.join(10)
    assert seen == {"other": not default, "main": default}
    with tw.use_fuse_blend(not default):
        assert tw._FUSE_BLEND.get() is (not default)
    assert tw._FUSE_BLEND.get() is default


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    """The plain version on CPU tensors, the kernel or an error elsewhere
    (never the plain version on another device)."""
    x = [torch.from_numpy(v) for v in _inputs(5, 1, 3, 16, 24, "smooth")]
    before = tw.warp2_blend_planes.launches
    with tw.use_fuse_blend(True):
        tw.warp2_blend_planes(*x, need_pair=True)
        tw.warp2_blend_planes(*x, need_pair=False)
        assert tw.warp2_blend_planes.launches == before
        meta = [torch.zeros(v.shape, device="meta") for v in x]
        with pytest.raises(ValueError, match="CUDA"):
            tw.warp2_blend_planes(*meta, need_pair=False)


@pytest.mark.parametrize("bad", ["flow_shape", "mask_shape", "img_dtype", "empty"])
def test_kernel_wrapper_checks_before_it_launches(bad):
    """The binding refuses what the kernel cannot take (before building or
    launching anything), here on meta tensors."""
    n, c, h, w = 2, 3, 8, 8
    shapes = {"img0": (n, c, h, w), "img1": (n, c, h, w), "flow": (n, 4, h, w),
              "mask": (n, 1, h, w)}
    dt = {k: torch.float32 for k in shapes}
    if bad == "flow_shape":
        shapes["flow"] = (n, 2, h, w)
    elif bad == "mask_shape":
        shapes["mask"] = (n, 3, h, w)
    elif bad == "img_dtype":
        dt["img1"] = torch.bfloat16
    else:
        shapes = {k: (0,) + v[1:] for k, v in shapes.items()}
    ts = {k: torch.empty(v, dtype=dt[k], device="meta") for k, v in shapes.items()}
    with pytest.raises((ValueError, TypeError)):
        cuda_blend._check(ts["img0"], ts["img1"], ts["flow"], ts["mask"])
