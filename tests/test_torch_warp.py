"""rife_tpu_torch warp vs rife_tpu's exact XLA warp, on the CPU.

Inputs come from a seeded numpy generator and go to both packages as
numpy arrays.  f32 is held to 1e-5 abs (same formula, summed in the same
order); the bf16 path (bf16 taps, f32 math, one rounding) is held to one
bf16 ulp of the exact f32 result on the same bf16-rounded inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.ops.warp import warp2_blend_planes as jax_warp2_blend
from rife_tpu.ops.warp import warp2_planes as jax_warp2
from rife_tpu.ops.warp import warp_xla_planes
from rife_tpu_torch.engine import InferenceEngine, resolve_device
from rife_tpu_torch.ops import warp as tw


def _flow(rng, n, h, w, kind):
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = np.stack([3.7 * np.sin(yy / 7.0) + 1.3, -2.9 * np.cos(xx / 5.0) - 0.6])
        return np.broadcast_to(f, (n, 2, h, w)) + rng.normal(
            0, 0.3, (n, 2, h, w)).astype(np.float32)
    if kind == "out_of_frame":
        return rng.uniform(-1.5 * max(h, w), 1.5 * max(h, w),
                           (n, 2, h, w)).astype(np.float32)
    # "blocks": +-200 px, random per 8x8 block, partly out of frame.
    hb, wb = -(-h // 8), -(-w // 8)
    blk = rng.uniform(-200, 200, (n, 2, hb, wb)).astype(np.float32)
    f = np.repeat(np.repeat(blk, 8, 2), 8, 3)[:, :, :h, :w]
    return f + rng.uniform(-1, 1, (n, 2, h, w)).astype(np.float32)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("c,h,w,kind", [
    (1, 37, 53, "smooth"), (3, 37, 53, "out_of_frame"), (16, 37, 53, "blocks"),
    (3, 64, 96, "blocks"), (16, 24, 40, "smooth"), (1, 64, 96, "out_of_frame"),
])
def test_warp_ref_matches_xla_f32(c, h, w, kind):
    rng = np.random.default_rng(c * 1000 + h)
    img = rng.random((2, c, h, w), np.float32)
    flow = _flow(rng, 2, h, w, kind).astype(np.float32)
    want = np.asarray(warp_xla_planes(jnp.asarray(img), jnp.asarray(flow)))
    got = tw.warp_planes(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["smooth", "blocks"])
def test_warp_bf16_within_one_ulp(kind):
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.normal(0, 4, (2, 16, 37, 53)).astype(np.float32))
    flow = torch.from_numpy(_flow(rng, 2, 37, 53, kind).astype(np.float32))
    img16, flow16 = img.bfloat16(), flow.bfloat16()
    want = np.asarray(warp_xla_planes(jnp.asarray(img16.float().numpy()),
                                      jnp.asarray(flow16.float().numpy())))
    got = tw.warp_planes(img16, flow16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= _bf16_ulp(want)), float(err.max())


@pytest.mark.parametrize("need_pair", [True, False])
def test_pair_warps_match_reference(need_pair):
    rng = np.random.default_rng(9)
    a, b = (rng.random((2, 3, 40, 56), np.float32) for _ in range(2))
    flow = np.concatenate([_flow(rng, 2, 40, 56, "smooth"),
                           _flow(rng, 2, 40, 56, "blocks")], 1).astype(np.float32)
    mask = rng.normal(0, 2, (2, 1, 40, 56)).astype(np.float32)
    j = [jnp.asarray(x) for x in (a, b, flow, mask)]
    t = [torch.from_numpy(x) for x in (a, b, flow, mask)]
    pair_want = jax_warp2(j[0], j[1], j[2][:, 0:2], j[2][:, 2:4])
    pair_got = tw.warp2_planes(t[0], t[1], t[2][:, 0:2], t[2][:, 2:4])
    for g, w in zip(pair_got, pair_want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    want = jax_warp2_blend(*j, need_pair=need_pair)
    got = tw.warp2_blend_planes(*t, need_pair=need_pair)
    if not need_pair:
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_warp_cpu_path_launches_no_kernel():
    before = tw.warp_planes.launches
    tw.warp_planes(torch.zeros(1, 3, 8, 8), torch.zeros(1, 2, 8, 8))
    assert tw.warp_planes.launches == before


def test_warp_refuses_a_device_it_has_no_kernel_for():
    img = torch.zeros(1, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tw.warp_planes(img, torch.zeros(1, 2, 8, 8, device="meta"))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine("rife", {}, device=None)
    assert resolve_device("cpu").type == "cpu"
