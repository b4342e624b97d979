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


def _grads_port(img, flow, wts, img_grad=True):
    """d/img and d/flow of sum(wts * warp_planes(img, flow)) through the
    port's autograd.Function (the plain backward on the CPU)."""
    ti = torch.from_numpy(img).requires_grad_(img_grad)
    tf = torch.from_numpy(flow).requires_grad_(True)
    (torch.from_numpy(wts) * tw.warp_planes(ti, tf)).sum().backward()
    return (ti.grad.numpy() if img_grad else None), tf.grad.numpy()


@pytest.mark.parametrize("c,h,w,kind", [
    (3, 37, 53, "smooth"), (16, 24, 40, "out_of_frame"), (3, 64, 96, "blocks"),
    (32, 20, 28, "smooth"),
])
def test_warp_grad_matches_xla_vjp_f32(c, h, w, kind):
    """The port's backward against jax.vjp of the exact XLA warp, f32.
    Flows drawn from continuous distributions never put a raw coordinate
    exactly on a border, where JAX's clip gives half a gradient and the
    port (like the Pallas VJP) none."""
    import jax

    rng = np.random.default_rng(100 + c + h)
    img = rng.normal(0, 1, (2, c, h, w)).astype(np.float32)
    flow = _flow(rng, 2, h, w, kind).astype(np.float32)
    if kind == "smooth":  # and flows above 64 px in one sample
        flow[1] *= 20.0
    wts = rng.normal(0, 1, (2, c, h, w)).astype(np.float32)
    _, vjp = jax.vjp(warp_xla_planes, jnp.asarray(img), jnp.asarray(flow))
    want_img, want_flow = (np.asarray(x) for x in vjp(jnp.asarray(wts)))
    got_img, got_flow = _grads_port(img, flow, wts)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_flow, want_flow, rtol=0, atol=1e-4)


def test_warp_grad_matches_pallas_vjp():
    """Against rife_tpu's Pallas kernel-grad VJP (interpret mode on the
    CPU), as tests/test_pallas_warp.py runs it: d/img is the same scatter
    adjoint; d/flow differs by the Pallas path's bf16 taps."""
    import jax

    from rife_tpu.ops.warp import warp_planes_pallas_diff

    rng = np.random.default_rng(21)
    n, c, h, w = 1, 3, 32, 128
    img = rng.random((n, c, h, w), np.float32)
    flow = _flow(rng, n, h, w, "smooth").astype(np.float32) + 0.37
    wts = rng.random((n, c, h, w), np.float32)

    def loss(im, fl):
        return jnp.sum(jnp.asarray(wts) * warp_planes_pallas_diff(im, fl))

    want_img, want_flow = (np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(flow)))
    got_img, got_flow = _grads_port(img, flow, wts)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_flow, want_flow, rtol=0, atol=0.02)


def test_warp_gradcheck_f64():
    """torch.autograd.gradcheck of the plain backward in f64, with every
    sample inside the frame and its fractions in [0.2, 0.8] (away from the
    kinks of floor and clamp)."""
    rng = np.random.default_rng(4)
    n, c, h, w = 2, 3, 9, 11
    img = torch.from_numpy(rng.normal(0, 1, (n, c, h, w))).requires_grad_(True)
    yy, xx = np.mgrid[0:h, 0:w]
    tx = rng.integers(1, w - 2, (n, h, w)) + rng.uniform(0.2, 0.8, (n, h, w))
    ty = rng.integers(1, h - 2, (n, h, w)) + rng.uniform(0.2, 0.8, (n, h, w))
    flow = torch.from_numpy(np.stack([tx - xx, ty - yy], 1)).requires_grad_(True)
    assert torch.autograd.gradcheck(tw.warp_planes, (img, flow), eps=1e-6,
                                    atol=1e-7, rtol=1e-6)


def test_warp_grad_zero_where_clamped_and_only_what_is_needed():
    rng = np.random.default_rng(8)
    n, c, h, w = 2, 4, 12, 16
    img = rng.normal(0, 1, (n, c, h, w)).astype(np.float32)
    flow = _flow(rng, n, h, w, "smooth").astype(np.float32)
    # Half the rows sample outside the frame on x, some columns on y.
    flow[:, 0, : h // 2] += 3 * w
    flow[:, 1, :, : w // 4] -= 2 * h
    wts = rng.normal(0, 1, (n, c, h, w)).astype(np.float32)
    got_img, got_flow = _grads_port(img, flow, wts, img_grad=False)
    assert got_img is None
    assert np.all(got_flow[:, 0, : h // 2] == 0)
    assert np.all(got_flow[:, 1, :, : w // 4] == 0)
    assert np.any(got_flow[:, 0, h // 2:] != 0)
    d_img, d_flow = tw.warp_planes_bwd(torch.from_numpy(img), torch.from_numpy(flow),
                                       torch.from_numpy(wts), need_img=True,
                                       need_flow=False)
    assert d_flow is None and d_img.shape == img.shape
    before = tw.warp_planes_bwd.launches
    tw.warp_planes_bwd(torch.from_numpy(img), torch.from_numpy(flow),
                       torch.from_numpy(wts))
    assert tw.warp_planes_bwd.launches == before  # the CPU path launches nothing
