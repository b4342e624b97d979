"""rife_tpu_torch's NHWC warp (`ops.warp.warp`/`warp2`, the legacy models'
warp) against rife_tpu's, on the CPU.

On CPU tensors the port's warp is its plain version `warp_ref`, the
reference K3 and K4 are held to on the card.  Inputs come from a seeded
numpy generator.  f32 is held to rife_tpu's exact `warp_xla` within 1e-5
(the same formula), for 2, 3, 16 and 32 channels, smooth flows and a
+-200 px per-8x8-block flow that leaves the frame; to the Pallas kernel
K3 (`warp_pallas`) in interpret mode within 1e-5 on a smooth flow, where
that kernel is exact (K4 in `test_torch_warp_nhwc_v4.py`); and to the
planes plain version on the permuted tensors bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.ops import resize_bilinear
from rife_tpu.ops.pallas.warp import warp_pallas
from rife_tpu.ops.warp import warp2 as jax_warp2
from rife_tpu.ops.warp import warp_xla
from rife_tpu_torch.ops import warp as tw
from rife_tpu_torch.ops.cuda import warp_nhwc as cuda_nhwc


def _flow(rng, n, h, w, kind):
    """(N, H, W, 2) f32: a smooth field of a few px with a little noise,
    or +-200 px random per 8x8 block."""
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = np.stack([3.7 * np.sin(yy / 7.0) + 1.3, -2.9 * np.cos(xx / 5.0) - 0.6], -1)
        return (f + rng.normal(0, 0.3, (n, h, w, 2))).astype(np.float32)
    blk = rng.uniform(-200, 200, (n, -(-h // 8), -(-w // 8), 2))
    f = np.repeat(np.repeat(blk, 8, 1), 8, 2)[:, :h, :w]
    return (f + rng.uniform(-1, 1, (n, h, w, 2))).astype(np.float32)


def smooth_flow(rng, n, h, w, cell, mag):
    """tests/test_pallas_warp.py's flow: a coarse normal grid, resized."""
    coarse = rng.standard_normal((n, max(h // cell, 1), max(w // cell, 1), 2))
    return np.asarray(resize_bilinear(jnp.asarray(coarse.astype(np.float32) * mag),
                                      (h, w)))


@pytest.fixture
def _clear_jax_caches():
    """Interpret-mode kernels compile very large XLA CPU graphs; drop them
    after the test, as tests/test_pallas_warp.py does."""
    yield
    jax.clear_caches()


@pytest.mark.parametrize("c", [2, 3, 16, 32])
@pytest.mark.parametrize("kind", ["smooth", "blocks"])
def test_warp_matches_warp_xla_f32(c, kind):
    rng = np.random.default_rng(10 * c + len(kind))
    img = rng.random((2, 37, 53, c), np.float32)
    flow = _flow(rng, 2, 37, 53, kind)
    want = np.asarray(warp_xla(jnp.asarray(img), jnp.asarray(flow)))
    got = tw.warp(torch.from_numpy(img), torch.from_numpy(flow))
    assert got.shape == img.shape and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_warp2_matches_reference_warp2():
    rng = np.random.default_rng(4)
    a, b = (rng.random((2, 40, 56, 3), np.float32) for _ in range(2))
    fa, fb = _flow(rng, 2, 40, 56, "smooth"), _flow(rng, 2, 40, 56, "blocks")
    want = jax_warp2(*(jnp.asarray(x) for x in (a, b, fa, fb)))
    got = tw.warp2(*(torch.from_numpy(x) for x in (a, b, fa, fb)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_warp_matches_k3_in_interpret_mode(_clear_jax_caches):
    """K3 at tests/test_pallas_warp.py's 1x32x128x3 with its smooth flow
    (exact there); tile_h=8 keeps the interpret-mode trace near 15 s."""
    rng = np.random.default_rng(1234)
    img = rng.random((1, 32, 128, 3), np.float32)
    flow = smooth_flow(rng, 1, 32, 128, 32, 4.0)
    want = np.asarray(warp_pallas(jnp.asarray(img), jnp.asarray(flow), interpret=True,
                                  tile_h=8))
    got = tw.warp(torch.from_numpy(img), torch.from_numpy(flow.copy())).numpy()
    assert np.abs(flow).max() > 2.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,flow_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_warp_is_the_planes_warp_on_permuted_tensors(dtype, flow_dtype):
    """Bit for bit: the NHWC warp is the planes warp seen through permutes
    (on the card, K3/K4 against K1)."""
    rng = np.random.default_rng(7)
    for c in (3, 16):
        img = torch.from_numpy(rng.normal(0, 2, (2, 24, 40, c)).astype(np.float32)).to(dtype)
        flow = torch.from_numpy(_flow(rng, 2, 24, 40, "blocks")).to(flow_dtype)
        got = tw.warp(img, flow)
        planes = tw.warp_planes(img.permute(0, 3, 1, 2).contiguous(),
                                flow.permute(0, 3, 1, 2).contiguous())
        assert got.dtype == dtype
        assert torch.equal(got, planes.permute(0, 2, 3, 1))


def test_warp_on_channels_last_strides_is_the_same():
    """Channel slices of a channels-last tensor (pixel stride 6 and 4, as
    the legacy models pass them) give the numbers of contiguous copies."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((2, 6, 32, 48), np.float32)).contiguous(
        memory_format=torch.channels_last)
    f = torch.from_numpy(rng.normal(0, 5, (2, 4, 32, 48)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    img, flow = x[:, 3:].permute(0, 2, 3, 1), f[:, 2:4].permute(0, 2, 3, 1)
    assert img.stride() == (6 * 32 * 48, 6 * 48, 6, 1) and flow.stride()[2:] == (4, 1)
    assert torch.equal(tw.warp(img, flow), tw.warp(img.contiguous(), flow.contiguous()))


def test_warp_backward_raises_instead_of_returning_zeros():
    """The NHWC warp's backward is the plain gradient on CPU tensors (not
    zeros: it equals warp_planes_bwd_ref on the permuted planes, bit for
    bit, and counts no kernel launch); on a device without a kernel it
    raises rather than fall back."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((1, 8, 8, 3), np.float32)).requires_grad_(True)
    flow = torch.from_numpy(_flow(rng, 1, 8, 8, "smooth")).requires_grad_(True)
    g = torch.from_numpy(rng.normal(0, 1, (1, 8, 8, 3)).astype(np.float32))
    before = tw.warp_planes_bwd.launches
    tw.warp(img, flow).backward(g)
    d_img, d_flow = tw.warp_planes_bwd_ref(img.detach().permute(0, 3, 1, 2).contiguous(),
                                           flow.detach().permute(0, 3, 1, 2).contiguous(),
                                           g.permute(0, 3, 1, 2).contiguous())
    assert torch.equal(img.grad, d_img.permute(0, 2, 3, 1))
    assert torch.equal(flow.grad, d_flow.permute(0, 2, 3, 1))
    assert float(img.grad.abs().sum()) > 0 and float(flow.grad.abs().sum()) > 0
    assert tw.warp_planes_bwd.launches == before
    meta = [torch.zeros(1, 8, 8, c, device="meta") for c in (3, 2, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        tw.warp_nhwc_bwd(*meta)
    assert tw.warp_planes_bwd.launches == before


@pytest.mark.parametrize("c", [3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_gradient_matches_warp_xla(c, dtype):
    """d_img and d_flow of the NHWC warp (on a channels-last channel slice,
    as the legacy models pass it) against jax.grad of rife_tpu's
    `warp_xla` in f32 within 1e-5 of the terms' scale (a smooth flow with
    no coordinate on a clamp edge); in bf16, the port's own f32 gradient
    of the same bf16 inputs rounded once to bf16 (rife_tpu's bf16 warp
    rounds its weights to bf16, the port keeps them in f32)."""
    rng = np.random.default_rng(20 + c)
    n, h, w = 2, 24, 40
    x = rng.random((n, h, w, 2 * c), np.float32)
    flow = _flow(rng, n, h, w, "smooth")
    g = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    loss = lambda i, f: jnp.sum(warp_xla(i, f) * g)  # noqa: E731
    want_i, want_f = jax.jit(jax.grad(loss, (0, 1)))(jnp.asarray(x[..., c:]),
                                                      jnp.asarray(flow))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    ft = torch.from_numpy(flow).to(dtype).requires_grad_(True)
    img = xt[..., c:]
    assert img.stride()[-1] == 1 and img.stride()[-2] == 2 * c
    tw.warp(img, ft).backward(torch.from_numpy(g).to(dtype))
    assert xt.grad.dtype == ft.grad.dtype == dtype
    assert float(xt.grad[..., :c].abs().max()) == 0.0
    got_i, got_f = xt.grad[..., c:].float().numpy(), ft.grad.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got_i, np.asarray(want_i), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(want_i)).max())
        np.testing.assert_allclose(got_f, np.asarray(want_f), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(want_f)).max())
    else:
        i32 = img.detach().float().requires_grad_(True)
        f32 = ft.detach().float().requires_grad_(True)
        tw.warp(i32, f32).backward(torch.from_numpy(g).to(dtype).float())
        assert torch.equal(xt.grad[..., c:], i32.grad.to(dtype))
        assert torch.equal(ft.grad, f32.grad.to(dtype))


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    before = (tw.warp_nhwc_k3.launches, tw.warp_nhwc_k4.launches)
    for c in (3, 8):
        tw.warp(torch.zeros(1, 8, 8, c), torch.zeros(1, 8, 8, 2))
    assert (tw.warp_nhwc_k3.launches, tw.warp_nhwc_k4.launches) == before
    for c in (3, 8):  # K3's and K4's entries both refuse a device without a kernel
        with pytest.raises(ValueError, match="CUDA"):
            tw.warp(torch.zeros(1, 8, 8, c, device="meta"),
                    torch.zeros(1, 8, 8, 2, device="meta"))
    assert (tw.warp_nhwc_k3.launches, tw.warp_nhwc_k4.launches) == before


def test_k4_takes_16_byte_loads_only_where_aligned():
    f32 = torch.zeros(2, 5, 7, 32)
    assert cuda_nhwc.vector_loads(f32)
    assert cuda_nhwc.vector_loads(torch.zeros(2, 5, 7, 64, dtype=torch.bfloat16))
    assert not cuda_nhwc.vector_loads(torch.zeros(2, 5, 7, 12, dtype=torch.bfloat16))
    assert not cuda_nhwc.vector_loads(torch.zeros(2, 5, 7, 10))
    assert not cuda_nhwc.vector_loads(f32[..., 1:9])  # address off by 4 bytes
    assert cuda_nhwc.vector_loads(f32[..., 4:12])  # strides of 32, address +16 B
