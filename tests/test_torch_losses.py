"""rife_tpu_torch's auxiliary losses, VGG19 perceptual loss and training
panels against rife_tpu's, on the CPU.

Same seeded numpy inputs in both packages, f32.  The losses within 1e-5
absolute (the same formula, summed in other orders); the perceptual loss
on random VGG19-shaped weights (no pretrained VGG19 ships with the repo)
at 2x32x32 within 1e-5; the panels equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.train import losses as jl
from rife_tpu.train import perceptual as jp
from rife_tpu.utils import viz as jviz
from rife_tpu_torch.train import losses as tl
from rife_tpu_torch.train import perceptual as tp
from rife_tpu_torch.utils import viz as tviz
from rife_tpu_torch.utils.logging import MetricLogger

VGG_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512)


def _planes(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_epe_loss_matches_reference():
    rng = np.random.default_rng(0)
    f = rng.normal(0, 3, (2, 16, 24, 2)).astype(np.float32)
    g = rng.normal(0, 3, (2, 16, 24, 2)).astype(np.float32)
    m = (rng.random((2, 16, 24, 1)) > 0.3).astype(np.float32)
    want = np.asarray(jax.jit(jl.epe_loss)(f, g, m))
    got = _nhwc(tl.epe_loss(_planes(f), _planes(g), _planes(m)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 9, 13)])
def test_ternary_loss_matches_reference(shape):
    """7x7 census, soft-normalised, 1-pixel border masked: on two images
    and on an image against itself (zero)."""
    rng = np.random.default_rng(1)
    a = rng.random((*shape, 3), np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = float(jax.jit(jl.ternary_loss)(a, b))
    got = float(tl.ternary_loss(_planes(a), _planes(b)))
    assert want > 0.1
    assert abs(got - want) <= 1e-5, (got, want)
    assert float(tl.ternary_loss(_planes(a), _planes(a))) == 0.0


def test_sobel_loss_matches_reference():
    """On a 4-channel flow against zero (v4.25's smoothness) and on two
    3-channel images."""
    rng = np.random.default_rng(2)
    f = rng.normal(0, 4, (2, 20, 28, 4)).astype(np.float32)
    want = float(jax.jit(jl.sobel_loss)(f, np.zeros_like(f)))
    got = float(tl.sobel_loss(_planes(f), torch.zeros(2, 4, 20, 28)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)
    a, b = rng.random((2, 2, 17, 19, 3), np.float32)
    want = float(jax.jit(jl.sobel_loss)(a, b))
    got = float(tl.sobel_loss(_planes(a), _planes(b)))
    assert abs(got - want) <= 1e-5, (got, want)


def test_losses_are_differentiable_like_the_reference():
    """The gradients of ternary and sobel through autograd against
    jax.grad, in f32."""
    rng = np.random.default_rng(3)
    a, b = rng.random((2, 1, 12, 16, 3), np.float32)
    for jf, tf in ((jl.ternary_loss, tl.ternary_loss), (jl.sobel_loss, tl.sobel_loss)):
        want = np.asarray(jax.jit(jax.grad(jf))(a, b))
        x = _planes(a).requires_grad_(True)
        tf(x, _planes(b)).backward()
        np.testing.assert_allclose(_nhwc(x.grad), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def _vgg_params(seed=0):
    """Random VGG19-shaped conv weights in the reference's HWIO layout, He
    scaled so the activations neither vanish nor blow up over 13 convs."""
    rng = np.random.default_rng(seed)
    params, cin = [], 3
    for co in VGG_WIDTHS:
        params.append({"w": (rng.standard_normal((3, 3, cin, co))
                             * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
                       "b": rng.normal(0, 0.01, co).astype(np.float32)})
        cin = co
    return params


def test_perceptual_loss_matches_reference(tmp_path):
    """On random VGG19-shaped weights at 2x32x32: the loss within 1e-5 of
    rife_tpu's; the same from the reference's .npz read by the port and
    from the port's .npz read by the reference; zero on equal images; the
    target detached (no gradient reaches it)."""
    jparams = _vgg_params()
    rng = np.random.default_rng(4)
    a = rng.random((2, 32, 32, 3), np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    want = float(jax.jit(jp.vgg_perceptual_loss)(jparams, a, b))
    ref_npz = str(tmp_path / "ref.npz")
    jp.save_vgg19_features(ref_npz, jparams)
    params = tp.load_vgg19_features(ref_npz)
    assert [tuple(p["weight"].shape) for p in params][:2] == [(64, 3, 3, 3), (64, 64, 3, 3)]
    x, y = _planes(a).requires_grad_(True), _planes(b).requires_grad_(True)
    got = tp.vgg_perceptual_loss(params, x, y)
    assert want > 1e-3
    assert got.dtype == torch.float32 and abs(got.item() - want) <= 1e-5, (got.item(), want)
    got.backward()
    assert y.grad is None and float(x.grad.abs().sum()) > 0
    assert float(tp.vgg_perceptual_loss(params, _planes(a), _planes(a))) == 0.0
    port_npz = str(tmp_path / "port.npz")
    tp.save_vgg19_features(port_npz, params)
    with np.load(ref_npz) as r, np.load(port_npz) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            np.testing.assert_array_equal(r[k], p[k], err_msg=k)
    again = float(jax.jit(jp.vgg_perceptual_loss)(jp.load_vgg19_features(port_npz), a, b))
    assert again == want


def test_torchvision_import_matches_reference():
    """A torchvision-layout `features` state dict -> the same weights in
    both packages' layouts."""
    jparams = _vgg_params(1)
    sd = {}
    for idx, p in zip(jp._VGG19_CONVS, jparams):
        sd[f"features.{idx}.weight"] = torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy())
        sd[f"features.{idx}.bias"] = torch.from_numpy(p["b"])
    want = jp.import_torchvision_vgg19(sd)
    got = tp.import_torchvision_vgg19(sd)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["weight"].permute(2, 3, 1, 0).numpy(), w["w"])
        np.testing.assert_array_equal(g["bias"].numpy(), w["b"])


def _vis(seed=5, n=6, h=12, w=20):
    rng = np.random.default_rng(seed)
    vis = {k: rng.random((n, h, w, 3), np.float32) * 1.2 - 0.1
           for k in ("pred", "gt", "merged_tea")}
    vis.update({k: rng.random((n, h, w, 1), np.float32) for k in ("mask", "mask_tea")})
    vis["flow"] = rng.normal(0, 3, (n, h, w, 2)).astype(np.float32)
    vis["flow_tea"] = rng.normal(0, 3, (n, h, w, 4)).astype(np.float32)
    return vis


def test_panels_equal_reference():
    vis = _vis()
    want, got = jviz.build_panels(vis), tviz.build_panels(vis)
    assert sorted(got) == sorted(want) and len(got) == 15
    for k in want:
        assert got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(tviz.build_panels(vis, n=2)) == sorted(jviz.build_panels(vis, n=2))
    for f in (vis["flow"][0], vis["flow_tea"][0], np.zeros((4, 5, 2), np.float32)):
        np.testing.assert_array_equal(tviz.flow_to_rgb(f), jviz.flow_to_rgb(f))


def test_dump_panels_writes_pngs_through_the_logger(tmp_path):
    """MetricLogger.log_image writes each panel as a PNG at the reference's
    path; the PNG reads back as the panel."""
    import cv2

    vis = _vis(n=2)
    logger = MetricLogger(str(tmp_path))
    try:
        paths = tviz.dump_panels(logger, 7, vis)
    finally:
        logger.close()
    panels = tviz.build_panels(vis)
    assert len(paths) == len(panels) == 6
    for (tag, img), path in zip(panels.items(), paths):
        assert path == str(tmp_path / "panels" / "step_00000007" / (tag.replace("/", "_")
                                                                    + ".png"))
        np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)


def test_vis_to_host_gives_nhwc():
    from rife_tpu_torch.train import vis_to_host

    t = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    got = vis_to_host({"pred": t, "mask": t[:, :1].to(torch.bfloat16)})
    np.testing.assert_array_equal(got["pred"], t.permute(0, 2, 3, 1).numpy())
    assert got["mask"].shape == (2, 4, 5, 1) and got["mask"].dtype == np.float32
    assert jnp.asarray(got["pred"]).shape == (2, 4, 5, 3)
