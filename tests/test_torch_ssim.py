"""rife_tpu_torch.ops.ssim and rife_tpu_torch.metrics vs rife_tpu, on the
CPU.

The SSIM family is held to 1e-6 abs in f32 on seeded numpy inputs (the
same shifted-slice sums in the same tap order), including a 7x9 input
where the window shrinks to 7 taps but the edge pad stays 5, inputs on
0-255 and [-1, 1] with `val_range=None`, and `full=True`.  The SSIM maps
are compared element by element.  The scalars are compared with the
reference's final means taken in f64: XLA's f32 mean on the CPU sums in
an order of its own and lands up to 1.2e-6 off the exact mean of its
own map (a [-1, 1] input at 2x24x40), where the port's torch mean lands
within 1e-7.  The metrics are a numpy copy and must agree bit for bit.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu import metrics as jmetrics
from rife_tpu_torch import metrics
from rife_tpu_torch.ops import msssim, ssim_matlab

jssim = importlib.import_module("rife_tpu.ops.ssim")
tssim = importlib.import_module("rife_tpu_torch.ops.ssim")


def _images(shape, seed, kind="unit"):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.08, shape), 0, 1).astype(np.float32)
    if kind == "255":
        a, b = a * 255, b * 255
    elif kind == "signed":
        a, b = a * 2 - 1, b * 2 - 1
    return a.astype(np.float32), b.astype(np.float32)


class _ExactMean:
    """jax.numpy with `mean` taken in f64 on the host (see the module
    docstring); every other name is jax.numpy's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def mean(x, *a, **k):
        return jnp.asarray(np.mean(np.asarray(x, np.float64), *a, **k), jnp.float32)


@pytest.fixture
def exact_mean(monkeypatch):
    monkeypatch.setattr(jssim, "jnp", _ExactMean())


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-6)


CASES = [((1, 32, 48, 3), "unit", 1.0), ((2, 64, 96, 3), "unit", None),
         ((1, 7, 9, 3), "unit", None), ((1, 32, 48, 3), "255", None),
         ((2, 24, 40, 3), "signed", None)]


@pytest.mark.parametrize("name", ["ssim", "ssim_matlab"])
@pytest.mark.parametrize("shape,kind,val_range", CASES)
@pytest.mark.parametrize("full", [False, True])
def test_ssim_matches_reference(exact_mean, name, shape, kind, val_range, full):
    a, b = _images(shape, seed=sum(shape), kind=kind)
    want = getattr(jssim, name)(jnp.asarray(a), jnp.asarray(b), val_range=val_range,
                                full=full)
    got = getattr(tssim, name)(torch.from_numpy(a), torch.from_numpy(b),
                               val_range=val_range, full=full)
    _close(got, want)


@pytest.mark.parametrize("name", ["ssim", "ssim_matlab"])
@pytest.mark.parametrize("shape,kind", [((2, 24, 40, 3), "signed"), ((1, 7, 9, 3), "unit")])
def test_ssim_maps_match_reference(name, shape, kind):
    """The maps and the cs maps element by element, before any mean."""
    a, b = _images(shape, seed=sum(shape), kind=kind)
    axes = (1, 2) if name == "ssim" else (1, 2, 3)
    real = min(11, shape[1], shape[2])
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if name == "ssim_matlab":
        ja, jb = jnp.moveaxis(ja, -1, 1), jnp.moveaxis(jb, -1, 1)
        ta, tb = ta.movedim(-1, 1), tb.movedim(-1, 1)
    for f in (lambda x, y: x, lambda x, y: x * y):
        jmap = jssim._blur(f(ja, jb), axes, real)
        tmap = tssim._blur(f(ta, tb), axes, real)
        np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), rtol=0, atol=1e-6)
    L = jssim._val_range(jnp.asarray(a), None)
    assert float(tssim._val_range(torch.from_numpy(a), None)) == float(L)
    jm, _ = jssim._ssim_core(ja, jb, lambda x: jssim._blur(x, axes, real), L)
    tm, _ = tssim._ssim_core(ta, tb, lambda x: tssim._blur(x, axes, real),
                             tssim._val_range(torch.from_numpy(a), None))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)


def test_window_shrinks_but_the_pad_stays_five():
    """At 7x9 the window is 7 taps and the pad 5 a side, so each blurred
    axis comes out 4 longer than its input; a pad of 3 would give
    another value."""
    a, b = _images((1, 7, 9, 3), seed=5)
    x = torch.from_numpy(a)
    blurred = tssim._blur(x.movedim(-1, 1), (2, 3), 7)
    assert tuple(blurred.shape) == (1, 3, 11, 13)
    got = float(ssim_matlab(x, torch.from_numpy(b)))
    want = float(jssim.ssim_matlab(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-6
    assert len(tssim._gaussian_1d(7)) == 7
    np.testing.assert_array_equal(tssim._gaussian_1d(11), jssim._gaussian_1d(11))


def test_pool_sums_as_the_reference_does():
    a, _ = _images((1, 13, 18, 3), seed=2)
    n, h, w, c = a.shape
    want = jnp.asarray(a)[:, :12].reshape(n, 6, 2, 9, 2, c).mean((2, 4))
    np.testing.assert_array_equal(tssim._pool2(torch.from_numpy(a)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("normalize", [False, True])
def test_msssim_matches_reference(exact_mean, normalize):
    a, b = _images((1, 96, 128, 3), seed=9)
    want = jssim.msssim(jnp.asarray(a), jnp.asarray(b), normalize=normalize)
    got = msssim(torch.from_numpy(a), torch.from_numpy(b), normalize=normalize)
    _close(got, want)


def test_ssim_of_an_image_with_itself_is_one():
    a, _ = _images((1, 32, 48, 3), seed=3)
    x = torch.from_numpy(a)
    assert abs(float(ssim_matlab(x, x)) - 1.0) <= 1e-6


def test_metrics_are_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    pred = rng.random((16, 24, 3)).astype(np.float32) * 1.2 - 0.1
    gt = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    gt01 = rng.random((16, 24, 3)).astype(np.float32)
    for fn, args in (("psnr", (pred, gt01)), ("psnr", (gt01, gt01)),
                     ("psnr", (pred * 255, gt.astype(np.float32), 255.0)),
                     ("psnr_uint8_protocol", (pred, gt)),
                     ("interpolation_error", (pred, gt))):
        got, want = getattr(metrics, fn)(*args), getattr(jmetrics, fn)(*args)
        assert type(got) is type(want) and (got == want), (fn, got, want)
    assert metrics.psnr(gt01, gt01) == float("inf")
    y = metrics.rgb_to_y(pred)
    np.testing.assert_array_equal(y, jmetrics.rgb_to_y(pred))
    assert y.shape == (16, 24)
