"""rife_tpu_torch resizes and padding vs their rife_tpu namesakes, on the CPU.

The resizes are held to 1e-5 abs in f32.  The reference works on NHWC for
`scale_by` and `pad_*` and on (N, C, H, W) planes for the `plane_*` ops;
the port works on planes throughout except for the NHWC frame padding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.ops import pad as jpad
from rife_tpu.ops import resize as jres
from rife_tpu_torch.ops import pad as tpad
from rife_tpu_torch.ops import resize as tres


def _planes(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("f", [2, 4, 8])
def test_plane_up(f):
    x = _planes((2, 5, 6, 10), f)
    _close(tres.plane_up(torch.from_numpy(x), f), jres.plane_up(jnp.asarray(x), f))


def test_plane_down2():
    x = _planes((2, 4, 24, 40))
    _close(tres.plane_down2(torch.from_numpy(x)), jres.plane_down2(jnp.asarray(x)))


@pytest.mark.parametrize("f", [2, 4, 8, 16])
def test_plane_down_int(f):
    x = _planes((2, 3, 32, 48), f)
    _close(tres.plane_down_int(torch.from_numpy(x), f),
           jres.plane_down_int(jnp.asarray(x), f))


@pytest.mark.parametrize("factor,hw", [(0.5, (24, 40)), (0.25, (32, 48)),
                                       (2.0, (9, 13)), (0.7, (37, 53)),
                                       (1.5, (11, 17))])
def test_scale_by(factor, hw):
    x = _planes((2,) + hw + (3,), int(factor * 10))  # NHWC, as the reference takes
    want = jres.scale_by(jnp.asarray(x), factor)
    got = tres.scale_by(torch.from_numpy(x).permute(0, 3, 1, 2), factor)
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("hw,mult", [((37, 53), 32), ((64, 96), 32), ((720, 1280), 32),
                                     ((37, 53), 64)])
def test_pad_to_multiple(hw, mult):
    x = _planes((1,) + hw + (3,))
    want, wp = jpad.pad_to_multiple(jnp.asarray(x), mult)
    got, gp = tpad.pad_to_multiple(torch.from_numpy(x), mult)
    assert (gp.top, gp.bottom, gp.left, gp.right, gp.orig_h, gp.orig_w) == \
        (wp.top, wp.bottom, wp.left, wp.right, wp.orig_h, wp.orig_w)
    _close(got, want)
    _close(gp.crop(got), x)


def test_pad_centered():
    x = _planes((2, 37, 600, 3))
    want, wp = jpad.pad_centered(jnp.asarray(x), 32, 512)
    got, gp = tpad.pad_centered(torch.from_numpy(x), 32, 512)
    assert (gp.top, gp.bottom, gp.left, gp.right) == \
        (wp.top, wp.bottom, wp.left, wp.right)
    _close(got, want)
    _close(gp.crop(got), x)
