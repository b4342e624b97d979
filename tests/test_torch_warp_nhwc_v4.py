"""rife_tpu_torch's NHWC warp against rife_tpu's K4 (`warp_pallas_v4`, the
f32 route for C >= 8) in interpret mode, on the CPU.

At tests/test_pallas_warp.py's 1x48x256 with its smooth flow, where K4 is
exact, but with 8 channels (the smallest count `warp_pallas_auto` sends
to K4) and tile_h=8: interpret mode traces and compiles K4's kernel body
once per channel of a block, and at 16 channels that alone takes ~47 s
here, at 8 ~36 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rife_tpu.ops import resize_bilinear
from rife_tpu.ops.pallas.warp_v4 import warp_pallas_v4
from rife_tpu_torch.ops import warp as tw


def test_warp_matches_k4_in_interpret_mode():
    rng = np.random.default_rng(1234)
    img = rng.random((1, 48, 256, 8), np.float32)
    coarse = rng.standard_normal((1, 1, 5, 2)).astype(np.float32) * 2.5
    flow = np.asarray(resize_bilinear(jnp.asarray(coarse), (48, 256)))
    try:
        want = np.asarray(warp_pallas_v4(jnp.asarray(img), jnp.asarray(flow),
                                         interpret=True, tile_h=8))
    finally:
        jax.clear_caches()
    got = tw.warp(torch.from_numpy(img), torch.from_numpy(flow.copy())).numpy()
    assert np.abs(flow).max() > 2.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
