"""rife_tpu_torch on the card: the CUDA kernel against its plain version,
and the engine through the kernel against the CPU path.

Marked `gpu`; each test skips without a card.  This file imports neither
JAX nor rife_tpu, so it also runs where only PyTorch is installed:

    pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py imports JAX; --noconftest skips it on such a machine.)
"""
import os

import numpy as np
import pytest
import torch

from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
from rife_tpu_torch.ops import warp as tw

CKPT = os.path.join(os.path.dirname(__file__), "..", "train_log_r5", "flownet.rtpu")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _flow(rng, n, h, w, kind):
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        f = np.stack([3.7 * np.sin(yy / 7.0) + 1.3, -2.9 * np.cos(xx / 5.0) - 0.6])
        return np.broadcast_to(f, (n, 2, h, w)) + rng.normal(0, 0.3, (n, 2, h, w))
    if kind == "out_of_frame":
        return rng.uniform(-1.5 * max(h, w), 1.5 * max(h, w), (n, 2, h, w))
    blk = rng.uniform(-200, 200, (n, 2, -(-h // 8), -(-w // 8)))
    return np.repeat(np.repeat(blk, 8, 2), 8, 3)[:, :, :h, :w]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["smooth", "out_of_frame", "blocks"])
def test_kernel_matches_plain_version(dtype, kind):
    _need_card()
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((4, 19, 67, 131), np.float32)).cuda().to(dtype)
    flow = torch.from_numpy(_flow(rng, 4, 67, 131, kind).astype(np.float32))
    flow = flow.cuda().to(dtype)
    before = tw.warp_planes.launches
    got = tw.warp_planes(img, flow)
    assert tw.warp_planes.launches == before + 1
    want = tw.warp_planes_ref(img, flow)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().cpu().numpy()
    if dtype == torch.float32:
        assert err.max() <= 1e-5
    else:
        assert np.all(err <= _bf16_ulp(want.float().cpu().numpy()))


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take():
    _need_card()
    img = torch.zeros(2, 3, 8, 8, device="cuda")
    with pytest.raises(ValueError):
        tw.warp_planes(img, torch.zeros(2, 2, 8, 9, device="cuda"))
    with pytest.raises(ValueError):
        tw.warp_planes(img.transpose(2, 3), torch.zeros(2, 2, 8, 8, device="cuda"))
    with pytest.raises(TypeError):
        tw.warp_planes(img.half(), torch.zeros(2, 2, 8, 8, device="cuda"))


@pytest.mark.gpu
def test_engine_goes_through_the_kernel():
    _need_card()
    sd = state_dict_from_jax(load_checkpoint(CKPT)[1])
    rng = np.random.default_rng(0)
    a = rng.random((2, 128, 192, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    ref = InferenceEngine("rife", sd, fast=1, device="cpu").interpolate(a, b)
    eng = InferenceEngine("rife", sd, fast=1)
    before = tw.warp_planes.launches
    got = eng.interpolate(a, b)
    torch.cuda.synchronize()
    assert tw.warp_planes.launches - before == 7
    # cuDNN and the CPU backend sum the convolutions in other orders.
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-3)
