"""rife_tpu_torch's v4.25 against rife_tpu's, on the CPU.

Same weights (the in-repo v4.25 checkpoint, train_log_r5_v425) and the
same seeded numpy inputs in both packages.  The reference's forward runs
under `jax.jit` (eager it takes 11-21 s a call here).  f32 with TF32 off
on the port's side: the output frame and every level's flow within 2e-4.
The checkpoint's flows stay under 0.5 px, which leaves the warps nearly
idle, so every forward case also runs with the flow channels of each
block's head scaled by 30 (largest |flow| >= 8 px at every level).  bf16
is held to the port's own f32 (>= 40 dB PSNR).
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu import nn as jnn
from rife_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from rife_tpu.engine.inference import InferenceEngine as JaxEngine
from rife_tpu.models.v425 import V425Config as JaxV425Config
from rife_tpu.models.v425 import v425_apply
from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
from rife_tpu_torch.engine.checkpoint import jax_tree_from_state_dict
from rife_tpu_torch.engine.inference import full_f32
from rife_tpu_torch.models import V425, V425Config, get_model_def
from rife_tpu_torch.nn import leaky_relu, pixel_shuffle

CKPT = os.path.join(os.path.dirname(__file__), "..", "train_log_r5_v425",
                    "flownet.rtpu")
FLOW_GAIN = 30.0


def _enlarge_flows(tree, gain):
    """The reference tree with the flow channels of every block's head
    (deconv outputs 0-15, which PixelShuffle(2) makes channels 0-3)
    scaled by `gain`."""
    t = jax.tree.map(np.array, tree)
    for k in t:
        if k.startswith("block"):
            t[k]["lastconv"]["w"][..., 0:16] *= gain
            t[k]["lastconv"]["b"][0:16] *= gain
    return t


@pytest.fixture(scope="module")
def trees():
    name, tree = jax_load_checkpoint(CKPT)
    assert name == "v4.25"
    return {"ckpt": tree, "big_flow": _enlarge_flows(tree, FLOW_GAIN)}


@functools.lru_cache(maxsize=None)
def _jitted(fast: bool):
    return jax.jit(functools.partial(v425_apply, cfg=JaxV425Config(fast_level0=fast)))


def _pair(n, h, w, seed):
    """Smooth textured content, the second frame panned 5 px right, 3 down."""
    rng = np.random.default_rng(seed)
    base = rng.random((n, h + 16, w + 16, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3
    return (np.ascontiguousarray(base[:, 8:8 + h, 8:8 + w]),
            np.ascontiguousarray(base[:, 5:5 + h, 3:3 + w]))


def _planes(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def test_leaky_relu_and_pixel_shuffle_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 5, 7, 12)).astype(np.float32)  # NHWC, 12 = 3 * 2 * 2
    want = np.asarray(jnn.leaky_relu(jnp.asarray(x), 0.2))
    np.testing.assert_array_equal(leaky_relu(torch.from_numpy(x), 0.2).numpy(), want)
    want = np.asarray(jnn.pixel_shuffle(jnp.asarray(x), 2))  # (2, 10, 14, 3)
    got = pixel_shuffle(_planes(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_weight_carrier_round_trip_on_the_checkpoint(trees):
    name, tree = load_checkpoint(CKPT)
    assert name == "v4.25"
    sd = state_dict_from_jax(tree)
    model = V425()
    model.load_state_dict(sd)  # strict: every key and shape
    assert sorted(sd) == sorted(model.state_dict())
    assert tuple(sd["encode.cnn3.weight"].shape) == (16, 4, 4, 4)  # (I, O, kh, kw)
    assert tuple(sd["block0.lastconv.weight"].shape) == (192, 52, 4, 4)
    assert tuple(sd["block3.convblock.7.beta"].shape) == (64,)
    back = jax_tree_from_state_dict(sd)
    la = jax.tree_util.tree_leaves_with_path(back)
    lb = jax.tree_util.tree_leaves_with_path(trees["ckpt"])
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=str(path))
    assert get_model_def("v4.25").pad_multiple == 64


_CASES = [(64, 128, 0.5), (128, 192, 0.25), (64, 128, "per-pair")]


@pytest.mark.parametrize("weights", ["ckpt", "big_flow"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("h,w,timestep", _CASES)
def test_forward_matches_reference_f32(trees, weights, fast, h, w, timestep):
    tree = trees[weights]
    a, b = _pair(2, h, w, seed=h + w)
    t = np.float32(timestep) if timestep != "per-pair" else \
        np.array([0.25, 0.75], np.float32)
    want = _jitted(fast)(tree, jnp.asarray(a), jnp.asarray(b), timestep=jnp.asarray(t))
    model = V425(V425Config(fast_level0=fast))
    model.load_state_dict(state_dict_from_jax(tree))
    with torch.no_grad(), full_f32():
        got = model(_planes(a), _planes(b), torch.from_numpy(np.asarray(t)))
    out = got["merged"][-1].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(want["merged"][-1]), rtol=0, atol=2e-4)
    assert len(got["flow_list"]) == len(want["flow_list"]) == 5
    for i, (f, fw) in enumerate(zip(got["flow_list"], want["flow_list"])):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(fw),
                                   rtol=0, atol=2e-4, err_msg=f"level {i}")
    np.testing.assert_allclose(got["mask"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want["mask"]), rtol=0, atol=2e-4)
    largest = min(float(np.abs(np.asarray(fw)).max()) for fw in want["flow_list"])
    if weights == "big_flow":
        assert largest >= 8.0, largest  # the warps move pixels at every level
    # Where rung 1 warps at each level's own resolution, no full-res warps.
    kept = [m is not None for m in got["merged"][:-1]]
    assert kept == ([False, False, False, True] if fast else [True] * 4)


@pytest.mark.parametrize("fast", [0, 1])
def test_engine_matches_reference_engine_f32(trees, fast):
    a, b = _pair(2, 128, 192, seed=3)
    jeng = JaxEngine("v4.25", trees["ckpt"], compute_dtype=jnp.float32, fast=fast,
                     warp_impl="xla")
    eng = InferenceEngine("v4.25", state_dict_from_jax(trees["ckpt"]), fast=fast,
                          device="cpu")
    assert eng.supports_timestep and eng.pad_multiple == jeng.pad_multiple == 64
    assert eng.model_def.config.fast_level0 is bool(fast)
    for t in (0.5, 0.25):
        want = jeng.interpolate(jnp.asarray(a), jnp.asarray(b), timestep=t)
        got = eng.interpolate(a, b, timestep=t)
        assert got.shape == (2, 128, 192, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    assert not torch.equal(eng.interpolate(a, b, timestep=0.25),
                           eng.interpolate(a, b, timestep=0.5))


def test_engine_rungs_follow_the_reference(trees):
    sd = state_dict_from_jax(trees["ckpt"])
    for rung in (1, 2, 3, 4):  # v4.25 has only fast_level0 to turn on
        eng = InferenceEngine("v4.25", sd, fast=rung, device="cpu")
        assert eng.model_def.config.fast_level0
        assert eng.scale_list == (16.0, 8.0, 4.0, 2.0, 1.0)
    assert InferenceEngine("v4.25", sd, scale=0.5, device="cpu").scale_list == \
        (32.0, 16.0, 8.0, 4.0, 2.0)
    with pytest.raises(ValueError):
        InferenceEngine("v4.25", sd, fast=5, device="cpu")
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine("v4.25", sd)


def test_engine_bf16_close_to_own_f32(trees):
    a, b = _pair(2, 128, 192, seed=4)
    sd = state_dict_from_jax(_enlarge_flows(trees["ckpt"], FLOW_GAIN))
    for fast in (0, 1):
        ref = InferenceEngine("v4.25", sd, fast=fast, device="cpu").interpolate(a, b)
        got = InferenceEngine("v4.25", sd, compute_dtype=torch.bfloat16, fast=fast,
                              device="cpu").interpolate(a, b)
        assert got.dtype == torch.bfloat16
        mse = float(((got.float() - ref).double() ** 2).mean())
        assert 10 * np.log10(1.0 / max(mse, 1e-20)) >= 40.0
