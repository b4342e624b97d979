"""The paper model's family beyond `rife`: `rife_m` (the timestep plane),
`rife_2r` (the half-resolution contract) and scale lists of any factor,
rife_tpu_torch vs rife_tpu on the CPU.

No weights of `rife_m` or `rife_2r` are in the repo: both sides take a
seeded draw of the reference's tree (narrow blocks, flow heads scaled so
that the warps move several pixels), carried by `state_dict_from_jax`.
64x96 inputs (48x96 for the scale list (3, 2, 1): its x1/3 level needs
a height divisible by 12, the context pyramid one divisible by 16), f32,
2e-4 abs, K1 launches and the K2 form counted on both sides
(tests/test_torch_ladder.py's helpers).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu.models.ifnet import ifnet_apply
from rife_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from rife_tpu_torch.engine import InferenceEngine, state_dict_from_jax
from rife_tpu_torch.models import (MODEL_REGISTRY, IFNet, IFNetConfig,
                                   detect_model_from_state_dict, get_model_def)

from test_torch_ladder import ATOL, Counts, compare_forward, nhwc, pair, planes, random_tree

NARROW = dict(block_channels=(32, 24, 16), teacher_channels=16)


def _cfgs(**kw):
    return JaxIFNetConfig(**NARROW, **kw), IFNetConfig(**NARROW, **kw)


@pytest.mark.parametrize("timestep", [0.3, np.array([0.3, 0.7], np.float32)],
                         ids=["t0.3", "per-pair"])
@pytest.mark.parametrize("fast", [False, True])
def test_rife_m_matches_reference(monkeypatch, timestep, fast):
    jcfg, cfg = _cfgs(variant="rife_m", fast_level0=fast)
    jparams = random_tree(jcfg, seed=11, flow_gain=4.0)
    assert jparams["block0"]["conv0"][0]["conv"]["w"].shape[2] == 7
    img0, img1 = pair(64, 96, seed=5)
    (jc, tc), got = compare_forward(Counts(monkeypatch), jparams, jcfg, cfg,
                                    (4.0, 2.0, 1.0), img0, img1, timestep)
    assert jc == tc == (6, ["pair"]), (jc, tc)
    assert float(got["flow_list"][-1].abs().max()) > 2.0
    net = IFNet(cfg)
    net.load_state_dict(state_dict_from_jax(jparams))
    with torch.no_grad():
        other = net(planes(img0), planes(img1), timestep=0.5)["merged"][-1]
    assert float((other - got["merged"][-1]).abs().max()) > 1e-3  # t reaches the net


def test_rife_m_teacher_matches_reference(monkeypatch):
    jcfg, cfg = _cfgs(variant="rife_m")
    jparams = random_tree(jcfg, seed=12, flow_gain=4.0)
    img0, img1 = pair(64, 96, seed=6)
    gt = np.ascontiguousarray(0.5 * (img0 + img1) + 0.01)
    counts = Counts(monkeypatch)
    want = jax.jit(functools.partial(ifnet_apply, cfg=jcfg))(
        jparams, jnp.asarray(img0), jnp.asarray(img1), timestep=jnp.float32(0.3),
        gt=jnp.asarray(gt))
    net = IFNet(cfg)
    net.load_state_dict(state_dict_from_jax(jparams))
    with torch.no_grad():
        got = net(planes(img0), planes(img1), timestep=0.3, gt=planes(gt))
    for key in ("flow_teacher", "merged_teacher"):
        np.testing.assert_allclose(nhwc(got[key]), np.asarray(want[key]), rtol=0,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(float(got["loss_distill"]), float(want["loss_distill"]),
                               rtol=0, atol=1e-4)
    # With gt both take the composed final level: 8 warps, no K2.
    assert counts.both() == ((8, []),) * 2


@pytest.mark.parametrize("fast", [0, 3, 4])
def test_rife_2r_matches_reference(monkeypatch, fast):
    """The 2R contract turns the fast rungs off in both packages (rung 3
    still halves the final level's resolution): 6 K1 + a K2 with the pair
    (rungs <= 3), context level 0 at full resolution."""
    switches = {0: {}, 3: dict(fast_level0=True, fast_refine=True),
                4: dict(fast_level0=True, fast_refine=True, refine=False)}[fast]
    jcfg, cfg = _cfgs(half_res=True, **switches)
    jparams = random_tree(jcfg, seed=13, flow_gain=4.0)
    img0, img1 = pair(64, 96, seed=7)
    counts = Counts(monkeypatch)
    scale_list = (4.0, 2.0, 2.0) if fast >= 3 else (4.0, 2.0, 1.0)
    (jc, tc), got = compare_forward(counts, jparams, jcfg, cfg, scale_list, img0, img1)
    assert jc == tc == ((2, ["blend only"]) if fast == 4 else (6, ["pair"])), (jc, tc)
    assert float(got["flow_list"][-1].abs().max()) > 2.0


def test_rife_2r_teacher_matches_reference(monkeypatch):
    jcfg, cfg = _cfgs(half_res=True)
    jparams = random_tree(jcfg, seed=14, flow_gain=4.0)
    img0, img1 = pair(64, 96, seed=8)
    gt = np.ascontiguousarray(0.5 * (img0 + img1) + 0.01)
    want = jax.jit(functools.partial(ifnet_apply, cfg=jcfg))(
        jparams, jnp.asarray(img0), jnp.asarray(img1), gt=jnp.asarray(gt))
    net = IFNet(cfg)
    net.load_state_dict(state_dict_from_jax(jparams))
    with torch.no_grad():
        got = net(planes(img0), planes(img1), gt=planes(gt))
    for key in ("flow_teacher", "merged_teacher"):
        np.testing.assert_allclose(nhwc(got[key]), np.asarray(want[key]), rtol=0,
                                   atol=ATOL, err_msg=key)


# (scale list, fast_level0, height, K1 per forward)
SCALES = [((8.0, 4.0, 2.0), False, 64, 6), ((8.0, 4.0, 2.0), True, 64, 6),
          ((2.0, 1.0, 0.5), False, 64, 6), ((2.0, 1.0, 0.5), True, 64, 6),
          ((3.0, 2.0, 1.0), False, 48, 6), ((3.0, 2.0, 1.0), True, 48, 6)]


@pytest.mark.parametrize("scale_list,fast,h,k1", SCALES)
def test_scale_lists_match_reference(monkeypatch, scale_list, fast, h, k1):
    """(8, 4, 2): even factors only, at rung 1 every level built at its
    working resolution; (2, 1, 0.5): the last level works above full
    resolution (the stack upsampled by the general resize) and rung 1
    changes nothing (level 1 is at full resolution); (3, 2, 1): block0's
    input by the general x1/3 and its output by plane_up(6)."""
    jcfg, cfg = _cfgs(fast_level0=fast)
    jparams = random_tree(jcfg, seed=15, flow_gain=4.0)
    img0, img1 = pair(h, 96, seed=9)
    (jc, tc), got = compare_forward(Counts(monkeypatch), jparams, jcfg, cfg, scale_list,
                                    img0, img1)
    assert jc == tc == (k1, ["pair"]), (jc, tc)
    assert got["merged"][-1].shape == (2, 3, h, 96)


def test_registry_and_engine_serve_the_family():
    """rife_m and rife_2r have the reference's presets, serve from seeded
    weights (rife_m's timestep reaching the frame, per pair too) and take
    the reference's input widths."""
    for name in ("rife_m", "rife_2r"):
        d, jd = MODEL_REGISTRY[name], JAX_REGISTRY[name]
        assert (d.config.variant, d.config.half_res) == (jd.config.variant, jd.config.half_res)
        assert d.scale_list == jd.scale_list and d.pad_multiple == jd.pad_multiple
        assert d.config.block_in == jd.config.block_in
        assert d.config.teacher_in == jd.config.teacher_in
    sd_m = get_model_def("rife_m").init(torch.Generator().manual_seed(1))
    assert sd_m["block0.conv0.0.conv.weight"].shape[1] == 7
    assert sd_m["block_tea.conv0.0.conv.weight"].shape[1] == 21
    # The checkpoint detection reads the original model's key names.
    assert detect_model_from_state_dict(
        {"block0.conv0.0.0.weight": np.zeros((120, 7, 3, 3))}) == "rife_m"
    a, b = pair(32, 64, seed=10)
    eng = InferenceEngine("rife_m", sd_m, device="cpu")
    assert eng.supports_timestep
    quarter, half = eng.interpolate(a, b, 0.25), eng.interpolate(a, b, 0.5)
    assert float((quarter - half).abs().max()) > 1e-4
    per_pair = eng.interpolate(a, b, np.array([0.25, 0.5], np.float32))
    torch.testing.assert_close(per_pair[0], quarter[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(per_pair[1], half[1], rtol=0, atol=1e-6)
    eng2r = InferenceEngine("rife_2r", seed=2, fast=4, device="cpu")
    assert not eng2r.supports_timestep and eng2r.model.unet is None
    assert eng2r.interpolate(a, b).shape == (2, 32, 64, 3)
    with pytest.raises(KeyError, match="unknown model"):
        get_model_def("rife_x")
