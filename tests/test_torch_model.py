"""rife_tpu_torch checkpoint reader, weight carrier, layers and IFNet vs
rife_tpu, on the CPU.

The same weights (the r5 checkpoint, or a random init of the reference
with narrow blocks) and the same seeded numpy inputs go through both
packages.  Nets are held to 2e-4 abs in f32: flows are in pixels and
pass through ~30 convolutions whose sums the two backends order
differently.
"""
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from rife_tpu.engine.checkpoint import load_params as jax_load_params
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu.models.ifnet import ifnet_apply, init_ifnet  # init: tree shapes only
from rife_tpu.nn import conv2d as jconv2d
from rife_tpu.nn import conv_transpose2d as jdeconv
from rife_tpu.nn import prelu as jprelu
import rife_tpu_torch.ops.warp as twarp
from rife_tpu_torch.engine import load_checkpoint, load_params, state_dict_from_jax
from rife_tpu_torch.models import IFNet, IFNetConfig
from rife_tpu_torch.nn import conv2d, conv_transpose2d, prelu

# rife_tpu.ops exports a function named `warp` that shadows the module.
jwarp = importlib.import_module("rife_tpu.ops.warp")
jrefine = importlib.import_module("rife_tpu.models.refine")
CKPT = os.path.join(os.path.dirname(__file__), "..", "train_log_r5", "flownet.rtpu")


@functools.lru_cache(maxsize=1)
def _r5():
    return load_checkpoint(CKPT)[1]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _same_tree(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_rtpu_reader_matches_reference():
    tree, meta = load_params(CKPT)
    jtree, jmeta = jax_load_params(CKPT)
    assert meta == jmeta
    _same_tree(tree, jtree)


def test_checkpoint_keeps_params_only():
    name, jparams = jax_load_checkpoint(CKPT)
    assert name == "rife"
    _same_tree(_r5(), jparams)


def test_carried_layers_match_reference():
    p = _r5()
    sd = state_dict_from_jax(p)
    x = np.random.default_rng(0).random((2, 12, 20, 6), np.float32)
    conv = p["block0"]["conv0"][0]
    want = jprelu(jconv2d(jnp.asarray(x), conv["conv"], stride=2), conv["alpha"])
    got = prelu(conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       sd["block0.conv0.0.conv.weight"],
                       sd["block0.conv0.0.conv.bias"], stride=2),
                sd["block0.conv0.0.alpha"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    y = np.random.default_rng(1).random((2, 5, 7, 240), np.float32)
    want = jdeconv(jnp.asarray(y), p["block0"]["lastconv"])
    got = conv_transpose2d(torch.from_numpy(y).permute(0, 3, 1, 2),
                           sd["block0.lastconv.weight"], sd["block0.lastconv.bias"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    up = p["unet"]["up3"]
    z = np.random.default_rng(2).normal(0, 1, (1, 6, 8, 64)).astype(np.float32)
    want = jprelu(jdeconv(jnp.asarray(z), up["conv"]), up["alpha"])
    got = prelu(conv_transpose2d(torch.from_numpy(z).permute(0, 3, 1, 2),
                                 sd["unet.up3.conv.weight"], sd["unet.up3.conv.bias"]),
                sd["unet.up3.alpha"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 8, 0:w + 8] / 9.0
    base = 0.5 + 0.25 * np.sin(yy[..., None] + np.arange(3)) * np.cos(xx[..., None])
    base = base + rng.normal(0, 0.02, base.shape)
    a = base[None, :h, :w].astype(np.float32)
    b = base[None, 3:h + 3, 2:w + 2].astype(np.float32)
    return np.concatenate([a, b[:, ::-1]]), np.concatenate([b, a[:, ::-1]])


def _count_calls(monkeypatch, module, name):
    calls = [0]
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def _compare(monkeypatch, jparams, block_channels, fast, scale_list, h, w):
    img0, img1 = _pair(h, w)
    jcfg = JaxIFNetConfig(block_channels=block_channels, fast_level0=fast)
    jcalls = _count_calls(monkeypatch, jwarp, "warp_planes")
    monkeypatch.setattr(jrefine, "warp_planes", jwarp.warp_planes)
    fn = jax.jit(functools.partial(ifnet_apply, cfg=jcfg, scale_list=scale_list))
    want = fn(jparams, jnp.asarray(img0), jnp.asarray(img1))

    sd = state_dict_from_jax(jparams)
    net = IFNet(IFNetConfig(block_channels=block_channels, fast_level0=fast,
                            teacher_channels=sd["block_tea.conv0.1.conv.weight"].shape[0]))
    net.load_state_dict(sd)
    tcalls = _count_calls(monkeypatch, twarp, "warp_planes_ref")
    with torch.no_grad():
        got = net(torch.from_numpy(img0).permute(0, 3, 1, 2).contiguous(),
                  torch.from_numpy(img1).permute(0, 3, 1, 2).contiguous(),
                  scale_list=scale_list)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    for key in ("flow_list", "mask_list"):
        for g, wnt in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(g), np.asarray(wnt), rtol=0, atol=2e-4,
                                       err_msg=key)
    np.testing.assert_allclose(nhwc(got["merged"][-1]), np.asarray(want["merged"][-1]),
                               rtol=0, atol=2e-4)
    # One pair-batched warp per level that warps, plus 4 context levels.
    assert tcalls[0] == jcalls[0] == 7


@pytest.mark.parametrize("fast,scale_list", [(False, (4.0, 2.0, 1.0)),
                                             (True, (4.0, 2.0, 1.0)),
                                             (True, (8.0, 4.0, 2.0))])
def test_ifnet_random_init_matches_reference(monkeypatch, fast, scale_list):
    chans = (32, 24, 16)
    jcfg = JaxIFNetConfig(block_channels=chans, teacher_channels=16)
    shapes = jax.eval_shape(lambda key: init_ifnet(key, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['alpha']"):
            return rng.uniform(0.1, 0.4, leaf.shape).astype(np.float32)
        bound = 1 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) == 4 else 0.1
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    jparams = jax.tree_util.tree_map_with_path(draw, shapes)
    _compare(monkeypatch, jparams, chans, fast, scale_list, 64, 96)


@pytest.mark.parametrize("fast", [False, True])
def test_ifnet_r5_weights_match_reference(monkeypatch, fast):
    _compare(monkeypatch, _r5(), (240, 150, 90), fast, (4.0, 2.0, 1.0), 64, 96)


@pytest.mark.parametrize("fast", [False, True])
def test_teacher_branch_matches_reference(monkeypatch, fast):
    """ifnet_apply(..., gt=) with the r5 weights at 64x96, f32: the
    teacher's flow and frame and every level's frame to 2e-4 abs, the
    distillation loss to 1e-4; 8 pair warps on both sides.  gt turns the
    fast rungs off in both packages."""
    img0, img1 = _pair(64, 96)
    gt = np.ascontiguousarray(0.5 * (img0 + img1) + 0.01)
    jcalls = _count_calls(monkeypatch, jwarp, "warp_planes")
    monkeypatch.setattr(jrefine, "warp_planes", jwarp.warp_planes)
    jcfg = JaxIFNetConfig(fast_level0=fast)
    fn = jax.jit(functools.partial(ifnet_apply, cfg=jcfg))
    want = fn(_r5(), jnp.asarray(img0), jnp.asarray(img1), gt=jnp.asarray(gt))

    net = IFNet(IFNetConfig(fast_level0=fast))
    net.load_state_dict(state_dict_from_jax(_r5()))
    tcalls = _count_calls(monkeypatch, twarp, "warp_planes_ref")
    planes = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    with torch.no_grad():
        got = net(planes(img0), planes(img1), gt=planes(gt))
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    for key in ("flow_teacher", "merged_teacher"):
        np.testing.assert_allclose(nhwc(got[key]), np.asarray(want[key]), rtol=0,
                                   atol=2e-4, err_msg=key)
    for g, w in zip(got["merged"], want["merged"]):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=2e-4)
    np.testing.assert_allclose(float(got["loss_distill"]), float(want["loss_distill"]),
                               rtol=0, atol=1e-4)
    assert float(want["loss_distill"]) > 0
    assert tcalls[0] == jcalls[0] == 8
