"""rife_tpu_torch's legacy model `hdv2` against rife_tpu's, on the CPU
(`hd` in test_torch_legacy_hd.py, which shares this file's helpers).

Weights: rife_tpu's `init_hdv2` from a seeded key (the repository holds
no legacy checkpoint), carried across by `state_dict_from_jax(...,
model="hdv2")`, with each block's flow head (`block{i}.conv1`) scaled so
that the flows reach several pixels: at random init they stay under half
a pixel and would leave the warps idle.  Inputs: the same seeded numpy
frames in both packages, 2x64x128 at full width.  The reference runs
under `jax.jit`.  f32 (TF32 off on the port's side) is held within 2e-4
on the output frame and every block's flow; bf16 to the port's own f32
(>= 40 dB PSNR).  A three-file checkpoint written here with random
reference-named state dicts is loaded by both packages' `load_checkpoint`.
"""
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from rife_tpu.models import legacy as jax_legacy
from rife_tpu.models.registry import detect_model_from_state_dict as jax_detect
from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
from rife_tpu_torch.engine.checkpoint import jax_tree_from_state_dict
from rife_tpu_torch.models import detect_model_from_state_dict, get_model_def
from rife_tpu_torch.ops import warp as tw

FLOW_GAIN = 20.0
_APPLY = {"hdv2": jax_legacy.hdv2_apply, "hd": jax_legacy.hd_apply}
_INIT = {"hdv2": jax_legacy.init_hdv2, "hd": jax_legacy.init_hd}


def init_tree(model, seed=0):
    """rife_tpu's init from a seeded key, as numpy, flow heads scaled.
    The key is an "rbg" one: the init draws ~28M values in ~60 shapes, and
    eager threefry compiles each shape's draw (24 s here; rbg 11 s)."""
    tree = jax.tree.map(np.array, _INIT[model](jax.random.key(seed, impl="rbg")))
    return scale_flow_heads(tree)


def scale_flow_heads(tree, gain=FLOW_GAIN):
    for i in range(4):
        head = tree[f"block{i}"]["conv1"]
        head["w"] = head["w"] * gain
        head["b"] = head["b"] * gain
    return tree


@functools.lru_cache(maxsize=None)
def jitted(model, divisor=1.0):
    return jax.jit(functools.partial(_APPLY[model], scale_list=(divisor,)))


def frames(n=2, h=64, w=128, seed=0):
    """Smooth textured content, the second frame panned 5 px right, 3 down."""
    rng = np.random.default_rng(seed)
    base = rng.random((n, h + 16, w + 16, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)) / 3
    return (np.ascontiguousarray(base[:, 8:8 + h, 8:8 + w]),
            np.ascontiguousarray(base[:, 5:5 + h, 3:3 + w]))


def check_carrier_round_trip(model, tree):
    sd = state_dict_from_jax(tree, model=model)
    d = get_model_def(model)
    net = d.build(d.config)
    net.load_state_dict(sd)  # strict: every key and shape
    assert sorted(sd) == sorted(net.state_dict())
    back = jax_tree_from_state_dict(sd, model=model)
    la = jax.tree_util.tree_leaves_with_path(back)
    lb = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    return sd


def check_forward_f32(model, tree, scale, min_flow):
    """The port's CPU engine against jax.jit(apply): output frame, blend
    and every block's flow within 2e-4; the flows reach `min_flow` px."""
    a, b = frames(seed=int(10 * scale))
    want = jitted(model, 1.0 / scale)(tree, jnp.asarray(a), jnp.asarray(b))
    eng = InferenceEngine(model, state_dict_from_jax(tree, model=model),
                          scale=scale, device="cpu")
    assert eng.scale_list == (1.0 / scale,)
    np.testing.assert_allclose(eng.interpolate(a, b).numpy(),
                               np.asarray(want["merged"][-1]), rtol=0, atol=2e-4)
    with torch.inference_mode():
        got = eng.model(eng._input(a), eng._input(b), scale_list=eng.scale_list)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(nhwc(got["merged"][0]), np.asarray(want["merged"][0]),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(nhwc(got["mask"]), np.asarray(want["mask"]),
                               rtol=0, atol=2e-4)
    assert len(got["flow_list"]) == len(want["flow_list"]) == 4
    for i, (f, fw) in enumerate(zip(got["flow_list"], want["flow_list"])):
        np.testing.assert_allclose(nhwc(f), np.asarray(fw), rtol=0, atol=2e-4,
                                   err_msg=f"block {i}")
    largest = float(np.abs(np.asarray(want["flow_list"][-1])).max())
    assert largest >= min_flow, largest  # the warps move pixels


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def check_bf16(model, tree):
    a, b = frames(seed=5)
    sd = state_dict_from_jax(tree, model=model)
    out32 = InferenceEngine(model, sd, device="cpu").interpolate(a, b)
    out16 = InferenceEngine(model, sd, compute_dtype=torch.bfloat16,
                            device="cpu").interpolate(a, b)
    assert out16.dtype == torch.bfloat16
    quality = psnr(out16.float(), out32)
    assert quality >= 40.0, quality


def check_warps_and_layout(model, k3, k4):
    """The CPU path's warps: `k3` of C < 8 and `k4` of C >= 8 per forward
    (each a K3/K4 launch on the card), every image and flow handed over
    with channel stride 1, and the output frame channels-last."""
    seen = []
    ref = tw.warp_ref

    def record(img, flow):
        seen.append((img.shape[-1], img.stride(-1), flow.stride(-1)))
        return ref(img, flow)

    d = get_model_def(model)
    sd = d.init(torch.Generator().manual_seed(0))
    eng = InferenceEngine(model, sd, fast=1, device="cpu")
    a, b = frames(seed=2)
    tw.warp_ref = record
    try:
        with torch.inference_mode():
            out = eng.model(eng._input(a), eng._input(b), scale_list=eng.scale_list)
    finally:
        tw.warp_ref = ref
    assert sum(c < 8 for c, _, _ in seen) == k3
    assert sorted(c for c, _, _ in seen if c >= 8) == [32, 32, 64, 64, 128, 128, 256, 256]
    assert len(seen) == k3 + k4
    assert all(s == 1 and fs == 1 for _, s, fs in seen)
    assert out["merged"][-1].is_contiguous(memory_format=torch.channels_last)
    assert eng.interpolate(a, b).is_contiguous()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _oihw(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _deconv(w):
    """Inverse of the importers' transposed-conv mapping."""
    return np.flip(np.asarray(w).transpose(2, 3, 0, 1), (2, 3))


def _conv_prelu(sd, prefix, p):
    sd[f"{prefix}.0.weight"] = _t(_oihw(p["conv"]["w"]))
    sd[f"{prefix}.0.bias"] = _t(p["conv"]["b"])
    sd[f"{prefix}.1.weight"] = _t(p["alpha"])


def _deconv_prelu(sd, prefix, p):
    sd[f"{prefix}.0.weight"] = _t(_deconv(p["conv"]["w"]))
    sd[f"{prefix}.0.bias"] = _t(p["conv"]["b"])
    sd[f"{prefix}.1.weight"] = _t(p["alpha"])


def write_trio(path, model, tree, rng):
    """The reference's three state dicts (flownet.pkl, contextnet.pkl,
    unet.pkl, RIFE_HDv2.py / RIFE_HD.py names) for the weights of `tree`;
    `hd`'s flownet convs are bias-free and followed by BatchNorms with
    random, non-trivial statistics.  unet.pkl keeps DDP's "module."
    prefixes."""
    flow, ctx, unet = {}, {}, {}

    def conv_bn(sd, conv, bn, w):
        o = np.asarray(w).shape[-1]
        sd[f"{conv}.weight"] = _t(_oihw(w))
        sd[f"{bn}.weight"] = _t(rng.uniform(0.5, 1.5, o))
        sd[f"{bn}.bias"] = _t(rng.normal(0, 0.1, o))
        sd[f"{bn}.running_mean"] = _t(rng.normal(0, 0.1, o))
        sd[f"{bn}.running_var"] = _t(rng.uniform(0.5, 2.0, o))
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(1000)

    def se(sd, prefix, p, folded):
        if folded:  # IFNet_HD.ResBlock: conv + BN, no shortcut conv
            conv_bn(sd, f"{prefix}.conv1.0", f"{prefix}.conv1.1", p["conv1"]["conv"]["w"])
            sd[f"{prefix}.conv1.2.weight"] = _t(p["conv1"]["alpha"])
            conv_bn(sd, f"{prefix}.conv2.0", f"{prefix}.conv2.1", p["conv2"]["w"])
        else:  # RIFE_HD.ResBlock
            sd[f"{prefix}.conv0.weight"] = _t(_oihw(p["conv0"]["w"]))
            _conv_prelu(sd, f"{prefix}.conv1", p["conv1"])
            sd[f"{prefix}.conv2.0.weight"] = _t(_oihw(p["conv2"]["w"]))
            sd[f"{prefix}.conv2.0.bias"] = _t(p["conv2"]["b"])
        for k in ("relu1", "relu2"):
            sd[f"{prefix}.{k}.weight"] = _t(p[k])
        for k in ("fc1", "fc2"):
            sd[f"{prefix}.{k}.weight"] = _t(_oihw(p[k]["w"]))

    fus = tree["fusionnet"]
    for i in range(4):
        blk = tree[f"block{i}"]
        if model == "hdv2":
            for j in range(2):
                _conv_prelu(flow, f"block{i}.conv0.{j}", blk["conv0"][j])
            for k in range(6):
                _conv_prelu(flow, f"block{i}.convblock.{k}", blk["convblock"][k])
            flow[f"block{i}.conv1.weight"] = _t(_deconv(blk["conv1"]["w"]))
        else:
            conv_bn(flow, f"block{i}.conv0.0", f"block{i}.conv0.1", blk["conv0"]["conv"]["w"])
            flow[f"block{i}.conv0.2.weight"] = _t(blk["conv0"]["alpha"])
            for j in range(6):
                se(flow, f"block{i}.res{j}", blk[f"res{j}"], True)
            flow[f"block{i}.conv1.weight"] = _t(_oihw(blk["conv1"]["w"]))
        flow[f"block{i}.conv1.bias"] = _t(blk["conv1"]["b"])
    if model == "hdv2":
        for i in range(5):
            for s in ("conv1", "conv2"):
                _conv_prelu(ctx, f"conv{i}.{s}", tree["contextnet"][f"conv{i}"][s])
        for name in ("conv0", "down0", "down1", "down2", "down3"):
            for s in ("conv1", "conv2"):
                _conv_prelu(unet, f"{name}.{s}", fus[name][s])
        unet["conv.weight"] = _t(_deconv(fus["conv"]["w"]))
    else:
        _conv_prelu(ctx, "conv0", tree["contextnet"]["conv0"])
        for i in range(1, 5):
            se(ctx, f"conv{i}", tree["contextnet"][f"conv{i}"], False)
        _conv_prelu(unet, "conv0", fus["conv0"])
        for i in range(4):
            se(unet, f"down{i}", fus[f"down{i}"], False)
        unet["conv.weight"] = _t(_oihw(fus["conv"]["w"]))
    unet["conv.bias"] = _t(fus["conv"]["b"])
    for n in range(4):
        _deconv_prelu(unet, f"up{n}", fus[f"up{n}"])
    os.makedirs(path, exist_ok=True)
    torch.save(flow, os.path.join(path, "flownet.pkl"))
    torch.save(ctx, os.path.join(path, "contextnet.pkl"))
    torch.save({f"module.{k}": v for k, v in unet.items()}, os.path.join(path, "unet.pkl"))


def check_trio(model, tree, path):
    """Both packages' `load_checkpoint` read the trio to the same tree
    (bit for bit, BatchNorm folded the same way) and detect `model`; the
    port's engine on it matches jax.jit(apply) on rife_tpu's."""
    write_trio(path, model, tree, np.random.default_rng(11))
    jname, jtree = jax_load_checkpoint(str(path))
    name, ptree = load_checkpoint(str(path))
    assert name == jname == model
    la = jax.tree_util.tree_leaves_with_path(ptree)
    lb = jax.tree_util.tree_leaves_with_path(jtree)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=str(p))
    a, b = frames(seed=3)
    want = jitted(model)(jtree, jnp.asarray(a), jnp.asarray(b))["merged"][-1]
    got = InferenceEngine(model, state_dict_from_jax(ptree, model=model),
                          device="cpu").interpolate(a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


@pytest.fixture(scope="module")
def tree():
    return init_tree("hdv2")


def test_hdv2_weight_carrier_round_trip(tree):
    sd = check_carrier_round_trip("hdv2", tree)
    # The flow heads and the U-Net's last layer are transposed convs here.
    assert tuple(sd["block0.conv1.weight"].shape) == (384, 4, 4, 4)  # (I, O, kh, kw)
    assert tuple(sd["fusionnet.conv.weight"].shape) == (32, 4, 4, 4)
    assert tuple(sd["fusionnet.up0.conv.weight"].shape) == (1024, 256, 4, 4)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_hdv2_engine_matches_reference_f32(tree, scale):
    check_forward_f32("hdv2", tree, scale, min_flow=2.0)


def test_hdv2_trio_loads_the_same_in_both_packages(tree, tmp_path):
    check_trio("hdv2", tree, tmp_path / "hdv2")


def test_hdv2_bf16_close_to_f32(tree):
    check_bf16("hdv2", tree)


def test_hdv2_warps_and_layout():
    check_warps_and_layout("hdv2", k3=4, k4=8)


def test_detection_matches_reference():
    cases = [
        {"flownet.block0.conv1.weight", "contextnet.conv0.conv1.0.weight"},
        {"module.block0.conv1.weight", "module.block0.convblock.5.0.weight"},
        {"flownet.block0.res0.conv1.0.weight", "flownet.block0.conv1.weight"},
        {"block0.conv0.0.0.weight", "block0.convblock.6.0.weight"},
        {"encode.cnn0.weight"},
    ]
    for keys in cases:
        assert detect_model_from_state_dict(keys) == jax_detect(keys)
    rife_m = {"block0.conv0.0.0.weight": np.zeros((80, 7, 3, 3), np.float32)}
    assert detect_model_from_state_dict(rife_m) == jax_detect(rife_m) == "rife_m"
    with pytest.raises(ValueError):
        detect_model_from_state_dict({"foo.weight"})


def test_legacy_rungs_and_registry():
    """Rungs leave a legacy config as it is (it has no fast_level0); the
    scale knob is the divisor; the paper model still takes fast_level0."""
    for model in ("hd", "hdv2"):
        d = get_model_def(model)
        assert d.scale_list == (1.0,) and d.pad_multiple == 32
        sd = d.init(torch.Generator().manual_seed(1))
        for fast in (0, 1, 4):
            eng = InferenceEngine(model, sd, fast=fast, scale=0.5, device="cpu")
            assert eng.model_def.config == d.config
            assert eng.scale_list == (2.0,) and eng.pad_multiple == 64
            assert not eng.supports_timestep
    rife = InferenceEngine("rife", get_model_def("rife").init(
        torch.Generator().manual_seed(1)), fast=1, device="cpu")
    assert rife.model_def.config.fast_level0 and not rife.channels_last


def test_legacy_training_is_refused():
    """Training the legacy models is ported: `train_init` builds them (the
    convs of `hd`'s folded BatchNorms train as plain convs) and the CLI
    takes them; what stays refused is the chained step, for every model."""
    from rife_tpu_torch.cli.train import main as train_cli
    from rife_tpu_torch.train import train_init

    for model in ("hd", "hdv2"):
        st = train_init(get_model_def(model), total_steps=1, device="cpu")
        names = [k for k, _ in st.model.named_parameters()]
        assert names and not any("bn" in k or "running" in k for k in names)
        assert len(st.optimizer.param_groups[0]["params"]) == len(names)
        with pytest.raises(NotImplementedError, match="Not ported, by design"):
            train_cli(["--model", model, "--synthetic", "--device", "cpu",
                       "--steps_per_call", "2"])
