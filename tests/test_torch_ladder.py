"""The paper model's ladder (rungs 2-4), refine off, and the engine's TTA,
`with_flow` and seeded init: rife_tpu_torch vs rife_tpu on the CPU.

The same weights (the r5 checkpoint, or a seeded draw of the reference's
tree) and the same seeded numpy inputs at 64x96 go through
`jax.jit(ifnet_apply)` or rife_tpu's engine and through the port, in f32,
held to 2e-4 abs (as tests/test_torch_model.py).  Both sides count their
warps: K1 launches (pair-batched plane warps) and the final level's K2
launch with its form (with the pair, or blend only).
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
from rife_tpu.engine.inference import InferenceEngine as JaxEngine
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu.models.ifnet import ifnet_apply, init_ifnet  # init: tree shapes only
import rife_tpu_torch.ops.warp as twarp
from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
from rife_tpu_torch.models import IFNet, IFNetConfig, get_model_def

jwarp = importlib.import_module("rife_tpu.ops.warp")
jrefine = importlib.import_module("rife_tpu.models.refine")
jifnet = importlib.import_module("rife_tpu.models.ifnet")
tifnet = importlib.import_module("rife_tpu_torch.models.ifnet")
CKPT = os.path.join(os.path.dirname(__file__), "..", "train_log_r5", "flownet.rtpu")
ATOL = 2e-4


@functools.lru_cache(maxsize=1)
def _r5():
    return load_checkpoint(CKPT)[1]


def pair(h, w, seed=0):
    """Two NHWC pairs of smooth textured content, panned by (3, 2) px and
    mirrored (tests/test_torch_model.py's recipe)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 8, 0:w + 8] / 9.0
    base = 0.5 + 0.25 * np.sin(yy[..., None] + np.arange(3)) * np.cos(xx[..., None])
    base = base + rng.normal(0, 0.02, base.shape)
    a = base[None, :h, :w].astype(np.float32)
    b = base[None, 3:h + 3, 2:w + 2].astype(np.float32)
    return np.concatenate([a, b[:, ::-1]]), np.concatenate([b, a[:, ::-1]])


def random_tree(jcfg, seed=3, flow_gain=1.0):
    """A seeded draw of the reference's parameter tree for `jcfg` (torch's
    default bounds, PReLU slopes in [0.1, 0.4]); each block's flow head
    (lastconv's first 4 output channels) scaled by `flow_gain`."""
    shapes = jax.eval_shape(lambda key: init_ifnet(key, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['alpha']"):
            return rng.uniform(0.1, 0.4, leaf.shape).astype(np.float32)
        bound = 1 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) == 4 else 0.1
        v = rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if "['lastconv']" in name:
            v[..., :4] *= flow_gain
        return v

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Counts:
    """K1 launches and K2 forms on both sides, patched into both packages:
    rife_tpu's `warp_planes` (its composed final level warps once through
    it) and the `warp2_blend_planes` its ifnet calls; the port's plain
    warp (which its fused final level's plain version calls once) and the
    `warp2_blend_planes` its ifnet calls."""

    def __init__(self, monkeypatch):
        self.jax_warps, self.jax_k2 = [0], []
        self.torch_warps, self.torch_k2 = [0], []
        self._wrap(monkeypatch, jwarp, "warp_planes", self.jax_warps)
        monkeypatch.setattr(jrefine, "warp_planes", jwarp.warp_planes)
        self._wrap(monkeypatch, twarp, "warp_planes_ref", self.torch_warps)
        self._form(monkeypatch, jifnet, self.jax_k2)
        self._form(monkeypatch, tifnet, self.torch_k2)

    @staticmethod
    def _wrap(monkeypatch, module, name, box):
        fn = getattr(module, name)

        def counted(*a, **k):
            box[0] += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, counted)

    @staticmethod
    def _form(monkeypatch, module, forms):
        fn = module.warp2_blend_planes

        def counted(*a, **k):
            forms.append("pair" if k.get("need_pair", a[4] if len(a) > 4 else True)
                         else "blend only")
            return fn(*a, **k)

        monkeypatch.setattr(module, "warp2_blend_planes", counted)

    def reset(self):
        self.jax_warps[0] = self.torch_warps[0] = 0
        self.jax_k2.clear()
        self.torch_k2.clear()

    def both(self):
        """((K1, K2 forms) of rife_tpu, of the port)."""
        return ((self.jax_warps[0] - len(self.jax_k2), list(self.jax_k2)),
                (self.torch_warps[0] - len(self.torch_k2), list(self.torch_k2)))


def planes(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def compare_forward(counts, jparams, jcfg, cfg, scale_list, img0, img1, timestep=0.5,
                    sd=None):
    """ifnet_apply (jitted) and IFNet on the same weights and inputs: every
    level's flow and mask and the final frame within ATOL.  Returns the
    launch counts of both sides and the port's output."""
    counts.reset()
    fn = jax.jit(functools.partial(ifnet_apply, cfg=jcfg, scale_list=scale_list))
    want = fn(jparams, jnp.asarray(img0), jnp.asarray(img1),
              timestep=jnp.asarray(timestep, jnp.float32))
    net = IFNet(cfg)
    net.load_state_dict(state_dict_from_jax(jparams) if sd is None else sd)
    with torch.no_grad():
        got = net(planes(img0), planes(img1), scale_list=scale_list,
                  timestep=torch.as_tensor(timestep, dtype=torch.float32))
    for key in ("flow_list", "mask_list"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=ATOL,
                                       err_msg=key)
    np.testing.assert_allclose(nhwc(got["merged"][-1]), np.asarray(want["merged"][-1]),
                               rtol=0, atol=ATOL)
    return counts.both(), got


# (rung, the engine's config switches, scale list, K1 per forward, K2 form)
RUNGS = [
    (2, dict(fast_level0=True, fast_refine=True), (4.0, 2.0, 1.0), 7, "blend only"),
    (3, dict(fast_level0=True, fast_refine=True), (4.0, 2.0, 2.0), 7, "blend only"),
    (4, dict(fast_level0=True, fast_refine=True, refine=False), (4.0, 2.0, 2.0), 2,
     "blend only"),
]


@pytest.mark.parametrize("rung,switches,scale_list,k1,form", RUNGS)
def test_rungs_on_r5_match_reference(monkeypatch, rung, switches, scale_list, k1, form):
    img0, img1 = pair(64, 96)
    counts = Counts(monkeypatch)
    # Rung 4's net keeps no refine stage; the checkpoint's is left out.
    sd = {k: v for k, v in state_dict_from_jax(_r5()).items()
          if switches.get("refine", True) or not k.startswith(("contextnet.", "unet."))}
    (jc, tc), got = compare_forward(counts, _r5(), JaxIFNetConfig(**switches),
                                    IFNetConfig(**switches), scale_list, img0, img1, sd=sd)
    assert jc == tc == (k1, [form]), (jc, tc)
    if rung == 4:  # no residual and no clamp: the final level's blend itself
        flow, sig = got["flow_list"][-1], got["mask_list"][-1]
        w0 = twarp.warp_planes_ref(planes(img0), flow[:, 0:2])
        w1 = twarp.warp_planes_ref(planes(img1), flow[:, 2:4])
        torch.testing.assert_close(got["merged"][-1], w0 * sig + w1 * (1 - sig),
                                   rtol=0, atol=1e-6)


def test_refine_off_on_a_tree_without_refine_stage(monkeypatch):
    """IFNetConfig(refine=False) on a seeded tree that has no contextnet or
    unet keys (the reference's init builds none): exact graph, 2 K1 + a
    blend-only K2; and the forward's `refine=False` on a full net."""
    jcfg = JaxIFNetConfig(block_channels=(32, 24, 16), teacher_channels=16, refine=False)
    jparams = random_tree(jcfg)
    assert "contextnet" not in jparams and "unet" not in jparams
    cfg = IFNetConfig(block_channels=(32, 24, 16), teacher_channels=16, refine=False)
    assert IFNet(cfg).contextnet is None
    img0, img1 = pair(64, 96, seed=1)
    counts = Counts(monkeypatch)
    (jc, tc), _ = compare_forward(counts, jparams, jcfg, cfg, (4.0, 2.0, 1.0), img0, img1)
    assert jc == tc == (2, ["blend only"])

    full = JaxIFNetConfig(block_channels=(32, 24, 16), teacher_channels=16)
    fparams = random_tree(full)
    counts.reset()
    want = jax.jit(functools.partial(ifnet_apply, cfg=full, refine=False))(
        fparams, jnp.asarray(img0), jnp.asarray(img1))
    net = IFNet(IFNetConfig(block_channels=(32, 24, 16), teacher_channels=16))
    net.load_state_dict(state_dict_from_jax(fparams))
    with torch.no_grad():
        got = net(planes(img0), planes(img1), refine=False)
    np.testing.assert_allclose(nhwc(got["merged"][-1]), np.asarray(want["merged"][-1]),
                               rtol=0, atol=ATOL)
    assert counts.both() == ((2, ["blend only"]),) * 2


@pytest.fixture(scope="module")
def r5_engines():
    return {"jparams": jax_load_checkpoint(CKPT)[1],
            "sd": state_dict_from_jax(load_checkpoint(CKPT)[1])}


@pytest.mark.parametrize("fast", [1, 4])
def test_engine_tta_matches_reference(monkeypatch, r5_engines, fast):
    """tta=True: both H and W flipped, the two frames averaged; each
    forward's launches twice."""
    a, b = pair(64, 96, seed=2)
    counts = Counts(monkeypatch)
    jeng = JaxEngine("rife", r5_engines["jparams"], compute_dtype=jnp.float32, fast=fast,
                     warp_impl="xla")
    want = jeng.interpolate(jnp.asarray(a), jnp.asarray(b), tta=True)
    eng = InferenceEngine("rife", r5_engines["sd"], fast=fast, device="cpu")
    got = eng.interpolate(a, b, tta=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    k1, form = {1: (6, "pair"), 4: (2, "blend only")}[fast]
    assert counts.both() == ((2 * k1, [form] * 2),) * 2
    one = eng.interpolate(a, b)
    flipped = eng.interpolate(*(np.ascontiguousarray(x[:, ::-1, ::-1]) for x in (a, b)))
    torch.testing.assert_close(got, (one + torch.flip(flipped, (1, 2))) / 2, rtol=0, atol=0)
    assert float((got - one).abs().max()) > 1e-4  # the flipped pass is another frame


def test_engine_with_flow_matches_reference(r5_engines):
    a, b = pair(64, 96, seed=3)
    jeng = JaxEngine("rife", r5_engines["jparams"], compute_dtype=jnp.float32, fast=2,
                     warp_impl="xla")
    fn = jax.jit(functools.partial(jeng._forward, tta=False, with_flow=True))
    want_mid, want_flow = fn(jeng.params, jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(0.5, jnp.float32))
    eng = InferenceEngine("rife", r5_engines["sd"], fast=2, device="cpu")
    mid, flow = eng.forward(a, b, with_flow=True)
    assert flow.shape == (2, 64, 96, 4) and flow.dtype == torch.float32
    np.testing.assert_allclose(flow.numpy(), np.asarray(want_flow), rtol=0, atol=ATOL)
    np.testing.assert_allclose(mid.numpy(), np.asarray(want_mid), rtol=0, atol=ATOL)
    torch.testing.assert_close(mid, eng.interpolate(a, b), rtol=0, atol=0)
    assert float(flow.abs().max()) > 1.0  # the pan moves the pair by (3, 2) px


def test_engine_rungs_follow_the_reference(r5_engines):
    for rung in range(5):
        jeng = JaxEngine("rife", r5_engines["jparams"], fast=rung, warp_impl="xla")
        eng = InferenceEngine("rife", r5_engines["sd"], fast=rung, device="cpu")
        jcfg, cfg = jeng.model_def.config, eng.model_def.config
        assert (cfg.fast_level0, cfg.fast_refine, cfg.refine) == \
            (jcfg.fast_level0, jcfg.fast_refine, jcfg.refine), rung
        assert eng.scale_list == jeng.scale_list
        # Rung 4 loads the whole checkpoint strictly, then drops the stage.
        assert (eng.model.contextnet is None) == (rung == 4)
        assert eng.model.block_tea is None
    for scale in (0.5, 2.0):
        eng = InferenceEngine("rife", r5_engines["sd"], fast=3, scale=scale, device="cpu")
        jeng = JaxEngine("rife", r5_engines["jparams"], fast=3, scale=scale)
        assert eng.scale_list == jeng.scale_list and eng.pad_multiple == jeng.pad_multiple
    with pytest.raises(RuntimeError, match="Missing key"):
        InferenceEngine("rife", {k: v for k, v in r5_engines["sd"].items()
                                 if not k.startswith("unet.")}, fast=1, device="cpu")


def test_engine_seeded_init():
    """params=None draws ModelDef.init from the seed: the same seed gives
    the same weights and frames, another seed other weights."""
    a, b = pair(32, 32, seed=4)
    one = InferenceEngine("rife", None, seed=5, device="cpu")
    two = InferenceEngine("rife", seed=5, device="cpu")
    other = InferenceEngine("rife", seed=6, device="cpu")
    want = get_model_def("rife").init(torch.Generator().manual_seed(5))
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, want[k]) and torch.equal(v, two.model.state_dict()[k]), k
    assert not torch.equal(one.model.block0.lastconv.weight,
                           other.model.block0.lastconv.weight)
    torch.testing.assert_close(one.interpolate(a, b), two.interpolate(a, b), rtol=0, atol=0)
    # Rung 4 draws a tree without the refine stage, as the reference's init.
    assert InferenceEngine("rife", fast=4, seed=5, device="cpu").model.unet is None
