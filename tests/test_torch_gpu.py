"""rife_tpu_torch on the card: the CUDA warp kernel, its gradient kernel,
the fused pair warp + blend kernel, the NHWC warps K3/K4, the convblock
chain kernel K5 and the gather probes K6-K8 against their plain versions,
the engines of every served model through the kernels against the CPU
path (the paper model at every rung of its ladder, with TTA and at scale
2), the SSIM family against the CPU, and two training steps through the
warp kernels.

Marked `gpu`; each test skips without a card.  This file imports neither
JAX nor rife_tpu, so it also runs where only PyTorch is installed:

    pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py imports JAX; --noconftest skips it on such a machine.)
"""
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
from rife_tpu_torch.ops import conv_chain as cc
from rife_tpu_torch.ops import gather_probe as gp
from rife_tpu_torch.ops import warp as tw
from rife_tpu_torch.ops.cuda import conv_chain as cc_cuda
from rife_tpu_torch.ops.cuda import warp as tw_cuda
from rife_tpu_torch.tools import conv_chain as cc_tool
from rife_tpu_torch.tools import gather_probe as gp_tool

CKPT = os.path.join(os.path.dirname(__file__), "..", "train_log_r5", "flownet.rtpu")
CKPT_V425 = os.path.join(os.path.dirname(__file__), "..", "train_log_r5_v425",
                         "flownet.rtpu")


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


# (image, flow) dtypes: each the kernels instantiate.  The bf16 training
# step passes a bf16 image with an f32 flow to the teacher's pair warp.
_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
           (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
_DTYPE_IDS = ["bf16", "f32", "bf16-img-f32-flow", "f32-img-bf16-flow"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("kind", ["smooth", "out_of_frame", "blocks"])
def test_kernel_matches_plain_version(dtype, flow_dtype, kind):
    _need_card()
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((4, 19, 67, 131), np.float32)).cuda().to(dtype)
    flow = torch.from_numpy(_flow(rng, 4, 67, 131, kind).astype(np.float32))
    flow = flow.cuda().to(flow_dtype)
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
    # Composed final level: 7 warp launches; fused: 6 and one warp_blend.
    for fused, k1, k2 in ((False, 7, 0), (True, 6, 1)):
        before, before2 = tw.warp_planes.launches, tw.warp2_blend_planes.launches
        with tw.use_fuse_blend(fused):
            got = eng.interpolate(a, b)
        torch.cuda.synchronize()
        assert tw.warp_planes.launches - before == k1
        assert tw.warp2_blend_planes.launches - before2 == k2
        # cuDNN and the CPU backend sum the convolutions in other orders.
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("kind", ["smooth", "out_of_frame", "blocks"])
@pytest.mark.parametrize("need_img", [True, False])
def test_backward_kernel_matches_plain_version(dtype, flow_dtype, kind, need_img):
    """f32: within 1e-5 of the sum of the terms' magnitudes (channel and
    atomic summation order); bf16: plus one bf16 ulp of the plain
    version's f32 result (one rounding)."""
    _need_card()
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.normal(0, 2, (3, 37, 45, 67)).astype(np.float32))
    flow = torch.from_numpy(_flow(rng, 3, 45, 67, kind).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (3, 37, 45, 67)).astype(np.float32))
    img, g = (t.cuda().to(dtype) for t in (img, g))
    flow = flow.cuda().to(flow_dtype)
    before = tw.warp_planes_bwd.launches
    d_img, d_flow = tw.warp_planes_bwd(img, flow, g, need_img, True)
    assert tw.warp_planes_bwd.launches == before + 1
    assert (d_img is not None) == need_img and d_flow.dtype == flow_dtype
    assert d_img is None or d_img.dtype == dtype
    want = tw.warp_planes_bwd_ref(img.float(), flow.float(), g.float(), need_img, True)
    scale = tw._bwd_term_scale(img, flow, g)
    torch.cuda.synchronize()
    for got, w, m in zip((d_img, d_flow), want, scale):
        if got is None:
            continue
        lim = 1e-5 * m.cpu().numpy()
        if got.dtype == torch.bfloat16:
            lim = lim + _bf16_ulp(w.cpu().numpy())
        err = (got.float() - w).abs().cpu().numpy()
        assert np.all(err <= lim), float(err.max())


@pytest.mark.gpu
def test_warp_on_the_card_has_a_gradient_through_the_kernel():
    _need_card()
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.random((2, 16, 24, 40), np.float32)).cuda()
    flow = torch.from_numpy(_flow(rng, 2, 24, 40, "smooth").astype(np.float32)).cuda()
    wts = torch.from_numpy(rng.random((2, 16, 24, 40), np.float32)).cuda()
    ti, tf = img.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    out = tw.warp_planes(ti, tf)
    assert out.grad_fn is not None
    before = tw.warp_planes_bwd.launches
    (out * wts).sum().backward()
    assert tw.warp_planes_bwd.launches == before + 1
    ri, rf = img.cpu().requires_grad_(True), flow.cpu().requires_grad_(True)
    (tw.warp_planes(ri, rf) * wts.cpu()).sum().backward()
    np.testing.assert_allclose(ti.grad.cpu().numpy(), ri.grad.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.grad.cpu().numpy(), rf.grad.numpy(), rtol=0, atol=1e-4)


def _assert_bwd_within_bound(img, flow, g, got, need_img):
    """The gradient kernel's (d_img, d_flow) against the plain version's f32
    result: within 1e-5 of the sum of the terms' magnitudes, plus one bf16
    ulp for a bf16 result (test_backward_kernel_matches_plain_version's
    bound)."""
    want = tw.warp_planes_bwd_ref(img.float(), flow.float(), g.float(), need_img, True)
    scale = tw._bwd_term_scale(img, flow, g)
    torch.cuda.synchronize()
    for k, w, m in zip(got, want, scale):
        assert (k is None) == (w is None)
        if k is None:
            continue
        lim = 1e-5 * m.cpu().numpy()
        if k.dtype == torch.bfloat16:
            lim = lim + _bf16_ulp(w.cpu().numpy())
        err = (k.float() - w).abs().cpu().numpy()
        assert np.all(err <= lim), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("c", [3, 16])
def test_backward_kernel_merges_taps_where_the_host_replay_says(dtype, flow_dtype, c):
    """On a flow that is a constant fractional shift on the left half of the
    frame and +-200 px random per 8x8 block on the right half, one launch
    hands the smooth pixels' right taps of d_img to their neighbours and
    adds the rest tap by tap: the kernel's own count of each equals the
    host's replay (`tap_merges`), both occur, and d_img and d_flow are
    within the plain version's bound."""
    _need_card()
    rng = np.random.default_rng(11 + c)
    n, h, w = 2, 48, 192
    img = torch.from_numpy(rng.normal(0, 2, (n, c, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (n, c, h, w)).astype(np.float32))
    img, g = (t.cuda().to(dtype) for t in (img, g))
    f = _flow(rng, n, h, w, "blocks").astype(np.float32)
    f[:, :, :, : w // 2] = np.array([[2.3, -1.6], [-4.7, 0.2]], np.float32)[:, :, None, None]
    flow = torch.from_numpy(f).cuda().to(flow_dtype)
    merges = torch.zeros(2, dtype=torch.int32, device="cuda")
    got = tw_cuda.launch_bwd(img, flow, g, True, True, merges=merges)
    gave, kept = tw_cuda.tap_merges(flow, tw_cuda.bwd_plan(img.shape))
    assert tuple(merges.tolist()) == (gave, kept)
    assert gave > 0 and kept > 0
    _assert_bwd_within_bound(img, flow, g, got, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
def test_backward_d_flow_is_the_same_bit_for_bit_across_calls(dtype, flow_dtype):
    """d_flow from three calls, with and without d_img, is the same bit for
    bit: the channel order of its sums is the plan's; and within the plain
    version's bound."""
    _need_card()
    rng = np.random.default_rng(12)
    n, c, h, w = 2, 24, 40, 136
    img = torch.from_numpy(rng.normal(0, 2, (n, c, h, w)).astype(np.float32)).cuda().to(dtype)
    g = torch.from_numpy(rng.normal(0, 1, (n, c, h, w)).astype(np.float32)).cuda().to(dtype)
    flow = torch.from_numpy(_flow(rng, n, h, w, "blocks").astype(np.float32))
    flow = flow.cuda().to(flow_dtype)
    first = tw_cuda.launch_bwd(img, flow, g, True, True)
    second = tw_cuda.launch_bwd(img, flow, g, True, True)
    third = tw_cuda.launch_bwd(img, flow, g, False, True)
    assert torch.equal(first[1], second[1]) and torch.equal(first[1], third[1])
    _assert_bwd_within_bound(img, flow, g, first, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
def test_k1_and_gradient_at_ragged_widths(dtype, flow_dtype):
    """Widths that are no multiple of 8 and narrower than a tile: K1 in both
    layouts (3 channels: runs of 2 pixels; 5: a pixel a thread) bit-equal
    to its plain version, the gradient within its bound, on smooth,
    out-of-frame and block flows."""
    _need_card()
    rng = np.random.default_rng(13)
    for w, c in itertools.product((1, 2, 3, 7, 13, 31, 33, 67, 131), (3, 5)):
        for kind in ("smooth", "out_of_frame", "blocks"):
            n, h = 2, 9
            img = torch.from_numpy(rng.normal(0, 2, (n, c, h, w)).astype(np.float32))
            g = torch.from_numpy(rng.normal(0, 1, (n, c, h, w)).astype(np.float32))
            img, g = (t.cuda().to(dtype) for t in (img, g))
            flow = torch.from_numpy(_flow(rng, n, h, w, kind).astype(np.float32))
            flow = flow.cuda().to(flow_dtype)
            got = tw_cuda.launch(img, flow)
            assert torch.equal(got, tw.warp_planes_ref(img, flow)), (w, c, kind)
            for need_img in (True, False):
                got = tw_cuda.launch_bwd(img, flow, g, need_img, True)
                _assert_bwd_within_bound(img, flow, g, got, need_img)


@pytest.mark.gpu
def test_backward_kernel_refuses_tiles_wider_than_a_warp():
    """The shuffle merge of d_img's taps needs a tile's row within one warp:
    the C entry refuses tx_shift > 5 (a tile over 32 wide) with
    cudaErrorInvalidValue (1), and takes the plan's own."""
    _need_card()
    n, c, h, w = 1, 3, 8, 64
    img = torch.zeros(n, c, h, w, device="cuda")
    flow = torch.zeros(n, 2, h, w, device="cuda")
    d_img = torch.zeros_like(img)
    fn = tw_cuda.library_bwd().warp_planes_bwd_f32
    stream = torch.cuda.current_stream().cuda_stream
    args = [img.data_ptr(), flow.data_ptr(), img.data_ptr(), d_img.data_ptr(), None,
            n, c, h, w, 0]
    assert fn(*args, 6, 8, None, stream) == 1
    p = tw_cuda.bwd_plan(img.shape)
    assert fn(*args, p["tx_shift"], p["p_shift"], None, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_k1_bf16_past_2_31_output_elements():
    """760 bf16 frames of 3x736x1280 (2.15e9 elements, over 2^31): the
    planes' 64-bit bases, with 32-bit offsets within a plane.  The first and
    last frames bit-equal to K1 and the plain version on those frames alone."""
    _need_card()
    n, c, h, w = 760, 3, 736, 1280
    assert n * c * h * w > 2 ** 31
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    img = torch.rand(n, c, h, w, device="cuda", generator=gen, dtype=torch.bfloat16)
    yy = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    phase = torch.arange(n, device="cuda", dtype=torch.float32).view(n, 1, 1)
    flow = torch.stack([(9 * torch.sin(yy / 40 + phase)).expand(n, h, w),
                        (7 * torch.cos(xx / 60 + phase)).expand(n, h, w)], 1).bfloat16()
    out = tw.warp_planes(img, flow)
    for i in (0, n - 1):
        one = tw.warp_planes(img[i:i + 1].clone(), flow[i:i + 1].clone())
        want = tw.warp_planes_ref(img[i:i + 1], flow[i:i + 1])
        torch.cuda.synchronize()
        assert torch.equal(out[i:i + 1], one) and torch.equal(one, want), i


@pytest.mark.gpu
def test_warp_kernel_and_gradient_are_one_cuda_launch_each():
    """By the profiler's device events: K1 is one kernel a call (the feature
    maps' layout, at 16 channels, and the frame pairs'), and the gradient
    one kernel a call (besides the d_img scratch's memset and cast), where
    it was two; the counters move by one."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(14)
    img = torch.from_numpy(rng.normal(0, 2, (2, 16, 40, 72)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.normal(0, 1, (2, 16, 40, 72)).astype(np.float32)).cuda()
    flow = torch.from_numpy(_flow(rng, 2, 40, 72, "smooth").astype(np.float32)).cuda()
    pair = img[:, :3].contiguous()
    calls = [("warp_planes_flat_kernel", tw.warp_planes, lambda: tw.warp_planes(img, flow)),
             ("warp_planes_kernel", tw.warp_planes, lambda: tw.warp_planes(pair, flow))]
    for need_img in (True, False):
        calls.append(("warp_planes_bwd_kernel", tw.warp_planes_bwd,
                      lambda ni=need_img: tw.warp_planes_bwd(img, flow, g, ni, True)))
    for name, counter, fn in calls:
        fn()
        torch.cuda.synchronize()
        before = counter.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        assert counter.launches == before + 1
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "warp_planes" in e.name]
        assert len(kernels) == 1 and name in kernels[0], kernels


@pytest.mark.gpu
def test_two_training_steps_on_the_card():
    """bf16 training from a random init at 2x64x64: finite losses, 8
    forward and 8 backward warp launches per step, every parameter moves."""
    _need_card()
    from rife_tpu_torch.data import SyntheticTriplets, batch_iterator
    from rife_tpu_torch.models import get_model_def
    from rife_tpu_torch.train import train_init, train_step

    state = train_init(get_model_def("rife"), total_steps=10,
                       schedule=lambda step: 2e-4)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    batches = batch_iterator(SyntheticTriplets(n=4, h=72, w=72), 2, crop=64)
    f0, b0 = tw.warp_planes.launches, tw.warp_planes_bwd.launches
    losses = [float(train_step(state, next(batches), torch.bfloat16)["loss"])
              for _ in range(2)]
    assert np.isfinite(losses).all()
    assert tw.warp_planes.launches - f0 == 16 and tw.warp_planes_bwd.launches - b0 == 16
    for k, v in state.model.state_dict().items():
        assert not torch.equal(v, before[k]), k


def _ulp(v: np.ndarray, dtype) -> np.ndarray:
    """One ulp of `dtype` (bf16 or f32) at |v|."""
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - (7 if dtype == torch.bfloat16 else 23))


@pytest.mark.gpu
@pytest.mark.parametrize("side_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["smooth", "out_of_frame", "blocks"])
@pytest.mark.parametrize("need_pair", [True, False])
def test_blend_kernel_matches_plain_version(side_dtype, dtype, kind, need_pair):
    """w0 and w1 bit-equal to the plain version (K1's taps and blend); the
    blend within one ulp of the images' dtype at the magnitude of its
    terms (the last f32 bit of the sigmoid may move one rounding)."""
    _need_card()
    rng = np.random.default_rng(7)
    n, c, h, w = 3, 3, 45, 67
    a, b = (torch.from_numpy(rng.random((n, c, h, w), np.float32)).cuda().to(dtype)
            for _ in range(2))
    flow = np.concatenate([_flow(rng, n, h, w, kind), _flow(rng, n, h, w, kind)], 1)
    flow = torch.from_numpy(flow.astype(np.float32)).cuda().to(side_dtype)
    mask = torch.from_numpy(rng.normal(0, 3, (n, 1, h, w)).astype(np.float32))
    mask = mask.cuda().to(side_dtype)
    before = tw.warp2_blend_planes.launches
    with tw.use_fuse_blend(True):
        got = tw.warp2_blend_planes(a, b, flow, mask, need_pair=need_pair)
    assert tw.warp2_blend_planes.launches == before + 1
    want = tw.warp2_blend_planes_ref(a, b, flow, mask, need_pair=True)
    torch.cuda.synchronize()
    got = got if need_pair else (got,)
    assert all(g.dtype == dtype for g in got)
    for g, wv in zip(got[1:], want[1:]):
        assert torch.equal(g, wv)
    terms = torch.maximum(want[1].float().abs(), want[2].float().abs()).cpu().numpy()
    err = (got[0].float() - want[0].float()).abs().cpu().numpy()
    assert np.all(err <= _ulp(terms, dtype)), float(err.max())


@pytest.mark.gpu
def test_blend_kernel_refuses_what_it_cannot_take():
    _need_card()
    x = torch.zeros(2, 3, 8, 8, device="cuda")
    f, m = torch.zeros(2, 4, 8, 8, device="cuda"), torch.zeros(2, 1, 8, 8, device="cuda")
    from rife_tpu_torch.ops.cuda import warp_blend as cb

    with pytest.raises(ValueError):
        cb.launch(x, x, f[:, :2], m, True)
    with pytest.raises(ValueError):
        cb.launch(x.transpose(2, 3), x, f, m, True)
    with pytest.raises(TypeError):
        cb.launch(x.half(), x.half(), f, m, False)
    with pytest.raises(ValueError):
        cb.launch(x, x.cpu(), f, m, False)


def _offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of `t` `offset` elements into its storage."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].view(t.shape)


_TRIPLES = list(itertools.product((torch.bfloat16, torch.float32), repeat=3))
_TRIPLE_IDS = ["-".join(str(t)[6:] for t in tr) for tr in _TRIPLES]


def _assert_blend(got, want, dtype, label):
    """w0 and w1 bit-equal to the plain version, the blend within one ulp
    of the images' dtype at the magnitude of its terms."""
    for g, wv in zip(got[1:], want[1:]):
        assert torch.equal(g, wv), label
    terms = torch.maximum(want[1].float().abs(), want[2].float().abs()).cpu().numpy()
    err = (got[0].float() - want[0].float()).abs().cpu().numpy()
    assert np.all(err <= _ulp(terms, dtype)), (label, float(err.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("triple", _TRIPLES, ids=_TRIPLE_IDS)
@pytest.mark.parametrize("need_pair", [True, False])
def test_blend_kernel_at_ragged_widths_and_misaligned_views(triple, need_pair):
    """K2 at widths that are odd, narrower than a row tile or around a run,
    at C = 3 (the unrolled channel loop) and C = 5, with the flow's and the
    mask's addresses on or off their runs' bytes (views one element into
    their storage: value-by-value runs), on smooth, out-of-frame and
    +-200 px block flows, against its plain version; one launch a call."""
    _need_card()
    dtype, flow_dtype, mask_dtype = triple
    rng = np.random.default_rng(17)
    for w, c in itertools.product((1, 2, 3, 7, 13, 33, 67, 131, 256, 257), (3, 5)):
        for kind, layout in itertools.product(("smooth", "out_of_frame", "blocks"),
                                              ("aligned", "flow_offset", "mask_offset")):
            n, h = 2, 7
            a, b = (torch.from_numpy(rng.random((n, c, h, w), np.float32)).cuda().to(dtype)
                    for _ in range(2))
            flow = np.concatenate([_flow(rng, n, h, w, kind), _flow(rng, n, h, w, kind)], 1)
            flow = torch.from_numpy(flow.astype(np.float32)).cuda().to(flow_dtype)
            mask = torch.from_numpy(rng.normal(0, 3, (n, 1, h, w)).astype(np.float32))
            mask = mask.cuda().to(mask_dtype)
            if layout == "flow_offset":
                flow = _offset_view(flow, 1)
            elif layout == "mask_offset":
                mask = _offset_view(mask, 1)
            before = tw.warp2_blend_planes.launches
            with tw.use_fuse_blend(True):
                got = tw.warp2_blend_planes(a, b, flow, mask, need_pair=need_pair)
            assert tw.warp2_blend_planes.launches == before + 1
            want = tw.warp2_blend_planes_ref(a, b, flow, mask, need_pair=True)
            torch.cuda.synchronize()
            got = got if need_pair else (got,)
            assert all(g.dtype == dtype for g in got)
            _assert_blend(got, want, dtype, (w, c, kind, layout))


@pytest.mark.gpu
def test_blend_kernel_refuses_a_plan_that_leaves_pixels_unwritten():
    """The C entry refuses another run size, a grid short of the row or the
    rows, vector runs at an odd width, and only one of w0 and w1
    (cudaErrorInvalidValue, 1); it takes the plan's own."""
    _need_card()
    from rife_tpu_torch.ops.cuda import warp_blend as cb

    n, c, h, w = 1, 3, 4, 9
    x = torch.zeros(n, c, h, w, device="cuda")
    f, m = torch.zeros(n, 4, h, w, device="cuda"), torch.zeros(n, 1, h, w, device="cuda")
    p = cb.k2_plan(x, f, m, (x.data_ptr(),))
    fn = cb.library().warp_blend_f32
    stream = torch.cuda.current_stream().cuda_stream
    out, w0 = torch.empty_like(x), torch.empty_like(x)
    args = lambda o0=None, o1=None: [x.data_ptr(), x.data_ptr(), f.data_ptr(),  # noqa: E731
                                     m.data_ptr(), out.data_ptr(), o0, o1, n, c, h, w, 0, 0]
    plan = {"gx": p["gx"], "gy": p["gy"], "tx": p["tx"], "ty": p["ty"], "ppt": p["ppt"],
            "vec": int(p["vec"])}
    assert (plan["gx"], plan["gy"], plan["vec"]) == (1, 1, 0)  # W = 9 in one tile, odd
    assert fn(*args(), *plan.values(), stream) == 0
    for bad in ({"ppt": p["ppt"] + 1}, {"tx": 1}, {"ty": 1}, {"vec": 1}):
        assert fn(*args(), *{**plan, **bad}.values(), stream) == 1, bad
    assert fn(*args(w0.data_ptr()), *plan.values(), stream) == 1
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_blend_kernel_bf16_past_2_31_output_elements():
    """760 bf16 frame pairs of 3x736x1280 (2.15e9 elements an output, over
    2^31), with w0 and w1: the planes' 64-bit bases, with 32-bit offsets
    within a plane.  The first and last frames bit-equal to K2 on those
    frames alone, and to the plain version there."""
    _need_card()
    n, c, h, w = 760, 3, 736, 1280
    assert n * c * h * w > 2 ** 31
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    a = torch.rand(n, c, h, w, device="cuda", generator=gen, dtype=torch.bfloat16)
    b = torch.rand(n, c, h, w, device="cuda", generator=gen, dtype=torch.bfloat16)
    yy = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    phase = torch.arange(n, device="cuda", dtype=torch.float32).view(n, 1, 1)
    flow = torch.stack([(9 * torch.sin(yy / 40 + phase)).expand(n, h, w),
                        (7 * torch.cos(xx / 60 + phase)).expand(n, h, w),
                        (-6 * torch.cos(yy / 30 - phase)).expand(n, h, w),
                        (5 * torch.sin(xx / 50 - phase)).expand(n, h, w)], 1).bfloat16()
    mask = (3 * torch.sin(xx / 70 + yy / 90 + phase)).unsqueeze(1).bfloat16()
    with tw.use_fuse_blend(True):
        out = tw.warp2_blend_planes(a, b, flow, mask, need_pair=True)
        for i in (0, n - 1):
            sl = lambda t: t[i:i + 1].clone()  # noqa: E731
            one = tw.warp2_blend_planes(sl(a), sl(b), sl(flow), sl(mask), need_pair=True)
            want = tw.warp2_blend_planes_ref(sl(a), sl(b), sl(flow), sl(mask), True)
            torch.cuda.synchronize()
            for o, g in zip(out, one):
                assert torch.equal(o[i:i + 1], g), i
            _assert_blend(one, want, torch.bfloat16, i)
    del a, b, flow, mask, out
    torch.cuda.empty_cache()


# Run in a process of its own: in this file's full run, sessions of the
# profiler opened after the training and large-tensor tests recorded no
# device events (or some of them) on the card's machine.
_BLEND_LAUNCHES = """
import itertools, json
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from rife_tpu_torch.ops import warp as tw

gen = torch.Generator(device="cuda")
gen.manual_seed(18)
out = []
for c, need_pair in itertools.product((3, 5), (True, False)):
    a, b = (torch.rand(2, c, 40, 72, device="cuda", generator=gen) for _ in range(2))
    flow = torch.randn(2, 4, 40, 72, device="cuda", generator=gen) * 4
    mask = torch.randn(2, 1, 40, 72, device="cuda", generator=gen) * 3
    with tw.use_fuse_blend(True):
        tw.warp2_blend_planes(a, b, flow, mask, need_pair=need_pair)
        torch.cuda.synchronize()
        before = tw.warp2_blend_planes.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tw.warp2_blend_planes(a, b, flow, mask, need_pair=need_pair)
            torch.cuda.synchronize()
    out.append({"counted": tw.warp2_blend_planes.launches - before,
                "kernels": [e.name for e in prof.events()
                            if e.device_type == DeviceType.CUDA]})
print(json.dumps(out))
"""


@pytest.mark.gpu
def test_blend_kernel_is_one_cuda_launch_a_call():
    """By the profiler's device events, in a fresh process: one
    warp_blend kernel a call and no other, in both forms, at C = 3 and
    C = 5; the counter moves by one a call."""
    _need_card()
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", _BLEND_LAUNCHES], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    calls = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(calls) == 4
    for call in calls:
        assert call["counted"] == 1, call
        assert len(call["kernels"]) == 1 and "warp_blend_kernel" in call["kernels"][0], call


@pytest.mark.gpu
def test_blend_kernel_gradients_are_the_composed_routes():
    _need_card()
    rng = np.random.default_rng(8)
    n, c, h, w = 2, 3, 24, 40
    x = [rng.random((n, c, h, w), np.float32), rng.random((n, c, h, w), np.float32),
         np.concatenate([_flow(rng, n, h, w, "smooth")] * 2, 1).astype(np.float32),
         rng.normal(0, 2, (n, 1, h, w)).astype(np.float32)]
    g = torch.from_numpy(rng.normal(0, 1, (n, c, h, w)).astype(np.float32)).cuda()
    grads = {}
    for fused in (True, False):
        ts = [torch.from_numpy(v).cuda().requires_grad_(True) for v in x]
        with tw.use_fuse_blend(fused):
            out = tw.warp2_blend_planes(*ts, need_pair=False)
        (out * g).sum().backward()
        grads[fused] = [t.grad for t in ts]
    for f, comp in zip(grads[True], grads[False]):
        torch.testing.assert_close(f, comp, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [0, 1])
def test_v425_engine_goes_through_the_kernels(fast):
    """4 warp launches and 1 final launch per forward (warp_blend when the
    switch is on, a 5th warp when it is off), at rung 0 and 1; the card's
    f32 output against the CPU path."""
    _need_card()
    sd = state_dict_from_jax(load_checkpoint(CKPT_V425)[1])
    rng = np.random.default_rng(1)
    a = rng.random((2, 128, 192, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    ref = InferenceEngine("v4.25", sd, fast=fast, device="cpu").interpolate(a, b, 0.25)
    eng = InferenceEngine("v4.25", sd, fast=fast)
    for fused, k1, k2 in ((True, 4, 1), (False, 5, 0)):
        before, before2 = tw.warp_planes.launches, tw.warp2_blend_planes.launches
        with tw.use_fuse_blend(fused):
            got = eng.interpolate(a, b, 0.25)
        torch.cuda.synchronize()
        assert tw.warp_planes.launches - before == k1
        assert tw.warp2_blend_planes.launches - before2 == k2
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-3)


def _nhwc(rng, n, h, w, c, kind, dtype, flow_dtype, stride=None):
    """An NHWC image (the first C channels of `stride`) and an NHWC flow."""
    base = rng.normal(0, 2, (n, h, w, stride or c)).astype(np.float32)
    img = torch.from_numpy(base).cuda().to(dtype)[..., :c]
    flow = _flow(rng, n, h, w, kind).astype(np.float32).transpose(0, 2, 3, 1)
    return img, torch.from_numpy(np.ascontiguousarray(flow)).cuda().to(flow_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("kind", ["smooth", "out_of_frame", "blocks"])
@pytest.mark.parametrize("c,stride", [(3, 3), (3, 6), (8, 8), (32, 32), (12, 12),
                                      (16, 20)])
def test_nhwc_kernels_match_plain_version_and_k1(dtype, flow_dtype, kind, c, stride):
    """K3 (C < 8) and K4 (C >= 8; 16-byte loads, or channel by channel where
    C or the strides are not multiples of 16 bytes) bit-equal to the plain
    version and to K1 on the permuted planes, contiguous or channel slices."""
    _need_card()
    rng = np.random.default_rng(c + stride)
    img, flow = _nhwc(rng, 3, 37, 131, c, kind, dtype, flow_dtype, stride)
    counter = tw.warp_nhwc_k3 if c < 8 else tw.warp_nhwc_k4
    before = counter.launches
    got = tw.warp(img, flow)
    assert counter.launches == before + 1
    want = tw.warp_ref(img, flow)
    planes = tw.warp_planes(img.permute(0, 3, 1, 2).contiguous(),
                            flow.permute(0, 3, 1, 2).contiguous())
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(got, planes.permute(0, 2, 3, 1))


@pytest.mark.gpu
def test_nhwc_kernels_refuse_what_they_cannot_take():
    _need_card()
    for c in (3, 16):
        img = torch.zeros(2, 8, 8, c, device="cuda")
        flow = torch.zeros(2, 8, 8, 2, device="cuda")
        with pytest.raises(ValueError, match="channel"):  # NCHW memory seen as NHWC
            tw.warp(torch.zeros(2, c, 8, 8, device="cuda").permute(0, 2, 3, 1), flow)
        with pytest.raises(ValueError, match="channel"):
            tw.warp(img, torch.zeros(2, 2, 8, 8, device="cuda").permute(0, 2, 3, 1))
        with pytest.raises(ValueError):
            tw.warp(img, torch.zeros(2, 8, 9, 2, device="cuda"))
        with pytest.raises(TypeError):
            tw.warp(img.half(), flow)
    with pytest.raises(TypeError):  # K1's gradient kernel, under the NHWC backward
        tw.warp_nhwc_bwd(torch.zeros(1, 8, 8, 3, device="cuda").half(),
                         torch.zeros(1, 8, 8, 2, device="cuda"),
                         torch.zeros(1, 8, 8, 3, device="cuda").half())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("kind", ["smooth", "blocks"])
@pytest.mark.parametrize("c,stride", [(3, 3), (3, 6), (32, 32)])
def test_nhwc_gradient_is_one_k1_gradient_launch(dtype, flow_dtype, kind, c, stride):
    """The NHWC warp's backward on the card: one launch of K1's gradient
    kernel on NCHW copies of the permuted planes (contiguous or channel
    slices, as the legacy models pass them), within the gradient kernel's
    bound of the plain version, d_img and d_flow in the NHWC shapes and
    dtypes the forward took; never zeros."""
    _need_card()
    rng = np.random.default_rng(40 + c + stride)
    img, flow = _nhwc(rng, 2, 29, 67, c, kind, dtype, flow_dtype, stride)
    g = torch.from_numpy(rng.normal(0, 1, (2, 29, 67, c)).astype(np.float32)).cuda().to(dtype)
    ti, tf = img.detach().requires_grad_(True), flow.detach().requires_grad_(True)
    before = (tw.warp_planes_bwd.launches, tw.warp_planes.launches)
    tw.warp(ti, tf).backward(g)
    assert (tw.warp_planes_bwd.launches, tw.warp_planes.launches) == (before[0] + 1,
                                                                        before[1])
    assert ti.grad.shape == img.shape and ti.grad.dtype == dtype
    assert tf.grad.shape == flow.shape and tf.grad.dtype == flow_dtype
    assert float(ti.grad.abs().sum()) > 0 and float(tf.grad.abs().sum()) > 0
    planes = [t.permute(0, 3, 1, 2).contiguous() for t in (img, flow, g)]
    _assert_bwd_within_bound(*planes, (ti.grad.permute(0, 3, 1, 2), tf.grad.permute(0, 3, 1, 2)),
                             True)


@pytest.mark.gpu
@pytest.mark.parametrize("model,k3", [("hdv2", 4), ("hd", 8)])
def test_legacy_engine_goes_through_the_nhwc_kernels(model, k3):
    """K3 + 8 K4 launches per forward and nothing else; the card's f32
    output within 2e-4 of the CPU path; a bf16 engine runs."""
    _need_card()
    from rife_tpu_torch.models import get_model_def

    sd = get_model_def(model).init(torch.Generator().manual_seed(0))
    for i in range(4):  # flows of several pixels
        for k in ("weight", "bias"):
            sd[f"block{i}.conv1.{k}"] *= 20.0
    rng = np.random.default_rng(2)
    a = rng.random((2, 128, 192, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    ref = InferenceEngine(model, sd, device="cpu").interpolate(a, b)
    for dtype in (torch.float32, torch.bfloat16):
        eng = InferenceEngine(model, sd, compute_dtype=dtype)
        counters = (tw.warp_nhwc_k3, tw.warp_nhwc_k4, tw.warp_planes, tw.warp2_blend_planes)
        before = [f.launches for f in counters]
        got = eng.interpolate(a, b)
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(counters, before)] == [k3, 8, 0, 0]
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=2e-4)


# K5 at the three convblock shapes of a served rife request, a 12-channel
# tail, an odd channel count (1-channel loads) and a width over one block's
# 256 output channels.
_CHAIN_SHAPES = cc_tool.SERVED + (cc_tool.ODD, ("C = 5", 2, 6, 11, 5),
                                  ("C = 264", 1, 5, 6, 264))


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [1, 8])
@pytest.mark.parametrize("shape", _CHAIN_SHAPES, ids=[s[0] for s in _CHAIN_SHAPES])
def test_conv_chain_kernel_matches_plain_version(shape, stages):
    """1 stage: every element within 1 bf16 ulp of the stage and 1 of the
    residual sum, plus the f32 order term; 8 stages: as close to the
    unrounded f32 chain as the plain version (cc_tool.check_chain).  One
    launch per stage."""
    _need_card()
    name, n, h, w, c = shape
    params = cc.pack_chain(cc_tool.random_convblock(c, stages, seed=stages).to("cuda"))
    x = cc_tool.random_input(n, h, w, c, 0, "cuda")
    before = cc.conv_chain.launches
    cc_tool.check_chain(x, params, name)
    assert cc.conv_chain.launches == before + stages


@pytest.mark.gpu
def test_conv_chain_kernel_on_the_r5_convblocks():
    """The r5 model's three convblocks at their served shapes: 8 stages
    within mean relative 1e-3 of the plain version."""
    _need_card()
    for i, convs in enumerate(cc_tool.r5_convblocks("cuda")):
        name, n, h, w, c = cc_tool.SERVED[i]
        cc_tool.check_chain(cc_tool.random_input(n, h, w, c, i, "cuda"), cc.pack_chain(convs),
                            name, cc_tool.CHAIN_MEAN_REL)


@pytest.mark.gpu
def test_conv_chain_kernel_reads_a_strided_channels_last_input():
    """A channel slice of a wider NHWC tensor and the NHWC view of a
    channels-last NCHW tensor are read in place."""
    _need_card()
    params = cc.pack_chain(cc_tool.random_convblock(16, 2, seed=3).to("cuda"))
    wide = cc_tool.random_input(2, 9, 13, 40, 1, "cuda")
    cc_tool.check_chain(wide[..., 6:22], params, "channel slice")
    cl = wide[..., :16].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    cc_tool.check_chain(cl.permute(0, 2, 3, 1), params, "channels-last view")


@pytest.mark.gpu
def test_conv_chain_kernel_refuses_what_it_cannot_take():
    _need_card()
    params = cc.pack_chain(cc_tool.random_convblock(16, 2, seed=3).to("cuda"))
    x = cc_tool.random_input(1, 5, 7, 16, 1, "cuda")
    before = cc.conv_chain.launches
    with pytest.raises(TypeError):
        cc.conv_chain(x.float(), *params)
    with pytest.raises(ValueError):
        cc.conv_chain(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), *params)
    assert cc.conv_chain.launches == before


# K5's building blocks on the card, in the order they were brought up: one
# (tap, chunk) product through TMA and wgmma, one stage on flat row counts
# that are not a multiple of the 128-row tile, the chain on a strided input.
_PRODUCTS = [(16, 16, 0, 0, 0, 0), (96, 96, -11, 0, 64, 1), (152, 152, 40, 0, 128, 2),
             (240, 240, -83, 0, 192, 1), (128, 264, 5, 128, 256, 2), (240, 240, 50, 0, 0, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("bn,c8,m0,n0,c0,dr", _PRODUCTS,
                         ids=[f"n{p[0]}-c{p[1]}-m{p[2]}-k{p[4]}-r{p[5]}" for p in _PRODUCTS])
def test_conv_chain_tile_product_matches_matmul(bn, c8, m0, n0, c0, dr):
    """One A box (136 rows at m0, which may start above the first row or
    run past the last) and one B box (bn rows at n0) of 64 channels at c0,
    multiplied by the kernel's wgmma from dr rows into the A box (a tap's
    shift within its kernel row), against torch.matmul in f32 on the same
    bf16 values with the rows and channels outside taken as 0; within the
    f32 summation-order term of 64 exact products.  Rows are the kernel's
    128-byte stride apart; the channels from c8 to the next multiple of 16
    are zero and those past it NaN, which the products must not read."""
    _need_card()
    gen = torch.Generator().manual_seed(bn + c8)
    ld, c16 = -(-c8 // 64) * 64, -(-c8 // 16) * 16
    a = torch.full((180, ld), float("nan"))
    b = torch.full((n0 + bn + 3, ld), float("nan"))
    a[:, :c16] = b[:, :c16] = 0
    a[:, :c8] = torch.randn(180, c8, generator=gen)
    b[:, :c8] = torch.randn(b.shape[0], c8, generator=gen)
    a, b = a.to("cuda", torch.bfloat16), b.to("cuda", torch.bfloat16)
    got = cc_cuda.tile_product(a, b, c8, bn, m0, n0, c0, dr)
    torch.cuda.synchronize()
    rows = torch.arange(m0 + dr, m0 + dr + 128, device="cuda")
    ok = (rows >= 0) & (rows < a.shape[0])
    a_box = torch.where(ok[:, None], a[rows.clamp(0, a.shape[0] - 1)], 0).float()
    a_box, b_box = a_box[:, c0:min(c0 + 64, c8)], b[n0:n0 + bn, c0:min(c0 + 64, c8)].float()
    want = a_box @ b_box.t()
    tol = 1e-5 * (a_box.abs() @ b_box.abs().t()) + 1e-30
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


_RAGGED = [("C = 12", 1, 7, 9, 12), ("C = 16", 2, 13, 17, 16), ("C = 90", 1, 21, 30, 90),
           ("C = 150", 3, 9, 14, 150), ("C = 240", 2, 11, 25, 240)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _RAGGED, ids=[s[0] for s in _RAGGED])
def test_conv_chain_one_stage_on_ragged_flat_rows(shape):
    """One stage at each kernel width on shapes whose flat row count
    N (H+2) (W+2) is not a multiple of 128 (the last tile is ragged):
    within 1 bf16 ulp of the plain version plus the f32 order term."""
    _need_card()
    name, n, h, w, c = shape
    assert cc.geometry(n, h, w, c).rows % 128
    params = cc.pack_chain(cc_tool.random_convblock(c, 1, seed=c).to("cuda"))
    cc_tool.check_chain(cc_tool.random_input(n, h, w, c, 2, "cuda"), params, name)


@pytest.mark.gpu
def test_conv_chain_eight_stages_on_a_strided_channels_last_input():
    """8 stages on the NHWC view of a channels-last NCHW tensor with a
    channel stride of 1 and padded n/y strides (a channel slice of a
    wider one): as close to the f32 chain as the plain version."""
    _need_card()
    params = cc.pack_chain(cc_tool.random_convblock(90, 8, seed=4).to("cuda"))
    wide = cc_tool.random_input(2, 19, 23, 100, 3, "cuda").permute(0, 3, 1, 2)
    cl = wide.contiguous(memory_format=torch.channels_last)[:, 4:94].permute(0, 2, 3, 1)
    assert cl.stride(3) == 1 and not cl.is_contiguous()
    cc_tool.check_chain(cl, params, "strided channels-last, 8 stages")


@pytest.mark.gpu
def test_conv_chain_profiled_build_computes_the_same_stage():
    """The --profile tool's build (clock64 marks) writes the same stage as
    the served build, bit for bit, and counts every tile once."""
    _need_card()
    n, h, w, c = 2, 23, 31, 90
    g = cc.geometry(n, h, w, c, cc_cuda.sm_count(0))
    kw, kb, ka = cc.kernel_params(*cc.pack_chain(cc_tool.random_convblock(c, 2, seed=5)
                                                 .to("cuda")), g)
    xin = cc.to_flat(cc_tool.random_input(n, h, w, c, 5, "cuda"), g.ld)
    served, profiled = torch.zeros_like(xin), torch.zeros_like(xin)
    prof = torch.zeros((g.grid, cc_cuda.PROF_FIELDS), dtype=torch.int64, device="cuda")
    cc_cuda.launch_stage(xin, served, xin, kw, kb, ka, g, 0, False)
    cc_cuda.launch_stage(xin, profiled, xin, kw, kb, ka, g, 0, False, prof)
    torch.cuda.synchronize()
    assert torch.equal(served, profiled)
    assert int(prof[:, 6].sum()) == g.tiles and bool((prof[:, 4] > 0).all())


@pytest.mark.gpu
def test_conv_chain_launches_once_per_stage():
    _need_card()
    x = cc_tool.random_input(1, 7, 9, 12, 0, "cuda")
    for stages in (1, 2, 8):
        params = cc.pack_chain(cc_tool.random_convblock(12, stages, seed=stages).to("cuda"))
        before = cc.conv_chain.launches
        cc.conv_chain(x, *params)
        torch.cuda.synchronize()
        assert cc.conv_chain.launches == before + stages
    before = cc.conv_chain.launches
    cc.conv_chain(x.cpu(), *(t.cpu() for t in params))
    assert cc.conv_chain.launches == before


# K6-K8, the gather probes (ops/gather_probe.py), at the TPU experiments'
# sizes; the checks are the probe tool's, which raise on a failure.
_PROBE_SECTIONS = {"exp1": (1, 128, (gp_tool.EXP1_R, 1)),
                   "exp2": (2, 127, (gp_tool.EXP2_OUTER, gp_tool.EXP2_UNROLL))}


@pytest.mark.gpu
@pytest.mark.parametrize("section", sorted(_PROBE_SECTIONS))
def test_probe_micro_kernel_matches_plain_version(section):
    """The recurrence for each body of r3_exp1.py (R = 4000) or r3_exp2.py
    (40000 x 32) bit-equal to its plain version (run on the host in worker
    processes, stopping exactly at the fixed point), at R = 4000 in both
    forms (the tile in shared memory, and in one warp's registers); the chaotic
    unpack bodies bit-equal over 4 steps, and over 4000 bodies their
    differing elements counted.  One launch per body and form."""
    _need_card()
    seed, idx_hi, steps = _PROBE_SECTIONS[section]
    arrays = gp_tool.micro_inputs(seed, idx_hi)
    chaotic_outer = 4000 // steps[1]
    with gp_tool.plain_pool() as pool:
        plain = gp_tool.submit_section(pool, section, arrays, steps, chaotic_outer)
        x = tuple(torch.from_numpy(a).cuda() for a in arrays)
        bodies = gp.EXP1_BODIES if section == "exp1" else gp.EXP2_BODIES
        before = gp.micro.launches
        forms = gp.FORMS if steps[1] == 1 else ("block",)  # the warp form: unroll 1
        outs = {(b, f): gp.micro(*x, b, *steps, f) for b in bodies for f in forms}
        assert gp.micro.launches == before + len(bodies) * len(forms)
        recs = gp_tool.check_micro(section, outs, arrays, steps, plain, chaotic_outer)
    assert all(r.get("differ_after_4_steps", r["differ"]) == 0 for r in recs)


@pytest.mark.gpu
@pytest.mark.parametrize("body", gp.BODIES)
def test_probe_micro_block_form_matches_warp_form_and_plain_version(body):
    """The block form (a block per row, column group or element group) bit-
    equal to the warp form and to the plain version over 300 steps (NaN
    payloads not compared: the card's NaN is canonical), and at unroll 32
    to itself at unroll 1 over 32 x 10 steps; with
    indices out of range (lane -1, 128, 200; sublane -1, 8) bit-equal to
    the warp form, NaN where a step gathers one (the plain version raises
    there)."""
    _need_card()
    arrays = gp_tool.micro_inputs(21, 128)
    x = tuple(torch.from_numpy(a).cuda() for a in arrays)
    block = gp.micro(*x, body, 300, 1, "block")
    warp = gp.micro(*x, body, 300, 1, "warp")
    plain = gp.micro_ref(*(torch.from_numpy(a) for a in arrays), body, 300)
    assert gp_tool.differing(block, warp.cpu()) == 0
    assert gp_tool.differing(block, plain) == 0
    assert gp_tool.differing(gp.micro(*x, body, 10, 32, "block"),
                             gp.micro(*x, body, 320, 1, "block").cpu()) == 0
    xv, idx, idx0, w = (a.copy() for a in arrays)
    idx[0, :3], idx[3, 5], idx[7, 127] = (-1, 128, 200), 128, -1
    idx0[1, 4], idx0[6, :2] = 8, (-1, 8)
    bad = tuple(torch.from_numpy(a).cuda() for a in (xv, idx, idx0, w))
    got_block = gp.micro(*bad, body, 50, 1, "block")
    got_warp = gp.micro(*bad, body, 50, 1, "warp")
    torch.cuda.synchronize()
    assert gp_tool.differing(got_block, got_warp.cpu()) == 0
    if body in ("lane", "lane2", "v4row", "v5row", "sublane"):
        assert bool(torch.isnan(got_block).any())


@pytest.mark.gpu
def test_probe_copies_gathers_and_cb1_warp_at_the_scripts_sizes():
    """select_rows (64x256 and a 181 MB stack), the three tile gathers (512
    and 32768 tiles) equal to their plain versions and to index_select /
    torch.gather; 10 chained cb = 1 warps of the 4x736x1280x3 bf16 image
    bit-equal to K3's and to the plain chain, and one on a +-200 px block
    flow; r3_exp2.py's five warp shapes through K3/K4 and through K1 bit-
    equal, 20 chained each."""
    _need_card()
    e1, e2, e21 = (gp_tool.exp1_inputs("cuda"), gp_tool.exp2_inputs("cuda"),
                   gp_tool.exp21_inputs("cuda"))
    outs = {"sel_small": gp.select_rows(*e1["sel_small"], gp_tool.SEL_ROWS),
            "sel_big": gp.select_rows(*e1["sel_big"], gp_tool.SEL_ROWS),
            "cb1_chain": gp_tool.chained(gp.warp_nhwc_cb1, e1["img"], e1["flow"], 10),
            "k3_chain": gp_tool.chained(tw.warp_nhwc_k3, e1["img"], e1["flow"], 10),
            "exp2_warps": [(gp_tool.chained(gp_tool.current_warp, img, fl, 20),
                            gp_tool.chained(gp_tool.planes_route, img, fl, 20))
                           for _, img, fl in e2["cases"]],
            "tiles": {(nt, k): gp.tile_gather(x, il if k == "lane" else is_, k)
                      for nt, (x, il, is_) in e21.items() for k in gp.GATHER_KINDS}}
    gp_tool.check_exp1(e1, outs)
    gp_tool.check_exp2_warps(e2, outs)
    gp_tool.check_exp21(e21, outs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("kind", ["smooth", "out_of_frame", "blocks"])
@pytest.mark.parametrize("c,stride", [(1, 1), (3, 3), (3, 6), (5, 5), (16, 20)])
def test_probe_cb1_warp_is_k3_bit_for_bit(dtype, flow_dtype, kind, c, stride):
    """The cb = 1 warp (one thread per pixel and channel) bit-equal to K3
    and to the plain version, contiguous or a channel slice."""
    _need_card()
    rng = np.random.default_rng(10 * c + stride)
    img, flow = _nhwc(rng, 2, 37, 131, c, kind, dtype, flow_dtype, stride)
    before = gp.warp_nhwc_cb1.launches
    got = gp.warp_nhwc_cb1(img, flow)
    assert gp.warp_nhwc_cb1.launches == before + 1
    k3 = tw.warp_nhwc_k3(img, flow)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, k3)
    assert torch.equal(got, tw.warp_ref(img, flow))


def _misaligned(rng, n, h, w, c, kind, dtype, flow_dtype, layout):
    """An NHWC image and flow whose addresses or strides rule out the vector
    paths: "flow_slice", the flow a 2-channel slice of a 3-channel tensor
    (pixel stride 3, one scalar load per value); "image_offset", the image
    a view one element past its storage's start."""
    flow = np.ascontiguousarray(_flow(rng, n, h, w, kind).astype(np.float32).transpose(0, 2, 3, 1))
    flow = torch.from_numpy(flow).cuda().to(flow_dtype)
    img = torch.from_numpy(rng.normal(0, 2, (n, h, w, c)).astype(np.float32)).cuda().to(dtype)
    if layout == "flow_slice":
        flow = torch.cat([flow, torch.zeros_like(flow[..., :1])], -1)[..., :2]
    else:
        buf = torch.empty(img.numel() + 1, dtype=dtype, device="cuda")
        buf[1:] = img.reshape(-1)
        img = buf[1:].view(n, h, w, c)
    return img, flow


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,flow_dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("layout", ["flow_slice", "image_offset"])
def test_k3_and_cb1_at_ragged_widths_and_misaligned_views(dtype, flow_dtype, layout):
    """K3 and the cb = 1 warp bit-equal to the plain version, to K1 on the
    permuted planes and to each other at widths around their 128- and
    256-pixel tiles (a ragged last tile, 16-byte stores or element stores
    by width), on smooth, out-of-frame and +-200 px block flows, with the
    flow read value by value or the image off its storage's alignment."""
    _need_card()
    rng = np.random.default_rng(len(layout))
    for w in (1, 2, 127, 128, 129, 255, 256, 257, 520):
        for kind in ("smooth", "out_of_frame", "blocks"):
            img, flow = _misaligned(rng, 2, 9, w, 3, kind, dtype, flow_dtype, layout)
            k3 = tw.warp_nhwc_k3(img, flow)
            cb1 = gp.warp_nhwc_cb1(img, flow)
            want = tw.warp_ref(img, flow)
            planes = tw.warp_planes(img.permute(0, 3, 1, 2).contiguous(),
                                    flow.permute(0, 3, 1, 2).contiguous())
            torch.cuda.synchronize()
            assert k3.dtype == dtype and k3.is_contiguous() and cb1.is_contiguous()
            assert torch.equal(k3, want), (w, kind)
            assert torch.equal(cb1, want), (w, kind)
            assert torch.equal(k3, planes.permute(0, 2, 3, 1)), (w, kind)


@pytest.mark.gpu
def test_k3_bf16_past_2_31_output_elements():
    """760 bf16 frames of 736x1280x3 (2.15e9 elements, over 2^31): the
    images' and rows' 64-bit bases, with 32-bit offsets within a row.  The
    first and last frames bit-equal to K3 and the plain version on those
    frames alone."""
    _need_card()
    n, h, w = 760, 736, 1280
    assert n * h * w * 3 > 2 ** 31
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    img = torch.rand(n, h, w, 3, device="cuda", generator=gen, dtype=torch.bfloat16)
    yy = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    phase = torch.arange(n, device="cuda", dtype=torch.float32).view(n, 1, 1)
    flow = torch.stack([(9 * torch.sin(yy / 40 + phase)).expand(n, h, w),
                        (7 * torch.cos(xx / 60 + phase)).expand(n, h, w)], -1).bfloat16()
    out = tw.warp_nhwc_k3(img, flow)
    for i in (0, n - 1):
        one = tw.warp_nhwc_k3(img[i:i + 1].clone(), flow[i:i + 1].clone())
        want = tw.warp_ref(img[i:i + 1], flow[i:i + 1])
        torch.cuda.synchronize()
        assert torch.equal(out[i:i + 1], one) and torch.equal(one, want), i


@pytest.mark.gpu
def test_k3_and_cb1_launch_once_per_call():
    _need_card()
    img = torch.rand(2, 16, 300, 3, device="cuda")
    flow = torch.randn(2, 16, 300, 2, device="cuda") * 4
    for fn, counter in ((tw.warp_nhwc_k3, tw.warp_nhwc_k3), (tw.warp, tw.warp_nhwc_k3),
                        (gp.warp_nhwc_cb1, gp.warp_nhwc_cb1)):
        before = (tw.warp_nhwc_k3.launches, tw.warp_nhwc_k4.launches,
                  gp.warp_nhwc_cb1.launches, tw.warp_planes.launches)
        fn(img, flow)
        after = (tw.warp_nhwc_k3.launches, tw.warp_nhwc_k4.launches,
                 gp.warp_nhwc_cb1.launches, tw.warp_planes.launches)
        assert [a - b for a, b in zip(after, before)] == [
            int(counter is tw.warp_nhwc_k3), 0, int(counter is gp.warp_nhwc_cb1), 0]


@pytest.mark.gpu
def test_probe_kernels_refuse_what_they_cannot_take():
    _need_card()
    x, idx, idx0, w = (torch.from_numpy(a).cuda() for a in gp_tool.micro_inputs(0, 128))
    counts = (gp.micro.launches, gp.select_rows.launches, gp.tile_gather.launches,
              gp.warp_nhwc_cb1.launches)
    with pytest.raises(ValueError):
        gp.micro(x, idx, idx0, w, "base", 4, unroll=4)  # built for unroll 1 and 32
    with pytest.raises(ValueError):
        gp.micro(x, idx, idx0, w, "base", 4, unroll=32, form="warp")  # built for unroll 1
    with pytest.raises(ValueError):
        gp.micro(x.t().contiguous().t(), idx, idx0, w, "base", 4)
    with pytest.raises(ValueError):
        gp.select_rows(torch.zeros(16, 3, device="cuda"), torch.zeros(1, dtype=torch.int32,
                                                                      device="cuda"), 2)
    t = torch.zeros(2, 128, 8, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError):
        gp.tile_gather(t, torch.zeros(2, 8, 128, dtype=torch.int32, device="cuda"), "lane")
    img = torch.zeros(1, 3, 4, 5, device="cuda").permute(0, 2, 3, 1)  # channel stride 20
    with pytest.raises(ValueError):
        gp.warp_nhwc_cb1(img, torch.zeros(1, 4, 5, 2, device="cuda"))
    assert counts == (gp.micro.launches, gp.select_rows.launches, gp.tile_gather.launches,
                      gp.warp_nhwc_cb1.launches)


# K1 launches and the K2 form per `rife` forward at each rung
# (tests/test_torch_ladder.py counts the same on both packages on the CPU).
_LADDER = {0: (6, True), 1: (6, True), 2: (7, False), 3: (7, False), 4: (2, False)}


@pytest.fixture(scope="module")
def r5_sd():
    _need_card()
    return state_dict_from_jax(load_checkpoint(CKPT)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("rung", sorted(_LADDER))
def test_each_rung_launches_what_the_ladder_says(r5_sd, rung):
    """K1 and K2 launches per forward by the wrappers' counters (K2 in its
    blend-only form from rung 2 on, a K1 launch instead with the switch
    off), twice that with TTA; the f32 output against the CPU path."""
    _need_card()
    rng = np.random.default_rng(2)
    a = rng.random((2, 128, 192, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    k1, pair = _LADDER[rung]
    eng = InferenceEngine("rife", r5_sd, fast=rung)
    forms = []
    launch = tw._cuda_blend.launch

    def recorded(*args):
        forms.append(args[4])
        return launch(*args)

    tw._cuda_blend.launch = recorded
    try:
        for fused, tta in ((True, False), (True, True), (False, False)):
            before, before2 = tw.warp_planes.launches, tw.warp2_blend_planes.launches
            forms.clear()
            with tw.use_fuse_blend(fused):
                got = eng.interpolate(a, b, tta=tta)
            torch.cuda.synchronize()
            times = 2 if tta else 1
            assert tw.warp_planes.launches - before == times * (k1 + (0 if fused else 1))
            assert tw.warp2_blend_planes.launches - before2 == (times if fused else 0)
            assert forms == ([pair] * times if fused else [])
    finally:
        tw._cuda_blend.launch = launch
    ref = InferenceEngine("rife", r5_sd, fast=rung, device="cpu").interpolate(a, b)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_blend_only_launch_inside_a_rung2_forward_matches_plain_version(r5_sd):
    """The K2 launch a rung-2 bf16 forward makes (blend only, at the
    forward's own flow and mask) against its plain version on the same
    inputs: within one bf16 ulp of the blend's terms."""
    _need_card()
    rng = np.random.default_rng(3)
    a = rng.random((2, 128, 192, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    seen = []
    launch = tw._cuda_blend.launch

    def recorded(*args):
        out = launch(*args)
        seen.append(([t.clone() for t in args[:4]], args[4], out))
        return out

    tw._cuda_blend.launch = recorded
    try:
        InferenceEngine("rife", r5_sd, compute_dtype=torch.bfloat16, fast=2).interpolate(a, b)
    finally:
        tw._cuda_blend.launch = launch
    torch.cuda.synchronize()
    (x, need_pair, got), = seen
    assert not need_pair and got.dtype == torch.bfloat16
    blend, w0, w1 = tw.warp2_blend_planes_ref(*x, True)
    terms = torch.maximum(w0.float().abs(), w1.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(terms.clamp_min(2.0 ** -126))) - 7)
    assert bool(((got.float() - blend.float()).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tta_is_the_mean_of_the_two_flipped_forwards(r5_sd, dtype):
    """Bit for bit, with cuDNN held to its deterministic algorithms: with
    the default ones two f32 runs of one forward can differ by ~5e-6 on
    the card (split sums in another order)."""
    _need_card()
    rng = np.random.default_rng(4)
    a = rng.random((2, 128, 192, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    eng = InferenceEngine("rife", r5_sd, compute_dtype=dtype, fast=1)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = eng.interpolate(a, b, tta=True)
        one = eng.interpolate(a, b)
        flipped = eng.interpolate(np.ascontiguousarray(a[:, ::-1, ::-1]),
                                  np.ascontiguousarray(b[:, ::-1, ::-1]))
    finally:
        torch.backends.cudnn.deterministic = saved
    assert got.dtype == dtype
    torch.testing.assert_close(got, (one + torch.flip(flipped, (1, 2))) / 2, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ssim_matlab", "ssim", "msssim"])
def test_ssim_on_the_card_matches_the_cpu(name):
    from rife_tpu_torch.ops import ssim as ss

    _need_card()
    rng = np.random.default_rng(5)
    x = rng.random((2, 96, 128, 3), dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    fn = getattr(ss, name)
    want = float(fn(torch.from_numpy(x), torch.from_numpy(y)))
    got = float(fn(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()))
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.gpu
def test_scale_two_engine_at_full_width_runs():
    """scale=2 (scale list (2, 1, 0.5): the last level works at 1472x2560)
    on a 736x1280 pair: finite frames in [0, 1], 6 K1 + 1 K2."""
    _need_card()
    rng = np.random.default_rng(6)
    a = rng.random((1, 736, 1280, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    eng = InferenceEngine("rife", seed=0, compute_dtype=torch.bfloat16, fast=1, scale=2.0)
    assert eng.scale_list == (2.0, 1.0, 0.5)
    before, before2 = tw.warp_planes.launches, tw.warp2_blend_planes.launches
    out = eng.interpolate(a, b)
    torch.cuda.synchronize()
    assert out.shape == (1, 736, 1280, 3) and bool(torch.isfinite(out).all())
    assert 0 <= float(out.min()) and float(out.max()) <= 1
    assert (tw.warp_planes.launches - before, tw.warp2_blend_planes.launches - before2) == (6, 1)


def _video_clip(n=9, h=64, w=96, pan=2, seed=7):
    """u8 frames of smooth content panned `pan` px a frame, an exact
    duplicate after the middle one and the last inverted (1 static pair,
    1 scene cut)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h + 32, w + 32 + n * pan, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, 2, 0) + np.roll(base, 2, 1)) / 5
    u8 = (np.clip(base, 0, 1) * 255 + 0.5).astype(np.uint8)
    clip = [np.ascontiguousarray(u8[16:16 + h, 16 + i * pan:16 + i * pan + w])
            for i in range(n - 1)]
    mid = len(clip) // 2
    clip = clip[:mid + 1] + [clip[mid].copy()] + clip[mid + 1:]
    clip[-1] = 255 - clip[-1]
    return clip


class _Frames:
    def __init__(self, frames):
        self.frames, self.fps = frames, 25.0
        self.height, self.width = frames[0].shape[:2]

    def __iter__(self):
        return iter(self.frames)


class _Written(list):
    def write(self, f):
        self.append(f)

    def close(self):
        pass


@pytest.mark.gpu
@pytest.mark.parametrize("exp", [1, 2])
def test_video_pipeline_on_the_card_matches_the_cpu_path(r5_sd, exp):
    """interpolate_video through the kernels (6 K1 + 1 K2 a forward)
    against the port's CPU path at 64x96 f32: stats equal, frames within
    1 LSB and at least 99.9% equal."""
    from rife_tpu_torch.video import VideoJob, interpolate_video

    _need_card()
    clip = _video_clip()
    runs = {}
    for where in ("cpu", None):
        eng = InferenceEngine("rife", r5_sd, fast=1, device=where)
        out = _Written()
        before, before2 = tw.warp_planes.launches, tw.warp2_blend_planes.launches
        stats = interpolate_video(eng, _Frames(clip), out, VideoJob(exp=exp))
        torch.cuda.synchronize()
        runs[where] = (stats, out, tw.warp_planes.launches - before,
                       tw.warp2_blend_planes.launches - before2)
    (cstats, cframes, ck1, ck2), (stats, frames, k1, k2) = runs["cpu"], runs[None]
    for k in ("frames_in", "frames_out", "static", "scene_cut"):
        assert stats[k] == cstats[k], k
    assert (stats["static"], stats["scene_cut"]) == (1, 1)
    assert (ck1, ck2) == (0, 0)  # the CPU path launches nothing
    forwards = 3 if exp == 1 else 3 * 7 + 1  # 2X: 7 gaps in batches of 4 + the static pair
    assert (k1, k2) == (6 * forwards, forwards)
    d = np.abs(np.stack(frames).astype(int) - np.stack(cframes).astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_video_prep_and_post_on_the_card_are_the_cpus(dtype):
    from rife_tpu_torch.ops.pad import plan_pad_to_multiple
    from rife_tpu_torch.video import pipeline as pl

    _need_card()
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, -1)
    pad = plan_pad_to_multiple(16, 16, 32)
    on_card, on_cpu = pl.prep(u8, pad, dtype, "cuda"), pl.prep(u8, pad, dtype, "cpu")
    assert on_card.is_cuda and on_card.dtype == dtype
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=0)
    np.testing.assert_array_equal(pl.post(on_card, pad), pl.post(on_cpu, pad))
    x = torch.rand((2, 40, 48, 3), generator=torch.Generator().manual_seed(1)) * 1.4 - 0.2
    np.testing.assert_array_equal(pl.post(x.to("cuda", dtype), pad),
                                  pl.post(x.to(dtype), pad))


@pytest.mark.gpu
def test_native_frame_ops_on_the_cards_machine():
    """The card's machine has g++ (nvcc needs it): the binding builds and
    agrees with its numpy versions."""
    from rife_tpu_torch import native

    _need_card()
    assert native.have_native()
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (72, 128, 3), dtype=np.uint8)
    got, want = native.u8_to_f32_pad(u8, 96, 128), native.u8_to_f32_pad_ref(u8, 96, 128)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
    f = (rng.standard_normal((72, 128, 3)) * 0.6 + 0.5).astype(np.float32)
    np.testing.assert_array_equal(native.f32_to_u8_crop(f, 64, 100),
                                  native.f32_to_u8_crop_ref(f, 64, 100))
    y = rng.integers(0, 256, (72, 128), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (36, 64), dtype=np.uint8) for _ in range(2))
    np.testing.assert_array_equal(native.yuv420_to_rgb(y, u, v),
                                  native.yuv420_to_rgb_ref(y, u, v))


@pytest.mark.gpu
def test_pkl_engine_equals_the_rtpu_engine_on_the_card(tmp_path):
    from rife_tpu_torch.models.torch_export import export_ifnet, save_torch_pickle

    _need_card()
    name, tree = load_checkpoint(CKPT)
    path = str(tmp_path / "flownet.pkl")
    save_torch_pickle(path, export_ifnet(tree))
    pname, ptree = load_checkpoint(path)
    assert pname == "rife"
    rng = np.random.default_rng(3)
    a = rng.random((2, 128, 192, 3), np.float32)
    b = np.roll(a, (3, 5), (1, 2))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = [InferenceEngine(pname, state_dict_from_jax(t), compute_dtype=torch.bfloat16,
                                fast=1).interpolate(a, b) for t in (tree, ptree)]
    finally:
        torch.backends.cudnn.deterministic = saved
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.gpu
def test_app_pair_request_on_the_card(tmp_path):
    """The serving app's pair request (r5, bf16, rung 1) at passes 2 on a
    720x1280 pair: 3 batch-1 forwards at 736x1280, so 18 K1 + 3 K2
    launches; the frames handed to the encoder equal `exp_doubling` on the
    same engine (cuDNN deterministic), cropped back to 720x1280."""
    _need_card()
    import contextlib
    import io

    from rife_tpu_torch.engine import exp_doubling
    from rife_tpu_torch.ops import pad_centered
    from rife_tpu_torch.serve import app, services

    with contextlib.redirect_stdout(io.StringIO()):
        eng = app.load_engine(os.path.dirname(CKPT))
    assert eng.device.type == "cuda" and eng.model_name == "rife"
    rng = np.random.default_rng(0)
    base = rng.random((760, 1330, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    a, b = base[:720, :1280], base[16:736, 24:1304]
    seen = []
    real = services._encode_frames
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        services._encode_frames = lambda f, o, fps: (seen.append(f), real(f, o, fps))
        eng.warmup((1, 736, 1280, 3))
        k1, k2 = tw.warp_planes.launches, tw.warp2_blend_planes.launches
        r = services.interpolate_pair_to_video(eng, a, b, str(tmp_path / "p.mp4"), passes=2)
        torch.cuda.synchronize()
        assert (tw.warp_planes.launches - k1, tw.warp2_blend_planes.launches - k2) == (18, 3)
        pa, pad = pad_centered(torch.from_numpy(a[None]).cuda(), 32, 512)
        pb, _ = pad_centered(torch.from_numpy(b[None]).cuda(), 32, 512)
        want = [pad.crop(f)[0].float().cpu().numpy() for f in exp_doubling(eng, [pa, pb], 2)]
    finally:
        services._encode_frames = real
        torch.backends.cudnn.deterministic = saved
    assert r["frames"] == 5 and tuple(pa.shape) == (1, 736, 1280, 3)
    assert len(seen[0]) == 5
    for got, w in zip(seen[0], want):
        assert got.shape == (720, 1280, 3)
        np.testing.assert_array_equal(got, w)


@pytest.mark.gpu
def test_testtime_times_the_forwards_not_the_queue(monkeypatch, capsys):
    """`benchmarks testtime` synchronises the card before and after its
    timed loop: its seconds/frame is at least the forwards' device time
    by CUDA events."""
    _need_card()
    from rife_tpu_torch.cli import benchmarks

    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: (syncs.append(d), real(d)))
    benchmarks.main(["testtime", "--warmup", "3", "--iters", "5", "--dtype", "bfloat16",
                     "--modelDir", os.path.dirname(CKPT)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["benchmark"] == "testtime" and len(syncs) >= 2
    eng = benchmarks._engine(benchmarks.argparse.Namespace(
        modelDir=os.path.dirname(CKPT), model=None, scale=1.0, dtype="bfloat16", fast=0,
        device=None))
    z = torch.zeros((1, 480, 640, 3), dtype=torch.bfloat16, device="cuda")
    eng.interpolate(z, z)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        eng.interpolate(z, z)
    end.record()
    end.synchronize()
    assert rec["seconds_per_frame"] * 1e3 >= 0.9 * start.elapsed_time(end) / 5
