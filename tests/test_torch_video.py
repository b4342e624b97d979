"""The port's streaming video pipeline (rife_tpu_torch.video) against
rife_tpu's on the CPU: prep and post over every u8 value, the host
probes, and `interpolate_video` on shared f32 weights at 48x64 (padded to
64x64) with 2X batching, the midpoint tree, a montage, static pairs, a
scene cut and rife_m's timestep schedule.

Frames within 1 LSB, at least 99.9% of them equal; stats equal exactly.
The clips' pairs sit far from the 0.996 / 0.2 gates (moving pairs at
0.59-0.74, an exact duplicate at 1.0, the cut at -0.31)."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.engine.inference import InferenceEngine as JaxEngine
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu.video import VideoJob as JaxVideoJob
from rife_tpu.video import interpolate_video as jax_interpolate_video
from rife_tpu.video import pipeline as ref_pl
from rife_tpu.video import probe as ref_probe
from rife_tpu_torch.engine import InferenceEngine, state_dict_from_jax
from rife_tpu_torch.ops.pad import plan_pad_to_multiple
from rife_tpu_torch.video import VideoJob, interpolate_video
from rife_tpu_torch.video import pipeline as pl
from rife_tpu_torch.video import probe

from test_torch_ladder import _r5, random_tree


class ListReader:
    def __init__(self, frames, fps=10.0):
        self.frames = frames
        self.fps = fps
        self.height, self.width = frames[0].shape[:2]
        self.frame_count = len(frames)

    def __iter__(self):
        return iter(self.frames)


class ListWriter:
    def __init__(self):
        self.frames = []

    def write(self, f):
        self.frames.append(f)

    def close(self):
        pass


def smooth_clip(n, h=48, w=64, shift=2, seed=0):
    """Textured smooth content panned by `shift` px a frame (the recipe of
    bench.py's smooth_pair), float32 HWC in [0, 1]."""
    rng = np.random.default_rng(seed)
    m = 16
    base = rng.random((h + 2 * m, w + n * shift + 2 * m, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, 2, 0) + np.roll(base, 2, 1)) / 5
    return [np.ascontiguousarray(base[m:m + h, m + i * shift:m + i * shift + w])
            for i in range(n)]


def to_u8(frames):
    return [(np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8) for f in frames]


def cut_clip(n=9):
    """`n` panned frames with an exact duplicate inserted after the middle
    one, then a cut to the inverted content panned on: 1 static pair, 1
    scene cut (64x64, so no zero padding pulls the cut's SSIM up)."""
    a = smooth_clip(n, h=64)
    m = n // 2 - 1
    cut = max(m + 2, n - 3)
    return (a[:m + 1] + [a[m].copy()] + a[m + 1:cut]
            + [np.ascontiguousarray(1.0 - f) for f in a[cut:]])


# ---------------------------------------------------------------- prep, post

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prep_then_post_over_every_u8_value(dtype):
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, -1)
    u8[..., 1] = u8[..., 0][::-1]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_prep, p0 = ref_pl._prep_graph(u8.shape, 32, jdt)
    want = ref_prep(jnp.asarray(u8))
    pad = plan_pad_to_multiple(16, 16, 32)
    got = pl.prep(u8, pad, tdt, "cpu")
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    back = pl.post(got, pad)
    ref_back = np.asarray(ref_pl._post_graph(want.shape, p0)(want))
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, ref_back)
    if dtype == "float32":
        np.testing.assert_array_equal(back[0], u8)  # f32 returns every level


def test_post_of_model_like_frames_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 0.4, (2, 40, 48, 3)).astype(np.float32)
    x.reshape(-1)[:2048] = (np.arange(2048) % 256 + 0.5) / np.float32(255.0)
    p = plan_pad_to_multiple(33, 41, 8)
    ref_p = ref_pl.plan_pad_to_multiple(33, 41, 8)
    want = np.asarray(ref_pl._post_graph(x.shape, ref_p)(jnp.asarray(x)))
    np.testing.assert_array_equal(pl.post(torch.from_numpy(x), p), want)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(ref_pl._post_graph(xb.shape, ref_p)(xb))
    got = pl.post(torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(), p)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- probes

@pytest.mark.parametrize("shape,pads", [((41, 57), (0, 7, 0, 7)), ((48, 64), (0, 16, 0, 0)),
                                        ((720, 1280), (0, 16, 0, 0)), ((32, 32), (0, 0, 0, 0))])
@pytest.mark.parametrize("kind", ["u8", "f32"])
def test_probe_small_matches_reference(shape, pads, kind):
    rng = np.random.default_rng(shape[0])
    frame = rng.random(shape + (3,)).astype(np.float32)
    if kind == "u8":
        frame = to_u8([frame])[0]
    got = probe.probe_small(frame, pads)
    want = ref_probe.probe_small(frame, pads)  # cv2.resize INTER_LINEAR
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ssim_probe_equals_reference():
    rng = np.random.default_rng(7)
    for noise in (0.0, 0.01, 0.1, 0.5):
        a = rng.random((32, 32, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, noise, a.shape).astype(np.float32), 0, 1)
        assert probe.ssim_probe(a, b) == ref_probe.ssim_probe(a, b)


# ---------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def engines():
    tree_m = random_tree(JaxIFNetConfig(variant="rife_m"), seed=41, flow_gain=4.0)
    return {
        "rife": (JaxEngine("rife", _r5(), fast=1),
                 InferenceEngine("rife", state_dict_from_jax(_r5()), fast=1, device="cpu")),
        "rife_m": (JaxEngine("rife_m", tree_m, fast=1),
                   InferenceEngine("rife_m", state_dict_from_jax(tree_m, model="rife_m"),
                                   fast=1, device="cpu")),
    }


def run_both(engines, model, frames, **job):
    jeng, teng = engines[model]
    want, got = ListWriter(), ListWriter()
    wstats = jax_interpolate_video(jeng, ListReader(frames), want, JaxVideoJob(**job))
    stats = interpolate_video(teng, ListReader(frames), got, VideoJob(**job))
    return (stats, got.frames), (wstats, want.frames)


def assert_same_video(got, want):
    (stats, frames), (wstats, wframes) = got, want
    for k in ("frames_in", "frames_out", "static", "scene_cut"):
        assert stats[k] == wstats[k], (k, stats, wstats)
    assert len(frames) == len(wframes) == stats["frames_out"]
    for f, w in zip(frames, wframes):
        assert f.dtype == w.dtype == np.uint8 and f.shape == w.shape
    d = np.abs(np.stack(frames).astype(int) - np.stack(wframes).astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()


CASES = {
    "2X batched, u8": ("rife", lambda: to_u8(cut_clip()), dict(exp=1), (10, 19, 1, 1)),
    "2X batched, f32 frames": ("rife", cut_clip, dict(exp=1), (10, 19, 1, 1)),
    "4X midpoint tree": ("rife", lambda: to_u8(cut_clip(5)), dict(exp=2), (6, 21, 1, 1)),
    "2X montage": ("rife", lambda: to_u8(smooth_clip(4, w=128)), dict(exp=1, montage=True),
                   (4, 7, 0, 0)),
    "static final pair": ("rife", lambda: to_u8(smooth_clip(2) + smooth_clip(2)[1:]),
                          dict(exp=1), (3, 5, 1, 0)),
    "short flush, queue of 2": ("rife", lambda: to_u8(smooth_clip(7)),
                                dict(exp=1, queue_size=2), (7, 13, 0, 0)),
    "rife_m timestep 4X": ("rife_m", lambda: to_u8(smooth_clip(4)),
                           dict(exp=2, use_timestep=True), (4, 13, 0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_interpolate_video_matches_reference(engines, case):
    model, frames, job, counts = CASES[case]
    got, want = run_both(engines, model, frames(), **job)
    assert_same_video(got, want)
    stats = got[0]
    assert (stats["frames_in"], stats["frames_out"], stats["static"],
            stats["scene_cut"]) == counts
    if job.get("montage"):
        assert got[1][0].shape == (48, 128, 3)  # the centre half beside the output


def test_batched_midpoints_are_the_engines_on_the_stacked_pairs(engines):
    """Each 2X flush is one engine call on the stacked pairs, its short
    tail padded by repeating the last pair, and the frames written are
    that call's outputs."""
    teng = engines["rife"][1]
    calls = []

    class Recording:
        def __getattr__(self, name):
            return getattr(teng, name)

        def interpolate(self, a, b, t=0.5, tta=False):
            out = teng.interpolate(a, b, t, tta)
            calls.append((a.clone(), b.clone(), out.clone()))
            return out

    frames = to_u8(smooth_clip(6))
    writer = ListWriter()
    stats = interpolate_video(Recording(), ListReader(frames), writer, VideoJob(exp=1))
    assert stats["frames_out"] == 11
    assert [tuple(c[0].shape) for c in calls] == [(4, 64, 64, 3), (4, 64, 64, 3)]
    assert torch.equal(calls[1][0][1], calls[1][0][3])  # the flush of 1 repeats its pair
    mids = [writer.frames[i] for i in range(1, 11, 2)]
    direct = [pl.post(teng.interpolate(a, b), plan_pad_to_multiple(48, 64, 32))
              for a, b, _ in calls]
    for i, m in enumerate(mids):
        np.testing.assert_array_equal(m, direct[i // 4][i % 4])


def test_steady_state_never_fetches_from_the_device(engines, monkeypatch):
    def boom(frame):
        raise AssertionError("steady-state loop fetched from the device for the gate")

    monkeypatch.setattr(pl, "device_probe", boom)
    writer = ListWriter()
    stats = interpolate_video(engines["rife"][1], ListReader(to_u8(smooth_clip(5))), writer,
                              VideoJob(exp=1))
    assert stats["static"] == 0
    assert len(writer.frames) == 9


def test_the_static_branch_probes_on_the_device_once(engines, monkeypatch):
    probed = []
    real = pl.device_probe
    monkeypatch.setattr(pl, "device_probe", lambda f: probed.append(f.shape) or real(f))
    stats = interpolate_video(engines["rife"][1], ListReader(to_u8(cut_clip())), ListWriter(),
                              VideoJob(exp=1))
    assert stats["static"] == 1 and probed == [(1, 64, 64, 3)]


def test_stats_report_host_seconds(engines):
    stats = interpolate_video(engines["rife"][1], ListReader(to_u8(smooth_clip(3))),
                              ListWriter(), VideoJob(exp=1))
    for k in ("upload_s", "probe_s", "fetch_s", "seconds", "fps_out"):
        assert stats[k] >= 0, k
    assert stats["fetch_s"] > 0 and stats["probe_s"] > 0


class Failing(ListWriter):
    def write(self, f):
        if len(self.frames) == 2:
            raise OSError("disk full")
        super().write(f)


def _bounded(fn):
    """Run fn in a thread and require it to end within 60 s."""
    box = []
    t = threading.Thread(target=lambda: box.append(_catch(fn)), daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the pipeline did not end"
    return box[0]


def _catch(fn):
    try:
        return fn()
    except Exception as e:  # returned to the test
        return e


def test_a_writer_failure_is_raised_without_a_deadlock(engines):
    frames = to_u8(smooth_clip(12))
    err = _bounded(lambda: interpolate_video(engines["rife"][1], ListReader(frames), Failing(),
                                             VideoJob(exp=1, queue_size=1)))
    assert isinstance(err, OSError) and "disk full" in str(err)


def test_a_reader_failure_is_raised_without_a_deadlock(engines):
    def frames():
        yield from to_u8(smooth_clip(3))
        raise OSError("truncated stream")

    class Broken(ListReader):
        def __iter__(self):
            return frames()

    err = _bounded(lambda: interpolate_video(engines["rife"][1],
                                             Broken(to_u8(smooth_clip(3))), ListWriter(),
                                             VideoJob(exp=1)))
    assert isinstance(err, OSError) and "truncated" in str(err)


class MeanEngine:
    """A stand-in engine: the mean of the pair, on the CPU."""
    pad_multiple, compute_dtype, device = 32, torch.float32, torch.device("cpu")
    supports_timestep, model_name = False, "mean"

    def interpolate(self, a, b, t=0.5, tta=False):
        return (a.float() + b.float()) / 2


def test_frames_keep_their_order_under_constant_thread_switches():
    """Queues of one frame and a switch interval of 1 us: the same frames,
    in the same order, as with the default interval and long queues."""
    import sys

    frames = to_u8(smooth_clip(30, h=32, w=32, shift=1)) + to_u8(smooth_clip(2, h=32, w=32))
    want = ListWriter()
    interpolate_video(MeanEngine(), ListReader(frames), want, VideoJob(exp=1))
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for exp, batch in ((1, 4), (1, 3), (2, 4)):
            got = ListWriter()
            stats = _bounded(lambda: interpolate_video(
                MeanEngine(), ListReader(frames), got,
                VideoJob(exp=exp, batch=batch, queue_size=1)))
            assert stats["frames_out"] == len(got.frames) == 32 + 31 * ((1 << exp) - 1)
            if exp == 1:
                assert all(np.array_equal(g, w) for g, w in zip(got.frames, want.frames))
    finally:
        sys.setswitchinterval(saved)
