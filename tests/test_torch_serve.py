"""The port's service layer (rife_tpu_torch.serve.services, analyzer) against
rife_tpu's on the CPU.

With one numpy stand-in engine on both sides (test_torch_benchmarks.StandIn)
the frames that reach `_encode_frames` are u8-equal to rife_tpu's for the
pair (in memory and disk-based), the chain's cv2 path and the cv2
re-encode, and the decoded outputs of `interpolate_video_file` equal; the
ffmpeg commands of `_encode_frames`, `chained_transitions` and
`reencode_video` (ffmpeg and subprocess.run patched: neither machine has
ffmpeg) equal the reference's, the PNGs they would encode too; every mp4
the cv2 writer leaves carries the BT.709 colr atom; the analyzer's cv2
branch and a recorded ffprobe JSON give the reference's analysis and
verdict.  Then the whole slice on shared f32 weights: the pair at
passes 1 (one forward at the app's minimum, 512x512), frames within 1
LSB.
"""
import json
import os
import re
import subprocess

import cv2
import jax
import numpy as np
import pytest

from rife_tpu.engine import InferenceEngine as JaxEngine
from rife_tpu.engine.checkpoint import load_params
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu.serve import analyzer as ref_analyzer
from rife_tpu.serve import services as ref
from rife_tpu_torch.engine import build_engine
from rife_tpu_torch.engine.checkpoint import save_params
from rife_tpu_torch.native import f32_to_u8
from rife_tpu_torch.serve import analyzer, services
from rife_tpu_torch.video.mp4meta import read_colr

from test_torch_benchmarks import StandIn
from test_torch_ladder import random_tree


def write_clip(path, n, fps, seed=0, h=48, w=64, shift=3):
    rng = np.random.default_rng(seed)
    base = rng.random((h + 8, w + shift * n + 8, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    u8 = (base * 255 + 0.5).astype(np.uint8)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for i in range(n):
        wr.write(np.ascontiguousarray(u8[4:4 + h, 4 + shift * i:4 + shift * i + w]))
    wr.release()
    return str(path)


def decode(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


@pytest.fixture
def captured(monkeypatch):
    """Both packages' `_encode_frames` wrapped: the frames each was handed,
    then the real encoder."""
    seen = {"jax": [], "torch": []}
    for key, mod in (("jax", ref), ("torch", services)):
        real = mod._encode_frames

        def enc(frames, out, fps, real=real, key=key):
            seen[key].append(([np.asarray(f, np.float32) for f in frames], fps))
            return real(frames, out, fps)

        monkeypatch.setattr(mod, "_encode_frames", enc)
    return seen


def assert_same_frames(seen):
    assert len(seen["torch"]) == len(seen["jax"]) >= 1
    for (got, gfps), (want, wfps) in zip(seen["torch"], seen["jax"]):
        assert gfps == wfps and len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(f32_to_u8(g), f32_to_u8(w))


def _img(h, w, seed):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("disk", [False, True])
def test_pair_frames_equal_reference(tmp_path, captured, disk):
    a, b = _img(40, 56, 1), _img(40, 56, 2)
    kw = dict(passes=2, fps=5, disk_based=disk)
    want = ref.interpolate_pair_to_video(StandIn("jax"), a, b, str(tmp_path / "r.mp4"),
                                         workdir=str(tmp_path / "rd"), **kw)
    got = services.interpolate_pair_to_video(StandIn("torch"), a, b, str(tmp_path / "p.mp4"),
                                             workdir=str(tmp_path / "pd"), **kw)
    assert {**got, "output": None} == {**want, "output": None}
    assert got["frames"] == 5
    assert_same_frames(captured)
    assert read_colr(got["output"]) == (1, 1, 1)
    assert [f.shape for f in decode(got["output"])] == [(40, 56, 3)] * 5


def test_pair_uploads_once_and_crops_on_the_device(tmp_path, monkeypatch):
    """The padded pair reaches the engine as (1, 512, 512, 3) tensors; each
    fetched frame was cropped before it left the device."""
    eng = StandIn("torch")
    fetched = []
    real = services._fetch
    monkeypatch.setattr(services, "_fetch",
                        lambda f, pad: (fetched.append(tuple(pad.crop(f).shape)), real(f, pad))[1])
    services.interpolate_pair_to_video(eng, _img(40, 56, 1), _img(40, 56, 2),
                                       str(tmp_path / "p.mp4"), passes=1)
    assert eng.calls == [((1, 512, 512, 3), 0.5)]
    assert fetched == [(1, 40, 56, 3)] * 3


def test_video_file_equals_reference(tmp_path):
    src = write_clip(tmp_path / "in.mp4", 5, 10)
    want = ref.interpolate_video_file(StandIn("jax", timestep=False), src,
                                      str(tmp_path / "r.mp4"), exp=1)
    got = services.interpolate_video_file(StandIn("torch", timestep=False), src,
                                          str(tmp_path / "p.mp4"), exp=1)
    keys = ("frames_in", "frames_out", "static", "scene_cut", "audio")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["frames_out"] == 9
    a, b = decode(tmp_path / "p.mp4"), decode(tmp_path / "r.mp4")
    assert len(a) == len(b) == 9
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_chain_cv2_path_equals_reference(tmp_path, captured):
    a = write_clip(tmp_path / "a.mp4", 3, 10, seed=1)
    b = write_clip(tmp_path / "b.mp4", 4, 25, seed=2)
    want = ref.chained_transitions(StandIn("jax"), [a, b], str(tmp_path / "r.mp4"),
                                   transition_passes=1)
    got = services.chained_transitions(StandIn("torch"), [a, b], str(tmp_path / "p.mp4"),
                                       transition_passes=1)
    assert {**got, "output": None} == {**want, "output": None}
    assert got["mode"] == "cv2" and got["frames"] == 3 + 1 + 4
    assert_same_frames(captured)
    assert len(decode(got["output"])) == 8 and read_colr(got["output"]) == (1, 1, 1)


def test_reencode_cv2_equals_reference(tmp_path, captured):
    src = write_clip(tmp_path / "in.mp4", 4, 12)
    want = ref.reencode_video(src, str(tmp_path / "r.mp4"))
    got = services.reencode_video(src, str(tmp_path / "p.mp4"))
    assert got == want and got["action"] == "reencoded_cv2"
    assert_same_frames(captured)
    assert read_colr(str(tmp_path / "p.mp4")) == (1, 1, 1)


def test_analyzer_cv2_branch_equals_reference(tmp_path, monkeypatch):
    src = write_clip(tmp_path / "in.mp4", 3, 30)
    monkeypatch.setattr("shutil.which", lambda name: None)
    got, want = analyzer.analyze_video(src), ref_analyzer.analyze_video(src)
    assert got == want and got["source"] == "cv2" and (got["width"], got["height"]) == (64, 48)
    assert analyzer.is_compliant(got) is ref_analyzer.is_compliant(want) is False


FFPROBE = {
    "streams": [
        {"codec_type": "video", "codec_name": "h264", "pix_fmt": "yuv420p",
         "color_space": "bt709", "width": 1280, "height": 720, "r_frame_rate": "30000/1001"},
        {"codec_type": "audio", "codec_name": "aac", "sample_rate": "16000"},
    ],
    "format": {"duration": "2.0"},
}


def _variants():
    yield FFPROBE
    no_cs = json.loads(json.dumps(FFPROBE))
    no_cs["streams"][0].pop("color_space")
    no_cs["streams"][0]["color_trc"] = "bt709"
    yield no_cs
    bad_audio = json.loads(json.dumps(FFPROBE))
    bad_audio["streams"][1]["sample_rate"] = "44100"
    yield bad_audio
    silent = json.loads(json.dumps(FFPROBE))
    silent["streams"] = silent["streams"][:1]
    silent["streams"][0]["r_frame_rate"] = "0/0"
    yield silent
    yield {}


@pytest.mark.parametrize("probe", list(_variants()))
def test_analyzer_ffprobe_json_equals_reference(monkeypatch, probe):
    class Done:
        returncode, stdout = 0, json.dumps(probe)

    monkeypatch.setattr("shutil.which", lambda name: "/usr/bin/" + name)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Done())
    got, want = analyzer.analyze_video("x.mp4"), ref_analyzer.analyze_video("x.mp4")
    assert got == want and got["source"] == "ffprobe"
    assert analyzer.is_compliant(got) is ref_analyzer.is_compliant(want)


@pytest.fixture
def fake_ffmpeg(monkeypatch):
    """ffmpeg 'present' for both packages; each command recorded with its
    temporary directory replaced by <tmp>, its output written as b"x", and
    the PNGs it would encode read back."""
    calls = []
    real = subprocess.run

    class Done:
        returncode = 0

    def run(cmd, check=False, **kw):
        if cmd[0] != "ffmpeg":  # numpy's own probes (lscpu)
            return real(cmd, check=check, **kw)
        cmd = [str(c) for c in cmd]
        pngs = []
        if "-framerate" in cmd:
            d = os.path.dirname(cmd[cmd.index("-i") + 1])
            pngs = [cv2.imread(os.path.join(d, f)) for f in sorted(os.listdir(d))]
        tmp = re.compile(r"[^ ']*/(?:tmp|rife_chain_)[a-z0-9_]{8}(?=/)")
        calls.append(([tmp.sub("<tmp>", c) for c in cmd], pngs))
        with open(cmd[-1], "wb") as f:
            f.write(b"x")
        return Done()

    monkeypatch.setattr(subprocess, "run", run)
    for mod in (ref, services):
        monkeypatch.setattr(mod, "have_ffmpeg", lambda: True)
    return calls


def _split(calls, n):
    return calls[:n], calls[n:]


def assert_same_calls(mine, theirs):
    assert [c for c, _ in mine] == [c for c, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_ffmpeg_commands_equal_reference(tmp_path, fake_ffmpeg, monkeypatch):
    out = str(tmp_path / "o.mp4")
    a, b = _img(40, 56, 1), _img(40, 56, 2)
    ref.interpolate_pair_to_video(StandIn("jax"), a, b, out, passes=1, fps=7)
    services.interpolate_pair_to_video(StandIn("torch"), a, b, out, passes=1, fps=7)
    theirs, mine = _split(fake_ffmpeg, 1)
    assert_same_calls(mine, theirs)
    assert theirs[0][0][:8] == ["ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
                                "-framerate", "7", "-i"]
    assert len(theirs[0][1]) == 3

    fake_ffmpeg.clear()
    va = write_clip(tmp_path / "a.mp4", 3, 10, seed=1)
    vb = write_clip(tmp_path / "b.mp4", 3, 25, seed=2)
    want = ref.chained_transitions(StandIn("jax"), [va, vb], out, transition_passes=1)
    n = len(fake_ffmpeg)
    got = services.chained_transitions(StandIn("torch"), [va, vb], out, transition_passes=1)
    theirs, mine = _split(fake_ffmpeg, n)
    assert_same_calls(mine, theirs)
    assert got == want and got["mode"] == "concat_copy" and got["fps_normalized"] == 1

    fake_ffmpeg.clear()
    monkeypatch.setattr("shutil.which", lambda name: None)  # no ffprobe: not compliant
    want = ref.reencode_video(va, out)
    got = services.reencode_video(va, out)
    theirs, mine = _split(fake_ffmpeg, 1)
    assert got == want and got["action"] == "reencoded_ffmpeg"
    assert_same_calls(mine, theirs)
    assert mine[0][0][-3:] == ["-ar", "16000", out]


def test_chain_falls_back_to_a_reencode_concat(tmp_path, monkeypatch):
    """A failing stream copy -> the re-encode concat, as the reference."""
    calls = {"jax": [], "torch": []}
    side = {"now": "jax"}
    real = subprocess.run

    class Result:
        def __init__(self, rc):
            self.returncode = rc

    def run(cmd, check=False, **kw):
        if cmd[0] != "ffmpeg":
            return real(cmd, check=check, **kw)
        cmd = [str(c) for c in cmd]
        calls[side["now"]].append("copy" in cmd)
        with open(cmd[-1], "wb") as f:
            f.write(b"x")
        return Result(1 if "copy" in cmd else 0)

    monkeypatch.setattr(subprocess, "run", run)
    for mod in (ref, services):
        monkeypatch.setattr(mod, "have_ffmpeg", lambda: True)
    va = write_clip(tmp_path / "a.mp4", 3, 10, seed=1)
    vb = write_clip(tmp_path / "b.mp4", 3, 10, seed=2)
    want = ref.chained_transitions(StandIn("jax"), [va, vb], str(tmp_path / "o.mp4"),
                                   transition_passes=1)
    side["now"] = "torch"
    got = services.chained_transitions(StandIn("torch"), [va, vb], str(tmp_path / "o.mp4"),
                                       transition_passes=1)
    assert got == want and got["mode"] == "concat_reencode"
    assert calls["torch"] == calls["jax"]


@pytest.fixture(scope="module")
def shared_f32(tmp_path_factory):
    """rife_tpu's f32 engine and the port's on the same seeded weights."""
    d = tmp_path_factory.mktemp("ckpt")
    tree = jax.tree_util.tree_map(np.asarray, random_tree(JaxIFNetConfig(), seed=21,
                                                          flow_gain=4.0))
    save_params(str(d / "flownet.rtpu"), tree, {"model": "rife"})
    jeng = JaxEngine("rife", load_params(str(d / "flownet.rtpu"))[0])
    return jeng, build_engine(str(d / "flownet.rtpu"), None, device="cpu")


def test_pair_on_shared_weights_within_one_lsb(tmp_path, captured, shared_f32):
    """The whole slice: one forward at 512x512 (the app's minimum) of the
    port's f32 engine against rife_tpu's; the frames handed to the
    encoder within 1 LSB, at least 99% equal."""
    jeng, teng = shared_f32
    rng = np.random.default_rng(3)
    base = rng.random((200, 240, 3)).astype(np.float32)
    for _ in range(4):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    a, b = base[:180, :200], base[6:186, 8:208]
    ref.interpolate_pair_to_video(jeng, a, b, str(tmp_path / "r.mp4"), passes=1)
    services.interpolate_pair_to_video(teng, a, b, str(tmp_path / "p.mp4"), passes=1)
    (got, _), (want, _) = captured["torch"][0], captured["jax"][0]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        d = np.abs(f32_to_u8(g).astype(int) - f32_to_u8(w).astype(int))
        assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())
    moved = np.abs(got[1] - 0.5 * (a + b)).mean()
    assert moved > 1e-3  # the model's frame, not the blend of its inputs
