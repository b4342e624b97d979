"""The port's six protocol benchmarks (rife_tpu_torch.cli.benchmarks:
ucf101, middlebury, hd, hd4x, atd12k, testtime) against rife_tpu's on
fixture directories and `.yuv` clips laid out as each dataset.

Logic: both packages' `_engine` patched to one numpy stand-in engine
(the same blend, as a jnp array on one side and a torch tensor on the
other): the printed JSON within 1e-6 and every other printed line equal;
hd4x's refusal of a fixed-midpoint checkpoint word for word; testtime's
two device synchronisations around the timed loop.  Shared f32 weights
(a seeded `.rtpu`): ucf101, atd12k and hd (`--clips` at 64x96) within
0.01 dB PSNR and 1e-4 SSIM.
"""
import argparse
import contextlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.cli import benchmarks as ref
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu.video.yuv import YUV420Writer
from rife_tpu_torch.cli import benchmarks
from rife_tpu_torch.engine.checkpoint import save_params

from test_torch_ladder import random_tree

SIX = ("ucf101", "middlebury", "hd", "hd4x", "atd12k", "testtime")


class StandIn:
    """One numpy engine for both packages: the frame at t is a + (b - a) * t
    in f32, computed in numpy and returned as a jnp array (`xp="jax"`) or a
    torch tensor on the CPU (`xp="torch"`)."""

    pad_multiple = 32

    def __init__(self, xp, model_name="rife_m", timestep=True):
        self.xp, self.model_name, self.supports_timestep = xp, model_name, timestep
        self.device = torch.device("cpu")
        self.compute_dtype = torch.float32 if xp == "torch" else jnp.dtype(jnp.float32)
        self.calls = []

    def interpolate(self, a, b, timestep=0.5, tta=False):
        a, b = (np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float32) for x in (a, b))
        t = np.asarray(timestep, np.float32)
        t = t.reshape(-1, 1, 1, 1) if t.ndim else t
        out = (a + (b - a) * t).astype(np.float32)
        self.calls.append((a.shape, float(np.mean(t))))
        return torch.from_numpy(out) if self.xp == "torch" else jnp.asarray(out)


def ns(**kw) -> argparse.Namespace:
    """The reference's arguments, at their defaults unless given."""
    base = dict(root=".", gt="other-gt-interp", model=None, modelDir="/nonexistent",
                scale=1.0, dtype="float32", fast=0, clips=None, warmup=2, iters=3)
    base.update(kw)
    return argparse.Namespace(**base)


def argv(name, **kw) -> list:
    out = [name, "--device", "cpu"]
    for k, v in kw.items():
        if v is not None:
            out += [f"--{k}", str(v)]
    return out


def run(fn, *a) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue().splitlines()


def smooth(h, w, seed, shift=0):
    rng = np.random.default_rng(seed)
    base = rng.random((h + 16, w + 16, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    return base[shift:shift + h, shift:shift + w]


def _png(path: Path, img01):
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), (np.clip(img01, 0, 1) * 255 + 0.5).astype(np.uint8))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """ucf101 (2 dirs, 64x64), middlebury (the 12 names, 40x56 and 48x64,
    with the ground-truth tree), atd12k (2 dirs, 60x96), a 5-frame 64x96
    `.yuv` clip, and a checkpoint directory of seeded `rife` weights."""
    d = tmp_path_factory.mktemp("bench")
    for i in range(2):
        for k, name in enumerate(("frame_00.png", "frame_01_gt.png", "frame_02.png")):
            _png(d / "ucf" / f"clip{i}" / name, smooth(64, 64, i, 2 * k))
        for k in range(3):
            _png(d / "atd" / f"d{i}" / f"frame{k + 1}.png", smooth(60, 96, 10 + i, 2 * k))
    for j, name in enumerate(ref._MIDDLEBURY):
        h, w = (40, 56) if j % 2 else (48, 64)
        _png(d / "mb" / name / "frame10.png", smooth(h, w, 20 + j))
        _png(d / "mb" / name / "frame11.png", smooth(h, w, 20 + j, 4))
        _png(d / "mbgt" / name / "frame10i11.png", smooth(h, w, 20 + j, 2))
    clip = d / "clip_64x96.yuv"
    wr = YUV420Writer(str(clip), 96, 64)
    for k in range(5):
        wr.write_frame(smooth(64, 96, 40, 2 * k))
    wr.close()
    ckpt = d / "ckpt"
    ckpt.mkdir()
    tree = jax.tree_util.tree_map(np.asarray, random_tree(JaxIFNetConfig(), seed=21,
                                                          flow_gain=4.0))
    save_params(str(ckpt / "flownet.rtpu"), tree, {"model": "rife"})
    return {"ucf101": {"root": d / "ucf"}, "atd12k": {"root": d / "atd"},
            "middlebury": {"root": d / "mb", "gt": d / "mbgt"},
            "hd": {"clips": f"{clip}:64:96"}, "hd4x": {"clips": f"{clip}:64:96"},
            "testtime": {"warmup": 2, "iters": 3}, "ckpt": str(ckpt)}


@pytest.mark.parametrize("name", SIX)
def test_logic_matches_reference_with_a_stand_in_engine(data, monkeypatch, name):
    engines = {"jax": StandIn("jax"), "torch": StandIn("torch")}
    monkeypatch.setattr(ref, "_engine", lambda args, default_model=None: engines["jax"])
    monkeypatch.setattr(benchmarks, "_engine",
                        lambda args, default_model=None: engines["torch"])
    kw = {k: v if isinstance(v, int) else str(v) for k, v in data[name].items()}
    want = run(getattr(ref, f"run_{name}"), ns(**kw))
    got = run(benchmarks.main, argv(name, **kw))
    jg, jw = json.loads(got[-1]), json.loads(want[-1])
    assert sorted(jg) == sorted(jw) and jg["benchmark"] == jw["benchmark"]
    assert engines["torch"].calls == engines["jax"].calls and engines["torch"].calls
    if name == "testtime":
        assert jg["seconds_per_frame"] > 0 and np.isclose(jg["fps"] * jg["seconds_per_frame"], 1)
        assert len(engines["torch"].calls) == 5
        return
    for k, v in jw.items():
        if k != "benchmark":
            assert np.isfinite(jg[k]) and abs(jg[k] - v) <= 1e-6, (k, jg[k], v)
    assert got[:-1] == want[:-1]
    if name == "hd4x":
        assert [c[1] for c in engines["torch"].calls] == [0.25, 0.5, 0.75]


def test_hd_skips_a_missing_clip_as_the_reference(data, monkeypatch, tmp_path):
    monkeypatch.setattr(ref, "_engine", lambda args, default_model=None: StandIn("jax"))
    monkeypatch.setattr(benchmarks, "_engine",
                        lambda args, default_model=None: StandIn("torch"))
    clips = f"{tmp_path / 'none.yuv'}:64:96,{data['hd']['clips']}"
    want = run(ref.run_hd, ns(clips=clips))
    got = run(benchmarks.main, argv("hd", clips=clips))
    assert got[0] == want[0] == f"skip missing {tmp_path / 'none.yuv'}"
    assert got[:-1] == want[:-1]


def test_hd4x_refuses_a_fixed_midpoint_checkpoint_as_the_reference(data):
    with pytest.raises(SystemExit) as want:
        ref.run_hd4x(ns(modelDir=data["ckpt"], clips=data["hd4x"]["clips"]))
    with pytest.raises(SystemExit) as got:
        benchmarks.main(argv("hd4x", modelDir=data["ckpt"], clips=data["hd4x"]["clips"]))
    assert "timestep" in str(got.value) and str(got.value) == str(want.value)


def test_engine_default_model_only_without_a_checkpoint(data):
    args = benchmarks.argparse.Namespace(modelDir="/nonexistent", model=None, scale=1.0,
                                         dtype="float32", fast=0, device="cpu")
    assert benchmarks._engine(args, default_model="rife_m").model_name == "rife_m"
    assert benchmarks._engine(args).model_name == "rife"
    args.modelDir = data["ckpt"]
    assert benchmarks._engine(args, default_model="rife_m").model_name == "rife"


def test_testtime_synchronises_around_the_timed_loop(monkeypatch):
    eng = StandIn("torch")
    events = []
    real = eng.interpolate
    eng.interpolate = lambda *a, **k: (events.append("fwd"), real(*a, **k))[1]
    monkeypatch.setattr(benchmarks, "_engine", lambda args, default_model=None: eng)
    monkeypatch.setattr(benchmarks, "_sync", lambda dev: events.append(f"sync {dev}"))
    line = run(benchmarks.main, argv("testtime", warmup=2, iters=3))[-1]
    assert events == ["fwd"] * 2 + ["sync cpu"] + ["fwd"] * 3 + ["sync cpu"]
    assert eng.calls[0][0] == (1, 480, 640, 3)
    assert json.loads(line)["benchmark"] == "testtime"


def test_sync_waits_for_the_card_only(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: seen.append(dev))
    benchmarks._sync(torch.device("cpu"))
    benchmarks._sync(torch.device("cuda", 0))
    assert seen == [torch.device("cuda", 0)]


@pytest.mark.parametrize("name", ["ucf101", "atd12k", "hd"])
def test_shared_f32_weights_match_reference(data, name):
    kw = {k: str(v) for k, v in data[name].items()}
    want = json.loads(run(getattr(ref, f"run_{name}"), ns(modelDir=data["ckpt"], **kw))[-1])
    got = json.loads(run(benchmarks.main, argv(name, modelDir=data["ckpt"], **kw))[-1])
    assert got["benchmark"] == want["benchmark"]
    for k in [k for k in want if k != "benchmark"]:
        tol = 1e-4 if k == "ssim" else 0.01
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    assert 5 < got.get("psnr", got.get("psnr_y")) < 60  # a frame, not a copy
