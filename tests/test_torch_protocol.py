"""The Vimeo90K protocol (`rife_tpu_torch.cli.benchmarks`) and the
checkpoint evaluation tool (`tools/port_eval_checkpoint.py`) against
rife_tpu's, on the CPU.

Both CLIs run over one fixture directory written with cv2 (2 triplets,
64x96) and one `.rtpu` of seeded random weights: PSNR within 0.02 dB,
SSIM within 1e-5.  The tool's in-memory fixture is bit-equal to
rife_tpu's `SyntheticTriplets` and to its PNGs read back.
"""
import argparse
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from rife_tpu.cli.benchmarks import run_vimeo90k as jax_run_vimeo90k
from rife_tpu.data import SyntheticTriplets as JaxSyntheticTriplets
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu_torch.cli import benchmarks
from rife_tpu_torch.engine.checkpoint import save_params

from test_torch_ladder import random_tree

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "port_eval_checkpoint", ROOT / "tools" / "port_eval_checkpoint.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


def _json_line(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return json.loads([x for x in buf.getvalue().splitlines() if x.startswith("{")][-1])


@pytest.fixture(scope="module")
def bench_dirs(tmp_path_factory):
    """A 2-triplet 64x96 Vimeo90K directory and a checkpoint directory with
    seeded random `rife` weights (flow heads x4, so the warps move)."""
    root = tmp_path_factory.mktemp("vimeo")
    import cv2

    ds = JaxSyntheticTriplets(n=2, h=64, w=96, seed=3)
    items = []
    for i in range(2):
        d = root / "sequences" / f"{i:05d}" / "0001"
        d.mkdir(parents=True)
        for name, img in zip(("im1", "im2", "im3"), ds.load(i)[:3]):
            cv2.imwrite(str(d / f"{name}.png"), img)
        items.append(f"{i:05d}/0001")
    (root / "tri_testlist.txt").write_text("\n".join(items) + "\n")
    ckpt = tmp_path_factory.mktemp("ckpt")
    tree = jax.tree_util.tree_map(np.asarray, random_tree(JaxIFNetConfig(), seed=21,
                                                          flow_gain=4.0))
    save_params(str(ckpt / "flownet.rtpu"), tree, {"model": "rife"})
    return str(root), str(ckpt)


@pytest.mark.parametrize("fast", [0, 2])
def test_vimeo90k_protocol_matches_reference(bench_dirs, fast):
    root, ckpt = bench_dirs
    ns = argparse.Namespace(root=root, modelDir=ckpt, model=None, scale=1.0,
                            dtype="float32", fast=fast)
    want = _json_line(jax_run_vimeo90k, ns)
    got = _json_line(benchmarks.main, ["vimeo90k", "--root", root, "--modelDir", ckpt,
                                       "--fast", str(fast), "--device", "cpu"])
    assert got["benchmark"] == "vimeo90k"
    assert abs(got["psnr"] - want["psnr"]) <= 0.02, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5, (got, want)
    assert 5 < got["psnr"] < 60  # a frame, not a copy of the ground truth


def test_ssim_rounded_rounds_in_f32_before_the_ssim():
    from rife_tpu.cli.benchmarks import _ssim_rounded as jax_ssim_rounded

    rng = np.random.default_rng(4)
    gt = rng.random((32, 48, 3), dtype=np.float32)
    pred = np.clip(gt + rng.normal(0, 0.03, gt.shape), -0.1, 1.1).astype(np.float32)
    assert abs(benchmarks._ssim_rounded(gt, pred) - jax_ssim_rounded(gt, pred)) <= 1e-6


def test_tool_fixture_is_the_reference_fixture(tmp_path):
    ref = JaxSyntheticTriplets(n=2, h=256, w=448, seed=777)
    mem = tool.fixture(n=2)
    for i, frames in enumerate(mem):
        for got, want in zip(frames, ref.load(i)[:3]):
            assert got.dtype == np.float32 and got.shape == (256, 448, 3)
            np.testing.assert_array_equal(got, want.astype(np.float32) / 255.0)
    tool.write_fixture(str(tmp_path), n=2)
    for frames, back in zip(mem, benchmarks.read_vimeo90k(str(tmp_path))):
        for a, b in zip(frames, back):
            np.testing.assert_array_equal(a, b)


def test_tool_writes_a_subset_without_exact_f32(tmp_path, bench_dirs):
    """A subset without exact-f32 runs and writes its rows (r4's tool lost
    them to a KeyError); the TPU JSON's rows are reported beside."""
    _, ckpt = bench_dirs
    (Path(ckpt) / "eval_protocol.json").write_text(json.dumps(
        {"fast2-f32": {"benchmark": "vimeo90k", "psnr": 40.0, "ssim": 0.99}}))
    out = tmp_path / "rows.json"
    with contextlib.redirect_stdout(io.StringIO()):
        res = tool.main([ckpt, "--device", "cpu", "--n", "1", "--configs",
                         "fast2-f32,fast4-bf16", "--out", str(out)])
    written = json.loads(out.read_text())
    assert sorted(written["port"]) == ["fast2-f32", "fast4-bf16"]
    assert written["deltas"] == res["deltas"]
    d = written["deltas"]["fast2-f32"]
    assert "vs_port_exact_f32" not in d
    assert d["vs_tpu_json"]["psnr"] == pytest.approx(written["port"]["fast2-f32"]["psnr"] - 40)
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            tool.main([ckpt, "--configs", "exact-f64"])


def test_committed_cpu_rows_hold_the_port_to_rife_tpu():
    """rife_tpu_torch/tools/eval_r5_cpu.json, the rows the card is held to:
    the port's nine rows and rife_tpu's f32 rows on the CPU over r4's
    32-triplet fixture; the port's exact, fast2 and fast3 f32 rows within
    0.02 dB and 1e-4 SSIM of rife_tpu's."""
    rows = json.loads((ROOT / "rife_tpu_torch" / "tools" / "eval_r5_cpu.json").read_text())
    assert rows["fixture"] == {"kind": "SyntheticTriplets", "n": 32, "h": 256, "w": 448,
                               "seed": 777, "form": "memory"}
    assert sorted(rows["port"]) == sorted(c[0] for c in tool.CONFIGS)
    for label in ("exact-f32", "fast2-f32", "fast3-f32"):
        got, want = rows["port"][label], rows["reference_cpu"][label]
        assert abs(got["psnr"] - want["psnr"]) <= 0.02, label
        assert abs(got["ssim"] - want["ssim"]) <= 1e-4, label


@pytest.mark.parametrize("name", ("ucf101", "middlebury", "hd", "hd4x", "atd12k", "testtime"))
def test_other_benchmarks_raise_naming_a12b(name, monkeypatch):
    """The six benchmarks ported after A12b's Vimeo90K protocol run on the
    card by default and raise without one (no CPU fallback)."""
    monkeypatch.setattr(benchmarks.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.main([name, "--root", "."])
