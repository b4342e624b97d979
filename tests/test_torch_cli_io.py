"""The port's image and video CLIs and its disk-spill interpolator against
rife_tpu's on the CPU: `interp_img` (--exp, --ratio, a `.pkl`
checkpoint, the EXR path), `interp_video --img DIR --png` and
`DiskInterpolator`, with the r5 weights, on PNGs written here.  Frames
within 1 LSB and at least 99.9% equal (the disk interpolator, whose
waves re-read rounded PNGs, within 2 LSB); the port imports without cv2.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from rife_tpu.cli import _common as ref_common
from rife_tpu.cli import interp_img as ref_interp_img
from rife_tpu.cli import interp_video as ref_interp_video
from rife_tpu.engine.disk_interp import DiskInterpolator as JaxDiskInterpolator
from rife_tpu.engine.inference import InferenceEngine as JaxEngine
from rife_tpu_torch.cli import interp_img, interp_video
from rife_tpu_torch.engine import DiskInterpolator, InferenceEngine, state_dict_from_jax
from rife_tpu_torch.models.torch_export import export_ifnet, save_torch_pickle

from test_torch_ladder import _r5
from test_torch_video import smooth_clip, to_u8

ROOT = os.path.join(os.path.dirname(__file__), "..")
R5_DIR = os.path.join(ROOT, "train_log_r5")


@pytest.fixture(autouse=True)
def no_jit_cache_dir(monkeypatch):
    """rife_tpu's CLIs create a cache directory under HOME; not here."""
    monkeypatch.setattr(ref_common, "enable_compilation_cache", lambda path=None: None)


def read_dir(path):
    names = sorted(f for f in os.listdir(path) if f.endswith(".png"))
    return names, [cv2.imread(os.path.join(path, f)) for f in names]


def assert_close_frames(got, want, lsb=1):
    assert len(got) == len(want) > 0
    d = np.abs(np.stack(got).astype(int) - np.stack(want).astype(int))
    assert d.max() <= lsb, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Two 48x72 frames of panned content as PNGs (padded to 64x96)."""
    d = tmp_path_factory.mktemp("pair")
    paths = []
    for i, f in enumerate(to_u8(smooth_clip(2, h=48, w=72, shift=3))):
        paths.append(str(d / f"frame{i}.png"))
        cv2.imwrite(paths[-1], f[..., ::-1])
    return paths


def run_interp_img(tmp_path, pngs, *flags, model_dir=R5_DIR):
    out = {}
    for label, mod, extra in (("ref", ref_interp_img, []),
                              ("port", interp_img, ["--device", "cpu"])):
        dest = str(tmp_path / label)
        mod.main(["--img", *pngs, "--modelDir", model_dir, "--output", dest, *flags,
                  *extra])
        out[label] = read_dir(dest)
    return out


@pytest.mark.parametrize("flags,n", [(["--exp", "2"], 5), (["--exp", "1"], 3),
                                     (["--ratio", "0.3"], 3),
                                     (["--ratio", "0.3", "--rthreshold", "0.2"], 3)])
def test_interp_img_matches_reference(tmp_path, pngs, flags, n):
    out = run_interp_img(tmp_path, pngs, *flags)
    assert out["port"][0] == out["ref"][0] == [f"img{i}.png" for i in range(n)]
    assert_close_frames(out["port"][1], out["ref"][1])


def test_interp_img_reads_a_reference_pickle(tmp_path, pngs):
    """--modelDir holding only a flownet.pkl: the same frames as the .rtpu."""
    pkl_dir = tmp_path / "pkl"
    pkl_dir.mkdir()
    save_torch_pickle(str(pkl_dir / "flownet.pkl"), export_ifnet(_r5()))
    assert interp_img.find_checkpoint(str(pkl_dir)) == str(pkl_dir / "flownet.pkl")
    assert interp_img.find_checkpoint(R5_DIR).endswith("flownet.rtpu")
    for label, model_dir in (("pkl", str(pkl_dir)), ("rtpu", R5_DIR)):
        interp_img.main(["--img", *pngs, "--exp", "1", "--modelDir", model_dir,
                         "--output", str(tmp_path / label), "--device", "cpu"])
    a, b = read_dir(str(tmp_path / "pkl"))[1], read_dir(str(tmp_path / "rtpu"))[1]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


class FakeExr:
    """cv2.imread / cv2.imwrite for .exr paths, in memory: cv2 reads and
    writes EXR only where it was built with OpenEXR (otherwise imwrite
    raises "could not find a writer for the specified extension"), so the
    EXR path of both CLIs is held to each other through the calls they
    make, whatever the installed cv2 supports."""

    def __init__(self, monkeypatch):
        self.files, self.writes = {}, []
        self.imread, self.imwrite = cv2.imread, cv2.imwrite
        monkeypatch.setattr(cv2, "imread", self.read)
        monkeypatch.setattr(cv2, "imwrite", self.write)

    def read(self, path, flags=cv2.IMREAD_COLOR):
        if path.endswith(".exr"):
            assert flags == cv2.IMREAD_COLOR | cv2.IMREAD_ANYDEPTH
            return self.files.get(path)
        return self.imread(path, flags)

    def write(self, path, img, params=()):
        if path.endswith(".exr"):
            assert list(params) == [cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_HALF]
            self.files[path] = np.array(img, np.float32)
            self.writes.append((os.path.basename(path), img.dtype, img.shape))
            return True
        return self.imwrite(path, img, params)


def test_interp_img_exr_path_matches_reference(tmp_path, pngs, monkeypatch):
    fake = FakeExr(monkeypatch)
    exrs = []
    for i, f in enumerate(smooth_clip(2, h=48, w=72, shift=3)):
        exrs.append(str(tmp_path / f"frame{i}.exr"))
        fake.files[exrs[-1]] = (f[..., ::-1] * 1.5).astype(np.float16).astype(np.float32)
    out = {}
    for label, mod, extra in (("ref", ref_interp_img, []),
                              ("port", interp_img, ["--device", "cpu"])):
        dest = str(tmp_path / label)
        mod.main(["--img", *exrs, "--exp", "1", "--modelDir", R5_DIR, "--output", dest,
                  *extra])
        out[label] = [fake.files[os.path.join(dest, f"img{i}.exr")] for i in range(3)]
    assert [w[0] for w in fake.writes] == ["img0.exr", "img1.exr", "img2.exr"] * 2
    assert all(w[1] == np.float16 and w[2] == (48, 72, 3) for w in fake.writes)
    for got, want in zip(out["port"], out["ref"]):
        # half floats of frames within 2e-4: at most 1 half ulp apart
        np.testing.assert_allclose(got, want, rtol=2 ** -10, atol=2e-4)
    assert float(np.max(out["port"][0])) > 1.0  # EXR skips the [0, 1] scaling


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for i, f in enumerate(to_u8(smooth_clip(5, h=48, w=72, shift=3))):
        cv2.imwrite(str(d / f"{i:04d}.png"), f[..., ::-1])
    return str(d)


@pytest.mark.parametrize("flags", [["--exp", "1"], ["--exp", "2"],
                                   ["--exp", "1", "--montage"]])
def test_interp_video_png_dir_matches_reference(tmp_path, frame_dir, flags):
    out = {}
    for label, mod, extra in (("ref", ref_interp_video, []),
                              ("port", interp_video, ["--device", "cpu"])):
        dest = str(tmp_path / label)
        mod.main(["--img", frame_dir, "--png", "--output", dest, "--modelDir", R5_DIR,
                  "--dtype", "float32", *flags, *extra])
        out[label] = read_dir(dest)
    exp = int(flags[1])
    assert out["port"][0] == out["ref"][0]
    assert len(out["port"][0]) == 5 + 4 * ((1 << exp) - 1)
    assert_close_frames(out["port"][1], out["ref"][1])


def test_interp_video_defaults_bf16_rung_1(tmp_path, frame_dir, monkeypatch, capsys):
    """The reference's defaults (bfloat16, --fast 1): against the port's own
    f32 output, by PSNR."""
    built = []
    real = interp_video.build_engine
    monkeypatch.setattr(interp_video, "build_engine",
                        lambda *a, **k: built.append((a, k)) or real(*a, **k))
    runs = {}
    for label, flags in (("bf16", []), ("f32", ["--dtype", "float32"])):
        dest = str(tmp_path / label)
        interp_video.main(["--img", frame_dir, "--output", dest, "--modelDir", R5_DIR,
                           "--device", "cpu", *flags])
        runs[label] = np.stack(read_dir(dest)[1]).astype(np.float64)
    assert built[0][0][3] == "bfloat16" and built[0][1]["fast"] == 1
    assert "'frames_out': 9" in capsys.readouterr().out
    mse = float(np.mean((runs["bf16"] - runs["f32"]) ** 2)) / 255.0 ** 2
    assert 10 * np.log10(1 / max(mse, 1e-20)) >= 40


def test_interp_video_refuses_bad_flags(tmp_path, frame_dir):
    with pytest.raises(SystemExit):
        interp_video.main(["--device", "cpu"])
    with pytest.raises(SystemExit):
        interp_video.main(["--img", frame_dir, "--scale", "0.3", "--device", "cpu"])


def test_disk_interpolator_matches_reference(tmp_path):
    frames = smooth_clip(3, h=64, w=96, shift=3)
    jeng = JaxEngine("rife", _r5())
    teng = InferenceEngine("rife", state_dict_from_jax(_r5()), device="cpu")
    want = JaxDiskInterpolator(jeng, str(tmp_path / "ref")).interpolate(frames, 9)
    di = DiskInterpolator(teng, str(tmp_path / "port"))
    got = di.interpolate(frames, 9)
    assert len(got) == len(want) == 9
    assert all(g.dtype == np.float32 and g.shape == (64, 96, 3) for g in got)
    as_u8 = lambda fs: [np.rint(f * 255).astype(np.uint8) for f in fs]  # noqa: E731
    assert_close_frames(as_u8(got), as_u8(want), lsb=2)
    di.cleanup()
    assert not os.listdir(tmp_path / "port")


def test_the_port_imports_without_cv2():
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import rife_tpu_torch.video, rife_tpu_torch.video.pipeline\n"
            "import rife_tpu_torch.engine, rife_tpu_torch.native\n"
            "import rife_tpu_torch.cli.interp_img, rife_tpu_torch.cli.interp_video\n"
            "import rife_tpu_torch.cli.convert, rife_tpu_torch.engine.disk_interp\n"
            "import rife_tpu_torch.engine.checkpoint, rife_tpu_torch.engine.schedule\n"
            "assert 'jax' not in sys.modules and 'rife_tpu' not in sys.modules\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
