"""The port's frame-ops binding (rife_tpu_torch.native) against rife_tpu's
compiled library of the same C source, against its own numpy versions,
and against rife_tpu's numpy fallback."""
import numpy as np
import pytest

from rife_tpu import native as ref_native
from rife_tpu_torch import native


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    u8[0, :16, 0] = np.arange(0, 256, 16)
    f32 = (rng.standard_normal((40, 60, 3)) * 0.6 + 0.5).astype(np.float32)
    # every u8 level and the values around each rounding boundary
    edges = (np.arange(256, dtype=np.float32) - 0.5) / np.float32(255.0)
    near = np.concatenate([np.nextafter(edges, -np.inf), edges,
                           np.nextafter(edges, np.inf), [-1, -0.0, 0, 1, 2]])
    f32.reshape(-1)[:near.size] = near.astype(np.float32)
    return u8, f32


def test_both_packages_build_the_library():
    assert native.have_native()
    assert ref_native.have_native()


def test_binding_is_bit_equal_to_rife_tpus_library(frames):
    u8, f32 = frames
    for pad in ((37, 53), (64, 64), (40, 96)):
        np.testing.assert_array_equal(native.u8_to_f32_pad(u8, *pad),
                                      ref_native.u8_to_f32_pad(u8, *pad))
    for crop in ((40, 60), (32, 48), (1, 1)):
        np.testing.assert_array_equal(native.f32_to_u8_crop(f32, *crop),
                                      ref_native.f32_to_u8_crop(f32, *crop))
    batch = np.stack([u8, u8[::-1]])
    np.testing.assert_array_equal(native.u8_to_f32(batch), ref_native.u8_to_f32(batch))
    fb = np.stack([f32, -f32])
    np.testing.assert_array_equal(native.f32_to_u8(fb), ref_native.f32_to_u8(fb))


def test_numpy_versions_are_bit_equal_to_rife_tpus_fallback(frames, monkeypatch):
    u8, f32 = frames
    mine = (native.u8_to_f32_pad_ref(u8, 64, 64), native.f32_to_u8_crop_ref(f32, 32, 48))
    monkeypatch.setattr(ref_native, "_build_and_load", lambda: None)
    ref = (ref_native.u8_to_f32_pad(u8, 64, 64), ref_native.f32_to_u8_crop(f32, 32, 48))
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_binding_against_its_numpy_versions(frames):
    u8, f32 = frames
    got, want = native.u8_to_f32_pad(u8, 48, 64), native.u8_to_f32_pad_ref(u8, 48, 64)
    # 1/255.0f times against a division: at most 1 ulp apart
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp)
    assert (got[37:] == 0).all() and (got[:, 53:] == 0).all()
    np.testing.assert_array_equal(native.f32_to_u8_crop(f32, 40, 60),
                                  native.f32_to_u8_crop_ref(f32, 40, 60))


@pytest.mark.parametrize("hw", [(2, 2), (36, 54), (72, 128)])
def test_yuv420_to_rgb_is_bit_equal_to_its_numpy_version(hw):
    rng = np.random.default_rng(hw[1])
    h, w = hw
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8) for _ in range(2))
    got = native.yuv420_to_rgb(y, u, v)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, native.yuv420_to_rgb_ref(y, u, v))


def test_yuv420_to_rgb_over_every_chroma_pair():
    """Every (u, v) pair at four luma levels: the saturating corners and
    every rounding of the matrix."""
    u, v = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    for level in (0, 77, 160, 255):
        y = np.full((512, 512), level, np.uint8)
        np.testing.assert_array_equal(native.yuv420_to_rgb(y, u, v),
                                      native.yuv420_to_rgb_ref(y, u, v))


def test_refuses_what_the_c_code_cannot_take(frames):
    u8, f32 = frames
    with pytest.raises(ValueError):
        native.u8_to_f32_pad(f32, 64, 64)
    with pytest.raises(ValueError):
        native.u8_to_f32_pad(u8, 16, 64)
    with pytest.raises(ValueError):
        native.f32_to_u8_crop(f32, 41, 60)
    with pytest.raises(ValueError):
        native.yuv420_to_rgb(np.zeros((3, 4), np.uint8), np.zeros((1, 2), np.uint8),
                             np.zeros((1, 2), np.uint8))


def test_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "frameops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build("g++")
    assert not list((tmp_path / "build").glob("*.so"))


def test_without_gpp_the_numpy_versions_run(frames, monkeypatch):
    u8, f32 = frames
    monkeypatch.setattr(native, "_STATE", {"lock": native.threading.Lock(),
                                           "tried": False, "lib": None})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.have_native()
    np.testing.assert_array_equal(native.u8_to_f32_pad(u8, 64, 64),
                                  native.u8_to_f32_pad_ref(u8, 64, 64))
    np.testing.assert_array_equal(native.f32_to_u8(f32), native.f32_to_u8_crop_ref(f32, 40, 60))
