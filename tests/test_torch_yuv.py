"""The port's raw YUV420 IO (rife_tpu_torch.video.yuv) against rife_tpu's
on the same `.yuv` files: the writer's bytes equal, `read_frame`,
`read_rgb` (PIL's bicubic chroma, the f32 matrix product and the
truncation to uint8) and the matrices bit-equal, also on the cv2
INTER_CUBIC route taken where PIL is missing."""
import sys

import numpy as np
import pytest

from rife_tpu.video import yuv as ref
from rife_tpu_torch.video import yuv


def _frames(n, h, w, seed):
    """`n` smooth panned YUV frames in [0, 1] with noise (every u8 code of
    chroma near the clip edges reached)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h, w + 4 * n, 3)).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    base[..., 1:] = np.clip((base[..., 1:] - 0.5) * 3 + 0.5, 0, 1)
    return [np.ascontiguousarray(base[:, 4 * i:4 * i + w]) for i in range(n)]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The same frames written by both writers: (port path, reference path,
    h, w, frames)."""
    d = tmp_path_factory.mktemp("yuv")
    h, w = 36, 52
    frames = _frames(4, h, w, seed=5)
    paths = []
    for mod, name in ((yuv, "port.yuv"), (ref, "ref.yuv")):
        wr = mod.YUV420Writer(str(d / name), w, h)
        for f in frames:
            wr.write_frame(f)
        wr.close()
        paths.append(str(d / name))
    return paths[0], paths[1], h, w, frames


def test_writer_bytes_equal_reference(clips):
    port, refp, h, w, frames = clips
    with open(port, "rb") as a, open(refp, "rb") as b:
        got, want = a.read(), b.read()
    assert len(got) == len(frames) * h * w * 3 // 2
    assert got == want


@pytest.mark.parametrize("index", [None, 2])
def test_read_frame_bit_equal(clips, index):
    port, _, h, w, _ = clips
    got = yuv.YUV420Reader(port, w, h).read_frame(index)
    want = ref.YUV420Reader(port, w, h).read_frame(index)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_read_rgb_bit_equal_every_frame(clips):
    port, _, h, w, frames = clips
    r, q = yuv.YUV420Reader(port, w, h), ref.YUV420Reader(port, w, h)
    for i in range(len(frames)):
        got, want = r.read_rgb(i), q.read_rgb(i)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want)
    assert r.read_rgb(len(frames)) is None and q.read_rgb(len(frames)) is None
    r.close()


def test_read_rgb_truncates():
    """read_rgb truncates: a value that would round up stays below."""
    import tempfile

    h, w = 2, 2
    # Y = 128 with neutral chroma is 128/255 in every channel; 255 times its
    # f32 value lands just below or above 128 and must truncate either way,
    # as the reference's astype does: Y = 128 reads back 127 or 128, never
    # a rounded neighbour.
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/g.yuv"
        with open(path, "wb") as f:
            f.write(bytes([128] * (h * w)) + bytes([128] * (h * w // 2)))
        got = yuv.YUV420Reader(path, w, h).read_rgb(0)
        want = ref.YUV420Reader(path, w, h).read_rgb(0)
        np.testing.assert_array_equal(got, want)
        u = np.float32(128 / 255.0)
        exact = (np.float32(255.0) * u)
        assert int(got[0, 0, 0]) == int(exact)


def test_cv2_route_without_pil(clips, monkeypatch):
    port, _, h, w, frames = clips
    assert yuv.rgb_chroma_route() == "PIL"
    monkeypatch.setitem(sys.modules, "PIL", None)  # `import PIL` raises ImportError
    assert yuv.rgb_chroma_route() == "cv2 INTER_CUBIC"
    r, q = yuv.YUV420Reader(port, w, h), ref.YUV420Reader(port, w, h)
    for i in range(len(frames)):
        np.testing.assert_array_equal(r.read_rgb(i), q.read_rgb(i))


def test_iteration_and_matrices(clips):
    port, _, h, w, frames = clips
    got = list(yuv.YUV420Reader(port, w, h))
    want = list(ref.YUV420Reader(port, w, h))
    assert len(got) == len(frames) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rgb = np.random.default_rng(2).random((8, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(yuv.rgb_to_yuv(rgb), ref.rgb_to_yuv(rgb))
    np.testing.assert_array_equal(yuv.yuv_to_rgb(rgb), ref.yuv_to_rgb(rgb))
