"""The port's small modules against rife_tpu's: `video.mp4meta` (byte-equal
`tag_bt709` output on a cv2-written mp4 and on hand-built boxes),
`video.framing` (equal results on a cv2-written clip), `serve.config`
(`_parse_fast` and the environment's names), and the port's own
`utils.memory` (`MemoryMonitor`: the card by default, zeros on an
explicit CPU device, the pressure bands, JSON export) and
`utils.profiling` (`StageTimer`, `trace`)."""
import importlib
import json
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
import torch

from rife_tpu.serve import config as ref_config
from rife_tpu.video import framing as ref_framing
from rife_tpu.video import mp4meta as ref_mp4
from rife_tpu_torch.serve import config
from rife_tpu_torch.utils import memory, profiling
from rife_tpu_torch.video import framing, mp4meta

from test_torch_serve import write_clip


def box(kind: bytes, payload: bytes, large=False) -> bytes:
    if large:
        return struct.pack(">I", 1) + kind + struct.pack(">Q", 16 + len(payload)) + payload
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def movie(entry=b"avc1", children=b"", moov_first=False, large_moov=False) -> bytes:
    """ftyp, mdat and a moov whose first sample entry is `entry` (a 78-byte
    VisualSampleEntry header, then `children`)."""
    sample = box(entry, bytes(range(78)) + children)
    stsd = box(b"stsd", struct.pack(">II", 0, 1) + sample)
    stbl = box(b"stbl", stsd + box(b"stco", b"\0" * 8))
    trak = box(b"trak", box(b"tkhd", b"\0" * 12) + box(b"mdia", box(b"minf", stbl)))
    moov = box(b"moov", box(b"mvhd", b"\0" * 20) + trak, large=large_moov)
    head, mdat = box(b"ftyp", b"isom\0\0\0\0"), box(b"mdat", b"\x01" * 64)
    return head + (moov + mdat if moov_first else mdat + moov)


CASES = {
    "avc1": movie(),
    "mp4v with a child": movie(b"mp4v", box(b"esds", b"\0" * 10)),
    "64-bit moov": movie(large_moov=True),
    "already tagged": movie(children=box(b"colr", b"nclx" + struct.pack(">HHHB", 9, 9, 9, 0))),
    "moov before mdat": movie(moov_first=True),
    "unknown entry": movie(b"abcd"),
    "no moov": box(b"ftyp", b"isom") + box(b"mdat", b"\0" * 8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tag_bt709_byte_equal_on_hand_built_boxes(tmp_path, name):
    data = CASES[name]
    mine, theirs = tmp_path / "p.mp4", tmp_path / "r.mp4"
    mine.write_bytes(data)
    theirs.write_bytes(data)
    assert mp4meta.tag_bt709(str(mine)) == ref_mp4.tag_bt709(str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    assert mp4meta.read_colr(str(mine)) == ref_mp4.read_colr(str(theirs))
    if name in ("avc1", "mp4v with a child"):
        assert mp4meta.read_colr(str(mine)) == (1, 1, 1)
        assert len(mine.read_bytes()) == len(data) + 19
    if name == "64-bit moov":
        # The reference reads a 64-bit box's children from 8 bytes in, not
        # 16, so it finds no trak there and leaves the file as it was; the
        # port keeps that (cv2 and ffmpeg write 32-bit moov boxes).
        assert mine.read_bytes() == data


def test_tag_bt709_byte_equal_on_a_cv2_mp4(tmp_path):
    src = write_clip(tmp_path / "in.mp4", 4, 10)
    mine, theirs = str(tmp_path / "p.mp4"), str(tmp_path / "r.mp4")
    shutil.copy(src, mine)
    shutil.copy(src, theirs)
    assert mp4meta.read_colr(mine) is None
    assert mp4meta.tag_bt709(mine) is True and ref_mp4.tag_bt709(theirs) is True
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert mp4meta.read_colr(mine) == (1, 1, 1)
    size = os.path.getsize(mine)
    assert mp4meta.tag_bt709(mine) is True and os.path.getsize(mine) == size  # idempotent
    cap = cv2.VideoCapture(mine)
    assert cap.read()[0]  # still decodes


def test_framing_equals_reference(tmp_path):
    src = write_clip(tmp_path / "in.mp4", 5, 12)
    other = write_clip(tmp_path / "b.mp4", 3, 24, h=32)
    assert framing.get_video_info(src) == ref_framing.get_video_info(src)
    for pos in ("first", "last"):
        np.testing.assert_array_equal(framing.extract_boundary_frame(src, pos),
                                      ref_framing.extract_boundary_frame(src, pos))
    for a, b in ((src, src), (src, other)):
        assert framing.validate_temporal_alignment(a, b) == \
            ref_framing.validate_temporal_alignment(a, b)
    assert framing.validate_temporal_alignment(src, other)["issues"] == \
        ["resolution mismatch", "fps mismatch"]
    frame = (np.random.default_rng(0).random((8, 8, 3)) * 255).astype(np.uint8)
    for f in (frame, frame // 40, 255 - frame // 40):
        assert framing.frame_quality(f) == ref_framing.frame_quality(f)
    n = framing.extract_frames(src, str(tmp_path / "p"), limit=3)
    assert n == ref_framing.extract_frames(src, str(tmp_path / "r"), limit=3) == 3
    for f in sorted(os.listdir(tmp_path / "p")):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p" / f)),
                                      cv2.imread(str(tmp_path / "r" / f)))
    with pytest.raises(FileNotFoundError):
        framing.get_video_info(str(tmp_path / "none.mp4"))


def test_boundary_frame_skips_black_frames(tmp_path):
    path = str(tmp_path / "dark.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for v in (0, 0, 128, 200, 0):
        wr.write(np.full((32, 32, 3), v, np.uint8))
    wr.release()
    for pos in ("first", "last"):
        got = framing.extract_boundary_frame(path, pos)
        np.testing.assert_array_equal(got, ref_framing.extract_boundary_frame(path, pos))
        assert got.mean() > 0.3


@pytest.mark.parametrize("v", ["", "false", "true", "0", "1", "3"])
def test_parse_fast_equals_reference(v):
    assert config._parse_fast(v) == ref_config._parse_fast(v)


def test_config_reads_the_ports_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("RIFE_TPU_TORCH_BASE", str(tmp_path))
    monkeypatch.setenv("RIFE_TPU_TORCH_PORT", "7123")
    monkeypatch.setenv("RIFE_TPU_TORCH_FAST", "0")
    monkeypatch.setenv("RIFE_TPU_FAST", "3")  # the reference's: not read by the port
    monkeypatch.setenv("AUTH_USERNAME", "u")
    try:
        c = importlib.reload(config)
        assert (c.BASE_DIR, c.MODEL_DIR) == (tmp_path, tmp_path / "train_log")
        assert (c.SERVER_PORT, c.FAST_MODE, c.AUTH_USERNAME) == (7123, 0, "u")
        assert c.UPLOAD_DIR == tmp_path / "temp" / "uploads"
        monkeypatch.setenv("RIFE_TPU_TORCH_MODEL_DIR", str(tmp_path / "m"))
        monkeypatch.delenv("RIFE_TPU_TORCH_FAST")
        c = importlib.reload(config)
        assert c.MODEL_DIR == tmp_path / "m" and c.FAST_MODE == 1  # the default rung
        c.ensure_dirs()
        assert all(d.is_dir() for d in (c.UPLOAD_DIR, c.OUTPUT_DIR, c.FRAMES_DIR))
    finally:
        monkeypatch.undo()
        importlib.reload(config)


def test_memory_monitor_on_an_explicit_cpu_device(tmp_path):
    mon = memory.MemoryMonitor("cpu")
    s = mon.snapshot("t")
    assert {k: s[k] for k in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use",
                              "utilization")} == {"bytes_in_use": 0, "bytes_limit": 0,
                                                  "peak_bytes_in_use": 0, "utilization": 0.0}
    assert s["pressure"] == "normal" and s["label"] == "t"
    assert mon.recommend_disk_based(10000, 4096, 4096) is False
    mon.export_json(str(tmp_path / "m.json"))
    assert json.loads((tmp_path / "m.json").read_text())[0]["label"] == "t"
    assert [memory.MemoryMonitor.pressure(u) for u in (0.5, 0.75, 0.85, 0.95)] == \
        ["normal", "moderate", "high", "critical"]


def test_memory_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory.MemoryMonitor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory.hbm_stats()


def test_memory_reads_the_allocator_and_the_card(monkeypatch):
    """On a card: bytes from the allocator's stats, the limit from
    mem_get_info, the high band for the disk-based recommendation."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
        "allocated_bytes.all.current": 80, "allocated_bytes.all.peak": 90})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (10, 100))
    s = memory.hbm_stats()
    assert s == {"bytes_in_use": 80, "bytes_limit": 100, "peak_bytes_in_use": 90,
                 "utilization": 0.8}
    mon = memory.MemoryMonitor()
    assert mon.snapshot()["pressure"] == "moderate"
    assert mon.recommend_disk_based(1, 1, 1, bytes_per_px=5) is True
    assert mon.recommend_disk_based(1, 1, 1, bytes_per_px=4) is False


def test_monitor_memory_decorator():
    calls = []

    @memory.monitor_memory("job", device="cpu")
    def job(x):
        calls.append(x)
        return 2 * x

    assert job(3) == 6 and calls == [3]


def test_stage_timer():
    t = profiling.StageTimer()
    for _ in range(2):
        with t.stage("decode"):
            pass
    with pytest.raises(ValueError):
        with t.stage("infer"):
            raise ValueError
    rep = t.report()
    assert rep["decode"]["count"] == 2 and rep["infer"]["count"] == 1
    assert set(rep["decode"]) == {"total_s", "count", "mean_ms"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    with profiling.trace(str(tmp_path / "t")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / "t").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in json.loads(files[0].read_text())
