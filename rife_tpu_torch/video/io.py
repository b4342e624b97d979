"""Video decode and encode, and the audio remux (port of
rife_tpu/video/io.py; reference inference_video.py:16-54, 113-152).

mp4 or numbered-PNG-directory input, cv2 video or PNG-directory output,
and the ffmpeg remux chain lossless copy -> AAC transcode -> silent.
ffmpeg is optional: without it the output keeps no audio.  cv2 is
imported where it is used, so the port imports without it.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from rife_tpu_torch.native import u8_to_f32


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


class VideoReader:
    """cv2 sequential reader yielding RGB HWC uint8 frames (the pipeline
    normalises them on the device)."""

    def __init__(self, path: str):
        import cv2

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 25.0
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def __iter__(self):
        while True:
            ok, frame = self.cap.read()
            if not ok:
                break
            yield np.ascontiguousarray(frame[..., ::-1])
        self.cap.release()


class PngDirReader:
    """Numbered-PNG directory input (inference_video.py:133-140), frames as
    float32 RGB in [0, 1]."""

    def __init__(self, path: str, fps: float = 25.0):
        import cv2

        self.files = sorted(
            (f for f in os.listdir(path) if f.lower().endswith(".png")),
            key=lambda f: int("".join(ch for ch in os.path.splitext(f)[0] if ch.isdigit()) or 0),
        )
        if not self.files:
            raise FileNotFoundError(f"no .png frames in {path}")
        self.path = path
        self.fps = fps
        self.frame_count = len(self.files)
        probe = cv2.imread(os.path.join(path, self.files[0]))
        self.height, self.width = probe.shape[:2]

    def __iter__(self):
        import cv2

        for f in self.files:
            img = cv2.imread(os.path.join(self.path, f))
            yield u8_to_f32(img[..., ::-1])


class VideoWriter:
    def __init__(self, path: str, fps: float, width: int, height: int, codec: str = "mp4v"):
        import cv2

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*codec), fps, (width, height)
        )
        self.path = path

    def write(self, frame_u8_rgb: np.ndarray):
        self.writer.write(frame_u8_rgb[..., ::-1])

    def close(self):
        self.writer.release()


class PngDirWriter:
    def __init__(self, path: str, **_):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.idx = 0

    def write(self, frame_u8_rgb: np.ndarray):
        import cv2

        cv2.imwrite(os.path.join(self.path, f"{self.idx:0>7d}.png"), frame_u8_rgb[..., ::-1])
        self.idx += 1

    def close(self):
        pass


def _run_quiet(cmd: list[str]) -> bool:
    try:
        r = subprocess.run(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return r.returncode == 0
    except OSError:
        return False


def transfer_audio(source_video: str, target_video: str) -> str:
    """Remux the audio of `source_video` into `target_video`: a lossless
    stream copy, else an AAC transcode, else the output stays silent.
    Returns what happened, for the log."""
    if not have_ffmpeg():
        return "no-ffmpeg: output keeps no audio"
    base = target_video + ".noaudio.mp4"
    os.replace(target_video, base)
    ok = _run_quiet([
        "ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
        "-i", base, "-i", source_video,
        "-c", "copy", "-map", "0:v:0", "-map", "1:a:0", target_video,
    ]) and os.path.getsize(target_video) > 0
    if ok:
        os.remove(base)
        return "audio copied losslessly"
    ok = _run_quiet([
        "ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
        "-i", base, "-i", source_video,
        "-c:v", "copy", "-c:a", "aac", "-b:a", "160k",
        "-map", "0:v:0", "-map", "1:a:0", target_video,
    ]) and os.path.exists(target_video) and os.path.getsize(target_video) > 0
    if ok:
        os.remove(base)
        return "audio transcoded to AAC"
    os.replace(base, target_video)
    return "audio transfer failed: output keeps no audio"
