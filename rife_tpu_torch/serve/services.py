"""Service-layer operations over the engine (port of
rife_tpu/serve/services.py; reference rife_app/services/).

- interpolate_pair_to_video: image pair -> interpolated clip with the
  app's padding contract (centred, min 512, %32 — framing.py:216-253),
  passes-of-2x doubling or disk-based mode
  (services/image_interpolator.py:13-126).
- interpolate_video_file: streaming multi-pass video interpolation
  (services/video_interpolator.py:25-205) over the threaded pipeline.
- chained_transitions: video chaining with interpolated transition
  segments between boundary frames (services/chained.py:19-339).
- reencode_video: standards-checking re-encode
  (services/simple_reencoder.py:18-436) — ffmpeg one-pass when
  available, cv2 rebuild otherwise.

Each frame goes to `engine.device` once, is padded there, and is cropped
there before it is fetched.  Encoding uses ffmpeg (libx264 CRF18 BT.709 —
the reference's quality contract, image_interpolator.py:90-106) when the
binary exists and falls back to cv2's mp4 writer otherwise.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from rife_tpu_torch.engine import DiskInterpolator, InferenceEngine, exp_doubling
from rife_tpu_torch.native import f32_to_u8, u8_to_f32
from rife_tpu_torch.ops import pad_centered
from rife_tpu_torch.video import (VideoJob, VideoReader, VideoWriter, have_ffmpeg,
                                  interpolate_video, transfer_audio)
from rife_tpu_torch.video.framing import extract_boundary_frame, get_video_info

FFMPEG_QUALITY = [
    "-c:v", "libx264", "-preset", "slow", "-crf", "18",
    "-pix_fmt", "yuv420p",
    "-color_primaries", "bt709", "-color_trc", "bt709", "-colorspace", "bt709",
]


def _encode_frames(frames01: list[np.ndarray], out_path: str, fps: float):
    """PNG dump + ffmpeg libx264/CRF18/BT.709, cv2 fallback.

    The [0,1]->u8 rounding runs through the native frame ops (threaded
    C++; numpy where there is no g++)."""
    import cv2

    h, w = frames01[0].shape[:2]
    if have_ffmpeg():
        with tempfile.TemporaryDirectory() as td:
            for i, f in enumerate(frames01):
                cv2.imwrite(os.path.join(td, f"{i:07d}.png"), f32_to_u8(f)[..., ::-1])
            cmd = ["ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
                   "-framerate", str(fps), "-i", os.path.join(td, "%07d.png"),
                   *FFMPEG_QUALITY, out_path]
            subprocess.run(cmd, check=True)
        return
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames01:
        writer.write(f32_to_u8(f)[..., ::-1])
    writer.release()
    # cv2 cannot tag color metadata; patch a BT.709 colr atom in post so
    # the fallback matches the ffmpeg path's always-tagged contract
    # (reference image_interpolator.py:90-106).
    from rife_tpu_torch.video.mp4meta import tag_bt709

    tag_bt709(out_path)


def _on_device(engine: InferenceEngine, img01: np.ndarray):
    """An HWC [0, 1] frame -> (1, H', W', 3) on the engine's device, padded
    centred to %32 and at least 512 there, with its Padding."""
    x = torch.from_numpy(np.ascontiguousarray(img01[None], dtype=np.float32))
    return pad_centered(x.to(engine.device), 32, 512)


def _fetch(frame: torch.Tensor, pad) -> np.ndarray:
    """A padded (1, H', W', 3) frame -> the cropped HWC float32 frame on the
    host (cropped on the device, one fetch)."""
    return pad.crop(frame)[0].float().cpu().numpy()


def interpolate_pair_to_video(engine: InferenceEngine, img0: np.ndarray,
                              img1: np.ndarray, out_path: str, *,
                              passes: int = 4, fps: float = 25.0,
                              disk_based: bool = False,
                              workdir: str | None = None) -> dict:
    """img0/img1: HWC float RGB [0,1].  2^passes - 1 intermediates."""
    if disk_based:
        # The spill works on host frames: pad on the host, the interpolator
        # uploads one pair at a time.
        a, pad = pad_centered(torch.from_numpy(np.ascontiguousarray(img0, np.float32)), 32, 512)
        b, _ = pad_centered(torch.from_numpy(np.ascontiguousarray(img1, np.float32)), 32, 512)
        di = DiskInterpolator(engine, workdir or tempfile.mkdtemp(prefix="rife_disk_"))
        padded = di.interpolate([a.numpy(), b.numpy()], (1 << passes) + 1)
        frames = [np.ascontiguousarray(pad.crop(torch.from_numpy(f)).numpy())
                  for f in padded]
        di.cleanup()
    else:
        a, pad = _on_device(engine, img0)
        b, _ = _on_device(engine, img1)
        frames = [_fetch(f, pad) for f in exp_doubling(engine, [a, b], passes)]
    _encode_frames(frames, out_path, fps)
    return {"frames": len(frames), "output": out_path, "disk_based": disk_based}


def interpolate_video_file(engine: InferenceEngine, in_path: str, out_path: str, *,
                           exp: int = 1, keep_audio: bool = True) -> dict:
    reader = VideoReader(in_path)
    writer = VideoWriter(out_path, reader.fps * (1 << exp), reader.width, reader.height)
    job = VideoJob(exp=exp, use_timestep=engine.supports_timestep)
    stats = interpolate_video(engine, reader, writer, job)
    writer.close()
    if keep_audio:
        stats["audio"] = transfer_audio(in_path, out_path)
    return stats


def _transition_frames(engine: InferenceEngine, before: str, after: str,
                       passes: int) -> list[np.ndarray]:
    """Interpolated frames bridging `before`'s last and `after`'s first."""
    last = extract_boundary_frame(before, "last")
    first = extract_boundary_frame(after, "first")
    a, pad = _on_device(engine, last)
    b, _ = _on_device(engine, first)
    mids = exp_doubling(engine, [a, b], passes)[1:-1]
    return [_fetch(m, pad) for m in mids]


def _read_frames01(path: str) -> tuple[list[np.ndarray], float]:
    """A video's frames as HWC float32 RGB in [0, 1], and its fps."""
    reader = VideoReader(path)
    return [u8_to_f32(f) for f in reader], reader.fps


def chained_transitions(engine: InferenceEngine, videos: list[str], out_path: str, *,
                        transition_passes: int = 4, fps: float | None = None) -> dict:
    """Concatenate videos with interpolated transitions between boundary
    frames (services/chained.py:19-339).  Output fps follows the first
    video unless given.

    With ffmpeg present this mirrors the reference's segment pipeline
    (chained.py:227-313): inputs whose fps differs from the target are
    re-encoded to it, matching inputs are used untouched, transitions
    are written as their own segments, and the result is stitched with
    the concat demuxer + `-c copy` (no decode of the sources, O(1)
    memory) — falling back to a re-encode concat if stream copy fails
    (e.g. heterogeneous source codecs).  Without ffmpeg: in-RAM cv2
    decode + re-encode.
    """
    assert len(videos) >= 2
    fps = fps or get_video_info(videos[0])["fps"]

    if not have_ffmpeg():
        all_frames: list[np.ndarray] = []
        for vi, path in enumerate(videos):
            all_frames.extend(_read_frames01(path)[0])
            if vi < len(videos) - 1:
                all_frames.extend(
                    _transition_frames(engine, path, videos[vi + 1], transition_passes))
        _encode_frames(all_frames, out_path, fps)
        return {"videos": len(videos), "frames": len(all_frames),
                "output": out_path, "mode": "cv2"}

    normalized = 0
    with tempfile.TemporaryDirectory(prefix="rife_chain_") as td:
        segments: list[str] = []
        for vi, path in enumerate(videos):
            if abs(get_video_info(path)["fps"] - fps) > 0.01:
                seg = os.path.join(td, f"seg{vi}.mp4")
                subprocess.run(
                    ["ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
                     "-i", path, "-r", str(fps), *FFMPEG_QUALITY, "-an", seg],
                    check=True)
                segments.append(seg)
                normalized += 1
            else:
                segments.append(os.path.abspath(path))
            if vi < len(videos) - 1:
                trans = os.path.join(td, f"trans{vi}.mp4")
                _encode_frames(
                    _transition_frames(engine, path, videos[vi + 1], transition_passes),
                    trans, fps)
                segments.append(trans)

        concat_list = os.path.join(td, "concat.txt")
        with open(concat_list, "w") as f:
            for seg in segments:
                f.write(f"file '{seg}'\n")
        copy_cmd = ["ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
                    "-f", "concat", "-safe", "0", "-i", concat_list,
                    "-c", "copy", "-an", out_path]
        mode = "concat_copy"
        if subprocess.run(copy_cmd).returncode != 0:
            subprocess.run(
                ["ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
                 "-f", "concat", "-safe", "0", "-i", concat_list,
                 *FFMPEG_QUALITY, "-an", out_path],
                check=True)
            mode = "concat_reencode"
    return {"videos": len(videos), "segments": len(segments),
            "fps_normalized": normalized, "output": out_path, "mode": mode}


def reencode_video(in_path: str, out_path: str) -> dict:
    """Standards-checking re-encode (services/simple_reencoder.py)."""
    from rife_tpu_torch.serve.analyzer import analyze_video, is_compliant

    analysis = analyze_video(in_path)
    if is_compliant(analysis):
        shutil.copyfile(in_path, out_path)
        return {"action": "copied", "analysis": analysis}
    if have_ffmpeg():
        cmd = ["ffmpeg", "-y", "-hide_banner", "-loglevel", "error", "-i", in_path,
               *FFMPEG_QUALITY, "-c:a", "aac", "-b:a", "192k", "-ar", "16000", out_path]
        subprocess.run(cmd, check=True)
        return {"action": "reencoded_ffmpeg", "analysis": analysis}
    frames, fps = _read_frames01(in_path)
    _encode_frames(frames, out_path, fps)
    return {"action": "reencoded_cv2", "analysis": analysis}
