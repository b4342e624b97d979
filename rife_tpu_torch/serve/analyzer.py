"""Video standards analysis (port of rife_tpu/serve/analyzer.py; reference
rife_app/utils/video_analyzer.py:10-201).

Uses ffprobe JSON when the binary exists, else cv2 properties.  The
compliance table mirrors the reference: H.264 / yuv420p / BT.709 /
AAC-16kHz, with 30000/1001-style fps handling
(simple_reencoder.py:250-287).
"""
from __future__ import annotations

import json
import shutil
import subprocess
from fractions import Fraction

STANDARDS = {
    "codec": "h264",
    "pix_fmt": "yuv420p",
    "color_space": "bt709",
    "audio_codec": "aac",
    "audio_sample_rate": 16000,
}


def _parse_fps(rate: str) -> float:
    try:
        return float(Fraction(rate))
    except (ValueError, ZeroDivisionError):
        return 0.0


def _from_ffprobe(data: dict) -> dict:
    """The analysis of ffprobe's `-show_streams -show_format` JSON."""
    video = next((s for s in data.get("streams", []) if s.get("codec_type") == "video"), {})
    audio = next((s for s in data.get("streams", []) if s.get("codec_type") == "audio"), {})
    # color_trc field-name fallbacks (video_analyzer.py:81-97)
    trc = video.get("color_transfer") or video.get("color_trc") or ""
    return {
        "source": "ffprobe",
        "codec": video.get("codec_name", ""),
        "pix_fmt": video.get("pix_fmt", ""),
        "color_space": video.get("color_space", "") or trc,
        "width": video.get("width", 0),
        "height": video.get("height", 0),
        "fps": _parse_fps(video.get("r_frame_rate", "0/1")),
        "audio_codec": audio.get("codec_name", ""),
        "audio_sample_rate": int(audio.get("sample_rate", 0) or 0),
    }


def analyze_video(path: str) -> dict:
    if shutil.which("ffprobe"):
        out = subprocess.run(
            ["ffprobe", "-v", "quiet", "-print_format", "json",
             "-show_streams", "-show_format", path],
            capture_output=True, text=True,
        )
        if out.returncode == 0:
            return _from_ffprobe(json.loads(out.stdout or "{}"))
    from rife_tpu_torch.video.framing import get_video_info

    info = get_video_info(path)
    return {
        "source": "cv2",
        "codec": info["codec"].lower(),
        "pix_fmt": "",
        "color_space": "",
        "width": info["width"],
        "height": info["height"],
        "fps": info["fps"],
        "audio_codec": "",
        "audio_sample_rate": 0,
    }


def is_compliant(analysis: dict) -> bool:
    if analysis.get("source") != "ffprobe":
        return False  # cannot verify without ffprobe -> re-encode
    checks = [
        analysis["codec"] == STANDARDS["codec"],
        analysis["pix_fmt"] == STANDARDS["pix_fmt"],
        STANDARDS["color_space"] in (analysis["color_space"] or ""),
        (not analysis["audio_codec"])
        or (analysis["audio_codec"] == STANDARDS["audio_codec"]
            and analysis["audio_sample_rate"] == STANDARDS["audio_sample_rate"]),
    ]
    return all(checks)
