"""Video: the streaming pipeline and its IO (port of rife_tpu/video)."""
from rife_tpu_torch.video.io import (PngDirReader, PngDirWriter, VideoReader, VideoWriter,
                                     have_ffmpeg, transfer_audio)
from rife_tpu_torch.video.pipeline import VideoJob, interpolate_video

__all__ = [
    "VideoReader",
    "VideoWriter",
    "PngDirReader",
    "PngDirWriter",
    "transfer_audio",
    "have_ffmpeg",
    "interpolate_video",
    "VideoJob",
]
