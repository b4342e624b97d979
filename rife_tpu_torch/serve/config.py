"""Service configuration (port of rife_tpu/serve/config.py; reference
rife_app/config.py:1-20).

The port reads its own variables, `RIFE_TPU_TORCH_BASE`, `_MODEL_DIR`,
`_PORT` and `_FAST`, where the reference reads `RIFE_TPU_*`;
`AUTH_USERNAME`, `AUTH_PASSWORD` and `GRADIO_SERVER_NAME` keep their
names.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_PREFIX = "RIFE_TPU_TORCH_"
BASE_DIR = Path(os.environ.get(ENV_PREFIX + "BASE", Path.cwd()))
MODEL_DIR = Path(os.environ.get(ENV_PREFIX + "MODEL_DIR", BASE_DIR / "train_log"))
TEMP_DIR = BASE_DIR / "temp"
UPLOAD_DIR = TEMP_DIR / "uploads"
OUTPUT_DIR = TEMP_DIR / "outputs"
FRAMES_DIR = TEMP_DIR / "frames"

DEFAULT_FPS = 25
SERVER_NAME = os.environ.get("GRADIO_SERVER_NAME", "0.0.0.0")
SERVER_PORT = int(os.environ.get(ENV_PREFIX + "PORT", "7860"))
AUTH_USERNAME = os.environ.get("AUTH_USERNAME")
AUTH_PASSWORD = os.environ.get("AUTH_PASSWORD")
# The serving rung of the approximation ladder (`InferenceEngine(fast=)`):
# 0 = the exact graph, 1 = consumer-res coarse-level warps, 2 = + half-res
# refine stage, 3 = + half-res final flow level, 4 = no refine stage.  The
# default is the reference's, rung 1: the highest that held the trained
# checkpoint's protocol within 0.05 dB of exact f32.  RIFE_TPU_TORCH_FAST=0
# serves the exact graph; the serving graph is logged at startup
# (serve/app.py).
FAST_ENV = ENV_PREFIX + "FAST"


def _parse_fast(v: str) -> int:
    if v in ("", "false"):
        return 0
    if v == "true":
        return 1
    return int(v)


FAST_MODE = _parse_fast(os.environ.get(FAST_ENV, "1"))


def ensure_dirs():
    for d in (TEMP_DIR, UPLOAD_DIR, OUTPUT_DIR, FRAMES_DIR):
        d.mkdir(parents=True, exist_ok=True)
