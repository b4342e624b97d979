"""Metric logging: JSONL always, TensorBoard when it imports (a copy of
rife_tpu/utils/logging.py).  Scalars land in {log_dir}/metrics.jsonl, one
record per call: {"tag", "step", "time", **scalars}; image panels in
{log_dir}/panels/step_{step:08d}/{tag}.png (and TensorBoard)."""
from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def log(self, tag: str, step: int, scalars: dict):
        rec = {"tag": tag, "step": step, "time": time.time(), **scalars}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(f"{tag}/{k}", v, step)

    def log_image(self, tag: str, step: int, img_u8) -> str:
        """An (H, W, 3) uint8 image -> TensorBoard (where it imports) and a
        PNG under the log directory; returns the PNG's path."""
        if self.tb is not None:
            self.tb.add_image(tag, img_u8, step, dataformats="HWC")
            self.tb.flush()
        from rife_tpu_torch.utils.viz import save_png

        path = os.path.join(self.log_dir, "panels", f"step_{step:08d}",
                            tag.replace("/", "_") + ".png")
        save_png(path, img_u8)
        return path

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()
