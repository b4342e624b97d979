"""Metric logging: JSONL always, TensorBoard when it imports (a copy of
rife_tpu/utils/logging.py without the image panels, which the port does
not draw yet).  Scalars land in {log_dir}/metrics.jsonl, one record per
call: {"tag", "step", "time", **scalars}."""
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

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()
