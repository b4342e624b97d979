from rife_tpu_torch.engine.checkpoint import (find_checkpoint, load_checkpoint, load_params,
                                              state_dict_from_jax)
from rife_tpu_torch.engine.disk_interp import DiskInterpolator
from rife_tpu_torch.engine.inference import (DTYPES, InferenceEngine, build_engine,
                                             resolve_device)
from rife_tpu_torch.engine.schedule import (bisect_to_ratio, exp_doubling,
                                            midpoint_tree, timestep_frames)

__all__ = ["DTYPES", "DiskInterpolator", "InferenceEngine", "bisect_to_ratio",
           "build_engine", "exp_doubling", "find_checkpoint", "load_checkpoint",
           "load_params", "midpoint_tree", "resolve_device", "state_dict_from_jax",
           "timestep_frames"]
