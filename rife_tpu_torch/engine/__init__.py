from rife_tpu_torch.engine.checkpoint import (load_checkpoint, load_params,
                                              state_dict_from_jax)
from rife_tpu_torch.engine.inference import InferenceEngine, resolve_device

__all__ = ["InferenceEngine", "load_checkpoint", "load_params",
           "resolve_device", "state_dict_from_jax"]
