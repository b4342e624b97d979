from rife_tpu_torch.models.ifnet import IFBlock, IFNet, IFNetConfig
from rife_tpu_torch.models.legacy import HD, HDConfig, HDv2, HDv2Config
from rife_tpu_torch.models.refine import ContextNet, UNet
from rife_tpu_torch.models.registry import (MODEL_REGISTRY, ModelDef,
                                            detect_model_from_state_dict,
                                            get_model_def)
from rife_tpu_torch.models.v425 import V425, V425Config

__all__ = ["IFBlock", "IFNet", "IFNetConfig", "ContextNet", "UNet", "HD",
           "HDConfig", "HDv2", "HDv2Config", "MODEL_REGISTRY", "ModelDef",
           "detect_model_from_state_dict", "get_model_def", "V425", "V425Config"]
