from rife_tpu_torch.models.ifnet import IFBlock, IFNet, IFNetConfig
from rife_tpu_torch.models.refine import ContextNet, UNet
from rife_tpu_torch.models.registry import MODEL_REGISTRY, ModelDef, get_model_def
from rife_tpu_torch.models.v425 import V425, V425Config

__all__ = ["IFBlock", "IFNet", "IFNetConfig", "ContextNet", "UNet",
           "MODEL_REGISTRY", "ModelDef", "get_model_def", "V425", "V425Config"]
