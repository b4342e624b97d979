from rife_tpu_torch.nn.init import init_torch_default_
from rife_tpu_torch.nn.layers import (ConvPReLU, DeconvPReLU, SEResBlock,
                                     conv2d, conv_prelu, conv_transpose2d,
                                     leaky_relu, pixel_shuffle, prelu)

__all__ = ["ConvPReLU", "DeconvPReLU", "SEResBlock", "conv2d", "conv_prelu",
           "conv_transpose2d", "init_torch_default_", "leaky_relu",
           "pixel_shuffle", "prelu"]
