"""Quality metrics of the benchmark protocols (numpy only)."""
from rife_tpu_torch.metrics.quality import (interpolation_error, psnr,
                                            psnr_uint8_protocol, rgb_to_y)

__all__ = ["psnr", "psnr_uint8_protocol", "interpolation_error", "rgb_to_y"]
