"""Training data (numpy only): Vimeo90K triplets and septuplets, their
synthetic stand-ins and the batch iterator."""
from rife_tpu_torch.data.vimeo import (SyntheticSeptuplets, SyntheticTriplets,
                                       VimeoSeptuplets, VimeoTriplets, batch_iterator)

__all__ = ["SyntheticSeptuplets", "SyntheticTriplets", "VimeoSeptuplets",
           "VimeoTriplets", "batch_iterator"]
