"""Training data (numpy only): Vimeo90K triplets, synthetic triplets and
the batch iterator."""
from rife_tpu_torch.data.vimeo import SyntheticTriplets, VimeoTriplets, batch_iterator

__all__ = ["SyntheticTriplets", "VimeoTriplets", "batch_iterator"]
