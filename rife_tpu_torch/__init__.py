"""PyTorch/CUDA port of rife_tpu (RIFE frame interpolation) for NVIDIA Hopper.

Layout mirrors rife_tpu: `ops/` (warp, resizes, padding), `ops/cuda/` and
`csrc/` (the hand-written CUDA kernels, counterparts of `ops/pallas/`),
`nn/`, `models/`, `engine/`.  Tensors are NCHW planes inside; the engine's
API takes and returns NHWC like the reference's.  This package imports
neither JAX nor rife_tpu.
"""
