"""hypervla_tpu_torch: the PyTorch/CUDA port of hypervla_tpu.

Mirrors the JAX package's module paths (models/, models/encoders/, ops/,
eval/, train/, utils/). Plain tensor code is PyTorch; the Pallas TPU
kernels on the ported path are hand-written CUDA kernels for Hopper
(csrc/), each with a plain PyTorch version beside it that the CPU runs.
Parameters keep the JAX package's key paths ("encoder/image_encoder/...")
and flax's (in, out) Dense layout, so a param tree moves between the two
packages unchanged (utils/convert.py).
"""
