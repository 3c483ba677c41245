"""pycricodecs_tpu_torch: the PyTorch + CUDA port of pycricodecs_tpu.

The batched HCA bank decode runs on one NVIDIA Hopper GPU through three
hand-written CUDA kernels (csrc/), built with nvcc at first use; every kernel
has a plain PyTorch twin that a CPU tensor runs instead. Output is byte-equal
to the JAX package. This package never imports jax or pycricodecs_tpu.
"""
from .ops.hca_frame import HcaInfo
from .parallel import DecodeStats, decode_batch

__all__ = ["DecodeStats", "HcaInfo", "decode_batch"]
