"""pycricodecs_tpu_torch: the PyTorch + CUDA port of pycricodecs_tpu.

The batched HCA bank decode and encode, the batched ADX decode and encode,
the batched AHX (MPEG Layer II) decode and the HCA key search run on one
NVIDIA Hopper GPU through hand-written CUDA kernels (csrc/), built with
nvcc at first use; every kernel has a plain PyTorch twin that a CPU tensor
runs instead. Output is byte-equal to the JAX package. This package never
imports jax or pycricodecs_tpu.
"""
from .models.hca import crypt
from .ops.hca_frame import HcaInfo
from .parallel import (DecodeStats, adx_decode_batch, adx_encode_batch,
                       ahx_decode_batch, decode_batch, find_key,
                       hca_encode_batch, rank_keys, score_key)

__all__ = ["DecodeStats", "HcaInfo", "adx_decode_batch", "adx_encode_batch",
           "ahx_decode_batch", "crypt", "decode_batch", "find_key",
           "hca_encode_batch", "rank_keys", "score_key"]
