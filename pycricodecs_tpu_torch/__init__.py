"""pycricodecs_tpu_torch: the PyTorch + CUDA port of pycricodecs_tpu.

The batched HCA bank decode and encode, the batched ADX decode and encode,
the batched AHX (MPEG Layer II) decode and encode, the AWB/ACB bank decode
and the HCA key search run on one NVIDIA Hopper GPU through hand-written
CUDA kernels (csrc/), built with nvcc at first use; every kernel has a plain PyTorch twin
that a CPU tensor runs instead. The single-file surfaces (ADX, HCA, AHX),
the frame-range decode (models.hca.decode_range), the single-frame key test
(ops.hca_frame.test_block), the Layer II decode (models.ahx.decode_mp2)
and the command line (`python -m pycricodecs_tpu_torch`) run through the
same kernels; the batch entry points also shard over a mesh of devices
(`parallel.make_mesh`, `mesh=`); the container readers (UTF, AWB, ACB),
builders (UTFBuilder, AWBBuilder, ACBBuilder) and CRILAYLA are host code,
and `cricodecs` is the CriCodecs drop-in module. Output is byte-equal to the JAX package. This package never imports jax or
pycricodecs_tpu.
"""
from .containers.acb import ACB, ACBBuilder
from .containers.awb import AWB, AWBBuilder
from .containers.utf import UTF, UTFBuilder
from .models.adx import ADX
from .models.ahx import AHX
from .models.hca import HCA, crypt
from .ops.hca_frame import HcaInfo
from .parallel import (DecodeStats, adx_decode_batch, adx_encode_batch,
                       ahx_decode_batch, ahx_encode_batch, decode_acb,
                       decode_awb, decode_batch, encode_batch, find_key,
                       hca_encode_batch, rank_keys, score_key)

__all__ = ["ACB", "ACBBuilder", "ADX", "AHX", "AWB", "AWBBuilder",
           "DecodeStats", "HCA", "HcaInfo", "UTF", "UTFBuilder",
           "adx_decode_batch", "adx_encode_batch", "ahx_decode_batch",
           "ahx_encode_batch", "crypt", "decode_acb", "decode_awb",
           "decode_batch", "encode_batch", "find_key", "hca_encode_batch",
           "rank_keys", "score_key"]
