"""pycricodecs_tpu_torch: the PyTorch + CUDA port of pycricodecs_tpu.

The batched HCA bank decode and encode, the batched ADX decode and encode,
the batched AHX (MPEG Layer II) decode and encode, the AWB/ACB bank decode,
the HCA key search and CRILAYLA (de)compression run on one NVIDIA Hopper
GPU through hand-written CUDA kernels (csrc/), built with nvcc at first
use; every kernel has a plain version that a CPU tensor runs instead. The
single-file surfaces (ADX, HCA, AHX),
the frame-range decode (models.hca.decode_range), the single-frame key test
(ops.hca_frame.test_block), the Layer II decode (models.ahx.decode_mp2)
and the command line (`python -m pycricodecs_tpu_torch`) run through the
same kernels; the batch entry points also shard over a mesh of devices
(`parallel.make_mesh`, `mesh=`); the containers (UTF, AWB, ACB, CPK, USM,
IVF) and their builders are host code that hands its audio and CRILAYLA
members to the kernels, and `cricodecs` is the CriCodecs drop-in module.
The public surface mirrors the JAX package's (its classes, enums, structs
and submodule aliases) plus the port's batch entry points. Output is
byte-equal to the JAX package. This package never imports jax or
pycricodecs_tpu.
"""
from enum import Enum
from struct import Struct

from .containers.acb import ACB, ACBBuilder
from .containers.awb import AWB, AWBBuilder
from .containers.chunk import (AWBChunkHeader, AWBType, CPKChunkHeader,
                               CPKChunkHeaderType, CriHcaQuality, HCAType,
                               SBTChunkHeader, USMChunckHeaderType,
                               USMChunkHeader, UTFChunkHeader, UTFType,
                               UTFTypeValues, VideoType, WavDataHeaderStruct,
                               WavHeaderStruct, WavNoteHeaderStruct,
                               WavSmplHeaderStruct)
from .containers.cpk import CPK, CPKBuilder
from .containers.ivf import IVF
from .containers.usm import USM, USMBuilder
from .containers.utf import UTF, UTFBuilder
from .models.adx import ADX
from .models.ahx import AHX
from .models.hca import HCA, crypt
from .models import crilayla
from .ops.hca_frame import HcaInfo
from .parallel import (DecodeStats, adx_decode_batch, adx_encode_batch,
                       ahx_decode_batch, ahx_encode_batch, decode_acb,
                       decode_awb, decode_batch, encode_batch, find_key,
                       hca_encode_batch, rank_keys, score_key)

# submodule aliases matching the reference package layout (and the JAX
# package's): `pycricodecs_tpu_torch.usm`, `from pycricodecs_tpu_torch
# import chunk`
from .containers import acb, awb, chunk, cpk, ivf, usm, utf
from .models import adx, ahx, hca

__all__ = ["ADX", "AHX", "HCA", "CPK", "CPKBuilder", "USM", "USMBuilder",
           "UTF", "UTFBuilder", "ACB", "ACBBuilder", "AWB", "AWBBuilder",
           "IVF", "crilayla", "USMChunckHeaderType", "CPKChunkHeaderType",
           "UTFType", "AWBType", "HCAType", "VideoType", "UTFTypeValues",
           "CriHcaQuality", "Enum", "Struct", "UTFChunkHeader",
           "USMChunkHeader", "CPKChunkHeader", "AWBChunkHeader",
           "SBTChunkHeader", "WavHeaderStruct", "WavSmplHeaderStruct",
           "WavNoteHeaderStruct", "WavDataHeaderStruct",
           "acb", "adx", "ahx", "awb", "chunk", "cpk", "hca", "ivf",
           "usm", "utf",
           # the port's own
           "DecodeStats", "HcaInfo", "adx_decode_batch", "adx_encode_batch",
           "ahx_decode_batch", "ahx_encode_batch", "crypt", "decode_acb",
           "decode_awb", "decode_batch", "encode_batch", "find_key",
           "hca_encode_batch", "rank_keys", "score_key"]
