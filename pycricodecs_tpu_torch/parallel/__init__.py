"""Batched bank decode and encode (see pipeline.py)."""
from .pipeline import (DecodeStats, adx_decode_batch, adx_encode_batch,
                       ahx_decode_batch, decode_batch, hca_encode_batch)

__all__ = ["DecodeStats", "adx_decode_batch", "adx_encode_batch",
           "ahx_decode_batch", "decode_batch", "hca_encode_batch"]
