"""Batched bank decode and encode (HCA, ADX, AHX), the AWB/ACB bank
decode, and the HCA key search (see pipeline.py)."""
from .pipeline import (DecodeStats, adx_decode_batch, adx_encode_batch,
                       ahx_decode_batch, ahx_encode_batch, decode_acb,
                       decode_awb, decode_batch, encode_batch, find_key,
                       hca_encode_batch, rank_keys, score_key)

__all__ = ["DecodeStats", "adx_decode_batch", "adx_encode_batch",
           "ahx_decode_batch", "ahx_encode_batch", "decode_acb", "decode_awb",
           "decode_batch", "encode_batch", "find_key", "hca_encode_batch",
           "rank_keys", "score_key"]
