"""Batched bank decode and encode (HCA, ADX, AHX), the AWB/ACB bank
decode, the HCA key search, the profiler helpers (see pipeline.py) and the
device mesh the sharded entry points take (see mesh.py)."""
from .mesh import Mesh, make_mesh
from .pipeline import (DecodeStats, adx_decode_batch, adx_encode_batch,
                       ahx_decode_batch, ahx_encode_batch, decode_acb,
                       decode_awb, decode_batch, encode_batch, find_key,
                       hca_encode_batch, measure_d2h_bandwidth, rank_keys,
                       score_key, trace)

__all__ = ["DecodeStats", "Mesh", "adx_decode_batch", "adx_encode_batch",
           "ahx_decode_batch", "ahx_encode_batch", "decode_acb", "decode_awb",
           "decode_batch", "encode_batch", "find_key", "hca_encode_batch",
           "make_mesh", "measure_d2h_bandwidth", "rank_keys", "score_key",
           "trace"]
