"""Batched bank decode (see pipeline.py)."""
from .pipeline import DecodeStats, decode_batch

__all__ = ["DecodeStats", "decode_batch"]
