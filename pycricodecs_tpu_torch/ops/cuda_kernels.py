"""ctypes bindings of the port's hand-written CUDA kernels, the counterpart
of pycricodecs_tpu/ops/pallas_kernels.py.

B3 `hca_transform` (csrc/hca_transform.cu) replaces transform_fused_pallas;
its wrapper and launch counter live here. The unpack kernels B1/B2 are
wrapped in hca_unpack_device.py with the helpers below. A wrapper checks its
inputs, allocates the outputs, launches on the current stream, raises if the
launch failed and counts the launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

#: hca_transform launches since import (or the last reset)
TRANSFORM_LAUNCHES = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """Device pointer of a tensor."""
    return ctypes.c_void_p(t.data_ptr())


def host_ptr(a: np.ndarray) -> ctypes.c_void_p:
    """Host pointer of a contiguous numpy array (kept alive by the caller)."""
    return ctypes.c_void_p(a.ctypes.data)


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the tensor's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               shape: tuple) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch_failed(kernel: str, rc: int) -> RuntimeError:
    return RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def hca_transform(qc, sf, res, inten, hfr_map, *, base_band, total_band,
                  stereo_pairs, apply_hfr, hfr_group_count) -> torch.Tensor:
    """Kernel B3: qc i16 [B, F, C, 8, 128], sf/res u8 [B, F, C, 128],
    inten u8 [B, F, C, 8] (CUDA) -> PCM i16 [B, F, 8, 128, C]."""
    global TRANSFORM_LAUNCHES
    B, F, C = qc.shape[0], qc.shape[1], qc.shape[2]
    check_cuda(qc, "qc", torch.int16, (B, F, C, 8, 128))
    check_cuda(sf, "sf", torch.uint8, (B, F, C, 128))
    check_cuda(res, "res", torch.uint8, (B, F, C, 128))
    check_cuda(inten, "inten", torch.uint8, (B, F, C, 8))
    out = torch.empty((B, F, 8, 128, C), dtype=torch.int16, device=qc.device)
    if B * F == 0:
        return out
    partner = np.full(C, -1, dtype=np.int32)
    for (p, s) in stereo_pairs:
        partner[p] = s
    hfr_is = np.ascontiguousarray(hfr_map.band_is_hfr, dtype=np.int32)
    hfr_src = np.ascontiguousarray(hfr_map.src_band, dtype=np.int32)
    hfr_group = np.ascontiguousarray(hfr_map.group_of, dtype=np.int32)
    rc = _build.load().hca_transform(
        ptr(qc), ptr(sf), ptr(res), ptr(inten), B, F, C, int(base_band),
        int(total_band), int(bool(apply_hfr)), int(hfr_group_count),
        int(hfr_map.zero_band) if apply_hfr else -1, host_ptr(partner),
        host_ptr(hfr_is), host_ptr(hfr_src), host_ptr(hfr_group), ptr(out),
        stream_ptr(qc))
    if rc:
        raise launch_failed("hca_transform", rc)
    TRANSFORM_LAUNCHES += 1
    return out
