"""Drop-in replacement for the reference's `CriCodecs` C extension module,
on the port: the counterpart of pycricodecs_tpu/cricodecs.py.

The same seven functions (CriCodecs.cpp:8-17) with the reference's
positional signatures, so code written against `import CriCodecs` can
switch to `from pycricodecs_tpu_torch import cricodecs as CriCodecs`.
All but HcaCrypt reach a kernel, and take a keyword-only `device` ("cuda"
by default; "cpu" runs the kernels' plain versions):

    AdxDecode(data) / AdxEncode(data, bitdepth, blocksize, encoding,
                                highpass, filter, adxver, force_no_looping)
    HcaDecode(data, header_size, keycode, subkey)
    HcaEncode(wav, force_not_looping, quality)
    HcaCrypt(buffer, crypt, header_size, type, keycode, subkey)   (host)
    CriLaylaDecompress(data) / CriLaylaCompress(data)   (kernels C1 / C2)
"""
from __future__ import annotations

from .models import adx as _adx
from .models import crilayla as _crilayla
from .models import hca as _hca


def AdxDecode(data: bytes, *, device="cuda") -> bytes:
    return _adx.decode(data, device=device)


def AdxEncode(data: bytes, bitdepth: int = 4, blocksize: int = 0x12,
              encoding: int = 3, highpass_frequency: int = 0x1F4,
              filter: int = 0, adx_version: int = 4,
              force_no_looping: bool = False, *, device="cuda") -> bytes:
    return _adx.encode(data, bit_depth=bitdepth, block_size=blocksize,
                       encoding_mode=encoding,
                       highpass_frequency=highpass_frequency, filter_=filter,
                       version=adx_version, force_not_looping=force_no_looping,
                       device=device)


def HcaDecode(data: bytes, header_size: int, keycode: int = 0,
              subkey: int = 0, *, device="cuda") -> bytes:
    return _hca.decode(data, key=keycode, subkey=subkey, device=device)


def HcaEncode(data: bytes, force_not_looping: int = 0, quality: int = 1, *,
              device="cuda") -> bytes:
    from .parallel import pipeline
    return pipeline.hca_encode_batch(
        [data], quality=quality, force_not_looping=bool(force_not_looping),
        device=device)[0]


def HcaCrypt(buffer, crypt: int, header_size: int, type: int,
             keycode: int, subkey: int) -> bytes:
    return _hca.crypt(bytes(buffer), bool(crypt), header_size, type,
                      keycode, subkey)


def CriLaylaDecompress(data: bytes, *, device="cuda") -> bytes:
    return _crilayla.decompress(data, device=device)


def CriLaylaCompress(data: bytes, *, device="cuda") -> bytes:
    return _crilayla.compress(data, device=device)
