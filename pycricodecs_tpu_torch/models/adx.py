"""ADX codec: the host pieces of the batched codec (header parse, payload
slicing, history, encode preparation and stream assembly; numpy only) and
the single-file surface (`decode`, `encode`, the `ADX` class).

The host pieces are copies of pycricodecs_tpu/models/adx.py (held equal by
tests/test_torch_adx_host.py). The single-file functions run one stream
through the batch paths of parallel/pipeline.py (`adx_decode_batch` in the
JAX host decoders' arithmetic, `adx_encode_batch`), on `device`, and give
the JAX package's `decode` / `encode` bytes. Format anchors: adx.cpp:298-515
(header, loops, modes 2/3/4, versions 3/4/5, EOF scale block).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils import wav as wavmod

CRI_STRING = b"(c)CRI"

STATIC_COEFFICIENTS = np.array(
    [0x0000, 0x0000, 0x0F00, 0x0000, 0x1CC0, -0x0D00, 0x1880, -0x0DC0],
    dtype=np.int32)
# (0xF300 and 0xF240 as signed 16-bit, adx.cpp:45)

_ERRORS = {
    -1: "Invalid ADX file header.",
    -2: "AHX file provided, unsopported.",
    -3: "Encrypted ADX detected, unsupported.",
    -4: "Invalid/Unknown encoding mode found.",
    -5: "Unknown ADX version provided.",
    -6: "Invalid Bitdepth found on the provided ADX.",
    -7: "ADX does not contain any channels info.",
    -8: "Invalid ADX header, loop information size is bigger than the header.",
    -9: "Inavlid ADX header, Criware copyright string not found.",
    -10: "Numbers of Channel cannot exceed 255 or go below 0.",
    -11: "Bitdepth must be between 2 and 15 inclusive.",
    -12: "Blocksize must be between 3 and 255 inclusive.",
    -13: "EncodingMode must be either 2, 3, or 4.",
    -14: "HighpassFrequency must be between 0 and 65535 inclusive.",
    -15: "Filter is used with EncodingMode == 2 and must be between 0 and 4 inclusive.",
    -16: "AdxVersion must be either 3, 4 or 5.",
    -17: "Provided Bitdepth does not fit correctly with the provided BlockSize",
    -18: "Given WAVE file is not valid for ADX encoding.",
}


def _err(code: int):
    exc = NotImplementedError if code == -3 else ValueError
    raise exc(_ERRORS[code])


def samples_per_block(block_size: int, bit_depth: int) -> int:
    return (block_size - 2) * 8 // bit_depth


def calculate_coefficients(highpass_frequency: int, sample_rate: int):
    """Highpass-derived prediction coefficients (adx.cpp:58-64)."""
    a = math.sqrt(2.0) - math.cos(2.0 * math.pi * highpass_frequency
                                  / sample_rate)
    b = math.sqrt(2.0) - 1.0
    c = (a - math.sqrt((a + b) * (a - b))) / b
    return int(c * 8192), int(c * c * -4096)


@dataclass
class AdxHeader:
    data_offset: int = 0
    encoding_mode: int = 3
    block_size: int = 0x12
    bit_depth: int = 4
    channels: int = 1
    sample_rate: int = 48000
    sample_count: int = 0
    highpass_frequency: int = 500
    version: int = 4
    flag: int = 0
    looping: bool = False
    loop_start_sample: int = 0
    loop_end_sample: int = 0
    history: Optional[np.ndarray] = None  # int16 [channels, 2] (prev1, prev2)

    @property
    def samples_per_block(self) -> int:
        return samples_per_block(self.block_size, self.bit_depth)


def parse_adx_header(data: bytes, strict_cri_check: bool = True) -> AdxHeader:
    if len(data) < 20:
        _err(-1)
    h = AdxHeader()
    sig = int.from_bytes(data[0:2], "big")
    h.data_offset = int.from_bytes(data[2:4], "big")
    h.encoding_mode = data[4]
    h.block_size = data[5]
    h.bit_depth = data[6]
    h.channels = data[7]
    h.sample_rate = int.from_bytes(data[8:12], "big")
    h.sample_count = int.from_bytes(data[12:16], "big")
    h.highpass_frequency = int.from_bytes(data[16:18], "big")
    h.version = data[18]
    h.flag = data[19]

    if sig != 0x8000:
        _err(-1)
    if h.encoding_mode in (0x10, 0x11) or h.version == 0x06 \
            or h.block_size == 0 or h.bit_depth == 0:
        _err(-2)
    if h.flag in (0x08, 0x09):
        _err(-3)
    if h.encoding_mode not in (2, 3, 4):
        _err(-4)
    if h.version not in (3, 4, 5):
        _err(-5)
    if ((h.block_size - 2) * 8) % h.bit_depth != 0 or h.bit_depth >= 16:
        _err(-6)
    if h.channels == 0:
        _err(-7)

    base = 20
    looping_possible = False
    if h.version == 5:
        looping_possible = False
    elif h.version == 4:
        base += 4  # padding word
        nhist = h.channels if h.channels > 1 else 2
        hist = np.zeros((h.channels, 2), dtype=np.int16)
        for i in range(h.channels):
            off = base + i * 4
            hist[i, 0] = int.from_bytes(data[off:off + 2], "big", signed=True)
            hist[i, 1] = int.from_bytes(data[off + 2:off + 4], "big",
                                        signed=True)
        h.history = hist
        base += nhist * 4
        looping_possible = base + 24 <= h.data_offset - 2
    else:  # version 3
        looping_possible = base + 24 <= h.data_offset - 2

    if looping_possible:
        loop_count = int.from_bytes(data[base + 2:base + 4], "big")
        if loop_count:
            if base + 4 + loop_count * 20 >= h.data_offset - 2:
                _err(-8)
            off = base + 4
            h.looping = True
            h.loop_start_sample = int.from_bytes(data[off + 4:off + 8], "big")
            h.loop_end_sample = int.from_bytes(data[off + 12:off + 16], "big")

    # The reference compares 7 chars ("(c)CRI" + NUL) starting at
    # DataOffset-2: the 7th byte is the first audio block's scale high byte
    # (adx.cpp:345-348), which rejects some valid files. strict mode keeps
    # that for decode parity; non-strict checks only the 6 real signature
    # bytes (the bank decode's ADX members).
    want = CRI_STRING + (b"\x00" if strict_cri_check else b"")
    if data[h.data_offset - 2:h.data_offset - 2 + len(want)] != want:
        _err(-9)
    return h


def _payload_blocks(data: bytes, h: AdxHeader) -> np.ndarray:
    """Slice the raw block stream to [nblocks, C, block_size] (EOF-trimmed)."""
    spb = h.samples_per_block
    base = h.data_offset + 4
    blocks_total = math.ceil(h.sample_count / spb) if h.sample_count else 0

    raw = np.frombuffer(data, dtype=np.uint8)
    avail_blocks = (len(raw) - base) // (h.block_size * h.channels)
    nblocks = min(blocks_total, avail_blocks) if blocks_total else 0
    payload = raw[base:base + nblocks * h.block_size * h.channels]
    payload = payload.reshape(nblocks, h.channels, h.block_size)

    # EOF scale detection (adx.cpp:405-406): stop at the first block whose
    # first channel scale bytes read 0x8001.
    eof = (payload[:, 0, 0] == 0x80) & (payload[:, 0, 1] == 0x01)
    if eof.any():
        nblocks = int(np.argmax(eof))
        payload = payload[:nblocks]
    return payload


def _history_init(h: AdxHeader):
    if h.version == 4 and h.history is not None:
        return (h.history[:, 0].astype(np.int32),
                h.history[:, 1].astype(np.int32))
    return (np.zeros(h.channels, dtype=np.int32),
            np.zeros(h.channels, dtype=np.int32))


def _get_next_multiple(value: int, multiple: int) -> int:
    if multiple <= 0 or value % multiple == 0:
        return value
    return value + multiple - value % multiple


class _EncodePrep:
    """Validated/derived encode state of one WAV (see _encode_prep)."""

    __slots__ = ("wav", "channels", "sample_rate", "spc", "looping",
                 "frames", "spb", "data_block", "c0", "c1", "h1", "h2",
                 "blocks")


def _encode_prep(data: bytes, *, bit_depth: int, block_size: int,
                 encoding_mode: int, highpass_frequency: int, filter_: int,
                 version: int, force_not_looping: bool) -> _EncodePrep:
    """Parse + validate the WAV and derive what the encoder needs
    (adx.cpp:416-478 argument checks + PCM blocking + history init)."""
    wav = wavmod.parse_wav(bytes(data))
    channels = wav.channels
    sample_rate = wav.sample_rate
    sample_count = wav.num_samples
    looping = wav.looping
    if force_not_looping and version == 5:
        looping = False

    if channels > 255 or channels < 1:
        _err(-10)
    if bit_depth <= 1 or bit_depth >= 16:
        _err(-11)
    if block_size <= 2 or block_size > 255:
        _err(-12)
    if encoding_mode not in (2, 3, 4):
        _err(-13)
    if not (0 <= highpass_frequency <= 0xFFFF):
        _err(-14)
    if filter_ not in (0, 1, 2, 3):
        _err(-15)
    if version not in (3, 4, 5):
        _err(-16)
    if (8 * (block_size - 2)) % bit_depth != 0:
        _err(-17)
    if sample_count < channels or sample_count % channels != 0:
        _err(-18)

    data_block = block_size - 2
    spb = data_block * 8 // bit_depth
    spc = sample_count // channels
    pcm = wav.pcm16.astype(np.int32)
    if spc % spb != 0:
        needed = _get_next_multiple(spc, data_block) * channels
        frames = (needed // channels) // spb
        padded = np.zeros(needed, dtype=np.int32)
        padded[:sample_count] = pcm
        pcm = padded
    else:
        frames = spc // spb

    if encoding_mode == 2:
        c0 = int(STATIC_COEFFICIENTS[filter_ * 2])
        c1 = int(STATIC_COEFFICIENTS[filter_ * 2 + 1])
    else:
        c0, c1 = calculate_coefficients(highpass_frequency, sample_rate)

    # deinterleave to [C, frames*spb] then group into blocks [C, frames, spb]
    per_ch = pcm.reshape(-1, channels).T[:, :frames * spb]
    blocks = per_ch.reshape(channels, frames, spb)

    if version in (4, 5):
        # history seeds from the padded PCM's first sample even when the
        # stream is shorter than one block (frames == 0): the reference's
        # history init reads PCMData[i] unconditionally
        full_ch = pcm.reshape(-1, channels).T
        h1 = full_ch[:, 0].copy() if full_ch.shape[1] \
            else np.zeros(channels, np.int32)
        h2 = h1.copy()
    else:
        h1 = np.zeros(channels, dtype=np.int32)
        h2 = np.zeros(channels, dtype=np.int32)

    prep = _EncodePrep()
    prep.wav = wav
    prep.channels = channels
    prep.sample_rate = sample_rate
    prep.spc = spc
    prep.looping = looping
    prep.frames = frames
    prep.spb = spb
    prep.data_block = data_block
    prep.c0 = c0
    prep.c1 = c1
    prep.h1 = h1
    prep.h2 = h2
    prep.blocks = blocks
    return prep


def _assemble_stream(prep: _EncodePrep, payload: np.ndarray, *,
                     bit_depth: int, block_size: int, encoding_mode: int,
                     highpass_frequency: int, version: int) -> bytes:
    """ADX header + raw block stream + EOF block (adx.cpp:359-379, 479-489).
    payload is [frames, channels, block_size] uint8."""
    wav = prep.wav
    channels = prep.channels
    sample_rate = prep.sample_rate
    spc = prep.spc
    looping = prep.looping
    data_block = prep.data_block
    spb = prep.spb
    h1, h2 = prep.h1, prep.h2
    header_size = 20 + 6
    if version in (4, 5):
        # The reference sizes the history area from an *uninitialized*
        # Header.Channels (adx.cpp:482; zero on that toolchain), so it always
        # reserves 8 bytes whatever the channel count; history entries past
        # it are overwritten by the CRI string / audio blocks below.
        header_size += 8
    num_loops = 1 if looping else 0
    if looping:
        header_size += 4 + num_loops * 20
    header_size = _get_next_multiple(header_size, 16)

    out = bytearray(header_size)
    out[0:2] = (0x8000).to_bytes(2, "big")
    out[2:4] = (header_size - 4).to_bytes(2, "big")
    out[4] = encoding_mode
    out[5] = block_size
    out[6] = bit_depth
    out[7] = channels
    out[8:12] = sample_rate.to_bytes(4, "big")
    out[12:16] = spc.to_bytes(4, "big")
    out[16:18] = (0 if encoding_mode == 2 else highpass_frequency).to_bytes(
        2, "big")
    out[18] = version
    out[19] = 0
    base = 20
    if version in (4, 5):
        # 4-byte padding then per-channel history (first-sample init);
        # entries past header_size are clipped (the reference overwrites
        # them with audio data right after)
        for i in range(channels):
            off = base + 4 + i * 4
            entry = (int(h1[i] & 0xFFFF).to_bytes(2, "big")
                     + int(h2[i] & 0xFFFF).to_bytes(2, "big"))
            room = max(0, min(4, header_size - off))
            out[off:off + room] = entry[:room]
        base += 4 + (4 * channels if channels > 1 else 8)
    if looping:
        samples_in_frame = data_block * 2
        # the reference stores AlignmentSamples in an unsigned short
        # (adx.cpp struct Loop) and derives every loop field from the
        # truncated value
        align = _get_next_multiple(
            wav.loop_start,
            samples_in_frame * 2 if channels == 1 else samples_in_frame) \
            & 0xFFFF
        start = wav.loop_start + align
        end = wav.loop_end + align
        start_byte = header_size + (start // spb) * block_size * channels
        end_byte = header_size + _get_next_multiple(
            (end // spb) * block_size + (end % spb) // block_size,
            block_size) * channels

        def wr(off, blob):
            # like the history entries: writes past header_size are clipped
            # (the reference writes into a larger zeroed buffer and then
            # overwrites that region with audio data)
            room = max(0, min(len(blob), header_size - off))
            out[off:off + room] = blob[:room]

        wr(base, align.to_bytes(2, "big"))
        wr(base + 2, (1).to_bytes(2, "big"))
        lo = base + 4
        wr(lo, (0).to_bytes(2, "big"))                 # loop index
        wr(lo + 2, (1).to_bytes(2, "big"))             # loop type: enabled
        wr(lo + 4, ((wav.loop_start + align) & 0xFFFFFFFF).to_bytes(4, "big"))
        wr(lo + 8, (start_byte & 0xFFFFFFFF).to_bytes(4, "big"))
        wr(lo + 12, ((wav.loop_end + align) & 0xFFFFFFFF).to_bytes(4, "big"))
        wr(lo + 16, (end_byte & 0xFFFFFFFF).to_bytes(4, "big"))
    out[header_size - 6:header_size] = CRI_STRING

    eof_block = bytearray(block_size)
    eof_block[0:2] = (0x8001).to_bytes(2, "big")
    eof_block[2:4] = (block_size - 4).to_bytes(2, "big")

    return bytes(out) + payload.tobytes() + bytes(eof_block)


def decode(data: bytes, use_jax=None, strict_cri_check: bool = True, *,
           device="cuda") -> bytes:
    """ADX -> WAV (PCM16) on `device`, truncated or zero-padded to the
    header's sample count: pycricodecs_tpu.models.adx.decode(data,
    use_jax, strict_cri_check)'s bytes. strict_cri_check=False skips the
    reference's 7th-signature-byte check.

    use_jax is the JAX function's choice of engine, and the answer is that
    engine's: None or false, its host decoders' arithmetic (B7's host
    instance); true, its device scan's int32 wrap (B7's wrap=True), which
    differs on mode 4 blocks whose scale times code leaves int32. The
    device scan's host demux raises IndexError on a mode 2 block with
    predictor 4-7, and so does this function with use_jax true (the host
    arithmetic predicts such a block from zero coefficients)."""
    from ..parallel import pipeline
    data = bytes(data)
    if use_jax:
        h = parse_adx_header(data, strict_cri_check=strict_cri_check)
        if h.encoding_mode == 2:
            predictor = _payload_blocks(data, h)[:, :, 0] >> 5
            if (predictor >= 4).any():
                raise IndexError(
                    f"ADX mode 2 predictor {int(predictor.max())} has no "
                    "coefficients (the JAX device scan's table has 4)")
    return pipeline.adx_decode_batch([data], device=device,
                                     strict_cri_check=strict_cri_check,
                                     wrap=bool(use_jax))[0]


def encode(data: bytes, bit_depth: int = 4, block_size: int = 0x12,
           encoding_mode: int = 3, highpass_frequency: int = 0x1F4,
           filter_: int = 0, version: int = 4,
           force_not_looping: bool = False, use_jax=None,
           scale_fix: bool = False, *, device="cuda") -> bytes:
    """WAV -> ADX on `device`: pycricodecs_tpu.models.adx.encode's bytes
    for the same arguments (one stream through adx_encode_batch). use_jax
    is the JAX function's choice of engine; its engines give the same
    bytes, and so does this function for every value."""
    from ..parallel import pipeline
    return pipeline.adx_encode_batch(
        [data], bit_depth=bit_depth, block_size=block_size,
        encoding_mode=encoding_mode, highpass_frequency=highpass_frequency,
        filter_=filter_, version=version,
        force_not_looping=force_not_looping, scale_fix=scale_fix,
        device=device)[0]


class ADX:
    """Drop-in replacement for PyCriCodecs.ADX (static decode/encode), on
    `device`."""

    @staticmethod
    def decode(data: bytes, *, device="cuda") -> bytes:
        return decode(data, device=device)

    @staticmethod
    def encode(data: bytes, BitDepth: int = 0x4, Blocksize: int = 0x12,
               Encoding: int = 3, AdxVersion: int = 0x4,
               Highpass_Frequency: int = 0x1F4, Filter: int = 0,
               force_not_looping: bool = False, *, device="cuda") -> bytes:
        return encode(data, bit_depth=BitDepth, block_size=Blocksize,
                      encoding_mode=Encoding,
                      highpass_frequency=Highpass_Frequency, filter_=Filter,
                      version=AdxVersion,
                      force_not_looping=force_not_looping, device=device)
