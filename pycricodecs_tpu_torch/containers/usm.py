"""USM (SofDec2) container: demuxer/extractor and builder.

A copy of pycricodecs_tpu/containers/usm.py (held equal by
tests/test_torch_usm.py) whose audio runs on `device`: `USM.extract(
decode=True)` decodes its tracks with the port's HCA (kernels B1-B3), ADX
(B7) and AHX (B10 and mp2_synth) decoders, and `USMBuilder` encodes WAV
tracks with the port's HCA (B6 and hca_pack) or ADX (B8) encoder. The key
schedule, the masks and the demux and mux are numpy host code, as in the
JAX package. A track that is not a decodable audio stream is written raw
with a warning; a kernel's build or launch failure raises.

Parity surface: PyCriCodecs.USM / USMBuilder (usm.py:16-1302): same key
schedule and chunk masks, same demux outputs and metadata payloads, same
interleaving layout on build. The mask ciphers are numpy-vectorised: the
XOR-feedback recurrences collapse to stride-32 cumulative XOR scans.

The builder's ADX path is fixed here (the reference's is broken by an API
mismatch, reference README.md:132): ADX streams are chunked from the encoded
bytes with sizes derived from the parsed ADX header.
"""
from __future__ import annotations

import os
from io import BytesIO, FileIO
import numpy as np
import torch

from ..models.adx import ADX, parse_adx_header
from ..models.hca import HCA
from ..utils.paths import anchored_join, safe_parts
from ..utils.device import as_device
from .chunk import (SBTChunkHeader, USMChunckHeaderType,
                    USMChunkHeader, UTFTypeValues, VideoType)
from .ivf import IVF
from .utf import UTF, UTFBuilder


def init_key(key) -> tuple:
    """Derive (videomask1, videomask2, audiomask) from a 64-bit key.

    Parity: usm.py:47-117. Accepts int or hex string.
    """
    if isinstance(key, str):
        if len(key) <= 16:
            key = key.rjust(16, "0")
            key1 = bytes.fromhex(key[8:])
            key2 = bytes.fromhex(key[:8])
        else:
            raise ValueError("Invalid input key.")
    elif isinstance(key, int):
        key1 = int.to_bytes(key & 0xFFFFFFFF, 4, "big")
        key2 = int.to_bytes(key >> 32, 4, "big")
    else:
        raise ValueError("Invalid key format, must be either a string or an integer.")
    t = bytearray(0x20)
    t[0x00:0x09] = [
        key1[3], key1[2], key1[1], (key1[0] - 0x34) % 0x100,
        (key2[3] + 0xF9) % 0x100, (key2[2] ^ 0x13) % 0x100,
        (key2[1] + 0x61) % 0x100, (key1[3] ^ 0xFF) % 0x100,
        (key1[1] + key1[2]) % 0x100,
    ]
    t[0x09:0x0C] = [(t[0x01] - t[0x07]) % 0x100, (t[0x02] ^ 0xFF) % 0x100,
                    (t[0x01] ^ 0xFF) % 0x100]
    t[0x0C:0x0E] = [(t[0x0B] + t[0x09]) % 0x100, (t[0x08] - t[0x03]) % 0x100]
    t[0x0E:0x10] = [(t[0x0D] ^ 0xFF) % 0x100, (t[0x0A] - t[0x0B]) % 0x100]
    t[0x10] = (t[0x08] - t[0x0F]) % 0x100
    t[0x11:0x17] = [(t[0x10] ^ t[0x07]) % 0x100, (t[0x0F] ^ 0xFF) % 0x100,
                    (t[0x03] ^ 0x10) % 0x100, (t[0x04] - 0x32) % 0x100,
                    (t[0x05] + 0xED) % 0x100, (t[0x06] ^ 0xF3) % 0x100]
    t[0x17:0x1A] = [(t[0x13] - t[0x0F]) % 0x100, (t[0x15] + t[0x07]) % 0x100,
                    (0x21 - t[0x13]) % 0x100]
    t[0x1A:0x1C] = [(t[0x14] ^ t[0x17]) % 0x100, (t[0x16] + t[0x16]) % 0x100]
    t[0x1C:0x1F] = [(t[0x17] + 0x44) % 0x100, (t[0x03] + t[0x04]) % 0x100,
                    (t[0x05] - t[0x16]) % 0x100]
    t[0x1F] = (t[0x1D] ^ t[0x13]) % 0x100
    vm1 = np.frombuffer(bytes(t), dtype=np.uint8).copy()
    vm2 = vm1 ^ 0xFF
    am = vm2.copy()
    am[1::2] = np.frombuffer(b"URUC", dtype=np.uint8)[
        (np.arange(1, 0x20, 2) >> 1) & 3]
    return vm1, vm2, am


def _xor_acc_chains(body: np.ndarray, stride: int) -> np.ndarray:
    """Per-chain cumulative XOR: out[i] = XOR of body[j] for j<=i, j≡i (mod stride)."""
    n = len(body)
    pad = (-n) % stride
    padded = np.concatenate([body, np.zeros(pad, dtype=np.uint8)])
    acc = np.bitwise_xor.accumulate(padded.reshape(-1, stride), axis=0)
    return acc.reshape(-1)[:n]


def video_mask_decrypt(data: bytearray, vm1: np.ndarray, vm2: np.ndarray) -> bytearray:
    """Decrypt an SFV/ALP payload (parity with usm.py:279-310)."""
    head, body = bytes(data[:0x40]), np.frombuffer(bytes(data[0x40:]), dtype=np.uint8)
    size = len(body)
    if size <= 0x200:
        return bytearray(head) + bytearray(body.tobytes())
    out = body.copy()
    # phase 1 (mask2): word-granular region [0x100, (size//8)*8)
    end = (size // 8) * 8
    region = body[0x100:end]
    tiles = (len(region) + 31) // 32
    vm2_t = np.tile(vm2, tiles)[:len(region)]
    # recurrence plain_i = cipher_i ^ plain_{i-32} ^ vm2 collapses to a
    # per-chain cumulative XOR of (cipher ^ vm2)
    plain_body = _xor_acc_chains(region ^ vm2_t, 32)
    out[0x100:end] = plain_body
    # phase 2 (mask1): first 0x100 bytes keyed from decrypted [0x100, 0x200)
    src = plain_body[:0x100]
    acc = _xor_acc_chains(src, 32)
    vm1_t = np.tile(vm1, 8)
    out[:0x100] = body[:0x100] ^ vm1_t ^ acc
    return bytearray(head) + bytearray(out.tobytes())


def video_mask_encrypt(data: bytes, vm1: np.ndarray, vm2: np.ndarray) -> bytes:
    """Encrypt an SFV payload (parity with usm.py:1255-1288, byte variant)."""
    head, body = data[:0x40], np.frombuffer(data[0x40:], dtype=np.uint8)
    size = len(body)
    if size <= 0x200:
        return bytes(head) + body.tobytes()
    out = body.copy()
    # mask1 phase over first 0x100 bytes, keyed from plaintext [0x100, 0x200)
    src = body[0x100:0x200]
    acc = _xor_acc_chains(src, 32)
    vm1_t = np.tile(vm1, 8)
    out[:0x100] = body[:0x100] ^ vm1_t ^ acc
    # mask2 phase over [0x100, size): cipher = plain ^ plain_{i-32} ^ vm2
    region = body[0x100:]
    prev = np.concatenate([np.zeros(32, dtype=np.uint8), region[:-32]]) \
        if len(region) > 32 else np.zeros_like(region)
    tiles = (len(region) + 31) // 32
    vm2_t = np.tile(vm2, tiles)[:len(region)]
    out[0x100:] = region ^ prev ^ vm2_t
    return bytes(head) + out.tobytes()


def audio_mask(data, mask: np.ndarray, word_mode: bool = True):
    """XOR an SFA payload with the repeating 32-byte audio mask.

    Decrypt (demux) touches only whole 8-byte words (usm.py:313-322); the
    builder's encrypt variant covers every byte (usm.py:1290-1299).
    """
    head, body = bytes(data[:0x140]), np.frombuffer(bytes(data[0x140:]), dtype=np.uint8)
    end = (len(body) // 8) * 8 if word_mode else len(body)
    out = body.copy()
    tiles = (end + 31) // 32
    out[:end] = body[:end] ^ np.tile(mask, max(tiles, 1))[:end]
    return bytearray(head) + bytearray(out.tobytes())


class USM:
    """USM demuxer/extractor (parity with PyCriCodecs.USM)."""

    __slots__ = ["filename", "videomask1", "videomask2", "audiomask",
                 "decrypt", "stream", "_fileinfo", "CRIDObj", "size",
                 "output", "codec", "demuxed", "device"]

    def __init__(self, filename, key=False, *, device="cuda"):
        self.device = device
        self.filename = filename
        self.decrypt = False
        self.codec = 0
        if key and not isinstance(key, bool):
            self.decrypt = True
            self.videomask1, self.videomask2, self.audiomask = init_key(key)
        if isinstance(filename, str):
            self.stream = FileIO(filename)
        else:
            self.stream = BytesIO(filename)
        self.stream.seek(0, 2)
        self.size = self.stream.tell()
        self.stream.seek(0)
        if self.stream.read(4) != USMChunckHeaderType.CRID.value:
            raise NotImplementedError("Unsupported file type.")
        self.stream.seek(0)
        self.demuxed = False

    def init_key(self, key) -> None:
        """Drop-in alias (usm.py:47): set/replace the crypt key."""
        self.decrypt = True
        self.videomask1, self.videomask2, self.audiomask = init_key(key)

    def VideoMask(self, memObj):
        """Drop-in alias (usm.py:279): decrypt a @SFV payload in place."""
        return video_mask_decrypt(bytearray(memObj), self.videomask1,
                                  self.videomask2)

    def AudioMask(self, memObj):
        """Drop-in alias (usm.py:313): de/encrypt a @SFA payload."""
        return audio_mask(bytes(memObj), self.audiomask)

    def load_file(self) -> None:
        """Drop-in alias (usm.py:121): (re)demux the stream."""
        self.demux()

    def demux(self) -> None:
        self.stream.seek(0)
        self._fileinfo = []
        (header, chunksize, _, offset, padding, chno, _, _, ctype, _, _, _,
         _) = USMChunkHeader.unpack(self.stream.read(USMChunkHeader.size))
        chunksize -= 0x18
        self.CRIDObj = UTF(self.stream.read(chunksize))
        payload = self.CRIDObj.get_payload()
        self._fileinfo.append({self.CRIDObj.table_name: payload})
        headers = [int.to_bytes(x["stmid"][1], 4, "big").decode()
                   for x in payload[1:]]
        chnos = [x["chno"][1] for x in payload[1:]]
        output = {h + "_" + str(c): bytearray() for h, c in zip(headers, chnos)}
        known = [chunk.value for chunk in USMChunckHeaderType]
        while self.stream.tell() < self.size:
            (header, chunksize, _, offset, padding, chno, _, _, ctype, _, _,
             _, _) = USMChunkHeader.unpack(self.stream.read(USMChunkHeader.size))
            chunksize -= 0x18
            offset -= 0x18
            if header.decode(errors="replace") in headers or header in known:
                key = header.decode() + "_" + str(
                    chno if header.decode() in headers else 0)
                if ctype == 0:
                    data = self._read_payload(chunksize, offset, padding, header)
                    output.setdefault(key, bytearray()).extend(data)
                elif ctype in (1, 3):
                    obj = UTF(self.stream.read(chunksize))
                    self._fileinfo.append({obj.table_name: obj.get_payload()})
                    if ctype == 1 and header == USMChunckHeaderType.SFA.value:
                        self.codec = obj.get_payload()[0]["audio_codec"][1]
                else:
                    self.stream.seek(chunksize, 1)
                # Resync for reference-builder output: its AUDIO_HEADER
                # metadata chunks declare `padding` in the chunk size but
                # never write those bytes (reference usm.py:927 discards the
                # bytes.ljust() result), so walking by declared size lands
                # mid-header. If the next position does not start a known
                # tag but `padding` bytes earlier does, step back. The
                # reference's own demuxer cannot read these files; we can.
                if padding and self.stream.tell() < self.size \
                        and padding < self.stream.tell():
                    pos = self.stream.tell()
                    nxt = self.stream.read(4)
                    if not (nxt in known
                            or nxt.decode(errors="replace") in headers):
                        self.stream.seek(pos - padding)
                        prev = self.stream.read(4)
                        if (prev in known
                                or prev.decode(errors="replace") in headers):
                            self.stream.seek(pos - padding)
                            continue
                    self.stream.seek(pos)
            else:
                raise NotImplementedError(f"Unsupported chunk type: {header}")
        self.output = output
        self.demuxed = True

    def _read_payload(self, chunksize, offset, padding, header) -> bytearray:
        data = bytearray(self.stream.read(chunksize)[offset:])
        if header in (USMChunckHeaderType.SFV.value, USMChunckHeaderType.ALP.value):
            if self.decrypt:
                data = video_mask_decrypt(data, self.videomask1, self.videomask2)
        elif header == USMChunckHeaderType.SFA.value:
            if self.codec == 2 and self.decrypt:
                data = audio_mask(data, self.audiomask, word_mode=True)
        if padding:
            data = data[:-padding]
        return data

    def extract(self, dirname: str = "", decode: bool = False,
                key: int = 0, subkey: int = 0) -> None:
        """Write demuxed streams to disk.

        ``decode=True`` additionally converts audio streams (@SFA carrying
        ADX or HCA, @AHX carrying MPEG Layer II) to ``.wav`` on the USM's
        device — a capability the reference lacks (its extract always
        writes raw payloads, and it cannot decode AHX at all).
        ``key``/``subkey`` are the HCA keycodes. A stream that is not
        decodable audio is written raw with a warning.
        """
        self.stream.seek(0)
        if not self.demuxed:
            self.demux()
        table = self.CRIDObj.get_payload()
        filenames = []
        point = 0
        for row in table[1:]:
            filename = row["filename"][1]
            for sep in (":\\", ":/", ":" + os.sep):
                if sep in filename:
                    filename = filename.split(sep, 1)[1]
                    break
            for sep in (".." + os.sep, "../", "..\\"):
                if sep in filename:
                    filename = filename.rsplit(sep, 1)[1]
                    break
            filename = "".join(ch for ch in filename if ch not in ':?*<>|"')
            # anchor under dirname (the reference only strips drive-letter
            # absolutes, so a POSIX-absolute or crafted name escapes its
            # output directory — usm.py:205-220; not reproduced). Empty
            # results fall through to _chunk_filename's <chunk>.bin name.
            filename = anchored_join(dirname, filename) \
                if safe_parts(filename) else dirname
            if filename not in filenames:
                filenames.append(filename)
            else:
                # splitext keeps the split inside the basename — a dot in a
                # directory component must not become the split point
                stem, ext = os.path.splitext(filename)
                filenames.append(f"{stem}_{point}{ext}")
                point += 1
        point = 0
        written: set = set()

        def _chunk_filename(chunk_name, point):
            """CRID-listed name for this output slot, or a fallback for data
            chunks demux carried beyond the CRID table (e.g. @USR/@PST) and
            for empty/fully-sanitised CRID filenames."""
            name = filenames[point] if point < len(filenames) else ""
            if not name or name.rstrip(os.sep + "/") in (
                    "", dirname.rstrip(os.sep + "/")):
                name = os.path.join(dirname, chunk_name + ".bin")
            os.makedirs(os.path.dirname(name) or ".", exist_ok=True)
            return name

        for chunk_name, data in self.output.items():
            tag = chunk_name.rsplit("_", 1)[0]
            if tag == USMChunckHeaderType.SBT.value.decode():
                name = _chunk_filename(chunk_name, point)
                for i, text in enumerate(self.sbt_to_srt(data)):
                    if "." in os.path.basename(name):
                        sub = name.rsplit(".", 1)[0] + f"_{i}.srt"
                    else:
                        sub = name + f"_{i}"
                    with open(sub, "w", encoding="utf-8") as fh:
                        fh.write(text)
                point += 1
            elif tag == USMChunckHeaderType.CUE.value.decode() or not data:
                point += 1
            else:
                name = _chunk_filename(chunk_name, point)
                payload = bytes(data)
                if decode and tag in (
                        USMChunckHeaderType.SFA.value.decode(),
                        USMChunckHeaderType.AHX.value.decode()):
                    wav = self._decode_audio(payload, key, subkey,
                                             device=self.device)
                    if wav is None:
                        import warnings
                        warnings.warn(
                            f"could not decode audio stream {chunk_name}; "
                            "wrote the raw payload (wrong key?)")
                    else:
                        payload = wav
                        base = name.rsplit(".", 1)[0] \
                            if "." in os.path.basename(name) else name
                        name = base + ".wav"
                if name in written:
                    stem, ext = os.path.splitext(name)
                    name = f"{stem}_{point}{ext}"
                with open(name, "wb") as fh:
                    fh.write(payload)
                written.add(name)
                point += 1

    @staticmethod
    def _decode_audio(data: bytes, key: int = 0, subkey: int = 0, *,
                      device="cuda"):
        """Sniff and decode one demuxed audio payload to WAV on `device`
        (None if the payload is not a decodable audio stream).

        Only a bad stream becomes None: a ValueError of the host's sniff
        and header parse (not audio, truncated), the HCA decoder's
        HcaError and WavError past it (a wrong key), and an AHX frame
        whose fields run past its end (the AHX batch isolates it).
        Everything the kernels' wrappers and launches raise propagates,
        their ValueErrors for a wrong tensor included, and so do torch's
        CUDA errors: the JAX package catches every exception here, which
        would hide them behind raw output files."""
        from ..models import adx as adxmod
        from ..models import ahx as ahxmod
        from ..models import hca as hcamod
        from ..ops.hca_frame import HcaError, parse_header
        from ..parallel import pipeline
        from ..utils.sniff import sniff
        from ..utils.wav import WavError

        try:
            kind = sniff(data)
            if kind == "hca":
                parse_header(data[:int.from_bytes(data[6:8], "big")])
            elif kind == "ahx":
                ahxmod.parse_header(data)
                pipeline._parse_mp2(data)
            elif kind == "adx":
                pipeline._parse_adx(data, strict_cri_check=False)
            else:
                return None
        except ValueError:
            return None
        try:
            if kind == "hca":
                return hcamod.decode(data, key=key, subkey=subkey,
                                     device=device)
            if kind == "ahx":
                # AHX.decode's call, a bad frame isolated (None)
                return pipeline._ahx_decode([data], as_device(device),
                                            "isolate", zero_fill=True)[0]
            return adxmod.decode(data, strict_cri_check=False, device=device)
        except (HcaError, WavError):
            return None

    def sbt_to_srt(self, stream: bytearray) -> list:
        """Convert @SBT subtitle chunks to SRT documents (usm.py:324-361)."""
        size = len(stream)
        sio = BytesIO(bytes(stream))
        out: dict = {}
        while sio.tell() < size:
            langid, framerate, frametime, duration, data_size = \
                SBTChunkHeader.unpack(sio.read(SBTChunkHeader.size))

            def stamp(ms_total):
                ms = ms_total % framerate
                sec = (ms_total // framerate) % 60
                mins = (ms_total // (framerate * 60)) % 60
                hrs = (ms_total // (framerate * 60 * 60)) % 24
                return f"{hrs:0>2.0f}:{mins:0>2.0f}:{sec:0>2.0f},{ms:0>3.0f}"

            start = stamp(frametime)
            end = stamp(frametime + duration)
            text = sio.read(data_size)
            if text.endswith(b"\x00\x00"):
                text = text[:-2].decode("utf-8", errors="ignore") + "\n\n"
            else:
                text = text.decode("utf-8", errors="ignore")
            if langid in out:
                n = int(out[langid][-1].split("\n", 1)[0]) + 1
                out[langid].append(f"{n}\n{start} --> {end}\n{text}")
            else:
                out[langid] = [f"1\n{start} --> {end}\n{text}"]
        return ["".join(v) for v in out.values()]

    def get_metadata(self):
        return self._fileinfo


class USMBuilder:
    """Builds a USM from an IVF/VP9 video and optional ADX/HCA audio; WAV
    tracks are encoded on `device`.

    Parity with the reference layout (usm.py:370-1302); the ADX path works
    here (fixed behaviour), the HCA path matches the reference structure.
    """

    __slots__ = ["ivfObj", "videomask1", "videomask2", "audiomask", "encrypt",
                 "audio_codec", "streams", "stream_infos", "encryptAudio",
                 "SFA_chunk_size", "base_interval_per_SFA_chunk", "video_codec",
                 "SFV_interval_for_VP9", "audio", "video_filename",
                 "audio_filenames", "minchk", "minbuf", "avbps", "key", "usm",
                 "subtitles", "alpObj", "device"]

    def __init__(self, video, audio=False, key=False, audio_codec: str = "adx",
                 encryptAudio: bool = False, subtitles=None,
                 alpha=None, *, device="cuda") -> None:
        """Beyond-reference extras: `subtitles` builds an @SBT stream
        ({langid: [(start_ms, duration_ms, text), ...]} or a plain list for
        language 0); `alpha` builds an @ALP alpha-video stream from a second
        IVF/VP9 blob (VideoMask-encrypted when a key is set, like @SFV).
        Round-trips through USM.demux / sbt_to_srt."""
        self.device = device
        if isinstance(video, str):
            videostream = FileIO(video)
            # CRID carries the bare name: embedding the builder host's full
            # path both leaks it and (on naive extractors, the reference
            # included) makes extraction write outside the target directory
            self.video_filename = os.path.basename(video)
        else:
            videostream = BytesIO(video)
            self.video_filename = "temp.ivf"
        header = videostream.read(4)
        if header == USMChunckHeaderType.CRID.value:
            raise NotImplementedError("USM editing is not implemented yet.")
        if header != VideoType.IVF.value:
            raise NotImplementedError(
                "Video container must be in IVF format containing VP9 codec.")
        videostream.seek(0)
        self.ivfObj = IVF(videostream)
        self.video_codec = "vp9"
        self.audio_codec = audio_codec.lower()
        self.encrypt = False
        self.audio = False
        self.encryptAudio = encryptAudio
        self.key = 0
        if isinstance(subtitles, (list, tuple)):
            subtitles = {0: list(subtitles)}
        self.subtitles = subtitles or None
        self.alpObj = None
        if alpha is not None:
            astream = FileIO(alpha) if isinstance(alpha, str) \
                else BytesIO(alpha)
            if astream.read(4) != VideoType.IVF.value:
                raise NotImplementedError(
                    "Alpha stream must be IVF/VP9 as well.")
            astream.seek(0)
            self.alpObj = IVF(astream)
        if encryptAudio and not key:
            raise ValueError("Cannot encrypt Audio without key.")
        if key:
            self.key = key if isinstance(key, int) else int(key, 16)
            self.videomask1, self.videomask2, self.audiomask = init_key(key)
            self.encrypt = True
        if audio:
            self._load_audio(audio)
            self.audio = True

    # -- audio ------------------------------------------------------------

    def _load_audio(self, audio) -> None:
        tracks = audio if isinstance(audio, list) else [audio]
        self.audio_filenames = []
        for count, track in enumerate(tracks):
            if isinstance(track, str):
                self.audio_filenames.append(os.path.basename(track))
            else:
                self.audio_filenames.append("{:02d}.sfa".format(count))
        self.streams = []
        self.stream_infos = []
        for track in tracks:
            if isinstance(track, str):
                with open(track, "rb") as fh:
                    raw = fh.read()
            else:
                raw = bytes(track)
            if self.audio_codec == "adx":
                if raw[:4] == b"RIFF":
                    raw = ADX.encode(raw, AdxVersion=4, Encoding=3,
                                     force_not_looping=True,
                                     device=self.device)
                self.streams.append(raw)
                self.stream_infos.append(
                    parse_adx_header(raw, strict_cri_check=False))
            elif self.audio_codec == "hca":
                obj = HCA(raw, key=self.key, device=self.device)
                if obj.filetype == "wav":
                    obj.encode(force_not_looping=True,
                               encrypt=self.encryptAudio, keyless=False)
                self.streams.append(obj)
                self.stream_infos.append(obj)
            else:
                raise ValueError(
                    "Supported audio codecs in USM are only HCA and ADX.")

    def append_stream(self, audio) -> None:
        assert not isinstance(audio, list)
        self._load_audio_one(audio)

    def _load_audio_one(self, track) -> None:
        saved = self.streams, self.stream_infos, self.audio_filenames
        self._load_audio([track])
        self.streams = saved[0] + self.streams
        self.stream_infos = saved[1] + self.stream_infos
        self.audio_filenames = saved[2] + self.audio_filenames
        # auto-generated names restart at "00.sfa" per call; renumber
        # duplicates so every CRID row keeps a distinct filename
        seen: set = set()
        fixed = []
        for i, nm in enumerate(self.audio_filenames):
            if nm in seen:
                stem, dot, ext = nm.rpartition(".")
                nm = f"{stem}_{i}{dot}{ext}" if dot else f"{nm}_{i}"
            seen.add(nm)
            fixed.append(nm)
        self.audio_filenames = fixed

    # -- intervals ---------------------------------------------------------

    def _prepare_sfv(self) -> None:
        ivfinfo = self.ivfObj.info()
        v_framerate = round(
            ivfinfo["time_base_denominator"] / ivfinfo["time_base_numerator"], 2)
        self.SFV_interval_for_VP9 = round(2997 / v_framerate, 1)

    def _prepare_sfa(self) -> None:
        self.SFA_chunk_size = []
        self.base_interval_per_SFA_chunk = []
        framerate = 29.97
        if self.audio_codec == "adx":
            for info in self.stream_infos:
                size = (int(info.sample_rate // framerate // 32)
                        * (info.block_size * info.channels))
                if size <= 0:
                    raise ValueError(
                        "ADX sample rate too low for USM SFA chunking "
                        f"({info.sample_rate} Hz needs >= 960 Hz).")
                self.SFA_chunk_size.append(size)
                self.base_interval_per_SFA_chunk.append(
                    99.9 if self.video_codec == "vp9" else 100)
        else:
            for obj in self.stream_infos:
                self.SFA_chunk_size.append(obj.hca["FrameSize"])
                self.base_interval_per_SFA_chunk.append(64)

    # -- build -------------------------------------------------------------

    def build(self) -> bytes:
        if self.audio:
            self._prepare_sfa()
        self._prepare_sfv()
        sfv_list = self._gen_sfv_chunks()
        sfa_chunks = self._gen_sfa_chunks() if self.audio else False
        self._assemble(sfv_list, sfa_chunks)
        return self.usm

    def _pack_chunk(self, tag, payload, chno, ctype, frametime, framerate,
                    pad_to=0x20) -> bytes:
        padding = (pad_to - len(payload) % pad_to) if len(payload) % pad_to else 0
        chunk = USMChunkHeader.pack(tag, len(payload) + 0x18 + padding, 0,
                                    0x18, padding, chno, 0, 0, ctype,
                                    frametime, framerate, 0, 0)
        return chunk + bytes(payload).ljust(len(payload) + padding, b"\x00")

    def _end_chunk(self, tag, chno, text) -> bytes:
        chunk = USMChunkHeader.pack(tag, 0x38, 0, 0x18, 0, chno, 0, 0, 2, 0,
                                    30, 0, 0)
        return chunk + text

    def _gen_sfv_chunks(self) -> list:
        ivfinfo = self.ivfObj.info()
        self.ivfObj.stream.seek(0)
        v_framerate = int((ivfinfo["time_base_denominator"]
                           / ivfinfo["time_base_numerator"]) * 100)
        sfv_header = self.ivfObj.stream.read(ivfinfo["HeaderSize"])
        sfv_list = []
        current_interval = 0
        count = 0
        self.minchk = 0
        self.minbuf = 0
        bitrate = 0
        for size, _ts, _idx, frame, keyframe in self.ivfObj.get_frames():
            payload = (sfv_header + frame) if count == 0 else frame
            if self.encrypt:
                payload = video_mask_encrypt(payload, self.videomask1,
                                             self.videomask2)
            pad_len = len(payload)
            padding = (0x20 - pad_len % 0x20) if pad_len % 0x20 else 0
            chunk = USMChunkHeader.pack(
                USMChunckHeaderType.SFV.value, pad_len + 0x18 + padding, 0,
                0x18, padding, 0, 0, 0, 0, current_interval, v_framerate, 0, 0)
            chunk += payload
            chunk = chunk.ljust(pad_len + 0x18 + padding + 0x8, b"\x00")
            sfv_list.append(chunk)
            count += 1
            current_interval = int(count * self.SFV_interval_for_VP9)
            if keyframe:
                self.minchk += 1
            if self.minbuf < pad_len:
                self.minbuf = pad_len
            bitrate += pad_len * 8 * (v_framerate / 100)
        self.avbps = int(bitrate / count) if count else 0
        sfv_list.append(self._end_chunk(USMChunckHeaderType.SFV.value, 0,
                                        b"#CONTENTS END   ===============\x00"))
        return sfv_list

    def _gen_sbt_chunks(self) -> list:
        """@SBT subtitle chunks: each entry is an SBTChunkHeader
        (langid, framerate=1000 i.e. milliseconds, frametime, duration,
        data_size) + NUL-terminated UTF-8 text, matching what sbt_to_srt /
        the reference's demuxer expect (usm.py:324-361)."""
        entries = []
        for langid, items in self.subtitles.items():
            for start_ms, duration_ms, text in items:
                entries.append((int(start_ms), int(duration_ms), int(langid),
                                str(text)))
        entries.sort(key=lambda e: (e[0], e[2]))
        chunks = []
        for start_ms, duration_ms, langid, text in entries:
            data = text.encode("utf-8") + b"\x00\x00"
            payload = SBTChunkHeader.pack(langid, 1000, start_ms,
                                          duration_ms, len(data)) + data
            pad = (0x20 - len(payload) % 0x20) if len(payload) % 0x20 else 0
            chunk = USMChunkHeader.pack(
                USMChunckHeaderType.SBT.value, len(payload) + 0x18 + pad, 0,
                0x18, pad, 0, 0, 0, 0, start_ms, 1000, 0, 0)
            chunk += payload
            chunks.append(chunk.ljust(len(payload) + 0x18 + pad + 0x8,
                                      b"\x00"))
        chunks.append(self._end_chunk(
            USMChunckHeaderType.SBT.value, 0,
            b"#CONTENTS END   ===============\x00"))
        return chunks

    def _gen_alp_chunks(self) -> list:
        """@ALP alpha-video chunks (same framing as @SFV, incl. VideoMask)."""
        info = self.alpObj.info()
        self.alpObj.stream.seek(0)
        framerate = int((info["time_base_denominator"]
                         / info["time_base_numerator"]) * 100)
        header = self.alpObj.stream.read(info["HeaderSize"])
        chunks = []
        count = 0
        interval = 0
        for _size, _ts, _idx, frame, _kf in self.alpObj.get_frames():
            payload = (header + frame) if count == 0 else frame
            if self.encrypt:
                payload = video_mask_encrypt(payload, self.videomask1,
                                             self.videomask2)
            pad = (0x20 - len(payload) % 0x20) if len(payload) % 0x20 else 0
            chunk = USMChunkHeader.pack(
                USMChunckHeaderType.ALP.value, len(payload) + 0x18 + pad, 0,
                0x18, pad, 0, 0, 0, 0, interval, framerate, 0, 0)
            chunk += payload
            chunks.append(chunk.ljust(len(payload) + 0x18 + pad + 0x8,
                                      b"\x00"))
            count += 1
            interval = int(count * self.SFV_interval_for_VP9)
        chunks.append(self._end_chunk(
            USMChunckHeaderType.ALP.value, 0,
            b"#CONTENTS END   ===============\x00"))
        return chunks

    def _gen_sfa_chunks(self) -> list:
        all_chunks = [[] for _ in self.streams]
        for sidx, stream in enumerate(self.streams):
            interval = 0
            chunks = all_chunks[sidx]
            if self.audio_codec == "adx":
                info = self.stream_infos[sidx]
                raw = stream
                chunk_size = self.SFA_chunk_size[sidx]
                base_int = self.base_interval_per_SFA_chunk[sidx]
                stream_size = len(raw) - info.block_size  # sans EOF block
                pos = 0
                count = 0
                while pos < stream_size:
                    if pos == 0:
                        do = info.data_offset + 4
                    else:
                        remaining = stream_size - pos
                        do = chunk_size if remaining >= chunk_size else remaining
                    payload = raw[pos:pos + do]
                    if self.encryptAudio:
                        payload = bytes(audio_mask(payload, self.audiomask,
                                                   word_mode=False))
                    chunks.append(self._pack_chunk(
                        USMChunckHeaderType.SFA.value, payload, sidx, 0,
                        interval, 2997))
                    pos += do
                    interval = int(count * base_int)
                    count += 1
                # trailing EOF block chunk
                payload = raw[stream_size:stream_size + info.block_size]
                chunks.append(self._pack_chunk(
                    USMChunckHeaderType.SFA.value, payload, sidx, 0,
                    interval, 2997))
                chunks[-1] += self._end_chunk(
                    USMChunckHeaderType.SFA.value, sidx,
                    b"#CONTENTS END   ===============\x00")
            else:
                obj: HCA = self.streams[sidx]
                base_int = self.base_interval_per_SFA_chunk[sidx]
                chunks.append(self._pack_chunk(
                    USMChunckHeaderType.SFA.value, obj.get_header(), sidx, 0,
                    interval, 2997))
                for _i, frame in obj.get_frames():
                    chunks.append(self._pack_chunk(
                        USMChunckHeaderType.SFA.value, frame, sidx, 0,
                        interval, 2997))
                    interval += base_int
                chunks[-1] += self._end_chunk(
                    USMChunckHeaderType.SFA.value, sidx,
                    b"#CONTENTS END   ===============\x00")
        return all_chunks

    def _assemble(self, sfv_list, sfa_chunks) -> None:
        sbt_list = self._gen_sbt_chunks() if self.subtitles else []
        alp_list = self._gen_alp_chunks() if self.alpObj is not None else []
        extra_len = (sum(len(x) for x in sbt_list)
                     + sum(len(x) for x in alp_list))
        header = self._build_header(sfv_list, sfa_chunks, extra_len)
        len_sfv = len(sfv_list)
        len_sfa = [len(x) for x in sfa_chunks] if self.audio else [0]
        current_interval = 0.0
        target_interval = 0.0
        sfa_count = 0
        # alpha IVFs longer than the main video must still flush fully
        max_len = max(len_sfv, max(len_sfa), len(alp_list))
        out = bytearray(header)
        for i in range(max_len):
            if i < len_sfv:
                out += sfv_list[i]
            if i < len(alp_list):
                out += alp_list[i]
            if i == 0:
                for ch in sbt_list:
                    out += ch
            target_interval += self.SFV_interval_for_VP9
            if self.audio:
                while current_interval < target_interval:
                    for idx, stream in enumerate(sfa_chunks):
                        if current_interval > target_interval:
                            current_interval += self.base_interval_per_SFA_chunk[0]
                            break
                        if sfa_count == 0:
                            out += stream[sfa_count]
                        if sfa_count < len_sfa[idx] - 1:
                            out += stream[sfa_count + 1]
                    else:
                        current_interval += self.base_interval_per_SFA_chunk[0]
                        sfa_count += 1
        self.usm = bytes(out)

    def _build_header(self, sfv_list, sfa_chunks, extra_len=0) -> bytes:
        tv = UTFTypeValues
        nstreams = len(self.streams) if self.audio else 0
        crid_rows = [dict(
            avbps=(tv.uint, -1 & 0xFFFFFFFF), chno=(tv.ushort, 0xFFFF),
            datasize=(tv.uint, 0),
            filename=(tv.string, self.video_filename.rsplit(".", 1)[0] + ".usm"),
            filesize=(tv.uint, 0), fmtver=(tv.uint, 16777984),
            minbuf=(tv.uint, 0), minchk=(tv.ushort, 1), stmid=(tv.uint, 0))]

        total_avbps = self.avbps
        minbuf = 4 + self.minbuf
        self.ivfObj.stream.seek(0, 2)
        v_filesize = self.ivfObj.stream.tell()
        self.ivfObj.stream.seek(0)
        crid_rows.append(dict(
            avbps=(tv.uint, self.avbps), chno=(tv.ushort, 0),
            datasize=(tv.uint, 0), filename=(tv.string, self.video_filename),
            filesize=(tv.uint, v_filesize), fmtver=(tv.uint, 16777984),
            minbuf=(tv.uint, self.minbuf), minchk=(tv.ushort, self.minchk),
            stmid=(tv.uint, int.from_bytes(USMChunckHeaderType.SFV.value, "big"))))

        if self.audio:
            for chno, stream in enumerate(self.streams):
                if self.audio_codec == "adx":
                    info = self.stream_infos[chno]
                    sz = len(stream)
                    chnls = info.channels
                    avbps = (sz * 8 * chnls) - sz
                else:
                    sz = len(stream.get_hca())
                    chnls = stream.hca["ChannelCount"]
                    avbps = int(sz / chnls)
                total_avbps += avbps
                minbuf += 27860
                crid_rows.append(dict(
                    avbps=(tv.uint, avbps), chno=(tv.ushort, chno),
                    datasize=(tv.uint, 0),
                    filename=(tv.string, self.audio_filenames[chno]),
                    filesize=(tv.uint, sz), fmtver=(tv.uint, 16777984),
                    minbuf=(tv.uint, 27860), minchk=(tv.ushort, 1),
                    stmid=(tv.uint, int.from_bytes(
                        USMChunckHeaderType.SFA.value, "big"))))
        if self.alpObj is not None:
            self.alpObj.stream.seek(0, 2)
            a_filesize = self.alpObj.stream.tell()
            self.alpObj.stream.seek(0)
            crid_rows.append(dict(
                avbps=(tv.uint, self.avbps), chno=(tv.ushort, 0),
                datasize=(tv.uint, 0), filename=(tv.string, "alpha.ivf"),
                filesize=(tv.uint, a_filesize), fmtver=(tv.uint, 16777984),
                minbuf=(tv.uint, self.minbuf), minchk=(tv.ushort, 1),
                stmid=(tv.uint, int.from_bytes(
                    USMChunckHeaderType.ALP.value, "big"))))
            minbuf += self.minbuf
        if self.subtitles:
            n_entries = sum(len(v) for v in self.subtitles.values())
            crid_rows.append(dict(
                avbps=(tv.uint, 8000), chno=(tv.ushort, 0),
                datasize=(tv.uint, 0), filename=(tv.string, "subtitles.sbt"),
                filesize=(tv.uint, n_entries), fmtver=(tv.uint, 16777984),
                minbuf=(tv.uint, 4096), minchk=(tv.ushort, 1),
                stmid=(tv.uint, int.from_bytes(
                    USMChunckHeaderType.SBT.value, "big"))))
            minbuf += 4096
        crid_rows[0]["avbps"] = (tv.uint, total_avbps)
        crid_rows[0]["minbuf"] = (tv.uint, minbuf)

        ivf = self.ivfObj.ivf
        v_framerate = int(round(ivf["time_base_denominator"]
                                / ivf["time_base_numerator"], 3) * 1000)
        video_hdr = [{
            "alpha_type": (tv.uint, 0), "color_space": (tv.uint, 0),
            "disp_height": (tv.uint, ivf["Height"]),
            "disp_width": (tv.uint, ivf["Width"]),
            "framerate_d": (tv.uint, 1000), "framerate_n": (tv.uint, v_framerate),
            "height": (tv.uint, ivf["Height"]), "ixsize": (tv.uint, self.minbuf),
            "mat_height": (tv.uint, ivf["Height"]),
            "mat_width": (tv.uint, ivf["Width"]),
            "max_picture_size": (tv.uint, 0), "metadata_count": (tv.uint, 1),
            "metadata_size": (tv.uint, 224), "mpeg_codec": (tv.uchar, 9),
            "mpeg_dcprec": (tv.uchar, 0), "picture_type": (tv.uint, 0),
            "pre_padding": (tv.uint, 0), "scrn_width": (tv.uint, 0),
            "total_frames": (tv.uint, ivf["FrameCount"]),
            "width": (tv.uint, ivf["Width"]),
        }]
        builder = UTFBuilder(video_hdr, table_name="VIDEO_HDRINFO")
        builder.strings = b"<NULL>\x00" + builder.strings
        video_hdr_blob = builder.parse()
        video_hdr_chunk = self._pack_chunk(
            USMChunckHeaderType.SFV.value, video_hdr_blob, 0, 1, 0, 30)

        audio_metadata = []
        audio_headers = []
        if self.audio:
            if self.audio_codec == "hca":
                for chno, stream in enumerate(self.streams):
                    payload = [dict(hca_header=(tv.bytes, stream.get_header()))]
                    b = UTFBuilder(payload, table_name="AUDIO_HEADER")
                    b.strings = b"<NULL>\x00" + b.strings
                    metadata = b.parse()
                    audio_metadata.append(self._pack_chunk(
                        USMChunckHeaderType.SFA.value, metadata, chno, 3, 0, 30))
            for chno, stream in enumerate(self.streams):
                if self.audio_codec == "adx":
                    info = self.stream_infos[chno]
                    chnls = info.channels
                    sampling_rate = info.sample_rate
                    total_samples = info.sample_count
                else:
                    chnls = stream.hca["ChannelCount"]
                    sampling_rate = stream.hca["SampleRate"]
                    total_samples = stream.hca["FrameCount"]
                hdr = {
                    "audio_codec": (tv.uchar, 2 if self.audio_codec == "adx" else 4),
                    "ixsize": (tv.uint, 27860),
                    "metadata_count": (tv.uint, 0 if self.audio_codec == "adx" else 1),
                    "metadat_size": (tv.uint, 0 if self.audio_codec == "adx"
                                     else len(audio_metadata[chno])),
                    "num_channels": (tv.uchar, chnls),
                    "sampling_rate": (tv.uint, sampling_rate),
                    "total_samples": (tv.uint, total_samples),
                }
                if self.audio_codec == "hca":
                    hdr["ambisonics"] = (tv.uint, 0)
                b = UTFBuilder([hdr], table_name="AUDIO_HDRINFO")
                b.strings = b"<NULL>\x00" + b.strings
                audio_headers.append(self._pack_chunk(
                    USMChunckHeaderType.SFA.value, b.parse(), chno, 1, 0, 30))

        first_chk_ofs = (0x800 + len(video_hdr_chunk) + 0x20
                         + 0x40 * nstreams + 192)
        if self.audio:
            first_chk_ofs += sum(len(x) + 0x40 for x in audio_headers)
            if self.audio_codec == "hca":
                first_chk_ofs += sum(len(x) + 0x40 for x in audio_metadata)
        seekinfo = [{
            "num_skip": (tv.short, 0), "ofs_byte": (tv.ullong, first_chk_ofs),
            "ofs_frmid": (tv.int, 0), "resv": (tv.short, 0),
        }]

        total_len = sum(len(x) for x in sfv_list) + first_chk_ofs + extra_len
        if self.audio:
            total_len += sum(len(x) for s in sfa_chunks for x in s)
        crid_rows[0]["filesize"] = (tv.uint, total_len)
        b = UTFBuilder(crid_rows, table_name="CRIUSF_DIR_STREAM")
        b.strings = b"<NULL>\x00" + b.strings
        crid_blob = b.parse()

        out = bytearray()
        padding = 0x800 - len(crid_blob)
        crid = USMChunkHeader.pack(
            USMChunckHeaderType.CRID.value, 0x800 - 0x8, 0, 0x18,
            padding - 0x20, 0, 0, 0, 1, 0, 30, 0, 0)
        out += crid + bytes(crid_blob).ljust(0x800 - 0x20, b"\x00")
        out += video_hdr_chunk
        if self.audio:
            for chunk in audio_headers:
                out += chunk
        out += self._end_chunk(USMChunckHeaderType.SFV.value, 0,
                               b"#HEADER END     ===============\x00")
        if self.audio:
            for chno in range(nstreams):
                out += self._end_chunk(USMChunckHeaderType.SFA.value, chno,
                                       b"#HEADER END     ===============\x00")
        b = UTFBuilder(seekinfo, table_name="VIDEO_SEEKINFO")
        b.strings = b"<NULL>\x00" + b.strings
        out += self._pack_chunk(USMChunckHeaderType.SFV.value, b.parse(),
                                0, 3, 0, 30)
        if self.audio and self.audio_codec == "hca":
            for metadata in audio_metadata:
                out += metadata
        out += self._end_chunk(USMChunckHeaderType.SFV.value, 0,
                               b"#METADATA END   ===============\x00")
        if self.audio and self.audio_codec == "hca":
            for chno in range(nstreams):
                out += self._end_chunk(USMChunckHeaderType.SFA.value, chno,
                                       b"#METADATA END   ===============\x00")
        return bytes(out)

    def get_usm(self) -> bytes:
        return self.usm
