"""ACB cue database: a nested @UTF table referencing an AWB bank.

A copy of `ACB` and `ACBBuilder` of pycricodecs_tpu/containers/acb.py
(held equal by tests/test_torch_containers.py and
tests/test_torch_builders.py). The extractors decode HCA members with the
port's HCA on `device`; the builder writes the JAX package's bytes.

Parity surface: PyCriCodecs.ACB (acb.py:9-176) — recursive payload parsing,
embedded-or-sibling AWB loading, extract() with the EncodeType extension map.
Additionally implements extract_with_names(), completing what the reference
left unfinished (acb.py:46-109): cue-name resolution for ReferenceType 1
(direct waveform) and 3 (sequence) entries.
"""
from __future__ import annotations

import os
from struct import iter_unpack

from .awb import AWB
from .chunk import UTFType, UTFTypeValues
from .utf import UTF


_EXTENSIONS = {0: ".adx", 3: ".adx", 2: ".hca", 6: ".hca", 7: ".vag",
               10: ".vag", 8: ".at3", 9: ".bcwav", 11: ".at9", 18: ".at9",
               12: ".xma", 13: ".dsp", 4: ".dsp", 5: ".dsp", 19: ".m4a"}


def get_extension(encode_type: int) -> str:
    return _EXTENSIONS.get(encode_type, "")


class ACB(UTF):
    """Parses an ACB and exposes its payload + waveform AWB."""

    __slots__ = ["filename", "payload", "awb"]

    def __init__(self, filename) -> None:
        self.payload = UTF(filename).get_payload()
        self.filename = filename
        self._parse_nested(self.payload)
        self._load_awb()

    def _parse_nested(self, payload: list) -> None:
        for row in payload:
            for key, value in row.items():
                if isinstance(value, tuple) and value[0] == UTFTypeValues.bytes \
                        and isinstance(value[1], (bytes, bytearray)) \
                        and bytes(value[1][:4]) == UTFType.UTF.value:
                    sub = UTF(value[1]).get_payload()
                    row[key] = sub
                    self._parse_nested(sub)

    def _load_awb(self) -> None:
        awb_cell = self.payload[0].get("AwbFile")
        if awb_cell is not None and isinstance(awb_cell, tuple) and awb_cell[1]:
            self.awb = AWB(awb_cell[1])
            return
        name_cell = self.payload[0].get("Name")
        if not (isinstance(name_cell, tuple) and len(name_cell) == 2
                and isinstance(name_cell[1], str)):
            raise ValueError("ACB has neither an embedded AwbFile nor a Name.")
        name = name_cell[1] + ".awb"
        if isinstance(self.filename, str):
            name = os.path.join(os.path.dirname(self.filename), name)
        self.awb = AWB(name)

    def get_payload(self) -> list:
        return self.payload

    # -- extraction -----------------------------------------------------

    def _encode_type(self, index: int) -> int:
        """EncodeType for the AWB member at enumeration position ``index``.

        WaveformTable row order need not match AWB id order (streaming +
        memory waveforms mix), so match the member's awb id against the
        rows' MemoryAwbId/Id and only fall back to the positional row."""
        table = self.payload[0].get("WaveformTable") or []
        ids = getattr(self.awb, "ids", [])
        awb_id = ids[index] if index < len(ids) else index
        for row in table:
            for key in ("MemoryAwbId", "Id"):
                cell = row.get(key)
                if cell is not None and cell[1] == awb_id:
                    enc = row.get("EncodeType")
                    if enc is not None:
                        return enc[1]
        if index < len(table):
            cell = table[index].get("EncodeType")
            if cell is not None:
                return cell[1]
        return -1

    def extract(self, decode: bool = False, key: int = 0,
                dirname: str = "", *, device="cuda") -> None:
        """Extract AWB members as numbered files (reference-compatible)."""
        from ..models.hca import HCA

        if dirname:
            os.makedirs(dirname, exist_ok=True)
        for index, data in enumerate(self.awb.getfiles()):
            ext = get_extension(self._encode_type(index))
            if decode and ext == ".hca":
                payload = HCA(data, key=key, subkey=self.awb.subkey,
                              device=device).decode()
                path = os.path.join(dirname, f"{index}.wav")
            else:
                payload = data
                path = os.path.join(dirname, f"{index}{ext}")
            with open(path, "wb") as fh:
                fh.write(payload)

    def cue_names(self) -> dict:
        """Map AWB member index -> cue name.

        Resolves CueNameTable -> CueTable -> WaveformTable via ReferenceType
        1 (direct) and 3 (sequence -> track -> command -> synth -> waveform),
        the layouts seen in practice. Unknown reference types are skipped.
        """
        pl = self.payload[0]
        names: dict = {}

        def table(key, alt=None):
            # corrupt files may leave a raw (enum, value) cell where a
            # parsed sub-table (list of row dicts) is expected
            v = pl.get(key)
            if not isinstance(v, list) and alt is not None:
                v = pl.get(alt)
            return v if isinstance(v, list) else []

        def cell(row, key, types):
            v = row.get(key) if isinstance(row, dict) else None
            if isinstance(v, tuple) and len(v) == 2 and isinstance(v[1], types):
                return v[1]
            return None

        cue_names = table("CueNameTable")
        cues = table("CueTable")
        waveforms = table("WaveformTable")
        synths = table("SynthTable")
        sequences = table("SequenceTable")
        tracks = table("TrackTable")
        track_events = table("TrackEventTable", "CommandTable")

        def waveform_awb_id(widx):
            if widx >= len(waveforms):
                return None
            w = waveforms[widx]
            for k in ("MemoryAwbId", "Id"):
                v = cell(w, k, int)
                if v is not None:
                    return v
            return None

        def synth_waveforms(sidx, seen=None):
            # `seen` guards against reference cycles in hostile/corrupt
            # tables (a 2-node A->B->A loop would otherwise recurse forever)
            if sidx >= len(synths):
                return []
            seen = seen if seen is not None else set()
            if sidx in seen:
                return []
            seen.add(sidx)
            ref = cell(synths[sidx], "ReferenceItems", (bytes, bytearray))
            if not ref:
                return []
            ref = ref[:len(ref) - len(ref) % 4]
            out = []
            for (item_type, item_index) in iter_unpack(">HH", ref):
                if item_type == 1:
                    out.append(item_index)
                elif item_type == 2 and item_index < len(synths):
                    out.extend(synth_waveforms(item_index, seen))
            return out

        def track_waveforms(tidx):
            if tidx >= len(tracks):
                return []
            ev = cell(tracks[tidx], "EventIndex", int)
            if ev is None or ev == 65535 or ev >= len(track_events):
                return []
            cmd = cell(track_events[ev], "Command", (bytes, bytearray))
            if cmd is None:
                return []
            out = []
            data = bytes(cmd)
            pos = 0
            while pos + 3 <= len(data):
                op = int.from_bytes(data[pos:pos + 2], "big")
                size = data[pos + 2]
                body = data[pos + 3:pos + 3 + size]
                pos += 3 + size
                if op == 0x07D0 and len(body) >= 4:  # noteOn: synth reference
                    ref_type = int.from_bytes(body[0:2], "big")
                    ref_index = int.from_bytes(body[2:4], "big")
                    if ref_type == 0x02:
                        out.extend(synth_waveforms(ref_index))
                    elif ref_type == 0x01:
                        out.append(ref_index)
            return out

        for entry in cue_names:
            cue_index = cell(entry, "CueIndex", int)
            cue_name = cell(entry, "CueName", str)
            if cue_index is None or cue_name is None or cue_index >= len(cues):
                continue
            ref_type = cell(cues[cue_index], "ReferenceType", int)
            ref_index = cell(cues[cue_index], "ReferenceIndex", int)
            if ref_type is None or ref_index is None:
                continue
            widxs = []
            if ref_type == 1:
                widxs = [ref_index]
            elif ref_type == 2:
                widxs = synth_waveforms(ref_index)
            elif ref_type == 3 or ref_type == 8:
                if ref_index < len(sequences):
                    ti = cell(sequences[ref_index], "TrackIndex",
                              (bytes, bytearray))
                    if ti:
                        ti = ti[:len(ti) - len(ti) % 2]
                        for (tidx,) in iter_unpack(">H", ti):
                            widxs.extend(track_waveforms(tidx))
            for n, widx in enumerate(widxs):
                awb_id = waveform_awb_id(widx)
                if awb_id is None:
                    continue
                name = cue_name if n == 0 else f"{cue_name}_{n}"
                names.setdefault(awb_id, name)
        return names

    def exp_extract(self, decode: bool = False, key: int = 0,
                    dirname: str = "", *, device="cuda") -> None:
        """Drop-in alias for the reference's experimental named extract
        (acb.py:46-109, unfinished there — complete here)."""
        return self.extract_with_names(decode=decode, key=key,
                                       dirname=dirname, device=device)

    def extract_with_names(self, decode: bool = False, key: int = 0,
                           dirname: str = "", *, device="cuda") -> None:
        """Extract AWB members using resolved cue names where available."""
        from ..models.hca import HCA

        if dirname:
            os.makedirs(dirname, exist_ok=True)
        names = self.cue_names()
        ids = self.awb.ids
        for index, data in enumerate(self.awb.getfiles()):
            awb_id = ids[index] if index < len(ids) else index
            stem = names.get(awb_id, str(index))
            ext = get_extension(self._encode_type(index))
            # cue names are archive data: anchor them under the output dir
            from ..utils.paths import anchored_join
            if decode and ext == ".hca":
                payload = HCA(data, key=key, subkey=self.awb.subkey,
                              device=device).decode()
                path = anchored_join(dirname, f"{stem}.wav",
                                     fallback=f"{index}.wav")
            else:
                payload = data
                path = anchored_join(dirname, f"{stem}{ext}",
                                     fallback=f"{index}{ext or '.dat'}")
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as fh:
                fh.write(payload)


class ACBBuilder:
    """Builds a minimal playable ACB (one cue per AWB track).

    The reference's ACBBuilder is an empty stub (acb.py:179-180); this is a
    functional replacement producing a self-contained ACB with an embedded
    AWB, CueTable (ReferenceType 1), CueNameTable and WaveformTable.
    """

    def __init__(self, tracks: list, name: str = "pycricodecs_acb",
                 encode_type: int = 2, sample_rate: int = 48000,
                 channels: int = 2, cue_names=None,
                 embed_awb: bool = True) -> None:
        """tracks: list of encoded audio payloads (e.g. HCA bytes).

        embed_awb=False leaves the AwbFile cell empty and exposes the bank
        as `self.awb_blob` after build(); write it as `<Name>.awb` next to
        the ACB — the extractor resolves that sibling, like the reference
        (acb.py:33-43)."""
        self.tracks = [bytes(t) for t in tracks]
        self.name = name
        self.encode_type = encode_type
        self.sample_rate = sample_rate
        self.channels = channels
        self.cue_names = cue_names or [f"cue_{i:04d}" for i in range(len(tracks))]
        self.embed_awb = bool(embed_awb)
        self.awb_blob: bytes = b""

    def build(self) -> bytes:
        from .awb import build_afs2
        from .utf import UTFBuilder

        awb_blob = build_afs2(self.tracks, subkey=0)
        self.awb_blob = awb_blob

        waveform_rows = [{
            "MemoryAwbId": (UTFTypeValues.ushort, i),
            "EncodeType": (UTFTypeValues.uchar, self.encode_type),
            "Streaming": (UTFTypeValues.uchar, 0),
            "NumChannels": (UTFTypeValues.uchar, self.channels),
            "SamplingRate": (UTFTypeValues.ushort, self.sample_rate & 0xFFFF),
            "NumSamples": (UTFTypeValues.uint, 0),
        } for i in range(len(self.tracks))]
        cue_rows = [{
            "CueId": (UTFTypeValues.uint, i),
            "ReferenceType": (UTFTypeValues.uchar, 1),
            "ReferenceIndex": (UTFTypeValues.ushort, i),
        } for i in range(len(self.tracks))]
        cue_name_rows = [{
            "CueName": (UTFTypeValues.string, self.cue_names[i]),
            "CueIndex": (UTFTypeValues.ushort, i),
        } for i in range(len(self.tracks))]

        def table(rows, name):
            return bytes(UTFBuilder(rows, table_name=name).parse())

        header = [{
            "Name": (UTFTypeValues.string, self.name),
            "AwbFile": (UTFTypeValues.bytes,
                        awb_blob if self.embed_awb else b""),
            "CueTable": (UTFTypeValues.bytes, table(cue_rows, "Cue")),
            "CueNameTable": (UTFTypeValues.bytes, table(cue_name_rows, "CueName")),
            "WaveformTable": (UTFTypeValues.bytes, table(waveform_rows, "Waveform")),
        }]
        return bytes(UTFBuilder(header, table_name="Header").parse())
