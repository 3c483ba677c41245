"""AWB / AFS2 audio bank: the reader and extractor, build_afs2 and the
builder.

A copy of `AWB`, `build_afs2` and `AWBBuilder` of
pycricodecs_tpu/containers/awb.py (held equal by
tests/test_torch_containers.py and tests/test_torch_builders.py).
Behaviour parity: PyCriCodecs/awb.py — same header fields (version,
offset/id int sizes, alignment, subkey), same offset rounding, and the
builder emits the JAX package's bytes for the same inputs.
`extract(decode=True)` decodes HCA members with the port's HCA on `device`.
"""
from __future__ import annotations

import os
from io import BytesIO, FileIO
from struct import iter_unpack, pack
from typing import List

from .chunk import AWBChunkHeader, HCAType


def _int_code(intsize: int) -> str:
    try:
        return {1: "B", 2: "H", 4: "I", 8: "Q"}[intsize]
    except KeyError:
        raise ValueError("Unknown int size.")


class AWB:
    """AFS2 bank reader; yields member files via getfiles()."""

    __slots__ = ["stream", "numfiles", "align", "subkey", "version", "ids",
                 "ofs", "filename", "headersize", "id_intsize"]

    def __init__(self, stream) -> None:
        if isinstance(stream, str):
            self.stream = FileIO(stream)
            self.filename = stream
        else:
            self.stream = BytesIO(stream)
            self.filename = ""
        self._read_header()

    def _read_header(self) -> None:
        (magic, self.version, offset_intsize, id_intsize, self.numfiles,
         self.align, self.subkey) = AWBChunkHeader.unpack(
            self.stream.read(AWBChunkHeader.size))
        if magic != b"AFS2":
            raise ValueError("Invalid AWB header.")
        if self.align == 0:
            raise ValueError("Invalid AWB alignment.")
        self.id_intsize = id_intsize
        self.ids = [v[0] for v in iter_unpack(
            "<" + _int_code(id_intsize),
            self.stream.read(id_intsize * self.numfiles))]
        self.ofs = []
        for (v,) in iter_unpack("<" + _int_code(offset_intsize),
                                self.stream.read(offset_intsize * (self.numfiles + 1))):
            self.ofs.append(v if v % self.align == 0
                            else v + (self.align - v % self.align))
        self.headersize = (16 + offset_intsize * (self.numfiles + 1)
                           + id_intsize * self.numfiles)
        if self.headersize % self.align != 0:
            self.headersize += self.align - self.headersize % self.align
        self.stream.seek(self.headersize, 0)

    def getfiles(self):
        """Yield each member's bytes in order.

        Unlike the reference (awb.py:83-88), re-iterating works: the stream is
        repositioned at the first member on each call.
        """
        self.stream.seek(self.ofs[0], 0)
        for i in range(1, len(self.ofs)):
            data = self.stream.read(self.ofs[i] - self.ofs[i - 1])
            self.stream.seek(self.ofs[i], 0)
            yield data

    def getfile_atindex(self, index: int) -> bytes:
        # member i spans [ofs[i], ofs[i+1]); the reference seeks ofs[i+1]
        # and returns the NEXT member's bytes (empty for the last) — a bug
        # we fix rather than reproduce (awb.py:90-96)
        self.stream.seek(self.ofs[index], 0)
        data = self.stream.read(self.ofs[index + 1] - self.ofs[index])
        self.stream.seek(self.headersize, 0)
        return data

    def extract(self, decode: bool = False, key: int = 0,
                dirname: str = "", *, device="cuda") -> None:
        """Write members to disk (HCA decoded to WAV on `device` when
        `decode`)."""
        from ..models.hca import HCA

        if dirname:
            os.makedirs(dirname, exist_ok=True)
        base = os.path.splitext(self.filename)[0] if self.filename else ""
        if dirname:
            # keep output under dirname even when the AWB was opened via an
            # absolute path (os.path.join would discard dirname otherwise)
            base = os.path.basename(base)
        for count, data in enumerate(self.getfiles()):
            is_hca = data.startswith(HCAType.HCA.value) or \
                data.startswith(HCAType.EHCA.value)
            if is_hca:
                ext = ".wav" if decode else ".hca"
                payload = HCA(data, key=key, subkey=self.subkey,
                              device=device).decode() if decode else data
            else:
                ext = ".dat"
                payload = data
            name = (f"{base}_{count}{ext}" if base else f"{count}{ext}")
            with open(os.path.join(dirname, name) if dirname else name, "wb") as fh:
                fh.write(payload)


def build_afs2(members, subkey: int = 0, version: int = 2,
               id_intsize: int = 0x2, align: int = 0x20) -> bytes:
    """Build a *consistent* AFS2 bank from in-memory payloads.

    Unlike the reference's list-mode AWBBuilder (whose offsets drift from the
    written data when member sizes round differently, awb.py:135-182), this
    writer keeps offsets and payload positions in lockstep. Used by
    ACBBuilder and the batch pipeline.
    """
    members = [bytes(m) for m in members]
    n = len(members)
    total = sum(len(m) for m in members)
    intsize, code = (8, "<Q") if total > 0xFFFFFFFF else (4, "<I")
    header = AWBChunkHeader.pack(b"AFS2", version, intsize, id_intsize, n,
                                 align, subkey)
    for i in range(n):
        header += pack("<" + _int_code(id_intsize), i)
    headersize = len(header) + intsize * (n + 1)
    pos = headersize if headersize % align == 0 \
        else headersize + (align - headersize % align)
    offsets = [headersize]
    blobs = []
    for i, m in enumerate(members):
        blobs.append(m)
        end = pos + len(m)
        offsets.append(end)
        if i != n - 1 and end % align != 0:
            padding = align - end % align
            blobs.append(b"\x00" * padding)
            end += padding
        pos = end
    for off in offsets:
        header += pack(code, off)
    if headersize % align != 0:
        header = header.ljust(headersize + (align - headersize % align), b"\x00")
    return header + b"".join(blobs)


class AWBBuilder:
    """Builds an AFS2 bank from a list of files or a directory tree."""

    __slots__ = ["dirname", "version", "align", "subkey", "id_intsize"]

    def __init__(self, dirname, subkey: int = 0, version: int = 2,
                 id_intsize: int = 0x2, align: int = 0x20) -> None:
        if dirname == "":
            raise ValueError("Invalid directory.")
        if version == 1 and subkey != 0:
            raise ValueError("Cannot have a subkey with AWB version of 1.")
        if id_intsize not in (0x2, 0x4, 0x8):
            raise ValueError("id_intsize must be either 2, 4 or 8.")
        self.dirname = dirname
        self.version = version
        self.align = align
        self.subkey = subkey
        self.id_intsize = id_intsize

    def _file_list(self) -> List[str]:
        if isinstance(self.dirname, list):
            return list(self.dirname)
        files = []
        for root, _, names in os.walk(self.dirname):
            for name in names:
                files.append(os.path.join(root, name))
        return files

    def build(self, outfile: str) -> None:
        if outfile == "":
            raise ValueError("Invalid output file name.")
        files = self._file_list()
        # directory mode aligns each size up-front (reference awb.py:188-195)
        dir_mode = not isinstance(self.dirname, list)
        sizes = []
        for path in files:
            sz = os.stat(path).st_size
            if dir_mode and sz % self.align != 0:
                sz += self.align - sz % self.align
            sizes.append(sz)
        cum = []
        total = 0
        for sz in sizes:
            total += sz
            cum.append(total)

        intsize, strtype = (8, "<Q") if total > 0xFFFFFFFF else (4, "<I")
        header = AWBChunkHeader.pack(b"AFS2", self.version, intsize,
                                     self.id_intsize, len(files), self.align,
                                     self.subkey)
        for i in range(len(files)):
            header += pack("<" + _int_code(self.id_intsize), i)
        headersize = len(header) + intsize * len(files) + intsize
        aligned = headersize + (self.align - headersize % self.align)
        offsets = []
        for idx, x in enumerate(cum):
            v = x + aligned
            if v % self.align != 0 and idx != len(cum) - 1:
                v += self.align - v % self.align
            offsets.append(v)
        offsets = [headersize] + offsets
        for off in offsets:
            header += pack(strtype, off)
        if headersize % self.align != 0:
            header = header.ljust(
                headersize + (self.align - headersize % self.align), b"\x00")
        # "last file skips padding": list mode checks against the whole list;
        # directory mode checks per-directory position (reference awb.py:177-181
        # vs 229-233)
        if dir_mode:
            last_flags = []
            for root, _, names in os.walk(self.dirname):
                for idx, _name in enumerate(names):
                    last_flags.append(idx == len(names) - 1)
        else:
            last_flags = [i == len(files) - 1 for i in range(len(files))]
        with open(outfile, "wb") as out:
            out.write(header)
            for path, is_last in zip(files, last_flags):
                with open(path, "rb") as fh:
                    data = fh.read()
                if len(data) % self.align != 0 and not is_last:
                    data = data.ljust(
                        len(data) + (self.align - len(data) % self.align), b"\x00")
                out.write(data)
