"""@UTF — CRI's universal binary table format: the reader.

A copy of `xor_utf` and `UTF` of pycricodecs_tpu/containers/utf.py (held
equal by tests/test_torch_containers.py); the builder stays in the JAX
package. Drop-in behaviour for PyCriCodecs.UTF (utf.py:7-196): the same
`table` (columnar dict) and `get_payload()` (list of per-row dicts of
``(UTFTypeValues, value)`` tuples) representations. Reads the XOR-encrypted
EUTF variant.
"""
from __future__ import annotations

from io import BytesIO
from struct import calcsize, unpack

import numpy as np

from .chunk import UTFChunkHeader, UTFType, UTFTypeValues

_TYPE_CODES = "BbHhIiQqfdI"


def _struct_code(type_flag: int) -> str:
    if type_flag == 0xB:
        return "II"
    return _TYPE_CODES[type_flag]


def xor_utf(data: bytes) -> bytearray:
    """The @UTF XOR stream cipher (involution): m=0x655F, m*=0x4115 per byte."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n = len(buf)
    # keystream: m_k = 0x655F * 0x4115^k mod 2^32, low byte
    ks = np.empty(n, dtype=np.uint32)
    m = np.uint32(0x655F)
    t = np.uint32(0x4115)
    # vectorised: successive powers via cumprod in uint32 (wraps mod 2^32)
    with np.errstate(over="ignore"):
        powers = np.concatenate(
            [[np.uint32(1)], np.cumprod(np.full(n - 1, t, dtype=np.uint32),
                                        dtype=np.uint32)]) if n else ks[:0]
        ks = (np.uint32(m) * powers).astype(np.uint32)
    return bytearray((buf ^ (ks & 0xFF).astype(np.uint8)).tobytes())


class UTF:
    """Parses a @UTF table from bytes or a file path."""

    __slots__ = ["magic", "table_size", "rows_offset", "string_offset",
                 "data_offset", "table_name", "num_columns", "row_length",
                 "num_rows", "stream", "table", "encoding", "_payload"]

    def __init__(self, stream) -> None:
        if isinstance(stream, str):
            with open(stream, "rb") as fh:
                data = fh.read()
        else:
            data = bytes(stream)
        if data[:4] == UTFType.EUTF.value:
            data = bytes(xor_utf(data))
            if data[:4] != UTFType.UTF.value:
                raise Exception("Decryption error.")
        elif data[:4] != UTFType.UTF.value:
            raise ValueError("UTF chunk is not present.")
        self.stream = BytesIO(data)
        (magic, self.table_size, self.rows_offset, self.string_offset,
         self.data_offset, table_name_ptr, self.num_columns, self.row_length,
         self.num_rows) = UTFChunkHeader.unpack(data[:UTFChunkHeader.size])
        # hostile headers: a u32 row count whose rows cannot fit in the blob
        # would spin the row loop for minutes (or build a giant payload)
        cap = len(data) if self.row_length else 0x100000
        if self.num_rows * max(self.row_length, 1) > max(cap, 1):
            raise ValueError("Implausible @UTF row count.")
        self.magic = magic
        self._parse(data, table_name_ptr)

    def _parse(self, data: bytes, table_name_ptr: int) -> None:
        body = data[UTFChunkHeader.size:]
        pos = 0
        columns = []  # (name_ptr, storage, type_flag, const_raw)
        for _ in range(self.num_columns):
            flag = body[pos]
            pos += 1
            storage = flag >> 4
            type_flag = flag & 0xF
            name_ptr = int.from_bytes(body[pos:pos + 4], "big")
            pos += 4
            const_raw = None
            if storage in (0x3, 0x7):
                # 0x70 appears in old CPKs; the reference raises
                # NotImplementedError (utf.py:73-76).  Community decoders
                # treat it as a second constant-with-value storage class
                # ("CONSTANT2"), identical to 0x30 — the value lives in the
                # column header.  We parse it so old archives extract.
                code = _struct_code(type_flag)
                width = calcsize(">" + code)
                const_raw = unpack(">" + code, body[pos:pos + width])
                pos += width
            elif storage not in (0x1, 0x5):
                raise Exception("Unknown storage flag.")
            columns.append((name_ptr, storage, type_flag, const_raw))

        rows = []
        for _ in range(self.num_rows):
            row = []
            for (_, storage, type_flag, _) in columns:
                if storage == 0x5:
                    code = _struct_code(type_flag)
                    width = calcsize(">" + code)
                    row.append(unpack(">" + code, body[pos:pos + width]))
                    pos += width
                else:
                    row.append(None)
            rows.append(row)

        # string pool: from string_offset (relative to +8) to data_offset
        strings_blob = data[8 + self.string_offset:8 + self.data_offset]
        raw_strings = strings_blob.split(b"\x00")
        self.encoding = "utf-8"
        decoded = []
        for s in raw_strings:
            for enc in ("utf-8", "shift-jis", "utf-16"):
                try:
                    decoded.append(s.decode(enc))
                    if enc != "utf-8":
                        self.encoding = enc
                    break
                except UnicodeDecodeError:
                    continue
            else:
                decoded.append(s.decode("utf-8", errors="replace"))

        def str_at(ptr: int) -> str:
            total = 0
            for i, s in enumerate(raw_strings):
                if total >= ptr:
                    return decoded[i]
                total += len(raw_strings[i]) + 1
            raise Exception("Failed string lookup.")

        def fetch(type_flag, raw):
            if type_flag == 0xA:
                return str_at(raw[0])
            if type_flag == 0xB:
                off, size = raw
                return data[8 + self.data_offset + off:
                            8 + self.data_offset + off + size]
            return raw[0]

        self.table_name = str_at(table_name_ptr)
        type_list = list(UTFTypeValues)

        table: dict = {}
        const_entries = {}  # name -> (enum, value)
        # constants first (name-only then valued), matching reference order
        for (name_ptr, storage, type_flag, const_raw) in columns:
            name = str_at(name_ptr)
            if storage == 0x1:
                if type_flag == 0xA:
                    table.setdefault(name, []).append("<NULL>")
                    const_entries[name] = (UTFTypeValues.string, "<NULL>")
                elif type_flag == 0xB:
                    table.setdefault(name, []).append(b"")
                    const_entries[name] = (UTFTypeValues.bytes, b"")
                else:
                    table.setdefault(name, []).append(0)
                    const_entries[name] = (type_list[type_flag], None)
        for (name_ptr, storage, type_flag, const_raw) in columns:
            if storage in (0x3, 0x7):
                name = str_at(name_ptr)
                val = fetch(type_flag, const_raw)
                # quirk parity: the reference's columnar table keeps the raw
                # unpack tuple for valued constants (utf.py:127)
                table.setdefault(name, []).append(
                    val if type_flag in (0xA, 0xB) else const_raw)
                const_entries[name] = (type_list[type_flag], val)

        payload = []
        for row in rows:
            row_dict = {}
            for (name_ptr, storage, type_flag, _), raw in zip(columns, row):
                if storage != 0x5:
                    continue
                name = str_at(name_ptr)
                val = fetch(type_flag, raw)
                table.setdefault(name, []).append(val)
                row_dict[name] = (type_list[type_flag], val)
            row_dict.update(const_entries)
            payload.append(row_dict)
        if not rows:
            payload.append(dict(const_entries))
        self.table = table
        self._payload = payload

    def get_payload(self) -> list:
        """Row-dict payload (WannaCri-compatible, reference utf.py:177-187)."""
        return self._payload
