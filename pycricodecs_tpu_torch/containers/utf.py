"""@UTF — CRI's universal binary table format: the reader and the builder.

A copy of `xor_utf`, `UTF` and `UTFBuilder` of
pycricodecs_tpu/containers/utf.py (held equal by
tests/test_torch_containers.py and tests/test_torch_builders.py). Drop-in
behaviour for PyCriCodecs.UTF/UTFBuilder (utf.py:7-355): the same `table`
(columnar dict) and `get_payload()` (list of per-row dicts of
``(UTFTypeValues, value)`` tuples) representations, and the builder emits
the JAX package's bytes for the same payload. Reads and writes the
XOR-encrypted EUTF variant.
"""
from __future__ import annotations

from io import BytesIO
from struct import calcsize, pack, unpack

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


class UTFBuilder:
    """Builds a @UTF table from a payload list (byte-parity with reference)."""

    __slots__ = ["encoding", "dictarray", "encrypt", "strings", "table_name",
                 "binary", "stflag", "rows_data", "column_data", "data_offset"]

    def __init__(self, dictarray: list, encrypt: bool = False,
                 encoding: str = "utf-8",
                 table_name: str = "PyCriCodecs_table") -> None:
        lengths = {len(d) for d in dictarray}
        if len(lengths) != 1:
            raise ValueError("All dictionaries must be equal in length.")
        matches = [(k, v[0]) for k, v in dictarray[0].items()]
        for d in dictarray[1:]:
            if matches != [(k, v[0]) for k, v in d.items()]:
                raise ValueError(
                    "Keys and/or value types are not matching across dictionaries.")
        self.dictarray = dictarray
        self.encrypt = encrypt
        self.encoding = encoding
        self.table_name = table_name
        self.binary = b""
        self._collect_strings()

    def _collect_strings(self) -> None:
        strings = []
        binary = b""
        for d in self.dictarray:
            for key in d:
                if key not in strings:
                    strings.append(key)
        for d in self.dictarray:
            for key, value in d.items():
                if isinstance(value[1], str) and value[1] not in strings:
                    strings.append(value[1])
                if isinstance(value[1], (bytes, bytearray)) and value[1] not in binary:
                    binary += value[1]
        self.binary = bytes(binary)
        strings = [self.table_name] + strings
        if "<NULL>" in strings:
            strings.remove("<NULL>")
            strings = ["<NULL>"] + strings
        encoded = []
        for s in strings:
            raw = s.encode(self.encoding)
            if b"\x00" in raw:
                raise ValueError(
                    f"Encoding of {self.encoding} for '{s}' results in string "
                    "with a null byte.")
            encoded.append(raw)
        self.strings = b"\x00".join(encoded) + b"\x00"

    def _decide_stflags(self) -> None:
        type_list = list(UTFTypeValues)
        self.stflag = []
        for key, first in self.dictarray[0].items():
            tindex = type_list.index(first[0])
            if len(self.dictarray) != 1:
                varies = any(d[key][1] != first[1] for d in self.dictarray)
                if varies:
                    self.stflag.append((0x50, tindex, key))
                elif first[1] is None:
                    self.stflag.append((0x10, tindex, key))
                else:
                    self.stflag.append((0x30, tindex, key, first[1]))
            else:
                if first[1] is None or first[1] == "<NULL>":
                    self.stflag.append((0x10, tindex, key))
                else:
                    self.stflag.append((0x50, tindex, key))

    def _strptr(self, value: str) -> int:
        raw = bytes(value, self.encoding)
        if self.strings.startswith(raw + b"\x00"):
            return 0
        return self.strings.index(b"\x00" + raw + b"\x00") + 1

    def _write_columns(self) -> bytearray:
        out = bytearray()
        for entry in self.stflag:
            storage, tindex, key = entry[0], entry[1], entry[2]
            out += int.to_bytes(storage | tindex, 1, "big")
            name_ptr = self._strptr(key)
            if storage in (0x10, 0x50):
                out += int.to_bytes(name_ptr, 4, "big")
            else:
                value = entry[3]
                out += int.to_bytes(name_ptr, 4, "big")
                if tindex not in (0xA, 0xB):
                    out += int.to_bytes(value, calcsize(_struct_code(tindex)),
                                        "big")
                elif tindex == 0xA:
                    out += int.to_bytes(self._strptr(value), 4, "big")
                else:
                    out += int.to_bytes(self.binary.index(value), 4, "big")
                    out += int.to_bytes(len(value), 4, "big")
        return out

    def _write_rows(self) -> bytearray:
        out = bytearray()
        for d in self.dictarray:
            for entry in self.stflag:
                if entry[0] != 0x50:
                    continue
                tindex, key = entry[1], entry[2]
                value = d[key][1]
                if tindex not in (0xA, 0xB):
                    out += pack(">" + _struct_code(tindex), value)
                elif tindex == 0xA:
                    raw = bytes(value, self.encoding)
                    if raw == b"":
                        idx = self.strings.index(b"\x00\x00") + 1
                        out += pack(">I", idx)
                    else:
                        # _strptr handles the pool's first string (offset 0,
                        # e.g. "<NULL>" mixed into a varying column)
                        out += pack(">I", self._strptr(value))
                else:
                    out += pack(">II", self.binary.index(value), len(value))
        return out

    def _write_header(self) -> bytearray:
        datalen = (len(self.column_data) + len(self.rows_data)
                   + len(self.strings) + len(self.binary) + 0x18)
        self.data_offset = datalen
        if self.data_offset % 8 != 0:
            self.data_offset += 8 - self.data_offset % 8
        binary_offset = self.data_offset if not self.binary \
            else datalen - len(self.binary)
        name_ptr = 0 if self.strings.startswith(
            bytes(self.table_name, self.encoding)) else self.strings.index(
            b"\x00" + bytes(self.table_name, self.encoding) + b"\x00") + 1
        header = UTFChunkHeader.pack(
            b"@UTF",
            self.data_offset,
            len(self.column_data) + 0x18,
            datalen - len(self.strings) - len(self.binary),
            binary_offset,
            name_ptr,
            len(self.stflag),
            sum(calcsize(_struct_code(e[1])) for e in self.stflag
                if e[0] == 0x50),
            len(self.dictarray),
        )
        return bytearray(header)

    def parse(self) -> bytearray:
        """Serialise to a @UTF table (optionally XOR-encrypted)."""
        self._decide_stflags()
        self.column_data = self._write_columns()
        self.rows_data = self._write_rows()
        header = self._write_header()
        data = (header + self.column_data + self.rows_data
                + self.strings + self.binary)
        if len(data) % 8 != 0:
            data = data[:8] + bytes(data[8:]).ljust(self.data_offset, b"\x00")
        data = bytearray(data)
        if self.encrypt:
            data = xor_utf(data)
        return data
