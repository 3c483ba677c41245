"""CPK archive: extractor (TOC/ITOC modes) and builder (modes 0-3).

A copy of `TOC`, `CPK` and `CPKBuilder` of pycricodecs_tpu/containers/cpk.py
(held equal by tests/test_torch_cpk.py), with CRILAYLA on `device`:
`CPK.extract` decompresses the compressed members of an archive in one
launch of kernel C1 (`crilayla.decompress_members`) for each C1_BUDGET
of their bytes, and
`CPKBuilder(compress=True)` compresses the members in one launch of C2
(`crilayla.compress_members`) for each `crilayla.C2_BUDGET` of their bytes. Parity surface: PyCriCodecs.CPK /
CPKBuilder (cpk.py:8-756) — same table walking, extraction layout, and
byte-identical archives from the builder (same TOC size estimation,
alignment, Tvers defaults and header payloads).
"""
from __future__ import annotations

import os
from io import BytesIO, FileIO

from ..models import crilayla
from ..utils import tracing
from ..utils.paths import anchored_join
from .chunk import CPKChunkHeader, CPKChunkHeaderType, UTFTypeValues
from .utf import UTF, UTFBuilder

# bytes of compressed members (read and decompressed) that CPK.extract
# holds for one launch of C1; a larger member is launched alone
C1_BUDGET = 1 << 28


class TOC:
    __slots__ = ["magic", "encflag", "packet_size", "unk0C", "stream", "table"]

    def __init__(self, stream: bytes) -> None:
        self.stream = BytesIO(stream)
        self.magic, self.encflag, self.packet_size, self.unk0C = \
            CPKChunkHeader.unpack(self.stream.read(CPKChunkHeader.size))
        if self.magic not in [h.value for h in CPKChunkHeaderType]:
            raise ValueError(f"{self.magic} header not supported.")
        self.table = UTF(self.stream.read()).table


class CPK:
    __slots__ = ["magic", "encflag", "packet_size", "unk0C", "stream",
                 "tables", "filename", "device"]

    def __init__(self, filename, *, device="cuda") -> None:
        self.device = device
        if isinstance(filename, str):
            self.filename = filename
            self.stream = FileIO(filename)
        else:
            self.stream = BytesIO(filename)
            self.filename = ""
        self.magic, self.encflag, self.packet_size, self.unk0C = \
            CPKChunkHeader.unpack(self.stream.read(CPKChunkHeader.size))
        if self.magic != CPKChunkHeaderType.CPK.value:
            raise ValueError("Invalid CPK file.")
        self.tables = dict(
            CPK=UTF(self.stream.read(0x800 - CPKChunkHeader.size)).table)
        self._check_tocs()

    def checkTocs(self) -> None:
        """Drop-in alias for the reference's checkTocs (cpk.py:45)."""
        return self._check_tocs()

    def _check_tocs(self) -> None:
        cpk = self.tables["CPK"]
        specs = [("TocOffset", "TocSize", "TOC"),
                 ("ItocOffset", "ItocSize", "ITOC"),
                 ("HtocOffset", "HtocSize", "HTOC"),
                 ("GtocOffset", "GtocSize", "GTOC"),
                 ("HgtocOffset", "HgtocSize", "HGTOC"),
                 ("EtocOffset", "EtocSize", "ETOC")]
        for off_key, size_key, name in specs:
            value = cpk.get(off_key)
            if not value or not self._cell(value, 0):
                continue
            # constant-storage (0x30/0x70) columns keep raw unpack tuples in
            # the columnar table; _cell normalises them (old CPKs use 0x70)
            off = self._cell(value, 0)
            size = self._cell(cpk.get(size_key, [0]), 0)
            end = self.stream.seek(0, 2)
            if not isinstance(off, int) or not isinstance(size, int) \
                    or off < 0 or size < 0 or off > end:
                raise ValueError(f"Corrupt CPK {off_key}/{size_key}.")
            self.stream.seek(off, 0)
            # clamp: FileIO.read pre-allocates the requested size, so a
            # forged u64 here would be a multi-GB allocation
            self.tables[name] = TOC(
                self.stream.read(min(size, end - off))).table
            if name == "ITOC":
                for sub in ("DataL", "DataH"):
                    if sub in self.tables["ITOC"]:
                        self.tables["ITOC"][sub][0] = \
                            UTF(self.tables["ITOC"][sub][0]).table
            elif name == "GTOC":
                for sub in ("AttrData", "Fdata", "Gdata"):
                    if sub in self.tables["GTOC"]:
                        self.tables["GTOC"][sub][0] = \
                            UTF(self.tables["GTOC"][sub][0]).table

    # -- extraction -----------------------------------------------------

    def _read_entry(self, size: int, extract_size: int) -> bytes:
        data = self.stream.read(size)
        if extract_size > size:
            return crilayla.decompress(data, device=self.device)
        return data

    def _read_at(self, pos: int, size: int) -> bytes:
        self.stream.seek(pos, 0)
        return self.stream.read(size)

    def _write_members(self, jobs, failure=None) -> None:
        """Write the planned members [(target, pos, size, compressed,
        makedir)] in order and raise where the JAX package's member loop
        raises, after writing the same earlier members. A raw member is
        read when it is written. The compressed ones are read and parsed
        (the host's magic and size checks) in member order, and
        decompressed in one launch of C1 for each run of members whose
        compressed bytes, in and out, reach C1_BUDGET; a malformed stream
        raises at its member. `failure`, the exception that ended the walk
        of the table, is raised after the last member."""
        i = 0
        while i < len(jobs):
            parsed, bad, held, j = [], None, 0, i
            # spans as `crilayla.decompress_batch` makes them; the parse's
            # span holds the members' reads too
            with tracing.span("crilayla.decompress"):
                with tracing.span("crilayla.parse"):
                    while j < len(jobs) and held < C1_BUDGET:
                        _, pos, size, compressed, _ = jobs[j]
                        if compressed:
                            try:
                                p = crilayla.parse(self._read_at(pos, size))
                            except Exception as exc:  # raised at its member
                                bad = exc
                                break
                            parsed.append(p)
                            held += p[1] + p[2] + 512
                        j += 1
                outs = iter(crilayla.decompress_members(parsed,
                                                        device=self.device))
            for target, pos, size, compressed, makedir in jobs[i:j]:
                if makedir:
                    os.makedirs(os.path.dirname(target) or ".",
                                exist_ok=True)
                data = next(outs) if compressed else self._read_at(pos, size)
                if data is None:
                    raise ValueError(crilayla.MALFORMED)
                with open(target, "wb") as fh:
                    fh.write(data)
            if bad is not None:
                if jobs[j][4]:
                    os.makedirs(os.path.dirname(jobs[j][0]) or ".",
                                exist_ok=True)
                raise bad
            i = j
        if failure:
            raise failure

    @staticmethod
    def _cell(col, i):
        """Read row i of a UTF column, normalising constant columns.

        The UTF parser mirrors the reference's table quirk: a column whose
        rows all share one value is stored as a single-element list holding
        a tuple (the reference extractor crashes on such archives, e.g. two
        compressed members that happen to share a compressed size)."""
        v = col[i % len(col)]
        return v[0] if isinstance(v, tuple) else v

    def extract(self, dirname: str = "") -> None:
        """Extract all files (TOC mode by name, ITOC mode by ID)."""
        jobs = []
        try:
            if "TOC" in self.tables:
                toc = self.tables["TOC"]
                base = dirname or (os.path.splitext(self.filename)[0]
                                   if self.filename else "") or "cpk_out"
                written = set()
                for i in range(len(toc["FileName"])):
                    subdir = self._cell(toc["DirName"], i)
                    filename = self._cell(toc["FileName"], i)
                    if len(filename) >= 255:
                        filename = filename[:250] + "_" + str(i)
                    # DirName/FileName are archive data: anchor them under
                    # the output dir (the reference joins them raw —
                    # traversal hole)
                    target = anchored_join(base, subdir or "", filename,
                                           fallback=f"member_{i}")
                    if target in written:
                        # duplicate member names lose data in the reference
                        # ("will overwrite each other", README.md:134);
                        # suffix the row index. splitext keeps the split
                        # inside the basename (a dot in a directory
                        # component must not become the split point — that
                        # would write outside the anchored output dir).
                        stem, ext = os.path.splitext(target)
                        target = f"{stem}_{i}{ext}"
                    written.add(target)
                    pos = 0x800 + self._cell(toc["FileOffset"], i)
                    size = self._cell(toc["FileSize"], i)
                    extract_size = self._cell(toc["ExtractSize"], i)
                    jobs.append((target, pos, size, extract_size > size,
                                 True))
            elif "ITOC" in self.tables:
                align = self._cell(self.tables["CPK"]["Align"], 0)
                offset = self._cell(self.tables["CPK"]["ContentOffset"], 0)
                base = dirname or (os.path.splitext(self.filename)[0]
                                   if self.filename else "")
                if base:
                    os.makedirs(base, exist_ok=True)
                pos = offset
                for file_id, size, extract_size in self._itoc_entries():
                    jobs.append((os.path.join(base, str(file_id)), pos,
                                 size, extract_size > size, False))
                    pos += size + ((align - size % align)
                                   if size % align else 0)
        except Exception as exc:  # re-raised in member order below
            self._write_members(jobs, exc)
        self._write_members(jobs)

    def _itoc_entries(self):
        """Ordered (id, file_size, extract_size) from the ITOC DataL/DataH
        sub-tables, honouring the FilesL/FilesH counts (the builder emits a
        dummy row in an otherwise-empty table; the reference extractor trips
        over it when a real ID 0 exists, cpk.py:118-129)."""
        itoc = self.tables["ITOC"]
        entries = []
        for sub, count_key in (("DataL", "FilesL"), ("DataH", "FilesH")):
            if sub not in itoc:
                continue
            table = itoc[sub][0]
            count = itoc.get(count_key, [len(table["ID"])])[0]
            if isinstance(count, tuple):
                count = count[0]
            for idx in range(min(count, len(table["ID"]))):
                entries.append((self._cell(table["ID"], idx),
                                self._cell(table["FileSize"], idx),
                                self._cell(table["ExtractSize"], idx)))
        entries.sort(key=lambda e: e[0])
        return entries

    def extract_file(self, filename, dirname: str = "") -> None:
        """Extract a single member by name (TOC) or integer ID (ITOC)."""
        if "TOC" in self.tables:
            toc = self.tables["TOC"]
            if filename not in toc["FileName"]:
                raise ValueError("Given filename does not exist inside the provided CPK.")
            idx = toc["FileName"].index(filename)
            base = dirname or (os.path.splitext(self.filename)[0]
                               if self.filename else "")
            subdir = self._cell(toc["DirName"], idx)
            target = anchored_join(base, subdir or "", filename,
                                   fallback=f"member_{idx}")
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            self.stream.seek(0x800 + self._cell(toc["FileOffset"], idx), 0)
            data = self._read_entry(self._cell(toc["FileSize"], idx),
                                    self._cell(toc["ExtractSize"], idx))
            with open(target, "wb") as fh:
                fh.write(data)
        elif "ITOC" in self.tables:
            file_id = int(filename)
            align = self._cell(self.tables["CPK"]["Align"], 0)
            offset = self._cell(self.tables["CPK"]["ContentOffset"], 0)
            pos = offset
            for fid, size, extract_size in self._itoc_entries():
                if fid == file_id:
                    self.stream.seek(pos, 0)
                    data = self._read_entry(size, extract_size)
                    base = dirname or (os.path.splitext(self.filename)[0]
                                       if self.filename else "")
                    if base:
                        os.makedirs(base, exist_ok=True)
                    with open(os.path.join(base, str(file_id)), "wb") as fh:
                        fh.write(data)
                    return
                pos += size + ((align - size % align) if size % align else 0)
            raise ValueError("Given ID does not exist in the given CPK.")


def _sort_key(name: str) -> str:
    return "".join("~" if ch == "_" else ch for ch in name).lower()


class CPKBuilder:
    """Builds CPK archives, modes 0-3 (byte parity with the reference);
    `compress=True` runs kernel C2 on `device` once for all members."""

    __slots__ = ["CpkMode", "Tver", "dirname", "encrypt", "encoding", "files",
                 "fileslen", "ITOCdata", "CPKdata", "ContentSize",
                 "EnabledDataSize", "outfile", "TOCdata", "GTOCdata",
                 "compress", "EnabledPackedSize", "init_toc_len", "device"]

    _DEFAULT_TVERS = {
        0: "CPKMC2.18.04, DLL2.78.04",
        1: "CPKMC2.45.00, DLL3.15.00",
        2: "CPKMC2.49.32, DLL3.24.00",
        3: "CPKFBSTD1.49.35, DLL3.24.00",
    }

    def __init__(self, dirname: str, outfile: str, CpkMode: int = 1,
                 Tver: str = False, encrypt: bool = False,
                 encoding: str = "utf-8", compress: bool = False, *,
                 device="cuda") -> None:
        self.device = device
        if CpkMode not in (0, 1, 2, 3):
            raise ValueError("Unknown CpkMode.")
        self.CpkMode = CpkMode
        self.Tver = Tver if Tver else self._DEFAULT_TVERS[CpkMode]
        if dirname == "":
            raise ValueError("Invalid directory name/path.")
        if CpkMode == 0 and compress:
            raise NotImplementedError(
                "CpkMode of 0 with compression is not supported yet.")
        self.dirname = dirname
        self.encrypt = encrypt
        self.encoding = encoding
        self.EnabledDataSize = 0
        self.EnabledPackedSize = 0
        self.ContentSize = 0
        self.outfile = outfile
        self.compress = compress
        self._generate()

    # -- helpers ---------------------------------------------------------

    def _pad(self, data: bytearray) -> bytearray:
        return data.ljust(len(data) + (0x800 - len(data) % 0x800), b"\x00")

    def _chunk(self, tag: bytes, table: bytearray) -> bytearray:
        encflag = 0 if self.encrypt else 0xFF
        return bytearray(CPKChunkHeader.pack(tag, encflag, len(table), 0)) + table

    def _generate(self) -> None:
        if self.CpkMode == 3:
            self.TOCdata = self._pad(self._chunk(b"TOC ", self._generate_toc()))
            assert self.init_toc_len == len(self.TOCdata)
            self.GTOCdata = self._pad(self._chunk(b"GTOC", self._generate_gtoc()))
            self.CPKdata = self._chunk(b"CPK ", self._generate_cpk())
            data = (self.CPKdata.ljust(
                len(self.CPKdata) + (0x800 - len(self.CPKdata) % 0x800) - 6,
                b"\x00") + bytearray(b"(c)CRI") + self.TOCdata + self.GTOCdata)
        elif self.CpkMode == 2:
            self.TOCdata = self._pad(self._chunk(b"TOC ", self._generate_toc()))
            assert self.init_toc_len == len(self.TOCdata)
            self.ITOCdata = self._pad(self._chunk(b"ITOC", self._generate_itoc()))
            self.CPKdata = self._chunk(b"CPK ", self._generate_cpk())
            data = (self.CPKdata.ljust(
                len(self.CPKdata) + (0x800 - len(self.CPKdata) % 0x800) - 6,
                b"\x00") + bytearray(b"(c)CRI") + self.TOCdata + self.ITOCdata)
        elif self.CpkMode == 1:
            self.TOCdata = self._pad(self._chunk(b"TOC ", self._generate_toc()))
            assert self.init_toc_len == len(self.TOCdata)
            self.CPKdata = self._chunk(b"CPK ", self._generate_cpk())
            data = (self.CPKdata.ljust(
                len(self.CPKdata) + (0x800 - len(self.CPKdata) % 0x800) - 6,
                b"\x00") + bytearray(b"(c)CRI") + self.TOCdata)
        else:
            self.ITOCdata = self._pad(self._chunk(b"ITOC", self._generate_itoc()))
            self.CPKdata = self._chunk(b"CPK ", self._generate_cpk())
            data = (self.CPKdata.ljust(
                len(self.CPKdata) + (0x800 - len(self.CPKdata) % 0x800) - 6,
                b"\x00") + bytearray(b"(c)CRI") + self.ITOCdata)
        self._write(data)

    def _write(self, data) -> None:
        with open(self.outfile, "wb") as out:
            out.write(data)
            if self.compress:
                for blob in self.files:
                    if len(blob) % 0x800 != 0:
                        blob = blob.ljust(
                            len(blob) + (0x800 - len(blob) % 0x800), b"\x00")
                    out.write(blob)
            else:
                for path in self.files:
                    with open(path, "rb") as fh:
                        blob = fh.read()
                    if len(blob) % 0x800 != 0:
                        blob = blob.ljust(
                            len(blob) + (0x800 - len(blob) % 0x800), b"\x00")
                    out.write(blob)

    def _collect_files(self, listing, root) -> None:
        for name in listing:
            path = os.path.join(root, name)
            if os.path.isdir(path):
                self._collect_files(
                    sorted(os.listdir(path), key=_sort_key), path)
            else:
                self.files.append(path)

    def _generate_toc(self) -> bytearray:
        payload = []
        self.files = []
        compressed = []
        self._collect_files(sorted(os.listdir(self.dirname), key=_sort_key),
                            self.dirname)

        # TOC size estimation (reference cpk.py:408-443)
        count = 0
        lent = 0
        switch = False
        # the UTF string pool dedups GLOBALLY (utf.py:215-239): one seen-set
        # covering dir names, file names and the strings already in the pool
        # (table name, column keys, "<NULL>") keeps the estimate exact where
        # the reference's separate dir/file sets over-count and trip the
        # size assert (or corrupt FileOffsets under python -O)
        seen = {"CpkTocInfo", "DirName", "FileName", "FileSize",
                "ExtractSize", "FileOffset", "ID", "UserString", "<NULL>"}
        seen_dirs = set()
        for path in self.files:
            dname = self._rel_dirname(path)
            if dname not in seen_dirs:
                switch = True
                seen_dirs.add(dname)
            if dname not in seen:
                lent += len(dname) + 1
                seen.add(dname)
            fname = os.path.basename(path)
            if fname not in seen:
                lent += len(fname) + 1
                seen.add(fname)
            count += 1
        if switch and len(seen_dirs) != 1:
            lent = lent + (4 + 4 + 4 + 4 + 8 + 4) * count + 0x47 + 0x51
        else:
            lent = lent + (4 + 4 + 4 + 8 + 4) * count + 0x4B + 0x51
        if lent % 8 != 0:
            lent = 8 + (lent - 8) + (8 - (lent - 8) % 8)
        lent += 0x10
        lent = lent + (0x800 - lent % 0x800)
        self.init_toc_len = lent

        self.fileslen = count
        sizes = []
        for path in self.files:
            sz = os.stat(path).st_size
            if sz > 0xFFFFFFFF:
                raise OverflowError(
                    "4GBs is the max size of a single file that can be bundled "
                    "in a CPK archive of mode 1.")
            sizes.append(sz)
        if self.compress:
            raws = []
            for path in self.files:
                with open(path, "rb") as fh:
                    raws.append(fh.read())
            # one launch of C2 a C2_BUDGET of members; None is the
            # kernel's own refusal (0x100 bytes or fewer, or over
            # capacity), the JAX native's `return 0` that its caller stores
            # raw. A build or launch failure raises.
            comps = crilayla.compress_members(raws, device=self.device)
        for idx, path in enumerate(self.files):
            sz = sizes[idx]
            fz = sz
            if self.compress:
                # NOTE: valid semantics (FileSize = stored/compressed,
                # ExtractSize = decompressed) — the reference builder writes
                # these swapped (cpk.py:479-480), producing archives its own
                # extractor cannot decompress.
                self.EnabledDataSize += sz
                raw = raws[idx]
                comp = raw if comps[idx] is None else comps[idx]
                if len(comp) >= sz:
                    comp = raw  # store raw: the ExtractSize>FileSize trigger
                                # can't represent expansion
                compressed.append(comp)
                fz = len(comp)
                self.EnabledPackedSize += fz
                self.ContentSize += fz + ((0x800 - fz % 0x800) if fz % 0x800 else 0)
            else:
                self.EnabledDataSize += sz
                self.EnabledPackedSize += sz
                self.ContentSize += sz + ((0x800 - sz % 0x800) if sz % 0x800 else 0)
            payload.append({
                "DirName": (UTFTypeValues.string, self._rel_dirname(path)),
                "FileName": (UTFTypeValues.string, os.path.basename(path)),
                "FileSize": (UTFTypeValues.uint, sz if not self.compress else fz),
                "ExtractSize": (UTFTypeValues.uint, sz),
                "FileOffset": (UTFTypeValues.ullong, lent),
                "ID": (UTFTypeValues.uint, idx),
                "UserString": (UTFTypeValues.string, "<NULL>"),
            })
            step = fz if self.compress else sz
            lent += step + ((0x800 - step % 0x800) if step % 0x800 else 0)
        if self.compress:
            self.files = compressed
        return UTFBuilder(payload, encrypt=self.encrypt,
                          encoding=self.encoding,
                          table_name="CpkTocInfo").parse()

    def _rel_dirname(self, path: str) -> str:
        # the reference splits on every occurrence of the root dir string
        # (cpk.py:406), corrupting DirName when a subpath repeats it; use a
        # real relative path instead (identical output for sane trees)
        dname = os.path.dirname(os.path.relpath(path, self.dirname))
        if dname == ".":
            dname = ""
        return dname.replace("\\", "/").replace(os.sep, "/")

    def _generate_gtoc(self) -> bytearray:
        gdata = [
            {"Gname": (UTFTypeValues.string, ""),
             "Child": (UTFTypeValues.int, -1),
             "Next": (UTFTypeValues.int, 0)},
            {"Gname": (UTFTypeValues.string, "(none)"),
             "Child": (UTFTypeValues.int, 0),
             "Next": (UTFTypeValues.int, 0)},
        ]
        fdata = [
            {"Next": (UTFTypeValues.int, -1), "Child": (UTFTypeValues.int, -1),
             "SortFlink": (UTFTypeValues.int, 2),
             "Aindex": (UTFTypeValues.ushort, 0)},
            {"Next": (UTFTypeValues.int, 2), "Child": (UTFTypeValues.int, 0),
             "SortFlink": (UTFTypeValues.int, 1),
             "Aindex": (UTFTypeValues.ushort, 0)},
            {"Next": (UTFTypeValues.int, 0), "Child": (UTFTypeValues.int, 1),
             "SortFlink": (UTFTypeValues.int, 2),
             "Aindex": (UTFTypeValues.ushort, 0)},
        ]
        attrdata = [
            {"Aname": (UTFTypeValues.string, ""),
             "Align": (UTFTypeValues.ushort, 0x800),
             "Files": (UTFTypeValues.uint, 0),
             "FileSize": (UTFTypeValues.uint, 0)},
        ]
        payload = [{
            "Glink": (UTFTypeValues.uint, 2),
            "Flink": (UTFTypeValues.uint, 3),
            "Attr": (UTFTypeValues.uint, 1),
            "Gdata": (UTFTypeValues.bytes, bytes(UTFBuilder(
                gdata, encrypt=False, encoding=self.encoding,
                table_name="CpkGtocGlink").parse())),
            "Fdata": (UTFTypeValues.bytes, bytes(UTFBuilder(
                fdata, encrypt=False, encoding=self.encoding,
                table_name="CpkGtocFlink").parse())),
            "Attrdata": (UTFTypeValues.bytes, bytes(UTFBuilder(
                attrdata, encrypt=False, encoding=self.encoding,
                table_name="CpkGtocAttr").parse())),
        }]
        return UTFBuilder(payload, encrypt=self.encrypt,
                          encoding=self.encoding,
                          table_name="CpkGtocInfo").parse()

    def _generate_itoc(self) -> bytearray:
        if self.CpkMode == 2:
            payload = [{"ID": (UTFTypeValues.int, i),
                        "TocIndex": (UTFTypeValues.int, i)}
                       for i in range(len(self.files))]
            return UTFBuilder(payload, encrypt=self.encrypt,
                              encoding=self.encoding,
                              table_name="CpkExtendId").parse()
        try:
            listing = sorted(os.listdir(self.dirname), key=int)
        except ValueError:
            raise ValueError("CpkMode of 0 requires filenames to be integers.")
        self.files = [os.path.join(self.dirname, f) for f in listing]
        if not listing:
            raise ValueError("No files are present in the given directory.")
        if len(listing) > 0xFFFF:
            raise OverflowError(
                "CpkMode of 0 can only contain 65535 files at max.")
        self.fileslen = len(listing)
        datal, datah = [], []
        for name in listing:
            sz = os.stat(os.path.join(self.dirname, name)).st_size
            self.EnabledDataSize += sz
            self.ContentSize += sz + ((0x800 - sz % 0x800) if sz % 0x800 else 0)
            if sz > 0xFFFF:
                datah.append({"ID": (UTFTypeValues.ushort, int(name)),
                              "FileSize": (UTFTypeValues.uint, sz),
                              "ExtractSize": (UTFTypeValues.uint, sz)})
            else:
                datal.append({"ID": (UTFTypeValues.ushort, int(name)),
                              "FileSize": (UTFTypeValues.ushort, sz),
                              "ExtractSize": (UTFTypeValues.ushort, sz)})
        datallen, datahlen = len(datal), len(datah)
        self.EnabledPackedSize = self.EnabledDataSize
        if not datal:
            datal.append({"ID": (UTFTypeValues.ushort, 0),
                          "FileSize": (UTFTypeValues.ushort, 0),
                          "ExtractSize": (UTFTypeValues.ushort, 0)})
        elif not datah:
            datah.append({"ID": (UTFTypeValues.uint, 0),
                          "FileSize": (UTFTypeValues.uint, 0),
                          "ExtractSize": (UTFTypeValues.uint, 0)})
        payload = [{
            "FilesL": (UTFTypeValues.uint, datallen),
            "FilesH": (UTFTypeValues.uint, datahlen),
            "DataL": (UTFTypeValues.bytes, bytes(UTFBuilder(
                datal, table_name="CpkItocL", encrypt=False,
                encoding=self.encoding).parse())),
            "DataH": (UTFTypeValues.bytes, bytes(UTFBuilder(
                datah, table_name="CpkItocH", encrypt=False,
                encoding=self.encoding).parse())),
        }]
        return UTFBuilder(payload, table_name="CpkItocInfo",
                          encrypt=self.encrypt, encoding=self.encoding).parse()

    def _generate_cpk(self) -> bytearray:
        tv = UTFTypeValues
        mode = self.CpkMode
        if mode == 3:
            content_offset = 0x800 + len(self.TOCdata) + len(self.GTOCdata)
            fields = [
                ("UpdateDateTime", tv.ullong, 0),
                ("ContentOffset", tv.ullong, content_offset),
                ("ContentSize", tv.ullong, self.ContentSize),
                ("TocOffset", tv.ullong, 0x800),
                ("TocSize", tv.ullong, len(self.TOCdata)),
                ("EtocOffset", tv.ullong, None),
                ("EtocSize", tv.ullong, None),
                ("GtocOffset", tv.ullong, 0x800 + len(self.TOCdata)),
                ("GtocSize", tv.ullong, len(self.GTOCdata)),
                ("EnabledPackedSize", tv.ullong, self.EnabledPackedSize),
                ("EnabledDataSize", tv.ullong, self.EnabledDataSize),
                ("Files", tv.uint, self.fileslen),
                ("Groups", tv.uint, 0),
                ("Attrs", tv.uint, 0),
                ("Version", tv.ushort, 7),
                ("Revision", tv.ushort, 14),
                ("Align", tv.ushort, 0x800),
                ("Sorted", tv.ushort, 1),
                ("EnableFileName", tv.ushort, 1),
                ("CpkMode", tv.uint, mode),
                ("Tvers", tv.string, self.Tver),
                ("Codec", tv.uint, 0),
                ("DpkItoc", tv.uint, 0),
                ("EnableTocCrc", tv.ushort, None),
                ("EnableFileCrc", tv.ushort, None),
                ("CrcMode", tv.uint, None),
                ("CrcTable", tv.bytes, b""),
                ("FileSize", tv.ullong, None),
                ("TocCrc", tv.uint, None),
                ("HtocOffset", tv.ullong, None),
                ("HtocSize", tv.ullong, None),
                ("ItocOffset", tv.ullong, None),
                ("ItocSize", tv.ullong, None),
                ("ItocCrc", tv.uint, None),
                ("GtocCrc", tv.uint, None),
                ("HgtocOffset", tv.ullong, None),
                ("HgtocSize", tv.ullong, None),
                ("TotalDataSize", tv.ullong, None),
                ("Tocs", tv.uint, None),
                ("TotalFiles", tv.uint, None),
                ("Directories", tv.uint, None),
                ("Updates", tv.uint, None),
                ("EID", tv.ushort, None),
                ("Comment", tv.string, "<NULL>"),
            ]
        elif mode == 2:
            content_offset = 0x800 + len(self.TOCdata) + len(self.ITOCdata)
            fields = [
                ("UpdateDateTime", tv.ullong, 0),
                ("ContentOffset", tv.ullong, content_offset),
                ("ContentSize", tv.ullong, self.ContentSize),
                ("TocOffset", tv.ullong, 0x800),
                ("TocSize", tv.ullong, len(self.TOCdata)),
                ("EtocOffset", tv.ullong, None),
                ("EtocSize", tv.ullong, None),
                ("ItocOffset", tv.ullong, 0x800 + len(self.TOCdata)),
                ("ItocSize", tv.ullong, len(self.ITOCdata)),
                ("EnabledPackedSize", tv.ullong, self.EnabledPackedSize),
                ("EnabledDataSize", tv.ullong, self.EnabledDataSize),
                ("Files", tv.uint, self.fileslen),
                ("Groups", tv.uint, 0),
                ("Attrs", tv.uint, 0),
                ("Version", tv.ushort, 7),
                ("Revision", tv.ushort, 14),
                ("Align", tv.ushort, 0x800),
                ("Sorted", tv.ushort, 1),
                ("EnableFileName", tv.ushort, 1),
                ("EID", tv.ushort, None),
                ("CpkMode", tv.uint, mode),
                ("Tvers", tv.string, self.Tver),
                ("Codec", tv.uint, 0),
                ("DpkItoc", tv.uint, 0),
                ("EnableTocCrc", tv.ushort, None),
                ("EnableFileCrc", tv.ushort, None),
                ("CrcMode", tv.uint, None),
                ("CrcTable", tv.bytes, b""),
                ("FileSize", tv.ullong, None),
                ("TocCrc", tv.uint, None),
                ("HtocOffset", tv.ullong, None),
                ("HtocSize", tv.ullong, None),
                ("ItocCrc", tv.uint, None),
                ("GtocOffset", tv.ullong, None),
                ("GtocSize", tv.ullong, None),
                ("HgtocOffset", tv.ullong, None),
                ("HgtocSize", tv.ullong, None),
                ("TotalDataSize", tv.ullong, None),
                ("Tocs", tv.uint, None),
                ("TotalFiles", tv.uint, None),
                ("Directories", tv.uint, None),
                ("Updates", tv.uint, None),
                ("Comment", tv.string, "<NULL>"),
            ]
        elif mode == 1:
            content_offset = 0x800 + len(self.TOCdata)
            fields = [
                ("UpdateDateTime", tv.ullong, 0),
                ("FileSize", tv.ullong, None),
                ("ContentOffset", tv.ullong, content_offset),
                ("ContentSize", tv.ullong, self.ContentSize),
                ("TocOffset", tv.ullong, 0x800),
                ("TocSize", tv.ullong, len(self.TOCdata)),
                ("TocCrc", tv.uint, None),
                ("EtocOffset", tv.ullong, None),
                ("EtocSize", tv.ullong, None),
                ("ItocOffset", tv.ullong, None),
                ("ItocSize", tv.ullong, None),
                ("ItocCrc", tv.uint, None),
                ("GtocOffset", tv.ullong, None),
                ("GtocSize", tv.ullong, None),
                ("GtocCrc", tv.uint, None),
                ("EnabledPackedSize", tv.ullong, self.EnabledPackedSize),
                ("EnabledDataSize", tv.ullong, self.EnabledDataSize),
                ("TotalDataSize", tv.ullong, None),
                ("Tocs", tv.uint, None),
                ("Files", tv.uint, self.fileslen),
                ("Groups", tv.uint, 0),
                ("Attrs", tv.uint, 0),
                ("TotalFiles", tv.uint, None),
                ("Directories", tv.uint, None),
                ("Updates", tv.uint, None),
                ("Version", tv.ushort, 7),
                ("Revision", tv.ushort, 1),
                ("Align", tv.ushort, 0x800),
                ("Sorted", tv.ushort, 1),
                ("EID", tv.ushort, None),
                ("CpkMode", tv.uint, mode),
                ("Tvers", tv.string, self.Tver),
                ("Comment", tv.string, "<NULL>"),
                ("Codec", tv.uint, 0),
                ("DpkItoc", tv.uint, 0),
                ("EnableFileName", tv.ushort, 1),
                ("EnableTocCrc", tv.ushort, None),
                ("EnableFileCrc", tv.ushort, None),
                ("CrcMode", tv.uint, None),
                ("CrcTable", tv.bytes, b""),
                ("HtocOffset", tv.ullong, None),
                ("HtocSize", tv.ullong, None),
                ("HgtocOffset", tv.ullong, None),
                ("HgtocSize", tv.ullong, None),
            ]
        else:
            fields = [
                ("UpdateDateTime", tv.ullong, 0),
                ("ContentOffset", tv.ullong, 0x800 + len(self.ITOCdata)),
                ("ContentSize", tv.ullong, self.ContentSize),
                ("ItocOffset", tv.ullong, 0x800),
                ("ItocSize", tv.ullong, len(self.ITOCdata)),
                ("EnabledPackedSize", tv.ullong, self.EnabledPackedSize),
                ("EnabledDataSize", tv.ullong, self.EnabledDataSize),
                ("Files", tv.uint, self.fileslen),
                ("Groups", tv.uint, 0),
                ("Attrs", tv.uint, 0),
                ("Version", tv.ushort, 7),
                ("Revision", tv.ushort, 0),
                ("Align", tv.ushort, 0x800),
                ("Sorted", tv.ushort, 0),
                ("EID", tv.ushort, None),
                ("CpkMode", tv.uint, mode),
                ("Tvers", tv.string, self.Tver),
                ("Codec", tv.uint, 0),
                ("DpkItoc", tv.uint, 0),
                ("FileSize", tv.ullong, None),
                ("TocOffset", tv.ullong, None),
                ("TocSize", tv.ullong, None),
                ("TocCrc", tv.uint, None),
                ("EtocOffset", tv.ullong, None),
                ("EtocSize", tv.ullong, None),
                ("ItocCrc", tv.uint, None),
                ("GtocOffset", tv.ullong, None),
                ("GtocSize", tv.ullong, None),
                ("GtocCrc", tv.uint, None),
                ("TotalDataSize", tv.ullong, None),
                ("Tocs", tv.uint, None),
                ("TotalFiles", tv.uint, None),
                ("Directories", tv.uint, None),
                ("Updates", tv.uint, None),
                ("Comment", tv.string, "<NULL>"),
            ]
        payload = [{k: (t, v) for (k, t, v) in fields}]
        return UTFBuilder(payload, encrypt=self.encrypt,
                          encoding=self.encoding,
                          table_name="CpkHeader").parse()
