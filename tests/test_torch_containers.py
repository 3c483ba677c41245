"""PyTorch port, the container readers it copies: chunk.py, the @UTF reader
(`xor_utf`, `UTF`), the AWB reader and `build_afs2`, the ACB reader, sniff
and the path anchoring are equal to the JAX package's on tables and banks
the JAX builders make (plain and XOR-encrypted @UTF tables, every column
type and storage class, 8-byte offsets and ids, subkeys, embedded and
sibling AWBs, cue names through synths and sequences). Extraction writes
the same files. No module of the port, and not chip_smoke.py, imports jax
or pycricodecs_tpu (checked on the source, by AST).
"""
import ast
import enum
import os
import struct

import numpy as np
import pytest

from pycricodecs_tpu.containers import acb as jax_acb
from pycricodecs_tpu.containers import awb as jax_awb
from pycricodecs_tpu.containers import chunk as jax_chunk
from pycricodecs_tpu.containers import utf as jax_utf
from pycricodecs_tpu.containers.chunk import UTFTypeValues as TV
from pycricodecs_tpu.utils import paths as jax_paths
from pycricodecs_tpu.utils import sniff as jax_sniff
from pycricodecs_tpu_torch.containers import acb as port_acb
from pycricodecs_tpu_torch.containers import awb as port_awb
from pycricodecs_tpu_torch.containers import chunk as port_chunk
from pycricodecs_tpu_torch.containers import utf as port_utf
from pycricodecs_tpu_torch.utils import paths as port_paths
from pycricodecs_tpu_torch.utils import sniff as port_sniff
from tests import torch_port_helpers as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(x):
    """Payloads and tables with enums as (class name, member name, value),
    so the two packages' (distinct) enum classes compare."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    return x


# -- chunk.py ----------------------------------------------------------------

def test_chunk_structs_and_enums_equal():
    structs = [n for n, v in vars(jax_chunk).items()
               if isinstance(v, struct.Struct)]
    enums = [n for n, v in vars(jax_chunk).items()
             if isinstance(v, type) and issubclass(v, enum.Enum)
             and v is not enum.Enum]
    assert len(structs) == 9 and len(enums) == 8
    for n in structs:
        assert getattr(port_chunk, n).format == getattr(jax_chunk, n).format
    for n in enums:
        got = [(m.name, m.value) for m in getattr(port_chunk, n)]
        assert got == [(m.name, m.value) for m in getattr(jax_chunk, n)], n


# -- @UTF ----------------------------------------------------------------------

def _every_type_payload(rows: int):
    """A payload with a column of every type, varying, constant-valued and
    empty-constant columns, '<NULL>' strings and blobs."""
    out = []
    for i in range(rows):
        out.append({
            "U8": (TV.uchar, 200 + i % 50), "I8": (TV.char, -5 - i),
            "U16": (TV.ushort, 0xFFF0 + i % 8), "I16": (TV.short, -300 * i),
            "U32": (TV.uint, 0xFFFF0000 + i), "I32": (TV.int, -(1 << 30) + i),
            "U64": (TV.ullong, (1 << 63) + i), "I64": (TV.llong, -(1 << 40) - i),
            "F32": (TV.float, 0.5 + i), "F64": (TV.double, -1.25 * i),
            "Str": (TV.string, f"name_{i}"), "Blob": (TV.bytes, bytes([i]) * (i + 3)),
            "ConstU16": (TV.ushort, 7), "ConstStr": (TV.string, "same"),
            "Empty": (TV.uint, None), "NullStr": (TV.string, "<NULL>"),
        })
    return out


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("encrypt", [False, True])
def test_utf_reader_equal_on_jax_built_tables(rows, encrypt):
    blob = bytes(jax_utf.UTFBuilder(_every_type_payload(rows), encrypt=encrypt,
                                    table_name="Every").parse())
    if encrypt:
        assert blob[:4] == b"\x1f\x9e\xf3\xf5"
    ref, got = jax_utf.UTF(blob), port_utf.UTF(blob)
    assert _norm(got.get_payload()) == _norm(ref.get_payload())
    assert _norm(got.table) == _norm(ref.table)
    for attr in ("table_name", "num_rows", "num_columns", "row_length",
                 "encoding", "magic", "table_size"):
        assert getattr(got, attr) == getattr(ref, attr), attr


def test_xor_utf_equal():
    data = np.random.default_rng(3).integers(0, 256, 1000, np.uint8).tobytes()
    for n in (0, 1, 7, 1000):
        assert port_utf.xor_utf(data[:n]) == jax_utf.xor_utf(data[:n])


def test_utf_reader_errors_equal(tmp_path):
    blob = bytes(jax_utf.UTFBuilder(_every_type_payload(2)).parse())
    path = tmp_path / "t.utf"
    path.write_bytes(blob)
    assert _norm(port_utf.UTF(str(path)).get_payload()) == \
        _norm(jax_utf.UTF(str(path)).get_payload())
    bad_rows = bytearray(blob)
    bad_rows[26:30] = (1 << 30).to_bytes(4, "big")
    for data in (b"NOPE" + blob[4:], bytes(bad_rows)):
        got = H.outcome(port_utf.UTF, data)
        ref = H.outcome(jax_utf.UTF, data)
        assert isinstance(got, tuple) and got == ref


# -- AWB -----------------------------------------------------------------------

def _members(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(k), np.uint8).tobytes()
            for k in rng.integers(1, 300, n)]


@pytest.mark.parametrize("kw", [
    {}, dict(subkey=0x55AA), dict(align=0x10, id_intsize=4),
    dict(version=1, id_intsize=8, align=4), dict(align=1)])
def test_build_afs2_equal_and_read_back(kw):
    members = _members()
    blob = port_awb.build_afs2(members, **kw)
    assert blob == jax_awb.build_afs2(members, **kw)
    ref, got = jax_awb.AWB(blob), port_awb.AWB(blob)
    for attr in ("numfiles", "align", "subkey", "version", "ids", "ofs",
                 "headersize", "id_intsize"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    files = list(got.getfiles())
    assert files == list(ref.getfiles())
    assert list(got.getfiles()) == files              # re-iterates
    for i in range(len(members)):
        assert got.getfile_atindex(i) == files[i] == ref.getfile_atindex(i)
        assert files[i][:len(members[i])] == members[i]


def _awb_wide(members):
    """An AFS2 bank with 8-byte offsets and 8-byte ids (the layout
    build_afs2 writes past 4 GiB), built by hand."""
    n = len(members)
    head = port_chunk.AWBChunkHeader.pack(b"AFS2", 2, 8, 8, n, 0x20, 0)
    head += b"".join(struct.pack("<Q", 100 + i) for i in range(n))
    size = len(head) + 8 * (n + 1)
    pos = -(-size // 0x20) * 0x20
    offs, body = [size], b""
    for m in members:
        body += m + bytes(-len(m) % 0x20)
        offs.append(pos + len(body) - (-len(m) % 0x20))
    head += b"".join(struct.pack("<Q", o) for o in offs)
    return head.ljust(pos, b"\0") + body


def test_awb_reader_equal_on_8_byte_offsets_and_ids(tmp_path):
    members = _members(4, seed=1)
    blob = _awb_wide(members)
    ref, got = jax_awb.AWB(blob), port_awb.AWB(blob)
    assert got.ids == ref.ids == [100, 101, 102, 103]
    assert got.ofs == ref.ofs and got.headersize == ref.headersize
    assert list(got.getfiles()) == list(ref.getfiles())
    path = tmp_path / "wide.awb"
    path.write_bytes(blob)
    assert list(port_awb.AWB(str(path)).getfiles()) == \
        list(jax_awb.AWB(str(path)).getfiles())


def test_awb_reader_errors_equal():
    blob = port_awb.build_afs2(_members(2))
    for data in (b"AFS3" + blob[4:], blob[:12] + b"\0\0" + blob[14:],
                 blob[:5] + b"\x03" + blob[6:]):
        got = H.outcome(port_awb.AWB, data)
        assert isinstance(got, tuple) and got == H.outcome(jax_awb.AWB, data)


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _hca_members():
    return [H.load_fixture("q4_stereo_48k_1s"), H.load_fixture("q2_mono_48k_1s")]


@pytest.mark.parametrize("decode", [False, True])
def test_awb_extract_writes_the_same_files(tmp_path, decode):
    blob = port_awb.build_afs2(_hca_members() + [b"other member"])
    path = tmp_path / "bank.awb"
    path.write_bytes(blob)
    for pkg, awb, kw in (("jax", jax_awb, {}),
                         ("port", port_awb, dict(device="cpu"))):
        awb.AWB(blob).extract(decode=decode, dirname=str(tmp_path / pkg),
                              **kw)
        awb.AWB(str(path)).extract(decode=decode,
                                   dirname=str(tmp_path / (pkg + "_named")),
                                   **kw)
    for pkg in ("", "_named"):
        got, ref = _tree(tmp_path / ("port" + pkg)), _tree(tmp_path / ("jax" + pkg))
        assert got == ref and len(got) == 3


# -- ACB -----------------------------------------------------------------------

def _acb_payloads_equal(got, ref):
    assert _norm(got.payload) == _norm(ref.payload)
    assert list(got.awb.getfiles()) == list(ref.awb.getfiles())
    assert got.awb.subkey == ref.awb.subkey


@pytest.mark.parametrize("embed", [True, False])
def test_acb_reader_equal(tmp_path, embed):
    tracks = _hca_members() + [b"\x80\x00 not adx"]
    builder = jax_acb.ACBBuilder(tracks, name="unit", embed_awb=embed,
                                 cue_names=["a", "b/c", "../d"])
    blob = builder.build()
    path = tmp_path / "unit.acb"
    path.write_bytes(blob)
    if not embed:
        (tmp_path / "unit.awb").write_bytes(builder.awb_blob)
    got, ref = port_acb.ACB(str(path)), jax_acb.ACB(str(path))
    _acb_payloads_equal(got, ref)
    assert got.cue_names() == ref.cue_names() == {0: "a", 1: "b/c", 2: "../d"}
    assert [got._encode_type(i) for i in range(4)] == \
        [ref._encode_type(i) for i in range(4)]
    if embed:
        _acb_payloads_equal(port_acb.ACB(blob), jax_acb.ACB(blob))
    else:
        # bytes input: the sibling resolves against the working directory
        assert H.outcome(port_acb.ACB, blob) == H.outcome(jax_acb.ACB, blob)


def test_acb_reader_equal_on_encrypted_nested_tables():
    """A Header table and nested tables all XOR-encrypted (EUTF): the
    reader deciphers the top table; nested EUTF cells stay raw bytes in
    both packages."""
    hca = _hca_members()
    inner = bytes(jax_utf.UTFBuilder(
        [{"MemoryAwbId": (TV.ushort, i), "EncodeType": (TV.uchar, 2)}
         for i in range(2)], table_name="Waveform").parse())
    cue = bytes(jax_utf.UTFBuilder(
        [{"CueId": (TV.uint, 0), "ReferenceType": (TV.uchar, 1),
          "ReferenceIndex": (TV.ushort, 0)}], encrypt=True,
        table_name="Cue").parse())
    header = [{"Name": (TV.string, "enc"),
               "AwbFile": (TV.bytes, jax_awb.build_afs2(hca)),
               "WaveformTable": (TV.bytes, inner),
               "CueTable": (TV.bytes, cue)}]
    blob = bytes(jax_utf.UTFBuilder(header, encrypt=True,
                                    table_name="Header").parse())
    got, ref = port_acb.ACB(blob), jax_acb.ACB(blob)
    _acb_payloads_equal(got, ref)
    assert isinstance(got.payload[0]["WaveformTable"], list)
    assert isinstance(got.payload[0]["CueTable"], tuple)


def test_acb_cue_names_through_synths_and_sequences():
    """ReferenceType 2 (synth items, nested) and 3 (sequence -> track ->
    noteOn command), on hand-made tables; unknown items are skipped."""
    tables = {
        "WaveformTable": [{"MemoryAwbId": (TV.ushort, 10 + i)}
                          for i in range(4)],
        "SynthTable": [
            {"ReferenceItems": (TV.bytes, struct.pack(">HHHH", 1, 0, 2, 1))},
            {"ReferenceItems": (TV.bytes, struct.pack(">HH", 1, 1))},
            {"ReferenceItems": (TV.bytes, struct.pack(">HH", 1, 2))}],
        "SequenceTable": [{"TrackIndex": (TV.bytes, struct.pack(">HH", 0, 1))}],
        "TrackTable": [{"EventIndex": (TV.ushort, 0)},
                       {"EventIndex": (TV.ushort, 1)}],
        "TrackEventTable": [
            {"Command": (TV.bytes, bytes.fromhex("07d00400020002"))},
            {"Command": (TV.bytes, bytes.fromhex("00010007d00400010003"))}],
        "CueTable": [{"ReferenceType": (TV.uchar, 2),
                      "ReferenceIndex": (TV.ushort, 0)},
                     {"ReferenceType": (TV.uchar, 3),
                      "ReferenceIndex": (TV.ushort, 0)},
                     {"ReferenceType": (TV.uchar, 9),
                      "ReferenceIndex": (TV.ushort, 0)}],
        "CueNameTable": [{"CueName": (TV.string, n), "CueIndex": (TV.ushort, i)}
                         for i, n in enumerate(("synth", "seq", "odd"))],
    }
    names = []
    for mod in (jax_acb, port_acb):
        acb = mod.ACB.__new__(mod.ACB)
        acb.payload = [dict(tables)]
        acb.awb = None
        names.append(acb.cue_names())
    assert names[0] == names[1] == {10: "synth", 11: "synth_1", 12: "seq",
                                    13: "seq_1"}


@pytest.mark.parametrize("decode", [False, True])
def test_acb_extract_writes_the_same_files(tmp_path, decode):
    # every member is EncodeType 2 (.hca), which extract(decode=True)
    # decodes: a raw member only without decode
    tracks = _hca_members() + ([] if decode else [b"raw"])
    blob = jax_acb.ACBBuilder(tracks, cue_names=["x", "../y", "z"]).build()
    for pkg, acb, kw in (("jax", jax_acb, {}),
                         ("port", port_acb, dict(device="cpu"))):
        acb.ACB(blob).extract(decode=decode, dirname=str(tmp_path / pkg),
                              **kw)
        acb.ACB(blob).exp_extract(decode=decode,
                                  dirname=str(tmp_path / (pkg + "_names")),
                                  **kw)
    for pkg in ("", "_names"):
        got, ref = _tree(tmp_path / ("port" + pkg)), _tree(tmp_path / ("jax" + pkg))
        assert got == ref and len(got) == len(tracks)


def test_acb_without_awb_or_name_raises_alike():
    blob = bytes(jax_utf.UTFBuilder([{"Other": (TV.uint, 1)}],
                                    table_name="Header").parse())
    got = H.outcome(port_acb.ACB, blob)
    assert got == H.outcome(jax_acb.ACB, blob) and got[0] == "ValueError"


# -- sniff, paths ----------------------------------------------------------------

@pytest.mark.parametrize("data", [
    b"CPK x", b"AFS2....", b"CRID", b"@UTF", b"\x1f\x9e\xf3\xf5", b"HCA\0",
    b"\xc8\xc3\xc1\x80", b"\x80\x00\x00\x20\x03", b"\x80\x00\x00\x20\x11",
    b"\x80\x00", b"RIFF", b"DKIF", b"????", b""])
def test_sniff_equal(data):
    assert H.outcome(port_sniff.sniff, data) == \
        H.outcome(jax_sniff.sniff, data)


@pytest.mark.parametrize("name", ["a/b.hca", "../../x", "C:\\evil\\y",
                                  "a:b/c", "/abs/p", "..", ""])
def test_anchored_join_equal(name):
    assert port_paths.anchored_join("out", name, fallback="f") == \
        jax_paths.anchored_join("out", name, fallback="f")
    assert port_paths.safe_parts(name) == jax_paths.safe_parts(name)


# -- imports -------------------------------------------------------------------

def _port_sources():
    pkg = os.path.join(ROOT, "pycricodecs_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def test_no_port_module_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 30
    rel = {os.path.relpath(p, ROOT).replace(os.sep, "/") for p in sources}
    assert {f"pycricodecs_tpu_torch/containers/{m}.py"
            for m in ("cpk", "ivf", "usm")} <= rel
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "pycricodecs_tpu"), \
                    f"{os.path.relpath(path, ROOT)} imports {name}"
