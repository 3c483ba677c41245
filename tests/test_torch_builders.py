"""PyTorch port, the container builders it copies: `UTFBuilder`,
`AWBBuilder` and `ACBBuilder` write the JAX package's bytes (every column
type, plain and XOR-encrypted tables, the builders' errors, AWB list and
directory modes, ACBs with embedded and sibling banks), the port's readers
read the port's builds, and the CLI's `build` of an .awb, .acb, .cpk or
.usm writes the JAX CLI's file.
"""
import os
import struct

import pytest

from pycricodecs_tpu import __main__ as jax_cli
from pycricodecs_tpu.containers import acb as jax_acb
from pycricodecs_tpu.containers import awb as jax_awb
from pycricodecs_tpu.containers import utf as jax_utf
from pycricodecs_tpu_torch import __main__ as port_cli
from pycricodecs_tpu_torch.containers import acb as port_acb
from pycricodecs_tpu_torch.containers import awb as port_awb
from pycricodecs_tpu_torch.containers import chunk as port_chunk
from pycricodecs_tpu_torch.containers import utf as port_utf
from tests import torch_port_helpers as H
from tests.test_torch_containers import _every_type_payload, _members, _norm


def _port_payload(payload):
    """The payload with the JAX package's UTFTypeValues members swapped for
    the port's (the builders look the type up in their own enum)."""
    return [{k: (port_chunk.UTFTypeValues[t.name], v)
             for k, (t, v) in row.items()} for row in payload]


def _both_utf(payload, **kw):
    """(JAX outcome, port outcome) of building the payload: the bytes, or
    (exception type name, message)."""
    ref = H.outcome(lambda: bytes(jax_utf.UTFBuilder(payload, **kw).parse()))
    got = H.outcome(lambda: bytes(
        port_utf.UTFBuilder(_port_payload(payload), **kw).parse()))
    return ref, got


# -- UTFBuilder ----------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("encrypt", [False, True])
def test_utf_builder_equal_on_every_type(rows, encrypt):
    ref, got = _both_utf(_every_type_payload(rows), encrypt=encrypt,
                         table_name="Every")
    assert isinstance(got, bytes) and got == ref
    assert _norm(port_utf.UTF(got).get_payload()) == \
        _norm(jax_utf.UTF(ref).get_payload())


@pytest.mark.parametrize("encoding", ["utf-8", "shift-jis"])
def test_utf_builder_equal_with_encoding_and_default_name(encoding):
    payload = [{"Name": (port_chunk.UTFTypeValues.string, "キュー"),
                "Id": (port_chunk.UTFTypeValues.uint, i)} for i in range(3)]
    from pycricodecs_tpu.containers.chunk import UTFTypeValues as TV
    jax_payload = [{"Name": (TV.string, "キュー"), "Id": (TV.uint, i)}
                   for i in range(3)]
    ref = bytes(jax_utf.UTFBuilder(jax_payload, encoding=encoding).parse())
    got = bytes(port_utf.UTFBuilder(payload, encoding=encoding).parse())
    assert got == ref
    assert port_utf.UTF(got).table_name == "PyCriCodecs_table"


def test_utf_builder_varying_empty_and_null_strings_equal():
    from pycricodecs_tpu.containers.chunk import UTFTypeValues as TV
    payload = [{"S": (TV.string, s), "B": (TV.bytes, b)}
               for s, b in (("", b"x"), ("<NULL>", b""), ("a", b"x"))]
    ref, got = _both_utf(payload)
    assert isinstance(got, bytes) and got == ref


def test_utf_builder_errors_equal():
    from pycricodecs_tpu.containers.chunk import UTFTypeValues as TV
    cases = [
        # rows of different lengths
        [{"A": (TV.uint, 1)}, {"A": (TV.uint, 1), "B": (TV.uint, 2)}],
        # the same keys with another type
        [{"A": (TV.uint, 1)}, {"A": (TV.ushort, 1)}],
        # the same types under other keys
        [{"A": (TV.uint, 1)}, {"B": (TV.uint, 1)}],
        # a string that encodes with a null byte
        [{"A": (TV.string, "a\x00b")}],
    ]
    for payload in cases:
        ref, got = _both_utf(payload)
        assert isinstance(got, tuple) and got == ref, payload
    ref, got = _both_utf([{"A": (TV.string, "x")}], table_name="bad\x00name")
    assert isinstance(got, tuple) and got == ref


# -- AWBBuilder ----------------------------------------------------------------

def _write_members(d, members):
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, m in enumerate(members):
        p = os.path.join(d, f"m{i}.bin")
        with open(p, "wb") as fh:
            fh.write(m)
        paths.append(p)
    return paths


def _build_awb(mod, src, out, **kw):
    try:
        mod.AWBBuilder(src, **kw).build(str(out))
    except Exception as exc:     # compared, not swallowed
        return type(exc).__name__, str(exc)
    return out.read_bytes()


@pytest.mark.parametrize("id_intsize", [2, 4, 8])
@pytest.mark.parametrize("align", [0x20, 0x10, 4])
def test_awb_builder_list_mode_equal(tmp_path, id_intsize, align):
    paths = _write_members(tmp_path / "in", _members(6, seed=id_intsize))
    kw = dict(subkey=0x1234, id_intsize=id_intsize, align=align)
    ref = _build_awb(jax_awb, paths, tmp_path / "ref.awb", **kw)
    got = _build_awb(port_awb, paths, tmp_path / "got.awb", **kw)
    assert isinstance(got, bytes) and got == ref
    assert port_awb.AWB(got).id_intsize == id_intsize


@pytest.mark.parametrize("version", [1, 2])
def test_awb_builder_directory_mode_equal(tmp_path, version):
    """Nested directories: each size aligned up front, the last file of
    each directory unpadded, files in os.walk order (the same directory in
    one process, so both walks see one order)."""
    src = tmp_path / "tree"
    _write_members(src, _members(3, seed=1))
    _write_members(src / "sub", _members(4, seed=2))
    _write_members(src / "sub" / "deeper", _members(2, seed=3))
    ref = _build_awb(jax_awb, str(src), tmp_path / "ref.awb",
                     version=version, align=0x40)
    got = _build_awb(port_awb, str(src), tmp_path / "got.awb",
                     version=version, align=0x40)
    assert isinstance(got, bytes) and got == ref
    assert port_awb.AWB(got).numfiles == 9


def test_awb_builder_errors_equal(tmp_path):
    paths = _write_members(tmp_path / "in", _members(2))
    cases = [(paths, dict(version=1, subkey=5)),
             (paths, dict(id_intsize=3)), ("", {})]
    for src, kw in cases:
        ref = _build_awb(jax_awb, src, tmp_path / "r.awb", **kw)
        got = _build_awb(port_awb, src, tmp_path / "g.awb", **kw)
        assert isinstance(got, tuple) and got == ref, kw
    for mod in (jax_awb, port_awb):
        with pytest.raises(ValueError, match="Invalid output file name"):
            mod.AWBBuilder(paths).build("")


def test_awb_builder_over_the_hca_fixtures_reads_back(tmp_path):
    """List mode over the committed HCA fixtures (the bank chip_smoke.py
    rebuilds): the port's reader gives the members back."""
    names = sorted(f for f in os.listdir(H.FIXTURE_DIR) if f.endswith(".hca"))
    paths = [os.path.join(H.FIXTURE_DIR, f) for f in names]
    ref = _build_awb(jax_awb, paths, tmp_path / "ref.awb")
    got = _build_awb(port_awb, paths, tmp_path / "got.awb")
    assert isinstance(got, bytes) and got == ref
    members = list(port_awb.AWB(got).getfiles())
    for m, p in zip(members, paths):
        with open(p, "rb") as fh:
            data = fh.read()
        assert bytes(m)[:len(data)] == data


# -- ACBBuilder ----------------------------------------------------------------

@pytest.mark.parametrize("embed_awb", [True, False])
@pytest.mark.parametrize("cue_names", [None, ["intro", "loop", "outro"]])
def test_acb_builder_equal_and_read_back(tmp_path, embed_awb, cue_names):
    tracks = [H.load_fixture(n) for n in ("q4_stereo_48k_1s",
                                          "q2_mono_48k_1s",
                                          "pns_v3_mono_48k_1s")]
    kw = dict(name="built", cue_names=cue_names, embed_awb=embed_awb)
    jb = jax_acb.ACBBuilder(tracks, **kw)
    pb = port_acb.ACBBuilder(tracks, **kw)
    ref, got = jb.build(), pb.build()
    assert got == ref and pb.awb_blob == jb.awb_blob
    path = tmp_path / "built.acb"
    path.write_bytes(got)
    if not embed_awb:
        (tmp_path / "built.awb").write_bytes(pb.awb_blob)
    acb = port_acb.ACB(str(path))
    assert [bytes(m) for m in acb.awb.getfiles()] == tracks
    names = acb.cue_names()
    assert sorted(names.values()) == sorted(
        cue_names or [f"cue_{i:04d}" for i in range(3)])


def afs2_members(awb: bytes) -> list:
    """The members of an AFS2 bank exactly as built: from each member's
    aligned start to the next raw offset (AWB.getfiles reads up to the
    next aligned start, trailing padding included)."""
    (_, _, osize, isize, n, align, _) = struct.unpack_from("<4sBBHIHH", awb)
    code = {2: "H", 4: "I", 8: "Q"}[osize]
    raw = struct.unpack_from("<" + code * (n + 1), awb, 16 + isize * n)
    return [awb[-(-raw[i] // align) * align:raw[i + 1]] for i in range(n)]


def test_acb_builder_rebuilds_the_mixed_fixture():
    expected, blobs = H.load_bank_fixtures()
    awb = port_acb.ACB(blobs["mixed"]).awb.stream.getvalue()
    members = afs2_members(awb)
    assert len(members) == len(expected["mixed"]["members"])
    assert port_acb.ACBBuilder(members, name="mixed").build() == \
        blobs["mixed"]


# -- the CLI's build -----------------------------------------------------------

def _tracks_dir(d):
    os.makedirs(d, exist_ok=True)
    for name in ("q4_stereo_48k_1s", "q2_mono_48k_1s"):
        (d / f"{name}.hca").write_bytes(H.load_fixture(name))
    (d / "notes.txt").write_bytes(b"not audio\n")
    os.makedirs(d / "skipped_dir", exist_ok=True)


@pytest.mark.parametrize("ext,extra", [("awb", []), ("awb", ["--subkey",
                                                             "0x55AA"]),
                                       ("acb", [])])
def test_cli_build_writes_the_jax_clis_file(tmp_path, capsys, ext, extra):
    src = tmp_path / "tracks"
    _tracks_dir(src)
    # one file name in two directories: an ACB's Name is its file's stem
    os.makedirs(tmp_path / "ref")
    os.makedirs(tmp_path / "got")
    ref = tmp_path / "ref" / f"bank.{ext}"
    got = tmp_path / "got" / f"bank.{ext}"
    jax_cli.main(["build", str(src), "-o", str(ref), *extra])
    port_cli.main(["build", str(src), "-o", str(got), *extra])
    assert got.read_bytes() == ref.read_bytes()
    assert capsys.readouterr().out.splitlines()[-1] == str(got)


@pytest.mark.parametrize("ext", ["cpk", "usm"])
def test_cli_build_of_cpk_or_usm_refuses_by_name(tmp_path, capsys, ext):
    """Refused by name until the port carried CPK and USM (the old id):
    the CLI's build of a compressed, encrypted mode 3 CPK, and of a USM
    with an enciphered HCA track, writes the JAX CLI's file."""
    from pycricodecs_tpu.containers.ivf import build_ivf

    if ext == "cpk":
        # small members: the plain CRILAYLA matcher runs here
        src = tmp_path / "members"
        os.makedirs(src / "sub")
        (src / "notes.txt").write_bytes(b"not audio\n" * 60)
        (src / "sub" / "cues.bin").write_bytes(bytes(range(256)) * 2)
        extra = ["--cpk-mode", "3", "--compress", "--encrypt"]
    else:
        (tmp_path / "v.ivf").write_bytes(build_ivf(
            [b"\x82I\x83B" + b"v" * 700, b"w" * 400], fps_num=30))
        (tmp_path / "a.wav").write_bytes(H.wav(4000, 2, seed=8))
        src = tmp_path / "v.ivf"
        extra = ["--audio", str(tmp_path / "a.wav"), "--codec", "hca",
                 "--key", "0x1234ABCD5678", "--encrypt"]
    got, ref = tmp_path / f"got.{ext}", tmp_path / f"ref.{ext}"
    jax_cli.main(["build", str(src), "-o", str(ref), *extra])
    port_cli.main(["build", str(src), "-o", str(got), *extra,
                   "--device", "cpu"])
    assert got.read_bytes() == ref.read_bytes()
    assert capsys.readouterr().out.splitlines()[-1] == str(got)


def test_cli_build_errors(tmp_path):
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no files in"):
        port_cli.main(["build", str(empty), "-o", str(tmp_path / "x.acb")])
    with pytest.raises(SystemExit, match="must end in"):
        port_cli.main(["build", str(empty), "-o", str(tmp_path / "x.zip")])
