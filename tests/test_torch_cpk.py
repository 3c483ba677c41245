"""PyTorch port, the CPK archive (pycricodecs_tpu_torch/containers/cpk.py)
against the JAX package's: CPKBuilder's bytes for modes 0-3 x encrypt x
compress, the constant-storage columns and the shared-string TOC estimate,
extract / extract_file trees in TOC and ITOC modes, the hostile and
duplicate member names, errors at the same member after the same files,
and the mutated archives of the JAX fuzz test (the same exception types).
CRILAYLA runs its plain versions here (device="cpu"); the kernels' check
on the card is chip_smoke.py's phase 19."""
import os

import numpy as np
import pytest

from pycricodecs_tpu.containers import cpk as jax_cpk
from pycricodecs_tpu_torch.containers import cpk as port_cpk
from pycricodecs_tpu_torch.models import crilayla
from tests.test_fuzz import N_MUTATIONS, _mutate


def _tree(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _sample_dir(root):
    """Named members (one compressible, one too small to compress, one
    random) and a nested directory: the JAX tests' sample_dir, smaller."""
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "nested"))
    for i in range(4):
        with open(os.path.join(root, f"file_{i:02d}.bin"), "wb") as f:
            f.write((b"payload %d " % i) * (25 * (i + 1)))
    with open(os.path.join(root, "tiny.txt"), "wb") as f:
        f.write(b"under 0x100 bytes")
    with open(os.path.join(root, "nested", "deep.dat"), "wb") as f:
        f.write(bytes(rng.integers(0, 255, 777).astype(np.uint8)))
    return str(root)


def _id_dir(root):
    rng = np.random.default_rng(5)
    os.makedirs(root)
    for i in range(4):
        size = 100 + i * 30000          # DataL (< 64 KB) and DataH rows
        with open(os.path.join(root, str(i)), "wb") as f:
            f.write(bytes(rng.integers(0, 255, size).astype(np.uint8)))
    return str(root)


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return None
    except Exception as exc:  # the type is what the two must share
        return type(exc).__name__


def _both_build(tmp_path, src, **kw):
    """(port bytes or error, JAX bytes or error) of CPKBuilder(src)."""
    got = tmp_path / "port.cpk"
    want = tmp_path / "jax.cpk"
    e_port = _outcome(port_cpk.CPKBuilder, src, str(got), device="cpu", **kw)
    e_jax = _outcome(jax_cpk.CPKBuilder, src, str(want), **kw)
    assert e_port == e_jax
    if e_jax:
        return e_jax, e_jax
    return got.read_bytes(), want.read_bytes()


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("encrypt", [False, True])
@pytest.mark.parametrize("compress", [False, True])
def test_builder_bytes_equal(tmp_path, mode, encrypt, compress):
    src = _id_dir(tmp_path / "ids") if mode == 0 else \
        _sample_dir(tmp_path / "named")
    got, want = _both_build(tmp_path, src, CpkMode=mode, encrypt=encrypt,
                            compress=compress)
    assert got == want
    if mode == 0 and compress:
        assert want == "NotImplementedError"


@pytest.mark.parametrize("kw", [dict(CpkMode=7), dict(CpkMode=1, dirname=""),
                                dict(CpkMode=0, named=True),
                                dict(CpkMode=1, Tver="CPKMC9.99.99")])
def test_builder_errors_and_options_equal(tmp_path, kw):
    kw = dict(kw)
    src = kw.pop("dirname", None)
    if src is None:
        src = _sample_dir(tmp_path / "named") if kw.pop("named", True) \
            else _id_dir(tmp_path / "ids")
    got, want = _both_build(tmp_path, src, **kw)
    assert got == want


def test_toc_estimate_shared_string_dedup(tmp_path):
    root = tmp_path / "r"
    (root / "foo").mkdir(parents=True)
    (root / "foo" / "foo").write_bytes(b"\x03" * 500)    # dir and file
    (root / "foo" / "ID").write_bytes(b"\x04" * 200)     # a column key
    got, want = _both_build(tmp_path, str(root), CpkMode=1)
    assert got == want and isinstance(got, bytes)
    cpk = port_cpk.CPK(str(tmp_path / "port.cpk"), device="cpu")
    cpk.extract_file("foo", dirname=str(tmp_path / "y"))
    assert (tmp_path / "y" / "foo" / "foo").read_bytes() == b"\x03" * 500


def test_constant_storage_header_columns(tmp_path):
    root = tmp_path / "c"
    root.mkdir()
    (root / "one.bin").write_bytes(b"\x05" * 128)
    out = tmp_path / "c.cpk"
    jax_cpk.CPKBuilder(str(root), str(out), CpkMode=1)
    trees = []
    for mod, kw in ((port_cpk, {"device": "cpu"}), (jax_cpk, {})):
        cpk = mod.CPK(str(out), **kw)
        for key in ("TocOffset", "TocSize", "ContentOffset", "Align"):
            cell = cpk.tables["CPK"].get(key)
            if cell and not isinstance(cell[0], tuple):
                cpk.tables["CPK"][key] = [(cell[0],)]
        cpk.tables.pop("TOC", None)
        cpk.checkTocs()
        assert "TOC" in cpk.tables
        dst = tmp_path / mod.__name__.split(".")[0]
        cpk.extract_file("one.bin", dirname=str(dst))
        trees.append(_tree(dst))
    assert trees[0] == trees[1] == {"one.bin": b"\x05" * 128}


@pytest.mark.parametrize("mode,encrypt,compress", [
    (1, False, False), (1, True, True), (1, False, True), (2, False, False),
    (2, True, True), (3, False, False), (3, False, True), (0, False, False),
    (0, True, False)])
def test_extract_trees_equal(tmp_path, mode, encrypt, compress):
    """extract of every mode writes the JAX package's tree (modes 2 and 3
    included: their TOC offsets leave out the ITOC / GTOC, and the two
    packages read the same other bytes, or raise alike)."""
    src = _id_dir(tmp_path / "ids") if mode == 0 else \
        _sample_dir(tmp_path / "named")
    path = tmp_path / "a.cpk"
    jax_cpk.CPKBuilder(src, str(path), CpkMode=mode, encrypt=encrypt,
                       compress=compress)
    e_port = _outcome(port_cpk.CPK(str(path), device="cpu").extract,
                      str(tmp_path / "port"))
    e_jax = _outcome(jax_cpk.CPK(str(path)).extract, str(tmp_path / "jax"))
    assert e_port == e_jax
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    if mode in (0, 1):
        assert e_jax is None
        assert _tree(tmp_path / "port") == _tree(src)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", ["file_03.bin", "deep.dat", "tiny.txt",
                                  "absent.bin"])
def test_extract_file_equal(tmp_path, compress, name):
    src = _sample_dir(tmp_path / "named")
    path = tmp_path / "a.cpk"
    jax_cpk.CPKBuilder(src, str(path), CpkMode=1, compress=compress)
    e_port = _outcome(port_cpk.CPK(str(path), device="cpu").extract_file,
                      name, str(tmp_path / "port"))
    e_jax = _outcome(jax_cpk.CPK(str(path)).extract_file, name,
                     str(tmp_path / "jax"))
    assert e_port == e_jax
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


@pytest.mark.parametrize("file_id", [2, 3, 9])
def test_itoc_extract_file_equal(tmp_path, file_id):
    src = _id_dir(tmp_path / "ids")
    path = tmp_path / "ids.cpk"
    jax_cpk.CPKBuilder(src, str(path), CpkMode=0)
    e_port = _outcome(port_cpk.CPK(str(path), device="cpu").extract_file,
                      file_id, str(tmp_path / "port"))
    e_jax = _outcome(jax_cpk.CPK(str(path)).extract_file, file_id,
                     str(tmp_path / "jax"))
    assert e_port == e_jax
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_bytes_input_and_default_output_dir(tmp_path, monkeypatch):
    src = _sample_dir(tmp_path / "named")
    path = tmp_path / "archive.v2.cpk"
    jax_cpk.CPKBuilder(src, str(path), CpkMode=1)
    monkeypatch.chdir(tmp_path)
    port_cpk.CPK(path.read_bytes(), device="cpu").extract()   # "cpk_out"
    port_cpk.CPK(str(path), device="cpu").extract()           # "archive.v2"
    assert _tree(tmp_path / "cpk_out") == _tree(src)
    assert _tree(tmp_path / "archive.v2") == _tree(src)


# -- hostile and duplicate names (tests/test_traversal.py, test_containers) ----

def _one_member_archive(tmp_path, name="a.bin", data=b"payload-a" * 10):
    src = tmp_path / "src"
    src.mkdir()
    (src / name).write_bytes(data)
    path = tmp_path / "t.cpk"
    jax_cpk.CPKBuilder(str(src), str(path), CpkMode=1)
    return path


@pytest.mark.parametrize("names,dirs", [
    (["../../evil.bin"], [("/",)]),
    ([".."], [("",)]),
    (["dup.bin", "dup.bin"], [("",)]),
    (["track", "track"], [("sound",)]),
    (["x" * 300], [("",)]),
    (["C:\\win\\abs.bin"], [("a/../../b",)]),
])
def test_hostile_and_duplicate_names_equal(tmp_path, names, dirs):
    path = _one_member_archive(tmp_path)
    trees = []
    for mod, kw in ((port_cpk, {"device": "cpu"}), (jax_cpk, {})):
        cpk = mod.CPK(str(path), **kw)
        cpk.tables["TOC"]["FileName"] = list(names)
        cpk.tables["TOC"]["DirName"] = list(dirs)
        out = tmp_path / ("out_" + mod.__name__.split(".")[0])
        cpk.extract(dirname=str(out))
        trees.append(_tree(tmp_path / out))
        if names[0] == "../../evil.bin":
            out2 = tmp_path / ("one_" + mod.__name__.split(".")[0])
            cpk.extract_file("../../evil.bin", dirname=str(out2))
            assert (out2 / "evil.bin").exists()
    assert trees[0] == trees[1]
    assert not (tmp_path / "evil.bin").exists()


# -- errors at the same member, after the same files ---------------------------

def _member_offset(path, name):
    cpk = jax_cpk.CPK(str(path))
    toc = cpk.tables["TOC"]
    i = toc["FileName"].index(name)
    return 0x800 + cpk._cell(toc["FileOffset"], i), cpk._cell(
        toc["FileSize"], i)


@pytest.mark.parametrize("damage", ["malformed", "magic", "truncated"])
def test_a_bad_compressed_member_raises_where_the_jax_package_does(
        tmp_path, damage):
    src = _sample_dir(tmp_path / "named")
    path = tmp_path / "a.cpk"
    jax_cpk.CPKBuilder(src, str(path), CpkMode=1, compress=True)
    blob = bytearray(path.read_bytes())
    off, size = _member_offset(path, "file_02.bin")
    if damage == "malformed":        # every stream bit set
        blob[off + 16:off + size - 256] = b"\xff" * (size - 272)
    elif damage == "magic":
        blob[off:off + 8] = b"NOTLAYLA"
    else:                            # compressed size past the member
        blob[off + 12:off + 16] = (size * 4).to_bytes(4, "little")
    path.write_bytes(bytes(blob))
    e_port = _outcome(port_cpk.CPK(str(path), device="cpu").extract,
                      str(tmp_path / "port"))
    e_jax = _outcome(jax_cpk.CPK(str(path)).extract, str(tmp_path / "jax"))
    assert e_jax == e_port == "ValueError"
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want and 0 < len(got) < len(_tree(src))


@pytest.mark.parametrize("budget", [None, 1, 900])
@pytest.mark.parametrize("damage", [None, "malformed", "magic"])
def test_extract_launches_c1_per_budget_and_raises_alike(
        tmp_path, monkeypatch, budget, damage):
    """CPK.extract holds the compressed members for one launch of C1 up to
    C1_BUDGET bytes (one launch for the whole archive by default, one per
    member at a budget of 1) and reads each raw member when it writes it;
    its tree and its error stay the JAX package's at every budget."""
    src = _sample_dir(tmp_path / "named")
    path = tmp_path / "a.cpk"
    jax_cpk.CPKBuilder(src, str(path), CpkMode=1, compress=True)
    if damage:
        blob = bytearray(path.read_bytes())
        off, size = _member_offset(path, "file_02.bin")
        if damage == "malformed":
            blob[off + 16:off + size - 256] = b"\xff" * (size - 272)
        else:
            blob[off:off + 8] = b"NOTLAYLA"
        path.write_bytes(bytes(blob))
    if budget is not None:
        monkeypatch.setattr(port_cpk, "C1_BUDGET", budget)
    launches = []
    members = crilayla.decompress_members

    def counted(parsed, *, device="cuda"):
        if parsed:                   # an empty call launches nothing
            launches.append(len(parsed))
        return members(parsed, device=device)

    monkeypatch.setattr(crilayla, "decompress_members", counted)
    e_port = _outcome(port_cpk.CPK(str(path), device="cpu").extract,
                      str(tmp_path / "port"))
    e_jax = _outcome(jax_cpk.CPK(str(path)).extract, str(tmp_path / "jax"))
    assert e_port == e_jax == (damage and "ValueError")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    toc = jax_cpk.CPK(str(path)).tables["TOC"]
    packed = sum(jax_cpk.CPK._cell(toc["ExtractSize"], i)
                 > jax_cpk.CPK._cell(toc["FileSize"], i)
                 for i in range(len(toc["FileName"])))
    assert packed >= 3
    if damage is None:
        assert sum(launches) == packed
        assert launches == {None: [packed], 1: [1] * packed}.get(
            budget, launches)
        assert budget != 900 or 1 < len(launches) < packed


# -- the JAX fuzz test's mutations (tests/test_fuzz.py::test_fuzz_cpk) --------

@pytest.mark.parametrize("compress", [False, True])
def test_mutated_archives_raise_alike(tmp_path, compress):
    rng = np.random.default_rng(5)
    d = tmp_path / "in"
    d.mkdir()
    (d / "x.bin").write_bytes(b"cpk fuzz corpus " * 64)
    jax_cpk.CPKBuilder(str(d), str(tmp_path / "a.cpk"), CpkMode=1,
                       compress=compress)
    blob = (tmp_path / "a.cpk").read_bytes()
    for k in range(N_MUTATIONS):
        mutated = _mutate(rng, blob)
        outcomes = []
        for mod, kw in ((port_cpk, {"device": "cpu"}), (jax_cpk, {})):
            out = tmp_path / f"{k}_{mod.__name__.split('.')[0]}"
            try:
                cpk = mod.CPK(mutated, **kw)
            except Exception as exc:  # the type is what the two must share
                outcomes.append(("init", type(exc).__name__))
                continue
            outcomes.append(("extract", _outcome(cpk.extract, str(out)),
                             _tree(out)))
        assert outcomes[0] == outcomes[1], k


def test_a_launch_failure_under_compress_is_not_stored_raw(tmp_path,
                                                           monkeypatch):
    """Only the kernel's own refusal (None) stores a member raw; a failed
    build or launch raises out of CPKBuilder."""
    src = _sample_dir(tmp_path / "named")

    def broken(datas, *, device="cuda"):
        raise RuntimeError("crilayla_compress: CUDA launch failed with "
                           "error 1")

    monkeypatch.setattr(crilayla, "compress_members", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        port_cpk.CPKBuilder(src, str(tmp_path / "x.cpk"), compress=True,
                            device="cpu")
