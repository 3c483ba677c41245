"""PyTorch port, the command line (`python -m pycricodecs_tpu_torch`, here
in-process with --device cpu): decode, encode, extract, bank-decode,
find-key and info write the same files and print the same text as the JAX
package's CLI on the fixtures (encode --format ahx among them), and so do
the container paths: extract of a CPK and a USM, info of a CPK, a USM and
an IVF, build of a CPK (the six cases that refused by name before the port
carried CPK, USM and IVF, under their old ids).
"""
import os

import pytest

from pycricodecs_tpu import __main__ as jax_cli
from pycricodecs_tpu.containers.acb import ACBBuilder
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu_torch import __main__ as port_cli
from tests import torch_port_helpers as H

_, BANK_BLOBS = H.load_bank_fixtures()
KEY = H.KEY


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _run(capsys, cli, argv):
    """(stdout with the output paths' package tag removed, SystemExit code
    or None)."""
    code = None
    try:
        cli.main(argv)
    except SystemExit as exc:
        code = exc.code
    return capsys.readouterr().out, code


def _both(capsys, tmp_path, argv, inputs):
    """Run the JAX and the port CLI on the same argv, each writing under its
    own directory (`{out}` in argv); returns (port, jax) outputs as
    (stdout, exit code, files written)."""
    res = []
    for tag, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                            ("jax", jax_cli, [])):
        out = tmp_path / tag
        out.mkdir()
        args = [a.replace("{out}", str(out)) for a in argv]
        for name, data in inputs.items():
            (out / name).write_bytes(data)
        args = [str(out / a) if a in inputs else a for a in args]
        stdout, code = _run(capsys, cli, args + extra)
        files = {k: v for k, v in _tree(out).items() if k not in inputs}
        res.append((stdout.replace(str(out), "{out}"), code, files))
    return res


CASES = {
    "decode_adx": (["decode", "in.adx", "-o", "{out}/o.wav"],
                   {"in.adx": H.load_adx_fixtures()[1]["adx_m4_stereo_1s"]}),
    "decode_hca_key": (["decode", "in.hca", "--key", hex(KEY),
                        "--subkey", "9"], {}),
    "decode_ahx": (["decode", "in.ahx"],
                   {"in.ahx": H.load_ahx_fixtures()[1][
                       "ahx10_lsf_mono_16k_1s"]}),
    "encode_adx": (["encode", "in.wav", "--format", "adx", "--bitdepth", "8",
                    "--mode", "4", "--scale-fix"], {}),
    "encode_ahx": (["encode", "in.wav", "--format", "ahx"],
                   {"in.wav": H.wav(6000, 1, 22050, seed=7)}),
    "encode_ahx_bitrate": (["encode", "in.wav", "--format", "ahx",
                            "--bitrate", "32", "-o", "{out}/a.ahx"],
                           {"in.wav": H.wav(4000, 1, 16000, seed=8)}),
    "encode_hca_key": (["encode", "in.wav", "--format", "hca", "--quality",
                        "2", "--key", hex(KEY), "--subkey", "3", "-o",
                        "{out}/e.hca"], {}),
    "bank_decode_acb": (["bank-decode", "mixed.acb", "-o", "{out}/wavs"],
                        {"mixed.acb": BANK_BLOBS["mixed"]}),
    "bank_decode_awb": (["bank-decode", "subkey.awb", "--key", hex(KEY)],
                        {"subkey.awb": BANK_BLOBS["subkey"]}),
    "extract_acb": (["extract", "mixed.acb", "-o", "{out}/x"],
                    {"mixed.acb": BANK_BLOBS["mixed"]}),
    "extract_awb_decode": (["extract", "subkey.awb", "--decode", "--key",
                            hex(KEY), "-o", "{out}/x"],
                           {"subkey.awb": BANK_BLOBS["subkey"]}),
    "info_hca": (["info", "in.hca"], {}),
    "info_adx": (["info", "in.adx"],
                 {"in.adx": H.load_adx_fixtures()[1]["adx_loop_stereo_1s"]}),
    "info_ahx": (["info", "in.ahx"],
                 {"in.ahx": H.load_ahx_fixtures()[1][
                     "ahx11_lsf_mono_22k_1s"]}),
    "info_wav": (["info", "in.wav"], {}),
    "info_awb": (["info", "subkey.awb"], {"subkey.awb": BANK_BLOBS["subkey"]}),
    "decode_wav_refused": (["decode", "in.wav"], {}),
    "bank_decode_hca_refused": (["bank-decode", "in.hca"], {}),
}


def _inputs(case):
    argv, inputs = CASES[case]
    inputs = dict(inputs)
    blob = H.load_fixture("q4_stereo_48k_1s")
    if "in.hca" in argv and "in.hca" not in inputs:
        if "--key" in argv:
            hs = H.header_size(blob)
            blob = jax_hca.crypt(blob, True, hs, 56, KEY, 9)
        inputs["in.hca"] = blob
    if "in.wav" in argv and "in.wav" not in inputs:
        inputs["in.wav"] = H.wav(3000, 2, seed=5, loop=(300, 2500))
    return argv, inputs


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_command_equals_jax(capsys, tmp_path, case):
    argv, inputs = _inputs(case)
    port, ref = _both(capsys, tmp_path, argv, inputs)
    assert port == ref
    stdout, code, files = port
    if case.endswith("refused"):
        assert code is not None and code != 0 and not files
    elif case.startswith("info"):
        assert stdout.startswith("{")
    else:
        assert files and code is None


def test_extract_acb_decode_and_bank_decode_through_a_sibling_awb(
        capsys, tmp_path, monkeypatch):
    """An ACB whose AWB sits beside it: the port opens the ACB by path, so
    the sibling resolves from any working directory; the JAX CLI, run from
    the ACB's directory, writes the same files."""
    tracks = [H.load_fixture("q2_mono_48k_1s"), H.load_fixture(
        "q4_stereo_48k_1s")]
    builder = ACBBuilder(tracks, name="side", embed_awb=False)
    acb = builder.build()
    res = []
    for tag, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                            ("jax", jax_cli, [])):
        d = tmp_path / tag
        d.mkdir()
        (d / "side.acb").write_bytes(acb)
        (d / "side.awb").write_bytes(builder.awb_blob)
        if tag == "jax":
            monkeypatch.chdir(d)
        for argv in (["bank-decode", str(d / "side.acb"), "-o",
                      str(d / "wavs")],
                     ["extract", str(d / "side.acb"), "--decode", "-o",
                      str(d / "x")]):
            stdout, code = _run(capsys, cli, argv + extra)
            assert code is None, stdout
        res.append((_tree(d / "wavs"), _tree(d / "x")))
    assert res[0] == res[1]
    assert len(res[0][0]) == 2 and len(res[0][1]) == 2


def test_find_key_equals_jax(capsys, tmp_path):
    blob = H.load_fixture("q2_mono_48k_1s")
    enc = jax_hca.crypt(blob, True, H.header_size(blob), 56, KEY, 0)
    cands = tmp_path / "cands.txt"
    cands.write_text("# candidates\n0x1\n" + hex(KEY) + "\n" + hex(KEY + 1)
                     + "\n")
    for i, argv in enumerate((
            ["find-key", "enc.hca", "--range", hex(KEY - 20), "40",
             "--max-frames", "4", "--top", "3"],
            ["find-key", "enc.hca", "--candidates", str(cands)],
            ["find-key", "enc.hca", "--range", "0x10", "8",
             "--max-frames", "2"],
            ["find-key", "enc.hca"])):
        run_dir = tmp_path / f"run{i}"
        run_dir.mkdir()
        port, ref = _both(capsys, run_dir, argv, {"enc.hca": enc})
        assert port == ref


def test_find_key_ranks_the_true_key_first(capsys, tmp_path):
    blob = H.load_fixture("q2_mono_48k_1s")
    enc = jax_hca.crypt(blob, True, H.header_size(blob), 56, KEY, 0)
    (tmp_path / "enc.hca").write_bytes(enc)
    stdout, code = _run(capsys, port_cli, [
        "find-key", str(tmp_path / "enc.hca"), "--range", hex(KEY - 5),
        "10", "--max-frames", "4", "--device", "cpu"])
    assert code is None and stdout.startswith(f"0x{KEY:016X}")


USM_KEY = 0x0019C0FFEE5EED19


def _container_inputs():
    """A compressed CPK, a USM with an enciphered HCA track and subtitles,
    and an IVF, all from the JAX package's builders."""
    import tempfile

    from pycricodecs_tpu.containers.cpk import CPKBuilder
    from pycricodecs_tpu.containers.ivf import build_ivf
    from pycricodecs_tpu.containers.usm import USMBuilder

    ivf = build_ivf([b"\x82I\x83B" + bytes(range(256)) * 3, b"w" * 900,
                     b"v" * 333], fps_num=2997, fps_den=100)
    usm = USMBuilder(ivf, [H.wav(4000, 2, seed=6)], key=USM_KEY,
                     audio_codec="hca", encryptAudio=True,
                     subtitles=[(0, 900, "line")]).build()
    with tempfile.TemporaryDirectory() as tmp:
        _cpk_source(os.path.join(tmp, "src"))
        CPKBuilder(os.path.join(tmp, "src"), os.path.join(tmp, "a.cpk"),
                   compress=True)
        with open(os.path.join(tmp, "a.cpk"), "rb") as fh:
            cpk = fh.read()
    return {"in.cpk": cpk, "in.usm": usm, "in.ivf": ivf}


def _cpk_source(root):
    os.makedirs(os.path.join(root, "sub"))
    for name, data in (("a.txt", b"container path " * 40),
                       ("sub/b.bin", bytes(range(256)) * 3),
                       ("tiny", b"short")):
        with open(os.path.join(root, name), "wb") as fh:
            fh.write(data)


# each case's id fixed (argv1-argv6), whatever its place in the list: these
# six refused by name until the port carried CPK, USM and IVF
@pytest.mark.parametrize("argv,what", [
    pytest.param(argv, what, id=f"argv{i}-{what}") for i, (argv, what) in
    enumerate([
        (["extract", "in.cpk"], "extract of CPK"),
        (["extract", "in.usm"], "extract of USM"),
        (["info", "in.cpk"], "info of CPK"),
        (["info", "in.usm"], "info of USM"),
        (["info", "in.ivf"], "info of IVF"),
        (["build", "somedir", "-o", "out.cpk"], "build"),
    ], start=1)])
def test_what_is_not_ported_refuses_by_name(capsys, tmp_path, argv, what):
    """The CLI's container paths write and print what the JAX CLI does."""
    if argv[0] == "build":
        res = []
        for tag, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                                ("jax", jax_cli, [])):
            root = tmp_path / tag
            _cpk_source(str(root / "somedir"))
            stdout, code = _run(capsys, cli, [
                "build", str(root / "somedir"), "-o", str(root / "out.cpk"),
                "--compress", "--encrypt", "--cpk-mode", "2"] + extra)
            res.append((stdout.replace(str(root), "{out}"), code,
                        (root / "out.cpk").read_bytes()))
        assert res[0] == res[1] and res[0][1] is None
        return
    inputs = _container_inputs()
    if argv[0] == "extract":
        argv = argv + ["-o", "{out}/x"]
        if "in.usm" in argv:
            argv += ["--decode", "--key", hex(USM_KEY)]
    port, ref = _both(capsys, tmp_path, argv,
                      {n: inputs[n] for n in argv if n in inputs})
    assert port == ref
    stdout, code, files = port
    assert code is None
    if argv[0] == "extract":
        assert files and (what != "extract of USM"
                          or any(n.endswith(".wav") for n in files))
    else:
        assert stdout.startswith(("{", "["))
