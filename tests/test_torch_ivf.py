"""PyTorch port, the IVF container (pycricodecs_tpu_torch/containers/ivf.py)
against the JAX package's: header, frames and the keyframe quirk from a
path, bytes and an open stream; build_ivf's bytes; the same exception type
on malformed and mutated inputs."""
import io
import struct

import numpy as np
import pytest

from pycricodecs_tpu.containers import ivf as jax_ivf
from pycricodecs_tpu_torch.containers import ivf as port_ivf
from tests.test_fuzz import _mutate


def _frames(n=12, seed=11):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        body = bytes(rng.integers(0, 255, 400 + 37 * i).astype(np.uint8))
        if i % 6 == 0:
            body = b"\x82I\x83B" + body      # the magic, at the payload head
        frames.append(body)
    return frames


def _read_all(mod, src):
    ivf = mod.IVF(src)
    return ivf.info(), list(ivf.get_frames())


@pytest.mark.parametrize("kw", [{}, {"width": 1920, "height": 1080},
                                {"fps_num": 2997, "fps_den": 100}])
def test_build_ivf_bytes_equal(kw):
    frames = _frames()
    assert port_ivf.build_ivf(frames, **kw) == jax_ivf.build_ivf(frames, **kw)


@pytest.mark.parametrize("source", ["bytes", "bytearray", "path", "stream"])
def test_info_and_frames_equal(tmp_path, source):
    blob = jax_ivf.build_ivf(_frames(), fps_num=2997, fps_den=100)
    path = tmp_path / "v.ivf"
    path.write_bytes(blob)

    def src():
        return {"bytes": blob, "bytearray": bytearray(blob),
                "path": str(path), "stream": io.BytesIO(blob)}[source]

    got, want = _read_all(port_ivf, src()), _read_all(jax_ivf, src())
    assert got == want
    info, frames = got
    assert info["FrameCount"] == 12 and len(frames) == 12
    # the keyframe quirk: the magic is matched against data that starts
    # with the 12-byte frame header, so it never fires (minchk = 0)
    assert all(f[4] is False for f in frames)
    assert port_ivf.KEYFRAME_FLAG == jax_ivf.KEYFRAME_FLAG


def test_loadfile_rereads_the_header():
    blob = jax_ivf.build_ivf(_frames(3))
    ivfs = [mod.IVF(blob) for mod in (port_ivf, jax_ivf)]
    for ivf in ivfs:
        list(ivf.get_frames())
        ivf.loadfile()
    port, ref = (list(i.get_frames()) for i in ivfs)
    assert port == ref and len(port) == 3


def _outcome(mod, blob):
    try:
        return "ok", _read_all(mod, blob)
    except Exception as exc:  # the type is what the two must share
        return "raised", type(exc).__name__


@pytest.mark.parametrize("blob", [
    b"",                                              # no header at all
    b"DKIF" + bytes(10),                              # truncated header
    struct.pack("<4sHH4sHHIIII", b"DKIF", 0, 32, b"VP80", 1, 1, 1, 1, 0, 0),
    struct.pack("<4sHH4sHHIIII", b"RIFF", 0, 32, b"VP90", 1, 1, 1, 1, 0, 0),
    # a frame count past the frames written: the last reads come up short
    struct.pack("<4sHH4sHHIIII", b"DKIF", 0, 32, b"VP90", 1, 1, 1, 1, 3, 0)
    + struct.pack("<IQ", 5, 0) + b"abcde",
], ids=["empty", "truncated", "vp8", "riff", "short_frames"])
def test_error_cases_equal(blob):
    assert _outcome(port_ivf, blob) == _outcome(jax_ivf, blob)


def test_mutated_inputs_equal():
    rng = np.random.default_rng(7)
    blob = jax_ivf.build_ivf([b"frame-a" * 40, b"frame-b" * 55],
                             fps_num=30, fps_den=1)
    for _ in range(120):
        mutated = _mutate(rng, blob)
        assert _outcome(port_ivf, mutated) == _outcome(jax_ivf, mutated)
