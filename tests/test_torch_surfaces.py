"""PyTorch port, the remaining single-device surfaces on the CPU:
`models.ahx.decode_mp2` (kernels B10 and `mp2_synth` through their twins)
gives the samples and rate of the JAX `decode_mp2(device=False)` on every
AHX and Layer II fixture, with offsets and frame caps, and its errors;
the port's graft entry (`__graft_entry_torch__.entry`) builds the JAX
entry's example frames and its `fn` gives the JAX `fn`'s (pcm, err);
`parallel.trace` writes a Chrome trace; `measure_d2h_bandwidth` measures
once; the `WavFile` helpers equal the JAX package's. Neither the graft
entry nor anything it imports pulls in jax or pycricodecs_tpu.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import __graft_entry_torch__ as port_entry
from pycricodecs_tpu.models import ahx as jax_ahx
from pycricodecs_tpu.ops import mp2_frame as jax_mp2
from pycricodecs_tpu.utils import wav as jax_wav
from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.models import ahx as port_ahx
from pycricodecs_tpu_torch.utils import wav as port_wav
from tests import torch_port_helpers as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AHX_NAMES = sorted(H.load_ahx_fixtures()[0])


def _both_mp2(blob, offset, **kw):
    ref = H.outcome(jax_ahx.decode_mp2, blob, offset, device=False, **kw)
    got = H.outcome(port_ahx.decode_mp2, blob, offset, device="cpu", **kw)
    return ref, got


def _assert_same_mp2(ref, got):
    assert isinstance(got[0], np.ndarray), got
    assert got[1] == ref[1]
    assert got[0].dtype == ref[0].dtype == np.int16
    assert got[0].shape == ref[0].shape
    np.testing.assert_array_equal(got[0], ref[0])


# -- decode_mp2 ------------------------------------------------------------------

@pytest.mark.parametrize("name", AHX_NAMES)
def test_decode_mp2_matches_the_jax_host_lane(name):
    _, blobs = H.load_ahx_fixtures()
    blob = blobs[name]
    off = H.mp2_offset(blob)
    _, walk = jax_mp2.scan_frames(blob, off)
    for kw in ({}, {"max_frames": 1}, {"max_frames": 5}):
        ref, got = _both_mp2(blob, off, **kw)
        _assert_same_mp2(ref, got)
    # untrimmed: every frame's 1,152 samples
    assert got[0].shape[1] == 5 * 1152 or len(walk) < 5
    full = _both_mp2(blob, off)[1]
    assert full[0].shape[1] == len(walk) * 1152


def test_decode_mp2_from_a_later_frame():
    _, blobs = H.load_ahx_fixtures()
    blob = blobs["mp2_stereo_44k_192k_1s"]
    _, walk = jax_mp2.scan_frames(blob, 0)
    ref, got = _both_mp2(blob, walk[7][0], max_frames=9)
    _assert_same_mp2(ref, got)
    assert got[0].shape == (2, 9 * 1152)


def _truncated_frame(blob: bytes) -> bytes:
    """The stream with its last frame's bitrate lowered (its bytes cut to
    the new size), so that frame's fields cross its end."""
    off = H.mp2_offset(blob)
    _, walk = jax_mp2.scan_frames(blob, off)
    pos, fr = walk[-1]
    w = int.from_bytes(fr[:4], "big")
    w = (w & ~(0xF << 12)) | (1 << 12)                  # lowest bitrate
    size = jax_mp2.parse_header(w.to_bytes(4, "big")).frame_size
    return blob[:pos] + w.to_bytes(4, "big") + fr[4:size]


def test_decode_mp2_errors_match_jax():
    _, blobs = H.load_ahx_fixtures()
    blob = blobs["ahx11_lsf_mono_22k_1s"]
    off = H.mp2_offset(blob)
    _, walk = jax_mp2.scan_frames(blob, off)
    cases = {
        "no_sync": (b"xyz" * 20, 0),
        "no_complete_frame": (blob[:off + 100], off),
        "fields_past_the_frame": (_truncated_frame(blob), off),
    }
    for what, (data, offset) in cases.items():
        ref, got = _both_mp2(data, offset)
        assert isinstance(got, tuple) and isinstance(got[0], str), what
        assert got == ref, what
    # a last frame cut short: the walk stops before it, in both
    cut = blob[:walk[-1][0] + 20]
    ref, got = _both_mp2(cut, off)
    _assert_same_mp2(ref, got)
    assert got[0].shape[1] == (len(walk) - 1) * 1152


# -- the graft entry -------------------------------------------------------------

@pytest.fixture(scope="module")
def entries():
    return jax_entry.entry(), port_entry.entry(device="cpu")


def test_graft_entry_example_frames_equal_jax(entries):
    (_, jargs), (_, pargs) = entries
    assert len(pargs) == 1
    frames = pargs[0]
    assert frames.device.type == "cpu" and frames.dtype == torch.uint8
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jargs[0]))
    assert frames.shape[0] == port_entry.STREAMS == 4


def test_graft_entry_fn_matches_the_jax_fn(entries):
    (jfn, jargs), (pfn, pargs) = entries
    jpcm, jerr = (np.asarray(x) for x in jfn(*jargs))
    pcm, err = pfn(*pargs)
    B, F = jerr.shape
    C = jpcm.shape[-1]
    assert pcm.shape == (B, F * 1024, C) and pcm.dtype == torch.int16
    np.testing.assert_array_equal(pcm.numpy(), jpcm.reshape(B, F * 1024, C))
    np.testing.assert_array_equal(err.numpy(), jerr)
    assert not err.any() and pcm.abs().max() > 1000


def test_graft_entry_imports_neither_jax_nor_the_jax_package():
    path = os.path.join(ROOT, "__graft_entry_torch__.py")
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
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "pycricodecs_tpu"), name
    code = ("import sys, __graft_entry_torch__ as g; "
            "fn, args = g.entry(device='cpu'); pcm, err = fn(*args); "
            "assert not bool(err.any()); "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'pycricodecs_tpu' not in sys.modules, 'pycricodecs_tpu'")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


# -- trace and measure_d2h_bandwidth ---------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    blob = H.load_fixture("q2_mono_48k_1s")
    log_dir = tmp_path / "prof"
    with port_parallel.trace(str(log_dir)) as tr:
        wav = port_parallel.decode_batch([blob], device="cpu")[0]
    assert wav[:4] == b"RIFF"
    assert tr.path is not None and os.path.dirname(tr.path) == str(log_dir)
    with open(tr.path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)


def test_measure_d2h_bandwidth_is_measured_once():
    mbps = port_parallel.measure_d2h_bandwidth(1 << 16, device="cpu")
    assert mbps > 0
    assert port_parallel.measure_d2h_bandwidth(device="cpu") == mbps


# -- WavFile helpers ---------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 6])
def test_wavfile_helpers_equal_jax(channels):
    pcm = np.random.default_rng(channels).integers(
        -32768, 32768, 1200 * channels, dtype=np.int16)
    blob = jax_wav.write_wav(pcm, channels, 44100)
    ref, got = jax_wav.parse_wav(blob), port_wav.parse_wav(blob)
    assert got.samples_per_channel == ref.samples_per_channel == 1200
    np.testing.assert_array_equal(got.deinterleave(), ref.deinterleave())
    assert got.deinterleave().shape == (channels, 1200)
    np.testing.assert_array_equal(got.deinterleave()[-1],
                                  pcm[channels - 1::channels])


# -- the values chip_smoke.py's phase 17 holds the card to ----------------------

def _surfaces():
    with open(os.path.join(H.FIXTURE_DIR, "surfaces", "expected.json")) as f:
        return json.load(f)


def _record(pcm):
    pcm = np.ascontiguousarray(pcm)
    assert pcm.dtype == np.int16
    return {"sha256": H.sha256(pcm.tobytes()), "shape": list(pcm.shape)}


@pytest.mark.parametrize("part", ["decode_range", "decode_frames_to_pcm",
                                  "test_block_state", "decode_mp2",
                                  "awb_builder", "graft_entry"])
def test_port_gives_the_recorded_surface_values(tmp_path, part):
    """tests/data/torch_port/surfaces/expected.json (the JAX package's
    values, tools/make_torch_port_fixtures.py --surfaces) from the port on
    the CPU."""
    from pycricodecs_tpu_torch.containers.awb import AWBBuilder
    from pycricodecs_tpu_torch.models import hca as port_hca
    from pycricodecs_tpu_torch.ops import hca_frame as port_frame

    e = _surfaces()[part]
    if part == "decode_range":
        blob = H.load_fixture(e["stream"])
        for a, b, rec in e["ranges"]:
            assert _record(port_hca.decode_range(blob, a, b,
                                                 device="cpu")) == rec
        hs = H.header_size(blob)
        enc = port_hca.crypt(blob, True, hs, 56, e["enciphered_key"])
        assert H.sha256(enc) == e["enciphered_sha256"]
        for a, b, rec in e["enciphered_ranges"]:
            assert _record(port_hca.decode_range(
                enc, a, b, e["enciphered_key"], device="cpu")) == rec
    elif part == "decode_frames_to_pcm":
        blob = H.load_fixture(e["stream"])
        _, pi = H.parse_both(blob)
        for state, rec in e["random_states"]:
            assert _record(port_hca.decode_frames_to_pcm(
                pi, blob[H.header_size(blob):], state, device="cpu")) == rec
    elif part == "test_block_state":
        rng = _surfaces()["decode_range"]
        blob = H.load_fixture(rng["stream"])
        hs = H.header_size(blob)
        enc = port_hca.crypt(blob, True, hs, 56, rng["enciphered_key"])
        for key, rec in e["keys"].items():
            _, pi = H.parse_both(enc, int(key, 16))
            scores, states = port_frame.score_frames(
                pi, enc[hs:hs + pi.frame_count * pi.frame_size],
                e["start_state"], device="cpu")
            pairs = np.stack([scores, states], 1).astype("<i8")
            assert H.sha256(pairs.tobytes()) == rec["pairs_sha256"], key
    elif part == "decode_mp2":
        _, blobs = H.load_ahx_fixtures()
        for name, rec in e.items():
            pcm, rate = port_ahx.decode_mp2(blobs[name], rec["offset"],
                                            device="cpu")
            assert rate == rec["sample_rate"]
            assert _record(pcm) == {"sha256": rec["sha256"],
                                    "shape": rec["shape"]}
    elif part == "awb_builder":
        out = tmp_path / "list.awb"
        AWBBuilder([os.path.join(H.FIXTURE_DIR, n)
                    for n in e["members"]]).build(str(out))
        assert H.sha256(out.read_bytes()) == e["sha256"]
    else:
        fn, args = port_entry.entry(device="cpu")
        pcm, err = fn(*args)
        assert H.sha256(pcm.numpy().tobytes()) == e["sha256"]
        assert bool(err.any()) == e["err_any"]
