"""PyTorch port: the batched bank decode (the port's main path) on the CPU,
byte-equal to pycricodecs_tpu.parallel.decode_batch with its device engine
and with its host engine.

One mixed call covers: several configs and lengths, a truncated stream
(tail zeroing), per-stream subkeys on enciphered streams, and a looped
stream (smpl chunk). Also: on_error="isolate" with one corrupt CRC, a v3
PNS stream beside a v2 one, the launch counters, the refusal of
chip_smoke.py without a GPU, and the committed fixtures.
"""
import cProfile
import hashlib
import importlib.util
import os
import pstats
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.utils.hca_crypt import scramble_subkey
from pycricodecs_tpu_torch import parallel as port_parallel
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.ops import hca_unpack_device as port_unpack
from tests import torch_port_helpers as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB_A, SUB_B = 0x1234, 0x0042


def _truncate(blob: bytes, frames_dropped: int) -> bytes:
    ji, _ = H.parse_both(blob)
    keep = (ji.frame_count - frames_dropped) * ji.frame_size + 100
    return blob[:H.header_size(blob) + keep]


def _mixed_streams():
    """name -> (blob, subkey)."""
    return {
        "q2_stereo_1s": (H.encode(2, 2, seed=11, samples=48000), 0),
        "q2_stereo_short": (H.encode(2, 2, seed=12, samples=29000), 0),
        "q2_stereo_truncated": (_truncate(
            H.encode(2, 2, seed=13, samples=48000), 7), 0),
        "q2_stereo_looped": (H.encode(2, 2, seed=14, samples=40000,
                                      loop=(5000, 30000)), 0),
        "q2_stereo_keyed_a": (H.encode(
            2, 2, seed=15, samples=20000,
            key=scramble_subkey(H.KEY, SUB_A)), SUB_A),
        "q2_stereo_keyed_b": (H.encode(
            2, 2, seed=16, samples=20000,
            key=scramble_subkey(H.KEY, SUB_B)), SUB_B),
        "q4_stereo": (H.encode(2, 4, seed=17, samples=38000), 0),
        "q2_mono": (H.encode(1, 2, seed=18, samples=48000), 0),
        "q2_6ch": (H.encode(6, 2, seed=19, samples=24000), 0),
    }


@pytest.fixture(scope="module")
def mixed():
    streams = _mixed_streams()
    names = list(streams)
    blobs = [streams[n][0] for n in names]
    subkeys = [streams[n][1] for n in names]
    port_stats = port_parallel.DecodeStats()
    jax_stats = jax_parallel.DecodeStats()
    port = port_parallel.decode_batch(blobs, key=H.KEY, subkeys=subkeys,
                                      device="cpu", stats=port_stats)
    dev = jax_parallel.decode_batch(blobs, key=H.KEY, subkeys=subkeys,
                                    engine="device", stats=jax_stats)
    host = jax_parallel.decode_batch(blobs, key=H.KEY, subkeys=subkeys,
                                     engine="host")
    return dict(names=names, blobs=blobs, subkeys=subkeys, port=port,
                dev=dev, host=host, port_stats=port_stats,
                jax_stats=jax_stats)


STREAM_NAMES = ["q2_stereo_1s", "q2_stereo_short", "q2_stereo_truncated",
                "q2_stereo_looped", "q2_stereo_keyed_a", "q2_stereo_keyed_b",
                "q4_stereo", "q2_mono", "q2_6ch"]


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_mixed_call_stream_matches_jax_engines(mixed, name):
    i = mixed["names"].index(name)
    got = mixed["port"][i]
    assert isinstance(got, bytes)
    assert got == mixed["dev"][i], "differs from the JAX device engine"
    assert got == mixed["host"][i], "differs from the JAX host engine"


def test_mixed_call_cases_are_meaningful(mixed):
    out = dict(zip(mixed["names"], mixed["port"]))
    # looped stream: 0x70-byte header with the smpl chunk
    assert out["q2_stereo_looped"][36:40] == b"smpl"
    # truncated stream: full length, silent tail
    full = out["q2_stereo_truncated"]
    pcm = np.frombuffer(full[44:], np.int16)
    assert len(pcm) > 0 and not pcm[-2 * 6 * 1024:].any()
    assert pcm[:len(pcm) // 2].any()
    assert mixed["names"] == STREAM_NAMES


def test_decode_stats_counts_match_jax(mixed):
    p, j = mixed["port_stats"], mixed["jax_stats"]
    for field in ("streams", "groups", "frames", "failed_streams",
                  "bytes_in", "samples_out", "device_unpack_streams"):
        assert getattr(p, field) == getattr(j, field), field
    assert p.total_seconds > 0


def test_return_arrays_match_jax():
    blobs = [H.encode(2, 4, seed=21, samples=20000),
             H.encode(1, 2, seed=22, samples=15000)]
    got = port_parallel.decode_batch(blobs, device="cpu", return_arrays=True)
    ref = jax_parallel.decode_batch(blobs, engine="host", return_arrays=True)
    for (pcm, info), (rpcm, rinfo) in zip(got, ref):
        assert pcm.dtype == np.int16 and pcm.shape == rpcm.shape
        np.testing.assert_array_equal(pcm, rpcm)
        assert info.frame_count == rinfo.frame_count


def test_isolate_one_corrupt_crc(mixed):
    # equal frame counts: the JAX device engine's per-stream retries then
    # share one compiled shape
    names = ["q2_stereo_1s", "q2_stereo_truncated", "q2_stereo_1s"]
    blobs = [mixed["blobs"][mixed["names"].index(n)] for n in names]
    ji, _ = H.parse_both(blobs[0])
    bad = bytearray(blobs[0])
    bad[H.header_size(blobs[0]) + 5 * ji.frame_size + 40] ^= 0x10
    blobs = [blobs[0], bytes(bad), blobs[1], blobs[2]]
    got = port_parallel.decode_batch(blobs, device="cpu", on_error="isolate")
    dev = jax_parallel.decode_batch(blobs, engine="device",
                                    on_error="isolate")
    host = jax_parallel.decode_batch(blobs, engine="host",
                                     on_error="isolate")
    for i in (0, 2, 3):
        assert got[i] == dev[i] == host[i]
    assert isinstance(got[1], ValueError)
    assert type(got[1]).__name__ == type(dev[1]).__name__ == "HcaError"
    assert str(got[1]) == str(dev[1]) == "Frame checksum mismatch"
    assert isinstance(host[1], ValueError)
    with pytest.raises(ValueError, match="checksum"):
        port_parallel.decode_batch(blobs, device="cpu")


def test_pns_noise_stream_decodes_like_jax():
    """A v3 PNS stream (min_resolution 0) beside a v2 stream: byte-equal to
    the JAX package's host engine and single-stream decode, in both error
    modes."""
    from pycricodecs_tpu.models import hca as jax_hca
    from tests.test_hca import _relabel_v3
    v3 = _relabel_v3(H.encode(1, 0, seed=77, samples=24576))
    ok = H.encode(2, 2, seed=23, samples=10000)
    for mode in ("raise", "isolate"):
        got = port_parallel.decode_batch([ok, v3], device="cpu",
                                         on_error=mode)
        assert got == jax_parallel.decode_batch([ok, v3], engine="host",
                                                on_error=mode)
        assert got[1] == jax_hca.decode(v3)


def test_launch_counters_stay_zero_on_cpu():
    port_parallel.decode_batch([H.encode(2, 4, seed=24, samples=9000)],
                               device="cpu")
    assert port_unpack.SIDE_INFO_LAUNCHES == 0
    assert port_unpack.COEFF_LAUNCHES == 0
    assert cuda_kernels.TRANSFORM_LAUNCHES == 0


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    r = _run_smoke(alone)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_tool_names_the_pipeline_pieces():
    """The slice profiler's host breakdown finds every piece it names in a
    real decode, and its device busy time is the union of the intervals."""
    prof_tool = _tool("profile_torch_slice")
    _, blobs = H.load_fixtures()
    cp = cProfile.Profile()
    cp.enable()
    port_parallel.decode_batch([blobs["q2_mono_48k_1s"]] * 2, device="cpu")
    cp.disable()
    stats = pstats.Stats(cp).stats
    for label, fsuffix, fname in prof_tool.HOST_PIECES:
        assert any((f == "~" and fname in fn) if fsuffix == "~"
                   else (f.endswith(fsuffix) and fn == fname)
                   for f, _, fn in stats), label
    pieces = prof_tool.host_pieces(cp)
    assert 0 < pieces["crc16_batch"] < pieces["_decode_group"] \
        <= pieces["decode_batch (whole call)"]
    assert prof_tool.union_us([("a", "kernel", 0.0, 10.0),
                               ("b", "gpu_memcpy", 5.0, 10.0),
                               ("c", "kernel", 30.0, 1.0)]) == 16.0
    # the ADX bank's pieces, in a real ADX decode
    _, adx_blobs = H.load_adx_fixtures()
    cp = cProfile.Profile()
    cp.enable()
    port_parallel.adx_decode_batch([adx_blobs["adx_bd8_stereo_1s"]] * 2,
                                   device="cpu")
    cp.disable()
    stats = pstats.Stats(cp).stats
    for label, fsuffix, fname in prof_tool.ADX_HOST_PIECES:
        assert any((f == "~" and fname in fn) if fsuffix == "~"
                   else (f.endswith(fsuffix) and fn == fname)
                   for f, _, fn in stats), label
    pieces = prof_tool.host_pieces(cp, prof_tool.ADX_HOST_PIECES)
    assert 0 < pieces["_interleave"] < pieces["adx_decode_batch (whole call)"]
    assert os.path.exists(prof_tool.ADX_BANK)
    # the HCA encode bank's pieces, in a real encode
    from pycricodecs_tpu_torch.utils import signals
    from pycricodecs_tpu_torch.utils.wav import write_wav
    wav = signals.hca_wav("q2_mono_48k_1s", write_wav)
    cp = cProfile.Profile()
    cp.enable()
    port_parallel.hca_encode_batch([wav] * 2, quality=2, device="cpu")
    cp.disable()
    stats = pstats.Stats(cp).stats
    for label, fsuffix, fname in prof_tool.ENCODE_HOST_PIECES:
        assert any((f == "~" and fname in fn) if fsuffix == "~"
                   else (f.endswith(fsuffix) and fn == fname)
                   for f, _, fn in stats), label
    pieces = prof_tool.host_pieces(cp, prof_tool.ENCODE_HOST_PIECES)
    assert 0 < pieces["build_timeline"] \
        <= pieces["stack_timelines (stacking, build_timeline included)"] \
        < pieces["hca_encode_batch (whole call)"]
    # the AHX bank's pieces, in a real AHX decode
    _, ahx_blobs = H.load_ahx_fixtures()
    cp = cProfile.Profile()
    cp.enable()
    port_parallel.ahx_decode_batch([ahx_blobs["ahx11_lsf_mono_22k_1s"]] * 2,
                                   device="cpu")
    cp.disable()
    stats = pstats.Stats(cp).stats
    for label, fsuffix, fname in prof_tool.AHX_HOST_PIECES:
        assert any((f == "~" and fname in fn) if fsuffix == "~"
                   else (f.endswith(fsuffix) and fn == fname)
                   for f, _, fn in stats), label
    pieces = prof_tool.host_pieces(cp, prof_tool.AHX_HOST_PIECES)
    assert 0 < pieces["scan_frames"] \
        <= pieces["_parse_mp2 (AHX header + frame walk)"] \
        < pieces["ahx_decode_batch (whole call)"]
    assert os.path.exists(prof_tool.AHX_BANK)
    for extra in ([], ["--adx"], ["--hca-encode"], ["--ahx"]):
        r = subprocess.run([sys.executable, "tools/profile_torch_slice.py",
                            *extra], cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0


def test_fixtures_regenerate_byte_identically():
    tool = _tool("make_torch_port_fixtures")
    expected, blobs = H.load_fixtures()
    made = tool.make_streams()
    assert sorted(made) == sorted(expected)
    for name, (wav, blob) in made.items():
        assert blob == blobs[name], name
        assert hashlib.sha256(wav).hexdigest() == \
            expected[name]["wav_in_sha256"], name
        assert hashlib.sha256(blob).hexdigest() == \
            expected[name]["hca_sha256"], name
    adx_expected, adx_blobs = H.load_adx_fixtures()
    made = tool.make_adx_streams()
    assert sorted(made) == sorted(adx_expected)
    for name, (wav, blob) in made.items():
        assert blob == adx_blobs[name], name
        assert hashlib.sha256(wav).hexdigest() == \
            adx_expected[name]["wav_in_sha256"], name
        assert hashlib.sha256(blob).hexdigest() == \
            adx_expected[name]["adx_sha256"], name


@pytest.mark.parametrize("name", sorted(H.load_fixtures()[0]))
def test_fixture_wav_hash_matches_jax_and_port(name):
    expected, blobs = H.load_fixtures()
    want = expected[name]["wav_sha256"]
    ref = jax_parallel.decode_batch([blobs[name]], engine="host")[0]
    assert hashlib.sha256(ref).hexdigest() == want
    got = port_parallel.decode_batch([blobs[name]], device="cpu")[0]
    assert hashlib.sha256(got).hexdigest() == want
