"""PyTorch port, the AHX / MPEG Layer II encode on the CPU (kernels' twins)
against the JAX package's f64 host lane (models/ahx.py::encode_mp2,
device=False, the lane AHX.encode, the JAX CLI and ahx_encode_batch run by
default):

(a) the analysis twin `analyze_plain` against `analyze_fast` and
    `analyze_np` on every fixture's PCM (tolerance 1e-12: another f64
    summation order; measured at most 1.4e-16, PERF.md);
(b) the spectra injection: the JAX `analyze_fast` output, recorded by a
    monkeypatch that wraps it, fed through the port's
    `encode_from_spectra` with its part and frame peaks (as K1 gives them
    with the spectra), and without them (the CPU twins take them), gives
    encode_mp2's bytes on every configuration (mono LSF 16/22.05/24 kHz,
    MPEG-1 stereo 44.1 kHz 192 kbps, joint bounds 4/8/12/16): the stages
    after the analysis are exact whatever the analysis rounding; spectra
    off the CPU without their peaks are refused (K1 gives them on the
    card, never a plain reduction);
(c) whole streams: `AHX.encode`, `encode_mp2` and
    `ahx_encode_batch(device="cpu")` give each AHX fixture's recorded
    stream_sha256 (the PCM rebuilt as tools/make_torch_port_fixtures.py
    does);
(d) a batch of streams of different lengths (1, 1152, 1153 samples,
    silence, a full-scale square wave), mono LSF and stereo groups, each
    equal to its JAX encode;
(e) the ValueErrors and their text: channels, rate, bitrate, joint_bound,
    AhxVersion, the container rules;
(f) the copied tables, the host configuration (`mp2_encode_host`) and
    `ahx_container`, held equal to their originals;
(g) the need_db of the fixtures' peaks: numpy's log10 on the host, bit for
    bit the reference's; torch's CPU log10 agrees on them too.

Tolerance: exact (bytes, bits), except (a).
"""
import hashlib

import numpy as np
import pytest
import torch

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.models import ahx as jax_ahx
from pycricodecs_tpu.ops import mp2_kernels as jax_kernels
from pycricodecs_tpu.ops import mp2_tables as jax_tables
from pycricodecs_tpu.utils.wav import write_wav
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch.models import ahx as port_ahx
from pycricodecs_tpu_torch.ops import mp2_encode_device as E
from pycricodecs_tpu_torch.ops import mp2_encode_host as EH
from pycricodecs_tpu_torch.ops import mp2_kernels as port_kernels
from pycricodecs_tpu_torch.ops import mp2_tables as port_tables
from pycricodecs_tpu_torch.utils import signals
from tests import torch_port_helpers as H

EXPECTED, _ = H.load_ahx_fixtures()
tones = signals.tones

# name -> (PCM [C, N] or a list of two such halves, rate, encode keywords),
# as tools/make_torch_port_fixtures.py makes each fixture
FIXTURE_PCM = {
    signals.AHX_BANK: (signals.ahx_bank_pcm()[None], 22050,
                       dict(bitrate_kbps=96)),
    "ahx10_lsf_mono_16k_1s": (tones(1.0, 1, 16000, 11), 16000, {}),
    "ahx11_lsf_mono_22k_1s": (tones(1.0, 1, 22050, 12), 22050,
                              dict(bitrate_kbps=64)),
    "mp2_lsf_mono_24k_1s": (tones(1.0, 1, 24000, 13), 24000, {}),
    "mp2_stereo_44k_192k_1s": (tones(1.0, 2, 44100, 14), 44100,
                               dict(bitrate_kbps=192)),
    "mp2_joint8_44k_192k_1s": (tones(1.0, 2, 44100, 15), 44100,
                               dict(bitrate_kbps=192, joint_bound=8)),
}
VBR = "mp2_vbr_lsf_mono_22k_1s"
VBR_HALVES = ((tones(0.5, 1, 22050, 17), 22050, dict(bitrate_kbps=64)),
              (tones(0.5, 1, 22050, 18), 22050, dict(bitrate_kbps=96)))
AHX_FIXTURES = {"ahx10_lsf_mono_16k_1s": dict(AhxVersion=0x10),
                "ahx11_lsf_mono_22k_1s": dict(bitrate_kbps=64),
                signals.AHX_BANK: dict(bitrate_kbps=96)}


def _padded(pcm: np.ndarray) -> np.ndarray:
    """PCM [C, N] zero-padded to whole frames, in the +-1 scale."""
    C, N = pcm.shape
    x = np.zeros((C, -(-N // 1152) * 1152))
    x[:, :N] = pcm / 32768.0
    return x


def _padded_i16(pcm: np.ndarray) -> torch.Tensor:
    C, N = pcm.shape
    x = np.zeros((1, C, -(-N // 1152) * 1152), np.int16)
    x[0, :, :N] = pcm
    return torch.from_numpy(x)


# -- (a) the analysis ----------------------------------------------------------

@pytest.mark.parametrize("name", [*FIXTURE_PCM, VBR + "[0]", VBR + "[1]"])
def test_analysis_twin_within_1e12_of_jax(name):
    pcm = (VBR_HALVES[int(name[-2])][0] if name.startswith(VBR)
           else FIXTURE_PCM[name][0])
    got = port_kernels.analyze_plain(_padded_i16(pcm)).numpy()[0]
    x = _padded(pcm)
    for ref in (jax_kernels.analyze_fast(x), jax_kernels.analyze_np(x)):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12


# -- (b) the spectra injection ---------------------------------------------------

INJECTION = {
    "lsf_mono_16k": (tones(1.0, 1, 16000, 21), 16000, {}),
    "lsf_mono_22k": (tones(1.0, 1, 22050, 22), 22050,
                     dict(bitrate_kbps=96)),
    "lsf_mono_24k": (tones(1.0, 1, 24000, 23), 24000,
                     dict(bitrate_kbps=40)),
    "stereo_44k_192k": (tones(1.0, 2, 44100, 24), 44100,
                        dict(bitrate_kbps=192)),
    **{f"joint{jb}_44k_192k": (tones(1.0, 2, 44100, 24 + jb), 44100,
                               dict(bitrate_kbps=192, joint_bound=jb))
       for jb in (4, 8, 12, 16)},
}


@pytest.mark.parametrize("name", list(INJECTION))
def test_stages_after_the_analysis_are_exact_given_the_jax_spectra(
        name, monkeypatch):
    pcm, rate, kw = INJECTION[name]
    recorded = []
    analyze = jax_kernels.analyze_fast

    def record(x):
        S = analyze(x)
        recorded.append(S)
        return S

    monkeypatch.setattr(jax_kernels, "analyze_fast", record)
    ref = jax_ahx.encode_mp2(pcm, rate, **kw)
    (S,) = recorded
    cfg = EH.configure(pcm.shape[0], rate, kw.get("bitrate_kbps"),
                       kw.get("joint_bound"))
    S_t = torch.from_numpy(S)[None]
    peaks = (E.part_peaks_plain(S_t), E.frame_peaks_plain(S_t))
    got = E.encode_from_spectra(S_t, cfg, peaks=peaks)[0]
    assert got == ref
    assert E.encode_from_spectra(S_t, cfg)[0] == ref


def test_spectra_off_the_cpu_need_their_peaks():
    cfg = EH.configure(1, 22050, 96)
    S = torch.empty((1, 1, 72, 32), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="peaks from kernel K1"):
        E.encode_from_spectra(S, cfg)


# -- (c) whole streams -------------------------------------------------------------

def _want(name: str) -> str:
    return EXPECTED[name]["stream_sha256"]


@pytest.mark.parametrize("name", list(FIXTURE_PCM))
def test_encode_mp2_equals_the_fixture(name):
    pcm, rate, kw = FIXTURE_PCM[name]
    got = port_ahx.encode_mp2(pcm if pcm.shape[0] == 2 else pcm[0], rate,
                              device="cpu", **kw)
    if name in AHX_FIXTURES:
        got = port_ahx.ahx_container(got, rate, pcm.shape[1],
                                     AHX_FIXTURES[name].get("AhxVersion",
                                                            0x11))
    assert hashlib.sha256(got).hexdigest() == _want(name)


def test_vbr_halves_equal_the_fixture():
    got = b"".join(port_ahx.encode_mp2(p[0], r, device="cpu", **kw)
                   for p, r, kw in VBR_HALVES)
    assert hashlib.sha256(got).hexdigest() == _want(VBR)


@pytest.mark.parametrize("name", list(AHX_FIXTURES))
def test_ahx_encode_equals_the_fixture(name):
    pcm, rate, _ = FIXTURE_PCM[name]
    got = port.AHX.encode(write_wav(pcm.reshape(-1), 1, rate), device="cpu",
                          **AHX_FIXTURES[name])
    assert hashlib.sha256(got).hexdigest() == _want(name)


BATCH_CASES = {
    signals.AHX_BANK: dict(),
    "ahx11_lsf_mono_22k_1s": dict(),
    "mp2_lsf_mono_24k_1s": dict(container="mp2"),
    "mp2_stereo_44k_192k_1s": dict(),
    "mp2_joint8_44k_192k_1s": dict(),
}


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_ahx_encode_batch_equals_the_fixture(name):
    """ahx_encode_batch (container "auto" wraps mono LSF in AHX, version
    0x11) of two copies of the fixture's WAV."""
    pcm, rate, kw = FIXTURE_PCM[name]
    wav = write_wav(pcm.T.reshape(-1), pcm.shape[0], rate)
    outs = port.ahx_encode_batch([wav, wav], kw.get("bitrate_kbps"),
                                 device="cpu",
                                 joint_bound=kw.get("joint_bound"),
                                 **BATCH_CASES[name])
    assert [hashlib.sha256(o).hexdigest() for o in outs] == [_want(name)] * 2


# -- (d) a batch of mixed lengths ---------------------------------------------------

def _mixed_wavs():
    rng = np.random.default_rng(44)
    mono = []
    for n in (1, 1152, 1153, 5000, 30000):
        sig = tones(n / 22050, 1, 22050, n)[0] if n > 1 else \
            np.array([12345], np.int16)
        mono.append(sig)
    mono.append(np.zeros(7000, np.int16))                       # silence
    t = np.arange(9000)
    mono.append(np.where((t // 25) % 2, 32767, -32768).astype(np.int16))
    mono.append(rng.integers(-32768, 32768, 4000).astype(np.int16))
    wavs = [write_wav(p, 1, 22050) for p in mono]
    for n in (1153, 2304, 4000):
        st = tones(n / 44100, 2, 44100, n)
        wavs.append(write_wav(st.T.reshape(-1), 2, 44100))
    sq = np.where((np.arange(3000) // 11) % 2, 32767, -32768).astype(np.int16)
    wavs.append(write_wav(np.stack([sq, -sq], 1).reshape(-1), 2, 44100))
    return wavs


@pytest.mark.parametrize("joint_bound", [None, 8])
def test_mixed_length_batch_equals_per_stream_jax_encodes(joint_bound):
    wavs = _mixed_wavs()
    got = port.ahx_encode_batch(wavs, 96, device="cpu",
                                joint_bound=joint_bound)
    want = [jax_parallel.ahx_encode_batch([w], 96, joint_bound=joint_bound)[0]
            for w in wavs]
    assert got == want
    # the group of the same streams in another order
    order = list(range(len(wavs)))[::-1]
    got_rev = port.ahx_encode_batch([wavs[i] for i in order], 96,
                                    device="cpu", joint_bound=joint_bound)
    assert got_rev == [want[i] for i in order]


def test_container_keywords_equal_jax():
    mono = _mixed_wavs()[:8]
    for container in ("auto", "mp2", "ahx"):
        assert port.ahx_encode_batch(mono, 64, device="cpu",
                                     container=container) == \
            jax_parallel.ahx_encode_batch(mono, 64, container=container)
    assert port.ahx_encode_batch([], device="cpu") == \
        jax_parallel.ahx_encode_batch([])


# -- (e) errors ------------------------------------------------------------------------

def _wav(channels=1, rate=22050, n=3000):
    pcm = tones(n / rate, channels, rate, 5)
    return write_wav(pcm.T.reshape(-1), channels, rate)


ERROR_CASES = {
    "three channels": (dict(wavs=[_wav(3)]), {}),
    "rate": (dict(wavs=[_wav(1, 8000)]), {}),
    "bitrate lsf": (dict(wavs=[_wav()]), dict(bitrate_kbps=192)),
    "bitrate mpeg-1": (dict(wavs=[_wav(2, 48000)]), dict(bitrate_kbps=8)),
    "joint_bound": (dict(wavs=[_wav(2, 44100)]), dict(joint_bound=5)),
    "joint_bound mono": (dict(wavs=[_wav()]), dict(joint_bound=6)),
    "container ahx stereo": (dict(wavs=[_wav(2, 44100)]),
                             dict(container="ahx")),
    "container ahx mpeg-1 mono": (dict(wavs=[_wav(1, 48000)]),
                                  dict(container="ahx")),
    "container name": (dict(wavs=[_wav()]), dict(container="wav")),
    "first error in order": (dict(wavs=[_wav(), _wav(2, 44100), _wav(3)]),
                             dict(container="ahx")),
    "bad wav": (dict(wavs=[_wav(), b"RIFF" + bytes(40)]), {}),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_batch_errors_equal_jax(case):
    args, kw = ERROR_CASES[case]
    got = H.outcome(port.ahx_encode_batch, args["wavs"], device="cpu", **kw)
    ref = H.outcome(jax_parallel.ahx_encode_batch, args["wavs"], **kw)
    assert isinstance(ref, tuple) and got == ref


@pytest.mark.parametrize("wav,kw", [
    (_wav(2, 22050), {}), (_wav(1, 44100), {}), (_wav(), dict(AhxVersion=3)),
    (_wav(), dict(bitrate_kbps=7)), (_wav(1, 16000), dict(bitrate_kbps=192)),
    (b"not a wav", {}),
])
def test_ahx_encode_errors_equal_jax(wav, kw):
    got = H.outcome(port.AHX.encode, wav, device="cpu", **kw)
    ref = H.outcome(jax_ahx.AHX.encode, wav, **kw)
    assert isinstance(ref, tuple) and got == ref


@pytest.mark.parametrize("pcm,rate,kw", [
    (np.zeros((3, 100), np.int16), 44100, {}),
    (np.zeros(100, np.int16), 11025, {}),
    (np.zeros(100, np.int16), 22050, dict(bitrate_kbps=320)),
    (np.zeros((2, 100), np.int16), 44100, dict(joint_bound=0)),
])
def test_encode_mp2_errors_equal_jax(pcm, rate, kw):
    got = H.outcome(port_ahx.encode_mp2, pcm, rate, device="cpu", **kw)
    ref = H.outcome(jax_ahx.encode_mp2, pcm, rate, **kw)
    assert isinstance(ref, tuple) and got == ref


def test_one_sample_stream_equals_jax():
    pcm = np.array([-7], np.int16)
    assert port_ahx.encode_mp2(pcm, 24000, device="cpu") == \
        jax_ahx.encode_mp2(pcm, 24000)
    w = write_wav(pcm, 1, 16000)
    assert port.AHX.encode(w, device="cpu") == jax_ahx.AHX.encode(w)


def test_an_empty_stream_raises_a_valueerror_as_jax_does():
    """The JAX encoder fails on no samples inside its stream packer
    (numpy's reshape ValueError, mp2_frame.py:416); the port raises a
    ValueError that says so, at the same point of a batch (after the
    stream's configuration checks, before its container's)."""
    empty = write_wav(np.zeros(0, np.int16), 1, 16000)
    calls = [(port_ahx.encode_mp2, jax_ahx.encode_mp2,
              (np.zeros(0, np.int16), 24000)),
             (port.AHX.encode, jax_ahx.AHX.encode, (empty,)),
             (port.ahx_encode_batch, jax_parallel.ahx_encode_batch,
              ([_wav(), empty],))]
    for port_fn, jax_fn, args in calls:
        kw = {"device": "cpu"}
        got, ref = H.outcome(port_fn, *args, **kw), H.outcome(jax_fn, *args)
        assert got == ("ValueError", EH.EMPTY_STREAM) and ref[0] == \
            "ValueError"
    # a configuration error of the same stream comes first in both
    bad = write_wav(np.zeros(0, np.int16), 1, 8000)
    assert H.outcome(port.ahx_encode_batch, [bad], device="cpu") == \
        H.outcome(jax_parallel.ahx_encode_batch, [bad])


# -- (f) tables, configuration, container ----------------------------------------------

@pytest.mark.parametrize("table", ["analysis_window", "analysis_matrix"])
def test_analysis_tables_equal_bit_for_bit(table):
    got = getattr(port_tables, table)()
    ref = getattr(jax_tables, table)(np.float64)
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))


@pytest.mark.parametrize("table_id", sorted(jax_tables.ALLOC_TABLES))
def test_class_meta_equals_jax(table_id):
    for (pc, pb, ps), (jc, jb, js) in zip(EH._class_meta(table_id),
                                          jax_ahx._class_meta(table_id)):
        assert list(pc) == list(jc) and pb == jb
        np.testing.assert_array_equal(np.float64(ps).view(np.int64),
                                      np.float64(js).view(np.int64))


def _jax_pads(F, bitrate_kbps, sample_rate):
    """encode_mp2's padding-slot loop (models/ahx.py:195-202)."""
    slots_num = 144 * bitrate_kbps * 1000
    acc = 0
    pads = np.zeros(F, dtype=np.int32)
    for f in range(F):
        acc += slots_num % sample_rate
        if acc >= sample_rate:
            acc -= sample_rate
            pads[f] = 1
    return pads, slots_num // sample_rate + pads


@pytest.mark.parametrize("rate", [*jax_tables.SAMPLE_RATES_V1,
                                  *jax_tables.SAMPLE_RATES_V2])
def test_configuration_equals_encode_mp2s(rate):
    rates = (jax_tables.BITRATES_V2_L2 if rate in jax_tables.SAMPLE_RATES_V2
             else jax_tables.BITRATES_V1_L2)
    for C in (1, 2):
        for jb in ((None,) if C == 1 else (None, 4, 8, 12, 16)):
            for kbps in rates[1:]:
                cfg = EH.configure(C, rate, kbps, jb)
                joint = jb is not None
                mode = 3 if C == 1 else (1 if joint else 0)
                hdr = jax_ahx.mp2_frame.parse_header(
                    jax_ahx.mp2_frame.header_word(
                        cfg.version, rates.index(kbps), cfg.sr_idx, 0, mode,
                        jb // 4 - 1 if joint else 0).to_bytes(4, "big"))
                assert tuple(cfg.hdr) == tuple(hdr)
                metas = jax_ahx._class_meta(hdr.table_id)
                assert cfg.nbal_bits == sum(
                    (len(m[0]) - 1).bit_length()
                    * (C if sb < hdr.bound else 1)
                    for sb, m in enumerate(metas))
                pads, sizes, budgets = cfg.frame_plan(250)
                ref_pads, ref_sizes = _jax_pads(250, kbps, rate)
                np.testing.assert_array_equal(pads, ref_pads)
                np.testing.assert_array_equal(sizes, ref_sizes)
                np.testing.assert_array_equal(
                    budgets, ref_sizes * 8 - 32 - cfg.nbal_bits)
    assert EH.configure(1, rate).bitrate_kbps == \
        (80 if rate in jax_tables.SAMPLE_RATES_V2 else 128)
    assert EH.configure(2, rate).bitrate_kbps == \
        (160 if rate in jax_tables.SAMPLE_RATES_V2 else 256)


def test_ahx_container_equals_jax():
    rng = np.random.default_rng(3)
    for n, version in ((0, 0x11), (1, 0x10), (220500, 0x11), (2 ** 31, 0x10)):
        stream = rng.integers(0, 256, n % 977, dtype=np.uint8).tobytes()
        for rate in (16000, 22050, 24000):
            assert port_ahx.ahx_container(stream, rate, n, version) == \
                jax_ahx.ahx_container(stream, rate, n, version)
            assert port_ahx.ahx_container(stream, rate, n) == \
                jax_ahx.ahx_container(stream, rate, n)


# -- (g) need_db -------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FIXTURE_PCM))
def test_need_db_is_numpys_log10_of_the_peaks(name):
    pcm, _, _ = FIXTURE_PCM[name]
    S = jax_kernels.analyze_fast(_padded(pcm))
    C = S.shape[0]
    F = S.shape[1] // 36
    peaks = np.abs(S).reshape(C, F, 3, 12, 32).max(axis=3)
    ref = 20.0 * np.log10(np.maximum(peaks.max(axis=2), 1e-9))   # [C,F,32]
    port_peaks = E.frame_peaks_plain(torch.from_numpy(S)[None])  # [1,F,C,32]
    got = E.need_db_host(port_peaks)[0].permute(1, 0, 2).numpy()
    np.testing.assert_array_equal(got.view(np.int64), ref.view(np.int64))
    p = np.maximum(peaks.max(axis=2), 1e-9)
    torch_cpu = torch.log10(torch.from_numpy(p)).numpy()
    assert int((torch_cpu != np.log10(p)).sum()) == 0


def test_bit_writer_equals_jax():
    from pycricodecs_tpu.utils.bitio import BitWriter as JaxWriter
    from pycricodecs_tpu_torch.utils.bitio import BitWriter as PortWriter
    rng = np.random.default_rng(9)
    for size in (1, 7, 64):
        jw, pw = JaxWriter(size), PortWriter(size)
        for _ in range(200):
            v, n = int(rng.integers(0, 1 << 33)), int(rng.integers(-1, 34))
            jw.write(v, n)
            pw.write(v, n)
            assert pw.pos == jw.pos
        assert pw.getvalue() == jw.getvalue()
