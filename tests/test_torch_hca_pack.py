"""PyTorch port, HCA frame packer (the plain twin of kernel `hca_pack`, which
carries B9's symbol -> word placement): `pack_frames_plain` equals the JAX
package's `pack_frames_device` (XLA scatter, and the B9 Pallas scatter in
interpret mode) and its host packer (`hca_frame_pack` / `pack_frame`) byte
for byte, including a symbol that ends inside the CRC slot; frames that
overflow the writer equal both.
"""
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_encode_device as JD
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.ops.hca_pack_device import pack_frames_device
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.ops import hca_pack_device as PP
import chip_smoke
from tests import torch_port_helpers  # noqa: F401  (one torch thread)
from tests.test_pack_device import CASES, _encode_tensors, _wav


def _case_id(c):
    return (f"ch{c['channels']}q{c['quality']}r{c.get('rate', 44100)}"
            f"{'loop' if c.get('loop') else ''}")


def _kw(info):
    return dict(channels=int(info.channels),
                coded_counts=tuple(int(x) for x in info.coded_count),
                channel_types=tuple(int(x) for x in info.channel_type),
                hfr_group_count=int(info.hfr_group_count),
                frame_size=int(info.frame_size))


def _port(tensors, info):
    t = [torch.from_numpy(np.array(a)) for a in tensors]
    return PP.pack_frames_plain(*t, **_kw(info)).numpy()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pack_plain_matches_jax_device_and_host(case):
    wav = _wav(samples=case["samples"], channels=case["channels"],
               rate=case.get("rate", 44100), seed=case["seed"],
               loop=case.get("loop", False))
    info, F, tensors = _encode_tensors(wav, case["quality"])
    got = _port(tensors, info)
    dev = np.asarray(pack_frames_device(*tensors, **_kw(info)))
    np.testing.assert_array_equal(got, dev)
    host = JD.hca_frame_pack(info, *[a[0, :F] for a in tensors])
    assert got[0, :F].tobytes() == host


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3], CASES[4]],
                         ids=_case_id)
def test_pack_plain_matches_b9_pallas_scatter(case):
    """pack_frames_device with the B9 scatter kernel (interpret mode)."""
    wav = _wav(samples=case["samples"], channels=case["channels"],
               rate=case.get("rate", 44100), seed=case["seed"] + 40,
               loop=case.get("loop", False))
    info, F, tensors = _encode_tensors(wav, case["quality"])
    got = _port(tensors, info)
    b9 = np.asarray(pack_frames_device(*tensors, **_kw(info),
                                       pallas_mode="interpret"))
    np.testing.assert_array_equal(got, b9)


def test_pack_plain_keeps_the_symbol_that_ends_in_the_crc_slot():
    """chip_smoke.py's CRC-slot frame (the JAX suite's case, 48 kHz q0
    stereo, frame_size 1024): its last spectrum symbol starts in the last
    data byte and ends inside the CRC slot, with all-ones leading bits."""
    info, _, _ = _encode_tensors(_wav(samples=4096, channels=2, rate=48000,
                                      seed=3), 0)
    assert info.frame_size == 1024
    tt, lead = chip_smoke.crc_slot_tensors(info, "cpu")
    t = [x.numpy() for x in tt]
    assert lead > 0
    got = _port(t, info)
    host = jax_frame.pack_frame(info, 0, 0, *[a[0, 0] for a in t[2:]])
    assert got[0, 0].tobytes() == host
    np.testing.assert_array_equal(
        got, np.asarray(pack_frames_device(*t, **_kw(info))))
    fs = int(info.frame_size)
    k = min(lead, 8)
    assert got[0, 0, fs - 3] & ((1 << k) - 1) == (1 << k) - 1


def _random_frames(info, n, seed):
    """chip_smoke.py's random encode tensors (legal value ranges; most
    frames overflow the writer) as numpy [1, n, ...]."""
    t = chip_smoke.random_pack_tensors(np.random.default_rng(seed), info, n,
                                       "cpu")
    return [x.numpy() for x in t]


@pytest.mark.parametrize("channels,quality", [(2, 2), (1, 4), (6, 2),
                                              (2, 0), (8, 1)])
def test_pack_plain_matches_host_packer_on_random_frames(channels, quality):
    """Random legal values, overflowing frames included (a write that would
    cross fs*8 is dropped and the cursor stays): every frame equals the
    JAX package's host packer, write by write."""
    info, _, _ = _encode_tensors(_wav(samples=4096, channels=channels,
                                      rate=48000, seed=channels), quality)
    t = _random_frames(info, 12, seed=channels * 7 + quality)
    got = _port(t, info)
    for f in range(12):
        host = jax_frame.pack_frame(info, int(t[0][0, f]), int(t[1][0, f]),
                                    *[a[0, f] for a in t[2:]])
        assert got[0, f].tobytes() == host, f


def test_overflow_frames_agree_between_host_and_device_packers():
    """Frames whose symbols overflow fs*8: the host writer drops only the
    crossing writes and keeps later ones that fit, the device packers drop
    every symbol past the first crossing one; what the host writes after a
    drop lies inside the CRC slot, so all three give the same bytes."""
    info, _, _ = _encode_tensors(_wav(samples=4096, channels=2, rate=48000,
                                      seed=2), 2)
    t = _random_frames(info, 6, seed=5)
    got = _port(t, info)
    dev = np.asarray(pack_frames_device(*t, **_kw(info)))
    fs = int(info.frame_size)
    for f in range(6):
        host = jax_frame.pack_frame(info, int(t[0][0, f]), int(t[1][0, f]),
                                    *[a[0, f] for a in t[2:]])
        assert got[0, f].tobytes() == host == dev[0, f].tobytes(), f
    value, bits = PP._symbols(*[torch.from_numpy(a[0]) for a in t],
                              **{k: v for k, v in _kw(info).items()
                                 if k not in ("channels", "frame_size")})
    assert bool((bits.sum(dim=1) > fs * 8).all()), "no frame overflows"


def test_pack_frames_runs_the_twin_on_cpu_and_the_wrapper_refuses_it():
    info, F, tensors = _encode_tensors(_wav(samples=4096, channels=2,
                                            seed=1), 1)
    t = [torch.from_numpy(np.array(a)) for a in tensors]
    before = cuda_kernels.PACK_LAUNCHES
    got = PP.pack_frames(*t, **_kw(info))
    assert torch.equal(got, PP.pack_frames_plain(*t, **_kw(info)))
    assert cuda_kernels.PACK_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.hca_pack(*t, **_kw(info))


def test_pack_plain_chunks_frames_alike(monkeypatch):
    """The twin packs PLAIN_CHUNK_FRAMES frames per pass; a small chunk
    gives the same bytes."""
    info, F, tensors = _encode_tensors(_wav(samples=16384, channels=2,
                                            seed=9), 2)
    full = _port(tensors, info)
    monkeypatch.setattr(PP, "PLAIN_CHUNK_FRAMES", 3)
    np.testing.assert_array_equal(_port(tensors, info), full)
