"""PyTorch port: the batched HCA key search (`find_key`, `score_key`,
`rank_keys`) on the CPU, against the JAX package.

Each stream is enciphered by the JAX package's `crypt`; the candidates are
seeded decoys plus the true key. Scores must equal
pycricodecs_tpu.parallel.find_key's exactly (int64), in every case: the q2
stereo 1 s fixture (cipher 56, 40 decoys), the v3 PNS fixture (the noise
path; the true key twice, so two keys each run their own LCG, and a silent
frame that draws nothing; its frames re-packed, since the relabelled ones
fail the key test), a subkey, cipher type 1 (keyless: every key
scores alike) and the zero-coded_count stream
(tests/data/torch_port/keysearch/). The per-(key, frame) status of the
bitstream half is held to the JAX native tester (`test_frames_native`) over
hundreds of random keys, which reach the -1 (unpack error, nonzero tail) and
-6 (cursor past the end) rules. `score_key` is held to the JAX
hca_frame.score_key, `cipher_tables_56_batch` to the JAX function.
"""
import json
import os

import numpy as np
import pytest
import torch

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.utils import hca_crypt as jax_crypt
from pycricodecs_tpu.utils.crc import crc16
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch.ops import hca_unpack_device as port_unpack
from pycricodecs_tpu_torch.parallel import pipeline as port_pipeline
from pycricodecs_tpu_torch.utils import hca_crypt as port_crypt
from pycricodecs_tpu_torch.utils.crc import crc16_batch
from pycricodecs_tpu_torch.utils.signals import HCA_PNS
from tests import torch_port_helpers as H

KEYSEARCH_DIR = os.path.join(H.FIXTURE_DIR, "keysearch")
SUBKEY = 0x5A17


def _zero_coded():
    with open(os.path.join(KEYSEARCH_DIR, "expected.json")) as f:
        zc = json.load(f)["zero_coded"]
    with open(os.path.join(KEYSEARCH_DIR, zc["file"]), "rb") as f:
        return f.read()


def _silence(blob: bytes, frame: int) -> bytes:
    """`blob` with one frame's body zeroed (a silent frame; CRC restamped)."""
    out = bytearray(blob)
    hs = H.header_size(blob)
    fs = H.parse_both(blob)[1].frame_size
    off = hs + frame * fs
    out[off + 2:off + fs] = bytes(fs - 2)
    out[off + fs - 2:off + fs] = crc16(bytes(out[off:off + fs - 2])) \
        .to_bytes(2, "big")
    return bytes(out)


def _enciphered(name):
    """(stream bytes, cipher type, key, subkey) of a search case."""
    fixtures = H.load_fixtures()[1]
    if name == "q2_stereo":
        blob, ctype, sub = fixtures["q2_loop_stereo_48k_1s"], 56, 0
    elif name == "pns_v3":
        # re-packed: the relabelled frames fail the key test's tail rule
        blob = _silence(H.repack_stream(fixtures[HCA_PNS]), 3)
        ctype, sub = 56, 0
    elif name == "subkey":
        blob, ctype, sub = fixtures["q4_stereo_48k_1s"], 56, SUBKEY
    elif name == "cipher1":
        blob, ctype, sub = fixtures["q4_stereo_48k_1s"], 1, 0
    else:
        blob, ctype, sub = _zero_coded(), 56, 0
    hs = H.header_size(blob)
    return jax_hca.crypt(blob, True, hs, ctype, H.KEY, sub), ctype, sub


def _candidates(n=40, seed=11, true_at=(17,)):
    cands = [int(k) for k in
             np.random.default_rng(seed).integers(1, 1 << 63, n)]
    for i in true_at:
        cands.insert(i, H.KEY)
    return cands


CASES = ["q2_stereo", "pns_v3", "subkey", "cipher1", "zero_coded"]


@pytest.mark.parametrize("name", CASES)
def test_find_key_matches_jax(name):
    enc, ctype, sub = _enciphered(name)
    cands = _candidates(true_at=(17, 30) if name == "pns_v3" else (17,))
    ref = jax_parallel.find_key(enc, cands, subkey=sub, max_frames=8)
    got = port.find_key(enc, cands, subkey=sub, max_frames=8, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert got[17] > 0                      # the true key decodes cleanly
    if ctype == 1:
        assert (got == got[17]).all()       # the key plays no part
    else:
        assert (got < 0).sum() >= 35        # decoys rejected
        assert port.rank_keys(got)[0] == 17
    np.testing.assert_array_equal(port.rank_keys(got),
                                  jax_parallel.rank_keys(ref))


def test_find_key_in_small_device_batches(monkeypatch):
    """Chunking the (key, frame) rows changes no score."""
    enc, _, _ = _enciphered("pns_v3")
    cands = _candidates(n=12, true_at=(3, 9))
    whole = port.find_key(enc, cands, max_frames=6, device="cpu")
    monkeypatch.setattr(port_pipeline, "KEY_ROWS", 5)
    np.testing.assert_array_equal(
        port.find_key(enc, cands, max_frames=6, device="cpu"), whole)
    assert whole[3] == whole[9] > 0


def test_find_key_edges_match_jax():
    enc, _, _ = _enciphered("q2_stereo")
    for cands, mf in (([], 8), ([H.KEY, 5], 0), ([H.KEY], 1),
                      ([H.KEY, 0, 1], 3), ([H.KEY, 7], -40)):
        np.testing.assert_array_equal(
            port.find_key(enc, cands, max_frames=mf, device="cpu"),
            jax_parallel.find_key(enc, cands, max_frames=mf))


@pytest.mark.parametrize("name", ["bank_q2_stereo_48k_10s", "q4_stereo_48k_1s",
                                  HCA_PNS, "q2_6ch_48k_1s", "zero_coded"])
def test_frame_status_matches_native_tester(name):
    blob = _zero_coded() if name == "zero_coded" \
        else H.load_fixtures()[1][name]
    if name == HCA_PNS:
        blob = H.repack_stream(blob)
    blob = _silence(blob, 1)
    hs = H.header_size(blob)
    enc = jax_hca.crypt(blob, True, hs, 56, H.KEY)
    ji, pi = H.parse_both(enc)
    F, fs = 4, pi.frame_size
    raw = enc[hs:hs + F * fs]
    keys = np.random.default_rng(3).integers(1, 1 << 63, 600).astype(
        np.uint64)
    keys[5] = H.KEY
    ref = jax_frame.test_frames_native(
        ji, raw, jax_crypt.cipher_tables_56_batch(keys), want_soa=False)
    assert ref is not None, "the JAX package's native core did not load"
    fb = np.frombuffer(raw, np.uint8).reshape(F, fs)
    pre = torch.from_numpy(np.where(
        ~fb[:, 2:fs - 2].any(axis=1), 1,
        np.where(crc16_batch(fb) != 0, -1, 0)).astype(np.int64))
    tables, tix = port_pipeline._key_tables(pi, keys, 0, "cpu")
    up = port_unpack.DeviceUnpacker(pi, device="cpu")
    got, _ = port_pipeline._frame_status(
        up, torch.from_numpy(fb.copy()), pre, tables, tix, F, False)
    np.testing.assert_array_equal(got.numpy(), ref[0])
    assert (ref[0][5] == [1, 0, 1, 1]).all()   # the true key; a silent frame
    assert {-6, -1, 0, 1} <= set(np.unique(ref[0]).tolist())


@pytest.mark.parametrize("key,sub,mf", [
    (H.KEY, 0, 6), (H.KEY ^ 0x10, 0, 6), (987654321, 0, 6), (0, 0, 6),
    (H.KEY, SUBKEY, 6), (H.KEY, 0, -3)])
def test_score_key_matches_jax(key, sub, mf):
    blob = H.load_fixtures()[1]["q4_stereo_48k_1s"]
    hs = H.header_size(blob)
    enc = jax_hca.crypt(blob, True, hs, 56, H.KEY, sub)
    want = jax_frame.score_key(enc, key, subkey=sub, max_frames=mf)
    assert port.score_key(enc, key, subkey=sub, max_frames=mf,
                          device="cpu") == want
    if key == H.KEY:
        assert want == max(mf, -1)


def test_score_key_of_zero_deciphers_with_the_identity():
    """Key 0 on a plain-framed stream marked cipher 56: score_key uses the
    identity table (as a stream keyed with 0), find_key _cipher56(0)'s."""
    blob = H.load_fixtures()[1]["q4_stereo_48k_1s"]
    hs = H.header_size(blob)
    marked = jax_hca.crypt(blob, True, hs, 56, H.KEY)[:hs] + blob[hs:]
    want = jax_frame.score_key(marked, 0, max_frames=4)
    assert want == 4
    assert port.score_key(marked, 0, max_frames=4, device="cpu") == want
    np.testing.assert_array_equal(
        port.find_key(marked, [0], max_frames=4, device="cpu"),
        jax_parallel.find_key(marked, [0], max_frames=4))


def test_cipher_tables_56_batch_matches_jax():
    keys = np.random.default_rng(5).integers(0, 1 << 63, 300).astype(
        np.uint64) * np.uint64(3)
    keys[:4] = [0, 1, 2, 0xFFFFFFFFFFFFFFFF]
    keys[4] = H.KEY
    got = port_crypt.cipher_tables_56_batch(keys, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (300, 256)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_crypt.cipher_tables_56_batch(keys))
    np.testing.assert_array_equal(got[4].numpy(),
                                  port_crypt.cipher_table(56, H.KEY))


def test_rank_keys_matches_jax():
    s = np.array([5, -1, 0, 3, 3, -1, 8, 0, 1], dtype=np.int64)
    np.testing.assert_array_equal(port.rank_keys(s),
                                  jax_parallel.rank_keys(s))
    assert list(port.rank_keys(s)[:4]) == [8, 3, 4, 0]
