"""PyTorch port: the configs the device unpacker used to refuse, on the CPU,
against the JAX package.

- A channel with coded_count 0: a v2.0 `comp` header may carry
  base_band_count 0, which makes the stereo secondary's coded_count 0. The
  stream is tests/data/torch_port/keysearch/zero_coded_v2_stereo_48k_1s.hca,
  the q4 stereo fixture re-packed by the JAX package's pack_frame under such
  a header (tests/torch_port_helpers.py zero_coded_stream). `decode_batch`
  must equal the JAX decode_batch (which sends the config to its host
  unpacker) byte for byte, and B1/B2's twins the JAX host unpack, the
  secondary's lone sf[0] included.
- The v3 HFR extension at 128 scalefactors: the JAX Python unpacker raises
  IndexError (it copies sf[128]), its native one reads past the channel's
  row; the port refuses the stream with HcaError, per stream under
  on_error="isolate". Pinned here.
Tolerance 0 throughout.
"""
import hashlib
import json
import os

import numpy as np
import pytest

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu.utils.crc import crc16
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.ops import hca_unpack_device as port_unpack
from pycricodecs_tpu_torch.utils.signals import HCA_PNS
from tests import torch_port_helpers as H

KEYSEARCH_DIR = os.path.join(H.FIXTURE_DIR, "keysearch")


@pytest.fixture(scope="module")
def zero_coded():
    with open(os.path.join(KEYSEARCH_DIR, "expected.json")) as f:
        entry = json.load(f)["zero_coded"]
    with open(os.path.join(KEYSEARCH_DIR, entry["file"]), "rb") as f:
        return entry, f.read()


def test_zero_coded_fixture_is_the_repacked_q4_stream(zero_coded):
    entry, blob = zero_coded
    rebuilt = H.zero_coded_stream(H.load_fixtures()[1][entry["source"]])
    assert rebuilt == blob
    _, pi = H.parse_both(blob)
    assert pi.version == 0x0200 and pi.base_band_count == 0
    assert list(pi.coded_count) == [64, 0] and pi.hfr_group_count == 8


def test_unpack_zero_coded_matches_host_reference(zero_coded):
    blob = zero_coded[1]
    ji, pi = H.parse_both(blob)
    ref = jax_frame._unpack_frames_py(
        ji, blob[H.header_size(blob):][:ji.frame_count * ji.frame_size])
    up = port_unpack.DeviceUnpacker(pi, device="cpu")
    qc, sf, res, inten, err = up(H.frames_of(blob, pi))
    assert not err.any()
    np.testing.assert_array_equal(qc.numpy(), ref.qc)
    np.testing.assert_array_equal(sf.numpy(), ref.scalefactors)
    np.testing.assert_array_equal(res.numpy(), ref.resolutions)
    np.testing.assert_array_equal(inten.numpy(), ref.intensity)
    # the secondary reads its 3 delta bits and the first 6-bit value only
    assert (sf.numpy()[:, 1, 0] > 0).all() and not sf.numpy()[:, 1, 1:].any()


@pytest.mark.parametrize("on_error", ["raise", "isolate"])
def test_decode_zero_coded_matches_jax(zero_coded, on_error):
    entry, blob = zero_coded
    fixtures = H.load_fixtures()[1]
    batch = [blob, fixtures["q4_stereo_48k_1s"], blob,
             H.zero_coded_stream(fixtures["q2_loop_stereo_48k_1s"])]
    got = port.decode_batch(batch, device="cpu", on_error=on_error)
    want = jax_parallel.decode_batch(batch, engine="host", on_error=on_error)
    assert got == want
    assert hashlib.sha256(got[0]).hexdigest() == entry["wav_sha256"]


def _cs128_v3_stream() -> bytes:
    """The v3 PNS fixture's header with base_band_count 100 and one band per
    HFR group: coded_count 100 + 28 extension scalefactors = 128."""
    blob = H.load_fixtures()[1][HCA_PNS]
    hs = H.header_size(blob)
    head = bytearray(blob[:hs])
    head[35] = 100                        # base_band_count
    head[37] = 1                          # bands_per_hfr_group
    head[hs - 2:hs] = crc16(bytes(head[:hs - 2])).to_bytes(2, "big")
    return bytes(head) + blob[hs:]


def test_cs128_with_the_v3_extension_is_refused_per_stream():
    bad = _cs128_v3_stream()
    ji, pi = H.parse_both(bad)
    assert ji.hfr_group_count == 28 and int(ji.coded_count[0]) == 100
    with pytest.raises(port_frame.HcaError, match="cs_count == 128"):
        port_unpack.DeviceUnpacker(pi, device="cpu")
    with pytest.raises(port_frame.HcaError, match="cs_count == 128"):
        port.decode_batch([bad], device="cpu")
    # no defined answer in the JAX package: its Python unpacker copies
    # sf[128] and raises IndexError, its native one reads the next row
    hs = H.header_size(bad)
    with pytest.raises(IndexError):
        jax_frame._unpack_frames_py(ji, bad[hs:hs + ji.frame_size])
    good = H.load_fixtures()[1]["q2_mono_48k_1s"]
    out = port.decode_batch([bad, good], device="cpu", on_error="isolate")
    assert isinstance(out[0], port_frame.HcaError)
    assert out[1] == jax_parallel.decode_batch([good], engine="host")[0]
    with pytest.raises(port_frame.HcaError):
        port.find_key(bad, [H.KEY], device="cpu")


def test_scalefactor_count_past_128_is_an_hca_error():
    """No parsed header reaches it (coded + HFR groups <= total <= 128); a
    config that did would fail every frame in the JAX host unpacker."""
    _, pi = H.parse_both(H.load_fixtures()[1][HCA_PNS])
    pi.base_band_count = 120
    pi.hfr_group_count = 9
    pi.init_derived()
    with pytest.raises(port_frame.HcaError,
                       match=r"Unpack error \(scalefactor count\)"):
        port_unpack.DeviceUnpacker(pi, device="cpu")
