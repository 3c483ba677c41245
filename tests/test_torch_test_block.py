"""PyTorch port, the single-frame key test: `ops.hca_frame.test_block` and
`test_block_state` on the CPU (kernels B1, B2 and B4 through their twins)
give the JAX package's (score, noise state) frame by frame, threaded, on
every HCA fixture and on the enciphered bank stream under its key and
wrong keys; `score_frames` gives the same fold over every frame in one
pass. Silent, bad-sync, bad-CRC, short and long frames score as in the JAX
package, before any launch, and leave the state as it was. The port's
`score_key` equals the fold of its `test_block_state`, as the JAX
`score_key` is that fold.
"""
import pytest

from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_frame as jax_frame
from pycricodecs_tpu_torch.ops import hca_frame as port_frame
from pycricodecs_tpu_torch.parallel import pipeline as port_pipeline
from tests import torch_port_helpers as H

NAMES = sorted(H.load_fixtures()[0])
BANK = "bank_q2_stereo_48k_10s"
WRONG_KEYS = (H.KEY + 1, 1, 0xDEADBEEF)
# frames threaded one call at a time (the rest through score_frames)
PER_FRAME = 4


def _frames(blob, info):
    hs, fs = H.header_size(blob), info.frame_size
    return [blob[hs + f * fs:hs + (f + 1) * fs]
            for f in range(info.frame_count)]


def _fold(mod, info, frames, state, **kw):
    """[(score, state after the frame)] of test_block_state threaded."""
    out = []
    for frame in frames:
        score, state = mod.test_block_state(info, frame, state, **kw)
        out.append((score, state))
    return out


def _score_frames(info, frames, state):
    scores, states = port_frame.score_frames(info, b"".join(frames), state,
                                             device="cpu")
    return list(zip(scores.tolist(), states.tolist()))


@pytest.fixture(scope="module")
def enciphered():
    plain = H.load_fixture(BANK)
    return jax_hca.crypt(plain, True, H.header_size(plain), 56, H.KEY)


@pytest.mark.parametrize("name", NAMES)
def test_every_frame_threaded_matches_jax(name):
    blob = H.load_fixture(name)
    ji, pi = H.parse_both(blob)
    frames = _frames(blob, ji)
    for state in (1, 0x1234) if pi.min_resolution == 0 else (1,):
        ref = _fold(jax_frame, ji, frames, state)
        assert _score_frames(pi, frames, state) == ref
        assert _fold(port_frame, pi, frames[:PER_FRAME], state,
                     device="cpu") == ref[:PER_FRAME]
    assert {s for s, _ in ref} & {1}, "no frame decoded cleanly"


def test_pns_frames_advance_the_noise_state():
    blob = H.load_fixture("pns_v3_mono_48k_1s")
    _, pi = H.parse_both(blob)
    got = _score_frames(pi, _frames(blob, pi), 1)
    assert got[0][1] != 1          # the first clean frame drew noise


@pytest.mark.parametrize("key", (H.KEY,) + WRONG_KEYS)
def test_enciphered_stream_under_true_and_wrong_keys(enciphered, key):
    ji, pi = H.parse_both(enciphered, key)
    frames = _frames(enciphered, ji)
    ref = _fold(jax_frame, ji, frames, 1)
    assert _score_frames(pi, frames, 1) == ref
    assert _fold(port_frame, pi, frames[:PER_FRAME], 1,
                 device="cpu") == ref[:PER_FRAME]
    scores = {s for s, _ in ref}
    if key == H.KEY:
        assert scores == {1}
    else:
        assert scores <= {-1, -6}


def _edge_frames(blob, info):
    """name -> frame bytes: silent, bad sync, bad CRC, cut short, one too
    long, empty."""
    good = _frames(blob, info)[3]
    fs = info.frame_size
    flip = bytearray(good)
    flip[fs // 2] ^= 0x01
    silent = bytearray(fs)
    silent[:2] = b"\xff\xff"
    silent[-2:] = b"\x12\x34"                  # the CRC slot is not body
    return {"silent": bytes(silent), "zero": bytes(fs),
            "bad_sync": b"\xff\x7f" + good[2:], "bad_crc": bytes(flip),
            "short10": good[:10], "short2": good[:2], "empty": b"",
            "long": good + b"\x01\x02\x03", "good": good}


@pytest.mark.parametrize("name", ["pns_v3_mono_48k_1s", "q4_stereo_48k_1s"])
def test_edge_frames_score_as_in_jax(name):
    blob = H.load_fixture(name)
    ji, pi = H.parse_both(blob)
    for what, frame in _edge_frames(blob, ji).items():
        for state in (1, 0xABCDEF):
            ref = jax_frame.test_block_state(ji, frame, state)
            got = port_frame.test_block_state(pi, frame, state,
                                              device="cpu")
            assert got == ref, what
            assert port_frame.test_block(pi, frame, state,
                                         device="cpu") == ref[0]
            if what not in ("good", "long"):
                assert got[1] == state, what   # early returns keep it


def _fold_score_key(data, keycode, subkey=0, max_frames=16):
    """The JAX score_key's fold, over the port's test_block_state."""
    hs = H.header_size(data)
    info = port_frame.parse_header(data[:hs])
    info.set_key(port_frame.hca_crypt.scramble_subkey(keycode, subkey))
    total = tested = 0
    state = 1
    for f in range(min(max_frames, info.frame_count)):
        off = hs + f * info.frame_size
        frame = data[off:off + info.frame_size]
        if len(frame) < info.frame_size:
            break
        score, state = port_frame.test_block_state(info, frame, state,
                                                   device="cpu")
        if score < 0:
            return -1
        total += score
        tested += 1
    return total if tested else -1


@pytest.mark.parametrize("case", ["true_key", "wrong_key", "pns_plain",
                                  "cut"])
def test_score_key_is_the_fold_of_test_block_state(enciphered, case):
    fs = H.parse_both(enciphered)[1].frame_size
    data, key = {
        "true_key": (enciphered, H.KEY),
        "wrong_key": (enciphered, WRONG_KEYS[0]),
        "pns_plain": (H.load_fixture("pns_v3_mono_48k_1s"), 0),
        # 3 whole frames and a cut fourth: the fold stops at the cut
        "cut": (enciphered[:H.header_size(enciphered) + 3 * fs + 100],
                H.KEY),
    }[case]
    max_frames = 8
    want = jax_frame.score_key(data, key, max_frames=max_frames)
    assert _fold_score_key(data, key, max_frames=max_frames) == want
    assert port_pipeline.score_key(data, key, max_frames=max_frames,
                                   device="cpu") == want
