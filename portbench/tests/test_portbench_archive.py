"""The banks: each configuration's layout is its stream's own header, the
streams are the repo's committed fixtures, and the members are the
stream's frames rotated, deterministic per seed, the same sizes for
every seed."""
import hashlib
import struct

import pytest

from portbench import archive
from portbench.run import CHECKOUT, load_json

CONFIGS = ["adx_bank_cpk", "hca_bank_cpk"]
FIXTURES = {"adx_bank_cpk":
            "tests/data/torch_port/adx/adx_m3_bd4_stereo_48k_10s.adx",
            "hca_bank_cpk": "tests/data/torch_port/bank_q2_stereo_48k_10s.hca"}


def config(name):
    return load_json(CHECKOUT / f"portbench/configs/{name}.json")


def header_layout(codec: str, data: bytes) -> tuple:
    """(data offset, frame bytes, frames) read from the stream's header."""
    if codec == "adx":
        assert data[:2] == b"\x80\x00" and data[4] == 3  # mode 3
        offset = struct.unpack(">H", data[2:4])[0] + 4
        block, depth, channels = data[5], data[6], data[7]
        assert (block, depth) == (0x12, 4)
        samples = struct.unpack(">I", data[12:16])[0]
        return offset, block * channels, -(-samples // 32)
    assert data[:4] == b"HCA\x00"
    offset = struct.unpack(">H", data[6:8])[0]
    fmt = data.index(b"fmt\x00")
    frames = struct.unpack(">I", data[fmt + 8:fmt + 12])[0]
    comp = data.index(b"comp")
    return offset, struct.unpack(">H", data[comp + 4:comp + 6])[0], frames


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_is_the_streams_header(name):
    c = config(name)
    data = archive.stream(c)
    s = c["stream"]
    assert header_layout(s["codec"], data) == (
        s["data_offset"], s["frame_bytes"], s["frames"])
    end = s["data_offset"] + s["frames"] * s["frame_bytes"]
    # ADX keeps its end block (scale 0x8001) after the frames; HCA none
    assert data[end:end + 2] == (b"\x80\x01" if s["codec"] == "adx"
                                 else b"")


@pytest.mark.parametrize("name", CONFIGS)
def test_stream_is_the_committed_fixture(name):
    ours = archive.stream(config(name))
    fixture = (CHECKOUT / FIXTURES[name]).read_bytes()
    assert hashlib.sha256(ours).digest() == hashlib.sha256(fixture).digest()


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**32 + 7])
def test_members_are_deterministic_per_seed(small, seed):
    a = archive.make_members(small, seed)
    b = archive.make_members(small, seed)
    assert a == b and len(a) == small["streams"]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_member_is_the_stream_with_its_frames_rotated(name):
    c = config(name)
    s = c["stream"]
    data = archive.stream(c)
    lo = s["data_offset"]
    hi = lo + s["frames"] * s["frame_bytes"]
    frames = sorted(data[i:i + s["frame_bytes"]]
                    for i in range(lo, hi, s["frame_bytes"]))
    members = archive.make_members(c, 2**31 + 99)
    assert len(members) == c["streams"] == 256
    for m, k in zip(members[:8], archive.rotations(c, 2**31 + 99)):
        assert len(m) == len(data)
        assert m[:lo] == data[:lo] and m[hi:] == data[hi:]
        cut = lo + k * s["frame_bytes"]
        assert m[lo:hi] == data[cut:hi] + data[lo:cut]
        assert sorted(m[i:i + s["frame_bytes"]]
                      for i in range(lo, hi, s["frame_bytes"])) == frames


def test_seeds_draw_other_rotations_of_the_same_sizes():
    c = config("adx_bank_cpk")
    a, b = archive.make_members(c, 1), archive.make_members(c, 2)
    assert list(map(len, a)) == list(map(len, b))
    assert sum(x != y for x, y in zip(a, b)) >= 250


def test_members_of_a_bank_differ():
    members = archive.make_members(config("hca_bank_cpk"), 2**31 + 3)
    assert len(set(members)) == len(members) == 256
