"""The plain reference against the port's CPU path on small members: the
greedy compressor gives the port's blobs, the judge accepts them, the
decoder gives the members back."""
import pytest
import torch

from portbench import reference as R
from portbench.run import CHECKOUT

#: (stream, offset, size): pieces of the benchmark's real streams
PIECES = [("adx_m3_bd4_stereo_48k_10s.adx", 48, 257),
          ("adx_m3_bd4_stereo_48k_10s.adx", 1000, 700),
          ("adx_m3_bd4_stereo_48k_10s.adx", 50000, 2600),
          ("adx_m3_bd4_stereo_48k_10s.adx", 200000, 20000),
          ("bank_q2_stereo_48k_10s.hca", 0, 257),
          ("bank_q2_stereo_48k_10s.hca", 5000, 700),
          ("bank_q2_stereo_48k_10s.hca", 100000, 2600),
          ("bank_q2_stereo_48k_10s.hca", 0, 12000)]


def members():
    out = [(CHECKOUT / "portbench/streams" / f).read_bytes()[at:at + n]
           for f, at, n in PIECES]
    # a long copy, a copy whose length runs into bytes of 255, a period
    out += [bytes(3000), bytes([7]) * 20000, (b"abcdefgh" * 400)[:3000],
            bytes(range(200))]
    return out


@pytest.fixture(scope="module")
def pair():
    from pycricodecs_tpu_torch.models import crilayla
    datas = members()
    return datas, crilayla.compress_members(datas, device="cpu")


def test_plain_compressor_gives_the_ports_blobs(pair):
    datas, port = pair
    assert R.compress_plain(datas) == port


def test_judge_accepts_the_ports_blobs(pair):
    datas, port = pair
    assert all(R.verify_compress(datas, port))


def test_plain_decoder_gives_the_members(pair):
    from pycricodecs_tpu_torch.models import crilayla
    datas, port = pair
    kept = [b for b in port if b is not None]
    assert R.decompress_plain(kept) == crilayla.decompress_batch(
        kept, device="cpu")
    assert R.decompress_plain(kept) == [d for d, b in zip(datas, port)
                                        if b is not None]


def test_refusals_are_judged(pair):
    datas, port = pair
    assert port[-1] is None                    # 200 bytes: refused
    blobs = list(port)
    blobs[0] = None                            # a refusal it must not make
    ok = R.verify_compress(datas, blobs)
    assert ok[0] is False and all(ok[1:])


@pytest.mark.parametrize("where", ["header", "stream", "prefix", "tail"])
def test_judge_flags_an_altered_byte(pair, where):
    datas, port = pair
    i = 2                                      # 2,600 bytes of ADX
    b = bytearray(port[i])
    cs = int.from_bytes(b[12:16], "little")
    at = {"header": 9, "stream": 16 + cs - 5, "prefix": -3,
          "tail": 16 + cs // 2}[where]
    b[at] ^= 0x10
    blobs = list(port)
    blobs[i] = bytes(b)
    ok = R.verify_compress(datas, blobs)
    assert ok[i] is False and ok[:i] + ok[i + 1:] == [True] * (len(ok) - 1)


def test_judge_flags_a_valid_but_not_greedy_blob():
    # a 600-byte block repeated 5,000 bytes above: only candidates past
    # 0x1002 find it, so half the window writes literals there instead
    g = torch.Generator().manual_seed(9)
    block = torch.randint(0, 256, (600,), generator=g,
                          dtype=torch.uint8).numpy().tobytes()
    filler = torch.randint(0, 256, (4400,), generator=g,
                           dtype=torch.uint8).numpy().tobytes()
    data = bytes(300) + block + filler + block
    half = R.compress_plain([data], window=0x1000)
    full = R.compress_plain([data])
    assert half != full
    assert R.decompress_plain(half) == [data]  # a valid encoding
    assert R.verify_compress([data], half) == [False]
    assert R.verify_compress([data], full) == [True]
