"""PyTorch port: the sharded entry points on a mesh of CPU devices.

`make_mesh(..., devices=["cpu"] * 8)` is the port's counterpart of the JAX
tests' eight virtual CPU devices: every shard runs the kernels' plain
PyTorch twins. Every sharded call is byte-equal to the port's meshless
call on the same input, and where a JAX reference exists, to it:
- `decode_batch` under (8, 1), (4, 2) and (1, 8) with 11 streams (an odd
  count; a keyed stream, a v3 PNS stream and a truncated stream among
  them, so the frame halo and the PNS draw offsets run under sp) against
  the JAX models.hca.decode of each stream;
- `noise_maps` with `draws_before` against the unsharded maps' rows;
- `decode_awb` / `decode_acb` with the mesh in the JAX third positional
  place against the meshless JAX call;
- ADX decode (modes 2, 3 and 4, the mode 4 probe block both ways) and
  encode under (4, 2);
- AHX decode, HCA encode and AHX encode under (8, 1) against the JAX host
  lane, `hca_encode_host.encode` and the JAX AHX host lane;
- `dryrun_multichip(8, devices=["cpu"] * 8)`.
"""
import ast
import hashlib
import os

import numpy as np
import pytest
import torch

from pycricodecs_tpu import parallel as jax_parallel
from pycricodecs_tpu.containers.acb import ACB as JaxACB
from pycricodecs_tpu.models import adx as jax_adx
from pycricodecs_tpu.models import hca as jax_hca
from pycricodecs_tpu.ops import hca_encode_host
from pycricodecs_tpu.utils.wav import write_wav
import pycricodecs_tpu_torch as port
from pycricodecs_tpu_torch import parallel
from pycricodecs_tpu_torch.containers.acb import ACB
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.ops import hca_frame, hca_unpack_device
from pycricodecs_tpu_torch.parallel import Mesh, make_mesh
from pycricodecs_tpu_torch.utils.signals import HCA_PNS
from tests import torch_port_helpers as H
from tests.conftest import make_sine_pcm16

CPU8 = ["cpu"] * 8
SHAPES = [(8, 1), (4, 2), (1, 8)]


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def mesh(shape):
    return make_mesh(shape, devices=CPU8[:int(np.prod(shape))])


# -- make_mesh -------------------------------------------------------------------

def test_make_mesh_shapes():
    m = make_mesh(devices=CPU8)
    assert isinstance(m, Mesh)
    assert m.shape == (8, 1) and (m.dp, m.sp) == (8, 1)
    assert m.axis_names == ("dp", "sp")
    assert m.devices.dtype == object
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    m = make_mesh((4, 2), devices=CPU8)
    assert m.devices.shape == (4, 2) and (m.dp, m.sp) == (4, 2)
    assert len(m.stream_devices()) == 4 and len(m.flat_devices()) == 8
    # like the JAX function, the first prod(shape) devices
    m = make_mesh((3,), ("rows",), devices=["cpu"] * 5)
    assert m.shape == (3,) and m.axis_names == ("rows",) and m.sp == 1
    m = make_mesh((2, 1), devices=["cuda:1", torch.device("cuda", 0)])
    assert list(m.devices.flat) == [torch.device("cuda", 1),
                                    torch.device("cuda", 0)]


@pytest.mark.parametrize("case", ["no_cuda", "too_few", "zero_axis",
                                  "three_axes", "unindexed_cuda",
                                  "one_name"])
def test_make_mesh_refusals(case):
    calls = {
        "no_cuda": (lambda: make_mesh((1, 1)), RuntimeError),
        "too_few": (lambda: make_mesh((4, 2), devices=["cpu"] * 7),
                    ValueError),
        "zero_axis": (lambda: make_mesh((0, 1), devices=CPU8), ValueError),
        "three_axes": (lambda: make_mesh((2, 2, 2), devices=CPU8),
                       ValueError),
        "unindexed_cuda": (lambda: make_mesh((1, 1), devices=["cuda"]),
                           ValueError),
        "one_name": (lambda: make_mesh((4, 2), ("dp",), devices=CPU8),
                     ValueError),
    }
    fn, exc = calls[case]
    if case == "no_cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(exc):
        fn()


def test_a_cuda_mesh_does_not_run_on_the_cpu():
    """A mesh of CUDA devices sends its shards there; without CUDA the
    call fails instead of decoding on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    m = make_mesh((2, 1), devices=["cuda:0", "cuda:1"])
    with pytest.raises((RuntimeError, AssertionError)):
        parallel.decode_batch([H.load_fixture("q2_mono_48k_1s")], mesh=m)


# -- the launch device ---------------------------------------------------------

def test_every_launch_goes_through_the_device_guard():
    """No kernel wrapper calls the built library but through
    cuda_kernels.launch (the plan queries excepted)."""
    ops = os.path.dirname(cuda_kernels.__file__)
    calls = []
    for name in sorted(os.listdir(ops)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ops, name)) as fh:
            tree = ast.parse(fh.read())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "load"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "_build"):
                    calls.append((name, fn.name))
    assert sorted(calls) == [("cuda_kernels.py", "_adx_plan"),
                             ("cuda_kernels.py", "launch")]


def test_launch_runs_under_the_tensor_device(monkeypatch):
    """launch makes the tensor's device current around the launcher (and
    the previous one current again after it, also when it raises), hands
    it that device's stream last, and raises on a failed launch."""
    seen = []

    class Lib:
        def kern(self, *args):
            seen.append(("call", args))
            return args[0]

    def exchange(idx):
        seen.append(("current", idx))
        return 5                         # the device current before

    def exchange_back(idx):
        seen.append(("back", idx))

    class FakeTensor:
        device = torch.device("cuda", 3)

        def get_device(self):
            return 3

    monkeypatch.setattr(cuda_kernels._build, "load", lambda: Lib())
    monkeypatch.setattr(torch._C, "_cuda_exchangeDevice", exchange,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_maybeExchangeDevice",
                        exchange_back, raising=False)
    monkeypatch.setattr(cuda_kernels, "stream_ptr",
                        lambda t: ("stream", t.device))
    cuda_kernels.launch("kern", FakeTensor(), 0, 7)
    dev = torch.device("cuda", 3)
    assert seen == [("current", 3), ("call", (0, 7, ("stream", dev))),
                    ("back", 5)]
    seen.clear()
    with pytest.raises(RuntimeError, match="kern: CUDA launch failed "
                       "with error 2"):
        cuda_kernels.launch("kern", FakeTensor(), 2)
    assert seen[-1] == ("back", 5)

    class Raises:
        def kern(self, *args):
            raise OSError("the launcher failed")

    seen.clear()
    monkeypatch.setattr(cuda_kernels._build, "load", lambda: Raises())
    with pytest.raises(OSError):
        cuda_kernels.launch("kern", FakeTensor(), 0)
    assert seen == [("current", 3), ("back", 5)]


# -- decode_batch ----------------------------------------------------------------

@pytest.fixture(scope="module")
def hca():
    """11 streams in three groups: nine plain mono streams of different
    lengths (one truncated mid-frame), a keyed one (cipher 56) and the v3
    PNS fixture; their meshless port decode and the JAX decode of each."""
    blobs = [H.encode(channels=1, samples=3000 + 700 * i, seed=i)
             for i in range(9)]
    blobs[6] = blobs[6][:-300]
    blobs.insert(4, H.encode(channels=1, samples=5000, seed=20, key=H.KEY))
    blobs.append(H.load_fixture(HCA_PNS))
    ref = port.decode_batch(blobs, H.KEY, device="cpu")
    jax = [jax_hca.decode(b, key=H.KEY) for b in blobs]
    return dict(blobs=blobs, ref=ref, jax=jax)


def test_meshless_reference_equals_jax(hca):
    assert hca["ref"] == hca["jax"]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_decode_batch_sharded_equals_meshless_and_jax(hca, shape):
    stats = port.DecodeStats()
    got = port.decode_batch(hca["blobs"], H.KEY, mesh=mesh(shape),
                            stats=stats)
    assert [sha(g) for g in got] == [sha(r) for r in hca["ref"]]
    assert got == hca["jax"]
    assert stats.device_unpack_streams == len(hca["blobs"]) == 11
    assert stats.streams == 11 and stats.groups == 3


def test_decode_batch_sharded_isolates_a_corrupt_stream(hca):
    bad = bytearray(hca["blobs"][0])
    bad[-40] ^= 0xFF                        # a frame's CRC fails
    blobs = [bytes(bad)] + hca["blobs"][1:4]
    got = port.decode_batch(blobs, mesh=mesh((2, 2)), on_error="isolate")
    assert isinstance(got[0], hca_frame.HcaError)
    assert got[1:] == hca["ref"][1:4]


def test_decode_batch_sharded_return_arrays(hca):
    got = port.decode_batch(hca["blobs"][:3], mesh=mesh((2, 2)),
                            return_arrays=True)
    want = port.decode_batch(hca["blobs"][:3], device="cpu",
                             return_arrays=True)
    for (pg, ig), (pw, iw) in zip(got, want):
        np.testing.assert_array_equal(pg, pw)
        assert ig.frame_count == iw.frame_count


# -- the PNS draw offset ------------------------------------------------------------

def test_noise_maps_with_draws_before_equal_the_unsharded_rows():
    """Two streams of the PNS fixture's config (its frames, and the same
    frames rotated) split at frame k: the maps of frames k.. with each
    stream's draws before k equal the unsharded maps' rows."""
    blob = H.load_fixture(HCA_PNS)
    info = hca_frame.parse_header(blob[:H.header_size(blob)])
    fr = H.frames_of(blob, info)
    F = fr.shape[0]
    frames = np.stack([fr, np.roll(fr, 17, axis=0)])            # [2, F, fs]
    up = hca_unpack_device.DeviceUnpacker(info, device="cpu")
    _, sf, res, _, err = up(frames.reshape(2 * F, -1))
    assert not bool(err.any())
    whole = up.noise_maps(sf, res, 2)
    draws = up.frame_draws(sf, res).view(2, F)
    assert int(draws.sum()) > 0
    for k in (1, F // 3, F - 1):
        tail = [t.view(2, F, -1)[:, k:].reshape(2 * (F - k), -1)
                for t in (sf, res)]
        part = up.noise_maps(*(t.view(2 * (F - k), info.channels, 128)
                               for t in tail), 2,
                             draws_before=draws[:, :k].sum(1))
        for w, p in zip(whole, part):
            assert torch.equal(w.view(2, F, *w.shape[1:])[:, k:],
                               p.view(2, F - k, *p.shape[1:]))
    # the default leaves the call as it was
    for a, b in zip(whole, up.noise_maps(sf, res, 2,
                                         draws_before=torch.zeros(2))):
        assert torch.equal(a, b)


# -- decode_awb / decode_acb -----------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    acb = H.load_bank_fixtures()[1]["mixed"]
    return dict(acb=acb, jax=jax_parallel.decode_awb(JaxACB(acb).awb, 0,
                                                     None))


def test_decode_awb_positional_none_and_mesh_equal_the_meshless_jax_call(
        mixed):
    awb = ACB(mixed["acb"]).awb
    assert port.decode_awb(awb, 0, None, device="cpu") == mixed["jax"]
    assert port.decode_awb(awb, 0, mesh((2, 2))) == mixed["jax"]


def test_decode_acb_mesh_in_the_third_place(mixed):
    assert port.decode_acb(mixed["acb"], 0, mesh((2, 1))) == mixed["jax"]
    with pytest.raises(TypeError):
        port.decode_acb(mixed["acb"], 0, "cpu")


@pytest.mark.parametrize("third", [False, True, 0, "cpu"], ids=repr)
def test_decode_awb_third_argument_not_a_mesh_raises(mixed, third):
    with pytest.raises(TypeError):
        port.decode_awb(ACB(mixed["acb"]).awb, 0, third, device="cpu")


# -- ADX ---------------------------------------------------------------------------------

def _adx_streams():
    """Short ADX streams of modes 2, 3 and 4 (one mono), and the mode 4
    stream with block 20 of channel 0 given the scale word 13 (2^31) and
    first codes 1, 1: there the two arithmetics differ."""
    w2 = H.wav(samples=1500, channels=2, seed=3)
    w1 = H.wav(samples=1100, channels=1, seed=4)
    out = {"m2": jax_adx.encode(w2, encoding_mode=2, filter_=2),
           "m3": jax_adx.encode(w2),
           "m3_mono": jax_adx.encode(w1, bit_depth=5, block_size=12),
           "m4": jax_adx.encode(w2, encoding_mode=4)}
    d = bytearray(out["m4"])
    h = jax_adx.parse_adx_header(bytes(d))
    off = h.data_offset + 4 + 20 * 2 * 18
    d[off:off + 3] = b"\x00\x0d\x11"
    out["m4_probe"] = bytes(d)
    return out


@pytest.mark.parametrize("wrap", [False, True], ids=["host", "wrap"])
def test_adx_decode_sharded_equals_meshless(wrap):
    streams = _adx_streams()
    blobs = list(streams.values())
    want = port.adx_decode_batch(blobs, device="cpu", wrap=wrap)
    got = port.adx_decode_batch(blobs, mesh=mesh((4, 2)), wrap=wrap)
    assert got == want
    probe = list(streams).index("m4_probe")
    jax_want = (jax_parallel.adx_decode_batch([blobs[probe]], device=True)
                if wrap else [jax_adx.decode(blobs[probe])])
    assert got[probe] == jax_want[0]
    if not wrap:
        assert got == [jax_adx.decode(b) for b in blobs]


def test_adx_probe_block_differs_between_the_arithmetics():
    probe = _adx_streams()["m4_probe"]
    m = mesh((4, 2))
    host = port.adx_decode_batch([probe], mesh=m)[0]
    wrap = port.adx_decode_batch([probe], mesh=m, wrap=True)[0]
    assert host != wrap


@pytest.mark.parametrize("kw", [{}, dict(encoding_mode=2, filter_=1),
                                dict(encoding_mode=4, bit_depth=5,
                                     block_size=12)],
                         ids=["m3", "m2", "m4_bd5"])
def test_adx_encode_sharded_equals_meshless(kw):
    wavs = [H.wav(samples=900 + 300 * i, channels=1 + i % 2, seed=i)
            for i in range(5)]
    want = port.adx_encode_batch(wavs, device="cpu", **kw)
    assert port.adx_encode_batch(wavs, mesh=mesh((4, 2)), **kw) == want
    assert want == [jax_adx.encode(w, **kw) for w in wavs]


# -- AHX decode, HCA encode, AHX encode over the stream axis ------------------------

def test_ahx_decode_sharded_equals_meshless_and_the_jax_host_lane():
    _, fx = H.load_ahx_fixtures()
    blobs = [fx[n] for n in ("ahx11_lsf_mono_22k_1s", "mp2_stereo_44k_192k_1s",
                             "ahx10_lsf_mono_16k_1s",
                             "mp2_vbr_lsf_mono_22k_1s",
                             "mp2_joint8_44k_192k_1s")]
    got = port.ahx_decode_batch(blobs, mesh=mesh((8, 1)))
    assert got == port.ahx_decode_batch(blobs, device="cpu")
    assert got == jax_parallel.ahx_decode_batch(blobs, device=False)


def test_ahx_decode_sharded_isolates_a_truncated_stream():
    _, fx = H.load_ahx_fixtures()
    good = fx["ahx11_lsf_mono_22k_1s"]
    cut = bytearray(good)
    hdr = 0x24
    cut[hdr + 300:] = bytes(len(cut) - hdr - 300)   # zeroed past a frame
    blobs = [good, bytes(cut), good]
    want = port.ahx_decode_batch(blobs, device="cpu", on_error="isolate")
    assert port.ahx_decode_batch(blobs, mesh=mesh((8, 1)),
                                 on_error="isolate") == want


def _hca_wavs():
    return [write_wav(make_sine_pcm16(6000 + 1000 * i, 2, 48000, seed=i), 2,
                      48000) for i in range(5)]


def test_hca_encode_sharded_equals_meshless_and_the_jax_host_encoder():
    wavs = _hca_wavs() + [write_wav(make_sine_pcm16(5000, 1, 48000, seed=7),
                                    1, 48000)]
    got = port.hca_encode_batch(wavs, 2, mesh=mesh((8, 1)))
    assert got == port.hca_encode_batch(wavs, 2, device="cpu")
    assert got == [hca_encode_host.encode(w, quality=2) for w in wavs]


def test_ahx_encode_sharded_equals_meshless_and_the_jax_host_lane():
    wavs = [write_wav(make_sine_pcm16(8000 + 1500 * i, 1, 22050, seed=i), 1,
                      22050) for i in range(4)]
    wavs.append(write_wav(make_sine_pcm16(9000, 2, 44100, seed=9), 2, 44100))
    got = port.ahx_encode_batch(wavs, 96, mesh=mesh((8, 1)))
    assert got == port.ahx_encode_batch(wavs, 96, device="cpu")
    assert got == jax_parallel.ahx_encode_batch(wavs, 96)


# -- dryrun_multichip -----------------------------------------------------------------------

def test_dryrun_multichip_on_eight_cpu_devices(capsys):
    import __graft_entry_torch__ as graft
    graft.dryrun_multichip(8, devices=CPU8)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh=(4, 2)" in out
    assert "17 HCA + 9 AHX + 9 ADX streams decoded" in out


def test_dryrun_multichip_refuses_without_devices():
    import __graft_entry_torch__ as graft
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError):
        graft.dryrun_multichip(2)
    with pytest.raises(ValueError):
        graft.dryrun_multichip(4, devices=["cpu"] * 3)
