"""PyTorch port: the kernel wrappers refuse a misaligned input before any
launch, with a ValueError that names the input.

`mp2_synth` reads codes as 32-bit pairs, levels as int2 and sfidx as
16-bit pairs (8-byte alignment asked of all three), B6 `hca_mdct` stages
PCM with 16-byte copies, B10 `mp2_unpack` stages frames with 16-byte
copies from 16-byte boundaries; of the Layer II encoder's kernels, K1
`mp2_analysis` (which now gives the peaks beside the spectra) stages PCM
in 16-byte chunks, K2 `mp2_allocate` streams S through its rings with
16-byte copies and K3 `mp2_pack` stages a frame's codes and side info
(alloc, scfsi, sfidx) with 16-byte copies. A view one element into a
tensor is off those boundaries; the check runs before the device check,
so it shows on CPU tensors too, and no launch is counted.

Tolerance: exact (the error and the unchanged launch counts).
"""
import pytest
import torch

from pycricodecs_tpu_torch.ops import cuda_kernels as K


def _counts():
    return (K.MP2_SYNTH_LAUNCHES, K.MDCT_LAUNCHES, K.MP2_UNPACK_LAUNCHES,
            K.MP2_ANALYSIS_LAUNCHES, K.MP2_ALLOCATE_LAUNCHES,
            K.MP2_PACK_LAUNCHES)


def _synth_inputs(off):
    codes = torch.zeros(1 * 2 * 1 * 36 * 32 + 1, dtype=torch.uint16)
    levels = torch.zeros(1 * 2 * 1 * 32 + 1, dtype=torch.int32)
    sfidx = torch.zeros(1 * 2 * 1 * 3 * 32 + 1, dtype=torch.uint8)
    views = [codes[:-1], levels[:-1], sfidx[:-1]]
    i = ("codes", "levels", "sfidx").index(off)
    views[i] = (codes, levels, sfidx)[i][1:]
    return (views[0].view(1, 2, 1, 36, 32), views[1].view(1, 2, 1, 32),
            views[2].view(1, 2, 1, 3, 32))


@pytest.mark.parametrize("name", ["codes", "levels", "sfidx"])
def test_mp2_synth_refuses_a_misaligned_input(name):
    before = _counts()
    with pytest.raises(ValueError, match=f"{name}: data is not 8-byte"):
        K.mp2_synth(*_synth_inputs(name))
    assert _counts() == before


def test_mdct_and_unpack_refuse_misaligned_inputs():
    before = _counts()
    pcm = torch.zeros(2 * 256 + 1, dtype=torch.int16)[1:].view(1, 2, 256)
    with pytest.raises(ValueError, match="pcm: data is not 16-byte"):
        K.hca_mdct(pcm)
    frames = torch.zeros(2 * 700 + 1, dtype=torch.uint8)[1:].view(2, 700)
    with pytest.raises(ValueError, match="frames: data is not 16-byte"):
        K.mp2_unpack(frames, 1)
    assert _counts() == before


def test_mp2_analysis_refuses_misaligned_pcm():
    before = _counts()
    pcm = torch.zeros(2 * 1152 + 1, dtype=torch.int16)[1:].view(1, 2, 1152)
    with pytest.raises(ValueError, match="pcm: data is not 16-byte"):
        K.mp2_analysis(pcm)
    assert _counts() == before


@pytest.mark.parametrize("encode_pass", ["peaks", "allocate"])
def test_mp2_allocate_refuses_misaligned_spectra(encode_pass):
    """"peaks": the peaks come from K1, whose PCM (two stereo frames here)
    it stages in 16-byte chunks, in a view 8 bytes in (8-byte aligned, so
    an 8-byte check would let it through; the case above is 2 bytes in);
    "allocate": K2's S."""
    before = _counts()
    if encode_pass == "peaks":
        pcm = torch.zeros(2 * 2304 + 4, dtype=torch.int16)[4:].view(
            1, 2, 2304)
        assert pcm.data_ptr() % 16 == 8
        with pytest.raises(ValueError, match="pcm: data is not 16-byte"):
            K.mp2_analysis(pcm)
    else:
        S = torch.zeros(2 * 36 * 32 + 1, dtype=torch.float64)[1:].view(
            1, 2, 36, 32)
        with pytest.raises(ValueError, match="S: data is not 16-byte"):
            K.mp2_allocate(S, torch.zeros((1, 1, 2, 3, 32),
                                          dtype=torch.float64),
                           torch.zeros((1, 1, 2, 32), dtype=torch.float64),
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1088, dtype=torch.int32),
                           torch.zeros(512, dtype=torch.float64), sblimit=30,
                           bound=8, joint=True)
    assert _counts() == before


def test_mp2_pack_refuses_misaligned_codes():
    before = _counts()
    u8 = lambda *shape: torch.zeros(shape, dtype=torch.uint8)  # noqa: E731
    codes = torch.zeros(2 * 36 * 32 + 1, dtype=torch.uint16)[1:].view(
        1, 1, 2, 36, 32)
    with pytest.raises(ValueError, match="codes: data is not 16-byte"):
        K.mp2_pack(u8(1, 1, 2, 32), u8(1, 1, 2, 32), u8(1, 1, 2, 3, 32),
                   codes, torch.zeros(1, dtype=torch.int32),
                   torch.tensor([0, 626]), torch.zeros(1568, dtype=torch.int32),
                   sblimit=30, bound=30, header_base=0xFFF5A0C0, total=626,
                   max_frame=626)
    assert _counts() == before


@pytest.mark.parametrize("name", ["alloc", "scfsi", "sfidx"])
def test_mp2_pack_refuses_misaligned_side_info(name):
    before = _counts()
    shapes = {"alloc": (1, 1, 2, 32), "scfsi": (1, 1, 2, 32),
              "sfidx": (1, 1, 2, 3, 32)}
    side = {k: torch.zeros(v, dtype=torch.uint8) for k, v in shapes.items()}
    n = side[name].numel()
    side[name] = torch.zeros(n + 1, dtype=torch.uint8)[1:].view(shapes[name])
    with pytest.raises(ValueError, match=f"{name}: data is not 16-byte"):
        K.mp2_pack(side["alloc"], side["scfsi"], side["sfidx"],
                   torch.zeros((1, 1, 2, 36, 32), dtype=torch.uint16),
                   torch.zeros(1, dtype=torch.int32),
                   torch.tensor([0, 626]), torch.zeros(1568, dtype=torch.int32),
                   sblimit=30, bound=30, header_base=0xFFF5A0C0, total=626,
                   max_frame=626)
    assert _counts() == before
