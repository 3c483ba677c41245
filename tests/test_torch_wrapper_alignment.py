"""PyTorch port: the kernel wrappers refuse a misaligned input before any
launch, with a ValueError that names the input.

`mp2_synth` reads codes as 32-bit pairs, levels as int2 and sfidx as
16-bit pairs (8-byte alignment asked of all three), B6 `hca_mdct` stages
PCM with 16-byte copies, B10 `mp2_unpack` stages frames with 16-byte
copies from 16-byte boundaries. A view one element into a tensor is off
those boundaries; the check runs before the device check, so it shows on
CPU tensors too, and no launch is counted.

Tolerance: exact (the error and the unchanged launch counts).
"""
import pytest
import torch

from pycricodecs_tpu_torch.ops import cuda_kernels as K


def _counts():
    return (K.MP2_SYNTH_LAUNCHES, K.MDCT_LAUNCHES, K.MP2_UNPACK_LAUNCHES)


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
