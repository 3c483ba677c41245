"""PyTorch port, HCA encoder MDCT (kernel B6's plain twin): `mdct_plain`
equals the JAX package's Pallas kernel `mdct_enc_pallas` (interpret mode)
and its XLA stage network `_mdct`, bit for bit (f32 compared as its bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycricodecs_tpu.ops import hca_encode_device as jax_enc
from pycricodecs_tpu.ops import hca_tables as jax_tables
from pycricodecs_tpu.ops import pallas_kernels
from pycricodecs_tpu_torch.ops import cuda_kernels
from pycricodecs_tpu_torch.ops import hca_encode_device as port_enc
from tests import torch_port_helpers  # noqa: F401  (one torch thread)


def _pcm(B, C, Tn, seed):
    """Random PCM16 with both rails and silent blocks."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, size=(B, C, Tn * 128), dtype=np.int16)
    pcm[0, 0, :5] = (-32768, 32767, -32768, 32767, 0)
    pcm[-1, -1, 128:256] = 0
    pcm[-1, 0, -128:] = 32767
    return pcm


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("B,C,Tn", [(1, 1, 5), (1, 2, 9), (3, 1, 11),
                                    (3, 2, 16)])
def test_mdct_plain_matches_pallas_and_xla(B, C, Tn):
    pcm = _pcm(B, C, Tn, seed=B * 10 + C)
    got = port_enc.mdct_plain(torch.from_numpy(pcm)).numpy()
    pallas = np.asarray(pallas_kernels.mdct_enc_pallas(pcm, interpret=True))
    wave = (jnp.asarray(pcm).astype(jnp.float32)
            * jnp.float32(1.0 / 32768.0)).reshape(B, C, Tn, 128)
    window = jnp.asarray(jax_tables.IMDCT_WINDOW)
    xla = np.asarray(jax.jit(lambda w: jax_enc._mdct(w, window))(wave))
    assert got.shape == (B, C, Tn, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    np.testing.assert_array_equal(_bits(got), _bits(xla))


def test_dct4_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((7, 128)) * 0.3).astype(np.float32)
    got = port_enc.dct4(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jax_enc._dct4)(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_hca_mdct_runs_the_twin_on_cpu_and_counts_no_launch():
    pcm = torch.from_numpy(_pcm(2, 2, 6, seed=4))
    before = cuda_kernels.MDCT_LAUNCHES
    got = port_enc.hca_mdct(pcm)
    assert torch.equal(got, port_enc.mdct_plain(pcm))
    assert cuda_kernels.MDCT_LAUNCHES == before


def test_mdct_kernel_wrapper_refuses_cpu_tensors():
    pcm = torch.zeros((1, 1, 256), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.hca_mdct(pcm)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_kernels.hca_mdct(torch.zeros((1, 1, 100), dtype=torch.int16))
