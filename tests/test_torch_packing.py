"""Port packing (llm_mixed_q_torch.kernels.packing) against the JAX
package's: the packed buffers are byte-identical and unpack to the same
values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_torch.kernels import packing as tp

RNG = np.random.default_rng(1)


def _w(shape, scale=0.05):
    w = (RNG.standard_normal(shape) * scale).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    w[1, :32] = 0.0  # all-zero blocks take the tensor-wide nonzero-min fill
    return w


def _bytes_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a))
    b = np.ascontiguousarray(b.numpy())
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("k,k_stride", [(1100, None), (1100, 1024), (48, None)])
@pytest.mark.parametrize("width", [4, 6, 8])
def test_pack_block_fp_bytes(k, k_stride, width):
    w = _w((24, k))
    a = jp.pack_block_fp(jnp.asarray(w), width, 8, None, [1, 16], k_stride=k_stride)
    b = tp.pack_block_fp(torch.from_numpy(w), width, 8, None, [1, 16], k_stride=k_stride)
    _bytes_equal(a.codes, b.codes)
    _bytes_equal(a.scales, b.scales)
    assert tuple(a[2:]) == tuple(b[2:])
    _bytes_equal(jp.unpack_block_fp(a), tp.unpack_block_fp(b))
    assert tp.packed_nbytes(b) == jp.packed_nbytes(a)


@pytest.mark.parametrize("k", [640, 1100])
@pytest.mark.parametrize("width", [3, 4, 6])
def test_pack_subbyte_and_transposed_bytes(k, width):
    w = _w((16, k))
    a = jp.pack_block_fp_subbyte(jnp.asarray(w), width, 8, None, [1, 16])
    b = tp.pack_block_fp_subbyte(torch.from_numpy(w), width, 8, None, [1, 16])
    _bytes_equal(a.words, b.words)
    _bytes_equal(a.scales, b.scales)
    _bytes_equal(jp.unpack_block_fp_subbyte(a), tp.unpack_block_fp_subbyte(b))
    at, bt = jp.transpose_subbyte(a), tp.transpose_subbyte(b)
    _bytes_equal(at.words, bt.words)
    _bytes_equal(at.scales, bt.scales)
    _bytes_equal(jp.unpack_block_fp_subbyte_t(at), tp.unpack_block_fp_subbyte_t(bt))
    assert tp.packed_nbytes(bt) == jp.packed_nbytes(at)


def test_bfp_encode_decode_lastdim_bytes():
    x = RNG.standard_normal((2, 3, 5, 128)).astype(np.float32)
    a = jp.bfp_encode_lastdim(jnp.asarray(x), 6, 8, None, 16)
    b = tp.bfp_encode_lastdim(torch.from_numpy(x), 6, 8, None, 16)
    _bytes_equal(a[0], b[0])
    _bytes_equal(a[1], b[1])
    _bytes_equal(jp.bfp_decode_lastdim(*a, 16), tp.bfp_decode_lastdim(*b, 16))


def test_scale_e8_round_trip():
    # normal powers of two (XLA:CPU flushes subnormal inputs to zero)
    e = np.arange(-126, 128, dtype=np.int32)
    scales = np.ldexp(np.float32(1.0), e).astype(np.float32)
    scales[:3] = 0.0
    _bytes_equal(jp.scale_to_e8(jnp.asarray(scales)),
                 tp.scale_to_e8(torch.from_numpy(scales)))
    e8 = np.arange(256, dtype=np.uint8)
    _bytes_equal(jp.scale_from_e8(jnp.asarray(e8)), tp.scale_from_e8(torch.from_numpy(e8)))
    assert tp.effective_block_len([1, 16], 8) == 8
    assert tp.effective_block_len([4, 16], 64) is None
