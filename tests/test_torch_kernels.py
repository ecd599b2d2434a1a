"""Plain versions of the port's kernels against the JAX kernels in Pallas
interpret mode, on the same numpy inputs.

On a CPU tensor each kernel wrapper computes its plain version and counts
no launch; the CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.

Tolerances are the JAX package's own: 1e-4 for the matmuls
(tests/test_kernels.py: float32 sums in another order), rtol 2e-4 / atol
2e-5 for decode attention (tests/test_attention_kernel.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import attention_decode as jattn
from llm_mixed_q_tpu.kernels import dequant_matmul as jmm
from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_tpu.ops.quantizers import _block_fp_qdq as _jax_qdq
from llm_mixed_q_torch import kernels as tk
from llm_mixed_q_torch.kernels import attention_decode as tattn
from llm_mixed_q_torch.kernels import packing as tp
from llm_mixed_q_torch.kernels.dequant_matmul import bfp_matmul, bfp_matmul_plain

RNG = np.random.default_rng(2)
ACTQ = (16, 6, 8, 127)


def _w(shape):
    w = (RNG.standard_normal(shape) * 0.05).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    return w


def _pack_both(fmt, w, width=6):
    if fmt == "int8":
        return (jp.pack_block_fp(jnp.asarray(w), width, 8, None, [1, 16]),
                tp.pack_block_fp(torch.from_numpy(w), width, 8, None, [1, 16]))
    j = jp.pack_block_fp_subbyte(jnp.asarray(w), width, 8, None, [1, 16])
    t = tp.pack_block_fp_subbyte(torch.from_numpy(w), width, 8, None, [1, 16])
    if fmt == "subbyte_t":
        return jp.transpose_subbyte(j), tp.transpose_subbyte(t)
    return j, t


# the lane-major sub-byte cases (K3) cover widths 4, 5 and 6 (tiles of 1024,
# 768 and 640), K short of a whole tile (1344 = 2.1 tiles at width 6) and N
# not a multiple of the CUDA kernel's 32-column block
@pytest.mark.parametrize("fmt,width,m,n,k", [("int8", 6, 5, 32, 704),
                                              ("subbyte_t", 6, 8, 48, 704),
                                              ("subbyte", 6, 8, 48, 256),
                                              ("subbyte", 6, 3, 45, 1344),
                                              ("subbyte", 5, 8, 40, 700),
                                              ("subbyte", 4, 5, 33, 1100)])
@pytest.mark.parametrize("actq", [None, ACTQ])
def test_matmul_plain_matches_jax_kernel(fmt, width, m, n, k, actq):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    if actq is None:  # as in the pipeline: activations arrive quantized
        x = np.asarray(_jax_qdq(jnp.asarray(x), 6, 8, None, [1, 16], True))
    jpk, tpk = _pack_both(fmt, _w((n, k)), width)
    want = np.asarray(jmm.bfp_matmul(jnp.asarray(x), jpk, use_pallas=True,
                                     interpret=True, actq=actq))
    tk.reset_launch_counts()
    got = bfp_matmul(torch.from_numpy(x), tpk, actq=actq).numpy()
    assert sum(tk.launch_counts().values()) == 0  # CPU: plain version, no launch
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        got, bfp_matmul_plain(torch.from_numpy(x), tpk, actq).numpy())


def test_matmul_large_m_takes_unpack_path():
    x = RNG.standard_normal((300, 64)).astype(np.float32)
    jpk, tpk = _pack_both("int8", _w((16, 64)))
    want = np.asarray(jmm.bfp_matmul(jnp.asarray(x), jpk, actq=ACTQ))
    got = bfp_matmul(torch.from_numpy(x), tpk, actq=ACTQ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# The premise of K1's tensor-core design: its bf16 operands are exact.

@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8])
def test_subbyte_t_weights_are_bf16_exact(width):
    """code * 2^e has at most 8 significant bits for every scale exponent
    e in [-126, 127] (scale bytes 2..255), so dequantizing to bf16 loses
    nothing (2^127 times a code of 2 or more is inf in both)."""
    w = torch.from_numpy(_w((48, 700)))
    packed = tp.pack_block_fp_subbyte_t(w, width, 8, None, [1, 16])
    e8 = torch.from_numpy(RNG.integers(2, 256, packed.scales.shape).astype(np.uint8))
    e8.view(-1)[::5] = 2
    e8.view(-1)[1::5] = 255
    packed = packed._replace(scales=e8)
    want = tp.unpack(packed)
    got = tp.unpack(packed, torch.bfloat16).float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8, 9])
def test_block_fp_activations_are_bf16_exact(width):
    """block_fp at data_in width <= 9 (exponent width 8) leaves at most 8
    significant bits in every element it quantizes (|x| > 1e-8), so it
    survives bf16; elements it passes through come back unchanged, so K1
    carries their bf16 remainder. Row 3's blocks sit below 2^-127: their
    exponent is clipped at -bias and every element passes through."""
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq

    x = RNG.standard_normal((16, 256)) * np.exp2(RNG.integers(-20, 20, (16, 1)))
    x[3] = RNG.integers(-63, 64, 256) * 2.0**-133  # bf16 subnormals
    x = torch.from_numpy(x.astype(np.float32))
    q = _block_fp_qdq(x, width, 8, None, [1, 16], True)
    quantized = x.abs() > 1e-8
    assert not quantized[3].any() and quantized.float().mean() > 0.9
    assert torch.equal(q[~quantized], x[~quantized])
    assert torch.equal(q[quantized].to(torch.bfloat16).float(), q[quantized])
    assert torch.equal(q[3].to(torch.bfloat16).float(), q[3])


def _cache(b, nkv, s_len, hd, pos_major):
    k = RNG.standard_normal((b, nkv, s_len, hd)).astype(np.float32)
    v = RNG.standard_normal((b, nkv, s_len, hd)).astype(np.float32)
    kc, ks = jp.bfp_encode_lastdim(jnp.asarray(k), 6, 8, None, 16)
    vc, vs = jp.bfp_encode_lastdim(jnp.asarray(v), 6, 8, None, 16)
    if pos_major:
        flat = lambda t: np.asarray(t).transpose(0, 3, 2, 1).reshape(b, t.shape[3], s_len * nkv)
        arrs = [flat(kc), flat(ks), flat(vc), flat(vs)]
    else:
        arrs = [np.asarray(kc).transpose(0, 1, 3, 2), np.asarray(ks).transpose(0, 1, 3, 2),
                np.asarray(vc), np.asarray(vs)]
    return [np.ascontiguousarray(a) for a in arrs]


def _q(b, nh, hd):
    q = RNG.standard_normal((b * nh, hd)).astype(np.float32)
    return np.asarray(_jax_qdq(jnp.asarray(q), 6, 8, None, [1, 16], True))


@pytest.mark.parametrize("nkv,rep", [(2, 1), (1, 2)])
@pytest.mark.parametrize("prob_q", [(16, 6, 8, None), None])
def test_attention_pos_major_plain_matches_jax(nkv, rep, prob_q):
    b, hd, s_len = 2, 128, 64
    cache = _cache(b, nkv, s_len, hd, True)
    q = _q(b, nkv * rep, hd).reshape(b, nkv * rep, hd)
    pos = np.array([s_len - 1, 20], np.int32)
    want = np.asarray(jattn.packed_attention_decode_batch(
        jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(pos), 16, 16,
        nkv=nkv, rep=rep, prob_q=prob_q, exact_q=True, interpret=True))
    got = tattn.packed_attention_decode_batch_cuda(
        torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos),
        16, 16, nkv=nkv, rep=rep, prob_q=prob_q).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("nkv,rep", [(2, 1), (1, 2)])
def test_attention_head_major_plain_matches_jax(nkv, rep):
    b, hd, s_len = 2, 128, 128
    cache = _cache(b, nkv, s_len, hd, False)
    q = _q(b, nkv * rep, hd).reshape(b, nkv, rep, hd)
    pos = np.array([100, 3], np.int32)
    prob_q = (16, 6, 8, None)
    want = np.asarray(jattn.packed_attention_decode(
        jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(pos), 16, 16,
        prob_q=prob_q, interpret=True))
    got = tattn.packed_attention_decode_cuda(
        torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos),
        16, 16, prob_q=prob_q).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_prob_q_spec_and_gates_match_jax():
    cfg = {"name": "block_fp", "bypass": False, "data_in_width": 6,
           "data_in_exponent_width": 8, "data_in_exponent_bias": 127,
           "data_in_block_size": [1, 16]}
    assert tattn.prob_q_spec(cfg, 64) == jattn.prob_q_spec(cfg, 64)
    for bad in (dict(cfg, data_in_width=12), dict(cfg, data_in_block_size=[1, 24])):
        with pytest.raises(ValueError):
            tattn.prob_q_spec(bad, 96)
    assert tattn.BATCH_KERNEL_MAX_LANES == jattn.BATCH_KERNEL_MAX_LANES
    # the TPU kernel's cache cap is the JAX package's own: the CUDA kernels
    # take any cache length, and the route follows the JAX cap only for a
    # cache they refuse
    assert 8192 * 128 > jattn._MAX_S_HD == tattn._REFERENCE_MAX_S_HD
    assert tattn.kernel_shape_error(1, 128) is None
    from llm_mixed_q_torch.kernels.dequant_matmul import actq_spec

    for c in (cfg, dict(cfg, data_in_block_size=[-1, 16]), dict(cfg, name="integer"), None):
        assert actq_spec(c) == jmm.actq_spec(c)


@pytest.mark.parametrize("rep,hd,s_len,reason", [
    (1, 128, 56000, None), (8, 128, 6800, None), (1, 128, 131072, None),
    (8, 128, 8192, None), (9, 128, 64, "query rows"), (1, 96, 64, None),
    (1, 272, 64, None), (1, 512, 64, None), (1, 1040, 64, None),
    (2, 2048, 64, None), (1, 2**16, 8, None), (8, 3012, 174, None), (1, 0, 64, "head_dim")])
def test_attention_kernel_limits(rep, hd, s_len, reason):
    """The limits of csrc/attention_decode.cu, which the wrappers raise on
    and by which serving picks its route: rep 1..8 and a head_dim from 1
    (``_launch_attention``), at any cache length; the refusals lie outside
    the JAX package's kernel too (rep > 8). Since fault 18's repair K5
    takes 1040 and 2048 dims, since fault 21's 65536 (K4 took at most 65535)
    and 3012 at rep 8."""
    error = tattn.kernel_shape_error(rep, hd)
    assert (error is None) if reason is None else (reason in error)
    if reason is not None:
        q = torch.zeros((1, rep, hd))
        with pytest.raises(ValueError, match=reason):
            tattn._launch_attention("k", q, *(torch.zeros(1, dtype=torch.int8),
                                              torch.zeros(1)) * 2, torch.zeros(1), 1, rep,
                                    hd, s_len, 16, 16, None)


def test_attention_wrappers_refuse_operands_past_32_bit_indices():
    """The kernels index in 32 bits: a head-major cache of 2^31 code bytes
    (meta tensors, nothing allocated) is refused before any launch."""
    meta = dict(device="meta")
    q = torch.empty((1, 1, 1, 128), **meta)
    kc = torch.empty((1, 1, 128, 2**24), dtype=torch.int8, **meta)
    ks = torch.empty((1, 1, 8, 2**24), **meta)
    with pytest.raises(ValueError, match="32 bits"):
        tattn._check_attention("k", q, kc, ks, kc, ks, 1, 128, 16, 16, None)
    with pytest.raises(ValueError, match="32 bits"):
        tattn._workspace("k", 2**31, "meta")
