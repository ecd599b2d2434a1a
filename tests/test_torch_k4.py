"""K4's chunked schedule, held to the JAX package on the CPU.

K4 (``llm_mixed_q_torch.kernels.attention_decode.packed_attention_decode_batch_cuda``)
gives a block all kv heads (G of them) of a chunk of P positions of one
batch element (``k4_geometry``) and splits decode attention into phases:

1. the scores of the chunk's lanes into a workspace [b, nh, S];
2. per query row, the max and the float64 denominator over every filled
   position, and for a prob block longer than min(P, 32) the max of exp
   over each whole block (positions past pos count as 0);
3. per chunk, the probabilities and their block_fp quantization, a block of
   at most min(P, 32) positions inside the chunk taking its max there and a
   longer one phase 2's max of exp divided by the denominator; then
   P . deq(V) of the chunk into a partial [b, chunk, hd, nh];
4. the partials of the filled chunks summed in chunk order.

These tests run that schedule in plain torch (float32, the float64
denominator rounded to float32, each block's max taken as the kernel takes
it) on numpy inputs from a seed, and hold it against the TPU kernel
``packed_attention_decode_batch(..., interpret=True)`` at rtol 2e-4 /
atol 2e-5, the tolerance of ``tests/test_attention_kernel.py`` (sums in
another order; the float64 denominator, ROADMAP fault 5), and against the
port's plain version at the same tolerance. The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import attention_decode as jattn
from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_tpu.ops.quantizers import _block_fp_qdq as _jax_qdq
from llm_mixed_q_torch.kernels import attention_decode as ad
from llm_mixed_q_torch.ops.quantizers.exact import ceil_log2, exact_exp2

SEED = 11
RTOL, ATOL = 2e-4, 2e-5


def _cache(rng, b, nkv, s_len, hd, bs_k, bs_v):
    """A pos-major packed cache of random K/V, packed by the JAX package."""
    k = rng.standard_normal((b, nkv, s_len, hd)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s_len, hd)).astype(np.float32)
    kc, ks = jp.bfp_encode_lastdim(jnp.asarray(k), 6, 8, None, bs_k)
    vc, vs = jp.bfp_encode_lastdim(jnp.asarray(v), 6, 8, None, bs_v)
    flat = lambda t: np.ascontiguousarray(
        np.asarray(t).transpose(0, 3, 2, 1).reshape(b, t.shape[3], s_len * nkv))
    return [flat(kc), flat(ks), flat(vc), flat(vs)]


def _q(rng, b, nh, hd):
    """q as serving quantizes it (data_in block_fp [1, 16], width 6)."""
    q = rng.standard_normal((b * nh, hd)).astype(np.float32)
    return np.array(_jax_qdq(jnp.asarray(q), 6, 8, None, [1, 16], True)).reshape(b, nh, hd)


def _qdq_given_max(x, mx, width, ew, eb):
    """block_fp qdq of x (>= 0) whose block's abs max is mx, by the formula
    of ``ops/quantizers/block_fp.py`` (a zero block passes through)."""
    if eb in (None, "none", "None"):
        eb = 2 ** (ew - 1) - 1
    mbits = width - 1
    e = ceil_log2(torch.where(mx > 0, mx, torch.ones_like(mx))).clamp(-eb, 2**ew - 1 - eb)
    two_e = exact_exp2(e)
    mant = torch.round((x.abs() + 1e-9) / two_e * 2**mbits).clamp(0, 2**mbits - 1)
    q = torch.sign(x + 1e-9) * two_e * (mant / 2**mbits)
    return torch.where(x.abs() <= 1e-8, x, q)


def k4_scale_rows(hd, dims, bs):
    """The scale row the kernel reads for each dim: a ring stage holds the
    rows from its first dim's (d0 / bs) on, and dim dd of the stage reads
    its row dd / bs (the dim's own row wherever the stage fits the
    blocks, as ``k4_tiles`` makes it)."""
    d = torch.arange(hd)
    return d // dims * dims // bs + d % dims // bs


def _ordered_sum(parts):
    """The parts summed one after the other, as a kernel sums its thread
    groups."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def k4_schedule(q, kc, ks, vc, vs, positions, bs_k, bs_v, nkv, rep, prob_q):
    """K4's phases in plain torch, chunk by chunk, with the head dims in the
    kernel's ring stages of ``dims`` dims (each dim dequantized by the
    scale row the kernel reads), the scores' dim groups (dims dd of a
    stage with dd // (dims / dgs) == g) summed in group order, and, where
    G % 4 == 0, P . V's position groups (pp % pgs == g) summed in group
    order (``ad.k4_tiles``). -> ctx [b, nh, hd]."""
    b, nh, hd = q.shape
    s_len = kc.shape[2] // nkv
    g_heads, p_len = ad.k4_geometry(nkv, rep, s_len)
    dims, dgs, pgs = ad.k4_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
    assert hd % dims == 0 and dims % dgs == 0
    if g_heads % 4:
        pgs = 1
    dim_group = torch.arange(hd) % dims // (dims // dgs)
    nch = -(-s_len // p_len)
    sqrt_hd = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    # deq(K), deq(V) as [b, hd, S, nkv]
    kd = (kc.float() * ks[:, k4_scale_rows(hd, dims, bs_k)]).reshape(b, hd, s_len, nkv)
    vd = (vc.float() * vs[:, k4_scale_rows(hd, dims, bs_v)]).reshape(b, hd, s_len, nkv)
    qg = q.reshape(b, nkv, rep, hd)
    scores = torch.full((b, nkv, rep, s_len), float("nan"))  # the workspace
    partial = torch.full((b, nch, hd, nkv, rep), float("nan"))
    out = torch.empty((b, nkv, rep, hd))
    for bi in range(b):
        npos = min(int(positions[bi]), s_len - 1) + 1
        chunks = [(c * p_len, min(p_len, npos - c * p_len)) for c in range(nch)
                  if c * p_len < npos]
        groups = [(h0, min(g_heads, nkv - h0)) for h0 in range(0, nkv, g_heads)]
        for p0, n in chunks:  # phase 1
            for h0, gl in groups:
                kt = kd[bi, :, p0:p0 + n, h0:h0 + gl]  # [hd, n, gl]
                acc = _ordered_sum([
                    torch.einsum("hrd,dph->hrp", qg[bi, h0:h0 + gl][..., dim_group == g],
                                 kt[dim_group == g]) for g in range(dgs)])
                scores[bi, h0:h0 + gl, :, p0:p0 + n] = acc / sqrt_hd
        for c, (p0, n) in enumerate(chunks):  # phases 2 and 3
            for h0, gl in groups:
                s_rows = scores[bi, h0:h0 + gl, :, :npos]  # [gl, rep, npos]
                m = s_rows.amax(-1, keepdim=True)
                denom = torch.exp(s_rows - m).double().sum(-1, keepdim=True).float()
                e = torch.exp(scores[bi, h0:h0 + gl, :, p0:p0 + n] - m)
                p = e / denom
                if prob_q is not None:
                    pbs, width, ew, eb = prob_q
                    if pbs <= min(p_len, 32):  # blocks inside the chunk
                        padded = torch.nn.functional.pad(p, (0, p_len - n))
                        mx = padded.reshape(gl, rep, p_len // pbs, pbs).amax(-1)
                        mx = mx.repeat_interleave(pbs, -1)[..., :n]
                    else:  # the max of exp over each whole block, divided
                        blocks = range(p0 // pbs, (p0 + n - 1) // pbs + 1)
                        emax = torch.stack([torch.exp(
                            scores[bi, h0:h0 + gl, :, k0 * pbs:min((k0 + 1) * pbs, npos)] - m
                        ).amax(-1) for k0 in blocks], -1) / denom
                        mx = emax[..., (torch.arange(p0, p0 + n) // pbs) - blocks[0]]
                    p = _qdq_given_max(p, mx, width, ew, eb)
                vt = vd[bi, :, p0:p0 + n, h0:h0 + gl]  # [hd, n, gl]
                pos_group = torch.arange(n) % pgs
                partial[bi, c, :, h0:h0 + gl] = _ordered_sum([
                    torch.einsum("hrp,dph->dhr", p[..., pos_group == g], vt[:, pos_group == g])
                    for g in range(min(pgs, n))])
        acc = torch.zeros((hd, nkv, rep))  # phase 4, in chunk order
        for c in range(len(chunks)):
            acc = acc + partial[bi, c]
        out[bi] = acc.permute(1, 2, 0)
    return out.reshape(b, nh, hd)


# b, nkv, rep, hd, S, bs_k, bs_v, prob block (None: no prob quantizer),
# positions. Geometry (G, P): 32 heads -> (32, 16), 8 -> (8, 64), 2 ->
# (2, 256), 1 -> (1, 512); 64 heads at rep 8 -> two head groups of 32.
# Positions: S - 1, 0, a chunk's last and first position, mid-chunk.
K4_CASES = [
    (4, 32, 1, 128, 256, 16, 16, 16, [255, 0, 16, 100]),  # Llama-2-7B
    (3, 8, 4, 128, 1024, 16, 16, 16, [1023, 63, 64]),  # GQA at the lane cap
    (2, 1, 8, 64, 8192, 16, 16, 8192, [8191, 700]),  # one head, prob block S
    (3, 2, 4, 64, 4096, 32, 16, 1, [0, 4095, 511]),  # prob block 1
    (2, 32, 8, 128, 256, 16, 16, None, [255, 37]),  # 256 query rows a block
    (2, 8, 1, 64, 1024, 16, 64, 256, [1023, 300]),  # a prob block over 4 chunks
    (2, 1, 4, 128, 2048, 16, 16, 128, [2047, 1000]),  # 4 long blocks a chunk
    (2, 32, 1, 64, 128, 16, 16, 32, [127, 40]),  # 32 > P = 16: a block of 2 chunks
    (1, 64, 8, 64, 64, 16, 16, 16, [63]),  # two head groups
    (2, 5, 3, 64, 128, 8, 32, 16, [127, 64]),  # 5 heads, rep 3
    (2, 8, 2, 128, 512, 16, 16, None, [0, 511]),  # no prob quantizer
    (3, 2, 1, 128, 64, 4, 128, 64, [15, 16, 63]),  # prob block S, K blocks of 4
    (2, 32, 4, 64, 64, 64, 2, 16, [31, 63]),  # scale blocks 64 and 2
    (2, 4, 1, 128, 2048, 1, 16, 16, [2047, 127]),  # K scale a code
]


def _inputs(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions, seed=SEED):
    rng = np.random.default_rng(seed)
    cache = _cache(rng, b, nkv, s_len, hd, bs_k, bs_v)
    q = _q(rng, b, nkv * rep, hd)
    prob_q = None if pbs is None else (pbs, 6, 8, None)
    return q, cache, np.array(positions, np.int32), prob_q


_SCHEDULED = {}


def scheduled(case, seed=SEED):
    """(torch args of the schedule, its ctx) of a case, computed once: both
    tests of a case hold the same run, on inputs from the case's seed."""
    key = (repr(case), seed)
    if key not in _SCHEDULED:
        b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions = case
        q, cache, pos, prob_q = _inputs(*case, seed=seed)
        args = (torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos),
                bs_k, bs_v, nkv, rep, prob_q)
        _SCHEDULED[key] = args, k4_schedule(*args)
    return _SCHEDULED[key]


def jax_kernel(args):
    """The TPU kernel in interpret mode on the schedule's args."""
    q, kc, ks, vc, vs, pos, bs_k, bs_v, nkv, rep, prob_q = args
    return np.asarray(jattn.packed_attention_decode_batch(
        *(jnp.asarray(t.numpy()) for t in (q, kc, ks, vc, vs, pos)), bs_k, bs_v, nkv=nkv,
        rep=rep, prob_q=prob_q, exact_q=True, interpret=True))


@pytest.mark.parametrize("b,nkv,rep,hd,s_len,bs_k,bs_v,pbs,positions", K4_CASES)
def test_k4_schedule_matches_jax_kernel(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions):
    args, got = scheduled((b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions))
    want = jax_kernel(args)
    assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,nkv,rep,hd,s_len,bs_k,bs_v,pbs,positions", K4_CASES)
def test_k4_schedule_matches_plain(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions):
    """The schedule against the port's plain version, which the kernel is
    held to on the card."""
    args, got = scheduled((b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions))
    torch.testing.assert_close(got, ad.packed_attention_decode_batch_plain(*args),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nkv,rep,s_len,want", [
    (32, 1, 256, (32, 16)), (8, 4, 1024, (8, 64)), (1, 8, 8192, (1, 512)),
    (2, 1, 4096, (2, 256)), (64, 8, 128, (32, 16)), (5, 3, 100, (5, 64)),
    (32, 8, 8, (32, 8)), (2, 1, 1, (2, 1)),
])
def test_k4_geometry(nkv, rep, s_len, want):
    """A block holds at most 512 lanes and 256 query rows; P is a power of
    two no longer than the cache; the workspace holds the scores, one
    partial a chunk, each row's max and denominator, and a max a long prob
    block."""
    g, p = ad.k4_geometry(nkv, rep, s_len)
    assert (g, p) == want
    assert p * g <= 512 and g * rep <= 256 and p & (p - 1) == 0 and p <= s_len
    hd, b, nh = 128, 3, nkv * rep
    nch = -(-s_len // p)
    base = b * nh * s_len + b * nch * hd * nh + 2 * b * nh  # scores, partials, max, denom
    assert ad.k4_workspace_floats(b, nkv, rep, hd, s_len) == base
    assert ad.k4_workspace_floats(b, nkv, rep, hd, s_len, min(p, 32)) == base
    long_block = 2 * max(p, 32)  # longer than min(P, 32): its max of exp a row
    assert ad.k4_workspace_floats(b, nkv, rep, hd, s_len, long_block) == (
        base + b * nh * -(-s_len // long_block))
