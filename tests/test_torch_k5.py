"""K5's chunked schedule, held to the JAX package on the CPU.

K5 (``llm_mixed_q_torch.kernels.attention_decode.packed_attention_decode_cuda``)
runs decode attention over the head-major cache (K codes [b, nkv, hd, S],
V codes [b, nkv, S, hd]) with a block a chunk of P positions of one kv head
and its rep query rows, walked in tiles of T (``k5_geometry``; ``k5_tiles``
halves T where two stages would not fit, below 32 past ~1000 dims a head),
in K4's phases:

1. the scores of the chunk into a workspace [b, nh, S];
2. per query row, the max and the float64 denominator over every filled
   position, and for a prob block longer than min(T, 32) the max of exp
   over each whole block (K4's stats kernel);
3. per chunk, the probabilities and their block_fp quantization, a block of
   at most min(T, 32) positions inside the chunk taking its max there and a
   longer one phase 2's max of exp divided by the denominator; then
   P . deq(V) of the chunk into a partial [b, chunk, hd, nh];
4. the partials of the filled chunks summed in chunk order (K4's sum
   kernel).

These tests run that schedule in plain torch (float32, each block's max
taken as the kernel takes it) on numpy inputs from a seed. With the TPU
kernel's own denominator (a float32 sum by XLA) it is held against that
kernel, ``packed_attention_decode(..., interpret=True)``, at rtol 2e-4 /
atol 2e-5, the tolerance of ``tests/test_attention_kernel.py`` (sums in
another order). With the port's denominator (the float64 sum rounded to
float32: ROADMAP fault 5, which can move a probability by an ulp and flip
a rounding of the prob quantizer, as it does in one row of the
2048-position case) it is held against the port's plain version at the
same tolerance. The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import attention_decode as jattn
from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_tpu.ops.quantizers import _block_fp_qdq as _jax_qdq
from llm_mixed_q_torch.kernels import attention_decode as ad
from test_torch_k4 import _ordered_sum, _qdq_given_max

RNG = np.random.default_rng(12)
RTOL, ATOL = 2e-4, 2e-5


def _cache(b, nkv, s_len, hd, bs_k, bs_v):
    """A head-major packed cache of random K/V, packed by the JAX package:
    K codes and scales transposed to [b, nkv, hd(/bs), S]."""
    k = RNG.standard_normal((b, nkv, s_len, hd)).astype(np.float32)
    v = RNG.standard_normal((b, nkv, s_len, hd)).astype(np.float32)
    kc, ks = jp.bfp_encode_lastdim(jnp.asarray(k), 6, 8, None, bs_k)
    vc, vs = jp.bfp_encode_lastdim(jnp.asarray(v), 6, 8, None, bs_v)
    t = lambda a: np.ascontiguousarray(np.asarray(a).transpose(0, 1, 3, 2))
    return [t(kc), t(ks), np.asarray(vc), np.asarray(vs)]


def f64_denominator(e):
    """Each row's sum of exp, in float64 rounded to float32 (the port's,
    kernel and plain version alike)."""
    return e.double().sum(-1, keepdim=True).float()


def jax_denominator(e):
    """Each row's sum of exp as the TPU kernel takes it: in float32, by XLA,
    over a row of all S positions (those past pos are 0) in a block of 8
    rows (fault 5: its last bits differ from the float64 sum's)."""
    rows = np.zeros((8, e.shape[-1]), np.float32)
    rows[:e.shape[0]] = e.numpy()
    return torch.from_numpy(np.asarray(_jax_row_sum(jnp.asarray(rows)))[:e.shape[0], None])


_jax_row_sum = jax.jit(lambda x: jnp.sum(x, axis=1))


def k5_scores(q, codes, scales, hd, dgs, bs_k):
    """Phase 1 of a chunk as the kernel splits it (``ad.k5_tiles``): dgs
    dim groups of hd / dgs dims, each walked in runs of min(hd / dgs, bs_k)
    dims whose q . codes is multiplied by the scale row of the run's first
    dim, the groups summed in group order. q [rep, hd]; codes [hd, n];
    scales [hd / bs_k, n]. -> [rep, n]"""
    dpg = hd // dgs
    run = min(dpg, bs_k)
    groups = []
    for g in range(dgs):
        starts = range(g * dpg, (g + 1) * dpg, run)
        groups.append(_ordered_sum([
            (q[:, d0:d0 + run] @ codes[d0:d0 + run]) * scales[d0 // bs_k] for d0 in starts]))
    return _ordered_sum(groups)


def k5_schedule(q, kc, ks, vc, vs, positions, bs_k, bs_v, prob_q, denominator=f64_denominator):
    """K5's phases in plain torch, chunk by chunk, with the scores' dim
    groups and scale runs (``k5_scores``) and P . V's position groups (a
    chunk's position pp in group pp % T % pgs, T the positions a ring
    stage) summed in group order (``ad.k5_tiles``); ``denominator`` maps
    the rows of exp [rep, S] (0 past pos) to their sums [rep, 1].
    -> ctx [b, nkv, rep, hd]."""
    b, nkv, rep, hd = q.shape
    s_len = vc.shape[2]
    p_len, _ = ad.k5_geometry(nkv, rep, s_len)
    t_len, dims, dgs, pgs = ad.k5_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
    assert dims == hd  # the replica keeps all of the head in a stage of the scores
    nch = -(-s_len // p_len)
    sqrt_hd = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    vd = vc.float() * vs.repeat_interleave(bs_v, 3)  # [b, nkv, S, hd]
    scores = torch.full((b, nkv, rep, s_len), float("nan"))  # the workspace
    partial = torch.full((b, nch, hd, nkv, rep), float("nan"))
    out = torch.empty((b, nkv, rep, hd))
    for bi in range(b):
        npos = min(int(positions[bi]), s_len - 1) + 1
        chunks = [(c * p_len, min(p_len, npos - c * p_len)) for c in range(nch)
                  if c * p_len < npos]
        for h in range(nkv):
            for p0, n in chunks:  # phase 1
                acc = k5_scores(q[bi, h], kc[bi, h, :, p0:p0 + n].float(),
                                ks[bi, h, :, p0:p0 + n], hd, dgs, bs_k)
                scores[bi, h, :, p0:p0 + n] = acc / sqrt_hd
            s_rows = scores[bi, h, :, :npos]  # phase 2
            m = s_rows.amax(-1, keepdim=True)
            denom = denominator(torch.nn.functional.pad(torch.exp(s_rows - m),
                                                        (0, s_len - npos)))
            for c, (p0, n) in enumerate(chunks):  # phase 3
                p = torch.exp(scores[bi, h, :, p0:p0 + n] - m) / denom
                if prob_q is not None:
                    pbs, width, ew, eb = prob_q
                    if pbs <= min(t_len, 32):  # blocks inside a tile of the chunk
                        padded = torch.nn.functional.pad(p, (0, p_len - n))
                        mx = padded.reshape(rep, p_len // pbs, pbs).amax(-1)
                        mx = mx.repeat_interleave(pbs, -1)[..., :n]
                    else:  # the max of exp over each whole block, divided
                        blocks = range(p0 // pbs, (p0 + n - 1) // pbs + 1)
                        emax = torch.stack([torch.exp(
                            scores[bi, h, :, k0 * pbs:min((k0 + 1) * pbs, npos)] - m
                        ).amax(-1) for k0 in blocks], -1) / denom
                        mx = emax[:, (torch.arange(p0, p0 + n) // pbs) - blocks[0]]
                    p = _qdq_given_max(p, mx, width, ew, eb)
                pos_group = torch.arange(n) % t_len % pgs
                partial[bi, c, :, h] = _ordered_sum([
                    torch.einsum("rp,pd->dr", p[:, pos_group == g],
                                 vd[bi, h, p0:p0 + n][pos_group == g])
                    for g in range(min(pgs, n))])
        acc = torch.zeros((hd, nkv, rep))  # phase 4, in chunk order
        for c in range(len(chunks)):
            acc = acc + partial[bi, c]
        out[bi] = acc.permute(1, 2, 0)
    return out


# b, nkv, rep, hd, S, bs_k, bs_v, prob block (None: no prob quantizer),
# positions. (P, T) from k5_geometry: (512, 128) at 32 heads and 512 or
# more positions and at 8 heads and 4096, (128, 128) at fewer heads, the
# cache length below 128. Positions: S - 1, 0, a chunk's or a tile's last
# and first, mid-chunk.
K5_CASES = [
    (4, 32, 1, 128, 512, 16, 16, 16, [511, 0, 127, 128]),  # Llama-2-7B, the batcher's S
    (2, 4, 3, 64, 256, 16, 16, 16, [255, 100]),  # rep 3 (run-time rep)
    (2, 4, 4, 128, 512, 16, 16, 32, [511, 200]),  # rep 4, prob block min(T, 32)
    (2, 2, 8, 64, 512, 16, 16, 256, [511, 300]),  # rep 8, a prob block over 2 chunks
    (2, 2, 1, 128, 512, 16, 16, 1, [511, 5]),  # prob block 1
    (1, 2, 2, 64, 512, 16, 16, 512, [511]),  # prob block S, over 4 chunks
    (2, 4, 1, 128, 256, 16, 16, None, [255, 17]),  # no prob quantizer
    (2, 2, 2, 128, 512, 1, 2, 16, [511, 300]),  # a scale a K code, V blocks of 2
    (2, 8, 4, 128, 4096, 16, 16, 16, [4095, 512]),  # GQA past 1024 positions: 4 tiles a chunk
    (2, 1, 1, 64, 32, 16, 16, 16, [31, 0]),  # a cache shorter than a tile
    (2, 2, 1, 128, 2048, 16, 16, 64, [2047, 1023]),  # 16 chunks, prob blocks of 64
    (2, 3, 2, 64, 100, 16, 16, 4, [99, 64]),  # S off the chunk: a short last chunk
]


def _inputs(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions):
    cache = _cache(b, nkv, s_len, hd, bs_k, bs_v)
    q = RNG.standard_normal((b * nkv * rep, hd)).astype(np.float32)
    q = np.array(_jax_qdq(jnp.asarray(q), 6, 8, None, [1, 16], True)).reshape(b, nkv, rep, hd)
    prob_q = None if pbs is None else (pbs, 6, 8, None)
    return q, cache, np.array(positions, np.int32), prob_q


@pytest.mark.parametrize("b,nkv,rep,hd,s_len,bs_k,bs_v,pbs,positions", K5_CASES)
def test_k5_schedule_matches_jax_kernel(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions):
    q, cache, pos, prob_q = _inputs(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions)
    want = np.asarray(jattn.packed_attention_decode(
        jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(pos), bs_k, bs_v,
        prob_q=prob_q, interpret=True))
    got = k5_schedule(torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos),
                      bs_k, bs_v, prob_q, jax_denominator).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,nkv,rep,hd,s_len,bs_k,bs_v,pbs,positions", K5_CASES)
def test_k5_schedule_matches_plain(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions):
    """The schedule against the port's plain version, which the kernel is
    held to on the card, and which the wrapper returns for CPU tensors."""
    q, cache, pos, prob_q = _inputs(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions)
    args = (torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos), bs_k,
            bs_v, prob_q)
    want = ad.packed_attention_decode_plain(*args)
    torch.testing.assert_close(k5_schedule(*args), want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ad.packed_attention_decode_cuda(*args), want, rtol=0, atol=0)


@pytest.mark.parametrize("nkv,rep,s_len,want", [
    (32, 1, 512, (512, 128)), (32, 1, 2048, (512, 128)), (32, 1, 4096, (512, 128)),
    (8, 4, 4096, (512, 128)), (8, 1, 512, (128, 128)), (8, 8, 100, (64, 64)),
    (1, 1, 32, (32, 32)), (2, 1, 1, (1, 1)),
])
def test_k5_geometry(nkv, rep, s_len, want):
    """P and T are powers of two, T <= P <= the cache length, T <= 128 and
    P <= 512, and P leaves a batch element 32 blocks or more unless it is
    one tile; the workspace is K4's with K5's P: the scores, one partial a
    chunk, each row's max and denominator, and a max a long prob block."""
    p, t = ad.k5_geometry(nkv, rep, s_len)
    assert (p, t) == want
    assert p & (p - 1) == 0 and t & (t - 1) == 0 and t <= p <= min(s_len, 512) and t <= 128
    assert nkv * s_len // p >= 32 or p == t
    hd, b, nh = 128, 3, nkv * rep
    nch = -(-s_len // p)
    base = b * nh * s_len + b * nch * hd * nh + 2 * b * nh  # scores, partials, max, denom
    assert ad.k4_workspace_floats(b, nkv, rep, hd, s_len, p=p) == base
    assert ad.k4_workspace_floats(b, nkv, rep, hd, s_len, min(t, 32), p) == base
    long_block = 2 * max(t, 32)  # longer than min(T, 32): its max of exp a row
    assert ad.k4_workspace_floats(b, nkv, rep, hd, s_len, long_block, p) == (
        base + b * nh * -(-s_len // long_block))
