"""Decode attention over the packed KV cache (counterpart of the JAX
package's ``kernels/attention_decode.py``).

Per decode step and kv head:
    scores  = q @ dequant(K) / sqrt(hd), masked to pos <= positions[b]
    probs   = softmax_f32(scores)
    probs_q = block_fp qdq of probs over [1, bs] runs of positions
    ctx     = probs_q @ dequant(V)

Two Hopper kernels (``csrc/attention_decode.cu``) replace the TPU kernels:

- K4 ``packed_attention_decode_batch_cuda``: the pos-major cache, flat
  [b, rows, S*nkv] arrays with lane = pos*nkv + head, K and V both stored
  [hd, lanes] (replaces ``packed_attention_decode_batch`` /
  ``_attn_kernel_batch``). A block covers all kv heads of a chunk of
  positions (``k4_geometry``), so it reads each cache sector once; its
  phases (scores; each row's max and denominator; the prob quantizer and
  P . V a chunk; the chunks' sum) are four launches of one C call, on a
  workspace from PyTorch's allocator (``k4_workspace_floats``);
- K5 ``packed_attention_decode_cuda``: the head-major cache, K [b, nkv, hd,
  S], V [b, nkv, S, hd] (replaces ``packed_attention_decode`` /
  ``_attn_kernel``). K4's phases with one kv head a block: a block covers a
  chunk of positions of one (batch element, kv head) and its query rows
  (``k5_geometry``), whose K and V tiles are contiguous runs of the cache;
  K4's stats and sum kernels run as they are, on a workspace of the same
  layout.

Each wrapper launches its kernel for CUDA tensors (counting launches) and
computes the plain version, the dense dequantize + einsum path of
serving, for CPU tensors.

The softmax denominator is summed in float64 and rounded to float32, in
the kernels and in the plain version alike. With block_fp-quantized q the
scores are exact in float32 whatever the summation order, so the kernel
and the plain version then agree on every probability bit and quantize
them identically; a float32 sum taken in two orders would differ in the
last bit and flip a rounding of the prob quantizer now and then. This
departs from the JAX reference, which sums in float32 (ROADMAP, faults).

``attend_dense`` serves the float32 fake-quant cache. A packed cache is
routed by shape (``packed_decode_route``): through the kernels where
``attention_kernel_error`` finds none of their limits passed, and through
``packed_attention_decode_dense`` (the dense path on the dequantized
codes, no kernel, its layer calls counted) where the JAX package's kernel
refuses it too (``reference_kernel_error``: its ``attention_kernel_ok`` is
False), as the JAX package's ``decode_step`` then decodes densely. The
kernels take rep 1..8, every head_dim and every K/V scale block that
divides it (``kernel_shape_error``, ``kernel_block_error``), with a split
that ``k4_tiles`` / ``k5_tiles`` find and the C host checks: a head_dim
off 4 keeps the JAX package's cache layout and is padded to 4 dims only
in shared memory, a block that is not a power of two takes its scale rows
by a counter or a quotient, K4 walks a head in ring stages of at most 128
dims, K5's P . V walks a head of more than 1024 dims in passes, and K5's
scores walk a head in passes of a divisor of it where two stages of all
its dims do not fit in shared memory (past 3011 dims at rep 8 and a
scale a code). So every cache that the JAX package's kernel takes, the
kernels take.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quantizers.block_fp import _block_fp_qdq
from . import _cuda
from .packing import effective_block_len

NEG_INF = float(np.finfo(np.float32).min)
_REP_MAX = 8  # GQA query rows per kv head the kernels take
_THREADS = 256
_SMEM_MAX = 227 * 1024  # shared memory a block (csrc kSmemMax)
# the JAX package's cap on its decode-attention kernel's cache: max_len *
# head_dim (its ``_MAX_S_HD``)
_REFERENCE_MAX_S_HD = 4096 * 128

# pos-major cache when nkv * max_len fits this many lanes (the JAX
# package's batch-folded kernel budget; the layout choice is kept so a
# cache has the same shapes in both packages)
BATCH_KERNEL_MAX_LANES = 8192
# K4's blocks: at most this many lanes (positions x kv heads) and query
# rows (kv heads x rep) a block (csrc kK4Lanes, kK4Rows)
_K4_LANES = 512
_K4_ROWS = 256
# K5's blocks: a chunk of at most _K5_CHUNK positions of one kv head, at
# least _K5_BLOCKS chunks a batch element where the cache allows, staged
# _K5_TILE positions at a time (the best of P 64-1024 and T 64-128 at the
# four shapes of chip_smoke.py's K5_SHAPES on an H100: PERF.md)
_K5_CHUNK = 512
_K5_BLOCKS = 32
_K5_TILE = 128


def k4_geometry(nkv: int, rep: int, s_len: int) -> tuple[int, int]:
    """(G, P): the kv heads and the positions (a power of two, at most
    ``s_len``) a K4 block covers. G is every head unless G * rep would pass
    ``_K4_ROWS``; P is the most positions that keep P * G <= ``_K4_LANES``
    (16 at 32 heads, 64 at 8)."""
    g = min(nkv, _K4_ROWS // rep)
    p = 1
    while 2 * p * g <= _K4_LANES and 2 * p <= s_len:
        p *= 2
    return g, p


def k5_geometry(nkv: int, rep: int, s_len: int) -> tuple[int, int]:
    """(P, T): the positions a K5 block covers, for one kv head and its
    ``rep`` query rows, and the positions a stage of its ring holds, both
    powers of two, T <= P <= ``s_len``. T is ``_K5_TILE`` (``k5_tiles``
    halves it where two stages would not fit in shared memory: head_dim
    256 with a scale a code); P is the longest chunk up to ``_K5_CHUNK`` that
    leaves a batch element ``_K5_BLOCKS`` blocks (nkv * S / P) or more."""
    cap = 1
    while 2 * cap <= s_len:
        cap *= 2
    t = min(_K5_TILE, cap)
    p = t
    while 2 * p <= min(cap, _K5_CHUNK) and nkv * s_len // (2 * p) >= _K5_BLOCKS:
        p *= 2
    return p, t


def _fits_blocks(n: int, bs: int) -> bool:
    """A run of n dims lies inside one scale block of ``bs`` dims or holds
    whole ones."""
    return n % bs == 0 or bs % n == 0


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _dim_groups(n: int, cap: int, bs: int) -> int:
    """The most groups, at most ``cap``, that split n dims evenly into runs
    that fit the scale blocks of ``bs`` dims. A power of two n gives the
    largest power of two <= min(cap, n)."""
    for d in range(min(cap, n), 1, -1):
        if n % d == 0 and _fits_blocks(n // d, bs):
            return d
    return 1


def _k4_scale_rows(dims: int, bs: int) -> int:
    return 1 if bs >= dims else dims // bs


def _stage_dims(hd: int):
    """K4's candidate ring stages, longest first: the multiples of 16 up
    to min(hd, 128), then the other multiples of 4 (a head_dim off 16),
    then every other length (a head_dim off 4)."""
    top = min(hd, 128)
    return [*range(top - top % 16, 15, -16),
            *(d for d in range(top - top % 4, 3, -4) if d % 16),
            *(d for d in range(top, 0, -1) if d % 4)]


def k4_tiles(nkv: int, rep: int, hd: int, s_len: int, bs_k: int, bs_v: int):
    """(dims, dgs, pgs) of a K4 call, which its C host checks: the head
    dims a ring stage holds (the first of ``_stage_dims`` that divides hd
    and fits both scale blocks, with which two stages fit in each kernel's
    shared memory: min(hd, 128), 64, 32 or 16 for a power of two; 80 of
    320, 40 of 40), the dim groups of the scores kernel (``_dim_groups`` of
    a stage's dims; every dim's scale is its own there) and the position
    groups of P . V (G % 4 == 0; else 1). q's tile of a stage is rounded
    up to 16 bytes. None where nothing fits."""
    g, p = k4_geometry(nkv, rep, s_len)
    rows, nq, q4 = g * rep, (p * g + 3) // 4, g % 4 == 0
    cstr, sstr = (p * g + 15) & ~15, (p * g + 3) & ~3
    for dims in _stage_dims(hd):
        if hd % dims or not (_fits_blocks(dims, bs_k) and _fits_blocks(dims, bs_v)):
            continue
        n_tiles = hd // dims
        dgs = _dim_groups(dims, _THREADS // nq, 1)
        pgs = 1
        while q4 and 2 * pgs * (g // 4) * dims <= _THREADS:
            pgs *= 2
        stage1 = dims * cstr + 4 * _k4_scale_rows(dims, bs_k) * sstr + (
            (4 * dims * rows + 15) & ~15)
        stage2 = dims * cstr + 4 * _k4_scale_rows(dims, bs_v) * sstr
        persist2 = 4 * (p * rows + 2 * rows + (pgs * dims * rows if q4 else 0))
        want = max(n_tiles, 2) if n_tiles < 8 else 8
        stages1 = min(_SMEM_MAX // stage1, want)
        stages2 = min((_SMEM_MAX - persist2) // stage2, want)
        smem1 = max(min(stages1, n_tiles) * stage1, 4 * dgs * rows * (p + 1))
        smem2 = min(stages2, n_tiles) * stage2 + persist2
        if stages1 >= 2 and stages2 >= 2 and max(smem1, smem2) <= _SMEM_MAX:
            return dims, dgs, pgs
    return None


def k5_pv_threads(hd: int) -> tuple[int, int]:
    """(vw, passes) of K5's P . V: the threads of a position group, each
    taking 4 dims of a pass (hd rounded up to 4, over 4, at most 256), and
    the passes over the head (more than one past 1024 dims)."""
    nd4 = _round4(hd) // 4
    vw = min(nd4, _THREADS)
    return vw, -(-nd4 // vw)


def _divisors(n: int) -> list[int]:
    """n's divisors, longest first."""
    small = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
    return sorted({*small, *(n // d for d in small)}, reverse=True)


def _k5_pv_stage(t: int, hd: int, bs_v: int, passes: bool) -> int:
    """Bytes of a ring stage of K5's P . V: t rows of all hd codes (rounded
    up to 4) and their hd / bs_v scales; with ``passes``, t rows of a
    pass's dims (``k5_pv_threads``) and the most scales a pass's dims take."""
    vw, _ = k5_pv_threads(hd)
    if not passes:
        return ((t * _round4(hd) + 15) & ~15) + 4 * _round4(t * (hd // bs_v))
    pw = 4 * vw
    most = max((min(g0 + pw, hd) - 1) // bs_v - g0 // bs_v + 1 for g0 in range(0, hd, pw))
    return ((t * pw + 15) & ~15) + 4 * _round4(t * _round4(most))


def k5_tiles(nkv: int, rep: int, hd: int, s_len: int, bs_k: int, bs_v: int):
    """(T, dims, dgs, pgs) of a K5 call, which its C host checks: the
    positions a ring stage holds (``k5_geometry``'s T, halved until two
    stages fit in shared memory), the head dims of a stage of the scores
    kernel (all of hd where two such stages fit at some T, else the longest
    divisor of hd that fits the K blocks at the longest T: the scores then
    walk each tile in passes of it), the dim groups of the scores kernel
    (``_dim_groups`` of a stage's dims, each group's runs under one K
    scale) and the whole groups of ``k5_pv_threads``' vw threads of P . V
    (256 // vw; the threads past them idle; 1 where a head takes passes,
    each pass a walk of the chunk of its own, the chunk's probabilities
    kept from the first). Without passes q's rows, a V code row and a row
    of P . V's sums take hd rounded up to 4 in shared memory. None where
    nothing fits (no cache: a stage of one position and one dim always
    does)."""
    p, t_top = k5_geometry(nkv, rep, s_len)
    vw, npass = k5_pv_threads(hd)
    for whole in (True, False):
        t = t_top
        while t >= 1:
            cstr = (t + 15) & ~15 if t >= 16 else _round4(t)
            sstr, nq = _round4(t), (t + 3) // 4
            for dims in [hd] if whole else _divisors(hd)[1:]:
                if not _fits_blocks(dims, bs_k):
                    continue
                passes = npass > 1 or dims < hd  # P . V's
                pgs = 1 if passes else _THREADS // vw
                stage2 = _k5_pv_stage(t, hd, bs_v, passes)
                ring2 = 2 * stage2 if passes else max(2 * stage2, 4 * pgs * rep * _round4(hd))
                smem2 = ((4 * ((p if passes else t) * rep + 2 * rep) + 15) & ~15) + ring2
                dgs = _dim_groups(dims, _THREADS // nq, bs_k)
                red1 = (dgs * rep * (t + 1) + 3) & ~3
                ksp = 1 if bs_k >= dims else dims // bs_k
                stage1 = ((dims * cstr + 15) & ~15) + 4 * ksp * sstr
                q_floats = _round4(rep * hd) if whole else 0
                if not whole:
                    stage1 += 4 * rep * _round4(dims)
                if max(4 * (q_floats + red1) + 2 * stage1, smem2) <= _SMEM_MAX:
                    return t, dims, dgs, pgs
            t //= 2
    return None


def k4_workspace_floats(b: int, nkv: int, rep: int, hd: int, s_len: int,
                        prob_block: int | None = None, p: int | None = None,
                        t: int | None = None) -> int:
    """float32 elements of the workspace of K4 (and of K5, given its P and
    T): the scores [b, nh, S], the chunks' P . V partials [b, ceil(S / P),
    hd, nh], then each row's max and denominator [b, nh] and, for a prob
    block longer than min(T, 32), each block's max of exp [b, nh, ceil(S /
    block)]. ``p``: the positions a block, K4's (``k4_geometry``) when
    None; ``t``: the positions whose prob blocks a block quantizes by a
    shuffle of its lanes (K5's ring stage), P when None."""
    if p is None:
        _, p = k4_geometry(nkv, rep, s_len)
    nh = nkv * rep
    shuffled = min(p if t is None else t, 32)
    long_blocks = -(-s_len // prob_block) if prob_block and prob_block > shuffled else 0
    return b * nh * (s_len + (-(-s_len // p)) * hd + 2 + long_blocks)


def softmax_lastdim(s: torch.Tensor) -> torch.Tensor:
    """float32 softmax whose denominator is summed in float64 (the JAX
    reference sums it in float32)."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.double().sum(dim=-1, keepdim=True).float()


def attend_dense(qg, k_all_t, v_all, positions_b, prob_quantizer=None, masks=None):
    """Dense decode attention. qg [b, nkv, rep, hd]; k_all_t [b, nkv, hd, S];
    v_all [b, nkv, S, hd]; positions_b [b] (last valid index, inclusive);
    ``prob_quantizer`` maps probs [b*nh, 1, S] to their quantized values;
    ``masks`` (bias, key_pos), each [nkv, rep, S]: a bias added to the
    scores and the key positions of the causal test, in place of 0 and
    0..S-1. -> ctx [b, nkv, rep, hd]."""
    b, nkv, rep, hd = qg.shape
    s_len = v_all.shape[2]
    # a tensor divisor keeps this a true division on the card, as in the
    # kernels (a Python scalar divisor becomes a reciprocal multiply there)
    sqrt_hd = torch.full((), math.sqrt(hd), dtype=torch.float32, device=qg.device)
    scores = torch.einsum("bkrd,bkds->bkrs", qg, k_all_t) / sqrt_hd
    key_pos = torch.arange(s_len, device=qg.device)
    if masks is not None:
        scores = scores + masks[0]
        key_pos = masks[1]
    valid = key_pos <= positions_b[:, None, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = softmax_lastdim(scores)
    if prob_quantizer is not None:
        probs = prob_quantizer(probs.reshape(b * nkv * rep, 1, s_len)).reshape(
            b, nkv, rep, s_len
        )
    return torch.einsum("bkrs,bksd->bkrd", probs, v_all)


def _prob_qdq_fn(prob_q):
    if prob_q is None:
        return None
    bs, width, ew, eb = prob_q
    return lambda p: _block_fp_qdq(p, width, ew, eb, [1, bs], skip_first_dim=True)


def _dequant_rows(codes, scales, bs, axis):
    """codes * scales broadcast over blocks of ``bs`` along ``axis``."""
    return codes.to(torch.float32) * scales.repeat_interleave(bs, dim=axis)


def packed_attention_decode_batch_plain(q, k_codes, k_scales, v_codes, v_scales,
                                        positions, bs_k, bs_v, nkv, rep=1,
                                        prob_q=None):
    """Plain version of K4: dequantize the pos-major cache to the dense
    layouts and run ``attend_dense``. -> ctx [b, nh, hd]."""
    b, nh, hd = q.shape
    lanes = k_codes.shape[2]
    s_len = lanes // nkv
    k_all_t = (
        _dequant_rows(k_codes, k_scales, bs_k, 1)
        .reshape(b, hd, s_len, nkv).permute(0, 3, 1, 2)
    )
    v_all = (
        _dequant_rows(v_codes, v_scales, bs_v, 1)
        .reshape(b, hd, s_len, nkv).permute(0, 3, 2, 1)
    )
    ctx = attend_dense(q.reshape(b, nkv, rep, hd), k_all_t, v_all,
                       positions.reshape(b), _prob_qdq_fn(prob_q))
    return ctx.reshape(b, nh, hd)


def packed_attention_decode_plain(q, k_codes_t, k_scales_t, v_codes, v_scales,
                                  positions, bs_k, bs_v, prob_q=None):
    """Plain version of K5 over the head-major cache. -> [b, nkv, rep, hd]."""
    k_all_t = _dequant_rows(k_codes_t, k_scales_t, bs_k, 2)
    v_all = _dequant_rows(v_codes, v_scales, bs_v, 3)
    return attend_dense(q, k_all_t, v_all, positions.reshape(q.shape[0]),
                        _prob_qdq_fn(prob_q))


def _prob_q_args(prob_q):
    """(on, bs, width, emin, emax) for the C interface."""
    if prob_q is None:
        return (0, 1, 1, 0, 0)
    bs, width, ew, eb = prob_q
    if eb in (None, "none", "None"):
        eb = 2 ** (ew - 1) - 1
    eb = int(eb)
    return (1, bs, width, -eb, 2**ew - 1 - eb)


def kernel_shape_error(rep: int, hd: int) -> str | None:
    """Why the decode-attention kernels (K4, K5) are not given ``rep``
    query rows per kv head at head_dim ``hd``, or None. They take rep 1..8
    and every head_dim from 1, at any cache length: K4 and K5 walk the
    cache in chunks and a head in ring stages of its dims, and neither
    keeps anything in shared memory that grows with either (the wrappers
    bound the operands and the workspace to 32-bit indices). The split of
    the head is ``k4_tiles`` / ``k5_tiles``' to find
    (``attention_kernel_error``)."""
    if not 1 <= rep <= _REP_MAX:
        return f"{rep} query rows per kv head (the kernels take 1..{_REP_MAX})"
    if hd < 1:
        return f"head_dim {hd} is not 1 or more"
    return None


def kernel_block_error(hd: int, bs_k: int, bs_v: int) -> str | None:
    """Why the kernels do not take K/V scale blocks of ``bs_k``/``bs_v``
    dims at head_dim ``hd``, or None: a block must divide hd."""
    for what, bs in (("K", bs_k), ("V", bs_v)):
        if bs < 1 or hd % bs:
            return f"{what} scale block {bs} does not divide head_dim {hd}"
    return None


def kernel_tiles_error(nkv: int, rep: int, hd: int, s_len: int, pos_major: bool,
                       blocks: tuple[int, int]) -> str | None:
    """Why no split of the head fits the shared memory of the kernel of a
    layout (``k4_tiles`` / ``k5_tiles`` find none), or None."""
    tiles = k4_tiles if pos_major else k5_tiles
    if tiles(nkv, rep, hd, s_len, *blocks) is None:
        return (f"no ring stage of head_dim {hd} at rep {rep} and blocks {blocks} fits in "
                f"shared memory")
    return None


def _check_attention(fn_name, q, kc, ks, vc, vs, rep, hd, bs_k, bs_v, prob_q):
    tensors = (q, kc, ks, vc, vs)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn_name}: q and the cache must be contiguous on one device")
    if q.dtype != torch.float32 or kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise ValueError(f"{fn_name}: q float32, codes int8 expected")
    if hd % bs_k or hd % bs_v:
        raise ValueError(f"{fn_name}: blocks {bs_k}/{bs_v} do not divide {hd}")
    if prob_q is not None and prob_q[0] < 1:
        raise ValueError(f"{fn_name}: bad prob block {prob_q[0]}")
    error = kernel_shape_error(rep, hd) or kernel_block_error(hd, bs_k, bs_v)
    if error:
        raise ValueError(f"{fn_name}: {error}")
    if max(t.numel() for t in tensors) >= 2**31:
        raise ValueError(f"{fn_name}: an operand of 2^31 elements or more (the kernels "
                         "index in 32 bits)")


def _workspace(fn_name, floats, device):
    if floats >= 2**31:
        raise ValueError(f"{fn_name}: a workspace of {floats} floats (the kernels index "
                         "in 32 bits)")
    return torch.empty(floats, dtype=torch.float32, device=device)


def _positions(positions, q):
    return positions.to(device=q.device, dtype=torch.int32).reshape(q.shape[0]).contiguous()


def _launch_attention(fn_name, q, kc, ks, vc, vs, positions, nkv, rep, hd,
                      s_len, bs_k, bs_v, prob_q):
    """K5's C call on checked operands (q [b, nkv, rep, hd]; the head-major
    cache) -> ctx [b, nkv * rep, hd]; ``fn_name`` names the caller in
    errors."""
    _check_attention(fn_name, q, kc, ks, vc, vs, rep, hd, bs_k, bs_v, prob_q)
    b = q.shape[0]
    shapes = {"q": (q.shape, (b, nkv, rep, hd)),
              "K codes": (kc.shape, (b, nkv, hd, s_len)),
              "K scales": (ks.shape, (b, nkv, hd // bs_k, s_len)),
              "V codes": (vc.shape, (b, nkv, s_len, hd)),
              "V scales": (vs.shape, (b, nkv, s_len, hd // bs_v))}
    for what, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{fn_name}: {what} {tuple(got)}, expected {want}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise ValueError(f"{fn_name}: float32 scales expected")
    if prob_q is not None and prob_q[0] & (prob_q[0] - 1):
        raise ValueError(f"{fn_name}: prob block {prob_q[0]} is not a power of two")
    p, _ = k5_geometry(nkv, rep, s_len)
    tiles = k5_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
    if tiles is None:
        raise ValueError(f"{fn_name}: no ring stage fits in shared memory")
    ws = _workspace(fn_name, k4_workspace_floats(b, nkv, rep, hd, s_len, prob_q and prob_q[0],
                                                 p, tiles[0]), q.device)
    pos = _positions(positions, q)
    out = torch.empty((b, nkv * rep, hd), dtype=torch.float32, device=q.device)
    rc = _cuda.lib().lmq_attn_decode_head_major(
        q.data_ptr(), kc.data_ptr(), ks.data_ptr(), vc.data_ptr(), vs.data_ptr(),
        pos.data_ptr(), out.data_ptr(), ws.data_ptr(), b, nkv, rep, hd, s_len, bs_k, bs_v, p,
        *tiles, math.sqrt(hd), *_prob_q_args(prob_q), _cuda.stream_ptr(q))
    _cuda.check(rc, fn_name)
    return out


def packed_attention_decode_batch_cuda(q, k_codes, k_scales, v_codes, v_scales,
                                       positions, bs_k, bs_v, nkv, rep=1,
                                       prob_q=None):
    """K4: decode attention over the pos-major packed cache.
    q [b, nh, hd] f32 (rows grouped by kv head); codes int8 [b, hd, S*nkv];
    scales f32 [b, hd/bs, S*nkv]; positions [b]; ``prob_q``'s block a power
    of two (``prob_q_spec``). -> ctx [b, nh, hd] f32."""
    if not q.is_cuda:
        return packed_attention_decode_batch_plain(
            q, k_codes, k_scales, v_codes, v_scales, positions, bs_k, bs_v,
            nkv, rep, prob_q)
    name = "packed_attention_decode_batch_cuda"
    b, nh, hd = q.shape
    if nh != nkv * rep:
        raise ValueError(f"{nh} query heads != nkv {nkv} * rep {rep}")
    s_len = k_codes.shape[2] // nkv
    _check_attention(name, q, k_codes, k_scales, v_codes, v_scales, rep, hd, bs_k, bs_v,
                     prob_q)
    if prob_q is not None and prob_q[0] & (prob_q[0] - 1):
        raise ValueError(f"{name}: prob block {prob_q[0]} is not a power of two")
    g, p = k4_geometry(nkv, rep, s_len)
    tiles = k4_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
    if tiles is None:
        raise ValueError(f"{name}: no ring stage fits in shared memory")
    ws = _workspace(name, k4_workspace_floats(b, nkv, rep, hd, s_len, prob_q and prob_q[0]),
                    q.device)
    pos = _positions(positions, q)
    out = torch.empty((b, nh, hd), dtype=torch.float32, device=q.device)
    rc = _cuda.lib().lmq_attn_decode_pos_major(
        q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(), v_codes.data_ptr(),
        v_scales.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(), b, nkv, rep, hd,
        s_len, bs_k, bs_v, g, p, *tiles, math.sqrt(hd), *_prob_q_args(prob_q),
        _cuda.stream_ptr(q))
    _cuda.check(rc, name)
    packed_attention_decode_batch_cuda.launches += 1
    return out


def packed_attention_decode_cuda(q, k_codes_t, k_scales_t, v_codes, v_scales,
                                 positions, bs_k, bs_v, prob_q=None):
    """K5: decode attention over the head-major packed cache.
    q [b, nkv, rep, hd] f32; K codes [b, nkv, hd, S], K scales
    [b, nkv, hd/bs, S]; V codes [b, nkv, S, hd], V scales [b, nkv, S, hd/bs];
    ``prob_q``'s block a power of two (``prob_q_spec``).
    -> ctx [b, nkv, rep, hd] f32."""
    if not q.is_cuda:
        return packed_attention_decode_plain(
            q, k_codes_t, k_scales_t, v_codes, v_scales, positions, bs_k, bs_v,
            prob_q)
    b, nkv, rep, hd = q.shape
    out = _launch_attention(
        "packed_attention_decode_cuda", q, k_codes_t, k_scales_t, v_codes,
        v_scales, positions, nkv, rep, hd, v_codes.shape[2], bs_k, bs_v, prob_q)
    packed_attention_decode_cuda.launches += 1
    return out.reshape(b, nkv, rep, hd)


packed_attention_decode_batch_cuda.launches = 0
packed_attention_decode_cuda.launches = 0


def packed_attention_decode_dense(qg, k_all_t, v_all, positions_b, prob_quantizer=None):
    """The dense route of a packed cache (``packed_decode_route``):
    ``attend_dense`` on its dequantized codes, as the JAX package decodes
    outside ``attention_kernel_ok``. No kernel: its layer calls are counted
    in ``calls``, beside the kernels' launches, so that a run shows its
    route."""
    packed_attention_decode_dense.calls += 1
    return attend_dense(qg, k_all_t, v_all, positions_b, prob_quantizer)


packed_attention_decode_dense.calls = 0


def prob_q_spec(mm1_cfg: dict, max_len: int):
    """(bs, width, exp_width, exp_bias) of one layer's prob quantizer, or
    None for a bypass data_in. Raises ValueError when the layer cannot use
    the kernels (non-block_fp probs, width > 9, a block that does not tile
    max_len, or a non-power-of-two block)."""
    if mm1_cfg.get("bypass", False):
        return None
    if mm1_cfg.get("name") != "block_fp" or mm1_cfg.get("data_in_width", 99) > 9:
        raise ValueError(f"matmul_1 data_in not kernel-eligible: {mm1_cfg}")
    bs = effective_block_len(mm1_cfg["data_in_block_size"], max_len)
    if bs is None or max_len % bs != 0:
        raise ValueError(
            f"prob block {mm1_cfg['data_in_block_size']} does not tile "
            f"max_len {max_len}"
        )
    if bs & (bs - 1):
        raise ValueError(f"prob block {bs} is not a power of two")
    return (
        bs,
        mm1_cfg["data_in_width"],
        mm1_cfg.get("data_in_exponent_width", 8),
        mm1_cfg.get("data_in_exponent_bias"),
    )


def _prob_q_error(config, max_len: int) -> str | None:
    if config.quant_config is None:
        return None
    try:
        for i in range(config.num_hidden_layers):
            prob_q_spec(
                config.quant_config[f"model_layer_{i}"]["self_attn"]["matmul_1"], max_len
            )
    except (ValueError, KeyError) as e:
        return f"prob quantizer: {e}"
    return None


def attention_kernel_error(config, max_len: int, pos_major: bool,
                           blocks: tuple[int, int]) -> str | None:
    """Why the packed decode-attention kernels cannot serve this config at
    this cache length, or None when every layer can decode through the
    kernel of its cache's layout. The cache's maker states the layout:
    ``pos_major`` (K4, else K5) and its K/V ``blocks`` (bs_k, bs_v)."""
    rep = config.num_attention_heads // config.num_key_value_heads
    return (kernel_shape_error(rep, config.head_dim)
            or kernel_block_error(config.head_dim, *blocks)
            or kernel_tiles_error(config.num_key_value_heads, rep, config.head_dim, max_len,
                                  pos_major, blocks)
            or _prob_q_error(config, max_len))


def reference_kernel_error(config, max_len: int) -> str | None:
    """Why the JAX package's decode-attention kernel refuses this config at
    this cache length (its ``attention_kernel_ok`` is False), or None."""
    rep = config.num_attention_heads // config.num_key_value_heads
    if max_len * config.head_dim > _REFERENCE_MAX_S_HD:
        return (f"a cache of {max_len} positions at head_dim {config.head_dim} passes "
                f"{_REFERENCE_MAX_S_HD} elements")
    if rep > _REP_MAX:
        return f"{rep} query rows per kv head (at most {_REP_MAX})"
    return _prob_q_error(config, max_len)


def packed_decode_route(config, max_len: int, pos_major: bool,
                        blocks: tuple[int, int]) -> str:
    """How ``decode_step`` attends over a packed cache of ``max_len``
    positions, of layout ``pos_major`` and K/V ``blocks``, under
    ``attn_kernel=None``, on either device: "kernel" where
    ``attention_kernel_error`` finds none of the kernels' limits passed
    (the wrappers launch K4/K5 on the card and compute their plain
    versions on the CPU); "dense" (``packed_attention_decode_dense``,
    counted in its ``calls``) where the JAX package's kernel refuses the
    cache too (``reference_kernel_error``), as its ``decode_step`` then
    decodes densely. The kernels take every cache that the JAX package's
    kernel takes; a cache that it takes and they refuse raises
    ValueError, as ``attn_kernel=True`` does on any cache they refuse
    (``models.llama.serving._uses_kernel``)."""
    error = attention_kernel_error(config, max_len, pos_major, blocks)
    if error is None:
        return "kernel"
    if reference_kernel_error(config, max_len):
        return "dense"
    raise ValueError(f"the decode-attention kernels refuse a packed cache that the JAX "
                     f"package's kernel takes ({error})")
