"""Chunked (blockwise) quantized attention, O(S * chunk) memory
(counterpart of the JAX package's ``ops/attention.py``).

Computes the same quantized attention as the naive path (quantized
matmul_0, float32 softmax, quantized probs, quantized matmul_1) one kv
chunk at a time, never holding more than [b, h, S, chunk] scores. The
reference quantizes the normalized probabilities, which a one-pass online
softmax cannot reproduce, so there are two passes: the first takes each
row's exact max and its online sum of exponentials, the second recomputes
each chunk's scores, forms the normalized probs, quantizes them and
accumulates p_q @ v. ``BLOCK_LOG_MATMUL_QUANTIZES_Y`` is bound from
``ops.functions`` at import, as the JAX package binds it: the switch here
is this module's own. Chunks are multiples of 16, so [1, 16] blocks on the
kv axis tile as in the naive path; fully masked positions get probs of
exactly 0, which the zero-preserving quantizers pass through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .functions import BLOCK_LOG_MATMUL_QUANTIZES_Y, _quantize_matmul_operand

NEG_INF = -1e9


def _q4(x, cfg, entry):
    """Quantize a rank-4 operand as ``quantized_matmul`` does: leading dims
    flattened to rank 3, blocks over the last two."""
    shape = x.shape
    return _quantize_matmul_operand(x.reshape((-1,) + tuple(shape[-2:])), cfg,
                                    entry).reshape(shape)


def _chunk_scores(qq, k_chunk, mask_chunk, mm0_cfg, sqrt_hd):
    """Quantized matmul_0 for one kv chunk, plus the mask: [..., S, chunk]
    float32 scores. Divides by sqrt_hd, as the naive path does."""
    kt = k_chunk.transpose(2, 3)  # [b, h, d, chunk]
    if not mm0_cfg.get("bypass", False) and (mm0_cfg["name"] != "block_log"
                                             or BLOCK_LOG_MATMUL_QUANTIZES_Y):
        kt = _q4(kt, mm0_cfg, "weight")
    s = torch.matmul(qq, kt) / sqrt_hd
    if mask_chunk is not None:
        s = torch.clamp_min(s + mask_chunk, NEG_INF)
    return s.to(torch.float32)


def chunked_quantized_attention(q, k, v, mask, mm0_cfg: dict, mm1_cfg: dict,
                                sqrt_hd: float, chunk: int = 512):
    """Drop-in for the naive quantized attention pair.

    q: [b, h, S, d]; k, v: [b, h, K, d]; mask: additive [b, 1, S, K] or
    None. Returns [b, h, S, d]. ``chunk`` must be a multiple of 16 (the
    kv-axis block of every shipped config) unless it covers all of K.
    """
    b, h, S, d = q.shape
    K = k.shape[2]
    chunk = min(chunk, K)
    if chunk % 16 and chunk != K:
        raise ValueError(f"chunk {chunk} does not keep the 16-wide block tiling")

    pad = (-K) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        if mask is None:
            mask = torch.zeros((b, 1, S, K), dtype=q.dtype, device=q.device)
        mask = F.pad(mask, (0, pad), value=NEG_INF)

    # the chunk-independent operand quantization
    qq = q if mm0_cfg.get("bypass", False) else _q4(q, mm0_cfg, "data_in")
    if not mm1_cfg.get("bypass", False) and (mm1_cfg["name"] != "block_log"
                                             or BLOCK_LOG_MATMUL_QUANTIZES_Y):
        v = _q4(v, mm1_cfg, "weight")  # [1, 16] blocks along d, a row each

    starts = range(0, K + pad, chunk)

    def scores(c0):
        mask_c = None if mask is None else mask[..., c0:c0 + chunk]
        return _chunk_scores(qq, k[:, :, c0:c0 + chunk], mask_c, mm0_cfg, sqrt_hd)

    # pass 1: each row's exact max and online sum of exp(s - m)
    m = torch.full((b, h, S), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, S), dtype=torch.float32, device=q.device)
    for c0 in starts:
        s = scores(c0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(dim=-1)
        m = m_new

    # pass 2: exact normalized probs a chunk -> quantize -> accumulate @ v
    ctx = torch.zeros((b, h, S, d), dtype=q.dtype, device=q.device)
    for c0 in starts:
        p = (torch.exp(scores(c0) - m[..., None]) / l[..., None]).to(q.dtype)
        if not mm1_cfg.get("bypass", False):
            p = _q4(p, mm1_cfg, "data_in")  # [1, 16] blocks along kv
        ctx = ctx + torch.matmul(p, v[:, :, c0:c0 + chunk])
    return ctx
