"""Serving: fixed-size KV cache, decode step, generation and continuous
batching (counterpart of the JAX package's ``models/llama/serving.py``).

The cache is allocated once at ``max_len`` and updated IN PLACE (the JAX
package returns a new cache from each step; in PyTorch the in-place write
saves a copy of the cache per step). K/V are quantized at append time, per
token, with blocks along head_dim.

``PackedKVCache`` holds int8 codes + f32 per-block scales in one of two
layouts, chosen exactly as the JAX package chooses them:

- pos-major (``nkv * max_len <= BATCH_KERNEL_MAX_LANES``): every array is
  flat [b, rows, S*nkv] with lane = pos*nkv + head, K and V both [hd, lanes];
  decode attention runs kernel K4;
- head-major: K [b, nkv, hd, S] (transposed), V [b, nkv, S, hd]; decode
  attention runs kernel K5.

``generate`` and ``ContinuousBatcher`` pack the cache whenever the quant
config permits (``kv_cache_pack_spec``), on either device, as the JAX
package does. ``decode_step`` and ``generate`` take the JAX package's
``attn_kernel``: True forces the kernel wrappers, False the dense route on
the packed codes, and None (the default) routes a packed cache by shape
(``packed_decode_route``), on either device: it calls the kernel wrappers
when every layer is within the kernels' limits (``attention_kernel_error``),
which launch K4/K5 on the card and compute their plain versions on the
CPU, and takes the dense path on the dequantized codes
(``packed_attention_decode_dense``, counted) where JAX's kernel refuses
the cache too, as JAX's ``decode_step`` does outside
``attention_kernel_ok``. K4/K5 take every cache that JAX's kernel takes.

Under tensor parallelism (``parallel.tp.spmd`` around a local tree from
``parallel.shard_params``) the caches hold this rank's kv heads, and their
layout and route follow the rank's count.
JAX's ``jit``, ``fori_loop`` and ``while_loop`` become plain Python loops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ... import resolve_device
from ...kernels.attention_decode import (
    BATCH_KERNEL_MAX_LANES,
    attend_dense,
    packed_attention_decode_batch_cuda,
    packed_attention_decode_cuda,
    attention_kernel_error,
    packed_attention_decode_dense,
    packed_decode_route,
    prob_q_spec,
)
from ...kernels.packing import bfp_decode_lastdim, bfp_encode_lastdim, effective_block_len
from ...ops.functions import make_entry_quantizer, quantized_apply_rotary_pos_emb
from ...ops.linear import row_parallel_linear
from ...parallel import tp
from .configuration import LlamaQuantizedConfig
from .modeling import (
    NEG_INF,
    _node_cfg,
    embed,
    llama_for_causal_lm,
    lm_logits,
    local_heads,
    mlp,
    project_qkv,
    rms_norm,
    rope_tables,
)


def init_kv_cache(config: LlamaQuantizedConfig, batch: int, max_len: int,
                  device=None) -> torch.Tensor:
    """Fake-quant f32 cache [L, 2, b, nkv, max_len, hd]."""
    shape = (config.num_hidden_layers, 2, batch, local_heads(config)[1], max_len,
             config.head_dim)
    return torch.zeros(shape, dtype=torch.float32, device=device)


class PackedKVCache(NamedTuple):
    k_codes: list  # L x int8 [b, hd, S*nkv] pos-major | [b, nkv, hd, S]
    k_scales: list  # L x f32 [b, hd//bs_k, S*nkv] | [b, nkv, hd//bs_k, S]
    v_codes: list  # L x int8 [b, hd, S*nkv] | [b, nkv, S, hd]
    v_scales: list  # L x f32 [b, hd//bs_v, S*nkv] | [b, nkv, S, hd//bs_v]
    bs_k: int
    bs_v: int
    pos_major: bool = True
    nkv: int = 0

    @property
    def max_len(self) -> int:
        s = self.v_codes[0].shape[2]
        return s // self.nkv if self.pos_major else s

    def layer(self, i):
        return (self.k_codes[i], self.k_scales[i], self.v_codes[i], self.v_scales[i])


def kv_cache_pack_spec(config: LlamaQuantizedConfig):
    """(bs_k, bs_v) if the KV cache can be stored packed, else None: every
    layer's matmul_0 / matmul_1 weight config is non-bypass block_fp with
    width <= 8 and a [1, bs] block dividing head_dim, uniform over layers."""
    if config.quant_config is None:
        return None
    hd = config.head_dim
    spec = []
    for which in ("matmul_0", "matmul_1"):
        sizes = set()
        for i in range(config.num_hidden_layers):
            try:
                cfg = _node_cfg(config.quant_config, i, "self_attn", which)
            except KeyError:
                return None
            if cfg.get("bypass", False) or cfg.get("name") != "block_fp":
                return None
            if cfg.get("weight_width", 0) > 8:
                return None
            bs = effective_block_len(cfg["weight_block_size"], hd)
            if bs is None or hd % bs != 0:
                return None
            sizes.add(bs)
        if len(sizes) != 1:
            return None
        spec.append(sizes.pop())
    return tuple(spec)


def packed_cache_layout(config: LlamaQuantizedConfig, max_len: int):
    """(pos_major, (bs_k, bs_v) or None) of the packed cache that
    ``init_packed_kv_cache`` makes at ``max_len`` by default: pos-major
    where this rank's ``nkv * max_len`` fits the lanes of K4."""
    nkv = local_heads(config)[1]
    return nkv * max_len <= BATCH_KERNEL_MAX_LANES, kv_cache_pack_spec(config)


def init_packed_kv_cache(config: LlamaQuantizedConfig, batch: int, max_len: int,
                         spec, device=None, pos_major: bool | None = None
                         ) -> PackedKVCache:
    """``pos_major`` None picks the layout by ``packed_cache_layout``; an
    admission's bucket cache passes the live cache's layout instead."""
    bs_k, bs_v = spec
    L = config.num_hidden_layers
    _, nkv, hd = local_heads(config)
    if pos_major is None:
        pos_major = packed_cache_layout(config, max_len)[0]

    def zeros(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)]

    if pos_major:
        lanes = max_len * nkv
        return PackedKVCache(
            zeros((batch, hd, lanes), torch.int8),
            zeros((batch, hd // bs_k, lanes), torch.float32),
            zeros((batch, hd, lanes), torch.int8),
            zeros((batch, hd // bs_v, lanes), torch.float32),
            bs_k, bs_v, True, nkv,
        )
    return PackedKVCache(
        zeros((batch, nkv, hd, max_len), torch.int8),
        zeros((batch, nkv, hd // bs_k, max_len), torch.float32),
        zeros((batch, nkv, max_len, hd), torch.int8),
        zeros((batch, nkv, max_len, hd // bs_v), torch.float32),
        bs_k, bs_v, False, nkv,
    )


def _encode_kv(x, cfg, bs):
    """Encode [b, h, s, d] on the matmul's weight_* keys."""
    return bfp_encode_lastdim(x, cfg["weight_width"],
                              cfg.get("weight_exponent_width", 8),
                              cfg.get("weight_exponent_bias"), bs)


def _quantize_kv_append(k, v, mm0_cfg, mm1_cfg):
    """Fake-quantize per-token K (matmul_0 weight keys) and V (matmul_1
    weight keys) along head_dim before caching."""

    def q(x, cfg):
        if cfg.get("bypass", False):
            return x
        b, h, s, d = x.shape
        quantizer = make_entry_quantizer(cfg, "weight", skip_first_dim=True)
        return quantizer(x.reshape(b * h * s, d)).reshape(b, h, s, d)

    return q(k, mm0_cfg), q(v, mm1_cfg)


def _scatter_(buf, dim, positions, new):
    """buf[..., positions[b], ...] = new along ``dim``, per batch row;
    ``new`` has extent 1 (or nkv lanes) along ``dim``."""
    shape = [1] * buf.ndim
    shape[0] = buf.shape[0]
    idx = positions.reshape(shape)
    if new.shape[dim] > 1:  # pos-major: nkv consecutive lanes per position
        lanes = torch.arange(new.shape[dim], device=buf.device)
        lane_shape = [1] * buf.ndim
        lane_shape[dim] = new.shape[dim]
        idx = idx * new.shape[dim] + lanes.reshape(lane_shape)
    buf.scatter_(dim, idx.expand(new.shape), new)


def _append_and_read(cache_layer, k, v, positions, mm0_cfg, mm1_cfg, pack_spec,
                     keep_packed=False, pos_major=False):
    """Write this step's K/V [b, nkv, 1, hd] at ``positions`` [b] into the
    layer's cache (in place) and read the full K/V back dequantized:
    K transposed [b, nkv, hd, max_len] for the packed cache, [b, nkv,
    max_len, hd] for the f32 one; V [b, nkv, max_len, hd]. With
    ``keep_packed`` nothing is read back (the kernels read the codes)."""
    if pack_spec is None:
        kq, vq = _quantize_kv_append(k, v, mm0_cfg, mm1_cfg)
        _scatter_(cache_layer[0], 2, positions, kq)
        _scatter_(cache_layer[1], 2, positions, vq)
        return cache_layer[0], cache_layer[1]
    bs_k, bs_v = pack_spec
    kc, ks, vc, vs = cache_layer
    k_codes, k_scales = _encode_kv(k, mm0_cfg, bs_k)  # [b, nkv, 1, hd/nb]
    v_codes, v_scales = _encode_kv(v, mm1_cfg, bs_v)
    if pos_major:
        # lanes pos*nkv .. pos*nkv + nkv - 1 hold position pos of every head
        nkv = k_codes.shape[1]
        for buf, new in ((kc, k_codes), (ks, k_scales), (vc, v_codes), (vs, v_scales)):
            _scatter_(buf, 2, positions, new[:, :, 0, :].transpose(1, 2))
        if keep_packed:
            return None, None
        b, hd, lanes = kc.shape
        s_len = lanes // nkv
        k_all_t = (
            (kc.to(torch.float32) * ks.repeat_interleave(bs_k, dim=1))
            .reshape(b, hd, s_len, nkv).permute(0, 3, 1, 2)
        )
        v_all = (
            (vc.to(torch.float32) * vs.repeat_interleave(bs_v, dim=1))
            .reshape(b, hd, s_len, nkv).permute(0, 3, 2, 1)
        )
        return k_all_t, v_all
    # head-major: K is cached transposed ([..., hd/nb, max_len])
    _scatter_(kc, 3, positions, k_codes.transpose(2, 3))
    _scatter_(ks, 3, positions, k_scales.transpose(2, 3))
    _scatter_(vc, 2, positions, v_codes)
    _scatter_(vs, 2, positions, v_scales)
    if keep_packed:
        return None, None
    k_all_t = kc.to(torch.float32) * ks.repeat_interleave(bs_k, dim=2)
    return k_all_t, bfp_decode_lastdim(vc, vs, bs_v)


def _attention_cached(params, hidden, cache_layer, positions, cos, sin, config,
                      layer_idx, quantize_weights, pack_spec=None,
                      use_kernel=False, pos_major=False):
    """One layer's decode attention. ``positions`` [b]: each sequence's
    length before this token (its write offset)."""
    b, q_len, _ = hidden.shape  # q_len == 1
    nh, nkv, hd = local_heads(config)
    if pack_spec is None:
        max_len = cache_layer.shape[3]
    elif pos_major:
        max_len = cache_layer[2].shape[2] // nkv
    else:
        max_len = cache_layer[2].shape[2]
    qc = partial(_node_cfg, config.quant_config, layer_idx, "self_attn")
    # a finished slot may sit at max_len: write, rotate and mask at the last
    # row, as the JAX package's clamped dynamic_update_slice does
    positions = positions.clamp(max=max_len - 1)

    q, k, v = project_qkv(params, hidden, config, layer_idx, quantize_weights)
    q, k = quantized_apply_rotary_pos_emb(q, k, cos, sin, positions[:, None],
                                          qc("rotary_positional_encoding"))

    k_all, v_all = _append_and_read(cache_layer, k, v, positions, qc("matmul_0"),
                                    qc("matmul_1"), pack_spec,
                                    keep_packed=use_kernel, pos_major=pos_major)

    mm0 = qc("matmul_0")
    if not mm0.get("bypass", False):
        qq = make_entry_quantizer(mm0, "data_in", skip_first_dim=True)
        q = qq(q.reshape(b * nh, q_len, hd)).reshape(b, nh, q_len, hd)
    rep = nh // nkv
    qg = q.reshape(b, nkv, rep * q_len, hd)

    if use_kernel:
        kc, ks, vc, vs = cache_layer
        prob_q = prob_q_spec(qc("matmul_1"), max_len)
        if pos_major:
            ctx = packed_attention_decode_batch_cuda(
                qg.reshape(b, nh, hd).contiguous(), kc, ks, vc, vs, positions,
                pack_spec[0], pack_spec[1], nkv=nkv, rep=rep, prob_q=prob_q)
        else:
            ctx = packed_attention_decode_cuda(
                qg.contiguous(), kc, ks, vc, vs, positions, pack_spec[0],
                pack_spec[1], prob_q=prob_q)
    else:
        mm1 = qc("matmul_1")
        pq = None
        if not mm1.get("bypass", False):
            pq = make_entry_quantizer(mm1, "data_in", skip_first_dim=True)
        if pack_spec is None:
            ctx = attend_dense(qg, k_all.transpose(2, 3), v_all, positions, pq)
        else:
            ctx = packed_attention_decode_dense(qg, k_all, v_all, positions, pq)
    ctx = ctx.reshape(b, nh, q_len, hd).transpose(1, 2).reshape(b, q_len, nh * hd)
    return row_parallel_linear(ctx, params["o_proj"], qc("o_proj"), quantize_weights)


def _uses_kernel(config, max_len: int, pos_major: bool, spec, attn_kernel) -> bool:
    """Whether decode attention reads a cache of ``max_len`` positions (packed
    with K/V blocks ``spec`` in layout ``pos_major``, or the float32 cache
    for ``spec`` None) through the kernel wrappers, by ``attn_kernel``: None
    routes by ``packed_decode_route``, False takes the dense route, True the
    wrappers. True raises ValueError on a float32 cache, as the JAX package
    does, and where ``attention_kernel_error`` refuses the cache, on either
    device: the JAX package would interpret its kernel off the TPU on some
    of these caches, the port holds the CPU to the card's limits."""
    if attn_kernel is None:
        return spec is not None and packed_decode_route(
            config, max_len, pos_major, spec) == "kernel"
    if not attn_kernel:
        return False
    if spec is None:
        raise ValueError("attn_kernel=True requires a packed KV cache")
    error = attention_kernel_error(config, max_len, pos_major, spec)
    if error is not None:
        raise ValueError(f"attn_kernel=True: the decode-attention kernels refuse this "
                         f"packed cache ({error})")
    return True


@torch.no_grad()
def decode_step(params, token, cache, position, config: LlamaQuantizedConfig,
                quantize_weights: bool = True, attn_kernel: bool | None = None):
    """One decode step -> logits [b, vocab]; ``cache`` is updated in place.

    ``position``: int or per-sequence [b] (ragged batches): each sequence's
    K/V lands at its own offset, RoPE uses its own position, attention
    masks beyond it. ``attn_kernel``: True forces the attention kernels
    (their plain versions on the CPU; a packed cache required), False the
    dense route on a packed cache's dequantized codes
    (``packed_attention_decode_dense``), None routes a packed cache by
    ``packed_decode_route``: through the kernels within their limits, else,
    where JAX's kernel refuses the cache too, through the dense route, on
    either device; True raises ValueError on a cache that the kernels
    refuse (``_uses_kernel``)."""
    packed = isinstance(cache, PackedKVCache)
    pack_spec = (cache.bs_k, cache.bs_v) if packed else None
    b = token.shape[0]
    device = token.device
    positions = torch.as_tensor(position, dtype=torch.int64, device=device)
    positions = positions.expand(b).contiguous() if positions.ndim == 0 else positions
    hidden = embed(params, token)
    max_len = cache.max_len if packed else cache.shape[4]
    use_kernel = _uses_kernel(config, max_len, packed and cache.pos_major, pack_spec,
                              attn_kernel)
    cos, sin = rope_tables(max_len, config.head_dim, config.rope_theta, device)
    for i, layer_params in enumerate(params["layers"]):
        residual = hidden
        h = rms_norm(hidden, layer_params["input_layernorm"]["weight"],
                     config.rms_norm_eps)
        h = _attention_cached(
            layer_params["self_attn"], h, cache.layer(i) if packed else cache[i],
            positions, cos, sin, config, i, quantize_weights, pack_spec,
            use_kernel, pos_major=packed and cache.pos_major)
        hidden = residual + h
        residual = hidden
        h = rms_norm(hidden, layer_params["post_attention_layernorm"]["weight"],
                     config.rms_norm_eps)
        hidden = residual + mlp(layer_params["mlp"], h, config, i, quantize_weights)
    hidden = rms_norm(hidden, params["norm"]["weight"], config.rms_norm_eps)
    return lm_logits(params, hidden[:, 0], config)


@torch.no_grad()
def prefill_into_cache(params, input_ids, attention_mask, cache, config,
                       quantize_weights=True):
    """Full forward over the prompt; writes its quantized K/V into the
    cache (in place). -> (last-token logits [b, vocab], lengths [b])."""
    out = llama_for_causal_lm(params, input_ids, attention_mask, config=config,
                              quantize_weights=quantize_weights)
    packed = isinstance(cache, PackedKVCache)
    for i, (k, v) in enumerate(out["past_kvs"]):
        qc = partial(_node_cfg, config.quant_config, i, "self_attn")
        s = k.shape[2]
        if packed:
            kc, ks = _encode_kv(k, qc("matmul_0"), cache.bs_k)  # [b, nkv, s, .]
            vc, vs = _encode_kv(v, qc("matmul_1"), cache.bs_v)
            if cache.pos_major:
                # flat [b, rows, s*nkv], lane = pos*nkv + head
                def flat(x):
                    b_, nk_, sp_, d_ = x.shape
                    return x.permute(0, 3, 2, 1).reshape(b_, d_, sp_ * nk_)

                news = (flat(kc), flat(ks), flat(vc), flat(vs))
                for bufs, new in zip(cache[:4], news):
                    bufs[i][:, :, : new.shape[2]] = new
            else:
                cache.k_codes[i][..., :s] = kc.transpose(2, 3)
                cache.k_scales[i][..., :s] = ks.transpose(2, 3)
                cache.v_codes[i][:, :, :s] = vc
                cache.v_scales[i][:, :, :s] = vs
        else:
            kq, vq = _quantize_kv_append(k, v, qc("matmul_0"), qc("matmul_1"))
            cache[i, 0, :, :, :s] = kq
            cache[i, 1, :, :, :s] = vq
    lengths = attention_mask.sum(dim=1)
    last_idx = (lengths - 1).clamp(min=0)
    logits = out["logits"][torch.arange(input_ids.shape[0], device=input_ids.device),
                           last_idx]
    return logits, lengths


def _sample_fn(temperature: float, top_k: int, generator):
    """logits [b, V] -> tokens [b]; temperature 0 = greedy."""
    if temperature <= 0.0:
        return lambda logits: torch.argmax(logits, dim=-1)

    def sample(logits):
        logits = logits / temperature
        if top_k:
            kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
            logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return sample


def _as_index(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


def _cache_spec(config, packed_kv):
    """(bs_k, bs_v) of a packed KV cache, or None for the float32 fake-quant
    cache. ``packed_kv`` None packs whenever the config permits, as the JAX
    package does, at any length and on either device."""
    if packed_kv is False:
        return None
    spec = kv_cache_pack_spec(config)
    if packed_kv is True and spec is None:
        raise ValueError("quant config does not permit a packed KV cache")
    return spec


def _new_cache(config, batch, max_len, spec, device, pos_major=None, attn_kernel=None):
    if spec is not None and pos_major is None:
        pos_major = packed_cache_layout(config, max_len)[0]
    _uses_kernel(config, max_len, pos_major, spec, attn_kernel)  # raises before any work
    if spec is not None:
        return init_packed_kv_cache(config, batch, max_len, spec, device, pos_major)
    return init_kv_cache(config, batch, max_len, device)


@torch.no_grad()
def generate(params, config: LlamaQuantizedConfig, input_ids, attention_mask=None,
             max_new_tokens: int = 32, max_len: int | None = None,
             quantize_weights: bool = True, packed_kv: bool | None = None,
             eos_token_id: int | None = None, temperature: float = 0.0,
             top_k: int = 0, seed: int = 0, attn_kernel: bool | None = None,
             device=None) -> np.ndarray:
    """Batched generation over the fixed-size quantized KV cache.

    Right-padded ragged prompts use each sequence's true length (from the
    mask) for RoPE, cache offsets and masking. ``eos_token_id`` stops a
    sequence (its remaining slots hold EOS); ``temperature``/``top_k``
    sample with a ``torch.Generator`` seeded from ``seed``. ``packed_kv``:
    True/False forces the packed / fake-quant cache, None picks as
    ``_cache_spec`` says. ``attn_kernel`` routes every decode step's
    attention as ``decode_step``'s does (checked before the prefill; the
    prefill attends densely). Runs on ``device`` (the card unless "cpu"); the
    parameters must already live there. -> tokens [b, max_new_tokens]."""
    device = resolve_device(device)
    input_ids = _as_index(input_ids, device)
    b, prompt_len = input_ids.shape
    attention_mask = (torch.ones_like(input_ids) if attention_mask is None
                      else _as_index(attention_mask, device))
    if max_len is None:
        max_len = prompt_len + max_new_tokens
    spec = _cache_spec(config, packed_kv)
    cache = _new_cache(config, b, max_len, spec, device, attn_kernel=attn_kernel)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    sample = _sample_fn(temperature, top_k, generator)

    logits, lengths = prefill_into_cache(params, input_ids, attention_mask, cache,
                                         config, quantize_weights)
    return decode_loop(
        lambda last, positions: decode_step(params, last[:, None], cache, positions,
                                            config, quantize_weights, attn_kernel),
        logits, lengths, max_new_tokens, eos_token_id, sample)


def generate_greedy(params, config: LlamaQuantizedConfig, input_ids, attention_mask=None,
                    max_new_tokens: int = 32, max_len: int | None = None,
                    quantize_weights: bool = True, packed_kv: bool | None = None,
                    device=None) -> np.ndarray:
    """Greedy decoding: ``generate`` at temperature 0, in the JAX
    package's positional order."""
    return generate(params, config, input_ids, attention_mask=attention_mask,
                    max_new_tokens=max_new_tokens, max_len=max_len,
                    quantize_weights=quantize_weights, packed_kv=packed_kv, device=device)


def decode_loop(step, logits, lengths, max_new_tokens: int, eos_token_id, sample
                ) -> np.ndarray:
    """Tokens after the prefill: ``step(last [b], positions [b])`` runs one
    decode step and returns its logits; token t's input lands at cache
    offset lengths + t - 1. A sequence stops at its first EOS and holds EOS
    from there on; the loop ends when all have stopped.
    -> int32 [b, max_new_tokens]."""
    eos = -1 if eos_token_id is None else eos_token_id
    last = sample(logits)
    done = last == eos
    tokens = torch.full((logits.shape[0], max_new_tokens), eos, dtype=torch.int64,
                        device=logits.device)
    tokens[:, 0] = last
    for t in range(1, max_new_tokens):
        if eos_token_id is not None and tp.everywhere(bool(done.all())):
            break  # the remaining columns already hold EOS (on every data slice)
        nxt = sample(step(last, lengths + (t - 1)))
        if eos_token_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            done = done | (nxt == eos)
        tokens[:, t] = nxt
        last = nxt
    return tokens.cpu().numpy().astype(np.int32)


class ContinuousBatcher:
    """Slot-based continuous batching over one fixed cache.

    ``num_slots`` sequences decode together; finished slots are freed and
    refilled from the queue between decode chunks. Admission prefills every
    admissible request in ONE batch of ``num_slots`` rows (prompts padded to
    the largest bucket) and writes their K/V into their slots. Decode runs
    up to ``decode_chunk`` steps per host round trip; per-slot counters stop
    a finished slot (its position stops and its tokens read -1).
    ``warmup()`` runs every bucket's admission and a decode chunk once on
    throwaway caches, before serving."""

    def __init__(self, params, config: LlamaQuantizedConfig, num_slots: int = 8,
                 max_len: int = 512, quantize_weights: bool = True,
                 eos_token_id: int | None = None, max_new_tokens: int = 64,
                 prompt_bucket: int = 32, packed_kv: bool | None = None,
                 decode_chunk: int = 16, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.num_slots = num_slots
        self.max_len = max_len
        self.quantize_weights = quantize_weights
        self.eos_token_id = eos_token_id
        self.max_new_tokens = max_new_tokens
        self.prompt_bucket = prompt_bucket
        self.decode_chunk = max(1, decode_chunk)
        spec = _cache_spec(config, packed_kv)
        self._spec = spec
        self.cache = _new_cache(config, num_slots, max_len, spec, self.device)
        self._positions = torch.zeros(num_slots, dtype=torch.int64, device=self.device)
        self._last_tok = torch.zeros(num_slots, dtype=torch.int64, device=self.device)
        self._pos_host = np.zeros(num_slots, dtype=np.int64)
        self._req = [None] * num_slots  # request id per slot
        self._emitted = {}
        self._queue = []  # (request_id, prompt list[int])
        self._next_id = 0
        self._done = {}

    def submit(self, prompt_ids) -> int:
        prompt = [int(t) for t in np.asarray(prompt_ids)]
        if not 0 < len(prompt) < self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens: it must be non-empty "
                             f"and shorter than max_len ({self.max_len})")
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, prompt))
        self._emitted[rid] = []
        return rid

    def _bucket_cache(self, bucket):
        """A cache of ``num_slots`` rows and ``bucket`` positions in the live
        cache's layout, whatever its length would pick: a pos-major bucket
        cannot be copied into head-major slots (ROADMAP fault 4)."""
        return _new_cache(self.config, self.num_slots, bucket, self._spec, self.device,
                          self._spec is not None and self.cache.pos_major)

    def _write_slots(self, cache, tmp, rows, slots):
        """Copy admission rows ``rows`` of the bucket cache ``tmp`` into
        ``slots`` of ``cache``; empty ``rows`` and ``slots`` write nothing."""
        if self._spec is None:
            extent = tmp.shape[4]
            cache[:, :, slots, :, :extent] = tmp[:, :, rows]
            return
        for bufs, news in zip(cache[:4], tmp[:4]):
            for buf, new in zip(bufs, news):
                idx = (slots,) + tuple(slice(0, e) for e in new.shape[1:])
                buf[idx] = new[rows]

    def _zero_cache(self):
        """A zero cache of the live cache's shapes and layout."""
        if self._spec is None:
            return torch.zeros_like(self.cache)
        return self.cache._replace(**{
            f: [torch.zeros_like(t) for t in getattr(self.cache, f)]
            for f in ("k_codes", "k_scales", "v_codes", "v_scales")})

    @torch.no_grad()
    def warmup(self, buckets=None):
        """Run once, on throwaway caches, what serving runs: the admission
        prefill and slot write of each prompt bucket (``buckets``, default
        the whole ladder ``prompt_bucket, 2 * prompt_bucket, ..`` up to
        ``max_len``) and one decode chunk, so that first-use costs (the
        kernel libraries' load, library handles, the allocator's growth)
        land here and not in the middle of serving. The write takes an
        empty slot list, as the JAX package's takes an out-of-range slot,
        and the chunk runs with no active slot on a zero copy of the live
        cache: the live cache, positions, tokens and queue do not change."""
        if buckets is None:
            buckets = range(self.prompt_bucket, self.max_len + 1, self.prompt_bucket)
        scratch = self._zero_cache()
        none = torch.zeros(0, dtype=torch.int64, device=self.device)
        for bucket in buckets:
            bucket = min(bucket, self.max_len)
            ids = torch.zeros((self.num_slots, bucket), dtype=torch.int64, device=self.device)
            tmp = self._bucket_cache(bucket)
            prefill_into_cache(self.params, ids, torch.ones_like(ids), tmp, self.config,
                               self.quantize_weights)
            self._write_slots(scratch, tmp, none, none)
        self._chunk(torch.zeros(self.num_slots, dtype=torch.int64, device=self.device), 1,
                    scratch, self._last_tok, self._positions)

    def _admit(self):
        """Fill free slots from the queue with one batched prefill."""
        free = [s for s in range(self.num_slots) if self._req[s] is None]
        take = min(len(free), len(self._queue))
        if take == 0:
            return
        grp = []
        for slot in free[:take]:
            rid, prompt = self._queue.pop(0)
            grp.append((slot, rid, prompt))
        bucket = max(-(-len(p) // self.prompt_bucket) * self.prompt_bucket
                     for _, _, p in grp)
        bucket = min(bucket, self.max_len)
        S = self.num_slots
        ids = np.zeros((S, bucket), dtype=np.int64)
        # padding rows attend to one position, so no row is fully masked
        mask = np.zeros((S, bucket), dtype=np.int64)
        mask[:, 0] = 1
        for i, (_, _, prompt) in enumerate(grp):
            ids[i, : len(prompt)] = prompt
            mask[i, : len(prompt)] = 1
        tmp = self._bucket_cache(bucket)
        logits, _ = prefill_into_cache(
            self.params, torch.as_tensor(ids, device=self.device),
            torch.as_tensor(mask, device=self.device), tmp, self.config,
            self.quantize_weights)
        toks = torch.argmax(logits, dim=-1)
        rows = torch.arange(len(grp), device=self.device)
        slots = torch.as_tensor([s for s, _, _ in grp], device=self.device)
        self._write_slots(self.cache, tmp, rows, slots)
        self._last_tok[slots] = toks[rows]
        self._positions[slots] = torch.as_tensor(
            [len(p) for _, _, p in grp], device=self.device)
        first = toks.cpu().numpy()  # the admission's one host sync
        for i, (slot, rid, prompt) in enumerate(grp):
            self._req[slot] = rid
            self._pos_host[slot] = len(prompt)
            self._emit(slot, int(first[i]))

    def _emit(self, slot, tok):
        rid = self._req[slot]
        self._emitted[rid].append(tok)
        hit_eos = self.eos_token_id is not None and tok == self.eos_token_id
        if hit_eos or len(self._emitted[rid]) >= self.max_new_tokens:
            self._done[rid] = self._emitted[rid]
            self._req[slot] = None

    @torch.no_grad()
    def _chunk(self, rem, n, cache, last, pos):
        """``n`` decode steps on ``cache`` from tokens ``last`` at positions
        ``pos``; inactive slots (rem == 0) keep their position and token,
        and their buffer entries are -1. -> (buffer, last, pos)."""
        eos = -1 if self.eos_token_id is None else self.eos_token_id
        buf = torch.full((self.num_slots, n), -1, dtype=torch.int64, device=self.device)
        for t in range(n):
            active = rem > 0
            logits = decode_step(self.params, last[:, None], cache, pos,
                                 self.config, self.quantize_weights)
            nxt = torch.where(active, torch.argmax(logits, dim=-1), last)
            buf[:, t] = torch.where(active, nxt, torch.full_like(nxt, -1))
            pos = pos + active.to(pos.dtype)
            rem = (rem - active.to(rem.dtype)).clamp(min=0)
            if self.eos_token_id is not None:
                rem = torch.where(active & (nxt == eos), torch.zeros_like(rem), rem)
            last = nxt
        return buf, last, pos

    def step(self) -> bool:
        """Admit, decode up to ``decode_chunk`` tokens for every active slot,
        harvest the chunk with one host sync. False when idle."""
        self._admit()
        rem = np.zeros(self.num_slots, dtype=np.int64)
        for slot, rid in enumerate(self._req):
            if rid is None:
                continue
            want = self.max_new_tokens - len(self._emitted[rid])
            # a decode at position p writes row p: cap the quota at max_len
            room = self.max_len - self._pos_host[slot]
            rem[slot] = max(0, min(want, room))
            if rem[slot] == 0:
                self._done[rid] = self._emitted[rid]
                self._req[slot] = None
        active = rem[rem > 0]
        if active.size == 0:
            return False
        # with requests waiting, stop at the first slot to free up
        n = int(min(active) if self._queue else max(active))
        n = min(n, self.decode_chunk)
        buf, self._last_tok, self._positions = self._chunk(
            torch.as_tensor(rem, device=self.device), n, self.cache, self._last_tok,
            self._positions)
        buf = buf.cpu().numpy()
        for t in range(n):
            for slot in range(self.num_slots):
                tok = int(buf[slot, t])
                if tok < 0 or self._req[slot] is None:
                    continue
                self._pos_host[slot] += 1
                self._emit(slot, tok)
        return True

    def run(self) -> dict[int, list[int]]:
        """Drive until every submitted request has finished."""
        while self.step() or self._queue:
            pass
        return dict(self._done)
