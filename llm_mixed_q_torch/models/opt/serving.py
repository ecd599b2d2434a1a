"""OPT serving: fixed-size quantized KV cache, decode step and generation
(counterpart of the JAX package's ``models/opt/serving.py``).

The cache is float32 [L, 2, b, heads, max_len, head_dim], allocated once
and updated IN PLACE (the JAX package returns a new cache from each step).
K/V are fake-quantized at append time, per token, along head_dim: K on
bmm_0's weight_* keys, V on bmm_1's. The linears go through
``quantized_linear`` -> ``bfp_matmul``, so packed weights decode through
the matmul kernels: K1 for ``pack_opt_params`` trees, K3 for lane-major
``PackedBFPSub`` weights. Decode attention is plain PyTorch over the float32
cache, as in the JAX package. JAX's ``jit`` and ``while_loop`` become plain
Python loops.
"""

from __future__ import annotations

from functools import partial

import torch

from ... import resolve_device
from ...ops.functions import make_entry_quantizer
from ...ops.linear import row_parallel_linear
from ...parallel import tp
from ..llama.serving import _as_index, _sample_fn, _scatter_, decode_loop
from ..llama.serving import _quantize_kv_append as _quantize_kv
from .configuration import OPTQuantizedConfig
from .modeling import (
    NEG_INF,
    _decoder_layer,
    _linear,
    _node_cfg,
    embed_tokens,
    final_hidden,
    lm_logits,
    opt_for_causal_lm,
)


def init_kv_cache(config: OPTQuantizedConfig, batch: int, max_len: int,
                  device=None) -> torch.Tensor:
    shape = (config.num_hidden_layers, 2, batch, tp.local(config.num_attention_heads),
             max_len, config.head_dim)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _attention_cached(params, hidden, cache_layer, positions, config, layer_idx,
                      quantize_weights):
    """One layer's decode attention over the fixed cache; ``positions`` [b]
    is each sequence's length before this token (its write offset)."""
    b, q_len, _ = hidden.shape  # q_len == 1
    nh, hd = tp.local(config.num_attention_heads), config.head_dim
    max_len = cache_layer.shape[3]
    qc = partial(_node_cfg, config.quant_config, layer_idx, "self_attn")
    # a position past the cache writes the last row, as the JAX package's
    # clamped dynamic_update_slice does (and every row is then valid)
    positions = positions.clamp(max=max_len - 1)

    hidden = tp.copy_to_group(hidden)

    def proj(name):
        out = _linear(params[name], hidden, qc(name), quantize_weights)
        return out.reshape(b, q_len, nh, hd).transpose(1, 2)

    q = proj("q_proj") * (hd**-0.5)  # scaled before the bmm_0 quantizer
    kq, vq = _quantize_kv(proj("k_proj"), proj("v_proj"), qc("bmm_0"), qc("bmm_1"))
    _scatter_(cache_layer[0], 2, positions, kq)
    _scatter_(cache_layer[1], 2, positions, vq)

    bmm0, bmm1 = qc("bmm_0"), qc("bmm_1")
    if not bmm0.get("bypass", False):
        q = make_entry_quantizer(bmm0, "data_in", skip_first_dim=True)(
            q.reshape(b * nh, q_len, hd)).reshape(b, nh, q_len, hd)
    scores = torch.matmul(q, cache_layer[0].transpose(2, 3))  # [b, nh, 1, max_len]
    valid = (torch.arange(max_len, device=hidden.device)[None, None, None, :]
             <= positions[:, None, None, None])
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    if not bmm1.get("bypass", False):
        probs = make_entry_quantizer(bmm1, "data_in", skip_first_dim=True)(
            probs.reshape(b * nh, q_len, max_len)).reshape(b, nh, q_len, max_len)
    ctx = torch.matmul(probs, cache_layer[1])
    ctx = ctx.transpose(1, 2).reshape(b, q_len, nh * hd)
    return row_parallel_linear(ctx, params["out_proj"], qc("out_proj"), quantize_weights)


@torch.no_grad()
def decode_step(params, token, cache, position, config: OPTQuantizedConfig,
                quantize_weights: bool = True):
    """One decode step -> logits [b, vocab]; ``cache`` is updated in place.
    ``position``: int or per-sequence [b]: the token's position index is its
    sequence's length so far (embedded at +2)."""
    b = token.shape[0]
    positions = torch.as_tensor(position, dtype=torch.int64, device=token.device)
    positions = positions.expand(b).contiguous() if positions.ndim == 0 else positions
    hidden = (embed_tokens(params, token)
              + params["embed_positions"]["weight"][positions + 2][:, None])
    for i, layer_params in enumerate(params["layers"]):
        attend = partial(_attention_cached, cache_layer=cache[i], positions=positions,
                         config=config, layer_idx=i, quantize_weights=quantize_weights)
        hidden = _decoder_layer(layer_params, hidden, config, i, quantize_weights, attend)
    return lm_logits(params, final_hidden(params, hidden, config)[:, 0])


@torch.no_grad()
def prefill_into_cache(params, input_ids, attention_mask, cache, config,
                       quantize_weights=True):
    """Full forward over the prompt; writes its quantized K/V into the cache
    (in place). -> (last-token logits [b, vocab], lengths [b])."""
    out = opt_for_causal_lm(params, input_ids, attention_mask, config=config,
                            quantize_weights=quantize_weights)
    for i, (k, v) in enumerate(out["past_kvs"]):
        qc = partial(_node_cfg, config.quant_config, i, "self_attn")
        kq, vq = _quantize_kv(k, v, qc("bmm_0"), qc("bmm_1"))
        s = k.shape[2]
        cache[i, 0, :, :, :s] = kq
        cache[i, 1, :, :, :s] = vq
    lengths = attention_mask.sum(dim=1)
    last_idx = (lengths - 1).clamp(min=0)
    logits = out["logits"][torch.arange(input_ids.shape[0], device=input_ids.device),
                           last_idx]
    return logits, lengths


@torch.no_grad()
def generate(params, config: OPTQuantizedConfig, input_ids, attention_mask=None,
             max_new_tokens: int = 32, max_len: int | None = None,
             quantize_weights: bool = True, eos_token_id: int | None = None,
             temperature: float = 0.0, top_k: int = 0, seed: int = 0, device=None):
    """Batched OPT generation over the fixed quantized KV cache.

    Right-padded ragged prompts use each sequence's true length (from the
    mask) for positions, cache offsets and masking, matching unbatched
    generation token for token. ``eos_token_id`` stops a sequence (its
    remaining slots hold EOS); ``temperature``/``top_k`` sample with a
    ``torch.Generator`` seeded from ``seed``. Runs on ``device`` (the card
    unless "cpu"); the parameters must already live there.
    -> tokens int32 [b, max_new_tokens]."""
    device = resolve_device(device)
    input_ids = _as_index(input_ids, device)
    b, prompt_len = input_ids.shape
    attention_mask = (torch.ones_like(input_ids) if attention_mask is None
                      else _as_index(attention_mask, device))
    if max_len is None:
        max_len = prompt_len + max_new_tokens
    cache = init_kv_cache(config, b, max_len, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    logits, lengths = prefill_into_cache(params, input_ids, attention_mask, cache,
                                         config, quantize_weights)
    return decode_loop(
        lambda last, positions: decode_step(params, last[:, None], cache, positions,
                                            config, quantize_weights),
        logits, lengths, max_new_tokens, eos_token_id,
        _sample_fn(temperature, top_k, generator))


def generate_greedy(params, config, input_ids, attention_mask=None,
                    max_new_tokens: int = 32, max_len: int | None = None,
                    quantize_weights: bool = True, device=None):
    return generate(params, config, input_ids, attention_mask, max_new_tokens, max_len,
                    quantize_weights, device=device)
