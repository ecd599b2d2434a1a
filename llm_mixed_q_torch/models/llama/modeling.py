"""Quantized Llama in PyTorch (counterpart of the JAX package's
``models/llama/modeling.py``): plain functions over a parameter dict, with
weights in the torch ``[out, in]`` layout.

Numerics follow the reference: RMSNorm variance in float32; RoPE cos/sin
tables quantized per the rope node, rotation in full precision; quantized
matmul_0 = q @ k^T, then / sqrt(head_dim); additive causal + padding mask
clamped at finfo.min; float32 softmax; quantized matmul_1 = probs @ v.
GQA repeats the kv heads. With ``config.attention_chunk`` set, attention
takes the kv-chunked two-pass path (``ops/attention.py``): the same
quantized attention in O(S * chunk) memory, for long contexts.

``past_kvs`` (the float k/v of earlier tokens) makes the causal LM
incremental: ``models/api.py:make_prefill_and_decode``.

Under tensor parallelism (``parallel/tp.py``, a local tree from
``parallel.shard_params``) a rank runs ``heads / tp`` heads: q/k/v and
gate/up column-parallel, o_proj and down_proj row-parallel, the embedding
vocab-parallel, lm_head and score column-parallel with their logits
gathered.

Heads: causal LM and sequence classification. ``remat=True`` recomputes
each decoder layer in the backward pass (``torch.utils.checkpoint``)
instead of keeping its activations.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.attention import chunked_quantized_attention
from ...ops.functions import quantized_apply_rotary_pos_emb, quantized_matmul
from ...ops.linear import quantized_linear, row_parallel_linear
from ...parallel import tp
from .configuration import LlamaQuantizedConfig

NEG_INF = float(np.finfo(np.float32).min)

_BYPASS = {"bypass": True, "name": "integer"}


def _node_cfg(quant_config, layer_idx: int, group: str, name: str) -> dict:
    if quant_config is None:
        return _BYPASS
    return quant_config[f"model_layer_{layer_idx}"][group][name]


def rms_norm(x, weight, eps: float):
    input_dtype = x.dtype
    xf = x.to(torch.float32)
    variance = xf.square().mean(dim=-1, keepdim=True)
    return (weight * (xf * torch.rsqrt(variance + eps))).to(input_dtype)


def rope_tables(seq_len: int, head_dim: int, base: float, device=None,
                dtype=torch.float32):
    """cos/sin [seq_len, head_dim], computed in numpy float32 as the JAX
    package does."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(seq_len, dtype=np.float32)
    emb = np.concatenate([np.outer(t, inv_freq)] * 2, axis=-1)
    return (torch.as_tensor(np.cos(emb), dtype=dtype, device=device),
            torch.as_tensor(np.sin(emb), dtype=dtype, device=device))


def make_causal_mask(attention_mask, q_len: int, kv_len: int, past_len: int = 0,
                     device=None):
    """Additive mask [b, 1, q, kv]: 0 where attendable, finfo.min otherwise;
    queries sit at the end of the kv axis."""
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device).tril(past_len)
    ok = ok[None, None]
    if attention_mask is not None:
        ok = ok & attention_mask[:, None, None, :].to(torch.bool)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _repeat_kv(x, n_rep: int):
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def local_heads(config) -> tuple[int, int, int]:
    """(query heads, kv heads, head_dim) of this rank (all of them outside
    tensor parallelism)."""
    return (tp.local(config.num_attention_heads), tp.local(config.num_key_value_heads),
            config.head_dim)


def project_qkv(params, hidden, config, layer_idx, quantize_weights, name_nodes=False):
    """q [b, nh, s, hd], k and v [b, nkv, s, hd] (fused or separate nodes).
    ``name_nodes``: the separate nodes report to the stat tap (the full
    forward's, not the decode step's, as in the JAX package)."""
    b, q_len, _ = hidden.shape
    nh, nkv, hd = local_heads(config)
    qc = partial(_node_cfg, config.quant_config, layer_idx, "self_attn")

    def heads(out, nheads):
        return out.reshape(b, q_len, nheads, hd).transpose(1, 2)

    hidden = tp.copy_to_group(hidden)  # the input of column-parallel nodes
    if "qkv_proj" in params:
        # fused packed projection: member configs are identical, so
        # q_proj's config speaks for all three
        node = params["qkv_proj"]
        fused = quantized_linear(hidden, node["weight"], node.get("bias"),
                                 qc("q_proj"), quantize_weights)
        nq, nk, _ = node["splits"]
        return (heads(fused[..., :nq], nh), heads(fused[..., nq:nq + nk], nkv),
                heads(fused[..., nq + nk:], nkv))

    def proj(name, nheads):
        node = params[name]
        node_name = f"model_layer_{layer_idx}:self_attn:{name}" if name_nodes else None
        return heads(quantized_linear(hidden, node["weight"], node.get("bias"),
                                      qc(name), quantize_weights, node_name), nheads)

    return proj("q_proj", nh), proj("k_proj", nkv), proj("v_proj", nkv)


def attention(params, hidden, mask, position_ids, cos, sin,
              config: LlamaQuantizedConfig, layer_idx: int,
              quantize_weights: bool, past_kv=None):
    b, q_len, _ = hidden.shape
    nh, nkv, hd = local_heads(config)
    qc = partial(_node_cfg, config.quant_config, layer_idx, "self_attn")
    q, k, v = project_qkv(params, hidden, config, layer_idx, quantize_weights,
                          name_nodes=True)
    q, k = quantized_apply_rotary_pos_emb(
        q, k, cos, sin, position_ids, qc("rotary_positional_encoding"))
    if past_kv is not None:
        k = torch.cat([past_kv[0], k], dim=2)
        v = torch.cat([past_kv[1], v], dim=2)
    new_kv = (k, v)

    k = _repeat_kv(k, nh // nkv)
    v = _repeat_kv(v, nh // nkv)
    if config.attention_chunk:
        out = chunked_quantized_attention(q, k, v, mask, qc("matmul_0"), qc("matmul_1"),
                                          sqrt_hd=math.sqrt(hd), chunk=config.attention_chunk)
    else:
        attn = quantized_matmul(q, k.transpose(2, 3), qc("matmul_0")) / math.sqrt(hd)
        if mask is not None:
            attn = torch.clamp_min(attn + mask, NEG_INF)
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(q.dtype)
        out = quantized_matmul(attn, v, qc("matmul_1"))
    out = out.transpose(1, 2).reshape(b, q_len, nh * hd)
    out = row_parallel_linear(out, params["o_proj"], qc("o_proj"), quantize_weights,
                              f"model_layer_{layer_idx}:self_attn:o_proj")
    return out, new_kv


def mlp(params, hidden, config, layer_idx: int, quantize_weights: bool):
    """The MLP; its separate nodes and down_proj report to the stat tap,
    also from the decode step, as in the JAX package."""
    qc = partial(_node_cfg, config.quant_config, layer_idx, "mlp")
    nn = lambda name: f"model_layer_{layer_idx}:mlp:{name}"
    hidden = tp.copy_to_group(hidden)  # the input of column-parallel nodes
    if "gate_up_proj" in params:
        node = params["gate_up_proj"]
        gu = quantized_linear(hidden, node["weight"], node.get("bias"),
                              qc("gate_proj"), quantize_weights)
        gate, up = gu[..., : node["splits"][0]], gu[..., node["splits"][0]:]
    else:
        gate = quantized_linear(hidden, params["gate_proj"]["weight"], None,
                                qc("gate_proj"), quantize_weights, nn("gate_proj"))
        up = quantized_linear(hidden, params["up_proj"]["weight"], None,
                              qc("up_proj"), quantize_weights, nn("up_proj"))
    return row_parallel_linear(F.silu(gate) * up, params["down_proj"], qc("down_proj"),
                               quantize_weights, nn("down_proj"))


def decoder_layer(params, hidden, mask, position_ids, cos, sin, config,
                  layer_idx: int, quantize_weights: bool, past_kv=None):
    residual = hidden
    h = rms_norm(hidden, params["input_layernorm"]["weight"], config.rms_norm_eps)
    h, new_kv = attention(params["self_attn"], h, mask, position_ids, cos, sin,
                          config, layer_idx, quantize_weights, past_kv)
    hidden = residual + h
    residual = hidden
    h = rms_norm(hidden, params["post_attention_layernorm"]["weight"],
                 config.rms_norm_eps)
    h = mlp(params["mlp"], h, config, layer_idx, quantize_weights)
    return residual + h, new_kv


def embed(params, input_ids):
    # a bf16 table (pack_llama_params(bf16_embed=True)) upcasts at the lookup
    return tp.vocab_parallel_embed(params["embed_tokens"]["weight"], input_ids).to(torch.float32)


def lm_logits(params, hidden, config):
    """Logits in float32. A bf16 table rounds hidden to bf16 first; the
    products of two bf16 values are exact in float32, so the product runs
    in float32 (the JAX package's bf16 dot with float32 accumulation)."""
    name = "embed_tokens" if config.tie_word_embeddings else "lm_head"
    lm_w = params.get(name, params["embed_tokens"])["weight"]
    if lm_w.dtype != torch.float32:
        hidden = hidden.to(lm_w.dtype)
    hidden = tp.copy_to_group(hidden.to(torch.float32))
    return tp.gather_from_group(torch.matmul(hidden, lm_w.to(torch.float32).t()))


def llama_model(params, input_ids, attention_mask, config: LlamaQuantizedConfig,
                quantize_weights: bool = True, position_ids=None, past_kvs=None,
                remat: bool = False):
    """Backbone forward -> (final hidden [b, s, h], per-layer (k, v)).
    ``past_kvs``: per-layer float (k, v) [b, nkv, past, hd] of the earlier
    tokens; the new tokens sit at positions past .. past + s - 1, and the
    returned caches hold all of them. ``attention_mask`` then covers the
    past and the new tokens, [b, past + s]."""
    b, q_len = input_ids.shape
    device = input_ids.device
    past_len = 0 if past_kvs is None else past_kvs[0][0].shape[2]
    kv_len = past_len + q_len
    hidden = embed(params, input_ids)
    if position_ids is None:
        position_ids = torch.arange(past_len, kv_len, device=device)[None, :].expand(b, q_len)
    cos, sin = rope_tables(kv_len, config.head_dim, config.rope_theta, device)
    if attention_mask is None:
        attention_mask = torch.ones((b, kv_len), dtype=torch.int32, device=device)
    mask = make_causal_mask(attention_mask, q_len, kv_len, past_len, device=device)
    layer_fn = partial(checkpoint, decoder_layer, use_reentrant=False) if remat else decoder_layer
    new_kvs = []
    for i, layer_params in enumerate(params["layers"]):
        past = None if past_kvs is None else past_kvs[i]
        hidden, new_kv = layer_fn(layer_params, hidden, mask, position_ids,
                                  cos, sin, config, i, quantize_weights, past)
        new_kvs.append(new_kv)
    hidden = rms_norm(hidden, params["norm"]["weight"], config.rms_norm_eps)
    return hidden, new_kvs


def llama_for_causal_lm(params, input_ids, attention_mask=None, labels=None,
                        config: LlamaQuantizedConfig = None,
                        quantize_weights: bool = True, position_ids=None,
                        past_kvs=None, remat: bool = False):
    """-> dict(logits=[b, s, vocab] float32, past_kvs=[(k, v)], loss=...)."""
    hidden, new_kvs = llama_model(params, input_ids, attention_mask, config,
                                  quantize_weights, position_ids, past_kvs, remat)
    out = {"logits": lm_logits(params, hidden, config), "past_kvs": new_kvs}
    if labels is not None:
        out["loss"] = causal_lm_loss(out["logits"], labels)
    return out


def causal_lm_loss(logits, labels, ignore_index: int = -100):
    """Shifted cross-entropy."""
    return F.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]).to(torch.float32),
        labels[:, 1:].reshape(-1).long(), ignore_index=ignore_index)


def pooled_index(input_ids, pad_token_id):
    """The row each sequence is pooled at: the count of its non-pad ids
    less one, clamped at 0 (a count, not the last non-pad position: a pad
    id inside a sequence moves it), or the last position when the model
    has no pad id."""
    b, s = input_ids.shape
    if pad_token_id is None:
        return torch.full((b,), s - 1, dtype=torch.int64, device=input_ids.device)
    return ((input_ids != pad_token_id).sum(-1) - 1).clamp_min(0)


def sequence_classification_head(params, hidden, input_ids, labels, config):
    """``score`` on every position, pooled at ``pooled_index``; the loss is
    the MSE for one label (regression), else the float32 cross-entropy."""
    logits = tp.gather_from_group(torch.matmul(tp.copy_to_group(hidden),
                                               params["score"]["weight"].t()))
    rows = torch.arange(input_ids.shape[0], device=input_ids.device)
    pooled = logits[rows, pooled_index(input_ids, config.pad_token_id)]
    out = {"logits": pooled}
    if labels is not None:
        if config.num_labels == 1:
            out["loss"] = (pooled.squeeze(-1) - labels).square().mean()
        else:
            out["loss"] = F.cross_entropy(pooled.to(torch.float32), labels.long())
    return out


def llama_for_sequence_classification(params, input_ids, attention_mask=None, labels=None,
                                      config: LlamaQuantizedConfig = None,
                                      quantize_weights: bool = True):
    """-> dict(logits=[b, num_labels] float32, loss=...)."""
    hidden, _ = llama_model(params, input_ids, attention_mask, config, quantize_weights)
    return sequence_classification_head(params, hidden, input_ids, labels, config)
