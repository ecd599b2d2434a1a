"""Quantized OPT in PyTorch (counterpart of the JAX package's
``models/opt/modeling.py``): plain functions over a parameter dict, weights
in the torch ``[out, in]`` layout.

Numerics follow the reference: learned positional embedding indexed by
cumsum(attention_mask) * mask - 1 with the +2 offset; q scaled by
head_dim**-0.5 BEFORE the bmm_0 quantizer; bmm_0 / bmm_1 on rank-3
[b*heads, t, d] operands (so block quantizers take the 3-D activation
path); additive mask clamped at finfo(float32).min; float32 softmax;
pre- or post-LN per ``do_layer_norm_before``; optional project_in/out.

``ACT2FN["gelu"]`` is the tanh approximation, as the JAX package's
``jax.nn.gelu`` default has it (the reference's transformers mapping uses
the exact erf GELU there; the port follows the JAX package).

Under tensor parallelism (``parallel/tp.py``, a local tree from
``parallel.shard_params``) a rank runs ``heads / tp`` heads: q/k/v and fc1
column-parallel, out_proj and fc2 row-parallel, the embedding
vocab-parallel and the logits gathered.

Heads: causal LM, sequence classification (``score`` on the
``word_embed_proj_dim``-wide output, pooled at ``pooled_index``) and span
question answering (``qa_outputs``).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.functions import quantized_matmul
from ...ops.linear import quantized_linear, row_parallel_linear
from ...parallel import tp
from ..llama.modeling import causal_lm_loss, make_causal_mask, sequence_classification_head
from .configuration import OPTQuantizedConfig

NEG_INF = float(np.finfo(np.float32).min)
_BYPASS = {"bypass": True, "name": "integer"}

ACT2FN = {
    "relu": F.relu,
    "gelu": partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
    "gelu_new": partial(F.gelu, approximate="tanh"),
}


def _node_cfg(quant_config, layer_idx: int, *path) -> dict:
    if quant_config is None:
        return _BYPASS
    node = quant_config[f"model_layer_{layer_idx}"]
    for p in path:
        node = node[p]
    return node


def layer_norm(x, weight, bias, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y


def _ln(node, x):
    return layer_norm(x, node.get("weight"), node.get("bias"))


def opt_learned_positional_embedding(weight, attention_mask, past_len: int = 0):
    """positions = cumsum(mask) * mask - 1, from ``past_len`` on, +2 offset."""
    mask = attention_mask.to(torch.int64)
    positions = torch.cumsum(mask, dim=1) * mask - 1
    return weight[positions[:, past_len:] + 2]


def _linear(node, x, cfg, quantize_weights, node_name=None):
    return quantized_linear(x, node["weight"], node.get("bias"), cfg, quantize_weights,
                            node_name)


def opt_attention(params, hidden, mask, config: OPTQuantizedConfig, layer_idx: int,
                  quantize_weights: bool, past_kv=None):
    """-> (output [b, t, hidden], (k, v) [b, heads, kv_len, head_dim])."""
    b, q_len, _ = hidden.shape
    nh, hd = tp.local(config.num_attention_heads), config.head_dim
    qc = partial(_node_cfg, config.quant_config, layer_idx, "self_attn")
    hidden = tp.copy_to_group(hidden)  # the input of column-parallel nodes

    def proj(name):
        out = _linear(params[name], hidden, qc(name), quantize_weights,
                      f"model_layer_{layer_idx}:self_attn:{name}")
        return out.reshape(b, q_len, nh, hd).transpose(1, 2)

    q = proj("q_proj") * (hd**-0.5)  # scaled before the bmm_0 quantizer
    k, v = proj("k_proj"), proj("v_proj")
    if past_kv is not None:
        k = torch.cat([past_kv[0], k], dim=2)
        v = torch.cat([past_kv[1], v], dim=2)
    kv_len = k.shape[2]

    # rank-3 [b*h, t, d] operands, as the reference's torch.bmm path
    q3 = q.reshape(b * nh, q_len, hd)
    k3 = k.reshape(b * nh, kv_len, hd)
    v3 = v.reshape(b * nh, kv_len, hd)
    attn = quantized_matmul(q3, k3.transpose(1, 2), qc("bmm_0"), "bmm")
    if mask is not None:
        attn = torch.clamp_min(attn.reshape(b, nh, q_len, kv_len) + mask, NEG_INF)
        attn = attn.reshape(b * nh, q_len, kv_len)
    attn = torch.softmax(attn.to(torch.float32), dim=-1).to(q.dtype)
    out = quantized_matmul(attn, v3, qc("bmm_1"), "bmm")
    out = out.reshape(b, nh, q_len, hd).transpose(1, 2).reshape(b, q_len, nh * hd)
    return row_parallel_linear(out, params["out_proj"], qc("out_proj"), quantize_weights,
                               f"model_layer_{layer_idx}:self_attn:out_proj"), (k, v)


def _decoder_layer(params, hidden, config, layer_idx, quantize_weights, attend,
                   name_nodes=False):
    """One decoder layer around ``attend(self_attn_params, h) -> h`` (the
    full-sequence attention or the cached decode attention). ``name_nodes``:
    fc1 and fc2 report to the stat tap (the full forward's, not the decode
    step's, as in the JAX package)."""
    pre = config.do_layer_norm_before
    residual = hidden
    h = _ln(params["self_attn_layer_norm"], hidden) if pre else hidden
    hidden = residual + attend(params["self_attn"], h)
    if not pre:
        hidden = _ln(params["self_attn_layer_norm"], hidden)

    residual = hidden
    h = _ln(params["final_layer_norm"], hidden) if pre else hidden
    cfg = partial(_node_cfg, config.quant_config, layer_idx)

    def nn(name):
        return f"model_layer_{layer_idx}:{name}" if name_nodes else None

    h = _linear(params["fc1"], tp.copy_to_group(h), cfg("fc1"), quantize_weights, nn("fc1"))
    h = ACT2FN[config.activation_function](h)
    h = row_parallel_linear(h, params["fc2"], cfg("fc2"), quantize_weights, nn("fc2"))
    hidden = residual + h
    if not pre:
        hidden = _ln(params["final_layer_norm"], hidden)
    return hidden


def opt_decoder_layer(params, hidden, mask, config, layer_idx: int, quantize_weights: bool,
                      past_kv=None):
    kv = []

    def attend(attn_params, h):
        out, new_kv = opt_attention(attn_params, h, mask, config, layer_idx,
                                    quantize_weights, past_kv)
        kv.append(new_kv)
        return out

    hidden = _decoder_layer(params, hidden, config, layer_idx, quantize_weights, attend,
                            name_nodes=True)
    return hidden, kv[0]


def embed_tokens(params, input_ids):
    """Token embeddings, through project_in when the model has one."""
    hidden = tp.vocab_parallel_embed(params["embed_tokens"]["weight"], input_ids)
    if "project_in" in params:
        hidden = torch.matmul(hidden, params["project_in"]["weight"].t())
    return hidden


def final_hidden(params, hidden, config):
    """The final layer norm (pre-LN models) and project_out."""
    if "final_layer_norm" in params and config.do_layer_norm_before:
        hidden = _ln(params["final_layer_norm"], hidden)
    if "project_out" in params:
        hidden = torch.matmul(hidden, params["project_out"]["weight"].t())
    return hidden


def lm_logits(params, hidden):
    """Tied (or explicit) lm_head in float32."""
    lm_w = params.get("lm_head", params["embed_tokens"])["weight"]
    return tp.gather_from_group(torch.matmul(tp.copy_to_group(hidden), lm_w.t()))


def opt_model(params, input_ids, attention_mask, config: OPTQuantizedConfig,
              quantize_weights: bool = True, past_kvs=None):
    """Backbone forward -> (final hidden [b, t, word_embed_proj_dim],
    per-layer (k, v))."""
    b, q_len = input_ids.shape
    device = input_ids.device
    past_len = 0 if past_kvs is None else past_kvs[0][0].shape[2]
    kv_len = past_len + q_len
    if attention_mask is None:
        attention_mask = torch.ones((b, kv_len), dtype=torch.int64, device=device)

    hidden = embed_tokens(params, input_ids) + opt_learned_positional_embedding(
        params["embed_positions"]["weight"], attention_mask, past_len)
    mask = make_causal_mask(attention_mask, q_len, kv_len, past_len, device=device)
    new_kvs = []
    for i, layer_params in enumerate(params["layers"]):
        past = None if past_kvs is None else past_kvs[i]
        hidden, new_kv = opt_decoder_layer(layer_params, hidden, mask, config, i,
                                           quantize_weights, past)
        new_kvs.append(new_kv)
    return final_hidden(params, hidden, config), new_kvs


def opt_for_causal_lm(params, input_ids, attention_mask=None, labels=None,
                      config: OPTQuantizedConfig = None, quantize_weights: bool = True,
                      past_kvs=None):
    """-> dict(logits=[b, t, vocab] float32, past_kvs=[(k, v)], loss=...)."""
    hidden, new_kvs = opt_model(params, input_ids, attention_mask, config,
                                quantize_weights, past_kvs)
    out = {"logits": lm_logits(params, hidden), "past_kvs": new_kvs}
    if labels is not None:
        out["loss"] = causal_lm_loss(out["logits"], labels)
    return out


def opt_for_sequence_classification(params, input_ids, attention_mask=None, labels=None,
                                    config: OPTQuantizedConfig = None,
                                    quantize_weights: bool = True):
    """-> dict(logits=[b, num_labels] float32, loss=...)."""
    hidden, _ = opt_model(params, input_ids, attention_mask, config, quantize_weights)
    return sequence_classification_head(params, hidden, input_ids, labels, config)


def _span_ce(logits, positions):
    return F.cross_entropy(logits.to(torch.float32), positions.long())


def opt_for_question_answering(params, input_ids, attention_mask=None, start_positions=None,
                               end_positions=None, config: OPTQuantizedConfig = None,
                               quantize_weights: bool = True):
    """Span QA head -> dict(start_logits, end_logits [b, t], loss=the mean
    of the two positions' cross-entropies)."""
    hidden, _ = opt_model(params, input_ids, attention_mask, config, quantize_weights)
    node = params["qa_outputs"]
    logits = torch.matmul(hidden, node["weight"].t()) + node["bias"]
    start_logits, end_logits = logits[..., 0], logits[..., 1]
    out = {"start_logits": start_logits, "end_logits": end_logits}
    if start_positions is not None and end_positions is not None:
        out["loss"] = (_span_ce(start_logits, start_positions)
                       + _span_ce(end_logits, end_positions)) / 2
    return out
