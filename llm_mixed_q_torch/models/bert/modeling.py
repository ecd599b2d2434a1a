"""Quantized BERT in PyTorch (counterpart of the JAX package's
``models/bert/modeling.py``): plain functions over a parameter dict, weights
in the torch ``[out, in]`` layout.

Numerics follow the reference: embeddings word + absolute position +
token type, then LayerNorm; quantized query/key/value linears;
quantized matmul_0 = q @ k^T, then / sqrt(head_dim), then the additive mask
(1 - mask) * finfo(float32).min (a fully padded row gives a uniform
softmax, not NaN); float32 softmax; quantized matmul_1; post-LN blocks
(dense, then LayerNorm of the sum with the residual); the pooler
tanh(dense(first token)). ``hidden_act`` "gelu" is the exact erf GELU, as
the JAX package's activation map has it for BERT ("gelu_new" is the tanh
form). The pooler, the heads and the masked-LM decoder (tied to the word
embeddings) are plain float32 matmuls, as in the JAX package.

Under tensor parallelism (``parallel/tp.py``, a local tree from
``parallel.shard_params``) a rank runs ``heads / tp`` heads: query/key/value
and intermediate.dense column-parallel, the output.dense nodes
row-parallel, the classifier column-parallel with its logits gathered.

Heads (``TASK`` names of the registry): sequence classification (``cls``,
MSE for one label), masked LM (``mlm``), the causal-LM-style head with
shifted labels (``clm``), next-sentence prediction (``nsp``), pretraining
(``pretrain``, MLM + NSP), multiple choice (``mc``), token classification
(``token``) and span question answering (``qa``). Token losses are the
mean cross-entropy over labels other than -100.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.functions import quantized_matmul
from ...ops.linear import quantized_linear, row_parallel_linear
from ...parallel import tp
from ..opt.modeling import layer_norm
from .configuration import BertQuantizedConfig

NEG_INF = float(np.finfo(np.float32).min)
_BYPASS = {"bypass": True, "name": "integer"}

ACT2FN = {
    "gelu": partial(F.gelu, approximate="none"),
    "gelu_new": partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def _node_cfg(quant_config, layer_idx: int, *path) -> dict:
    if quant_config is None:
        return _BYPASS
    node = quant_config[f"model_layer_{layer_idx}"]
    for p in path:
        node = node[p]
    return node


def _ln(node, x, config):
    return layer_norm(x, node["weight"], node["bias"], config.layer_norm_eps)


def _dense(node, x):
    return torch.matmul(x, node["weight"].t()) + node["bias"]


def _classifier(node, x):
    """The classifier, column-parallel on the labels: the ranks' logits
    gathered (the whole node outside tensor parallelism)."""
    return tp.gather_from_group(_dense(node, tp.copy_to_group(x)))


def bert_embeddings(params, input_ids, token_type_ids, config):
    pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    h = (params["word_embeddings"]["weight"][input_ids]
         + params["position_embeddings"]["weight"][pos_ids]
         + params["token_type_embeddings"]["weight"][token_type_ids])
    return _ln(params["LayerNorm"], h, config)


def bert_self_attention(params, hidden, ext_mask, config, layer_idx, quantize_weights):
    """-> the attention context [b, s, hidden] (before attention.output)."""
    b, s, _ = hidden.shape
    nh, hd = tp.local(config.num_attention_heads), config.head_dim
    qc = partial(_node_cfg, config.quant_config, layer_idx, "attention")
    hidden = tp.copy_to_group(hidden)  # the input of column-parallel nodes

    def proj(name):
        node = params[name]
        out = quantized_linear(hidden, node["weight"], node.get("bias"), qc(name),
                               quantize_weights, f"model_layer_{layer_idx}:attention:{name}")
        return out.reshape(b, s, nh, hd).transpose(1, 2)

    q, k, v = proj("query"), proj("key"), proj("value")
    scores = quantized_matmul(q, k.transpose(2, 3), qc("matmul_0")) / math.sqrt(hd)
    if ext_mask is not None:
        scores = scores + ext_mask
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    ctx = quantized_matmul(probs, v, qc("matmul_1"))
    return ctx.transpose(1, 2).reshape(b, s, nh * hd)


def bert_layer(params, hidden, ext_mask, config, layer_idx, quantize_weights):
    cfg = partial(_node_cfg, config.quant_config, layer_idx)

    def row(node, x, *path):  # the output.dense nodes are row-parallel
        return row_parallel_linear(x, node, cfg(*path), quantize_weights,
                                   ":".join((f"model_layer_{layer_idx}",) + path))

    ctx = bert_self_attention(params["attention"], hidden, ext_mask, config, layer_idx,
                              quantize_weights)
    so = params["attention"]["output"]
    attn_out = row(so["dense"], ctx, "attention", "output", "dense")
    hidden = _ln(so["LayerNorm"], attn_out + hidden, config)
    node = params["intermediate"]["dense"]  # column-parallel
    inter = quantized_linear(tp.copy_to_group(hidden), node["weight"], node.get("bias"),
                             cfg("intermediate", "dense"), quantize_weights,
                             f"model_layer_{layer_idx}:intermediate:dense")
    inter = ACT2FN[config.hidden_act](inter)
    out = row(params["output"]["dense"], inter, "output", "dense")
    return _ln(params["output"]["LayerNorm"], out + hidden, config)


def bert_model(params, input_ids, attention_mask=None, token_type_ids=None,
               config: BertQuantizedConfig = None, quantize_weights: bool = True):
    """-> (sequence output [b, s, hidden], pooled output [b, hidden] or None
    without a pooler)."""
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    hidden = bert_embeddings(params["embeddings"], input_ids, token_type_ids, config)
    ext_mask = (1.0 - attention_mask[:, None, None, :].to(hidden.dtype)) * NEG_INF
    for i, layer_params in enumerate(params["layers"]):
        hidden = bert_layer(layer_params, hidden, ext_mask, config, i, quantize_weights)
    pooled = None
    if "pooler" in params:
        pooled = torch.tanh(_dense(params["pooler"]["dense"], hidden[:, 0]))
    return hidden, pooled


def _token_ce_loss(logits, labels, ignore_index: int = -100):
    """Mean cross-entropy over labels != ``ignore_index`` (0 when none)."""
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = labels.long()
    keep = labels != ignore_index
    ll = torch.gather(logprobs, -1, torch.where(keep, labels, 0)[..., None])[..., 0]
    return -(ll * keep).sum() / keep.sum().clamp_min(1)


def _mlm_logits(params, hidden, config):
    """BertLMPredictionHead: dense, exact GELU, LayerNorm, then the decoder
    (the word embeddings unless the head has its own) and an output
    bias."""
    t = params["cls"]["transform"]
    h = F.gelu(_dense(t["dense"], hidden), approximate="none")
    h = _ln(t["LayerNorm"], h, config)
    dec_w = params["cls"].get("decoder", {}).get(
        "weight", params["embeddings"]["word_embeddings"]["weight"])
    return torch.matmul(h, dec_w.t()) + params["cls"]["bias"]


def bert_for_masked_lm(params, input_ids, attention_mask=None, token_type_ids=None,
                       labels=None, config: BertQuantizedConfig = None,
                       quantize_weights: bool = True):
    hidden, _ = bert_model(params, input_ids, attention_mask, token_type_ids, config,
                           quantize_weights)
    out = {"logits": _mlm_logits(params, hidden, config)}
    if labels is not None:
        out["loss"] = _token_ce_loss(out["logits"], labels)
    return out


def bert_lm_head_model(params, input_ids, attention_mask=None, token_type_ids=None,
                       labels=None, config: BertQuantizedConfig = None,
                       quantize_weights: bool = True):
    """The MLM head with SHIFTED labels (the reference's BertLMHeadModel)."""
    hidden, _ = bert_model(params, input_ids, attention_mask, token_type_ids, config,
                           quantize_weights)
    out = {"logits": _mlm_logits(params, hidden, config)}
    if labels is not None:
        out["loss"] = _token_ce_loss(out["logits"][:, :-1], labels[:, 1:])
    return out


def _nsp_logits(params, pooled):
    return _dense(params["cls"]["seq_relationship"], pooled)


def bert_for_next_sentence_prediction(params, input_ids, attention_mask=None,
                                      token_type_ids=None, labels=None,
                                      config: BertQuantizedConfig = None,
                                      quantize_weights: bool = True):
    _, pooled = bert_model(params, input_ids, attention_mask, token_type_ids, config,
                           quantize_weights)
    out = {"logits": _nsp_logits(params, pooled)}
    if labels is not None:
        out["loss"] = _token_ce_loss(out["logits"], labels)
    return out


def bert_for_pretraining(params, input_ids, attention_mask=None, token_type_ids=None,
                         labels=None, next_sentence_label=None,
                         config: BertQuantizedConfig = None, quantize_weights: bool = True):
    """MLM + NSP; the loss is the sum of the two."""
    hidden, pooled = bert_model(params, input_ids, attention_mask, token_type_ids, config,
                                quantize_weights)
    out = {"prediction_logits": _mlm_logits(params, hidden, config),
           "seq_relationship_logits": _nsp_logits(params, pooled)}
    if labels is not None and next_sentence_label is not None:
        out["loss"] = (_token_ce_loss(out["prediction_logits"], labels)
                       + _token_ce_loss(out["seq_relationship_logits"], next_sentence_label))
    return out


def bert_for_multiple_choice(params, input_ids, attention_mask=None, token_type_ids=None,
                             labels=None, config: BertQuantizedConfig = None,
                             quantize_weights: bool = True):
    """Input [b, n_choices, s] through the encoder as [b * n, s]; the pooled
    output scored by a 1-logit classifier -> logits [b, n]."""
    b, n, s = input_ids.shape
    flat = lambda x: None if x is None else x.reshape(b * n, s)
    _, pooled = bert_model(params, flat(input_ids), flat(attention_mask),
                           flat(token_type_ids), config, quantize_weights)
    out = {"logits": _classifier(params["classifier"], pooled).reshape(b, n)}
    if labels is not None:
        out["loss"] = _token_ce_loss(out["logits"], labels)
    return out


def bert_for_token_classification(params, input_ids, attention_mask=None,
                                  token_type_ids=None, labels=None,
                                  config: BertQuantizedConfig = None,
                                  quantize_weights: bool = True):
    hidden, _ = bert_model(params, input_ids, attention_mask, token_type_ids, config,
                           quantize_weights)
    out = {"logits": _classifier(params["classifier"], hidden)}
    if labels is not None:
        out["loss"] = _token_ce_loss(out["logits"], labels)
    return out


def bert_for_question_answering(params, input_ids, attention_mask=None, token_type_ids=None,
                                start_positions=None, end_positions=None,
                                config: BertQuantizedConfig = None,
                                quantize_weights: bool = True):
    """Span start/end logits [b, s]; the loss is the mean of the two
    positions' cross-entropies."""
    hidden, _ = bert_model(params, input_ids, attention_mask, token_type_ids, config,
                           quantize_weights)
    logits = _dense(params["qa_outputs"], hidden)
    out = {"start_logits": logits[..., 0], "end_logits": logits[..., 1]}
    if start_positions is not None and end_positions is not None:
        out["loss"] = 0.5 * (_token_ce_loss(out["start_logits"], start_positions)
                             + _token_ce_loss(out["end_logits"], end_positions))
    return out


def bert_for_sequence_classification(params, input_ids, attention_mask=None,
                                     token_type_ids=None, labels=None,
                                     config: BertQuantizedConfig = None,
                                     quantize_weights: bool = True):
    """The classifier on the pooled output -> logits [b, num_labels]; the
    loss is the MSE for one label (regression), else the cross-entropy."""
    _, pooled = bert_model(params, input_ids, attention_mask, token_type_ids, config,
                           quantize_weights)
    logits = _classifier(params["classifier"], pooled)
    out = {"logits": logits}
    if labels is not None:
        if config.num_labels == 1:
            out["loss"] = (logits.squeeze(-1) - labels).square().mean()
        else:
            out["loss"] = F.cross_entropy(logits.to(torch.float32), labels.long())
    return out
