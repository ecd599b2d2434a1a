"""Forward factories (counterpart of the JAX package's ``models/api.py``):
the model function of (arch, task) with the config and the quantization
mode bound, whole (``make_forward``) or incremental
(``make_prefill_and_decode``)."""

from __future__ import annotations

import torch


def make_forward(arch: str, task: str, config, quantize_weights: bool = True,
                 with_labels: bool = False):
    """``fwd(params, input_ids, attention_mask=None[, labels]) -> dict``:
    the model's outputs (logits, and loss with labels) without the KV
    caches."""
    from . import get_model_fn

    model_fn = get_model_fn(arch, task)

    def run(params, input_ids, attention_mask, **labels):
        out = model_fn(params, input_ids, attention_mask, config=config,
                       quantize_weights=quantize_weights, **labels)
        return {k: v for k, v in out.items() if k != "past_kvs"}

    if with_labels:
        def fwd(params, input_ids, attention_mask, labels):
            return run(params, input_ids, attention_mask, labels=labels)
    else:
        def fwd(params, input_ids, attention_mask=None):
            return run(params, input_ids, attention_mask)
    return fwd


def make_prefill_and_decode(arch: str, task: str, config, quantize_weights: bool = True):
    """(prefill, decode_step) for incremental generation on float k/v
    caches that grow by one token a step (no fixed-size or packed cache):

    - ``prefill(params, input_ids, attention_mask) -> (logits, kvs)``;
    - ``decode_step(params, token, attention_mask, kvs) -> (logits, kvs)``,
      ``token`` [b, 1] and ``attention_mask`` over the past and the new
      token, [b, past + 1].

    Both run under ``torch.no_grad()``."""
    from . import get_model_fn

    model_fn = get_model_fn(arch, task)

    @torch.no_grad()
    def prefill(params, input_ids, attention_mask):
        out = model_fn(params, input_ids, attention_mask, config=config,
                       quantize_weights=quantize_weights)
        return out["logits"], out["past_kvs"]

    @torch.no_grad()
    def decode_step(params, token, attention_mask, kvs):
        out = model_fn(params, token, attention_mask, config=config,
                       quantize_weights=quantize_weights, past_kvs=kvs)
        return out["logits"], out["past_kvs"]

    return prefill, decode_step
