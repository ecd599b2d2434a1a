"""Forward factory (counterpart of the JAX package's ``models/api.py``):
the model function of (arch, task) with the config and the quantization
mode bound."""

from __future__ import annotations


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
