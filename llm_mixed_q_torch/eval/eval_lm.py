"""Fixed-sequence-length perplexity eval, the Wikitext2 protocol
(counterpart of the JAX package's ``eval/eval_lm.py``): sum loss *
batch_size * seq_len over fixed-length chunks; ppl = exp(sum / (seq_len *
num_sequences))."""

from __future__ import annotations

import math

import numpy as np
import torch


def _first_tensor(tree):
    """The first tensor of a parameter tree (dicts, lists, packed nodes)."""
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    return next((t for t in map(_first_tensor, items) if t is not None), None)


@torch.inference_mode()
def eval_lm_wikitext2(forward_fn, params, eval_dataloader, num_samples: int | None = None,
                      progress_bar: bool = False) -> dict:
    """``forward_fn(params, input_ids, attention_mask, labels)["loss"]`` over
    the batches, each moved to the parameters' device. ``progress_bar`` is
    accepted and ignored, as in the JAX package."""
    device = _first_tensor(params).device
    losses = []
    seq_len = None
    num_sequences = 0
    for batch in eval_dataloader:
        input_ids = np.asarray(batch["input_ids"])
        bs, cur_len = input_ids.shape
        if seq_len is None:
            seq_len = cur_len
        if cur_len != seq_len:
            raise ValueError("All batches must have the same seq_len")
        ids, mask, labels = (torch.as_tensor(np.asarray(batch[k]), device=device)
                             for k in ("input_ids", "attention_mask", "labels"))
        out = forward_fn(params, ids, mask, labels)
        losses.append(float(out["loss"]) * bs * seq_len)
        num_sequences += bs
        if num_samples is not None and num_sequences >= num_samples:
            break
    avg_nll = float(np.sum(losses)) / (seq_len * num_sequences)
    return {"loss": avg_nll, "perplexity": math.exp(avg_nll),
            "num_sequences": num_sequences, "seq_len": seq_len}
