"""GLUE classification eval (counterpart of the JAX package's
``eval/eval_cls.py``): argmax of the logits (their squeeze for a
regression task) over a dataloader, with an optional ``num_samples`` cap,
scored by ``compute_glue_metrics``."""

from __future__ import annotations

import numpy as np
import torch

from .eval_lm import _first_tensor
from .metrics import compute_glue_metrics


@torch.inference_mode()
def eval_cls_glue(forward_fn, params, task: str, eval_dataloader, is_regression: bool = False,
                  num_samples: int | None = None, progress_bar: bool = False) -> dict[str, float]:
    """``forward_fn(params, input_ids, attention_mask)["logits"]`` over the
    batches, each moved to the parameters' device; the logits come back
    once a batch. ``progress_bar`` is accepted for the JAX package's
    signature and draws nothing, as there."""
    device = _first_tensor(params).device
    preds_all, refs_all = [], []
    seen = 0
    for batch in eval_dataloader:
        ids, mask = (torch.as_tensor(np.asarray(batch[k]), device=device)
                     for k in ("input_ids", "attention_mask"))
        logits = forward_fn(params, ids, mask)["logits"].cpu().numpy()
        preds = logits.squeeze(-1) if is_regression else logits.argmax(axis=-1)
        labels = np.asarray(batch["labels"])
        if num_samples is not None and seen + len(labels) > num_samples:
            take = num_samples - seen
            preds, labels = preds[:take], labels[:take]
        preds_all.append(preds)
        refs_all.append(labels)
        seen += len(labels)
        if num_samples is not None and seen >= num_samples:
            break
    return compute_glue_metrics(task, np.concatenate(preds_all), np.concatenate(refs_all))
