"""Dataset pipelines and numpy batch loaders (counterpart of the JAX
package's ``datasets/``): the GLUE tasks and Wikitext2, and their synthetic
stand-ins. HF ``datasets`` is imported only to load a raw corpus (from its
cache or the network)."""

from __future__ import annotations

import numpy as np

from .glue import TASK_TO_KEYS, get_num_labels, is_regression_task, preprocess_glue
from .wikitext2 import preprocess_wikitext2


def get_raw_dataset_dict(name: str):
    """Load the raw HF dataset dict (needs the HF cache or the network)."""
    from datasets import load_dataset

    if name in TASK_TO_KEYS:
        return load_dataset("glue", name)
    if name == "wikitext2":
        return load_dataset("wikitext", "wikitext-2-raw-v1")
    raise ValueError(f"Unknown dataset: {name}")


def preprocess_dataset_dict(raw_dataset_dict, name: str, tokenizer, padding, max_length):
    """A GLUE task tokenized (padded per ``padding``), or Wikitext2 cut into
    ``max_length`` chunks (``padding`` unused)."""
    if name in TASK_TO_KEYS:
        return preprocess_glue(raw_dataset_dict, name, tokenizer, padding, max_length)
    if name == "wikitext2":
        return preprocess_wikitext2(raw_dataset_dict, tokenizer, max_length)
    raise ValueError(f"Unknown dataset: {name}")


def numpy_dataloader(dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                     columns=("input_ids", "attention_mask", "labels"),
                     drop_last: bool = False):
    """Minimal batcher over a dict of arrays or an HF dataset."""
    if hasattr(dataset, "to_dict"):
        data = {k: np.asarray(v) for k, v in dataset.to_dict().items() if k in columns}
    else:
        data = {k: np.asarray(v) for k, v in dataset.items() if k in columns}
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        sel = idx[start:start + batch_size]
        yield {k: v[sel] for k, v in data.items()}


def make_synthetic_lm_dataset(vocab_size: int, seq_len: int, num_sequences: int, seed=0):
    """Offline stand-in for Wikitext2 chunks: uniform token ids of a fixed
    length, labels = input_ids (the JAX package's stream for a seed)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, size=(num_sequences, seq_len), dtype=np.int64)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids.copy()}


def make_synthetic_cls_dataset(vocab_size: int, seq_len: int, num_samples: int,
                               num_labels: int = 2, seed=0):
    """Offline stand-in for a GLUE split: token ids in [1, vocab), each row
    right-padded with 0 from a length in [seq_len // 2, seq_len], uniform
    labels (the JAX package's stream for a seed)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab_size, size=(num_samples, seq_len), dtype=np.int64)
    mask = np.ones_like(ids)
    lengths = rng.integers(seq_len // 2, seq_len + 1, size=num_samples)
    for i, l in enumerate(lengths):
        mask[i, l:] = 0
        ids[i, l:] = 0
    return {
        "input_ids": ids,
        "attention_mask": mask,
        "labels": rng.integers(0, num_labels, size=num_samples, dtype=np.int64),
    }
