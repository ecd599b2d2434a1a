"""Dataset pipelines and numpy batch loaders (counterpart of the JAX
package's ``datasets/``). This slice ports the language-modelling path:
Wikitext2 and its synthetic stand-in. HF ``datasets`` is imported only to
load the raw corpus (from its cache or the network); the GLUE tasks wait
for the classification slice."""

from __future__ import annotations

import numpy as np

from .wikitext2 import preprocess_wikitext2

GLUE_TASKS = ("cola", "mnli", "mrpc", "qnli", "qqp", "rte", "sst2", "stsb", "wnli")


def _check_name(name: str):
    if name in GLUE_TASKS:
        raise NotImplementedError(f"the GLUE dataset {name!r} is not ported yet")
    if name != "wikitext2":
        raise ValueError(f"Unknown dataset: {name}")


def get_raw_dataset_dict(name: str):
    """Load the raw HF dataset dict (needs the HF cache or the network)."""
    _check_name(name)
    from datasets import load_dataset

    return load_dataset("wikitext", "wikitext-2-raw-v1")


def preprocess_dataset_dict(raw_dataset_dict, name: str, tokenizer, padding, max_length):
    """Tokenize and cut into ``max_length`` chunks (``padding`` is the GLUE
    tasks' and unused here)."""
    _check_name(name)
    return preprocess_wikitext2(raw_dataset_dict, tokenizer, max_length)


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
