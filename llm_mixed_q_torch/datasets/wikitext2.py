"""Wikitext2 preprocessing (counterpart of the JAX package's
``datasets/wikitext2.py``): tokenize, concatenate, cut into ``max_length``
chunks, labels = input_ids."""

from __future__ import annotations


def preprocess_wikitext2(raw, tokenizer, max_length: int):
    def tokenize_fn(examples):
        return tokenizer(examples["text"])

    tokenized = raw.map(tokenize_fn, batched=True, remove_columns=raw["train"].column_names)

    def group_fn(examples):
        concatenated = {k: sum(examples[k], []) for k in examples.keys()}
        total_length = (len(concatenated["input_ids"]) // max_length) * max_length
        result = {
            k: [t[i:i + max_length] for i in range(0, total_length, max_length)]
            for k, t in concatenated.items()
        }
        result["labels"] = [list(x) for x in result["input_ids"]]
        return result

    return tokenized.map(group_fn, batched=True)
