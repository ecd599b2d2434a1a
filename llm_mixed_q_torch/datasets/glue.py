"""GLUE preprocessing (counterpart of the JAX package's
``datasets/glue.py``): the sentence keys of each task, its label count, and
tokenization of a raw ``DatasetDict``, with mnli's ``validation`` the
matched split."""

from __future__ import annotations

TASK_TO_KEYS = {
    "cola": ("sentence", None),
    "mnli": ("premise", "hypothesis"),
    "mrpc": ("sentence1", "sentence2"),
    "qnli": ("question", "sentence"),
    "qqp": ("question1", "question2"),
    "rte": ("sentence1", "sentence2"),
    "sst2": ("sentence", None),
    "stsb": ("sentence1", "sentence2"),
    "wnli": ("sentence1", "sentence2"),
}


def get_num_labels(task: str) -> int:
    if task == "stsb":
        return 1
    if task == "mnli":
        return 3
    return 2


def is_regression_task(task: str) -> bool:
    return task == "stsb"


def preprocess_glue(raw, task: str, tokenizer, padding="max_length", max_length=128):
    """Tokenize one sentence or a pair per example (``labels`` from
    ``label``), dropping the raw columns."""
    key1, key2 = TASK_TO_KEYS[task]

    def tokenize_fn(examples):
        args = (examples[key1],) if key2 is None else (examples[key1], examples[key2])
        result = tokenizer(*args, padding=padding, max_length=max_length, truncation=True)
        result["labels"] = examples["label"]
        return result

    processed = raw.map(tokenize_fn, batched=True, remove_columns=raw["train"].column_names)
    if task == "mnli":
        processed["validation"] = processed["validation_matched"]
    return processed
