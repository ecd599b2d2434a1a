"""GLUE metrics in numpy and scipy (counterpart of the JAX package's
``eval/metrics.py``): each task's standard metric set."""

from __future__ import annotations

import numpy as np
from scipy.stats import pearsonr, spearmanr

TASK_TO_METRICS = {
    "cola": ("matthews_correlation",),
    "mnli": ("accuracy",),
    "mrpc": ("accuracy", "f1"),
    "qnli": ("accuracy",),
    "qqp": ("accuracy", "f1"),
    "rte": ("accuracy",),
    "sst2": ("accuracy",),
    "stsb": ("pearson", "spearmanr"),
    "wnli": ("accuracy",),
}


def accuracy(preds, refs) -> float:
    preds, refs = np.asarray(preds), np.asarray(refs)
    return float((preds == refs).mean())


def f1(preds, refs, pos_label: int = 1) -> float:
    preds, refs = np.asarray(preds), np.asarray(refs)
    tp = np.sum((preds == pos_label) & (refs == pos_label))
    fp = np.sum((preds == pos_label) & (refs != pos_label))
    fn = np.sum((preds != pos_label) & (refs == pos_label))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom else 0.0


def matthews_correlation(preds, refs) -> float:
    """The multiclass Matthews correlation from the confusion matrix; 0
    where it is undefined."""
    preds, refs = np.asarray(preds), np.asarray(refs)
    classes = np.unique(np.concatenate([preds, refs]))
    idx = {c: i for i, c in enumerate(classes)}
    cm = np.zeros((len(classes), len(classes)), dtype=np.float64)
    for p, r in zip(preds, refs):
        cm[idx[r], idx[p]] += 1
    t, p_ = cm.sum(axis=1), cm.sum(axis=0)
    c, s = np.trace(cm), cm.sum()
    cov_ytyp = c * s - t @ p_
    cov_ypyp = s**2 - p_ @ p_
    cov_ytyt = s**2 - t @ t
    denom = np.sqrt(cov_ypyp * cov_ytyt)
    return float(cov_ytyp / denom) if denom else 0.0


def compute_glue_metrics(task: str, preds, refs) -> dict[str, float]:
    fns = {"accuracy": accuracy, "f1": f1, "matthews_correlation": matthews_correlation,
           "pearson": lambda p, r: float(pearsonr(p, r)[0]),
           "spearmanr": lambda p, r: float(spearmanr(p, r)[0])}
    return {metric: fns[metric](preds, refs) for metric in TASK_TO_METRICS[task]}
