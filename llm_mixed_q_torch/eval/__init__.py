"""Eval layer (counterpart of the JAX package's ``eval/``): the perplexity
eval, the GLUE classification eval and its metrics. Prompting waits for
its slice."""

from .eval_cls import eval_cls_glue
from .eval_lm import eval_lm_wikitext2
from .metrics import TASK_TO_METRICS, compute_glue_metrics
