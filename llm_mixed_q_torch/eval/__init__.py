"""Eval layer (counterpart of the JAX package's ``eval/``): the perplexity
eval, the GLUE classification eval and its metrics, the prompting eval, and
``eval_dse_results``, the reference's stub (eval/__init__.py:7-20): its
FPGA design-space-exploration submodule was never released, so the fps
objectives of a search are inert, as in both references."""

from .eval_cls import eval_cls_glue
from .eval_lm import eval_lm_wikitext2
from .metrics import TASK_TO_METRICS, compute_glue_metrics
from .prompting import eval_prompting_task, eval_prompting_tasks, loglikelihood_batch


def eval_dse_results(config, is_mixed: bool = False) -> dict:
    """The reference's stub of its closed-source DSE."""
    return {"best_fps": 0.0, "resource": 1.0}
