"""CLI entry points (counterpart of the JAX package's ``cli/``; reference
cli/__init__.py:1-21): the GLUE classification, perplexity and prompting
evals, the QAT fine-tune runners, the statistic-profiling runners, and the
search, stat-to-integer-config and trial-extraction entry points."""

from .evals import (
    cli_eval_cls_glue,
    cli_eval_lm_wikitext2,
    cli_eval_lm_wikitext2_int8_baseline,
    cli_eval_lm_wikitext2_with_config,
    cli_eval_prompting_cls,
)
from .profile_statistics import cli_profile_statistics_cls_glue, cli_profile_statistics_lm
from .search_cli import (
    cli_conditional_search_quantisation_on_cls_glue,
    cli_conditional_search_quantisation_on_prompting_cls_tasks,
    cli_extract_quant_config,
    cli_extract_quant_config_and_prompting_eval,
    cli_search_quantisation_on_cls_glue,
    cli_search_quantisation_on_prompting_cls_tasks,
    cli_transform_stat_profile_to_int_quant_config,
)
from .train_cli import ddp_train_runner, dp_train_runner, fsdp_train_runner
