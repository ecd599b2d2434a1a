"""CLI entry points (counterpart of the JAX package's ``cli/``): the GLUE
classification and perplexity evals, the QAT fine-tune runners and the
statistic-profiling runners. The prompting and search entry points wait
for their slices."""

from .evals import (
    cli_eval_cls_glue,
    cli_eval_lm_wikitext2,
    cli_eval_lm_wikitext2_int8_baseline,
    cli_eval_lm_wikitext2_with_config,
)
from .profile_statistics import cli_profile_statistics_cls_glue, cli_profile_statistics_lm
from .train_cli import ddp_train_runner, dp_train_runner, fsdp_train_runner
