"""CLI entry points (counterpart of the JAX package's ``cli/``). This
slice ports the perplexity evals; the classification, prompting, search,
statistics and training entry points wait for their slices."""

from .evals import (
    cli_eval_lm_wikitext2,
    cli_eval_lm_wikitext2_int8_baseline,
    cli_eval_lm_wikitext2_with_config,
)
