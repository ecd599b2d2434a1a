"""Eval layer (counterpart of the JAX package's ``eval/``). This slice
ports the perplexity eval; classification, metrics and prompting wait."""

from .eval_lm import eval_lm_wikitext2
