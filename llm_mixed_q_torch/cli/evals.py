"""Perplexity eval CLIs (counterpart of the LM part of the JAX package's
``cli/evals.py``):
- ``cli_eval_lm_wikitext2``: Wikitext2 perplexity of a local checkpoint
  under a quant config;
- ``cli_eval_lm_wikitext2_int8_baseline``: the same under W8A8 integer
  PTQ, the framework's own stand-in for the reference's llm.int8 baseline.
"""

from __future__ import annotations

import argparse

from ..datasets import get_raw_dataset_dict, numpy_dataloader, preprocess_dataset_dict
from ..eval import eval_lm_wikitext2
from .common import add_common_model_args, build_model, get_tokenizer, save_results

INT8_BASELINE = {
    "default": {
        "name": "integer",
        "bypass": False,
        "is_ptq": True,
        "data_in_width": 8,
        "data_in_frac_width": 4,
        "weight_width": 8,
        "weight_frac_width": 7,
        "bias_width": 8,
        "bias_frac_width": 7,
    }
}


def _eval_lm(args, name: str) -> dict:
    _, params, fwd = build_model(args, "lm")
    tokenizer = get_tokenizer(args)
    raw = get_raw_dataset_dict("wikitext2")
    ds = preprocess_dataset_dict(raw, "wikitext2", tokenizer, None, args.max_length)
    results = eval_lm_wikitext2(fwd, params, numpy_dataloader(ds["test"], batch_size=args.batch_size),
                                num_samples=args.num_samples)
    save_results(args, results, name)
    return results


def cli_eval_lm_wikitext2(argv=None):
    parser = argparse.ArgumentParser("eval_lm_wikitext2")
    add_common_model_args(parser)
    return _eval_lm(parser.parse_args(argv), "eval_lm_wikitext2")


def cli_eval_lm_wikitext2_int8_baseline(argv=None):
    """W8A8 integer PTQ baseline (the llm.int8 regime's comparison point)."""
    parser = argparse.ArgumentParser("eval_lm_wikitext2_int8_baseline")
    add_common_model_args(parser)
    args = parser.parse_args(argv)
    args.quant_config = INT8_BASELINE
    return cli_eval_lm_wikitext2_with_config(args)


def cli_eval_lm_wikitext2_with_config(args):
    """The perplexity eval on parsed ``args`` (``args.quant_config`` may be a
    dict)."""
    return _eval_lm(args, "eval_lm_wikitext2_int8")
