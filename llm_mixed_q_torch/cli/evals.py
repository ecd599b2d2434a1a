"""Eval CLIs (counterpart of the JAX package's ``cli/evals.py``):
- ``cli_eval_cls_glue``: a GLUE task's validation metrics of a local
  checkpoint with a classification head under a quant config (mnli also
  on its mismatched split);
- ``cli_eval_lm_wikitext2``: Wikitext2 perplexity of a local checkpoint
  under a quant config;
- ``cli_eval_lm_wikitext2_int8_baseline``: the same under W8A8 integer
  PTQ, the framework's own stand-in for the reference's llm.int8 baseline;
- ``cli_eval_prompting_cls``: the mean zero-shot prompting accuracy over
  ``--tasks`` (their splits through HF ``datasets``).
"""

from __future__ import annotations

import argparse

from ..datasets import get_raw_dataset_dict, numpy_dataloader, preprocess_dataset_dict
from ..datasets.glue import is_regression_task
from ..eval import eval_cls_glue, eval_lm_wikitext2, eval_prompting_tasks
from ..models.api import make_forward
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


def _glue_loader(args, tokenizer, split="validation"):
    raw = get_raw_dataset_dict(args.task)
    ds = preprocess_dataset_dict(raw, args.task, tokenizer, "max_length", args.max_length)
    return numpy_dataloader(ds[split], batch_size=args.batch_size)


def cli_eval_cls_glue(argv=None):
    parser = argparse.ArgumentParser("eval_cls_glue")
    add_common_model_args(parser)
    parser.add_argument("--task", required=True)
    args = parser.parse_args(argv)
    _, params, fwd = build_model(args, "cls")
    tokenizer = get_tokenizer(args)
    results = eval_cls_glue(fwd, params, args.task, _glue_loader(args, tokenizer),
                            is_regression=is_regression_task(args.task),
                            num_samples=args.num_samples)
    if args.task == "mnli":
        # matched and mismatched, as the reference's final mnli-mm pass
        mm = eval_cls_glue(fwd, params, args.task,
                           _glue_loader(args, tokenizer, split="validation_mismatched"),
                           is_regression=False, num_samples=args.num_samples)
        results.update({f"{k}_mm": v for k, v in mm.items()})
    save_results(args, results, "eval_cls")
    return results


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


def cli_eval_prompting_cls(argv=None):
    parser = argparse.ArgumentParser("eval_prompting_cls")
    add_common_model_args(parser)
    parser.add_argument("--tasks", nargs="+", required=True)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    config, params, _ = build_model(args, "lm")
    fwd = make_forward(args.model_arch, "lm", config, quantize_weights=False)
    tokenizer = get_tokenizer(args)
    results = eval_prompting_tasks(fwd, params, tokenizer, args.tasks, limit=args.limit,
                                   batch_size=args.batch_size)
    save_results(args, results, "eval_prompting")
    return results
