"""Search CLIs (counterpart of the JAX package's ``cli/search_cli.py``;
reference cli/search_quantization_cls.py:20,
cli/search_int_quantization_cls.py:20, the prompting variants,
cli/transform_stat_profile_to_int_config.py:17 and the trial-extraction
CLIs, cli/extract_quant_config_cls.py:21). The parameters load on
``--device`` (cuda unless cpu is asked for) and stay there for every
trial. A prompting search without explicit examples loads each task's
split through HF ``datasets``, which raises ImportError naming the
package where it is absent.
"""

from __future__ import annotations

import argparse
import dataclasses
from functools import partial

from ..config import transform_stat_profile_to_int_quant_config
from ..datasets import get_raw_dataset_dict, numpy_dataloader, preprocess_dataset_dict
from ..datasets.glue import is_regression_task
from ..eval.prompting import eval_prompting_tasks
from ..models import get_config_cls, get_params_loader, get_stat_config_formatter
from ..models.api import make_forward
from ..models.hf_loader import load_flat_state_dict
from ..search import (
    SearchIntQuantisationForClassification,
    SearchIntQuantisationForPromptingCLS,
    SearchQuantisationForClassification,
    SearchQuantisationForPromptingCLS,
)
from ..utils import load_config, save_config
from ..utils.trial_extractor import extract_quant_config
from .common import add_common_model_args, get_tokenizer, save_results


def checkpoint_config_kwargs(model_config) -> dict:
    """The checkpoint's config fields but its quant config: the widths each
    trial's config is built with. (The JAX package passes ``num_labels``
    alone, so its trials take the config class's default widths and fail
    on any checkpoint of other widths: ROADMAP fault 17.)"""
    return {f.name: getattr(model_config, f.name) for f in dataclasses.fields(model_config)
            if f.name != "quant_config"}


def _cls_setup(args):
    config_cls = get_config_cls(args.model_arch)
    model_config = config_cls.from_pretrained(
        args.model_name, num_labels=args.num_labels
    )
    flat = load_flat_state_dict(args.model_name)
    params = get_params_loader(args.model_arch)(flat, model_config, task="cls",
                                                device=args.device)
    tokenizer = get_tokenizer(args)
    raw = get_raw_dataset_dict(args.task)
    ds = preprocess_dataset_dict(raw, args.task, tokenizer, "max_length", args.max_length)
    loader_factory = partial(
        numpy_dataloader, ds["validation"], batch_size=args.batch_size
    )
    return params, loader_factory, checkpoint_config_kwargs(model_config)


def cli_search_quantisation_on_cls_glue(argv=None):
    parser = argparse.ArgumentParser("search_quantisation_cls_glue")
    add_common_model_args(parser)
    parser.add_argument("--task", required=True)
    parser.add_argument("--search_config", required=True)
    args = parser.parse_args(argv)
    params, loader_factory, mck = _cls_setup(args)
    search = SearchQuantisationForClassification(
        args.model_arch,
        args.model_name,
        args.search_config,
        args.save_dir or "search_out",
        params,
        num_labels=args.num_labels,
        model_config_kwargs=mck,
    )
    study = search.search(
        loader_factory,
        args.task,
        is_regression_task(args.task),
        args.max_length,
        args.num_samples,
    )
    results = search.evaluate_best_trials(
        study, loader_factory, args.task, is_regression_task(args.task)
    )
    save_results(args, results, "search_best")
    return study


def cli_conditional_search_quantisation_on_cls_glue(argv=None):
    parser = argparse.ArgumentParser("conditional_search_cls_glue")
    add_common_model_args(parser)
    parser.add_argument("--task", required=True)
    parser.add_argument("--search_config", required=True)
    parser.add_argument("--stat_profile", required=True)
    parser.add_argument("--range_entry", default="range_min_max")
    args = parser.parse_args(argv)
    params, loader_factory, mck = _cls_setup(args)
    stat_profile = load_config(args.stat_profile)
    search = SearchIntQuantisationForClassification(
        args.model_arch,
        args.model_name,
        args.search_config,
        args.save_dir or "search_out",
        params,
        stat_profile=stat_profile,
        range_entry=args.range_entry,
        num_labels=args.num_labels,
        model_config_kwargs=mck,
    )
    study = search.search(
        loader_factory,
        args.task,
        is_regression_task(args.task),
        args.max_length,
        args.num_samples,
    )
    results = search.evaluate_best_trials(
        study, loader_factory, args.task, is_regression_task(args.task)
    )
    save_results(args, results, "conditional_search_best")
    return study


def _prompting_setup(args):
    config_cls = get_config_cls(args.model_arch)
    model_config = config_cls.from_pretrained(args.model_name)
    flat = load_flat_state_dict(args.model_name)
    params = get_params_loader(args.model_arch)(flat, model_config, task="lm",
                                                device=args.device)
    tokenizer = get_tokenizer(args)
    return params, tokenizer, checkpoint_config_kwargs(model_config)


def cli_search_quantisation_on_prompting_cls_tasks(argv=None):
    """Reference cli_search_quantisation_on_prompting_cls_tasks
    (cli/search_quantization_promting_cls.py:14)."""
    parser = argparse.ArgumentParser("search_quantisation_prompting_cls")
    add_common_model_args(parser)
    parser.add_argument("--tasks", nargs="+", required=True)
    parser.add_argument("--search_config", required=True)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    params, tokenizer, mck = _prompting_setup(args)
    search = SearchQuantisationForPromptingCLS(
        args.model_arch,
        args.model_name,
        args.search_config,
        args.save_dir or "search_out",
        params,
        tokenizer,
        model_config_kwargs=mck,
    )
    study = search.search_prompting(args.tasks, args.max_length, limit=args.limit)
    results = search.evaluate_best_trials_prompting(
        study, args.tasks, limit=args.limit
    )
    save_results(args, results, "prompting_search_best")
    return study


def cli_conditional_search_quantisation_on_prompting_cls_tasks(argv=None):
    """Reference cli_conditional_search_quantization_on_prompting_cls_tasks
    (cli/search_int_quantization_promting_cls.py)."""
    parser = argparse.ArgumentParser("conditional_search_prompting_cls")
    add_common_model_args(parser)
    parser.add_argument("--tasks", nargs="+", required=True)
    parser.add_argument("--search_config", required=True)
    parser.add_argument("--stat_profile", required=True)
    parser.add_argument("--range_entry", default="range_min_max")
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    params, tokenizer, mck = _prompting_setup(args)
    search = SearchIntQuantisationForPromptingCLS(
        args.model_arch,
        args.model_name,
        args.search_config,
        args.save_dir or "search_out",
        params,
        tokenizer,
        stat_profile=load_config(args.stat_profile),
        range_entry=args.range_entry,
        model_config_kwargs=mck,
    )
    study = search.search_prompting(args.tasks, args.max_length, limit=args.limit)
    results = search.evaluate_best_trials_prompting(
        study, args.tasks, limit=args.limit
    )
    save_results(args, results, "conditional_prompting_search_best")
    return study


def cli_extract_quant_config_and_prompting_eval(argv=None):
    """Reference cli_extract_quant_config_and_prompting_eval
    (cli/extract_quant_config_promting_cls.py:17): re-extract a trial's
    config from study.pkl and re-evaluate on prompting tasks."""
    parser = argparse.ArgumentParser("extract_quant_config_prompting_eval")
    add_common_model_args(parser)
    parser.add_argument("--tasks", nargs="+", required=True)
    parser.add_argument("--study", required=True)
    parser.add_argument("--trial_number", type=int, default=None)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    params, tokenizer, _ = _prompting_setup(args)
    qc = extract_quant_config(args.study, args.trial_number)
    config_cls = get_config_cls(args.model_arch)
    model_config = config_cls.from_pretrained(args.model_name, quant_config=qc)
    fwd = make_forward(args.model_arch, "lm", model_config)
    results = eval_prompting_tasks(
        fwd, params, tokenizer, args.tasks, limit=args.limit
    )
    save_results(args, results, "extracted_prompting_eval")
    return results


def cli_transform_stat_profile_to_int_quant_config(argv=None):
    parser = argparse.ArgumentParser("transform_stat_profile_to_int_config")
    parser.add_argument("--model_arch", required=True)
    parser.add_argument("--stat_profile", required=True)
    parser.add_argument("--range_entry", default="range_min_max")
    parser.add_argument("--width", type=int, default=8)
    parser.add_argument("--num_hidden_layers", type=int, required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    stat_profile = load_config(args.stat_profile)
    qc = transform_stat_profile_to_int_quant_config(
        stat_profile, args.range_entry, width=args.width
    )
    qc = get_stat_config_formatter(args.model_arch)(qc, args.num_hidden_layers)
    save_config(qc, args.output)
    print(f"saved {args.output}")
    return qc


def cli_extract_quant_config(argv=None):
    parser = argparse.ArgumentParser("extract_quant_config")
    parser.add_argument("--study", required=True, help="study.pkl path")
    parser.add_argument("--trial_number", type=int, default=None)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    qc = extract_quant_config(args.study, args.trial_number, args.output)
    print(f"saved {args.output}")
    return qc
