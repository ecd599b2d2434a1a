"""Statistic-profiling CLIs (counterpart of the JAX package's
``cli/profile_statistics.py``; reference cli/profile_statistics.py:25,107):
the float model of a local checkpoint over a dataset's train split, its
statistics written to ``<save_dir>/statistic_profile.toml``.

- ``cli_profile_statistics_cls_glue``: a GLUE task, the ``cls`` model;
- ``cli_profile_statistics_lm``: Wikitext2, the ``lm`` model.

``--device`` (default ``cuda``) holds the parameters and runs the forward.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..datasets import get_raw_dataset_dict, numpy_dataloader, preprocess_dataset_dict
from ..models import get_config_cls, get_model_fn, get_params_loader
from ..models.hf_loader import load_flat_state_dict
from ..stats import profile_statistics
from ..utils import save_config
from .common import add_common_model_args, get_tokenizer


def _profile(args, task: str, dataset_name: str, split: str):
    config = get_config_cls(args.model_arch).from_pretrained(args.model_name, quant_config=None)
    flat = load_flat_state_dict(args.model_name)
    params = get_params_loader(args.model_arch)(flat, config, task=task, device=args.device)
    tokenizer = get_tokenizer(args)
    raw = get_raw_dataset_dict(dataset_name)
    ds = preprocess_dataset_dict(raw, dataset_name, tokenizer, "max_length", args.max_length)
    batches = numpy_dataloader(ds[split], batch_size=args.batch_size)
    profile = profile_statistics(batches=batches, arch=args.model_arch,
                                 model_fn=get_model_fn(args.model_arch, task), config=config,
                                 params=params, num_samples=args.num_samples)
    out = Path(args.save_dir or ".") / "statistic_profile.toml"
    save_config(profile, out)
    print(f"saved {out} ({len(profile)} entries)")
    return profile


def cli_profile_statistics_cls_glue(argv=None):
    parser = argparse.ArgumentParser("profile_statistics_cls_glue")
    add_common_model_args(parser)
    parser.add_argument("--task", required=True)
    args = parser.parse_args(argv)
    return _profile(args, "cls", args.task, "train")


def cli_profile_statistics_lm(argv=None):
    parser = argparse.ArgumentParser("profile_statistics_lm")
    add_common_model_args(parser)
    args = parser.parse_args(argv)
    return _profile(args, "lm", "wikitext2", "train")
