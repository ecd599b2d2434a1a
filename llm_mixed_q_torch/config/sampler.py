"""Categorical sampling over a dict-of-lists search space (counterpart of
the JAX package's ``config/sampler.py``; reference
quant_config_sampler.py:10-26). A choice that TOML cannot hold (a list,
None, a bool) is written as the string '!ast!<literal>' and decoded after
sampling. ``trial`` is any object with ``suggest_categorical``."""

from __future__ import annotations

import ast
from copy import deepcopy


def decode_ast_value(v):
    """'!ast!<literal>' -> literal (reference quant_config_sampler.py:13-14)."""
    if isinstance(v, str) and v.startswith("!ast!"):
        return ast.literal_eval(v.removeprefix("!ast!"))
    return v


def sample_a_list(trial, name: str, choices: list):
    if not isinstance(choices, list):
        raise TypeError(f"choices must be a list, got {choices}")
    return decode_ast_value(trial.suggest_categorical(name, deepcopy(choices)))


def sample_a_dict_of_list(trial, name: str, config: dict) -> dict:
    if not isinstance(config, dict):
        raise TypeError(f"config must be a dict, got {config}")
    return {k: sample_a_list(trial, f"{name}:{k}", v) for k, v in config.items()}
