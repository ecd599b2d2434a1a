"""Re-extract a trial's quant config from a pickled study (counterpart of
the JAX package's ``utils/trial_extractor.py``; reference
utils/trial_extractor.py:13-47). The TOML goes through the port's writer,
byte-equal to the JAX package's."""

from __future__ import annotations

from ..search.engine import FrozenTrial, Study, decode_ast_value
from .toml_io import save_config


def parse_and_create_item(quant_config: dict, keys: list[str], value):
    for i, key in enumerate(keys):
        if key not in quant_config:
            quant_config[key] = {}
        if i == len(keys) - 1:
            quant_config[key] = value
        else:
            quant_config = quant_config[key]


def trial_to_quant_config(trial: FrozenTrial, save_path=None) -> dict:
    """A trial's params (``root:<key>:...:<entry>``) as a nested quant config,
    saved as TOML where ``save_path`` is given."""
    quant_config: dict = {}
    for name, value in trial.params.items():
        keys = name.removeprefix("root:").split(":")
        value = decode_ast_value(value)
        parse_and_create_item(quant_config, keys, value)
    if save_path is not None:
        save_config(quant_config, save_path)
    return quant_config


def extract_quant_config(study_pkl_path, trial_number: int | None = None,
                         save_path=None) -> dict:
    """The quant config of trial ``trial_number`` of a saved study, or of the
    first trial of its Pareto front."""
    study = Study.load(study_pkl_path)
    if trial_number is None:
        trials = study.best_trials
        assert trials, "No completed trials in study"
        trial = trials[0]
    else:
        trial = study.trials[trial_number]
    return trial_to_quant_config(trial, save_path)
