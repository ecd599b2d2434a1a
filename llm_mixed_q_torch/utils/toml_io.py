"""TOML loading with the reference's "NA" -> None convention (counterpart
of the JAX package's ``utils/toml_io.py``; the writer is not needed by the
serving slice and is not copied)."""

from __future__ import annotations

import tomllib
from pathlib import Path


def convert_str_na_to_none(d):
    """'NA' -> None, recursively (reference config_load.py:6-25)."""
    if isinstance(d, dict):
        return {k: convert_str_na_to_none(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(convert_str_na_to_none(v) for v in d)
    return None if d == "NA" else d


def load_config(config_path: str | Path) -> dict:
    """Load a TOML config, converting 'NA' to None (config_load.py:49-55)."""
    with open(config_path, "rb") as f:
        config = tomllib.load(f)
    return convert_str_na_to_none(config)
