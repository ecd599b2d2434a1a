"""TOML load and save with the reference's "NA" <-> None convention
(counterpart of the JAX package's ``utils/toml_io.py``). Python ships
``tomllib``, which only reads, so the writer is written here; its text is
byte-equal to the JAX package's writer's."""

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


def convert_none_to_str_na(d):
    """None -> 'NA', recursively (reference config_load.py:28-47)."""
    if isinstance(d, dict):
        return {k: convert_none_to_str_na(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(convert_none_to_str_na(v) for v in d)
    return "NA" if d is None else d


def load_config(config_path: str | Path) -> dict:
    """Load a TOML config, converting 'NA' to None (config_load.py:49-55)."""
    with open(config_path, "rb") as f:
        config = tomllib.load(f)
    return convert_str_na_to_none(config)


def save_config(config: dict, config_path: str | Path):
    """Save a config as TOML, converting None to 'NA' (config_load.py:58-64)."""
    config = convert_none_to_str_na(config)
    Path(config_path).parent.mkdir(parents=True, exist_ok=True)
    with open(config_path, "w") as f:
        f.write(dumps_toml(config))


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, (list, tuple)):
        return "[ " + ", ".join(_fmt_value(i) for i in v) + " ]"
    raise TypeError(f"Cannot serialize {type(v)} to TOML: {v!r}")


def _fmt_key(k: str) -> str:
    if k and all(c.isalnum() or c in "-_" for c in k):
        return k
    return _fmt_value(str(k))


def dumps_toml(d: dict, _prefix: str = "") -> str:
    """A minimal TOML writer: a table's scalars and lists first, then its
    nested tables."""
    lines = []
    tables = []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{_fmt_key(k)} = {_fmt_value(v)}")
    out = "\n".join(lines)
    for k, v in tables:
        full = f"{_prefix}{_fmt_key(k)}"
        body = dumps_toml(v, _prefix=full + ".")
        out += f"\n\n[{full}]\n{body}" if body.strip() else f"\n\n[{full}]"
    return out.lstrip("\n")
