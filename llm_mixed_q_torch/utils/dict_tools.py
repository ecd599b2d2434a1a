"""Nested-dict flatten/expand with ':'-joined keys (counterpart of the JAX
package's ``utils/dict_tools.py``). Flat keys look like
``root:model_layer_0:self_attn:q_proj:weight_width``: the names of search
trial parameters and of statistic-profile entries."""

from __future__ import annotations


def flatten_dict(d: dict, new_d: dict, join: str = ":", name: str = "root") -> dict:
    """Flatten a nested dict into ``new_d`` with ``join``-separated keys."""
    for k, v in d.items():
        if isinstance(v, dict):
            flatten_dict(v, new_d, join, f"{name}{join}{k}")
        else:
            new_d[f"{name}{join}{k}"] = v
    return new_d


def _create_nested_dict(d: dict, key_list: list[str], value):
    if len(key_list) == 1:
        if key_list[0] not in d:
            d[key_list[0]] = value
        elif isinstance(d[key_list[0]], dict):
            d[key_list[0]].update(value)
        else:
            raise ValueError(f"Cannot expand dict at key {key_list[0]}")
    else:
        if key_list[0] not in d:
            d[key_list[0]] = {}
        _create_nested_dict(d[key_list[0]], key_list[1:], value)


def expand_dict(d: dict, new_d: dict, join: str = ":", name: str = "root") -> dict:
    """Inverse of ``flatten_dict``."""
    for k, v in d.items():
        _create_nested_dict(new_d, k.removeprefix(f"{name}{join}").split(join), v)
    return new_d
