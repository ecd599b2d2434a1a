"""Statistic profile -> integer quant config (counterpart of the JAX
package's ``config/stat_to_int.py``; reference
stat_profile_to_quant_config.py). An entry of width w whose range reaches
max_half_range gets frac_width = floor(log2((2^(w-1) - 1) / max_half_range)),
or the largest of ``frac_choices`` at or below it; the nested config is
rebuilt from the ``root:<layer>:...:<entry>`` names."""

from __future__ import annotations

import math


def find_int_frac_width(width: int, max_half_range: float, frac_choices=None) -> int:
    if not max_half_range > 0:
        raise ValueError(f"max_half_range must be positive, got {max_half_range}")
    if not width > 0:
        raise ValueError(f"width must be positive, got {width}")
    upper_limit = 2 ** (width - 1) - 1
    frac_width = math.floor(math.log2(upper_limit / max_half_range))
    if frac_choices is not None:
        frac_width = max(filter(lambda x: x <= frac_width, frac_choices))
    return frac_width


def create_nested_dict(d: dict, key_list: list[str], value):
    if len(key_list) == 1:
        if key_list[0] not in d:
            d[key_list[0]] = value
        elif isinstance(d[key_list[0]], dict):
            d[key_list[0]].update(value)
        else:
            raise ValueError(f"Cannot create nested dict at {key_list}")
    else:
        if key_list[0] not in d:
            d[key_list[0]] = {}
        create_nested_dict(d[key_list[0]], key_list[1:], value)


def transform_stat_profile_to_int_quant_config(
    stat_profile: dict,
    range_entry: str,
    width: int | dict,
    frac_choices=None,
    root_name: str = "root",
    is_ptq: bool = True,
    bypass: bool = False,
) -> dict:
    """``width``: one width for every entry, or ``{"<name>_width": w}`` by
    profile name; ``frac_choices``: None, one list for every entry, or a
    list by profile name."""
    quant_config: dict = {}
    for name, stat in stat_profile.items():
        tgt_stat = stat[range_entry]
        max_half_range = max(abs(tgt_stat["min"]), abs(tgt_stat["max"]))

        if isinstance(width, dict):
            entry_width = width[f"{name}_width"]
        elif isinstance(width, int):
            entry_width = width
        else:
            raise ValueError(f"Unknown type of width: {type(width)}")

        if isinstance(frac_choices, dict):
            entry_frac_choices = frac_choices[name]
        elif isinstance(frac_choices, (list, tuple)):
            entry_frac_choices = frac_choices
        elif frac_choices is None:
            entry_frac_choices = None
        else:
            raise ValueError(f"Unknown type of frac_choices: {type(frac_choices)}")

        entry_frac_width = find_int_frac_width(entry_width, max_half_range,
                                               entry_frac_choices)

        name = name.removeprefix(f"{root_name}:")
        layer_name_keys, entry_name = name.split(":")[:-1], name.split(":")[-1]
        create_nested_dict(
            quant_config,
            layer_name_keys,
            {
                "bypass": bypass,
                "name": "integer",
                "is_ptq": is_ptq,
                f"{entry_name}_width": entry_width,
                f"{entry_name}_frac_width": entry_frac_width,
            },
        )
    return quant_config
