"""Symmetric fixed-point (integer) fake quantizer:
qdq(x) = clamp(round(x * 2^frac_width), int_min, int_max) / 2^frac_width,
round half to even."""

from __future__ import annotations

from math import log2

import torch

from .ste import ste


def _integer_qdq(x: torch.Tensor, width: int, frac_width: int,
                 is_signed: bool = True) -> torch.Tensor:
    if is_signed:
        int_min = -(2 ** (width - 1))
        int_max = 2 ** (width - 1) - 1
    else:
        int_min = 0
        int_max = 2**width - 1
    scale = float(2**frac_width)
    return torch.round(x * scale).clamp(int_min, int_max) / scale


integer_quantizer = ste(_integer_qdq)


def integer_fraction(width: int, frac_choices: list, min_value: float,
                     max_value: float) -> int:
    """The largest frac_width among ``frac_choices`` that leaves the integer
    bits a value range needs (reference integer.py:98-105)."""
    max_half_range = max(abs(min_value), abs(max_value))
    int_width = int(log2(max(0.5, max_half_range))) + 2
    frac_width = max(0, width - int_width)
    return max(filter(lambda x: x <= frac_width, frac_choices))
