"""Symmetric fixed-point (integer) fake quantizer:
qdq(x) = clamp(round(x * 2^frac_width), int_min, int_max) / 2^frac_width,
round half to even."""

from __future__ import annotations

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
