"""Block floating point (BFP / MSFP) fake quantizer.

Per block: shared exponent = clamp(ceil(log2(block abs max))); each element
is sign + (width-1) mantissa bits of |x| / 2^e, rounded half to even, with
the reference's +1e-9 epsilons and the |x| <= 1e-8 passthrough. The
exponent is computed exactly (``exact.ceil_log2``).
"""

from __future__ import annotations

import torch

from .blocking import block_abs_max
from .exact import ceil_log2, exact_exp2
from .ste import ste

_ATOL = 1e-8


def _block_fp_qdq(
    x: torch.Tensor,
    width: int = 12,
    exponent_width: int = 8,
    exponent_bias=None,
    block_size=(16,),
    skip_first_dim: bool = True,
) -> torch.Tensor:
    # zero_fill="one": a zero block's elements all take the passthrough, so
    # the fill value never reaches the output
    per_block_max = block_abs_max(x, block_size, skip_first_dim, zero_fill="one")

    mantissa_bits = width - 1
    if exponent_bias in (None, "none", "None"):
        exponent_bias = 2 ** (exponent_width - 1) - 1
    exponent_max = 2**exponent_width - 1 - exponent_bias
    exponent_min = -exponent_bias
    mantissa_integer_max = 2**mantissa_bits - 1

    sign = torch.sign(x + 1e-9)
    value = x.abs() + 1e-9
    exponent = ceil_log2(per_block_max).clamp(exponent_min, exponent_max)

    two_e = exact_exp2(exponent)
    mantissa = value / two_e
    shift = 2**mantissa_bits
    mantissa_integer = torch.round(mantissa * shift).clamp(0, mantissa_integer_max)
    mantissa = mantissa_integer / shift

    msfp = sign * two_e * mantissa
    return torch.where(x.abs() <= _ATOL, x, msfp)


block_fp_quantizer = ste(_block_fp_qdq)
