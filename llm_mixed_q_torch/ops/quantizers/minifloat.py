"""Minifloat fake quantizers, denorm and IEEE-like (counterpart of the JAX
package's ``ops/quantizers/minifloat.py``).

- denorm: no implicit leading bit; exponent = ceil(log2(|x| + 1e-9))
  clamped, mantissa in [0, 1). Saturates; no inf or NaN.
- ieee: implicit leading bit and subnormals; exponent = floor(log2(|x| +
  1e-9)) clamped; normal mantissa 1 + m / 2^mb, subnormal m / 2^mb * 2.

``exponent_bias`` of the ieee variant may be a broadcastable float32
tensor: block_minifloat runs this core with a bias shared by each block.
The arithmetic is the JAX package's, in float32 (epsilons, isclose
thresholds, round half to even); the exponents are floor and ceil of the
float32 log2, computed exactly (``exact.py``).
"""

from __future__ import annotations

import torch

from .exact import ceil_log2_f32, exact_exp2, floor_log2_f32
from .ste import ste

# torch.isclose(x, 0) defaults: |x| <= atol + rtol*|0| = 1e-8
_ATOL = 1e-8
_RTOL = 1e-5


def _default_bias(exponent_width: int, exponent_bias):
    if not isinstance(exponent_bias, torch.Tensor) and exponent_bias in (None, "none", "None"):
        return 2 ** (exponent_width - 1) - 1
    return exponent_bias


def _minifloat_denorm_qdq(x: torch.Tensor, width: int, exponent_width: int,
                          exponent_bias=None) -> torch.Tensor:
    mantissa_bits = width - exponent_width - 1
    exponent_bias = _default_bias(exponent_width, exponent_bias)

    exponent_max = 2**exponent_width - 1 - exponent_bias
    exponent_min = -exponent_bias
    shifted_mantissa_max = 2**mantissa_bits - 1

    sign = torch.sign(x + 1e-9)
    value = x.abs()
    exponent = ceil_log2_f32(value + 1e-9).clamp(exponent_min, exponent_max)

    two_e = exact_exp2(exponent)
    mantissa = value / two_e
    shift = 2**mantissa_bits
    shifted_mantissa = torch.round(mantissa * shift).clamp(0, shifted_mantissa_max)
    mantissa = shifted_mantissa / shift
    return torch.where(value <= _ATOL, x, sign * two_e * mantissa)


def _minifloat_ieee_qdq(x: torch.Tensor, width: int, exponent_width: int,
                        exponent_bias=None) -> torch.Tensor:
    mantissa_bits = width - exponent_width - 1
    exponent_bias = torch.as_tensor(_default_bias(exponent_width, exponent_bias),
                                    dtype=torch.float32, device=x.device)

    exponent_max = 2**exponent_width - 1 - exponent_bias
    exponent_min = -exponent_bias
    shift = 2**mantissa_bits
    shifted_mantissa_max = 2**mantissa_bits - 1

    sign = torch.sign(x + 1e-9)
    value = x.abs()
    exponent = torch.clamp(floor_log2_f32(value + 1e-9), exponent_min, exponent_max)
    two_e = exact_exp2(exponent)
    mantissa = value / two_e

    # subnormal iff the clamped exponent hit -bias (the reference's isclose)
    is_normal = (exponent - exponent_min).abs() > (_ATOL + _RTOL * exponent_bias.abs())

    sm_normal = torch.round(mantissa * shift - shift).clamp(0, shifted_mantissa_max)
    sm_subnormal = torch.round(mantissa * shift / 2).clamp(0, shifted_mantissa_max)
    shifted_mantissa = torch.where(is_normal, sm_normal, sm_subnormal)
    mantissa = torch.where(is_normal, 1.0 + shifted_mantissa / shift,
                           shifted_mantissa / shift * 2)
    return torch.where(value <= _ATOL, x, sign * two_e * mantissa)


minifloat_denorm_quantizer = ste(_minifloat_denorm_qdq)
minifloat_ieee_quantizer = ste(_minifloat_ieee_qdq)
