"""Base-2 logarithmic fake quantizer (counterpart of the JAX package's
``ops/quantizers/log.py``):
x -> sign * 2^clamp(round(log2(|x| + min_pos*0.1)), -bias, 2^(w-1)-1-bias).
Zero is not representable; ``min_pos * 0.1`` keeps log2 finite.
``exponent_bias`` may be a broadcastable float32 tensor (block_log shares
one a block). round(log2) is that of the float32 log2, computed exactly
(``exact.round_log2_f32``)."""

from __future__ import annotations

import torch

from .exact import exact_exp2, round_log2_f32
from .minifloat import _default_bias
from .ste import ste


def _log_qdq(x: torch.Tensor, width: int, exponent_bias=None) -> torch.Tensor:
    exponent_bits = width - 1
    exponent_bias = torch.as_tensor(_default_bias(exponent_bits, exponent_bias),
                                    dtype=torch.float32, device=x.device)

    exponent_max = 2**exponent_bits - 1 - exponent_bias
    exponent_min = -exponent_bias
    min_pos = exact_exp2(exponent_min)

    sign = torch.sign(x + min_pos * 0.1)
    value = x.abs() + min_pos * 0.1
    exponent = torch.clamp(round_log2_f32(value), exponent_min, exponent_max)
    return sign * exact_exp2(exponent)


log_quantizer = ste(_log_qdq)
