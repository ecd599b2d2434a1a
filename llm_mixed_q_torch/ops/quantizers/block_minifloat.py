"""Block minifloat fake quantizer (counterpart of the JAX package's
``ops/quantizers/block_minifloat.py``): per block, a shared exponent bias
clamp(floor(log2(block abs max)), 0, 2^bias_width - 1), then each element
minifloat_ieee-quantized with its block's bias. floor(log2) is that of
the float32 log2, computed exactly (``exact.floor_log2_f32``)."""

from __future__ import annotations

import torch

from .blocking import block_abs_max
from .exact import floor_log2_f32
from .minifloat import _minifloat_ieee_qdq
from .ste import ste


def _block_minifloat_qdq(x: torch.Tensor, width: int, exponent_width: int,
                         exponent_bias_width: int, block_size=(16,),
                         skip_first_dim: bool = False) -> torch.Tensor:
    per_block_max = block_abs_max(x, block_size, skip_first_dim)
    per_block_bias = floor_log2_f32(per_block_max).clamp(0, 2**exponent_bias_width - 1)
    return _minifloat_ieee_qdq(x, width=width, exponent_width=exponent_width,
                               exponent_bias=per_block_bias)


block_minifloat_quantizer = ste(_block_minifloat_qdq)
