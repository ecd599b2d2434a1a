"""Block base-2 log fake quantizer (counterpart of the JAX package's
``ops/quantizers/block_log.py``): per block, a shared log bias
clamp(2^(width-1) - 1 - ceil(log2(block abs max)), 0, 2^bias_width - 1),
then elementwise log quantization with that bias. ceil(log2) is that of
the float32 log2, computed exactly (``exact.ceil_log2_f32``)."""

from __future__ import annotations

import torch

from .blocking import block_abs_max
from .exact import ceil_log2_f32
from .log import _log_qdq
from .ste import ste


def _block_log_qdq(x: torch.Tensor, width: int, exponent_bias_width: int = None,
                   block_size=(16,), skip_first_dim: bool = False) -> torch.Tensor:
    exponent_bits = width - 1
    per_block_max = block_abs_max(x, block_size, skip_first_dim)
    per_block_bias = (2**exponent_bits - 1 - ceil_log2_f32(per_block_max)).clamp(
        0, 2**exponent_bias_width - 1)
    return _log_qdq(x, width=width, exponent_bias=per_block_bias)


block_log_quantizer = ste(_block_log_qdq)
