"""Quantizer registry: the seven arithmetics of the JAX package, each a
fake quantizer (quantize -> dequantize) with a straight-through gradient."""

from .block_fp import _block_fp_qdq, block_fp_quantizer
from .block_log import _block_log_qdq, block_log_quantizer
from .block_minifloat import _block_minifloat_qdq, block_minifloat_quantizer
from .blocking import block_abs_max, infer_block_shape
from .integer import _integer_qdq, integer_fraction, integer_quantizer
from .log import _log_qdq, log_quantizer
from .minifloat import (
    _minifloat_denorm_qdq,
    _minifloat_ieee_qdq,
    minifloat_denorm_quantizer,
    minifloat_ieee_quantizer,
)

QUANTIZER_MAP = {
    "block_fp": block_fp_quantizer,
    "block_log": block_log_quantizer,
    "block_minifloat": block_minifloat_quantizer,
    "integer": integer_quantizer,
    "log": log_quantizer,
    "minifloat_denorm": minifloat_denorm_quantizer,
    "minifloat_ieee": minifloat_ieee_quantizer,
}


def get_quantizer(name: str):
    return QUANTIZER_MAP[name]
