"""Quantizer registry. This slice ports block_fp and integer, the two
arithmetics of the packed serving configs; the other five raise until they
are ported."""

from .block_fp import _block_fp_qdq, block_fp_quantizer
from .blocking import block_abs_max, infer_block_shape
from .integer import _integer_qdq, integer_quantizer

QUANTIZER_MAP = {
    "block_fp": block_fp_quantizer,
    "integer": integer_quantizer,
}

NOT_PORTED = (
    "block_log",
    "block_minifloat",
    "log",
    "minifloat_denorm",
    "minifloat_ieee",
)


def get_quantizer(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(f"quantizer {name!r} is not ported yet")
    return QUANTIZER_MAP[name]
