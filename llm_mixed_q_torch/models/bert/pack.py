"""Convert BERT linear weights to packed BFP storage (counterpart of the JAX
package's ``models/bert/pack.py``): attention.{query,key,value},
attention.output.dense, intermediate.dense and output.dense through
``pack_linear_node``. ``subbyte=True`` (default) stores bit-packed sub-byte
words in the transposed serving layout (kernel K1 at up to 256 rows);
``subbyte=False`` int8 codes (K2). Biases are quantized at pack time."""

from __future__ import annotations

from functools import partial

from ..pack_common import pack_linear_node, pack_params
from .prepare import map_linear_nodes


def pack_bert_layer(layer: dict, layer_cfg: dict, subbyte: bool = True) -> dict:
    """Pack one encoder layer's linear nodes (already packed nodes pass)."""
    return map_linear_nodes(layer, layer_cfg, partial(pack_linear_node, subbyte=subbyte))


def pack_bert_params(params: dict, config, subbyte: bool = True, device=None) -> dict:
    """Pack every layer on ``device`` (the card unless ``device="cpu"``),
    moving one layer there at a time."""
    return pack_params(params, config, partial(pack_bert_layer, subbyte=subbyte), device)
