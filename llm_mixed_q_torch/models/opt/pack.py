"""Convert OPT linear weights to packed BFP storage (counterpart of the JAX
package's ``models/opt/pack.py``): self_attn.{q,k,v,out}_proj, fc1 and fc2
through ``pack_linear_node``. ``subbyte=True`` (default) stores bit-packed
sub-byte words in the transposed serving layout; biases are quantized at
pack time."""

from __future__ import annotations

from functools import partial

from ..pack_common import pack_linear_node, pack_params
from .prepare import map_linear_nodes


def pack_opt_layer(layer: dict, layer_cfg: dict, subbyte: bool = True) -> dict:
    """Pack one decoder layer's linear nodes (already packed nodes pass)."""
    return map_linear_nodes(layer, layer_cfg, partial(pack_linear_node, subbyte=subbyte))


def pack_opt_params(params: dict, config, subbyte: bool = True, device=None) -> dict:
    """Pack every layer on ``device`` (the card unless ``device="cpu"``),
    moving one layer there at a time."""
    return pack_params(params, config, partial(pack_opt_layer, subbyte=subbyte), device)
