"""Convert Llama linear weights to packed BFP storage (counterpart of the
JAX package's ``models/llama/pack.py``).

``subbyte=False`` (default) stores int8 codes + f32 scales; ``subbyte=True``
stores bit-packed sub-byte words in the transposed serving layout.
``fuse=True`` merges q/k/v into one ``qkv_proj`` node and gate/up into
``gate_up_proj`` whenever the member configs are identical: one kernel
launch and one activation quantize instead of three / two.
``bf16_embed=True`` stores the embedding table and lm_head in bfloat16.
``pack_llama_params_host`` packs on the host (``pack_common``'s
``host=True``), so only the packed bytes move to the card.
"""

from __future__ import annotations

from functools import partial

import torch

from ..pack_common import pack_fused_nodes, pack_linear_node, pack_params
from .prepare import _LLAMA_LINEARS

_FUSE_GROUPS = {
    "self_attn": ("qkv_proj", ("q_proj", "k_proj", "v_proj")),
    "mlp": ("gate_up_proj", ("gate_proj", "up_proj")),
}


def pack_llama_layer(layer: dict, layer_cfg: dict, subbyte: bool = False,
                     fuse: bool = True, host: bool = False) -> dict:
    """Pack one decoder layer's linear nodes (already packed nodes pass);
    ``host``: on the host."""
    new_layer = dict(layer)
    for group, names in _LLAMA_LINEARS.items():
        new_group = dict(layer[group])
        done = set()
        if fuse and group in _FUSE_GROUPS:
            fused_name, members = _FUSE_GROUPS[group]
            if all(m in new_group for m in members):
                fused = pack_fused_nodes(
                    [new_group[m] for m in members],
                    [layer_cfg[group][m] for m in members], subbyte, host,
                )
                if fused is not None:
                    new_group[fused_name] = fused
                    for m in members:
                        del new_group[m]
                    done.update(members)
        for name in names:
            if name in done or name not in new_group:
                continue
            new_group[name] = pack_linear_node(
                new_group[name], layer_cfg[group][name], subbyte, host)
        new_layer[group] = new_group
    return new_layer


@torch.no_grad()
def pack_llama_params(params: dict, config, subbyte: bool = False,
                      fuse: bool = True, bf16_embed: bool = False,
                      device=None, host: bool = False) -> dict:
    """Pack every layer on ``device`` (the card unless ``device="cpu"``),
    moving one layer there at a time; with ``host`` each layer is packed on
    the host first. ``bf16_embed`` also stores the embedding table and an
    untied lm_head in bfloat16 (the serving option: it halves the largest
    dense weight stream of a decode step; the backbone still computes in
    float32)."""
    if bf16_embed and config.quant_config is not None:
        params = dict(params)
        for name in ("embed_tokens", "lm_head"):
            if name in params:
                params[name] = {**params[name],
                                "weight": params[name]["weight"].to(torch.bfloat16)}
    return pack_params(params, config,
                       partial(pack_llama_layer, subbyte=subbyte, fuse=fuse, host=host),
                       device, host)


def pack_llama_params_host(params: dict, config, subbyte: bool = False, fuse: bool = True,
                           bf16_embed: bool = False, device=None) -> dict:
    """``pack_llama_params`` with every layer packed on the host (the
    native C++ engine), so that only the packed bytes (about a quarter of
    the float32 weights as int8 codes, a fifth sub-byte at width 6) move to
    the card: for a model whose float32 weights do not fit it."""
    return pack_llama_params(params, config, subbyte, fuse, bf16_embed, device, host=True)
