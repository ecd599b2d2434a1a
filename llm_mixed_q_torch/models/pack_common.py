"""Packed-storage conversion of quantized-linear nodes (counterpart of the
JAX package's ``models/pack_common.py``).

block_fp nodes with [1, bs]-style blocks become int8 codes + f32 scales
(``PackedBFP``) or bit-packed sub-byte words transposed to the serving
layout (``PackedBFPSubT``); any other node keeps fake-quant semantics with
its weight quantized once here. Packing runs in torch on the tensor's own
device; the buffers are byte-identical to the JAX package's.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..kernels.packing import (
    _SLICE,
    PACKED_TYPES,
    PackedBFP,
    PackedBFPSub,
    effective_block_len,
    pack_block_fp,
    pack_block_fp_subbyte,
    transpose_subbyte,
)
from ..ops.linear import quantize_bias, quantize_weight
from .hf_loader import tree_map_tensors


def _k_stride(bs: int, in_features: int) -> int | None:
    """K padding stride of int8 packing: 1024 whenever K >= 1024 and the
    block divides it (7B down_proj 11008 -> 11264), as the JAX package
    packs it, so the buffers stay interchangeable."""
    if in_features >= 1024 and 1024 % bs == 0:
        return 1024
    return None


def _packable_cfg(node_cfg: dict, w) -> bool:
    return (
        node_cfg.get("name") == "block_fp"
        and not node_cfg.get("bypass", False)
        and effective_block_len(node_cfg["weight_block_size"], w.shape[1]) is not None
    )


def _concat_packed(packed_list):
    """Concatenate per-node packed tensors along out features."""
    first = packed_list[0]
    out = sum(p.out_features for p in packed_list)
    if isinstance(first, PackedBFPSub):
        return PackedBFPSub(
            torch.cat([p.words for p in packed_list], dim=0),
            torch.cat([p.scales for p in packed_list], dim=1),
            first.width, first.block_size, out, first.in_features,
        )
    return PackedBFP(
        torch.cat([p.codes for p in packed_list], dim=0),
        torch.cat([p.scales for p in packed_list], dim=0),
        first.width, first.block_size, out, first.in_features,
    )


def _to_t(p):
    """PackedBFPSub -> the transposed serving layout."""
    return transpose_subbyte(p) if isinstance(p, PackedBFPSub) else p


def _pack_weight(w, cfg: dict, subbyte: bool):
    width = cfg["weight_width"]
    bs = effective_block_len(cfg["weight_block_size"], w.shape[1])
    ew = cfg["weight_exponent_width"]
    eb = cfg["weight_exponent_bias"]
    if subbyte and width < 8 and _SLICE % bs == 0:
        return pack_block_fp_subbyte(w, width, ew, eb, cfg["weight_block_size"])
    return pack_block_fp(w, width, ew, eb, cfg["weight_block_size"],
                         k_stride=_k_stride(bs, w.shape[1]))


def pack_fused_nodes(nodes: list[dict], cfgs: list[dict], subbyte: bool = False):
    """Pack several linear nodes that share one input into one node
    ``{"weight", "bias"?, "splits"}``, or None when they cannot fuse
    (different configs, an unpackable weight, different K, or biases on
    some nodes only)."""
    if any(c != cfgs[0] for c in cfgs[1:]):
        return None
    cfg = cfgs[0]
    ws = [n["weight"] for n in nodes]
    if not all(_packable_cfg(cfg, w) for w in ws):
        return None
    if len({w.shape[1] for w in ws}) != 1:
        return None
    biases = [n.get("bias") for n in nodes]
    if any(b is None for b in biases) != all(b is None for b in biases):
        return None
    fused = {
        "weight": _to_t(_concat_packed([_pack_weight(w, cfg, subbyte) for w in ws])),
        "splits": tuple(int(w.shape[0]) for w in ws),
    }
    if biases[0] is not None:
        fused["bias"] = torch.cat([quantize_bias(b, cfg) for b in biases], dim=0)
    return fused


def pack_linear_node(node: dict, node_cfg: dict, subbyte: bool = True) -> dict:
    """One linear node {weight, bias?} -> packed (or fake-quantized) node.
    A node whose weight is already packed passes through."""
    node = dict(node)
    w = node["weight"]
    if isinstance(w, PACKED_TYPES):
        return node
    if _packable_cfg(node_cfg, w):
        node["weight"] = _to_t(_pack_weight(w, node_cfg, subbyte))
    else:
        node["weight"] = quantize_weight(w, node_cfg)
    if node.get("bias") is not None:
        node["bias"] = quantize_bias(node["bias"], node_cfg)
    return node


@torch.no_grad()
def pack_params(params: dict, config, pack_layer, device=None) -> dict:
    """``params`` moved to ``device`` (the card unless ``device="cpu"``) one
    layer at a time, each layer packed by ``pack_layer(layer, layer_cfg)``
    as it arrives; without a quant config the layers only move."""
    device = resolve_device(device)
    to_dev = lambda tree: tree_map_tensors(lambda t: t.to(device), tree)
    new_params = {k: to_dev(v) for k, v in params.items() if k != "layers"}
    qc = config.quant_config
    new_params["layers"] = [
        to_dev(layer) if qc is None else pack_layer(to_dev(layer), qc[f"model_layer_{i}"])
        for i, layer in enumerate(params["layers"])
    ]
    return new_params
