"""Packed-storage conversion of quantized-linear nodes (counterpart of the
JAX package's ``models/pack_common.py``).

block_fp nodes with [1, bs]-style blocks become int8 codes + f32 scales
(``PackedBFP``) or bit-packed sub-byte words transposed to the serving
layout (``PackedBFPSubT``); any other node keeps fake-quant semantics with
its weight quantized once here. Packing runs in torch on the tensor's own
device, or with ``host=True`` on the host: the C++ engine of
``llm_mixed_q_torch.native`` (the torch packer on the CPU where there is no
g++), so that only the packed bytes cross to the card. The buffers are
byte-identical to the JAX package's, and the host's to the device's.
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


def _pack_weight(w, cfg: dict, subbyte: bool, host: bool = False):
    width = cfg["weight_width"]
    bs = effective_block_len(cfg["weight_block_size"], w.shape[1])
    ew = cfg["weight_exponent_width"]
    eb = cfg["weight_exponent_bias"]
    if host:
        return _pack_host(w, width, ew, eb, bs, subbyte and width < 8 and _SLICE % bs == 0)
    if subbyte and width < 8 and _SLICE % bs == 0:
        return pack_block_fp_subbyte(w, width, ew, eb, cfg["weight_block_size"])
    return pack_block_fp(w, width, ew, eb, cfg["weight_block_size"],
                         k_stride=_k_stride(bs, w.shape[1]))


def _pack_host(w, width, ew, eb, bs, use_sub):
    """Pack on the host with the native engine -> CPU tensors; the torch
    packer on the CPU when the engine is unavailable (the same bits)."""
    from ..native import native_pack_int8, native_pack_subbyte

    w = w.detach().cpu()
    out_features, in_features = w.shape
    stride = _k_stride(bs, in_features)
    if use_sub:
        res = native_pack_subbyte(w.numpy(), width, ew, eb, bs)
        if res is None:
            return pack_block_fp_subbyte(w, width, ew, eb, [1, bs])
        words, scales = res
        return PackedBFPSub(torch.from_numpy(words), torch.from_numpy(scales), width, bs,
                            out_features, in_features)
    res = native_pack_int8(w.numpy(), width, ew, eb, bs, k_stride=stride)
    if res is None:
        return pack_block_fp(w, width, ew, eb, [1, bs], k_stride=stride)
    codes, scales = res
    return PackedBFP(torch.from_numpy(codes), torch.from_numpy(scales), width, bs,
                     out_features, in_features)


def _on_host_if(host: bool, fn, x, cfg):
    """``fn(x, cfg)``, on the CPU with ``host``."""
    return fn(x.cpu() if host else x, cfg)


def pack_fused_nodes(nodes: list[dict], cfgs: list[dict], subbyte: bool = False,
                     host: bool = False):
    """Pack several linear nodes that share one input into one node
    ``{"weight", "bias"?, "splits"}``, or None when they cannot fuse
    (different configs, an unpackable weight, different K, or biases on
    some nodes only). ``host``: pack on the host (CPU tensors)."""
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
        "weight": _to_t(_concat_packed([_pack_weight(w, cfg, subbyte, host) for w in ws])),
        "splits": tuple(int(w.shape[0]) for w in ws),
    }
    if biases[0] is not None:
        fused["bias"] = torch.cat([_on_host_if(host, quantize_bias, b, cfg) for b in biases],
                                  dim=0)
    return fused


def pack_linear_node(node: dict, node_cfg: dict, subbyte: bool = True,
                     host: bool = False) -> dict:
    """One linear node {weight, bias?} -> packed (or fake-quantized) node.
    A node whose weight is already packed passes through. ``host``: pack
    on the host, and quantize the other weights and the biases on the CPU
    (CPU tensors)."""
    node = dict(node)
    w = node["weight"]
    if isinstance(w, PACKED_TYPES):
        return node
    if _packable_cfg(node_cfg, w):
        node["weight"] = _to_t(_pack_weight(w, node_cfg, subbyte, host))
    else:
        node["weight"] = _on_host_if(host, quantize_weight, w, node_cfg)
    if node.get("bias") is not None:
        node["bias"] = _on_host_if(host, quantize_bias, node["bias"], node_cfg)
    return node


@torch.no_grad()
def pack_params(params: dict, config, pack_layer, device=None, host: bool = False) -> dict:
    """``params`` moved to ``device`` (the card unless ``device="cpu"``) one
    layer at a time, each layer packed by ``pack_layer(layer, layer_cfg)``:
    on the device as it arrives, or with ``host`` on the host before it
    moves (``pack_layer`` then packs on the host), so that only packed
    bytes cross. Without a quant config the layers only move."""
    device = resolve_device(device)
    to_dev = lambda tree: tree_map_tensors(lambda t: t.to(device), tree)
    to_host = lambda tree: tree_map_tensors(lambda t: t.cpu(), tree)
    new_params = {k: to_dev(v) for k, v in params.items() if k != "layers"}
    qc = config.quant_config

    def layer_on_device(i, layer):
        if qc is None:
            return to_dev(layer)
        if host:
            return to_dev(pack_layer(to_host(layer), qc[f"model_layer_{i}"]))
        return pack_layer(to_dev(layer), qc[f"model_layer_{i}"])

    new_params["layers"] = [layer_on_device(i, layer) for i, layer in enumerate(params["layers"])]
    return new_params
