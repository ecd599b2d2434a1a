"""Llama parameters for the port (counterpart of the Llama part of the JAX
package's ``models/hf_loader.py``).

- ``init_llama_params``: random weights from a ``torch.Generator``, made on
  the target device one layer at a time; with ``pack=`` each layer is
  packed as soon as it exists, so a 7B model never holds all its float32
  weights at once.
- ``params_from_jax``: the JAX package's parameter tree, given as numpy
  arrays (``jax.tree.map(np.asarray, params)``), as the port's tree. Packed
  nodes (``PackedBFP``, ``PackedBFPSub``, ``PackedBFPSubT``) keep their
  bytes; fused nodes keep their ``splits``.
- ``params_to_numpy``: the way back, for checking a round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..kernels.packing import PACKED_TYPES

_PACKED_BY_NAME = {cls.__name__: cls for cls in PACKED_TYPES}


def tree_map_tensors(fn, tree):
    """Apply ``fn`` to every tensor of a parameter tree (packed nodes too)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, PACKED_TYPES):
        return tree._replace(**{f: fn(getattr(tree, f)) for f in tree._fields[:2]})
    if isinstance(tree, dict):
        return {k: tree_map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_tensors(fn, v) for v in tree]
    return tree


@torch.no_grad()
def init_llama_params(config, task: str = "lm", seed: int = 0, device=None,
                      pack: dict | None = None) -> dict:
    """Random-init parameter dict: N(0, 0.02) linear and embedding weights,
    unit norms. ``pack``: keyword arguments of ``pack_llama_params``
    (``subbyte``, ``fuse``, ``bf16_embed``) to pack each layer as it is
    made."""
    from .llama.pack import pack_llama_layer, pack_llama_params

    if task != "lm":
        raise NotImplementedError("only the causal-LM head is ported")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, inter, v = config.hidden_size, config.intermediate_size, config.vocab_size
    kvh = config.num_key_value_heads * config.head_dim

    def w(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def ones(n):
        return torch.ones(n, device=device)

    pack = dict(pack or {})
    bf16_embed = pack.pop("bf16_embed", False)
    layers = []
    for i in range(config.num_hidden_layers):
        layer = {
            "input_layernorm": {"weight": ones(h)},
            "post_attention_layernorm": {"weight": ones(h)},
            "self_attn": {
                "q_proj": {"weight": w(h, h)},
                "k_proj": {"weight": w(kvh, h)},
                "v_proj": {"weight": w(kvh, h)},
                "o_proj": {"weight": w(h, h)},
            },
            "mlp": {
                "gate_proj": {"weight": w(inter, h)},
                "up_proj": {"weight": w(inter, h)},
                "down_proj": {"weight": w(h, inter)},
            },
        }
        if pack and config.quant_config is not None:
            layer = pack_llama_layer(
                layer, config.quant_config[f"model_layer_{i}"], **pack)
        layers.append(layer)
    params = {
        "embed_tokens": {"weight": w(v, h)},
        "layers": layers,
        "norm": {"weight": ones(h)},
        "lm_head": {"weight": w(v, h)},
    }
    if bf16_embed:
        params = pack_llama_params(params, config, bf16_embed=True,
                                   device=device, **pack)
    return params


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree, device=None):
    """The JAX package's parameter tree (numpy leaves) -> the port's."""
    device = resolve_device(device)

    def conv(node):
        name = type(node).__name__
        if name in _PACKED_BY_NAME and hasattr(node, "_fields"):
            fields = dict(zip(node._fields, node))
            cls = _PACKED_BY_NAME[name]
            return cls(*(
                _tensor_from_numpy(np.asarray(fields[f]), device)
                if i < 2 else int(fields[f])
                for i, f in enumerate(cls._fields)
            ))
        if isinstance(node, dict):
            return {k: (tuple(int(s) for s in v) if k == "splits" else conv(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if isinstance(node, np.ndarray) or np.isscalar(node):
            return _tensor_from_numpy(np.asarray(node), device)
        raise TypeError(f"unexpected parameter leaf {type(node)}")

    return conv(np_tree)


def params_to_numpy(params):
    """The port's parameter tree -> numpy leaves (bf16 as float32)."""

    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map_tensors(to_np, params)
