"""Quantized op functions: entry-quantizer factory, matmul/bmm, RoPE
(counterpart of the JAX package's ``ops/functions.py``).

As in the JAX package, a "log" matmul is a plain log matmul (the
reference maps it onto the block_log one), and a block_log matmul
quantizes only x (the reference builds its y quantizer and never applies
it) unless ``BLOCK_LOG_MATMUL_QUANTIZES_Y`` is switched on."""

from __future__ import annotations

from functools import partial

import torch

from .quantizers import get_quantizer

# a block_log matmul quantizes its y operand only with this switch on (the
# JAX package's switch, off by default); read at each call
BLOCK_LOG_MATMUL_QUANTIZES_Y = False

BLOCK_ARITHS = ("block_fp", "block_minifloat", "block_log")


def make_entry_quantizer(config: dict, entry: str, skip_first_dim: bool = False):
    """Bind a quantizer to one entry's keys (entry in weight/data_in/bias).
    Activations use skip_first_dim=True, weights and bias False."""
    name = config["name"]
    quantizer = get_quantizer(name)
    g = lambda k: config[f"{entry}_{k}"]
    if name == "integer":
        return partial(quantizer, width=g("width"), frac_width=g("frac_width"))
    if name in ("minifloat_denorm", "minifloat_ieee"):
        return partial(quantizer, width=g("width"), exponent_width=g("exponent_width"),
                       exponent_bias=g("exponent_bias"))
    if name == "log":
        return partial(quantizer, width=g("width"), exponent_bias=g("exponent_bias"))
    if name == "block_fp":
        return partial(quantizer, width=g("width"), exponent_width=g("exponent_width"),
                       exponent_bias=g("exponent_bias"), block_size=g("block_size"),
                       skip_first_dim=skip_first_dim)
    if name == "block_minifloat":
        return partial(quantizer, width=g("width"), exponent_width=g("exponent_width"),
                       exponent_bias_width=g("exponent_bias_width"),
                       block_size=g("block_size"), skip_first_dim=skip_first_dim)
    if name == "block_log":
        return partial(quantizer, width=g("width"),
                       exponent_bias_width=g("exponent_bias_width"),
                       block_size=g("block_size"), skip_first_dim=skip_first_dim)
    raise ValueError(f"Unknown quant arith: {name}")


def _quantize_matmul_operand(x, config: dict, entry: str):
    """Block ariths flatten leading dims to rank 3 and block over the last
    two dims; elementwise ariths apply directly."""
    if config["name"] in BLOCK_ARITHS:
        more_than_2 = x.ndim > 2
        q = make_entry_quantizer(config, entry, skip_first_dim=more_than_2)
        if more_than_2:
            shape = x.shape
            return q(x.reshape((-1,) + tuple(shape[-2:]))).reshape(shape)
        return q(x)
    return make_entry_quantizer(config, entry)(x)


def quantized_matmul(x, y, config: dict, style: str = "matmul"):
    """q(x) @ q(y): x takes the data_in_* keys, y the weight_* keys.
    ``style`` ("matmul" | "bmm") names the reference op; ``torch.matmul``
    covers both."""
    if config.get("bypass", False):
        return torch.matmul(x, y)
    x = _quantize_matmul_operand(x, config, "data_in")
    if config["name"] != "block_log" or BLOCK_LOG_MATMUL_QUANTIZES_Y:
        y = _quantize_matmul_operand(y, config, "weight")
    return torch.matmul(x, y)


def quantized_bmm(x, y, config: dict):
    return quantized_matmul(x, y, config, style="bmm")


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def quantized_apply_rotary_pos_emb(q, k, cos, sin, position_ids, config: dict):
    """RoPE with quantized cos/sin tables [seq_len, dim]; the rotation itself
    stays full precision. ``position_ids`` is [batch, seq] and is clamped to
    the table, as an out-of-range gather clamps in the JAX package."""
    if not config.get("bypass", False):
        if config["name"] in BLOCK_ARITHS:
            quantizer = make_entry_quantizer(config, "data_in", skip_first_dim=False)
        else:
            quantizer = make_entry_quantizer(config, "data_in")
        cos = quantizer(cos)
        sin = quantizer(sin)
    idx = position_ids.clamp(0, cos.shape[0] - 1)
    cos = cos[idx][:, None, :, :]  # [b, 1, seq, dim]
    sin = sin[idx][:, None, :, :]
    q_embed = (q * cos) + (_rotate_half(q) * sin)
    k_embed = (k * cos) + (_rotate_half(k) * sin)
    return q_embed, k_embed
