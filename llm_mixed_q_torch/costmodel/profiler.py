"""Analytical bit and FLOP cost model in numpy (counterpart of the JAX
package's ``costmodel/profiler.py``; reference
quantized_layer_profiler.py:10-186).

The memory density that search scores is (32 * params + 32 * acts) /
(param_bits + act_bits) (reference search.py:206-229). Only the ``integer``
and ``block_fp`` arithmetics are counted, as in the reference: any other
raises ``ValueError``, so search spaces stay within these two (the paper's
search TOMLs use block_fp only).
"""

from __future__ import annotations

import numpy as np


def compute_tensor_bits_fp(tensor_shape: np.ndarray, width: int):
    return np.prod(tensor_shape) * width


def compute_tensor_bits_integer(tensor_shape: np.ndarray, width: int):
    return np.prod(tensor_shape) * width


def compute_tensor_bits_block_fp(
    tensor_shape: np.ndarray, width: int, exponent_width: int, block_size: np.ndarray
):
    if tensor_shape.size > block_size.size:
        block_size = np.append([1] * (tensor_shape.size - block_size.size), block_size)
    elif tensor_shape.size < block_size.size:
        block_size = block_size[-tensor_shape.size :]
    num_blocks = np.prod(np.ceil(tensor_shape / block_size))
    return num_blocks * np.prod(block_size) * width + num_blocks * exponent_width


def _empty_profile():
    return {
        "num_params": 0,
        "num_acts": 0,
        "param_bits": 0,
        "act_bits": 0,
        "flops": 0,
    }


def profile_linear_layer(
    quant_config: dict, in_features: int, out_features: int, bias: bool, batch_size: int
) -> dict:
    w_shape = np.array((in_features, out_features))
    b_shape = np.array((out_features,))
    x_shape = np.array((batch_size, in_features))

    num_params = in_features * out_features + (out_features if bias else 0)
    num_xs = batch_size * in_features

    if quant_config.get("bypass", False):
        p_bits = compute_tensor_bits_fp(w_shape, 32)
        if bias:
            p_bits += compute_tensor_bits_fp(b_shape, 32)
        x_bits = compute_tensor_bits_fp(x_shape, 32)
    else:
        arith = quant_config["name"]
        w_width = quant_config["weight_width"]
        x_width = quant_config["data_in_width"]
        if arith == "integer":
            p_bits = compute_tensor_bits_integer(w_shape, w_width)
            if bias:
                p_bits += compute_tensor_bits_integer(
                    b_shape, quant_config["bias_width"]
                )
            x_bits = compute_tensor_bits_integer(x_shape, x_width)
        elif arith == "block_fp":
            p_bits = compute_tensor_bits_block_fp(
                w_shape,
                w_width,
                quant_config["weight_exponent_width"],
                np.array(quant_config["weight_block_size"]),
            )
            if bias:
                p_bits += compute_tensor_bits_block_fp(
                    b_shape,
                    quant_config["bias_width"],
                    quant_config["bias_exponent_width"],
                    np.array(quant_config["bias_block_size"]),
                )
            x_bits = compute_tensor_bits_block_fp(
                x_shape,
                x_width,
                quant_config["data_in_exponent_width"],
                np.array(quant_config["data_in_block_size"]),
            )
        else:
            raise ValueError(f"Unknown quant_arith: {arith}")

    flops = batch_size * out_features * (2 * in_features - 1)
    if bias:
        flops += batch_size * out_features
    return {
        "num_params": np.rint(num_params).astype(np.int64),
        "num_acts": np.rint(num_xs).astype(np.int64),
        "param_bits": np.rint(p_bits).astype(np.int64),
        "act_bits": np.rint(x_bits).astype(np.int64),
        "flops": np.rint(flops).astype(np.int64),
    }


def profile_matmul_layer(quant_config: dict, data_in_0_size, data_in_1_size) -> dict:
    """Two-operand matmul; operand 1 uses the *weight* block/exponent schema
    but data_in_width for its code bits — a reference quirk kept for parity
    (reference quantized_layer_profiler.py:141-146)."""
    x0_shape = np.array((data_in_0_size,))
    x1_shape = np.array((data_in_1_size,))
    num_xs = np.prod(x0_shape) + np.prod(x1_shape)

    if quant_config.get("bypass", False):
        x_bits = compute_tensor_bits_fp(x0_shape, 32) + compute_tensor_bits_fp(
            x1_shape, 32
        )
    else:
        arith = quant_config["name"]
        x0_width = quant_config["data_in_width"]
        x1_width = quant_config["data_in_width"]
        if arith == "integer":
            x_bits = compute_tensor_bits_integer(
                x0_shape, x0_width
            ) + compute_tensor_bits_integer(x1_shape, x1_width)
        elif arith == "block_fp":
            x_bits = compute_tensor_bits_block_fp(
                x0_shape,
                x0_width,
                quant_config["data_in_exponent_width"],
                np.array(quant_config["data_in_block_size"]),
            ) + compute_tensor_bits_block_fp(
                x1_shape,
                x1_width,
                quant_config["weight_exponent_width"],
                np.array(quant_config["weight_block_size"]),
            )
        else:
            raise ValueError(f"Unknown quant_arith: {arith}")

    flops = data_in_0_size[0] * data_in_1_size[1] * (2 * data_in_0_size[1] - 1)
    return {
        "num_params": np.int64(0),
        "num_acts": np.rint(num_xs).astype(np.int64),
        "param_bits": np.int64(0),
        "act_bits": np.rint(x_bits).astype(np.int64),
        "flops": np.rint(flops).astype(np.int64),
    }


def update_profile(profile: dict, delta: dict) -> dict:
    for k in ("num_params", "num_acts", "param_bits", "act_bits", "flops"):
        profile[k] += delta[k]
    return profile


def compute_memory_density(profile: dict) -> float:
    """(32*params + 32*acts)/(param_bits + act_bits) — reference search.py:206-229."""
    return (32 * profile["num_params"] + 32 * profile["num_acts"]) / (
        profile["param_bits"] + profile["act_bits"]
    )
