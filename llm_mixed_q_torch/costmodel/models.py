"""Per-model cost profilers (counterpart of the JAX package's
``costmodel/models.py``; reference profiler_llama.py:9-155,
profiler_opt.py:11-184, profiler_bert.py:13-177). Each sums its layers'
linear and matmul counts; the attention matmuls are counted a head at a
time with the reference's shapes.
"""

from __future__ import annotations

from .profiler import profile_linear_layer, profile_matmul_layer, update_profile


def _empty():
    return {"num_params": 0, "num_acts": 0, "param_bits": 0, "act_bits": 0, "flops": 0}


def _profile_attention_matmuls(profile, matmul_0_qc, matmul_1_qc, heads, seq_len, hd):
    for _ in range(heads):
        update_profile(
            profile,
            profile_matmul_layer(matmul_0_qc, (seq_len, hd), (hd, seq_len)),
        )
        update_profile(
            profile,
            profile_matmul_layer(matmul_1_qc, (seq_len, seq_len), (seq_len, hd)),
        )


def profile_llama_quantized(config, seq_len: int) -> dict:
    h, inter = config.hidden_size, config.intermediate_size
    heads = config.num_attention_heads
    hd = h // heads
    profile = _empty()
    for i in range(config.num_hidden_layers):
        lc = config.quant_config[f"model_layer_{i}"]
        sa, mlp = lc["self_attn"], lc["mlp"]
        # k_proj and v_proj are counted at h x h even under GQA, where they
        # are h x (num_key_value_heads * head_dim): the reference's count
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            update_profile(
                profile, profile_linear_layer(sa[name], h, h, False, seq_len)
            )
        _profile_attention_matmuls(
            profile, sa["matmul_0"], sa["matmul_1"], heads, seq_len, hd
        )
        update_profile(
            profile, profile_linear_layer(mlp["gate_proj"], h, inter, False, seq_len)
        )
        update_profile(
            profile, profile_linear_layer(mlp["down_proj"], inter, h, False, seq_len)
        )
        update_profile(
            profile, profile_linear_layer(mlp["up_proj"], h, inter, False, seq_len)
        )
    return profile


def profile_opt_quantized(config, seq_len: int) -> dict:
    h, ffn = config.hidden_size, config.ffn_dim
    heads = config.num_attention_heads
    hd = h // heads
    bias = config.enable_bias
    profile = _empty()
    for i in range(config.num_hidden_layers):
        lc = config.quant_config[f"model_layer_{i}"]
        sa = lc["self_attn"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            update_profile(
                profile, profile_linear_layer(sa[name], h, h, bias, seq_len)
            )
        _profile_attention_matmuls(
            profile, sa["bmm_0"], sa["bmm_1"], heads, seq_len, hd
        )
        update_profile(
            profile, profile_linear_layer(lc["fc1"], h, ffn, bias, seq_len)
        )
        update_profile(
            profile, profile_linear_layer(lc["fc2"], ffn, h, bias, seq_len)
        )
    return profile


def profile_bert_quantized(config, seq_len: int) -> dict:
    h, inter = config.hidden_size, config.intermediate_size
    heads = config.num_attention_heads
    hd = h // heads
    profile = _empty()
    for i in range(config.num_hidden_layers):
        lc = config.quant_config[f"model_layer_{i}"]
        attn = lc["attention"]
        for name in ("query", "key", "value"):
            update_profile(
                profile, profile_linear_layer(attn[name], h, h, True, seq_len)
            )
        _profile_attention_matmuls(
            profile, attn["matmul_0"], attn["matmul_1"], heads, seq_len, hd
        )
        update_profile(
            profile,
            profile_linear_layer(attn["output"]["dense"], h, h, True, seq_len),
        )
        update_profile(
            profile,
            profile_linear_layer(lc["intermediate"]["dense"], h, inter, True, seq_len),
        )
        update_profile(
            profile,
            profile_linear_layer(lc["output"]["dense"], inter, h, True, seq_len),
        )
    return profile
