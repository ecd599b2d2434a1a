"""The Llama family (Mistral-7B-v0.3 runs as it): its random weights, the
port's parameter tree and config of them, and the port's serving loop.

A family's file gives ``layer``, ``top`` (weights as plain tensors, which
the reference also takes), ``program_config``, ``program_layer``,
``program_top`` and, where the port serves the family, ``serving``. The
harness finds it by the configuration's ``family``. Linear weights and
embeddings are N(0, initializer_range); norm weights 1.
"""

from __future__ import annotations

import torch

from benchmark.weights import draws


def layer(dims: dict, seed: int, i: int, device) -> dict:
    h, inter = dims["hidden_size"], dims["intermediate_size"]
    kvh = dims["num_key_value_heads"] * (h // dims["num_attention_heads"])
    w = draws(seed, i, {"q": (h, h), "k": (kvh, h), "v": (kvh, h), "o": (h, h),
                        "gate": (inter, h), "up": (inter, h), "down": (h, inter)},
              dims["initializer_range"], device)
    ones = torch.ones(h, device=device)
    return {**w, "input_ln": ones, "post_ln": ones.clone()}


def top(dims: dict, seed: int, device) -> dict:
    h, v = dims["hidden_size"], dims["vocab_size"]
    t = draws(seed, dims["num_hidden_layers"], {"embed": (v, h), "lm_head": (v, h)},
              dims["initializer_range"], device)
    return {**t, "norm": torch.ones(h, device=device)}


def program_config(config: dict):
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig

    dims = config["model"]
    keys = ("vocab_size hidden_size intermediate_size num_hidden_layers "
            "num_attention_heads num_key_value_heads max_position_embeddings "
            "rms_norm_eps rope_theta bos_token_id eos_token_id tie_word_embeddings").split()
    return LlamaQuantizedConfig(**{k: dims[k] for k in keys}, quant_config=config["quant"])


def program_layer(w: dict) -> dict:
    lin = lambda t: {"weight": t}
    return {"input_layernorm": {"weight": w["input_ln"]},
            "post_attention_layernorm": {"weight": w["post_ln"]},
            "self_attn": {n: lin(w[k]) for n, k in (("q_proj", "q"), ("k_proj", "k"),
                                                    ("v_proj", "v"), ("o_proj", "o"))},
            "mlp": {n: lin(w[k]) for n, k in (("gate_proj", "gate"), ("up_proj", "up"),
                                              ("down_proj", "down"))}}


def program_top(t: dict) -> dict:
    return {"embed_tokens": {"weight": t["embed"]}, "lm_head": {"weight": t["lm_head"]},
            "norm": {"weight": t["norm"]}}


def serving(config: dict, traffic: dict, seed: int, device):
    """The port's ``ContinuousBatcher`` on weights packed layer by layer
    (``traffic["pack"]``), with no EOS, warmed up on the mix's buckets."""
    from llm_mixed_q_torch.models.llama.pack import pack_llama_params
    from llm_mixed_q_torch.models.llama.serving import ContinuousBatcher

    dims = config["model"]
    pconfig = program_config(config)
    layers = (program_layer(layer(dims, seed, i, device))
              for i in range(dims["num_hidden_layers"]))
    params = pack_llama_params({**program_top(top(dims, seed, device)), "layers": layers},
                               pconfig, device=device, **traffic["pack"])
    batcher = ContinuousBatcher(params, pconfig, device=device, eos_token_id=None,
                                **traffic["batcher"])
    batcher.warmup(buckets=traffic["warm_buckets"])
    return batcher
