"""The OPT family (OPT-6.7B): its random weights, and the port's parameter
tree and config of them (see ``families/llama.py`` for what a family's
file gives). Linear weights, biases and embeddings are N(0, init_std);
layer norms 1 and 0.
"""

from __future__ import annotations

import torch

from benchmark.weights import draws


def layer(dims: dict, seed: int, i: int, device) -> dict:
    h, ffn = dims["hidden_size"], dims["ffn_dim"]
    w = draws(seed, i, {"q": (h, h), "k": (h, h), "v": (h, h), "o": (h, h),
                        "fc1": (ffn, h), "fc2": (h, ffn), "q_b": (h,), "k_b": (h,),
                        "v_b": (h,), "o_b": (h,), "fc1_b": (ffn,), "fc2_b": (h,)},
              dims["init_std"], device)
    one, zero = torch.ones(h, device=device), torch.zeros(h, device=device)
    return {**w, "attn_ln": one, "attn_ln_b": zero, "mlp_ln": one.clone(),
            "mlp_ln_b": zero.clone()}


def top(dims: dict, seed: int, device) -> dict:
    h = dims["hidden_size"]
    t = draws(seed, dims["num_hidden_layers"],
              {"embed": (dims["vocab_size"], h),
               "positions": (dims["max_position_embeddings"] + 2, h)},
              dims["init_std"], device)
    return {**t, "final_ln": torch.ones(h, device=device),
            "final_ln_b": torch.zeros(h, device=device)}


def program_config(config: dict):
    from llm_mixed_q_torch.models import get_config_cls

    cls = get_config_cls("opt")
    fields = set(cls.__dataclass_fields__)
    return cls(**{k: v for k, v in config["model"].items()
                  if k in fields and k not in ("quant_config", "model_type")},
               quant_config=config["quant"])


def program_layer(w: dict) -> dict:
    lin = lambda k: {"weight": w[k], "bias": w[k + "_b"]}
    return {"self_attn": {n: lin(k) for n, k in (("q_proj", "q"), ("k_proj", "k"),
                                                 ("v_proj", "v"), ("out_proj", "o"))},
            "self_attn_layer_norm": {"weight": w["attn_ln"], "bias": w["attn_ln_b"]},
            "fc1": lin("fc1"), "fc2": lin("fc2"),
            "final_layer_norm": {"weight": w["mlp_ln"], "bias": w["mlp_ln_b"]}}


def program_top(t: dict) -> dict:
    return {"embed_tokens": {"weight": t["embed"]},
            "embed_positions": {"weight": t["positions"]},
            "final_layer_norm": {"weight": t["final_ln"], "bias": t["final_ln_b"]}}
