"""Per-model quant-config samplers (counterpart of the JAX package's
``search/samplers_model.py``; reference sampler_llama.py:12-57,
sampler_opt.py, sampler_bert.py): walk the seed dict (``default`` /
``model_layer`` / ``model_layer_<i>`` / top-level op entries) and sample
every leaf list, producing flat trial param names like
``root:model_layer_0:self_attn:q_proj:weight_width``.
"""

from __future__ import annotations

import logging

from ..config.sampler import sample_a_dict_of_list

logger = logging.getLogger(__name__)

_LLAMA_LAYER_NODES = {
    "self_attn": (
        "q_proj",
        "k_proj",
        "v_proj",
        "o_proj",
        "rotary_positional_encoding",
        "matmul_0",
        "matmul_1",
    ),
    "mlp": ("gate_proj", "down_proj", "up_proj"),
}
_OPT_LAYER_NODES = {
    "self_attn": ("q_proj", "k_proj", "v_proj", "out_proj", "bmm_0", "bmm_1"),
    "": ("fc1", "fc2"),
}
_BERT_LAYER_NODES = {
    "attention": ("query", "key", "value", "matmul_0", "matmul_1"),
}


def _sample_layer(trial, name, layer_qc, node_spec, extra=None):
    qc = {}
    for group, nodes in node_spec.items():
        if group == "":
            for node in nodes:
                qc[node] = sample_a_dict_of_list(
                    trial, f"{name}:{node}", layer_qc[node]
                )
        else:
            qc[group] = {
                node: sample_a_dict_of_list(
                    trial, f"{name}:{group}:{node}", layer_qc[group][node]
                )
                for node in nodes
            }
    if extra:
        extra(trial, name, layer_qc, qc)
    return qc


def _make_sampler(node_spec, extra=None, known_top=()):
    def sampler(trial, name: str, config_seed: dict) -> dict:
        sampled = {}
        for k, v in config_seed.items():
            if k == "default" or k in known_top:
                sampled[k] = sample_a_dict_of_list(trial, f"{name}:{k}", v)
            elif k == "model_layer" or k.startswith("model_layer_"):
                sampled[k] = _sample_layer(trial, f"{name}:{k}", v, node_spec, extra)
            else:
                logger.warning(f"Unknown key: {k}, ignored")
        return sampled

    return sampler


def _bert_extra(trial, name, layer_qc, qc):
    # bert nests attention.output.dense + intermediate/output dense
    qc["attention"]["output"] = {
        "dense": sample_a_dict_of_list(
            trial,
            f"{name}:attention:output:dense",
            layer_qc["attention"]["output"]["dense"],
        )
    }
    for group in ("intermediate", "output"):
        qc.setdefault(group, {})
        qc[group]["dense"] = sample_a_dict_of_list(
            trial, f"{name}:{group}:dense", layer_qc[group]["dense"]
        )


sample_llama_quant_config = _make_sampler(
    _LLAMA_LAYER_NODES, known_top=("rotary_positional_encoding",)
)
sample_opt_quant_config = _make_sampler(_OPT_LAYER_NODES)
sample_bert_quant_config = _make_sampler(_BERT_LAYER_NODES, extra=_bert_extra)

MODEL_SAMPLER_MAP = {
    "llama": sample_llama_quant_config,
    "opt": sample_opt_quant_config,
    "bert": sample_bert_quant_config,
}


def get_model_sampler(arch: str):
    return MODEL_SAMPLER_MAP[arch]
