"""Model registry (counterpart of the JAX package's ``models/__init__.py``):
model functions, config classes, parameter loaders, PTQ preparers,
packers, cost-model profilers, quant-config parsers, stat-config
formatters and quant-config samplers by arch, and the tokenizer class. Ported: Llama and OPT, with the causal-LM task ``lm``
and the sequence-classification task ``cls``, OPT's span
question-answering task ``qa``, and BERT with its eight tasks (``cls``,
``mlm``, ``clm``, ``nsp``, ``pretrain``, ``mc``, ``token``, ``qa``; no
``lm``, as in the reference); any other arch or task raises
``NotImplementedError`` naming it."""

from __future__ import annotations

from ..costmodel.models import (
    profile_bert_quantized,
    profile_llama_quantized,
    profile_opt_quantized,
)
from .bert import (
    BertQuantizedConfig,
    bert_for_masked_lm,
    bert_for_multiple_choice,
    bert_for_next_sentence_prediction,
    bert_for_pretraining,
    bert_for_question_answering,
    bert_for_sequence_classification,
    bert_for_token_classification,
    bert_lm_head_model,
    format_stat_profiled_int_config_bert_quantized,
    pack_bert_params,
    parse_bert_quantized_config,
    quantize_bert_params_ptq,
)
from .hf_loader import (
    bert_params_from_flat,
    llama_params_from_flat,
    load_flat_state_dict,
    opt_params_from_flat,
)
from .llama import (
    LlamaQuantizedConfig,
    format_stat_profiled_int_config_llama_quantized,
    llama_for_causal_lm,
    llama_for_sequence_classification,
    pack_llama_params,
    parse_llama_quantized_config,
    quantize_llama_params_ptq,
)
from .opt import (
    OPTQuantizedConfig,
    format_stat_profiled_int_config_opt_quantized,
    opt_for_causal_lm,
    opt_for_question_answering,
    opt_for_sequence_classification,
    parse_opt_quantized_config,
    quantize_opt_params_ptq,
)
from .opt.pack import pack_opt_params

MODEL_FN_MAP = {
    "bert": {"cls": bert_for_sequence_classification, "mlm": bert_for_masked_lm,
             "clm": bert_lm_head_model, "nsp": bert_for_next_sentence_prediction,
             "pretrain": bert_for_pretraining, "mc": bert_for_multiple_choice,
             "token": bert_for_token_classification, "qa": bert_for_question_answering},
    "llama": {"cls": llama_for_sequence_classification, "lm": llama_for_causal_lm},
    "opt": {"cls": opt_for_sequence_classification, "lm": opt_for_causal_lm,
            "qa": opt_for_question_answering},
}
CONFIG_MAP = {"bert": BertQuantizedConfig, "llama": LlamaQuantizedConfig,
              "opt": OPTQuantizedConfig}
PARAMS_LOADER_MAP = {"bert": bert_params_from_flat, "llama": llama_params_from_flat,
                     "opt": opt_params_from_flat}
PTQ_PREPARE_MAP = {"bert": quantize_bert_params_ptq, "llama": quantize_llama_params_ptq,
                   "opt": quantize_opt_params_ptq}
PARAMS_PACKER_MAP = {"bert": pack_bert_params, "llama": pack_llama_params,
                     "opt": pack_opt_params}
PROFILER_MAP = {"bert": profile_bert_quantized, "llama": profile_llama_quantized,
                "opt": profile_opt_quantized}
QUANT_CONFIG_PARSER_MAP = {"bert": parse_bert_quantized_config,
                           "llama": parse_llama_quantized_config,
                           "opt": parse_opt_quantized_config}
STAT_CONFIG_FORMATTER_MAP = {"bert": format_stat_profiled_int_config_bert_quantized,
                             "llama": format_stat_profiled_int_config_llama_quantized,
                             "opt": format_stat_profiled_int_config_opt_quantized}


def _get(map_, arch, task=None):
    if arch not in map_:
        raise NotImplementedError(f"model arch {arch!r} is not ported (ported: {list(map_)})")
    entry = map_[arch]
    if task is None:
        return entry
    if task not in entry:
        raise NotImplementedError(
            f"task {task!r} of {arch} is not ported (ported: {list(entry)})")
    return entry[task]


def get_model_fn(arch: str, task: str):
    return _get(MODEL_FN_MAP, arch, task)


def get_config_cls(arch: str):
    return _get(CONFIG_MAP, arch)


def get_params_loader(arch: str):
    return _get(PARAMS_LOADER_MAP, arch)


def get_ptq_preparer(arch: str):
    return _get(PTQ_PREPARE_MAP, arch)


def get_params_packer(arch: str):
    """Packed-storage converter: BFP weights as int8 codes (``PackedBFP``,
    the default) or sub-byte words, served through ``bfp_matmul``."""
    return _get(PARAMS_PACKER_MAP, arch)


def get_model_profiler(arch: str):
    """``profile(config, seq_len) -> counts``: the cost model of the arch's
    quantized layers (``costmodel``)."""
    return _get(PROFILER_MAP, arch)


def get_quant_config_parser(arch: str):
    return _get(QUANT_CONFIG_PARSER_MAP, arch)


def get_stat_config_formatter(arch: str):
    """Completes an integer config derived from a statistic profile
    (``config.transform_stat_profile_to_int_quant_config``) with the arch's
    attention matmul nodes."""
    return _get(STAT_CONFIG_FORMATTER_MAP, arch)


def get_tokenizer_cls(arch: str):
    """The HF tokenizer class of every arch (reference TOKENIZER_MAP):
    transformers' ``AutoTokenizer``. Raises ImportError naming the package
    where transformers is not installed."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"get_tokenizer_cls({arch!r}) needs the transformers package, which is not "
            "installed; pass a tokenizer object instead") from e
    return AutoTokenizer


def get_quant_config_sampler(arch: str):
    """``sample(trial, name, config_seed) -> quant config``: the arch's
    sampler of a search space (``search.samplers_model``)."""
    from ..search.samplers_model import get_model_sampler

    return get_model_sampler(arch)
