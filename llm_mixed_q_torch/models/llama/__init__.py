from .configuration import LlamaQuantizedConfig
from .modeling import llama_for_causal_lm, llama_for_sequence_classification, llama_model
from .pack import pack_llama_params, pack_llama_params_host
from .prepare import quantize_llama_params_ptq
from .quant_config import (
    format_stat_profiled_int_config_llama_quantized,
    parse_llama_quantized_config,
)
from .serving import (
    ContinuousBatcher,
    decode_step,
    generate,
    generate_greedy,
    prefill_into_cache,
)
