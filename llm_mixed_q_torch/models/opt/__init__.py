from .configuration import OPTQuantizedConfig
from .modeling import (
    opt_for_causal_lm,
    opt_for_question_answering,
    opt_for_sequence_classification,
    opt_model,
)
from .prepare import quantize_opt_params_ptq
from .quant_config import (
    format_stat_profiled_int_config_opt_quantized,
    parse_opt_quantized_config,
)
from .serving import generate as opt_generate
from .serving import generate_greedy as opt_generate_greedy
