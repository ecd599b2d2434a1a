from .configuration import BertQuantizedConfig
from .modeling import (
    bert_for_masked_lm,
    bert_for_multiple_choice,
    bert_for_next_sentence_prediction,
    bert_for_pretraining,
    bert_for_question_answering,
    bert_for_sequence_classification,
    bert_for_token_classification,
    bert_lm_head_model,
    bert_model,
)
from .pack import pack_bert_params
from .prepare import quantize_bert_params_ptq
from .quant_config import (
    format_stat_profiled_int_config_bert_quantized,
    parse_bert_quantized_config,
)
