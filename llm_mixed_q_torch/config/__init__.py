from .sampler import decode_ast_value, sample_a_dict_of_list, sample_a_list
from .schema import (
    OP_TO_ENTRIES,
    QUANT_ARITH_ENTRIES,
    cp_weight_entries_to_bias,
    parse_node_config,
)
from .stat_to_int import (
    create_nested_dict,
    find_int_frac_width,
    transform_stat_profile_to_int_quant_config,
)
