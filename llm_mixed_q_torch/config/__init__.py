from .schema import OP_TO_ENTRIES, QUANT_ARITH_ENTRIES, parse_node_config
