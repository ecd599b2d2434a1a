from .models import profile_bert_quantized, profile_llama_quantized, profile_opt_quantized
from .profiler import (
    compute_memory_density,
    compute_tensor_bits_block_fp,
    compute_tensor_bits_fp,
    compute_tensor_bits_integer,
    profile_linear_layer,
    profile_matmul_layer,
    update_profile,
)
