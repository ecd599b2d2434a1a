"""Packed BFP storage and the Hopper kernels of the serving path."""

from .attention_decode import (
    packed_attention_decode_batch_cuda,
    packed_attention_decode_cuda,
    packed_attention_decode_dense,
)
from .dequant_matmul import (
    actq_split_cuda,
    bfp_matmul,
    bfp_matmul_cuda,
    bfp_matmul_subbyte_cuda,
    bfp_matmul_subbyte_t_cuda,
)
from .packing import (
    PACKED_TYPES,
    PackedBFP,
    PackedBFPSub,
    PackedBFPSubT,
    bfp_decode_lastdim,
    bfp_encode_lastdim,
    effective_block_len,
    pack_block_fp,
    pack_block_fp_subbyte,
    pack_block_fp_subbyte_t,
    packed_nbytes,
    transpose_subbyte,
    unpack,
    unpack_block_fp,
    unpack_block_fp_subbyte,
    unpack_block_fp_subbyte_t,
)

# every kernel wrapper, by the name its launch count is reported under
KERNEL_WRAPPERS = {
    "bfp_matmul_subbyte_t": bfp_matmul_subbyte_t_cuda,
    "bfp_matmul_int8": bfp_matmul_cuda,
    "actq_split": actq_split_cuda,
    "bfp_matmul_subbyte": bfp_matmul_subbyte_cuda,
    "attn_decode_pos_major": packed_attention_decode_batch_cuda,
    "attn_decode_head_major": packed_attention_decode_cuda,
}


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches, and under "attn_decode_packed_dense"
    the layer calls of the packed KV cache's dense route (no kernel)."""
    return {**{name: fn.launches for name, fn in KERNEL_WRAPPERS.items()},
            "attn_decode_packed_dense": packed_attention_decode_dense.calls}


def reset_launch_counts():
    """Set every count of ``launch_counts`` to 0."""
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    packed_attention_decode_dense.calls = 0
