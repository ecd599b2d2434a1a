"""Fused dequant-matmul: y = actq(x) @ unpack(W)^T (counterpart of the JAX
package's ``kernels/dequant_matmul.py``).

Three Hopper kernels (``csrc/dequant_matmul.cu``) replace the TPU kernels:

- K1 ``bfp_matmul_subbyte_t_cuda``: ``PackedBFPSubT`` sub-byte weights
  (replaces ``bfp_matmul_subbyte_t_pallas`` / ``_subbyte_t_kernel``);
- K2 ``bfp_matmul_cuda``: ``PackedBFP`` int8 codes
  (replaces ``bfp_matmul_pallas`` / ``_dequant_matmul_kernel``);
- K3 ``bfp_matmul_subbyte_cuda``: lane-major ``PackedBFPSub`` sub-byte
  weights (replaces ``bfp_matmul_subbyte_pallas`` / ``_subbyte_kernel``;
  its ``tps`` tiling knob has no counterpart).

All fold the block_fp data_in quantizer (``actq``, blocks of at most 32
along K; longer blocks are quantized before the call) into their prologue
and accumulate in float32. K1 multiplies on the tensor cores, in bf16
operands that are exact (codes times powers of two; x as a bf16 sum of two
terms), so it differs from the plain version only in the order of its
sums; K2 and K3 multiply in float32 on the CUDA cores. Each wrapper launches its kernel for a CUDA tensor
(counting the launch in its ``launches`` attribute) and computes the plain
version for a CPU tensor. ``bfp_matmul`` routes M <= 256 rows to the
kernels and larger M to unpack + ``torch.matmul``, as the JAX package
leaves large-M products to XLA.
"""

from __future__ import annotations

import torch

from ..ops.quantizers.block_fp import _block_fp_qdq
from . import _cuda
from .packing import _SLICE, PackedBFP, PackedBFPSub, PackedBFPSubT, unpack

# Below this many rows the product is bound by the weight stream and the
# fused dequant kernel wins; above it the weight is unpacked once and the
# product goes to torch.matmul.
_FUSED_M_MAX = 256
# longest data_in block the kernels quantize in their prologue (a block is
# a run of lanes of one warp)
_KERNEL_ACTQ_BLOCK = 32


def actq_spec(config: dict | None):
    """Static (bs, width, exponent_width, exponent_bias) of the data_in
    block_fp quantizer the kernels fold into their prologue, or None when
    the config is not kernel-eligible (not block_fp, 2-D activation tiles,
    or a block that does not divide 128)."""
    if (
        config is None
        or config.get("bypass", False)
        or config.get("name") != "block_fp"
    ):
        return None
    bs = config.get("data_in_block_size")
    if isinstance(bs, (list, tuple)):
        # bs[-2] == -1 shares one exponent across all sequence positions of
        # a 3-D activation; the in-kernel quantizer is per row [1, bs]
        if len(bs) >= 2 and bs[-2] != 1:
            return None
        bs = bs[-1]
    if not isinstance(bs, int) or bs < 1 or 128 % bs:
        return None
    eb = config.get("data_in_exponent_bias")
    if eb is not None and not isinstance(eb, (int, float)):
        return None
    return (bs, config["data_in_width"], config.get("data_in_exponent_width", 8), eb)


def _k_padded(packed) -> int:
    if isinstance(packed, PackedBFPSubT):
        return (packed.words.shape[0] // _SLICE) * packed.tile
    if isinstance(packed, PackedBFPSub):
        return (packed.words.shape[1] // _SLICE) * packed.tile
    return packed.codes.shape[1]


def _actq_qdq(x2, actq):
    bs, width, ew, eb = actq
    return _block_fp_qdq(x2, width, ew, eb, [1, bs], skip_first_dim=True)


def bfp_matmul_plain(x2: torch.Tensor, packed, actq=None) -> torch.Tensor:
    """Plain version of K1/K2/K3: actq through ``_block_fp_qdq`` with [1, bs]
    blocks, unpack, float32 matmul."""
    if actq is not None:
        x2 = _actq_qdq(x2, actq)
    return torch.matmul(x2, unpack(packed).t())


def _actq_args(actq):
    """(on, bs, width, emin, emax) for the C interface."""
    if actq is None:
        return (0, 1, 1, 0, 0)
    bs, width, ew, eb = actq
    if eb in (None, "none", "None"):
        eb = 2 ** (ew - 1) - 1
    eb = int(eb)
    return (1, bs, width, -eb, 2**ew - 1 - eb)


def _check_operands(x2, packed, name):
    if x2.dtype != torch.float32 or x2.ndim != 2 or not x2.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D float32 tensor")
    if x2.shape[1] != packed.in_features:
        raise ValueError(f"{name}: K {x2.shape[1]} != in_features {packed.in_features}")
    if any(t.device != x2.device or not t.is_contiguous() for t in packed[:2]):
        raise ValueError(f"{name}: packed buffers must be contiguous on {x2.device}")
    if packed[0].data_ptr() % 4:  # the kernels read codes / words 4 bytes at a time
        raise ValueError(f"{name}: packed codes must be 4-byte aligned")


def _launch_subbyte(entry: str, name: str, x2, packed, actq) -> tuple[torch.Tensor, bool]:
    """Run a sub-byte kernel (K1 or K3) through C entry point ``entry`` ->
    (y, whether it launched: an empty product launches nothing)."""
    _check_operands(x2, packed, name)
    if actq is not None and _KERNEL_ACTQ_BLOCK % actq[0]:
        raise ValueError(f"{name}: actq block {actq[0]} does not divide {_KERNEL_ACTQ_BLOCK}")
    m = x2.shape[0]
    n = packed.out_features
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return y, False
    rc = getattr(_cuda.lib(), entry)(
        x2.data_ptr(), packed.words.data_ptr(), packed.scales.data_ptr(), y.data_ptr(),
        m, n, packed.in_features, _k_padded(packed), packed.width,
        packed.block_size, *_actq_args(actq), _cuda.stream_ptr(x2),
    )
    _cuda.check(rc, name)
    return y, True


def bfp_matmul_subbyte_t_cuda(x2: torch.Tensor, packed: PackedBFPSubT,
                              actq=None) -> torch.Tensor:
    """K1: x [M, K] @ unpack(packed)^T -> [M, N] float32."""
    if not x2.is_cuda:
        return bfp_matmul_plain(x2, packed, actq)
    y, launched = _launch_subbyte("lmq_bfp_matmul_subbyte_t", "bfp_matmul_subbyte_t_cuda",
                                  x2, packed, actq)
    bfp_matmul_subbyte_t_cuda.launches += launched
    return y


def bfp_matmul_subbyte_cuda(x2: torch.Tensor, packed: PackedBFPSub,
                            actq=None) -> torch.Tensor:
    """K3: x [M, K] @ unpack(packed)^T -> [M, N] float32, lane-major words."""
    if not x2.is_cuda:
        return bfp_matmul_plain(x2, packed, actq)
    y, launched = _launch_subbyte("lmq_bfp_matmul_subbyte", "bfp_matmul_subbyte_cuda",
                                  x2, packed, actq)
    bfp_matmul_subbyte_cuda.launches += launched
    return y


def bfp_matmul_cuda(x2: torch.Tensor, packed: PackedBFP, actq=None) -> torch.Tensor:
    """K2: x [M, K] @ unpack(packed)^T -> [M, N] float32, int8 codes."""
    if not x2.is_cuda:
        return bfp_matmul_plain(x2, packed, actq)
    name = "bfp_matmul_cuda"
    _check_operands(x2, packed, name)
    bs = packed.block_size
    if bs < 4 or 128 % bs:
        raise ValueError(f"{name}: block {bs} must divide 128 and be >= 4")
    if actq is not None and _KERNEL_ACTQ_BLOCK % actq[0]:
        raise ValueError(f"{name}: actq block {actq[0]} does not divide {_KERNEL_ACTQ_BLOCK}")
    m = x2.shape[0]
    n = packed.out_features
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return y
    lib = _cuda.lib()
    rc = lib.lmq_bfp_matmul_int8(
        x2.data_ptr(), packed.codes.data_ptr(), packed.scales.data_ptr(), y.data_ptr(),
        m, n, packed.in_features, packed.codes.shape[1], bs, *_actq_args(actq),
        _cuda.stream_ptr(x2),
    )
    _cuda.check(rc, name)
    bfp_matmul_cuda.launches += 1
    return y


bfp_matmul_subbyte_t_cuda.launches = 0
bfp_matmul_subbyte_cuda.launches = 0
bfp_matmul_cuda.launches = 0


def bfp_matmul(x: torch.Tensor, packed, actq: tuple | None = None) -> torch.Tensor:
    """x [..., K] @ unpack(packed)^T -> [..., N] float32.

    ``actq`` (from ``actq_spec``): the data_in quantizer, run inside the
    kernel; callers pass it INSTEAD of pre-quantizing, never both."""
    lead_shape = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if actq is not None and (_k_padded(packed) % actq[0] or _KERNEL_ACTQ_BLOCK % actq[0]):
        # a partial trailing activation block would straddle the padded K row
        # inside the kernel, or a block is longer than the kernels' run of
        # lanes: quantize outside instead
        x2 = _actq_qdq(x2, actq)
        actq = None
    if x2.shape[0] > _FUSED_M_MAX:
        out = bfp_matmul_plain(x2, packed, actq)
    elif isinstance(packed, PackedBFPSubT):
        out = bfp_matmul_subbyte_t_cuda(x2, packed, actq)
    elif isinstance(packed, PackedBFPSub):
        out = bfp_matmul_subbyte_cuda(x2, packed, actq)
    else:
        out = bfp_matmul_cuda(x2, packed, actq)
    return out.reshape(*lead_shape, packed.out_features)
