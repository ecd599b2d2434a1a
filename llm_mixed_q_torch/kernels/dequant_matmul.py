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

The block_fp data_in quantizer (``actq``, blocks of at most 32 along K;
longer blocks are quantized before the call) is ``_qdq_lanes_signed`` on
the TPU. K1 folds it into its prologue; K2 and K3 run it once a call in a
kernel of their own, ``actq_split`` (wrapper ``actq_split_cuda``, plain
version ``actq_split_plain``; a block a row and 512 K), which writes x as
two bf16 terms, hi = bf16(q) and lo = bf16(q - hi), and a flag a row and
512 K where lo is nonzero into a workspace that the matmul then reads; one
C call launches both, the matmul as actq_split's programmatic dependent
(PDL: its blocks queue their first weight stages while actq_split runs and
wait for it before they read the workspace). All three multiply on the tensor cores,
in bf16 operands that are exact (codes times powers of two; x as hi + lo,
about 2^-17 of |x| left for raw float32 x, none for block_fp activations
of width <= 9), so they differ from the plain version only in the order of
their float32 sums. Their bound on an H100 is their bytes at decode M (a
Llama-2-7B layer's four projections at M = 8: 0.0571 ms for K1 and K3,
0.0765 ms for K2, PERF.md). Each wrapper launches its kernel for a CUDA
tensor (counting the launch in its ``launches`` attribute; K2's and K3's
also count ``actq_split``) and computes the plain version for a CPU
tensor. ``bfp_matmul`` routes M <= 256 rows to the kernels and larger M
to unpack + ``torch.matmul``, as the JAX package leaves large-M products
to XLA.
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


def bfp_matmul_subbyte_t_cuda(x2: torch.Tensor, packed: PackedBFPSubT,
                              actq=None) -> torch.Tensor:
    """K1: x [M, K] @ unpack(packed)^T -> [M, N] float32."""
    if not x2.is_cuda:
        return bfp_matmul_plain(x2, packed, actq)
    name = "bfp_matmul_subbyte_t_cuda"
    _check_operands(x2, packed, name)
    _check_actq(actq, name)
    m, n = x2.shape[0], packed.out_features
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return y
    rc = _cuda.lib().lmq_bfp_matmul_subbyte_t(
        x2.data_ptr(), packed.words.data_ptr(), packed.scales.data_ptr(), y.data_ptr(),
        m, n, packed.in_features, _k_padded(packed), packed.width,
        packed.block_size, *_actq_args(actq), _cuda.stream_ptr(x2),
    )
    _cuda.check(rc, name)
    bfp_matmul_subbyte_t_cuda.launches += 1
    return y


# K stride of the workspace of K2 and K3: a multiple of this (csrc kK2WsK),
# so that every ring stage of K2's matmul reads whole rows of it; also the
# K of an actq_split block (csrc kSplitK), which flags its chunk of a row
_WS_K = 512


def _split_workspace(m: int, k_pad: int, device):
    """(kw, workspace, hi, lo, lo_flags) of actq_split: hi and lo [m, kw]
    bf16 and lo_flags [m, kw / 512] bool (a chunk of 512 K of a row with a
    nonzero lo) in one uint8 buffer, kw = k_pad rounded up to a multiple of
    ``_WS_K``."""
    kw = -(-k_pad // _WS_K) * _WS_K
    nck = kw // _WS_K
    ws = torch.empty(4 * m * kw + m * nck, dtype=torch.uint8, device=device)
    hi = ws[: 2 * m * kw].view(torch.bfloat16).view(m, kw)
    lo = ws[2 * m * kw: 4 * m * kw].view(torch.bfloat16).view(m, kw)
    return kw, ws, hi, lo, ws[4 * m * kw:].view(torch.bool).view(m, nck)


def actq_split_plain(x2: torch.Tensor, actq=None, k_pad: int | None = None):
    """Plain version of actq_split: q = actq(x2) (x2 itself for None),
    zero-padded to ``k_pad`` columns -> (hi = bf16(q), lo = bf16(q - hi),
    lo_flags [M, ceil(k / 512)]: whether a chunk of 512 K of a row has a
    nonzero lo; a row has one where any of its chunks has)."""
    q = x2 if actq is None else _actq_qdq(x2, actq)
    if k_pad is not None and k_pad > q.shape[1]:
        q = torch.nn.functional.pad(q, (0, k_pad - q.shape[1]))
    hi = q.to(torch.bfloat16)
    lo = (q - hi.float()).to(torch.bfloat16)
    m, k = lo.shape
    chunks = torch.nn.functional.pad(lo != 0, (0, -k % _WS_K)).view(m, -1, _WS_K)
    return hi, lo, chunks.any(dim=2)


def _check_actq(actq, name):
    if actq is not None and _KERNEL_ACTQ_BLOCK % actq[0]:
        raise ValueError(f"{name}: actq block {actq[0]} does not divide {_KERNEL_ACTQ_BLOCK}")


def actq_split_cuda(x2: torch.Tensor, actq=None, k_pad: int | None = None):
    """actq_split alone: -> (hi, lo [M, kw] bf16, lo_flags [M, kw / 512]
    bool), kw = ``k_pad`` (default K) rounded up to a multiple of 512; the
    plain version padded to kw for a CPU tensor."""
    name = "actq_split_cuda"
    k_pad = x2.shape[1] if k_pad is None else k_pad
    if not x2.is_cuda:
        return actq_split_plain(x2, actq, -(-k_pad // _WS_K) * _WS_K)
    if x2.dtype != torch.float32 or x2.ndim != 2 or not x2.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D float32 tensor")
    if k_pad < x2.shape[1]:
        raise ValueError(f"{name}: k_pad {k_pad} < K {x2.shape[1]}")
    _check_actq(actq, name)
    m = x2.shape[0]
    kw, ws, hi, lo, lo_flags = _split_workspace(m, k_pad, x2.device)
    if m == 0:
        return hi, lo, lo_flags
    rc = _cuda.lib().lmq_actq_split(x2.data_ptr(), ws.data_ptr(), m, x2.shape[1], kw,
                                    *_actq_args(actq), _cuda.stream_ptr(x2))
    _cuda.check(rc, name)
    actq_split_cuda.launches += 1
    return hi, lo, lo_flags


def _launch_after_split(entry: str, name: str, x2, packed, actq, k_pad: int,
                        *format_args) -> tuple[torch.Tensor, bool]:
    """K2 or K3: actq_split into a workspace, then the matmul reading it as
    its programmatic dependent, through C entry point ``entry`` (one call
    launches both; their return code is checked after both: a refused
    launch raises, with no other launch in its place) -> (y, whether it
    launched: an empty product launches nothing)."""
    _check_operands(x2, packed, name)
    bs = packed.block_size
    if bs < 1 or 128 % bs:
        raise ValueError(f"{name}: block {bs} must divide 128")
    _check_actq(actq, name)
    m, n = x2.shape[0], packed.out_features
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return y, False
    kw, ws, *_ = _split_workspace(m, k_pad, x2.device)
    rc = getattr(_cuda.lib(), entry)(
        x2.data_ptr(), packed[0].data_ptr(), packed[1].data_ptr(), y.data_ptr(),
        ws.data_ptr(), m, n, packed.in_features, k_pad, kw, *format_args, bs,
        *_actq_args(actq), 1, _cuda.stream_ptr(x2),
    )
    _cuda.check(rc, name)
    actq_split_cuda.launches += 1
    return y, True


def bfp_matmul_cuda(x2: torch.Tensor, packed: PackedBFP, actq=None) -> torch.Tensor:
    """K2: x [M, K] @ unpack(packed)^T -> [M, N] float32, int8 codes:
    actq_split into a workspace, then the matmul on the tensor cores."""
    if not x2.is_cuda:
        return bfp_matmul_plain(x2, packed, actq)
    y, launched = _launch_after_split("lmq_bfp_matmul_int8", "bfp_matmul_cuda", x2, packed,
                                      actq, packed.codes.shape[1])
    bfp_matmul_cuda.launches += launched
    return y


def bfp_matmul_subbyte_cuda(x2: torch.Tensor, packed: PackedBFPSub,
                            actq=None) -> torch.Tensor:
    """K3: x [M, K] @ unpack(packed)^T -> [M, N] float32, lane-major
    sub-byte words: actq_split into a workspace, then the matmul on the
    tensor cores."""
    if not x2.is_cuda:
        return bfp_matmul_plain(x2, packed, actq)
    y, launched = _launch_after_split("lmq_bfp_matmul_subbyte", "bfp_matmul_subbyte_cuda", x2,
                                      packed, actq, _k_padded(packed), packed.width)
    bfp_matmul_subbyte_cuda.launches += launched
    return y


bfp_matmul_subbyte_t_cuda.launches = 0
bfp_matmul_subbyte_cuda.launches = 0
bfp_matmul_cuda.launches = 0
actq_split_cuda.launches = 0


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
