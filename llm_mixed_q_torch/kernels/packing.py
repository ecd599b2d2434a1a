"""Packed block-floating-point (BFP) weight storage (counterpart of the JAX
package's ``kernels/packing.py``; buffers are byte-identical to it).

- ``PackedBFP``: int8 codes [out, K_pad] (sign * mantissa integer) and f32
  per-block scales [out, K_pad / bs], scale = 2^(exponent - mantissa_bits).
- ``PackedBFPSub``: sub-byte codes, ``per_word = 32 // width`` to a uint32
  word, lane-major; uint8 scale exponents (scale = 2^(u8 - 128)).
- ``PackedBFPSubT``: the same bits transposed, K on rows: words
  [K_pad / per_word, out], scales [K_pad / bs, out]. The shipping format.

Pack math matches ``_block_fp_qdq``: per-block abs max with the
reference's zero-block fix (the tensor-wide nonzero minimum), exact
ceil-log2 exponent, round-half-even mantissa, saturation. Elements with
|x| <= 1e-8 store code 0 (packed storage cannot pass them through).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.quantizers.exact import ceil_log2, exact_exp2

_SLICE = 128  # codes per extracted K-slice of a sub-byte tile
_SCALE_E8_BIAS = 128  # uint8 scale byte: scale = 2^(u8 - 128)


class PackedBFP(NamedTuple):
    codes: torch.Tensor  # int8 [out, in_padded]
    scales: torch.Tensor  # float32 [out, in_padded // block]
    width: int
    block_size: int
    out_features: int
    in_features: int  # un-padded

    @property
    def mantissa_bits(self) -> int:
        return self.width - 1


class PackedBFPSub(NamedTuple):
    words: torch.Tensor  # uint32 [out, K_padded // per_word]
    scales: torch.Tensor  # uint8 [n_tiles, out, tile // block]: 2^(u8-128)
    width: int
    block_size: int
    out_features: int
    in_features: int

    @property
    def mantissa_bits(self) -> int:
        return self.width - 1

    @property
    def per_word(self) -> int:
        return 32 // self.width

    @property
    def tile(self) -> int:
        return self.per_word * _SLICE


class PackedBFPSubT(NamedTuple):
    """Row r of packing tile t (rows t*128..) packs per_word codes; shift j
    extracts K rows [t*tile + j*128, ... + 128). Scale row
    t*(tile // block) + b is K-block b of tile t."""

    words: torch.Tensor  # uint32 [K_padded // per_word, out]
    scales: torch.Tensor  # uint8 [K_padded // block, out]: 2^(u8-128)
    width: int
    block_size: int
    out_features: int
    in_features: int

    @property
    def mantissa_bits(self) -> int:
        return self.width - 1

    @property
    def per_word(self) -> int:
        return 32 // self.width

    @property
    def tile(self) -> int:
        return self.per_word * _SLICE


PACKED_TYPES = (PackedBFP, PackedBFPSub, PackedBFPSubT)


def effective_block_len(block_size, in_features: int) -> int | None:
    """Along-in-features block length of a [1, bs]-style weight block, or
    None for a genuine 2-D tile (not packable)."""
    bs = [block_size] if isinstance(block_size, int) else list(block_size)
    if len(bs) >= 2 and bs[-2] not in (1, -1):
        return None
    return min(bs[-1], in_features) if bs[-1] != -1 else in_features


def _bfp_encode_blocked(blocked: torch.Tensor, width: int, exponent_width: int,
                        exponent_bias):
    """[..., nb, bs] -> (codes int8 [..., nb, bs], scales f32 [..., nb])."""
    if width > 8:
        raise ValueError(f"int8 code storage requires width <= 8, got {width}")
    if exponent_bias in (None, "none", "None"):
        exponent_bias = 2 ** (exponent_width - 1) - 1
    exponent_max = 2**exponent_width - 1 - exponent_bias
    exponent_min = -exponent_bias
    mantissa_bits = width - 1
    mantissa_max = 2**mantissa_bits - 1

    pbm = blocked.abs().amax(dim=-1)
    is_zero = pbm == 0
    nonzero_min = torch.where(is_zero, torch.full_like(pbm, float("inf")), pbm).amin()
    fill = torch.where(torch.isinf(nonzero_min), torch.ones_like(nonzero_min), nonzero_min)
    pbm = torch.where(is_zero, fill, pbm)

    exponent = ceil_log2(pbm).clamp(exponent_min, exponent_max)
    scales = exact_exp2(exponent - mantissa_bits)

    sign = torch.sign(blocked + 1e-9)
    value = blocked.abs() + 1e-9
    mant_int = torch.round(
        value / exact_exp2(exponent)[..., None] * (2**mantissa_bits)
    ).clamp(0, mantissa_max)
    codes = torch.where(blocked.abs() <= 1e-8, torch.zeros_like(mant_int),
                        sign * mant_int)
    return codes.to(torch.int8), scales


def pack_block_fp(
    w: torch.Tensor,
    width: int,
    exponent_width: int = 8,
    exponent_bias=None,
    block_size=16,
    k_stride: int | None = None,
) -> PackedBFP:
    """Quantize + pack a [out, in] weight. ``k_stride`` pads the packed K
    axis to that multiple (a multiple of the block)."""
    out_features, in_features = w.shape
    bs = effective_block_len(block_size, in_features)
    if bs is None:
        raise ValueError(f"unsupported 2-D tile block for packing: {block_size}")
    pad = (-in_features) % bs
    if k_stride:
        if k_stride % bs:
            raise ValueError(f"k_stride {k_stride} is not a multiple of the block {bs}")
        pad = (-in_features) % k_stride
    if pad:
        w = F.pad(w, (0, pad))
    in_padded = w.shape[1]
    codes, scales = _bfp_encode_blocked(
        w.reshape(out_features, in_padded // bs, bs), width, exponent_width,
        exponent_bias,
    )
    return PackedBFP(codes.reshape(out_features, in_padded), scales, width, bs,
                     out_features, in_features)


def unpack_block_fp(p: PackedBFP, dtype=torch.float32) -> torch.Tensor:
    """w = codes * scales, sliced to the un-padded shape."""
    nb = p.codes.shape[1] // p.block_size
    w = (
        p.codes.to(torch.float32).reshape(p.out_features, nb, p.block_size)
        * p.scales[:, :, None]
    ).reshape(p.out_features, -1)[:, : p.in_features]
    return w.to(dtype)


def packed_nbytes(p) -> int:
    if isinstance(p, (PackedBFPSub, PackedBFPSubT)):
        return 4 * p.words.numel() + p.scales.numel()
    return p.codes.numel() + 4 * p.scales.numel()


# ------------------------------------------------------- last-axis encode

def bfp_encode_lastdim(x: torch.Tensor, width: int, exponent_width: int = 8,
                       exponent_bias=None, block_size: int = 16):
    """Encode BFP along the last axis: (codes int8 x.shape, scales f32
    x.shape[:-1] + (d // bs,)). The KV-cache storage primitive."""
    d = x.shape[-1]
    if d % block_size:
        raise ValueError(f"last dim {d} is not a multiple of the block {block_size}")
    codes, scales = _bfp_encode_blocked(
        x.reshape(tuple(x.shape[:-1]) + (d // block_size, block_size)),
        width, exponent_width, exponent_bias,
    )
    return codes.reshape(x.shape), scales


def bfp_decode_lastdim(codes: torch.Tensor, scales: torch.Tensor,
                       block_size: int, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``bfp_encode_lastdim``: codes * block-broadcast scales."""
    d = codes.shape[-1]
    out = (
        codes.to(torch.float32).reshape(tuple(codes.shape[:-1]) + (d // block_size, block_size))
        * scales[..., None]
    )
    return out.reshape(codes.shape).to(dtype)


# --------------------------------------------------------------- sub-byte

def scale_to_e8(scales: torch.Tensor) -> torch.Tensor:
    """Power-of-two f32 scales -> uint8 biased exponents (2^(u8-128)); a
    zero scale maps to byte 0."""
    mant, ex = torch.frexp(scales)
    e = (ex - 1).to(torch.float32)
    e = torch.where(scales > 0, e, torch.full_like(e, float("-inf")))
    return (e + _SCALE_E8_BIAS).clamp(0, 255).to(torch.uint8)


def scale_from_e8(e8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 biased exponents -> exact power-of-two scales."""
    return exact_exp2(e8.to(torch.float32) - _SCALE_E8_BIAS).to(dtype)


def _unsigned_words(words_i64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as uint32."""
    wrapped = torch.where(words_i64 >= 2**31, words_i64 - 2**32, words_i64)
    return wrapped.to(torch.int32).view(torch.uint32)


def _extract_codes(words: torch.Tensor, width: int, shifts_shape) -> torch.Tensor:
    """Shift + mask through an int32 view (no uint32 shift on the CPU)."""
    per_word = 32 // width
    shifts = (width * torch.arange(per_word, dtype=torch.int32,
                                   device=words.device)).reshape(shifts_shape)
    mask = 2**width - 1
    cmax = 2 ** (width - 1) - 1
    return ((words.view(torch.int32) >> shifts) & mask) - cmax


def pack_block_fp_subbyte(w: torch.Tensor, width: int, exponent_width: int = 8,
                          exponent_bias=None, block_size=16) -> PackedBFPSub:
    """Quantize + bit-pack a [out, in] weight (same grid as pack_block_fp)."""
    if not 2 <= width <= 8:
        raise ValueError(f"sub-byte packing needs width in [2,8], got {width}")
    out_features, in_features = w.shape
    bs = effective_block_len(block_size, in_features)
    if bs is None or _SLICE % bs:
        raise ValueError(
            f"sub-byte packing needs a [1, bs] block with bs | {_SLICE}: {block_size}")
    per_word = 32 // width
    tile = per_word * _SLICE
    pad = (-in_features) % tile
    base = pack_block_fp(F.pad(w, (0, pad)) if pad else w, width,
                         exponent_width, exponent_bias, [1, bs])
    k_padded = base.codes.shape[1]
    nt = k_padded // tile
    cmax = 2 ** (width - 1) - 1
    biased = (base.codes.to(torch.int64) + cmax).reshape(out_features, nt, per_word, _SLICE)
    shifts = (width * torch.arange(per_word, dtype=torch.int64,
                                   device=w.device))[None, None, :, None]
    words = _unsigned_words((biased << shifts).sum(dim=2))
    scales = scale_to_e8(
        base.scales.reshape(out_features, nt, tile // bs).permute(1, 0, 2)
    ).contiguous()
    return PackedBFPSub(words.reshape(out_features, nt * _SLICE), scales, width,
                        bs, out_features, in_features)


def transpose_subbyte(p: PackedBFPSub) -> PackedBFPSubT:
    """PackedBFPSub -> the transposed layout (bit-identical content)."""
    nt, out, spb = p.scales.shape
    scales_t = p.scales.permute(0, 2, 1).reshape(nt * spb, out).contiguous()
    return PackedBFPSubT(p.words.t().contiguous(), scales_t, p.width,
                         p.block_size, p.out_features, p.in_features)


def pack_block_fp_subbyte_t(w, width, exponent_width=8, exponent_bias=None,
                            block_size=16) -> PackedBFPSubT:
    return transpose_subbyte(
        pack_block_fp_subbyte(w, width, exponent_width, exponent_bias, block_size)
    )


def unpack_block_fp_subbyte_t(p: PackedBFPSubT, dtype=torch.float32) -> torch.Tensor:
    """Dequantize the transposed format -> [out, in_features]."""
    nw, out = p.words.shape
    nt = nw // _SLICE
    codes = _extract_codes(p.words.reshape(nt, 1, _SLICE, out), p.width,
                           (1, -1, 1, 1))
    codes = codes.reshape(nt * p.per_word * _SLICE, out)  # [K_padded, out]
    nb = codes.shape[0] // p.block_size
    scales = scale_from_e8(p.scales)  # [nb, out]
    wt = (
        codes.to(torch.float32).reshape(nb, p.block_size, out) * scales[:, None, :]
    ).reshape(-1, out)[: p.in_features]
    return wt.t().to(dtype)


def unpack_block_fp_subbyte(p: PackedBFPSub, dtype=torch.float32) -> torch.Tensor:
    """Dequantize the lane-major bit-packed format -> [out, in_features]."""
    out, nw = p.words.shape
    nt = nw // _SLICE
    codes = _extract_codes(p.words.reshape(out, nt, 1, _SLICE), p.width,
                           (1, 1, -1, 1))
    codes = codes.reshape(out, nt * p.per_word * _SLICE)
    nb = codes.shape[1] // p.block_size
    scales = scale_from_e8(p.scales).permute(1, 0, 2).reshape(out, nb)
    w = (
        codes.to(torch.float32).reshape(out, nb, p.block_size) * scales[:, :, None]
    ).reshape(out, -1)[:, : p.in_features]
    return w.to(dtype)


def unpack(p, dtype=torch.float32) -> torch.Tensor:
    """Dequantize any packed format to [out, in_features]."""
    if isinstance(p, PackedBFPSubT):
        return unpack_block_fp_subbyte_t(p, dtype)
    if isinstance(p, PackedBFPSub):
        return unpack_block_fp_subbyte(p, dtype)
    return unpack_block_fp(p, dtype)
