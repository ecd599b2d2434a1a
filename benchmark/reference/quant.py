"""Frozen arithmetic of the quantizers the benchmark's references use.

Plain PyTorch, written from the definitions and kept here so that a later
change to the program cannot move the yardstick:

- block floating point (BFP): a block shares the exponent
  e = clamp(ceil(log2(block abs max)), -bias, 2^ew - 1 - bias); an element
  keeps sign and round_half_even(|x| / 2^e * 2^(w-1)), saturated at
  2^(w-1) - 1, as a multiple of 2^(e - w + 1). |x| <= 1e-8 passes through
  the fake quantizer unchanged; stored codes (weights and KV cache) hold 0
  there. The +1e-9 on the sign and the magnitude is the definition's.
- fixed point (the RoPE tables): clamp(round_half_even(x * 2^f)) / 2^f.

Blocks run along the last axis, aligned at 0, the tail zero-padded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TINY = 1e-8


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e for integer-valued float32 e, exact, built from the bits."""
    ei = e.to(torch.int32).clamp(-150, 128)
    normal = ((ei + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(ei) << (ei + 149).clamp(0, 22)).view(torch.float32)
    val = torch.where(ei >= -126, normal, sub)
    return torch.where(ei >= -149, val, torch.zeros_like(val))


def ceil_log2(m: torch.Tensor) -> torch.Tensor:
    """Exact ceil(log2(m)) for float32 m > 0 (read from the binary exponent)."""
    mant, ex = torch.frexp(m)
    return ex.to(torch.float32) - (mant == 0.5).to(torch.float32)


def _blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    """[..., n] -> [..., ceil(n / bs), bs], zero-padded."""
    n = x.shape[-1]
    pad = (-n) % bs
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, bs)


def _exponent(block_max: torch.Tensor, ew: int, bias) -> torch.Tensor:
    if bias is None:
        bias = 2 ** (ew - 1) - 1
    e = ceil_log2(torch.where(block_max > 0, block_max, torch.ones_like(block_max)))
    return e.clamp(-bias, 2**ew - 1 - bias)


def bfp(x: torch.Tensor, width: int, ew: int = 8, bias=None, bs: int = 16) -> torch.Tensor:
    """Fake-quantized x (float32), blocks of ``bs`` along the last axis."""
    n = x.shape[-1]
    xb = _blocks(x, bs)
    two_e = pow2(_exponent(xb.abs().amax(dim=-1, keepdim=True), ew, bias))
    shift = 2 ** (width - 1)
    mant = torch.round((xb.abs() + 1e-9) / two_e * shift).clamp(0, shift - 1) / shift
    q = torch.sign(xb + 1e-9) * two_e * mant
    q = torch.where(xb.abs() <= _TINY, xb, q)
    return q.reshape(*x.shape[:-1], -1)[..., :n]


def bfp_codes(x: torch.Tensor, width: int, ew: int = 8, bias=None, bs: int = 16):
    """Stored form of x: (int8 codes x.shape, float32 scales [..., n / bs]),
    value = code * scale. The last axis must be a multiple of ``bs``."""
    xb = _blocks(x, bs)
    e = _exponent(xb.abs().amax(dim=-1), ew, bias)
    shift = 2 ** (width - 1)
    mant = torch.round((xb.abs() + 1e-9) / pow2(e)[..., None] * shift).clamp(0, shift - 1)
    codes = torch.where(xb.abs() <= _TINY, torch.zeros_like(mant), torch.sign(xb + 1e-9) * mant)
    return codes.to(torch.int8).reshape(x.shape), pow2(e - (width - 1))


def bfp_stored(x: torch.Tensor, width: int, ew: int = 8, bias=None, bs: int = 16):
    """The float32 value of x's stored form (codes * scales)."""
    codes, scales = bfp_codes(x, width, ew, bias, bs)
    return (codes.to(torch.float32).reshape(*x.shape[:-1], -1, bs)
            * scales[..., None]).reshape(x.shape)


def fixed(x: torch.Tensor, width: int, frac: int) -> torch.Tensor:
    scale = float(2**frac)
    return torch.round(x * scale).clamp(-(2 ** (width - 1)), 2 ** (width - 1) - 1) / scale


class Arith:
    """One BFP setting (width, exponent width, bias, block) and the
    fixed-point RoPE setting, read from a configuration's quant section."""

    def __init__(self, quant: dict):
        d = quant["default"]
        if d.get("name") != "block_fp" or d.get("bypass", False):
            raise ValueError("the references take a block_fp default section")
        for entry in ("weight", "data_in"):
            if list(d[f"{entry}_block_size"])[:-1] not in ([], [1]):
                raise ValueError("the references take [1, bs] blocks")
        self.d = d
        rope = quant.get("rotary_positional_encoding", {"bypass": True})
        self.rope = None if rope.get("bypass", False) else (
            rope["data_in_width"], rope["data_in_frac_width"])

    def _args(self, entry):
        d = self.d
        bs = d[f"{entry}_block_size"]
        bs = bs[-1] if isinstance(bs, (list, tuple)) else bs
        return d[f"{entry}_width"], d.get(f"{entry}_exponent_width", 8), \
            d.get(f"{entry}_exponent_bias"), bs

    def act(self, x):
        """An activation (data_in): blocks along the last axis."""
        return bfp(x, *self._args("data_in"))

    def weight(self, x):
        """A weight or a matmul's second operand, fake-quantized."""
        return bfp(x, *self._args("weight"))

    def weight_stored(self, w):
        """A weight as packed storage holds it (codes * scales)."""
        return bfp_stored(w, *self._args("weight"))

    def bias(self, b):
        d = self.d
        if "bias_width" not in d:
            return b
        bs = d["bias_block_size"]
        bs = bs[-1] if isinstance(bs, (list, tuple)) else bs
        return bfp(b, d["bias_width"], d.get("bias_exponent_width", 8),
                   d.get("bias_exponent_bias"), bs)

    def table(self, t):
        return t if self.rope is None else fixed(t, *self.rope)
