"""Exact powers of two and exact ceil(log2(x)).

``exact_exp2`` builds 2^e from bits, as the JAX package does, so every
block scale is exactly a power of two.

``ceil_log2`` is exact too: it reads the binary exponent with ``frexp``,
like the native C++ packer. The JAX package takes ``ceil(log2(x))``
through ``jnp.log2``, which XLA:CPU gets wrong at some exact powers of two
(e.g. 2^-13 -> -12.99999); the port does not copy that.
"""

from __future__ import annotations

import torch


def exact_exp2(e: torch.Tensor) -> torch.Tensor:
    """2.0**e for an integer-valued float tensor ``e`` (finite), exact for
    every float32 result: normals (e in [-126, 128]; 128 gives +inf),
    subnormals (e in [-149, -127]) and 0 below."""
    ei = e.to(torch.int32).clamp(-150, 128)
    normal_bits = (ei + 127) << 23
    sub_bits = torch.ones_like(ei) << (ei + 149).clamp(0, 22)
    bits = torch.where(ei >= -126, normal_bits, sub_bits)
    val = bits.view(torch.float32)
    return torch.where(ei >= -149, val, torch.zeros_like(val))


def ceil_log2(m: torch.Tensor) -> torch.Tensor:
    """Exact ceil(log2(m)) for float32 m >= 0: -inf at 0, +inf at +inf."""
    mant, ex = torch.frexp(m)
    e = ex.to(torch.float32) - (mant == 0.5).to(torch.float32)
    e = torch.where(m > 0, e, torch.full_like(e, float("-inf")))
    return torch.where(torch.isinf(m), m, e)
