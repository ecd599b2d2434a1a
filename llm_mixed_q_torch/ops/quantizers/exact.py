"""Exact powers of two and exact roundings of log2(x).

``exact_exp2`` builds 2^e from bits, as the JAX package does, so every
block scale is exactly a power of two.

``ceil_log2`` (block_fp, its packing and the Hopper kernels) is the exact
ceil(log2(x)), read from the binary exponent with ``frexp``. The JAX
package takes ``ceil(log2(x))`` through ``jnp.log2``, which XLA:CPU gets
wrong at some exact powers of two (e.g. 2^-13 -> -12.99999); the port
does not copy that.

``floor_log2_f32``, ``ceil_log2_f32`` and ``round_log2_f32`` (the other
block and elementwise quantizers) take floor, ceil and round of log2(x)
rounded to the nearest float32, as the reference's ``torch.log2`` and the
native packer's ``std::log2`` leave it, but computed without a libm: with
x = f * 2^e, f in [1, 2), the float32 nearest e + log2(f) is e, e + 1/2 or
e + 1 only for f within a threshold of 1, sqrt(2) or 2 that depends on e
alone (the float32 spacing there), tabulated once on the host. So the
card and the CPU agree bit for bit, and the quantizers agree with the
reference where the float32 log2 of a neighbour of 2^k rounds to k itself:
an exact ceil would take |x| + 1e-9 just above a small power of two 2^k to
k + 1 where the reference's float32 log2 gives k.
"""

from __future__ import annotations

import functools
import math

import numpy as np
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


def _gap(n: float, toward: float) -> float:
    """Distance from float32 n to its float32 neighbour toward ``toward``."""
    n32 = np.float32(n)
    return abs(float(np.nextafter(n32, np.float32(toward))) - float(n32))


# for every binary exponent e of a positive float32 (-149 .. 127), with
# f = x / 2^e = 1 + j / 2^23 in [1, 2): thresholds on j from the float32
# spacing where e + log2(f) lies. Rows: j below row 0: it rounds down to e;
# j above row 1: up to e + 1; j strictly between rows 2 and 3: onto e + 1/2
# (never equal: log2(f) is irrational for j > 0)
_E0 = -149
_LN2 = math.log(2.0)
_J = 2.0**23
_THRESHOLDS = np.array([
    [math.ceil(_J * math.expm1(_LN2 * _gap(e, math.inf) / 2)),
     math.floor(_J * (1 + 2 * math.expm1(-_LN2 * _gap(e + 1, -math.inf) / 2))),
     math.floor(_J * (math.sqrt(2) * 2 ** (-_gap(e + 0.5, -math.inf) / 2) - 1)),
     math.ceil(_J * (math.sqrt(2) * 2 ** (_gap(e + 0.5, math.inf) / 2) - 1))]
    for e in range(_E0, 128)], dtype=np.int32).T
_J_SQRT2 = math.ceil(_J * (math.sqrt(2) - 1))  # f >= sqrt(2) iff j >= this


@functools.lru_cache(maxsize=None)
def _thresholds(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_THRESHOLDS).to(device)


def _f32_log2_parts(m: torch.Tensor, rows):
    """(e, j, thresholds) of m > 0: m = (1 + j / 2^23) * 2^e, and the
    thresholds ``rows`` of each element's e. Every step is exact."""
    mant, ex = torch.frexp(m)
    e = ex - 1
    j = ((mant * 2.0 - 1.0) * _J).to(torch.int32)
    idx = (e - _E0).clamp(0, _THRESHOLDS.shape[1] - 1)
    t = _thresholds(m.device)
    return e, j, [t[r][idx] for r in rows]


def _finish(m: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """e as float32 for m > 0; -inf at 0, +inf at +inf."""
    e = e.to(torch.float32)
    e = torch.where(m > 0, e, torch.full_like(e, float("-inf")))
    return torch.where(torch.isinf(m), m, e)


def floor_log2_f32(m: torch.Tensor) -> torch.Tensor:
    """floor of the float32-rounded log2(m), float32 m >= 0."""
    e, j, (up,) = _f32_log2_parts(m, (1,))
    return _finish(m, e + (j > up).to(e.dtype))


def ceil_log2_f32(m: torch.Tensor) -> torch.Tensor:
    """ceil of the float32-rounded log2(m), float32 m >= 0."""
    e, j, (down,) = _f32_log2_parts(m, (0,))
    return _finish(m, e + (j >= down).to(e.dtype))


def round_log2_f32(m: torch.Tensor) -> torch.Tensor:
    """round (half to even) of the float32-rounded log2(m), float32 m >= 0:
    e + 1 where f >= sqrt(2), the even one of e and e + 1 where the float32
    log2 is e + 1/2."""
    e, j, (lo, hi) = _f32_log2_parts(m, (2, 3))
    half = (lo < j) & (j < hi)
    up = torch.where(half, (e & 1) == 1, j >= _J_SQRT2)
    return _finish(m, e + up.to(e.dtype))
