"""The one traffic generator. A mix is a data file under ``traffic/``;
this module turns its parameters and the seed into prompts, lengths,
arrival offsets and think times.

Sizes come from fixed grids (quantiles of the stated distribution), which
the seed only permutes, so that every seed gives the same set of sizes
and times in another order; token ids are drawn from the seed.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def loguniform_grid(n: int, lo: int, hi: int, seed: int) -> list[int]:
    """n lengths on the log-uniform quantiles of [lo, hi], permuted."""
    a, b = math.log(lo), math.log(hi)
    grid = [int(round(math.exp(a + (b - a) * (k + 0.5) / n))) for k in range(n)]
    return [grid[i] for i in rng(seed, 1).permutation(n)]


def lognormal_strata(n: int, mean: float, sigma: float, lo: int, hi: int, strata: int,
                     seed: int) -> list[int]:
    """n lengths, in blocks of ``strata``: each block holds the ``strata``
    quantiles of the log-normal law of this mean and sigma (rounded, held
    in [lo, hi]) in an order of its own. Every stretch of ``strata``
    requests of the queue then holds the same set of lengths."""
    mu = math.log(mean) - sigma * sigma / 2
    z = [NormalDist().inv_cdf((k + 0.5) / strata) for k in range(strata)]
    grid = [min(hi, max(lo, int(round(math.exp(mu + sigma * q))))) for q in z]
    r = rng(seed, 1)
    out = []
    while len(out) < n:
        out.extend(grid[i] for i in r.permutation(strata))
    return out[:n]


def lengths(spec: dict, n: int, seed: int) -> list[int]:
    """n prompt lengths of a mix's ``prompt_len``: ``{"dist": "lognormal",
    "mean", "sigma", "lo", "hi", "strata"}`` or log-uniform ``{"lo", "hi"}``."""
    if spec.get("dist", "loguniform") == "lognormal":
        return lognormal_strata(n, spec["mean"], spec["sigma"], spec["lo"], spec["hi"],
                                spec["strata"], seed)
    return loguniform_grid(n, spec["lo"], spec["hi"], seed)


def exponential_grid(n: int, mean: float, seed: int) -> list[float]:
    """n times on the exponential quantiles of ``mean``, permuted."""
    grid = [-mean * math.log(1.0 - (k + 0.5) / n) for k in range(n)]
    return [grid[i] for i in rng(seed, 2).permutation(n)]


def uniform_grid(n: int, spread: float, seed: int) -> list[float]:
    grid = [spread * (k + 0.5) / n for k in range(n)]
    return [grid[i] for i in rng(seed, 3).permutation(n)]


def prompts(lengths: list[int], vocab: int, seed: int) -> list[list[int]]:
    r = rng(seed, 4)
    return [r.integers(0, vocab, size=n).tolist() for n in lengths]


def sequence(index: int, seq_len: int, vocab: int, seed: int) -> np.ndarray:
    """The eval's sequence ``index``: uniform token ids."""
    return rng(seed, 5, index).integers(0, vocab, size=seq_len, dtype=np.int64)
