"""Statistic reducers (counterpart of the JAX package's ``stats/stats.py``;
reference statstic_profiler/stats.py:12-421, directory name sic).

The reducers take torch tensors (a numpy array is taken as one) and reduce
them on the tensor's own device in float32: at Llama-2-7B widths a sample's
taps are megabytes a token, so nothing goes through the host until
``export``. The formulas are the JAX package's, in the same order, so that
a CPU run agrees with it to float32 rounding. ``export`` gives the types the
JAX package's does: floats, nested lists of floats, ints and "NA".
"""

from __future__ import annotations

import logging
import math

import torch

logger = logging.getLogger(__name__)

STAT_NAME_TO_CLS = {}


def _register(cls):
    STAT_NAME_TO_CLS[cls.name] = cls
    return cls


class StatBase:
    name: str = None

    def update_a_sample(self, new_s) -> None:
        raise NotImplementedError

    def compute(self) -> dict:
        raise NotImplementedError

    def export(self) -> dict:
        return {
            self.name: {
                k: v.tolist() if isinstance(v, torch.Tensor) else v
                for k, v in self.compute().items()
            }
        }


def _as_f32(x) -> torch.Tensor:
    """x as a float32 tensor; a float32 tensor as itself, not a copy."""
    return torch.as_tensor(x).to(torch.float32)


@_register
class Record(StatBase):
    """Concatenate every sample (reference stats.py:66-109). One sample is
    kept as given, so recording a float32 weight does not copy it."""

    name = "record"

    def __init__(self, add_new_dim_before_concat: bool = False):
        self.add_new_dim = add_new_dim_before_concat
        self.data = None
        self.count = None

    def update_a_sample(self, new_s):
        new_s = _as_f32(new_s)
        if self.add_new_dim:
            new_s = new_s[None]
        if self.data is None:
            self.data = new_s
            self.count = 1
        else:
            self.data = torch.cat([self.data, new_s], dim=0)
            self.count += 1

    def compute(self):
        return {
            "data": self.data,
            "count": self.count,
            "size_in_bytes": self.data.numel() * self.data.element_size(),
        }


@_register
class VarianceOnline(StatBase):
    """Welford/Chan running mean and variance (reference stats.py:113-223)."""

    name = "variance_online"

    def __init__(self, dims="all"):
        if not (dims in ("all", None) or isinstance(dims, (list, tuple))):
            raise ValueError(f"dims must be 'all', None or a list, got {dims!r}")
        self.dims = sorted(dims) if isinstance(dims, (list, tuple)) else dims
        self.count = 0
        self.mean = 0.0
        self.m = 0.0

    def _update_one(self, new_s):
        self.count += 1
        delta = new_s - self.mean
        self.mean = self.mean + delta / self.count
        self.m = self.m + delta * (new_s - self.mean)

    def update_a_sample(self, new_s):
        new_s = _as_f32(new_s)
        if self.dims == "all":
            # Chan's merge of the sample's mean and variance into the running
            # pair (the JAX package's formula, ddof=1 variance times n_b)
            flat = new_s.reshape(-1)
            n_b = flat.numel()
            mean_b = flat.mean()
            delta = mean_b - self.mean
            self.mean = self.mean + delta * n_b / (self.count + n_b)
            self.m = self.m + flat.var(correction=1) * n_b + delta**2 * self.count * n_b / (
                self.count + n_b
            )
            self.count += n_b
        elif self.dims is None:
            self._update_one(new_s)
        else:
            keep = [i for i in range(new_s.ndim) if i not in self.dims]
            new_s = new_s.permute(keep + list(self.dims))
            new_s = new_s.reshape(new_s.shape[: len(keep)] + (-1,))
            for i in range(new_s.shape[-1]):
                self._update_one(new_s[..., i])

    def compute(self):
        if self.count < 2:
            logger.warning("VarianceOnline: count < 2, returning NA")
            return {"mean": "NA", "variance": "NA"}
        return {
            "mean": torch.as_tensor(self.mean),
            "variance": torch.as_tensor(self.m / self.count),
            "count": self.count,
        }


@_register
class VariancePrecise(Record):
    """Exact variance over every recorded sample (reference stats.py:227-281)."""

    name = "variance_precise"

    def __init__(self, dims="all"):
        super().__init__(add_new_dim_before_concat=True)
        self.dims = dims

    def compute(self):
        if self.dims == "all":
            return {
                "mean": self.data.mean(),
                "variance": self.data.var(correction=1),
                "count": self.data.numel(),
            }
        if self.dims is None:
            if self.data.shape[0] < 2:
                logger.warning("VariancePrecise: count < 2, returning NA")
                return {"mean": "NA", "variance": "NA", "count": self.data.shape[0]}
            return {
                "mean": self.data.mean(dim=0),
                "variance": self.data.var(dim=0, correction=1),
                "count": self.data.shape[0],
            }
        dims = [0] + [i + 1 for i in self.dims]
        return {
            "mean": self.data.mean(dim=dims),
            "variance": self.data.var(dim=dims, correction=1),
            "count": math.prod(self.data.shape[d] for d in dims),
        }


@_register
class RangeMinMax(StatBase):
    """Running min, max and range, of |x| with ``abs`` (reference
    stats.py:285-368)."""

    name = "range_min_max"

    def __init__(self, dims="all", abs: bool = False):
        self.dims = dims
        self.abs = abs
        self.min = None
        self.max = None
        self.count = 0

    def update_a_sample(self, new_s):
        new_s = _as_f32(new_s)
        if self.abs:
            new_s = new_s.abs()
        if self.dims == "all":
            mn, mx, n = new_s.min(), new_s.max(), new_s.numel()
        elif self.dims is None:
            mn, mx, n = new_s, new_s, 1
        else:
            mn = torch.amin(new_s, dim=tuple(self.dims))
            mx = torch.amax(new_s, dim=tuple(self.dims))
            n = math.prod(new_s.shape[d] for d in self.dims)
        if self.min is None:
            self.min, self.max = mn, mx
        else:
            self.min = torch.minimum(self.min, mn)
            self.max = torch.maximum(self.max, mx)
        self.count += n

    def compute(self):
        if self.count < 2:
            logger.warning("RangeMinMax: count < 2, returning NA")
            return {"min": "NA", "max": "NA", "range": "NA", "count": self.count}
        return {
            "min": self.min,
            "max": self.max,
            "range": self.max - self.min,
            "count": self.count,
        }


@_register
class ThresholdCount(StatBase):
    """Counts of |x| above ``threshold``, LLM.int8-style (reference
    stats.py:372-411)."""

    name = "threshold_count"

    def __init__(self, threshold: float = 6.0, dims=None):
        self.threshold = threshold
        self.dims = dims
        self.n_outliers = 0
        self.total = 0
        self.n_samples = 0

    def update_a_sample(self, new_s):
        new_s = _as_f32(new_s)
        comp = new_s.abs() > self.threshold
        if self.dims is not None:
            self.n_outliers = self.n_outliers + comp.sum(dim=tuple(self.dims))
            self.total += math.prod(new_s.shape[d] for d in self.dims)
        else:
            self.n_outliers = self.n_outliers + comp.sum()
            self.total += new_s.numel()
        self.n_samples += 1

    def compute(self):
        n = self.n_outliers
        return {
            "num_outliers": n.tolist() if isinstance(n, torch.Tensor) else int(n),
            "total": self.total,
            "threshold": self.threshold,
            "num_samples": self.n_samples,
        }


def create_new_stat(stat_name: str, **stat_kwargs) -> StatBase:
    if stat_name not in STAT_NAME_TO_CLS:
        raise ValueError(f"Unknown stat name: {stat_name}. Available: {list(STAT_NAME_TO_CLS)}")
    return STAT_NAME_TO_CLS[stat_name](**stat_kwargs)
