"""Straight-through estimator: the forward is the fake quantizer, the
backward is the identity on the input (the reference's quantizers are
``torch.autograd.Function``s with an identity backward)."""

from __future__ import annotations

import functools

import torch


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn, args, kwargs):
        return fn(x, *args, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def ste(fn):
    """Wrap ``fn(x, *static_args, **static_kwargs)`` so gradients pass
    straight through to ``x``."""

    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        return _StraightThrough.apply(x, fn, args, kwargs)

    return wrapper
