"""Blocking for block-based quantizers (counterpart of the JAX package's
``ops/quantizers/blocking.py``).

The per-block abs-max is computed with pad + reshape + amax and broadcast
back to every element, so a block quantizer is elementwise over
(x, block max). Block-shape inference and padding follow the reference:
1-D bias blocks, per-row activation blocks (2-D, ``skip_first_dim``),
2-D weight tiles, and per-batch 2-D tiles of 3-D activations.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def infer_block_shape(x_shape: Sequence[int], block_shape: Sequence[int]) -> list[int]:
    """Right-align ``block_shape`` with ``x_shape`` and clamp to array dims."""
    x_ndim = len(x_shape)
    block_ndim = len(block_shape)
    if block_ndim >= x_ndim:
        inferred = list(block_shape[-x_ndim:])
    else:
        inferred = [-1] * (x_ndim - block_ndim) + list(block_shape)
    for i in range(x_ndim):
        if inferred[i] == -1 or inferred[i] > x_shape[i]:
            inferred[i] = x_shape[i]
    return inferred


def _pad_to_multiple(x: torch.Tensor, dims: Sequence[int], blocks: Sequence[int]):
    """Zero-pad dims of x up to a multiple of their block size."""
    pads = [0] * (2 * x.ndim)  # F.pad order: last dim first
    for d, b in zip(dims, blocks):
        n = x.shape[d]
        pads[2 * (x.ndim - 1 - d) + 1] = math.ceil(n / b) * b - n
    return F.pad(x, pads) if any(pads) else x


def _fix_zero_blocks(pbm: torch.Tensor, zero_fill: str = "nonzero_min") -> torch.Tensor:
    """Replace zero per-block maxes: with 1.0 (``zero_fill="one"``), or with
    the smallest nonzero block max of the whole tensor (1.0 if every block
    is zero), as the reference does. The fill never changes a block_fp
    output: a zero block's elements all take the |x| <= 1e-8 passthrough.
    On a mesh (``parallel.tp.spmd``) the whole tensor spans the ranks, and
    the minimum is taken over all of them, as XLA takes it over the
    global array."""
    is_zero = pbm == 0
    one = torch.ones((), dtype=pbm.dtype, device=pbm.device)
    if zero_fill == "one":
        return torch.where(is_zero, one, pbm)
    from ...parallel.tp import global_min  # parallel/ imports the quantizers

    nonzero_min = global_min(
        torch.where(is_zero, torch.full_like(pbm, float("inf")), pbm).amin())
    fill = torch.where(torch.isinf(nonzero_min), one, nonzero_min)
    return torch.where(is_zero, fill, pbm)


def block_abs_max(
    x: torch.Tensor, block_size: Sequence[int] | int, skip_first_dim: bool,
    zero_fill: str = "nonzero_min",
) -> torch.Tensor:
    """Per-block abs-max broadcast back to ``x.shape`` (zero blocks fixed)."""
    if isinstance(block_size, int):
        block_size = [block_size]
    block_size = list(block_size)

    if x.ndim == 1:
        if skip_first_dim:
            raise ValueError("skip_first_dim must be False for 1-D (bias) blocking")
        (n,) = x.shape
        bs = infer_block_shape([n], block_size)[0]
        xp = _pad_to_multiple(x, [0], [bs])
        pbm = xp.abs().reshape(-1, bs).amax(dim=1)
        pbm = _fix_zero_blocks(pbm, zero_fill)
        return pbm.repeat_interleave(bs)[:n]

    if x.ndim == 2 and skip_first_dim:
        b, h = x.shape
        bs = infer_block_shape([1, h], block_size)[-1]
        xp = _pad_to_multiple(x, [1], [bs])
        pbm = xp.abs().reshape(b, -1, bs).amax(dim=2)
        pbm = _fix_zero_blocks(pbm, zero_fill)
        return pbm.repeat_interleave(bs, dim=1)[:, :h]

    if x.ndim == 2:  # 2-D weight: full 2-D tiles
        r, c = x.shape
        bs0, bs1 = infer_block_shape([r, c], block_size)
        xp = _pad_to_multiple(x, [0, 1], [bs0, bs1])
        nb0, nb1 = xp.shape[0] // bs0, xp.shape[1] // bs1
        pbm = xp.abs().reshape(nb0, bs0, nb1, bs1).amax(dim=(1, 3))
        pbm = _fix_zero_blocks(pbm, zero_fill)
        return pbm.repeat_interleave(bs0, dim=0).repeat_interleave(bs1, dim=1)[:r, :c]

    if x.ndim == 3 and skip_first_dim:
        b, d1, d2 = x.shape
        _, bs1, bs2 = infer_block_shape([1, d1, d2], block_size)
        xp = _pad_to_multiple(x, [1, 2], [bs1, bs2])
        nb1, nb2 = xp.shape[1] // bs1, xp.shape[2] // bs2
        pbm = xp.abs().reshape(b, nb1, bs1, nb2, bs2).amax(dim=(2, 4))
        pbm = _fix_zero_blocks(pbm, zero_fill)
        out = pbm.repeat_interleave(bs1, dim=1).repeat_interleave(bs2, dim=2)
        return out[:, :d1, :d2]

    raise ValueError(
        f"Unsupported blocking: ndim={x.ndim}, skip_first_dim={skip_first_dim}"
    )
