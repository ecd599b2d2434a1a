"""Dequant-arithmetic variants of the sub-byte matmul on the card: probe P1,
the counterpart of the TPU probe ``tools/kvariants.py`` (``matmul_variant``
with ``_kernel_v2`` and ``_kernel_v3``), in K1's transposed layout and in
K3's lane-major one.

    python -m llm_mixed_q_torch.tools.kvariants [--shape=qkv] [--reps=3] [--device=cpu]

At each Llama-2-7B projection shape (``ksub.SHAPES``; ``--shape`` picks
those whose name holds it), random weights from seed 0 are packed with
``pack_block_fp_subbyte(w, 6, 8, 127, [1, 16])`` and enough copies rotated
that no call finds its weights in the L2 (``timing.copies_for``). For each
layout, one line per row (µs a call, GB/s of packed weight, the share of
the card's memory peak) on the same bf16 x [8, K]:

- ``production``: K1 (transposed) or K3 (lane-major) without activation
  quantizer, the TPU tool's ``v1_dimsem`` (its ``dimension_semantics`` is
  Mosaic lowering);
- ``v2``: w = bf16(code - cmax) * bf16(scale), the product in bf16
  arithmetic;
- ``v3``: the biased code times the scale, no per-element subtract; one
  correction cmax * (sum of x over the block) * scale per row, column and
  block (``v3_bn2048``'s tile width has no counterpart).

Scales are today's uint8 scale bytes, decoded as ``ksub``'s ship decodes
them. (The TPU tool passes ``PackedBFPSub.scales`` to its kernels as if
they were float32 scales, as they were when it was written; fed today's
bytes it multiplies by the exponent byte.) ``matmul_variant_plain``
computes each variant in plain PyTorch. With ``--device=cpu`` each plain
version runs once and its max|y| is printed: the CPU gives no card times.
"""

from __future__ import annotations

import argparse
from functools import partial

import torch

from .. import resolve_device
from ..kernels.dequant_matmul import _k_padded
from ..kernels.packing import pack_block_fp_subbyte, packed_nbytes, transpose_subbyte
from . import ksub
from .timing import SetupClock, card_peaks, chain_ms, copies_for, normal_draws

VARIANTS = ("v2", "v3")
# TPU case names of the same instance: tile widths (bn) are Mosaic tiling
ALIASES = {"v2_bf16": "v2", "v3_corr": "v3", "v3_bn2048": "v3"}
# the TPU case that is the production kernel, not a variant
PRODUCTION_CASE = "v1_dimsem"
# the variants of the C entry point lmq_probe_variant, by index (P1's,
# then P3's)
ENTRY_VARIANTS = ("v2", "v3", "v4_f32s", "v4_bf16s")


def instance(variant: str) -> str:
    """The port's instance of a variant or TPU case name; raises for an
    unknown one."""
    variant = ALIASES.get(variant, variant)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (P1 has {VARIANTS}; "
                         f"{PRODUCTION_CASE} is the production kernel without actq)")
    return variant


def check_block(name: str, packed):
    if packed.block_size < 4:
        raise ValueError(f"{name}: the variant kernels take blocks of 4 or more, "
                         f"got {packed.block_size}")


def matmul_variant_plain(x: torch.Tensor, packed, variant: str) -> torch.Tensor:
    """Plain version of P1: x [M, Kx] (Kx <= K_pad, zero past Kx, rounded to
    bf16) against the sub-byte weight (either layout, uint8 scale bytes)
    under ``variant`` -> y [M, N] float32."""
    variant = instance(variant)
    xb, fields, e8 = ksub.plain_operands(x, packed)
    bs, cmax = packed.block_size, 2 ** (packed.width - 1) - 1
    s = ksub.probe_scale(e8.to(torch.int32))  # [N, K_pad / bs]
    sk = s.repeat_interleave(bs, dim=1)
    if variant == "v2":
        w = ((fields - cmax).to(torch.bfloat16) * sk.to(torch.bfloat16)).float()
        return xb @ w.t()
    # v3: biased codes, then one correction per (row, column, block)
    xsum = xb.reshape(xb.shape[0], -1, bs).sum(dim=-1)  # [M, K_pad / bs]
    return xb @ (fields.float() * sk).t() - cmax * (xsum @ s.t())


def matmul_variant(x: torch.Tensor, packed, variant: str) -> torch.Tensor:
    """P1: x [M, Kx] f32 (Kx <= K_pad, zero past Kx) against a sub-byte
    weight (``PackedBFPSubT`` or ``PackedBFPSub``, uint8 scale bytes) under
    ``variant`` ("v2" or "v3", or a TPU case name) -> y [M, N] f32.
    Launches the kernel for CUDA tensors (counting it in
    ``launches[layout]``), computes the plain version for CPU tensors."""
    if not x.is_cuda:
        return matmul_variant_plain(x, packed, variant)
    name = "matmul_variant"
    variant = instance(variant)
    check_block(name, packed)
    if packed.scales.dtype != torch.uint8:
        raise ValueError(f"{name}: P1 reads uint8 scale bytes, got {packed.scales.dtype}")
    y, layout = ksub.launch_probe("lmq_probe_variant", name, x, packed,
                                  ENTRY_VARIANTS.index(variant))
    if layout is not None:
        matmul_variant.launches[layout] += 1
    return y


matmul_variant.launches = dict.fromkeys(ksub.LAYOUTS, 0)


def log_row(log, label, on_card, value, nbytes=None, peak=None):
    """One line of an entry point's table: µs, GB/s and share of peak on the
    card, max|y| of the plain version on the CPU."""
    if not on_card:
        log(f"  {label:>32s}: max|y| {value:.6g} (plain version, cpu)")
    else:
        log(f"  {label:>32s}: {value * 1e3:8.1f} us  ({nbytes / value / 1e6:6.0f} GB/s, "
            f"{nbytes / value / 1e-3 / peak:.3f} of peak)")


def run(shapes=ksub.SHAPES, device=None, reps=3, seed=0, log=print) -> dict:
    """Time the production kernel and every variant in both layouts at each
    shape; -> {shape: {"bytes": packed bytes, layout: {"production" or
    variant: ms}}}. On the CPU, runs each plain version once and returns
    max|y| in place of the times."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    peak = card_peaks(torch.cuda.get_device_name(device))[0] if on_card else None
    normal = normal_draws(seed, device)
    clock = SetupClock("kvariants", device)
    out = {}
    for sname, (n, k) in shapes.items():
        draw = lambda: pack_block_fp_subbyte(normal((n, k), 0.02), ksub.WIDTH, 8, 127,
                                             [1, ksub.BLOCK])
        lane_major = clock(lambda: [draw()])
        nb = packed_nbytes(lane_major[0])
        lane_major += clock(lambda: [draw() for _ in range((copies_for(nb) if on_card else 1) - 1)])
        packs = {"transposed": clock(lambda: [transpose_subbyte(p) for p in lane_major]),
                 "lane_major": lane_major}
        # the same bf16 x for every row: the production kernels take [M, K]
        x = clock(lambda: normal((ksub.M, k)).to(torch.bfloat16).float())
        bound = f"bound at {peak / 1e12} TB/s {nb / peak * 1e6:.1f} us" if on_card else "cpu"
        log(f"{sname}: N={n} K={k} K_pad={_k_padded(lane_major[0])} M={ksub.M} "
            f"bytes={nb / 1e6:.1f}MB copies={len(lane_major)} {bound}")
        res = out[sname] = {"bytes": nb}
        for layout in ("transposed", "lane_major"):
            res[layout] = {}
            prod = ksub.PRODUCTION[layout]
            calls = [("production", [partial(prod, x, p, None) for p in packs[layout]])]
            calls += [(v, [partial(matmul_variant, x, p, v) for p in packs[layout]])
                      for v in VARIANTS]
            for v, fns in calls:
                label = f"{layout} " + (v if v != "production" else
                                        f"{'K1' if layout == 'transposed' else 'K3'} (v1_dimsem)")
                res[layout][v] = chain_ms(fns, reps=reps) if on_card else fns[0]().abs().max().item()
                log_row(log, label, on_card, res[layout][v], nb, peak)
        del packs, lane_major
    clock.log(log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="", help="run the shapes whose name holds this")
    ap.add_argument("--reps", type=int, default=3, help="timed chains of 100 calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    shapes = {name: s for name, s in ksub.SHAPES.items() if args.shape in name}
    return run(shapes, args.device, args.reps)


if __name__ == "__main__":
    main()
