"""Scale-storage variants of the fused dequant-matmuls on the card: probes
P3 (``sub_variant``: the sub-byte matmul with FMA dequant and decoded
float32 or bf16 scales, in K1's transposed layout and in K3's lane-major
one) and P2 (``int8_variant``: the int8 matmul of K2's CUDA-core design,
from before K2 moved to the tensor cores, with bf16 scales, and the same
copy with float32 scales as its control), the counterparts of the TPU
probe ``tools/kvariants2.py``.

    python -m llm_mixed_q_torch.tools.kvariants2 [i|s|all] [--shape=qkv] [--reps=3] [--device=cpu]

``i`` runs the int8 rows, ``s`` the sub-byte rows. At each Llama-2-7B
projection shape (``ksub.SHAPES``), random weights from seed 0 are packed
with ``pack_block_fp`` / ``pack_block_fp_subbyte(w, 6, 8, 127, [1, 16])``
and enough copies rotated that no call finds its weights in the L2; the
stored scale arrays of each copy are made before the timed calls
(``stored_scales``). One line per row (µs a call, GB/s of the bytes it
streams, the share of the card's memory peak), all on the same bf16 x
[8, K]:

- int8: ``K2`` (float32 scales, no activation quantizer: the TPU tool's
  ``i_base_*``), ``int8_f32s`` (the design's copy in P2, float32 scales:
  the control, equal to ``ktune7b``'s c32_k512) and ``int8_bf16s``
  (the copy with s stored bf16: ``i_bf16s_*``), w = code * s;
- sub-byte, each layout: ``production`` (K1 or K3 without activation
  quantizer: ``s_base_*``), ``v4_f32s`` and ``v4_bf16s`` (w = fma(c_b, s,
  -cmax * s) on the stored biased field c_b, s stored decoded as float32 or
  bf16 in the scale bytes' shape: ``s_fma_*``).

The TPU cases' tile sizes (``bm``/``bn``/``bk``) are Mosaic tiling with no
counterpart: each case maps to one row (``CASES``). ``sub_variant_plain``
and ``int8_variant_plain`` compute each variant in plain PyTorch; with
``--device=cpu`` each plain version runs once and its max|y| is printed.
"""

from __future__ import annotations

import argparse
from functools import partial

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..kernels import _cuda
from ..kernels.dequant_matmul import bfp_matmul_cuda
from ..kernels.packing import (
    PackedBFP,
    pack_block_fp,
    pack_block_fp_subbyte,
    scale_from_e8,
    transpose_subbyte,
)
from . import ksub
from .kvariants import ENTRY_VARIANTS, check_block, log_row
from .timing import SetupClock, card_peaks, chain_ms, copies_for, normal_draws

# by stored scale dtype
SUB_VARIANTS = {torch.float32: "v4_f32s", torch.bfloat16: "v4_bf16s"}
INT8_VARIANTS = {torch.float32: "int8_f32s", torch.bfloat16: "int8_bf16s"}
# each case of the TPU tool -> the row of this module that runs it
CASES = {
    "i_base_128_1024_1024": "K2", "i_base_128_2048_2048": "K2",
    "i_base_128_512_4096": "K2", "i_base_128_4096_512": "K2",
    "i_bf16s_128_1024_1024": "int8_bf16s", "i_bf16s_128_2048_2048": "int8_bf16s",
    "i_bf16s_128_1024_2048": "int8_bf16s",
    "s_base_256_2048": "production",
    "s_fma_f32s_256_2048": "v4_f32s",
    "s_fma_bf16s_256_2048": "v4_bf16s", "s_fma_bf16s_256_4096": "v4_bf16s",
    "s_fma_bf16s_256_1024": "v4_bf16s",
}


def stored_scales(packed, dtype: torch.dtype):
    """``packed`` with its scales stored as ``dtype`` in the same shape:
    uint8 scale bytes decoded by ``scale_from_e8``, float32 scales cast (both
    exact: the scales are powers of two)."""
    if packed.scales.dtype == dtype:
        return packed
    if packed.scales.dtype == torch.uint8:
        return packed._replace(scales=scale_from_e8(packed.scales, dtype))
    if packed.scales.dtype == torch.float32:
        return packed._replace(scales=packed.scales.to(dtype))
    raise ValueError(f"cannot store {packed.scales.dtype} scales as {dtype}")


def _instance(name: str, variants: dict, scale_dtype) -> str:
    if scale_dtype not in variants:
        raise ValueError(f"{name}: scale dtype {scale_dtype} is not one of {list(variants)}")
    return variants[scale_dtype]


def sub_variant_plain(x: torch.Tensor, packed, scale_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of P3: x [M, Kx] (Kx <= K_pad, zero past Kx, rounded to
    bf16) against the sub-byte weight (either layout) with its scales stored
    as ``scale_dtype`` -> y [M, N] float32."""
    _instance("sub_variant", SUB_VARIANTS, scale_dtype)
    xb, fields, s = ksub.plain_operands(x, stored_scales(packed, scale_dtype))
    sk = s.float().repeat_interleave(packed.block_size, dim=1)
    cmax = 2 ** (packed.width - 1) - 1
    return xb @ (fields.float() * sk - cmax * sk).t()  # fma(c_b, s, -cmax s): exact


def sub_variant(x: torch.Tensor, packed, scale_dtype=torch.bfloat16) -> torch.Tensor:
    """P3: x [M, Kx] f32 (Kx <= K_pad, zero past Kx) against a sub-byte
    weight (``PackedBFPSubT`` or ``PackedBFPSub``) whose scales are stored
    as ``scale_dtype`` (float32 or bfloat16; uint8 scale bytes are decoded
    here first, outside the kernel) -> y [M, N] f32. Launches the kernel for
    CUDA tensors (counting it in ``launches[layout]``), computes the plain
    version for CPU tensors."""
    if not x.is_cuda:
        return sub_variant_plain(x, packed, scale_dtype)
    name = "sub_variant"
    variant = _instance(name, SUB_VARIANTS, scale_dtype)
    check_block(name, packed)
    y, layout = ksub.launch_probe("lmq_probe_variant", name, x,
                                  stored_scales(packed, scale_dtype),
                                  ENTRY_VARIANTS.index(variant))
    if layout is not None:
        sub_variant.launches[layout] += 1
    return y


sub_variant.launches = dict.fromkeys(ksub.LAYOUTS, 0)


def int8_variant_plain(x: torch.Tensor, packed: PackedBFP,
                       scale_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of P2: x [M, Kx] (Kx <= K_pad, zero past Kx, rounded to
    bf16) against int8 codes times block scales stored as ``scale_dtype``
    (bfloat16, or float32 for the control) -> y [M, N] float32."""
    _instance("int8_variant", INT8_VARIANTS, scale_dtype)
    p = stored_scales(packed, scale_dtype)
    n, k_pad = p.codes.shape
    xb = ksub._bf16(F.pad(x, (0, k_pad - x.shape[1])))
    w = p.codes.float().reshape(n, -1, p.block_size) * p.scales.float()[:, :, None]
    return xb @ w.reshape(n, k_pad).t()


def int8_variant(x: torch.Tensor, packed: PackedBFP, scale_dtype=torch.bfloat16) -> torch.Tensor:
    """P2: x [M, Kx] f32 (Kx <= K_pad, zero past Kx) against int8 codes with
    block scales stored as ``scale_dtype``: bfloat16 (float32 ``PackedBFP``
    scales are cast here first, outside the kernel), or float32 for the
    control -> y [M, N] f32. Launches the kernel for CUDA tensors (counting
    it in ``launches``), computes the plain version for CPU tensors. The
    kernel reads bf16 scales in aligned pairs: an odd number of them is
    copied here into a buffer one longer (no Llama-2-7B shape has one)."""
    if not x.is_cuda:
        return int8_variant_plain(x, packed, scale_dtype)
    name = "int8_variant"
    _instance(name, INT8_VARIANTS, scale_dtype)
    p = stored_scales(packed, scale_dtype)
    n, k_pad = p.codes.shape
    bs = p.block_size
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous() or x.shape[1] > k_pad:
        raise ValueError(f"{name}: x must be a contiguous [M, <= {k_pad}] float32 tensor")
    if any(t.device != x.device or not t.is_contiguous() for t in p[:2]):
        raise ValueError(f"{name}: packed buffers must be contiguous on {x.device}")
    if bs < 4 or 128 % bs or p.codes.data_ptr() % 4 or p.scales.data_ptr() % 4:
        raise ValueError(f"{name}: block {bs} must divide 128 and be >= 4, codes and scales "
                         "4-byte aligned")
    scales, bf16 = p.scales, scale_dtype == torch.bfloat16
    if bf16 and scales.numel() % 2:
        scales = torch.cat([scales.reshape(-1), scales.new_zeros(1)])
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    rc = _cuda.lib("probes").lmq_probe_int8(
        x.data_ptr(), p.codes.data_ptr(), scales.data_ptr(), y.data_ptr(), m, n, x.shape[1],
        k_pad, bs, int(bf16), _cuda.stream_ptr(x))
    _cuda.check(rc, name)
    int8_variant.launches += 1
    return y


int8_variant.launches = 0


def stored_nbytes(packed) -> int:
    """Bytes of the packed weight as stored: codes or words, and scales at
    their element size."""
    return sum(t.numel() * t.element_size() for t in packed[:2])


def _time_rows(rows, on_card, reps, peak, log, res):
    """rows: [(key, label, [fn per copy], bytes streamed)]."""
    for key, label, fns, nbytes in rows:
        res[key] = chain_ms(fns, reps=reps) if on_card else fns[0]().abs().max().item()
        log_row(log, label, on_card, res[key], nbytes, peak)


def run(shapes=ksub.SHAPES, device=None, reps=3, seed=0, log=print, which="all") -> dict:
    """Time the int8 rows (``which`` "i" or "all") and the sub-byte rows in
    both layouts ("s" or "all") at each shape; -> {shape: {"int8" or
    layout: {row: ms}, "bytes": {row: bytes streamed}}}. On the CPU, runs
    each plain version once and returns max|y| in place of the times."""
    if which not in ("i", "s", "all"):
        raise ValueError(f"which must be i, s or all, got {which!r}")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    peak = card_peaks(torch.cuda.get_device_name(device))[0] if on_card else None
    normal = normal_draws(seed, device)
    clock = SetupClock("kvariants2", device)
    out = {}
    for sname, (n, k) in shapes.items():
        w0 = lambda: normal((n, k), 0.02)
        x = clock(lambda: normal((ksub.M, k)).to(torch.bfloat16).float())
        res = out[sname] = {"bytes": {}}
        log(f"{sname}: N={n} K={k} M={ksub.M}" + ("" if on_card else " (cpu)"))
        if which in ("i", "all"):
            p8 = clock(lambda: [pack_block_fp(w0(), ksub.WIDTH, 8, 127, [1, ksub.BLOCK])])
            p8 += clock(lambda: [
                pack_block_fp(w0(), ksub.WIDTH, 8, 127, [1, ksub.BLOCK])
                for _ in range((copies_for(stored_nbytes(p8[0])) if on_card else 1) - 1)])
            stored = clock(lambda: {v: [stored_scales(p, dt) for p in p8]
                                    for dt, v in INT8_VARIANTS.items()})
            rows = [("K2", "int8 K2 (i_base)", [partial(bfp_matmul_cuda, x, p, None) for p in p8],
                     stored_nbytes(p8[0]))]
            rows += [(v, f"int8 {v}", [partial(int8_variant, x, p, dt) for p in stored[v]],
                      stored_nbytes(stored[v][0])) for dt, v in INT8_VARIANTS.items()]
            res["bytes"].update({v: nb for v, _, _, nb in rows})
            res["int8"] = {}
            _time_rows(rows, on_card, reps, peak, log, res["int8"])
            del p8, stored
        if which in ("s", "all"):
            draw = lambda: pack_block_fp_subbyte(w0(), ksub.WIDTH, 8, 127, [1, ksub.BLOCK])
            lane_major = clock(lambda: [draw()])
            lane_major += clock(lambda: [draw() for _ in range(
                (copies_for(stored_nbytes(lane_major[0])) if on_card else 1) - 1)])
            for layout in ("transposed", "lane_major"):
                packs = lane_major if layout == "lane_major" else clock(
                    lambda: [transpose_subbyte(p) for p in lane_major])
                stored = clock(lambda: {v: [stored_scales(p, dt) for p in packs]
                                        for dt, v in SUB_VARIANTS.items()})
                prod = ksub.PRODUCTION[layout]
                rows = [("production", f"{layout} {'K1' if layout == 'transposed' else 'K3'} (s_base)",
                         [partial(prod, x, p, None) for p in packs], stored_nbytes(packs[0]))]
                rows += [(v, f"{layout} {v}", [partial(sub_variant, x, p, dt) for p in stored[v]],
                          stored_nbytes(stored[v][0])) for dt, v in SUB_VARIANTS.items()]
                res["bytes"].update({v: nb for v, _, _, nb in rows})
                res[layout] = {}
                _time_rows(rows, on_card, reps, peak, log, res[layout])
                del packs, stored
            del lane_major
    clock.log(log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=("i", "s", "all"),
                    help="int8 rows, sub-byte rows, or both")
    ap.add_argument("--shape", default="", help="run the shapes whose name holds this")
    ap.add_argument("--reps", type=int, default=3, help="timed chains of 100 calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    shapes = {name: s for name, s in ksub.SHAPES.items() if args.shape in name}
    return run(shapes, args.device, args.reps, which=args.which)


if __name__ == "__main__":
    main()
