"""Stage knock-outs of the sub-byte dequant-matmul on the card: probes P8
(the transposed layout of K1) and P9 (the lane-major layout of K3), the
counterparts of the TPU probe ``tools/ksub.py``.

    python -m llm_mixed_q_torch.tools.ksub [--shape=qkv] [--reps=3] [--device=cpu]

At each Llama-2-7B projection shape (``--shape`` picks those whose name
holds it), three or more random weights from seed 0 are packed with
``pack_block_fp_subbyte(w, 6, 8, 127, [1, 16])`` and rotated, so no call
finds its weights in the L2. For each layout, one line per variant (µs a
call, GB/s of packed weight, the share of the card's memory peak), then the
production kernel (K1 or K3) with its activation quantizer ``ACTQ`` on the
same x:

    stream -> extract -> mulconst -> muladd -> shift2 -> ship -> production

``stream`` to ``ship`` is the dequant chain; ``ship`` to the production
kernel is the in-kernel activation quantizer. The variants' semantics are
those of the TPU probe's ``kernel`` (``csrc/probes/subbyte_probe.cu`` spells
them out); ``subbyte_probe_plain`` computes each in plain PyTorch. With
``--device=cpu`` each variant's plain version runs once and its max|y| is
printed: the CPU gives no card times.
"""

from __future__ import annotations

import argparse
from functools import partial

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..kernels import _cuda
from ..kernels.dequant_matmul import (
    _k_padded,
    bfp_matmul_subbyte_cuda,
    bfp_matmul_subbyte_t_cuda,
)
from ..kernels.packing import (
    _SLICE,
    PackedBFPSub,
    PackedBFPSubT,
    pack_block_fp_subbyte,
    packed_nbytes,
    transpose_subbyte,
)
from .timing import SetupClock, card_peaks, chain_ms, copies_for, normal_draws

WIDTH, BLOCK = 6, 16
M = 8
ACTQ = (16, 6, 8, 127)  # the production kernels' data_in quantizer (bfp_6bit.toml)
SHAPES = {  # name: (N, K) of one Llama-2-7B decoder layer's projections
    "qkv": (12288, 4096),
    "o": (4096, 4096),
    "gate_up": (22016, 4096),
    "down": (4096, 11008),
}
VARIANTS = ("ship", "stream", "extract", "mulconst", "muladd", "shift2")
LADDER = ("stream", "extract", "mulconst", "muladd", "shift2", "ship")
# variants of the TPU probe that differ from ship only in TPU lowering
SHIP_ALIASES = {"noconcat": "ship", "lanerepeat": "ship", "tkernel": "ship",
                "tkernel2": "ship"}
LAYOUTS = {"transposed": 0, "lane_major": 1}
PRODUCTION = {"transposed": bfp_matmul_subbyte_t_cuda, "lane_major": bfp_matmul_subbyte_cuda}


def _layout(packed) -> str:
    if isinstance(packed, PackedBFPSubT):
        return "transposed"
    if isinstance(packed, PackedBFPSub):
        return "lane_major"
    raise TypeError(f"a sub-byte packed weight expected, got {type(packed).__name__}")


def _lane_major_view(packed):
    """(words int32 [N, n_tiles*128], block scales [n_tiles, N, tile/bs] in
    their stored dtype) of either layout."""
    if isinstance(packed, PackedBFPSubT):
        nsb = packed.tile // packed.block_size
        nt = packed.scales.shape[0] // nsb
        words = packed.words.t()
        scales = packed.scales.reshape(nt, nsb, -1).permute(0, 2, 1)
    else:
        words, scales = packed.words, packed.scales
    return words.contiguous().view(torch.int32), scales


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def plain_operands(x: torch.Tensor, packed):
    """What the sub-byte probes' plain versions start from, in either layout:
    bf16(x) zero-padded to K_pad [M, K_pad] float32, the stored (biased)
    fields int32 [N, K_pad] in K order, and the block scales [N, K_pad / bs]
    in their stored dtype."""
    words, scales = _lane_major_view(packed)
    width = packed.width
    per_word, n = 32 // width, words.shape[0]
    nt = words.shape[1] // _SLICE
    k_pad = nt * per_word * _SLICE
    xb = _bf16(F.pad(x, (0, k_pad - x.shape[1])))
    shifts = width * torch.arange(per_word, dtype=torch.int32, device=words.device)
    fields = (words.reshape(n, nt, 1, _SLICE) >> shifts.reshape(1, 1, -1, 1)) & (2**width - 1)
    return xb, fields.reshape(n, k_pad), scales.permute(1, 0, 2).reshape(n, -1)


def probe_scale(e8: torch.Tensor) -> torch.Tensor:
    """2^clip(e8 - 128, -126, 127) of int32 scale bytes, as ship decodes
    them (and K3's TPU kernel)."""
    return (((e8 - 128).clamp(-126, 127) + 127) << 23).view(torch.float32)


def subbyte_probe_plain(x: torch.Tensor, packed, variant: str = "ship") -> torch.Tensor:
    """Plain version of the probe kernels: x [M, Kx] (Kx <= K_pad, zero past
    Kx) against the packed weight under ``variant`` -> y [M, N] float32."""
    variant = SHIP_ALIASES.get(variant, variant)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    xb, fields, e8 = plain_operands(x, packed)
    width, bs = packed.width, packed.block_size
    if variant == "stream":
        # the K rows of shift 0 of each tile against the raw words
        words = _lane_major_view(packed)[0]
        nt = words.shape[1] // _SLICE
        xs = xb.reshape(xb.shape[0], nt, 32 // width, _SLICE)[:, :, 0].reshape(-1, nt * _SLICE)
        return xs @ _bf16(words.float()).t()
    e8k = e8.to(torch.int32).repeat_interleave(bs, dim=1)  # [N, K_pad]
    scale = probe_scale(e8k)
    cf = (fields - (2 ** (width - 1) - 1)).float()
    if variant == "ship":
        w = cf * scale
    elif variant == "extract":
        w = cf
    elif variant == "mulconst":
        w = _bf16(cf * 1.0078125)
    elif variant == "muladd":
        added = (cf.view(torch.int32) + ((e8k - 128) << 23)).view(torch.float32)
        w = torch.where(cf == 0, torch.zeros_like(cf), added)
    else:  # shift2: the stored field read as a signed integer
        signed = torch.where(fields >= 2 ** (width - 1), fields - 2**width, fields)
        w = signed.float() * scale
    return xb @ w.t()


def launch_probe(entry: str, name: str, x: torch.Tensor, packed, variant_index: int):
    """Launch the probe library's sub-byte entry point ``entry`` (the C
    interface of ``lmq_probe_subbyte``) on x [M, Kx] f32 (Kx <= K_pad, zero
    past Kx) -> (y [M, N] f32, the layout it launched on, or None for an
    empty product, which launches nothing)."""
    layout = _layout(packed)
    k_pad = _k_padded(packed)
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous() or x.shape[1] > k_pad:
        raise ValueError(f"{name}: x must be a contiguous [M, <= {k_pad}] float32 tensor")
    if any(t.device != x.device or not t.is_contiguous() for t in packed[:2]):
        raise ValueError(f"{name}: packed buffers must be contiguous on {x.device}")
    m, n = x.shape[0], packed.out_features
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y, None
    rc = getattr(_cuda.lib("probes"), entry)(
        x.data_ptr(), packed.words.data_ptr(), packed.scales.data_ptr(), y.data_ptr(),
        m, n, x.shape[1], k_pad, packed.width, packed.block_size, LAYOUTS[layout],
        variant_index, _cuda.stream_ptr(x))
    _cuda.check(rc, name)
    return y, layout


def subbyte_probe(x: torch.Tensor, packed, variant: str = "ship") -> torch.Tensor:
    """A probe kernel (P8 for ``PackedBFPSubT``, P9 for ``PackedBFPSub``):
    x [M, Kx] f32 (Kx <= K_pad, zero past Kx) -> y [M, N] f32. Launches the
    kernel for CUDA tensors (counting it in ``launches[layout]``), computes
    the plain version for CPU tensors."""
    if not x.is_cuda:
        return subbyte_probe_plain(x, packed, variant)
    name = "subbyte_probe"
    variant = SHIP_ALIASES.get(variant, variant)
    if variant not in VARIANTS:
        raise ValueError(f"{name}: unknown variant {variant!r}")
    y, layout = launch_probe("lmq_probe_subbyte", name, x, packed, VARIANTS.index(variant))
    if layout is not None:
        subbyte_probe.launches[layout] += 1
    return y


subbyte_probe.launches = dict.fromkeys(LAYOUTS, 0)


def run(shapes=SHAPES, device=None, reps=3, seed=0, log=print) -> dict:
    """Time every (layout, variant) and the production kernels at each
    shape; -> {shape: {"bytes": packed bytes, layout: {variant or
    "production": ms}}}. On the CPU, runs each plain version once and
    returns max|y| in place of the times."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    peak = card_peaks(torch.cuda.get_device_name(device))[0] if on_card else None
    normal = normal_draws(seed, device)
    clock = SetupClock("ksub", device)
    out = {}
    for sname, (n, k) in shapes.items():
        draw = lambda: pack_block_fp_subbyte(normal((n, k), 0.02), WIDTH, 8, 127, [1, BLOCK])
        lane_major = clock(lambda: [draw()])
        nb = packed_nbytes(lane_major[0])
        lane_major += clock(lambda: [draw() for _ in range((copies_for(nb) if on_card else 1) - 1)])
        packs = {"lane_major": lane_major,
                 "transposed": clock(lambda: [transpose_subbyte(p) for p in lane_major])}
        k_pad = _k_padded(lane_major[0])
        x0 = clock(lambda: normal((M, k_pad)))
        xk = x0[:, :k].contiguous()
        bound = f"bound at {peak / 1e12} TB/s {nb / peak * 1e6:.1f} us" if on_card else "cpu"
        log(f"{sname}: N={n} K={k} M={M} bytes={nb / 1e6:.1f}MB copies={len(packs['transposed'])} "
            f"{bound}")
        res = out[sname] = {"bytes": nb}
        for layout in ("transposed", "lane_major"):
            res[layout] = {}
            prod = PRODUCTION[layout]
            calls = [(v, [partial(subbyte_probe, x0, p, v) for p in packs[layout]])
                     for v in LADDER]
            calls.append(("production", [partial(prod, xk, p, ACTQ) for p in packs[layout]]))
            for v, fns in calls:
                label = f"{layout} {v}" if v != "production" else (
                    f"{layout} {'K1' if layout == 'transposed' else 'K3'} actq")
                if not on_card:
                    res[layout][v] = fns[0]().abs().max().item()
                    log(f"  {label:>26s}: max|y| {res[layout][v]:.6g} (plain version, cpu)")
                    continue
                ms = res[layout][v] = chain_ms(fns, reps=reps)
                log(f"  {label:>26s}: {ms * 1e3:8.1f} us  ({nb / ms / 1e6:6.0f} GB/s, "
                    f"{nb / ms / 1e-3 / peak:.3f} of peak)")
        del packs, lane_major
    clock.log(log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="", help="run the shapes whose name holds this")
    ap.add_argument("--reps", type=int, default=3, help="timed chains of 100 calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    shapes = {name: s for name, s in SHAPES.items() if args.shape in name}
    return run(shapes, args.device, args.reps)


if __name__ == "__main__":
    main()
