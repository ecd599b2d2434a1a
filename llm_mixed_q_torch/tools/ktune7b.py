"""Column tile, K per step and K split of the int8 matmul, and tiles per
step of the lane-major sub-byte matmul, on the card: probes P6
(``int8_tile``: a copy of K2's CUDA-core design, from before K2 moved to
the tensor cores, with ``cols`` output columns a block and
``kstep`` of K staged a step), P5 (``int8_tile(..., band=)``: the same
kernel summing bands of K in blocks of their own, then ``band_sum``) and
P7 (``kprobe.subbyte_tile(..., tps=)``), the counterparts of the TPU probe
``tools/ktune7b.py`` (``int8_call``, ``int8_call(j_inner=True)``,
``sub_call``).

    python -m llm_mixed_q_torch.tools.ktune7b [case,...] [--shape=qkv] [--reps=3] [--device=cpu]

The shapes, weights, rows and columns are ``kprobe``'s (``kprobe.run_rows``):
each case's instance, then K2 and K3 without and with the activation
quantizer and the bf16 library yardstick beside them. Case names are the
TPU tool's (``"int8 bn1024 bk1024"``: quote them, comma-separated); they
map to instances relative to the TPU tool's shipped tiles (``CASES``):

- int8: bn 1024 (K2's TPU tile) <-> 32 columns (the design's), bk 1024 <->
  512 of K a step (the design's), each halved or doubled with the other;
  ``nocost`` and ``nodim`` are Mosaic lowering: that instance. ``j_inner
  (the output tile resident across an outer K axis of bk bands) <-> bands
  of 1024 of K, each summed by blocks of its own into a workspace, then
  added in order (4 bands at K = 4096, 11 at K = 11008, the last short).
- sub-byte: bn as in ``kprobe``; ks packing tiles a step <-> ``tps``.
  Where ``tps`` does not divide the tile count the last step is short:
  the TPU's ``sub_call`` shrinks ``ks`` until it divides instead, which at
  width 6 (a tile is 640 of K, K = 4096 pads to 7 tiles) would run every
  ``ks`` of three of the four shapes as 1. The product is the same; only
  the schedule departs.

``int8_tile_plain`` computes every instance in plain PyTorch (a band
instance sums its bands' products in order, as P5's grid does); with
``--device=cpu`` each row's plain version runs once and its max|y| is
printed: the CPU gives no card times.
"""

from __future__ import annotations

import argparse
import math
from functools import partial

import torch
import torch.nn.functional as F

from ..kernels import _cuda
from ..kernels.packing import PackedBFP
from . import ksub
from .kprobe import BESIDE, SUB_INSTANCES, Row, occupancy, rows_for, run_rows, sub_row

# the library's instances of int8_tile: name -> (cols, kstep, band); c32_k512
# is K2's CUDA-core design without its activation quantizer
INT8_INSTANCES = {"c32_k512": (32, 512, None), "c16_k512": (16, 512, None),
                  "c32_k256": (32, 256, None), "c64_k256": (64, 256, None),
                  "c16_k1024": (16, 1024, None), "c16_k2048": (16, 2048, None),
                  "c8_k2048": (8, 2048, None), "c32_k512_band1024": (32, 512, 1024)}
# each case of the TPU tool -> the row that runs it
CASES = {
    "int8 bn1024 bk1024": "c32_k512",  # the TPU tool's shipped config
    "int8 bn1024 bk1024 nocost": "c32_k512",
    "int8 bn1024 bk1024 nodim": "c32_k512",
    "int8 bn512 bk1024": "c16_k512",
    "int8 bn1024 bk512": "c32_k256",
    "int8 bn1024 bk1024 j_inner": "c32_k512_band1024",
    "int8 bn2048 bk512": "c64_k256",
    "int8 bn512 bk4096": "c16_k2048",
    "int8 bn256 bk4096": "c8_k2048",
    "int8 bn512 bk2048": "c16_k1024",
    "sub bn2048 ks1": "c32_t1",
    "sub bn2048 ks2": "c32_t2",
    "sub bn1024 ks2": "c16_t2",
    "sub bn1024 ks4": "c16_t4",
    "sub bn4096 ks2": "c64_t2",
}


def _check_instance(cols: int, kstep: int, band: int | None):
    """Raise when the library has no kernel (cols, kstep), or when ``band``
    (None: no split) is not a positive multiple of 128."""
    if band is not None and (band < 128 or band % 128):
        raise ValueError(f"int8_tile: a band is a positive multiple of 128 of K, got {band}")
    kernels = {(c, s) for c, s, _ in INT8_INSTANCES.values()}
    if (cols, kstep) not in kernels:
        raise ValueError(f"no int8_tile instance with cols={cols}, kstep={kstep} "
                         f"(the library has {sorted(kernels)})")


def band_sum_plain(ws: torch.Tensor) -> torch.Tensor:
    """Plain version of the band reduction: ws [bands, ...] -> ws[0] + ws[1]
    + ... in that order."""
    y = ws[0].clone()
    for part in ws[1:]:
        y += part
    return y


def band_sum(ws: torch.Tensor) -> torch.Tensor:
    """P5's second launch: the bands' partial sums ws [bands, M, N] f32 ->
    y [M, N], each element added over the bands in order. Launches the
    kernel for CUDA tensors (counting it in ``launches``), computes the
    plain version for CPU tensors."""
    if not ws.is_cuda:
        return band_sum_plain(ws)
    if ws.dtype != torch.float32 or ws.ndim < 2 or not ws.is_contiguous():
        raise ValueError("band_sum: ws must be a contiguous [bands, ...] float32 tensor")
    y = torch.empty(ws.shape[1:], dtype=torch.float32, device=ws.device)
    if y.numel() == 0:
        return y
    rc = _cuda.lib("probes").lmq_probe_band_sum(ws.data_ptr(), y.data_ptr(), ws.shape[0],
                                               y.numel(), _cuda.stream_ptr(ws))
    _cuda.check(rc, "band_sum")
    band_sum.launches += 1
    return y


band_sum.launches = 0


def _operands(x: torch.Tensor, packed: PackedBFP):
    """bf16(x) zero-padded to K_pad and the dequantized weight [N, K_pad]."""
    n, k_pad = packed.codes.shape
    xb = ksub._bf16(F.pad(x, (0, k_pad - x.shape[1])))
    w = packed.codes.float().reshape(n, -1, packed.block_size) * packed.scales[:, :, None]
    return xb, w.reshape(n, k_pad)


def int8_tile_plain(x: torch.Tensor, packed: PackedBFP, cols: int = 32, kstep: int = 512,
                    band: int | None = None) -> torch.Tensor:
    """Plain version of P6/P5: x [M, Kx] (Kx <= K_pad, zero past Kx, rounded
    to bf16) against int8 codes times float32 block scales -> y [M, N]
    float32, for instance (cols, kstep); with ``band``, each band of K's
    product, added in order (``band_sum_plain``)."""
    _check_instance(cols, kstep, band)
    xb, w = _operands(x, packed)
    if band is None:
        return xb @ w.t()
    k_pad = w.shape[1]
    return band_sum_plain(torch.stack([xb[:, k0:k0 + band] @ w[:, k0:k0 + band].t()
                                       for k0 in range(0, k_pad, band)]))


def int8_tile(x: torch.Tensor, packed: PackedBFP, cols: int = 32, kstep: int = 512,
              band: int | None = None) -> torch.Tensor:
    """P6 (P5 with ``band``): x [M, Kx] f32 (Kx <= K_pad, zero past Kx)
    against int8 codes with float32 block scales -> y [M, N] f32, on
    instance (cols, kstep). With ``band``, blocks of their own sum each band
    of K into a workspace [bands, M, N], which ``band_sum`` then adds.
    Launches the kernel for CUDA tensors (counting it in ``launches``),
    computes the plain version for CPU tensors."""
    if not x.is_cuda:
        return int8_tile_plain(x, packed, cols, kstep, band)
    name = "int8_tile"
    _check_instance(cols, kstep, band)
    n, k_pad = packed.codes.shape
    bs = packed.block_size
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous() or x.shape[1] > k_pad:
        raise ValueError(f"{name}: x must be a contiguous [M, <= {k_pad}] float32 tensor")
    if any(t.device != x.device or not t.is_contiguous() for t in packed[:2]):
        raise ValueError(f"{name}: packed buffers must be contiguous on {x.device}")
    if bs < 4 or 128 % bs or packed.codes.data_ptr() % 4:
        raise ValueError(f"{name}: block {bs} must divide 128 and be >= 4, codes 4-byte aligned")
    m = x.shape[0]
    bands = 1 if band is None else math.ceil(k_pad / band)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    out = y if band is None else torch.empty((bands, m, n), dtype=torch.float32,
                                             device=x.device)
    rc = _cuda.lib("probes").lmq_probe_int8_tile(
        x.data_ptr(), packed.codes.data_ptr(), packed.scales.data_ptr(), out.data_ptr(), m, n,
        x.shape[1], k_pad, bs, cols, kstep, k_pad if band is None else band,
        _cuda.stream_ptr(x))
    _cuda.check(rc, name)
    int8_tile.launches += 1
    return y if band is None else band_sum(out)


int8_tile.launches = 0


def int8_grid(cols: int, kstep: int, band: int | None, packed) -> tuple[int, int, int]:
    """(steps a block, blocks, workspace bytes) of an int8 instance at M <=
    8: the longest band's staging steps; the workspace is written and read
    once."""
    n, k_pad = packed.codes.shape
    bands = 1 if band is None else math.ceil(k_pad / band)
    steps = math.ceil(min(k_pad, band or k_pad) / kstep)
    ws_bytes = 0 if band is None else 2 * bands * ksub.M * n * 4
    return steps, math.ceil(n / cols) * bands, ws_bytes


def int8_row(cols: int, kstep: int, band: int | None) -> Row:
    return Row("int8", partial(int8_tile, cols=cols, kstep=kstep, band=band),
               partial(int8_grid, cols, kstep, band),
               lambda p: occupancy("lmq_probe_int8_tile_occupancy", cols, kstep))


ROWS = {**{name: int8_row(*spec) for name, spec in INT8_INSTANCES.items()},
        **{name: sub_row(*SUB_INSTANCES[name]) for name in dict.fromkeys(
            v for c, v in CASES.items() if c.startswith("sub"))},
        **BESIDE}


def run(shapes=ksub.SHAPES, device=None, reps=3, seed=0, log=print, cases=None) -> dict:
    """P6, P5 and P7: the instances of ``cases`` (TPU case names, all by
    default) and the rows beside them at each shape (``kprobe.run_rows``)."""
    return run_rows(rows_for(cases, CASES, BESIDE), ROWS, shapes, device, reps, seed, log,
                    name="ktune7b")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="?", default=None,
                    help="comma-separated TPU case names (all by default)")
    ap.add_argument("--shape", default="", help="run the shapes whose name holds this")
    ap.add_argument("--reps", type=int, default=3, help="timed chains of 100 calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    shapes = {name: s for name, s in ksub.SHAPES.items() if args.shape in name}
    cases = args.cases.split(",") if args.cases else None
    return run(shapes, args.device, args.reps, cases=cases)


if __name__ == "__main__":
    main()
