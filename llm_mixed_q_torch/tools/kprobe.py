"""Column tile of the lane-major sub-byte matmul on the card: probe P4
(``subbyte_tile``: a copy of K3's former CUDA-core design with ``cols``
output columns a block and ``tps`` packing tiles staged a step), the counterpart of the TPU probe
``tools/kprobe.py`` (``subbyte_call``). ``ktune7b`` runs the same kernel
for P7 (tiles per step).

    python -m llm_mixed_q_torch.tools.kprobe [case,...] [--shape=o] [--reps=3] [--device=cpu]

At each Llama-2-7B projection shape (``ksub.SHAPES``; ``--shape`` picks
those whose name holds it), random weights from seed 0 are packed with
``pack_block_fp_subbyte`` / ``pack_block_fp(w, 6, 8, 127, [1, 16])`` and
enough copies rotated that no call finds its weights in the L2
(``timing.copies_for``). One line per row on the same bf16 x [8, K]: µs a
call, GB/s of the bytes it streams, the share of the card's memory peak,
its steps (barrier pairs a block), blocks, blocks an SM and waves on the
card's SMs. The rows: the instances of the cases asked for (all by
default), then beside them K3 and K2 without and with the activation
quantizer ``ksub.ACTQ``, and a bf16 ``torch.matmul`` on the
pre-dequantized weight (the library yardstick, in the place of the TPU
tool's ``bf16_xla_dot``; not a port).

The TPU cases map to instances relative to their own shipped tile: bn 2048
(K3's TPU tile) <-> 32 columns (K3's), bn halved <-> columns halved
(``CASES``). ``cost``/``nocost`` (the cost estimate), ``dimsem`` and ``bm``
are Mosaic lowering, or have no effect at M = 8, so ``sub_bn1024_cost`` and
``sub_bn1024_nocost`` are one instance. ``int8_default`` is K2 (the TPU
tool calls ``bfp_matmul_pallas`` without activation quantizer; K2 with it
prints beside). Unknown case names raise.

``subbyte_tile_plain`` computes every instance in plain PyTorch (the knobs
change the schedule, not the product); with ``--device=cpu`` each row's
plain version runs once and its max|y| is printed: the CPU gives no card
times.
"""

from __future__ import annotations

import argparse
import ctypes
import math
from functools import partial
from typing import Callable, NamedTuple

import torch

from .. import resolve_device
from ..kernels import _cuda
from ..kernels.dequant_matmul import (
    _k_padded,
    bfp_matmul_cuda,
    bfp_matmul_subbyte_cuda,
)
from ..kernels.packing import (
    PackedBFPSub,
    pack_block_fp,
    pack_block_fp_subbyte,
    packed_nbytes,
    unpack,
)
from . import ksub
from .timing import SetupClock, card_peaks, chain_ms, copies_for, normal_draws

# the library's instances of subbyte_tile: name -> (cols, tps); c32_t1 is
# K3's former CUDA-core design without its activation quantizer (K3 now runs
# on the tensor cores), the anchor the lane-major probe copies are held to
SUB_INSTANCES = {"c32_t1": (32, 1), "c16_t1": (16, 1), "c8_t1": (8, 1), "c64_t1": (64, 1),
                 "c32_t2": (32, 2), "c16_t2": (16, 2), "c16_t4": (16, 4), "c64_t2": (64, 2)}
# each case of the TPU tool -> the row that runs it
CASES = {
    "sub_bn2048_cost": "c32_t1",  # the TPU tool's shipped config
    "sub_bn1024_cost": "c16_t1", "sub_bn1024_nocost": "c16_t1",
    "sub_bn512_nocost": "c8_t1",
    "sub_bn4096_cost": "c64_t1",
    "int8_default": "K2",
    "bf16_xla_dot": "bf16",
}


class Row(NamedTuple):
    """A row of an entry point's table."""

    fmt: str  # the operand it takes: "sub", "int8" or "bf16" (a pre-dequantized weight)
    call: Callable  # (x, operand) -> y
    grid: Callable | None = None  # (operand) -> (steps, blocks, workspace bytes)
    per_sm: Callable | None = None  # (operand) -> blocks of the instance an SM fits (card)


def _check_instance(cols: int, tps: int):
    """Raise when the library has no instance (cols, tps)."""
    if (cols, tps) not in SUB_INSTANCES.values():
        raise ValueError(f"no subbyte_tile instance with cols={cols}, tps={tps} "
                         f"(the library has {sorted(SUB_INSTANCES.values())})")


def _lane_major(name: str, packed):
    if not isinstance(packed, PackedBFPSub):
        raise TypeError(f"{name}: a lane-major PackedBFPSub weight expected, "
                        f"got {type(packed).__name__}")


def subbyte_tile_plain(x: torch.Tensor, packed: PackedBFPSub, cols: int = 32,
                       tps: int = 1) -> torch.Tensor:
    """Plain version of P4/P7: x [M, Kx] (Kx <= K_pad, zero past Kx, rounded
    to bf16) against the lane-major sub-byte weight -> y [M, N] float32, for
    instance (cols, tps), which changes the schedule only."""
    _check_instance(cols, tps)
    _lane_major("subbyte_tile", packed)
    return ksub.subbyte_probe_plain(x, packed, "ship")


def subbyte_tile(x: torch.Tensor, packed: PackedBFPSub, cols: int = 32,
                 tps: int = 1) -> torch.Tensor:
    """P4 (and P7): x [M, Kx] f32 (Kx <= K_pad, zero past Kx) against a
    lane-major sub-byte weight -> y [M, N] f32, on instance (cols, tps).
    Launches the kernel for CUDA tensors (counting it in ``launches``),
    computes the plain version for CPU tensors."""
    if not x.is_cuda:
        return subbyte_tile_plain(x, packed, cols, tps)
    name = "subbyte_tile"
    _check_instance(cols, tps)
    _lane_major(name, packed)
    k_pad = _k_padded(packed)
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous() or x.shape[1] > k_pad:
        raise ValueError(f"{name}: x must be a contiguous [M, <= {k_pad}] float32 tensor")
    if any(t.device != x.device or not t.is_contiguous() for t in packed[:2]):
        raise ValueError(f"{name}: packed buffers must be contiguous on {x.device}")
    m, n = x.shape[0], packed.out_features
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    rc = _cuda.lib("probes").lmq_probe_subbyte_tile(
        x.data_ptr(), packed.words.data_ptr(), packed.scales.data_ptr(), y.data_ptr(), m, n,
        x.shape[1], k_pad, packed.width, packed.block_size, cols, tps, _cuda.stream_ptr(x))
    _cuda.check(rc, name)
    subbyte_tile.launches += 1
    return y


subbyte_tile.launches = 0


def occupancy(entry: str, *args) -> int:
    """Blocks of a probe instance that fit on one SM (the probe library's
    ``entry``, which takes a pointer to the result last)."""
    blocks = ctypes.c_int(0)
    _cuda.check(getattr(_cuda.lib("probes"), entry)(*args, ctypes.addressof(blocks)), entry)
    return blocks.value


def sub_grid(cols: int, tps: int, packed) -> tuple[int, int, int]:
    """(steps, blocks, workspace bytes) of instance (cols, tps) at M <= 8:
    steps of tps packing tiles, the last one short."""
    n_tiles = _k_padded(packed) // packed.tile
    return math.ceil(n_tiles / tps), math.ceil(packed.out_features / cols), 0


def sub_row(cols: int, tps: int) -> Row:
    return Row("sub", partial(subbyte_tile, cols=cols, tps=tps),
               partial(sub_grid, cols, tps),
               lambda p: occupancy("lmq_probe_subbyte_tile_occupancy", p.width, p.block_size,
                                   cols, tps))


def _bf16_matmul(x, w_bf16):
    return torch.matmul(x.to(torch.bfloat16), w_bf16.t())


# the rows every entry point prints beside its sweep
BESIDE = {
    "K3": Row("sub", partial(bfp_matmul_subbyte_cuda, actq=None)),
    "K3_actq": Row("sub", partial(bfp_matmul_subbyte_cuda, actq=ksub.ACTQ)),
    "K2": Row("int8", partial(bfp_matmul_cuda, actq=None)),
    "K2_actq": Row("int8", partial(bfp_matmul_cuda, actq=ksub.ACTQ)),
    "bf16": Row("bf16", _bf16_matmul),
}
ROWS = {**{name: sub_row(*shape) for name, shape in SUB_INSTANCES.items()
           if shape[1] == 1}, **BESIDE}


def rows_for(cases, table: dict, beside) -> list[str]:
    """Row names for the TPU ``cases`` (all of ``table`` for None), then the
    ``beside`` rows, each once; raises for an unknown case."""
    names = []
    for case in table if cases is None else cases:
        if case not in table:
            raise ValueError(f"unknown case {case!r} (cases: {sorted(table)})")
        if table[case] not in beside:
            names.append(table[case])
    return list(dict.fromkeys([*names, *beside]))


def stream_bytes(fmt: str, operand, m: int, k: int, n: int) -> int:
    """Bytes a row must move: its weight operand as stored, x [m, k] read and
    y [m, n] written once (bf16 x and weight for the yardstick)."""
    if fmt == "bf16":
        return operand.numel() * 2 + 2 * m * k + 4 * m * n
    return packed_nbytes(operand) + 4 * m * (k + n)


def run_rows(rows: list[str], table: dict, shapes=ksub.SHAPES, device=None, reps=3, seed=0,
             log=print, name="kprobe") -> dict:
    """Time each row of ``table`` named in ``rows`` at each shape; -> {shape:
    {fmt: {row: ms}, "bytes": {row: bytes moved}, "steps": {row: steps},
    "blocks": {row: blocks}, "per_sm": {row: blocks an SM}}}. On the CPU,
    runs each plain version once and returns max|y| in place of the times.
    ``name``: the entry point, under which its set-up seconds are kept."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    peak = card_peaks(torch.cuda.get_device_name(device))[0] if on_card else None
    sms = torch.cuda.get_device_properties(device).multi_processor_count if on_card else None
    normal = normal_draws(seed, device)
    clock = SetupClock(name, device)
    fmts = {table[r].fmt for r in rows}
    out = {}
    for sname, (n, k) in shapes.items():
        w0 = lambda: normal((n, k), 0.02)
        x = clock(lambda: normal((ksub.M, k)).to(torch.bfloat16).float())
        ops = {}
        for fmt, packer in (("sub", pack_block_fp_subbyte), ("int8", pack_block_fp)):
            if fmt in fmts:
                draw = lambda: packer(w0(), ksub.WIDTH, 8, 127, [1, ksub.BLOCK])
                ops[fmt] = clock(lambda: [draw()])
                copies = copies_for(packed_nbytes(ops[fmt][0])) if on_card else 1
                ops[fmt] += clock(lambda: [draw() for _ in range(copies - 1)])
        if "bf16" in fmts:  # the yardstick dequantizes the packed copies
            src = next(iter(ops.values()))
            copies = copies_for(2 * n * k) if on_card else 1
            ops["bf16"] = clock(lambda: [unpack(src[i % len(src)], torch.bfloat16)
                                         for i in range(copies)])
        sub_info = ""
        if "sub" in ops:
            p = ops["sub"][0]
            sub_info = f" packing tiles={_k_padded(p) // p.tile}"
        log(f"{sname}: N={n} K={k} M={ksub.M}{sub_info} copies "
            + ", ".join(f"{f} {len(v)}" for f, v in ops.items()) + ("" if on_card else " (cpu)"))
        res = out[sname] = {**{f: {} for f in fmts}, "bytes": {}, "steps": {}, "blocks": {},
                            "per_sm": {}}
        for row in rows:
            spec = table[row]
            fns = [partial(spec.call, x, p) for p in ops[spec.fmt]]
            value = chain_ms(fns, reps=reps) if on_card else fns[0]().abs().max().item()
            res[spec.fmt][row] = value
            nbytes = stream_bytes(spec.fmt, ops[spec.fmt][0], ksub.M, k, n)
            grid = ""
            if spec.grid is not None:
                steps, blocks, ws_bytes = spec.grid(ops[spec.fmt][0])
                nbytes += ws_bytes
                res["steps"][row], res["blocks"][row] = steps, blocks
                grid = f"  steps {steps:3d} blocks {blocks:5d}"
                if on_card:
                    per_sm = res["per_sm"][row] = spec.per_sm(ops[spec.fmt][0])
                    grid += f" ({per_sm}/SM, {blocks / (per_sm * sms):.2f} waves)"
            res["bytes"][row] = nbytes
            if on_card:
                log(f"  {row:>18s}: {value * 1e3:8.1f} us  ({nbytes / value / 1e6:6.0f} GB/s, "
                    f"{nbytes / value / 1e-3 / peak:.3f} of peak){grid}")
            else:
                log(f"  {row:>18s}: max|y| {value:.6g} (plain version, cpu){grid}")
        del ops
    clock.log(log)
    return out


def run(shapes=ksub.SHAPES, device=None, reps=3, seed=0, log=print, cases=None) -> dict:
    """P4: the instances of ``cases`` (TPU case names, all by default) and
    the rows beside them at each shape (``run_rows``)."""
    return run_rows(rows_for(cases, CASES, BESIDE), ROWS, shapes, device, reps, seed, log)


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
