"""The scale expansion of a block-scaled dequant on the card: probe P10, the
counterpart of the TPU probe ``tools/kexp.py``.

    python -m llm_mixed_q_torch.tools.kexp [--l=8192] [--b=32] [--reps=3] [--device=cpu]

For each batch element, out = bf16(q) [8, 128] @ w [128, L] in float32,
where w = int8 codes [128, L] times per-block scales [8, L] (taken to
bf16) expanded along the 128 rows in blocks of 16: the step inside K2, K3
and K4 that turns per-block scales into per-element ones. Inputs from seed
0 as the TPU probe draws them (codes in [-31, 31], power-of-two scales).
It prints each TPU variant, the port instance it runs, µs a call, and the
µs of dequant over ``none``. The instances (``csrc/probes/expand_probe.cu``):

    none    the codes alone; the scales are loaded but not applied
    index   w = c * s[k / 16] from a register: how K4 expands
    staged  the expanded scales [128, tile] written to shared memory first

``ALIASES`` maps the TPU's six variants to them. On the TPU they differed
in how Mosaic lowers the expansion; on Hopper there are two forms of it:
``repeat`` is the JAX package's shipping expansion (``_dequant_sublane``),
so it maps to ``index``, the port's; ``dot`` (a one-hot matmul),
``bcast3d`` and ``bcastmat`` (broadcasts reshaped to [128, L]) and
``rollfill`` (a roll fill of a [128, L] array) each materialise the
expanded array before the multiply, so they map to ``staged``.

``expand_probe_plain`` computes each in plain PyTorch, summing k in the
kernels' order; every product is exact, so the kernels equal it bit for
bit. With ``--device=cpu`` each plain version runs once and its max|y| is
printed: the CPU gives no card times. An unknown name raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..kernels import _cuda
from .timing import SetupClock, chain_ms, copies_for

HD = 128
ROWS = 8
BS = 16
NB = HD // BS
VARIANTS = ("none", "index", "staged")
TPU_VARIANTS = ("none", "dot", "bcast3d", "bcastmat", "repeat", "rollfill")
ALIASES = {"none": "none", "repeat": "index", "dot": "staged", "bcast3d": "staged",
           "bcastmat": "staged", "rollfill": "staged"}


def make_inputs(l: int, b: int, seed: int = 0, device=None):
    """(q [b, 8, 128] float32, codes [b, 128, l] int8, scales [b, 8, l]
    float32) as the TPU probe's ``main`` draws them."""
    rng = np.random.default_rng(seed)
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    q = as_t(rng.standard_normal((b, ROWS, HD)), torch.float32)
    codes = as_t(rng.integers(-31, 32, (b, HD, l)), torch.int8)
    scales = as_t(2.0 ** rng.integers(-8, 0, (b, NB, l)), torch.float32)
    return q, codes, scales


def _instance(variant: str, name="expand_probe") -> str:
    instance = ALIASES.get(variant, variant)
    if instance not in VARIANTS:
        raise ValueError(f"{name}: unknown variant {variant!r} (one of "
                         f"{', '.join(VARIANTS + TPU_VARIANTS[1:])})")
    return instance


def expand_probe_plain(q, codes, scales, variant) -> torch.Tensor:
    """Plain version of P10: bf16(q) @ (codes * expanded bf16 scales), or
    @ codes for ``none``, summed over k in order -> [b, 8, L] float32."""
    instance = _instance(variant)
    qb = q.to(torch.bfloat16).float()
    w = codes.float()
    if instance != "none":
        w = w * scales.to(torch.bfloat16).float().repeat_interleave(BS, dim=1)
    out = torch.zeros((q.shape[0], ROWS, codes.shape[2]), dtype=torch.float32, device=q.device)
    for k in range(HD):
        out = out + qb[:, :, k, None] * w[:, None, k, :]
    return out


def expand_probe(q, codes, scales, variant) -> torch.Tensor:
    """The probe kernel P10 (``variant``: an instance or a TPU name).
    Launches the kernel for CUDA tensors (counting it in ``launches``),
    computes the plain version for CPU tensors."""
    if not q.is_cuda:
        return expand_probe_plain(q, codes, scales, variant)
    name = "expand_probe"
    instance = _instance(variant, name)
    if any(t.device != q.device or not t.is_contiguous() for t in (q, codes, scales)):
        raise ValueError(f"{name}: q, codes and scales must be contiguous on one device")
    if q.dtype != torch.float32 or codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{name}: q float32, codes int8, scales float32 expected")
    b, l = codes.shape[0], codes.shape[2]
    if q.shape != (b, ROWS, HD) or codes.shape != (b, HD, l) or scales.shape != (b, NB, l):
        raise ValueError(f"{name}: q [b, {ROWS}, {HD}], codes [b, {HD}, L], scales "
                         f"[b, {NB}, L] expected, got {tuple(q.shape)}, "
                         f"{tuple(codes.shape)}, {tuple(scales.shape)}")
    out = torch.empty((b, ROWS, l), dtype=torch.float32, device=q.device)
    rc = _cuda.lib("probes").lmq_probe_expand(
        q.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(), b, l,
        VARIANTS.index(instance), _cuda.stream_ptr(q))
    _cuda.check(rc, name)
    expand_probe.launches += 1
    return out


expand_probe.launches = 0


def nbytes_of(l: int, b: int) -> int:
    """Bytes the probe must move: codes, scales, q and the float32 output."""
    return b * (HD * l + 4 * NB * l + 4 * ROWS * HD + 4 * ROWS * l)


def run(l=8192, b=32, reps=3, device=None, seed=0, log=print) -> dict:
    """Time each instance once and print every TPU variant against its
    instance's time -> {TPU name: ms}. On the CPU, runs each plain version
    once and returns max|y| in place of the times."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    clock = SetupClock("kexp", device)
    inputs = clock(lambda: make_inputs(l, b, seed, device))
    data = (inputs[1].numel() + 4 * inputs[2].numel()) / 1e6
    log(f"B={b} L={l} codes+scales={data:.1f}MB, with q and the output "
        f"{nbytes_of(l, b) / 1e6:.1f}MB")
    # on the card, copies past twice the L2, so no call finds its inputs there
    sets = [inputs] + clock(lambda: [tuple(t.clone() for t in inputs) for _ in range(
        copies_for(nbytes_of(l, b)) - 1 if on_card else 0)])
    got = {}
    for instance in VARIANTS:
        if on_card:
            got[instance] = chain_ms([lambda s=s: expand_probe(*s, instance) for s in sets],
                                     reps=reps)
        else:
            got[instance] = expand_probe(*inputs, instance).abs().max().item()
    out = {}
    for name in TPU_VARIANTS:
        instance = ALIASES[name]
        out[name] = got[instance]
        if not on_card:
            log(f"  {name:>9s} ({instance}): max|y| {out[name]:.6g} (plain version, cpu)")
            continue
        extra = "" if instance == "none" else (
            f"  (+{(out[name] - got['none']) * 1e3:6.1f} us dequant)")
        log(f"  {name:>9s} ({instance:>6s}): {out[name] * 1e3:7.1f} us" + extra)
    clock.log(log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--l", type=int, default=8192, help="columns of each batch element")
    ap.add_argument("--b", type=int, default=32, help="batch elements")
    ap.add_argument("--reps", type=int, default=3, help="timed chains of 100 calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.l, args.b, args.reps, args.device)


if __name__ == "__main__":
    main()
