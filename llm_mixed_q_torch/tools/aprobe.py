"""Stage knock-outs of decode attention on the card: probe P11, the
counterpart of the TPU probe ``tools/aprobe.py``.

    python -m llm_mixed_q_torch.tools.aprobe [--batch=32] [--s=256] [--reps=30] [--device=cpu]

At the 7B decode shape (b x [nh = 32, hd = 128] q against a pos-major packed
cache of S positions of nkv = 32 heads, every position filled; inputs from
seed 0 as the TPU probe makes them) it times the port's K4 first, then one
line per stage and dot type (µs a call, µs per batch element):

    dma -> dequant -> matmul -> softmax -> quant

``dma`` reads the cache and returns q; ``dequant`` also dequantizes it;
``matmul`` is the TPU kernel's dense q.K and scores.V over every lane of the
cache (all heads), before its mask; ``softmax`` and ``quant`` are K4's
former design (one block a (batch element, kv head), the design K5 keeps)
without and with its prob quantizer (``csrc/probes/attention_probe.cu``
spells them out). Dots in float32, and on bf16 operands for matmul, softmax
and quant. ``quant`` with float32 dots is the anchor of the attention
probes: the other copies equal it, and K4, which reads each cache sector
once for all heads of a chunk of positions, is held to it at the kernels'
tolerance. K4 dots in float32; the TPU probe's shipping line used bf16
dots.
``attention_probe_plain`` computes each stage in plain PyTorch. With
``--device=cpu`` each stage's plain version runs once and its max|ctx| is
printed: the CPU gives no card times.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .. import resolve_device
from ..kernels import _cuda
from ..kernels.attention_decode import (
    _prob_q_args,
    _prob_qdq_fn,
    _REP_MAX,
    attend_dense,
    packed_attention_decode_batch_cuda,
)
from .timing import SetupClock, chain_ms

_PROBE_THREADS = 256
_PROBE_SMEM_MAX = 227 * 1024


def probe_shape_error(rep: int, hd: int) -> str | None:
    """Why the attention probes are not given ``rep`` query rows per kv head
    at head_dim ``hd``, or None: rep 1..8 and a head_dim of 16..256 that
    divides the block's 256 threads (csrc/probes/attention_probe.cu splits
    them into 256 / hd parts)."""
    if not 1 <= rep <= _REP_MAX:
        return f"{rep} query rows per kv head (the probes take 1..{_REP_MAX})"
    if hd > _PROBE_THREADS or _PROBE_THREADS % hd or hd % 16:
        return f"head_dim {hd} does not divide {_PROBE_THREADS} or is not a multiple of 16"
    return None

NH = NKV = 32
REP = 1
HD = 128
BSK = BSV = 16
PROB_Q = (16, 6, 8, None)
STAGES = ("dma", "dequant", "matmul", "softmax", "quant")
DOTS = {"dma": ("f32",), "dequant": ("f32",), "matmul": ("f32", "bf16"),
        "softmax": ("f32", "bf16"), "quant": ("f32", "bf16")}


def make_inputs(batch: int, s_len: int, seed: int = 0, device=None):
    """(q, k codes, k scales, v codes, v scales, positions) as the TPU
    probe's ``make_inputs`` draws them: the cache [b, hd, S*nkv] pos-major,
    codes in [-31, 31], power-of-two scales, every position filled."""
    rng = np.random.default_rng(seed)
    lanes = s_len * NKV
    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    q = as_t(rng.standard_normal((batch, NH, HD)), torch.float32)
    kc = as_t(rng.integers(-31, 32, (batch, HD, lanes)), torch.int8)
    ks = as_t(2.0 ** rng.integers(-8, 0, (batch, HD // BSK, lanes)), torch.float32)
    vc = as_t(rng.integers(-31, 32, (batch, HD, lanes)), torch.int8)
    vs = as_t(2.0 ** rng.integers(-8, 0, (batch, HD // BSV, lanes)), torch.float32)
    pos = torch.full((batch,), s_len - 1, dtype=torch.int32, device=device)
    return q, kc, ks, vc, vs, pos


def _round(t: torch.Tensor, dot: str) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if dot == "bf16" else t


def attention_probe_plain(q, k_codes, k_scales, v_codes, v_scales, positions, stage,
                          dot="f32", bs_k=BSK, bs_v=BSV, nkv=NKV, rep=REP,
                          prob_q=PROB_Q) -> torch.Tensor:
    """Plain version of the probe kernel: ``stage`` of decode attention over
    the pos-major cache (q [b, nh, hd]; codes [b, hd, S*nkv]; scales
    [b, hd/bs, S*nkv]) with ``dot`` ("f32" or "bf16") operands -> [b, nh, hd]."""
    if stage not in STAGES or dot not in DOTS[stage]:
        raise ValueError(f"no stage {stage!r} with {dot} dots")
    if stage in ("dma", "dequant"):
        return q.clone()
    hd = q.shape[2]
    qd = _round(q, dot)
    kd = k_codes.float() * k_scales.repeat_interleave(bs_k, dim=1)  # [b, hd, lanes]
    vd = v_codes.float() * v_scales.repeat_interleave(bs_v, dim=1)
    if stage == "matmul":
        sqrt_hd = torch.full((), math.sqrt(hd), dtype=torch.float32, device=q.device)
        scores = torch.einsum("bhd,bdl->bhl", qd, kd) / sqrt_hd
        return torch.einsum("bhl,bdl->bhd", _round(scores, dot), vd)
    quantize = _prob_qdq_fn(prob_q) if stage == "quant" else None
    probs_fn = None
    if quantize is not None or dot == "bf16":
        probs_fn = lambda p: _round(quantize(p) if quantize is not None else p, dot)
    return attend_cache(qd, kd, vd, positions, probs_fn, nkv, rep)


def attend_cache(qd, kd, vd, positions, probs_fn=None, nkv=NKV, rep=REP, masks=None):
    """``attend_dense`` over the dequantized pos-major cache: qd [b, nh, hd],
    kd and vd [b, hd, S*nkv], ``probs_fn`` the map of the probabilities,
    ``masks`` attend_dense's -> ctx [b, nh, hd]."""
    b, nh, hd = qd.shape
    s_len = kd.shape[2] // nkv
    ctx = attend_dense(qd.reshape(b, nkv, rep, hd),
                       kd.reshape(b, hd, s_len, nkv).permute(0, 3, 1, 2),
                       vd.reshape(b, hd, s_len, nkv).permute(0, 3, 2, 1),
                       positions.reshape(b), probs_fn, masks)
    return ctx.reshape(b, nh, hd)


def check_operands(name, q, k_codes, k_scales, v_codes, v_scales, nkv, rep, dense, extra=()):
    """Raise ValueError unless the operands suit the probe kernels: q float32
    [b, nkv*rep, hd], int8 codes, every tensor (``extra`` too) contiguous on
    q's device, and a shape the kernel takes (``dense``: a score for every
    lane of the cache). -> S."""
    tensors = (q, k_codes, k_scales, v_codes, v_scales, *extra)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: q, the cache and the masks must be contiguous on one device")
    if q.dtype != torch.float32 or k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise ValueError(f"{name}: q float32, codes int8 expected")
    _, nh, hd = q.shape
    s_len = k_codes.shape[2] // nkv
    if nh != nkv * rep:
        raise ValueError(f"{name}: {nh} query heads != nkv {nkv} * rep {rep}")
    error = probe_shape_error(rep, hd)
    # the probe holds q and a row's scores (every lane of the dense stages)
    # in shared memory, as csrc/probes/attention_probe.cu checks
    smem = 4 * rep * (hd + s_len * (nkv if dense else 1) + _PROBE_THREADS)
    if not error and smem > _PROBE_SMEM_MAX:
        error = f"{smem} bytes of shared memory (at most {_PROBE_SMEM_MAX})"
    if error:
        raise ValueError(f"{name}: {error}")
    return s_len


def attention_probe(q, k_codes, k_scales, v_codes, v_scales, positions, stage, dot="f32",
                    bs_k=BSK, bs_v=BSV, nkv=NKV, rep=REP, prob_q=PROB_Q) -> torch.Tensor:
    """The probe kernel P11: ``stage`` with ``dot`` operands. Launches the
    kernel for CUDA tensors (counting it in ``launches``), computes the plain
    version for CPU tensors."""
    if not q.is_cuda:
        return attention_probe_plain(q, k_codes, k_scales, v_codes, v_scales, positions,
                                     stage, dot, bs_k, bs_v, nkv, rep, prob_q)
    name = "attention_probe"
    if stage not in STAGES or dot not in DOTS[stage]:
        raise ValueError(f"{name}: no stage {stage!r} with {dot} dots")
    s_len = check_operands(name, q, k_codes, k_scales, v_codes, v_scales, nkv, rep,
                           dense=stage == "matmul")
    if stage == "quant" and prob_q is None:
        raise ValueError(f"{name}: the quant stage needs a prob quantizer")
    b, _, hd = q.shape
    pos = positions.to(device=q.device, dtype=torch.int32).reshape(b).contiguous()
    out = torch.empty_like(q)
    rc = _cuda.lib("probes").lmq_probe_attention(
        q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(), v_codes.data_ptr(),
        v_scales.data_ptr(), pos.data_ptr(), out.data_ptr(), b, nkv, rep, hd, s_len, bs_k,
        bs_v, math.sqrt(hd), *_prob_q_args(prob_q), STAGES.index(stage), int(dot == "bf16"),
        _cuda.stream_ptr(q))
    _cuda.check(rc, name)
    attention_probe.launches += 1
    return out


attention_probe.launches = 0


def run(batch=32, s_len=256, reps=30, device=None, seed=0, log=print) -> dict:
    """Time K4 and every (stage, dot) -> {"K4" or "stage/dot": ms}. On the
    CPU, runs each plain version once and returns max|ctx| in place of the
    times."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    clock = SetupClock("aprobe", device)
    inputs = clock(lambda: make_inputs(batch, s_len, seed, device))
    q, kc, ks, vc, vs, pos = inputs
    nbytes = sum(t.numel() * t.element_size() for t in inputs[1:5])
    log(f"shape: b={batch} nh={NH} hd={HD} S={s_len} lanes={s_len * NKV} "
        f"cache={nbytes / 1e6:.1f}MB")
    calls = {"K4": lambda: packed_attention_decode_batch_cuda(
        q, kc, ks, vc, vs, pos, BSK, BSV, nkv=NKV, rep=REP, prob_q=PROB_Q)}
    for stage in STAGES:
        for dot in DOTS[stage]:
            calls[f"{stage}/{dot}"] = (
                lambda stage=stage, dot=dot: attention_probe(*inputs, stage, dot))
    out = {}
    for label, fn in calls.items():
        if not on_card:
            out[label] = fn().abs().max().item()
            log(f"{label:>16s}: max|ctx| {out[label]:.6g} (plain version, cpu)")
            continue
        ms = out[label] = chain_ms([fn], reps=reps)
        log(f"{label:>16s}: {ms * 1e3:8.1f} us  {ms * 1e3 / batch:6.2f} us/elem")
    clock.log(log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--s", type=int, default=256, help="cache positions")
    ap.add_argument("--reps", type=int, default=30, help="timed chains of 100 calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.batch, args.s, args.reps, args.device)


if __name__ == "__main__":
    main()
