"""Stage knock-outs of decode attention with bf16 dots, and resident masks,
on the card: probes P12 and P13, the counterparts of the TPU probe
``tools/k3.py`` (``call_v2`` and ``call_v3``).

    python -m llm_mixed_q_torch.tools.k3 [--batch=32] [--reps=5] [--only=name] [--device=cpu]

At the 7B decode shape (b x [nh = 32, hd = 128] q against a pos-major
packed cache of S = 256 positions of nkv = 32 heads, every position filled;
inputs from seed 0 as the TPU probe makes them) it times the port's K4
first, then one line per P12 stage and P13 (µs a call, µs per batch
element):

    v2_dots, v2_softmax, v2_qmax, v2_qmath, v2_full, v3_masks

``dots`` is the TPU kernel's dense q.K and scores.V over every lane of the
cache (all heads), before its mask; ``softmax`` and ``full`` are K4's former
design (one block a (batch element, kv head), P11's template) without and
with its prob quantizer; ``qmax`` replaces each probability by the max
of its aligned run of 16 positions (the quantizer's block max alone, which
on the TPU also reaches the positions after pos up to the end of pos's
run); ``qmath`` runs the quantizer's exponent/mantissa chain with each
probability as its own block max; ``v3_masks`` is ``full`` with the
own-head bias and the causal index read from two resident arrays
(``resident_masks``). All dot on bf16 operands, as the TPU probe does
(``csrc/probes/attention_probe.cu`` spells them out; dots, softmax and
full are P11's matmul, softmax and quant instances with bf16 dots; on
quantized q, whose dots are exact in bf16, full and v3_masks are held to
P11's quant with float32 dots, the anchor of the attention probes, at the
kernels' tolerance: their float32 sums run in another order). K4 dots in
float32 on float32 q, so on the tool's raw q it is not the same function
as the TPU's ship line, whose dots were bf16.

``attention_v2_plain`` and ``attention_v3_plain`` compute each in plain
PyTorch. With ``--device=cpu`` each plain version runs once and its
max|ctx| is printed: the CPU gives no card times. An unknown name raises.
"""

from __future__ import annotations

import argparse
import math

import torch

from .. import resolve_device
from ..kernels import _cuda
from ..kernels.attention_decode import (
    _prob_q_args,
    _prob_qdq_fn,
    packed_attention_decode_batch_cuda,
)
from . import aprobe
from .timing import SetupClock, chain_ms

NH = NKV = 32
REP = 1
HD = 128
S = 256
BSK = BSV = 16
PROB_Q = (16, 6, 8, None)
# the TPU tool's qmath chain: a block of one, 5 mantissa bits, exponent in
# [-127, 128] (block_fp width 6, exponent width 8, bias 127)
QMATH_Q = (1, 6, 8, 127)
MASKED = -1e9  # the TPU tool's NEG_INF, in the resident bias
STAGES = ("dots", "softmax", "qmax", "qmath", "full")
# stage codes of lmq_probe_attention_v2 (csrc/probes/attention_probe.cu)
_CODES = {"dots": 2, "softmax": 3, "full": 4, "qmax": 5, "qmath": 6, "masks": 7}


def make_inputs(batch: int, seed: int = 0, device=None):
    """(q, k codes, k scales, v codes, v scales, positions) as the TPU
    probe's ``make_inputs`` draws them (S = 256, float32 scales, every
    position filled): the same draws as ``aprobe.make_inputs``."""
    return aprobe.make_inputs(batch, S, seed, device)


def resident_masks(nh=NH, nkv=NKV, s_len=S, rep=REP, device=None):
    """(negb, posi), each [nh, S*nkv], as the TPU probe's ``call_v3`` makes
    them: negb float32, 0 on a row's own-head lanes (lane % nkv == row //
    rep), -1e9 elsewhere; posi int32, the position of the lane (lane //
    nkv)."""
    lane = torch.arange(s_len * nkv, device=device)
    row = torch.arange(nh, device=device)
    own = lane[None, :] % nkv == (row[:, None] // rep)
    negb = torch.where(own, 0.0, MASKED).to(torch.float32)
    posi = (lane // nkv).to(torch.int32).expand(nh, -1).contiguous()
    return negb.contiguous(), posi


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _block_max(p: torch.Tensor, bs: int) -> torch.Tensor:
    """Each element of p [..., S] replaced by the max of its aligned run of
    bs along the last axis (a short last run padded with zeros)."""
    s_len = p.shape[-1]
    nblk = -(-s_len // bs)
    pp = torch.nn.functional.pad(p, (0, nblk * bs - s_len)).reshape(*p.shape[:-1], nblk, bs)
    return pp.amax(-1, keepdim=True).expand_as(pp).reshape(*p.shape[:-1], nblk * bs)[..., :s_len]


def _probs_fn(stage: str, prob_q):
    """The map of the probabilities [b*nh, 1, S] after the softmax, bf16
    rounding included."""
    if stage == "softmax":
        return _bf16
    if stage == "qmax":
        return lambda p: _bf16(_block_max(p, prob_q[0]))
    return lambda p: _bf16(_prob_qdq_fn(QMATH_Q if stage == "qmath" else prob_q)(p))


def _own_lanes(m, nkv, rep):
    """The resident mask m [nh, S*nkv] at each row's own-head lanes ->
    [nkv, rep, S]."""
    nh = m.shape[0]
    rows = torch.arange(nh, device=m.device)
    return m.reshape(nh, -1, nkv)[rows, :, rows // rep].reshape(nkv, rep, -1)


def _check_stage(stage, name="attention_v2"):
    if stage not in STAGES:
        raise ValueError(f"{name}: unknown stage {stage!r} (one of {', '.join(STAGES)})")


def attention_v2_plain(q, k_codes, k_scales, v_codes, v_scales, positions, stage, bs_k=BSK,
                       bs_v=BSV, nkv=NKV, rep=REP, prob_q=PROB_Q, masks=None) -> torch.Tensor:
    """Plain version of P12: ``stage`` of decode attention over the pos-major
    cache (q [b, nh, hd]; codes [b, hd, S*nkv]; scales [b, hd/bs, S*nkv])
    with bf16 dots -> [b, nh, hd]; with ``masks`` (negb, posi), the
    own-head bias and the causal index read from them (P13)."""
    _check_stage(stage)
    if stage == "dots":
        return aprobe.attention_probe_plain(q, k_codes, k_scales, v_codes, v_scales, positions,
                                            "matmul", "bf16", bs_k, bs_v, nkv, rep, prob_q)
    kd = k_codes.float() * k_scales.repeat_interleave(bs_k, dim=1)
    vd = v_codes.float() * v_scales.repeat_interleave(bs_v, dim=1)
    if masks is not None:
        masks = tuple(_own_lanes(m, nkv, rep) for m in masks)
    return aprobe.attend_cache(_bf16(q), kd, vd, positions, _probs_fn(stage, prob_q), nkv, rep,
                               masks)


def attention_v3_plain(q, k_codes, k_scales, v_codes, v_scales, positions, negb, posi,
                       bs_k=BSK, bs_v=BSV, nkv=NKV, rep=REP, prob_q=PROB_Q) -> torch.Tensor:
    """Plain version of P13: ``full`` with the own-head bias and the causal
    index taken from the resident masks (negb, posi) -> [b, nh, hd]."""
    return attention_v2_plain(q, k_codes, k_scales, v_codes, v_scales, positions, "full", bs_k,
                              bs_v, nkv, rep, prob_q, masks=(negb, posi))


def _launch(name, code, q, kc, ks, vc, vs, positions, masks, bs_k, bs_v, nkv, rep, prob_q):
    s_len = aprobe.check_operands(name, q, kc, ks, vc, vs, nkv, rep,
                                  dense=code == _CODES["dots"], extra=masks or ())
    if prob_q is None:
        raise ValueError(f"{name}: the probes need the prob quantizer's block")
    b, nh, hd = q.shape
    if masks is not None:
        negb, posi = masks
        if (negb.dtype != torch.float32 or posi.dtype != torch.int32
                or negb.shape != (nh, s_len * nkv) or posi.shape != negb.shape):
            raise ValueError(f"{name}: negb float32 and posi int32 [{nh}, {s_len * nkv}] expected")
    pos = positions.to(device=q.device, dtype=torch.int32).reshape(b).contiguous()
    out = torch.empty_like(q)
    negb_ptr, posi_ptr = (masks[0].data_ptr(), masks[1].data_ptr()) if masks else (None, None)
    rc = _cuda.lib("probes").lmq_probe_attention_v2(
        q.data_ptr(), kc.data_ptr(), ks.data_ptr(), vc.data_ptr(), vs.data_ptr(),
        pos.data_ptr(), negb_ptr, posi_ptr, out.data_ptr(), b, nkv, rep, hd, s_len, bs_k, bs_v,
        math.sqrt(hd), *_prob_q_args(prob_q), code, _cuda.stream_ptr(q))
    _cuda.check(rc, name)
    return out


def attention_v2(q, k_codes, k_scales, v_codes, v_scales, positions, stage, bs_k=BSK, bs_v=BSV,
                 nkv=NKV, rep=REP, prob_q=PROB_Q) -> torch.Tensor:
    """The probe kernel P12: ``stage`` with bf16 dots. Launches the kernel
    for CUDA tensors (counting it in ``launches``), computes the plain
    version for CPU tensors."""
    if not q.is_cuda:
        return attention_v2_plain(q, k_codes, k_scales, v_codes, v_scales, positions, stage,
                                  bs_k, bs_v, nkv, rep, prob_q)
    _check_stage(stage)
    out = _launch("attention_v2", _CODES[stage], q, k_codes, k_scales, v_codes, v_scales,
                  positions, None, bs_k, bs_v, nkv, rep, prob_q)
    attention_v2.launches += 1
    return out


attention_v2.launches = 0


def attention_v3(q, k_codes, k_scales, v_codes, v_scales, positions, negb, posi, bs_k=BSK,
                 bs_v=BSV, nkv=NKV, rep=REP, prob_q=PROB_Q) -> torch.Tensor:
    """The probe kernel P13: ``full`` with resident masks. Launches the
    kernel for CUDA tensors (counting it in ``launches``), computes the
    plain version for CPU tensors."""
    if not q.is_cuda:
        return attention_v3_plain(q, k_codes, k_scales, v_codes, v_scales, positions, negb,
                                  posi, bs_k, bs_v, nkv, rep, prob_q)
    out = _launch("attention_v3", _CODES["masks"], q, k_codes, k_scales, v_codes, v_scales,
                  positions, (negb, posi), bs_k, bs_v, nkv, rep, prob_q)
    attention_v3.launches += 1
    return out


attention_v3.launches = 0


def run(batch=32, reps=5, device=None, seed=0, only="", log=print) -> dict:
    """Time K4, every P12 stage and P13 -> {"K4", "v2_<stage>" or
    "v3_masks": ms}, the labels holding ``only``. On the CPU, runs each
    plain version once and returns max|ctx| in place of the times."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    clock = SetupClock("k3", device)
    inputs = clock(lambda: make_inputs(batch, seed, device))
    q, kc, ks, vc, vs, pos = inputs
    masks = clock(lambda: resident_masks(device=device))
    nbytes = sum(t.numel() * t.element_size() for t in inputs[1:5])
    log(f"shape: b={batch} nh={NH} hd={HD} S={S} lanes={S * NKV} cache={nbytes / 1e6:.1f}MB "
        "(K4 dots in float32 on float32 q; the v2/v3 kernels in bf16, as the TPU's ship line)")
    calls = {"K4": lambda: packed_attention_decode_batch_cuda(
        q, kc, ks, vc, vs, pos, BSK, BSV, nkv=NKV, rep=REP, prob_q=PROB_Q)}
    for stage in STAGES:
        calls[f"v2_{stage}"] = lambda stage=stage: attention_v2(*inputs, stage)
    calls["v3_masks"] = lambda: attention_v3(*inputs, *masks)
    out = {}
    for label, fn in calls.items():
        if only and only not in label:
            continue
        if not on_card:
            out[label] = fn().abs().max().item()
            log(f"{label:>12s}: max|ctx| {out[label]:.6g} (plain version, cpu)")
            continue
        ms = out[label] = chain_ms([fn], reps=reps)
        log(f"{label:>12s}: {ms * 1e3:8.1f} us  {ms * 1e3 / batch:6.2f} us/elem")
    clock.log(log)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5, help="timed chains of 100 calls")
    ap.add_argument("--only", default="", help="run the labels that hold this")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.batch, args.reps, args.device, only=args.only)


if __name__ == "__main__":
    main()
