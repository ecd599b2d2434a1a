"""The metric arithmetic against hand-worked cases."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark import roofline, trace
from benchmark.harness import Record, Request, card_peaks, eval_metrics, load_reader, serve_metrics

MISTRAL = {"hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
           "num_attention_heads": 32, "num_key_value_heads": 8, "vocab_size": 32768}
PEAKS = (3.35e12, 67e12, 989e12)


def _rec(**kw):
    rec = Record("w", "llama", MISTRAL, {"batcher": {"num_slots": 8}, "seq_len": 2048})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_rates_and_p95_over_the_window():
    a = Request(prompt=[1], times=[0.1, 0.3, 0.6, 1.0])
    b = Request(prompt=[1], times=[0.2, 0.25])
    rec = _rec(window_s=2.0, requests=[a, b],
               steps=[{"new_tokens": 4}, {"new_tokens": 2}])
    out = serve_metrics(rec)
    assert out["decode_tok_s"] == pytest.approx(3.0)
    gaps = [0.2, 0.3, 0.4, 0.05]
    assert out["itl_p95_ms"] == pytest.approx(float(np.percentile(gaps, 95)) * 1e3)
    # four gaps: p95 lies 0.85 of the way from the third to the fourth smallest
    assert out["itl_p95_ms"] == pytest.approx((0.3 + 0.85 * 0.1) * 1e3)
    ev = _rec(window_s=4.0, batches=[(0, 1, 2048), (1, 2, 2048)])
    assert eval_metrics(ev)["eval_tok_s"] == pytest.approx(1024.0)


def test_k2_bound_by_hand():
    # M = 8, N = K = 4096: codes 16 MiB, scales 4 MiB, x and y 256 KiB
    nbytes = 4096 * 4096 + 4 * 4096 * 256 + 4 * 8 * 8192
    assert nbytes == 21_233_664
    assert roofline.k2_bound_s(8, 4096, 4096, PEAKS) == pytest.approx(nbytes / 3.35e12)
    # at M = 4096 the operations bound: 2 * 4096^3 over the bf16 peak
    assert roofline.k2_bound_s(4096, 4096, 4096, PEAKS) == pytest.approx(2 * 4096**3 / 989e12)


def test_attention_bytes_and_flops_by_hand():
    # 8 kv heads x (K and V codes 2 x 128 B + scales 2 x 8 x 4 B) = 2560 B a position
    assert roofline.attn_bytes(100, 1, MISTRAL) == 100 * 2560 + 32 * 128 * 8 + 4
    assert roofline.attn_flops(100, MISTRAL) == 4 * 128 * 32 * 100


def test_model_flops_by_hand():
    lin = 4096 * (4096 + 2048 + 4096) + 3 * 4096 * 14336
    assert roofline.linear_params(MISTRAL, "llama") == lin
    step = {"prompt_tokens": 3, "prompt_sq": 6, "admitted": 1, "row_steps": 2, "filled": 9}
    head = 2 * 4096 * 32768
    want = (3 * 32 * 2 * lin + 32 * 4 * 128 * 32 * 6 + head
            + 2 * (32 * 2 * lin + head) + 32 * 4 * 128 * 32 * 9)
    assert roofline.model_flops_serve([step], MISTRAL) == pytest.approx(want)
    opt = {"hidden_size": 8, "ffn_dim": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
           "vocab_size": 10}
    seq = 4
    want = seq * (2 * 2 * (4 * 64 + 2 * 8 * 16) + 2 * 8 * 10) + 2 * 4 * 4 * 2 * 10
    assert roofline.model_flops_eval(8, seq, opt, "opt") == pytest.approx(2 * want)


def test_card_peaks():
    assert card_peaks("NVIDIA H100 80GB HBM3") == PEAKS
    assert card_peaks("NVIDIA H100 PCIe")[0] == 2.0e12


def test_busy_idle_and_spans():
    events = [("a", 0.1, 0.2), ("b", 0.2, 0.2), ("c", 0.6, 0.1), ("Memcpy HtoD", 0.9, 0.05)]
    assert trace.busy_intervals(events) == [[0.1, pytest.approx(0.4)], [0.6, pytest.approx(0.7)],
                                            [0.9, pytest.approx(0.95)]]
    assert trace.busy_s(events) == pytest.approx(0.45)
    gaps = trace.idle_gaps(events, 1.0)
    assert [g[0] for g in gaps] == pytest.approx([0.0, 0.4, 0.7, 0.95])
    assert sum(g[1] for g in gaps) == pytest.approx(0.55)
    spans = [("step.admit", 0.0, 0.5), ("step.decode", 0.5, 0.8)]
    assert trace.span_at(spans, 0.4) == "step.admit"
    assert trace.span_at(spans, 0.7) == "step.decode"
    assert trace.span_at(spans, 0.9) == "host"
    bd = trace.breakdown(events, spans, 1.0)
    assert bd["device_ops"][0][0] == "a"
    # gaps [0, 0.1) and [0.4, 0.6) start in step.admit, [0.7, 0.9) in
    # step.decode, [0.95, 1) between spans
    assert dict(bd["idle_gaps"]) == pytest.approx({"step.admit": 0.3, "step.decode": 0.2,
                                                   "host": 0.05})
    assert len(trace.kernels(events)) == 3


def _steps():
    return [
        {"start": 0.0, "end": 1.0, "admitted": 8, "decode_steps": 2, "row_steps": 16,
         "filled": 16 * 40, "prompt_tokens": 8 * 30, "prompt_sq": 8 * 465, "new_tokens": 24},
        {"start": 1.0, "end": 1.2, "admitted": 0, "decode_steps": 2, "row_steps": 16,
         "filled": 16 * 42, "prompt_tokens": 0, "prompt_sq": 0, "new_tokens": 16},
        {"start": 1.2, "end": 1.4, "admitted": 0, "decode_steps": 2, "row_steps": 16,
         "filled": 16 * 44, "prompt_tokens": 0, "prompt_sq": 0, "new_tokens": 16},
    ]


def test_serving_readers():
    rec = _rec(window_s=1.4, steps=_steps())
    assert load_reader("step_ms.decode")(rec) == pytest.approx(100.0)
    # the admitting call less its 2 decode steps at 100 ms
    assert load_reader("admit_ms.offline")(rec) == pytest.approx(800.0)
    # no trace: the trace's readers find nothing to read
    for name in ("launches_per_step", "k2_roofline", "attn_roofline", "idle_share.serve"):
        assert load_reader(name)(rec) is None
    kernel = lambda name, t, d: (name, t, d)
    events = ([kernel("void int8_kernel<1>", 1.0 + 0.01 * i, 0.001) for i in range(10)]
              + [kernel("actq_split_kernel", 1.3 + 0.001 * i, 0.0001) for i in range(10)]
              + [kernel("k4_scores_kernel", 0.5, 0.002), kernel("Memset", 1.25, 0.01)])
    rec.events = events
    assert load_reader("launches_per_step")(rec) == pytest.approx(20 / 4)
    t_k2 = 10 * 0.001 + 10 * 0.0001
    per_step = sum(roofline.k2_bound_s(8, n, k, PEAKS) for n, k in roofline.llama_linears(MISTRAL))
    assert load_reader("k2_roofline")(rec) == pytest.approx(100 * 6 * 32 * per_step / t_k2)
    filled, rows = 16 * (40 + 42 + 44), 48
    want = 32 * roofline.attn_bytes(filled, rows, MISTRAL) / 3.35e12
    assert load_reader("attn_roofline")(rec) == pytest.approx(100 * want / 0.002)
    busy = trace.busy_s(events)
    assert load_reader("idle_share.serve")(rec) == pytest.approx(100 * (1 - busy / 1.4))
    flops = roofline.model_flops_serve(rec.steps, MISTRAL)
    assert load_reader("mfu.serve")(rec) == pytest.approx(100 * flops / (1.4 * 989e12))


def test_eval_readers():
    rec = _rec(window_s=2.0, batches=[(0.0, 1.0, 2048)], family="opt",
               dims={"hidden_size": 64, "ffn_dim": 128, "num_hidden_layers": 2,
                     "num_attention_heads": 4, "vocab_size": 256})
    rec.events = [("nvjet_tst_128x256_h_bz_NNT", 0.0, 0.3), ("vectorized_elementwise_kernel", 0.3, 0.6),
                  ("sm90_xmma_gemm_f32f32", 0.9, 0.1)]
    assert load_reader("nongemm_share.eval")(rec) == pytest.approx(60.0)
    assert load_reader("idle_share.eval")(rec) == pytest.approx(50.0)
    flops = roofline.model_flops_eval(2048, 2048, rec.dims, "opt")
    assert load_reader("mfu.eval")(rec) == pytest.approx(100 * flops / (2.0 * 989e12))
    rec.events = []
    assert load_reader("nongemm_share.eval")(rec) is None
    assert math.isfinite(load_reader("mfu.eval")(rec))
