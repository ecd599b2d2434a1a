"""The plain references against the port at tiny sizes on the CPU, and the
control (the reference in bfloat16) against the limits."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.families import llama as fam_llama, opt as fam_opt
from benchmark.harness import run_cell
from benchmark.reference import quant
from benchmark.reference.llama import served_logits
from benchmark.reference.opt import sequence_losses

BENCH = Path(__file__).resolve().parent.parent
QUANT = json.loads((BENCH / "configs" / "mistral-7b.json").read_text())["quant"]
TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
        "rms_norm_eps": 1e-5, "rope_theta": 1e6, "initializer_range": 0.02,
        "max_position_embeddings": 256, "bos_token_id": 1, "eos_token_id": 2,
        "tie_word_embeddings": False}
TINY_OPT = {"hidden_size": 64, "ffn_dim": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
            "vocab_size": 256, "max_position_embeddings": 128, "init_std": 0.02,
            "do_layer_norm_before": True, "activation_function": "relu"}


def _x(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3
    x[..., :16] = 0.0  # a zero block
    x[..., 17] = 1e-9  # passes through
    x[..., 20] = 2.0**-3  # a power of two at the block max
    return x


def test_bfp_matches_the_port():
    from llm_mixed_q_torch.kernels.packing import bfp_encode_lastdim
    from llm_mixed_q_torch.ops.quantizers.block_fp import _block_fp_qdq
    from llm_mixed_q_torch.ops.quantizers.integer import _integer_qdq

    x = _x(8, 96)
    want = _block_fp_qdq(x, 6, 8, 127, [1, 16], skip_first_dim=True)
    assert torch.equal(quant.bfp(x, 6, 8, 127, 16), want)
    codes, scales = bfp_encode_lastdim(x, 6, 8, 127, 16)
    got_c, got_s = quant.bfp_codes(x, 6, 8, 127, 16)
    assert torch.equal(got_c, codes)
    # a zero block's scale differs (the port fills it from its neighbours)
    # and multiplies only zero codes
    stored = codes.float().reshape(8, 6, 16) * scales[..., None]
    assert torch.equal(quant.bfp_stored(x, 6, 8, 127, 16), stored.reshape(8, 96))
    t = torch.linspace(-1.2, 1.2, 1001)
    assert torch.equal(quant.fixed(t, 8, 7), _integer_qdq(t, 8, 7))


def _port_llama(dims, seed, bf16_embed=True):
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig
    from llm_mixed_q_torch.models.llama.pack import pack_llama_params

    keys = ("vocab_size hidden_size intermediate_size num_hidden_layers num_attention_heads "
            "num_key_value_heads max_position_embeddings rms_norm_eps rope_theta").split()
    cfg = LlamaQuantizedConfig(**{k: dims[k] for k in keys}, quant_config=QUANT)
    top = fam_llama.program_top(fam_llama.top(dims, seed, "cpu"))
    layers = [fam_llama.program_layer(fam_llama.layer(dims, seed, i, "cpu"))
              for i in range(dims["num_hidden_layers"])]
    return cfg, pack_llama_params({**top, "layers": layers}, cfg, bf16_embed=bf16_embed,
                                  device="cpu")


def test_llama_reference_follows_the_served_path():
    """Prefill (bucket-padded prompts) and decode steps on the packed cache:
    the reference's logits equal the port's."""
    from llm_mixed_q_torch.models.llama.serving import (decode_step, init_packed_kv_cache,
                                                        kv_cache_pack_spec, prefill_into_cache)

    seed, max_len, bucket = 5, 64, 32
    cfg, params = _port_llama(TINY, seed)
    prompts = [[3, 9, 27, 81, 243, 17, 5], list(range(40, 60))]
    ids = torch.zeros((2, bucket), dtype=torch.int64)
    mask = torch.zeros((2, bucket), dtype=torch.int64)
    mask[:, 0] = 1
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.as_tensor(p)
        mask[i, :len(p)] = 1
    cache = init_packed_kv_cache(cfg, 2, max_len, kv_cache_pack_spec(cfg), "cpu")
    tmp = init_packed_kv_cache(cfg, 2, bucket, kv_cache_pack_spec(cfg), "cpu", cache.pos_major)
    logits, lengths = prefill_into_cache(params, ids, mask, tmp, cfg)
    for bufs, news in zip(cache[:4], tmp[:4]):
        for buf, new in zip(bufs, news):
            buf[:, :, :new.shape[2]] = new
    tokens = [[int(logits[i].argmax())] for i in range(2)]
    pos = lengths.clone()
    for _ in range(5):
        last = torch.as_tensor([t[-1] for t in tokens])
        step = decode_step(params, last[:, None], cache, pos, cfg)
        for i in range(2):
            tokens[i].append(int(step[i].argmax()))
        pos = pos + 1

    got = served_logits(TINY, QUANT, fam_llama.top(TINY, seed, "cpu"),
                        lambda i: fam_llama.layer(TINY, seed, i, "cpu"), "cpu", max_len,
                        [{"prompt": p, "tokens": t, "bucket": bucket}
                         for p, t in zip(prompts, tokens)])
    for i in range(2):
        assert torch.equal(got[i][0], logits[i])
        served = torch.as_tensor(tokens[i])
        assert torch.equal(got[i].argmax(-1), served)


def _port_opt(dims, seed):
    from llm_mixed_q_torch.models.api import make_forward
    from llm_mixed_q_torch.models.opt import OPTQuantizedConfig
    from llm_mixed_q_torch.models.opt.prepare import quantize_opt_params_ptq

    cfg = OPTQuantizedConfig(**{k: dims[k] for k in ("hidden_size", "ffn_dim", "num_hidden_layers",
                                                     "num_attention_heads", "vocab_size",
                                                     "max_position_embeddings")},
                             quant_config=QUANT)
    params = {**fam_opt.program_top(fam_opt.top(dims, seed, "cpu")),
              "layers": [fam_opt.program_layer(fam_opt.layer(dims, seed, i, "cpu"))
                         for i in range(dims["num_hidden_layers"])]}
    params = quantize_opt_params_ptq(params, cfg)
    return make_forward("opt", "lm", cfg, quantize_weights=False, with_labels=True), params


def test_opt_reference_loss_equals_the_port():
    seed = 9
    fwd, params = _port_opt(TINY_OPT, seed)
    seqs = [torch.as_tensor(np.random.default_rng(i).integers(0, 256, 48)) for i in range(2)]
    want = sequence_losses(TINY_OPT, QUANT, fam_opt.top(TINY_OPT, seed, "cpu"),
                           lambda i: fam_opt.layer(TINY_OPT, seed, i, "cpu"), "cpu", seqs)
    for s, w in zip(seqs, want):
        ids = s[None]
        got = float(fwd(params, ids, torch.ones_like(ids), ids)["loss"])
        assert got == w


@pytest.mark.parametrize("workload,key", [("tiny.offline", "request_mean_gap"),
                                          ("tiny.ppl", "max_loss_gap")])
def test_control_fails_where_the_program_passes(tiny_bench, workload, key):
    """The reference in bfloat16 in the program's place, through the same
    limits and rule, comes out not correct; the program comes out correct."""
    bench, bench_json = tiny_bench
    out = run_cell(workload, 2**31 + 3, 3.0, False, "cpu", time.perf_counter(),
                   bench_dir=bench, bench_json=bench_json, controls=("bf16",),
                   log=lambda *a: None)
    assert out["correct"]
    control = out["controls"]["bf16"]
    assert not control["correct"]
    assert control["checks"][key]["value"] > control["checks"][key]["limit"]
