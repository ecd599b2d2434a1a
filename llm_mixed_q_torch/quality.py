"""Quality gate of the port: perplexity delta + per-node SQNR, offline
(counterpart of the repo's ``quality.py``).

BASELINE.md's quality gate is "W6A6 BFP Llama-7B <= 0.1 ppl delta vs fp32 on
Wikitext2". With no checkpoint or corpus on the machine, the harness runs
the Wikitext2 protocol (fixed-seq-len chunks, ppl = exp(sum loss*bs*L /
(L*N))) on a deterministic synthetic Markov corpus with a tiny Llama
trained in float32 on it, then evaluates the same weights under:

  - fp32 (bypass)           — the baseline
  - W8A8 integer            — frac widths calibrated from a stat profile
  - W6A6 BFP fake-quant     — the headline config (bfp_6bit.toml)
  - W4A4 BFP fake-quant     — the aggressive config
  - W6A6 BFP packed         — int8 codes + ``bfp_matmul``; its delta vs the
                              W6A6 fake path isolates packed-storage numerics

plus per-node SQNR (10*log10(||y_fp32||^2 / ||y_fp32 - y_q||^2)) of every
quantized linear's output on one batch, all seven arithmetics, the
Section 4.3 W4A4 QAT recovery, OPT and BERT arms, and with ``--seven-b`` a
Llama-2-7B-width arm: weight SQNR and pack mismatches on the CPU, the
fake-quant logit oracle on the CPU, then on the device the packed forward
and the teacher-forced per-layer parity at layers 0, 15 and 31 (at 2 x 64
rows the packed linears run the fused int8 matmul, K2 on the card).

    python -m llm_mixed_q_torch.quality [--out QUALITY.json] [--steps 300]
        [--seven-b] [--device cpu]

Runs on the card unless ``--device cpu``; TOML paths resolve from the repo
root. Writes the JSON report (the JAX script's keys) and prints one summary
line per config.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .eval.eval_lm import _first_tensor
from .models.hf_loader import tree_map_tensors
from .train.qat import _optax_adamw, _trainable

ROOT = Path(__file__).resolve().parent.parent

VOCAB = 512
SEQ = 128
HIDDEN, INTER, LAYERS, HEADS = 256, 704, 4, 4
# the 7B-shape arm's model (Llama-2-7B widths)
_SEVEN_B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                num_hidden_layers=32, num_attention_heads=32, max_position_embeddings=2048)
_SEVEN_B_LAYERS = (0, 15, 31)  # first / middle / last layer


def synthetic_corpus(n_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic order-1 Markov corpus with skewed transitions — enough
    structure that a trained LM reaches ppl far below vocab size."""
    rng = np.random.default_rng(seed)
    # sparse row-stochastic transition matrix: each token has 8 likely successors
    succ = rng.integers(0, VOCAB, size=(VOCAB, 8))
    probs = rng.dirichlet(np.full(8, 0.4), size=VOCAB)
    toks = np.empty(n_tokens, dtype=np.int32)
    toks[0] = 0
    draws = rng.random(n_tokens)
    cum = np.cumsum(probs, axis=1)
    for i in range(1, n_tokens):
        row = toks[i - 1]
        c = int((draws[i] > cum[row]).sum())
        toks[i] = succ[row, min(c, 7)]
    return toks


def chunk_batches(tokens: np.ndarray, batch: int):
    n = len(tokens) // SEQ
    ids = tokens[: n * SEQ].reshape(n, SEQ)
    for i in range(0, n - batch + 1, batch):
        chunk = ids[i : i + batch]
        yield {
            "input_ids": chunk,
            "attention_mask": np.ones_like(chunk),
            "labels": chunk,
        }


def quant_cfg(name: str):
    from .utils.toml_io import load_config

    if name == "fp32":
        return None
    path = {
        "w6a6_bfp": "configs/quantization/bfp_6bit.toml",
        "w4a4_bfp": "configs/quantization/bfp_4bit.toml",
    }[name]
    return load_config(ROOT / path)


def calibrated_int8_config(params, fp32_config, calib_tokens):
    """W8A8 integer config with frac widths derived from an activation stat
    profile (the llm.int8-style calibrated baseline; the reference's
    stat_profile_to_quant_config.py pipeline)."""
    from .config import transform_stat_profile_to_int_quant_config
    from .models.llama import (
        format_stat_profiled_int_config_llama_quantized,
        llama_for_causal_lm,
        parse_llama_quantized_config,
    )
    from .stats.profiler import profile_statistics

    batches = list(chunk_batches(calib_tokens, 4))[:4]
    profile = profile_statistics(
        batches=batches, arch="llama", model_fn=llama_for_causal_lm,
        config=fp32_config, params=params,
    )
    qc = transform_stat_profile_to_int_quant_config(profile, "range_min_max", width=8)
    qc = format_stat_profiled_int_config_llama_quantized(qc, LAYERS)
    return parse_llama_quantized_config(qc, LAYERS, strict=False)


def build_model(qname: str):
    from .models.llama import LlamaQuantizedConfig

    return LlamaQuantizedConfig(
        vocab_size=VOCAB,
        hidden_size=HIDDEN,
        intermediate_size=INTER,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        max_position_embeddings=SEQ,
        quant_config=quant_cfg(qname),
    )


def _detached(params):
    return tree_map_tensors(lambda t: t.detach(), params)


def _train(loss_fn, params, steps: int, draw):
    """``steps`` updates of optax's ``adamw(3e-4)`` on ``loss_fn(params,
    *draw())`` -> (the trained tree, detached; the last step's loss)."""
    params = _trainable(params)
    opt = _optax_adamw(params, 3e-4)
    loss = None
    for _ in range(steps):
        loss = loss_fn(params, *draw())
        loss.backward()
        opt.step()
    return _detached(params), loss.detach()


def train_fp32(params, config, corpus, steps: int, batch: int = 8):
    from .models.llama import llama_for_causal_lm

    device = _first_tensor(params).device
    n = len(corpus) // SEQ
    ids_all = corpus[: n * SEQ].reshape(n, SEQ)
    rng = np.random.default_rng(1)

    def draw():
        rows = rng.integers(0, n, size=batch)
        return (torch.as_tensor(ids_all[rows], dtype=torch.int64, device=device),)

    def loss_fn(p, ids):
        return llama_for_causal_lm(p, ids, torch.ones_like(ids), labels=ids, config=config,
                                   quantize_weights=False)["loss"]

    params, loss = _train(loss_fn, params, steps, draw)
    return params, float(loss)


def eval_ppl(params, config, test_tokens, quantize_weights: bool):
    from .eval.eval_lm import eval_lm_wikitext2
    from .models.llama import llama_for_causal_lm

    def fwd(p, ids, mask, labels):
        return llama_for_causal_lm(p, ids, mask, labels=labels, config=config,
                                   quantize_weights=quantize_weights)

    return eval_lm_wikitext2(fwd, params, chunk_batches(test_tokens, 4))


def node_sqnr(params, fp32_config, q_config, test_tokens):
    """Per-quantized-linear SQNR (dB) of node outputs, quantized vs fp32
    forward on one batch, via the tap collector."""
    from .models.llama import llama_for_causal_lm
    from .ops.linear import capture_quant_node_taps

    batch = next(chunk_batches(test_tokens, 2))
    ids = torch.as_tensor(batch["input_ids"], dtype=torch.int64,
                          device=_first_tensor(params).device)
    mask = torch.ones_like(ids)

    class Collector:
        def __init__(self):
            self.outs = {}

        def on_linear(self, name, x, w, b, out):
            self.outs[name] = out.detach().cpu().numpy()

    def run(config, qw):
        c = Collector()
        with torch.no_grad(), capture_quant_node_taps(c):
            llama_for_causal_lm(params, ids, mask, config=config, quantize_weights=qw)
        return c.outs

    ref = run(fp32_config, False)
    qout = run(q_config, True)
    table = {}
    for name, y in ref.items():
        if name not in qout:
            continue
        err = float(np.sum((y - qout[name]) ** 2))
        sig = float(np.sum(y**2))
        table[name] = round(10 * math.log10(sig / err), 2) if err > 0 else float("inf")
    return table


# The reference's uniform PTQ configs: all 7 quantizer arithmetics
ARITH_TOMLS = {
    "integer": "configs/quantization/integer.toml",
    "log": "configs/quantization/log.toml",
    "minifloat_ieee": "configs/quantization/minifloat_ieee.toml",
    "minifloat_denorm": "configs/quantization/minifloat_denorm.toml",
    "block_fp_w6": "configs/quantization/bfp_6bit.toml",
    "block_minifloat": "configs/quantization/block_minifloat.toml",
    "block_log": "configs/quantization/block_log.toml",
}


def _sqnr_db(w, qw) -> float:
    """10 log10(||w||^2 / ||w - qw||^2) of one weight, float32 sums."""
    err = float(torch.sum((w - qw) ** 2))
    sig = float(torch.sum(w**2))
    return 10 * math.log10(sig / max(err, 1e-30))


def eval_all_ariths(params, base_ppl, test_toks):
    """Per-arith ppl delta table over the reference's uniform PTQ configs."""
    from .models.llama import LlamaQuantizedConfig
    from .ops.quantizers import QUANTIZER_MAP
    from .utils.toml_io import load_config

    table = {}
    for name, path in ARITH_TOMLS.items():
        cfg = LlamaQuantizedConfig(
            vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
            num_hidden_layers=LAYERS, num_attention_heads=HEADS,
            max_position_embeddings=SEQ, quant_config=load_config(ROOT / path),
        )
        r = eval_ppl(params, cfg, test_toks, quantize_weights=True)
        table[name] = {
            "ppl": round(r["perplexity"], 4),
            "delta_vs_fp32": round(r["perplexity"] - base_ppl, 4),
        }
        print(f"arith {name}: ppl {r['perplexity']:.4f} "
              f"(delta {r['perplexity'] - base_ppl:+.4f})")

    # The block_minifloat blowup is the reference's own semantics: its
    # shared exponent bias clamps to >= 0 (block_minifloat.py:77-79), so a
    # block whose max is < 1.0 (every typical weight block) quantizes
    # against a grid that underflows small weights. The weight SQNR of one
    # real weight tensor shows it.
    w = params["layers"][0]["self_attn"]["q_proj"]["weight"]
    with torch.no_grad():
        qw = QUANTIZER_MAP["block_minifloat"](
            w, width=8, exponent_width=4, exponent_bias_width=8,
            block_size=[1, 16], skip_first_dim=True,
        )
    table["block_minifloat"]["weight_sqnr_db"] = round(_sqnr_db(w, qw), 2)
    table["block_minifloat"]["note"] = (
        "reference semantics: shared exponent bias clamps to >= 0 "
        "(reference block_minifloat.py:77-79), so blocks with max < 1.0 "
        "(all typical weights) quantize against a grid anchored at "
        "magnitude >= ~2^-6 — the ppl blowup reproduces the reference "
        "emulation bit-for-bit (tests/test_quantizers_parity.py), it is "
        "not an e2e misconfiguration"
    )
    return table


def qat_recover_w4a4(params, train_toks, test_toks, base_ppl, steps=150):
    """The paper's Section 4.3 claim, offline: W4A4 BFP is lossy PTQ, QAT
    fine-tuning recovers most of the delta (reference
    experiments/emnlp/section_4.3/opt_350m_sst2.sh). Returns before/after
    deltas."""
    from .train.qat import MultiSteps, make_adamw, make_qat_train_step

    cfg4 = build_model("w4a4_bfp")
    before = eval_ppl(params, cfg4, test_toks, quantize_weights=True)

    qp = _trainable(params)
    optimizer = MultiSteps(*make_adamw(qp, 1e-4, total_steps=steps, schedule="linear"))
    step = make_qat_train_step("llama", "lm", cfg4, optimizer)
    device = _first_tensor(params).device
    n = len(train_toks) // SEQ
    ids_all = train_toks[: n * SEQ].reshape(n, SEQ)
    rng = np.random.default_rng(7)
    for _ in range(steps):
        rows = rng.integers(0, n, size=8)
        ids = torch.as_tensor(ids_all[rows], dtype=torch.int64, device=device)
        step(qp, {"input_ids": ids, "attention_mask": torch.ones_like(ids), "labels": ids})
    after = eval_ppl(_detached(qp), cfg4, test_toks, quantize_weights=True)
    out = {
        "ppl_before_qat": round(before["perplexity"], 4),
        "ppl_after_qat": round(after["perplexity"], 4),
        "delta_before": round(before["perplexity"] - base_ppl, 4),
        "delta_after": round(after["perplexity"] - base_ppl, 4),
        "qat_steps": steps,
    }
    print(f"w4a4 QAT recovery: delta {out['delta_before']:+.4f} -> "
          f"{out['delta_after']:+.4f} after {steps} steps")
    return out


def opt_arm(corpus, steps, hidden=128, ffn=352, device=None):
    """OPT-architecture quality arm: same Markov corpus, tiny OPT trained
    fp32, W6A6 BFP PTQ delta. At hidden=128 a [1,16] block covers 1/8 of
    the fan-in, so the 0.1 Llama-7B gate does not transfer; main() runs a
    second point at hidden=256."""
    from .eval.eval_lm import eval_lm_wikitext2
    from .models.hf_loader import init_opt_params
    from .models.opt import OPTQuantizedConfig, opt_for_causal_lm
    from .utils.toml_io import load_config

    device = resolve_device(device)
    kw = dict(
        vocab_size=VOCAB, hidden_size=hidden, num_hidden_layers=2,
        ffn_dim=ffn, num_attention_heads=4, max_position_embeddings=SEQ,
    )
    cfg = OPTQuantizedConfig(**kw, quant_config=None)
    params = init_opt_params(cfg, task="lm", seed=0, device=device)

    train, test = corpus[: 320 * SEQ], corpus[320 * SEQ :]
    n = len(train) // SEQ
    ids_all = train[: n * SEQ].reshape(n, SEQ)
    rng = np.random.default_rng(1)

    def draw():
        rows = rng.integers(0, n, size=8)
        return (torch.as_tensor(ids_all[rows], dtype=torch.int64, device=device),)

    def loss_fn(p, ids):
        return opt_for_causal_lm(p, ids, torch.ones_like(ids), labels=ids, config=cfg,
                                 quantize_weights=False)["loss"]

    params, _ = _train(loss_fn, params, steps, draw)

    def ppl_of(config, qw):
        def fwd(p, ids, mask, labels):
            return opt_for_causal_lm(p, ids, mask, labels=labels, config=config,
                                     quantize_weights=qw)

        return eval_lm_wikitext2(fwd, params, chunk_batches(test, 4))

    base = ppl_of(cfg, False)["perplexity"]
    qcfg = OPTQuantizedConfig(
        **kw, quant_config=load_config(ROOT / "configs/quantization/bfp_6bit.toml")
    )
    q = ppl_of(qcfg, True)["perplexity"]
    print(f"opt arm: fp32 ppl {base:.4f}, w6a6 delta {q - base:+.4f}")
    return {
        "fp32_ppl": round(base, 4),
        "w6a6_bfp_ppl": round(q, 4),
        "delta_vs_fp32": round(q - base, 4),
    }


def bert_arm(steps, device=None):
    """BERT-architecture quality arm: tiny BERT trained fp32 to memorize a
    synthetic classification set; W6A6 BFP PTQ accuracy delta on the
    memorized set (offline stand-in for the reference's GLUE evals)."""
    from .datasets import make_synthetic_cls_dataset
    from .models.bert import BertQuantizedConfig, bert_for_sequence_classification
    from .models.hf_loader import init_bert_params
    from .utils.toml_io import load_config

    device = resolve_device(device)
    kw = dict(
        vocab_size=VOCAB, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=352,
        max_position_embeddings=64, num_labels=2,
    )
    cfg = BertQuantizedConfig(**kw, quant_config=None)
    params = init_bert_params(cfg, task="cls", seed=0, device=device)
    data = make_synthetic_cls_dataset(VOCAB, 32, 128, seed=3)
    ids, mask, labels = (torch.as_tensor(data[k], dtype=torch.int64, device=device)
                         for k in ("input_ids", "attention_mask", "labels"))
    rng = np.random.default_rng(2)

    def draw():
        rows = torch.as_tensor(rng.integers(0, ids.shape[0], size=16), device=device)
        return ids[rows], mask[rows], labels[rows]

    def loss_fn(p, i, m, y):
        return bert_for_sequence_classification(p, i, m, labels=y, config=cfg,
                                                quantize_weights=False)["loss"]

    params, _ = _train(loss_fn, params, steps, draw)

    @torch.no_grad()
    def acc_of(config, qw):
        logits = bert_for_sequence_classification(params, ids, mask, config=config,
                                                  quantize_weights=qw)["logits"]
        return float((logits.argmax(-1) == labels).float().mean())

    base = acc_of(cfg, False)
    qcfg = BertQuantizedConfig(
        **kw, quant_config=load_config(ROOT / "configs/quantization/bfp_6bit.toml")
    )
    q = acc_of(qcfg, True)
    print(f"bert arm: fp32 acc {base:.4f}, w6a6 delta {q - base:+.4f}")
    return {
        "fp32_acc": round(base, 4),
        "w6a6_bfp_acc": round(q, 4),
        "delta_vs_fp32": round(q - base, 4),
    }


_ATTN, _MLP = ("q_proj", "k_proj", "v_proj", "o_proj"), ("gate_proj", "up_proj", "down_proj")


@torch.no_grad()
def _seven_b_weights(params, cfg, layers) -> dict:
    """The 7B arm's part (a), on the CPU: the W6A6 BFP weight SQNR of each
    node type at ``layers`` and the elements where unpack(pack(w)) !=
    qdq(w)."""
    from .kernels.packing import pack_block_fp, unpack_block_fp
    from .ops.linear import quantize_weight

    node_cfg = cfg.quant_config["model_layer_0"]
    sqnr_acc: dict[str, list] = {}
    mism = 0
    for li in layers:
        layer = params["layers"][li]
        for group, names in (("self_attn", _ATTN), ("mlp", _MLP)):
            for name in names:
                w = layer[group][name]["weight"].cpu()
                ncfg = node_cfg[group][name]
                qw = quantize_weight(w, ncfg)
                sqnr_acc.setdefault(name, []).append(round(_sqnr_db(w, qw), 2))
                p = pack_block_fp(
                    w, ncfg["weight_width"], ncfg.get("weight_exponent_width", 8),
                    ncfg.get("weight_exponent_bias"), [1, 16],
                )
                mism += int(torch.sum(unpack_block_fp(p) != qw))
    return {
        "shape": {"hidden": cfg.hidden_size, "layers": cfg.num_hidden_layers,
                  "vocab": cfg.vocab_size},
        "weight_sqnr_db_by_node": {
            k: {"per_layer_0_15_31": v, "mean": round(float(np.mean(v)), 2)}
            for k, v in sqnr_acc.items()
        },
        "packed_vs_fake_weight_mismatches": mism,
        "note_mismatches": "elements where unpack(pack(w)) != qdq(w); only "
        "the documented |w|<=1e-8 zero-grid deviation can appear here",
    }


def _pair(a, b, rms) -> dict:
    """max and mean |a - b| over the reference RMS ``rms``."""
    d = np.abs(a - b)
    return {
        "max_abs_over_ref_rms": round(float(d.max()) / rms, 6),
        "mean_abs_over_ref_rms": round(float(d.mean()) / rms, 8),
    }


@torch.no_grad()
def _seven_b_per_layer(layer_params: dict, cfg, device, batch=2, seq=64) -> dict:
    """Teacher-forced per-layer parity: each layer of ``layer_params``
    {index: layer tree on the CPU} takes the same input (numpy seed 1, x
    0.5) as the fake-quant oracle on the CPU, as a packed layer on
    ``device`` (``pack_linear_node(subbyte=False, host=True)``: int8 codes,
    the fused int8 matmul at batch x seq rows) and as the weights
    fake-quantized on ``device`` (the quantizers give the CPU's bits on
    the card). Each pair's max and mean |diff| over the
    reference RMS; packed-vs-device-fake isolates packed storage and the
    fused kernel (the device's matmul precision common-mode).
    -> {"layer_<i>": {...}}"""
    from .models.llama.modeling import decoder_layer, make_causal_mask, rope_tables
    from .models.pack_common import pack_linear_node
    from .ops.linear import quantize_weight

    node_cfg = cfg.quant_config["model_layer_0"]
    rng2 = np.random.default_rng(1)
    h_in = torch.from_numpy(
        rng2.standard_normal((batch, seq, cfg.hidden_size), np.float32) * 0.5)
    mask = torch.ones((batch, seq), dtype=torch.int64)
    pos = torch.arange(seq)[None, :].repeat(batch, 1)

    def layer_fn(dev):
        mask_f = make_causal_mask(mask.to(dev), seq, seq, device=dev)
        cos, sin = rope_tables(seq, cfg.head_dim, cfg.rope_theta, dev)
        return lambda li, p, qw: decoder_layer(p, h_in.to(dev), mask_f, pos.to(dev), cos, sin,
                                               cfg, li, qw)[0].cpu().numpy()

    on_cpu, on_dev = layer_fn(torch.device("cpu")), layer_fn(device)
    to_dev = lambda tree: tree_map_tensors(lambda t: t.to(device), tree)
    per_layer = {}
    for li, lp in layer_params.items():
        ref_l = on_cpu(li, lp, True)  # the fake-quant oracle, CPU float32
        norms = {k: lp[k] for k in ("input_layernorm", "post_attention_layernorm")}
        packed_l = to_dev({**norms, **{g: {n: pack_linear_node(
            lp[g][n], node_cfg[g][n], subbyte=False, host=True) for n in names}
            for g, names in (("self_attn", _ATTN), ("mlp", _MLP))}})
        got_pack = on_dev(li, packed_l, False)
        del packed_l
        fake_l = {**to_dev(norms), **{g: {n: {"weight": quantize_weight(
            lp[g][n]["weight"].to(device), node_cfg[g][n])} for n in names}
            for g, names in (("self_attn", _ATTN), ("mlp", _MLP))}}
        got_fake = on_dev(li, fake_l, False)
        del fake_l
        # normalised by the reference RMS: a max relative diff is dominated
        # by near-zero elements
        rms = float(np.sqrt(np.mean(ref_l**2)))
        per_layer[f"layer_{li}"] = {
            "ref_rms": round(rms, 4),
            "packed_vs_chip_fake": _pair(got_pack, got_fake, rms),
            "chip_fake_vs_cpu_oracle": _pair(got_fake, ref_l, rms),
            "packed_vs_cpu_oracle": _pair(got_pack, ref_l, rms),
        }
        print(f"  layer {li}: {per_layer[f'layer_{li}']}", flush=True)
    return per_layer


def seven_b_shape_arm(batch=2, seq=64, device=None):
    """Quality evidence at the flagship 7B shape (4096 hidden / 32 layers /
    32000 vocab, random init):

    - per-node-type weight SQNR of the W6A6 BFP grid at 7B fan-ins and the
      pack mismatches, on the CPU (``_seven_b_weights``);
    - packed-vs-fake-quant logit parity on one batch: the fake-quant oracle
      runs on the CPU in float32, the packed model (int8 codes through
      ``pack_llama_params_host``) on ``device``, with and without the bf16
      embedding; then the teacher-forced per-layer parity
      (``_seven_b_per_layer``). With ``device`` the CPU the device part is
      reported skipped, as the JAX script's off-chip run reports it.
    The CPU holds the float32 tree (~27 GB) and runs the oracle's whole
    forward on it."""
    from .models.hf_loader import init_llama_params
    from .models.llama import LlamaQuantizedConfig, llama_for_causal_lm
    from .models.llama.pack import pack_llama_params_host

    device = resolve_device(device)
    cfg = LlamaQuantizedConfig(**_SEVEN_B, quant_config=quant_cfg("w6a6_bfp"))
    print("7B-shape: init random params on host…", flush=True)
    params = init_llama_params(cfg, task="lm", seed=0, device="cpu")
    out = _seven_b_weights(params, cfg, _SEVEN_B_LAYERS)

    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, seq)), dtype=torch.int64)
    mask = torch.ones_like(ids)
    print("7B-shape: CPU fake-quant oracle forward…", flush=True)
    with torch.no_grad():
        ref = llama_for_causal_lm(params, ids, mask, config=cfg,
                                  quantize_weights=True)["logits"][:, -1].numpy()

    if device.type == "cpu":
        out["logit_parity"] = "skipped (run on the CPU)"
        return out
    print("7B-shape: packing + on-device packed forward…", flush=True)
    for bf16_embed in (False, True):
        packed = pack_llama_params_host(params, cfg, bf16_embed=bf16_embed, device=device)
        with torch.no_grad():
            got = llama_for_causal_lm(packed, ids.to(device), mask.to(device), config=cfg,
                                      quantize_weights=False)["logits"][:, -1].float().cpu().numpy()
        rel = np.abs(got - ref) / (np.abs(ref) + 1e-6)
        key = "packed_bf16_embed" if bf16_embed else "packed_f32_embed"
        out[f"logit_parity_{key}"] = {
            "max_rel_diff": float(np.max(rel)),
            "mean_rel_diff": float(np.mean(rel)),
            "argmax_agree": float(np.mean(got.argmax(-1) == ref.argmax(-1))),
        }
        del packed, got
    out["note_logit_parity"] = (
        "end-to-end logits through 32 RANDOM-init layers amplify any "
        "correct-but-reordered f32 accumulation chaotically (~x2-3 per "
        "layer; 1e-6 platform deltas fully decorrelate 32000-way "
        "argmax) — per_layer_parity below is the fair per-op evidence"
    )
    print("7B-shape: per-layer teacher-forced parity…", flush=True)
    out["per_layer_parity"] = _seven_b_per_layer(
        {li: params["layers"][li] for li in _SEVEN_B_LAYERS}, cfg, device, batch, seq)
    del params
    return out


def _llama_configs(params, fp32_cfg, train_toks, test_toks):
    """The Llama arm: (report["configs"], the fp32 ppl unrounded): ppl under
    fp32, calibrated W8A8, W6A6 and W4A4 fake-quant and W6A6 packed."""
    from .models.llama import LlamaQuantizedConfig
    from .models.llama.pack import pack_llama_params

    configs = {}
    base = eval_ppl(params, fp32_cfg, test_toks, quantize_weights=False)
    configs["fp32"] = {"ppl": round(base["perplexity"], 4)}
    print(f"fp32: ppl {base['perplexity']:.4f}")

    int8_qc = calibrated_int8_config(params, fp32_cfg, train_toks)
    int8_cfg = LlamaQuantizedConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
        num_hidden_layers=LAYERS, num_attention_heads=HEADS,
        max_position_embeddings=SEQ, quant_config=int8_qc,
    )
    r8 = eval_ppl(params, int8_cfg, test_toks, quantize_weights=True)
    configs["w8a8_int_calibrated"] = {
        "ppl": round(r8["perplexity"], 4),
        "delta_vs_fp32": round(r8["perplexity"] - base["perplexity"], 4),
        "note": "frac widths from range_min_max stat profile "
                "(llm.int8-style calibrated baseline)",
    }
    print(f"w8a8_int_calibrated: ppl {r8['perplexity']:.4f} "
          f"(delta {r8['perplexity'] - base['perplexity']:+.4f})")

    for qname in ("w6a6_bfp", "w4a4_bfp"):
        cfg = build_model(qname)
        r = eval_ppl(params, cfg, test_toks, quantize_weights=True)
        delta = r["perplexity"] - base["perplexity"]
        configs[qname] = {"ppl": round(r["perplexity"], 4), "delta_vs_fp32": round(delta, 4)}
        print(f"{qname}: ppl {r['perplexity']:.4f} (delta {delta:+.4f})")

    # packed path: the same W6A6 weights as int8 codes + bfp_matmul
    cfg6 = build_model("w6a6_bfp")
    packed = pack_llama_params(params, cfg6, device=_first_tensor(params).device)
    rp = eval_ppl(packed, cfg6, test_toks, quantize_weights=False)
    configs["w6a6_bfp_packed"] = {
        "ppl": round(rp["perplexity"], 4),
        "delta_vs_fake_quant": round(rp["perplexity"] - configs["w6a6_bfp"]["ppl"], 6),
        "delta_vs_fp32": round(rp["perplexity"] - base["perplexity"], 4),
    }
    print(f"w6a6_bfp_packed: ppl {rp['perplexity']:.4f}")
    return configs, base["perplexity"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="QUALITY.json")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seven-b", action="store_true",
                    help="also run the 7B-shape arm (~40GB host RAM)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    corpus = synthetic_corpus(400 * SEQ, seed=0)
    train_toks, test_toks = corpus[: 320 * SEQ], corpus[320 * SEQ :]

    from .models.hf_loader import init_llama_params

    fp32_cfg = build_model("fp32")
    params = init_llama_params(fp32_cfg, task="lm", seed=0, device=device)
    params, train_loss = train_fp32(params, fp32_cfg, train_toks, args.steps)
    print(f"trained {args.steps} steps, final loss {train_loss:.3f}")

    report = {
        "protocol": "wikitext2-fixed-seq (reference eval_lm.py:38-63), "
        "synthetic Markov corpus (offline substitute)",
        "model": {
            "hidden": HIDDEN, "layers": LAYERS, "vocab": VOCAB, "seq": SEQ,
            "train_steps": args.steps,
        },
    }
    report["configs"], base_ppl = _llama_configs(params, fp32_cfg, train_toks, test_toks)
    cfg6 = build_model("w6a6_bfp")
    report["sqnr_db_w6a6"] = node_sqnr(params, fp32_cfg, cfg6, test_toks)
    report["sqnr_db_w4a4"] = node_sqnr(params, fp32_cfg, build_model("w4a4_bfp"), test_toks)

    # all 7 ariths, the Section 4.3 W4A4 QAT recovery, OPT/BERT coverage
    report["all_ariths"] = eval_all_ariths(params, base_ppl, test_toks)
    report["w4a4_after_qat"] = qat_recover_w4a4(
        params, train_toks, test_toks, base_ppl, steps=max(args.steps // 2, 50),
    )
    report["opt_arm"] = opt_arm(corpus, steps=max(args.steps // 2, 50), device=device)
    report["opt_arm_hidden256"] = opt_arm(
        corpus, steps=max(args.steps // 2, 50), hidden=256, ffn=704, device=device
    )
    report["opt_arm"]["note"] = (
        "hidden=128: a [1,16] block spans 1/8 of the fan-in, so relative "
        "block-quantization error is far coarser than at any real OPT "
        "width; the hidden=256 point shows the delta collapsing toward "
        "the llama arm's as fan-in grows (the 0.1 gate is defined for "
        "Llama-7B fan-ins, BASELINE.md)"
    )
    report["bert_arm"] = bert_arm(steps=max(args.steps // 2, 50), device=device)

    if args.seven_b:
        report["seven_b_shape"] = seven_b_shape_arm(device=device)

    d6 = report["configs"]["w6a6_bfp"]["delta_vs_fp32"]
    qat_rec = report["w4a4_after_qat"]
    report["gate"] = {
        "target": "W6A6 BFP ppl delta <= 0.1 vs fp32 (BASELINE.md); "
        "W4A4+QAT recovers toward lossless (README.md:11)",
        "w6a6_ppl_delta": d6,
        "w4a4_delta_before_qat": qat_rec["delta_before"],
        "w4a4_delta_after_qat": qat_rec["delta_after"],
        "pass": bool(abs(d6) <= 0.1 and qat_rec["delta_after"] < qat_rec["delta_before"]),
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"gate: W6A6 delta {d6:+.4f} -> {'PASS' if report['gate']['pass'] else 'FAIL'}")
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
