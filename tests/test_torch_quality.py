"""``llm_mixed_q_torch.quality`` against the repo's ``quality.py`` on the CPU,
at a tiny size set in both modules (vocab 64, seq 16, hidden 32,
intermediate 64, 2 layers, 2 heads) and from the same trees
(``params_from_jax``):

- ``synthetic_corpus`` and ``chunk_batches`` bit-equal;
- ``calibrated_int8_config``: the same parsed config;
- ``eval_ppl`` at rtol 1e-5 (``tests/test_torch_eval_lm.py``'s tolerance)
  under fp32, W6A6, W4A4 and W6A6 packed, on a tree trained one step by
  JAX's ``train_fp32``, whose loss the port's one step gives at rtol 1e-5;
- ``node_sqnr``: the same nodes, each within 0.1 dB;
- the report's keys: JAX's ``main`` and the port's at this size with the
  same workers (their own report assembly, the gate included);
- the 7B arm's CPU parts at a cut width: weight SQNR and pack mismatches
  against JAX's quantizer and packer, the arm on the CPU (its device part
  reported skipped), and the teacher-forced layer against JAX's
  fake-quant layer within 1e-4 of its RMS, packed against fake-quant on
  the CPU.

JAX's eager forwards (``node_sqnr``'s tap run) run jitted here, their taps
handed back to the collector (``_jit_taps``): eagerly they compile every
operation, ~30 s. The arithmetics, the QAT recovery and the OPT and BERT
arms are ``tests/test_torch_quality_arms.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quality as jq
from llm_mixed_q_tpu.kernels.packing import pack_block_fp as jax_pack_block_fp
from llm_mixed_q_tpu.kernels.packing import unpack_block_fp as jax_unpack_block_fp
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import modeling as jax_modeling
from llm_mixed_q_tpu.ops import linear as jax_linear
from llm_mixed_q_torch import quality as tq
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig

TINY = dict(VOCAB=64, SEQ=16, HIDDEN=32, INTER=64, LAYERS=2, HEADS=2)
TEST_SEQS = 16  # of the 80 test sequences: four eval batches
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def tiny():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jq, tq):
            for k, v in TINY.items():
                mp.setattr(mod, k, v)
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return params_from_jax(_np(tree), device="cpu")


@pytest.fixture(scope="module")
def data(tiny):
    corpus = jq.synthetic_corpus(400 * jq.SEQ, seed=0)
    return corpus, corpus[: 320 * jq.SEQ], corpus[320 * jq.SEQ:][: TEST_SEQS * jq.SEQ]


@pytest.fixture(scope="module")
def trained(data):
    """(JAX's init tree, its tree after one step of JAX's ``train_fp32``,
    that step's loss)."""
    _, train, _ = data
    cfg = jq.build_model("fp32")
    init = _np(jax_init(cfg, task="lm", seed=0))
    params, loss = jq.train_fp32(init, cfg, train, 1)
    return init, _np(params), loss


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_corpus_is_bit_equal(tiny, seed):
    want = jq.synthetic_corpus(3000, seed=seed)
    got = tq.synthetic_corpus(3000, seed=seed)
    assert got.dtype == want.dtype == np.int32 and len(np.unique(got)) > 8
    np.testing.assert_array_equal(got, want)


def test_chunk_batches_are_bit_equal(data):
    corpus, _, _ = data
    want, got = list(jq.chunk_batches(corpus, 4)), list(tq.chunk_batches(corpus, 4))
    assert len(got) == len(want) == 100
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_train_fp32_one_step_matches_jax(data, trained):
    _, train, _ = data
    init, _, want = trained
    params, loss = tq.train_fp32(_port(init), tq.build_model("fp32"), train, 1)
    np.testing.assert_allclose(loss, want, rtol=RTOL)
    assert not params["embed_tokens"]["weight"].requires_grad


def _plain(x):
    """A parsed config with numpy scalars as Python's."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x.item() if isinstance(x, np.generic) else x


def test_calibrated_int8_config_matches_jax(data, trained):
    _, train, _ = data
    _, params, _ = trained
    want = jq.calibrated_int8_config(params, jq.build_model("fp32"), train)
    got = tq.calibrated_int8_config(_port(params), tq.build_model("fp32"), train)
    assert _plain(got) == _plain(want)
    assert got["model_layer_0"]["self_attn"]["q_proj"]["name"] == "integer"


def _jax_packed_eval(params, test):
    from llm_mixed_q_tpu.models.llama.pack import pack_llama_params

    cfg6 = jq.build_model("w6a6_bfp")
    packed = jax.jit(lambda p: pack_llama_params(p, cfg6))(params)
    return jq.eval_ppl(packed, cfg6, test, quantize_weights=False)


@pytest.mark.parametrize("name", ["fp32", "w6a6_bfp", "w4a4_bfp", "w6a6_bfp_packed"])
def test_eval_ppl_matches_jax(data, trained, name):
    _, _, test = data
    _, params, _ = trained
    if name == "w6a6_bfp_packed":
        from llm_mixed_q_torch.models.llama.pack import pack_llama_params

        want = _jax_packed_eval(params, test)
        cfg6 = tq.build_model("w6a6_bfp")
        got = tq.eval_ppl(pack_llama_params(_port(params), cfg6, device="cpu"), cfg6, test,
                          quantize_weights=False)
    else:
        qw = name != "fp32"
        want = jq.eval_ppl(params, jq.build_model(name), test, quantize_weights=qw)
        got = tq.eval_ppl(_port(params), tq.build_model(name), test, quantize_weights=qw)
    assert got["num_sequences"] == want["num_sequences"] == TEST_SEQS
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=RTOL)


def _jit_taps(monkeypatch):
    """JAX's ``llama_for_causal_lm`` jitted under a tap collector: the taps
    come back as outputs and go to the collector after the call, in the
    order the trace met them."""
    from llm_mixed_q_tpu.models import llama as jax_llama

    orig = jax_modeling.llama_for_causal_lm

    def fwd(params, ids, mask, config=None, quantize_weights=True):
        collector = jax_linear._TAP_COLLECTOR
        names = []

        class Taps:
            def __init__(self):
                self.outs = []

            def on_linear(self, name, x, w, b, out):
                names.append(name)
                self.outs.append(out)

        def traced(p, i, m):
            taps = Taps()
            with jax_linear.capture_quant_node_taps(taps):
                out = orig(p, i, m, config=config, quantize_weights=quantize_weights)
            return out, taps.outs

        out, outs = jax.jit(traced)(params, ids, mask)
        for name, y in zip(names, outs):
            collector.on_linear(name, None, None, None, y)
        return out

    monkeypatch.setattr(jax_llama, "llama_for_causal_lm", fwd)


@pytest.mark.parametrize("name", ["w6a6_bfp", "w4a4_bfp"])
def test_node_sqnr_matches_jax(data, trained, name, monkeypatch):
    """The same nodes, each within 0.1 dB."""
    _, _, test = data
    _, params, _ = trained
    got = tq.node_sqnr(_port(params), tq.build_model("fp32"), tq.build_model(name), test)
    _jit_taps(monkeypatch)
    want = jq.node_sqnr(params, jq.build_model("fp32"), jq.build_model(name), test)
    assert list(got) == list(want) and len(want) == 7 * jq.LAYERS
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=0,
                               atol=0.1)


# the workers of ``main``: each module's own, stubbed alike by
# ``_stub_workers`` (values from the real arms are compared in their tests)
WORKERS = ("train_fp32", "eval_ppl", "calibrated_int8_config", "node_sqnr", "eval_all_ariths",
           "qat_recover_w4a4", "opt_arm", "bert_arm")


def _stub_workers(mp, mod, arms):
    mp.setattr(mod, "train_fp32", lambda params, *a, **k: (params, 1.0))
    mp.setattr(mod, "eval_ppl", lambda *a, **k: {"perplexity": 2.0})
    mp.setattr(mod, "calibrated_int8_config", lambda params, fp32_config, toks:
               mod.build_model("w6a6_bfp").quant_config)
    mp.setattr(mod, "node_sqnr", lambda *a, **k: {"q_proj": 1.0})
    for name in ("eval_all_ariths", "qat_recover_w4a4", "opt_arm", "bert_arm"):
        mp.setattr(mod, name, lambda *a, v=arms[name], **k: dict(v))


def _keys(tree, prefix=""):
    if not isinstance(tree, dict):
        return set()
    out = set()
    for k, v in tree.items():
        out |= {f"{prefix}/{k}"} | _keys(v, f"{prefix}/{k}")
    return out


def test_report_keys_match_jax_main(tmp_path, monkeypatch):
    """JAX's ``main`` and the port's, each with its own report assembly and
    gate, on the same stubbed workers: the same keys, and the same gate."""
    arms = {"eval_all_ariths": {"integer": {"ppl": 2.0, "delta_vs_fp32": 0.0}},
            "qat_recover_w4a4": {"ppl_before_qat": 3.0, "ppl_after_qat": 2.5,
                                 "delta_before": 1.0, "delta_after": 0.5, "qat_steps": 50},
            "opt_arm": {"fp32_ppl": 2.0}, "bert_arm": {"fp32_acc": 1.0}}
    reports = {}
    for mod in (jq, tq):
        with pytest.MonkeyPatch.context() as mp:
            _stub_workers(mp, mod, arms)
            out = tmp_path / f"{mod.__name__}.json"
            argv = ["--steps", "2", "--out", str(out)]
            if mod is tq:
                tq.main(argv + ["--device", "cpu"])
            else:
                mp.setattr("sys.argv", ["quality.py", *argv])
                mp.setattr("llm_mixed_q_tpu.models.llama.pack.pack_llama_params",
                           lambda params, config: params)
                jq.main()
            reports[mod] = json.loads(out.read_text())
    assert _keys(reports[tq]) == _keys(reports[jq])
    assert "/gate/pass" in _keys(reports[jq]) and "/opt_arm_hidden256" in _keys(reports[jq])
    assert reports[tq]["gate"] == reports[jq]["gate"]
    assert reports[tq]["model"] == reports[jq]["model"]


SEVEN_B_CUT = dict(vocab_size=64, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=64)


def _cut_config():
    return LlamaQuantizedConfig(**SEVEN_B_CUT, quant_config=tq.quant_cfg("w6a6_bfp"))


def _cut_tree(seed=3):
    return _np(jax_init(JaxConfig(**SEVEN_B_CUT, quant_config=jq.quant_cfg("w6a6_bfp")),
                        task="lm", seed=seed))


def test_seven_b_weights_at_a_cut_width():
    """Part (a) of the 7B arm on one layer: JAX's quantizer and packer on
    the same weights give the same SQNRs (2 decimals) and mismatches."""
    tree, cfg = _cut_tree(), _cut_config()
    got = tq._seven_b_weights(_port(tree), cfg, layers=(0,))
    node_cfg = JaxConfig(**SEVEN_B_CUT, quant_config=jq.quant_cfg("w6a6_bfp")).quant_config[
        "model_layer_0"]

    @jax.jit
    def part_a(layer):  # the JAX script's loop body, jitted
        out = {}
        for group, names in (("self_attn", tq._ATTN), ("mlp", tq._MLP)):
            for name in names:
                w = layer[group][name]["weight"]
                ncfg = node_cfg[group][name]
                qw = jax_linear.quantize_weight(w, ncfg)
                db = 10 * jnp.log10(jnp.sum(w**2) / jnp.maximum(jnp.sum((w - qw) ** 2), 1e-30))
                p = jax_pack_block_fp(w, ncfg["weight_width"], 8,
                                      ncfg.get("weight_exponent_bias"), [1, 16])
                out[name] = (db, jnp.sum(jax_unpack_block_fp(p) != qw))
        return out

    want = part_a(tree["layers"][0])
    for name, (db, _) in want.items():
        assert got["weight_sqnr_db_by_node"][name]["per_layer_0_15_31"] == [round(float(db), 2)]
    assert got["packed_vs_fake_weight_mismatches"] == sum(int(m) for _, m in want.values())
    assert got["shape"] == {"hidden": 64, "layers": 2, "vocab": 64}


def test_seven_b_arm_on_the_cpu_reports_the_device_part_skipped(monkeypatch):
    """At a cut width: the CPU parts run, the device part is reported
    skipped, with the keys of JAX's off-chip run."""
    monkeypatch.setattr(tq, "_SEVEN_B", SEVEN_B_CUT)
    monkeypatch.setattr(tq, "_SEVEN_B_LAYERS", (0, 1))
    out = tq.seven_b_shape_arm(batch=2, seq=8, device="cpu")
    assert set(out) == {"shape", "weight_sqnr_db_by_node", "packed_vs_fake_weight_mismatches",
                        "note_mismatches", "logit_parity"}
    assert out["logit_parity"].startswith("skipped")
    assert set(out["weight_sqnr_db_by_node"]) == set(tq._ATTN + tq._MLP)


def test_teacher_forced_layer_matches_jax():
    """``_seven_b_per_layer`` with the CPU as its device: the oracle layer
    matches JAX's fake-quant ``decoder_layer`` within 1e-4 of its RMS, the
    fake-quant weights give the oracle bit for bit, and the packed layer
    (the plain int8 matmul) is within 1e-5 of it."""
    tree, cfg = _cut_tree(), _cut_config()
    batch, seq = 2, 8
    got = tq._seven_b_per_layer({1: _port(tree)["layers"][1]}, cfg, torch.device("cpu"),
                                batch, seq)["layer_1"]
    assert got["chip_fake_vs_cpu_oracle"]["max_abs_over_ref_rms"] == 0
    assert got["packed_vs_chip_fake"]["max_abs_over_ref_rms"] < 1e-5
    jc = JaxConfig(**SEVEN_B_CUT, quant_config=jq.quant_cfg("w6a6_bfp"))
    h_in = jnp.asarray(np.random.default_rng(1).standard_normal((batch, seq, 64), np.float32)
                       * 0.5)
    mask = jnp.ones((batch, seq), jnp.int32)
    cos, sin = jax_modeling.rope_tables(seq, jc.head_dim, jc.rope_theta)
    pos = jnp.arange(seq)[None, :].repeat(batch, 0)
    want = np.asarray(jax.jit(lambda p: jax_modeling.decoder_layer(
        p, h_in, jax_modeling.make_causal_mask(mask, seq, seq), pos, cos, sin, jc, 1, True)[0])(
        tree["layers"][1]))
    rms = float(np.sqrt(np.mean(want**2)))
    assert got["ref_rms"] == pytest.approx(round(rms, 4), abs=2e-4)
    mine = _seven_b_oracle(tree, cfg, batch, seq)
    np.testing.assert_allclose(mine / rms, want / rms, rtol=0, atol=1e-4)


def _seven_b_oracle(tree, cfg, batch, seq):
    """The port's oracle layer 1 on the same input, as ``_seven_b_per_layer``
    computes it."""
    from llm_mixed_q_torch.models.llama.modeling import decoder_layer, make_causal_mask, rope_tables

    h_in = torch.from_numpy(np.random.default_rng(1).standard_normal((batch, seq, 64),
                                                                      np.float32) * 0.5)
    mask_f = make_causal_mask(torch.ones((batch, seq), dtype=torch.int64), seq, seq)
    cos, sin = rope_tables(seq, cfg.head_dim, cfg.rope_theta)
    pos = torch.arange(seq)[None, :].repeat(batch, 1)
    with torch.no_grad():
        return decoder_layer(_port(tree)["layers"][1], h_in, mask_f, pos, cos, sin, cfg, 1,
                             True)[0].numpy()
