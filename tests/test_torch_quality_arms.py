"""The seven arithmetics of ``llm_mixed_q_torch.quality`` against the repo's
``quality.py`` on the CPU, at a tiny size set in both modules (vocab 64,
seq 16, hidden 32, intermediate 64, one layer, 2 heads), from the same
tree (``params_from_jax``): ``eval_ppl`` under each of the seven
``ARITH_TOMLS`` at rtol 1e-5 (``tests/test_torch_eval_lm.py``'s
tolerance), and ``eval_all_ariths``' table: those perplexities and
deltas, and block_minifloat's weight SQNR and note, as JAX's
``eval_all_ariths`` gives them. The training arms are
``tests/test_torch_quality_training.py``."""

import jax
import numpy as np
import pytest
import torch

import quality as jq
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_torch import quality as tq
from llm_mixed_q_torch.models.hf_loader import params_from_jax

TINY = dict(VOCAB=64, SEQ=16, HIDDEN=32, INTER=64, LAYERS=1, HEADS=2)
TEST_SEQS = 16
RTOL = 1e-5
_JAX_PPL = {}  # arith: JAX's eval_ppl


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


@pytest.fixture(scope="module")
def data(tiny):
    corpus = jq.synthetic_corpus(400 * jq.SEQ, seed=0)
    params = _np(jax_init(jq.build_model("fp32"), task="lm", seed=0))
    return corpus, corpus[: 320 * jq.SEQ], corpus[320 * jq.SEQ:][: TEST_SEQS * jq.SEQ], params


def _arith_config(mod, name):
    from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
    from llm_mixed_q_tpu.utils.toml_io import load_config as jax_load
    from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig
    from llm_mixed_q_torch.utils.toml_io import load_config

    cls, load = (JaxConfig, jax_load) if mod is jq else (LlamaQuantizedConfig, load_config)
    return cls(vocab_size=mod.VOCAB, hidden_size=mod.HIDDEN, intermediate_size=mod.INTER,
               num_hidden_layers=mod.LAYERS, num_attention_heads=mod.HEADS,
               max_position_embeddings=mod.SEQ,
               quant_config=load(str(tq.ROOT / mod.ARITH_TOMLS[name])))


def _jax_ppl(name, params, test):
    if name not in _JAX_PPL:
        _JAX_PPL[name] = jq.eval_ppl(params, _arith_config(jq, name), test,
                                     quantize_weights=True)["perplexity"]
    return _JAX_PPL[name]


def test_arith_tomls_are_jax_s():
    assert tq.ARITH_TOMLS == jq.ARITH_TOMLS


@pytest.mark.parametrize("name", list(jq.ARITH_TOMLS))
def test_eval_ppl_under_each_arith_matches_jax(data, name):
    _, _, test, params = data
    want = _jax_ppl(name, params, test)
    got = tq.eval_ppl(params_from_jax(params, device="cpu"), _arith_config(tq, name), test,
                      quantize_weights=True)
    np.testing.assert_allclose(got["perplexity"], want, rtol=RTOL)


def test_eval_all_ariths_table_matches_jax(data, monkeypatch):
    """The port's table against JAX's ``eval_all_ariths``, whose
    perplexities come from the evaluations above (the block_minifloat
    weight SQNR and note are its own)."""
    _, _, test, params = data
    base = 64.0
    got = tq.eval_all_ariths(params_from_jax(params, device="cpu"), base, test)

    def cached(p, cfg, toks, quantize_weights):
        name = next(n for n in jq.ARITH_TOMLS
                    if _arith_config(jq, n).quant_config == cfg.quant_config)
        return {"perplexity": _jax_ppl(name, params, test)}

    monkeypatch.setattr(jq, "eval_ppl", cached)
    want = jq.eval_all_ariths(jax.tree.map(jax.numpy.asarray, params), base, test)
    assert list(got) == list(want)
    for name, row in want.items():
        assert set(got[name]) == set(row)
        np.testing.assert_allclose(got[name]["ppl"], row["ppl"], rtol=RTOL)
        np.testing.assert_allclose(got[name]["delta_vs_fp32"], row["delta_vs_fp32"], atol=2e-4)
    assert got["block_minifloat"]["note"] == want["block_minifloat"]["note"]
    np.testing.assert_allclose(got["block_minifloat"]["weight_sqnr_db"],
                               want["block_minifloat"]["weight_sqnr_db"], atol=0.011)
