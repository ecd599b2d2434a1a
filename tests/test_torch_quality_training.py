"""The training arms of ``llm_mixed_q_torch.quality`` against the repo's
``quality.py`` on the CPU, at a tiny size set in both modules (vocab 64,
seq 16, hidden 32, intermediate 64, one layer, 2 heads), from the same
trees (``params_from_jax``; the arms' own inits patched to JAX's):

- ``qat_recover_w4a4`` at one step: the W4A4 perplexities before and after
  it at rtol 1e-5 (``tests/test_torch_eval_lm.py``'s tolerance);
- ``opt_arm`` and ``bert_arm`` at two training steps: their fp32 and W6A6
  metrics (perplexities at rtol 1e-5, accuracies equal).

JAX's eager BERT forward (``bert_arm``'s accuracy) runs jitted here
(``_jit_bert``): eagerly it compiles every operation, ~20 s a call."""

import jax
import numpy as np
import pytest
import torch
from test_torch_quality_arms import TEST_SEQS, TINY, _np

import quality as jq
from llm_mixed_q_tpu.models.hf_loader import init_bert_params as jax_init_bert
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.hf_loader import init_opt_params as jax_init_opt
from llm_mixed_q_torch import quality as tq
from llm_mixed_q_torch.models import hf_loader as port_loader
from llm_mixed_q_torch.models.hf_loader import params_from_jax

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


@pytest.fixture(scope="module")
def data(tiny):
    corpus = jq.synthetic_corpus(400 * jq.SEQ, seed=0)
    params = _np(jax_init(jq.build_model("fp32"), task="lm", seed=0))
    return corpus, corpus[: 320 * jq.SEQ], corpus[320 * jq.SEQ:][: TEST_SEQS * jq.SEQ], params


def test_qat_recover_one_step_matches_jax(data):
    _, train, test, params = data
    want = jq.qat_recover_w4a4(params, train, test, 64.0, steps=1)
    got = tq.qat_recover_w4a4(params_from_jax(params, device="cpu"), train, test, 64.0,
                              steps=1)
    assert got.keys() == want.keys() and got["qat_steps"] == 1
    for key in ("ppl_before_qat", "ppl_after_qat"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    assert got["ppl_after_qat"] != got["ppl_before_qat"]


def test_opt_arm_matches_jax(data, monkeypatch):
    """``opt_arm`` at hidden 32 from JAX's init tree, two steps."""
    from llm_mixed_q_tpu.models.opt import OPTQuantizedConfig as JaxOPT

    corpus = data[0]

    def jax_tree(config, task="lm", seed=0, device=None):
        kw = {k: getattr(config, k) for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                              "ffn_dim", "num_attention_heads",
                                              "max_position_embeddings")}
        return params_from_jax(_np(jax_init_opt(JaxOPT(**kw, quant_config=None), task=task,
                                                seed=seed)), device=device)

    monkeypatch.setattr(port_loader, "init_opt_params", jax_tree)
    want = jq.opt_arm(corpus, 2, hidden=32, ffn=64)
    got = tq.opt_arm(corpus, 2, hidden=32, ffn=64, device="cpu")
    assert got.keys() == want.keys()
    for key in ("fp32_ppl", "w6a6_bfp_ppl"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)


def _jit_bert(monkeypatch):
    """JAX's BERT classifier jitted at each call (inside the arm's jitted
    step, inlined)."""
    from llm_mixed_q_tpu.models import bert as jax_bert

    orig = jax_bert.bert_for_sequence_classification

    def fwd(params, ids, mask, labels=None, config=None, quantize_weights=True):
        return jax.jit(lambda p, i, m, y: orig(p, i, m, labels=y, config=config,
                                               quantize_weights=quantize_weights))(
            params, ids, mask, labels)

    monkeypatch.setattr(jax_bert, "bert_for_sequence_classification", fwd)


def test_bert_arm_matches_jax(monkeypatch):
    """``bert_arm`` at two steps from JAX's init tree: the same accuracies."""
    from llm_mixed_q_tpu.models.bert import BertQuantizedConfig as JaxBert

    def jax_tree(config, task="cls", seed=0, device=None):
        kw = {k: getattr(config, k) for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                              "num_attention_heads", "intermediate_size",
                                              "max_position_embeddings", "num_labels")}
        return params_from_jax(_np(jax_init_bert(JaxBert(**kw, quant_config=None), task=task,
                                                 seed=seed)), device=device)

    monkeypatch.setattr(port_loader, "init_bert_params", jax_tree)
    got = tq.bert_arm(2, device="cpu")
    _jit_bert(monkeypatch)
    want = jq.bert_arm(2)
    assert got == want
