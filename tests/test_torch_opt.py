"""The port's OPT slice against the JAX package, on the CPU at a small size:
2 layers, hidden 64, ffn 128, 4 heads (head_dim 16), vocab 128. Weights are
a synthetic flat dict of HF names made with numpy, loaded by both packages'
``opt_params_from_flat``, or the JAX package's numpy init crossed over
through ``params_from_jax``.

Tolerances: logits agree to 1e-4 of their largest magnitude (float32 sums
taken in another order; a flipped 5-bit rounding of a quantized activation
would show as ~1e-3, and none may occur); PTQ weights and packed buffers
are bit-equal; generated tokens are equal."""

import contextlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.models import pack_common as jax_pack_common
from llm_mixed_q_tpu.models.hf_loader import init_opt_params as jax_init
from llm_mixed_q_tpu.models.hf_loader import opt_params_from_flat as jax_from_flat
from llm_mixed_q_tpu.models.opt import OPTQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.opt import opt_for_causal_lm as jax_forward
from llm_mixed_q_tpu.models.opt import quantize_opt_params_ptq as jax_ptq
from llm_mixed_q_tpu.models.opt.modeling import ACT2FN as JAX_ACT2FN
from llm_mixed_q_tpu.models.opt.pack import pack_opt_params as jax_pack
from llm_mixed_q_tpu.models.opt.serving import generate as jax_generate
from llm_mixed_q_torch.kernels import PackedBFPSub, PackedBFPSubT
from llm_mixed_q_torch.models import pack_common
from llm_mixed_q_torch.models.hf_loader import (
    init_opt_params,
    opt_params_from_flat,
    params_from_jax,
    params_to_numpy,
)
from llm_mixed_q_torch.models.opt import (
    OPTQuantizedConfig,
    opt_for_causal_lm,
    opt_generate,
    quantize_opt_params_ptq,
)
from llm_mixed_q_torch.models.opt.modeling import ACT2FN
from llm_mixed_q_torch.models.opt.pack import pack_opt_params

from test_torch_llama import _flat

BFP6 = "configs/quantization/bfp_6bit.toml"
VOCAB = 128
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, ffn_dim=128,
            num_attention_heads=4, max_position_embeddings=128)


def _configs(quant=BFP6, **kw):
    kw = {**TINY, **kw}
    return JaxConfig(**kw, quant_config=quant), OPTQuantizedConfig(**kw, quant_config=quant)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hf_flat(config, seed):
    """Random OPT weights under HF names, nonzero biases and norms."""
    rng = np.random.default_rng(seed)
    h, ffn, d = config.hidden_size, config.ffn_dim, config.word_embed_proj_dim

    def r(*shape, scale=0.05, offset=0.0):
        return (offset + rng.standard_normal(shape) * scale).astype(np.float32)

    pre = "model.decoder."
    flat = {pre + "embed_tokens.weight": r(config.vocab_size, d, scale=0.5),
            pre + "embed_positions.weight": r(config.max_position_embeddings + 2, h, scale=0.5),
            pre + "final_layer_norm.weight": r(h, scale=0.1, offset=1.0),
            pre + "final_layer_norm.bias": r(h)}
    if d != h:
        flat[pre + "project_in.weight"] = r(h, d, scale=0.2)
        flat[pre + "project_out.weight"] = r(d, h, scale=0.2)
    for i in range(config.num_hidden_layers):
        lp = f"{pre}layers.{i}."
        for name, (o, n) in {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h),
                             "self_attn.v_proj": (h, h), "self_attn.out_proj": (h, h),
                             "fc1": (ffn, h), "fc2": (h, ffn)}.items():
            flat[lp + name + ".weight"] = r(o, n, scale=0.15)
            flat[lp + name + ".bias"] = r(o)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            flat[lp + ln + ".weight"] = r(h, scale=0.1, offset=1.0)
            flat[lp + ln + ".bias"] = r(h)
    return flat


def _ragged(lengths, pad_to, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), pad_to), np.int32)
    mask = np.zeros((len(lengths), pad_to), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(2, VOCAB, size=n)
        mask[i, :n] = 1
    return ids, mask


def _jax_logits(jp, jc, ids, mask, quantize_weights=True):
    return np.asarray(jax.jit(lambda p, i, m: jax_forward(
        p, i, m, config=jc, quantize_weights=quantize_weights)["logits"])(jp, ids, mask))


def _torch_logits(tp, tc, ids, mask, quantize_weights=True):
    return opt_for_causal_lm(tp, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                             config=tc, quantize_weights=quantize_weights)["logits"].numpy()


def _assert_logits_close(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pre_ln,wepd,act", [(True, 64, "relu"), (False, 64, "relu"),
                                             (True, 48, "relu"), (True, 64, "gelu_new")])
@pytest.mark.parametrize("quant", [None, BFP6])
def test_logits_match_jax(quant, pre_ln, wepd, act):
    """Bypass and W6A6 BFP, pre- and post-LN, project_in/out, ragged mask;
    both packages load the same flat dict."""
    jc, tc = _configs(quant, do_layer_norm_before=pre_ln, word_embed_proj_dim=wepd,
                      activation_function=act)
    flat = _hf_flat(tc, seed=1)
    jp = jax_from_flat(flat, jc)
    tp = opt_params_from_flat(flat, tc, device="cpu")
    assert ("project_in" in tp) == (wepd != 64)
    ids, mask = _ragged([13, 8], 13, seed=2)
    _assert_logits_close(_torch_logits(tp, tc, ids, mask), _jax_logits(jp, jc, ids, mask))


def test_opt_params_from_flat_matches_jax():
    jc, tc = _configs(word_embed_proj_dim=48)
    flat = _hf_flat(tc, seed=3)
    want = _flat(_np(jax_from_flat(flat, jc)))
    got = _flat(params_to_numpy(opt_params_from_flat(
        {k: torch.from_numpy(v) for k, v in flat.items()}, tc, device="cpu")))
    assert want.keys() == got.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_gelu_is_exact_where_jax_approximates():
    """"gelu" follows the JAX package: jax.nn.gelu, whose default is the
    tanh approximation (the reference's transformers mapping is the exact
    erf GELU; the JAX package departs from it there). gelu_new (tanh)
    agrees too."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    got = ACT2FN["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JAX_ACT2FN["gelu"](x)), rtol=1e-6, atol=1e-6)
    assert np.abs(got - np.asarray(jax.nn.gelu(x, approximate=False))).max() > 1e-4
    np.testing.assert_allclose(ACT2FN["gelu_new"](torch.from_numpy(x)).numpy(),
                               np.asarray(JAX_ACT2FN["gelu_new"](x)), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    jc, tc = _configs()
    flat = _hf_flat(tc, seed=5)
    return jc, tc, jax_from_flat(flat, jc), opt_params_from_flat(flat, tc, device="cpu")


def test_ptq_prepare_matches_jax(tiny):
    """Weights and biases fake-quantized once are bit-equal, and the PTQ
    forward (quantize_weights=False) gives JAX's logits."""
    jc, tc, jp, tp = tiny
    jq = _np(jax_ptq(jp, jc))
    tq = quantize_opt_params_ptq(tp, tc)
    for node in (("self_attn", "q_proj"), ("fc2",)):
        jn, tn = jq["layers"][1], tq["layers"][1]
        for key in node:
            jn, tn = jn[key], tn[key]
        for leaf in ("weight", "bias"):
            np.testing.assert_array_equal(tn[leaf].numpy(), jn[leaf])
    ids, mask = _ragged([9, 6], 9, seed=10)
    _assert_logits_close(_torch_logits(tq, tc, ids, mask, False),
                         _jax_logits(jq, jc, ids, mask, False))


def _packed_pair(jp, jc, tp, tc, lane_major):
    """JAX and port trees packed sub-byte; ``lane_major`` keeps the
    PackedBFPSub layout in both (their transpose patched to the identity)."""
    def identity_to_t(module):
        if not lane_major:
            return contextlib.nullcontext()
        return mock.patch.object(module, "_to_t", lambda p: p)

    with identity_to_t(jax_pack_common):
        jpk = jax.jit(lambda p: jax_pack(p, jc, subbyte=True))(jp)
    with identity_to_t(pack_common):
        tpk = pack_opt_params(tp, tc, subbyte=True, device="cpu")
    return jpk, tpk


@pytest.mark.parametrize("lane_major", [False, True])
def test_pack_matches_jax(tiny, lane_major):
    """Every buffer of the packed trees is byte-equal (biases quantized at
    pack time included)."""
    jc, tc, jp, tp = tiny
    jpk, tpk = _packed_pair(jp, jc, tp, tc, lane_major)
    fmt = PackedBFPSub if lane_major else PackedBFPSubT
    assert isinstance(tpk["layers"][0]["fc1"]["weight"], fmt)
    assert type(jpk["layers"][0]["fc1"]["weight"]).__name__ == fmt.__name__
    want, got = _flat(_np(jpk)), _flat(params_to_numpy(tpk))
    assert want.keys() == got.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert w.dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k].view(np.uint8), w.view(np.uint8), err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("lane_major", [False, True])
@pytest.mark.parametrize("lengths", [(7, 7), (4, 11, 7)])
def test_generate_matches_jax(tiny, lane_major, lengths):
    """Greedy tokens of packed OPT generation, uniform and ragged batches, on
    the transposed (K1) and the lane-major (K3) tree."""
    jc, tc, jp, tp = tiny
    jpk, tpk = _packed_pair(jp, jc, tp, tc, lane_major)
    ids, mask = _ragged(lengths, max(lengths), seed=len(lengths))
    want = np.asarray(jax_generate(jpk, jc, ids, mask, max_new_tokens=6, max_len=24))
    got = opt_generate(tpk, tc, ids, mask, max_new_tokens=6, max_len=24, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_generate_fake_quant_matches_jax(tiny):
    """Unpacked weights, quantized every call."""
    jc, tc, jp, tp = tiny
    ids, mask = _ragged([5, 9], 9, seed=6)
    want = np.asarray(jax_generate(jp, jc, ids, mask, max_new_tokens=5, max_len=20))
    got = opt_generate(tp, tc, ids, mask, max_new_tokens=5, max_len=20, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_generate_eos_stops(tiny):
    """A row stops at its first EOS and holds EOS from there on."""
    _, tc, _, tp = tiny
    ids, mask = _ragged([5, 8], 8, seed=7)
    free = opt_generate(tp, tc, ids, mask, max_new_tokens=8, device="cpu")
    eos = int(free[0, 2])
    got = opt_generate(tp, tc, ids, mask, max_new_tokens=8, eos_token_id=eos, device="cpu")
    for row_got, row_free in zip(got, free):
        hit = np.flatnonzero(row_free == eos)
        stop = hit[0] + 1 if hit.size else len(row_free)
        np.testing.assert_array_equal(row_got[:stop], row_free[:stop])
        assert (row_got[stop:] == eos).all()


def test_sampling_is_seeded(tiny):
    _, tc, _, tp = tiny
    ids, mask = _ragged([6, 4], 6, seed=8)
    runs = [opt_generate(tp, tc, ids, mask, max_new_tokens=6, temperature=1.0, top_k=8,
                         seed=s, device="cpu") for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (runs[0] != runs[2]).any()
    assert ((runs[0] >= 0) & (runs[0] < VOCAB)).all()


def test_init_packs_layer_by_layer():
    """init_opt_params(pack=...) packs each layer as it is made: the same
    tree as packing the float32 init afterwards."""
    _, tc = _configs(word_embed_proj_dim=48)
    direct = init_opt_params(tc, seed=4, device="cpu", pack=dict(subbyte=True))
    after = pack_opt_params(init_opt_params(tc, seed=4, device="cpu"), tc, device="cpu")
    want, got = _flat(params_to_numpy(after)), _flat(params_to_numpy(direct))
    assert want.keys() == got.keys()
    assert "/project_in/weight" in got
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_params_from_jax_round_trip():
    """JAX OPT tree (sub-byte packed, biases, embed_positions) -> port ->
    numpy: every buffer and every static field comes back unchanged."""
    jc, _ = _configs()
    jpk = _np(jax.jit(lambda p: jax_pack(p, jc, subbyte=True))(jax_init(jc, seed=2)))
    want = _flat(jpk)
    got = _flat(params_to_numpy(params_from_jax(jpk, device="cpu")))
    assert want.keys() == got.keys()
    assert "/embed_positions/weight" in got and "/layers/0/fc1/bias" in got
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert w.dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_default_device_raises_without_cuda(monkeypatch, tiny):
    _, tc, _, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_opt_params(tc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        opt_generate(tp, tc, np.ones((1, 3), np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_opt_params(tp, tc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        opt_params_from_flat(_hf_flat(tc, seed=0), tc)
