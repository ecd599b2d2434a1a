"""The port's Llama slice against the JAX package, on the CPU at a small
size: 2 layers, hidden 256, head_dim 128, vocab 512, MHA (nkv 2) and GQA
(rep 2). Weights come from the JAX package's numpy init and cross over
through ``params_from_jax``.

Tolerances: logits agree to 1e-4 of their largest magnitude (float32 sums
taken in another order; with quantized activations a flipped 5-bit
rounding would show as ~1e-3, and none may occur); generated tokens are
equal."""

import jax
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import llama_for_causal_lm as jax_forward
from llm_mixed_q_tpu.models.llama.pack import pack_llama_params as jax_pack
from llm_mixed_q_tpu.models.llama.prepare import quantize_llama_params_ptq as jax_ptq
from llm_mixed_q_tpu.models.llama.serving import generate as jax_generate
from llm_mixed_q_torch.kernels import PackedBFP, PackedBFPSubT
from llm_mixed_q_torch.models.hf_loader import init_llama_params, params_from_jax, params_to_numpy
from llm_mixed_q_torch.models.llama import (
    ContinuousBatcher,
    LlamaQuantizedConfig,
    decode_step,
    generate,
    llama_for_causal_lm,
    pack_llama_params,
    prefill_into_cache,
    quantize_llama_params_ptq,
)
from llm_mixed_q_torch.models.llama.serving import init_packed_kv_cache, kv_cache_pack_spec

BFP6 = "configs/quantization/bfp_6bit.toml"
VOCAB = 512


def _configs(nkv=2, quant=BFP6):
    kw = dict(vocab_size=VOCAB, hidden_size=256, intermediate_size=704,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=nkv, max_position_embeddings=4200)
    return JaxConfig(**kw, quant_config=quant), LlamaQuantizedConfig(**kw, quant_config=quant)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_packed(jp, jc, **kw):
    # jitted: eager JAX packing compiles every primitive on its own
    return jax.jit(lambda p: jax_pack(p, jc, **kw))(jp)


def _ragged(lengths, pad_to, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), pad_to), np.int32)
    mask = np.zeros((len(lengths), pad_to), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(2, VOCAB, size=n)
        mask[i, :n] = 1
    return ids, mask


@pytest.fixture(scope="module")
def gqa():
    jc, tc = _configs(nkv=1)
    jp = jax_init(jc, seed=0)
    return jc, tc, jp, params_from_jax(_np(jp), device="cpu")


@pytest.mark.parametrize("quant", [None, BFP6])
@pytest.mark.parametrize("nkv", [2, 1])
def test_logits_match_jax(quant, nkv):
    jc, tc = _configs(nkv, quant)
    jp = jax_init(jc, seed=0)
    ids, mask = _ragged([11, 7], 11, seed=1)
    want = np.asarray(jax.jit(lambda p, i, m: jax_forward(p, i, m, config=jc)["logits"])(
        jp, ids, mask))
    got = llama_for_causal_lm(params_from_jax(_np(jp), device="cpu"),
                              torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                              config=tc)["logits"].numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


def test_ptq_prepare_matches_jax(gqa):
    """Weights fake-quantized once (2-D [1, 16] weight tiles) are bit-equal,
    and the PTQ forward (quantize_weights=False) gives JAX's logits."""
    jc, tc, jp, tp = gqa
    jq = _np(jax_ptq(jp, jc))
    tq = quantize_llama_params_ptq(tp, tc)
    for name in ("q_proj", "o_proj"):
        np.testing.assert_array_equal(
            tq["layers"][1]["self_attn"][name]["weight"].numpy(),
            jq["layers"][1]["self_attn"][name]["weight"])
    ids, mask = _ragged([9, 6], 9, seed=10)
    want = np.asarray(jax.jit(lambda p, i, m: jax_forward(
        p, i, m, config=jc, quantize_weights=False)["logits"])(jq, ids, mask))
    got = llama_for_causal_lm(tq, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                              config=tc, quantize_weights=False)["logits"].numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("quant", [None, BFP6])
def test_generate_fake_quant_cache_matches_jax(quant):
    """The float32 fake-quant KV cache (packed_kv=False; the only cache of a
    bypass config) on unpacked weights, ragged batch."""
    jc, tc = _configs(nkv=2, quant=quant)
    jp = jax_init(jc, seed=11)
    ids, mask = _ragged([7, 12], 12, seed=12)
    want = np.asarray(jax_generate(jp, jc, ids, mask, max_new_tokens=5, max_len=24,
                                   packed_kv=False))
    got = generate(params_from_jax(_np(jp), device="cpu"), tc, ids, mask, max_new_tokens=5,
                   max_len=24, packed_kv=False, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subbyte", [False, True])
def test_generate_pos_major_matches_jax(gqa, subbyte):
    """Ragged batch, packed weights (int8 / sub-byte), bf16 embeddings,
    pos-major packed cache, greedy and with EOS."""
    jc, tc, jp, tp = gqa
    jpk = _jax_packed(jp, jc, subbyte=subbyte, bf16_embed=True)
    tpk = pack_llama_params(tp, tc, subbyte=subbyte, bf16_embed=True, device="cpu")
    node = tpk["layers"][0]["self_attn"]["qkv_proj"]["weight"]
    assert isinstance(node, PackedBFPSubT if subbyte else PackedBFP)
    # the port packs the same bytes as the JAX package
    for a, b in zip(_np(jpk["layers"][1]["mlp"]["gate_up_proj"]["weight"])[:2],
                    tpk["layers"][1]["mlp"]["gate_up_proj"]["weight"][:2]):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), b.numpy().view(np.uint8))
    ids, mask = _ragged([5, 11, 16], 16, seed=2)
    want = np.asarray(jax_generate(jpk, jc, ids, mask, max_new_tokens=8, max_len=32))
    got = generate(tpk, tc, ids, mask, max_new_tokens=8, max_len=32, device="cpu")
    np.testing.assert_array_equal(got, want)
    # EOS as the JAX package defines it: a row stops at its first EOS and
    # holds EOS from there on
    eos = int(want[0, 2])
    got = generate(tpk, tc, ids, mask, max_new_tokens=8, max_len=32, device="cpu",
                   eos_token_id=eos)
    for row_got, row_free in zip(got, want):
        hit = np.flatnonzero(row_free == eos)
        stop = hit[0] + 1 if hit.size else len(row_free)
        np.testing.assert_array_equal(row_got[:stop], row_free[:stop])
        assert (row_got[stop:] == eos).all()


def test_generate_head_major_matches_jax():
    """nkv * max_len = 8320 > 8192 lanes: the head-major packed cache."""
    jc, tc = _configs(nkv=2)
    jp = jax_init(jc, seed=3)
    jpk = _jax_packed(jp, jc)
    tpk = params_from_jax(_np(jpk), device="cpu")
    cache = init_packed_kv_cache(tc, 1, 4160, kv_cache_pack_spec(tc))
    assert not cache.pos_major
    ids, mask = _ragged([6, 3], 6, seed=4)
    want = np.asarray(jax_generate(jpk, jc, ids, mask, max_new_tokens=4, max_len=4160))
    got = generate(tpk, tc, ids, mask, max_new_tokens=4, max_len=4160, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_len", [48, 4160])
def test_continuous_batcher_matches_generate(max_len):
    """3 slots, 5 requests: rolling admission, both cache layouts."""
    _, tc = _configs(nkv=2)
    jp = jax_init(_configs(nkv=2)[0], seed=5)
    tpk = pack_llama_params(params_from_jax(_np(jp), device="cpu"), tc, subbyte=True,
                            device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, VOCAB, size=n) for n in (4, 9, 6, 12, 3)]
    srv = ContinuousBatcher(tpk, tc, num_slots=3, max_len=max_len, max_new_tokens=5,
                            prompt_bucket=16, device="cpu")
    rids = [srv.submit(p) for p in prompts]
    done = srv.run()
    for rid, p in zip(rids, prompts):
        ref = generate(tpk, tc, p[None, :], max_new_tokens=5, max_len=max_len,
                       device="cpu")[0]
        np.testing.assert_array_equal(np.asarray(done[rid]), ref)


def test_batcher_stops_requests_at_eos(gqa):
    """With an EOS id a request ends at its first EOS (inclusive): the
    batcher returns generate's row cut there."""
    _, tc, _, tp = gqa
    tpk = pack_llama_params(tp, tc, device="cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(2, VOCAB, size=n) for n in (5, 8, 3)]
    free = [generate(tpk, tc, p[None, :], max_new_tokens=6, max_len=32, device="cpu")[0]
            for p in prompts]
    eos = int(free[0][2])
    srv = ContinuousBatcher(tpk, tc, num_slots=2, max_len=32, max_new_tokens=6,
                            eos_token_id=eos, prompt_bucket=8, device="cpu")
    rids = [srv.submit(p) for p in prompts]
    done = srv.run()
    for rid, row in zip(rids, free):
        hit = np.flatnonzero(row == eos)
        stop = hit[0] + 1 if hit.size else len(row)
        assert done[rid] == row[:stop].tolist()


def test_init_packs_layer_by_layer(gqa):
    """init_llama_params(pack=...) packs each layer as it is made: the same
    tree as packing the float32 init afterwards."""
    _, tc, _, _ = gqa
    pack = dict(subbyte=True, bf16_embed=True)
    direct = init_llama_params(tc, seed=4, device="cpu", pack=pack)
    after = pack_llama_params(init_llama_params(tc, seed=4, device="cpu"), tc, device="cpu",
                              **pack)
    want, got = _flat(params_to_numpy(after)), _flat(params_to_numpy(direct))
    assert want.keys() == got.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_batcher_rejects_prompts_that_do_not_fit(gqa):
    _, tc, _, tp = gqa
    srv = ContinuousBatcher(tp, tc, num_slots=2, max_len=8, device="cpu")
    for prompt in ([], list(range(2, 10))):
        with pytest.raises(ValueError, match="shorter than max_len"):
            srv.submit(prompt)
    assert srv.run() == {}


def test_sampling_is_seeded(gqa):
    _, tc, _, tp = gqa
    ids, mask = _ragged([8, 5], 8, seed=7)
    runs = [generate(tp, tc, ids, mask, max_new_tokens=6, temperature=1.0, top_k=8,
                     seed=s, device="cpu") for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (runs[0] != runs[2]).any()
    assert ((runs[0] >= 0) & (runs[0] < VOCAB)).all()


@pytest.mark.parametrize("pos_major", [True, False])
def test_kernel_flag_takes_plain_versions_on_cpu(pos_major):
    """On CPU tensors the attention kernel wrappers, which a packed cache's
    decode step calls, take their plain versions: the same context as
    ``attend_dense`` on the dequantized cache, for both layouts."""
    from llm_mixed_q_torch.kernels.attention_decode import (
        attend_dense, packed_attention_decode_batch_cuda, packed_attention_decode_cuda)
    from llm_mixed_q_torch.kernels.packing import bfp_encode_lastdim
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq

    b, nkv, rep, hd, max_len = 2, 2, 2, 128, 48
    gen = torch.Generator().manual_seed(int(pos_major))
    k, v = (torch.randn((b, nkv, max_len, hd), generator=gen) for _ in range(2))
    (kc, ks), (vc, vs) = (bfp_encode_lastdim(t, 6, 8, None, 16) for t in (k, v))
    q = _block_fp_qdq(torch.randn((b * nkv * rep, hd), generator=gen), 6, 8, None,
                      [1, 16], True).reshape(b, nkv, rep, hd)
    positions = torch.tensor([max_len - 1, 5])
    prob_q = (16, 6, 8, None)
    pq = lambda p: _block_fp_qdq(p, 6, 8, None, [1, 16], skip_first_dim=True)
    want = attend_dense(q, (kc * ks.repeat_interleave(16, -1)).transpose(2, 3),
                        vc * vs.repeat_interleave(16, -1), positions, pq)
    if pos_major:
        flat = lambda t: t.permute(0, 3, 2, 1).reshape(b, t.shape[3], max_len * nkv)
        got = packed_attention_decode_batch_cuda(
            q.reshape(b, nkv * rep, hd), flat(kc), flat(ks), flat(vc), flat(vs),
            positions, 16, 16, nkv=nkv, rep=rep, prob_q=prob_q).reshape(want.shape)
    else:
        got = packed_attention_decode_cuda(
            q, kc.transpose(2, 3).contiguous(), ks.transpose(2, 3).contiguous(), vc, vs,
            positions, 16, 16, prob_q=prob_q)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cache_choice_follows_the_kernel_limits(gqa):
    """generate's default cache is packed wherever the config permits, as
    the JAX package's is; the kernel limits (rep 2 at head_dim 128: any
    cache length) choose the decode route, not the cache."""
    from llm_mixed_q_torch.kernels.attention_decode import attention_kernel_error
    from llm_mixed_q_torch.models.llama.serving import _cache_spec, packed_cache_layout

    _, tc, _, _ = gqa
    spec = kv_cache_pack_spec(tc)
    assert spec is not None
    assert _cache_spec(tc, None) == spec
    assert _cache_spec(tc, True) == spec
    assert _cache_spec(tc, False) is None
    for max_len in (4160, 40000):
        assert attention_kernel_error(tc, max_len, *packed_cache_layout(tc, max_len)) is None


def _flat(tree, path=""):
    """path -> array for every array of a parameter tree (packed nodes by
    field name; the static ``splits`` tuples by value)."""
    if hasattr(tree, "_fields"):
        out = {f"{path}.{f}": np.asarray(getattr(tree, f)) for f in tree._fields[:2]}
        out.update({f"{path}.{f}": getattr(tree, f) for f in tree._fields[2:]})
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    if isinstance(tree, tuple):
        return {path: tuple(int(v) for v in tree)}
    return {path: np.asarray(tree)}


def test_params_from_jax_round_trip(gqa):
    """JAX tree (sub-byte packed, fused, bf16 embeddings) -> port -> numpy:
    every buffer and every static field comes back unchanged."""
    jc, _, jp, _ = gqa
    jpk = _np(_jax_packed(jp, jc, subbyte=True, bf16_embed=True))
    want = _flat(jpk)
    got = _flat(params_to_numpy(params_from_jax(jpk, device="cpu")))
    assert want.keys() == got.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            w = w.astype(np.float32) if w.dtype.name == "bfloat16" else w
            assert w.dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_default_device_raises_without_cuda(monkeypatch, gqa):
    from llm_mixed_q_torch import resolve_device
    from llm_mixed_q_torch.models.hf_loader import init_llama_params

    _, tc, _, tp = gqa
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_llama_params(tc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(tp, tc, np.ones((1, 3), np.int32), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatcher(tp, tc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_llama_params(tp, tc)


def test_batcher_layout_fault_pinned():
    """The JAX batcher builds its admission bucket cache with the layout of
    the bucket's length (pos-major at 16 positions) while the live cache of
    max_len 4160 is head-major, and its slot write fails; the port gives the
    bucket cache the live layout."""
    from llm_mixed_q_tpu.models.llama.serving import ContinuousBatcher as JaxBatcher

    jc, tc = _configs(nkv=2)
    jp = jax_init(jc, seed=9)
    prompt = np.array([3, 4, 5])
    srv = JaxBatcher(jp, jc, num_slots=2, max_len=4160, max_new_tokens=2, prompt_bucket=16)
    assert not srv.cache.pos_major
    srv.submit(prompt)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        srv.run()
    tp = params_from_jax(_np(jp), device="cpu")
    srv = ContinuousBatcher(tp, tc, num_slots=2, max_len=4160, max_new_tokens=2,
                            prompt_bucket=16, device="cpu")
    rid = srv.submit(prompt)
    ref = generate(tp, tc, prompt[None, :], max_new_tokens=2, max_len=4160, device="cpu")
    assert srv.run()[rid] == ref[0].tolist()
