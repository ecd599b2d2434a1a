"""``attn_kernel`` on Llama's ``decode_step`` and ``generate``, on the CPU
against the JAX package.

The JAX package's ``attn_kernel`` forces the route of decode attention:
True its Pallas kernels (interpreted off the TPU), False the dense
dequantize + einsum route on the packed codes, None its own choice (dense
off the TPU). The port takes the same argument: True calls the K4/K5
wrappers (their plain versions for CPU tensors), False the counted dense
route (``packed_attention_decode_dense``), None ``packed_decode_route``.

A tiny Llama (2 layers, hidden 64, 4 heads over 2 kv heads, head_dim 16)
under ``bfp_6bit.toml``, its tree the JAX package's through
``params_from_jax``, its prompts ragged from a numpy seed, one intra-op
thread. Two caches: pos-major at 64 positions (K4's layout), and
head-major at 4112 positions, the smallest multiple of the prob block of
16 whose nkv * max_len passes the 8192 lanes of the pos-major layout
(K5's).

Tolerances: logits within 1e-4 of max|logit| (float32 sums in another
order), as ``tests/test_torch_llama.py`` holds a decode step; greedy tokens
equal. The port's softmax denominator is a float64 sum (ROADMAP fault 5),
which could flip a rounding of the prob quantizer against JAX's float32
one; no flip occurs at these inputs."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import serving as jax_serving
from llm_mixed_q_torch.kernels import attention_decode as ad
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig, decode_step, generate
from llm_mixed_q_torch.models.llama import serving
from llm_mixed_q_torch.models.llama.serving import (
    init_kv_cache,
    init_packed_kv_cache,
    kv_cache_pack_spec,
    prefill_into_cache,
)

BFP6 = "configs/quantization/bfp_6bit.toml"
KW = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=8192)
LAYERS = KW["num_hidden_layers"]
MAX_LEN = {"pos_major": 64, "head_major": 4112}
LENGTHS = (8, 5)  # the ragged prompts, right-padded to 8
NEW = 6
TOL = 1e-4  # of max|logit|
ROUTES = [True, False]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(LENGTHS), max(LENGTHS)), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(LENGTHS):
        ids[i, :n] = rng.integers(2, KW["vocab_size"], size=n)
        mask[i, :n] = 1
    return ids, mask


@pytest.fixture(scope="module")
def model():
    jc = JaxConfig(**KW, quant_config=BFP6)
    tc = LlamaQuantizedConfig(**KW, quant_config=BFP6)
    jp = jax_init(jc, seed=0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _close_to_max(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


def _jax_step(jc, jp, layout, attn_kernel):
    """JAX's logits of one decode step after the prefill, on its packed cache."""
    ids, mask = _prompts()
    cache = jax_serving.init_packed_kv_cache(jc, len(LENGTHS), MAX_LEN[layout],
                                             jax_serving.kv_cache_pack_spec(jc))
    assert cache.pos_major == (layout == "pos_major")
    logits, cache, lengths = jax.jit(lambda p, c: jax_serving.prefill_into_cache(
        p, ids, mask, c, jc))(jp, cache)
    tok = jax.numpy.argmax(logits, -1)[:, None].astype(jax.numpy.int32)
    step, _ = jax.jit(lambda p, c: jax_serving.decode_step(
        p, tok, c, lengths, jc, attn_kernel=attn_kernel))(jp, cache)
    return np.asarray(step)


def _port_cache(tc, tp, layout):
    """(token, cache, lengths) after the port's prefill."""
    ids, mask = (torch.from_numpy(a.astype(np.int64)) for a in _prompts())
    cache = init_packed_kv_cache(tc, len(LENGTHS), MAX_LEN[layout], kv_cache_pack_spec(tc),
                                 "cpu")
    assert cache.pos_major == (layout == "pos_major")
    logits, lengths = prefill_into_cache(tp, ids, mask, cache, tc)
    return logits.argmax(-1)[:, None], cache, lengths


@pytest.mark.parametrize("attn_kernel", ROUTES, ids=["kernel", "dense"])
@pytest.mark.parametrize("layout", list(MAX_LEN))
def test_decode_step_matches_jax(model, layout, attn_kernel):
    """True against JAX's interpreted Pallas kernels, False against its
    dense route."""
    jc, tc, jp, tp = model
    tok, cache, lengths = _port_cache(tc, tp, layout)
    got = decode_step(tp, tok, cache, lengths, tc, attn_kernel=attn_kernel).numpy()
    _close_to_max(got, _jax_step(jc, jp, layout, attn_kernel))


@pytest.mark.parametrize("attn_kernel", ROUTES, ids=["kernel", "dense"])
@pytest.mark.parametrize("layout", list(MAX_LEN))
def test_greedy_generate_gives_jax_tokens(model, layout, attn_kernel):
    jc, tc, jp, tp = model
    ids, mask = _prompts()
    want = np.asarray(jax_serving.generate(jp, jc, ids, mask, max_new_tokens=NEW,
                                           max_len=MAX_LEN[layout], attn_kernel=attn_kernel))
    got = generate(tp, tc, ids, mask, max_new_tokens=NEW, max_len=MAX_LEN[layout],
                   attn_kernel=attn_kernel, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_the_two_routes_agree(model):
    """On one packed cache, the kernel route and the dense route give the
    same logits (the wrappers' plain versions are the dense route's
    arithmetic, read from the codes)."""
    _, tc, _, tp = model
    out = []
    for attn_kernel in ROUTES:
        tok, cache, lengths = _port_cache(tc, tp, "head_major")
        out.append(decode_step(tp, tok, cache, lengths, tc, attn_kernel=attn_kernel).numpy())
    _close_to_max(out[0], out[1])


@pytest.mark.parametrize("attn_kernel", [None, True, False], ids=["auto", "kernel", "dense"])
@pytest.mark.parametrize("layout", list(MAX_LEN))
def test_the_route_taken(model, layout, attn_kernel):
    """Spies on the wrappers: True calls the layout's kernel wrapper once a
    layer and never the dense route; False the reverse (its calls
    counted); None routes by ``packed_decode_route``, which takes the
    wrappers within the kernels' limits on either device."""
    _, tc, _, tp = model
    tok, cache, lengths = _port_cache(tc, tp, layout)
    wrapper = ("packed_attention_decode_batch_cuda" if layout == "pos_major"
               else "packed_attention_decode_cuda")
    other = ({"packed_attention_decode_batch_cuda", "packed_attention_decode_cuda"}
             - {wrapper}).pop()
    spies = {name: mock.patch.object(serving, name, wraps=getattr(serving, name))
             for name in (wrapper, other, "packed_attention_decode_dense")}
    ad.packed_attention_decode_dense.calls = 0
    with spies[wrapper] as kernel, spies[other] as unused, \
            spies["packed_attention_decode_dense"] as dense:
        decode_step(tp, tok, cache, lengths, tc, attn_kernel=attn_kernel)
    expect_kernel = attn_kernel is not False
    assert (kernel.call_count, dense.call_count) == ((LAYERS, 0) if expect_kernel
                                                     else (0, LAYERS))
    assert unused.call_count == 0
    assert ad.packed_attention_decode_dense.calls == (0 if expect_kernel else LAYERS)


def test_kernel_on_a_float32_cache_raises_as_jax_does(model):
    jc, tc, jp, tp = model
    msg = "attn_kernel=True requires a packed KV cache"
    ids, mask = _prompts()
    cache = jax_serving.init_kv_cache(jc, len(LENGTHS), 16)
    _, cache, lengths = jax.jit(lambda p, c: jax_serving.prefill_into_cache(
        p, ids, mask, c, jc))(jp, cache)
    tok = np.zeros((len(LENGTHS), 1), np.int32)
    with pytest.raises(ValueError, match=msg):
        jax_serving.decode_step(jp, tok, cache, lengths, jc, attn_kernel=True)
    cache = init_kv_cache(tc, len(LENGTHS), 16)
    _, lengths = prefill_into_cache(tp, torch.from_numpy(ids.astype(np.int64)),
                                    torch.from_numpy(mask.astype(np.int64)), cache, tc)
    with pytest.raises(ValueError, match=msg):
        decode_step(tp, torch.zeros((len(LENGTHS), 1), dtype=torch.int64), cache, lengths, tc,
                    attn_kernel=True)


def test_generate_on_a_float32_cache_raises_before_the_prefill(model):
    _, tc, _, tp = model
    ids, mask = _prompts()
    with mock.patch.object(serving, "prefill_into_cache") as prefill, \
            pytest.raises(ValueError, match="requires a packed KV cache"):
        generate(tp, tc, ids, mask, max_new_tokens=2, packed_kv=False, attn_kernel=True,
                 device="cpu")
    prefill.assert_not_called()


# caches the kernels refuse (``attention_kernel_error``): a prob block of 16
# that does not tile 40 positions; 12 query rows a kv head (hidden 96, 12
# heads over 1: head_dim 8)
REFUSED = {"untiled_prob_block": (KW, 40),
           "rep_12": (dict(KW, hidden_size=96, num_attention_heads=12,
                           num_key_value_heads=1), 32)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_where_the_kernels_refuse_raises_with_the_reason(case):
    kw, max_len = REFUSED[case]
    tc = LlamaQuantizedConfig(**kw, quant_config=BFP6)
    tp = params_from_jax(jax.tree.map(np.asarray, jax_init(JaxConfig(**kw, quant_config=BFP6),
                                                           seed=0)), device="cpu")
    spec = kv_cache_pack_spec(tc)
    pos_major = serving.packed_cache_layout(tc, max_len)[0]
    reason = ad.attention_kernel_error(tc, max_len, pos_major, spec)
    assert reason is not None
    cache = init_packed_kv_cache(tc, 1, max_len, spec, "cpu")
    ids = torch.full((1, 4), 5, dtype=torch.int64)
    _, lengths = prefill_into_cache(tp, ids, torch.ones_like(ids), cache, tc)
    with pytest.raises(ValueError) as err:
        decode_step(tp, ids[:, :1], cache, lengths, tc, attn_kernel=True)
    assert reason in str(err.value)
    with mock.patch.object(serving, "prefill_into_cache") as prefill, \
            pytest.raises(ValueError) as err:
        generate(tp, tc, ids, max_new_tokens=2, max_len=max_len, attn_kernel=True, device="cpu")
    assert reason in str(err.value)
    prefill.assert_not_called()
    # False takes the dense route on the same cache
    ad.packed_attention_decode_dense.calls = 0
    logits = decode_step(tp, ids[:, :1], cache, lengths, tc, attn_kernel=False)
    assert torch.isfinite(logits).all()
    assert ad.packed_attention_decode_dense.calls == tc.num_hidden_layers
