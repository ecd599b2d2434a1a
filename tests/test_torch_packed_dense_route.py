"""The route of a packed KV cache's decode attention, on the CPU against
the JAX package: ``generate`` and ``ContinuousBatcher`` pack the cache
whenever the quant config permits, on either device, as JAX's do, and
``packed_decode_route`` picks how ``decode_step`` attends over it:

- "kernel" within the kernels' limits (``attention_kernel_error``): the
  wrappers, which launch K4/K5 on the card and compute their plain
  versions on the CPU;
- "dense" (``packed_attention_decode_dense``, counted a layer a call)
  where JAX's kernel refuses the cache too (its ``attention_kernel_ok`` is
  False), as JAX's ``decode_step`` then decodes densely;
- the same route on either device: the kernels take every cache that
  JAX's kernel takes (fault 21's repair, held in
  ``tests/test_torch_fault18.py``).

Eight configs (name: hidden, heads, kv heads, max_len):
``head_dim_48`` (a multiple of 16 that is not a power of two: both take
it at 48 positions), ``head_dim_320`` (past 256: both take it at 48
positions), ``head_dim_6`` (not a multiple of 4, a block of 16 cut to the
head: both take it since fault 18's repair), ``rep_16`` and ``rep_12``
(16 and 12 query rows per kv head: both refuse), ``long_head_dim_48``
(head_dim 48 at 12000 positions, past JAX's cap of 4096 x 128 elements,
within K4/K5's limits), ``long_head_dim_320`` (head_dim 320 at 2048
positions: past JAX's cap, within K4's) and ``long_gqa_cache`` (2 kv
heads, rep 8 at head_dim 128 and 8192 positions, as Llama-3-70B's
attention at 8192: past JAX's cap, within K5's limits). Every max_len is a
multiple of the prob quantizer's block of 16, which both packages'
kernels need.
The route takes the device as an argument, so the CPU shows what the
card does without one.

Tolerances: logits rtol 2e-4 / atol 2e-5, as the attention tests use
(float32 sums in another order); tokens equal."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels.attention_decode import attention_kernel_ok
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import serving as jax_serving
from llm_mixed_q_torch import kernels
from llm_mixed_q_torch.kernels.attention_decode import (
    attention_kernel_error,
    packed_attention_decode_dense,
    packed_decode_route,
    reference_kernel_error,
)
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import (
    ContinuousBatcher,
    LlamaQuantizedConfig,
    decode_step,
    generate,
    prefill_into_cache,
)
from llm_mixed_q_torch.models.llama import serving
from llm_mixed_q_torch.models.llama.serving import (
    PackedKVCache,
    _cache_spec,
    _new_cache,
    init_packed_kv_cache,
    kv_cache_pack_spec,
)

BFP6 = "configs/quantization/bfp_6bit.toml"
VOCAB = 96
# name: (hidden, heads, kv heads, max_len)
CASES = {
    "head_dim_48": (96, 2, 2, 48),
    "head_dim_320": (640, 2, 2, 48),
    "head_dim_6": (12, 2, 2, 48),
    "rep_16": (256, 16, 1, 48),
    "rep_12": (384, 12, 1, 48),
    "long_head_dim_48": (96, 2, 2, 12000),
    "long_head_dim_320": (640, 2, 2, 2048),
    "long_gqa_cache": (2048, 16, 2, 8192),
}
# name: the route, on either device
ROUTES = {
    "head_dim_48": "kernel",
    "head_dim_320": "kernel",
    "head_dim_6": "kernel",
    "rep_16": "dense",
    "rep_12": "dense",
    "long_head_dim_48": "kernel",
    "long_head_dim_320": "kernel",
    "long_gqa_cache": "kernel",
}
DENSE_IN_BOTH = [name for name, route in ROUTES.items() if route == "dense"]
K5 = "packed_attention_decode_cuda"
K4 = "packed_attention_decode_batch_cuda"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, seed=0):
    hidden, heads, nkv, max_len = CASES[name] if name in CASES else name
    kw = dict(vocab_size=VOCAB, hidden_size=hidden, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=heads, num_key_value_heads=nkv,
              max_position_embeddings=max_len)
    jc, tc = JaxConfig(**kw, quant_config=BFP6), LlamaQuantizedConfig(**kw, quant_config=BFP6)
    jp = jax_init(jc, seed=seed)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), max_len


def _prompt(b, n, seed=1):
    return np.random.default_rng(seed).integers(2, VOCAB, size=(b, n)).astype(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_default_cache_is_packed_where_jax_packs(name):
    """``packed_kv=None`` takes JAX's choice: the pack spec, whatever the
    kernels' limits and the device."""
    jc, tc, _, _, max_len = _case(name)
    spec = jax_serving.kv_cache_pack_spec(jc)
    assert spec is not None
    assert _cache_spec(tc, None) == kv_cache_pack_spec(tc) == spec


@pytest.mark.parametrize("name", list(CASES))
def test_route_follows_both_packages_kernels(name):
    """The route (the same on either device), and ``reference_kernel_error``
    as JAX's ``attention_kernel_ok`` says."""
    jc, tc, _, _, max_len = _case(name)
    layout = serving.packed_cache_layout(tc, max_len)
    assert (reference_kernel_error(tc, max_len) is None) == attention_kernel_ok(jc, max_len)
    assert (attention_kernel_error(tc, max_len, *layout) is None) == (ROUTES[name] == "kernel")
    assert packed_decode_route(tc, max_len, *layout) == ROUTES[name]


def _decode_against_jax(name):
    """One decode step on a packed cache after a prefill, in both packages,
    with the kernel wrappers mocked. -> (port logits, JAX logits, K4 mock,
    K5 mock, the port's config)"""
    jc, tc, jp, tp, max_len = _case(name)
    spec = kv_cache_pack_spec(tc)
    ids = _prompt(2, 7)
    mask = np.ones_like(ids)
    jcache = jax_serving.init_packed_kv_cache(jc, 2, max_len, spec)
    _, jcache, jlen = jax.jit(
        lambda p, c: jax_serving.prefill_into_cache(p, ids, mask, c, jc))(jp, jcache)
    tok = np.asarray([[5], [9]], np.int32)
    want, _ = jax.jit(lambda p, c: jax_serving.decode_step(p, tok, c, jlen, jc))(jp, jcache)

    cache = init_packed_kv_cache(tc, 2, max_len, spec)
    assert isinstance(cache, PackedKVCache)
    _, lengths = prefill_into_cache(tp, torch.as_tensor(ids), torch.as_tensor(mask), cache, tc)
    kernels.reset_launch_counts()
    with mock.patch.object(serving, K5, wraps=getattr(serving, K5)) as k5, \
            mock.patch.object(serving, K4, wraps=getattr(serving, K4)) as k4:
        got = decode_step(tp, torch.as_tensor(tok), cache, lengths, tc)
    return got.numpy(), np.asarray(want), k4, k5, tc


@pytest.mark.parametrize("name", DENSE_IN_BOTH)
def test_packed_decode_takes_the_dense_route_as_jax_does(name):
    """Where JAX's kernel refuses the cache too: JAX's logits, through the
    dense route only (one call a layer; no kernel wrapper called)."""
    got, want, k4, k5, tc = _decode_against_jax(name)
    assert not k4.called and not k5.called
    assert packed_attention_decode_dense.calls == tc.num_hidden_layers
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_packed_decode_of_a_head_dim_the_kernels_refuse_on_the_cpu():
    """head_dim 6, which JAX's kernel takes and K4/K5 refused before fault
    18's repair: the K4 wrapper (the cache is pos-major at 48 positions)
    takes every layer, its plain version here, and gives JAX's logits; the
    dense route is not called."""
    got, want, k4, k5, tc = _decode_against_jax("head_dim_6")
    assert k4.call_count == tc.num_hidden_layers and not k5.called
    assert packed_attention_decode_dense.calls == 0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_long_gqa_cache_takes_the_kernels():
    """rep 8 at head_dim 128 and 8192 positions, past JAX's cap: the K5
    wrapper takes every layer (its plain version here) and gives the logits
    of JAX's dense decode; the dense route is not called."""
    got, want, k4, k5, tc = _decode_against_jax("long_gqa_cache")
    assert k5.call_count == tc.num_hidden_layers and not k4.called
    assert packed_attention_decode_dense.calls == 0
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_generate_packs_outside_the_limits_as_jax_does(name):
    """``generate``'s default cache is packed and decodes by its route:
    JAX's tokens, and the float32 fake-quant cache's."""
    jc, tc, jp, tp, max_len = _case(name, seed=3)
    ids = _prompt(2, 6, seed=4)
    new = 4
    want = np.asarray(jax_serving.generate(jp, jc, ids, max_new_tokens=new, max_len=max_len))
    kernels.reset_launch_counts()
    got = generate(tp, tc, ids, max_new_tokens=new, max_len=max_len, device="cpu")
    dense = tc.num_hidden_layers * (new - 1) if ROUTES[name] == "dense" else 0
    assert kernels.launch_counts()["attn_decode_packed_dense"] == dense
    np.testing.assert_array_equal(got, want)
    f32 = generate(tp, tc, ids, max_new_tokens=new, max_len=max_len, packed_kv=False,
                   device="cpu")
    np.testing.assert_array_equal(got, f32)


def test_batcher_packs_outside_the_limits():
    """The batcher's default cache is packed too at head_dim 6 (outside
    the kernels' limits before fault 18's repair), and its rows are JAX's
    batcher's. (At such a
    config a batcher row and ``generate``'s may differ in both packages for
    one prompt: the bucketed prefill quantizes other blocks.)"""
    jc, tc, jparams, tp, _ = _case("head_dim_6", seed=5)
    srv = ContinuousBatcher(tp, tc, num_slots=2, max_len=48, max_new_tokens=4,
                            prompt_bucket=8, device="cpu")
    jsrv = jax_serving.ContinuousBatcher(jparams, jc, num_slots=2, max_len=48,
                                         max_new_tokens=4, prompt_bucket=8)
    assert isinstance(srv.cache, PackedKVCache)
    prompts = [_prompt(1, n, seed=n)[0] for n in (3, 6, 5)]
    rids = [srv.submit(p) for p in prompts]
    jrids = [jsrv.submit(p) for p in prompts]
    out, want = srv.run(), jsrv.run()
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_array_equal(out[rid], want[jrid])


def _blocks_of(bs):
    """bfp_6bit.toml with every [1, 16] block cut to [1, bs]."""
    import tomllib

    with open(BFP6, "rb") as f:
        qc = tomllib.load(f)
    for key in ("weight_block_size", "data_in_block_size"):
        qc["default"][key] = [1, bs]
    return qc


# head_dim, K/V block, kv heads, max_len, the cache's layout: each a cache
# JAX's kernel takes (within its 4096 x 128 cap), pos-major (K4) and
# head-major (K5, nkv * max_len > 8192)
CARD_HEAD_DIMS = [(320, 16, 2, 48, True), (320, 16, 8, 1040, False),
                  (40, 8, 2, 48, True), (40, 8, 8, 2048, False),
                  (8, 16, 2, 48, True), (8, 16, 16, 1024, False)]


@pytest.mark.parametrize("hd,bs,nkv,max_len,pos_major", CARD_HEAD_DIMS,
                         ids=[f"hd{c[0]}_{'k4' if c[4] else 'k5'}" for c in CARD_HEAD_DIMS])
def test_the_card_routes_head_dims_320_40_and_8_to_the_kernels(hd, bs, nkv, max_len, pos_major):
    """A packed cache of head_dim 320, 40 (blocks of 8) or 8 (a block of 16
    cut to the head), which JAX's kernel takes, goes to K4 or K5 by its
    layout on the card, made without a refusal (fault 15's repair)."""
    qc = _blocks_of(bs) if bs != 16 else BFP6
    kw = dict(vocab_size=VOCAB, hidden_size=hd * nkv, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=nkv, num_key_value_heads=nkv,
              max_position_embeddings=max_len)
    jc, tc = JaxConfig(**kw, quant_config=qc), LlamaQuantizedConfig(**kw, quant_config=qc)
    spec = kv_cache_pack_spec(tc)
    assert spec == jax_serving.kv_cache_pack_spec(jc) == (min(bs, hd),) * 2
    assert serving.packed_cache_layout(tc, max_len) == (pos_major, spec)
    assert attention_kernel_ok(jc, max_len)
    assert attention_kernel_error(tc, max_len, pos_major, spec) is None
    assert packed_decode_route(tc, max_len, pos_major, spec) == "kernel"
    cache = _new_cache(tc, 1, max_len, spec, torch.device("cpu"))
    assert isinstance(cache, PackedKVCache) and cache.pos_major == pos_major


@pytest.mark.parametrize("pos_major", [True, False])
def test_within_the_limits_the_kernels_take_the_cache(pos_major):
    """Nothing that reached K4/K5 before reaches the dense route now: a
    cache within the limits goes to the kernel wrapper of its layout."""
    _, tc, _, tp, _ = _case((256, 2, 2, 4160))
    max_len = 64 if pos_major else 4160
    assert attention_kernel_error(tc, max_len, pos_major, kv_cache_pack_spec(tc)) is None
    cache = init_packed_kv_cache(tc, 1, max_len, kv_cache_pack_spec(tc))
    assert cache.pos_major == pos_major
    ids = torch.as_tensor(_prompt(1, 5))
    _, lengths = prefill_into_cache(tp, ids, torch.ones_like(ids), cache, tc)
    name = K4 if pos_major else K5
    kernels.reset_launch_counts()
    with mock.patch.object(serving, name, wraps=getattr(serving, name)) as wrapper:
        decode_step(tp, torch.tensor([[7]]), cache, lengths, tc)
    assert wrapper.call_count == tc.num_hidden_layers
    assert kernels.launch_counts()["attn_decode_packed_dense"] == 0


def test_reset_sets_the_dense_route_count_to_zero():
    packed_attention_decode_dense.calls = 5
    assert kernels.launch_counts()["attn_decode_packed_dense"] == 5
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.launch_counts()) == {*kernels.KERNEL_WRAPPERS, "attn_decode_packed_dense"}
