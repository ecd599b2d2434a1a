"""K4 and K5 at head_dims that are not powers of two, held to the JAX
package on the CPU.

The JAX package's decode-attention kernel takes any head_dim whose K/V
block divides it, within its cap of 4096 x 128 cache elements; every
quant config of ``configs/quantization/`` packs a cache in blocks of 16,
so a Llama-family model at head_dim 48, 80, 96, 112 or 320 (or 8, a block
of 16 cut to the head) decodes its packed cache through that kernel, and
a config with blocks of 8 at head_dim 40. K4 and K5 take every head_dim
and every block that divides it (fault 18's repair: the off-4 head_dims,
the other blocks and K5 past 1024 dims are in ``tests/test_torch_fault18.py``):
the C host splits such a head_dim into ring stages and dim groups that
divide it (``ad.k4_tiles``, ``ad.k5_tiles``; K4's stage 80 of 320's dims,
40 of 40's, 8 of 8's), and K5's P . V idles the threads past its last
whole position group. A power of two keeps the split it always had.

The schedule replicas of ``tests/test_torch_k4.py`` and
``tests/test_torch_k5.py`` (which split the dims and positions as the
kernels do) are held against the TPU kernels in interpret mode and against
the port's plain versions at rtol 2e-4 / atol 2e-5, the tolerance of those
files; generation at head_dim 80 gives the JAX package's tokens. The CUDA
kernels are held against their plain versions at these head_dims on the
card (``chip_smoke.py --search-only``, part 1)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import attention_decode as jattn
from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import serving as jax_serving
from llm_mixed_q_tpu.ops.quantizers import _block_fp_qdq as _jax_qdq
from llm_mixed_q_torch import kernels
from llm_mixed_q_torch.kernels import attention_decode as ad
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig, generate
from llm_mixed_q_torch.models.llama.serving import packed_cache_layout
from test_torch_k4 import _inputs as k4_inputs
from test_torch_k4 import jax_kernel as k4_jax_kernel
from test_torch_k4 import k4_schedule
from test_torch_k5 import jax_denominator, k5_schedule

RTOL, ATOL = 2e-4, 2e-5
BFP6 = "configs/quantization/bfp_6bit.toml"
# b, nkv, rep, hd, S, bs_k, bs_v, prob block, positions: 64-256
# positions, rep 1 and 4, K blocks of 16 and of 32 (96 = 3 x 32)
CASES = [
    (2, 4, 1, 48, 128, 16, 16, 16, [127, 70]),
    (2, 2, 4, 48, 64, 16, 16, 32, [63, 0]),
    (2, 4, 1, 80, 64, 16, 16, 16, [63, 33]),
    (2, 2, 4, 80, 128, 16, 16, 64, [127, 100]),
    (2, 4, 1, 96, 64, 32, 16, 16, [63, 20]),
    (1, 2, 4, 96, 256, 16, 32, 16, [200]),
    # past 256 (K4: four stages of 80 dims; K5: 5 dim groups, 3 position
    # groups of 80 threads), and off 16 with blocks of 8 (40: V codes by
    # 4-byte copies) and a head of 8
    (2, 2, 1, 320, 64, 16, 16, 16, [63, 20]),
    (2, 2, 4, 40, 64, 8, 8, 16, [63, 7]),
    (2, 4, 2, 8, 128, 8, 8, 32, [127, 50]),
]
IDS = [f"hd{c[3]}_rep{c[2]}" for c in CASES]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k4_at_head_dim(case):
    """K4's schedule against the TPU pos-major kernel and the plain version."""
    b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions = case
    q, cache, pos, prob_q = k4_inputs(*case, seed=hd + rep)
    args = (torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos), bs_k,
            bs_v, nkv, rep, prob_q)
    got = k4_schedule(*args)
    want = k4_jax_kernel(args)
    assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, ad.packed_attention_decode_batch_plain(*args),
                               rtol=RTOL, atol=ATOL)


def _head_major(case, seed):
    """A head-major cache packed by the JAX package and q as serving
    quantizes it, from the seed."""
    b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions = case
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((b, nkv, s_len, hd)).astype(np.float32) for _ in range(2))
    kc, ks = jp.bfp_encode_lastdim(jnp.asarray(k), 6, 8, None, bs_k)
    vc, vs = jp.bfp_encode_lastdim(jnp.asarray(v), 6, 8, None, bs_v)
    t = lambda a: np.ascontiguousarray(np.asarray(a).transpose(0, 1, 3, 2))
    q = rng.standard_normal((b * nkv * rep, hd)).astype(np.float32)
    q = np.array(_jax_qdq(jnp.asarray(q), 6, 8, None, [1, 16], True)).reshape(b, nkv, rep, hd)
    cache = [t(kc), t(ks), np.asarray(vc), np.asarray(vs)]
    prob_q = None if pbs is None else (pbs, 6, 8, None)
    return q, cache, np.array(positions, np.int32), prob_q


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k5_at_head_dim(case):
    """K5's schedule against the TPU head-major kernel (with its float32
    denominator) and, with the port's, the plain version; the wrapper on
    CPU tensors is the plain version."""
    b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions = case
    q, cache, pos, prob_q = _head_major(case, seed=hd * 10 + rep)
    want = np.asarray(jattn.packed_attention_decode(
        jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(pos), bs_k, bs_v,
        prob_q=prob_q, interpret=True))
    args = (torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos), bs_k,
            bs_v, prob_q)
    got = k5_schedule(*args, jax_denominator).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = ad.packed_attention_decode_plain(*args)
    torch.testing.assert_close(k5_schedule(*args), plain, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ad.packed_attention_decode_cuda(*args), plain, rtol=0, atol=0)


@pytest.mark.parametrize("nkv,rep,s_len,bs_k,bs_v", [
    (32, 1, 256, 16, 16), (8, 4, 1024, 16, 16), (1, 8, 8192, 16, 16), (32, 8, 256, 16, 16),
    (5, 3, 128, 8, 32), (2, 1, 64, 4, 128), (4, 1, 2048, 1, 16), (8, 8, 4096, 1, 2)])
def test_power_of_two_head_dims_keep_their_split(nkv, rep, s_len, bs_k, bs_v):
    """At head_dim 16-256, a power of two, the split is the one the kernels
    had: K4's stage a power of two up to min(hd, 128), its dim groups the largest power of two <= min(256 / quads,
    dims); K5's dim groups
    the largest power of two <= min(256 / quads, hd) and 256 / (hd / 4)
    position groups."""
    for hd in (16, 32, 64, 128, 256):
        if hd % bs_k or hd % bs_v:
            continue
        dims, dgs, pgs = ad.k4_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
        g, p = ad.k4_geometry(nkv, rep, s_len)
        # min(hd, 128), halved where two stages would not fit (256 query
        # rows a block, a scale a code)
        assert dims & (dims - 1) == 0 and dims <= min(hd, 128)
        nq = (p * g + 3) // 4
        old = 1
        while 2 * old * nq <= 256 and 2 * old <= dims:
            old *= 2
        assert dgs == old
        t, dims5, dgs5, pgs5 = ad.k5_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
        assert dims5 == hd
        nq5, old5 = (t + 3) // 4, 1
        while 2 * old5 * nq5 <= 256 and 2 * old5 <= hd:
            old5 *= 2
        assert (dgs5, pgs5) == (old5, 256 // (hd // 4)) and 256 % (hd // 4) == 0


@pytest.mark.parametrize("head_dims", [range(16, 65, 16), range(80, 129, 16),
                                       range(144, 193, 16), range(208, 257, 16)],
                         ids=["16-64", "80-128", "144-192", "208-256"])
def test_every_multiple_of_16_splits_evenly(head_dims):
    """Every multiple of 16 up to 256 has a K4 stage and K5 groups that
    divide it, whose runs fit the K/V scale blocks of every block size that
    divides it; the kernels take it at rep 1-8."""
    for hd, rep in itertools.product(head_dims, (1, 3, 8)):
        blocks = [bs for bs in (1, 2, 4, 8, 16, 32, 64, 128, 256) if hd % bs == 0]
        assert ad.kernel_shape_error(rep, hd) is None
        for bs_k in blocks:
            for bs_v in blocks[:3] + blocks[-1:]:
                dims, dgs, _ = ad.k4_tiles(4, rep, hd, 256, bs_k, bs_v)
                assert hd % dims == 0 and dims % 16 == 0 and dims % dgs == 0
                assert all(dims % bs == 0 or bs % dims == 0 for bs in (bs_k, bs_v))
                t, dims5, dgs5, pgs5 = ad.k5_tiles(4, rep, hd, 512, bs_k, bs_v)
                assert dims5 == hd
                dpg = hd // dgs5
                assert hd % dgs5 == 0 and (dpg % bs_k == 0 or bs_k % dpg == 0)
                assert 1 <= pgs5 * (hd // 4) <= 256 and t >= 1


@pytest.mark.parametrize("rep,hd,reason", [(9, 80, "query rows")])
def test_what_the_kernels_still_refuse(rep, hd, reason):
    """Outside the limits: more than 8 query rows a kv head (which the JAX
    package's kernel refuses too), and a scale block that does not divide
    the head. Since fault 18's repair the head_dims off 4 (2, 6, 90) and K5
    past 1024 dims (1040) are taken, and so is a block that is neither a
    power of two nor the head (12 at head_dim 48)."""
    assert reason in ad.kernel_shape_error(rep, hd)
    for hd_taken in (2, 6, 90, 1040):
        assert ad.kernel_shape_error(1, hd_taken) is None
    assert "scale block" in ad.kernel_block_error(48, 7, 16)
    assert ad.kernel_block_error(48, 12, 16) is None
    assert ad.kernel_block_error(12, 12, 4) is None


def _llama(hidden, heads, nkv, max_len, seed):
    kw = dict(vocab_size=96, hidden_size=hidden, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=heads, num_key_value_heads=nkv,
              max_position_embeddings=max_len)
    jc, tc = JaxConfig(**kw, quant_config=BFP6), LlamaQuantizedConfig(**kw, quant_config=BFP6)
    jparams = jax_init(jc, seed=seed)
    return jc, tc, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("hidden,heads,nkv", [(96, 2, 2), (320, 4, 2), (384, 4, 4)],
                         ids=["hd48", "hd80", "hd96"])
def test_the_card_routes_these_head_dims_to_the_kernels(hidden, heads, nkv):
    """The packed cache of such a config goes to K4/K5 on the card (and to
    their wrappers' plain versions on the CPU), where JAX's kernel takes
    it too."""
    jc, tc, _, _ = _llama(hidden, heads, nkv, 256, seed=0)
    assert jattn.attention_kernel_ok(jc, 256) and jax_serving.kv_cache_pack_spec(jc)
    for max_len in (64, 256):
        layout = packed_cache_layout(tc, max_len)
        assert ad.attention_kernel_error(tc, max_len, *layout) is None
        assert ad.packed_decode_route(tc, max_len, *layout) == "kernel"


def test_generate_at_head_dim_80_matches_jax():
    """Greedy tokens at head_dim 80 (hidden 320, 4 heads over 2 kv heads)
    over the default packed cache, through the kernel wrappers (their plain
    versions here) and never the dense route: the JAX package's tokens."""
    max_len = 48
    jc, tc, jparams, tparams = _llama(320, 4, 2, max_len, seed=7)
    ids = np.random.default_rng(8).integers(2, 96, size=(2, 9)).astype(np.int32)
    want = np.asarray(jax_serving.generate(jparams, jc, ids, max_new_tokens=5, max_len=max_len))
    kernels.reset_launch_counts()
    got = generate(tparams, tc, ids, max_new_tokens=5, max_len=max_len, device="cpu")
    assert kernels.launch_counts()["attn_decode_packed_dense"] == 0
    np.testing.assert_array_equal(got, want)
