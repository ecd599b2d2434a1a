"""Fault 18's repair, held to the JAX package on the CPU: K4 and K5 take
every packed KV cache that the JAX package's decode-attention kernel takes.

The JAX package packs a cache whenever every layer's K/V block divides
head_dim (``kv_cache_pack_spec``) and its kernel takes it within max_len x
head_dim <= 4096 x 128 and 8 query rows a kv head (``attention_kernel_ok``).
Before the repair the port's kernels refused three kinds of such cache on
the card: a head_dim off 4 (2, 6, 10, 18), a K/V block that is neither a
power of two nor the head (12 at 48, 20 at 80, 24 at 96) and a head-major
cache past 1024 dims a head (1280, 2048). Here, for each:

- the route: ``attention_kernel_error`` finds nothing and
  ``packed_decode_route`` sends the cache to the kernels on the card, at
  rep 1 and 8 in both layouts (pos-major at 64 positions, head-major where
  nkv x max_len passes 8192 lanes, within the JAX cap);
- the split: ``k4_tiles`` and ``k5_tiles`` find ring stages and thread
  groups that divide the head and fit its blocks (the C host's checks,
  replayed);
- the arithmetic: the schedule replicas of ``tests/test_torch_k4.py`` and
  ``tests/test_torch_k5.py`` (which split the dims and positions as the
  kernels do) against the TPU kernels in interpret mode at head_dim 6, at
  blocks of 12 at 48 and at 1280 dims on 2 kv heads, and against the
  port's plain versions (themselves held to JAX) at the others, at rtol
  2e-4 / atol 2e-5, the tolerance of those files.

The CUDA kernels are held against their plain versions at these shapes on
the card (``tests/test_torch_cuda_kernels.py`` ``ATTN_CASES``,
``chip_smoke.py --search-only`` part 1).

Fault 21's repair: the caches that JAX's kernel takes and for which K4/K5
found no split that fits in shared memory (``FAULT21``: head-major past
3011 dims at rep 8, pos-major past 65535 dims) now have one, through K5's
scores walking a head in passes of a divisor of it, K5's P . V walking a
chunk once a pass of 1024 dims, and K4 taking every head_dim: their route
is "kernel" under ``attn_kernel=None`` and ``attn_kernel=True``."""

import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import attention_decode as jattn
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import serving as jax_serving
from llm_mixed_q_torch.kernels import attention_decode as ad
from llm_mixed_q_torch.kernels.packing import bfp_encode_lastdim
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig
from llm_mixed_q_torch.models.llama.serving import _uses_kernel, packed_cache_layout
from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq
from test_torch_head_dims import _head_major
from test_torch_k4 import _inputs as k4_inputs
from test_torch_k4 import jax_kernel as k4_jax_kernel
from test_torch_k4 import k4_schedule
from test_torch_k5 import jax_denominator, k5_schedule

RTOL, ATOL = 2e-4, 2e-5
BFP6 = "configs/quantization/bfp_6bit.toml"
CAP = 4096 * 128  # the JAX package's cache cap, max_len * head_dim
# name: (head_dim, the K/V block: the [1, bs] weight block of every layer)
SHAPES = {"hd2": (2, 2), "hd6": (6, 6), "hd10": (10, 10), "hd18": (18, 9),
          "hd36": (36, 12), "bs12_hd48": (48, 12), "bs20_hd80": (80, 20),
          "bs24_hd96": (96, 24), "hd1280": (1280, 16), "hd2048": (2048, 16)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quant_config(bs, prob_bs=16):
    """bfp_6bit.toml with the weight blocks [1, bs] (the K/V cache's) and
    the data_in blocks (the prob quantizer's among them) [1, prob_bs]."""
    with open(BFP6, "rb") as f:
        qc = tomllib.load(f)
    qc["default"]["weight_block_size"] = [1, bs]
    qc["default"]["data_in_block_size"] = [1, prob_bs]
    return qc


def _layouts(hd):
    """(nkv, max_len) of a pos-major cache (64 positions on 2 kv heads) and
    of a head-major one (nkv * max_len past 8192 lanes), both within the JAX
    cap and multiples of the prob block of 16."""
    long = min(256, CAP // hd // 16 * 16)
    return [(2, 64), (8192 // long + 1, long)]


@pytest.mark.parametrize("name", list(SHAPES))
def test_route_takes_the_kernels(name):
    """Both packages pack the cache and JAX's kernel takes it; the port's
    kernels do too, at rep 1 and 8 in both layouts: no limit passed, the
    route "kernel" on the card (where it raised before)."""
    hd, bs = SHAPES[name]
    qc = _quant_config(bs)
    for (nkv, max_len), rep in ((layout, rep) for layout in _layouts(hd) for rep in (1, 8)):
        kw = dict(vocab_size=96, hidden_size=hd * nkv * rep, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=nkv * rep, num_key_value_heads=nkv,
                  max_position_embeddings=max_len)
        jc, tc = JaxConfig(**kw, quant_config=qc), LlamaQuantizedConfig(**kw, quant_config=qc)
        assert tc.head_dim == hd
        spec = jax_serving.kv_cache_pack_spec(jc)
        assert spec == (bs, bs) and jattn.attention_kernel_ok(jc, max_len)
        pos_major, blocks = packed_cache_layout(tc, max_len)
        assert blocks == spec and pos_major == (nkv * max_len <= ad.BATCH_KERNEL_MAX_LANES)
        assert ad.reference_kernel_error(tc, max_len) is None
        assert ad.attention_kernel_error(tc, max_len, pos_major, blocks) is None
        assert ad.packed_decode_route(tc, max_len, pos_major, blocks) == "kernel"


# name: (head_dim, K/V block, prob block, kv heads, rep, max_len): caches
# within JAX's cap for which K4/K5 had no split that fits in shared memory.
# Head-major (nkv x max_len past 8192 lanes) at 3012 dims, rep 8 and a
# scale a code, at 174 positions (prob blocks of 2 tile them) and 160; at
# 5434 dims with one scale a head; pos-major at 65536 dims (K4 took at
# most 65535).
FAULT21 = {"hd3012_s174": (3012, 1, 2, 48, 8, 174), "hd3012_s160": (3012, 1, 16, 52, 8, 160),
           "hd5434_one_scale": (5434, 5434, 16, 86, 8, 96),
           "pos_major_hd65536": (65536, 16, 8, 1, 1, 8)}


@pytest.mark.parametrize("name", list(FAULT21))
def test_fault_21_caches_take_the_kernels(name):
    """Fault 21: JAX packs the cache and its kernel takes it, and so do
    K4/K5 now (the route raised on the card before): the route is "kernel"
    under ``attn_kernel=None`` and True, with K5's scores in passes of a
    divisor of the head."""
    hd, bs, prob_bs, nkv, rep, max_len = FAULT21[name]
    qc = _quant_config(bs, prob_bs)
    kw = dict(vocab_size=96, hidden_size=hd * nkv * rep, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=nkv * rep, num_key_value_heads=nkv,
              max_position_embeddings=max_len)
    jc, tc = JaxConfig(**kw, quant_config=qc), LlamaQuantizedConfig(**kw, quant_config=qc)
    assert tc.head_dim == hd and max_len * hd <= CAP
    spec = jax_serving.kv_cache_pack_spec(jc)
    assert spec == (bs, bs) and jattn.attention_kernel_ok(jc, max_len)
    pos_major, blocks = packed_cache_layout(tc, max_len)
    assert blocks == spec and pos_major == (nkv * max_len <= ad.BATCH_KERNEL_MAX_LANES)
    assert pos_major == (name == "pos_major_hd65536")
    assert ad.reference_kernel_error(tc, max_len) is None
    assert ad.attention_kernel_error(tc, max_len, pos_major, blocks) is None
    if pos_major:
        _check_k4_split(nkv, rep, hd, max_len, bs, bs)
    else:
        _check_k5_split(nkv, rep, hd, max_len, bs, bs)
        assert ad.k5_tiles(nkv, rep, hd, max_len, bs, bs)[1] < hd
    assert ad.packed_decode_route(tc, max_len, pos_major, blocks) == "kernel"
    assert _uses_kernel(tc, max_len, pos_major, blocks, None)
    assert _uses_kernel(tc, max_len, pos_major, blocks, True)


def test_fault_21_edge_is_where_fault_18_left_it():
    """The head-major split at rep 8 and a scale a code keeps all of the
    head in a stage of the scores up to 3011 dims (at 174 positions, the
    JAX cap's longest there), and past it walks the head in passes of its
    longest divisor that fits (1506 of 3012) at the longest T that fits."""
    assert ad.k5_tiles(1, 8, 3011, 174, 1, 1) == (4, 3011, 1, 1)
    t, dims, dgs, pgs = ad.k5_tiles(1, 8, 3012, 174, 1, 1)
    assert dims < 3012 and 3012 % dims == 0 and t >= 4
    _check_k5_split(1, 8, 3012, 174, 1, 1)


def _check_k4_split(nkv, rep, hd, s_len, bs_k, bs_v):
    """k4_tiles' split, as the C host checks it."""
    dims, dgs, pgs = ad.k4_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
    g, p = ad.k4_geometry(nkv, rep, s_len)
    assert 1 <= dims <= 128 and hd % dims == 0 and dims % dgs == 0
    assert all(dims % bs == 0 or bs % dims == 0 for bs in (bs_k, bs_v))
    assert dgs * ((p * g + 3) // 4) <= 256
    assert pgs == 1 or (g % 4 == 0 and pgs * (g // 4) * dims <= 256)


def _check_k5_split(nkv, rep, hd, s_len, bs_k, bs_v):
    """k5_tiles' split, as the C host checks it: a head past 1024 dims
    takes passes of 1024 with one position group; the scores' stage dims
    divide the head and fit the K blocks."""
    t, dims, dgs, pgs = ad.k5_tiles(nkv, rep, hd, s_len, bs_k, bs_v)
    p, _ = ad.k5_geometry(nkv, rep, s_len)
    vw, npass = ad.k5_pv_threads(hd)
    dpg = dims // dgs
    assert hd % dims == 0 and (dims % bs_k == 0 or bs_k % dims == 0)
    assert t & (t - 1) == 0 and t <= p and dims % dgs == 0
    assert dpg % bs_k == 0 or bs_k % dpg == 0
    assert dgs * ((t + 3) // 4) <= 256 and 1 <= pgs * vw <= 256
    assert (npass > 1) == (hd > 1024) and (npass == 1 or pgs == 1)
    assert vw * 4 * npass >= hd


@pytest.mark.parametrize("name", list(SHAPES))
def test_tiles_split_the_head(name):
    """A split for every new shape in both layouts, at rep 1, 3 and 8, with
    its own block, a scale a code and one scale a head, K and V apart."""
    hd, bs = SHAPES[name]
    for (nkv, s_len), rep in ((layout, rep) for layout in _layouts(hd) for rep in (1, 3, 8)):
        for bs_k, bs_v in ((bs, bs), (1, hd), (hd, bs)):
            _check_k4_split(nkv, rep, hd, s_len, bs_k, bs_v)
            _check_k5_split(nkv, rep, hd, s_len, bs_k, bs_v)


# b, nkv, rep, hd, S, bs_k, bs_v, prob block, positions: against the TPU
# kernels in interpret mode (one case ~10 s at most)
JAX_CASES = {
    "hd6": (2, 4, 2, 6, 64, 6, 3, 16, [63, 20]),
    "bs12_hd48": (2, 2, 4, 48, 64, 12, 24, 32, [63, 7]),
    "hd1280": (1, 2, 2, 1280, 32, 16, 20, 16, [31]),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_k4_schedule_at_fault_18_shapes_matches_jax(name):
    """K4's schedule against the TPU pos-major kernel and the plain version."""
    case = JAX_CASES[name]
    b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions = case
    q, cache, pos, prob_q = k4_inputs(*case, seed=hd + 18)
    args = (torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos), bs_k,
            bs_v, nkv, rep, prob_q)
    got = k4_schedule(*args)
    want = k4_jax_kernel(args)
    assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, ad.packed_attention_decode_batch_plain(*args),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_k5_schedule_at_fault_18_shapes_matches_jax(name):
    """K5's schedule against the TPU head-major kernel (with its float32
    denominator) and, with the port's, the plain version."""
    case = JAX_CASES[name]
    b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions = case
    q, cache, pos, prob_q = _head_major(case, seed=hd * 10 + 18)
    want = np.asarray(jattn.packed_attention_decode(
        jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(pos), bs_k, bs_v,
        prob_q=prob_q, interpret=True))
    args = (torch.from_numpy(q), *map(torch.from_numpy, cache), torch.from_numpy(pos), bs_k,
            bs_v, prob_q)
    got = k5_schedule(*args, jax_denominator).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(k5_schedule(*args), ad.packed_attention_decode_plain(*args),
                               rtol=RTOL, atol=ATOL)


# against the plain versions: the other head_dims off 4 and blocks, K5 at
# 2048 dims (T below 32 where P is 32: its prob blocks of 32 by their
# maxima of exp), rep 1, 3 and 8
PLAIN_CASES = {
    "hd2": (2, 2, 8, 2, 64, 2, 1, 16, [63, 9]),
    "hd10": (2, 2, 3, 10, 64, 5, 10, 16, [63, 40]),
    "hd18": (2, 2, 1, 18, 64, 9, 6, 32, [63, 0]),
    "hd36": (2, 2, 8, 36, 64, 12, 4, 16, [63, 33]),
    "bs20_hd80": (2, 2, 1, 80, 64, 20, 40, 64, [63, 17]),
    "bs24_hd96": (1, 2, 8, 96, 64, 24, 12, 16, [63]),
    "hd2048": (1, 2, 8, 2048, 32, 1, 16, 32, [31]),
}


def _port_inputs(b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions, seed):
    """q as serving quantizes it and a cache packed by the port (both
    layouts), from the seed."""
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randn((b, nkv, s_len, hd), generator=g) for _ in range(2))
    kc, ks = bfp_encode_lastdim(k, 6, 8, None, bs_k)
    vc, vs = bfp_encode_lastdim(v, 6, 8, None, bs_v)
    q = _block_fp_qdq(torch.randn((b * nkv * rep, hd), generator=g), 6, 8, None, [1, 16], True)
    flat = lambda t: t.permute(0, 3, 2, 1).reshape(b, t.shape[3], s_len * nkv).contiguous()
    pos_major = (q.reshape(b, nkv * rep, hd), flat(kc), flat(ks), flat(vc), flat(vs))
    head_major = (q.reshape(b, nkv, rep, hd), kc.transpose(2, 3).contiguous(),
                  ks.transpose(2, 3).contiguous(), vc, vs)
    return pos_major, head_major, torch.tensor(positions, dtype=torch.int32), (pbs, 6, 8, None)


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_schedules_at_fault_18_shapes_match_plain(name):
    """K4's and K5's schedules against the plain versions (which the
    wrappers return for CPU tensors)."""
    case = PLAIN_CASES[name]
    b, nkv, rep, hd, s_len, bs_k, bs_v, pbs, positions = case
    pos_major, head_major, pos, prob_q = _port_inputs(*case, seed=hd + 19)
    args = (*pos_major, pos, bs_k, bs_v, nkv, rep, prob_q)
    plain = ad.packed_attention_decode_batch_plain(*args)
    assert torch.isfinite(plain).all() and plain.abs().max() > 0
    torch.testing.assert_close(k4_schedule(*args), plain, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ad.packed_attention_decode_batch_cuda(*args), plain, rtol=0,
                               atol=0)
    args = (*head_major, pos, bs_k, bs_v, prob_q)
    plain = ad.packed_attention_decode_plain(*args)
    torch.testing.assert_close(k5_schedule(*args), plain, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ad.packed_attention_decode_cuda(*args), plain, rtol=0, atol=0)


def test_k5_workspace_holds_the_long_prob_blocks_of_short_tiles():
    """Where ``k5_tiles`` halves T below 32 while P stays 32 or more (2048
    dims at rep 8 and a scale a code), a prob block of 32 is quantized by
    its max of exp, which the workspace then holds: K5's wrapper sizes it
    with T, K4's with P."""
    nkv, rep, hd, s_len = 2, 8, 2048, 256
    p, _ = ad.k5_geometry(nkv, rep, s_len)
    t = ad.k5_tiles(nkv, rep, hd, s_len, 1, 1)[0]
    assert t < 32 <= p
    base = ad.k4_workspace_floats(1, nkv, rep, hd, s_len, None, p, t)
    nh = nkv * rep
    assert ad.k4_workspace_floats(1, nkv, rep, hd, s_len, 32, p, t) == base + nh * s_len // 32
    assert ad.k4_workspace_floats(1, nkv, rep, hd, s_len, 32, p) == base
