"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at edge shapes the serving path does not reach: ragged M, N and K, every
sub-byte width in both sub-byte layouts (K1 and K3), other block sizes, GQA up to rep 8, positions at both ends
of the cache. The probe kernels (P8, P9, P11 of ``llm_mixed_q_torch.tools``)
too: N not a multiple of 32, K not a multiple of the tile, a cache of one
position; and the tiling probes (P4-P7): N off every column tile, a short
last step of packing tiles or of a K band, M in {1, 3, 8, 9, 17}.

Needs an NVIDIA GPU (marker ``cuda``); skips without one. Imports nothing of
JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are the JAX package's own: 1e-4 of max|y| for the matmuls
(float32 sums in another order: K1 sums bf16-exact products on the tensor
cores), rtol 2e-4 / atol 2e-5 for decode attention; and a row's matmul
result is bit-exact whatever M. The attention probe's matmul stage, a dense
sum over every lane of the cache, is held relative to max|ctx|: 1e-4 with
float32 dots, 1e-3 with bf16 dots (a score whose float32 sum lands on the
other side of a bf16 rounding point moves by one bf16 step)."""

import pytest
import torch

from llm_mixed_q_torch import kernels as tk
from llm_mixed_q_torch.kernels import attention_decode as ad
from llm_mixed_q_torch.kernels import dequant_matmul as dm
from llm_mixed_q_torch.kernels import packing as tp
from llm_mixed_q_torch.tools import aprobe as tap
from llm_mixed_q_torch.tools import kprobe as tkp
from llm_mixed_q_torch.tools import ksub as tks
from llm_mixed_q_torch.tools import ktune7b as tkt
from llm_mixed_q_torch.tools import kvariants as tkv
from llm_mixed_q_torch.tools import kvariants2 as tkv2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _qdq(x, bs=16, width=6):
    from llm_mixed_q_torch.ops.quantizers import _block_fp_qdq

    return _block_fp_qdq(x, width, 8, None, [1, bs], True)


def _weight(n, k, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((n, k), generator=g) * 0.05
    w.view(-1)[::37] = 0.0
    return w


def _close_rel(got, want, tol=1e-4):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("m,n,k,bs", [(1, 48, 700, 16), (9, 100, 1100, 32),
                                      (17, 33, 640, 8), (40, 300, 4096, 16)])
@pytest.mark.parametrize("actq", [None, (16, 6, 8, 127), (32, 4, 8, 127)])
def test_subbyte_t_kernel_matches_plain(dev, width, m, n, k, bs, actq):
    packed = tp.pack_block_fp_subbyte_t(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    if actq is None:
        x = _qdq(x)
    before = dm.bfp_matmul_subbyte_t_cuda.launches
    got = dm.bfp_matmul_subbyte_t_cuda(x, packed, actq)
    assert dm.bfp_matmul_subbyte_t_cuda.launches == before + 1
    _close_rel(got, dm.bfp_matmul_plain(x, packed, actq))


@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("m,n,k,bs", [(1, 48, 700, 16), (9, 100, 1100, 32),
                                      (17, 33, 640, 8), (256, 300, 4096, 16)])
@pytest.mark.parametrize("actq", [None, (16, 6, 8, 127), (32, 4, 8, 127), (4, 8, 8, 127)])
def test_subbyte_kernel_matches_plain(dev, width, m, n, k, bs, actq):
    """K3, lane-major words: K short of a whole tile, N not a multiple of
    the 32-column block, M from 1 to the 256 rows bfp_matmul sends."""
    packed = tp.pack_block_fp_subbyte(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    if actq is None:
        x = _qdq(x)
    before = dm.bfp_matmul_subbyte_cuda.launches
    got = dm.bfp_matmul_subbyte_cuda(x, packed, actq)
    assert dm.bfp_matmul_subbyte_cuda.launches == before + 1
    _close_rel(got, dm.bfp_matmul_plain(x, packed, actq))


def test_subbyte_kernel_raises_on_bad_operands(dev):
    packed = tp.pack_block_fp_subbyte(_weight(40, 700, 0).to(dev), 6, 8, None, [1, 16])
    x = torch.randn((3, 700), device=dev)
    on_cpu = packed._replace(words=packed.words.cpu())
    for args, match in (((x, on_cpu), "packed buffers"),
                        ((x.t().contiguous().t(), packed), "contiguous"),
                        ((x[:, :640].contiguous(), packed), "in_features"),
                        ((x, packed, (64, 6, 8, 127)), "does not divide")):
        with pytest.raises(ValueError, match=match):
            dm.bfp_matmul_subbyte_cuda(*args)


@pytest.mark.parametrize("m,n,k,bs,k_stride", [(1, 1, 64, 4, None), (9, 100, 1100, 8, 1024),
                                               (17, 33, 700, 16, None), (40, 300, 4096, 32, 1024),
                                               (8, 64, 1500, 128, None)])
@pytest.mark.parametrize("actq", [None, (16, 6, 8, 127), (4, 8, 8, 127)])
def test_int8_kernel_matches_plain(dev, m, n, k, bs, k_stride, actq):
    packed = tp.pack_block_fp(_weight(n, k, bs).to(dev), 6, 8, None, [1, bs], k_stride=k_stride)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    if actq is None:
        x = _qdq(x)
    before = dm.bfp_matmul_cuda.launches
    got = dm.bfp_matmul_cuda(x, packed, actq)
    assert dm.bfp_matmul_cuda.launches == before + 1
    _close_rel(got, dm.bfp_matmul_plain(x, packed, actq))


@pytest.mark.parametrize("width", [2, 6, 8])
@pytest.mark.parametrize("m,n,k,bs", [(8, 100, 1100, 16), (40, 300, 4096, 16),
                                      (256, 64, 700, 32)])
def test_subbyte_t_kernel_keeps_float32_x(dev, width, m, n, k, bs):
    """Raw float32 x, no quantizer: K1's tensor cores take x as bf16 hi + lo
    terms, and must keep float32 semantics (ROADMAP fault 3) to 1e-4 of
    max|y|."""
    packed = tp.pack_block_fp_subbyte_t(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    _close_rel(dm.bfp_matmul_subbyte_t_cuda(x, packed), dm.bfp_matmul_plain(x, packed))


@pytest.mark.parametrize("actq", [None, (16, 6, 8, 127)])
def test_subbyte_t_kernel_keeps_subnormal_activations(dev, actq):
    """Activations at the bottom of the exponent range: c * 2^-133 with
    |c| < 128, block maxima near 2^-126, all bf16 subnormals (and all under
    the quantizer's 1e-8 passthrough). Weights near 2^100 keep every product
    normal, so only a tensor core that flushed subnormal inputs would lose
    them."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (8, 1100), generator=g).float() * 2.0**-133
    w = torch.randn((64, 1100), generator=g) * 2.0**100
    packed = tp.pack_block_fp_subbyte_t(w.to(dev), 6, 8, None, [1, 16])
    x = x.to(dev)
    want = dm.bfp_matmul_plain(x, packed, actq)
    assert want.abs().max().item() > 2.0**-60
    _close_rel(dm.bfp_matmul_subbyte_t_cuda(x, packed, actq), want)


def test_matmul_rows_do_not_depend_on_the_batch(dev):
    """A row's result is the same bits whatever M and the other rows are
    (what lets the batcher reproduce generate), up to the 256 rows
    bfp_matmul sends to the kernels (K1 takes 8 rows a block at M <= 8 and
    32 above)."""
    x = _qdq(torch.randn((256, 1100), generator=torch.Generator().manual_seed(0))).to(dev)
    w = _weight(200, 1100, 1).to(dev)
    for packed, fn in ((tp.pack_block_fp_subbyte_t(w, 6, 8, None, [1, 16]),
                        dm.bfp_matmul_subbyte_t_cuda),
                       (tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16]),
                        dm.bfp_matmul_subbyte_cuda),
                       (tp.pack_block_fp(w, 6, 8, None, [1, 16], k_stride=1024),
                        dm.bfp_matmul_cuda)):
        full = fn(x, packed, (16, 6, 8, 127))
        for rows in (slice(0, 1), slice(3, 8), slice(5, 22), slice(9, 41), slice(100, 256)):
            part = fn(x[rows].contiguous(), packed, (16, 6, 8, 127))
            torch.testing.assert_close(part, full[rows], rtol=0, atol=0)


def test_long_actq_block_is_quantized_outside_the_kernels(dev):
    """A data_in block longer than the kernels' run of lanes (64 > 32)."""
    x = torch.randn((4, 1024), generator=torch.Generator().manual_seed(3)).to(dev)
    actq = (64, 6, 8, 127)
    w = _weight(64, 1024, 0).to(dev)
    for packed in (tp.pack_block_fp_subbyte_t(w, 6, 8, None, [1, 16]),
                   tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16]),
                   tp.pack_block_fp(w, 6, 8, None, [1, 16])):
        _close_rel(dm.bfp_matmul(x, packed, actq), dm.bfp_matmul_plain(x, packed, actq))


def test_lane_major_subbyte_takes_k3_on_the_card(dev):
    """bfp_matmul sends a PackedBFPSub at M <= 256 to K3 (it raised before
    K3 was ported) and a larger M to unpack + torch.matmul."""
    packed = tp.pack_block_fp_subbyte(_weight(16, 640, 0).to(dev), 6, 8, None, [1, 16])
    tk.reset_launch_counts()
    for m in (2, 256, 257):
        x = _qdq(torch.randn((m, 640), generator=torch.Generator().manual_seed(m))).to(dev)
        _close_rel(dm.bfp_matmul(x, packed), dm.bfp_matmul_plain(x, packed))
    assert tk.launch_counts() == {**dict.fromkeys(tk.KERNEL_WRAPPERS, 0),
                                  "bfp_matmul_subbyte": 2}


def _cache(b, nkv, s_len, hd, bs_k, bs_v, pos_major, dev, seed):
    g = torch.Generator().manual_seed(seed)
    k = torch.randn((b, nkv, s_len, hd), generator=g).to(dev)
    v = torch.randn((b, nkv, s_len, hd), generator=g).to(dev)
    kc, ks = tp.bfp_encode_lastdim(k, 6, 8, None, bs_k)
    vc, vs = tp.bfp_encode_lastdim(v, 6, 8, None, bs_v)
    if pos_major:
        flat = lambda t: t.permute(0, 3, 2, 1).reshape(b, t.shape[3], s_len * nkv).contiguous()
        return flat(kc), flat(ks), flat(vc), flat(vs)
    return (kc.transpose(2, 3).contiguous(), ks.transpose(2, 3).contiguous(),
            vc.contiguous(), vs.contiguous())


ATTN_CASES = [  # b, nkv, rep, hd, s_len, bs_k, bs_v, prob_q
    (2, 2, 1, 128, 64, 16, 16, (16, 6, 8, None)),
    (3, 1, 8, 128, 96, 32, 16, (32, 6, 8, None)),
    (2, 4, 2, 64, 256, 16, 64, None),
    (1, 2, 4, 128, 512, 16, 16, (16, 4, 8, None)),
]


@pytest.mark.parametrize("pos_major", [True, False])
@pytest.mark.parametrize("b,nkv,rep,hd,s_len,bs_k,bs_v,prob_q", ATTN_CASES)
def test_attention_kernels_match_plain(dev, pos_major, b, nkv, rep, hd, s_len, bs_k, bs_v,
                                       prob_q):
    cache = _cache(b, nkv, s_len, hd, bs_k, bs_v, pos_major, dev, seed=s_len)
    q = _qdq(torch.randn((b * nkv * rep, hd), generator=torch.Generator().manual_seed(1)))
    # first position only, last position, and one in between
    positions = torch.tensor([0, s_len - 1, s_len // 3][:b], dtype=torch.int32).to(dev)
    if pos_major:
        q = q.reshape(b, nkv * rep, hd).to(dev)
        fn, plain = ad.packed_attention_decode_batch_cuda, ad.packed_attention_decode_batch_plain
        args = (q, *cache, positions, bs_k, bs_v, nkv, rep, prob_q)
    else:
        q = q.reshape(b, nkv, rep, hd).to(dev)
        fn, plain = ad.packed_attention_decode_cuda, ad.packed_attention_decode_plain
        args = (q, *cache, positions, bs_k, bs_v, prob_q)
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    torch.testing.assert_close(got, plain(*args), rtol=2e-4, atol=2e-5)


def test_launch_counts_reset(dev):
    tk.reset_launch_counts()
    packed = tp.pack_block_fp(_weight(32, 64, 0).to(dev), 6, 8, None, [1, 16])
    dm.bfp_matmul(torch.zeros((3, 64), device=dev), packed)
    counts = tk.launch_counts()
    assert counts["bfp_matmul_int8"] == 1
    assert sum(counts.values()) == 1
    tk.reset_launch_counts()
    assert set(tk.launch_counts().values()) == {0}


# every per_word instance of the transposed probe (widths 2..8), block
# sizes 4..32, N off the 32-column block, K off the packing tile
PROBE_MATMUL_CASES = [  # m, n, k, width, bs
    (8, 100, 700, 6, 16), (3, 33, 1100, 4, 8), (17, 300, 640, 5, 32),
    (8, 48, 4096, 2, 16), (1, 64, 1000, 8, 16), (9, 40, 1300, 3, 16), (8, 70, 900, 7, 4),
]


@pytest.mark.parametrize("layout", ["transposed", "lane_major"])
@pytest.mark.parametrize("variant", tks.VARIANTS)
@pytest.mark.parametrize("m,n,k,width,bs", PROBE_MATMUL_CASES)
def test_subbyte_probe_matches_plain(dev, layout, variant, m, n, k, width, bs):
    packed = tp.pack_block_fp_subbyte(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    if layout == "transposed":
        packed = tp.transpose_subbyte(packed)
    k_pad = dm._k_padded(packed)
    x = torch.randn((m, k_pad), generator=torch.Generator().manual_seed(m)).to(dev)
    for kx in (k_pad, k):  # x over K_pad, as ksub; x of K columns, as K1 and K3 take it
        xs = x[:, :kx].contiguous()
        before = tks.subbyte_probe.launches[layout]
        got = tks.subbyte_probe(xs, packed, variant)
        assert tks.subbyte_probe.launches[layout] == before + 1
        _close_rel(got, tks.subbyte_probe_plain(xs, packed, variant))


@pytest.mark.parametrize("layout", ["transposed", "lane_major"])
def test_subbyte_probe_ship_is_the_production_kernel(dev, layout):
    """On bf16 x with no activation quantizer, ship computes what K1 (K3)
    computes."""
    packed = tp.pack_block_fp_subbyte(_weight(100, 1100, 0).to(dev), 6, 8, None, [1, 16])
    prod = dm.bfp_matmul_subbyte_cuda
    if layout == "transposed":
        packed, prod = tp.transpose_subbyte(packed), dm.bfp_matmul_subbyte_t_cuda
    x = torch.randn((8, 1100), generator=torch.Generator().manual_seed(0)).to(dev)
    x = x.to(torch.bfloat16).float()
    _close_rel(tks.subbyte_probe(x, packed, "ship"), prod(x, packed, None))


PROBE_ATTN_CASES = [  # b, nkv, rep, hd, s_len, bs, positions
    (2, 4, 1, 128, 1, 16, [0, 0]),
    (3, 2, 2, 64, 37, 16, [36, 0, 20]),
    (2, 1, 8, 128, 48, 32, [47, 9]),
    (1, 32, 1, 128, 256, 16, [255]),
]


@pytest.mark.parametrize("stage,dot", [(s, d) for s in tap.STAGES for d in tap.DOTS[s]])
@pytest.mark.parametrize("b,nkv,rep,hd,s_len,bs,positions", PROBE_ATTN_CASES)
def test_attention_probe_matches_plain(dev, stage, dot, b, nkv, rep, hd, s_len, bs, positions):
    cache = _cache(b, nkv, s_len, hd, bs, bs, True, dev, seed=s_len)
    # q quantized as serving quantizes it: the scores are then exact in
    # float32 whatever the order of their sums (as in the K4/K5 test above)
    q = _qdq(torch.randn((b * nkv * rep, hd), generator=torch.Generator().manual_seed(1)))
    q = q.reshape(b, nkv * rep, hd).to(dev)
    pos = torch.tensor(positions, dtype=torch.int32).to(dev)
    args = (q, *cache, pos, stage, dot, bs, bs, nkv, rep, (16, 6, 8, None))
    before = tap.attention_probe.launches
    got = tap.attention_probe(*args)
    assert tap.attention_probe.launches == before + 1
    want = tap.attention_probe_plain(*args)
    if stage in ("dma", "dequant"):
        assert torch.equal(got, q)
    elif stage == "matmul":
        _close_rel(got, want, 1e-4 if dot == "f32" else 1e-3)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


# P1 (v2, v3) and P3 (v4 with float32 or bf16 scales) on both layouts, P2
# (int8 codes, bf16 scales): M in {1, 3, 8, 9, 17}, N off the 32-column
# block, K off the packing tile, x over K_pad and over K columns
@pytest.mark.parametrize("layout", ["transposed", "lane_major"])
@pytest.mark.parametrize("variant", ["v2", "v3", "v4_f32s", "v4_bf16s"])
@pytest.mark.parametrize("m,n,k,width,bs", PROBE_MATMUL_CASES)
def test_variant_probe_matches_plain(dev, layout, variant, m, n, k, width, bs):
    packed = tp.pack_block_fp_subbyte(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    if layout == "transposed":
        packed = tp.transpose_subbyte(packed)
    if variant.startswith("v4"):
        dtype = torch.float32 if variant == "v4_f32s" else torch.bfloat16
        fn, plain, arg = tkv2.sub_variant, tkv2.sub_variant_plain, dtype
    else:
        fn, plain, arg = tkv.matmul_variant, tkv.matmul_variant_plain, variant
    k_pad = dm._k_padded(packed)
    x = torch.randn((m, k_pad), generator=torch.Generator().manual_seed(m)).to(dev)
    for kx in (k_pad, k):
        xs = x[:, :kx].contiguous()
        before = fn.launches[layout]
        got = fn(xs, packed, arg)
        assert fn.launches[layout] == before + 1
        _close_rel(got, plain(xs, packed, arg))


# (3, 5, 92, 4): an odd number of bf16 scales, the last read alone
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,k,bs,k_stride", [(1, 1, 64, 4, None), (9, 100, 1100, 8, 1024),
                                               (17, 33, 700, 16, None), (8, 300, 4096, 32, 1024),
                                               (8, 64, 1500, 128, None), (3, 5, 92, 4, None)])
def test_int8_variant_probe_matches_plain(dev, m, n, k, bs, k_stride, scale_dtype):
    packed = tp.pack_block_fp(_weight(n, k, bs).to(dev), 6, 8, None, [1, bs], k_stride=k_stride)
    k_pad = packed.codes.shape[1]
    x = torch.randn((m, k_pad), generator=torch.Generator().manual_seed(m)).to(dev)
    for kx in (k_pad, k):
        xs = x[:, :kx].contiguous()
        before = tkv2.int8_variant.launches
        got = tkv2.int8_variant(xs, packed, scale_dtype)
        assert tkv2.int8_variant.launches == before + 1
        _close_rel(got, tkv2.int8_variant_plain(xs, packed, scale_dtype))


@pytest.mark.parametrize("layout", ["transposed", "lane_major"])
def test_variant_probes_are_the_production_kernels(dev, layout):
    """On bf16 x with no activation quantizer, v2, v4_f32s and v4_bf16s
    compute exactly what K1 (K3) computes, in the same order; v3 differs by
    its correction's rounding; P2 with either scale type computes what K2
    computes."""
    w = _weight(100, 1100, 0).to(dev)
    packed = tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16])
    prod = dm.bfp_matmul_subbyte_cuda
    if layout == "transposed":
        packed, prod = tp.transpose_subbyte(packed), dm.bfp_matmul_subbyte_t_cuda
    x = torch.randn((8, 1100), generator=torch.Generator().manual_seed(0)).to(dev)
    x = x.to(torch.bfloat16).float()
    want = prod(x, packed, None)
    for got in (tkv.matmul_variant(x, packed, "v2"), tkv2.sub_variant(x, packed, torch.float32),
                tkv2.sub_variant(x, packed, torch.bfloat16)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    _close_rel(tkv.matmul_variant(x, packed, "v3"), want, 1e-5)
    p8 = tp.pack_block_fp(w, 6, 8, None, [1, 16])
    for dt in (torch.bfloat16, torch.float32):
        torch.testing.assert_close(tkv2.int8_variant(x, p8, dt), dm.bfp_matmul_cuda(x, p8, None),
                                   rtol=0, atol=0)


def test_variant_probes_raise_on_bad_operands(dev):
    packed = tp.pack_block_fp_subbyte(_weight(40, 700, 0).to(dev), 6, 8, None, [1, 2])
    x = torch.randn((3, 700), device=dev)
    with pytest.raises(ValueError, match="blocks of 4"):
        tkv.matmul_variant(x, packed, "v2")
    with pytest.raises(ValueError, match="blocks of 4"):
        tkv2.sub_variant(x, packed, torch.float32)
    packed = tp.pack_block_fp_subbyte(_weight(40, 700, 0).to(dev), 6, 8, None, [1, 16])
    with pytest.raises(ValueError, match="uint8"):
        tkv.matmul_variant(x, tkv2.stored_scales(packed, torch.float32), "v2")
    with pytest.raises(ValueError, match="contiguous"):
        tkv.matmul_variant(torch.randn((3, 2000), device=dev), packed, "v3")


# P4/P7 (subbyte_tile): N off every column tile, K off the packing tile, 3
# and 7 packing tiles (a short last step at tps 2 and 4), widths 4-6
TILE_CASES = [  # m, n, k, width, bs
    (8, 100, 700, 6, 16), (1, 48, 1920, 6, 16), (8, 300, 4096, 6, 16), (9, 70, 1300, 4, 8),
    (3, 33, 2600, 5, 32),
]


@pytest.mark.parametrize("instance", list(tkp.SUB_INSTANCES))
@pytest.mark.parametrize("m,n,k,width,bs", TILE_CASES)
def test_subbyte_tile_matches_plain(dev, instance, m, n, k, width, bs):
    cols, tps = tkp.SUB_INSTANCES[instance]
    packed = tp.pack_block_fp_subbyte(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    k_pad = dm._k_padded(packed)
    x = torch.randn((m, k_pad), generator=torch.Generator().manual_seed(m)).to(dev)
    for kx in (k_pad, k):
        xs = x[:, :kx].contiguous()
        before = tkp.subbyte_tile.launches
        got = tkp.subbyte_tile(xs, packed, cols, tps)
        assert tkp.subbyte_tile.launches == before + 1
        _close_rel(got, tkp.subbyte_tile_plain(xs, packed, cols, tps))


# P6/P5 (int8_tile, band_sum): K_pad 64 (one short step), 1100 off every
# step, 2608 (bands of 1024, 1024, 560), 4096; N off every column tile
INT8_TILE_CASES = [  # m, n, k, bs, k_stride
    (1, 1, 64, 4, None), (9, 100, 1100, 8, 1024), (17, 33, 700, 16, None),
    (8, 300, 4096, 32, None), (8, 64, 2600, 16, None),
]


@pytest.mark.parametrize("instance", list(tkt.INT8_INSTANCES))
@pytest.mark.parametrize("m,n,k,bs,k_stride", INT8_TILE_CASES)
def test_int8_tile_matches_plain(dev, instance, m, n, k, bs, k_stride):
    cols, kstep, band = tkt.INT8_INSTANCES[instance]
    packed = tp.pack_block_fp(_weight(n, k, bs).to(dev), 6, 8, None, [1, bs], k_stride=k_stride)
    k_pad = packed.codes.shape[1]
    x = torch.randn((m, k_pad), generator=torch.Generator().manual_seed(m)).to(dev)
    for kx in (k_pad, k):
        xs = x[:, :kx].contiguous()
        before = (tkt.int8_tile.launches, tkt.band_sum.launches)
        got = tkt.int8_tile(xs, packed, cols, kstep, band)
        assert (tkt.int8_tile.launches, tkt.band_sum.launches) == (
            before[0] + 1, before[1] + (band is not None))
        _close_rel(got, tkt.int8_tile_plain(xs, packed, cols, kstep, band))


@pytest.mark.parametrize("bands,m,n", [(1, 8, 100), (4, 8, 4096), (11, 3, 33)])
def test_band_sum_adds_the_bands_in_order(dev, bands, m, n):
    ws = torch.randn((bands, m, n), generator=torch.Generator().manual_seed(bands)).to(dev)
    torch.testing.assert_close(tkt.band_sum(ws), tkt.band_sum_plain(ws), rtol=0, atol=0)


def test_tile_probes_are_the_production_kernels(dev):
    """On bf16 x with no activation quantizer, every subbyte_tile instance
    computes K3's sums and every int8_tile instance without bands K2's, in
    the same order; the band instance adds its bands' sums instead."""
    w = _weight(300, 4096, 0).to(dev)
    x = torch.randn((8, 4096), generator=torch.Generator().manual_seed(0)).to(dev)
    x = x.to(torch.bfloat16).float()
    packed = tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16])
    want = dm.bfp_matmul_subbyte_cuda(x, packed, None)
    for cols, tps in tkp.SUB_INSTANCES.values():
        torch.testing.assert_close(tkp.subbyte_tile(x, packed, cols, tps), want, rtol=0, atol=0)
    p8 = tp.pack_block_fp(w, 6, 8, None, [1, 16])
    want = dm.bfp_matmul_cuda(x, p8, None)
    for cols, kstep, band in tkt.INT8_INSTANCES.values():
        got = tkt.int8_tile(x, p8, cols, kstep, band)
        if band is None:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            _close_rel(got, want, 1e-5)


def test_tile_probes_raise_on_bad_operands(dev):
    packed = tp.pack_block_fp_subbyte(_weight(40, 700, 0).to(dev), 6, 8, None, [1, 16])
    x = torch.randn((3, 700), device=dev)
    with pytest.raises(ValueError, match="no subbyte_tile instance"):
        tkp.subbyte_tile(x, packed, 24, 1)
    with pytest.raises(TypeError, match="lane-major"):
        tkp.subbyte_tile(x, tp.transpose_subbyte(packed), 32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tkp.subbyte_tile(torch.randn((3, 2000), device=dev), packed, 32, 1)
    wide = tp.pack_block_fp_subbyte(_weight(40, 4096, 0).to(dev), 2, 8, None, [1, 16])
    with pytest.raises(RuntimeError, match="CUDA error"):  # 4 tiles of width 2: > 227 KiB
        tkp.subbyte_tile(torch.randn((3, 4096), device=dev), wide, 16, 4)
    p8 = tp.pack_block_fp(_weight(40, 700, 0).to(dev), 6, 8, None, [1, 16])
    with pytest.raises(ValueError, match="no int8_tile instance"):
        tkt.int8_tile(x, p8, 32, 4096)
    with pytest.raises(ValueError, match="multiple of 128"):
        tkt.int8_tile(x, p8, 32, 512, band=1000)
