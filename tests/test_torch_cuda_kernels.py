"""The port's CUDA kernels against their plain PyTorch versions, on the card,
at edge shapes the serving path does not reach: ragged M, N and K, every
sub-byte width in both sub-byte layouts (K1 and K3), other block sizes, GQA up to rep 8, positions at both ends
of the cache; K4 at the Llama-2-7B shape and at GQA's 8192 lanes, positions
at its chunk edges, prob blocks from 1 to S, a batch element's ctx the same
bits alone and in a batch of 8; K5 the same, and at 4096 positions (rep 1
and GQA rep 4), a scale a K code, runs off 16 bytes and operands off 16
bytes (element copies), and its refusals of bad operands; K2 at weight blocks 1 and 2. The probe kernels (P8, P9, P11 of ``llm_mixed_q_torch.tools``)
too: N not a multiple of 32, K not a multiple of the tile, a cache of one
position; the tiling probes (P4-P7): N off every column tile, a short
last step of packing tiles or of a K band, M in {1, 3, 8, 9, 17}; P12 and
P13 at batch 1, 3 and 32, positions 0, 15, 16 and 100, rep 2 with a short
last block; P10 with L off its 256-column tile and off its 4-column loads,
and misaligned codes. Since fault 18's repair K4 and K5 also at head_dims
off 4, K/V blocks that are not powers of two and K5 past 1024 dims; and K2
and K3, whose matmul starts as ``actq_split``'s programmatic dependent,
on one workspace over 200 unsynchronised calls (each output its own x's,
bit for bit) and with a lo term in one 512-K chunk of one row.

Needs an NVIDIA GPU (marker ``cuda``); skips without one. Imports nothing of
JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are the JAX package's own: 1e-4 of max|y| for the matmuls
(float32 sums in another order: K1, K2 and K3 sum bf16-exact products on
the tensor cores, raw float32 x as bf16 hi + lo), rtol 2e-4 / atol 2e-5
for decode attention; a row's matmul result is bit-exact whatever M, and
the prologue of K2 and K3, ``actq_split``, equals its plain version bit
for bit. The probe copies of K2's former CUDA-core design (P2,
``int8_tile``) equal its c32_k512 instance bit for bit, and K2 is within
1e-5 of max|y| of it (the same exact products summed in another order);
the lane-major probe copies of K3's former CUDA-core design (P9's ship,
P1's v2, P3's v4, every ``subbyte_tile`` instance) equal its c32_t1
instance bit for bit, and K3 is within 1e-5 of max|y| of it. The attention probe's matmul stage, a dense
sum over every lane of the cache, is held relative to max|ctx|: 1e-4 with
float32 dots, 1e-3 with bf16 dots (a score whose float32 sum lands on the
other side of a bf16 rounding point moves by one bf16 step). P10 equals
its plain version bit for bit (exact products summed in the same order)."""

from unittest import mock

import pytest
import torch

from llm_mixed_q_torch import kernels as tk
from llm_mixed_q_torch.kernels import attention_decode as ad
from llm_mixed_q_torch.kernels import dequant_matmul as dm
from llm_mixed_q_torch.kernels import packing as tp
from llm_mixed_q_torch.tools import aprobe as tap
from llm_mixed_q_torch.tools import k3 as tk3
from llm_mixed_q_torch.tools import kexp as tkx
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


# N >= 8448 takes K3's 32-column blocks on 132 SMs, smaller N its 16-column
# ones; block sizes 1 to 128 (at 128 and width 6, N = 301 leaves the scale
# runs off 4-byte copies, N = 8500 off 16-byte ones)
SUBBYTE_CASES = [  # m, n, k, bs
    (1, 48, 700, 16), (9, 100, 1100, 32), (17, 33, 640, 8), (256, 300, 4096, 16),
    (8, 40, 1300, 1), (256, 64, 2000, 4), (8, 301, 1300, 128), (3, 8500, 700, 128),
    (20, 8448, 1024, 4), (5, 20, 900, 2),
]


@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("m,n,k,bs", SUBBYTE_CASES)
@pytest.mark.parametrize("actq", [None, "raw", (16, 6, 8, 127), (32, 4, 8, 127), (4, 8, 8, 127)])
def test_subbyte_kernel_matches_plain(dev, width, m, n, k, bs, actq):
    """K3 (actq_split, then the tensor-core matmul), lane-major words: K
    short of a whole tile, N not a multiple of the column block, M from 1 to
    the 256 rows bfp_matmul sends, on quantized x, on raw float32 x ("raw":
    no quantizer, hi and lo products) and with the quantizer in the call."""
    packed = tp.pack_block_fp_subbyte(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    if actq is None:
        x = _qdq(x)
    elif actq == "raw":
        actq = None
    before = (dm.bfp_matmul_subbyte_cuda.launches, dm.actq_split_cuda.launches)
    got = dm.bfp_matmul_subbyte_cuda(x, packed, actq)
    assert (dm.bfp_matmul_subbyte_cuda.launches, dm.actq_split_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    _close_rel(got, dm.bfp_matmul_plain(x, packed, actq))


def test_subbyte_kernel_takes_misaligned_buffers(dev):
    """Words 4 bytes off 16 (4-byte copies) and scale bytes at an odd
    address (plain loads)."""
    packed = tp.pack_block_fp_subbyte(_weight(100, 1100, 3).to(dev), 6, 8, None, [1, 16])
    words = torch.empty(packed.words.numel() + 1, dtype=torch.int32, device=dev)[1:]
    words = words.view(packed.words.shape).copy_(packed.words.view(torch.int32))
    scales = torch.empty(packed.scales.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    scales = scales.view(packed.scales.shape).copy_(packed.scales)
    odd = packed._replace(words=words.view(torch.uint32), scales=scales)
    x = torch.randn((9, 1100), generator=torch.Generator().manual_seed(9)).to(dev)
    _close_rel(dm.bfp_matmul_subbyte_cuda(x, odd, (16, 6, 8, 127)),
               dm.bfp_matmul_plain(x, packed, (16, 6, 8, 127)))


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


# N >= 8448 takes K2's 32-column blocks on 132 SMs, smaller N its 16-column
# ones; k_pad 92 is off the 16-byte copies of the codes; blocks 1 and 2 take
# the per-code scale path
INT8_CASES = [  # m, n, k, bs, k_stride
    (1, 1, 64, 4, None), (9, 100, 1100, 8, 1024), (17, 33, 700, 16, None),
    (40, 300, 4096, 32, 1024), (8, 64, 1500, 128, None), (3, 5, 92, 4, None),
    (256, 300, 4096, 16, 1024), (3, 8500, 700, 16, None), (20, 8448, 1024, 32, 1024),
    (9, 100, 1100, 1, 1024), (17, 8500, 700, 2, None), (3, 5, 91, 1, None),
]


@pytest.mark.parametrize("m,n,k,bs,k_stride", INT8_CASES)
@pytest.mark.parametrize("actq", [None, "raw", (16, 6, 8, 127), (4, 8, 8, 127), (32, 4, 8, 127)])
def test_int8_kernel_matches_plain(dev, m, n, k, bs, k_stride, actq):
    """K2 (actq_split, then the tensor-core matmul) on quantized x, on raw
    float32 x ("raw": no quantizer, hi and lo products) and with the
    quantizer in the call, M from 1 to the 256 rows bfp_matmul sends."""
    packed = tp.pack_block_fp(_weight(n, k, bs).to(dev), 6, 8, None, [1, bs], k_stride=k_stride)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    if actq is None:
        x = _qdq(x)
    elif actq == "raw":
        actq = None
    before = (dm.bfp_matmul_cuda.launches, dm.actq_split_cuda.launches)
    got = dm.bfp_matmul_cuda(x, packed, actq)
    assert (dm.bfp_matmul_cuda.launches, dm.actq_split_cuda.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    _close_rel(got, dm.bfp_matmul_plain(x, packed, actq))


@pytest.mark.parametrize("width", [2, 6, 8])
@pytest.mark.parametrize("m,n,k,bs", [(8, 100, 1100, 16), (40, 300, 4096, 16),
                                      (256, 64, 700, 32), (8, 8448, 1024, 16)])
def test_int8_kernel_keeps_float32_x(dev, width, m, n, k, bs):
    """Raw float32 x, no quantizer: K2's tensor cores take x as bf16 hi + lo
    terms, and must keep float32 semantics (ROADMAP fault 3) to 1e-4 of
    max|y|."""
    packed = tp.pack_block_fp(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    _close_rel(dm.bfp_matmul_cuda(x, packed), dm.bfp_matmul_plain(x, packed))


@pytest.mark.parametrize("actq", [None, (16, 6, 8, 127)])
def test_int8_kernel_keeps_subnormal_activations(dev, actq):
    """Activations at the bottom of the exponent range (c * 2^-133, bf16
    subnormals under the quantizer's 1e-8 passthrough), weights near 2^100:
    only a tensor core that flushed subnormal inputs would lose them."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (8, 1100), generator=g).float() * 2.0**-133
    w = torch.randn((64, 1100), generator=g) * 2.0**100
    packed = tp.pack_block_fp(w.to(dev), 6, 8, None, [1, 16])
    x = x.to(dev)
    want = dm.bfp_matmul_plain(x, packed, actq)
    assert want.abs().max().item() > 2.0**-60
    _close_rel(dm.bfp_matmul_cuda(x, packed, actq), want)


@pytest.mark.parametrize("bs", [16, 1])
def test_int8_kernel_applies_a_tiny_scale_in_float32(dev, bs):
    """A 2^-134 scale (below bf16's reach for odd codes; no packer pairs it
    with a nonzero code, so it is built by hand) next to x near 2^100: the
    kernel lifts it by 2^64 in the mma and drops 2^-64 in float32 (at block
    1, a code at a time)."""
    g = torch.Generator().manual_seed(4)
    codes = torch.randint(-127, 128, (300, 1024), generator=g, dtype=torch.int8)
    scales = torch.full((300, 64), 2.0**-10)
    scales[:, 1::7] = 2.0**-134
    scales[5, :] = 2.0**-134
    scales = scales.repeat_interleave(16 // bs, dim=1)
    packed = tp.PackedBFP(codes.to(dev), scales.to(dev), 8, bs, 300, 1024)
    big = torch.zeros(64, dtype=torch.bool)
    big[1::7] = True
    x = torch.randn((9, 64, 16), generator=g)
    x[:, big] *= 2.0**100
    x[:, ~big] *= 2.0**-60
    x = x.reshape(9, 1024).to(dev)
    _close_rel(dm.bfp_matmul_cuda(x, packed), dm.bfp_matmul_plain(x, packed))


ACTQ_SPLIT_CASES = [  # m, k, misaligned
    (1, 64, False), (8, 11008, False), (17, 1100, False), (256, 4096, False), (3, 701, False),
    (5, 1000, True),
]


@pytest.mark.parametrize("m,k,misaligned", ACTQ_SPLIT_CASES)
@pytest.mark.parametrize("actq", [None, (16, 6, 8, 127), (32, 4, 8, 127), (4, 8, 8, 127),
                                  (1, 6, 8, 127), (8, 6, 8, None)])
def test_actq_split_matches_plain(dev, m, k, misaligned, actq):
    """actq_split equals actq_split_plain bit for bit: hi, lo (0 past K)
    and the rows that have a lo; K off the float4 loads (701) and x at an
    address off 16 bytes take the scalar loads."""
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(k)) * 3
    x = x.to(dev)
    if misaligned:
        x = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)
    before = dm.actq_split_cuda.launches
    got = dm.actq_split_cuda(x, actq)
    assert dm.actq_split_cuda.launches == before + 1
    want = dm.actq_split_plain(x, actq, got[0].shape[1])
    torch.cuda.synchronize()
    for g_, w_ in zip(got[:2], want[:2]):
        assert torch.equal(g_.view(torch.int16), w_.view(torch.int16))
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("kind", ["int8", "subbyte"])
def test_pdl_matmuls_read_their_own_x(dev, kind):
    """K2 and K3 start their matmul as actq_split's programmatic dependent:
    its blocks queue weights while actq_split runs and must wait for it
    before they read the workspace. 200 calls alternating x1 (raw float32:
    lo terms) and x2 (quantized: none) on ONE workspace, with no
    synchronisation: each output equals its own x's synchronised output
    bit for bit (a matmul that read the workspace early would take the
    other x's rows), and those are their plain versions' within 1e-4 of
    max|y|."""
    m, n, k = 8, 4096, 4096
    w = _weight(n, k, 6).to(dev)
    if kind == "int8":
        packed, fn = tp.pack_block_fp(w, 6, 8, None, [1, 16]), dm.bfp_matmul_cuda
    else:
        packed, fn = tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16]), dm.bfp_matmul_subbyte_cuda
    g = torch.Generator().manual_seed(3)
    xs = (torch.randn((m, k), generator=g).to(dev),
          _qdq(torch.randn((m, k), generator=g) * 100).to(dev))
    refs = [fn(x, packed) for x in xs]
    torch.cuda.synchronize()
    for x, ref in zip(xs, refs):
        _close_rel(ref, dm.bfp_matmul_plain(x, packed))
    one = dm._split_workspace(m, dm._k_padded(packed), dev)
    with mock.patch.object(dm, "_split_workspace", lambda *_: one):
        outs = [fn(xs[i % 2], packed) for i in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, refs[i % 2]) for i, y in enumerate(outs))


@pytest.mark.parametrize("kind", ["int8", "subbyte"])
def test_matmuls_or_every_chunk_flag(dev, kind):
    """actq_split flags a row's lo a chunk of 512 K at a time, and K2 and
    K3 take a row block's lo products where any chunk of any of its rows
    has one: x quantized (no lo) but for its last 512 K in one row, raw
    float32 there (a chunk before the last where the sub-byte k_pad pads
    K). Skipping that chunk's lo would
    move y by ~2^-9 of the chunk's share, past 1e-4 of max|y|."""
    m, n, k = 24, 300, 4096
    w = _weight(n, k, 6).to(dev)
    if kind == "int8":
        packed, fn = tp.pack_block_fp(w, 6, 8, None, [1, 16]), dm.bfp_matmul_cuda
    else:
        packed, fn = tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16]), dm.bfp_matmul_subbyte_cuda
    g = torch.Generator().manual_seed(4)
    x = _qdq(torch.randn((m, k), generator=g))
    x[13, -512:] = torch.randn(512, generator=g) * 8
    x = x.to(dev)
    hi, lo, flags = dm.actq_split_cuda(x, None, dm._k_padded(packed))
    assert flags.nonzero().tolist() == [[13, k // 512 - 1]]
    _close_rel(fn(x, packed), dm.bfp_matmul_plain(x, packed))


def test_int8_kernel_raises_on_bad_operands(dev):
    x = torch.randn((3, 700), device=dev)
    packed = tp.pack_block_fp(_weight(40, 700, 0).to(dev), 6, 8, None, [1, 16])
    with pytest.raises(ValueError, match="must divide 128"):
        dm.bfp_matmul_cuda(x, packed._replace(block_size=3))
    for args, match in (((x, packed, (64, 6, 8, 127)), "does not divide"),
                        ((x[:, :640].contiguous(), packed), "in_features"),
                        ((x.double(), packed), "float32")):
        with pytest.raises(ValueError, match=match):
            dm.bfp_matmul_cuda(*args)
    with pytest.raises(ValueError, match="k_pad"):
        dm.actq_split_cuda(x, None, 512)


@pytest.mark.parametrize("bs", [1, 2])
def test_int8_kernel_takes_blocks_1_and_2(dev, bs):
    """Weight blocks [1, 1] and [1, 2], which the JAX package's
    bfp_matmul_pallas takes (K2 raised on them before its per-code scale
    path): K2 within 1e-4 of max|y| of bfp_matmul_plain, with the quantizer
    in the call and on raw x, and a row's bits the same whatever M."""
    w = _weight(200, 1100, bs).to(dev)
    packed = tp.pack_block_fp(w, 6, 8, None, [1, bs], k_stride=1024)
    x = torch.randn((256, 1100), generator=torch.Generator().manual_seed(bs)).to(dev)
    for actq in ((16, 6, 8, 127), None):
        full = dm.bfp_matmul_cuda(x, packed, actq)
        _close_rel(full, dm.bfp_matmul_plain(x, packed, actq))
        for rows in (slice(0, 1), slice(3, 8), slice(5, 22), slice(100, 256)):
            part = dm.bfp_matmul_cuda(x[rows].contiguous(), packed, actq)
            torch.testing.assert_close(part, full[rows], rtol=0, atol=0)


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


@pytest.mark.parametrize("width", [2, 6, 8])
@pytest.mark.parametrize("m,n,k,bs", [(8, 100, 1100, 16), (40, 300, 4096, 16),
                                      (256, 64, 700, 32), (8, 8448, 1024, 1)])
def test_subbyte_kernel_keeps_float32_x(dev, width, m, n, k, bs):
    """Raw float32 x, no quantizer: K3's tensor cores take x as bf16 hi + lo
    terms from actq_split, and must keep float32 semantics (ROADMAP fault 3)
    to 1e-4 of max|y|."""
    packed = tp.pack_block_fp_subbyte(_weight(n, k, width).to(dev), width, 8, None, [1, bs])
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dev)
    _close_rel(dm.bfp_matmul_subbyte_cuda(x, packed), dm.bfp_matmul_plain(x, packed))


@pytest.mark.parametrize("actq", [None, (16, 6, 8, 127)])
def test_subbyte_kernel_keeps_subnormal_activations(dev, actq):
    """Activations at the bottom of the exponent range (c * 2^-133, bf16
    subnormals under the quantizer's 1e-8 passthrough), weights near 2^100:
    only a tensor core that flushed subnormal inputs would lose them."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-127, 128, (8, 1100), generator=g).float() * 2.0**-133
    w = torch.randn((64, 1100), generator=g) * 2.0**100
    packed = tp.pack_block_fp_subbyte(w.to(dev), 6, 8, None, [1, 16])
    x = x.to(dev)
    want = dm.bfp_matmul_plain(x, packed, actq)
    assert want.abs().max().item() > 2.0**-60
    _close_rel(dm.bfp_matmul_subbyte_cuda(x, packed, actq), want)


@pytest.mark.parametrize("bs", [1, 16, 128])
def test_subbyte_kernel_takes_the_smallest_scale_bytes(dev, bs):
    """Scale bytes 0, 1 and 2 (2^-128 .. 2^-126: the small codes land on
    bf16 subnormals; built by hand, no packer makes them) next to x near
    2^100: the kernel keeps every product that the plain version keeps."""
    g = torch.Generator().manual_seed(6)
    packed = tp.pack_block_fp_subbyte(_weight(300, 1100, 6).to(dev), 6, 8, None, [1, bs])
    e8 = torch.randint(0, 3, packed.scales.shape, generator=g, dtype=torch.uint8)
    packed = packed._replace(scales=e8.to(dev))
    x = (torch.randn((9, 1100), generator=g) * 2.0**100).to(dev)
    want = dm.bfp_matmul_plain(x, packed)
    assert want.abs().max().item() > 2.0**-40
    _close_rel(dm.bfp_matmul_subbyte_cuda(x, packed), want)


def test_matmul_rows_do_not_depend_on_the_batch(dev):
    """A row's result is the same bits whatever M and the other rows are
    (what lets the batcher reproduce generate), up to the 256 rows
    bfp_matmul sends to the kernels (K1, K2 and K3 take 8 rows a block at
    M <= 8 and 16 above; K2 and K3 are also held on a raw row, whose lo
    products run in its row block and not in others)."""
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
    xr = x.clone()
    xr[4] = torch.randn(1100, generator=torch.Generator().manual_seed(1)).to(dev)
    for packed, fn in ((tp.pack_block_fp(w, 6, 8, None, [1, 16], k_stride=1024),
                        dm.bfp_matmul_cuda),
                       (tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16]),
                        dm.bfp_matmul_subbyte_cuda)):
        full = fn(xr, packed)
        for rows in (slice(0, 1), slice(3, 8), slice(5, 22), slice(100, 256)):
            torch.testing.assert_close(fn(xr[rows].contiguous(), packed), full[rows],
                                       rtol=0, atol=0)


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
    assert tk.launch_counts() == {**dict.fromkeys(tk.launch_counts(), 0),
                                  "bfp_matmul_subbyte": 2, "actq_split": 2}


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


# positions: the first only, the last, and ones in between; K4's chunk of
# 16 positions at 32 heads ends at 15 and 31 (64 at 8 heads); prob blocks
# from 1 to S; K4's run-time rep (3) with 5 heads, and 64 heads at rep 8
# (a block takes 32 of them)
ATTN_CASES = [  # b, nkv, rep, hd, s_len, bs_k, bs_v, prob_q, positions
    (2, 2, 1, 128, 64, 16, 16, (16, 6, 8, None), [0, 63]),
    (3, 1, 8, 128, 96, 32, 16, (32, 6, 8, None), [0, 95, 32]),
    (2, 4, 2, 64, 256, 16, 64, None, [0, 255]),
    (1, 2, 4, 128, 512, 16, 16, (16, 4, 8, None), [0]),
    (3, 32, 1, 128, 256, 16, 16, (16, 6, 8, None), [0, 15, 255]),  # Llama-2-7B
    (3, 32, 1, 128, 256, 16, 16, (256, 6, 8, None), [16, 100, 31]),
    (1, 32, 1, 128, 256, 16, 16, (1, 6, 8, None), [100]),
    (3, 8, 4, 128, 1024, 16, 16, (16, 6, 8, None), [16, 1023, 100]),  # GQA, 8192 lanes
    (1, 8, 4, 128, 1024, 16, 16, (1024, 6, 8, None), [1023]),
    (3, 8, 4, 128, 1024, 16, 16, (1, 6, 8, None), [63, 64, 0]),
    (2, 5, 3, 64, 128, 16, 32, (16, 6, 8, None), [127, 64]),  # rep 3, heads off 4
    (1, 64, 8, 64, 64, 16, 16, (32, 6, 8, None), [63]),  # K4: two groups of 32 heads
    # K5 at 4096 positions takes chunks of 512 in tiles of 128: a tile's
    # last and first, a chunk's last, mid positions at Llama-2-7B and GQA
    # widths
    (2, 32, 1, 128, 4096, 16, 16, (16, 6, 8, None), [4095, 127]),
    (3, 8, 4, 128, 4096, 16, 16, (16, 6, 8, None), [128, 2047, 4000]),
    # K5's chunks of 128 at 4 heads: a scale a K code, prob blocks longer
    # than 32, a chunk's last and first
    (3, 4, 2, 128, 512, 1, 16, (64, 6, 8, None), [127, 128, 511]),
    # 100 positions: K's runs off 16 bytes (element copies); V blocks of 2
    (2, 2, 1, 64, 100, 16, 2, (4, 6, 8, None), [99, 37]),
    # Llama-3-70B attention widths (8 kv heads, rep 8) at its 8192
    # positions, and rep 8 on one kv head at the pos-major 8192 lanes
    (2, 8, 8, 128, 8192, 16, 16, (16, 6, 8, None), [8191, 6944]),
    (2, 1, 8, 128, 8192, 16, 16, (16, 6, 8, None), [8191, 7000]),
    # head_dims that are multiples of 16 but not powers of two: K4's stage
    # all of hd (48, 80, 96, 112), 48 dims (144), 32 (160 with blocks of 32),
    # 16 (208: 13 stages); K5's dim groups 3, 5, 6, 7, and P . V with idle
    # threads past the last whole position group
    (2, 4, 1, 48, 256, 16, 16, (16, 6, 8, None), [255, 31]),
    (3, 8, 4, 80, 1024, 16, 16, (16, 6, 8, None), [1023, 64, 5]),
    (2, 2, 8, 96, 512, 32, 16, (64, 6, 8, None), [511, 128]),
    (2, 8, 8, 112, 1024, 16, 16, (16, 6, 8, None), [1000, 127]),
    (2, 2, 2, 144, 512, 16, 16, (32, 6, 8, None), [511, 300]),
    (2, 4, 2, 160, 512, 32, 32, (16, 6, 8, None), [511, 7]),
    (1, 2, 3, 208, 128, 16, 16, (16, 6, 8, None), [127]),
    (2, 2, 1, 240, 256, 1, 16, (256, 6, 8, None), [255, 100]),
    (2, 32, 1, 80, 4096, 16, 16, (16, 6, 8, None), [4095, 2000]),
    # past 256 and off 16 (fault 15's repair): K4's four stages of 80 dims
    # at 320 (two stages of 128 at 1024), one stage of 40 and of 8 dims;
    # K5's 5 dim groups and 3 position groups of 80 threads at 320, V codes
    # by 4-byte copies at 40, 8 and 12, a scale block of the whole head (12)
    (2, 2, 1, 320, 256, 16, 16, (16, 6, 8, None), [255, 40]),
    (3, 8, 4, 320, 512, 16, 16, (16, 6, 8, None), [511, 100, 0]),
    (2, 4, 2, 40, 256, 8, 8, (32, 6, 8, None), [255, 31]),
    (2, 8, 8, 40, 2048, 8, 8, (16, 6, 8, None), [2047, 900]),
    (2, 2, 1, 8, 64, 8, 8, (16, 6, 8, None), [63, 3]),
    (3, 16, 2, 8, 1024, 8, 8, (16, 6, 8, None), [1023, 17, 500]),
    (2, 2, 2, 12, 128, 12, 4, (16, 6, 8, None), [127, 60]),
    (1, 2, 1, 1024, 64, 16, 16, (16, 6, 8, None), [63]),
    # fault 18's repair, rep 1 and 8: head_dims off 4 (2, 6, 10, 18; V code
    # rows padded to 4 bytes in shared memory, the last quad's dims past hd
    # not stored) and 36, K/V blocks that are not powers of two (3, 5, 6,
    # 9, 10, 12, 18, 20, 24, 36, 40), and K5 past 1024 dims (1280, 2048:
    # P . V in passes of 1024 dims, its sums in shared memory)
    (2, 2, 1, 2, 64, 2, 1, (16, 6, 8, None), [63, 5]),
    (2, 2, 8, 2, 128, 1, 2, (32, 6, 8, None), [127, 40]),
    (2, 4, 1, 6, 128, 6, 3, (16, 6, 8, None), [127, 0]),
    (2, 2, 8, 6, 256, 3, 6, (64, 6, 8, None), [255, 100]),
    (2, 4, 1, 10, 64, 10, 5, (16, 6, 8, None), [63, 20]),
    (2, 2, 8, 10, 128, 5, 10, None, [127, 64]),
    (2, 4, 1, 18, 128, 9, 6, (16, 6, 8, None), [127, 31]),
    (2, 2, 8, 18, 64, 18, 9, (16, 6, 8, None), [63, 1]),
    (2, 4, 1, 36, 256, 12, 4, (16, 6, 8, None), [255, 77]),
    (2, 2, 8, 36, 128, 36, 12, (16, 6, 8, None), [127, 3]),
    (2, 4, 1, 48, 256, 12, 12, (16, 6, 8, None), [255, 90]),
    (2, 2, 8, 48, 512, 12, 24, (64, 6, 8, None), [511, 200]),
    (2, 4, 1, 80, 256, 20, 20, (16, 6, 8, None), [255, 31]),
    (2, 2, 8, 80, 256, 40, 20, (32, 6, 8, None), [255, 128]),
    (2, 4, 1, 96, 256, 24, 24, (16, 6, 8, None), [255, 64]),
    (2, 2, 8, 96, 128, 24, 12, (16, 6, 8, None), [127, 100]),
    (2, 4, 1, 1280, 256, 16, 16, (16, 6, 8, None), [255, 70]),
    (2, 2, 8, 1280, 256, 1, 20, (16, 6, 8, None), [255, 128]),
    (2, 2, 1, 2048, 256, 16, 16, (16, 6, 8, None), [255, 17]),
    (1, 2, 8, 2048, 256, 1, 1, (32, 6, 8, None), [255]),
    # fault 21's repair: K5's scores in passes of a divisor of the head
    # (1004 of 3012 at rep 8 and a scale a code; 494 of 5434 with one scale
    # a head; 1 of the prime 7919, V codes a byte at a time), P . V a walk
    # of the chunk a pass of 1024 dims; K4 past 65535 dims
    (2, 2, 8, 3012, 174, 1, 1, (2, 6, 8, None), [173, 60]),
    (1, 2, 8, 5434, 96, 5434, 5434, (16, 6, 8, None), [95]),
    (1, 2, 3, 7919, 16, 1, 1, (16, 6, 8, None), [15]),
    (2, 2, 8, 3012, 128, 12, 4, (16, 6, 8, None), [127, 3]),
    (1, 1, 1, 65536, 8, 16, 16, None, [7]),
    (1, 1, 2, 70000, 8, 16, 8, None, [5]),
]


@pytest.mark.parametrize("pos_major", [True, False])
@pytest.mark.parametrize("b,nkv,rep,hd,s_len,bs_k,bs_v,prob_q,positions", ATTN_CASES)
def test_attention_kernels_match_plain(dev, pos_major, b, nkv, rep, hd, s_len, bs_k, bs_v,
                                       prob_q, positions):
    cache = _cache(b, nkv, s_len, hd, bs_k, bs_v, pos_major, dev, seed=s_len)
    q = _qdq(torch.randn((b * nkv * rep, hd), generator=torch.Generator().manual_seed(1)))
    positions = torch.tensor(positions, dtype=torch.int32).to(dev)
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


def test_k4_batch_element_does_not_depend_on_the_batch(dev):
    """K4 at the Llama-2-7B shape: a batch element's ctx is the same bits
    alone and in a batch of 8 (no sums across batch elements, no atomics)."""
    b, nkv, hd, s_len = 8, 32, 128, 256
    cache = _cache(b, nkv, s_len, hd, 16, 16, True, dev, seed=7)
    q = _qdq(torch.randn((b * nkv, hd), generator=torch.Generator().manual_seed(7)))
    q = q.reshape(b, nkv, hd).to(dev)
    positions = torch.tensor([255, 0, 15, 16, 100, 31, 200, 64], dtype=torch.int32).to(dev)
    full = ad.packed_attention_decode_batch_cuda(q, *cache, positions, 16, 16, nkv, 1,
                                                 (16, 6, 8, None))
    for i in range(b):
        one = ad.packed_attention_decode_batch_cuda(
            q[i:i + 1].contiguous(), *(t[i:i + 1].contiguous() for t in cache),
            positions[i:i + 1], 16, 16, nkv, 1, (16, 6, 8, None))
        torch.testing.assert_close(one[0], full[i], rtol=0, atol=0)


def test_k5_batch_element_does_not_depend_on_the_batch(dev):
    """K5 at the Llama-2-7B batcher shape (512 positions): a batch
    element's ctx is the same bits alone and in a batch of 8."""
    b, nkv, hd, s_len = 8, 32, 128, 512
    cache = _cache(b, nkv, s_len, hd, 16, 16, False, dev, seed=8)
    q = _qdq(torch.randn((b * nkv, hd), generator=torch.Generator().manual_seed(8)))
    q = q.reshape(b, nkv, 1, hd).to(dev)
    positions = torch.tensor([511, 0, 63, 64, 100, 31, 200, 450], dtype=torch.int32).to(dev)
    full = ad.packed_attention_decode_cuda(q, *cache, positions, 16, 16, (16, 6, 8, None))
    for i in range(b):
        one = ad.packed_attention_decode_cuda(
            q[i:i + 1].contiguous(), *(t[i:i + 1].contiguous() for t in cache),
            positions[i:i + 1], 16, 16, (16, 6, 8, None))
        torch.testing.assert_close(one[0], full[i], rtol=0, atol=0)


@pytest.mark.parametrize("rep", [1, 8])
def test_k5_head_dim_256_with_a_scale_a_code(dev, rep):
    """head_dim 256 with a scale a K and a V code: two ring stages of 128
    positions do not fit in shared memory, so K5 takes tiles of 64."""
    b, nkv, hd, s_len = 2, 2, 256, 512
    cache = _cache(b, nkv, s_len, hd, 1, 1, False, dev, seed=11)
    q = _qdq(torch.randn((b * nkv * rep, hd), generator=torch.Generator().manual_seed(11)))
    q = q.reshape(b, nkv, rep, hd).to(dev)
    positions = torch.tensor([511, 200], dtype=torch.int32).to(dev)
    args = (q, *cache, positions, 1, 1, (16, 6, 8, None))
    torch.testing.assert_close(ad.packed_attention_decode_cuda(*args),
                               ad.packed_attention_decode_plain(*args), rtol=2e-4, atol=2e-5)


def _off_by_one_element(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def test_k5_takes_unaligned_operands(dev):
    """Every operand one element off 16 bytes: K5 stages them by element
    copies and agrees with its plain version."""
    b, nkv, rep, hd, s_len = 2, 4, 2, 128, 256
    cache = _cache(b, nkv, s_len, hd, 16, 16, False, dev, seed=9)
    q = _qdq(torch.randn((b * nkv * rep, hd), generator=torch.Generator().manual_seed(9)))
    q = q.reshape(b, nkv, rep, hd).to(dev)
    positions = torch.tensor([255, 70], dtype=torch.int32).to(dev)
    args = (q, *cache, positions, 16, 16, (16, 6, 8, None))
    moved = [_off_by_one_element(t) for t in (q, *cache)]
    assert all(t.data_ptr() % 16 for t in moved)
    got = ad.packed_attention_decode_cuda(*moved, positions, 16, 16, (16, 6, 8, None))
    torch.testing.assert_close(got, ad.packed_attention_decode_plain(*args), rtol=2e-4,
                               atol=2e-5)


def test_k5_refuses_bad_operands(dev):
    """The K5 wrapper raises on operands it does not take, launching
    nothing and computing no plain version in its place."""
    b, nkv, rep, hd, s_len = 1, 2, 1, 64, 64
    kc, ks, vc, vs = _cache(b, nkv, s_len, hd, 16, 16, False, dev, seed=10)
    q = torch.zeros((b, nkv, rep, hd), device=dev)
    pos = torch.tensor([10], dtype=torch.int32, device=dev)
    fn = ad.packed_attention_decode_cuda
    bad = {
        "power of two": ((q, kc, ks, vc, vs, pos, 16, 16, (24, 6, 8, None)), {}),
        "K scales": ((q, kc, ks[:, :, :2].contiguous(), vc, vs, pos, 16, 16, None), {}),
        "q float32": ((q.to(torch.bfloat16), kc, ks, vc, vs, pos, 16, 16, None), {}),
        "contiguous": ((q, kc.transpose(2, 3), ks, vc, vs, pos, 16, 16, None), {}),
        "query rows": ((torch.zeros((b, 1, 9, hd), device=dev), kc[:, :1], ks[:, :1],
                        vc[:, :1], vs[:, :1], pos, 16, 16, None), {}),
    }
    before = fn.launches
    for reason, (args, kwargs) in bad.items():
        with pytest.raises(ValueError, match=reason):
            fn(*args, **kwargs)
    assert fn.launches == before


def test_launch_counts_reset(dev):
    tk.reset_launch_counts()
    packed = tp.pack_block_fp(_weight(32, 64, 0).to(dev), 6, 8, None, [1, 16])
    dm.bfp_matmul(torch.zeros((3, 64), device=dev), packed)
    counts = tk.launch_counts()
    assert counts["bfp_matmul_int8"] == 1 and counts["actq_split"] == 1
    assert sum(counts.values()) == 2
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


def _c32_t1(x, packed):
    """subbyte_tile's c32_t1: the copy of K3's former CUDA-core design (no
    activation quantizer), the anchor of the lane-major probes."""
    return tkp.subbyte_tile(x, packed, *tkp.SUB_INSTANCES["c32_t1"])


@pytest.mark.parametrize("layout", ["transposed", "lane_major"])
def test_subbyte_probe_ship_is_the_production_kernel(dev, layout):
    """On bf16 x with no activation quantizer, ship computes what K1
    computes (transposed), and what c32_t1, K3's former design that it
    copies, computes, bit for bit (lane-major); K3 on the tensor cores sums
    the same products in another order."""
    packed = tp.pack_block_fp_subbyte(_weight(100, 1100, 0).to(dev), 6, 8, None, [1, 16])
    x = torch.randn((8, 1100), generator=torch.Generator().manual_seed(0)).to(dev)
    x = x.to(torch.bfloat16).float()
    if layout == "transposed":
        packed = tp.transpose_subbyte(packed)
        _close_rel(tks.subbyte_probe(x, packed, "ship"),
                   dm.bfp_matmul_subbyte_t_cuda(x, packed, None))
        return
    anchor = _c32_t1(x, packed)
    torch.testing.assert_close(tks.subbyte_probe(x, packed, "ship"), anchor, rtol=0, atol=0)
    _close_rel(dm.bfp_matmul_subbyte_cuda(x, packed, None), anchor, 1e-5)


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
    compute exactly what K1 computes (transposed) and what subbyte_tile's
    c32_t1, K3's former CUDA-core design that they copy, computes
    (lane-major), in the same order; v3 differs by its correction's
    rounding; K3 on the tensor cores sums the same products as c32_t1 in
    another order. P2 with either scale type computes what int8_tile's
    c32_k512 computes, K2's CUDA-core design that both copy; K2 on the
    tensor cores sums the same products in another order."""
    w = _weight(100, 1100, 0).to(dev)
    packed = tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16])
    x = torch.randn((8, 1100), generator=torch.Generator().manual_seed(0)).to(dev)
    x = x.to(torch.bfloat16).float()
    if layout == "transposed":
        packed = tp.transpose_subbyte(packed)
        want = dm.bfp_matmul_subbyte_t_cuda(x, packed, None)
    else:
        want = _c32_t1(x, packed)
        _close_rel(dm.bfp_matmul_subbyte_cuda(x, packed, None), want, 1e-5)
    for got in (tkv.matmul_variant(x, packed, "v2"), tkv2.sub_variant(x, packed, torch.float32),
                tkv2.sub_variant(x, packed, torch.bfloat16)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    _close_rel(tkv.matmul_variant(x, packed, "v3"), want, 1e-5)
    p8 = tp.pack_block_fp(w, 6, 8, None, [1, 16])
    anchor = tkt.int8_tile(x, p8, *tkt.INT8_INSTANCES["c32_k512"])
    for dt in (torch.bfloat16, torch.float32):
        torch.testing.assert_close(tkv2.int8_variant(x, p8, dt), anchor, rtol=0, atol=0)
    _close_rel(dm.bfp_matmul_cuda(x, p8, None), anchor, 1e-5)


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
    computes c32_t1's sums (K3's former CUDA-core design) and every int8_tile
    instance without bands c32_k512's (K2's), in the same order; the band
    instance adds its bands' sums instead, and K3 and K2 on the tensor cores
    sum the same products in another order."""
    w = _weight(300, 4096, 0).to(dev)
    x = torch.randn((8, 4096), generator=torch.Generator().manual_seed(0)).to(dev)
    x = x.to(torch.bfloat16).float()
    packed = tp.pack_block_fp_subbyte(w, 6, 8, None, [1, 16])
    want = _c32_t1(x, packed)
    _close_rel(dm.bfp_matmul_subbyte_cuda(x, packed, None), want, 1e-5)
    for cols, tps in tkp.SUB_INSTANCES.values():
        torch.testing.assert_close(tkp.subbyte_tile(x, packed, cols, tps), want, rtol=0, atol=0)
    p8 = tp.pack_block_fp(w, 6, 8, None, [1, 16])
    want = tkt.int8_tile(x, p8, *tkt.INT8_INSTANCES["c32_k512"])
    _close_rel(dm.bfp_matmul_cuda(x, p8, None), want, 1e-5)
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


# P12 and P13 (tools.k3): the probe's S = 256 at batch 1, 3 and 32, positions
# 0, 15, 16, 100 (mid-block: qmax reaches the end of the block) and the
# last; rep 2 at S = 40, a short last block
K3_CASES = [  # b, nkv, rep, hd, s_len, positions
    (1, 32, 1, 128, 256, [0]),
    (3, 32, 1, 128, 256, [15, 16, 100]),
    (32, 32, 1, 128, 256, [255] * 16 + [100] * 16),
    (3, 2, 2, 64, 40, [39, 0, 21]),
]


@pytest.mark.parametrize("stage", tk3.STAGES + ("v3_masks",))
@pytest.mark.parametrize("b,nkv,rep,hd,s_len,positions", K3_CASES)
def test_attention_v2_v3_match_plain(dev, stage, b, nkv, rep, hd, s_len, positions):
    cache = _cache(b, nkv, s_len, hd, 16, 16, True, dev, seed=s_len + b)
    # q quantized as serving quantizes it: bf16-exact, so the scores are
    # exact in float32 whatever the order of their sums
    q = _qdq(torch.randn((b * nkv * rep, hd), generator=torch.Generator().manual_seed(2)))
    q = q.reshape(b, nkv * rep, hd).to(dev)
    args = (q, *cache, torch.tensor(positions, dtype=torch.int32).to(dev))
    kw = dict(nkv=nkv, rep=rep)
    if stage == "v3_masks":
        masks = tk3.resident_masks(nkv * rep, nkv, s_len, rep, dev)
        before = tk3.attention_v3.launches
        got = tk3.attention_v3(*args, *masks, **kw)
        assert tk3.attention_v3.launches == before + 1
        want = tk3.attention_v3_plain(*args, *masks, **kw)
        assert torch.equal(got, tk3.attention_v2(*args, "full", **kw))
    else:
        before = tk3.attention_v2.launches
        got = tk3.attention_v2(*args, stage, **kw)
        assert tk3.attention_v2.launches == before + 1
        want = tk3.attention_v2_plain(*args, stage, **kw)
    if stage == "dots":
        _close_rel(got, want, 1e-3)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_attention_v3_is_v2_full_on_raw_q(dev):
    """On the tool's raw q the two kernels differ only in where the masks
    come from: the same sums, bit for bit."""
    inputs = tk3.make_inputs(32, device=dev)
    pos = torch.tensor([255] * 16 + [100] * 16, dtype=torch.int32, device=dev)
    inputs = (*inputs[:5], pos)
    got = tk3.attention_v3(*inputs, *tk3.resident_masks(device=dev))
    assert torch.equal(got, tk3.attention_v2(*inputs, "full"))


def test_attention_v2_v3_raise_on_bad_operands(dev):
    inputs = tk3.make_inputs(1, device=dev)
    negb, posi = tk3.resident_masks(device=dev)
    with pytest.raises(ValueError, match="stage"):
        tk3.attention_v2(*inputs, "quant")
    with pytest.raises(ValueError, match="negb float32"):
        tk3.attention_v3(*inputs, negb[:, :-32].contiguous(), posi)
    with pytest.raises(ValueError, match="negb float32"):
        tk3.attention_v3(*inputs, negb, posi.float())


# P10 (tools.kexp): L off the 256-column tile, odd L (no 4-column loads),
# codes at an odd address (no vector loads), the probe's own shape
@pytest.mark.parametrize("variant", tkx.VARIANTS)
@pytest.mark.parametrize("b,l,misaligned", [(1, 256, False), (3, 1000, False), (2, 257, False),
                                             (2, 1000, True), (32, 8192, False)])
def test_expand_probe_matches_plain(dev, variant, b, l, misaligned):
    q, codes, scales = tkx.make_inputs(l, b, seed=l, device=dev)
    if misaligned:
        codes = torch.empty(codes.numel() + 1, dtype=torch.int8, device=dev)[1:].view_as(
            codes).copy_(codes)
    before = tkx.expand_probe.launches
    got = tkx.expand_probe(q, codes, scales, variant)
    assert tkx.expand_probe.launches == before + 1
    assert torch.equal(got, tkx.expand_probe_plain(q, codes, scales, variant))


def test_expand_probe_takes_scales_in_bf16(dev):
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 8, 128), generator=g).to(dev)
    codes = torch.randint(-128, 128, (2, 128, 300), generator=g, dtype=torch.int8).to(dev)
    scales = torch.rand((2, 8, 300), generator=g).to(dev) + 0.01
    want = tkx.expand_probe_plain(q, codes, scales, "index")
    for variant in ("index", "staged"):
        assert torch.equal(tkx.expand_probe(q, codes, scales, variant), want)


def test_expand_probe_raises_on_bad_operands(dev):
    q, codes, scales = tkx.make_inputs(256, 2, device=dev)
    with pytest.raises(ValueError, match="variant"):
        tkx.expand_probe(q, codes, scales, "ship")
    with pytest.raises(ValueError, match="expected"):
        tkx.expand_probe(q[:, :4].contiguous(), codes, scales, "index")
    with pytest.raises(ValueError, match="expected"):
        tkx.expand_probe(q, codes, scales.double(), "index")
