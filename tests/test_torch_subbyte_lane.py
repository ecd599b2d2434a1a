"""K3's route on the tensor cores, held to the JAX package on the CPU.

K3 (``llm_mixed_q_torch.kernels.dequant_matmul.bfp_matmul_subbyte_cuda``,
lane-major ``PackedBFPSub`` words) is two kernels: K2's ``actq_split``
quantizes x once a call into bf16 hi and lo rows of a workspace; the
matmul then multiplies bf16 operands on the tensor cores, the weight as A
and x as B, and sums in float32. Its K permutation: lane ``tig`` of a quad
loads word rows r0 + 4 tig .. + 3 of a 16-row group r0 of a packing tile;
slice j of those words holds K rows j*128 + r0 + 4 tig .. + 3 of the tile,
which go to the mma's k 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9, and B takes
x at the same K. These tests hold what that route computes, on numpy
inputs from a seed:

- the route emulated in plain torch (``actq_split_plain``, the A and B
  fragments built from the words and the workspace in that permutation,
  float32 sums) against ``bfp_matmul_subbyte_pallas(..., interpret=True)``
  to 1e-4 of max|y|, the JAX package's kernel tolerance
  (``tests/test_kernels.py``: float32 sums in another order);
- its bf16 weights are exact: every code times the scale of every byte
  0-255 (bytes 0 and 1 give bf16 subnormals);
- raw float32 x keeps float32 through the route (hi + lo);
- the workspace layout for the sub-byte k_pad (a multiple of the tile);
- the CPU wrappers take the plain versions.

The CUDA kernels themselves are held against ``bfp_matmul_plain`` on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import dequant_matmul as jmm
from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_tpu.ops.quantizers import _block_fp_qdq as _jax_qdq
from llm_mixed_q_torch import kernels as tk
from llm_mixed_q_torch.kernels import dequant_matmul as dm
from llm_mixed_q_torch.kernels import packing as tp

RNG = np.random.default_rng(10)
# the data_in specs of tests/test_torch_k2.py
SPECS = [(16, 6, 8, 127), (32, 4, 8, 127), (4, 8, 8, 127), (8, 6, 8, None)]
SLICE = 128


def _x(m, k):
    """Rows at exponents 2^-8 .. 2^8, none near the 1e-8 passthrough."""
    x = RNG.standard_normal((m, k)) * np.exp2(RNG.integers(-8, 9, (m, 1)))
    return x.astype(np.float32)


def _w(n, k):
    w = (RNG.standard_normal((n, k)) * 0.05).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    return w


def _k_positions():
    """(p, tig, u) of the mma's 16 k positions: p = 2 tig + u for u < 2,
    2 tig + 8 + (u - 2) for u >= 2, where lane tig's code u sits."""
    p = torch.arange(16)
    tig = (p % 8) // 2
    u = p % 2 + 2 * (p // 8)
    return tig, u


def _fragments(packed, hi):
    """The A and B operands of every k16 step of the route, as float32
    (bf16-exact) tensors [N or M, n_tiles, 8 groups, per_word slices, 16 k]:
    A from the words and scale bytes as the kernel decodes them, B from the
    workspace rows ``hi`` at the same K rows of the tile."""
    width, pw, tile = packed.width, packed.per_word, packed.tile
    lbs = packed.block_size.bit_length() - 1
    n, nw = packed.words.shape
    nt = nw // SLICE
    tig, u = _k_positions()
    r0 = 16 * torch.arange(8)[:, None]                     # [8 groups, 1]
    rows = r0 + 4 * tig[None, :] + u[None, :]              # [8, 16]: word rows of each k
    j = torch.arange(pw)[:, None, None]                    # [pw, 1, 1]
    kk = j * SLICE + rows[None]                            # [pw, 8, 16]: K rows in the tile
    kk = kk.permute(1, 0, 2)                               # [8, pw, 16]
    words = packed.words.view(torch.int32).reshape(n, nt, SLICE).long() & 0xFFFFFFFF
    w = words[:, :, rows]                                  # [n, nt, 8, 16]
    shift = (width * torch.arange(pw))[None, None, None, :, None]
    codes = (w[:, :, :, None, :] >> shift) & (2**width - 1)  # [n, nt, 8, pw, 16]
    cmax = 2 ** (width - 1) - 1
    # float(0x4B000000 | code) - (2^23 + cmax), exactly
    cf = (codes | 0x4B000000).int().view(torch.float32) - torch.tensor(8388608.0 + cmax)
    e8 = packed.scales.permute(1, 0, 2).long()             # [n, nt, tile / bs]
    s = tp.scale_from_e8(e8[:, :, kk >> lbs])              # [n, nt, 8, pw, 16]
    a = cf * s
    b = hi.float().reshape(hi.shape[0], -1)[:, : nt * tile].reshape(-1, nt, tile)[:, :, kk]
    assert torch.equal(a.to(torch.bfloat16).float(), a)  # exact operands
    return a, b


def _route_emulated(x2, packed, actq):
    """K3's arithmetic in plain torch: actq_split's hi and lo, A and B in
    the kernel's K permutation, every k16 step's products summed in
    float32, the lo products only where some row has a lo."""
    hi, lo, lo_rows = dm.actq_split_plain(x2, actq, dm._k_padded(packed))
    a, bh = _fragments(packed, hi)
    y = torch.einsum("ntgjp,mtgjp->mn", a, bh)
    if lo_rows.any():
        _, bl = _fragments(packed, lo)
        y = y + torch.einsum("ntgjp,mtgjp->mn", a, bl)
    return y


def test_the_permutation_covers_every_k_of_a_group_once():
    """Slice j of a 16-row group's words: the quad's 16 mma k positions take
    K rows j*128 + r0 .. + 15 once each, 4 consecutive ones a lane."""
    tig, u = _k_positions()
    k = 4 * tig + u
    assert sorted(k.tolist()) == list(range(16))
    for t in range(4):
        assert sorted(k[tig == t].tolist()) == [4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3]


# widths 2-8 (tiles 2048, 1280, 1024, 768, 640, 512), bs 1..128, M 1..256,
# K short of a whole tile, N not a multiple of 16
ROUTE_CASES = [  # m, n, k, width, bs
    (1, 40, 700, 6, 16), (8, 33, 640, 6, 4), (17, 24, 1100, 4, 1), (256, 20, 600, 8, 128),
    (8, 48, 2100, 2, 16), (17, 19, 1000, 3, 4), (1, 16, 1300, 7, 128), (256, 35, 500, 6, 1),
]


@pytest.mark.parametrize("m,n,k,width,bs", ROUTE_CASES)
@pytest.mark.parametrize("actq", [None] + SPECS)
def test_route_matches_jax_kernel(m, n, k, width, bs, actq):
    """The emulated route against the TPU kernel in interpret mode. As in
    the pipeline, x arrives block_fp-quantized when there is no in-kernel
    quantizer (the TPU kernel casts raw x to bf16: ROADMAP fault 3)."""
    x = _x(m, k)
    if actq is None:
        x = np.array(_jax_qdq(jnp.asarray(x), 6, 8, None, [1, 16], True))
    w = _w(n, k)
    jpk = jp.pack_block_fp_subbyte(jnp.asarray(w), width, 8, None, [1, bs])
    tpk = tp.pack_block_fp_subbyte(torch.from_numpy(w), width, 8, None, [1, bs])
    want = np.asarray(jmm.bfp_matmul_subbyte_pallas(jnp.asarray(x), jpk, interpret=True,
                                                    actq=actq))
    got = _route_emulated(torch.from_numpy(x), tpk, actq).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8])
def test_subbyte_weights_are_bf16_exact_for_every_scale_byte(width):
    """Every code (field - cmax) times 2^(byte - 128) is exact in bf16 for
    every byte 0-255: bytes 0 and 1 put the small codes on bf16 subnormals
    (multiples of 2^-133), and a product of 2^128 or more (byte 255 with a
    code of 2 or more, byte 254 with 4) is inf in both versions. So no
    scale takes K2's lift. Then a packed weight with every byte,
    dequantized through bf16, against float32."""
    cmax = 2 ** (width - 1) - 1
    codes = torch.arange(2**width, dtype=torch.float64) - cmax
    scales = torch.exp2(torch.arange(256, dtype=torch.float64) - 128)
    exact = codes[None, :] * scales[:, None]
    prod = exact.float()
    finite = torch.isfinite(prod)
    assert torch.equal(prod[finite].double(), exact[finite])  # exact in float32
    assert torch.equal(~finite, exact.abs() >= 2.0**128)  # inf in both versions
    assert torch.equal(prod.to(torch.bfloat16).float(), prod)
    w = torch.from_numpy(_w(48, 700))
    packed = tp.pack_block_fp_subbyte(w, width, 8, None, [1, 16])
    e8 = torch.from_numpy(RNG.integers(0, 256, packed.scales.shape).astype(np.uint8))
    e8.view(-1)[:256] = torch.arange(256, dtype=torch.uint8)
    packed = packed._replace(scales=e8)
    want = tp.unpack(packed)
    got = tp.unpack(packed, torch.bfloat16).float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_smallest_scale_bytes_reach_the_route():
    """Weights whose scale bytes are 0, 1 and 2 (2^-128 .. 2^-126, built by
    hand: no packer makes them for weights above 1e-8) against x near
    2^100: the route keeps every product that the plain version keeps."""
    g = torch.Generator().manual_seed(3)
    packed = tp.pack_block_fp_subbyte(torch.from_numpy(_w(24, 640)), 6, 8, None, [1, 16])
    e8 = torch.randint(0, 3, packed.scales.shape, generator=g, dtype=torch.uint8)
    packed = packed._replace(scales=e8)
    x = torch.randn((8, 640), generator=g) * 2.0**100
    want = dm.bfp_matmul_plain(x, packed)
    assert want.abs().max() > 2.0**-40
    got = _route_emulated(x, packed, None)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("m,n,k,width,bs", [(8, 64, 1100, 6, 16), (256, 33, 640, 4, 2),
                                            (3, 20, 2000, 2, 128)])
def test_route_keeps_raw_float32_x(m, n, k, width, bs):
    """Raw x and no quantizer: the route (hi and lo products) against the
    port's float32 plain version, 1e-4 of max|y| (ROADMAP fault 3: the port
    keeps float32 x where the TPU kernel casts it to bf16)."""
    x = torch.from_numpy(_x(m, k))
    packed = tp.pack_block_fp_subbyte(torch.from_numpy(_w(n, k)), width, 8, None, [1, bs])
    hi, lo, lo_rows = dm.actq_split_plain(x, None, dm._k_padded(packed))
    assert lo_rows.all()
    want = dm.bfp_matmul_plain(x, packed)
    got = _route_emulated(x, packed, None)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    # without the lo products the route would lose float32 x
    a, bh = _fragments(packed, hi)
    bf16_only = torch.einsum("ntgjp,mtgjp->mn", a, bh)
    assert (bf16_only - want).abs().max() > (got - want).abs().max()


@pytest.mark.parametrize("m,k_pad", [(1, 640), (8, 1280), (17, 4480), (256, 11520)])
def test_split_workspace_takes_the_subbyte_k_pad(m, k_pad):
    """The sub-byte k_pad is a multiple of the tile (640 at width 6), not
    of 512: kw rounds it up to a multiple of 512 (as lmq_bfp_matmul_subbyte
    and actq_split read it), hi at byte 0, lo at 2 m kw, lo_flags (a byte a
    row and 512 K) at 4 m kw."""
    kw, ws, hi, lo, lo_flags = dm._split_workspace(m, k_pad, "cpu")
    assert kw % 512 == 0 and k_pad <= kw < k_pad + 512
    assert ws.numel() == 4 * m * kw + m * (kw // 512)
    base = ws.data_ptr()
    assert (hi.data_ptr() - base, lo.data_ptr() - base, lo_flags.data_ptr() - base) == (
        0, 2 * m * kw, 4 * m * kw)
    assert hi.shape == lo.shape == (m, kw)


@pytest.mark.parametrize("actq", [None, SPECS[0]])
def test_k3_wrapper_takes_the_plain_version_on_the_cpu(actq):
    x = torch.from_numpy(_x(9, 700))
    packed = tp.pack_block_fp_subbyte(torch.from_numpy(_w(40, 700)), 6, 8, None, [1, 16])
    tk.reset_launch_counts()
    y = dm.bfp_matmul_subbyte_cuda(x, packed, actq)
    assert torch.equal(y, dm.bfp_matmul_plain(x, packed, actq))
    assert torch.equal(dm.bfp_matmul(x, packed, actq), y)
    assert sum(tk.launch_counts().values()) == 0
    assert tk.KERNEL_WRAPPERS["bfp_matmul_subbyte"] is dm.bfp_matmul_subbyte_cuda
