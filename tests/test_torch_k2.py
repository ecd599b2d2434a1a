"""K2's route on the tensor cores, held to the JAX package on the CPU.

K2 (``llm_mixed_q_torch.kernels.dequant_matmul.bfp_matmul_cuda``) is two
kernels: ``actq_split`` quantizes x once a call and writes it as two bf16
terms, hi = bf16(q) and lo = bf16(q - hi); the matmul then multiplies bf16
operands on the tensor cores and sums in float32. These tests hold what
that route computes, on the same numpy inputs:

- ``actq_split_plain`` against the JAX package's in-kernel quantizer
  ``_qdq_lanes_signed`` (run as the JAX kernels run it on the CPU,
  ``interpret=True``), bit for bit: hi and lo are the split of the JAX q;
- the premises of its bf16 operands: block_fp activations of width <= 9
  leave no lo, raw float32 x loses at most 2^-17 of |x|, and every int8
  code times every scale ``pack_block_fp`` can produce is exact in bf16,
  except for the one scale that the kernel applies in float32 (pinned);
- the route's arithmetic emulated in plain torch (split, bf16 operands,
  float32 sums) against ``bfp_matmul_pallas(..., interpret=True)``, to
  1e-4 of max|y|, the JAX package's kernel tolerance
  (``tests/test_kernels.py``: float32 sums in another order).

The CUDA kernels themselves are held against ``actq_split_plain`` and
``bfp_matmul_plain`` on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``)."""

import functools
import re
from pathlib import Path

import jax
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

RNG = np.random.default_rng(9)
SPECS = [(16, 6, 8, 127), (32, 4, 8, 127), (4, 8, 8, 127), (8, 6, 8, None)]
# int8 code times a power-of-two scale is exact in bf16 from this scale up
# (csrc/dequant_matmul.cu: kK2Bf16Scale; bf16 subnormals are multiples of
# 2^-133), and a scale below it is applied as s * 2^64 in the mma and 2^-64
# in float32 (kK2Lift, kK2Drop)
BF16_SCALE, LIFT = 2.0**-133, 2.0**64
CSRC = Path(dm.__file__).resolve().parent.parent / "csrc" / "dequant_matmul.cu"


@functools.lru_cache(maxsize=None)
def _jax_lanes_qdq(bs, width, ew, eb):
    return jax.jit(lambda x: jmm._qdq_lanes_signed(x, bs, width, ew, eb, True))


def _x(m, k):
    """Rows at exponents 2^-8 .. 2^8, none near the 1e-8 passthrough."""
    x = RNG.standard_normal((m, k)) * np.exp2(RNG.integers(-8, 9, (m, 1)))
    return x.astype(np.float32)


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("m", [1, 8, 17, 256])
@pytest.mark.parametrize("k", [64, 1100, 4096])
@pytest.mark.parametrize("actq", SPECS)
def test_actq_split_plain_is_the_jax_lanes_quantizer(m, k, actq):
    """hi and lo of actq_split_plain are the bf16 split of the JAX
    quantizer's q, on x zero-padded to the workspace's K (as
    ``bfp_matmul_pallas`` pads x to the packed K); past K both are 0."""
    x = _x(m, k)
    kw = -(-k // 512) * 512
    q = np.asarray(_jax_lanes_qdq(*actq)(jnp.asarray(np.pad(x, ((0, 0), (0, kw - k))))))
    q = torch.from_numpy(q.copy())
    hi, lo, lo_flags = dm.actq_split_plain(torch.from_numpy(x), actq, kw)
    want_hi = q.to(torch.bfloat16)
    want_lo = (q - want_hi.float()).to(torch.bfloat16)
    assert hi.shape == lo.shape == (m, kw)
    assert torch.equal(_bits(hi), _bits(want_hi))
    assert torch.equal(_bits(lo), _bits(want_lo))
    assert torch.equal(lo_flags.any(dim=1), (want_lo != 0).any(dim=1))
    assert not hi[:, k:].any() and not lo[:, k:].any()


@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8, 9])
def test_block_fp_activations_leave_no_lo(width):
    """block_fp at data_in width <= 9 keeps at most 8 significant bits: hi
    is q itself, lo is 0 and no row is flagged (K2 then skips the lo
    products)."""
    x = torch.from_numpy(_x(17, 1100))
    actq = (16, width, 8, 127)
    hi, lo, lo_rows = dm.actq_split_plain(x, actq, 1536)
    assert not lo.any() and not lo_rows.any()
    q = dm._actq_qdq(x, actq)
    assert torch.equal(hi[:, :1100].float(), q)


@pytest.mark.parametrize("exp_lo,exp_hi", [(-8, 8), (-100, 100), (-126, -110)])
def test_raw_float32_x_keeps_float32(exp_lo, exp_hi):
    """With no quantizer, hi + lo holds x to 2^-17 of |x| (ROADMAP fault 3:
    the port keeps float32 x where the TPU kernel casts it to bf16); below
    2^-117, where lo is a bf16 subnormal, to an absolute 2^-134 (K1's
    split, tests/test_torch_cuda_kernels.py)."""
    x = RNG.standard_normal((8, 1000)) * np.exp2(RNG.integers(exp_lo, exp_hi + 1, (8, 1000)))
    x = torch.from_numpy(x.astype(np.float32))
    hi, lo, lo_rows = dm.actq_split_plain(x, None)
    err = (x.double() - hi.double() - lo.double()).abs()
    bound = torch.maximum(x.double().abs() * 2.0**-17, torch.full_like(err, 2.0**-134))
    assert (err <= bound).all()
    assert lo_rows.all()


@pytest.mark.parametrize("width", [2, 3, 4, 5, 6, 7, 8])
def test_int8_weights_are_bf16_exact_but_one_scale(width):
    """Every code of ``width`` bits times every scale 2^(e - width + 1),
    e in [-127, 128] (exponent width 8, bias 127), is exact in bf16, except
    odd codes at width 8 times 2^-134, the one scale under 2^-133: the
    kernel applies such a scale as s * 2^64 in the mma (exact for every
    code) and 2^-64 in float32. ``pack_block_fp`` never pairs it with a
    nonzero code (a nonzero code needs |w| > 1e-8, so a block max > 1e-8
    and a scale >= 2^-33), even for weights at the bottom of the range."""
    cmax = 2 ** (width - 1) - 1
    codes = torch.arange(-cmax, cmax + 1, dtype=torch.float64)
    scales = torch.exp2(torch.arange(-127, 129, dtype=torch.float64) - (width - 1))
    prod = (codes[None, :] * scales[:, None]).float()
    assert torch.equal(prod.double(), codes[None, :] * scales[:, None])  # exact in float32
    inexact = prod.to(torch.bfloat16).float() != prod
    tiny = (scales.float() < BF16_SCALE)[:, None].expand_as(inexact)
    assert not (inexact & ~tiny).any()
    if width == 8:
        assert torch.equal(inexact, tiny & (codes.remainder(2) == 1)[None, :])
    else:
        assert not tiny.any()
    lifted = (codes[None, :] * scales[:, None] * LIFT).float()
    assert torch.equal(lifted.to(torch.bfloat16).float(), lifted)
    # weights at the bottom of the range: blocks whose max is 2^-127, a
    # subnormal, 1e-8 and just above it, and zero blocks
    w = torch.randn((4, 128), generator=torch.Generator().manual_seed(width))
    w[0] *= 2.0**-130
    w[1, :16] = 2.0**-127
    w[1, 16:32] = 1e-45
    w[2, :16] = 1e-8
    w[2, 16:32] = 1.5e-8
    w[3, :32] = 0.0
    packed = tp.pack_block_fp(w, width, 8, None, [1, 16])
    s = packed.scales.repeat_interleave(16, dim=1)
    assert (packed.codes[s < BF16_SCALE] == 0).all()
    assert (s[packed.codes != 0] >= 2.0**-33).all()


def test_the_kernel_constants_are_these():
    """The scale threshold and lift above are csrc/dequant_matmul.cu's."""
    src = CSRC.read_text()
    assert re.search(r"kK2Bf16Scale = 0x1p-133f", src)
    assert re.search(r"kK2Lift = 0x1p64f, kK2Drop = 0x1p-64f", src)
    assert re.search(r"constexpr int kK2WsK = 512;", src) and dm._WS_K == 512


def _route_emulated(x2, packed, actq):
    """K2's arithmetic in plain torch: actq_split's hi and lo, the weight as
    bf16 (code times scale, or times scale * 2^64 for a scale under 2^-133;
    at blocks of 1 and 2 each code with its own scale, as the kernel's
    per-code path reads them), products summed in float32, the lifted part
    times 2^-64 in float32."""
    hi, lo, lo_rows = dm.actq_split_plain(x2, actq, packed.codes.shape[1])
    codes = packed.codes.float()
    s = packed.scales.repeat_interleave(packed.block_size, dim=1)
    tiny = (s > 0) & (s < BF16_SCALE)
    zero = torch.zeros_like(s)
    w = (codes * torch.where(tiny, zero, s)).to(torch.bfloat16)
    w_fix = (codes * torch.where(tiny, s * LIFT, zero)).to(torch.bfloat16)
    assert torch.equal(w.float(), codes * torch.where(tiny, zero, s))  # exact operands
    assert torch.equal(w_fix.float(), codes * torch.where(tiny, s * LIFT, zero))

    def prod(wt):
        y = torch.matmul(hi.float(), wt.float().t())
        if lo_rows.any():
            y = y + torch.matmul(lo.float(), wt.float().t())
        return y

    y = prod(w)
    if tiny.any():
        y = y + prod(w_fix) * 2.0**-64
    return y


ROUTE_CASES = [  # m, n, k, bs, k_stride; bs 1 and 2: a scale a code or a pair
    (5, 32, 704, 16, None), (17, 48, 1100, 8, 1024), (8, 40, 4096, 32, None),
    (5, 32, 704, 1, None), (9, 40, 1100, 2, 1024),
]


@pytest.mark.parametrize("m,n,k,bs,k_stride", ROUTE_CASES)
@pytest.mark.parametrize("actq", [None] + SPECS[:3])
def test_route_matches_jax_kernel(m, n, k, bs, k_stride, actq):
    """The emulated route against the TPU kernel in interpret mode. As in
    the pipeline, x arrives block_fp-quantized when there is no in-kernel
    quantizer (the TPU kernel casts raw x to bf16: ROADMAP fault 3)."""
    x = _x(m, k)
    if actq is None:
        x = np.array(_jax_qdq(jnp.asarray(x), 6, 8, None, [1, 16], True))
    w = (RNG.standard_normal((n, k)) * 0.05).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    jpk = jp.pack_block_fp(jnp.asarray(w), 6, 8, None, [1, bs], k_stride=k_stride)
    tpk = tp.pack_block_fp(torch.from_numpy(w), 6, 8, None, [1, bs], k_stride=k_stride)
    want = np.asarray(jmm.bfp_matmul_pallas(jnp.asarray(x), jpk, interpret=True, actq=actq))
    got = _route_emulated(torch.from_numpy(x), tpk, actq).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("m,n,k,bs", [(8, 64, 1100, 16), (256, 33, 640, 4)])
def test_route_keeps_raw_float32_x(m, n, k, bs):
    """Raw x and no quantizer: the route (hi and lo products) against the
    port's float32 plain version, 1e-4 of max|y|."""
    x = torch.from_numpy(_x(m, k))
    w = torch.from_numpy((RNG.standard_normal((n, k)) * 0.05).astype(np.float32))
    packed = tp.pack_block_fp(w, 6, 8, None, [1, bs])
    want = dm.bfp_matmul_plain(x, packed)
    got = _route_emulated(x, packed, None)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_route_applies_a_tiny_scale_in_float32():
    """Codes next to a 2^-134 scale (no packer makes one; built by hand)
    and x near 2^100: the lifted route keeps these products, bf16 weights
    would round half of them away."""
    g = torch.Generator().manual_seed(4)
    codes = torch.randint(-127, 128, (16, 64), generator=g, dtype=torch.int8)
    scales = torch.full((16, 4), 2.0**-10)
    scales[:, 1] = 2.0**-134
    scales[3, :] = 2.0**-134
    packed = tp.PackedBFP(codes, scales, 8, 16, 16, 64)
    x = torch.randn((3, 64), generator=g)
    x[:, 16:32] *= 2.0**100  # the tiny blocks' products near 2^-34
    x[:, :16] *= 2.0**-60
    x[:, 32:] *= 2.0**-60
    want = dm.bfp_matmul_plain(x, packed)
    got = _route_emulated(x, packed, None)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    unlifted = torch.matmul(x, (codes.float() * scales.repeat_interleave(16, 1))
                            .to(torch.bfloat16).float().t())
    assert (unlifted - want).abs().max() > 1e-3 * want.abs().max()


def test_k2_wrappers_take_the_plain_versions_on_the_cpu():
    x = torch.from_numpy(_x(9, 700))
    packed = tp.pack_block_fp(torch.from_numpy(_x(40, 700)) * 0.01, 6, 8, None, [1, 16])
    tk.reset_launch_counts()
    y = dm.bfp_matmul_cuda(x, packed, SPECS[0])
    assert torch.equal(y, dm.bfp_matmul_plain(x, packed, SPECS[0]))
    hi, lo, lo_rows = dm.actq_split_cuda(x, SPECS[0], 704)
    want = dm.actq_split_plain(x, SPECS[0], 1024)
    assert all(torch.equal(a, b) for a, b in zip((hi, lo, lo_rows), want))
    assert sum(tk.launch_counts().values()) == 0
    assert tk.KERNEL_WRAPPERS["actq_split"] is dm.actq_split_cuda


@pytest.mark.parametrize("m,k_pad", [(1, 64), (17, 1104), (256, 11264)])
def test_split_workspace_is_the_kernels_layout(m, k_pad):
    """hi at byte 0, lo at 2 m kw, lo_flags (a byte a row and 512 K) at
    4 m kw (as ``lmq_bfp_matmul_int8`` and ``lmq_actq_split`` read it), kw
    a multiple of 512 at least k_pad."""
    kw, ws, hi, lo, lo_flags = dm._split_workspace(m, k_pad, "cpu")
    assert kw % 512 == 0 and k_pad <= kw < k_pad + 512
    assert ws.numel() == 4 * m * kw + m * (kw // 512)
    base = ws.data_ptr()
    assert (hi.data_ptr() - base, lo.data_ptr() - base, lo_flags.data_ptr() - base) == (
        0, 2 * m * kw, 4 * m * kw)
    assert hi.shape == lo.shape == (m, kw) and lo_flags.shape == (m, kw // 512)
