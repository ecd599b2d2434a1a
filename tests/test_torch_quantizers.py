"""Port quantizers (llm_mixed_q_torch.ops.quantizers) against the JAX
package's, bit for bit: the same numpy inputs go through both.

Inputs are random normals, so no block maximum sits exactly on a power of
two where XLA:CPU's log2 is inexact; ``test_exact_ceil_log2_diverges_from_xla``
pins that divergence on purpose."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.ops import quantizers as jq
from llm_mixed_q_torch.ops import quantizers as tq
from llm_mixed_q_torch.ops.functions import make_entry_quantizer
from llm_mixed_q_torch.ops.quantizers.exact import ceil_log2

RNG = np.random.default_rng(0)


def _x(shape, scale=0.3):
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    flat[::29] = 0.0  # exact zeros
    flat[5] = 5e-9  # |x| <= 1e-8 passthrough
    return x


def _same(a, b):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


# the four blocking layouts: 1-D bias, per-row activation, 2-D weight
# tile, per-batch 2-D tile of a 3-D activation
LAYOUTS = [
    ((70,), [16], False),
    ((6, 70), [1, 16], True),
    ((12, 70), [4, 16], False),
    ((3, 5, 70), [2, 16], True),
]


@pytest.mark.parametrize("shape,block,skip", LAYOUTS)
@pytest.mark.parametrize("width,bias", [(6, 127), (4, None), (8, 100)])
def test_block_fp_matches_jax(shape, block, skip, width, bias):
    x = _x(shape)
    if len(shape) == 2:
        x[0, :16] = 0.0  # an all-zero block
    want = jq._block_fp_qdq(jnp.asarray(x), width, 8, bias, block, skip)
    got = tq._block_fp_qdq(torch.from_numpy(x), width, 8, bias, block, skip)
    _same(want, got)


@pytest.mark.parametrize("width,frac", [(8, 7), (4, 2), (12, 9)])
def test_integer_matches_jax(width, frac):
    x = _x((7, 33), scale=2.0)
    _same(jq._integer_qdq(jnp.asarray(x), width, frac),
          tq._integer_qdq(torch.from_numpy(x), width, frac))


def test_ste_gradient_is_identity():
    x = torch.from_numpy(_x((4, 32))).requires_grad_()
    cfg = {"name": "block_fp", "data_in_width": 6, "data_in_exponent_width": 8,
           "data_in_exponent_bias": None, "data_in_block_size": [1, 16]}
    y = make_entry_quantizer(cfg, "data_in", skip_first_dim=True)(x)
    (y * torch.arange(32.0)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.tile(np.arange(32.0), (4, 1)))


@pytest.mark.parametrize("name", ["block_log", "block_minifloat", "log",
                                  "minifloat_denorm", "minifloat_ieee"])
def test_unported_quantizers_raise(name):
    """The five quantizers the serving slices left out no longer raise:
    ``get_quantizer`` returns each one's STE wrapper (their parity with the
    JAX package: tests/test_torch_arith.py)."""
    q = tq.get_quantizer(name)
    assert q is tq.QUANTIZER_MAP[name] and q.__wrapped__ is getattr(tq, f"_{name}_qdq")


def test_exact_ceil_log2_diverges_from_xla():
    """XLA:CPU gives log2(2^-13) = -12.99999 and ceil -12; the port takes
    the exact -13, as the native C++ packer does."""
    m = np.float32(2.0 ** -13)
    assert float(ceil_log2(torch.tensor([m]))[0]) == -13.0
    assert float(jnp.ceil(jnp.log2(jnp.float32(m)))) == -12.0
    x = np.full((1, 16), m, np.float32)
    x[0, 1:] = np.float32(2.0 ** -14)
    got = tq._block_fp_qdq(torch.from_numpy(x), 6, 8, None, [1, 16], True).numpy()
    want = np.asarray(jq._block_fp_qdq(jnp.asarray(x), 6, 8, None, [1, 16], True))
    # exact exponent -13: the block max saturates at 31/32 * 2^-13; XLA's
    # exponent -12 keeps it exact. The 2^-14 elements agree.
    assert got[0, 0] == np.float32(31 / 32 * 2.0 ** -13) and want[0, 0] == m
    np.testing.assert_array_equal(got[0, 1:], want[0, 1:])
