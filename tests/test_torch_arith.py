"""The five quantizers the serving slices left out (minifloat denorm and
ieee, log, block_minifloat, block_log) and the ops that bind all seven,
against the JAX package, bit for bit: the same numpy inputs go through
both.

The port takes floor, ceil and round of the float32-rounded log2 without
a libm (``exact.py``); XLA:CPU's log2 departs from it at some exact powers
of two and within a few dozen float32 steps of 2^k and sqrt(2)*2^k.
Inputs are random normals, so no value or block maximum sits there;
block_log inputs have no exact zeros, where XLA:CPU's flushing of
subnormals departs from IEEE arithmetic. One test a quantizer pins a
departure on purpose (ROADMAP.md, faults 1 and 10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.ops import functions as jf
from llm_mixed_q_tpu.ops import quantizers as jq
from llm_mixed_q_tpu.utils.toml_io import load_config
from llm_mixed_q_torch.ops import functions as tf
from llm_mixed_q_torch.ops import quantizers as tq
from llm_mixed_q_torch.ops.quantizers.exact import (
    ceil_log2,
    ceil_log2_f32,
    floor_log2_f32,
    round_log2_f32,
)

RNG = np.random.default_rng(1)
TOMLS = "configs/quantization/{}.toml"


def _x(shape, scale=0.3, zeros=True):
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    flat[::29] = 0.0 if zeros else 1e-3  # exact zeros
    flat[5] = 5e-9  # |x| <= 1e-8 passthrough
    return x


def _same(a, b):
    a, b = np.asarray(a), b.detach().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


# the four blocking layouts of tests/test_torch_quantizers.py: 1-D bias,
# per-row activation, 2-D weight tile, per-batch 2-D tile of a 3-D
# activation (the elementwise quantizers take the shapes alone)
LAYOUTS = [
    ((70,), [16], False),
    ((6, 70), [1, 16], True),
    ((12, 70), [4, 16], False),
    ((3, 5, 70), [2, 16], True),
]

# (name, keyword arguments): the TOMLs' widths and biases, then others
CASES = [
    ("minifloat_denorm", dict(width=8, exponent_width=4, exponent_bias=7)),
    ("minifloat_denorm", dict(width=6, exponent_width=3, exponent_bias=None)),
    ("minifloat_ieee", dict(width=8, exponent_width=4, exponent_bias=7)),
    ("minifloat_ieee", dict(width=6, exponent_width=3, exponent_bias=None)),
    ("log", dict(width=8, exponent_bias=63)),
    ("log", dict(width=5, exponent_bias=None)),
    ("block_minifloat", dict(width=8, exponent_width=4, exponent_bias_width=8)),
    ("block_minifloat", dict(width=6, exponent_width=3, exponent_bias_width=4)),
    ("block_log", dict(width=8, exponent_bias_width=8)),
    ("block_log", dict(width=5, exponent_bias_width=6)),
]
QDQ = {name: (getattr(jq, f"_{name}_qdq"), getattr(tq, f"_{name}_qdq"))
       for name in ("minifloat_denorm", "minifloat_ieee", "log", "block_minifloat",
                    "block_log")}


@pytest.mark.parametrize("shape,block,skip", LAYOUTS)
@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{kw['width']}" for n, kw in CASES])
def test_quantizer_matches_jax(name, kw, shape, block, skip):
    x = _x(shape, zeros=name != "block_log")
    if name.startswith("block"):
        kw = dict(kw, block_size=block, skip_first_dim=skip)
    jfn, tfn = QDQ[name]
    _same(jfn(jnp.asarray(x), **kw), tfn(torch.from_numpy(x), **kw))


def test_log2_roundings():
    """floor, ceil and round of the float32-rounded log2 against numpy's
    float64 log2 rounded to float32, and the exact ceil against frexp, at
    every float32 power of two, at sqrt(2)*2^k, and 40 float32 steps either
    side of each (where the float32 log2 rounds onto k or k + 1/2); 0 and
    +inf."""
    f32 = np.float32
    p = np.ldexp(f32(1), np.arange(-149, 128)).astype(f32)
    s = (np.sqrt(2.0) * np.ldexp(1.0, np.arange(-149, 127))).astype(f32)
    vs = [p, s]
    for a in (p, s):
        lo, hi = a, a
        for _ in range(40):
            lo, hi = np.nextafter(lo, f32(0)), np.nextafter(hi, f32(np.inf))
            vs += [lo, hi]
    v = np.concatenate(vs)
    v = v[(v > 0) & np.isfinite(v)]
    y = np.log2(v.astype(np.float64)).astype(f32)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(floor_log2_f32(t).numpy(), np.floor(y))
    np.testing.assert_array_equal(ceil_log2_f32(t).numpy(), np.ceil(y))
    np.testing.assert_array_equal(round_log2_f32(t).numpy(), np.round(y))
    mant, ex = np.frexp(v.astype(np.float64))  # v = mant * 2^ex, mant in [0.5, 1)
    np.testing.assert_array_equal(ceil_log2(t).numpy(), np.where(mant == 0.5, ex - 1, ex))
    edge = torch.tensor([0.0, float("inf")])
    for fn in (floor_log2_f32, ceil_log2_f32, round_log2_f32, ceil_log2):
        assert fn(edge).tolist() == [float("-inf"), float("inf")]


# one departure from the JAX package a quantizer, pinned: (name, kw, x[0],
# the other 15 elements of its block, the port's x[0], the JAX package's)
_DEPARTURES = [
    # XLA:CPU: log2(2^-13) = -12.99999, ceil -12. |x| + 1e-9 is 2^-13: the
    # exponent -13 saturates the 3-bit mantissa of the denorm format
    # at 7/8; JAX's -12 holds 2^-13 as 4/8
    ("minifloat_denorm", dict(width=8, exponent_width=4, exponent_bias=15),
     np.float32(2.0 ** -13) - np.float32(1e-9), 0.25, 0.875 * 2.0 ** -13, 2.0 ** -13),
    # XLA:CPU: log2(2^13) = 12.99999, floor 12: JAX's mantissa 2 saturates
    # at 1 + 3/4 of 2^12
    ("minifloat_ieee", dict(width=8, exponent_width=5, exponent_bias=1),
     2.0 ** 13, 0.25, 2.0 ** 13, 1.75 * 2.0 ** 12),
    # 6 float32 steps under sqrt(2) * 2^-17: the nearest float32 of its log2
    # is -16.500002, which rounds to -17; XLA's (a log, then a division by
    # ln 2) is -16.5, which round takes to even -16
    ("log", dict(width=8, exponent_bias=63),
     np.float32(1.0789586e-05), 0.25, 2.0 ** -17, 2.0 ** -16),
    # a block max of 2^13: JAX's shared bias floor(12.99999) = 12 leaves
    # the exponents [-12, 3], where 2^13 saturates at 1.875 * 2^3; the bias
    # 13 leaves [-13, 2]
    ("block_minifloat", dict(width=8, exponent_width=4, exponent_bias_width=8,
                             block_size=[16], skip_first_dim=False),
     2.0 ** 13, 0.25, 7.5, 15.0),
    # XLA:CPU flushes subnormals: a block max of 0.5 gives the log bias 128,
    # and min_pos * 0.1 = 2^-128 * 0.1 is flushed, so JAX maps 0 to 0
    # where IEEE arithmetic (and the torch reference) gives min_pos
    ("block_log", dict(width=8, exponent_bias_width=8, block_size=[16], skip_first_dim=False),
     0.0, 0.5, 2.0 ** -128, 0.0),
]


@pytest.mark.parametrize("name,kw,x0,rest,port,xla", _DEPARTURES, ids=[d[0] for d in _DEPARTURES])
def test_departure_from_xla_pinned(name, kw, x0, rest, port, xla):
    x = np.full(16, rest, np.float32)
    x[0] = x0
    jfn, tfn = QDQ[name]
    got = tfn(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jfn(jnp.asarray(x), **kw))
    assert (got[0], want[0]) == (np.float32(port), np.float32(xla))
    np.testing.assert_array_equal(got[1:], want[1:])


@pytest.mark.parametrize("name", ["block_fp", "block_minifloat"])
def test_subnormal_block_maxima_match_jax(name):
    """XLA:CPU's log2 of a subnormal block max is -inf, frexp's the true
    exponent; the exponent clamps make the outputs agree. (block_log's do
    not: its subnormal elements meet fault 10, the flush.)"""
    x = np.array([3e-39, -1e-40, 2.0 ** -140, 0.0] + [1e-41] * 12 + [0.5] * 16, np.float32)
    cfg = load_config(TOMLS.format("bfp_6bit" if name == "block_fp" else name))["default"]
    kw = dict(width=cfg["weight_width"], block_size=[16], skip_first_dim=False)
    if name == "block_fp":
        kw.update(exponent_width=8, exponent_bias=None)
        jfn, tfn = jq._block_fp_qdq, tq._block_fp_qdq
    else:
        kw.update(exponent_width=cfg["weight_exponent_width"],
                  exponent_bias_width=cfg["weight_exponent_bias_width"])
        jfn, tfn = QDQ[name]
    _same(jfn(jnp.asarray(x), **kw), tfn(torch.from_numpy(x), **kw))


# each arithmetic with the default section of its TOML (bypass.toml is a
# bypass integer node; block_fp.toml's 8-bit arm stands beside bfp_6bit's)
ARITH_TOMLS = {"integer": "integer", "block_fp": "bfp_6bit", "minifloat_denorm": "minifloat_denorm",
               "minifloat_ieee": "minifloat_ieee", "log": "log",
               "block_minifloat": "block_minifloat", "block_log": "block_log"}


def _cfg(arith):
    return load_config(TOMLS.format(ARITH_TOMLS[arith]))["default"]


def test_get_quantizer_has_all_seven():
    assert set(tq.QUANTIZER_MAP) == set(jq.QUANTIZER_MAP) == set(ARITH_TOMLS)


@pytest.mark.parametrize("arith", list(ARITH_TOMLS))
def test_entry_quantizers_match_jax(arith):
    """data_in (per-row blocks), weight (2-D tiles) and bias (1-D blocks)
    bound from the TOML's keys."""
    cfg = _cfg(arith)
    zeros = arith != "block_log"
    for entry, shape, skip in (("data_in", (6, 70), True), ("weight", (12, 70), False),
                               ("bias", (70,), False)):
        x = _x(shape, zeros=zeros)
        _same(jf.make_entry_quantizer(cfg, entry, skip_first_dim=skip)(jnp.asarray(x)),
              tf.make_entry_quantizer(cfg, entry, skip_first_dim=skip)(torch.from_numpy(x)))


@pytest.mark.parametrize("name", list(QDQ))
def test_ste_gradient_matches_jax(name):
    """The backward of each new quantizer is the identity, as jax.grad of
    the JAX package's custom VJP gives it."""
    cfg = _cfg(name)
    x = _x((4, 32), zeros=name != "block_log")
    w = RNG.standard_normal((4, 32)).astype(np.float32)
    jfn = jf.make_entry_quantizer(cfg, "data_in", skip_first_dim=True)
    want = jax.grad(lambda v: jnp.sum(jfn(v) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tf.make_entry_quantizer(cfg, "data_in", skip_first_dim=True)(xt) * torch.from_numpy(w)).sum().backward()
    _same(want, xt.grad)


@pytest.mark.parametrize("arith", list(ARITH_TOMLS))
def test_quantized_matmul_matches_jax(arith):
    """Rank-4 (attention's bmm) and rank-2 products: operands quantized as
    the JAX package quantizes them (a "log" matmul is a plain log one; a
    block_log one leaves y as it is); float32 sums in another order, so
    1e-5 of max|y|."""
    cfg = _cfg(arith)
    zeros = arith != "block_log"
    for xs, ys in (((2, 3, 6, 32), (2, 3, 32, 20)), ((6, 32), (32, 20))):
        x, y = _x(xs, zeros=zeros), _x(ys, zeros=zeros)
        want = np.asarray(jf.quantized_matmul(jnp.asarray(x), jnp.asarray(y), cfg))
        got = tf.quantized_matmul(torch.from_numpy(x), torch.from_numpy(y), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arith", list(ARITH_TOMLS))
def test_quantized_rope_matches_jax(arith):
    """The cos/sin tables quantized with the node's data_in keys (2-D
    blocks for the block arithmetics), the rotation in full precision.
    block_log maps sin(0) = 0 to its min_pos, a subnormal that XLA:CPU
    flushes (fault 10): there the port's products are subnormal and
    JAX's 0."""
    from llm_mixed_q_torch.models.llama.modeling import rope_tables

    cfg = _cfg(arith)
    b, h, s, d = 2, 2, 24, 32
    q, k = _x((b, h, s, d)), _x((b, h, s, d))
    cos, sin = (t.numpy() for t in rope_tables(40, d, 10000.0))
    pos = np.stack([np.arange(s), np.arange(5, 5 + s)]).astype(np.int32)
    want = jf.quantized_apply_rotary_pos_emb(*(jnp.asarray(a) for a in (q, k, cos, sin, pos)), cfg)
    got = tf.quantized_apply_rotary_pos_emb(
        *(torch.from_numpy(a) for a in (q, k, cos, sin)), torch.from_numpy(pos).long(), cfg)
    for w, g in zip(want, got):
        w = np.asarray(w)
        if arith == "block_log":
            tiny = g.abs().numpy() < np.finfo(np.float32).tiny
            assert (w[tiny] == 0).all()
            g = torch.where(torch.from_numpy(tiny), 0.0, g)
        _same(w, g)
