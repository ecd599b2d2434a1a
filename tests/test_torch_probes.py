"""The port's probes (``llm_mixed_q_torch.tools``: P8, P9, P11) against the
TPU probes they replace (``tools/ksub.py``, ``tools/aprobe.py``), whose
Pallas kernels run here in interpret mode on the same numpy inputs.

On a CPU tensor each probe wrapper computes its plain version; the CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerances:
- sub-byte variants: 1e-5 of max|y| (float32 sums of the same products in
  another order); ``stream`` 1e-3, for its int32 -> bf16 conversion;
- attention ``dma``/``dequant``: bit-exact (both return q);
- ``softmax``/``quant``: rtol 2e-4 / atol 2e-5, the JAX package's decode
  attention tolerance (the port sums the softmax denominator in float64);
- ``matmul``: relative to max|ctx|, since its dense sums over every lane
  cancel and an element near 0 has no relative precision: 1e-5 with
  float32 dots; 1e-3 with bf16 dots, where a score whose float32 sum lands
  on the other side of a bf16 rounding point moves by one bf16 step."""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from llm_mixed_q_tpu.kernels import attention_decode as jattn
from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_torch.kernels import packing as tp
from llm_mixed_q_torch.tools import aprobe as tap
from llm_mixed_q_torch.tools import ksub as tks

REPO = Path(__file__).resolve().parent.parent
N, K, BN = 256, 640, 128  # two column blocks, one packing tile at width 6
BATCH, S_LEN = 2, 16


def _load_tool(name, argv):
    """tools/<name>.py by file path; it reads sys.argv at import."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}",
                                                      REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ksub():
    return _load_tool("ksub", [f"--bn={BN}"])


@pytest.fixture(scope="module")
def aprobe():
    return _load_tool("aprobe", [f"--batch={BATCH}", f"--s={S_LEN}"])


@pytest.fixture(scope="module")
def packed(ksub):
    """One weight packed by both packages (lane-major), and x over K_pad."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((N, K)) * 0.02).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    jpk = jp.pack_block_fp_subbyte(jnp.asarray(w), ksub.WIDTH, 8, 127, [1, ksub.BLOCK])
    tpk = tp.pack_block_fp_subbyte(torch.from_numpy(w), ksub.WIDTH, 8, 127, [1, ksub.BLOCK])
    k_pad = (jpk.words.shape[1] // 128) * ksub.TILE
    x = rng.standard_normal((ksub.M, k_pad)).astype(np.float32)
    return jpk, tpk, x


def _ksub_lane_major(ksub, jpk, x, variant):
    """ksub.kernel in interpret mode with make_call's BlockSpecs."""
    nt = x.shape[1] // ksub.TILE
    return np.asarray(pl.pallas_call(
        functools.partial(ksub.kernel, variant=variant),
        grid=(1, N // BN, nt),
        in_specs=[pl.BlockSpec((ksub.M, ksub.TILE), lambda i, j, k: (i, k)),
                  pl.BlockSpec((BN, 128), lambda i, j, k: (j, k)),
                  pl.BlockSpec((1, BN, ksub.TILE // ksub.BLOCK), lambda i, j, k: (k, j, 0))],
        out_specs=pl.BlockSpec((ksub.M, BN), lambda i, j, k: (i, j)),
        out_shape=jax.ShapeDtypeStruct((ksub.M, N), jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jpk.words, jpk.scales))


def _close_to_max(got, want, tol):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _ksub_tol(variant):
    return 1e-3 if variant == "stream" else 1e-5


@pytest.mark.parametrize("variant", ["ship", "stream", "extract", "mulconst", "muladd",
                                     "shift2", "noconcat", "lanerepeat"])
def test_lane_major_probe_plain_matches_jax_kernel(ksub, packed, variant):
    jpk, tpk, x = packed
    want = _ksub_lane_major(ksub, jpk, x, variant)
    got = tks.subbyte_probe(torch.from_numpy(x), tpk, variant).numpy()
    _close_to_max(got, want, _ksub_tol(variant))


@pytest.mark.parametrize("kfn", ["tkernel", "tkernel2"])
def test_transposed_probe_plain_matches_jax_kernel(ksub, packed, kfn):
    """tkernel / tkernel2 with make_tcall's BlockSpecs on transpose_pack's
    buffers; the port's transposed ship on transpose_subbyte's."""
    jpk, tpk, x = packed
    words_t, scales_t = ksub.transpose_pack(jpk)
    nt = x.shape[1] // ksub.TILE
    want = np.asarray(pl.pallas_call(
        getattr(ksub, kfn),
        grid=(1, N // BN, nt),
        in_specs=[pl.BlockSpec((ksub.M, ksub.TILE), lambda i, j, k: (i, k)),
                  pl.BlockSpec((128, BN), lambda i, j, k: (k, j)),
                  pl.BlockSpec((ksub.TILE // ksub.BLOCK, BN), lambda i, j, k: (k, j))],
        out_specs=pl.BlockSpec((ksub.M, BN), lambda i, j, k: (i, j)),
        out_shape=jax.ShapeDtypeStruct((ksub.M, N), jnp.float32),
        interpret=True,
    )(jnp.asarray(x), words_t, scales_t))
    got = tks.subbyte_probe(torch.from_numpy(x), tp.transpose_subbyte(tpk), kfn).numpy()
    _close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("variant", ["stream", "extract", "mulconst", "muladd", "shift2"])
def test_transposed_probe_plain_matches_lane_major_jax_kernel(ksub, packed, variant):
    """The stages are defined on the stored words whatever their layout:
    the port's transposed variants equal the TPU probe's lane-major ones."""
    jpk, tpk, x = packed
    want = _ksub_lane_major(ksub, jpk, x, variant)
    got = tks.subbyte_probe(torch.from_numpy(x), tp.transpose_subbyte(tpk), variant).numpy()
    _close_to_max(got, want, _ksub_tol(variant))


def test_transpose_pack_is_the_port_transposed_layout(ksub, packed):
    jpk, tpk, _ = packed
    words_t, scales_t = ksub.transpose_pack(jpk)
    t = tp.transpose_subbyte(tpk)
    np.testing.assert_array_equal(np.asarray(words_t), t.words.numpy())
    np.testing.assert_array_equal(np.asarray(scales_t), t.scales.numpy())


def test_probe_x_short_of_k_pad_reads_zeros(packed):
    """x narrower than K_pad (the production kernels' [M, K]) is read as 0
    past its width, for every variant."""
    _, tpk, x = packed
    for variant in tks.VARIANTS:
        got = tks.subbyte_probe(torch.from_numpy(x[:, :K - 40].copy()), tpk, variant)
        padded = np.concatenate([x[:, :K - 40], np.zeros_like(x[:, K - 40:])], axis=1)
        want = tks.subbyte_probe(torch.from_numpy(padded), tpk, variant)
        assert torch.equal(got, want), variant


def _aprobe_jax(aprobe, stage, dt, inputs):
    q, kc, ks, vc, vs, pos = inputs
    b, nh, hd, lanes = aprobe.B, aprobe.NH, aprobe.HD, aprobe.LANES
    return np.asarray(pl.pallas_call(
        functools.partial(aprobe.variant_kernel, stage=stage, dt=dt),
        grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((1, nh, hd), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, hd, lanes), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, hd // aprobe.BSK, lanes), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, hd, lanes), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, hd // aprobe.BSV, lanes), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, nh, hd), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, nh, hd), jnp.float32),
        interpret=True,
    )(pos, q, kc, ks, vc, vs))


@pytest.fixture(scope="module")
def attn_inputs(aprobe):
    """aprobe.make_inputs and the port's make_inputs: the same arrays."""
    jin = aprobe.make_inputs()
    tin = tap.make_inputs(BATCH, S_LEN, device="cpu")
    for a, b in zip(jin, tin):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jin, tin


@pytest.mark.parametrize("stage,dot", [(s, d) for s in tap.STAGES for d in tap.DOTS[s]])
def test_attention_probe_plain_matches_jax_kernel(aprobe, attn_inputs, stage, dot):
    jin, tin = attn_inputs
    want = _aprobe_jax(aprobe, stage, jnp.float32 if dot == "f32" else jnp.bfloat16, jin)
    got = tap.attention_probe(*tin, stage, dot).numpy()
    if stage in ("dma", "dequant"):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tin[0].numpy())
    elif stage == "matmul":
        _close_to_max(got, want, 1e-5 if dot == "f32" else 1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_attention_quant_stage_matches_the_shipping_jax_kernel(attn_inputs):
    """The quant stage with bf16 dots is the TPU's shipping kernel with
    exact_q (bf16 dots); held as the port's K4 plain version is held."""
    jin, tin = attn_inputs
    q, kc, ks, vc, vs, pos = jin
    want = np.asarray(jattn.packed_attention_decode_batch(
        q, kc, ks, vc, vs, pos, tap.BSK, tap.BSV, nkv=tap.NKV, rep=tap.REP,
        prob_q=tap.PROB_Q, exact_q=True, interpret=True))
    got = tap.attention_probe(*tin, "quant", "bf16").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_quant_stage_with_f32_dots_is_k4_plain(attn_inputs):
    """Faithfulness on the CPU: the quant stage with float32 dots is K4's
    plain version, with ragged positions too."""
    from llm_mixed_q_torch.kernels.attention_decode import packed_attention_decode_batch_cuda

    _, (q, kc, ks, vc, vs, _) = attn_inputs
    pos = torch.tensor([S_LEN - 1, 5], dtype=torch.int32)
    got = tap.attention_probe(q, kc, ks, vc, vs, pos, "quant", "f32")
    want = packed_attention_decode_batch_cuda(q, kc, ks, vc, vs, pos, tap.BSK, tap.BSV,
                                              nkv=tap.NKV, rep=tap.REP, prob_q=tap.PROB_Q)
    assert torch.equal(got, want)


def test_probe_wrappers_take_the_plain_version_on_the_cpu(packed, attn_inputs):
    from llm_mixed_q_torch import tools

    _, tpk, x = packed
    tools.reset_launch_counts()
    tks.subbyte_probe(torch.from_numpy(x), tpk, "ship")
    tks.subbyte_probe(torch.from_numpy(x), tp.transpose_subbyte(tpk), "ship")
    tap.attention_probe(*attn_inputs[1], "softmax")
    counts = tools.launch_counts()
    assert {"probe_subbyte_t", "probe_subbyte", "probe_attention"} <= set(counts)
    assert set(counts.values()) == {0}
    with pytest.raises(ValueError, match="variant"):
        tks.subbyte_probe(torch.from_numpy(x), tpk, "nosuch")
    with pytest.raises(ValueError, match="stage"):
        tap.attention_probe(*attn_inputs[1], "dma", "bf16")


def test_entry_points_run_on_the_cpu():
    """The two entry points at tiny shapes with --device=cpu: plain versions,
    no card times."""
    lines = []
    res = tks.run({"tiny": (64, 700)}, device="cpu", log=lines.append)
    assert set(res["tiny"]) == {"bytes", "transposed", "lane_major"}
    for layout in ("transposed", "lane_major"):
        assert set(res["tiny"][layout]) == set(tks.LADDER) | {"production"}
        assert res["tiny"][layout]["ship"] == pytest.approx(res["tiny"][layout]["production"],
                                                            rel=0.1)
    res = tap.run(batch=1, s_len=4, device="cpu", log=lines.append)
    assert len(res) == 1 + sum(len(d) for d in tap.DOTS.values())
    assert all(np.isfinite(v) for v in res.values())
    assert any("cpu" in line for line in lines)
