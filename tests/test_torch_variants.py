"""The port's dequant-arithmetic and scale-storage probes
(``llm_mixed_q_torch.tools.kvariants``: P1; ``.kvariants2``: P3, P2)
against the TPU probes they replace (``tools/kvariants.py``,
``tools/kvariants2.py``), whose Pallas kernels run here in interpret mode
through the tools' own wrappers and BlockSpecs, on the same numpy inputs.

The TPU tools were written when ``PackedBFPSub.scales`` held float32
scales; today they hold uint8 exponent bytes, which the tools' kernels take
for values. Their kernels are fed what their authors meant, the decoded
scales (``scale_from_e8``, bf16-cast for the bf16 cases), and one test pins
what today's bytes give them.

On a CPU tensor each probe wrapper computes its plain version; the CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerances: 1e-5 of max|y| for the sub-byte variants (float32 sums of the
same exact products in another order; v3's correction cancels against a
sum that grows with K, so it is held to max|y|, not elementwise); error 0
for the int8 variant on x whose products and sums are all exact in float32,
so that no order of the sums can change a bit."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_tpu.kernels.dequant_matmul import bfp_matmul_subbyte_pallas
from llm_mixed_q_torch import tools
from llm_mixed_q_torch.kernels import packing as tp
from llm_mixed_q_torch.tools import ksub as tks
from llm_mixed_q_torch.tools import kvariants as tkv
from llm_mixed_q_torch.tools import kvariants2 as tkv2

REPO = Path(__file__).resolve().parent.parent
M, N, K, BN = 8, 256, 1152, 128  # two column blocks; two packing tiles (K_pad 1280), three int8 K steps
WIDTH, BLOCK = 6, 16


class _Interpret:
    """``pl`` as a TPU tool loaded here sees it: ``pallas_call`` in interpret
    mode, without the TPU compiler parameters and cost estimate."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def pallas_call(self, kernel, **kw):
        kw.pop("compiler_params", None)
        kw.pop("cost_estimate", None)
        return self._real.pallas_call(kernel, interpret=True, **kw)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _Interpret(pl)
    return mod


@pytest.fixture(scope="module")
def kv():
    return _load_tool("kvariants")


@pytest.fixture(scope="module")
def kv2():
    return _load_tool("kvariants2")


@pytest.fixture(scope="module")
def data():
    """One weight packed by both packages (sub-byte lane-major and int8),
    and x [M, K]."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((N, K)) * 0.02).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    x = rng.standard_normal((M, K)).astype(np.float32)
    jsub = jp.pack_block_fp_subbyte(jnp.asarray(w), WIDTH, 8, 127, [1, BLOCK])
    tsub = tp.pack_block_fp_subbyte(torch.from_numpy(w), WIDTH, 8, 127, [1, BLOCK])
    j8 = jp.pack_block_fp(jnp.asarray(w), WIDTH, 8, 127, [1, BLOCK])
    t8 = tp.pack_block_fp(torch.from_numpy(w), WIDTH, 8, 127, [1, BLOCK])
    return dict(x=x, jsub=jsub, tsub=tsub, j8=j8, t8=t8,
                jsub_f32=jsub._replace(scales=jp.scale_from_e8(jsub.scales)))


def _close_to_max(got, want, tol):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _layout(packed, layout):
    return tp.transpose_subbyte(packed) if layout == "transposed" else packed


# ------------------------------------------------------------------- P1

@pytest.mark.parametrize("layout", ["lane_major", "transposed"])
@pytest.mark.parametrize("variant,kernel", [("v2", "_kernel_v2"), ("v3", "_kernel_v3")])
def test_matmul_variant_plain_matches_jax_kernel(kv, data, layout, variant, kernel):
    """P1 on either layout against the TPU kernel on the lane-major words
    (the variants are defined on the stored words whatever their layout)."""
    want = np.asarray(kv.matmul_variant(jnp.asarray(data["x"]), data["jsub_f32"],
                                        getattr(kv, kernel), bn=BN))
    got = tkv.matmul_variant(torch.from_numpy(data["x"]), _layout(data["tsub"], layout),
                             variant).numpy()
    _close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("kernel", ["_kernel_v2", "_kernel_v3"])
def test_tpu_variants_take_todays_scale_bytes_for_values(kv, data, kernel):
    """The staleness of the TPU tool: fed today's uint8 exponent bytes, its
    kernels multiply by the byte (~2^7) instead of the scale (~2^-10)."""
    x = jnp.asarray(data["x"])
    stale = np.asarray(kv.matmul_variant(x, data["jsub"], getattr(kv, kernel), bn=BN))
    want = np.asarray(bfp_matmul_subbyte_pallas(x, data["jsub"], bn=BN, interpret=True))
    assert np.abs(stale - want).max() > 1e3 * np.abs(want).max()
    fixed = np.asarray(kv.matmul_variant(x, data["jsub_f32"], getattr(kv, kernel), bn=BN))
    _close_to_max(fixed, want, 1e-5)


# ------------------------------------------------------------------- P3

@pytest.mark.parametrize("layout", ["lane_major", "transposed"])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_sub_variant_plain_matches_jax_kernel(kv2, data, layout, scale_dtype):
    want = np.asarray(kv2.sub_variant(jnp.asarray(data["x"]), data["jsub_f32"], kv2._sub_kernel_v4,
                                      scale_dtype == torch.bfloat16, bn=BN))
    got = tkv2.sub_variant(torch.from_numpy(data["x"]), _layout(data["tsub"], layout),
                           scale_dtype).numpy()
    _close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("layout", ["lane_major", "transposed"])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_stored_scales_are_the_decoded_bytes(data, layout, scale_dtype):
    packed = _layout(data["tsub"], layout)
    stored = tkv2.stored_scales(packed, scale_dtype)
    assert stored.scales.dtype == scale_dtype and stored.scales.shape == packed.scales.shape
    assert torch.equal(stored.scales.float(), tp.scale_from_e8(packed.scales))
    assert torch.equal(stored.words, packed.words)
    assert tkv2.stored_scales(stored, scale_dtype) is stored


# ------------------------------------------------------------------- P2

@pytest.fixture(scope="module")
def exact_x():
    """Small integers: with the weight's scales in [2^-11, 2^-8] and codes
    below 32, every product code * scale * x is a multiple of 2^-11 below
    2^-1 and every sum of K of them stays below 2^10, so all are exact in
    float32 whatever the order of the sums."""
    return np.random.default_rng(3).integers(-4, 5, size=(M, K)).astype(np.float32)


@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
def test_int8_variant_plain_matches_jax_kernel(kv2, data, exact_x, scale_dtype):
    """bf16 scales against the TPU tool's bf16 kernel; the float32 control
    against its base case (K2's TPU kernel)."""
    scales = data["t8"].scales
    assert 2.0**-11 <= scales.min() and scales.max() <= 2.0**-8  # exact_x's premise
    bf16 = scale_dtype == torch.bfloat16
    want = np.asarray(kv2.int8_variant(jnp.asarray(exact_x), data["j8"], bf16, bn=BN))
    got = tkv2.int8_variant(torch.from_numpy(exact_x), data["t8"], scale_dtype).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


def test_int8_variant_base_case_is_k2(kv2, data, exact_x):
    """The TPU tool's two int8 cases agree, bf16 scales against float32 (its
    base case, K2's kernel), and the port's variant equals the port's K2."""
    from llm_mixed_q_torch.kernels.dequant_matmul import bfp_matmul_plain

    x = jnp.asarray(exact_x)
    base = np.asarray(kv2.int8_variant(x, data["j8"], False, bn=BN))
    bf16s = np.asarray(kv2.int8_variant(x, data["j8"], True, bn=BN))
    np.testing.assert_array_equal(bf16s, base)
    xb = torch.from_numpy(data["x"]).to(torch.bfloat16).float()
    torch.testing.assert_close(tkv2.int8_variant(xb, data["t8"]),
                               bfp_matmul_plain(xb, data["t8"]), rtol=0, atol=1e-6)


def test_int8_stored_scales_are_exact(data):
    stored = tkv2.stored_scales(data["t8"], torch.bfloat16)
    assert stored.scales.dtype == torch.bfloat16
    assert torch.equal(stored.scales.float(), data["t8"].scales)
    assert torch.equal(stored.codes, data["t8"].codes)


# ------------------------------------------------------ port-side checks

@pytest.mark.parametrize("layout", ["lane_major", "transposed"])
def test_variants_dequantize_as_ship(data, layout):
    """v2 and v4 compute ship's weights exactly (codes times powers of two
    are exact in bf16 and in an FMA), so they equal ship's plain version bit
    for bit; v3 differs only by its correction's rounding."""
    x = torch.from_numpy(data["x"])
    packed = _layout(data["tsub"], layout)
    ship = tks.subbyte_probe_plain(x, packed, "ship")
    assert torch.equal(tkv.matmul_variant(x, packed, "v2"), ship)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(tkv2.sub_variant(x, packed, dt), ship)
    _close_to_max(tkv.matmul_variant(x, packed, "v3").numpy(), ship.numpy(), 1e-5)


@pytest.mark.parametrize("call", [
    lambda x, d: tkv.matmul_variant(x, d["tsub"], "v2"),
    lambda x, d: tkv.matmul_variant(x, tp.transpose_subbyte(d["tsub"]), "v3"),
    lambda x, d: tkv2.sub_variant(x, d["tsub"], torch.float32),
    lambda x, d: tkv2.sub_variant(x, tp.transpose_subbyte(d["tsub"]), torch.bfloat16),
    lambda x, d: tkv2.int8_variant(x, d["t8"]),
], ids=["v2", "v3_t", "v4_f32s", "v4_bf16s_t", "int8_bf16s"])
def test_variant_x_short_of_k_pad_reads_zeros(data, call):
    """x narrower than K_pad is read as 0 past its width."""
    x = data["x"]
    got = call(torch.from_numpy(x[:, :K - 40].copy()), data)
    padded = np.concatenate([x[:, :K - 40], np.zeros_like(x[:, K - 40:])], axis=1)
    assert torch.equal(got, call(torch.from_numpy(padded), data))


def test_tpu_case_names_map_to_port_instances():
    assert {tkv.instance(c) for c in ("v2", "v2_bf16")} == {"v2"}
    assert {tkv.instance(c) for c in ("v3", "v3_corr", "v3_bn2048")} == {"v3"}
    assert tkv.PRODUCTION_CASE == "v1_dimsem"
    assert set(tkv2.CASES.values()) == {"K2", "int8_bf16s", "production", "v4_f32s", "v4_bf16s"}
    assert all(v == "K2" for c, v in tkv2.CASES.items() if c.startswith("i_base"))
    assert all(v == "v4_bf16s" for c, v in tkv2.CASES.items() if c.startswith("s_fma_bf16s"))
    assert tkv.ENTRY_VARIANTS == tkv.VARIANTS + tuple(tkv2.SUB_VARIANTS.values())


def test_unknown_variants_and_dtypes_raise(data):
    x = torch.from_numpy(data["x"])
    with pytest.raises(ValueError, match="unknown variant"):
        tkv.matmul_variant(x, data["tsub"], "v1_dimsem")
    with pytest.raises(ValueError, match="unknown variant"):
        tkv.matmul_variant(x, data["tsub"], "v5")
    with pytest.raises(ValueError, match="scale dtype"):
        tkv2.sub_variant(x, data["tsub"], torch.float16)
    with pytest.raises(ValueError, match="scale dtype"):
        tkv2.int8_variant(x, data["t8"], torch.float16)
    with pytest.raises(ValueError, match="which"):
        tkv2.run({"tiny": (64, 700)}, device="cpu", which="x")


def test_variant_wrappers_take_the_plain_version_on_the_cpu(data):
    x = torch.from_numpy(data["x"])
    tools.reset_launch_counts()
    for layout in ("lane_major", "transposed"):
        packed = _layout(data["tsub"], layout)
        tkv.matmul_variant(x, packed, "v3")
        tkv2.sub_variant(x, packed, torch.bfloat16)
    for dt in tkv2.INT8_VARIANTS:
        tkv2.int8_variant(x, data["t8"], dt)
    counts = tools.launch_counts()
    assert {"probe_matmul_variant_t", "probe_matmul_variant", "probe_sub_variant_t",
            "probe_sub_variant", "probe_int8_variant"} <= set(counts)
    assert set(counts.values()) == {0}


def test_kvariants_entry_point_runs_on_the_cpu():
    lines = []
    res = tkv.run({"tiny": (64, 700)}, device="cpu", log=lines.append)
    for layout in ("transposed", "lane_major"):
        row = res["tiny"][layout]
        assert set(row) == {"production", *tkv.VARIANTS}
        assert row["v2"] == row["production"]  # bf16 x, no actq: the same product
        assert row["v3"] == pytest.approx(row["production"], rel=1e-5)
    assert any("cpu" in line for line in lines)


def test_kvariants2_entry_point_runs_on_the_cpu():
    lines = []
    res = tkv2.run({"tiny": (64, 700)}, device="cpu", log=lines.append)["tiny"]
    assert res["int8"]["int8_bf16s"] == res["int8"]["int8_f32s"] == res["int8"]["K2"]
    for layout in ("transposed", "lane_major"):
        assert set(res[layout]) == {"production", "v4_f32s", "v4_bf16s"}
        assert len(set(res[layout].values())) == 1
    nb = res["bytes"]
    assert nb["v4_f32s"] - nb["production"] == 3 * (nb["v4_bf16s"] - nb["production"]) > 0
    assert nb["K2"] == nb["int8_f32s"] > nb["int8_bf16s"]
    assert tkv2.main(["s", "--shape=nosuch", "--device=cpu"]) == {}
