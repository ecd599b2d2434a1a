"""The port's tiling probes (``llm_mixed_q_torch.tools.kprobe``: P4;
``.ktune7b``: P6, P5, P7) against the TPU probes they replace
(``tools/kprobe.py``, ``tools/ktune7b.py``), whose Pallas kernels run here
in interpret mode through the tools' own wrappers and BlockSpecs, on the
same numpy inputs. ``tools/ktune7b.py`` reads ``sys.argv`` at import, so it
is loaded with ``sys.argv`` set first.

Each TPU case runs at the tiles of its port instance scaled to this test's
small weight (N = 256: the TPU's shipped bn 2048 / 1024 becomes 128, each
other bn in proportion; bk divides K_pad). The port's instances change the
schedule, not the product, so every one of them is held against the TPU
case it replaces, and a short last step of packing tiles and a short last
K band against the package's TPU kernels.

On a CPU tensor each probe wrapper computes its plain version; the CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: 1e-5 of max|y| (float32 sums of the same exact products, bf16 x
times codes times powers of two, in another order: the TPU's MXU sums a
dot's K in its own order)."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from llm_mixed_q_tpu.kernels import packing as jp
from llm_mixed_q_tpu.kernels.dequant_matmul import bfp_matmul_pallas, bfp_matmul_subbyte_pallas
from llm_mixed_q_torch import tools
from llm_mixed_q_torch.kernels import packing as tp
from llm_mixed_q_torch.kernels.dequant_matmul import bfp_matmul_plain
from llm_mixed_q_torch.tools import kprobe as tkp
from llm_mixed_q_torch.tools import ktune7b as tkt

REPO = Path(__file__).resolve().parent.parent
M, N = 8, 256
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
    """tools/<name>.py by file path, ``sys.argv`` holding its name only (the
    tool's own defaults), its ``pl`` interpreting."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py"])
        spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}",
                                                      REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    mod.pl = _Interpret(pl)
    return mod


@pytest.fixture(scope="module")
def kp():
    return _load_tool("kprobe")


@pytest.fixture(scope="module")
def kt():
    return _load_tool("ktune7b")


def _weights(k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, k)) * 0.02).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    return w, rng.standard_normal((M, k)).astype(np.float32)


@pytest.fixture(scope="module")
def sub_data():
    """{K: (x, jax lane-major packing, torch lane-major packing)}: 2, 3 and 4
    packing tiles of 640 K at width 6."""
    out = {}
    for k in (1152, 1900, 2500):
        w, x = _weights(k, k)
        out[k] = (x, jp.pack_block_fp_subbyte(jnp.asarray(w), WIDTH, 8, 127, [1, BLOCK]),
                  tp.pack_block_fp_subbyte(torch.from_numpy(w), WIDTH, 8, 127, [1, BLOCK]))
    return out


@pytest.fixture(scope="module")
def int8_data():
    """{K: (x, jax int8 packing, torch int8 packing)}: K_pad 1024, 1152 and
    2608."""
    out = {}
    for k in (1024, 1152, 2600):
        w, x = _weights(k, k + 1)
        out[k] = (x, jp.pack_block_fp(jnp.asarray(w), WIDTH, 8, 127, [1, BLOCK]),
                  tp.pack_block_fp(torch.from_numpy(w), WIDTH, 8, 127, [1, BLOCK]))
    return out


def _close_to_max(got, want, tol=1e-5):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


# ------------------------------------------------------------------- P4

# each P4 case: the TPU tool's arguments at this test's N
P4_CASES = {"sub_bn2048_cost": dict(bn=128), "sub_bn1024_cost": dict(bn=64),
            "sub_bn1024_nocost": dict(bn=64, cost=False),
            "sub_bn512_nocost": dict(bn=32, cost=False), "sub_bn4096_cost": dict(bn=256)}


@pytest.mark.parametrize("case", list(P4_CASES))
def test_subbyte_tile_plain_matches_kprobe_case(kp, sub_data, case):
    x, jpk, tpk = sub_data[1152]
    want = np.asarray(kp.subbyte_call(jnp.asarray(x), jpk, **P4_CASES[case]))
    cols, tps = tkp.SUB_INSTANCES[tkp.CASES[case]]
    got = tkp.subbyte_tile(torch.from_numpy(x), tpk, cols, tps).numpy()
    _close_to_max(got, want)


# ------------------------------------------------------------------- P7

P7_CASES = {"sub bn2048 ks1": dict(bn=128, ks=1), "sub bn2048 ks2": dict(bn=128, ks=2),
            "sub bn1024 ks2": dict(bn=64, ks=2), "sub bn1024 ks4": dict(bn=64, ks=4),
            "sub bn4096 ks2": dict(bn=256, ks=2)}


@pytest.mark.parametrize("case", list(P7_CASES))
def test_subbyte_tile_plain_matches_ktune7b_sub_case(kt, sub_data, case):
    """At 4 packing tiles, so that every ks divides the tile count and the
    TPU case runs the ks it names."""
    x, jpk, tpk = sub_data[2500]
    assert tpk.words.shape[1] // 128 == 4
    want = np.asarray(kt.sub_call(jnp.asarray(x), jpk, **P7_CASES[case]))
    cols, tps = tkp.SUB_INSTANCES[tkt.CASES[case]]
    assert tps == P7_CASES[case]["ks"]
    got = tkp.subbyte_tile(torch.from_numpy(x), tpk, cols, tps).numpy()
    _close_to_max(got, want)


@pytest.mark.parametrize("instance", ["c32_t2", "c16_t4"])
def test_short_last_step_matches_k3_tpu_kernel(sub_data, instance):
    """3 packing tiles at 2 or 4 tiles a step: the last step is short (the
    TPU's sub_call would run ks = 1 instead); the product is K3's."""
    x, jpk, tpk = sub_data[1900]
    cols, tps = tkp.SUB_INSTANCES[instance]
    assert tkp.sub_grid(cols, tps, tpk)[0] == -(-3 // tps)
    want = np.asarray(bfp_matmul_subbyte_pallas(jnp.asarray(x), jpk, bn=128, interpret=True))
    got = tkp.subbyte_tile(torch.from_numpy(x), tpk, cols, tps).numpy()
    _close_to_max(got, want)


# ------------------------------------------------------------------- P6

# each k-innermost P6 case: the TPU tool's arguments at this test's N and
# K_pad 1152 (bk 1024 -> 384, halved -> 128, doubled and more -> 1152)
P6_CASES = {
    "int8 bn1024 bk1024": dict(bn=128, bk=384),
    "int8 bn1024 bk1024 nocost": dict(bn=128, bk=384, cost=False),
    "int8 bn1024 bk1024 nodim": dict(bn=128, bk=384, dimsem=False),
    "int8 bn512 bk1024": dict(bn=64, bk=384), "int8 bn1024 bk512": dict(bn=128, bk=128),
    "int8 bn2048 bk512": dict(bn=256, bk=128), "int8 bn512 bk4096": dict(bn=64, bk=1152),
    "int8 bn256 bk4096": dict(bn=32, bk=1152), "int8 bn512 bk2048": dict(bn=64, bk=1152),
}


@pytest.mark.parametrize("case", list(P6_CASES))
def test_int8_tile_plain_matches_ktune7b_int8_case(kt, int8_data, case):
    x, jpk, tpk = int8_data[1152]
    want = np.asarray(kt.int8_call(jnp.asarray(x), jpk, **P6_CASES[case]))
    cols, kstep, band = tkt.INT8_INSTANCES[tkt.CASES[case]]
    assert band is None
    got = tkt.int8_tile(torch.from_numpy(x), tpk, cols, kstep, band).numpy()
    _close_to_max(got, want)


# ------------------------------------------------------------------- P5

@pytest.mark.parametrize("k,bk", [(1152, 384), (1024, 512)], ids=["3_bands", "2_bands"])
def test_int8_band_plain_matches_ktune7b_j_inner(kt, int8_data, k, bk):
    """The j-innermost grid sums one bk band of K at a time into the resident
    output tile; the port's band instance at bands of bk."""
    x, jpk, tpk = int8_data[k]
    want = np.asarray(kt.int8_call(jnp.asarray(x), jpk, bn=128, bk=bk, j_inner=True))
    cols, kstep, _ = tkt.INT8_INSTANCES[tkt.CASES["int8 bn1024 bk1024 j_inner"]]
    got = tkt.int8_tile(torch.from_numpy(x), tpk, cols, kstep, band=bk).numpy()
    _close_to_max(got, want)


def test_short_last_band_matches_k2_tpu_kernel(int8_data):
    """K_pad 2608 in bands of 1024: the last band is 560 of K."""
    x, jpk, tpk = int8_data[2600]
    assert tpk.codes.shape[1] == 2608
    cols, kstep, band = tkt.INT8_INSTANCES["c32_k512_band1024"]
    assert tkt.int8_grid(cols, kstep, band, tpk) == (2, 3 * 8, 2 * 3 * M * N * 4)
    want = np.asarray(bfp_matmul_pallas(jnp.asarray(x), jpk, bn=128, interpret=True))
    got = tkt.int8_tile(torch.from_numpy(x), tpk, cols, kstep, band).numpy()
    _close_to_max(got, want)


# ------------------------------------------------------ port-side checks

def test_band_sum_adds_the_bands_in_order():
    ws = torch.from_numpy(np.random.default_rng(5).standard_normal((5, 3, 7)).astype(np.float32))
    want = ws[0]
    for b in range(1, 5):
        want = want + ws[b]
    assert torch.equal(tkt.band_sum(ws), want)


def test_tile_plain_versions_are_k3_and_k2(sub_data, int8_data):
    """On bf16 x, every instance without bands is the plain K3 / K2 product
    without activation quantizer, bit for bit; the band instance within
    its sums' rounding."""
    x, _, tpk = sub_data[1900]
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    want = bfp_matmul_plain(xb, tpk)
    for cols, tps in tkp.SUB_INSTANCES.values():
        torch.testing.assert_close(tkp.subbyte_tile(xb, tpk, cols, tps), want, rtol=0, atol=0)
    x, _, tpk = int8_data[2600]
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    want = bfp_matmul_plain(xb, tpk)
    for cols, kstep, band in tkt.INT8_INSTANCES.values():
        got = tkt.int8_tile(xb, tpk, cols, kstep, band)
        if band is None:
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            _close_to_max(got.numpy(), want.numpy())


@pytest.mark.parametrize("instance", ["c16_t4", "c8_k2048", "c32_k512_band1024"])
def test_tile_x_short_of_k_pad_reads_zeros(sub_data, int8_data, instance):
    """x narrower than K_pad is read as 0 past its width."""
    if instance in tkp.SUB_INSTANCES:
        x, _, packed = sub_data[1900]
        k_pad = 1920
        call = lambda xs: tkp.subbyte_tile(xs, packed, *tkp.SUB_INSTANCES[instance])
    else:
        x, _, packed = int8_data[2600]
        k_pad = 2608
        call = lambda xs: tkt.int8_tile(xs, packed, *tkt.INT8_INSTANCES[instance])
    xs = torch.from_numpy(x[:, :-40].copy())
    assert torch.equal(call(xs), call(torch.nn.functional.pad(xs, (0, k_pad - xs.shape[1]))))


def test_p4_cases_map_to_instances_relative_to_the_shipped_tile():
    assert tkp.CASES["sub_bn2048_cost"] == "c32_t1"  # K3's tile on each machine
    assert tkp.CASES["sub_bn1024_cost"] == tkp.CASES["sub_bn1024_nocost"] == "c16_t1"
    assert tkp.CASES["sub_bn512_nocost"] == "c8_t1"
    assert tkp.CASES["sub_bn4096_cost"] == "c64_t1"
    assert tkp.CASES["int8_default"] == "K2" and tkp.CASES["bf16_xla_dot"] == "bf16"
    rows = tkp.rows_for(None, tkp.CASES, tkp.BESIDE)
    assert rows == ["c32_t1", "c16_t1", "c8_t1", "c64_t1", *tkp.BESIDE]
    assert set(rows) == set(tkp.ROWS)


def test_ktune7b_cases_map_to_instances_relative_to_the_shipped_tiles():
    c = tkt.CASES
    assert c["int8 bn1024 bk1024"] == c["int8 bn1024 bk1024 nocost"] == "c32_k512"
    assert c["int8 bn1024 bk1024 nodim"] == "c32_k512"
    assert tkt.INT8_INSTANCES[c["int8 bn1024 bk1024 j_inner"]] == (32, 512, 1024)
    for case, inst in c.items():
        if case.startswith("int8") and "j_inner" not in case:
            bn, bk = (int(t[2:]) for t in case.split()[1:3])
            assert tkt.INT8_INSTANCES[inst] == (bn // 32, bk // 2, None)
        elif case.startswith("sub"):
            bn, ks = int(case.split()[1][2:]), int(case.split()[2][2:])
            assert tkp.SUB_INSTANCES[inst] == (bn // 64, ks)
    # 16 kernel instances: 8 sub-byte, 7 int8 (COLS, KSTEP), the band split
    assert len(tkp.SUB_INSTANCES) + len(tkt.INT8_INSTANCES) == 16
    assert set(tkt.ROWS) == set(tkt.rows_for(None, c, tkt.BESIDE))


@pytest.mark.parametrize("call,error", [
    (lambda x, s, i: tkp.subbyte_tile(x, s, 24, 1), "no subbyte_tile instance"),
    (lambda x, s, i: tkp.subbyte_tile(x, s, 32, 3), "no subbyte_tile instance"),
    (lambda x, s, i: tkp.subbyte_tile(x, tp.transpose_subbyte(s), 32, 1), "lane-major"),
    (lambda x, s, i: tkt.int8_tile(x, i, 32, 4096), "no int8_tile instance"),
    (lambda x, s, i: tkt.int8_tile(x, i, 64, 512), "no int8_tile instance"),
    (lambda x, s, i: tkt.int8_tile(x, i, 32, 512, band=1000), "multiple of 128"),
    (lambda x, s, i: tkp.rows_for(["sub_bn2048_dimsem"], tkp.CASES, tkp.BESIDE), "unknown case"),
    (lambda x, s, i: tkt.run({"tiny": (64, 700)}, device="cpu", cases=["int8 bn64 bk64"]),
     "unknown case"),
], ids=["cols24", "tps3", "transposed", "kstep4096", "c64_k512", "band1000", "p4_case",
        "ktune7b_case"])
def test_unknown_cases_and_instances_raise(sub_data, int8_data, call, error):
    x, _, tsub = sub_data[1152]
    _, _, t8 = int8_data[1152]
    with pytest.raises((ValueError, TypeError), match=error):
        call(torch.from_numpy(x), tsub, t8)


def test_tile_wrappers_take_the_plain_version_on_the_cpu(sub_data, int8_data):
    x, _, tsub = sub_data[1152]
    _, _, t8 = int8_data[1152]
    x = torch.from_numpy(x)
    tools.reset_launch_counts()
    for cols, tps in tkp.SUB_INSTANCES.values():
        tkp.subbyte_tile(x, tsub, cols, tps)
    for cols, kstep, band in tkt.INT8_INSTANCES.values():
        tkt.int8_tile(x, t8, cols, kstep, band)
    tkt.band_sum(torch.zeros(3, 2, 5))
    counts = tools.launch_counts()
    assert {"probe_subbyte_tile", "probe_int8_tile", "probe_band_sum"} <= set(counts)
    assert set(counts.values()) == {0}


def test_kprobe_entry_point_runs_on_the_cpu():
    lines = []
    res = tkp.run({"tiny": (64, 1300)}, device="cpu", log=lines.append)["tiny"]
    assert set(res["sub"]) == {"c32_t1", "c16_t1", "c8_t1", "c64_t1", "K3", "K3_actq"}
    assert len({v for r, v in res["sub"].items() if r != "K3_actq"}) == 1  # one product
    assert set(res["int8"]) == {"K2", "K2_actq"} and set(res["bf16"]) == {"bf16"}
    assert res["steps"] == dict.fromkeys(["c32_t1", "c16_t1", "c8_t1", "c64_t1"], 3)
    assert res["blocks"] == {"c32_t1": 2, "c16_t1": 4, "c8_t1": 8, "c64_t1": 1}
    assert any("cpu" in line for line in lines)
    assert tkp.main(["sub_bn512_nocost", "--shape=nosuch", "--device=cpu"]) == {}


def test_ktune7b_entry_point_runs_on_the_cpu():
    res = tkt.run({"tiny": (64, 2600)}, device="cpu", log=lambda *a: None)["tiny"]
    ints = {name for name in tkt.INT8_INSTANCES}
    assert set(res["int8"]) == ints | {"K2", "K2_actq"}
    plain = {v for r, v in res["int8"].items() if r in ints and "band" not in r}
    assert plain == {res["int8"]["K2"]}
    assert res["int8"]["c32_k512_band1024"] == pytest.approx(res["int8"]["K2"], rel=1e-5)
    assert set(res["sub"]) == {"c32_t1", "c32_t2", "c16_t2", "c16_t4", "c64_t2", "K3", "K3_actq"}
    assert res["steps"]["c16_t4"] == 2 and res["steps"]["c32_k512_band1024"] == 2
    assert res["blocks"]["c32_k512_band1024"] == 2 * 3
    nb = res["bytes"]
    assert nb["c32_k512_band1024"] - nb["c32_k512"] == 2 * 3 * 8 * 64 * 4
    assert tkt.main(["sub bn1024 ks4", "--shape=nosuch", "--device=cpu"]) == {}
