"""The port's probes P12, P13 (``llm_mixed_q_torch.tools.k3``) and P10
(``llm_mixed_q_torch.tools.kexp``) against the TPU probes they replace
(``tools/k3.py``: ``call_v2``, ``call_v3``; ``tools/kexp.py``:
``make_call``), whose Pallas kernels run here in interpret mode through the
tools' own wrappers and BlockSpecs, on the same numpy inputs. The tools
read ``sys.argv`` at import, so each is loaded by path with ``sys.argv``
set first (``k3``: ``--batch=1``, S = 256 and nh = nkv = 32 being fixed;
``kexp``: ``--l=256 --b=2``), its ``pl`` interpreting.

On a CPU tensor each probe wrapper computes its plain version; the CUDA
kernels are held against these plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerances:
- P12 ``softmax``, ``qmax``, ``qmath``, ``full`` and P13: rtol 2e-4 /
  atol 2e-5, the JAX package's decode attention tolerance (the port sums
  the softmax denominator in float64; bf16 dots of the raw q sum exact
  products in another order);
- P12 ``dots``: 1e-3 of max|ctx|, its dense sums over every lane cancel
  and a score whose float32 sum lands on the other side of a bf16 rounding
  point moves by one bf16 step (as P11's ``matmul`` with bf16 dots);
- P10: 1e-5 of max|y| (float32 sums of the same exact products in
  another order);
- ``attention_v3_plain`` equals ``attention_v2_plain(..., "full")`` bit
  for bit (the resident bias adds 0 at the lanes it reads)."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from llm_mixed_q_tpu.kernels import attention_decode as jattn
from llm_mixed_q_torch import tools
from llm_mixed_q_torch.tools import aprobe as tap
from llm_mixed_q_torch.tools import k3 as tk3
from llm_mixed_q_torch.tools import kexp as tkx

REPO = Path(__file__).resolve().parent.parent
L_LEN, B_EXP = 256, 2
MID = 100  # a position that ends mid-block (block 96..111)


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


def _load_tool(name, argv):
    """tools/<name>.py by file path, ``sys.argv`` set first, its ``pl``
    interpreting."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}",
                                                      REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    mod.pl = _Interpret(pl)
    return mod


@pytest.fixture(scope="module")
def k3tool():
    return _load_tool("k3", ["--batch=1"])


@pytest.fixture(scope="module")
def kexptool():
    return _load_tool("kexp", [f"--l={L_LEN}", f"--b={B_EXP}"])


@pytest.fixture(scope="module")
def attn_inputs(k3tool):
    """The tool's ``make_inputs`` and the port's: the same arrays."""
    jin = k3tool.make_inputs()
    tin = tk3.make_inputs(1, device="cpu")
    for a, b in zip(jin, tin):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jin, tin


def _at(inputs, pos, framework):
    """The inputs with every batch element at ``pos``."""
    *arrays, positions = inputs
    if framework == "jax":
        return (*arrays, jnp.full(positions.shape, pos, jnp.int32))
    return (*arrays, torch.full(positions.shape, pos, dtype=torch.int32))


def _tpu_call(call, inputs):
    q, kc, ks, vc, vs, pos = inputs
    return np.asarray(call(pos, q, kc, ks, vc, vs))


@pytest.fixture(scope="module")
def tpu_out(k3tool, attn_inputs):
    """{(name, pos): ctx} of the TPU tool's kernels, each run once."""
    jin, _ = attn_inputs
    out = {}
    for pos in (tk3.S - 1, MID):
        for stage in tk3.STAGES:
            out[stage, pos] = _tpu_call(k3tool.call_v2(stage), _at(jin, pos, "jax"))
        out["v3", pos] = _tpu_call(k3tool.call_v3(), _at(jin, pos, "jax"))
    return out


def _close_to_max(got, want, tol):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("pos", [tk3.S - 1, MID])
@pytest.mark.parametrize("stage", tk3.STAGES)
def test_v2_plain_matches_tpu_kernel(attn_inputs, tpu_out, stage, pos):
    _, tin = attn_inputs
    got = tk3.attention_v2(*_at(tin, pos, "torch"), stage).numpy()
    want = tpu_out[stage, pos]
    if stage == "dots":
        _close_to_max(got, want, 1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("pos", [tk3.S - 1, MID])
def test_v3_plain_matches_tpu_kernel(attn_inputs, tpu_out, pos):
    _, tin = attn_inputs
    got = tk3.attention_v3(*_at(tin, pos, "torch"), *tk3.resident_masks()).numpy()
    np.testing.assert_allclose(got, tpu_out["v3", pos], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("pos", [tk3.S - 1, MID])
def test_v2_full_matches_the_shipping_jax_kernel(attn_inputs, pos):
    """v2's full stage is the package's pos-major kernel with exact_q (bf16
    dots), the TPU tool's ship line."""
    jin, tin = attn_inputs
    q, kc, ks, vc, vs, jpos = _at(jin, pos, "jax")
    want = np.asarray(jattn.packed_attention_decode_batch(
        q, kc, ks, vc, vs, jpos, tk3.BSK, tk3.BSV, nkv=tk3.NKV, rep=tk3.REP,
        prob_q=tk3.PROB_Q, exact_q=True, interpret=True))
    got = tk3.attention_v2(*_at(tin, pos, "torch"), "full").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _small_attention(seed=3):
    """A ragged batch of 3 at nkv = 2, rep = 2, S = 40 (a short last
    block), and its resident masks."""
    rng = np.random.default_rng(seed)
    b, nkv, rep, hd, s_len = 3, 2, 2, 64, 40
    lanes = s_len * nkv
    q = torch.tensor(rng.standard_normal((b, nkv * rep, hd)), dtype=torch.float32)
    kc = torch.tensor(rng.integers(-31, 32, (b, hd, lanes)), dtype=torch.int8)
    ks = torch.tensor(2.0 ** rng.integers(-8, 0, (b, hd // 16, lanes)), dtype=torch.float32)
    vc = torch.tensor(rng.integers(-31, 32, (b, hd, lanes)), dtype=torch.int8)
    vs = torch.tensor(2.0 ** rng.integers(-8, 0, (b, hd // 16, lanes)), dtype=torch.float32)
    pos = torch.tensor([39, 0, 21], dtype=torch.int32)
    kw = dict(nkv=nkv, rep=rep)
    return (q, kc, ks, vc, vs, pos), tk3.resident_masks(nkv * rep, nkv, s_len, rep), kw


@pytest.mark.parametrize("case", ["tool_last", "tool_mid", "ragged_rep2"])
def test_v3_plain_is_v2_full_plain_bit_for_bit(attn_inputs, case):
    if case == "ragged_rep2":
        inputs, masks, kw = _small_attention()
    else:
        inputs = _at(attn_inputs[1], tk3.S - 1 if case == "tool_last" else MID, "torch")
        masks, kw = tk3.resident_masks(), {}
    got = tk3.attention_v3_plain(*inputs, *masks, **kw)
    want = tk3.attention_v2_plain(*inputs, "full", **kw)
    assert torch.equal(got, want)


def test_v2_stages_of_p11_are_its_plain_versions():
    """dots, softmax and full are P11's matmul, softmax and quant with bf16
    dots, ragged and at rep 2 too."""
    inputs, _, kw = _small_attention(5)
    for stage, p11 in (("dots", "matmul"), ("softmax", "softmax"), ("full", "quant")):
        got = tk3.attention_v2_plain(*inputs, stage, **kw)
        want = tap.attention_probe_plain(*inputs, p11, "bf16", **kw)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_qmax_weights_the_rest_of_the_block_of_pos(attn_inputs):
    """At pos = 100 the block max also weights positions 101..111 (the
    TPU's context dot runs over every lane), and nothing after 111."""
    q, kc, ks, vc, vs, pos = _at(attn_inputs[1], MID, "torch")
    base = tk3.attention_v2_plain(q, kc, ks, vc, vs, pos, "qmax")
    lane = lambda p: slice(p * tk3.NKV, (p + 1) * tk3.NKV)
    inside, after = vc.clone(), vc.clone()
    inside[:, :, lane(105)] = 31
    after[:, :, lane(112)] = 31
    assert not torch.equal(tk3.attention_v2_plain(q, kc, ks, inside, vs, pos, "qmax"), base)
    assert torch.equal(tk3.attention_v2_plain(q, kc, ks, after, vs, pos, "qmax"), base)
    assert torch.equal(tk3.attention_v2_plain(q, kc, ks, inside, vs, pos, "full"),
                       tk3.attention_v2_plain(q, kc, ks, vc, vs, pos, "full"))


def test_resident_masks_are_the_tools():
    """negb and posi as ``call_v3`` builds them, at rep 1 and rep 2."""
    for nh, nkv, rep in ((tk3.NH, tk3.NKV, tk3.REP), (4, 2, 2)):
        negb, posi = tk3.resident_masks(nh, nkv, tk3.S, rep)
        lane, row = np.arange(tk3.S * nkv), np.arange(nh)
        want_b = np.where(lane[None, :] % nkv == (row[:, None] // rep), 0.0, -1e9)
        want_p = np.broadcast_to(lane // nkv, (nh, tk3.S * nkv))
        np.testing.assert_array_equal(negb.numpy(), want_b.astype(np.float32))
        np.testing.assert_array_equal(posi.numpy(), want_p.astype(np.int32))
        assert negb.dtype == torch.float32 and posi.dtype == torch.int32


@pytest.fixture(scope="module")
def exp_inputs():
    """The inputs as the TPU tool's ``main`` draws them, for both."""
    tin = tkx.make_inputs(L_LEN, B_EXP, device="cpu")
    rng = np.random.default_rng(0)
    jin = (jnp.asarray(rng.standard_normal((B_EXP, 8, tkx.HD)), jnp.float32),
           jnp.asarray(rng.integers(-31, 32, (B_EXP, tkx.HD, L_LEN)), jnp.int8),
           jnp.asarray(2.0 ** rng.integers(-8, 0, (B_EXP, tkx.NB, L_LEN)), jnp.float32))
    for a, b in zip(jin, tin):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jin, tin


@pytest.mark.parametrize("variant", tkx.TPU_VARIANTS)
def test_expand_plain_matches_tpu_kernel(kexptool, exp_inputs, variant):
    jin, tin = exp_inputs
    want = np.asarray(kexptool.make_call(variant)(*jin))
    got = tkx.expand_probe(*tin, variant).numpy()
    assert got.shape == want.shape == (B_EXP, 8, L_LEN)
    _close_to_max(got, want, 1e-5)


def test_expand_instances(exp_inputs):
    """index and staged are one function, ``none`` another; every TPU name
    runs its instance."""
    _, tin = exp_inputs
    outs = {v: tkx.expand_probe_plain(*tin, v) for v in tkx.VARIANTS}
    assert torch.equal(outs["index"], outs["staged"])
    assert not torch.allclose(outs["none"], outs["index"])
    for name, instance in tkx.ALIASES.items():
        assert torch.equal(tkx.expand_probe_plain(*tin, name), outs[instance])
    assert set(tkx.ALIASES) == set(tkx.TPU_VARIANTS)


def test_expand_plain_takes_scales_in_bf16():
    """Scales that are not bf16 are taken to bf16 first, as every TPU
    variant takes them; codes of 8 bits stay exact."""
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((1, 8, tkx.HD)), dtype=torch.float32)
    codes = torch.tensor(rng.integers(-128, 128, (1, tkx.HD, 40)), dtype=torch.int8)
    scales = torch.tensor(rng.uniform(0.01, 1.0, (1, tkx.NB, 40)), dtype=torch.float32)
    got = tkx.expand_probe_plain(q, codes, scales, "index")
    sb = scales.to(torch.bfloat16).float()
    assert torch.equal(got, tkx.expand_probe_plain(q, codes, sb, "staged"))
    w = codes.double() * sb.double().repeat_interleave(tkx.BS, dim=1)
    want = torch.einsum("brk,bkl->brl", q.to(torch.bfloat16).double(), w)
    _close_to_max(got.numpy(), want.numpy(), 1e-6)


def test_wrappers_take_the_plain_version_on_the_cpu(attn_inputs, exp_inputs):
    tools.reset_launch_counts()
    tin = attn_inputs[1]
    tk3.attention_v2(*tin, "qmax")
    tk3.attention_v3(*tin, *tk3.resident_masks())
    tkx.expand_probe(*exp_inputs[1], "repeat")
    counts = tools.launch_counts()
    assert {"probe_attention_v2", "probe_attention_v3", "probe_expand"} <= set(counts)
    assert set(counts.values()) == {0}


def test_unknown_names_raise(attn_inputs, exp_inputs):
    tin = attn_inputs[1]
    for stage in ("quant", "masks", "nosuch"):
        with pytest.raises(ValueError, match="stage"):
            tk3.attention_v2(*tin, stage)
    for variant in ("ship", "nosuch"):
        with pytest.raises(ValueError, match="variant"):
            tkx.expand_probe(*exp_inputs[1], variant)


def test_k3_entry_point_runs_on_the_cpu():
    lines = []
    res = tk3.run(batch=1, device="cpu", log=lines.append)
    assert list(res) == ["K4", *(f"v2_{s}" for s in tk3.STAGES), "v3_masks"]
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert res["v3_masks"] == res["v2_full"]
    assert any("cpu" in line for line in lines)
    assert list(tk3.run(batch=1, device="cpu", only="v2_q", log=lines.append)) == [
        "v2_qmax", "v2_qmath"]


def test_kexp_entry_point_runs_on_the_cpu():
    lines = []
    res = tkx.run(l=300, b=1, device="cpu", log=lines.append)
    assert list(res) == list(tkx.TPU_VARIANTS)
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert len({res[v] for v in tkx.TPU_VARIANTS[1:]}) == 1
    assert any("cpu" in line for line in lines)
