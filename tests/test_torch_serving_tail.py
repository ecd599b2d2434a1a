"""The port's serving tail against the JAX package, on the CPU at a tiny
size: incremental decoding (``past_kvs`` of Llama and OPT through
``make_prefill_and_decode``), Llama's ``generate_greedy``, the batcher's
``warmup``, the native host pack engine (``llm_mixed_q_torch.native``) and
``pack_llama_params_host``.

Models: 2 layers, hidden 64, 4 heads (Llama with 2 kv heads, GQA), vocab
96, from the JAX package's numpy init through ``params_from_jax``. Each
incremental run prefills 20 tokens and decodes the rest one at a time;
row 1 of each batch is right-padded (its mask 0 after 15 tokens of the
prefill, and then 1 again for the decoded tokens, as the JAX package's
callers pass it).

Tolerances: stitched logits rtol 2e-4 / atol 2e-4 (the JAX package's own,
``tests/test_llama_model.py``); logits against JAX within 1e-4 of
max|logit|; caches within 1e-5 of their max; tokens and packed bytes
equal.

Under a quantized attention (``bfp_6bit``: matmul_0 quantizes k^T in
blocks of 16 along the positions) the incremental logits depart from the
full forward's in both packages, because a step sees a partial last block
of positions that the full forward fills with later tokens; the port is
held to JAX's incremental logits there, and to the full forward where the
attention matmuls are not quantized (the ``LINEARS_ONLY`` config: W6A6
linears, packed or fake-quantized)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.kernels import pack_block_fp as jax_pack_block_fp
from llm_mixed_q_tpu.kernels import pack_block_fp_subbyte as jax_pack_block_fp_subbyte
from llm_mixed_q_tpu.models.api import make_prefill_and_decode as jax_prefill_and_decode
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init_llama
from llm_mixed_q_tpu.models.hf_loader import init_opt_params as jax_init_opt
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxLlamaConfig
from llm_mixed_q_tpu.models.llama.pack import pack_llama_params as jax_pack_llama
from llm_mixed_q_tpu.models.llama.serving import generate_greedy as jax_generate_greedy
from llm_mixed_q_tpu.models.opt import OPTQuantizedConfig as JaxOPTConfig
from llm_mixed_q_tpu.models.opt.pack import pack_opt_params as jax_pack_opt
from llm_mixed_q_torch import native
from llm_mixed_q_torch.kernels import (
    PACKED_TYPES,
    PackedBFP,
    PackedBFPSubT,
    pack_block_fp,
    pack_block_fp_subbyte,
)
from llm_mixed_q_torch.models.api import make_forward, make_prefill_and_decode
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import (
    ContinuousBatcher,
    LlamaQuantizedConfig,
    generate,
    generate_greedy,
    llama_for_causal_lm,
    pack_llama_params,
    pack_llama_params_host,
)
from llm_mixed_q_torch.models.opt import OPTQuantizedConfig
from llm_mixed_q_torch.native import loader

REPO = Path(__file__).resolve().parent.parent
BFP6 = "configs/quantization/bfp_6bit.toml"
VOCAB, PREFILL, TOTAL = 96, 20, 22
_MM_BYPASS = {"bypass": True, "name": "integer"}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread, so that the many small ops neither
    wait on nor crowd the threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linears_only():
    """bfp_6bit with the attention matmuls unquantized."""
    from llm_mixed_q_torch.utils import load_config

    cfg = load_config(str(REPO / BFP6))
    cfg["matmul"] = dict(_MM_BYPASS)  # Llama's attention matmuls
    cfg["bmm"] = dict(_MM_BYPASS)  # OPT's
    return cfg


LINEARS_ONLY = _linears_only()
QUANTS = {"bypass": None, "bfp_6bit": BFP6, "linears_only": LINEARS_ONLY}
LLAMA_KW = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
OPT_KW = dict(vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=128, word_embed_proj_dim=64,
              do_layer_norm_before=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, size=(2, TOTAL)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[1, 15:PREFILL] = 0  # row 1 right-padded in the prefill
    return ids, mask


def _families(arch, quant):
    if arch == "llama":
        jc = JaxLlamaConfig(**LLAMA_KW, quant_config=quant)
        tc = LlamaQuantizedConfig(**LLAMA_KW, quant_config=quant)
        return jc, tc, _np(jax_init_llama(jc, seed=0))
    jc = JaxOPTConfig(**OPT_KW, quant_config=quant)
    tc = OPTQuantizedConfig(**OPT_KW, quant_config=quant)
    return jc, tc, _np(jax_init_opt(jc, seed=0))


def _stitch(prefill, decode, params, ids, mask, wrap):
    """Prefill PREFILL tokens, decode the rest one at a time -> (stitched
    logits [b, TOTAL, vocab], the last caches)."""
    logits, kvs = prefill(params, wrap(ids[:, :PREFILL]), wrap(mask[:, :PREFILL]))
    steps = [np.asarray(logits)]
    for t in range(PREFILL, TOTAL):
        logits, kvs = decode(params, wrap(ids[:, t:t + 1]), wrap(mask[:, :t + 1]), kvs)
        steps.append(np.asarray(logits))
    return np.concatenate(steps, axis=1), kvs


@pytest.mark.parametrize("quant,packed", [("bypass", False), ("bfp_6bit", False),
                                          ("bfp_6bit", True), ("linears_only", True)])
@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_prefill_and_decode_matches_jax(arch, quant, packed):
    """Stitched incremental logits equal JAX's ``make_prefill_and_decode``
    (within 1e-4 of max|logit|), and the port's full forward (rtol/atol
    2e-4) where the attention matmuls are unquantized; under bfp_6bit they
    depart from the full forward as JAX's do (module docstring); the returned
    caches equal JAX's within 1e-5 of their max. Packed: sub-byte weights
    (``PackedBFPSubT``) through the plain ``bfp_matmul``."""
    jc, tc, jp = _families(arch, QUANTS[quant])
    if packed:
        pack = jax_pack_llama if arch == "llama" else jax_pack_opt
        jp = _np(jax.jit(lambda p: pack(p, jc, subbyte=True))(jp))
    tp = params_from_jax(jp, device="cpu")
    if packed:
        layer = tp["layers"][0]
        node = layer["self_attn"]["qkv_proj"] if arch == "llama" else layer["fc1"]
        assert isinstance(node["weight"], PackedBFPSubT)
    ids, mask = _batch()
    j_pre, j_dec = jax_prefill_and_decode(arch, "lm", jc)
    want, want_kvs = _stitch(j_pre, j_dec, jp, ids, mask, np.asarray)
    t_pre, t_dec = make_prefill_and_decode(arch, "lm", tc)
    got, got_kvs = _stitch(t_pre, t_dec, tp, ids, mask, torch.from_numpy)
    rows = mask.astype(bool)
    _close(got[rows], want[rows])
    assert len(got_kvs) == 2 and got_kvs[0][0].shape[2] == TOTAL
    for (gk, gv), (wk, wv) in zip(got_kvs, want_kvs):
        _close(gk.numpy(), wk, 1e-5)
        _close(gv.numpy(), wv, 1e-5)
    full = make_forward(arch, "lm", tc)(tp, torch.from_numpy(ids), torch.from_numpy(mask))
    full = full["logits"].numpy()[rows]
    if quant != "bfp_6bit":
        np.testing.assert_allclose(got[rows], full, rtol=2e-4, atol=2e-4)
    else:
        # the departure from the full forward: past the tolerance, and the
        # same as JAX's within 1e-4 of max|logit|
        assert np.abs(got[rows] - full).max() > 1e-3 * np.abs(full).max()
        _close(got[rows] - full, want[rows] - full)


def test_llama_past_kvs_offsets_positions_and_mask():
    """``llama_for_causal_lm`` with ``past_kvs``: positions past .. past + s
    - 1 by default, a [b, past + s] mask; remat gives the same output."""
    _, tc, jp = _families("llama", None)
    tp = params_from_jax(jp, device="cpu")
    ids, mask = (torch.from_numpy(a) for a in _batch(seed=2))
    first = llama_for_causal_lm(tp, ids[:, :PREFILL], mask[:, :PREFILL], config=tc)
    kw = dict(config=tc, past_kvs=first["past_kvs"])
    out = llama_for_causal_lm(tp, ids[:, PREFILL:], mask, **kw)
    pos = torch.arange(PREFILL, TOTAL)[None].expand(2, -1)
    explicit = llama_for_causal_lm(tp, ids[:, PREFILL:], mask, position_ids=pos, **kw)
    remat = llama_for_causal_lm(tp, ids[:, PREFILL:], mask, remat=True, **kw)
    full = llama_for_causal_lm(tp, ids, mask, config=tc)["logits"][:, PREFILL:]
    torch.testing.assert_close(out["logits"], full, rtol=2e-4, atol=2e-4)
    assert torch.equal(out["logits"], explicit["logits"])
    assert torch.equal(out["logits"], remat["logits"])
    assert out["past_kvs"][1][0].shape == (2, 2, TOTAL, 16)


# --------------------------------------------------------- generate_greedy


@pytest.mark.parametrize("packed", [False, True], ids=["fake_quant", "packed_subbyte"])
def test_generate_greedy_matches_jax_and_generate(packed):
    """Ragged prompts: the tokens equal JAX's ``generate_greedy`` and the
    port's ``generate`` at temperature 0 (packed KV cache)."""
    jc, tc, jp = _families("llama", BFP6)
    if packed:
        jp = _np(jax.jit(lambda p: jax_pack_llama(p, jc, subbyte=True))(jp))
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(5)
    ids = rng.integers(2, VOCAB, size=(2, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    want = np.asarray(jax_generate_greedy(jp, jc, ids, mask, 6, 24))
    got = generate_greedy(tp, tc, ids, mask, 6, 24, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, generate(tp, tc, ids, mask, max_new_tokens=6, max_len=24, device="cpu"))


# -------------------------------------------------------------------- warmup

# head-major needs nkv * max_len > 8192 lanes: 16 kv heads of head_dim 16
WARM_KW = dict(vocab_size=VOCAB, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=16, num_key_value_heads=16, max_position_embeddings=1024)


def _state(srv):
    cache = [srv.cache] if srv._spec is None else [t for f in srv.cache[:4] for t in f]
    return ([t.clone() for t in cache], srv._positions.clone(), srv._last_tok.clone(),
            list(srv._queue), list(srv._req))


def _same_state(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert a[3] == b[3] and a[4] == b[4]


@pytest.mark.parametrize("buckets", [None, [16, 48]], ids=["ladder", "given"])
@pytest.mark.parametrize("max_len", [96, 520], ids=["pos_major", "head_major"])
def test_warmup_changes_no_state_and_no_output(max_len, buckets):
    """``warmup`` between admissions leaves every byte of the live cache,
    the positions, the last tokens and the queue as they were, and every
    request's tokens equal those of a batcher without ``warmup``. Both
    cache layouts; the head-major live cache admits through bucket caches
    of its own layout (ROADMAP fault 4), and so does ``warmup``."""
    tc = LlamaQuantizedConfig(**WARM_KW, quant_config=BFP6)
    jc = JaxLlamaConfig(**WARM_KW, quant_config=BFP6)
    tp = params_from_jax(_np(jax_init_llama(jc, seed=3)), device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, VOCAB, size=n) for n in (5, 17, 9, 30, 12)]

    def batcher():
        srv = ContinuousBatcher(tp, tc, num_slots=2, max_len=max_len, max_new_tokens=5,
                                prompt_bucket=64, decode_chunk=3, device="cpu")
        for p in prompts:
            srv.submit(p)
        return srv

    srv = batcher()
    assert srv.cache.pos_major == (max_len == 96)
    srv.step()  # two requests admitted and decoding
    before = _state(srv)
    srv.warmup(buckets)
    _same_state(before, _state(srv))
    got = srv.run()
    want = batcher().run()
    assert got == want and len(got) == len(prompts)


def test_warmup_of_the_fake_quant_cache_writes_nothing():
    tc = LlamaQuantizedConfig(**LLAMA_KW, quant_config=BFP6)
    tp = params_from_jax(_families("llama", BFP6)[2], device="cpu")
    srv = ContinuousBatcher(tp, tc, num_slots=2, max_len=40, max_new_tokens=3,
                            prompt_bucket=16, packed_kv=False, device="cpu")
    srv.submit(np.arange(3, 10))
    srv.step()
    before = _state(srv)
    srv.warmup()
    _same_state(before, _state(srv))


# ---------------------------------------------------------- native engine

RNG = np.random.default_rng(7)


def _w(shape, scale=0.05):
    w = RNG.standard_normal(shape).astype(np.float32) * scale
    w.reshape(-1)[::41] = 0.0
    w[0, :16] = 0.0  # a zero block: the tensor's least nonzero block max fills it
    return w


def _crafted():
    """[N, 64] float32: 2^k and its float32 neighbours as block maxima
    (every exponent), the fault-1 point 2^-13 among them; subnormal and
    tiny blocks; elements at +-1e-8 and +-5e-9; zero blocks."""
    f32 = np.float32
    p = np.ldexp(f32(1), np.arange(-149, 128)).astype(f32)
    pts = np.concatenate([p, np.nextafter(p, f32(0)), np.nextafter(p, f32(np.inf))])
    pts = pts[(pts > 0) & np.isfinite(pts)]
    pts = np.concatenate([pts, np.zeros((-len(pts)) % 4, f32) + f32(1)])
    rng = np.random.default_rng(8)
    blocks = pts[:, None] * rng.uniform(0, 1, (len(pts), 16)).astype(f32)
    blocks[:, 0] = pts
    w = (blocks * rng.choice([-1, 1], blocks.shape)).astype(f32).reshape(-1, 64)
    w[1, :16] = 0.0
    w[2, 16:20] = [1e-8, -1e-8, 5e-9, -5e-9]
    w[3, 32:48] = 1e-40
    return w


def _torch_int8(w, width, k_stride=None):
    p = pack_block_fp(torch.from_numpy(w), width, 8, None, [1, 16], k_stride=k_stride)
    return p.codes.numpy(), p.scales.numpy()


def _torch_sub(w, width):
    p = pack_block_fp_subbyte(torch.from_numpy(w), width, 8, None, [1, 16])
    return p.words.numpy(), p.scales.numpy()


def test_native_engine_is_built_into_build_native():
    assert native.native_available()
    path = loader._lib_path()
    assert path.exists() and path.parent.parent == REPO / "build" / "native"


@pytest.mark.parametrize("width", [4, 6, 8])
def test_native_int8_equals_torch_packer(width):
    """Random weights with a zero block, K padded to the block or (K >=
    700) to a 1024 stride."""
    for shape in ((32, 64), (16, 48), (64, 700)):
        w = _w(shape)
        k_stride = 1024 if shape[1] >= 700 else None
        codes, scales = native.native_pack_int8(w, width, 8, None, 16, k_stride=k_stride)
        want = _torch_int8(w, width, k_stride)
        np.testing.assert_array_equal(codes, want[0])
        np.testing.assert_array_equal(scales, want[1])


@pytest.mark.parametrize("width", [3, 4, 6])
def test_native_subbyte_equals_torch_packer(width):
    for shape in ((16, 640), (8, 1280), (32, 700)):
        w = _w(shape)
        words, scales = native.native_pack_subbyte(w, width, 8, None, 16)
        want = _torch_sub(w, width)
        np.testing.assert_array_equal(words, want[0])
        np.testing.assert_array_equal(scales, want[1])


def test_native_crafted_blocks_equal_torch_packer():
    """Every power of two and its neighbours as a block max, zero,
    subnormal and tiny blocks, elements at the 1e-8 threshold: bit-equal,
    int8 and (width < 8) sub-byte, with the exponent bias 127 and 5, at
    widths 3, 4, 6 and 8."""
    w = _crafted()
    for width, eb in ((wd, b) for wd in (3, 4, 6, 8) for b in (None, 5)):
        codes, scales = native.native_pack_int8(w, width, 8, eb, 16)
        p = pack_block_fp(torch.from_numpy(w), width, 8, eb, [1, 16])
        np.testing.assert_array_equal(codes, p.codes.numpy())
        np.testing.assert_array_equal(scales, p.scales.numpy())
        if width < 8:
            words, sub_scales = native.native_pack_subbyte(w, width, 8, eb, 16)
            p = pack_block_fp_subbyte(torch.from_numpy(w), width, 8, eb, [1, 16])
            np.testing.assert_array_equal(words, p.words.numpy())
            np.testing.assert_array_equal(sub_scales, p.scales.numpy())


@pytest.mark.parametrize("kind", ["int8", "subbyte"])
def test_native_matches_jax_off_the_fault_1_points(kind):
    """Random weights, with a zero block and a k_stride (int8), widths 4
    and 6: equal to the JAX package's ``pack_block_fp`` /
    ``pack_block_fp_subbyte``."""
    w = _w((24, 1300))
    for width in (4, 6):
        if kind == "int8":
            got = native.native_pack_int8(w, width, 8, None, 16, k_stride=1024)
            ref = jax_pack_block_fp(w, width, 8, None, [1, 16], k_stride=1024)
            want = (ref.codes, ref.scales)
        else:
            got = native.native_pack_subbyte(w, width, 8, None, 16)
            ref = jax_pack_block_fp_subbyte(w, width, 8, None, [1, 16])
            want = (ref.words, ref.scales)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(r))


def test_fault_1_point_native_equals_torch_not_jax():
    """A block whose max is exactly 2^-13: XLA:CPU's log2 gives -12.99999,
    so JAX's pack takes exponent -12; the port's engine and torch packer
    take the exact -13 (ROADMAP fault 1)."""
    w = np.full((1, 16), 2.0 ** -14, np.float32)
    w[0, 0] = 2.0 ** -13
    codes, scales = native.native_pack_int8(w, 6, 8, None, 16)
    np.testing.assert_array_equal(scales, _torch_int8(w, 6)[1])
    np.testing.assert_array_equal(codes, _torch_int8(w, 6)[0])
    assert scales[0, 0] == np.float32(2.0 ** -18)
    assert np.asarray(jax_pack_block_fp(w, 6, 8, None, [1, 16]).scales)[0, 0] == 2.0 ** -17


def test_native_result_does_not_depend_on_threads(monkeypatch):
    w = _w((97, 1280))
    results = {}
    for n in (1, 16):
        monkeypatch.setattr(loader, "_n_threads", lambda: n)
        results[n] = (native.native_pack_int8(w, 6, 8, None, 16),
                      native.native_pack_subbyte(w, 6, 8, None, 16))
    for a, b in zip(results[1], results[16]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_native_counts_its_calls():
    native.reset_native_calls()
    native.native_pack_int8(_w((4, 32)), 6)
    native.native_pack_subbyte(_w((4, 32)), 6)
    assert native.native_calls() == 2
    native.reset_native_calls()
    assert native.native_calls() == 0


_BUILD = r'''
import sys
from pathlib import Path
from llm_mixed_q_torch.native import loader
loader.BUILD_ROOT = Path(sys.argv[1])
assert loader.native_available()
codes, _ = loader.native_pack_int8([[0.5] * 16], 6)
print(loader._lib_path(), int(codes[0, 0]))
'''


def test_parallel_builds_all_load(tmp_path):
    """Four processes build the engine into one empty directory at once:
    each links under its own name and renames into place, and all four
    load it."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1 and lines.pop().endswith(" 31")
    built = list(tmp_path.rglob("*.so"))
    assert [p.name for p in built] == ["libbfp_pack.so"]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bfp_pack.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "_SRC", bad)
    monkeypatch.setattr(loader, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(loader, "_state", {})
    with pytest.raises(RuntimeError, match="build failed"):
        loader.native_available()


# ------------------------------------------------------------ host packing


def _leaves(tree, path=""):
    if isinstance(tree, PACKED_TYPES):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k, x in la.items():
        y = lb[k]
        assert type(x) is type(y), k
        if isinstance(x, PACKED_TYPES):
            assert x[2:] == y[2:] and all(torch.equal(s, t) for s, t in zip(x[:2], y[:2])), k
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("subbyte,fuse,bf16_embed", [(False, True, False), (True, True, False),
                                                     (False, False, True), (True, False, True)])
def test_pack_llama_params_host_equals_device_packing(subbyte, fuse, bf16_embed):
    """Every packed leaf bit-equal to ``pack_llama_params(device="cpu")``'s,
    the native engine called, and the logits equal."""
    _, tc, jp = _families("llama", BFP6)
    tp = params_from_jax(jp, device="cpu")
    kw = dict(subbyte=subbyte, fuse=fuse, bf16_embed=bf16_embed, device="cpu")
    native.reset_native_calls()
    host = pack_llama_params_host(tp, tc, **kw)
    assert native.native_calls() > 0
    dev = pack_llama_params(tp, tc, **kw)
    _assert_trees_equal(host, dev)
    kind = PackedBFPSubT if subbyte else PackedBFP
    node = host["layers"][0]["self_attn"]["qkv_proj" if fuse else "q_proj"]
    assert isinstance(node["weight"], kind)
    ids = torch.from_numpy(_batch()[0])
    assert torch.equal(llama_for_causal_lm(host, ids, config=tc)["logits"],
                       llama_for_causal_lm(dev, ids, config=tc)["logits"])


def test_host_packing_without_gxx_uses_the_torch_packer(monkeypatch):
    """No g++: the engine is unavailable, with a warning, and the host path
    packs with the torch packer on the CPU, to the same bits."""
    _, tc, jp = _families("llama", BFP6)
    tp = params_from_jax(jp, device="cpu")
    want = pack_llama_params(tp, tc, subbyte=True, device="cpu")
    monkeypatch.setattr(loader.shutil, "which", lambda name: None)
    monkeypatch.setattr(loader, "_state", {})
    native.reset_native_calls()
    assert not native.native_available()
    got = pack_llama_params_host(tp, tc, subbyte=True, device="cpu")
    assert native.native_calls() == 0
    _assert_trees_equal(got, want)
