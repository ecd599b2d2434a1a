"""``parallel/`` in a world of 4 ranks on the CPU, against the JAX package.

One module-scoped fixture spawns a 4-rank gloo world once
(``tests/torch_parallel_worker.py``, a data = 2 x model = 2 mesh, one
intra-op thread a rank), which runs every scenario and hands back numpy
results; the JAX side runs here, on the 8 virtual CPU devices of
``tests/conftest.py``. The trees are the JAX package's (``params_from_jax``),
the inputs drawn from numpy seeds. The scenarios:

- the TP fake-quant forward of a Llama (2 layers, 4 heads over 2 kv heads,
  intermediate 1088) under ``bfp_6bit.toml`` and ``block_minifloat.toml``
  (whose zero-block fill is a minimum over the whole tensor: the ranks
  take it together), and of an OPT and a BERT classifier under
  ``bfp_6bit.toml``, against JAX's forward sharded on a 2 x 2 mesh, within
  1e-4 of max|logit|, the unsharded forward's tolerance
  (``tests/test_torch_llama.py``);
- greedy ``generate`` on the packed sub-byte-T tree (fused q/k/v and
  gate/up, split part by part; intermediate 128) and the int8 tree
  (unfused; down_proj's K of 1088 padded to 2048 by the packer, split by
  its real K) against JAX's
  ``generate_greedy``: tokens equal; then ``decode_step`` on a
  kv-head-sharded packed cache after a prefill, its logits within 1e-4 of
  max|logit| of JAX's; OPT's greedy ``generate`` on its int8 tree, JAX's
  tokens;
- one QAT step of the cls head under DP x TP, and with ``fsdp``, against
  JAX's ``make_qat_train_step`` on the global batch: the loss within rtol
  1e-5 and the gradients within 1e-4 of each leaf's max|grad|, as
  ``tests/test_torch_qat.py`` holds a step; the parameters after the
  update within 1e-2 of each leaf's max|change|, as it holds a trajectory,
  but where Adam's first step is steep in the gradient
  (``_close_after_adam``); the same loss on every rank; an LM batch
  whose data slices hold unequal token counts, its loss the global
  batch's;
- ``train_qat`` on the mesh with ``fsdp``: its checkpoint restores on one
  process, and a resume under the same world is bit-equal to the
  uninterrupted run;
- ``graft_entry.dryrun_multichip(4)`` on the (dcn, data, model) = (1, 2, 2)
  hybrid mesh, and its helper ``_dryrun`` there fed JAX's tree: the QAT
  loss within rtol 1e-5 on every rank and the decode step's logits within
  1e-4 of max|logit| of the JAX script's steps on 4 virtual devices
  (``tests/test_torch_graft_entry.py:jax_dryrun``);
- last, two simulated hosts of 2 ranks (``initialize(local_device_count=2)``)
  on the hybrid meshes (dcn, data, model) = (2, 2, 1) and (2, 1, 2)
  (ROADMAP fault 19): each rank's rows of ``global_batch`` from its host's
  local batch are the rows of JAX's device at the same coordinates under
  ``batch_spec_hybrid()`` (JAX's ``device_put`` of the stacked global
  batch on 4 of the virtual devices), where the contract before the repair
  took others; one QAT step from host-local batches (DP on both meshes,
  FSDP on the first) is JAX's step on the global batch, held as above."""

import functools
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_cls import _np, cls_batch
from test_torch_graft_entry import jax_dryrun
from test_torch_llama import _flat
from test_torch_qat import _close_to_leaf_max

from llm_mixed_q_tpu.models import get_model_fn as jax_model_fn
from llm_mixed_q_tpu.models.api import make_forward as jax_make_forward
from llm_mixed_q_tpu.models.bert import BertQuantizedConfig as JaxBert
from llm_mixed_q_tpu.models.hf_loader import init_bert_params, init_opt_params
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import serving as jax_serving
from llm_mixed_q_tpu.models.llama.pack import pack_llama_params as jax_pack
from llm_mixed_q_tpu.models.opt import OPTQuantizedConfig as JaxOPT
from llm_mixed_q_tpu.models.opt import serving as jax_opt_serving
from llm_mixed_q_tpu.models.opt.pack import pack_opt_params as jax_pack_opt
from llm_mixed_q_tpu.parallel import make_mesh as jax_make_mesh
from llm_mixed_q_tpu.parallel.distributed import batch_spec_hybrid as jax_batch_spec_hybrid
from llm_mixed_q_tpu.parallel.distributed import make_hybrid_mesh as jax_make_hybrid_mesh
from llm_mixed_q_tpu.parallel import shard_params as jax_shard_params
from llm_mixed_q_tpu.train.qat import make_adamw as jax_make_adamw
from llm_mixed_q_tpu.train.qat import make_qat_train_step as jax_qat_step
from llm_mixed_q_torch.graft_entry import _DRYRUN_KW, BFP6
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.train.qat import (
    MultiSteps,
    _checkpoint_manager,
    _trainable,
    make_adamw,
    named_leaves,
    restore_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
QUANT = {a: str(ROOT / f"configs/quantization/{a}.toml") for a in ("bfp_6bit", "block_minifloat")}
KW = dict(vocab_size=96, hidden_size=64, intermediate_size=1088, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
QAT_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
              pad_token_id=0)
OPT_KW = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, ffn_dim=128,
              num_attention_heads=4, max_position_embeddings=128)
BERT_KW = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=160, max_position_embeddings=64, num_labels=2)
# the packed trees: sub-byte-T fused (its row-parallel nodes stay whole, and
# JAX's interpreted kernel costs ~4x at intermediate 1088), int8 unfused at
# intermediate 1088 (down_proj's K packed to 2048)
SERVE = {"subbyte_t": (dict(KW, intermediate_size=128), dict(subbyte=True)),
         "int8": (KW, dict(fuse=False))}
PROMPT, NEW, LR, WD = 8, 8, 1e-3, 0.01
TOL = 1e-4  # of max|logit|
WORLD = 4
TIMEOUT = 300
_INPUTS = {}  # the fixture's inputs by id, for the cached JAX steps


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _lm_batch(seed=11):
    """4 sequences of 16 tokens; rows 0-1 (data slice 0) with most labels
    ignored, rows 2-3 with all but a few kept."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 96, size=(4, 16)).astype(np.int32)
    labels = ids.copy()
    labels[0, 3:] = -100
    labels[1, 9:] = -100
    labels[3, :2] = -100
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels}


def _inputs():
    rng = np.random.default_rng(0)
    jc = JaxConfig(**KW, quant_config=QUANT["bfp_6bit"])
    float_tree = _np(jax_init(jc, task="lm", seed=0))
    packed = {}
    for name, (kw, pack) in SERVE.items():
        sc = JaxConfig(**kw, quant_config=QUANT["bfp_6bit"])
        # jitted: the eager packers take ~10x as long
        packed[name] = (kw, _np(jax.jit(lambda p, sc=sc, pack=pack: jax_pack(p, sc, **pack))(
            jax_init(sc, task="lm", seed=0))))
    families = {"opt": ("lm", OPT_KW, _np(init_opt_params(
                    JaxOPT(**OPT_KW, quant_config=QUANT["bfp_6bit"]), task="lm", seed=2))),
                "bert": ("cls", BERT_KW, _np(init_bert_params(
                    JaxBert(**BERT_KW, quant_config=QUANT["bfp_6bit"]), task="cls", seed=3)))}
    oc = JaxOPT(**OPT_KW, quant_config=QUANT["bfp_6bit"])
    opt_int8 = (OPT_KW, _np(jax.jit(lambda p: jax_pack_opt(p, oc, subbyte=False))(
        init_opt_params(oc, task="lm", seed=4))))
    qc = JaxConfig(**QAT_KW, quant_config=QUANT["bfp_6bit"])
    qat_trees = {"cls": _np(jax_init(qc, task="cls", seed=1)),
                 "lm": _np(jax_init(qc, task="lm", seed=1))}
    return {"kw": KW, "fwd_quants": QUANT, "serve_quant": QUANT["bfp_6bit"],
            "float_tree": float_tree, "packed_trees": packed, "families": families,
            "opt_int8": opt_int8,
            "ids": rng.integers(0, 96, size=(4, 16)).astype(np.int64),
            "prompt": rng.integers(2, 96, size=(4, PROMPT)).astype(np.int64),
            "new": NEW, "max_len": PROMPT + NEW,
            "qat_kw": QAT_KW, "qat_quant": QUANT["bfp_6bit"], "qat_trees": qat_trees,
            "lr": LR, "wd": WD, "cls_batch": cls_batch(0, n=4, seed=5),
            "lm_batch": _lm_batch(),
            "ckpt_batches": [cls_batch(0, n=4, seed=s) for s in (21, 22)],
            "graft_tree": _np(jax_init(JaxConfig(**_DRYRUN_KW, quant_config=BFP6), task="lm",
                                       seed=0)),
            "host_rows": np.random.default_rng(19).integers(0, 1000, size=(8, 3))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the 4 ranks' results)."""
    workdir = tmp_path_factory.mktemp("world")
    inp = _inputs()
    _INPUTS[id(inp)] = inp
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(port),
                               str(workdir)], env=env) for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for r in range(WORLD):
        path = workdir / f"rank{r}.pkl"
        assert path.is_file(), f"rank {r} wrote no results (exit {procs[r].returncode})"
        with open(path, "rb") as f:
            results.append(pickle.load(f))
        assert "error" not in results[-1], f"rank {r}:\n{results[-1]['error']}"
    return inp, results, workdir


def _by_data(results, key_fn):
    """The data slices' results (the ranks of model coordinate 0), in data
    order, concatenated along the batch."""
    parts = sorted((r["coords"]["data"], key_fn(r)) for r in results
                   if r["coords"]["model"] == 0)
    return np.concatenate([p for _, p in parts])


def _close_to_max(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


def test_world_is_a_2_by_2_mesh(world):
    _, results, _ = world
    coords = sorted((r["coords"]["data"], r["coords"]["model"]) for r in results)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("arith", list(QUANT))
def test_tp_forward_matches_jax_sharded(world, arith):
    inp, results, _ = world
    jc = JaxConfig(**KW, quant_config=QUANT[arith])
    mesh = jax_make_mesh(data=2, model=2)
    params = jax_shard_params(jax.tree.map(jnp.asarray, inp["float_tree"]), mesh)
    ids = jax.device_put(jnp.asarray(inp["ids"], jnp.int32), NamedSharding(mesh, P("data")))
    want = np.asarray(jax_make_forward("llama", "lm", jc)(params, ids, None)["logits"])
    got = _by_data(results, lambda r: r["forward"][arith])
    for r in results:  # the model ranks of a slice gather the same logits
        same = [o["forward"][arith] for o in results if o["coords"]["data"] == r["coords"]["data"]]
        np.testing.assert_array_equal(same[0], same[1])
    _close_to_max(got, want)


@pytest.mark.parametrize("arch", ["opt", "bert"])
def test_tp_forward_of_opt_and_bert_matches_jax_sharded(world, arch):
    """OPT (q/k/v and fc1 column-parallel, out_proj and fc2 row-parallel,
    the vocabulary split) and BERT (query/key/value and intermediate.dense
    column-parallel, the output.dense nodes row-parallel, the classifier's
    labels split) under bfp_6bit.toml."""
    inp, results, _ = world
    task, kw, tree = inp["families"][arch]
    config = {"opt": JaxOPT, "bert": JaxBert}[arch](**kw, quant_config=inp["serve_quant"])
    mesh = jax_make_mesh(data=2, model=2)
    params = jax_shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    ids = jax.device_put(jnp.asarray(inp["ids"], jnp.int32), NamedSharding(mesh, P("data")))
    want = np.asarray(jax_make_forward(arch, task, config)(params, ids, jnp.ones_like(ids))[
        "logits"])
    _close_to_max(_by_data(results, lambda r: r["families"][arch]), want)


def _jax_serve(inp, name):
    kw, tree = inp["packed_trees"][name]
    jc = JaxConfig(**kw, quant_config=inp["serve_quant"])
    params = jax.tree.map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, tree)
    prompt = inp["prompt"].astype(np.int32)
    tokens = np.asarray(jax_serving.generate_greedy(params, jc, prompt, max_new_tokens=NEW))
    cache = jax_serving.init_packed_kv_cache(jc, prompt.shape[0], PROMPT + NEW,
                                             jax_serving.kv_cache_pack_spec(jc))
    logits, cache, lengths = jax.jit(lambda p, c: jax_serving.prefill_into_cache(
        p, prompt, np.ones_like(prompt), c, jc))(params, cache)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    step, _ = jax.jit(lambda p, c: jax_serving.decode_step(p, tok, c, lengths, jc))(params, cache)
    return tokens, np.asarray(step)


@pytest.mark.parametrize("name", ["subbyte_t", "int8"])
def test_tp_generate_and_decode_step_match_jax(world, name):
    inp, results, _ = world
    want_tokens, want_step = _jax_serve(inp, name)
    np.testing.assert_array_equal(_by_data(results, lambda r: r["serve"][name]["tokens"]),
                                  want_tokens)
    _close_to_max(_by_data(results, lambda r: r["serve"][name]["step"]), want_step)


def test_tp_opt_generate_matches_jax(world):
    """OPT's greedy ``generate`` on its int8 tree (out_proj and fc2 split by
    their K, the float32 cache holding each rank's heads): JAX's tokens."""
    inp, results, _ = world
    kw, tree = inp["opt_int8"]
    config = JaxOPT(**kw, quant_config=inp["serve_quant"])
    params = jax.tree.map(lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, tree)
    want = np.asarray(jax_opt_serving.generate_greedy(params, config,
                                                      inp["prompt"].astype(np.int32),
                                                      max_new_tokens=NEW))
    np.testing.assert_array_equal(_by_data(results, lambda r: r["serve"]["opt_int8"]["tokens"]),
                                  want)


def test_the_cache_is_sharded_on_kv_heads(world):
    """Each rank's packed cache holds its one kv head of the two, in the
    pos-major layout (the JAX package's choice at 2 x 16 lanes)."""
    _, results, _ = world
    for r in results:
        for name in SERVE:
            assert r["serve"][name]["kv_heads"] == 1 and r["serve"][name]["pos_major"]


@functools.lru_cache(maxsize=None)
def _jax_step(inp_id, key, task):
    """JAX's step on the global batch -> (loss, gradients, parameters after
    the update, before it)."""
    inp = _INPUTS[inp_id]
    jc = JaxConfig(**QAT_KW, quant_config=inp["qat_quant"])
    params = jax.tree.map(jnp.asarray, inp["qat_trees"][task])
    optimizer = jax_make_adamw(LR, WD)
    batch = {k: jnp.asarray(v) for k, v in inp[key].items()}
    loss_fn = lambda p: jax_model_fn("llama", task)(
        p, batch["input_ids"], batch["attention_mask"], labels=batch["labels"],
        config=jc)["loss"]
    grads = jax.jit(jax.grad(loss_fn))(params)
    new, _, loss = jax_qat_step("llama", task, jc, optimizer)(params, optimizer.init(params),
                                                              batch)
    return (float(loss), _flat(_np(grads)), _flat(_np(new)),
            _flat(inp["qat_trees"][task]))


def _close_after_adam(got, want, start, grads):
    """Parameters after one AdamW update, held as ``_close_to_leaf_change``
    holds a trajectory (each leaf within 1e-2 of its max|change|), except
    where JAX's gradient is under 100 eps (1e-6): Adam's first step there,
    lr * g / (|g| + eps), moves with g at the slope lr / eps, so a gradient
    summed in another order (the ranks' partial sums) moves it by up to lr;
    those elements are held within lr of JAX's."""
    for k, w in want.items():
        scale = np.abs(w - start[k]).max()
        steep = np.abs(grads[k]) < 1e-6
        err = np.abs(got[k] - w)
        assert (err[~steep] <= 1e-2 * scale).all(), (k, err[~steep].max() / scale)
        assert (err[steep] <= LR * (1 + 1e-3)).all(), k


@pytest.mark.parametrize("mode,key,task", [("dp_tp", "cls_batch", "cls"),
                                           ("fsdp", "cls_batch", "cls"),
                                           ("lm_unequal", "lm_batch", "lm")])
def test_qat_step_matches_jax_on_the_global_batch(world, mode, key, task):
    inp, results, _ = world
    want_loss, want_grads, want, start = _jax_step(id(inp), key, task)
    losses = [r["qat"][mode]["loss"] for r in results]
    assert len(set(losses)) == 1, losses  # the same loss on every rank
    np.testing.assert_allclose(losses[0], want_loss, rtol=1e-5)
    got = next(r["qat"][mode] for r in results if r["qat"][mode]["params"])
    _close_to_leaf_max(got["grads"], want_grads, 1e-4, "grad")
    _close_after_adam(got["params"], want, start, want_grads)


def test_unequal_token_counts_weight_the_loss(world):
    """The LM batch's data slices hold 15 and 26 labelled tokens: the mean
    of the two slices' means is not the global loss."""
    inp, _, _ = world
    labels = inp["lm_batch"]["labels"][:, 1:]
    counts = [(labels[:2] != -100).sum(), (labels[2:] != -100).sum()]
    assert counts[0] != counts[1]


def test_checkpoint_of_the_world_restores_on_one_process(world):
    inp, results, workdir = world
    params = _trainable(params_from_jax(inp["qat_trees"]["cls"], device="cpu"))
    opt = MultiSteps(*make_adamw(params, LR, WD, 2, 0, "cosine"))
    _, _, step = restore_checkpoint(_checkpoint_manager(workdir / "ckpt_full"), params, opt)
    assert step == 2
    full = results[0]["checkpoint"]["full"]
    restored = {"/" + "/".join(map(str, p)): t.detach().numpy() for p, t in named_leaves(params)}
    assert restored.keys() == full.keys()
    for k in full:
        np.testing.assert_array_equal(restored[k], full[k], err_msg=k)
    assert opt.optimizer.state_dict()["state"]  # AdamW's moments came back whole
    assert all(torch.isfinite(m["exp_avg"]).all() for m in opt.optimizer.state.values())


def test_resume_under_the_world_is_bit_equal(world):
    _, results, _ = world
    for r in results:
        full, resumed = r["checkpoint"]["full"], r["checkpoint"]["resumed"]
        assert full.keys() == resumed.keys()
        for k in full:
            np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


def test_graft_dryrun_on_the_world_matches_jax(world):
    inp, results, _ = world
    want_loss, want_logits, tree = jax_dryrun(2, 2)
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(v, _flat(inp["graft_tree"])[k], err_msg=k)
    parts = [r["graft"] for r in results]
    assert sorted(tuple(p["coords"].values()) for p in parts) == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    for p in parts:  # the loss of the global batch on every rank
        np.testing.assert_allclose(p["loss"], want_loss, rtol=1e-5)
    got = np.concatenate([p["logits"] for p in sorted(parts, key=lambda p: p["coords"]["data"])
                          if p["coords"]["model"] == 0])
    assert got.shape == want_logits.shape == (4, 128)
    _close_to_max(got, want_logits)


HYBRID = {"2x2x1": (2, 2, 1), "2x1x2": (2, 1, 2)}


def _jax_rows(rows, shape):
    """{(dcn, data, model): rows} of JAX's devices: the global batch put on
    a hybrid mesh of 4 of the virtual devices under ``batch_spec_hybrid()``."""
    mesh = jax_make_hybrid_mesh(*shape, devices=jax.devices()[:4])
    arr = jax.device_put(rows, NamedSharding(mesh, jax_batch_spec_hybrid()))
    return {tuple(int(i) for i in np.argwhere(mesh.devices == s.device)[0]): np.asarray(s.data)
            for s in arr.addressable_shards}


def _coords(part):
    c = part["coords"]
    return c["dcn"], c["data"], c["model"]


@pytest.mark.parametrize("name", list(HYBRID))
def test_host_local_batches_give_jax_devices_rows(world, name):
    inp, results, _ = world
    want = _jax_rows(inp["host_rows"], HYBRID[name])
    parts = [r["hosts"][name] for r in results]
    assert sorted(p["host"] for p in parts) == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert sorted(map(_coords, parts)) == sorted(want)
    for p in parts:
        assert p["global_shape"] == inp["host_rows"].shape
        np.testing.assert_array_equal(p["rows"], want[_coords(p)])


def test_the_old_contract_took_other_rows(world):
    """Fault 19 before its repair: a rank cut its host's local batch as if
    it were the global batch, so on (2, 2, 1) each rank kept a quarter of
    its host's half and the ranks together held half of the global batch,
    not JAX's rows."""
    inp, results, _ = world
    want = _jax_rows(inp["host_rows"], HYBRID["2x2x1"])
    parts = [r["hosts"]["2x2x1"] for r in results]
    assert all(len(p["old_rows"]) == len(p["rows"]) // 2 for p in parts)
    assert all(not np.array_equal(p["old_rows"], want[_coords(p)]) for p in parts)
    held = np.concatenate([p["old_rows"] for p in parts])
    assert len(np.unique(held, axis=0)) == len(inp["host_rows"]) // 2


@pytest.mark.parametrize("name,mode", [("2x2x1", "dp"), ("2x2x1", "fsdp"), ("2x1x2", "dp")])
def test_qat_step_from_host_local_batches_matches_jax(world, name, mode):
    inp, results, _ = world
    want_loss, want_grads, want, start = _jax_step(id(inp), "cls_batch", "cls")
    steps = [r["hosts"][name][mode] for r in results]
    losses = [s["loss"] for s in steps]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], want_loss, rtol=1e-5)
    got = next(s for s in steps if s["params"])
    _close_to_leaf_max(got["grads"], want_grads, 1e-4, "grad")
    _close_after_adam(got["params"], want, start, want_grads)
