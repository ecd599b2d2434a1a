"""The port's QAT trainer against the JAX package, on the CPU at a tiny size
(the models of tests/test_torch_cls.py): one QAT step's loss and gradients,
the decay mask, the learning rate at every update (ROADMAP.md fault 11:
the schedule is sized in micro-steps and advanced once an update),
``train_qat``'s trajectory, checkpoint and resume, ``remat``, and the
train CLIs.

Tolerances: a step's loss within 1e-5 relative and each leaf's gradient
within 1e-4 of that leaf's max|grad| (float32 sums in another order); the
learning rate within 1e-6 of the peak (optax rounds each operation of the
schedule to float32, and XLA divides by a constant as a product with its
reciprocal, so near the schedule's end optax's value carries rounding of
its own, down to -3e-13 where the exact value is 0; the port computes in
float64); a trajectory's losses within 1e-5 relative
and its final parameters within 1e-2 of each leaf's max|change|, all but
1 in 10^4 within 1e-4 (``_close_to_leaf_change`` says why); a resumed
run equal to the uninterrupted one within rtol 1e-6."""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_cls import KW, VOCAB, SEQ, _configs, _np, _toml, cls_batch, llama_trees
from test_torch_cls import opt_checkpoint, opt_trees, pair_tokenizer, raw_glue  # noqa: F401
from test_torch_llama import _flat

import llm_mixed_q_tpu.cli.train_cli as jax_train_cli
from llm_mixed_q_tpu.models import get_model_fn as jax_model_fn
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init_llama
from llm_mixed_q_tpu.models.llama.modeling import llama_for_causal_lm as jax_llama_lm
from llm_mixed_q_tpu.train.qat import make_adamw as jax_make_adamw
from llm_mixed_q_tpu.train.qat import train_qat as jax_train_qat
import llm_mixed_q_torch.cli.train_cli as port_train_cli
from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset, numpy_dataloader
from llm_mixed_q_torch.models import get_model_fn
from llm_mixed_q_torch.models.hf_loader import params_from_jax, params_to_numpy
from llm_mixed_q_torch.models.llama.modeling import (
    llama_for_causal_lm,
    llama_model,
    sequence_classification_head,
)
from llm_mixed_q_torch.train import make_adamw, make_qat_train_step, train_qat
from llm_mixed_q_torch.train.qat import (
    MultiSteps,
    _checkpoint_manager,
    _trainable,
    is_decay,
    lr_schedule,
    named_leaves,
    restore_checkpoint,
    save_checkpoint,
)


def _trees(arch, quant):
    """(JAX config, port config, JAX numpy tree, port tree) of a cls model."""
    jc, tc = _configs(arch, quant)
    jp, tp = opt_trees(jc, tc) if arch == "opt" else llama_trees(jc)
    return jc, tc, jp, tp


def _port_flat(tree, attr=None):
    """path -> array of a port tree (``attr="grad"``: of its gradients), in
    ``_flat``'s path format."""
    return {"/" + "/".join(map(str, p)): (getattr(t, attr) if attr else t).detach().numpy()
            for p, t in named_leaves(tree)}


def _batch(arch, n=4, seed=3):
    return cls_batch(KW[arch]["pad_token_id"], n=n, seed=seed)


def _close_to_leaf_max(got, want, tol, what):
    """Each leaf within ``tol`` of its max|want|. An attention key's bias
    has a gradient of 0 in exact arithmetic (the softmax ignores a shift
    shared by every key), so each package holds only its own rounding
    noise there: those leaves are held below 1e-5 of the largest leaf's
    max in both instead."""
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if k.endswith("k_proj/bias"):
            assert max(np.abs(got[k]).max(), np.abs(w).max()) < 1e-5 * top, f"{what} {k}"
            continue
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch,toml", [("opt", "bypass"), ("opt", "bfp_4bit"),
                                       ("llama", "bypass"), ("llama", "bfp_4bit")])
def test_qat_step_gradients_match_jax(arch, toml):
    """The loss of a QAT forward (weights fake-quantized, STE backward) and
    every leaf's gradient against ``jax.value_and_grad``."""
    jc, tc, jp, tp = _trees(arch, None if toml == "bypass" else _toml(toml))
    b = _batch(arch)

    def jax_loss(p):
        return jax_model_fn(arch, "cls")(p, b["input_ids"], b["attention_mask"],
                                         labels=b["labels"], config=jc)["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(jp)
    tp = _trainable(tp)
    loss = get_model_fn(arch, "cls")(tp, *(torch.from_numpy(b[k]) for k in
                                           ("input_ids", "attention_mask", "labels")),
                                     config=tc, quantize_weights=True)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _close_to_leaf_max(_port_flat(tp, "grad"), _flat(_np(want_grads)), 1e-4, "grad")


@pytest.mark.parametrize("arch", ["opt", "llama"])
def test_decay_mask_matches_jax(arch):
    """The leaves that decay, read from one update on zero gradients of an
    all-ones tree (only the decoupled decay moves a leaf): the same paths
    in both packages, and none of a bias, a norm or a vector."""
    _, _, jp, tp = _trees(arch, None)
    jones = jax.tree.map(np.ones_like, jp)
    opt = jax_make_adamw(1e-2, weight_decay=0.5)
    updates, _ = opt.update(jax.tree.map(np.zeros_like, jones), opt.init(jones), jones)
    want = {k for k, v in _flat(_np(updates)).items() if np.any(v != 0)}

    tones = _trainable(params_from_jax(jones, device="cpu"))
    adamw, _ = make_adamw(tones, 1e-2, weight_decay=0.5)
    for _, t in named_leaves(tones):
        t.grad = torch.zeros_like(t)
    adamw.step()
    got = {k for k, v in _port_flat(tones).items() if np.any(v != 1)}
    assert got == want == {"/" + "/".join(map(str, p)) for p, t in named_leaves(tp)
                           if is_decay(p, t)}
    assert not any(k.endswith("bias") or "norm" in k for k in got)
    assert "/layers/0/fc1/weight" in got or "/layers/0/mlp/up_proj/weight" in got


def _jax_lrs(schedule, warmup, total, accum, lr=2e-5, seed=0):
    """JAX's learning rate at each update of ``total`` micro-steps: the
    ratio of its update to that of ``optax.adamw(1.0, weight_decay=0)`` on the same
    gradients of a scalar (no decay), both under ``optax.MultiSteps``."""
    def wrap(o):
        return optax.MultiSteps(o, accum) if accum > 1 else o

    sched = wrap(jax_make_adamw(lr, 0.0, total, warmup, schedule))
    unit = wrap(optax.adamw(1.0, weight_decay=0.0))
    p = {"w": jnp.float32(0.5)}
    states = [sched.init(p), unit.init(p)]
    step = jax.jit(lambda s, u, g: (sched.update(g, s, p), unit.update(g, u, p)))
    grads = np.random.default_rng(seed).normal(size=total).astype(np.float32)
    lrs = []
    for g in grads:
        (us, states[0]), (uu, states[1]) = step(*states, {"w": jnp.float32(g)})
        if float(uu["w"]) != 0:
            lrs.append(float(us["w"]) / float(uu["w"]))
    return lrs


def _port_lrs(schedule, warmup, total, accum, lr=2e-5, seed=0):
    """The port's learning rate at each update of ``total`` micro-steps."""
    p = {"w": torch.tensor(0.5, requires_grad=True)}
    opt = MultiSteps(*make_adamw(p, lr, 0.0, total, warmup, schedule), every_k=accum)
    grads = np.random.default_rng(seed).normal(size=total).astype(np.float32)
    lrs = []
    for i, g in enumerate(grads):
        p["w"].grad = torch.tensor(g) if p["w"].grad is None else p["w"].grad + g
        if (i + 1) % accum == 0:
            lrs.append(opt.optimizer.param_groups[0]["lr"])
        opt.step()
    return lrs


@pytest.mark.parametrize("schedule,warmup,total,accum", [
    ("cosine", 0, 8, 1), ("cosine", 1, 6, 1), ("cosine", 3, 10, 1), ("linear", 0, 8, 1),
    ("linear", 2, 10, 1), ("cosine", 0, 32, 4), ("linear", 1, 12, 3)])
def test_learning_rate_matches_jax_at_every_update(schedule, warmup, total, accum):
    """Fault 11 pinned: at update u both packages take the schedule's value
    at u, though the schedule spans ``total`` micro-steps; with the
    protocol's 32 micro-steps and 4 a update, the cosine's last update
    still runs at 0.889 of the peak."""
    want = _jax_lrs(schedule, warmup, total, accum)
    got = _port_lrs(schedule, warmup, total, accum)
    at = lr_schedule(2e-5, total, warmup, schedule)
    assert len(got) == len(want) == total // accum
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 2e-5)
    assert got == [at(u) for u in range(total // accum)]
    if (schedule, total, accum) == ("cosine", 32, 4):
        np.testing.assert_allclose(got[-1] / 2e-5, 0.5 * (1 + np.cos(np.pi * 7 / 32)), rtol=1e-6)
        assert got[0] == 2e-5


@pytest.mark.parametrize("warmup,total", [(0, 8), (1, 6), (3, 10), (0, 100), (10, 1000)])
def test_lr_schedule_matches_optax(warmup, total):
    """Every step of the cosine against ``optax.warmup_cosine_decay_schedule``
    (at the peak from step 0 without warmup) and of the linear branch
    against optax's join of two linear schedules, beyond the end too."""
    lr = 2e-5
    cos = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    lin = optax.join_schedules([optax.linear_schedule(0.0, lr, max(warmup, 1)),
                                optax.linear_schedule(lr, 0.0, max(total - warmup, 1))],
                               [warmup])
    steps = np.arange(total + 3, dtype=np.int32)
    for name, ref in (("cosine", cos), ("linear", lin)):
        want = np.asarray(jax.jit(jax.vmap(ref))(steps))
        got = np.array([lr_schedule(lr, total, warmup, name)(int(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * lr, err_msg=name)
    assert lr_schedule(lr, total, warmup, "cosine")(0) == (lr if warmup == 0 else 0)
    assert lr_schedule(lr)(123) == lr
    with pytest.raises(ValueError, match="total_steps > warmup_steps"):
        lr_schedule(lr, 4, 4, "cosine")


def _factory(batches):
    calls = []

    def factory(start=0):
        calls.append(start)
        yield from batches[start:]

    return factory, calls


def _cls_batches(n_batches=6, bs=2, seed=11):
    return list(numpy_dataloader(make_synthetic_cls_dataset(VOCAB, SEQ, n_batches * bs,
                                                            seed=seed), bs))


def _steps(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _close_to_leaf_change(got, want, start, per=10_000):
    """Final parameters against the JAX package's, all but 1 in ``per``
    elements within 1e-4 of their leaf's max|change| and every one within
    1e-2 of it. Adam's step lr * g / (|g| + eps) has the slope lr / eps at
    g = 0, so a float32 rounding difference in a gradient near 0 (a
    near-cancelling sum) moves that element's step by up to
    lr * |dg| / eps: 3 of OPT's 82368 elements land between 1e-4 and 1e-3
    in the trajectory test. The train CLI's JAX run sums its gradients
    over a mesh of 8 devices, in another order again: 12 of its 82368
    elements lie beyond 1e-4, 1 beyond 1e-3 (it is held to 1 in 10^3).
    The attention keys' biases are left out: their gradient is 0 in exact
    arithmetic, and Adam turns either package's rounding noise into steps
    of +-lr."""
    assert got.keys() == want.keys()
    n = beyond = 0
    for k, w in want.items():
        if k.endswith("k_proj/bias"):
            continue
        scale = np.abs(w - start[k]).max()
        assert scale > 0, k
        err = np.abs(got[k] - w)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-2 * scale, err_msg=k)
        n, beyond = n + err.size, beyond + int((err > 1e-4 * scale).sum())
    assert beyond <= n // per, (beyond, n)


@pytest.mark.parametrize("arch", ["opt", "llama"])
def test_train_qat_trajectory_matches_jax(arch, tmp_path):
    """bfp_4bit, grad_accum 2, cosine, warmup 1, weight decay 0.1, 6
    micro-batches (3 updates): each step's loss and the final parameters
    against the JAX package's ``train_qat(mesh=None)``."""
    jc, tc, jp, tp = _trees(arch, _toml("bfp_4bit"))
    batches = _cls_batches()
    common = dict(num_epochs=1, learning_rate=1e-3, weight_decay=0.1, grad_accum_steps=2,
                  schedule="cosine", warmup_steps=1, steps_per_epoch=6, log_every=100)
    jfinal, jhist = jax_train_qat(arch, "cls", jc, jax.tree.map(jnp.array, jp),
                                  _factory(batches)[0], metrics_path=str(tmp_path / "j.jsonl"),
                                  **common)
    tfinal, thist = train_qat(arch, "cls", tc, tp, _factory(batches)[0],
                              metrics_path=str(tmp_path / "t.jsonl"), **common)
    want, got = _steps(tmp_path / "j.jsonl"), _steps(tmp_path / "t.jsonl")
    assert [l["step"] for l in got[:6]] == [l["step"] for l in want[:6]] == list(range(1, 7))
    np.testing.assert_allclose([l["loss"] for l in got[:6]], [l["loss"] for l in want[:6]],
                               rtol=1e-5)
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"], rtol=1e-5)
    _close_to_leaf_change(_port_flat(tfinal), _flat(_np(jfinal)), _flat(jp))
    np.testing.assert_array_equal(_port_flat(tp)["/score/weight"], _flat(jp)["/score/weight"])


def test_checkpoint_round_trip(tmp_path):
    _, tc, _, tp = _trees("llama", None)
    params = _trainable(tp)
    opt = MultiSteps(*make_adamw(params, 1e-3), every_k=2)
    mngr = _checkpoint_manager(str(tmp_path / "ckpt"))
    for step in range(1, 6):
        save_checkpoint(mngr, params, opt, step)
    assert mngr.all_steps() == [3, 4, 5] and mngr.latest_step() == 5
    fresh = _trainable(params_from_jax(jax.tree.map(np.zeros_like, params_to_numpy(tp)),
                                       device="cpu"))
    fresh_opt = MultiSteps(*make_adamw(fresh, 1e-3), every_k=2)
    r_params, r_opt, step = restore_checkpoint(mngr, fresh, fresh_opt)
    assert step == 5 and r_params is fresh and r_opt is fresh_opt
    for k, v in _port_flat(tp).items():
        np.testing.assert_array_equal(_port_flat(fresh)[k], v)
    assert restore_checkpoint(_checkpoint_manager(str(tmp_path / "none")), fresh, opt) is None


def test_resume_seeks_and_matches_the_uninterrupted_run(tmp_path):
    """Interrupted at micro-step 3, between the two micro-steps of an update
    (the checkpoint holds the half-summed gradients), then resumed: the
    factory is asked for ``start=3`` once, no batch is replayed, the
    parameters equal the uninterrupted run's, and ``metrics.jsonl`` holds
    steps 1-6 once."""
    _, tc, _, tp = _trees("llama", _toml("bfp_4bit"))
    batches = _cls_batches()
    common = dict(num_epochs=1, learning_rate=1e-3, grad_accum_steps=2, schedule="linear",
                  steps_per_epoch=6, log_every=100)
    factory, calls = _factory(batches)
    p_full, h_full = train_qat("llama", "cls", tc, tp, factory, **common)
    ck = str(tmp_path / "ckpt")
    train_qat("llama", "cls", tc, tp,
              lambda start=0: itertools.islice(factory(start), 3 - start),
              checkpoint_dir=ck, save_every_steps=3, **common)
    calls.clear()
    p_res, h_res = train_qat("llama", "cls", tc, tp, factory, checkpoint_dir=ck, resume=True,
                             **common)
    assert calls == [3], calls
    full, res = _port_flat(p_full), _port_flat(p_res)
    for k in full:
        np.testing.assert_allclose(res[k], full[k], rtol=1e-6, err_msg=k)
    assert h_res[0]["loss"] == h_full[0]["loss"]
    lines = _steps(tmp_path / "ckpt" / "metrics.jsonl")
    assert [l["step"] for l in lines if "step" in l] == [1, 2, 3, 4, 5, 6]
    assert sum("epoch" in l and "time" in l for l in lines) == 2
    assert _checkpoint_manager(ck).all_steps() == [3, 6]


def test_empty_epoch_and_mesh():
    """An empty epoch; a mesh of one rank (``parallel.make_mesh()`` without a
    process group) trains as no mesh does. Meshes of several ranks:
    ``tests/test_torch_parallel_world.py``."""
    from llm_mixed_q_torch.parallel import make_mesh

    _, tc, _, tp = _trees("llama", _toml("bfp_4bit"))
    p, hist = train_qat("llama", "cls", tc, tp, lambda: iter(()), num_epochs=1)
    assert hist == [{"epoch": 0, "loss": None}]
    p, hist = train_qat("llama", "cls", tc, tp, lambda: iter(()), mesh=make_mesh(), fsdp=True)
    assert hist == [{"epoch": 0, "loss": None}]
    step = make_qat_train_step("llama", "cls", tc, None, mesh=make_mesh(), fsdp=True)
    assert callable(step)


def test_remat_gives_the_same_loss_and_gradients():
    """``remat=True`` recomputes each decoder layer in the backward: the
    causal-LM loss and gradients equal those without it, and match the
    JAX package's ``remat=True``; a cls head on ``llama_model(remat=True)``
    too."""
    jc, tc = _configs("llama", _toml("bfp_4bit"))
    jp = _np(jax_init_llama(jc, seed=1))
    ids = np.random.default_rng(2).integers(1, VOCAB, (2, SEQ))
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_llama_lm(p, ids, None, labels=ids, config=jc, remat=True)["loss"]))(jp)
    results = []
    for remat in (False, True):
        tp = _trainable(params_from_jax(jp, device="cpu"))
        t_ids = torch.from_numpy(ids)
        loss = llama_for_causal_lm(tp, t_ids, labels=t_ids, config=tc, remat=remat)["loss"]
        loss.backward()
        results.append((loss.item(), _port_flat(tp, "grad")))
    assert results[0][0] == results[1][0]
    for k, g in results[0][1].items():
        np.testing.assert_array_equal(results[1][1][k], g)
    np.testing.assert_allclose(results[1][0], float(want_loss), rtol=1e-5)
    _close_to_leaf_max(results[1][1], _flat(_np(want_grads)), 1e-4, "grad")

    _, _, _, tcls = _trees("llama", None)
    b = _batch("llama")
    grads = []
    for remat in (False, True):
        tp = _trainable(tcls)
        ids_t = torch.from_numpy(b["input_ids"])
        hidden, _ = llama_model(tp, ids_t, torch.from_numpy(b["attention_mask"]), tc,
                                remat=remat)
        sequence_classification_head(tp, hidden, ids_t, torch.from_numpy(b["labels"]),
                                     tc)["loss"].backward()
        grads.append(_port_flat(tp, "grad"))
    for k, g in grads[0].items():
        np.testing.assert_array_equal(grads[1][k], g)


@pytest.fixture
def offline_train(monkeypatch):
    """Both packages' train CLIs read in-memory GLUE splits (16 training
    rows) through the stand-in tokenizer."""
    for mod in (jax_train_cli, port_train_cli):
        monkeypatch.setattr(mod, "get_raw_dataset_dict", lambda name: raw_glue(name, n=16))
        monkeypatch.setattr(mod, "get_tokenizer", lambda args: pair_tokenizer)


def _train_argv(ckpt, tmp_path, name):
    return ["--model_arch", "opt", "--model_name", str(ckpt), "--task", "sst2",
            "--seq_len", str(SEQ), "--batch_size", "8", "--num_train_epochs", "1",
            "--learning_rate", "1e-3", "--quant_config", _toml("bfp_4bit"),
            "--save_dir", str(tmp_path / name)]


def test_dp_train_runner_matches_jax(opt_checkpoint, offline_train, tmp_path):
    """2 steps of batch 8. The JAX package trains data-parallel over the
    tests' 8 CPU devices (gradients summed across its mesh in another
    order); the port on one device. History (the last step's loss, the
    eval's accuracy) and final parameters against it; ``fsdp_train_runner``
    gives the port the same run."""
    from llm_mixed_q_tpu.models.hf_loader import load_flat_state_dict

    ckpt = opt_checkpoint[2]
    jfinal, jhist = jax_train_cli.dp_train_runner(_train_argv(ckpt, tmp_path, "j"))
    tfinal, thist = port_train_cli.dp_train_runner(_train_argv(ckpt, tmp_path, "t")
                                                   + ["--device", "cpu"])
    assert len(thist) == 1 and thist[0]["accuracy"] == jhist[0]["accuracy"]
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"], rtol=1e-5)
    assert json.loads((tmp_path / "t" / "train_history.json").read_text()) == {"history": thist}
    start = {"/" + k.removeprefix("model.decoder.").replace(".", "/"): v
             for k, v in load_flat_state_dict(ckpt).items() if "qa_outputs" not in k}
    _close_to_leaf_change(_port_flat(tfinal), _flat(_np(jfinal)), start, per=1000)
    _, fhist = port_train_cli.fsdp_train_runner(_train_argv(ckpt, tmp_path, "f")
                                                + ["--device", "cpu"])
    assert fhist == thist


def test_train_runner_defaults_to_the_card(opt_checkpoint, offline_train, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default does not raise here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train_cli.dp_train_runner(_train_argv(opt_checkpoint[2], tmp_path, "d"))
