"""``llm_mixed_q_torch.graft_entry`` against the repo's ``__graft_entry__.py``
on the CPU.

- ``entry()``: the port's forward on JAX's ``entry()`` parameters
  (``params_from_jax``) and ids against ``jax.jit(fn)(*args)``, within 1e-4
  of max|logit| (the fake-quant forward's tolerance,
  ``tests/test_torch_llama.py``); ``BFP6`` equal to JAX's;
- the dry run's work (``_dryrun``) on one process, fed JAX's trees, against
  the JAX script's steps (``jax_dryrun``: JAX's public functions as
  ``__graft_entry__.py`` calls them, on a 1-device hybrid mesh): the QAT
  step's loss at rtol 1e-5 and the decode step's logits within 1e-4 of
  max|logit|. The 4-rank run of ``dryrun_multichip(4)`` and its helper on
  the (1, 2, 2) mesh is a scenario of ``tests/test_torch_parallel_world.py``;
- ``dryrun_multichip`` on one process, its refusal of another world size,
  and ``python -m llm_mixed_q_torch.graft_entry --device cpu``."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__ as jax_graft
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import serving as jax_serving
from llm_mixed_q_tpu.parallel import shard_params as jax_shard_params
from llm_mixed_q_tpu.parallel.distributed import batch_spec_hybrid, make_hybrid_mesh
from llm_mixed_q_tpu.train import make_qat_train_step as jax_qat_step
from llm_mixed_q_torch import graft_entry
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.parallel.distributed import make_hybrid_mesh as port_hybrid_mesh

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4  # of max|logit|


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def close_to_max(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


def jax_dryrun(data: int, model: int):
    """The JAX script's ``dryrun_multichip`` steps on a (1, data, model)
    hybrid mesh of the first data x model virtual devices -> (the QAT
    step's loss, the decode step's logits [b, vocab], the init tree as
    numpy)."""
    mesh = make_hybrid_mesh(dcn=1, data=data, model=model, devices=jax.devices()[:data * model])
    config = JaxConfig(**graft_entry._DRYRUN_KW, quant_config=jax_graft.BFP6)
    tree = _np(jax_init(config, task="lm", seed=0))
    params = jax_shard_params(jax.tree.map(jnp.asarray, tree), mesh, fsdp=False)
    optimizer = optax.adamw(1e-4)
    opt_state = optimizer.init(params)
    step = jax_qat_step("llama", "lm", config, optimizer, mesh)
    rng = np.random.default_rng(0)
    bs = max(2, 2 * data)
    ids = rng.integers(0, 128, size=(bs, 16))
    batch_sharding = NamedSharding(mesh, batch_spec_hybrid())
    batch = {"input_ids": jnp.asarray(ids, jnp.int32),
             "attention_mask": jnp.ones((bs, 16), jnp.int32),
             "labels": jnp.asarray(ids, jnp.int32)}
    batch = {k: jax.device_put(v, batch_sharding) for k, v in batch.items()}
    _, _, loss = step(params, opt_state, batch)

    serve = jax_shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    cache = jax.device_put(jax_serving.init_kv_cache(config, bs, 32), NamedSharding(
        mesh, P(None, None, ("dcn", "data"), "model", None, None)))
    ids = jax.device_put(jnp.asarray(rng.integers(0, 128, size=(bs, 8)), jnp.int32),
                         batch_sharding)
    logits, cache, lengths = jax.jit(lambda p, i, m, c: jax_serving.prefill_into_cache(
        p, i, m, c, config, True))(serve, ids, jnp.ones_like(ids), cache)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    logits2, _ = jax.jit(lambda p, t, c, pos: jax_serving.decode_step(p, t, c, pos, config, True))(
        serve, tok, cache, lengths)
    return float(loss), np.asarray(logits2), tree


def test_bfp6_is_jax_s():
    assert graft_entry.BFP6 == jax_graft.BFP6


def test_entry_forward_matches_jax():
    """The port's forward on JAX's parameters and ids: JAX's jitted logits."""
    jfn, (jparams, jids, jmask) = jax_graft.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jids, jmask))
    fn, (params, ids, mask) = graft_entry.entry(device="cpu")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    got = fn(params_from_jax(_np(jparams), device="cpu"), ids, mask)
    assert got.shape == want.shape == (2, 64, 256) and got.dtype == torch.float32
    close_to_max(got.numpy(), want)


def test_entry_runs_the_fake_quant_forward_on_float_params():
    """As the JAX script's code (not its docstring): unpacked float32
    weights, quantized in the forward; its own parameters give finite
    logits of the same shape."""
    fn, (params, ids, mask) = graft_entry.entry(device="cpu")
    q = params["layers"][0]["self_attn"]["q_proj"]["weight"]
    assert isinstance(q, torch.Tensor) and q.dtype == torch.float32 and q.shape == (256, 256)
    out = fn(params, ids, mask)
    assert out.shape == (2, 64, 256) and torch.isfinite(out).all()


def test_dryrun_helper_matches_jax_on_one_process():
    """``_dryrun`` on the trivial hybrid mesh, fed JAX's trees: JAX's QAT
    loss and decode logits."""
    want_loss, want_logits, tree = jax_dryrun(1, 1)
    mesh = port_hybrid_mesh(dcn=1, data=1, model=1, device_type="cpu")
    loss, logits = graft_entry._dryrun(mesh, params_from_jax(tree, device="cpu"),
                                       params_from_jax(tree, device="cpu"), "cpu")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert logits.shape == want_logits.shape == (2, 128)
    close_to_max(logits.numpy(), want_logits)


def test_dryrun_multichip_on_one_process():
    graft_entry.dryrun_multichip(1, device="cpu")


def test_dryrun_multichip_refuses_another_world():
    with pytest.raises(ValueError, match="needs a world of 2 ranks, this one has 1"):
        graft_entry.dryrun_multichip(2, device="cpu")


def test_module_runs_as_the_jax_script_s_main():
    out = subprocess.run([sys.executable, "-m", "llm_mixed_q_torch.graft_entry", "--device",
                          "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["entry forward: (2, 64, 256) torch.float32",
                                       "dryrun_multichip ok"]
