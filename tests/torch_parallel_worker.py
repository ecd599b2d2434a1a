"""One rank of the 4-rank gloo world of ``tests/test_torch_parallel_world.py``
(a data = 2 x model = 2 mesh on the CPU, one intra-op thread a rank; then
``graft_entry.dryrun_multichip(4)`` on the (1, 2, 2) hybrid mesh; last, two
simulated hosts of 2 ranks on hybrid meshes).

Imports torch and the port only, never JAX: the test process prepares the
inputs (the JAX package's trees as numpy, the batches) in
``<workdir>/inputs.pkl``, and each rank writes its results as numpy to
``<workdir>/rank<r>.pkl``. Run as

    python tests/torch_parallel_worker.py <rank> <world> <port> <workdir>
"""

from __future__ import annotations

import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from llm_mixed_q_torch.models.hf_loader import params_from_jax  # noqa: E402
from llm_mixed_q_torch.models.llama import (  # noqa: E402
    LlamaQuantizedConfig,
    decode_step,
    generate,
    prefill_into_cache,
)
from llm_mixed_q_torch.models.llama.modeling import llama_for_causal_lm  # noqa: E402
from llm_mixed_q_torch.models.llama.serving import _new_cache, kv_cache_pack_spec  # noqa: E402
from llm_mixed_q_torch.parallel import global_batch, make_mesh, shard_params  # noqa: E402
from llm_mixed_q_torch.parallel.distributed import (  # noqa: E402
    _global_batch_slice,
    initialize,
    make_hybrid_mesh,
)
from llm_mixed_q_torch.parallel import tp  # noqa: E402
from llm_mixed_q_torch.train.qat import (  # noqa: E402
    MeshLayout,
    MultiSteps,
    leaves_of,
    make_adamw,
    make_qat_train_step,
    named_leaves,
    shard_for_training,
    train_qat,
    whole_params,
)


def _config(kw, quant):
    return LlamaQuantizedConfig(**kw, quant_config=quant)


def _local_tree(np_tree, mesh, config):
    return shard_params(params_from_jax(np_tree, device="cpu"), mesh, config=config)


def _slice(mesh, **arrays):
    local, _ = global_batch(mesh, arrays)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in local.items()}


def forward(mesh, inp):
    """The TP fake-quant forward's logits of this rank's batch slice, per
    arithmetic."""
    out = {}
    for arith, quant in inp["fwd_quants"].items():
        config = _config(inp["kw"], quant)
        local = _local_tree(inp["float_tree"], mesh, config)
        ids = _slice(mesh, ids=inp["ids"])["ids"]
        with torch.no_grad(), tp.spmd(mesh):
            out[arith] = llama_for_causal_lm(local, ids, None, config=config)["logits"].numpy()
    return out


def family_forward(mesh, inp):
    """The TP fake-quant forward of OPT (lm) and BERT (cls) on this rank's
    batch slice."""
    from llm_mixed_q_torch.models import get_config_cls
    from llm_mixed_q_torch.models.api import make_forward

    out = {}
    for arch, (task, kw, np_tree) in inp["families"].items():
        config = get_config_cls(arch)(**kw, quant_config=inp["serve_quant"])
        local = _local_tree(np_tree, mesh, config)
        ids = _slice(mesh, ids=inp["ids"])["ids"]
        with torch.no_grad(), tp.spmd(mesh):
            out[arch] = make_forward(arch, task, config)(local, ids,
                                                         torch.ones_like(ids))["logits"].numpy()
    return out


def serve(mesh, inp):
    """Per packed tree: greedy tokens of ``generate`` and one decode step's
    logits on a kv-head-sharded packed cache after a prefill, for this
    rank's prompts; and the local cache's layout."""
    out = {}
    for name, (kw, np_tree) in inp["packed_trees"].items():
        config = _config(kw, inp["serve_quant"])
        local = _local_tree(np_tree, mesh, config)
        prompt = _slice(mesh, ids=inp["prompt"])["ids"]
        with torch.no_grad(), tp.spmd(mesh):
            tokens = generate(local, config, prompt, max_new_tokens=inp["new"], device="cpu")
            cache = _new_cache(config, prompt.shape[0], inp["max_len"],
                               kv_cache_pack_spec(config), torch.device("cpu"))
            logits, lengths = prefill_into_cache(local, prompt, torch.ones_like(prompt), cache,
                                                 config)
            tok = logits.argmax(-1)[:, None]
            step = decode_step(local, tok, cache, lengths, config)
        out[name] = {"tokens": np.asarray(tokens), "step": step.numpy(),
                     "kv_heads": cache.nkv, "pos_major": cache.pos_major}
    from llm_mixed_q_torch.models import get_config_cls
    from llm_mixed_q_torch.models.opt import opt_generate_greedy

    kw, np_tree = inp["opt_int8"]
    config = get_config_cls("opt")(**kw, quant_config=inp["serve_quant"])
    local = _local_tree(np_tree, mesh, config)
    with torch.no_grad(), tp.spmd(mesh):
        out["opt_int8"] = {"tokens": np.asarray(opt_generate_greedy(
            local, config, prompt, max_new_tokens=inp["new"], device="cpu"))}
    return out


def _qat_step(mesh, inp, fsdp, arrays, task):
    """One QAT step on this rank's part of ``arrays``, the global batch on
    one host, the host's local batch on several."""
    config = _config(inp["qat_kw"], inp["qat_quant"])
    tree = shard_for_training(params_from_jax(inp["qat_trees"][task], device="cpu"), mesh,
                              fsdp, config)
    local = leaves_of(tree)
    # two micro-steps an update on the same batch: the first leaves the
    # step's gradients (averaged over the mesh), the second updates with
    # their mean, the same gradients
    optimizer = MultiSteps(*make_adamw(local, inp["lr"], inp["wd"]), every_k=2)
    step = make_qat_train_step("llama", task, config, optimizer, mesh, fsdp)
    batch = _slice(mesh, **arrays)
    layout = MeshLayout(mesh, fsdp)
    loss = step(tree, batch)
    grads = {"/" + "/".join(map(str, p)): layout.full(t.grad, layout.spec(p, t)).numpy()
             for p, t in named_leaves(local)}
    step(tree, batch)
    full = whole_params(layout, local)
    flat = {"/" + "/".join(map(str, p)): t.numpy() for p, t in named_leaves(full)}
    mine = dist.get_rank() == 0
    return {"loss": float(loss), "params": flat if mine else None,
            "grads": grads if mine else None}


def qat(mesh, inp):
    """One QAT step of the cls model under DP x TP, without and with fsdp,
    and of the LM on a batch whose data slices hold unequal token counts."""
    return {"dp_tp": _qat_step(mesh, inp, False, inp["cls_batch"], "cls"),
            "fsdp": _qat_step(mesh, inp, True, inp["cls_batch"], "cls"),
            "lm_unequal": _qat_step(mesh, inp, False, inp["lm_batch"], "lm")}


def checkpoint(mesh, inp, workdir):
    """``train_qat`` on the mesh for 2 steps with a checkpoint a step, then
    1 step and a resume of the second from the first's checkpoint."""
    config = _config(inp["qat_kw"], inp["qat_quant"])
    tree = params_from_jax(inp["qat_trees"]["cls"], device="cpu")
    batches = inp["ckpt_batches"]
    kw = dict(learning_rate=inp["lr"], weight_decay=inp["wd"], mesh=mesh, fsdp=True,
              steps_per_epoch=len(batches), save_every_steps=1, schedule="cosine")

    def factory(start=0):
        return iter(batches[start:])

    full, hist = train_qat("llama", "cls", config, tree, factory,
                           checkpoint_dir=str(workdir / "ckpt_full"), **kw)
    train_qat("llama", "cls", config, tree, lambda start=0: iter(batches[start:1]),
              checkpoint_dir=str(workdir / "ckpt_cut"), **kw)
    resumed, _ = train_qat("llama", "cls", config, tree, factory,
                           checkpoint_dir=str(workdir / "ckpt_cut"), resume=True, **kw)
    flat = lambda t: {"/" + "/".join(map(str, p)): v.numpy() for p, v in named_leaves(t)}
    return {"full": flat(full), "resumed": flat(resumed), "loss": hist[0]["loss"]}


def _host_local(mesh, batch):
    """This rank's host's rows of a global batch: its local batch."""
    host, hosts = mesh.host
    return {k: v[host * len(v) // hosts:(host + 1) * len(v) // hosts] for k, v in batch.items()}


def two_hosts(inp):
    """Two hosts of 2 ranks (``initialize(local_device_count=2)``: the world
    is up, so it records the host size only), on the hybrid meshes
    (dcn, data, model) = (2, 2, 1) and (2, 1, 2): this rank's rows of
    ``global_batch`` from its host's local batch, and of the global slice of
    that local batch (the contract before fault 19's repair); one QAT step
    from host-local batches, DP on both meshes and FSDP on (2, 2, 1)."""
    initialize(local_device_count=2)
    out = {}
    for shape in ((2, 2, 1), (2, 1, 2)):
        mesh = make_hybrid_mesh(*shape, device_type="cpu")
        local = _host_local(mesh, {"rows": inp["host_rows"]})
        name = "x".join(map(str, shape))
        rows, shapes = global_batch(mesh, local)
        out[name] = {"coords": mesh.coords, "host": mesh.host, "rows": rows["rows"],
                     "global_shape": shapes["rows"],
                     "old_rows": _global_batch_slice(mesh, local)["rows"],
                     "dp": _qat_step(mesh, inp, False, _host_local(mesh, inp["cls_batch"]), "cls")}
        if shape[1] > 1:
            out[name]["fsdp"] = _qat_step(mesh, inp, True, _host_local(mesh, inp["cls_batch"]),
                                          "cls")
    return out


def graft(inp):
    """``dryrun_multichip(4)`` on the world (its own init), then its helper
    on the (1, 2, 2) hybrid mesh from JAX's tree: the QAT loss and this
    rank's decode logits."""
    from llm_mixed_q_torch import graft_entry

    graft_entry.dryrun_multichip(dist.get_world_size(), device="cpu")
    mesh = make_hybrid_mesh(1, 2, 2, device_type="cpu")
    tree = lambda: params_from_jax(inp["graft_tree"], device="cpu")
    loss, logits = graft_entry._dryrun(mesh, tree(), tree(), "cpu")
    return {"coords": mesh.coords, "loss": loss, "logits": logits.numpy()}


def main(rank: int, world: int, port: int, workdir: Path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(data=2, model=2, device_type="cpu")
        with open(workdir / "inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        out = {"coords": mesh.coords, "forward": forward(mesh, inp),
               "families": family_forward(mesh, inp), "serve": serve(mesh, inp),
               "qat": qat(mesh, inp), "checkpoint": checkpoint(mesh, inp, workdir),
               "graft": graft(inp),
               "hosts": two_hosts(inp)}  # last: it sets the host size for the process
    except Exception:
        out = {"error": traceback.format_exc()}
    with open(workdir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
