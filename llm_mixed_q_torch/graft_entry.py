"""Driver entry points of the port (counterpart of the repo's
``__graft_entry__.py``).

- ``entry(device=None)``: the flagship model's forward and its arguments: a
  2-layer Llama at hidden 256 under W6A6 block_fp (``BFP6``), its weights
  fake-quantized in the forward (``quantize_weights=True``) on unpacked
  float32 parameters, as the JAX script's code runs it;
- ``dryrun_multichip(n_devices, device=None)``: on every rank of a world of
  ``n_devices`` ranks, one QAT step over the (dcn, data, model) hybrid
  mesh with DP x TP shardings (model = 2 where ``n_devices`` is even), then
  a TP-sharded prefill of 8 tokens into a float32 KV cache of 32 positions
  and one decode step, on tiny shapes; asserts a finite loss and finite
  logits.

    python -m llm_mixed_q_torch.graft_entry [--device cpu]
    torchrun --nproc_per_node N -m llm_mixed_q_torch.graft_entry [--device cpu]

One process runs ``dryrun_multichip(1)``; under torchrun each rank runs
``dryrun_multichip(world)``. The entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .models.hf_loader import init_llama_params
from .models.llama import LlamaQuantizedConfig, llama_for_causal_lm
from .models.llama.serving import decode_step, init_kv_cache, prefill_into_cache
from .parallel import global_batch, initialize, shard_params, tp
from .parallel.distributed import make_hybrid_mesh
from .train.qat import _optax_adamw, leaves_of, make_qat_train_step, shard_for_training

BFP6 = {
    "default": {
        "name": "block_fp",
        "bypass": False,
        "is_ptq": True,
        "bias_block_size": [16],
        "bias_exponent_bias": 127,
        "bias_exponent_width": 8,
        "bias_width": 6,
        "data_in_block_size": [1, 16],
        "data_in_exponent_bias": 127,
        "data_in_exponent_width": 8,
        "data_in_width": 6,
        "weight_block_size": [1, 16],
        "weight_exponent_bias": 127,
        "weight_exponent_width": 8,
        "weight_width": 6,
    },
    "rotary_positional_encoding": {
        "bypass": False,
        "name": "integer",
        "data_in_width": 8,
        "data_in_frac_width": 7,
    },
}
# the dry run's model (the JAX script's ``dryrun_multichip``)
_DRYRUN_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128)


def entry(device=None):
    """(forward, (params, input_ids, attention_mask)): the quantized-Llama
    forward step -> logits [2, 64, 256]."""
    device = resolve_device(device)
    config = LlamaQuantizedConfig(
        vocab_size=256,
        hidden_size=256,
        intermediate_size=704,
        num_hidden_layers=2,
        num_attention_heads=4,
        max_position_embeddings=512,
        quant_config=BFP6,
    )
    params = init_llama_params(config, task="lm", seed=0, device=device)

    @torch.no_grad()
    def forward(params, input_ids, attention_mask):
        return llama_for_causal_lm(params, input_ids, attention_mask, config=config,
                                   quantize_weights=True)["logits"]

    rng = np.random.default_rng(0)
    input_ids = torch.as_tensor(rng.integers(0, 256, size=(2, 64)), dtype=torch.int64,
                                device=device)
    return forward, (params, input_ids, torch.ones_like(input_ids))


def _dryrun_config() -> LlamaQuantizedConfig:
    return LlamaQuantizedConfig(**_DRYRUN_KW, quant_config=BFP6)


def _dryrun(mesh, params, serve_params, device=None):
    """The dry run's work on ``mesh`` from two whole parameter trees (the
    trained one and the served one; ``dryrun_multichip`` draws both from
    seed 0) -> (the QAT step's loss, this rank's decode-step logits [b, vocab],
    b its rows of the batch). ``shard_params`` without FSDP, optax's
    ``adamw(1e-4)``, ``make_qat_train_step`` on a batch of max(2, 2 x data)
    x 16 tokens through ``global_batch``; then the prefill of 8 tokens into
    a float32 cache of 32 positions and one decode step, TP-sharded."""
    device = resolve_device(device)
    config = _dryrun_config()
    data = mesh.shape.get("dcn", 1) * mesh.shape.get("data", 1)
    tree = shard_for_training(params, mesh, fsdp=False, config=config)  # DP x TP
    optimizer = _optax_adamw(leaves_of(tree), 1e-4)
    step = make_qat_train_step("llama", "lm", config, optimizer, mesh)

    rng = np.random.default_rng(0)
    bs = max(2, 2 * data)
    ids = rng.integers(0, 128, size=(bs, 16))
    rows, _ = global_batch(mesh, {"input_ids": ids, "attention_mask": np.ones((bs, 16)),
                                  "labels": ids})
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device) for k, v in rows.items()}
    loss = float(step(tree, batch))

    serve = shard_params(serve_params, mesh, config=config)
    b, max_len = bs, 32
    prompt, _ = global_batch(mesh, {"ids": rng.integers(0, 128, size=(b, 8))})
    ids = torch.as_tensor(prompt["ids"], dtype=torch.int64, device=device)
    with torch.no_grad(), tp.spmd(mesh):
        cache = init_kv_cache(config, ids.shape[0], max_len, device=device)
        logits, lengths = prefill_into_cache(serve, ids, torch.ones_like(ids), cache, config,
                                             True)
        tok = logits.argmax(-1)[:, None]
        logits2 = decode_step(serve, tok, cache, lengths, config, True)
    return loss, logits2


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One QAT step and one TP-sharded prefill + decode step over an
    ``n_devices``-rank hybrid (dcn, data, model) mesh, run on every rank of
    a world of ``n_devices`` ranks (raises ValueError where the world
    differs). Asserts a finite loss and finite logits."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a world of {n_devices} ranks, "
                         f"this one has {world}")
    device = resolve_device(device)
    model_axis = 2 if n_devices % 2 == 0 else 1
    data_axis = n_devices // model_axis
    mesh = make_hybrid_mesh(dcn=1, data=data_axis, model=model_axis,
                            device_type=device.type)
    config = _dryrun_config()
    params = init_llama_params(config, task="lm", seed=0, device=device)
    serve_params = init_llama_params(config, task="lm", seed=0, device=device)
    loss, logits = _dryrun(mesh, params, serve_params, device)
    assert np.isfinite(loss), f"non-finite loss: {loss}"
    assert torch.isfinite(logits).all(), "non-finite serve logits"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    world = initialize()
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype)
    dryrun_multichip(world, args.device)
    print("dryrun_multichip ok")


if __name__ == "__main__":
    main()
