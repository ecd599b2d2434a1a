"""Shared plumbing of the EMNLP reproduction drivers (counterpart of the
JAX package's ``experiments/emnlp/_common.py``).

The drivers bind the port's entry points into the paper's protocols, with
the JAX drivers' arguments, artifact names, CSV headers and JSON keys, and
``--device`` (the card unless "cpu"). ``--synthetic`` runs the same
protocol on a randomly initialized tiny model and synthetic data (no
checkpoint, dataset or network needed); a local checkpoint directory in
``--model_name`` runs it at the paper's scale.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
CONFIGS = REPO / "configs" / "quantization"


def add_driver_args(parser: argparse.ArgumentParser):
    parser.add_argument("--model_name", default=None,
                        help="local HF checkpoint dir; omit with --synthetic")
    parser.add_argument("--model_arch", default="opt", choices=["bert", "llama", "opt"])
    parser.add_argument("--synthetic", action="store_true",
                        help="random-init tiny model + synthetic data (CI scale)")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--seq_len", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def tiny_config_kwargs(arch: str) -> dict:
    """CI-scale model shape per arch (synthetic mode)."""
    base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=128 if arch == "bert" else 256)
    if arch == "opt":
        base["ffn_dim"] = 128
    else:
        base["intermediate_size"] = 128
    return base


def build_synthetic(arch: str, task: str, quant_config, num_labels: int = 2, device=None):
    """(config, params) of a random-init tiny model on ``device``."""
    from ...models import get_config_cls, hf_loader

    kwargs = tiny_config_kwargs(arch)
    if task == "cls":
        kwargs["num_labels"] = num_labels
    config = get_config_cls(arch)(**kwargs, quant_config=quant_config)
    init = getattr(hf_loader, f"init_{arch}_params")
    return config, init(config, task=task, seed=0, device=device)


def build_from_checkpoint(arch: str, task: str, model_name: str, quant_config,
                          num_labels: int = 2, device=None):
    from ...models import get_config_cls, get_params_loader
    from ...models.hf_loader import load_flat_state_dict

    kwargs = {"num_labels": num_labels} if task == "cls" else {}
    config = get_config_cls(arch).from_pretrained(model_name, quant_config=quant_config, **kwargs)
    params = get_params_loader(arch)(load_flat_state_dict(model_name), config, task=task,
                                     device=device)
    return config, params


def build(args, task: str, quant_config, num_labels: int = 2):
    if args.synthetic or args.model_name is None:
        return build_synthetic(args.model_arch, task, quant_config, num_labels, args.device)
    return build_from_checkpoint(args.model_arch, task, args.model_name, quant_config,
                                 num_labels, args.device)


def write_json(save_dir, name: str, payload: dict):
    out = Path(save_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / name
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    print(f"wrote {path}")
    return path
