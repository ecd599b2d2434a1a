"""Shared CLI plumbing (counterpart of the JAX package's ``cli/common.py``):
config, parameter tree and forward from the arguments."""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from ..models import get_config_cls, get_params_loader, get_params_packer, get_ptq_preparer
from ..models.api import make_forward
from ..models.hf_loader import load_flat_state_dict
from ..utils import set_logging_verbosity

logger = logging.getLogger(__name__)


def add_common_model_args(parser: argparse.ArgumentParser):
    parser.add_argument("--model_arch", required=True, choices=["bert", "llama", "opt"])
    parser.add_argument("--model_name", required=True,
                        help="local HF checkpoint dir (config.json + safetensors/bin)")
    parser.add_argument("--quant_config", default=None, help="quant config TOML")
    parser.add_argument("--save_dir", default=None)
    parser.add_argument("--num_labels", type=int, default=2)
    parser.add_argument("--seq_len", "--max_length", type=int, default=128, dest="max_length")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--packed", action="store_true",
                        help="serve block_fp weights packed through bfp_matmul (the arch's "
                             "packer: int8 codes for llama, sub-byte words for opt and bert)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the parameters and the forward (cpu to run "
                             "without a card)")


def build_model(args, task: str):
    """(config, params, forward_fn) from CLI args: weights PTQ-prepared
    once, or packed with ``--packed``; the forward runs with
    ``quantize_weights=False``. The ``cls`` task takes ``--num_labels``."""
    set_logging_verbosity("info")
    config = get_config_cls(args.model_arch).from_pretrained(
        args.model_name, quant_config=args.quant_config,
        **({"num_labels": args.num_labels} if task == "cls" else {}))
    flat = load_flat_state_dict(args.model_name)
    params = get_params_loader(args.model_arch)(flat, config, task=task, device=args.device)
    if config.quant_config is not None:
        if args.packed:
            params = get_params_packer(args.model_arch)(params, config, device=args.device)
        else:
            params = get_ptq_preparer(args.model_arch)(params, config)
    fwd = make_forward(args.model_arch, task, config, quantize_weights=False,
                       with_labels=(task == "lm"))
    return config, params, fwd


def get_tokenizer(args):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(args.model_name)


def save_results(args, results: dict, name: str):
    print(json.dumps(results, indent=2, default=str))
    if args.save_dir:
        out = Path(args.save_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / f"{name}.json", "w") as f:
            json.dump(results, f, indent=2, default=str)
        logger.info(f"saved {out / f'{name}.json'}")
