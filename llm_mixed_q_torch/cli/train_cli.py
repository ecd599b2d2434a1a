"""QAT fine-tune CLIs (counterpart of the JAX package's
``cli/train_cli.py``): ``dp_train_runner``, ``fsdp_train_runner`` and
their reference alias ``ddp_train_runner``.

The JAX package builds a data mesh over every device it sees when there
is more than one. The port does the same over the ranks of a ``torchrun``
launch (``parallel.distributed.initialize``: one process a rank, NCCL when
each has a card of its own, else gloo): ``make_mesh(data=WORLD_SIZE)``,
each rank training on its slice of every global batch of
``--batch_size``, the gradients averaged over the ranks (DP), and under
``fsdp_train_runner`` the 2-D weights and their optimizer state sharded
over them by ``torch.distributed.fsdp.fully_shard``. A single process trains on ``--device`` alone
(``fsdp`` then changes nothing, as in the JAX package). Rank 0 writes the
checkpoints and the results. For example, two ranks:

    torchrun --nproc_per_node 2 -m llm_mixed_q_torch.cli.train_cli fsdp \
        --model_arch opt --model_name <dir> --task sst2 \
        --quant_config configs/quantization/bfp_4bit.toml --batch_size 16
"""

from __future__ import annotations

import argparse
from functools import partial

import torch.distributed as dist

from ..datasets import get_raw_dataset_dict, numpy_dataloader, preprocess_dataset_dict
from ..datasets.glue import is_regression_task
from ..eval import eval_cls_glue
from ..models import get_config_cls, get_params_loader
from ..models.api import make_forward
from ..models.hf_loader import load_flat_state_dict
from ..parallel import initialize, make_mesh
from ..train import train_qat
from .common import add_common_model_args, get_tokenizer, save_results


def _train(args, fsdp: bool):
    world = initialize()
    mesh = make_mesh(data=world) if world > 1 else None
    config = get_config_cls(args.model_arch).from_pretrained(
        args.model_name, quant_config=args.quant_config, num_labels=args.num_labels)
    flat = load_flat_state_dict(args.model_name)
    params = get_params_loader(args.model_arch)(flat, config, task="cls", device=args.device)
    tokenizer = get_tokenizer(args)
    raw = get_raw_dataset_dict(args.task)
    ds = preprocess_dataset_dict(raw, args.task, tokenizer, "max_length", args.max_length)
    train_factory = partial(numpy_dataloader, ds["train"], batch_size=args.batch_size,
                            shuffle=True, drop_last=True)
    eval_fwd = make_forward(args.model_arch, "cls", config, quantize_weights=True)

    def eval_fn(p):
        out = eval_cls_glue(eval_fwd, p, args.task,
                            numpy_dataloader(ds["validation"], batch_size=args.batch_size),
                            is_regression=is_regression_task(args.task))
        if args.task == "mnli":
            # the mismatched split too (the reference's mnli-mm pass)
            mm = eval_cls_glue(eval_fwd, p, args.task,
                               numpy_dataloader(ds["validation_mismatched"],
                                                batch_size=args.batch_size),
                               is_regression=False)
            out.update({f"{k}_mm": v for k, v in mm.items()})
        return out

    params, history = train_qat(
        args.model_arch, "cls", config, params, train_factory, eval_fn=eval_fn,
        num_epochs=args.num_train_epochs, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, grad_accum_steps=args.gradient_accumulation_steps,
        schedule=args.lr_scheduler_type, warmup_steps=args.num_warmup_steps,
        checkpoint_dir=args.checkpoint_dir, save_every_steps=args.checkpointing_steps,
        resume=args.resume_from_checkpoint, mesh=mesh, fsdp=fsdp,
        steps_per_epoch=len(ds["train"]) // args.batch_size)
    if mesh is None or dist.get_rank() == 0:
        save_results(args, {"history": history}, "train_history")
    return params, history


def _add_train_args(parser):
    add_common_model_args(parser)
    parser.add_argument("--task", required=True)
    parser.add_argument("--num_train_epochs", type=int, default=4)
    parser.add_argument("--learning_rate", type=float, default=2e-5)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--lr_scheduler_type", default="cosine")
    parser.add_argument("--num_warmup_steps", type=int, default=0)
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--checkpointing_steps", type=int, default=None)
    parser.add_argument("--resume_from_checkpoint", action="store_true")


def dp_train_runner(argv=None):
    parser = argparse.ArgumentParser("dp_train_runner")
    _add_train_args(parser)
    return _train(parser.parse_args(argv), fsdp=False)


def fsdp_train_runner(argv=None):
    parser = argparse.ArgumentParser("fsdp_train_runner")
    _add_train_args(parser)
    return _train(parser.parse_args(argv), fsdp=True)


ddp_train_runner = dp_train_runner  # the reference's name


if __name__ == "__main__":  # python -m llm_mixed_q_torch.cli.train_cli {dp,fsdp} <args>
    import sys

    {"dp": dp_train_runner, "fsdp": fsdp_train_runner}[sys.argv[1]](sys.argv[2:])
