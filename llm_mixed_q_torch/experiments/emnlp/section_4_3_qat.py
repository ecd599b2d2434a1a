"""Section 4.3 (QAT): the W4A4 BFP quantization-aware fine-tune on SST-2
(counterpart of the JAX package's ``experiments/emnlp/section_4_3_qat.py``).

The reference protocol (opt_350m_sst2.sh): OPT-350M, W4A4 BFP, batch 16,
lr 2e-5, 4 epochs, a cosine schedule, grad-accum 4, checkpoints every half
epoch, eval each epoch, through ``train.train_qat``; it writes
qat_history.json and the checkpoints under ``<save_dir>/checkpoints``.
Under ``torchrun`` (``parallel.distributed.initialize``) it trains on a data
mesh of every rank, each on its slice of a global batch of
``--batch_size`` (DP; ``--fsdp`` shards the 2-D weights over the ranks
with ``fully_shard``), rank 0 writing.

CI scale:    python -m llm_mixed_q_torch.experiments.emnlp.section_4_3_qat \\
                 --synthetic --save_dir out/ [--device cpu]
Two ranks:   torchrun --nproc_per_node 2 -m llm_mixed_q_torch.experiments.emnlp.section_4_3_qat \\
                 --synthetic --save_dir out/
Paper scale: ... --model_arch opt --model_name <opt-350m ckpt> --task sst2
"""

from __future__ import annotations

import argparse

from .common import CONFIGS, add_driver_args, build, write_json


def main(argv=None):
    parser = argparse.ArgumentParser("section_4.3 W4A4 QAT fine-tune")
    add_driver_args(parser)
    parser.add_argument("--task", default="sst2")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--grad_accum", type=int, default=4)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--fsdp", action="store_true",
                        help="on a mesh of several ranks, shard the 2-D weights (fully_shard)")
    args = parser.parse_args(argv)
    epochs = args.epochs or (1 if args.synthetic else 4)
    batch_size = args.batch_size or (4 if args.synthetic else 16)
    seq_len = args.seq_len or (32 if args.synthetic else 128)

    import torch.distributed as dist

    from ...datasets import (get_raw_dataset_dict, make_synthetic_cls_dataset, numpy_dataloader,
                             preprocess_dataset_dict)
    from ...eval.eval_cls import eval_cls_glue
    from ...models.api import make_forward
    from ...parallel import initialize, make_mesh
    from ...train import train_qat
    from ...utils.toml_io import load_config

    world = initialize()
    mesh = make_mesh(data=world) if world > 1 else None
    qc = load_config(CONFIGS / "bfp_4bit.toml")
    config, params = build(args, "cls", qc)

    if args.synthetic:
        train_ds = make_synthetic_cls_dataset(256, seq_len, 32, seed=0)
        eval_ds = make_synthetic_cls_dataset(256, seq_len, 16, seed=1)
        steps_per_epoch = 32 // batch_size
    else:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_name)
        raw = get_raw_dataset_dict(args.task)
        ds = preprocess_dataset_dict(raw, args.task, tokenizer, "max_length", seq_len)
        train_ds, eval_ds = ds["train"], ds["validation"]
        steps_per_epoch = len(train_ds) // batch_size

    def train_batches():
        return numpy_dataloader(train_ds, batch_size=batch_size, shuffle=True, drop_last=True)

    eval_fwd = make_forward(args.model_arch, "cls", config, quantize_weights=True)

    def eval_fn(p):
        return eval_cls_glue(eval_fwd, p, args.task,
                             numpy_dataloader(eval_ds, batch_size=batch_size),
                             is_regression=False)

    params, history = train_qat(
        args.model_arch, "cls", config, params, train_batches, eval_fn=eval_fn,
        num_epochs=epochs, learning_rate=args.lr, grad_accum_steps=args.grad_accum,
        schedule="cosine", steps_per_epoch=steps_per_epoch,
        checkpoint_dir=f"{args.save_dir}/checkpoints",
        save_every_steps=max(steps_per_epoch // 2, 1), resume=args.resume,
        mesh=mesh, fsdp=args.fsdp)
    if mesh is None or dist.get_rank() == 0:
        write_json(args.save_dir, "qat_history.json",
                   {"protocol": "opt_350m_sst2.sh (W4A4 BFP QAT)", "epochs": epochs,
                    "history": history})
    return history


if __name__ == "__main__":
    main()
