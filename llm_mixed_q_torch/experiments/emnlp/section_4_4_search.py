"""Section 4.4 (search): the mixed-precision BFP search on SST-2
(counterpart of the JAX package's ``experiments/emnlp/section_4_4_search.py``).

The reference protocol (opt_1.3b_sst2.sh): OPT-1.3B, TPE, 128 trials, 256
eval samples a trial, alpha_accuracy 1 / alpha_memory_density 0.1,
thresholds acc >= 0.80 and avg_bitwidth <= 5; the search space is
configs/search/opt_1.3b_sst2.toml. This runs
``SearchQuantisationForClassification`` end to end and leaves the
reference's artifacts in save_dir (search_log.csv, study.pkl, results.csv,
best_trials/*.toml), then evaluates the winners (search_summary.json).

CI scale:    python -m llm_mixed_q_torch.experiments.emnlp.section_4_4_search \\
                 --synthetic --save_dir out/ [--device cpu]
Paper scale: ... --model_arch opt --model_name <opt-1.3b ckpt> \\
                 --search_config configs/search/opt_1.3b_sst2.toml
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .common import REPO, add_driver_args, build, write_json


def main(argv=None):
    parser = argparse.ArgumentParser("section_4.4 mixed-precision search")
    add_driver_args(parser)
    parser.add_argument("--search_config",
                        default=str(REPO / "configs" / "search" / "opt_1.3b_sst2.toml"))
    parser.add_argument("--task", default="sst2")
    parser.add_argument("--n_trials", type=int, default=None)
    parser.add_argument("--samples_per_trial", type=int, default=None)
    args = parser.parse_args(argv)
    seq_len = args.seq_len or (32 if args.synthetic else 128)
    batch_size = args.batch_size or (4 if args.synthetic else 16)

    from ...datasets import (get_raw_dataset_dict, make_synthetic_cls_dataset, numpy_dataloader,
                             preprocess_dataset_dict)
    from ...search import SearchQuantisationForClassification
    from ...utils.toml_io import load_config

    search_config = load_config(args.search_config)
    if args.n_trials is not None:
        search_config["search_strategy"]["n_trials"] = args.n_trials
    if args.synthetic:
        search_config["search_strategy"].setdefault("n_trials", 128)
        if args.n_trials is None:
            search_config["search_strategy"]["n_trials"] = 4
        # CI thresholds: a random-init model does not reach 0.80 accuracy
        search_config["search_strategy"]["accuracy_threshold"] = 0.0
        search_config["search_strategy"]["avg_bitwidth_threshold"] = 0.0
    samples = args.samples_per_trial or (8 if args.synthetic else 256)

    config, params = build(args, "cls", None)
    if args.synthetic:
        eval_ds = make_synthetic_cls_dataset(256, seq_len, 16, seed=1)

        def loader():
            return numpy_dataloader(eval_ds, batch_size=batch_size)
    else:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_name)
        raw = get_raw_dataset_dict(args.task)
        ds = preprocess_dataset_dict(raw, args.task, tokenizer, "max_length", seq_len)

        def loader():
            return numpy_dataloader(ds["validation"], batch_size=batch_size)

    search = SearchQuantisationForClassification(
        args.model_arch, args.model_name or f"synthetic-{args.model_arch}", search_config,
        args.save_dir, params,
        model_config_kwargs=(
            None if args.model_name and not args.synthetic
            else {k: v for k, v in vars(config).items()
                  if k in ("vocab_size", "hidden_size", "intermediate_size", "ffn_dim",
                           "num_hidden_layers", "num_attention_heads",
                           "max_position_embeddings", "num_labels")}))
    study = search.search(loader, args.task, is_regression=False, seq_len=seq_len,
                          num_samples_per_trial=samples)
    search.save_study_and_results(study)
    best = search.evaluate_best_trials(study, loader, args.task, is_regression=False)
    write_json(args.save_dir, "search_summary.json", {
        "protocol": "opt_1.3b_sst2.sh (TPE mixed-precision BFP search)",
        "n_trials": len(study.trials),
        "pareto_size": len(study.best_trials),
        "best": best,
    })
    for artifact in ("search_log.csv", "study.pkl", "results.csv"):
        if not (Path(args.save_dir) / artifact).exists():
            raise RuntimeError(f"the search left no {artifact}")
    return study


if __name__ == "__main__":
    main()
