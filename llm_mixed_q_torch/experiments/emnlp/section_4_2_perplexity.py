"""Section 4.2 (perplexity): Wikitext2 perplexity across the quantization
arithmetics (counterpart of the JAX package's
``experiments/emnlp/section_4_2_perplexity.py``).

The reference drives ``cli_eval_lm_wikitext2`` once per TOML (seq_len
2048, batch 1, the test split); this runs the sweep in one process, the
float weights resident and only the quant config changing per arm, and
writes ppl_<arm>.json and perplexity_summary.csv.

CI scale:    python -m llm_mixed_q_torch.experiments.emnlp.section_4_2_perplexity \\
                 --synthetic --save_dir out/ [--device cpu]
Paper scale: ... --model_arch llama --model_name <ckpt> --seq_len 2048 --batch_size 1
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

from .common import CONFIGS, add_driver_args, build, write_json

DEFAULT_ARMS = [
    ("fp32", "bypass.toml"),
    ("w8a8_int", "integer.toml"),
    ("w6a6_bfp", "bfp_6bit.toml"),
    ("w4a4_bfp", "bfp_4bit.toml"),
    ("block_minifloat", "block_minifloat.toml"),
    ("block_log", "block_log.toml"),
    ("minifloat_ieee", "minifloat_ieee.toml"),
]


def main(argv=None):
    parser = argparse.ArgumentParser("section_4.2 perplexity sweep")
    add_driver_args(parser)
    parser.add_argument("--arms", nargs="*", default=None, help="subset of arm names to run")
    args = parser.parse_args(argv)
    seq_len = args.seq_len or (64 if args.synthetic else 2048)
    batch_size = args.batch_size or (4 if args.synthetic else 1)

    from ...datasets import (get_raw_dataset_dict, make_synthetic_lm_dataset, numpy_dataloader,
                             preprocess_dataset_dict)
    from ...eval.eval_lm import eval_lm_wikitext2
    from ...models.api import make_forward
    from ...utils.toml_io import load_config

    arms = [(name, path) for name, path in DEFAULT_ARMS if args.arms is None or name in args.arms]

    def data():
        if args.synthetic:
            return numpy_dataloader(make_synthetic_lm_dataset(256, seq_len, 16),
                                    batch_size=batch_size)
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_name)
        raw = get_raw_dataset_dict("wikitext2")
        ds = preprocess_dataset_dict(raw, "wikitext2", tokenizer, None, seq_len)
        return numpy_dataloader(ds["test"], batch_size=batch_size)

    rows = []
    params = None
    for name, toml in arms:
        qc = None if name == "fp32" else load_config(CONFIGS / toml)
        config, p = build(args, "lm", qc)
        if params is None:
            params = p  # the same weights for every arm
        fwd = make_forward(args.model_arch, "lm", config, quantize_weights=True,
                           with_labels=True)
        res = eval_lm_wikitext2(fwd, params, data(), num_samples=args.num_samples)
        res["arm"] = name
        rows.append(res)
        write_json(args.save_dir, f"ppl_{name}.json", res)
        print(f"{name}: ppl {res['perplexity']:.4f}")

    base = next(r for r in rows if r["arm"] == "fp32")["perplexity"]
    out = Path(args.save_dir) / "perplexity_summary.csv"
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["arm", "perplexity", "delta_vs_fp32"])
        for r in rows:
            w.writerow([r["arm"], r["perplexity"], r["perplexity"] - base])
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
