"""Section 4.2 (downstream): 0-shot prompting accuracy, float against
quantized (counterpart of the JAX package's
``experiments/emnlp/section_4_2_downstream.py``).

The reference drives ``cli_eval_prompting_cls`` (lm-eval, num_fewshot 0);
this sweeps the quant arms over the port's task registry
(``eval/prompting.py``) and writes downstream_<arm>.json and
downstream_summary.csv.

CI scale:    python -m llm_mixed_q_torch.experiments.emnlp.section_4_2_downstream \\
                 --synthetic --save_dir out/ [--device cpu]
Paper scale: ... --model_arch llama --model_name <ckpt> --tasks sst rte cola
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from .common import CONFIGS, add_driver_args, build, write_json

ARMS = [("fp32", None), ("w6a6_bfp", "bfp_6bit.toml"), ("w4a4_bfp", "bfp_4bit.toml")]


class _SynthTokenizer:
    """A word's id from Python's string hash (the JAX driver's: the same
    ids within one process)."""

    def __call__(self, text, add_special_tokens=True):
        ids = [1] if add_special_tokens else []
        ids += [2 + (hash(w) % 250) for w in text.split()]
        return {"input_ids": ids}

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


def _synthetic_examples(task: str, n=8):
    rng = np.random.default_rng(0)
    if task == "sst":
        return [{"sentence": f"synthetic review {i} text", "label": int(rng.integers(0, 2))}
                for i in range(n)]
    if task == "rte":
        return [{"sentence1": f"premise {i}", "sentence2": f"hypothesis {i}",
                 "label": int(rng.integers(0, 2))} for i in range(n)]
    if task == "cola":
        return [{"sentence": f"sample sentence {i}", "label": int(rng.integers(0, 2))}
                for i in range(n)]
    raise ValueError(task)


def main(argv=None):
    parser = argparse.ArgumentParser("section_4.2 downstream 0-shot sweep")
    add_driver_args(parser)
    parser.add_argument("--tasks", nargs="*", default=["sst", "rte", "cola"])
    parser.add_argument("--num_fewshot", type=int, default=0)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)

    from ...eval.prompting import eval_prompting_tasks
    from ...models.api import make_forward
    from ...utils.toml_io import load_config

    if args.synthetic:
        tokenizer = _SynthTokenizer()
        examples = {t: _synthetic_examples(t) for t in args.tasks}
        limit = args.limit or 6
    else:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_name)
        examples = None
        limit = args.limit

    rows = []
    params = None
    for name, toml in ARMS:
        qc = None if toml is None else load_config(CONFIGS / toml)
        config, p = build(args, "lm", qc)
        if params is None:
            params = p
        fwd = make_forward(args.model_arch, "lm", config, quantize_weights=True)
        res = eval_prompting_tasks(fwd, params, tokenizer, args.tasks, limit=limit,
                                   batch_size=args.batch_size or 4,
                                   num_fewshot=args.num_fewshot, examples_by_task=examples)
        res["arm"] = name
        rows.append(res)
        write_json(args.save_dir, f"downstream_{name}.json", res)
        print(f"{name}: mean_acc {res['mean_acc']:.4f}")

    out = Path(args.save_dir) / "downstream_summary.csv"
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["arm", "mean_acc"] + args.tasks)
        for r in rows:
            w.writerow([r["arm"], r["mean_acc"]] + [r["results"][t]["acc"] for t in args.tasks])
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
