"""Section 1 (motivation): the activation variance against depth (counterpart
of the JAX package's ``experiments/emnlp/section_1_variance.py``).

The float model (quant nodes bypassed) is profiled with ``variance_online``
at every quantized node (``stats.profile_statistics`` with the model
function: the stat tap, no fork of the model), reduced per layer (the mean
and max over the layer's data_in taps), and written to
variance_vs_depth.{json,csv}.

CI scale:    python -m llm_mixed_q_torch.experiments.emnlp.section_1_variance \\
                 --synthetic --save_dir out/ [--device cpu]
Paper scale: ... --model_arch llama --model_name <vicuna-7b dir>
"""

from __future__ import annotations

import argparse
import csv
import re
from pathlib import Path

import numpy as np

from .common import add_driver_args, build, write_json


def main(argv=None):
    parser = argparse.ArgumentParser("section_1 variance-vs-depth profile")
    add_driver_args(parser)
    args = parser.parse_args(argv)
    seq_len = args.seq_len or (32 if args.synthetic else 2048)
    batch_size = args.batch_size or 4
    num_batches = 4

    from ...datasets import make_synthetic_lm_dataset
    from ...models import get_model_fn
    from ...stats.profiler import profile_statistics

    # the float model: the paper profiles the float activations
    config, params = build(args, task="lm", quant_config=None)
    data = make_synthetic_lm_dataset(config.vocab_size, seq_len, batch_size * num_batches, seed=0)
    batches = [{k: v[i * batch_size:(i + 1) * batch_size] for k, v in data.items()}
               for i in range(num_batches)]
    profile = profile_statistics(batches=batches, arch=args.model_arch,
                                 model_fn=get_model_fn(args.model_arch, "lm"), config=config,
                                 params=params, act_stats=("variance_online",), weight_stats=())

    # node-level variance reduced to a per-layer depth series; the profile's
    # keys are flat ``root:<node path>:<entry>`` names
    per_layer: dict[int, list[float]] = {}
    node_table = {}
    for name, stats in profile.items():
        m = re.search(r"model_layer_(\d+)", name)
        if m is None or "variance_online" not in stats or not name.endswith(":data_in"):
            continue
        var = np.asarray(stats["variance_online"]["variance"], dtype=np.float64)
        v = float(np.mean(var))
        per_layer.setdefault(int(m.group(1)), []).append(v)
        node_table[name] = round(v, 6)

    series = [{"layer": d, "mean_data_in_variance": round(float(np.mean(vs)), 6),
               "max_data_in_variance": round(float(np.max(vs)), 6)}
              for d, vs in sorted(per_layer.items())]
    if not series:
        raise RuntimeError("empty variance series: no 'root:model_layer_<i>:...:data_in' keys "
                           f"with variance_online in the profile ({len(profile)} keys)")

    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    write_json(save_dir, "variance_vs_depth.json", {
        "protocol": "variance_online per quant node (jitted tap path), "
        "reduced per layer — reference section_1/profile_variance",
        "arch": args.model_arch,
        "seq_len": seq_len,
        "series": series,
        "per_node": node_table,
    })
    with open(save_dir / "variance_vs_depth.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["layer", "mean_data_in_variance",
                                          "max_data_in_variance"])
        w.writeheader()
        w.writerows(series)
    for row in series:
        print(f"layer {row['layer']:3d}: mean var {row['mean_data_in_variance']:.6f}  max "
              f"{row['max_data_in_variance']:.6f}")
    print(f"wrote {save_dir}/variance_vs_depth.json")


if __name__ == "__main__":
    main()
