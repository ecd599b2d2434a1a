"""Tiny cells for the benchmark's CPU tests: a copy of the benchmark's
folder with small configurations, mixes and limits beside the real ones,
and a ``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

# several test processes share the CPU: one thread each
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent
TINY_CELLS = {
    "tiny.offline": ("tiny-llama", "tiny-offline", {"request_mean_gap": 1e-4}),
    "tiny.stream": ("tiny-llama", "tiny-stream", {"request_mean_gap": 1e-4}),
    "tiny.ppl": ("tiny-opt", "tiny-ppl", {"max_loss_gap": 1e-5}),
}
# the tiny serving cells report what the offline cell reports
RENAME = {"mistral-7b.offline-b128": ("tiny.offline", "tiny.stream"),
          "opt-6.7b.ppl-w6a6": ("tiny.ppl",)}


def _dump(path: Path, obj):
    path.write_text(json.dumps(obj, indent=1))


def make_tiny_bench(root: Path) -> tuple[Path, Path]:
    """(bench_dir, bench_json) of a copy of the benchmark with tiny cells."""
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    llama = json.loads((bench / "configs" / "mistral-7b.json").read_text())
    llama["name"] = "tiny-llama"
    llama["model"].update(hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                          num_attention_heads=4, num_key_value_heads=2, vocab_size=4096)
    _dump(bench / "configs" / "tiny-llama.json", llama)
    opt = json.loads((bench / "configs" / "opt-6.7b.json").read_text())
    opt["name"] = "tiny-opt"
    opt["model"].update(hidden_size=64, ffn_dim=128, num_hidden_layers=2, num_attention_heads=4,
                        vocab_size=256, max_position_embeddings=128)
    _dump(bench / "configs" / "tiny-opt.json", opt)
    off = json.loads((bench / "traffic" / "offline-b128.json").read_text())
    off["batcher"].update(num_slots=4, max_len=64, prompt_bucket=16, decode_chunk=4,
                          max_new_tokens=24)
    off["prompt_len"].update(mean=8.0, hi=40, strata=4)
    off.update(warm_buckets=[16], queue=12, check={"requests": 3})
    _dump(bench / "traffic" / "tiny-offline.json", off)
    st = json.loads((bench / "traffic" / "stream-c16.json").read_text())
    st["batcher"].update(num_slots=4, max_len=64, prompt_bucket=16, decode_chunk=1,
                         max_new_tokens=6)
    st.update(warm_buckets=[16, 32], prompt_len={"lo": 4, "hi": 20}, clients=3,
              think_mean_s=0.05, start_spread_s=0.05, pool=64, check={"requests": 3})
    _dump(bench / "traffic" / "tiny-stream.json", st)
    ev = json.loads((bench / "traffic" / "ppl-w6a6.json").read_text())
    ev.update(seq_len=64, check={"sequences": 2})
    _dump(bench / "traffic" / "tiny-ppl.json", ev)
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "a CPU test"}
                         for n, (c, t, _) in TINY_CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [t for w in m["workloads"] for t in RENAME[w]]
    for n, (_, _, limits) in TINY_CELLS.items():
        _dump(bench / "limits" / f"{n}.json", limits)
    bench_json = root / "BENCHMARK.json"
    _dump(bench_json, spec)
    return bench, bench_json


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path)
