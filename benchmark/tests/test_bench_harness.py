"""The harness on the CPU at tiny sizes: sound runs are correct, planted
faults are not, a run without a card fails, nothing imports JAX, and new
cells come from new files alone."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import run_cell

BENCH = Path(__file__).resolve().parent.parent

SEED = 2**31 + 11


def _run(tiny_bench, workload, seconds=3.0, trace=False, controls=()):
    bench, bench_json = tiny_bench
    return run_cell(workload, SEED, seconds, trace, "cpu", time.perf_counter(),
                    bench_dir=bench, bench_json=bench_json, controls=controls,
                    log=lambda *a: None)


@pytest.mark.parametrize("workload", ["tiny.offline", "tiny.stream", "tiny.ppl"])
def test_sound_run_is_correct(tiny_bench, workload):
    out = _run(tiny_bench, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]
    assert out["device"]["count"] == 1


@pytest.mark.parametrize("workload", ["tiny.offline", "tiny.ppl"])
def test_traced_run_reports_per_layer_metrics(tiny_bench, workload):
    out = _run(tiny_bench, workload, trace=True)
    assert out["correct"]
    names = set(out["metrics"])
    assert "setup_s" not in names
    assert names <= {"admit_ms.offline", "step_ms.decode", "mfu.serve", "mfu.eval"}
    assert "window_s" in out["device"] and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_token_altered_where_produced(tiny_bench, monkeypatch):
    from llm_mixed_q_torch.models.llama import serving

    real = serving.decode_step

    def altered(*args, **kwargs):
        logits = real(*args, **kwargs)
        rows = torch.arange(logits.shape[0])
        wrong = (logits.argmax(-1) + 1) % logits.shape[-1]
        logits[rows, wrong] = logits.amax(-1) + 1.0
        return logits

    monkeypatch.setattr(serving, "decode_step", altered)
    out = _run(tiny_bench, "tiny.offline")
    assert not out["correct"]
    check = out["checks"]["request_mean_gap"]
    assert check["value"] > check["limit"]


def test_one_request_altered_in_part(tiny_bench):
    """Half of the tokens of the longest request of each block altered: the
    check's largest mean gap of a request fails it, undiluted by the
    sample's sound requests."""
    from benchmark import faults, traffic as gen
    from benchmark.harness import load_cell

    bench, bench_json = tiny_bench
    _, _, config, traffic, _, _, _ = load_cell("tiny.offline", bench, bench_json)
    longest = max(gen.lengths(traffic["prompt_len"], traffic["queue"], SEED))
    half = traffic["batcher"]["max_new_tokens"] // 2
    with faults.one_request(longest, half, config["model"]["vocab_size"]):
        out = _run(tiny_bench, "tiny.offline")
    assert not out["correct"]
    check = out["checks"]["request_mean_gap"]
    assert check["value"] > check["limit"]
    # the pooled mean of the sample is diluted by its sound requests
    assert out["readings"]["mean_gap"] < check["value"]


def test_step_that_leaves_its_state_unchanged(tiny_bench, monkeypatch):
    from llm_mixed_q_torch.models.llama import serving

    real = serving._append_and_read

    def unchanged(cache_layer, *args, **kwargs):
        copy = tuple(t.clone() for t in cache_layer) if isinstance(cache_layer, tuple) \
            else cache_layer.clone()
        return real(copy, *args, **kwargs)

    monkeypatch.setattr(serving, "_append_and_read", unchanged)
    out = _run(tiny_bench, "tiny.stream")
    assert not out["correct"]


def test_half_of_the_batch_left_out(tiny_bench, monkeypatch):
    from llm_mixed_q_torch.models.opt import modeling

    real = modeling.causal_lm_loss

    def half(logits, labels, ignore_index=-100):
        keep = logits.shape[1] // 2
        return real(logits[:, :keep], labels[:, :keep], ignore_index)

    monkeypatch.setattr(modeling, "causal_lm_loss", half)
    out = _run(tiny_bench, "tiny.ppl")
    assert not out["correct"]


def test_answer_altered_where_produced(tiny_bench, monkeypatch):
    from llm_mixed_q_torch.models.opt import modeling

    real = modeling.causal_lm_loss

    def altered(logits, labels, ignore_index=-100):
        logits = logits.clone()
        logits[0, 0, labels[0, 1]] += 1.0
        return real(logits, labels, ignore_index)

    monkeypatch.setattr(modeling, "causal_lm_loss", altered)
    out = _run(tiny_bench, "tiny.ppl")
    assert not out["correct"]


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "mistral-7b.offline-b128", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fail(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = bench_run.main(["--workload", "opt-6.7b.ppl-w6a6", "--seed", "1",
                         "--seconds", "1", "--trace", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder
    cannot run the system under test."""
    (tmp_path / "BENCHMARK.json").write_text((BENCH.parent / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'opt-6.7b.ppl-w6a6', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "llm_mixed_q_torch" in proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_nothing_imports_jax_or_the_jax_package():
    forbidden = set(bench_run.FORBIDDEN)
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for path in files:
        for name, level in _imports(path):
            if level == 0:
                assert name.split(".")[0] not in forbidden, (path, name)


def test_the_references_import_nothing_of_the_program():
    """The references, and the weights' draw they share with set-up."""
    for path in [*(BENCH / "reference").glob("*.py"), BENCH / "weights.py"]:
        for name, level in _imports(path):
            assert level == 0, (path, name)
            assert (name.split(".")[0] in {"__future__", "math", "numpy", "torch"}
                    or name == "benchmark.reference.quant"), (path, name)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "llm_mixed_q_tpux", object())
    assert "llm_mixed_q_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "llm_mixed_q_tpu.kernels", object())
    assert "llm_mixed_q_tpu" in bench_run.forbidden_modules()


def test_new_files_make_a_new_cell(tiny_bench):
    """A family, a configuration, a mix, a metric and a cell added as new
    files and entries run without an edit to any file that was there."""
    bench, bench_json = tiny_bench
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "families" / "tinyfam.py").write_text("from benchmark.families.llama import *\n")
    (bench / "reference" / "tinyfam.py").write_text(
        "from benchmark.reference.llama import served_logits\n")
    cfg = json.loads((bench / "configs" / "tiny-llama.json").read_text())
    cfg["name"] = "tiny-llama-wide"
    cfg["family"] = "tinyfam"
    cfg["model"]["intermediate_size"] = 192
    (bench / "configs" / "tiny-llama-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny-offline.json").read_text())
    mix["prompt_len"] = {"lo": 20, "hi": 30}
    mix["warm_buckets"] = [32]
    (bench / "traffic" / "tiny-long.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_in_window.py").write_text(
        "def read(rec):\n    return float(sum(s['decode_steps'] for s in rec.steps)) or None\n")
    (bench / "limits" / "wide.long.json").write_text(json.dumps({"request_mean_gap": 1e-4}))
    spec = json.loads(bench_json.read_text())
    spec["configs"].append({"name": "tiny-llama-wide", "source": "a test", "why": "a test",
                            "file": "benchmark/configs/tiny-llama-wide.json", "reduced": []})
    spec["workloads"].append({"name": "wide.long", "config": "tiny-llama-wide",
                              "traffic": "tiny-long", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "Serving loop",
                              "moves": "decode_tok_s", "workloads": ["wide.long"]})
    spec["end_to_end"][0]["workloads"].append("wide.long")
    bench_json.write_text(json.dumps(spec))
    out = _run((bench, bench_json), "wide.long", trace=True)
    assert out["correct"]
    assert out["metrics"]["steps_in_window"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())
    plain = _run((bench, bench_json), "wide.long")
    assert set(plain["metrics"]) == {"decode_tok_s", "setup_s"}


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tiny_bench):
    """The tiny cells through the card's kernels, held to the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench, bench_json = tiny_bench
    for workload in ("tiny.offline", "tiny.stream", "tiny.ppl"):
        out = run_cell(workload, SEED, 2.0, True, "cuda", time.perf_counter(),
                       bench_dir=bench, bench_json=bench_json, log=lambda *a: None)
        assert out["correct"], (workload, out["checks"])
        assert out["device"]["busy_s"] > 0
