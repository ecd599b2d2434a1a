"""The port's EMNLP drivers (``llm_mixed_q_torch/experiments/emnlp/``) against
the JAX package's (``experiments/emnlp/``), both run in this process at
``--synthetic`` with their smallest sizes, the port's with ``--device cpu``.

Each port driver writes the JAX driver's artifacts: the same file names,
CSV headers and JSON keys. The numbers agree within the tolerance of the
path's own test: the synthetic model is the JAX driver's (the port's
``common.build_synthetic`` is given the JAX package's ``init_*_params`` of
the same seed through ``params_from_jax``, since the port draws its random
weights with torch's generator); then

- Section 1: the per-layer variances within rtol 1e-4
  (``tests/test_torch_stats.py``), rounded to 6 decimals by both;
- Section 4.2 perplexity: each arm's perplexity within rtol 1e-5 (the
  loss's tolerance in ``tests/test_torch_eval_lm.py``);
- Section 4.2 downstream: equal accuracies (``tests/test_torch_prompting.py``);
- Section 4.3 QAT: the epoch's loss within rtol 1e-5 and an equal accuracy
  (``tests/test_torch_qat.py``'s trajectory), checkpoints written;
- Section 4.4 search (the sampler seeded): the same trials, the same
  results.csv rows (``tests/test_torch_search.py``) and the summary's keys
  and counts.

The CI script runs the five port drivers (checked by its commands here; the
card runs it in ``chip_smoke.py --parallel-only``)."""

import csv
import importlib
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from llm_mixed_q_torch.experiments.emnlp import common as port_common
from llm_mixed_q_torch.models.hf_loader import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
JAX_DRIVERS = ROOT / "experiments" / "emnlp"
PORT_DRIVERS = ROOT / "llm_mixed_q_torch" / "experiments" / "emnlp"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_driver(name):
    if str(JAX_DRIVERS) not in sys.path:
        sys.path.insert(0, str(JAX_DRIVERS))
    return importlib.import_module(name)


@pytest.fixture
def jax_weights(monkeypatch):
    """The port drivers' synthetic model drawn as the JAX drivers draw it."""

    def build_synthetic(arch, task, quant_config, num_labels=2, device=None):
        jconfig, jparams = _jax_driver("_common").build_synthetic(arch, task, None, num_labels)
        from llm_mixed_q_torch.models import get_config_cls

        kwargs = port_common.tiny_config_kwargs(arch)
        if task == "cls":
            kwargs["num_labels"] = num_labels
        config = get_config_cls(arch)(**kwargs, quant_config=quant_config)
        return config, params_from_jax(jax.tree.map(np.asarray, jparams), device=device)

    monkeypatch.setattr(port_common, "build_synthetic", build_synthetic)


def _run_both(name, tmp_path, args):
    port = importlib.import_module(f"llm_mixed_q_torch.experiments.emnlp.{name}")
    port_out = port.main(["--synthetic", "--device", "cpu", "--save_dir",
                          str(tmp_path / "port"), *args])
    jax_out = _jax_driver(name).main(["--synthetic", "--save_dir", str(tmp_path / "jax"), *args])
    files = lambda d: sorted(p.relative_to(d).as_posix() for p in d.iterdir() if p.is_file())
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    return port_out, jax_out


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _json(path):
    return json.loads(Path(path).read_text())


def test_section_1_variance(tmp_path, jax_weights):
    _run_both("section_1_variance", tmp_path, ["--model_arch", "llama", "--seq_len", "16",
                                               "--batch_size", "2"])
    got, want = (_json(tmp_path / d / "variance_vs_depth.json") for d in ("port", "jax"))
    assert got.keys() == want.keys() and got["per_node"].keys() == want["per_node"].keys()
    assert [r["layer"] for r in got["series"]] == [r["layer"] for r in want["series"]] == [0, 1]
    for g, w in zip(got["series"], want["series"]):
        for k in ("mean_data_in_variance", "max_data_in_variance"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6)
    assert _csv(tmp_path / "port" / "variance_vs_depth.csv")[0] == _csv(
        tmp_path / "jax" / "variance_vs_depth.csv")[0]


def test_section_4_2_perplexity(tmp_path, jax_weights):
    _run_both("section_4_2_perplexity", tmp_path, ["--arms", "fp32", "w6a6_bfp",
                                                   "--seq_len", "32", "--num_samples", "8"])
    got, want = (_csv(tmp_path / d / "perplexity_summary.csv") for d in ("port", "jax"))
    assert got[0] == want[0] == ["arm", "perplexity", "delta_vs_fp32"]
    assert [r[0] for r in got] == [r[0] for r in want]
    for arm in ("fp32", "w6a6_bfp"):
        g, w = (_json(tmp_path / d / f"ppl_{arm}.json") for d in ("port", "jax"))
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["perplexity"], w["perplexity"], rtol=1e-5)


def test_section_4_2_downstream(tmp_path, jax_weights):
    _run_both("section_4_2_downstream", tmp_path, ["--tasks", "sst", "rte", "--limit", "4",
                                                   "--seq_len", "16"])
    for arm in ("fp32", "w6a6_bfp", "w4a4_bfp"):
        g, w = (_json(tmp_path / d / f"downstream_{arm}.json") for d in ("port", "jax"))
        assert g.keys() == w.keys() and g["results"].keys() == w["results"].keys()
        assert g["mean_acc"] == w["mean_acc"]
        assert all(g["results"][t]["acc"] == w["results"][t]["acc"] for t in g["results"])
    assert _csv(tmp_path / "port" / "downstream_summary.csv") == _csv(
        tmp_path / "jax" / "downstream_summary.csv")


def test_section_4_3_qat(tmp_path, jax_weights):
    _run_both("section_4_3_qat", tmp_path, ["--seq_len", "16", "--batch_size", "8"])
    got, want = (_json(tmp_path / d / "qat_history.json") for d in ("port", "jax"))
    assert got.keys() == want.keys() and len(got["history"]) == len(want["history"]) == 1
    g, w = got["history"][0], want["history"][0]
    assert g.keys() == w.keys()
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
    assert g["accuracy"] == w["accuracy"]
    assert (tmp_path / "port" / "checkpoints").is_dir() and (tmp_path / "jax" / "checkpoints").is_dir()


def test_section_4_4_search(tmp_path, jax_weights):
    """The paper's search space with the sampler seeded (its TOML leaves the
    seed out, and an unseeded TPE draws other trials each run)."""
    text = (ROOT / "configs" / "search" / "opt_1.3b_sst2.toml").read_text()
    seeded = tmp_path / "search.toml"
    seeded.write_text(text.replace('sampler = "TPE"', 'sampler = "TPE"\nseed = 0', 1))
    _run_both("section_4_4_search", tmp_path, ["--n_trials", "2", "--samples_per_trial", "8",
                                               "--seq_len", "16", "--search_config", str(seeded)])
    got, want = (_json(tmp_path / d / "search_summary.json") for d in ("port", "jax"))
    assert got.keys() == want.keys()
    assert (got["n_trials"], got["pareto_size"]) == (want["n_trials"], want["pareto_size"])
    assert _csv(tmp_path / "port" / "results.csv") == _csv(tmp_path / "jax" / "results.csv")
    assert _csv(tmp_path / "port" / "search_log.csv")[0] == _csv(
        tmp_path / "jax" / "search_log.csv")[0]


def test_ci_script_runs_the_five_port_drivers():
    script = (PORT_DRIVERS / "run_all_ci.sh").read_text()
    jax_script = (JAX_DRIVERS / "run_all_ci.sh").read_text()
    names = ("section_1_variance", "section_4_2_perplexity", "section_4_2_downstream",
             "section_4_3_qat", "section_4_4_search")
    port_lines = [line for line in script.splitlines() if line.startswith("run \"")]
    jax_lines = [line for line in jax_script.splitlines() if line.startswith("run \"")]
    assert len(port_lines) == len(jax_lines) == len(names)
    for name, line, jax_line in zip(names, port_lines, jax_lines):
        # the same sections in the same order, each one process at --synthetic
        assert f"python -m $M.{name} " in line and f" {name}.py " in jax_line
        assert "--synthetic --device" in line and "--synthetic" in jax_line
