"""The port's mixed-precision search against the JAX package, on the CPU at
a tiny size (2 layers, hidden 64, vocab 96): the search engine and its
five samplers, the Pareto helpers, the study's pickle, the trial
extractor, the model samplers and the registry's last getters, the
classification search and the conditional (integer) search with their
artifacts, and the seven search CLIs.

The engine is pure Python in both packages and draws from ``random``
seeded by the study's seed, so a seeded study gives the same trials: the
same params, values, states and Pareto front. The searches run 2 trials
on the same float32 parameters and the same synthetic GLUE stream:
sampled configs and metrics equal, ``search_log.csv``, ``results.csv``
and the TOMLs byte-equal, and the best trial's evaluation within 1e-12
(the metrics of equal predictions)."""

import builtins
import filecmp
import logging
import pickle
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

import llm_mixed_q_tpu.cli.search_cli as jax_cli
import llm_mixed_q_tpu.search.engine as jax_engine
from llm_mixed_q_tpu.datasets import make_synthetic_cls_dataset as jax_synthetic_cls
from llm_mixed_q_tpu.datasets import numpy_dataloader as jax_loader
from llm_mixed_q_tpu.eval import eval_cls_glue as jax_eval_cls
from llm_mixed_q_tpu.models import get_config_cls as jax_config_cls
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init_llama
from llm_mixed_q_tpu.search import SearchIntQuantisationForClassification as JaxIntSearch
from llm_mixed_q_tpu.search import SearchQuantisationForClassification as JaxSearch
from llm_mixed_q_tpu.search.samplers_model import MODEL_SAMPLER_MAP as JAX_SAMPLERS
from llm_mixed_q_tpu.utils.trial_extractor import trial_to_quant_config as jax_trial_to_qc
import llm_mixed_q_torch.cli.search_cli as port_cli
from llm_mixed_q_torch import models as port_models
from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset, numpy_dataloader
from llm_mixed_q_torch.eval import eval_dse_results
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import llama_for_sequence_classification
from llm_mixed_q_torch.models.opt import opt_for_sequence_classification
from llm_mixed_q_torch.search import (
    MODEL_SAMPLER_MAP,
    SAMPLER_MAP,
    SearchIntQuantisationForClassification,
    SearchQuantisationForClassification,
    Study,
    create_study,
    get_sampler,
    non_dominated_sort,
)
from llm_mixed_q_torch.search.engine import FrozenTrial, crowding_distance, decode_ast_value
from llm_mixed_q_torch.stats.profiler import profile_statistics
from llm_mixed_q_torch.utils.trial_extractor import extract_quant_config, trial_to_quant_config
from test_torch_cls import KW, opt_trees

SEED_SPACE = {  # a block_fp search space (configs/search/*.toml's entries)
    "name": ["block_fp"], "bypass": ["!ast!False"], "is_ptq": ["!ast!True"],
    "data_in_width": [6, 4], "data_in_exponent_width": [8],
    "data_in_exponent_bias": ["!ast!None"], "data_in_block_size": ["!ast![1, 16]"],
    "weight_width": [6, 4], "weight_exponent_width": [8],
    "weight_exponent_bias": ["!ast!None"], "weight_block_size": ["!ast![1, 16]"],
    "bias_width": [6], "bias_exponent_width": [8], "bias_exponent_bias": ["!ast!None"],
    "bias_block_size": ["!ast![1, 16]"],
}
INT_SPACE = {"name": ["integer"], "bypass": [False], "data_in_width": [8, 6],
             "weight_width": [8, 6], "bias_width": [8], "data_out_width": [8]}


def search_config(space, extend_first, sampler="random"):
    return {
        "search_strategy": {"n_trials": 2, "n_jobs": 1, "sampler": sampler, "seed": 0,
                            "accuracy_threshold": 0, "avg_bitwidth_threshold": 0},
        "search_estimator": {"alpha_accuracy": 1.0, "alpha_memory_density": 0.1,
                             "alpha_fps": 0, "alpha_fps_per_lut": 0, "compare_to": 32},
        "search_space": {"extend_quant_config_seed_first": extend_first,
                         "quant_config_seed": {"default": dict(space)}},
    }


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ the engine


def _objective(trial):
    """Two objectives of three categorical choices (a list among them)."""
    w = trial.suggest_categorical("w", [2, 4, 6, 8])
    b = trial.suggest_categorical("b", ["!ast![1, 16]", "!ast![16]"])
    e = trial.suggest_categorical("e", [4, 8])
    acc = 1.0 - 0.05 * (8 - w) + (0.01 if b == "!ast![16]" else 0.0) - 0.002 * e
    return acc, 32 / w + 0.1 * e


SAMPLER_CASES = {  # name: constructor arguments past the seed (every sampler's own path)
    "random": {}, "tpe": {"n_startup_trials": 4}, "nsgaii": {"population_size": 4},
    "nsgaiii": {"population_size": 4}, "qmc": {},
}


@pytest.mark.parametrize("name", list(SAMPLER_CASES))
def test_samplers_give_jax_s_trials(name):
    """A seeded study of 12 trials: the JAX engine's trials in its order,
    with its params, values, states and Pareto front."""
    studies = []
    for maps in (jax_engine.SAMPLER_MAP, SAMPLER_MAP):
        sampler = maps[name](seed=3, **SAMPLER_CASES[name])
        study = (jax_engine.create_study if maps is jax_engine.SAMPLER_MAP else create_study)(
            ["maximize", "maximize"], sampler)
        study.optimize(_objective, n_trials=12)
        studies.append(study)
    want, got = studies
    key = lambda s: [(t.number, t.params, t.values, t.state) for t in s.trials]
    assert key(got) == key(want) and len(got.trials) == 12
    assert [t.number for t in got.best_trials] == [t.number for t in want.best_trials]
    assert get_sampler(name.upper(), seed=3).__class__ is SAMPLER_MAP[name]


def test_pareto_helpers_match_jax():
    """``non_dominated_sort`` and ``crowding_distance`` on fixed points."""
    pts = [[1, 1], [2, 0.5], [0.5, 0.5], [0.5, 2], [1, 1], [0.2, 0.1], [3, 0], [0.4, 0.4]]
    ours = [FrozenTrial(i, {}, {}, list(v), "COMPLETE") for i, v in enumerate(pts)]
    theirs = [jax_engine.FrozenTrial(i, {}, {}, list(v), "COMPLETE") for i, v in enumerate(pts)]
    fronts = [[t.number for t in f] for f in non_dominated_sort(ours)]
    assert fronts == [[t.number for t in f] for f in jax_engine.non_dominated_sort(theirs)]
    assert fronts[0] == [0, 1, 3, 4, 6]
    assert crowding_distance(ours[:5]) == jax_engine.crowding_distance(theirs[:5])
    assert crowding_distance([]) == {}


def test_study_save_load_and_best_trial(tmp_path):
    """``save`` / ``load`` round-trip the trials; a single-objective study's
    ``best_trial``; ``decode_ast_value``."""
    study = create_study(["maximize", "maximize"], get_sampler("random", seed=1))
    study.optimize(_objective, n_trials=5)
    study.save(tmp_path / "study.pkl")
    back = Study.load(tmp_path / "study.pkl")
    assert [(t.params, t.values) for t in back.trials] == [(t.params, t.values)
                                                           for t in study.trials]
    single = create_study(["maximize"], get_sampler("tpe", seed=1))
    single.optimize(lambda t: t.suggest_categorical("x", [1, 3, 2]), n_trials=6)
    assert single.best_trial.value == 3.0
    assert decode_ast_value("!ast![1, 16]") == [1, 16] and decode_ast_value(4) == 4


def test_optimize_timeout_and_n_jobs(caplog, monkeypatch):
    """``timeout`` stops before ``n_trials``; ``n_jobs`` > 1 runs the trials
    one after another and says so; a failing objective marks its trial.
    (The package logger stops propagating once a CLI has set its verbosity,
    ``utils/logger.py``, which an earlier test in the same process may have
    done: it propagates to ``caplog`` here whatever ran before.)"""
    monkeypatch.setattr(logging.getLogger("llm_mixed_q_torch"), "propagate", True)
    study = create_study(["maximize"], get_sampler("random", seed=0))

    def slow(trial):
        time.sleep(0.05)
        return trial.suggest_categorical("x", [1, 2])

    study.optimize(slow, n_trials=100, timeout=0.2)
    assert 1 <= len(study.trials) < 100
    with caplog.at_level(logging.WARNING):
        create_study(["maximize"]).optimize(slow, n_trials=2, n_jobs=4)
    assert "sequentially" in caplog.text

    def fails(trial):
        trial.suggest_categorical("x", [1])
        raise RuntimeError("boom")

    broken = create_study(["maximize"])
    with pytest.raises(RuntimeError):
        broken.optimize(fails, n_trials=1)
    assert broken.trials[0].state == "FAIL" and broken.trials[0].params == {"x": 1}


def test_trial_extractor_writes_jax_s_toml(tmp_path):
    """A trial's config and its TOML byte-equal to JAX's; ``extract_quant_config``
    of a saved study (a trial, and the Pareto front's first)."""
    study = create_study(["maximize", "maximize"], get_sampler("random", seed=2))
    sampler = MODEL_SAMPLER_MAP["llama"]
    seed_qc = {"default": dict(SEED_SPACE), "model_layer_0": {
        "self_attn": {n: dict(SEED_SPACE) for n in (
            "q_proj", "k_proj", "v_proj", "o_proj", "rotary_positional_encoding", "matmul_0",
            "matmul_1")},
        "mlp": {n: dict(SEED_SPACE) for n in ("gate_proj", "down_proj", "up_proj")}}}
    study.optimize(lambda t: (len(sampler(t, "root", seed_qc)), 1.0), n_trials=3)
    trial = study.trials[1]
    got = trial_to_quant_config(trial, tmp_path / "port.toml")
    assert got == jax_trial_to_qc(trial, tmp_path / "jax.toml")
    assert got["model_layer_0"]["self_attn"]["matmul_0"]["data_in_block_size"] == [1, 16]
    assert (tmp_path / "port.toml").read_bytes() == (tmp_path / "jax.toml").read_bytes()
    study.save(tmp_path / "study.pkl")
    assert extract_quant_config(tmp_path / "study.pkl", 1, tmp_path / "x.toml") == got
    assert extract_quant_config(tmp_path / "study.pkl") == trial_to_quant_config(
        study.best_trials[0])


# -------------------------------------------- the model samplers and the registry


class _FirstChoice:
    """A trial that records every name it is asked and takes the last
    choice."""

    def __init__(self):
        self.names = []

    def suggest_categorical(self, name, choices):
        self.names.append(name)
        return choices[-1]


def _seed_config(arch):
    """Every node the arch's sampler walks, with a model_layer_1 entry and
    an unknown key (ignored with a warning)."""
    layer = {
        "llama": {"self_attn": dict.fromkeys(("q_proj", "k_proj", "v_proj", "o_proj",
                                              "rotary_positional_encoding", "matmul_0",
                                              "matmul_1")),
                  "mlp": dict.fromkeys(("gate_proj", "down_proj", "up_proj"))},
        "opt": {"self_attn": dict.fromkeys(("q_proj", "k_proj", "v_proj", "out_proj",
                                            "bmm_0", "bmm_1")),
                "fc1": None, "fc2": None},
        "bert": {"attention": {**dict.fromkeys(("query", "key", "value", "matmul_0",
                                                "matmul_1")), "output": {"dense": None}},
                 "intermediate": {"dense": None}, "output": {"dense": None}},
    }[arch]

    def fill(d):
        return {k: fill(v) if isinstance(v, dict) else {"weight_width": [4, 6], "bias": [8]}
                for k, v in d.items()}

    qc = {"default": {"name": ["integer"], "data_in_width": [8, 6]},
          "model_layer_1": fill(layer), "unknown_key": {}}
    if arch == "llama":
        qc["rotary_positional_encoding"] = {"name": ["integer"]}
    return qc


@pytest.mark.parametrize("arch", ["llama", "opt", "bert"])
def test_model_samplers_match_jax(arch):
    """Each arch's sampler asks JAX's param names, in JAX's order, and
    builds JAX's config; the registry's getter returns it."""
    out = []
    for sampler in (MODEL_SAMPLER_MAP[arch], JAX_SAMPLERS[arch]):
        trial = _FirstChoice()
        out.append((trial.names, sampler(trial, "root", _seed_config(arch))))
    assert out[0] == out[1] and len(out[0][0]) > 10
    assert "root:model_layer_1:" + {"llama": "self_attn:q_proj", "opt": "fc1",
                                    "bert": "attention:output:dense"}[arch] + ":weight_width" in \
        out[0][0]
    assert port_models.get_quant_config_sampler(arch) is MODEL_SAMPLER_MAP[arch]


def test_registry_tokenizer_and_dse_stub(monkeypatch):
    """``get_tokenizer_cls`` gives transformers' AutoTokenizer (a stand-in
    module here, to spare the import), and without transformers an
    ImportError that names it; ``eval_dse_results`` is the reference's
    inert stub."""
    stand_in = types.ModuleType("transformers")
    stand_in.AutoTokenizer = object()
    monkeypatch.setitem(sys.modules, "transformers", stand_in)
    assert port_models.get_tokenizer_cls("llama") is stand_in.AutoTokenizer
    monkeypatch.delitem(sys.modules, "transformers")
    real_import = builtins.__import__

    def no_transformers(name, *a, **k):
        if name.startswith("transformers"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="transformers"):
        port_models.get_tokenizer_cls("opt")
    assert eval_dse_results(None, is_mixed=True) == {"best_fps": 0.0, "resource": 1.0}


# ------------------------------------------------------------------ the searches

TINY_CLS = {"llama": dict(KW["llama"], num_labels=2), "opt": dict(KW["opt"], num_labels=2)}


def _trees(arch):
    """(JAX numpy tree, port tree) of one seeded classifier."""
    if arch == "llama":
        jp = jax.tree.map(np.asarray, jax_init_llama(jax_config_cls("llama")(**KW["llama"]),
                                                     task="cls", seed=0))
        return jp, params_from_jax(jp, device="cpu")
    jc = jax_config_cls("opt")(**KW["opt"])
    tc = port_models.get_config_cls("opt")(**KW["opt"])
    return opt_trees(jc, tc)


def _profile(arch, tree, data):
    """A stat profile of the float classifier on the data's first 2 batches."""
    fn = {"llama": llama_for_sequence_classification, "opt": opt_for_sequence_classification}
    config = port_models.get_config_cls(arch)(**TINY_CLS[arch])
    return profile_statistics(batches=list(numpy_dataloader(data, batch_size=8))[:2],
                              arch=arch, model_fn=fn[arch], config=config, params=tree)


def _same_artifacts(a, b):
    """search_log.csv, results.csv, best_quant_config.toml and every
    best_trials/*.toml byte-equal."""
    names = sorted(p.name for p in (a / "best_trials").iterdir())
    assert names and names == sorted(p.name for p in (b / "best_trials").iterdir())
    for rel in ["search_log.csv", "results.csv", "best_quant_config.toml",
                *(f"best_trials/{n}" for n in names)]:
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


@pytest.mark.parametrize("arch", ["llama", "opt"])
@pytest.mark.parametrize("kind", ["plain", "conditional"])
def test_search_matches_jax(arch, kind, tmp_path):
    """2 trials of ``SearchQuantisationForClassification`` (block_fp, the
    seed extended per layer first for llama) or of
    ``SearchIntQuantisationForClassification`` (integer widths, frac widths
    from a stat profile), then ``evaluate_best_trials``: JAX's sampled
    configs, metrics, artifacts and result."""
    jp, tp = _trees(arch)
    data = jax_synthetic_cls(96, 16, 16, seed=5)
    np.testing.assert_array_equal(make_synthetic_cls_dataset(96, 16, 16, seed=5)["input_ids"],
                                  data["input_ids"])
    mck = TINY_CLS[arch]
    results = {}
    for pkg, tree, loader in (("jax", jp, jax_loader), ("port", tp, numpy_dataloader)):
        factory = lambda loader=loader: loader(data, batch_size=8)
        if kind == "plain":
            cls = JaxSearch if pkg == "jax" else SearchQuantisationForClassification
            search = cls(arch, "tiny", search_config(SEED_SPACE, arch == "llama"),
                         tmp_path / pkg, tree, model_config_kwargs=mck)
        else:
            cls = JaxIntSearch if pkg == "jax" else SearchIntQuantisationForClassification
            search = cls(arch, "tiny", search_config(INT_SPACE, False), tmp_path / pkg, tree,
                         stat_profile=_profile(arch, tp, data), model_config_kwargs=mck)
        study = search.search(factory, "sst2", False, 16, 16)
        if pkg == "jax" and kind == "conditional":
            # fault 16: JAX evaluates the sampled widths without their frac
            # widths and raises; its eval of the config the trial ran is the
            # reference, with the TOML it would save
            with pytest.raises(KeyError, match="frac_width"):
                search.evaluate_best_trials(study, factory, "sst2")
            results[pkg] = (study, search)
            continue
        results[pkg] = (study, search.evaluate_best_trials(study, factory, "sst2"))
    (want, want_best), (got, got_best) = results["jax"], results["port"]
    assert [(t.params, t.values, t.state) for t in got.trials] == [
        (t.params, t.values, t.state) for t in want.trials]
    if kind == "conditional":
        jsearch, best = want_best, want.trials[got_best["best_trial_number"]]
        assert best in want.best_trials
        qc = jax_trial_to_qc(best, tmp_path / "jax" / "best_quant_config.toml")
        qc = jsearch.q_config_parser(jsearch._sampled_to_config(qc, 2), 2, strict=False)
        want_best = {"best_trial_number": best.number, **jax_eval_cls(
            jsearch.make_forward(jsearch.make_model_config(qc)), jp, "sst2",
            jax_loader(data, batch_size=8))}
    assert got_best.keys() == want_best.keys()
    assert got_best["best_trial_number"] == want_best["best_trial_number"]
    for k in got_best:
        assert abs(got_best[k] - want_best[k]) <= 1e-12, k
    _same_artifacts(tmp_path / "jax", tmp_path / "port")
    saved = pickle.loads((tmp_path / "port" / "study.pkl").read_bytes())
    assert [t.params for t in saved.trials] == [t.params for t in got.trials]


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def opt_checkpoint(tmp_path_factory):
    """A tiny OPT classifier checkpoint (the statistics tests')."""
    import json

    from safetensors.numpy import save_file
    from test_torch_cls import opt_flat

    d = tmp_path_factory.mktemp("search_opt")
    (d / "config.json").write_text(json.dumps(dict(KW["opt"], model_type="opt")))
    save_file(opt_flat(2, seed=2), str(d / "model.safetensors"))
    return d


@pytest.fixture
def offline_glue(monkeypatch):
    """Both packages' search CLIs read an in-memory SST-2 through the
    classification tests' stand-in tokenizer."""
    from test_torch_cls import pair_tokenizer, raw_glue

    for mod in (jax_cli, port_cli):
        monkeypatch.setattr(mod, "get_raw_dataset_dict", lambda name: raw_glue(name, n=16))
        monkeypatch.setattr(mod, "get_tokenizer", lambda args: pair_tokenizer)


def jax_cls_setup_at_checkpoint_widths(monkeypatch):
    """Fault 17's repair applied to the JAX CLIs for the comparison: each
    trial's config takes the checkpoint's widths, as the port's does (JAX's
    takes the config class's defaults)."""
    setup = jax_cli._cls_setup

    def at_widths(args):
        params, factory, _ = setup(args)
        config = jax_config_cls(args.model_arch).from_pretrained(args.model_name,
                                                                 num_labels=args.num_labels)
        return params, factory, port_cli.checkpoint_config_kwargs(config)

    monkeypatch.setattr(jax_cli, "_cls_setup", at_widths)


@pytest.mark.parametrize("cli,extra", [
    ("cli_search_quantisation_on_cls_glue", []),
    ("cli_conditional_search_quantisation_on_cls_glue", ["--stat_profile"]),
])
def test_cls_search_clis_match_jax(opt_checkpoint, offline_glue, monkeypatch, tmp_path, cli,
                                   extra):
    """Both packages' CLIs on one checkpoint: the same trials and
    artifacts, and the same best result written beside them. JAX's CLIs
    build each trial's config at the config class's default widths and
    fail on this checkpoint (fault 17): they run here with the port's
    repair; its conditional CLI still raises before its best result
    (fault 16)."""
    import json

    from llm_mixed_q_torch.utils import save_config

    space = SEED_SPACE if not extra else INT_SPACE
    save_config(search_config(space, False), tmp_path / "search.toml")
    argv = ["--model_arch", "opt", "--model_name", str(opt_checkpoint), "--task", "sst2",
            "--search_config", str(tmp_path / "search.toml"), "--seq_len", "16",
            "--batch_size", "8", "--num_samples", "16"]
    if extra:
        data = {k: v for k, v in jax_synthetic_cls(96, 16, 16, seed=5).items()}
        jc = jax_config_cls("opt")(**KW["opt"])
        tc = port_models.get_config_cls("opt")(**KW["opt"])
        save_config(_profile("opt", opt_trees(jc, tc)[1], data), tmp_path / "profile.toml")
        argv += ["--stat_profile", str(tmp_path / "profile.toml")]
    got = getattr(port_cli, cli)(argv + ["--device", "cpu", "--save_dir", str(tmp_path / "port")])
    if not extra:  # fault 17: JAX's trials take the default OPT widths, not the checkpoint's
        with pytest.raises(Exception):
            getattr(jax_cli, cli)(argv + ["--save_dir", str(tmp_path / "jax_as_is")])
    jax_cls_setup_at_checkpoint_widths(monkeypatch)
    if extra:
        # fault 16: JAX's CLI raises in evaluate_best_trials, after the
        # trials and their artifacts
        with pytest.raises(KeyError, match="frac_width"):
            getattr(jax_cli, cli)(argv + ["--save_dir", str(tmp_path / "jax")])
        want = jax_engine.Study.load(tmp_path / "jax" / "study.pkl")
        assert (tmp_path / "port" / "conditional_search_best.json").exists()
    else:
        want = getattr(jax_cli, cli)(argv + ["--save_dir", str(tmp_path / "jax")])
        assert json.loads((tmp_path / "port" / "search_best.json").read_text()) == json.loads(
            (tmp_path / "jax" / "search_best.json").read_text())
    assert [(t.params, t.values) for t in got.trials] == [(t.params, t.values)
                                                           for t in want.trials]
    for rel in ["search_log.csv", "results.csv",
                *(f"best_trials/{p.name}" for p in (tmp_path / "jax" / "best_trials").iterdir())]:
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel, shallow=False), rel


def test_extract_and_transform_clis_match_jax(tmp_path):
    """``cli_extract_quant_config`` of a saved study and
    ``cli_transform_stat_profile_to_int_quant_config`` of a profile: JAX's
    configs and TOML bytes."""
    from llm_mixed_q_torch.utils import save_config

    study = create_study(["maximize", "maximize"], get_sampler("random", seed=2))
    space = {"default": dict(SEED_SPACE)}
    study.optimize(lambda t: (MODEL_SAMPLER_MAP["opt"](t, "root", space) and 1.0, 1.0),
                   n_trials=3)
    study.save(tmp_path / "study.pkl")
    for n in ([], ["--trial_number", "2"]):
        args = ["--study", str(tmp_path / "study.pkl")] + n
        got = port_cli.cli_extract_quant_config(args + ["--output", str(tmp_path / "p.toml")])
        want = jax_cli.cli_extract_quant_config(args + ["--output", str(tmp_path / "j.toml")])
        assert got == want
        assert (tmp_path / "p.toml").read_bytes() == (tmp_path / "j.toml").read_bytes()
    jp, tp = _trees("llama")
    profile = _profile("llama", tp, jax_synthetic_cls(96, 16, 16, seed=5))
    save_config(profile, tmp_path / "profile.toml")
    for width in ("8", "6"):
        args = ["--model_arch", "llama", "--stat_profile", str(tmp_path / "profile.toml"),
                "--width", width, "--num_hidden_layers", "2"]
        got = port_cli.cli_transform_stat_profile_to_int_quant_config(
            args + ["--output", str(tmp_path / "p.toml")])
        want = jax_cli.cli_transform_stat_profile_to_int_quant_config(
            args + ["--output", str(tmp_path / "j.toml")])
        assert got == want
        assert (tmp_path / "p.toml").read_bytes() == (tmp_path / "j.toml").read_bytes()
