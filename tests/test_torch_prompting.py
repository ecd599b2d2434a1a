"""The port's prompting eval and prompting searches against the JAX
package, on the CPU at a tiny size (2 layers, hidden 64, vocab 96), with
in-memory examples and a toy whitespace tokenizer (no dataset or tokenizer
file is needed): the task registry, the loglikelihood primitive,
multiple-choice tasks with static and per-example choices, winogrande
style, the few-shot prefix, greedy tasks with and without the serving
stack's ``generate_fn`` (Llama's packed KV cache, OPT's float cache), the
auto batch size and its out-of-memory test, the multi-task mean, the two
prompting searches (2 trials each) and the prompting CLIs.

The same numpy-seeded parameters go through both packages' forwards:
loglikelihoods within rtol 1e-5 (float32 sums in another order),
accuracies, greedy ids and decoded text equal, search artifacts
byte-equal."""

import builtins
import filecmp
import json
import zlib

import jax
import numpy as np
import pytest
import torch

import llm_mixed_q_tpu.cli.evals as jax_evals_cli
import llm_mixed_q_tpu.cli.search_cli as jax_cli
import llm_mixed_q_tpu.eval.prompting as jp_mod
import llm_mixed_q_tpu.search.prompting as jax_search_prompting
from llm_mixed_q_tpu.models import get_config_cls as jax_config_cls
from llm_mixed_q_tpu.models.api import make_forward as jax_make_forward
from llm_mixed_q_tpu.search import SearchIntQuantisationForPromptingCLS as JaxIntPromptSearch
import llm_mixed_q_torch.cli.evals as port_evals_cli
import llm_mixed_q_torch.cli.search_cli as port_cli
import llm_mixed_q_torch.eval.prompting as tp_mod
import llm_mixed_q_torch.search.prompting as port_search_prompting
from llm_mixed_q_torch import models as port_models
from llm_mixed_q_torch.models.api import make_forward
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import llama_for_causal_lm
from llm_mixed_q_torch.search import SearchIntQuantisationForPromptingCLS
from llm_mixed_q_torch.stats.profiler import profile_statistics
from llm_mixed_q_torch.utils import save_config
from test_torch_eval_lm import JAX_INIT, TINY, _hf_llama_flat
from test_torch_search import SEED_SPACE, search_config

BFP6 = "configs/quantization/bfp_6bit.toml"
RTOL = 1e-5


class ToyTokenizer:
    """Whitespace words as ids 2..91 (crc32, the same in every process),
    id 1 as the start token; ``decode`` spells the ids."""

    def __call__(self, text, add_special_tokens=True):
        ids = [1] if add_special_tokens else []
        ids += [2 + zlib.crc32(w.encode()) % 90 for w in text.split()]
        return {"input_ids": ids}

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


TOK = ToyTokenizer()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, quant=None, seed=0):
    """(JAX jitted forward, JAX params, port forward, port params, JAX
    config, port config) of one seeded tiny causal LM."""
    jc = jax_config_cls(arch)(**TINY[arch], quant_config=quant)
    tc = port_models.get_config_cls(arch)(**TINY[arch], quant_config=quant)
    jparams = jax.tree.map(np.asarray, JAX_INIT[arch](jc, task="lm", seed=seed))
    tparams = params_from_jax(jparams, device="cpu")
    jfwd = jax.jit(jax_make_forward(arch, "lm", jc))
    return jfwd, jparams, make_forward(arch, "lm", tc), tparams, jc, tc


@pytest.fixture(scope="module")
def llama():
    return _models("llama")


def _sst(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"sentence": f"example sentence number {i} good {int(rng.integers(9))}",
             "label": int(rng.integers(0, 2))} for i in range(n)]


def _both(fn_name, llama, *args, **kwargs):
    """``fn_name`` of each package's prompting module on its own model."""
    jfwd, jparams, tfwd, tparams = llama[:4]
    want = getattr(jp_mod, fn_name)(jfwd, jparams, TOK, *args, **kwargs)
    got = getattr(tp_mod, fn_name)(tfwd, tparams, TOK, *args, **kwargs)
    return got, want


# -------------------------------------------------------------- the registry

EXAMPLES = {  # one example a task, in its dataset's schema
    "sst": {"sentence": "a fine film", "label": 1},
    "rte": {"sentence1": "it rains", "sentence2": "it is wet", "label": 0},
    "cola": {"sentence": "the the cat", "label": 0},
    "boolq": {"passage": "water is wet", "question": "is water wet", "label": 1},
    "piqa": {"goal": "open a jar", "sol1": "twist the lid", "sol2": "eat the lid", "label": 0},
    "arc_easy": {"question": "what is hot", "choices": {"text": ["ice", "fire"],
                                                         "label": ["A", "B"]},
                 "answerKey": "B"},
    "arc_challenge": {"question": "what is up", "choices": {"text": ["sky", "ground", "sea"],
                                                             "label": ["1", "2", "3"]},
                      "answerKey": "1"},
    "hellaswag": {"ctx": "she picks up the ball", "endings": ["and throws it", "and sleeps"],
                  "label": "0"},
    "openbookqa": {"question_stem": "plants need", "choices": {"text": ["light", "rocks"],
                                                                "label": ["A", "B"]},
                   "answerKey": "A"},
    "winogrande": {"sentence": "the cup fell because _ was light", "option1": "the cup",
                   "option2": "the table", "answer": "1"},
    "lambada": {"text": "the cat sat on the mat"},
}


@pytest.mark.parametrize("task", list(EXAMPLES))
def test_registry_task_matches_jax(task):
    """Each registered task's template gives JAX's few-shot prefix (its
    context, gold continuation and style) and its dataset source."""
    assert set(tp_mod.TASK_TEMPLATES) >= set(EXAMPLES) and set(jp_mod.TASK_TEMPLATES) >= set(
        EXAMPLES)
    ex = EXAMPLES[task]
    got = tp_mod.make_fewshot_prefix(task, [ex, ex, ex], k=2)
    assert got == jp_mod.make_fewshot_prefix(task, [ex, ex, ex], k=2) and got.count("\n\n") == 2
    assert tp_mod.TASK_TEMPLATES[task]["dataset"] == jp_mod.TASK_TEMPLATES[task]["dataset"]
    assert tp_mod.make_fewshot_prefix(task, [ex], k=0) == ""


# ------------------------------------------------------------- the primitives


def test_loglikelihood_batch_matches_jax(llama):
    pairs = [("a b c", " d"), ("the first context here", " yes no"), ("x", " y z w v"),
             (" ".join(f"w{i}" for i in range(60)), " end")]
    (got, got_lens), (want, want_lens) = _both("loglikelihood_batch", llama, pairs)
    np.testing.assert_array_equal(got_lens, want_lens)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    (short, _), (short_want, _) = _both("loglikelihood_batch", llama, pairs, max_length=8)
    np.testing.assert_allclose(short, short_want, rtol=RTOL)


def test_per_example_choices(llama):
    examples = [{"question": f"what is item {i}",
                 "choices": {"text": [f"alpha {i}", f"beta {i}", f"gamma {i}"],
                             "label": ["A", "B", "C"]}, "answerKey": "B"} for i in range(4)]
    got, want = _both("eval_prompting_task", llama, "arc_easy", examples, batch_size=2)
    assert got == want and got["n"] == 4


def test_winogrande_style(llama):
    examples = [{"sentence": f"the thing {i} could not fit because _ was big",
                 "option1": "the thing", "option2": "the box", "answer": str(1 + i % 2)}
                for i in range(3)]
    got, want = _both("eval_prompting_task", llama, "winogrande", examples, batch_size=3)
    assert got == want and got["n"] == 3


def test_fewshot_prefix_and_static_choices(llama):
    examples = _sst(6)
    for k in (0, 2):
        got, want = _both("eval_prompting_task", llama, "sst", examples[:3], batch_size=3,
                          num_fewshot=k, fewshot_examples=examples[3:])
        assert got == want and got["n"] == 3
    got, want = _both("eval_prompting_task", llama, "sst", examples, limit=4, batch_size=3)
    assert got == want and got["n"] == 4


def test_greedy_without_generate_fn(llama):
    """Full-forward argmax appends: JAX's text (with and without a stop
    string) and lambada's exact match."""
    for stop in (None, "t3"):
        got, want = _both("greedy_until", llama, ["some context words", "more"],
                          max_gen_tokens=3, stop=stop)
        assert got == want and got[0]
    got, want = _both("greedy_generate_ids", llama, ["a b", "c d e"], 3)
    np.testing.assert_array_equal(got, want)
    examples = [{"text": "one two three four"}, {"text": "five six seven"}]
    got, want = _both("eval_prompting_task", llama, "lambada", examples, batch_size=1)
    assert got == want and got["n"] == 2


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_greedy_with_serving_generate_fn(arch):
    """``make_serving_generate_fn`` on W6A6 (Llama: its default packed KV
    cache; OPT: its float cache): JAX's greedy ids and text; no
    generate_fn for an arch without a serving stack."""
    jfwd, jparams, tfwd, tparams, jc, tc = _models(arch, BFP6, seed=1)
    from llm_mixed_q_torch import kernels

    jgen = jp_mod.make_serving_generate_fn(arch, jc, jparams)
    tgen = tp_mod.make_serving_generate_fn(arch, tc, tparams)
    ctxs = ["a b c d", "the long context of words here"]
    kernels.reset_launch_counts()
    got = tp_mod.greedy_generate_ids(tfwd, tparams, TOK, ctxs, 4, generate_fn=tgen)
    want = jp_mod.greedy_generate_ids(jfwd, jparams, TOK, ctxs, 4, generate_fn=jgen)
    np.testing.assert_array_equal(got, want)
    # Llama's packed cache of 32 + 4 positions is not tiled by the prob
    # quantizer's block of 16: the dense route, as JAX's decode takes it
    assert kernels.launch_counts()["attn_decode_packed_dense"] == (6 if arch == "llama" else 0)
    assert tp_mod.greedy_until(tfwd, tparams, TOK, ctxs, 4, stop=None, generate_fn=tgen) == \
        jp_mod.greedy_until(jfwd, jparams, TOK, ctxs, 4, stop=None, generate_fn=jgen)
    assert tp_mod.make_serving_generate_fn("bert", tc, tparams) is None


def test_auto_batch_size_and_oom(llama):
    """``batch_size="auto"`` gives JAX's result; the probe halves on the
    card's out-of-memory error and re-raises any other."""
    got, want = _both("eval_prompting_task", llama, "sst", _sst(5), batch_size="auto")
    assert got == want and got["batch_size"] >= 1 and got["n"] == 5
    seen = []

    def run_chunk(chunk):
        seen.append(len(chunk))
        if len(chunk) > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    assert tp_mod._auto_batch_size(run_chunk, list(range(40))) == 4 and seen == [32, 16, 8, 4]
    assert tp_mod._is_oom(RuntimeError("RESOURCE_EXHAUSTED: out of HBM"))
    with pytest.raises(ValueError):
        tp_mod._auto_batch_size(lambda c: (_ for _ in ()).throw(ValueError("bug")), [1, 2])


def test_register_task_and_multi_task_mean(llama):
    toy = {"context": lambda ex: f"value {ex['x']} parity:", "choices": [" even", " odd"],
           "gold": lambda ex: ex["x"] % 2, "dataset": (None, None, None)}
    for mod in (tp_mod, jp_mod):
        mod.register_task("toy_parity", toy)
    examples = {"toy_parity": [{"x": i} for i in range(4)], "sst": _sst(4)}
    got, want = _both("eval_prompting_tasks", llama, ["toy_parity", "sst"], batch_size=2,
                      examples_by_task=examples)
    assert got == want and set(got["results"]) == {"toy_parity", "sst"}
    assert got["mean_acc"] == float(np.mean([r["acc"] for r in got["results"].values()]))


def test_load_task_examples_needs_datasets(monkeypatch):
    """Without HF ``datasets`` a task's split cannot load: ImportError
    naming the package."""
    real_import = builtins.__import__

    def no_datasets(name, *a, **k):
        if name == "datasets":
            raise ImportError("No module named 'datasets'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_datasets)
    with pytest.raises(ImportError, match="datasets"):
        tp_mod.load_task_examples("sst")


# ---------------------------------------------------------- the searches

PROMPT_EXAMPLES = {"sst": _sst(6)}


def _stat_profile(tc, tparams):
    ids = np.random.default_rng(3).integers(2, 96, size=(4, 16))
    batches = [{"input_ids": ids[i:i + 2], "attention_mask": np.ones_like(ids[i:i + 2])}
               for i in (0, 2)]
    return profile_statistics(batches=batches, model_fn=llama_for_causal_lm, config=tc,
                              params=tparams)


def test_conditional_prompting_search_matches_jax(llama, tmp_path):
    """2 trials of ``SearchIntQuantisationForPromptingCLS`` (integer widths,
    frac widths from a stat profile) on in-memory examples, then
    ``evaluate_best_trials_prompting``: JAX's trials, artifacts and
    result. (The block_fp prompting search runs through its CLI below.)"""
    jfwd, jparams, tfwd, tparams, jc, tc = llama
    mck = TINY["llama"]
    space = {"name": ["integer"], "bypass": [False], "data_in_width": [8, 6],
             "weight_width": [8, 6], "bias_width": [8], "data_out_width": [8]}
    profile = _stat_profile(tc, tparams)
    out = []
    for cls, params, d in zip((JaxIntPromptSearch, SearchIntQuantisationForPromptingCLS),
                              (jparams, tparams), ("jax", "port")):
        search = cls("llama", "tiny", search_config(space, False), tmp_path / d, params, TOK,
                     model_config_kwargs=mck, stat_profile=profile)
        study = search.search_prompting(["sst"], 16, examples_by_task=PROMPT_EXAMPLES)
        out.append((study, search.evaluate_best_trials_prompting(
            study, ["sst"], examples_by_task=PROMPT_EXAMPLES)))
    (want, want_best), (got, got_best) = out
    assert [(t.params, t.values, t.state) for t in got.trials] == [
        (t.params, t.values, t.state) for t in want.trials]
    assert got_best == want_best
    for rel in ["search_log.csv", "results.csv", "best_quant_config.toml",
                *(f"best_trials/{p.name}" for p in (tmp_path / "jax" / "best_trials").iterdir())]:
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel, shallow=False), rel


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def llama_checkpoint(tmp_path_factory):
    """A tiny Llama LM checkpoint: config.json and model.safetensors."""
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("prompting_llama")
    (d / "config.json").write_text(json.dumps(
        dict(TINY["llama"], model_type="llama", tie_word_embeddings=False)))
    jc = jax_config_cls("llama")(**TINY["llama"])
    save_file(_hf_llama_flat(jax.tree.map(np.asarray, JAX_INIT["llama"](jc, seed=2))),
              str(d / "model.safetensors"))
    return d


@pytest.fixture
def offline_prompting(monkeypatch):
    """Both packages' prompting CLIs read in-memory SST examples through the
    toy tokenizer; JAX's prompting searches take the checkpoint's widths
    (fault 17's repair, as the port's CLIs do)."""
    for mod in (jax_cli, port_cli, jax_evals_cli, port_evals_cli):
        monkeypatch.setattr(mod, "get_tokenizer", lambda args: TOK)
    for mod in (jp_mod, tp_mod, jax_search_prompting, port_search_prompting):
        monkeypatch.setattr(mod, "load_task_examples", lambda task, which="dataset": _sst(6))

    def at_widths(cls):
        class AtCheckpointWidths(cls):
            def __init__(self, arch, name, *args, **kwargs):
                config = jax_config_cls(arch).from_pretrained(name)
                kwargs["model_config_kwargs"] = port_cli.checkpoint_config_kwargs(config)
                super().__init__(arch, name, *args, **kwargs)
        return AtCheckpointWidths

    for name in ("SearchQuantisationForPromptingCLS", "SearchIntQuantisationForPromptingCLS"):
        monkeypatch.setattr(jax_cli, name, at_widths(getattr(jax_cli, name)))


@pytest.mark.parametrize("cli", ["cli_search_quantisation_on_prompting_cls_tasks",
                                 "cli_conditional_search_quantisation_on_prompting_cls_tasks"])
def test_prompting_search_clis_match_jax(llama_checkpoint, offline_prompting, tmp_path, cli):
    """Both CLIs on one checkpoint: the same trials, artifacts and best
    result; then ``cli_extract_quant_config_and_prompting_eval`` of the
    saved study gives JAX's accuracies."""
    space = SEED_SPACE
    argv = ["--model_arch", "llama", "--model_name", str(llama_checkpoint), "--tasks", "sst",
            "--seq_len", "16", "--limit", "5"]
    if "conditional" in cli:
        space = {"name": ["integer"], "bypass": [False], "data_in_width": [8, 6],
                 "weight_width": [8], "bias_width": [8], "data_out_width": [8]}
        tc = port_models.get_config_cls("llama")(**TINY["llama"])
        tparams = params_from_jax(jax.tree.map(np.asarray, JAX_INIT["llama"](
            jax_config_cls("llama")(**TINY["llama"]), seed=2)), device="cpu")
        save_config(_stat_profile(tc, tparams), tmp_path / "profile.toml")
        argv += ["--stat_profile", str(tmp_path / "profile.toml")]
    save_config(search_config(space, False), tmp_path / "search.toml")
    argv += ["--search_config", str(tmp_path / "search.toml")]
    want = getattr(jax_cli, cli)(argv + ["--save_dir", str(tmp_path / "jax")])
    got = getattr(port_cli, cli)(argv + ["--device", "cpu", "--save_dir", str(tmp_path / "port")])
    assert [(t.params, t.values) for t in got.trials] == [(t.params, t.values)
                                                           for t in want.trials]
    results = sorted(p.name for p in (tmp_path / "port").glob("*.json"))
    for rel in ["search_log.csv", "results.csv", "best_quant_config.toml", *results]:
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel, shallow=False), rel
    if "conditional" in cli:
        return
    extract = ["--model_arch", "llama", "--model_name", str(llama_checkpoint), "--tasks", "sst",
               "--study", str(tmp_path / "port" / "study.pkl"), "--trial_number", "1"]
    want = jax_cli.cli_extract_quant_config_and_prompting_eval(extract)
    got = port_cli.cli_extract_quant_config_and_prompting_eval(extract + ["--device", "cpu"])
    assert got == want and got["results"]["sst"]["n"] == 6


@pytest.mark.parametrize("quant", [None, BFP6])
def test_cli_eval_prompting_cls_matches_jax(llama_checkpoint, offline_prompting, tmp_path, quant):
    """The prompting eval CLI (PTQ-prepared weights when a quant config is
    given): JAX's accuracies, saved as JAX saves them."""
    argv = ["--model_arch", "llama", "--model_name", str(llama_checkpoint), "--tasks", "sst",
            "--batch_size", "4", "--limit", "5"]
    if quant:
        argv += ["--quant_config", quant]
    want = jax_evals_cli.cli_eval_prompting_cls(argv + ["--save_dir", str(tmp_path / "jax")])
    got = port_evals_cli.cli_eval_prompting_cls(argv + ["--device", "cpu", "--save_dir",
                                                        str(tmp_path / "port")])
    assert got == want and got["results"]["sst"]["n"] == 5
    assert json.loads((tmp_path / "port" / "eval_prompting.json").read_text()) == json.loads(
        (tmp_path / "jax" / "eval_prompting.json").read_text())
