"""The port stands alone: with ``jax``, ``llm_mixed_q_tpu`` and the repo's
root scripts that drive it (``quality``, ``__graft_entry__``) blocked from
import, it imports (chip_smoke.py, the probes of ``llm_mixed_q_torch.tools``
and the ``cli``, ``datasets``, ``eval`` and ``train`` subpackages included)
and runs Llama and OPT generation, the perplexity path under the new
arithmetics with chunked attention, a QAT step of an OPT classifier, and
the eight probe entry points on the CPU, a packed BERT classifier, an
incremental Llama decode step (``make_prefill_and_decode``), a statistic
profile with its integer config, a memory density, and a prompting search
with its best trial's eval; ``parallel/`` and the EMNLP drivers import,
and the perplexity driver runs a CI-scale arm; ``graft_entry`` and
``quality`` import, and ``entry()``'s forward runs."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r'''
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "llm_mixed_q_tpu", "quality", "__graft_entry__")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]

import pkgutil
import numpy as np
import torch
import llm_mixed_q_torch
import chip_smoke  # noqa: F401  (imports only; main() needs a card)
for info in pkgutil.walk_packages(llm_mixed_q_torch.__path__, "llm_mixed_q_torch."):
    __import__(info.name)
assert {"llm_mixed_q_torch.cli.evals", "llm_mixed_q_torch.datasets.wikitext2",
        "llm_mixed_q_torch.eval.eval_lm", "llm_mixed_q_torch.ops.attention",
        "llm_mixed_q_torch.train.qat", "llm_mixed_q_torch.cli.train_cli",
        "llm_mixed_q_torch.eval.eval_cls", "llm_mixed_q_torch.eval.metrics",
        "llm_mixed_q_torch.datasets.glue", "llm_mixed_q_torch.models.bert.modeling",
        "llm_mixed_q_torch.models.bert.quant_config",
        "llm_mixed_q_torch.native.loader", "llm_mixed_q_torch.stats.profiler",
        "llm_mixed_q_torch.stats.capture", "llm_mixed_q_torch.costmodel.models",
        "llm_mixed_q_torch.cli.profile_statistics", "llm_mixed_q_torch.config.stat_to_int",
        "llm_mixed_q_torch.config.sampler", "llm_mixed_q_torch.utils.dict_tools",
        "llm_mixed_q_torch.search.engine", "llm_mixed_q_torch.search.search",
        "llm_mixed_q_torch.search.conditional", "llm_mixed_q_torch.search.prompting",
        "llm_mixed_q_torch.search.samplers_model", "llm_mixed_q_torch.eval.prompting",
        "llm_mixed_q_torch.utils.trial_extractor",
        "llm_mixed_q_torch.cli.search_cli", "llm_mixed_q_torch.parallel.mesh",
        "llm_mixed_q_torch.parallel.sharding", "llm_mixed_q_torch.parallel.distributed",
        "llm_mixed_q_torch.parallel.tp", "llm_mixed_q_torch.experiments.emnlp.common",
        "llm_mixed_q_torch.experiments.emnlp.section_1_variance",
        "llm_mixed_q_torch.experiments.emnlp.section_4_2_perplexity",
        "llm_mixed_q_torch.experiments.emnlp.section_4_2_downstream",
        "llm_mixed_q_torch.experiments.emnlp.section_4_3_qat",
        "llm_mixed_q_torch.experiments.emnlp.section_4_4_search",
        "llm_mixed_q_torch.graft_entry", "llm_mixed_q_torch.quality"} <= set(sys.modules)
from llm_mixed_q_torch.graft_entry import entry

fn, args = entry(device="cpu")
assert fn(*args).shape == (2, 64, 256)

import tempfile
from llm_mixed_q_torch.experiments.emnlp import section_4_2_perplexity
from llm_mixed_q_torch.parallel import make_mesh, shard_params

mesh = make_mesh()
assert mesh.size == 1

with tempfile.TemporaryDirectory() as d:
    rows = section_4_2_perplexity.main(["--synthetic", "--device", "cpu", "--save_dir", d,
                                        "--arms", "fp32", "--seq_len", "16", "--num_samples",
                                        "2"])
assert rows[0]["arm"] == "fp32" and np.isfinite(rows[0]["perplexity"])

from llm_mixed_q_torch.models.api import make_forward, make_prefill_and_decode
from llm_mixed_q_torch.models.bert import BertQuantizedConfig, pack_bert_params
from llm_mixed_q_torch.models.hf_loader import init_bert_params, init_llama_params
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig

bcfg = BertQuantizedConfig(vocab_size=64, hidden_size=64, num_hidden_layers=1,
                           num_attention_heads=4, intermediate_size=128,
                           quant_config="configs/quantization/bfp_4bit.toml")
bp = pack_bert_params(init_bert_params(bcfg, seed=0, device="cpu"), bcfg, device="cpu")
logits = make_forward("bert", "cls", bcfg, quantize_weights=False)(
    bp, torch.tensor([[3, 4, 5, 6]]))["logits"]
assert logits.shape == (1, 2) and bool(torch.isfinite(logits).all())
lcfg = LlamaQuantizedConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=1, num_attention_heads=2,
                            quant_config="configs/quantization/bfp_6bit.toml")
prefill, decode = make_prefill_and_decode("llama", "lm", lcfg)
lp = init_llama_params(lcfg, seed=0, device="cpu")
_, kvs = prefill(lp, torch.tensor([[3, 4, 5]]), torch.ones(1, 3, dtype=torch.int64))
step, kvs = decode(lp, torch.tensor([[6]]), torch.ones(1, 4, dtype=torch.int64), kvs)
assert step.shape == (1, 1, 64) and kvs[0][0].shape[2] == 4

from llm_mixed_q_torch.datasets import make_synthetic_cls_dataset, numpy_dataloader
from llm_mixed_q_torch.models.hf_loader import init_opt_params as init_opt
from llm_mixed_q_torch.models.opt import OPTQuantizedConfig as OptConfig
from llm_mixed_q_torch.train import train_qat

cfg = OptConfig(vocab_size=64, hidden_size=64, ffn_dim=128, num_hidden_layers=1,
                num_attention_heads=4, word_embed_proj_dim=32, do_layer_norm_before=False,
                quant_config="configs/quantization/bfp_4bit.toml")
p0 = init_opt(cfg, task="cls", seed=0, device="cpu")
p1, hist = train_qat("opt", "cls", cfg, p0,
                     lambda: numpy_dataloader(make_synthetic_cls_dataset(64, 16, 2), 2),
                     learning_rate=1e-3, steps_per_epoch=1)
assert np.isfinite(hist[0]["loss"]) and not torch.equal(p1["score"]["weight"], p0["score"]["weight"])

from llm_mixed_q_torch.datasets import make_synthetic_lm_dataset, numpy_dataloader
from llm_mixed_q_torch.eval import eval_lm_wikitext2
from llm_mixed_q_torch.models import get_config_cls, get_ptq_preparer
from llm_mixed_q_torch.models.api import make_forward

for toml in ("block_minifloat", "log", "minifloat_denorm"):
    cfg = get_config_cls("llama")(vocab_size=64, hidden_size=64, intermediate_size=128,
                                  num_hidden_layers=1, num_attention_heads=2, attention_chunk=16,
                                  quant_config=f"configs/quantization/{toml}.toml")
    from llm_mixed_q_torch.models.hf_loader import init_llama_params
    p = get_ptq_preparer("llama")(init_llama_params(cfg, seed=0, device="cpu"), cfg)
    res = eval_lm_wikitext2(make_forward("llama", "lm", cfg, quantize_weights=False, with_labels=True),
                            p, numpy_dataloader(make_synthetic_lm_dataset(64, 40, 2), 1))
    assert np.isfinite(res["loss"]) and res["num_sequences"] == 2

from llm_mixed_q_torch.models.hf_loader import init_llama_params
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig, generate
from llm_mixed_q_torch.models.llama import llama_for_causal_lm as llama_for_causal_lm_

config = LlamaQuantizedConfig(vocab_size=64, hidden_size=128, intermediate_size=256,
                              num_hidden_layers=1, num_attention_heads=1,
                              quant_config="configs/quantization/bfp_6bit.toml")
params = init_llama_params(config, seed=0, device="cpu",
                           pack=dict(subbyte=True, bf16_embed=True))
out = generate(params, config, np.array([[3, 4, 5]]), max_new_tokens=2, device="cpu")
assert out.shape == (1, 2)

from llm_mixed_q_torch.models.hf_loader import init_opt_params
from llm_mixed_q_torch.models.opt import OPTQuantizedConfig, opt_for_causal_lm, opt_generate

opt_config = OPTQuantizedConfig(vocab_size=64, hidden_size=64, ffn_dim=128,
                                num_hidden_layers=1, num_attention_heads=4,
                                quant_config="configs/quantization/bfp_6bit.toml")
opt_params = init_opt_params(opt_config, seed=0, device="cpu", pack=dict(subbyte=True))
logits = opt_for_causal_lm(opt_params, torch.tensor([[3, 4, 5]]), config=opt_config)["logits"]
assert logits.shape == (1, 3, 64) and bool(torch.isfinite(logits).all())
out = opt_generate(opt_params, opt_config, np.array([[3, 4, 5]]), max_new_tokens=2,
                   device="cpu")
assert out.shape == (1, 2)
from llm_mixed_q_torch.config import transform_stat_profile_to_int_quant_config
from llm_mixed_q_torch.costmodel.profiler import compute_memory_density
from llm_mixed_q_torch.models import get_model_profiler, get_stat_config_formatter
from llm_mixed_q_torch.stats import profile_statistics

lcfg = LlamaQuantizedConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=1, num_attention_heads=2)
prof = profile_statistics(batches=[{"input_ids": np.array([[3, 4, 5, 6]]),
                                    "attention_mask": np.ones((1, 4), np.int64)}],
                          model_fn=llama_for_causal_lm_, config=lcfg,
                          params=init_llama_params(lcfg, seed=0, device="cpu"))
assert len(prof) == 17
qc = get_stat_config_formatter("llama")(
    transform_stat_profile_to_int_quant_config(prof, "range_min_max", width=8), 1)
assert qc["model_layer_0"]["self_attn"]["matmul_0"]["name"] == "integer"
bcfg = LlamaQuantizedConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=1, num_attention_heads=2,
                            quant_config="configs/quantization/bfp_6bit.toml")
assert 4.5 < compute_memory_density(get_model_profiler("llama")(bcfg, 64)) < 5.0
from llm_mixed_q_torch.tools import aprobe, ksub

assert "llm_mixed_q_torch.tools.timing" in sys.modules
res = ksub.run({"tiny": (64, 700)}, device="cpu", log=lambda *a: None)
assert set(res["tiny"]["transposed"]) == set(ksub.LADDER) | {"production"}
res = aprobe.run(batch=1, s_len=4, device="cpu", log=lambda *a: None)
assert "quant/bf16" in res and "K4" in res
from llm_mixed_q_torch.tools import kvariants, kvariants2

res = kvariants.run({"tiny": (64, 700)}, device="cpu", log=lambda *a: None)
assert set(res["tiny"]["lane_major"]) == {"production", "v2", "v3"}
res = kvariants2.run({"tiny": (64, 700)}, device="cpu", log=lambda *a: None)
assert set(res["tiny"]["int8"]) == {"K2", "int8_f32s", "int8_bf16s"}
assert set(res["tiny"]["transposed"]) == {"production", "v4_f32s", "v4_bf16s"}
from llm_mixed_q_torch.tools import kprobe, ktune7b

res = kprobe.run({"tiny": (64, 700)}, device="cpu", log=lambda *a: None)
assert set(res["tiny"]["sub"]) == {"c32_t1", "c16_t1", "c8_t1", "c64_t1", "K3", "K3_actq"}
res = ktune7b.run({"tiny": (64, 1300)}, device="cpu", log=lambda *a: None)
assert set(res["tiny"]["int8"]) == set(ktune7b.INT8_INSTANCES) | {"K2", "K2_actq"}
from llm_mixed_q_torch.tools import k3, kexp

res = k3.run(batch=1, device="cpu", log=lambda *a: None)
assert set(res) == {"K4", "v2_dots", "v2_softmax", "v2_qmax", "v2_qmath", "v2_full", "v3_masks"}
res = kexp.run(l=256, b=1, device="cpu", log=lambda *a: None)
assert set(res) == set(kexp.ALIASES)
import tempfile
from llm_mixed_q_torch.eval.prompting import eval_prompting_tasks
from llm_mixed_q_torch.search import SearchQuantisationForPromptingCLS

tok = lambda text, add_special_tokens=True: {"input_ids": [1] * add_special_tokens + [
    2 + len(w) for w in text.split()]}
space = {"default": {"name": ["block_fp"], "bypass": ["!ast!False"], "weight_width": [6, 4],
                     "weight_exponent_width": [8], "weight_exponent_bias": ["!ast!None"],
                     "weight_block_size": ["!ast![1, 16]"], "data_in_width": [6],
                     "data_in_exponent_width": [8], "data_in_exponent_bias": ["!ast!None"],
                     "data_in_block_size": ["!ast![1, 16]"], "bias_width": [6],
                     "bias_exponent_width": [8], "bias_exponent_bias": ["!ast!None"],
                     "bias_block_size": ["!ast![1, 16]"]}}
sc = {"search_strategy": {"n_trials": 2, "sampler": "tpe", "seed": 0, "accuracy_threshold": 0,
                          "avg_bitwidth_threshold": 0},
      "search_estimator": {"alpha_accuracy": 1.0, "alpha_memory_density": 0.1, "alpha_fps": 0,
                           "alpha_fps_per_lut": 0, "compare_to": 32},
      "search_space": {"quant_config_seed": space}}
mck = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
           num_attention_heads=2)
examples = {"sst": [{"sentence": f"a b {i}", "label": i % 2} for i in range(4)]}
with tempfile.TemporaryDirectory() as d:
    search = SearchQuantisationForPromptingCLS(
        "llama", "tiny", sc, d, init_llama_params(LlamaQuantizedConfig(**mck), seed=0,
                                                  device="cpu"), tok, model_config_kwargs=mck)
    study = search.search_prompting(["sst"], 16, examples_by_task=examples)
    best = search.evaluate_best_trials_prompting(study, ["sst"], examples_by_task=examples)
assert len(study.trials) == 2 and 0 <= best["mean_acc"] <= 1
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("ISOLATED-OK")
'''


def test_port_imports_and_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout
