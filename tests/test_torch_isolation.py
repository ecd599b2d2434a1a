"""The port stands alone: with ``jax`` and ``llm_mixed_q_tpu`` blocked from
import, it imports (chip_smoke.py and the probes of
``llm_mixed_q_torch.tools`` included) and runs Llama and OPT generation and
the six probe entry points on the CPU."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r'''
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "llm_mixed_q_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "llm_mixed_q_tpu"):
        del sys.modules[mod]

import pkgutil
import numpy as np
import torch
import llm_mixed_q_torch
import chip_smoke  # noqa: F401  (imports only; main() needs a card)
for info in pkgutil.walk_packages(llm_mixed_q_torch.__path__, "llm_mixed_q_torch."):
    __import__(info.name)

from llm_mixed_q_torch.models.hf_loader import init_llama_params
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig, generate

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
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "llm_mixed_q_tpu")]
print("ISOLATED-OK")
'''


def test_port_imports_and_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED-OK" in res.stdout
