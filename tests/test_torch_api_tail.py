"""The last of the JAX package's public surface in the port, on the CPU
against the JAX package:

- ``config.cp_weight_entries_to_bias`` for every arithmetic of
  ``QUANT_ARITH_ENTRIES``, with and without bias keys, strict and not;
- ``ops.quantizers.integer_fraction`` on a grid of widths, frac choices
  and ranges (0.5, powers of two, negative ranges);
- ``ops.functions.BLOCK_LOG_MATMUL_QUANTIZES_Y``, read at call time by
  ``quantized_matmul``, and bound at import by ``ops.attention``: a
  block_log Llama forward, naive and chunked, with the switch flipped in
  one module of each package at a time;
- ``eval_lm_wikitext2(progress_bar=)`` and
  ``StatManager.finalize(show_progress_bar=)``, accepted and ignored;
- ``parallel.distributed.initialize``'s arguments (``_launch_settings``,
  without a process group) and ``batch_spec_hybrid``;
- name parity: every public top-level name of every module of
  ``llm_mixed_q_tpu/`` has a counterpart in the port's module at the same
  path, and every parameter of a public function or method of the same
  name there, but for a list of JAX constructs, each with its stand-in;
  and so has every public top-level name and parameter of the repo's root
  scripts that drive the JAX package (``ROOT_SCRIPTS``:
  ``__graft_entry__.py`` in ``llm_mixed_q_torch.graft_entry``,
  ``quality.py`` in ``llm_mixed_q_torch.quality``), but ``bench.py``,
  which waits for the port's ``benchmark`` PR.

Tolerances: logits within 1e-4 of max|logit| (float32 sums in another
order; ``tests/test_torch_llama.py``; block_log's subnormal departure,
ROADMAP fault 10, stays inside it), losses within 1e-5 relative
(``tests/test_torch_eval_lm.py``); everything else equal."""

import ast
import importlib
import importlib.util
import inspect
from copy import deepcopy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import llm_mixed_q_tpu.ops.attention as jax_attention
import llm_mixed_q_tpu.ops.functions as jax_functions
from llm_mixed_q_tpu.config import cp_weight_entries_to_bias as jax_cp
from llm_mixed_q_tpu.datasets import numpy_dataloader as jax_loader
from llm_mixed_q_tpu.eval.eval_lm import eval_lm_wikitext2 as jax_eval_lm
from llm_mixed_q_tpu.models.api import make_forward as jax_make_forward
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.llama import llama_for_causal_lm as jax_forward
from llm_mixed_q_tpu.ops.quantizers import integer_fraction as jax_integer_fraction
from llm_mixed_q_tpu.parallel.distributed import batch_spec_hybrid as jax_batch_spec_hybrid
from llm_mixed_q_tpu.parallel.distributed import initialize as jax_initialize
from llm_mixed_q_tpu.stats.manager import StatManager as JaxStatManager
import llm_mixed_q_torch.ops.attention as port_attention
import llm_mixed_q_torch.ops.functions as port_functions
from llm_mixed_q_torch.config import QUANT_ARITH_ENTRIES, cp_weight_entries_to_bias
from llm_mixed_q_torch.datasets import make_synthetic_lm_dataset, numpy_dataloader
from llm_mixed_q_torch.eval import eval_lm_wikitext2
from llm_mixed_q_torch.models.api import make_forward
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig, llama_for_causal_lm
from llm_mixed_q_torch.ops.quantizers import integer_fraction
from llm_mixed_q_torch.parallel import distributed
from llm_mixed_q_torch.stats.manager import StatManager

ROOT = Path(__file__).resolve().parent.parent
BLOCK_LOG = "configs/quantization/block_log.toml"
TINY = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
TOL = 1e-4  # of max|logit|
SWITCH = "BLOCK_LOG_MATMUL_QUANTIZES_Y"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- cp_weight_entries_to_bias ------------------------------------------

def _node(arith, bias):
    """A node config with every weight and data_in key of ``arith`` (lists
    among the values, so that a copy must be deep), and with ``bias`` its
    bias keys too, valued apart from the weight's."""
    entries = QUANT_ARITH_ENTRIES[arith]
    config = {"name": arith}
    for i, key in enumerate(entries["weight_entries"] + entries["data_in_entries"]):
        config[key] = [1, 16] if key.endswith("block_size") else 4 + i
    if bias:
        for i, key in enumerate(entries["bias_entries"]):
            config[key] = [1, 8] if key.endswith("block_size") else 20 + i
    return config


@pytest.mark.parametrize("bias", [True, False], ids=["bias_keys", "no_bias_keys"])
@pytest.mark.parametrize("arith", list(QUANT_ARITH_ENTRIES))
def test_cp_weight_entries_to_bias_matches_jax(arith, bias):
    config = _node(arith, bias)
    # not strict: a weight key missing (and its bias key, where there are
    # bias keys) is skipped; strict: it raises KeyError in both packages
    missing = QUANT_ARITH_ENTRIES[arith]["weight_entries"][0]
    partial = {k: v for k, v in config.items()
               if k not in (missing, missing.replace("weight", "bias"))}
    for src, strict in ((config, True), (config, False), (partial, False)):
        got, want = {"name": arith}, {"name": arith}
        cp_weight_entries_to_bias(src, got, arith, strict)
        jax_cp(deepcopy(src), want, arith, strict)
        assert got == want
        for key, value in got.items():
            if isinstance(value, list):
                assert value is not src.get(key), key  # a copy
    with pytest.raises(KeyError):
        cp_weight_entries_to_bias(partial, {}, arith, True)
    with pytest.raises(KeyError):
        jax_cp(partial, {}, arith, True)


# ---- integer_fraction -----------------------------------------------------

RANGES = [(0.0, 0.0), (-0.5, 0.5), (0.0, 0.5), (-0.25, 0.1), (-1.0, 1.0), (0.0, 2.0),
          (-4.0, 3.0), (-3.99, 1.0), (-8.0, -2.0), (-1e-3, 1e-3), (-0.75, 0.0), (-64.0, 64.0),
          (-100.5, 3.0), (0.3, 1.7)]
FRACS = [list(range(17)), [0, 2, 4, 6, 8], [3, 5], [0]]


@pytest.mark.parametrize("width", [2, 4, 8, 16])
def test_integer_fraction_matches_jax(width):
    for frac_choices in FRACS:
        for lo, hi in RANGES:
            try:
                want = jax_integer_fraction(width, frac_choices, lo, hi)
            except ValueError:  # no choice fits: both take max of nothing
                with pytest.raises(ValueError):
                    integer_fraction(width, frac_choices, lo, hi)
                continue
            assert integer_fraction(width, frac_choices, lo, hi) == want, (frac_choices, lo, hi)


# ---- BLOCK_LOG_MATMUL_QUANTIZES_Y -----------------------------------------

@pytest.fixture(scope="module")
def block_log_tree():
    jp = jax_init(JaxConfig(**TINY, quant_config=BLOCK_LOG), seed=0)
    ids = np.random.default_rng(5).integers(2, TINY["vocab_size"], size=(2, 32)).astype(np.int32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), ids


def _both_forwards(block_log_tree, chunk):
    """(port, JAX) logits of the block_log forward, attention naive (chunk
    None) or chunked; JAX traced anew, so that it reads the switches as they
    are now."""
    jp, tp, ids = block_log_tree
    jc = JaxConfig(**TINY, quant_config=BLOCK_LOG, attention_chunk=chunk)
    tc = LlamaQuantizedConfig(**TINY, quant_config=BLOCK_LOG, attention_chunk=chunk)
    want = np.asarray(jax.jit(lambda p, i: jax_forward(p, i, None, config=jc)["logits"])(jp, ids))
    got = llama_for_causal_lm(tp, torch.from_numpy(ids.astype(np.int64)), None,
                              config=tc)["logits"].numpy()
    return got, want


@pytest.mark.parametrize("module", ["functions", "attention"])
def test_block_log_switch_flipped_in_one_module(block_log_tree, module, monkeypatch):
    """Flipping the switch in ``ops.functions`` changes the naive attention
    (``quantized_matmul`` reads it at each call) and not the chunked one
    (``ops.attention`` bound it at import); flipping it in ``ops.attention``
    the reverse. Each package does the same, within the tolerance."""
    off = {chunk: _both_forwards(block_log_tree, chunk) for chunk in (None, 16)}
    monkeypatch.setattr({"functions": port_functions, "attention": port_attention}[module],
                        SWITCH, True)
    monkeypatch.setattr({"functions": jax_functions, "attention": jax_attention}[module],
                        SWITCH, True)
    changed = {None: module == "functions", 16: module == "attention"}
    for chunk, (got, want) in ((c, _both_forwards(block_log_tree, c)) for c in (None, 16)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)
        moved = np.abs(got - off[chunk][0]).max() / scale
        assert (moved > 1e-3) == changed[chunk], (chunk, moved)


def test_block_log_switch_defaults_off():
    assert getattr(port_functions, SWITCH) is getattr(jax_functions, SWITCH) is False
    assert getattr(port_attention, SWITCH) is getattr(jax_attention, SWITCH) is False


# ---- the ignored progress bars -------------------------------------------

def test_eval_lm_takes_progress_bar():
    jc = JaxConfig(**TINY, quant_config="configs/quantization/bfp_6bit.toml")
    tc = LlamaQuantizedConfig(**TINY, quant_config="configs/quantization/bfp_6bit.toml")
    jp = jax.tree.map(np.asarray, jax_init(jc, seed=1))
    ds = make_synthetic_lm_dataset(TINY["vocab_size"], 16, 4, seed=11)
    want = jax_eval_lm(jax_make_forward("llama", "lm", jc, with_labels=True), jp,
                       jax_loader(ds, 2), progress_bar=True)
    got = {bar: eval_lm_wikitext2(make_forward("llama", "lm", tc, with_labels=True),
                                  params_from_jax(jp, device="cpu"), numpy_dataloader(ds, 2),
                                  progress_bar=bar) for bar in (True, False)}
    assert got[True] == got[False]
    np.testing.assert_allclose(got[True]["loss"], want["loss"], rtol=1e-5)


def test_finalize_takes_show_progress_bar():
    w = np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32)
    port = StatManager(("range_min_max",), ("range_min_max",))
    ref = JaxStatManager(("range_min_max",), ("range_min_max",))
    port.update_weight("w", torch.from_numpy(w))
    ref.update_weight("w", w)
    got = port.finalize(show_progress_bar=True)
    assert got == port.finalize() == ref.finalize(show_progress_bar=True)


# ---- initialize's arguments and the hybrid batch spec --------------------

TORCHRUN = {"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4",
            "MASTER_ADDR": "10.1.2.3", "MASTER_PORT": "29400"}
LAUNCH = {
    "nothing": ({}, {}, {"world": 1, "local_world": 1}),
    "torchrun": ({}, TORCHRUN, {"world": 8, "local_world": 4, "rank": 5, "local_rank": 1,
                                "init_method": "tcp://10.1.2.3:29400"}),
    # every argument wins over its variable; the local rank follows the rank
    "arguments": (dict(coordinator_address="node0:1234", num_processes=4, process_id=3,
                       local_device_count=2), TORCHRUN,
                  {"world": 4, "local_world": 2, "rank": 3, "local_rank": 1,
                   "init_method": "tcp://node0:1234"}),
    "arguments_alone": (dict(num_processes=2, process_id=0), {},
                        {"world": 2, "local_world": 2, "rank": 0, "local_rank": 0,
                         "init_method": "tcp://localhost:29500"}),
}


@pytest.mark.parametrize("case", list(LAUNCH))
def test_initialize_arguments_map_as_stated(case):
    kwargs, env, want = LAUNCH[case]
    assert distributed._launch_settings(**kwargs, env=env) == want


def test_initialize_alone_is_one_process_and_records_the_host_size(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(distributed, "_HOST_SIZE", None)
    assert distributed.initialize() == jax_initialize() == 1
    assert distributed._host_size() == 1
    assert distributed.initialize(local_device_count=2) == 1
    assert distributed._host_size() == 2


def test_batch_spec_hybrid_is_jax_spec():
    assert distributed.batch_spec_hybrid() == tuple(jax_batch_spec_hybrid()) == (("dcn", "data"),)


# ---- name parity ----------------------------------------------------------

JAX_ROOT = ROOT / "llm_mixed_q_tpu"
_PALLAS = "a Pallas wrapper; its Hopper kernel's wrapper stands in"
# (module, name): (the port's stand-in in the same module, why)
NAME_EXCEPTIONS = {
    ("kernels", "bfp_matmul_pallas"): ("bfp_matmul_cuda", _PALLAS),
    ("kernels", "bfp_matmul_subbyte_pallas"): ("bfp_matmul_subbyte_cuda", _PALLAS),
    ("kernels.dequant_matmul", "bfp_matmul_pallas"): ("bfp_matmul_cuda", _PALLAS),
    ("kernels.dequant_matmul", "bfp_matmul_subbyte_pallas"): ("bfp_matmul_subbyte_cuda", _PALLAS),
    ("kernels.dequant_matmul", "bfp_matmul_subbyte_t_pallas"): ("bfp_matmul_subbyte_t_cuda",
                                                                _PALLAS),
    ("kernels.attention_decode", "packed_attention_decode"): ("packed_attention_decode_cuda",
                                                              _PALLAS),
    ("kernels.attention_decode", "packed_attention_decode_batch"): (
        "packed_attention_decode_batch_cuda", _PALLAS),
    ("kernels.attention_decode", "attention_kernel_ok"): (
        "attention_kernel_error",
        "the gate of JAX's kernel; the port's kernels' limits say why they refuse a cache "
        "(and reference_kernel_error why JAX's does)"),
    ("models.pack_common", "StaticTuple"): (
        "pack_fused_nodes",
        "a pytree node that keeps a fused node's splits static under jit; with no tracing "
        "the port's splits are a plain tuple, which pack_fused_nodes makes"),
    ("stats.capture", "TracingTapCollector"): (
        "StatTapRouter",
        "collects the taps as tracers in one jit trace; the port's taps stream each tensor "
        "into the statistics as the forward runs"),
}
# (module, function, parameter): why the port has none
PARAM_EXCEPTIONS = {
    ("kernels.dequant_matmul", "bfp_matmul", "use_pallas"): "the route follows the device",
    ("kernels.dequant_matmul", "bfp_matmul", "interpret"): "Pallas's interpret mode: a CPU "
                                                           "tensor takes the plain version",
    ("kernels.packing", "transpose_subbyte", "xp"): "numpy or jax.numpy; the port takes "
                                                    "torch tensors",
    ("models.api", "make_forward", "jit"): "no jit in PyTorch",
    ("models.llama.modeling", "make_causal_mask", "dtype"): "the mask is float32, as JAX's "
                                                            "default",
    ("parallel.distributed", "make_hybrid_mesh", "devices"): "ranks, not devices, make a "
                                                             "mesh; device_type stands in",
    ("parallel.mesh", "make_mesh", "devices"): "ranks, not devices, make a mesh; device_type "
                                               "stands in",
}


def _modules():
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = path.relative_to(JAX_ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _public_names(path):
    """A module's public top-level names: its defs, classes and
    assignments, and in a package's ``__init__`` what it re-exports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and node.level and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _public_functions(path):
    """{name or Class.method: parameter names} of a module's public
    functions and its classes' public methods and ``__init__`` (a
    property's getter, not its setter)."""
    out = {}

    def params(fn):
        a = fn.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                setter = any(isinstance(d, ast.Attribute) and d.attr == "setter"
                             for d in getattr(sub, "decorator_list", ()))
                if isinstance(sub, ast.FunctionDef) and not setter and (
                        sub.name == "__init__" or not sub.name.startswith("_")):
                    out[f"{node.name}.{sub.name}"] = params(sub)
    return out


def _port(module):
    return importlib.import_module("llm_mixed_q_torch" + (f".{module}" if module else ""))


def test_every_public_name_has_a_counterpart():
    missing = []
    for module, path in _modules():
        port = _port(module)
        for name in sorted(_public_names(path)):
            if (module, name) in NAME_EXCEPTIONS:
                standin, _ = NAME_EXCEPTIONS[module, name]
                assert not hasattr(port, name) and hasattr(port, standin), (module, name)
            elif not hasattr(port, name):
                missing.append(f"{module}:{name}")
    assert not missing, missing
    for module, name in NAME_EXCEPTIONS:  # the list names only what JAX has
        assert name in _public_names(dict(_modules())[module]), (module, name)


# the repo's root scripts that drive the JAX package: their counterparts in
# the port, or why there is none yet (``chip_smoke.py`` is the port's own)
ROOT_SCRIPTS = {"__graft_entry__": "graft_entry", "quality": "quality"}
ROOT_SCRIPT_EXCEPTIONS = {"bench": "the benchmark, ported in the `benchmark` PR"}


def test_every_root_script_is_ported_or_excepted():
    scripts = {p.stem for p in ROOT.glob("*.py")} - {"chip_smoke"}
    assert scripts == set(ROOT_SCRIPTS) | set(ROOT_SCRIPT_EXCEPTIONS)
    for name in ROOT_SCRIPT_EXCEPTIONS:
        assert importlib.util.find_spec(f"llm_mixed_q_torch.{name}") is None


@pytest.mark.parametrize("script", list(ROOT_SCRIPTS))
def test_every_public_name_of_a_root_script_has_a_counterpart(script):
    path = ROOT / f"{script}.py"
    port = _port(ROOT_SCRIPTS[script])
    names = _public_names(path)
    assert names and not [n for n in sorted(names) if not hasattr(port, n)]
    for qualname, params in _public_functions(path).items():
        have = inspect.signature(getattr(port, qualname)).parameters
        assert not [p for p in params if p not in have], qualname


def test_every_parameter_has_a_counterpart():
    missing = []
    for module, path in _modules():
        port = _port(module)
        for qualname, params in _public_functions(path).items():
            if (module, qualname.split(".")[0]) in NAME_EXCEPTIONS:
                continue
            obj = port
            for part in qualname.split("."):
                raw = inspect.getattr_static(obj, part)
                obj = raw.fget if isinstance(raw, property) else getattr(obj, part)
            have = inspect.signature(obj).parameters
            for p in params:
                if p in ("self", "cls") or p in have:
                    continue
                if (module, qualname, p) not in PARAM_EXCEPTIONS:
                    missing.append(f"{module}:{qualname}({p})")
    assert not missing, missing
