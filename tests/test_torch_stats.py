"""The port's statistic profiling against the JAX package, on the CPU at a
tiny size (2 layers, hidden 64): the five reducers with their ``dims`` and
``abs`` cases on the same numpy samples, the manager's once-per-weight
guard, the stat tap of ``quantized_linear`` and its context,
``make_tapped_forward``, ``profile_statistics`` of Llama, OPT and BERT
(the ``model_fn`` path, the CLI's, and the eager ``forward_fn`` path), the
packed-tree ``TypeError``, the stat -> integer config -> formatter ->
parser -> forward chain of each family, and both statistics CLIs with the
checkpoint and the datasets of the eval tests.

Tolerances. The reducers on identical inputs: min, max, range, counts,
outlier counts and recorded data equal; means and variances within rtol
1e-5 (float32 sums in another order), a mean also within 1e-6 of the
samples' max|x| where its terms cancel. Profiles through the two forwards
(which differ by ~1e-6 relative): counts equal, min and max within 1e-5 of
the entry's max|.|, variances within rtol 1e-4 and means within 1e-4 of
|mean| + the entry's standard deviation. Integer configs derived from the
same profile dict are equal; forwards under them within 1e-4 of
max|logit|."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_mixed_q_tpu.cli.profile_statistics as jax_cli
import llm_mixed_q_tpu.config as jax_config
import llm_mixed_q_tpu.models as jax_models
import llm_mixed_q_tpu.ops.linear as jax_linear
from llm_mixed_q_tpu.datasets import make_synthetic_cls_dataset, numpy_dataloader
from llm_mixed_q_tpu.models.api import make_forward as jax_make_forward
from llm_mixed_q_tpu.models.hf_loader import init_bert_params as jax_init_bert
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init_llama
from llm_mixed_q_tpu.models.hf_loader import init_opt_params as jax_init_opt
from llm_mixed_q_tpu.stats import StatManager as JaxStatManager
from llm_mixed_q_tpu.stats import create_new_stat as jax_create_stat
from llm_mixed_q_tpu.stats import profile_statistics as jax_profile
from llm_mixed_q_tpu.stats.capture import make_tapped_forward as jax_tapped_forward
from llm_mixed_q_tpu.utils import load_config as jax_load_config
import llm_mixed_q_torch.cli.profile_statistics as port_cli
import llm_mixed_q_torch.config as port_config
import llm_mixed_q_torch.models as port_models
from llm_mixed_q_torch.kernels import pack_block_fp
from llm_mixed_q_torch.models.api import make_forward
from llm_mixed_q_torch.models.hf_loader import init_llama_params, params_from_jax
from llm_mixed_q_torch.ops import linear
from llm_mixed_q_torch.stats import (
    StatManager,
    create_new_stat,
    make_tapped_forward,
    profile_statistics,
)
from llm_mixed_q_torch.utils import convert_str_na_to_none, load_config, save_config

SEQ = 16
TINY = {
    "llama": dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=2, max_position_embeddings=128),
    "opt": dict(vocab_size=96, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128),
    "bert": dict(vocab_size=96, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64),
}
TASK = {"llama": "lm", "opt": "lm", "bert": "cls"}
JAX_INIT = {"llama": jax_init_llama, "opt": jax_init_opt, "bert": jax_init_bert}
# entries a layer: llama 3 * 3 + 4 * 2, opt 3 * 4 + 3 * 3, bert the same as opt
ENTRIES_A_LAYER = {"llama": 17, "opt": 21, "bert": 21}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(vocab, n=4, batch_size=2, seed=0):
    """Right-padded rows: the CLI's batches, input_ids and attention_mask."""
    data = make_synthetic_cls_dataset(vocab, SEQ, n, seed=seed)
    return list(numpy_dataloader(data, batch_size=batch_size))


# ------------------------------------------------------------------ reducers

REDUCER_CASES = [
    ("record", {}),
    ("record", {"add_new_dim_before_concat": True}),
    ("variance_online", {"dims": "all"}),
    ("variance_online", {"dims": None}),
    ("variance_online", {"dims": [1]}),
    ("variance_online", {"dims": [2, 1]}),
    ("variance_precise", {"dims": "all"}),
    ("variance_precise", {"dims": None}),
    ("variance_precise", {"dims": [1]}),
    ("range_min_max", {"dims": "all"}),
    ("range_min_max", {"dims": "all", "abs": True}),
    ("range_min_max", {"dims": None}),
    ("range_min_max", {"dims": [1], "abs": True}),
    ("threshold_count", {"threshold": 1.5}),
    ("threshold_count", {"threshold": 1.5, "dims": [1]}),
]


def _samples(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, 5, 6)) * 2 + 0.3).astype(np.float32) for _ in range(n)]


def _assert_export(got, want, name, scale):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, (name, got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_export(got[k], want[k], k, scale)
    elif isinstance(want, float) and name in ("mean", "variance"):
        tol = 1e-5 * abs(want) + (1e-6 * scale if name == "mean" else 0)
        assert abs(got - want) <= tol, (name, got, want)
    elif isinstance(want, list) and name in ("mean", "variance"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    else:
        assert got == want, (name, got, want)


@pytest.mark.parametrize("stat,kw", REDUCER_CASES,
                         ids=[f"{s}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for s, kw in REDUCER_CASES])
def test_reducer_matches_jax(stat, kw):
    """The same numpy samples through each package's reducer; ``export``
    gives the same types and values."""
    port, ref = create_new_stat(stat, **kw), jax_create_stat(stat, **kw)
    samples = _samples()
    for s in samples:
        port.update_a_sample(torch.from_numpy(s))
        ref.update_a_sample(s)
    _assert_export(port.export(), ref.export(), stat, max(np.abs(s).max() for s in samples))


def test_record_keeps_a_float32_weight_without_a_copy():
    """A weight recorded by ``variance_precise`` is a view of the weight,
    so profiling a 7B tree does not double it."""
    w = torch.randn(6, 8)
    for stat in (create_new_stat("record"), create_new_stat("variance_precise")):
        stat.update_a_sample(w)
        assert stat.data.data_ptr() == w.data_ptr()


def test_count_below_two_exports_na_and_round_trips(tmp_path):
    """``variance_online`` over one value gives "NA" in both packages;
    ``save_config`` writes it as the string, ``load_config`` reads None."""
    port, ref = create_new_stat("variance_online"), jax_create_stat("variance_online")
    port.update_a_sample(torch.tensor([[2.5]]))
    ref.update_a_sample(np.array([[2.5]], np.float32))
    assert port.export() == ref.export() == {"variance_online": {"mean": "NA", "variance": "NA"}}
    save_config({"root:x:data_in": port.export()}, tmp_path / "p.toml")
    assert '"NA"' in (tmp_path / "p.toml").read_text()
    assert load_config(tmp_path / "p.toml") == {
        "root:x:data_in": {"variance_online": {"mean": None, "variance": None}}}


def test_manager_takes_each_weight_once():
    """A weight entry keeps its first sample; activations take every one."""
    rng = np.random.default_rng(3)
    w1, w2, a1, a2 = (rng.standard_normal((2, 4, 3)).astype(np.float32) for _ in range(4))
    port = StatManager(("range_min_max",), ("range_min_max", "variance_precise"))
    ref = JaxStatManager(("range_min_max",), ("range_min_max", "variance_precise"))
    for w, a in ((w1, a1), (w2, a2)):
        port.update_weight("w", torch.from_numpy(w))
        port.update_act("a", torch.from_numpy(a))
        ref.update_weight("w", w)
        ref.update_act("a", a)
    got, want = port.finalize(), ref.finalize()
    _assert_export(got, want, "profile", 5.0)
    assert got["w"]["range_min_max"]["max"] == float(w1.max())
    assert got["a"]["range_min_max"]["max"] == float(max(a1.max(), a2.max()))
    assert got["w"]["variance_precise"]["count"] == w1.size


# ------------------------------------------------------------------ the tap


class Recorder:
    def __init__(self):
        self.taps = []

    def on_linear(self, node_name, x, w, b, out):
        self.taps.append((node_name, x, w, b, out))


def test_tap_context_restores_the_collector_it_found():
    outer, inner = Recorder(), Recorder()
    x, w = torch.randn(2, 8), torch.randn(4, 8)
    cfg = {"bypass": True}
    with linear.capture_quant_node_taps(outer):
        linear.quantized_linear(x, w, None, cfg, False, "n0")
        with linear.capture_quant_node_taps(inner):
            linear.quantized_linear(x, w, None, cfg, False, "n1")
        linear.quantized_linear(x, w, None, cfg, False, "n2")
        linear.quantized_linear(x, w, None, cfg, False)  # unnamed: not tapped
        with pytest.raises(RuntimeError), linear.capture_quant_node_taps(inner):
            raise RuntimeError
        assert linear._TAP_COLLECTOR is outer
    assert linear._TAP_COLLECTOR is None
    assert [t[0] for t in outer.taps] == ["n0", "n2"] and [t[0] for t in inner.taps] == ["n1"]


def test_linear_tap_sees_the_raw_operands_as_jax_does():
    """The tap gets x, w and b before quantization and the output, on the
    fake-quant branch (weights quantized in the call) and the packed one."""
    cfg = port_models.get_config_cls("llama")(
        **TINY["llama"], quant_config="configs/quantization/bfp_6bit.toml"
    ).quant_config["model_layer_0"]["mlp"]["up_proj"]
    rng = np.random.default_rng(4)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 32), (16, 32), (16,)))
    for packed in (False, True):
        rec, ref = Recorder(), Recorder()
        tw = pack_block_fp(torch.from_numpy(w), 6, 8, None, 16) if packed else torch.from_numpy(w)
        tx, tb = torch.from_numpy(x), torch.from_numpy(b)
        with linear.capture_quant_node_taps(rec):
            out = linear.quantized_linear(tx, tw, tb, cfg, True, "model_layer_0:mlp:up_proj")
        name, gx, gw, gb, gout = rec.taps[0]
        assert name == "model_layer_0:mlp:up_proj" and gx is tx and gw is tw and gb is tb
        assert gout is out
        if not packed:
            with jax_linear.capture_quant_node_taps(ref):
                jax_linear.quantized_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), cfg,
                                            True, node_name="model_layer_0:mlp:up_proj")
            np.testing.assert_array_equal(np.asarray(ref.taps[0][1]), x)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref.taps[0][4]), rtol=0,
                                       atol=1e-5 * np.abs(out.numpy()).max())


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_decode_steps_tap_the_nodes_jax_taps(arch):
    """A decode step reports to the tap only the nodes JAX's reports: at
    Llama's its o_proj and MLP, not its q/k/v, and at OPT's none (the full
    forwards name every node)."""
    import importlib

    jax_serving = importlib.import_module(f"llm_mixed_q_tpu.models.{arch}.serving")
    port_serving = importlib.import_module(f"llm_mixed_q_torch.models.{arch}.serving")
    jc, tc, jp, tp = _family(arch, quant="configs/quantization/bfp_6bit.toml")
    rec, ref = Recorder(), Recorder()
    tok = np.asarray([[5], [9]], np.int32)
    with jax_linear.capture_quant_node_taps(ref):
        jax_serving.decode_step(jp, jnp.asarray(tok), jax_serving.init_kv_cache(jc, 2, 8), 3, jc)
    with linear.capture_quant_node_taps(rec):
        port_serving.decode_step(tp, torch.from_numpy(tok),
                                 port_serving.init_kv_cache(tc, 2, 8, device="cpu"), 3, tc)
    names = [t[0] for t in rec.taps]
    assert names == [t[0] for t in ref.taps]
    if arch == "llama":
        assert names and not any(n.endswith(("q_proj", "k_proj", "v_proj")) for n in names)
    else:
        assert names == []


# ------------------------------------------------------------------ profiles


def _with_biases(tree, rng):
    """Draw the zero biases of an initialized tree (a checkpoint's are not
    zero, and a zero range has no integer frac width)."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05
                    if k == "bias" and not v.any() else _with_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_biases(v, rng) for v in tree]
    return tree


def _family(arch, seed=0, quant=None):
    jc = jax_models.get_config_cls(arch)(**TINY[arch], quant_config=quant)
    tc = port_models.get_config_cls(arch)(**TINY[arch], quant_config=quant)
    tree = _with_biases(_np(JAX_INIT[arch](jc, task=TASK[arch], seed=seed)),
                        np.random.default_rng(seed))
    return jc, tc, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def profiles():
    """Each family's profile through both packages' ``model_fn`` path, the
    CLI's defaults, over two batches of padded rows."""
    out = {}
    for arch in TINY:
        jc, tc, jp, tp = _family(arch)
        batches = _batches(TINY[arch]["vocab_size"])
        fn = TASK[arch]
        want = jax_profile(batches=batches, arch=arch, model_fn=jax_models.get_model_fn(arch, fn),
                           config=jc, params=jp)
        got = profile_statistics(batches=batches, arch=arch,
                                 model_fn=port_models.get_model_fn(arch, fn), config=tc,
                                 params=tp)
        out[arch] = (got, want, (jc, tc, jp, tp))
    return out


def assert_profiles_close(got, want, act_tol=1e-4):
    """Keys in the same order, counts equal; min and max within 1e-5 of the
    entry's max|.|; variances within rtol ``act_tol`` and means within
    ``act_tol`` of |mean| + the entry's standard deviation."""
    assert list(got) == list(want)
    for name, stats in want.items():
        assert list(got[name]) == list(stats), name
        rmm = stats.get("range_min_max", {})
        scale = max(abs(rmm.get("min", 0.0)), abs(rmm.get("max", 0.0)))
        for stat, values in stats.items():
            g = got[name][stat]
            assert list(g) == list(values), (name, stat)
            std = math.sqrt(values.get("variance", 0.0))
            for k, v in values.items():
                if k == "count":
                    assert g[k] == v, (name, stat)
                elif k in ("min", "max", "range"):
                    assert abs(g[k] - v) <= 1e-5 * scale, (name, stat, k, g[k], v)
                elif k == "variance":
                    assert abs(g[k] - v) <= act_tol * v, (name, stat, k, g[k], v)
                else:
                    assert abs(g[k] - v) <= act_tol * (abs(v) + std), (name, stat, k, g[k], v)


@pytest.mark.parametrize("arch", list(TINY))
def test_profile_statistics_matches_jax(profiles, arch):
    """The ``model_fn`` path: JAX's keys in JAX's order (activation entries
    sorted by node, then entry; then weights and biases layer by layer),
    its counts, its values within the forwards' gap."""
    got, want, _ = profiles[arch]
    assert len(got) == 2 * ENTRIES_A_LAYER[arch]
    assert_profiles_close(got, want)
    first_weight = next(i for i, k in enumerate(got) if k.endswith((":weight", ":bias")))
    assert all(k.endswith((":data_in", ":data_out")) for k in list(got)[:first_weight])


def test_two_layer_llama_profile_has_34_entries(profiles):
    got = profiles["llama"][0]
    assert len(got) == 34
    assert "root:model_layer_1:self_attn:q_proj:data_out" in got
    assert "root:model_layer_1:self_attn:o_proj:data_out" not in got
    assert list(got)[-1] == "root:model_layer_1:mlp:up_proj:weight"
    act = got["root:model_layer_0:mlp:down_proj:data_in"]
    assert set(act) == {"range_min_max", "variance_online"}
    assert act["range_min_max"]["count"] == 4 * SEQ * TINY["llama"]["intermediate_size"]
    assert set(got["root:model_layer_0:mlp:down_proj:weight"]) == {"range_min_max",
                                                                  "variance_precise"}


def test_eager_forward_path_takes_every_entry_from_the_taps(profiles):
    """``forward_fn`` runs the caller's forward under the router: the same
    entries and values as the ``model_fn`` path, in forward order, the
    weights taken from the taps."""
    got, _, (_, tc, _, tp) = profiles["llama"]
    fwd = make_forward("llama", "lm", tc, quantize_weights=False)

    def forward_fn(batch):
        with torch.no_grad():
            fwd(tp, torch.as_tensor(batch["input_ids"]), torch.as_tensor(batch["attention_mask"]))

    eager = profile_statistics(forward_fn=forward_fn, batches=_batches(96), arch="llama")
    assert list(eager)[:4] == [f"root:model_layer_0:self_attn:q_proj:{e}"
                               for e in ("data_in", "weight", "data_out")] + [
        "root:model_layer_0:self_attn:k_proj:data_in"]
    assert sorted(eager) == sorted(got)
    assert_profiles_close({k: eager[k] for k in got}, got, act_tol=1e-6)


def test_tapped_forward_matches_jax(profiles):
    _, _, (jc, tc, jp, tp) = profiles["opt"]
    batch = _batches(96, n=2)[0]
    want = jax.jit(jax_tapped_forward(jax_models.get_model_fn("opt", "lm"), jc, "opt"))(
        jp, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]))
    got = make_tapped_forward(port_models.get_model_fn("opt", "lm"), tc, "opt")(
        tp, torch.as_tensor(batch["input_ids"]), torch.as_tensor(batch["attention_mask"]))
    assert sorted(got) == list(want) and len(got) == 2 * 6
    for node, entries in want.items():
        assert list(got[node]) == list(entries)
        for entry, arr in entries.items():
            arr = np.asarray(arr)
            np.testing.assert_allclose(got[node][entry].numpy(), arr, rtol=0,
                                       atol=1e-5 * np.abs(arr).max())


def test_packed_tree_raises_naming_the_node():
    """Statistics are profiled on the float tree. On a packed Llama tree
    the port raises ``TypeError`` at the first packed weight the router
    meets; JAX's ``model_fn`` path raises ``KeyError`` looking for q_proj
    in the fused tree (ROADMAP, faults)."""
    quant = "configs/quantization/bfp_6bit.toml"
    jc, tc, jp, tp = _family("llama", quant=quant)
    packed = init_llama_params(tc, seed=0, device="cpu", pack=dict(subbyte=True))
    batches = _batches(96, n=2)
    with pytest.raises(TypeError, match="model_layer_0:self_attn:o_proj.*PackedBFPSubT"):
        profile_statistics(batches=batches, arch="llama",
                           model_fn=port_models.get_model_fn("llama", "lm"), config=tc,
                           params=packed)
    from llm_mixed_q_tpu.models.llama.pack import pack_llama_params as jax_pack

    with pytest.raises(KeyError, match="q_proj"):
        jax_profile(batches=batches, arch="llama", model_fn=jax_models.get_model_fn("llama", "lm"),
                    config=jc, params=jax.jit(lambda p: jax_pack(p, jc, subbyte=True))(jp))


@pytest.mark.parametrize("arch", list(TINY))
def test_stat_profile_to_integer_config_matches_jax(profiles, arch):
    """profile -> ``transform_stat_profile_to_int_quant_config(width=8)`` ->
    the family's formatter -> its parser: the same config in both packages
    from the same profile dict, and forwards under it that agree."""
    got, _, (_, _, jp, tp) = profiles[arch]
    layers = TINY[arch]["num_hidden_layers"]
    configs = []
    for cfg_mod, models in ((port_config, port_models), (jax_config, jax_models)):
        qc = cfg_mod.transform_stat_profile_to_int_quant_config(got, "range_min_max", width=8)
        qc = models.get_stat_config_formatter(arch)(qc, layers)
        configs.append(models.get_quant_config_parser(arch)(qc, layers, strict=False))
    assert configs[0] == configs[1]
    layer0 = configs[0]["model_layer_0"]
    attn = layer0["attention" if arch == "bert" else "self_attn"]
    assert attn["matmul_0" if arch != "opt" else "bmm_0"]["name"] == "integer"
    tc = port_models.get_config_cls(arch)(**TINY[arch], quant_config=configs[0])
    jc = jax_models.get_config_cls(arch)(**TINY[arch], quant_config=configs[1])
    batch = _batches(96, n=2)[0]
    want = np.asarray(jax_make_forward(arch, TASK[arch], jc)(
        jp, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attention_mask"]))["logits"])
    with torch.no_grad():
        logits = make_forward(arch, TASK[arch], tc)(
            tp, torch.as_tensor(batch["input_ids"]),
            torch.as_tensor(batch["attention_mask"]))["logits"].numpy()
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, want, rtol=0, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny Llama LM checkpoint and a tiny OPT classifier (the eval
    tests' checkpoints)."""
    from safetensors.numpy import save_file
    from test_torch_cls import KW, opt_flat
    from test_torch_eval_lm import TINY as LM_TINY
    from test_torch_eval_lm import _hf_llama_flat
    from transformers import LlamaConfig, OPTConfig

    llama = tmp_path_factory.mktemp("stats_llama")
    LlamaConfig(**LM_TINY["llama"], tie_word_embeddings=False).save_pretrained(llama)
    jc = jax_models.get_config_cls("llama")(**LM_TINY["llama"])
    save_file(_hf_llama_flat(_np(jax_init_llama(jc, seed=2))), str(llama / "model.safetensors"))
    opt = tmp_path_factory.mktemp("stats_opt")
    OPTConfig(**KW["opt"]).save_pretrained(opt)
    save_file(opt_flat(2, seed=2), str(opt / "model.safetensors"))
    return {"llama": llama, "opt": opt}


@pytest.fixture
def offline(monkeypatch):
    """Both packages' statistics CLIs read in-memory Wikitext2 and GLUE
    splits through the eval tests' stand-in tokenizers."""
    from test_torch_cls import pair_tokenizer, raw_glue
    from test_torch_eval_lm import _raw_wikitext, _tokenizer

    def raw(name):
        return _raw_wikitext() if name == "wikitext2" else raw_glue(name, n=10)

    def tokenizer(args):
        return _tokenizer if args.model_arch == "llama" else pair_tokenizer

    for mod in (jax_cli, port_cli):
        monkeypatch.setattr(mod, "get_raw_dataset_dict", raw)
        monkeypatch.setattr(mod, "get_tokenizer", tokenizer)


@pytest.mark.parametrize("cli", ["lm", "cls_glue"])
def test_cli_profile_statistics_matches_jax(checkpoints, offline, tmp_path, cli):
    """Both CLIs on the same checkpoint and data: the same profile, and
    the TOML the port writes reads back as the profile it returned."""
    arch = "llama" if cli == "lm" else "opt"
    argv = ["--model_arch", arch, "--model_name", str(checkpoints[arch]), "--seq_len",
            str(SEQ), "--batch_size", "2", "--num_samples", "6"]
    if cli == "cls_glue":
        argv += ["--task", "sst2"]
    name = f"cli_profile_statistics_{cli}"
    want = getattr(jax_cli, name)(argv + ["--save_dir", str(tmp_path / "jax")])
    got = getattr(port_cli, name)(argv + ["--device", "cpu", "--save_dir", str(tmp_path)])
    assert len(got) == 2 * ENTRIES_A_LAYER[arch]
    assert_profiles_close(got, want)
    written = load_config(tmp_path / "statistic_profile.toml")
    assert written == convert_str_na_to_none(got)
    assert list(written) == list(jax_load_config(tmp_path / "jax" / "statistic_profile.toml"))
