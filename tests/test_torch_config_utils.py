"""The port's config and utils leaves and its cost model against the JAX
package, on the CPU: the TOML writer (byte-equal text on every TOML under
``configs/`` and on a statistic profile; a save/load round trip with
"NA"), ``flatten_dict`` / ``expand_dict``, the search-space sampler with
one recording trial stub, ``find_int_frac_width`` and
``transform_stat_profile_to_int_quant_config``, and the cost model of the
three families (exact integer counts, W6A6 at ~4.9x the density of
float32, other arithmetics raising), with the registry's getters.

Tolerances: none; every result is equal."""

import tomllib
from pathlib import Path

import numpy as np
import pytest

import llm_mixed_q_tpu.config as jax_config
import llm_mixed_q_tpu.costmodel.profiler as jax_cost
import llm_mixed_q_tpu.models as jax_models
import llm_mixed_q_tpu.utils as jax_utils
import llm_mixed_q_torch.config as port_config
import llm_mixed_q_torch.costmodel as port_cost
import llm_mixed_q_torch.models as port_models
import llm_mixed_q_torch.utils as port_utils
from llm_mixed_q_torch.costmodel.profiler import compute_memory_density

TOMLS = sorted(Path("configs").rglob("*.toml"))
TINY = {
    "llama": dict(vocab_size=96, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2),
    "opt": dict(vocab_size=96, hidden_size=64, ffn_dim=160, num_hidden_layers=2,
                num_attention_heads=4),
    "bert": dict(vocab_size=96, hidden_size=64, intermediate_size=160, num_hidden_layers=2,
                 num_attention_heads=4),
}
COST_TOMLS = ["bypass", "integer", "bfp_6bit", "bfp_4bit"]


def _profile_names():
    """Statistic-profile names of two Llama layers' q_proj and o_proj."""
    return [f"root:model_layer_{i}:self_attn:{node}:{entry}"
            for i in range(2) for node in ("q_proj", "o_proj")
            for entry in ("data_in", "weight")]


def _stat_profile(seed=0):
    """A statistic profile as ``profile_statistics`` writes one: each
    entry's range_min_max and variance_online, one of them "NA"."""
    rng = np.random.default_rng(seed)
    profile = {}
    for name in _profile_names():
        lo, hi = sorted(float(v) for v in rng.standard_normal(2) * 10.0 ** rng.integers(-3, 2))
        profile[name] = {"range_min_max": {"min": lo, "max": hi, "range": hi - lo, "count": 512},
                         "variance_online": {"mean": float(rng.standard_normal()),
                                             "variance": float(rng.uniform()), "count": 512}}
    profile[name]["variance_online"] = {"mean": None, "variance": None}
    return profile


@pytest.mark.parametrize("path", TOMLS, ids=[p.stem for p in TOMLS])
def test_dumps_toml_matches_jax(path):
    """Byte-equal text, and it reads back as the file does."""
    config = port_utils.convert_none_to_str_na(port_utils.load_config(path))
    text = port_utils.dumps_toml(config)
    assert text == jax_utils.dumps_toml(config)
    with open(path, "rb") as f:
        assert tomllib.loads(text) == tomllib.load(f)


def test_dumps_toml_of_a_profile_matches_jax():
    profile = port_utils.convert_none_to_str_na(_stat_profile())
    assert port_utils.dumps_toml(profile) == jax_utils.dumps_toml(profile)


def test_save_load_round_trip_with_na(tmp_path):
    """None is written as "NA" and read back as None; each package reads
    the other's file."""
    profile = _stat_profile(1)
    port_utils.save_config(profile, tmp_path / "port" / "p.toml")
    jax_utils.save_config(profile, tmp_path / "jax.toml")
    assert (tmp_path / "port" / "p.toml").read_bytes() == (tmp_path / "jax.toml").read_bytes()
    assert port_utils.load_config(tmp_path / "port" / "p.toml") == profile
    assert jax_utils.load_config(tmp_path / "port" / "p.toml") == profile
    assert '"NA"' in (tmp_path / "jax.toml").read_text()


def test_flatten_and_expand_match_jax():
    config = port_utils.load_config("configs/search/llama_7b_sst2.toml")
    flat = port_utils.flatten_dict(config, {})
    assert list(flat.items()) == list(jax_utils.flatten_dict(config, {}).items())
    assert all(k.startswith("root:") for k in flat)
    assert port_utils.expand_dict(flat, {}) == config == jax_utils.expand_dict(flat, {})
    for utils in (port_utils, jax_utils):
        with pytest.raises(ValueError):
            utils.expand_dict({"root:a": 2}, {"a": 1})


class RecordingTrial:
    """A search trial that records each question and answers by turns."""

    def __init__(self):
        self.calls = []

    def suggest_categorical(self, name, choices):
        self.calls.append((name, list(choices)))
        return choices[len(self.calls) % len(choices)]


def test_sampler_matches_jax():
    space = port_utils.load_config("configs/search/opt_1.3b_sst2.toml")["search_space"]
    seed = space["quant_config_seed"]["default"]
    port_trial, jax_trial = RecordingTrial(), RecordingTrial()
    got = port_config.sample_a_dict_of_list(port_trial, "root:default", seed)
    want = jax_config.sample_a_dict_of_list(jax_trial, "root:default", seed)
    assert got == want and port_trial.calls == jax_trial.calls
    assert port_trial.calls[0][0] == f"root:default:{next(iter(seed))}"
    # "!ast!" choices come back as their literals
    assert got["bypass"] is False and got["weight_block_size"] == [1, 16]
    assert port_config.decode_ast_value("!ast!None") is None
    assert port_config.sample_a_list(RecordingTrial(), "w", [4, 6]) == 6
    with pytest.raises(TypeError):
        port_config.sample_a_list(RecordingTrial(), "w", (4, 6))


@pytest.mark.parametrize("width,half_range,choices", [
    (8, 1.5, None),
    (4, 0.3, None),
    (6, 100.0, None),
    (8, 0.01, [0, 2, 4, 6, 8]),
])
def test_find_int_frac_width_matches_jax(width, half_range, choices):
    got = port_config.find_int_frac_width(width, half_range, choices)
    assert got == jax_config.find_int_frac_width(width, half_range, choices)
    assert (2 ** (width - 1) - 1) / 2 ** got >= half_range


@pytest.mark.parametrize("width,frac", [("int", "none"), ("dict", "list"), ("int", "dict")])
def test_transform_stat_profile_matches_jax(width, frac):
    """The integer config of one profile, in both packages, key for key."""
    profile = _stat_profile(2)
    names = _profile_names()
    widths = 8 if width == "int" else {f"{n}_width": 4 + i % 4 for i, n in enumerate(names)}
    fracs = {"none": None, "list": [0, 1, 2, 3, 4, 5, 6, 7],
             "dict": {n: list(range(-4 + i % 3, 9)) for i, n in enumerate(names)}}[frac]
    kw = dict(range_entry="range_min_max", width=widths, frac_choices=fracs)
    got = port_config.transform_stat_profile_to_int_quant_config(profile, **kw)
    assert got == jax_config.transform_stat_profile_to_int_quant_config(profile, **kw)
    node = got["model_layer_1"]["self_attn"]["o_proj"]
    assert set(node) == {"bypass", "name", "is_ptq", "data_in_width", "data_in_frac_width",
                         "weight_width", "weight_frac_width"}
    assert node["name"] == "integer" and node["is_ptq"] and not node["bypass"]


def _cost_configs(arch, stem):
    toml = f"configs/quantization/{stem}.toml"
    return (jax_models.get_config_cls(arch)(**TINY[arch], quant_config=toml),
            port_models.get_config_cls(arch)(**TINY[arch], quant_config=toml))


@pytest.mark.parametrize("arch", list(TINY))
def test_cost_model_matches_jax(arch):
    """Exact counts under bypass, integer, bfp_6bit and bfp_4bit."""
    for stem in COST_TOMLS:
        jc, tc = _cost_configs(arch, stem)
        for seq_len in (16, 100):
            want = jax_models.get_model_profiler(arch)(jc, seq_len)
            got = port_models.get_model_profiler(arch)(tc, seq_len)
            assert got == want and all(isinstance(v, (int, np.integer)) for v in got.values())
            assert compute_memory_density(got) == jax_cost.compute_memory_density(want)
            if stem == "bypass":
                assert compute_memory_density(got) == 1.0


def test_w6a6_density_and_unsupported_arithmetics():
    """W6A6 block_fp (6-bit codes, an 8-bit exponent a block of 16) is
    ~4.9x the density of float32 at Llama-2-7B widths, seq 2048; any
    arithmetic other than integer and block_fp raises in both packages."""
    kw = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
              num_hidden_layers=2, num_attention_heads=32)
    toml = "configs/quantization/bfp_6bit.toml"
    got = compute_memory_density(port_models.get_model_profiler("llama")(
        port_models.get_config_cls("llama")(**kw, quant_config=toml), 2048))
    assert got == pytest.approx(32 / 6.5, rel=1e-3)
    for stem in ("minifloat_ieee", "log"):
        jc, tc = _cost_configs("opt", stem)
        with pytest.raises(ValueError, match="Unknown quant_arith"):
            port_models.get_model_profiler("opt")(tc, 16)
        with pytest.raises(ValueError, match="Unknown quant_arith"):
            jax_models.get_model_profiler("opt")(jc, 16)
    assert port_cost.profile_llama_quantized is port_models.get_model_profiler("llama")


def test_registry_getters():
    for arch in TINY:
        assert port_models.get_quant_config_parser(arch) is getattr(
            port_models, f"parse_{arch}_quantized_config")
        assert port_models.get_stat_config_formatter(arch) is getattr(
            port_models, f"format_stat_profiled_int_config_{arch}_quantized")
        assert port_models.get_model_profiler(arch).__name__ == f"profile_{arch}_quantized"
    for getter in (port_models.get_model_profiler, port_models.get_quant_config_parser,
                   port_models.get_stat_config_formatter):
        with pytest.raises(NotImplementedError, match="gpt2"):
            getter("gpt2")
    parsed = port_models.get_quant_config_parser("llama")("configs/quantization/bfp_6bit.toml", 2)
    assert parsed == jax_models.get_quant_config_parser("llama")(
        "configs/quantization/bfp_6bit.toml", 2)
