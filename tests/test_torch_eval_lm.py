"""The port's perplexity path against the JAX package, on the CPU at a tiny
size (2 layers, hidden 64, vocab 96): the Llama and OPT forwards under
each quantization TOML, one-shot and PTQ; the synthetic LM stream and its
loader; ``eval_lm_wikitext2``; the registry and ``make_forward``; a tiny
local checkpoint through ``load_flat_state_dict`` and
``llama_params_from_flat``; and ``build_model`` and the perplexity CLIs,
with the Wikitext2 download and the tokenizer replaced on each package's
own module attributes.

Tolerances: logits within 1e-4 of max|logit| (float32 sums in another
order; tests/test_torch_llama.py), PTQ weights bit-equal, losses within
1e-5 relative, the data bit-equal."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import llm_mixed_q_tpu.cli.evals as jax_cli
import llm_mixed_q_tpu.datasets as jax_datasets
from llm_mixed_q_tpu.eval.eval_lm import eval_lm_wikitext2 as jax_eval_lm
from llm_mixed_q_tpu.models import get_config_cls as jax_config_cls
from llm_mixed_q_tpu.models import get_model_fn as jax_model_fn
from llm_mixed_q_tpu.models import get_ptq_preparer as jax_ptq_preparer
from llm_mixed_q_tpu.models.api import make_forward as jax_make_forward
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init_llama
from llm_mixed_q_tpu.models.hf_loader import init_opt_params as jax_init_opt
from llm_mixed_q_tpu.models.hf_loader import llama_params_from_flat as jax_llama_from_flat
from llm_mixed_q_tpu.models.hf_loader import load_flat_state_dict as jax_load_flat
import llm_mixed_q_torch.cli.evals as port_cli
import llm_mixed_q_torch.datasets as port_datasets
from llm_mixed_q_torch import models as port_models
from llm_mixed_q_torch.eval import eval_lm_wikitext2
from llm_mixed_q_torch.models.api import make_forward
from llm_mixed_q_torch.models.hf_loader import (
    llama_params_from_flat,
    load_flat_state_dict,
    opt_params_from_flat,
    params_from_jax,
    params_to_numpy,
)
from llm_mixed_q_torch.utils import get_logger, set_logging_verbosity

TOMLS = sorted(str(p) for p in Path("configs/quantization").glob("*.toml"))
VOCAB, SEQ = 96, 16
TINY = {
    "llama": dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=2, max_position_embeddings=128),
    "opt": dict(vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128),
}
JAX_INIT = {"llama": jax_init_llama, "opt": jax_init_opt}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, quant, **kw):
    kw = {**TINY[arch], **kw}
    return (jax_config_cls(arch)(**kw, quant_config=quant),
            port_models.get_config_cls(arch)(**kw, quant_config=quant))


@pytest.fixture(scope="module", params=["llama", "opt"])
def family(request):
    """(arch, JAX numpy params, the same params as the port's tree)."""
    arch = request.param
    jp = _np(JAX_INIT[arch](_configs(arch, None)[0], seed=0))
    return arch, jp, params_from_jax(jp, device="cpu")


def _batch(n=2, seed=7):
    return port_datasets.make_synthetic_lm_dataset(VOCAB, SEQ, n, seed=seed)


def _tensors(batch):
    return [torch.from_numpy(batch[k]) for k in ("input_ids", "attention_mask", "labels")]


def _close_logits(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("toml", TOMLS, ids=[Path(t).stem for t in TOMLS])
def test_forward_matches_jax_under_each_toml(family, toml):
    """One-shot (weights quantized every call) and PTQ (quantized once by
    the registry's preparer, then ``quantize_weights=False``): logits and
    loss against the JAX package's one-shot forward; the PTQ weights
    bit-equal to the JAX preparer's."""
    arch, jp, tp = family
    jc, tc = _configs(arch, toml)
    batch = _batch()
    want = jax.jit(jax_make_forward(arch, "lm", jc, with_labels=True, jit=False))(
        jp, batch["input_ids"], batch["attention_mask"], batch["labels"])
    fwd = make_forward(arch, "lm", tc, with_labels=True)
    got = fwd(tp, *_tensors(batch))
    assert set(got) == {"logits", "loss"}
    _close_logits(got["logits"].numpy(), np.asarray(want["logits"]))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)

    tq = port_models.get_ptq_preparer(arch)(tp, tc)
    jq = _np(jax_ptq_preparer(arch)(jp, jc))
    layer = "self_attn" if arch == "llama" else "fc1"
    w = lambda p: (p["layers"][1][layer]["q_proj"] if arch == "llama" else p["layers"][1][layer])
    np.testing.assert_array_equal(params_to_numpy(w(tq))["weight"], w(jq)["weight"])
    got_ptq = make_forward(arch, "lm", tc, quantize_weights=False, with_labels=True)(
        tq, *_tensors(batch))
    _close_logits(got_ptq["logits"].numpy(), np.asarray(want["logits"]))


def test_synthetic_stream_and_loader_match_jax():
    want = jax_datasets.make_synthetic_lm_dataset(VOCAB, SEQ, 7, seed=3)
    got = port_datasets.make_synthetic_lm_dataset(VOCAB, SEQ, 7, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    for kw in (dict(batch_size=3), dict(batch_size=3, shuffle=True, seed=5, drop_last=True)):
        jb = list(jax_datasets.numpy_dataloader(want, **kw))
        tb = list(port_datasets.numpy_dataloader(got, **kw))
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])


def test_eval_lm_matches_jax():
    """5 sequences in batches of 2, stopped after 4 by ``num_samples``."""
    arch = "llama"
    jc, tc = _configs(arch, "configs/quantization/bfp_6bit.toml")
    jp = _np(jax_init_llama(jc, seed=1))
    ds = _batch(5, seed=11)
    want = jax_eval_lm(jax_make_forward(arch, "lm", jc, with_labels=True), jp,
                       jax_datasets.numpy_dataloader(ds, 2), num_samples=4)
    got = eval_lm_wikitext2(make_forward(arch, "lm", tc, with_labels=True),
                            params_from_jax(jp, device="cpu"),
                            port_datasets.numpy_dataloader(ds, 2), num_samples=4)
    assert (got["num_sequences"], got["seq_len"]) == (want["num_sequences"], want["seq_len"]) == (4, SEQ)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)


def test_eval_lm_rejects_ragged_lengths():
    _, tc = _configs("llama", None)
    params = params_from_jax(_np(jax_init_llama(_configs("llama", None)[0], seed=0)), device="cpu")
    batches = [_batch(1), port_datasets.make_synthetic_lm_dataset(VOCAB, SEQ + 1, 1)]
    with pytest.raises(ValueError, match="seq_len"):
        eval_lm_wikitext2(make_forward("llama", "lm", tc, with_labels=True), params, batches)


def test_registry():
    for arch, fn in (("llama", "llama_for_causal_lm"), ("opt", "opt_for_causal_lm")):
        assert port_models.get_model_fn(arch, "lm").__name__ == fn
        assert port_models.get_config_cls(arch).__name__ == jax_config_cls(arch).__name__
        assert port_models.get_params_loader(arch).__name__ == f"{arch}_params_from_flat"
        assert port_models.get_ptq_preparer(arch).__name__ == f"quantize_{arch}_params_ptq"
        assert port_models.get_params_packer(arch).__name__ == f"pack_{arch}_params"
        assert jax_model_fn(arch, "lm").__name__ == fn
    with pytest.raises(NotImplementedError, match="'lm' of bert"):
        port_models.get_model_fn("bert", "lm")
    with pytest.raises(NotImplementedError, match="'qa' of llama"):
        port_models.get_model_fn("llama", "qa")
    with pytest.raises(NotImplementedError, match="gpt2"):
        port_models.get_params_loader("gpt2")


def test_make_forward_drops_the_kv_caches():
    _, tc = _configs("opt", None)
    params = params_from_jax(_np(jax_init_opt(_configs("opt", None)[0], seed=0)), device="cpu")
    ids, mask, _ = _tensors(_batch())
    out = make_forward("opt", "lm", tc)(params, ids)
    assert set(out) == {"logits"} and out["logits"].shape == (2, SEQ, VOCAB)
    np.testing.assert_array_equal(make_forward("opt", "lm", tc)(params, ids, mask)["logits"],
                                  out["logits"])


def test_dataset_names():
    """The GLUE tasks and wikitext2 are known (GLUE's pipeline is held in
    tests/test_torch_cls.py); other names are unknown."""
    assert set(port_datasets.TASK_TO_KEYS) == set(jax_datasets.TASK_TO_KEYS)
    with pytest.raises(ValueError, match="Unknown"):
        port_datasets.preprocess_dataset_dict({}, "c4", None, "max_length", 8)
    with pytest.raises(ValueError, match="Unknown"):
        port_datasets.get_raw_dataset_dict("c4")


def test_logger():
    set_logging_verbosity("warning")
    assert get_logger().level == 30 and get_logger().name == "llm_mixed_q_torch"
    set_logging_verbosity("info")
    assert get_logger().level == 20


# ------------------------------------------------------------ checkpoint


def _hf_llama_flat(jp):
    """The JAX package's tree under HF Llama names."""
    flat = {"model.embed_tokens.weight": jp["embed_tokens"]["weight"],
            "model.norm.weight": jp["norm"]["weight"], "lm_head.weight": jp["lm_head"]["weight"]}
    for i, layer in enumerate(jp["layers"]):
        pre = f"model.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            flat[pre + norm + ".weight"] = layer[norm]["weight"]
        for group in ("self_attn", "mlp"):
            for name, node in layer[group].items():
                flat[f"{pre}{group}.{name}.weight"] = node["weight"]
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny Llama checkpoint: ``config.json`` from transformers'
    LlamaConfig, weights in a safetensors file."""
    from safetensors.numpy import save_file
    from transformers import LlamaConfig

    d = tmp_path_factory.mktemp("tiny_llama")
    kw = TINY["llama"]
    LlamaConfig(**kw, tie_word_embeddings=False).save_pretrained(d)
    jp = _np(jax_init_llama(_configs("llama", None)[0], seed=2))
    save_file(_hf_llama_flat(jp), str(d / "model.safetensors"))
    return d, jp


def test_load_checkpoint_matches_jax(checkpoint, tmp_path):
    """safetensors and ``pytorch_model.bin``; prefixed names and not; an
    untied config without lm_head takes the embedding table."""
    d, jp = checkpoint
    jc, tc = _configs("llama", None)
    flat = load_flat_state_dict(d)
    want = _np(jax_llama_from_flat(jax_load_flat(d), jc))
    got = llama_params_from_flat(flat, tc, device="cpu")
    from test_torch_llama import _flat

    assert _flat(params_to_numpy(got)).keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(_flat(params_to_numpy(got))[k], v)
    torch.save({k.removeprefix("model."): v for k, v in flat.items() if k != "lm_head.weight"},
               tmp_path / "pytorch_model.bin")
    bare = llama_params_from_flat(load_flat_state_dict(tmp_path), tc, device="cpu")
    np.testing.assert_array_equal(bare["lm_head"]["weight"], jp["embed_tokens"]["weight"])
    np.testing.assert_array_equal(bare["layers"][1]["mlp"]["down_proj"]["weight"],
                                  jp["layers"][1]["mlp"]["down_proj"]["weight"])
    with pytest.raises(NotImplementedError):
        llama_params_from_flat(flat, tc, task="qa", device="cpu")
    with pytest.raises(FileNotFoundError):
        load_flat_state_dict(tmp_path / "none")


def _tokenizer(texts):
    """Bytes as token ids, a stand-in for a checkpoint's tokenizer."""
    ids = [[b % VOCAB for b in t.encode()] for t in texts]
    return {"input_ids": ids, "attention_mask": [[1] * len(i) for i in ids]}


def _raw_wikitext():
    from datasets import Dataset, DatasetDict

    rng = np.random.default_rng(4)
    words = ["".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(2, 9)))
             for _ in range(200)]
    lines = [" ".join(words[i:i + 12]) for i in range(0, 200, 12)]
    return DatasetDict({s: Dataset.from_dict({"text": lines[j::2]})
                        for j, s in enumerate(("train", "test"))})


def test_preprocess_wikitext2_matches_jax():
    raw = _raw_wikitext()
    want = jax_datasets.preprocess_dataset_dict(raw, "wikitext2", _tokenizer, None, SEQ)
    got = port_datasets.preprocess_dataset_dict(raw, "wikitext2", _tokenizer, None, SEQ)
    assert got["test"].num_rows > 4
    assert got["test"].to_dict() == want["test"].to_dict()


@pytest.fixture
def offline(monkeypatch):
    """Both packages' CLIs read the in-memory corpus with the byte
    tokenizer."""
    raw = _raw_wikitext()
    for mod in (jax_cli, port_cli):
        monkeypatch.setattr(mod, "get_raw_dataset_dict", lambda name: raw)
        monkeypatch.setattr(mod, "get_tokenizer", lambda args: _tokenizer)


@pytest.mark.parametrize("toml", ["bfp_6bit", "block_minifloat", None])
def test_cli_eval_lm_wikitext2_matches_jax(checkpoint, offline, tmp_path, toml):
    d, _ = checkpoint
    argv = ["--model_arch", "llama", "--model_name", str(d), "--seq_len", str(SEQ),
            "--batch_size", "2"]
    if toml:
        argv += ["--quant_config", f"configs/quantization/{toml}.toml"]
    want = jax_cli.cli_eval_lm_wikitext2(argv)
    got = port_cli.cli_eval_lm_wikitext2(argv + ["--device", "cpu", "--save_dir", str(tmp_path)])
    assert got["num_sequences"] == want["num_sequences"] > 4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert json.loads((tmp_path / "eval_lm_wikitext2.json").read_text()) == got


def test_cli_int8_baseline_matches_jax(checkpoint, offline):
    d, _ = checkpoint
    argv = ["--model_arch", "llama", "--model_name", str(d), "--seq_len", str(SEQ)]
    want = jax_cli.cli_eval_lm_wikitext2_int8_baseline(argv)
    got = port_cli.cli_eval_lm_wikitext2_int8_baseline(argv + ["--device", "cpu"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_build_model_packed_matches_ptq(checkpoint, offline):
    """``--packed`` serves int8 ``PackedBFP`` weights through ``bfp_matmul``
    (its plain version on the CPU); the loss equals the PTQ flow's within
    1e-5 relative."""
    import argparse

    from llm_mixed_q_torch.cli.common import add_common_model_args, build_model
    from llm_mixed_q_torch.kernels import PackedBFP

    d, _ = checkpoint
    parser = argparse.ArgumentParser()
    add_common_model_args(parser)
    argv = ["--model_arch", "llama", "--model_name", str(d), "--device", "cpu",
            "--quant_config", "configs/quantization/bfp_6bit.toml"]
    batch = _batch()
    losses = []
    for extra in ([], ["--packed"]):
        config, params, fwd = build_model(parser.parse_args(argv + extra), "lm")
        if extra:
            assert isinstance(params["layers"][0]["mlp"]["down_proj"]["weight"], PackedBFP)
        losses.append(float(fwd(params, *_tensors(batch))["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_entry_points_default_to_the_card(checkpoint, offline):
    """Without ``device`` (``--device``) the loaders and the CLI ask for
    CUDA, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default does not raise here")
    d, jp = checkpoint
    _, tc = _configs("llama", None)
    flat = load_flat_state_dict(d)
    for call in (lambda: llama_params_from_flat(flat, tc),
                 lambda: opt_params_from_flat({}, _configs("opt", None)[1]),
                 lambda: port_cli.cli_eval_lm_wikitext2(
                     ["--model_arch", "llama", "--model_name", str(d)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
