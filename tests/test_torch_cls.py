"""The port's classification path against the JAX package, on the CPU at a
tiny size (2 layers, hidden 64, vocab 96): the sequence-classification
heads of Llama and OPT and OPT's span question-answering head under six
quantization TOMLs, the regression head, the loaders and the registry of
the new tasks, GLUE preprocessing and the synthetic classification stream,
the GLUE metrics, ``eval_cls_glue`` and ``cli_eval_cls_glue``.

OPT is OPT-350M's shape in small: post-LN (``do_layer_norm_before``
false) with a ``word_embed_proj_dim`` (32) other than hidden (64), so
project_in/out exist and the heads sit on project_out's 32-wide output.
The JAX package's ``init_opt_params`` leaves project_in/out out, so both
OPT trees come from one seeded flat state dict through each package's
``opt_params_from_flat``. The batches hold a pad id inside a sequence, so
the pooling row is the count of non-pad ids less one, not the last
non-pad position.

Tolerances: logits within 1e-4 of max|logit| (float32 sums in another
order), losses within 1e-5 relative, loaded arrays and data bit-equal,
metrics within 1e-12."""

import json

import jax
import numpy as np
import pytest
import torch

import llm_mixed_q_tpu.cli.evals as jax_cli
import llm_mixed_q_tpu.datasets as jax_datasets
from llm_mixed_q_tpu.eval import eval_cls_glue as jax_eval_cls
from llm_mixed_q_tpu.eval.metrics import compute_glue_metrics as jax_metrics
from llm_mixed_q_tpu.models import get_config_cls as jax_config_cls
from llm_mixed_q_tpu.models import get_model_fn as jax_model_fn
from llm_mixed_q_tpu.models.api import make_forward as jax_make_forward
from llm_mixed_q_tpu.models.hf_loader import init_llama_params as jax_init_llama
from llm_mixed_q_tpu.models.hf_loader import llama_params_from_flat as jax_llama_from_flat
from llm_mixed_q_tpu.models.hf_loader import opt_params_from_flat as jax_opt_from_flat
import llm_mixed_q_torch.cli.evals as port_cli
import llm_mixed_q_torch.datasets as port_datasets
from llm_mixed_q_torch import models as port_models
from llm_mixed_q_torch.eval import TASK_TO_METRICS, compute_glue_metrics, eval_cls_glue
from llm_mixed_q_torch.models.api import make_forward
from llm_mixed_q_torch.models.hf_loader import (
    init_llama_params,
    init_opt_params,
    llama_params_from_flat,
    opt_params_from_flat,
    params_from_jax,
    params_to_numpy,
)
from llm_mixed_q_torch.models.llama.modeling import pooled_index

VOCAB, SEQ = 96, 16
KW = {
    "llama": dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=2, max_position_embeddings=128, pad_token_id=0),
    "opt": dict(vocab_size=VOCAB, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128, word_embed_proj_dim=32,
                do_layer_norm_before=False, pad_token_id=1),
}
HEAD_TOMLS = ["bypass", "bfp_4bit", "integer", "block_minifloat", "log", "minifloat_ieee"]


def _toml(stem):
    return f"configs/quantization/{stem}.toml"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, quant=None, **kw):
    kw = {**KW[arch], **kw}
    return (jax_config_cls(arch)(**kw, quant_config=quant),
            port_models.get_config_cls(arch)(**kw, quant_config=quant))


def opt_flat(num_labels=2, seed=0):
    """A seeded flat state dict under HF's OPTForSequenceClassification
    names, with ``score`` and ``qa_outputs`` heads."""
    rng = np.random.default_rng(seed)
    c = KW["opt"]
    h, d, ffn = c["hidden_size"], c["word_embed_proj_dim"], c["ffn_dim"]

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    pre = "model.decoder."
    flat = {pre + "embed_tokens.weight": w(VOCAB, d),
            pre + "embed_positions.weight": w(c["max_position_embeddings"] + 2, h),
            pre + "project_in.weight": w(h, d), pre + "project_out.weight": w(d, h),
            "score.weight": w(num_labels, d), "qa_outputs.weight": w(2, d),
            "qa_outputs.bias": w(2)}
    for i in range(c["num_hidden_layers"]):
        lp = f"{pre}layers.{i}."
        shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h),
                  "self_attn.v_proj": (h, h), "self_attn.out_proj": (h, h),
                  "fc1": (ffn, h), "fc2": (h, ffn)}
        for name, shape in shapes.items():
            flat[f"{lp}{name}.weight"] = w(*shape)
            flat[f"{lp}{name}.bias"] = w(shape[0], scale=0.01)
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            flat[f"{lp}{norm}.weight"] = 1 + w(h, scale=0.1)
            flat[f"{lp}{norm}.bias"] = w(h, scale=0.01)
    return flat


def opt_trees(jc, tc, task="cls", num_labels=2, seed=0):
    """(JAX numpy tree, port tree) of one flat state dict."""
    flat = opt_flat(num_labels, seed)
    return _np(jax_opt_from_flat(flat, jc, task=task)), opt_params_from_flat(flat, tc, task=task,
                                                                             device="cpu")


def llama_trees(jc, seed=0):
    jp = _np(jax_init_llama(jc, task="cls", seed=seed))
    return jp, params_from_jax(jp, device="cpu")


def cls_batch(pad_id, n=3, num_labels=2, seed=7):
    """The synthetic stream, row 0 with ``pad_id`` inside its sequence."""
    ds = port_datasets.make_synthetic_cls_dataset(VOCAB, SEQ, n, num_labels=max(num_labels, 2),
                                                  seed=seed)
    ds["input_ids"][0, 2] = pad_id
    if num_labels == 1:
        ds["labels"] = np.random.default_rng(seed).uniform(0, 5, n).astype(np.float32)
    return ds


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_logits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize("toml", HEAD_TOMLS)
def test_heads_match_jax(toml):
    """OPT and Llama sequence classification and OPT span QA, weights
    fake-quantized every call: logits (start/end logits) and loss. One JAX
    compile runs the three heads."""
    quant = None if toml == "bypass" else _toml(toml)
    (jo, to), (jl, tl) = _configs("opt", quant), _configs("llama", quant)
    jp_opt, tp_opt = opt_trees(jo, to, task="cls")
    jp_qa, tp_qa = opt_trees(jo, to, task="qa")
    jp_llama, tp_llama = llama_trees(jl)
    ob, lb = cls_batch(1), cls_batch(0, seed=8)
    start, end = np.array([3, 0, 9]), np.array([5, 15, 9])

    @jax.jit
    def want_fn(jp_opt, jp_qa, jp_llama):
        qa = jax_model_fn("opt", "qa")(jp_qa, ob["input_ids"], ob["attention_mask"], start, end,
                                       config=jo)
        return {"opt": jax_model_fn("opt", "cls")(jp_opt, ob["input_ids"], ob["attention_mask"],
                                                  labels=ob["labels"], config=jo),
                "llama": jax_model_fn("llama", "cls")(jp_llama, lb["input_ids"],
                                                      lb["attention_mask"], labels=lb["labels"],
                                                      config=jl),
                "qa": qa}

    want = want_fn(jp_opt, jp_qa, jp_llama)
    got = {
        "opt": make_forward("opt", "cls", to, with_labels=True)(
            tp_opt, _t(ob["input_ids"]), _t(ob["attention_mask"]), _t(ob["labels"])),
        "llama": make_forward("llama", "cls", tl, with_labels=True)(
            tp_llama, _t(lb["input_ids"]), _t(lb["attention_mask"]), _t(lb["labels"])),
        "qa": port_models.get_model_fn("opt", "qa")(
            tp_qa, _t(ob["input_ids"]), _t(ob["attention_mask"]), _t(start), _t(end),
            config=to),
    }
    assert got["opt"]["logits"].shape == (3, 2) and got["qa"]["start_logits"].shape == (3, SEQ)
    for name in ("opt", "llama"):
        _close_logits(got[name]["logits"], want[name]["logits"])
    for k in ("start_logits", "end_logits"):
        _close_logits(got["qa"][k], want["qa"][k])
    for name in got:
        np.testing.assert_allclose(float(got[name]["loss"]), float(want[name]["loss"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("toml", ["bypass", "bfp_4bit"])
def test_regression_heads_match_jax(toml):
    """One label: the squeezed logit and the MSE loss, OPT and a Llama
    without a pad id (pooled at the last position)."""
    quant = None if toml == "bypass" else _toml(toml)
    jo, to = _configs("opt", quant, num_labels=1)
    jl, tl = _configs("llama", quant, num_labels=1, pad_token_id=None)
    jp_opt, tp_opt = opt_trees(jo, to, num_labels=1)
    jp_llama, tp_llama = llama_trees(jl, seed=3)
    b = cls_batch(1, num_labels=1)
    args = (b["input_ids"], b["attention_mask"], b["labels"])
    want = jax.jit(lambda po, pl: (jax_make_forward("opt", "cls", jo, with_labels=True, jit=False)(
        po, *args), jax_make_forward("llama", "cls", jl, with_labels=True, jit=False)(pl, *args)))(
        jp_opt, jp_llama)
    got = (make_forward("opt", "cls", to, with_labels=True)(tp_opt, *map(_t, args)),
           make_forward("llama", "cls", tl, with_labels=True)(tp_llama, *map(_t, args)))
    for g, w in zip(got, want):
        assert g["logits"].shape == (3, 1) and g["loss"].dtype == torch.float32
        _close_logits(g["logits"], w["logits"])
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]), rtol=1e-5)


def test_pooled_index_counts_non_pad_ids():
    ids = torch.tensor([[5, 1, 7, 1, 1], [1, 1, 1, 1, 1], [4, 4, 4, 4, 4]])
    assert pooled_index(ids, 1).tolist() == [1, 0, 4]
    assert pooled_index(ids, None).tolist() == [4, 4, 4]


@pytest.mark.parametrize("arch,task", [("llama", "cls"), ("opt", "cls"), ("opt", "qa")])
def test_init_params_heads(arch, task):
    """The head is drawn after the backbone: one seed gives the causal-LM
    tree's backbone; two calls give the same arrays."""
    _, tc = _configs(arch, None, num_labels=3)
    init = {"llama": init_llama_params, "opt": init_opt_params}[arch]
    a, b = (params_to_numpy(init(tc, task=task, seed=4, device="cpu")) for _ in range(2))
    lm = params_to_numpy(init(tc, task="lm", seed=4, device="cpu"))
    width = tc.hidden_size if arch == "llama" else tc.word_embed_proj_dim
    head = {"cls": "score", "qa": "qa_outputs"}[task]
    assert a[head]["weight"].shape == ((3, width) if task == "cls" else (2, width))
    if task == "qa":
        np.testing.assert_array_equal(a[head]["bias"], np.zeros(2, np.float32))
    for k in a:
        np.testing.assert_equal(a[k], b[k])
        if k != head:
            np.testing.assert_equal(a[k], lm[k])
    assert "lm_head" not in a
    with pytest.raises(NotImplementedError, match="'qa' of llama"):
        init_llama_params(tc if arch == "llama" else _configs("llama")[1], task="qa",
                          device="cpu")


@pytest.mark.parametrize("arch,task", [("llama", "cls"), ("opt", "cls"), ("opt", "qa")])
def test_params_from_flat_match_jax(arch, task):
    """Both packages' loaders on one flat dict give the same arrays; without
    ``score.weight`` the cls head is zeros."""
    from test_torch_llama import _flat

    from test_torch_eval_lm import _hf_llama_flat

    jc, tc = _configs(arch, None)
    if arch == "llama":
        flat = _hf_llama_flat(_np(jax_init_llama(jc, seed=5)))
        flat["score.weight"] = np.random.default_rng(5).standard_normal((2, 64)).astype(np.float32)
        load_j, load_t = jax_llama_from_flat, llama_params_from_flat
    else:
        flat, load_j, load_t = opt_flat(seed=5), jax_opt_from_flat, opt_params_from_flat
    want = _flat(_np(load_j(flat, jc, task=task)))
    got = _flat(params_to_numpy(load_t(flat, tc, task=task, device="cpu")))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    if task == "cls":
        bare = {k: v for k, v in flat.items() if k != "score.weight"}
        zeros = load_t(bare, tc, task="cls", device="cpu")["score"]["weight"]
        np.testing.assert_array_equal(zeros, np.asarray(load_j(bare, jc, task="cls")["score"]["weight"]))
        assert not zeros.any() and zeros.shape == (2, 64 if arch == "llama" else 32)


def test_registry_heads():
    names = {("llama", "cls"): "llama_for_sequence_classification",
             ("opt", "cls"): "opt_for_sequence_classification",
             ("opt", "qa"): "opt_for_question_answering"}
    for (arch, task), name in names.items():
        assert port_models.get_model_fn(arch, task).__name__ == name
        assert jax_model_fn(arch, task).__name__ == name
    with pytest.raises(NotImplementedError, match="'qa' of llama"):
        port_models.get_model_fn("llama", "qa")
    with pytest.raises(NotImplementedError, match="'mlm' of opt"):
        port_models.get_model_fn("opt", "mlm")
    with pytest.raises(NotImplementedError, match="'lm' of bert"):
        port_models.get_model_fn("bert", "lm")


# ------------------------------------------------------------------ data


def pair_tokenizer(a, b=None, padding="max_length", max_length=SEQ, truncation=True):
    """A stand-in tokenizer: bytes as ids, a pair joined by id 3,
    truncated and right-padded with 1 to ``max_length``."""
    ids, masks = [], []
    for i, text in enumerate(a):
        row = [2] + [c % VOCAB for c in text.encode()]
        if b is not None:
            row += [3] + [c % VOCAB for c in b[i].encode()]
        row = row[:max_length] if truncation else row
        mask = [1] * len(row)
        if padding == "max_length":
            row, mask = row + [1] * (max_length - len(row)), mask + [0] * (max_length - len(row))
        ids.append(row)
        masks.append(mask)
    return {"input_ids": ids, "attention_mask": masks}


def raw_glue(task, n=12, seed=0):
    """An in-memory GLUE DatasetDict of ``task``'s columns and splits."""
    from datasets import Dataset, DatasetDict

    rng = np.random.default_rng(seed)
    key1, key2 = port_datasets.TASK_TO_KEYS[task]

    def text():
        return " ".join("".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(1, 7)))
                        for _ in range(rng.integers(1, 6)))

    def split(m):
        cols = {key1: [text() for _ in range(m)]}
        if key2:
            cols[key2] = [text() for _ in range(m)]
        cols["label"] = (rng.uniform(0, 5, m).tolist() if task == "stsb"
                         else rng.integers(0, port_datasets.get_num_labels(task), m).tolist())
        cols["idx"] = list(range(m))
        return Dataset.from_dict(cols)

    splits = (["train", "validation_matched", "validation_mismatched"] if task == "mnli"
              else ["train", "validation"])
    return DatasetDict({s: split(n) for s in splits})


@pytest.mark.parametrize("task", ["sst2", "mrpc", "mnli", "stsb"])
def test_preprocess_glue_matches_jax(task):
    raw = raw_glue(task)
    want = jax_datasets.preprocess_dataset_dict(raw, task, pair_tokenizer, "max_length", SEQ)
    got = port_datasets.preprocess_dataset_dict(raw, task, pair_tokenizer, "max_length", SEQ)
    assert set(got) == set(want)
    for split in want:
        assert got[split].to_dict() == want[split].to_dict()
    assert got["validation"].to_dict() == got[
        "validation_matched" if task == "mnli" else "validation"].to_dict()
    assert set(got["train"].column_names) == {"labels", "input_ids", "attention_mask"}
    assert (port_datasets.get_num_labels(task), port_datasets.is_regression_task(task)) == (
        {"mnli": 3, "stsb": 1}.get(task, 2), task == "stsb")


def test_synthetic_cls_dataset_matches_jax():
    for args in ((VOCAB, SEQ, 7), (50272, 128, 16, 2, 3)):
        want = jax_datasets.make_synthetic_cls_dataset(*args)
        got = port_datasets.make_synthetic_cls_dataset(*args)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    with pytest.raises(ValueError, match="Unknown"):
        port_datasets.preprocess_dataset_dict({}, "c4", None, "max_length", 8)


@pytest.mark.parametrize("task", sorted(TASK_TO_METRICS))
def test_glue_metrics_match_jax(task):
    """Random predictions, perfect ones, and all of one class (an undefined
    Matthews correlation or F1 is 0)."""
    rng = np.random.default_rng(len(task))
    n = 50
    if task == "stsb":
        refs = rng.uniform(0, 5, n)
        cases = [refs + rng.normal(0, 1, n), refs]
    else:
        k = port_datasets.get_num_labels(task)
        refs = rng.integers(0, k, n)
        cases = [rng.integers(0, k, n), refs, np.zeros(n, np.int64)]
    for preds in cases:
        got, want = compute_glue_metrics(task, preds, refs), jax_metrics(task, preds, refs)
        assert list(got) == list(want) == list(TASK_TO_METRICS[task])
        for m in want:
            assert abs(got[m] - want[m]) <= 1e-12, (m, got[m], want[m])


@pytest.mark.parametrize("task,num_samples", [("sst2", None), ("sst2", 5), ("cola", 5)])
def test_eval_cls_glue_matches_jax(task, num_samples):
    """7 samples in batches of 3 through the QAT-mode forward (bfp_6bit),
    capped by ``num_samples``."""
    jc, tc = _configs("opt", _toml("bfp_6bit"))
    jp, tp = opt_trees(jc, tc)
    ds = cls_batch(1, n=7, seed=9)
    want = jax_eval_cls(jax_make_forward("opt", "cls", jc), jp, task,
                        jax_datasets.numpy_dataloader(ds, 3), num_samples=num_samples)
    got = eval_cls_glue(make_forward("opt", "cls", tc), tp, task,
                        port_datasets.numpy_dataloader(ds, 3), num_samples=num_samples)
    assert got == want and list(got) == list(TASK_TO_METRICS[task])


# ------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def opt_checkpoint(tmp_path_factory):
    """A tiny OPT classification checkpoint per label count: config.json
    from transformers' OPTConfig, weights in safetensors."""
    from safetensors.numpy import save_file
    from transformers import OPTConfig

    dirs = {}
    for num_labels in (2, 3):
        d = tmp_path_factory.mktemp(f"tiny_opt_{num_labels}")
        OPTConfig(**KW["opt"]).save_pretrained(d)
        save_file(opt_flat(num_labels, seed=num_labels), str(d / "model.safetensors"))
        dirs[num_labels] = d
    return dirs


@pytest.fixture
def offline(monkeypatch):
    """Both packages' eval CLIs read in-memory GLUE splits through the
    stand-in tokenizer."""
    for mod in (jax_cli, port_cli):
        monkeypatch.setattr(mod, "get_raw_dataset_dict", lambda name: raw_glue(name, n=10))
        monkeypatch.setattr(mod, "get_tokenizer", lambda args: pair_tokenizer)


@pytest.mark.parametrize("task", ["sst2", "mnli"])
def test_cli_eval_cls_glue_matches_jax(opt_checkpoint, offline, tmp_path, task):
    """PTQ weights (bfp_6bit) with the QAT-free forward; mnli adds its
    mismatched split's metrics."""
    num_labels = 3 if task == "mnli" else 2
    argv = ["--model_arch", "opt", "--model_name", str(opt_checkpoint[num_labels]),
            "--task", task, "--num_labels", str(num_labels), "--seq_len", str(SEQ),
            "--batch_size", "4", "--quant_config", _toml("bfp_6bit")]
    want = jax_cli.cli_eval_cls_glue(argv)
    got = port_cli.cli_eval_cls_glue(argv + ["--device", "cpu", "--save_dir", str(tmp_path)])
    assert got == want
    assert set(got) == ({"accuracy", "accuracy_mm"} if task == "mnli" else {"accuracy"})
    assert json.loads((tmp_path / "eval_cls.json").read_text()) == got


def test_cls_entry_points_default_to_the_card(opt_checkpoint, offline):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default does not raise here")
    _, tc = _configs("opt")
    for call in (lambda: init_opt_params(tc, task="cls"),
                 lambda: opt_params_from_flat(opt_flat(), tc, task="qa"),
                 lambda: port_cli.cli_eval_cls_glue(
                     ["--model_arch", "opt", "--model_name", str(opt_checkpoint[2]),
                      "--task", "sst2"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
