"""The port's BERT family against the JAX package, on the CPU at a tiny size
(2 layers, hidden 64, 4 heads, intermediate 160, vocab 120, the shape of
``tests/test_bert_model.py``): the sequence-classification head under
seven quantization TOMLs, the eight task heads and their losses,
``init_bert_params``, ``bert_params_from_flat``, PTQ, packing (sub-byte
words and int8 codes through the plain ``bfp_matmul``), the registry,
``cli_eval_cls_glue --model_arch bert`` and fault 12 (the eval passes no
``token_type_ids``).

Both packages load one seeded flat state dict under HF BERT names (a
``bert.`` prefix, a pooler, a classifier) or draw ``init_bert_params``
from one seed. Batches hold a right-padded row and segment ids.

Tolerances: logits within 1e-4 of max|logit| (float32 sums in another
order), losses within 1e-5 relative, arrays and packed bytes equal."""

import json

import jax
import numpy as np
import pytest
import torch

import llm_mixed_q_tpu.cli.evals as jax_cli
from llm_mixed_q_tpu.eval import eval_cls_glue as jax_eval_cls
from llm_mixed_q_tpu.models import get_model_fn as jax_model_fn
from llm_mixed_q_tpu.models.api import make_forward as jax_make_forward
from llm_mixed_q_tpu.models.bert import BertQuantizedConfig as JaxConfig
from llm_mixed_q_tpu.models.bert import quantize_bert_params_ptq as jax_ptq
from llm_mixed_q_tpu.models.bert.pack import pack_bert_params as jax_pack
from llm_mixed_q_tpu.models.hf_loader import bert_params_from_flat as jax_from_flat
from llm_mixed_q_tpu.models.hf_loader import init_bert_params as jax_init
import llm_mixed_q_torch.cli.evals as port_cli
from llm_mixed_q_torch import models as port_models
from llm_mixed_q_torch.datasets import numpy_dataloader
from llm_mixed_q_torch.eval import eval_cls_glue
from llm_mixed_q_torch.kernels import PACKED_TYPES, PackedBFP, PackedBFPSubT
from llm_mixed_q_torch.models.api import make_forward
from llm_mixed_q_torch.models.bert import (
    BertQuantizedConfig,
    bert_for_multiple_choice,
    bert_for_sequence_classification,
    pack_bert_params,
    quantize_bert_params_ptq,
)
from llm_mixed_q_torch.models.bert.modeling import ACT2FN
from llm_mixed_q_torch.models.hf_loader import (
    bert_params_from_flat,
    init_bert_params,
    params_from_jax,
    params_to_numpy,
)

VOCAB, SEQ = 120, 19
TINY = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=160, max_position_embeddings=64)
CLS_TOMLS = ["bypass", "bfp_4bit", "bfp_6bit", "integer", "block_minifloat", "log",
             "minifloat_ieee"]
TASKS = ["cls", "mlm", "clm", "nsp", "pretrain", "mc", "token", "qa"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread, so that the many small ops neither
    wait on nor crowd the threads of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toml(stem):
    return None if stem == "bypass" else f"configs/quantization/{stem}.toml"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _configs(stem="bypass", **kw):
    kw = {**TINY, **kw}
    return JaxConfig(**kw, quant_config=_toml(stem)), BertQuantizedConfig(**kw,
                                                                          quant_config=_toml(stem))


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def bert_flat(num_labels=2, seed=0, prefix="bert.", pooler=True, classifier=True):
    """A seeded flat state dict under HF BertForSequenceClassification's
    names; LayerNorms away from 1 and 0."""
    rng = np.random.default_rng(seed)
    h, inter = TINY["hidden_size"], TINY["intermediate_size"]

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def add(flat, name, out, inp=None, norm=False):
        if norm:
            flat[name + ".weight"] = 1 + w(out, scale=0.1)
        else:
            flat[name + ".weight"] = w(out, inp)
        flat[name + ".bias"] = w(out, scale=0.02)

    emb = prefix + "embeddings."
    flat = {emb + "word_embeddings.weight": w(VOCAB, h, scale=0.5),
            emb + "position_embeddings.weight": w(TINY["max_position_embeddings"], h, scale=0.5),
            emb + "token_type_embeddings.weight": w(2, h, scale=0.5)}
    add(flat, emb + "LayerNorm", h, norm=True)
    for i in range(TINY["num_hidden_layers"]):
        lp = f"{prefix}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            add(flat, f"{lp}attention.self.{n}", h, h)
        add(flat, lp + "attention.output.dense", h, h)
        add(flat, lp + "attention.output.LayerNorm", h, norm=True)
        add(flat, lp + "intermediate.dense", inter, h)
        add(flat, lp + "output.dense", h, inter)
        add(flat, lp + "output.LayerNorm", h, norm=True)
    if pooler:
        add(flat, prefix + "pooler.dense", h, h)
    if classifier:
        add(flat, "classifier", num_labels, h)
    return flat


def _batch(b=3, s=SEQ, seed=3):
    """Ids, a mask with row 1 right-padded, segment ids (the second half
    of each row in segment 1)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, size=(b, s)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[1, 13:] = 0
    ids[1, 13:] = 0
    tt = np.zeros_like(ids)
    tt[:, s // 2:] = 1
    return ids, mask, tt


@pytest.mark.parametrize("toml", CLS_TOMLS)
def test_cls_logits_match_jax(toml):
    """From one flat state dict through both packages' loaders: logits (weights
    fake-quantized every call, segment ids given) and the loss."""
    jc, tc = _configs(toml)
    flat = bert_flat()
    jp, tp = _np(jax_from_flat(flat, jc)), bert_params_from_flat(flat, tc, device="cpu")
    ids, mask, tt = _batch()
    labels = np.array([0, 1, 1])
    want = jax.jit(lambda p: jax_model_fn("bert", "cls")(
        p, ids, mask, tt, labels, config=jc))(jp)
    got = bert_for_sequence_classification(tp, _t(ids), _t(mask), _t(tt), _t(labels), config=tc)
    assert got["logits"].shape == (3, 2)
    _close(got["logits"], want["logits"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)


def _head_args(task, seed=0):
    """(positional inputs, keyword labels) of ``task`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    ids, mask, tt = _batch(b=2, s=12, seed=seed)
    if task == "mc":
        ids = rng.integers(2, VOCAB, size=(2, 3, 10)).astype(np.int64)
        mask = np.ones_like(ids)
        mask[0, 1, 7:] = 0
        tt = np.zeros_like(ids)
        return (ids, mask, tt), {"labels": np.array([1, 2])}
    token_labels = np.where(ids % 3 == 0, ids, -100)
    labels = {"cls": {"labels": np.array([0, 1])},
              "mlm": {"labels": token_labels},
              "clm": {"labels": ids},
              "nsp": {"labels": np.array([0, 1])},
              "pretrain": {"labels": token_labels, "next_sentence_label": np.array([1, 0])},
              "token": {"labels": rng.integers(0, 3, size=ids.shape)},
              "qa": {"start_positions": np.array([2, 3]),
                     "end_positions": np.array([5, 7])}}[task]
    return (ids, mask, tt), labels


@pytest.fixture(scope="module", params=[None, "bfp_6bit"], ids=["fp32", "w6a6"])
def heads(request):
    """Every head's JAX outputs, from one compile a quantization."""
    jc, tc = _configs(request.param or "bypass", num_labels=3)
    trees = {task: _np(jax_init(jc, task=task, seed=0)) for task in TASKS}
    args = {task: _head_args(task) for task in TASKS}

    @jax.jit
    def run(trees):
        return {task: jax_model_fn("bert", task)(trees[task], *args[task][0], **args[task][1],
                                                 config=jc) for task in TASKS}

    return tc, trees, args, _np(run(trees))


@pytest.mark.parametrize("task", TASKS)
def test_heads_match_jax(heads, task):
    """Each of the eight heads on ``init_bert_params`` trees: every output and
    the loss, fp32 and W6A6."""
    tc, trees, args, want = heads
    tp = params_from_jax(trees[task], device="cpu")
    inputs, labels = args[task]
    got = port_models.get_model_fn("bert", task)(
        tp, *map(_t, inputs), **{k: _t(v) for k, v in labels.items()}, config=tc)
    assert set(got) == set(want[task])
    for key, value in want[task].items():
        if key == "loss":
            np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-5)
        else:
            assert got[key].shape == value.shape
            _close(got[key], value)


def test_init_bert_params_matches_jax():
    """One seed, one tree, for each of the eight tasks: every array equal."""
    jc, tc = _configs(num_labels=3)
    for task in TASKS:
        want = _np(jax_init(jc, task=task, seed=4))
        got_np = params_to_numpy(init_bert_params(tc, task=task, seed=4, device="cpu"))
        assert jax.tree.structure(got_np) == jax.tree.structure(want), task
        for g, w in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)


def test_ptq_prepare_matches_jax():
    """Weights and biases fake-quantized once are bit-equal; the PTQ forward
    (``quantize_weights=False``) gives JAX's logits and the one-shot
    forward's."""
    jc, tc = _configs("bfp_6bit")
    flat = bert_flat(seed=1)
    jq = _np(jax_ptq(jax_from_flat(flat, jc), jc))
    tq = quantize_bert_params_ptq(bert_params_from_flat(flat, tc, device="cpu"), tc)
    for g, w in zip(jax.tree.leaves(params_to_numpy(tq)), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(g, w)
    ids, mask, _ = _batch()
    want = np.asarray(jax_make_forward("bert", "cls", jc, quantize_weights=False)(
        jq, ids, mask)["logits"])
    got = make_forward("bert", "cls", tc, quantize_weights=False)(tq, _t(ids), _t(mask))
    _close(got["logits"], want)
    one_shot = make_forward("bert", "cls", tc)(bert_params_from_flat(flat, tc, device="cpu"),
                                               _t(ids), _t(mask))
    _close(got["logits"], one_shot["logits"], 1e-5)


@pytest.mark.parametrize("subbyte", [True, False], ids=["subbyte_t", "int8"])
def test_packed_matches_jax(subbyte):
    """Packed leaves bit-equal to the JAX package's ``pack_bert_params``;
    the packed forward (the plain ``bfp_matmul``) within 1e-4 of max|logit|
    of JAX's packed forward, and within the JAX package's own 5e-4 of its
    fake-quant forward."""
    jc, tc = _configs("bfp_6bit")
    flat = bert_flat(seed=2)
    jpk = _np(jax.jit(lambda p: jax_pack(p, jc, subbyte=subbyte))(jax_from_flat(flat, jc)))
    tp = bert_params_from_flat(flat, tc, device="cpu")
    tpk = pack_bert_params(tp, tc, subbyte=subbyte, device="cpu")
    node = tpk["layers"][1]["intermediate"]["dense"]
    assert isinstance(node["weight"], PackedBFPSubT if subbyte else PackedBFP)
    from_jax = params_from_jax(jpk, device="cpu")
    for layer_t, layer_j in zip(tpk["layers"], from_jax["layers"]):
        for part in ("attention", "intermediate", "output"):
            for name, node in layer_t[part].items():
                inner = node["dense"] if name == "output" and part == "attention" else node
                other = (layer_j[part][name]["dense"] if name == "output" and part == "attention"
                         else layer_j[part][name])
                if not isinstance(inner, dict) or not isinstance(inner.get("weight"),
                                                                 PACKED_TYPES):
                    continue
                assert all(torch.equal(a, b) for a, b in zip(inner["weight"][:2],
                                                             other["weight"][:2]))
                assert torch.equal(inner["bias"], other["bias"])
    ids, mask, _ = _batch()
    want = np.asarray(jax_make_forward("bert", "cls", jc, quantize_weights=False)(
        jpk, ids, mask)["logits"])
    got = make_forward("bert", "cls", tc, quantize_weights=False)(tpk, _t(ids), _t(mask))
    _close(got["logits"], want)
    fake = make_forward("bert", "cls", tc)(tp, _t(ids), _t(mask))["logits"]
    np.testing.assert_allclose(got["logits"].numpy(), fake.numpy(), rtol=5e-4, atol=5e-4)


def test_registry_has_bert():
    for task in TASKS:
        assert port_models.get_model_fn("bert", task).__name__ == \
            jax_model_fn("bert", task).__name__
    assert port_models.get_config_cls("bert") is BertQuantizedConfig
    assert port_models.get_params_loader("bert") is bert_params_from_flat
    assert port_models.get_ptq_preparer("bert") is quantize_bert_params_ptq
    assert port_models.get_params_packer("bert") is pack_bert_params
    with pytest.raises(NotImplementedError, match="'lm' of bert"):
        port_models.get_model_fn("bert", "lm")
    with pytest.raises(NotImplementedError, match="'lm' of bert"):
        init_bert_params(_configs()[1], task="lm", device="cpu")
    with pytest.raises(NotImplementedError, match="gpt2"):
        port_models.get_config_cls("gpt2")


@pytest.mark.parametrize("prefix,pooler,classifier", [("bert.", True, True), ("", False, False)],
                         ids=["hf_names", "bare_backbone"])
def test_params_from_flat_and_from_jax(prefix, pooler, classifier):
    """The port's loader equals the JAX package's tree carried over by
    ``params_from_jax``: with or without the ``bert.`` prefix and the pooler,
    a zero classifier without ``classifier.weight``."""
    jc, tc = _configs()
    flat = bert_flat(seed=5, prefix=prefix, pooler=pooler, classifier=classifier)
    got = bert_params_from_flat(flat, tc, device="cpu")
    want = params_from_jax(_np(jax_from_flat(flat, jc)), device="cpu")
    assert ("pooler" in got) == pooler
    assert jax.tree.structure(params_to_numpy(got)) == jax.tree.structure(params_to_numpy(want))
    for g, w in zip(jax.tree.leaves(params_to_numpy(got)), jax.tree.leaves(params_to_numpy(want))):
        np.testing.assert_array_equal(g, w)
    if not classifier:
        assert not got["classifier"]["weight"].any() and got["classifier"]["weight"].shape == (2, 64)


def test_regression_head_matches_jax():
    jc, tc = _configs("bfp_4bit", num_labels=1)
    flat = bert_flat(num_labels=1, seed=6)
    ids, mask, tt = _batch()
    labels = np.array([0.5, 2.0, 4.5], np.float32)
    want = jax.jit(lambda p: jax_model_fn("bert", "cls")(p, ids, mask, tt, labels, config=jc))(
        _np(jax_from_flat(flat, jc)))
    got = bert_for_sequence_classification(bert_params_from_flat(flat, tc, device="cpu"),
                                           _t(ids), _t(mask), _t(tt), _t(labels), config=tc)
    _close(got["logits"], want["logits"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)


def test_fully_padded_row_and_none_inputs():
    """A row whose mask is all 0 gives a uniform softmax (finite logits),
    as JAX's; multiple choice with no mask and no segment ids equals
    explicit ones and zeros."""
    jc, tc = _configs("bfp_6bit")
    flat = bert_flat(seed=7)
    ids, mask, tt = _batch()
    mask[2] = 0
    want = jax.jit(lambda p: jax_model_fn("bert", "cls")(p, ids, mask, tt, config=jc))(
        _np(jax_from_flat(flat, jc)))
    got = bert_for_sequence_classification(bert_params_from_flat(flat, tc, device="cpu"),
                                           _t(ids), _t(mask), _t(tt), config=tc)
    assert torch.isfinite(got["logits"]).all()
    _close(got["logits"], want["logits"])
    tp = init_bert_params(tc, task="mc", seed=1, device="cpu")
    mc_ids = _t(np.random.default_rng(1).integers(2, VOCAB, size=(2, 3, 10)))
    bare = bert_for_multiple_choice(tp, mc_ids, config=tc)["logits"]
    full = bert_for_multiple_choice(tp, mc_ids, torch.ones_like(mc_ids), torch.zeros_like(mc_ids),
                                    config=tc)["logits"]
    assert bare.shape == (2, 3) and torch.equal(bare, full)


def test_gelu_is_exact():
    """BERT's "gelu" is the erf form (OPT's "gelu" is tanh's, fault 6)."""
    x = torch.linspace(-4, 4, 101)
    exact = 0.5 * x * (1 + torch.erf(x / 2 ** 0.5))
    torch.testing.assert_close(ACT2FN["gelu"](x), exact, rtol=0, atol=1e-6)
    assert (ACT2FN["gelu"](x) - ACT2FN["gelu_new"](x)).abs().max() > 1e-4


# ------------------------------------------------------------------ CLI


def pair_tokenizer(a, b=None, padding="max_length", max_length=16, truncation=True):
    """A stand-in tokenizer: bytes as ids, a pair joined by id 3, truncated
    and right-padded with 0 to ``max_length``."""
    ids, masks = [], []
    for i, text in enumerate(a):
        row = [2] + [c % VOCAB for c in text.encode()]
        if b is not None:
            row += [3] + [c % VOCAB for c in b[i].encode()]
        row = row[:max_length] if truncation else row
        mask = [1] * len(row)
        if padding == "max_length":
            row, mask = row + [0] * (max_length - len(row)), mask + [0] * (max_length - len(row))
        ids.append(row)
        masks.append(mask)
    return {"input_ids": ids, "attention_mask": masks}


def raw_glue(task, n=10, seed=0):
    from datasets import Dataset, DatasetDict

    from llm_mixed_q_torch.datasets import TASK_TO_KEYS

    rng = np.random.default_rng(seed)
    key1, key2 = TASK_TO_KEYS[task]

    def text():
        return " ".join("".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(1, 7)))
                        for _ in range(rng.integers(1, 6)))

    def split(m):
        cols = {key1: [text() for _ in range(m)], "label": rng.integers(0, 2, m).tolist(),
                "idx": list(range(m))}
        if key2:
            cols[key2] = [text() for _ in range(m)]
        return Dataset.from_dict(cols)

    return DatasetDict({s: split(n) for s in ("train", "validation")})


@pytest.fixture(scope="module")
def bert_checkpoint(tmp_path_factory):
    """A tiny BERT classification checkpoint: config.json as
    ``bert-base-uncased``'s keys have it, weights in safetensors."""
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("tiny_bert")
    (d / "config.json").write_text(json.dumps({
        **TINY, "model_type": "bert", "hidden_act": "gelu", "type_vocab_size": 2,
        "layer_norm_eps": 1e-12, "pad_token_id": 0, "architectures": ["BertForSequenceClassification"]}))
    save_file(bert_flat(seed=8), str(d / "model.safetensors"))
    return d


@pytest.fixture
def offline(monkeypatch):
    for mod in (jax_cli, port_cli):
        monkeypatch.setattr(mod, "get_raw_dataset_dict", lambda name: raw_glue(name))
        monkeypatch.setattr(mod, "get_tokenizer", lambda args: pair_tokenizer)


def test_cli_eval_cls_glue_bert_matches_jax(bert_checkpoint, offline, tmp_path):
    """``cli_eval_cls_glue --model_arch bert``: PTQ (sst2) and packed (mrpc)
    weights under bfp_6bit, the metrics equal to JAX's."""
    for task, extra in (("sst2", []), ("mrpc", ["--packed"])):
        argv = ["--model_arch", "bert", "--model_name", str(bert_checkpoint), "--task", task,
                "--seq_len", "16", "--batch_size", "4", "--quant_config",
                _toml("bfp_6bit")] + extra
        want = jax_cli.cli_eval_cls_glue(argv)
        got = port_cli.cli_eval_cls_glue(argv + ["--device", "cpu", "--save_dir", str(tmp_path)])
        assert got == want
        assert set(got) == ({"accuracy", "f1"} if task == "mrpc" else {"accuracy"})
        assert json.loads((tmp_path / "eval_cls.json").read_text()) == got


def test_eval_ignores_token_type_ids_as_jax_does():
    """Fault 12: ``eval_cls_glue`` calls the forward with ids and mask
    only, so a pair task's second segment is seen as segment 0, in JAX and
    in the port alike: the metrics with segment ids in the batches equal
    those without, and equal JAX's, though the model given the segment ids
    gives other logits."""
    jc, tc = _configs("bfp_6bit")
    flat = bert_flat(seed=9)
    jp, tp = _np(jax_from_flat(flat, jc)), bert_params_from_flat(flat, tc, device="cpu")
    ids, mask, tt = _batch(b=8, s=16, seed=10)
    data = {"input_ids": ids, "attention_mask": mask, "labels": np.arange(8) % 2}
    with_tt = {**data, "token_type_ids": tt}
    fwd = make_forward("bert", "cls", tc, quantize_weights=False)
    got = eval_cls_glue(fwd, tp, "mrpc", numpy_dataloader(with_tt, batch_size=4))
    assert got == eval_cls_glue(fwd, tp, "mrpc", numpy_dataloader(data, batch_size=4))
    want = jax_eval_cls(jax_make_forward("bert", "cls", jc, quantize_weights=False), jp, "mrpc",
                        numpy_dataloader(with_tt, batch_size=4))
    assert got == want
    seg0 = bert_for_sequence_classification(tp, _t(ids), _t(mask), config=tc,
                                            quantize_weights=False)["logits"]
    seg = bert_for_sequence_classification(tp, _t(ids), _t(mask), _t(tt), config=tc,
                                           quantize_weights=False)["logits"]
    assert (seg - seg0).abs().max() > 1e-3 * seg0.abs().max()
