"""Llama, OPT and BERT parameters for the port (counterpart of the JAX
package's ``models/hf_loader.py``).

- ``init_llama_params`` / ``init_opt_params``: random weights from a
  ``torch.Generator``, made on the target device one layer at a time; with
  ``pack=`` each layer is packed as soon as it exists, so a 7B model never
  holds all its float32 weights at once. The task head (``lm_head``, the
  ``cls`` task's ``score`` or OPT's ``qa`` task's ``qa_outputs``) is drawn
  last, so one seed gives every task the same backbone.
- ``init_bert_params``: BERT's tree for each of its eight tasks, drawn
  with numpy exactly as the JAX package draws it (the same seed gives the
  same arrays), then moved to the target device.
- ``load_flat_state_dict``: the ``{hf_name: tensor}`` dict of a local
  checkpoint directory (safetensors or ``pytorch_model*.bin``).
- ``llama_params_from_flat`` / ``opt_params_from_flat`` /
  ``bert_params_from_flat``: such a flat dict (numpy or torch values) as
  the port's Llama / OPT / BERT tree, for the tasks ``lm`` and ``cls`` (and
  OPT's ``qa``; BERT's backbone with an optional ``bert.`` prefix and
  pooler, and the ``cls`` head); a checkpoint without ``score.weight`` or
  ``classifier.weight`` gets a zero head, as in the JAX package.
- ``params_from_jax``: the JAX package's parameter tree, given as numpy
  arrays (``jax.tree.map(np.asarray, params)``), as the port's tree. Packed
  nodes (``PackedBFP``, ``PackedBFPSub``, ``PackedBFPSubT``) keep their
  bytes; fused nodes keep their ``splits``.
- ``params_to_numpy``: the way back, for checking a round trip.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..kernels.packing import PACKED_TYPES

_PACKED_BY_NAME = {cls.__name__: cls for cls in PACKED_TYPES}
TASKS = {"llama": ("lm", "cls"), "opt": ("lm", "cls", "qa"),
         "bert": ("cls", "mlm", "clm", "nsp", "pretrain", "mc", "token", "qa")}


def _check_task(arch: str, task: str):
    if task not in TASKS[arch]:
        raise NotImplementedError(f"task {task!r} of {arch} is not ported "
                                  f"(ported: {list(TASKS[arch])})")


def tree_map_tensors(fn, tree):
    """Apply ``fn`` to every tensor of a parameter tree (packed nodes too)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, PACKED_TYPES):
        return tree._replace(**{f: fn(getattr(tree, f)) for f in tree._fields[:2]})
    if isinstance(tree, dict):
        return {k: tree_map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_tensors(fn, v) for v in tree]
    return tree


@torch.no_grad()
def init_llama_params(config, task: str = "lm", seed: int = 0, device=None,
                      pack: dict | None = None) -> dict:
    """Random-init parameter dict: N(0, 0.02) linear and embedding weights
    (``lm_head``, or ``score`` [num_labels, hidden] for ``cls``), unit
    norms. ``pack``: keyword arguments of ``pack_llama_params``
    (``subbyte``, ``fuse``, ``bf16_embed``) to pack each layer as it is
    made."""
    from .llama.pack import pack_llama_layer, pack_llama_params

    _check_task("llama", task)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, inter, v = config.hidden_size, config.intermediate_size, config.vocab_size
    kvh = config.num_key_value_heads * config.head_dim

    def w(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def ones(n):
        return torch.ones(n, device=device)

    pack = dict(pack or {})
    bf16_embed = pack.pop("bf16_embed", False)
    layers = []
    for i in range(config.num_hidden_layers):
        layer = {
            "input_layernorm": {"weight": ones(h)},
            "post_attention_layernorm": {"weight": ones(h)},
            "self_attn": {
                "q_proj": {"weight": w(h, h)},
                "k_proj": {"weight": w(kvh, h)},
                "v_proj": {"weight": w(kvh, h)},
                "o_proj": {"weight": w(h, h)},
            },
            "mlp": {
                "gate_proj": {"weight": w(inter, h)},
                "up_proj": {"weight": w(inter, h)},
                "down_proj": {"weight": w(h, inter)},
            },
        }
        if pack and config.quant_config is not None:
            layer = pack_llama_layer(
                layer, config.quant_config[f"model_layer_{i}"], **pack)
        layers.append(layer)
    params = {
        "embed_tokens": {"weight": w(v, h)},
        "layers": layers,
        "norm": {"weight": ones(h)},
    }
    if task == "lm":
        params["lm_head"] = {"weight": w(v, h)}
    else:
        params["score"] = {"weight": w(config.num_labels, h)}
    if bf16_embed:
        params = pack_llama_params(params, config, bf16_embed=True,
                                   device=device, **pack)
    return params


@torch.no_grad()
def init_opt_params(config, task: str = "lm", seed: int = 0, device=None,
                    pack: dict | None = None) -> dict:
    """Random-init OPT parameter dict, the tree of ``opt_params_from_flat``:
    N(0, 0.02) weights and embeddings, zero biases, unit layer norms; with a
    ``word_embed_proj_dim`` other than ``hidden_size`` also project_in/out;
    the ``cls`` task's ``score`` [num_labels, word_embed_proj_dim], the
    ``qa`` task's ``qa_outputs`` [2, word_embed_proj_dim] with a zero bias.
    ``pack``: keyword arguments of ``pack_opt_params`` (``subbyte``) to pack
    each layer as it is made."""
    from .opt.pack import pack_opt_layer

    _check_task("opt", task)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, ffn, v, d = (config.hidden_size, config.ffn_dim, config.vocab_size,
                    config.word_embed_proj_dim)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def lin(out, inp):
        return {"weight": w(out, inp), "bias": torch.zeros(out, device=device)}

    def ln(n):
        return {"weight": torch.ones(n, device=device), "bias": torch.zeros(n, device=device)}

    layers = []
    for i in range(config.num_hidden_layers):
        layer = {
            "self_attn": {n: lin(h, h) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": ln(h),
            "fc1": lin(ffn, h),
            "fc2": lin(h, ffn),
            "final_layer_norm": ln(h),
        }
        if pack is not None and config.quant_config is not None:
            layer = pack_opt_layer(layer, config.quant_config[f"model_layer_{i}"], **pack)
        layers.append(layer)
    params = {
        "embed_tokens": {"weight": w(v, d)},
        # +2 offset rows (the reference's OPTLearnedPositionalEmbedding)
        "embed_positions": {"weight": w(config.max_position_embeddings + 2, h)},
        "layers": layers,
        "final_layer_norm": ln(h),
    }
    if d != h:
        params["project_in"] = {"weight": w(h, d)}
        params["project_out"] = {"weight": w(d, h)}
    if task == "cls":
        params["score"] = {"weight": w(config.num_labels, d)}
    elif task == "qa":
        params["qa_outputs"] = lin(2, d)
    return params


def init_bert_params(config, task: str = "cls", seed: int = 0, device=None) -> dict:
    """Random-init BERT parameter dict, the tree of ``bert_params_from_flat``
    with the head of ``task``: N(0, 0.02) weights and embeddings drawn in
    float32 from ``numpy.random.default_rng(seed)`` in the JAX package's
    order (so both packages' trees are equal), zero biases, unit layer
    norms, a pooler; ``cls`` and ``token`` a classifier of ``num_labels``,
    ``mc`` one of 1 logit, ``qa`` ``qa_outputs``, and ``mlm``, ``clm``,
    ``nsp`` and ``pretrain`` the LM prediction head (its decoder tied to
    the word embeddings), with ``seq_relationship`` for the last two."""
    _check_task("bert", task)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    h, inter, v = config.hidden_size, config.intermediate_size, config.vocab_size

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    def lin(out, inp):
        return {"weight": w(out, inp), "bias": np.zeros(out, np.float32)}

    def ln(d):
        return {"weight": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    layers = [{
        "attention": {"query": lin(h, h), "key": lin(h, h), "value": lin(h, h),
                      "output": {"dense": lin(h, h), "LayerNorm": ln(h)}},
        "intermediate": {"dense": lin(inter, h)},
        "output": {"dense": lin(h, inter), "LayerNorm": ln(h)},
    } for _ in range(config.num_hidden_layers)]
    params = {
        "embeddings": {
            "word_embeddings": {"weight": w(v, h)},
            "position_embeddings": {"weight": w(config.max_position_embeddings, h)},
            "token_type_embeddings": {"weight": w(config.type_vocab_size, h)},
            "LayerNorm": ln(h),
        },
        "layers": layers,
        "pooler": {"dense": lin(h, h)},
    }
    if task in ("cls", "token"):
        params["classifier"] = lin(config.num_labels, h)
    elif task == "mc":
        params["classifier"] = lin(1, h)
    elif task == "qa":
        params["qa_outputs"] = lin(2, h)
    else:
        head = {"transform": {"dense": lin(h, h), "LayerNorm": ln(h)},
                "bias": np.zeros(v, np.float32)}
        if task in ("pretrain", "nsp"):
            head["seq_relationship"] = lin(2, h)
        params["cls"] = head
    return params_from_jax(params, device)


def load_flat_state_dict(model_dir) -> dict[str, torch.Tensor]:
    """``{hf_name: tensor}`` (CPU, the checkpoint's dtype) from the local
    files of a model directory: ``*.safetensors``, else
    ``pytorch_model*.bin``."""
    model_dir = Path(model_dir)
    st_files = sorted(model_dir.glob("*.safetensors"))
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    flat: dict[str, torch.Tensor] = {}
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            flat.update(load_file(str(f)))
    elif bin_files:
        for f in bin_files:
            flat.update(torch.load(f, map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(f"No safetensors/bin weights in {model_dir}")
    return flat


class _Flat:
    """A flat ``{hf_name: array}`` dict (numpy or torch) read as float32
    tensors on ``device``, one leaf at a time."""

    def __init__(self, flat: dict, device):
        self.flat, self.device = flat, resolve_device(device)

    def __contains__(self, name):
        return name in self.flat

    def prefixed(self, prefix: str) -> bool:
        return any(k.startswith(prefix) for k in self.flat)

    def leaf(self, name: str) -> torch.Tensor:
        if name not in self.flat:
            raise KeyError(f"Missing weight: {name}")
        v = self.flat[name]
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return v.to(device=self.device, dtype=torch.float32)

    def leaf_or_zeros(self, name: str, *shape) -> torch.Tensor:
        if name in self.flat:
            return self.leaf(name)
        return torch.zeros(shape, device=self.device)

    def linear(self, prefix: str) -> dict:
        node = {"weight": self.leaf(f"{prefix}.weight")}
        if f"{prefix}.bias" in self.flat:
            node["bias"] = self.leaf(f"{prefix}.bias")
        return node


def llama_params_from_flat(flat: dict, config, task: str = "lm", device=None) -> dict:
    """HF Llama names (with or without the ``model.`` prefix) -> the port's
    tree, float32 on ``device``. Without ``lm_head.weight`` an untied
    config takes the embedding table as its lm_head."""
    _check_task("llama", task)
    f = _Flat(flat, device)
    pre = "model." if f.prefixed("model.") else ""
    layers = []
    for i in range(config.num_hidden_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "input_layernorm": {"weight": f.leaf(lp + "input_layernorm.weight")},
            "post_attention_layernorm": {"weight": f.leaf(lp + "post_attention_layernorm.weight")},
            "self_attn": {n: f.linear(lp + f"self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {n: f.linear(lp + f"mlp.{n}") for n in ("gate_proj", "up_proj", "down_proj")},
        })
    params = {
        "embed_tokens": {"weight": f.leaf(pre + "embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": f.leaf(pre + "norm.weight")},
    }
    if task == "cls":
        params["score"] = {"weight": f.leaf_or_zeros("score.weight", config.num_labels,
                                                     config.hidden_size)}
    elif "lm_head.weight" in f:
        params["lm_head"] = {"weight": f.leaf("lm_head.weight")}
    elif not config.tie_word_embeddings:
        params["lm_head"] = {"weight": f.leaf(pre + "embed_tokens.weight")}
    return params


def opt_params_from_flat(flat: dict, config, task: str = "lm", device=None) -> dict:
    """HF OPT names (with or without the ``model.decoder.`` / ``decoder.``
    prefix) -> the port's tree, float32 on ``device``."""
    _check_task("opt", task)
    f = _Flat(flat, device)
    pre = next((c for c in ("model.decoder.", "decoder.") if f.prefixed(c + "embed_tokens.")), "")
    layers = []
    for i in range(config.num_hidden_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "self_attn": {n: f.linear(lp + f"self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": f.linear(lp + "self_attn_layer_norm"),
            "fc1": f.linear(lp + "fc1"),
            "fc2": f.linear(lp + "fc2"),
            "final_layer_norm": f.linear(lp + "final_layer_norm"),
        })
    params = {
        "embed_tokens": {"weight": f.leaf(pre + "embed_tokens.weight")},
        "embed_positions": {"weight": f.leaf(pre + "embed_positions.weight")},
        "layers": layers,
    }
    if pre + "final_layer_norm.weight" in f:
        params["final_layer_norm"] = f.linear(pre + "final_layer_norm")
    for proj in ("project_in", "project_out"):
        if f"{pre}{proj}.weight" in f:
            params[proj] = {"weight": f.leaf(f"{pre}{proj}.weight")}
    if task == "lm" and "lm_head.weight" in f and not config.tie_word_embeddings:
        params["lm_head"] = {"weight": f.leaf("lm_head.weight")}
    elif task == "cls":
        params["score"] = {"weight": f.leaf_or_zeros("score.weight", config.num_labels,
                                                     config.word_embed_proj_dim)}
    elif task == "qa":
        params["qa_outputs"] = f.linear("qa_outputs")
    return params


def bert_params_from_flat(flat: dict, config, task: str = "cls", device=None) -> dict:
    """HF BERT names (with or without the ``bert.`` prefix) -> the port's
    tree, float32 on ``device``: the backbone, the pooler when the
    checkpoint has one, and for ``cls`` the classifier (zeros without
    ``classifier.weight``). Other tasks get no head, as in the JAX
    package."""
    _check_task("bert", task)
    f = _Flat(flat, device)
    pre = "bert." if f.prefixed("bert.") else ""
    emb = pre + "embeddings."
    params = {
        "embeddings": {
            n: {"weight": f.leaf(f"{emb}{n}.weight")}
            for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")
        },
        "layers": [],
    }
    params["embeddings"]["LayerNorm"] = f.linear(emb + "LayerNorm")
    for i in range(config.num_hidden_layers):
        lp = f"{pre}encoder.layer.{i}."
        params["layers"].append({
            "attention": {
                **{n: f.linear(f"{lp}attention.self.{n}") for n in ("query", "key", "value")},
                "output": {"dense": f.linear(lp + "attention.output.dense"),
                           "LayerNorm": f.linear(lp + "attention.output.LayerNorm")},
            },
            "intermediate": {"dense": f.linear(lp + "intermediate.dense")},
            "output": {"dense": f.linear(lp + "output.dense"),
                       "LayerNorm": f.linear(lp + "output.LayerNorm")},
        })
    if pre + "pooler.dense.weight" in f:
        params["pooler"] = {"dense": f.linear(pre + "pooler.dense")}
    if task == "cls":
        params["classifier"] = (
            f.linear("classifier") if "classifier.weight" in f else
            {"weight": torch.zeros((config.num_labels, config.hidden_size), device=f.device),
             "bias": torch.zeros(config.num_labels, device=f.device)})
    return params


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree, device=None):
    """The JAX package's parameter tree (numpy leaves) -> the port's."""
    device = resolve_device(device)

    def conv(node):
        name = type(node).__name__
        if name in _PACKED_BY_NAME and hasattr(node, "_fields"):
            fields = dict(zip(node._fields, node))
            cls = _PACKED_BY_NAME[name]
            return cls(*(
                _tensor_from_numpy(np.asarray(fields[f]), device)
                if i < 2 else int(fields[f])
                for i, f in enumerate(cls._fields)
            ))
        if isinstance(node, dict):
            return {k: (tuple(int(s) for s in v) if k == "splits" else conv(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if isinstance(node, np.ndarray) or np.isscalar(node):
            return _tensor_from_numpy(np.asarray(node), device)
        raise TypeError(f"unexpected parameter leaf {type(node)}")

    return conv(np_tree)


def params_to_numpy(params):
    """The port's parameter tree -> numpy leaves (bf16 as float32)."""

    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map_tensors(to_np, params)
