"""``parallel/``'s sharding plan against the JAX package's, in one process.

For every tensor of the float, int8, sub-byte-T and lane-major sub-byte
trees of Llama (fused and unfused), OPT and BERT, with ``fsdp`` off and on,
the port's ``param_specs`` names the axes of the JAX package's
``param_specs`` (packed fields under JAX's key names: ``0``/``1``,
``words_t``/``scales_t``). Every rank's local tree (``local_params`` at
each coordinate of a 2 x 2 mesh) concatenates back to the whole tree bit
for bit: a fused node part by part, a row-parallel int8 node along its
real K (the padding the packer adds is dropped). A split that would cut a
head, a quant block or the K padding raises ValueError naming the node.
The hybrid mesh groups ranks by host. Trees come from the JAX package's
``init_*_params`` and packers through ``params_from_jax``."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from llm_mixed_q_tpu.models.bert import BertQuantizedConfig as JaxBert
from llm_mixed_q_tpu.models.bert.pack import pack_bert_params as jax_pack_bert
from llm_mixed_q_tpu.models.hf_loader import init_bert_params, init_llama_params, init_opt_params
from llm_mixed_q_tpu.models.llama import LlamaQuantizedConfig as JaxLlama
from llm_mixed_q_tpu.models.llama.pack import pack_llama_params as jax_pack_llama
from llm_mixed_q_tpu.models.opt import OPTQuantizedConfig as JaxOPT
from llm_mixed_q_tpu.models.opt.pack import pack_opt_params as jax_pack_opt
from llm_mixed_q_tpu.parallel import param_specs as jax_param_specs
from llm_mixed_q_tpu.parallel.sharding import _path_names
from llm_mixed_q_torch.kernels.packing import PackedBFP, PackedBFPSub, PackedBFPSubT
from llm_mixed_q_torch.models.hf_loader import params_from_jax
from llm_mixed_q_torch.models.llama import LlamaQuantizedConfig
from llm_mixed_q_torch.parallel import param_specs
from llm_mixed_q_torch.parallel.distributed import hybrid_layout
from llm_mixed_q_torch.parallel.sharding import leaf_spec, local_params

BFP6 = "configs/quantization/bfp_6bit.toml"
LLAMA = dict(vocab_size=96, hidden_size=64, intermediate_size=1088, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
OPT = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, ffn_dim=128,
           num_attention_heads=4, max_position_embeddings=128)
BERT = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=160, max_position_embeddings=64)
SIZES = {"data": 2, "model": 2}
COORDS = [{"data": d, "model": m} for d in range(2) for m in range(2)]


def _identity_t(p):
    return p


def _jax_tree(family, fmt):
    """The JAX package's tree of ``family`` in format ``fmt`` (float, int8,
    int8_unfused, subbyte_t, subbyte_t_unfused, lane)."""
    # the packers jitted: eager, they take ~10x as long
    if family == "llama":
        config = JaxLlama(**LLAMA, quant_config=BFP6)
        params = init_llama_params(config, task="lm", seed=0)
        pack = lambda sub, fuse=True: jax.jit(
            lambda p: jax_pack_llama(p, config, subbyte=sub, fuse=fuse))(params)
    elif family == "opt":
        config = JaxOPT(**OPT, quant_config=BFP6)
        params = init_opt_params(config, task="lm", seed=0)
        pack = lambda sub, fuse=False: jax.jit(
            lambda p: jax_pack_opt(p, config, subbyte=sub))(params)
    else:
        config = JaxBert(**BERT, quant_config=BFP6)
        params = init_bert_params(config, task="cls", seed=0)
        pack = lambda sub, fuse=False: jax.jit(
            lambda p: jax_pack_bert(p, config, subbyte=sub))(params)
    if fmt == "float":
        return params
    if fmt == "lane":  # the packers' transpose left out: lane-major PackedBFPSub words
        with mock.patch("llm_mixed_q_tpu.models.pack_common._to_t", _identity_t):
            return pack(True, fuse=False)
    return pack(fmt.startswith("subbyte"), fuse=not fmt.endswith("unfused"))


TREES = [("llama", f) for f in ("float", "int8", "int8_unfused", "subbyte_t",
                                "subbyte_t_unfused", "lane")]
TREES += [("opt", f) for f in ("float", "int8", "subbyte_t", "lane")]
TREES += [("bert", f) for f in ("float", "int8", "subbyte_t")]


def _jax_specs(tree, fsdp):
    specs = jax_param_specs(tree, fsdp=fsdp)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {":".join(_path_names(path)): tuple(spec) for path, spec in flat
            if "splits" not in _path_names(path)}


@pytest.mark.parametrize("family,fmt", TREES, ids=[f"{a}-{b}" for a, b in TREES])
def test_plan_names_jax_s_axes(family, fmt):
    jtree = _jax_tree(family, fmt)
    tree = params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")
    kind = {"float": None, "lane": PackedBFPSub, "int8": PackedBFP}.get(
        fmt.split("_")[0], PackedBFPSubT)
    assert kind is None or any(isinstance(t, kind) for t in _packed(tree)), fmt
    for fsdp in (False, True):
        want = _jax_specs(jtree, fsdp)
        got = param_specs(tree, fsdp=fsdp)
        assert got.keys() == want.keys()
        for k, spec in want.items():
            # JAX writes P() for a replicated leaf of any rank; the port a None a dim
            assert got[k] == spec or (spec == () and set(got[k]) == {None}), (k, got[k], spec)


def _packed(tree):
    if isinstance(tree, (PackedBFP, PackedBFPSub, PackedBFPSubT)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _packed(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _packed(v)


def _join(parts, dim, splits=None):
    """Rank parts (in rank order) joined along ``dim``; fused parts each on
    their own."""
    if splits is None:
        return torch.cat(parts, dim=dim)
    local = [n // len(parts) for n in splits]
    offsets = np.cumsum([0] + local)
    return torch.cat([torch.cat([p.narrow(dim, offsets[j], local[j]) for p in parts], dim=dim)
                      for j in range(len(splits))], dim=dim)


def _assemble(full, locals_, fsdp, names=(), splits=None):
    """The whole tree from the four ranks' local trees (``locals_`` by
    ``COORDS``), by the plan: each tensor's dims joined along their axes."""
    if isinstance(full, dict):
        sp = full.get("splits")
        return {k: (v if k == "splits" else _assemble(v, [l[k] for l in locals_], fsdp,
                                                        names + (str(k),), sp))
                for k, v in full.items()}
    if isinstance(full, list):
        return [_assemble(v, [l[i] for l in locals_], fsdp, names + (f"#{i}",), splits)
                for i, v in enumerate(full)]
    if isinstance(full, PackedBFP):
        spec = leaf_spec(list(names) + ["0"], full.codes, fsdp)
        k = full.in_features
        codes = _join_axes([l.codes for l in locals_], spec, splits)
        scales = _join_axes([l.scales for l in locals_], spec, splits)
        # the whole K of a row split is the real K: the padding is dropped
        return PackedBFP(codes, scales, full.width, full.block_size, full.out_features,
                         codes.shape[1] if spec[1] else k)
    if isinstance(full, (PackedBFPSub, PackedBFPSubT)):
        fields = ["words_t", "scales_t"] if isinstance(full, PackedBFPSubT) else ["0", "1"]
        return type(full)(*(_join_axes([l[i] for l in locals_],
                                       leaf_spec(list(names) + [fields[i]], full[i], fsdp),
                                       splits) for i in range(2)), *full[2:])
    if isinstance(full, torch.Tensor):
        return _join_axes(locals_, leaf_spec(list(names), full, fsdp), splits)
    return full


def _join_axes(locals_, spec, splits):
    """Join the four ranks' parts (``COORDS`` order: data-major) along the
    spec's axes: "model" first within each data slice, then "data"."""
    by_data = []
    for d in range(2):
        parts = [locals_[i] for i, c in enumerate(COORDS) if c["data"] == d]
        if "model" in spec:
            parts = [_join(parts, spec.index("model"), splits)]
        by_data.append(parts[0])
    if "data" in spec:
        return _join(by_data, spec.index("data"))
    return by_data[0]


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}:{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, torch.Tensor):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}:#{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


CONCAT = [("llama", "float", False), ("llama", "float", True), ("llama", "subbyte_t", False),
          ("llama", "int8_unfused", False), ("llama", "int8", False), ("llama", "lane", False),
          ("opt", "float", True), ("bert", "float", True), ("bert", "int8", False)]


@pytest.mark.parametrize("family,fmt,fsdp", CONCAT,
                         ids=[f"{a}-{b}-{'fsdp' if c else 'tp'}" for a, b, c in CONCAT])
def test_local_trees_join_back_bit_for_bit(family, fmt, fsdp):
    tree = params_from_jax(jax.tree.map(np.asarray, _jax_tree(family, fmt)), device="cpu")
    locals_ = [local_params(tree, c, SIZES, fsdp) for c in COORDS]
    # row-parallel int8 nodes come back at their real K
    want = _real_k(tree) if fmt.startswith("int8") else tree
    _same(_assemble(tree, locals_, fsdp), want)


def _real_k(tree, names=()):
    if isinstance(tree, dict):
        return {k: _real_k(v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_real_k(v, names + (f"#{i}",)) for i, v in enumerate(tree)]
    if isinstance(tree, PackedBFP) and leaf_spec(list(names) + ["0"], tree.codes, False)[1]:
        k, bs = tree.in_features, tree.block_size
        return tree._replace(codes=tree.codes[:, :k], scales=tree.scales[:, :k // bs])
    return tree


def test_row_parallel_int8_node_drops_the_k_padding():
    """down_proj's K of 1088 is packed to 2048 (a stride of 1024): each of
    two ranks keeps 544 real features, 34 blocks, and no padding."""
    tree = params_from_jax(jax.tree.map(np.asarray, _jax_tree("llama", "int8")), device="cpu")
    full = tree["layers"][0]["mlp"]["down_proj"]["weight"]
    assert full.codes.shape[1] == 2048 and full.in_features == 1088
    part = local_params(tree, {"data": 0, "model": 1}, SIZES)["layers"][0]["mlp"]["down_proj"]
    assert part["weight"].codes.shape == (64, 544) and part["weight"].in_features == 544
    assert torch.equal(part["weight"].codes, full.codes[:, 544:1088])


def test_fused_node_keeps_each_part_s_slice():
    tree = params_from_jax(jax.tree.map(np.asarray, _jax_tree("llama", "subbyte_t")),
                           device="cpu")
    node = tree["layers"][0]["self_attn"]["qkv_proj"]
    assert node["splits"] == (64, 32, 32)
    part = local_params(tree, {"data": 1, "model": 1}, SIZES)["layers"][0]["self_attn"]["qkv_proj"]
    assert part["splits"] == (32, 16, 16)
    want = torch.cat([node["weight"].words[:, 32:64], node["weight"].words[:, 80:96],
                      node["weight"].words[:, 112:128]], dim=1)
    assert torch.equal(part["weight"].words, want)
    assert part["weight"].out_features == 64


@pytest.mark.parametrize("what,sizes,match", [
    ("head", {"data": 1, "model": 4}, "cut a head"),
    ("block", {"data": 1, "model": 8}, "multiple of 16"),
    ("padding", {"data": 1, "model": 2}, "K padding")])
def test_a_split_that_cuts_raises_naming_the_node(what, sizes, match):
    """4 model ranks of 2 kv heads cut a head of k_proj; 8 ranks (8 heads of
    8 dims) cut down_proj's 1088 in-features into parts of 136, not whole
    quant blocks of 16; an int8 down_proj of K 1064 splits into halves of
    532, not whole blocks of 16."""
    kw = dict(LLAMA)
    config = LlamaQuantizedConfig(**kw, quant_config=BFP6)
    if what == "padding":
        kw["intermediate_size"] = 1064
        config = LlamaQuantizedConfig(**kw, quant_config=BFP6)
        jc = JaxLlama(**kw, quant_config=BFP6)
        tree = params_from_jax(jax.tree.map(np.asarray, jax.jit(
            lambda p: jax_pack_llama(p, jc, fuse=False))(init_llama_params(jc, task="lm", seed=0))),
            device="cpu")
        node = "layers:#0:mlp:down_proj"
    else:
        tree = params_from_jax(jax.tree.map(np.asarray, _jax_tree("llama", "float")),
                               device="cpu")
        if what == "block":  # 8 heads of 8 dims: the heads split, the block does not
            config = LlamaQuantizedConfig(**{**kw, "num_attention_heads": 8,
                                             "num_key_value_heads": 8}, quant_config=BFP6)
        node = "layers:#0:self_attn:k_proj" if what == "head" else "layers:#0:mlp:down_proj"
    with pytest.raises(ValueError, match=match) as e:
        local_params(tree, {"data": 0, "model": 0}, sizes, config=config)
    assert node in str(e.value)


@pytest.mark.parametrize("world,local,dcn,data,model,ok", [
    (8, 4, None, 2, 2, True), (8, 4, 2, 4, 1, True), (8, 4, 2, 2, 2, True),
    (8, 2, 2, 2, 2, False), (4, 4, None, 2, 2, True)])
def test_hybrid_mesh_groups_ranks_by_host(world, local, dcn, data, model, ok):
    """The "dcn" axis runs over hosts (``local`` contiguous ranks each): a
    [data, model] plane on one host, or an error naming the slice that
    spans hosts."""
    if not ok:
        with pytest.raises(ValueError, match="spans hosts"):
            hybrid_layout(world, local, dcn, data, model)
        return
    ranks = hybrid_layout(world, local, dcn, data, model)
    assert ranks.shape == ((dcn or world // local), data, model)
    for plane in ranks:
        assert len({int(r) // local for r in plane.flat}) == 1
    assert sorted(ranks.flat) == list(range(ranks.size))
