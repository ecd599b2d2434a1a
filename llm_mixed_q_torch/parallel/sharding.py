"""Tensor- and data-parallel sharding rules for the model trees
(counterpart of the JAX package's ``parallel/sharding.py``).

The rules are the JAX package's, leaf by leaf (``leaf_spec``, a copy of
its ``_leaf_spec``): Megatron TP over the "model" axis

- column-parallel (out-features, axis 0): q/k/v, gate/up (Llama), fc1
  (OPT), query/key/value and intermediate.dense (BERT), the embedding,
  lm_head, score and classifier along the vocabulary or the labels;
- row-parallel (in-features, axis 1): o_proj/down_proj, out_proj/fc2,
  and BERT's attention.output.dense and output.dense;
- norms and the biases of row-parallel nodes replicated;

and, with ``fsdp``, the other axis of a 2-D weight over "data" (ZeRO-3
storage). Packed leaves follow their node: ``PackedBFP`` codes and scales
split as the weight; sub-byte ``PackedBFPSub`` words and its rank-3 scales
and ``PackedBFPSubT`` ``words_t``/``scales_t`` split on their out axis in
a column-parallel node, and stay replicated in a row-parallel one (a K
split must land on a packing tile).

A spec is a tuple of axis names (or None) a dim, as JAX's
``PartitionSpec``. The JAX package gives XLA a global array and lets it
reshard; the port has no resharder, so ``shard_params`` returns this
rank's local tree and differs from a plain even cut in two places:

- a fused ``qkv_proj``/``gate_up_proj`` splits each of its parts (q, k, v;
  gate, up) and keeps the rank's slice of each, with local ``splits``
  (JAX cuts the concatenated axis and XLA moves the rows);
- a row-parallel ``PackedBFP`` splits its real K (``in_features``), not the
  padded K the int8 packer rounds up to 1024 (the rank's x holds the real
  features).

A split that would cut a quant block, a head or a packed leaf's K padding
raises ValueError naming the node.
"""

from __future__ import annotations

import torch

from ..kernels.packing import PackedBFP, PackedBFPSub, PackedBFPSubT

COLUMN_PARALLEL = (
    "q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",  # llama
    "qkv_proj", "gate_up_proj",  # fused packed projections
    "fc1",  # opt
    "query", "key", "value", "intermediate",  # bert
    "embed_tokens", "lm_head", "score", "classifier",
)
ROW_PARALLEL = ("o_proj", "down_proj", "out_proj", "fc2")
# the nodes whose out (column) or in (row) features are heads
_HEAD_NODES = ("q_proj", "k_proj", "v_proj", "qkv_proj", "query", "key", "value", "o_proj",
               "out_proj")


def _field_names(node) -> list[str]:
    """The key names of a packed node's two tensors in the JAX package's
    tree paths."""
    return ["words_t", "scales_t"] if isinstance(node, PackedBFPSubT) else ["0", "1"]


def leaf_spec(names: list[str], leaf: torch.Tensor, fsdp: bool) -> tuple:
    """The spec of a tensor at the path ``names`` (dict keys, "#i" for list
    indices, "0"/"1" or "words_t"/"scales_t" for a packed node's fields), as
    the JAX package's ``_leaf_spec``."""
    is_weight_like = names[-1] in ("weight", "0", "1") or (
        len(names) >= 2 and names[-2] == "weight")
    row = any(n in ROW_PARALLEL for n in names) or (
        "output" in names and "dense" in names and "intermediate" not in names)
    col = any(n in COLUMN_PARALLEL for n in names) and not row
    ndim = leaf.ndim
    data_axis = "data" if fsdp else None
    if names[-1] == "bias":
        return ("model",) if col and ndim == 1 else (None,) * ndim
    if names[-1] in ("words_t", "scales_t"):
        return (None, "model") if col else (None, None)
    if ndim == 3 and is_weight_like:
        return (None, "model", None) if col else (None, None, None)
    if ndim == 2 and is_weight_like and leaf.dtype == torch.uint32:
        return ("model", data_axis) if col else (None, None)
    if ndim == 2 and is_weight_like:
        if row:
            return (data_axis, "model")
        if col:
            return ("model", data_axis)
        return (data_axis, None)
    return (None,) * ndim


def _tensors(tree, names=()):
    """(names, tensor) of every tensor of a tree, packed fields by their
    JAX key names."""
    if isinstance(tree, torch.Tensor):
        yield list(names), tree
    elif isinstance(tree, (PackedBFP, PackedBFPSub, PackedBFPSubT)):
        for field, t in zip(_field_names(tree), tree[:2]):
            yield list(names) + [field], t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k != "splits":
                yield from _tensors(v, names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, names + (f"#{i}",))


def param_specs(params, fsdp: bool = False) -> dict:
    """{":"-joined path: spec} of every tensor of ``params`` (packed
    fields included, under the JAX package's key names)."""
    return {":".join(names): leaf_spec(names, t, fsdp) for names, t in _tensors(params)}


# ----------------------------------------------------------- local parts


def _cut(t: torch.Tensor, dim: int, parts: int, index: int, what: str, unit: int = 1):
    """Part ``index`` of ``parts`` even parts of ``t`` along ``dim``, each
    a multiple of ``unit`` long."""
    n = t.shape[dim]
    if n % parts or (n // parts) % unit:
        raise ValueError(f"{what}: {n} along dim {dim} does not split in {parts} parts of a "
                         f"multiple of {unit}")
    m = n // parts
    return t.narrow(dim, index * m, m)


def _cut_parts(t, dim, splits, parts, index, what, unit=1):
    """The rank's part of each of the fused parts (lengths ``splits``
    along ``dim``), concatenated."""
    out, start = [], 0
    for n in splits:
        out.append(_cut(t.narrow(dim, start, n), dim, parts, index, what, unit))
        start += n
    return torch.cat(out, dim=dim)


def local_part(t: torch.Tensor, spec: tuple, coords: dict, sizes: dict, what: str = "tensor",
               splits=None, units=None) -> torch.Tensor:
    """This rank's part of ``t`` under ``spec``: every dim named by an axis
    cut in ``sizes[axis]`` even parts, part ``coords[axis]`` kept (each
    fused part on its own, given ``splits``, along the "model" dim);
    ``units`` {dim: length} a part must be a multiple of."""
    for dim, axis in enumerate(spec):
        if axis is None or sizes[axis] == 1:
            continue
        unit = (units or {}).get(dim, 1)
        if splits is not None and axis == "model":
            t = _cut_parts(t, dim, splits, sizes[axis], coords[axis], what, unit)
        else:
            t = _cut(t, dim, sizes[axis], coords[axis], what, unit)
    return t.contiguous()


def _packed_bfp_part(p: PackedBFP, spec, coords, sizes, what, splits):
    """A PackedBFP's part: out rows as a tensor's axis 0 (fused parts on
    their own), K by the real ``in_features`` (the padding dropped), in
    whole blocks."""
    codes, scales, out, k = p.codes, p.scales, p.out_features, p.in_features
    out_axis, k_axis = spec
    if out_axis is not None and sizes[out_axis] > 1:
        n, i = sizes[out_axis], coords[out_axis]
        cut = (lambda t: _cut_parts(t, 0, splits, n, i, what)) if (
            splits is not None and out_axis == "model") else (lambda t: _cut(t, 0, n, i, what))
        codes, scales, out = cut(codes), cut(scales), out // n
    if k_axis is not None and sizes[k_axis] > 1:
        n, i = sizes[k_axis], coords[k_axis]
        if k % n or (k // n) % p.block_size:
            raise ValueError(f"{what}: K {k} does not split in {n} parts of whole blocks of "
                             f"{p.block_size} (a split inside the K padding or a block)")
        m = k // n
        codes = codes[:, i * m:(i + 1) * m]
        scales = scales[:, i * m // p.block_size:(i + 1) * m // p.block_size]
        k = m
    return PackedBFP(codes.contiguous(), scales.contiguous(), p.width, p.block_size, out, k)


def _check_heads(what, lengths, parts, head_dim):
    for n in lengths:
        if n % parts or (n // parts) % head_dim:
            raise ValueError(f"{what}: {n} features in {parts} parts cut a head of {head_dim}")


def _node_blocks(config, names):
    """The [1, bs] blocks (weight, data_in) of the node at ``names`` in a
    layer of ``config``'s quant config, or () where there is none."""
    qc = getattr(config, "quant_config", None)
    if qc is None or "layers" not in names:
        return ()
    i = names.index("layers")
    node = qc.get(f"model_layer_{names[i + 1][1:]}")
    for key in names[i + 2:]:
        if not isinstance(node, dict) or key not in node:
            return ()
        node = node[key]
    if not isinstance(node, dict) or node.get("bypass", False):
        return ()
    return tuple(node[k][-1] for k in ("weight_block_size", "data_in_block_size")
                 if isinstance(node.get(k), (list, tuple)) and node[k][-1] > 0)


def _local_node(node, names, coords, sizes, fsdp, config):
    """A linear node's local part: its weight (float or packed), bias and
    ``splits``."""
    what = ":".join(names)
    splits = node.get("splits")
    w = node["weight"]
    packed = isinstance(w, (PackedBFP, PackedBFPSub, PackedBFPSubT))
    tensors = tuple(w[:2]) if packed else (w,)
    fields = ([names + ["weight", f] for f in _field_names(w)] if packed
              else [names + ["weight"]])
    specs = [leaf_spec(n, t, fsdp) for n, t in zip(fields, tensors)]
    out_dim = 1 if isinstance(w, PackedBFPSubT) else 0
    out_axis = specs[0][out_dim] if len(specs[0]) > out_dim else None
    in_axis = (specs[0][1] if len(specs[0]) == 2 and not isinstance(w, (PackedBFPSub,
                                                                          PackedBFPSubT))
               else None)
    head_dim = getattr(config, "head_dim", None)
    if head_dim and any(n in _HEAD_NODES for n in names):
        if out_axis == "model":
            _check_heads(what, splits or (w.out_features if packed else w.shape[0],),
                         sizes["model"], head_dim)
        if in_axis == "model":
            _check_heads(what, (w.in_features if packed else w.shape[1],), sizes["model"],
                         head_dim)
    out = dict(node)
    if isinstance(w, PackedBFP):
        out["weight"] = _packed_bfp_part(w, specs[0], coords, sizes, what, splits)
    elif packed:
        parts = [local_part(t, s, coords, sizes, what, splits) for t, s in zip(tensors, specs)]
        out["weight"] = type(w)(*parts, w.width, w.block_size, parts[0].shape[out_dim],
                                w.in_features)
    else:
        units = None
        if in_axis == "model":  # the rank's in-features hold whole quant blocks
            units = {1: max(_node_blocks(config, names), default=1)}
        out["weight"] = local_part(w, specs[0], coords, sizes, what, splits, units)
    if node.get("bias") is not None:
        b = node["bias"]
        out["bias"] = local_part(b, leaf_spec(names + ["bias"], b, fsdp), coords, sizes, what,
                                 splits)
    if splits is not None and out_axis == "model":
        out["splits"] = tuple(n // sizes["model"] for n in splits)
    return out


def local_params(params, coords: dict, sizes: dict, fsdp: bool = False, config=None):
    """The local tree of the rank at ``coords`` ({"data": i, "model": j})
    of a mesh of ``sizes`` (a pure function: ``shard_params`` calls it with
    this rank's coordinates). ``config`` (the model's) adds the checks
    that a split keeps whole heads and whole quant blocks."""

    def walk(tree, names):
        if isinstance(tree, dict):
            if "weight" in tree:
                return _local_node(tree, names, coords, sizes, fsdp, config)
            return {k: walk(v, names + [str(k)]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, names + [f"#{i}"]) for i, v in enumerate(tree)]
        if isinstance(tree, torch.Tensor):
            return local_part(tree, leaf_spec(names, tree, fsdp), coords, sizes,
                              ":".join(names))
        return tree

    return walk(params, [])


def shard_params(params, mesh, fsdp: bool = False, config=None):
    """This rank's local tree of ``params`` on ``mesh`` (``local_params`` at
    ``mesh.coords``)."""
    return local_params(params, mesh.coords, mesh.shape, fsdp, config)
