"""Logical-axis -> mesh-axis sharding rules, and the placements they give.

Two rule sets, the JAX package's:
  * train: 2-D sharded weights (FSDP over 'data' [+ 'pod'], TP over
           'model'); activations batch-sharded over ('pod', 'data').
  * serve: weights TP over 'model', replicated over 'data'; the MoE expert
           dim sharded over 'data'; batch and KV cache over 'data', KV
           heads over 'model' (the head-padded serve configs make them
           divisible).

A leaf's sharding is one DTensor placement a mesh dim, in the mesh's order:
`Shard(d)` where tensor dim d is cut over that mesh axis, `Replicate()`
elsewhere. A tensor dim over several axes (('pod', 'data')) is `Shard(d)`
on each, and DTensor cuts it major to minor in mesh order, as the JAX
package's PartitionSpec does: the chunk of coordinates (p, q) is
p * |data| + q. A dim that its axes do not divide is replicated.

Every function takes a mesh as either a `DeviceMesh` or a mapping of axis
name to size in mesh order (`{"data": 16, "model": 16}`), so the rules of
a 16 x 16 or 2 x 16 x 16 mesh can be checked without ranks.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.params import tree_map

Placements = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order, of a DeviceMesh or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def train_rules(mesh, cfg=None) -> Dict[str, Any]:
    sizes = axis_sizes(mesh)
    fsdp = ("pod", "data") if "pod" in sizes else ("data",)
    rules = {
        "batch": fsdp,
        "seq": None,
        "embed": fsdp,             # FSDP: a weight's d_model dim over data(+pod)
        "vocab": "model",
        "heads": "model",
        # clean head-TP when kv_heads divides the model axis; otherwise the
        # attention weights are 2-D sharded through head_dim
        "kv_heads": None,
        "head_dim": "model",
        "mlp": "model",
        "expert": None,
        "expert_embed": fsdp,
        "expert_mlp": "model",
        "ssm_inner": "model",
        "ssm_conv": "model",
        "ssm_heads": "model",
        "layers": None,
    }
    # expert parallelism when E divides the data axis
    if cfg is not None and cfg.n_experts and cfg.n_experts % sizes["data"] == 0:
        rules["expert"] = "data"
        rules["expert_embed"] = None
    if cfg is not None and cfg.n_kv_heads % sizes["model"] == 0:
        rules["kv_heads"] = "model"
        rules["head_dim"] = None
    return rules


def serve_rules(mesh, cfg=None) -> Dict[str, Any]:
    sizes = axis_sizes(mesh)
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    rules = {
        "batch": dp,
        "seq": None,
        "embed": None,             # dense weights replicated over data, TP over model
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",       # head-padded serve configs make this divisible
        "head_dim": None,
        "mlp": "model",
        "expert": None,
        "expert_embed": None,
        "expert_mlp": "model",
        "ssm_inner": "model",
        "ssm_conv": "model",
        "ssm_heads": "model",
        "layers": None,
    }
    # expert weights 2-D sharded to fit device memory: expert parallelism
    # over 'data' when E divides it, else d over data and f over model
    if cfg is not None and cfg.n_experts:
        if cfg.n_experts % sizes["data"] == 0:
            rules["expert"] = "data"
        else:
            rules["expert_embed"] = "data"
    # small-model serving: replicate the attention weights over 'model' and
    # shard the KV cache along its sequence instead (no head padding)
    if cfg is not None and _small_serve(cfg):
        rules["kv_heads"] = None
        rules["seq"] = "model"
    return rules


def _small_serve(cfg) -> bool:
    return cfg.param_count() < 1_000_000_000 and cfg.family != "ssm"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in _entry_axes(entry):
        out *= sizes[a]
    return out


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], rules: Dict[str, Any],
             mesh) -> Placements:
    """One placement a mesh dim, in mesh order: Shard(d) on every axis the
    rules cut tensor dim d over, Replicate() on the others. A dim its axes
    do not divide stays whole."""
    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, (dim, ax) in enumerate(zip(shape, axes)):
        entry = rules.get(ax) if ax is not None else None
        if entry is None or dim % _axis_size(mesh, entry):
            continue
        for a in _entry_axes(entry):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} cuts two dims of {tuple(shape)} "
                                 f"(axes {tuple(axes)})")
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(spec_tree, axes_tree, rules, mesh):
    """spec_tree: a tree of tensors (meta or real); axes_tree: the matching
    tree of logical axes. A tree of placements."""
    return tree_map(lambda s, a: spec_for(s.shape, a, rules, mesh), spec_tree, axes_tree)


def scalar_sharding(mesh) -> Placements:
    return (Replicate(),) * len(axis_sizes(mesh))


def batch_shardings(spec_tree, rules, mesh):
    """Data batches: dim 0 = batch, the rest replicated (tokens, labels,
    the front ends' stub inputs)."""
    return tree_map(lambda s: spec_for(s.shape, ("batch",) + (None,) * (len(s.shape) - 1),
                                       rules, mesh), spec_tree)


def local_shard(t, placements: Placements, mesh, coordinate: Sequence[int]):
    """The chunk of the full tensor t that the rank at `coordinate` (one
    index a mesh dim) holds under `placements`: for each tensor dim, the
    mesh dims that cut it fold major to minor into one chunk index. A view
    of t."""
    sizes = list(axis_sizes(mesh).values())
    for d in range(t.dim()):
        idx, n = 0, 1
        for i, pl in enumerate(placements):
            if pl == Shard(d):
                idx, n = idx * sizes[i] + coordinate[i], n * sizes[i]
        if n > 1:
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide into {n}")
            step = t.shape[d] // n
            t = t.narrow(d, idx * step, step)
    return t
