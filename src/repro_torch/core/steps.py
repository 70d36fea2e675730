"""Step factories: the train step (loss, backward, AdamW), prefill and
decode, as the train loop and the serving paths call them, and the sharding
the JAX package attaches to them on a device mesh.

The train step differentiates with respect to a `cfg.dtype` copy of the
fp32 master weights (the JAX package's bf16 gradient tree), hands fp32
gradients to AdamW, and accumulates fp32 gradients over microbatches.

On a mesh, the JAX package lowers each step with shardings and lets GSPMD
insert the collectives. Here each rank runs the same model functions on its
own local shards: `shard_params` cuts the (head-padded) weights by the
serve rules' placements, and `sharded_prefill` / `sharded_decode` set the
ambient mesh, under which the model closes each sharded contraction with
the collectives of `distributed/ctx.py`: heads, KV heads, MLP, vocab and
the Mamba2 block's channels and heads over `model`, batch and cache rows
over `data`; MoE experts over `data` when it divides them (expert
parallel), else their d_model dim over `data` (gathered per layer), their
hidden units over `model` (`layers.moe_shard_map`). The decode kernel runs
on each rank's local heads. A model under 1B parameters that is not an SSM
(whisper-base, every reduced config) takes the small-serve layout instead:
its attention weights whole on every rank, no head padding, and each
attention cache (the self-attention ring, an encoder-decoder's cross
cache) cut along its sequence over `model` where the axis divides it; the
decode kernel then runs over each rank's cut and returns each row's
log-sum-exp, and the ranks' outputs merge exactly
(`distributed.ctx.merge_seq_shards`).

The sharded train step (`make_sharded_train_step`, every family) runs
under the train rules (`train_state_shardings`): each rank's fp32 master
and moments are its cut of every leaf (`shard_train_state`), the d_model
dim over the data axes (FSDP) and KV heads, or head_dim where the KV heads
do not divide the axis, MLP and expert hidden units, the Mamba2 block's
channels and heads and the vocab over `model`; an MoE's experts over
`data` when it divides them (expert parallel), else their d_model dim over
the data axes. Each layer (and each of whisper's encoder blocks) gathers
its FSDP-cut weights inside the layer (`models/lm._fsdp_layer`; the routed
experts' per product, `layers._gather_d`), whose backward reduce-scatters
their gradients; attention runs on rows cut over every mesh axis when the
(micro)batch can fill the mesh (`_train_cfg`'s `attn_dp_axes`), the MoE
routes the tokens of each data rank in its own groups (`moe_shard_map`),
and the loss is the global batch's mean.

The dry run's lowering (`lower_train_step`, `lower_prefill`,
`lower_decode`, `lower_cell`, the JAX package's `lower_*`) builds the step
one rank runs from these sharded steps, with the rank's local shards as
meta tensors for arguments; `Lowered.analyze()` runs it once under the op
counter (`analysis/op_trace.py`)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Shard

from repro_torch.analysis import op_trace
from repro_torch.configs.base import ModelConfig, ShapeConfig, serve_config
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.models import api, lm
from repro_torch.models.params import (_set, cache_axes, cache_specs, init_params,
                                       iter_params, leaves, param_axes, param_specs,
                                       ring_len, tree_map, unflatten)
from repro_torch.models.serve_pad import padded_leaves
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state

Tree = Dict[str, Any]

# Gradient-accumulation factors for the archs whose activations at the
# production global batch exceed device memory (the JAX package's table).
TRAIN_MICROBATCHES = {
    "mixtral-8x22b": 2,
    "jamba-v0.1-52b": 16,
    "moonshot-v1-16b-a3b": 4,
    "yi-34b": 1,
}


def _moe_fields(cfg: ModelConfig, mesh, group_axes) -> dict:
    """The MoE distribution fields the JAX package's step configs set:
    their names and values. The JAX package's GSPMD placements read them;
    this package's MoE layer reads the ambient mesh instead (expert
    parallel when E divides the `data` axis, groups over the data axes, as
    `moe_shard_map` decides in both packages), so they stay a dict."""
    sizes = shd.axis_sizes(mesh)
    if not cfg.n_experts or math.prod(sizes.values()) == 1:
        return {}
    ep = "data" if cfg.n_experts % sizes["data"] == 0 else ""
    return {"moe_shard_constraints": True, "moe_ep_axis": ep,
            "moe_group_axes": tuple(group_axes)}


def _train_fields(cfg: ModelConfig, mesh, batch: int) -> dict:
    """The distribution fields the JAX package's `_train_cfg` sets on the
    train config: the attention batch-DP axes when the (micro)batch can
    occupy the whole mesh; the MoE fields, groups on the data axes. Rules
    as a dict: `_train_cfg` sets the batch-DP axes on the config."""
    sizes = shd.axis_sizes(mesh)
    n = math.prod(sizes.values())
    fields = {}
    if n > 1 and batch >= n // 2:
        fields["attn_dp_axes"] = tuple(sizes)
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    fields.update(_moe_fields(cfg, mesh, dp))
    return fields


def _train_cfg(cfg: ModelConfig, mesh, batch: int) -> ModelConfig:
    """The train config on `mesh` for a (micro)batch of `batch` rows (the
    JAX package's `_train_cfg`): `attn_dp_axes` set, every mesh axis, when
    the batch can occupy the whole mesh (`_train_fields`). The MoE fields
    (expert parallel over `data` when it divides the experts, token groups
    on the data axes) stay `_train_fields`' dict: the MoE layer reads them
    off the mesh (`layers.moe`), where `moe_shard_map` groups each data
    rank's own tokens, as the JAX package's groups on the data axes do."""
    axes = _train_fields(cfg, mesh, batch).get("attn_dp_axes", ())
    return dataclasses.replace(cfg, attn_dp_axes=axes) if axes else cfg


def _serve_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """The head-padded serve config for the mesh's `model` axis (small
    models keep their heads: they shard the cache along its sequence). The
    JAX package's `_serve_cfg` also sets the MoE fields, which are
    `_moe_fields` here (a dict: the MoE layer reads the mesh)."""
    if not shd._small_serve(cfg):
        cfg = serve_config(cfg, int(shd.axis_sizes(mesh).get("model", 1)))
    return cfg


def train_state_specs(cfg: ModelConfig) -> Tree:
    """The train state's shapes and types as meta tensors: the weights in
    cfg.param_dtype, fp32 moments, an int32 step."""
    p = param_specs(cfg)
    f32 = lambda t: tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                                   device="meta"), t)
    return {"params": p, "opt": {"mu": f32(p), "nu": f32(p),
                                 "step": torch.empty((), dtype=torch.int32, device="meta")}}


def train_state_shardings(cfg: ModelConfig, mesh) -> Tree:
    rules = shd.train_rules(mesh, cfg)
    pshard = shd.tree_shardings(param_specs(cfg), param_axes(cfg), rules, mesh)
    return {"params": pshard,
            "opt": {"mu": pshard, "nu": pshard, "step": shd.scalar_sharding(mesh)}}


def init_train_state(cfg: ModelConfig, generator: torch.Generator, device) -> Tree:
    """Seeded master weights in cfg.param_dtype (fp32) on `device` (the
    generator must live there too) and a zero AdamW state."""
    params = init_params(cfg, generator, device, cfg.param_dtype)
    return {"params": params, "opt": init_opt_state(params)}


def _device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _grads(cfg: ModelConfig, params: Tree, batch: Dict[str, torch.Tensor],
           microbatches: int, device) -> Tuple[Tree, Dict]:
    """The gradient of `lm.train_loss` with respect to a detached
    `cfg.dtype` copy of the fp32 leaves of `params` (the JAX package's bf16
    gradient tree), in fp32: over `microbatches` equal chunks of the rows,
    the mean of their fp32 gradients. Returns (gradient tree, the last
    chunk's detached metrics)."""
    dt = getattr(torch, cfg.dtype)
    # the tree differentiated: detached cfg.dtype copies of the fp32 leaves
    low = tree_map(lambda p: (p.detach().to(dt) if p.dtype == torch.float32
                              else p.detach()).requires_grad_(p.is_floating_point()),
                   params)
    trainable = [v for _, v in leaves(low)]

    def grads_of(b) -> Tuple[Tuple[torch.Tensor, ...], Dict]:
        loss, metrics = lm.train_loss(low, b, cfg)
        grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        grads = tuple(torch.zeros_like(p) if g is None else g
                      for p, g in zip(trainable, grads))
        return grads, {k: v.detach() for k, v in metrics.items()}

    if microbatches == 1:
        g, metrics = grads_of(batch)
        flat = [x.float() for x in g]
    else:
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch {n} is not a multiple of {microbatches} microbatches")
        m = n // microbatches
        flat = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in trainable]
        for i in range(microbatches):
            g, metrics = grads_of({k: v[i * m:(i + 1) * m] for k, v in batch.items()})
            for acc, x in zip(flat, g):
                acc.add_(x.float())
        flat = [x / microbatches for x in flat]
    return unflatten(low, flat), metrics


def make_train_step(cfg: ModelConfig, oc: Optional[OptConfig] = None,
                    microbatches: int = 1):
    """train_step(state, batch) -> (state, metrics). `batch` holds numpy
    arrays or tensors ({"tokens", "labels"} and a family's stub inputs),
    moved to the weights' device; the state's weights and moments are
    updated in place. metrics: "loss", "nll", "aux" of the last microbatch
    and AdamW's "grad_norm" and "lr", 0-d tensors."""
    oc = oc or OptConfig()

    def train_step(state: Tree, batch: Dict[str, Any]):
        params = state["params"]
        device = next(v for _, v in leaves(params)).device
        grads, metrics = _grads(cfg, params, _device_batch(batch, device), microbatches, device)
        new_params, new_opt, opt_metrics = adamw_update(params, grads, state["opt"], oc)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    return train_step


def make_prefill(cfg: ModelConfig):
    """prefill_fn(params, {"tokens", and "img_embeds" or "audio_frames",
    and "cache_len", the KV slots to allocate, the prompt length if not
    given}) -> (last-position logits [B, 1, V], cache)."""
    @torch.no_grad()
    def prefill_fn(params: Tree, inputs: Dict[str, Any]):
        return lm.prefill(params, inputs["tokens"], cfg, img_embeds=inputs.get("img_embeds"),
                          audio_frames=inputs.get("audio_frames"),
                          cache_len=inputs.get("cache_len"))

    return prefill_fn


def make_decode(cfg: ModelConfig, ring: Optional[int] = None):
    """decode_fn(params, {"cache", "tokens" [B, 1], "pos"}) -> (logits
    [B, 1, V], cache), the cache updated in place. ring: the global slots
    of the self-attention rings (`lm.decode`'s)."""
    @torch.no_grad()
    def decode_fn(params: Tree, inputs: Dict[str, Any]):
        return lm.decode(params, inputs["cache"], inputs["tokens"], int(inputs["pos"]), cfg,
                         ring=ring)

    return decode_fn


# ---------------------------------------------------------------------------
# Serve on a mesh: tensor parallel over `model`, rows over `data`
# ---------------------------------------------------------------------------

# the logical axes a leaf must have cut over a `model` axis wider than 1
# where the serve rules map them to it: the dims whose contractions the
# model's collectives close (the small-serve layout maps `kv_heads` to
# none: its attention weights are whole)
_MODEL_CUT = ("kv_heads", "mlp", "vocab", "expert_mlp", "ssm_inner", "ssm_conv", "ssm_heads")


def serve_param_shardings(cfg: ModelConfig, mesh) -> Tree:
    """The serve placements of every weight of `cfg` (a serve config)."""
    rules = shd.serve_rules(mesh, cfg)
    return shd.tree_shardings(param_specs(cfg, dtype=cfg.dtype), param_axes(cfg), rules,
                              mesh)


def serve_cache_shardings(cfg: ModelConfig, mesh, batch: int, cache_len: int) -> Tree:
    """The serve placements of a cache of `cfg`: rows over the data axes,
    KV heads over `model` (under the small-serve layout, the attention
    caches' sequence instead, where the axis divides it), an SSM layer's
    conv channels and heads over `model`."""
    rules = shd.serve_rules(mesh, cfg)
    return shd.tree_shardings(cache_specs(cfg, batch, cache_len),
                              cache_axes(cfg, batch, cache_len), rules, mesh)


def tp_serve_cfg(cfg: ModelConfig, mesh) -> ModelConfig:
    """`_serve_cfg` for the sharded serve steps, which take every family:
    the head layout at 1B parameters or more (an SSM model at any size),
    the small-serve layout below. Raises for a layout the model's
    collectives cannot close: with a `model` axis wider than 1, every
    KV-head (but under the small-serve layout), MLP, vocab, expert
    hidden-unit and SSM channel and head dim must be cut over it (and an
    MoE's d_model over it too, where the experts reduce-scatter along d);
    with a `data` axis wider than 1, an MoE's experts (or, when the axis
    does not divide them, their d_model dim) must be cut over `data`."""
    scfg = _serve_cfg(cfg, mesh)
    sizes = shd.axis_sizes(mesh)
    names = list(sizes)
    rules = shd.serve_rules(mesh, scfg)
    need = {}
    if sizes.get("model", 1) > 1:
        need["model"] = tuple(ax for ax in _MODEL_CUT if rules[ax] == "model")
        if scfg.n_experts and scfg.d_model % sizes["model"]:
            raise ValueError(f"{cfg.name} on {sizes}: d_model {scfg.d_model} does not cut "
                             f"over the model axis for the experts' reduce-scatter")
    if scfg.n_experts and sizes.get("data", 1) > 1:
        ep = scfg.n_experts % sizes["data"] == 0
        need["data"] = ("expert",) if ep else ("expert_embed",)
    if need:
        all_axes = dict(leaves(param_axes(scfg)))
        for path, spec in leaves(param_specs(scfg, dtype=scfg.dtype)):
            axes = all_axes[path]
            pl = shd.spec_for(spec.shape, axes, rules, mesh)
            for d, ax in enumerate(axes):
                for axis, cut in need.items():
                    if ax in cut and pl[names.index(axis)] != Shard(d):
                        raise ValueError(
                            f"{cfg.name} on {sizes}: {path} dim {d} ({ax}, "
                            f"{spec.shape[d]}) is not cut over the {axis} axis")
    return scfg


def _coordinate(mesh, coordinate):
    return list(mesh.get_coordinate()) if coordinate is None else list(coordinate)


def shard_params(params, cfg: ModelConfig, mesh, coordinate=None) -> Tree:
    """This rank's local shards of the weights of `cfg`, leaf by leaf: each
    leaf head-padded for the mesh's `model` axis (`serve_pad.padded_leaves`)
    and cut by its serve placements, on the leaf's device. `params` is a
    full tree, or an iterable of (path, leaf) in sorted path order, such as
    `params.iter_params` drawing on the card: each leaf is padded and cut as
    it comes, so besides the shards kept only the current full leaf (and
    its padded copy) is ever alive. A cut leaf is a copy of its own; a
    replicated one is the same tensor. coordinate: the rank's index a mesh
    dim (default: this process's)."""
    scfg = tp_serve_cfg(cfg, mesh)
    # the small-serve layout keeps the heads as they are (no padding)
    tp = 1 if shd._small_serve(cfg) else int(shd.axis_sizes(mesh).get("model", 1))
    coord = _coordinate(mesh, coordinate)
    placements = dict(leaves(serve_param_shardings(scfg, mesh)))
    items = leaves(params) if isinstance(params, dict) else params
    out: Tree = {}
    for path, t in padded_leaves(items, cfg, tp):
        pl = placements.pop(path)
        if any(isinstance(p, Shard) for p in pl):
            t = shd.local_shard(t, pl, mesh, coord).clone(memory_format=torch.contiguous_format)
        _set(out, path, t)
    if placements:
        raise ValueError(f"{cfg.name}: weights missing from the tree: {sorted(placements)}")
    return out


def shard_batch(x: torch.Tensor, mesh, coordinate=None) -> torch.Tensor:
    """This rank's rows of a batch-major input (tokens, img_embeds): cut
    over the data axes, the same on every `model` rank; all of them when
    the data axes do not divide the batch."""
    pl = shd.spec_for(x.shape, ("batch",) + (None,) * (x.dim() - 1), shd.serve_rules(mesh),
                      mesh)
    return shd.local_shard(x, pl, mesh, _coordinate(mesh, coordinate)).contiguous()


def _rows_cut(mesh, batch: Optional[int], local: int) -> bool:
    """Whether a rank's `local` rows are its cut of the global batch over
    the data axes (`shard_batch` cuts only a batch they divide): by the
    global `batch` where given, else taken as cut."""
    n_dp = math.prod(v for k, v in shd.axis_sizes(mesh).items() if k in ("pod", "data"))
    if batch is None:
        return True
    cut = batch % n_dp == 0
    if local != (batch // n_dp if cut else batch):
        raise ValueError(f"{local} rows on this rank are not shard_batch's rows of a "
                         f"batch of {batch} over {n_dp} data ranks")
    return cut


def _seq_cut(scfg: ModelConfig, mesh) -> bool:
    """Whether the serve rules cut the attention caches along their
    sequence (the small-serve layout)."""
    return shd.serve_rules(mesh, scfg)["seq"] == "model"


def sharded_prefill(cfg: ModelConfig, mesh, batch: Optional[int] = None):
    """The tensor-parallel prefill (the JAX package's `lower_prefill`):
    prefill_fn(local params, inputs as `make_prefill` takes them, the
    batch-major ones (tokens, img_embeds, audio_frames) cut by
    `shard_batch`) -> (logits [B_local, 1, V], this rank's cache: its rows,
    KV heads or cut of each attention cache's sequence, and SSM channels
    and heads). Runs `make_prefill` of `tp_serve_cfg(cfg, mesh)` under the
    mesh. batch: the global batch's rows; the MoE layer, which routes
    tokens in groups across rows, needs it when the data axes may not
    divide it (`shard_batch` then gives every data rank every row). Without
    it the rows are taken as cut."""
    scfg = tp_serve_cfg(cfg, mesh)
    fn, seq = make_prefill(scfg), _seq_cut(scfg, mesh)

    def prefill_fn(params: Tree, inputs: Dict[str, Any]):
        cut = _rows_cut(mesh, batch, inputs["tokens"].shape[0])
        with dctx.mesh_context(mesh, rows_cut=cut, seq_cut=seq):
            return fn(params, inputs)

    return prefill_fn


def sharded_decode(cfg: ModelConfig, mesh, batch: Optional[int] = None,
                   cache_len: Optional[int] = None):
    """The tensor-parallel decode step (the JAX package's `lower_decode`):
    decode_fn(local params, {"cache": this rank's cache, "tokens" [B_local,
    1], "pos"}) -> (logits [B_local, 1, V], cache updated in place). The
    decode-attention kernel runs on the rank's local heads, or, under the
    small-serve layout, over the rank's cut of each cache's sequence, and
    the ranks' outputs merge. batch: as `sharded_prefill`'s. cache_len: the
    KV slots the prefill allocated (the JAX package's `shape.seq_len`),
    which the small-serve layout needs: a rank's ring alone does not say
    whether the whole ring was cut."""
    scfg = tp_serve_cfg(cfg, mesh)
    ring = None if cache_len is None else ring_len(scfg, cache_len)
    fn, seq = make_decode(scfg, ring), _seq_cut(scfg, mesh)

    def decode_fn(params: Tree, inputs: Dict[str, Any]):
        cut = _rows_cut(mesh, batch, inputs["tokens"].shape[0])
        with dctx.mesh_context(mesh, rows_cut=cut, seq_cut=seq):
            return fn(params, inputs)

    return decode_fn


# ---------------------------------------------------------------------------
# Train on a mesh: FSDP over the data axes, TP over `model` (the train rules)
# ---------------------------------------------------------------------------

# the logical axes a leaf must have cut over a `model` axis wider than 1
# where the train rules map them to it: the dims whose contractions the
# model's collectives close (one of kv_heads and head_dim, as the rules
# say; the experts' hidden units; the Mamba2 block's channels and heads)
_TRAIN_MODEL_CUT = ("kv_heads", "head_dim", "mlp", "vocab", "expert_mlp", "ssm_inner",
                    "ssm_conv", "ssm_heads")


def train_cut_axes(cfg: ModelConfig, mesh) -> Tree:
    """Every weight's mesh axes that cut it under the train rules, in mesh
    order (() for a replicated leaf): the axes over which its sum of
    squares is summed for the global norm."""
    names = list(shd.axis_sizes(mesh))
    return tree_map(lambda pl: tuple(n for n, p in zip(names, pl) if isinstance(p, Shard)),
                    train_state_shardings(cfg, mesh)["params"])


def _check_train_layout(cfg: ModelConfig, mesh) -> None:
    """With a `model` axis wider than 1, refuse a leaf whose KV-head or
    head_dim, MLP, vocab, expert hidden-unit or SSM channel or head dim the
    train rules map to `model` but the axis does not cut (the model's
    collectives could not close its contraction), naming the leaf, and an
    MoE whose d_model the axis does not cut (the experts reduce-scatter
    along d)."""
    sizes = shd.axis_sizes(mesh)
    if sizes.get("model", 1) == 1:
        return
    if cfg.n_experts and cfg.d_model % sizes["model"]:
        raise ValueError(f"{cfg.name} on {sizes}: d_model {cfg.d_model} does not cut over "
                         f"the model axis for the experts' reduce-scatter")
    names = list(sizes)
    rules = shd.train_rules(mesh, cfg)
    cut = tuple(ax for ax in _TRAIN_MODEL_CUT if rules[ax] == "model")
    all_axes = dict(leaves(param_axes(cfg)))
    for path, pl in leaves(train_state_shardings(cfg, mesh)["params"]):
        for d, ax in enumerate(all_axes[path]):
            if ax in cut and pl[names.index("model")] != Shard(d):
                raise ValueError(f"{cfg.name} on {sizes}: {path} dim {d} ({ax}) is not cut "
                                 f"over the model axis")


def shard_train_state(state: Tree, cfg: ModelConfig, mesh, coordinate=None) -> Tree:
    """This rank's cut of a whole fp32 train state ({"params", "opt": {"mu",
    "nu", "step"}}, as `init_train_state` builds it or as carried across
    from the JAX package's tree) under `train_state_shardings`: each leaf a
    contiguous copy of its own (no head padding: the train rules cut
    head_dim where the KV heads do not divide the `model` axis).
    coordinate: the rank's index a mesh dim (default: this process's)."""
    coord = _coordinate(mesh, coordinate)
    sh = train_state_shardings(cfg, mesh)

    def cut(t, pl):
        return shd.local_shard(t, pl, mesh, coord).clone(memory_format=torch.contiguous_format)

    return {"params": tree_map(cut, state["params"], sh["params"]),
            "opt": {"mu": tree_map(cut, state["opt"]["mu"], sh["opt"]["mu"]),
                    "nu": tree_map(cut, state["opt"]["nu"], sh["opt"]["nu"]),
                    "step": state["opt"]["step"].clone()}}


def init_sharded_train_state(cfg: ModelConfig, generator: torch.Generator, device,
                             mesh) -> Tree:
    """`shard_train_state` of `init_train_state` with the same generator,
    the same bits, without the whole tree: each leaf is drawn
    (`params.iter_params`), cut and dropped in turn, and the moments are
    zeros of the cut shapes."""
    coord = _coordinate(mesh, None)
    placements = dict(leaves(train_state_shardings(cfg, mesh)["params"]))
    params: Tree = {}
    for path, t in iter_params(cfg, generator, device, cfg.param_dtype):
        _set(params, path, shd.local_shard(t, placements[path], mesh, coord).clone(
            memory_format=torch.contiguous_format))
    return {"params": params, "opt": init_opt_state(params)}


def unshard_leaf(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's cut under `placements`:
    gathered over the mesh axes that cut each dim, major to minor (a
    collective every rank of the mesh runs)."""
    names = list(shd.axis_sizes(mesh))
    with torch.no_grad(), dctx.mesh_context(mesh):
        for d in range(t.dim()):
            axes = [n for n, p in zip(names, placements) if p == Shard(d)]
            if axes:
                t = dctx.gather(t, d, axes)
    return t


def unshard_train_state(state: Tree, cfg: ModelConfig, mesh) -> Tree:
    """The whole train state from this rank's cut of it (`unshard_leaf`
    leaf by leaf; every rank of the mesh calls it)."""
    sh = train_state_shardings(cfg, mesh)
    return tree_map(lambda t, pl: unshard_leaf(t, pl, mesh), state, sh)


def shard_train_batch(batch: Dict[str, Any], mesh, microbatches: int = 1,
                      coordinate=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch ({"tokens", "labels"} and a
    family's stub inputs, batch-major), microbatch by microbatch: the rows
    of microbatch i are the global rows [i B / k, (i + 1) B / k), as the
    JAX package's scan cuts them, and the rank holds its cut of each over
    the data axes (`shard_batch`), in microbatch order. The data axes must
    divide each microbatch."""
    n_dp = math.prod(v for k, v in shd.axis_sizes(mesh).items() if k in ("pod", "data"))
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        b = t.shape[0]
        if b % microbatches or (b // microbatches) % n_dp:
            raise ValueError(f"{k}: a batch of {b} rows in {microbatches} microbatches does "
                             f"not cut over {n_dp} data ranks")
        m = b // microbatches
        out[k] = torch.cat([shard_batch(t[i * m:(i + 1) * m], mesh, coordinate)
                            for i in range(microbatches)])
    return out


def make_sharded_train_step(cfg: ModelConfig, mesh, oc: Optional[OptConfig] = None,
                            microbatches: Optional[int] = None):
    """The train step on a mesh (the JAX package's `lower_train_step` of
    `make_train_step`), for every family: returns
    sharded_train_step(local state, batch) -> (local state, metrics).

    The state is this rank's cut (`shard_train_state`), updated in place;
    the batch this rank's rows (`shard_train_batch`). Like the one-device
    step, it differentiates a `cfg.dtype` copy of the rank's master leaves,
    sums the microbatches' fp32 gradients and hands AdamW fp32 gradients of
    the rank's shards, which it updates in place. Under the mesh each layer
    gathers its weights' d_model cut over the data axes and the gather's
    backward reduce-scatters their gradients; a leaf replicated over the
    data axes has its gradient all-reduced over them after the backward;
    the loss is the global batch's mean and `grad_norm` the whole
    gradient's. An expert leaf cut over `data` (expert parallel) holds the
    whole gradient of its experts; on a mesh with `pod` it is summed over
    `pod`, the data axis that does not cut it. microbatches: the JAX
    package's rule by default (`TRAIN_MICROBATCHES` on a mesh of more than
    one rank, else 1); the train config is `_train_cfg(cfg, mesh, global
    batch // microbatches)`. Raises ValueError for a layout the model's
    collectives cannot close."""
    _check_train_layout(cfg, mesh)
    sizes = shd.axis_sizes(mesh)
    if microbatches is None:
        microbatches = TRAIN_MICROBATCHES.get(cfg.name, 1) if math.prod(sizes.values()) > 1 \
            else 1
    oc = oc or OptConfig()
    n_dp = math.prod(v for k, v in sizes.items() if k in dctx.DP)
    cut = train_cut_axes(cfg, mesh)
    # the data axes over which each leaf's gradient is still a partial sum
    summed = [tuple(a for a in dctx.DP if a not in names) for _, names in leaves(cut)]

    def sharded_train_step(state: Tree, batch: Dict[str, Any]):
        params = state["params"]
        device = next(v for _, v in leaves(params)).device
        batch = _device_batch(batch, device)
        rows = next(iter(batch.values())).shape[0]
        tcfg = _train_cfg(cfg, mesh, rows * n_dp // microbatches)
        with dctx.mesh_context(mesh):
            grads, metrics = _grads(tcfg, params, batch, microbatches, device)
            flat = [dctx.all_reduce(g, axes) if axes else g
                    for (_, g), axes in zip(leaves(grads), summed)]
            grads = unflatten(grads, flat)
            new_params, new_opt, opt_metrics = adamw_update(params, grads, state["opt"], oc,
                                                            cut)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    return sharded_train_step


# ---------------------------------------------------------------------------
# The dry run: one rank's step of an (arch x shape x mesh) cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Lowered:
    """The step one rank runs in a cell: fn(*args), args its local shards,
    each a tensor of its own (meta tensors but the decode position, a 0-d
    int32 on the host, whose value the port's decode reads); params, the
    weights among them."""
    fn: Callable
    args: Tuple[Any, ...]
    params: Any

    def analyze(self, sites: bool = False) -> op_trace.StepCost:
        return op_trace.analyze_step(self.fn, *self.args, sites=sites, params=self.params)


def _local(tree: Tree, placements: Tree, mesh, coord) -> Tree:
    return tree_map(lambda t, pl: shd.local_shard(t, pl, mesh, coord).clone(
        memory_format=torch.contiguous_format), tree, placements)


def lower_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh, oc: Optional[OptConfig] = None,
                     microbatches: Optional[int] = None, coordinate=None) -> Lowered:
    """`make_sharded_train_step` on this rank's cut of the fp32 train state
    (`train_state_specs` through `shard_train_state`) and its rows of the
    global batch (`api.train_batch_specs` through `shard_train_batch`), in
    `TRAIN_MICROBATCHES` microbatches on a mesh of more than one rank.
    Raises ValueError for a layout the port refuses, naming the leaf."""
    if microbatches is None:
        n = math.prod(shd.axis_sizes(mesh).values())
        microbatches = TRAIN_MICROBATCHES.get(cfg.name, 1) if n > 1 else 1
    fn = make_sharded_train_step(cfg, mesh, oc, microbatches)
    coord = _coordinate(mesh, coordinate)
    state = shard_train_state(train_state_specs(cfg), cfg, mesh, coord)
    batch = shard_train_batch(api.train_batch_specs(cfg, shape), mesh, microbatches, coord)
    return Lowered(fn, (state, batch), state["params"])


def _serve_params(cfg: ModelConfig, mesh, coord) -> Tree:
    return shard_params(param_specs(cfg, dtype=cfg.dtype), cfg, mesh, coord)


def lower_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, coordinate=None) -> Lowered:
    """`sharded_prefill` of the global batch on this rank's weights
    (`shard_params` of `param_specs` in cfg.dtype) and rows
    (`api.prefill_input_specs` through `shard_batch`); the cache holds the
    prompt. Raises ValueError for a layout the port refuses."""
    fn = sharded_prefill(cfg, mesh, batch=shape.global_batch)
    coord = _coordinate(mesh, coordinate)
    params = _serve_params(cfg, mesh, coord)
    inputs = {k: shard_batch(v, mesh, coord).clone()
              for k, v in api.prefill_input_specs(cfg, shape).items()}
    return Lowered(fn, (params, inputs), params)


def lower_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, coordinate=None) -> Lowered:
    """`sharded_decode` of one token a row against a cache of
    `shape.seq_len` slots (this rank's cut of `api.decode_input_specs`'
    cache of the serve config, by `serve_cache_shardings`), at the last
    position. Raises ValueError for a layout the port refuses."""
    scfg = tp_serve_cfg(cfg, mesh)
    b, s = shape.global_batch, shape.seq_len
    fn = sharded_decode(cfg, mesh, batch=b, cache_len=s)
    coord = _coordinate(mesh, coordinate)
    params = _serve_params(cfg, mesh, coord)
    specs = api.decode_input_specs(scfg, shape)
    inputs = {"cache": _local(specs["cache"], serve_cache_shardings(scfg, mesh, b, s), mesh,
                              coord),
              "tokens": shard_batch(specs["tokens"], mesh, coord).clone(),
              "pos": torch.tensor(s - 1, dtype=torch.int32)}
    return Lowered(fn, (params, inputs), params)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, oc: Optional[OptConfig] = None,
               coordinate=None) -> Lowered:
    """The step an (arch x shape) cell runs, lowered for this rank."""
    if shape.kind == "train":
        return lower_train_step(cfg, shape, mesh, oc, coordinate=coordinate)
    if shape.kind == "prefill":
        return lower_prefill(cfg, shape, mesh, coordinate)
    return lower_decode(cfg, shape, mesh, coordinate)
