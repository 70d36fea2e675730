"""AdamW with global-norm clipping and a warmup-cosine schedule, written
out over parameter trees (nested dicts of tensors, leaves in sorted path
order) in the JAX package's order of operations: clip by the global norm,
update the fp32 moments, bias-correct, then mh / (sqrt(vh) + eps) + wd * p.

On a mesh (the sharded train step) the trees hold each rank's shards: the
update is elementwise, so each rank updates its own shards in place, and
the clip uses the norm of the whole gradient, each leaf's sum of squares
summed over the mesh axes that cut that leaf (`global_norm`'s `cut`)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import ctx as dctx
from repro_torch.models.params import leaves, tree_map

Tree = Dict[str, Any]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an integer tensor), fp32: linear warm-up
    to oc.lr over warmup_steps, then a cosine from oc.lr down to 0.1 oc.lr
    at total_steps, flat after."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / _f32(max(1.0, oc.warmup_steps), step)
    t = (step - oc.warmup_steps) / _f32(max(1.0, oc.total_steps - oc.warmup_steps), step)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, step) * torch.clamp(t, 0.0, 1.0)))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, 0.1 + 0.9 * cos)


def init_opt_state(params: Tree) -> Tree:
    """fp32 zero moments shaped like `params`, and the step count (int32)."""
    zeros = lambda t: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), t)
    dev = next(v for _, v in leaves(params)).device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree, cut: Optional[Tree] = None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted path order) of sum(x^2) in fp32.
    cut: on a mesh, a tree of the mesh axes that cut each leaf (the tree
    holds this rank's shards): the leaves' sums of squares are grouped by
    those axes, each group all-reduced over its axes only (a replicated
    leaf counts once), and the groups summed in the order of their axes."""
    if cut is None:
        sq = sum(torch.sum(torch.square(x.float())) for _, x in leaves(tree))
        return torch.sqrt(sq)
    names = dict(leaves(cut))
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for path, x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        key = tuple(names[path])
        groups[key] = groups[key] + s if key in groups else s
    sq = sum(dctx.all_reduce(groups[key], key) for key in sorted(groups))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, opt_state: Tree, oc: OptConfig,
                 cut: Optional[Tree] = None) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One AdamW step. The parameter leaves and the moments are updated in
    place and returned as (params, {"mu", "nu", "step"}, {"grad_norm",
    "lr"}); each value is the JAX package's for the same inputs. cut: on a
    mesh, the mesh axes that cut each leaf (`global_norm`'s); the trees then
    hold this rank's shards, and grad_norm is the whole gradient's."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, cut)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(oc, step)
    stepf = step.to(torch.float32)
    b1c = 1 - _f32(oc.b1, stepf) ** stepf
    b2c = 1 - _f32(oc.b2, stepf) ** stepf
    mu, nu = dict(leaves(opt_state["mu"])), dict(leaves(opt_state["nu"]))
    g_of = dict(leaves(grads))
    for path, p in leaves(params):
        m, v = mu[path], nu[path]
        g = g_of[path].float() * scale
        m.mul_(oc.b1).add_((1 - oc.b1) * g)
        v.mul_(oc.b2).add_((1 - oc.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    new_opt = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return params, new_opt, {"grad_norm": gnorm, "lr": lr}
