"""GPipe-style pipeline parallelism over a `pipe` mesh axis, the JAX
package's `distributed/pipeline.py` on torch.distributed ranks.

Each rank of the axis holds one stage's parameters (`stage_params` cuts a
stacked tree's leading dim); the microbatches are replicated and stream
through the classic (n_micro + n_stages - 1)-step schedule: at step t stage
0 ingests microbatch t, each stage applies `stage_fn` to what it holds, the
last stage emits from t >= n_stages - 1, and the activations shift to the
next stage (`ctx.shift`, the counterpart of `ppermute`: an all-reduce into
a zero-filled buffer, as every collective here is). An all-reduce of the
last stage's outputs replicates them to every rank. A rank skips
`stage_fn` in its bubble steps, where the JAX version computes on zeros
whose results are never emitted; outputs and gradients are the same.

The backward is the schedule run in reverse: at each step the gradient of
what a stage received shifts back to the stage before it (the transpose of
the shift, as JAX differentiates `ppermute`), and each stage backpropagates
it through the graph its forward kept for that step. Every rank runs the
same collectives in the same order in both directions, bubbles included.
The gradient of the replicated microbatches is summed over the axis, so
every rank holds it whole; each rank's parameter gradients are its own
stage's.

At pod scale this composes with the production mesh by reshaping `data`
into (`pipe`, `data`); bubble fraction = (S - 1) / (M + S - 1). The dry
run's counter (`analysis/op_trace.py`) and roofline apply unchanged to a
stage's step function.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.distributed import ctx as dctx


def make_pipe_mesh(n_stages: int, device="cuda") -> DeviceMesh:
    """A mesh of one `pipe` axis over the `n_stages` ranks of the world."""
    return init_device_mesh(torch.device(device).type, (n_stages,), mesh_dim_names=("pipe",))


def stage_params(stacked: Any, mesh: DeviceMesh, axis: str = "pipe") -> Any:
    """This rank's stage of a tree whose leaves stack every stage along
    their leading dim (the JAX version's in_spec P(axis)): leaf[rank], a
    contiguous copy."""
    rank = mesh.get_local_rank(axis)
    return tree_map(lambda x: x[rank].clone(), stacked)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, treedef, axis, mesh, grad, mbs, *leaves):
        _, stage, n_stages = dctx._axis(axis)
        n_micro = mbs.shape[0]
        ctx.axis, ctx.mesh, ctx.n_micro = axis, mesh, n_micro
        ctx.stage, ctx.n_stages = stage, n_stages
        locs = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        params = tree_unflatten(locs, treedef)
        state = torch.zeros_like(mbs[0])
        outs = torch.zeros_like(mbs)
        steps: List[Any] = []          # (input, output) of each active step, or None
        for t in range(n_micro + n_stages - 1):
            m = t - stage              # the microbatch at this stage now
            if 0 <= m < n_micro:
                x = (mbs[m] if stage == 0 else state).detach().requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    y = stage_fn(params, x)
                steps.append((x, y) if grad else None)
                y = y.detach()
                if stage == n_stages - 1:
                    outs[m] = y
            else:
                y = torch.zeros_like(state)
                steps.append(None)
            state = dctx.shift(y, axis, 1)
        ctx.steps, ctx.locs = steps, locs
        return dctx._sum_(outs, (axis,))

    @staticmethod
    def backward(ctx, g_outs):
        with dctx.mesh_context(ctx.mesh):
            return _Pipeline._backward(ctx, g_outs)

    @staticmethod
    def _backward(ctx, g_outs):
        stage, n_stages, n_micro, axis = ctx.stage, ctx.n_stages, ctx.n_micro, ctx.axis
        g_mbs = torch.zeros_like(g_outs)
        grads = [None] * len(ctx.locs)
        idx = [i for i, p in enumerate(ctx.locs) if p.requires_grad]
        trainable = [ctx.locs[i] for i in idx]
        g_state = None                 # the gradient of what this stage received next step
        for t in reversed(range(n_micro + n_stages - 1)):
            g_y = dctx.shift(torch.zeros_like(g_outs[0]) if g_state is None else g_state,
                              axis, -1)
            m = t - stage
            g_state = None
            if not 0 <= m < n_micro:
                continue
            if stage == n_stages - 1:
                g_y = g_y + g_outs[m]
            x, y = ctx.steps[t]
            got = torch.autograd.grad(y, [x] + trainable, g_y, allow_unused=True)
            for i, gp in zip(idx, got[1:]):
                if gp is not None:
                    grads[i] = gp if grads[i] is None else grads[i] + gp
            if got[0] is not None and stage == 0:
                g_mbs[m] = got[0]
            elif got[0] is not None:
                g_state = got[0]
        ctx.steps = None
        g_mbs = dctx._sum_(g_mbs, (axis,)) if ctx.needs_input_grad[5] else None
        return (None, None, None, None, None, g_mbs) + tuple(
            torch.zeros_like(p) if g is None and p.requires_grad else g
            for p, g in zip(ctx.locs, grads))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   microbatches: torch.Tensor, mesh: DeviceMesh, axis: str = "pipe"):
    """Run the stages of every rank on the axis `axis` as a pipeline.

    stage_fn(params, x) -> y of x's shape and type; stage_params: this
    rank's stage (`stage_params` of the stacked tree); microbatches:
    [n_micro, mb, ...], the same on every rank. Returns the last stage's
    outputs [n_micro, mb, ...] on every rank. Differentiable with respect
    to the microbatches and the stage's parameters. Every rank of the axis
    calls it."""
    leaves, treedef = tree_flatten(stage_params)
    with dctx.mesh_context(mesh):
        if dctx._axis(axis) is None:       # one stage: sequential apply
            return torch.stack([stage_fn(stage_params, mb) for mb in microbatches])
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in [microbatches] + leaves)
        return _Pipeline.apply(stage_fn, treedef, axis, mesh, grad,
                               microbatches.contiguous(), *leaves)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
