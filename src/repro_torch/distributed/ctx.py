"""The ambient device mesh, and the collectives the model code closes its
sharded contractions with.

The sharded serve steps (`core/steps.py`) set the mesh around a call of the
model's own functions (`models/lm.py`), which then run on this rank's local
shards. Each collective here works over the mesh's `model` axis; with no
mesh set, or a `model` axis of size 1, it is the identity and returns its
input, so every single-device path computes what it did without it.

Every collective is an all-reduce. A gather is written as an all-reduce
into a zero-filled buffer, which is exact (one rank contributes each
element and the others add zeros): gloo, the backend of ranks that share
one card, offers only `broadcast` and `all_reduce` on CUDA tensors.

The JAX package also keeps a `shard_map` version shim here. It has no
counterpart in this package: GSPMD and `shard_map` hand each device its
shard of the arrays, and here a rank already holds its shards
(`core/steps.shard_params`) and runs plain functions on them.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def mesh_context(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def _model_axis() -> Optional[Tuple[object, int, int]]:
    """(process group, this rank's coordinate, size) of the ambient mesh's
    `model` axis, or None with no mesh or a `model` axis of size 1."""
    mesh = _MESH
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names:
        return None
    size = mesh.size(names.index("model"))
    if size == 1:
        return None
    return mesh.get_group("model"), mesh.get_local_rank("model"), size


def model_coordinate() -> Tuple[int, int]:
    """(this rank's coordinate on the `model` axis, the axis' size); (0, 1)
    with no mesh."""
    axis = _model_axis()
    return (0, 1) if axis is None else (axis[1], axis[2])


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the `model` axis. A 16-bit input is summed in fp32
    and rounded back once; an fp32 one is summed in place."""
    axis = _model_axis()
    if axis is None:
        return x
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.contiguous()
    dist.all_reduce(y, group=axis[0])
    return y.to(x.dtype)


def matmul_model(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ w [K, N] where K is this rank's shard of a contraction
    cut over the `model` axis: the partial products summed over the axis.
    With 16-bit inputs each partial product is kept in fp32 (accumulated
    in fp32 and not rounded) and the sum is rounded once to a's type, as
    the unsharded product rounds its fp32 accumulator once. With no model
    axis it is a @ w."""
    if _model_axis() is None:
        return a @ w
    if a.dtype not in (torch.bfloat16, torch.float16):
        return all_reduce_model(a @ w)
    a2 = a.reshape(-1, a.shape[-1])
    y = (torch.mm(a2, w, out_dtype=torch.float32) if a.is_cuda
         else a2.float() @ w.float())
    return all_reduce_model(y.reshape(*a.shape[:-1], w.shape[-1])).to(a.dtype)


def gather_model_last(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] of every rank on the `model` axis, concatenated in axis
    order along the last dim -> [..., n * size]."""
    axis = _model_axis()
    if axis is None:
        return x
    group, rank, size = axis
    n = x.shape[-1]
    full = torch.zeros(*x.shape[:-1], n * size, dtype=x.dtype, device=x.device)
    full[..., rank * n:(rank + 1) * n] = x
    dist.all_reduce(full, group=group)
    return full
