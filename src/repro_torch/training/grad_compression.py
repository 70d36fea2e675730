"""Int8 error-feedback gradient compression: quantize each leaf to int8
with one fp32 scale per tensor, and carry the rounding residual to the next
step, so the compression is unbiased over time. `allreduce_compressed`
averages such gradients across data-parallel ranks: it sums the int8
values as int32 over the mesh's data axes and bounds them by the largest
of the ranks' scales (the JAX package's, on `distributed/ctx.py`'s
collectives). No train step calls it, in either package."""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.distributed import ctx as dctx
from repro_torch.models.params import tree_map

Tree = Dict[str, Any]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale fp32 []): scale = max|x| / 127 (at least 1e-12 / 127),
    q = clip(round-half-even(x / scale), -127, 127)."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_grads(grads: Tree, err: Tree) -> Tuple[Tree, Tree, Tree]:
    """(q tree, scale tree, new error tree): each leaf's fp32 gradient plus
    its carried residual is quantized, and what the int8 values miss is the
    next residual."""
    def one(g, e):
        x = g.to(torch.float32) + e
        q, s = quantize_int8(x)
        return q, s, x - dequantize_int8(q, s)

    trees = tree_map(one, grads, err)
    return tuple(tree_map(lambda t: t[i], trees) for i in range(3))


def decompress_grads(qs: Tree, ss: Tree) -> Tree:
    return tree_map(dequantize_int8, qs, ss)


def allreduce_compressed(grads: Tree, err: Tree,
                         names: Sequence[str] = dctx.DP) -> Tuple[Tree, Tree]:
    """The mean over the ranks of the mesh axes `names` (the ambient mesh's;
    by default its data axes) of each rank's compressed gradients: each
    leaf quantized with its error state (`compress_grads`), the int8 values
    summed as int32, the scales' max taken, and total * s_max / n. Returns
    (the averaged fp32 gradients, the same on every rank; this rank's new
    error state)."""
    qs, ss, new_err = compress_grads(grads, err)
    n = dctx.coordinate(names)[1]

    def reduce_one(q, s):
        total = dctx.all_reduce(q.to(torch.int32), names)
        s_max = dctx.all_max(s, names)
        return total.to(torch.float32) * s_max / n

    return tree_map(reduce_one, qs, ss), new_err
