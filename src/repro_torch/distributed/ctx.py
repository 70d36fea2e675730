"""The ambient device mesh, and the collectives the model code closes its
sharded contractions with.

The sharded serve steps (`core/steps.py`) set the mesh around a call of the
model's own functions (`models/lm.py`), which then run on this rank's local
shards. The collectives work over the mesh's `model` axis (the attention,
MLP, SSM and vocab contractions), its `data` axis (the expert-parallel
all-to-all) or its data axes, `pod` and `data` (the MoE's token groups and
its weight gather). With no mesh set, or an axis of size 1, each is the
identity and returns its input, so every single-device path computes what
it did without it. The mesh context also says whether the rows a rank
holds are its data shard of the batch or the whole batch (`rows_cut`):
the data axes cut a batch only when they divide it (`steps.shard_batch`),
and the MoE layer, the one layer that mixes rows, needs to know which. And
it says whether the attention caches are cut along their sequence over
`model` (`seq_cut`, the small-serve layout of models under 1B parameters):
each rank then attends over its cut of a cache and the ranks' partial
outputs merge by their log-sum-exp (`merge_seq_shards`).

Every collective is an all-reduce. A gather or an all-to-all is written as
an all-reduce into a zero-filled buffer, which is exact (one rank
contributes each element and the others add zeros); a reduce-scatter is an
all-reduce (in fp32 for 16-bit inputs) sliced and rounded once. gloo, the
backend of ranks that share one card, offers only `broadcast` and
`all_reduce` on CUDA tensors. Over the data axes a sum runs over `data`,
then over `pod`.

The collectives have a backward, so that a loss differentiates through a
mesh (the sharded train step, `core/steps.make_sharded_train_step`). Where
the input needs no gradient, each runs as it did without one, bit for bit.
The backward follows from what a rank holds on each axis. Over `model`,
activations are replicated: every rank computes the same loss from the
same values, so the sum of partial products (`all_reduce_model`,
`matmul_model`) passes its gradient through, a gather over `model` keeps
the rank's own slice of its gradient, and `enter_model`, the identity,
sums its gradient over `model` where a replicated activation enters a
contraction cut over `model` (Megatron's f and g). Over the data axes, rows
differ: a rank's gradient of a gathered weight is a partial sum, so a
gather over them (the FSDP weight gather, `gather_fsdp`) has a
reduce-scatter as its backward, an all-reduce of the gradient sliced. The
batch-DP re-layout of attention (`rows_to_model` / `rows_from_model`)
permutes values across `model` ranks, and each is the other's backward.
Where the ranks go on with different parts of a sum or a gather (the
Mamba2 block's heads of its gathered channels and of its norm's sum over
`model`; an MoE's global groups, whose rows each data rank keeps its own
of), the backward sums their gradients over those axes (`grad_sum`); a
loss term every data rank computes alike from the whole batch enters the
gradient once (`once_over`).

Each collective reports itself to the dry run's op counter
(`analysis/op_trace.py`) as the collective it implements (an all-gather,
a reduce-scatter, an all-to-all, a collective-permute) beside the
all-reduce it runs; with no step being counted that is one check.

The JAX package also keeps a `shard_map` version shim here, for its
`moe_shard_map`. This package has none: its `models/layers.moe_shard_map`
runs on the shards a rank already holds (`core/steps.shard_params`) and
calls the collectives below where the JAX version's `shard_map` body calls
`all_to_all`, `psum_scatter`, `all_gather` and `pmean`.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.analysis import op_trace

_MESH = None
_ROWS_CUT = True
_SEQ_CUT = False
# the collective the all-reduces under `_as` implement: (kind, per-rank output bytes)
_KIND: Optional[Tuple[str, float]] = None
_GROUPS: Dict[tuple, tuple] = {}


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def mesh_context(mesh, rows_cut: bool = True, seq_cut: bool = False):
    """Set `mesh` for the body. rows_cut: the batch a rank holds is its cut
    over the data axes (False: every data rank holds the whole batch).
    seq_cut: the serve rules map the caches' `seq` axis to `model` (the
    small-serve layout)."""
    global _MESH, _ROWS_CUT, _SEQ_CUT
    prev = _MESH, _ROWS_CUT, _SEQ_CUT
    _MESH, _ROWS_CUT, _SEQ_CUT = mesh, rows_cut, seq_cut
    try:
        yield
    finally:
        _MESH, _ROWS_CUT, _SEQ_CUT = prev


def rows_cut() -> bool:
    return _ROWS_CUT


def _axis(name: str) -> Optional[Tuple[object, int, int]]:
    """(process group, this rank's coordinate, size) of the ambient mesh's
    axis `name`, or None with no mesh, no such axis, or one of size 1."""
    mesh = _MESH
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if name not in names:
        return None
    size = mesh.size(names.index(name))
    if size == 1:
        return None
    return mesh.get_group(name), mesh.get_local_rank(name), size


def _model_axis():
    return _axis("model")


def seq_cut_active() -> bool:
    """Whether attention caches may be cut along their sequence: the
    small-serve layout on a `model` axis wider than 1."""
    return _SEQ_CUT and _model_axis() is not None


def seq_cut(n: int) -> Optional[Tuple[int, int]]:
    """(offset, length) of this rank's cut of an attention cache of n slots
    along its sequence, slots [r L, (r + 1) L) with L = n / m on `model`
    rank r of m; None where the cache is whole: no such layout, or an axis
    that does not divide n (the JAX package's `spec_for` keeps such a dim
    whole)."""
    ax = _model_axis()
    if not _SEQ_CUT or ax is None or n % ax[2]:
        return None
    length = n // ax[2]
    return ax[1] * length, length


def mesh_size() -> int:
    """Ranks in the ambient mesh (1 with none)."""
    return 1 if _MESH is None else int(_MESH.size())


def coordinate(names: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index over the axes `names`, folded major to minor, and
    their combined size); (0, 1) with no mesh."""
    idx, n = 0, 1
    for name in names:
        ax = _axis(name)
        if ax is not None:
            idx, n = idx * ax[2] + ax[1], n * ax[2]
    return idx, n


DP = ("pod", "data")  # the data axes, major to minor; a missing one counts as size 1


def model_coordinate() -> Tuple[int, int]:
    """(this rank's coordinate on the `model` axis, the axis' size); (0, 1)
    with no mesh."""
    return coordinate(("model",))


@contextmanager
def _as(kind: str, out_bytes: float):
    """Count the all-reduces of the body as one collective of `kind` with a
    per-rank output of `out_bytes` (the op counter's logical kind)."""
    global _KIND
    prev, _KIND = _KIND, (kind, out_bytes)
    try:
        yield
    finally:
        _KIND = prev


def _groups(names: Sequence[str]) -> Tuple[List[int], List[List[int]]]:
    """The ranks of this rank's group over the axes `names` together, and
    of its group over each of them of size > 1 (for the op counter)."""
    mesh = _MESH
    key = (id(mesh), tuple(names))
    if key not in _GROUPS or _GROUPS[key][0] is not mesh:
        with _disable_current_modes():
            dims = [mesh.mesh_dim_names.index(n) for n in names if _axis(n) is not None]
            coord = mesh.get_coordinate()

            def ranks(cut):
                idx = tuple(slice(None) if d in cut else c for d, c in enumerate(coord))
                return mesh.mesh[idx].flatten().tolist()

            _GROUPS[key] = mesh, ranks(dims), [ranks([d]) for d in dims]
    return _GROUPS[key][1:]


def _sum_(x: torch.Tensor, names: Sequence[str], op=None, kind: str = "all-reduce",
          out_bytes: Optional[float] = None) -> torch.Tensor:
    """All-reduce x in place over each axis of `names` in turn (a sum, or
    `op`). kind, out_bytes: the collective this implements and its
    per-rank output (x's bytes by default), as the op counter records it
    (overridden under `_as`)."""
    if op_trace._ACTIVE is not None and coordinate(names)[1] > 1:
        k, b = _KIND or (kind, x.nbytes if out_bytes is None else out_bytes)
        op_trace.note_collective(k, b, x.nbytes, *_groups(names))
    for name in names:
        ax = _axis(name)
        if ax is not None:
            if op is None:
                dist.all_reduce(x, group=ax[0])
            else:
                dist.all_reduce(x, op=op, group=ax[0])
    return x


def _summable(x: torch.Tensor) -> torch.Tensor:
    """x as a collective sums it: fp32 for 16-bit types, contiguous."""
    return (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x).contiguous()


def _grad(*xs: torch.Tensor) -> bool:
    """Whether autograd records an op on xs: then a collective runs as its
    differentiable Function, with the same forward."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _all_reduce(x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
    return _sum_(_summable(x), names, out_bytes=x.nbytes).to(x.dtype)


def _sum_copy(x: torch.Tensor, names: Sequence[str], kind: str = "all-reduce",
              out_bytes: Optional[float] = None) -> torch.Tensor:
    """`_all_reduce` that leaves x as it is (a Function's input or incoming
    gradient may be shared)."""
    y = _summable(x)
    return _sum_(y.clone() if y is x else y, names, kind=kind,
                 out_bytes=x.nbytes if out_bytes is None else out_bytes).to(x.dtype)


def _gather(x: torch.Tensor, dim: int, names: Sequence[str]) -> torch.Tensor:
    idx, n = coordinate(names)
    dim = dim % x.dim()
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = k * n
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, idx * k, k).copy_(x)
    return _sum_(full, names, kind="all-gather")


def _own(x: torch.Tensor, dim: int, names: Sequence[str]) -> torch.Tensor:
    """This rank's chunk of x along `dim` over the axes `names`."""
    idx, n = coordinate(names)
    k = x.shape[dim] // n
    return x.narrow(dim, idx * k, k).contiguous()


class _AllReduce(torch.autograd.Function):
    """The sum of partials over `names`; its gradient passes through (each
    rank holds the whole gradient of the replicated sum), summed over the
    axes `grad_sum` (where the ranks use the sum differently)."""

    @staticmethod
    def forward(ctx, x, names, grad_sum):
        ctx.grad_sum = grad_sum
        return _sum_copy(x, names)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum and coordinate(ctx.grad_sum)[1] > 1:
            g = _sum_copy(g, ctx.grad_sum)
        return g, None, None


def all_reduce(x: torch.Tensor, names: Sequence[str],
               grad_sum: Sequence[str] = ()) -> torch.Tensor:
    """The sum of x over the axes `names`. A 16-bit input is summed in fp32
    and rounded back once; an fp32 one is summed in place where it is
    contiguous (NCCL takes only contiguous tensors), unless it needs a
    gradient. Backward: the identity where every rank's loss is the same
    function of the sum; over the axes `grad_sum`, whose ranks go on with
    different parts of it (their own rows, their own channels), the sum of
    the ranks' gradients."""
    if coordinate(names)[1] == 1:
        return x
    if _grad(x):
        return _AllReduce.apply(x, tuple(names), tuple(grad_sum))
    return _all_reduce(x, names)


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def once_over(x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
    """x, a term of the loss that every rank over the axes `names` computes
    alike from the whole batch (the MoE router's loss over global groups):
    the identity, whose backward divides the gradient by those ranks'
    number, so that the sum of the ranks' weight gradients over the data
    axes counts the term once."""
    n = coordinate(names)[1]
    if n == 1 or not _grad(x):
        return x
    return _Once.apply(x, n)


def all_max(x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
    """The elementwise max of x over the axes `names` (no gradient)."""
    if coordinate(names)[1] == 1:
        return x
    return _sum_(x.detach().clone(memory_format=torch.contiguous_format), names,
                 op=dist.ReduceOp.MAX)


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the `model` axis (`all_reduce`)."""
    return all_reduce(x, ("model",))


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_copy(g, ("model",))


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """x, a replicated activation, where it enters a contraction cut over
    the `model` axis (a column-parallel product): the identity, whose
    backward sums the ranks' partial gradients of x over `model`."""
    if _model_axis() is None or not _grad(x):
        return x
    return _EnterModel.apply(x)


def pmean(x: torch.Tensor, names: Sequence[str] = DP) -> torch.Tensor:
    """The mean of x over the axes `names` (the JAX package's `pmean`)."""
    n = coordinate(names)[1]
    return x if n == 1 else all_reduce(x, names) / n


class _MmF32(torch.autograd.Function):
    """a2 @ w of 16-bit CUDA inputs kept in fp32 (`torch.mm`'s out_dtype);
    the backward products run in the inputs' type, as a 16-bit product's
    do."""

    @staticmethod
    def forward(ctx, a2, w):
        ctx.save_for_backward(a2, w)
        return torch.mm(a2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a2, w = ctx.saved_tensors
        g = g.to(a2.dtype)
        return g @ w.t(), a2.t() @ g


def matmul_model(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ w [K, N] where K is this rank's shard of a contraction
    cut over the `model` axis: the partial products summed over the axis.
    With 16-bit inputs each partial product is kept in fp32 (accumulated
    in fp32 and not rounded) and the sum is rounded once to a's type, as
    the unsharded product rounds its fp32 accumulator once. With no model
    axis it is a @ w. Backward: the gradient of the sum passes through to
    each rank's partial product."""
    if _model_axis() is None:
        return a @ w
    if a.dtype not in (torch.bfloat16, torch.float16):
        return all_reduce_model(a @ w)
    a2 = a.reshape(-1, a.shape[-1])
    if not a.is_cuda:
        y = a2.float() @ w.float()
    elif _grad(a2, w):
        y = _MmF32.apply(a2, w)
    else:
        y = torch.mm(a2, w, out_dtype=torch.float32)
    return all_reduce_model(y.reshape(*a.shape[:-1], w.shape[-1])).to(a.dtype)


class _Gather(torch.autograd.Function):
    """The gather over `names`; backward: the gradient summed over the axes
    `summed` (by default the data axes among `names`, where ranks hold
    different rows, so each gradient is a partial sum, and not `model`,
    where each is whole), then this rank's chunk of it."""

    @staticmethod
    def forward(ctx, x, dim, names, summed):
        ctx.dim, ctx.names, ctx.summed = dim % x.dim(), names, summed
        # the op counter's kind of the backward: an all-to-all's is one too
        ctx.kind = "all-to-all" if _KIND and _KIND[0] == "all-to-all" else "reduce-scatter"
        return _gather(x, dim, names)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed and coordinate(ctx.summed)[1] > 1:
            g = _sum_copy(g, ctx.summed, kind=ctx.kind,
                          out_bytes=g.nbytes / coordinate(ctx.names)[1])
        return _own(g, ctx.dim, ctx.names), None, None, None


def gather(x: torch.Tensor, dim: int, names: Sequence[str],
           grad_sum: Optional[Sequence[str]] = None) -> torch.Tensor:
    """x of every rank over the axes `names`, concatenated along `dim` in
    their folded order (the JAX package's tiled `all_gather`). Backward:
    over `model`, the rank's own slice of the gradient; over the data axes,
    the reduce-scatter of it. grad_sum: the axes whose ranks' gradients are
    summed before the slice, where not these defaults (a gather over
    `model` whose ranks go on with different parts of the whole, such as
    the Mamba2 block's channels, sums over `model` too)."""
    if coordinate(names)[1] == 1:
        return x
    if _grad(x):
        summed = tuple(n for n in names if n != "model") if grad_sum is None \
            else tuple(grad_sum)
        return _Gather.apply(x, dim, tuple(names), summed)
    return _gather(x, dim, names)


def gather_fsdp(w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """A weight whole along its d_model dim `dim` of `full` entries: where
    the train rules cut that dim over the data axes (FSDP), the ranks'
    cuts gathered, in w's type (backward: the reduce-scatter of the
    gradient); else w itself."""
    if w.shape[dim] == full:
        return w
    n = coordinate(DP)[1]
    if w.shape[dim] * n != full:
        raise ValueError(f"a weight of shape {tuple(w.shape)} has {w.shape[dim]} of {full} "
                         f"entries along dim {dim} on a mesh of {n} data ranks")
    return gather(w, dim, DP)


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _own(x, dim, ("model",))

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ("model",)), None


def split_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim` of x, replicated over `model` (the
    inverse of a gather over `model`). Backward: the ranks' gradients
    gathered."""
    if _model_axis() is None:
        return x
    if _grad(x):
        return _SplitModel.apply(x, dim % x.dim())
    return _own(x, dim, ("model",))


def _rows_to(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    m = _model_axis()[2]
    pad = -x.shape[0] % m
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    if dim is None:  # x whole on every rank: a copy of its own rows, no
        # collective (a view would keep the whole rows' storage alive)
        return _own(x, 0, ("model",)).clone()
    with _as("all-to-all", x.nbytes):
        return _own(_gather(x, dim, ("model",)), 0, ("model",))


def _rows_from(x: torch.Tensor, dim: Optional[int], rows: int) -> torch.Tensor:
    if dim is None:  # every rank's rows, whole
        return _gather(x, 0, ("model",))[:rows].contiguous()
    with _as("all-to-all", x.nbytes):
        return _own(_gather(x, 0, ("model",)), dim, ("model",))[:rows].contiguous()


class _RowsTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.rows = dim, x.shape[0]
        return _rows_to(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _rows_from(g, ctx.dim, ctx.rows), None


class _RowsFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, rows):
        ctx.dim = dim
        return _rows_from(x, dim, rows)

    @staticmethod
    def backward(ctx, g):
        return _rows_to(g, ctx.dim), None, None


def rows_to_model(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """The all-to-all over `model` from a layout cut along `dim` (KV heads
    or head_dim) with every rank holding the same rows, to rows cut over
    `model` with `dim` whole: x [B, ...] -> this rank's chunk [ceil(B / m),
    ...] of the rows, padded with zero rows to a multiple of m (GSPMD pads
    so). Written as a gather into zeros, exact. With `dim` None, x is whole
    on every rank (the block carry): the rank keeps its chunk of the rows,
    with no collective. Backward: `rows_from_model` of the gradient."""
    if _model_axis() is None:
        return x
    dim = None if dim is None else dim % x.dim()
    return _RowsTo.apply(x, dim) if _grad(x) else _rows_to(x, dim)


def rows_from_model(x: torch.Tensor, dim: Optional[int], rows: int) -> torch.Tensor:
    """The inverse of `rows_to_model`: each rank's chunk of the rows, with
    `dim` whole, back to all `rows` rows (the padding dropped) with `dim`
    cut over `model`; with `dim` None, every row whole on every rank (an
    all-gather). Backward: `rows_to_model` of the gradient."""
    if _model_axis() is None:
        return x
    dim = None if dim is None else dim % x.dim()
    return _RowsFrom.apply(x, dim, rows) if _grad(x) else _rows_from(x, dim, rows)


def merge_seq_shards(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over a whole cache from each `model` rank's attention
    over its cut of it (`seq_cut`): o [B, H, D] and each row's log-sum-exp
    lse [B, H] (fp32; -inf, with o = 0, where the cut holds no valid key).
    Both are gathered in one exact all-reduce and merged in rank order, M =
    max_r lse_r, o = sum_r exp(lse_r - M) o_r / sum_r exp(lse_r - M), in
    fp32, so every rank holds the same bits; returned in o's type. A row
    with no valid key on any rank gives 0."""
    ax = _model_axis()
    if ax is None:
        return o
    both = gather(torch.cat([o.float(), lse.float()[..., None]], -1)[None], 0, ("model",))
    parts, lses = both[..., :-1], both[..., -1]                   # [m, B, H, D], [m, B, H]
    top = lses.max(0).values
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)
    num, den = parts[0] * w[0, ..., None], w[0]
    for r in range(1, ax[2]):
        num = num + parts[r] * w[r, ..., None]
        den = den + w[r]
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(o.dtype)


class _VocabXent(torch.autograd.Function):
    """(lse, gold) of fp32 logits cut along the vocab over `model`; the
    backward is this rank's softmax columns minus its one-hot columns,
    scaled by the incoming gradients: no gather either way."""

    @staticmethod
    def forward(ctx, z, labels, start, vocab):
        n = z.shape[-1]
        col = torch.arange(start, start + n, device=z.device)
        z = z.masked_fill(col >= vocab, float("-inf"))  # the padded vocab slots
        top = all_max(z.amax(-1), ("model",))
        lab = labels.long().clamp(min=0) - start
        own = (lab >= 0) & (lab < n)
        idx = lab.clamp(0, n - 1)
        pick = torch.gather(z, -1, idx[..., None])[..., 0]
        sums = torch.stack([torch.exp(z - top[..., None]).sum(-1),
                            torch.where(own, pick, torch.zeros_like(pick))])
        se, gold = _sum_copy(sums, ("model",)).unbind()
        ctx.save_for_backward(z, top, se, idx, own)
        return top + torch.log(se), gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        # the softmax as exp(z - top) / se: the exponent is not rounded to
        # the lse's ulp (which at |lse| ~ 20 is 1.9e-6)
        z, top, se, idx, own = ctx.saved_tensors
        g = torch.exp(z - top[..., None]) * (g_lse / se)[..., None]
        g.scatter_add_(-1, idx[..., None], torch.where(own, g_gold, 0.0)[..., None])
        return g, None, None, None


def vocab_xent(z: torch.Tensor, labels: torch.Tensor, start: int,
               vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-entropy's log-sum-exp and gold logit of each row, from
    this `model` rank's vocab columns [start, start + n) of fp32 logits z
    [..., n] (columns at or past `vocab` are padding, left out): the
    global lse from one all-reduce of the row max and one of the row sum of
    exponentials (with the gold logit, a masked local pick, beside it);
    labels < 0 pick column 0, as the gathered loss does. Both fp32 [...].
    The logits are never gathered; the backward (`_VocabXent`) is the
    rank's local softmax and one-hot columns."""
    return _VocabXent.apply(z, labels, start, vocab)


def gather_model_last(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] of every rank on the `model` axis, concatenated in axis
    order along the last dim -> [..., n * size]."""
    return gather(x, -1, ("model",))


class _ReduceScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _reduce_scatter_model(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ("model",)), None


def _reduce_scatter_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    _, rank, size = _model_axis()
    y = _sum_(_summable(x), ("model",), kind="reduce-scatter", out_bytes=x.nbytes / size)
    k = x.shape[dim] // size
    return y.narrow(dim, rank * k, k).to(x.dtype).contiguous()


def reduce_scatter_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of x over the `model` axis, of which this rank keeps chunk
    `rank` along `dim` (the JAX package's tiled `psum_scatter`): an fp32
    all-reduce for 16-bit inputs, sliced and rounded once. Backward: the
    ranks' gradients gathered."""
    if _model_axis() is None:
        return x
    if _grad(x):
        return _ReduceScatterModel.apply(x, dim % x.dim())
    return _reduce_scatter_model(x, dim)


def all_to_all_data(x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The JAX package's tiled `all_to_all` over the `data` axis: x is cut
    into `size` chunks along split_dim, chunk k goes to data rank k, and
    each rank concatenates what it receives along concat_dim in data-rank
    order. Every rank's x is gathered (into zeros, exact) and each takes
    its own chunk of each."""
    ax = _axis("data")
    if ax is None:
        return x
    _, rank, size = ax
    with _as("all-to-all", x.nbytes):
        full = gather(x[None], 0, ("data",))      # [size, *x.shape]
    k = x.shape[split_dim] // size
    return torch.cat([full[s].narrow(split_dim, rank * k, k) for s in range(size)],
                     dim=concat_dim)


def shift(x: torch.Tensor, name: str, step: int = 1) -> torch.Tensor:
    """The x of the rank `step` places before this one on the axis `name`,
    cyclically: rank r's x goes to rank (r + step) % n (the JAX package's
    `ppermute` with perm [(i, (i + step) % n)]). Written as an all-reduce
    into a zero-filled buffer of n slots, each rank writing its x into its
    receiver's slot: exact, since one rank contributes each element. The
    op counter counts it as a collective-permute. Not differentiated here:
    the pipeline (`distributed/pipeline.py`), its one caller, runs its
    transpose, the shift by -step, in its own backward. Every rank of the
    axis calls it."""
    _, rank, n = _axis(name)
    buf = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[(rank + step) % n].copy_(x)
    with _as("collective-permute", x.nbytes):
        _sum_(buf, (name,))
    return buf[rank]
