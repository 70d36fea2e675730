"""Per-rank op counts of one step: the counterpart of the JAX package's
trip-count-aware HLO parser (src/repro/analysis/hlo_parse.py).

PyTorch has no HLO: a step is a Python function that runs op by op. So the
counter runs the step once, on this rank's local shards as meta tensors
(shapes and types, nothing computed), under a `TorchDispatchMode` that sees
every aten op the step dispatches, its backward and the recomputation of
its checkpointed layers included. A loop that runs a product 11 times
dispatches it 11 times: that is the HLO parser's trip-count multiplier, and
nothing has to be parsed for it. What it accounts, per rank, as the HLO
parser does for post-SPMD HLO:

  * dots: every matrix product (`mm`, `bmm`, `addmm`, `baddbmm`; `matmul`,
    `einsum` and `linear` reach the dispatcher as these). FLOPs are
    2 * prod(out) * contracted size; bytes lhs + rhs + out.
  * decode attention: the hand-written kernel is bound with ctypes, so no
    dispatch mode sees it. Its meta branch reports its QK and PV products
    here (`note_dot`), 2 * B * H * S * D FLOPs each over the whole ring: the
    work of the JAX package's dense attention dots at the same shape.
  * collectives: every collective of the port is an all-reduce through
    `distributed/ctx.py::_sum_`, which reports each one here with the
    collective it implements. Two wire counts: the *logical* one, the
    reference's ring formula for that kind (all-reduce 2 P (n-1)/n,
    all-gather P_out (n-1)/n, reduce-scatter P_out (n-1), all-to-all
    P (n-1)/n, collective-permute P; `logical_wire`), and what the port
    sends, an all-reduce of the buffer it reduces, 2 P (n-1)/n a mesh axis
    (`wire_bytes`). Each is also split by link: a group within 8
    consecutive ranks (one node of 8 cards) takes NVLink, any other the
    network.
  * memory, the counterpart of `compiled.memory_analysis()`: argument bytes
    (the rank's state and inputs), output bytes, alias bytes (outputs that
    are argument storages updated in place: the train state, the decode
    cache) and temp bytes, the peak over the step of the bytes of the live
    storages the step created, its outputs left out. A storage is freed
    when its last reference dies (a weakref finalizer on it).
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# the matrix products, and the index of their lhs among the op's arguments
_DOT_LHS = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1, aten.addbmm: 1}

NODE = 8  # cards a node: a group within 8 consecutive ranks takes NVLink


def logical_wire(kind: str, out_bytes: float, n: int) -> float:
    """Wire bytes a rank of a group of n sends for a collective of `kind`
    whose per-rank output is `out_bytes` (the JAX package's ring formulas,
    `hlo_parse._collective_wire`)."""
    if n <= 1 or out_bytes == 0:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return float(out_bytes) * (n - 1)
    if kind == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective {kind!r}")


def link_of(ranks: Sequence[int]) -> str:
    """"nvlink" for a group within one node of `NODE` consecutive ranks,
    else "network"."""
    return "nvlink" if len({r // NODE for r in ranks}) <= 1 else "network"


@dataclass
class Op:
    """One counted op: a dot ("dot") or a collective (its logical kind)."""
    kind: str
    name: str
    shape: str
    flops: float = 0.0
    bytes: float = 0.0          # a dot's lhs + rhs + out; a collective's payload
    wire: float = 0.0           # a collective's logical wire bytes
    sent: float = 0.0           # the wire bytes of the all-reduces it runs
    link: str = ""
    site: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class StepCost:
    """One rank's counts of one step (the fields of the JAX package's
    `HloCost`, and the memory and link splits besides). `wire_bytes` is
    what the port sends; `logical_wire_bytes` what the reference's
    collectives of the same kinds would."""
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_counts: Dict[str, float] = field(default_factory=dict)
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    param_bytes: float = 0.0
    dots: int = 0
    logical_wire_bytes: float = 0.0
    wire_by_link: Dict[str, float] = field(default_factory=dict)
    logical_wire_by_link: Dict[str, float] = field(default_factory=dict)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    temp_bytes: float = 0.0
    ops: List[Op] = field(default_factory=list)
    # the storages alive at the temp peak, largest first: (bytes, shape, dtype, site)
    temp_at_peak: List[tuple] = field(default_factory=list)

    @property
    def bytes_per_device(self) -> float:
        return self.argument_bytes + self.temp_bytes + self.output_bytes - self.alias_bytes

    def memory_analysis(self) -> Dict[str, float]:
        """The keys of the JAX package's dry-run record."""
        return {"temp_size_in_bytes": self.temp_bytes,
                "argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "alias_size_in_bytes": self.alias_bytes,
                "generated_code_size_in_bytes": 0.0}

    def to_dict(self) -> Dict[str, Any]:
        return {"dot_flops": self.dot_flops, "dot_bytes": self.dot_bytes,
                "wire_bytes": self.wire_bytes, "dots": self.dots,
                "collective_counts": self.collective_counts,
                "collective_bytes": self.collective_bytes,
                "param_bytes": self.param_bytes,
                "logical_wire_bytes": self.logical_wire_bytes,
                "wire_by_link": self.wire_by_link,
                "logical_wire_by_link": self.logical_wire_by_link}


_ACTIVE: Optional["_Counter"] = None


def _site() -> str:
    """The innermost frame of the port's model or distributed code on the
    stack (not `ctx.py`'s own, unless there is no other), as
    `models/lm.py:421`; in a backward op, the forward's, from the autograd
    node's anomaly-mode traceback."""
    f = sys._getframe(2)
    fallback = ""
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        for part in ("repro_torch/models/", "repro_torch/distributed/"):
            if part in fn:
                tag = f"{fn.split('repro_torch/', 1)[1]}:{f.f_lineno}"
                if not fn.endswith("distributed/ctx.py"):
                    return tag
                fallback = fallback or tag
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is not None:
        tb = node.metadata.get("traceback_") or ""
        best = ""
        for line in "".join(tb).splitlines():
            line = line.strip()
            for part in ("repro_torch/models/", "repro_torch/distributed/"):
                if line.startswith("File") and part in line and "distributed/ctx.py" not in line:
                    path = line.split('"')[1].split("repro_torch/", 1)[1]
                    best = f"{path}:{line.split('line ')[1].split(',')[0]}"
        if best:
            return f"backward of {best} ({node.name()})"
        return f"backward ({node.name()})"
    return fallback or "step"


class _Counter(TorchDispatchMode):
    def __init__(self, cost: StepCost, sites: bool):
        super().__init__()
        self.cost, self.sites = cost, sites
        self.args: Dict[int, int] = {}          # argument storages: key -> bytes
        self.live: Dict[int, int] = {}          # created storages alive: key -> id
        self.events: List[tuple] = []           # (id, +bytes) at alloc, (id, -bytes) at free
        self.what: List[tuple] = []             # by id: (shape, dtype, site)
        self.next_id = 0

    def _note_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.args or key in self.live:
            return
        i, n = self.next_id, st.nbytes()
        self.next_id += 1
        self.live[key] = i
        self.events.append((i, n))
        self.what.append((tuple(t.shape), str(t.dtype).replace("torch.", ""),
                          _site() if self.sites else ""))
        weakref.finalize(st, self._free, key, i, n)

    def _free(self, key: int, i: int, n: int) -> None:
        if self.live.get(key) == i:
            del self.live[key]
        self.events.append((i, -n))

    def dot(self, name: str, lhs_shape, out_shape, flops: float, nbytes: float) -> None:
        c = self.cost
        c.dot_flops += flops
        c.dot_bytes += nbytes
        c.dots += 1
        c.ops.append(Op("dot", name, f"{tuple(lhs_shape)}->{tuple(out_shape)}", flops, nbytes,
                        site=_site() if self.sites else ""))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        lhs_i = _DOT_LHS.get(func.overloadpacket)
        if lhs_i is not None:
            lhs, rhs = args[lhs_i], args[lhs_i + 1]
            flops = 2.0 * out.numel() * lhs.shape[-1]
            self.dot(func.overloadpacket.__name__, lhs.shape, out.shape, flops,
                     float(lhs.nbytes + rhs.nbytes + out.nbytes))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._note_storage(t)
        return out


def note_dot(name: str, lhs_shape, out_shape, flops: float, nbytes: float) -> None:
    """Count a product that no dispatch mode sees (a ctypes-bound kernel's):
    its FLOPs and bytes as the caller works them out. A no-op unless a step
    is being counted."""
    if _ACTIVE is not None:
        _ACTIVE.dot(name, lhs_shape, out_shape, float(flops), float(nbytes))


def note_collective(kind: str, out_bytes: float, buffer_bytes: float,
                    joint_ranks: Sequence[int], axis_ranks: Sequence[Sequence[int]]) -> None:
    """Count one collective of `kind` whose per-rank output is `out_bytes`,
    over the group `joint_ranks`, run by the port as an all-reduce of
    `buffer_bytes` over each group of `axis_ranks` in turn
    (`distributed/ctx.py::_sum_`). A no-op unless a step is being counted."""
    if _ACTIVE is None:
        return
    c = _ACTIVE.cost
    wire = logical_wire(kind, out_bytes, len(joint_ranks))
    link = link_of(joint_ranks)
    sent = 0.0
    for ranks in axis_ranks:
        s = logical_wire("all-reduce", buffer_bytes, len(ranks))
        c.wire_by_link[link_of(ranks)] = c.wire_by_link.get(link_of(ranks), 0.0) + s
        sent += s
    c.wire_bytes += sent
    c.logical_wire_bytes += wire
    c.logical_wire_by_link[link] = c.logical_wire_by_link.get(link, 0.0) + wire
    c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
    c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + out_bytes
    c.ops.append(Op(kind, kind, f"n={len(joint_ranks)}", 0.0, float(out_bytes), wire, sent,
                    link, _site() if _ACTIVE.sites else ""))


def _storages(tree) -> Dict[int, int]:
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def analyze_step(fn, *args, sites: bool = False, params=None) -> StepCost:
    """Run fn(*args) once under the counter and return its StepCost. args:
    the rank's inputs (meta tensors, or real ones: nothing here reads a
    value). params: the part of args that is the weights, for
    `param_bytes`. sites: tag each dot and collective with its call site
    (`_site`); backward ops find their forward's through anomaly mode's
    tracebacks, which costs time."""
    global _ACTIVE
    cost = StepCost()
    arg_st = _storages(args)
    cost.argument_bytes = float(sum(arg_st.values()))
    cost.param_bytes = float(sum(_storages(params).values())) if params is not None else 0.0
    counter = _Counter(cost, sites)
    counter.args = dict(arg_st)
    prev = _ACTIVE
    _ACTIVE = counter
    try:
        if sites:
            with torch.autograd.set_detect_anomaly(True, check_nan=False), counter:
                out = fn(*args)
        else:
            with counter:
                out = fn(*args)
    finally:
        _ACTIVE = prev
    out_st = _storages(out)
    cost.output_bytes = float(sum(out_st.values()))
    cost.alias_bytes = float(sum(n for k, n in out_st.items() if k in arg_st))
    outputs = {counter.live[k] for k in out_st if k in counter.live}
    events = [(i, n) for i, n in counter.events if i not in outputs]
    live = peak = at = 0
    for j, (i, n) in enumerate(events):
        live += n
        if live > peak:
            peak, at = live, j
    cost.temp_bytes = float(peak)
    alive: Dict[int, int] = {}
    for i, n in events[:at + 1]:
        if n > 0:
            alive[i] = n
        else:
            alive.pop(i, None)
    cost.temp_at_peak = sorted(((n,) + counter.what[i] for i, n in alive.items()),
                               reverse=True)
    del out
    return cost
