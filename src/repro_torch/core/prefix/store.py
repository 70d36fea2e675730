"""Radix prefix KV store over the slot pool.

A per-bucket radix tree keyed by token prefix. Each node owns one edge
segment of tokens plus the host-side K/V rows for exactly those positions
(numpy, sliced from a retired request's pool row), so sibling prefixes
share their common ancestors' K/V bytes instead of duplicating them. The
store is a pure host structure — numpy only — and the engine owns
all device work (scatter on hit, gather on insert).

Why a FOREST keyed by the padded prompt bucket `lp` rather than one tree:
after the canonical true-position read (see models.lm._attn_chunk), K/V bits at
position t are a function of (tokens[0..t], lp) — independent of the
request's left-pad offset and of how prefill was chunked — but the
attention reduction's axis length lp may still affect blocking, so entries
are only provably bit-exact for admissions of the same bucket. Trees for
different lp never share bytes.

Concurrency/lifetime invariants (held against the JAX package's store in
tests/test_torch_engine_modes.py):
  * lookup() pins every node on the matched path (refcount) and returns a
    lease; eviction NEVER removes a node with refs > 0, so K/V an
    in-flight admission may still scatter cannot vanish under it.
  * Node splits during insert preserve pins: the new parent created by a
    split inherits membership in every active lease whose path crossed the
    split node, so release() decrements exactly what is pinned.
  * bytes_used == sum(len(node.segment) for all nodes) * token_bytes at
    all times, for arbitrary interleavings of insert/lookup/release/evict.
  * Eviction is leaf-only LRU (deterministic logical clock, no wall time):
    removing a leaf may expose its parent as the next candidate, so the
    loop converges to the budget whenever enough unpinned bytes exist.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["PrefixLease", "PrefixStore", "tree_concat_positions",
           "tree_pad_positions"]


# K/V payload trees are nested dicts of numpy arrays shaped like one slot
# row of the lm slot pool: per-layer leaves [wc, kh, hd] and stacked body
# leaves [nb, wc, kh, hd] — the position axis is always ndim - 3.


def _pos_axis(leaf: np.ndarray) -> int:
    if leaf.ndim < 3:
        raise ValueError(f"K/V leaf needs >= 3 dims, got shape {leaf.shape}")
    return leaf.ndim - 3


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_multimap(fn, trees: List[Any]) -> Any:
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_multimap(fn, [t[k] for t in trees]) for k in head}
    return fn(trees)


def _slice_positions(tree: Any, start: int, stop: int) -> Any:
    def f(leaf):
        ax = _pos_axis(leaf)
        idx = tuple(slice(None) for _ in range(ax)) + (slice(start, stop),)
        return np.ascontiguousarray(leaf[idx])
    return _tree_map(f, tree)


def tree_concat_positions(trees: List[Any]) -> Any:
    """Concatenate K/V trees along the position axis (host-side)."""
    def f(leaves):
        return np.concatenate(leaves, axis=_pos_axis(leaves[0]))
    return _tree_multimap(f, trees)


def tree_pad_positions(tree: Any, length: int) -> Any:
    """Zero-pad every leaf's position axis out to `length`."""
    def f(leaf):
        ax = _pos_axis(leaf)
        have = leaf.shape[ax]
        if have == length:
            return leaf
        pad = [(0, 0)] * leaf.ndim
        pad[ax] = (0, length - have)
        return np.pad(leaf, pad)
    return _tree_map(f, tree)


class _Node:
    """One radix edge: `segment` tokens ending at depth `end`, with the K/V
    rows for true positions [end - len(segment), end)."""

    __slots__ = ("segment", "kv", "children", "parent", "refs", "last_used")

    def __init__(self, segment: np.ndarray, kv: Any, parent: "_Node"):
        self.segment = segment
        self.kv = kv
        self.children: Dict[int, "_Node"] = {}  # keyed by first token
        self.parent = parent
        self.refs = 0
        self.last_used = 0


@dataclass
class PrefixLease:
    """Pin on a matched path, held from admission until retire/cancel."""
    lp: int
    match_len: int
    _nodes: List[_Node] = field(repr=False, default_factory=list)
    _released: bool = False


class PrefixStore:
    """Refcounted, LRU-evicting radix store of prefix K/V, per-lp forest."""

    def __init__(self, bytes_budget: int, token_bytes: int, registry=None,
                 labels=None):
        assert token_bytes > 0, token_bytes
        self.bytes_budget = int(bytes_budget)
        self.token_bytes = int(token_bytes)
        self._roots: Dict[int, _Node] = {}       # lp -> sentinel root
        self._tokens_stored = 0                  # sum of len(segment)
        self._tick = 0                           # deterministic LRU clock
        self._leases: List[PrefixLease] = []     # active (unreleased) pins
        # registry-backed counters behind the historical dict interface
        # (the owning engine passes its registry AND its slice/tenant
        # labels, so per-slice stores stay distinct series under one fleet
        # root; standalone stores get a private registry) — store contents
        # survive a metrics reset, only the counters clear, so readers diff
        # across warmup boundaries
        if registry is None:
            from repro_torch.core.metrics import MetricsRegistry

            registry = MetricsRegistry("prefix_store")
        self.registry = registry
        self.stats = registry.view("prefix_store", (
            "lookups", "hits", "hit_tokens", "inserts", "inserted_tokens",
            "evictions", "evicted_tokens"), labels=labels)

    # -- introspection ----------------------------------------------------

    @property
    def bytes_used(self) -> int:
        return self._tokens_stored * self.token_bytes

    def node_count(self) -> int:
        return sum(self._count(r) for r in self._roots.values())

    def _count(self, node: _Node) -> int:
        return sum(1 + self._count(c) for c in node.children.values())

    # -- matching ---------------------------------------------------------

    def _walk(self, lp: int, tokens: np.ndarray):
        """Longest-prefix walk. Returns (path nodes under root, matched)."""
        root = self._roots.get(lp)
        path: List[_Node] = []
        matched = 0
        if root is None:
            return path, matched
        tokens = np.asarray(tokens)
        node = root
        while matched < len(tokens):
            child = node.children.get(int(tokens[matched]))
            if child is None:
                break
            seg = child.segment
            n = min(len(seg), len(tokens) - matched)
            eq = seg[:n] == tokens[matched:matched + n]
            common = int(n if eq.all() else np.argmin(eq))
            if common == 0:
                break
            matched += common
            path.append(child)
            if common < len(seg):
                break  # diverged (or ran out) inside this edge
            node = child
        return path, matched

    def peek(self, lp: int, tokens: np.ndarray) -> int:
        """Longest stored match length (a partial final edge counts:
        kv_prefix slices nodes, so any walked depth is assemblable) — no
        pin, no LRU touch. Used for prefix-affinity dispatch and for
        insert dedupe on retire."""
        _, matched = self._walk(lp, tokens)
        return matched

    # -- lookup / lease ---------------------------------------------------

    def lookup(self, lp: int, tokens: np.ndarray) -> Optional[PrefixLease]:
        """Pin the longest matched path; None on zero match."""
        self.stats["lookups"] += 1
        path, matched = self._walk(lp, tokens)
        if matched == 0:
            return None
        self._tick += 1
        for node in path:
            node.refs += 1
            node.last_used = self._tick
        lease = PrefixLease(lp=lp, match_len=matched, _nodes=list(path))
        self._leases.append(lease)
        self.stats["hits"] += 1
        self.stats["hit_tokens"] += matched
        return lease

    def kv_prefix(self, lease: PrefixLease, m: int) -> Optional[Any]:
        """Assemble host K/V for true positions [0, m) from the leased
        path. m must not exceed lease.match_len."""
        if lease._released or m <= 0:
            return None
        assert m <= lease.match_len, (m, lease.match_len)
        parts: List[Any] = []
        depth = 0
        for node in lease._nodes:
            take = min(len(node.segment), m - depth)
            if take <= 0:
                break
            parts.append(node.kv if take == len(node.segment)
                         else _slice_positions(node.kv, 0, take))
            depth += take
        assert depth == m, (depth, m)
        return tree_concat_positions(parts) if len(parts) > 1 else parts[0]

    def release(self, lease: PrefixLease) -> None:
        """Unpin (idempotent)."""
        if lease._released:
            return
        lease._released = True
        for node in lease._nodes:
            node.refs -= 1
            assert node.refs >= 0
        self._leases.remove(lease)

    # -- insert -----------------------------------------------------------

    def insert(self, lp: int, tokens: np.ndarray, kv: Any) -> int:
        """Store K/V for `tokens` (positions [0, len(tokens)) of a prompt
        of bucket lp). `kv` leaves must cover at least len(tokens) on the
        position axis. Already-stored positions are skipped (their bits are
        identical by the canonical-read invariant). Evicts LRU leaves to
        the byte budget afterwards. Returns #tokens newly stored."""
        tokens = np.asarray(tokens, dtype=np.int64)
        if len(tokens) == 0:
            return 0
        root = self._roots.setdefault(lp, _Node(np.empty(0, np.int64), None, None))
        self._tick += 1
        node = root
        depth = 0
        added = 0
        while depth < len(tokens):
            node.last_used = self._tick
            child = node.children.get(int(tokens[depth]))
            if child is None:
                seg = tokens[depth:]
                leaf = _Node(seg, _slice_positions(kv, depth, len(tokens)), node)
                leaf.last_used = self._tick
                node.children[int(seg[0])] = leaf
                self._tokens_stored += len(seg)
                added += len(seg)
                break
            seg = child.segment
            n = min(len(seg), len(tokens) - depth)
            eq = seg[:n] == tokens[depth:depth + n]
            common = int(n if eq.all() else np.argmin(eq))
            if common < len(seg):
                if depth + common == len(tokens):
                    break  # strict prefix of an existing edge: nothing new
                child = self._split(child, common)
            depth += common
            node = child
        self._evict_to_budget()
        self.stats["inserts"] += 1
        self.stats["inserted_tokens"] += added
        return added

    def _split(self, node: _Node, at: int) -> _Node:
        """Split `node`'s edge at `at` (> 0), returning the new upper node.
        The upper node joins every active lease that pinned `node`, so pins
        keep covering the full matched path and release() stays exact."""
        assert 0 < at < len(node.segment)
        upper = _Node(node.segment[:at], _slice_positions(node.kv, 0, at),
                      node.parent)
        upper.last_used = node.last_used
        node.parent.children[int(node.segment[0])] = upper
        node.segment = node.segment[at:]
        node.kv = _slice_positions(node.kv, at, at + len(node.segment))
        node.parent = upper
        upper.children[int(node.segment[0])] = node
        for lease in self._leases:
            if node in lease._nodes:
                i = lease._nodes.index(node)
                lease._nodes.insert(i, upper)
                upper.refs += 1
        return upper

    # -- eviction ---------------------------------------------------------

    def _evict_to_budget(self) -> None:
        while self.bytes_used > self.bytes_budget:
            victim = None
            for lp, root in self._roots.items():
                for node in _iter_leaves(root):
                    if node.refs == 0 and (
                            victim is None or node.last_used < victim.last_used):
                        victim = node
            if victim is None:
                return  # everything left is pinned (or empty)
            del victim.parent.children[int(victim.segment[0])]
            self._tokens_stored -= len(victim.segment)
            self.stats["evictions"] += 1
            self.stats["evicted_tokens"] += len(victim.segment)
        for lp in [k for k, r in self._roots.items() if not r.children]:
            del self._roots[lp]


def _iter_leaves(node: _Node):
    for child in node.children.values():
        if child.children:
            yield from _iter_leaves(child)
        else:
            yield child
