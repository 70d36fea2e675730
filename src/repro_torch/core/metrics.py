"""Unified metrics registry: counters, gauges, and streaming histograms.

Every serving-layer component (`PipelinedRuntime`, `DpuService`,
`ServingEngine`, `MultiSliceEngine`, `PrefixStore`, `FaultInjector`) hangs
its signals off a `MetricsRegistry` instead of ad-hoc dicts and unbounded
sample lists:

  * `Counter` / `Gauge` — plain monotone / settable scalars, labelled;
  * `Histogram` — a streaming log-bucketed quantile sketch (geometric
    buckets, ~2% relative resolution): O(#buckets) memory regardless of
    sample count, exact sum/count/min/max, so means stay exact while
    p50/p95/p99 are read from the sketch (no `np.sort` over per-request
    lists anywhere on the serving path);
  * `StatsView` — a dict-shaped facade over registry counters, so the
    historical `component.stats["key"] += 1` call sites (including the
    trace-time increments inside jitted closures) and every existing test
    that reads `stats[...]` keep working unchanged.

Registries compose: a parent (the runtime) attaches each child component's
registry, so ONE `reset()` clears every accumulator in the pipeline at the
warmup boundary — no counter survives unpaired (the historical drift:
`reset_metrics()` on the runtime, the engines, and the DPU service were
three separate call sites). Counters created with `persistent=True`
(compile/trace counters, which mirror executable caches that a reset does
NOT evict) are exempt and must be diffed by readers, exactly as the bench
harness already does.

Exporters: `snapshot()` (JSON), `prometheus_text()` (text exposition), and
`lint()` (name-uniqueness / label-schema check, also run by CI over the
exported snapshot). All exports are deterministically ordered so a
virtual-clock replay exports byte-identical artifacts.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

# geometric bucket growth: value v lands in bucket floor(log(v)/log(1.02)),
# i.e. ~2% relative quantile resolution — far below the >30% effects the
# bench gates assert on, at a few hundred buckets across 1us..1000s
_GROWTH = 1.02
_LOG_GROWTH = math.log(_GROWTH)

_KINDS = ("counter", "gauge", "histogram")


def _label_key(labels: Optional[Mapping[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone-by-convention scalar (resettable via the registry)."""

    __slots__ = ("name", "labels", "value", "persistent")

    def __init__(self, name: str, labels=(), persistent: bool = False):
        self.name = name
        self.labels = labels
        self.value = 0
        self.persistent = persistent

    def inc(self, delta=1) -> None:
        self.value += delta

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time scalar: set to the latest observation."""

    __slots__ = ("name", "labels", "value", "persistent")

    def __init__(self, name: str, labels=(), persistent: bool = False):
        self.name = name
        self.labels = labels
        self.value = 0
        self.persistent = persistent

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Streaming log-bucketed sketch: bounded memory, exact sum/count/min/
    max, ~2% relative-error quantiles. Values <= 0 land in a dedicated
    bucket (index None) that quantile() treats as 0.0."""

    __slots__ = ("name", "labels", "persistent", "count", "total",
                 "vmin", "vmax", "buckets", "zero_count")

    def __init__(self, name: str, labels=(), persistent: bool = False):
        self.name = name
        self.labels = labels
        self.persistent = persistent
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            self.zero_count += 1
        else:
            idx = int(math.floor(math.log(v) / _LOG_GROWTH))
            self.buckets[idx] = self.buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, p: float) -> float:
        """p in [0, 1]; returns the geometric midpoint of the bucket that
        holds the p-th sample (0.0 for the <=0 bucket), clamped to the
        exact observed min/max so q(0)/q(1) are exact."""
        if not self.count:
            return float("nan")
        rank = max(1, int(math.ceil(p * self.count)))
        seen = self.zero_count
        if rank <= seen:
            return max(0.0, self.vmin)
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank <= seen:
                mid = math.exp((idx + 0.5) * _LOG_GROWTH)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def merge(self, other: "Histogram") -> None:
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self.zero_count += other.zero_count
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zero_count = 0
        self.buckets.clear()


class MetricsRegistry:
    """Labelled metric store with child composition and one-shot reset.

    A component owns one registry; a composing layer (`MultiSliceEngine`
    over its slice engines, `PipelinedRuntime` over engine + DPU service)
    `attach()`es the children so reset/snapshot/quantile see the whole
    pipeline through the root.
    """

    def __init__(self, component: str = ""):
        self.component = component
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._schema: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        self._children: List["MetricsRegistry"] = []
        self._hooks: List[Callable[[], None]] = []

    # -- creation ----------------------------------------------------------
    def _get(self, cls, kind: str, name: str, labels, persistent: bool):
        lk = _label_key(labels)
        label_names = tuple(k for k, _ in lk)
        want = (kind, label_names)
        have = self._schema.setdefault(name, want)
        if have != want:
            raise ValueError(
                f"metric {name!r} re-registered as {want}, already {have}")
        key = (name, lk)
        m = self._metrics.get(key)
        if m is not None:
            return m
        m = cls(name, lk, persistent=persistent)
        self._metrics[key] = m
        return m

    def counter(self, name: str, labels=None, persistent: bool = False) -> Counter:
        return self._get(Counter, "counter", name, labels, persistent)

    def gauge(self, name: str, labels=None, persistent: bool = False) -> Gauge:
        return self._get(Gauge, "gauge", name, labels, persistent)

    def histogram(self, name: str, labels=None,
                  persistent: bool = False) -> Histogram:
        return self._get(Histogram, "histogram", name, labels, persistent)

    def view(self, prefix: str, keys, labels=None,
             persistent=()) -> "StatsView":
        return StatsView(self, prefix, keys, labels=labels,
                         persistent=persistent)

    # -- composition -------------------------------------------------------
    def attach(self, child: "MetricsRegistry") -> "MetricsRegistry":
        if child is not self and child not in self._children:
            self._children.append(child)
        return child

    def detach(self, child: "MetricsRegistry") -> None:
        if child in self._children:
            self._children.remove(child)

    def on_reset(self, hook: Callable[[], None]) -> None:
        self._hooks.append(hook)

    # -- reset: the ONE warmup boundary ------------------------------------
    def reset(self) -> None:
        """Zero every non-persistent metric here and in every attached
        child, then run the registered hooks (which clear Python-side
        state: completed/shed/dead lists, tracer events, drain marks)."""
        for m in self._metrics.values():
            if not m.persistent:
                m.reset()
        for c in self._children:
            c.reset()
        for h in self._hooks:
            h()

    # -- aggregate readers (self + children) -------------------------------
    def _walk(self) -> Iterator[Tuple["MetricsRegistry", object]]:
        for m in self._metrics.values():
            yield self, m
        for c in self._children:
            yield from c._walk()

    def _select(self, name: str, labels: Optional[Mapping[str, str]] = None):
        want = dict(labels or {})
        for _, m in self._walk():
            if m.name != name:
                continue
            got = dict(m.labels)
            if all(got.get(k) == str(v) for k, v in want.items()):
                yield m

    def value(self, name: str, labels=None):
        """Sum of matching counter/gauge values (0 if none)."""
        return sum(m.value for m in self._select(name, labels))

    def merged_histogram(self, name: str, labels=None) -> Histogram:
        h = Histogram(name)
        for m in self._select(name, labels):
            if isinstance(m, Histogram):
                h.merge(m)
        return h

    def quantile(self, name: str, p: float, labels=None) -> float:
        return self.merged_histogram(name, labels).quantile(p)

    # -- exporters ---------------------------------------------------------
    def _rows(self) -> List[dict]:
        rows = []
        for _, m in self._walk():
            row = {"name": m.name, "labels": dict(m.labels),
                   "kind": type(m).__name__.lower()}
            if isinstance(m, Histogram):
                row.update(
                    count=m.count, sum=m.total,
                    min=(None if not m.count else m.vmin),
                    max=(None if not m.count else m.vmax),
                    p50=(None if not m.count else m.quantile(0.50)),
                    p95=(None if not m.count else m.quantile(0.95)),
                    p99=(None if not m.count else m.quantile(0.99)),
                )
            else:
                row["value"] = m.value
            rows.append(row)
        rows.sort(key=lambda r: (r["name"], sorted(r["labels"].items())))
        return rows

    def snapshot(self) -> dict:
        return {"metrics": self._rows()}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=2)

    def prometheus_text(self) -> str:
        lines = []
        seen_type = set()
        for r in self._rows():
            kind = r["kind"]
            if r["name"] not in seen_type:
                seen_type.add(r["name"])
                lines.append(f"# TYPE {r['name']} "
                             f"{'histogram' if kind == 'histogram' else kind}")
            lab = ",".join(f'{k}="{v}"'
                           for k, v in sorted(r["labels"].items()))
            lab = "{" + lab + "}" if lab else ""
            if kind == "histogram":
                lines.append(f"{r['name']}_count{lab} {r['count']}")
                lines.append(f"{r['name']}_sum{lab} {r['sum']}")
                for q in (0.5, 0.95, 0.99):
                    v = r[f"p{int(q * 100)}"]
                    if v is not None:
                        qlab = (lab[:-1] + "," if lab else "{") \
                            + f'quantile="{q}"' + "}"
                        lines.append(f"{r['name']}{qlab} {v}")
            else:
                lines.append(f"{r['name']}{lab} {r['value']}")
        return "\n".join(lines) + "\n"

    def lint(self) -> List[str]:
        """Schema check across self + children: a metric name must map to
        exactly one kind and one label keyset. Returns problems ([] = ok);
        CI runs the same check over the exported snapshot."""
        return lint_rows(self._rows())


def lint_rows(rows) -> List[str]:
    """Shared metric-schema lint: one kind and one label keyset per name,
    no duplicate (name, labels) series. Used by `MetricsRegistry.lint()`
    and by CI over an exported `snapshot()["metrics"]` list."""
    problems: List[str] = []
    schema: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
    seen = set()
    for r in rows:
        want = (r["kind"], tuple(sorted(r["labels"])))
        have = schema.setdefault(r["name"], want)
        if have != want:
            problems.append(
                f"{r['name']}: schema conflict {want} vs {have}")
        key = (r["name"], tuple(sorted(r["labels"].items())))
        if key in seen:
            problems.append(f"{r['name']}: duplicate series {key[1]}")
        seen.add(key)
    return problems


class StatsView:
    """Dict-shaped facade over registry counters.

    `view["k"] += 1`, `dict(view)`, `view.get(k)`, iteration, and `in`
    all behave like the plain dicts these components used to hold — but
    every key is a live registry counter, so one registry-wide `reset()`
    clears them together and the exporters see them labelled. Keys in
    `persistent` (trace/compile counters, which mirror executable caches)
    survive reset and must be diffed by readers.
    """

    __slots__ = ("_registry", "_prefix", "_labels", "_persistent", "_c")

    def __init__(self, registry: MetricsRegistry, prefix: str, keys,
                 labels=None, persistent=()):
        self._registry = registry
        self._prefix = prefix
        self._labels = labels
        self._persistent = frozenset(persistent)
        self._c: Dict[str, Counter] = {}
        for k in keys:
            self._c[k] = registry.counter(
                f"{prefix}_{k}", labels=labels, persistent=k in self._persistent)

    def __getitem__(self, k):
        return self._c[k].value

    def __setitem__(self, k, v) -> None:
        c = self._c.get(k)
        if c is None:
            c = self._c[k] = self._registry.counter(
                f"{self._prefix}_{k}", labels=self._labels,
                persistent=k in self._persistent)
        c.value = v

    def __contains__(self, k) -> bool:
        return k in self._c

    def __iter__(self):
        return iter(self._c)

    def __len__(self) -> int:
        return len(self._c)

    def keys(self):
        return self._c.keys()

    def values(self):
        return [c.value for c in self._c.values()]

    def items(self):
        return [(k, c.value) for k, c in self._c.items()]

    def get(self, k, default=None):
        c = self._c.get(k)
        return default if c is None else c.value

    def __repr__(self) -> str:
        return f"StatsView({dict(self.items())!r})"
