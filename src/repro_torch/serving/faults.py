"""Deterministic fault-injection harness + typed shed/dead bookkeeping.

PREBA's value claim is an inference *server*, and a server is defined by
what it does when a slice flaps, a CU launch dies, or a payload is garbage
— not just by its steady-state hot path. This module supplies the *policy*
side of that story:

  * `ShedReason` — the enumerated vocabulary for every request that leaves
    the pipeline without completing. `runtime.shed` (recoverable-by-client
    rejections: SLO, overflow, malformed, preprocess error) and
    `runtime.dead` (the dead-letter queue: retries exhausted, poison) both
    carry one per rid, and every serve summary surfaces the
    counts.
  * `FaultEvent` / `FaultPlan` — a seeded, typed schedule of fault events
    (slice loss, slice flap, straggler stretch, DPU CU launch failure,
    malformed payload, mid-resize abort). A plan is pure data: the same
    plan replayed on the virtual clock produces bit-identical behaviour
    run to run, which is what lets CI gate a chaos soak.
  * `FaultInjector` — applies a plan's due events to a live
    `PipelinedRuntime` (and its `MultiSliceEngine` / `DpuService`). The
    virtual-clock path replays events at exact virtual times; the
    wall-clock path samples the same plan against elapsed wall time.
  * `replay_virtual` — the deterministic virtual-tick Poisson replay used
    by the chaos tests and chip_smoke.py's chaos phase: the clock
    advances by a fixed tick per iteration, so arrivals, fault events,
    watchdog rounds, probes, and retry backoffs all fire in the same order
    on every run.

Fault semantics (how each kind manifests, and which recovery mechanism is
expected to absorb it):

  slice_fail    an ANNOUNCED device loss: `fail_slice` fires immediately
                (in-flight work requeued under the retry budget), and the
                slice stays stalled for `duration` — the periodic probe
                re-admits it once healed.
  slice_flap    a SILENT hang: the slice simply stops advancing. Nothing
                is told; the health watchdog must detect the no-advance
                window, quarantine via `fail_slice`, probe, and re-admit
                after `duration`.
  straggler     a short stall, below the watchdog threshold: progress-
                gated hedging clones the victims onto a healthy twin and
                first-completion-wins absorbs it.
  dpu_fail      the next `param` batched CU launches raise: failed groups
                retry under the preprocess budget, repeated failures trip
                the breaker onto the synchronous CPU path, and a request
                that keeps killing launches dead-letters as poison.
  malformed     request index `target` of the trace gets a structurally
                invalid payload (applied by `FaultPlan.corrupt_payloads`
                BEFORE submission): the ingest front door must shed it
                with a typed reason instead of crashing a CU batch.
  resize_abort  a mid-trace elastic re-slice to `param` slices that is
                aborted immediately (re-sliced straight back): every
                in-flight request is requeued twice, exercising the
                bounded-total-retries accounting.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batching.buckets import Request
from repro_torch.serving import telemetry as tm

__all__ = [
    "ShedReason", "FaultEvent", "FaultPlan", "FaultInjector",
    "SLICE_FAIL", "SLICE_FLAP", "STRAGGLER", "DPU_FAIL", "MALFORMED",
    "RESIZE_ABORT", "FAULT_KINDS", "replay_virtual", "reason_counts",
]


class ShedReason(str, enum.Enum):
    """Why a request left the pipeline without completing. `shed` reasons
    are front-door / stage rejections a client may retry; `dead` reasons
    are terminal dead-letter verdicts the server itself gave up on."""

    SLO = "slo"                              # deadline already blown at the door
    OVERFLOW = "overflow"                    # bounded ingest full (backpressure)
    MALFORMED = "malformed"                  # structurally invalid raw payload
    PREPROCESS_ERROR = "preprocess_error"    # CU launch raised, no retry budget
    RETRIES_EXHAUSTED = "retries_exhausted"  # requeued past the per-rid budget
    POISON = "poison"                        # kept killing launches / CPU path


def reason_counts(reasons: Dict[int, Any]) -> Dict[str, int]:
    """Collapse a {rid -> reason} map into {reason value -> count}."""
    out: Dict[str, int] = {}
    for why in reasons.values():
        key = why.value if isinstance(why, ShedReason) else str(why)
        out[key] = out.get(key, 0) + 1
    return out


# --- fault kinds ----------------------------------------------------------

SLICE_FAIL = "slice_fail"
SLICE_FLAP = "slice_flap"
STRAGGLER = "straggler"
DPU_FAIL = "dpu_fail"
MALFORMED = "malformed"
RESIZE_ABORT = "resize_abort"
FAULT_KINDS = (SLICE_FAIL, SLICE_FLAP, STRAGGLER, DPU_FAIL, MALFORMED,
               RESIZE_ABORT)


@dataclass(frozen=True)
class FaultEvent:
    """One typed fault at virtual time `at` (seconds from trace start).

    target    slice id (slice faults) or trace request INDEX (malformed).
    duration  stall window for slice_fail / slice_flap / straggler: the
              fault heals (the probe can succeed) at `at + duration`.
    param     dpu_fail: number of launches to fail; resize_abort: the
              aborted target slice count.
    """

    at: float
    kind: str
    target: int = 0
    duration: float = 0.0
    param: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def to_json(self) -> Dict[str, Any]:
        return {"at": self.at, "kind": self.kind, "target": self.target,
                "duration": self.duration, "param": self.param}


@dataclass
class FaultPlan:
    """A seeded schedule of typed fault events, sorted by fire time. Pure
    data: replaying the same plan on the virtual clock is bit-identical
    run to run (the published chaos-soak plan lives in the bench and is
    recorded verbatim in the artifact)."""

    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: e.at)

    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "events": [e.to_json() for e in self.events]}

    @staticmethod
    def generate(seed: int, *, horizon_s: float, n_slices: int,
                 rates: Optional[Dict[str, float]] = None,
                 n_requests: int = 0) -> "FaultPlan":
        """Sample a plan from per-kind Poisson rates (events/second) over
        `horizon_s`. Deterministic in `seed`; slice targets cycle over the
        fleet and malformed targets over the trace indices, so any two
        runs of the same seed agree on every event field."""
        rates = dict(rates or {})
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for kind in FAULT_KINDS:  # fixed kind order keeps the draws stable
            rate = rates.get(kind, 0.0)
            if rate <= 0.0:
                continue
            t = float(rng.exponential(1.0 / rate))
            while t < horizon_s:
                if kind == MALFORMED:
                    target = int(rng.integers(0, max(1, n_requests)))
                else:
                    target = int(rng.integers(0, max(1, n_slices)))
                events.append(FaultEvent(
                    at=round(t, 6), kind=kind, target=target,
                    duration=round(float(rng.uniform(0.05, 0.3)), 6),
                    param=int(rng.integers(1, 4)),
                ))
                t += float(rng.exponential(1.0 / rate))
        return FaultPlan(events=events, seed=seed)

    # --- trace-level application (pre-submission) -------------------------
    def corrupt_payloads(self, reqs: Sequence[Request]) -> List[int]:
        """Apply the plan's MALFORMED events to a trace before submission:
        request index `target` gets a structurally invalid payload (wrong
        rank — the ingest validator must catch it; it would crash a CU
        batch mid-launch otherwise). Returns the corrupted rids."""
        bad: List[int] = []
        for ev in self.events:
            if ev.kind != MALFORMED or not (0 <= ev.target < len(reqs)):
                continue
            r = reqs[ev.target]
            r.payload = np.zeros((2, 2), np.float32)  # rank-2: never valid
            bad.append(r.rid)
        return bad


class FaultInjector:
    """Applies a `FaultPlan`'s due events to a live pipelined runtime.

    The runtime calls `step(rt, now)` once per pipeline iteration; events
    with `at <= now - t0` fire in plan order, and stall windows opened by
    slice faults heal (are removed from `stalled_slices`) when their
    expiry passes — after which the engine's periodic probe can succeed
    and re-admit the slice. Virtual clock: `now` is the replay's virtual
    time and the whole schedule is deterministic. Wall clock: `t0` is the
    serving start and the same plan is sampled against elapsed wall time.
    """

    def __init__(self, plan: FaultPlan, t0: float = 0.0):
        self.plan = plan
        self.t0 = t0
        self._i = 0
        # (heal time, slice id) stall windows still open
        self._expiries: List[Tuple[float, int]] = []
        self.log: List[Tuple[float, str, int]] = []  # (rel time, kind, target)

    def done(self) -> bool:
        return self._i >= len(self.plan.events) and not self._expiries

    def next_at(self) -> Optional[float]:
        """Absolute time of the next modeled fault transition (event fire
        or stall heal) — the virtual clock's idle-jump hint."""
        ts = []
        if self._i < len(self.plan.events):
            ts.append(self.t0 + self.plan.events[self._i].at)
        ts.extend(self.t0 + t for t, _ in self._expiries)
        return min(ts) if ts else None

    def step(self, rt, now: float) -> None:
        rel = now - self.t0
        ms = rt.engine if hasattr(rt.engine, "fail_slice") else None
        while self._expiries and self._expiries[0][0] <= rel:
            _, sid = self._expiries.pop(0)
            if ms is not None:
                ms.stalled_slices.discard(sid)
        while self._i < len(self.plan.events) \
                and self.plan.events[self._i].at <= rel:
            ev = self.plan.events[self._i]
            self._i += 1
            self._apply(rt, ms, ev, now)
            self.log.append((round(rel, 6), ev.kind, ev.target))
            # telemetry: every injected fault lands on the shared timeline
            # and in a per-kind counter — guarded getattrs keep the
            # injector usable against bare test doubles
            tracer = getattr(rt, "tracer", None)
            if tracer is not None:
                tracer.event(tm.FAULT, now, fault=ev.kind, target=ev.target)
            registry = getattr(rt, "registry", None)
            if registry is not None:
                registry.counter("faults_injected_total",
                                 labels={"kind": ev.kind}).inc()

    def _stall(self, ms, sid: int, ev: FaultEvent) -> None:
        ms.stalled_slices.add(sid)
        if ev.duration > 0:
            self._expiries.append((ev.at + ev.duration, sid))
            self._expiries.sort()

    def _apply(self, rt, ms, ev: FaultEvent, now: float) -> None:
        if ev.kind in (SLICE_FAIL, SLICE_FLAP, STRAGGLER):
            if ms is None or not ms.engines:
                return
            sid = sorted(ms.engines)[ev.target % len(ms.engines)]
            self._stall(ms, sid, ev)
            if ev.kind == SLICE_FAIL:
                # announced loss: no detection latency — evict immediately
                # (the stall window keeps the probe failing until healed)
                ms.fail_slice(sid, now)
        elif ev.kind == DPU_FAIL:
            if rt.service is not None:
                rt.service.inject_launch_failures(max(1, ev.param))
        elif ev.kind == RESIZE_ABORT:
            if ms is None:
                return
            keep = len(ms.engines)
            ms.resize(n_slices=max(1, ev.param), now=now)
            ms.resize(n_slices=keep, now=now)  # aborted: straight back
        # MALFORMED is trace-level (corrupt_payloads), nothing to do live


def replay_virtual(rt, reqs: Sequence[Request], plan: Optional[FaultPlan]
                   = None, *, tick: float = 2e-3,
                   max_idle_ticks: int = 200_000) -> List[Request]:
    """Deterministic virtual-clock Poisson replay: submit each request when
    its virtual arrival passes, fire due fault events, and advance the
    clock by a fixed `tick` per iteration — every decision (dispatch order,
    watchdog rounds, probes, retry backoffs, breaker transitions) is a pure
    function of the trace and the plan, so two runs are bit-identical.
    Returns the completed requests."""
    if plan is not None:
        rt.attach_faults(plan)
    inj = rt.injector
    i, now, idle = 0, 0.0, 0

    def pending() -> bool:
        # drive past the last request AND the last fault transition AND any
        # quarantine still probing — the soak must end with the fleet
        # healed, not merely drained. The quarantine map is read afresh:
        # a resize rebuilds it
        return (i < len(reqs) or rt.busy()
                or (inj is not None and not inj.done())
                or bool(getattr(rt.engine, "_quarantined", None)))

    while pending():
        while i < len(reqs) and reqs[i].arrival <= now:
            rt.submit(reqs[i], now=now)
            i += 1
        if rt.step(now):
            idle = 0
        else:
            idle += 1
            if idle > max_idle_ticks:
                raise RuntimeError(
                    "chaos replay wedged: no stage progressed for "
                    f"{max_idle_ticks} ticks (depths={rt.stage_summary()})"
                )
        now += tick
    return list(rt.completed)
