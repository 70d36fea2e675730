"""Online partition controller: the closed resize() loop.

PREBA's premise is that MIG reconfigurability is a performance LEVER; a
fleet that can `resize()` still needs something to decide when. This
module is the deciding layer: a controller that watches the signals
the runtime already emits (arrival rate and prompt-length mix at the
front door, slot occupancy, admission depth, shed/dead/hedge counters)
and drives `MultiSliceEngine.resize()` mid-trace — fine slices for bursty
small-request traffic, coarse slices for long-prompt / heavy-decode
mixes — the "reconfigurable machine scheduling problem" (arxiv
2109.11067) closed on the real engine.

Decision discipline, in order of precedence:

* DETERMINISTIC — a decision is a pure function of (trace, fault plan,
  ControllerConfig, knee profiles). The controller never reads wall time,
  random state, or the wall-measured execution EMAs (`_seg_ema` is
  measured even under the virtual clock); its inputs are arrival
  observations stamped with the replay clock and exact queue/slot counts.
  Two virtual-clock replays of the same seed therefore produce
  byte-identical decision logs — a CI gate, same contract as the trace
  timeline.
* COST-MODELED — candidate menu points are scored with the tenant knee
  profiles (`core/batching/knee.py`; measured on the card via `serve.py
  --calibrate-knee`, or the analytical roofline default): fleet service
  rate at V slices is V * b_V / lat(b_V) with b_V the per-slice batch the
  current demand would form (capped at the knee), and the latency proxy
  is the queueing waves the backlog needs at that batch. A switch charges
  its drain/rebuild cost — every in-flight request redoes its work, one
  knee-time each — against the predicted gain over `amortize_horizon_s`.
* HYSTERETIC — a reconfiguration only fires when the predicted gain
  clears `improve_frac`, the cooldown since the last switch has expired,
  and the run's `max_reconfigs` budget is not exhausted. The controller
  can therefore never thrash: the bench gates the total switch count.
* OBSERVABLE — every switch emits a typed `reconfig` span on the shared
  tracer and increments `fleet_reconfigs_total{from,to,reason}`; the
  full decision log exports deterministically via `decisions_json()`.

Per-tenant re-apportionment rides along: at each switch the controller
re-divides the new slice count between tenants by their windowed arrival
share (`rebalance_slices` largest-remainder, every tenant keeping >= 1),
writing the updated asks through the same `_build` path `plan_placement`
audits — a tenant that went quiet donates slices to the one taking the
burst.
"""
from __future__ import annotations

import json
import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.core.slicing.mig import rebalance_slices
from repro_torch.serving import telemetry as tm


@dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the online partition controller (all deterministic
    inputs; the defaults are tuned for the virtual-clock traces the bench
    and tests replay)."""

    menu: Tuple[int, ...] = (1, 2, 4)   # candidate slice counts (asc)
    eval_interval_s: float = 0.05       # signal-evaluation cadence
    window_s: float = 0.5               # arrival-rate / mix window
    cooldown_s: float = 0.4             # min gap between reconfigurations
    improve_frac: float = 0.15          # predicted gain must clear this
    amortize_horizon_s: float = 1.0     # gain horizon a switch must pay
    #                                     its drain/rebuild cost within
    max_reconfigs: int = 6              # hard per-run switch budget
    min_observations: int = 4           # arrivals needed before deciding
    slo_target_s: float = 0.05          # latency-proxy budget: a menu
    #                                     point whose modeled latency blows
    #                                     this is scored down however
    #                                     efficient its batches are


@dataclass(frozen=True)
class Decision:
    """One reconfiguration decision (the log entry CI byte-compares).
    Every field derives from deterministic inputs only."""

    t: float                            # virtual-clock decision time
    from_slices: int
    to_slices: int
    reason: str                         # burst_fine | heavy_coarse
    rate_qps: float                     # windowed arrival rate
    mean_len: float                     # windowed mean request length
    demand: int                         # in-flight + admission backlog
    gain_frac: float                    # predicted relative improvement
    cost_s: float                       # modeled drain/rebuild charge
    requeued: int                       # requests resize() carried over
    shed: int                           # shed counter at decision time
    dead: int                           # dead-letter counter at decision
    hedges: int                         # hedge counter at decision time
    apportion: Tuple[Tuple[str, int], ...] = ()  # per-tenant slice split

    def to_row(self) -> dict:
        d = {
            "t": round(self.t, 9),
            "from": self.from_slices,
            "to": self.to_slices,
            "reason": self.reason,
            "rate_qps": round(self.rate_qps, 6),
            "mean_len": round(self.mean_len, 6),
            "demand": self.demand,
            "gain_frac": round(self.gain_frac, 6),
            "cost_s": round(self.cost_s, 9),
            "requeued": self.requeued,
            "shed": self.shed,
            "dead": self.dead,
            "hedges": self.hedges,
        }
        if self.apportion:
            d["apportion"] = {k: v for k, v in self.apportion}
        return d


class PartitionController:
    """Closed-loop partition controller over one `MultiSliceEngine`.

    The `PipelinedRuntime` feeds it arrival observations at the front
    door (`observe`) and polls it once per `step()` (`maybe_reconfigure`);
    when a switch clears the hysteresis + cost model it calls
    `engine.resize(n_slices=target, now=now)` in place. `next_wakeup()`
    joins the runtime's virtual-clock idle-jump set so evaluation cadence
    survives idle gaps."""

    def __init__(self, cc: Optional[ControllerConfig] = None):
        self.cc = ControllerConfig() if cc is None else cc
        if list(self.cc.menu) != sorted(set(self.cc.menu)):
            raise ValueError(f"menu must be ascending/unique: {self.cc.menu}")
        self.decisions: List[Decision] = []
        self._arrivals: Deque[Tuple[float, float, Optional[str]]] = deque()
        self._next_eval = 0.0
        self._cooldown_until = 0.0
        self._rt = None                 # bound PipelinedRuntime
        self._counter_labels: Dict[Tuple[str, str, str], Any] = {}

    # --- wiring -----------------------------------------------------------
    def bind(self, runtime) -> None:
        """Attach to a PipelinedRuntime (done by its constructor). The
        engine must support resize() — i.e. be a MultiSliceEngine."""
        if not hasattr(runtime.engine, "resize"):
            raise ValueError(
                "PartitionController needs a resizable multi-slice engine"
            )
        n_tenants = len(getattr(runtime.engine, "_tenants", {})) or 1
        if all(v < n_tenants for v in self.cc.menu):
            raise ValueError(
                f"no menu point {self.cc.menu} can host {n_tenants} tenants"
            )
        self._rt = runtime

    def reset(self) -> None:
        """Warmup-boundary hook (the runtime's registry reset cascades
        here): clear the decision log and windowed observations so the
        measured replay starts from a cold controller, exactly like every
        other layer."""
        self.decisions.clear()
        self._arrivals.clear()
        self._next_eval = 0.0
        self._cooldown_until = 0.0

    # --- signals ----------------------------------------------------------
    def observe(self, req, now: float) -> None:
        """One front-door arrival (runtime.submit calls this for every
        well-formed request): the controller's arrival-rate and
        length-mix window. Deterministic — the replay clock stamps it."""
        self._arrivals.append(
            (now, float(req.length), getattr(req, "model", None))
        )
        self._trim(now)

    def _trim(self, now: float) -> None:
        horizon = now - self.cc.window_s
        while self._arrivals and self._arrivals[0][0] < horizon:
            self._arrivals.popleft()

    def _window(self, now: float) -> Tuple[float, float, Dict[str, int]]:
        """(rate_qps, mean_len, per-tenant arrival counts) over the
        window."""
        self._trim(now)
        n = len(self._arrivals)
        if n == 0:
            return 0.0, 0.0, {}
        rate = n / self.cc.window_s
        mean_len = sum(a[1] for a in self._arrivals) / n
        by_tenant: Dict[str, int] = {}
        for _, _, m in self._arrivals:
            if m is not None:
                by_tenant[m] = by_tenant.get(m, 0) + 1
        return rate, mean_len, by_tenant

    # --- cost model -------------------------------------------------------
    def _profile_for(self, mean_len: float):
        """Knee profile for the context bucket the windowed mix lands in
        (the default tenant's profiles; per-tenant scoring collapses to
        the dominant tenant's — the signal that matters is the knee's
        dependence on slice size, identical in shape across tenants)."""
        eng = self._rt.engine
        profiles = getattr(eng, "_knee_profiles", None) or {}
        if not profiles:
            return None
        bw = max(1, getattr(eng.ec, "bucket_width", 1))
        b = int(mean_len // bw)
        keys = sorted(profiles)
        b = min(max(b, keys[0]), keys[-1])
        while b not in profiles:
            b -= 1
        return profiles[b]

    @staticmethod
    def _lat_at(profile, batch: int) -> float:
        """Profile latency at `batch` (nearest measured point >= batch,
        falling back to the largest)."""
        for bs, lat in zip(profile.batch_sizes, profile.latencies):
            if bs >= batch:
                return lat
        return profile.latencies[-1]

    def _work_units(self, n: int, mean_len: float) -> float:
        """Modeled dispatch iterations one mean-mix request costs at `n`
        slices: chunked-prefill iterations for its prompt — DISCOUNTED by
        the expected prefix-store hit, which CONSOLIDATES as slices
        coarsen (one slice = one store = every template reuse lands; n
        stores spread the same traffic ~1/n) — plus its decode segments.
        This is where "coarse for long-prompt mixes" comes from: the
        prefill term only matters when prompts are long, and only
        shrinks with n when a prefix cache is on."""
        ec = self._rt.engine.ec
        segs = max(1, math.ceil(ec.max_new_tokens / max(1, ec.segment_len)))
        chunked = getattr(self._rt.engine, "_chunked", False)
        if chunked and ec.chunk_lens:
            chunks = max(1.0, mean_len / min(ec.chunk_lens))
        else:
            chunks = 1.0
        if ec.prefix_cache_bytes:
            chunks *= 1.0 - 1.0 / max(1, n)     # store-consolidation hit
        return chunks + segs

    def _predict(self, profile, n: int, demand: int,
                 mean_len: float) -> Tuple[float, float]:
        """(wall_service_rate, latency_proxy_s) at `n` slices for the
        current demand + mix.

        Per-slice resident batch is the demand split across slices,
        bounded by the slot pool; the FLEET rate is n concurrent slices,
        each serving its batch capped at the knee (batching past
        Batch_knee buys nothing but tail latency — the paper's §3.2
        observation) over the knee-curve latency of the batch actually
        formed, divided by the per-request work. Fine slices multiply
        the fleet's slot capacity — that is why they win a burst — while
        the per-request work term grows with n when a prefix cache is on
        (store fragmentation), which is how a coarse pool wins a
        long-prompt mix. The latency proxy is the queueing WAVES the
        backlog needs through the fleet's concurrent capacity, times the
        per-request work at the knee timescale."""
        ec = self._rt.engine.ec
        per_slice = max(1, math.ceil(demand / max(1, n)))
        b = min(per_slice, max(1, ec.max_slots))
        w = self._work_units(n, mean_len)
        n_busy = min(n, max(1, demand))     # idle slices serve nothing
        rate = n_busy * min(b, max(1, profile.batch_knee)) \
            / (w * self._lat_at(profile, b))
        waves = max(1.0, math.ceil(demand / max(1, n * b)))
        lproxy = waves * w * profile.time_knee
        return rate, lproxy

    def _score(self, rate: float, lproxy: float) -> float:
        """One deterministic scalar per menu point: wall service rate,
        discounted by how far the latency proxy overruns the SLO target.
        Under a burst the latency term dominates (fine wins); in a
        heavy/long mix within budget the rate term does (coarse wins)."""
        excess = max(0.0, lproxy / self.cc.slo_target_s - 1.0)
        return rate / (1.0 + excess)

    # --- the control loop -------------------------------------------------
    def next_wakeup(self) -> Optional[float]:
        """Next self-driven evaluation instant (virtual-clock idle jump)."""
        if self._rt is None or len(self.decisions) >= self.cc.max_reconfigs:
            return None
        return max(self._next_eval, self._cooldown_until)

    def maybe_reconfigure(self, now: float) -> Optional[Decision]:
        """One control-loop poll (the runtime calls this every step()).
        Returns the Decision when a reconfiguration fired, else None."""
        cc = self.cc
        if self._rt is None or now < self._next_eval:
            return None
        self._next_eval = now + cc.eval_interval_s
        if now < self._cooldown_until:
            return None
        if len(self.decisions) >= cc.max_reconfigs:
            return None
        eng = self._rt.engine
        rate, mean_len, by_tenant = self._window(now)
        if len(self._arrivals) < cc.min_observations:
            return None
        profile = self._profile_for(mean_len)
        if profile is None:
            return None
        cur = len(eng.pod.slices)
        inflight = len(getattr(eng, "_inflight", {}))
        demand = inflight + eng.admission_depth()
        if demand <= 0:
            return None
        n_tenants = len(getattr(eng, "_tenants", {})) or 1
        cur_score = self._score(*self._predict(profile, cur, demand, mean_len))
        best, best_gain = None, 0.0
        for n in cc.menu:
            if n == cur or n < n_tenants:
                continue
            n_score = self._score(*self._predict(profile, n, demand, mean_len))
            gain = n_score / max(cur_score, 1e-12) - 1.0
            if gain > best_gain:
                best, best_gain = n, gain
        if best is None or best_gain < cc.improve_frac:
            return None
        # reconfiguration cost: every in-flight request redoes its work —
        # time_knee/batch_knee amortized seconds each; the predicted
        # relative gain over the horizon must pay for it
        cost_s = inflight * profile.time_knee / max(1, profile.batch_knee)
        gain_s = best_gain * cc.amortize_horizon_s
        if cost_s >= gain_s:
            return None
        reason = "burst_fine" if best > cur else "heavy_coarse"
        apportion: Tuple[Tuple[str, int], ...] = ()
        if n_tenants > 1:
            apportion = self._apportion(eng, best, by_tenant)
        requeued = eng.resize(n_slices=best, now=now)
        self._cooldown_until = now + cc.cooldown_s
        dec = Decision(
            t=now, from_slices=cur, to_slices=best, reason=reason,
            rate_qps=rate, mean_len=mean_len, demand=demand,
            gain_frac=best_gain, cost_s=cost_s, requeued=requeued,
            shed=int(self._rt.stats["shed_slo"]
                     + self._rt.stats["shed_backpressure"]
                     + self._rt.stats["shed_error"]
                     + self._rt.stats["shed_malformed"]),
            dead=int(self._rt.stats["dead"]),
            hedges=int(eng.hedges),
            apportion=apportion,
        )
        self.decisions.append(dec)
        self._observe_switch(dec, now)
        return dec

    def _apportion(self, eng, n_slices: int,
                   by_tenant: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
        """Re-divide `n_slices` between tenants by windowed arrival share
        (largest remainder, >= 1 each; a tenant with no window traffic
        still keeps its floor slice). Writes the asks the next _build
        reads — the same path the static configuration used."""
        asks = {
            name: max(1, by_tenant.get(name, 0))
            for name in eng._tenants
        }
        counts = rebalance_slices(n_slices, asks)
        for name, t in eng._tenants.items():
            t.n_slices_ask = counts[name]
        return tuple(sorted(counts.items()))

    # --- observability ----------------------------------------------------
    def _observe_switch(self, dec: Decision, now: float) -> None:
        rt = self._rt
        labels = {"from": str(dec.from_slices), "to": str(dec.to_slices),
                  "reason": dec.reason}
        key = (labels["from"], labels["to"], labels["reason"])
        c = self._counter_labels.get(key)
        if c is None:
            c = rt.registry.counter("fleet_reconfigs_total", labels=labels)
            self._counter_labels[key] = c
        c.inc()
        rt.tracer.event(
            tm.RECONFIG, now, reason=dec.reason,
            from_slices=dec.from_slices, to_slices=dec.to_slices,
            requeued=dec.requeued, demand=dec.demand,
            gain_frac=round(dec.gain_frac, 6),
        )

    def decisions_json(self) -> str:
        """Deterministic decision-log export (sorted keys, fixed
        separators) — two virtual-clock replays of the same seed must
        produce byte-identical strings (a CI gate)."""
        return json.dumps([d.to_row() for d in self.decisions],
                          sort_keys=True, separators=(",", ":"))
