"""Stage-pipelined serving runtime: decoupled preprocessing over the
continuous-batching engine (PREBA's system shape, end to end).

    client ──► ingest ──► preprocess ──► admission ──► decode ──► emit
               (shed)     (DpuService)   (SlotScheduler  (ServingEngine)
                                          EDF backlog)

The paper's headline is that CPU-inline preprocessing starves the
inference slices: every submit stalls the decode loop for a full
preprocessing pass. This runtime removes that stall. Each stage owns a
bounded queue and a `step()` method; one cooperative event loop advances
every stage once per iteration, downstream first, so a decode segment never
waits on preprocessing (and vice versa — the DpuService hands finished
requests to admission through a double buffer it fills while admission
drains). On the card the service's worker issues its kernels on a stream of
its own, so preprocessing overlaps decode.

Queues and backpressure:

  ingest      bounded by RuntimeConfig.max_ingest; overflow is SHED at the
              front door (ShedReason.OVERFLOW), never dropped silently.
  preprocess  DpuService input queue (max_pending) + in-flight cap tied to
              the ready buffer: a stalled admission stage stops launches.
  ready       double-buffered preprocess-complete queue.
  admission   SlotScheduler EDF backlog bounded by max_backlog; admission
              pulls from the ready queue ONLY while it has headroom.
  decode      the engine's fixed slot pool (the hard resource).

Every request is either completed, still queued, or recorded in
`self.shed` with a typed reason — `slo` (its deadline cannot be met),
`overflow` (bounded ingest full), `malformed` (structurally invalid raw
payload, validated at the door), `preprocess_error` (its DPU launch raised)
— and `conservation_ok()` checks exactly that.

Clocks: `clock="virtual"` is deterministic (tests/replay drive `now`
explicitly; idle gaps jump to the next modeled event). `clock="wall"` is
real serving (launch/serve.py --pipelined).

Not ported yet (the JAX runtime has them): the multi-slice fleet, fault
injection with retry budgets and the dead-letter queue, the DPU breaker's
CPU fallback, and the partition controller.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Union

from repro_torch.core.batching.buckets import Request, next_pow2
from repro_torch.core.dpu.runtime import payload_error
from repro_torch.core.dpu.service import DpuService
from repro_torch.core.metrics import Histogram, MetricsRegistry
from repro_torch.device import DeviceLike
from repro_torch.serving import telemetry as tm
from repro_torch.serving.engine import ServingEngine, validate_requests
from repro_torch.serving.faults import ShedReason, reason_counts

_STAGES = ("ingest", "preprocess", "ready", "admission", "slots")


@dataclass(frozen=True)
class RuntimeConfig:
    max_ingest: int = 64            # front-door queue bound (overflow sheds)
    max_backlog: int = 64           # admission backlog bound
    slo_s: float = float("inf")     # front-door latency SLO (inf = no shed)
    clock: str = "virtual"          # virtual (tests/replay) | wall (serving)
    validate_payloads: bool = True  # structural front-door payload check


class PipelinedRuntime:
    """Cooperative five-stage pipeline over a continuous-batching engine and
    an optional DpuService."""

    def __init__(self, engine: ServingEngine, service: Optional[DpuService] = None,
                 rc: Optional[RuntimeConfig] = None):
        rc = RuntimeConfig() if rc is None else rc
        if rc.clock not in ("virtual", "wall"):
            raise ValueError(f"unknown clock mode {rc.clock!r}")
        if service is not None and service.cfg.clock != rc.clock:
            raise ValueError(
                f"clock mismatch: runtime={rc.clock} service={service.cfg.clock}")
        self.engine = engine
        self.service = service
        self.rc = rc
        self._ingest: Deque[Request] = deque()
        self.shed: List[Request] = []
        self.shed_reasons: Dict[int, ShedReason] = {}
        # one metrics root over engine + service, one shared tracer
        self.registry = MetricsRegistry("runtime")
        self.registry.attach(engine.registry)
        self.tracer = engine.tracer
        if service is not None:
            self.registry.attach(service.registry)
            service.tracer = self.tracer
        if rc.clock == "virtual":
            engine._virtual = True  # deterministic stamping on the replay clock
        self.registry.on_reset(self._reset_state)
        self.stats = self.registry.view("runtime", (
            "submitted", "accepted", "offered",
            "shed_slo", "shed_backpressure", "shed_error", "shed_malformed",
        ))
        self._depths: Dict[str, Histogram] = {
            k: self.registry.histogram("runtime_stage_depth", labels={"stage": k})
            for k in _STAGES
        }
        self._pre_busy = self.registry.histogram("runtime_dpu_busy")
        self._now = 0.0                 # virtual-clock high-water mark
        # EMA of the engine's per-dispatch execution times (admit/segment
        # calls) feeding the decode-backlog SLO estimate
        self.seg_ema: Optional[float] = None
        self._exec_seen = 0

    # --- clock --------------------------------------------------------------
    def _tick(self, now: Optional[float]) -> float:
        if self.rc.clock == "wall":
            return time.monotonic() if now is None else now
        if now is not None:
            self._now = max(self._now, now)
        return self._now

    def _shed(self, r: Request, reason: ShedReason, stat_key: str,
              now: Optional[float] = None) -> None:
        self.stats[stat_key] += 1
        self.shed.append(r)
        self.shed_reasons[r.rid] = reason
        self.tracer.event(tm.SHED, self._now if now is None else now,
                          rid=r.rid, tenant=getattr(r, "model", None),
                          reason=reason.value)

    def shed_counts(self) -> Dict[str, int]:
        """{reason -> count} over the shed list."""
        return reason_counts(self.shed_reasons)

    def conservation_ok(self) -> bool:
        """Nothing lost, nothing stuck: every submitted request is either
        completed or shed, and no queue still holds work."""
        accounted = len(self.completed) + len(self.shed)
        return not self.busy() and accounted == self.stats["submitted"]

    # --- front door (ingest + shedding) -------------------------------------
    def submit(self, reqs: Union[Request, List[Request]],
               now: Optional[float] = None) -> int:
        """Admit requests at the front door. Malformed requests raise before
        anything is enqueued; well-formed requests are either accepted into
        the bounded ingest queue or SHED — when the SLO is already blown,
        the raw payload is structurally invalid, or backpressure has filled
        ingest. Returns the number accepted."""
        if isinstance(reqs, Request):
            reqs = [reqs]
        now = self._tick(now)
        validate_requests(reqs, self.engine.ec, check_bucket=True)
        if self.service is None and any(r.payload is not None for r in reqs):
            raise ValueError(
                "raw payloads submitted to a runtime without a DpuService "
                "would silently skip preprocessing; attach a service or "
                "preprocess upstream")
        accepted = 0
        backlog_est: Optional[float] = None
        check = self.rc.validate_payloads and self.service is not None
        has_slo = self.rc.slo_s != float("inf")
        for r in reqs:
            self.stats["submitted"] += 1
            if check and r.payload is not None \
                    and payload_error(r.payload, self.service.cfg.dpu.modality) is not None:
                self._shed(r, ShedReason.MALFORMED, "shed_malformed", now)
                continue
            est = 0.0
            if has_slo:
                if backlog_est is None:
                    backlog_est = self.decode_backlog_s()
                est = backlog_est + self.request_service_s(r)
                if self.service is not None and r.payload is not None:
                    est += self.service.estimate_s(r.payload)
            if now + est > r.arrival + self.rc.slo_s:
                self._shed(r, ShedReason.SLO, "shed_slo", now)
            elif len(self._ingest) >= self.rc.max_ingest:
                self._shed(r, ShedReason.OVERFLOW, "shed_backpressure", now)
            else:
                self._ingest.append(r)
                self.stats["accepted"] += 1
                accepted += 1
                self.tracer.event(tm.INGEST, now, rid=r.rid,
                                  tenant=getattr(r, "model", None))
        return accepted

    # --- event loop ---------------------------------------------------------
    def busy(self) -> bool:
        return bool(self._ingest
                    or (self.service is not None and self.service.busy())
                    or self.engine.busy())

    def step(self, now: Optional[float] = None) -> bool:
        """One pipeline iteration, downstream stages first (each item moves
        at most one stage per tick; decode is never blocked behind this
        tick's preprocessing work). Returns True if anything moved."""
        now = self._tick(now)
        progressed = False

        # stages 4+5 — decode + emit: admit -> segment -> retire
        if self.engine.busy():
            progressed |= bool(self.engine.step(now))

        # stage 3 — admission pulls from the preprocess-complete queue,
        # bounded by the backlog (full slot pool => backlog stays full =>
        # nothing is pulled => the stall propagates upstream)
        space = self.rc.max_backlog - self.engine.admission_depth()
        if self.service is not None and space > 0:
            ready = self.service.poll(now, space)
            if ready:
                self.engine.offer(ready)
                space -= len(ready)
                self.stats["offered"] += len(ready)
                self.tracer.event(tm.OFFER, now, rids=[r.rid for r in ready])
                progressed = True

        # stage 2 — the DPU service drains same-shape groups into batched
        # launches and harvests completions; a group whose launch raised is
        # shed here (recorded, never lost)
        if self.service is not None:
            progressed |= self.service.step(now)
            failed = self.service.take_failed()
            for r in failed:
                self._shed(r, ShedReason.PREPROCESS_ERROR, "shed_error", now)
            progressed |= bool(failed)

        # stage 1 — ingest feeds the service (raw payloads) or admission
        # directly (already-tokenized requests), FIFO, stopping at the first
        # request the downstream stage cannot take
        direct: List[Request] = []
        while self._ingest:
            r = self._ingest[0]
            if r.payload is not None and self.service is not None:
                if not self.service.submit(r):
                    break
            else:
                if space <= 0:
                    break
                r.preprocessed_at = now
                direct.append(r)
                space -= 1
            self._ingest.popleft()
            progressed = True
        if direct:
            self.engine.offer(direct)
            self.stats["offered"] += len(direct)
            self.tracer.event(tm.OFFER, now, rids=[r.rid for r in direct])

        self._sample()
        return progressed

    def run_until_idle(self) -> List[Request]:
        """Drain the pipeline. Virtual clock: idle iterations jump to the
        next modeled event (service completion or batcher deadline). Wall
        clock: idle iterations nap briefly while the DPU worker runs."""
        stall = 0
        while self.busy():
            if self.step():
                stall = 0
                continue
            if self.rc.clock == "wall":
                time.sleep(0.0005)
                continue
            nxt = self._next_event()
            if nxt is not None and nxt > self._now:
                self._now = nxt
                stall = 0
            else:
                self._now += 1e-4
                stall += 1
                if stall > 10_000:
                    raise RuntimeError(
                        "pipeline stalled: no stage can make progress "
                        f"(depths={self.stage_summary()})")
        return list(self.completed)

    def close(self) -> None:
        if self.service is not None:
            self.service.close()

    @property
    def completed(self) -> List[Request]:
        return self.engine.completed

    # --- decode-backlog SLO model -------------------------------------------
    def decode_backlog_s(self) -> float:
        """Decode-side front-door wait estimate: requests ahead of a new
        arrival (admission depth plus slot occupancy), scaled by how long a
        resident request holds its slot (segments per decode budget x the
        measured per-dispatch EMA) over the pool's drain parallelism."""
        cap = self.engine.slot_capacity()
        if cap <= 0 or self.seg_ema is None:
            return 0.0
        waiting = self.engine.admission_depth() + self.engine.slots_in_use()
        if not waiting:
            return 0.0
        ec = self.engine.ec
        segs = max(1, -(-ec.max_new_tokens // max(1, ec.segment_len)))
        return self.seg_ema * segs * waiting / cap

    def request_service_s(self, r: Request) -> float:
        """Per-request decode-side service estimate, prompt-bucket aware:
        prefill dispatches for THIS request's padded prompt length (chunk
        calls when the engine chunks, one monolithic admit otherwise) plus
        its decode segments, scaled by the measured per-dispatch EMA. The
        prefill term is discounted by the expected prefix hit (the radix
        store is peeked for this exact prompt and the chunk calls a hit
        would skip are not charged). 0.0 until calibrated."""
        if self.seg_ema is None:
            return 0.0
        ec = self.engine.ec
        budget = (ec.max_new_tokens if r.max_new_tokens is None
                  else min(r.max_new_tokens, ec.max_new_tokens))
        segs = max(1, -(-budget // max(1, ec.segment_len)))
        chunks = 1
        if self._chunked():
            n = max(1, int(r.length))
            lp = max(ec.min_prompt_len, next_pow2(n))
            q = min(ec.chunk_lens)
            chunks = max(1, lp // q)
            if ec.prefix_cache_bytes:
                chunks = max(1, chunks - self.engine.prefix_peek_req(r) // q)
        return self.seg_ema * (chunks + segs)

    def _chunked(self) -> bool:
        """Whether the engine really chunks (family-gated)."""
        return bool(self.engine._chunk_lens)

    def _observe_exec(self) -> None:
        xs = self.engine.batch_exec_s
        if self._exec_seen > len(xs):  # engine metrics were reset
            self._exec_seen = 0
        for x in xs[self._exec_seen:]:
            self.seg_ema = x if self.seg_ema is None else 0.7 * self.seg_ema + 0.3 * x
        self._exec_seen = len(xs)

    # --- internals ----------------------------------------------------------
    def _next_event(self) -> Optional[float]:
        ts = []
        if self.service is not None:
            t = self.service.next_ready()
            if t is not None:
                ts.append(t)
        dl = self.engine.batcher.next_deadline()
        if dl is not None:
            ts.append(dl)
        return min(ts) if ts else None

    def _sample(self) -> None:
        self._observe_exec()
        self._depths["ingest"].observe(len(self._ingest))
        if self.service is not None:
            self._depths["preprocess"].observe(
                self.service.pending() + self.service.in_flight())
            self._depths["ready"].observe(self.service.ready())
            self._pre_busy.observe(int(self.service.executing() > 0))
        else:
            self._depths["preprocess"].observe(0)
            self._depths["ready"].observe(0)
            self._pre_busy.observe(0)
        self._depths["admission"].observe(self.engine.admission_depth())
        self._depths["slots"].observe(self.engine.slots_in_use())

    # --- telemetry ----------------------------------------------------------
    def stage_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-stage queue-depth stats over every step() sample."""
        return {
            k: {"mean": round(st.mean, 3), "max": int(st.vmax) if st.count else 0}
            for k, st in self._depths.items()
        }

    def stage_occupancy(self) -> Dict[str, float]:
        """Fraction-of-time-busy per resource stage: the DPU (service busy
        across step samples) and the KV slot pool (occupied fraction)."""
        cap = self.engine.slot_capacity()
        slots = self._depths["slots"]
        return {
            "preprocess": round(self._pre_busy.mean, 3),
            "slots": round(slots.mean / cap, 3) if cap else 0.0,
        }

    def _reset_state(self) -> None:
        """Registry reset hook: clear the records that pair with the zeroed
        counters and rewind the exec-time watermark."""
        self.shed = []
        self.shed_reasons = {}
        self._exec_seen = 0

    def reset_metrics(self) -> None:
        self.registry.reset()


def build_pipelined_runtime(cfg=None, *, seed: int = 0, ec=None,
                            service: Optional[DpuService] = None,
                            rc: Optional[RuntimeConfig] = None, params=None,
                            device: DeviceLike = "cuda") -> PipelinedRuntime:
    """One continuous-batching engine behind the pipelined stages, on
    `device`. The engine's own inline DPU pass is disabled — preprocessing
    belongs to the service stage here. `params`: weights to serve (e.g.
    from_reference); None draws seeded ones from `seed`."""
    from dataclasses import replace as dc_replace

    from repro_torch.serving.engine import EngineConfig, build_engine

    ec = EngineConfig() if ec is None else ec
    ec = dc_replace(ec, continuous=True, preprocess="none")
    engine = build_engine(cfg, seed=seed, ec=ec, device=device, params=params)
    return PipelinedRuntime(engine, service, rc)
