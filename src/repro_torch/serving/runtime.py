"""Stage-pipelined serving runtime: decoupled preprocessing over the real
engines (PREBA's system shape, end to end).

    client ──► ingest ──► preprocess ──► admission ──► decode ──► emit
               (shed)     (DpuService)   (SlotScheduler  (ServingEngine, or
                                          EDF backlog)    the per-slice
                                                          engines of a
                                                          MultiSliceEngine)

The paper's headline is that CPU-inline preprocessing starves the
inference slices: every submit stalls the decode loop for a full
preprocessing pass. This runtime removes that stall. Each stage owns a
bounded queue and a `step()` method; one cooperative event loop advances
every stage once per iteration, downstream first, so a decode segment never
waits on preprocessing (and vice versa — the DpuService hands finished
requests to admission through a double buffer it fills while admission
drains). On the card the service's worker issues its kernels on a stream of
its own, and each fleet slice issues its work on its own stream.

Queues and backpressure:

  ingest      bounded by RuntimeConfig.max_ingest; overflow is SHED at the
              front door (ShedReason.OVERFLOW), never dropped silently.
  preprocess  DpuService input queue (max_pending) + in-flight cap tied to
              the ready buffer: a stalled admission stage stops launches.
  ready       double-buffered preprocess-complete queue.
  admission   SlotScheduler EDF backlog bounded by max_backlog; admission
              pulls from the ready queue ONLY while it has headroom.
  decode      the engines' fixed slot pools (the hard resource).

Every request is either completed, still queued, recorded in `self.shed`,
or dead-lettered in `self.dead` — `conservation_ok()` checks exactly that.

Failure semantics (every exit is typed with a ShedReason):

  shed   front-door / stage rejections a client may retry elsewhere:
         `slo` (deadline already blown), `overflow` (bounded ingest full),
         `malformed` (structurally invalid raw payload, validated at the
         door), `preprocess_error` (a launch raised and no retry budget is
         configured).
  dead   the DEAD-LETTER queue, terminal server-side verdicts:
         `retries_exhausted` (requeued by slice failure/flap/resize past
         the per-rid budget in SliceScheduler) and `poison` (kept killing
         preprocessing launches past `preprocess_retries`, or failed the
         degraded CPU path too).
  breaker  when DpuService launches fail repeatedly (`breaker_threshold`
         consecutive failed groups; 0 = off), the runtime trips a circuit
         breaker and routes payload requests through the SYNCHRONOUS numpy
         CPU preprocessing path — a counted, visible state
         (`stats["breaker_trips"]`, `stats["cpu_fallback"]`), slower, not
         dead; payloads never influence decode tokens. After
         `breaker_probe_s` one probe request is offered to the service,
         and a success closes the breaker.

The fault-injection harness (serving/faults.py) drives all of this
deterministically on the virtual clock; `attach_faults(plan)` arms a
FaultPlan whose events fire inside step().

SLO-aware shedding: with an SLO set (RuntimeConfig.slo_s, or a tenant's
SLO class), a request whose modeled completion already overruns
`arrival + slo` is shed at the door. The estimate folds in the DPU cost
model, a decode-backlog term and the request's own prompt-bucket- and
prefix-aware service time (`request_service_s`), per tenant.

Clocks: `clock="virtual"` is deterministic (tests/replay drive `now`
explicitly; idle gaps jump to the next modeled event). `clock="wall"` is
real serving (launch/serve.py --pipelined).

Partition control: an optional `PartitionController`
(core/control/partition.py) observes every front-door arrival, is polled
once per step(), and calls the fleet's resize() mid-trace when its
hysteresis and knee cost model clear — the closed reconfiguration loop.
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
from repro_torch.serving.faults import FaultInjector, FaultPlan, ShedReason, reason_counts
from repro_torch.serving.multislice import MultiSliceEngine

Engine = Union[ServingEngine, MultiSliceEngine]

_STAGES = ("ingest", "preprocess", "ready", "admission", "slots")


@dataclass(frozen=True)
class RuntimeConfig:
    max_ingest: int = 64            # front-door queue bound (overflow sheds)
    max_backlog: int = 64           # admission backlog bound
    slo_s: float = float("inf")     # front-door latency SLO (inf = no shed)
    clock: str = "virtual"          # virtual (tests/replay) | wall (serving)
    validate_payloads: bool = True  # structural front-door payload check
    preprocess_retries: int = 0     # failed-launch retries per rid before
    #                                 dead-lettering as poison (0: shed on
    #                                 the first failure)
    breaker_threshold: int = 0      # consecutive failed launches that trip
    #                                 the CPU-fallback breaker (0 = off)
    breaker_probe_s: float = 0.25   # open-breaker probe interval


class PipelinedRuntime:
    """Cooperative five-stage pipeline over a continuous-batching engine
    (single- or multi-slice) and an optional DpuService."""

    def __init__(self, engine: Engine, service: Optional[DpuService] = None,
                 rc: Optional[RuntimeConfig] = None, controller=None):
        rc = RuntimeConfig() if rc is None else rc
        if rc.clock not in ("virtual", "wall"):
            raise ValueError(f"unknown clock mode {rc.clock!r}")
        if isinstance(engine, ServingEngine) and not engine.ec.continuous:
            raise ValueError("pipelined runtime requires continuous=True")
        if service is not None and service.cfg.clock != rc.clock:
            raise ValueError(
                f"clock mismatch: runtime={rc.clock} service={service.cfg.clock}")
        self.engine = engine
        self.service = service
        self.rc = rc
        self._ingest: Deque[Request] = deque()
        self.shed: List[Request] = []
        # dead-letter queue: terminal server-side verdicts (typed reasons in
        # dead_reasons). Conservation: once idle, completed + shed + dead ==
        # submitted.
        self.dead: List[Request] = []
        self.shed_reasons: Dict[int, ShedReason] = {}
        self.dead_reasons: Dict[int, ShedReason] = {}
        # one metrics root over engine(s) + service, one shared tracer
        self.registry = MetricsRegistry("runtime")
        self.registry.attach(engine.registry)
        self.tracer = getattr(engine, "tracer", None) or tm.Tracer()
        engine.tracer = self.tracer
        if service is not None:
            self.registry.attach(service.registry)
            service.tracer = self.tracer
        if rc.clock == "virtual":
            # deterministic stamping on the replay clock
            svc = getattr(engine, "set_virtual_clock", None)
            if svc is not None:
                svc(True)
            else:
                engine._virtual = True
        self.registry.on_reset(self._reset_state)
        self.stats = self.registry.view("runtime", (
            "submitted", "accepted", "offered",
            "shed_slo", "shed_backpressure", "shed_error", "shed_malformed",
            "dead", "breaker_trips", "cpu_fallback", "pp_retries",
        ))
        # preprocess retry accounting + DPU circuit breaker state
        self._pp_retries: Dict[int, int] = {}
        self._brk_consec = 0            # consecutive failed launches
        self._brk_open = False
        self._brk_probing = False       # one probe in flight to the service
        self._brk_retry_at = 0.0
        self._proc_mark = 0             # service processed-counter watermark
        self._cpu_dpu = None            # lazily-built synchronous CPU DPU
        self.injector: Optional[FaultInjector] = None
        self._depths: Dict[str, Histogram] = {
            k: self.registry.histogram("runtime_stage_depth", labels={"stage": k})
            for k in _STAGES
        }
        self._pre_busy = self.registry.histogram("runtime_dpu_busy")
        # optional online partition controller: observes front-door
        # arrivals and is polled once per step(); when its hysteresis and
        # cost model clear, it drives engine.resize() mid-trace
        self.controller = controller
        if controller is not None:
            controller.bind(self)
        self._now = 0.0                 # virtual-clock high-water mark
        # EMA of the engine's per-dispatch execution times (admit/chunk/
        # segment calls) feeding the decode-backlog SLO estimate; the
        # multi-slice engine maintains its own, a single engine is observed
        # here from batch_exec_s
        self.seg_ema: Optional[float] = None
        self._exec_seen = 0

    # --- clock --------------------------------------------------------------
    def _tick(self, now: Optional[float]) -> float:
        if self.rc.clock == "wall":
            return time.monotonic() if now is None else now
        if now is not None:
            self._now = max(self._now, now)
        return self._now

    # --- typed shed / dead-letter bookkeeping -------------------------------
    def _shed(self, r: Request, reason: ShedReason, stat_key: str,
              now: Optional[float] = None) -> None:
        self.stats[stat_key] += 1
        self.shed.append(r)
        self.shed_reasons[r.rid] = reason
        self.tracer.event(tm.SHED, self._now if now is None else now,
                          rid=r.rid, tenant=getattr(r, "model", None),
                          reason=reason.value)

    def _dead_letter(self, r: Request, reason: ShedReason,
                     now: Optional[float] = None, trace: bool = True) -> None:
        self.dead.append(r)
        self.dead_reasons[r.rid] = reason
        self.stats["dead"] += 1
        self._pp_retries.pop(r.rid, None)
        if trace:  # the fleet already stamps drained slice dead-letters
            self.tracer.event(tm.DEAD_LETTER, self._now if now is None else now,
                              rid=r.rid, tenant=getattr(r, "model", None),
                              reason=reason.value)

    def shed_counts(self) -> Dict[str, int]:
        """{reason -> count} over the shed list."""
        return reason_counts(self.shed_reasons)

    def dead_counts(self) -> Dict[str, int]:
        """{reason -> count} over the dead-letter queue."""
        return reason_counts(self.dead_reasons)

    def conservation_ok(self) -> bool:
        """Nothing lost, nothing stuck: every submitted request is either
        completed, shed, or dead-lettered, and no queue still holds work."""
        accounted = len(self.completed) + len(self.shed) + len(self.dead)
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
        # model router first (multi-tenant fleets stamp/validate
        # Request.model at the front door), then validate each request
        # against ITS tenant's EngineConfig
        route = getattr(self.engine, "route", None)
        if route is not None:
            route(reqs)
        ec_for = getattr(self.engine, "ec_for_model", None)
        if ec_for is None:
            validate_requests(reqs, self.engine.ec, check_bucket=True)
        else:
            by_model: Dict[Optional[str], List[Request]] = {}
            for r in reqs:
                by_model.setdefault(getattr(r, "model", None), []).append(r)
            for m, group in by_model.items():
                validate_requests(group, ec_for(m), check_bucket=True)
        if self.service is None and any(r.payload is not None for r in reqs):
            raise ValueError(
                "raw payloads submitted to a runtime without a DpuService "
                "would silently skip preprocessing; attach a service or "
                "preprocess upstream")
        accepted = 0
        slo_for = getattr(self.engine, "slo_for_model", None)
        backlog_est: Optional[float] = None  # computed once, only if needed
        check = self.rc.validate_payloads and self.service is not None
        modality = self.service.cfg.dpu.modality if check else "audio"
        for r in reqs:
            self.stats["submitted"] += 1
            if self.controller is not None:
                # the controller windows OFFERED load (shed included): a
                # shed storm is exactly the signal that the current
                # partitioning is wrong for the traffic
                self.controller.observe(r, now)
            if check and r.payload is not None \
                    and payload_error(r.payload, modality) is not None:
                self._shed(r, ShedReason.MALFORMED, "shed_malformed", now)
                continue
            # effective SLO = the tighter of the runtime-wide knob and the
            # request's tenant SLO class (multi-tenant fleets)
            slo = self.rc.slo_s
            if slo_for is not None:
                slo = min(slo, slo_for(getattr(r, "model", None)))
            est = 0.0
            if slo != float("inf"):
                if backlog_est is None:
                    backlog_est = self.decode_backlog_s()
                est = backlog_est + self.request_service_s(r)
                if self.service is not None and r.payload is not None:
                    est += self.service.estimate_s(r.payload)
            if now + est > r.arrival + slo:
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

        # fault harness — due FaultPlan events fire before the stages see
        # this tick (deterministic on the virtual clock)
        if self.injector is not None:
            self.injector.step(self, now)

        # partition-control poll — a firing decision calls engine.resize()
        # BEFORE this tick's decode step, so the drained backlog requeues
        # and redispatches onto the new slice layout within the same tick
        if self.controller is not None:
            if self.controller.maybe_reconfigure(now) is not None:
                progressed = True

        # stages 4+5 — decode + emit: the engine's own admit -> segment ->
        # retire iteration. A drained multi-slice engine still steps while
        # slices sit in quarantine — the probe/readmit loop must finish
        # even after the last request
        if self.engine.busy() or getattr(self.engine, "_quarantined", None):
            progressed |= bool(self.engine.step(now))

        # a multi-slice engine dead-letters requests that exhausted their
        # retry budget; drain them into the runtime's queue so conservation
        # has a single ledger
        eng_dead = getattr(self.engine, "dead", None)
        if eng_dead:
            reasons = getattr(self.engine, "dead_reasons", {})
            for r in eng_dead:
                self._dead_letter(
                    r, reasons.pop(r.rid, ShedReason.RETRIES_EXHAUSTED),
                    now, trace=False)
            eng_dead.clear()
            progressed = True

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
        # handled HERE (recorded, never lost): with no retry budget it is
        # shed, with one it re-enters ingest (routed to the CPU path once
        # the breaker is open) until the budget runs out and the request
        # dead-letters as poison
        if self.service is not None:
            progressed |= self.service.step(now)
            proc = self.service.stats["processed"]
            if proc > self._proc_mark:
                self._brk_consec = 0
                if self._brk_probing or self._brk_open:
                    # a launch went through: the DPU is back — close
                    self._brk_open = False
                    self._brk_probing = False
                    self.tracer.event(tm.BREAKER_CLOSE, now)
            self._proc_mark = proc
            failed = self.service.take_failed()
            if failed:
                self._brk_consec += 1
                if self._brk_probing:
                    # the probe died: re-open, try again after the interval
                    self._brk_probing = False
                    self._brk_retry_at = now + self.rc.breaker_probe_s
                if self.rc.breaker_threshold and not self._brk_open \
                        and self._brk_consec >= self.rc.breaker_threshold:
                    self._brk_open = True
                    self._brk_retry_at = now + self.rc.breaker_probe_s
                    self.stats["breaker_trips"] += 1
                    self.tracer.event(tm.BREAKER_TRIP, now,
                                      consec=self._brk_consec)
                for r in failed:
                    n = self._pp_retries.get(r.rid, 0) + 1
                    self._pp_retries[r.rid] = n
                    if n > self.rc.preprocess_retries:
                        if self.rc.preprocess_retries > 0:
                            # kept killing launches: poison verdict
                            self._dead_letter(r, ShedReason.POISON, now)
                        else:
                            self._shed(r, ShedReason.PREPROCESS_ERROR,
                                       "shed_error", now)
                    else:
                        self.stats["pp_retries"] += 1
                        self._ingest.appendleft(r)  # retry at queue head
                progressed = True

        # stage 1 — ingest feeds the service (raw payloads) or admission
        # directly (already-tokenized requests), FIFO, stopping at the first
        # request the downstream stage cannot take. With the breaker open,
        # payload requests degrade to the synchronous CPU preprocessing
        # path except for a single probe offered to the service every
        # breaker_probe_s.
        direct: List[Request] = []
        while self._ingest:
            r = self._ingest[0]
            if r.payload is not None and self.service is not None:
                if self._brk_open:
                    if now >= self._brk_retry_at and not self._brk_probing:
                        if not self.service.submit(r):
                            break
                        self._brk_probing = True
                    else:
                        if space <= 0:
                            break
                        self._ingest.popleft()
                        if self._cpu_preprocess(r, now):
                            direct.append(r)
                            space -= 1
                        progressed = True
                        continue
                elif not self.service.submit(r):
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

    def _cpu_preprocess(self, r: Request, now: float) -> bool:
        """Degraded-mode synchronous CPU preprocessing (breaker open): the
        same functional pipeline, inline, on the package's numpy backend.
        Returns True when the request is ready for admission; a payload
        that fails even here is dead-lettered as poison (False). Tokens are
        unaffected — payloads never influence decode tokens."""
        try:
            if self._cpu_dpu is None:
                from dataclasses import replace as dc_replace

                from repro_torch.core.dpu.runtime import DPU

                self._cpu_dpu = DPU(dc_replace(self.service.cfg.dpu, backend="cpu"),
                                    device="cpu")
            r.payload = self._cpu_dpu.process(r.payload)
        except Exception:  # any failure of the fallback path is a verdict
            self._dead_letter(r, ShedReason.POISON, now)
            return False
        r.preprocessed_at = now
        self.stats["cpu_fallback"] += 1
        self.tracer.event(tm.CPU_FALLBACK, now, rid=r.rid)
        return True

    def run_until_idle(self) -> List[Request]:
        """Drain the pipeline. Virtual clock: idle iterations jump to the
        next modeled event (service completion, batcher deadline, probe,
        backoff, breaker probe or fault). Wall clock: idle iterations nap
        briefly while the DPU worker runs."""
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

    # --- emit side ----------------------------------------------------------
    @property
    def completed(self) -> List[Request]:
        return self.engine.completed

    @property
    def batcher(self):
        """The engine's batcher (replay deadline compatibility); idle on
        the pipelined path — admission bypasses it via offer()."""
        return self.engine.batcher

    # --- decode-backlog SLO model -------------------------------------------
    def decode_backlog_s(self) -> float:
        """Decode-side front-door wait estimate: requests ahead of a new
        arrival (admission depth plus slot occupancy), scaled by how long a
        resident request holds its slot (segments per decode budget x the
        measured per-dispatch EMA) over the pools' drain parallelism."""
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
        prefill term is discounted by the expected prefix hit. In a
        multi-tenant fleet the whole estimate is the TENANT'S: its
        EngineConfig, its family's chunking truth and its own execution
        EMA (the fleet EMA until the tenant has samples). 0.0 until
        calibrated."""
        if self.seg_ema is None:
            return 0.0
        m = getattr(r, "model", None)
        ec_for = getattr(self.engine, "ec_for_model", None)
        ec = self.engine.ec if ec_for is None else ec_for(m)
        ema = self.seg_ema
        t_ema = getattr(self.engine, "_tenant_ema", None)
        if t_ema and m is not None and m in t_ema:
            ema = t_ema[m]
        budget = (ec.max_new_tokens if r.max_new_tokens is None
                  else min(r.max_new_tokens, ec.max_new_tokens))
        segs = max(1, -(-budget // max(1, ec.segment_len)))
        n = max(1, int(r.length))
        lp = max(ec.min_prompt_len, next_pow2(n))
        chunk_for = getattr(self.engine, "chunked_for_model", None)
        chunked = self._chunked() if chunk_for is None else chunk_for(m)
        chunks = 1
        if chunked:
            q = min(ec.chunk_lens)
            chunks = max(1, lp // q)
            if ec.prefix_cache_bytes:
                chunks = max(1, chunks - self.engine.prefix_peek_req(r) // q)
        return ema * (chunks + segs)

    def _chunked(self) -> bool:
        """Whether the underlying engines really chunk (family-gated)."""
        if isinstance(self.engine, MultiSliceEngine):
            return self.engine._chunked
        return bool(self.engine._chunk_lens)

    def _observe_exec(self) -> None:
        """Fold fresh engine execution timings into `seg_ema` (a multi-slice
        engine maintains its own EMA; a single engine is observed from
        batch_exec_s)."""
        if isinstance(self.engine, MultiSliceEngine):
            if self.engine._seg_ema is not None:
                self.seg_ema = self.engine._seg_ema
            return
        xs = self.engine.batch_exec_s
        if self._exec_seen > len(xs):  # engine metrics were reset
            self._exec_seen = 0
        for x in xs[self._exec_seen:]:
            self.seg_ema = x if self.seg_ema is None else 0.7 * self.seg_ema + 0.3 * x
        self._exec_seen = len(xs)

    # --- fault harness ------------------------------------------------------
    def attach_faults(self, plan: FaultPlan, t0: float = 0.0) -> FaultInjector:
        """Arm a FaultPlan: its events fire inside step() as the clock
        passes them (virtual: exact replay; wall: sampled against elapsed
        time from `t0`)."""
        self.injector = FaultInjector(plan, t0=t0)
        return self.injector

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
        # self-driven future transitions: quarantine probes / retry backoffs
        # (multi-slice), the breaker's next service probe, and pending
        # fault-plan events — without these the virtual clock would grind
        # through stall ticks waiting for a recovery that is only time-gated
        nw = getattr(self.engine, "next_wakeup", None)
        if nw is not None:
            t = nw()
            if t is not None:
                ts.append(t)
        if self._brk_open and not self._brk_probing:
            ts.append(self._brk_retry_at)
        if self.injector is not None:
            t = self.injector.next_at()
            if t is not None:
                ts.append(t)
        if self.controller is not None:
            t = self.controller.next_wakeup()
            if t is not None and t > self._now:
                ts.append(t)
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
        across step samples) and the KV slot pools (occupied fraction)."""
        cap = self.engine.slot_capacity()
        slots = self._depths["slots"]
        return {
            "preprocess": round(self._pre_busy.mean, 3),
            "slots": round(slots.mean / cap, 3) if cap else 0.0,
        }

    def _reset_state(self) -> None:
        """Registry reset hook: clear the records that pair with the zeroed
        counters and rewind the watermarks over child counters that just
        reset. Breaker open/probing state is deliberately KEPT (a reset
        must not silently close an open breaker); only its counters
        restart."""
        self.shed = []
        self.dead = []
        self.shed_reasons = {}
        self.dead_reasons = {}
        self._pp_retries = {}
        self._brk_consec = 0
        self._proc_mark = 0
        self._exec_seen = 0
        if self.controller is not None:
            self.controller.reset()

    def reset_metrics(self) -> None:
        """One registry-wide reset (warmup boundary): every counter and
        histogram of every layer zeroes together with the shed/dead records
        and the trace stream."""
        self.registry.reset()


def build_pipelined_runtime(
    cfg=None, *, n_slices: int = 1, seed: int = 0, ec=None,
    service: Optional[DpuService] = None, rc: Optional[RuntimeConfig] = None,
    params=None, hedge_factor: float = 3.0,
    max_retries: int = 3, retry_backoff_s: float = 0.0,
    watchdog_rounds: int = 0, probe_interval_s: float = 0.0,
    tenants=None, controller=None, knee_profiles=None,
    device: DeviceLike = "cuda", devices=None,
) -> PipelinedRuntime:
    """One continuous-batching engine (or a multi-slice fleet) behind the
    pipelined stages, on `device`. The engine's own inline DPU pass is
    disabled — preprocessing belongs to the service stage here. `params`:
    weights to serve (a tree, e.g. from_reference, or an LM); None
    draws seeded ones from `seed`. The failure-semantics knobs (retry
    budget, watchdog, probe/readmit) apply to the fleet; single-engine
    runtimes have no slice to lose. Pass `tenants=[TenantSpec(...), ...]`
    (serving/multislice.py) instead of `cfg` for a multi-tenant fleet —
    per-tenant EngineConfig overrides are normalized the same way the
    fleet default is (continuous, no inline preprocessing). A `controller`
    (core/control/partition.py) is bound to the runtime; it needs a
    resizable fleet, so one is built even at n_slices=1. `devices`: the
    cards the fleet's slices serve on (`build_multislice_engine`; a fleet
    is built even at n_slices=1); by default the one of `device`."""
    from dataclasses import replace as dc_replace

    from repro_torch.models.api import LM
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.multislice import build_multislice_engine

    ec = EngineConfig() if ec is None else ec
    ec = dc_replace(ec, continuous=True, preprocess="none")
    fleet = dict(n_slices=n_slices, seed=seed, ec=ec, hedge_factor=hedge_factor,
                 max_retries=max_retries, retry_backoff_s=retry_backoff_s,
                 watchdog_rounds=watchdog_rounds, probe_interval_s=probe_interval_s,
                 knee_profiles=knee_profiles, device=device, devices=devices)
    if tenants is not None:
        tenants = [
            t if t.ec is None
            else dc_replace(t, ec=dc_replace(t.ec, continuous=True, preprocess="none"))
            for t in tenants
        ]
        engine: Engine = build_multislice_engine(tenants=tenants, **fleet)
    elif n_slices > 1 or controller is not None or devices is not None:
        # a partition controller needs a resizable fleet even when the
        # starting menu point is a single coarse slice
        engine = build_multislice_engine(cfg, params=params, **fleet)
    else:
        if isinstance(params, LM):
            params = params.tree()
        engine = build_engine(cfg, seed=seed, ec=ec, device=device, params=params)
    return PipelinedRuntime(engine, service, rc, controller=controller)
