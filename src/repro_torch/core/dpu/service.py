"""Decoupled DPU preprocessing service — stage 2 of the pipelined runtime.

PREBA's first proposition is a dedicated preprocessing accelerator that runs
*concurrently* with inference: the model decodes while the DPU chews
through the next requests' raw inputs. `DpuService` is that accelerator's
service wrapper for the serving runtime (serving/runtime.py):

* ONE CU pool (`DPU`) shared by the engine — the paper's DPU is a
  board-level resource, not a per-slice one;
* a bounded input queue of raw requests; `step()` drains it into same-shape
  same-tenant groups (grouping key: `(Request.model, runtime.group_key)`)
  and launches each group as one batched pass — with the `dpu` backend the
  whole audio front-end runs as one launch per kernel for the group
  (`kernels.ops.audio_pipeline_batch`), and the features come back to the
  host with one copy per group;
* a bounded double-buffered ready queue toward admission: the service fills
  the back buffer while admission drains the front, so neither side ever
  iterates a buffer the other is mutating.

Two clock modes (DpuServiceConfig.clock):

* ``virtual`` — deterministic, for tests/simulation: a launched group's
  outputs are computed synchronously but its *completion time* comes from
  the CU pool's analytic cost model (`DPU.submit`), and `poll(now)` releases
  requests only once the modeled completion has passed.
* ``wall`` — real overlap for serving: a single background worker (the DPU
  device analogue) runs the launches off the event loop, on a CUDA stream of
  its own, so preprocessing overlaps the decode kernels the event loop
  issues on the default stream. The kernel calls release the GIL. The worker
  touches only the internal work/done lists (mutex held for O(1) hand-offs;
  kernels run outside the lock) — the double buffer and every queue bound
  stay main-thread-only.

Backpressure: `submit()` returns False when the input queue is full, and
`step()` stops launching once in-flight + ready work reaches the ready
capacity, so a stalled admission stage propagates back to ingest instead of
growing unbounded queues.
"""
from __future__ import annotations

import contextlib
import heapq
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batching.buckets import Request, next_pow2
from repro_torch.core.dpu.pipeline import shared_qtable
from repro_torch.core.dpu.runtime import DPU, DpuConfig, group_key
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.device import DeviceLike
from repro_torch.serving import telemetry as tm


@dataclass(frozen=True)
class DpuServiceConfig:
    dpu: DpuConfig = field(default_factory=DpuConfig)
    clock: str = "virtual"          # virtual (tests/sim) | wall (serving)
    max_pending: int = 64           # ingest -> preprocess queue bound
    max_group: int = 16             # requests per batched CU launch
    max_ready: int = 64             # ready buffer bound (x2: double-buffered)
    # Pad each launched group to the next power-of-two stack size (last
    # payload repeated, padded outputs dropped), so the kernels see one
    # launch shape per (pow2 size, payload shape) — the engine's shape-bucket
    # discipline applied to the DPU. None = auto: on for the kernel backend,
    # off for the numpy CPU baseline (which loops per request).
    bucket_pow2: Optional[bool] = None
    # Run a group's WHOLE front-end as one launch per kernel
    # (kernels.ops.audio_pipeline_batch / image_pipeline_batch) instead of
    # one pass per functional unit. None = auto: on for the kernel backend.
    fused_launch: Optional[bool] = None


class DoubleBuffer:
    """Bounded two-buffer hand-off between pipeline stages.

    The producer appends to the BACK buffer while the consumer drains the
    FRONT; when the front empties, the buffers swap. The consumer therefore
    never walks a list the producer is appending to, and each side touches
    shared structure only at the O(1) put/swap boundary. Total capacity is
    2 x `cap`.
    """

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._front: Deque[Any] = deque()
        self._back: Deque[Any] = deque()

    def __len__(self) -> int:
        return len(self._front) + len(self._back)

    def free(self) -> int:
        """Producer-side headroom (back buffer only — the front belongs to
        the consumer until it drains)."""
        return max(0, self.cap - len(self._back))

    def put(self, item: Any) -> bool:
        if len(self._back) >= self.cap:
            return False
        self._back.append(item)
        return True

    def drain(self, n: Optional[int] = None) -> List[Any]:
        """Consumer side: take up to `n` items (all, when None) from the
        front; swap in the back buffer when the front is empty."""
        if not self._front:
            self._front, self._back = self._back, self._front
        out: List[Any] = []
        while self._front and (n is None or len(out) < n):
            out.append(self._front.popleft())
        return out


class DpuService:
    """Asynchronous preprocessing service over one shared CU pool, on
    `device` (default the card; pass device='cpu' for the kernels' plain
    versions)."""

    def __init__(self, cfg: Optional[DpuServiceConfig] = None, *,
                 device: DeviceLike = "cuda",
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[tm.Tracer] = None):
        self.cfg = DpuServiceConfig() if cfg is None else cfg
        if self.cfg.clock not in ("virtual", "wall"):
            raise ValueError(f"unknown clock mode {self.cfg.clock!r}")
        self.registry = registry if registry is not None \
            else MetricsRegistry("dpu_service")
        self.tracer = tracer if tracer is not None else tm.Tracer()
        self.dpu = DPU(self.cfg.dpu, device)
        self.device = self.dpu.device
        kernels = self.cfg.dpu.backend == "dpu"
        self._bucket = kernels if self.cfg.bucket_pow2 is None else self.cfg.bucket_pow2
        self._fused = kernels if self.cfg.fused_launch is None else self.cfg.fused_launch
        # the launches' own stream: preprocessing overlaps decode on the card
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._pending: Deque[Request] = deque()
        self._ready = DoubleBuffer(self.cfg.max_ready)
        # virtual clock: (modeled ready_at, seq, request) min-heap
        self._scheduled: List[Tuple[float, int, Request]] = []
        self._seq = 0
        self.stats = self.registry.view("dpu", (
            "submitted", "groups", "processed", "failed",
            "max_pending_depth", "max_ready_depth",
        ))
        # requests whose batched launch raised: surfaced via take_failed()
        # so the runtime can shed them — a bad payload must never vanish or
        # wedge the pipeline (see _worker_loop)
        self._failed: List[Request] = []
        self.last_error: Optional[BaseException] = None
        # fault injection (serving/faults.py FaultPlan dpu_fail events): the
        # next N batched launches raise, through the same take_failed()
        # contract a real kernel failure uses
        self._fail_next_launches = 0
        # wall clock: one worker = the DPU device; work/done guarded by _cond
        self._cond = threading.Condition()
        self._work: Deque[List[Request]] = deque()
        self._done: Deque[Request] = deque()
        self._inflight = 0              # requests handed to the worker
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        if self.cfg.clock == "wall":
            self._worker = threading.Thread(
                target=self._worker_loop, name="dpu-service", daemon=True
            )
            self._worker.start()

    # --- intake -------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Accept one raw request into the input queue; False when the queue
        is full (backpressure toward ingest — the caller keeps the request
        and retries after draining)."""
        if len(self._pending) >= self.cfg.max_pending:
            return False
        self._pending.append(req)
        self.stats["submitted"] += 1
        self.stats["max_pending_depth"] = max(
            self.stats["max_pending_depth"], len(self._pending)
        )
        return True

    # --- introspection ------------------------------------------------------
    def pending(self) -> int:
        return len(self._pending)

    def in_flight(self) -> int:
        """Requests launched but not yet surfaced on poll()."""
        if self.cfg.clock == "virtual":
            return len(self._scheduled)
        with self._cond:
            return sum(len(g) for g in self._work) + self._inflight \
                + len(self._done)

    def executing(self) -> int:
        """Requests launched on (or queued to) the CU pool right now —
        excludes completed work awaiting harvest (the occupancy signal)."""
        if self.cfg.clock == "virtual":
            return len(self._scheduled)
        with self._cond:
            return sum(len(g) for g in self._work) + self._inflight

    def ready(self) -> int:
        return len(self._ready)

    def failed_count(self) -> int:
        with self._cond:
            return len(self._failed)

    def busy(self) -> bool:
        # failed requests count as busy until take_failed() collects them —
        # otherwise a runtime loop whose LAST pending work fails would exit
        # before recording the shed, stranding the requests
        return bool(self._pending or self.in_flight() or len(self._ready)
                    or self.failed_count())

    def next_ready(self) -> Optional[float]:
        """Virtual-clock event hint: earliest modeled completion still in
        flight (None in wall mode — the wall clock advances by itself)."""
        if self.cfg.clock == "virtual" and self._scheduled:
            return self._scheduled[0][0]
        return None

    def estimate_s(self, payload: Any) -> float:
        """Analytic per-request preprocessing latency (SLO admission
        estimate at the runtime's front door)."""
        return self.dpu.latency_s(payload)

    # --- stage step ---------------------------------------------------------
    def step(self, now: float) -> bool:
        """One service iteration: launch same-shape groups from the input
        queue (capacity permitting) and harvest completed requests into the
        ready buffer. Returns True if anything moved."""
        progressed = self._launch(now)
        progressed |= self._harvest(now)
        self.stats["max_ready_depth"] = max(
            self.stats["max_ready_depth"], len(self._ready)
        )
        return progressed

    def poll(self, now: float, n: Optional[int] = None) -> List[Request]:
        """Completed requests in completion order (admission intake)."""
        return self._ready.drain(n)

    def reset_metrics(self) -> None:
        """Zero the stat counters (benchmark warmup boundary)."""
        self.registry.reset()

    def close(self) -> None:
        if self._worker is not None:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._worker.join(timeout=5.0)
            self._worker = None

    # --- fault injection ----------------------------------------------------
    def inject_launch_failures(self, n: int) -> None:
        """Arm the next `n` batched launches to raise (deterministic chaos
        harness): each armed launch fails its whole group through the same
        take_failed() contract a real kernel failure uses."""
        with self._cond:
            self._fail_next_launches += int(n)

    def _injected_failure(self) -> bool:
        with self._cond:
            if self._fail_next_launches > 0:
                self._fail_next_launches -= 1
                return True
        return False

    # --- internals ----------------------------------------------------------
    def _process_group(self, group: List[Request]) -> List[Any]:
        """One batched pass over a group's payloads; with pow2 bucketing the
        stack is padded by repeating the last payload (same shape, so the
        whole stack is still one launch per kernel) and padded outputs are
        dropped. With fused_launch the front-end is one
        kernels.ops.audio_pipeline_batch call (audio) or one
        kernels.ops.image_pipeline_batch call (JPEG dicts whose qtables all
        equal the first; a group with mixed tables takes the per-FU batched
        path) on the service's stream, and the features reach the host in
        one copy. An armed injected failure raises before any kernel
        launches."""
        if self._injected_failure():
            raise RuntimeError("injected DPU launch failure (fault plan)")
        xs = [r.payload for r in group]
        n = len(xs)
        if self._bucket:
            m = next_pow2(n)
            if m > n:
                xs = xs + [xs[-1]] * (m - n)
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with stream:
            out = self._fused_pass(xs) if self._fused else None
            if out is not None:
                self.dpu.processed += n
                return [out[i] for i in range(n)]
            outs = self.dpu.process_batch(xs)[:n]
        self.dpu.processed -= len(xs) - n  # padded rows are not requests
        return outs

    def _fused_pass(self, xs: List[Any]) -> Optional[np.ndarray]:
        """The group's whole front-end as one launch per kernel, features on
        the host; None when the group cannot fuse (mixed qtables)."""
        from repro_torch.kernels import ops as kops

        if self.cfg.dpu.modality != "image":
            x = torch.from_numpy(np.stack(xs)).to(self.device)
            return kops.audio_pipeline_batch(x).cpu().numpy()
        qt = shared_qtable(xs)
        if qt is None:
            return None
        coeffs = torch.from_numpy(np.stack([np.asarray(x["coeffs"]) for x in xs]))
        return kops.image_pipeline_batch(coeffs.to(self.device),
                                         torch.from_numpy(qt).to(self.device)).cpu().numpy()

    def _form_group(self) -> List[Request]:
        """Pop the head-of-line request plus every same-shape SAME-TENANT
        follower (up to max_group), preserving FIFO priority of the head.
        The launch key is (Request.model, runtime.group_key): two models'
        same-shape payloads never share one batched launch."""
        head = self._pending.popleft()
        key = (getattr(head, "model", None), group_key(head.payload))
        group = [head]
        kept: Deque[Request] = deque()
        while self._pending and len(group) < self.cfg.max_group:
            r = self._pending.popleft()
            if (getattr(r, "model", None), group_key(r.payload)) == key:
                group.append(r)
            else:
                kept.append(r)
        kept.extend(self._pending)
        self._pending = kept
        return group

    def _launch(self, now: float) -> bool:
        """Drain the input queue into batched launches while the ready side
        has headroom (in-flight + ready bounded by the ready capacity —
        otherwise a stalled admission stage would pile work up here)."""
        did = False
        while self._pending and (
            self.in_flight() + len(self._ready) < self.cfg.max_ready
        ):
            group = self._form_group()
            self.stats["groups"] += 1
            self.tracer.event(tm.PREPROCESS_LAUNCH, now, n=len(group),
                              tenant=getattr(group[0], "model", None),
                              rids=[r.rid for r in group])
            if self.cfg.clock == "virtual":
                # process FIRST (same shed-the-group contract as the wall
                # worker: a raising launch must not crash the pipeline or
                # lose requests), then model completion times from the CU
                # pool's analytic cost model on the RAW inputs
                raws = [r.payload for r in group]
                try:
                    outs = self._process_group(group)
                    ts = []
                    for x in raws:
                        t = now
                        for pool in self.dpu.stages:
                            _, t = pool.schedule(t, x)
                        ts.append(t)
                except Exception as e:
                    self.last_error = e
                    self._failed.extend(group)
                    self.stats["failed"] += len(group)
                    self.tracer.event(tm.PREPROCESS_FAIL, now, n=len(group),
                                      rids=[r.rid for r in group])
                    did = True
                    continue
                for r, t, y in zip(group, ts, outs):
                    heapq.heappush(self._scheduled, (t, self._seq, r))
                    self._seq += 1
                    r.payload = y
            else:
                with self._cond:
                    self._work.append(group)
                    self._cond.notify()
            did = True
        return did

    def _harvest(self, now: float) -> bool:
        """Move completed requests into the ready double-buffer (bounded:
        leftovers stay queued for the next step — backpressure)."""
        did = False
        if self.cfg.clock == "virtual":
            while self._scheduled and self._scheduled[0][0] <= now:
                ready_at, _, r = self._scheduled[0]
                r.preprocessed_at = ready_at
                if not self._ready.put(r):
                    r.preprocessed_at = None
                    break
                heapq.heappop(self._scheduled)
                self.stats["processed"] += 1
                self.tracer.event(tm.PREPROCESS_DONE, ready_at, rid=r.rid,
                                  tenant=getattr(r, "model", None))
                did = True
        else:
            with self._cond:
                done, self._done = self._done, deque()
            while done:
                r = done[0]
                r.preprocessed_at = now
                if not self._ready.put(r):
                    r.preprocessed_at = None
                    break
                done.popleft()
                self.stats["processed"] += 1
                self.tracer.event(tm.PREPROCESS_DONE, now, rid=r.rid,
                                  tenant=getattr(r, "model", None))
                did = True
            if done:  # ready buffer full: keep the rest for the next step
                with self._cond:
                    done.extend(self._done)
                    self._done = done
        return did

    def _worker_loop(self) -> None:
        """Wall-clock worker (the DPU device): batched kernel launches run
        here, off the decode loop. Shared state is touched only under the
        condition lock, and only for O(1) queue hand-offs. A launch that
        raises (malformed payload, kernel failure) sheds ONLY its group —
        the requests move to the failed list for the runtime to record, the
        error is kept on `last_error`, and the worker keeps serving later
        groups; killing the thread would silently lose the group and wedge
        busy() forever."""
        while True:
            with self._cond:
                while not self._work and not self._stop:
                    self._cond.wait()
                if self._stop and not self._work:
                    return
                group = self._work.popleft()
                self._inflight += len(group)
            try:
                outs = self._process_group(group)
                for r, y in zip(group, outs):
                    r.payload = y
            except Exception as e:  # shed the group, keep serving
                with self._cond:
                    self.last_error = e
                    self._failed.extend(group)
                    self.stats["failed"] += len(group)
                    self._inflight -= len(group)
                continue
            with self._cond:
                self._done.extend(group)
                self._inflight -= len(group)

    def take_failed(self) -> List[Request]:
        """Requests whose preprocessing launch raised: the caller records
        them as shed. The triggering exception stays on `last_error`."""
        with self._cond:
            out, self._failed = self._failed, []
        return out
