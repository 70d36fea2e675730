"""Request/slot dispatch policies.

`SliceScheduler`: REQUEST -> slice dispatch tracking for the multi-slice
serving pool (the MIG analogue, core/slicing: V independent sub-mesh serving
replicas, each a continuous-batching engine with `max_slots` KV rows).

Per-request contract (the batch-granularity scheduler this replaced handed
each slice exactly one formed batch at a time; every semantic below is now
tracked per request id):

* dispatch — the caller streams individual requests into any slice with a
  free slot; `pick_slice` chooses the least-loaded healthy slice (by the
  caller-supplied load map, i.e. `slots_in_use() + admission_depth()`;
  `capacity` may be a scalar or a per-slice map for fleets whose tenants
  size their slot pools differently), so later admission groups join a
  busy slice's pool mid-flight instead of queueing behind a resident
  batch. `dispatch(rid, sid, ...)` records a *holder*: (slice,
  dispatched_at, expected_s). TENANCY is the caller's invariant, enforced
  via `exclude`: in a multi-tenant fleet (serving/multislice.py) every
  pick — stream dispatch, hedge twin, failure/resize redispatch — excludes
  all slices not owned by the request's model, so a request can only ever
  hold slots on its own tenant's slices.
* hedging — PROGRESS-GATED straggler detection: the caller stamps
  `note_progress(sid, now)` whenever a slice's engine advances, and a
  holder is a straggler only once `hedge_factor x` its expected execution
  time passes with NO progress on its slice (a hung/failed device). Pure
  elapsed time cannot be the signal at request granularity: a healthy
  slice time-shares its pool across many streamed residents, so every
  request's wall time stretches with load and elapsed-only detection
  hedges the whole pool (measured: it re-ran ~30% of a saturated trace).
  `hedge(rid, ...)` records a speculative copy of THAT REQUEST on a twin
  slice (the caller clones the Request so the two engines never race on
  shared fields) and marks every holder hedged so the pair is never
  re-hedged onto a third slice. First completion wins: `complete(rid,
  sid)` records the winner exactly once and returns the losing holders'
  slice ids for mid-flight cancellation (`ServingEngine.cancel`); a later
  completion of the same rid is a no-op (returns None).
* failure — evicting a slice returns the rids whose ONLY healthy holder it
  was (the caller requeues those requests); a rid with a surviving healthy
  holder is NOT requeued — the survivor simply carries on, re-armed for
  hedging (hedged=False). An elastic RESIZE rebuilds the whole pool (every
  engine is torn down, so no holder can survive): the caller requeues
  every tracked original — unique per rid — and the rebuilt scheduler
  adopts the old one's retry accounting.
* retry budget — every failure/resize requeue charges `note_requeue(rid)`;
  once a rid has been requeued more than `max_retries` times the caller
  dead-letters it (typed reason) instead of requeueing, so a request
  caught in a failure loop is bounded-total-retries, not retried forever.
  With `retry_backoff_s`, each retry pushes the rid's earliest redispatch
  out exponentially and the dispatch loop holds it back until then.

The scheduler tracks ids and timing only; Request objects, slot pools, and
execution live in serving/multislice.py. The simulator's analytic
batch-granularity scheduler survives as `BatchSliceScheduler` below.

`SlotScheduler`: continuous-batching admission planner for the slot-pool
engine. Pulls knee-formed batches from the BucketedBatcher as they come due,
keeps an oldest-deadline-first backlog, and each engine iteration plans which
requests join free KV slots and how long the next decode segment runs
(policy.pick_segment_len, knee-profile bounded when profiles are wired in).
Admission groups stay bucketed + left-padded AND tenant-pure: the group key
is (Request.model, pow2 prompt bucket), so in a multi-tenant fleet two
models' same-length prompts never share an admission group — each group is
executable-compatible with exactly one tenant's engines. `plan()` accepts
either a scalar `free_slots` (single-tenant pool) or a per-tenant
{model: free slots} map; with the map, EDF order is preserved PER TENANT
and a tenant whose slices are all full never blocks another tenant's
requests sitting behind it in the backlog (no cross-tenant head-of-line).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.batching.buckets import Batch, BucketedBatcher, Request, next_pow2
from repro_torch.core.batching.policy import BatchPolicy, pick_segment_len


@dataclass
class SlotPlan:
    """One engine iteration: admit these request groups into free slots (in
    order), then run one decode segment of `segment_len` steps."""

    admissions: List[List[Request]]
    segment_len: int


class SlotScheduler:
    """Admission order + segment length for the continuous-batching engine.

    The batcher still owns knee-driven batch *formation* (Batch_max /
    Time_queue); this layer owns slot *admission*: due batches are drained
    into a backlog ordered by ready time (EDF — the oldest request's flush
    deadline expires first), and each plan() admits the `free_slots` oldest
    requests as bucket-pure left-padded groups (one per power-of-two prompt
    bucket, so short prompts never pay a long neighbor's padded prefill).
    Requests that do not fit stay in the backlog and join at a later segment
    boundary — that bounded wait (<= one segment once a slot frees) replaces
    the run-to-completion path's head-of-line wait of up to max_new_tokens
    steps.
    """

    def __init__(self, policy: BatchPolicy, *, max_slots: int,
                 segment_len: int = 8, segment_lens: Sequence[int] = (),
                 profile_for: Optional[Callable[[int], Any]] = None):
        self.policy = policy
        self.max_slots = max_slots
        self.segment_len = segment_len
        self.segment_lens = tuple(sorted(set(segment_lens))) or (segment_len,)
        # padded prompt length -> KneeProfile (or None): lets
        # pick_segment_len bound the segment by the measured batch knee
        # instead of the pure pool-pressure heuristic — the same wiring
        # pick_chunk_len got (ServingEngine._profile_for supplies it)
        self._profile_for = profile_for
        self._backlog: List[Request] = []

    def backlog(self) -> int:
        return len(self._backlog)

    def depth(self) -> int:
        """Admission queue depth (backlogged requests not yet in a slot) —
        the stage-pipelined runtime's backpressure signal: when depth
        reaches RuntimeConfig.max_backlog, admission stops pulling from the
        preprocess-complete queue and the stall propagates upstream to
        ingest. Alias of backlog() so the two can never diverge."""
        return self.backlog()

    def offer(self, reqs: Sequence[Request]) -> None:
        """Admission intake from the stage-pipelined runtime's preprocess-
        complete queue (serving/runtime.py): requests whose preprocessing
        already finished join the EDF backlog directly. Batch *formation*
        already happened upstream (the DpuService drains same-shape groups
        and stamps preprocessed_at), so the batcher's knee timer is not paid
        a second time; plan() still emits bucket-pure left-padded admission
        groups, so the engine's compile-once invariant is untouched."""
        self.requeue(reqs)

    def pull(self, batcher: BucketedBatcher, now: float) -> None:
        """Drain every batch the knee policy says is due at `now`."""
        pulled = False
        for b in batcher.poll(now):
            self._backlog.extend(b.requests)
            pulled = True
        if pulled:
            self._backlog.sort(key=Request.ready_at)

    @staticmethod
    def _lp_bucket(req: Request) -> Tuple[Optional[str], int]:
        """Per-tenant admission-group key: (model id, power-of-two
        prompt-length bucket — the engine's admit-executable key).
        Admission groups are kept bucket-pure so a short prompt never pays
        a long neighbor's padded prefill, and TENANT-pure so a group is
        only ever executable on its own model's engines (model=None is the
        single-tenant default and groups exactly as before)."""
        return (getattr(req, "model", None), next_pow2(max(1, int(req.length))))

    def cancel(self, rids) -> int:
        """Drop backlogged requests by rid (hedge-twin cancellation or an
        elastic re-slice pulling queued work back); returns how many left."""
        rids = set(rids)
        kept = [r for r in self._backlog if r.rid not in rids]
        n = len(self._backlog) - len(kept)
        self._backlog = kept
        return n

    def drain(self) -> List[Request]:
        """Take the whole backlog (requests already pulled out of the
        batcher but not yet admitted) — an elastic re-slice must carry these
        across the scheduler rebuild or they would be lost."""
        out, self._backlog = self._backlog, []
        return out

    def requeue(self, reqs: Sequence[Request]) -> None:
        """Return requests to the backlog, restoring EDF order."""
        self._backlog.extend(reqs)
        self._backlog.sort(key=Request.ready_at)

    def plan(self, batcher: BucketedBatcher, now: float, *,
             free_slots) -> SlotPlan:
        """`free_slots` is a scalar (single pool) or a {model: free slots}
        map (multi-tenant fleet). With the map, requests are taken in EDF
        order but only against THEIR tenant's quota — a tenant whose
        slices are all full leaves its requests in the backlog without
        blocking another tenant's requests queued behind them."""
        self.pull(batcher, now)
        admissions: List[List[Request]] = []
        if isinstance(free_slots, dict):
            quota = {m: max(0, int(v)) for m, v in free_slots.items()}
            budget = min(sum(quota.values()), self.max_slots)
            take, keep = [], []
            for r in self._backlog:
                m = getattr(r, "model", None)
                if len(take) < budget and quota.get(m, 0) > 0:
                    take.append(r)
                    quota[m] -= 1
                else:
                    keep.append(r)
            self._backlog = keep
            free_after = budget - len(take)
        else:
            free_slots = min(free_slots, self.max_slots)  # pool capacity
            take = self._backlog[:free_slots] if free_slots else []
            if take:
                del self._backlog[:len(take)]
            free_after = free_slots - len(take)
        if take:
            groups: Dict[Tuple[Optional[str], int], List[Request]] = {}
            for r in take:  # tenant- and bucket-pure groups, EDF preserved
                groups.setdefault(self._lp_bucket(r), []).append(r)
            admissions.extend(groups.values())
        waiting = len(self._backlog) + batcher.pending()
        prof = None
        if self._profile_for is not None and waiting:
            # knee profile of the dominant waiting/admitted prompt bucket:
            # the largest padded length in play bounds the stall a long
            # segment imposes on the queue
            lps = [self._lp_bucket(r)[1] for r in self._backlog]
            lps.extend(self._lp_bucket(r)[1] for g in admissions for r in g)
            if lps:
                prof = self._profile_for(max(lps))
        seg = pick_segment_len(
            self.segment_lens, waiting=waiting, free_slots=free_after,
            profile=prof,
        )
        return SlotPlan(admissions=admissions, segment_len=seg)


@dataclass
class SliceState:
    """Per-slice health + completion bookkeeping (request granularity)."""

    slice_id: int
    healthy: bool = True
    completed: int = 0            # requests completed by this slice
    last_progress: float = 0.0    # caller-stamped engine-advance time


@dataclass
class _Holder:
    """One slice's in-flight copy of one request."""

    slice_id: int
    dispatched_at: float
    expected_s: float
    hedged: bool = False


class SliceScheduler:
    """Per-request slice dispatch tracker (contract in the module
    docstring): holders per rid, straggler hedging with first-completion-
    wins, and failure/resize requeue that never duplicates a request whose
    other hedge holder is still healthy."""

    def __init__(self, n_slices: int, *, hedge_factor: float = 3.0,
                 max_retries: int = 3, retry_backoff_s: float = 0.0):
        self.slices = {i: SliceState(i) for i in range(n_slices)}
        self.hedge_factor = hedge_factor
        self.hedges = 0
        self._holders: Dict[int, List[_Holder]] = {}
        # bounded-total-retries accounting: a rid requeued by slice failure
        # or resize more than max_retries times is dead-lettered by the
        # caller instead of cycling forever. Counts survive resize (the
        # rebuilt scheduler adopts them) so "exactly once per event" really
        # is "bounded total per rid".
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retries: Dict[int, int] = {}
        self.not_before: Dict[int, float] = {}  # rid -> earliest redispatch

    # --- introspection -----------------------------------------------------
    def holders(self, rid: int) -> List[int]:
        return [h.slice_id for h in self._holders.get(rid, ())]

    # --- retry budget ------------------------------------------------------
    def note_requeue(self, rid: int, now: float) -> bool:
        """Charge one retry against `rid`'s budget (called when a failure
        or resize requeues it). Returns False when the budget is exhausted
        — the caller must dead-letter instead of requeueing. With
        retry_backoff_s > 0, each retry also pushes the rid's earliest
        redispatch out exponentially (2^(n-1) x base)."""
        n = self.retries.get(rid, 0) + 1
        self.retries[rid] = n
        if n > self.max_retries:
            return False
        if self.retry_backoff_s > 0:
            self.not_before[rid] = now + self.retry_backoff_s * (2 ** (n - 1))
        return True

    def ready_for_dispatch(self, rid: int, now: float) -> bool:
        return now >= self.not_before.get(rid, 0.0)

    def next_retry_at(self) -> Optional[float]:
        """Earliest pending backoff expiry (virtual-clock idle-jump hint)."""
        return min(self.not_before.values()) if self.not_before else None

    def forget(self, rid: int) -> None:
        """Drop retry bookkeeping for a rid that reached a terminal state
        (completed or dead-lettered)."""
        self.retries.pop(rid, None)
        self.not_before.pop(rid, None)

    def adopt_retries(self, other: "SliceScheduler") -> None:
        """Carry retry accounting across a resize rebuild."""
        self.retries.update(other.retries)
        self.not_before.update(other.not_before)

    # --- slice lifecycle ---------------------------------------------------
    def fail_slice(self, slice_id: int) -> List[int]:
        """Evict a slice. Returns the rids to requeue: those whose only
        healthy holder was the failed slice. A rid with a surviving healthy
        holder is NOT requeued (the survivor completes alone, re-armed for
        hedging) — requeueing it would duplicate execution and completion."""
        self.slices[slice_id].healthy = False
        requeue: List[int] = []
        for rid, hs in list(self._holders.items()):
            if not any(h.slice_id == slice_id for h in hs):
                continue
            rest = [h for h in hs if h.slice_id != slice_id
                    and self.slices[h.slice_id].healthy]
            if rest:
                for h in rest:
                    h.hedged = False  # single holder again: re-arm hedging
                self._holders[rid] = rest
            else:
                del self._holders[rid]
                requeue.append(rid)
        return requeue

    def recover_slice(self, slice_id: int) -> None:
        self.slices[slice_id].healthy = True

    # --- dispatch ----------------------------------------------------------
    def pick_slice(self, load: Dict[int, int], capacity, *,
                   exclude: Iterable[int] = ()) -> Optional[int]:
        """Least-loaded healthy slice with a free slot (`load` is the
        caller's occupancy map — slots in use plus admission backlog;
        `capacity` the per-slice slot count, a scalar or a {sid: slots}
        map for fleets whose tenants size their pools differently). Ties
        break toward the slice that has completed the fewest requests,
        then the lowest id. Tenant constraints arrive via `exclude` — the
        multi-slice caller excludes every slice the request's model does
        not own, so this stays a pure capacity/health chooser."""
        exclude = set(exclude)
        if not isinstance(capacity, dict):
            capacity = {sid: capacity for sid in self.slices}
        cands = [
            sid for sid, s in self.slices.items()
            if s.healthy and sid not in exclude
            and load.get(sid, 0) < capacity.get(sid, 0)
        ]
        if not cands:
            return None
        return min(cands, key=lambda sid: (load.get(sid, 0),
                                           self.slices[sid].completed, sid))

    def dispatch(self, rid: int, slice_id: int, now: float,
                 expected_s: float) -> None:
        """Record `rid` streaming into a slot of `slice_id`."""
        self._holders.setdefault(rid, []).append(
            _Holder(slice_id, now, expected_s)
        )

    def complete(self, rid: int, slice_id: int) -> Optional[List[int]]:
        """First completion wins: records the winner and returns the OTHER
        holders' slice ids (losing hedge copies for the caller to cancel
        mid-flight). Returns None when the rid is unknown — already
        completed elsewhere, or cancelled."""
        hs = self._holders.pop(rid, None)
        if hs is None:
            return None
        self.forget(rid)  # terminal: retry budget no longer applies
        st = self.slices.get(slice_id)
        if st is not None:
            st.completed += 1
        return [h.slice_id for h in hs if h.slice_id != slice_id]

    # --- hedging -----------------------------------------------------------
    def note_progress(self, slice_id: int, now: float) -> None:
        """Stamp a slice as having advanced (its engine did work at `now`);
        holders on a progressing slice are never stragglers, however long
        they wall-clock wait behind other streamed residents."""
        st = self.slices.get(slice_id)
        if st is not None and now > st.last_progress:
            st.last_progress = now

    def stragglers(self, now: float) -> List[Tuple[int, int]]:
        """(rid, slice_id) holders whose slice has made NO progress for
        hedge_factor x the holder's expected execution time."""
        out = []
        for rid, hs in self._holders.items():
            for h in hs:
                st = self.slices.get(h.slice_id)
                if st is None or not st.healthy or h.hedged or h.expected_s <= 0:
                    continue
                ref = max(h.dispatched_at, st.last_progress)
                if now - ref > self.hedge_factor * h.expected_s:
                    out.append((rid, h.slice_id))
        return out

    def hedge(self, rid: int, now: float, twin_sid: int) -> None:
        """Record a speculative copy of `rid` on `twin_sid`. Every holder of
        the pair is marked hedged — without this, stragglers() would flag
        the twin and re-hedge the same request onto a third slice (and so
        on), multiplying speculative copies."""
        hs = self._holders.get(rid)
        if not hs:
            return
        for h in hs:
            h.hedged = True
        hs.append(_Holder(twin_sid, now, hs[0].expected_s, hedged=True))
        self.hedges += 1


# ---------------------------------------------------------------------------
# Simulator's batch-granularity scheduler (analytic model)
# ---------------------------------------------------------------------------


@dataclass
class BatchSliceState:
    slice_id: int
    healthy: bool = True
    busy_until: float = 0.0
    inflight: Optional[Batch] = None
    dispatched_at: float = 0.0
    expected_s: float = 0.0
    hedged: bool = False
    completed: int = 0


class BatchSliceScheduler:
    """Batch -> slice dispatch with failure handling and straggler hedging,
    one in-flight batch per slice. This is the event-driven SIMULATOR's
    analytic execution model (serving/simulator.py reproduces the paper's
    figures with whole-batch slice latencies); the real serving path
    streams requests per slot through the per-request `SliceScheduler`
    above."""

    def __init__(self, n_slices: int, *, hedge_factor: float = 3.0):
        self.slices = {i: BatchSliceState(i) for i in range(n_slices)}
        self.hedge_factor = hedge_factor
        self.requeued: List[Batch] = []
        self.hedges = 0

    @staticmethod
    def _reset(s: BatchSliceState) -> None:
        """Clear dispatch-tracking state once a slice stops holding a batch
        (complete / cancel / fail / drop) so stragglers() and free_slices()
        never act on stale expected_s / dispatched_at / busy_until."""
        s.inflight = None
        s.hedged = False
        s.expected_s = 0.0
        s.dispatched_at = 0.0
        s.busy_until = 0.0

    def _holders(self, batch: Batch, *, exclude: int = -1) -> List[BatchSliceState]:
        """Every healthy slice currently running `batch` (hedge twins run the
        same Batch object, so identity is the dedupe key)."""
        return [
            s for s in self.slices.values()
            if s.slice_id != exclude and s.healthy and s.inflight is batch
        ]

    # --- slice lifecycle ---------------------------------------------------
    def fail_slice(self, slice_id: int) -> Optional[Batch]:
        """Evict a slice. Its in-flight batch is re-queued ONLY if no healthy
        hedge twin is still running the same batch — otherwise requeueing
        would duplicate execution (and completion) of the surviving copy."""
        s = self.slices[slice_id]
        s.healthy = False
        b = s.inflight
        self._reset(s)
        if b is None:
            return None
        survivors = self._holders(b, exclude=slice_id)
        if survivors:
            # the batch lives on with a single holder again: re-arm hedging
            for other in survivors:
                other.hedged = False
            return None
        self.requeued.append(b)
        return b

    def recover_slice(self, slice_id: int) -> None:
        self.slices[slice_id].healthy = True

    def resize(self, n_slices: int) -> List[Batch]:
        """Elastic re-slice (MIG reconfiguration analogue): drop or add
        slices; in-flight work on dropped slices is re-queued exactly once —
        a hedged batch whose two holders are both dropped is deduped, and a
        batch whose other holder survives is not requeued at all."""
        dropped: List[Batch] = []
        for sid in [s for s in self.slices if s >= n_slices]:
            st = self.slices.pop(sid)
            if st.inflight is not None:
                dropped.append(st.inflight)
            self._reset(st)
        for sid in range(n_slices):
            self.slices.setdefault(sid, BatchSliceState(sid))
        requeue: List[Batch] = []
        for b in dropped:
            if any(u is b for u in requeue):
                continue  # both hedge holders dropped -> one copy
            survivors = self._holders(b)
            if survivors:  # still running on a surviving slice
                for other in survivors:
                    other.hedged = False
                continue
            requeue.append(b)
        self.requeued.extend(requeue)
        return requeue

    # --- dispatch ------------------------------------------------------------
    def free_slices(self, now: float) -> List[int]:
        return [
            s.slice_id
            for s in self.slices.values()
            if s.healthy and s.inflight is None and s.busy_until <= now
        ]

    def dispatch(self, batch: Batch, now: float, expected_s: float) -> Optional[int]:
        free = self.free_slices(now)
        if not free:
            return None
        sid = min(free, key=lambda i: self.slices[i].completed)
        s = self.slices[sid]
        s.inflight = batch
        s.dispatched_at = now
        s.expected_s = expected_s
        s.busy_until = now + max(0.0, expected_s)
        s.hedged = False
        for r in batch.requests:
            r.dispatched_at = now
        return sid

    def complete(self, slice_id: int, now: float) -> Optional[Batch]:
        s = self.slices[slice_id]
        b = s.inflight
        if b is None:
            return None
        self._reset(s)
        s.completed += 1
        for r in b.requests:
            r.completed_at = now
        # cancel any hedge twin still in flight for the same batch; a stale
        # hedged/expected_s/dispatched_at on the twin would make it look
        # busy/straggling forever, so its state is fully reset
        for other in self.slices.values():
            if other.slice_id != slice_id and other.inflight is b:
                self._reset(other)
        return b

    def stragglers(self, now: float) -> List[int]:
        """Slices past hedge_factor x expected execution time."""
        out = []
        for s in self.slices.values():
            if (
                s.healthy
                and s.inflight is not None
                and not s.hedged
                and s.expected_s > 0
                and now - s.dispatched_at > self.hedge_factor * s.expected_s
            ):
                out.append(s.slice_id)
        return out

    def hedge(self, slice_id: int, now: float) -> Optional[int]:
        """Speculatively re-dispatch a straggler's batch to a free slice."""
        s = self.slices[slice_id]
        if s.inflight is None:
            return None
        free = [x for x in self.free_slices(now) if x != slice_id]
        if not free:
            return None
        twin = self.slices[free[0]]
        twin.inflight = s.inflight
        twin.dispatched_at = now
        twin.expected_s = s.expected_s
        twin.busy_until = now + max(0.0, s.expected_s)
        # the twin is itself part of a hedge pair: without this flag
        # stragglers() would flag it and re-hedge the same batch onto a
        # third slice (and so on), multiplying speculative copies
        twin.hedged = True
        s.hedged = True
        self.hedges += 1
        return twin.slice_id
