"""Bucketized variable-length batching queues (paper §4.3, Fig. 16).

Inputs are bucketized by length into non-overlapping windows (2.5 s of audio
in the paper; token-length windows for LM serving). Each bucket has its own
queue and its own Batch_max (= that length's Batch_knee). A batch is released
when (a) the bucket holds Batch_max requests, or (b) the oldest request has
waited Time_queue. Under-full batches merge requests from *adjacent* buckets,
capped by the Batch_max of the longest member's bucket.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.batching.policy import BatchPolicy


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (for n >= 1): THE shape-bucket formula,
    shared by prompt buckets (serving/engine), bucket-pure admission groups
    (core/batching/scheduler), and DPU launch stacks (core/dpu/service) so
    the compile-once shape discipline can never silently diverge between
    layers."""
    return 1 << max(0, (n - 1).bit_length())


@dataclass
class Request:
    rid: int
    arrival: float               # seconds (sim or wall clock)
    length: float                # audio seconds or token count
    payload: Any = None
    # Tenancy: which model/tenant this request belongs to (multi-tenant
    # fleets; None = the single-tenant default). Stamped by the model
    # router at the fleet front door and carried end-to-end — bucket keys,
    # admission groups, DPU launch groups, and slice routing are all
    # tenant-pure. Hedge clones (dataclasses.replace) inherit it.
    model: Optional[str] = None
    max_new_tokens: Optional[int] = None  # per-request decode budget
    # Real tokenized prompt: an int token array of exactly max(1, int(length))
    # ids. None falls back to the deterministic per-rid synthetic generator
    # (the benchmark workload). Carried end-to-end through the slot pool;
    # hedge clones share the (read-only) array.
    prompt: Any = None
    preprocessed_at: Optional[float] = None
    dispatched_at: Optional[float] = None
    # TTFT telemetry: when the request's FIRST output token materialized
    # (prefill/final-chunk greedy token on the slot-pool path; batch finish
    # on run-to-completion, which has no earlier observable point). Prefix
    # cache and SLO gates key on TTFT, not just completion latency.
    first_token_at: Optional[float] = None
    completed_at: Optional[float] = None

    def ready_at(self) -> float:
        return self.preprocessed_at if self.preprocessed_at is not None else self.arrival


@dataclass
class Batch:
    requests: List[Request]
    bucket_id: int               # bucket of the longest member
    formed_at: float

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def max_length(self) -> float:
        return max(r.length for r in self.requests)


@dataclass
class Bucket:
    bucket_id: int
    model: Optional[str] = None       # tenant owning this queue (None = default)
    queue: Deque[Request] = field(default_factory=deque)

    def oldest_ready_time(self) -> Optional[float]:
        if not self.queue:
            return None
        return self.queue[0].ready_at()


# bucket-map key: (tenant model id, length-bucket id). Tenancy is part of
# the queue identity, so two tenants' same-length requests never share a
# queue and neighbor-merging can never mix models in one batch.
BucketKey = Tuple[Optional[str], int]


class BucketedBatcher:
    """N batching queues + merge logic. Deterministic, clock-agnostic.

    Multi-tenant: queues are keyed by (Request.model, length bucket) and
    each tenant may carry its own BatchPolicy (`policy_for`) — its own
    bucket width, Batch_max table, and Time_queue — falling back to the
    shared default policy. Requests with model=None use the default policy
    (the single-tenant path, behaviorally unchanged)."""

    def __init__(self, policy: BatchPolicy, merge_adjacent: bool = True,
                 policy_for: Optional[Dict[str, BatchPolicy]] = None):
        self.policy = policy
        self.merge_adjacent = merge_adjacent
        self.policy_for: Dict[str, BatchPolicy] = dict(policy_for or {})
        self.buckets: Dict[BucketKey, Bucket] = {}
        self.formed = 0

    def policy_of(self, model: Optional[str]) -> BatchPolicy:
        if model is None:
            return self.policy
        return self.policy_for.get(model, self.policy)

    def bucket_of(self, length: float, model: Optional[str] = None) -> int:
        return int(length / self.policy_of(model).bucket_width)

    def enqueue(self, req: Request) -> None:
        m = getattr(req, "model", None)
        bid = self.bucket_of(req.length, m)
        key = (m, bid)
        self.buckets.setdefault(key, Bucket(bid, model=m)).queue.append(req)

    def pending(self) -> int:
        return sum(len(b.queue) for b in self.buckets.values())

    def next_deadline(self) -> Optional[float]:
        """Earliest time at which some bucket must be flushed."""
        ts = [
            t + self.policy_of(b.model).time_queue
            for b in self.buckets.values()
            if (t := b.oldest_ready_time()) is not None
        ]
        return min(ts) if ts else None

    def poll(self, now: float) -> List[Batch]:
        """Release every batch that is due at `now`."""
        out: List[Batch] = []
        for key in sorted(self.buckets, key=lambda k: (k[0] or "", k[1])):
            bucket = self.buckets[key]
            pol = self.policy_of(bucket.model)
            bmax = pol.batch_max_for(bucket.bucket_id)
            while len(bucket.queue) >= bmax:
                out.append(self._form(key, bmax, now))
            t0 = bucket.oldest_ready_time()
            if t0 is not None and now >= t0 + pol.time_queue:  # next_deadline, exactly
                out.append(self._form(key, bmax, now))
        return [b for b in out if b is not None]

    def _form(self, key: BucketKey, bmax: int,
              now: float) -> Optional[Batch]:
        bucket = self.buckets[key]
        reqs: List[Request] = []
        while bucket.queue and len(reqs) < bmax:
            reqs.append(bucket.queue.popleft())
        top_bid = key[1]
        if self.merge_adjacent and len(reqs) < bmax:
            top_bid, reqs = self._merge_neighbors(key, reqs, now)
        if not reqs:
            return None
        self.formed += 1
        return Batch(requests=reqs, bucket_id=top_bid, formed_at=now)

    def _merge_neighbors(self, key: BucketKey, reqs: List[Request],
                         now: float):
        """Fill from adjacent buckets OF THE SAME TENANT; the batch size cap
        follows the *longest* member's bucket (paper: never exceed the
        Batch_max of the longest input in the batch). Cross-tenant merging
        is structurally impossible — neighbor keys carry this queue's
        model id, so another tenant's queues are never candidates."""
        model, bid = key
        pol = self.policy_of(model)
        top_bid = bid
        for nb in (bid + 1, bid - 1, bid + 2, bid - 2):
            if nb < 0 or (model, nb) not in self.buckets:
                continue
            neighbor = self.buckets[(model, nb)]
            while neighbor.queue:
                cand_top = max(top_bid, nb)
                cap = pol.batch_max_for(cand_top)
                if len(reqs) >= cap:
                    break
                reqs.append(neighbor.queue.popleft())
                top_bid = cand_top
            if len(reqs) >= pol.batch_max_for(top_bid):
                break
        return top_bid, reqs
