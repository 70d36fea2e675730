"""Batch_max / Time_queue policy (paper §4.3).

Batch_max(bucket)  = Batch_knee(bucket input length)
Time_queue         = Time_knee / V   (V = number of slices), so the batcher
                     produces on average V fresh batches per model-execution
                     interval and no slice starves.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.batching.knee import KneeProfile


@dataclass(frozen=True)
class BatchPolicy:
    batch_max: Dict[int, int]        # bucket id -> Batch_max
    time_queue: float                # seconds
    time_knee: float
    n_slices: int
    bucket_width: float              # bucket window width (sec of audio / tokens)

    def batch_max_for(self, bucket_id: int) -> int:
        if bucket_id in self.batch_max:
            return self.batch_max[bucket_id]
        # fall back to the nearest profiled bucket (paper: per-length knees)
        keys = sorted(self.batch_max)
        if not keys:
            return 1
        nearest = min(keys, key=lambda k: abs(k - bucket_id))
        return self.batch_max[nearest]


def pick_segment_len(choices: Sequence[int], *, waiting: int, free_slots: int,
                     profile: Optional[KneeProfile] = None) -> int:
    """Decode-segment length for continuous batching, against the knee.

    Segment length is the join/leave granularity: queued requests can only be
    admitted (and finished rows only retired) at segment boundaries, so S is
    the same latency/throughput dial Batch_max turns at the knee — short
    segments admit sooner (lower queueing latency), long segments amortize
    host dispatch (higher tokens/s). The rule mirrors Time_queue's intent:

      * requests waiting AND no free slot -> shortest S (drain the pool fast
        so finished rows free slots for the queue);
      * requests waiting but slots free   -> middle S (they join next
        boundary anyway; don't give up all the fusion);
      * idle queue                        -> longest S (pure throughput).

    With a knee `profile` for the workload's prompt bucket
    (core/batching/knee.py), the waiting cases stop guessing — the same
    wiring pick_chunk_len has: a segment of S steps stalls
    admission for roughly the latency of S sequential token positions, so
    the MEASURED batch knee (the largest size whose latency is still
    ~flat) bounds the interruption. We take the largest choice at or under
    the knee while requests wait with slots still free (throughput without
    blowing the queueing budget), dropping to the smallest knee-safe
    choice when the pool is full; the pressure heuristic above remains the
    fallback when no profile is available, and an idle queue always takes
    the longest segment (nobody is waiting on the boundary).
    """
    cs = sorted(set(int(c) for c in choices))
    assert cs and cs[0] > 0, choices
    if waiting and profile is not None:
        safe = [c for c in cs if c <= profile.batch_knee] or cs[:1]
        return safe[0] if free_slots == 0 else safe[-1]
    if waiting and free_slots == 0:
        return cs[0]
    if waiting:
        return cs[len(cs) // 2]
    return cs[-1]


def pick_chunk_len(choices: Sequence[int], *, resident: int,
                   waiting: int = 0,
                   profile: Optional[KneeProfile] = None) -> int:
    """Prefill chunk length for chunked admission, against the knee.

    Chunk length is the prefill-side twin of pick_segment_len's dial: a
    monolithic long-prompt prefill freezes every resident decoder for the
    whole pass (head-of-line at the latency/throughput knee), while tiny
    chunks pay per-chunk dispatch overhead. The rule mirrors Time_queue's
    intent:

      * resident decoders AND queued work -> shortest chunk (the pool is
        contended; interleave decode segments as finely as possible);
      * resident decoders only            -> middle chunk (they must keep
        producing, but don't give up all the fusion);
      * empty pool                        -> longest chunk (nobody stalls;
        amortize dispatch overhead).

    With a knee `profile` for the prompt's bucket (core/batching/knee.py),
    the resident-decoder cases stop guessing: a chunk call stalls resident
    rows for roughly the latency of a batch of chunk-many token positions,
    so the MEASURED batch knee — the largest size whose latency is still
    ~flat — bounds the interruption. We take the largest choice at or under
    the knee (pure throughput), dropping to the smallest knee-safe choice
    under queue pressure; the pressure heuristic above stays the fallback
    when no profile is available.

    The engine chunks a prompt bucket only when the bucket is strictly
    longer than the returned length (a prompt that fits one chunk admits
    monolithically through its bucket executable)."""
    cs = sorted(set(int(c) for c in choices))
    assert cs and cs[0] > 0, choices
    if resident and profile is not None:
        safe = [c for c in cs if c <= profile.batch_knee] or cs[:1]
        return safe[0] if waiting else safe[-1]
    if resident and waiting:
        return cs[0]
    if resident:
        return cs[len(cs) // 2]
    return cs[-1]


def derive_policy(
    profiles: Dict[int, KneeProfile],
    n_slices: int,
    bucket_width: float,
) -> BatchPolicy:
    """profiles: bucket id -> knee profile for that input-length bucket."""
    assert profiles, "need at least one profiled bucket"
    batch_max = {b: p.batch_knee for b, p in profiles.items()}
    # Paper Fig.15: Time_knee is ~constant across input lengths; use median.
    knees = sorted(p.time_knee for p in profiles.values())
    time_knee = knees[len(knees) // 2]
    return BatchPolicy(
        batch_max=batch_max,
        time_queue=time_knee / max(1, n_slices),
        time_knee=time_knee,
        n_slices=n_slices,
        bucket_width=bucket_width,
    )
