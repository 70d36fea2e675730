"""Typed shed bookkeeping and the deterministic virtual-clock replay.

`ShedReason` is the enumerated vocabulary for every request that leaves the
pipeline without completing. The fault-injection harness, the dead-letter
queue and the breaker of the JAX package are not ported yet; their reasons
stay in the vocabulary so counts read the same in both packages.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Sequence

from repro_torch.core.batching.buckets import Request


class ShedReason(str, enum.Enum):
    """Why a request left the pipeline without completing. `shed` reasons
    are front-door / stage rejections a client may retry; `dead` reasons
    are terminal dead-letter verdicts the server itself gave up on."""

    SLO = "slo"                              # deadline already blown at the door
    OVERFLOW = "overflow"                    # bounded ingest full (backpressure)
    MALFORMED = "malformed"                  # structurally invalid raw payload
    PREPROCESS_ERROR = "preprocess_error"    # a DPU launch raised
    RETRIES_EXHAUSTED = "retries_exhausted"  # requeued past the per-rid budget
    POISON = "poison"                        # kept killing launches


def reason_counts(reasons: Dict[int, Any]) -> Dict[str, int]:
    """Collapse a {rid -> reason} map into {reason value -> count}."""
    out: Dict[str, int] = {}
    for why in reasons.values():
        key = why.value if isinstance(why, ShedReason) else str(why)
        out[key] = out.get(key, 0) + 1
    return out


def replay_virtual(rt, reqs: Sequence[Request], *, tick: float = 2e-3,
                   max_idle_ticks: int = 200_000) -> List[Request]:
    """Deterministic virtual-clock Poisson replay: submit each request when
    its virtual arrival passes and advance the clock by a fixed `tick` per
    iteration, so every decision is a pure function of the trace. Returns
    the completed requests."""
    i, now, idle = 0, 0.0, 0
    while i < len(reqs) or rt.busy():
        while i < len(reqs) and reqs[i].arrival <= now:
            rt.submit(reqs[i], now=now)
            i += 1
        if rt.step(now):
            idle = 0
        else:
            idle += 1
            if idle > max_idle_ticks:
                raise RuntimeError(
                    "replay wedged: no stage progressed for "
                    f"{max_idle_ticks} ticks (depths={rt.stage_summary()})")
        now += tick
    return list(rt.completed)
