"""Per-request lifecycle tracer + exportable timelines.

Every serving layer stamps typed span events onto one shared `Tracer`:

    ingest -> preprocess_launch/preprocess_done -> offer -> dispatch ->
    admit | prefill_chunk* | prefix_scatter -> decode_segment* ->
    retire | shed | dead_letter

plus the fleet-health transitions (hedge, requeue, quarantine, readmit,
resize, fault, breaker_trip/breaker_close, cpu_fallback). Events carry the
(tenant, slice, bucket) labels plus the request id and an
open extras dict; timestamps are the CALLER's clock, so on the virtual
clock the whole timeline is a deterministic pure function of trace + fault
plan — `to_json()` serializes with sorted keys and stable ordering, and
two replays of the same seed must export byte-identical files (a CI gate).

Export formats: `to_chrome_trace()` emits Chrome trace-event JSON
(load in chrome://tracing or Perfetto; slices lane per `tid`), and
`events` is the raw typed stream for programmatic checks. The tracer is
bounded (`max_events`, drop-counted) so a long soak cannot grow without
limit — it is a telemetry stream, not a log.
"""
from __future__ import annotations

import json
from typing import List, Optional

# -- span kinds (the typed lifecycle vocabulary) ----------------------------
INGEST = "ingest"
PREPROCESS_LAUNCH = "preprocess_launch"
PREPROCESS_DONE = "preprocess_done"
PREPROCESS_FAIL = "preprocess_fail"
OFFER = "offer"                    # admission queue accepted the request
DISPATCH = "dispatch"              # fleet handed the request to a slice
ADMIT = "admit"                    # monolithic prefill+admit into a slot
PREFILL_CHUNK = "prefill_chunk"    # one chunked-prefill step
PREFIX_SCATTER = "prefix_scatter"  # cached-prefix K/V scattered into slots
DECODE_SEGMENT = "decode_segment"  # one segment_len decode scan
RETIRE = "retire"
SHED = "shed"
DEAD_LETTER = "dead_letter"
HEDGE = "hedge"
REQUEUE = "requeue"
QUARANTINE = "quarantine"
READMIT = "readmit"
RESIZE = "resize"
RECONFIG = "reconfig"              # partition controller repartitioned
FAULT = "fault"                    # injector fired a FaultEvent
BREAKER_TRIP = "breaker_trip"
BREAKER_CLOSE = "breaker_close"
CPU_FALLBACK = "cpu_fallback"

SPAN_KINDS = (
    INGEST, PREPROCESS_LAUNCH, PREPROCESS_DONE, PREPROCESS_FAIL, OFFER,
    DISPATCH, ADMIT, PREFILL_CHUNK, PREFIX_SCATTER, DECODE_SEGMENT, RETIRE,
    SHED, DEAD_LETTER, HEDGE, REQUEUE, QUARANTINE, READMIT, RESIZE, RECONFIG,
    FAULT, BREAKER_TRIP, BREAKER_CLOSE, CPU_FALLBACK,
)


class SpanEvent:
    """One typed lifecycle event: kind + timestamp + (tenant, slice,
    bucket) labels + optional duration and extras."""

    __slots__ = ("seq", "t", "kind", "rid", "tenant", "sid", "bucket",
                 "dur", "extra")

    def __init__(self, seq: int, t: float, kind: str, rid=None, tenant=None,
                 sid=None, bucket=None, dur: Optional[float] = None,
                 extra=None):
        self.seq = seq
        self.t = t
        self.kind = kind
        self.rid = rid
        self.tenant = tenant
        self.sid = sid
        self.bucket = bucket
        self.dur = dur
        self.extra = extra

    def to_json(self) -> dict:
        d = {"seq": self.seq, "t": round(self.t, 9), "kind": self.kind}
        for k in ("rid", "tenant", "sid", "bucket"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.dur is not None:
            d["dur"] = round(self.dur, 9)
        if self.extra:
            d.update(self.extra)
        return d

    def __repr__(self) -> str:
        return f"SpanEvent({self.to_json()!r})"


class Tracer:
    """Bounded, append-only lifecycle event stream shared by every layer
    of one pipeline (the composing layer injects itself via set_tracer)."""

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self.events: List[SpanEvent] = []
        self.dropped = 0
        self._seq = 0

    def event(self, kind: str, t: float, *, rid=None, tenant=None, sid=None,
              bucket=None, dur: Optional[float] = None, **extra) -> None:
        self._seq += 1
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(SpanEvent(
            self._seq, float(t), kind, rid=rid, tenant=tenant,
            sid=None if sid is None else str(sid), bucket=bucket, dur=dur,
            extra=extra or None))

    def reset(self) -> None:
        """Clear the stream (the registry reset hook calls this at the
        warmup boundary, so exported timelines start at the measured
        window)."""
        self.events.clear()
        self.dropped = 0
        self._seq = 0

    def counts(self) -> dict:
        out: dict = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def of(self, *kinds: str) -> List[SpanEvent]:
        want = set(kinds)
        return [e for e in self.events if e.kind in want]

    # -- exporters ---------------------------------------------------------
    def to_chrome_trace(self, t0: Optional[float] = None) -> dict:
        """Chrome trace-event / Perfetto JSON. Point events render as
        instants, events carrying `dur` as complete ('X') slices; one lane
        (tid) per slice id, lane 0 for fleet-level events. Timestamps are
        rebased to the first event (or `t0`) in microseconds."""
        if t0 is None:
            t0 = self.events[0].t if self.events else 0.0
        out = []
        lanes: dict = {}
        for e in self.events:
            lane = 0
            if e.sid is not None:
                lane = lanes.setdefault(e.sid, len(lanes) + 1)
            args = {k: v for k, v in e.to_json().items()
                    if k not in ("seq", "t", "kind", "dur")}
            ts = round(1e6 * (e.t - t0), 3)
            ev = {"name": e.kind, "cat": "serving", "pid": 0, "tid": lane,
                  "ts": ts, "args": args}
            if e.dur is not None:
                ev["ph"] = "X"
                ev["dur"] = round(1e6 * e.dur, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            out.append(ev)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": lane,
             "args": {"name": f"slice {sid}"}}
            for sid, lane in sorted(lanes.items(), key=lambda kv: kv[1])
        ]
        meta.insert(0, {"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": 0, "args": {"name": "fleet"}})
        return {"traceEvents": meta + out,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "event_count": len(self.events)}}

    def to_json(self, t0: Optional[float] = None) -> str:
        """Deterministic serialization of the Chrome trace: sorted keys,
        fixed separators — byte-identical across replays of the same
        virtual-clock trace + plan (a CI regression gate)."""
        return json.dumps(self.to_chrome_trace(t0), sort_keys=True,
                          separators=(",", ":"))
