"""Inference request generation: Poisson arrivals (MLPerf-style, paper §5)
with LibriSpeech-like length distribution for audio (paper Fig. 13) and
fixed-size inputs for vision.

Multi-tenant traffic: `generate_requests` also accepts a list of
`(WorkloadSpec, weight)` pairs — one independent Poisson stream per tenant,
merged by arrival time, with per-tenant rid namespacing so two tenants'
request ids never collide. The bench and the tests share this one
generator, so a "mixed trace" means the same thing everywhere.

Phase-shifting traffic: a spec may carry a tuple of `Phase`
segments — a piecewise rate/mix schedule. Arrivals follow the phase active
at the request's arrival time (burst of short requests, then a long-prompt
regime, ...), per tenant, so the partition-controller bench and its tests
replay the same regime changes from one generator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.batching.buckets import Request

# rid namespace stride for multi-tenant traces: tenant k's requests are
# rid = (k+1) * RID_NAMESPACE + i, so per-tenant ids stay dense (the
# deterministic per-rid prompt generator depends only on rid) and never
# collide across tenants for any sane trace length
RID_NAMESPACE = 1_000_000


@dataclass(frozen=True)
class Phase:
    """One segment of a piecewise traffic schedule: for `duration_s` the
    stream runs at `rate_qps` with the given length mix (None = inherit the
    spec's value). The last phase extends to the end of the trace."""
    duration_s: float
    rate_qps: float
    mean_len: Optional[float] = None
    sigma: Optional[float] = None
    max_len: Optional[float] = None


@dataclass(frozen=True)
class WorkloadSpec:
    modality: str = "audio"        # audio | image | text
    rate_qps: float = 100.0
    mean_len: float = 7.5          # audio seconds / prompt tokens
    sigma: float = 0.6             # lognormal shape (LibriSpeech-ish)
    max_len: float = 30.0
    fixed_len: float = 1.0         # for image (one unit)
    vocab: int = 0                 # text: >0 attaches real token arrays
    payload_samples: int = 0       # >0 attaches raw audio payloads (DPU work)
    seed: int = 0
    # tenant/model id stamped on every generated Request (multi-tenant
    # fleets route on it; None = single-tenant default)
    model: Optional[str] = None
    # piecewise rate/mix schedule: when set, arrivals and length
    # draws follow the phase active at the request's arrival time instead
    # of the flat spec-level rate/mix; None = flat Poisson
    phases: Optional[Tuple[Phase, ...]] = None


def _phase_at(phases: Sequence[Phase], t: float) -> Phase:
    """Phase active at absolute trace time `t` (last phase is open-ended)."""
    edge = 0.0
    for ph in phases[:-1]:
        edge += ph.duration_s
        if t < edge:
            return ph
    return phases[-1]


def _generate_phased(spec: WorkloadSpec, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential piecewise-Poisson draw: each request's inter-arrival gap
    and length come from the phase active at its arrival. One rng, one
    draw order — deterministic for a given (spec, n)."""
    assert spec.phases, spec
    rng = np.random.default_rng(spec.seed)
    arrivals = np.empty(n)
    lengths = np.empty(n)
    t = 0.0
    for i in range(n):
        ph = _phase_at(spec.phases, t)
        t += float(rng.exponential(1.0 / ph.rate_qps))
        arrivals[i] = t
        if spec.modality == "image":
            lengths[i] = spec.fixed_len
            continue
        mean = ph.mean_len if ph.mean_len is not None else spec.mean_len
        sigma = ph.sigma if ph.sigma is not None else spec.sigma
        cap = ph.max_len if ph.max_len is not None else spec.max_len
        mu = math.log(mean) - sigma**2 / 2
        lengths[i] = max(0.5, min(float(rng.lognormal(mu, sigma)), cap))
    return arrivals, lengths


def _generate_single(spec: WorkloadSpec, n: int, *,
                     rid_base: int = 0) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    if spec.phases:
        arrivals, lengths = _generate_phased(spec, n)
        # re-seed the payload/prompt stream so attachment draws below stay
        # independent of how many arrival/length draws the schedule used
        rng = np.random.default_rng(spec.seed + 1)
    else:
        gaps = rng.exponential(1.0 / spec.rate_qps, size=n)
        arrivals = np.cumsum(gaps)
        if spec.modality == "image":
            lengths = np.full(n, spec.fixed_len)
        else:
            mu = math.log(spec.mean_len) - spec.sigma**2 / 2
            lengths = np.minimum(rng.lognormal(mu, spec.sigma, size=n),
                                 spec.max_len)
            lengths = np.maximum(lengths, 0.5)
    if spec.modality == "text" and spec.vocab > 0:
        # prompt length is the unit of `length` for text — round to ints so
        # the token array matches max(1, int(length)) exactly
        lengths = np.maximum(1, np.round(lengths)).astype(np.int64)
    out = []
    for i in range(n):
        prompt = None
        payload = None
        if spec.modality == "text" and spec.vocab > 0:
            prompt = rng.integers(0, spec.vocab, int(lengths[i])).astype(np.int32)
        if spec.payload_samples > 0:
            payload = rng.standard_normal(spec.payload_samples).astype(np.float32)
        out.append(Request(rid=rid_base + i, arrival=float(arrivals[i]),
                           length=float(lengths[i]), prompt=prompt,
                           payload=payload, model=spec.model))
    return out


def _split_counts(weights: Sequence[float], n: int) -> List[int]:
    """Largest-remainder split of `n` requests across tenant weights —
    deterministic, sums to n exactly, every positive weight gets >=1 when
    n >= number of tenants."""
    total = float(sum(weights))
    assert total > 0, weights
    quotas = [w * n / total for w in weights]
    counts = [int(q) for q in quotas]
    if n >= len(weights):
        counts = [max(1, c) if w > 0 else c
                  for c, w in zip(counts, weights)]
    while sum(counts) < n:
        i = max(range(len(counts)),
                key=lambda j: (quotas[j] - counts[j], weights[j], -j))
        counts[i] += 1
    while sum(counts) > n:
        i = max((j for j in range(len(counts)) if counts[j] > 0),
                key=lambda j: (counts[j] - quotas[j], counts[j], j))
        counts[i] -= 1
    return counts


def generate_requests(
    spec: Union[WorkloadSpec, Sequence[Tuple[WorkloadSpec, float]]],
    n: int,
) -> List[Request]:
    """Poisson request stream(s).

    Single-tenant (`spec` is a WorkloadSpec): the base contract —
    rids 0..n-1, one Poisson process. Text workloads with `vocab` set carry
    REAL tokenized prompts (Request.prompt, exactly int(length) ids)
    end-to-end through the slot pool instead of relying on the engine's
    per-rid synthetic generator; `payload_samples` additionally attaches
    raw audio payloads so the preprocessing stage has actual DPU work.

    Multi-tenant (`spec` is a list of (WorkloadSpec, weight) pairs): `n`
    total requests are apportioned to tenants by weight (largest
    remainder), each tenant draws its OWN independent Poisson stream (its
    spec's seed/rate), rids live in disjoint per-tenant namespaces
    (tenant k: (k+1)*RID_NAMESPACE + i), and the merged trace is sorted by
    arrival (stable, so same-instant arrivals keep tenant order). Each
    request carries its spec's `model` id for the fleet router."""
    if isinstance(spec, WorkloadSpec):
        return _generate_single(spec, n)
    pairs = list(spec)
    assert pairs, "need at least one (WorkloadSpec, weight) pair"
    counts = _split_counts([w for _, w in pairs], n)
    merged: List[Request] = []
    for k, ((s, _), cnt) in enumerate(zip(pairs, counts)):
        merged.extend(_generate_single(s, cnt,
                                       rid_base=(k + 1) * RID_NAMESPACE))
    merged.sort(key=lambda r: r.arrival)
    return merged
