"""Multi-slice real execution: the paper's system shape on the real engine.

PREBA's core claim is that a MIG GPU reconfigured into many small slices,
each running its own inference replica behind a shared dynamic batcher,
beats one monolithic GPU. This module composes:

  core/slicing/mig.partition_pod   -> V disjoint slices (PodSlice), each
                                      with its device and its own CUDA
                                      stream
  serving/engine.ServingEngine     -> one continuous-batching engine PER
                                      slice (own KV slot pool allocated on
                                      the slice's stream, own shape caches);
                                      the slices of a tenant on one card
                                      serve that tenant's ONE LM there,
                                      uncopied
  core/batching SliceScheduler     -> REQUEST -> slice dispatch tracking
                                      with per-request straggler hedging
                                      and failure/resize requeue

On one GPU without MIG instances the V slices are logical replicas that
share every SM of the card (`replicated`); each issues its work on its own
stream. Such a fleet says nothing about MIG isolation. Over several cards
(`devices=["cuda:0", "cuda:1", ...]`) each slice serves on its first card
(`PodSlice.device`), and each tenant's weights are replicated once onto
every card one of its slices serves on (`_weights_on`; the JAX package
places them on the slice's mesh, `_params_for`): one copy a (tenant,
card), made at the first build that needs it and kept across resizes,
so a card never holds a tenant's weights twice. A slice on the card
that holds the weights serves them as they are.

THE SLICE IS THE UNIT OF TENANCY. A fleet hosts one or more tenants, each
a (model config, weights, policy, EngineConfig) bundle with its own slice
ask; `rebalance_slices` (core/slicing/mig.py) apportions the pod's slices
between tenants and `plan_placement` accounts the units (fragmentation is
measured, never hidden). Every slice's engine is built for ITS tenant, so
two models share one pod and ONE admission queue without sharing a slot
pool. A model ROUTER at the front door (`route`) stamps every Request with
its tenant's model id; from there tenancy is structural: bucket queues,
admission groups, DPU launch groups, and slice routing are all keyed by
model, and `_send` raises on any cross-tenant dispatch rather than serving
a request on the wrong weights. The single-tenant construction (one
cfg/params/policy) is the one-tenant special case of the same machinery.

Admission is ONE shared queue — and dispatch is REQUEST -> SLOT streaming:
`submit_many` runs one batched `DPU.process_batch` preprocessing pass per
tenant group, the shared `BucketedBatcher` forms knee-driven batches
(per-tenant policies, tenant-pure queues), the shared `SlotScheduler`
keeps an EDF backlog with per-tenant slot quotas, and each `step()`
streams individual due requests into whichever of THEIR TENANT'S slices
has free slot capacity (least-loaded by `slots_in_use() +
admission_depth()`). Later admission groups join a busy slice's pool
mid-flight. `dispatch="batch"` — a slice only receives work when fully
idle — is the baseline.

Per-request semantics (contract in core/batching/scheduler.py):

* straggler hedging — a REQUEST past `hedge_factor x` its expected
  execution time on a slice is cloned (`dataclasses.replace`, so the two
  engines never race on shared Request fields) onto another slice of its
  OWN tenant with a free slot; the first copy to complete wins, the loser
  is cancelled mid-flight (`ServingEngine.cancel`), and results are
  recorded exactly once per rid. Outputs are the same either way: prompts
  are deterministic per rid and decode is greedy.
* `fail_slice` — evicts a slice; each of its in-flight requests is
  requeued into the shared admission backlog UNLESS a hedge twin still
  runs it elsewhere. A requeued request redispatches only onto its own
  tenant's slices. Cancellation releases the victims' prefix-store leases.
* `resize` — elastic reconfiguration mid-trace: cancel in-flight work,
  re-partition, RE-BALANCE the new slice count between tenants
  (largest-remainder over their original asks, every tenant keeping >= 1
  slice), rebuild each slice's engine for its newly assigned tenant, and
  requeue every in-flight request (hedge pairs deduped by rid).

Failure semantics (detect -> quarantine -> probe -> readmit):

* retry budget — every failure/resize requeue charges the rid's budget in
  `SliceScheduler.note_requeue` (counts survive resize); past
  `max_retries` the request is DEAD-LETTERED into `self.dead` with a
  typed reason, and with `retry_backoff_s` a requeued rid is held out of
  dispatch until its exponential backoff expires.
* watchdog — with `watchdog_rounds > 0`, a slice that stays busy without
  its engine advancing for that many consecutive dispatch rounds (a
  SILENT hang) is quarantined through the same `fail_slice` path.
* probe / readmit — with `probe_interval_s > 0`, every evicted slice is
  probed periodically; once the probe succeeds, `readmit_slice` rebuilds
  its engine from scratch — FOR THE TENANT THAT OWNS THE SLICE — with an
  EMPTY prefix store and a fresh slot pool, and the slice rejoins dispatch.

Chunked prefill and the radix prefix cache compose as in the engine; with
per-slice prefix stores, stream dispatch is PREFIX-AFFINE WITHIN THE
TENANT (`_pick_slice_for`).

Launch accounting: every decode step runs the decode-attention kernel once
per layer, and engines are replaced by resize, readmit and the warm
partition cache, so `decode_steps_total()` sums over every engine built
since the last metrics reset, not only the live ones.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace as dc_replace
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.batching.buckets import BucketedBatcher, Request, next_pow2
from repro_torch.core.batching.policy import BatchPolicy
from repro_torch.core.batching.scheduler import SliceScheduler, SlotScheduler
from repro_torch.core.dpu.runtime import DPU, DpuConfig
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.slicing.mig import (
    PlacementAsk, PodSlice, SlicedPod, SliceSpec, partition_pod,
    plan_placement, rebalance_slices, slice_name,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models.api import LM
from repro_torch.models.params import tree_map
from repro_torch.serving import telemetry as tm
from repro_torch.serving.engine import (
    EngineConfig, ServingEngine, enqueue_requests,
)
from repro_torch.serving.faults import ShedReason


def _slice_pod(devices: Sequence, n_slices: int):
    """Partition `devices` into `n_slices` slices. When there are fewer
    devices than slices (one card), fall back to `n_slices` logical
    replicas that share the whole device set. Returns (pod, replicated)."""
    devs = np.asarray(devices, dtype=object).reshape(-1)
    n_slices = max(1, int(n_slices))
    if devs.size >= n_slices:
        pod = partition_pod(devs, devs.size // n_slices)
        if len(pod.slices) > n_slices:
            # keep exactly n_slices; whole spare slices count as stranded
            extra = sum(s.devices.size for s in pod.slices[n_slices:])
            cps = pod.spec.chips_per_slice
            pod = SlicedPod(
                spec=SliceSpec(slice_name(cps, n_slices), cps, n_slices),
                slices=pod.slices[:n_slices],
                stranded_chips=pod.stranded_chips + extra,
            )
        return pod, False
    slices = [PodSlice(i, devs.copy()) for i in range(n_slices)]
    spec = SliceSpec(slice_name(devs.size, n_slices), int(devs.size), n_slices)
    return SlicedPod(spec=spec, slices=slices, stranded_chips=0), True


def _card(dev) -> torch.device:
    """`dev` with its index: a bare "cuda" is the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _as_model(cfg: ModelConfig, params) -> LM:
    return params if isinstance(params, LM) else LM(cfg, params)


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's ask for `build_multislice_engine(tenants=...)`: which
    model, how many slices, and how its engines are configured.

    `name` defaults to `cfg.name` (two tenants serving the same config must
    pass distinct names). `params=None` draws seeded weights from `seed`
    exactly like the single-tenant builder, so a tenant's fleet outputs
    equal a single-slice engine built with the same seed. `ec=None`
    inherits the fleet-default EngineConfig. `chips_per_slice > 0` is a
    right-sizing CONSTRAINT: the builder rejects a partitioning whose
    uniform slice is smaller than the ask. `slo_s` is the tenant's SLO
    class — the pipelined runtime's front-door shed uses it per request."""

    cfg: ModelConfig
    name: str = ""
    n_slices: int = 1
    seed: int = 0
    params: Any = None
    ec: Optional[EngineConfig] = None
    slo_s: float = math.inf
    chips_per_slice: int = 0

    @property
    def tenant_name(self) -> str:
        return self.name or self.cfg.name


@dataclass
class _Tenant:
    """One tenant, fully resolved: everything a slice engine build needs
    (its one LM, shared by every slice it owns) plus the fleet-level
    knobs keyed off the tenant (slice ask for rebalance, chunking truth for
    hedging budgets, SLO class)."""

    name: str
    cfg: ModelConfig
    model: LM
    policy: BatchPolicy
    ec: EngineConfig
    chunked: bool
    knee_profiles: Dict[int, Any] = field(default_factory=dict)
    slo_s: float = math.inf
    n_slices_ask: int = 1


@dataclass
class _ReqTrack:
    """One in-flight request's copies. `req` is always the ORIGINAL request
    object; a hedge twin executes a clone (`copies[twin_sid]`) so the two
    engines never race on the same Request fields."""

    req: Request
    primary_sid: int
    copies: Dict[int, Request]


class MultiSliceEngine:
    """V per-slice continuous-batching engines behind one admission queue;
    individual requests stream into any of THEIR TENANT'S slices with free
    slot capacity (per-request hedging / failure / elastic resize via
    `SliceScheduler`, all tenant-constrained). Single-tenant construction
    (cfg, params, policy) is the one-tenant case. `params` is a weight
    tree or an LM; `device` is where the slices serve (default the
    card; a CUDA device that is not there raises)."""

    def __init__(self, cfg: Optional[ModelConfig] = None, params=None,
                 policy: Optional[BatchPolicy] = None,
                 ec: Optional[EngineConfig] = None, *, n_slices: int,
                 tenants: Optional[Sequence[_Tenant]] = None,
                 device: DeviceLike = "cuda",
                 devices: Optional[Sequence] = None,
                 hedge_factor: float = 3.0, dispatch: str = "stream",
                 knee_profiles: Optional[Dict[int, Any]] = None,
                 max_retries: int = 3, retry_backoff_s: float = 0.0,
                 watchdog_rounds: int = 0, probe_interval_s: float = 0.0):
        if dispatch not in ("stream", "batch"):
            raise ValueError(f"unknown dispatch mode {dispatch!r}")
        self.device = resolve_device(device)
        if tenants is None:
            # single-tenant construction: wrap the trio into the one tenant
            # the fleet hosts (same machinery, one special case)
            if cfg is None or policy is None or params is None:
                raise ValueError("pass (cfg, params, policy) or tenants=")
            ec = EngineConfig() if ec is None else ec
            tenants = [_Tenant(
                name=getattr(cfg, "name", "default"), cfg=cfg,
                model=_as_model(cfg, params), policy=policy, ec=ec,
                chunked=bool(ec.chunk_lens) and lm.supports_chunked_prefill(cfg),
                knee_profiles=knee_profiles or {}, n_slices_ask=n_slices,
            )]
        tenants = list(tenants)
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self._tenants: Dict[str, _Tenant] = {t.name: t for t in tenants}
        self._default = tenants[0]
        # fleet-level aliases = the first tenant's view (single-tenant
        # telemetry reads these; multi-tenant code paths go through
        # _tenant_of / ec_for_model instead)
        self.cfg = self._default.cfg
        self.model = self._default.model
        self.policy = self._default.policy
        self.ec = self._default.ec
        self._chunked = self._default.chunked
        self._knee_profiles = self._default.knee_profiles
        self.hedge_factor = hedge_factor
        self.dispatch_mode = dispatch
        self._devices = ([self.device] if devices is None
                         else [resolve_device(d) for d in devices])
        self.dpu = (DPU(DpuConfig(), self.device)
                    if any(t.ec.preprocess == "dpu" for t in tenants) else None)
        self.batcher = BucketedBatcher(
            self._default.policy,
            policy_for={t.name: t.policy for t in tenants},
        )
        self.completed: List[Request] = []
        self._done_rids: Set[int] = set()
        # dead-letter queue: requests that exhausted their retry budget —
        # terminal, typed-reason, drained by the pipelined runtime into its
        # own `dead` list (conservation: completed + shed + dead == submitted)
        self.dead: List[Request] = []
        self.dead_reasons: Dict[int, ShedReason] = {}
        # failure-semantics knobs: bounded total retries per rid (with
        # optional exponential backoff), silent-hang detection after
        # watchdog_rounds busy-no-advance rounds (0 = off), and periodic
        # probing / re-admission of evicted slices (0 = off, permanent
        # eviction)
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.watchdog_rounds = watchdog_rounds
        self.probe_interval_s = probe_interval_s
        self._stall_rounds: Dict[int, int] = {}
        self._quarantined: Dict[int, float] = {}  # sid -> next probe time
        # fleet registry: per-slice engine registries attach as children on
        # every (re)build, so ONE reset() clears the whole fleet's counters
        # at the warmup boundary; the tracer is shared downward into every
        # slice engine (one lifecycle timeline per fleet)
        self.registry = MetricsRegistry("multislice")
        self.tracer = tm.Tracer()
        self._virtual = False
        self.registry.on_reset(self._reset_state)
        self.stats = self.registry.view("fleet", (
            "dispatched", "hedge_wins", "cancelled",
            "requeued", "resizes", "dpu_batches",
            "quarantined", "readmitted", "dead_lettered",
        ))
        self._hedges_base = 0
        self._seg_ema: Optional[float] = None
        self._tenant_ema: Dict[str, float] = {}
        self._exec_seen: Dict[int, int] = {}
        # every engine built since the last metrics reset, live or not: the
        # decode kernel's launches are n_layers x their summed decode steps
        self._built: List[ServingEngine] = []
        # --- test/chaos injection knobs ---
        # slices listed here skip their engine step (a hung device): the
        # straggler detector must hedge their requests onto a healthy twin
        self.stalled_slices: Set[int] = set()
        # override the per-request expected execution time used for straggler
        # detection (None = analytic chunk/segment count * EMA of measured
        # execution times)
        self.fixed_expected_s: Optional[float] = None
        # warm partition cache: drained engine generations are stashed per
        # (n_slices, slice->tenant map) on resize, so a switch BACK to a
        # configuration served before restores the engines — shape caches
        # and slot pools intact — instead of rebuilding them
        self._engine_cache: Dict[Any, Dict[int, ServingEngine]] = {}
        self._gen_key: Any = None
        # each tenant's weights on the other cards its slices serve on:
        # (tenant, card) -> LM, one copy each, kept across resizes
        self._replicas: Dict[Any, LM] = {}
        self._build(n_slices)

    # --- tenancy -------------------------------------------------------------
    def tenant_names(self) -> List[str]:
        return list(self._tenants)

    def _tenant_by(self, model: Optional[str]) -> _Tenant:
        if model is None:
            if len(self._tenants) > 1:
                raise ValueError(
                    f"request has no model; fleet hosts {sorted(self._tenants)}"
                )
            return self._default
        t = self._tenants.get(model)
        if t is None:
            raise ValueError(
                f"unknown model {model!r}; fleet hosts {sorted(self._tenants)}"
            )
        return t

    def _tenant_of(self, r: Request) -> _Tenant:
        return self._tenant_by(getattr(r, "model", None))

    def ec_for_model(self, model: Optional[str]) -> EngineConfig:
        """Per-tenant EngineConfig (the pipelined runtime's validation and
        service-time estimates are per tenant, not per fleet)."""
        return self._tenant_by(model).ec

    def slo_for_model(self, model: Optional[str]) -> float:
        """Tenant SLO class (seconds; inf = no per-tenant SLO)."""
        return self._tenant_by(model).slo_s

    def chunked_for_model(self, model: Optional[str]) -> bool:
        """Whether this tenant's slice engines really chunk prefill (its
        chunk_lens AND its model family's gate)."""
        return self._tenant_by(model).chunked

    def slices_of(self, model: str) -> List[int]:
        return [sid for sid, name in sorted(self.slice_tenant.items())
                if name == model]

    def route(self, reqs: Sequence[Request]) -> Sequence[Request]:
        """Model router at the fleet front door: stamp every request with
        its tenant's model id (single-tenant fleets default-route; a
        multi-tenant fleet REQUIRES the submitter to say which model) and
        reject unknown models before any queue sees the request. Runs
        inside submit_many/offer, so no admission path can skip it."""
        for r in reqs:
            m = getattr(r, "model", None)
            if m is None:
                if len(self._tenants) > 1:
                    raise ValueError(
                        f"request {r.rid} has no model; fleet hosts "
                        f"{sorted(self._tenants)}"
                    )
                r.model = self._default.name
            elif m not in self._tenants:
                raise ValueError(
                    f"request {r.rid} asks for unknown model {m!r}; fleet "
                    f"hosts {sorted(self._tenants)}"
                )
        return reqs

    # --- construction / elastic re-slice -----------------------------------
    def _build(self, n_slices: int) -> None:
        # detach the previous generation's engine registries (resize rebuilds
        # every engine): a rebuilt slice starts from fresh counters, and the
        # stale series must not linger as duplicates under the fleet root
        outgoing = dict(getattr(self, "engines", {}))
        for e in outgoing.values():
            self.registry.detach(e.registry)
        # stash the outgoing generation in the warm partition cache IF it is
        # fully drained (resize cancels every in-flight request and drains
        # the backlog before rebuilding); an engine still holding slots or
        # prefix leases would smuggle live state across a re-slice, so any
        # residue voids the stash
        if outgoing and self._gen_key is not None and all(
                not e.busy() and e.prefix_lease_count() == 0
                for e in outgoing.values()):
            self._engine_cache[self._gen_key] = outgoing
        self.pod, self.replicated = _slice_pod(self._devices, n_slices)
        # slice -> tenant assignment: largest-remainder apportionment over
        # the tenants' original asks (>=1 slice each), contiguous runs in
        # tenant declaration order; the placement pass accounts every unit
        counts = rebalance_slices(
            len(self.pod.slices),
            {t.name: t.n_slices_ask for t in self._tenants.values()},
        )
        self.slice_tenant: Dict[int, str] = {}
        cursor = 0
        for t in self._tenants.values():
            for _ in range(counts[t.name]):
                self.slice_tenant[cursor] = t.name
                cursor += 1
        cps = self.pod.spec.chips_per_slice if not self.replicated else 1
        pod_chips = (len(self._devices) if not self.replicated
                     else len(self.pod.slices))
        self.placement = plan_placement(pod_chips, [
            PlacementAsk(t.name, counts[t.name], cps)
            for t in self._tenants.values()
        ])
        # per-slice slot capacity comes from the OWNING tenant's config
        self._cap: Dict[int, int] = {
            sid: self._tenants[name].ec.max_slots
            for sid, name in self.slice_tenant.items()
        }
        self.sched = SliceScheduler(len(self.pod.slices),
                                    hedge_factor=self.hedge_factor,
                                    max_retries=self.max_retries,
                                    retry_backoff_s=self.retry_backoff_s)
        self._stall_rounds = {}
        self._quarantined = {}
        # global admission capacity = every slice's slot pool
        self.slot_scheduler = SlotScheduler(
            self.policy, max_slots=sum(self._cap.values()),
            segment_len=self.ec.segment_len, segment_lens=self.ec.segment_lens,
        )
        # warm partition cache hit: a configuration served before restores
        # its drained engines — shape caches, slot pools and prefix-store
        # contents intact. Restore re-applies the ambient virtual-clock
        # mode, re-attaches the engine registries (their counters resume
        # where they left off; readers diff), and fast-forwards the
        # exec-sample drain marks so pre-stash timings are not re-ingested
        # into the hedging EMA. Each restored slice takes its engine's
        # stream, so the pool stays on the stream it was allocated on.
        self._gen_key = (n_slices, tuple(sorted(self.slice_tenant.items())))
        cached = self._engine_cache.pop(self._gen_key, None)
        if cached is not None and set(cached) == {
                ps.slice_id for ps in self.pod.slices}:
            self.engines: Dict[int, ServingEngine] = cached
            for ps in self.pod.slices:
                ps.stream = cached[ps.slice_id].stream
            for e in self.engines.values():
                e.completed = []
                e._virtual = self._virtual
                self.registry.attach(e.registry)
            self._exec_seen = {sid: len(e.batch_exec_s)
                               for sid, e in self.engines.items()}
        else:
            for ps in self.pod.slices:
                if ps.device.type == "cuda":
                    ps.stream = torch.cuda.Stream(ps.device)
            self.engines = {
                ps.slice_id: self._make_engine(ps) for ps in self.pod.slices
            }
            self._exec_seen = {}
        # routing audit per build (slice ids change meaning on resize):
        # model -> every slice id that ever received one of its requests.
        # _send raises on a cross-tenant dispatch, so this records where
        # requests actually ran.
        self.routes: Dict[str, Set[int]] = {name: set()
                                            for name in self._tenants}
        self._inflight: Dict[int, _ReqTrack] = {}

    def _make_engine(self, ps: PodSlice) -> ServingEngine:
        # per-slice engines are always continuous (own slot pool, chunk_lens
        # inherited) and are built for the tenant that OWNS the slice, on
        # the slice's device and stream; preprocessing already happened
        # once at the shared queue, and batch formation too — their
        # internal batcher is a pass-through
        t = self._tenants[self.slice_tenant[ps.slice_id]]
        model = self._weights_on(t, ps.device)
        ec_s = dc_replace(t.ec, continuous=True, preprocess="none")
        pol = dc_replace(t.policy, time_queue=0.0)
        e = ServingEngine(t.cfg, model, pol, ec_s, device=ps.device,
                          knee_profiles=t.knee_profiles, tracer=self.tracer,
                          slice_id=ps.slice_id, tenant=t.name, stream=ps.stream)
        e._virtual = self._virtual
        self.registry.attach(e.registry)
        self._built.append(e)
        return e

    def _weights_on(self, t: _Tenant, dev: torch.device) -> LM:
        """Tenant t's weights on `dev`: its own LM where they live there,
        else its replica on that card, copied at the first call and kept
        (resize and readmit reuse it). Weights on a device the fleet does
        not use raise."""
        home = _card(t.model.tree()["embed"].device)
        dev = _card(dev)
        if home not in {_card(d) for d in self._devices}:
            raise ValueError(f"tenant {t.name!r}'s weights live on {home}, which this "
                             f"fleet ({[str(d) for d in self._devices]}) does not use")
        if dev == home:
            return t.model
        key = (t.name, str(dev))
        if key not in self._replicas:
            self._replicas[key] = LM(t.cfg, tree_map(lambda a: a.to(dev), t.model.tree()))
        return self._replicas[key]

    def weights_by_device(self) -> Dict[str, Dict[str, LM]]:
        """card -> {tenant: the LM its slices there serve}: each tenant's
        own weights on their card and its replicas on the others."""
        out: Dict[str, Dict[str, LM]] = {}
        for t in self._tenants.values():
            out.setdefault(str(_card(t.model.tree()["embed"].device)), {})[t.name] = t.model
        for (name, dev), model in self._replicas.items():
            out.setdefault(dev, {})[name] = model
        return out

    @property
    def hedges(self) -> int:
        return self._hedges_base + self.sched.hedges

    def resize(self, n_slices: Optional[int] = None, *,
               chips_per_slice: Optional[int] = None,
               now: Optional[float] = None) -> int:
        """Elastic re-slice mid-trace: cancel in-flight work, re-partition,
        RE-BALANCE the new slice count between tenants (each slice's engine
        is rebuilt for the tenant the placement pass assigns it), and
        requeue every in-flight request (hedge copies dedupe by rid — tracks
        hold one original each; each request redispatches onto its own
        tenant's new slices). Each requeue charges the rid's retry budget —
        carried across the scheduler rebuild — and a rid past its budget
        dead-letters instead (a mid-resize abort that re-slices straight
        back must not launder unlimited retries). Returns the number of
        requeued requests."""
        if (n_slices is None) == (chips_per_slice is None):
            raise ValueError("pass exactly one of n_slices / chips_per_slice")
        now = time.monotonic() if now is None else now
        if n_slices is None:
            n_slices = max(1, len(self._devices) // max(1, chips_per_slice))
        if n_slices < len(self._tenants):
            raise ValueError(
                f"cannot re-slice to {n_slices} slices: fleet hosts "
                f"{len(self._tenants)} tenants (each keeps >= 1 slice)"
            )
        carry: List[Request] = []
        dead: List[Request] = []
        for tr in self._inflight.values():
            if self.sched.note_requeue(tr.req.rid, now):
                carry.append(tr.req)
            else:
                dead.append(tr.req)
        rids = set(self._inflight)
        for sid, e in self.engines.items():
            self.stats["cancelled"] += e.cancel(rids)
        # the shared admission backlog holds requests already pulled out of
        # the batcher but not yet dispatched — carry them across the
        # scheduler rebuild or they would simply vanish
        backlog = self.slot_scheduler.drain()
        self._hedges_base += self.sched.hedges
        old_sched = self.sched
        self._build(n_slices)
        self.sched.adopt_retries(old_sched)
        for r in dead:
            self._dead_letter(r, ShedReason.RETRIES_EXHAUSTED, now)
        self.slot_scheduler.requeue(carry + backlog)
        self.stats["resizes"] += 1
        self.stats["requeued"] += len(carry)
        self.tracer.event(tm.RESIZE, now, n_slices=n_slices,
                          requeued=len(carry))
        return len(carry)

    def fail_slice(self, slice_id: int,
                   now: Optional[float] = None) -> List[Request]:
        """Evict a slice (explicit loss signal / watchdog quarantine): cancel
        its engine's work — `ServingEngine.cancel` releases the victims'
        prefix-store leases; each in-flight request is requeued into the
        shared backlog unless a hedge twin still runs it elsewhere. A
        requeued request re-enters dispatch tenant-constrained. Every
        requeue charges the rid's retry budget; past the budget it
        dead-letters. With probing enabled the slice enters the quarantine
        loop (probe -> readmit once healed). Returns the requeued
        requests."""
        now = time.monotonic() if now is None else now
        requeue_rids = self.sched.fail_slice(slice_id)
        self.pod.fail(slice_id)
        victims = [rid for rid, tr in self._inflight.items()
                   if slice_id in tr.copies]
        if victims:
            self.stats["cancelled"] += self.engines[slice_id].cancel(victims)
        requeued: List[Request] = []
        for rid in victims:
            tr = self._inflight[rid]
            tr.copies.pop(slice_id, None)
            if rid in requeue_rids:
                del self._inflight[rid]
                if self.sched.note_requeue(rid, now):
                    requeued.append(tr.req)
                else:
                    self._dead_letter(tr.req, ShedReason.RETRIES_EXHAUSTED,
                                      now)
        if requeued:
            self.slot_scheduler.requeue(requeued)
            self.stats["requeued"] += len(requeued)
            self.tracer.event(tm.REQUEUE, now, sid=slice_id,
                              rids=[r.rid for r in requeued])
        self._stall_rounds.pop(slice_id, None)
        if self.probe_interval_s > 0 and slice_id not in self._quarantined:
            self._quarantined[slice_id] = now + self.probe_interval_s
            self.stats["quarantined"] += 1
            self.tracer.event(tm.QUARANTINE, now, sid=slice_id)
        return requeued

    def recover_slice(self, slice_id: int) -> None:
        self.sched.recover_slice(slice_id)
        self.pod.recover(slice_id)
        self._quarantined.pop(slice_id, None)
        self._stall_rounds.pop(slice_id, None)

    def readmit_slice(self, slice_id: int,
                      now: Optional[float] = None) -> None:
        """Re-admit a healed slice: rebuild its engine from scratch FOR THE
        TENANT THAT OWNS THE SLICE (fresh shape caches, a fresh slot pool on
        the slice's stream and an EMPTY prefix store — cached K/V lives on
        a device we just declared unreliable) and rejoin dispatch."""
        now = time.monotonic() if now is None else now
        ps = next(p for p in self.pod.slices if p.slice_id == slice_id)
        old = self.engines.get(slice_id)
        if old is not None:  # stale series must not shadow the rebuild's
            self.registry.detach(old.registry)
        self.engines[slice_id] = self._make_engine(ps)
        self._exec_seen[slice_id] = 0
        self.sched.recover_slice(slice_id)
        self.pod.recover(slice_id)
        self._quarantined.pop(slice_id, None)
        self._stall_rounds.pop(slice_id, None)
        self.stats["readmitted"] += 1
        self.tracer.event(tm.READMIT, now, sid=slice_id)

    def _probe_slice(self, slice_id: int) -> bool:
        """Health probe for a quarantined slice. The default models a device
        liveness check: healed unless an injected stall window still holds
        it (FaultInjector keeps `stalled_slices` populated for the fault's
        duration)."""
        return slice_id not in self.stalled_slices

    def _check_quarantine(self, now: float) -> bool:
        did = False
        for sid in sorted(self._quarantined):
            if now < self._quarantined[sid]:
                continue
            if self._probe_slice(sid):
                self.readmit_slice(sid, now)
                did = True
            else:
                self._quarantined[sid] = now + self.probe_interval_s
        return did

    def _dead_letter(self, req: Request, reason: ShedReason,
                     now: Optional[float] = None) -> None:
        """Terminal verdict for a request that exhausted its retry budget:
        record it in the dead-letter queue with a typed reason, drop its
        retry bookkeeping, and cancel any residual copy on any engine —
        cancellation releases prefix leases, so a dead rid never leaves a
        ghost pin."""
        self.dead.append(req)
        self.dead_reasons[req.rid] = reason
        self.sched.forget(req.rid)
        self._inflight.pop(req.rid, None)
        for e in self.engines.values():
            self.stats["cancelled"] += e.cancel([req.rid])
        self.stats["dead_lettered"] += 1
        self.tracer.event(
            tm.DEAD_LETTER, time.monotonic() if now is None else now,
            rid=req.rid, tenant=getattr(req, "model", None),
            reason=reason.value)

    # --- shared admission queue --------------------------------------------
    def submit(self, req: Request) -> None:
        self.submit_many([req])

    def submit_many(self, reqs: List[Request]) -> None:
        """Route, then one batched DPU preprocessing pass PER TENANT GROUP
        (each tenant's requests validate against ITS EngineConfig and form
        their own DPU launch group), then enqueue into the shared batcher
        (same contract as ServingEngine)."""
        self.route(reqs)
        groups: Dict[str, List[Request]] = {}
        for r in reqs:
            groups.setdefault(r.model, []).append(r)
        for name, group in groups.items():
            enqueue_requests(group, ec=self._tenants[name].ec, dpu=self.dpu,
                             batcher=self.batcher, stats=self.stats,
                             validate_prompts=True)

    def offer(self, reqs: List[Request]) -> None:
        """Stage-pipelined admission intake (serving/runtime.py): already-
        preprocessed requests join the shared SlotScheduler's EDF backlog
        directly (routed first — tenancy must be stamped before quota
        accounting sees the request); _dispatch() streams them into slice
        slots as capacity frees."""
        self.route(reqs)
        self.slot_scheduler.offer(reqs)

    def admission_depth(self) -> int:
        """Requests waiting for a KV slot anywhere (shared batcher + shared
        backlog + per-slice admission backlogs of requests already streamed
        to a slice but not yet in a slot) — the pipelined runtime's
        backpressure signal for this stage."""
        return (self.batcher.pending() + self.slot_scheduler.depth()
                + sum(e.admission_depth() for e in self.engines.values()))

    def busy(self) -> bool:
        return bool(
            self.batcher.pending() or self.slot_scheduler.backlog()
            or self._inflight or any(e.busy() for e in self.engines.values())
        )

    # --- serve loop ---------------------------------------------------------
    def step(self, now: Optional[float] = None) -> bool:
        """One global iteration: stream due requests into slices with free
        slot capacity, advance every busy slice engine one admit/chunk/
        segment iteration, harvest completions, and hedge stragglers.
        Returns True if anything moved."""
        now = time.monotonic() if now is None else now
        progressed = self._check_quarantine(now) if self._quarantined else False
        progressed |= self._dispatch(now)
        progressed |= self._advance(now)
        self._check_hedges(now)
        return progressed

    def run_until_idle(self) -> List[Request]:
        while self.busy():
            if not any(s.healthy for s in self.sched.slices.values()) \
                    and not self._quarantined:
                raise RuntimeError("work pending but every slice has failed")
            if not self.step():
                deadline = self.batcher.next_deadline()
                self.step(deadline if deadline is not None
                          else time.monotonic())
        return self.completed

    def next_wakeup(self) -> Optional[float]:
        """Earliest self-driven future transition (quarantine probe or retry
        backoff expiry) — the virtual-clock runtime's idle-jump hint."""
        ts = list(self._quarantined.values())
        t = self.sched.next_retry_at()
        if t is not None:
            ts.append(t)
        return min(ts) if ts else None

    def _loads(self) -> Dict[int, int]:
        """Per-slice slot pressure: occupied pool rows plus requests already
        streamed to the slice but still waiting in its admission backlog."""
        return {
            sid: e.slots_in_use() + e.admission_depth()
            for sid, e in self.engines.items()
        }

    def _dispatch(self, now: float) -> bool:
        """Stream due requests (EDF order, tenant+bucket-grouped by the
        shared SlotScheduler) into slices. `stream` mode: any healthy slice
        OF THE REQUEST'S TENANT with free slot capacity, least-loaded first
        — later groups join a busy slice's pool mid-flight. Free-slot
        accounting is per tenant (a {model: free} map into plan()), so one
        tenant's full pool never head-of-line blocks another's backlog.
        `batch` mode (the baseline): a slice receives one max_slots-sized
        group only when fully idle."""
        if self.dispatch_mode == "batch":
            return self._dispatch_batch_mode(now)
        load = self._loads()
        healthy = [sid for sid, s in self.sched.slices.items() if s.healthy]
        if len(self._tenants) == 1:
            free = sum(max(0, self._cap[sid] - load[sid]) for sid in healthy)
        else:
            free: Dict[str, int] = {name: 0 for name in self._tenants}
            for sid in healthy:
                free[self.slice_tenant[sid]] += max(
                    0, self._cap[sid] - load[sid]
                )
        plan = self.slot_scheduler.plan(self.batcher, now, free_slots=free)
        did = False
        leftovers: List[Request] = []
        for group in plan.admissions:
            for r in group:
                if not self.sched.ready_for_dispatch(r.rid, now):
                    leftovers.append(r)  # retry backoff still running
                    continue
                sid = self._pick_slice_for(r, load)
                if sid is None:
                    leftovers.append(r)
                    continue
                self._send(r, sid, now)
                load[sid] += 1
                did = True
        if leftovers:  # capacity raced away, or backoff held the rid out
            self.slot_scheduler.requeue(leftovers)
        return did

    def _pick_slice_for(self, r: Request,
                        load: Dict[int, int]) -> Optional[int]:
        """Slice choice for one streamed request, WITHIN ITS TENANT (every
        slice another model owns is excluded). With per-slice prefix
        stores, prefer the tenant slice whose radix tree holds the LONGEST
        match for this prompt (ties broken least-loaded by pick_slice). A
        slice at capacity never wins on affinity, and zero-match dispatch
        falls through to the plain least-loaded scheduler — as does
        everything when the tenant's prefix cache is off."""
        t = self._tenant_of(r)
        foreign = [sid for sid, name in self.slice_tenant.items()
                   if name != t.name]
        if t.ec.prefix_cache_bytes:
            best: List[int] = []
            best_m = 0
            for sid, s in self.sched.slices.items():
                if self.slice_tenant.get(sid) != t.name:
                    continue
                if not s.healthy or load.get(sid, 0) >= self._cap.get(sid, 0):
                    continue
                m = self.engines[sid].prefix_peek_req(r)
                if m > best_m:
                    best, best_m = [sid], m
                elif m == best_m and best_m > 0:
                    best.append(sid)
            if best_m > 0:
                exclude = [sid for sid in self.sched.slices
                           if sid not in best]
                sid = self.sched.pick_slice(load, self._cap, exclude=exclude)
                if sid is not None:
                    return sid
        return self.sched.pick_slice(load, self._cap, exclude=foreign)

    def _dispatch_batch_mode(self, now: float) -> bool:
        idle_by: Dict[str, List[int]] = {name: [] for name in self._tenants}
        for sid, s in sorted(self.sched.slices.items()):
            if (s.healthy and self.engines[sid].slots_in_use() == 0
                    and self.engines[sid].admission_depth() == 0
                    and not any(sid in tr.copies
                                for tr in self._inflight.values())):
                idle_by[self.slice_tenant[sid]].append(sid)
        if len(self._tenants) == 1:
            free = len(idle_by[self._default.name]) * self._default.ec.max_slots
        else:
            free = {name: len(sids) * self._tenants[name].ec.max_slots
                    for name, sids in idle_by.items()}
        plan = self.slot_scheduler.plan(self.batcher, now, free_slots=free)
        did = False
        leftovers: List[Request] = []
        for group in plan.admissions:
            group = list(group)
            t = self._tenant_of(group[0])  # groups are tenant-pure
            idle = idle_by[t.name]
            cap = t.ec.max_slots
            while group:
                if not idle:
                    leftovers.extend(group)
                    break
                sid = idle.pop(0)
                for r in group[:cap]:
                    self._send(r, sid, now)
                    did = True
                del group[:cap]
        if leftovers:
            self.slot_scheduler.requeue(leftovers)
        return did

    def _send(self, r: Request, sid: int, now: float) -> None:
        t = self._tenant_of(r)
        if self.slice_tenant.get(sid) != t.name:
            # structural invariant, not a recoverable condition: a request
            # must never run on another model's weights
            raise RuntimeError(
                f"cross-tenant dispatch: rid {r.rid} ({t.name}) -> slice "
                f"{sid} ({self.slice_tenant.get(sid)})"
            )
        self.routes[t.name].add(sid)
        self.engines[sid].offer([r])
        self.sched.dispatch(r.rid, sid, now, self._expected_s(r))
        self._inflight[r.rid] = _ReqTrack(req=r, primary_sid=sid,
                                          copies={sid: r})
        self.stats["dispatched"] += 1
        self.tracer.event(tm.DISPATCH, now, rid=r.rid, tenant=t.name, sid=sid)

    def _expected_s(self, r: Request) -> float:
        """Analytic per-request time budget for straggler detection: chunked
        admission dispatches (worst case: smallest chunk length over the
        prompt bucket) + decode segments + one admission pass, from the
        REQUEST'S TENANT's config, scaled by the EMA of that tenant's
        measured per-dispatch execution times (global EMA until the tenant
        has its own samples)."""
        if self.fixed_expected_s is not None:
            return self.fixed_expected_s
        t = self._tenant_of(r)
        ema = self._tenant_ema.get(t.name)
        if ema is None:
            ema = self._seg_ema
        if ema is None:
            return 0.0  # uncalibrated: hedging off until a dispatch is timed
        cap = t.ec.max_new_tokens
        budget = cap if r.max_new_tokens is None else min(r.max_new_tokens, cap)
        segs = math.ceil(budget / max(1, t.ec.segment_len))
        chunks = 1
        if t.chunked:  # only when the slice engines really chunk
            lp = next_pow2(max(1, int(r.length)))
            chunks = max(1, lp // min(t.ec.chunk_lens))
        return (segs + chunks) * ema

    def _advance(self, now: float) -> bool:
        did = False
        stuck: List[int] = []
        for sid, engine in self.engines.items():
            if sid in self.stalled_slices:
                # hung device: no progress; hedging covers short stalls and
                # the watchdog quarantines a busy slice that stays silent
                self._watch(sid, engine, stuck)
                continue
            moved = False
            if engine.busy():
                moved = bool(engine.step(now))
                did |= moved
            if moved or not engine.busy():
                # straggler detection is progress-gated: a slice that
                # advanced (or has nothing to do) is healthy, however long
                # its streamed residents wall-clock wait behind each other
                self.sched.note_progress(sid, now)
                self._stall_rounds.pop(sid, None)
            else:
                self._watch(sid, engine, stuck)
            self._update_ema(sid, engine)
            if engine.completed:
                done, engine.completed = engine.completed, []
                for res in done:
                    self._record(res, sid)
                did = True
        for sid in stuck:
            self.fail_slice(sid, now)  # watchdog verdict: quarantine
            did = True
        return did

    def _watch(self, sid: int, engine: ServingEngine,
               stuck: List[int]) -> None:
        """Progress-based failure detection: count consecutive rounds in
        which a HEALTHY slice stayed busy without its engine advancing; at
        `watchdog_rounds` the slice is quarantined through `fail_slice`
        (its work requeues under the retry budget) and, with probing
        enabled, later probed and re-admitted."""
        if not self.watchdog_rounds:
            return
        st = self.sched.slices.get(sid)
        if st is None or not st.healthy or not engine.busy():
            return
        n = self._stall_rounds.get(sid, 0) + 1
        self._stall_rounds[sid] = n
        if n >= self.watchdog_rounds:
            stuck.append(sid)

    def _update_ema(self, sid: int, engine: ServingEngine) -> None:
        seen = self._exec_seen.get(sid, 0)
        fresh = engine.batch_exec_s[seen:]
        self._exec_seen[sid] = seen + len(fresh)
        name = self.slice_tenant.get(sid)
        for x in fresh:
            self._seg_ema = (x if self._seg_ema is None
                             else 0.7 * self._seg_ema + 0.3 * x)
            if name is not None:
                prev = self._tenant_ema.get(name)
                self._tenant_ema[name] = (x if prev is None
                                          else 0.7 * prev + 0.3 * x)

    def _record(self, res: Request, sid: int) -> None:
        """First completion wins per rid: record the original exactly once
        (clone results copied back when a hedge twin won) and cancel every
        losing copy mid-flight on its engine."""
        track = self._inflight.get(res.rid)
        if track is None or res.rid in self._done_rids:
            return  # stale copy of an already-recorded completion
        orig = track.req
        if res is not orig:  # hedge twin ran a clone: copy results back
            orig.payload = res.payload
            orig.dispatched_at = res.dispatched_at
            orig.first_token_at = res.first_token_at
            orig.completed_at = res.completed_at
        self._done_rids.add(orig.rid)
        self.completed.append(orig)
        losers = self.sched.complete(res.rid, sid) or []
        for osid in losers:
            if osid in self.engines:
                self.stats["cancelled"] += self.engines[osid].cancel([res.rid])
        del self._inflight[res.rid]
        if sid != track.primary_sid:
            self.stats["hedge_wins"] += 1

    def _check_hedges(self, now: float) -> None:
        load = None
        for rid, sid in self.sched.stragglers(now):
            track = self._inflight.get(rid)
            if track is None:
                continue
            if load is None:
                load = self._loads()
            # the twin must be a slice of the request's OWN tenant: exclude
            # every current holder AND every slice another model owns
            t = self._tenant_of(track.req)
            foreign = [s for s, name in self.slice_tenant.items()
                       if name != t.name]
            twin = self.sched.pick_slice(load, self._cap,
                                         exclude=list(track.copies) + foreign)
            if twin is None:
                continue  # no free capacity: stays un-hedged, retried next step
            clone = dc_replace(track.req)
            self.routes[t.name].add(twin)
            self.engines[twin].offer([clone])
            track.copies[twin] = clone
            self.sched.hedge(rid, now, twin)
            load[twin] += 1
            self.tracer.event(tm.HEDGE, now, rid=rid, tenant=t.name, sid=twin)

    def set_virtual_clock(self, v: bool) -> None:
        """Virtual-clock stamping for every slice engine (the pipelined
        runtime sets this under rc.clock='virtual'): request lifecycle
        stamps and tracer timestamps come from the replay clock. Sticky
        across rebuilds (_make_engine re-applies it)."""
        self._virtual = bool(v)
        for e in self.engines.values():
            e._virtual = self._virtual

    # --- reporting ----------------------------------------------------------
    def _reset_state(self) -> None:
        """Registry reset hook (fleet part): clear the harvested-result and
        dead-letter state and rewind the per-slice exec-drain marks; each
        engine's own hook clears its completed/exec lists in the same
        cascade. Engines that are neither live nor in the warm partition
        cache leave the launch accounting: their steps predate the reset."""
        self.completed = []
        self._done_rids = set()
        self.dead = []
        self.dead_reasons = {}
        self._exec_seen = {sid: 0 for sid in self.engines}
        kept = list(self.engines.values()) + [
            e for gen in self._engine_cache.values() for e in gen.values()]
        self._built = [e for e in self._built if any(e is k for k in kept)]
        self.tracer.reset()

    def reset_metrics(self) -> None:
        """ONE registry-wide reset at the warmup boundary: zeroes the fleet
        counters AND every attached slice engine's. Shape-cache counters
        persist; readers diff."""
        self.registry.reset()
        # warm-partition-cached generations are detached from the fleet
        # root, so the cascade above misses them — reset explicitly, or a
        # restored generation would re-attach warmup-era counters (and
        # stale exec samples) mid-measurement
        for gen in self._engine_cache.values():
            for e in gen.values():
                e.registry.reset()

    def decode_steps_total(self, tenant: Optional[str] = None) -> int:
        """Decode steps executed by every engine built since the last
        metrics reset — live, replaced (readmit, resize) or stashed in the
        warm partition cache — or by those of one tenant. Each step of an
        attention model runs the decode kernel once per layer, so a
        tenant's count x its n_layers is its share of the kernel's
        launches (an SSM tenant's steps launch none)."""
        seen: Set[int] = set()
        total = 0
        for e in self._built:
            if id(e) not in seen and tenant in (None, e._tenant):
                seen.add(id(e))
                total += e.stats["decode_steps"]
        return total

    def trace_counts(self) -> Dict[int, int]:
        """Per-slice shape-cache trace totals (compile-once invariant): in
        steady state, one admit program per monolithically-admitted prompt
        bucket + one chunk program per (chunk length, bucket) pair actually
        chunked + ONE segment. Per-tenant in a multi-tenant fleet."""
        return {
            sid: (e.stats["prefill_traces"] + e.stats["generate_traces"]
                  + e.stats["segment_traces"] + e.stats["decode_step_traces"])
            for sid, e in self.engines.items()
        }

    def prefix_peek_req(self, r: Request) -> int:
        """Best stored-prefix match for a request across ITS TENANT'S slices
        (the runtime's SLO shed model: the affinity router will land the
        request on the best-matching slice of its model)."""
        t = self._tenant_of(r)
        return max((self.engines[sid].prefix_peek_req(r)
                    for sid, name in self.slice_tenant.items()
                    if name == t.name),
                   default=0)

    def prefix_stats(self) -> Dict[str, int]:
        """Aggregated prefix-cache counters across slices (all zero with the
        cache off)."""
        keys = ("prefix_hits", "prefix_hit_tokens", "prefix_prompt_tokens",
                "prefix_inserts", "prefix_scatter_traces")
        return {k: sum(e.stats[k] for e in self.engines.values())
                for k in keys}

    def slice_stats(self) -> Dict[int, Dict[str, Any]]:
        out: Dict[int, Dict[str, Any]] = {}
        for sid, e in self.engines.items():
            st = self.sched.slices.get(sid)
            out[sid] = {
                "model": self.slice_tenant.get(sid),
                "admitted": e.stats["admitted"],
                "retired": e.stats["retired"],
                "segments": e.stats["segments"],
                "mean_slot_occupancy": round(e.mean_slot_occupancy(), 3),
                "completed_requests": st.completed if st is not None else 0,
                "healthy": st.healthy if st is not None else False,
            }
        return out

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant rollup: slice assignment, completion/dead counts (by
        each request's stamped model), and the routing audit (every slice
        that ever received one of this model's requests — it stays within
        the tenant's own slices)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name in self._tenants:
            own = self.slices_of(name)
            out[name] = {
                "slices": own,
                "completed": sum(1 for r in self.completed
                                 if (r.model or self._default.name) == name),
                "dead": sum(1 for r in self.dead
                            if (r.model or self._default.name) == name),
                "routed_to": sorted(self.routes.get(name, ())),
            }
        return out

    def mean_slot_occupancy(self) -> float:
        """Fleet-wide mean active-slot fraction over every segment any
        engine ran (0.0 before any segment)."""
        h = self.registry.merged_histogram("engine_slot_occupancy_ratio")
        return float(h.mean)

    def slots_in_use(self) -> int:
        """Occupied KV pool rows across every slice (runtime telemetry)."""
        return sum(e.slots_in_use() for e in self.engines.values())

    def slot_capacity(self) -> int:
        return sum(e.slot_capacity() for e in self.engines.values())


def _knee_policy(cfg: ModelConfig, ec: EngineConfig, n_slices: int,
                 knee_profiles: Optional[Dict[int, Any]]):
    """(profiles, policy): measured profiles where given, else the
    analytical roofline knee per prompt bucket; V = n_slices, so
    Time_queue = Time_knee / V."""
    from repro_torch.core.batching import (
        analytical_knee, derive_policy, kv_bytes_per_token,
    )

    profiles = knee_profiles or {
        b: analytical_knee(
            cfg.active_param_count(), chips=1,
            context_len=int((b + 0.5) * ec.bucket_width),
            kv_bytes_per_token=kv_bytes_per_token(cfg),
        )
        for b in range(8)
    }
    return profiles, derive_policy(profiles, n_slices=n_slices,
                                   bucket_width=ec.bucket_width)


def _seeded_params(cfg: ModelConfig, seed: int, dev: torch.device):
    """The weights build_engine draws for `seed` (so a fleet's outputs equal
    a single engine's built with the same seed)."""
    from repro_torch.models.params import init_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(cfg, gen, dev, cfg.dtype)


def _check_served(cfg: ModelConfig) -> None:
    """Tenants are models of a served arch (SERVED_ARCHS: every arch but
    whisper's encoder-decoder), each fleet tenant of its own; anything else
    raises."""
    from repro_torch.configs import SERVED_ARCHS
    from repro_torch.serving.engine import check_servable

    check_servable(cfg)
    base = cfg.name[:-len("-reduced")] if cfg.name.endswith("-reduced") else cfg.name
    if base not in SERVED_ARCHS:
        raise ValueError(
            f"tenant arch {cfg.name!r} is not served by the PyTorch package "
            f"(served: {SERVED_ARCHS})")


def _resolve_tenants(specs: Sequence[TenantSpec], n_slices: int,
                     ec: EngineConfig, devices: Sequence[torch.device],
                     knee_profiles: Optional[Dict[int, Any]] = None,
                     ) -> List[_Tenant]:
    """Resolve TenantSpec asks into fully-built tenants: per-tenant weights
    (seeded unless supplied; one LM per tenant, shared by its slices),
    per-tenant knee profiles and policy (V = the tenant's apportioned slice
    count), chunking truth per model family, and the right-sizing check
    against the pod's uniform slice size."""
    names = [s.tenant_name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    counts = rebalance_slices(
        n_slices, {s.tenant_name: max(1, s.n_slices) for s in specs}
    )
    n_devs = len(devices)
    cps_pod = n_devs // n_slices if n_devs >= n_slices else 0
    out: List[_Tenant] = []
    for spec in specs:
        _check_served(spec.cfg)
        if spec.chips_per_slice > 0 and cps_pod and \
                spec.chips_per_slice > cps_pod:
            raise ValueError(
                f"tenant {spec.tenant_name!r} asks for "
                f"{spec.chips_per_slice}-chip slices; this partitioning "
                f"gives {cps_pod} chips per slice"
            )
        t_ec = ec if spec.ec is None else spec.ec
        params = spec.params
        if params is None:
            params = _seeded_params(spec.cfg, spec.seed, devices[0])
        profiles, policy = _knee_policy(spec.cfg, t_ec, counts[spec.tenant_name],
                                        knee_profiles)
        out.append(_Tenant(
            name=spec.tenant_name, cfg=spec.cfg,
            model=_as_model(spec.cfg, params), policy=policy, ec=t_ec,
            chunked=bool(t_ec.chunk_lens)
            and lm.supports_chunked_prefill(spec.cfg),
            knee_profiles=profiles, slo_s=spec.slo_s,
            n_slices_ask=max(1, spec.n_slices),
        ))
    return out


def build_multislice_engine(
    cfg: Optional[ModelConfig] = None, *, n_slices: int, seed: int = 0,
    ec: Optional[EngineConfig] = None, hedge_factor: float = 3.0,
    device: DeviceLike = "cuda", devices: Optional[Sequence] = None,
    params=None, dispatch: str = "stream",
    max_retries: int = 3, retry_backoff_s: float = 0.0,
    watchdog_rounds: int = 0, probe_interval_s: float = 0.0,
    tenants: Optional[Sequence[TenantSpec]] = None,
    knee_profiles: Optional[Dict[int, Any]] = None,
) -> MultiSliceEngine:
    """Mirror of engine.build_engine for the multi-slice system: the same
    seeded weights (outputs equal a single engine's), knee-derived policy
    with V = n_slices (Time_queue = Time_knee / V). Pass `params` (a tree or
    an LM) to serve weights already on the card; `dispatch="batch"`
    keeps the batch-granularity dispatcher (baseline).

    Multi-tenant: pass `tenants=[TenantSpec(...), ...]` instead of `cfg`.
    Each tenant gets its own weights/policy/knee profiles derived exactly as
    the single-tenant path would for its model (V = its apportioned slice
    count), `ec` becomes the fleet default any TenantSpec may override, and
    the fleet hosts all of them on disjoint slice sets behind one admission
    queue."""
    ec = EngineConfig() if ec is None else ec
    dev = resolve_device(device)
    devs = [dev] if devices is None else [resolve_device(d) for d in devices]
    if tenants is not None:
        resolved = _resolve_tenants(list(tenants), n_slices, ec, devs,
                                    knee_profiles)
        return MultiSliceEngine(
            n_slices=n_slices, tenants=resolved, device=dev, devices=devices,
            hedge_factor=hedge_factor, dispatch=dispatch,
            max_retries=max_retries, retry_backoff_s=retry_backoff_s,
            watchdog_rounds=watchdog_rounds, probe_interval_s=probe_interval_s,
        )
    if cfg is None:
        raise ValueError("pass cfg (single tenant) or tenants=[...]")
    _check_served(cfg)
    if params is None:
        params = _seeded_params(cfg, seed, devs[0])
    profiles, policy = _knee_policy(cfg, ec, n_slices, knee_profiles)
    return MultiSliceEngine(cfg, params, policy, ec, n_slices=n_slices,
                            device=dev, devices=devices,
                            hedge_factor=hedge_factor,
                            dispatch=dispatch, knee_profiles=profiles,
                            max_retries=max_retries,
                            retry_backoff_s=retry_backoff_s,
                            watchdog_rounds=watchdog_rounds,
                            probe_interval_s=probe_interval_s)
