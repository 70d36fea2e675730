"""Serving engine, continuous-batching path.

The KV cache is ONE fixed-shape slot pool `[max_slots, pool_cache_len]`
allocated up front; serving is a loop of admit -> decode-segment -> retire.
Admission prefills a left-padded pow2 prompt bucket and scatters it into
free row slots (`lm.prefill_into_slots`, batch width pinned to max_slots);
decode runs `lm.decode_segment` (`segment_len` steps over the whole pool);
finished rows free their slots between segments and queued requests join
without waiting for the pool to drain. A single scalar clock is the shared
padded write position; per-slot `pos_offset` maps it to each request's true
position, so a request's tokens are those it would get decoded alone.

Composes the knee-driven BucketedBatcher, the SlotScheduler (admission
order + segment length) and, for `submit_many`, an inline DPU pass. The
pipelined runtime (serving/runtime.py) feeds `offer()` instead.

Not ported yet (the JAX engine has them): the run-to-completion path, chunked
prefill and the radix prefix cache. A config that asks for one raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.core.batching.buckets import BucketedBatcher, Request, next_pow2
from repro_torch.core.batching.policy import BatchPolicy
from repro_torch.core.batching.scheduler import SlotScheduler
from repro_torch.core.dpu.runtime import DPU, DpuConfig
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models.api import DenseLM
from repro_torch.models.params import init_params
from repro_torch.serving import telemetry as tm


@dataclass
class EngineConfig:
    max_new_tokens: int = 8        # decode budget cap (per-request budgets clamp to it)
    bucket_width: float = 64.0     # prompt-length buckets (tokens)
    preprocess: str = "none"       # none | dpu (inline audio front-end at submit)
    pad_buckets: bool = True       # pow2 (batch, len) shape buckets + masking
    fused_decode: bool = True      # segment decode (the only decode served)
    min_prompt_len: int = 8        # shortest padded prompt length
    # --- continuous batching (slot pool + segmented decode) ---
    continuous: bool = False       # slot-pool admit/segment/retire loop
    max_slots: int = 8             # KV slot-pool rows (in-flight requests)
    segment_len: int = 8           # decode steps per segment
    segment_lens: Tuple[int, ...] = ()  # scheduler choices; () = fixed segment_len
    max_prompt_len: int = 64       # largest padded prompt bucket the pool accepts
    pool_cache_len: int = 0        # 0 -> max_prompt_len + max_new_tokens + max segment
    eos_id: Optional[int] = None   # retire a row early when it emits this token
    # --- chunked prefill (not ported yet; must stay empty) ---
    chunk_lens: Tuple[int, ...] = ()
    # --- radix prefix KV cache (not ported yet; must stay 0) ---
    prefix_cache_bytes: int = 0


def _check_supported(ec: EngineConfig) -> None:
    if not ec.continuous:
        raise NotImplementedError(
            "the run-to-completion engine is not ported yet; set continuous=True")
    if not (ec.pad_buckets and ec.fused_decode):
        raise NotImplementedError("only the bucketed, segment-decode path is served")
    if ec.chunk_lens:
        raise NotImplementedError("chunked prefill is not ported yet")
    if ec.prefix_cache_bytes:
        raise NotImplementedError("the prefix KV cache is not ported yet")


def validate_requests(reqs: List[Request], ec: EngineConfig,
                      *, check_bucket: bool) -> None:
    """Front-door request validation, shared by every intake path: a
    malformed request must fail BEFORE anything is enqueued.

    * a real tokenized prompt (Request.prompt) must carry exactly
      max(1, int(length)) ids;
    * on the slot-pool path the padded prompt bucket must fit
      max_prompt_len."""
    for r in reqs:
        n = max(1, int(r.length))
        if r.prompt is not None and len(r.prompt) != n:
            raise ValueError(
                f"request {r.rid}: prompt carries {len(r.prompt)} tokens "
                f"but length={r.length} implies {n}"
            )
        if check_bucket:
            lp = max(ec.min_prompt_len, next_pow2(n))
            if lp > ec.max_prompt_len:
                raise ValueError(
                    f"request {r.rid}: prompt bucket {lp} exceeds "
                    f"max_prompt_len={ec.max_prompt_len}; raise "
                    "EngineConfig.max_prompt_len"
                )


def enqueue_requests(reqs: List[Request], *, ec: EngineConfig,
                     dpu: Optional[DPU], batcher: BucketedBatcher,
                     stats, validate_prompts: bool) -> None:
    """Admission contract: validate every request up front, run ONE batched
    DPU preprocessing pass over the submission, then enqueue."""
    validate_requests(reqs, ec, check_bucket=validate_prompts)
    if dpu is not None:
        idx = [i for i, r in enumerate(reqs) if r.payload is not None]
        if idx:
            outs = dpu.process_batch([reqs[i].payload for i in idx])
            for i, y in zip(idx, outs):
                reqs[i].payload = y
            stats["dpu_batches"] += 1
    now = time.monotonic()
    for r in reqs:
        r.preprocessed_at = now
        batcher.enqueue(r)


@dataclass
class _Slot:
    """Host-side state of one occupied pool row."""

    req: Request
    budget: int
    produced: List[int]


class ServingEngine:
    """Single-slice continuous-batching engine: enqueue requests,
    run_until_idle() drains them through dynamic batching -> prefill into
    slots -> segmented decode -> retire.

    `stats` is a registry-backed view: `admitted` / `retired` / `segments`
    / `prefill_calls` / `dpu_batches`, plus `launches_<kernel>` — the
    process-wide launch counts of the DPU kernels (kernels.launch_counts),
    refreshed after every step. Exec times, request latency, TTFT and slot
    occupancy are streaming histograms on the same registry; lifecycle
    events (admit / decode_segment / retire) land on the shared tracer.
    """

    def __init__(self, cfg: ModelConfig, model: DenseLM, policy: BatchPolicy,
                 ec: Optional[EngineConfig] = None, *,
                 device: DeviceLike = "cuda",
                 knee_profiles: Optional[Dict[int, Any]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[tm.Tracer] = None):
        ec = EngineConfig() if ec is None else ec
        _check_supported(ec)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model
        self.policy = policy
        self.ec = ec
        self._knee_profiles = knee_profiles or {}
        self.batcher = BucketedBatcher(policy)
        self.dpu = DPU(DpuConfig(), self.device) if ec.preprocess == "dpu" else None
        self.completed: List[Request] = []
        self.batch_exec_s: List[float] = []
        self._labels = {"slice": "-", "tenant": "-"}
        self.registry = registry if registry is not None \
            else MetricsRegistry("engine")
        self.tracer = tracer if tracer is not None else tm.Tracer()
        self._virtual = False  # virtual-clock stamping (set by the runtime)
        self.stats = self.registry.view("engine", (
            "admitted", "retired", "segments", "prefill_calls", "dpu_batches",
            *(f"launches_{k}" for k in kernels.KERNELS),
        ), labels=self._labels)
        self._h_exec = self.registry.histogram(
            "engine_batch_exec_seconds", self._labels)
        self._h_occ = self.registry.histogram(
            "engine_slot_occupancy_ratio", self._labels)
        self._h_lat = self.registry.histogram(
            "request_latency_seconds", self._labels)
        self._h_ttft = self.registry.histogram(
            "request_ttft_seconds", self._labels)
        self.registry.on_reset(self._reset_state)

        seg_max = max(ec.segment_lens or (ec.segment_len,))
        self.pool_len = ec.pool_cache_len or (
            ec.max_prompt_len + ec.max_new_tokens + seg_max)
        assert self.pool_len >= ec.max_prompt_len + ec.max_new_tokens, (
            "pool_cache_len too small for max_prompt_len + max_new_tokens")
        self.slot_scheduler = SlotScheduler(
            policy, max_slots=ec.max_slots, segment_len=ec.segment_len,
            segment_lens=ec.segment_lens, profile_for=self._profile_for,
        )
        self._pool = None                      # allocated on first admit
        self._slots: List[Optional[_Slot]] = [None] * ec.max_slots
        self._pool_off = np.zeros(ec.max_slots, np.int64)
        self._tok = np.zeros((ec.max_slots, 1), np.int64)
        # clock >= any padded prompt bucket keeps pos_offset
        # (= clock - prompt_len) non-negative; reset when idle. Placement is
        # clock-independent (true-position indexed per row).
        self._clock = ec.max_prompt_len

    # --- queueing ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.submit_many([req])

    def submit_many(self, reqs: List[Request]) -> None:
        """Enqueue requests; with preprocess='dpu', pending requests carrying
        raw inputs in `payload` are preprocessed as ONE batched CU pass."""
        enqueue_requests(reqs, ec=self.ec, dpu=self.dpu, batcher=self.batcher,
                         stats=self.stats, validate_prompts=True)

    def offer(self, reqs: List[Request]) -> None:
        """Stage-pipelined admission intake (serving/runtime.py): requests
        whose preprocessing already completed join the SlotScheduler's EDF
        backlog directly. The runtime validates at its front door."""
        self.slot_scheduler.offer(reqs)

    def admission_depth(self) -> int:
        """Requests waiting for a KV slot (batcher + scheduler backlog) —
        the pipelined runtime's backpressure signal for this stage."""
        return self.batcher.pending() + self.slot_scheduler.depth()

    def cancel(self, rids: Iterable[int]) -> int:
        """Abandon requests by rid wherever they are: queued in the batcher,
        backlogged in the slot scheduler, occupying a pool slot mid-decode,
        or finished but not yet harvested. A cancelled slot's stale KV stays
        masked (pos_offset is rewritten on the next admission). Returns the
        number of live (not-yet-completed) requests removed."""
        rids = set(rids)
        n = 0
        for bucket in self.batcher.buckets.values():
            kept = [r for r in bucket.queue if r.rid not in rids]
            n += len(bucket.queue) - len(kept)
            bucket.queue.clear()
            bucket.queue.extend(kept)
        n += self.slot_scheduler.cancel(rids)
        for s, st in enumerate(self._slots):
            if st is not None and st.req.rid in rids:
                self._slots[s] = None
                n += 1
        self.completed = [r for r in self.completed if r.rid not in rids]
        return n

    def busy(self) -> bool:
        return bool(self.batcher.pending() or self.slot_scheduler.backlog()
                    or any(s is not None for s in self._slots))

    def step(self, now: Optional[float] = None) -> bool:
        """One engine iteration: admit due requests into free slots, run one
        decode segment, retire finished rows. Returns True if any work was
        done."""
        now = time.monotonic() if now is None else now
        plan = self.slot_scheduler.plan(self.batcher, now,
                                        free_slots=self._free_slots())
        progressed = False
        for group in plan.admissions:
            self._admit(group, now)
            progressed = True
        if any(st is not None for st in self._slots):
            self._decode_segment(plan.segment_len, now)
            progressed = True
        elif not self.slot_scheduler.backlog() and not self.batcher.pending():
            # pool drained: rewind the clock so positions stay small
            self._clock = self.ec.max_prompt_len
            self._pool_off[:] = 0
        for k, v in kernels.launch_counts().items():
            self.stats[f"launches_{k}"] = v
        return progressed

    def run_until_idle(self) -> List[Request]:
        while self.busy():
            if not self.step():
                deadline = self.batcher.next_deadline()
                self.step(deadline if deadline is not None else time.monotonic())
        return self.completed

    # --- telemetry ----------------------------------------------------------
    def _stamp(self, now: Optional[float]) -> float:
        """The caller's clock under virtual replay (deterministic timelines),
        wall time otherwise (wall-mode TTFT includes real prefill time)."""
        if self._virtual and now is not None:
            return now
        return time.monotonic()

    def _reset_state(self) -> None:
        self.completed.clear()
        self.batch_exec_s.clear()
        self.tracer.reset()

    def reset_metrics(self) -> None:
        self.registry.reset()

    # --- hot path ----------------------------------------------------------
    def _prompt_tokens(self, req: Request, n: int) -> np.ndarray:
        """The request's token array, else the deterministic per-rid
        synthetic prompt (the benchmark workload)."""
        if req.prompt is not None:
            return np.asarray(req.prompt, np.int64)
        rng = np.random.default_rng(req.rid)
        return rng.integers(0, self.cfg.vocab, n)

    def _budget(self, req: Request) -> int:
        b = self.ec.max_new_tokens if req.max_new_tokens is None else req.max_new_tokens
        return max(1, min(b, self.ec.max_new_tokens))

    def _truncate(self, tokens, budget: int) -> np.ndarray:
        out = np.asarray(tokens[:budget], np.int32)
        if self.ec.eos_id is not None:
            hits = np.flatnonzero(out == self.ec.eos_id)
            if hits.size:
                out = out[: hits[0] + 1]
        return out

    def _free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def _profile_for(self, lp: int):
        """Knee profile for a prompt bucket (nearest bucket); None without
        profiles."""
        if not self._knee_profiles:
            return None
        b = int(lp / self.policy.bucket_width)
        key = min(self._knee_profiles, key=lambda k: abs(k - b))
        return self._knee_profiles[key]

    def _admit(self, reqs: List[Request], now: Optional[float] = None) -> None:
        """Prefill a left-padded admission group and join it into free slots.
        The admission batch width is pinned to max_slots."""
        if self._pool is None:
            self._pool = lm.alloc_slot_pool(self.cfg, self.ec.max_slots,
                                            self.pool_len, self.device)
        free = [i for i, s in enumerate(self._slots) if s is None]
        assert len(reqs) <= len(free), (len(reqs), len(free))
        lens = [max(1, int(r.length)) for r in reqs]
        lp = max(self.ec.min_prompt_len, next_pow2(max(lens)))
        assert lp <= self.ec.max_prompt_len, lp  # enforced at the front door
        assert self._clock >= lp
        bp = self.ec.max_slots
        toks = np.zeros((bp, lp), np.int64)
        off = np.full(bp, lp, np.int64)          # rows past the group: all pad
        for i, r in enumerate(reqs):
            toks[i, lp - lens[i]:] = self._prompt_tokens(r, lens[i])
            off[i] = lp - lens[i]
        sids = np.full(bp, bp, np.int64)         # out-of-range rows -> dropped
        sids[: len(reqs)] = free[: len(reqs)]
        t0 = time.monotonic()
        tok0, self._pool = self.model.prefill_into_slots(
            torch.from_numpy(toks).to(self.device), self._pool,
            torch.from_numpy(sids).to(self.device), self._clock,
            pos_offset=torch.from_numpy(off).to(self.device))
        tok0 = tok0.cpu().numpy()
        exec_s = time.monotonic() - t0
        self.batch_exec_s.append(exec_s)
        self._h_exec.observe(exec_s)
        self.stats["prefill_calls"] += 1
        t = self._stamp(now)
        for i, r in enumerate(reqs):
            s = free[i]
            self._pool_off[s] = self._clock - lens[i]
            self._tok[s] = tok0[i]
            self._slots[s] = _Slot(req=r, budget=self._budget(r),
                                   produced=[int(tok0[i, 0])])
            r.dispatched_at = t
            r.first_token_at = t  # TTFT: prefill emits the first token
        self.stats["admitted"] += len(reqs)
        self.tracer.event(tm.ADMIT, t, bucket=lp, rids=[r.rid for r in reqs])
        self._retire_finished(t)  # budget-1 / instant-EOS requests

    def _decode_segment(self, steps: int, now: Optional[float] = None) -> None:
        """One segment over the whole pool; finished rows retire after."""
        t0 = time.monotonic()
        toks, self._pool = self.model.decode_segment(
            self._pool, torch.from_numpy(self._tok).to(self.device), self._clock,
            steps=int(steps), pos_offset=torch.from_numpy(self._pool_off).to(self.device))
        toks = toks.cpu().numpy()
        self._clock += steps
        if self._clock >= self.ec.max_prompt_len + 8 * self.pool_len:
            self._rebase_clock()
        self._tok = toks[:, -1:].astype(np.int64).copy()
        done = time.monotonic()
        exec_s = done - t0
        self.batch_exec_s.append(exec_s)
        self._h_exec.observe(exec_s)
        self.stats["segments"] += 1
        n_active = self.ec.max_slots - self._free_slots()
        self._h_occ.observe(n_active / self.ec.max_slots)
        stamp = now if (self._virtual and now is not None) else done
        self.tracer.event(tm.DECODE_SEGMENT, stamp, steps=int(steps),
                          active=n_active, dur=None if self._virtual else exec_s)
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            take = min(steps, st.budget - len(st.produced))
            if take > 0:
                st.produced.extend(int(t) for t in toks[s, :take])
        self._retire_finished(stamp)

    def _rebase_clock(self) -> None:
        """Shift the clock and every slot offset down by a multiple of the
        ring length; positions, ring slots and masks are invariant under it,
        so in-flight rows are unaffected and positions stay bounded."""
        k = (self._clock - self.ec.max_prompt_len) // self.pool_len
        if k <= 0:
            return
        self._clock -= k * self.pool_len
        self._pool_off -= k * self.pool_len
        for s, st in enumerate(self._slots):
            if st is None:
                self._pool_off[s] = 0

    def _retire_finished(self, now: float) -> None:
        eos = self.ec.eos_id
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            if not (len(st.produced) >= st.budget
                    or (eos is not None and eos in st.produced)):
                continue
            r = st.req
            r.payload = self._truncate(np.asarray(st.produced), st.budget)
            r.completed_at = now
            self.completed.append(r)
            self._h_lat.observe(now - r.arrival)
            if r.first_token_at is not None:
                self._h_ttft.observe(r.first_token_at - r.arrival)
            self.tracer.event(tm.RETIRE, now, rid=r.rid, tokens=len(r.payload))
            self._slots[s] = None  # stale KV stays masked for the next occupant
            self.stats["retired"] += 1

    def mean_slot_occupancy(self) -> float:
        return float(self._h_occ.mean)

    def slots_in_use(self) -> int:
        """Occupied KV pool rows right now (pipelined-runtime telemetry)."""
        return self.ec.max_slots - self._free_slots()

    def slot_capacity(self) -> int:
        return self.ec.max_slots


def build_engine(cfg: ModelConfig, *, seed: int = 0, ec: Optional[EngineConfig] = None,
                 device: DeviceLike = "cuda",
                 params: Optional[Dict[str, Any]] = None) -> ServingEngine:
    """A ServingEngine with knee-derived batching policy. Weights: `params`
    (e.g. carried from the JAX package by models.params.from_reference), or
    seeded ones from `seed`, in cfg.dtype, on `device`."""
    from repro_torch.core.batching import analytical_knee, derive_policy, kv_bytes_per_token

    ec = EngineConfig() if ec is None else ec
    _check_supported(ec)
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, dev, cfg.dtype)
    n_active = cfg.active_param_count()
    profiles = {
        b: analytical_knee(
            n_active, chips=1, context_len=int((b + 0.5) * ec.bucket_width),
            kv_bytes_per_token=kv_bytes_per_token(cfg),
        )
        for b in range(8)
    }
    policy = derive_policy(profiles, n_slices=1, bucket_width=ec.bucket_width)
    return ServingEngine(cfg, DenseLM(cfg, params), policy, ec, device=dev,
                         knee_profiles=profiles)
