"""Serving engine: run-to-completion and continuous batching, with chunked
prefill and the radix prefix KV cache.

Prefill inputs are left-padded to power-of-two (batch, length) shape buckets;
padded positions are masked out of attention and the KV cache
(lm.forward pos_offset), so padding never changes a request's tokens. Every
decode step, in every mode, runs the flash-decode kernel
(kernels.ops.decode_attention) once per layer.

* run-to-completion (`continuous=False`): each formed batch is prefilled
  into a cache of lp + max_new_tokens and decoded by `lm.generate`
  (`max_new_tokens` steps), or with `fused_decode=False` by a host loop of
  single `lm.decode` steps. `pad_buckets=False` is the legacy baseline:
  right-padded prompts at the batch's own shape, no masking.

* continuous batching (`continuous=True`): the KV cache is ONE fixed-shape
  slot pool `[max_slots, pool_cache_len]` allocated up front; serving is a
  loop of admit -> decode-segment -> retire. Admission prefills a left-padded
  prompt bucket and scatters it into free row slots (`lm.prefill_into_slots`,
  batch width pinned to max_slots); decode runs `lm.decode_segment`
  (`segment_len` steps over the whole pool); finished rows free their slots
  between segments and queued requests join without waiting for the pool to
  drain. A single scalar clock is the shared padded write position; per-slot
  `pos_offset` maps it to each request's true position, so a request's
  tokens are those it would get decoded alone.

* chunked prefill (`chunk_lens` non-empty, model permitting —
  `lm.supports_chunked_prefill`): a prompt bucket longer than the policy-
  chosen chunk admits across several engine steps, one
  `lm.prefill_chunk_into_slots` call per step interleaved with the decode
  segments. Mid-prefill rows hold their slots but are not `live`: segments
  skip their token production, and their `pos_offset` is refreshed to
  `clock - filled` before every segment so the segment's (ignored) write
  for such a row lands at ring slot >= the filled prefix, above the row's
  current position, where later chunks overwrite it before it is read.

* radix prefix cache (`prefix_cache_bytes`, with chunked prefill): a
  retiring row's prompt K/V is stored on the host in a per-bucket radix
  tree (core/prefix); an admission whose prompt matches a stored prefix
  scatters it into its row and resumes chunked prefill past it.

The executable caches of the JAX engine are dicts of shape keys here: the
first use of a shape counts as a trace (`prefill_traces`, `generate_traces`,
`segment_traces`, `decode_step_traces`, `prefix_scatter_traces`), a reuse as
a cache hit, so the compile-once accounting reads as it does there.

Composes the knee-driven BucketedBatcher, the SlotScheduler (admission
order + segment length) and, for `submit_many`, an inline DPU pass. The
pipelined runtime (serving/runtime.py) feeds `offer()` instead.

A fleet slice (serving/multislice.py) builds its engine with `slice_id`,
`tenant` and the slice's CUDA `stream`: the engine allocates its slot pool
and issues every kernel of `step()` on that stream, and its metrics and
lifecycle events carry the slice and tenant labels.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.core.batching.buckets import Batch, BucketedBatcher, Request, next_pow2
from repro_torch.core.batching.policy import BatchPolicy, pick_chunk_len
from repro_torch.core.batching.scheduler import SlotScheduler
from repro_torch.core.dpu.runtime import DPU, DpuConfig
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.prefix import PrefixLease, PrefixStore
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models.api import LM
from repro_torch.models.params import init_params
from repro_torch.serving import telemetry as tm


@dataclass
class EngineConfig:
    max_new_tokens: int = 8        # decode budget cap (per-request budgets clamp to it)
    bucket_width: float = 64.0     # prompt-length buckets (tokens)
    preprocess: str = "none"       # none | dpu (inline audio front-end at submit)
    pad_buckets: bool = True       # pow2 (batch, len) shape buckets + masking
    fused_decode: bool = True      # lm.generate vs a host loop of lm.decode steps
    min_prompt_len: int = 8        # shortest padded prompt length
    # --- continuous batching (slot pool + segmented decode) ---
    continuous: bool = False       # slot-pool admit/segment/retire loop
    max_slots: int = 8             # KV slot-pool rows (in-flight requests)
    segment_len: int = 8           # decode steps per segment
    segment_lens: Tuple[int, ...] = ()  # scheduler choices; () = fixed segment_len
    max_prompt_len: int = 64       # largest padded prompt bucket the pool accepts
    pool_cache_len: int = 0        # 0 -> max_prompt_len + max_new_tokens + max segment
    eos_id: Optional[int] = None   # retire a row early when it emits this token
    # --- chunked prefill (long-prompt admission split across steps) ---
    # candidate chunk lengths (pow2); () disables chunking. The policy picks
    # one per admission (policy.pick_chunk_len); buckets longer than the
    # pick admit chunk-by-chunk, interleaved with decode segments. Inert for
    # model families lm.supports_chunked_prefill rejects.
    chunk_lens: Tuple[int, ...] = ()
    # --- radix prefix KV cache (cross-request shared-prefix reuse) ---
    # host byte budget for the engine's radix store; 0 disables. Hits
    # resume suffix chunks at the matched length, so it is inert without
    # chunk_lens.
    prefix_cache_bytes: int = 0


def validate_requests(reqs: List[Request], ec: EngineConfig,
                      *, check_bucket: bool) -> None:
    """Front-door request validation, shared by every intake path: a
    malformed request must fail BEFORE anything is enqueued.

    * a real tokenized prompt (Request.prompt) must carry exactly
      max(1, int(length)) ids;
    * on the slot-pool path the padded prompt bucket must fit
      max_prompt_len (run-to-completion sizes its cache per batch)."""
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
    """Host-side state of one occupied pool row.

    `live=False` marks a mid-prefill row (chunked admission in progress):
    it holds its slot but produces no tokens and never retires; `filled`
    is its TRUE-position prefix length written so far (the garbage-write
    floor for interleaved decode segments)."""

    req: Request
    budget: int
    produced: List[int]
    live: bool = True
    filled: int = 0


@dataclass
class _ChunkAdmission:
    """One in-flight chunked admission group: a bucket-pure left-padded
    prompt block being written into the pool chunk by chunk. `toks`/`off`
    are laid out on POOL ROWS (row s is slot s; non-member rows carry the
    sentinel offset lp, which the chunk program fully masks)."""

    reqs: List[Request]
    slots: List[int]
    toks: np.ndarray         # [max_slots, lp] left-padded prompt tokens
    off: np.ndarray          # [max_slots] left-pad; lp sentinel = not ours
    lp: int
    chunk: int
    pos: int = 0             # next padded column to process (past base)
    # prefix-cache resume: first padded column this admission computes (a
    # chunk multiple; columns [0, base) were scattered from the radix store
    # or are left-pad). Hit groups split per base so each admission stays
    # column-pure; admissions of one (chunk, lp) class share one call.
    base: int = 0
    # rows whose TTFT was stamped at the scatter step (whole prompt served
    # from the store); the final chunk keeps their earlier stamp
    stamped: List[int] = field(default_factory=list)


# numpy has no bfloat16: host copies of the pool keep its bits as int16
_HOST_BITS = {torch.bfloat16: torch.int16}


def _map_tree(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def check_servable(cfg: ModelConfig) -> None:
    """Refuse, before anything is built or admitted, a model the engine
    cannot serve: an encoder-decoder (whisper), whose prefill needs
    `audio_frames`, which no admission path carries. The JAX package's
    engine fails on it too, inside prefill_into_slots (its encoder reads
    audio_frames=None); the port runs it through the model entry points."""
    if cfg.enc_layers:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its prefill needs audio_frames "
            f"[B, {cfg.n_audio_ctx}, {cfg.d_model}], which the serving engine's "
            "admission does not carry; run it through repro_torch.models.api.LM "
            "(prefill(..., audio_frames=), decode, generate)")


class ServingEngine:
    """Single-slice engine: enqueue requests, run_until_idle() drains them
    through dynamic batching -> prefill -> decode (run-to-completion
    batches, or slot-pool admission, segments and retirement).

    `stats` is a registry-backed view: `batches` (run-to-completion),
    `admitted` / `retired` / `segments` / `prefill_calls` / `dpu_batches`,
    `decode_steps` (decode steps executed over the whole batch or pool —
    each runs the decode kernel once per layer), the shape-cache counters
    (`prefill_compiles`, `prefill_cache_hits`, `*_traces`), the `prefix_*`
    counters of the radix store, and `launches_<kernel>` — the process-wide
    launch counts of the hand-written kernels (kernels.launch_counts),
    refreshed after every step. Exec times, request latency, TTFT and slot
    occupancy are streaming histograms on the same registry; lifecycle
    events (admit / prefill_chunk / prefix_scatter / decode_segment /
    retire) land on the shared tracer.
    """

    # shape-cache counters mirror caches a metrics reset does not evict
    _PERSISTENT_STATS = (
        "prefill_compiles", "prefill_cache_hits", "prefill_traces",
        "generate_traces", "segment_traces", "decode_step_traces",
        "prefix_scatter_traces",
    )

    def __init__(self, cfg: ModelConfig, model: LM, policy: BatchPolicy,
                 ec: Optional[EngineConfig] = None, *,
                 device: DeviceLike = "cuda",
                 knee_profiles: Optional[Dict[int, Any]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[tm.Tracer] = None,
                 slice_id: Optional[int] = None,
                 tenant: Optional[str] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        check_servable(cfg)
        ec = EngineConfig() if ec is None else ec
        self.cfg = cfg
        self.device = resolve_device(device)
        if stream is not None and self.device.type != "cuda":
            raise ValueError("a CUDA stream needs a CUDA device")
        self.stream = stream
        if stream is not None:
            # the weights were written on the caller's stream: order this
            # engine's first reads after them
            stream.wait_stream(torch.cuda.current_stream(self.device))
        self.model = model
        self.policy = policy
        self.ec = ec
        self._knee_profiles = knee_profiles or {}
        self.batcher = BucketedBatcher(policy)
        self.dpu = DPU(DpuConfig(), self.device) if ec.preprocess == "dpu" else None
        self.completed: List[Request] = []
        self.batch_exec_s: List[float] = []
        self._sid = slice_id
        self._tenant = tenant
        self._labels = {"slice": "-" if slice_id is None else str(slice_id),
                        "tenant": tenant if tenant is not None else "-"}
        self.registry = registry if registry is not None \
            else MetricsRegistry("engine")
        self.tracer = tracer if tracer is not None else tm.Tracer()
        self._virtual = False  # virtual-clock stamping (set by the runtime)
        self.stats = self.registry.view("engine", (
            "batches", "admitted", "retired", "segments", "prefill_calls",
            "dpu_batches", "decode_steps",
            *self._PERSISTENT_STATS,
            "prefix_hits", "prefix_hit_tokens", "prefix_prompt_tokens",
            "prefix_inserts",
            *(f"launches_{k}" for k in kernels.KERNELS),
        ), labels=self._labels, persistent=self._PERSISTENT_STATS)
        self._h_exec = self.registry.histogram(
            "engine_batch_exec_seconds", self._labels)
        self._h_occ = self.registry.histogram(
            "engine_slot_occupancy_ratio", self._labels)
        self._h_lat = self.registry.histogram(
            "request_latency_seconds", self._labels)
        self._h_ttft = self.registry.histogram(
            "request_ttft_seconds", self._labels)
        self.registry.on_reset(self._reset_state)
        # shape keys each program has run at (the JAX engine's jit caches)
        self._shapes: Dict[str, set] = {}

        # --- continuous-batching state (slot pool) -------------------------
        self.slot_scheduler: Optional[SlotScheduler] = None
        if not ec.continuous:
            return
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
        # --- chunked prefill ---
        self._chunk_lens: Tuple[int, ...] = (
            tuple(sorted(set(int(c) for c in ec.chunk_lens)))
            if ec.chunk_lens and lm.supports_chunked_prefill(cfg) else ())
        self._chunk_q: List[_ChunkAdmission] = []
        # --- radix prefix KV cache ---
        self.prefix_store: Optional[PrefixStore] = None
        if ec.prefix_cache_bytes and self._chunk_lens:
            from repro_torch.core.batching import kv_bytes_per_token

            self.prefix_store = PrefixStore(
                ec.prefix_cache_bytes, kv_bytes_per_token(cfg),
                registry=self.registry, labels=self._labels)
        self._prefix_leases: Dict[int, PrefixLease] = {}  # rid -> pin

    # --- queueing ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.submit_many([req])

    def submit_many(self, reqs: List[Request]) -> None:
        """Enqueue requests; with preprocess='dpu', pending requests carrying
        raw inputs in `payload` are preprocessed as ONE batched CU pass.
        Prompt buckets are validated only on the slot-pool path."""
        enqueue_requests(reqs, ec=self.ec, dpu=self.dpu, batcher=self.batcher,
                         stats=self.stats, validate_prompts=self.ec.continuous)

    def offer(self, reqs: List[Request]) -> None:
        """Stage-pipelined admission intake (serving/runtime.py): requests
        whose preprocessing already completed join the SlotScheduler's EDF
        backlog directly. The runtime validates at its front door."""
        if not self.ec.continuous:
            raise ValueError("pipelined admission requires continuous=True")
        self.slot_scheduler.offer(reqs)

    def admission_depth(self) -> int:
        """Requests waiting for a KV slot (batcher + scheduler backlog) —
        the pipelined runtime's backpressure signal for this stage."""
        d = self.batcher.pending()
        if self.ec.continuous:
            d += self.slot_scheduler.depth()
        return d

    def cancel(self, rids: Iterable[int]) -> int:
        """Abandon requests by rid wherever they are: queued in the batcher,
        backlogged in the slot scheduler, mid-chunked-prefill or mid-decode
        in a pool slot, or finished but not yet harvested. A cancelled
        slot's stale KV stays masked (pos_offset is rewritten on the next
        admission); its prefix-store pin is released. Returns the number of
        live (not-yet-completed) requests removed."""
        rids = set(rids)
        n = 0
        for bucket in self.batcher.buckets.values():
            kept = [r for r in bucket.queue if r.rid not in rids]
            n += len(bucket.queue) - len(kept)
            bucket.queue.clear()
            bucket.queue.extend(kept)
        if self.ec.continuous:
            n += self.slot_scheduler.cancel(rids)
            # mid-chunk: mask the row out of its admission with the sentinel
            # offset; the slot loop below frees and counts it
            for adm in list(self._chunk_q):
                keep_r, keep_s = [], []
                for r, s in zip(adm.reqs, adm.slots):
                    if r.rid in rids:
                        adm.off[s] = adm.lp
                    else:
                        keep_r.append(r)
                        keep_s.append(s)
                adm.reqs, adm.slots = keep_r, keep_s
                if not adm.reqs:
                    self._chunk_q.remove(adm)
            for s, st in enumerate(self._slots):
                if st is not None and st.req.rid in rids:
                    self._slots[s] = None
                    n += 1
            if self.prefix_store is not None:
                for rid in rids:
                    lease = self._prefix_leases.pop(rid, None)
                    if lease is not None:
                        self.prefix_store.release(lease)
        self.completed = [r for r in self.completed if r.rid not in rids]
        return n

    def busy(self) -> bool:
        if self.batcher.pending():
            return True
        if self.ec.continuous:
            return bool(self.slot_scheduler.backlog()) or any(
                s is not None for s in self._slots)
        return False

    def step(self, now: Optional[float] = None) -> bool:
        """One engine iteration; returns True if any work was done.

        Run-to-completion: execute every batch due at `now`. Continuous:
        admit due requests into free slots (monolithic or chunked), advance
        every chunked admission by one chunk, run one decode segment, retire
        finished rows."""
        now = time.monotonic() if now is None else now
        with self._on_stream():
            progressed = self._step_rtc(now) if not self.ec.continuous \
                else self._step_pool(now)
        for k, v in kernels.launch_counts().items():
            self.stats[f"launches_{k}"] = v
        return progressed

    def _step_rtc(self, now: float) -> bool:
        batches = self.batcher.poll(now)
        for b in batches:
            self._execute(b)
        return bool(batches)

    def _step_pool(self, now: float) -> bool:
        plan = self.slot_scheduler.plan(self.batcher, now,
                                        free_slots=self._free_slots())
        progressed = False
        for group in plan.admissions:
            lp = max(self.ec.min_prompt_len,
                     next_pow2(max(max(1, int(r.length)) for r in group)))
            c = self._pick_chunk(lp)
            if c:
                self._begin_chunked(group, lp, c, now)
            else:
                self._admit(group, now)
            progressed = True
        # one chunk of every in-flight chunked admission, then the segment:
        # a long prompt never freezes resident decoders
        progressed |= self._advance_chunks(now)
        if any(st is not None and st.live for st in self._slots):
            self._decode_segment(plan.segment_len, now)
            progressed = True
        elif all(st is None for st in self._slots) \
                and not self.slot_scheduler.backlog() \
                and not self.batcher.pending():
            # pool drained: rewind the clock so positions stay small.
            # Mid-prefill-only pools skip the segment: it would decode
            # nothing but masked rows.
            self._clock = self.ec.max_prompt_len
            self._pool_off[:] = 0
        return progressed

    def _on_stream(self):
        """The engine's stream as the current one (a slice engine's work
        and slot-pool allocations stay on its own stream)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

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

    def _observe_exec(self, seconds: float) -> None:
        self.batch_exec_s.append(seconds)
        self._h_exec.observe(seconds)

    def _shape_use(self, program: str, key: Any, traces: str,
                   count_hit: bool = True) -> None:
        """First use of `key` by `program` counts one trace (and a prefill
        compile for the prefill programs); a reuse counts a cache hit."""
        seen = self._shapes.setdefault(program, set())
        if key in seen:
            if count_hit:
                self.stats["prefill_cache_hits"] += 1
            return
        seen.add(key)
        self.stats[traces] += 1
        if traces == "prefill_traces":
            self.stats["prefill_compiles"] += 1

    # --- shared helpers -----------------------------------------------------
    def bucket_shape(self, batch_size: int, max_len: int) -> Tuple[int, int]:
        """Power-of-two (batch, length) shape bucket for a ragged batch."""
        if not self.ec.pad_buckets:
            return batch_size, max(self.ec.min_prompt_len, max_len)
        return next_pow2(batch_size), max(self.ec.min_prompt_len, next_pow2(max_len))

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

    def _left_pad_prompts(self, reqs: List[Request], lens: List[int],
                          bp: int, lp: int):
        """(tokens [bp, lp], pos_offset [bp]) of a left-padded block; rows
        beyond len(reqs) stay fully padded (offset == lp)."""
        toks = np.zeros((bp, lp), np.int64)
        off = np.full(bp, lp, np.int64)
        for i, r in enumerate(reqs):
            toks[i, lp - lens[i]:] = self._prompt_tokens(r, lens[i])
            off[i] = lp - lens[i]
        return toks, off

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # --- run-to-completion ---------------------------------------------------
    def _pad_batch(self, batch: Batch):
        """Prompts in the batch's shape bucket: (tokens [Bp, Lp], pos_offset
        [Bp] or None, (Bp, Lp)). Bucketed batches are left-padded and masked
        (rows beyond the batch fully padded); the legacy path right-pads
        with zeros, unmasked."""
        lens = [max(1, int(r.length)) for r in batch.requests]
        bp, lp = self.bucket_shape(len(batch.requests), max(lens))
        if self.ec.pad_buckets:
            toks, off = self._left_pad_prompts(batch.requests, lens, bp, lp)
            return self._dev(toks), self._dev(off), (bp, lp)
        toks = np.zeros((bp, lp), np.int64)
        for i, r in enumerate(batch.requests):
            toks[i, :lens[i]] = self._prompt_tokens(r, lens[i])
        return self._dev(toks), None, (bp, lp)

    def _execute(self, batch: Batch) -> None:
        """Prefill one formed batch into a cache of lp + max_new_tokens and
        decode it to the end of the budget."""
        t0 = time.monotonic()
        toks, off, (bp, lp) = self._pad_batch(batch)
        steps = self.ec.max_new_tokens
        self._shape_use("prefill", (bp, lp), "prefill_traces")
        logits, cache = self.model.prefill(toks, pos_offset=off,
                                           cache_len=lp + steps)  # ring never wraps
        self.stats["prefill_calls"] += 1
        if self.ec.fused_decode:
            self._shape_use("generate", (bp, lp), "generate_traces", count_hit=False)
            out, _ = self.model.generate(cache, logits, lp, steps=steps, pos_offset=off)
        else:
            tok = torch.argmax(logits, -1)
            outs = [tok]
            for i in range(steps - 1):
                self._shape_use("decode_step", (bp, lp), "decode_step_traces",
                                count_hit=False)
                logits, cache = self.model.decode(cache, tok, lp + i, pos_offset=off)
                tok = torch.argmax(logits, -1)
                outs.append(tok)
            out = torch.cat(outs, dim=1)
        tokens = out.cpu().numpy()
        self.stats["decode_steps"] += steps - 1
        done = time.monotonic()
        self.stats["batches"] += 1
        self._observe_exec(done - t0)
        for i, r in enumerate(batch.requests):
            r.dispatched_at = t0
            r.completed_at = done
            # all tokens materialize at once: the first is observable no
            # earlier than the batch finishing
            r.first_token_at = done
            # the whole budget is decoded; per-request budgets truncate
            r.payload = self._truncate(tokens[i], self._budget(r))
            self.completed.append(r)
            self._h_lat.observe(done - r.arrival)
            self._h_ttft.observe(done - r.arrival)
            self.tracer.event(tm.RETIRE, done, rid=r.rid, sid=self._sid,
                              tenant=self._tenant, tokens=len(r.payload))

    # --- continuous batching (slot pool + segmented decode) ----------------
    def _free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def _ensure_pool(self) -> None:
        if self._pool is None:
            self._pool = lm.alloc_slot_pool(self.cfg, self.ec.max_slots,
                                            self.pool_len, self.device)

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
        self._ensure_pool()
        free = [i for i, s in enumerate(self._slots) if s is None]
        assert len(reqs) <= len(free), (len(reqs), len(free))
        lens = [max(1, int(r.length)) for r in reqs]
        lp = max(self.ec.min_prompt_len, next_pow2(max(lens)))
        assert lp <= self.ec.max_prompt_len, lp  # enforced at the front door
        assert self._clock >= lp
        bp = self.ec.max_slots
        toks, off = self._left_pad_prompts(reqs, lens, bp, lp)
        sids = np.full(bp, bp, np.int64)         # out-of-range rows -> dropped
        sids[: len(reqs)] = free[: len(reqs)]
        self._shape_use("admit", lp, "prefill_traces")
        t0 = time.monotonic()
        tok0, self._pool = self.model.prefill_into_slots(
            self._dev(toks), self._pool, self._dev(sids), self._clock,
            pos_offset=self._dev(off))
        tok0 = tok0.cpu().numpy()
        self._observe_exec(time.monotonic() - t0)
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
            self.stats["prefix_prompt_tokens"] += lens[i]
        self.stats["admitted"] += len(reqs)
        self.tracer.event(tm.ADMIT, t, sid=self._sid, tenant=self._tenant,
                          bucket=lp, rids=[r.rid for r in reqs])
        self._retire_finished(t)  # budget-1 / instant-EOS requests

    # --- chunked prefill ----------------------------------------------------
    def _pick_chunk(self, lp: int) -> int:
        """Chunk length for a prompt bucket of padded length lp; 0 means
        monolithic admission (chunking off, unsupported family, or the
        bucket fits in one policy-chosen chunk)."""
        if not self._chunk_lens:
            return 0
        resident = sum(1 for s in self._slots if s is not None)
        waiting = self.slot_scheduler.backlog() + self.batcher.pending()
        c = pick_chunk_len(self._chunk_lens, resident=resident, waiting=waiting,
                           profile=self._profile_for(lp))
        return c if c < lp else 0

    def prefix_peek(self, lp: int, tokens: np.ndarray) -> int:
        """Longest stored prefix match (0 without a store)."""
        if self.prefix_store is None:
            return 0
        return self.prefix_store.peek(lp, tokens)

    def prefix_peek_req(self, r: Request) -> int:
        """prefix_peek for a whole request, with the prompt bucket and token
        ids admission itself would use."""
        if self.prefix_store is None:
            return 0
        n = max(1, int(r.length))
        lp = max(self.ec.min_prompt_len, next_pow2(n))
        return self.prefix_store.peek(lp, self._prompt_tokens(r, n))

    def _begin_chunked(self, reqs: List[Request], lp: int, chunk: int,
                       now: Optional[float] = None) -> None:
        """Reserve slots for a chunked admission group and queue its prompt
        block; chunks run one per engine step (_advance_chunks).

        With a prefix store, each prompt is looked up first: a hit pins the
        matched path (until retire or cancel), scatters the stored K/V into
        the row's true positions [0, m) and resumes chunked prefill at
        padded column off + m, a chunk multiple (m <= n - 1 so the final
        chunk still produces the first token; m = n mod chunk). The group
        splits into one _ChunkAdmission per resume column."""
        self._ensure_pool()
        free = [i for i, s in enumerate(self._slots) if s is None]
        assert len(reqs) <= len(free), (len(reqs), len(free))
        assert lp % chunk == 0, (lp, chunk)  # both pow2, chunk < lp
        assert self._clock >= lp
        bp = self.ec.max_slots
        toks = np.zeros((bp, lp), np.int64)
        off = np.full(bp, lp, np.int64)  # sentinel: rows not ours stay masked
        slots = free[: len(reqs)]
        t = self._stamp(now)
        by_base: Dict[int, Tuple[List[Request], List[int]]] = {}
        hits: List[Tuple[int, int, Any]] = []  # (slot, m, host K/V tree)
        pre_stamped: set = set()
        for i, r in enumerate(reqs):
            n = max(1, int(r.length))
            s = slots[i]
            prompt = self._prompt_tokens(r, n)
            toks[s, lp - n:] = prompt
            off[s] = lp - n
            m = self._prefix_match(r, lp, chunk, n, prompt, hits, s)
            self._slots[s] = _Slot(req=r, budget=self._budget(r), produced=[],
                                   live=False, filled=m)
            self._pool_off[s] = self._clock - m  # refreshed per segment
            r.dispatched_at = t
            col = (lp - n) + m if m else 0
            if m and col >= lp:
                # the whole prompt came from the store: stamp TTFT now and
                # rerun the last chunk (an idempotent K/V rewrite) for the
                # first token. The n - 1 cap of _prefix_match keeps this
                # unreachable; it guards that no request retires without a
                # first-token stamp.
                r.first_token_at = t
                pre_stamped.add(s)
                self._slots[s].filled = lp - int(off[s]) - chunk
                col = lp - chunk
            g = by_base.setdefault(col, ([], []))
            g[0].append(r)
            g[1].append(s)
        if hits:
            self._scatter_hits(hits, lp, t)
        for base, (greqs, gslots) in sorted(by_base.items()):
            self._chunk_q.append(_ChunkAdmission(
                reqs=greqs, slots=gslots, toks=toks, off=off, lp=lp,
                chunk=chunk, base=base,
                stamped=[s for s in gslots if s in pre_stamped]))

    def _prefix_match(self, r: Request, lp: int, chunk: int, n: int,
                      prompt: np.ndarray, hits: List, s: int) -> int:
        """Radix lookup for one admission row: the usable matched length m
        (0 = cold); records the pinned lease and the host K/V for the
        batched scatter."""
        self.stats["prefix_prompt_tokens"] += n
        if self.prefix_store is None:
            return 0
        lease = self.prefix_store.lookup(lp, prompt)
        if lease is None:
            return 0
        cap = min(lease.match_len, n - 1)
        m = cap - ((cap - n) % chunk)  # largest m <= cap with m = n (mod c)
        if m <= 0:
            self.prefix_store.release(lease)
            return 0
        self._prefix_leases[r.rid] = lease
        hits.append((s, m, self.prefix_store.kv_prefix(lease, m)))
        self.stats["prefix_hits"] += 1
        self.stats["prefix_hit_tokens"] += m
        return m

    def _scatter_hits(self, hits: List[Tuple[int, int, Any]], lp: int,
                      t: float) -> None:
        """Batched scatter of this admission's prefix hits: one prefill-cache-
        shaped tree (hit rows at their slot index, true positions [0, m)
        filled, the rest zero — columns the suffix chunks overwrite or the
        causal mask hides), copied to the device and scattered into the
        pool in place."""
        bp = self.ec.max_slots
        sids = np.full(bp, bp, np.int64)  # out-of-range rows -> dropped
        batch = _map_tree(lambda leaf: np.zeros(
            (leaf.shape[0], bp, lp) + leaf.shape[2:], leaf.dtype), hits[0][2])
        bk, bv = lm._kv_leaves(batch)
        for s, m, kv in hits:
            sids[s] = s
            hk, hv = lm._kv_leaves(kv)
            bk[:, s, :m] = hk
            bv[:, s, :m] = hv
        pool_dtype = lm._kv_leaves(self._pool)[0].dtype
        dev = _map_tree(lambda a: self._from_host(a, pool_dtype), batch)
        self._shape_use("prefix_scatter", lp, "prefix_scatter_traces")
        self._pool = self.model.scatter_prefix_into_slots(self._pool, dev,
                                                          self._dev(sids), lp)
        self.tracer.event(tm.PREFIX_SCATTER, t, sid=self._sid, tenant=self._tenant,
                          bucket=lp, rows=len(hits), tokens=sum(m for _, m, _ in hits))

    def _from_host(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        t = torch.from_numpy(a).to(self.device)
        return t.view(dtype) if dtype in _HOST_BITS else t

    def _advance_chunks(self, now: Optional[float] = None) -> bool:
        """Advance every in-flight chunked admission by ONE chunk, merging
        admissions of the same (chunk len, prompt bucket) class into one
        call (per-row start positions)."""
        if not self._chunk_q:
            return False
        classes: Dict[Tuple[int, int], List[_ChunkAdmission]] = {}
        for adm in self._chunk_q:
            classes.setdefault((adm.chunk, adm.lp), []).append(adm)
        for (c, lp), adms in classes.items():
            self._chunk_step(c, lp, adms, now)
        self._chunk_q = [a for a in self._chunk_q if a.base + a.pos < a.lp]
        return True

    def _chunk_step(self, c: int, lp: int, adms: List[_ChunkAdmission],
                    now: Optional[float] = None) -> None:
        """Run one chunk for every admission of a (chunk, bucket) class in
        ONE call; admissions reaching their final chunk flip their rows live
        (decode starts at the next segment)."""
        bp = self.ec.max_slots
        toks = np.zeros((bp, c), np.int64)
        off = np.full(bp, lp, np.int64)   # sentinel: rows not ours, masked
        start = np.zeros(bp, np.int64)
        for adm in adms:
            for s in adm.slots:
                col = adm.base + adm.pos  # prefix hits resume past base
                toks[s] = adm.toks[s, col:col + c]
                off[s] = adm.off[s]
                start[s] = col
        self._shape_use("chunk", (c, lp), "prefill_traces")
        t0 = time.monotonic()
        tok0, self._pool = self.model.prefill_chunk_into_slots(
            self._dev(toks), self._pool, self._dev(start), pos_offset=self._dev(off), lp=lp)
        tok0 = tok0.cpu().numpy()
        exec_s = time.monotonic() - t0
        self._observe_exec(exec_s)
        self.stats["prefill_calls"] += 1
        self.tracer.event(tm.PREFILL_CHUNK, self._stamp(now), sid=self._sid,
                          tenant=self._tenant, bucket=lp, chunk=c,
                          rows=sum(len(a.slots) for a in adms),
                          dur=None if self._virtual else exec_s)
        finished: List[_ChunkAdmission] = []
        for adm in adms:
            adm.pos += c
            for s in adm.slots:
                self._slots[s].filled = max(0, adm.base + adm.pos - int(adm.off[s]))
            if adm.base + adm.pos >= adm.lp:
                finished.append(adm)
        if not finished:
            return
        # final chunk: column lp-1 is every row's last true prompt position,
        # so its greedy tokens seed decode as prefill_into_slots' do
        t = self._stamp(now)
        for adm in finished:
            for s in adm.slots:
                st = self._slots[s]
                n = adm.lp - int(adm.off[s])
                self._pool_off[s] = self._clock - n
                self._tok[s] = tok0[s]
                st.produced = [int(tok0[s, 0])]
                st.live = True
                if s not in adm.stamped:
                    st.req.first_token_at = t  # TTFT: the final chunk's token
            self.stats["admitted"] += len(adm.reqs)
        self._retire_finished(t)

    def _decode_segment(self, steps: int, now: Optional[float] = None) -> None:
        """One segment over the whole pool; finished rows retire after."""
        # mid-prefill rows: pin the (ignored) segment write to ring slot
        # `filled` — at or above the written prefix, below the pool ring
        for s, st in enumerate(self._slots):
            if st is not None and not st.live:
                self._pool_off[s] = self._clock - st.filled
        self._shape_use("segment", int(steps), "segment_traces", count_hit=False)
        t0 = time.monotonic()
        toks, self._pool = self.model.decode_segment(
            self._pool, self._dev(self._tok), self._clock,
            steps=int(steps), pos_offset=self._dev(self._pool_off))
        toks = toks.cpu().numpy()
        self._clock += steps
        if self._clock >= self.ec.max_prompt_len + 8 * self.pool_len:
            self._rebase_clock()
        self._tok = toks[:, -1:].astype(np.int64).copy()
        done = time.monotonic()
        exec_s = done - t0
        self._observe_exec(exec_s)
        self.stats["segments"] += 1
        self.stats["decode_steps"] += int(steps)
        n_active = self.ec.max_slots - self._free_slots()
        self._h_occ.observe(n_active / self.ec.max_slots)
        stamp = now if (self._virtual and now is not None) else done
        self.tracer.event(tm.DECODE_SEGMENT, stamp, sid=self._sid, tenant=self._tenant,
                          steps=int(steps), active=n_active,
                          dur=None if self._virtual else exec_s)
        for s, st in enumerate(self._slots):
            if st is None or not st.live:
                continue  # mid-prefill rows produce nothing yet
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
            if st is None or not st.live:
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
            self.tracer.event(tm.RETIRE, now, rid=r.rid, sid=self._sid,
                              tenant=self._tenant, tokens=len(r.payload))
            # the row's prompt K/V (true positions [0, n), which decode never
            # overwrites) is donor material for later shared-prefix hits
            self._prefix_insert_on_retire(s, st)
            self._slots[s] = None  # stale KV stays masked for the next occupant
            self.stats["retired"] += 1

    def _prefix_insert_on_retire(self, s: int, st: _Slot) -> None:
        """Release the row's lease and store its prompt's K/V, cut to the
        smallest chunk quantum, unless the store already holds it."""
        if self.prefix_store is None:
            return
        r = st.req
        lease = self._prefix_leases.pop(r.rid, None)
        if lease is not None:
            self.prefix_store.release(lease)
        n = max(1, int(r.length))
        q = min(self._chunk_lens)
        m_ins = (n // q) * q
        lp = max(self.ec.min_prompt_len, next_pow2(n))
        if m_ins <= 0:
            return
        prompt = self._prompt_tokens(r, n)
        if self.prefix_store.peek(lp, prompt[:m_ins]) >= m_ins:
            return  # already stored bit for bit; skip the device copy
        self.prefix_store.insert(lp, prompt[:m_ins], self._extract_prefix(s, m_ins))
        self.stats["prefix_inserts"] += 1

    def _extract_prefix(self, s: int, m: int):
        """Host copy of pool row s, true positions [0, m): leaves [L, m, kh,
        hd] (bf16 kept as its int16 bits)."""
        def f(leaf):
            row = leaf[:, s, :m]
            if row.dtype in _HOST_BITS:
                row = row.view(_HOST_BITS[row.dtype])
            return row.cpu().numpy()
        return _map_tree(f, self._pool)

    def mean_slot_occupancy(self) -> float:
        return float(self._h_occ.mean)

    def slots_in_use(self) -> int:
        """Occupied KV pool rows right now (pipelined-runtime telemetry)."""
        if not self.ec.continuous:
            return 0
        return self.ec.max_slots - self._free_slots()

    def slot_capacity(self) -> int:
        return self.ec.max_slots if self.ec.continuous else 0

    def prefix_lease_count(self) -> int:
        """Prefix-store pins held by in-flight requests (0 once every owner
        retired or was cancelled)."""
        return len(getattr(self, "_prefix_leases", {}) or {})


def build_engine(cfg: ModelConfig, *, seed: int = 0, ec: Optional[EngineConfig] = None,
                 device: DeviceLike = "cuda",
                 params: Optional[Dict[str, Any]] = None) -> ServingEngine:
    """A ServingEngine with knee-derived batching policy. Weights: `params`
    (e.g. carried from the JAX package by models.params.from_reference), or
    seeded ones from `seed`, in cfg.dtype, on `device`."""
    from repro_torch.core.batching import analytical_knee, derive_policy, kv_bytes_per_token

    check_servable(cfg)
    ec = EngineConfig() if ec is None else ec
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
    return ServingEngine(cfg, LM(cfg, params), policy, ec, device=dev,
                         knee_profiles=profiles)
