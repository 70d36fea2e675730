"""Event-driven inference-server simulator (discrete time, deterministic).

Composes the full PREBA pipeline: arrivals -> preprocessing (CPU pool or
DPU) -> bucketized dynamic batching -> slice execution (a caller-supplied
latency model), mirroring Fig. 3/10 end-to-end. A host-side cost model: it
launches no kernel. The DPU's preprocessing times come from its CUs'
analytical cost models (core/dpu/pipeline.py); the batch execution and CPU
preprocessing costs are the caller's callables (measured knee profiles or
kernel times from the card, for instance). The serving runtime exercises
the same component code paths on real engines.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.batching.buckets import Batch, BucketedBatcher, Request
from repro_torch.core.batching.policy import BatchPolicy
from repro_torch.core.batching.scheduler import BatchSliceScheduler
from repro_torch.core.dpu.runtime import DPU, CpuPreprocessPool, DpuConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class SimConfig:
    n_slices: int = 16
    preprocess: str = "dpu"              # dpu | cpu | none (Ideal)
    cpu_cores: int = 32
    dpu_cus: int = 4
    split_audio_cus: bool = True
    dynamic_batching: bool = True        # False => static Batch_max=1..N greedy
    static_batch: int = 8
    hedge_factor: float = 3.0
    straggler_prob: float = 0.0          # inject stragglers (fault tolerance)
    straggler_slowdown: float = 5.0
    fail_slice_at: Optional[Tuple[int, float]] = None  # (slice_id, time)
    seed: int = 0


@dataclass
class SimResult:
    completed: List[Request]
    horizon: float
    hedges: int
    batches: int
    batch_sizes: List[int]
    preprocess_wait: List[float]
    queue_wait: List[float]
    exec_time: List[float]

    @property
    def qps(self) -> float:
        return len(self.completed) / self.horizon if self.horizon else 0.0

    def latency_percentile(self, q: float) -> float:
        lats = [r.completed_at - r.arrival for r in self.completed]
        return float(np.percentile(lats, q)) if lats else float("nan")

    @property
    def p95_ms(self) -> float:
        return 1e3 * self.latency_percentile(95)

    def breakdown_ms(self) -> Dict[str, float]:
        f = lambda xs: 1e3 * float(np.mean(xs)) if xs else 0.0
        return {
            "preprocess": f(self.preprocess_wait),
            "batching": f(self.queue_wait),
            "execution": f(self.exec_time),
        }


def simulate(
    requests: List[Request],
    policy: BatchPolicy,
    exec_latency_s: Callable[[Batch], float],
    preprocess_cost_s: Callable[[float], float],  # of input length
    cfg: SimConfig,
    device: DeviceLike = "cuda",
    dpu_costs: Optional[Dict[str, Callable[[Any], float]]] = None,
) -> SimResult:
    """Replay `requests` through the modeled pipeline. `device` is where the
    DPU's functional units would run (`preprocess="dpu"`): the card by
    default, as every entry point of the package; pass device="cpu" on a
    machine without one. A CUDA device that is not there raises, whatever
    the preprocessing mode. `dpu_costs`: {functional unit name: seconds of
    a request of that input length}, measured costs that replace the DPU's
    analytical ones (`core/dpu/pipeline.py`) on the virtual clock."""
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    batcher = BucketedBatcher(policy)
    # analytic whole-batch slice latencies -> the batch-granularity scheduler
    # (the real serving path streams requests per slot; see multislice.py)
    sched = BatchSliceScheduler(cfg.n_slices, hedge_factor=cfg.hedge_factor)

    if cfg.preprocess == "cpu":
        pre = CpuPreprocessPool(cfg.cpu_cores, preprocess_cost_s)
    elif cfg.preprocess == "dpu":
        pre = DPU(DpuConfig(n_cus=cfg.dpu_cus, split_audio_cus=cfg.split_audio_cus),
                  device=device)
        for unit in (u for pool in pre.stages for u in pool.cu.units):
            if dpu_costs and unit.name in dpu_costs:
                unit.cost_s = dpu_costs[unit.name]
    else:
        pre = None

    # event heap: (time, seq, kind, payload)
    events: List[Tuple[float, int, str, Any]] = []
    seq = 0

    def push(t, kind, payload=None):
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, payload))
        seq += 1

    for r in requests:
        push(r.arrival, "arrive", r)
    if cfg.fail_slice_at is not None:
        sid, t = cfg.fail_slice_at
        push(t, "fail", sid)

    completed: List[Request] = []
    batch_sizes: List[int] = []
    pre_wait: List[float] = []
    q_wait: List[float] = []
    x_time: List[float] = []
    now = 0.0
    next_tick = -1.0

    def try_dispatch(now: float):
        for b in list(sched.requeued):
            sched.requeued.remove(b)
            _dispatch(b, now)
        for b in batcher.poll(now):
            _dispatch(b, now)

    def _dispatch(b: Batch, now: float):
        t_exec = exec_latency_s(b)
        if cfg.straggler_prob and rng.random() < cfg.straggler_prob:
            t_exec *= cfg.straggler_slowdown
        sid = sched.dispatch(b, now, expected_s=exec_latency_s(b))
        if sid is None:
            sched.requeued.append(b)  # all slices busy; retry on next event
            return
        push(now + t_exec, "exec_done", (sid, b, t_exec))

    while events:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            r: Request = payload
            if pre is None:
                r.preprocessed_at = now
                batcher.enqueue(r)
            else:
                done = pre.submit(now, r.length)
                push(done, "pre_done", r)
        elif kind == "pre_done":
            r = payload
            r.preprocessed_at = now
            batcher.enqueue(r)
        elif kind == "exec_done":
            sid, b, t_exec = payload
            got = sched.complete(sid, now)
            if got is not None:
                batch_sizes.append(got.size)
                for r in got.requests:
                    completed.append(r)
                    pre_wait.append((r.preprocessed_at or r.arrival) - r.arrival)
                    q_wait.append((r.dispatched_at or now) - (r.preprocessed_at or r.arrival))
                    x_time.append(now - (r.dispatched_at or now))
        elif kind == "fail":
            sched.fail_slice(payload)
        # hedging check + dispatch on every event
        for sid in sched.stragglers(now):
            twin = sched.hedge(sid, now)
            if twin is not None:
                st = sched.slices[twin]
                push(now + st.expected_s, "exec_done", (twin, st.inflight, st.expected_s))
        try_dispatch(now)
        # schedule a wakeup at the batcher's next deadline (deduplicated)
        dl = batcher.next_deadline()
        if dl is not None and dl > now and abs(dl - next_tick) > 1e-12:
            next_tick = dl
            push(dl + 1e-9, "tick", None)

    horizon = max((r.completed_at for r in completed), default=0.0)
    return SimResult(
        completed=completed, horizon=horizon, hedges=sched.hedges,
        batches=batcher.formed, batch_sizes=batch_sizes,
        preprocess_wait=pre_wait, queue_wait=q_wait, exec_time=x_time,
    )
