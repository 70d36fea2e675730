"""Batch_knee / Time_knee estimation (paper §3.2, §4.3).

Two estimators:

* `profile_knee` — the paper's offline profiling: measure latency(b) for a
  sweep of batch sizes on the target slice, derive throughput(b) = b/lat(b),
  and take the knee as the largest b that still improves throughput by more
  than `eps` per doubling ("once throughput plateaus, tail latency spikes").

* `analytical_knee` — on a memory-bound decode step the knee IS the roofline crossover, i.e. the batch where the
  compute term first exceeds the weight+cache read term. This turns the
  paper's empirical observation ("Batch_knee is smaller on smaller slices")
  into a first-principles model; profiling remains as validation.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM data-sheet peaks (not measured here): dense bf16
# tensor-core rate and HBM3 bandwidth at the 700 W power limit.
from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS


@dataclass(frozen=True)
class KneeProfile:
    batch_sizes: Tuple[int, ...]
    latencies: Tuple[float, ...]          # seconds per batch
    batch_knee: int
    time_knee: float                      # latency at the knee (paper's ~35ms)

    def throughput(self, i: int) -> float:
        return self.batch_sizes[i] / self.latencies[i]


def find_knee(batch_sizes: Sequence[int], latencies: Sequence[float],
              eps: float = 0.10) -> KneeProfile:
    """Knee = largest batch whose throughput still improves > eps over the
    previous point. Requires ascending batch sizes."""
    assert len(batch_sizes) == len(latencies) and len(batch_sizes) >= 1
    knee_i = 0
    for i in range(1, len(batch_sizes)):
        t_prev = batch_sizes[i - 1] / latencies[i - 1]
        t_cur = batch_sizes[i] / latencies[i]
        gain = (t_cur - t_prev) / max(t_prev, 1e-12)
        # normalize gain per doubling so irregular sweeps behave
        steps = math.log2(batch_sizes[i] / batch_sizes[i - 1]) or 1.0
        if gain / steps > eps:
            knee_i = i
        else:
            break
    return KneeProfile(
        tuple(batch_sizes), tuple(latencies),
        batch_sizes[knee_i], latencies[knee_i],
    )


def profile_knee(run_batch: Callable[[int], float],
                 max_batch: int = 512, eps: float = 0.10) -> KneeProfile:
    """Offline profiling sweep (paper: 'several minutes, amortized over
    millions of queries'). `run_batch(b)` returns measured seconds."""
    bs: List[int] = []
    lats: List[float] = []
    b = 1
    while b <= max_batch:
        bs.append(b)
        lats.append(run_batch(b))
        b *= 2
    return find_knee(bs, lats, eps)


def analytical_decode_latency(
    n_params_active: int,
    batch: int,
    *,
    chips: int,
    context_len: int = 0,
    kv_bytes_per_token: int = 0,
    weight_bytes: Optional[int] = None,
    seq_len: int = 1,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    overhead_s: float = 3e-4,
) -> float:
    """Roofline latency of one decode step of `batch` sequences on a slice.

    compute = 2 * N_active * batch * seq / (chips * peak)
    memory  = (weights + batch * context * kv_bytes) / (chips * bw)
    """
    wb = weight_bytes if weight_bytes is not None else 2 * n_params_active
    t_c = 2.0 * n_params_active * batch * seq_len / (chips * peak_flops)
    t_m = (wb + batch * context_len * kv_bytes_per_token) / (chips * hbm_bw)
    return max(t_c, t_m) + overhead_s


def analytical_knee(
    n_params_active: int,
    *,
    chips: int,
    context_len: int = 0,
    kv_bytes_per_token: int = 0,
    weight_bytes: Optional[int] = None,
    max_batch: int = 4096,
    eps: float = 0.10,
) -> KneeProfile:
    """Knee from the analytical latency curve. Smaller slices (fewer chips)
    yield smaller knees — the paper's core MIG observation, derived."""
    bs: List[int] = []
    lats: List[float] = []
    b = 1
    while b <= max_batch:
        bs.append(b)
        lats.append(
            analytical_decode_latency(
                n_params_active, b, chips=chips, context_len=context_len,
                kv_bytes_per_token=kv_bytes_per_token, weight_bytes=weight_bytes,
            )
        )
        b *= 2
    return find_knee(bs, lats, eps)


def profiles_to_json(profiles: Dict[int, KneeProfile]) -> str:
    """Deterministic JSON for a {context bucket: KneeProfile} map — the
    calibration artifact `serve.py --calibrate-knee` writes and
    `--knee-profiles` reads back."""
    out = {
        str(b): {
            "batch_sizes": list(p.batch_sizes),
            "latencies": list(p.latencies),
            "batch_knee": p.batch_knee,
            "time_knee": p.time_knee,
        }
        for b, p in sorted(profiles.items())
    }
    return json.dumps(out, sort_keys=True, indent=1)


def profiles_from_json(text: str) -> Dict[int, KneeProfile]:
    """Inverse of `profiles_to_json` (round-trips exactly)."""
    raw = json.loads(text)
    out: Dict[int, KneeProfile] = {}
    for b, d in raw.items():
        out[int(b)] = KneeProfile(
            tuple(int(x) for x in d["batch_sizes"]),
            tuple(float(x) for x in d["latencies"]),
            int(d["batch_knee"]),
            float(d["time_knee"]),
        )
    return out


def calibrate_knees(
    measure: Callable[[int, int], float],
    buckets: Sequence[int],
    bucket_width: int,
    *,
    max_batch: int = 64,
    eps: float = 0.10,
) -> Dict[int, KneeProfile]:
    """Measured calibration pass: for each context
    bucket, sweep batch sizes through `measure(batch, context_len) ->
    seconds` (a real timed decode step — `serve.py --calibrate-knee`
    supplies one) and find the knee. Returns the {bucket: KneeProfile}
    map the engine factories and the partition controller's cost model
    consume, replacing the analytical default with measurements."""
    out: Dict[int, KneeProfile] = {}
    for b in buckets:
        context_len = int((b + 0.5) * bucket_width)
        out[b] = profile_knee(
            lambda bs, _cl=context_len: measure(bs, _cl),
            max_batch=max_batch, eps=eps)
    return out


def kv_bytes_per_token(cfg) -> int:
    """Per-token per-sequence KV (or SSM state amortization -> 0) bytes."""
    if cfg.family == "ssm":
        return 0
    n_attn = sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
    return n_attn * 2 * cfg.n_kv_heads * cfg.hd * 2  # k+v, bf16
