"""DPU runtime: request-level parallelism over multiple CUs (paper Fig. 10).

Design objectives carried over from the paper:
  1. latency-centric — single-input requests are preprocessed immediately on
     arrival (no preprocessing-side batching), maximizing the downstream
     batcher's freedom;
  2. throughput via replication — multiple CU instances process independent
     requests concurrently;
  3. fine-grained scheduling across CU *types* for audio so Normalize's
     global-stats barrier never stalls Resample+Mel (Fig. 12c).

`DPU.submit` is the event-driven (virtual-clock) interface the serving
simulator and the service's virtual clock use; `DPU.process` and
`DPU.process_batch` are the real-execution paths. `CpuPreprocessPool` is
the host-core baseline the simulator compares it with.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dpu.pipeline import (ComputeUnit, make_audio_cus,
                                           make_audio_fused_cu, make_image_cu)
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class DpuConfig:
    modality: str = "audio"         # audio | image
    n_cus: int = 4                  # CU instances per type
    backend: str = "cpu"            # cpu (numpy baseline) | dpu (CUDA kernels)
    split_audio_cus: bool = True    # False = Fig.12(b) strawman (ablation)


def group_key(x: Any) -> Any:
    """THE grouping key for batched preprocessing (process_batch and the
    DpuService drain loop both use it — keep them in sync):

    * array payloads group by `.shape` (a same-shape stack is one kernel
      launch per functional unit);
    * dict payloads (JPEG {"coeffs", "qtable"}) group by the sorted
      (field name, field shape) items, so two requests land in one group
      iff every field is shape-compatible for stacking;
    * payloads with no `.shape` group together.

    Grouping NEVER changes result order: DPU.process_batch scatters each
    group's outputs back to the input indices, so out[i] always corresponds
    to xs[i]."""
    if isinstance(x, dict):
        return tuple(sorted((k, getattr(v, "shape", None)) for k, v in x.items()))
    return getattr(x, "shape", None)


def payload_error(x: Any, modality: str = "audio") -> Optional[str]:
    """Structural front-door validation of a RAW payload, cheap enough to
    run per request at ingest: returns a reason string when the payload
    would crash (or poison) a batched CU launch, None when well-formed.
    audio: a non-empty 1-D float array (the waveform the resample/feature
    CUs expect). image: the decoded-JPEG dict analogue of a parseable
    header — `coeffs` a non-empty 4-D numeric block array and an 8x8
    `qtable`. The point is to shed garbage with a typed reason at the door
    instead of killing a whole same-shape group mid-batch."""
    if modality == "image":
        if not isinstance(x, dict):
            return "image payload must be a dict with coeffs/qtable"
        for k in ("coeffs", "qtable"):
            if k not in x:
                return f"image payload missing {k!r}"
            v = x[k]
            if not isinstance(v, np.ndarray) or v.size == 0 \
                    or not np.issubdtype(v.dtype, np.number):
                return f"image {k} must be a non-empty numeric ndarray"
        if x["coeffs"].ndim != 4:
            return "image coeffs must be 4-D (blocks_h, blocks_w, 8, 8)"
        if x["qtable"].shape != (8, 8):
            return "image qtable must be 8x8"
        return None
    if not isinstance(x, np.ndarray):
        return "audio payload must be a 1-D float ndarray"
    if x.ndim != 1:
        return f"audio payload must be 1-D, got ndim={x.ndim}"
    if x.size == 0:
        return "audio payload is empty"
    if not np.issubdtype(x.dtype, np.floating):
        return f"audio payload must be float, got {x.dtype}"
    return None


class _CuPool:
    """Instances of one CU type with earliest-free scheduling."""

    def __init__(self, cu: ComputeUnit, n: int):
        self.cu = cu
        self.free_at = [0.0] * n

    def schedule(self, now: float, x: Any) -> Tuple[float, float]:
        """Returns (start, done). Occupies the CU for occupancy_s but the
        request completes after latency_s (pipelined)."""
        i = min(range(len(self.free_at)), key=lambda j: self.free_at[j])
        start = max(now, self.free_at[i])
        self.free_at[i] = start + self.cu.occupancy_s(x)
        return start, start + self.cu.latency_s(x)


class DPU:
    """The CU pool. With backend='dpu' its functional units run the Hopper
    kernels on `device` (default the card; pass device='cpu' for their plain
    versions)."""

    def __init__(self, config: DpuConfig, device: DeviceLike = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        if config.modality == "image":
            self.stages = [_CuPool(make_image_cu(config.backend, self.device),
                                   config.n_cus)]
        elif config.split_audio_cus:
            cu_a, cu_b = make_audio_cus(config.backend, self.device)
            self.stages = [_CuPool(cu_a, config.n_cus), _CuPool(cu_b, config.n_cus)]
        else:
            self.stages = [_CuPool(make_audio_fused_cu(config.backend, self.device),
                                   config.n_cus)]
        self.processed = 0

    # --- virtual-clock path ------------------------------------------------
    def submit(self, now: float, x: Any) -> float:
        """Returns the completion time of preprocessing for one request."""
        t = now
        for pool in self.stages:
            _, t = pool.schedule(t, x)
        self.processed += 1
        return t

    # --- real-execution path -----------------------------------------------
    def process(self, x: Any) -> Any:
        for pool in self.stages:
            x = pool.cu.process(x)
        self.processed += 1
        return x

    def process_batch(self, xs: List[Any]) -> List[Any]:
        """Preprocess a stack of requests; same-shape groups (key:
        `group_key`) go through the CU batch path (one kernel launch per FU
        per stack) instead of one launch per request. out[i] is ALWAYS the
        preprocessed xs[i]."""
        groups: Dict[Any, List[int]] = {}
        for i, x in enumerate(xs):
            groups.setdefault(group_key(x), []).append(i)
        out: List[Any] = [None] * len(xs)
        for idxs in groups.values():
            ys = [xs[i] for i in idxs]
            for pool in self.stages:
                ys = pool.cu.process_batch(ys)
            for i, y in zip(idxs, ys):
                out[i] = y
        self.processed += len(xs)
        return out

    def latency_s(self, x: Any) -> float:
        return sum(p.cu.latency_s(x) for p in self.stages)


# ---------------------------------------------------------------------------
# CPU-baseline preprocessing pool (the paper's bottleneck, §3.3)
# ---------------------------------------------------------------------------


@dataclass
class CpuPreprocessPool:
    """Host-core preprocessing: `n_cores` workers, each non-pipelined (a
    core runs the whole pipeline per request). Models the paper's saturation:
    demand scales with the number of active inference servers while the core
    pool is fixed."""

    n_cores: int
    cost_per_request_s: Callable[[Any], float]
    free_at: List[float] = field(default_factory=list)

    def __post_init__(self):
        self.free_at = [0.0] * self.n_cores

    def submit(self, now: float, x: Any) -> float:
        i = min(range(self.n_cores), key=lambda j: self.free_at[j])
        start = max(now, self.free_at[i])
        done = start + self.cost_per_request_s(x)
        self.free_at[i] = done
        return done

    def utilization(self, horizon: float) -> float:
        busy = sum(min(t, horizon) for t in self.free_at)
        return busy / (self.n_cores * horizon) if horizon > 0 else 0.0
