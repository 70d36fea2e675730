"""End-to-end PREBA audio serving study on the PyTorch package (the
paper's headline experiment):

  raw audio -> DPU preprocessing (resample -> mel -> normalize: the three
  hand-written CUDA kernels, two CU types) -> bucketized dynamic batching
  -> whisper-family backbone on MIG slices of one H100

compares Baseline (CPU preprocessing, static batching) against full PREBA
on the event-driven simulator, then runs one utterance through the real
DPU kernels to show the numerics.

    PYTHONPATH=src python examples/serve_audio_preba_torch.py               # on the GPU
    PYTHONPATH=src python examples/serve_audio_preba_torch.py --device cpu  # plain versions

Every cost is the H100's or this host's, none a TPU's:
- the slice menu is the H100 80GB MIG profiles (`core/slicing/mig.py`);
  a slice's roofline share is its fraction of the card's seven compute
  slices, and a batch's execution time is the analytical decode latency
  at the H100 data-sheet peaks times that share;
- the CPU preprocessing cost is measured here, on the host, with the
  package's plain CPU pipeline (`data/preprocess_cpu.audio_pipeline`) on
  one 7.5 s utterance at 48 kHz, and scales with the utterance's length;
- the DPU's per-unit costs are measured on the card, each unit's whole
  call (resample, mel, normalize) on one 7.5 s utterance (CUDA events);
  on the CPU they are PERF.md §6 rows 1-3 (the kernels at the serve shape,
  16 x 48,000 samples, NVIDIA H100 80GB HBM3 at 700.00 W). A request
  longer than the timed input costs in proportion; a shorter one what the
  timed input costs (a launch-bound kernel).

This script keeps its own copies of the JAX package's benchmark helpers
(`benchmarks/common.py`: the slice menu, `exec_model`, `policy_for`,
`audio_pre_cost`), rebuilt on those costs.
"""
import argparse
import copy
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.batching import (analytical_decode_latency, analytical_knee,
                                       derive_policy, kv_bytes_per_token)
from repro_torch.core.batching.buckets import Batch
from repro_torch.core.dpu.runtime import DPU, DpuConfig
from repro_torch.core.slicing.mig import H100_COMPUTE_SLICES, H100_MIG_PROFILES
from repro_torch.data import preprocess_cpu
from repro_torch.device import resolve_device
from repro_torch.serving.requests import WorkloadSpec, generate_requests
from repro_torch.serving.simulator import SimConfig, simulate

ARCH = "whisper-base"
SLICE = "1g.10gb(7x)"      # the paper's finest partitioning (1g.5gb(7x) on an A100)
DECODE_STEPS, CTX_PER_SEC = 20, 100
IN_SR = 48_000
CAL_SECONDS = 7.5          # the utterance the preprocessing costs are timed on

# H100 80GB MIG profiles: name -> the slice's fraction of the card and the
# slices of the uniform partitioning
SLICE_MENU = {f"{name}({n}x)": dict(chips=g / H100_COMPUTE_SLICES, n_slices=n)
              for name, g, n in H100_MIG_PROFILES}

# PERF.md §6 rows 1-3: each DPU kernel's device ms at the serve shape, 16
# utterances of 48,000 samples (NVIDIA H100 80GB HBM3, 700.00 W)
PERF_DPU_MS = {"resample": 0.0084, "mel": 0.0112, "normalize": 0.0088}
PERF_DPU_SAMPLES = 16 * 48_000


def exec_model(arch: str, chips: float, decode_steps: int, ctx_per_sec: int):
    """(cfg, active params, KV bytes a token, a batch's execution seconds on
    a slice of `chips` cards)."""
    cfg = get_config(arch)
    n = cfg.active_param_count()
    kvb = kv_bytes_per_token(cfg)

    def lat(batch: Batch) -> float:
        ctx = int(batch.max_length * ctx_per_sec) if ctx_per_sec else int(batch.max_length)
        return decode_steps * analytical_decode_latency(
            n, batch.size, chips=chips, context_len=ctx, kv_bytes_per_token=kvb)

    return cfg, n, kvb, lat


def policy_for(arch: str, chips: float, n_slices: int, ctx_per_sec: int = CTX_PER_SEC,
               decode_steps: int = DECODE_STEPS, bucket_width: float = 2.5):
    """The knee-derived batching policy of a slice (knees of a whole
    request's decode steps)."""
    cfg = get_config(arch)
    n = cfg.active_param_count()
    kvb = kv_bytes_per_token(cfg)
    profiles = {
        bkt: analytical_knee(
            n, chips=chips,
            context_len=int((bkt + 0.5) * bucket_width * max(1, ctx_per_sec)),
            kv_bytes_per_token=kvb)
        for bkt in range(12)
    }
    profiles = {k: type(p)(p.batch_sizes, tuple(t * decode_steps for t in p.latencies),
                           p.batch_knee, p.time_knee * decode_steps)
                for k, p in profiles.items()}
    return derive_policy(profiles, n_slices=n_slices, bucket_width=bucket_width)


def utterance(seconds: float, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(int(IN_SR * seconds)).astype(np.float32)


def cpu_cost_s(repeats: int = 5) -> float:
    """Seconds of the plain CPU pipeline on one CAL_SECONDS utterance on
    this host: the median of `repeats` runs after one warm-up."""
    x = utterance(CAL_SECONDS, seed=1)
    preprocess_cpu.audio_pipeline(x)
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        preprocess_cpu.audio_pipeline(x)
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def audio_pre_cost(cost_s: float):
    """A request's CPU preprocessing seconds, in proportion to its length."""
    return lambda length_s: cost_s * length_s / CAL_SECONDS


def dpu_unit_ms(device, n: int = 25) -> dict:
    """Each audio unit's whole call on the card (ms, CUDA events, after a
    warm-up) on one CAL_SECONDS utterance, each on the previous unit's
    output."""
    import torch

    dpu = DPU(DpuConfig(modality="audio", backend="dpu"), device)
    units = [u for pool in dpu.stages for u in pool.cu.units]
    x, out = utterance(CAL_SECONDS, seed=1), {}
    for u in units:
        y = u.fn(x)
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            u.fn(x)
        end.record()
        torch.cuda.synchronize(device)
        out[u.name] = start.elapsed_time(end) / n
        x = y
    return out


def dpu_costs(unit_ms: dict, samples: int) -> dict:
    """{unit: seconds of a request of length_s}: the unit's time on
    `samples` input samples, in proportion beyond them."""
    return {name: (lambda length_s, t=ms * 1e-3: t * max(1.0, length_s * IN_SR / samples))
            for name, ms in unit_ms.items()}


def real_dpu(device, seconds: float = 5.0):
    """One utterance through DPU(backend="dpu") on `device`: the three CUDA
    kernels on the card, their plain versions on the CPU. Returns (the
    48 kHz audio, its features [frames, 80])."""
    audio = utterance(seconds)
    dpu = DPU(DpuConfig(modality="audio", backend="dpu"), device)
    return audio, np.asarray(dpu.process(audio))


def main(argv=None):
    ap = argparse.ArgumentParser(description="PREBA's audio serving study on the port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: costs and kernels on the card) or cpu")
    ap.add_argument("--requests", type=int, default=3000)
    ap.add_argument("--rate", type=float, default=6000.0, help="arrivals a second")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    sc = SLICE_MENU[SLICE]
    _, _, _, lat = exec_model(ARCH, sc["chips"], DECODE_STEPS, CTX_PER_SEC)
    pol = policy_for(ARCH, sc["chips"], sc["n_slices"])
    static = dataclasses.replace(pol, batch_max={0: 1})
    reqs = generate_requests(WorkloadSpec(rate_qps=args.rate, seed=0), args.requests)
    cpu_s = cpu_cost_s()
    if dev.type == "cuda":
        unit_ms, samples = dpu_unit_ms(dev), int(IN_SR * CAL_SECONDS)
        origin = f"measured on {dev}, one {CAL_SECONDS} s utterance"
    else:
        unit_ms, samples = PERF_DPU_MS, PERF_DPU_SAMPLES
        origin = "PERF.md §6 rows 1-3, 16 x 48,000 samples, NVIDIA H100 80GB HBM3, 700.00 W"
    print(f"costs: cpu {1e3 * cpu_s:.3f} ms a {CAL_SECONDS} s utterance (this host); dpu "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in unit_ms.items()) + f" ({origin})")

    base = simulate(copy.deepcopy(reqs), static, lat, audio_pre_cost(cpu_s),
                    SimConfig(n_slices=sc["n_slices"], preprocess="cpu", cpu_cores=32),
                    device=dev)
    preba = simulate(copy.deepcopy(reqs), pol, lat, audio_pre_cost(cpu_s),
                     SimConfig(n_slices=sc["n_slices"], preprocess="dpu"), device=dev,
                     dpu_costs=dpu_costs(unit_ms, samples))
    print(f"baseline : {base.qps:7.1f} qps  p95 {base.p95_ms:8.1f} ms "
          f"breakdown {base.breakdown_ms()}")
    print(f"PREBA    : {preba.qps:7.1f} qps  p95 {preba.p95_ms:8.1f} ms "
          f"breakdown {preba.breakdown_ms()}")
    print(f"gain     : {preba.qps / base.qps:.2f}x throughput, "
          f"{base.p95_ms / preba.p95_ms:.2f}x tail latency "
          f"({ARCH} on {SLICE}, {args.requests} requests at {args.rate:g}/s)")

    print(f"\n== real DPU kernel pipeline on one utterance ({dev}) ==")
    audio, feats = real_dpu(dev)
    print(f"log-mel features: {feats.shape}, mean {feats.mean():+.4f}, "
          f"std {feats.std():.4f} (normalized)")
    return dict(baseline=base, preba=preba, unit_ms=unit_ms, cpu_s=cpu_s, audio=audio,
                feats=feats)


if __name__ == "__main__":
    main()
