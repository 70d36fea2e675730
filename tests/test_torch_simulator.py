"""The PyTorch package's event-driven simulator and CPU preprocessing pool
against the JAX package's, on the CPU.

`simulate()` is a host-side cost model: the same requests, batching
policy, cost callables and SimConfig must give equal SimResult fields in
both packages — through the CPU core pool, the DPU's CU pools (split and
fused audio CUs) and no preprocessing, with injected stragglers and
hedging, and with a slice failure.

The two packages' DPU cost models differ in their peaks only (the JAX
package's are a TPU's, the port's the H100's data sheet); the DPU cases
give the reference the port's peaks, so both model the same device.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core.batching.policy import BatchPolicy as RBatchPolicy  # noqa: E402
from repro.core.dpu import pipeline as rpipeline  # noqa: E402
from repro.core.dpu.runtime import CpuPreprocessPool as RCpuPool  # noqa: E402
from repro.serving import simulator as rsim  # noqa: E402
from repro.serving.requests import WorkloadSpec as RSpec  # noqa: E402
from repro.serving.requests import generate_requests as rgenerate  # noqa: E402
from repro_torch.core.batching.policy import BatchPolicy  # noqa: E402
from repro_torch.core.dpu import pipeline  # noqa: E402
from repro_torch.core.dpu.runtime import CpuPreprocessPool  # noqa: E402
from repro_torch.serving import simulator as sim  # noqa: E402
from repro_torch.serving.requests import WorkloadSpec, generate_requests  # noqa: E402

N_REQ = 400


def _policy(cls):
    return cls(batch_max={0: 4, 1: 8, 2: 8, 3: 16}, time_queue=0.004, time_knee=0.02,
               n_slices=4, bucket_width=2.5)


def _exec_s(b):
    # a knee-shaped batch latency: fixed part, per-request part, longest member
    return 0.004 + 0.0006 * b.size + 0.0004 * b.max_length


def _pre_s(length):
    return 0.002 + 0.003 * float(length)


def _requests(spec_cls, gen):
    return gen(spec_cls(modality="audio", rate_qps=400.0, mean_len=4.0, sigma=0.6,
                        max_len=10.0, seed=7), N_REQ)


CASES = {
    "cpu": dict(preprocess="cpu", cpu_cores=8),
    "dpu": dict(preprocess="dpu", dpu_cus=2),
    "dpu_fused_cus": dict(preprocess="dpu", dpu_cus=2, split_audio_cus=False),
    "none": dict(preprocess="none"),
    "stragglers_hedged": dict(preprocess="dpu", straggler_prob=0.1, straggler_slowdown=6.0,
                              hedge_factor=2.0, seed=3),
    "slice_failure": dict(preprocess="none", fail_slice_at=(1, 0.3), n_slices=4),
}


def _fields(res):
    return dict(
        completed=[(r.rid, r.arrival, r.preprocessed_at, r.dispatched_at, r.completed_at)
                   for r in res.completed],
        horizon=res.horizon, hedges=res.hedges, batches=res.batches,
        batch_sizes=res.batch_sizes, preprocess_wait=res.preprocess_wait,
        queue_wait=res.queue_wait, exec_time=res.exec_time, qps=res.qps,
        p95_ms=res.p95_ms, breakdown_ms=res.breakdown_ms())


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_equals_reference(case, monkeypatch):
    # the reference's DPU cost model at the port's (H100 data-sheet) peaks
    monkeypatch.setattr(rpipeline, "_MXU_FLOPS", pipeline._FP32_FLOPS)
    monkeypatch.setattr(rpipeline, "_VPU_BYTES", pipeline._HBM_BYTES)
    kw = {"n_slices": 4, **CASES[case]}
    ref = rsim.simulate(_requests(RSpec, rgenerate), _policy(RBatchPolicy), _exec_s, _pre_s,
                        rsim.SimConfig(**kw))
    port = sim.simulate(_requests(WorkloadSpec, generate_requests), _policy(BatchPolicy),
                        _exec_s, _pre_s, sim.SimConfig(**kw), device="cpu")
    want, got = _fields(ref), _fields(port)
    assert got == want
    assert len(got["completed"]) == N_REQ        # every request served, once
    if case == "stragglers_hedged":
        assert got["hedges"] > 0


def test_cpu_pool_equals_reference():
    costs = np.random.default_rng(5).uniform(0.001, 0.02, 64)
    arrivals = np.cumsum(np.random.default_rng(6).exponential(0.002, 64))
    ref, port = RCpuPool(3, lambda i: costs[i]), CpuPreprocessPool(3, lambda i: costs[i])
    for i, t in enumerate(arrivals):
        assert port.submit(float(t), i) == ref.submit(float(t), i)
    assert port.free_at == ref.free_at
    for h in (0.0, 0.05, float(arrivals[-1]), 1.0):
        assert port.utilization(h) == ref.utilization(h)


def test_simulate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    for p in ("dpu", "cpu", "none"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sim.simulate(_requests(WorkloadSpec, generate_requests)[:4], _policy(BatchPolicy),
                         _exec_s, _pre_s, sim.SimConfig(preprocess=p))
