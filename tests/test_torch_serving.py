"""The PyTorch package's serving slice on the CPU: the DPU service, the
continuous-batching engine and the pipelined runtime, held against the JAX
package's runtime on one seeded trace; plus the package's hygiene (it
imports neither JAX nor the JAX package, and its entry points refuse to
run on the CPU unless asked to).

The port's service runs the DPU backend, i.e. its kernels' plain versions
on a CPU tensor; the JAX runtime runs its default numpy DPU backend (its
fused Pallas path cannot trace the resample kernel on the installed JAX).
Per request: generated tokens equal, features within rtol 1e-3 / atol 1e-2.
"""
import ast
import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.core.dpu.service import DpuService as RefService  # noqa: E402
from repro.core.dpu.service import DpuServiceConfig as RefServiceConfig  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import faults as rfaults  # noqa: E402
from repro.serving import requests as rrequests  # noqa: E402
from repro.serving import runtime as rruntime  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.core.dpu.runtime import DpuConfig  # noqa: E402
from repro_torch.core.dpu.service import DpuService, DpuServiceConfig  # noqa: E402
from repro_torch.data import preprocess_cpu as pp  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import requests as trequests  # noqa: E402
from repro_torch.serving.engine import EngineConfig, build_engine  # noqa: E402
from repro_torch.serving.faults import ShedReason, replay_virtual  # noqa: E402
from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime  # noqa: E402
from repro_torch.training.train_loop import TrainLoopConfig, train  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
SAMPLES = 4800


def _ec(cls):
    return cls(continuous=True, max_slots=4, segment_len=4, max_new_tokens=6,
               max_prompt_len=32)


def _spec(mod, cfg):
    return mod.WorkloadSpec(modality="text", rate_qps=200.0, mean_len=12, max_len=30,
                            vocab=cfg.vocab, payload_samples=SAMPLES, seed=3)


def _record_features(service):
    """Keep each request's features as the service hands it to admission
    (the engine later replaces the payload with the generated tokens)."""
    feats = {}
    poll = service.poll

    def wrapped(now, n=None):
        out = poll(now, n)
        for r in out:
            feats[r.rid] = np.array(r.payload)
        return out

    service.poll = wrapped
    return feats


@pytest.fixture(scope="module")
def slice_runs():
    """The same 8-request trace through the JAX runtime and the port's."""
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    params = from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu", "float32")

    rsvc = RefService(RefServiceConfig(clock="virtual"))
    rfeats = _record_features(rsvc)
    rrt = rruntime.build_pipelined_runtime(rcfg, ec=_ec(rengine.EngineConfig),
                                           service=rsvc, params=jparams)
    rreqs = rrequests.generate_requests(_spec(rrequests, rcfg), 8)
    rdone = rfaults.replay_virtual(rrt, rreqs)

    kernels.reset_launch_counts()
    svc = DpuService(DpuServiceConfig(clock="virtual", dpu=DpuConfig(backend="dpu")),
                     device="cpu")
    feats = _record_features(svc)
    rt = build_pipelined_runtime(cfg, ec=_ec(EngineConfig), service=svc,
                                 params=params, device="cpu")
    reqs = trequests.generate_requests(_spec(trequests, cfg), 8)
    done = replay_virtual(rt, reqs)
    return dict(rreqs=rreqs, rdone=rdone, rfeats=rfeats, rrt=rrt,
                reqs=reqs, done=done, feats=feats, rt=rt, svc=svc)


def test_trace_generation_matches_reference(slice_runs):
    for a, b in zip(slice_runs["rreqs"], slice_runs["reqs"]):
        assert (a.rid, a.arrival, a.length) == (b.rid, b.arrival, b.length)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_slice_tokens_match_reference_per_request(slice_runs):
    ref = {r.rid: np.asarray(r.payload) for r in slice_runs["rdone"]}
    got = {r.rid: np.asarray(r.payload) for r in slice_runs["done"]}
    assert sorted(got) == sorted(ref) == list(range(8))
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])


def test_slice_features_match_reference_per_request(slice_runs):
    ref, got = slice_runs["rfeats"], slice_runs["feats"]
    assert sorted(got) == sorted(ref) == list(range(8))
    for rid in ref:
        assert got[rid].shape == ref[rid].shape == (8, 80)
        assert_allclose(got[rid], ref[rid], rtol=1e-3, atol=1e-2)


def test_slice_conserves_requests(slice_runs):
    rt = slice_runs["rt"]
    assert rt.conservation_ok() and not rt.shed and rt.shed_counts() == {}
    assert rt.stats["submitted"] == rt.stats["accepted"] == rt.stats["offered"] == 8
    assert slice_runs["rrt"].conservation_ok()
    # CPU tensors never reach a kernel
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    st = rt.stage_summary()
    assert set(st) == {"ingest", "preprocess", "ready", "admission", "slots"}
    assert 0.0 <= rt.stage_occupancy()["preprocess"] <= 1.0
    assert slice_runs["svc"].stats["groups"] >= 1
    assert rt.engine.stats["admitted"] == rt.engine.stats["retired"] == 8


def test_virtual_replay_timeline_is_deterministic():
    cfg = reduced(ARCH)

    def run():
        svc = DpuService(DpuServiceConfig(clock="virtual", dpu=DpuConfig(backend="dpu")),
                         device="cpu")
        rt = build_pipelined_runtime(cfg, ec=_ec(EngineConfig), service=svc, device="cpu")
        done = replay_virtual(rt, trequests.generate_requests(_spec(trequests, cfg), 4))
        return {r.rid: r.payload.tolist() for r in done}, rt.tracer.to_json(0.0)

    assert run() == run()


def _payload_reqs(n, samples=SAMPLES, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival=0.0, length=float(5 + i), max_new_tokens=3,
                    payload=rng.standard_normal(samples).astype(np.float32))
            for i in range(n)]


@pytest.mark.parametrize("fused", [None, False])
def test_wall_service_groups_and_matches_numpy(fused):
    """Wall clock: same-shape requests share one group (padded to a pow2
    stack) — one fused launch per kernel, or one batched pass per
    functional unit — and the features equal the numpy chain."""
    svc = DpuService(DpuServiceConfig(clock="wall", dpu=DpuConfig(backend="dpu"),
                                      fused_launch=fused), device="cpu")
    reqs = _payload_reqs(3)
    raws = [r.payload.copy() for r in reqs]
    for r in reqs:
        assert svc.submit(r)
    out = []
    deadline = time.monotonic() + 60.0
    while svc.busy() and time.monotonic() < deadline:
        svc.step(0.0)
        out.extend(svc.poll(0.0))
    worker = svc._worker
    svc.close()
    assert not worker.is_alive()
    assert svc.stats["groups"] == 1 and len(out) == 3
    for r in out:
        assert_allclose(r.payload, pp.audio_pipeline(raws[r.rid]), rtol=1e-3, atol=1e-2)


def test_front_door_sheds_malformed_slo_overflow_and_failed_launches():
    cfg = reduced(ARCH)
    svc = DpuService(DpuServiceConfig(clock="virtual", dpu=DpuConfig(backend="dpu")),
                     device="cpu")
    rt = build_pipelined_runtime(cfg, ec=_ec(EngineConfig), service=svc, device="cpu",
                                 rc=RuntimeConfig(max_ingest=2, slo_s=1.0))
    good = _payload_reqs(4)
    bad = Request(rid=10, arrival=0.0, length=4.0, payload=np.zeros((2, 3), np.float32))
    late = Request(rid=11, arrival=-5.0, length=4.0)
    assert rt.submit([bad, late] + good, now=0.0) == 2
    assert rt.shed_reasons == {10: ShedReason.MALFORMED, 11: ShedReason.SLO,
                               2: ShedReason.OVERFLOW, 3: ShedReason.OVERFLOW}
    rt.run_until_idle()
    assert sorted(r.rid for r in rt.completed) == [0, 1]
    assert rt.conservation_ok()

    rt2 = build_pipelined_runtime(cfg, ec=_ec(EngineConfig), service=DpuService(
        DpuServiceConfig(clock="virtual", dpu=DpuConfig(backend="dpu")), device="cpu"),
        device="cpu", rc=RuntimeConfig(validate_payloads=False))
    poison = _payload_reqs(1)[0]
    poison.payload = object()
    rt2.submit([poison], now=0.0)
    rt2.run_until_idle()
    assert rt2.shed_reasons == {0: ShedReason.PREPROCESS_ERROR}
    assert rt2.conservation_ok()


def test_engine_stats_carry_kernel_launch_counts():
    eng = build_engine(reduced(ARCH), ec=_ec(EngineConfig), device="cpu")
    eng.submit_many([Request(rid=i, arrival=0.0, length=float(3 + 2 * i)) for i in range(5)])
    done = eng.run_until_idle()
    assert len(done) == 5 and all(len(r.payload) == 6 for r in done)
    assert {f"launches_{k}" for k in kernels.KERNELS} <= set(eng.stats)
    assert eng.slots_in_use() == 0 and not eng.busy()


def test_engine_cancel_frees_slots_and_queue():
    eng = build_engine(reduced(ARCH), ec=_ec(EngineConfig), device="cpu")
    eng.submit_many([Request(rid=i, arrival=0.0, length=float(3 + i)) for i in range(6)])
    eng.step(eng.batcher.next_deadline())  # first flush: admit, one segment
    in_slot = next(s.req.rid for s in eng._slots if s is not None)
    queued = 5
    assert eng.slots_in_use() > 0 and eng.admission_depth() > 0
    assert eng.cancel([in_slot, queued]) == 2
    done = eng.run_until_idle()
    assert sorted(r.rid for r in done) == sorted(set(range(6)) - {in_slot, queued})
    assert eng.slots_in_use() == 0 and not eng.busy()


@pytest.mark.parametrize("mode", [
    dict(continuous=False),
    dict(continuous=True, chunk_lens=(16,)),
    dict(continuous=True, chunk_lens=(16,), prefix_cache_bytes=1 << 20),
])
def test_unported_engine_paths_raise(mode):
    """Sliding-window models are served now in every engine mode (the name
    is kept from when each mode refused them): reduced tinyllama with a
    16-token window, prompts within it and budgets that wrap its ring. The
    chunked modes admit it monolithically, as the JAX engine does (a ring
    shorter than the prompt cannot hold the chunk history). Per rid the
    tokens equal the JAX engine's on the same weights."""
    ec = dict(max_new_tokens=12, max_slots=4, segment_len=4, max_prompt_len=16, **mode)
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32", sliding_window=16)
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32", sliding_window=16)
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    reqs = [(0, 14.0, 12), (1, 5.0, 9), (2, 16.0, 11)]
    reng = rengine.build_engine(rcfg, ec=rengine.EngineConfig(**ec))
    reng.params = jparams
    reng.submit_many([RRequest(rid=i, arrival=0.0, length=n, max_new_tokens=b)
                      for i, n, b in reqs])
    want = {r.rid: np.asarray(r.payload) for r in reng.run_until_idle()}
    eng = build_engine(cfg, ec=EngineConfig(**ec), device="cpu",
                       params=from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    eng.submit_many([Request(rid=i, arrival=0.0, length=n, max_new_tokens=b)
                     for i, n, b in reqs])
    got = {r.rid: np.asarray(r.payload) for r in eng.run_until_idle()}
    assert got.keys() == want.keys() == {0, 1, 2}
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)
    if mode.get("continuous"):
        assert eng._chunk_lens == reng._chunk_lens == ()


# --- hygiene -----------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["src/repro_torch", "chip_smoke.py",
                                   "examples/quickstart_torch.py",
                                   "examples/pod_dryrun_roofline_torch.py",
                                   "examples/serve_audio_preba_torch.py",
                                   "src/repro_torch/core/control/partition.py",
                                   "src/repro_torch/serving/simulator.py"])
def test_port_imports_neither_jax_nor_the_jax_package(where):
    paths = sorted((ROOT / where).rglob("*.py")) if (ROOT / where).is_dir() else [ROOT / where]
    assert paths
    for p in paths:
        for mod in _imports(p):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (str(p), mod)


@pytest.mark.parametrize("entry", [
    lambda: build_engine(reduced(ARCH), ec=EngineConfig(continuous=True)),
    lambda: build_pipelined_runtime(reduced(ARCH)),
    lambda: DpuService(DpuServiceConfig(dpu=DpuConfig(backend="dpu"))),
    lambda: DpuService(DpuServiceConfig(dpu=DpuConfig(backend="dpu", modality="image"))),
    lambda: __import__("repro_torch.launch.serve", fromlist=["main"]).main(
        ["--arch", ARCH, "--reduced", "--continuous", "--requests", "1"]),
    lambda: train(reduced(ARCH), DataConfig(2, 8), TrainLoopConfig(total_steps=1)),
    lambda: launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"]),
])
def test_entry_points_default_to_cuda_and_refuse_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
