"""The PyTorch package's fault harness, dead-letter queue and DPU breaker
against the JAX package's, on the CPU: FaultPlan draws event for event,
a chaos replay on the virtual clock (the same completed rids and tokens,
shed and dead reason counts, injector log, conservation), the breaker's
trip -> CPU path -> close, poison and retry-budget dead letters, and the
watchdog's quarantine -> probe -> readmit of the owning tenant's engine.

Reduced tinyllama at an fp32 override; the JAX package's weights (seeds 0
and 1) carried across with models.params.from_reference. The JAX
runtime's `backend="dpu"` service cannot trace its resample kernel on the
installed JAX, so the reference runs its numpy DPU backend; the port runs
its kernels' plain versions. Payloads never influence decode tokens. Where
a reference decision rests on measured wall time (the hedging EMA), the
tests compare outcomes, not timelines.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.core.dpu.service import DpuService as RService  # noqa: E402
from repro.core.dpu.service import DpuServiceConfig as RServiceConfig  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import faults as rfaults  # noqa: E402
from repro.serving import runtime as rruntime  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.core.dpu.runtime import DpuConfig, payload_error  # noqa: E402
from repro_torch.core.dpu.service import DpuService, DpuServiceConfig  # noqa: E402
from repro_torch.models.api import LM  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.faults import (  # noqa: E402
    DPU_FAIL, MALFORMED, RESIZE_ABORT, SLICE_FAIL, SLICE_FLAP, STRAGGLER,
    FaultEvent, FaultPlan, ShedReason, reason_counts, replay_virtual,
)
from repro_torch.serving.multislice import TenantSpec, build_multislice_engine  # noqa: E402
from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime  # noqa: E402

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
SPEC = [(17, 8), (23, 5), (19, 8), (25, 6), (21, 3), (30, 7),
        (18, 4), (28, 8), (22, 2), (26, 6)]
AUDIO = 1600


def _ec(cls):
    return cls(continuous=True, max_slots=4, segment_len=4, max_new_tokens=8,
               max_prompt_len=32)


def _mk(cls, i, *, arrival=0.0, audio=None, rid0=6000, model=None):
    n, b = SPEC[i]
    payload = None
    if audio is not None:
        payload = np.random.default_rng(4000 + i).standard_normal(audio).astype(np.float32)
    return cls(rid=rid0 + i, arrival=arrival, length=float(n), max_new_tokens=b,
               payload=payload, model=model)


def _rsvc():
    return RService(RServiceConfig(clock="virtual", max_group=8))


def _svc():
    return DpuService(DpuServiceConfig(clock="virtual", max_group=8,
                                       dpu=DpuConfig(backend="dpu")), device="cpu")


def _tokens(done):
    return {r.rid: np.asarray(r.payload) for r in done}


@pytest.fixture(scope="module")
def setup():
    """Both packages' weights (seeds 0 and 1) and the reference single
    engine's tokens for the canonical requests (rids 6000+ on seed 0,
    6500+ on seed 1)."""
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jp, pt, ref = {}, {}, {}
    for seed in (0, 1):
        jp[seed] = rapi.init_params(rcfg, jax.random.PRNGKey(seed), dtype="float32")
        pt[seed] = LM(cfg, from_reference(jax.tree.map(np.asarray, jp[seed]), cfg,
                                               "cpu", "float32"))
        eng = rengine.build_engine(rcfg, ec=_ec(rengine.EngineConfig))
        eng.params = jp[seed]
        eng.submit_many([_mk(RRequest, i, rid0=6000 + 500 * seed) for i in range(len(SPEC))])
        ref.update(_tokens(eng.run_until_idle()))
    return dict(rcfg=rcfg, cfg=cfg, jp=jp, pt=pt, ref=ref)


def _check(done, ref):
    rids = [r.rid for r in done]
    assert len(rids) == len(set(rids))  # exactly once each
    for r in done:
        np.testing.assert_array_equal(np.asarray(r.payload), ref[r.rid])


# --- FaultPlan --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_plan_generate_equals_reference_event_for_event(seed):
    rates = {k: r for k, r in zip(faults.FAULT_KINDS, (3.0, 4.0, 3.0, 3.0, 5.0, 3.0))}
    kw = dict(horizon_s=2.0, n_slices=3, rates=rates, n_requests=20)
    got = FaultPlan.generate(seed, **kw)
    want = rfaults.FaultPlan.generate(seed, **kw)
    assert got.to_json() == want.to_json()
    assert len(got.events) > 5 and {e.kind for e in got.events} == set(faults.FAULT_KINDS)
    assert got.events == sorted(got.events, key=lambda e: e.at)


def test_corrupt_payloads_and_event_validation_equal_reference():
    plan = FaultPlan([FaultEvent(at=0.0, kind=MALFORMED, target=t) for t in (3, 12, 0)])
    rplan = rfaults.FaultPlan([rfaults.FaultEvent(at=0.0, kind=MALFORMED, target=t)
                               for t in (3, 12, 0)])
    reqs = [_mk(Request, i, audio=AUDIO) for i in range(len(SPEC))]
    rreqs = [_mk(RRequest, i, audio=AUDIO) for i in range(len(SPEC))]
    assert plan.corrupt_payloads(reqs) == rplan.corrupt_payloads(rreqs) == [6003, 6000]
    assert payload_error(reqs[3].payload) is not None
    assert payload_error(reqs[4].payload) is None
    with pytest.raises(ValueError):
        FaultEvent(at=0.0, kind="meteor_strike")
    assert reason_counts({1: ShedReason.SLO, 2: ShedReason.SLO, 3: "x"}) == {"slo": 2, "x": 1}


# --- chaos replay against the reference --------------------------------------

# (at, kind, target, duration, param). Each quarantine heals and is
# readmitted before the resize: the reference's replay_virtual reads the
# quarantine map it found at the start, which a resize replaces, so a resize
# during a quarantine wedges it (ROADMAP Queue 3)
CHAOS = [
    (0.0, DPU_FAIL, 0, 0.0, 3),
    (0.0, MALFORMED, 1, 0.0, 0),
    (0.02, SLICE_FAIL, 0, 0.02, 0),
    (0.03, STRAGGLER, 1, 0.006, 0),
    (0.05, SLICE_FLAP, 1, 0.04, 0),
    (0.14, RESIZE_ABORT, 0, 0.0, 1),
]


def _chaos(mod_rt, plan_cls, event_cls, req_cls, svc, params, cfg, ec, device):
    kw = {} if device is None else {"device": device}
    rt = mod_rt.build_pipelined_runtime(
        cfg, n_slices=2, ec=ec, params=params, service=svc,
        rc=mod_rt.RuntimeConfig(preprocess_retries=1, breaker_threshold=2,
                                breaker_probe_s=0.05),
        max_retries=10, watchdog_rounds=5, probe_interval_s=0.02, **kw)
    reqs = [_mk(req_cls, i, arrival=0.02 * i, audio=AUDIO if i % 2 else None)
            for i in range(len(SPEC))]
    plan = plan_cls([event_cls(at=a, kind=k, target=t, duration=d, param=p)
                     for a, k, t, d, p in CHAOS], seed=7)
    bad = plan.corrupt_payloads(reqs)
    done = (rfaults.replay_virtual if mod_rt is rruntime else replay_virtual)(rt, reqs, plan)
    return dict(rt=rt, done=done, bad=bad, reqs=reqs)


@pytest.fixture(scope="module")
def chaos_runs(setup):
    ref = _chaos(rruntime, rfaults.FaultPlan, rfaults.FaultEvent, RRequest, _rsvc(),
                 setup["jp"][0], setup["rcfg"], _ec(rengine.EngineConfig), None)
    got = _chaos(__import__("repro_torch.serving.runtime", fromlist=["x"]), FaultPlan,
                 FaultEvent, Request, _svc(), setup["pt"][0], setup["cfg"],
                 _ec(EngineConfig), "cpu")
    return ref, got


def test_chaos_replay_completes_the_reference_rids_with_its_tokens(chaos_runs, setup):
    ref, got = chaos_runs
    assert sorted(r.rid for r in got["done"]) == sorted(r.rid for r in ref["done"])
    assert len(got["done"]) >= len(SPEC) - 3
    _check(got["done"], setup["ref"])
    _check(got["done"], _tokens(ref["done"]))


def test_chaos_replay_sheds_and_dead_letters_as_the_reference(chaos_runs):
    ref, got = chaos_runs
    assert got["bad"] == ref["bad"] == [6001]
    assert got["rt"].shed_counts() == ref["rt"].shed_counts() == {"malformed": 1}
    assert got["rt"].dead_counts() == ref["rt"].dead_counts()
    assert got["rt"].dead_counts().get("poison", 0) >= 1
    assert sorted(got["rt"].dead_reasons) == sorted(ref["rt"].dead_reasons)
    for k in ("breaker_trips", "cpu_fallback", "pp_retries", "shed_malformed", "dead"):
        assert got["rt"].stats[k] == ref["rt"].stats[k], k
    assert got["rt"].stats["breaker_trips"] == 1 and got["rt"].stats["cpu_fallback"] >= 1


def test_chaos_replay_injector_log_equals_reference(chaos_runs):
    ref, got = chaos_runs
    assert got["rt"].injector.log == ref["rt"].injector.log
    assert [k for _, k, _ in got["rt"].injector.log] == [e[1] for e in sorted(CHAOS)]
    assert got["rt"].injector.done()


def test_chaos_replay_conserves_and_ends_healed(chaos_runs):
    ref, got = chaos_runs
    for run in (ref, got):
        rt = run["rt"]
        assert rt.conservation_ok()
        out = [r.rid for r in run["done"]] + [r.rid for r in rt.shed] + \
            [r.rid for r in rt.dead]
        assert sorted(out) == sorted(r.rid for r in run["reqs"])  # exactly-once partition
        ms = rt.engine
        assert ms.stats["resizes"] == 2 and ms.stats["quarantined"] >= 1
        assert ms.stats["readmitted"] >= 1 and not ms._quarantined
        assert all(s.healthy for s in ms.sched.slices.values())
    ms = got["rt"].engine
    assert ms.stats["quarantined"] == ref["rt"].engine.stats["quarantined"]
    assert ms.decode_steps_total() >= sum(e.stats["decode_steps"] for e in ms.engines.values())


# --- the breaker, poison, retry budgets ---------------------------------------


def _breaker_run(mod_rt, plan_cls, event_cls, req_cls, svc, params, cfg, ec, **kw):
    rt = mod_rt.build_pipelined_runtime(
        cfg, ec=ec, params=params, service=svc,
        rc=mod_rt.RuntimeConfig(preprocess_retries=3, breaker_threshold=1,
                                breaker_probe_s=0.05), **kw)
    wave1 = [_mk(req_cls, i, audio=AUDIO) for i in range(3)]
    wave2 = [_mk(req_cls, i, arrival=0.2, audio=AUDIO) for i in range(3, 6)]
    plan = plan_cls([event_cls(at=0.0, kind=DPU_FAIL, param=1)])
    replay = rfaults.replay_virtual if mod_rt is rruntime else replay_virtual
    return rt, replay(rt, wave1 + wave2, plan)


def test_breaker_trips_degrades_to_cpu_and_recovers_as_the_reference(setup):
    from repro_torch.serving import runtime as truntime

    rrt, rdone = _breaker_run(rruntime, rfaults.FaultPlan, rfaults.FaultEvent, RRequest,
                              _rsvc(), setup["jp"][0], setup["rcfg"],
                              _ec(rengine.EngineConfig))
    rt, done = _breaker_run(truntime, FaultPlan, FaultEvent, Request, _svc(),
                            setup["pt"][0], setup["cfg"], _ec(EngineConfig), device="cpu")
    assert len(done) == 6
    _check(done, setup["ref"])
    for k in ("breaker_trips", "pp_retries", "cpu_fallback"):
        assert rt.stats[k] == rrt.stats[k], k
    assert rt.stats["breaker_trips"] == 1 and rt.stats["cpu_fallback"] >= 1
    assert not rt._brk_open and rt.dead == [] and rt.shed == []
    assert [e.kind for e in rt.tracer.events if e.kind.startswith("breaker")] == \
        ["breaker_trip", "breaker_close"]
    assert rt.conservation_ok()


def test_poison_requests_dead_letter_after_preprocess_retries(setup):
    svc = _svc()
    rt = build_pipelined_runtime(setup["cfg"], ec=_ec(EngineConfig), params=setup["pt"][0],
                                 service=svc, rc=RuntimeConfig(preprocess_retries=1),
                                 device="cpu")
    poisoned = [_mk(Request, i, audio=AUDIO) for i in range(2)]  # one shape group
    clean = [_mk(Request, 5)]
    svc.inject_launch_failures(2)  # the group fails, retries once, fails again
    rt.submit(poisoned + clean, now=0.0)
    done = rt.run_until_idle()
    assert {r.rid for r in done} == {clean[0].rid}
    _check(done, setup["ref"])
    assert {r.rid for r in rt.dead} == {r.rid for r in poisoned}
    assert rt.dead_counts() == {"poison": 2} and rt.stats["dead"] == 2
    assert svc.stats["failed"] == 4 and rt.stats["breaker_trips"] == 0
    assert rt.conservation_ok()


def test_retry_budget_exhaustion_dead_letters_as_the_reference(setup):
    """max_retries=0: the requests a slice loss requeues dead-letter as
    retries_exhausted; the rest complete; the same rids as the reference."""
    plan = [(0.004, SLICE_FAIL, 0, 0.01, 0)]
    out = []
    for mod_rt, pcls, ecls, rcls, params, cfg, ec, kw in (
            (rruntime, rfaults.FaultPlan, rfaults.FaultEvent, RRequest, setup["jp"][0],
             setup["rcfg"], _ec(rengine.EngineConfig), {}),
            (__import__("repro_torch.serving.runtime", fromlist=["x"]), FaultPlan,
             FaultEvent, Request, setup["pt"][0], setup["cfg"], _ec(EngineConfig),
             {"device": "cpu"})):
        rt = mod_rt.build_pipelined_runtime(cfg, n_slices=2, ec=ec, params=params,
                                            max_retries=0, probe_interval_s=0.02, **kw)
        replay = rfaults.replay_virtual if mod_rt is rruntime else replay_virtual
        done = replay(rt, [_mk(rcls, i) for i in range(6)],
                      pcls([ecls(at=a, kind=k, target=t, duration=d, param=p)
                            for a, k, t, d, p in plan]))
        assert rt.conservation_ok()
        out.append((sorted(r.rid for r in done), rt.dead_counts(), sorted(rt.dead_reasons)))
        if mod_rt is not rruntime:
            _check(done, setup["ref"])
    assert out[1] == out[0]
    assert out[1][1].get("retries_exhausted", 0) >= 1


def test_watchdog_quarantines_probes_and_readmits_the_owning_tenants_engine(setup):
    """Two tenants (seeds 0 and 1), two slices each: a silently hung slice
    of tenant b is quarantined after 3 rounds, its work requeues within b,
    the probe readmits the slice with an engine rebuilt for b's model, and
    every request's tokens equal its tenant's reference single engine."""
    ms = build_multislice_engine(
        n_slices=4, ec=_ec(EngineConfig), device="cpu",
        tenants=[TenantSpec(cfg=setup["cfg"], name="a", n_slices=2, params=setup["pt"][0]),
                 TenantSpec(cfg=setup["cfg"], name="b", n_slices=2, params=setup["pt"][1])],
        watchdog_rounds=3, probe_interval_s=0.05)
    ms.offer([_mk(Request, i, model="a") for i in range(4)]
             + [_mk(Request, i, rid0=6500, model="b") for i in range(3)])
    now = time.monotonic()
    ms._dispatch(now)
    b_slices = set(ms.slices_of("b"))
    sid = next(s for tr in ms._inflight.values() for s in tr.copies if s in b_slices)
    ms.stalled_slices.add(sid)
    old = ms.engines[sid]
    for _ in range(3):
        now += 1e-3
        ms.step(now)
    assert sid in ms._quarantined and not ms.sched.slices[sid].healthy
    now = ms._quarantined[sid] + 1e-3
    ms.step(now)                           # still stalled: the probe fails
    assert sid in ms._quarantined and ms.stats["readmitted"] == 0
    ms.stalled_slices.discard(sid)         # the device heals
    now = ms._quarantined[sid] + 1e-3
    ms.step(now)
    assert sid not in ms._quarantined and ms.stats["readmitted"] == 1
    e = ms.engines[sid]
    assert e is not old and e.model is setup["pt"][1] and e._tenant == "b"
    done = ms.run_until_idle()
    assert len(done) == 7
    _check(done, setup["ref"])
    for name in ("a", "b"):
        assert set(ms.tenant_stats()[name]["routed_to"]) <= set(ms.slices_of(name))
    assert ms.dead == []
    assert ms.decode_steps_total() == sum(
        x.stats["decode_steps"] for x in [old, *ms.engines.values()])


def test_watchdog_readmit_rebuilds_the_ssm_tenants_engine(setup):
    """The two-family fleet (tinyllama, and mamba2 as tenant
    "mamba2-370m-fleet"), two slices each: a hung mamba2 slice is
    quarantined, its work requeues within its tenant, the probe readmits
    the slice with an engine rebuilt for mamba2 (never tinyllama), no
    request crosses the model boundary, every request's tokens equal the
    JAX package's single engine of its model, and the readmitted slice
    serves its tenant's next wave."""
    name_b = "mamba2-370m-fleet"
    rcfg_b = dataclasses.replace(ref_reduced("mamba2-370m"), dtype="float32")
    cfg_b = dataclasses.replace(reduced("mamba2-370m"), dtype="float32")
    jp_b = rapi.init_params(rcfg_b, jax.random.PRNGKey(0), dtype="float32")
    model_b = LM(cfg_b, from_reference(jax.tree.map(np.asarray, jp_b), cfg_b, "cpu",
                                       "float32"))

    def _b(cls, i, model=None):
        return cls(rid=6500 + i, arrival=0.0, length=float(17 + 2 * i),
                   max_new_tokens=3 + i, model=model)

    single = rengine.build_engine(rcfg_b, ec=_ec(rengine.EngineConfig))
    single.params = jp_b
    single.submit_many([_b(RRequest, i) for i in range(3)]
                       + [RRequest(rid=6510 + i, arrival=0.0, length=float(18 + i),
                                   max_new_tokens=4) for i in range(4)])
    ref = {**setup["ref"], **_tokens(single.run_until_idle())}
    ms = build_multislice_engine(
        n_slices=4, ec=_ec(EngineConfig), device="cpu",
        tenants=[TenantSpec(cfg=setup["cfg"], name="a", n_slices=2, params=setup["pt"][0]),
                 TenantSpec(cfg=cfg_b, name=name_b, n_slices=2, params=model_b)],
        watchdog_rounds=3, probe_interval_s=0.05)
    ms.offer([_mk(Request, i, model="a") for i in range(4)]
             + [_b(Request, i, model=name_b) for i in range(3)])
    now = time.monotonic()
    ms._dispatch(now)
    b_slices = set(ms.slices_of(name_b))
    sid = next(s for tr in ms._inflight.values() for s in tr.copies if s in b_slices)
    ms.stalled_slices.add(sid)
    old = ms.engines[sid]
    for _ in range(3):
        now += 1e-3
        ms.step(now)
    assert sid in ms._quarantined
    ms.stalled_slices.discard(sid)         # the device heals
    now = ms._quarantined[sid] + 1e-3
    ms.step(now)
    assert sid not in ms._quarantined and ms.stats["readmitted"] == 1
    e = ms.engines[sid]
    assert e is not old and e.cfg is cfg_b and e.model is model_b and e._tenant == name_b
    done = ms.run_until_idle()
    assert len(done) == 7
    _check(done, ref)
    for name in ("a", name_b):
        assert set(ms.tenant_stats()[name]["routed_to"]) <= set(ms.slices_of(name))
    assert ms.dead == []
    more = [Request(rid=6510 + i, arrival=0.0, length=float(18 + i), max_new_tokens=4,
                    model=name_b) for i in range(4)]
    ms.submit_many(more)
    _check(ms.run_until_idle(), ref)
    assert sum(ms.engines[s].stats["admitted"] for s in b_slices) >= 7
    assert set(ms.engines[sid]._pool["body"]["l0"]["mixer"]) == {"conv", "state"}


def test_service_injected_failures_take_the_failed_path():
    svc = _svc()
    reqs = [_mk(Request, i, audio=AUDIO) for i in range(3)]
    svc.inject_launch_failures(1)
    for r in reqs:
        assert svc.submit(r)
    svc.step(0.0)
    failed = svc.take_failed()
    assert [r.rid for r in failed] == [r.rid for r in reqs]
    assert "injected" in str(svc.last_error) and svc.stats["failed"] == 3
    for r in failed:
        svc.submit(r)
    svc.step(0.0)
    assert svc.take_failed() == [] and svc.stats["groups"] == 2


def test_replay_does_not_wedge_on_a_resize_during_a_quarantine(setup):
    """The port's replay reads the fleet's quarantine map afresh each tick:
    a resize that replaces the map while a slice is quarantined ends the
    replay drained and healed (the reference's wedges; ROADMAP Queue 3)."""
    rt = build_pipelined_runtime(setup["cfg"], n_slices=2, ec=_ec(EngineConfig),
                                 params=setup["pt"][0], watchdog_rounds=5,
                                 probe_interval_s=0.02, device="cpu")
    plan = FaultPlan([FaultEvent(at=0.01, kind=SLICE_FAIL, target=0, duration=0.2),
                      FaultEvent(at=0.03, kind=RESIZE_ABORT, param=1)])
    done = replay_virtual(rt, [_mk(Request, i, arrival=0.01 * i) for i in range(6)], plan,
                          max_idle_ticks=2_000)
    assert len(done) == 6 and rt.conservation_ok()
    _check(done, setup["ref"])
    assert rt.engine.stats["resizes"] == 2 and not rt.engine._quarantined
