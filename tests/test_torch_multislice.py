"""The PyTorch package's multi-slice fleet against the JAX package's, on the
CPU: per-request tokens against the reference's single-slice and
multi-slice engines, joins into a busy slice, hedging (the twin wins; the
original wins and the twin is cancelled), resize and slice failure
mid-trace, a two-tenant fleet (router, cross-tenant refusal, rebalance on
resize), the slice accounting (`rebalance_slices`, `plan_placement`, the
H100 MIG menu), and the launcher's fleet flags.

Reduced tinyllama at an fp32 override; the JAX package's weights (seeds 0
and 1, one per tenant) carried across with models.params.from_reference.
Prompts are synthesized per rid, so a request's tokens depend only on
(rid, length, budget, weights): equal tokens mean equal serving.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.core.batching.policy import BatchPolicy as RBatchPolicy  # noqa: E402
from repro.core.slicing import mig as rmig  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import multislice as rms  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.core.batching.policy import BatchPolicy  # noqa: E402
from repro_torch.core.slicing import mig  # noqa: E402
from repro_torch.models.api import LM  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.multislice import (  # noqa: E402
    MultiSliceEngine, TenantSpec, build_multislice_engine,
)

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
# one (.., 32) prompt bucket; per-request budgets
LENS = [17.0 + i for i in range(9)]
BUDGETS = [3, 5, 8, 2, 7, 4, 6, 1, 8]
TENANTS = ("a", "b")  # one config served under two names, seeds 0 and 1


def _ec(cls, **kw):
    base = dict(max_new_tokens=8, continuous=True, max_slots=4, segment_len=4,
                max_prompt_len=32)
    return cls(**{**base, **kw})


def _reqs(cls, idxs, model=None, rid0=7000):
    return [cls(rid=rid0 + i, arrival=0.0, length=LENS[i], max_new_tokens=BUDGETS[i],
                model=model) for i in idxs]


def _policy(cls, n_slices):
    # immediate flush: formation timing is not under test here
    return cls(batch_max={0: 4}, time_queue=0.0, time_knee=0.1, n_slices=n_slices,
               bucket_width=64.0)


def _tokens(done):
    return {r.rid: np.asarray(r.payload) for r in done}


@pytest.fixture(scope="module")
def setup():
    """Both packages' weights for the two seeds, and the reference's tokens:
    a single-slice engine per seed, its 2-slice fleet (seed 0), and its
    two-tenant fleet."""
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jp, pt, single = {}, {}, {}
    for seed in (0, 1):
        jp[seed] = rapi.init_params(rcfg, jax.random.PRNGKey(seed), dtype="float32")
        pt[seed] = LM(cfg, from_reference(jax.tree.map(np.asarray, jp[seed]), cfg,
                                               "cpu", "float32"))
        eng = rengine.build_engine(rcfg, ec=_ec(rengine.EngineConfig))
        eng.params = jp[seed]
        eng.submit_many(_reqs(RRequest, range(9), rid0=7000 + 100 * seed))
        single[seed] = _tokens(eng.run_until_idle())
    rfleet = rms.MultiSliceEngine(rcfg, jp[0], _policy(RBatchPolicy, 2),
                                  _ec(rengine.EngineConfig), n_slices=2)
    rfleet.submit_many(_reqs(RRequest, range(9)))
    rtenants = rms.build_multislice_engine(
        n_slices=4, ec=_ec(rengine.EngineConfig),
        tenants=[rms.TenantSpec(cfg=rcfg, name=nm, n_slices=2, params=jp[i])
                 for i, nm in enumerate(TENANTS)])
    rtenants.submit_many(_reqs(RRequest, range(9), "a")
                         + _reqs(RRequest, range(9), "b", rid0=7100))
    return dict(cfg=cfg, rcfg=rcfg, jp=jp, pt=pt, single=single,
                rfleet=_tokens(rfleet.run_until_idle()),
                rtenants=_tokens(rtenants.run_until_idle()),
                rtenant_map=rtenants.slice_tenant)


def _fleet(setup, n_slices=2, **kw):
    return MultiSliceEngine(setup["cfg"], setup["pt"][0], _policy(BatchPolicy, n_slices),
                            _ec(EngineConfig, **kw.pop("ec", {})), n_slices=n_slices,
                            device="cpu", **kw)


def _check(done, want, k):
    assert len(done) == k and len({r.rid for r in done}) == k  # exactly once each
    for r in done:
        np.testing.assert_array_equal(np.asarray(r.payload), want[r.rid])
        assert r.completed_at >= r.dispatched_at > 0.0


def test_fleet_tokens_equal_reference_single_and_multi_slice(setup):
    ms = _fleet(setup)
    ms.submit_many(_reqs(Request, range(9)))
    done = ms.run_until_idle()
    assert setup["rfleet"].keys() == setup["single"][0].keys()
    for rid, toks in setup["rfleet"].items():
        np.testing.assert_array_equal(toks, setup["single"][0][rid])
    _check(done, setup["rfleet"], 9)
    st = ms.slice_stats()
    assert sum(1 for v in st.values() if v["admitted"] > 0) == 2
    assert all(0.0 < v["mean_slot_occupancy"] <= 1.0 for v in st.values())
    assert ms.replicated and ms.pod.spec.name == "1gpu(2x)"
    assert ms.decode_steps_total() == sum(e.stats["decode_steps"]
                                          for e in ms.engines.values()) > 0


def test_stream_joins_busy_slice_mid_flight(setup):
    """A later admission group joins a BUSY slice's pool mid-flight."""
    ms = _fleet(setup, n_slices=1)
    ms.submit_many(_reqs(Request, [2, 8]))       # budget-8 residents
    ms.step()
    e = ms.engines[0]
    assert e.slots_in_use() == 2 and e.stats["retired"] == 0
    ms.submit_many(_reqs(Request, [0, 4]))       # arrive while the slice is busy
    ms.step()
    assert e.stats["admitted"] == 4
    _check(ms.run_until_idle(), setup["single"][0], 4)


def test_hedge_twin_wins_exactly_once(setup):
    """A stalled slice's requests are cloned onto a healthy twin, the twin
    wins, the stalled copies are cancelled."""
    ms = _fleet(setup, hedge_factor=1.5)
    ms.fixed_expected_s = 1e-4
    ms.submit_many(_reqs(Request, range(2)))
    ms._dispatch(time.monotonic())
    sid = next(iter(next(iter(ms._inflight.values())).copies))
    ms.stalled_slices.add(sid)
    _check(ms.run_until_idle(), setup["single"][0], 2)
    assert ms.hedges >= 1 and ms.stats["hedge_wins"] >= 1
    assert ms.stats["cancelled"] >= 1 and ms._inflight == {}


def test_hedge_original_wins_and_twin_is_cancelled(setup):
    """A transient stall: the hedge fires, the device recovers, the original
    (segments ahead) finishes first and the clone is cancelled mid-flight."""
    ms = _fleet(setup, hedge_factor=1.5, ec=dict(segment_len=2))
    ms.fixed_expected_s = 1e-4
    ms.submit_many(_reqs(Request, [2]))          # budget 8: 4 segments
    ms.step()
    (rid,) = list(ms._inflight)
    (sid,) = ms._inflight[rid].copies
    ms.step()
    ms.stalled_slices.add(sid)
    t0 = time.monotonic()
    while ms.hedges == 0 and time.monotonic() - t0 < 30:
        ms.step()
    assert ms.hedges == 1
    ms.stalled_slices.discard(sid)
    _check(ms.run_until_idle(), setup["single"][0], 1)
    assert ms.stats["hedge_wins"] == 0 and ms.stats["cancelled"] >= 1
    assert not any(e.busy() for e in ms.engines.values())


def test_resize_mid_trace_loses_no_request(setup):
    ms = _fleet(setup)
    ms.submit_many(_reqs(Request, range(9)))
    ms.step()
    assert ms._inflight and ms.slot_scheduler.backlog() >= 1
    old = dict(ms.engines)
    assert ms.resize(n_slices=3) >= 1
    assert ms.slot_scheduler.backlog() >= 1 and len(ms.engines) == 3
    _check(ms.run_until_idle(), setup["single"][0], 9)
    assert ms.stats["resizes"] == 1
    # the launch accounting keeps the replaced generation's steps
    assert ms.decode_steps_total() == sum(
        e.stats["decode_steps"] for e in [*old.values(), *ms.engines.values()])


def test_fail_slice_requeues_and_recovers(setup):
    ms = _fleet(setup)
    ms.submit_many(_reqs(Request, range(2)))
    ms._dispatch(time.monotonic())
    sid = next(iter(next(iter(ms._inflight.values())).copies))
    assert ms.fail_slice(sid)
    _check(ms.run_until_idle(), setup["single"][0], 2)
    assert not ms.sched.slices[sid].healthy
    ms.recover_slice(sid)
    assert ms.sched.slices[sid].healthy


def _tenant_fleet(setup, na=2, nb=2, **kw):
    return build_multislice_engine(
        n_slices=na + nb, ec=_ec(EngineConfig), device="cpu",
        tenants=[TenantSpec(cfg=setup["cfg"], name="a", n_slices=na, params=setup["pt"][0]),
                 TenantSpec(cfg=setup["cfg"], name="b", n_slices=nb, params=setup["pt"][1])],
        **kw)


def _tenant_reqs(idxs=range(9)):
    return _reqs(Request, idxs, "a") + _reqs(Request, idxs, "b", rid0=7100)


def test_two_tenant_fleet_equals_reference_per_tenant(setup):
    ms = _tenant_fleet(setup)
    assert ms.slice_tenant == setup["rtenant_map"]
    ms.submit_many(_tenant_reqs())
    done = ms.run_until_idle()
    _check(done, setup["rtenants"], 18)
    for r in done:
        seed = TENANTS.index(r.model)
        np.testing.assert_array_equal(np.asarray(r.payload), setup["single"][seed][r.rid])
    for sid, e in ms.engines.items():
        assert e.model is setup["pt"][TENANTS.index(ms.slice_tenant[sid])]
    ts = ms.tenant_stats()
    for name in TENANTS:
        assert ts[name]["completed"] == 9 and ts[name]["dead"] == 0
        assert set(ts[name]["routed_to"]) <= set(ms.slices_of(name))


def test_router_stamps_validates_and_refuses_cross_tenant_dispatch(setup):
    ms = _tenant_fleet(setup, na=1, nb=1)
    with pytest.raises(ValueError, match="has no model"):
        ms.submit(Request(rid=8900, arrival=0.0, length=17.0, max_new_tokens=2))
    with pytest.raises(ValueError, match="unknown model"):
        ms.submit(Request(rid=8901, arrival=0.0, length=17.0, max_new_tokens=2,
                          model="gpt-17"))
    assert ms.admission_depth() == 0
    r = Request(rid=8902, arrival=0.0, length=17.0, max_new_tokens=2, model="a")
    with pytest.raises(RuntimeError, match="cross-tenant dispatch"):
        ms._send(r, ms.slices_of("b")[0], 0.0)
    single = _fleet(setup)
    r = Request(rid=8903, arrival=0.0, length=17.0, max_new_tokens=2)
    single.submit(r)
    assert r.model == setup["cfg"].name
    assert [x.rid for x in single.run_until_idle()] == [r.rid]


def test_fail_slice_requeues_within_tenant(setup):
    ms = _tenant_fleet(setup)
    ms.offer(_reqs(Request, range(3), "b", rid0=7100))
    ms._dispatch(time.monotonic())
    b_slices = set(ms.slices_of("b"))
    sid = next(s for tr in ms._inflight.values() for s in tr.copies if s in b_slices)
    assert ms.fail_slice(sid)
    done = ms.run_until_idle()
    assert len(done) == 3
    _check(done, setup["single"][1], 3)
    assert set(ms.tenant_stats()["b"]["routed_to"]) <= b_slices
    assert all(ms.engines[s].stats["admitted"] == 0 for s in ms.slices_of("a"))


def test_resize_rebalances_between_tenants_as_the_reference(setup):
    ms = _tenant_fleet(setup)
    ref = rms.build_multislice_engine(
        n_slices=4, ec=_ec(rengine.EngineConfig),
        tenants=[rms.TenantSpec(cfg=setup["rcfg"], name=nm, n_slices=2,
                                params=setup["jp"][i]) for i, nm in enumerate(TENANTS)])
    ms.offer(_tenant_reqs())
    ms.step()
    assert ms._inflight
    with pytest.raises(ValueError):
        ms.resize(n_slices=1)
    ms.resize(n_slices=3)
    ref.resize(n_slices=3)
    assert ms.slice_tenant == ref.slice_tenant
    assert ms.placement.assignments == ref.placement.assignments
    for sid, e in ms.engines.items():
        assert e.model is setup["pt"][TENANTS.index(ms.slice_tenant[sid])]
    _check(ms.run_until_idle(), setup["rtenants"], 18)
    for name in TENANTS:
        assert set(ms.tenant_stats()[name]["routed_to"]) <= set(ms.slices_of(name))


# --- the two-family fleet: tinyllama + mamba2 behind one admission queue ----

SSM = "mamba2-370m"
T_LENS = [17.0, 19.0, 21.0, 23.0, 25.0, 18.0]
T_BUDGETS = [4, 6, 3, 8, 5, 7]
T_BASE = {ARCH: 8100, SSM: 8200}


def _treqs(cls, model):
    return [cls(rid=T_BASE[model] + i, arrival=0.0, length=T_LENS[i],
                max_new_tokens=T_BUDGETS[i], model=model) for i in range(len(T_LENS))]


@pytest.fixture(scope="module")
def two_family():
    """Reduced tinyllama and reduced mamba2 at fp32, the JAX package's
    seed-0 weights of each, and the JAX two-tenant fleet's tokens (the
    reference's own two-tenant fixture, tests/test_multislice.py)."""
    rcfgs = {m: dataclasses.replace(ref_reduced(m), dtype="float32") for m in (ARCH, SSM)}
    cfgs = {m: dataclasses.replace(reduced(m), dtype="float32") for m in (ARCH, SSM)}
    jp = {m: rapi.init_params(rcfgs[m], jax.random.PRNGKey(0), dtype="float32")
          for m in (ARCH, SSM)}
    pt = {m: LM(cfgs[m], from_reference(jax.tree.map(np.asarray, jp[m]), cfgs[m], "cpu",
                                        "float32")) for m in (ARCH, SSM)}
    rfleet = rms.build_multislice_engine(
        n_slices=4, ec=_ec(rengine.EngineConfig),
        tenants=[rms.TenantSpec(cfg=rcfgs[m], name=m, n_slices=2, params=jp[m])
                 for m in (ARCH, SSM)])
    rfleet.submit_many(_treqs(RRequest, ARCH) + _treqs(RRequest, SSM))
    return dict(cfgs=cfgs, pt=pt, ref=_tokens(rfleet.run_until_idle()),
                rtenant_map=rfleet.slice_tenant)


def test_two_family_fleet_equals_the_reference_fleet_per_rid(two_family):
    """Two model families on disjoint slice sets behind one admission
    queue, each slice's engine built for its owner's model (a KV pool for
    tinyllama, conv/state rows for mamba2): per rid the tokens equal the
    JAX package's two-tenant fleet's, and no request touched a foreign
    slice."""
    cfgs, pt = two_family["cfgs"], two_family["pt"]
    ms = build_multislice_engine(
        n_slices=4, ec=_ec(EngineConfig), device="cpu",
        tenants=[TenantSpec(cfg=cfgs[m], name=m, n_slices=2, params=pt[m])
                 for m in (ARCH, SSM)])
    assert ms.slice_tenant == two_family["rtenant_map"]
    ms.submit_many(_treqs(Request, ARCH) + _treqs(Request, SSM))
    done = ms.run_until_idle()
    _check(done, two_family["ref"], 2 * len(T_LENS))
    for sid, e in ms.engines.items():
        m = ms.slice_tenant[sid]
        assert e.cfg is cfgs[m] and e.model is pt[m]
        assert set(e._pool["body"]["l0"]["mixer"]) == (
            {"conv", "state"} if m == SSM else {"k", "v"})
    ts = ms.tenant_stats()
    for m in (ARCH, SSM):
        assert ts[m]["completed"] == len(T_LENS) and ts[m]["dead"] == 0
        assert set(ts[m]["routed_to"]) <= set(ms.slices_of(m))
    assert all(e.stats["admitted"] > 0 for e in ms.engines.values())
    assert not ms.chunked_for_model(SSM)


def test_rebalance_and_placement_equal_reference_over_a_sweep():
    rng = np.random.default_rng(0)
    for _ in range(200):
        k = int(rng.integers(1, 5))
        asks = {f"t{i}": int(rng.integers(1, 10)) for i in range(k)}
        n = int(rng.integers(1, 24))
        want = got = None
        try:
            want = rmig.rebalance_slices(n, asks)
        except ValueError:
            with pytest.raises(ValueError):
                mig.rebalance_slices(n, asks)
        if want is not None:
            got = mig.rebalance_slices(n, asks)
            assert got == want
        pod = int(rng.integers(1, 300))
        spec = [(f"t{i}", int(rng.integers(0, 4)), int(rng.choice([0, 1, 2, 16, 64])))
                for i in range(k)]
        try:
            rp = rmig.plan_placement(pod, [rmig.PlacementAsk(*a) for a in spec])
        except ValueError:
            with pytest.raises(ValueError):
                mig.plan_placement(pod, [mig.PlacementAsk(*a) for a in spec])
            continue
        p = mig.plan_placement(pod, [mig.PlacementAsk(*a) for a in spec])
        assert (p.assignments, p.stranded_chips, p.fragmentation, p.slice_counts()) == \
            (rp.assignments, rp.stranded_chips, rp.fragmentation, rp.slice_counts())


def test_partition_equals_reference_and_menu_names_h100_profiles():
    for n_dev in (1, 3, 4, 8, 17):
        for cps in (1, 2, 4, 16):
            p, rp = mig.partition_pod(list(range(n_dev)), cps), \
                rmig.partition_pod(list(range(n_dev)), cps)
            assert [s.devices.tolist() for s in p.slices] == \
                [s.devices.tolist() for s in rp.slices]
            assert (p.spec.chips_per_slice, p.spec.n_slices, p.stranded_chips) == \
                (rp.spec.chips_per_slice, rp.spec.n_slices, rp.stranded_chips)
    menu = mig.menu_for_pod(1)
    assert [s.name for s in menu] == ["1g.10gb(7x)", "2g.20gb(3x)", "3g.40gb(2x)",
                                      "4g.40gb(1x)", "7g.80gb(1x)"]
    assert [s.stranded(7) for s in menu] == [0, 1, 1, 3, 0]
    assert [s.n_slices for s in mig.menu_for_pod(4)] == [28, 12, 8, 4, 4]


def test_fleet_entry_points_default_to_cuda_and_refuse_an_unserved_arch(setup):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_multislice_engine(reduced(ARCH), n_slices=2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MultiSliceEngine(setup["cfg"], setup["pt"][0], _policy(BatchPolicy, 2),
                             n_slices=2)
    other = dataclasses.replace(setup["cfg"], name="whisper-base")
    with pytest.raises(ValueError, match="not served"):
        build_multislice_engine(n_slices=2, device="cpu",
                                tenants=[TenantSpec(cfg=other, params=setup["pt"][0])])


@pytest.mark.parametrize("flags", [
    ["--arch", ARCH, "--slices", "2", "--continuous"],
    ["--tenants", f"{ARCH}:1,{ARCH}:1"],
    ["--arch", ARCH, "--slices", "2", "--continuous", "--pipelined", "--clock", "virtual"],
])
def test_serve_launcher_fleet_on_the_cpu(flags, capsys):
    from repro_torch.launch.serve import main

    main([*flags, "--reduced", "--device", "cpu", "--requests", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "slice 1 [" in out
    if "--tenants" in flags:
        assert f"tenant {ARCH}@1" in out


# each flag's misuse, and what the refusal says
_MISUSE = {"--controller": (["--controller"], "add --pipelined"),
           "--controller-menu": (["--pipelined", "--controller", "--controller-menu", "1,x"],
                                 "comma-separated"),
           "--calibrate-knee": (["--tenants", f"{ARCH}:1", "--calibrate-knee", "k.json"],
                                "needs --arch"),
           "--knee-profiles": (["--arch", ARCH, "--knee-profiles", "no-such-knees.json"],
                               "--knee-profiles no-such-knees.json")}


@pytest.mark.parametrize("flag", [["--controller"], ["--controller-menu", "1,2"],
                                  ["--calibrate-knee", "k.json"],
                                  ["--knee-profiles", "k.json"]])
def test_serve_launcher_refuses_unported_flags(flag, capsys):
    """The controller and knee flags are ported; each refuses its misuse
    at parse time, before anything is built."""
    from repro_torch.launch.serve import main

    args, why = _MISUSE[flag[0]]
    if "--tenants" not in args and "--arch" not in args:
        args = ["--arch", ARCH, *args]
    with pytest.raises(SystemExit):
        main([*args, "--reduced", "--device", "cpu"])
    assert why in capsys.readouterr().err
