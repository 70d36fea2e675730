"""The PyTorch package's online partition controller against the JAX
package's, on the CPU.

* Decision logic: every case of the reference's fake-runtime tests
  (`tests/test_partition_controller.py`) is a scenario here, driven through
  both controllers on the same fake fleet; each scenario records what a
  controller returned or raised, every resize it made, its next wake-up,
  its counter and spans, and both packages must record the same, with
  `decisions_json()` equal byte for byte.
* The closed loop on a real fleet: reduced tinyllama at fp32 (the JAX
  package's weights carried across), text traffic on the virtual clock,
  the same explicit knee profiles in both packages; the decision logs are
  byte-equal, and so are the rids and the tokens.
* Knee calibration: `calibrate_knees` and the JSON round trip are byte for
  byte the reference's.
* The launcher: `--calibrate-knee` writes what `--knee-profiles` loads,
  `--controller` serves with 0 dead, and a `--slices` off the menu is
  refused.
* The phased audio trace `chip_smoke.py` replays on the card (phase 13),
  with the analytical profiles of the reduced model: its decision log is
  pinned by sha256, the same pin the card's run is held to.
"""
import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching import knee as rknee  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.core.control import partition as rpartition  # noqa: E402
from repro.core.metrics import MetricsRegistry as RRegistry  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import multislice as rms  # noqa: E402
from repro.serving import runtime as rruntime  # noqa: E402
from repro.serving.faults import replay_virtual as rreplay  # noqa: E402
from repro.serving.telemetry import Tracer as RTracer  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.batching import knee  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.core.control import partition  # noqa: E402
from repro_torch.core.metrics import MetricsRegistry  # noqa: E402
from repro_torch.models.api import LM  # noqa: E402
from repro_torch.models.params import from_reference, init_params  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.faults import replay_virtual  # noqa: E402
from repro_torch.serving.multislice import build_multislice_engine  # noqa: E402
from repro_torch.serving.runtime import PipelinedRuntime, RuntimeConfig  # noqa: E402
from repro_torch.serving.telemetry import Tracer  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"

PKGS = {
    "ref": SimpleNamespace(ControllerConfig=rpartition.ControllerConfig,
                           PartitionController=rpartition.PartitionController,
                           KneeProfile=rknee.KneeProfile, Registry=RRegistry,
                           Tracer=RTracer),
    "port": SimpleNamespace(ControllerConfig=partition.ControllerConfig,
                            PartitionController=partition.PartitionController,
                            KneeProfile=knee.KneeProfile, Registry=MetricsRegistry,
                            Tracer=Tracer),
}


# --- decision logic on a fake fleet -------------------------------------------


class _FakeEngine:
    """The surface the controller reads (the reference test's stand-in):
    pod width, in-flight map, admission backlog, the engine config's
    geometry, knee profiles, tenants, hedges, and a resize() that records
    its calls."""

    def __init__(self, pkg, n, *, tenants=None, inflight=0, backlog=0):
        self.ec = SimpleNamespace(bucket_width=64.0, max_new_tokens=8, segment_len=4,
                                  max_slots=4, chunk_lens=(16,),
                                  prefix_cache_bytes=1 << 20)
        self.pod = SimpleNamespace(slices=list(range(n)))
        self._chunked = True
        profile = pkg.KneeProfile(batch_sizes=(1, 2, 4, 8),
                                  latencies=(0.010, 0.011, 0.012, 0.020),
                                  batch_knee=4, time_knee=0.012)
        self._knee_profiles = {b: profile for b in range(9)}
        self._tenants = tenants or {}
        self._inflight = {i: object() for i in range(inflight)}
        self._backlog = backlog
        self.hedges = 0
        self.resize_calls = []

    def admission_depth(self):
        return self._backlog

    def resize(self, n_slices, now=0.0):
        self.resize_calls.append((n_slices, now))
        self.pod = SimpleNamespace(slices=list(range(n_slices)))
        return len(self._inflight)


def _fake_rt(pkg, eng):
    return SimpleNamespace(
        engine=eng,
        stats={"shed_slo": 0, "shed_backpressure": 0, "shed_error": 0,
               "shed_malformed": 0, "dead": 0},
        registry=pkg.Registry(), tracer=pkg.Tracer())


def _cc(pkg, **kw):
    base = dict(menu=(1, 2, 4), eval_interval_s=0.01, window_s=0.5, cooldown_s=0.1,
                improve_frac=0.15, amortize_horizon_s=1.0, max_reconfigs=6,
                min_observations=4, slo_target_s=0.05)
    return pkg.ControllerConfig(**{**base, **kw})


def _feed(ctl, now, n, length, model=None):
    for _ in range(n):
        ctl.observe(SimpleNamespace(length=length, model=model), now)


def _poll(log, ctl, now):
    dec = ctl.maybe_reconfigure(now)
    log.append(("poll", now, None if dec is None else dec.to_row()))
    return dec


def _raises(log, what, fn):
    try:
        fn()
        log.append((what, "ok"))
    except ValueError:
        log.append((what, "ValueError"))


def _finish(log, ctl, eng, rt=None):
    log.append(("resizes", eng.resize_calls))
    log.append(("json", ctl.decisions_json()))
    log.append(("wakeup", ctl.next_wakeup()))
    if rt is not None:
        log.append(("counter", rt.registry.value("fleet_reconfigs_total")))
        log.append(("spans", [(e.t, sorted(e.extra.items()))
                              for e in rt.tracer.of("reconfig")]))
    return log


def _bound(pkg, eng, **cc):
    ctl = pkg.PartitionController(_cc(pkg, **cc))
    rt = _fake_rt(pkg, eng)
    ctl.bind(rt)
    return ctl, rt


def sc_menu_must_be_ascending_unique(pkg):
    log = []
    for menu in ((4, 2, 1), (1, 2, 2), (1, 2, 4)):
        _raises(log, menu, lambda: pkg.PartitionController(pkg.ControllerConfig(menu=menu)))
    return log


def sc_bind_rejects_non_resizable_engine_and_starved_menu(pkg):
    log = []
    ctl = pkg.PartitionController(_cc(pkg))
    _raises(log, "no resize", lambda: ctl.bind(SimpleNamespace(engine=object())))
    eng = _FakeEngine(pkg, 2, tenants={"a": object(), "b": object(), "c": object()})
    ctl2 = pkg.PartitionController(_cc(pkg, menu=(1, 2)))
    _raises(log, "starved menu", lambda: ctl2.bind(_fake_rt(pkg, eng)))
    return log


def sc_burst_goes_fine_then_heavy_goes_coarse(pkg):
    log = []
    eng = _FakeEngine(pkg, 1, inflight=4, backlog=12)
    ctl, rt = _bound(pkg, eng)
    _feed(ctl, 0.10, 12, 8.0)                     # short-request burst
    _poll(log, ctl, 0.10)
    eng._inflight, eng._backlog = {0: object()}, 3
    ctl._arrivals.clear()
    _feed(ctl, 0.30, 6, 480.0)                    # heavy mix
    _poll(log, ctl, 0.30)
    return _finish(log, ctl, eng, rt)


def sc_cooldown_and_eval_interval_gate_thrash(pkg):
    log = []
    eng = _FakeEngine(pkg, 1, inflight=2, backlog=12)
    ctl, rt = _bound(pkg, eng, cooldown_s=0.2)
    _feed(ctl, 0.10, 12, 8.0)
    _poll(log, ctl, 0.10)
    eng.pod = SimpleNamespace(slices=[0])
    _feed(ctl, 0.15, 12, 8.0)
    for now in (0.15, 0.25, 0.31, 0.311):
        _poll(log, ctl, now)
    return _finish(log, ctl, eng, rt)


def sc_switch_budget_exhausts_and_next_wakeup_goes_quiet(pkg):
    log = []
    eng = _FakeEngine(pkg, 1, inflight=1, backlog=12)
    ctl, rt = _bound(pkg, eng, max_reconfigs=1, cooldown_s=0.0)
    _feed(ctl, 0.10, 12, 8.0)
    log.append(("wakeup", ctl.next_wakeup()))
    _poll(log, ctl, 0.10)
    eng.pod = SimpleNamespace(slices=[0])
    _feed(ctl, 0.30, 12, 8.0)
    _poll(log, ctl, 0.30)
    return _finish(log, ctl, eng, rt)


def sc_improvement_threshold_and_min_observations(pkg):
    log = []
    eng = _FakeEngine(pkg, 1, inflight=1, backlog=12)
    ctl, _ = _bound(pkg, eng, improve_frac=1e9)
    _feed(ctl, 0.10, 12, 8.0)
    _poll(log, ctl, 0.10)
    eng2 = _FakeEngine(pkg, 1, inflight=1, backlog=12)
    ctl2, _ = _bound(pkg, eng2, min_observations=50)
    _feed(ctl2, 0.10, 12, 8.0)
    _poll(log, ctl2, 0.10)
    _finish(log, ctl, eng)
    return _finish(log, ctl2, eng2)


def sc_drain_cost_gate_blocks_expensive_switch(pkg):
    log = []
    eng = _FakeEngine(pkg, 1, inflight=400, backlog=12)
    ctl, rt = _bound(pkg, eng, amortize_horizon_s=1e-4)
    _feed(ctl, 0.10, 12, 8.0)
    _poll(log, ctl, 0.10)
    return _finish(log, ctl, eng, rt)


def sc_idle_fleet_never_reconfigures(pkg):
    log = []
    eng = _FakeEngine(pkg, 1, inflight=0, backlog=0)
    ctl, rt = _bound(pkg, eng)
    _feed(ctl, 0.10, 12, 8.0)
    _poll(log, ctl, 0.10)
    return _finish(log, ctl, eng, rt)


def sc_apportionment_follows_windowed_arrival_share(pkg):
    log = []
    tenants = {"a": SimpleNamespace(n_slices_ask=1), "b": SimpleNamespace(n_slices_ask=1)}
    eng = _FakeEngine(pkg, 2, tenants=tenants, inflight=2, backlog=12)
    ctl, rt = _bound(pkg, eng, menu=(2, 4))
    _feed(ctl, 0.10, 9, 8.0, model="a")
    _feed(ctl, 0.10, 3, 8.0, model="b")
    _poll(log, ctl, 0.10)
    log.append(("asks", {k: t.n_slices_ask for k, t in tenants.items()}))
    return _finish(log, ctl, eng, rt)


def sc_switch_is_observable_and_log_is_deterministic(pkg):
    log = []
    eng = _FakeEngine(pkg, 1, inflight=2, backlog=12)
    ctl, rt = _bound(pkg, eng, cooldown_s=0.05)
    _feed(ctl, 0.10, 12, 8.0)
    _poll(log, ctl, 0.10)
    eng._inflight, eng._backlog = {0: object()}, 2
    ctl._arrivals.clear()
    _feed(ctl, 0.30, 6, 480.0)
    _poll(log, ctl, 0.30)
    _finish(log, ctl, eng, rt)
    ctl.reset()
    log.append(("after reset", ctl.decisions, ctl.decisions_json(), ctl.next_wakeup()))
    return log


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_decisions_equal_reference(scenario):
    ref, port = scenario(PKGS["ref"]), scenario(PKGS["port"])
    assert port == ref


# --- the closed loop on a real fleet ------------------------------------------


REAL_EC = dict(max_new_tokens=4, continuous=True, max_slots=4, segment_len=4,
               max_prompt_len=32)
REAL_CC = dict(menu=(1, 2), eval_interval_s=0.004, window_s=0.05, cooldown_s=0.05,
               improve_frac=0.2, amortize_horizon_s=0.5, max_reconfigs=2,
               min_observations=2, slo_target_s=0.02)


def _burst(cls):
    # 16 arrivals inside ~2 ticks against a 4-slot slice: the admission
    # backlog really accumulates at evaluation time
    return [cls(rid=9700 + i, arrival=0.01 + 0.0002 * i, length=17.0 + (i % 4),
                max_new_tokens=4) for i in range(16)]


@pytest.fixture(scope="module")
def real_fleet():
    """Both packages' closed loops, twice each, on the same weights and the
    same knee profiles (the reference fleet's own default, given to the
    port explicitly)."""
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jp = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    model = LM(cfg, from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu", "float32"))

    def ref_run():
        ms = rms.build_multislice_engine(rcfg, n_slices=1,
                                         ec=rengine.EngineConfig(**REAL_EC), params=jp)
        ms.fixed_expected_s = 1.0                 # no wall-EMA hedging
        ctl = rpartition.PartitionController(rpartition.ControllerConfig(**REAL_CC))
        rt = rruntime.PipelinedRuntime(ms, None, rruntime.RuntimeConfig(clock="virtual"),
                                       controller=ctl)
        return rt, ctl, rreplay(rt, _burst(RRequest), tick=2e-3)

    ref = [ref_run(), ref_run()]
    profiles = {b: knee.KneeProfile(p.batch_sizes, p.latencies, p.batch_knee, p.time_knee)
                for b, p in ref[0][0].engine._knee_profiles.items()}

    def port_run():
        ms = build_multislice_engine(cfg, n_slices=1, ec=EngineConfig(**REAL_EC),
                                     params=model, device="cpu", knee_profiles=profiles)
        ms.fixed_expected_s = 1.0
        ctl = partition.PartitionController(partition.ControllerConfig(**REAL_CC))
        rt = PipelinedRuntime(ms, None, RuntimeConfig(clock="virtual"), controller=ctl)
        return rt, ctl, replay_virtual(rt, _burst(Request), tick=2e-3)

    return ref, [port_run(), port_run()]


def _tokens(done):
    return {r.rid: np.asarray(r.payload) for r in done}


def test_real_fleet_decisions_equal_reference(real_fleet):
    ref, port = real_fleet
    (_, rc1, _), (_, rc2, _) = ref
    (rt, pc1, done1), (_, pc2, _) = port
    assert rc1.decisions_json() == rc2.decisions_json()
    assert pc1.decisions_json() == pc2.decisions_json() == rc1.decisions_json()
    assert len(pc1.decisions) >= 1 and pc1.decisions[0].reason == "burst_fine"
    assert rt.registry.value("fleet_reconfigs_total") == len(pc1.decisions)
    assert len(rt.tracer.of("reconfig")) == len(pc1.decisions)
    assert rt.conservation_ok() and not rt.dead


def test_real_fleet_rids_and_tokens_equal_reference(real_fleet):
    ref, port = real_fleet
    want = _tokens(ref[0][2])
    assert len(want) == 16
    for _, _, done in port:
        assert sorted(r.rid for r in done) == sorted(want)   # each exactly once
        for r in done:
            np.testing.assert_array_equal(np.asarray(r.payload), want[r.rid])


def test_build_pipelined_runtime_gives_a_controller_a_resizable_fleet():
    """One slice and a controller: the runtime still gets a fleet."""
    from repro_torch.serving.multislice import MultiSliceEngine
    from repro_torch.serving.runtime import build_pipelined_runtime

    cfg = reduced(ARCH)
    ctl = partition.PartitionController(partition.ControllerConfig(menu=(1, 2)))
    rt = build_pipelined_runtime(cfg, n_slices=1, ec=EngineConfig(**REAL_EC),
                                 device="cpu", controller=ctl)
    assert isinstance(rt.engine, MultiSliceEngine) and len(rt.engine.pod.slices) == 1
    assert rt.controller is ctl and ctl.next_wakeup() == 0.0
    rt.reset_metrics()                            # the registry reset reaches it
    assert ctl.decisions == [] and ctl.decisions_json() == "[]"


# --- knee calibration ---------------------------------------------------------


def _measure(batch, context_len):
    # a synthetic device: throughput doubles with the batch until a
    # context-dependent saturation batch, then latency grows linearly
    sat = 8 if context_len < 96 else 4
    return 0.010 * max(1.0, batch / sat) * (1 + context_len / 1000)


@pytest.mark.parametrize("max_batch,eps", [(32, 0.10), (8, 0.10), (64, 0.3)])
def test_calibrate_knees_and_json_equal_reference_byte_for_byte(max_batch, eps):
    kw = dict(buckets=(0, 1, 2), bucket_width=64, max_batch=max_batch, eps=eps)
    ref = rknee.calibrate_knees(_measure, **kw)
    port = knee.calibrate_knees(_measure, **kw)
    text = knee.profiles_to_json(port)
    assert text == rknee.profiles_to_json(ref)
    assert knee.profiles_from_json(text) == port
    assert knee.profiles_to_json(knee.profiles_from_json(text)) == text
    # each package reads the other's file
    assert knee.profiles_to_json(knee.profiles_from_json(rknee.profiles_to_json(ref))) == text
    assert rknee.profiles_to_json(rknee.profiles_from_json(text)) == text


# --- the launcher -------------------------------------------------------------


def test_serve_calibrates_knees_then_serves_with_the_controller(tmp_path, capsys):
    from repro_torch.launch.serve import main

    path = tmp_path / "knees.json"
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--max-slots", "4",
          "--calibrate-knee", str(path)])
    profiles = knee.profiles_from_json(path.read_text())
    assert sorted(profiles) == [0, 1]             # 128-token prompts, 64-token buckets
    assert all(p.batch_sizes == (1, 2, 4) for p in profiles.values())
    assert "Batch_knee=" in capsys.readouterr().out
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--continuous", "--pipelined",
          "--clock", "virtual", "--slices", "1", "--controller", "--controller-menu", "1,2",
          "--knee-profiles", str(path), "--requests", "6", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "knee profiles <- " in out and "(2 context buckets)" in out
    assert "served 6 requests" in out and "dead 0" in out
    assert "controller: " in out


@pytest.mark.parametrize("flags", [
    ["--slices", "3"],                            # default menu (1, 2, 4)
    ["--slices", "4", "--controller-menu", "1,2"],
    ["--slices", "1", "--controller-menu", "2,4"],
])
def test_serve_refuses_slices_off_the_controller_menu(flags, capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--arch", ARCH, "--reduced", "--device", "cpu", "--continuous",
              "--pipelined", "--controller", *flags])
    assert "must be on the controller menu" in capsys.readouterr().err


# --- the card's controller trace (chip_smoke.py phase 13) ---------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_card_controller_trace_log_is_pinned():
    """Phase 13's trace on the reduced model with its analytical profiles,
    on the CPU: two replays agree byte for byte, and the log's sha256 is
    the one the card's run must give (the profiles are explicit, so the log
    depends on neither the model's width nor the backend)."""
    cs = _chip_smoke()
    cfg = reduced(ARCH)
    model = LM(cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu", cfg.dtype))
    profiles = cs.analytical_profiles()
    runs = [cs.controller_replay(torch, np, model, profiles, "cpu") for _ in range(2)]
    (rt, ctl, done), (_, ctl2, done2) = runs
    text = ctl.decisions_json()
    assert text == ctl2.decisions_json()
    assert hashlib.sha256(text.encode()).hexdigest() == cs.ANALYTICAL_LOG_SHA256
    rows = json.loads(text)
    assert rows and rows[0]["reason"] == "burst_fine" and rows[0]["requeued"] >= 1
    assert sorted(r.rid for r in done) == list(range(cs.CONTROLLER_REQUESTS))
    assert rt.conservation_ok() and not rt.dead and not rt.shed
    assert rt.registry.value("fleet_reconfigs_total") == len(rows) \
        == len(rt.tracer.of("reconfig"))
    t2 = _tokens(done2)
    for r in done:
        np.testing.assert_array_equal(np.asarray(r.payload), t2[r.rid])
