"""`examples/serve_audio_preba_torch.py`, PREBA's audio study on the port,
on the CPU: its three result lines, its DPU costs from PERF.md on a
machine without a card, and its real-DPU features (the kernels' plain
versions) against the JAX package's `preprocess_cpu` pipeline, within the
fleet phase's feature gate; and the simulator's measured DPU costs."""
import importlib.util
from pathlib import Path

import numpy as np
from numpy.testing import assert_allclose

from repro.data import preprocess_cpu as rpp
from repro_torch.core.batching.policy import BatchPolicy
from repro_torch.serving.requests import WorkloadSpec, generate_requests
from repro_torch.serving.simulator import SimConfig, simulate

ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_audio_preba_torch", ROOT / "examples" / "serve_audio_preba_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_on_the_cpu(capsys):
    ex = _example()
    out = ex.main(["--device", "cpu", "--requests", "300"])
    text = capsys.readouterr().out
    for head in ("baseline :", "PREBA    :", "gain     :"):
        assert sum(line.startswith(head) for line in text.splitlines()) == 1, head
    assert "PERF.md §6 rows 1-3" in text and out["unit_ms"] == ex.PERF_DPU_MS
    assert len(out["baseline"].completed) == len(out["preba"].completed) == 300
    feats, audio = out["feats"], out["audio"]
    assert feats.shape == (498, 80) and np.isfinite(feats).all()
    # the JAX package's audio_pipeline, its normalize fed float64: on float32
    # it misses the empty mel band's constant column (exact output 0) by
    # 0.016 at these 498 frames (ROADMAP Queue 3 G)
    mel = rpp.mel_spectrogram(rpp.resample_poly(audio, 16000, 48000))
    assert_allclose(feats, rpp.normalize_meanvar(mel.astype(np.float64)), rtol=1e-3,
                    atol=1e-2)


def test_slice_menu_is_the_h100_mig_profiles():
    ex = _example()
    assert ex.SLICE_MENU["1g.10gb(7x)"] == dict(chips=1 / 7, n_slices=7)
    assert ex.SLICE_MENU["7g.80gb(1x)"] == dict(chips=1.0, n_slices=1)
    assert len(ex.SLICE_MENU) == 5


def test_simulator_takes_measured_dpu_costs():
    """`dpu_costs` replaces the analytical unit costs on the virtual clock:
    at 10 ms a unit, no request leaves the DPU before 30 ms."""
    reqs = generate_requests(WorkloadSpec(rate_qps=50.0, seed=3), 20)
    pol = BatchPolicy(batch_max={0: 4}, time_queue=0.0, time_knee=0.01, n_slices=2,
                      bucket_width=64.0)
    costs = {u: (lambda length_s: 0.01) for u in ("resample", "mel", "normalize")}
    res = simulate(reqs, pol, lambda b: 0.001, lambda s: 0.0,
                   SimConfig(n_slices=2, preprocess="dpu"), device="cpu", dpu_costs=costs)
    assert len(res.completed) == 20
    assert min(res.preprocess_wait) >= 0.03 - 1e-12
