"""The port's training modules against the JAX package's, on the CPU:
AdamW and its schedule, int8 gradient compression, the synthetic batches,
checkpoints (both directions, and the twins of tests/test_checkpoint.py),
the train loop, its launcher, and the quickstart's train-then-serve.

Exact where the arithmetic is the same IEEE operations in the same order
(int8 values and scales, the batches, the checkpoint bytes); fp32
tolerances stated beside each comparison otherwise.
"""
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import checkpoint as rckpt  # noqa: E402
from repro.training import grad_compression as rgc  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro.training import train_loop as rloop  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models.params import from_reference, leaves, tree_map  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import grad_compression as gc  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"


def _np(tree):
    return dict(leaves(jax.tree.map(np.asarray, tree)))


def _torch_np(tree):
    return {k: v.numpy() for k, v in leaves(tree)}


def _random_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"a": rng.standard_normal((3, 4, 2)).astype(np.float32),
                    "b": rng.standard_normal((7,)).astype(np.float32)},
            "z": rng.standard_normal((1,)).astype(np.float32)}


# --- optimizer ------------------------------------------------------------------


@pytest.mark.parametrize("oc", [dict(lr=3e-4, warmup_steps=5, total_steps=20),
                                dict(lr=1e-3, warmup_steps=0, total_steps=7),
                                dict(lr=2e-3, warmup_steps=3, total_steps=3)])
def test_schedule_matches_reference_on_both_sides_of_warmup(oc):
    steps_ = np.arange(0, 25, dtype=np.int32)
    want = np.asarray(ropt.schedule(ropt.OptConfig(**oc), jnp.asarray(steps_)))
    got = optimizer.schedule(optimizer.OptConfig(**oc), torch.from_numpy(steps_)).numpy()
    assert got.dtype == np.float32
    assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_with_clipping_matches_reference():
    """Four updates of a random tree with gradients whose global norm is
    ~30x the clip norm (clipping active every step), across warm-up into
    the cosine: weights, moments, grad_norm and lr at fp32 rtol 1e-5."""
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0)
    p0 = _random_tree(0)
    rp = jax.tree.map(jnp.asarray, p0)
    ropt_state = ropt.init_opt_state(rp)
    tp = tree_map(torch.from_numpy, _random_tree(0))
    topt = optimizer.init_opt_state(tp)
    for i in range(4):
        g = tree_map(lambda a: 10 * a, _random_tree(10 + i))
        rp, ropt_state, rm = ropt.adamw_update(rp, jax.tree.map(jnp.asarray, g), ropt_state,
                                               ropt.OptConfig(**oc))
        tp, topt, m = optimizer.adamw_update(tp, tree_map(torch.from_numpy, g), topt,
                                             optimizer.OptConfig(**oc))
        assert float(m["grad_norm"]) > 10 * oc["clip_norm"]
        for k in ("grad_norm", "lr"):
            assert_allclose(float(m[k]), float(rm[k]), rtol=1e-6, err_msg=k)
        want, got = _np({"p": rp, "opt": ropt_state}), _torch_np({"p": tp, "opt": topt})
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(topt["step"]) == 4
    assert_allclose(float(optimizer.global_norm(tp)), float(ropt.global_norm(rp)), rtol=1e-6)


# --- gradient compression -----------------------------------------------------------


def test_quantize_int8_matches_reference_exactly():
    rng = np.random.default_rng(1)
    for x in (rng.standard_normal((64, 33)).astype(np.float32) * 3,
              np.zeros((5,), np.float32), np.array([0.5, -0.5, 1.5, 127.0], np.float32)):
        rq, rs = rgc.quantize_int8(jnp.asarray(x))
        q, s = gc.quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        np.testing.assert_array_equal(gc.dequantize_int8(q, s).numpy(),
                                      np.asarray(rgc.dequantize_int8(rq, rs)))


def test_error_feedback_matches_reference_over_50_rounds():
    rerr = rgc.init_error_state(jax.tree.map(jnp.asarray, _random_tree(0)))
    err = gc.init_error_state(tree_map(torch.from_numpy, _random_tree(0)))
    total, rtotal, gsum = None, None, None
    for r in range(50):
        g = _random_tree(100 + r)
        rq, rs, rerr = rgc.compress_grads(jax.tree.map(jnp.asarray, g), rerr)
        q, s, err = gc.compress_grads(tree_map(torch.from_numpy, g), err)
        for a, b in ((q, rq), (s, rs), (err, rerr)):
            want, got = _np(b), _torch_np(a)
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"round {r} {k}")
        d = _torch_np(gc.decompress_grads(q, s))
        np.testing.assert_array_equal(d["w"], np.asarray(rgc.decompress_grads(rq, rs)["w"]))
        total = d if total is None else {k: total[k] + d[k] for k in d}
        gsum = dict(leaves(g)) if gsum is None else {k: gsum[k] + v for k, v in leaves(g)}
    # error feedback: what was sent plus the carried residual is what was given
    for k, e in _torch_np(err).items():
        assert_allclose(total[k] + e, gsum[k], rtol=1e-5, atol=1e-4)


# --- data -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "whisper-base", "phi-3-vision-4.2b"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batch_iterator_is_byte_equal_to_reference(arch, seed):
    it = pipeline.batch_iterator(reduced(arch), pipeline.DataConfig(3, 24, seed=seed))
    rit = rpipe.batch_iterator(ref_reduced(arch), rpipe.DataConfig(3, 24, seed=seed))
    for _ in range(3):
        got, want = next(it), next(rit)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_prefetcher_keeps_order_and_close_joins_its_thread():
    cfg = reduced(ARCH)
    dc = pipeline.DataConfig(2, 8)
    pf = pipeline.Prefetcher(pipeline.batch_iterator(cfg, dc), depth=2)
    direct = pipeline.batch_iterator(cfg, dc)
    for _ in range(4):
        np.testing.assert_array_equal(next(pf)["tokens"], next(direct)["tokens"])
    pf.close()
    pf.t.join(timeout=5)
    assert not pf.t.is_alive()


# --- checkpoints ---------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "step": torch.tensor(7, dtype=torch.int32)}}


def _rtree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "b": {"c": jnp.ones((5,), jnp.int32), "step": jnp.int32(7)}}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save_checkpoint(str(tmp_path), 3, t)
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = ckpt.restore_checkpoint(str(tmp_path), t)
    for (pa, a), (pb, b) in zip(leaves(t), leaves(out)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_atomic_commit_ignores_partial(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 5, _tree())
    (tmp_path / ".tmp_step_000000009").mkdir()  # a crashed write
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_gc_keeps_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(str(tmp_path), s, _tree(), keep=2)
    steps_ = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps_) == 2 and steps_[-1].endswith("5".zfill(9))


def test_async_checkpointer_snapshots_before_the_tree_moves_on(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _tree()
    saver.save(1, t)
    t["a"].add_(100.0)  # the train loop updates in place while the writer runs
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 1
    out = ckpt.restore_checkpoint(str(tmp_path), t)
    assert torch.equal(out["a"], torch.arange(12.0).reshape(3, 4))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port's checkpoint restores in the JAX package and the JAX
    package's in the port: leaf for leaf, dtype for dtype, bit for bit; the
    manifests agree but for the time."""
    ckpt.save_checkpoint(str(tmp_path / "port"), 4, _tree())
    out = rckpt.restore_checkpoint(str(tmp_path / "port"), _rtree())
    for (p, a), (_, b) in zip(leaves(_tree()), leaves(jax.tree.map(np.asarray, out))):
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == b.tobytes(), p
    rckpt.save_checkpoint(str(tmp_path / "ref"), 4, _rtree())
    back = ckpt.restore_checkpoint(str(tmp_path / "ref"), _tree())
    for (p, a), (_, b) in zip(leaves(_tree()), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    man = [json.loads((tmp_path / d / "step_000000004" / "manifest.json").read_text())
           for d in ("port", "ref")]
    for m in man:
        m.pop("time")
    assert man[0] == man[1]


def test_train_state_checkpoint_crosses_and_bf16_is_refused(tmp_path):
    cfg = reduced(ARCH)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt.save_checkpoint(str(tmp_path), 2, state)
    rp = rapi.init_params(ref_reduced(ARCH), jax.random.PRNGKey(1))
    rstate = {"params": rp, "opt": ropt.init_opt_state(rp)}  # the structure restored into
    out = _np(rckpt.restore_checkpoint(str(tmp_path), rstate))
    mine = _torch_np(state)
    assert out.keys() == mine.keys()
    for k in mine:
        assert out[k].tobytes() == mine[k].tobytes(), k
    low = tree_map(lambda p: p.to(torch.bfloat16), state["params"])
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save_checkpoint(str(tmp_path / "bf16"), 1, low)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(1)})


# --- the train loop ------------------------------------------------------------------


def _fp32(arch=ARCH):
    return (dataclasses.replace(ref_reduced(arch), dtype="float32"),
            dataclasses.replace(reduced(arch), dtype="float32"))


def _reference_state(monkeypatch, rcfg, cfg):
    """Make the port's train() start from the reference's seed-0 state."""
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)

    def init(cfg_, generator, device):
        params = from_reference(tree, cfg_, device)
        return {"params": params, "opt": optimizer.init_opt_state(params)}

    monkeypatch.setattr(steps, "init_train_state", init)


def test_train_losses_match_reference(monkeypatch):
    """Ten steps of train() from the same seed-0 weights and batches: every
    loss within rtol 1e-4 (fp32; AdamW's sign-like steps on near-zero
    gradients let the weights drift apart by rounding, slowly)."""
    rcfg, cfg = _fp32()
    dc = dict(global_batch=2, seq_len=16)
    tc = dict(total_steps=10, log_every=5)
    want = rloop.train(rcfg, make_local_mesh(), rpipe.DataConfig(**dc),
                       rloop.TrainLoopConfig(**tc))
    _reference_state(monkeypatch, rcfg, cfg)
    got = train_loop.train(cfg, pipeline.DataConfig(**dc), train_loop.TrainLoopConfig(**tc),
                           device="cpu")
    assert got["steps"] == want["steps"] == 10
    assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert int(got["final_state"]["opt"]["step"]) == 10


class _Recorder:
    """A Prefetcher that records the tokens of every batch the loop takes."""

    def __init__(self, base, seen):
        self.base, self.seen = base, seen

    def __call__(self, it, depth=2):
        pf = self.base(it, depth)
        nxt = pf.__next__
        seen = self.seen

        class Wrapped:
            def __next__(self):
                b = nxt()
                seen.append(np.array(b["tokens"]))
                return b

            def close(self):
                pf.close()

        return Wrapped()


def test_restart_replays_the_stream_from_batch_0_in_both_packages(monkeypatch, tmp_path):
    """A fault both packages share: train() builds a fresh batch_iterator
    and resumes at the checkpoint's step, so the resumed steps see batches
    0, 1, ... again, not the batches after the checkpoint."""
    rcfg, cfg = _fp32()
    dc = dict(global_batch=2, seq_len=16)
    tc = dict(total_steps=8, ckpt_every=5, log_every=100)
    stream = pipeline.batch_iterator(cfg, pipeline.DataConfig(**dc))
    first = [next(stream)["tokens"] for _ in range(8)]
    seen = {}
    for name, mod, run in (
            ("ref", rloop, lambda **kw: rloop.train(
                rcfg, make_local_mesh(), rpipe.DataConfig(**dc),
                rloop.TrainLoopConfig(ckpt_dir=str(tmp_path / "ref"), **tc), **kw)),
            ("port", train_loop, lambda **kw: train_loop.train(
                cfg, pipeline.DataConfig(**dc),
                train_loop.TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **tc),
                device="cpu", **kw))):
        with pytest.raises(RuntimeError, match="injected failure"):
            run(fail_at_step=6)
        seen[name] = []
        monkeypatch.setattr(mod, "Prefetcher", _Recorder(mod.Prefetcher, seen[name]))
        out = run()
        assert out["steps"] == 3
    for name in ("ref", "port"):
        assert len(seen[name]) == 3
        for i, toks in enumerate(seen[name]):  # steps 5, 6, 7 took batches 0, 1, 2
            np.testing.assert_array_equal(toks, first[i], err_msg=name)
        assert not np.array_equal(seen[name][0], first[5])


def test_train_restart_after_injected_failure(tmp_path):
    """Crash at step 6, restart, and finish: the loop resumes at the
    checkpoint of step 5, not from scratch."""
    cfg = reduced(ARCH)
    dc = pipeline.DataConfig(global_batch=2, seq_len=16)
    tc = train_loop.TrainLoopConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=5,
                                    log_every=100)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop.train(cfg, dc, tc, fail_at_step=6, device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 5
    saved = ckpt.restore_checkpoint(str(tmp_path), steps.init_train_state(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert int(saved["opt"]["step"]) == 5
    out = train_loop.train(cfg, dc, tc, device="cpu")
    assert out["steps"] == 5
    assert np.isfinite(out["losses"]).all()
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_training_reduces_loss():
    cfg = reduced(ARCH)
    out = train_loop.train(cfg, pipeline.DataConfig(global_batch=4, seq_len=32),
                           train_loop.TrainLoopConfig(total_steps=20, log_every=100),
                           device="cpu")
    first, last = np.mean(out["losses"][:3]), np.mean(out["losses"][-3:])
    assert last < first, (first, last)


def test_non_finite_loss_raises(monkeypatch):
    cfg = reduced(ARCH)
    real = steps.make_train_step

    def poisoned(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            state, m = step(state, batch)
            return state, dict(m, loss=torch.tensor(float("nan")))
        return run

    monkeypatch.setattr(steps, "make_train_step", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        train_loop.train(cfg, pipeline.DataConfig(2, 8),
                         train_loop.TrainLoopConfig(total_steps=2), device="cpu")


# --- entry points -------------------------------------------------------------------------


def test_train_launcher_reduced_on_cpu(capsys):
    from repro_torch.launch import train as launch

    out = launch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "16"])
    assert out["steps"] == 3 and np.isfinite(out["losses"]).all()
    assert "done: 3 steps, final loss" in capsys.readouterr().out
    for flag in ("--production-mesh", "--multi-pod"):
        with pytest.raises(SystemExit):
            launch.main(["--arch", ARCH, "--reduced", "--device", "cpu", flag])
        assert flag in capsys.readouterr().err


def test_quickstart_trains_then_serves_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, done = mod.main(["--device", "cpu"])
    assert out["steps"] == 20 and out["losses"][-1] < out["losses"][0]
    assert len(done) == 12 and len({r.rid for r in done}) == 12
    text = capsys.readouterr().out
    assert "== training ==" in text and "served 12 requests in" in text
