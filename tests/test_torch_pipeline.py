"""The GPipe pipeline of the PyTorch package (`distributed/pipeline.py`)
against sequential apply and the JAX package's `pipeline_apply`: one spawn
of 4 gloo CPU ranks runs every case (the workers are
`torch_tp_ranks.pipe_rank`) while a subprocess runs the JAX version on 4
host devices; each has a time limit of its own."""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.distributed.pipeline import bubble_fraction as ref_bubble_fraction
from repro_torch.configs import reduced
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.params import init_params, tree_map

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tp_ranks  # noqa: E402

MB, D = 2, 16
TOL = 2e-5  # the JAX package's own pipeline test


def _case(n_stages, n_micro, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_stages, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((n_stages, D)) * 0.1).astype(np.float32)
    mbs = rng.standard_normal((n_micro, MB, D)).astype(np.float32)
    r = rng.standard_normal((n_micro, MB, D)).astype(np.float32)
    return w, b, mbs, r


CASES = {key: _case(*key, seed=i) for i, key in enumerate(torch_tp_ranks.PIPE_CASES)}

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipeline_apply
    data = np.load(sys.argv[1])
    out = {}
    for n_stages, n_micro in ((4, 8), (4, 2), (2, 1)):
        k = f"{n_stages}_{n_micro}"
        w, b, mbs, r = (jnp.asarray(data[f"{k}_{n}"]) for n in ("w", "b", "mbs", "r"))
        mesh = jax.make_mesh((n_stages,), ("pipe",), devices=jax.devices()[:n_stages],
                             axis_types=(jax.sharding.AxisType.Auto,))
        stage = lambda p, x: jnp.tanh(x @ p[0] + p[1])
        f = lambda w, b, x: pipeline_apply(stage, (w, b), x, mesh)
        loss = lambda w, b, x: jnp.sum(f(w, b, x) * r)
        out[k + "_out"] = np.asarray(jax.jit(f)(w, b, mbs))
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(w, b, mbs)
        for n, g in zip(("w", "b", "mbs"), grads):
            out[f"{k}_g{n}"] = np.asarray(g)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, the JAX version's), run at once."""
    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.numpy(), init_params(cfg, gen, "cpu"))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (4, MB, 8)).astype(np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        inp, res = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, **{f"{s}_{m}_{n}": a for (s, m), arrs in CASES.items()
                         for n, a in zip(("w", "b", "mbs", "r"), arrs)})
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, inp, res], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = run_ranks(torch_tp_ranks.pipe_rank, 4, (CASES, (cfg, params, tokens)),
                              device="cpu", timeout=120)
            _, err = proc.communicate(timeout=240)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-3000:]
        ref = dict(np.load(res))
    return ranks, ref


def test_bubble_fraction():
    for s in range(1, 9):
        for m in range(1, 33):
            assert bubble_fraction(s, m) == ref_bubble_fraction(s, m)
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(4, 28) < 0.1


def _sequential(w, b, mbs, r):
    w, b, x = (torch.tensor(a, requires_grad=True) for a in (w, b, mbs))
    y = x
    for s in range(w.shape[0]):
        y = torch.tanh(y @ w[s] + b[s])
    (y * torch.from_numpy(r)).sum().backward()
    return y.detach().numpy(), w.grad.numpy(), b.grad.numpy(), x.grad.numpy()


@pytest.mark.parametrize("key", list(CASES), ids=lambda k: f"{k[0]}stages-{k[1]}micro")
def test_pipeline_equals_sequential_apply(runs, key):
    ranks, _ = runs
    want, gw, gb, gx = _sequential(*CASES[key])
    for out in ranks:
        stage, y, w_grad, b_grad, x_grad = out[key]
        assert torch.equal(torch.from_numpy(y), torch.from_numpy(want))
        np.testing.assert_allclose(w_grad, gw[stage], rtol=0, atol=1e-5)
        np.testing.assert_allclose(b_grad, gb[stage], rtol=0, atol=1e-5)
        np.testing.assert_allclose(x_grad, gx, rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", list(CASES), ids=lambda k: f"{k[0]}stages-{k[1]}micro")
def test_pipeline_matches_the_jax_package(runs, key):
    """Outputs, and jax.grad of sum(out * r) with respect to w, b and the
    microbatches: each rank holds its stage's w and b gradients and the
    microbatches' whole."""
    ranks, ref = runs
    k = f"{key[0]}_{key[1]}"
    for out in ranks:
        stage, y, w_grad, b_grad, x_grad = out[key]
        np.testing.assert_allclose(y, ref[k + "_out"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(w_grad, ref[k + "_gw"][stage], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(b_grad, ref[k + "_gb"][stage], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(x_grad, ref[k + "_gmbs"], rtol=TOL, atol=TOL)


def test_pipeline_of_tinyllama_layers_equals_the_forward(runs):
    """Reduced tinyllama at fp32, 4 layers as 2 stages of 2, 4 microbatches:
    the final hidden states equal `lm.forward`'s on each microbatch."""
    ranks, _ = runs
    for out in ranks:
        got, want = out["layers"]
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))


def test_stage_params_cut_the_leading_dim():
    from repro_torch.distributed.pipeline import stage_params

    class _Mesh:
        def get_local_rank(self, axis):
            return 2

    tree = {"a": torch.arange(12.0).reshape(4, 3), "b": (torch.arange(4.0),)}
    got = stage_params(tree, _Mesh())
    assert torch.equal(got["a"], torch.tensor([6.0, 7.0, 8.0]))
    assert torch.equal(got["b"][0], torch.tensor(2.0))
