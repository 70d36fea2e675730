"""The port's training step against the JAX package's, on the CPU.

Reduced configs at an fp32 override, the JAX package's seed-0 weights
carried across with `from_reference`. `train_loss` and every gradient leaf
against `jax.value_and_grad(lm.train_loss)` for one arch per family
(tinyllama, mixtral, mamba2, jamba, whisper with `audio_frames`,
phi-3-vision with `img_embeds`), plus mixtral at capacity factor 0.5, where
choices drop, through both MoE dispatches; batch 2 x 16 with some labels
-100. Tolerances: the loss at rtol 1e-5; a gradient leaf at rtol 1e-4 and
an atol of 1e-4 of that leaf's largest magnitude (the largest distance
seen is ~5e-6 of it, jamba's). Within the port, remat on equals remat off
bit for bit. The train step (AdamW included) against the reference's
jitted one: two microbatches against its scan, and three steps in a row;
metrics at rtol 1e-5 (2e-5 after three steps), moments at 1e-4 of each
leaf's magnitude, each weight leaf's update at a relative L2 distance of
1e-3 (see `_check_state`).
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import steps as rsteps  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import api, lm  # noqa: E402
from repro_torch.models.params import from_reference, leaves, tree_map  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402

torch.set_num_threads(2)

B, S = 2, 16
# (arch, config overrides): one arch per family; mixtral again with drops
CASES = {
    "tinyllama": ("tinyllama-1.1b", {}),
    "mixtral": ("mixtral-8x22b", {}),
    "mixtral-drops-einsum": ("mixtral-8x22b", {"capacity_factor": 0.5}),
    "mixtral-drops-sort": ("mixtral-8x22b", {"capacity_factor": 0.5, "moe_impl": "sort"}),
    "mamba2": ("mamba2-370m", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "whisper": ("whisper-base", {}),
    "phi-3-vision": ("phi-3-vision-4.2b", {}),
}


def _setup(arch, **over):
    rcfg = dataclasses.replace(ref_reduced(arch), dtype="float32", **over)
    cfg = dataclasses.replace(reduced(arch), dtype="float32", **over)
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    return rcfg, cfg, jparams, from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out["labels"][0, :3] = -100
    out["labels"][-1, -2:] = -100
    if cfg.enc_layers:
        out["audio_frames"] = rng.standard_normal(
            (b, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        out["img_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def _loss_and_grads(params, batch, cfg):
    p = tree_map(lambda x: x.detach().clone().requires_grad_(), params)
    loss, metrics = api.train_loss(p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    flat = [v for _, v in leaves(p)]
    grads = torch.autograd.grad(loss, flat)
    return {k: float(v.detach()) for k, v in metrics.items()}, {
        path: g.numpy() for (path, _), g in zip(leaves(p), grads)}


def _close_leaf(got, want, path):
    assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()), err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_train_loss_and_grads_match_reference(case):
    arch, over = CASES[case]
    rcfg, cfg, jparams, params = _setup(arch, **over)
    batch = _batch(cfg)
    f = jax.jit(jax.value_and_grad(lambda p, b: rapi.train_loss(p, b, rcfg), has_aux=True))
    (_, rmetrics), rgrads = f(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    rgrads = dict(leaves(jax.tree.map(np.asarray, rgrads)))
    metrics, grads = _loss_and_grads(params, batch, cfg)
    for k in ("loss", "nll", "aux"):
        assert_allclose(metrics[k], float(rmetrics[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if cfg.n_experts:
        assert metrics["aux"] > 0
    assert grads.keys() == rgrads.keys()
    for path, g in grads.items():
        assert np.isfinite(g).all(), path
        _close_leaf(g, rgrads[path], path)


@pytest.mark.parametrize("case", ["tinyllama", "mixtral-drops-sort", "mamba2", "whisper"])
def test_remat_on_equals_off(case):
    arch, over = CASES[case]
    _, cfg, _, params = _setup(arch, **over)
    batch = _batch(cfg, seed=3)
    assert cfg.remat
    # deterministic kernels: the embedding gradient's scatter-add otherwise
    # sums duplicate tokens in a thread-dependent order
    torch.use_deterministic_algorithms(True)
    try:
        on = _loss_and_grads(params, batch, cfg)
        off = _loss_and_grads(params, batch, dataclasses.replace(cfg, remat=False))
    finally:
        torch.use_deterministic_algorithms(False)
    assert on[0] == off[0]
    for path in on[1]:
        np.testing.assert_array_equal(on[1][path], off[1][path], err_msg=path)


def test_forward_train_mode_returns_hidden_and_aux_without_cache():
    _, cfg, _, params = _setup("mixtral-8x22b")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    x, aux = lm.forward(params, toks, cfg, mode="train")
    assert x.shape == (B, S, cfg.d_model) and aux.dtype == torch.float32 and aux.dim() == 0
    hidden, cache = lm.forward(params, toks, cfg, cache_len=S)  # prefill, as before
    assert isinstance(cache, dict) and "body" in cache
    # the two modes share the layers; with remat off their hidden states agree
    x_off, _ = lm.forward(params, toks, dataclasses.replace(cfg, remat=False), mode="train")
    torch.testing.assert_close(x_off, hidden, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        lm.forward(params, toks, cfg, mode="decode")


def _state_of(jparams):
    return {"params": jparams, "opt": ropt.init_opt_state(jparams)}


def _port_state(rstate, cfg):
    tree = jax.tree.map(np.asarray, rstate)
    params = from_reference(tree["params"], cfg, "cpu")
    return {"params": params, "opt": optimizer.init_opt_state(params)}


def _check_state(state, rstate, jparams, lr_sum, tol=1e-4):
    """Moments within tol of each leaf's magnitude. Weights: each leaf's
    update (new - initial) within a relative L2 distance of 1e-3 of the
    reference's, and no element off by more than 2 x the summed learning
    rate. AdamW moves a weight whose gradient is near 0 by about lr *
    sign(g), so gradients an ulp apart can move it by up to 2 lr: an
    elementwise bound tighter than that would test rounding, not the step."""
    got = dict(leaves(state))
    want = dict(leaves(jax.tree.map(np.asarray, rstate)))
    init = dict(leaves(jax.tree.map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype, path
        if path.startswith("params."):
            p0 = init[path[len("params."):]]
            du, dw = g - p0, w - p0
            assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw) + 1e-12, path
            assert np.abs(g - w).max() <= 2 * lr_sum, path
        else:
            assert_allclose(g, w, rtol=tol, atol=tol * max(float(np.abs(w).max()), 1e-30),
                            err_msg=path)


def test_microbatches_match_reference_scan():
    rcfg, cfg, jparams, _ = _setup("tinyllama-1.1b")
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    batch = _batch(cfg, b=4, seed=5)
    rstep = jax.jit(rsteps.make_train_step(rcfg, ropt.OptConfig(**oc), microbatches=2))
    rstate = _state_of(jparams)
    state = _port_state(rstate, cfg)
    rstate, rmetrics = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, metrics = steps.make_train_step(cfg, optimizer.OptConfig(**oc), 2)(state, batch)
    assert set(metrics) == set(rmetrics) == {"loss", "nll", "aux", "grad_norm", "lr"}
    for k in metrics:
        assert_allclose(float(metrics[k]), float(rmetrics[k]), rtol=1e-5, err_msg=k)
    _check_state(state, rstate, jparams, float(metrics["lr"]))
    # the last microbatch's metrics, as the reference's scan reports them
    half = {k: v[2:] for k, v in batch.items()}
    assert_allclose(float(metrics["loss"]),
                    _loss_and_grads(_port_state(_state_of(jparams), cfg)["params"], half,
                                    cfg)[0]["loss"], rtol=1e-6)


def test_three_train_steps_match_reference():
    rcfg, cfg, jparams, _ = _setup("tinyllama-1.1b")
    oc = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    rstep = jax.jit(rsteps.make_train_step(rcfg, ropt.OptConfig(**oc)))
    step = steps.make_train_step(cfg, optimizer.OptConfig(**oc))
    rstate = _state_of(jparams)
    state = _port_state(rstate, cfg)
    dc = pipeline.DataConfig(global_batch=B, seq_len=S)
    it = pipeline.batch_iterator(cfg, dc)
    rit = rpipe.batch_iterator(rcfg, rpipe.DataConfig(global_batch=B, seq_len=S))
    lr_sum = 0.0
    for _ in range(3):
        batch, rbatch = next(it), next(rit)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in rbatch.items()})
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert_allclose(float(m[k]), float(rm[k]), rtol=2e-5, err_msg=k)
        lr_sum += float(m["lr"])
    assert int(state["opt"]["step"]) == 3 and state["opt"]["step"].dtype == torch.int32
    _check_state(state, rstate, jparams, lr_sum)


def test_init_train_state_is_fp32_master_and_zero_moments():
    cfg = reduced("tinyllama-1.1b")
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(v.dtype == torch.float32 for _, v in leaves(state["params"]))
    assert all(float(v.abs().max()) == 0 for _, v in leaves(state["opt"]["mu"]))
    assert int(state["opt"]["step"]) == 0
    assert steps.TRAIN_MICROBATCHES == rsteps.TRAIN_MICROBATCHES


def test_prefill_and_decode_steps_match_the_model():
    _, cfg, _, params = _setup("tinyllama-1.1b")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    logits, cache = steps.make_prefill(cfg)(params, {"tokens": toks})
    want, _ = lm.prefill(params, toks, cfg)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt = torch.argmax(logits, -1)
    out, _ = steps.make_decode(cfg)(params, {"cache": cache, "tokens": nxt, "pos": S})
    assert out.shape == (B, 1, cfg.vocab) and torch.isfinite(out).all()
