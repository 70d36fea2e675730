"""The small-serve layout on gloo ranks on the CPU, against the unsharded
port and the JAX package.

Models under 1B parameters that are not SSMs (whisper-base and every
reduced config) serve with their attention weights whole on every `model`
rank and each attention cache cut along its sequence, where the axis
divides it (the JAX package's `serve_rules` with `kv_heads: None` and `seq:
"model"`); the decode kernel runs over each rank's cut with its
log-sum-exp and the ranks' outputs merge. Each mesh, (1, 2), (1, 4) and
(2, 2), is one spawn of ranks (`launch.mesh.run_ranks`, with its own
timeout), run once and read by one test a config, the rule left on. The
configs (`torch_tp_ranks.SMALL_CONFIGS`) at fp32 with the JAX package's
seed-0 weights: reduced tinyllama with a 4-token prompt in a 32-slot ring
(the cuts of ranks above 0 hold no valid key for the first steps) and in
a 33-slot ring that no axis divides (whole on every rank), h2o-danube whose
16-slot window ring wraps in prefill and again in decode, mixtral (the
layout beside the MoE fields) and whisper with numpy audio frames (its
24-frame cross cache cut as well). Checked: the logits equal the unsharded
port's within rtol = atol = 1e-5; their greedy tokens equal the JAX
package's `lm.prefill`/`lm.decode`; each rank's weight and cache leaves
have the shapes of the JAX package's `spec_for` under its `serve_rules`;
after prefill and after the last step each rank's cache equals the JAX
package's whole cache cut to the rank's rows and slots within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from test_torch_tp_serve import FakeMesh, _cut_shapes  # noqa: E402
from torch_tp_ranks import (ROWS, SMALL_CONFIGS, SMALL_STEPS, config,  # noqa: E402
                            small_rank, small_run)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = [(1, 2), (1, 4), (2, 2)]
R_PREFILL = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
R_DECODE = jax.jit(rlm.decode, static_argnums=(4,))


def _ref_cfg(name):
    arch, fields, _, _ = SMALL_CONFIGS[name]
    return dataclasses.replace(ref_reduced(arch), dtype="float32", **fields)


def _ref_run(name):
    """The JAX package's seed-0 weights (numpy), the prompts, the audio
    frames (whisper's, else None), its prefill + greedy decode: tokens
    [ROWS, 1 + SMALL_STEPS], and its whole cache after prefill and after
    the last step ({path: numpy})."""
    rcfg = _ref_cfg(name)
    _, _, prompt, cache_len = SMALL_CONFIGS[name]
    jp = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(27)
    prompts = rng.integers(0, rcfg.vocab, (ROWS, prompt))
    frames = (rng.standard_normal((ROWS, rcfg.n_audio_ctx, rcfg.d_model)).astype(np.float32)
              if rcfg.enc_layers else None)
    logits, cache = R_PREFILL(jp, jax.numpy.asarray(prompts), rcfg, cache_len=cache_len,
                              audio_frames=None if frames is None else jax.numpy.asarray(frames))
    first = _flat(cache)
    toks = [np.asarray(jax.numpy.argmax(logits, -1))]
    for i in range(SMALL_STEPS):
        logits, cache = R_DECODE(jp, cache, jax.numpy.asarray(toks[-1]),
                                 jax.numpy.int32(prompt + i), rcfg)
        toks.append(np.asarray(jax.numpy.argmax(logits, -1)))
    return (jax.tree.map(np.asarray, jp), prompts, frames, np.concatenate(toks, axis=1),
            first, _flat(cache))


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def refs():
    return {name: _ref_run(name) for name in SMALL_CONFIGS}


_SPAWNS = {}


def _ranks(shape, refs):
    """The ranks' results on mesh `shape`: one spawn a mesh, kept for the
    module's tests."""
    if shape not in _SPAWNS:
        args = {name: r[:4] for name, r in refs.items()}
        _SPAWNS[shape] = tmesh.run_ranks(small_rank, shape[0] * shape[1], (shape, args),
                                         device="cpu", timeout=240)
    return _SPAWNS[shape]


def _local_cut(a, axes, rules, sizes, coord):
    """The block of the whole array `a` that the rank at `coord` holds under
    the JAX package's PartitionSpec of `axes`."""
    names = list(sizes)
    for d, entry in enumerate(rshd.spec_for(a.shape, axes, rules, FakeMesh(sizes))):
        if entry is None:
            continue
        idx, n = 0, 1
        for ax in ((entry,) if isinstance(entry, str) else entry):
            idx, n = idx * sizes[ax] + coord[names.index(ax)], n * sizes[ax]
        step = a.shape[d] // n
        a = np.take(a, range(idx * step, (idx + 1) * step), axis=d)
    return a


@pytest.mark.parametrize("name", list(SMALL_CONFIGS))
@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, s)) for s in MESHES])
def test_small_serve_matches_unsharded_and_reference(shape, name, refs):
    sizes = {"data": shape[0], "model": shape[1]}
    ranks = _ranks(shape, refs)
    rows = ROWS // shape[0]
    jp, prompts, frames, toks, ref_first, ref_last = refs[name]
    _, _, prompt, cache_len = SMALL_CONFIGS[name]
    cfg, rcfg = config(name), _ref_cfg(name)
    assert rshd._small_serve(rcfg) and steps.tp_serve_cfg(cfg, sizes) == cfg
    want, _, _ = small_run(from_reference(jp, cfg, "cpu"), torch.from_numpy(prompts),
                           torch.from_numpy(toks), steps.make_prefill(cfg),
                           steps.make_decode(cfg), prompt, cache_len,
                           None if frames is None else torch.from_numpy(frames))
    rules = rshd.serve_rules(FakeMesh(sizes), rcfg)
    assert rules["kv_heads"] is None and rules["seq"] == "model"
    want_params = _cut_shapes(rapi.param_specs(rcfg), rapi.param_axes(rcfg), rules, sizes)
    cspecs = rapi.cache_specs(rcfg, ROWS, cache_len)
    caxes = rapi.cache_axes(rcfg, ROWS, cache_len)
    want_cache = _cut_shapes(cspecs, caxes, rules, sizes)
    axes = dict(zip(_flat(cspecs), jax.tree.leaves(caxes, is_leaf=lambda x: isinstance(x, tuple))))
    ring = min(rcfg.sliding_window or cache_len, cache_len)
    n_attn = sum(m == "attn" for m, _ in cfg.layer_kinds()) + (cfg.n_layers if cfg.enc_layers
                                                               else 0)
    for r in ranks:
        got, coord = r[name], r["coord"]
        assert got["params"] == want_params, coord
        for key, ref_cache in (("first", ref_first), ("last", ref_last)):
            assert {k: v.shape for k, v in got[key].items()} == want_cache, (coord, key)
            for path, a in ref_cache.items():
                np.testing.assert_allclose(got[key][path],
                                           _local_cut(a, axes[path], rules, sizes, coord),
                                           **TOL, err_msg=f"{coord} {key} {path}")
        sl = slice(coord[0] * rows, (coord[0] + 1) * rows)
        np.testing.assert_allclose(got["logits"], want[:, sl], **TOL, err_msg=str(coord))
        np.testing.assert_array_equal(got["logits"].argmax(-1).T, toks[sl], err_msg=str(coord))
        # every attention layer of every step is one decode-attention call;
        # a cut cache takes the log-sum-exp, a whole one the plain call
        calls = got["calls"]
        assert calls["lse"] + calls["plain"] == n_attn * SMALL_STEPS, (coord, calls)
        assert calls["plain"] == (n_attn * SMALL_STEPS if ring % shape[1] else 0), coord
    if name == "tinyllama":
        # the last model rank's cut holds no valid key for the first steps
        last = next(r for r in ranks if r["coord"] == [0, shape[1] - 1])
        assert last[name]["calls"]["empty"] >= 4 * cfg.n_layers, last[name]["calls"]


@pytest.mark.parametrize("per_row", [True, False])
def test_attn_decode_over_cuts_equals_the_whole_ring(per_row, monkeypatch):
    """One decode attention layer over a 16-slot ring cut into 4 (in one
    process, no mesh): each cut writes the slot it holds (per row with
    pos_offset, rows 0 and 1 wrapped; or the shared slot) and leaves the
    others; the cuts' (o, lse), merged in rank order, give the whole
    ring's layer output within 1e-5; the cuts that hold no valid key of a
    row return lse -inf there."""
    from repro_torch.distributed import ctx as dctx
    from repro_torch.models import lm
    from repro_torch.models.params import init_params

    cfg = config("tinyllama")
    p = lm._layers(cfg, init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                                    "float32"))[0]["mixer"]
    b, ring, m, pos = 3, 16, 4, 20
    rng = np.random.default_rng(11)
    ck, cv = (torch.from_numpy(rng.standard_normal((b, ring, cfg.n_kv_heads, cfg.hd))
                               .astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32))
    off = torch.tensor([0, 2, 17]) if per_row else None
    qpos = pos - (off if per_row else torch.zeros(b, dtype=torch.int64))
    valid = torch.clamp(qpos + 1, 0, ring).to(torch.int32)
    wk, wv = ck.clone(), cv.clone()
    want = lm._attn_decode(x, p, cfg, wk, wv, pos, off, valid)
    n = ring // m
    parts = []
    monkeypatch.setattr(dctx, "merge_seq_shards", lambda o, lse: parts.append((o, lse)) or o)
    for r in range(m):
        sl = slice(r * n, (r + 1) * n)
        k_r, v_r = ck[:, sl].clone(), cv[:, sl].clone()
        lm._attn_decode(x, p, cfg, k_r, v_r, pos, off, valid, ring=ring, seq=(r * n, n))
        assert torch.equal(k_r, wk[:, sl]) and torch.equal(v_r, wv[:, sl]), r
    o = np.stack([o.numpy() for o, _ in parts])
    lse = np.stack([x.numpy() for _, x in parts])
    if per_row:
        assert np.isneginf(lse[1:, 2]).all()          # row 2 (qpos 3) lies in cut 0 alone
    w = np.exp(lse - lse.max(0))
    merged = torch.from_numpy((w[..., None] * o).sum(0) / w.sum(0)[..., None])
    monkeypatch.setattr(dctx, "merge_seq_shards", lambda o, lse: merged)
    got = lm._attn_decode(x, p, cfg, ck[:, :n].clone(), cv[:, :n].clone(), pos, off, valid,
                          ring=ring, seq=(0, n))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
