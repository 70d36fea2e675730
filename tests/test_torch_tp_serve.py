"""Tensor-parallel serving on gloo ranks on the CPU, against the unsharded
port and the JAX package.

Each mesh, (1, 2), (1, 4) and (2, 2) over ("data", "model"), is one spawn
of ranks (`launch.mesh.run_ranks`, with its own timeout: a rank that dies
or hangs fails the test, it does not hang it), run once and read by one
test a config. The spawn runs four reduced configs at fp32 with the JAX
package's seed-0 weights: tinyllama with its own heads (4 q, 2 KV) and
with the yi-like ratio (6 q, 2 KV, head size 16), h2o-danube (its 16-slot
window ring wraps during decode) and phi-3-vision (img_embeds replace the
first 8 prompt embeddings after the embedding's all-reduce). At tp 4 the
configs with 2 KV heads are head-padded (KV heads replicated to 4; the
yi-like one gets two zero q slots). Every rank cuts the full tree with
`steps.shard_params`, and again leaf by leaf from a stream of its leaves,
and runs `sharded_prefill` on its rows of 4 x 16 prompts, then 8
`sharded_decode` steps fed the reference's greedy tokens. Checked: the two
cuts agree bit for bit; each rank's weight and cache shards have the
global shape cut as the JAX package's PartitionSpec says; the logits equal
the unsharded port's within rtol = atol = 1e-5, and their greedy tokens
equal the JAX package's `lm.prefill`/`lm.decode`. Reduced configs are
under 1B parameters, which take the seq-sharded small-serve layout, so the
ranks force `sharding._small_serve` off: the head layout here is the one
every full-width dense config of 1B parameters or more gets. The (2, 2)
spawn also checks that DTensor cuts a dim over ('pod', 'data') major to
minor, as `sharding.local_shard` does, and builds `make_slice_mesh` over
the world. In process: every family's reduced config, whisper-base's and
the MoE, SSM and hybrid families' full configs pass the sharded steps with
the JAX package's layout (the small-serve layout is served on ranks in
tests/test_torch_small_serve.py, the MoE, SSM and hybrid families in
tests/test_torch_tp_families.py), and a layout the model's collectives
cannot close is refused by name.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs import serve_config as ref_serve_config  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.params import (cache_specs, from_reference, init_params,  # noqa: E402
                                       leaves, param_specs)
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch_tp_ranks import (CONFIGS, PROMPT, ROWS, STEPS, config, die_rank,  # noqa: E402
                            port_run, serve_rank)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = [(1, 2), (1, 4), (2, 2)]
R_PREFILL = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
R_DECODE = jax.jit(rlm.decode, static_argnums=(4,))


def _ref_cfg(name):
    arch, fields = CONFIGS[name]
    return dataclasses.replace(ref_reduced(arch), dtype="float32", **fields)


class FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _ref_run(name):
    """The JAX package's seed-0 weights (numpy), the prompts, the img_embeds
    (a vlm's, else None), and its prefill + greedy decode: tokens [ROWS, 1 +
    STEPS]."""
    rcfg = _ref_cfg(name)
    jp = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, rcfg.vocab, (ROWS, PROMPT))
    img = (rng.standard_normal((ROWS, rcfg.n_img_tokens, rcfg.d_model)).astype(np.float32)
           if rcfg.n_img_tokens else None)
    logits, cache = R_PREFILL(jp, jax.numpy.asarray(prompts), rcfg, cache_len=PROMPT + STEPS,
                              img_embeds=None if img is None else jax.numpy.asarray(img))
    toks = [np.asarray(jax.numpy.argmax(logits, -1))]
    for i in range(STEPS):
        logits, cache = R_DECODE(jp, cache, jax.numpy.asarray(toks[-1]),
                                 jax.numpy.int32(PROMPT + i), rcfg)
        toks.append(np.asarray(jax.numpy.argmax(logits, -1)))
    return jax.tree.map(np.asarray, jp), prompts, img, np.concatenate(toks, axis=1)


@pytest.fixture(scope="module")
def refs():
    return {name: _ref_run(name) for name in CONFIGS}


_SPAWNS = {}


def _ranks(shape, refs):
    """The ranks' results on mesh `shape`: one spawn a mesh, kept for the
    module's tests."""
    if shape not in _SPAWNS:
        _SPAWNS[shape] = tmesh.run_ranks(serve_rank, shape[0] * shape[1], (shape, refs),
                                         device="cpu", timeout=240)
    return _SPAWNS[shape]


def _cut_shapes(spec_tree, axes_tree, rules, sizes):
    """{path: local shape} of a JAX-package tree cut by its PartitionSpecs."""
    fake = FakeMesh(sizes)
    flat = jax.tree_util.tree_flatten_with_path(spec_tree)[0]
    axes = jax.tree.leaves(axes_tree, is_leaf=lambda x: isinstance(x, tuple))
    out = {}
    for (path, s), a in zip(flat, axes):
        spec = rshd.spec_for(s.shape, a, rules, fake)
        out[".".join(k.key for k in path)] = tuple(
            d // rshd._axis_size(fake, e) if e is not None else d for d, e in zip(s.shape, spec))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, s)) for s in MESHES])
def test_sharded_serve_matches_unsharded_and_reference(shape, name, refs, monkeypatch):
    sizes = {"data": shape[0], "model": shape[1]}
    monkeypatch.setattr(rshd, "_small_serve", lambda cfg: False)   # as the ranks do
    ranks = _ranks(shape, refs)
    assert [r["backend"] for r in ranks] == ["gloo"] * len(ranks)
    rows = ROWS // shape[0]
    jp, prompts, img, toks = refs[name]
    cfg, rcfg = config(name), _ref_cfg(name)
    want, _ = port_run(from_reference(jp, cfg, "cpu"), torch.from_numpy(prompts),
                       torch.from_numpy(toks), steps.make_prefill(cfg),
                       steps.make_decode(cfg), None if img is None else torch.from_numpy(img))
    # the shards' shapes, as the JAX package's serve specs cut them
    rscfg = ref_serve_config(rcfg, shape[1])
    rules = rshd.serve_rules(FakeMesh(sizes), rscfg)
    want_params = _cut_shapes(rapi.param_specs(rscfg), rapi.param_axes(rscfg), rules, sizes)
    want_cache = _cut_shapes(rapi.cache_specs(rscfg, ROWS, PROMPT + STEPS),
                             rapi.cache_axes(rscfg, ROWS, PROMPT + STEPS), rules, sizes)
    if shape[1] == 4 and rcfg.n_kv_heads == 2:
        assert rscfg.n_kv_heads == 4                                 # padded
    for r in ranks:
        got = r[name]
        assert got["streamed_equal"], r["coord"]
        assert got["params"] == want_params, r["coord"]
        assert got["cache"] == want_cache, r["coord"]
        sl = slice(r["coord"][0] * rows, (r["coord"][0] + 1) * rows)
        np.testing.assert_allclose(got["logits"], want[:, sl], **TOL, err_msg=str(r["coord"]))
        np.testing.assert_array_equal(got["logits"].argmax(-1).T, toks[sl],
                                      err_msg=str(r["coord"]))


def test_dtensor_order_and_slice_mesh(refs):
    """On the (2, 2) spawn: DTensor cuts a dim over ('pod', 'data') major to
    minor as sharding.local_shard does; make_slice_mesh spans the world."""
    ranks = _ranks((2, 2), refs)
    assert all(r["dtensor_order"] for r in ranks)
    assert ranks[0]["slice_mesh"] == (("data", "model"), (1, 4))


def test_run_ranks_fails_when_a_rank_dies():
    with pytest.raises(RuntimeError, match="died|rank"):
        tmesh.run_ranks(die_rank, 2, device="cpu", timeout=60)


def _port_cut_shapes(specs, placements, sizes):
    """{path: local shape} of a port tree cut by its placements."""
    out = {}
    for (path, s), (_, pl) in zip(leaves(specs), leaves(placements)):
        shape = list(s.shape)
        for size, p in zip(sizes.values(), pl):
            if isinstance(p, Shard):
                shape[p.dim] //= size
        out[path] = tuple(shape)
    return out


@pytest.mark.parametrize("arch,what", [
    ("mixtral-8x22b", "experts"), ("moonshot-v1-16b-a3b", "experts"),
    ("mamba2-370m", "SSM layers"), ("jamba-v0.1-52b", "experts"),
    ("whisper-base", "an encoder"), ("tinyllama-1.1b", "small-serve"),
    ("phi-3-vision-4.2b", "small-serve")])
def test_sharded_path_refuses_by_name(arch, what):
    """The sharded steps take every family: `tp_serve_cfg`,
    `sharded_prefill`, `sharded_decode` and `shard_params` accept each
    reduced config on (1, 2) with the layout the JAX package's serve rules
    give it, weights and caches leaf by leaf (the small-serve layout, whole
    attention weights and caches cut along their sequence, for every one
    but reduced mamba2, which the rule exempts in both packages), and the
    full configs too: the MoE, SSM and hybrid ones on (1, 2) and (2, 2),
    whisper-base on (1, 2), (1, 4) and (1, 8), whose 1,500-frame cross
    cache the last axis does not divide. What they refuse, by name, is a
    layout the model's collectives cannot close: a `model` axis of 3 cuts
    no MLP or SSM dim of these configs."""
    cfg, rcfg, sizes = reduced(arch), ref_reduced(arch), {"data": 1, "model": 2}
    assert rshd._small_serve(rcfg) == (what != "SSM layers")
    assert steps.tp_serve_cfg(cfg, sizes) == cfg                    # no head padding
    rules = rshd.serve_rules(FakeMesh(sizes), rcfg)
    assert _port_cut_shapes(param_specs(cfg, dtype=cfg.dtype),
                            steps.serve_param_shardings(cfg, sizes), sizes) == _cut_shapes(
        rapi.param_specs(rcfg), rapi.param_axes(rcfg), rules, sizes)
    assert _port_cut_shapes(cache_specs(cfg, ROWS, 32),
                            steps.serve_cache_shardings(cfg, sizes, ROWS, 32), sizes) == (
        _cut_shapes(rapi.cache_specs(rcfg, ROWS, 32), rapi.cache_axes(rcfg, ROWS, 32), rules,
                    sizes))
    steps.sharded_prefill(cfg, sizes)
    steps.sharded_decode(cfg, sizes, cache_len=32)
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu", "float32")
    local = steps.shard_params(full, cfg, sizes, coordinate=(0, 1))
    assert {k: tuple(v.shape) for k, v in leaves(local)} == _cut_shapes(
        rapi.param_specs(rcfg), rapi.param_axes(rcfg), rules, sizes)
    with pytest.raises(ValueError, match="cut over the model axis"):
        steps.tp_serve_cfg(cfg, {"data": 1, "model": 3})
    big = get_config(arch)
    if what == "an encoder":
        for tp in (2, 4, 8):
            assert steps.tp_serve_cfg(big, {"data": 1, "model": tp}) == big
            xattn = steps.serve_cache_shardings(big, {"data": 1, "model": tp}, 8, 64)
            assert xattn["body"]["l0"]["xattn"]["ck"][1] == (Replicate() if tp == 8
                                                              else Shard(2))
    else:
        assert steps.tp_serve_cfg(big, sizes).n_layers == big.n_layers
        assert steps.tp_serve_cfg(big, {"data": 2, "model": 2}).n_experts == big.n_experts


def test_meshes_in_one_process():
    """The production meshes name the ranks they need; the local mesh is a
    world of one on an in-memory store, with the production axis names."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()
    try:
        m = tmesh.make_local_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
        assert tmesh.backend_for("cpu", 1) == "gloo"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("flag,ranks", [("--production-mesh", 256), ("--multi-pod", 512)])
def test_train_launcher_mesh_flags(flag, ranks, capsys, monkeypatch):
    """The launcher's mesh flags build the production mesh, which names the
    ranks it needs; given a mesh, the launcher trains on it (the train
    loop gets the mesh)."""
    from repro_torch.launch import train as launch
    from repro_torch.training import train_loop

    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu", "--steps", "1", flag]
    with pytest.raises(SystemExit):
        launch.main(argv)
    assert f"needs {ranks} ranks" in capsys.readouterr().err
    built, trained = [], []
    monkeypatch.setattr(tmesh, "make_production_mesh",
                        lambda **kw: built.append(kw) or "the mesh")
    monkeypatch.setattr(train_loop, "train", lambda *a, **kw: trained.append(kw["mesh"])
                        or {"steps": 1, "losses": [1.0]})
    launch.main(argv)
    assert built == [{"multi_pod": flag == "--multi-pod", "device": "cpu"}]
    assert trained == ["the mesh"]
