"""The PyTorch package's MoE family against the JAX package's, on the CPU:
the configs and weight trees of the five archs this family and the rest of
the dense family add (h2o-danube-1.8b, granite-3-8b, yi-34b, mixtral-8x22b,
moonshot-v1-16b-a3b), the router (ties included), the capacity dispatch
mask, GShard's grouped einsum dispatch with dropped tokens, the sort-based
dispatch, the shared experts, prefill and decode of mixtral (window 16, 4
experts top 2) and moonshot (a dense first layer, 4 experts top 2, 2 shared
experts), the engine in both modes, a fleet with an MoE tenant beside a
dense one, the MoE join contract, and the launcher.

Reduced configs (4 layers, d_model 128, head dim 32, group 64) at an fp32
override; the JAX package's seed-0 weights carried across with
models.params.from_reference; inputs from a numpy seed. Layer outputs and
logits are held by allclose at rtol = atol = 1e-5, gate indices, dispatch
masks and greedy tokens by equality.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import multislice as rms  # noqa: E402
from repro_torch.configs import SERVED_ARCHS, get_config, reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import LM  # noqa: E402
from repro_torch.models.params import from_reference, init_params, leaves  # noqa: E402
from repro_torch.serving.engine import EngineConfig, build_engine  # noqa: E402
from repro_torch.serving.multislice import TenantSpec, build_multislice_engine  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NEW_ARCHS = ["h2o-danube-1.8b", "granite-3-8b", "yi-34b", "mixtral-8x22b",
             "moonshot-v1-16b-a3b"]
MOE_ARCHS = ["mixtral-8x22b", "moonshot-v1-16b-a3b"]
R_PREFILL = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
R_DECODE = jax.jit(rlm.decode, static_argnums=(4,))
R_EINSUM = jax.jit(RL.moe_gshard_einsum, static_argnums=(2,))
R_SORT = jax.jit(RL.moe_sort, static_argnums=(2,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


_SETUPS = {}


def _setup(arch):
    """Both packages' reduced fp32 configs and the JAX package's seed-0
    weights, carried across (built once a module)."""
    if arch not in _SETUPS:
        rcfg = dataclasses.replace(ref_reduced(arch), dtype="float32")
        cfg = dataclasses.replace(reduced(arch), dtype="float32")
        jp = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
        pt = from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu", "float32")
        _SETUPS[arch] = dict(rcfg=rcfg, cfg=cfg, jp=jp, pt=pt)
    return _SETUPS[arch]


def _moe_layer(arch, **kw):
    """(port cfg, ref cfg, port layer-0 MoE params, ref ones) with overrides."""
    s = _setup(arch)
    cfg, rcfg = dataclasses.replace(s["cfg"], **kw), dataclasses.replace(s["rcfg"], **kw)
    jffn = jax.tree.map(lambda a: a[0], s["jp"]["body"]["l0"]["ffn"])
    pffn = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jffn)
    return cfg, rcfg, pffn, jffn


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- configs and weights -----------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_tree_and_counts_match_reference(arch):
    """Every field of the full and the reduced config equals the JAX
    package's; the weight tree carries across leaf for leaf (the same
    paths and shapes, the values unchanged); the parameter counts, all and
    active, are count_params_analytical's."""
    assert arch in SERVED_ARCHS
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced(arch), ref_reduced(arch))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), (arch, f.name)
        assert mine.param_count() == rapi.count_params_analytical(ref)
        assert mine.active_param_count() == rapi.count_params_analytical(ref, active_only=True)
        assert mine.is_subquadratic() == ref.is_subquadratic()
        assert mine.layer_kinds() == ref.layer_kinds()
    s = _setup(arch)
    want = dict(leaves(jax.tree.map(np.asarray, s["jp"])))
    got = dict(leaves(s["pt"]))
    assert got.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(_np(got[path]), a)
    seeded = dict(leaves(init_params(s["cfg"], torch.Generator().manual_seed(0), "cpu")))
    assert {p: tuple(t.shape) for p, t in seeded.items()} == \
        {p: a.shape for p, a in want.items()}


def test_unserved_families_still_raise_and_name_themselves():
    """Every family of the JAX package has layer kinds now (the name is kept
    from when the hybrid, audio and vlm families raised); a family that
    exists in neither package still raises and names itself, and whisper,
    whose prefill needs audio frames, is the one arch the engine does not
    serve."""
    for arch in ("jamba-v0.1-52b", "whisper-base", "phi-3-vision-4.2b"):
        assert get_config(arch).layer_kinds() == ref_get_config(arch).layer_kinds()
        assert (arch in SERVED_ARCHS) == (arch != "whisper-base")
    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), family="retnet")
    with pytest.raises(NotImplementedError, match="'retnet'"):
        cfg.layer_kinds()


# --- the router and the dispatch ---------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_router_matches_reference(ties):
    """fp32 logits, softmax, top-k, renormalised, and the Switch aux loss.
    With ties (router columns 1 and 2 equal; zero tokens, whose four
    probabilities are equal) the lower expert index comes first, as in
    jax's top_k."""
    _, _, pffn, _ = _moe_layer("mixtral-8x22b")
    w = _np(pffn["router"]).copy()
    x = _x((48, w.shape[0]), 1)
    if ties:
        w[:, 2] = w[:, 1]
        x[:8] = 0.0  # all-zero tokens: every probability equal
    got = L._router(_t(x), {"router": _t(w)}, 4, 2)
    want = RL._router(jnp.asarray(x), {"router": jnp.asarray(w)}, 4, 2)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    for g, r in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert_allclose(_np(g), np.asarray(r), **TOL)
    if ties:
        assert (_np(got[1])[:8] == [0, 1]).all()


@pytest.mark.parametrize("C", [2, 3, 16])
def test_dispatch_mask_matches_reference(C):
    """Capacity slots over [K, t]: every first choice before any second
    one, tokens in order; choices past C dropped. C = 2 and 3 drop, 16
    (every choice of a group's 16 tokens) keeps all."""
    rng = np.random.default_rng(C)
    idx = np.stack([rng.permutation(4)[:2] for _ in range(2 * 16)]).reshape(2, 16, 2)
    vals = rng.random((2, 16, 2)).astype(np.float32)
    d, w = L._dispatch_mask(_t(idx), _t(vals), 4, C, torch.float32)
    rd, rw = RL._dispatch_mask(jnp.asarray(idx), jnp.asarray(vals), 4, C, jnp.float32)
    np.testing.assert_array_equal(_np(d), np.asarray(rd))
    assert_allclose(_np(w), np.asarray(rw), **TOL)
    kept = _np(d).sum((2, 3))
    assert (kept <= 2).all() and (kept.sum() < 2 * 16 * 2) == (C < 16)


@pytest.mark.parametrize("cf,group", [(8.0, 32), (0.01, 32), (1.25, 64), (0.5, 16)],
                         ids=["no-drop", "most-drop", "default", "some-drop"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gshard_einsum_matches_reference(arch, cf, group):
    """Groups of min(group, T), capacity max(4, ceil(cf * group * K / E)),
    choices past it dropped to the residual: y and the aux loss."""
    cfg, rcfg, pffn, jffn = _moe_layer(arch, capacity_factor=cf, moe_group_size=group)
    x = _x((2, 32, cfg.d_model), 2)
    y, aux = L.moe_gshard_einsum(_t(x), pffn, cfg)
    ry, raux = R_EINSUM(jnp.asarray(x), jffn, rcfg)
    assert_allclose(_np(y), np.asarray(ry), **TOL)
    assert_allclose(float(aux), float(raux), **TOL)


def test_moe_drops_tokens_at_small_capacity():
    """capacity_factor 0.01 (C = 4 of 64 choices an expert): the output is
    smaller than at a capacity where nothing drops (the reference's own
    check, tests/test_moe.py)."""
    cfg, _, pffn, _ = _moe_layer("mixtral-8x22b", capacity_factor=0.01, moe_group_size=32)
    x = _t(_x((2, 32, cfg.d_model), 1))
    y, _ = L.moe_gshard_einsum(x, pffn, cfg)
    y2, _ = L.moe_gshard_einsum(x, pffn, dataclasses.replace(cfg, capacity_factor=8.0))
    assert float(y.norm()) < float(y2.norm())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sort_matches_reference_and_einsum_without_drops(arch):
    cfg, rcfg, pffn, jffn = _moe_layer(arch, capacity_factor=8.0, moe_group_size=64,
                                       moe_impl="sort")
    x = _x((2, 32, cfg.d_model), 3)
    y, aux = L.moe_sort(_t(x), pffn, cfg)
    ry, raux = R_SORT(jnp.asarray(x), jffn, rcfg)
    assert_allclose(_np(y), np.asarray(ry), **TOL)
    assert_allclose(float(aux), float(raux), **TOL)
    ye, auxe = L.moe_gshard_einsum(_t(x), pffn, cfg)
    assert_allclose(_np(y), _np(ye), rtol=2e-4, atol=2e-4)
    assert_allclose(float(aux), float(auxe), **TOL)


def test_moe_sort_with_drops_on_the_last_expert_matches_reference():
    """Capacity 4 of 64 tokens x 2 choices: the last expert overflows, so
    dropped choices write zeros to the buffer slot a kept choice of that
    expert holds (the JAX package's double write). The port lets the last
    write in sorted order win, as the reference does on XLA CPU: the two
    agree, and that kept choice contributes nothing."""
    cfg, rcfg, pffn, jffn = _moe_layer("mixtral-8x22b", capacity_factor=0.01,
                                       moe_impl="sort")
    x = _x((2, 32, cfg.d_model), 4)
    _, idx, _, _ = L._router(_t(x).reshape(64, -1), pffn, 4, 2)
    assert int((idx == 3).sum()) > 4  # the last expert overflows its 4 slots
    y, _ = L.moe_sort(_t(x), pffn, cfg)
    ry, _ = R_SORT(jnp.asarray(x), jffn, rcfg)
    assert_allclose(_np(y), np.asarray(ry), **TOL)


def test_moe_group_must_divide_the_tokens_in_both_packages():
    """96 tokens in groups of 64: the JAX package asserts, the port raises
    (a 3-row, 32-token prefill bucket of the reduced model). The engine
    builds such a bucket with pad_buckets=False (ROADMAP Queue 3)."""
    cfg, rcfg, pffn, jffn = _moe_layer("mixtral-8x22b")
    x = _x((3, 32, cfg.d_model), 5)
    with pytest.raises(ValueError, match="not a multiple of the MoE group"):
        L.moe_gshard_einsum(_t(x), pffn, cfg)
    with pytest.raises(AssertionError):
        RL.moe_gshard_einsum(jnp.asarray(x), jffn, rcfg)
    # the run-to-completion engine without bucket padding batches prompts of
    # 30, 20 and 25 tokens as one 3 x 30 prefill: 90 tokens, in both packages
    s = _setup("mixtral-8x22b")
    ec = dict(continuous=False, pad_buckets=False, fused_decode=False, max_new_tokens=4,
              max_prompt_len=32)
    lens = (30, 20, 25)
    reng = rengine.build_engine(s["rcfg"], ec=rengine.EngineConfig(**ec))
    reng.params = s["jp"]
    reng.submit_many([RRequest(rid=i, arrival=0.0, length=float(n)) for i, n in enumerate(lens)])
    with pytest.raises(AssertionError):
        reng.run_until_idle()
    eng = build_engine(s["cfg"], ec=EngineConfig(**ec), device="cpu", params=s["pt"])
    eng.submit_many([Request(rid=i, arrival=0.0, length=float(n)) for i, n in enumerate(lens)])
    with pytest.raises(ValueError, match="not a multiple of the MoE group"):
        eng.run_until_idle()


def test_moe_with_shared_experts_matches_reference():
    cfg, rcfg, pffn, jffn = _moe_layer("moonshot-v1-16b-a3b")
    assert "shared" in pffn
    x = _x((2, 32, cfg.d_model), 6)
    y, aux = L.moe(_t(x), pffn, cfg)
    ry, raux = RL.moe(jnp.asarray(x), jffn, rcfg)
    assert_allclose(_np(y), np.asarray(ry), **TOL)
    assert_allclose(float(aux), float(raux), **TOL)


# --- the model -----------------------------------------------------------------


def _prompts(cfg, lens, lp, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), lp), np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = rng.integers(0, cfg.vocab, n)
    return toks, np.array([lp - n for n in lens], np.int64)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A left-padded 4 x 16 bucket (MoE groups of 64 tokens), then 10 decode
    steps of the whole batch (group 4: no drop), each against lm.prefill /
    lm.decode: logits allclose every step, greedy tokens equal. Mixtral's
    16-slot window ring wraps at step 6; the cache leaves are compared
    too."""
    s = _setup(arch)
    cfg, rcfg = s["cfg"], s["rcfg"]
    toks, off = _prompts(cfg, [16, 9, 13, 5], 16, seed=7)
    logits, cache = lm.prefill(s["pt"], _t(toks), cfg, pos_offset=_t(off), cache_len=32)
    rlogits, rcache = R_PREFILL(s["jp"], jnp.asarray(toks), rcfg, pos_offset=jnp.asarray(off),
                                cache_len=32)
    assert_allclose(_np(logits), np.asarray(rlogits), **TOL)
    for path, a in leaves(jax.tree.map(np.asarray, rcache)):
        got = dict(leaves(cache))[path]
        assert_allclose(_np(got), a, **TOL)
    tok, rtok = torch.argmax(logits, -1), jnp.argmax(rlogits, -1)
    for i in range(10):
        logits, cache = lm.decode(s["pt"], cache, tok, 16 + i, cfg, pos_offset=_t(off))
        rlogits, rcache = R_DECODE(s["jp"], rcache, rtok, jnp.int32(16 + i), rcfg,
                                   pos_offset=jnp.asarray(off))
        assert_allclose(_np(logits), np.asarray(rlogits), **TOL)
        tok, rtok = torch.argmax(logits, -1), jnp.argmax(rlogits, -1)
        np.testing.assert_array_equal(_np(tok), np.asarray(rtok))


def test_mixtral_decode_matches_forward():
    """The reference's teacher-forcing check (tests/test_archs_smoke.py):
    prefill 31 tokens (an unpadded prompt longer than the 16-slot window:
    the ring keeps the last 16 at slots pos % 16), decode token 31, and
    hold its logits to the full 32-token forward's last position, in the
    port and against the JAX package's decode."""
    s = _setup("mixtral-8x22b")
    cfg, rcfg = s["cfg"], s["rcfg"]
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, 32))
    full, _ = lm.prefill(s["pt"], _t(tokens), cfg)
    _, cache = lm.prefill(s["pt"], _t(tokens[:, :31]), cfg)
    assert cache["body"]["l0"]["mixer"]["k"].shape[2] == cfg.sliding_window
    dec, _ = lm.decode(s["pt"], cache, _t(tokens[:, 31:]), 31, cfg)
    assert_allclose(_np(dec), _np(full), rtol=3e-2, atol=3e-2)
    _, rcache = R_PREFILL(s["jp"], jnp.asarray(tokens[:, :31]), rcfg)
    rdec, _ = R_DECODE(s["jp"], rcache, jnp.asarray(tokens[:, 31:]), jnp.int32(31), rcfg)
    assert_allclose(_np(dec), np.asarray(rdec), **TOL)


# --- engines -------------------------------------------------------------------

# prompt lengths within the reduced window (16) and budgets; bucket 16
SPEC = [(6, 6), (11, 4), (9, 5), (16, 7), (3, 3), (13, 8)]
BASE = dict(max_new_tokens=8, max_slots=4, segment_len=4, max_prompt_len=16)


def _wave(cls, rid0=0, model=None):
    return [cls(rid=rid0 + i, arrival=0.0, length=float(n), max_new_tokens=b, model=model)
            for i, (n, b) in enumerate(SPEC)]


def _serve(engine, reqs):
    engine.submit_many(reqs)
    return {r.rid: np.asarray(r.payload) for r in engine.run_until_idle()}


@pytest.mark.parametrize("mode", [
    dict(continuous=True),
    dict(continuous=True, chunk_lens=(4,), prefix_cache_bytes=1 << 20),
    dict(continuous=False),
], ids=["continuous", "chunk-lens-fall-back", "run-to-completion"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_tokens_equal_reference_engine(arch, mode):
    """Per rid, the port's engine == the JAX package's. With chunk_lens set
    an MoE model admits monolithically in both packages (chunking would
    change which tokens drop), and no prefix store is built."""
    s = _setup(arch)
    ec = dict(BASE, **mode)
    reng = rengine.build_engine(s["rcfg"], ec=rengine.EngineConfig(**ec))
    reng.params = s["jp"]
    eng = build_engine(s["cfg"], ec=EngineConfig(**ec), device="cpu", params=s["pt"])
    want, got = _serve(reng, _wave(RRequest)), _serve(eng, _wave(Request))
    assert got.keys() == want.keys() and len(got) == len(SPEC)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)
    if mode.get("continuous"):
        assert eng._chunk_lens == reng._chunk_lens == ()
        assert eng.prefix_store is None and reng.prefix_store is None


def test_fleet_with_an_moe_tenant_beside_a_dense_one_equals_the_reference():
    """Reduced tinyllama and reduced moonshot (its dense first layer under
    `prefix`, its pools with a prefix entry) as two tenants, 2 slices each,
    one admission queue: per rid the tokens equal the JAX package's
    two-tenant fleet's, and no request touched a foreign slice."""
    dense = "tinyllama-1.1b"
    ds, ms_ = _setup(dense), _setup("moonshot-v1-16b-a3b")
    names = (dense, "moonshot-v1-16b-a3b")
    rcfgs, cfgs = (ds["rcfg"], ms_["rcfg"]), (ds["cfg"], ms_["cfg"])
    jps, pts = (ds["jp"], ms_["jp"]), (LM(ds["cfg"], ds["pt"]), LM(ms_["cfg"], ms_["pt"]))
    ec = dict(BASE)
    rfleet = rms.build_multislice_engine(
        n_slices=4, ec=rengine.EngineConfig(**ec),
        tenants=[rms.TenantSpec(cfg=c, name=n, n_slices=2, params=p)
                 for c, n, p in zip(rcfgs, names, jps)])
    rfleet.submit_many(_wave(RRequest, 100, dense) + _wave(RRequest, 200, names[1]))
    want = {r.rid: np.asarray(r.payload) for r in rfleet.run_until_idle()}
    fleet = build_multislice_engine(
        n_slices=4, ec=EngineConfig(**ec), device="cpu",
        tenants=[TenantSpec(cfg=c, name=n, n_slices=2, params=p)
                 for c, n, p in zip(cfgs, names, pts)])
    assert fleet.slice_tenant == rfleet.slice_tenant
    got = _serve(fleet, _wave(Request, 100, dense) + _wave(Request, 200, names[1]))
    assert got.keys() == want.keys() and len(got) == 2 * len(SPEC)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)
    ts = fleet.tenant_stats()
    for n in names:
        assert ts[n]["completed"] == len(SPEC) and ts[n]["dead"] == 0
        assert set(ts[n]["routed_to"]) <= set(fleet.slices_of(n))
    for sid in fleet.slices_of(names[1]):
        assert "prefix" in fleet.engines[sid]._pool


# --- the MoE join contract -------------------------------------------------------


def _join_run(pkg, p, cfg, join: bool):
    """Request B (11 tokens) admitted into slot 7 of an 8-slot pool at clock
    19, then 6 decode steps and the logits of one more; with `join`, slots
    0-6 hold seven requests admitted at clock 16 and three steps in.
    Returns (B's 7 tokens, B's next logits). pkg is the port's lm module or
    the JAX package's."""
    port = pkg is lm
    arr = _t if port else jnp.asarray
    pool = (lm.alloc_slot_pool(cfg, 8, 48, torch.device("cpu")) if port
            else rlm.alloc_slot_pool(cfg, 8, 48))
    off = np.zeros(8, np.int64)
    tok = np.zeros((8, 1), np.int64)
    if join:
        ta, oa = _prompts(cfg, [16, 9, 13, 5, 12, 7, 15], 16, seed=10)
        t0, pool = pkg.prefill_into_slots(p, arr(np.concatenate([ta, ta[:1]])), pool,
                                          arr(np.array([0, 1, 2, 3, 4, 5, 6, 8])), 16, cfg,
                                          pos_offset=arr(np.concatenate([oa, oa[:1]])))
        off[:7] = oa  # clock 16 - true length
        seg, pool = pkg.decode_segment(p, pool, arr(np.asarray(t0)), 16, cfg, steps=3,
                                       pos_offset=arr(off))
        tok[:7] = np.asarray(seg)[:7, -1:]
    tb, ob = _prompts(cfg, [11], 16, seed=11)
    blk = np.zeros((8, 16), np.int64)
    blk[0] = tb[0]
    boff = np.full(8, 16, np.int64)
    boff[0] = ob[0]
    t0b, pool = pkg.prefill_into_slots(p, arr(blk), pool, arr(np.array([7] + [8] * 7)), 19,
                                       cfg, pos_offset=arr(boff))
    off[7] = 19 - 11
    tok[7] = np.asarray(t0b)[0]
    rest, pool = pkg.decode_segment(p, pool, arr(tok), 19, cfg, steps=6, pos_offset=arr(off))
    logits, _ = pkg.decode(p, pool, arr(np.asarray(rest)[:, -1:]), 25, cfg,
                           pos_offset=arr(off))
    return (np.concatenate([np.asarray(t0b)[0], np.asarray(rest)[7]]),
            np.asarray(logits)[7, 0])


def test_moe_join_contract_is_the_reference_contract():
    """A token's expert capacity depends on the other rows of its decode
    group (8 tokens, capacity 5 an expert: here B loses choices in some
    layer-steps, other ones alone than joined). Run first on
    the JAX package, then on the port: in each setting both give B the same
    tokens and logits (allclose). Pinned as the reference has it: join ==
    alone holds on B's greedy tokens, not on its logits."""
    s = _setup("mixtral-8x22b")
    ref = {j: _join_run(rlm, s["jp"], s["rcfg"], j) for j in (False, True)}
    port = {j: _join_run(lm, s["pt"], s["cfg"], j) for j in (False, True)}
    for j in (False, True):
        np.testing.assert_array_equal(port[j][0], ref[j][0])
        assert_allclose(port[j][1], ref[j][1], **TOL)
    assert np.array_equal(ref[True][0], ref[False][0]) == JOIN_TOKENS_EQUAL
    assert np.allclose(ref[True][1], ref[False][1], **TOL) == JOIN_LOGITS_EQUAL


JOIN_TOKENS_EQUAL, JOIN_LOGITS_EQUAL = True, False


# --- entry points ----------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--arch", "mixtral-8x22b", "--continuous"],
    ["--arch", "moonshot-v1-16b-a3b"],
    ["--tenants", "tinyllama-1.1b:1,moonshot-v1-16b-a3b:1", "--pipelined", "--preprocess",
     "dpu", "--clock", "virtual"],
], ids=["mixtral-continuous", "moonshot-run-to-completion", "tenants-pipelined-dpu"])
def test_serve_launcher_serves_the_moe_family_on_the_cpu(flags, capsys):
    from repro_torch.launch.serve import main

    main([*flags, "--reduced", "--device", "cpu", "--requests", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
