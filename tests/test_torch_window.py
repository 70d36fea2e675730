"""The rest of the dense family against the JAX package, on the CPU:
h2o-danube-1.8b's sliding window (4,096, reduced to 16) and the plain
llama-style granite-3-8b and yi-34b.

The window ring: the ring is min(window, cache_len) slots, and slot t of a
row at true position qpos holds the most recent write at or below qpos
congruent to t. The JAX package's decode keeps the slots whose position is
not negative, with no window mask; the port's decode hands the flash-decode
kernel (here its plain version) valid_len = min(qpos + 1, ring). These
tests hold the two together where the ring wraps: decode steps well past
the window, per row and per layer, an unpadded prefill longer than the
window (keys at slots pos % ring), the slot pool and the engine. Then the
attention paths a long prefill takes: blockwise online softmax, banded
sliding-window attention, and the dispatcher that picks one by shape. Last,
granite and yi through both engine modes, and the three through the
launcher.

Reduced configs at an fp32 override, the JAX package's seed-0 weights
carried across with models.params.from_reference, inputs from a numpy
seed. Logits and layer outputs allclose at rtol = atol = 1e-5; greedy
tokens equal.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import from_reference, leaves  # noqa: E402
from repro_torch.serving.engine import EngineConfig, build_engine  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
DANUBE = "h2o-danube-1.8b"
DENSE = [DANUBE, "granite-3-8b", "yi-34b"]
R_PREFILL = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
R_DECODE = jax.jit(rlm.decode, static_argnums=(4,))
R_ATTN_DECODE = jax.jit(rlm._attn_decode, static_argnums=(2,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        rcfg = dataclasses.replace(ref_reduced(arch), dtype="float32")
        cfg = dataclasses.replace(reduced(arch), dtype="float32")
        jp = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
        pt = from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu", "float32")
        _SETUPS[arch] = dict(rcfg=rcfg, cfg=cfg, jp=jp, pt=pt)
    return _SETUPS[arch]


def _prompts(cfg, lens, lp, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), lp), np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = rng.integers(0, cfg.vocab, n)
    return toks, np.array([lp - n for n in lens], np.int64)


# --- the models: prefill and decode against the JAX package ---------------------


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded-32", "padded-16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, padded):
    """A batch of 2 prompts, then 24 decode steps: logits allclose each
    step, greedy tokens equal, and the prefill cache allclose leaf for leaf.
    Unpadded: 32-token prompts into a cache of 40, so danube's 16-slot ring
    keeps the last 16 keys at slots pos % 16 (banded attention in the
    prefill: 32 = 2 windows). Padded: a left-padded 16-token bucket (the
    window holds it) with per-row offsets; the ring wraps at decode step
    1 and again at 17."""
    s = _setup(arch)
    cfg, rcfg = s["cfg"], s["rcfg"]
    if padded:
        toks, off = _prompts(cfg, [16, 7], 16, seed=1)
        kw, rkw = dict(pos_offset=_t(off)), dict(pos_offset=jnp.asarray(off))
    else:
        toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 32))
        kw, rkw = {}, {}
    S = toks.shape[1]
    logits, cache = lm.prefill(s["pt"], _t(toks), cfg, cache_len=40, **kw)
    rlogits, rcache = R_PREFILL(s["jp"], jnp.asarray(toks), rcfg, cache_len=40, **rkw)
    assert_allclose(_np(logits), np.asarray(rlogits), **TOL)
    mine = dict(leaves(cache))
    for path, a in leaves(jax.tree.map(np.asarray, rcache)):
        assert_allclose(_np(mine[path]), a, **TOL)
    tok, rtok = torch.argmax(logits, -1), jnp.argmax(rlogits, -1)
    for i in range(24):
        logits, cache = lm.decode(s["pt"], cache, tok, S + i, cfg, **kw)
        rlogits, rcache = R_DECODE(s["jp"], rcache, rtok, jnp.int32(S + i), rcfg, **rkw)
        assert_allclose(_np(logits), np.asarray(rlogits), **TOL)
        tok, rtok = torch.argmax(logits, -1), jnp.argmax(rlogits, -1)
        np.testing.assert_array_equal(_np(tok), np.asarray(rtok))


def test_danube_decode_matches_forward():
    """The reference's teacher-forcing check (tests/test_archs_smoke.py):
    prefill 31 tokens, decode token 31 over the wrapped 16-slot ring, and
    hold its logits to the full 32-token forward's last position (3e-2, the
    reference's tolerance), and to the JAX package's decode (1e-5)."""
    s = _setup(DANUBE)
    cfg, rcfg = s["cfg"], s["rcfg"]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32))
    full, _ = lm.prefill(s["pt"], _t(tokens), cfg)
    _, cache = lm.prefill(s["pt"], _t(tokens[:, :31]), cfg)
    dec, _ = lm.decode(s["pt"], cache, _t(tokens[:, 31:]), 31, cfg)
    assert_allclose(_np(dec), _np(full), rtol=3e-2, atol=3e-2)
    _, rcache = R_PREFILL(s["jp"], jnp.asarray(tokens[:, :31]), rcfg)
    rdec, _ = R_DECODE(s["jp"], rcache, jnp.asarray(tokens[:, 31:]), jnp.int32(31), rcfg)
    assert_allclose(_np(dec), np.asarray(rdec), **TOL)


def test_window_prefill_with_offsets_past_the_ring_raises_in_both_packages():
    """A left-padded bucket longer than the window ring: the JAX package
    refuses pos_offset there, and so does the port (the slot pool's ring
    must hold the padded prompt)."""
    s = _setup(DANUBE)
    toks, off = _prompts(s["cfg"], [20, 9], 32, seed=4)
    with pytest.raises(ValueError, match="sliding-window ring"):
        lm.prefill(s["pt"], _t(toks), s["cfg"], pos_offset=_t(off), cache_len=40)
    with pytest.raises(ValueError, match="sliding-window ring"):
        rlm.prefill(s["jp"], jnp.asarray(toks), s["rcfg"], pos_offset=jnp.asarray(off),
                    cache_len=40)


# --- the ring: the prefix rule at the layer --------------------------------------


@pytest.mark.parametrize("qpos", [[3, 15], [16, 40], [17, 100], [15, 31]])
def test_attn_decode_over_a_window_ring_matches_reference(qpos):
    """One attention layer's decode step over a 16-slot ring filled with
    noise, rows at true positions qpos (before the ring is full, just full,
    and wrapped many times): the port (the kernel's plain version, valid_len
    = min(qpos + 1, ring)) against the JAX package's _attn_decode (slot
    positions qpos - (qpos - t) mod ring, no window mask): the output and
    the written slot."""
    s = _setup(DANUBE)
    cfg, rcfg = s["cfg"], s["rcfg"]
    p = {k: v[0] for k, v in s["pt"]["body"]["l0"]["mixer"].items()}
    jp = jax.tree.map(lambda a: a[0], s["jp"]["body"]["l0"]["mixer"])
    rng = np.random.default_rng(sum(qpos))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ring = rng.standard_normal((2, 2, 16, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    pos = 200
    off = pos - np.array(qpos)
    ck, cv = _t(ring[0]), _t(ring[1])
    valid_len = torch.clamp(_t(np.array(qpos)) + 1, 0, 16).to(torch.int32)
    out = lm._attn_decode(_t(x), p, cfg, ck, cv, pos, _t(off), valid_len)
    rout, rc = R_ATTN_DECODE(jnp.asarray(x), jp, rcfg,
                             {"k": jnp.asarray(ring[0]), "v": jnp.asarray(ring[1])},
                             jnp.int32(pos), jnp.asarray(off))
    assert_allclose(_np(out), np.asarray(rout), **TOL)
    assert_allclose(_np(ck), np.asarray(rc["k"]), **TOL)
    assert_allclose(_np(cv), np.asarray(rc["v"]), **TOL)


def test_prefix_rule_equals_the_window_mask_over_true_positions():
    """The kernel's plain version with valid_len = min(qpos + 1, ring) over
    a ring written in position order == dense attention over the same slots
    with each slot's true position and the window mask q - k < window,
    before and after the ring wraps."""
    W = 16
    rng = np.random.default_rng(5)
    for qpos in (0, 5, 15, 16, 30, 47, 300):
        q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((1, W, 2, 32)).astype(np.float32))
                for _ in range(2))
        t = torch.arange(W)
        kpos = qpos - torch.remainder(qpos - t, W)  # each slot's latest position
        got = kd.decode_attention_plain(q, k, v, torch.tensor([min(qpos + 1, W)],
                                                              dtype=torch.int32))
        want = L.attention_dense(q[:, None], k, v, torch.tensor([qpos]),
                                 torch.where(kpos >= 0, kpos, torch.full_like(kpos, -1)),
                                 causal=True, window=W)[:, 0]
        assert_allclose(_np(got), _np(want), **TOL)


# --- the slot pool and the engine ------------------------------------------------


def test_slot_pool_decode_wraps_the_window_ring_as_the_reference():
    """prefill_into_slots + decode_segment over a 4-slot pool whose ring is
    the 16-slot window (cache_len 48): 30 steps, so every row wraps; tokens
    equal the JAX package's."""
    s = _setup(DANUBE)
    cfg, rcfg = s["cfg"], s["rcfg"]
    toks, off = _prompts(cfg, [16, 9, 13, 3], 16, seed=6)
    slots = np.array([2, 0, 3, 1], np.int64)
    pool = lm.alloc_slot_pool(cfg, 4, 48, torch.device("cpu"))
    assert pool["body"]["l0"]["mixer"]["k"].shape[2] == 16
    t0, pool = lm.prefill_into_slots(s["pt"], _t(toks), pool, _t(slots), 16, cfg,
                                     pos_offset=_t(off))
    poff = np.zeros(4, np.int64)
    poff[slots] = off
    tok = np.zeros((4, 1), np.int64)
    tok[slots] = _np(t0)
    got, _ = lm.decode_segment(s["pt"], pool, _t(tok), 16, cfg, steps=30, pos_offset=_t(poff))
    rpool = rlm.alloc_slot_pool(rcfg, 4, 48)
    rt0, rpool = rlm.prefill_into_slots(s["jp"], jnp.asarray(toks), rpool,
                                        jnp.asarray(slots), 16, rcfg,
                                        pos_offset=jnp.asarray(off))
    np.testing.assert_array_equal(_np(t0), np.asarray(rt0))
    want, _ = rlm.decode_segment(s["jp"], rpool, jnp.asarray(tok), 16, rcfg, steps=30,
                                 pos_offset=jnp.asarray(poff))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_slot_pool_refuses_a_bucket_its_window_ring_cannot_hold():
    s = _setup(DANUBE)
    cfg = s["cfg"]
    pool = lm.alloc_slot_pool(cfg, 2, 48, torch.device("cpu"))
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 32))
    _, cache = lm.prefill(s["pt"], _t(toks), cfg, cache_len=32)  # ring 16 < bucket 32
    with pytest.raises(ValueError, match="hold the whole"):
        lm.scatter_into_slots(pool, cache, torch.arange(2), 32, 32)


# prompts within the reduced window (16); budgets long enough to wrap it
SPEC = [(6, 14), (11, 12), (9, 16), (16, 13), (3, 15), (13, 16)]


def _wave(cls):
    return [cls(rid=i, arrival=0.0, length=float(n), max_new_tokens=b)
            for i, (n, b) in enumerate(SPEC)]


@pytest.mark.parametrize("mode", [
    dict(continuous=True),
    dict(continuous=False),
    dict(continuous=False, pad_buckets=False, fused_decode=False),
], ids=["continuous", "run-to-completion", "rtc-legacy"])
def test_engine_wraps_the_window_ring_as_the_reference_engine(mode):
    """Danube served with budgets of 12-16 tokens past prompts of 3-16:
    every row's ring wraps; per rid the tokens equal the JAX engine's."""
    s = _setup(DANUBE)
    ec = dict(max_new_tokens=16, max_slots=4, segment_len=4, max_prompt_len=16, **mode)
    reng = rengine.build_engine(s["rcfg"], ec=rengine.EngineConfig(**ec))
    reng.params = s["jp"]
    reng.submit_many(_wave(RRequest))
    want = {r.rid: np.asarray(r.payload) for r in reng.run_until_idle()}
    eng = build_engine(s["cfg"], ec=EngineConfig(**ec), device="cpu", params=s["pt"])
    eng.submit_many(_wave(Request))
    got = {r.rid: np.asarray(r.payload) for r in eng.run_until_idle()}
    assert got.keys() == want.keys() and len(got) == len(SPEC)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)


# --- the attention paths of a long prefill ----------------------------------------


def _qkv(rng, B, Sq, Skv, H=4, KH=2, D=16):
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("per_row", [False, True])
def test_attention_blockwise_matches_reference(per_row, window):
    """Online softmax over KV blocks of 64 (Skv = 200: a padded last
    block), shared or per-row positions with left padding, with and without
    a window: against the JAX package's attention_blockwise and the port's
    dense attention."""
    rng = np.random.default_rng(8 + per_row + window)
    q, k, v = _qkv(rng, 2, 200, 200)
    if per_row:
        pos = np.arange(200)[None] - np.array([[0], [37]])
    else:
        pos = np.arange(200)
    kpos = np.where(pos >= 0, pos, -1)
    got = L.attention_blockwise(_t(q), _t(k), _t(v), _t(pos), _t(kpos), window=window,
                                kv_block=64)
    want = RL.attention_blockwise(*(jnp.asarray(a) for a in (q, k, v, pos, kpos)),
                                  window=window, kv_block=64)
    assert_allclose(_np(got), np.asarray(want), **TOL)
    dense = L.attention_dense(_t(q), _t(k), _t(v), _t(pos), _t(kpos), window=window)
    assert_allclose(_np(got), _np(dense), **TOL)


def test_attention_swa_banded_matches_reference():
    """Each 16-query block against its own and the previous key block (S =
    64, 4 windows, from pos0 = 5): the JAX package's banded attention and
    the port's dense attention with the window mask."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 2, 64, 64)
    got = L.attention_swa_banded(_t(q), _t(k), _t(v), 5, 16)
    want = RL.attention_swa_banded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 5, 16)
    assert_allclose(_np(got), np.asarray(want), **TOL)
    pos = torch.arange(64) + 5
    dense = L.attention_dense(_t(q), _t(k), _t(v), pos, pos, window=16)
    assert_allclose(_np(got), _np(dense), **TOL)


@pytest.mark.parametrize("case", ["banded", "dense", "blockwise", "blockwise-per-row"])
def test_attention_dispatcher_picks_the_reference_path(case, monkeypatch):
    """The dispatcher's three-way choice by shape: banded for a shared-
    position windowed self-attention of at least two windows, dense up to
    4,096 x 1,024 scores or one query, blockwise past that (here 2,080^2),
    also with per-row positions. The port takes the path the JAX package
    takes, and their outputs agree."""
    B, H, KH, D = 1, 2, 1, 8
    S, window = {"banded": (64, 16), "dense": (64, 0), "blockwise": (2080, 0),
                 "blockwise-per-row": (2080, 512)}[case]
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, B, S, S, H, KH, D)
    pos = np.arange(S)[None] - 3 if case.endswith("per-row") else np.arange(S)
    kpos = np.where(pos >= 0, pos, -1)
    taken = []
    for name in ("attention_swa_banded", "attention_dense", "attention_blockwise"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _fn=fn, _n=name, **kw: (
            taken.append(_n), _fn(*a, **kw))[1])
    got = L.attention(_t(q), _t(k), _t(v), _t(pos), _t(kpos), window=window)
    want_path = {"banded": "attention_swa_banded", "dense": "attention_dense"}.get(
        case, "attention_blockwise")
    assert taken[0] == want_path
    want = RL.attention(*(jnp.asarray(a) for a in (q, k, v, pos, kpos)), window=window)
    assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=2e-5)


# --- the dense archs through the engines and the launcher ---------------------------


@pytest.mark.parametrize("mode", [dict(continuous=True), dict(continuous=False)],
                         ids=["continuous", "run-to-completion"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "yi-34b"])
def test_dense_engine_tokens_equal_reference_engine(arch, mode):
    """granite (tied embeddings, vocab 49,155 at full size) and yi (rope
    theta 5e6): per rid the port's engine equals the JAX engine's."""
    s = _setup(arch)
    ec = dict(max_new_tokens=8, max_slots=4, segment_len=4, max_prompt_len=16, **mode)
    reng = rengine.build_engine(s["rcfg"], ec=rengine.EngineConfig(**ec))
    reng.params = s["jp"]
    reng.submit_many(_wave(RRequest))
    want = {r.rid: np.asarray(r.payload) for r in reng.run_until_idle()}
    eng = build_engine(s["cfg"], ec=EngineConfig(**ec), device="cpu", params=s["pt"])
    eng.submit_many(_wave(Request))
    got = {r.rid: np.asarray(r.payload) for r in eng.run_until_idle()}
    assert got.keys() == want.keys() and len(got) == len(SPEC)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)


@pytest.mark.parametrize("flags", [
    ["--arch", DANUBE, "--continuous", "--pipelined", "--preprocess", "dpu", "--clock",
     "virtual"],
    ["--arch", "granite-3-8b", "--continuous"],
    ["--arch", "yi-34b"],
], ids=["danube-pipelined-dpu", "granite-continuous", "yi-run-to-completion"])
def test_serve_launcher_serves_the_dense_archs_on_the_cpu(flags, capsys):
    """The launcher caps a window model's prompt bucket at its window (16
    reduced), which its slot pool's ring must hold."""
    from repro_torch.launch.serve import main

    main([*flags, "--reduced", "--device", "cpu", "--requests", "4", "--max-new", "3"])
    assert "served 4 requests" in capsys.readouterr().out
