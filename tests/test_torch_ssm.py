"""The PyTorch package's Mamba2 SSM family against the JAX package's, on the
CPU: the layer functions (the chunked SSD scan, the one-token SSM step, the
causal conv and its step, the gated RMSNorm, the left-padded block with
trained-looking biases), the weight bridge and the parameter count, the
model's prefill and generate, the continuous and run-to-completion engines,
the chunked-prefill fallback, join == alone in the slot pool, and the
launcher on an SSM arch.

Reduced mamba2-370m (4 layers, d_model 128, state 16, headdim 16, chunk 16)
at an fp32 override; inputs from a numpy seed; the JAX package's weights
carried across with models.params.from_reference. Greedy tokens must be
equal per request, with no near-tie exemption.

Tolerances. The two packages run the same fp32 formulas, but torch and XLA
contract the SSD scan's einsums in different orders, so layer outputs are
held by allclose: rtol 1e-4, atol 1e-5 (SSD outputs and states, the block,
its conv tail), 1e-5 on the causal conv and the gated norm, 1e-6 on
softplus, and 2e-3 against the float64 sequential recurrence (the JAX
package's own test tolerance); prefill logits at rtol 1e-4, atol 1e-5.
Within the port a decode-step continuation is held by the same 2e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
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
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import LM  # noqa: E402
from repro_torch.models.params import from_reference, init_params  # noqa: E402
from repro_torch.serving.engine import EngineConfig, build_engine  # noqa: E402

torch.set_num_threads(1)

# the JAX package's functions, jitted: one XLA program a shape instead of
# one a primitive (the same formulas; compared by tolerance anyway)
R_SSD = jax.jit(RL.ssd_chunked, static_argnums=(5,))
R_BLOCK = jax.jit(RL.ssm_block, static_argnums=(2,), static_argnames=("return_state",))
R_PREFILL = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
R_GENERATE = jax.jit(rlm.generate, static_argnums=(3, 4), static_argnames=("steps",))

ARCH = "mamba2-370m"
SSD_TOL = dict(rtol=1e-4, atol=1e-5)
ORACLE_TOL = dict(rtol=2e-3, atol=2e-3)
# prompt lengths (buckets 8 and 16) and per-request budgets
SPEC = [(6, 6), (11, 4), (9, 5), (16, 7), (3, 3), (13, 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def setup():
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    params = from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu", "float32")
    return dict(rcfg=rcfg, cfg=cfg, jparams=jparams, params=params)


def _ssd_inputs(rng, b, l, h, p, g, n):
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (0.001 + rng.random((b, l, h)) * 0.1).astype(np.float32)
    A = (-rng.random(h) * 4 - 0.5).astype(np.float32)
    Bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _naive_ssd(x, dt, A, Bm, Cm, state):
    """The sequential recurrence in float64: h_t = h_{t-1} e^{dt A} + dt B x."""
    rep = x.shape[2] // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    state = state.astype(np.float64)
    ys = np.zeros(x.shape, np.float64)
    for t in range(x.shape[1]):
        dA = np.exp(dt[:, t] * A[None])
        inc = np.einsum("bhp,bhn->bhpn", x[:, t] * dt[:, t][..., None], Bh[:, t])
        state = state * dA[..., None, None] + inc
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return ys, state


# --- layer functions ---------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("l", [8, 13, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk, l, with_state):
    """Two groups of two heads each, so B and C repeat per group
    (repeat_interleave, as jnp.repeat along an axis)."""
    rng = np.random.default_rng(100 * chunk + l)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x, dt, A, Bm, Cm = _ssd_inputs(rng, b, l, h, p, g, n)
    st0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state \
        else np.zeros((b, h, p, n), np.float32)
    init = st0 if with_state else None
    y, fin = L.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                           init_state=None if init is None else _t(init))
    ry, rfin = R_SSD(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
                     jnp.asarray(Cm), chunk, None if init is None else jnp.asarray(init))
    assert y.dtype == torch.float32 and fin.dtype == torch.float32
    assert_allclose(_np(y), np.asarray(ry), **SSD_TOL)
    assert_allclose(_np(fin), np.asarray(rfin), **SSD_TOL)
    y64, fin64 = _naive_ssd(x, dt, A, Bm, Cm, st0)
    assert_allclose(_np(y), y64, **ORACLE_TOL)
    assert_allclose(_np(fin), fin64, **ORACLE_TOL)


def test_segsum_is_the_cumsum_difference_with_minus_inf_above():
    x = np.random.default_rng(3).standard_normal((2, 3, 7)).astype(np.float32)
    got, want = _np(L.segsum(_t(x))), np.asarray(RL.segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1:]).all() and np.isfinite(np.diagonal(got, 0, -2, -1)).all()
    fin = np.isfinite(want)
    assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_ssm_step_continues_ssd():
    """SSD over l tokens, then ssm_step on token l+1 == SSD over l+1 (within
    the port), and the step equals the JAX package's step."""
    rng = np.random.default_rng(11)
    b, l, h, p, g, n = 1, 16, 2, 4, 1, 8
    x, dt, A, Bm, Cm = _ssd_inputs(rng, b, l + 1, h, p, g, n)
    _, st = L.ssd_chunked(_t(x[:, :l]), _t(dt[:, :l]), _t(A), _t(Bm[:, :l]),
                          _t(Cm[:, :l]), 8)
    y1, st1 = L.ssm_step(_t(x[:, l]), _t(dt[:, l]), _t(A), _t(Bm[:, l]), _t(Cm[:, l]), st)
    y_full, st_full = L.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), 17)
    assert_allclose(_np(y1), _np(y_full[:, -1]), **ORACLE_TOL)
    assert_allclose(_np(st1), _np(st_full), **ORACLE_TOL)
    ry, rst = RL.ssm_step(jnp.asarray(x[:, l]), jnp.asarray(dt[:, l]), jnp.asarray(A),
                          jnp.asarray(Bm[:, l]), jnp.asarray(Cm[:, l]), jnp.asarray(_np(st)))
    assert_allclose(_np(y1), np.asarray(ry), **SSD_TOL)
    assert_allclose(_np(st1), np.asarray(rst), **SSD_TOL)


def test_conv1d_step_continues_causal():
    rng = np.random.default_rng(12)
    b, l, c, k = 2, 10, 6, 4
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    w = rng.standard_normal((c, k)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    full = L.conv1d_causal(_t(x), _t(w), _t(bias))
    assert_allclose(_np(full), np.asarray(RL.conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                                                           jnp.asarray(bias))),
                    rtol=1e-5, atol=1e-5)
    y1, st = L.conv1d_step(_t(x[:, -1]), _t(x[:, l - k:l - 1]), _t(w), _t(bias))
    assert_allclose(_np(y1), _np(full[:, -1]), rtol=1e-5, atol=1e-5)
    assert torch.equal(st, _t(x[:, l - k + 1:]))


def test_rmsnorm_gated_and_softplus_match_reference():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    z = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    got = L.rmsnorm_gated(_t(x), _t(z), _t(w), 1e-5)
    want = RL.rmsnorm_gated(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), 1e-5)
    assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    # softplus: the JAX package's logaddexp(x, 0); F.softplus turns linear
    # above 20, where log1p(e^-x) is below an fp32 ulp of x: all three agree
    s = np.linspace(-40.0, 40.0, 4001, dtype=np.float32)
    mine = _np(L._softplus(_t(s)))
    assert_allclose(mine, np.asarray(jax.nn.softplus(jnp.asarray(s))), rtol=1e-6, atol=1e-6)
    assert_allclose(mine, _np(F.softplus(_t(s))), rtol=1e-6, atol=1e-6)


def _perturbed(tree, seed=42):
    """conv_b and dt_bias moved off their init (zeros; the log-uniform
    inverse softplus), as in any trained checkpoint."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, seed + 1)
        elif k in ("conv_b", "dt_bias"):
            v = np.asarray(v)
            out[k] = (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def test_ssm_block_with_pos_offset_and_trained_biases(setup):
    """Left-padded rows with nonzero conv_b and dt_bias: the block's output,
    conv tail and final state equal the JAX package's, and each padded row
    equals the same prompt run unpadded (pad slots stay state-neutral; a
    block that only zeroed its inputs would leak silu(conv_b) into the
    state)."""
    cfg = setup["cfg"]
    tree = _perturbed(jax.tree.map(np.asarray, setup["jparams"]))
    p_ref = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["body"]["l0"]["mixer"])
    p = {k: _t(v[0]) for k, v in tree["body"]["l0"]["mixer"].items()}
    assert np.abs(tree["body"]["l0"]["mixer"]["conv_b"]).max() > 0.1
    rng = np.random.default_rng(14)
    S, lens = 24, [24, 19, 7]
    x = rng.standard_normal((len(lens), S, cfg.d_model)).astype(np.float32)
    off = np.array([S - n for n in lens])
    for i, n in enumerate(lens):
        x[i, :S - n] = 0.0                           # the zeroed pad embeddings
    out, (tail, st) = L.ssm_block(_t(x), p, cfg, return_state=True, pos_offset=_t(off))
    rout, (rtail, rst) = R_BLOCK(jnp.asarray(x), p_ref, setup["rcfg"], return_state=True,
                                 pos_offset=jnp.asarray(off))
    assert st.dtype == torch.float32 and tail.shape == (3, cfg.ssm_conv - 1, cfg.conv_dim)
    for got, want in ((out, rout), (tail, rtail), (st, rst)):
        assert_allclose(_np(got), np.asarray(want), **SSD_TOL)
    assert not _np(out)[2, :S - 7].any()             # pad slots emit exactly 0
    for i, n in enumerate(lens):
        o1, (t1, s1) = L.ssm_block(_t(x[i:i + 1, S - n:]), p, cfg, return_state=True)
        assert_allclose(_np(out[i, S - n:]), _np(o1[0]), **SSD_TOL)
        assert_allclose(_np(st[i]), _np(s1[0]), **SSD_TOL)
        if n >= cfg.ssm_conv - 1:
            assert_allclose(_np(tail[i]), _np(t1[0]), **SSD_TOL)


# --- weights, count, model ---------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "tinyllama-1.1b"])
def test_param_count_is_the_reference_count(arch):
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced(arch), ref_reduced(arch))):
        assert mine.param_count() == rapi.count_params_analytical(ref)
        assert mine.active_param_count() == rapi.count_params_analytical(ref, active_only=True)


def test_seeded_init_draws_the_reference_init_rules():
    """Seeded weights: conv_b zeros, D and the norm gains ones, dt_bias the
    inverse softplus of a log-uniform dt in [1e-3, 1e-1], A_log in
    [log 1, log 16), conv_w at scale 0.1; the state pool in fp32."""
    cfg = reduced(ARCH)
    t = init_params(cfg, torch.Generator().manual_seed(0), "cpu", "float32")
    m = t["body"]["l0"]["mixer"]
    assert set(t["body"]["l0"]) == {"mixer"} and "lm_head" not in t
    assert not m["conv_b"].any() and bool((m["D"] == 1).all()) and bool((m["norm_w"] == 1).all())
    dt = F.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert float(m["A_log"].min()) >= 0.0 and float(m["A_log"].max()) < np.log(16.0)
    assert 0.05 < float(m["conv_w"].std()) < 0.15
    pool = lm.alloc_slot_pool(dataclasses.replace(cfg, dtype="bfloat16"), 3, 64, "cpu")
    pm = pool["body"]["l0"]["mixer"]
    assert pm["conv"].dtype == torch.bfloat16 and pm["state"].dtype == torch.float32
    assert pm["state"].shape == (cfg.n_layers, 3, cfg.n_ssm_heads, cfg.ssm_headdim,
                                 cfg.ssm_state)


def test_from_reference_prefill_and_generate_match(setup):
    """The JAX package's seed-0 tree carried across: prefill logits allclose
    (left-padded bucket, tied head cut to the true vocab), the SSM cache
    leaves allclose, and generate's tokens equal."""
    cfg, rcfg = setup["cfg"], setup["rcfg"]
    model = LM(cfg, setup["params"])
    rng = np.random.default_rng(15)
    lp, lens = 32, [32, 21, 9]
    toks = np.zeros((3, lp), np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = rng.integers(0, cfg.vocab, n)
    off = np.array([lp - n for n in lens])
    logits, cache = model.prefill(_t(toks), pos_offset=_t(off))
    rlogits, rcache = R_PREFILL(setup["jparams"], jnp.asarray(toks), rcfg,
                                pos_offset=jnp.asarray(off))
    assert logits.shape == (3, 1, cfg.vocab)
    assert_allclose(_np(logits), np.asarray(rlogits), rtol=1e-4, atol=1e-5)
    for k in ("conv", "state"):
        assert_allclose(_np(cache["body"]["l0"]["mixer"][k]),
                        np.asarray(rcache["body"]["l0"]["mixer"][k]), **SSD_TOL)
    got, _ = model.generate(cache, logits, lp, steps=10, pos_offset=_t(off))
    want, _ = R_GENERATE(setup["jparams"], rcache, rlogits, lp, rcfg, steps=10,
                         pos_offset=jnp.asarray(off))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# --- engines -----------------------------------------------------------------


def _wave(cls, rid0=0):
    return [cls(rid=rid0 + i, arrival=0.0, length=float(n), max_new_tokens=b)
            for i, (n, b) in enumerate(SPEC)]


def _serve(engine, reqs):
    engine.submit_many(reqs)
    return {r.rid: np.asarray(r.payload) for r in engine.run_until_idle()}


BASE = dict(max_new_tokens=8, max_slots=2, segment_len=4, max_prompt_len=16)


@pytest.mark.parametrize("mode", [
    dict(continuous=True),
    dict(continuous=True, chunk_lens=(4,), prefix_cache_bytes=1 << 20),
    dict(continuous=False),
    dict(continuous=False, pad_buckets=False, fused_decode=False),
], ids=["continuous", "chunk-lens-fall-back", "run-to-completion", "rtc-legacy"])
def test_engine_tokens_equal_reference_engine(setup, mode):
    """Per rid, the port's engine == the JAX package's, in every mode. With
    chunk_lens set the SSM family admits monolithically: no chunk length
    survives and no prefix store is built, in either package."""
    ec = dict(BASE, **mode)
    reng = rengine.build_engine(setup["rcfg"], ec=rengine.EngineConfig(**ec))
    reng.params = setup["jparams"]
    eng = build_engine(setup["cfg"], ec=EngineConfig(**ec), device="cpu",
                       params=setup["params"])
    want, got = _serve(reng, _wave(RRequest)), _serve(eng, _wave(Request))
    assert got.keys() == want.keys() and len(got) == len(SPEC)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)
    if mode.get("continuous"):
        assert eng._chunk_lens == reng._chunk_lens == ()
        assert eng.prefix_store is None and reng.prefix_store is None
        assert eng.stats["admitted"] == reng.stats["admitted"] == len(SPEC)


def _alone(model, cfg, rid, n, steps):
    """The request decoded alone: prefill at its own length, then the
    sequential decode loop (no padding, no pool, no segments)."""
    prompt = np.random.default_rng(rid).integers(0, cfg.vocab, n)
    logits, cache = model.prefill(_t(prompt)[None], cache_len=n + steps)
    tok = torch.argmax(logits, -1)
    out = [tok]
    for t in range(steps - 1):
        logits, cache = model.decode(cache, tok, n + t)
        tok = torch.argmax(logits, -1)
        out.append(tok)
    return _np(torch.cat(out, dim=1)[0]), cache


def test_join_equals_alone_in_the_slot_pool(setup):
    """A request that joins the pool while another is mid-flight decodes as
    it does alone: its tokens equal the lone run's (the conv tail and state
    rows are plain copies, so the row it lands in carries nothing of its
    previous occupant), and so do the JAX package's."""
    cfg = setup["cfg"]
    eng = build_engine(cfg, ec=EngineConfig(continuous=True, max_slots=2, segment_len=4,
                                            max_new_tokens=6, max_prompt_len=16),
                       device="cpu", params=setup["params"])
    first = [Request(rid=9, arrival=0.0, length=13.0, max_new_tokens=2)]
    eng._admit(first)               # an earlier occupant of slot 0, retired
    eng._decode_segment(4)
    r1 = Request(rid=11, arrival=0.0, length=6.0, max_new_tokens=6)
    r2 = Request(rid=12, arrival=0.0, length=11.0, max_new_tokens=4)
    eng._admit([r1])                # takes slot 0
    eng._decode_segment(4)
    eng._admit([r2])                # joins while r1 is mid-flight
    eng._decode_segment(4)
    done = {r.rid: r for r in eng.completed}
    assert set(done) == {9, 11, 12}
    for rid in (11, 12):
        r = done[rid]
        got = np.asarray(r.payload)
        alone, _ = _alone(eng.model, cfg, rid, int(r.length), len(got))
        np.testing.assert_array_equal(got, alone)
        n = int(r.length)
        prompt = jnp.asarray(np.random.default_rng(rid).integers(0, cfg.vocab, n))[None]
        rlogits, rcache = R_PREFILL(setup["jparams"], prompt, setup["rcfg"],
                                    cache_len=n + len(got))
        want, _ = R_GENERATE(setup["jparams"], rcache, rlogits, n, setup["rcfg"],
                             steps=len(got))
        np.testing.assert_array_equal(got, np.asarray(want)[0])


def test_service_estimate_of_a_tenant_that_cannot_chunk():
    """The runtime's per-request service estimate: a tenant whose family
    cannot chunk pays one admission whatever its prompt bucket, a chunking
    tenant one dispatch per chunk."""
    from repro_torch.serving.multislice import TenantSpec, build_multislice_engine
    from repro_torch.serving.runtime import PipelinedRuntime, RuntimeConfig

    ec = EngineConfig(max_new_tokens=8, continuous=True, max_slots=2, segment_len=4,
                      max_prompt_len=64, chunk_lens=(16,))
    ms = build_multislice_engine(
        n_slices=2, ec=ec, device="cpu",
        tenants=[TenantSpec(cfg=reduced("tinyllama-1.1b"), n_slices=1),
                 TenantSpec(cfg=reduced(ARCH), n_slices=1)])
    assert ms.chunked_for_model("tinyllama-1.1b-reduced")
    assert not ms.chunked_for_model("mamba2-370m-reduced")
    rt = PipelinedRuntime(ms, None, RuntimeConfig(clock="virtual"))
    rt.seg_ema = 0.01
    segs = 2  # 8 new tokens in segments of 4
    for model, chunks in (("tinyllama-1.1b-reduced", 4), ("mamba2-370m-reduced", 1)):
        r = Request(rid=1, arrival=0.0, length=60.0, model=model)
        assert rt.request_service_s(r) == pytest.approx(0.01 * (chunks + segs))


# --- entry points ------------------------------------------------------------


def test_ssm_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(reduced(ARCH))


@pytest.mark.parametrize("flags", [
    ["--arch", ARCH, "--continuous"],
    ["--arch", ARCH],
    ["--tenants", f"tinyllama-1.1b:2,{ARCH}:2"],
    ["--tenants", f"tinyllama-1.1b:1,{ARCH}:1", "--pipelined", "--preprocess", "dpu",
     "--clock", "virtual"],
], ids=["continuous", "run-to-completion", "tenants", "tenants-pipelined-dpu"])
def test_serve_launcher_serves_the_ssm_family_on_the_cpu(flags, capsys):
    from repro_torch.launch.serve import main

    main([*flags, "--reduced", "--device", "cpu", "--requests", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    if "--tenants" in flags:
        assert f"tenant {ARCH}: slices=" in out and "tenant tinyllama-1.1b: slices=" in out


def test_calibrate_knee_on_an_ssm_arch_on_the_cpu(tmp_path, capsys):
    from repro_torch.core.batching.knee import profiles_from_json
    from repro_torch.launch.serve import main

    out = tmp_path / "knees.json"
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--max-slots", "2",
          "--calibrate-knee", str(out)])
    profiles = profiles_from_json(out.read_text())
    assert sorted(profiles) == [0, 1] and all(p.batch_knee >= 1 for p in profiles.values())
