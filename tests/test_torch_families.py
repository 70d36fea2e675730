"""The PyTorch package's last three model families against the JAX
package's, on the CPU: jamba's hybrid stack (one attention layer and seven
Mamba2 layers a block of 8, MoE on every other layer), phi-3-vision's
decoder with image embeddings in place of its first tokens, and whisper's
encoder-decoder (a non-causal roped encoder over audio frames, then a
decoder whose every layer cross-attends the encoder's output).

Reduced configs (jamba 8 layers, the others 4; d_model 128, head size 32;
whisper's encoder 2 layers over 24 frames, phi-3-vision's 8 image tokens)
at an fp32 override; the JAX package's seed-0 weights carried across with
models.params.from_reference; inputs from a numpy seed. Logits are held by
allclose at rtol = atol = 1e-5, greedy tokens and cache shapes by
equality. Covered: the configs and their counts, prefill with and without
pos_offset, image embeddings, the encoder alone and whisper's prefill, 16
decode steps (every self- and cross-attention step through
ops.decode_attention), the slot pool's cross-attention rows, the
attention dispatcher at whisper's 1,500 encoder positions, the engine in
both modes and a fleet tenant for jamba and phi-3-vision, whisper's
refusal by the engine and the launcher beside the JAX engine's own
failure, and the chunked-prefill gate of all ten archs.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import multislice as rms  # noqa: E402
from repro_torch.configs import MODEL_ARCHS, SERVED_ARCHS, get_config, reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import LM  # noqa: E402
from repro_torch.models.params import from_reference, leaves  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine, build_engine  # noqa: E402
from repro_torch.serving.multislice import TenantSpec, build_multislice_engine  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["jamba-v0.1-52b", "phi-3-vision-4.2b", "whisper-base"]
ENGINE_ARCHS = ["jamba-v0.1-52b", "phi-3-vision-4.2b"]
R_PREFILL = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
R_DECODE = jax.jit(rlm.decode, static_argnums=(4,))
R_ENCODE = jax.jit(rlm.encode_audio, static_argnums=(2,))
B, S, STEPS = 2, 16, 16


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


def _inputs(cfg, seed, padded):
    """Tokens [B, S], left-pad offsets (or None) and the arch's non-token
    context: whisper's audio frames, phi-3-vision's image embeddings
    (unpadded batches only: both packages refuse them with pos_offset)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    off = np.array([0, 5]) if padded else None
    if padded:
        toks[1, :5] = 0
    ctx = {}
    if cfg.enc_layers:
        ctx["audio_frames"] = rng.standard_normal(
            (B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens and not padded:
        ctx["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return toks, off, ctx


# --- configs and weights -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_tree_and_counts_match_reference(arch):
    """Every field of the full and the reduced config equals the JAX
    package's; the layer kinds (jamba: attention on layer 0 of each 8, MoE
    on the odd layers), the block period, the counts (all and active, the
    encoder and cross-attention included) and the weight tree, leaf for
    leaf, are the reference's."""
    assert arch in MODEL_ARCHS and (arch in SERVED_ARCHS) == (arch != "whisper-base")
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced(arch), ref_reduced(arch))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), (arch, f.name)
        assert mine.layer_kinds() == ref.layer_kinds()
        assert mine.is_subquadratic() == ref.is_subquadratic()
        assert mine.param_count() == rapi.count_params_analytical(ref)
        assert mine.active_param_count() == rapi.count_params_analytical(ref, active_only=True)
        assert lm.block_period(mine) == rlm.block_period(ref)
    s = _setup(arch)
    want = dict(leaves(jax.tree.map(np.asarray, s["jp"])))
    got = dict(leaves(s["pt"]))
    assert got.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(_np(got[path]), a)


def test_all_ten_archs_are_registered_and_jamba_is_its_own_block():
    assert sorted(MODEL_ARCHS) == sorted(ASSIGNED_ARCHS)
    assert SERVED_ARCHS == [a for a in MODEL_ARCHS if a != "whisper-base"]
    jamba = get_config("jamba-v0.1-52b")
    assert lm.block_period(jamba) == 8 and jamba.param_count() == 51_485_722_112
    assert [m for m, _ in reduced(jamba).layer_kinds()] == ["attn"] + ["ssm"] * 7


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_trees_match_cache_specs(arch, dtype):
    """The slot pool's leaves, and a prefill cache's, have the shapes and
    types of the JAX package's cache_specs (paths included): K/V rings,
    SSM conv tails in the activation type and fp32 states, whisper's
    encoder K/V [B, n_audio_ctx, kh, hd]."""
    cfg = dataclasses.replace(reduced(arch), dtype=dtype)
    rcfg = dataclasses.replace(ref_reduced(arch), dtype=dtype)
    want = {p: (tuple(sd.shape), str(sd.dtype)) for p, sd in leaves(rlm.cache_specs(rcfg, 3, 24))}
    pool = lm.alloc_slot_pool(cfg, 3, 24, torch.device("cpu"))
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for p, t in leaves(pool)}
    assert got == want
    if dtype == "float32":
        rng = np.random.default_rng(1)
        ctx = {}
        if cfg.enc_layers:
            ctx["audio_frames"] = _t(rng.standard_normal((3, cfg.n_audio_ctx, cfg.d_model)))
        _, cache = lm.prefill(_setup(arch)["pt"], _t(rng.integers(0, cfg.vocab, (3, 8))), cfg,
                              cache_len=24, **ctx)
        assert {p: tuple(t.shape) for p, t in leaves(cache)} == {
            p: shape for p, (shape, _) in want.items()}


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_supports_chunked_prefill_equals_reference(arch):
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced(arch), ref_reduced(arch))):
        assert lm.supports_chunked_prefill(mine) == rlm.supports_chunked_prefill(ref)
    assert lm.supports_chunked_prefill(get_config(arch)) == (
        arch in ("tinyllama-1.1b", "granite-3-8b", "yi-34b"))


# --- prefill, the encoder and decode -------------------------------------------


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "pos_offset"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, padded):
    """Last-position logits and greedy tokens of a [2, 16] batch (row 1
    left-padded by 5 with pos_offset), whisper with audio frames,
    phi-3-vision with image embeddings when unpadded; through LM.forward
    too."""
    s = _setup(arch)
    cfg = s["cfg"]
    toks, off, ctx = _inputs(cfg, 2, padded)
    kw = {} if off is None else {"pos_offset": off}
    got, cache = lm.prefill(s["pt"], _t(toks), cfg, cache_len=S + STEPS,
                            **{k: _t(v) for k, v in {**ctx, **kw}.items()})
    want, _ = R_PREFILL(s["jp"], jnp.asarray(toks), s["rcfg"], cache_len=S + STEPS,
                        **{k: jnp.asarray(v) for k, v in {**ctx, **kw}.items()})
    assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(_np(got.argmax(-1)), np.asarray(want).argmax(-1))
    api = LM(cfg, s["pt"])(_t(toks), None if off is None else _t(off),
                           **{k: _t(v) for k, v in ctx.items()})
    assert torch.equal(api, got)


def test_image_embeddings_replace_the_first_tokens():
    """phi-3-vision: the patch embeddings stand in for the first 8 token
    embeddings (the logits differ from the text-only prefill's and do not
    depend on the tokens they replace)."""
    s = _setup("phi-3-vision-4.2b")
    cfg = s["cfg"]
    toks, _, ctx = _inputs(cfg, 3, padded=False)
    img = _t(ctx["img_embeds"])
    with_img, _ = lm.prefill(s["pt"], _t(toks), cfg, img_embeds=img)
    text, _ = lm.prefill(s["pt"], _t(toks), cfg)
    other = toks.copy()
    other[:, :cfg.n_img_tokens] = (other[:, :cfg.n_img_tokens] + 1) % cfg.vocab
    replaced, _ = lm.prefill(s["pt"], _t(other), cfg, img_embeds=img)
    assert torch.equal(with_img, replaced) and not torch.allclose(with_img, text)


def test_pos_offset_with_image_embeddings_is_refused_in_both_packages():
    s = _setup("phi-3-vision-4.2b")
    cfg = s["cfg"]
    toks, _, ctx = _inputs(cfg, 4, padded=False)
    off = np.array([0, 2])
    with pytest.raises(ValueError, match="image prefixes"):
        lm.prefill(s["pt"], _t(toks), cfg, pos_offset=_t(off),
                   img_embeds=_t(ctx["img_embeds"]))
    with pytest.raises(ValueError, match="image prefixes"):
        rlm.prefill(s["jp"], jnp.asarray(toks), s["rcfg"], pos_offset=jnp.asarray(off),
                    img_embeds=jnp.asarray(ctx["img_embeds"]))


def test_encoder_output_matches_reference():
    """whisper's encoder alone: 2 non-causal roped layers over 24 frames."""
    s = _setup("whisper-base")
    _, _, ctx = _inputs(s["cfg"], 5, padded=False)
    got = lm.encode_audio(s["pt"], _t(ctx["audio_frames"]), s["cfg"])
    want = R_ENCODE(s["jp"], jnp.asarray(ctx["audio_frames"]), s["rcfg"])
    assert got.shape == (B, s["cfg"].n_audio_ctx, s["cfg"].d_model)
    assert_allclose(_np(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="audio_frames"):
        lm.prefill(s["pt"], _t(np.zeros((1, 4), np.int64)), s["cfg"])


def _spy(monkeypatch):
    calls = []
    real = ops.decode_attention

    def spy(q, k, v, valid_len):
        calls.append((k.shape[1], valid_len.tolist()))
        return real(q, k, v, valid_len)

    monkeypatch.setattr(lm.ops, "decode_attention", spy)
    return calls


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "pos_offset"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, padded, monkeypatch):
    """16 greedy decode steps after the prefill: every step's logits and
    token equal the JAX package's decode; every self-attention layer calls
    decode attention once a step with valid_len = min(qpos + 1, ring), and
    every cross-attention layer once with valid_len = n_audio_ctx; the
    encoder K/V are never written; generate == the decode loop."""
    s = _setup(arch)
    cfg, rcfg = s["cfg"], s["rcfg"]
    toks, off, ctx = _inputs(cfg, 6, padded)
    kw = {} if off is None else {"pos_offset": off}
    tk = {k: _t(v) for k, v in {**ctx, **kw}.items()}
    jk = {k: jnp.asarray(v) for k, v in {**ctx, **kw}.items()}
    logits, cache = lm.prefill(s["pt"], _t(toks), cfg, cache_len=S + STEPS, **tk)
    rlogits, rcache = R_PREFILL(s["jp"], jnp.asarray(toks), rcfg, cache_len=S + STEPS, **jk)
    start = {p: t.clone() for p, t in leaves(cache)}
    ref_pos_offset = jk.get("pos_offset")
    calls = _spy(monkeypatch)
    n_attn = sum(m == "attn" for m, _ in cfg.layer_kinds())
    tok, rtok, toks_out = logits.argmax(-1), jnp.argmax(rlogits, -1).astype(jnp.int32), []
    for i in range(STEPS):
        pos = S + i
        logits, cache = lm.decode(s["pt"], cache, tok, pos, cfg, pos_offset=tk.get("pos_offset"))
        rlogits, rcache = R_DECODE(s["jp"], rcache, rtok, jnp.int32(pos), rcfg,
                                   pos_offset=ref_pos_offset)
        assert_allclose(_np(logits), np.asarray(rlogits), **TOL)
        tok, rtok = logits.argmax(-1), jnp.argmax(rlogits, -1).astype(jnp.int32)
        np.testing.assert_array_equal(_np(tok), np.asarray(rtok))
        toks_out.append(tok)
    n_cross = cfg.n_layers if cfg.enc_layers else 0
    assert len(calls) == (n_attn + n_cross) * STEPS
    true_len = S - (0 if off is None else off)
    for i in range(STEPS):
        step = calls[i * (n_attn + n_cross):(i + 1) * (n_attn + n_cross)]
        assert sorted(step) == sorted([(S + STEPS, (true_len + i + 1).tolist()
                                        if off is not None else [S + i + 1] * B)] * n_attn
                                      + [(cfg.n_audio_ctx, [cfg.n_audio_ctx] * B)] * n_cross)
    for p, t in leaves(cache):
        if p.split(".")[-1] in ("ck", "cv"):
            assert torch.equal(t, start[p])
    # generate == argmax(prefill) + the decode loop
    logits0, cache = lm.prefill(s["pt"], _t(toks), cfg, cache_len=S + STEPS, **tk)
    gen, _ = lm.generate(s["pt"], cache, logits0, S, cfg, steps=STEPS + 1,
                         pos_offset=tk.get("pos_offset"))
    assert torch.equal(gen, torch.cat([logits0.argmax(-1)] + toks_out, dim=1))


def test_whisper_slot_pool_rows_match_reference():
    """The encoder K/V are plain rows of the slot pool: a left-padded
    whisper prefill cache scattered into rows 2 and 0 of a 3-slot pool
    equals the JAX package's scatter_into_slots leaf for leaf, and 4 decode
    steps over the pool give the reference's logits."""
    s = _setup("whisper-base")
    cfg, rcfg = s["cfg"], s["rcfg"]
    toks, off, ctx = _inputs(cfg, 7, padded=True)
    _, pcache = lm.prefill(s["pt"], _t(toks), cfg, pos_offset=_t(off), cache_len=S,
                           audio_frames=_t(ctx["audio_frames"]))
    _, rpcache = R_PREFILL(s["jp"], jnp.asarray(toks), rcfg, cache_len=S,
                           pos_offset=jnp.asarray(off),
                           audio_frames=jnp.asarray(ctx["audio_frames"]))
    ids = np.array([2, 0])
    pool = lm.scatter_into_slots(lm.alloc_slot_pool(cfg, 3, 32, torch.device("cpu")),
                                 pcache, _t(ids), S, S)
    rpool = rlm.scatter_into_slots(rlm.alloc_slot_pool(rcfg, 3, 32), rpcache,
                                   jnp.asarray(ids), S, S)
    want = dict(leaves(jax.tree.map(np.asarray, rpool)))
    for p, t in leaves(pool):
        assert_allclose(_np(t), want[p], **TOL)
    poff = np.array([5, S, 0])  # clock S - true length; slot 1 is empty
    tok = np.zeros((3, 1), np.int64)
    for i in range(4):
        lg, pool = lm.decode(s["pt"], pool, _t(tok), S + i, cfg, pos_offset=_t(poff))
        rlg, rpool = R_DECODE(s["jp"], rpool, jnp.asarray(tok, jnp.int32), jnp.int32(S + i),
                              rcfg, pos_offset=jnp.asarray(poff))
        assert_allclose(_np(lg), np.asarray(rlg), **TOL)
        tok = _np(lg.argmax(-1))


@pytest.mark.parametrize("sq", [1, 8, 1500, 2800])
def test_attention_dispatch_at_1500_encoder_positions_matches_reference(sq, monkeypatch):
    """L.attention over 1,500 keys, not causal (whisper's encoder and cross
    attention): the port takes the path the JAX package takes (dense up to
    4,096 x 1,024 scores or one query, blockwise past it) and its output."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((1, sq, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1500, 1, 8)).astype(np.float32) for _ in range(2))
    qpos, kpos = np.arange(sq), np.arange(1500)
    taken = {}
    for mod, tag in ((L, "port"), (RL, "ref")):
        for name in ("attention_dense", "attention_blockwise"):
            real = getattr(mod, name)

            def rec(*a, _real=real, _name=name, _tag=tag, **kw):
                taken[_tag] = _name
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, rec)
    got = L.attention(_t(q), _t(k), _t(v), _t(qpos), _t(kpos), causal=False)
    want = RL.attention(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), causal=False)
    assert taken["port"] == taken["ref"] == (
        "attention_dense" if sq * 1500 <= 4096 * 1024 or sq == 1 else "attention_blockwise")
    assert_allclose(_np(got), np.asarray(want), **TOL)


# --- engines, the fleet and the launcher --------------------------------------

# prompt lengths (buckets 8 and 16) and budgets; a reduced MoE group is 64
# tokens, which a 4-slot admission of a 16-token bucket fills
SPEC = [(6, 6), (11, 4), (9, 5), (16, 7), (3, 3), (13, 8)]
FLEET_SPEC = [(6, 6), (3, 3), (8, 5)]  # one 8-token bucket: one prefill program a tenant
BASE = dict(max_new_tokens=8, max_slots=4, segment_len=4, max_prompt_len=16)


def _wave(cls, rid0=0, model=None, spec=SPEC):
    return [cls(rid=rid0 + i, arrival=0.0, length=float(n), max_new_tokens=b, model=model)
            for i, (n, b) in enumerate(spec)]


def _serve(engine, reqs):
    engine.submit_many(reqs)
    return {r.rid: np.asarray(r.payload) for r in engine.run_until_idle()}


@pytest.mark.parametrize("mode", [dict(continuous=True, chunk_lens=(8,)),
                                  dict(continuous=False)],
                         ids=["continuous", "run-to-completion"])
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_tokens_equal_reference_engine(arch, mode):
    """Per rid, the port's engine == the JAX package's; with chunk_lens set
    both admit monolithically (an SSM, MoE or image-prefix model cannot
    chunk), and every decode step launches decode attention once an
    attention layer."""
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


def test_fleet_with_a_jamba_tenant_equals_the_reference():
    """Reduced tinyllama and reduced jamba as two tenants of one slice
    each, one admission queue, three requests each: per rid the tokens equal the JAX package's
    two-tenant fleet's, and no request touched a foreign slice."""
    names = ("tinyllama-1.1b", "jamba-v0.1-52b")
    ss = [_setup(n) for n in names]
    ec = dict(BASE)
    rfleet = rms.build_multislice_engine(
        n_slices=2, ec=rengine.EngineConfig(**ec),
        tenants=[rms.TenantSpec(cfg=s["rcfg"], name=n, n_slices=1, params=s["jp"])
                 for s, n in zip(ss, names)])
    rfleet.submit_many(_wave(RRequest, 100, names[0], FLEET_SPEC)
                       + _wave(RRequest, 200, names[1], FLEET_SPEC))
    want = {r.rid: np.asarray(r.payload) for r in rfleet.run_until_idle()}
    fleet = build_multislice_engine(
        n_slices=2, ec=EngineConfig(**ec), device="cpu",
        tenants=[TenantSpec(cfg=s["cfg"], name=n, n_slices=1, params=LM(s["cfg"], s["pt"]))
                 for s, n in zip(ss, names)])
    got = _serve(fleet, _wave(Request, 100, names[0], FLEET_SPEC)
                 + _wave(Request, 200, names[1], FLEET_SPEC))
    assert got.keys() == want.keys() and len(got) == 2 * len(FLEET_SPEC)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got[rid], toks)
    ts = fleet.tenant_stats()
    for n in names:
        assert ts[n]["completed"] == len(FLEET_SPEC) and ts[n]["dead"] == 0
        assert set(ts[n]["routed_to"]) <= set(fleet.slices_of(n))


def test_whisper_is_refused_by_the_engine_as_the_reference_engine_fails():
    """The JAX package's engine cannot admit whisper: prefill_into_slots
    runs the encoder on audio_frames=None (AttributeError). The port
    refuses it before anything is built or admitted, naming the missing
    audio_frames path: the engine, build_engine and a fleet tenant."""
    s = _setup("whisper-base")
    rcfg = s["rcfg"]
    pool = rlm.alloc_slot_pool(rcfg, 2, 16)
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'astype'"):
        rlm.prefill_into_slots(s["jp"], jnp.zeros((2, 8), jnp.int32), pool,
                               jnp.arange(2), 8, rcfg, pos_offset=jnp.zeros(2, jnp.int32))
    cfg = s["cfg"]
    for make in (lambda: build_engine(cfg, device="cpu", params=s["pt"]),
                 lambda: ServingEngine(cfg, LM(cfg, s["pt"]), None, device="cpu"),
                 lambda: build_multislice_engine(
                     n_slices=1, device="cpu",
                     tenants=[TenantSpec(cfg=cfg, name="whisper-base", n_slices=1)])):
        with pytest.raises(ValueError, match="audio_frames"):
            make()


@pytest.mark.parametrize("flags", [["--arch", "whisper-base"],
                                   ["--tenants", "tinyllama-1.1b:1,whisper-base:1"]],
                         ids=["arch", "tenants"])
def test_serve_launcher_refuses_whisper(flags, capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main([*flags, "--reduced", "--device", "cpu"])
    assert "audio_frames" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--arch", "jamba-v0.1-52b", "--continuous"],
    ["--arch", "phi-3-vision-4.2b"],
    ["--tenants", "tinyllama-1.1b:1,jamba-v0.1-52b:1", "--pipelined", "--preprocess",
     "dpu", "--clock", "virtual"],
], ids=["jamba-continuous", "phi3v-run-to-completion", "tenants-pipelined-dpu"])
def test_serve_launcher_serves_jamba_and_phi3_vision_on_the_cpu(flags, capsys):
    from repro_torch.launch.serve import main

    main([*flags, "--reduced", "--device", "cpu", "--requests", "4", "--max-new", "3"])
    assert "served 4 requests" in capsys.readouterr().out
