"""The PyTorch package's engine modes against the JAX package's, on the CPU:
run-to-completion (with and without shape buckets and the fused generate),
chunked prefill at two chunk sizes, and the radix prefix KV cache; plus
the port's PrefixStore against the reference's, the runtime's chunk- and
prefix-aware service estimate, and the launcher's new modes.

Reduced tinyllama at an fp32 override, the JAX package's weights carried
across with models.params.from_reference. Per request, the greedy tokens
must be equal; so must the shape-cache and prefix-cache counters. Every
decode step here goes through `kernels.ops.decode_attention` on CPU tensors,
i.e. the decode kernel's plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.batching.buckets import Request as RRequest  # noqa: E402
from repro.core.prefix import PrefixStore as RPrefixStore  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving.runtime import PipelinedRuntime as RRuntime  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.core.prefix import PrefixStore  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import telemetry as tm  # noqa: E402
from repro_torch.serving.engine import EngineConfig, build_engine  # noqa: E402
from repro_torch.serving.runtime import PipelinedRuntime  # noqa: E402

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
# heavy-tailed prompt mix (two long, rest short), per-request budgets
SPEC = [(100, 8), (23, 5), (14, 9), (70, 6), (9, 12), (33, 7), (121, 4), (27, 3)]
SUFFIXES = [5, 11, 0, 23, 40, 3, 17, 9]   # template traffic (0 = bare template)
COUNTERS = ("batches", "admitted", "retired", "segments", "prefill_traces",
            "prefill_cache_hits", "generate_traces", "decode_step_traces",
            "segment_traces", "prefix_hits", "prefix_hit_tokens", "prefix_inserts",
            "prefix_prompt_tokens", "prefix_scatter_traces")


@pytest.fixture(scope="module")
def setup():
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    params = from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu", "float32")
    rng = np.random.default_rng(42)
    template = rng.integers(0, cfg.vocab, 80)
    prompts = [np.concatenate([template, rng.integers(0, cfg.vocab, n)]) if n
               else template.copy() for n in SUFFIXES]
    return dict(rcfg=rcfg, cfg=cfg, jparams=jparams, params=params, prompts=prompts)


def _spec_wave(cls, spec, rid0):
    return [cls(rid=rid0 + i, arrival=0.0, length=float(n), max_new_tokens=b)
            for i, (n, b) in enumerate(spec)]


def _template_wave(cls, prompts, wave):
    return [cls(rid=7000 + 100 * wave + i, arrival=0.0, length=float(len(p)),
                prompt=p.astype(np.int32), max_new_tokens=8)
            for i, p in enumerate(prompts)]


def _serve_both(setup, ec_kw, waves):
    """The same waves through the JAX engine and the port's; returns both
    engines and their {rid: tokens}."""
    reng = rengine.build_engine(setup["rcfg"], ec=rengine.EngineConfig(**ec_kw))
    reng.params = setup["jparams"]
    eng = build_engine(setup["cfg"], ec=EngineConfig(**ec_kw), device="cpu",
                       params=setup["params"])
    out = []
    for e, cls in ((reng, RRequest), (eng, Request)):
        for wave in waves:
            e.submit_many(wave(cls))
            e.run_until_idle()
        out.append({r.rid: np.asarray(r.payload) for r in e.completed})
    return reng, eng, out[0], out[1]


def _assert_same(reng, eng, ref, got, n):
    assert sorted(got) == sorted(ref) and len(got) == n
    for rid in ref:
        np.testing.assert_array_equal(got[rid], ref[rid])
    assert {k: eng.stats[k] for k in COUNTERS} == {k: reng.stats[k] for k in COUNTERS}


@pytest.mark.parametrize("fused_decode", [True, False])
@pytest.mark.parametrize("pad_buckets", [True, False])
def test_run_to_completion_matches_reference(setup, pad_buckets, fused_decode):
    """Two waves of formed batches (the second reuses the first's shapes):
    per-request tokens (truncated to their budgets) and the shape-cache
    counters equal the JAX engine's."""
    ec = dict(continuous=False, max_new_tokens=12, pad_buckets=pad_buckets,
              fused_decode=fused_decode)
    reng, eng, ref, got = _serve_both(setup, ec, [
        lambda cls: _spec_wave(cls, SPEC, 8000),
        lambda cls: _spec_wave(cls, SPEC[::-1], 9000)])
    _assert_same(reng, eng, ref, got, 2 * len(SPEC))
    assert eng.stats["batches"] >= 2
    assert eng.stats["decode_steps"] == 11 * eng.stats["batches"]
    assert eng.slots_in_use() == eng.slot_capacity() == 0 and not eng.busy()


@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_prefill_matches_reference(setup, chunk):
    """Chunked admission interleaved with decode segments: tokens equal the
    JAX engine's and the port's own monolithic admission."""
    ec = dict(continuous=True, max_slots=4, segment_len=4, max_new_tokens=12,
              max_prompt_len=128, chunk_lens=(chunk,))
    reng, eng, ref, got = _serve_both(setup, ec, [lambda cls: _spec_wave(cls, SPEC, 8000)])
    _assert_same(reng, eng, ref, got, len(SPEC))
    assert len(eng.tracer.of(tm.PREFILL_CHUNK)) > 0   # the chunk path ran
    mono = build_engine(setup["cfg"], ec=EngineConfig(**{**ec, "chunk_lens": ()}),
                        device="cpu", params=setup["params"])
    mono.submit_many(_spec_wave(Request, SPEC, 8000))
    for r in mono.run_until_idle():
        np.testing.assert_array_equal(np.asarray(r.payload), got[r.rid])


PREFIX_EC = dict(continuous=True, max_slots=4, segment_len=4, max_new_tokens=8,
                 max_prompt_len=128, chunk_lens=(8,), prefix_cache_bytes=64 << 20)


@pytest.fixture(scope="module")
def prefix_runs(setup):
    """Template traffic in two waves (the second re-sends every prompt)
    through both engines with the prefix cache on."""
    prompts = setup["prompts"]
    return _serve_both(setup, PREFIX_EC, [
        lambda cls: _template_wave(cls, prompts, 1),
        lambda cls: _template_wave(cls, prompts, 2)])


def test_prefix_cache_matches_reference(setup, prefix_runs):
    """The hits, hit tokens and inserts equal the JAX engine's, and every
    request's tokens equal both the reference's and a cold monolithic
    run's."""
    ec, prompts = PREFIX_EC, setup["prompts"]
    reng, eng, ref, got = prefix_runs
    _assert_same(reng, eng, ref, got, 2 * len(SUFFIXES))
    assert eng.stats["prefix_hits"] >= len(SUFFIXES)
    assert eng.stats["prefix_hit_tokens"] > 0
    assert eng.prefix_store.bytes_used <= eng.prefix_store.bytes_budget
    assert eng.prefix_lease_count() == 0
    assert all(r.first_token_at is not None for r in eng.completed)
    cold = build_engine(setup["cfg"], ec=EngineConfig(
        **{**ec, "chunk_lens": (), "prefix_cache_bytes": 0}),
        device="cpu", params=setup["params"])
    cold.submit_many(_template_wave(Request, prompts, 1))
    for r in cold.run_until_idle():
        np.testing.assert_array_equal(np.asarray(r.payload), got[r.rid])
        np.testing.assert_array_equal(np.asarray(r.payload), got[r.rid + 100])


def test_cancel_mid_chunk_releases_leases_and_spares_neighbours(setup):
    """New prompts that share the stored template hit it and resume several
    chunks before their end; cancelling one mid-prefill frees its slot and
    its lease, and the others' tokens equal a cold monolithic run's."""
    cfg, prompts = setup["cfg"], setup["prompts"]
    rng = np.random.default_rng(9)
    fresh = [np.concatenate([prompts[2], rng.integers(0, cfg.vocab, 40)]) for _ in range(3)]
    eng = build_engine(cfg, ec=EngineConfig(**PREFIX_EC), device="cpu",
                       params=setup["params"])
    eng.submit_many(_template_wave(Request, prompts, 1))
    eng.run_until_idle()
    eng.submit_many(_template_wave(Request, fresh, 2))
    victim = None
    for _ in range(50):
        eng.step(eng.batcher.next_deadline())
        leased = [st.req.rid for st in eng._slots if st is not None and not st.live
                  and st.req.rid in eng._prefix_leases]
        if leased:
            victim = leased[0]
            break
    assert victim is not None and eng.prefix_lease_count() > 0
    assert eng.cancel([victim]) == 1
    done = {r.rid: np.asarray(r.payload) for r in eng.run_until_idle() if r.rid >= 7200}
    assert victim not in done and len(done) == len(fresh) - 1
    assert eng.prefix_lease_count() == 0 and eng.slots_in_use() == 0
    cold = build_engine(cfg, ec=EngineConfig(**{**PREFIX_EC, "chunk_lens": (),
                                                "prefix_cache_bytes": 0}),
                        device="cpu", params=setup["params"])
    cold.submit_many(_template_wave(Request, fresh, 2))
    for r in cold.run_until_idle():
        if r.rid in done:
            np.testing.assert_array_equal(done[r.rid], np.asarray(r.payload))


def _store_ops(store, seed):
    """One seeded sequence of insert / lookup / kv_prefix / release / peek
    on a small budget (so eviction runs); returns everything observable."""
    rng = np.random.default_rng(seed)
    leases, log = [], []

    def kv(n):
        a = rng.standard_normal((2, n, 1, 2)).astype(np.float32)
        return {"body": {"l0": {"mixer": {"k": a, "v": -a}}}}

    for _ in range(300):
        op = rng.integers(0, 5)
        lp = int(rng.choice([16, 32]))
        toks = rng.integers(0, 3, int(rng.integers(1, 13)))
        if op == 0:
            log.append(("insert", store.insert(lp, toks, kv(len(toks)))))
        elif op == 1:
            lease = store.lookup(lp, toks)
            log.append(("lookup", None if lease is None else lease.match_len))
            if lease is not None:
                leases.append(lease)
                m = int(rng.integers(1, lease.match_len + 1))
                got = store.kv_prefix(lease, m)
                log.append(("kv", got["body"]["l0"]["mixer"]["k"].tobytes()))
        elif op == 2 and leases:
            store.release(leases.pop(int(rng.integers(0, len(leases)))))
        elif op == 3:
            log.append(("peek", store.peek(lp, toks)))
        log.append(("state", store.bytes_used, store.node_count(), dict(store.stats)))
    return log


def test_prefix_store_matches_reference():
    ref = _store_ops(RPrefixStore(30 * 8, 8), seed=11)
    got = _store_ops(PrefixStore(30 * 8, 8), seed=11)
    assert got == ref
    assert any(e[0] == "state" and e[3]["evictions"] > 0 for e in got)
    assert any(e[0] == "lookup" and e[1] for e in got)


def test_runtime_service_estimate_is_chunk_and_prefix_aware(setup, prefix_runs):
    """The front door's per-request estimate: prefill chunk calls for the
    request's bucket, less the calls its expected prefix hit skips, plus
    its segments — the JAX runtime's number on the same store."""
    prompts = setup["prompts"]
    reng, eng, _, _ = prefix_runs
    rrt, rt = RRuntime(reng), PipelinedRuntime(eng)
    rng = np.random.default_rng(3)
    cold_prompt = rng.integers(0, setup["cfg"].vocab, len(prompts[4])).astype(np.int32)
    for cls, runtime in ((RRequest, rrt), (Request, rt)):
        assert runtime.request_service_s(_template_wave(cls, prompts, 4)[4]) == 0.0
        runtime.seg_ema = 0.1
    est = []
    for cls, runtime in ((RRequest, rrt), (Request, rt)):
        warm = _template_wave(cls, prompts, 4)[4]
        cold = cls(rid=9999, arrival=0.0, length=warm.length, prompt=cold_prompt,
                   max_new_tokens=8)
        est.append((runtime.request_service_s(warm), runtime.request_service_s(cold)))
    assert est[1] == est[0]
    warm_s, cold_s = est[1]
    assert warm_s < cold_s == pytest.approx(0.1 * (128 // 8 + 2))


def test_generate_equals_sequential_decode(setup):
    """lm.generate's tokens are argmax(prefill) followed by the sequential
    decode() loop, token for token (left-padded bucket, masked rows)."""
    cfg, p = setup["cfg"], setup["params"]
    rng = np.random.default_rng(5)
    lens, lp, steps = [16, 9, 3], 16, 7
    toks = np.zeros((3, lp), np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = rng.integers(0, cfg.vocab, n)
    off = torch.tensor([lp - n for n in lens])
    logits, cache = lm.prefill(p, torch.from_numpy(toks), cfg, pos_offset=off,
                               cache_len=lp + steps)
    loop_cache = {"body": {"l0": {"mixer": {
        n: t.clone() for n, t in cache["body"]["l0"]["mixer"].items()}}}}
    got, _ = lm.generate(p, cache, logits, lp, cfg, steps=steps, pos_offset=off)
    tok = torch.argmax(logits, -1)
    want = [tok]
    for i in range(steps - 1):
        lg, loop_cache = lm.decode(p, loop_cache, tok, lp + i, cfg, pos_offset=off)
        tok = torch.argmax(lg, -1)
        want.append(tok)
    assert torch.equal(got, torch.cat(want, dim=1))


@pytest.mark.parametrize("flags", [[], ["--continuous", "--chunk-lens", "16,32"]])
def test_serve_launcher_modes_on_the_cpu(flags, capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "4", *flags])
    out = capsys.readouterr().out
    assert "served 4 requests in" in out
    assert ("segments" in out) == bool(flags)


def test_serve_launcher_refuses_bad_chunk_lens():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--arch", ARCH, "--reduced", "--device", "cpu", "--continuous",
              "--chunk-lens", "12"])
