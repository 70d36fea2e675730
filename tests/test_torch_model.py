"""The PyTorch package's dense LM against the JAX package, on the CPU.

Reduced tinyllama at an fp32 override. The port never draws its own weights
in a comparison: the JAX package's tree (api.init_params) is carried across
leaf by leaf with models.params.from_reference. Prefill logits are held at
rtol/atol 1e-4; greedy tokens from prefill_into_slots + decode_segment must
be equal. Within the port: padded == unpadded, and a request that joins a
busy pool decodes as it would alone.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import lm, params as tparams  # noqa: E402
from repro_torch.models.api import LM  # noqa: E402

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def setup():
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    tree = jax.tree.map(np.asarray, jparams)
    p = tparams.from_reference(tree, cfg, "cpu", "float32")
    return rcfg, cfg, jparams, p


def _prompts(cfg, lens, lp, seed=0):
    """Left-padded [B, lp] prompt block and its offsets."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), lp), np.int32)
    off = np.array([lp - n for n in lens], np.int32)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = rng.integers(0, cfg.vocab, n)
    return toks, off


@pytest.mark.parametrize("arch", [ARCH])
@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_reference(arch, reduce):
    from repro.configs import get_config as ref_get

    ref = ref_reduced(arch) if reduce else ref_get(arch)
    got = reduced(arch) if reduce else get_config(arch)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.param_count() == ref.param_count()


def test_param_tree_matches_reference(setup):
    rcfg, cfg, jparams, p = setup
    ref = dict(tparams.leaves(jax.tree.map(lambda a: a.shape, jparams,
                                           is_leaf=lambda a: hasattr(a, "shape"))))
    mine = dict(tparams.leaves(p))
    assert ref.keys() == mine.keys()
    for k, t in mine.items():
        assert tuple(t.shape) == tuple(ref[k]) and t.dtype == torch.float32, k
    g = torch.Generator().manual_seed(0)
    seeded = dict(tparams.leaves(tparams.init_params(cfg, g, "cpu", "bfloat16")))
    assert {k: tuple(v.shape) for k, v in seeded.items()} == \
        {k: tuple(v) for k, v in ref.items()}
    assert all(v.dtype == torch.bfloat16 for v in seeded.values())
    assert torch.all(seeded["final_ln"] == 1)
    # the reference's init scales: 0.02, and 0.02/sqrt(2L) for output projections
    assert abs(seeded["embed"].float().std().item() - 0.02) < 2e-3
    assert abs(seeded["body.l0.ffn.wo"].float().std().item()
               - 0.02 / np.sqrt(2 * cfg.n_layers)) < 1e-3


def test_from_reference_rejects_a_mismatched_tree(setup):
    rcfg, cfg, jparams, p = setup
    tree = jax.tree.map(np.asarray, jparams)
    del tree["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        tparams.from_reference(tree, cfg, "cpu")


def test_prefill_logits_match_reference(setup):
    rcfg, cfg, jparams, p = setup
    toks, off = _prompts(cfg, [16, 11, 5], 16, seed=1)
    want, _ = jax.jit(functools.partial(rlm.prefill, cfg=rcfg, cache_len=16))(
        jparams, jnp.asarray(toks), pos_offset=jnp.asarray(off))
    got, _ = lm.prefill(p, torch.from_numpy(toks), cfg,
                        pos_offset=torch.from_numpy(off), cache_len=16)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the nn.Module runs the same function
    assert torch.equal(LM(cfg, p)(torch.from_numpy(toks), torch.from_numpy(off)), got)


def _pool_rows(toks, off, slots, clock):
    """Pool-row order of an admission: row slots[i] holds prompt i."""
    order = np.argsort(slots)
    poff = (clock - (toks.shape[1] - off.astype(np.int64)))[order]
    return order, poff


def _ref_serve(rcfg, jparams, toks, off, slots, clock, steps, pool_len):
    """Reference: admit the block into pool rows `slots`, then one segment;
    returns [B, 1 + steps] tokens in prompt order."""
    pool = rlm.alloc_slot_pool(rcfg, toks.shape[0], pool_len)
    tok0, pool = rlm.prefill_into_slots(jparams, jnp.asarray(toks), pool,
                                        jnp.asarray(slots, jnp.int32), jnp.int32(clock),
                                        rcfg, pos_offset=jnp.asarray(off))
    order, poff = _pool_rows(toks, off, slots, clock)
    seg = jax.jit(functools.partial(rlm.decode_segment, cfg=rcfg, steps=steps))
    rest, _ = seg(jparams, pool, tok0[order], jnp.int32(clock),
                  pos_offset=jnp.asarray(poff, jnp.int32))
    rest = np.asarray(rest)[np.argsort(order)]
    return np.concatenate([np.asarray(tok0), rest], axis=1)


def _port_serve(cfg, p, toks, off, slots, clock, steps, pool_len):
    pool = lm.alloc_slot_pool(cfg, toks.shape[0], pool_len, torch.device("cpu"))
    tok0, pool = lm.prefill_into_slots(p, torch.from_numpy(toks).long(), pool,
                                       torch.as_tensor(slots).long(), clock, cfg,
                                       pos_offset=torch.from_numpy(off).long())
    order, poff = _pool_rows(toks, off, np.asarray(slots), clock)
    rest, _ = lm.decode_segment(p, pool, tok0[order], clock, cfg, steps=steps,
                                pos_offset=torch.from_numpy(poff))
    rest = rest[np.argsort(order)]
    return torch.cat([tok0, rest], dim=1).numpy()


def test_greedy_tokens_match_reference(setup):
    """prefill_into_slots + decode_segment over a slot pool: the same greedy
    tokens as the JAX package, exactly."""
    rcfg, cfg, jparams, p = setup
    toks, off = _prompts(cfg, [16, 9, 13, 3], 16, seed=2)
    slots = np.array([2, 0, 3, 1], np.int32)
    want = _ref_serve(rcfg, jparams, toks, off, slots, 32, 8, 40)
    got = _port_serve(cfg, p, toks, off, slots, 32, 8, 40)
    np.testing.assert_array_equal(got, want)


def test_padded_equals_unpadded(setup):
    """A prompt alone at its own length == the same prompt left-padded into
    a larger bucket next to other rows: logits and greedy tokens."""
    rcfg, cfg, jparams, p = setup
    toks, off = _prompts(cfg, [7, 16, 12], 16, seed=3)
    alone = torch.from_numpy(toks[:1, 9:]).long()
    la, _ = lm.prefill(p, alone, cfg)
    lb, _ = lm.prefill(p, torch.from_numpy(toks).long(), cfg,
                       pos_offset=torch.from_numpy(off).long())
    assert_allclose(lb[0].numpy(), la[0].numpy(), rtol=1e-5, atol=1e-5)
    got = _port_serve(cfg, p, toks, off, np.arange(3), 16, 6, 32)
    solo = _port_serve(cfg, p, toks[:1, 9:], np.zeros(1, np.int32),
                       np.zeros(1, np.int64), 16, 6, 32)
    np.testing.assert_array_equal(got[0], solo[0])


def test_request_joining_a_busy_pool_decodes_as_alone(setup):
    """Request B admitted into the pool while A is mid-decode (another
    clock, another slot, another bucket) yields the tokens B gets alone."""
    rcfg, cfg, jparams, p = setup
    dev = torch.device("cpu")
    ta, oa = _prompts(cfg, [14], 16, seed=4)
    tb, ob = _prompts(cfg, [5], 8, seed=5)
    solo = _port_serve(cfg, p, tb, ob, np.zeros(1, np.int64), 8, 5, 40)

    pool = lm.alloc_slot_pool(cfg, 2, 40, dev)
    clock = 16
    t0a, pool = lm.prefill_into_slots(p, torch.from_numpy(ta).long(), pool,
                                      torch.tensor([0]), clock, cfg,
                                      pos_offset=torch.from_numpy(oa).long())
    poff = torch.tensor([clock - 14, 0])
    tok = torch.cat([t0a, torch.zeros(1, 1, dtype=torch.long)])
    seg, pool = lm.decode_segment(p, pool, tok, clock, cfg, steps=3, pos_offset=poff)
    clock += 3
    t0b, pool = lm.prefill_into_slots(p, torch.from_numpy(tb).long(), pool,
                                      torch.tensor([1]), clock, cfg,
                                      pos_offset=torch.from_numpy(ob).long())
    poff[1] = clock - 5
    tok = torch.stack([seg[0, -1:], t0b[0]])
    rest, _ = lm.decode_segment(p, pool, tok, clock, cfg, steps=5, pos_offset=poff)
    joined = torch.cat([t0b[0], rest[1]]).numpy()
    np.testing.assert_array_equal(joined, solo[0])
