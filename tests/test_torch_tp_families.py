"""Tensor-parallel serving of the MoE, SSM and hybrid families on gloo ranks
on the CPU, against the unsharded port and the JAX package.

The Mamba2 block: `ssm_block` over a 2 x 24 prompt (chunk 16, so the SSD
scan pads) with its final state, then three `ssm_block_decode` steps, at tp
2 and 4 on the ranks' shards of one layer of reduced mamba2 (d_inner 256,
16 heads, conv_dim 288: at tp 2 rank 1's 144 conv channels are x[144:256]
and all of B and C), against the JAX package's `ssm_block` and
`ssm_block_decode` on the same weights and inputs: outputs within rtol =
atol = 2e-5, and each rank's conv tail and SSM state equal to its cut of
the reference's (conv channels and heads over `model`).

The whole model: reduced mixtral (4 experts, window 16: the ring wraps),
mixtral with 3 experts (the weight-gather mode at a data axis of 2),
moonshot (a dense first layer, shared experts), mamba2 and jamba (one
8-layer block: attention, SSM, MoE and MLP layers) at fp32 with capacity
8.0, so that no token drops in the local groups or the global ones, with
the JAX package's seed-0 weights. Meshes: (2, 2) for the MoE and hybrid
models (moonshot and jamba at 4 experts and mixtral in EP mode, mixtral-wg
in weight-gather mode), (1, 2) for moonshot and mamba2, (1, 4) for
mamba2. Each rank cuts the weights (whole and streamed leaf by leaf, bit
for bit the same), runs `sharded_prefill` on its rows of 4 x 16 prompts and
8 `sharded_decode` steps fed the reference's greedy tokens. Checked: the
shards' shapes are the JAX package's PartitionSpec cuts, weights and
caches; the logits equal the unsharded port's within rtol = atol = 1e-5
and the JAX package's within rtol = atol = 1e-4; the greedy tokens equal
the JAX package's. Reduced configs are under 1B parameters, which takes
the small-serve layout for every family but the SSM one, so the ranks (and
the expected specs) force `sharding._small_serve` off, as
tests/test_torch_tp_serve.py does.
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
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.params import _ssm_defs, from_reference  # noqa: E402
from torch_tp_ranks import (FAMILY_CONFIGS, PROMPT, ROWS, STEPS, config,  # noqa: E402
                            port_run, serve_rank, ssm_block_rank)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)        # sharded vs unsharded port, fp32
REF_TOL = dict(rtol=1e-4, atol=1e-4)    # sharded port vs the JAX package, fp32
SSM_TOL = dict(rtol=2e-5, atol=2e-5)    # the sharded block vs the JAX package's
MESHES = {(2, 2): ("mixtral", "mixtral-wg", "moonshot", "jamba"),
          (1, 2): ("moonshot", "mamba2"),
          (1, 4): ("mamba2",)}
CASES = [(shape, name) for shape, names in MESHES.items() for name in names]
R_PREFILL = jax.jit(rlm.prefill, static_argnums=(2,), static_argnames=("cache_len",))
R_DECODE = jax.jit(rlm.decode, static_argnums=(4,))


def _ref_cfg(name):
    arch, fields = FAMILY_CONFIGS[name]
    return dataclasses.replace(ref_reduced(arch), dtype="float32", **fields)


class FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _ref_run(name):
    """The JAX package's seed-0 weights (numpy), the prompts, and its
    prefill + greedy decode: tokens [ROWS, 1 + STEPS] and logits [1 + STEPS,
    ROWS, V]."""
    rcfg = _ref_cfg(name)
    jp = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(15).integers(0, rcfg.vocab, (ROWS, PROMPT))
    logits, cache = R_PREFILL(jp, jax.numpy.asarray(prompts), rcfg, cache_len=PROMPT + STEPS)
    toks, out = [np.asarray(jax.numpy.argmax(logits, -1))], [np.asarray(logits[:, 0])]
    for i in range(STEPS):
        logits, cache = R_DECODE(jp, cache, jax.numpy.asarray(toks[-1]),
                                 jax.numpy.int32(PROMPT + i), rcfg)
        toks.append(np.asarray(jax.numpy.argmax(logits, -1)))
        out.append(np.asarray(logits[:, 0]))
    return (jax.tree.map(np.asarray, jp), prompts, np.concatenate(toks, axis=1),
            np.stack(out))


@pytest.fixture(scope="module")
def refs():
    return {name: _ref_run(name) for name in FAMILY_CONFIGS}


_SPAWNS = {}


def _ranks(shape, refs):
    if shape not in _SPAWNS:
        mine = {n: (jp, prompts, None, toks) for n, (jp, prompts, toks, _) in refs.items()
                if n in MESHES[shape]}
        _SPAWNS[shape] = tmesh.run_ranks(serve_rank, shape[0] * shape[1], (shape, mine),
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


@pytest.mark.parametrize("shape,name", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{n}" for s, n in CASES])
def test_sharded_family_matches_unsharded_and_reference(shape, name, refs, monkeypatch):
    sizes = {"data": shape[0], "model": shape[1]}
    monkeypatch.setattr(rshd, "_small_serve", lambda cfg: False)   # as the ranks do
    ranks = _ranks(shape, refs)
    rows = ROWS // shape[0]
    jp, prompts, toks, ref_logits = refs[name]
    cfg, rcfg = config(name), _ref_cfg(name)
    want, _ = port_run(from_reference(jp, cfg, "cpu"), torch.from_numpy(prompts),
                       torch.from_numpy(toks), steps.make_prefill(cfg), steps.make_decode(cfg))
    rscfg = ref_serve_config(rcfg, shape[1])
    rules = rshd.serve_rules(FakeMesh(sizes), rscfg)
    want_params = _cut_shapes(rapi.param_specs(rscfg), rapi.param_axes(rscfg), rules, sizes)
    want_cache = _cut_shapes(rapi.cache_specs(rscfg, ROWS, PROMPT + STEPS),
                             rapi.cache_axes(rscfg, ROWS, PROMPT + STEPS), rules, sizes)
    for r in ranks:
        got = r[name]
        assert got["streamed_equal"], r["coord"]
        assert got["params"] == want_params, r["coord"]
        assert got["cache"] == want_cache, r["coord"]
        sl = slice(r["coord"][0] * rows, (r["coord"][0] + 1) * rows)
        np.testing.assert_allclose(got["logits"], want[:, sl], **TOL, err_msg=str(r["coord"]))
        np.testing.assert_allclose(got["logits"], ref_logits[:, sl], **REF_TOL,
                                   err_msg=str(r["coord"]))
        np.testing.assert_array_equal(got["logits"].argmax(-1).T, toks[sl],
                                      err_msg=str(r["coord"]))


def test_moe_cut_is_the_mode_the_mesh_picks(refs):
    """On (2, 2): 4 experts cut over `data` (EP, 2 a rank); 3 experts keep
    all 3 and cut d_model over `data` (weight-gather); hidden units over
    `model` either way."""
    ranks = _ranks((2, 2), refs)
    leaf = "body.l0.ffn.wi_gate"   # [layers, E, d_model, F]
    for r in ranks:
        assert r["mixtral"]["params"][leaf][1:] == (2, 128, 64)
        assert r["mixtral-wg"]["params"][leaf][1:] == (3, 64, 64)
        assert r["moonshot"]["params"][leaf][1:] == (2, 128, 64)


# --- the Mamba2 block -------------------------------------------------------

SSM_B, SSM_L, SSM_DECODE = 2, 24, 3


@pytest.fixture(scope="module")
def ssm_case():
    """One layer's weights (numpy, seed 20; conv_b and dt_bias nonzero),
    the prompt and the decode inputs, and the JAX package's outputs."""
    cfg = config("mamba2")
    rcfg = _ref_cfg("mamba2")
    rng = np.random.default_rng(20)
    defs = _ssm_defs(cfg)
    params = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in defs.items() if k != "ln"}
    params["A_log"] = np.log(rng.uniform(1, 16, defs["A_log"].shape)).astype(np.float32)
    params["D"] = (1 + 0.1 * rng.standard_normal(defs["D"].shape)).astype(np.float32)
    params["norm_w"] = (1 + 0.1 * rng.standard_normal(defs["norm_w"].shape)).astype(np.float32)
    x = rng.standard_normal((SSM_B, SSM_L, cfg.d_model)).astype(np.float32)
    x1s = rng.standard_normal((SSM_DECODE, SSM_B, 1, cfg.d_model)).astype(np.float32)
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    y, (conv, state) = RL.ssm_block(jax.numpy.asarray(x), jp, rcfg, return_state=True)
    outs, convs, states = [], [np.asarray(conv)], [np.asarray(state)]
    for x1 in x1s:
        o, (conv, state) = RL.ssm_block_decode(jax.numpy.asarray(x1), jp, rcfg, conv, state)
        outs.append(np.asarray(o))
        convs.append(np.asarray(conv))
        states.append(np.asarray(state))
    return params, x, x1s, dict(y=np.asarray(y), decode=outs, conv=convs, state=states)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_ssm_block_matches_reference(tp, ssm_case):
    params, x, x1s, want = ssm_case
    cfg = config("mamba2")
    ranks = tmesh.run_ranks(ssm_block_rank, tp, ((1, tp), {}, params, x, x1s), device="cpu",
                            timeout=120)
    cd, h = cfg.conv_dim // tp, cfg.n_ssm_heads // tp
    for r in ranks:
        j = r["coord"][1]
        np.testing.assert_allclose(r["y"], want["y"], **SSM_TOL, err_msg=f"rank {j}")
        for i, o in enumerate(r["decode"]):
            np.testing.assert_allclose(o, want["decode"][i], **SSM_TOL,
                                       err_msg=f"rank {j} step {i}")
        for i, (c, s) in enumerate(zip(r["conv"], r["state"])):
            assert c.shape == (SSM_B, cfg.ssm_conv - 1, cd) and s.shape[1] == h
            np.testing.assert_allclose(c, want["conv"][i][..., j * cd:(j + 1) * cd], **SSM_TOL,
                                       err_msg=f"rank {j} conv {i}")
            np.testing.assert_allclose(s, want["state"][i][:, j * h:(j + 1) * h], **SSM_TOL,
                                       err_msg=f"rank {j} state {i}")
