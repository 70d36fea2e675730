"""The PyTorch package's sharding rules, placements, serve configs and head
padding against the JAX package's, on the CPU, in one process (no ranks).

The rules take a mesh as axis sizes, so the production meshes (16 x 16 and
2 x 16 x 16) and the small ones the tensor-parallel tests run on ((1, 2),
(1, 4), (2, 2), (1, 8)) are checked without devices; the JAX side gets a
stand-in mesh with the same sizes (the JAX package's own test does this).
A placement tuple (one DTensor placement a mesh dim) is compared with the
JAX package's PartitionSpec (one mesh-axis entry a tensor dim) by turning
the spec into placements. The head-padded weights are compared bit for bit
on the JAX package's seed-0 weights, and the padded forward with the
unpadded one at fp32 (rtol 1e-5: the padded q slots and wo rows add exact
zeros, and only the products' shapes change).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

jax = pytest.importorskip("jax")

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs import serve_config as ref_serve_config  # noqa: E402
from repro.configs.base import shape_applicable as ref_shape_applicable  # noqa: E402
from repro.core import steps as rsteps  # noqa: E402
from repro.distributed import sharding as rshd  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models.serve_pad import pad_params_for_serve as ref_pad  # noqa: E402
from repro_torch.configs import (SHAPES, MODEL_ARCHS, get_config, reduced,  # noqa: E402
                                 serve_config, shape_applicable)
from repro_torch.core import steps  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import (cache_axes, cache_specs, from_reference,  # noqa: E402
                                       init_params, iter_params, leaves, param_axes,
                                       param_specs)
from repro_torch.models.serve_pad import pad_params_for_serve  # noqa: E402

torch.set_num_threads(1)

MESHES = [
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"data": 1, "model": 2},
    {"data": 1, "model": 4},
    {"data": 2, "model": 2},
    {"data": 1, "model": 8},
]
MESH_IDS = ["x".join(map(str, m.values())) for m in MESHES]
TPS = [1, 2, 4, 8, 16]


class FakeMesh:
    """The JAX package's mesh, as its rules and step configs read it."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _configs(arch):
    return [(get_config(arch), ref_get_config(arch)), (reduced(arch), ref_reduced(arch))]


def _same_config(mine, ref):
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def _ref_leaves(tree):
    """(path, leaf) of a JAX-package tree, tuples of axes kept whole."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {".".join(k.key for k in path): leaf for path, leaf in flat}


def _placements(spec, names):
    """A PartitionSpec's entries as placements, one a mesh axis."""
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def test_arch_lists_agree():
    assert sorted(MODEL_ARCHS) == sorted(ASSIGNED_ARCHS)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_param_and_cache_axes_match_reference(arch):
    """Every weight and cache leaf has the reference's logical axes, shape
    and type, leaf for leaf (the full and the reduced config); param_specs
    and cache_specs allocate nothing."""
    for cfg, rcfg in _configs(arch):
        assert dict(leaves(param_axes(cfg))) == _ref_leaves(rapi.param_axes(rcfg))
        got = dict(leaves(param_specs(cfg, dtype="bfloat16")))
        want = _ref_leaves(rapi.param_specs(rcfg, dtype="bfloat16"))
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.device.type == "meta" and tuple(t.shape) == want[k].shape, k
            assert t.dtype == torch.bfloat16
        for batch, cache_len in ((3, 24), (128, 32_768)):
            assert dict(leaves(cache_axes(cfg, batch, cache_len))) == \
                _ref_leaves(rapi.cache_axes(rcfg, batch, cache_len))
            got = dict(leaves(cache_specs(cfg, batch, cache_len)))
            want = _ref_leaves(rapi.cache_specs(rcfg, batch, cache_len))
            assert got.keys() == want.keys()
            for k, t in got.items():
                assert t.device.type == "meta", k
                assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == \
                    (want[k].shape, str(want[k].dtype)), k


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_slot_pool_is_cache_specs(arch):
    """The slot pool is the zero tree of cache_specs."""
    cfg = reduced(arch)
    pool = dict(leaves(lm.alloc_slot_pool(cfg, 3, 24, "cpu")))
    spec = dict(leaves(cache_specs(cfg, 3, 24)))
    assert pool.keys() == spec.keys()
    for k, t in pool.items():
        assert t.shape == spec[k].shape and t.dtype == spec[k].dtype and not t.any(), k


@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
def test_rules_match_reference(sizes):
    """train_rules and serve_rules, for every arch (full and reduced) and
    without a config, equal the reference's on the same mesh sizes."""
    fake = FakeMesh(sizes)
    assert shd.train_rules(sizes) == rshd.train_rules(fake)
    assert shd.serve_rules(sizes) == rshd.serve_rules(fake)
    for arch in MODEL_ARCHS:
        for cfg, rcfg in _configs(arch):
            assert shd.train_rules(sizes, cfg) == rshd.train_rules(fake, rcfg), arch
            assert shd.serve_rules(sizes, cfg) == rshd.serve_rules(fake, rcfg), arch
            assert shd._small_serve(cfg) == rshd._small_serve(rcfg), arch


@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
def test_placements_match_reference_specs(sizes):
    """The twin of the reference's test_spec_rules_divisible: every weight
    leaf of every arch under the train rules (the config) and the serve
    rules (serve_config at the mesh's model width), and every cache leaf at
    the decode_32k shape under the serve rules, gets the placements of the
    reference's PartitionSpec; a cut dim divides by its axes."""
    fake, names = FakeMesh(sizes), list(sizes)
    for arch in MODEL_ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        tp = sizes["model"]
        scfg, rscfg = serve_config(cfg, tp), ref_serve_config(rcfg, tp)
        cases = [(shd.train_rules, rshd.train_rules, cfg, rcfg),
                 (shd.serve_rules, rshd.serve_rules, scfg, rscfg)]
        for rules_fn, ref_rules_fn, c, rc in cases:
            rules, ref_rules = rules_fn(sizes, c), ref_rules_fn(fake, rc)
            axes = dict(leaves(param_axes(c)))
            got_tree = shd.tree_shardings(param_specs(c), param_axes(c), rules, sizes)
            for path, spec in leaves(param_specs(c)):
                want = rshd.spec_for(tuple(spec.shape), axes[path], ref_rules, fake)
                pl = shd.spec_for(spec.shape, axes[path], rules, sizes)
                assert pl == _placements(want, names), (arch, path, pl, want)
                assert dict(leaves(got_tree))[path] == pl
                for d, entry in enumerate(want):
                    if entry is not None:
                        assert spec.shape[d] % rshd._axis_size(fake, entry) == 0
        batch, seq = REF_SHAPES["decode_32k"].global_batch, REF_SHAPES["decode_32k"].seq_len
        rules, ref_rules = shd.serve_rules(sizes, scfg), rshd.serve_rules(fake, rscfg)
        axes = dict(leaves(cache_axes(scfg, batch, seq)))
        for path, spec in leaves(cache_specs(scfg, batch, seq)):
            want = rshd.spec_for(tuple(spec.shape), axes[path], ref_rules, fake)
            assert shd.spec_for(spec.shape, axes[path], rules, sizes) == \
                _placements(want, names), (arch, path)


def test_batch_and_scalar_placements_match_reference():
    for sizes in MESHES:
        fake, names = FakeMesh(sizes), list(sizes)
        rules = shd.serve_rules(sizes)
        assert shd.scalar_sharding(sizes) == (Replicate(),) * len(names)
        for shape in ((1, 1), (32, 1), (256, 4096), (128, 24, 80)):
            pl = shd.batch_shardings({"t": torch.empty(shape, device="meta")}, rules, sizes)["t"]
            want = rshd.spec_for(shape, ("batch",) + (None,) * (len(shape) - 1),
                                 rshd.serve_rules(fake), fake)
            assert pl == _placements(want, names), (sizes, shape)


def test_local_shard_cuts_major_to_minor():
    """A dim over ('pod', 'data') is cut with pod major: coordinate (p, q)
    holds chunk p * |data| + q; a replicated dim stays whole; a shard is a
    view."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    t = torch.arange(8 * 6).reshape(8, 6)
    pl = (Shard(0), Shard(0), Shard(1))
    for p in range(2):
        for q in range(2):
            for m in range(2):
                got = shd.local_shard(t, pl, sizes, (p, q, m))
                k = p * 2 + q
                assert torch.equal(got, t[2 * k:2 * k + 2, 3 * m:3 * m + 3])
                assert got.data_ptr() >= t.data_ptr()
    assert torch.equal(shd.local_shard(t, (Replicate(),) * 3, sizes, (1, 1, 1)), t)
    with pytest.raises(ValueError, match="two dims"):
        shd.spec_for((16, 16), ("mlp", "vocab"), shd.serve_rules({"data": 1, "model": 2}),
                     {"data": 1, "model": 2})


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_serve_config_matches_reference(arch):
    """serve_config at tp 1-16 equals the reference's field for field, for
    the full and the reduced config and an awkward 6-head, 3-KV-head one;
    where the reference raises, so does the port, with its message."""
    odd = dict(n_heads=6, n_kv_heads=3, head_dim=16)
    pairs = _configs(arch) + [(dataclasses.replace(reduced(arch), **odd),
                               dataclasses.replace(ref_reduced(arch), **odd))]
    for cfg, rcfg in pairs:
        for tp in TPS:
            try:
                want = ref_serve_config(rcfg, tp)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    serve_config(cfg, tp)
                assert str(got.value) == str(e)
                continue
            _same_config(serve_config(cfg, tp), want)


def test_shapes_and_applicability_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for arch in MODEL_ARCHS:
        for cfg, rcfg in _configs(arch):
            for name in SHAPES:
                assert shape_applicable(cfg, SHAPES[name]) == \
                    ref_shape_applicable(rcfg, REF_SHAPES[name]), (arch, name)


def _ref_only_fields(ref):
    """The fields of a JAX-package config that the port's ModelConfig does
    not have (its distribution knobs), by name."""
    mine = {f.name for f in dataclasses.fields(get_config("tinyllama-1.1b"))}
    return {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref) if f.name not in mine}


@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
def test_step_configs_match_reference(sizes):
    """_serve_cfg equals the reference's for every arch, field for field,
    and so does _train_cfg (at batches below, at and above half the mesh),
    whose attn_dp_axes is _train_fields'; the other distribution fields the
    reference's _serve_cfg and _train_cfg set are _moe_fields and
    _train_fields, name for name and value for value."""
    fake = FakeMesh(sizes)
    n = int(np.prod(list(sizes.values())))
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    for arch in MODEL_ARCHS:
        for cfg, rcfg in _configs(arch):
            rserve = rsteps._serve_cfg(rcfg, fake)
            _same_config(steps._serve_cfg(cfg, sizes), rserve)
            assert _ref_only_fields(rserve) == \
                dict(_ref_only_fields(rcfg), **steps._moe_fields(cfg, sizes, dp)), arch
            for batch in sorted({1, max(1, n // 2 - 1), n // 2, 256}):
                rtrain = rsteps._train_cfg(rcfg, fake, batch)
                tcfg = steps._train_cfg(cfg, sizes, batch)
                _same_config(tcfg, rtrain)
                fields = steps._train_fields(cfg, sizes, batch)
                assert tcfg.attn_dp_axes == fields.get("attn_dp_axes", ()), (arch, batch)
                assert _ref_only_fields(rtrain) == dict(
                    _ref_only_fields(rcfg),
                    **{k: v for k, v in fields.items() if k != "attn_dp_axes"}), (arch, batch)


def test_train_state_specs_and_shardings():
    """The train state's specs and placements: the reference's shapes,
    fp32 moments, an int32 step, and the moments placed as the weights."""
    sizes = {"data": 16, "model": 16}
    for arch in ("tinyllama-1.1b", "mixtral-8x22b"):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        spec = steps.train_state_specs(cfg)
        ref = rsteps.train_state_specs(rcfg)
        assert {k: tuple(v.shape) for k, v in leaves(spec["opt"]["mu"])} == \
            {k: v.shape for k, v in _ref_leaves(ref["opt"]["mu"]).items()}
        assert spec["opt"]["step"].dtype == torch.int32 and spec["opt"]["step"].shape == ()
        assert all(v.dtype == torch.float32 for _, v in leaves(spec["opt"]["nu"]))
        sh = steps.train_state_shardings(cfg, sizes)
        assert sh["opt"]["mu"] == sh["params"] == sh["opt"]["nu"]
        assert sh["opt"]["step"] == (Replicate(), Replicate())


def _awkward(arch):
    """A reduced config with the yi-like head ratio (6 heads, 2 KV heads,
    g = 3), at fp32."""
    kw = dict(n_heads=6, n_kv_heads=2, head_dim=16, dtype="float32")
    return dataclasses.replace(reduced(arch), **kw), dataclasses.replace(ref_reduced(arch), **kw)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "yi-34b"])
@pytest.mark.parametrize("tp", [2, 4])
def test_pad_params_for_serve_matches_reference(arch, tp):
    """The padded weights of the reference's seed-0 tree, carried across,
    equal the reference's padded tree bit for bit; the padded forward equals
    the unpadded one at fp32 (the twin of test_padded_serve_params_exact)."""
    cfg, rcfg = _awkward(arch)
    jp = rapi.init_params(rcfg, jax.random.PRNGKey(0))
    rscfg, rpadded = ref_pad(jp, rcfg, tp=tp)
    params = from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    scfg, padded = pad_params_for_serve(params, cfg, tp)
    _same_config(scfg, rscfg)
    want = dict(leaves(jax.tree.map(np.asarray, rpadded)))
    got = dict(leaves(padded))
    assert got.keys() == want.keys()
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    if tp == 4:
        assert scfg.n_kv_heads == 4 and scfg.n_heads == 8          # 2 zero q slots
    else:
        assert padded is params                                    # kv 2 % 2 == 0
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)))
    x1, _ = lm.forward(params, toks, cfg, mode="train")
    x2, _ = lm.forward(padded, toks, scfg, mode="train")
    torch.testing.assert_close(x2, x1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 4}, {"data": 2, "model": 2}],
                         ids=["1x4", "2x2"])
def test_shard_params_leaf_by_leaf(sizes, monkeypatch):
    """shard_params over a stream of leaves drawn one at a time
    (iter_params, init_params' bits) gives, for every rank of the mesh, the
    bits of shard_params over the whole tree: the yi-like heads, padded at
    model 4. Each cut shard owns its storage; a tree missing a leaf is
    refused by name."""
    monkeypatch.setattr(shd, "_small_serve", lambda cfg: False)   # the head layout
    cfg = _awkward("tinyllama-1.1b")[0]
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    streamed = list(iter_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert [k for k, _ in streamed] == [k for k, _ in leaves(full)]
    assert all(torch.equal(v, w) for (_, v), (_, w) in zip(leaves(full), streamed))
    whole = dict(leaves(full))
    for coord in itertools.product(*(range(n) for n in sizes.values())):
        a = dict(leaves(steps.shard_params(full, cfg, sizes, coordinate=coord)))
        b = dict(leaves(steps.shard_params(
            iter_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, sizes,
            coordinate=coord)))
        assert a.keys() == b.keys() == whole.keys()
        for k, t in a.items():
            assert torch.equal(t, b[k]), (coord, k)
            assert t.is_contiguous(), (coord, k)
            if t.shape != whole[k].shape:
                assert t.untyped_storage().data_ptr() != \
                    whole[k].untyped_storage().data_ptr(), (coord, k)
    del full["final_ln"]
    with pytest.raises(ValueError, match="final_ln"):
        steps.shard_params(full, cfg, sizes, coordinate=(0, 0))
