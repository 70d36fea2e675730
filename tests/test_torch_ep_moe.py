"""The port's sharded MoE layer on gloo ranks on the CPU, against the JAX
package's own `moe_shard_map` and, where the JAX package's `moe()` takes
its unsharded dispatch on a mesh, against that dispatch over the global
groups.

The reference runs in a subprocess with 8 host devices and a mesh built
with `axis_types=(AxisType.Auto,) * 2` (the mesh `jax.make_mesh` builds by
default on JAX 0.9 has Explicit axes, on which the reference's final
reshape fails; tests/test_moe.py's own subprocess test shows it). No file
of the JAX package changes. The port runs `layers.moe` on each rank's rows
(`steps.shard_batch`) and its shards of the layer's weights, cut by the
serve rules: experts over `data` when it divides them (EP mode), else
their d_model dim over `data` (weight-gather mode), hidden units over
`model`. Cases, on reduced mixtral (d_model 128, top 2) at fp32, each at
capacity 8.0 with groups of 16 tokens (no drops; several groups a data
rank) and at the default 1.25 with groups of up to 128 (drops, in local
groups of T / n_dp tokens where the unsharded layer groups all T):
  * EP: 4 experts at (2, 2) and (2, 1), 4 x 32 tokens;
  * weight-gather: 3 experts at (2, 2);
  * rows the data axes do not divide (1 x 64 tokens at (2, 2)): every data
    rank holds the row and routes its half of the tokens;
  * the JAX package's fallback (global groups): 4 x 1 tokens at (2, 2)
    (2 a data rank, under its minimum of 4) with the einsum dispatch, and
    the sort dispatch at 4 x 32 tokens, both against the reference's
    `moe_gshard_einsum`/`moe_sort` on the whole batch.
y is held within rtol = atol = 2e-5 (fp32; the sums run in another order
across ranks), the aux loss (the mean of the data ranks' losses) within
rtol 1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")

from repro_torch.launch import mesh as tmesh  # noqa: E402
from torch_tp_ranks import moe_layer_rank  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
AUX_RTOL = 1e-5
D = 128
# case: (mesh, n_experts, batch shape (B, S), the reference's dispatch,
# moe_impl); each runs at both capacities
CASES = {
    "ep-2x2": ((2, 2), 4, (4, 32), "shard_map", "einsum"),
    "ep-2x1": ((2, 1), 4, (4, 32), "shard_map", "einsum"),
    "wg-2x2": ((2, 2), 3, (4, 32), "shard_map", "einsum"),
    "rows-whole-2x2": ((2, 2), 4, (1, 64), "shard_map", "einsum"),
    "fallback-2x2": ((2, 2), 4, (4, 1), "einsum", "einsum"),
    "sort-2x2": ((2, 2), 4, (4, 32), "sort", "sort"),
}
# capacity: (capacity factor, moe_group_size)
CAPACITIES = {"nodrop": (8.0, 16), "drop": (1.25, 128)}

_REF_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro.configs import reduced
    from repro.distributed import ctx
    from repro.models import layers as L

    data = np.load(sys.argv[1])
    cases = json.loads(sys.argv[2])
    out = {}
    for name, (shape, fields, ref) in cases.items():
        cfg = dataclasses.replace(reduced("mixtral-8x22b"), **fields)
        x = data[name + "/x"]
        p = {k: data[f"{name}/{k}"] for k in ("router", "wi_gate", "wi_up", "wo")}
        if ref == "shard_map":
            n = shape[0] * shape[1]
            mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:n])
            with ctx.mesh_context(mesh), mesh:
                y, a = jax.jit(lambda x, p: L.moe_shard_map(x, p, cfg, mesh))(x, p)
        else:
            fn = L.moe_sort if ref == "sort" else L.moe_gshard_einsum
            y, a = jax.jit(lambda x, p: fn(x, p, cfg))(x, p)
        out[name + "/y"] = np.asarray(y)
        out[name + "/aux"] = np.asarray(a)
    np.savez(sys.argv[3], **out)
    print("REF_OK")
    """
)


def _case_data():
    """{case/capacity: (config fields, x, weights)}: numpy draws of seed 26.
    x has mean 1 and the router leans to expert 0, so that the routing is
    skewed and tokens drop at capacity 1.25."""
    rng = np.random.default_rng(26)
    out = {}
    for name, (shape, e, (b, s), ref, impl) in CASES.items():
        x = (1.0 + rng.standard_normal((b, s, D))).astype(np.float32)
        router = 0.3 * rng.standard_normal((D, e))
        router[:, 0] += 0.01
        w = {"router": router.astype(np.float32),
             "wi_gate": (0.05 * rng.standard_normal((e, D, 128))).astype(np.float32),
             "wi_up": (0.05 * rng.standard_normal((e, D, 128))).astype(np.float32),
             "wo": (0.05 * rng.standard_normal((e, 128, D))).astype(np.float32)}
        for cap_name, (cap, group) in CAPACITIES.items():
            fields = dict(n_experts=e, capacity_factor=cap, moe_group_size=group,
                          moe_impl=impl, dtype="float32")
            out[f"{name}/{cap_name}"] = (fields, x, w)
    return out


@pytest.fixture(scope="module")
def data():
    return _case_data()


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    """The JAX package's y and aux of every case, from one subprocess."""
    tmp = tmp_path_factory.mktemp("ep_moe")
    arrays, cases = {}, {}
    for key, (fields, x, w) in data.items():
        name = key.split("/")[0]
        arrays[key + "/x"] = x
        arrays.update({f"{key}/{k}": v for k, v in w.items()})
        cases[key] = (list(CASES[name][0]), fields, CASES[name][3])
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    run = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(tmp / "in.npz"),
                          json.dumps(cases), str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert "REF_OK" in run.stdout, run.stdout[-2000:] + run.stderr[-4000:]
    got = np.load(tmp / "out.npz")
    return {k: got[k] for k in got.files}


_SPAWNS = {}


def _ranks(shape, data):
    """Every case on mesh `shape`: one spawn a mesh."""
    if shape not in _SPAWNS:
        cases = {k: v for k, v in data.items() if CASES[k.split("/")[0]][0] == shape}
        _SPAWNS[shape] = tmesh.run_ranks(moe_layer_rank, shape[0] * shape[1], (shape, cases),
                                         device="cpu", timeout=240)
    return _SPAWNS[shape]


@pytest.mark.parametrize("cap", list(CAPACITIES))
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_moe_matches_reference(name, cap, data, reference):
    shape, e, (b, s), ref, impl = CASES[name]
    key = f"{name}/{cap}"
    want_y, want_aux = reference[key + "/y"], float(reference[key + "/aux"])
    ranks = _ranks(shape, data)
    n_dp = shape[0]
    cut = b % n_dp == 0
    for r in ranks:
        y, aux, ran_shard_map, leaf_shapes = r[key]
        # the JAX package's moe() rule: shard_map when T divides over the
        # data ranks with at least 4 tokens each (and the einsum dispatch)
        assert ran_shard_map == (ref == "shard_map"), (r["coord"], ran_shard_map)
        ep = e % n_dp == 0
        want_shape = (e // n_dp if ep else e, D if ep or n_dp == 1 else D // n_dp,
                      128 // shape[1])
        assert leaf_shapes["wi_gate"] == want_shape, (r["coord"], leaf_shapes)
        rows = slice(r["coord"][0] * (b // n_dp), (r["coord"][0] + 1) * (b // n_dp)) \
            if cut else slice(None)
        np.testing.assert_allclose(y, want_y[rows], **TOL, err_msg=f"{key} {r['coord']}")
        np.testing.assert_allclose(aux, want_aux, rtol=AUX_RTOL, err_msg=f"{key} {r['coord']}")


@pytest.mark.parametrize("name", ["ep-2x2", "wg-2x2"])
def test_drops_happen_and_local_groups_differ_from_global(name, data, reference):
    """At capacity 1.25 tokens drop (the output differs from the no-drop
    one), and the local groups' drops differ from the global einsum's: the
    sharded layer is held to the reference's moe_shard_map, not to the
    unsharded einsum, by design."""
    import torch

    from repro_torch.configs import reduced
    from repro_torch.models import layers as PL

    fields, x, w = data[f"{name}/drop"]
    assert not np.allclose(reference[f"{name}/drop/y"], reference[f"{name}/nodrop/y"],
                           rtol=1e-3, atol=1e-3)
    import dataclasses

    cfg = dataclasses.replace(reduced("mixtral-8x22b"), **fields)
    y, _ = PL.moe_gshard_einsum(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                      for k, v in w.items()}, cfg)
    assert not np.allclose(y.numpy(), reference[f"{name}/drop/y"], rtol=1e-3, atol=1e-3)


def test_collectives_sum_contiguous_fp32():
    """What a collective sums is contiguous (NCCL refuses anything else; an
    einsum's output, such as the experts' before their reduce-scatter, may
    be a permuted view) and fp32 for 16-bit inputs."""
    import torch

    from repro_torch.distributed import ctx

    for dt in (torch.bfloat16, torch.float32):
        x = torch.arange(12, dtype=dt).reshape(3, 4).t()
        assert not x.is_contiguous()
        y = ctx._summable(x)
        assert y.is_contiguous() and y.dtype == torch.float32
        assert torch.equal(y, x.float())
