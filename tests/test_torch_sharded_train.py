"""The sharded train step on gloo ranks on the CPU, against the JAX
package's train step.

Each mesh, (2, 2), (1, 4) and (4, 1) over ("data", "model"), is one spawn
of ranks (`launch.mesh.run_ranks`), run once and read by the tests below.
Every case starts from the JAX package's seed-0 weights of a reduced config
at fp32, cut by `steps.shard_train_state` under the train rules, and runs
two steps of `steps.make_sharded_train_step` on the rank's rows of two
batches (`steps.shard_train_batch`); the same batches go through the JAX
package's unsharded `make_train_step`, jitted. Cases (`TRAIN_CASES` in
tests/torch_tp_ranks.py): reduced tinyllama (4 heads, 2 KV heads, head_dim
32) on (2, 2), KV heads cut over `model` and d_model over `data` (FSDP);
on (1, 4), where 2 KV heads do not cut over 4 ranks so head_dim is cut, at
batch 2 with `attn_dp_axes` set (2 >= 4 / 2; q, k and v go to rows over
`model`, the 2 rows padded to 4) and at batch 4 in 4 microbatches (1 row a
microbatch, under 4 / 2: no batch-DP, head_dim gathered over `model`);
on (4, 1), FSDP alone; reduced h2o-danube (window 16) and phi-3-vision
(img_embeds) on (2, 2). Held as tests/test_torch_train_step.py holds the
one-device step: the metrics at rtol 2e-5 over two steps, the moments at
1e-4 of each leaf's magnitude, each weight leaf's update within a relative
L2 distance of 1e-3 of the reference's and no element off by more than 2 x
the summed learning rate. The batch-DP re-layout on against off on one
mesh at rtol 1e-5. Each rank's shards have the shapes the JAX package's
train PartitionSpecs give.

The (2, 2) spawn also runs `train()` on the mesh: 4 steps with a
checkpoint every 2, and again failing at step 3 and restarted; the losses
against the one-device loop's, the checkpoint files against the one-device
run's and restored into a one-device state. The (4, 1) spawn runs
`allreduce_compressed` over the data axis. A subprocess with 8 host
devices runs the JAX package's own sharded step (`make_train_step` with
`param_shardings`, jitted with the train shardings under `_train_cfg`) on
the (1, 4) mesh at batch 2, where its `constrain_batch_dp` pads the rows,
and its `allreduce_compressed` under `shard_map` over 4 data devices; the
port's agree with both.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core import steps as rsteps  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import optimizer as ropt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training.grad_compression import compress_grads  # noqa: E402
from torch_tp_ranks import (TRAIN_CASES, TRAIN_OPT, train_batches,  # noqa: E402
                            train_config, train_rank)
from torch_train_checks import check_state, train_cut_shapes  # noqa: E402

torch.set_num_threads(2)

METRIC_RTOL = 2e-5
DP_RTOL = 1e-5


def _ref_cfg(arch):
    return dataclasses.replace(ref_reduced(arch), dtype="float32")


def _weights(arch):
    return jax.tree.map(np.asarray, rapi.init_params(_ref_cfg(arch), jax.random.PRNGKey(0)))


def _batches(name):
    arch, _, b, s, _, _ = TRAIN_CASES[name]
    return train_batches(train_config(arch), b, s)


_REF = {}


def _reference(name):
    """The JAX package's unsharded train step, jitted, twice from its
    seed-0 weights: (metrics of each step, the state after, as numpy)."""
    arch, _, b, s, mb, _ = TRAIN_CASES[name]
    key = (arch, b, s, mb)
    if key not in _REF:
        jp = _weights(arch)
        rstep = jax.jit(rsteps.make_train_step(_ref_cfg(arch), ropt.OptConfig(**TRAIN_OPT),
                                               microbatches=mb))
        state = {"params": jp, "opt": ropt.init_opt_state(jp)}
        metrics = []
        for bt in _batches(name):
            state, m = rstep(state, {k: jnp.asarray(v) for k, v in bt.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        _REF[key] = (metrics, dict(leaves(jax.tree.map(np.asarray, state))))
    return _REF[key]


_SPAWNS = {}


def _compress_inputs():
    """Four ranks' gradient and error trees: numpy draws of seed 28."""
    rng = np.random.default_rng(28)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    g = [{k: (rng.standard_normal(s) * 10.0 ** -i).astype(np.float32)
          for i, (k, s) in enumerate(shapes.items())} for _ in range(4)]
    e = [{k: (1e-3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
         for _ in range(4)]
    return {"g": g, "e": e}


def _ranks(shape, tmp_path_factory):
    """The ranks' results on mesh `shape`: one spawn a mesh."""
    if shape not in _SPAWNS:
        cases = {name: (_weights(c[0]), _batches(name)) for name, c in TRAIN_CASES.items()
                 if c[1] == shape}
        loop = str(tmp_path_factory.mktemp("sharded_loop")) if shape == (2, 2) else None
        compress = _compress_inputs() if shape == (4, 1) else None
        _SPAWNS[shape] = (tmesh.run_ranks(train_rank, shape[0] * shape[1],
                                          (shape, cases, loop, compress), device="cpu",
                                          timeout=240), loop)
    return _SPAWNS[shape]


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_sharded_step_matches_reference(name, tmp_path_factory):
    arch, shape, b, _, mb, dp = TRAIN_CASES[name]
    ranks, _ = _ranks(shape, tmp_path_factory)
    assert [r["coord"] for r in ranks] == [[i, j] for i in range(shape[0])
                                          for j in range(shape[1])]
    want_metrics, want_state = _reference(name)
    init = dict(leaves(_weights(arch)))
    n_layers = train_config(arch).n_layers
    # the layout each case must take: batch-DP where the rule sets it on a
    # model axis wider than 1; else head_dim gathered where it is cut
    relayout = dp and shape[1] > 1 and b // mb >= shape[0] * shape[1] // 2
    hd_gather = not relayout and train_config(arch).n_kv_heads % shape[1] != 0
    want_shapes = train_cut_shapes(_ref_cfg(arch), shape)
    for r in ranks:
        got = r[name]
        assert got["shapes"] == want_shapes, r["coord"]
        # q, k and v a layer, each step (and again in each layer's recompute)
        assert (got["calls"]["rows_to_model"] > 0) == relayout, (r["coord"], got["calls"])
        assert (got["calls"]["split_model"] >= 2 * n_layers) == hd_gather, got["calls"]
        for m, w in zip(got["metrics"], want_metrics):
            assert set(m) == set(w)
            for k in m:
                assert_allclose(m[k], w[k], rtol=METRIC_RTOL, atol=1e-7,
                                err_msg=f"{name} {k} {r['coord']}")
    lr_sum = sum(m["lr"] for m in want_metrics)
    check_state(ranks[0][name]["state"], want_state, init, lr_sum)
    assert int(ranks[0][name]["state"]["opt.step"]) == 2


@pytest.mark.parametrize("shape,on,off", [((2, 2), "tinyllama-2x2", "tinyllama-2x2-dp-off"),
                                          ((1, 4), "tinyllama-1x4", "tinyllama-1x4-dp-off")])
def test_batch_dp_on_equals_off(shape, on, off, tmp_path_factory):
    """The batch-DP re-layout of q, k, v and the attention output changes
    where attention runs, not what it computes: losses and leaves agree."""
    ranks, _ = _ranks(shape, tmp_path_factory)
    for r in ranks:
        for a, b in zip(r[on]["metrics"], r[off]["metrics"]):
            for k in a:
                assert_allclose(a[k], b[k], rtol=DP_RTOL, atol=1e-7, err_msg=k)
    got_on, got_off = ranks[0][on]["state"], ranks[0][off]["state"]
    for path, v in got_on.items():
        assert_allclose(v, got_off[path], rtol=DP_RTOL,
                        atol=DP_RTOL * max(float(np.abs(v).max()), 1e-30), err_msg=path)


def test_sharded_train_loop_restarts_and_its_files_restore_unsharded(tmp_path_factory,
                                                                     tmp_path):
    """train() on (2, 2): 4 steps with a checkpoint every 2, and a run that
    fails at step 3 and restarts from the step-2 checkpoint. The losses
    equal the one-device loop's (the restart replays batches 0 and 1, in
    both: ROADMAP Queue 3); the checkpoints are the files a one-device run
    writes (leaf count, shapes, dtypes, tree) and restore into a one-device
    state with the leaves the mesh's run held."""
    ranks, loop_dir = _ranks((2, 2), tmp_path_factory)
    cfg = train_config("tinyllama-1.1b")
    dc = pipeline.DataConfig(global_batch=4, seq_len=16)

    def run(sub, **kw):
        tc = train_loop.TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path / sub),
                                        ckpt_every=2, log_every=100)
        return train_loop.train(cfg, dc, tc, device="cpu", **kw)

    whole = run("whole")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        run("restart", fail_at_step=3)
    again = run("restart")
    for r in ranks:
        got = r["loop"]
        assert got["failed"] == "injected failure at step 3"
        assert_allclose(got["losses"], whole["losses"], rtol=1e-4)
        assert len(got["restarted"]) == len(again["losses"]) == 2
        assert_allclose(got["restarted"], again["losses"], rtol=1e-4)
    sharded_dir = os.path.join(loop_dir, "whole")
    assert ckpt.latest_step(sharded_dir) == 4
    for sub in ("whole", "restart"):
        mine = json.loads(open(os.path.join(loop_dir, sub, "step_000000004",
                                            "manifest.json")).read())
        one = json.loads((tmp_path / sub / "step_000000004" / "manifest.json").read_text())
        for k in ("n_leaves", "treedef", "dtypes", "shapes", "step"):
            assert mine[k] == one[k], (sub, k)
    target = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    restored = dict(leaves(ckpt.restore_checkpoint(sharded_dir, target)))
    final = ranks[0]["loop"]["final"]
    assert restored.keys() == final.keys()
    for path, v in final.items():
        np.testing.assert_array_equal(restored[path].numpy(), v, err_msg=path)


_REF_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs import reduced
    from repro.core import steps
    from repro.distributed import ctx, sharding as shd
    from repro.models import api
    from repro.training import optimizer as ropt
    from repro.training.grad_compression import allreduce_compressed

    data = np.load(sys.argv[1])
    opt = json.loads(sys.argv[2])
    out = {}
    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), dtype="float32")
    mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    tcfg = steps._train_cfg(cfg, mesh, 2)
    out["attn_dp_axes"] = np.array(",".join(tcfg.attn_dp_axes))
    ss = steps.train_state_shardings(tcfg, mesh)
    rules = shd.train_rules(mesh, tcfg)
    batches = [{k: data[f"batch{i}/{k}"] for k in ("tokens", "labels")} for i in range(2)]
    bs = shd.batch_shardings({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                              for k, v in batches[0].items()}, rules, mesh)
    fn = steps.make_train_step(tcfg, ropt.OptConfig(**opt), 1, param_shardings=ss["params"])
    step = jax.jit(fn, in_shardings=(ss, bs), out_shardings=(ss, None))
    params = api.init_params(cfg, jax.random.PRNGKey(0))
    state = {"params": params, "opt": ropt.init_opt_state(params)}
    with ctx.mesh_context(mesh), mesh:
        state = jax.device_put(state, ss)
        for i, b in enumerate(batches):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            for k, v in m.items():
                out[f"metrics{i}/{k}"] = np.asarray(v)
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    for path, v in flat:
        out["state/" + ".".join(k.key for k in path)] = np.asarray(v)
    dmesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,),
                          devices=jax.devices()[:4])
    names = sorted({k.split("/")[1] for k in data.files if k.startswith("g/")})
    g = {k: data["g/" + k] for k in names}
    e = {k: data["e/" + k] for k in names}

    def body(g, e):
        avg, err = allreduce_compressed(jax.tree.map(lambda x: x[0], g),
                                        jax.tree.map(lambda x: x[0], e), "data")
        return avg, jax.tree.map(lambda x: x[None], err)

    f = ctx.shard_map(body, mesh=dmesh, in_specs=(P("data"), P("data")),
                      out_specs=(P(), P("data")))
    avg, err = jax.jit(f)(g, e)
    for k in names:
        out["avg/" + k] = np.asarray(avg[k])
        out["err/" + k] = np.asarray(err[k])
    np.savez(sys.argv[3], **out)
    print("REF_OK")
    """
)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's own sharded (1, 4) step at batch 2 and its
    allreduce_compressed over 4 data devices, from one subprocess."""
    tmp = tmp_path_factory.mktemp("sharded_ref")
    arrays = {f"batch{i}/{k}": v for i, b in enumerate(_batches("tinyllama-1x4"))
              for k, v in b.items()}
    c = _compress_inputs()
    for k in c["g"][0]:
        arrays["g/" + k] = np.stack([g[k] for g in c["g"]])
        arrays["e/" + k] = np.stack([e[k] for e in c["e"]])
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    run = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(tmp / "in.npz"),
                          json.dumps(TRAIN_OPT), str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert "REF_OK" in run.stdout, run.stdout[-2000:] + run.stderr[-4000:]
    got = np.load(tmp / "out.npz")
    return {k: got[k] for k in got.files}


def test_jax_sharded_step_agrees_with_the_port(jax_sharded, tmp_path_factory):
    """The JAX package's (1, 4) step, GSPMD padding its 2 batch-DP rows to
    4, against the port's (1, 4) step on the same weights and batches."""
    assert str(jax_sharded["attn_dp_axes"]) == "data,model"
    ranks, _ = _ranks((1, 4), tmp_path_factory)
    want_metrics, _ = _reference("tinyllama-1x4")
    got = ranks[0]["tinyllama-1x4"]
    for i in range(2):
        for k in ("loss", "nll", "grad_norm", "lr"):
            ref = float(jax_sharded[f"metrics{i}/{k}"])
            assert_allclose(got["metrics"][i][k], ref, rtol=METRIC_RTOL, err_msg=k)
            # the JAX package's own sharded and unsharded steps agree too
            assert_allclose(want_metrics[i][k], ref, rtol=METRIC_RTOL, err_msg=k)
    state = {k[len("state/"):]: v for k, v in jax_sharded.items() if k.startswith("state/")}
    init = dict(leaves(_weights("tinyllama-1.1b")))
    check_state(got["state"], state, init, sum(m["lr"] for m in want_metrics))


def test_allreduce_compressed_matches_reference(jax_sharded, tmp_path_factory):
    """allreduce_compressed over 4 gloo data ranks: bit for bit the formula
    on the ranks' own int8 values and scales (sum of int32 x max scale /
    n) and the rank's own new error state; against the JAX package's under
    shard_map, the average at rtol 1e-6 and the error state, a residual x -
    q s that cancels (XLA may contract it into one fused multiply-add), at
    1e-6 of each rank's largest |x|."""
    ranks, _ = _ranks((4, 1), tmp_path_factory)
    c = _compress_inputs()
    comp = [compress_grads({k: torch.from_numpy(v) for k, v in g.items()},
                           {k: torch.from_numpy(v) for k, v in e.items()})
            for g, e in zip(c["g"], c["e"])]
    for r in ranks:
        avg, err = r["compress"]
        i = r["coord"][0]
        for k in avg:
            total = sum(q[k].to(torch.int32) for q, _, _ in comp)
            s_max = torch.stack([s[k] for _, s, _ in comp]).max()
            np.testing.assert_array_equal(avg[k], (total.float() * s_max / 4).numpy(), k)
            np.testing.assert_array_equal(err[k], comp[i][2][k].numpy(), k)
            assert_allclose(avg[k], jax_sharded["avg/" + k], rtol=1e-6, err_msg=k)
            x = np.abs(c["g"][i][k] + c["e"][i][k]).max()
            assert_allclose(err[k], jax_sharded["err/" + k][i], rtol=1e-6, atol=1e-6 * x,
                            err_msg=k)


@pytest.mark.parametrize("arch,what", [("mixtral-8x22b", "MoE"),
                                       ("moonshot-v1-16b-a3b", "MoE"),
                                       ("mamba2-370m", "SSM"), ("jamba-v0.1-52b", "hybrid"),
                                       ("whisper-base", "encoder-decoder")])
def test_sharded_train_step_refuses_other_families_by_name(arch, what):
    """The sharded train step refuses no family by name: the MoE, SSM,
    hybrid and encoder-decoder families' full configs are taken on the
    production mesh's rules (16 x 16, and 2 x 16 x 16 with `pod`), their
    reduced configs on (2, 2), as the attention families' are. What it
    still refuses is a layout the model's collectives cannot close, naming
    the leaf: 2 KV heads on 3 model ranks, an SSM leaf's heads or an
    expert leaf's hidden units that 3 or 4 model ranks do not cut."""
    for mesh in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
        steps.make_sharded_train_step(get_config(arch), mesh)
    steps.make_sharded_train_step(reduced(arch), {"data": 2, "model": 2})
    assert get_config(arch).family == {"MoE": "moe", "SSM": "ssm", "hybrid": "hybrid",
                                       "encoder-decoder": "audio"}[what]
    for ok in ("tinyllama-1.1b", "h2o-danube-1.8b", "granite-3-8b", "yi-34b",
               "phi-3-vision-4.2b"):
        steps.make_sharded_train_step(get_config(ok), {"data": 16, "model": 16})
        steps.make_sharded_train_step(reduced(ok), {"data": 2, "model": 2})
    with pytest.raises(ValueError, match="is not cut over the model axis"):
        steps.make_sharded_train_step(reduced("tinyllama-1.1b"), {"data": 1, "model": 3})
    # 16 SSM heads on 3 model ranks; 130 expert hidden units on 4
    with pytest.raises(ValueError, match=r"mixer\.A_log dim 1 \(ssm_heads\) is not cut "
                                         "over the model axis"):
        steps.make_sharded_train_step(reduced("mamba2-370m"), {"data": 1, "model": 3})
    with pytest.raises(ValueError, match=r"ffn\.wi_gate dim 3 \(expert_mlp\) is not cut "
                                         "over the model axis"):
        steps.make_sharded_train_step(dataclasses.replace(reduced("mixtral-8x22b"),
                                                          moe_d_ff=130),
                                      {"data": 1, "model": 4})
