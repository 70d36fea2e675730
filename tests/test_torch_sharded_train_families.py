"""The sharded train step of the MoE, SSM, hybrid and encoder-decoder
families on gloo ranks on the CPU, against the JAX package's own sharded
train step.

Each mesh, (2, 2) and (1, 4) over ("data", "model") and (2, 2, 1) over
("pod", "data", "model"), is one spawn of ranks (`launch.mesh.run_ranks`),
run once and read by the tests below. Every
case (`FAMILY_TRAIN_CASES` in tests/torch_tp_ranks.py) starts from the JAX
package's seed-0 weights of a reduced config at fp32, cut by
`steps.shard_train_state` under the train rules, and runs two steps of
`steps.make_sharded_train_step` on the rank's rows of two batches
(`steps.shard_train_batch`). The cases: reduced moonshot (4 experts over 2
data ranks: expert parallel, `moe_shard_map`'s all-to-alls; 2 shared
experts; a dense first layer), mixtral with 3 experts (weight-gather: the
experts' d_model cut over `data`, gathered per product), mamba2 at (1, 4)
and (2, 2) (the Mamba2 block's channels and heads over `model`), jamba in
2 microbatches (attention, SSM and MoE layers), whisper-base (the encoder
under FSDP, cross-attention) and moonshot with the sort dispatch (the
MoE's global groups: rows gathered over the data axes, each rank's
experts summed over `data`, whose backward sums the ranks' gradients, and
the router loss counted once); on (2, 2, 1) moonshot in EP (the experts
over `data`, their gradients summed over `pod`) and mixtral with 3
experts (d_model over `pod` and `data`), the MoE groups over both.

The same weights and batches go through the JAX package in a subprocess
with 8 host devices, started before the ranks and read after them. MoE
routing runs in each data rank's own groups in both packages, so where
tokens drop the sharded step differs from the unsharded one by design
(ROADMAP Queue 3 E2), and the router loss is the mean of the data ranks'
losses: an MoE case is held to the JAX package's own sharded step on its
mesh (`make_train_step` with `param_shardings`, jitted with the train
shardings under `_train_cfg`, on a mesh of `AxisType.Auto` axes), at the
config's own capacity. mamba2 and whisper-base route nothing: each is
held to the JAX package's jitted unsharded step, one run an arch. The
reference is jitted with `remat=False` (a third less compile time; its
remat changes no value, and the port's ranks recompute every layer). Held
as tests/test_torch_sharded_train.py holds the attention families: the
metrics at rtol 2e-5 over two steps, the moments at 1e-4 of each leaf's
magnitude, each weight leaf's update within a relative L2 distance of
1e-3 of the reference's (an element off by at most one ulp of the
weight, the rounding of the weight's update, counting as equal:
`torch_train_checks.check_state`) and no element off by more than 2 x the summed learning
rate. Each rank's shards have the shapes the JAX package's train
PartitionSpecs give.

The (2, 2) spawn also runs `train()` of reduced moonshot on the mesh: 4
steps with a checkpoint every 2, and again failing at step 3 and
restarted, against the one-device loop; the checkpoint files against the
one-device run's, restored into a one-device state. That config routes
groups of 32 tokens, which are the same groups on one device and on 2
data ranks of 32 tokens each, and weighs the router loss 0: a mesh's
router loss is the mean of the data ranks' losses over their own tokens,
which differs from one device's loss over all of them in both packages.
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

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from torch_tp_ranks import (FAMILY_TRAIN_CASES, TRAIN_OPT, family_loop_config,  # noqa: E402
                            family_train_config, family_train_rank, train_batches)
from torch_train_checks import check_state, train_cut_shapes  # noqa: E402

torch.set_num_threads(2)

METRIC_RTOL = 2e-5


def _ref_cfg(name):
    arch, *_, fields = FAMILY_TRAIN_CASES[name]
    return dataclasses.replace(ref_reduced(arch), dtype="float32", **fields)


def _weights(name):
    return jax.tree.map(np.asarray, rapi.init_params(_ref_cfg(name), jax.random.PRNGKey(0)))


def _batches(name):
    _, _, b, s, _, _ = FAMILY_TRAIN_CASES[name]
    return train_batches(family_train_config(name), b, s)


def _ref_key(name):
    """The reference run a case is held to: the JAX package's sharded step
    on the case's mesh for an MoE model (its groups and router loss follow
    the mesh), else its unsharded step, one run an arch: (key, mesh or
    None)."""
    arch, shape, *_ = FAMILY_TRAIN_CASES[name]
    return (name, list(shape)) if family_train_config(name).n_experts else (arch, None)


_REF_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import reduced
    from repro.core import steps
    from repro.distributed import ctx, sharding as shd
    from repro.models import api
    from repro.training import optimizer as ropt

    data = np.load(sys.argv[1])
    cases = json.loads(sys.argv[2])
    opt = json.loads(sys.argv[3])
    out = {}
    for name, (arch, shape, mb, fields) in cases.items():
        cfg = dataclasses.replace(reduced(arch), dtype="float32", remat=False, **fields)
        keys = sorted({k.split("/")[2] for k in data.files if k.startswith(name + "/0/")})
        batches = [{k: data[f"{name}/{i}/{k}"] for k in keys} for i in range(2)]
        params = api.init_params(cfg, jax.random.PRNGKey(0))
        state = {"params": params, "opt": ropt.init_opt_state(params)}
        if shape is None:
            step = jax.jit(steps.make_train_step(cfg, ropt.OptConfig(**opt), mb))
            for i, b in enumerate(batches):
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                for k, v in m.items():
                    out[f"{name}/metrics{i}/{k}"] = np.asarray(v)
        else:
            names = ("pod", "data", "model")[-len(shape):]
            mesh = jax.make_mesh(tuple(shape), names, axis_types=(AxisType.Auto,) * len(shape),
                                 devices=jax.devices()[:int(np.prod(shape))])
            tcfg = steps._train_cfg(cfg, mesh, batches[0]["tokens"].shape[0] // mb)
            ss = steps.train_state_shardings(tcfg, mesh)
            rules = shd.train_rules(mesh, tcfg)
            bs = shd.batch_shardings({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                      for k, v in batches[0].items()}, rules, mesh)
            fn = steps.make_train_step(tcfg, ropt.OptConfig(**opt), mb,
                                       param_shardings=ss["params"])
            step = jax.jit(fn, in_shardings=(ss, bs), out_shardings=(ss, None))
            with ctx.mesh_context(mesh), mesh:
                state = jax.device_put(state, ss)
                for i, b in enumerate(batches):
                    state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                    for k, v in m.items():
                        out[f"{name}/metrics{i}/{k}"] = np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(state)[0]:
            out[f"{name}/state/" + ".".join(k.key for k in path)] = np.asarray(v)
        print("REF_CASE", name, flush=True)
    np.savez(sys.argv[4], **out)
    print("REF_OK")
    """
)


class _Reference:
    """The JAX package's reference run of every case (`_ref_key`), in a
    subprocess started at once and read when first asked for (the ranks
    run meanwhile)."""

    def __init__(self, tmp):
        cases, arrays = {}, {}
        for name, c in FAMILY_TRAIN_CASES.items():
            key, shape = _ref_key(name)
            cases[key] = (c[0], shape, c[4], c[5])
            arrays.update({f"{key}/{i}/{k}": v for i, b in enumerate(_batches(name))
                           for k, v in b.items()})
        np.savez(tmp / "in.npz", **arrays)
        env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
        self.out = tmp / "out.npz"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, str(tmp / "in.npz"), json.dumps(cases),
             json.dumps(TRAIN_OPT), str(self.out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.got = None

    def get(self, name):
        name = _ref_key(name)[0]
        if self.got is None:
            stdout, stderr = self.proc.communicate(timeout=600)
            assert "REF_OK" in stdout, stdout[-2000:] + stderr[-4000:]
            got = np.load(self.out)
            self.got = {k: got[k] for k in got.files}
        pre = name + "/"
        metrics = [{k.split("/")[2]: float(v) for k, v in self.got.items()
                    if k.startswith(f"{pre}metrics{i}/")} for i in range(2)]
        state = {k[len(pre + "state/"):]: v for k, v in self.got.items()
                 if k.startswith(pre + "state/")}
        return metrics, state


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("family_train_ref"))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


_SPAWNS = {}


def _ranks(shape, tmp_path_factory):
    """The ranks' results on mesh `shape`: one spawn a mesh."""
    if shape not in _SPAWNS:
        cases = {name: (_weights(name), _batches(name))
                 for name, c in FAMILY_TRAIN_CASES.items() if c[1] == shape}
        loop = str(tmp_path_factory.mktemp("family_loop")) if shape == (2, 2) else None
        _SPAWNS[shape] = (tmesh.run_ranks(family_train_rank, int(np.prod(shape)),
                                          (shape, cases, loop), device="cpu", timeout=300),
                          loop)
    return _SPAWNS[shape]


@pytest.mark.parametrize("name", list(FAMILY_TRAIN_CASES))
def test_sharded_family_step_matches_reference(name, reference, tmp_path_factory):
    _, shape, _, _, _, fields = FAMILY_TRAIN_CASES[name]
    ranks, _ = _ranks(shape, tmp_path_factory)
    assert [r["coord"] for r in ranks] == [list(c) for c in np.ndindex(*shape)]
    want_metrics, want_state = reference.get(name)
    cfg = family_train_config(name)
    # the MoE path each case must take: moe_shard_map (EP or weight-gather)
    # for the einsum dispatch, the global groups with their summing
    # backward for the sort dispatch, neither without experts
    local_groups = bool(cfg.n_experts) and cfg.moe_impl == "einsum"
    global_groups = bool(cfg.n_experts) and cfg.moe_impl == "sort"
    init = dict(leaves(_weights(name)))
    want_shapes = train_cut_shapes(_ref_cfg(name), shape)
    for r in ranks:
        got = r[name]
        assert got["shapes"] == want_shapes, r["coord"]
        assert (got["calls"]["moe_shard_map"] > 0) == local_groups, got["calls"]
        assert (got["calls"]["own_rows"] > 0) == global_groups, got["calls"]
        for m, w in zip(got["metrics"], want_metrics):
            assert set(m) == set(w)
            for k in m:
                assert_allclose(m[k], w[k], rtol=METRIC_RTOL, atol=1e-7,
                                err_msg=f"{name} {k} {r['coord']}")
    lr_sum = sum(m["lr"] for m in want_metrics)
    check_state(ranks[0][name]["state"], want_state, init, lr_sum, ulp_slack=True)
    assert int(ranks[0][name]["state"]["opt.step"]) == 2


def test_sharded_moe_train_loop_restarts_and_its_files_restore_unsharded(tmp_path_factory,
                                                                         tmp_path):
    """train() of reduced moonshot on (2, 2), its experts cut over `data`:
    4 steps with a checkpoint every 2, and a run that fails at step 3 and
    restarts from the step-2 checkpoint. The losses equal the one-device
    loop's; the checkpoints are the files a one-device run writes (leaf
    count, shapes, dtypes, tree) and restore into a one-device state with
    the leaves the mesh's run held."""
    ranks, loop_dir = _ranks((2, 2), tmp_path_factory)
    cfg = family_loop_config()
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
    # the expert leaves, cut over `data` on the mesh, are whole in the files
    assert restored["params.body.l0.ffn.wi_gate"].shape[1] == cfg.n_experts
    for path, v in final.items():
        np.testing.assert_array_equal(restored[path].numpy(), v, err_msg=path)
