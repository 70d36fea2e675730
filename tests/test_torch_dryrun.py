"""The dry-run tooling of the PyTorch package against the JAX package's:
the input specs, the op counter (`analysis/op_trace.py`: trip counts, ring
formulas, memory), the dot FLOPs of lowered cells against the JAX
package's HLO count, and the dry run on a fake world (subprocesses with
time limits of their own: a process holds one default process group)."""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.analysis import hlo_parse
from repro.configs import ASSIGNED_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.core import steps as ref_steps
from repro.models import api as ref_api
from repro_torch.analysis import op_trace, roofline
from repro_torch.configs import MODEL_ARCHS, SHAPES, ShapeConfig, get_config, reduced
from repro_torch.core import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import api
from repro_torch.models.params import leaves

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a JAX spec tree or a port meta tree."""
    out = {}
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def test_the_archs_are_the_reference_ones():
    assert sorted(MODEL_ARCHS) == sorted(ASSIGNED_ARCHS)


@pytest.mark.parametrize("arch", sorted(MODEL_ARCHS))
def test_input_specs_match_the_reference(arch):
    for name in SHAPES:
        want = _flat(ref_api.input_specs(ref_get_config(arch), REF_SHAPES[name]))
        got = _flat(api.input_specs(get_config(arch), SHAPES[name]))
        assert got == want, (arch, name)
        assert all(t.device.type == "meta" for _, t in leaves(api.input_specs(
            get_config(arch), SHAPES[name])))


def test_make_train_batch_ranges_and_types():
    cfg = reduced("whisper-base")
    b = api.make_train_batch(cfg, 3, 5, torch.Generator().manual_seed(0), "cpu")
    specs = api.train_batch_specs(cfg, ShapeConfig("t", "train", 5, 3))
    assert sorted(b) == sorted(specs)
    for k, v in b.items():
        assert v.shape == specs[k].shape and v.dtype == specs[k].dtype
    assert 0 <= int(b["tokens"].min()) and int(b["tokens"].max()) < cfg.vocab


def test_loop_counts_every_trip():
    """The twin of the JAX package's test_hlo_parser_scan_trip_count."""
    def f(x, w):
        for _ in range(11):
            x = x @ w
        return x

    spec = torch.empty((64, 64), device="meta")
    cost = op_trace.analyze_step(f, spec, spec)
    assert cost.dot_flops == pytest.approx(2 * 64 ** 3 * 11)
    assert cost.dots == 11


def test_collective_wire_formulas():
    """The JAX package's test_collective_wire_formulas values."""
    assert op_trace.logical_wire("all-reduce", 400, 4) == pytest.approx(2 * 400 * 3 / 4)
    assert op_trace.logical_wire("all-gather", 400, 2) == pytest.approx(400 * 1 / 2)
    assert op_trace.logical_wire("reduce-scatter", 400, 2) == pytest.approx(400.0)
    assert op_trace.logical_wire("all-to-all", 400, 4) == pytest.approx(300.0)
    assert op_trace.logical_wire("collective-permute", 400, 4) == pytest.approx(400.0)
    assert op_trace.link_of(range(8)) == "nvlink"
    assert op_trace.link_of(range(4, 12)) == "network"
    assert op_trace.link_of(range(0, 256, 16)) == "network"


def test_memory_accounting():
    """Arguments, the output that aliases an argument updated in place, and
    the peak of the storages the step created (outputs left out)."""
    def f(a, w):
        h = a @ w                  # [8, 64] fp32, freed after the add
        g = h @ w.t()              # [8, 32]
        a.add_(g)
        return a, g.sum()

    a, w = torch.empty((8, 32), device="meta"), torch.empty((32, 64), device="meta")
    cost = op_trace.analyze_step(f, a, w)
    assert cost.argument_bytes == (8 * 32 + 32 * 64) * 4
    assert cost.alias_bytes == 8 * 32 * 4
    assert cost.output_bytes == 8 * 32 * 4 + 4
    assert cost.temp_bytes == (8 * 64 + 8 * 32) * 4
    assert cost.bytes_per_device == cost.argument_bytes + cost.temp_bytes + 4


def test_roofline_terms():
    cost = op_trace.StepCost(dot_flops=989e12, dot_bytes=3.35e12,
                             wire_by_link={"nvlink": 450e9, "network": 100e9})
    cfg, shape = get_config("tinyllama-1.1b"), SHAPES["train_4k"]
    r = roofline.build_report(cfg, shape, "pod16x16", 256, cost)
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(3.0) and r.bottleneck == "collective"
    assert r.model_flops == 6.0 * cfg.active_param_count() * 256 * 4096


@pytest.fixture(scope="module")
def local_mesh():
    """A world of one in this process, left as it was found: the other test
    files of a worker expect no process group."""
    import torch.distributed as dist

    created = not dist.is_initialized()
    yield make_local_mesh("cpu")
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch, kind", [
    ("tinyllama-1.1b", "train"), ("tinyllama-1.1b", "prefill"), ("tinyllama-1.1b", "decode"),
    ("mamba2-370m", "prefill"), ("whisper-base", "train")])
def test_dot_flops_equal_the_reference_hlo_count(local_mesh, arch, kind):
    """Reduced configs at fp32 on a (1, 1) mesh, batch 2 x 64: the port's
    counted dot FLOPs against `hlo_parse.analyze_hlo` of the JAX package's
    compiled cell, within 0.1%. They agree exactly: tinyllama's train step
    recomputes each layer but its last product and keeps a single loss
    chunk's logits, as XLA's compiled step does; mamba2's prefill takes
    the conv tail from the block's own input product (XLA merges the
    reference's second one); whisper's encoder is not recomputed."""
    ref_cfg = dataclasses.replace(ref_reduced(arch), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with mesh:
        text = ref_steps.lower_cell(ref_cfg, RefShapeConfig(kind, kind, 64, 2), mesh).compile(
            ).as_text()
    want = hlo_parse.analyze_hlo(text).dot_flops
    cfg = dataclasses.replace(reduced(arch), dtype="float32")
    got = steps.lower_cell(cfg, ShapeConfig(kind, kind, 64, 2), local_mesh).analyze().dot_flops
    assert got == pytest.approx(want, rel=1e-3)


_FAKE8 = textwrap.dedent("""
    import dataclasses, json, torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ShapeConfig, reduced
    from repro_torch.core import steps
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import api
    from repro_torch.models.params import init_params, leaves

    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), dtype="float32")
    nbytes = lambda tree: sum(t.nbytes for _, t in leaves(tree))
    gen = lambda: torch.Generator().manual_seed(0)
    out = {}
    shape = ShapeConfig("t", "train", 32, 8)
    state = steps.shard_train_state(steps.init_train_state(cfg, gen(), "cpu"), cfg, mesh)
    batch = steps.shard_train_batch(api.make_train_batch(cfg, 8, 32, gen(), "cpu"), mesh)
    out["train"] = (steps.lower_cell(cfg, shape, mesh).analyze().argument_bytes,
                    nbytes(state) + nbytes(batch))
    params = steps.shard_params(init_params(cfg, gen(), "cpu", cfg.dtype), cfg, mesh)
    tokens = steps.shard_batch(torch.zeros((8, 32), dtype=torch.int32), mesh)
    shape = ShapeConfig("p", "prefill", 32, 8)
    out["prefill"] = (steps.lower_cell(cfg, shape, mesh).analyze().argument_bytes,
                      nbytes(params) + tokens.nbytes)
    assert tokens.untyped_storage().nbytes() == 2 * tokens.nbytes  # a view of all rows
    # the cache a real prefill leaves this rank (the fake world's collectives
    # return at once: values are not computed, shapes are)
    _, cache = steps.sharded_prefill(cfg, mesh, batch=8)(params, {"tokens": tokens})
    shape = ShapeConfig("d", "decode", 32, 8)
    out["decode"] = (steps.lower_cell(cfg, shape, mesh).analyze().argument_bytes,
                     nbytes(params) + nbytes(cache) + tokens[:, :1].nbytes + 4)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def dryruns():
    """(the fake world of 8's argument bytes, the dry run's record of
    tinyllama-1.1b train_4k on pod16x16), run at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        fake = subprocess.Popen([sys.executable, "-c", _FAKE8], env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                "tinyllama-1.1b", "--shape", "train_4k", "--out", tmp],
                               env=env, text=True, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE)
        try:
            fout, ferr = fake.communicate(timeout=180)
            cout, cerr = cli.communicate(timeout=180)
        finally:
            fake.kill()
            cli.kill()
        assert fake.returncode == 0, ferr[-3000:]
        assert cli.returncode == 0, cerr[-3000:]
        rec = json.loads((Path(tmp) / "tinyllama-1.1b__train_4k__pod16x16.json").read_text())
    return json.loads(fout.splitlines()[-1]), rec, cout


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_are_the_ranks_shards(dryruns, kind):
    """On a fake world of 8, mesh (2, 4): a lowered reduced cell's argument
    bytes equal the bytes of rank 0's real shards (`shard_train_state`,
    `shard_params`, its rows, the cache its prefill leaves), exactly."""
    got, want = dryruns[0][kind]
    assert got == want


def test_dryrun_writes_the_reference_record(dryruns):
    """`python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape
    train_4k`: status ok, the JAX package's keys (but compile_s), and its
    dot FLOPs and argument bytes equal the JAX package's committed record's;
    the record committed beside it is this one."""
    _, rec, out = dryruns
    ref = json.loads((ROOT / "results/dryrun/tinyllama-1.1b__train_4k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and "[ok     ]" in out
    assert set(ref) - {"compile_s"} <= set(rec)
    assert set(ref["memory_analysis"]) == set(rec["memory_analysis"])
    assert set(ref["roofline"]) <= set(rec["roofline"])
    assert rec["roofline"]["hlo_flops"] == ref["roofline"]["hlo_flops"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        ref["memory_analysis"]["argument_size_in_bytes"]
    mine = json.loads((ROOT / "results/dryrun_torch/tinyllama-1.1b__train_4k__pod16x16.json")
                      .read_text())
    for k in ("memory_analysis", "bytes_per_device", "cost_analysis", "roofline"):
        assert mine[k] == rec[k], k


def test_a_refused_layout_raises_naming_the_leaf():
    """A layout the port's collectives cannot close raises the port's own
    ValueError, naming the leaf (the dry run records it as an error cell):
    a model axis of 3 cuts no MLP dim of reduced tinyllama."""
    shape = ShapeConfig("d", "decode", 32, 2)
    with pytest.raises(ValueError, match=r"body\.l0\.ffn\..* is not cut over the model axis"):
        steps.lower_cell(reduced("tinyllama-1.1b"), shape, {"data": 1, "model": 3},
                         coordinate=(0, 0))
