"""Checks that tests/test_torch_sharded_train.py and
tests/test_torch_sharded_train_families.py share: the shapes the JAX
package's train PartitionSpecs give each rank, and a trained state held to
the JAX package's. Imports JAX, so spawned ranks do not import it."""
import jax
import numpy as np
from numpy.testing import assert_allclose

from repro.distributed import sharding as rshd
from repro.models import api as rapi


class FakeMesh:
    """Axis sizes in the shape of a jax Mesh, for the rules and spec_for."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def mesh_sizes(shape):
    """{axis: size} of a port mesh `shape`: (data, model), or (pod, data,
    model) for three axes."""
    names = ("pod", "data", "model")[-len(shape):]
    return dict(zip(names, shape))


def train_cut_shapes(rcfg, shape):
    """{path: local shape} of the JAX package's weights of config `rcfg`
    cut by its train PartitionSpecs on mesh `shape`."""
    fake = FakeMesh(mesh_sizes(shape))
    rules = rshd.train_rules(fake, rcfg)
    specs = rapi.param_specs(rcfg)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    axes = jax.tree.leaves(rapi.param_axes(rcfg), is_leaf=lambda x: isinstance(x, tuple))
    out = {}
    for (path, s), a in zip(flat, axes):
        spec = rshd.spec_for(s.shape, a, rules, fake)
        out[".".join(k.key for k in path)] = tuple(
            d // rshd._axis_size(fake, e) if e is not None else d for d, e in zip(s.shape, spec))
    return out


def check_state(got, want, init, lr_sum, tol=1e-4, ulp_slack=False):
    """tests/test_torch_train_step.py's `_check_state` on numpy trees: the
    moments within tol of each leaf's magnitude; each weight leaf's update
    within a relative L2 distance of 1e-3 of the reference's, no element
    off by more than 2 x the summed learning rate. ulp_slack: an element of
    a weight's update that differs by at most one ulp of the weight counts
    as equal (the rounding of p - lr u, not a difference of u). jamba's
    dt_bias (|p| ~ 4.6, ulp 4.8e-7) moves ~1e-4 in two steps, ~200 ulps, so
    a single flip is 1.1e-3 of that leaf's update; the JAX package's own
    sharded and unsharded steps differ there by 3.1e-3."""
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype, path
        if path.startswith("params."):
            p0 = init[path[len("params."):]]
            du, dw = g - p0, w - p0
            off = np.abs(du - dw)
            if ulp_slack:
                off = np.maximum(off - np.spacing(np.abs(w)), 0)
            assert np.linalg.norm(off) <= 1e-3 * np.linalg.norm(dw) + 1e-12, path
            assert np.abs(g - w).max() <= 2 * lr_sum, path
        else:
            assert_allclose(g, w, rtol=tol, atol=tol * max(float(np.abs(w).max()), 1e-30),
                            err_msg=path)
