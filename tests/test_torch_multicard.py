"""The fleet over several devices, on the CPU: each tenant's weights are
replicated once a (tenant, device) and kept across resizes, weights on a
device the fleet does not use are refused, and the launcher's
`--devices`. Reduced tinyllama at fp32 with the package's seeded weights;
two tenants of one config (seeds 0 and 1). The card-side tests (a fleet
over two cards, each kernel on the second card) are in
`tests/test_torch_card.py`."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.core.batching.buckets import Request
from repro_torch.models.params import leaves
from repro_torch.serving.engine import EngineConfig, build_engine
from repro_torch.serving.multislice import TenantSpec, build_multislice_engine

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
LENS = [17.0 + i for i in range(6)]
BUDGETS = [3, 5, 2, 4, 6, 1]


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(reduced(ARCH), dtype="float32")


def _ec():
    return EngineConfig(max_new_tokens=6, continuous=True, max_slots=4, segment_len=4,
                        max_prompt_len=32)


def _reqs(model=None, rid0=9000):
    return [Request(rid=rid0 + i, arrival=0.0, length=LENS[i], max_new_tokens=BUDGETS[i],
                    model=model) for i in range(len(LENS))]


def _tokens(done):
    return {r.rid: np.asarray(r.payload) for r in done}


def _fleet(cfg, n_slices, devices, **kw):
    return build_multislice_engine(cfg, n_slices=n_slices, ec=_ec(), device="cpu",
                                   devices=devices, **kw)


def test_one_tree_a_tenant_and_device_kept_across_resizes(cfg):
    """Two tenants over two CPU devices: every slice of a tenant serves
    that tenant's one LM (a device holds each tenant's weights once),
    the same objects after 4 -> 2 -> 4, and the tokens equal a single
    engine's per tenant through both resizes."""
    ms = build_multislice_engine(
        n_slices=4, ec=_ec(), device="cpu", devices=["cpu", "cpu", "cpu", "cpu"],
        tenants=[TenantSpec(cfg=cfg, name=n, n_slices=2, seed=i)
                 for i, n in enumerate("ab")])
    models = {n: ms._tenants[n].model for n in "ab"}
    assert ms.weights_by_device() == {"cpu": models}
    rounds = (4, 2, 4)
    want = {}
    for i, n in enumerate("ab"):
        single = build_engine(cfg, seed=i, ec=_ec(), device="cpu")
        for k in range(len(rounds)):
            single.submit_many(_reqs(rid0=9000 + 1000 * k + 100 * i))
        want.update(_tokens(single.run_until_idle()))
    for k, n_slices in enumerate(rounds):
        if n_slices != len(ms.engines):
            ms.resize(n_slices=n_slices)
        for sid, e in ms.engines.items():
            assert e.model is models[ms.slice_tenant[sid]]
        ms.submit_many(_reqs("a", 9000 + 1000 * k) + _reqs("b", 9100 + 1000 * k))
        done = [r for r in ms.run_until_idle() if r.rid // 1000 == 9 + k]
        assert len(done) == 12 and len({r.rid for r in done}) == 12
        for rid, toks in _tokens(done).items():
            np.testing.assert_array_equal(toks, want[rid])
    assert ms.weights_by_device() == {"cpu": models} and not ms._replicas


def test_replica_is_copied_once_a_device(cfg):
    """A slice on another device than the weights' gets a replica: one
    copy a (tenant, device), the same object on every later call, every
    leaf of the tenant's shape and type on that device; the weights' own
    device serves them uncopied."""
    ms = _fleet(cfg, 2, ["cpu", "cpu"])
    t = ms._tenants[cfg.name]
    assert ms._weights_on(t, torch.device("cpu")) is t.model
    meta = ms._weights_on(t, torch.device("meta"))
    assert meta is not t.model and ms._weights_on(t, torch.device("meta")) is meta
    got, want = dict(leaves(meta.tree())), dict(leaves(t.model.tree()))
    assert got.keys() == want.keys()
    for k, a in got.items():
        assert a.device.type == "meta" and (a.shape, a.dtype) == (want[k].shape, want[k].dtype)
    assert ms.weights_by_device() == {"cpu": {cfg.name: t.model}, "meta": {cfg.name: meta}}
    ms.resize(n_slices=1)
    assert ms._weights_on(t, torch.device("meta")) is meta


def test_weights_on_a_device_the_fleet_does_not_use_raise(cfg):
    from repro_torch.models.params import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), "meta", cfg.dtype)
    with pytest.raises(ValueError, match="does not use"):
        _fleet(cfg, 2, ["cpu", "cpu"], params=params)


def test_serve_launcher_spreads_slices_over_devices(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--devices", "cpu,cpu",
          "--continuous", "--requests", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 4 requests on 1gpu(2x)" in out and "slice 1 [" in out
    assert "on cpu:" in out
