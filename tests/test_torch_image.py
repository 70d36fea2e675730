"""The PyTorch package's image serving path against the JAX package, on the
CPU.

On the CPU each image wrapper runs its kernel's plain PyTorch version (the
CUDA kernels run only on the card: tests/test_torch_card.py). Inputs are
made with numpy from a seed and fed to the port's wrappers and to the JAX
package's ops (Pallas in interpret mode, as its own tests run them), and to
the numpy chain in preprocess_cpu. Tolerances are those of
tests/test_kernels.py: IDCT rtol 1e-4 / atol 1e-3, resize 1e-4, image
pipeline rtol 1e-3 / atol 1e-2; crop-normalize 1e-5 (one subtract and one
multiply by the same fp32 constant).

The slice: one seeded trace of image requests through the JAX runtime and
the port's, both on the virtual clock, reduced tinyllama at fp32 on the
reference's weights, with an image DPU service of the kernel backend.
Per request: generated tokens equal, features within rtol 1e-3 / atol 1e-2.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.dpu import runtime as rdpu  # noqa: E402
from repro.core.dpu.service import DpuService as RefService  # noqa: E402
from repro.core.dpu.service import DpuServiceConfig as RefServiceConfig  # noqa: E402
from repro.data import preprocess_cpu as rpp  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving import engine as rengine  # noqa: E402
from repro.serving import faults as rfaults  # noqa: E402
from repro.serving import requests as rrequests  # noqa: E402
from repro.serving import runtime as rruntime  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.dpu.runtime import DPU, DpuConfig, payload_error  # noqa: E402
from repro_torch.core.dpu.service import DpuService, DpuServiceConfig  # noqa: E402
from repro_torch.data import preprocess_cpu as pp  # noqa: E402
from repro_torch.kernels import image_normalize, image_resize, ops, ref  # noqa: E402
from repro_torch.models.params import from_reference  # noqa: E402
from repro_torch.serving import requests as trequests  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.faults import ShedReason, replay_virtual  # noqa: E402
from repro_torch.serving.runtime import build_pipelined_runtime  # noqa: E402

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"


def _coeffs(shape, seed):
    return np.random.default_rng(seed).integers(-32, 32, shape).astype(np.float32)


def _qtable(seed):
    return np.random.default_rng(seed).integers(1, 16, (8, 8)).astype(np.float32)


def _pixels(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def test_constants_equal_reference():
    assert np.array_equal(pp.idct_matrix(), rpp.idct_matrix())
    for n_in, n_out in [(256, 256), (320, 112), (200, 96), (512, 256), (384, 256), (7, 19)]:
        assert np.array_equal(pp._resize_matrix(n_in, n_out), rpp._resize_matrix(n_in, n_out))


@pytest.mark.parametrize("shape", [(1, 1, 1, 8, 8), (1, 10, 10, 8, 8), (1, 27, 19, 8, 8)])
def test_jpeg_decode_batch_matches_reference(shape):
    """1, 100 and 513 blocks; the last is ragged against any block tile."""
    c, q = _coeffs(shape, sum(shape)), _qtable(1)
    got = ops.jpeg_decode_batch(torch.from_numpy(c), torch.from_numpy(q)).numpy()
    want = np.asarray(rops.jpeg_decode_batch(jnp.asarray(c), jnp.asarray(q)))
    assert got.shape == want.shape == (shape[0], 8 * shape[1], 8 * shape[2])
    assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert_allclose(got[0], rpp.decode_blocks(c[0], q), rtol=1e-4, atol=1e-3)
    blocks = ref.jpeg_idct_ref(torch.from_numpy(c.reshape(-1, 8, 8)), torch.from_numpy(q))
    as_img = blocks.reshape(shape).permute(0, 1, 3, 2, 4).reshape(got.shape).numpy()
    assert_allclose(got, as_img, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("hw,out", [((256, 256), (256, 256)), ((320, 200), (112, 96)),
                                    ((512, 512), (256, 256))])
def test_image_resize_batch_matches_reference(hw, out):
    x = _pixels((2, *hw), hw[0] + out[1])
    got = ops.image_resize_batch(torch.from_numpy(x), *out).numpy()
    want = np.asarray(rops.image_resize_batch(jnp.asarray(x), *out))
    assert got.shape == want.shape == (2, *out)
    assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ry, rx = (torch.from_numpy(pp._resize_matrix(n, m).copy()) for n, m in zip(hw, out))
    for i in range(2):
        assert_allclose(got[i], rpp.resize_bilinear(x[i], *out), rtol=1e-4, atol=1e-4)
        assert_allclose(got[i], ref.image_resize_ref(torch.from_numpy(x[i]), ry, rx).numpy(),
                        rtol=1e-4, atol=1e-4)


# every (n_in, n_out) the port resizes (serve phases, the slice, the
# pipeline tests) and the card tests use
RESIZE_PAIRS = [(256, 256), (512, 256), (384, 256), (192, 256), (32, 256), (32, 32),
                (320, 112), (200, 96), (70, 257), (130, 65), (7, 19)]


@pytest.mark.parametrize("n_in,n_out", RESIZE_PAIRS)
def test_resize_taps_rebuild_the_matrix_bit_for_bit(n_in, n_out):
    idx, w = ops.resize_taps(n_in, n_out, torch.device("cpu"))
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    assert idx.shape == w.shape == (n_out, 2)
    idx, w = idx.numpy(), w.numpy()
    assert (idx[:, 0] <= idx[:, 1]).all() and (idx >= 0).all() and (idx < n_in).all()
    assert (w[idx[:, 0] == idx[:, 1], 1] == 0).all()  # one non-zero: named twice, weight 0
    dense = np.zeros((n_out, n_in), np.float32)
    np.add.at(dense, (np.repeat(np.arange(n_out), 2), idx.ravel()), w.ravel())
    m = pp._resize_matrix(n_in, n_out)
    assert np.array_equal(dense, m)
    assert np.array_equal(w[:, 0], m[np.arange(n_out), idx[:, 0]])


def test_resize_taps_refuse_a_row_with_three_nonzeros(monkeypatch):
    m = np.zeros((3, 5), np.float32)
    m[0, :2] = 0.5
    m[1, 1:4] = 1.0 / 3.0
    m[2, 4] = 1.0
    monkeypatch.setattr(pp, "_resize_matrix", lambda n_in, n_out: m)
    with pytest.raises(ValueError, match="row 1"):
        ops.resize_taps(5, 3, torch.device("cpu"))


@pytest.mark.parametrize("n,hw,out", [(1, (256, 256), (256, 256)), (3, (320, 200), (112, 96)),
                                      (2, (512, 512), (256, 256)), (2, (70, 130), (257, 65)),
                                      (2, (384, 512), (256, 256))])
def test_resize_tap_plain_matches_dense_products_and_reference(n, hw, out):
    """The plain two-tap gather (what the CPU path runs and what the kernel
    computes) against the dense products of ref.image_resize_ref and the
    JAX package's batched resize, at the card tests' and serve shapes:
    upscaling with clamped edge taps (70 -> 257), ragged rows (W % 4 != 0)
    and the non-integer scale 384 -> 256."""
    x = _pixels((n, *hw), n + hw[0])
    xt = torch.from_numpy(x)
    got = image_resize.image_resize_batch_plain(
        xt, ops.resize_taps(hw[0], out[0], xt.device), ops.resize_taps(hw[1], out[1], xt.device))
    assert got.shape == (n, *out) and got.dtype == torch.float32
    dense = ref.image_resize_ref(xt, ops.resize_matrix(hw[0], out[0], xt.device),
                                 ops.resize_matrix(hw[1], out[1], xt.device))
    assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)
    want = np.asarray(rops.image_resize_batch(jnp.asarray(x), *out))
    assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mean,std", [(127.5, 64.0), (110.3, 57.1)])
def test_image_normalize_batch_matches_reference(mean, std):
    x = _pixels((3, 224, 224), 5)
    got = ops.image_normalize_batch(torch.from_numpy(x), mean, std).numpy()
    want = np.asarray(rops.image_normalize_batch(jnp.asarray(x), mean, std))
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert_allclose(got, ref.image_normalize_ref(torch.from_numpy(x), mean, std).numpy(),
                    rtol=1e-5, atol=1e-5)


def test_crop_normalize_reads_the_centered_window():
    x = _pixels((2, 256, 240), 6)
    got = image_normalize.image_crop_normalize_batch(torch.from_numpy(x), 224, 200, 127.5, 64.0)
    assert got.shape == (2, 224, 200)
    for i in range(2):
        assert_allclose(got[i].numpy(),
                        rpp.normalize_image(rpp.center_crop(x[i], 224, 200), 127.5, 64.0),
                        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="does not fit"):
        image_normalize.crop_origin(200, 200, 224, 224)


@pytest.mark.parametrize("n,hw,crop", [(1, (97, 130), (33, 101)), (3, (30, 37), (21, 22))])
def test_crop_normalize_plain_at_an_unaligned_crop(n, hw, crop):
    """Crops whose origin and width are not multiples of 4 (the card
    kernel's scalar path): the plain version still reads the centered
    window, as the reference's numpy chain does, and equals the slice then
    subtract then multiply in fp32 bit for bit."""
    x = _pixels((n, *hw), 7 + n)
    got = image_normalize.image_crop_normalize_batch(torch.from_numpy(x), *crop, 110.3, 57.1)
    assert got.shape == (n, *crop)
    y0, x0 = image_normalize.crop_origin(*hw, *crop)
    assert x0 % 4 or crop[1] % 4
    win = x[:, y0:y0 + crop[0], x0:x0 + crop[1]]
    want = (win - np.float32(110.3)) * np.float32(1.0 / 57.1)
    assert np.array_equal(got.numpy(), want)
    for i in range(n):
        assert_allclose(got[i].numpy(),
                        rpp.normalize_image(rpp.center_crop(x[i], *crop), 110.3, 57.1),
                        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,by,bx", [(1, 32, 32), (3, 24, 32)])
def test_image_pipeline_batch_matches_reference(n, by, bx):
    c, q = _coeffs((n, by, bx, 8, 8), 40 + n), _qtable(2)
    got = ops.image_pipeline_batch(torch.from_numpy(c), torch.from_numpy(q)).numpy()
    want = np.asarray(rops.image_pipeline_batch(jnp.asarray(c), jnp.asarray(q)))
    assert got.shape == want.shape == (n, 224, 224)
    assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    for i in range(n):
        assert_allclose(got[i], rpp.image_pipeline(c[i], q), rtol=1e-3, atol=1e-2)
        assert_allclose(got[i], pp.image_pipeline(c[i], q), rtol=1e-3, atol=1e-2)


def test_single_wrappers_are_batches_of_one():
    c, q = _coeffs((32, 24, 8, 8), 50), _qtable(3)
    img = ops.jpeg_decode(torch.from_numpy(c), torch.from_numpy(q))
    assert_allclose(img.numpy(), np.asarray(rops.jpeg_decode(jnp.asarray(c), jnp.asarray(q))),
                    rtol=1e-4, atol=1e-3)
    big = ops.image_resize(img, 256, 256)
    assert_allclose(big.numpy(), np.asarray(rops.image_resize(jnp.asarray(img.numpy()), 256, 256)),
                    rtol=1e-4, atol=1e-4)
    crop = ops.center_crop(big, 224, 224)
    assert crop.shape == (224, 224)
    assert crop.untyped_storage().data_ptr() == big.untyped_storage().data_ptr()  # no copy
    out = ops.image_normalize(crop, 127.5, 64.0)
    assert_allclose(out.numpy(), pp.image_pipeline(c, q), rtol=1e-3, atol=1e-2)


def test_cpu_image_path_counts_nothing():
    kernels.reset_launch_counts()
    ops.image_pipeline_batch(torch.from_numpy(_coeffs((2, 4, 4, 8, 8), 7)),
                             torch.from_numpy(_qtable(4)), resize_to=32, crop_to=24)
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    assert (set(kernels.IMAGE_KERNELS) | set(kernels.AUDIO_KERNELS)
            | {"decode_attention"}) == set(kernels.KERNELS)


_GOOD = {"coeffs": np.zeros((4, 4, 8, 8), np.float32), "qtable": np.ones((8, 8), np.float32)}


@pytest.mark.parametrize("payload", [
    _GOOD,
    np.zeros(16, np.float32),
    {"qtable": _GOOD["qtable"]},
    {"coeffs": _GOOD["coeffs"]},
    {"coeffs": [[1.0]], "qtable": _GOOD["qtable"]},
    {"coeffs": np.zeros((0, 4, 8, 8), np.float32), "qtable": _GOOD["qtable"]},
    {"coeffs": np.array(["a"] * 4).reshape(1, 1, 2, 2), "qtable": _GOOD["qtable"]},
    {"coeffs": np.zeros((16, 8, 8), np.float32), "qtable": _GOOD["qtable"]},
    {"coeffs": _GOOD["coeffs"], "qtable": np.ones((4, 4), np.float32)},
    {"coeffs": _GOOD["coeffs"], "qtable": np.ones(64, np.int32)},
])
def test_image_payload_error_matches_reference(payload):
    assert payload_error(payload, "image") == rdpu.payload_error(payload, "image")
    assert (payload_error(payload, "image") is None) == (payload is _GOOD)


def test_unsplit_audio_cu_gives_the_split_design_features():
    x = list(np.random.default_rng(8).standard_normal((2, 4800)).astype(np.float32))
    split = DPU(DpuConfig(backend="dpu"), device="cpu")
    fused = DPU(DpuConfig(backend="dpu", split_audio_cus=False), device="cpu")
    assert len(split.stages) == 2 and len(fused.stages) == 1
    for a, b in zip(split.process_batch(x), fused.process_batch(x)):
        assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-5)
    assert_allclose(np.asarray(fused.process(x[0])), pp.audio_pipeline(x[0]),
                    rtol=1e-3, atol=1e-2)


# --- the slice ---------------------------------------------------------------


def _ec(cls):
    return cls(continuous=True, max_slots=4, segment_len=4, max_new_tokens=6,
               max_prompt_len=32)


def _image_trace(mod, cfg):
    """Six image requests: four 256 x 256 sharing a qtable (two arriving
    together, one fused group of 2), and a pair of 192 x 256 arriving
    together whose qtables differ (the per-FU path)."""
    spec = mod.WorkloadSpec(modality="text", rate_qps=200.0, mean_len=12, max_len=30,
                            vocab=cfg.vocab, seed=5)
    reqs = mod.generate_requests(spec, 6)
    q = _qtable(9)
    for i, r in enumerate(reqs):
        by, qt = (32, q) if i < 4 else (24, q * (0.5 if i == 4 else 2.0))
        r.payload = {"coeffs": _coeffs((by, 32, 8, 8), 100 + i), "qtable": qt.copy()}
    reqs[1].arrival = reqs[0].arrival
    reqs[5].arrival = reqs[4].arrival
    return reqs


def _record_features(service):
    feats = {}
    poll = service.poll

    def wrapped(now, n=None):
        out = poll(now, n)
        for r in out:
            feats[r.rid] = np.array(r.payload)
        return out

    service.poll = wrapped
    return feats


@pytest.fixture(scope="module")
def image_slice():
    rcfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(reduced(ARCH), dtype="float32")
    jparams = rapi.init_params(rcfg, jax.random.PRNGKey(0), dtype="float32")
    params = from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu", "float32")

    rsvc = RefService(RefServiceConfig(
        clock="virtual", dpu=rdpu.DpuConfig(backend="dpu", modality="image")))
    rfeats = _record_features(rsvc)
    rrt = rruntime.build_pipelined_runtime(rcfg, ec=_ec(rengine.EngineConfig),
                                           service=rsvc, params=jparams)
    rdone = rfaults.replay_virtual(rrt, _image_trace(rrequests, rcfg))

    kernels.reset_launch_counts()
    svc = DpuService(DpuServiceConfig(
        clock="virtual", dpu=DpuConfig(backend="dpu", modality="image")), device="cpu")
    feats = _record_features(svc)
    rt = build_pipelined_runtime(cfg, ec=_ec(EngineConfig), service=svc,
                                 params=params, device="cpu")
    reqs = _image_trace(trequests, cfg)
    raws = {r.rid: dict(r.payload) for r in reqs}
    done = replay_virtual(rt, reqs)
    return dict(rdone=rdone, rfeats=rfeats, rrt=rrt, done=done, feats=feats, rt=rt,
                svc=svc, raws=raws)


def test_image_slice_tokens_match_reference_per_request(image_slice):
    ref_toks = {r.rid: np.asarray(r.payload) for r in image_slice["rdone"]}
    got = {r.rid: np.asarray(r.payload) for r in image_slice["done"]}
    assert sorted(got) == sorted(ref_toks) == list(range(6))
    for rid in ref_toks:
        np.testing.assert_array_equal(got[rid], ref_toks[rid])


def test_image_slice_features_match_reference_per_request(image_slice):
    ref_f, got = image_slice["rfeats"], image_slice["feats"]
    assert sorted(got) == sorted(ref_f) == list(range(6))
    for rid in ref_f:
        assert got[rid].shape == ref_f[rid].shape == (224, 224)
        assert_allclose(got[rid], ref_f[rid], rtol=1e-3, atol=1e-2)
        raw = image_slice["raws"][rid]
        assert_allclose(got[rid], pp.image_pipeline(raw["coeffs"], raw["qtable"]),
                        rtol=1e-3, atol=1e-2)


def test_image_slice_conserves_requests(image_slice):
    rt, svc = image_slice["rt"], image_slice["svc"]
    assert rt.conservation_ok() and not rt.shed and rt.shed_counts() == {}
    assert rt.stats["submitted"] == rt.stats["accepted"] == rt.stats["offered"] == 6
    assert image_slice["rrt"].conservation_ok() and not image_slice["rrt"].shed
    assert svc.stats["processed"] == svc.dpu.processed == 6 and svc.stats["failed"] == 0
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}  # CPU tensors
    assert rt.engine.stats["admitted"] == rt.engine.stats["retired"] == 6


def test_front_door_sheds_malformed_image_payloads():
    cfg = reduced(ARCH)
    svc = DpuService(DpuServiceConfig(
        clock="virtual", dpu=DpuConfig(backend="dpu", modality="image")), device="cpu")
    rt = build_pipelined_runtime(cfg, ec=_ec(EngineConfig), service=svc, device="cpu")
    reqs = _image_trace(trequests, cfg)[:3]
    reqs[1].payload = {"coeffs": reqs[1].payload["coeffs"]}
    reqs[2].payload = np.zeros(16, np.float32)
    assert rt.submit(reqs, now=0.0) == 1
    assert rt.shed_reasons == {1: ShedReason.MALFORMED, 2: ShedReason.MALFORMED}
    rt.run_until_idle()
    assert [r.rid for r in rt.completed] == [0] and rt.conservation_ok()
