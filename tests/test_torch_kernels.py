"""The PyTorch package's DPU kernels against the JAX package, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version (the CUDA
kernels run only on the card: tests/test_torch_card.py). Inputs are made with numpy from a seed and fed to three opinions:
the port's batched wrapper, the JAX package's batched op (Pallas in
interpret mode, as its own tests run it), and the numpy chain in
preprocess_cpu. Tolerances are those of tests/test_kernels.py: mel 2e-4,
normalize 3e-3, resample rtol 1e-4 / atol 1e-5.

The JAX package's resample Pallas kernel does not trace on the installed
JAX (it calls `pl.load`, which JAX 0.9 removed), so resample is held
against its plain oracle `repro.kernels.ref.audio_resample_ref` on the same
pre-padded stack instead, and so is the resample stage of the fused
pipeline.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import preprocess_cpu as rpp  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.data import preprocess_cpu as pp  # noqa: E402
from repro_torch.kernels import audio_normalize, audio_resample, build, mel_spectrogram  # noqa: E402
from repro_torch.kernels import image_normalize, image_resize, jpeg_idct  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(1)

L = 4800


def _signals(n, seed=0, length=L):
    return np.random.default_rng(seed).standard_normal((n, length)).astype(np.float32)


def _ref_resample(x):
    """The JAX package's resample, through its plain oracle: the ops.py
    padding (72 left, 144 right) then ref.audio_resample_ref per row."""
    h = rpp.fir_lowpass(48 * 3, 1.0 / 3)
    xp = np.pad(x, ((0, 0), (72, 144)))
    n_out = (x.shape[1] + 2) // 3
    return np.stack([np.asarray(rref.audio_resample_ref(jnp.asarray(r), jnp.asarray(h), 3))
                     for r in xp])[:, :n_out]


def test_constants_equal_reference():
    assert np.array_equal(pp.hann(400), rpp.hann(400))
    for a, b in zip(pp.dft_matrices(512), rpp.dft_matrices(512)):
        assert np.array_equal(a, b)
    assert np.array_equal(pp.mel_filterbank(80, 512, 16000), rpp.mel_filterbank(80, 512, 16000))
    assert np.array_equal(pp.fir_lowpass(144, 1 / 3), rpp.fir_lowpass(144, 1 / 3))


@pytest.mark.parametrize("n", [1, 3])
def test_resample_batch_matches_reference(n):
    x = _signals(n, seed=n)
    got = ops.audio_resample_batch(torch.from_numpy(x), 1, 3).numpy()
    assert got.shape == (n, L // 3)
    assert_allclose(got, _ref_resample(x), rtol=1e-4, atol=1e-5)
    for i in range(n):
        assert_allclose(got[i], rpp.resample_poly(x[i], 1, 3), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("down", [2, 3])
def test_resample_single_matches_numpy(down):
    x = _signals(1, seed=7, length=1600)[0]
    got = ops.audio_resample(torch.from_numpy(x), 1, down).numpy()
    want = pp.resample_poly(x, 1, down)
    m = min(len(got), len(want))
    assert_allclose(got[:m], want[:m], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [1, 3])
def test_mel_batch_matches_reference(n):
    y = _signals(n, seed=10 + n, length=L // 3)
    got = ops.mel_spectrogram_batch(torch.from_numpy(y)).numpy()
    want = np.asarray(rops.mel_spectrogram_batch(jnp.asarray(y)))
    assert got.shape == want.shape == (n, 1 + (L // 3 - 400) // 160, 80)
    assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for i in range(n):
        assert_allclose(got[i], rpp.mel_spectrogram(y[i]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_mels", [40, 80])
def test_mel_plain_matches_oracle(n_mels):
    rng = np.random.default_rng(n_mels)
    frames = torch.from_numpy(rng.standard_normal((37, 512)).astype(np.float32))
    cr, ci = (torch.tensor(a) for a in pp.dft_matrices(512))
    fb = torch.from_numpy(pp.mel_filterbank(n_mels, 512, 16000).T.copy())
    got = mel_spectrogram.mel_spectrogram_batch(frames, cr, ci, fb)
    assert_allclose(got.numpy(), ref.mel_spectrogram_ref(frames, cr, ci, fb).numpy(),
                    rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [1, 3])
def test_normalize_batch_matches_reference(n):
    feats = (np.random.default_rng(20 + n).standard_normal((n, 30, 80)) * 3 + 1).astype(np.float32)
    got = ops.audio_normalize_batch(torch.from_numpy(feats)).numpy()
    want = np.asarray(rops.audio_normalize_batch(jnp.asarray(feats)))
    assert_allclose(got, want, rtol=3e-3, atol=3e-3)
    for i in range(n):
        assert_allclose(got[i], rpp.normalize_meanvar(feats[i]), rtol=3e-3, atol=3e-3)
        assert_allclose(got[i], ref.audio_normalize_ref(torch.from_numpy(feats[i])).numpy(),
                        rtol=3e-3, atol=3e-3)


def test_normalize_single_is_batch_of_one():
    feats = np.random.default_rng(5).standard_normal((5, 80)).astype(np.float32)
    got = ops.audio_normalize(torch.from_numpy(feats)).numpy()
    assert_allclose(got, rpp.normalize_meanvar(feats), rtol=3e-3, atol=3e-3)


def test_pipeline_batch_matches_reference():
    x = _signals(3, seed=30)
    got = ops.audio_pipeline_batch(torch.from_numpy(x)).numpy()
    y = _ref_resample(x)
    want = np.asarray(rops.audio_normalize_batch(rops.mel_spectrogram_batch(jnp.asarray(y))))
    assert got.shape == want.shape == (3, 8, 80)
    assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    for i in range(3):
        assert_allclose(got[i], rpp.audio_pipeline(x[i]), rtol=1e-3, atol=1e-2)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    kernels.reset_launch_counts()
    ops.audio_pipeline_batch(torch.from_numpy(_signals(2)))
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}


@pytest.mark.parametrize("call", [
    lambda t: audio_resample.audio_resample_batch(t(2, 400), t(144), 3),
    lambda t: mel_spectrogram.mel_spectrogram_batch(t(4, 512), t(512, 257), t(512, 257), t(257, 80)),
    lambda t: audio_normalize.audio_normalize_batch(t(2, 9, 80)),
    lambda t: jpeg_idct.jpeg_idct_batch(t(1, 2, 2, 8, 8), t(8, 8)),
    lambda t: image_resize.image_resize_batch(t(2, 16, 16), (t(8, 2),) * 2, (t(8, 2),) * 2),
    lambda t: image_normalize.image_crop_normalize_batch(t(2, 16, 16), 8, 8, 127.5, 64.0),
])
def test_non_cpu_tensor_never_falls_back(call):
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device that is not CUDA reaches the kernel's checks, which refuse it."""
    with pytest.raises(ValueError, match="CUDA"):
        call(lambda *s: torch.empty(s, device="meta"))


def test_build_is_lazy_and_named_by_sources():
    if not torch.cuda.is_available():
        assert build._lib is None  # importing and using the package built nothing
    p = build.library_path()
    assert p.parent == build.BUILD_DIR and p.name.startswith("libpreba_dpu_")
    assert all((build.CSRC / s).exists() for s in build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
