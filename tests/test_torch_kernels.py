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
@pytest.mark.parametrize("length", [97, 1000, 48001])
def test_resample_plain_pads_the_signal_itself(n, length):
    """pad_left = taps // 2 on the unpadded stack is the reference's padding
    (72 zeros left, 144 right) then its plain oracle, at lengths that leave
    the kernel's tiles partial."""
    x = _signals(n, seed=length + n, length=length)
    h = torch.tensor(rpp.fir_lowpass(48 * 3, 1.0 / 3), dtype=torch.float32)
    n_out = (length + 2) // 3
    got = audio_resample.audio_resample_batch_plain(torch.from_numpy(x), h, 3, n_out,
                                                    pad_left=72)
    assert got.shape == (n, n_out)
    assert_allclose(got.numpy(), _ref_resample(x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("down,taps", [(2, 48), (3, 144), (4, 192)])
def test_resample_plain_without_pad_left_is_the_plain_fir(down, taps):
    """pad_left = 0 on a pre-padded stack is y[i] = sum_k h[k] xp[i*down + k]
    exactly, for every output whose window lies in the stack; n_out may
    reach (L + pad_left) // down + 1, the windows past the end reading
    zeros."""
    xp = torch.from_numpy(_signals(3, seed=taps, length=1301))
    h = torch.from_numpy(np.random.default_rng(down).standard_normal(taps).astype(np.float32))
    n = (xp.shape[1] - taps) // down + 1
    want = (xp.unfold(1, taps, down)[:, :n] * h).sum(-1)
    assert torch.equal(audio_resample.audio_resample_batch_plain(xp, h, down, n), want)
    full = audio_resample.audio_resample_batch(xp, h, down)
    assert full.shape == (3, xp.shape[1] // down + 1)
    assert torch.equal(full[:, :n], want)
    last = (full.shape[1] - 1) * down  # the last window starts here and runs past the end
    tail = xp[:, last:]
    assert_allclose(full[:, -1].numpy(), (tail * h[:tail.shape[1]]).sum(-1).numpy(),
                    rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="n_out"):
        audio_resample.audio_resample_batch(xp, h, down, xp.shape[1] // down + 2)
    with pytest.raises(ValueError, match="pad_left"):
        audio_resample.audio_resample_batch(xp, h, down, pad_left=-1)


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
    """The plain version (framing, Stockham FFT, split, band sums) against
    the dense three products on the same frames (ref.mel_spectrogram_ref)."""
    rng = np.random.default_rng(n_mels)
    y = torch.from_numpy(rng.standard_normal((3, 1700)).astype(np.float32))
    for n_fft, frame in ((256, 200), (512, 400)):
        win, tw, w, bands = ops.mel_constants(n_fft, frame, n_mels, 16000, torch.device("cpu"))
        got = mel_spectrogram.mel_spectrogram_batch(y, win, tw, w, bands, 160)
        assert got.shape == (3, 1 + (1700 - frame) // 160, n_mels)
        cr, ci, fb = ref.mel_dense_operands(n_fft, n_mels, 16000, torch.device("cpu"))
        want = ref.mel_spectrogram_ref(mel_spectrogram.frames(y, win, 160, n_fft), cr, ci, fb)
        assert_allclose(got.reshape(-1, n_mels).numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_mels", [40, 80])
@pytest.mark.parametrize("n_fft,frame,hop", [(256, 200, 80), (512, 400, 160)])
@pytest.mark.parametrize("n", [1, 3])
def test_mel_sweep_matches_jax(n, n_fft, frame, hop, n_mels):
    """ops.mel_spectrogram_batch against the JAX package's (Pallas in
    interpret mode) across N, n_mels and n_fft; at N = 1 the last frame
    ends exactly at the signal's end."""
    length = frame + 7 * hop + (0 if n == 1 else 37)
    y = _signals(n, seed=n_fft + n_mels + n, length=length)
    kw = dict(n_fft=n_fft, frame=frame, hop=hop, n_mels=n_mels)
    got = ops.mel_spectrogram_batch(torch.from_numpy(y), **kw).numpy()
    want = np.asarray(rops.mel_spectrogram_batch(jnp.asarray(y), **kw))
    assert got.shape == want.shape == (n, 8, n_mels)
    assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048])
def test_mel_fft_passes_match_torch_fft(n_fft):
    """The plain version's Stockham passes (radix 8, then 4 or 2) are an
    FFT of n_fft / 2 points."""
    z = torch.from_numpy(np.random.default_rng(n_fft).standard_normal((3, n_fft // 2, 2))
                         .astype(np.float32))
    z = torch.complex(z[..., 0], z[..., 1])
    tw = torch.from_numpy(mel_spectrogram.fft_twiddles(n_fft))
    got = mel_spectrogram._stockham(z, torch.complex(tw[:, 0], tw[:, 1]))
    assert np.prod(mel_spectrogram.fft_radices(n_fft // 2)) == n_fft // 2
    assert_allclose(got.numpy(), torch.fft.fft(z).numpy(), rtol=1e-4, atol=1e-4 * np.sqrt(n_fft))


@pytest.mark.parametrize("n_fft,n_mels", [(64, 20), (256, 40), (512, 80), (2048, 128)])
def test_mel_constants_reproduce_dense_matrices(n_fft, n_mels):
    """The twiddle table is row 1 of the DFT bases, bit for bit, and the
    band weights scattered back are the filterbank, bit for bit."""
    tw = mel_spectrogram.fft_twiddles(n_fft)
    cr, ci = pp.dft_matrices(n_fft)
    assert np.array_equal(tw[:n_fft // 2 + 1, 0], cr[1]) and np.array_equal(tw[:n_fft // 2 + 1, 1], ci[1])
    fb = pp.mel_filterbank(n_mels, n_fft, 16000)
    w, bands = mel_spectrogram.mel_bands(fb)
    dense = np.zeros_like(fb)
    for m, (lo, hi, off) in enumerate(bands):
        assert lo <= hi <= n_fft // 2 + 1
        dense[m, lo:hi] = w[off:off + hi - lo]
    assert np.array_equal(dense, fb)
    assert bands[-1, 2] + bands[-1, 1] - bands[-1, 0] == len(w)


@pytest.mark.parametrize("n_fft", [32, 500, 4096])
def test_mel_refuses_unsupported_n_fft(n_fft):
    with pytest.raises(ValueError, match="power of two"):
        ops.mel_spectrogram_batch(torch.zeros(1, 4096), n_fft=n_fft, frame=32, hop=16)


@pytest.mark.parametrize("t", [30, 398])
@pytest.mark.parametrize("n", [1, 3])
def test_normalize_batch_matches_reference(n, t):
    feats = (np.random.default_rng(20 + n).standard_normal((n, t, 80)) * 3 + 1).astype(np.float32)
    # an empty mel band: a constant log(1e-6) column, variance 0, scale 316
    feats[:, :, 2] = np.float32(np.log(1e-6))
    got = ops.audio_normalize_batch(torch.from_numpy(feats)).numpy()
    want = np.asarray(rops.audio_normalize_batch(jnp.asarray(feats)))
    assert_allclose(got, want, rtol=3e-3, atol=3e-3)
    for i in range(n):
        # the numpy chain in float64: in float32 its mean over axis 0 is one
        # serial sum, 0.014 off on the constant column at T = 398
        assert_allclose(got[i], rpp.normalize_meanvar(feats[i].astype(np.float64)),
                        rtol=3e-3, atol=3e-3)
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
    lambda t: mel_spectrogram.mel_spectrogram_batch(t(2, 1000), t(400), t(512, 2), t(425),
                                                    t(80, 3), 160),
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
