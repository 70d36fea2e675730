"""The hand-written kernels on the card (the DPU's and decode attention),
against their plain PyTorch versions; the within-port contracts of the
dense and SSM families and the fleets that serve them.

Marked `gpu`: they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch import kernels
from repro_torch.kernels import audio_normalize, audio_resample, build, mel_spectrogram, ops, ref
from repro_torch.kernels import decode_attention, image_normalize, image_resize, jpeg_idct


def _signals(n, seed=0, length=48000):
    return np.random.default_rng(seed).standard_normal((n, length)).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    x = torch.from_numpy(_signals(4, seed=40, length=48000)).cuda()
    h = ops.resample_taps(1, 3, 48, x.device)
    xp = torch.nn.functional.pad(x, (72, 144)).contiguous()
    assert_allclose(audio_resample.audio_resample_batch_kernel(xp, h, 3).cpu().numpy(),
                    audio_resample.audio_resample_batch_plain(xp, h, 3).cpu().numpy(),
                    rtol=1e-4, atol=1e-5)
    y = ops.audio_resample_batch(x, 1, 3)
    consts = ops.mel_constants(512, 400, 80, 16000, x.device)
    assert_allclose(mel_spectrogram.mel_spectrogram_batch_kernel(y, *consts, 160).cpu().numpy(),
                    mel_spectrogram.mel_spectrogram_batch_plain(y, *consts, 160).cpu().numpy(),
                    rtol=2e-4, atol=2e-4)
    feats = ops.mel_spectrogram_batch(y)
    assert_allclose(audio_normalize.audio_normalize_batch_kernel(feats).cpu().numpy(),
                    audio_normalize.audio_normalize_batch_plain(feats).cpu().numpy(),
                    rtol=3e-3, atol=3e-3)


@pytest.mark.gpu
def test_pipeline_on_card_matches_cpu_and_counts_launches(cuda):
    x = _signals(5, seed=41)
    kernels.reset_launch_counts()
    got = ops.audio_pipeline_batch(torch.from_numpy(x).to(cuda)).cpu().numpy()
    counts = kernels.launch_counts()
    assert {k: counts[k] for k in kernels.AUDIO_KERNELS} == {k: 1 for k in kernels.AUDIO_KERNELS}
    assert {k: counts[k] for k in kernels.IMAGE_KERNELS} == {k: 0 for k in kernels.IMAGE_KERNELS}
    want = ops.audio_pipeline_batch(torch.from_numpy(x)).numpy()
    assert got.shape == (5, 98, 80)
    assert_allclose(got, want, rtol=1e-3, atol=1e-2)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_inputs_on_card(cuda):
    x = torch.zeros(2, 400, device=cuda)
    h = torch.zeros(144, device=cuda)
    with pytest.raises(TypeError):
        audio_resample.audio_resample_batch(x.double(), h.double(), 3)
    with pytest.raises(ValueError):
        audio_resample.audio_resample_batch(x[:, ::2], h, 3)
    with pytest.raises(ValueError):
        audio_normalize.audio_normalize_batch(torch.zeros(2, 9, 80, device=cuda).transpose(1, 2))
    assert build.library_path().exists()


def _taps(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) / n


@pytest.mark.gpu
@pytest.mark.parametrize("taps", [48, 144, 192])
@pytest.mark.parametrize("down", [2, 3, 4])
@pytest.mark.parametrize("pad_left", [0, 72])
@pytest.mark.parametrize("n", [1, 3, 16])
def test_resample_kernel_matches_plain_on_card(cuda, n, pad_left, down, taps):
    """One launch, within 1e-4 of the plain version, at a length whose last
    tile is partial at every down and tile size; a signal's result does not
    depend on N (nor on the tile plan N selects)."""
    length = 9601
    x = torch.from_numpy(_signals(n, seed=n * down + taps, length=length)).to(cuda)
    h = torch.from_numpy(_taps(taps, down)).to(cuda)
    n_out = (length + down - 1) // down
    kernels.reset_launch_counts()
    got = audio_resample.audio_resample_batch_kernel(x, h, down, n_out, pad_left)
    assert kernels.launch_counts()["audio_resample"] == 1
    assert got.shape == (n, n_out)
    want = audio_resample.audio_resample_batch_plain(x, h, down, n_out, pad_left)
    assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)
    one = audio_resample.audio_resample_batch_kernel(x[-1:].contiguous(), h, down, n_out,
                                                     pad_left)
    assert torch.equal(one[0], got[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,length,down,taps", [
    (1, 48000, 3, 144), (16, 48001, 3, 144), (16, 96001, 3, 144), (1, 192000, 3, 144),
    (16, 192001, 3, 144), (16, 48001, 1, 48), (16, 192001, 2, 96), (16, 192001, 4, 192),
    (3, 4801, 1, 48), (2, 4801, 5, 240)])
def test_resample_kernel_tile_plans_on_card(cuda, n, length, down, taps):
    """The serve rate at the sizes that select each tile plan (R = 3 or 9
    outputs a thread, 32-128 threads a block), down = 1, and a down the
    kernel does not compile (one output a thread), all padding themselves
    by taps // 2, against the plain version; n_out up to (L + pad) // down
    + 1, whose last windows read zeros past the end."""
    x = torch.from_numpy(_signals(n, seed=length + down, length=length)).to(cuda)
    h = torch.from_numpy(_taps(taps, taps)).to(cuda)
    pad = taps // 2
    got = audio_resample.audio_resample_batch_kernel(x, h, down, pad_left=pad)
    assert got.shape == (n, (length + pad) // down + 1)
    want = audio_resample.audio_resample_batch_plain(x, h, down, pad_left=pad)
    assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_resample_path_launches_only_the_kernel_on_card(cuda):
    """ops.audio_resample_batch hands the unpadded stack to the kernel: one
    resample launch and nothing else the counters see, equal bit for bit to
    the kernel with pad_left = 72 and within 1e-4 of the CPU path."""
    x = _signals(16, seed=43)
    xc = torch.from_numpy(x).to(cuda)
    kernels.reset_launch_counts()
    got = ops.audio_resample_batch(xc, 1, 3)
    assert kernels.launch_counts() == {k: int(k == "audio_resample") for k in kernels.KERNELS}
    h = ops.resample_taps(1, 3, 48, cuda)
    assert torch.equal(got, audio_resample.audio_resample_batch_kernel(xc, h, 3, 16000, 72))
    assert_allclose(got.cpu().numpy(), ops.audio_resample_batch(torch.from_numpy(x), 1, 3).numpy(),
                    rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,length,n_fft,frame,hop,n_mels", [
    (1, 16000, 512, 400, 160, 80), (16, 16000, 512, 400, 160, 80),      # chip_smoke's shapes
    (1, 64000, 512, 400, 160, 80), (16, 64000, 512, 400, 160, 80),
    (4, 16000, 512, 400, 160, 40), (3, 1360, 512, 400, 160, 80),        # n_mels 40; exact end
    (5, 9000, 256, 200, 80, 40), (2, 12000, 1024, 1000, 256, 80),
    (3, 3000, 64, 64, 32, 20), (2, 20000, 2048, 2048, 512, 128),        # the range's ends
    (7, 4000, 128, 100, 50, 30)])
def test_mel_kernel_matches_plain_on_card(cuda, n, length, n_fft, frame, hop, n_mels):
    """One launch frames, transforms and filters the stack, within 2e-4 of
    the plain version and of the dense products (ref.mel_spectrogram_ref,
    in float64: in fp32 they are off the exact log-mel by more than 2e-4
    where a band's power nears 0, as the DC bin's does in some frames)."""
    y = torch.from_numpy(_signals(n, seed=n_fft + n, length=length)).to(cuda)
    consts = ops.mel_constants(n_fft, frame, n_mels, 16000, cuda)
    kernels.reset_launch_counts()
    got = mel_spectrogram.mel_spectrogram_batch_kernel(y, *consts, hop)
    assert kernels.launch_counts()["mel_spectrogram"] == 1
    assert got.shape == (n, 1 + (length - frame) // hop, n_mels)
    assert_allclose(got.cpu().numpy(),
                    mel_spectrogram.mel_spectrogram_batch_plain(y, *consts, hop).cpu().numpy(),
                    rtol=2e-4, atol=2e-4)
    cr, ci, fb = ref.mel_dense_operands(n_fft, n_mels, 16000, cuda)
    frames = mel_spectrogram.frames(y, consts[0], hop, n_fft).double()
    dense = ref.mel_spectrogram_ref(frames, cr.double(), ci.double(), fb.double())
    assert_allclose(got.reshape(-1, n_mels).cpu().numpy(), dense.cpu().numpy(),
                    rtol=2e-4, atol=2e-4)
    one = mel_spectrogram.mel_spectrogram_batch_kernel(y[-1:].contiguous(), *consts, hop)
    assert torch.equal(one[0], got[-1])  # a signal's result does not depend on N


@pytest.mark.gpu
def test_mel_wrapper_refuses_bad_inputs_on_card(cuda):
    y = torch.zeros(2, 4000, device=cuda)
    win, tw, w, bands = ops.mel_constants(512, 400, 80, 16000, cuda)
    with pytest.raises(ValueError, match="power of two"):
        mel_spectrogram.mel_spectrogram_batch(y, win, tw[:500].contiguous(), w, bands, 160)
    with pytest.raises(ValueError, match="power of two"):
        mel_spectrogram.mel_spectrogram_batch(y, win, torch.zeros(4096, 2, device=cuda), w,
                                              bands, 160)
    with pytest.raises(TypeError):
        mel_spectrogram.mel_spectrogram_batch(y.double(), win, tw, w, bands, 160)
    with pytest.raises(ValueError):
        mel_spectrogram.mel_spectrogram_batch(y[:, ::2], win, tw, w, bands, 160)   # layout
    with pytest.raises(ValueError):
        mel_spectrogram.mel_spectrogram_batch(y, torch.zeros(600, device=cuda), tw, w, bands, 160)
    with pytest.raises(ValueError):
        mel_spectrogram.mel_spectrogram_batch(y[:, :300].contiguous(), win, tw, w, bands, 160)


_MEL_FEATS = {}


def _mel_feats(device, t, f):
    """[16, t, f] log-mel features of seeded noise from the port's mel
    kernel (made once per shape): band 2 of the 80-band filterbank is empty,
    so column 2 is the constant log(1e-6) and its exact output 0; the last
    utterance is silence (every column constant)."""
    if (t, f) not in _MEL_FEATS:
        y = np.random.default_rng(t + f).standard_normal((16, (t - 1) * 160 + 400)) * 0.1
        y[-1] = 0.0
        feats = ops.mel_spectrogram_batch(torch.from_numpy(y.astype(np.float32)).to(device),
                                          n_mels=f)
        assert feats.shape == (16, t, f)
        _MEL_FEATS[(t, f)] = feats
    return _MEL_FEATS[(t, f)]


@pytest.mark.gpu
@pytest.mark.parametrize("f", [80, 81, 128])
@pytest.mark.parametrize("t", [1, 7, 98, 398, 2998, 6000])
def test_normalize_kernel_matches_plain_on_card(cuda, t, f):
    """One launch of a cluster an utterance, at 3e-3 from the plain version
    at N in {1, 3, 16}: F = 81 takes the scalar path, T = 6,000 at F = 80
    the path that rereads its span from device memory. An utterance's
    output is the same bits in a stack of 1 and of 16."""
    feats = _mel_feats(cuda, t, f)
    plan = audio_normalize.plan(t, f)
    assert plan.cluster == min(4 if t < 998 else 8, 1 << (t.bit_length() - 1))
    assert plan.rows == -(-t // plan.cluster)
    if f == 80:
        assert plan.staged == (t < 6000)
    got = {}
    for n in (1, 3, 16):
        x = feats[16 - n:].clone()
        kernels.reset_launch_counts()
        y = audio_normalize.audio_normalize_batch_kernel(x)
        assert kernels.launch_counts()["audio_normalize"] == 1
        assert bool(build.library().preba_normalize_vectorized(
            x.data_ptr(), y.data_ptr(), f)) == (f % 4 == 0)
        assert_allclose(y.cpu().numpy(),
                        audio_normalize.audio_normalize_batch_plain(x).cpu().numpy(),
                        rtol=3e-3, atol=3e-3)
        got[n] = y
    assert torch.equal(got[1][0], got[16][-1])
    assert torch.equal(got[3], got[16][-3:])
    if f == 80:  # the empty band's exact output is 0
        assert float(got[16][..., 2].abs().max()) <= 3e-3
    assert float(got[16][-1].abs().max()) <= 3e-3  # silence


@pytest.mark.gpu
@pytest.mark.parametrize("t", [398, 2998, 6000])
def test_normalize_off_16_bytes_takes_the_scalar_path_on_card(cuda, t):
    """A contiguous stack whose storage starts one float past a 16-byte
    boundary: the same single launch, scalar, the same bits as the same
    utterances on the 16-byte path (staged, and at T = 6,000 reread)."""
    feats = _mel_feats(cuda, t, 80)[-3:]
    flat = torch.empty(feats.numel() + 1, device=cuda)
    flat[1:] = feats.flatten()
    x = flat[1:].view(feats.shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    kernels.reset_launch_counts()
    got = audio_normalize.audio_normalize_batch_kernel(x)
    assert kernels.launch_counts()["audio_normalize"] == 1
    assert not build.library().preba_normalize_vectorized(x.data_ptr(), got.data_ptr(), 80)
    aligned = audio_normalize.audio_normalize_batch_kernel(feats.clone())
    assert torch.equal(got, aligned)
    assert_allclose(got.cpu().numpy(),
                    audio_normalize.audio_normalize_batch_plain(x).cpu().numpy(),
                    rtol=3e-3, atol=3e-3)


def _coeffs(shape, seed):
    return np.random.default_rng(seed).integers(-32, 32, shape).astype(np.float32)


def _qtable(seed=0):
    return np.random.default_rng(seed).integers(1, 16, (8, 8)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 1, 8, 8), (1, 27, 19, 8, 8), (4, 64, 64, 8, 8),
                                   (3, 7, 5, 8, 8)])
def test_idct_kernel_matches_plain_on_card(cuda, shape):
    c = torch.from_numpy(_coeffs(shape, sum(shape))).to(cuda)
    q = torch.from_numpy(_qtable()).to(cuda)
    assert_allclose(jpeg_idct.jpeg_idct_batch_kernel(c, q).cpu().numpy(),
                    jpeg_idct.jpeg_idct_batch_plain(c, q).cpu().numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_idct_refuses_misaligned_coefficients_on_card(cuda):
    """The kernel reads 16 bytes at a time: a coefficient view 4 bytes off
    a 16-byte boundary is refused, never decoded by another path."""
    flat = torch.zeros(2 * 3 * 64 + 1, device=cuda)
    c = flat[1:].view(1, 2, 3, 8, 8)
    assert c.is_contiguous() and c.data_ptr() % 16 == 4
    q = torch.ones(8, 8, device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        jpeg_idct.jpeg_idct_batch(c, q)
    assert kernels.launch_counts()["jpeg_idct"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,hw,out", [(1, (256, 256), (256, 256)), (3, (320, 200), (112, 96)),
                                      (2, (512, 512), (256, 256)), (2, (70, 130), (257, 65))])
def test_resize_kernel_matches_plain_on_card(cuda, n, hw, out):
    """One launch for the stack, within 1e-4 of the plain two-tap gather
    and of the dense products (ref.image_resize_ref): ragged rows (W % 4 !=
    0) and upscaling with clamped edge taps in (70, 130) -> (257, 65)."""
    x = torch.from_numpy(np.random.default_rng(n).random((n, *hw), np.float32) * 255).to(cuda)
    yt, xt = ops.resize_taps(hw[0], out[0], cuda), ops.resize_taps(hw[1], out[1], cuda)
    kernels.reset_launch_counts()
    got = image_resize.image_resize_batch_kernel(x, yt, xt)
    assert kernels.launch_counts()["image_resize"] == 1
    assert got.shape == (n, *out)
    assert_allclose(got.cpu().numpy(),
                    image_resize.image_resize_batch_plain(x, yt, xt).cpu().numpy(),
                    rtol=1e-4, atol=1e-4)
    dense = ref.image_resize_ref(x, ops.resize_matrix(hw[0], out[0], cuda),
                                 ops.resize_matrix(hw[1], out[1], cuda))
    assert_allclose(got.cpu().numpy(), dense.cpu().numpy(), rtol=1e-4, atol=1e-4)
    one = image_resize.image_resize_batch_kernel(x[-1:].contiguous(), yt, xt)
    assert torch.equal(one[0], got[-1])  # an image's result does not depend on N


@pytest.mark.gpu
@pytest.mark.parametrize("n,hw,crop,vector", [
    (2, (256, 256), (224, 224), True), (16, (256, 256), (224, 224), True),
    (3, (224, 224), (224, 224), True), (1, (97, 130), (33, 101), False)])
def test_crop_normalize_kernel_matches_plain_on_card(cuda, n, hw, crop, vector):
    """One launch, equal to the plain version bit for bit (a subtract, then
    a multiply, each rounded in fp32), on the 16-byte path (256 -> 224, the
    serve shape; the uncropped stack) and on the scalar path (an odd crop
    origin and width)."""
    x = torch.from_numpy(np.random.default_rng(n).random((n, *hw), np.float32) * 255).to(cuda)
    x0 = image_normalize.crop_origin(*hw, *crop)[1]
    for mean, std in ((127.5, 64.0), (110.3, 57.1)):
        kernels.reset_launch_counts()
        got = image_normalize.image_crop_normalize_batch_kernel(x, *crop, mean, std)
        assert kernels.launch_counts()["image_normalize"] == 1
        assert torch.equal(got, image_normalize.image_crop_normalize_batch_plain(
            x, *crop, mean, std))
        assert build.library().preba_crop_normalize_vectorized(
            x.data_ptr(), got.data_ptr(), hw[1], x0, crop[1]) == vector


@pytest.mark.gpu
def test_crop_normalize_off_16_bytes_takes_the_scalar_path_on_card(cuda):
    """A contiguous stack whose storage starts one float past a 16-byte
    boundary: the same launch, scalar, still bit for bit."""
    flat = torch.from_numpy(np.random.default_rng(5).random(2 * 256 * 256 + 1, np.float32)
                            * 255).to(cuda)
    x = flat[1:].view(2, 256, 256)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    kernels.reset_launch_counts()
    got = image_normalize.image_crop_normalize_batch_kernel(x, 224, 224, 127.5, 64.0)
    assert kernels.launch_counts()["image_normalize"] == 1
    assert not build.library().preba_crop_normalize_vectorized(
        x.data_ptr(), got.data_ptr(), 256, 16, 224)
    assert torch.equal(got, image_normalize.image_crop_normalize_batch_plain(
        x, 224, 224, 127.5, 64.0))


@pytest.mark.gpu
def test_image_pipeline_on_card_matches_cpu_and_counts_launches(cuda):
    c, q = _coeffs((3, 48, 64, 8, 8), 42), _qtable(1)
    kernels.reset_launch_counts()
    got = ops.image_pipeline_batch(torch.from_numpy(c).to(cuda),
                                   torch.from_numpy(q).to(cuda)).cpu().numpy()
    assert kernels.launch_counts() == {
        "audio_resample": 0, "mel_spectrogram": 0, "audio_normalize": 0,
        "jpeg_idct": 1, "image_resize": 1, "image_normalize": 1, "decode_attention": 0}
    want = ops.image_pipeline_batch(torch.from_numpy(c), torch.from_numpy(q)).numpy()
    assert got.shape == (3, 224, 224)
    assert_allclose(got, want, rtol=1e-3, atol=1e-2)


@pytest.mark.gpu
def test_image_wrappers_refuse_bad_inputs_on_card(cuda):
    c = torch.zeros(1, 2, 2, 8, 8, device=cuda)
    q = torch.ones(8, 8, device=cuda)
    with pytest.raises(TypeError):
        jpeg_idct.jpeg_idct_batch(c.double(), q.double())
    with pytest.raises(ValueError):
        jpeg_idct.jpeg_idct_batch(c[0], q)                       # rank
    with pytest.raises(ValueError):
        jpeg_idct.jpeg_idct_batch(c.transpose(3, 4), q)          # contiguity
    x = torch.zeros(2, 16, 16, device=cuda)
    taps = ops.resize_taps(16, 8, cuda)
    with pytest.raises(TypeError):
        image_resize.image_resize_batch(x.double(), taps, taps)
    with pytest.raises(TypeError):
        image_resize.image_resize_batch(x, (taps[0].long(), taps[1]), taps)
    with pytest.raises(ValueError):
        image_resize.image_resize_batch(x[0], taps, taps)
    with pytest.raises(ValueError):
        image_resize.image_resize_batch(x.transpose(1, 2), taps, taps)
    with pytest.raises(ValueError):
        image_resize.image_resize_batch(x, (taps[0][:, :1], taps[1][:, :1]), taps)  # rank of taps
    with pytest.raises(TypeError):
        image_normalize.image_crop_normalize_batch(x.double(), 8, 8, 127.5, 64.0)
    with pytest.raises(ValueError):
        image_normalize.image_crop_normalize_batch(x[0], 8, 8, 127.5, 64.0)
    with pytest.raises(ValueError):
        image_normalize.image_crop_normalize_batch(x.transpose(1, 2), 8, 8, 127.5, 64.0)


# --- decode attention ----------------------------------------------------------

DECODE_SHAPES = [(2, 8, 4, 64, 512), (1, 7, 7, 128, 300), (4, 16, 16, 64, 1024),
                 (8, 32, 4, 64, 144), (8, 32, 4, 64, 2048), (4, 4, 2, 32, 74),
                 (8, 32, 8, 80, 4096), (3, 12, 3, 80, 300),  # h2o-danube's head size 80
                 (8, 32, 32, 96, 144), (8, 32, 32, 96, 4096),  # phi-3-vision's: D 96, G 1
                 (3, 12, 4, 96, 300), (8, 8, 8, 64, 1500)]  # whisper's cross-attention


def _decode_inputs(shape, dtype, device, seed, valid=None):
    b, h, kh, d, s = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device, dtype)
               for sh in ((b, h, d), (b, s, kh, d), (b, s, kh, d)))
    vl = rng.integers(1, s + 1, (b,)) if valid is None else np.asarray(valid)
    return q, k, v, torch.from_numpy(vl.astype(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_matches_plain_on_card(cuda, shape, dtype):
    q, k, v, vl = _decode_inputs(shape, dtype, cuda, seed=sum(shape))
    kernels.reset_launch_counts()
    got = decode_attention.decode_attention_kernel(q, k, v, vl)
    assert kernels.launch_counts()["decode_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    want = decode_attention.decode_attention_plain(q, k, v, vl)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_decode_attention_zero_valid_length_on_card(cuda):
    """valid_len == 0 returns the mean of V over the S positions, as the
    plain version does; the other rows are unaffected."""
    shape = (3, 8, 4, 64, 300)
    q, k, v, vl = _decode_inputs(shape, torch.float32, cuda, seed=5, valid=[0, 17, 300])
    got = decode_attention.decode_attention_kernel(q, k, v, vl).cpu()
    want = decode_attention.decode_attention_plain(q, k, v, vl).cpu()
    assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    mean_v = v[0].mean(0).repeat_interleave(2, dim=0).cpu()
    assert_allclose(got[0].numpy(), mean_v.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_whisper_cross_shape_on_card(cuda, dtype):
    """whisper's cross-attention decode: B 8, H 8, KH 8 (one query head a KV
    head), D 64, every one of the 1,500 encoder positions valid."""
    q, k, v, vl = _decode_inputs((8, 8, 8, 64, 1500), dtype, cuda, seed=15, valid=[1500] * 8)
    got = decode_attention.decode_attention_kernel(q, k, v, vl)
    want = decode_attention.decode_attention_plain(q, k, v, vl)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_decode_attention_ignores_positions_past_valid_length_on_card(cuda):
    """A row's result depends on its valid prefix only: other values past
    valid_len, or a longer S, change no bit."""
    q, k, v, vl = _decode_inputs((2, 32, 4, 64, 144), torch.bfloat16, cuda, seed=6,
                                 valid=[70, 130])
    a = decode_attention.decode_attention_kernel(q, k, v, vl)
    k2, v2 = k.clone(), v.clone()
    k2[0, 70:], v2[0, 70:] = 7.0, -7.0
    b = decode_attention.decode_attention_kernel(q, k2, v2, vl)
    longer = [torch.cat([t, torch.randn_like(t)], dim=1) for t in (k, v)]
    c = decode_attention.decode_attention_kernel(q, *longer, vl)
    assert torch.equal(a, b) and torch.equal(a, c)


# the rank shapes of the small-serve layout (B, H, KH, D, S): whisper-base's
# self-attention over a 64-slot ring at tp 2 and 4, its cross-attention over
# 1,500 frames at tp 2 and 4, tinyllama-1.1b's ring of 64 at tp 2
LSE_SHAPES = [(8, 8, 8, 64, 32), (8, 8, 8, 64, 16), (8, 8, 8, 64, 750), (8, 8, 8, 64, 375),
              (8, 32, 4, 64, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LSE_SHAPES)
def test_decode_attention_lse_matches_plain_on_card(cuda, shape, dtype):
    """return_lse=True: o within 2e-4 (fp32) or 3e-2 (bf16) of the plain
    version's, lse within 1e-4; rows with no valid key (rows 0 and 5) give
    o = 0 and lse = -inf; one launch, counted; and without the lse the
    kernel's o is bit for bit what it was (a null lse pointer)."""
    s = shape[-1]
    valid = [0, 1, s // 3, s - 1, s, 0, 2, s][:shape[0]]
    q, k, v, vl = _decode_inputs(shape, dtype, cuda, seed=sum(shape) + 27, valid=valid)
    kernels.reset_launch_counts()
    o, lse = decode_attention.decode_attention_kernel(q, k, v, vl, return_lse=True)
    assert kernels.launch_counts()["decode_attention"] == 1
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    want_o, want_lse = decode_attention.decode_attention_plain(q, k, v, vl, return_lse=True)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    assert_allclose(o.float().cpu().numpy(), want_o.float().cpu().numpy(), rtol=tol, atol=tol)
    assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(), rtol=1e-4, atol=1e-4)
    empty = [i for i, x in enumerate(valid) if x == 0]
    assert bool(torch.isneginf(lse[empty]).all()) and not bool(o[empty].any())
    plain = decode_attention.decode_attention_kernel(q, k, v, vl)
    keep = [i for i, x in enumerate(valid) if x > 0]
    assert torch.equal(plain[keep], o[keep])


BOUNDARY_VALID = (1, 63, 64, 65, 511, 512, 513)  # tiles of 64, cluster rounds of 8 x 64


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("s", [74, 2049])
def test_decode_attention_at_tile_and_cluster_boundaries_on_card(cuda, s, d, dtype):
    """valid_len on both sides of a 64-key tile and of a round of the 8-block
    cluster (512 keys), and the whole ring, one row each; G = 8 as in
    tinyllama."""
    valid = [x for x in BOUNDARY_VALID if x < s] + [s]
    q, k, v, vl = _decode_inputs((len(valid), 16, 2, d, s), dtype, cuda, seed=s + d,
                                 valid=valid)
    kernels.reset_launch_counts()
    got = decode_attention.decode_attention_kernel(q, k, v, vl)
    assert kernels.launch_counts()["decode_attention"] == 1
    want = decode_attention.decode_attention_plain(q, k, v, vl)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_decode_attention_rows_spanning_the_cluster_ignore_S_and_B_on_card(cuda):
    """Rows whose valid prefix spans several blocks of the cluster (300 keys:
    5 blocks; 1,300: all 8, three of them twice) give the same bits at S =
    1,536 and at S = 4,096 with noise past valid_len (NaN keys and infinite
    values in row 0: the kernel never uses them), and alone as in a
    batch."""
    q, k, v, vl = _decode_inputs((2, 32, 4, 64, 1536), torch.bfloat16, cuda, seed=8,
                                 valid=[300, 1300])
    a = decode_attention.decode_attention_kernel(q, k, v, vl)
    noise = torch.Generator(device=cuda).manual_seed(9)
    longer = []
    for t in (k, v):
        t2 = torch.randn((2, 4096, 4, 64), generator=noise, device=cuda).to(t.dtype)
        t2[:, :1536] = t
        t2[0, 300:] = float("nan") if t is k else float("inf")
        t2[1, 1300:] = 5.0
        longer.append(t2)
    b = decode_attention.decode_attention_kernel(q, *longer, vl)
    c = torch.cat([decode_attention.decode_attention_kernel(
        q[i:i + 1].contiguous(), k[i:i + 1].contiguous(), v[i:i + 1].contiguous(), vl[i:i + 1])
        for i in range(2)])
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_decode_attention_head_dim_80_ignores_positions_past_valid_length_on_card(cuda):
    """At head size 80 (20 lanes of 4 columns) a row's bits depend on its
    valid prefix only, and a row alone gives the bits it gives in a batch."""
    q, k, v, vl = _decode_inputs((2, 32, 8, 80, 600), torch.bfloat16, cuda, seed=16,
                                 valid=[70, 577])
    a = decode_attention.decode_attention_kernel(q, k, v, vl)
    k2, v2 = k.clone(), v.clone()
    k2[0, 70:], v2[0, 70:] = 7.0, -7.0
    b = decode_attention.decode_attention_kernel(q, k2, v2, vl)
    c = torch.cat([decode_attention.decode_attention_kernel(
        q[i:i + 1].contiguous(), k[i:i + 1].contiguous(), v[i:i + 1].contiguous(), vl[i:i + 1])
        for i in range(2)])
    assert torch.equal(a, b) and torch.equal(a, c)


def _plain_swapped(fn):
    """fn() with the decode kernel's plain version in its place."""
    real = ops.decode_attention
    ops.decode_attention = decode_attention.decode_attention_plain
    try:
        return fn()
    finally:
        ops.decode_attention = real


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b", "h2o-danube-1.8b",
                                  "jamba-v0.1-52b", "phi-3-vision-4.2b", "whisper-base"])
def test_window_and_moe_decode_match_the_plain_path_on_card(cuda, arch):
    """Reduced fp32 models: a 12-token prompt (whisper's with 24 stub audio
    frames), then 24 decode steps (the 16-slot window ring of danube and
    mixtral wraps at step 4) with the kernel, and the same with its plain
    version: logits every step within 2e-4, greedy tokens equal, one launch
    an attention layer (self and cross) a step. The MoE layers' dispatch
    and jamba's SSM layers run on the card in both."""
    from dataclasses import replace

    from repro_torch.configs import reduced
    from repro_torch.models import lm
    from repro_torch.models.params import init_params

    cfg = replace(reduced(arch), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))).to(cuda)
    ctx = {"audio_frames": torch.from_numpy(rng.standard_normal(
        (2, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)).to(cuda)} if cfg.enc_layers else {}
    n_attn = sum(m == "attn" for m, _ in cfg.layer_kinds()) + (
        cfg.n_layers if cfg.enc_layers else 0)

    def run():
        logits, cache = lm.prefill(params, prompt, cfg, cache_len=40, **ctx)
        out = [logits]
        tok = torch.argmax(logits, -1)
        for i in range(24):
            logits, cache = lm.decode(params, cache, tok, 12 + i, cfg)
            tok = torch.argmax(logits, -1)
            out.append(logits)
        return torch.cat(out, dim=1)

    kernels.reset_launch_counts()
    got = run()
    assert kernels.launch_counts()["decode_attention"] == 24 * n_attn
    want = _plain_swapped(run)
    assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.gpu
def test_decode_attention_wrapper_refuses_bad_inputs_on_card(cuda):
    q, k, v, vl = _decode_inputs((2, 8, 4, 64, 64), torch.float32, cuda, seed=7)
    with pytest.raises(TypeError):
        decode_attention.decode_attention(q.half(), k.half(), v.half(), vl)
    with pytest.raises(TypeError):
        decode_attention.decode_attention(q, k, v, vl.long())
    with pytest.raises(ValueError):
        decode_attention.decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                          v[..., :48].contiguous(), vl)   # head size
    with pytest.raises(ValueError):
        decode_attention.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), vl)
    flat = torch.zeros(k.numel() + 1, dtype=k.dtype, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        decode_attention.decode_attention(q, flat[1:].view(k.shape), v, vl)  # misaligned


@pytest.mark.gpu
def test_engine_decode_launches_once_per_layer_and_step_on_card(cuda):
    """Every decode step of every engine mode runs the kernel once per
    layer."""
    from repro_torch.configs import reduced
    from repro_torch.core.batching.buckets import Request
    from repro_torch.serving.engine import EngineConfig, build_engine

    cfg = reduced("tinyllama-1.1b")
    for ec in (EngineConfig(continuous=False, max_new_tokens=6),
               EngineConfig(continuous=False, max_new_tokens=6, fused_decode=False,
                            pad_buckets=False),
               EngineConfig(continuous=True, max_slots=4, segment_len=4, max_new_tokens=6,
                            max_prompt_len=64, chunk_lens=(8,),
                            prefix_cache_bytes=16 << 20)):
        eng = build_engine(cfg, ec=ec, device=cuda)
        eng.submit_many([Request(rid=i, arrival=0.0, length=float(n))
                         for i, n in enumerate((40, 3, 17, 9, 33))])
        kernels.reset_launch_counts()
        done = eng.run_until_idle()
        assert len(done) == 5 and all(len(r.payload) == 6 for r in done)
        assert kernels.launch_counts()["decode_attention"] == \
            cfg.n_layers * eng.stats["decode_steps"] > 0


# --- the within-port contracts at full width (d_model 2048, GQA 32/4,
# d_ff 5632, vocab 32000; 2 layers, bf16, seeded weights) -------------------
#
# Each compares logits and KV bits, under torch's default backend flags:
# these tests set none, and the package pins none (on the H100 no contract
# changed with TF32 off and the bf16/fp16 reduced-precision reductions off;
# PERF.md §6).

CONTRACT_BUDGET = 8


@pytest.fixture(scope="module")
def full_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the contracts are held on the card")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.api import LM
    from repro_torch.models.params import init_params

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    assert cfg.dtype == "bfloat16" and cfg.d_model == 2048
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, LM(cfg, init_params(cfg, gen, dev, cfg.dtype)), dev


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n)


def _block(cfg, lens, lp, seed, dev):
    """Left-padded [len(lens), lp] prompt block and its offsets."""
    toks = np.zeros((len(lens), lp), np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = _prompt(cfg, n, seed + i)
    off = np.array([lp - n for n in lens], np.int64)
    return torch.from_numpy(toks).to(dev), torch.from_numpy(off).to(dev)


def _kv(pool, row, n):
    """Row `row` of a pool or prefill cache, true positions [0, n), both leaves."""
    from repro_torch.models import lm

    k, v = lm._kv_leaves(pool)
    return torch.stack([k[:, row, :n], v[:, row, :n]])


def _assert_bits(got, want, what):
    assert got.shape == want.shape, what
    diff = (got.float() - want.float()).abs()
    assert torch.equal(got, want), (
        f"{what}: {int((got != want).sum())} of {got.numel()} elements differ, "
        f"largest difference {float(diff.max()):.3e}")


def _step_logits(model, pool, row, tok, pos):
    """Logits of one more decode step of pool row `row` (a one-row copy of
    it), at true position `pos` after token `tok`."""
    from repro_torch.models import lm

    k, v = lm._kv_leaves(pool)
    one = {"body": {"l0": {"mixer": {"k": k[:, row:row + 1].clone(),
                                      "v": v[:, row:row + 1].clone()}}}}
    t = torch.tensor([[int(tok)]], device=k.device)
    logits, _ = model.decode(one, t, pos)
    return logits[0, 0]


@pytest.mark.gpu
def test_contract_padded_equals_unpadded_on_card(full_width):
    """A prompt prefilled alone at its own length == the same prompt
    left-padded into a larger bucket next to other rows: last-position
    logits and the K/V at its true positions, bit for bit. On a failure the
    message also gives the greedy tokens' agreement over 8 generated
    tokens (the run-to-completion path: prefill, then lm.generate)."""
    cfg, model, dev = full_width
    n, lp, steps = 20, 32, CONTRACT_BUDGET
    alone = torch.from_numpy(_prompt(cfg, n, 1)[None]).to(dev)
    la, ca = model.prefill(alone, cache_len=n + steps)
    toks, off = _block(cfg, [n, 30, 7], lp, 1, dev)  # row 0: the same prompt
    lb, cb = model.prefill(toks, pos_offset=off, cache_len=lp + steps)
    logits_equal = torch.equal(lb[0], la[0])
    kv_equal = torch.equal(_kv(cb, 0, n), _kv(ca, 0, n))
    ta, _ = model.generate(ca, la, n, steps=steps)
    tb, _ = model.generate(cb, lb, lp, steps=steps, pos_offset=off)
    agree = int((ta[0] == tb[0]).sum())
    assert logits_equal and kv_equal, (
        f"padded != unpadded: logits largest difference "
        f"{float((lb[0].float() - la[0].float()).abs().max()):.3e}, K/V equal {kv_equal} "
        f"(largest difference {float((_kv(cb, 0, n).float() - _kv(ca, 0, n).float()).abs().max()):.3e}), "
        f"greedy tokens agree {agree} of {steps}")


def _pool_admit(model, cfg, dev, pool, slot, n, seed, clock):
    from repro_torch.models import lm

    lp = max(8, 1 << (n - 1).bit_length())
    toks, off = _block(cfg, [n], lp, seed, dev)
    tok0, pool = model.prefill_into_slots(toks, pool, torch.tensor([slot], device=dev),
                                          clock, pos_offset=off)
    return tok0, pool


@pytest.mark.gpu
def test_contract_join_equals_alone_on_card(full_width):
    """Request B admitted into a slot while A is mid-decode (another clock,
    another bucket) decodes as it does alone in the same pool: its tokens,
    its K/V row, and the logits of its next step, bit for bit."""
    from repro_torch.models import lm

    cfg, model, dev = full_width
    ring, nb, steps = 144, 37, CONTRACT_BUDGET

    def serve_b(pool, clock, poff, tok):
        t0b, pool = _pool_admit(model, cfg, dev, pool, 1, nb, 5, clock)
        poff[1] = clock - nb
        tok = tok.clone()
        tok[1] = t0b[0]
        seg, pool = model.decode_segment(pool, tok, clock, steps=steps, pos_offset=poff)
        return seg[1], pool

    pool = lm.alloc_slot_pool(cfg, 2, ring, dev)
    solo, pool_a = serve_b(pool, 64, torch.tensor([0, 0], device=dev),
                           torch.zeros(2, 1, dtype=torch.long, device=dev))

    pool = lm.alloc_slot_pool(cfg, 2, ring, dev)
    clock = 128
    t0a, pool = _pool_admit(model, cfg, dev, pool, 0, 100, 4, clock)
    poff = torch.tensor([clock - 100, 0], device=dev)
    tok = torch.cat([t0a, torch.zeros(1, 1, dtype=torch.long, device=dev)])
    seg, pool = model.decode_segment(pool, tok, clock, steps=3, pos_offset=poff)
    clock += 3
    tok = torch.cat([seg[:1, -1:], torch.zeros(1, 1, dtype=torch.long, device=dev)])
    joined, pool_j = serve_b(pool, clock, poff, tok)

    _assert_bits(joined, solo, "join tokens")
    _assert_bits(_kv(pool_j, 1, nb + steps), _kv(pool_a, 1, nb + steps), "join K/V")
    _assert_bits(_step_logits(model, pool_j, 1, joined[-1], nb + steps),
                 _step_logits(model, pool_a, 1, solo[-1], nb + steps), "join logits")


@pytest.mark.gpu
def test_contract_chained_segments_equal_sequential_decode_on_card(full_width):
    """decode_segment(3) then decode_segment(5) == eight single decode
    steps: tokens, the pool's K/V and the next step's logits, bit for bit."""
    from repro_torch.models import lm

    cfg, model, dev = full_width
    clock, lens = 64, (50, 13)

    def admitted():
        pool = lm.alloc_slot_pool(cfg, 2, 144, dev)
        toks, off = _block(cfg, list(lens), 64, 7, dev)
        tok0, pool = model.prefill_into_slots(toks, pool, torch.arange(2, device=dev),
                                              clock, pos_offset=off)
        return tok0, pool, torch.tensor([clock - n for n in lens], device=dev)

    tok0, pool_c, poff = admitted()
    s1, pool_c = model.decode_segment(pool_c, tok0, clock, steps=3, pos_offset=poff)
    s2, pool_c = model.decode_segment(pool_c, s1[:, -1:], clock + 3, steps=5,
                                      pos_offset=poff)
    chained = torch.cat([s1, s2], dim=1)
    tok, pool_s, poff = admitted()
    seq = []
    for i in range(8):
        logits, pool_s = model.decode(pool_s, tok, clock + i, pos_offset=poff)
        tok = torch.argmax(logits, -1)
        seq.append(tok)
    seq = torch.cat(seq, dim=1)
    _assert_bits(chained, seq, "chained tokens")
    for row, n in enumerate(lens):
        _assert_bits(_kv(pool_c, row, n + 8), _kv(pool_s, row, n + 8), f"row {row} K/V")
        _assert_bits(_step_logits(model, pool_c, row, chained[row, -1], n + 8),
                     _step_logits(model, pool_s, row, seq[row, -1], n + 8),
                     f"row {row} logits")


@pytest.mark.gpu
def test_contract_chunked_equals_monolithic_on_card(full_width):
    """A 100-token prompt admitted in 32-token chunks == admitted in one
    prefill: the first token, the K/V at its true positions, and the logits
    of the next decode step, bit for bit."""
    from repro_torch.models import lm

    cfg, model, dev = full_width
    n, lp, c, clock = 100, 128, 32, 128
    toks, off = _block(cfg, [n], lp, 9, dev)
    pool_m = lm.alloc_slot_pool(cfg, 2, 144, dev)
    tok_m, pool_m = model.prefill_into_slots(toks, pool_m, torch.tensor([0], device=dev),
                                             clock, pos_offset=off)
    pool_c = lm.alloc_slot_pool(cfg, 2, 144, dev)
    rows = torch.zeros(2, lp, dtype=torch.long, device=dev)
    rows[0] = toks[0]
    roff = torch.tensor([lp - n, lp], device=dev)  # row 1: not in the admission
    for col in range(0, lp, c):
        start = torch.tensor([col, 0], device=dev)
        tok_c, pool_c = model.prefill_chunk_into_slots(rows[:, col:col + c], pool_c, start,
                                                       pos_offset=roff, lp=lp)
    _assert_bits(tok_c[:1], tok_m, "chunked first token")
    _assert_bits(_kv(pool_c, 0, n), _kv(pool_m, 0, n), "chunked K/V")
    _assert_bits(_step_logits(model, pool_c, 0, tok_c[0, 0], n),
                 _step_logits(model, pool_m, 0, tok_m[0, 0], n), "chunked logits")


def _serve_alone(engine, reqs):
    """Serve `reqs` to the end; returns {rid: (tokens, pool row)} with each
    request's pool row as it was when the request retired."""
    rows = {}
    orig = engine._retire_finished

    def spy(now):
        for s, st in enumerate(engine._slots):
            if st is not None and st.live:
                rows[st.req.rid] = s
        orig(now)

    engine._retire_finished = spy
    engine.submit_many(reqs)
    done = engine.run_until_idle()
    torch.cuda.synchronize()
    mine = {r.rid for r in reqs}
    return {r.rid: (np.asarray(r.payload), rows[r.rid]) for r in done if r.rid in mine}


@pytest.mark.gpu
def test_contract_prefix_hit_equals_cold_prefill_on_card(full_width):
    """A request whose prompt shares a 64-token template with an earlier
    one (its prefix scattered from the radix store, the suffix chunked) ==
    the same request prefilled cold: tokens, K/V row, next-step logits."""
    from repro_torch.core.batching.buckets import Request
    from repro_torch.serving.engine import EngineConfig, build_engine

    cfg, model, dev = full_width
    template = _prompt(cfg, 64, 11)
    donor = np.r_[template, _prompt(cfg, 26, 12)]
    probe = np.r_[template, _prompt(cfg, 36, 13)]
    base = dict(continuous=True, max_slots=4, segment_len=CONTRACT_BUDGET,
                max_new_tokens=CONTRACT_BUDGET, max_prompt_len=128, chunk_lens=(32,))

    def req(rid, p):
        return Request(rid=rid, arrival=0.0, length=float(len(p)), prompt=p)

    hit = build_engine(cfg, ec=EngineConfig(**base, prefix_cache_bytes=64 << 20),
                       device=dev, params=model.tree())
    _serve_alone(hit, [req(1, donor)])
    got = _serve_alone(hit, [req(2, probe)])
    assert hit.stats["prefix_hits"] == 1 and hit.stats["prefix_hit_tokens"] > 0
    cold = build_engine(cfg, ec=EngineConfig(**base), device=dev, params=model.tree())
    want = _serve_alone(cold, [req(2, probe)])
    n = len(probe) + CONTRACT_BUDGET  # prompt + the 8 decode steps' writes
    (gt, gs), (wt, ws) = got[2], want[2]
    np.testing.assert_array_equal(gt, wt)
    _assert_bits(_kv(hit._pool, gs, n), _kv(cold._pool, ws, n), "prefix K/V")
    _assert_bits(_step_logits(model, hit._pool, gs, gt[-1], n - 1),
                 _step_logits(model, cold._pool, ws, wt[-1], n - 1), "prefix logits")


def _fleet_requests(lens, model=None, rid0=0):
    from repro_torch.core.batching.buckets import Request

    return [Request(rid=rid0 + i, arrival=0.0, length=float(n),
                    max_new_tokens=CONTRACT_BUDGET, model=model)
            for i, n in enumerate(lens)]


# one prompt bucket (33-64 tokens pad to 64) so every admission has one shape
FLEET_LENS = [48, 33, 61, 40, 57, 36, 64, 45]


@pytest.mark.gpu
def test_contract_multi_slice_equals_single_slice_on_card(full_width):
    """Two slices, each an engine on its own CUDA stream, sharing one
    LM == one engine: per request the tokens, the K/V row it left in
    its slice's pool and the logits of its next step, bit for bit."""
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.multislice import build_multislice_engine

    cfg, model, dev = full_width
    ec = EngineConfig(continuous=True, max_slots=8, segment_len=CONTRACT_BUDGET,
                      max_new_tokens=CONTRACT_BUDGET, max_prompt_len=128)
    single = build_engine(cfg, ec=ec, device=dev, params=model.tree())
    want = _serve_alone(single, _fleet_requests(FLEET_LENS))
    fleet = build_multislice_engine(cfg, n_slices=2, ec=ec, device=dev, params=model)
    streams = {e.stream for e in fleet.engines.values()}
    assert len(streams) == 2 and torch.cuda.current_stream(dev) not in streams
    rows = {}
    for sid, e in fleet.engines.items():
        orig = e._retire_finished

        def spy(now, e=e, orig=orig):
            for s, st in enumerate(e._slots):
                if st is not None and st.live:
                    rows[st.req.rid] = (e, s)
            orig(now)

        e._retire_finished = spy
    fleet.submit_many(_fleet_requests(FLEET_LENS))
    done = fleet.run_until_idle()
    torch.cuda.synchronize()
    assert sorted(r.rid for r in done) == list(range(len(FLEET_LENS)))
    assert all(e.stats["admitted"] > 0 for e in fleet.engines.values())
    for r in done:
        wt, ws = want[r.rid]
        e, s = rows[r.rid]
        n = FLEET_LENS[r.rid] + CONTRACT_BUDGET
        np.testing.assert_array_equal(np.asarray(r.payload), wt)
        _assert_bits(_kv(e._pool, s, n), _kv(single._pool, ws, n), f"rid {r.rid} K/V")
        _assert_bits(_step_logits(model, e._pool, s, wt[-1], n - 1),
                     _step_logits(model, single._pool, ws, wt[-1], n - 1),
                     f"rid {r.rid} logits")


@pytest.mark.gpu
def test_two_tenant_fleet_matches_each_tenants_single_engine_on_card(full_width):
    """Two tenants of one config under two names (seeds 0 and 1), two slices
    each: every request's tokens equal its own tenant's single engine's,
    and no request ran on the other tenant's slices."""
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.multislice import TenantSpec, build_multislice_engine

    cfg, _, dev = full_width
    ec = EngineConfig(continuous=True, max_slots=8, segment_len=CONTRACT_BUDGET,
                      max_new_tokens=CONTRACT_BUDGET, max_prompt_len=128)
    names = ("a", "b")
    fleet = build_multislice_engine(
        n_slices=4, ec=ec, device=dev,
        tenants=[TenantSpec(cfg=cfg, name=nm, n_slices=2, seed=i)
                 for i, nm in enumerate(names)])
    reqs = []
    for i, nm in enumerate(names):
        reqs += _fleet_requests(FLEET_LENS, model=nm, rid0=100 * i)
    kernels.reset_launch_counts()
    fleet.submit_many(reqs)
    done = fleet.run_until_idle()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == \
        cfg.n_layers * fleet.decode_steps_total() > 0
    assert len(done) == 2 * len(FLEET_LENS)
    for i, nm in enumerate(names):
        single = build_engine(cfg, seed=i, ec=ec, device=dev)
        single.submit_many(_fleet_requests(FLEET_LENS, rid0=100 * i))
        ref = {r.rid: np.asarray(r.payload) for r in single.run_until_idle()}
        for r in done:
            if r.model == nm:
                np.testing.assert_array_equal(np.asarray(r.payload), ref[r.rid])
        ts = fleet.tenant_stats()[nm]
        assert ts["completed"] == len(FLEET_LENS)
        assert set(ts["routed_to"]) <= set(ts["slices"])


# --- the Mamba2 SSM family on the card: chip_smoke.py phase 14's checks at
# full width (d_model 1024, 32 SSM heads of 64, state 128; 2 layers, bf16,
# seeded weights), bit for bit on tokens, the conv tail and state rows and
# the next step's logits ---------------------------------------------------


@pytest.fixture(scope="module")
def ssm_full_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSM contracts are held on the card")
    cs = _chip_smoke()
    return (cs, *cs.ssm_contract_model(torch))


@pytest.mark.gpu
@pytest.mark.parametrize("contract", ["padded", "join", "chained", "multi_slice"])
def test_ssm_contract_on_card(ssm_full_width, contract):
    """padded == unpadded, join == alone, chained segments == sequential
    decode, and multi-slice (two CUDA streams) == single-slice."""
    cs, cfg, model, dev = ssm_full_width
    res = getattr(cs, f"ssm_contract_{contract}")(torch, np, cfg, model, dev)
    assert res["equal"], res


@pytest.mark.gpu
def test_ssd_chunked_matches_the_recurrence_on_card(ssm_full_width):
    from repro_torch.configs import get_config

    cs = ssm_full_width[0]
    rows = cs.ssd_check(torch, np, get_config("mamba2-370m"))
    assert len(rows) == 4 and all(r["ok"] for r in rows)


@pytest.mark.gpu
def test_two_family_fleet_matches_each_models_single_engine_on_card(full_width,
                                                                      ssm_full_width):
    """tinyllama and mamba2 (2 layers each), two slices each behind one
    admission queue: every request's tokens equal its own model's single
    engine's, no request ran on the other tenant's slices, and the decode
    kernel ran once per layer on the tinyllama tenant's steps only."""
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.multislice import TenantSpec, build_multislice_engine

    cfg_a, model_a, dev = full_width
    _, cfg_b, model_b, _ = ssm_full_width
    ec = EngineConfig(continuous=True, max_slots=8, segment_len=CONTRACT_BUDGET,
                      max_new_tokens=CONTRACT_BUDGET, max_prompt_len=128)
    names = {"tinyllama-1.1b": (cfg_a, model_a), "mamba2-370m": (cfg_b, model_b)}
    fleet = build_multislice_engine(
        n_slices=4, ec=ec, device=dev,
        tenants=[TenantSpec(cfg=c, name=nm, n_slices=2, params=m)
                 for nm, (c, m) in names.items()])
    reqs = []
    for i, nm in enumerate(names):
        reqs += _fleet_requests(FLEET_LENS, model=nm, rid0=100 * i)
    kernels.reset_launch_counts()
    fleet.submit_many(reqs)
    done = fleet.run_until_idle()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == \
        cfg_a.n_layers * fleet.decode_steps_total("tinyllama-1.1b") > 0
    assert fleet.decode_steps_total("mamba2-370m") > 0
    assert len(done) == 2 * len(FLEET_LENS)
    for i, (nm, (c, m)) in enumerate(names.items()):
        single = build_engine(c, ec=ec, device=dev, params=m.tree())
        single.submit_many(_fleet_requests(FLEET_LENS, rid0=100 * i))
        ref = {r.rid: np.asarray(r.payload) for r in single.run_until_idle()}
        for r in done:
            if r.model == nm:
                np.testing.assert_array_equal(np.asarray(r.payload), ref[r.rid])
        ts = fleet.tenant_stats()[nm]
        assert ts["completed"] == len(FLEET_LENS)
        assert set(ts["routed_to"]) <= set(ts["slices"])


# --- the closed partition loop on the card ------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=["phi-3-vision-4.2b", "jamba-v0.1-52b"])
def family_full_width(request):
    """chip_smoke.py's phase-16 models: phi-3-vision (32 layers) and jamba
    (8 of 32 layers: one block), full width, bf16, seed 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the contracts are held on the card")
    cs = _chip_smoke()
    yield (cs, *cs.family_model(torch, request.param))
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_family_contracts_on_card(family_full_width):
    """chained segments == sequential decode (tokens, every row's K/V and,
    in jamba, its SSM conv tails and states, the next logits), bit for bit;
    join == alone too for phi-3-vision (an MoE token's capacity depends on
    its decode group, so jamba's join is not held)."""
    cs, cfg, model = family_full_width
    res = cs.attn_contracts(torch, np, cfg, model, torch.device("cuda"))
    assert res["chained_equals_sequential"]["equal"], res
    if not cfg.n_experts:
        assert res["join_equals_alone"]["equal"], res


@pytest.mark.gpu
def test_controller_resizes_the_fleet_deterministically_on_card(full_width):
    """chip_smoke.py's controller trace at full width, 2 layers: the
    analytical-profile decision log is the CPU test's pin (width and backend
    do not enter it), two replays agree on the log and on every token, each
    rid is served once, and the kernels ran on every step of every engine
    the resizes built."""
    import hashlib

    cs = _chip_smoke()
    cfg, model, _ = full_width
    runs = []
    for _ in range(2):
        kernels.reset_launch_counts()
        rt, ctl, done = cs.controller_replay(torch, np, model, cs.analytical_profiles(), "cuda")
        runs.append((rt, ctl, done, kernels.launch_counts()))
    (rt, ctl, done, counts), (_, ctl2, done2, _) = runs
    text = ctl.decisions_json()
    assert text == ctl2.decisions_json()
    assert hashlib.sha256(text.encode()).hexdigest() == cs.ANALYTICAL_LOG_SHA256
    assert sorted(r.rid for r in done) == list(range(cs.CONTROLLER_REQUESTS))
    assert rt.conservation_ok() and not rt.dead and not rt.shed
    assert rt.engine.stats["requeued"] >= 1 and len(rt.engine.pod.slices) > 1
    want = {r.rid: np.asarray(r.payload) for r in done2}
    for r in done:
        np.testing.assert_array_equal(np.asarray(r.payload), want[r.rid])
    assert counts["decode_attention"] == cfg.n_layers * rt.engine.decode_steps_total() > 0
    assert all(counts[k] == rt.service.stats["groups"] > 0 for k in kernels.AUDIO_KERNELS)


@pytest.mark.gpu
def test_calibrate_knee_on_card_writes_what_knee_profiles_reads(full_width, tmp_path):
    from repro_torch.core.batching.knee import profiles_from_json
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig

    cfg, _, _ = full_width
    path = tmp_path / "knees.json"
    kernels.reset_launch_counts()
    seen = []
    profiles = serve._calibrate_knee(
        cfg, EngineConfig(max_prompt_len=128), str(path), max_batch=4, device="cuda",
        on_point=lambda b, ctx, s, step: seen.append((b, ctx, s)))
    assert sorted(profiles) == [0, 1] and profiles_from_json(path.read_text()) == profiles
    assert [(b, ctx) for b, ctx, _ in seen] == [(b, c) for c in (32, 96) for b in (1, 2, 4)]
    assert all(0 < s < 1 for _, _, s in seen)
    # a warm-up and three timed decode steps a point, each one launch a layer
    assert kernels.launch_counts()["decode_attention"] == cfg.n_layers * 4 * len(seen)


@pytest.mark.gpu
def test_simulate_on_card_equals_the_cpu(cuda):
    """The simulator is a host-side cost model: on the card it launches
    nothing and gives the CPU's result."""
    from repro_torch.core.batching.policy import BatchPolicy
    from repro_torch.serving.requests import WorkloadSpec, generate_requests
    from repro_torch.serving.simulator import SimConfig, simulate

    def run(device):
        reqs = generate_requests(WorkloadSpec(rate_qps=300.0, seed=2), 200)
        pol = BatchPolicy(batch_max={0: 4, 1: 8}, time_queue=0.004, time_knee=0.02,
                          n_slices=4, bucket_width=2.5)
        res = simulate(reqs, pol, lambda b: 0.004 + 0.001 * b.size, lambda n: 0.002 * n,
                       SimConfig(n_slices=4, preprocess="dpu"), device=device)
        return [(r.rid, r.completed_at) for r in res.completed], res.batch_sizes

    kernels.reset_launch_counts()
    assert run("cuda") == run("cpu")
    assert not any(kernels.launch_counts().values())


def _train_grads(cfg, params, batch):
    from repro_torch.models import lm
    from repro_torch.models.params import leaves, tree_map

    p = tree_map(lambda x: x.detach().clone().requires_grad_(), params)
    dev = next(v for _, v in leaves(p)).device
    loss, _ = lm.train_loss(p, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, [v for _, v in leaves(p)])
    return float(loss.detach()), {path: g.cpu() for (path, _), g in zip(leaves(p), grads)}


@pytest.mark.gpu
def test_train_step_on_card_matches_the_cpu(cuda):
    """Reduced tinyllama at fp32, TF32 off: train_loss and every gradient
    leaf on the card against the CPU (loss rtol 1e-5; a leaf within 1e-4 of
    its largest magnitude), remat on against off on the card, and one
    make_train_step step's metrics on both devices."""
    import dataclasses

    from repro_torch.configs import reduced
    from repro_torch.core import steps
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = next(batch_iterator(cfg, DataConfig(2, 32)))
    batch["labels"][0, :4] = -100
    loss_cpu, g_cpu = _train_grads(cfg, params, batch)
    on_card = tree_map(lambda x: x.to(cuda), params)
    loss, g = _train_grads(cfg, on_card, batch)
    loss_off, g_off = _train_grads(dataclasses.replace(cfg, remat=False), on_card, batch)
    assert_allclose(loss, loss_cpu, rtol=1e-5)
    assert_allclose(loss_off, loss, rtol=1e-6)
    for path, want in g_cpu.items():
        w = want.numpy()
        tol = 1e-4 * float(np.abs(w).max())
        assert_allclose(g[path].numpy(), w, rtol=1e-4, atol=tol, err_msg=path)
        assert_allclose(g_off[path].numpy(), g[path].numpy(), rtol=1e-5, atol=0.1 * tol,
                        err_msg=path)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    out = []
    for p in (params, on_card):
        p = tree_map(lambda x: x.clone(), p)
        _, m = steps.make_train_step(cfg, oc)({"params": p, "opt": init_opt_state(p)}, batch)
        out.append({k: float(v) for k, v in m.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert_allclose(out[1][k], out[0][k], rtol=1e-5, err_msg=k)


# --- several cards --------------------------------------------------------------


@pytest.fixture
def other_card():
    """The last card, where there are two or more; cuda:0 is current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a kernel on another card, a fleet over cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    return torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.gpu
def test_each_kernel_runs_on_its_inputs_card(other_card):
    """chip_smoke.py phase 24 (a): each of the seven kernels at its serve
    shape on the last card while cuda:0 stays current, its output on that
    card and within its tolerance of the plain version (a miss fails the
    phase with SystemExit)."""
    out = _chip_smoke().other_card_kernels(torch, np, str(other_card))
    assert len(out) == len(kernels.KERNELS) and torch.cuda.current_device() == 0


@pytest.mark.gpu
def test_two_card_fleet_equals_a_single_slice_engine_on_card(full_width, other_card):
    """A fleet of two slices on cuda:0 and the last card, the weights drawn
    on cuda:0: per request the tokens of one engine on those weights, bit
    for bit; one replica on the other card, the same object after 2 -> 1
    -> 2 slices; decode attention once per layer and step."""
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.multislice import build_multislice_engine

    cfg, model, dev = full_width
    ec = EngineConfig(continuous=True, max_slots=8, segment_len=CONTRACT_BUDGET,
                      max_new_tokens=CONTRACT_BUDGET, max_prompt_len=128)
    want = _serve_alone(build_engine(cfg, ec=ec, device=dev, params=model.tree()),
                        _fleet_requests(FLEET_LENS))
    cards = ["cuda:0", str(other_card)]
    fleet = build_multislice_engine(cfg, n_slices=2, ec=ec, device="cuda:0", devices=cards,
                                    params=model)
    assert [str(e.device) for e in fleet.engines.values()] == cards
    held = fleet.weights_by_device()
    replica = held[cards[1]][cfg.name]
    assert sorted(held) == cards and held["cuda:0"][cfg.name] is model
    assert all(t.device == other_card for t in replica.weights.parameters())
    for n_slices in (2, 1, 2):
        if n_slices != len(fleet.engines):
            fleet.resize(n_slices=n_slices)
        fleet.reset_metrics()
        kernels.reset_launch_counts()
        fleet.submit_many(_fleet_requests(FLEET_LENS))
        done = fleet.run_until_idle()
        for d in cards:
            torch.cuda.synchronize(d)
        assert sorted(r.rid for r in done) == list(range(len(FLEET_LENS)))
        assert all(e.stats["admitted"] > 0 for e in fleet.engines.values())
        for r in done:
            np.testing.assert_array_equal(np.asarray(r.payload), want[r.rid][0])
        assert kernels.launch_counts()["decode_attention"] == \
            cfg.n_layers * fleet.decode_steps_total() > 0
        assert fleet.weights_by_device()[cards[1]][cfg.name] is replica
