"""The DPU kernels on the card, against their plain PyTorch versions.

Marked `gpu`: they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch import kernels
from repro_torch.kernels import audio_normalize, audio_resample, build, mel_spectrogram, ops


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
    win, cr, ci, fb = ops.mel_constants(512, 400, 80, 16000, x.device)
    idx = torch.arange(400, device=x.device)[None] + 160 * torch.arange(98, device=x.device)[:, None]
    frames = torch.nn.functional.pad(y[:, idx] * win, (0, 112)).reshape(-1, 512).contiguous()
    assert_allclose(mel_spectrogram.mel_spectrogram_batch_kernel(frames, cr, ci, fb).cpu().numpy(),
                    mel_spectrogram.mel_spectrogram_batch_plain(frames, cr, ci, fb).cpu().numpy(),
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
    assert kernels.launch_counts() == {k: 1 for k in kernels.KERNELS}
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
