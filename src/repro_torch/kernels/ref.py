"""Plain-torch oracles for the DPU audio kernels; their numerics mirror
repro_torch.data.preprocess_cpu (two-pass variance, direct gather)."""
from __future__ import annotations

import torch


def mel_spectrogram_ref(frames: torch.Tensor, cr: torch.Tensor, ci: torch.Tensor,
                        fb: torch.Tensor) -> torch.Tensor:
    """frames: [N, n_fft] (framed+windowed+padded); cr/ci: [n_fft, F];
    fb: [F, n_mels]. Returns log-mel [N, n_mels]."""
    re = frames @ cr
    im = frames @ ci
    return torch.log((re * re + im * im) @ fb + 1e-6)


def audio_normalize_ref(feats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-utterance mean -> variance -> scale over the frame axis. [T, F]."""
    mu = feats.mean(0, keepdim=True)
    var = ((feats - mu) ** 2).mean(0, keepdim=True)
    return (feats - mu) / torch.sqrt(var + eps)


def audio_resample_ref(x: torch.Tensor, h: torch.Tensor, down: int) -> torch.Tensor:
    """FIR decimation y[i] = sum_k h[k] * xp[i*down + k] on the pre-padded
    signal. x: [L], h: [taps]."""
    taps = h.shape[0]
    n_out = (x.shape[0] - taps) // down + 1
    idx = (torch.arange(n_out, device=x.device)[:, None] * down
           + torch.arange(taps, device=x.device)[None, :])
    return (x[idx] * h[None, :]).sum(-1)
