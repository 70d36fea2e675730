"""Plain-torch oracles for the DPU kernels; their numerics mirror
repro_torch.data.preprocess_cpu (two-pass variance, direct gather, the
IDCT as one three-operand product, division by std)."""
from __future__ import annotations

import torch

from repro_torch.data import preprocess_cpu as pp


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


def jpeg_idct_ref(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """coeffs: [NB, 8, 8] quantized DCT blocks; returns [NB, 8, 8] pixels."""
    m = torch.tensor(pp.idct_matrix(), device=coeffs.device)
    deq = coeffs.float() * qtable.float()[None]
    return torch.einsum("ij,bjk,lk->bil", m, deq, m) + 128.0


def image_resize_ref(img: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """Separable bilinear resize: ry: [H_out, H], rx: [W_out, W]; img: [H, W]."""
    return ry @ img @ rx.T


def image_normalize_ref(img: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    return (img - mean) / std
