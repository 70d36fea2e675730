"""Plain-torch oracles for the hand-written kernels; the DPU's numerics
mirror repro_torch.data.preprocess_cpu (two-pass variance, direct gather,
the IDCT as one three-operand product, division by std)."""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import torch

from repro_torch.data import preprocess_cpu as pp


@lru_cache(maxsize=None)
def mel_dense_operands(n_fft: int, n_mels: int, sr: int,
                       device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(cr [n_fft, F], ci [n_fft, F], fb [F, n_mels]) on device: the dense
    DFT bases and filterbank of the reference's three products."""
    cr, ci = pp.dft_matrices(n_fft)
    fb = pp.mel_filterbank(n_mels, n_fft, sr).T
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in (cr, ci, fb))


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


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: torch.Tensor) -> torch.Tensor:
    """Flash-decode oracle. q: [B, H, D]; k, v: [B, S, KH, D]; valid_len: [B]
    (prefix-valid layout). GQA via H = KH * G; fp32 result."""
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    qg = q.reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k.float()) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None] < valid_len.to(q.device)[:, None]
    s = torch.where(mask[:, None, None], s, torch.tensor(-1e30, device=q.device))
    o = torch.einsum("bkgj,bjkd->bkgd", torch.softmax(s, -1), v.float())
    return o.reshape(B, H, D)
