"""Public wrappers for the DPU audio kernels.

The padding, zero-stuffing, framing, Hann window and n_fft zero-pad around
the kernels are plain torch, as the JAX package does them outside Pallas.
Each wrapper runs where its input lies: CUDA tensors go through the
Hopper kernels, CPU tensors through their plain versions.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.data import preprocess_cpu as pp
from repro_torch.kernels.audio_normalize import audio_normalize_batch as _normalize
from repro_torch.kernels.audio_resample import audio_resample_batch as _resample
from repro_torch.kernels.mel_spectrogram import mel_spectrogram_batch as _mel


@lru_cache(maxsize=None)
def mel_constants(n_fft: int, frame: int, n_mels: int, sr: int,
                  device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(hann [frame], cr [n_fft, F], ci [n_fft, F], fb [F, n_mels]) on device."""
    cr, ci = pp.dft_matrices(n_fft)
    fb = pp.mel_filterbank(n_mels, n_fft, sr).T
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (pp.hann(frame), cr, ci, fb.copy()))


@lru_cache(maxsize=None)
def resample_taps(up: int, down: int, num_taps: int,
                  device: torch.device) -> torch.Tensor:
    h = pp.fir_lowpass(num_taps * max(up, down), 1.0 / max(up, down)) * up
    return torch.tensor(h, dtype=torch.float32, device=device)


# --- batched audio (one kernel launch per same-shape request stack) ----------


def audio_resample_batch(x: torch.Tensor, up: int, down: int,
                         num_taps: int = 48) -> torch.Tensor:
    """x: [N, L] same-length stack; rational resample in one kernel launch."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x.float()
    h = resample_taps(up, down, num_taps, x.device)
    if up > 1:
        xu = torch.zeros((x.shape[0], x.shape[1] * up), dtype=torch.float32,
                         device=x.device)
        xu[:, ::up] = x
    else:
        xu = x.float()
    taps = h.shape[0]
    xp = F.pad(xu, (taps // 2, taps)).contiguous()
    n_out = (xu.shape[1] + down - 1) // down
    return _resample(xp, h, down, n_out)


def mel_spectrogram_batch(x: torch.Tensor, *, sr: int = 16000, n_fft: int = 512,
                          frame: int = 400, hop: int = 160,
                          n_mels: int = 80) -> torch.Tensor:
    """x: [N, L] same-length mono stack -> log-mel [N, n_frames, n_mels]; the
    framed stack flattens to [N*n_frames, n_fft], one launch for the batch."""
    nsig, length = x.shape
    if length < frame:
        raise ValueError(f"signal of {length} samples is shorter than a {frame}-sample frame")
    n = 1 + (length - frame) // hop
    win, cr, ci, fb = mel_constants(n_fft, frame, n_mels, sr, x.device)
    idx = (torch.arange(frame, device=x.device)[None, :]
           + hop * torch.arange(n, device=x.device)[:, None])
    frames = x.float()[:, idx] * win[None, None, :]
    frames = F.pad(frames, (0, n_fft - frame))
    out = _mel(frames.reshape(nsig * n, n_fft).contiguous(), cr, ci, fb)
    return out.reshape(nsig, n, n_mels)


def audio_normalize_batch(feats: torch.Tensor) -> torch.Tensor:
    """feats: [N, T, F] -> per-utterance normalized, one launch."""
    return _normalize(feats.float().contiguous())


def audio_pipeline_batch(x: torch.Tensor, up: int = 1, down: int = 3) -> torch.Tensor:
    """The whole audio front-end — resample -> mel -> normalize — for a
    same-length stack [N, L]: one launch per kernel for the group (the DPU
    service's fused launch)."""
    y = audio_resample_batch(x, up, down)
    feats = mel_spectrogram_batch(y)
    return audio_normalize_batch(feats)


# --- per-request wrappers (the batched kernels at N = 1) ---------------------


def audio_resample(x: torch.Tensor, up: int, down: int, num_taps: int = 48) -> torch.Tensor:
    return audio_resample_batch(x[None], up, down, num_taps)[0]


def mel_spectrogram(x: torch.Tensor, *, sr: int = 16000, n_fft: int = 512,
                    frame: int = 400, hop: int = 160, n_mels: int = 80) -> torch.Tensor:
    """x: [L] mono audio -> log-mel [n_frames, n_mels]."""
    return mel_spectrogram_batch(x[None], sr=sr, n_fft=n_fft, frame=frame,
                                 hop=hop, n_mels=n_mels)[0]


def audio_normalize(feats: torch.Tensor) -> torch.Tensor:
    return audio_normalize_batch(feats[None])[0]
