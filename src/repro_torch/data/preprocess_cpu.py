"""Host-side audio preprocessing in numpy (the paper's CPU baseline, Fig. 4b):
resample -> mel spectrogram -> normalize.

It serves two roles in this package: the constants the DPU kernels take
(Hann window, DFT bases, mel filterbank, FIR taps) and an independent
numerical opinion the tests hold the kernels against.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np


def _frozen(a: np.ndarray) -> np.ndarray:
    """Mark an lru_cache'd operator matrix read-only (shared across calls)."""
    a.setflags(write=False)
    return a


@lru_cache(maxsize=None)
def fir_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Windowed-sinc lowpass (Hamming), cutoff in normalized Nyquist units."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    h *= np.hamming(num_taps)
    return _frozen((h / h.sum()).astype(np.float32))


def resample_poly(x: np.ndarray, up: int, down: int, num_taps: int = 48) -> np.ndarray:
    """Polyphase rational resampling (paper 'Resample' unit)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x.astype(np.float32)
    h = fir_lowpass(num_taps * max(up, down), 1.0 / max(up, down)) * up
    xu = np.zeros(len(x) * up, np.float32)
    xu[::up] = x
    y = np.convolve(xu, h, mode="same")
    return y[::down].astype(np.float32)


@lru_cache(maxsize=None)
def hann(n: int) -> np.ndarray:
    return _frozen((0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32))


def frame_signal(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


@lru_cache(maxsize=None)
def mel_filterbank(n_mels: int, n_fft: int, sr: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    fmax = fmax or sr / 2

    def to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def from_mel(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    pts = from_mel(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        for j in range(l, c):
            if c > l:
                fb[i, j] = (j - l) / (c - l)
        for j in range(c, r):
            if r > c:
                fb[i, j] = (r - j) / (r - c)
    return _frozen(fb)


@lru_cache(maxsize=None)
def dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases [n_fft, n_fft//2+1]: the FFT as two products."""
    k = np.arange(n_fft // 2 + 1)[None, :]
    t = np.arange(n_fft)[:, None]
    ang = -2.0 * np.pi * t * k / n_fft
    return _frozen(np.cos(ang).astype(np.float32)), _frozen(np.sin(ang).astype(np.float32))


def mel_spectrogram(x: np.ndarray, *, sr: int = 16000, n_fft: int = 512,
                    frame: int = 400, hop: int = 160, n_mels: int = 80) -> np.ndarray:
    """Frame -> window -> |DFT|^2 -> mel -> log  (paper 'Mel spectrogram' unit)."""
    frames = frame_signal(x, frame, hop) * hann(frame)[None, :]
    pad = np.zeros((frames.shape[0], n_fft - frame), np.float32)
    fp = np.concatenate([frames, pad], axis=1)
    cr, ci = dft_matrices(n_fft)
    re = fp @ cr
    im = fp @ ci
    power = re * re + im * im
    mel = power @ mel_filterbank(n_mels, n_fft, sr).T
    return np.log(mel + 1e-6).astype(np.float32)


def normalize_meanvar(feats: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Per-utterance mean/variance normalize (paper 'Normalize' CU): needs
    utterance-global stats, hence its own unit."""
    mu = feats.mean(axis=0, keepdims=True)
    var = ((feats - mu) ** 2).mean(axis=0, keepdims=True)
    return ((feats - mu) / np.sqrt(var + eps)).astype(np.float32)


def audio_pipeline(x: np.ndarray, *, in_sr: int = 48000, sr: int = 16000,
                   n_mels: int = 80) -> np.ndarray:
    y = resample_poly(x, sr, in_sr)
    feats = mel_spectrogram(y, sr=sr, n_mels=n_mels)
    return normalize_meanvar(feats)
