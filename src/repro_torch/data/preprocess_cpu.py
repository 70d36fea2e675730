"""Host-side preprocessing in numpy (the paper's CPU baseline, Fig. 4):

    image: decode (dequantize + IDCT) -> resize -> center crop -> normalize
    audio: resample -> mel spectrogram -> normalize

It serves two roles in this package: the constants the DPU kernels take
(IDCT basis, bilinear weights, Hann window, DFT bases, mel filterbank, FIR
taps) and an independent numerical opinion the tests hold the kernels
against.
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


# ---------------------------------------------------------------------------
# Image
# ---------------------------------------------------------------------------

_IDCT_N = 8


@lru_cache(maxsize=None)
def idct_matrix(n: int = _IDCT_N) -> np.ndarray:
    """Orthonormal DCT-III (inverse DCT-II) matrix M: block = M @ coeff @ M.T"""
    k = np.arange(n)[None, :]
    x = np.arange(n)[:, None]
    m = np.cos((2 * x + 1) * k * np.pi / (2 * n)) * np.sqrt(2.0 / n)
    m[:, 0] *= 1.0 / np.sqrt(2.0)
    return _frozen(m.astype(np.float32))


def decode_blocks(coeffs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """JPEG-style block decode backend: dequantize + 8x8 IDCT.

    coeffs: [H/8, W/8, 8, 8] quantized DCT coefficients (int32-ish)
    qtable: [8, 8] quantization table.
    Returns pixels [H, W] float32 in [0, 255]-ish range.
    (Huffman/entropy decode stays on the host, before the DPU.)
    """
    m = idct_matrix()
    deq = coeffs.astype(np.float32) * qtable.astype(np.float32)[None, None]
    blocks = np.einsum("ij,byjk,lk->byil", m, deq, m)
    by, bx = coeffs.shape[0], coeffs.shape[1]
    return (blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8) + 128.0).astype(
        np.float32
    )


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize (align_corners=False, half-pixel centers).
    img: [H, W] or [H, W, C] float32."""
    h, w = img.shape[0], img.shape[1]
    ry = _resize_matrix(h, out_h)
    rx = _resize_matrix(w, out_w)
    out = np.tensordot(ry, img, axes=(1, 0))            # [out_h, W, ...]
    out = np.moveaxis(np.tensordot(rx, np.moveaxis(out, 1, 0), axes=(1, 0)), 0, 1)
    return out.astype(np.float32)


@lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation weights (half-pixel centers)."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        c = (o + 0.5) * scale - 0.5
        lo = int(np.floor(c))
        frac = c - lo
        lo_c = min(max(lo, 0), n_in - 1)
        hi_c = min(max(lo + 1, 0), n_in - 1)
        m[o, lo_c] += 1.0 - frac
        m[o, hi_c] += frac
    return _frozen(m)


def center_crop(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    h, w = img.shape[0], img.shape[1]
    y0 = (h - ch) // 2
    x0 = (w - cw) // 2
    return img[y0 : y0 + ch, x0 : x0 + cw]


def normalize_image(img: np.ndarray, mean, std) -> np.ndarray:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((img - mean) / std).astype(np.float32)


def image_pipeline(coeffs: np.ndarray, qtable: np.ndarray,
                   resize_to: int = 256, crop_to: int = 224,
                   mean: float = 127.5, std: float = 64.0) -> np.ndarray:
    x = decode_blocks(coeffs, qtable)
    x = resize_bilinear(x, resize_to, resize_to)
    x = center_crop(x, crop_to, crop_to)
    return normalize_image(x, mean, std)


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------


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
