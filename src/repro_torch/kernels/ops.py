"""Public wrappers for the hand-written kernels: the DPU's, audio and
image, and decode attention.

The zero-stuffing before the resample kernel (up > 1, not on the served
1:3 path) and the center crop outside the fused image pipeline are plain
torch, as the JAX package does them outside Pallas; the resample kernel
zero-pads the signal itself, and the mel kernel frames, windows and
zero-pads it. Each wrapper runs where its input lies: CUDA tensors go
through the Hopper kernels, CPU tensors through their plain versions.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from repro_torch.data import preprocess_cpu as pp
from repro_torch.kernels.audio_normalize import audio_normalize_batch as _normalize
from repro_torch.kernels.audio_resample import audio_resample_batch as _resample
from repro_torch.kernels.decode_attention import decode_attention as _decode_attention
from repro_torch.kernels.image_normalize import crop_origin
from repro_torch.kernels.image_normalize import image_crop_normalize_batch as _crop_normalize
from repro_torch.kernels.image_resize import image_resize_batch as _resize
from repro_torch.kernels.jpeg_idct import jpeg_idct_batch as _idct
from repro_torch.kernels.mel_spectrogram import fft_twiddles, mel_bands
from repro_torch.kernels.mel_spectrogram import mel_spectrogram_batch as _mel


@lru_cache(maxsize=None)
def mel_constants(n_fft: int, frame: int, n_mels: int, sr: int,
                  device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(hann [frame], twiddles [n_fft, 2], weights [W], bands [n_mels, 3]
    int32) on device: the mel kernel's window, FFT table and filterbank
    bands, built once per configuration on the host."""
    weights, bands = mel_bands(pp.mel_filterbank(n_mels, n_fft, sr))
    return (torch.tensor(pp.hann(frame), dtype=torch.float32, device=device),
            torch.from_numpy(fft_twiddles(n_fft)).to(device),
            torch.from_numpy(weights).to(device), torch.from_numpy(bands).to(device))


@lru_cache(maxsize=None)
def resample_taps(up: int, down: int, num_taps: int,
                  device: torch.device) -> torch.Tensor:
    h = pp.fir_lowpass(num_taps * max(up, down), 1.0 / max(up, down)) * up
    return torch.tensor(h, dtype=torch.float32, device=device)


@lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """[n_out, n_in] bilinear weights (half-pixel centers) on device."""
    return torch.tensor(pp._resize_matrix(n_in, n_out), dtype=torch.float32,
                        device=device)


@lru_cache(maxsize=None)
def resize_taps(n_in: int, n_out: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The taps of `resize_matrix`, built once per shape on the host: idx
    [n_out, 2] int32, the columns of each row's non-zeros in ascending
    order, and w [n_out, 2] float32, the matrix's entries there. A row with
    one non-zero names its column twice, the second weight 0, so the taps
    encode the matrix exactly. A row with more than two non-zeros raises."""
    m = pp._resize_matrix(n_in, n_out)
    idx = np.zeros((n_out, 2), np.int32)
    w = np.zeros((n_out, 2), np.float32)
    for o, row in enumerate(m):
        cols = np.flatnonzero(row)
        if len(cols) > 2:
            raise ValueError(f"row {o} of the {n_in} -> {n_out} resize matrix has "
                             f"{len(cols)} non-zeros; bilinear taps hold two")
        if len(cols):
            idx[o] = (cols[0], cols[-1])
            w[o, 0] = row[cols[0]]
            w[o, 1] = row[cols[1]] if len(cols) == 2 else 0.0
    return (torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device))


# --- batched audio (one kernel launch per same-shape request stack) ----------


def audio_resample_batch(x: torch.Tensor, up: int, down: int,
                         num_taps: int = 48) -> torch.Tensor:
    """x: [N, L] same-length stack; rational resample in one kernel launch,
    which reads the signal as padded by taps // 2 zeros on the left (and
    zeros past its end), as the reference pads it."""
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
    n_out = (xu.shape[1] + down - 1) // down
    return _resample(xu.contiguous(), h, down, n_out, pad_left=h.shape[0] // 2)


def mel_spectrogram_batch(x: torch.Tensor, *, sr: int = 16000, n_fft: int = 512,
                          frame: int = 400, hop: int = 160,
                          n_mels: int = 80) -> torch.Tensor:
    """x: [N, L] same-length mono stack -> log-mel [N, n_frames, n_mels]:
    framing, window and zero-pad happen in the kernel, one launch for the
    batch. n_fft is a power of two in [64, 2048]."""
    win, tw, weights, bands = mel_constants(n_fft, frame, n_mels, sr, x.device)
    return _mel(x.float().contiguous(), win, tw, weights, bands, hop)


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


# --- batched image (one launch per kernel per same-shape request stack) ------


def jpeg_decode_batch(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """coeffs: [N, H/8, W/8, 8, 8] same-shape stack -> pixels [N, H, W]; all
    N*H/8*W/8 blocks go through one IDCT launch."""
    return _idct(coeffs.float().contiguous(),
                 qtable.to(coeffs.device, torch.float32).contiguous())


def image_resize_batch(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """imgs: [N, H, W] -> [N, out_h, out_w] in one launch for the stack."""
    ytaps = resize_taps(imgs.shape[1], out_h, imgs.device)
    xtaps = resize_taps(imgs.shape[2], out_w, imgs.device)
    return _resize(imgs.float().contiguous(), ytaps, xtaps)


def center_crop_batch(imgs: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    """The centered [N, ch, cw] window, as a view (no kernel, no copy)."""
    y0, x0 = crop_origin(imgs.shape[1], imgs.shape[2], ch, cw)
    return imgs[:, y0:y0 + ch, x0:x0 + cw]


def image_normalize_batch(imgs: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """imgs: [N, H, W] -> normalized stack: the crop-normalize kernel with
    the whole image as its window, one launch."""
    x = imgs.float().contiguous()
    return _crop_normalize(x, x.shape[1], x.shape[2], mean, std)


def image_pipeline_batch(coeffs: torch.Tensor, qtable: torch.Tensor, *,
                         resize_to: int = 256, crop_to: int = 224,
                         mean: float = 127.5, std: float = 64.0) -> torch.Tensor:
    """The whole JPEG front-end — dequantize+IDCT decode -> resize -> center
    crop -> normalize — for a same-shape coefficient stack [N, H/8, W/8, 8,
    8] with one shared qtable: one launch each of the IDCT, the resize and
    the crop-normalize for the group (the DPU service's fused
    launch). The crop is read in place by the normalize kernel."""
    imgs = jpeg_decode_batch(coeffs, qtable)
    imgs = image_resize_batch(imgs, resize_to, resize_to)
    return _crop_normalize(imgs, crop_to, crop_to, mean, std)


# --- per-request image wrappers (the batched kernels at N = 1) ---------------


def jpeg_decode(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """coeffs: [H/8, W/8, 8, 8] -> pixels [H, W]."""
    return jpeg_decode_batch(coeffs[None], qtable)[0]


def image_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return image_resize_batch(img[None], out_h, out_w)[0]


def center_crop(img: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    return center_crop_batch(img[None], ch, cw)[0]


def image_normalize(img: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    return image_normalize_batch(img[None], mean, std)[0]


# --- decode attention (one launch per decode step and layer) -----------------


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, return_lse: bool = False):
    """q: [B, H, D]; k, v: [B, S, KH, D]; valid_len: [B] int32 (positions
    [0, valid_len) hold keys) -> [B, H, D] flash-decode GQA attention; with
    return_lse, (o, each row's log-sum-exp [B, H] fp32), a row with no
    valid key weighing nothing (o = 0, lse = -inf)."""
    return _decode_attention(q, k, v, valid_len, return_lse)
