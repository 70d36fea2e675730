"""Log-mel spectrogram, the paper's 'Mel spectrogram' functional unit.

`mel_spectrogram_batch` computes, for every frame j of every signal n of a
same-length stack y [N, L],

    log(|DFT_n_fft(y[n, j*hop : j*hop + frame] * win, zero-padded)|^2 @ FB + 1e-6)

from the signal itself: framing, window and zero-pad happen inside, and the
output is [N, T, n_mels]. The DFT is a real-input FFT: the frame's even and
odd samples are packed into M = n_fft/2 complex points, a Stockham FFT of M
points runs radix-8 passes (the last one radix 4 or 2 where log2 M is not a
multiple of 3), and a split step recovers the n_fft/2 + 1 bins. Each mel
filter then sums only its own band of bins (`mel_bands`: the filterbank's
non-zero range, with its weights in ascending bin order).

On a CUDA tensor it launches the hand-written Hopper kernel
(csrc/mel_spectrogram.cu, which replaces the TPU kernel
src/repro/kernels/mel_spectrogram.py::mel_spectrogram_pallas and the framing
that src/repro/kernels/ops.py::mel_spectrogram_batch does around it); on a
CPU tensor it runs the plain PyTorch version below, which takes the same
inputs and follows the same stages. `LAUNCHES` counts kernel launches.
The dense three-product form stays as the oracle, `ref.mel_spectrogram_ref`.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build

LAUNCHES = 0
MIN_N_FFT, MAX_N_FFT = 64, 2048


def check_n_fft(n_fft: int) -> None:
    """The FFT takes a power of two in [64, 2048]; anything else raises."""
    if not (MIN_N_FFT <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0):
        raise ValueError(f"n_fft={n_fft}: the mel FFT takes a power of two from "
                         f"{MIN_N_FFT} to {MAX_N_FFT}")


def fft_twiddles(n_fft: int) -> np.ndarray:
    """W_n^k = exp(-2 pi i k / n_fft) for k < n_fft as [n_fft, 2] (cos, sin)
    float32, computed in float64: row k equals row 1, column k of
    `preprocess_cpu.dft_matrices` wherever both exist."""
    check_n_fft(n_fft)
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def fft_radices(m: int) -> List[int]:
    """The passes of an m-point FFT (m a power of two >= 8): radix 8, then
    the remainder 4 or 2 last."""
    log2 = m.bit_length() - 1
    return [8] * (log2 // 3) + {0: [], 1: [2], 2: [4]}[log2 % 3]


def mel_bands(fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """fb [n_mels, n_bins] -> (weights [W] float32, bands [n_mels, 3] int32).
    Filter m's band is [lo, hi), from its first to its last non-zero bin;
    its weights are fb[m, lo:hi] at weights[off : off + hi - lo], in
    ascending bin order. bands[m] = (lo, hi, off). An all-zero filter has an
    empty band. Outside the bands fb holds only exact zeros, so the band
    sums equal the dense product's terms."""
    bands = np.zeros((fb.shape[0], 3), np.int32)
    parts, off = [], 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
        bands[m] = (lo, hi, off)
        parts.append(row[lo:hi])
        off += hi - lo
    return np.concatenate(parts).astype(np.float32), bands


def n_frames(length: int, frame: int, hop: int) -> int:
    if hop < 1 or length < frame:
        raise ValueError(f"a signal of {length} samples holds no {frame}-sample frame "
                         f"(hop {hop})")
    return 1 + (length - frame) // hop


def frames(y: torch.Tensor, win: torch.Tensor, hop: int, n_fft: int) -> torch.Tensor:
    """y [N, L] -> its windowed frames, zero-padded to n_fft: [N * T, n_fft]."""
    frame = win.shape[0]
    nsig, length = y.shape
    t = n_frames(length, frame, hop)
    idx = (torch.arange(frame, device=y.device)[None, :]
           + hop * torch.arange(t, device=y.device)[:, None])
    return F.pad(y.float()[:, idx] * win, (0, n_fft - frame)).reshape(nsig * t, n_fft)


def _stockham(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Complex FFT of z [F, M] along its last axis by the kernel's passes:
    Stockham autosort, W_M^e = w[2e] from the n_fft = 2M table."""
    f, m = z.shape
    n = w.shape[0]
    ns = 1
    for r in fft_radices(m):
        j = torch.arange(m // r, device=z.device)
        rr = torch.arange(r, device=z.device)
        v = z.reshape(f, r, m // r)                        # v[:, r, j] = z[j + r m/r]
        if ns > 1:
            v = v * w[2 * (rr[:, None] * (j % ns)[None, :]) * (m // (ns * r))]
        dft = w[(n // r) * ((rr[:, None] * rr[None, :]) % r)]  # W_r^{s r}
        v = torch.einsum("sr,frj->fsj", dft, v)
        dst = (j // ns) * ns * r + j % ns
        out = torch.empty_like(z)
        out[:, dst[None, :] + ns * rr[:, None]] = v
        z, ns = out, ns * r
    return z


def mel_spectrogram_batch_plain(y: torch.Tensor, win: torch.Tensor, twiddles: torch.Tensor,
                                weights: torch.Tensor, bands: torch.Tensor,
                                hop: int) -> torch.Tensor:
    """Plain PyTorch version, stage by stage as the kernel: frame and
    window, pack even/odd samples, the Stockham passes, the split to
    n_fft/2 + 1 bins, power, the band sums, log."""
    n_fft = twiddles.shape[0]
    check_n_fft(n_fft)
    x = frames(y, win, hop, n_fft)
    w = torch.complex(twiddles[:, 0], twiddles[:, 1])
    z = _stockham(torch.complex(x[:, 0::2], x[:, 1::2]), w)
    m = n_fft // 2
    k = torch.arange(m + 1, device=y.device)
    za, zb = z[:, k % m], z[:, (m - k) % m].conj()
    spec = (za + zb) * 0.5 + w[k] * ((za - zb) * -0.5j)
    power = spec.real * spec.real + spec.imag * spec.imag
    # band m as a row of (bin, weight) pairs, padded with weight 0 at bin 0
    lo, hi, off = (bands[:, c, None].long() for c in range(3))
    i = torch.arange(int((hi - lo).max()), device=y.device)
    inside = i < hi - lo
    bins = torch.where(inside, lo + i, 0)
    wts = torch.cat([weights, weights.new_zeros(1)])[torch.where(inside, off + i, weights.numel())]
    mel = (power[:, bins] * wts).sum(-1)
    return torch.log(mel + 1e-6).reshape(y.shape[0], -1, bands.shape[0])


def mel_spectrogram_batch_kernel(y: torch.Tensor, win: torch.Tensor, twiddles: torch.Tensor,
                                 weights: torch.Tensor, bands: torch.Tensor,
                                 hop: int) -> torch.Tensor:
    """Launch the CUDA kernel once for the stack on its input's card, on
    that card's current stream (no sync)."""
    global LAUNCHES
    ts = (y, win, twiddles, weights, bands)
    if any(t.device.type != "cuda" or t.device != y.device for t in ts):
        raise ValueError(f"kernel needs all tensors on one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    if any(t.dtype != torch.float32 for t in ts[:4]) or bands.dtype != torch.int32:
        raise TypeError(f"kernel takes float32 signal and constants and int32 bands "
                        f"(got {[t.dtype for t in ts]})")
    if y.dim() != 2 or win.dim() != 1 or weights.dim() != 1 \
            or twiddles.dim() != 2 or twiddles.shape[1] != 2 \
            or bands.dim() != 2 or bands.shape[1] != 3:
        raise ValueError(f"expected y [N, L], win [frame], twiddles [n_fft, 2], weights [W], "
                         f"bands [n_mels, 3] (got {[tuple(t.shape) for t in ts]})")
    if not all(t.is_contiguous() for t in ts) or twiddles.data_ptr() % 8:
        raise ValueError("kernel takes contiguous tensors and 8-byte aligned twiddles")
    n_fft, frame = twiddles.shape[0], win.shape[0]
    check_n_fft(n_fft)
    if not 0 < frame <= n_fft:
        raise ValueError(f"frame={frame} outside (0, n_fft={n_fft}]")
    nsig, length = y.shape
    t = n_frames(length, frame, hop)
    n_mels = bands.shape[0]
    lib = build.library()
    if not 0 < n_mels <= lib.preba_mel_max_mels():
        raise ValueError(f"n_mels={n_mels} outside the kernel's range")
    out = torch.empty((nsig, t, n_mels), dtype=torch.float32, device=y.device)
    if nsig == 0:
        return out
    with torch.cuda.device(y.device):  # the attribute and the stream are the card's
        err = lib.preba_mel(y.data_ptr(), win.data_ptr(), twiddles.data_ptr(),
                            weights.data_ptr(), bands.data_ptr(), out.data_ptr(), nsig,
                            length, frame, hop, n_fft, n_mels, weights.numel(),
                            torch.cuda.current_stream().cuda_stream)
    build.check(err, "mel_spectrogram")
    LAUNCHES += 1
    return out


def mel_spectrogram_batch(y: torch.Tensor, win: torch.Tensor, twiddles: torch.Tensor,
                          weights: torch.Tensor, bands: torch.Tensor, hop: int) -> torch.Tensor:
    """y: [N, L] same-length signals; win: [frame] window; twiddles,
    weights, bands: `ops.mel_constants` -> log-mel [N, T, n_mels], T = 1 +
    (L - frame) // hop."""
    if y.device.type == "cpu":
        return mel_spectrogram_batch_plain(y, win, twiddles, weights, bands, hop)
    return mel_spectrogram_batch_kernel(y, win, twiddles, weights, bands, hop)
