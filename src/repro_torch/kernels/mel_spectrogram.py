"""Log-mel spectrogram, the paper's 'Mel spectrogram' functional unit.

`mel_spectrogram_batch` computes log(((F Cr)^2 + (F Ci)^2) FB + 1e-6) for
framed, windowed, zero-padded frames: on a CUDA tensor it launches the
hand-written Hopper kernel (csrc/mel_spectrogram.cu, which replaces the TPU
kernel src/repro/kernels/mel_spectrogram.py::mel_spectrogram_pallas), on a
CPU tensor it runs the plain PyTorch version below. `LAUNCHES` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

LAUNCHES = 0


def mel_spectrogram_batch_plain(frames: torch.Tensor, cr: torch.Tensor,
                                ci: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: three products, the power between them."""
    re = frames @ cr
    im = frames @ ci
    return torch.log((re * re + im * im) @ fb + 1e-6)


def mel_spectrogram_batch_kernel(frames: torch.Tensor, cr: torch.Tensor,
                                 ci: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    ts = (frames, cr, ci, fb)
    if any(t.device.type != "cuda" or t.device != frames.device for t in ts):
        raise ValueError(f"kernel needs all tensors on one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"kernel takes float32 (got {[t.dtype for t in ts]})")
    if any(t.dim() != 2 for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous 2-D tensors")
    m, n_fft = frames.shape
    n_bins, n_mels = fb.shape
    if cr.shape != (n_fft, n_bins) or ci.shape != (n_fft, n_bins):
        raise ValueError(f"bases {tuple(cr.shape)}/{tuple(ci.shape)} do not match "
                         f"frames {tuple(frames.shape)} and filterbank {tuple(fb.shape)}")
    lib = build.library()
    if not 0 < n_mels <= lib.preba_mel_max_mels():
        raise ValueError(f"n_mels={n_mels} outside the kernel's range")
    out = torch.empty((m, n_mels), dtype=torch.float32, device=frames.device)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = lib.preba_mel(frames.data_ptr(), cr.data_ptr(), ci.data_ptr(),
                        fb.data_ptr(), out.data_ptr(), m, n_fft, n_bins, n_mels,
                        stream)
    build.check(err, "mel_spectrogram")
    LAUNCHES += 1
    return out


def mel_spectrogram_batch(frames: torch.Tensor, cr: torch.Tensor,
                          ci: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """frames: [M, n_fft]; cr/ci: [n_fft, n_bins]; fb: [n_bins, n_mels] ->
    log-mel [M, n_mels]."""
    if frames.device.type == "cpu":
        return mel_spectrogram_batch_plain(frames, cr, ci, fb)
    return mel_spectrogram_batch_kernel(frames, cr, ci, fb)
