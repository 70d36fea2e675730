"""FIR decimation, the paper's 'Resample' functional unit.

`audio_resample_batch` computes y[n, i] = sum_k h[k] * xp[n, i*down + k] over
a stack of pre-padded signals: on a CUDA tensor it launches the hand-written
Hopper kernel (csrc/audio_resample.cu, which replaces the TPU kernel
src/repro/kernels/audio_resample.py::audio_resample_batch_pallas), on a CPU
tensor it runs the plain PyTorch version below. `LAUNCHES` counts kernel
launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0


def _n_out(length: int, taps: int, down: int, n_out: Optional[int]) -> int:
    full = (length - taps) // down + 1
    if full < 1:
        raise ValueError(f"signal of {length} samples is shorter than {taps} taps")
    if n_out is None:
        return full
    if not 0 < n_out <= full:
        raise ValueError(f"n_out={n_out} outside (0, {full}]")
    return n_out


def audio_resample_batch_plain(xp: torch.Tensor, h: torch.Tensor, down: int,
                               n_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: gather every output's window, weight, sum."""
    n = _n_out(xp.shape[1], h.shape[0], down, n_out)
    win = xp.float().unfold(1, h.shape[0], down)[:, :n]  # [N, n_out, taps] view
    return (win * h.float()).sum(-1)


def audio_resample_batch_kernel(xp: torch.Tensor, h: torch.Tensor, down: int,
                                n_out: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    if xp.device.type != "cuda" or h.device != xp.device:
        raise ValueError(f"kernel needs both tensors on one CUDA device "
                         f"(got {xp.device}, {h.device})")
    if xp.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 (got {xp.dtype}, {h.dtype})")
    if xp.dim() != 2 or h.dim() != 1:
        raise ValueError(f"expected xp [N, L] and h [taps] (got {tuple(xp.shape)}, "
                         f"{tuple(h.shape)})")
    if not (xp.is_contiguous() and h.is_contiguous()):
        raise ValueError("kernel takes contiguous tensors")
    if down < 1:
        raise ValueError(f"down={down} must be >= 1")
    nsig, length = xp.shape
    taps = h.shape[0]
    n = _n_out(length, taps, down, n_out)
    lib = build.library()
    if lib.preba_resample_smem_bytes(taps, down) > 48 * 1024:
        raise ValueError(f"{taps} taps at down={down} exceed the kernel's shared memory")
    y = torch.empty((nsig, n), dtype=torch.float32, device=xp.device)
    if nsig == 0:
        return y
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = lib.preba_resample(xp.data_ptr(), h.data_ptr(), y.data_ptr(), nsig,
                             length, taps, down, n, stream)
    build.check(err, "audio_resample")
    LAUNCHES += 1
    return y


def audio_resample_batch(xp: torch.Tensor, h: torch.Tensor, down: int,
                         n_out: Optional[int] = None) -> torch.Tensor:
    """xp: [N, L] pre-padded stack; h: [taps]; returns [N, n_out] with
    n_out = (L - taps) // down + 1 unless given smaller."""
    if xp.device.type == "cpu":
        return audio_resample_batch_plain(xp, h, down, n_out)
    return audio_resample_batch_kernel(xp, h, down, n_out)
