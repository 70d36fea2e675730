"""FIR decimation, the paper's 'Resample' functional unit.

`audio_resample_batch` computes y[n, i] = sum_k h[k] * xz[n, i*down + k -
pad_left] over a stack of signals, where xz is the signal with zeros outside
it: the kernel pads the signal itself, so a caller passes the unpadded
stack and pad_left (pad_left = 0 on a pre-padded stack is the plain FIR).
On a CUDA tensor it launches the hand-written Hopper kernel
(csrc/audio_resample.cu, which replaces the TPU kernel
src/repro/kernels/audio_resample.py::audio_resample_batch_pallas), on a CPU
tensor it runs the plain PyTorch version below. `LAUNCHES` counts kernel
launches.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

LAUNCHES = 0


def _n_out(length: int, taps: int, down: int, n_out: Optional[int], pad_left: int) -> int:
    """Outputs of the signal padded to length + pad_left + taps (zeros on
    both sides); n_out, if given, must lie in (0, that count]."""
    if length < 1:
        raise ValueError(f"signal of {length} samples")
    if pad_left < 0:
        raise ValueError(f"pad_left={pad_left} must be >= 0")
    full = (length + pad_left) // down + 1
    if n_out is None:
        return full
    if not 0 < n_out <= full:
        raise ValueError(f"n_out={n_out} outside (0, {full}]")
    return n_out


def audio_resample_batch_plain(x: torch.Tensor, h: torch.Tensor, down: int,
                               n_out: Optional[int] = None,
                               pad_left: int = 0) -> torch.Tensor:
    """Plain PyTorch version: pad with zeros, gather every output's window,
    weight, sum."""
    taps = h.shape[0]
    n = _n_out(x.shape[1], taps, down, n_out, pad_left)
    xp = F.pad(x.float(), (pad_left, taps))
    win = xp.unfold(1, taps, down)[:, :n]  # [N, n_out, taps] view
    return (win * h.float()).sum(-1)


def audio_resample_batch_kernel(x: torch.Tensor, h: torch.Tensor, down: int,
                                n_out: Optional[int] = None,
                                pad_left: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on its input's card, on that card's current
    stream (no sync)."""
    global LAUNCHES
    if x.device.type != "cuda" or h.device != x.device:
        raise ValueError(f"kernel needs both tensors on one CUDA device "
                         f"(got {x.device}, {h.device})")
    if x.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 (got {x.dtype}, {h.dtype})")
    if x.dim() != 2 or h.dim() != 1:
        raise ValueError(f"expected x [N, L] and h [taps] (got {tuple(x.shape)}, "
                         f"{tuple(h.shape)})")
    if not (x.is_contiguous() and h.is_contiguous()):
        raise ValueError("kernel takes contiguous tensors")
    if down < 1:
        raise ValueError(f"down={down} must be >= 1")
    nsig, length = x.shape
    taps = h.shape[0]
    n = _n_out(length, taps, down, n_out, pad_left)
    lib = build.library()
    if lib.preba_resample_smem_bytes(nsig, n, taps, down) > 48 * 1024:
        raise ValueError(f"{taps} taps at down={down} exceed the kernel's shared memory")
    y = torch.empty((nsig, n), dtype=torch.float32, device=x.device)
    if nsig == 0:
        return y
    with torch.cuda.device(x.device):  # the SM count and the stream are the card's
        err = lib.preba_resample(x.data_ptr(), h.data_ptr(), y.data_ptr(), nsig, length,
                                 taps, down, pad_left, n,
                                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "audio_resample")
    LAUNCHES += 1
    return y


def audio_resample_batch(x: torch.Tensor, h: torch.Tensor, down: int,
                         n_out: Optional[int] = None, pad_left: int = 0) -> torch.Tensor:
    """x: [N, L] stack; h: [taps]; returns [N, n_out] with n_out =
    (L + pad_left) // down + 1 unless given smaller."""
    if x.device.type == "cpu":
        return audio_resample_batch_plain(x, h, down, n_out, pad_left)
    return audio_resample_batch_kernel(x, h, down, n_out, pad_left)
