"""Per-utterance mean/variance normalize, the paper's 'Normalize' functional
unit.

`audio_normalize_batch` computes, per utterance and feature,
mu = sum(x)/T, var = max(sum(x^2)/T - mu^2, 0), (x - mu) * rsqrt(var + eps):
on a CUDA tensor it launches the hand-written Hopper kernel
(csrc/audio_normalize.cu, which replaces the TPU kernels
src/repro/kernels/audio_normalize.py::audio_normalize_batch_pallas), on a CPU
tensor it runs the plain PyTorch version below. `LAUNCHES` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

LAUNCHES = 0


def audio_normalize_batch_plain(feats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version, the same formula as the kernel."""
    t = feats.shape[1]
    x = feats.float()
    mu = x.sum(1, keepdim=True) / t
    var = torch.clamp((x * x).sum(1, keepdim=True) / t - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps)


def audio_normalize_batch_kernel(feats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    global LAUNCHES
    if feats.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor (got {feats.device})")
    if feats.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 (got {feats.dtype})")
    if feats.dim() != 3 or not feats.is_contiguous():
        raise ValueError(f"kernel takes a contiguous [N, T, F] tensor "
                         f"(got {tuple(feats.shape)})")
    n, t, f = feats.shape
    if t < 1 or f < 1:
        raise ValueError(f"empty utterances {tuple(feats.shape)}")
    lib = build.library()
    if lib.preba_normalize_smem_bytes(f) > 48 * 1024:
        raise ValueError(f"{f} features exceed the kernel's shared memory")
    out = torch.empty_like(feats)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = lib.preba_normalize(feats.data_ptr(), out.data_ptr(), n, t, f,
                              float(eps), stream)
    build.check(err, "audio_normalize")
    LAUNCHES += 1
    return out


def audio_normalize_batch(feats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """feats: [N, T, F] same-shape stack -> per-utterance normalized."""
    if feats.device.type == "cpu":
        return audio_normalize_batch_plain(feats, eps)
    return audio_normalize_batch_kernel(feats, eps)
