"""Per-utterance mean/variance normalize, the paper's 'Normalize' functional
unit.

`audio_normalize_batch` computes, per utterance and feature,
mu = sum(x)/T, var = max(sum(x^2)/T - mu^2, 0), (x - mu) * rsqrt(var + eps):
on a CUDA tensor it launches the hand-written Hopper kernel
(csrc/audio_normalize.cu, which replaces the TPU kernels
src/repro/kernels/audio_normalize.py::audio_normalize_batch_pallas: a
thread block cluster of C blocks an utterance, each staging its span of
rows in shared memory once), on a CPU tensor it runs the plain PyTorch
version below. `plan` is the kernel's launch plan for a shape, which
depends on (T, F) only. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

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


class Plan(NamedTuple):
    cluster: int  # blocks an utterance (a thread block cluster)
    rows: int     # rows a block at most
    staged: bool  # each block's span is read once, into shared memory


@lru_cache(maxsize=None)
def plan(t: int, f: int) -> Plan:
    """The kernel's launch plan for T rows of F features. Raises ValueError
    for a shape the kernel does not take."""
    out = [ctypes.c_int() for _ in range(3)]
    err = build.library().preba_normalize_plan(t, f, *map(ctypes.byref, out))
    if err:
        raise ValueError(f"audio_normalize takes no plan for T={t}, F={f}")
    c, rows, staged = (v.value for v in out)
    return Plan(c, rows, bool(staged))


def audio_normalize_batch_kernel(feats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel on its input's card, on that card's current
    stream (no sync)."""
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
    plan(t, f)
    out = torch.empty_like(feats)
    if n == 0:
        return out
    with torch.cuda.device(feats.device):  # the attribute and the stream are the card's
        err = build.library().preba_normalize(feats.data_ptr(), out.data_ptr(), n, t, f,
                                              float(eps),
                                              torch.cuda.current_stream().cuda_stream)
    build.check(err, "audio_normalize")
    LAUNCHES += 1
    return out


def audio_normalize_batch(feats: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """feats: [N, T, F] same-shape stack -> per-utterance normalized."""
    if feats.device.type == "cpu":
        return audio_normalize_batch_plain(feats, eps)
    return audio_normalize_batch_kernel(feats, eps)
