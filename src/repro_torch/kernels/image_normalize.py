"""Fused center crop + normalize, the paper's 'Crop' and 'Normalize'
functional units.

`image_crop_normalize_batch` computes (x[n, y0+r, x0+c] - mean) * (1/std)
on the centered [ch, cw] window of a same-shape stack, with 1/std rounded
to fp32 once: on a CUDA tensor it launches the hand-written Hopper kernel
(csrc/image_normalize.cu, which replaces the TPU kernel
src/repro/kernels/image_normalize.py::image_crop_normalize_pallas and reads
the window in place instead of copying it), on a CPU tensor it runs the
plain PyTorch version below. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build

LAUNCHES = 0


def crop_origin(h: int, w: int, ch: int, cw: int) -> Tuple[int, int]:
    """Top-left corner of the centered [ch, cw] window of an [h, w] image."""
    if not (0 < ch <= h and 0 < cw <= w):
        raise ValueError(f"crop {ch}x{cw} does not fit a {h}x{w} image")
    return (h - ch) // 2, (w - cw) // 2


def _inv_std(std: float) -> float:
    return float(np.float32(1.0 / std))


def image_crop_normalize_batch_plain(imgs: torch.Tensor, ch: int, cw: int,
                                     mean: float, std: float) -> torch.Tensor:
    """Plain PyTorch version: slice the window, subtract, scale."""
    y0, x0 = crop_origin(imgs.shape[1], imgs.shape[2], ch, cw)
    win = imgs[:, y0:y0 + ch, x0:x0 + cw].float()
    return (win - float(np.float32(mean))) * _inv_std(std)


def image_crop_normalize_batch_kernel(imgs: torch.Tensor, ch: int, cw: int,
                                      mean: float, std: float) -> torch.Tensor:
    """Launch the CUDA kernel on its input's card, on that card's current
    stream (no sync)."""
    global LAUNCHES
    if imgs.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor (got {imgs.device})")
    if imgs.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 (got {imgs.dtype})")
    if imgs.dim() != 3 or not imgs.is_contiguous():
        raise ValueError(f"kernel takes a contiguous [N, H, W] tensor "
                         f"(got {tuple(imgs.shape)})")
    n, h, w = imgs.shape
    y0, x0 = crop_origin(h, w, ch, cw)
    out = torch.empty((n, ch, cw), dtype=torch.float32, device=imgs.device)
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(imgs.device):  # the SM count and the stream are the card's
        err = lib.preba_crop_normalize(imgs.data_ptr(), out.data_ptr(), n, h, w, y0, x0,
                                       ch, cw, float(mean), _inv_std(std),
                                       torch.cuda.current_stream().cuda_stream)
    build.check(err, "image_normalize")
    LAUNCHES += 1
    return out


def image_crop_normalize_batch(imgs: torch.Tensor, ch: int, cw: int,
                               mean: float, std: float) -> torch.Tensor:
    """imgs: [N, H, W] -> the centered [N, ch, cw] window, normalized."""
    if imgs.device.type == "cpu":
        return image_crop_normalize_batch_plain(imgs, ch, cw, mean, std)
    return image_crop_normalize_batch_kernel(imgs, ch, cw, mean, std)
