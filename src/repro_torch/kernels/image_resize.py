"""Separable bilinear resize, the paper's 'Resize' functional unit.

`image_resize_batch` computes Ry @ img[n] @ Rx^T over a same-shape stack in
two passes (rows, then columns over the flattened [N*H_out, W] stack): on a
CUDA tensor it launches the hand-written Hopper kernel twice
(csrc/image_resize.cu, which replaces the TPU kernels
src/repro/kernels/image_resize.py::image_resize_batch_pallas), on a CPU
tensor it runs the plain PyTorch version below. `LAUNCHES` counts kernel
launches: two per stack.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

LAUNCHES = 0


def image_resize_batch_plain(imgs: torch.Tensor, ry: torch.Tensor,
                             rx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the rows product, then the columns product."""
    return (ry @ imgs.float()) @ rx.T


def image_resize_batch_kernel(imgs: torch.Tensor, ry: torch.Tensor,
                              rx: torch.Tensor) -> torch.Tensor:
    """Launch the two passes on PyTorch's current stream (no sync)."""
    global LAUNCHES
    ts = (imgs, ry, rx)
    if any(t.device.type != "cuda" or t.device != imgs.device for t in ts):
        raise ValueError(f"kernel needs all tensors on one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"kernel takes float32 (got {[t.dtype for t in ts]})")
    if imgs.dim() != 3 or ry.dim() != 2 or rx.dim() != 2 \
            or ry.shape[1] != imgs.shape[1] or rx.shape[1] != imgs.shape[2]:
        raise ValueError(f"expected imgs [N, H, W], ry [H_out, H], rx [W_out, W] "
                         f"(got {tuple(imgs.shape)}, {tuple(ry.shape)}, {tuple(rx.shape)})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kernel takes contiguous tensors")
    n, h, w = imgs.shape
    h_out, w_out = ry.shape[0], rx.shape[0]
    out = torch.empty((n, h_out, w_out), dtype=torch.float32, device=imgs.device)
    if out.numel() == 0 or h == 0 or w == 0:
        return out.zero_()
    lib = build.library()
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    tmp = torch.empty((n, h_out, w), dtype=torch.float32, device=imgs.device)
    err = lib.preba_resize_rows(imgs.data_ptr(), ry.data_ptr(), tmp.data_ptr(),
                                n, h, w, h_out, stream)
    build.check(err, "image_resize rows")
    LAUNCHES += 1
    err = lib.preba_resize_cols(tmp.data_ptr(), rx.data_ptr(), out.data_ptr(),
                                n * h_out, w, w_out, stream)
    build.check(err, "image_resize cols")
    LAUNCHES += 1
    return out


def image_resize_batch(imgs: torch.Tensor, ry: torch.Tensor,
                       rx: torch.Tensor) -> torch.Tensor:
    """imgs: [N, H, W]; ry: [H_out, H]; rx: [W_out, W] -> [N, H_out, W_out]."""
    if imgs.device.type == "cpu":
        return image_resize_batch_plain(imgs, ry, rx)
    return image_resize_batch_kernel(imgs, ry, rx)
