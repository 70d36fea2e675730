"""Separable bilinear resize, the paper's 'Resize' functional unit.

`image_resize_batch` computes Ry @ img[n] @ Rx^T over a same-shape stack
[N, H, W] from the matrices' taps (`ops.resize_taps`: for each output row
the two columns of its non-zeros and their weights): first the vertical
taps, then the horizontal ones, as the reference's two products order them.
On a CUDA tensor it launches the hand-written Hopper kernel once for the
stack (csrc/image_resize.cu, which replaces the TPU kernels
src/repro/kernels/image_resize.py::image_resize_batch_pallas); on a CPU
tensor it runs the plain PyTorch version below, the same two-tap gather.
`LAUNCHES` counts kernel launches: one per stack.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0

Taps = Tuple[torch.Tensor, torch.Tensor]  # (idx [n_out, 2] int32, w [n_out, 2] float32)


def image_resize_batch_plain(imgs: torch.Tensor, ytaps: Taps, xtaps: Taps) -> torch.Tensor:
    """Plain PyTorch version: the vertical taps, then the horizontal taps."""
    (yi, yw), (xi, xw) = ytaps, xtaps
    x = imgs.float()
    t = (yw[:, 0, None] * x.index_select(1, yi[:, 0])
         + yw[:, 1, None] * x.index_select(1, yi[:, 1]))
    return xw[:, 0] * t.index_select(2, xi[:, 0]) + xw[:, 1] * t.index_select(2, xi[:, 1])


def image_resize_batch_kernel(imgs: torch.Tensor, ytaps: Taps, xtaps: Taps) -> torch.Tensor:
    """Launch the kernel once for the stack on its input's card, on that
    card's current stream (no sync)."""
    global LAUNCHES
    (yi, yw), (xi, xw) = ytaps, xtaps
    ts = (imgs, yi, yw, xi, xw)
    if any(t.device.type != "cuda" or t.device != imgs.device for t in ts):
        raise ValueError(f"kernel needs all tensors on one CUDA device "
                         f"(got {[str(t.device) for t in ts]})")
    if imgs.dtype != torch.float32 or yw.dtype != torch.float32 \
            or xw.dtype != torch.float32 or yi.dtype != torch.int32 or xi.dtype != torch.int32:
        raise TypeError(f"kernel takes float32 images and weights and int32 columns "
                        f"(got {[t.dtype for t in ts]})")
    if imgs.dim() != 3 or any(t.dim() != 2 or t.shape[1] != 2 for t in ts[1:]) \
            or yi.shape != yw.shape or xi.shape != xw.shape:
        raise ValueError(f"expected imgs [N, H, W] and taps [H_out, 2], [W_out, 2] "
                         f"(got {[tuple(t.shape) for t in ts]})")
    if not all(t.is_contiguous() for t in ts) or any(t.data_ptr() % 8 for t in ts[1:]):
        raise ValueError("kernel takes contiguous tensors and 8-byte aligned taps")
    n, h, w = imgs.shape
    h_out, w_out = yi.shape[0], xi.shape[0]
    out = torch.empty((n, h_out, w_out), dtype=torch.float32, device=imgs.device)
    if out.numel() == 0 or h == 0 or w == 0:
        return out.zero_()
    lib = build.library()
    with torch.cuda.device(imgs.device):  # the attribute and the stream are the card's
        err = lib.preba_resize(imgs.data_ptr(), yi.data_ptr(), yw.data_ptr(),
                               xi.data_ptr(), xw.data_ptr(), out.data_ptr(), n, h, w,
                               h_out, w_out, torch.cuda.current_stream().cuda_stream)
    build.check(err, "image_resize")
    LAUNCHES += 1
    return out


def image_resize_batch(imgs: torch.Tensor, ytaps: Taps, xtaps: Taps) -> torch.Tensor:
    """imgs: [N, H, W]; ytaps, xtaps: (idx, w), each [n_out, 2], from
    `ops.resize_taps` -> [N, H_out, W_out]."""
    if imgs.device.type == "cpu":
        return image_resize_batch_plain(imgs, ytaps, xtaps)
    return image_resize_batch_kernel(imgs, ytaps, xtaps)
