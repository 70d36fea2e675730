"""JPEG block decode, the paper's 'Decode' functional unit: dequantize and
8x8 inverse DCT (Huffman decode stays on the host, before the DPU).

`jpeg_idct_batch` computes img[n, 8by+i, 8bx+l] = (M (C[n,by,bx] * Q) M^T)[i, l]
+ 128 over a same-shape coefficient stack: on a CUDA tensor it launches the
hand-written Hopper kernel (csrc/jpeg_idct.cu, which replaces the TPU
kernel src/repro/kernels/jpeg_idct.py::jpeg_idct_pallas and writes straight
into image layout, 16 bytes at a time: a coefficient stack that does not
start on 16 bytes is refused), on a CPU tensor it runs the plain PyTorch
version below.
`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.data import preprocess_cpu as pp
from repro_torch.kernels import build

LAUNCHES = 0


@lru_cache(maxsize=None)
def idct_basis(device: torch.device) -> torch.Tensor:
    """The orthonormal 8x8 IDCT basis M [8, 8] (fp32) on `device`."""
    return torch.tensor(pp.idct_matrix(), dtype=torch.float32, device=device)


def jpeg_idct_batch_plain(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: dequantize, the two 8x8 products per block,
    then the blocks reassembled into images as the JAX package does."""
    n, by, bx = coeffs.shape[:3]
    m = idct_basis(coeffs.device)
    blocks = m @ (coeffs.float() * qtable.float()) @ m.T + 128.0
    return blocks.permute(0, 1, 3, 2, 4).reshape(n, by * 8, bx * 8)


def jpeg_idct_batch_kernel(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on its input's card, on that card's current
    stream (no sync)."""
    global LAUNCHES
    if coeffs.device.type != "cuda" or qtable.device != coeffs.device:
        raise ValueError(f"kernel needs both tensors on one CUDA device "
                         f"(got {coeffs.device}, {qtable.device})")
    if coeffs.dtype != torch.float32 or qtable.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 (got {coeffs.dtype}, {qtable.dtype})")
    if coeffs.dim() != 5 or tuple(coeffs.shape[3:]) != (8, 8) \
            or tuple(qtable.shape) != (8, 8):
        raise ValueError(f"expected coeffs [N, BY, BX, 8, 8] and qtable [8, 8] "
                         f"(got {tuple(coeffs.shape)}, {tuple(qtable.shape)})")
    if not (coeffs.is_contiguous() and qtable.is_contiguous()):
        raise ValueError("kernel takes contiguous tensors")
    n, by, bx = coeffs.shape[:3]
    out = torch.empty((n, 8 * by, 8 * bx), dtype=torch.float32, device=coeffs.device)
    if out.numel() == 0:
        return out
    if coeffs.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("kernel reads and writes 16 bytes at a time: coeffs and out "
                         "must start on 16 bytes")
    lib = build.library()
    basis = idct_basis(coeffs.device)
    with torch.cuda.device(coeffs.device):  # the launch and the stream are the card's
        err = lib.preba_idct(coeffs.data_ptr(), qtable.data_ptr(), basis.data_ptr(),
                             out.data_ptr(), n * by, bx,
                             torch.cuda.current_stream().cuda_stream)
    build.check(err, "jpeg_idct")
    LAUNCHES += 1
    return out


def jpeg_idct_batch(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """coeffs: [N, H/8, W/8, 8, 8] quantized blocks; qtable: [8, 8] ->
    pixels [N, H, W]."""
    if coeffs.device.type == "cpu":
        return jpeg_idct_batch_plain(coeffs, qtable)
    return jpeg_idct_batch_kernel(coeffs, qtable)
