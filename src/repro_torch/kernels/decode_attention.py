"""Flash-decode GQA attention for one query token per sequence: the decode
step of serving.

`decode_attention` computes, for q [B, H, D] against k, v [B, S, KH, D]
with valid_len [B] (positions [0, valid_len) hold keys; G = H / KH query
heads share a KV head), the softmax of the fp32 scores q.k / sqrt(D) with
positions at or past valid_len set to -1e30, times V, in fp32, cast to q's
type. At valid_len == 0 every score is -1e30, so every position weighs the
same and the output is the mean of V over the S positions. With
`return_lse=True` it also returns each row's log-sum-exp of those scaled
scores over the valid prefix, lse [B, H] fp32, and a row with valid_len 0
weighs nothing instead (o = 0, lse = -inf): a rank that holds one cut of a
ring along its sequence returns (o, lse), and the ranks' partial outputs
merge exactly (`distributed.ctx.merge_seq_shards`). On a CUDA tensor
it launches the hand-written Hopper kernel once (csrc/decode_attention.cu,
which replaces the TPU kernel
src/repro/kernels/decode_attention.py::decode_attention_pallas: a cluster
of 8 blocks per KV head and sequence splits S and merges in one launch); on
a CPU tensor it runs the plain PyTorch version below; on a meta tensor
(the dry run) it returns outputs of the right shapes and types and reports
its two products to the op counter (`decode_attention_meta`). The kernel is
compiled for the head sizes in HEAD_DIMS (80 is h2o-danube's, 96
phi-3-vision's); any other raises. `LAUNCHES` counts kernel launches, with
and without the lse.
"""
from __future__ import annotations

import math

import torch

from repro_torch.analysis import op_trace
from repro_torch.kernels import build

LAUNCHES = 0
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 96, 128)


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len: torch.Tensor, return_lse: bool = False):
    """Plain PyTorch version: dense masked softmax over all S positions;
    with return_lse, (o, the logsumexp of the masked scores), a row with
    no valid key giving o = 0 and lse = -inf."""
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    qg = q.reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k.float()) * _scale(D)
    vl = valid_len.to(device=q.device, dtype=torch.int64)
    valid = torch.arange(S, device=q.device)[None, :] < vl[:, None]
    s = torch.where(valid[:, None, None], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", p, v.float()).reshape(B, H, D)
    if not return_lse:
        return o.to(q.dtype)
    empty = (vl <= 0)[:, None]
    lse = torch.where(empty, float("-inf"), torch.logsumexp(s, dim=-1).reshape(B, H))
    return torch.where(empty[..., None], 0.0, o).to(q.dtype), lse


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid_len: torch.Tensor, return_lse: bool = False):
    """Launch the CUDA kernel on its input's card, on that card's current
    stream (no sync); with return_lse, (o, lse [B, H] fp32)."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v), ("valid_len", valid_len)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"kernel needs CUDA tensors on one device "
                             f"({name} is on {t.device})")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"kernel takes float32 or bfloat16 q, k, v of one type "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if valid_len.dtype != torch.int32:
        raise TypeError(f"valid_len must be int32 (got {valid_len.dtype})")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"kernel takes q [B, H, D] and k, v [B, S, KH, D] "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or valid_len.shape != (B,):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"valid_len {tuple(valid_len.shape)}")
    if D not in HEAD_DIMS or H % KH:
        raise ValueError(f"kernel takes head size in {HEAD_DIMS} and H a multiple "
                         f"of KH (got D={D}, H={H}, KH={KH})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and valid_len.is_contiguous()):
        raise ValueError("kernel takes contiguous tensors")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("kernel takes q, k and v starting on 16 bytes (its "
                         "16-byte copies read K and V rows in place)")
    bf16 = int(q.dtype == torch.bfloat16)
    lib = build.library()
    if lib.preba_decode_attention_smem_bytes(D, H // KH, bf16) > 227 * 1024:
        raise ValueError(f"{H // KH} query heads a KV head exceed the kernel's "
                         f"shared memory at D={D}")
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    if B == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):  # the attribute and the stream are the card's
        err = lib.preba_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         valid_len.data_ptr(), out.data_ptr(),
                                         None if lse is None else lse.data_ptr(), B, H,
                                         KH, S, D, bf16, _scale(D),
                                         torch.cuda.current_stream().cuda_stream)
    build.check(err, "decode_attention")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def decode_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_len: torch.Tensor, return_lse: bool = False):
    """The kernel's outputs on the meta device (shapes and types, nothing
    computed), for the dry run. Its QK and PV products are reported to the
    op counter (`analysis/op_trace.note_dot`) over the whole ring, 2 B H S
    D FLOPs each: the work of the JAX package's dense attention dots at the
    same shape, whatever computes the function. Their bytes are those
    dots' operands and outputs: q, K, the fp32 scores; the probabilities
    in V's type, V, the output."""
    B, H, D = q.shape
    S = k.shape[1]
    flops = 2.0 * B * H * S * D
    op_trace.note_dot("decode_attention.qk", q.shape, (B, H, S), flops,
                      q.nbytes + k.nbytes + 4 * B * H * S)
    op_trace.note_dot("decode_attention.pv", (B, H, S), (B, H, D), flops,
                      v.element_size() * B * H * S + v.nbytes + q.nbytes)
    out = torch.empty_like(q)
    if not return_lse:
        return out
    return out, torch.empty((B, H), dtype=torch.float32, device=q.device)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, return_lse: bool = False):
    """q: [B, H, D]; k, v: [B, S, KH, D]; valid_len: [B] -> [B, H, D], and
    with return_lse lse [B, H] fp32."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid_len, return_lse)
    if q.device.type == "meta":
        return decode_attention_meta(q, k, v, valid_len, return_lse)
    return decode_attention_kernel(q, k, v, valid_len, return_lse)
