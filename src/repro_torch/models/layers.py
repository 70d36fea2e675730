"""Layer primitives of the dense decoder: RMSNorm, RoPE, masked dense
attention with GQA, the SiLU-gated MLP.

Plain functions on tensors. The compute dtype is the activation dtype;
norms, RoPE and the attention softmax run in fp32. The mask and the softmax
follow the JAX package's order (scores in fp32, NEG_INF fill, softmax,
masked probabilities zeroed), so logits stay comparable across the two.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; pos: int [S] absolute positions, or [B, S] per-row
    positions (ragged left-padded serving batches)."""
    d = x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half))
    freqs = pos.float()[..., :, None] * inv  # [S, half] or [B, S, half]
    if freqs.dim() == 2:
        freqs = freqs[None]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _pair_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """[Sq, Skv] bool mask (or [B, Sq, Skv] when either pos is per-row
    [B, S]). Negative positions mark invalid slots: kpos < 0 excludes a
    cache slot, qpos < 0 fully masks a padding query row."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    m = (k >= 0) & (q >= 0)
    if causal:
        m = m & (q >= k)
    if window:
        m = m & ((q - k) < window)
    return m


def _batch_mask(mask: torch.Tensor) -> torch.Tensor:
    """Normalize a _pair_mask result to [B|1, 1, 1, Sq, Skv] for
    [B, KH, G, Sq, Skv] score tensors."""
    if mask.dim() == 2:
        mask = mask[None]
    return mask[:, None, None]


def attention_dense(q, k, v, qpos, kpos, *, causal=True, window=0):
    """Direct-softmax attention. q: [B, Sq, H, D]; k, v: [B, Skv, KH, D]
    (GQA, H = KH * G). Scores are fp32 products of the inputs."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, D).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.float())
    s = s * (1.0 / math.sqrt(D))
    mask = _batch_mask(_pair_mask(qpos, kpos, causal, window))
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    # fully-masked query rows (left-pad slots) emit exactly 0, not a uniform
    # average; a no-op elsewhere since masked probs are already exactly 0
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    o = torch.einsum("bkgqj,bjkd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, D)


def attention(q, k, v, qpos, kpos, *, causal=True, window=0):
    """Dispatcher. Only the dense path is served so far: the prompt buckets
    this engine admits (max_prompt_len) keep Sq * Skv far inside it."""
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq * Skv <= 4096 * 1024 or Sq == 1:
        return attention_dense(q, k, v, qpos, kpos, causal=causal, window=window)
    raise NotImplementedError(
        f"attention over {Sq}x{Skv} needs the blockwise path, not ported yet")


def mlp(x: torch.Tensor, p) -> torch.Tensor:
    """SiLU-gated MLP: (silu(x Wg) * (x Wu)) Wo."""
    dt = x.dtype
    g = x @ p["wi_gate"].to(dt)
    u = x @ p["wi_up"].to(dt)
    return (F.silu(g) * u) @ p["wo"].to(dt)
