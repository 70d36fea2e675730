"""Layer primitives of the served families: RMSNorm (plain and gated),
RoPE, attention with GQA (dense, blockwise online-softmax, sliding-window
banded, and the dispatcher that picks one by shape), the SiLU-gated MLP,
GShard mixture-of-experts (the router, the capacity dispatch mask, the
grouped einsum dispatch and the sort-based one), and the Mamba2 block
(causal depthwise conv, the chunked SSD scan, the one-token SSM step).

On a tensor-parallel rank (a mesh set by `core/steps.sharded_prefill` /
`sharded_decode`) the same functions run on the rank's shards and close
their cut contractions through `distributed/ctx.py`: the MLP's and the
Mamba2 block's row-parallel products, the Mamba2 block's gated RMSNorm and
its conv channels (cut over `model` across the x | B | C split, gathered
whole), and the MoE experts, through `moe_shard_map` (the JAX package's,
experts over `data`) or the dispatch over the global groups, as the JAX
package's `moe()` picks.

Plain functions on tensors. The compute dtype is the activation dtype;
norms, RoPE, the attention softmax, the router and the SSM scan run in
fp32. The mask and the softmax follow the JAX package's order (scores in
fp32, NEG_INF fill, softmax, masked probabilities zeroed), the router its
tie order (the lower expert index first), and the SSD scan its formulas
term for term, so outputs stay comparable across the two.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import ctx as dctx

NEG_INF = -1e30


def constrain_batch_dp(x: torch.Tensor, axes, dim: Optional[int],
                       rows=None) -> torch.Tensor:
    """The attention batch-DP layout (the JAX package's constraint of q, k,
    v and the attention output to rows over `axes`, a train config's
    `attn_dp_axes`). x [B, S, ...] holds this rank's rows over the data
    axes with its dim `dim` (the KV heads, or head_dim) cut over `model`,
    the weights' layout; it returns the rank's rows cut over every axis of
    `axes` with `dim` whole: rows over the data axes stay as they are, and
    over `model` an all-to-all (`ctx.rows_to_model`) cuts them, zero rows
    padding them to a multiple of the axis. With `rows` (the rank's rows
    before) it is the way back, for the attention output before `wo`. With
    `dim` None, x is whole on every `model` rank (the block carry between
    training's layers, `lm._train_layers`): the cut keeps the rank's rows
    and the way back gathers them. The identity where `axes` is empty or
    holds no `model` axis wider than 1."""
    if "model" not in axes:
        return x
    if rows is None:
        return dctx.rows_to_model(x, dim)
    return dctx.rows_from_model(x, dim, rows)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rmsnorm_gated(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2-style gated RMSNorm: norm(x * silu(z)) * w."""
    return rmsnorm(x * F.silu(z.to(x.dtype)), w, eps)


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


def _kv_block(qg, kb, vb, mask, m, l_, acc, scale):
    """One KV block's step of the online softmax: (m, l, acc) updated."""
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, kb.float()) * scale
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    # fully-masked pad queries stay exactly 0
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    corr = torch.exp(m - m_new)
    l_ = l_ * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bkgqj,bjkd->bkgqd", p, vb.float())
    return m_new, l_, acc


def attention_blockwise(q, k, v, qpos, kpos, *, causal=True, window=0, kv_block=512):
    """Online-softmax (flash-style) attention over KV blocks of kv_block
    keys: O(Sq * kv_block) scores at a time instead of O(Sq * Skv). Shapes
    and masks as attention_dense; the output is cast to q's type. Where a
    gradient is taken, each block runs under `torch.utils.checkpoint` (the
    JAX package's nested remat): the backward recomputes a block's scores
    instead of keeping every block's."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    if Skv % kv_block:
        pad = kv_block - Skv % kv_block
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-1)
        Skv += pad
    qg = q.reshape(B, Sq, KH, G, D).float()
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, KH, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_ = torch.zeros((B, KH, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, G, Sq, D), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    for j in range(0, Skv, kv_block):
        mask = _batch_mask(_pair_mask(qpos, kpos[..., j:j + kv_block], causal, window))
        args = (qg, k[:, j:j + kv_block], v[:, j:j + kv_block], mask, m, l_, acc, scale)
        m, l_, acc = (checkpoint(_kv_block, *args, use_reentrant=False) if remat
                      else _kv_block(*args))
    out = acc / torch.clamp(l_, min=1e-30)[..., None]  # [B, KH, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def attention_swa_banded(q, k, v, pos0: int, window: int, *, kv_block=512):
    """Sliding-window attention with banded blocking: each window-sized
    query block attends to its own key block and the previous one, O(S * 2W)
    not O(S^2). Needs S % window == 0 and positions shared by the batch
    (pos0 + arange(S))."""
    B, S, H, D = q.shape
    W = window
    if S % W:
        raise ValueError(f"banded attention needs S % window == 0 (S={S}, window={W})")
    dev = q.device
    outs = []
    for j in range(S // W):
        lo = max(j - 1, 0) * W
        kj, vj = k[:, lo:(j + 1) * W], v[:, lo:(j + 1) * W]
        if j == 0:  # the first block has no previous one: zero keys, masked
            kj = torch.cat([torch.zeros_like(kj), kj], dim=1)
            vj = torch.cat([torch.zeros_like(vj), vj], dim=1)
        qpos = pos0 + j * W + torch.arange(W, device=dev)
        kpos = pos0 + (j - 1) * W + torch.arange(2 * W, device=dev)
        kpos = torch.where(kpos >= pos0, kpos, torch.full_like(kpos, -1))
        outs.append(attention_blockwise(q[:, j * W:(j + 1) * W], kj, vj, qpos, kpos,
                                        causal=True, window=W,
                                        kv_block=min(kv_block, 2 * W)))
    return torch.cat(outs, dim=1)


def attention(q, k, v, qpos, kpos, *, causal=True, window=0, pos0=0, kv_block=512):
    """Dispatcher: banded sliding-window, dense or blockwise by shape, as
    the JAX package picks. Per-row [B, S] positions (left-padded serving
    batches) take dense or blockwise, which mask per row; the banded path
    needs positions shared by the batch."""
    Sq, Skv = q.shape[1], k.shape[1]
    shared_pos = qpos.dim() == 1 and kpos.dim() == 1
    if (window and shared_pos and Sq == Skv and Sq % window == 0
            and Sq // window >= 2 and causal):
        return attention_swa_banded(q, k, v, pos0, window, kv_block=kv_block)
    if Sq * Skv <= 4096 * 1024 or Sq == 1:
        return attention_dense(q, k, v, qpos, kpos, causal=causal, window=window)
    return attention_blockwise(q, k, v, qpos, kpos, causal=causal, window=window,
                               kv_block=kv_block)


def mlp(x: torch.Tensor, p) -> torch.Tensor:
    """SiLU-gated MLP: (silu(x Wg) * (x Wu)) Wo. Over a shard of the hidden
    units (a tensor-parallel rank's), Wo's product is partial and closes
    with a sum over the mesh's `model` axis (the identity on one device);
    x enters the cut gate and up products through `enter_model`, whose
    backward sums x's gradient over that axis."""
    x = dctx.enter_model(x)
    dt = x.dtype
    g = x @ p["wi_gate"].to(dt)
    u = x @ p["wi_up"].to(dt)
    return dctx.matmul_model(F.silu(g) * u, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Mixture of experts (GShard)
# ---------------------------------------------------------------------------


def _router(x2d: torch.Tensor, p, n_experts: int, top_k: int):
    """x2d: [T, D] -> (gate_vals [T, k], gate_idx [T, k], probs [T, E], aux).

    fp32 logits and softmax, the top k renormalised, and the Switch load-
    balance loss E * sum_e f_e P_e. The top k is a stable descending sort:
    equal probabilities keep the lower expert index first, as the JAX
    package's top_k does (torch.topk promises no order among ties)."""
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    f = F.one_hot(gate_idx[:, 0], n_experts).float().mean(0)
    aux = n_experts * torch.sum(f * probs.mean(0))
    return gate_vals, gate_idx, probs, aux


def _dispatch_mask(gate_idx: torch.Tensor, gate_vals: torch.Tensor, E: int, C: int,
                   dtype: torch.dtype):
    """[g, t, K] top-k assignments -> ([g, t, E, C] 0/1 dispatch, [g, t, E]
    gate weights). A choice's capacity slot is its rank among the group's
    choices of that expert, counted over [K, t]: every token's first choice
    before any second choice, tokens in order within a choice. Choices at
    rank C or more are dropped (no slot)."""
    g_loc, t, K = gate_idx.shape
    onehot = F.one_hot(gate_idx, E).float()                  # [g, t, K, E]
    flat = onehot.transpose(1, 2).reshape(g_loc, K * t, E)
    pos = torch.cumsum(flat, dim=1) - flat
    keep = (pos < C).float() * flat
    pos = pos.reshape(g_loc, K, t, E)
    keep = keep.reshape(g_loc, K, t, E)
    slots = torch.arange(C, device=gate_idx.device)
    dispatch = torch.zeros((g_loc, t, E, C), dtype=dtype, device=gate_idx.device)
    for kk in range(K):  # a rank past C one-hots to nothing
        disp_k = (pos[:, kk].long()[..., None] == slots).to(dtype)
        dispatch = dispatch + disp_k * keep[:, kk][..., None].to(dtype)
    wte = torch.einsum("gtke,gtk->gte", onehot, gate_vals)
    return dispatch, wte


def _expert_ffn(xe: torch.Tensor, p) -> torch.Tensor:
    """xe: [G, E, C, D] dispatched token slots -> each expert's SiLU-gated
    MLP of its slots, [G, E, C, D].

    On a rank's shards (a mesh of more than one rank set) the result is this
    rank's part of that sum, which `_close_experts` completes: the experts
    the rank holds (a cut of E over `data`; the others' slots stay zero),
    over its cut of each expert's hidden units (over `model`). Weights whose
    d_model dim is cut over `data` (the serve rules' layout when the data
    axis does not divide E) are gathered whole first, in the compute dtype,
    as the JAX package's weight-gather mode gathers them."""
    dt = xe.dtype
    wg, wu, wo = p["wi_gate"].to(dt), p["wi_up"].to(dt), p["wo"].to(dt)
    E, D, el = xe.shape[1], xe.shape[3], wg.shape[0]
    if el == E:
        return _gathered_ffn(xe, wg, wu, wo, D)
    e0 = dctx.coordinate(("data",))[0] * el
    out = torch.zeros_like(xe)
    out[:, e0:e0 + el] = _gathered_ffn(xe[:, e0:e0 + el], wg, wu, wo, D)
    return out


def _gather_d(w: torch.Tensor, dim: int, D: int) -> torch.Tensor:
    """An expert leaf whose d_model dim `dim` is cut, gathered whole (the
    leaf itself when it is not cut): over `data` (the serve rules' cut), or
    over the data axes `pod` and `data` (the train rules' FSDP cut). The
    gather's backward reduce-scatters the gradient."""
    if w.shape[dim] == D:
        return w
    n_data = dctx.coordinate(("data",))[1]
    return dctx.gather(w, dim, ("data",) if w.shape[dim] * n_data == D else dctx.DP)


def _gathered_ffn(xe, wg, wu, wo, D: int) -> torch.Tensor:
    """The experts' MLP of xe [G, e, C, D] on this rank's leaves, a leaf's
    cut d_model dim gathered just before its product and freed after. xe
    enters the gate and up products, cut along the hidden units over
    `model`, through `enter_model`."""
    xe = dctx.enter_model(xe)
    g = torch.einsum("gecd,edf->gecf", xe, _gather_d(wg, 1, D))
    u = torch.einsum("gecd,edf->gecf", xe, _gather_d(wu, 1, D))
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, _gather_d(wo, 2, D))


def _close_experts(y: torch.Tensor, p, n_experts: int, own_rows: bool = False) -> torch.Tensor:
    """Sum a rank's part of the routed experts' output (`_expert_ffn`) over
    the ranks that hold the other parts: over `model` (the hidden units)
    and, when the experts are cut over `data`, over `data`. The identity
    with no mesh. own_rows: each data rank goes on with its own rows of
    the sum (the global groups of a training batch cut over the data
    axes), so the backward sums the ranks' gradients over `data`: a rank's
    experts then take the gradient of every row they served."""
    ep = p["wi_gate"].shape[0] != n_experts
    names = ("model", "data") if ep else ("model",)
    return dctx.all_reduce(y, names, grad_sum=("data",) if ep and own_rows else ())


def moe_capacity(cfg, tokens: int) -> int:
    """Slots an expert has in a dispatch group of `tokens` tokens."""
    return max(4, int(math.ceil(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)))


def moe_gshard_einsum(x: torch.Tensor, p, cfg, own_rows: bool = False):
    """GShard grouped einsum dispatch with capacity. x: [B, S, D] ->
    (y, aux loss). Tokens go in groups of min(moe_group_size, B * S); a
    choice past its expert's capacity in its group is dropped (the token's
    residual passes through). B * S must be a multiple of the group, as in
    the JAX package, which asserts it. On a mesh (the global groups of
    `moe`) the gate weights enter the combine, whose expert outputs are
    partial over `model`, through `enter_model`; own_rows: `_close_experts`'."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    group = min(cfg.moe_group_size, T)
    G = T // group
    if G * group != T:
        raise ValueError(f"{T} tokens are not a multiple of the MoE group {group}")
    xg = x.reshape(G, group, D)
    gate_vals, gate_idx, _, aux = _router(xg.reshape(T, D), p, E, K)
    C = moe_capacity(cfg, group)
    dispatch, wte = _dispatch_mask(gate_idx.reshape(G, group, K),
                                   gate_vals.reshape(G, group, K), E, C, x.dtype)
    combine = dctx.enter_model(dispatch * wte[..., None].to(x.dtype))
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    ye = _expert_ffn(xe, p)
    y = _close_experts(torch.einsum("gtec,gecd->gtd", combine, ye), p, E, own_rows)
    return y.reshape(B, S, D), aux * cfg.router_aux_weight


def moe_sort(x: torch.Tensor, p, cfg, own_rows: bool = False):
    """Sort-based dispatch: choices sorted by expert (stable), each expert's
    first C kept in equal buffers, gathered back and summed per token; no
    one-hot products. One group of all B * S tokens. On a mesh, as
    `moe_gshard_einsum`.

    A dropped choice writes zeros to the last buffer slot, as the JAX
    package's scatter does; where a kept choice of the last expert holds
    that slot, the last write in sorted order wins, as a serial scatter
    leaves it."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    x2 = x.reshape(T, D)
    gate_vals, gate_idx, _, aux = _router(x2, p, E, K)
    C = moe_capacity(cfg, T)
    flat_e = gate_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    tok_of = order // K
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    rank = torch.arange(T * K, device=x.device) - first[sorted_e]
    slot = sorted_e * C + rank
    ok = rank < C
    last = E * C - 1
    tgt = torch.where(ok, slot, torch.full_like(slot, last))
    vals = torch.where(ok[:, None], x2[tok_of], torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
    buf[tgt[ok]] = vals[ok]  # kept slots are distinct
    hits = torch.nonzero(tgt == last).flatten()
    if hits.numel():
        buf[last] = vals[hits[-1]]
    ye = _expert_ffn(buf.reshape(1, E, C, D), p).reshape(E * C, D)
    w = dctx.enter_model(gate_vals.reshape(-1)[order].to(x.dtype))
    contrib = torch.where(ok[:, None], ye[torch.clamp(slot, max=last)] * w[:, None],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add_(0, tok_of, contrib)
    y = _close_experts(y, p, E, own_rows)
    return y.reshape(B, S, D), aux * cfg.router_aux_weight


def moe_shard_map(x: torch.Tensor, p, cfg):
    """The routed experts on a rank's shards, with the collectives of the
    JAX package's `moe_shard_map` (its `shard_map` body, rank by rank).

    Token groups are local: the global batch's T tokens go in groups of
    min(moe_group_size, T / n_dp) over the data axes (`pod`, `data`; n_dp
    ranks), each data rank routing its own G / n_dp groups with capacity C
    a group, and the aux loss is the mean of the ranks' losses. So where
    tokens drop, this differs from the unsharded layer by design, as the
    JAX package's does. x is this rank's rows (`ctx.rows_cut()`) or, when
    the data axes did not divide the batch, every row, of which the rank
    routes its tokens' share and gathers the output back.

      * EP mode (E % |data| == 0): the rank holds experts [E / |data|, D,
        F / |model|]. Dispatched slots go all-to-all over `data` (E split,
        groups concatenated), each rank computes its experts, reduce-
        scatters the row-parallel `wo` product over `model` along d, sends
        its d-shard back through the all-to-all and combines it.
      * weight-gather mode (otherwise): tokens stay on their rank; the
        layer's leaves, cut over `data` along d_model, are gathered whole.

    Either way the combined [groups, t, D / |model|] output is gathered
    over `model`. Returns (y [B, S, D], aux loss).

    The backward is the `shard_map` body's transpose: the all-to-alls send
    the gradients back, the reduce-scatter's gathers them, and the dispatched
    slots and the gate weights, replicated over `model` where they enter
    the products cut over it (the hidden units; d in the combine), sum their
    gradients over `model` (`enter_model`), as the transpose of an input
    unmapped over `model` psums it."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    i_dp, n_dp = dctx.coordinate(dctx.DP)
    n_data = dctx.coordinate(("data",))[1]
    cut = dctx.rows_cut()
    T = B * S * (n_dp if cut else 1)
    tl = T // n_dp
    group = min(cfg.moe_group_size, tl)
    G = T // group
    if T % n_dp or G * group != T or G % n_dp:
        raise ValueError(f"{T} tokens do not cut into {n_dp} data ranks' groups of {group}")
    g_loc = G // n_dp
    x2 = x.reshape(-1, D)
    xl = (x2 if cut else x2[i_dp * tl:(i_dp + 1) * tl]).reshape(g_loc, group, D)
    dt = x.dtype
    gate_vals, gate_idx, _, aux = _router(xl.reshape(tl, D), p, E, K)
    C = moe_capacity(cfg, group)
    dispatch, wte = _dispatch_mask(gate_idx.reshape(g_loc, group, K),
                                   gate_vals.reshape(g_loc, group, K), E, C, dt)
    combine = dctx.enter_model(dispatch * wte[..., None].to(dt))
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xl)          # [g_loc, E, C, D]
    wg, wu, wo = p["wi_gate"].to(dt), p["wi_up"].to(dt), p["wo"].to(dt)
    if E % n_data == 0:
        xe = dctx.all_to_all_data(xe, 1, 0)                      # [G_data, E / n, C, D]
        ye = _gathered_ffn(xe, wg, wu, wo, D)
        ye = dctx.reduce_scatter_model(ye, 3)
        ye = dctx.all_to_all_data(ye, 0, 1)                      # [g_loc, E, C, D / m]
    else:
        ye = dctx.reduce_scatter_model(_gathered_ffn(xe, wg, wu, wo, D), 3)
    y = torch.einsum("gtec,gecd->gtd", combine, ye)             # [g_loc, t, D / m]
    y = dctx.gather(y, 2, ("model",)).reshape(tl, D)
    if not cut:
        y = dctx.gather(y, 0, dctx.DP)
    return y.reshape(B, S, D), dctx.pmean(aux) * cfg.router_aux_weight


def moe(x: torch.Tensor, p, cfg):
    """The MoE FFN of one layer: the routed experts plus the shared
    experts' MLP. Returns (y, aux loss).

    With no mesh (or a mesh of one rank) the routed experts are
    `cfg.moe_impl`'s: einsum or sort. On a mesh, the JAX package's rule:
    `moe_shard_map` for the einsum dispatch when the global batch's tokens
    T divide over the n_dp data ranks with at least 4 each; otherwise the
    einsum or sort dispatch over the global groups, as the JAX package runs
    it through GSPMD: the batch's rows gathered over the data axes (when
    the rank holds a cut of them), the dispatch run on every rank, each
    rank's experts computed, summed over the ranks (`_close_experts`), and
    the rank's rows kept. In training (rows cut over the data axes) each
    rank's experts then take the gradient of every row
    (`_close_experts`' own_rows), and the router loss, which every data
    rank computes over the whole batch, enters the gradient once
    (`ctx.once_over`)."""
    if dctx.mesh_size() == 1:
        impl = moe_sort if cfg.moe_impl == "sort" else moe_gshard_einsum
        y, aux = impl(x, p, cfg)
    else:
        B, S, _ = x.shape
        i_dp, n_dp = dctx.coordinate(dctx.DP)
        cut = dctx.rows_cut() and n_dp > 1
        T = B * S * (n_dp if cut else 1)
        if cfg.moe_impl == "einsum" and T % n_dp == 0 and T // n_dp >= 4:
            y, aux = moe_shard_map(x, p, cfg)
        else:
            impl = moe_sort if cfg.moe_impl == "sort" else moe_gshard_einsum
            y, aux = impl(dctx.gather(x, 0, dctx.DP) if cut else x, p, cfg, own_rows=cut)
            if cut:
                y = y.narrow(0, i_dp * B, B)
                aux = dctx.once_over(aux, dctx.DP)
    if cfg.n_shared_experts:
        y = y + mlp(x, p["shared"])
    return y, aux


# ---------------------------------------------------------------------------
# Causal depthwise conv (the mamba2 front end)
# ---------------------------------------------------------------------------


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: [B, L, C]; w: [C, k]; depthwise causal conv, k small (unrolled)."""
    k = w.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    L = x.shape[1]
    wc = w.to(x.dtype)
    y = sum(xp[:, i:i + L] * wc[None, None, :, i] for i in range(k))
    return y + b.to(x.dtype)


def conv1d_step(x1: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor):
    """x1: [B, C] new input; conv_state: [B, k-1, C] history. Returns
    (y [B, C], new_state [B, k-1, C])."""
    full = torch.cat([conv_state, x1[:, None]], dim=1)  # [B, k, C]
    y = torch.einsum("bkc,ck->bc", full, w.to(x1.dtype)) + b.to(x1.dtype)
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., T] -> [..., T, T] with out[i, j] = sum_{s=j+1..i} x[s]
    (cs[i] - cs[j] of the cumulative sum), -inf above the diagonal."""
    T = x.shape[-1]
    lower = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    return torch.where(lower, out, torch.full((), -math.inf, dtype=out.dtype,
                                              device=x.device))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked state-space-duality scan (Mamba2).

    xh: [b, l, h, p]; dt: [b, l, h] (> 0, post-softplus); A: [h] (< 0);
    Bm, Cm: [b, l, g, n]. Returns (y [b, l, h, p] in xh's dtype,
    final_state [b, h, p, n] in fp32)."""
    b, l, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    c = min(chunk, l)
    if l % c:  # pad to a chunk multiple; dt = 0 padding is state-neutral
        pad = c - l % c
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    l_orig, l = l, xh.shape[1]
    Bh = torch.repeat_interleave(Bm, rep, dim=2)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    nc = l // c

    f32 = torch.float32
    dA = (dt.to(f32) * A.to(f32)).reshape(b, nc, c, h)
    dAc = dA.permute(0, 3, 1, 2)  # [b, h, nc, c]
    A_cs = torch.cumsum(dAc, dim=-1)

    xdt = (xh.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, c, h, p)
    Bc = Bh.to(f32).reshape(b, nc, c, h, n)
    Cc = Ch.to(f32).reshape(b, nc, c, h, n)

    Lmat = torch.exp(segsum(dAc))  # [b, h, nc, c, c]
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cc, Bc, Lmat, xdt)

    decay_states = torch.exp(A_cs[..., -1:] - A_cs)  # [b, h, nc, c]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, xdt)

    chunk_decay = torch.exp(A_cs[..., -1])  # [b, h, nc]
    st = (init_state.to(f32) if init_state is not None
          else torch.zeros((b, h, p, n), dtype=f32, device=xh.device))
    prev = []
    for i in range(nc):  # the inter-chunk recurrence; emits each chunk's entry state
        prev.append(st)
        st = st * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # [b, nc, h, p, n]

    state_decay_out = torch.exp(A_cs)  # [b, h, nc, c]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, prev_states, state_decay_out)
    y = (y_diag + y_off).reshape(b, l, h, p)[:, :l_orig]
    return y.to(xh.dtype), st


def ssm_step(x1, dt1, A, B1, C1, state):
    """Single-token SSM recurrence. x1: [b, h, p]; dt1: [b, h]; B1, C1:
    [b, g, n]; state: [b, h, p, n] (fp32). Returns (y [b, h, p],
    new_state)."""
    h = x1.shape[1]
    rep = h // B1.shape[1]
    f32 = torch.float32
    Bh = torch.repeat_interleave(B1, rep, dim=1).to(f32)  # [b, h, n]
    Ch = torch.repeat_interleave(C1, rep, dim=1).to(f32)
    dA = torch.exp(dt1.to(f32) * A.to(f32))  # [b, h]
    inc = torch.einsum("bhp,bhn->bhpn", x1.to(f32) * dt1.to(f32)[..., None], Bh)
    new_state = state * dA[..., None, None] + inc
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x1.dtype), new_state


def _ssm_split(xBC: torch.Tensor, cfg):
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return xBC[..., :di], xBC[..., di:di + gn], xBC[..., di + gn:]


def _ssm_local(xBC: torch.Tensor, cfg):
    """The conv output of this rank's channels -> (x of the rank's heads,
    B, C of the groups those heads read). A tensor-parallel rank holds a
    cut of the conv_dim = d_inner + 2 * ngroups * state channels over
    `model`, which does not line up with the x | B | C split, so the
    channels are gathered whole first and x is cut again at the rank's
    heads: rank j of m holds heads [j h / m, (j + 1) h / m), whose x is
    d_inner channels [j d_inner / m, (j + 1) d_inner / m), all reading the
    one group of B and C (every arch here has one; more would need each
    rank's heads' groups). With no model axis it is `_ssm_split`."""
    j, m = dctx.model_coordinate()
    if m == 1:
        return _ssm_split(xBC, cfg)
    if cfg.ssm_ngroups != 1:
        raise NotImplementedError(f"{cfg.name}: {cfg.ssm_ngroups} SSM groups over "
                                  f"{m} model ranks")
    # each rank goes on with its own heads of the whole: the gather's
    # backward sums the ranks' gradients over `model` before the slice
    xs, Bm, Cm = _ssm_split(dctx.gather(xBC, -1, ("model",), grad_sum=("model",)), cfg)
    di = cfg.d_inner // m
    return xs[..., j * di:(j + 1) * di], Bm, Cm


def _rmsnorm_gated_ssm(y, z, w, cfg):
    """`rmsnorm_gated` over d_inner. On a tensor-parallel rank, which holds
    a cut of the d_inner channels, the sum of squares is summed over
    `model` (in fp32) before the mean and the rsqrt; every rank scales its
    own channels by it, so its backward sums over `model` too."""
    if dctx.model_coordinate()[1] == 1:
        return rmsnorm_gated(y, z, w, cfg.norm_eps)
    xf = (y * F.silu(z.to(y.dtype))).float()
    var = dctx.all_reduce((xf * xf).sum(-1, keepdim=True), ("model",),
                          grad_sum=("model",)) / cfg.d_inner
    return (xf * torch.rsqrt(var + cfg.norm_eps) * w.float()).to(y.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the JAX package computes it (logaddexp(x, 0)): no
    linear cut-off above a threshold, as F.softplus has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_block(x, p, cfg, init_state=None, return_state=False, pos_offset=None):
    """Full-sequence Mamba2 block. x: [B, L, D].

    pos_offset: [B] left-pad amounts (bucketed serving). The conv and dt
    biases make padding slots nonzero even when their inputs are zero, so
    with an offset the pad slots' dt is forced to 0 (state-neutral: dA = 1,
    zero increment) and the block output is zeroed there, keeping the
    padded rows' state and residual stream equal to unpadded execution.
    With return_state: (out, (conv_tail [B, k-1, conv_dim], final_state
    [B, h, p, n] fp32)). On a tensor-parallel rank the weights are its
    shards (in_z, norm_w over d_inner; in_xbc, conv_w, conv_b over
    conv_dim; in_dt, dt_bias, A_log, D over heads; out_proj row-parallel)
    and conv_dim, h and the state are the rank's (`_ssm_local`); x enters
    the input projections, cut over `model`, through `enter_model`."""
    B, L, D = x.shape
    dt_ = x.dtype
    x = dctx.enter_model(x)
    z = x @ p["in_z"].to(dt_)
    xbc_in = x @ p["in_xbc"].to(dt_)
    dtr = x @ p["in_dt"].to(dt_)
    xBC = F.silu(conv1d_causal(xbc_in, p["conv_w"], p["conv_b"]))
    valid = None
    if pos_offset is not None:
        valid = (torch.arange(L, device=x.device)[None, :]
                 >= pos_offset.to(device=x.device, dtype=torch.int64)[:, None])
        xBC = xBC * valid[..., None].to(xBC.dtype)
    xs, Bm, Cm = _ssm_local(xBC, cfg)
    pd, g, n = cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    h = xs.shape[-1] // pd   # the rank's heads
    dt = _softplus(dtr.float() + p["dt_bias"].float())
    if valid is not None:
        dt = torch.where(valid[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                           device=dt.device))
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B, L, h, pd)
    y, fstate = ssd_chunked(xh, dt, A, Bm.reshape(B, L, g, n), Cm.reshape(B, L, g, n),
                            cfg.ssm_chunk, init_state=init_state)
    y = y + p["D"].to(dt_)[None, None, :, None] * xh
    y = _rmsnorm_gated_ssm(y.reshape(B, L, h * pd), z, p["norm_w"], cfg)
    out = dctx.matmul_model(y, p["out_proj"].to(dt_))
    if valid is not None:
        out = out * valid[..., None].to(out.dtype)
    if return_state:
        # the decode handoff: the last k-1 pre-conv, pre-SiLU inputs (the
        # JAX package recomputes the product, which XLA merges with this one)
        return out, (xbc_in[:, -(cfg.ssm_conv - 1):, :], fstate)
    return out


def ssm_block_decode(x1, p, cfg, conv_state, state):
    """Single-token Mamba2 block. x1: [B, 1, D]; conv_state [B, k-1,
    conv_dim]; state [B, h, p, n] fp32. Returns (y [B, 1, D], (new_conv,
    new_state))."""
    B = x1.shape[0]
    dt_ = x1.dtype
    xf = x1[:, 0]
    z = xf @ p["in_z"].to(dt_)
    xBC = xf @ p["in_xbc"].to(dt_)
    dtr = xf @ p["in_dt"].to(dt_)
    xBC, new_conv = conv1d_step(xBC, conv_state, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = _ssm_local(F.silu(xBC), cfg)
    pd, g, n = cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    h = xs.shape[-1] // pd   # the rank's heads
    dt = _softplus(dtr.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, new_state = ssm_step(xs.reshape(B, h, pd), dt, A, Bm.reshape(B, g, n),
                            Cm.reshape(B, g, n), state)
    y = y + p["D"].to(dt_)[None, :, None] * xs.reshape(B, h, pd)
    y = _rmsnorm_gated_ssm(y.reshape(B, h * pd), z, p["norm_w"], cfg)
    out = dctx.matmul_model(y, p["out_proj"].to(dt_))
    return out[:, None], (new_conv, new_state)
