"""The LM of every family: the training forward and its chunked loss
(`train_loss`, each layer recomputed in the backward pass when `cfg.remat`
is set), prefill, decode (every self- and cross-attention step through the
flash-decode kernel), run-to-completion generate, chunked prefill, and the
slot pool of continuous batching.

Plain functions over a parameter tree laid out as the JAX package lays it
out (`models/params.py`): the unstacked leading layers under
``params["prefix"]["l{i}"]`` and the rest under ``params["body"]["l{j}"]``,
each leaf stacked over the blocks of `params.block_period` layers; GQA heads
factored as [kv_heads, q_per_kv, head_dim] (``wq [d, kh, g, hd]``,
``wk``/``wv [d, kh, hd]``, ``wo [kh, g, hd, d]`` a layer). Each layer is a
(mixer, ffn) pair of its kind (`cfg.layer_kinds()`): attention + MLP for
the dense family (and the decoders of whisper and phi-3-vision), attention
+ MLP or MoE for the MoE family, a Mamba2 SSM block and no FFN for the SSM
family, and for the hybrid (jamba) one attention layer and seven SSM
layers a block of 8, MoE on every other one. An encoder-decoder (whisper)
runs its encoder over `audio_frames` first (`encode_audio`) and gives every
decoder layer a cross-attention sublayer between the mixer and the ffn; a
vision-language model (phi-3-vision) takes `img_embeds` in place of its
first `n_img_tokens` token embeddings. Caches mirror the tree: an
attention layer's ``["mixer"]["k"|"v"]`` is ``[B, ring, kh, hd]`` (with a
leading block axis under ``body``); an SSM layer's ``["conv"]`` is ``[B,
k-1, conv_dim]`` (the last k-1 pre-conv inputs, in the activation dtype)
and ``["state"]`` ``[B, h, p, n]`` (fp32 whatever the activation dtype); a
cross-attention layer's ``["xattn"]["ck"|"cv"]`` is ``[B, n_audio_ctx,
kh, hd]``, written by prefill and only read by decode. A ring is
``min(sliding_window, cache_len)`` slots (`ring_len`).

Where the JAX functions return a new cache, these update the cache (the
slot pool) in place and return it — the same values, without a copy of the
pool per step.

KV slot pool. The pool is one fixed-shape cache ``[max_slots, ring]``
shared by all in-flight requests; requests join by having their prefill
cache scattered into a row slot and leave by being ignored (stale rows are
masked, overwritten on slot reuse). A single scalar clock is the shared
padded write position: a request admitted at clock P with true prompt length
n gets pos_offset = P - n, and each row's cache is TRUE-POSITION indexed —
its prompt KV lands on ring slots 0..n-1, and every decode step writes row
b's slot (clock - pos_offset[b]) mod ring — so the decode step never changes
shape as requests come and go, and a row's KV layout is the layout of an
isolated per-request cache no matter WHEN it joined.

Tensor parallel. Under a mesh (`core/steps.sharded_prefill`/`sharded_decode`
set it) the same functions run on one rank's shards: its KV heads and
their query heads, its MLP hidden units, its rows of the vocab, its Mamba2
conv channels and heads (an SSM layer's conv and state cache rows hold
those, written in place by decode), and its experts (over `data`) or its
cut of every expert's d_model (over `data`) and hidden units (over
`model`). The products that contract over a shard (the attention output,
the MLP's and the SSM block's output products, the experts) and the
vocab-sharded embedding and logits close through `distributed/ctx.py`;
with no mesh those calls return their input. Under the small-serve layout
(models under 1B parameters) the attention weights are whole on every rank
instead, and each attention cache is cut along its sequence where the
`model` axis divides it (`dctx.seq_cut`): rank r holds slots [r L, (r + 1)
L). Prefill computes the whole K/V and keeps the rank's cut; decode writes
a slot on the rank that owns it, runs the kernel over the rank's cut with
its log-sum-exp and merges the ranks' partial outputs
(`dctx.merge_seq_shards`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import ctx as dctx
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.params import block_period, cache_specs, ring_len, tree_map

Tree = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree: Tree, i: int) -> Tree:
    """Block i's view of a block-stacked subtree (views, no copies)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _layers(cfg: ModelConfig, tree: Tree) -> List[Tree]:
    """Every layer's subtree of a parameter or cache tree, in layer order:
    the prefix layers, then each body block's layers. Body layers are views
    into the stacked leaves, so a cache written through them is written in
    place."""
    p, npre = block_period(cfg), cfg.first_k_dense
    out = [tree["prefix"][f"l{i}"] for i in range(npre)]
    body = tree["body"]
    for j in range((cfg.n_layers - npre) // p):
        out.extend(_layer(body[f"l{li}"], j) for li in range(p))
    return out


def _assemble(cfg: ModelConfig, entries: List[Tree]) -> Tree:
    """Per-layer cache entries (layer order) -> the cache tree: prefix
    layers as they are, body layers stacked over the blocks."""
    p, npre = block_period(cfg), cfg.first_k_dense
    tree: Tree = {}
    if npre:
        tree["prefix"] = {f"l{i}": entries[i] for i in range(npre)}
    body = entries[npre:]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items)

    tree["body"] = {f"l{li}": stack(body[li::p]) for li in range(p)}
    return tree


def _kv_leaves(cache: Tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K and V leaves of a stack of attention layers with no prefix
    (the families that chunk their prefill: one body block)."""
    m = cache["body"]["l0"]["mixer"]
    return m["k"], m["v"]


def _heads_cut(w: torch.Tensor, cfg: ModelConfig, kv_dim: int) -> bool:
    """Whether an attention weight holds a cut of its heads over `model`:
    of its KV heads (dim kv_dim; the serve configs' padded ones) or of
    head_dim (the last dim of wq/wk/wv, dim kv_dim + 2 of wo: the train
    rules' 2-D case)."""
    hd_dim = -1 if kv_dim == 1 else kv_dim + 2
    return w.shape[kv_dim] != cfg.n_kv_heads or w.shape[hd_dim] != cfg.hd


def _qkv(x: torch.Tensor, p: Tree, kv_x: Optional[torch.Tensor] = None,
         cfg: Optional[ModelConfig] = None):
    """x: [B, S, D] -> q [B, S, kh, g, hd], k/v [B, Skv, kh, hd], the keys
    and values from kv_x [B, Skv, D] (cross-attention) or from x. With
    `cfg`, where the weights hold a cut of the heads over `model`, the
    inputs enter those products through `ctx.enter_model`."""
    B, S, D = x.shape
    dt = x.dtype
    wq = p["wq"].to(dt)
    kh, g, hd = wq.shape[1:]
    if cfg is not None and _heads_cut(wq, cfg, 1):
        x = dctx.enter_model(x)
        kv_x = None if kv_x is None else dctx.enter_model(kv_x)
    src = x if kv_x is None else kv_x
    q = (x @ wq.reshape(D, -1)).view(B, S, kh, g, hd)
    k = (src @ p["wk"].to(dt).reshape(D, -1)).view(B, src.shape[1], kh, hd)
    v = (src @ p["wv"].to(dt).reshape(D, -1)).view(B, src.shape[1], kh, hd)
    return q, k, v


def _out(o: torch.Tensor, wo: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """o: [B, S, kh, g, hd] -> [B, S, D]. Over a shard of the heads (a
    tensor-parallel rank's), the product is partial and closes with a sum
    over the mesh's `model` axis (the identity on one device); with every
    KV head on the rank (the small-serve layout's whole weights) it is the
    whole product."""
    B, S = o.shape[:2]
    w = wo.to(o.dtype)
    a, w = o.reshape(B, S, -1), w.reshape(-1, w.shape[-1])
    return dctx.matmul_model(a, w) if _heads_cut(wo, cfg, 0) else a @ w


def _seq_local(cache: Tree) -> Tree:
    """A cache entry of whole K/V [B, n, kh, hd] leaves -> this rank's cut
    along the sequence where the small-serve layout cuts it (`dctx.seq_cut`),
    a copy of its own; the entry itself where it is whole."""
    out = {}
    for name, t in cache.items():
        cut = dctx.seq_cut(t.shape[1])
        out[name] = t if cut is None else t.narrow(1, *cut).contiguous()
    return out


def _embed(params: Tree, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings [..., D] in the activation dtype. Over a vocab shard
    (a tensor-parallel rank holds rows [r n, (r + 1) n) of the table), a
    masked local lookup, then the sum over the `model` axis, which is exact:
    one rank holds each row and the others add zeros. A table whose d_model
    dim the train rules cut over the data axes is gathered first."""
    table, dt = dctx.gather_fsdp(params["embed"], 1, cfg.d_model), _dtype(cfg)
    n = table.shape[0]
    if n == cfg.padded_vocab:
        return table[tokens].to(dt)
    rank, size = dctx.model_coordinate()
    if n * size != cfg.padded_vocab:
        raise ValueError(f"embedding shard of {n} rows on a model axis of {size}: the "
                         f"table has {cfg.padded_vocab} (set the mesh with "
                         "distributed.ctx.mesh_context)")
    local = tokens - rank * n
    hit = (local >= 0) & (local < n)
    x = table[torch.where(hit, local, torch.zeros_like(local))].to(dt)
    return dctx.all_reduce_model(x * hit[..., None].to(dt))


def _rope4(q: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on [B, S, KH, G, D] (factored GQA heads)."""
    b, s, kh, g, d = q.shape
    return L.apply_rope(q.reshape(b, s, kh * g, d), pos, theta).reshape(b, s, kh, g, d)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _attn_layout(q, k, v, cfg: ModelConfig):
    """q [B, S, kh, g, hd] and k, v [B, S, kh, hd] in the layout attention
    computes on, and the function that takes its output back to the
    weights' layout for `wo`. Under the serve layouts and on one device,
    the weights' own: each rank's heads (or all of them), whole head_dim.
    Under the train rules a rank may hold a cut of head_dim instead, which
    RoPE (it rotates dim i with i + hd / 2) and the scores cannot take: with
    `cfg.attn_dp_axes` set, q, k and v go to rows cut over `model` with
    every head whole (`layers.constrain_batch_dp`, before RoPE as in the
    JAX package, for a KV-head cut too); without it (a microbatch too
    small to fill the mesh), head_dim is gathered over `model`, every
    `model` rank attends the same rows, and keeps its slice of the
    output."""
    hd_cut = q.shape[-1] != cfg.hd
    if cfg.attn_dp_axes and "model" in cfg.attn_dp_axes and (
            hd_cut or q.shape[2] != cfg.n_kv_heads):
        dim, rows = (-1 if hd_cut else 2), q.shape[0]
        q, k, v = (L.constrain_batch_dp(t, cfg.attn_dp_axes, dim) for t in (q, k, v))
        return q, k, v, lambda o: L.constrain_batch_dp(o, cfg.attn_dp_axes, dim, rows)
    if hd_cut:
        q, k, v = (dctx.gather(t, -1, ("model",)) for t in (q, k, v))
        return q, k, v, lambda o: dctx.split_model(o, -1)
    return q, k, v, lambda o: o


def _attn_forward(x, p, cfg: ModelConfig, *, cache_len: int = 0, pos_offset=None,
                  causal: bool = True, window: int = 0, make_cache: bool = True):
    """Self-attention sublayer over a full sequence: causal (with the window
    mask when `window` is set) for a decoder, emitting its cache; not
    causal and without a cache for whisper's encoder (RoPE at positions
    0..S-1 all the same).

    pos_offset: [B] left-pad amounts for ragged serving batches — row b's
    token at padded index j has true position j - pos_offset[b]; negative
    positions are padding, masked out of attention. With pos_offset the
    keys and values are shifted to the canonical TRUE-POSITION layout (axis
    column t holds the roped key/value at true position t, columns past the
    true length are zero and masked), the same layout the slot pool stores,
    and the shifted tensors double as the emitted cache. A window ring
    shorter than the prompt keeps the last ring keys at slots pos % ring,
    and refuses pos_offset, as the JAX package does.
    Returns (out [B, S, D], {"k", "v"} [B, ring, kh, hd] or None)."""
    B, S, _ = x.shape
    q, k, v, back = _attn_layout(*_qkv(x, p, cfg=cfg), cfg)
    s_idx = torch.arange(S, device=x.device)
    qpos = s_idx
    if pos_offset is not None:
        off = pos_offset.to(device=x.device, dtype=torch.int64)[:, None]
        qpos = s_idx[None, :] - off
    kpos = qpos
    q = _rope4(q, qpos, cfg.rope_theta)
    k = L.apply_rope(k, qpos, cfg.rope_theta)
    if pos_offset is not None:
        gi = s_idx[None, :] + off
        keep = (gi < S)[..., None, None]
        gidx = torch.clamp(gi, max=S - 1)[..., None, None].expand(-1, -1, *k.shape[2:])
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        k = torch.where(keep, torch.gather(k, 1, gidx), zero)
        v = torch.where(keep, torch.gather(v, 1, gidx), zero)
        kpos = torch.where(gi < S, s_idx[None, :], torch.full_like(gi, -1))
    b, kh, g, hd = q.shape[0], *q.shape[2:]
    o = L.attention(q.reshape(b, S, kh * g, hd), k, v, qpos, kpos,
                    causal=causal, window=window)
    out = _out(back(o.reshape(b, S, kh, g, hd)), p["wo"], cfg)
    if not make_cache:
        return out, None
    wc = ring_len(cfg, cache_len)
    if wc >= S:
        # decode headroom: slots S..wc-1 stay empty (masked until decode writes)
        cache = {"k": F.pad(k, (0, 0, 0, 0, 0, wc - S)),
                 "v": F.pad(v, (0, 0, 0, 0, 0, wc - S))}
        return out, _seq_local(cache)
    if pos_offset is not None:
        raise ValueError("pos_offset with a sliding-window ring smaller than the "
                         "padded prompt is unsupported (size the ring to cover the "
                         "prompt bucket)")
    # a window ring shorter than the prompt keeps its last wc keys, position
    # t at slot t % wc: the layout decode continues
    slots = torch.arange(S - wc, S, device=x.device) % wc
    cache = {}
    for name, t in (("k", k), ("v", v)):
        c = torch.zeros((B, wc) + t.shape[2:], dtype=t.dtype, device=t.device)
        c[:, slots] = t[:, S - wc:]
        cache[name] = c
    return out, _seq_local(cache)


def _xattn_forward(x, p, enc: torch.Tensor, cfg: ModelConfig, *, pos_offset=None):
    """Cross-attention sublayer over the encoder output enc [B, Sa, D]: no
    RoPE on either side and no causal mask, so every query sees every
    encoder position; a left-pad query (negative true position) is fully
    masked and emits 0. Returns (out [B, S, D], {"ck", "cv"} [B, Sa, kh,
    hd]) or this rank's cut of them along the sequence, the keys and values
    every decode step attends."""
    S = x.shape[1]
    q, k, v = _qkv(x, p, enc, cfg=cfg)
    # the cache keeps the weights' layout; attention runs on the train
    # rules' layout (`_attn_layout`), as self-attention does
    cache = {"ck": k, "cv": v}
    q, k, v, back = _attn_layout(q, k, v, cfg)
    qpos = torch.arange(S, device=x.device)
    if pos_offset is not None:
        qpos = qpos[None, :] - pos_offset.to(device=x.device, dtype=torch.int64)[:, None]
    kpos = torch.arange(k.shape[1], device=x.device)
    b, kh, g, hd = q.shape[0], *q.shape[2:]
    o = L.attention(q.reshape(b, S, kh * g, hd), k, v, qpos, kpos, causal=False, window=0)
    return _out(back(o.reshape(b, S, kh, g, hd)), p["wo"], cfg), _seq_local(cache)


def _enc_block(x, bp: Tree, cfg: ModelConfig) -> torch.Tensor:
    """One encoder block: its FSDP-cut weights gathered (`_fsdp_layer`),
    the non-causal self-attention, the MLP."""
    bp = _fsdp_layer(bp, cfg, ("attn", "mlp"))
    h = L.rmsnorm(x, bp["mixer"]["ln"], cfg.norm_eps)
    o, _ = _attn_forward(h, bp["mixer"], cfg, causal=False, make_cache=False)
    x = x + o
    h = L.rmsnorm(x, bp["ffn"]["ln"], cfg.norm_eps)
    return x + L.mlp(h, bp["ffn"])


def encode_audio(params: Tree, audio_frames: Optional[torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """whisper's encoder over audio_frames [B, n_audio_ctx, d_model] (stub
    frame embeddings, after the conv front end): per layer a non-causal
    self-attention roped at positions 0..n_audio_ctx-1 and an MLP, then a
    final RMSNorm. Returns [B, n_audio_ctx, d_model] in the activation
    dtype. Each block gathers its FSDP-cut weights as a decoder layer does.
    No block is recomputed in the backward pass (the JAX package's encoder
    scan has no remat)."""
    if audio_frames is None:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its prefill needs audio_frames "
            f"[B, {cfg.n_audio_ctx}, {cfg.d_model}] (LM.prefill(..., audio_frames=))")
    enc = params["encoder"]
    x = audio_frames.to(device=enc["ln"].device, dtype=_dtype(cfg))
    for i in range(cfg.enc_layers):
        x = _enc_block(x, _layer(enc["blocks"], i), cfg)
    return L.rmsnorm(x, enc["ln"], cfg.norm_eps)


def _mixer_forward(h, p, cfg: ModelConfig, mixer: str, *, cache_len: int,
                   pos_offset=None, make_cache: bool = True):
    """One layer's mixer over a full prompt: (out [B, S, D], cache entry,
    or None without make_cache)."""
    if mixer == "attn":
        return _attn_forward(h, p, cfg, cache_len=cache_len, pos_offset=pos_offset,
                             window=cfg.sliding_window, make_cache=make_cache)
    if not make_cache:
        return L.ssm_block(h, p, cfg, pos_offset=pos_offset), None
    o, (conv_tail, fstate) = L.ssm_block(h, p, cfg, return_state=True,
                                         pos_offset=pos_offset)
    return o, {"conv": conv_tail, "state": fstate}


def _ffn(x, sub: Tree, cfg: ModelConfig, ffn: str):
    """The layer's FFN with its residual: the MLP, the MoE experts or none
    (SSM). Returns (x, the MoE router's aux loss or None); serving drops the
    aux loss, training sums it."""
    if ffn == "none":
        return x, None
    h = L.rmsnorm(x, sub["ffn"]["ln"], cfg.norm_eps)
    if ffn == "moe":
        y, aux = L.moe(h, sub["ffn"], cfg)
        return x + y, aux
    return x + L.mlp(h, sub["ffn"]), None


# the d_model dim of each weight of a sublayer kind that carries one (the
# train rules' `embed`): attention (self and cross), MLP, the Mamba2 block,
# and the MoE's router and shared experts (the routed experts' d_model cut,
# `expert_embed`, is gathered per product: `layers._gather_d`)
_ATTN_D = {"wq": 0, "wk": 0, "wv": 0, "wo": -1}
_MLP_D = {"wi_gate": 0, "wi_up": 0, "wo": -1}
_D_DIM = {"attn": _ATTN_D, "mlp": _MLP_D, "moe": {"router": 0, "shared": _MLP_D},
          "ssm": {"in_z": 0, "in_xbc": 0, "in_dt": 0, "out_proj": -1}}


def _gathered(tree: Tree, dims: Dict[str, Any], cfg: ModelConfig) -> Tree:
    return {k: (w if k not in dims else _gathered(w, dims[k], cfg) if isinstance(w, dict)
                else dctx.gather_fsdp(w, dims[k], cfg.d_model))
            for k, w in tree.items()}


def _fsdp_layer(sub: Tree, cfg: ModelConfig, kind: Tuple[str, str]) -> Tree:
    """The layer's weights whole along d_model: those the train rules cut
    over the data axes (FSDP) are gathered here, inside the layer, so that
    under remat the gathered copies live only while the layer runs and are
    gathered again in its recomputation (`ctx.gather_fsdp`); the others,
    every weight on one device and under the serve rules, are the layer's
    own."""
    if dctx.coordinate(dctx.DP)[1] == 1:
        return sub
    out = dict(sub)
    for name, k in (("mixer", kind[0]), ("xattn", "attn"), ("ffn", kind[1])):
        if name in sub and k in _D_DIM:
            out[name] = _gathered(sub[name], _D_DIM[k], cfg)
    return out


def _sublayer(x, sub: Tree, enc, cfg: ModelConfig, kind: Tuple[str, str], *,
              train: bool, cache_len: int, pos_offset):
    """One layer over a full sequence: its mixer, the cross-attention
    sublayer of an encoder-decoder, and its FFN. Returns (x, the MoE aux
    loss or None, cache entry); training builds no cache (entry None)."""
    mixer, ffn = kind
    sub = _fsdp_layer(sub, cfg, kind)
    h = L.rmsnorm(x, sub["mixer"]["ln"], cfg.norm_eps)
    o, c = _mixer_forward(h, sub["mixer"], cfg, mixer, cache_len=cache_len,
                          pos_offset=pos_offset, make_cache=not train)
    x = x + o
    entry = None if train else {"mixer": c}
    if enc is not None:
        h = L.rmsnorm(x, sub["xattn"]["ln"], cfg.norm_eps)
        o, c = _xattn_forward(h, sub["xattn"], enc, cfg, pos_offset=pos_offset)
        x = x + o
        if entry is not None:
            entry["xattn"] = c
    x, aux = _ffn(x, sub, cfg, ffn)
    return x, aux, entry


def _train_layers(x, aux, subs, kinds, enc, cfg: ModelConfig, kw):
    """Training's layers. Between the body's blocks the carry holds this
    rank's rows cut over every axis of `cfg.attn_dp_axes`
    (`layers.constrain_batch_dp`, the JAX package's constraint of its scan
    carry, `lm.py` `block_fn`): a block gathers its rows over `model`
    first and cuts them again last. With `cfg.remat`, remat nests as the
    JAX package nests it: the prefix layers (`first_k_dense`) are not
    recomputed; each block runs under a checkpoint, so its saved input is
    the cut carry, and where a block holds several layers (jamba's 8) each
    layer under one more, so the backward recomputes the block for each
    layer's input and each layer again for its own backward. Returns (x
    whole over `model`, aux)."""
    npre, period = cfg.first_k_dense, block_period(cfg)
    inner = cfg.remat and period > 1
    # the carry's axes; none where `model` is 1 wide (the rows are cut already)
    axes = cfg.attn_dp_axes if dctx.model_coordinate()[1] > 1 else ()

    def add(aux, a):
        return aux if a is None else aux + a.float()

    def block(xc, aux, j, rows):
        x = L.constrain_batch_dp(xc, axes, None, rows)
        for i in range(npre + j * period, npre + (j + 1) * period):
            x, a, _ = (checkpoint(_sublayer, x, subs[i], enc, cfg, kinds[i], **kw,
                                  use_reentrant=False) if inner
                       else _sublayer(x, subs[i], enc, cfg, kinds[i], **kw))
            aux = add(aux, a)
        return L.constrain_batch_dp(x, axes, None), aux

    for i in range(npre):
        x, a, _ = _sublayer(x, subs[i], enc, cfg, kinds[i], **kw)
        aux = add(aux, a)
    rows = x.shape[0]
    x = L.constrain_batch_dp(x, axes, None)
    for j in range((len(subs) - npre) // period):
        x, aux = (checkpoint(block, x, aux, j, rows, use_reentrant=False) if cfg.remat
                  else block(x, aux, j, rows))
    return L.constrain_batch_dp(x, axes, None, rows), aux


def forward(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, *,
            mode: str = "prefill", cache_len: int = 0, pos_offset=None,
            img_embeds=None, audio_frames=None):
    """mode "prefill": (final hidden [B, S, D], cache tree); mode "train":
    (final hidden [B, S, D], aux), aux the fp32 sum of every MoE layer's
    router loss (0 without MoE), and no cache. In training the carry
    between blocks is cut to rows over `cfg.attn_dp_axes`, and with
    `cfg.remat` each body block runs under `torch.utils.checkpoint`: the
    backward pass keeps only the blocks' cut inputs and recomputes the rest
    (the JAX package's per-sublayer and per-block `jax.checkpoint`,
    `_train_layers`).

    pos_offset: optional [B] left-pad amounts (bucketed serving): row b's
    first pos_offset[b] token slots are padding. Their embeddings are zeroed
    and they are masked out of attention and SSM state, so each row
    computes what it would at its true length.
    img_embeds: [B, n_img_tokens, D] patch embeddings that replace the
    first n_img_tokens token embeddings (a vlm); refused with pos_offset,
    whose left-pad mask would zero them, as the JAX package refuses it.
    audio_frames: [B, n_audio_ctx, D], the encoder's input (an
    encoder-decoder needs it)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', not {mode!r}")
    if pos_offset is not None and cfg.n_img_tokens and img_embeds is not None:
        raise ValueError(
            "pos_offset (left-padded bucketing) is not supported with image "
            "prefixes: the left-pad mask would zero the leading img_embeds "
            "slots. Pad such batches on the right by length bucket instead.")
    train = mode == "train"
    dt = _dtype(cfg)
    x = _embed(params, tokens, cfg)
    if cfg.n_img_tokens and img_embeds is not None:
        x = torch.cat([img_embeds.to(device=x.device, dtype=dt),
                       x[:, cfg.n_img_tokens:]], dim=1)
    if pos_offset is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 >= pos_offset.to(x.device)[:, None])
        x = x * valid[..., None].to(dt)
    enc = encode_audio(params, audio_frames, cfg) if cfg.enc_layers else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
    kinds, subs = cfg.layer_kinds(), _layers(cfg, params)
    kw = dict(train=train, cache_len=cache_len, pos_offset=pos_offset)
    entries = []
    if train:
        x, aux = _train_layers(x, aux, subs, kinds, enc, cfg, kw)
    else:
        for kind, sub in zip(kinds, subs):
            x, _, entry = _sublayer(x, sub, enc, cfg, kind, **kw)
            entries.append(entry)
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    if train:
        return x, aux
    return x, _assemble(cfg, entries)


def _local_logits(params: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits of this rank's columns of the padded vocab [..., n]:
    products of the activation-dtype inputs accumulated in fp32 (the JAX
    package's preferred_element_type=f32). Over a vocab shard x enters the
    cut product through `ctx.enter_model`; a weight whose d_model dim the
    train rules cut over the data axes is gathered. Raises for a vocab
    shard with no mesh of as many `model` ranks set."""
    w = (dctx.gather_fsdp(params["embed"], 1, cfg.d_model).t() if cfg.tie_embeddings
         else dctx.gather_fsdp(params["lm_head"], 0, cfg.d_model))
    n = w.shape[-1]
    if n != cfg.padded_vocab:
        if n * dctx.model_coordinate()[1] != cfg.padded_vocab:
            raise ValueError(f"vocab shard of {n} columns with no mesh of "
                             f"{cfg.padded_vocab // n} model ranks set")
        x = dctx.enter_model(x)
    return x.float() @ w.to(x.dtype).float()


def logits_from_hidden(params: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits [..., vocab] (`_local_logits`). Over a vocab shard the
    local columns are gathered along the vocab over the `model` axis, and
    the padded vocab is stripped after: serving picks a token from whole
    rows. The loss does not gather them (`_xent_chunk`)."""
    logits = _local_logits(params, x, cfg)
    if logits.shape[-1] != cfg.padded_vocab:
        logits = dctx.gather_model_last(logits)
    return logits[..., : cfg.vocab]  # strip the padded vocab slots


def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, *,
            img_embeds=None, audio_frames=None, pos_offset=None,
            cache_len: Optional[int] = None):
    """Full-sequence prefill. Returns (last-position logits [B, 1, V], cache).
    cache_len: KV slots to allocate (defaults to the prompt length);
    img_embeds, audio_frames: see `forward`."""
    x, cache = forward(params, tokens, cfg,
                       cache_len=tokens.shape[1] if cache_len is None else cache_len,
                       pos_offset=pos_offset, img_embeds=img_embeds,
                       audio_frames=audio_frames)
    return logits_from_hidden(params, x[:, -1:], cfg), cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, valid_len: torch.Tensor,
            seq) -> torch.Tensor:
    """One launch of the flash-decode kernel over this rank's K/V: the whole
    cache, or (seq = (offset, length) of its cut along the sequence, and
    valid_len the rank's own valid prefix of it) the cut, with each row's
    log-sum-exp, merged with the other ranks' cuts."""
    if seq is None:
        return ops.decode_attention(q, ck, cv, valid_len)
    o, lse = ops.decode_attention(q, ck, cv, valid_len, return_lse=True)
    return dctx.merge_seq_shards(o, lse)


def _attn_decode(x, p, cfg: ModelConfig, ck: torch.Tensor, cv: torch.Tensor,
                 pos: int, pos_offset, valid_len: torch.Tensor, *, ring: Optional[int] = None,
                 seq=None) -> torch.Tensor:
    """Single-token attention. x: [B, 1, D]; ck/cv: this layer's ring
    buffers [B, ring, kh, hd], written in place; or, under the small-serve
    layout, this rank's cut of them, seq = (offset, length) of it in a ring
    of `ring` slots: a slot is written by the rank that holds it, and
    valid_len (the whole ring's) becomes the cut's own, clamp(valid_len -
    offset, 0, length).

    `pos` is the scalar *padded* write position; with pos_offset [B] the
    cache is TRUE-POSITION indexed per row: row b's step writes ring slot
    (pos - offset_b) mod ring, so slot t always holds the row's token at
    true position t, exactly like an unpadded per-request cache.

    The attention itself is one launch of the flash-decode kernel
    (kernels.ops.decode_attention) over the prefix-valid layout. Slot t of
    a row at true position qpos holds the most recent write at or below
    qpos congruent to t (mod ring): a row's own writes come in position
    order, and by pool sizing its live span never exceeds the ring unless
    the ring is a sliding window's. The JAX package keeps slot t when that
    position, qpos - (qpos - t) mod ring, is not negative, with no window
    mask (the ring is at most the window, so every such key is within it):
    that is t < min(qpos + 1, ring), the kernel's `pos < valid_len` with
    valid_len = min(qpos + 1, ring), which `decode` computes once per step.
    Before the ring is full it is the causal prefix; once full, every slot
    holds one of the last `ring` positions."""
    B = x.shape[0]
    q, k1, v1 = _qkv(x, p)
    wc = ck.shape[1] if ring is None else ring
    off0, n = (0, wc) if seq is None else seq
    if pos_offset is None:
        qpos = torch.tensor([pos], device=x.device)
    else:
        off = pos_offset.to(device=x.device, dtype=torch.int64)
        qpos = (pos - off)[:, None]                            # [B, 1] true positions
    q = _rope4(q, qpos, cfg.rope_theta)
    k1 = L.apply_rope(k1, qpos, cfg.rope_theta).to(ck.dtype)
    v1 = v1.to(cv.dtype)
    if pos_offset is None:
        slot = pos % wc - off0
        if 0 <= slot < n:   # this rank holds the slot
            ck[:, slot] = k1[:, 0]
            cv[:, slot] = v1[:, 0]
    else:
        # per-row slot write as a dense select, written back in place
        widx = torch.remainder(pos - off, wc)
        slots = torch.arange(off0, off0 + n, device=x.device)
        hit = (slots[None, :] == widx[:, None])[:, :, None, None]
        ck.copy_(torch.where(hit, k1, ck))
        cv.copy_(torch.where(hit, v1, cv))
    if seq is not None:
        valid_len = torch.clamp(valid_len - off0, 0, n).to(torch.int32)
    kh, g, hd = q.shape[2:]
    o = _attend(q.reshape(B, kh * g, hd), ck, cv, valid_len, seq)
    return _out(o.reshape(B, 1, kh, g, hd), p["wo"], cfg)


def _xattn_decode(x, p, cfg: ModelConfig, ck: torch.Tensor, cv: torch.Tensor,
                  valid_len: torch.Tensor, seq=None) -> torch.Tensor:
    """Single-token cross-attention over the encoder keys and values ck/cv
    [B, n_audio_ctx, kh, hd], read only: the JAX package attends every
    encoder position with no mask and no RoPE, which is the flash-decode
    kernel's `pos < valid_len` with valid_len = n_audio_ctx on every
    row. Under the small-serve layout ck/cv are this rank's cut, seq =
    (offset, length), every slot of it valid (valid_len = length)."""
    B, _, D = x.shape
    wq = p["wq"].to(x.dtype)
    kh, g, hd = wq.shape[1:]
    q = (x @ wq.reshape(D, -1)).view(B, kh * g, hd)
    o = _attend(q, ck, cv, valid_len, seq)
    return _out(o.reshape(B, 1, kh, g, hd), p["wo"], cfg)


def _seq_of(local: int, n: int):
    """The small-serve cut, (offset, length), of a cache of n slots whose
    leaf on this rank holds `local` (None: whole); raises where the leaf is
    neither the whole cache nor the rank's cut of it."""
    seq = dctx.seq_cut(n)
    if local != (n if seq is None else seq[1]):
        raise ValueError(f"a cache leaf of {local} slots on this rank is not the "
                         f"{'whole' if seq is None else 'cut'} cache of {n} slots the "
                         f"layout gives it (pass the global ring: sharded_decode's "
                         f"cache_len)")
    return seq


def decode(params: Tree, cache: Tree, tokens: torch.Tensor, pos: int,
           cfg: ModelConfig, *, pos_offset=None, ring: Optional[int] = None):
    """One decode step. tokens: [B, 1]; pos: the padded write position;
    pos_offset: optional [B] (row b's true position is pos - pos_offset[b]).
    Returns (logits [B, 1, V], cache) — the cache updated in place. An SSM
    layer reads neither position: its step advances each row's conv tail
    and state. A cross-attention sublayer reads its encoder keys and
    values and writes nothing. ring: the self-attention rings' slots, which
    the small-serve layout needs when it may cut them along the sequence
    (a rank's leaves then hold ring / m); by default the leaves' own."""
    x = _embed(params, tokens, cfg)
    B = x.shape[0]
    kinds = cfg.layer_kinds()
    caches = _layers(cfg, cache)
    valid_len = xvalid = seq = xseq = None
    attn = [c["mixer"] for (m, _), c in zip(kinds, caches) if m == "attn"]
    if attn:
        local = attn[0]["k"].shape[1]
        if ring is None and dctx.seq_cut_active():
            raise ValueError("the small-serve layout's decode needs the global ring "
                             "(sharded_decode's cache_len)")
        wc = local if ring is None else ring
        seq = _seq_of(local, wc)
        if pos_offset is None:
            qpos = torch.full((B,), pos, dtype=torch.int64, device=x.device)
        else:
            qpos = pos - pos_offset.to(device=x.device, dtype=torch.int64)
        valid_len = torch.clamp(qpos + 1, 0, wc).to(torch.int32)  # the ring's valid prefix
    if cfg.enc_layers:  # every encoder position (of the rank's cut), every row
        xseq = _seq_of(caches[0]["xattn"]["ck"].shape[1], cfg.n_audio_ctx)
        xvalid = torch.full((B,), caches[0]["xattn"]["ck"].shape[1], dtype=torch.int32,
                            device=x.device)
    for (mixer, ffn), sub, c in zip(kinds, _layers(cfg, params), caches):
        m = c["mixer"]
        h = L.rmsnorm(x, sub["mixer"]["ln"], cfg.norm_eps)
        if mixer == "attn":
            o = _attn_decode(h, sub["mixer"], cfg, m["k"], m["v"], pos, pos_offset,
                             valid_len, ring=wc, seq=seq)
        else:
            o, (conv, state) = L.ssm_block_decode(h, sub["mixer"], cfg, m["conv"],
                                                  m["state"])
            m["conv"].copy_(conv)
            m["state"].copy_(state)
        x = x + o
        if "xattn" in sub:
            h = L.rmsnorm(x, sub["xattn"]["ln"], cfg.norm_eps)
            x = x + _xattn_decode(h, sub["xattn"], cfg, c["xattn"]["ck"], c["xattn"]["cv"],
                                  xvalid, xseq)
        x, _ = _ffn(x, sub, cfg, ffn)
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return logits_from_hidden(params, x, cfg), cache


def generate(params: Tree, cache: Tree, last_logits: torch.Tensor, pos0: int,
             cfg: ModelConfig, *, steps: int, pos_offset=None):
    """Greedy-decode `steps` tokens after a prefill (the run-to-completion
    batch): argmax(last_logits), then steps - 1 decode steps from the padded
    write position pos0 (the padded prompt length). Returns (tokens
    [B, steps], cache); the tokens are those of the sequential decode()
    loop."""
    tok0 = torch.argmax(last_logits, -1)
    if steps == 1:
        return tok0, cache
    rest, cache = decode_segment(params, cache, tok0, pos0, cfg, steps=steps - 1,
                                 pos_offset=pos_offset)
    return torch.cat([tok0, rest], dim=1), cache


def decode_segment(params: Tree, cache: Tree, tok: torch.Tensor, pos0: int,
                   cfg: ModelConfig, *, steps: int, pos_offset=None):
    """Greedy-decode `steps` tokens starting *after* the last emitted token
    `tok` [B, 1] (the continuous-batching segment). pos0: the shared padded
    write position of the first step (the slot-pool clock). Returns
    (tokens [B, steps], cache); chaining segments equals one longer segment
    or the sequential decode() loop."""
    toks = []
    pos = int(pos0)
    for _ in range(steps):
        logits, cache = decode(params, cache, tok, pos, cfg, pos_offset=pos_offset)
        tok = torch.argmax(logits, -1)
        toks.append(tok)
        pos += 1
    return torch.cat(toks, dim=1), cache


# ---------------------------------------------------------------------------
# KV slot pool (continuous batching)
# ---------------------------------------------------------------------------


def alloc_slot_pool(cfg: ModelConfig, max_slots: int, cache_len: int,
                    device: torch.device) -> Tree:
    """Zero-initialized slot-pool cache tree, laid out as a prefill cache
    (`params.cache_defs`): per attention layer K/V rings [max_slots, ring,
    kh, hd]; per SSM layer the conv tail [max_slots, k-1, conv_dim] in the
    activation dtype and the state [max_slots, h, p, n] in fp32; per
    cross-attention sublayer the encoder K/V [max_slots, n_audio_ctx, kh,
    hd]; body leaves with a leading block axis."""
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=device),
                    cache_specs(cfg, max_slots, cache_len))


def _scatter_rows(pool: Tree, pre: Tree, keep: torch.Tensor, rows: torch.Tensor,
                  lp: int, stacked: bool) -> None:
    """Copy the kept rows of a prefill-cache subtree into pool rows `rows`,
    in place (body leaves carry a leading block axis)."""
    for name, pl in pool.items():
        q = pre[name]
        if isinstance(pl, dict):
            _scatter_rows(pl, q, keep, rows, lp, stacked)
            continue
        q = (q[:, keep] if stacked else q[keep]).to(pl.dtype)
        if name in ("k", "v"):
            ring_q, ring_p = q.shape[2 if stacked else 1], pl.shape[2 if stacked else 1]
            if ring_q != lp or lp > ring_p:
                raise ValueError(
                    f"slot-pool admission needs the prefill ring to hold the whole "
                    f"padded prompt (sliding_window 0 or >= the bucket): prefill "
                    f"ring {ring_q}, pool ring {ring_p}, prompt bucket {lp}")
            if stacked:
                pl[:, rows, :lp] = q
            else:
                pl[rows, :lp] = q
        elif stacked:
            pl[:, rows] = q
        else:
            pl[rows] = q


def scatter_into_slots(pool: Tree, prefill_cache: Tree, slot_ids: torch.Tensor,
                       clock: int, lp: int) -> Tree:
    """Admit a prefilled batch into pool row slots, in place: prefill-cache
    row i lands in pool slot slot_ids[i]; rows whose slot id is out of range
    (admission padding) are dropped. K/V land at ring slots 0..lp-1 (the
    prefill cache is already true-position indexed, and its ring must hold
    the whole bucket); an SSM conv tail or state is a plain row copy, so
    every admission overwrites the whole row and a reused slot inherits
    nothing; so is a cross-attention layer's encoder K/V. The clock does
    not enter: placement is true-position indexed."""
    del clock
    any_leaf = next(iter(pool["body"]["l0"]["mixer"].values()))
    slot_ids = slot_ids.to(any_leaf.device)
    keep = slot_ids < any_leaf.shape[1]
    rows = slot_ids[keep]
    if "prefix" in pool:
        _scatter_rows(pool["prefix"], prefill_cache["prefix"], keep, rows, lp, False)
    _scatter_rows(pool["body"], prefill_cache["body"], keep, rows, lp, True)
    return pool


def prefill_into_slots(params: Tree, tokens: torch.Tensor, pool: Tree,
                       slot_ids: torch.Tensor, clock: int, cfg: ModelConfig, *,
                       pos_offset=None):
    """Fused admission: prefill a left-padded (batch, lp) prompt bucket and
    scatter its cache (K/V, or SSM conv tail and state) into slot-pool rows. Returns (first greedy tokens [B, 1],
    pool). The caller sets each admitted slot's pos_offset to
    clock - true_prompt_len so decode positions continue from the prompt."""
    lp = tokens.shape[1]
    logits, pcache = prefill(params, tokens, cfg, pos_offset=pos_offset, cache_len=lp)
    pool = scatter_into_slots(pool, pcache, slot_ids, clock, lp)
    return torch.argmax(logits, -1), pool


def scatter_prefix_into_slots(pool: Tree, prefix_cache: Tree, slot_ids: torch.Tensor,
                              lp: int) -> Tree:
    """Admit CACHED prefix K/V (radix prefix-store hits) into pool rows, in
    place. prefix_cache is shaped like a prefill cache for bucket lp
    ([L, B, lp, kh, hd]); its rows carry a stored prefix at true positions
    [0, m) and zeros after. The engine resumes chunked prefill at the row's
    column off + m, so the suffix chunks overwrite [m, n) and everything
    past n stays masked. Rows whose slot id is out of range are dropped."""
    return scatter_into_slots(pool, prefix_cache, slot_ids, 0, lp)


# ---------------------------------------------------------------------------
# Chunked prefill (continuous batching without long-prompt head-of-line)
#
# A prompt bucket's KV construction split into fixed-length column chunks:
# each chunk runs the model over C padded prompt positions, writes their K/V
# at TRUE-POSITION ring slots of the pool (the layout of _attn_decode and
# scatter_into_slots) and attends the chunk's queries over the ring PREFIX
# [0, lp) (lp = the padded prompt bucket). The engine interleaves decode
# segments between chunks. The read presents the pool rows as the
# monolithic prefill presents its keys (column t = true position t, over an
# axis of length lp), so a chunked admission computes what a monolithic one
# does.
# ---------------------------------------------------------------------------


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill serves pure attention+MLP decoder stacks with no
    sliding window and no non-token context, as in the JAX package: a ring
    smaller than the prompt cannot hold the chunk history, an MoE layer's
    expert capacity counts the whole prefill's tokens, so chunking would
    change which tokens drop, an SSM has no chunk-resume path, and an
    encoder's output or an image prefix precedes the prompt. The others
    admit monolithically."""
    return (cfg.enc_layers == 0 and cfg.sliding_window == 0 and cfg.n_img_tokens == 0
            and all(m == "attn" and f == "mlp" for m, f in cfg.layer_kinds()))


def _attn_chunk(x, p, cfg: ModelConfig, ck: torch.Tensor, cv: torch.Tensor,
                qpos: torch.Tensor, valid: torch.Tensor, lp: int) -> torch.Tensor:
    """Multi-token cache-extending attention for one prefill chunk.

    x: [B, C, D]; ck/cv: this layer's pool rows [B, ring, kh, hd], written
    in place; qpos: [B, C] TRUE positions (negative = left-pad, or a row
    that is not part of this admission); valid = qpos >= 0. Writes the
    chunk's K/V at ring slots qpos (valid columns only), then attends over
    the prefix [0, lp): column t is valid up to the row's last query of this
    chunk, stale or future columns are masked."""
    B, C, _ = x.shape
    q, k1, v1 = _qkv(x, p)
    q = _rope4(q, qpos, cfg.rope_theta)
    k1 = L.apply_rope(k1, qpos, cfg.rope_theta)
    rows, cols = torch.nonzero(valid, as_tuple=True)
    slots = qpos[rows, cols]
    ck[rows, slots] = k1[rows, cols].to(ck.dtype)
    cv[rows, slots] = v1[rows, cols].to(cv.dtype)
    lp_idx = torch.arange(lp, device=x.device)
    kpos = torch.where(lp_idx[None, :] <= qpos[:, -1:], lp_idx[None, :],
                       torch.full((), -1, dtype=lp_idx.dtype, device=x.device))
    kh, g, hd = q.shape[2:]
    o = L.attention_dense(q.reshape(B, C, kh * g, hd), ck[:, :lp], cv[:, :lp],
                          qpos, kpos, causal=True, window=0)
    return _out(o.reshape(B, C, kh, g, hd), p["wo"], cfg)


def prefill_chunk_into_slots(params: Tree, tokens: torch.Tensor, pool: Tree,
                             start: torch.Tensor, cfg: ModelConfig, *,
                             pos_offset: torch.Tensor, lp: int):
    """Run ONE chunk of a left-padded prompt bucket and extend the slot
    pool's KV in place.

    tokens: [max_slots, C] — row b IS pool row b; its columns are padded
    prompt positions start[b] .. start[b] + C - 1 (start is per row, so one
    call advances every in-flight admission of this (C, lp) class).
    pos_offset: [max_slots] left-pad amounts; rows not in any admission of
    the class carry the sentinel lp with start 0, which makes every column's
    true position negative: embeddings zeroed, K/V writes dropped, attention
    fully masked.

    Returns (greedy next token [B, 1] from the LAST column's logits —
    meaningful only for rows on their bucket's final chunk — and the pool)."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"chunked prefill unsupported for {cfg.name} "
                         "(see lm.supports_chunked_prefill)")
    dt = _dtype(cfg)
    dev = tokens.device
    C = tokens.shape[1]
    off = pos_offset.to(device=dev, dtype=torch.int64)
    qpos = (start.to(device=dev, dtype=torch.int64)[:, None]
            + torch.arange(C, device=dev)[None, :]) - off[:, None]
    valid = qpos >= 0
    x = _embed(params, tokens, cfg) * valid[..., None].to(dt)
    for sub, c in zip(_layers(cfg, params), _layers(cfg, pool)):
        h = L.rmsnorm(x, sub["mixer"]["ln"], cfg.norm_eps)
        x = x + _attn_chunk(h, sub["mixer"], cfg, c["mixer"]["k"], c["mixer"]["v"],
                            qpos, valid, lp)
        h = L.rmsnorm(x, sub["ffn"]["ln"], cfg.norm_eps)
        x = x + L.mlp(h, sub["ffn"])
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = logits_from_hidden(params, x[:, -1:], cfg)
    return torch.argmax(logits, -1), pool


# ---------------------------------------------------------------------------
# Loss (chunked over the sequence to bound the logits' memory)
# ---------------------------------------------------------------------------


def _xent_chunk(params: Tree, xc: torch.Tensor, lc: torch.Tensor, cfg: ModelConfig):
    """One chunk's (sum of nll, sum of lse^2, count) over its labelled
    positions: fp32 logits [B, c, V], labels < 0 ignored. Over a vocab
    shard each `model` rank keeps its columns of the logits: the lse and
    the gold logit come from all-reduces of row sums (`ctx.vocab_xent`),
    never a gather of the logits."""
    logits = _local_logits(params, xc, cfg)
    n = logits.shape[-1]
    if n == cfg.padded_vocab:
        logits = logits[..., : cfg.vocab]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(lc, min=0).long()[..., None])[..., 0]
    else:
        lse, gold = dctx.vocab_xent(logits, lc, dctx.model_coordinate()[0] * n, cfg.vocab)
    mask = (lc >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(lse * lse * mask), torch.sum(mask)


def softmax_xent_chunked(params: Tree, x: torch.Tensor, labels: torch.Tensor,
                         cfg: ModelConfig, chunk: int = 2048):
    """x: [B, S, D] final hidden; labels [B, S] (-100 = ignore). Mean
    cross-entropy and mean squared log-partition (the z-loss term) over the
    labelled positions, computed over sequence chunks of c = min(chunk, S),
    lowered until it divides S, as the JAX package chunks them. With more
    than one chunk each is checkpointed: its fp32 logits [B, c, V] are
    recomputed in the backward pass, never kept. A single chunk keeps them,
    as the JAX package's compiled step does (XLA merges a one-trip loop's
    recomputation with its forward). Returns (nll, z2), fp32 scalars. On a mesh
    whose data axes cut the rows, the means are over the global batch: the
    sums and the count of labelled positions are all-reduced over those
    axes (not the mean of the ranks' means, which differs where their
    label masks do)."""
    B, S, _ = x.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    nll_sum, z_sum, count = (torch.zeros((), dtype=torch.float32, device=x.device)
                             for _ in range(3))
    labels = labels.to(x.device)
    for i in range(0, S, c):
        args = (params, x[:, i:i + c], labels[:, i:i + c], cfg)
        n, z, k = _xent_chunk(*args) if c == S else checkpoint(_xent_chunk, *args,
                                                                use_reentrant=False)
        nll_sum, z_sum, count = nll_sum + n, z_sum + z, count + k
    if dctx.rows_cut() and dctx.coordinate(dctx.DP)[1] > 1:
        # rows cut over the data axes: the global batch's sums, one all-reduce
        nll_sum, z_sum, count = dctx.all_reduce(torch.stack([nll_sum, z_sum, count]),
                                                dctx.DP).unbind()
    count = torch.clamp(count, min=1.0)
    return nll_sum / count, z_sum / count


def train_loss(params: Tree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               z_loss_weight: float = 1e-4):
    """The training objective of a batch {"tokens", "labels"} (plus
    "img_embeds" or "audio_frames" where the family takes them): the mean
    token cross-entropy, z_loss_weight times the z-loss term, and the MoE
    router losses. Returns (loss, {"loss", "nll", "aux"}), fp32 scalars."""
    x, aux = forward(params, batch["tokens"], cfg, mode="train",
                     img_embeds=batch.get("img_embeds"),
                     audio_frames=batch.get("audio_frames"))
    nll, z2 = softmax_xent_chunked(params, x, batch["labels"], cfg)
    loss = nll + z_loss_weight * z2 + aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}
