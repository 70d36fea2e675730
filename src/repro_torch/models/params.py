"""The weights of every family: their layout, a seeded init, and the
bridge from the JAX package's parameter tree.

The tree is the JAX package's (`lm.model_defs` there), leaf by leaf:
``embed [padded_vocab, d]``, ``final_ln [d]``, ``lm_head [d, padded_vocab]``
(absent with tied embeddings), the unstacked leading layers under
``prefix.l{i}`` (moonshot's `first_k_dense` dense layer) and the rest under
``body.l{j}``, each leaf stacked over the blocks of `block_period(cfg)`
layers (1 for the dense and SSM families, the MoE stride for mixtral's and
moonshot's every-layer MoE, 8 for jamba: one attention layer and seven SSM
layers, MoE on every other one). A layer is the mixer and the ffn of its
kind: ``mixer.{ln, wq, wk, wv, wo}`` for attention, ``mixer.{ln, in_z,
in_xbc, in_dt, conv_w, conv_b, dt_bias, A_log, D, norm_w, out_proj}`` for
the SSM (no ffn in the SSM family), ``ffn.{ln, wi_gate, wi_up, wo}`` for
the MLP, and for MoE ``ffn.{ln, router [d, E], wi_gate/wi_up [E, d, f],
wo [E, f, d]}`` plus ``ffn.shared.{wi_gate, wi_up, wo}`` with shared
experts. An encoder-decoder (whisper) adds to every decoder layer the
cross-attention ``xattn.{ln, wq, wk, wv, wo}`` and the encoder
``encoder.blocks.{mixer, ffn}`` (attention and MLP, stacked over
`enc_layers`) and ``encoder.ln``. Same paths and shapes on both sides is
what lets `from_reference` carry weights across by path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

Tree = Dict[str, Any]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # a logical axis a dim (distributed/sharding.py)
    init: str = "normal"  # normal | zeros | ones | dt_bias | a_log
    scale: float = 0.02
    expert: bool = False  # a routed expert's leaf (active_param_count)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _attn_defs(cfg: ModelConfig) -> Tree:
    d, kh, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kh
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((d,), (None,), "ones"),
        "wq": ParamDef((d, kh, g, hd), ("embed", "kv_heads", None, "head_dim")),
        "wk": ParamDef((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((kh, g, hd, d), ("kv_heads", None, "head_dim", "embed"),
                       scale=out_scale),
    }


def _mlp_defs(cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((d,), (None,), "ones"),
        "wi_gate": ParamDef((d, cfg.d_ff), ("embed", "mlp")),
        "wi_up": ParamDef((d, cfg.d_ff), ("embed", "mlp")),
        "wo": ParamDef((cfg.d_ff, d), ("mlp", "embed"), scale=out_scale),
    }


def _moe_defs(cfg: ModelConfig) -> Tree:
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    defs: Tree = {
        "ln": ParamDef((d,), (None,), "ones"),
        "router": ParamDef((d, e), ("embed", None)),
        "wi_gate": ParamDef((e, d, f), ("expert", "expert_embed", "expert_mlp"), expert=True),
        "wi_up": ParamDef((e, d, f), ("expert", "expert_embed", "expert_mlp"), expert=True),
        "wo": ParamDef((e, f, d), ("expert", "expert_mlp", "expert_embed"), scale=out_scale,
                       expert=True),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        defs["shared"] = {
            "wi_gate": ParamDef((d, fs), ("embed", "mlp")),
            "wi_up": ParamDef((d, fs), ("embed", "mlp")),
            "wo": ParamDef((fs, d), ("mlp", "embed"), scale=out_scale),
        }
    return defs


def _ssm_defs(cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    di, cd, h = cfg.d_inner, cfg.conv_dim, cfg.n_ssm_heads
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((d,), (None,), "ones"),
        "in_z": ParamDef((d, di), ("embed", "ssm_inner")),
        "in_xbc": ParamDef((d, cd), ("embed", "ssm_conv")),
        "in_dt": ParamDef((d, h), ("embed", "ssm_heads")),
        "conv_w": ParamDef((cd, cfg.ssm_conv), ("ssm_conv", None), scale=0.1),
        "conv_b": ParamDef((cd,), ("ssm_conv",), "zeros"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), "dt_bias"),
        "A_log": ParamDef((h,), ("ssm_heads",), "a_log"),
        "D": ParamDef((h,), ("ssm_heads",), "ones"),
        "norm_w": ParamDef((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed"), scale=out_scale),
    }


def _stack(tree: Tree, n: int) -> Tree:
    return {k: (_stack(v, n) if isinstance(v, dict)
                else ParamDef((n,) + v.shape, ("layers",) + v.axes, v.init, v.scale,
                              v.expert))
            for k, v in tree.items()}


def block_period(cfg: ModelConfig) -> int:
    """Layers a stacked body block holds: the period of the layer-kind
    pattern past the prefix, the lcm of the hybrid's attention stride and
    the MoE stride."""
    p = cfg.attn_every if cfg.family == "hybrid" and cfg.attn_every else 1
    if cfg.n_experts and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    return p


def _sublayer_defs(cfg: ModelConfig, kind: Tuple[str, str]) -> Tree:
    mixer, ffn = kind
    sub: Tree = {"mixer": _attn_defs(cfg) if mixer == "attn" else _ssm_defs(cfg)}
    if cfg.enc_layers:
        sub["xattn"] = _attn_defs(cfg)
    if ffn == "mlp":
        sub["ffn"] = _mlp_defs(cfg)
    elif ffn == "moe":
        sub["ffn"] = _moe_defs(cfg)
    return sub


def model_defs(cfg: ModelConfig) -> Tree:
    """Shapes and init kinds of every leaf (the JAX package's model_defs):
    the `first_k_dense` prefix layers unstacked, then one stacked block of
    `block_period` layers, and an encoder-decoder's encoder."""
    kinds = cfg.layer_kinds()
    p, npre = block_period(cfg), cfg.first_k_dense
    body_kinds = kinds[npre:]
    if len(body_kinds) % p:
        raise ValueError(f"{cfg.name}: {len(body_kinds)} body layers are not "
                         f"a multiple of the block period {p}")
    d = cfg.d_model
    defs: Tree = {
        "embed": ParamDef((cfg.padded_vocab, d), ("vocab", "embed")),
        "final_ln": ParamDef((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.padded_vocab), ("embed", "vocab"))
    if npre:
        defs["prefix"] = {f"l{i}": _sublayer_defs(cfg, kinds[i]) for i in range(npre)}
    block = {f"l{i}": _sublayer_defs(cfg, k) for i, k in enumerate(body_kinds[:p])}
    defs["body"] = _stack(block, len(body_kinds) // p)
    if cfg.enc_layers:
        defs["encoder"] = {
            "blocks": _stack({"mixer": _attn_defs(cfg), "ffn": _mlp_defs(cfg)},
                             cfg.enc_layers),
            "ln": ParamDef((d,), (None,), "ones"),
        }
    return defs


def param_axes(cfg: ModelConfig) -> Tree:
    """Every leaf's logical axes (the JAX package's `param_axes`): a name
    a dim, or None for a dim no rule shards."""
    return tree_map(lambda pd: pd.axes, model_defs(cfg))


def param_specs(cfg: ModelConfig, dtype=None) -> Tree:
    """Every leaf's shape and type as a tensor on the meta device (nothing
    is allocated), in `dtype` or cfg.param_dtype."""
    dt = _dtype(dtype or cfg.param_dtype)
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=dt, device="meta"),
                    model_defs(cfg))


def ring_len(cfg: ModelConfig, cache_len: int) -> int:
    """KV slots an attention layer keeps: the window, if one is shorter."""
    return min(cfg.sliding_window, cache_len) if cfg.sliding_window else cache_len


@dataclass(frozen=True)
class CacheDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str


def _sublayer_cache_defs(cfg: ModelConfig, mixer: str, batch: int, cache_len: int) -> Tree:
    kv = ("batch", "seq", "kv_heads", "head_dim")
    kh, hd = cfg.n_kv_heads, cfg.hd
    if mixer == "attn":
        ring = ring_len(cfg, cache_len)
        sub: Tree = {"mixer": {n: CacheDef((batch, ring, kh, hd), kv, cfg.dtype)
                               for n in ("k", "v")}}
    else:
        sub = {"mixer": {
            "conv": CacheDef((batch, cfg.ssm_conv - 1, cfg.conv_dim),
                             ("batch", None, "ssm_conv"), cfg.dtype),
            "state": CacheDef((batch, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                              ("batch", "ssm_heads", None, None), "float32"),
        }}
    if cfg.enc_layers:
        sub["xattn"] = {n: CacheDef((batch, cfg.n_audio_ctx, kh, hd), kv, cfg.dtype)
                        for n in ("ck", "cv")}
    return sub


def cache_defs(cfg: ModelConfig, batch: int, cache_len: int) -> Tree:
    """The cache tree of `batch` rows and `cache_len` slots (the JAX
    package's `cache_defs`): per attention layer the K/V rings [batch, ring,
    kh, hd], per SSM layer the conv tail [batch, k-1, conv_dim] in the
    activation dtype and the state [batch, h, p, n] in fp32, per
    cross-attention sublayer the encoder K/V [batch, n_audio_ctx, kh, hd];
    the prefix layers unstacked, the body's stacked over the blocks. A
    prefill cache and the slot pool both have this layout."""
    kinds = cfg.layer_kinds()
    p, npre = block_period(cfg), cfg.first_k_dense
    defs: Tree = {}
    if npre:
        defs["prefix"] = {f"l{i}": _sublayer_cache_defs(cfg, kinds[i][0], batch, cache_len)
                          for i in range(npre)}
    block = {f"l{i}": _sublayer_cache_defs(cfg, kinds[npre + i][0], batch, cache_len)
             for i in range(p)}
    nb = (len(kinds) - npre) // p
    defs["body"] = tree_map(lambda cd: CacheDef((nb,) + cd.shape, ("layers",) + cd.axes,
                                                cd.dtype), block)
    return defs


def cache_axes(cfg: ModelConfig, batch: int, cache_len: int) -> Tree:
    return tree_map(lambda cd: cd.axes, cache_defs(cfg, batch, cache_len))


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Tree:
    """The cache tree's shapes and types as meta tensors."""
    return tree_map(lambda cd: torch.empty(cd.shape, dtype=_dtype(cd.dtype), device="meta"),
                    cache_defs(cfg, batch, cache_len))


def leaves(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) pairs in sorted path order."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from leaves(v, path)
        else:
            yield path, v


def tree_map(fn, *trees: Mapping[str, Any]) -> Tree:
    """fn over the leaves of one or more trees of nested dicts that share
    one structure, called in sorted path order (the order of `leaves`); a
    new tree of that structure."""
    return {k: (tree_map(fn, *(t[k] for t in trees)) if isinstance(trees[0][k], Mapping)
                else fn(*(t[k] for t in trees)))
            for k in sorted(trees[0])}


def unflatten(tree: Mapping[str, Any], values) -> Tree:
    """`values`, given in leaf order (sorted paths), placed into tree's
    structure."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def _set(tree: Tree, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _draw(pd: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    """One leaf in fp32, by its init kind (the JAX package's formulas)."""
    if pd.init == "zeros":
        return torch.zeros(pd.shape, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, device=device)
    if pd.init == "normal":
        return torch.randn(pd.shape, generator=generator, device=device).mul_(pd.scale)
    u = torch.rand(pd.shape, generator=generator, device=device)
    if pd.init == "dt_bias":
        # dt log-uniform in [1e-3, 1e-1], stored as softplus^-1(dt)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        return dt + torch.log(-torch.expm1(-dt))
    if pd.init == "a_log":
        return torch.log(1.0 + 15.0 * u)  # A = -exp(A_log), |A| uniform in [1, 16)
    raise ValueError(f"unknown init {pd.init!r}")


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                dtype="float32") -> Tree:
    """Seeded weights with the JAX package's shapes and init rules:
    normal(0, 1) * scale, zeros and ones where it has them, and its dt_bias
    and A_log draws. Leaves are drawn in sorted path order from
    `generator`, which must live on `device`, each in fp32 and cast to
    `dtype` before the next is drawn: the peak is the tree in `dtype` and
    one leaf in fp32 (jamba's 8-layer block is ~26.5 GB in bf16, its
    largest leaf 3.8 GB in fp32). Torch's generator is not
    JAX's, so the values differ from the reference's; a comparison carries
    the reference's own weights with `from_reference`."""
    out: Tree = {}
    for path, leaf in iter_params(cfg, generator, device, dtype):
        _set(out, path, leaf)
    return out


def iter_params(cfg: ModelConfig, generator: torch.Generator, device,
                dtype="float32") -> Iterator[Tuple[str, torch.Tensor]]:
    """`init_params` one leaf at a time: (path, leaf) in sorted path order,
    each leaf drawn when asked for, with the same bits. A consumer that
    keeps only part of each leaf (`core.steps.shard_params`) never holds
    the whole tree."""
    dt = _dtype(dtype)
    for path, pd in leaves(model_defs(cfg)):
        yield path, _draw(pd, generator, device).to(dt)


def from_reference(tree: Mapping[str, Any], cfg: ModelConfig, device,
                   dtype="float32") -> Tree:
    """The JAX package's parameter tree, as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, api.init_params(...))``), carried across
    leaf by leaf and by path. Every leaf must be present with its expected
    shape, and nothing else."""
    dt = _dtype(dtype)
    defs = dict(leaves(model_defs(cfg)))
    got = dict(leaves(tree))
    missing, extra = sorted(set(defs) - set(got)), sorted(set(got) - set(defs))
    if missing or extra:
        raise ValueError(f"reference tree mismatch: missing {missing}, extra {extra}")
    out: Tree = {}
    for path, pd in defs.items():
        a = np.asarray(got[path])
        if tuple(a.shape) != pd.shape:
            raise ValueError(f"{path}: shape {a.shape} != expected {pd.shape}")
        _set(out, path, torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dt))
    return out
