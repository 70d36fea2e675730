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
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

Tree = Dict[str, Any]


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | dt_bias | a_log
    scale: float = 0.02
    expert: bool = False  # a routed expert's leaf (active_param_count)


def _attn_defs(cfg: ModelConfig) -> Tree:
    d, kh, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kh
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((d,), "ones"),
        "wq": ParamDef((d, kh, g, hd)),
        "wk": ParamDef((d, kh, hd)),
        "wv": ParamDef((d, kh, hd)),
        "wo": ParamDef((kh, g, hd, d), scale=out_scale),
    }


def _mlp_defs(cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((d,), "ones"),
        "wi_gate": ParamDef((d, cfg.d_ff)),
        "wi_up": ParamDef((d, cfg.d_ff)),
        "wo": ParamDef((cfg.d_ff, d), scale=out_scale),
    }


def _moe_defs(cfg: ModelConfig) -> Tree:
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    defs: Tree = {
        "ln": ParamDef((d,), "ones"),
        "router": ParamDef((d, e)),
        "wi_gate": ParamDef((e, d, f), expert=True),
        "wi_up": ParamDef((e, d, f), expert=True),
        "wo": ParamDef((e, f, d), scale=out_scale, expert=True),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        defs["shared"] = {
            "wi_gate": ParamDef((d, fs)),
            "wi_up": ParamDef((d, fs)),
            "wo": ParamDef((fs, d), scale=out_scale),
        }
    return defs


def _ssm_defs(cfg: ModelConfig) -> Tree:
    d = cfg.d_model
    di, cd, h = cfg.d_inner, cfg.conv_dim, cfg.n_ssm_heads
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((d,), "ones"),
        "in_z": ParamDef((d, di)),
        "in_xbc": ParamDef((d, cd)),
        "in_dt": ParamDef((d, h)),
        "conv_w": ParamDef((cd, cfg.ssm_conv), scale=0.1),
        "conv_b": ParamDef((cd,), "zeros"),
        "dt_bias": ParamDef((h,), "dt_bias"),
        "A_log": ParamDef((h,), "a_log"),
        "D": ParamDef((h,), "ones"),
        "norm_w": ParamDef((di,), "ones"),
        "out_proj": ParamDef((di, d), scale=out_scale),
    }


def _stack(tree: Tree, n: int) -> Tree:
    return {k: (_stack(v, n) if isinstance(v, dict)
                else ParamDef((n,) + v.shape, v.init, v.scale, v.expert))
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
        "embed": ParamDef((cfg.padded_vocab, d)),
        "final_ln": ParamDef((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.padded_vocab))
    if npre:
        defs["prefix"] = {f"l{i}": _sublayer_defs(cfg, kinds[i]) for i in range(npre)}
    block = {f"l{i}": _sublayer_defs(cfg, k) for i, k in enumerate(body_kinds[:p])}
    defs["body"] = _stack(block, len(body_kinds) // p)
    if cfg.enc_layers:
        defs["encoder"] = {
            "blocks": _stack({"mixer": _attn_defs(cfg), "ffn": _mlp_defs(cfg)},
                             cfg.enc_layers),
            "ln": ParamDef((d,), "ones"),
        }
    return defs


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
    dt = _dtype(dtype)
    out: Tree = {}
    for path, pd in leaves(model_defs(cfg)):
        _set(out, path, _draw(pd, generator, device).to(dt))
    return out


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
