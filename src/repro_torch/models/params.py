"""The dense family's weights: their layout, a seeded init, and the bridge
from the JAX package's parameter tree.

The tree is the JAX package's (`lm.model_defs` there), leaf by leaf:
``embed [padded_vocab, d]``, ``final_ln [d]``, ``lm_head [d, padded_vocab]``
and, layer-stacked under ``body.l0``, ``mixer.{ln, wq, wk, wv, wo}`` and
``ffn.{ln, wi_gate, wi_up, wo}``. Same paths and shapes on both sides is
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
    init: str = "normal"  # normal | ones
    scale: float = 0.02


def model_defs(cfg: ModelConfig) -> Tree:
    """Shapes and init scales of every leaf (the JAX package's model_defs
    for the dense family)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} not served yet")
    d, kh, hd, nl = cfg.d_model, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    g = cfg.n_heads // kh
    out_scale = 0.02 / math.sqrt(2 * nl)
    defs: Tree = {
        "embed": ParamDef((cfg.padded_vocab, d)),
        "final_ln": ParamDef((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.padded_vocab))
    defs["body"] = {"l0": {
        "mixer": {
            "ln": ParamDef((nl, d), "ones"),
            "wq": ParamDef((nl, d, kh, g, hd)),
            "wk": ParamDef((nl, d, kh, hd)),
            "wv": ParamDef((nl, d, kh, hd)),
            "wo": ParamDef((nl, kh, g, hd, d), scale=out_scale),
        },
        "ffn": {
            "ln": ParamDef((nl, d), "ones"),
            "wi_gate": ParamDef((nl, d, cfg.d_ff)),
            "wi_up": ParamDef((nl, d, cfg.d_ff)),
            "wo": ParamDef((nl, cfg.d_ff, d), scale=out_scale),
        },
    }}
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


def _set(tree: Tree, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                dtype="float32") -> Tree:
    """Seeded weights with the JAX package's shapes and init scales:
    normal(0, 1) * scale, RMSNorm gains at one. Leaves are drawn in sorted
    path order from `generator`, which must live on `device`. Torch's
    generator is not JAX's, so the values differ from the reference's; a
    comparison carries the reference's own weights with `from_reference`."""
    dt = _dtype(dtype)
    out: Tree = {}
    for path, pd in leaves(model_defs(cfg)):
        if pd.init == "ones":
            t = torch.ones(pd.shape, dtype=dt, device=device)
        else:
            t = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                            device=device).mul_(pd.scale).to(dt)
        _set(out, path, t)
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
