"""Head padding for tensor-parallel serving.

`configs.serve_config(cfg, tp)` re-factors the attention heads as
[kv_eff = tp, g_eff = ceil(g / rep)] when n_kv_heads < tp. This module
carries a trained (true-shape) weight tree into that padded layout: each KV
head is repeated `rep` times, the q and o head slots are zero-padded, so the
padded wo rows are zero and every output is the unpadded model's. Each
leaf pads on its own (`padded_leaves`), so a stream of leaves is padded as
it comes, without the whole tree in one place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, serve_config
from repro_torch.models.params import leaves, model_defs

Tree = Dict[str, Any]


_ATTN = {"wq", "wk", "wv", "wo"}


def _pad_fns(cfg: ModelConfig, scfg: ModelConfig) -> Dict[str, Callable]:
    """The padding of each attention leaf, by its name."""
    kh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    rep = scfg.n_kv_heads // kh
    g_e = scfg.n_heads // scfg.n_kv_heads
    pad_g = rep * g_e - g

    def pad_q(w):  # [*, kh, g, hd] -> [*, kh*rep, g_e, hd]
        return F.pad(w, (0, 0, 0, pad_g)).reshape(*w.shape[:-3], kh * rep, g_e, hd)

    def pad_o(w):  # [*, kh, g, hd, d] -> [*, kh*rep, g_e, hd, d]
        return (F.pad(w, (0, 0, 0, 0, 0, pad_g))
                .reshape(*w.shape[:-4], kh * rep, g_e, hd, w.shape[-1]))

    def rep_kv(w):  # [*, kh, hd] -> [*, kh*rep, hd]
        return torch.repeat_interleave(w, rep, dim=-2)

    return {"wq": pad_q, "wk": rep_kv, "wv": rep_kv, "wo": pad_o}


def _attn_parents(tree: Tree, prefix: str = "") -> set:
    """Paths of the subtrees that hold wq, wk, wv and wo."""
    out = {prefix} if set(tree) >= _ATTN else set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _attn_parents(v, f"{prefix}.{k}" if prefix else k)
    return out


def padded_leaves(items: Iterable[Tuple[str, Any]], cfg: ModelConfig,
                  tp: int) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a true-shape weight tree of `cfg`, each leaf as
    `serve_config(cfg, tp)` lays it out: an attention leaf padded (a new
    tensor), every other leaf as it came. Consumes `items` lazily."""
    scfg = serve_config(cfg, tp)
    if scfg.n_kv_heads == cfg.n_kv_heads:
        yield from items
        return
    fns, parents = _pad_fns(cfg, scfg), _attn_parents(model_defs(cfg))
    for path, w in items:
        parent, _, name = path.rpartition(".")
        yield path, fns[name](w) if parent in parents and name in fns else w
        del w   # before the next leaf is drawn


def pad_params_for_serve(params: Tree, cfg: ModelConfig, tp: int) -> Tuple[ModelConfig, Tree]:
    """(serve config, padded weight tree): every attention subtree padded as
    `serve_config(cfg, tp)` lays it out; the tree itself when no padding is
    needed. New tensors are made only for the padded attention leaves."""
    scfg = serve_config(cfg, tp)
    if scfg.n_kv_heads == cfg.n_kv_heads:
        return scfg, params
    out: Tree = {}
    for path, w in padded_leaves(leaves(params), cfg, tp):
        *head, last = path.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = w
    return scfg, out
