"""Public model API: the LM of any family (dense, MoE, SSM, the jamba
hybrid, whisper's encoder-decoder, phi-3-vision's vision-language decoder)
as an `nn.Module` over the reference-layout weight tree, the functions it
serves with, and the training loss (`train_loss`); and each step's inputs,
as meta tensors for the dry run (`input_specs`: shapes and types, nothing
allocated) or drawn from a generator (`make_train_batch`)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.models.lm import forward, train_loss  # noqa: F401  (re-exports)
from repro_torch.models.params import (cache_specs, from_reference, init_params,  # noqa: F401
                                       leaves)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def frontend_stub_specs(cfg: ModelConfig, batch: int) -> Dict[str, torch.Tensor]:
    """The modality front ends' stand-ins (precomputed frame and patch
    embeddings) in cfg.dtype: whisper's `audio_frames` [B, n_audio_ctx,
    d_model], phi-3-vision's `img_embeds` [B, n_img_tokens, d_model]."""
    dt = getattr(torch, cfg.dtype)
    out: Dict[str, torch.Tensor] = {}
    if cfg.enc_layers:
        out["audio_frames"] = _meta((batch, cfg.n_audio_ctx, cfg.d_model), dt)
    if cfg.n_img_tokens:
        out["img_embeds"] = _meta((batch, cfg.n_img_tokens, cfg.d_model), dt)
    return out


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    specs.update(frontend_stub_specs(cfg, b))
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int32)}
    specs.update(frontend_stub_specs(cfg, b))
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The cache of `shape.seq_len` slots a row (`params.cache_specs`), one
    token a row and the position, a 0-d int32."""
    b, s = shape.global_batch, shape.seq_len
    return {"cache": cache_specs(cfg, b, s), "tokens": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, generator: torch.Generator,
                     device) -> Dict[str, torch.Tensor]:
    """A random batch with `train_batch_specs`' keys and types: tokens and
    labels uniform in [0, vocab), the stub inputs normal(0, 1) in
    cfg.dtype, drawn from `generator` (which lives on `device`). Torch's
    generator is not JAX's threefry, so the values are not the JAX
    package's."""
    out = {k: torch.randint(0, cfg.vocab, (batch, seq), generator=generator, device=device,
                            dtype=torch.int32) for k in ("tokens", "labels")}
    dt = getattr(torch, cfg.dtype)
    for k, spec in frontend_stub_specs(cfg, batch).items():
        out[k] = torch.randn(spec.shape, generator=generator, device=device).to(dt)
    return out


def _to_module(tree: Dict[str, Any]) -> nn.Module:
    mod = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            mod.add_module(k, _to_module(v))
        else:
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return mod


def _to_tree(mod: nn.Module) -> Dict[str, Any]:
    out: Dict[str, Any] = {k: p for k, p in mod.named_parameters(recurse=False)}
    for k, child in mod.named_children():
        out[k] = _to_tree(child)
    return out


class LM(nn.Module):
    """The LM of `cfg.family` (dense, moe, ssm, hybrid, audio or vlm) for
    serving. An audio model (whisper) needs `audio_frames` [B, n_audio_ctx,
    d_model] at prefill and is not served by the engine; a vlm takes
    `img_embeds` [B, n_img_tokens, d_model] in place of its first token
    embeddings (not with `pos_offset`). Its weights are registered as (frozen) parameters under the
    reference paths (`body.l0.mixer.wq`, `body.l0.mixer.in_xbc`, ...),
    so `state_dict()` keys read like the JAX package's tree; `tree()` hands
    the same tensors, uncopied, to the functions of `models.lm`."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.weights = _to_module(params)
        self._tree: Optional[Dict[str, Any]] = None

    def tree(self) -> Dict[str, Any]:
        if self._tree is None:
            self._tree = _to_tree(self.weights)
        return self._tree

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, pos_offset=None, *, img_embeds=None,
                audio_frames=None) -> torch.Tensor:
        """Last-position prefill logits [B, 1, V] of a (left-padded) batch."""
        logits, _ = lm.prefill(self.tree(), tokens, self.cfg, pos_offset=pos_offset,
                               img_embeds=img_embeds, audio_frames=audio_frames)
        return logits

    @torch.no_grad()
    def prefill(self, tokens, *, pos_offset=None, cache_len=None, img_embeds=None,
                audio_frames=None):
        return lm.prefill(self.tree(), tokens, self.cfg, pos_offset=pos_offset,
                          cache_len=cache_len, img_embeds=img_embeds,
                          audio_frames=audio_frames)

    @torch.no_grad()
    def decode(self, cache, tokens, pos, *, pos_offset=None):
        return lm.decode(self.tree(), cache, tokens, pos, self.cfg, pos_offset=pos_offset)

    @torch.no_grad()
    def generate(self, cache, last_logits, pos0, *, steps, pos_offset=None):
        return lm.generate(self.tree(), cache, last_logits, pos0, self.cfg,
                           steps=steps, pos_offset=pos_offset)

    @torch.no_grad()
    def prefill_into_slots(self, tokens, pool, slot_ids, clock, *, pos_offset):
        return lm.prefill_into_slots(self.tree(), tokens, pool, slot_ids, clock,
                                     self.cfg, pos_offset=pos_offset)

    @torch.no_grad()
    def prefill_chunk_into_slots(self, tokens, pool, start, *, pos_offset, lp):
        return lm.prefill_chunk_into_slots(self.tree(), tokens, pool, start, self.cfg,
                                           pos_offset=pos_offset, lp=lp)

    @torch.no_grad()
    def scatter_prefix_into_slots(self, pool, prefix_cache, slot_ids, lp):
        return lm.scatter_prefix_into_slots(pool, prefix_cache, slot_ids, lp)

    @torch.no_grad()
    def decode_segment(self, pool, tok, pos0, *, steps, pos_offset):
        return lm.decode_segment(self.tree(), pool, tok, pos0, self.cfg,
                                 steps=steps, pos_offset=pos_offset)
