"""Step factories: the train step (loss, backward, AdamW), prefill and
decode, as the train loop and the serving paths call them.

The train step differentiates with respect to a `cfg.dtype` copy of the
fp32 master weights (the JAX package's bf16 gradient tree), hands fp32
gradients to AdamW, and accumulates fp32 gradients over microbatches. The
factories that attach a device mesh's shardings wait for the port's
distributed slice."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.params import init_params, leaves, tree_map, unflatten
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state

Tree = Dict[str, Any]

# Gradient-accumulation factors for the archs whose activations at the
# production global batch exceed device memory (the JAX package's table).
TRAIN_MICROBATCHES = {
    "mixtral-8x22b": 2,
    "jamba-v0.1-52b": 16,
    "moonshot-v1-16b-a3b": 4,
    "yi-34b": 1,
}


def init_train_state(cfg: ModelConfig, generator: torch.Generator, device) -> Tree:
    """Seeded master weights in cfg.param_dtype (fp32) on `device` (the
    generator must live there too) and a zero AdamW state."""
    params = init_params(cfg, generator, device, cfg.param_dtype)
    return {"params": params, "opt": init_opt_state(params)}


def _device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, oc: Optional[OptConfig] = None,
                    microbatches: int = 1):
    """train_step(state, batch) -> (state, metrics). `batch` holds numpy
    arrays or tensors ({"tokens", "labels"} and a family's stub inputs),
    moved to the weights' device; the state's weights and moments are
    updated in place. metrics: "loss", "nll", "aux" of the last microbatch
    and AdamW's "grad_norm" and "lr", 0-d tensors."""
    oc = oc or OptConfig()
    dt = getattr(torch, cfg.dtype)

    def grads_of(low: Tree, trainable, batch) -> Tuple[Tuple[torch.Tensor, ...], Dict]:
        loss, metrics = lm.train_loss(low, batch, cfg)
        grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        grads = tuple(torch.zeros_like(p) if g is None else g
                      for p, g in zip(trainable, grads))
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: Tree, batch: Dict[str, Any]):
        params = state["params"]
        device = next(v for _, v in leaves(params)).device
        batch = _device_batch(batch, device)
        # the tree differentiated: detached cfg.dtype copies of the fp32 leaves
        low = tree_map(lambda p: (p.detach().to(dt) if p.dtype == torch.float32
                                  else p.detach()).requires_grad_(p.is_floating_point()),
                       params)
        trainable = [v for _, v in leaves(low)]
        if microbatches == 1:
            g, metrics = grads_of(low, trainable, batch)
            flat = [x.float() for x in g]
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch {n} is not a multiple of {microbatches} microbatches")
            m = n // microbatches
            flat = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for p in trainable]
            for i in range(microbatches):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                g, metrics = grads_of(low, trainable, mb)
                for acc, x in zip(flat, g):
                    acc.add_(x.float())
            flat = [x / microbatches for x in flat]
        grads = unflatten(low, flat)
        new_params, new_opt, opt_metrics = adamw_update(params, grads, state["opt"], oc)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    return train_step


def make_prefill(cfg: ModelConfig):
    """prefill_fn(params, {"tokens", and "img_embeds" or "audio_frames"})
    -> (last-position logits [B, 1, V], cache)."""
    @torch.no_grad()
    def prefill_fn(params: Tree, inputs: Dict[str, Any]):
        return lm.prefill(params, inputs["tokens"], cfg, img_embeds=inputs.get("img_embeds"),
                          audio_frames=inputs.get("audio_frames"))

    return prefill_fn


def make_decode(cfg: ModelConfig):
    """decode_fn(params, {"cache", "tokens" [B, 1], "pos"}) -> (logits
    [B, 1, V], cache), the cache updated in place."""
    @torch.no_grad()
    def decode_fn(params: Tree, inputs: Dict[str, Any]):
        return lm.decode(params, inputs["cache"], inputs["tokens"], int(inputs["pos"]), cfg)

    return decode_fn
