"""Synthetic training data: a deterministic seeded token stream, one stream
a rank, and a background prefetch thread. The batches are numpy arrays,
byte for byte the JAX package's for the same config and seed."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2  # skewed token distribution (more realistic gradients)


def _rank() -> int:
    """This process's rank in the initialised torch.distributed group, else
    0 (the JAX package's jax.process_index())."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def batch_iterator(cfg: ModelConfig, dc: DataConfig,
                   rank: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM batches: zipf tokens mod vocab, labels =
    tokens shifted left; plus stub `audio_frames` [B, n_audio_ctx, d_model]
    for an encoder-decoder and `img_embeds` [B, n_img_tokens, d_model] for
    a vision-language model, drawn from the same stream. rank: whose
    stream, seed + rank (default: this process's rank); the sharded train
    loop draws rank 0's on every rank, one global batch it cuts."""
    rng = np.random.default_rng(dc.seed + (_rank() if rank is None else rank))
    while True:
        toks = rng.zipf(dc.zipf_a, size=(dc.global_batch, dc.seq_len + 1))
        toks = (toks % cfg.vocab).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if cfg.enc_layers:
            batch["audio_frames"] = rng.standard_normal(
                (dc.global_batch, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
        if cfg.n_img_tokens:
            batch["img_embeds"] = rng.standard_normal(
                (dc.global_batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        yield batch


class Prefetcher:
    """Host-side double buffering so data preparation overlaps the device
    step. close() stops the worker thread and joins it."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self) -> None:
        self._stop.set()
        while self.t.is_alive():  # unblock a put on a full queue
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.t.join(timeout=0.01)
