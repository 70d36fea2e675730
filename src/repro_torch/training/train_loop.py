"""The train loop: restart from the latest checkpoint, asynchronous
checkpoints every `ckpt_every` steps, a guard on non-finite losses,
throughput logging, and a failure-injection hook for the restart tests.

A restart replays the data stream from its first batch: `batch_iterator`
is built anew on every call and the loop resumes at the checkpoint's step,
so the resumed steps see batches 0, 1, ... again, as the JAX package's
loop does."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import steps
from repro_torch.data.pipeline import DataConfig, Prefetcher, batch_iterator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import OptConfig


@dataclass
class TrainLoopConfig:
    total_steps: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    log_every: int = 10
    microbatches: int = 1


def train(cfg: ModelConfig, dc: DataConfig, tc: TrainLoopConfig,
          oc: Optional[OptConfig] = None, fail_at_step: Optional[int] = None,
          device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Train from seed 0 (or the latest checkpoint under tc.ckpt_dir) to
    tc.total_steps on `device`. Returns {"losses", "final_state",
    "steps"} (the losses of the steps this call ran). `fail_at_step`
    raises mid-run to exercise the checkpoint and restart path."""
    dev = resolve_device(device)
    oc = oc or OptConfig(total_steps=tc.total_steps)
    step_fn = steps.make_train_step(cfg, oc, tc.microbatches)

    state = steps.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    start_step = 0
    if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
        state = ckpt.restore_checkpoint(tc.ckpt_dir, state, device=dev)
        start_step = int(state["opt"]["step"])
    saver = ckpt.AsyncCheckpointer(tc.ckpt_dir) if tc.ckpt_dir else None

    it = Prefetcher(batch_iterator(cfg, dc))
    losses = []
    tokens_per_step = dc.global_batch * dc.seq_len
    t0 = time.time()
    try:
        for step in range(start_step, tc.total_steps):
            batch = next(it)
            if fail_at_step is not None and step == fail_at_step:
                if saver:
                    saver.wait()
                raise RuntimeError(f"injected failure at step {step}")
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            losses.append(loss)
            if saver and (step + 1) % tc.ckpt_every == 0:
                saver.save(step + 1, state)
            if (step + 1) % tc.log_every == 0:
                dt = time.time() - t0
                print(f"step {step+1} loss={loss:.4f} "
                      f"tok/s={tokens_per_step*len(losses)/max(dt,1e-9):.0f}", flush=True)
    finally:
        it.close()
    if saver:
        saver.save(tc.total_steps, state)
        saver.wait()
    return {"losses": losses, "final_state": state, "steps": len(losses)}
