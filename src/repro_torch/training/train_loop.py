"""The train loop: restart from the latest checkpoint, asynchronous
checkpoints every `ckpt_every` steps, a guard on non-finite losses,
throughput logging, and a failure-injection hook for the restart tests.

On a mesh of more than one rank (the JAX package's `train(cfg, mesh, ...)`)
every rank runs the loop: the sharded train step on the rank's cut of the
state, each data rank given its rows of the one seeded batch stream, the
global batch's loss reported; a checkpoint is saved whole by rank 0 and
restored by every rank into its cut (`checkpoint.save_sharded`,
`restore_sharded`), synchronously.

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
          device: DeviceLike = "cuda", mesh=None) -> Dict[str, Any]:
    """Train from seed 0 (or the latest checkpoint under tc.ckpt_dir) to
    tc.total_steps on `device`. Returns {"losses", "final_state",
    "steps"} (the losses of the steps this call ran; on a mesh the final
    state is this rank's cut). `fail_at_step` raises mid-run to exercise
    the checkpoint and restart path. mesh: a DeviceMesh that every rank of
    the world passes; with more than one rank the loop trains sharded
    (`steps.make_sharded_train_step`)."""
    dev = resolve_device(device)
    oc = oc or OptConfig(total_steps=tc.total_steps)
    gen = torch.Generator(device=dev).manual_seed(0)
    sharded = mesh is not None and mesh.size() > 1
    if sharded:
        step_fn = steps.make_sharded_train_step(cfg, mesh, oc, tc.microbatches)
        shardings = steps.train_state_shardings(cfg, mesh)
        state = steps.init_sharded_train_state(cfg, gen, dev, mesh)
        rank0 = torch.distributed.get_rank() == 0
    else:
        step_fn = steps.make_train_step(cfg, oc, tc.microbatches)
        state = steps.init_train_state(cfg, gen, dev)
        rank0 = True
    start_step = 0
    if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
        if sharded:
            state = ckpt.restore_sharded(tc.ckpt_dir, steps.train_state_specs(cfg), shardings,
                                         mesh, device=dev)
        else:
            state = ckpt.restore_checkpoint(tc.ckpt_dir, state, device=dev)
        start_step = int(state["opt"]["step"])
    saver = ckpt.AsyncCheckpointer(tc.ckpt_dir) if tc.ckpt_dir and not sharded else None

    def save(step: int) -> None:
        if saver:
            saver.save(step, state)
        elif sharded and tc.ckpt_dir:
            ckpt.save_sharded(tc.ckpt_dir, step, state, shardings, mesh)

    # on a mesh every rank draws the one stream of the global batch and cuts it
    it = Prefetcher(batch_iterator(cfg, dc, rank=0 if sharded else None))
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
            if sharded:
                batch = steps.shard_train_batch(batch, mesh, tc.microbatches)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            losses.append(loss)
            if (step + 1) % tc.ckpt_every == 0:
                save(step + 1)
            if (step + 1) % tc.log_every == 0 and rank0:
                dt = time.time() - t0
                print(f"step {step+1} loss={loss:.4f} "
                      f"tok/s={tokens_per_step*len(losses)/max(dt,1e-9):.0f}", flush=True)
    finally:
        it.close()
    if tc.ckpt_dir:
        save(tc.total_steps)
    if saver:
        saver.wait()
    return {"losses": losses, "final_state": state, "steps": len(losses)}
