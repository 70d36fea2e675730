"""Quickstart on the PyTorch package: train a reduced LM for a few steps
with checkpoints, restore the last one, and serve a few requests on the
trained weights through the PREBA engine (decode attention through the
hand-written kernel on the card).

    PYTHONPATH=src python examples/quickstart_torch.py            # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.serving.engine import EngineConfig, build_engine
from repro_torch.serving.requests import WorkloadSpec, generate_requests
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_loop import TrainLoopConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description="train, checkpoint, restore, then serve")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced("tinyllama-1.1b")

    print("== training ==")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train(
            cfg,
            DataConfig(global_batch=4, seq_len=64),
            TrainLoopConfig(total_steps=20, ckpt_dir=ckpt_dir, ckpt_every=10,
                            log_every=5),
            device=dev,
        )
        print(f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
        state = ckpt.restore_checkpoint(ckpt_dir, out["final_state"], device=dev)
    dt = getattr(torch, cfg.dtype)
    params = tree_map(lambda p: p.to(dt), state["params"])

    print("== serving (dynamic batching) ==")
    engine = build_engine(cfg, ec=EngineConfig(max_new_tokens=4), device=dev, params=params)
    reqs = generate_requests(
        WorkloadSpec(modality="text", rate_qps=200, mean_len=24, max_len=48), 12
    )
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_idle()
    lat = [r.completed_at - r.dispatched_at for r in done]
    print(f"served {len(done)} requests in {engine.batcher.formed} batches; "
          f"mean exec {1e3*np.mean(lat):.0f} ms")
    return out, done


if __name__ == "__main__":
    main()
