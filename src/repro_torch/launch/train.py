"""Training launcher, on one NVIDIA GPU or on the production mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 20 --batch 4 --seq 2048

A CPU run at a reduced size: --device cpu --reduced [--steps 20 --batch 4
--seq 64]. The production mesh flags of the JAX package's launcher
(--production-mesh, --multi-pod) build that mesh (launch/mesh.py) in a
world of 256 (512) ranks, one a card, started by torch.distributed (e.g.
torchrun), each running this command, and train on it with the sharded
train step (every arch); in a smaller world the mesh says how many ranks
it needs.
"""
from __future__ import annotations

import argparse


def _join_world(device) -> None:
    """Join the world a launcher such as torchrun describes in the
    environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    one card a rank on NCCL (the production meshes' layout), or gloo on the
    CPU; nothing when no such world is set or one is already joined."""
    import os

    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) == 1 or dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--production-mesh", action="store_true",
                    help="train sharded on the 16 x 16 mesh (256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="train sharded on the 2 x 16 x 16 mesh (512 ranks)")
    args = ap.parse_args(argv)
    mesh = None
    if args.production_mesh or args.multi_pod:
        from repro_torch.launch.mesh import make_production_mesh

        flag = "--multi-pod" if args.multi_pod else "--production-mesh"
        _join_world(args.device)
        try:
            mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
        except ValueError as e:
            ap.error(f"{flag}: {e}")

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainLoopConfig, train

    cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    dc = DataConfig(global_batch=args.batch, seq_len=args.seq)
    tc = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches)
    out = train(cfg, dc, tc, OptConfig(lr=args.lr, total_steps=args.steps),
                device=args.device, mesh=mesh)
    print(f"done: {out['steps']} steps, final loss {out['losses'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
