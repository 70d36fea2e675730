"""The first train steps of tinyllama-1.1b at full width, cut to 2 layers,
on one card and sharded on spawned ranks that share it (gloo), under
chip_smoke.py phase 21's schedule for its fp32 steps (AdamW, lr 3e-4, 2
warm-up steps, a fresh batch of 4 x 256 a step): prints each step's loss
and grad_norm, one card at bf16 and fp32, and the sharded step at bf16 on
meshes (2, 2), (1, 2) and (2, 1) (with the bf16 partial products of
`ctx.matmul_model` kept in fp32 by its own Function, and by a plain fp32
product), and at fp32 on (2, 2). Also checks gloo's all-reduce of fp32,
bf16 and int32 CUDA tensors and its MAX on two ranks. Needs a CUDA card.

    python3 tools/train_schedule_check.py
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

LAYERS, STEPS = 2, 3


def allreduce_rank(rank, world, backend):
    """Each dtype's sum over the ranks against the sum computed in fp32,
    and the MAX of rank + 1."""
    import torch.distributed as dist

    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        base = torch.arange(1000, device="cuda") % 7
        y = (base + rank * 3).to(dt)
        dist.all_reduce(y)
        want = sum((base + r * 3).to(dt).float() for r in range(world))
        out[str(dt)] = float((y.float() - want).abs().max())
    s = torch.tensor(float(rank + 1), device="cuda")
    dist.all_reduce(s, op=dist.ReduceOp.MAX)
    out["max"] = float(s)
    return out


def step_rank(rank, world, backend, shape, dtype, variant):
    """STEPS sharded train steps on `shape`: [(loss, grad_norm)]."""
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke as cs
    from repro_torch.core import steps
    from repro_torch.distributed import ctx as dctx
    from repro_torch.training.optimizer import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    if variant == "fp32-product":
        dctx._MmF32.apply = staticmethod(lambda a2, w: a2.float() @ w.float())
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(cs.train_case_config(cs.SHARD_TRAIN_CASES["a"], dtype), n_layers=LAYERS)
    state = steps.init_sharded_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                                           "cuda", mesh)
    step = steps.make_sharded_train_step(cfg, mesh, OptConfig(**cs.SHARD_OPT))
    out = []
    for b in fresh_batches(cfg):
        local = {k: v.cuda() for k, v in steps.shard_train_batch(b, mesh).items()}
        state, m = step(state, local)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def fresh_batches(cfg):
    from repro_torch.data.pipeline import DataConfig, batch_iterator

    import chip_smoke as cs

    it = batch_iterator(cfg, DataConfig(cs.SHARD_TRAIN_BATCH, cs.SHARD_TRAIN_SEQ, seed=0), rank=0)
    return [next(it) for _ in range(STEPS)]


def main() -> int:
    if not torch.cuda.is_available():
        print("train_schedule_check: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import steps
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.training.optimizer import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    print("allreduce", run_ranks(allreduce_rank, 2, (), device="cuda", timeout=120))
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cs.train_case_config(cs.SHARD_TRAIN_CASES["a"], dtype), n_layers=LAYERS)
        state = steps.init_train_state(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        step = steps.make_train_step(cfg, OptConfig(**cs.SHARD_OPT))
        ms = []
        for b in fresh_batches(cfg):
            state, m = step(state, b)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        print("one card", dtype, ms, flush=True)
        del state
        torch.cuda.empty_cache()
        for variant in ("mm-out-fp32", "fp32-product"):
            for shape in ((2, 2), (1, 2), (2, 1)):
                if dtype == "float32" and (variant != "mm-out-fp32" or shape != (2, 2)):
                    continue
                got = run_ranks(step_rank, shape[0] * shape[1], (shape, dtype, variant),
                                device="cuda", timeout=300)[0]
                print("sharded", dtype, variant, shape, got, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
