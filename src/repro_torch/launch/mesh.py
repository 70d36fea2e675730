"""Device meshes over torch.distributed ranks, and a launcher of ranks.

The meshes carry the JAX package's axis names: ("data", "model") for a
single pod, ("pod", "data", "model") for two. Each is a function, so
importing this module starts nothing.

Backends: NCCL when every rank has a card of its own; gloo when ranks share
a card (NCCL refuses two ranks on one GPU), its collectives then staged
through host memory, or on the CPU. `backend_for` makes that choice and the
callers print it.
"""
from __future__ import annotations

import math
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device) -> str:
    return torch.device(device).type


def backend_for(device, world: int) -> str:
    """"nccl" when `world` ranks each get a card of their own, else "gloo"."""
    if _device_type(device) == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """The 16 x 16 single-pod mesh, or 2 x 16 x 16 over two pods: one rank a
    device, every rank of a world of exactly that size calling this."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if _world() != need:
        raise ValueError(
            f"the production mesh {' x '.join(map(str, shape))} {axes} needs {need} "
            f"ranks, one a device; this world has {_world()} (start {need} ranks with "
            f"torch.distributed, e.g. torchrun on {need // 8} hosts of 8 cards)")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_local_mesh(device="cuda") -> DeviceMesh:
    """A 1 x 1 mesh with the production axis names, in one process: unless
    a world is already up, a world of one on an in-memory store (no
    launcher needed)."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device, 1), store=dist.HashStore(), rank=0,
                                world_size=1)
    if _world() != 1:
        raise ValueError(f"the local mesh is one rank; this world has {_world()}")
    return init_device_mesh(_device_type(device), (1, 1), mesh_dim_names=("data", "model"))


def make_slice_mesh(devices: Sequence[int], axes=("data", "model"), device="cuda") -> DeviceMesh:
    """A mesh over the ranks `devices` (a slice of the world): the widest of
    16, 8, 4, 2 and 1 that divides their count on the model axis, the rest
    on the data axis. Every rank of the world calls it."""
    ranks = torch.tensor(list(devices), dtype=torch.int64)
    n = ranks.numel()
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    return DeviceMesh(_device_type(device), ranks.reshape(n // model, model),
                      mesh_dim_names=tuple(axes))


def init_rank(rank: int, world: int, init_file: str, device) -> str:
    """Join a world of `world` ranks through the rendezvous file
    `init_file`; a CUDA rank first takes card rank % cards. Returns the
    backend (`backend_for`)."""
    if _device_type(device) == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = backend_for(device, world)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    return backend


def _rank_main(fn, rank, world, init_file, device, args_file, results) -> None:
    try:
        backend = init_rank(rank, world, init_file, device)
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        out = fn(rank, world, backend, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, args: tuple = (), *, device="cuda",
              timeout: float = 300.0) -> List[Any]:
    """Run fn(rank, world, backend, *args) in `world` spawned processes that
    form one torch.distributed world, and return each rank's result in rank
    order. fn is a module-level function and returns plain picklable data
    (numbers, numpy arrays). `args` reach the ranks through a file, so a
    large one does not hold each start until that rank has read it. Raises,
    after stopping every process, when a rank raises or dies or the run
    outlasts `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        args_file = os.path.join(tmp, "args.pickle")
        with open(args_file, "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init_file, device, args_file, results),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(errors) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue_mod.Empty:
                    if time.monotonic() > deadline:
                        errors.append(f"timed out after {timeout:.0f} s with ranks "
                                      f"{sorted(set(range(world)) - set(got))} unfinished")
                        break
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and p.exitcode != 0 and r not in got]
                    if dead:
                        errors.append(f"ranks {dead} died (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=10.0 if not errors else 1.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
            results.close()
    if errors:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, world={world}): "
                           + "\n".join(errors))
    return [got[r] for r in range(world)]
