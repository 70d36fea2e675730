"""Fault-tolerant checkpoints in the JAX package's on-disk format: one
``leaf_%05d.npy`` a leaf and a ``manifest.json`` under ``step_%09d/``,
written into ``.tmp_step_%09d/`` and committed by an atomic rename (a crash
mid-write never corrupts the latest checkpoint); the newest `keep` are
kept. Leaves are numbered in `jax.tree.flatten`'s order over nested dicts
(sorted keys at each level), so a checkpoint written by either package
restores in the other. An async writer keeps the train loop running while
a snapshot is written.

A sharded train state (each rank's cut, `core/steps.shard_train_state`)
is saved whole: every leaf is gathered, rank 0 writes the files a
one-device run would write, and the other ranks wait at a barrier until
they are committed (`save_sharded`); a restore reads whole leaves and cuts
them again (`restore_sharded`), and the files restore as well into a
one-device state."""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.params import leaves, tree_map, unflatten

Tree = Dict[str, Any]


def _leaf_path(root: pathlib.Path, i: int) -> pathlib.Path:
    return root / f"leaf_{i:05d}.npy"


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _treedef(tree: Any) -> str:
    """The tree's structure as `str(jax.tree.flatten(tree)[1])` prints a
    tree of dicts: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    def one(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {one(t[k])}" for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({one(tree)})"


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf (tensor, array or scalar). numpy has no bf16
    (nor other torch-only dtypes): such a leaf raises, naming its dtype."""
    if isinstance(leaf, torch.Tensor):
        try:
            return leaf.detach().to("cpu", copy=True).numpy()
        except TypeError as e:
            raise TypeError(f"checkpoint leaves must have a numpy dtype; got {leaf.dtype} "
                            f"(cast the tree, e.g. to float32, before saving)") from e
    return np.array(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:09d}"
    tmp = base / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = [_to_numpy(leaf) for _, leaf in leaves(tree)]
    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "treedef": _treedef(tree),
        "process_index": _rank(),
        "time": time.time(),
        "dtypes": [str(a.dtype) for a in arrays],
        "shapes": [list(a.shape) for a in arrays],
    }
    for i, a in enumerate(arrays):
        np.save(_leaf_path(tmp, i), a)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    _gc(base, keep)
    return str(final)


def _gc(base: pathlib.Path, keep: int) -> None:
    ckpts = sorted(p for p in base.glob("step_*") if p.is_dir())
    for p in ckpts[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(m.group(1)) for p in base.glob("step_*")
             if (m := re.match(r"step_(\d+)$", p.name))]
    return max(steps) if steps else None


def _saved_leaves(ckpt_dir: str, target_tree: Any, step: Optional[int]):
    """(path, target leaf, saved array) for each leaf of target_tree, read
    one at a time from the checkpoint of `step` (the latest if None), its
    count and shapes held against the target's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    root = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((root / "manifest.json").read_text())
    targets = list(leaves(target_tree))
    if manifest["n_leaves"] != len(targets):
        raise ValueError(f"checkpoint/tree mismatch: {manifest['n_leaves']} leaves saved, "
                         f"{len(targets)} in the target")
    for i, (path, t) in enumerate(targets):
        a = np.load(_leaf_path(root, i))
        if tuple(a.shape) != tuple(np.shape(t)):
            raise ValueError(f"{path}: saved shape {a.shape} != target {tuple(np.shape(t))}")
        yield path, t, a


def restore_checkpoint(ckpt_dir: str, target_tree: Any, *, step: Optional[int] = None,
                       device=None) -> Any:
    """Restore into target_tree's structure (the latest step unless `step`
    is given). Each leaf lands on `device`, or where the target's leaf lies
    when `device` is None, as a tensor of the saved dtype and shape; a leaf
    count or shape that does not match the target raises."""
    out = []
    for _, t, a in _saved_leaves(ckpt_dir, target_tree, step):
        dev = device if device is not None else getattr(t, "device", "cpu")
        out.append(torch.from_numpy(a).to(dev))
    return unflatten(target_tree, out)


def save_sharded(ckpt_dir: str, step: int, state: Any, shardings: Any, mesh, *,
                 keep: int = 3) -> Optional[str]:
    """Save a sharded tree (this rank's cut of each leaf under `shardings`,
    a tree of placements) as `save_checkpoint` saves the whole tree: each
    leaf is gathered whole (a collective every rank runs), rank 0 writes
    and commits, and every rank then waits at a barrier, so the checkpoint
    is committed when any rank returns. Returns the committed directory on
    rank 0, else None."""
    from repro_torch.core.steps import unshard_leaf

    rank0 = _rank() == 0
    host = []
    for (_, t), (_, pl) in zip(leaves(state), leaves(shardings)):
        whole = unshard_leaf(t, pl, mesh)
        host.append(_to_numpy(whole) if rank0 else None)
        del whole
    out = save_checkpoint(ckpt_dir, step, unflatten(state, host), keep=keep) if rank0 else None
    torch.distributed.barrier()
    return out


def restore_sharded(ckpt_dir: str, specs: Any, shardings: Any, mesh, *, device,
                    step: Optional[int] = None, coordinate=None) -> Any:
    """This rank's cut, under `shardings`, of the checkpoint of `step` (the
    latest if None): whole leaves read one at a time, held to the shapes of
    `specs` (the whole tree, meta tensors will do), cut and moved to
    `device`, each a copy of its own. coordinate: the rank's index a mesh
    dim (default: this process's)."""
    coord = list(mesh.get_coordinate()) if coordinate is None else list(coordinate)
    placements = dict(leaves(shardings))
    out = []
    for path, _, a in _saved_leaves(ckpt_dir, specs, step):
        t = shd.local_shard(torch.from_numpy(a), placements[path], mesh, coord)
        out.append(t.to(device).clone(memory_format=torch.contiguous_format))
    return unflatten(specs, out)


class AsyncCheckpointer:
    """Background writer: snapshot the tree to host memory (a blocking
    copy), then write and commit it off-thread. wait() joins the save in
    flight (call it before exit or restore)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: List[str] = []

    def save(self, step: int, tree: Any) -> None:
        host_tree = tree_map(_to_numpy, tree)
        self.wait()
        self._thread = threading.Thread(
            target=lambda: self.saved.append(
                save_checkpoint(self.ckpt_dir, step, host_tree, keep=self.keep)),
            daemon=True,
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
