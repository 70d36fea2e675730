"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell,
counted on the CPU with nothing allocated; its memory, op counts and H100
roofline terms written as one JSON a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k [--multi-pod] [--out results/dryrun_torch] [--save-ops]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell, both meshes

The JAX package's dry run compiles each cell on 512 placeholder host
devices. Here the process joins a world of 256 or 512 ranks on torch's
`fake` process group (one process; a collective returns at once), builds
the production mesh on it (`launch/mesh.make_production_mesh`, device type
cpu), and runs rank 0's step (`core/steps.lower_cell`) on its local shards
as meta tensors under the op counter (`analysis/op_trace.py`). A process
holds one default process group, so run the dry run in a process of its
own. The record has the JAX package's keys but `compile_s` (there is no
compile); `lower_s` is the seconds of the traced run. A layout the port
refuses is a cell with status `error`, `refused: true` and the port's
reason; any other error fails the run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback


def fake_world(world: int) -> None:
    """Join a world of `world` ranks on the fake process group, as rank 0,
    unless this process is in one already (another fake world is left)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path,
             force: bool = False, save_ops: bool = False) -> dict:
    from repro_torch.analysis import roofline
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.core import steps
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    out_path = out_dir / f"{cell_id}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec = {"cell": cell_id, "status": "skipped", "reason": why,
               "arch": arch, "shape": shape_name, "mesh": mesh_name}
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.time()
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = mesh.size()
        cost = steps.lower_cell(cfg, shape, mesh).analyze(sites=save_ops)
        t_lower = time.time() - t0
        report = roofline.build_report(cfg, shape, mesh_name, chips, cost)
        rec = {
            "cell": cell_id, "status": "ok", "arch": arch, "shape": shape_name,
            "mesh": mesh_name, "chips": chips, "lower_s": round(t_lower, 2),
            "memory_analysis": cost.memory_analysis(),
            "bytes_per_device": cost.bytes_per_device,
            "cost_analysis": cost.to_dict(),
            "roofline": report.to_dict(),
        }
        if save_ops:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{cell_id}.ops.json").write_text(
                json.dumps([op.to_dict() for op in cost.ops]))
    except ValueError as e:  # a layout the port refuses, by its own check
        rec = {"cell": cell_id, "status": "error", "refused": True, "arch": arch,
               "shape": shape_name, "mesh": mesh_name, "error": f"ValueError: {e}"}
    except Exception as e:  # noqa: BLE001 — recorded as a failed cell
        rec = {"cell": cell_id, "status": "error", "arch": arch,
               "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-ops", action="store_true",
                    help="also write each cell's counted ops, with call sites")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    from repro_torch.configs import MODEL_ARCHS, SHAPES

    cells = []
    if args.all:
        for arch in MODEL_ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape, False))
                cells.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape, args.multi_pod))

    n_fail = 0
    for arch, shape, multi in cells:
        rec = run_cell(arch, shape, multi, out_dir, args.force, args.save_ops)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (
                f" bottleneck={r['bottleneck']}"
                f" t=({r['t_compute']:.3e},{r['t_memory']:.3e},{r['t_collective']:.3e})s"
                f" mem/dev={rec['bytes_per_device']/2**30:.2f}GiB"
                f" lower={rec['lower_s']:.1f}s"
            )
        elif status == "error":
            n_fail += not rec.get("refused")
            extra = " " + rec["error"][:200]
        print(f"[{status:7s}] {rec['cell']}{extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
