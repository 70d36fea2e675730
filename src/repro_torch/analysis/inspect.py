"""Per-cell cost inspector: one rank's top dots by FLOPs, top collectives
by wire bytes and the storages that hold its memory peak, each tagged with
its call site in the port's model or distributed code (file:line, where
the JAX package's inspector reads HLO `op_name`).

    PYTHONPATH=src python -m repro_torch.analysis.inspect --arch yi-34b --shape train_4k

Runs the cell's step once under the op counter with call sites on (anomaly
mode, for the backward ops' forward sites), in a fake world of 256 or 512
ranks (`launch/dryrun.fake_world`): run it in a process of its own.
"""
from __future__ import annotations

import argparse
from collections import defaultdict


def summarize(cost, top: int = 14):
    """Print and return (dots, collectives): per-rank FLOPs by (site,
    shape) and wire bytes by (kind, site, shape), logical beside sent."""
    dots = defaultdict(float)
    colls = defaultdict(lambda: [0.0, 0.0, 0])
    for op in cost.ops:
        if op.kind == "dot":
            dots[(op.site or op.name, op.shape)] += op.flops
        else:
            c = colls[(op.kind, op.site, op.shape, op.link)]
            c[0] += op.wire
            c[1] += op.sent
            c[2] += 1
    print("== top dots by per-rank FLOPs ==")
    for (site, shp), f in sorted(dots.items(), key=lambda x: -x[1])[:top]:
        print(f"  {f:.3e}  {shp:44s} {site}")
    print("== top collectives by per-rank wire bytes (logical / sent) ==")
    for (kind, site, shp, link), (w, s, n) in sorted(colls.items(),
                                                    key=lambda x: -x[1][1])[:top]:
        print(f"  {w / 2**30:8.3f} / {s / 2**30:8.3f} GiB x{n:5d}  {kind:18s} {shp:8s} "
              f"{link:8s} {site}")
    print(f"== storages alive at the temp peak ({cost.temp_bytes / 2**30:.2f} GiB) ==")
    for n, shape, dtype, site in cost.temp_at_peak[:top]:
        print(f"  {n / 2**20:10.1f} MiB  {str(shape):30s} {dtype:9s} {site}")
    return dots, colls


def main(argv=None):
    ap = argparse.ArgumentParser(description="one cell's top dots and collectives")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import steps
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh

    fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device="cpu")
    cost = steps.lower_cell(get_config(args.arch), SHAPES[args.shape], mesh).analyze(sites=True)
    summarize(cost, args.top)


if __name__ == "__main__":
    main()
