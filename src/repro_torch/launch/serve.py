"""Serving launcher: the PREBA inference server on one NVIDIA GPU.

PREBA's audio path, end to end (raw 48 kHz payloads through the DPU
kernels, then continuous batching):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --continuous --pipelined --preprocess dpu

Run-to-completion batches (the engine's default): no --continuous.
Continuous batching alone: --continuous [--max-slots 8 --segment-len 8];
chunked prefill on top: --continuous --chunk-lens 16,32. The multi-slice
fleet: --slices 4 (four engines, each on its own CUDA stream, behind one
shared admission queue; on one card they are logical replicas, not MIG
instances), or a multi-tenant fleet --tenants tinyllama-1.1b:2,tinyllama-1.1b:2
(dense model:slices asks; a second tenant of the same arch is named
arch@1). CPU run of the kernels' plain versions at a reduced size:
--device cpu --reduced. The partition controller and knee calibration are
not ported yet; their flags are rejected.
"""
from __future__ import annotations

import argparse


def _export(registry, tracer, metrics_out: str, trace_out: str,
            virtual: bool) -> None:
    """Write the metrics snapshot and/or the lifecycle timeline (the
    registry is schema-linted first). Virtual clock: the trace is rebased
    to t=0 so two replays of the same seed export byte-identical files."""
    if not (metrics_out or trace_out):
        return
    problems = registry.lint()
    if problems:
        raise SystemExit("metric schema lint failed:\n  " + "\n  ".join(problems))
    if metrics_out:
        with open(metrics_out, "w") as f:
            f.write(registry.to_json())
        print(f"  metrics -> {metrics_out}")
    if trace_out:
        with open(trace_out, "w") as f:
            f.write(tracer.to_json(0.0 if virtual else None))
        print(f"  trace   -> {trace_out}")


def _print_fleet(engine, tenanted: bool) -> None:
    """Per-slice (and, for a multi-tenant fleet, per-tenant) summary."""
    for sid, st in sorted(engine.slice_stats().items()):
        print(f"  slice {sid} [{st['model']}]: admitted={st['admitted']} "
              f"segments={st['segments']} occupancy={st['mean_slot_occupancy']:.3f}")
    print(f"  fleet: hedges={engine.hedges} requeued={engine.stats['requeued']} "
          f"dead_lettered={engine.stats['dead_lettered']}")
    if tenanted:
        for name, ts in sorted(engine.tenant_stats().items()):
            print(f"  tenant {name}: slices={ts['slices']} completed={ts['completed']} "
                  f"dead={ts['dead']} routed_to={ts['routed_to']}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--tenants", default="",
                    help="comma-separated dense model:slices asks (e.g. "
                         "'tinyllama-1.1b:2,tinyllama-1.1b:2'): a multi-tenant "
                         "fleet — every tenant gets its own slices (engines, "
                         "slot pools) behind ONE shared admission queue, "
                         "requests are tagged and routed per model, and the "
                         "slice count is the sum of the asks; replaces "
                         "--arch/--slices")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=50.0)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--continuous", action="store_true",
                    help="slot-pool continuous batching (in-flight join/leave)")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--segment-len", type=int, default=8)
    ap.add_argument("--chunk-lens", default="",
                    help="comma-separated chunked-prefill lengths (pow2, "
                         "e.g. '32' or '16,64'): prompt buckets longer than "
                         "the policy-chosen chunk admit chunk-by-chunk, "
                         "interleaved with decode segments (--continuous; "
                         "empty = monolithic admission)")
    ap.add_argument("--slices", type=int, default=1,
                    help="number of slices, each its own continuous-batching "
                         "engine on its own CUDA stream behind one shared "
                         "admission queue")
    ap.add_argument("--hedge-factor", type=float, default=3.0,
                    help="straggler threshold: hedge a request past this "
                         "multiple of its expected execution time")
    ap.add_argument("--pipelined", action="store_true",
                    help="stage-pipelined runtime: ingest -> DPU preprocess "
                         "-> admission -> decode with bounded queues")
    ap.add_argument("--preprocess", choices=("none", "dpu"), default="none",
                    help="attach raw 48 kHz audio payloads and preprocess "
                         "them (inline at submit, or on the decoupled DPU "
                         "service's kernels with --pipelined)")
    ap.add_argument("--slo", type=float, default=float("inf"),
                    help="front-door latency SLO in seconds (--pipelined)")
    ap.add_argument("--clock", choices=("wall", "virtual"), default="wall",
                    help="--pipelined clock: wall = real serving; virtual = "
                         "deterministic replay")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics-registry snapshot as JSON here")
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle timeline as Chrome "
                         "trace-event JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    # flags of the JAX launcher whose paths are not ported yet: rejected
    ap.add_argument("--controller", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--controller-menu", default="", help=argparse.SUPPRESS)
    ap.add_argument("--calibrate-knee", default="", help=argparse.SUPPRESS)
    ap.add_argument("--knee-profiles", default="", help=argparse.SUPPRESS)
    return ap


def _tenant_asks(ap, spec: str):
    """[(arch, slices)] from 'model:slices,...' (slices default 1)."""
    asks = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        arch, _, n = part.partition(":")
        try:
            n = int(n) if n else 1
        except ValueError:
            ap.error(f"--tenants entries are model:slices (got {part!r})")
        if n < 1:
            ap.error(f"--tenants slice asks must be >= 1 (got {part!r})")
        asks.append((arch.strip(), n))
    if spec and not asks:
        ap.error("--tenants given but holds no model:slices entries")
    return asks


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, given in (("--controller (partition controller)", args.controller),
                        ("--controller-menu (partition controller)",
                         bool(args.controller_menu)),
                        ("--calibrate-knee (knee calibration)", bool(args.calibrate_knee)),
                        ("--knee-profiles (measured knees)", bool(args.knee_profiles))):
        if given:
            ap.error(f"{flag} is not ported to the PyTorch package yet")
    tenant_asks = _tenant_asks(ap, args.tenants)
    if not tenant_asks and not args.arch:
        ap.error("--arch is required unless --tenants is given")
    if args.slices < 1:
        ap.error(f"--slices must be >= 1 (got {args.slices})")
    chunk_lens = tuple(int(c) for c in args.chunk_lens.split(",") if c.strip())
    for c in chunk_lens:
        # fail at parse time, not mid-serve: admission asserts pow2
        # divisibility against pow2 prompt buckets
        if c <= 0 or c & (c - 1):
            ap.error(f"--chunk-lens entries must be positive powers of two (got {c})")

    import time

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving.multislice import MultiSliceEngine
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.requests import WorkloadSpec, generate_requests

    cfg = (reduced(args.arch) if args.reduced else get_config(args.arch)) \
        if args.arch else None
    ec = EngineConfig(
        max_new_tokens=args.max_new, continuous=args.continuous or bool(tenant_asks),
        max_slots=args.max_slots, segment_len=args.segment_len,
        max_prompt_len=128,  # covers the workload's max_len=120 prompt bucket
        preprocess=args.preprocess if not args.pipelined else "none",
        chunk_lens=chunk_lens,
    )
    samples = 48000 if args.preprocess == "dpu" else 0
    tenants = None
    if tenant_asks:
        from repro_torch.serving.multislice import TenantSpec

        # a second tenant of the same arch gets an @k-suffixed name (tenant
        # names are unique even when two tenants serve one config)
        seen: dict = {}
        tenants, specs = [], []
        for i, (arch, n) in enumerate(tenant_asks):
            tcfg = reduced(arch) if args.reduced else get_config(arch)
            k = seen.get(arch, 0)
            seen[arch] = k + 1
            name = arch if k == 0 else f"{arch}@{k}"
            tenants.append(TenantSpec(cfg=tcfg, name=name, n_slices=n, seed=i))
            # one Poisson stream per tenant, traffic share ~ slice ask
            specs.append((WorkloadSpec(modality="text", rate_qps=args.rate, mean_len=48,
                                       max_len=120, vocab=tcfg.vocab, model=name, seed=i,
                                       payload_samples=samples), float(n)))
        n_slices = sum(n for _, n in tenant_asks)
        reqs = generate_requests(specs, args.requests)
    else:
        n_slices = args.slices
        reqs = generate_requests(
            WorkloadSpec(modality="text", rate_qps=args.rate, mean_len=48,
                         max_len=120, vocab=cfg.vocab,  # real tokenized prompts
                         payload_samples=samples),
            args.requests,
        )

    if args.pipelined:
        from repro_torch.core.dpu.runtime import DpuConfig
        from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
        from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

        service = None
        if args.preprocess == "dpu":
            # the decoupled path runs the DPU kernels (pow2-bucketed fused
            # launches); the numpy backend is the inline baseline
            service = DpuService(DpuServiceConfig(
                clock=args.clock, dpu=DpuConfig(backend="dpu")), device=args.device)
        rt = build_pipelined_runtime(
            cfg, n_slices=n_slices, ec=ec, service=service, device=args.device,
            rc=RuntimeConfig(clock=args.clock, slo_s=args.slo,
                             max_ingest=max(64, 2 * args.requests)),
            hedge_factor=args.hedge_factor, tenants=tenants,
        )
        t0 = time.monotonic()
        if args.clock == "virtual":
            from repro_torch.serving.faults import replay_virtual

            done = replay_virtual(rt, reqs)
        else:
            # rebase the workload's 0-based arrivals onto the wall clock (the
            # SLO check compares time.monotonic() against arrival + slo)
            for r in reqs:
                r.arrival += t0
            rt.submit(reqs)
            done = rt.run_until_idle()
        wall = time.monotonic() - t0
        rt.close()
        lats = [r.completed_at - r.dispatched_at for r in done]
        exec_ms = (f"exec p50={1e3*np.percentile(lats,50):.1f}ms "
                   f"p95={1e3*np.percentile(lats,95):.1f}ms"
                   if lats else "exec n/a (nothing served)")
        print(f"pipelined: served {len(done)} requests, shed {len(rt.shed)} "
              f"{rt.shed_counts()}, dead {len(rt.dead)} {rt.dead_counts()}; {exec_ms}; "
              f"{sum(len(r.payload) for r in done)} tokens in {wall:.3f}s")
        for stage, st in rt.stage_summary().items():
            print(f"  queue[{stage}]: mean={st['mean']:.2f} max={st['max']}")
        occ = rt.stage_occupancy()
        print(f"  occupancy: preprocess={occ['preprocess']:.3f} "
              f"slots={occ['slots']:.3f}")
        if isinstance(rt.engine, MultiSliceEngine):
            _print_fleet(rt.engine, tenants is not None)
        print(f"  kernel launches: {kernels.launch_counts()}")
        _export(rt.registry, rt.tracer, args.metrics_out, args.trace_out,
                args.clock == "virtual")
        return

    if n_slices > 1 or tenants:
        from repro_torch.serving.multislice import build_multislice_engine

        engine = build_multislice_engine(cfg, n_slices=n_slices, ec=ec, device=args.device,
                                         hedge_factor=args.hedge_factor, tenants=tenants)
        engine.submit_many(reqs)
        done = engine.run_until_idle()
        lats = [r.completed_at - r.dispatched_at for r in done]
        print(f"served {len(done)} requests on {engine.pod.spec.name} "
              f"({'replicated' if engine.replicated else 'partitioned'}, "
              f"{engine.pod.stranded_chips} stranded); "
              f"{engine.stats['dispatched']} dispatched requests, {engine.hedges} hedges; "
              f"exec p50={1e3*np.percentile(lats,50):.1f}ms "
              f"p95={1e3*np.percentile(lats,95):.1f}ms")
        _print_fleet(engine, tenants is not None)
        _export(engine.registry, engine.tracer, args.metrics_out, args.trace_out,
                virtual=False)
        return

    engine = build_engine(cfg, ec=ec, device=args.device)
    engine.submit_many(reqs)
    done = engine.run_until_idle()
    lats = [r.completed_at - r.dispatched_at for r in done]
    work = (f"{engine.stats['segments']} segments, {engine.stats['prefill_calls']} "
            f"prefill calls" if ec.continuous else f"{engine.stats['batches']} batches")
    print(f"served {len(done)} requests in {work}; "
          f"exec p50={1e3*np.percentile(lats,50):.1f}ms "
          f"p95={1e3*np.percentile(lats,95):.1f}ms")
    _export(engine.registry, engine.tracer, args.metrics_out, args.trace_out,
            virtual=False)


if __name__ == "__main__":
    main()
