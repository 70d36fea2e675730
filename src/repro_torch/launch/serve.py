"""Serving launcher: the PREBA inference server on one NVIDIA GPU.

PREBA's audio path, end to end (raw 48 kHz payloads through the DPU
kernels, then continuous batching):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --continuous --pipelined --preprocess dpu

Run-to-completion batches (the engine's default): no --continuous.
Continuous batching alone: --continuous [--max-slots 8 --segment-len 8];
chunked prefill on top: --continuous --chunk-lens 16,32. CPU run of the
kernels' plain versions at a reduced size: --device cpu --reduced. The
multi-slice fleet, tenancy, the partition controller and knee calibration
are not ported yet; their flags are rejected.
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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
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
    ap.add_argument("--slices", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--tenants", default="", help=argparse.SUPPRESS)
    ap.add_argument("--controller", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--calibrate-knee", default="", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, given in (("--slices > 1 (multi-slice fleet)", args.slices > 1),
                        ("--tenants (multi-tenant fleet)", bool(args.tenants)),
                        ("--controller (partition controller)", args.controller),
                        ("--calibrate-knee (knee calibration)", bool(args.calibrate_knee))):
        if given:
            ap.error(f"{flag} is not ported to the PyTorch package yet")
    chunk_lens = tuple(int(c) for c in args.chunk_lens.split(",") if c.strip())
    for c in chunk_lens:
        # fail at parse time, not mid-serve: admission asserts pow2
        # divisibility against pow2 prompt buckets
        if c <= 0 or c & (c - 1):
            ap.error(f"--chunk-lens entries must be positive powers of two (got {c})")

    import time

    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.requests import WorkloadSpec, generate_requests

    cfg = reduced(args.arch) if args.reduced else get_config(args.arch)
    ec = EngineConfig(
        max_new_tokens=args.max_new, continuous=args.continuous,
        max_slots=args.max_slots, segment_len=args.segment_len,
        max_prompt_len=128,  # covers the workload's max_len=120 prompt bucket
        preprocess=args.preprocess if not args.pipelined else "none",
        chunk_lens=chunk_lens,
    )
    reqs = generate_requests(
        WorkloadSpec(modality="text", rate_qps=args.rate, mean_len=48,
                     max_len=120, vocab=cfg.vocab,  # real tokenized prompts
                     payload_samples=48000 if args.preprocess == "dpu" else 0),
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
            cfg, ec=ec, service=service, device=args.device,
            rc=RuntimeConfig(clock=args.clock, slo_s=args.slo,
                             max_ingest=max(64, 2 * args.requests)),
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
              f"{rt.shed_counts()}; {exec_ms}; "
              f"{sum(len(r.payload) for r in done)} tokens in {wall:.3f}s")
        for stage, st in rt.stage_summary().items():
            print(f"  queue[{stage}]: mean={st['mean']:.2f} max={st['max']}")
        occ = rt.stage_occupancy()
        print(f"  occupancy: preprocess={occ['preprocess']:.3f} "
              f"slots={occ['slots']:.3f}")
        launches = {k[len("launches_"):]: v for k, v in rt.engine.stats.items()
                    if k.startswith("launches_")}
        print(f"  kernel launches: {launches}")
        _export(rt.registry, rt.tracer, args.metrics_out, args.trace_out,
                args.clock == "virtual")
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
