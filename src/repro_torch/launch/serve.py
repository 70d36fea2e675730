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
instances; --devices cuda:0,cuda:1 spreads them over several cards, one
slice a card by default, each card holding one replica of the weights),
or a multi-tenant fleet --tenants tinyllama-1.1b:2,mamba2-370m:2
(model:slices asks, PREBA's two-family fleet: the attention LM and a Mamba2
SSM behind one admission queue; a second tenant of the same arch is named
arch@1). Every entry point serves every arch of SERVED_ARCHS: tinyllama-1.1b,
mamba2-370m, h2o-danube-1.8b, granite-3-8b, yi-34b, mixtral-8x22b,
moonshot-v1-16b-a3b, jamba-v0.1-52b and phi-3-vision-4.2b (a
sliding-window model's prompts stay within its window, which the slot
pool's ring must hold). whisper-base, an encoder-decoder whose prefill
needs audio frames the engine does not carry, is refused by name. CPU run
of the kernels' plain versions at a reduced size: --device cpu --reduced.

The closed partition loop (PREBA's MIG lever): measure the knee profiles
on the card once, then serve with the online partition controller, which
resizes the fleet mid-serve between the menu's slice counts:

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --calibrate-knee knees.json
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --continuous \
        --pipelined --preprocess dpu --slices 1 --controller --knee-profiles knees.json
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


def _calibrate_knee(cfg, ec, out_path: str, *, max_batch: int,
                    device="cuda", on_point=None):
    """The paper's offline profiling pass (§3.2): for every context bucket
    the engine serves, sweep batch sizes through a REAL timed decode step
    (seeded weights, a padded context prefilled, then one `lm.decode` timed
    with the cache resident; every timing bracketed by device
    synchronization, best of 3) and find the Batch_knee/Time_knee. Writes
    the {bucket: profile} JSON `--knee-profiles` loads back, and returns
    the profiles. `on_point(batch, context_len, seconds, step)` sees each
    measured point with its decode-step closure (a caller may profile it)."""
    import time

    import torch

    from repro_torch.core.batching.knee import calibrate_knees, profiles_to_json
    from repro_torch.device import resolve_device
    from repro_torch.models.api import LM
    from repro_torch.models.params import init_params

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, init_params(cfg, gen, dev, cfg.dtype))

    def measure(batch: int, context_len: int) -> float:
        ctx = max(int(ec.min_prompt_len), context_len)
        toks = torch.zeros((batch, ctx), dtype=torch.int64, device=dev)
        _, cache = model.prefill(toks, cache_len=ctx + 2)
        tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)

        def step():
            model.decode(cache, tok, ctx)

        step()                                    # warm: handles, workspaces
        sync()
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            step()
            sync()
            best = min(best, time.perf_counter() - t0)
        if on_point is not None:
            on_point(batch, context_len, best, step)
        return best

    bw = max(1, int(ec.bucket_width))
    buckets = list(range(max(1, ec.max_prompt_len // bw)))
    profiles = calibrate_knees(measure, buckets, bw, max_batch=max_batch)
    with open(out_path, "w") as f:
        f.write(profiles_to_json(profiles))
    for b, p in sorted(profiles.items()):
        print(f"  bucket {b} (ctx~{int((b + 0.5) * bw)}): "
              f"Batch_knee={p.batch_knee} "
              f"Time_knee={1e3 * p.time_knee:.2f}ms")
    print(f"  knee profiles -> {out_path}")
    return profiles


def _print_fleet(engine, tenanted: bool) -> None:
    """Per-slice (and, for a multi-tenant fleet, per-tenant) summary."""
    for sid, st in sorted(engine.slice_stats().items()):
        print(f"  slice {sid} [{st['model']}] on {engine.engines[sid].device}: "
              f"admitted={st['admitted']} "
              f"segments={st['segments']} occupancy={st['mean_slot_occupancy']:.3f}")
    print(f"  fleet: hedges={engine.hedges} requeued={engine.stats['requeued']} "
          f"dead_lettered={engine.stats['dead_lettered']}")
    if tenanted:
        for name, ts in sorted(engine.tenant_stats().items()):
            print(f"  tenant {name}: slices={ts['slices']} completed={ts['completed']} "
                  f"dead={ts['dead']} routed_to={ts['routed_to']}")


def _servable(arch: str) -> str:
    """--arch and --tenants: an arch of the package the engine cannot serve
    (whisper-base) is refused here with the engine's reason."""
    from repro_torch.configs import MODEL_ARCHS, get_config
    from repro_torch.serving.engine import check_servable

    if arch in MODEL_ARCHS:
        try:
            check_servable(get_config(arch))
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from e
    return arch


def _parser() -> argparse.ArgumentParser:
    from repro_torch.configs import SERVED_ARCHS

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=SERVED_ARCHS, type=_servable)
    ap.add_argument("--tenants", default="",
                    help="comma-separated model:slices asks (e.g. "
                         "'tinyllama-1.1b:2,mamba2-370m:2'): a multi-tenant "
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
    ap.add_argument("--slices", type=int, default=None,
                    help="number of slices, each its own continuous-batching "
                         "engine on its own CUDA stream behind one shared "
                         "admission queue (default 1, or one a card of "
                         "--devices)")
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
    ap.add_argument("--controller", action="store_true",
                    help="close the resize() loop (--pipelined): an online "
                         "partition controller watches arrival rate, "
                         "prompt-length mix and queue depths and re-slices "
                         "the fleet mid-serve — fine slices for bursts, "
                         "coarse for long-prompt mixes; its decisions are "
                         "hysteretic, cost-modeled against the knee "
                         "profiles, and deterministic under --clock virtual")
    ap.add_argument("--controller-menu", default="",
                    help="comma-separated slice counts the controller may "
                         "pick from (ascending; default '1,2,4'); --slices "
                         "must be one of them (the starting point)")
    ap.add_argument("--calibrate-knee", default="", metavar="OUT",
                    help="run the offline Batch_knee/Time_knee profiling "
                         "pass on --device (paper §3.2: per context bucket "
                         "up to the engine's 128-token prompt limit, time a "
                         "real decode step at batch 1, 2, 4, ... up to "
                         "--max-slots; knee = where throughput plateaus), "
                         "write the {bucket: profile} JSON to OUT, then "
                         "exit; feed it back with --knee-profiles")
    ap.add_argument("--knee-profiles", default="", metavar="IN",
                    help="load a --calibrate-knee JSON file and use the "
                         "measured knees (instead of the analytical "
                         "data-sheet default) for admission batching and "
                         "the partition controller's cost model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--devices", default="",
                    help="comma-separated cards the fleet's slices serve on "
                         "(e.g. 'cuda:0,cuda:1'): the slices are spread over "
                         "them, each on its first card, and each card holds "
                         "one replica of each tenant's weights, drawn on the "
                         "first; the DPU service stays on --device. Default: "
                         "the one card of --device, all slices sharing it "
                         "(the MIG analogue; the JAX package's fleet spreads "
                         "over every device by default). A named card that "
                         "is not there raises")
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
        try:
            asks.append((_servable(arch.strip()), n))
        except argparse.ArgumentTypeError as e:
            ap.error(f"--tenants: {e}")
    if spec and not asks:
        ap.error("--tenants given but holds no model:slices entries")
    return asks


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    tenant_asks = _tenant_asks(ap, args.tenants)
    if not tenant_asks and not args.arch:
        ap.error("--arch is required unless --tenants is given")
    devices = [d.strip() for d in args.devices.split(",") if d.strip()] or None
    if args.slices is None:
        args.slices = len(devices) if devices else 1
    if args.slices < 1:
        ap.error(f"--slices must be >= 1 (got {args.slices})")
    if args.controller and not args.pipelined:
        ap.error("--controller closes the loop over the pipelined runtime; "
                 "add --pipelined")
    if args.calibrate_knee and not args.arch:
        ap.error("--calibrate-knee needs --arch (one model per pass)")
    try:
        menu = tuple(int(x) for x in args.controller_menu.split(",")
                     if x.strip()) or (1, 2, 4)
    except ValueError:
        ap.error(f"--controller-menu takes comma-separated slice counts "
                 f"(got {args.controller_menu!r})")
    n_asked = sum(n for _, n in tenant_asks) if tenant_asks else args.slices
    if args.controller and n_asked not in menu:
        ap.error(f"--slices {n_asked} must be on the controller menu {menu} "
                 f"(it is the starting point)")
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

    def config(arch):
        return reduced(arch) if args.reduced else get_config(arch)

    cfg = config(args.arch) if args.arch else None
    # the prompt bucket covers the workload's prompts (at most 120 tokens)
    # and fits every sliding window served: a window ring must hold the
    # padded prompt it admits
    windows = [c.sliding_window for c in ([cfg] if cfg else
                                          [config(a) for a, _ in tenant_asks])
               if c.sliding_window]
    max_prompt = min([128] + windows)
    max_len = min(120, max_prompt)
    ec = EngineConfig(
        max_new_tokens=args.max_new, continuous=args.continuous or bool(tenant_asks),
        max_slots=args.max_slots, segment_len=args.segment_len,
        max_prompt_len=max_prompt,
        preprocess=args.preprocess if not args.pipelined else "none",
        chunk_lens=chunk_lens,
    )
    if args.calibrate_knee:
        _calibrate_knee(cfg, ec, args.calibrate_knee, max_batch=args.max_slots,
                        device=args.device)
        return

    knee_profiles = None
    if args.knee_profiles:
        from repro_torch.core.batching.knee import profiles_from_json

        try:
            with open(args.knee_profiles) as f:
                knee_profiles = profiles_from_json(f.read())
        except (OSError, ValueError, KeyError) as e:
            ap.error(f"--knee-profiles {args.knee_profiles}: {e!r}")
        print(f"  knee profiles <- {args.knee_profiles} "
              f"({len(knee_profiles)} context buckets)")
    samples = 48000 if args.preprocess == "dpu" else 0
    tenants = None
    if tenant_asks:
        from repro_torch.serving.multislice import TenantSpec

        # a second tenant of the same arch gets an @k-suffixed name (tenant
        # names are unique even when two tenants serve one config)
        seen: dict = {}
        tenants, specs = [], []
        for i, (arch, n) in enumerate(tenant_asks):
            tcfg = config(arch)
            k = seen.get(arch, 0)
            seen[arch] = k + 1
            name = arch if k == 0 else f"{arch}@{k}"
            tenants.append(TenantSpec(cfg=tcfg, name=name, n_slices=n, seed=i))
            # one Poisson stream per tenant, traffic share ~ slice ask
            specs.append((WorkloadSpec(modality="text", rate_qps=args.rate, mean_len=48,
                                       max_len=max_len, vocab=tcfg.vocab, model=name, seed=i,
                                       payload_samples=samples), float(n)))
        n_slices = sum(n for _, n in tenant_asks)
        reqs = generate_requests(specs, args.requests)
    else:
        n_slices = args.slices
        reqs = generate_requests(
            WorkloadSpec(modality="text", rate_qps=args.rate, mean_len=48,
                         max_len=max_len, vocab=cfg.vocab,  # real tokenized prompts
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
        controller = None
        if args.controller:
            from repro_torch.core.control import ControllerConfig, PartitionController

            controller = PartitionController(ControllerConfig(menu=menu))
        rt = build_pipelined_runtime(
            cfg, n_slices=n_slices, ec=ec, service=service, device=args.device,
            rc=RuntimeConfig(clock=args.clock, slo_s=args.slo,
                             max_ingest=max(64, 2 * args.requests)),
            hedge_factor=args.hedge_factor, tenants=tenants,
            controller=controller, knee_profiles=knee_profiles, devices=devices,
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
        if controller is not None:
            print(f"  controller: {len(controller.decisions)} reconfiguration(s), "
                  f"fleet now {len(rt.engine.pod.slices)} slice(s)")
            for d in controller.decisions:
                print(f"    t={d.t:.3f}s {d.from_slices}->{d.to_slices} "
                      f"[{d.reason}] demand={d.demand} "
                      f"gain={d.gain_frac:.2f} requeued={d.requeued}")
        print(f"  kernel launches: {kernels.launch_counts()}")
        _export(rt.registry, rt.tracer, args.metrics_out, args.trace_out,
                args.clock == "virtual")
        return

    if n_slices > 1 or tenants or devices:
        from repro_torch.serving.multislice import build_multislice_engine

        engine = build_multislice_engine(cfg, n_slices=n_slices, ec=ec, device=args.device,
                                         devices=devices, hedge_factor=args.hedge_factor,
                                         tenants=tenants, knee_profiles=knee_profiles)
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
