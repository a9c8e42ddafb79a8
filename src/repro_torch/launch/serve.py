"""Serving launcher: Runtime -> engine -> batched requests (port of
``repro.launch.serve`` for one device).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch exanode-100m \
        --requests 32 --prompt-len 256 --max-new 64 --slots 16 \
        --capacity 2048 [--smoke] [--device cpu]

Builds a decode-shaped ``repro_torch.runtime.Runtime`` on the CUDA card
(``--device cpu`` runs the kernels' plain PyTorch versions), runs the
continuous-batching engine over seeded synthetic prompts and reports
throughput and latency percentiles.

Fault tolerance, as the reference's: ``--health-every N`` gates every Nth
tick on a device health check, ``--tick-retries`` bounds the transient-
failure retry loop, ``--scrub-every N`` arms the integrity scrub, and
``--fault-plan`` (or ``REPRO_TORCH_FAULT_PLAN``) arms a scripted fault
plan, e.g. ``tick=6,kind=corrupt,target=kv,seed=7`` runs detect ->
quarantine -> replay live.  The engine's ft events stream as JSONL to
``--events-out`` (default stdout); ``--metrics-out FILE`` dumps the
telemetry registry at exit (``.json`` -> snapshot, else Prometheus text)
and ``--trace-out FILE`` turns the tracer on and writes a Chrome
``trace_event`` file.

The port runs on one device: ``--mesh`` raises (sharding, ROADMAP queue
1, item 9; the reference's preflight runs only on a mesh), and so does
``--burn-in`` (the memory test and link sweep, item 12).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.ft.inject import FaultInjector
from repro_torch.obs.export import dump_metrics, write_events_jsonl
from repro_torch.obs.metrics import percentile
from repro_torch.runtime import Runtime
from repro_torch.serve.engine import Request


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="exanode-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--mesh", default="",
                    help="not ported: the port runs on one device")
    ap.add_argument("--kv-layout", default="dense",
                    choices=("dense", "paged"),
                    help="serve KV layout: dense per-slot slabs or the "
                         "pooled paged block caches (serve/blockpool.py)")
    ap.add_argument("--kv-dtype", default="f32", choices=("f32", "int8"),
                    help="paged pool storage: the working dtype, or int8 "
                         "blocks with per-(block, kv head) scales "
                         "(requires --kv-layout paged)")
    ap.add_argument("--burn-in", action="store_true",
                    help="not ported: memory test and link sweep")
    ap.add_argument("--health-every", type=int, default=0,
                    help="run device health checks every N ticks (0 = off)")
    ap.add_argument("--scrub-every", type=int, default=0,
                    help="integrity scrub cadence in ticks (0 = off): seal "
                         "KV fingerprints, re-verify them + the params "
                         "checksum, quarantine + replay on corruption")
    ap.add_argument("--tick-retries", type=int, default=2,
                    help="transient tick failures retried before evacuating")
    ap.add_argument("--fault-plan", default="",
                    help="scripted fault plan (ft/inject.py grammar, e.g. "
                         "'tick=6,kind=raise,times=3'); defaults to "
                         "$REPRO_TORCH_FAULT_PLAN")
    ap.add_argument("--scheduler", action="store_true",
                    help="token-budget continuous batching: chunked prefill "
                         "interleaved with decode (serve/scheduler.py)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="scheduler per-tick token budget (0 = default)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="scheduler prefill chunk length (0 = default)")
    ap.add_argument("--events-out", default="-",
                    help="JSONL sink for engine ft events (one JSON object "
                         "per line; '-' = stdout)")
    ap.add_argument("--metrics-out", default="",
                    help="write the telemetry registry at exit: .json -> "
                         "snapshot, anything else -> Prometheus text "
                         "exposition ('-' = stdout)")
    ap.add_argument("--trace-out", default="",
                    help="enable the tracer and write a Chrome trace_event "
                         "file at exit (chrome://tracing / Perfetto)")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the GPU)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh needs sharding, which the port does not have yet "
            "(ROADMAP queue 1, item 9); it serves on one device")
    if args.burn_in:
        raise NotImplementedError(
            "--burn-in (memory test + PRBS link sweep) is not ported yet "
            "(ROADMAP queue 1, item 12)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sched_kw = {}
    if args.token_budget:
        sched_kw["token_budget"] = args.token_budget
    if args.chunk_size:
        sched_kw["chunk_size"] = args.chunk_size
    rt = Runtime.create(cfg, shape_kind="decode", capacity=args.capacity,
                        kv_layout=args.kv_layout, kv_dtype=args.kv_dtype,
                        scheduler=args.scheduler,
                        sched_kw=sched_kw or None, device=args.device)
    if args.trace_out:
        rt.telemetry().tracer.enable()
    print(rt.describe(), flush=True)

    ft_kw = dict(health_every=args.health_every,
                 tick_retries=args.tick_retries,
                 scrub_every=args.scrub_every)
    if args.fault_plan:
        ft_kw["injector"] = FaultInjector.parse(args.fault_plan)
    eng = rt.engine(num_slots=args.slots, **ft_kw)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                                dtype=np.int32),
            max_new_tokens=args.max_new))
    stats = eng.run_to_completion()
    print("engine:", stats.summary)
    if eng.ft_events:
        n = write_events_jsonl(eng.ft_events, args.events_out)
        if args.events_out not in ("", "-"):
            print(f"ft events: {n} -> {args.events_out}")

    lat = [r.finished_at - r.submitted_at for r in eng.finished]
    ttft = [r.first_token_at - r.submitted_at for r in eng.finished]
    if lat:
        print(f"latency  p50={percentile(lat, 50):.3f}s "
              f"p95={percentile(lat, 95):.3f}s")
        print(f"ttft     p50={percentile(ttft, 50):.3f}s "
              f"p95={percentile(ttft, 95):.3f}s")
        ls = eng.latency_summary()
        print(f"itl      p50={ls['itl_p50']:.4f}s p95={ls['itl_p95']:.4f}s "
              f"p99={ls['itl_p99']:.4f}s  "
              f"queue_wait p95={ls['queue_wait_p95']:.4f}s")
    if args.metrics_out:
        dump_metrics(rt.telemetry().registry, args.metrics_out)
        if args.metrics_out != "-":
            print(f"metrics -> {args.metrics_out}")
    if args.trace_out:
        rt.telemetry().tracer.export_chrome(args.trace_out)
        print(f"trace -> {args.trace_out}")
    print("done")


if __name__ == "__main__":
    main()
