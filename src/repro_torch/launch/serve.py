"""Offline compression + compressed-cache serving behind one CLI
(``repro/launch/serve.py``, the offline path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --smoke --requests 6 --tasks 2 --slots 4 --max-new 8 --device cpu

Stages:
  1. "cloud": initialise the target and the compressor from seeds,
     compress each ICL task's many-shot context once, materialize the
     per-layer compressed KV through the frozen target projections, and
     register it in the engine's PrefixStore.
  2. "edge": the continuous-batching ServingEngine serves ragged
     requests round-robin over the tasks (``--classify``: ICL label
     queries): each seats its task memory in a free slot, and a finished
     slot is refilled mid-decode.

``--kv-layout paged`` swaps the per-slot dense cache for the block-pool
cache: every slot seated on one task points its block table at one shared
copy of the compressed prefix (copy-on-write of a partial tail block), so
prefix memory is O(tasks) instead of O(slots).  ``--block-size`` /
``--num-blocks`` size the pool; admission is gated on free blocks.
``--prefix-capacity`` bounds the resident prefixes (LRU past it).

``--raw-shots`` skips stage 1: each request carries its task's many-shot
context and the engine compiles an unseen task online, at most
``--compile-budget`` source tokens between decode steps (default: a whole
task at once).  ``--host-capacity`` / ``--disk-dir`` put the tiers behind
the store: an evicted prefix is demoted to (pinned) host memory, spilled
to a disk shard past the host capacity, and promoted back at most
``--promote-budget`` layers between decode steps; shards left in
``--disk-dir`` by an earlier run are indexed and promoted, not
recompiled.
``--priority-classes N`` puts request i in class i % N (a queued class
preempts a running lower one); ``--priority-aging S`` lifts a queued
request one class for every S seconds it waits.

``--fused-step`` lets a request join while other slots decode: its prompt
streams ``--fused-chunk-tokens`` at a time through the batched decode
step, and a budgeted compile chunk rides the same step.
``--spec-draft self|ARCH --spec-k K`` adds speculative decoding on the
fused step (the target drafting for itself, or ARCH's config from seed
1).  ``--traffic zipf|onoff`` serves a seeded synthetic workload instead
of the fixed batch (``--traffic-requests``, ``--traffic-tasks``,
``--traffic-rate``, ``--zipf-alpha``, ``--seed``): a Zipf catalog of
raw-shot tasks under Poisson or ON-OFF arrivals on a virtual clock,
reported as SLO metrics against ``--slo-ttft``, with an SLO burn-rate
watchdog that sheds lower-class admissions while a page alert holds.
``--autotune-budgets`` halves and doubles ``--compile-budget`` /
``--promote-budget`` against ``--target-gap``.  ``--stats`` prints the
engine's counters.

Observability: ``--trace-out PATH`` records the request lifecycle and
writes it as Chrome-trace / Perfetto JSON (``--flight-recorder N`` keeps
the last N events, dumped to PATH on a crash too); ``--metrics-out PATH``
writes the metrics registry as Prometheus text; ``--http-port PORT``
serves ``/metrics``, ``/healthz``, ``/debug/state`` and ``/debug/trace``
on 127.0.0.1 while the engine runs (0 picks a free port), and
``--http-linger S`` keeps it up S seconds after serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --smoke --fused-step --spec-draft self --spec-k 2 --device cpu

The device is the card unless ``--device cpu`` is given; without a card
the launcher raises.  A config without MemCom (the attention-free
mamba2-370m) exits with a message before any model is built, as the JAX
launcher does: its entry point is ``ServingEngine`` itself.

``--mesh M`` (or ``--mesh DxM``) serves tensor-parallel on a ("data",
"model") mesh of ``torch.distributed`` ranks: the target's weights split
by ``--rules`` (baseline, or fsdp, which at data 1 places as baseline
does and at data above 1 also cuts d_model over the data ranks, each
weight gathered whole for the call that reads it), K/V caches and pools
split by head over "model", every kernel on
the rank's heads, block tables, lengths and the control plane the same on
every rank.  The launcher starts its ranks itself (``spawn``, a file-store
rendezvous in a temporary directory) unless ``torchrun`` started them;
only rank 0 prints, and the report carries ``mesh`` and ``rules``.  A
data axis above 1 holds whole replicas.  The ranks' backend is ``nccl``
on the card (one card a rank) and ``gloo`` on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --smoke --mesh 2 --device cpu

MoE, Mamba2, MLA and enc-dec stacks raise under a model axis above 1 (the
next slice of the port); a 1x1 mesh runs every family.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time  # reprolint: ignore-file[wall-clock] -- the launcher reports real compress/serve seconds to its operator; nothing replays them

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import memcom
from repro_torch.data import (ICLTaskSpec, SyntheticVocab,
                              build_manyshot_prompt, make_episode, make_query)
from repro_torch.launch.mesh import (default_backend, make_serving_mesh,
                                     one_rank_group, run_ranks)
from repro_torch.models import transformer as tfm
from repro_torch.serving import (MetricsRegistry, Request, ServingEngine,
                                 ShedDegrade, SLOWatchdog, TelemetryServer,
                                 Tracer, TrafficConfig, VirtualClock,
                                 default_rules, generate_trace,
                                 materialize_prefix, slo_metrics)
from repro_torch.sharding import BASELINE_RULES, FSDP_RULES


# a spawned --mesh run, and each collective of it, is stopped after this
_MESH_TIMEOUT_S = 1800.0


def _parse_mesh(spec: str):
    """"M" -> (1, M) model-parallel; "DxM" -> (data, model)."""
    parts = spec.lower().split("x")
    if len(parts) == 1:
        data, model = 1, int(parts[0])
    elif len(parts) == 2:
        data, model = int(parts[0]), int(parts[1])
    else:
        raise ValueError(f"bad mesh spec {spec!r}: use M or DxM")
    if data < 1 or model < 1:
        raise ValueError(f"bad mesh spec {spec!r}: axes must be >= 1")
    return data, model


def _rank_main(rank: int, world: int, argv: list) -> dict:
    """One spawned rank of ``--mesh``: the launcher again, inside the
    group; only rank 0 prints."""
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    return main(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--tasks", type=int, default=2,
                    help="distinct compressed ICL tasks to serve")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--context-tokens", type=int, default=96)
    ap.add_argument("--classify", action="store_true",
                    help="serve ICL label queries instead of generation")
    ap.add_argument("--kv-layout", choices=("dense", "paged"), default="dense",
                    help="dense: per-slot cache stripes; paged: block-pool "
                         "cache where slots seated on the same compressed "
                         "task share its prefix blocks (copy-on-write)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="tokens per physical KV block (paged layout only)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical blocks in the paged pool (default: "
                         "slots+4 worst-case windows)")
    ap.add_argument("--prefix-capacity", type=int, default=None,
                    help="max resident compressed prefixes (LRU past it; "
                         "default unbounded)")
    ap.add_argument("--host-capacity", type=int, default=None,
                    help="enable the tiered prefix cache: HBM evictions "
                         "demote to a pinned-host tier holding up to N "
                         "prefixes (0 = demote straight to disk)")
    ap.add_argument("--disk-dir", default=None,
                    help="disk tier directory: host pressure spills "
                         "codec-compressed prefix shards here, and shards "
                         "from a previous run are promoted instead of "
                         "recompiled")
    ap.add_argument("--promote-budget", type=int, default=None,
                    help="max per-layer host->HBM chunks copied per "
                         "serve-loop iteration during a promotion "
                         "(default: whole prefix at once — decode stalls "
                         "for the full copy)")
    ap.add_argument("--raw-shots", action="store_true",
                    help="skip the offline compress stage: requests carry "
                         "their raw many-shot context and the engine "
                         "compiles each unseen task online, interleaved "
                         "with decode")
    ap.add_argument("--compile-budget", type=int, default=None,
                    help="max source tokens compiled per serve-loop "
                         "iteration (default: a whole task at once — "
                         "decode stalls for the full compile)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="request i gets priority class i %% N (class 0 most "
                         "urgent; >1 enables preemption)")
    ap.add_argument("--priority-aging", type=float, default=None,
                    help="seconds of queue wait per one-class priority "
                         "boost (anti-starvation; default off)")
    ap.add_argument("--stats", action="store_true",
                    help="print engine cache/compile counters after serving")
    ap.add_argument("--traffic", choices=("zipf", "onoff"), default=None,
                    help="serve a seeded synthetic workload instead of the "
                         "fixed batch: Zipf-popularity task catalog under "
                         "Poisson (zipf) or bursty ON-OFF (onoff) arrivals "
                         "on the engine's virtual clock")
    ap.add_argument("--traffic-requests", type=int, default=32)
    ap.add_argument("--traffic-tasks", type=int, default=8,
                    help="catalog size; set above --prefix-capacity/"
                         "--host-capacity to make the tiers churn")
    ap.add_argument("--traffic-rate", type=float, default=200.0,
                    help="arrival rate in requests per simulated second")
    ap.add_argument("--zipf-alpha", type=float, default=1.1)
    ap.add_argument("--slo-ttft", type=float, default=0.02,
                    help="traffic mode: TTFT SLO in simulated seconds")
    ap.add_argument("--autotune-budgets", action="store_true",
                    help="halve/double --compile-budget/--promote-budget "
                         "against the observed decode gap")
    ap.add_argument("--target-gap", type=float, default=2e-3,
                    help="decode-gap target (simulated s) for "
                         "--autotune-budgets")
    ap.add_argument("--seed", type=int, default=0,
                    help="traffic trace seed (same seed -> same workload "
                         "and, on the virtual clock, same metrics)")
    ap.add_argument("--fused-step", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="fuse admission prefill chunks / compile chunks "
                         "into the batched decode step (attention-only "
                         "archs): new requests join by streaming their "
                         "prompt through the decode step instead of "
                         "opening a prefill-sized decode gap")
    ap.add_argument("--fused-chunk-tokens", type=int, default=16,
                    help="prompt tokens a joining slot streams per fused "
                         "step (--fused-step)")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH|self",
                    help="speculative decoding drafter: an arch id (its "
                         "config, smoke with --smoke, drafts for the "
                         "target) or 'self' (the target drafts for "
                         "itself — the acceptance upper bound).  Needs "
                         "--fused-step and --spec-k")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="draft tokens proposed and verified per fused "
                         "step and slot (0 = speculative decoding off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    ap.add_argument("--http-port", type=int, default=None, metavar="PORT",
                    help="serve the telemetry plane over HTTP while the "
                         "engine runs: GET /metrics (Prometheus text), "
                         "/healthz, /debug/state, /debug/trace on "
                         "127.0.0.1:PORT (0 = pick an ephemeral port, "
                         "printed at startup)")
    ap.add_argument("--http-linger", type=float, default=0.0, metavar="S",
                    help="keep the process (and --http-port server) alive "
                         "S seconds after serving finishes, so external "
                         "scrapers can read the final state")
    ap.add_argument("--metrics", default=None,
                    help="write the run's numbers as JSON to this path")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a full request-lifecycle trace and write "
                         "it as Chrome-trace/Perfetto JSON; on the virtual "
                         "clock the file is byte-identical for one "
                         "(scenario, seed)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the engine's MetricsRegistry in Prometheus "
                         "text exposition format after serving")
    ap.add_argument("--flight-recorder", type=int, default=None,
                    metavar="N",
                    help="bound the tracer's ring buffer to the last N "
                         "events (the flight recorder: dumped to "
                         "--trace-out on a crash); default keeps all")
    ap.add_argument("--mesh", default=None, metavar="M|DxM",
                    help="tensor-parallel serving on a (data, model) mesh "
                         "of ranks: M = 1xM; the launcher spawns the ranks "
                         "unless torchrun started them")
    ap.add_argument("--rules", choices=("baseline", "fsdp"),
                    default="baseline",
                    help="weight placement rule set for --mesh (baseline: "
                         "tensor parallel over model; fsdp: also d_model "
                         "over data, gathered for each call)")
    args = ap.parse_args(argv)
    if min(args.tasks, args.slots, args.requests, args.priority_classes) < 1:
        ap.error("--tasks, --slots, --requests and --priority-classes must "
                 "all be >= 1")
    if args.compile_budget is not None and args.compile_budget < 1:
        ap.error("--compile-budget must be >= 1")
    if args.promote_budget is not None and args.promote_budget < 1:
        ap.error("--promote-budget must be >= 1")
    if args.host_capacity is not None and args.host_capacity < 0:
        ap.error("--host-capacity must be >= 0")
    if args.flight_recorder is not None and args.flight_recorder < 1:
        ap.error("--flight-recorder must be >= 1")
    if args.raw_shots and args.classify:
        ap.error("--raw-shots serves generation traffic (classify goes "
                 "through the offline seat path)")
    if args.traffic and (args.classify or args.raw_shots):
        ap.error("--traffic generates its own raw-shot requests (drop "
                 "--classify/--raw-shots)")
    if args.autotune_budgets and \
            args.compile_budget is None and args.promote_budget is None:
        ap.error("--autotune-budgets needs --compile-budget and/or "
                 "--promote-budget to tune")
    if (args.spec_k > 0) != (args.spec_draft is not None):
        ap.error("--spec-draft and --spec-k come together (both or neither)")
    if args.spec_k and not args.fused_step:
        ap.error("--spec-k rides the fused step: add --fused-step")
    if args.fused_chunk_tokens < 1:
        ap.error("--fused-chunk-tokens must be >= 1")
    if args.spec_draft is not None and args.spec_draft != "self" \
            and args.spec_draft not in ARCH_IDS:
        ap.error(f"--spec-draft must be 'self' or one of {ARCH_IDS}")
    if args.http_port is not None and args.http_port < 0:
        ap.error("--http-port must be >= 0 (0 picks an ephemeral port)")
    if args.http_linger < 0:
        ap.error("--http-linger must be >= 0")
    if args.http_linger and args.http_port is None:
        ap.error("--http-linger needs --http-port")
    device = resolve_device(args.device)
    mesh = rules = None
    if args.mesh:
        try:
            data, model = _parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        backend = default_backend(device)
        if not dist.is_initialized():
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                dist.init_process_group(backend)  # torchrun's env://
                try:
                    return main(argv)
                finally:
                    dist.destroy_process_group()
            if data * model == 1:
                with one_rank_group(backend, timeout=_MESH_TIMEOUT_S):
                    return main(argv)
            return run_ranks(_rank_main, data * model, (argv,),
                             backend=backend, timeout=_MESH_TIMEOUT_S,
                             device=device)[0]
        mesh = make_serving_mesh(model=model, data=data, device=device,
                                 backend=backend)
        if mesh.get_coordinate() is None:
            print(f"[edge] rank {dist.get_rank()}: not on the "
                  f"{args.mesh} mesh, idle")
            return {}
        rules = {"baseline": BASELINE_RULES, "fsdp": FSDP_RULES}[args.rules]
    # under a mesh every rank serves; rank 0 alone prints, listens and
    # writes the run's files
    lead = mesh is None or dist.get_rank() == 0

    vocab = SyntheticVocab()
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(vocab_size=vocab.size)
    if cfg.memcom is None:
        raise SystemExit(f"{args.arch}: attention-free, no MemCom config — "
                         "serve its plain prompts through ServingEngine "
                         "(each slot keeps the post-prompt SSM state)")
    m = cfg.memcom.num_memory_tokens
    print(f"[cloud] target {cfg.name} ({cfg.param_count()/1e6:.1f}M), "
          f"m={m} memory tokens, {args.tasks} task(s), device {device}")
    target = tfm.init_params(cfg, 0, device=device)
    compressor = memcom.init_memcom(cfg, target, 1)
    rng = np.random.default_rng(0)
    spec_draft = None
    if args.spec_k:
        if args.spec_draft == "self":
            spec_draft = "self"
            print(f"[edge] self-speculative decoding, k={args.spec_k}")
        else:
            dcfg = (get_smoke_config(args.spec_draft) if args.smoke
                    else get_config(args.spec_draft)).replace(
                        vocab_size=vocab.size)
            spec_draft = (dcfg, tfm.init_params(dcfg, 1, device=device))
            print(f"[edge] speculative decoding: drafter {dcfg.name} "
                  f"({dcfg.param_count()/1e6:.1f}M), k={args.spec_k}")
    tracer = None
    if args.trace_out or args.flight_recorder or args.http_port is not None:
        # the tracer takes the engine's clock, so on a --traffic run the
        # spans sit on simulated time; --http-port implies one so that
        # GET /debug/trace has a flight recorder to dump
        tracer = Tracer(capacity=args.flight_recorder,
                        dump_path=args.trace_out if lead else None)
        print(f"[edge] tracing: flight recorder "
              f"{'unbounded' if args.flight_recorder is None else args.flight_recorder}"
              f" event(s)"
              + (f", dump -> {args.trace_out}" if args.trace_out else ""))
    registry = watchdog = None
    if args.traffic or args.http_port is not None:
        registry = MetricsRegistry()
    if args.traffic:
        # SLO burn-rate watchdog over the virtual clock: alerts land as
        # tracer instants and serving_alerts_total counters, and the
        # page-severity hook sheds lower-class admissions while active
        watchdog = SLOWatchdog(default_rules(slo_ttft_s=args.slo_ttft),
                               metrics=registry, tracer=tracer,
                               degrade_hook=ShedDegrade())
    # traffic replays timed arrivals against a virtual clock: time moves
    # through the engine's work-cost model, so the SLO numbers are
    # simulated seconds, reproducible for one seed
    engine = ServingEngine(cfg, target, slots=args.slots,
                           max_len=m + 24 + args.max_new + 16, device=device,
                           kv_layout=args.kv_layout, block_size=args.block_size,
                           num_blocks=args.num_blocks,
                           prefix_capacity=args.prefix_capacity,
                           compressor=(compressor
                                       if args.raw_shots or args.traffic
                                       else None),
                           compile_token_budget=args.compile_budget,
                           host_capacity=args.host_capacity,
                           disk_dir=args.disk_dir,
                           promote_layer_budget=args.promote_budget,
                           clock=VirtualClock() if args.traffic else None,
                           priority_aging_s=args.priority_aging,
                           autotune_budgets=args.autotune_budgets,
                           target_decode_gap_s=(args.target_gap
                                                if args.autotune_budgets
                                                else None),
                           fused_step=args.fused_step,
                           fused_chunk_tokens=args.fused_chunk_tokens,
                           spec_draft=spec_draft, spec_k=args.spec_k,
                           tracer=tracer, metrics=registry,
                           watchdog=watchdog, mesh=mesh, rules=rules)
    if mesh is not None:
        print(f"[edge] tensor-parallel mesh {data}x{model} (data x model, "
              f"{dist.get_backend()}), rules={args.rules}")
    http_server = None
    if args.http_port is not None and lead:
        http_server = TelemetryServer(engine, port=args.http_port)
        port = http_server.start()
        print(f"[edge] http telemetry on 127.0.0.1:{port} "
              "(/metrics /healthz /debug/state /debug/trace)")
    if engine.tiers is not None:
        preloaded = engine.tiers.disk_names()
        print(f"[edge] tiered prefix cache: host capacity "
              f"{'unbounded' if args.host_capacity is None else args.host_capacity}"
              f", disk {args.disk_dir or '(none)'}"
              + (f", {len(preloaded)} shard(s) indexed from a previous run"
                 if preloaded else ""))

    tasks, payload = [], 0
    _sync(device)
    t0 = time.perf_counter()
    for t in range(0 if args.traffic else args.tasks):
        task = ICLTaskSpec(vocab, num_labels=8, keys_per_label=4)
        episode = make_episode(task, rng)
        prompt = build_manyshot_prompt(task, episode, rng,
                                       budget=args.context_tokens)
        if not args.raw_shots:  # stage 1: compress offline, register
            prefix, _ = memcom.compress(
                compressor, cfg, torch.as_tensor(prompt[None], device=device))
            kv = materialize_prefix(target, cfg, prefix)
            engine.add_prefix(f"task{t}", kv)
            payload += sum(x.numel() * x.element_size()
                           for entry in kv for x in entry.values())
        tasks.append((f"task{t}", task, episode, prompt))
    _sync(device)
    t_compress = time.perf_counter() - t0
    if args.traffic:
        pass  # the trace carries its own raw shots; no offline stage
    elif args.raw_shots:
        budget = ("whole-task" if args.compile_budget is None
                  else f"{args.compile_budget}-token")
        print(f"[edge] no offline stage: {args.tasks} task(s) will compile "
              f"online, {budget} chunks interleaved with decode")
    else:
        print(f"[cloud] compressed {args.tasks}x{args.context_tokens} tokens "
              f"-> {m} slots/layer each in {t_compress:.2f}s; "
              f"payload {payload/1e3:.1f} KB total")
    metrics = {"arch": cfg.name, "device": str(device), "m": m,
               "tasks": args.tasks, "slots": args.slots,
               "kv_layout": args.kv_layout,
               "context_tokens": args.context_tokens,
               "compress_s": t_compress, "payload_bytes": payload,
               "raw_shots": args.raw_shots,
               "compile_budget": args.compile_budget,
               "host_capacity": args.host_capacity,
               "disk_dir": args.disk_dir,
               "promote_budget": args.promote_budget,
               "fused_step": args.fused_step,
               "spec_draft": args.spec_draft, "spec_k": args.spec_k,
               "mesh": args.mesh, "rules": args.rules if args.mesh else None}

    if args.traffic:
        tcfg = TrafficConfig(
            num_tasks=args.traffic_tasks, zipf_alpha=args.zipf_alpha,
            context_tokens=args.context_tokens,
            num_requests=args.traffic_requests,
            process="poisson" if args.traffic == "zipf" else "onoff",
            rate_rps=args.traffic_rate,
            priority_classes=args.priority_classes)
        trace = generate_trace(tcfg, args.seed, vocab=vocab)
        print(f"[edge] traffic: {tcfg.num_requests} requests over "
              f"{tcfg.num_tasks} task(s), zipf {tcfg.zipf_alpha}, "
              f"{tcfg.process} arrivals @ {tcfg.rate_rps:.0f} r/s "
              f"(simulated), {tcfg.priority_classes} priority class(es), "
              f"seed {args.seed}")
        _sync(device)
        t0 = time.perf_counter()
        out = engine.serve(list(trace.requests))
        _sync(device)
        wall = time.perf_counter() - t0
        slo = slo_metrics(engine.request_log, slo_ttft_s=args.slo_ttft,
                          gap_samples=engine.gap_samples)
        generated = int(sum(len(v) for v in out.values()))
        print(f"[edge] {slo['completed']}/{slo['requests']} completed, "
              f"{generated} tokens in {slo['duration_s']*1e3:.1f} ms "
              f"simulated ({wall:.2f}s wall): TTFT p50 "
              f"{slo['ttft_p50_s']*1e3:.2f} / p99 "
              f"{slo['ttft_p99_s']*1e3:.2f} ms, goodput "
              f"{slo['goodput_rps']:.1f} r/s @ SLO "
              f"{args.slo_ttft*1e3:.0f} ms, "
              f"{slo['tokens_per_s_per_device']:.0f} tok/s/device, "
              f"decode-gap p99 {slo['decode_gap_p99_s']*1e3:.2f} ms, "
              f"{slo['preemptions']} preemption(s)")
        for cls, row in sorted(slo["per_class"].items()):
            print(f"[edge]   class {cls}: "
                  f"{row['completed']}/{row['requests']} done, TTFT p50 "
                  f"{row['ttft_p50_s']*1e3:.2f} ms, {row['slo_attained']} "
                  f"in SLO, {row['preemptions']} preempted")
        fires = sum(1 for e in watchdog.alert_log if e["kind"] == "fire")
        print(f"[edge] watchdog: {fires} alert fire(s), "
              f"{len(watchdog.alert_log) - fires} clear(s) over "
              f"{len(watchdog.rules)} burn-rate rule(s)")
        metrics["traffic"] = {
            "process": tcfg.process, "seed": args.seed,
            "traffic_tasks": tcfg.num_tasks, "rate_rps": tcfg.rate_rps,
            "zipf_alpha": tcfg.zipf_alpha,
            "priority_classes": tcfg.priority_classes,
            "wall_s": wall, "generated": generated,
            "alerts": watchdog.report(),
            "tokens": [out[r.uid].tolist() for r in trace.requests], **slo}
    elif args.classify:
        hits = 0
        t0 = time.perf_counter()
        for i in range(args.requests):
            name, task, episode, prompt = tasks[i % len(tasks)]
            engine.seat_prefix(0, name)
            q, label = make_query(task, episode, prompt, rng)
            pred = engine.score_labels(np.empty((0,), np.int32), q,
                                       vocab.label_ids())
            hits += int(pred - vocab.label_base == label)
        dt = time.perf_counter() - t0
        print(f"[edge] {args.requests} label queries in {dt:.2f}s "
              f"({hits}/{args.requests} correct — untrained compressor)")
        metrics.update(queries=args.requests, correct=hits, serve_s=dt)
    else:
        # ragged prompts, round-robin over the tasks and priority classes
        # with --raw-shots each request carries its task's many-shot
        # context; the first per task starts the (deduped) online compile
        reqs = [Request(tokens=rng.integers(4, vocab.size,
                                            int(rng.integers(4, 12))),
                        max_new=args.max_new, prefix=tasks[i % len(tasks)][0],
                        raw_shots=(tasks[i % len(tasks)][3]
                                   if args.raw_shots else None),
                        priority=i % args.priority_classes)
                for i in range(args.requests)]
        _sync(device)
        t0 = time.perf_counter()
        out = engine.serve(reqs)
        _sync(device)
        dt = time.perf_counter() - t0
        generated = int(sum(len(v) for v in out.values()))
        tok_s = generated / dt
        print(f"[edge] served {args.requests} ragged requests "
              f"({args.tasks} compressed tasks, {args.slots} slots) in "
              f"{dt:.2f}s: {generated} tokens, {tok_s:.1f} tok/s, "
              f"attending to <= {m}+prompt slots/layer per request")
        metrics.update(requests=args.requests, generated=generated,
                       serve_s=dt, tokens_per_s=tok_s,
                       preemptions=engine.stats()["engine"]["preemptions"],
                       tokens=[out[r.uid].tolist() for r in reqs])
        if args.raw_shots:
            cs = engine.stats()["compiler"]
            print(f"[edge] online compile: {cs['jobs']} job(s), "
                  f"{cs['deduped']} deduped submit(s), {cs['chunks']} "
                  f"chunk(s) / {cs['tokens']} source tokens")
            metrics["compiler"] = cs
        if args.fused_step:
            es = engine.stats()["engine"]
            line = (f"[edge] fused: {es['fused_steps']} fused step(s), "
                    f"{es['fused_prefill_tokens']} prompt tokens streamed "
                    f"in {es['fused_prefill_chunks']} chunk(s), "
                    f"{es['fused_compile_chunks']} compile chunk(s) fused")
            if args.spec_k:
                line += (f"; speculative: {es['draft_accepted']}/"
                         f"{es['draft_proposed']} drafts accepted "
                         f"({es['accept_rate']:.0%})")
            print(line)
    if engine.tiers is not None:
        ts = engine.stats()["prefix_tiers"]
        print(f"[edge] prefix tiers: {ts['demotes']} demoted, "
              f"{ts['spills']} spilled, {ts['host_promotes']} promoted "
              f"({ts['disk_loads']} from disk), {ts['hbm_resident']} / "
              f"{ts['host_resident']} / {ts['disk_resident']} resident in "
              "HBM / host / disk")
        metrics["prefix_tiers"] = ts
    if args.kv_layout == "paged":
        pool = engine.stats()["pool"]
        print(f"[edge] paged pool: {pool['blocks_used']}/"
              f"{pool['num_blocks']} blocks of {pool['block_size']} in use")
        metrics["pool"] = pool
    if args.stats:
        stats = engine.stats()
        print("[stats]", json.dumps(stats, indent=1))
        metrics["stats"] = stats
    if args.trace_out and lead:
        path = tracer.dump(args.trace_out)
        n = len(tracer.events())
        print(f"[edge] trace -> {path} ({n} event(s)"
              + (f", {tracer.dropped} dropped by the flight recorder"
                 if tracer.dropped else "") + ")")
    if args.metrics_out and lead:
        parent = os.path.dirname(args.metrics_out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.metrics_out, "w") as f:
            f.write(engine.metrics.render_prometheus())
        print(f"[edge] prometheus metrics -> {args.metrics_out}")
    if args.metrics and lead:
        with open(args.metrics, "w") as f:
            json.dump(metrics, f, indent=1)
        print(f"metrics -> {args.metrics}")
    if http_server is not None:
        if args.http_linger:
            print(f"[edge] http telemetry lingering {args.http_linger:g}s "
                  f"on 127.0.0.1:{http_server.bound_port}", flush=True)
            time.sleep(args.http_linger)
        http_server.stop()
    return metrics


if __name__ == "__main__":
    main()
