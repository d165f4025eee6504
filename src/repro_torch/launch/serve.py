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

The device is the card unless ``--device cpu`` is given; without a card
the launcher raises.  A config without MemCom (the attention-free
mamba2-370m) exits with a message before any model is built, as the JAX
launcher does: its entry point is ``ServingEngine`` itself.  The fused
step, the traffic harness, meshes and telemetry are later slices of the
port.
"""

from __future__ import annotations

import argparse
import json
import time  # reprolint: ignore-file[wall-clock] -- the launcher reports real compress/serve seconds to its operator; nothing replays them

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import memcom
from repro_torch.data import (ICLTaskSpec, SyntheticVocab,
                              build_manyshot_prompt, make_episode, make_query)
from repro_torch.models import transformer as tfm
from repro_torch.serving import Request, ServingEngine, materialize_prefix


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    ap.add_argument("--metrics", default=None,
                    help="write the run's numbers as JSON to this path")
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
    if args.raw_shots and args.classify:
        ap.error("--raw-shots serves generation traffic (classify goes "
                 "through the offline seat path)")
    device = resolve_device(args.device)

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
    engine = ServingEngine(cfg, target, slots=args.slots,
                           max_len=m + 24 + args.max_new + 16, device=device,
                           kv_layout=args.kv_layout, block_size=args.block_size,
                           num_blocks=args.num_blocks,
                           prefix_capacity=args.prefix_capacity,
                           compressor=compressor if args.raw_shots else None,
                           compile_token_budget=args.compile_budget,
                           host_capacity=args.host_capacity,
                           disk_dir=args.disk_dir,
                           promote_layer_budget=args.promote_budget,
                           priority_aging_s=args.priority_aging)
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
    for t in range(args.tasks):
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
    if args.raw_shots:
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
               "promote_budget": args.promote_budget}

    if args.classify:
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
                       preemptions=engine.counters["preemptions"],
                       tokens=[out[r.uid].tolist() for r in reqs])
        if args.raw_shots:
            cs = engine.stats()["compiler"]
            print(f"[edge] online compile: {cs['jobs']} job(s), "
                  f"{cs['deduped']} deduped submit(s), {cs['chunks']} "
                  f"chunk(s) / {cs['tokens']} source tokens")
            metrics["compiler"] = cs
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
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(metrics, f, indent=1)
        print(f"metrics -> {args.metrics}")
    return metrics


if __name__ == "__main__":
    main()
