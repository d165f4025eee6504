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
``--priority-classes N`` puts request i in class i % N (a queued class
preempts a running lower one); ``--priority-aging S`` lifts a queued
request one class for every S seconds it waits.

The device is the card unless ``--device cpu`` is given; without a card
the launcher raises.  The online compiler, the tiers, the fused step, the
traffic harness, meshes and telemetry are later slices of the port.
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
    device = resolve_device(args.device)

    vocab = SyntheticVocab()
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch)).replace(vocab_size=vocab.size)
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
                           priority_aging_s=args.priority_aging)

    tasks, payload = [], 0
    _sync(device)
    t0 = time.perf_counter()
    for t in range(args.tasks):
        task = ICLTaskSpec(vocab, num_labels=8, keys_per_label=4)
        episode = make_episode(task, rng)
        prompt = build_manyshot_prompt(task, episode, rng,
                                       budget=args.context_tokens)
        prefix, _ = memcom.compress(
            compressor, cfg, torch.as_tensor(prompt[None], device=device))
        kv = materialize_prefix(target, cfg, prefix)
        engine.add_prefix(f"task{t}", kv)
        payload += sum(x.numel() * x.element_size()
                       for entry in kv for x in entry.values())
        tasks.append((f"task{t}", task, episode, prompt))
    _sync(device)
    t_compress = time.perf_counter() - t0
    print(f"[cloud] compressed {args.tasks}x{args.context_tokens} tokens "
          f"-> {m} slots/layer each in {t_compress:.2f}s; "
          f"payload {payload/1e3:.1f} KB total")
    metrics = {"arch": cfg.name, "device": str(device), "m": m,
               "tasks": args.tasks, "slots": args.slots,
               "kv_layout": args.kv_layout,
               "context_tokens": args.context_tokens,
               "compress_s": t_compress, "payload_bytes": payload}

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
        reqs = [Request(tokens=rng.integers(4, vocab.size,
                                            int(rng.integers(4, 12))),
                        max_new=args.max_new, prefix=tasks[i % len(tasks)][0],
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
                       preemptions=engine.counters["preemptions"])
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
