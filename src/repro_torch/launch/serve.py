"""Offline compression + compressed-cache serving behind one CLI
(``repro/launch/serve.py``, the offline path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --smoke --requests 6 --tasks 2 --slots 4 --max-new 8 --device cpu

Stages:
  1. "cloud": initialise the target and the compressor from seeds,
     compress each ICL task's many-shot context once, materialize the
     per-layer compressed KV through the frozen target projections, and
     register it in the engine's PrefixStore.
  2. "edge": the lock-step dense ServingEngine seats each request's task
     memory in its own slot and serves ragged generate requests
     (``--classify``: ICL label queries) in waves of ``--slots``; a short
     last wave fills its idle slots with copies of its own requests and
     drops their output.

The device is the card unless ``--device cpu`` is given; without a card
the launcher raises.  The scheduler with mid-decode refill, the paged
layout, the online compiler, the tiers, the fused step, the traffic
harness, meshes and telemetry are later slices of the port.
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
from repro_torch.serving import ServingEngine, materialize_prefix


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch kernels)")
    ap.add_argument("--metrics", default=None,
                    help="write the run's numbers as JSON to this path")
    args = ap.parse_args(argv)
    if args.tasks < 1 or args.slots < 1 or args.requests < 1:
        ap.error("--tasks, --slots and --requests must all be >= 1")
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
                           max_len=m + 24 + args.max_new + 16, device=device)

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
        reqs = [(rng.integers(4, vocab.size, int(rng.integers(4, 12))),
                 tasks[i % len(tasks)][0]) for i in range(args.requests)]
        generated = 0
        _sync(device)
        t0 = time.perf_counter()
        for w in range(0, len(reqs), args.slots):
            wave = reqs[w:w + args.slots]
            filled = [wave[i % len(wave)] for i in range(args.slots)]
            engine.generate([p for p, _ in filled], args.max_new,
                            prefixes=[name for _, name in filled])
            generated += len(wave) * args.max_new
        _sync(device)
        dt = time.perf_counter() - t0
        tok_s = generated / dt
        print(f"[edge] served {args.requests} ragged requests "
              f"({args.tasks} compressed tasks, {args.slots} slots) in "
              f"{dt:.2f}s: {generated} tokens, {tok_s:.1f} tok/s, "
              f"attending to <= {m}+prompt slots/layer per request")
        metrics.update(requests=args.requests, generated=generated,
                       serve_s=dt, tokens_per_s=tok_s)
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(metrics, f, indent=1)
        print(f"metrics -> {args.metrics}")
    return metrics


if __name__ == "__main__":
    main()
