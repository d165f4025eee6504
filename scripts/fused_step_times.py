#!/usr/bin/env python3
"""Time of one serving step of gemma2-2b at full width: the engine's
classic decode step against its fused step at lane widths 1, 4 and 16,
on one NVIDIA card.

    python3 scripts/fused_step_times.py [--reps N] [--json-out PATH]
    python3 scripts/fused_step_times.py --traced [--reps N] [--json-out PATH]

Builds gemma2-2b (26 layers, bf16, weights from seed 0) and a dense
engine with ``fused_step=True`` over 4 slots of max_len 568 (the shapes
of ``chip_smoke.py``'s gemma2-2b path), the slots' lengths at 516-524.
Each step function is called as the serve loop calls it, ending in its
one host sync: the classic step (``_decode_step``, one lane a slot) and
the fused step (``_fused_program``) at W = 1, 4 and 16, once with every
lane valid and once as a join (three slots decode one lane, the fourth
streams W prompt tokens).  Per step: the host time over ``--reps`` warm
calls (median), and from ``torch.profiler`` over 5 calls the kernels
launched, the device busy time (the union of the kernels' intervals) and
the idle share.  Prints the card's name and power limit, one line per
step, and a JSON line last.  Exits non-zero without a card.

``--traced`` times the tracer instead: 8 requests (prompts of 4-33
tokens, budgets of 8-16, no prefix) served over the 4 slots by a classic
and a fused dense engine, each ``--reps`` times in the order off, on, on,
off (tracer off: the default no-op; on: a ``Tracer`` whose recording
calls are timed).  Per engine and mode: the serve's host ms a decode step
(median over the serves), and with the tracer on its own host ms a step
and its events a step; the tokens of every serve must be the same.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLOTS, MAX_LEN = 4, 568
LENGTHS = [520, 523, 516, 524]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--traced", action="store_true",
                    help="time the serve loop with the tracer off and on")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_step_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Request, ServingEngine, Tracer
    from repro_torch.serving.telemetry import NULL_TRACER

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = get_config("gemma2-2b")
    target = tfm.init_params(cfg, 0)
    if args.traced:
        return traced(args, card, cfg, target, np, torch, Request,
                      ServingEngine, Tracer, NULL_TRACER)
    eng = ServingEngine(cfg, target, slots=SLOTS, max_len=MAX_LEN,
                        fused_step=True)
    rng = np.random.default_rng(0)
    lengths = np.asarray(LENGTHS, np.int64)
    steps = {"classic": lambda: eng._decode_step(
        rng.integers(4, 1000, SLOTS).astype(np.int32), lengths, True)}
    for W in (1, 4, 16):
        for kind, valid in (("all", [W] * SLOTS), ("join", [1, 1, 1, W])):
            fn = eng._fused_program(W, True, None)
            toks = rng.integers(4, 1000, (SLOTS, W)).astype(np.int64)
            steps[f"fused_w{W}_{kind}"] = (
                lambda fn=fn, toks=toks, valid=valid: fn(
                    toks, lengths, np.asarray(valid, np.int32), None))

    out = {"card": card}
    with torch.no_grad():
        for name, fn in steps.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                fn()
                walls.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            busy, end = 0.0, float("-inf")
            for lo, hi in sorted((e.time_range.start, e.time_range.end)
                                 for e in kernels):
                busy += max(0.0, hi - max(lo, end))
                end = max(end, hi)
            row = {"host_ms_median": 1e3 * statistics.median(walls),
                   "host_ms_min": 1e3 * min(walls),
                   "kernels_per_step": len(kernels) / 5,
                   "device_busy_ms_per_step": busy / 1e3 / 5,
                   "idle_share": max(0.0, 1 - busy / 1e6 / wall)}
            out[name] = row
            print(f"{name}: host {row['host_ms_median']:.2f} ms a step "
                  f"(min {row['host_ms_min']:.2f}), "
                  f"{row['kernels_per_step']:.0f} kernels, device busy "
                  f"{row['device_busy_ms_per_step']:.3f} ms, idle share "
                  f"{row['idle_share']:.3f}", flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


def traced(args, card, cfg, target, np, torch, Request, ServingEngine,
           Tracer, NULL_TRACER) -> int:
    class TimedTracer(Tracer):
        """Sums the host seconds its recording calls take."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.host_s = 0.0

        def _timed(name):
            def call(self, *a, **k):
                t0 = time.perf_counter()
                getattr(Tracer, name)(self, *a, **k)
                self.host_s += time.perf_counter() - t0
            return call

        span = _timed("span")
        instant = _timed("instant")
        begin_async = _timed("begin_async")
        end_async = _timed("end_async")
        del _timed

    rng = np.random.default_rng(25)
    specs = [dict(tokens=rng.integers(4, 1000, n).astype(np.int32),
                  max_new=b)
             for n, b in zip((4, 9, 12, 7, 20, 33, 26, 17),
                             (16, 12, 8, 14, 16, 10, 16, 12))]
    out = {"card": card, "reps": args.reps}
    with torch.no_grad():
        for name, kw in (("classic", {}), ("fused", dict(
                fused_step=True, fused_chunk_tokens=16))):
            eng = ServingEngine(cfg, target, slots=SLOTS, max_len=MAX_LEN,
                                **kw)
            eng.serve([Request(**x) for x in specs])  # warm-up
            rows = {"off": [], "on": []}
            tokens = []
            for _ in range(args.reps):
                for mode in ("off", "on", "on", "off"):
                    tr = TimedTracer(clock=eng.clock) if mode == "on" \
                        else NULL_TRACER
                    eng.tracer = tr
                    eng.reset_stats()
                    reqs = [Request(**x) for x in specs]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = eng.serve(reqs)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    steps = eng.stats()["engine"]["decode_steps"]
                    tokens.append([res[r.uid].tolist() for r in reqs])
                    rows[mode].append({
                        "ms_per_step": 1e3 * wall / steps,
                        "tracer_ms_per_step": (1e3 * tr.host_s / steps
                                               if mode == "on" else 0.0),
                        "events_per_step": (len(tr.events()) / steps
                                            if mode == "on" else 0.0)})
            eng.tracer = NULL_TRACER
            if any(t != tokens[0] for t in tokens):
                print(f"{name}: the tracer changed the tokens",
                      file=sys.stderr)
                return 1
            row = {}
            for mode, rs in rows.items():
                for k in rs[0]:
                    row[f"{k}_{mode}"] = statistics.median(r[k] for r in rs)
            row["decode_steps"] = steps
            out[name] = row
            print(f"{name}: host {row['ms_per_step_off']:.2f} ms a step with "
                  f"the tracer off, {row['ms_per_step_on']:.2f} on; the "
                  f"tracer's own {row['tracer_ms_per_step_on']:.4f} ms a step"
                  f" ({row['events_per_step_on']:.1f} events a step, "
                  f"{steps} steps a serve); tokens identical", flush=True)
            del eng
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
