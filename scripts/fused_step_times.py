#!/usr/bin/env python3
"""Time of one serving step of gemma2-2b at full width: the engine's
classic decode step against its fused step at lane widths 1, 4 and 16,
on one NVIDIA card.

    python3 scripts/fused_step_times.py [--reps N] [--json-out PATH]

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
    from repro_torch.serving import ServingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = get_config("gemma2-2b")
    target = tfm.init_params(cfg, 0)
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


if __name__ == "__main__":
    sys.exit(main())
