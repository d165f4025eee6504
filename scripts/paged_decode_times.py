#!/usr/bin/env python3
"""Device time of ``paged_flash_decode`` at chip_smoke.py's paged shapes,
for one tree of the port, on one NVIDIA card.

    python3 scripts/paged_decode_times.py [--tree DIR] [--json-out PATH]
        [--splits N,N,...]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
builds its kernel there, so that one machine can time two trees, for
example a parent commit unpacked with ``git archive`` and this one, in
the order parent, change, change, parent.  Each shape (bf16, the inputs
chip_smoke.py draws for it) is first held to ``plain.paged_decode_
attention_ref`` (max abs error and ``plain.scaled_err`` at most 2e-2),
then timed by CUDA-graph replay: two calls per input set, rotating
through input sets whose K/V rows add up past 60 MB, so that no call
finds its rows in the 50 MB L2; then the same calls, run eagerly under
``torch.profiler``, give each kernel's device time by name (the decode
kernel and the merge of its splits).  ``--splits`` times the tree's
kernel again at each given split count in place of ``num_splits``'s
(trees that state ``paged_attention.num_splits``).  Prints the card's
name and power limit, one line per shape, and a JSON line last.  Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2
M, MAX_LEN, SLOTS = 512, 568, 4   # chip_smoke.py's memory rows, max_len
MAIN = [M + 8, M + 11, M + 4, M + 12]
SHAPES = [
    # name, B, S, Hq, Hkv, D, block size, lengths, shared blocks, softcap,
    # table positions
    ("decode", SLOTS, 1, 8, 4, 256, 16, MAIN, M // 16, 50.0, MAX_LEN),
    ("decode_s3", SLOTS, 3, 8, 4, 256, 16, MAIN, M // 16, 50.0, MAX_LEN),
    ("block8_boundary", SLOTS, 1, 8, 4, 256, 8, [M, M + 8, 8, 1], 0, 50.0,
     MAX_LEN),
    ("block12", SLOTS, 1, 8, 4, 256, 12, MAIN, M // 12, 50.0, MAX_LEN),
    ("mistral_width", SLOTS, 1, 32, 8, 128, 16, MAIN, M // 16, 50.0,
     MAX_LEN),
    ("granite_decode", SLOTS, 1, 24, 8, 64, 16, MAIN, M // 16, 0.0, MAX_LEN),
    ("long_table", SLOTS, 1, 8, 4, 256, 16, MAIN, M // 16, 50.0, 4096),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--splits", default="",
                    help="comma-separated split counts to time as well")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("paged_decode_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * 0.5).to(torch.bfloat16)

    def inputs(B, S, Hq, Hkv, D, bs, lengths, share, table):
        nb = -(-table // bs)
        N = 1 + B * nb
        order = torch.randperm(N - 1, generator=gen, device=dev) + 1
        tables = torch.zeros((B, nb), dtype=torch.int32, device=dev)
        for b, n in enumerate(lengths):
            used = -(-n // bs)
            tables[b, :used] = order[b * nb:b * nb + used].to(torch.int32)
            if share and b >= 2:
                tables[b, :share] = tables[b - 2, :share]
        return (rand(B, S, Hq, D), rand(N, bs, Hkv, D), rand(N, bs, Hkv, D),
                tables, torch.tensor(lengths, dtype=torch.int32, device=dev))

    def device_ms(fn, bufs, reps):
        calls = iter(range(reps + 1))

        def one():
            return fn(*bufs[next(calls) % len(bufs)])

        one()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                one()
        graph.replay()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernel_ms(fn, bufs):
        """Device ms per call of each kernel, by name, over one eager call
        per input set."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for b in bufs:
                fn(*b)
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by[e.name[:40]] = (by.get(e.name[:40], 0.0)
                                   + e.time_range.elapsed_us() / 1e3
                                   / len(bufs))
        return by

    def timed(bufs, sets, cap):
        fn = (lambda q_, k_, v_, t_, l_: pa.paged_flash_decode(  # noqa: E731
            q_, k_, v_, block_tables=t_, lengths=l_, softcap=cap))
        return device_ms(fn, bufs, 2 * sets), kernel_ms(fn, bufs)

    splits = [int(x) for x in args.splits.split(",") if x]
    rows = []
    for name, B, S, Hq, Hkv, D, bs, lengths, share, cap, table in SHAPES:
        first = inputs(B, S, Hq, Hkv, D, bs, lengths, share, table)
        q, kp, vp, tables, lens = first
        kw = dict(block_tables=tables, lengths=lens, softcap=cap)
        out = pa.paged_flash_decode(q, kp, vp, **kw)
        ref = plain.paged_decode_attention_ref(q, kp, vp, **kw)
        e = float((out.float() - ref.float()).abs().max())
        se = plain.scaled_err(out, ref)
        if not (e <= TOL and se <= TOL):
            raise AssertionError(f"{name}: max abs err {e:.3e}, scaled "
                                 f"{se:.3e}")
        # the K/V rows one call reads: each distinct (block, offset) once
        tab = tables.tolist()
        visible = {(tab[b][i // bs], i % bs)
                   for b, n in enumerate(lengths) for i in range(n)}
        nbytes = len(visible) * Hkv * D * 2 * 2
        sets = -(-60_000_000 // nbytes)
        bufs = [first] + [inputs(B, S, Hq, Hkv, D, bs, lengths, share, table)
                          for _ in range(sets - 1)]
        ms, by = timed(bufs, sets, cap)
        row = {"shape": name, "device_ms": ms, "sets": sets,
               "kernel_ms": by, "max_abs_err": e, "scaled_err": se}
        print(f"  {name}: device {ms:.5f} ms over {sets} input sets ("
              + ", ".join(f"{k} {v:.5f}" for k, v in by.items())
              + f"); max abs err {e:.3e}, scaled {se:.3e}", flush=True)
        for n in splits:
            native = pa.num_splits
            pa.num_splits = lambda *shape: n  # noqa: E731
            try:
                row[f"device_ms_split{n}"], by = timed(bufs, sets, cap)
            finally:
                pa.num_splits = native
            print(f"    {n} splits: device {row[f'device_ms_split{n}']:.5f} ("
                  + ", ".join(f"{k} {v:.5f}" for k, v in by.items()) + ")",
                  flush=True)
        rows.append(row)
        del first, bufs, out, ref
        torch.cuda.empty_cache()
    result = {"tree": str(Path(args.tree).resolve()), "card": card,
              "shapes": rows}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
