#!/usr/bin/env python3
"""Device time of the flash-attention backward at the training shapes, for
one tree of the port, on one NVIDIA card.

    python3 scripts/flash_bwd_times.py [--tree DIR] [--json-out PATH]
        [--quick | --time-only]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
builds its kernels there, so that one machine can time two trees, for
example a parent commit unpacked with ``git archive`` and this one, in
the order parent, change, change, parent.  Shapes (bf16): gemma2-2b's
three training calls (2x512 at 8/4 heads of 256, cap 50: the Memory-LLM's
causal self-attention, the prompt's at offset 512 and the prompt against
the 512 memory rows, both with an lse cotangent), the 3072-token source
(Phase 2), granite's and mistral-7b's widths, fully-masked rows and
ragged tiles (checked only).  Each bf16 backward kernel the tree has
(``variant=`` where its wrapper takes one) is first held to
``plain.attention_bwd_ref`` (``plain.grad_err`` at most 2e-2 per gradient;
queries that see no key and keys that no query sees exactly 0), the
wgmma variant also to ``plain.attention_bwd_tiled`` in bf16 steps
(``plain.bf16_ulps`` over the rows above ``plain.GRAD_NOISE_FLOOR``),
then timed by CUDA-graph replay: 21 calls rotating through three input
sets, so that no call finds its inputs in the 50 MB L2.  Last, a few
eager calls under ``torch.profiler`` give each kernel's device time by
name.  ``--quick`` checks without timing; ``--time-only`` times without
checking, for copies of a kernel cut down to find where its time goes.
Prints the card's name and
power limit, the ``-Xptxas -v`` lines of the backward's build, one line
per measurement, and a JSON line last.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2
# name, B, Sq, Skv, Hq, Hkv, D, cap, q layout, dlse, timed
SHAPES = [
    ("memory_self", 2, 512, 512, 8, 4, 256, 50.0, "causal", False, True),
    ("prompt_self", 2, 512, 512, 8, 4, 256, 50.0, "offset", True, True),
    ("prompt_prefix", 2, 512, 512, 8, 4, 256, 50.0, "prefix", True, True),
    ("source", 1, 3072, 3072, 8, 4, 256, 50.0, "causal", False, True),
    ("granite_memory_self", 2, 512, 512, 24, 8, 64, 0.0, "causal", False,
     True),
    ("mistral_memory_self", 2, 512, 512, 32, 8, 128, 0.0, "causal", False,
     True),
    ("masked_rows", 2, 40, 70, 8, 4, 256, 50.0, "masked", True, False),
    ("ragged_g3", 1, 170, 150, 24, 8, 64, 0.5, "causal", True, False),
    ("ragged_prefix", 1, 200, 130, 32, 8, 128, 0.5, "prefix", False, False),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="check every shape, time none")
    ap.add_argument("--time-only", action="store_true",
                    help="time the timed shapes, check none")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, plain
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build_all(["flash_attention", "flash_attention_bwd"])
    for ln in build.ptxas_report("flash_attention_bwd"):
        if any(w in ln for w in ("registers", "spill", "Compiling",
                                 "warning")):
            print(f"  {ln}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the restatements: f32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = (("wgmma", "mma_sync") if hasattr(fa, "bwd_variant_for")
                else (None,))

    def rand(*shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtype)

    def positions(B, Sq, Skv, layout):
        ar = lambda lo, n: (lo + torch.arange(  # noqa: E731
            n, dtype=torch.int32, device=dev)).expand(B, n).contiguous()
        if layout == "causal":
            return ar(0, Sq), ar(0, Skv), True
        if layout == "offset":
            return ar(512, Sq), ar(512, Skv), True
        if layout == "prefix":
            return ar(512, Sq), ar(0, Skv), False
        kv = ar(0, Skv).clone()
        kv[:, 5:9] = -1
        return ar(-8, Sq), kv, True

    def device_ms(fn, sets, reps=21):
        calls = iter(range(reps + 1))

        def one():
            return fn(*sets[next(calls) % len(sets)])

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
        del graph
        return e0.elapsed_time(e1) / reps

    def above_floor(g, t):
        t32 = t.float()
        keep = t32.pow(2).mean(dim=-1).sqrt() >= (
            plain.GRAD_NOISE_FLOOR * t32.pow(2).mean().sqrt())
        return plain.bf16_ulps(g[keep], t[keep])

    def bwd(vn, kw):
        def call(q, k, v, dout, out, lse, dlse):
            if vn is None:
                return fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse,
                                              **kw)
            return fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse,
                                          variant=vn, **kw)
        return call

    rows, timed = [], []
    for name, B, Sq, Skv, Hq, Hkv, D, cap, layout, with_dlse, t in SHAPES:
        if args.time_only and not t:
            continue
        q_pos, kv_pos, causal = positions(B, Sq, Skv, layout)
        kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, softcap=cap)
        sets = []
        for _ in range(3 if t and not args.quick else 1):
            q, k, v, dout = (rand(B, n, h, D) for n, h in (
                (Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq)))
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            live = (lse > plain.NEG_INF / 2).float()
            dlse = (rand(B, Sq, Hq, dtype=torch.float32) * live
                    if with_dlse else None)
            sets.append((q, k, v, dout, out, lse, dlse))
        if args.time_only:
            for vn in variants:
                row = {"shape": name, "variant": vn or "default",
                       "device_ms": device_ms(bwd(vn, kw), sets)}
                print(f"{name} {row['variant']}: device "
                      f"{row['device_ms']:.4f} ms", flush=True)
                rows.append(row)
            continue
        q, k, v, dout, out, lse, dlse = sets[0]
        want = plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse, **kw)
        seen = (kv_pos[:, None, :] >= 0).expand(B, Sq, Skv)
        if causal:
            seen = seen & (kv_pos[:, None, :] <= q_pos[:, :, None])
        dead = (~seen.any(dim=2), ~seen.any(dim=1), ~seen.any(dim=1))
        # the restatement from the same bf16 inputs, summed and returned
        # in float32: a kernel that rounds as it says lies 0.5 steps off
        tiled = (plain.attention_bwd_tiled(
            *(x.float() for x in (q, k, v, out)), lse, dout.float(), dlse,
            split_at=fa.bwd_split_at(B, Sq, Skv, Hq, Hkv, D, causal, sms),
            **kw)
            if "wgmma" in variants else None)
        if tiled is not None:  # how far a kernel without the roundings lands
            unrounded = [above_floor(g, tt) for g, tt in zip(want, tiled)]
            print(f"{name}: plain.attention_bwd_ref (P and dS unrounded) "
                  "from the tiled restatement, bf16 steps dq/dk/dv "
                  + " / ".join(f"{u:.3f}" for u in unrounded), flush=True)
        for vn in variants:
            got = bwd(vn, kw)(*sets[0])
            torch.cuda.synchronize()
            row = {"shape": name, "variant": vn or "default",
                   "grad_err": [plain.grad_err(g, w)
                                for g, w in zip(got, want)],
                   "dead_zero": all(not g[d].any()
                                    for g, d in zip(got, dead))}
            if vn == "wgmma":
                row["unrounded_ulps"] = unrounded
                row["tiled_ulps"] = [above_floor(g, tt)
                                     for g, tt in zip(got, tiled)]
                row["tiled_ulps_all_rows"] = [plain.bf16_ulps(g, tt)
                                              for g, tt in zip(got, tiled)]
            ok = max(row["grad_err"]) <= TOL and row["dead_zero"]
            print(f"{name} {row['variant']}: grad_err dq/dk/dv "
                  + " / ".join(f"{e:.3e}" for e in row["grad_err"])
                  + f", dead rows 0: {row['dead_zero']}"
                  + (", bf16 steps from tiled (rows above the floor; all "
                     "rows) " + " / ".join(
                         f"{a:.3f} ({b:.3f})" for a, b in zip(
                             row["tiled_ulps"], row["tiled_ulps_all_rows"]))
                     if vn == "wgmma" else ""), flush=True)
            if not ok:
                raise AssertionError(f"{name} {vn}: disagrees with "
                                     "plain.attention_bwd_ref")
            if t and not args.quick:
                row["device_ms"] = device_ms(bwd(vn, kw), sets)
                print(f"  device {row['device_ms']:.4f} ms", flush=True)
                timed.append((row, bwd(vn, kw), sets))
            rows.append(row)
            del got
        del want, tiled, seen, dead
    # kernels by name, after every timing (a profiler session slows the
    # launches that follow it in one process)
    for row, fn, sets in timed:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                fn(*sets[i])
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.time_range.elapsed_us() / 3e3)
        row["kernels_ms"] = by_name
        print(f"{row['shape']} {row['variant']} kernels: " + ", ".join(
            f"{n[:60]} {ms:.4f}" for n, ms in sorted(by_name.items())),
              flush=True)
    result = {"card": card, "rows": rows}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
