#!/usr/bin/env python3
"""Device time of the ``memcom_xattn`` backward at the training shapes, for
one tree of the port, on one NVIDIA card.

    python3 scripts/xattn_bwd_times.py [--tree DIR] [--json-out PATH]
        [--quick]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
builds its kernels there, so that one machine can time two trees, for
example a parent commit unpacked with ``git archive`` and this one, in
the order parent, change, change, parent.  Shapes (B x M x T x D, bf16):
gemma2-2b's Phase-1 call 2x512x3072x2304, granite-moe-3b-a800m's width
1x512x3072x1536 and mistral-7b's 1x768x6144x4096 (no training path runs
the last two yet), then ragged ones (checked only).  Each bf16 backward
kernel the tree has (``variant=`` where its wrapper takes one; a tree
whose backward takes no out and lse is called the old way) is first held
to ``plain.memcom_xattn_bwd_ref`` (``plain.grad_err`` at most 2e-2 per
gradient), the wgmma variant also to ``plain.memcom_xattn_bwd_tiled`` in
bf16 steps (``plain.bf16_ulps``; beside it, how far the restatement
without its rounding of P and dS lands), and its D_i (read back from the
workspace, ``mx.wgmma_bwd_pieces``) against the float32 rowsum(P o dP)
of the exact P; then each is timed by CUDA-graph replay: 21 calls
rotating through three input sets, so that no call finds its inputs in
the 50 MB L2.  Last, a few eager calls under ``torch.profiler`` give the
device time of each launch of a call in launch order (the mma.sync
variant's six: S, dP, the row pass, dQ, dK, dV; the wgmma variant's
three: D_i, S / dP, the gradients).  ``--quick`` checks without timing.
Prints the card's name and power limit, the ``-Xptxas -v`` lines of the
build, one line per measurement, and a JSON line last.  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2
# name, B, M, T, D, timed
SHAPES = [("memory_xattn_bwd", 2, 512, 3072, 2304, True),
          ("granite_memory_xattn_bwd", 1, 512, 3072, 1536, True),
          ("mistral_memory_xattn_bwd", 1, 768, 6144, 4096, True),
          ("ragged_rows", 2, 40, 300, 256, False),
          ("ragged_both", 1, 17, 99, 64, False)]
LAUNCHES = {"mma_sync": ("S", "dP", "rows", "dQ", "dK", "dV"),
            "wgmma": ("D_i", "S/dP", "grads")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="check every shape, time none")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("xattn_bwd_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, plain
    from repro_torch.kernels import memcom_xattn as mx

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build_all(["memcom_xattn"])
    for ln in build.ptxas_report("memcom_xattn"):
        if any(w in ln for w in ("registers", "spill", "Compiling",
                                 "warning")):
            print(f"  {ln}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the restatements: f32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    new = hasattr(mx, "bwd_variant_for")  # takes out, lse and variant=
    variants = ("wgmma", "mma_sync") if new else ("mma_sync",)

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(
            torch.bfloat16)

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

    def bwd(vn):
        def call(q, k, v, dout, out, lse):
            if not new:
                return mx.memcom_xattn_bwd(q, k, v, dout)
            return mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant=vn)
        return call

    rows, timed = [], []
    for name, B, M, T, D, t in SHAPES:
        sets = []
        for _ in range(3 if t and not args.quick else 1):
            q, dout = rand(B, M, D), rand(B, M, D)
            k, v = rand(B, T, D), rand(B, T, D)
            if new:
                out, lse = mx.memcom_xattn(q, k, v, return_lse=True)
            else:
                out, lse = mx.memcom_xattn(q, k, v), None
            sets.append((q, k, v, dout, out, lse))
        q, k, v, dout, out, lse = sets[0]
        want = plain.memcom_xattn_bwd_ref(q, k, v, dout)
        tiled = unrounded = None
        if new:
            f32 = [x.float() for x in (q, k, v, out)]
            nsplit = mx.bwd_num_splits(B, M, T, D, sms)
            tiled = plain.memcom_xattn_bwd_tiled(
                *f32, lse, dout.float(), splits=nsplit)
            unrounded = [plain.bf16_ulps(w, tt) for w, tt in zip(
                plain.memcom_xattn_bwd_tiled(*f32, lse, dout.float(),
                                             round_p=False, splits=nsplit),
                tiled)]
            print(f"{name}: the restatement without its rounding of P and "
                  "dS from the one with it, bf16 steps dq/dk/dv "
                  + " / ".join(f"{u:.3f}" for u in unrounded), flush=True)
        for vn in variants:
            if new and not mx.bwd_takes(vn, q.dtype, B, M, T, D, True):
                continue
            got = bwd(vn)(*sets[0])
            torch.cuda.synchronize()
            row = {"shape": name, "variant": vn,
                   "grad_err": [plain.grad_err(g, w)
                                for g, w in zip(got, want)]}
            line = (f"{name} {vn}: grad_err dq/dk/dv "
                    + " / ".join(f"{e:.3e}" for e in row["grad_err"]))
            if new:
                row["workspace_bytes"] = mx.bwd_workspace_bytes(
                    B, M, T, q.dtype, vn)
                line += f", workspace {row['workspace_bytes']} bytes"
            if vn == "wgmma":
                row["nsplit"] = nsplit
                row["unrounded_ulps"] = unrounded
                row["tiled_ulps"] = [plain.bf16_ulps(g, tt)
                                     for g, tt in zip(got, tiled)]
                # D_i from the bf16 O against rowsum(P o dP) of the exact
                # P, both float32
                di = mx.wgmma_bwd_pieces(q, k, v, out, lse, dout)[5]
                qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
                p = torch.softmax(torch.einsum("bmd,btd->bmt", qf, kf)
                                  * D ** -0.5, dim=-1)
                exact = (p * torch.einsum("bmd,btd->bmt", gf, vf)).sum(-1)
                del p
                row["di_err"] = float((di - exact).abs().max())
                row["di_rms"] = float(exact.pow(2).mean().sqrt())
                line += (f", {nsplit} split(s), bf16 steps from the tiled "
                         "restatement " + " / ".join(
                             f"{u:.3f}" for u in row["tiled_ulps"])
                         + f", D_i max abs err {row['di_err']:.3e} (rms of "
                         f"D_i {row['di_rms']:.3e})")
            print(line, flush=True)
            if max(row["grad_err"]) > TOL:
                raise AssertionError(f"{name} {vn}: disagrees with "
                                     "plain.memcom_xattn_bwd_ref")
            if t and not args.quick:
                row["device_ms"] = device_ms(bwd(vn), sets)
                flops = 10 * B * M * T * D
                row["tflops"] = flops / row["device_ms"] / 1e9
                print(f"  device {row['device_ms']:.4f} ms "
                      f"({row['tflops']:.1f} TFLOP/s)", flush=True)
                timed.append((row, bwd(vn), sets))
            rows.append(row)
            del got
        del want, tiled
    # each launch of a call by its device time, after every timing (a
    # profiler session slows the launches that follow it in one process)
    for row, fn, sets in timed:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                fn(*sets[i])
                torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and "elementwise" not in ev.name
                      and "fill" not in ev.name.lower()),
                     key=lambda ev: ev.time_range.start)
        names = LAUNCHES[row["variant"]]
        per = len(names)
        if len(evs) != 3 * per:
            print(f"{row['shape']} {row['variant']}: {len(evs)} kernels in "
                  f"3 calls, not {3 * per}: "
                  + ", ".join(sorted({ev.name[:40] for ev in evs})))
            continue
        split = {n: sum(evs[c * per + i].time_range.elapsed_us()
                        for c in range(3)) / 3e3
                 for i, n in enumerate(names)}
        row["launches_ms"] = split
        row["launch_kernels"] = [evs[i].name[:80] for i in range(per)]
        print(f"{row['shape']} {row['variant']} launches: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in split.items()) + " ms ("
            + "; ".join(row["launch_kernels"]) + ")", flush=True)
    result = {"card": card, "rows": rows}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
