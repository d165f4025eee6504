#!/usr/bin/env python3
"""Device time of ``memcom_xattn`` at the compressor's shapes, for one tree
of the port, on one NVIDIA card.

    python3 scripts/xattn_times.py [--tree DIR] [--json-out PATH]
        [--splits N,N,...]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
builds its kernel there, so that one machine can time two trees, for
example a parent commit unpacked with ``git archive`` and this one, in
the order parent, change, change, parent.  Shapes (B x M x T x D, bf16):
gemma2-2b's 1x512x3072x2304 and granite-moe-3b-a800m's 1x512x3072x1536
(the compress path's), and mistral-7b's 1x768x6144x4096 (a probe: no main
path runs it).  Each bf16 kernel the tree has (``variant=`` where its
wrapper takes one) is first held to ``plain.memcom_xattn_ref`` (max abs
error and ``plain.scaled_err`` at most 2e-2), then timed by CUDA-graph
replay: 21 calls rotating through three input sets (30-107 MB each), so
that no call finds its inputs in the 50 MB L2; then a few calls, run
eagerly under ``torch.profiler``, give each kernel's device time by name
(the passes of the three-pass kernel, the two of the wgmma one).
The wgmma variant is also set against ``plain.memcom_xattn_tiled``, its
own arithmetic, in units of bf16's spacing (``plain.bf16_ulps``): from
the restatement in float32, from its bf16 result, and the restatement
without its two roundings of P, from the one with them (how far a kernel
that skipped them would land); then the two passes apart, from the
pieces the first leaves in the workspace (``mx.wgmma_pieces``): m_j, l_j
and P~ against ``plain.memcom_xattn_tiled_pieces``, and the output
against ``plain.memcom_xattn_tiled_out`` on the kernel's own pieces.  ``--splits`` times the wgmma variant again at each
given split count in place of ``num_splits``'s.
Prints the card's name and power limit, one line per measurement, and a
JSON line last.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2
SHAPES = [("memory_xattn", 1, 512, 3072, 2304),
          ("granite_memory_xattn", 1, 512, 3072, 1536),
          ("mistral_memory_xattn", 1, 768, 6144, 4096)]


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
        print("xattn_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import plain
    from repro_torch.kernels import memcom_xattn as mx

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the restatements: f32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    has_variants = hasattr(mx, "variant_for")
    variants = ("wgmma", "mma_sync") if has_variants else (None,)

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * 0.5).to(torch.bfloat16)

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

    def check(out, ref, what):
        e = float((out.float() - ref.float()).abs().max())
        se = plain.scaled_err(out, ref)
        if not (e <= TOL and se <= TOL):
            raise AssertionError(f"{what}: max abs err {e:.3e}, scaled "
                                 f"{se:.3e} (tol {TOL:g})")
        return e, se

    def call(v):
        if v is None:
            return mx.memcom_xattn
        return lambda q, k, vv: mx.memcom_xattn(q, k, vv, variant=v)

    rows = []
    for name, B, M, T, D in SHAPES:
        sets = [(rand(B, M, D), rand(B, T, D), rand(B, T, D))
                for _ in range(3)]
        ref = plain.memcom_xattn_ref(*sets[0])
        flops = 4 * B * M * T * D
        for v in variants:
            out = call(v)(*sets[0])
            torch.cuda.synchronize()
            e, se = check(out, ref, f"{name} {v}")
            row = {"shape": name, "variant": v or "default",
                   "max_abs_err": e, "scaled_err": se,
                   "device_ms": device_ms(call(v), sets)}
            if v == "wgmma":
                n = mx.num_splits(B, M, T, D)
                row["nsplit"] = n
                tiled = plain.memcom_xattn_tiled(*sets[0], splits=n)
                row["tiled_err"] = float((out.float() - tiled.float())
                                         .abs().max())
                row["tiled_scaled_err"] = plain.scaled_err(out, tiled)
                f32 = [x.float() for x in sets[0]]
                tiled32 = plain.memcom_xattn_tiled(*f32, splits=n)
                row["tiled32_ulps"] = plain.bf16_ulps(out, tiled32)
                row["tiled_ulps"] = plain.bf16_ulps(out, tiled)
                row["unrounded_ulps"] = plain.bf16_ulps(
                    plain.memcom_xattn_tiled(*f32, splits=n, round_p=False),
                    tiled32)
                # the two passes apart, from the kernel's own workspace
                o, p, m, l = mx.wgmma_pieces(*sets[0])
                pr, mr, lr = plain.memcom_xattn_tiled_pieces(*sets[0][:2])
                row["m_diff"] = float((m - mr).abs().max())
                row["l_rel_diff"] = float(((l - lr) / lr).abs().max())
                row["p_off_share"] = float((p != pr).float().mean())
                row["own_pass2_ulps"] = plain.bf16_ulps(
                    o, plain.memcom_xattn_tiled_out(p, m, l, sets[0][2],
                                                    splits=n))
                row["max_abs_logit"] = float(mr.abs().max())
                del f32, tiled32, o, p, m, l, pr, mr, lr
            # per-kernel device time by name, 3 eager calls
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(3):
                    call(v)(*sets[i])
                torch.cuda.synchronize()
            by_name = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    us, cnt = by_name.get(ev.name, (0.0, 0))
                    by_name[ev.name] = (us + ev.time_range.elapsed_us(),
                                        cnt + 1)
            row["kernels_ms"] = {k: us / 1e3 / 3 for k, (us, _) in
                                 by_name.items()}
            row["tflops"] = flops / row["device_ms"] / 1e9
            rows.append(row)
            print(f"{name} {row['variant']}: device {row['device_ms']:.4f} ms "
                  f"({row['tflops']:.0f} TFLOP/s), err {e:.3e} / scaled "
                  f"{se:.3e}" + (f", nsplit {row['nsplit']}, tiled err "
                                 f"{row['tiled_err']:.3e} / scaled "
                                 f"{row['tiled_scaled_err']:.3e}, ulps "
                                 f"from tiled f32 {row['tiled32_ulps']:.4f} "
                                 f"/ bf16 {row['tiled_ulps']:.4f}, unrounded "
                                 f"{row['unrounded_ulps']:.4f}; m_j "
                                 f"{row['m_diff']:.3e} (max |S| "
                                 f"{row['max_abs_logit']:.2f}), l_j rel "
                                 f"{row['l_rel_diff']:.3e}, P~ off "
                                 f"{row['p_off_share']:.2e}, output pass "
                                 f"on its own pieces "
                                 f"{row['own_pass2_ulps']:.4f}"
                                 if v == "wgmma" else ""), flush=True)
            for k, ms in sorted(row["kernels_ms"].items()):
                print(f"    {ms:.4f} ms  {k[:90]}", flush=True)
        counts = [int(x) for x in args.splits.split(",") if x]
        nk = -(-T // 64)
        saved = mx.num_splits if has_variants else None
        try:
            for n in counts if has_variants else ():
                if -(-nk // n) > mx.SPLIT_SLABS_MAX:
                    continue
                mx.num_splits = lambda *a, n=n, **kw: n
                out = call("wgmma")(*sets[0])
                torch.cuda.synchronize()
                e, se = check(out, ref, f"{name} {n} splits")
                ms = device_ms(call("wgmma"), sets)
                rows.append({"shape": name, "variant": "wgmma", "nsplit": n,
                             "device_ms": ms, "max_abs_err": e,
                             "scaled_err": se})
                print(f"{name} wgmma nsplit {n}: device {ms:.4f} ms, err "
                      f"{e:.3e} / {se:.3e}", flush=True)
        finally:
            if has_variants:
                mx.num_splits = saved
        del sets, ref
        torch.cuda.empty_cache()

    result = {"card": card, "tree": args.tree, "rows": rows}
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
