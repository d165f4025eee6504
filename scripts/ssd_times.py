#!/usr/bin/env python3
"""Device time of the Mamba2 SSD scan (``ssd``) forward and backward at
mamba2-370m's shapes, for one tree of the port, on one NVIDIA card.

    python3 scripts/ssd_times.py [--tree DIR] [--json-out PATH] [--time-only]
                                 [--variant NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
builds its kernels there, so that one machine can time two trees, for
example a parent commit unpacked with ``git archive`` and this one, in
the order parent, change, change, parent.  Shapes (bf16, 32 heads of 64,
N 128, G 1): the forward at the serving prefill (1 x 3084, an initial
state) and at training (2 x 3072, none), and, where the tree has
``ssd_scan.ssd_bwd``, the backward at training (no final-state
cotangent) and with an initial state and a final-state cotangent, with
each backward kernel the tree has (``ssd_scan.bwd_variant_for``'s
``"chunked"`` and ``"sequential"``; a tree without it has one, reported
as ``"sequential"``), or only the one ``--variant`` names, and the
chosen kernel's workspace bytes.  Each
call is first held to the plain version (``plain.scaled_err`` /
``plain.grad_err`` at most 2e-2 per output), then timed by CUDA-graph
replay: 21 calls rotating through three input sets, so that no call
reads its inputs from the 50 MB L2.  No PyTorch call runs the scan, so
there is no library yardstick.  Prints the card's name and power limit,
one line per measurement, and a JSON line last.  Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2
H, P, N, G = 32, 64, 128, 1
# part, B, S, initial state (forward) / initial state and dhf (backward)
CASES = [("fwd", 1, 3084, True), ("fwd", 2, 3072, False),
         ("bwd", 2, 3072, False), ("bwd", 1, 3084, True)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--time-only", action="store_true",
                    help="time every shape, check none")
    ap.add_argument("--variant", default=None,
                    help="time only this backward kernel (chunked, "
                         "sequential)")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ssd_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import plain
    from repro_torch.kernels import ssd_scan as ss

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape, scale=0.5, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def inputs(B, S, init):
        """As a seeded Mamba2 layer makes dt and A; C·B of order 1."""
        return (rand(B, S, H, P), F.softplus(rand(B, S, H, scale=1.0,
                                                  dtype=torch.float32)),
                -torch.exp(torch.rand(H, generator=gen, device=dev) * 2 - 1),
                rand(B, S, G, N, scale=0.5 * N ** -0.25),
                rand(B, S, G, N, scale=0.5 * N ** -0.25),
                rand(B, H, P, N, dtype=torch.float32) if init else None,
                rand(B, S, H, P),
                rand(B, H, P, N, dtype=torch.float32) if init else None)

    def device_ms(fn, bufs, reps=21):
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
        del graph
        return e0.elapsed_time(e1) / reps

    def fwd(x, dt, A, Bm, Cm, h0, dy, dhf):
        return ss.ssd(x, dt, A, Bm, Cm, init_state=h0)

    has_variants = hasattr(ss, "bwd_variant_for")
    variants = ["chunked", "sequential"] if has_variants else ["sequential"]
    if args.variant:
        variants = [v for v in variants if v == args.variant]

    def bwd_for(variant):
        kw = {"variant": variant} if has_variants else {}

        def bwd(x, dt, A, Bm, Cm, h0, dy, dhf):
            return ss.ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dhf, **kw)
        return bwd

    rows = []
    cases = [(part, B, S, init, v) for part, B, S, init in CASES
             for v in ([None] if part == "fwd" else variants)]
    for part, B, S, init, variant in cases:
        if part == "bwd" and not hasattr(ss, "ssd_bwd"):
            continue
        bufs = [inputs(B, S, init) for _ in range(3)]
        fn = fwd if part == "fwd" else bwd_for(variant)
        row = {"part": part, "B": B, "S": S, "H": H, "P": P, "N": N,
               "init_state": init}
        if part == "fwd":
            row["variant"] = ss.variant_for(torch.bfloat16, S, P, N, True)
        else:
            row["variant"] = variant
            ws_kw = {"variant": variant} if has_variants else {}
            row["workspace_bytes"] = ss.bwd_workspace_bytes(
                B, S, H, P, N, torch.bfloat16, **ws_kw)
        if not args.time_only:
            a = bufs[0]
            got = fn(*a)
            if part == "fwd":
                want = plain.ssd_ref(*a[:5], init_state=a[5])
                e = max(plain.scaled_err(g, w) for g, w in zip(got, want))
            else:
                want = plain.ssd_bwd_ref(*a)
                e = max(plain.grad_err(g, w) for g, w in zip(got, want)
                        if w is not None)
            row["err"] = e
            if part == "bwd":
                again = fn(*a)
                row["bit_identical"] = all(
                    g is None or torch.equal(g, h) for g, h in zip(got, again))
                if not row["bit_identical"]:
                    raise AssertionError(f"ssd bwd {B}x{S} {variant}: a "
                                         "second call differs")
                del again
            if e > TOL:
                raise AssertionError(f"ssd {part} {B}x{S}: error {e:.3e} > "
                                     f"{TOL}")
            del got, want
        row["device_ms"] = device_ms(fn, bufs)
        rows.append(row)
        print(f"{part} {B}x{S} {row['variant']} (initial state {init}): "
              f"device {row['device_ms']:.4f} ms"
              + (f", workspace {row['workspace_bytes']} bytes"
                 if "workspace_bytes" in row else "")
              + (f", err {row['err']:.3e}" if "err" in row else ""),
              flush=True)
        del bufs
        torch.cuda.empty_cache()
    out = {"card": card, "tree": str(Path(args.tree).resolve()),
           "rows": rows}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
