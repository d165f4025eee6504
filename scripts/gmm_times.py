#!/usr/bin/env python3
"""Device time of the grouped matmul (``gmm``) forward and backward at
granite-moe-3b-a800m's shapes, for one tree of the port, on one NVIDIA
card.

    python3 scripts/gmm_times.py [--tree DIR] [--json-out PATH] [--time-only]
                                 [--variant NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout) and
builds its kernels there, so that one machine can time two trees, for
example a parent commit unpacked with ``git archive`` and this one, in
the order parent, change, change, parent.  Shapes (bf16, E = 40 experts,
D 1536 <-> F 512 in both orientations): the forward at C = 768 (the
source prefill), 256 (training's Memory-LLM and prompt), 128 (the
Memory-LLM at serving) and 8 (decode), and, where the tree has
``moe_gmm.gmm_bwd``, the backward's two products (dX = dY Wᵀ, dW = Xᵀ dY)
at C = 256 and 1536 (the training source), with each backward kernel the
tree has (``moe_gmm.bwd_variant_for``'s ``"wgmma"`` and ``"mma_sync"``;
a tree without it has one, reported as ``"mma_sync"``), or only the one
``--variant`` names.  Each call is first held to
the plain version (``plain.scaled_err`` / ``plain.grad_err`` at most
2e-2), then timed by CUDA-graph replay: 21 calls rotating through three
input sets (63 MB of weights each), so that no call reads its weights
from the 50 MB L2; ``torch.bmm`` on the same inputs is timed the same way
as a yardstick.  Prints the card's name and power limit, one line per
measurement, and a JSON line last.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOL = 2e-2
E, WIDE, NARROW = 40, 1536, 512
FWD_C = (768, 256, 128, 8)
BWD_C = (256, 1536)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--time-only", action="store_true",
                    help="time every shape, check none")
    ap.add_argument("--variant", default=None,
                    help="time only this backward kernel (wgmma, mma_sync)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gmm_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

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

    rows = []
    has_bwd = hasattr(gm, "gmm_bwd")
    variants = ["wgmma", "mma_sync"] if hasattr(gm, "bwd_variant_for") \
        else ["mma_sync"]
    if args.variant:
        variants = [v for v in variants if v == args.variant]
    for D, F in ((WIDE, NARROW), (NARROW, WIDE)):
        cases = [("fwd", C, None) for C in FWD_C]
        cases += [(part, C, v) for C in BWD_C for part in ("dx", "dw")
                  for v in variants if has_bwd]
        for part, C, variant in cases:
            bufs = [(rand(E, C, D), rand(E, D, F, scale=D ** -0.5),
                     rand(E, C, F)) for _ in range(3)]
            kw = {"variant": variant} if hasattr(gm, "bwd_variant_for") \
                and variant else {}
            if part == "fwd":
                def fn(x, w, dy):
                    return gm.gmm(x, w)

                def lib(x, w, dy):
                    return torch.bmm(x, w)
            elif part == "dx":
                def fn(x, w, dy, kw=kw):
                    return gm.gmm_bwd(x, w, dy, need_dw=False, **kw)[0]

                def lib(x, w, dy):
                    return torch.bmm(dy, w.transpose(1, 2))
            else:
                def fn(x, w, dy, kw=kw):
                    return gm.gmm_bwd(x, w, dy, need_dx=False, **kw)[1]

                def lib(x, w, dy):
                    return torch.bmm(x.transpose(1, 2), dy)
            row = {"part": part, "E": E, "C": C, "D": D, "F": F}
            if variant:
                row["variant"] = variant
            if not args.time_only:
                x, w, dy = bufs[0]
                got = fn(x, w, dy)
                if part == "fwd":
                    want = plain.gmm_ref(x, w)
                    e = plain.scaled_err(got, want)
                else:
                    want = plain.gmm_bwd_ref(x, w, dy)[part == "dw"]
                    e = plain.grad_err(got, want)
                row["err"] = e
                if part != "fwd":
                    again = fn(x, w, dy)
                    row["bit_identical"] = bool(torch.equal(got, again))
                    if not row["bit_identical"]:
                        raise AssertionError(f"gmm {part} C={C} {D}->{F} "
                                             f"{variant}: a second call "
                                             "differs")
                if e > TOL:
                    raise AssertionError(f"gmm {part} C={C} {D}->{F}: "
                                         f"error {e:.3e} > {TOL}")
            row["device_ms"] = device_ms(fn, bufs)
            row["library_device_ms"] = device_ms(lib, bufs)
            rows.append(row)
            print(f"{part} C={C} {D}->{F}"
                  + (f" {variant}" if variant else "")
                  + f": device {row['device_ms']:.4f} ms, "
                  f"torch.bmm {row['library_device_ms']:.4f} ms"
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
