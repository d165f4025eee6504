#!/usr/bin/env python3
"""Device time of the wgmma ``gmm`` backward kernel (``gmm_bwd_wgmma`` in
``csrc/moe_gmm.cu``) at each output tile it could use, on one NVIDIA card:
the probe behind the tile rule of ``launch_bwd_wgmma_for``.

    python3 scripts/gmm_bwd_tiles.py [--json-out PATH]

For each tile (rows x columns: 256 x 128 on four consumer warpgroups, 128
x 128 on two, 64 x 128 on one, 256 x 128 and 256 x 192 on two with two
64-row blocks each; each with the deepest cp.async ring that fits an SM)
the source is copied with the rule replaced by that one tile, built with
``nvcc`` (one process each, in parallel) into the git-ignored
``kernels/build/``, and its dX = dY Wᵀ and dW = Xᵀ dY are timed at
granite-moe-3b-a800m's training shapes (bf16, E = 40, D 1536 <-> F 512,
C = 256 and 1536) by CUDA-graph replay over three input sets, after a
check against ``plain.gmm_bwd_ref`` (``plain.grad_err`` at most 2e-2).
``torch.bmm`` on the same inputs is timed the same way.  Prints the
card's name and power limit, one line per measurement, and a JSON line
last.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (64-row consumer warpgroups, 64-row blocks each, columns)
TILES = ((4, 1, 128), (2, 1, 128), (1, 1, 128), (2, 2, 128), (2, 2, 192))
E, WIDE, NARROW = 40, 1536, 512
SHAPES = [(C, D, F) for C in (256, 1536)
          for D, F in ((WIDE, NARROW), (NARROW, WIDE))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gmm_bwd_tiles: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    src = (build.CSRC / "moe_gmm.cu").read_text()
    rule = re.compile(r"(int launch_bwd_wgmma_for\(.*?\{\n  if \(M == 0 \|\| "
                      r"N == 0\) return cudaSuccess;\n).*?(\n\})", re.S)
    out_dir = build.BUILD / "gmm_bwd_tiles"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for nwg, rb, bn in TILES:
        body = ("  int dev = 0, sms = 0;\n  cudaGetDevice(&dev);\n"
                "  cudaDeviceGetAttribute(&sms, "
                "cudaDevAttrMultiProcessorCount, dev);\n"
                f"  return launch_bwd_wgmma<{nwg}, {rb}, {bn}, DW>("
                "a, b, out, E, M, N, K, sms, st);")
        text, n = rule.subn(lambda m: m.group(1) + body + m.group(2), src)
        if n != 1:
            raise RuntimeError("launch_bwd_wgmma_for not found in the source")
        cu = out_dir / f"moe_gmm_{64 * nwg * rb}x{bn}_{nwg}wg.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[(nwg, rb, bn)] = (subprocess.Popen(
            [build.nvcc(), *build.FLAGS, f"-I{build.CSRC}", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    fns = {}
    for tile, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {tile} failed:\n{log}")
        fn = ctypes.CDLL(str(lib)).moe_gmm_bwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tile] = fn

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

    def call(fn, part):
        def run(x, w, dy):
            out = torch.empty_like(x if part == "dx" else w)
            err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                     out.data_ptr() if part == "dx" else None,
                     out.data_ptr() if part == "dw" else None,
                     E, x.shape[1], x.shape[2], w.shape[2], 1, 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return out
        return run

    rows = []
    for C, D, F in SHAPES:
        bufs = [(rand(E, C, D), rand(E, D, F, scale=D ** -0.5),
                 rand(E, C, F)) for _ in range(3)]
        want = plain.gmm_bwd_ref(*bufs[0])
        for part in ("dx", "dw"):
            row = {"part": part, "C": C, "D": D, "F": F}
            for tile, fn in fns.items():
                run = call(fn, part)
                e = plain.grad_err(run(*bufs[0]), want[part == "dw"])
                if e > 2e-2:
                    raise AssertionError(f"{tile} {part} C={C} {D}->{F}: "
                                         f"error {e:.3e}")
                nwg, rb, bn = tile
                row[f"{64 * nwg * rb}x{bn}/{nwg}wg"] = device_ms(
                    run, bufs)
            lib = ((lambda x, w, d: torch.bmm(d, w.transpose(1, 2)))
                   if part == "dx" else
                   (lambda x, w, d: torch.bmm(x.transpose(1, 2), d)))
            row["torch.bmm"] = device_ms(lib, bufs)
            rows.append(row)
            print(f"{part} C={C} {D}->{F}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items()
                if isinstance(v, float)) + " ms", flush=True)
        del bufs, want
        torch.cuda.empty_cache()
    out = {"card": card, "rows": rows}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
