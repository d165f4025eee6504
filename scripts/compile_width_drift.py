#!/usr/bin/env python3
"""How far an online compile of one task lies from the offline compress
when its chunks change width, as the budget autotuner makes them, at
gemma2-2b's full width on one NVIDIA card.

    python3 scripts/compile_width_drift.py [--json-out PATH]

gemma2-2b (26 layers, bf16, weights from seeds 0 and 1) compresses one
3072-token many-shot task offline (one call) and then chunk by chunk
(``memcom.begin_compress`` / ``compress_chunk`` / ``finish_compress``,
the online compiler's steps) under several width schedules: fixed widths
(``--widths``) and ``--trail`` (default: halving from 512 to 1 and
doubling back, an autotuner's trail), each width used for one chunk
until the task is consumed.  Per schedule: ``plain.scaled_err`` of the
O^i and of the materialized K/V against the offline compress, and
whether they are bitwise equal, in three modes: the kernels as the
compiler runs them (``kernels``: each chunk's flash call unsplit and its
rows padded to ``memcom.CHUNK_ROWS``), the same without either
(``split_unpadded``: the chunk's flash call split as the wrapper's rule
splits it, its rows as they come), and every op on its plain PyTorch
version without padding (``plain``, against a plain offline compress).  Prints the
card's name and power limit, one line per (mode, schedule) and a JSON
line last.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--trail", default="512,256,128,64,32,16,8,4,2,1,2,4,"
                    "8,16,32,64,128,256,512",
                    help="chunk widths in order; the last repeats")
    ap.add_argument("--widths", default="512,256,200,128,64,16,1")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compile_width_drift: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import memcom
    from repro_torch.data import (ICLTaskSpec, SyntheticVocab,
                                  build_manyshot_prompt, make_episode)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, plain
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import materialize_prefix

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    vocab = SyntheticVocab()
    cfg = get_config("gemma2-2b").replace(vocab_size=vocab.size)
    target = tfm.init_params(cfg, 0)
    mc = memcom.init_memcom(cfg, target, 1)
    rng = np.random.default_rng(0)
    task = ICLTaskSpec(vocab, num_labels=8, keys_per_label=4)
    src = build_manyshot_prompt(task, make_episode(task, rng), rng,
                                budget=3072)
    tokens = torch.as_tensor(src[None], device="cuda")
    T = tokens.shape[1]

    def schedule(widths):
        out, lo, i = [], 0, 0
        while lo < T:
            w = min(widths[min(i, len(widths) - 1)], T - lo)
            out.append(w)
            lo += w
            i += 1
        return out

    def chunked(ws):
        state = memcom.begin_compress(cfg, 1, T, mc=mc)
        lo = 0
        for w in ws:
            state = memcom.compress_chunk(mc, cfg, state,
                                          tokens[:, lo:lo + w])
            lo += w
        return memcom.finish_compress(mc, cfg, state)[0]

    def kv(omega):
        return materialize_prefix(target, cfg, omega)

    def compare(a, b, keys):
        err = max(plain.scaled_err(x[k], y[k]) for x, y in zip(a, b)
                  for k in keys)
        same = all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                   for k in keys)
        return err, same

    schedules = {f"fixed_{w}": [int(w)] for w in args.widths.split(",")}
    schedules["trail"] = [int(w) for w in args.trail.split(",")]
    flash, pads = fa.flash_attention, memcom._pads_chunks

    def split(*a, variant=None, **k):
        return flash(*a, variant=None if variant == "unsplit" else variant,
                     **k)

    out = {"card": card, "T": T, "chunk_rows": memcom.CHUNK_ROWS}
    with torch.no_grad():
        for mode in ("kernels", "split_unpadded", "plain"):
            if mode != "kernels":
                memcom._pads_chunks = lambda *a: False
            if mode == "split_unpadded":
                fa.flash_attention = split
            if mode == "plain":
                ops.set_default_impl("torch")
            try:
                ref = memcom.compress(mc, cfg, tokens)[0]
                ref_kv = kv(ref)
                for name, widths in schedules.items():
                    ws = schedule(widths)
                    om = chunked(ws)
                    e_o, b_o = compare(om, ref, ("h",))
                    e_k, b_k = compare(kv(om), ref_kv, ("k", "v"))
                    row = {"chunks": len(ws), "omega_scaled_err": e_o,
                           "omega_bitwise": b_o, "kv_scaled_err": e_k,
                           "kv_bitwise": b_k}
                    out[f"{mode} {name}"] = row
                    print(f"{mode} {name}: {len(ws)} chunks, O^i scaled err "
                          f"{e_o:.3e} (bitwise {b_o}), K/V {e_k:.3e} "
                          f"(bitwise {b_k})", flush=True)
            finally:
                ops.set_default_impl(None)
                fa.flash_attention, memcom._pads_chunks = flash, pads
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
