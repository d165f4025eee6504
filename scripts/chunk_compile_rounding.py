#!/usr/bin/env python3
"""How far a chunked (online) compile of one many-shot task lies from the
one-shot compress, at mistral-7b's full width in bf16, on one NVIDIA card.

    python3 scripts/chunk_compile_rounding.py [--chunk 512] [--json-out PATH]

Weights from seeds, one 6144-token task.  Each variant's O^i (and the
Source-LLM's layer inputs H^i) is set against the one-shot
``memcom.compress`` by ``plain.scaled_err`` per layer:

* ``chunked``: ``memcom.compress_chunked`` as the online compiler runs it
  (one causal flash call a chunk over the cached keys and its own);
* ``prefill_continuation``: the same chunks through the engine's prefill
  continuation (``decode=False``: the chunk's causal call and a call
  against the cached keys, merged by their log-sum-exp), which is how the
  JAX package computes a chunk;
* ``mma_sync`` / ``plain``: the one-shot compress with flash forced to its
  mma.sync kernel, and through every kernel's plain version: the spread
  between two roundings of one function.

Prints the card's name and power limit, one line per variant and a JSON
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
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chunk_compile_rounding: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import memcom
    from repro_torch.data import (ICLTaskSpec, SyntheticVocab,
                                  build_manyshot_prompt, make_episode)
    from repro_torch.kernels import build, ops, plain
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tfm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build_all()
    cfg = get_config("mistral-7b")
    target = tfm.init_params(cfg, 0)
    mc = memcom.init_memcom(cfg, target, 1)
    rng = np.random.default_rng(24)
    task = ICLTaskSpec(SyntheticVocab(), num_labels=8, keys_per_label=4)
    src = torch.as_tensor(build_manyshot_prompt(
        task, make_episode(task, rng), rng, budget=6144)[None],
        device="cuda")
    T = src.shape[1]

    def captured(fn):
        """(O^i, the Source-LLM's H^i) of one compress ``fn``."""
        caps, inner = [], memcom._memory

        def spy(mc_, cfg_, hiddens, remat=False):
            caps.append(hiddens)
            return inner(mc_, cfg_, hiddens, remat)

        memcom._memory = spy
        try:
            prefix, _ = fn()
        finally:
            memcom._memory = inner
        return [e["h"] for e in prefix], caps[0]

    def continuation():
        """The chunks through the prefill continuation (decode=False)."""
        state = memcom.begin_compress(cfg, 1, T, mc=mc)
        with torch.no_grad():
            for lo in range(0, T, args.chunk):
                _, aux = mc.source(tokens=src[:, lo:lo + args.chunk],
                                   capture_hiddens=True, cache=state.cache,
                                   cache_index=lo, mask_offset=lo,
                                   logits=False)
                state.hiddens.append(aux["hiddens"])
        return memcom.finish_compress(mc, cfg, state)

    def forced_mma_sync():
        picked = fa.variant_for
        fa.variant_for = lambda *a, **k: "mma_sync"
        try:
            return memcom.compress(mc, cfg, src)
        finally:
            fa.variant_for = picked

    def plain_versions():
        ops.set_default_impl("torch")
        try:
            return memcom.compress(mc, cfg, src)
        finally:
            ops.set_default_impl(None)

    one = captured(lambda: memcom.compress(mc, cfg, src))
    report = {"card": card, "chunk": args.chunk, "tokens": T}
    for name, fn in (
            ("one_shot_again", lambda: memcom.compress(mc, cfg, src)),
            ("chunked", lambda: memcom.compress_chunked(
                mc, cfg, src, chunk_size=args.chunk)),
            ("prefill_continuation", continuation),
            ("mma_sync", forced_mma_sync), ("plain", plain_versions)):
        omega, hid = captured(fn)
        o_err = [plain.scaled_err(a, b) for a, b in zip(omega, one[0])]
        h_err = [plain.scaled_err(a, b) for a, b in zip(hid, one[1])]
        equal = all(torch.equal(a, b) for a, b in zip(omega, one[0]))
        report[name] = {"omega_scaled_err": o_err, "hidden_scaled_err": h_err,
                        "bitwise_equal": equal}
        pick = (0, 8, 16, 24, cfg.num_layers - 1)
        print(f"{name}: O^i scaled err max {max(o_err):.3e} (layers "
              f"{pick}: {[f'{o_err[i]:.2e}' for i in pick]}), bitwise "
              f"equal {equal}; H^i scaled err (layers {pick}): "
              f"{[f'{h_err[i]:.2e}' for i in pick]}", flush=True)
        del omega, hid
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: (v if not isinstance(v, dict) else
                          {"omega_max": max(v["omega_scaled_err"]),
                           "bitwise_equal": v["bitwise_equal"]})
                      for k, v in report.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
