#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json-out PATH]

Phases, each of which raises (and so exits non-zero) on failure:

1. The card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel of the main path from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, all started together) and print the
   build seconds and the ``-Xptxas -v`` register / shared-memory / spill
   lines.
3. Kernel phases: each kernel at the shapes the full-width gemma2-2b main
   path gives it, held against its plain PyTorch version on the card in
   float32 (TF32 off) and bfloat16, fully-masked query rows included: the
   max abs error is at most 1e-4 (float32) / 2e-2 (bfloat16), and every
   element's error at most 1e-4 / 2e-2 of its scale ``|ref| + rms of ref's
   row`` (``plain.scaled_err``; an output that averages V over thousands
   of keys is ~0.01, so only the scaled rule holds it in bfloat16: a
   dropped 32-key tile of the 3072-token prefill leaves the max abs error
   under 2e-2 and gives a scaled error near 0.5).  Times
   from CUDA events over warmed repeats: the kernel, its plain version,
   and one PyTorch library call as a yardstick the port never calls
   (``F.scaled_dot_product_attention``; it has no logit softcap, so at the
   softcapped shapes it computes the function without the cap).  The
   bound is max(operations / 989 TFLOP/s bf16, bytes / 3.35 TB/s) from
   this run's inputs, counting only the K/V rows some query can see.
4. ``paged_flash_decode`` (the paged decode attention) against
   ``plain.paged_decode_attention_ref`` in float32 (TF32 off) and bfloat16
   under the same rules: the main-path shape (q 4x1x8x256, pools of
   16-position blocks, lengths 516-524, slots 0/2 and 1/3 sharing the
   first 32 blocks of their task, shuffled tables), S = 3, block sizes 8
   and 12, a length of 1, lengths on block boundaries, fully-masked rows
   and the mistral-7b width (32/8 heads of 128).  Its bound counts each
   distinct (pool block, offset) position below some slot's length once
   (a prefix row two slots share is read once, a block's positions past
   the length not at all) plus q, out, tables and lengths; no single
   PyTorch call attends through a block table, so it has no library
   time.
5. The main path, end to end, at the full published width and depth of
   gemma2-2b in bfloat16, weights drawn from seeds, in two runs, each
   with every kernel's launch counter set to 0 just before and read just
   after; each kernel of the run must have been launched:
   a. dense: compress two 3072-token many-shot prompts to m = 512 memory
      tokens, materialize the prefixes, and serve 4 requests naming them
      (ragged 4-12-token prompts, 16 greedy tokens each) through
      ``ServingEngine.serve`` on the dense cache;
   b. paged: the same two tasks in a ``kv_layout="paged"`` engine (block
      size 16, 4 slots, max_len 568) that holds them as 2 x 32 shared
      blocks, serving 12 requests round-robin over the tasks (prompts of
      4-12 tokens, max_new 4-16) once free-running, then again, measured,
      with every third request stopping at the second token of its own
      free-running stream, so slots refill mid-decode; every request ends
      within its budget, a stopped one on its stop token, and some stop.
      Each request's first token equals the dense engine's for the same
      request (the prefill reads the same prefix rows either way).
6. Kernels vs plain end to end: the pipeline at full width and depth 2,
   once through the kernels and once forced to the plain versions
   (``ops.set_default_impl("torch")``): O^i and the first-step logits
   agree within 2e-2 of the reference's largest magnitude (bfloat16); then
   a paged engine with block size 12 (512 % 12 != 0, so the shared tail
   block is copied on write on the card) serves two 2-token requests on
   one task, two prefills and one decode step through
   ``paged_flash_decode``: the logits of every forward pass, read by a
   forward hook on the target, agree within the same bound.

The line before the last is ``{"kernels": [...]}``, one entry per kernel
at its costliest main-path shape, with every shape's numbers under
``"shapes"``; the last line is ``{"ok": true, "device": {...}}``.  Without
a card, or without the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
E2E_REL_TOL = 2e-2


def log(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None,
                    help="also write every measured number to this path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.config import LayerDesc, LayerLayout
    from repro_torch.configs import get_config
    from repro_torch.core import memcom
    from repro_torch.data import (ICLTaskSpec, SyntheticVocab,
                                  build_manyshot_prompt, make_episode)
    from repro_torch.kernels import build, ops, plain, registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import memcom_xattn as mx
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import (Request, ServingEngine,
                                     materialize_prefix)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {}

    # ---- 1. the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    report["card"] = card

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build_s {build_s:.2f}")
    for name in build.SOURCES:
        for ln in build.ptxas_report(name):
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                log(f"  {name}: {ln}")
    report["build_s"] = build_s

    # ---- 3. kernel phases ----------------------------------------------
    def cuda_ms(fn, reps=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape, dtype):
        x = torch.randn(shape, generator=gen, device=dev) * 0.5
        return x.to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    m = 512            # gemma2-2b memory tokens
    T = 3072           # many-shot source tokens
    prompt_len = 12    # the longest ragged prompt
    slots, max_new = 4, 16
    max_len = m + 24 + max_new + 16
    Hq, Hkv, D = 8, 4, 256

    def arange(lo, n):
        return lo + torch.arange(n, dtype=torch.int32, device=dev)

    lengths = torch.tensor([m + 8, m + 11, m + 4, m + 12], dtype=torch.int32,
                           device=dev)
    attn_cases = [
        # name, B, Sq, Skv, q_pos, kv_pos, causal
        ("source_prefill", 1, T, T, arange(0, T)[None], arange(0, T)[None],
         True),
        ("memory_self", 1, m, m, arange(0, m)[None], arange(0, m)[None], True),
        ("prompt_self", 1, prompt_len, prompt_len, arange(m, prompt_len)[None],
         arange(m, prompt_len)[None], True),
        ("prompt_prefix", 1, prompt_len, m, arange(m, prompt_len)[None],
         arange(0, m)[None], False),
        ("decode", slots, 1, max_len, (lengths - 1)[:, None],
         arange(0, max_len)[None].expand(slots, max_len).contiguous(), True),
        ("masked_rows", 2, 3, 64,
         torch.tensor([[-2, -1, 0], [2, 3, 4]], dtype=torch.int32, device=dev),
         arange(0, 64)[None].expand(2, 64).contiguous(), True),
    ]
    flash_rows = []
    for name, B, Sq, Skv, q_pos, kv_pos, causal in attn_cases:
        row = {"shape": name, "q": [B, Sq, Hq, D], "kv": [B, Skv, Hkv, D],
               "causal": causal, "softcap": 50.0}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            q = rand(B, Sq, Hq, D, dtype=dtype)
            k = rand(B, Skv, Hkv, D, dtype=dtype)
            v = rand(B, Skv, Hkv, D, dtype=dtype)
            kw = dict(q_pos=q_pos.contiguous(), kv_pos=kv_pos, causal=causal,
                      softcap=50.0, return_lse=True)
            out, lse = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref, ref_lse = plain.attention_ref(q, k, v, **kw)
            e, se = err(out, ref), plain.scaled_err(out, ref)
            live = ref_lse > plain.NEG_INF / 2
            e_lse = err(lse[live], ref_lse[live]) if bool(live.any()) else 0.0
            lse_tol = 1e-4 * max(1.0, float(ref_lse[live].abs().max())) \
                if bool(live.any()) else 0.0
            dead = ~live  # rows that see no key: out 0, lse -1e30
            dead_ok = bool((lse[dead] == plain.NEG_INF).all()) and (
                not bool(dead.any()) or float(out[dead].abs().max()) == 0.0)
            row[f"max_abs_err_{dn}"] = e
            row[f"scaled_err_{dn}"] = se
            row[f"lse_err_{dn}"] = e_lse
            log(f"flash_attention {name} {dn}: max_abs_err {e:.3e} "
                f"(tol {TOL[dn]:g}), scaled err {se:.3e} (tol "
                f"{REL_TOL[dn]:g}), lse err {e_lse:.3e}, masked rows "
                f"{int((~live).sum())} exact={dead_ok}")
            if not (e <= TOL[dn] and se <= REL_TOL[dn] and e_lse <= lse_tol
                    and dead_ok):
                raise AssertionError(f"flash_attention {name} {dn} disagrees "
                                     "with attention_ref")
            if dtype is torch.bfloat16 and name != "masked_rows":
                row["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
                row["plain_ms"] = cuda_ms(
                    lambda: plain.attention_ref(q, k, v, **kw), reps=3)
                mask = kv_pos[:, None, :] >= 0
                if causal:
                    mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
                else:
                    mask = mask.expand(B, Sq, Skv)
                pairs = int(mask.sum())
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                if name in ("source_prefill", "memory_self", "prompt_self"):
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        qt, kt, vt, is_causal=True, enable_gqa=True)
                else:
                    am = mask[:, None]
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        qt, kt, vt, attn_mask=am, enable_gqa=True)
                row["library_ms"] = cuda_ms(sdpa)
                flops = 4 * D * Hq * pairs
                # q read and out written once, the K/V rows some query
                # sees read once (decode skips the cache's unwritten tail),
                # positions read and lse written
                seen = int(mask.any(dim=1).sum())
                nbytes = 2 * q.numel() * 2 + seen * Hkv * D * 2 * 2 \
                    + 4 * (q_pos.numel() + kv_pos.numel() + B * Sq * Hq)
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} "
                    f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
            del q, k, v, out, lse, ref, ref_lse
        flash_rows.append(row)

    mx_row = {"shape": "memory_xattn", "q": [1, m, 2304],
              "kv": [1, T, 2304]}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        q = rand(1, m, 2304, dtype=dtype)
        k = rand(1, T, 2304, dtype=dtype)
        v = rand(1, T, 2304, dtype=dtype)
        out = mx.memcom_xattn(q, k, v)
        torch.cuda.synchronize()
        ref = plain.memcom_xattn_ref(q, k, v)
        e, se = err(out, ref), plain.scaled_err(out, ref)
        mx_row[f"max_abs_err_{dn}"] = e
        mx_row[f"scaled_err_{dn}"] = se
        log(f"memcom_xattn {dn}: max_abs_err {e:.3e} (tol {TOL[dn]:g}), "
            f"scaled err {se:.3e} (tol {REL_TOL[dn]:g})")
        if not (e <= TOL[dn] and se <= REL_TOL[dn]):
            raise AssertionError(f"memcom_xattn {dn} disagrees with "
                                 "memcom_xattn_ref")
        if dtype is torch.bfloat16:
            mx_row["ms"] = cuda_ms(lambda: mx.memcom_xattn(q, k, v))
            mx_row["plain_ms"] = cuda_ms(
                lambda: plain.memcom_xattn_ref(q, k, v), reps=3)
            mx_row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                       v[:, None]), reps=3)
            flops = 4 * m * T * 2304
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            mx_row["bound_ms"], mx_row["bound_by"] = bound(flops, nbytes)
            mx_row["flops"], mx_row["bytes"] = flops, nbytes
            mx_row["workspace_bytes"] = mx.workspace_bytes(1, m, T, dtype)
            log(f"  memory_xattn bf16: kernel {mx_row['ms']:.4f} ms, plain "
                f"{mx_row['plain_ms']:.4f} ms, sdpa {mx_row['library_ms']:.4f}"
                f" ms, bound {mx_row['bound_ms']:.4f} ms "
                f"({mx_row['bound_by']}), workspace "
                f"{mx_row['workspace_bytes']} bytes")
        del q, k, v, out, ref

    def paged_inputs(B, S, Hq, Hkv, Dh, bs, lengths, share, dtype):
        """Pools of shuffled blocks; slot b + 2 shares slot b's first
        ``share`` table entries (a task prefix seated in two slots);
        entries past a slot's length name block 0."""
        nb = -(-max_len // bs)
        N = 1 + B * nb
        order = torch.randperm(N - 1, generator=gen, device=dev) + 1
        tables = torch.zeros((B, nb), dtype=torch.int32, device=dev)
        for b, n in enumerate(lengths):
            used = -(-n // bs)
            tables[b, :used] = order[b * nb:b * nb + used].to(torch.int32)
            if share and b >= 2:
                tables[b, :share] = tables[b - 2, :share]
        return (rand(B, S, Hq, Dh, dtype=dtype), rand(N, bs, Hkv, Dh,
                                                      dtype=dtype),
                rand(N, bs, Hkv, Dh, dtype=dtype), tables,
                torch.tensor(lengths, dtype=torch.int32, device=dev))

    pm = m // 16  # prefix blocks of a task at block size 16
    paged_cases = [
        # name, B, S, Hq, Hkv, D, block size, lengths, shared blocks
        ("decode", slots, 1, Hq, Hkv, D, 16, [m + 8, m + 11, m + 4, m + 12],
         pm),
        ("decode_s3", slots, 3, Hq, Hkv, D, 16, [m + 8, m + 11, m + 4,
                                                 m + 12], pm),
        ("block8_boundary", slots, 1, Hq, Hkv, D, 8, [m, m + 8, 8, 1], 0),
        ("block12", slots, 1, Hq, Hkv, D, 12, [m + 8, m + 11, m + 4, m + 12],
         m // 12),
        ("masked_rows", 2, 3, Hq, Hkv, D, 16, [2, 40], 0),
        ("mistral_width", slots, 1, 32, 8, 128, 16, [m + 8, m + 11, m + 4,
                                                     m + 12], pm),
    ]
    paged_rows = []
    for name, B, S, hq, hkv, Dh, bs, lens, share in paged_cases:
        row = {"shape": name, "q": [B, S, hq, Dh], "block_size": bs,
               "lengths": lens, "shared_blocks": share, "softcap": 50.0}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            q, kp, vp, tables, lengths_t = paged_inputs(B, S, hq, hkv, Dh, bs,
                                                        lens, share, dtype)
            kw = dict(block_tables=tables, lengths=lengths_t, softcap=50.0)
            out = pa.paged_flash_decode(q, kp, vp, **kw)
            torch.cuda.synchronize()
            ref = plain.paged_decode_attention_ref(q, kp, vp, **kw)
            e, se = err(out, ref), plain.scaled_err(out, ref)
            dead = (lengths_t[:, None] - S + torch.arange(S, device=dev)[None]
                    < 0)
            dead_ok = not bool(dead.any()) or float(
                out[dead].float().abs().max()) == 0.0
            row[f"max_abs_err_{dn}"] = e
            row[f"scaled_err_{dn}"] = se
            log(f"paged_flash_decode {name} {dn}: max_abs_err {e:.3e} (tol "
                f"{TOL[dn]:g}), scaled err {se:.3e} (tol {REL_TOL[dn]:g}), "
                f"masked rows {int(dead.sum())} exact={dead_ok}")
            if not (e <= TOL[dn] and se <= REL_TOL[dn] and dead_ok):
                raise AssertionError(f"paged_flash_decode {name} {dn} "
                                     "disagrees with paged_decode_attention_ref")
            if dtype is torch.bfloat16 and name != "masked_rows":
                row["ms"] = cuda_ms(lambda: pa.paged_flash_decode(q, kp, vp,
                                                                  **kw))
                row["plain_ms"] = cuda_ms(
                    lambda: plain.paged_decode_attention_ref(q, kp, vp, **kw),
                    reps=3)
                row["library_ms"] = None  # no PyTorch call reads a table
                # the K/V rows read: each distinct (pool block, offset)
                # below some slot's length once (a shared prefix row is
                # read once, a block's unwritten tail never)
                tab = tables.tolist()
                visible = set()
                pairs = 0
                for b, n in enumerate(lens):
                    visible.update((tab[b][i // bs], i % bs) for i in range(n))
                    pairs += sum(max(0, n - S + r + 1) for r in range(S))
                flops = 4 * Dh * hq * pairs
                nbytes = (len(visible) * hkv * Dh * 2 * 2
                          + 2 * q.numel() * 2 + 4 * (tables.numel() + B))
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                row["distinct_rows"] = len(visible)
                row["distinct_blocks"] = len({blk for blk, _ in visible})
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f} ms, no library call, bound "
                    f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                    f"{len(visible)} distinct K/V rows in "
                    f"{row['distinct_blocks']} blocks, {nbytes} bytes)")
            del q, kp, vp, out, ref
        paged_rows.append(row)
    torch.cuda.empty_cache()

    # ---- 5. the main path at full width -------------------------------
    cfg = get_config("gemma2-2b")
    vocab = SyntheticVocab()
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    target = tfm.init_params(cfg, 0)
    compressor = memcom.init_memcom(cfg, target, 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in compressor.parameters()) \
        + sum(p.numel() for p in target.parameters())
    log(f"[init] {cfg.name}: {n_params / 1e9:.3f} B parameters over target, "
        f"source, memory and memx in {time.perf_counter() - t0:.1f}s")
    sources = []
    for _ in range(2):
        task = ICLTaskSpec(vocab, num_labels=8, keys_per_label=4)
        sources.append(build_manyshot_prompt(task, make_episode(task, rng),
                                             rng, budget=T))
    prompts = [rng.integers(4, vocab.size, n).astype(np.int32)
               for n in (4, 9, prompt_len, 7)]
    engine = ServingEngine(cfg, target, slots=slots, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def set_counts():
        fa.launches = mx.launches = pa.launches = 0

    def counts():
        return {"flash_attention": fa.launches, "memcom_xattn": mx.launches,
                "paged_flash_decode": pa.launches}

    def serve_numbers(eng, reqs, out, wall, before):
        """Serve seconds, decode rate over the decode steps (each ends in
        the step's one host sync) and time to first token per request.
        The engine's counters add up over its life: ``before`` is their
        copy from just before this serve."""
        c = {k: eng.counters[k] - before[k] for k in
             ("tokens_generated", "decode_time_s", "decode_steps")}
        ttft = [eng.request_log[r.uid]["first_token_s"]
                - eng.request_log[r.uid]["arrival_s"] for r in reqs]
        return {"serve_s": wall,
                "tokens": int(sum(len(v) for v in out.values())),
                "decode_tok_s": c["tokens_generated"] / c["decode_time_s"],
                "decode_steps": c["decode_steps"],
                "decode_step_ms": 1e3 * c["decode_time_s"] / c["decode_steps"],
                "slots_per_step": c["tokens_generated"] / c["decode_steps"],
                "ttft_mean_s": float(np.mean(ttft)),
                "ttft_max_s": float(np.max(ttft))}

    set_counts()
    t0 = time.perf_counter()
    prefixes, task_s = [], []
    for t, src in enumerate(sources):
        t1 = time.perf_counter()
        prefix, _ = memcom.compress(compressor, cfg,
                                    torch.as_tensor(src[None], device=dev))
        kv = materialize_prefix(target, cfg, prefix)
        engine.add_prefix(f"task{t}", kv)
        prefixes.append((prefix, kv))
        torch.cuda.synchronize()
        task_s.append(time.perf_counter() - t1)
    compress_s = time.perf_counter() - t0
    after_compress = counts()
    reqs = [Request(tokens=p_, max_new=max_new, prefix=f"task{i % 2}")
            for i, p_ in enumerate(prompts)]
    before = dict(engine.counters)
    t0 = time.perf_counter()
    out = engine.serve(reqs)
    torch.cuda.synchronize()
    dense = serve_numbers(engine, reqs, out, time.perf_counter() - t0,
                          before)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = np.stack([out[r.uid] for r in reqs])
    log(f"[main] {card}: compress 2x{T} tokens -> m={m}: {compress_s:.3f}s "
        f"(per task {[round(x, 4) for x in task_s]}); dense serve "
        f"{slots}x{max_new}: {dense['serve_s']:.3f}s, decode "
        f"{dense['decode_tok_s']:.1f} tok/s ({dense['decode_step_ms']:.2f} ms "
        f"a step), TTFT mean "
        f"{dense['ttft_mean_s']:.4f}s max {dense['ttft_max_s']:.4f}s; peak "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[main] launches: compress {after_compress}, whole dense path "
        f"{launches}")
    log(f"[main] tokens {tokens.tolist()}")
    if tokens.shape != (slots, max_new) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {tokens.shape}")
    for prefix, kv in prefixes:
        if len(prefix) != cfg.num_layers or not all(
                bool(torch.isfinite(e["h"]).all()) and
                tuple(e["h"].shape) == (1, m, cfg.d_model) for e in prefix):
            raise AssertionError("compressed prefix is not finite (1, m, D)")
        if not all(bool(torch.isfinite(e["k"]).all() & torch.isfinite(
                e["v"]).all()) for e in kv):
            raise AssertionError("materialized prefix is not finite")
    for key in ("flash_attention", "memcom_xattn"):
        if launches[key] <= 0:
            raise AssertionError(f"{key} was never launched on the dense path")
    # -- 5b. the same tasks in a paged engine: 12 requests, refills --
    bs = 16
    pengine = ServingEngine(cfg, target, slots=slots, max_len=max_len,
                            kv_layout="paged", block_size=bs,
                            num_blocks=1 + 2 * (m // bs) + slots * 4)
    for t, (_, kv) in enumerate(prefixes):
        pengine.add_prefix(f"task{t}", kv)
    if pengine.alloc.used_count != 2 * (m // bs):
        raise AssertionError(f"{pengine.alloc.used_count} blocks in use after "
                             f"registering two tasks, want {2 * (m // bs)}")
    specs = []
    for i in range(12):
        n = int(rng.integers(4, 13))
        specs.append(dict(
            tokens=rng.integers(4, vocab.size, n).astype(np.int32),
            max_new=int(rng.integers(4, 17)), prefix=f"task{i % 2}"))
    # a free-running serve (it also warms the path) gives each request's
    # greedy stream; every third request then stops at the second token
    # of its own stream, so a stop fires and its slot refills early
    free_reqs = [Request(**s) for s in specs]
    free = pengine.serve(free_reqs)
    # the dense engine on the same requests: the first token comes from
    # the prefill over the same prefix rows, so it must be equal; the
    # later ones go through different decode kernels (reported only)
    dense_reqs = [Request(**s) for s in specs]
    dense_out = engine.serve(dense_reqs)
    first_diff = [i for i, (f, d) in enumerate(zip(free_reqs, dense_reqs))
                  if int(free[f.uid][0]) != int(dense_out[d.uid][0])]
    same_streams = sum(np.array_equal(free[f.uid], dense_out[d.uid])
                       for f, d in zip(free_reqs, dense_reqs))
    log(f"[paged] first tokens equal to the dense engine's: "
        f"{len(specs) - len(first_diff)}/{len(specs)}; whole streams equal: "
        f"{same_streams}/{len(specs)}")
    if first_diff:
        raise AssertionError(f"paged and dense first tokens differ for "
                             f"requests {first_diff}")
    preqs = [Request(**s, stop_token=int(free[f.uid][1]) if i % 3 == 0
                     else None)
             for i, (s, f) in enumerate(zip(specs, free_reqs))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts()
    before = dict(pengine.counters)
    t0 = time.perf_counter()
    pout = pengine.serve(preqs)
    torch.cuda.synchronize()
    paged = serve_numbers(pengine, preqs, pout, time.perf_counter() - t0,
                          before)
    paged_launches = counts()
    paged["peak_bytes"] = torch.cuda.max_memory_allocated()
    pool_bytes = sum(x.numel() * x.element_size() for c in pengine.cache
                     for x in c.values())
    dense_bytes = sum(x.numel() * x.element_size() for c in engine.cache
                      for x in c.values())
    stopped = 0
    for r in preqs:
        got = pout[r.uid]
        early = len(got) < r.max_new
        stopped += int(early)
        if not 1 <= len(got) <= r.max_new or (
                early and int(got[-1]) != r.stop_token) or \
                got.min() < 0 or got.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.uid}: {len(got)} tokens for a "
                                 f"budget of {r.max_new}, stop {r.stop_token}")
    if not stopped:
        raise AssertionError("no stop token fired in the paged serve")
    paged.update(pool_bytes=pool_bytes, dense_cache_bytes=dense_bytes,
                 requests=len(preqs), stopped_early=stopped,
                 streams_equal_to_dense=int(same_streams),
                 admissions=sum(1 for e in pengine.trace if e[0] == "admit"),
                 pool=pengine.stats()["pool"], launches=paged_launches)
    log(f"[paged] {card}: served {len(preqs)} requests ({paged['tokens']} "
        f"tokens, {stopped} stopped early) in {paged['serve_s']:.3f}s, decode "
        f"{paged['decode_tok_s']:.1f} tok/s over {paged['decode_steps']} "
        f"steps ({paged['decode_step_ms']:.2f} ms each, "
        f"{paged['slots_per_step']:.2f} slots a step), TTFT mean {paged['ttft_mean_s']:.4f}s max "
        f"{paged['ttft_max_s']:.4f}s; pool {pool_bytes} bytes "
        f"({pengine.alloc.num_blocks} blocks of {bs}) vs dense cache "
        f"{dense_bytes} bytes; peak memory {paged['peak_bytes'] / 2**30:.2f} "
        f"GiB")
    log(f"[paged] launches {paged_launches}")
    for key in ("flash_attention", "paged_flash_decode"):
        if paged_launches[key] <= 0:
            raise AssertionError(f"{key} was never launched on the paged path")

    # where the time goes: one warm compress and one warm 4-token serve
    # under the profiler.  Device busy is the union of the kernels' time
    # intervals (kernel events only: an aten op's own entry repeats the
    # device time of the kernels it launched).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    breakdown = {}
    for phase, fn in (
            ("compress", lambda: memcom.compress(
                compressor, cfg, torch.as_tensor(sources[0][None],
                                                 device=dev))),
            ("serve", lambda: engine.serve(
                [Request(tokens=p_, max_new=4, prefix=f"task{i % 2}")
                 for i, p_ in enumerate(prompts)])),
            ("paged_serve", lambda: pengine.serve(
                [Request(tokens=p_, max_new=4, prefix=f"task{i % 2}")
                 for i, p_ in enumerate(prompts)]))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us, end = 0.0, float("-inf")
        for lo, hi in sorted((e.time_range.start, e.time_range.end)
                             for e in kernels):
            busy_us += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        by_name = {}
        for e in kernels:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        busy = busy_us / 1e6
        breakdown[phase] = {
            "wall_s": wall, "device_busy_s": busy, "kernels": len(kernels),
            "idle_share": max(0.0, 1 - busy / wall),
            "top": [(name[:60], us / 1e3, n) for name, (us, n) in top]}
        log(f"[profile] {phase}: wall {wall:.4f}s, device busy {busy:.4f}s "
            f"over {len(kernels)} kernels, idle share "
            f"{breakdown[phase]['idle_share']:.3f}")
        for name, ms, n in breakdown[phase]["top"]:
            log(f"    {ms:9.3f} ms  x{n:<5d} {name}")
    report["main"] = {
        "task_compress_s": task_s, "breakdown": breakdown,
        "compress_s": compress_s, "dense": dense, "paged": paged,
        "peak_bytes": peak, "params": n_params,
        "launches_after_compress": after_compress, "launches": launches}
    del target, compressor, engine, pengine, prefixes, prefix, kv
    torch.cuda.empty_cache()

    # ---- 6. kernels vs plain at full width, depth 2 --------------------
    cfg2 = cfg.replace(name="gemma2-2b-depth2",
                       layout=LayerLayout.uniform(LayerDesc("attn", "dense"),
                                                  2))
    target2 = tfm.init_params(cfg2, 0)
    compressor2 = memcom.init_memcom(cfg2, target2, 1)
    src = torch.as_tensor(sources[0][None], device=dev)
    prompt = torch.as_tensor(prompts[2][None], dtype=torch.long, device=dev)

    def pipeline():
        prefix, _ = memcom.compress(compressor2, cfg2, src)
        kv = materialize_prefix(target2, cfg2, prefix)
        with torch.no_grad():
            logits, _ = target2(tokens=prompt, prefix=kv, mask_offset=m)
        return [e["h"] for e in prefix], logits[0, -1]

    omega_k, logits_k = pipeline()
    ops.set_default_impl("torch")
    omega_p, logits_p = pipeline()
    ops.set_default_impl(None)

    def rel(a, b):
        return err(a, b) / max(float(b.float().abs().max()), 1e-30)

    rel_omega = max(rel(a, b) for a, b in zip(omega_k, omega_p))
    rel_logits = rel(logits_k, logits_p)
    log(f"[kernel-vs-plain] depth 2, bf16: O^i rel err {rel_omega:.3e}, "
        f"first-step logits rel err {rel_logits:.3e} (tol {E2E_REL_TOL:g}); "
        f"greedy token kernel {int(logits_k.argmax())} plain "
        f"{int(logits_p.argmax())}")
    if not (rel_omega <= E2E_REL_TOL and rel_logits <= E2E_REL_TOL):
        raise AssertionError("kernel path and plain path disagree end to end")
    # a paged engine at block size 12: the shared tail block (512 % 12 =
    # 8 positions) is copied on write by both prefills, then one decode
    # step reads both slots through their tables
    kv2 = materialize_prefix(target2, cfg2,
                             memcom.compress(compressor2, cfg2, src)[0])
    ptoks = [prompts[2], prompts[1]]

    def paged_first_step():
        """Two 2-token requests through ``serve``: the last-position
        logits of the two prefills and of the one decode step, and
        whether both slots copied the shared tail block on write."""
        eng = ServingEngine(cfg2, target2, slots=2, max_len=max_len,
                            kv_layout="paged", block_size=12)
        eng.add_prefix("task", kv2)
        tail = eng.store.blocks("task")[-1]
        rows = []
        hook = target2.register_forward_hook(
            lambda mod, args, out: rows.append(out[0][:, -1].float()))
        try:
            out = eng.serve([Request(tokens=t, max_new=2, prefix="task")
                             for t in ptoks])
        finally:
            hook.remove()
        if len(rows) != 3 or any(len(t) != 2 for t in out.values()):
            raise AssertionError(f"{len(rows)} forward passes, want 2 "
                                 "prefills and 1 decode step")
        cow = all(int(eng.tables[s_, m // 12]) != tail for s_ in (0, 1))
        return torch.cat(rows[:2]), rows[2], cow

    set_counts()
    pre_k, step_k, cow = paged_first_step()
    torch.cuda.synchronize()
    e2e_counts = counts()
    ops.set_default_impl("torch")
    pre_p, step_p, _ = paged_first_step()
    ops.set_default_impl(None)
    rel_pre, rel_step = rel(pre_k, pre_p), rel(step_k, step_p)
    log(f"[kernel-vs-plain] paged, depth 2, block size 12 (tail copied on "
        f"write: {cow}): prefill logits rel err {rel_pre:.3e}, first decode "
        f"step logits rel err {rel_step:.3e} (tol {E2E_REL_TOL:g}); launches "
        f"{e2e_counts}")
    if not (cow and rel_pre <= E2E_REL_TOL and rel_step <= E2E_REL_TOL
            and e2e_counts["paged_flash_decode"] > 0):
        raise AssertionError("paged kernel path and plain path disagree")
    report["kernel_vs_plain"] = {"omega_rel_err": rel_omega,
                                 "logits_rel_err": rel_logits,
                                 "paged_prefill_rel_err": rel_pre,
                                 "paged_step_rel_err": rel_step}

    # ---- result lines ----------------------------------------------------
    entries = []
    for key, rows, main in (
            ("flash_attention:flash_attention", flash_rows, None),
            ("memcom_xattn:memcom_xattn", [mx_row], None),
            ("paged_attention:paged_flash_decode", paged_rows, "decode")):
        timed = [r for r in rows if "ms" in r]
        head = (next(r for r in rows if r["shape"] == main) if main
                else max(timed, key=lambda r: r["ms"]))
        name = key.split(":")[1]
        by_path = {"dense": launches[name], "paged": paged_launches[name]}
        entries.append({
            "name": name, "route": "cuda",
            "source": registry.KERNELS[key]["source"],
            "replaces": registry.KERNELS[key]["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(max(r["max_abs_err_float32"],
                                   r["max_abs_err_bfloat16"]) for r in rows),
            "scaled_err": max(r["scaled_err_bfloat16"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rows})
    report["kernels"] = entries
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    log(card)
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"}
                                for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
