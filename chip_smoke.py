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
4. The main path, end to end, at the full published width and depth of
   gemma2-2b in bfloat16, weights drawn from seeds: compress two
   3072-token many-shot prompts to m = 512 memory tokens, materialize the
   prefixes, and serve 4 slots x 16 greedy tokens behind them with ragged
   4-12-token prompts.  Every kernel's launch counter is set to 0 just
   before and read just after; each must be > 0.
5. Kernel vs plain end to end: the same pipeline at full width and depth
   2, once through the kernels and once forced to the plain versions
   (``ops.set_default_impl("torch")``); O^i and the first-step logits
   agree within 2e-2 of the reference's largest magnitude (bfloat16).

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
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServingEngine, materialize_prefix

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
    torch.cuda.empty_cache()

    # ---- 4. the main path at full width -------------------------------
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

    fa.launches = 0
    mx.launches = 0
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
    after_compress = {"flash_attention": fa.launches,
                      "memcom_xattn": mx.launches}
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, max_new,
                             prefixes=[f"task{i % 2}" for i in range(slots)])
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "memcom_xattn": mx.launches}
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    engine.generate(prompts, 1, prefixes=[f"task{i % 2}" for i in range(slots)])
    torch.cuda.synchronize()
    first_token_s = time.perf_counter() - t0
    decode_tok_s = slots * (max_new - 1) / (generate_s - first_token_s)
    log(f"[main] compress 2x{T} tokens -> m={m}: {compress_s:.3f}s "
        f"(per task {[round(x, 4) for x in task_s]}); "
        f"generate {slots}x{max_new}: {generate_s:.3f}s "
        f"({slots * max_new / generate_s:.1f} tok/s with prefill; decode "
        f"only {decode_tok_s:.1f} tok/s); peak memory {peak / 2**30:.2f} GiB")
    log(f"[main] launches: compress {after_compress}, whole path {launches}")
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
    for key, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{key} was never launched on the main path")
    # where the time goes: one warm compress and one warm 4-token generate
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
            ("generate", lambda: engine.generate(
                prompts, 4, prefixes=[f"task{i % 2}" for i in range(slots)]))):
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
        "compress_s": compress_s, "generate_s": generate_s,
        "first_token_s": first_token_s, "decode_tokens_per_s": decode_tok_s,
        "peak_bytes": peak, "params": n_params,
        "launches_after_compress": after_compress, "launches": launches}
    del target, compressor, engine, prefixes, prefix, kv
    torch.cuda.empty_cache()

    # ---- 5. kernel vs plain at full width, depth 2 ---------------------
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
    report["kernel_vs_plain"] = {"omega_rel_err": rel_omega,
                                 "logits_rel_err": rel_logits}

    # ---- result lines ----------------------------------------------------
    entries = []
    for key, rows in (("flash_attention:flash_attention", flash_rows),
                      ("memcom_xattn:memcom_xattn", [mx_row])):
        timed = [r for r in rows if "ms" in r]
        head = max(timed, key=lambda r: r["ms"])
        name = key.split(":")[0]
        entries.append({
            "name": name, "route": "cuda",
            "source": registry.KERNELS[key]["source"],
            "replaces": registry.KERNELS[key]["replaces"],
            "launches": launches[name],
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
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"}
                                for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
