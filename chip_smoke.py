#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json-out PATH]

Phases, each of which raises (and so exits non-zero) on failure:

1. The card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel of the main paths from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, all started together) and print the
   build seconds and the ``-Xptxas -v`` register / shared-memory / spill
   lines.
3. Kernel phases: each kernel at the shapes the full-width gemma2-2b and
   granite-moe-3b-a800m main paths give it, held against its plain
   PyTorch version on the card in float32 (TF32 off) and bfloat16,
   fully-masked query rows included: the max abs error is at most 1e-4
   (float32) / 2e-2 (bfloat16), and every element's error at most 1e-4 /
   2e-2 of its scale ``|ref| + rms of ref's row`` (``plain.scaled_err``;
   an output that averages V over thousands of keys is ~0.01, so only the
   scaled rule holds it in bfloat16: a dropped 32-key tile of the
   3072-token prefill leaves the max abs error under 2e-2 and gives a
   scaled error near 0.5).  Times from CUDA events over warmed repeats:
   the kernel, its plain version, and one PyTorch library call as a
   yardstick the port never calls (``F.scaled_dot_product_attention``; it
   has no logit softcap, so at gemma2's softcapped shapes it computes the
   function without the cap; ``torch.bmm`` for ``gmm``).  The bound is
   max(operations / 989 TFLOP/s bf16, bytes / 3.35 TB/s) from this run's
   inputs, counting only the K/V rows some query can see.
   a. ``flash_attention`` at gemma2-2b's 8/4 heads of 256 (softcap 50) and
      granite's 24/8 heads of 64 (group 3, no softcap): the 3072-token
      source prefill, the 512-token Memory-LLM, a prompt behind the 512
      memory rows, decode, and masked rows; and mistral-7b's 6144-token
      source prefill (32/8 heads of 128, bf16 only) and the online
      compiler's chunk of 512 source queries at offset 0, 3072 and 5632
      (``mistral_chunk_<offset>``: one causal call over the offset cached
      keys and its own, exactly o + 512 keys; the flash entry's
      ``compile_chunk``); the fused step's dense decode over 4 slots with
      W = 4 lanes a slot (the speculative verify lanes at k = 3) and W =
      16 (a join chunk), behind lengths of 516-524 (``fused_decode_w4``,
      ``fused_decode_w16``); and probes (bf16 only): decode over caches of 2048 and 8192 positions and over 32 to
      72 slots, a prompt of 64 (query, head) rows against a 2048-token
      prefix, and causal self-attention short enough to split the KV
      axis.  Every bf16 shape runs through both bf16 kernels, the wgmma variant and the
      mma.sync one, each forced and each held to the plain version; ``ms``
      is the time of the variant the wrapper picks (``variant``), beside
      ``ms_wgmma`` and ``ms_mma_sync``, and ``device_ms_wgmma`` /
      ``device_ms_mma_sync``: 20 calls captured into a CUDA graph and
      replayed, the time between launches left out (CUDA events around
      few-row calls time mostly the host; ``fa.variant_for``'s rule is
      set from these device times);
   b. ``memcom_xattn`` at 1x512 x 3072 at D = 2304 and D = 1536 (the
      compress paths'), and mistral-7b's 1x768 x 6144 x 4096 (bf16 only, a
      probe: no main path runs it).  Every bf16 shape runs through both
      bf16 kernels, the wgmma variant (two launches) and the mma.sync one
      (three), each forced and each held to the plain version; the wgmma
      variant's distance from ``plain.memcom_xattn_tiled`` (its own
      rounding points; also in bf16 steps from its float32 value, at most
      0.5 for a kernel that rounds as it says) is printed beside.  ``ms`` / ``device_ms`` are the
      picked variant's (``variant``), beside ``ms_<variant>`` and
      ``device_ms_<variant>``: 21 calls replayed in a CUDA graph that
      rotate through three input sets (30 MB each at D = 2304, 107 MB at
      the probe), with each variant's workspace bytes;
   c. ``paged_flash_decode`` (the paged decode attention): the gemma2-2b
      main-path shape (q 4x1x8x256, pools of 16-position blocks, lengths
      516-524, slots 0/2 and 1/3 sharing the first 32 blocks of their
      task, shuffled tables of max_len positions), S = 3, the fused
      step's S = W = 4 and 16 (``fused_w4``, ``fused_w16``: the lengths
      count the W new rows), block sizes 8
      and 12, a length of 1, lengths on block boundaries, fully-masked
      rows, the mistral-7b width (32/8 heads of 128), granite's (24/8
      heads of 64), and ``long_table``: the main-path shape in tables of
      4096 positions.  ``device_ms``: CUDA-graph replay rotating through
      input sets whose K/V rows read add up past 60 MB (14 at ``decode``),
      so that no call finds its rows in the 50 MB L2.  Its bound counts
      each distinct (pool block, offset) position below some slot's
      length once plus q, out, tables and lengths; no single PyTorch call
      attends through a block table, so it has no library time;
   d. ``gmm`` (the MoE grouped matmul) at granite's E = 40 experts, C =
      768 / 128 / 8 rows (source prefill / Memory-LLM / prompt and decode)
      in both orientations (1536 -> 512 and 512 -> 1536), and probes at C
      = 64, 32 and 16 (bf16 only) that set ``gm.variant_for``'s rule.
      Every bf16 shape runs through each bf16 kernel that takes it (wgmma,
      rows, mma.sync), forced and held to the plain version; ``ms`` is
      the picked variant's time (``variant``) beside ``ms_<variant>``,
      and ``device_ms_<variant>`` / ``library_device_ms`` (``torch.bmm``)
      replay 21 calls in a CUDA graph that rotate through three sets of x
      and w (189 MB of weights), so that no call reads its weights from
      the 50 MB L2.  The cuBLAS workspace that ``torch.bmm`` takes under
      graph capture is freed after the phase, so that the main paths'
      peak memory holds only their own.  Bound max(2·E·C·D·F / 989
      TFLOP/s, bytes of x, w and out / 3.35 TB/s);
   e. ``ssd`` (the Mamba2 SSD scan) at mamba2-370m's widths (32 heads of
      64, N 128): its prefill of a 3072-token prompt and a 12-token query
      with an initial state, a 12-token prompt, 1000 tokens (no multiple
      of any chunk), two groups, and dt·|A| = 25 a token (the decay sums
      past 100 within a chunk: the result must be finite).  y and the
      final state are held to ``plain.ssd_ref`` on the same inputs: bf16
      through both kernels, the chunked variant and the sequential one,
      each forced;
      float32 through the sequential kernel alone, summed in float64 for
      the check as the kernel sums float32 inputs (float32 sums stray up
      to ~5e-4 of a row's scale where the row is the cancelled remainder
      of its terms; the float32 plain version's own distance from it is
      printed beside); and probes at 64, 128 and 256 tokens (bf16 only)
      that set ``ss.variant_for``'s rule.  ``ms`` is the picked variant's
      time by CUDA events (``variant``), beside ``ms_<variant>`` and
      ``device_ms_<variant>``: 21 calls replayed in a CUDA graph that
      rotate through three input sets, so that no call reads its 15 MB
      of inputs from the 50 MB L2.  Bound max(the scan's least operations
      (2N + 2P + 4NP per token and head: the chunked form at Q = 1) / 989
      TFLOP/s, bytes of x, y, B, C, dt and the states / 3.35 TB/s),
      printed beside the bytes the chunked design moves (its chunk states
      cross device memory four times).  No PyTorch call runs the scan, so
      it has no library time.
   f. the backward kernels (``fa.flash_attention_bwd``,
      ``mx.memcom_xattn_bwd``) against their plain backward
      (``plain.attention_bwd_ref``, ``plain.memcom_xattn_bwd_ref``) on the
      same inputs: float32 (TF32 off) max abs error at most 1e-4 of max(1,
      the largest gradient), bf16 ``plain.grad_err`` at most 2e-2, per
      gradient.  Flash at the training step's shapes (gemma2-2b, batch 2:
      the Memory-LLM's 512 causal rows, the 512-token prompt at offset
      512 and against the 512 prefix, both with an lse cotangent), the
      3072-token source (Phase 2), fully-masked rows, granite's and
      mistral-7b's widths and float32 at head dim 32; ``memcom_xattn`` at
      2x512x3072x2304, 1x512x3072x1536 and mistral-7b's 1x768x6144x4096.
      Rows that get no gradient by their positions (queries that see no
      key, keys that no query sees) must be exactly 0.  Every bf16 flash
      shape runs through both bf16 kernels, each forced and each checked:
      the wgmma variant (``flash_bwd_wgmma``) and the mma.sync one; the
      wgmma variant's distance from its own arithmetic
      (``plain.attention_bwd_tiled``) in bf16 steps (``plain.bf16_ulps``,
      over the rows above ``plain.GRAD_NOISE_FLOOR``) is printed beside.
      ``memcom_xattn``'s backward takes the forward's out and lse; every
      bf16 shape runs through both its bf16 kernels, forced and checked:
      the wgmma variant (three launches: ``xattn_bwd_dot``,
      ``xattn_bwd_sdp_wgmma``, ``xattn_bwd_grad_wgmma``) and the mma.sync
      one (six), each with its workspace bytes.
      ``ms`` / ``device_ms`` are the picked variant's
      (``fa.bwd_variant_for``, ``mx.bwd_variant_for``), beside
      ``ms_<variant>`` and ``device_ms_<variant>``.  ``ms`` by CUDA
      events, ``device_ms`` by graph replay over three input sets; the
      library time that of ``torch.autograd.grad`` through one
      ``F.scaled_dot_product_attention`` call (no cap, ``enable_gqa``; one
      head for ``memcom_xattn``) on the first backend that takes it,
      printed, by CUDA events, and its device time by graph replay over
      the same three sets (forward and backward less the forward alone).
      Bound: five products against the forward's two.
4. The main path, end to end, at the full published width and depth of
   gemma2-2b, then (its models freed) of granite-moe-3b-a800m, in
   bfloat16, weights drawn from seeds, each in two runs with every
   kernel's launch counter set to 0 just before and read just after; each
   kernel of the run must have been launched (``gmm`` on granite's),
   every flash call over the 3072-token source prompt and every
   ``memcom_xattn`` call must have gone through the wgmma variant (their
   own counters, printed per path), and on
   granite's paths every ``gmm`` call at C = 768 through the wgmma kernel
   and every one at C = 8 through the rows kernel (the calls by C and
   kernel are printed per path); ``paged_flash_decode`` has one kernel,
   so its counter counts every paged decode call of the paged paths:
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
   A profiled warm compress and 4-request serve on each layout give the
   device busy time and idle share (and the compress's
   ``xattn_logits_wgmma`` / ``xattn_out_wgmma`` and the paged serve's
   ``paged_decode`` device times); peak device memory is printed.
   c. mamba2-370m (48 Mamba2 layers, no MemCom): 8 requests, each one of
      the two 3072-token many-shot prompts plus a 4-12-token query, 16
      greedy tokens each, over 4 slots (so slots refill), through a dense
      and then a paged engine (block size 16): the tokens must be
      identical, a request admitted into a refilled slot must give the
      tokens of a fresh engine, and ``ssd`` must have been launched once
      per layer and prefill, every time through the chunked variant.
      Printed: the prefill seconds of one ~3080-token prompt, decode
      tok/s, TTFT, the state bytes per slot beside gemma2-2b's K/V bytes
      for 3072 tokens, peak memory, and a profiled prefill (with the
      device time of each ``ssd`` kernel by name: the chunked variant's
      three phases) and 4-request serve.
   d. training (after the three models): gemma2-2b Phase 1 at full width
      and depth through ``launch/train.py``'s ``build`` (Trainer, AdamW
      with warmup_cosine over 2 warmup steps, clip 1.0), batch 2 x 3584
      tokens split at 3072, 4 steps with raw checkpoints after steps 2 and
      4 (in the git-ignored ``.chip_smoke_ckpt/``, deleted after), under
      ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
      losses finite, every trained tensor's float32 master moved, every
      frozen tensor bit-identical to its start, each step 77 flash
      backward calls (26 layers x Memory-LLM self, prompt vs prefix and
      prompt self, less layer 0's prompt self, which reads only frozen
      embeddings), each through the kernel ``fa.bwd_variant_for`` picks
      (the wgmma calls counted and printed), and 26 ``memcom_xattn``
      backward calls, each through the kernel ``mx.bwd_variant_for``
      picks (the wgmma variant's three launches), every forward
      ``memcom_xattn`` call through the wgmma variant; a second Trainer
      restored from step 2 reproduces the losses of steps 3-4 and the
      trained tensors exactly.  Printed: s/step, tokens/s, peak memory,
      and one profiled step's device busy, idle share and the forward and
      backward kernels' device times.
   e. mistral-7b (after the training phase, the other models freed; 32
      layers, d_model 4096, 32/8 heads of 128, m = 768; 23.89 B
      parameters over its three stacks and memx, initialised on the card):
      as 4a-b on three 6144-token tasks' first two; then the online
      compiler: O^i of a 512-token chunked compile within
      ``plain.scaled_err`` 2e-2 of the offline compress and bitwise equal
      on a second run; two requests on the third (resident) task decode
      while the first two tasks arrive as raw shots and compile 512
      source tokens behind each decode step (installed K/V within 2e-2 of
      the offline prefix; a recompile behind the same steps bitwise equal;
      printed: chunks interleaved, cold TTFT, the longest decode gap with
      and without a compile and with a whole-task budget, host clock);
      the same compile riding the fused steps (``fused_step=True``, 512
      source tokens a step): the installed K/V within 2e-2 of the offline
      prefix, the O^i bitwise equal to the classic chunked compile's
      (printed: the longest gap and cold TTFT beside the classic loop's);
      then the tiers: the three tasks served in turns through one HBM
      prefix, one host row and a temporary disk tier (dense and paged,
      the tokens of an all-HBM engine; demotes, spills, host promotes and
      disk loads all non-zero; printed: ms of each demote, spill, shard
      read and promotion from host and from disk, and the shard bytes);
      last, ``eval_accuracy`` on the committed trained target
      (``artifacts/bench/target``, dense ``score_labels``, the float32
      flash kernel at head dim 32) on the card and on the CPU, with the
      full budget and the fewer-shots protocol: the same labels.
   f. the fused step and speculative decoding at gemma2-2b's full width
      (in its path, on its models; bf16): 8 requests over 4 slots on the
      two tasks (prompts of 4-33 tokens, budgets of 8-16, so slots free
      at different steps and the later requests join while others
      decode, streaming 16 prompt tokens a step), through the classic
      engines of the path (the baseline), a fused engine
      (chunks of 16), a self-speculative one (k = 3) and one drafted by
      gemma2-2b at depth 2, full width, seed 5, each dense and paged
      (blocks of 16), a shorter warm-up serve and a measured one.
      Required: each
      request emits its budget, ``tokens_generated`` is the output less
      the first tokens, ``fused_prefill_tokens`` the sum of the join
      lengths, ``draft_accepted <= draft_proposed``, and the kernels of
      the path launched.  Printed: acceptance, the greedy streams equal to
      the classic engine's (not required: a bf16 call of another width
      rounds otherwise), tok/s, TTFT, the longest decode gap, the step
      functions' geometry counts, and five profiled fused steps' (W = 4,
      dense) device busy and idle share.
   g. traffic at gemma2-2b's full width on a ``VirtualClock``: 24 requests
      over 6 raw-shot tasks of 3072 tokens (Zipf, Poisson arrivals at 5 a
      second, two classes), 2 HBM prefixes and 4 host rows, compiles of 512 tokens a
      fused step, with a ``Tracer`` and an ``SLOWatchdog`` (the default
      rules at the run's TTFT SLO, ``ShedDegrade``) as the launcher
      attaches them; twice from one seed: every request completes, the
      same tokens, ``request_log``, ``Tracer.dumps()`` bytes and
      ``SLOWatchdog.dumps()`` bytes.  Printed: ``slo_metrics`` (simulated
      seconds), the wall seconds, the alerts fired and cleared and the
      admissions the shed floor refused.
   h. the trained target (``artifacts/bench/target``, float32, head dim
      32, dense) serves 8 ICL prompts (96-token context and a query,
      budgets of 4-8) greedily over 4 slots, classic, fused (chunks of
      16), self-speculative (k = 3) and drafted by the same config at seed
      9: identical tokens (the top-2 margin printed at a divergence), a
      self-draft accept rate of exactly 1.0.
   i. observability at gemma2-2b's full width, on the 4f requests (before
      4g): the classic dense engine and a fused paged one, each with the
      tracer off and on: identical tokens and the same count of
      synchronizing calls (torch's sync debug mode, its warnings
      counted); the trace passes ``validate_chrome_trace`` and its
      ``profile_spans`` report ``validate_profile_report``.  Then one serve
      with a ``TelemetryServer`` on an ephemeral port, scraped on
      ``/metrics``, ``/healthz``, ``/debug/state`` and ``/debug/trace``
      from a second thread while it serves: every answer 200, the tokens
      of the unscraped serve.  Then the budget autotuner: the two tasks
      arrive as raw shots and compile 512 tokens behind the decode steps
      of two requests on a resident task, ``target_decode_gap_s`` half the
      fixed budget's mean gap (host clock): at least one shrink, the
      installed K/V within 2e-2 of the offline prefix.  Printed: the
      profile reports, the tracer's own host ms a step, the scrape
      counts, the shrinks, grows and budget trail, the longest gap beside
      the fixed budget's, and the O^i against the offline compress
      (``plain.scaled_err``, bitwise or not).
5. Kernels vs plain end to end, after each model: the pipeline at full
   width and depth 2 (mistral-7b's over a 6144-token source into m =
   768), once through the kernels and once forced to the
   plain versions (``ops.set_default_impl("torch")``): O^i and the
   first-step logits agree within 2e-2 of the reference's largest
   magnitude (bfloat16); then a paged engine with block size 12 (10 at
   mistral-7b's m = 768; m is no multiple of it, so the shared tail block
   is copied on write on the card) serves
   two 2-token requests on one task, two prefills and one decode step
   through ``paged_flash_decode``: the logits of every forward pass, read
   by a forward hook on the target, agree within the same bound; for the
   attention-only models, a self-speculative fused engine's first two
   fused steps (W = 4 verify lanes; then a 16-token join beside them,
   W = 16), dense and paged: the valid lanes' logits agree within the
   same bound.  For the
   MoE model the plain run replays the kernel run's expert choices (top-k
   ids) so that both take the same discrete routing: a router
   probability that the two runs' bf16 roundings move across the top-k
   boundary would change which experts a token reaches, which is no
   kernel error.  The choices the plain run would have made on its own
   are counted and printed.  mamba2-370m at depth 2: a many-shot
   prompt's last-position logits and final SSM states through ``ssd``
   and through the plain version agree within the same bound (both
   ``ssd`` calls through the chunked variant).

   After the training phase: one Phase-1 and one Phase-2 step's loss and
   gradients of gemma2-2b at full width and depth 2, through the kernels
   and forced to the plain versions: each gradient within 2e-2 of the
   plain run's largest magnitude (Phase 2 adds the Source- and
   Memory-LLM and the 3072-token source's flash backward).

   After the kernel phases (3g): a ``gmm`` and an ``ssd`` call on CUDA
   inputs one of which requires grad, with gradients enabled, raise
   ``NotImplementedError`` (neither kernel has a backward yet) and launch
   nothing; under ``torch.no_grad`` the same calls run the kernel.

The line before the last is ``{"kernels": [...]}``, one entry per kernel
at its costliest main-path shape, with every shape's numbers under
``"shapes"``; the last line is ``{"ok": true, "device": {...}}``.  Without
a card, or without the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
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
    t_main = time.perf_counter()

    # cuBLAS reproducible run to run (the training phase's restart check),
    # set before torch creates its first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
                                  build_manyshot_prompt, make_episode,
                                  make_query)
    from repro_torch.kernels import build, ops, plain, registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import memcom_xattn as mx
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import (MetricsRegistry, Request,
                                     ServingEngine, ShedDegrade, SLOWatchdog,
                                     TelemetryServer, Tracer, TrafficConfig,
                                     VirtualClock, default_rules,
                                     generate_trace, materialize_prefix,
                                     profile_spans, slo_metrics,
                                     validate_alert_log,
                                     validate_chrome_trace,
                                     validate_profile_report)
    from repro_torch.serving import engine as engine_mod

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

    def device_ms(fn, reps=20, bufs=((),)):
        """Device time of one call of ``fn``: ``reps`` calls captured into
        a CUDA graph, replayed and timed with CUDA events, so the host's
        time between launches is left out and few-row calls compare on
        the card's work alone.  Call i gets the arguments
        ``bufs[i % len(bufs)]``: with several buffer sets, a call whose
        inputs fit the 50 MB L2 still reads them from device memory."""
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape, dtype, scale=0.5):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def check(kernel, name, dn, out, ref, extra_ok=True, extra=""):
        e, se = err(out, ref), plain.scaled_err(out, ref)
        log(f"{kernel} {name} {dn}: max_abs_err {e:.3e} (tol {TOL[dn]:g}), "
            f"scaled err {se:.3e} (tol {REL_TOL[dn]:g}){extra}")
        if not (e <= TOL[dn] and se <= REL_TOL[dn] and extra_ok):
            raise AssertionError(f"{kernel} {name} {dn} disagrees with its "
                                 "plain version")
        return e, se

    m = 512            # memory tokens of both models
    T = 3072           # many-shot source tokens
    prompt_len = 12    # the longest ragged prompt
    slots, max_new = 4, 16
    max_len = m + 24 + max_new + 16

    def arange(lo, n):
        return lo + torch.arange(n, dtype=torch.int32, device=dev)

    lengths = torch.tensor([m + 8, m + 11, m + 4, m + 12], dtype=torch.int32,
                           device=dev)
    decode_kv = arange(0, max_len)[None].expand(slots, max_len).contiguous()
    gemma_heads = (8, 4, 256, 50.0)    # Hq, Hkv, head dim, softcap
    granite_heads = (24, 8, 64, 0.0)
    mistral_heads = (32, 8, 128, 0.0)
    granite_prompt = 16  # a MoE prompt prefills at its power-of-two bucket
    attn_cases = [
        # name, B, Sq, Skv, q_pos, kv_pos, causal, heads
        ("source_prefill", 1, T, T, arange(0, T)[None], arange(0, T)[None],
         True, gemma_heads),
        ("memory_self", 1, m, m, arange(0, m)[None], arange(0, m)[None], True,
         gemma_heads),
        ("prompt_self", 1, prompt_len, prompt_len, arange(m, prompt_len)[None],
         arange(m, prompt_len)[None], True, gemma_heads),
        ("prompt_prefix", 1, prompt_len, m, arange(m, prompt_len)[None],
         arange(0, m)[None], False, gemma_heads),
        ("decode", slots, 1, max_len, (lengths - 1)[:, None], decode_kv, True,
         gemma_heads),
        # the fused step's dense decode: W lanes a slot behind the slot's
        # length, the speculative verify lanes at k = 3 (W = 4) and a
        # 16-token join chunk (W = 16)
        *((f"fused_decode_w{W_}", slots, W_, max_len,
           lengths[:, None] + arange(0, W_)[None], decode_kv, True,
           gemma_heads) for W_ in (4, 16)),
        ("masked_rows", 2, 3, 64,
         torch.tensor([[-2, -1, 0], [2, 3, 4]], dtype=torch.int32, device=dev),
         arange(0, 64)[None].expand(2, 64).contiguous(), True, gemma_heads),
        ("granite_source_prefill", 1, T, T, arange(0, T)[None],
         arange(0, T)[None], True, granite_heads),
        ("granite_memory_self", 1, m, m, arange(0, m)[None],
         arange(0, m)[None], True, granite_heads),
        ("granite_prompt_self", 1, granite_prompt, granite_prompt,
         arange(m, granite_prompt)[None], arange(m, granite_prompt)[None],
         True, granite_heads),
        ("granite_prompt_prefix", 1, granite_prompt, m,
         arange(m, granite_prompt)[None], arange(0, m)[None], False,
         granite_heads),
        ("granite_decode", slots, 1, max_len, (lengths - 1)[:, None],
         decode_kv, True, granite_heads),
        # mistral-7b's many-shot source prefill (32/8 heads of 128), bf16
        # only: the kernel row of a model the main paths do not run yet
        ("mistral_source_prefill", 1, 2 * T, 2 * T, arange(0, 2 * T)[None],
         arange(0, 2 * T)[None], True, mistral_heads),
        # the online compiler's chunk: 512 source queries at an offset,
        # causal over the offset cached keys and their own (one call)
        *((f"mistral_chunk_{off}", 1, 512, off + 512, arange(off, 512)[None],
           arange(0, off + 512)[None], True, mistral_heads)
          for off in (0, 3072, 5632)),
        # probes beyond the main paths' shapes (bf16 only), which set
        # fa.variant_for's rule: where the mma.sync variant's KV split
        # pays against the wgmma variant's unsplit walk
        *((f"probe_{tag}decode_{B_}x{L}", B_, 1, L, arange(L - 1, 1)[None]
           .expand(B_, 1), arange(0, L)[None].expand(B_, L).contiguous(),
           True, heads)
          for tag, heads, shapes in (
              ("", gemma_heads, ((slots, 2048), (slots, 8192), (32, max_len),
                                 (72, max_len))),
              ("granite_", granite_heads, ((slots, 2048), (slots, 8192),
                                           (36, max_len))),
              ("mistral_", mistral_heads, ((slots, max_len),)))
          for B_, L in shapes),
        # a prompt of 64 / 66 (query, head) rows against a long prefix
        *((f"probe_{tag}prefix_2048", 1, n, 2048, arange(2048, n)[None],
           arange(0, 2048)[None], False, heads)
          for tag, n, heads in (("", 32, gemma_heads),
                                ("granite_", 22, granite_heads))),
        # causal self-attention short enough to split
        *((f"probe_{tag}self_{L}", 1, L, L, arange(0, L)[None],
           arange(0, L)[None], True, heads)
          for tag, L, heads in (("", 2048, gemma_heads),
                                ("mistral_", m, mistral_heads))),
    ]
    flash_rows = []
    for name, B, Sq, Skv, q_pos, kv_pos, causal, heads in attn_cases:
        Hq, Hkv, D, cap = heads
        nsplit = fa._splits(B, Sq, Skv, Hq, Hkv, torch.cuda.current_device())
        dispatched = fa.variant_for(torch.bfloat16, D, Skv, nsplit)
        row = {"shape": name, "q": [B, Sq, Hq, D], "kv": [B, Skv, Hkv, D],
               "causal": causal, "softcap": cap, "variant": dispatched,
               "nsplit": nsplit}
        dtypes = ((torch.bfloat16,) if name.startswith(("mistral", "probe_"))
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            q = rand(B, Sq, Hq, D, dtype=dtype)
            k = rand(B, Skv, Hkv, D, dtype=dtype)
            v = rand(B, Skv, Hkv, D, dtype=dtype)
            kw = dict(q_pos=q_pos.contiguous(), kv_pos=kv_pos, causal=causal,
                      softcap=cap, return_lse=True)
            ref, ref_lse = plain.attention_ref(q, k, v, **kw)
            live = ref_lse > plain.NEG_INF / 2
            lse_tol = 1e-4 * max(1.0, float(ref_lse[live].abs().max())) \
                if bool(live.any()) else 0.0
            dead = ~live  # rows that see no key: out 0, lse -1e30
            # every bf16 shape goes through both bf16 kernels (the wgmma
            # one takes all of them when forced), each held to the plain
            # version; float32 through its one kernel
            variants = ((None,) if dtype is torch.float32
                        else ("wgmma", "mma_sync"))
            for var in variants:
                out, lse = fa.flash_attention(q, k, v, variant=var, **kw)
                torch.cuda.synchronize()
                e_lse = err(lse[live], ref_lse[live]) \
                    if bool(live.any()) else 0.0
                dead_ok = bool((lse[dead] == plain.NEG_INF).all()) and (
                    not bool(dead.any())
                    or float(out[dead].abs().max()) == 0.0)
                tag = "" if var is None else f"_{var}"
                e, se = check("flash_attention", name + tag, dn, out, ref,
                              e_lse <= lse_tol and dead_ok,
                              f", lse err {e_lse:.3e}, masked rows "
                              f"{int((~live).sum())} exact={dead_ok}")
                row[f"max_abs_err_{dn}{tag}"] = e
                row[f"scaled_err_{dn}{tag}"] = se
                row[f"lse_err_{dn}{tag}"] = e_lse
                del out, lse
            if dtype is torch.bfloat16:
                # the kernels' entries read the worse of the two variants
                for key in ("max_abs_err", "scaled_err", "lse_err"):
                    row[f"{key}_{dn}"] = max(row[f"{key}_{dn}_wgmma"],
                                             row[f"{key}_{dn}_mma_sync"])
            if dtype is torch.bfloat16 and name != "masked_rows":
                row["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
                for var in ("wgmma", "mma_sync"):
                    row[f"ms_{var}"] = cuda_ms(lambda: fa.flash_attention(
                        q, k, v, variant=var, **kw))
                    # the kernels' own time (a split call: both kernels)
                    row[f"device_ms_{var}"] = device_ms(
                        lambda: fa.flash_attention(q, k, v, variant=var, **kw))
                row["plain_ms"] = cuda_ms(
                    lambda: plain.attention_ref(q, k, v, **kw), reps=3)
                mask = kv_pos[:, None, :] >= 0
                if causal:
                    mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
                else:
                    mask = mask.expand(B, Sq, Skv)
                pairs = int(mask.sum())
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                if name.endswith(("source_prefill", "memory_self",
                                  "prompt_self")):
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
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms "
                    f"({dispatched}, {nsplit} split; wgmma "
                    f"{row['ms_wgmma']:.4f}, mma.sync "
                    f"{row['ms_mma_sync']:.4f}; device wgmma "
                    f"{row['device_ms_wgmma']:.4f}, mma.sync "
                    f"{row['device_ms_mma_sync']:.4f}), plain "
                    f"{row['plain_ms']:.4f} ms, sdpa "
                    f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                    f" ms ({row['bound_by']})")
            del q, k, v, ref, ref_lse
        torch.cuda.empty_cache()
        flash_rows.append(row)

    mx_rows = []
    for name, B, Mx, Tx, D in (("memory_xattn", 1, m, T, 2304),
                               ("granite_memory_xattn", 1, m, T, 1536),
                               ("mistral_memory_xattn", 1, 768, 2 * T, 4096)):
        picked = mx.variant_for(torch.bfloat16, B, Mx, Tx, D, True)
        row = {"shape": name, "q": [B, Mx, D], "kv": [B, Tx, D],
               "variant": picked,
               "nsplit": mx.num_splits(B, Mx, Tx, D)}
        dtypes = ((torch.bfloat16,) if name.startswith("mistral")
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            q = rand(B, Mx, D, dtype=dtype)
            k = rand(B, Tx, D, dtype=dtype)
            v = rand(B, Tx, D, dtype=dtype)
            ref = plain.memcom_xattn_ref(q, k, v)
            if dtype is torch.float32:
                out = mx.memcom_xattn(q, k, v)
                torch.cuda.synchronize()
                row[f"max_abs_err_{dn}"], row[f"scaled_err_{dn}"] = check(
                    "memcom_xattn", name, dn, out, ref)
                del q, k, v, out, ref
                continue
            # both bf16 kernels, each forced and held to the plain version
            for var in ("wgmma", "mma_sync"):
                out = mx.memcom_xattn(q, k, v, variant=var)
                torch.cuda.synchronize()
                extra = ""
                if var == "wgmma":
                    tiled = plain.memcom_xattn_tiled(q, k, v,
                                                     splits=row["nsplit"])
                    row["tiled_err"] = err(out, tiled)
                    row["tiled_scaled_err"] = plain.scaled_err(out, tiled)
                    tiled = plain.memcom_xattn_tiled(
                        q.float(), k.float(), v.float(), splits=row["nsplit"])
                    row["tiled_ulps"] = plain.bf16_ulps(out, tiled)
                    extra = (f", vs memcom_xattn_tiled {row['tiled_err']:.3e}"
                             f" / scaled {row['tiled_scaled_err']:.3e} / "
                             f"{row['tiled_ulps']:.4f} bf16 steps from its "
                             "float32 value")
                    del tiled
                e, se = check("memcom_xattn", f"{name}_{var}", dn, out, ref,
                              extra=extra)
                row[f"max_abs_err_{dn}_{var}"] = e
                row[f"scaled_err_{dn}_{var}"] = se
                del out
            for key in ("max_abs_err", "scaled_err"):
                row[f"{key}_{dn}"] = max(row[f"{key}_{dn}_wgmma"],
                                         row[f"{key}_{dn}_mma_sync"])
            # three input sets (30 MB each at D 2304) past the 50 MB L2
            bufs = [(q, k, v)] + [tuple(rand(*x.shape, dtype=dtype)
                                        for x in (q, k, v))
                                  for _ in range(2)]
            for var in ("wgmma", "mma_sync"):
                def call(q_, k_, v_, var=var):
                    return mx.memcom_xattn(q_, k_, v_, variant=var)
                row[f"ms_{var}"] = cuda_ms(lambda: call(q, k, v))
                row[f"device_ms_{var}"] = device_ms(call, 21, bufs)
                row[f"workspace_bytes_{var}"] = mx.workspace_bytes(
                    B, Mx, Tx, dtype, var)
            del bufs
            row["ms"] = row[f"ms_{picked}"]
            row["device_ms"] = row[f"device_ms_{picked}"]
            row["workspace_bytes"] = row[f"workspace_bytes_{picked}"]
            row["plain_ms"] = cuda_ms(
                lambda: plain.memcom_xattn_ref(q, k, v), reps=3)
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None]), reps=3)
            flops = 4 * B * Mx * Tx * D
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
            row["flops"], row["bytes"] = flops, nbytes
            log(f"  {name} bf16: kernel {row['ms']:.4f} ms ({picked}, "
                f"{row['nsplit']} splits; wgmma {row['ms_wgmma']:.4f}, "
                f"mma.sync {row['ms_mma_sync']:.4f}; device wgmma "
                f"{row['device_ms_wgmma']:.4f}, mma.sync "
                f"{row['device_ms_mma_sync']:.4f}), plain "
                f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f}"
                f" ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), workspace wgmma "
                f"{row['workspace_bytes_wgmma']} / mma.sync "
                f"{row['workspace_bytes_mma_sync']} bytes")
            del q, k, v, ref
        torch.cuda.empty_cache()
        mx_rows.append(row)

    def paged_inputs(B, S, Hq, Hkv, Dh, bs, lengths, share, dtype, table):
        """Pools of shuffled blocks; slot b + 2 shares slot b's first
        ``share`` table entries (a task prefix seated in two slots);
        entries past a slot's length name block 0.  The tables hold
        ``table`` positions (an engine's max_len)."""
        nb = -(-table // bs)
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
    main_lens = [m + 8, m + 11, m + 4, m + 12]
    paged_cases = [
        # name, B, S, Hq, Hkv, D, block size, lengths, shared blocks, softcap,
        # table positions
        ("decode", slots, 1, 8, 4, 256, 16, main_lens, pm, 50.0, max_len),
        ("decode_s3", slots, 3, 8, 4, 256, 16, main_lens, pm, 50.0, max_len),
        # the fused paged step: W = 4 verify lanes and a 16-token join,
        # the lengths counting the W new rows
        *((f"fused_w{W_}", slots, W_, 8, 4, 256, 16,
           [n + W_ for n in main_lens], pm, 50.0, max_len) for W_ in (4, 16)),
        ("block8_boundary", slots, 1, 8, 4, 256, 8, [m, m + 8, 8, 1], 0, 50.0,
         max_len),
        ("block12", slots, 1, 8, 4, 256, 12, main_lens, m // 12, 50.0,
         max_len),
        ("masked_rows", 2, 3, 8, 4, 256, 16, [2, 40], 0, 50.0, max_len),
        ("mistral_width", slots, 1, 32, 8, 128, 16, main_lens, pm, 50.0,
         max_len),
        ("granite_decode", slots, 1, 24, 8, 64, 16, main_lens, pm, 0.0,
         max_len),
        # an engine with max_len 4096 and young slots: splits follow the
        # slots' lengths, not the table's width
        ("long_table", slots, 1, 8, 4, 256, 16, main_lens, pm, 50.0, 4096),
    ]
    paged_rows = []
    for name, B, S, hq, hkv, Dh, bs, lens, share, cap, table in paged_cases:
        row = {"shape": name, "q": [B, S, hq, Dh], "block_size": bs,
               "lengths": lens, "shared_blocks": share, "softcap": cap,
               "table": table}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            inputs = paged_inputs(B, S, hq, hkv, Dh, bs, lens, share, dtype,
                                  table)
            q, kp, vp, tables, lengths_t = inputs
            kw = dict(block_tables=tables, lengths=lengths_t, softcap=cap)
            out = pa.paged_flash_decode(q, kp, vp, **kw)
            torch.cuda.synchronize()
            ref = plain.paged_decode_attention_ref(q, kp, vp, **kw)
            dead = (lengths_t[:, None] - S + torch.arange(S, device=dev)[None]
                    < 0)
            dead_ok = not bool(dead.any()) or float(
                out[dead].float().abs().max()) == 0.0
            row[f"max_abs_err_{dn}"], row[f"scaled_err_{dn}"] = check(
                "paged_flash_decode", name, dn, out, ref, dead_ok,
                f", masked rows {int(dead.sum())} exact={dead_ok}")
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
                # rotated input sets whose K/V rows read add up past the
                # 50 MB L2, so that no call finds its rows there
                sets = -(-60_000_000 // nbytes)
                bufs = [inputs] + [paged_inputs(B, S, hq, hkv, Dh, bs, lens,
                                                share, dtype, table)
                                   for _ in range(sets - 1)]
                row["device_ms"] = device_ms(
                    lambda q_, k_, v_, t_, l_: pa.paged_flash_decode(
                        q_, k_, v_, block_tables=t_, lengths=l_, softcap=cap),
                    2 * sets, bufs)
                row["device_sets"] = sets
                row["nsplit"] = pa.num_splits(
                    B, S, hq, hkv, tables.shape[1], bs,
                    torch.cuda.get_device_properties(0).multi_processor_count)
                del bufs
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms (device "
                    f"{row['device_ms']:.5f} over {sets} input sets, "
                    f"{row['nsplit']} splits), plain "
                    f"{row['plain_ms']:.4f} ms, no library call, bound "
                    f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                    f"{len(visible)} distinct K/V rows in "
                    f"{row['distinct_blocks']} blocks, {nbytes} bytes)")
            del q, kp, vp, out, ref, inputs
        torch.cuda.empty_cache()
        paged_rows.append(row)

    E_g = 40  # granite's experts
    gmm_variants = ("wgmma", "rows", "mma_sync")
    gmm_rows = []
    torch.cuda.synchronize()
    gmm_mem0 = torch.cuda.memory_allocated()
    # the main paths' C (source prefill, Memory-LLM, prompt prefill and
    # decode), then probes between them (bf16 only) that set variant_for's
    # rule
    for C in (768, 128, 8, 64, 32, 16):
        for D, Fd in ((1536, 512), (512, 1536)):
            probe = C not in (768, 128, 8)
            name = f"{'probe_' if probe else ''}C{C}_{D}to{Fd}"
            dispatched = gm.variant_for(torch.bfloat16, C, D, Fd, True)
            row = {"shape": name, "x": [E_g, C, D], "w": [E_g, D, Fd],
                   "variant": dispatched}
            for dtype in ((torch.bfloat16,) if probe
                          else (torch.float32, torch.bfloat16)):
                dn = str(dtype).split(".")[1]
                x = rand(E_g, C, D, dtype=dtype)
                w = rand(E_g, D, Fd, dtype=dtype, scale=D ** -0.5)
                ref = plain.gmm_ref(x, w)
                if dtype is torch.float32:
                    out = gm.gmm(x, w)
                    torch.cuda.synchronize()
                    row[f"max_abs_err_{dn}"], row[f"scaled_err_{dn}"] = check(
                        "gmm", name, dn, out, ref)
                    del x, w, out, ref
                    continue
                # every bf16 kernel that takes the shape, forced, each
                # held to the plain version
                variants = [v for v in gmm_variants
                            if gm.takes(v, dtype, E_g, C, D, Fd, True)]
                for var in variants:
                    out = gm.gmm(x, w, variant=var)
                    torch.cuda.synchronize()
                    e, se = check("gmm", f"{name}_{var}", dn, out, ref)
                    row[f"max_abs_err_{dn}_{var}"] = e
                    row[f"scaled_err_{dn}_{var}"] = se
                    del out
                for key in ("max_abs_err", "scaled_err"):
                    row[f"{key}_{dn}"] = max(row[f"{key}_{dn}_{v}"]
                                             for v in variants)
                # three buffer sets (189 MB of weights) for the device times
                bufs = [(x, w)] + [(rand(E_g, C, D, dtype=dtype),
                                    rand(E_g, D, Fd, dtype=dtype,
                                         scale=D ** -0.5)) for _ in range(2)]
                flops = 2 * E_g * C * D * Fd
                nbytes = 2 * (x.numel() + w.numel() + E_g * C * Fd)
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                row["ms"] = cuda_ms(lambda: gm.gmm(x, w))
                for var in variants:
                    row[f"ms_{var}"] = cuda_ms(
                        lambda: gm.gmm(x, w, variant=var))
                    row[f"device_ms_{var}"] = device_ms(
                        lambda a, b: gm.gmm(a, b, variant=var), 21, bufs)
                    row[f"tflops_{var}"] = flops / row[f"device_ms_{var}"] / 1e9
                row["plain_ms"] = cuda_ms(lambda: plain.gmm_ref(x, w), reps=3)
                row["library_ms"] = cuda_ms(lambda: torch.bmm(x, w))
                row["library_device_ms"] = device_ms(torch.bmm, 21, bufs)
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms ({dispatched});"
                    " device (3 buffer sets) "
                    + ", ".join(f"{v} {row[f'device_ms_{v}']:.4f} "
                                f"({row[f'tflops_{v}']:.0f} TFLOP/s)"
                                for v in variants)
                    + f"; bmm {row['library_device_ms']:.4f} (events "
                    f"{row['library_ms']:.4f}); plain {row['plain_ms']:.4f}"
                    f" ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}"
                    f", {flops} flops, {nbytes} bytes)")
                del x, w, ref, bufs
            torch.cuda.empty_cache()
            gmm_rows.append(row)
    # torch.bmm under graph capture leaves a cuBLAS workspace (32 MiB on
    # Hopper) held for the capture stream
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    log(f"  gmm phase: {torch.cuda.memory_allocated() - gmm_mem0} bytes "
        "left allocated after it")

    def ssd_inputs(B, S, H, P, G, N, dtype, init, big):
        """dt and A as a seeded Mamba2 layer makes them (softplus of unit
        normals; -exp of U(-1, 1)), or dt·|A| = 25 a token (``big``: the
        decay sums past 100 within any chunk); B and C scaled so that C·B
        is O(1)."""
        x = rand(B, S, H, P, dtype=dtype)
        Bm = rand(B, S, G, N, dtype=dtype, scale=0.5 * N ** -0.25)
        Cm = rand(B, S, G, N, dtype=dtype, scale=0.5 * N ** -0.25)
        if big:
            dt = torch.full((B, S, H), 5.0, device=dev)
            A = torch.full((H,), -5.0, device=dev)
        else:
            dt = F.softplus(rand(B, S, H, dtype=torch.float32, scale=1.0))
            A = -torch.exp(torch.rand(H, generator=gen, device=dev) * 2 - 1)
        h0 = rand(B, H, P, N, dtype=torch.float32) if init else None
        return x, dt, A, Bm, Cm, h0

    def ssd_design_bytes(B, S, H, P, G, N, init):
        """The bytes the chunked variant moves: x, B and dt read by phases
        1 and 3, C by phase 3, y written, the initial state read and the
        final one written; per chunk of ss.CHUNK_Q tokens the states four
        times (S_c written in float32 and read by phase 2, the entering
        state written and read as a bf16 pair) and e^{cum_Q} twice."""
        nc = -(-S // ss.CHUNK_Q)
        x_b, bc_b, dt_b = B * S * H * P * 2, B * S * G * N * 2, B * S * H * 4
        return (2 * (x_b + bc_b + dt_b) + bc_b + x_b
                + 4 * B * H * P * N * (2 if init else 1)
                + 16 * B * nc * H * P * N + 8 * B * nc * H)

    def ssd_work(B, S, H, P, G, N, init, elt):
        """The scan's least operations and the bytes it must move: x and
        y, B and C in their type, dt, the initial and final state in
        float32.  The chunked form at Q tokens costs 2Q(N + P) + 4NP per
        token and head (C·Bᵀ, its product with x, the state's update and
        read), least at Q = 1."""
        flops = B * S * H * (2 * N + 2 * P + 4 * N * P)
        nbytes = (2 * B * S * H * P + 2 * B * S * G * N) * elt + 4 * (
            B * S * H + H + (2 if init else 1) * B * H * P * N)
        return flops, nbytes

    mamba_S = T + prompt_len  # a many-shot prompt and a 12-token query
    ssd_cases = [
        # name, B, S, H, P, G, N, initial state, dt·|A| past 100 a chunk
        ("prefill", 1, mamba_S, 32, 64, 1, 128, True, False),
        ("prompt12", 1, prompt_len, 32, 64, 1, 128, False, False),
        ("ragged_1000", 1, 1000, 32, 64, 1, 128, True, False),
        ("groups2", 1, 512, 32, 64, 2, 128, True, False),
        ("decay_past_100", 1, 512, 32, 64, 1, 128, True, True),
        # probes (bf16 only) between the lengths above, that set
        # ss.variant_for's rule
        ("probe_S64", 1, 64, 32, 64, 1, 128, True, False),
        ("probe_S128", 1, 128, 32, 64, 1, 128, True, False),
        ("probe_S256", 1, 256, 32, 64, 1, 128, True, False),
    ]
    ssd_variants = ("chunked", "sequential")

    ssd_rows = []
    for name, B, S, H, P, G, N, init, big in ssd_cases:
        row = {"shape": name, "x": [B, S, H, P], "bc": [B, S, G, N],
               "init_state": init, "decay_past_100": big}

        def ssd_check(label, dn, y, hf, y_ref, hf_ref, extra=""):
            finite = bool(torch.isfinite(y.float()).all()
                          & torch.isfinite(hf).all())
            e_h, se_h = err(hf, hf_ref), plain.scaled_err(hf, hf_ref)
            e, se = check("ssd", label, dn, y, y_ref,
                          finite and e_h <= TOL[dn] and se_h <= REL_TOL[dn],
                          f", final state max abs err {e_h:.3e} scaled "
                          f"{se_h:.3e}, finite {finite}{extra}")
            return max(e, e_h), max(se, se_h)

        for dtype in ((torch.bfloat16,) if name.startswith("probe")
                      else (torch.float32, torch.bfloat16)):
            dn = str(dtype).split(".")[1]
            x, dt, A, Bm, Cm, h0 = ssd_inputs(B, S, H, P, G, N, dtype, init,
                                              big)
            wide = [None if a is None
                    else a.double() if dtype is torch.float32 else a
                    for a in (x, dt, A, Bm, Cm, h0)]
            y_ref, hf_ref = plain.ssd_ref(*wide[:5], init_state=wide[5])
            if dtype is torch.float32:  # the sequential kernel's alone
                y, hf = ss.ssd(x, dt, A, Bm, Cm, init_state=h0)
                torch.cuda.synchronize()
                y32, hf32 = plain.ssd_ref(x, dt, A, Bm, Cm, init_state=h0)
                row[f"max_abs_err_{dn}"], row[f"scaled_err_{dn}"] = ssd_check(
                    name, dn, y, hf, y_ref, hf_ref,
                    f"; float32 plain from float64: y scaled "
                    f"{plain.scaled_err(y32, y_ref):.3e}, state scaled "
                    f"{plain.scaled_err(hf32, hf_ref):.3e}")
                del x, dt, A, Bm, Cm, h0, y, hf, y_ref, hf_ref, wide, y32, hf32
                continue
            # every bf16 kernel that takes the shape, forced, each held to
            # the plain version
            variants = [v for v in ssd_variants
                        if ss.takes(v, dtype, P, N, True)]
            for var in variants:
                y, hf = ss.ssd(x, dt, A, Bm, Cm, init_state=h0, variant=var)
                torch.cuda.synchronize()
                (row[f"max_abs_err_{dn}_{var}"],
                 row[f"scaled_err_{dn}_{var}"]) = ssd_check(
                    f"{name}_{var}", dn, y, hf, y_ref, hf_ref)
                del y, hf
            for k in ("max_abs_err", "scaled_err"):
                row[f"{k}_{dn}"] = max(v for key, v in row.items()
                                       if key.startswith(f"{k}_{dn}_"))
            row["variant"] = ss.variant_for(dtype, S, P, N, True)
            # three input sets (15 MB each at the prefill) for the device
            # times, so that no call reads its inputs from the 50 MB L2
            bufs = [(x, dt, A, Bm, Cm, h0)] + [
                ssd_inputs(B, S, H, P, G, N, dtype, init, big)
                for _ in range(2)]
            row["ms"] = cuda_ms(lambda: ss.ssd(x, dt, A, Bm, Cm,
                                               init_state=h0))
            for var in variants:
                row[f"ms_{var}"] = cuda_ms(lambda: ss.ssd(
                    x, dt, A, Bm, Cm, init_state=h0, variant=var))
                row[f"device_ms_{var}"] = device_ms(
                    lambda *a: ss.ssd(*a[:5], init_state=a[5], variant=var),
                    21, bufs)
            row["plain_ms"] = cuda_ms(
                lambda: plain.ssd_ref(x, dt, A, Bm, Cm, init_state=h0),
                reps=3)
            row["library_ms"] = None  # no PyTorch call runs the scan
            flops, nbytes = ssd_work(B, S, H, P, G, N, init, 2)
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
            row["flops"], row["bytes"] = flops, nbytes
            row["chunk_q"] = ss.CHUNK_Q
            row["design_bytes"] = ssd_design_bytes(B, S, H, P, G, N, init)
            row["design_bound_ms"] = row["design_bytes"] / PEAK_BYTES * 1e3
            log(f"  {name} bf16: kernel {row['ms']:.4f} ms ({row['variant']}"
                f", Q {ss.CHUNK_Q}); device (3 input sets) "
                + ", ".join(f"{v} {row[f'device_ms_{v}']:.4f}"
                            for v in variants)
                + f"; plain {row['plain_ms']:.4f} ms, no library call; "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {flops}"
                f" flops, {nbytes} bytes); the chunked design moves "
                f"{row['design_bytes']} bytes, "
                f"{row['design_bound_ms']:.4f} ms at 3.35 TB/s")
            del x, dt, A, Bm, Cm, h0, y_ref, hf_ref, wide, bufs
        ssd_rows.append(row)
    torch.cuda.empty_cache()

    # ---- 3f. backward kernels ------------------------------------------
    # Each backward kernel against its plain backward (explicit formulas)
    # on the same inputs: float32 (TF32 off) max abs error at most 1e-4 of
    # max(1, the largest gradient), bf16 ``plain.grad_err`` at most 2e-2,
    # per gradient.  Shapes of the training step (batch 2, the 512-token
    # target segment behind m = 512 memory rows, the 3072-token source).
    from torch.nn.attention import SDPBackend, sdpa_kernel

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def grad_check(kernel, name, dn, got, want, zero_rows=None):
        """``zero_rows``: {gradient: boolean mask of its rows} of rows that
        get no gradient by their positions, which must be exactly 0."""
        errs = {}
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            e, ge = err(g, w), plain.grad_err(g, w)
            se = plain.scaled_err(g, w)
            w32 = w.float()
            row = w32.pow(2).mean(dim=-1).sqrt()
            floored = int((row < plain.GRAD_NOISE_FLOOR
                           * w32.pow(2).mean().sqrt()).sum())
            scale_ = max(1.0, float(w32.abs().max()))
            ok = (e <= 1e-4 * scale_) if dn == "float32" \
                else (ge <= REL_TOL["bfloat16"])
            zeros_ok = zero_rows is None or gname not in zero_rows or \
                not bool(g[zero_rows[gname]].ne(0).any())
            errs[gname] = (e, ge, se, floored)
            if not (ok and zeros_ok):
                raise AssertionError(
                    f"{kernel} {name} {dn} {gname} disagrees with its plain "
                    f"backward: max abs err {e:.3e} (largest |grad| "
                    f"{scale_:.3e}), grad err {ge:.3e} (scaled err "
                    f"{se:.3e}, {floored} rows at the noise floor), "
                    f"rows with no gradient exactly 0: {zeros_ok}")
            del w32, row
        log(f"{kernel} {name} {dn}: " + ", ".join(
            f"{k} max_abs_err {e:.3e} grad_err {ge:.3e} (scaled_err "
            f"{se:.3e}, {fl} rows at the noise floor)"
            for k, (e, ge, se, fl) in errs.items()))
        return (max(v[0] for v in errs.values()),
                max(v[1] for v in errs.values()))

    def tiled_ulps(got, tiled):
        """``plain.bf16_ulps`` of a gradient from its tiled restatement
        over the rows above ``plain.GRAD_NOISE_FLOOR`` (a one-key dq row
        without an lse cotangent is float32 noise in both)."""
        t32 = tiled.float()
        row_rms = t32.pow(2).mean(dim=-1).sqrt()
        keep = row_rms >= plain.GRAD_NOISE_FLOOR * t32.pow(2).mean().sqrt()
        return plain.bf16_ulps(got[keep], tiled[keep])

    def library_bwd(sets, **sdpa_kw):
        """The backward of one ``F.scaled_dot_product_attention`` call on
        the same (B, H, S, D) inputs ``sets`` (several sets of q, k, v,
        dout), on the first backend that takes it; returns (ms of
        ``torch.autograd.grad`` alone on the first set by CUDA events,
        its device ms by graph replay over the sets: forward and backward
        less the forward alone, backend)."""
        leaves = [[x.detach().requires_grad_(True) for x in st[:3]]
                  + [st[3]] for st in sets]
        xs, dout_ = leaves[0][:3], leaves[0][3]
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([backend]):
                    o_ = F.scaled_dot_product_attention(*xs, **sdpa_kw)
                    torch.autograd.grad(o_, xs, dout_, retain_graph=True)
                    torch.cuda.synchronize()
                    ms_ = cuda_ms(lambda: torch.autograd.grad(
                        o_, xs, dout_, retain_graph=True), reps=5)
                del o_
                break
            except RuntimeError:
                continue
        else:
            return None, None, None

        def fwd(q_, k_, v_, d_):
            return F.scaled_dot_product_attention(q_, k_, v_, **sdpa_kw)

        def fwd_bwd(q_, k_, v_, d_):
            return torch.autograd.grad(fwd(q_, k_, v_, d_), (q_, k_, v_), d_)

        try:
            with sdpa_kernel([backend]):
                dev_ = (device_ms(fwd_bwd, 21, leaves)
                        - device_ms(fwd, 21, leaves))
        except RuntimeError as exc:  # the call is timed by events alone
            log(f"  sdpa {backend.name} backward not timed by graph "
                f"replay: {str(exc).splitlines()[0]}")
            dev_ = None
        del leaves, xs
        return ms_, dev_, backend.name

    bwd_cases = [
        # name, B, Sq, Skv, q_pos, kv_pos, causal, heads, dlse, dtypes
        ("memory_self_bwd", 2, m, m, arange(0, m)[None].expand(2, m),
         arange(0, m)[None].expand(2, m), True, gemma_heads, False,
         ("float32", "bfloat16")),
        ("prompt_self_bwd", 2, m, m, arange(m, m)[None].expand(2, m),
         arange(m, m)[None].expand(2, m), True, gemma_heads, True,
         ("float32", "bfloat16")),
        ("prompt_prefix_bwd", 2, m, m, arange(m, m)[None].expand(2, m),
         arange(0, m)[None].expand(2, m), False, gemma_heads, True,
         ("float32", "bfloat16")),
        ("source_bwd", 1, T, T, arange(0, T)[None], arange(0, T)[None], True,
         gemma_heads, False, ("bfloat16",)),
        ("masked_rows_bwd", 2, 40, 70, arange(-8, 40)[None].expand(2, 40),
         torch.where((arange(0, 70) >= 5) & (arange(0, 70) < 9), -1,
                     arange(0, 70))[None].expand(2, 70), True, gemma_heads,
         True, ("float32", "bfloat16")),
        ("granite_memory_self_bwd", 2, m, m, arange(0, m)[None].expand(2, m),
         arange(0, m)[None].expand(2, m), True, granite_heads, False,
         ("float32", "bfloat16")),
        ("mistral_memory_self_bwd", 2, m, m, arange(0, m)[None].expand(2, m),
         arange(0, m)[None].expand(2, m), True, mistral_heads, False,
         ("bfloat16",)),
        ("float32_hd32_bwd", 2, m, m, arange(0, m)[None].expand(2, m),
         arange(0, m)[None].expand(2, m), True, (8, 4, 32, 0.0), True,
         ("float32",)),
    ]
    flash_bwd_rows = []
    for (name, B, Sq, Skv, q_pos, kv_pos, causal, heads, with_dlse,
         dtypes) in bwd_cases:
        Hq, Hkv, D, cap = heads
        q_pos, kv_pos = q_pos.contiguous(), kv_pos.contiguous()
        row = {"shape": name, "q": [B, Sq, Hq, D], "kv": [B, Skv, Hkv, D],
               "causal": causal, "softcap": cap, "dlse": with_dlse}
        for dn in dtypes:
            dtype = getattr(torch, dn)
            q, dout = (rand(B, Sq, Hq, D, dtype=dtype) for _ in range(2))
            k, v = (rand(B, Skv, Hkv, D, dtype=dtype) for _ in range(2))
            kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, softcap=cap)
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            dlse = (rand(B, Sq, Hq, dtype=torch.float32) if with_dlse
                    else None)
            want = plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse, **kw)
            # queries that see no key and keys that no query sees
            seen = kv_pos[:, None, :] >= 0
            if causal:
                seen = seen & (kv_pos[:, None, :] <= q_pos[:, :, None])
            seen = seen.expand(B, Sq, Skv)
            zero_rows = {"dq": ~seen.any(dim=2), "dk": ~seen.any(dim=1),
                         "dv": ~seen.any(dim=1)}
            # bf16: both kernels, each forced; the wgmma one also against
            # its own arithmetic (plain.attention_bwd_tiled) in bf16 steps,
            # over the rows grad_err holds by their own scale
            variants = ("wgmma", "mma_sync") if dn == "bfloat16" else (None,)
            errs = []
            for vn in variants:
                before = fa.bwd_wgmma_launches
                got = fa.flash_attention_bwd(q, k, v, out, lse, dout, dlse,
                                             variant=vn, **kw)
                torch.cuda.synchronize()
                if fa.bwd_wgmma_launches - before != (vn == "wgmma"):
                    raise AssertionError(f"flash_attention_bwd {name}: "
                                         f"variant {vn} not counted")
                errs.append(grad_check(
                    "flash_attention_bwd" + (f"[{vn}]" if vn else ""), name,
                    dn, got, want, zero_rows))
                if vn == "wgmma":
                    tiled = plain.attention_bwd_tiled(
                        *(x.float() for x in (q, k, v, out)), lse,
                        dout.float(), dlse, split_at=fa.bwd_split_at(
                            B, Sq, Skv, Hq, Hkv, D, causal, sms), **kw)
                    row["tiled_ulps"] = {
                        g: tiled_ulps(a, b) for g, a, b in zip(
                            ("dq", "dk", "dv"), got, tiled)}
                    log(f"  {name} wgmma vs plain.attention_bwd_tiled, bf16 "
                        f"steps: {row['tiled_ulps']}")
                    del tiled
                del got
            row[f"max_abs_err_{dn}"] = max(e[0] for e in errs)
            row[f"grad_err_{dn}"] = max(e[1] for e in errs)
            pairs = int(seen.sum())
            del seen, zero_rows, want
            if dn == "bfloat16" and name != "masked_rows_bwd":
                row["variant"] = fa.bwd_variant_for(dtype, D, Sq * Hq // Hkv,
                                                    Skv)
                # three input sets, so that no replayed call finds its
                # inputs (25 MB at the Memory-LLM's shape) in the 50 MB L2
                sets = [(q, k, v, dout)] + [
                    tuple(rand(*x.shape, dtype=dtype) for x in (q, k, v, dout))
                    for _ in range(2)]
                bufs = [(q, k, v, dout, out, lse, dlse)] + [
                    st + tuple(fa.flash_attention(*st[:3], return_lse=True,
                                                  **kw))
                    + ((rand(B, Sq, Hq, dtype=torch.float32)
                        if with_dlse else None),) for st in sets[1:]]
                for vn in variants:
                    row[f"ms_{vn}"] = cuda_ms(
                        lambda: fa.flash_attention_bwd(
                            q, k, v, out, lse, dout, dlse, variant=vn, **kw))
                    row[f"device_ms_{vn}"] = device_ms(
                        lambda q_, k_, v_, d_, o_, l_, dl_:
                        fa.flash_attention_bwd(
                            q_, k_, v_, o_, l_, d_, dl_, variant=vn, **kw),
                        21, bufs)
                row["ms"] = row[f"ms_{row['variant']}"]
                row["device_ms"] = row[f"device_ms_{row['variant']}"]
                del bufs
                row["plain_ms"] = cuda_ms(lambda: plain.attention_bwd_ref(
                    q, k, v, out, lse, dout, dlse, **kw), reps=3)
                if causal and Sq == Skv:
                    sdpa_kw = dict(is_causal=True, enable_gqa=True)
                else:
                    sdpa_kw = dict(enable_gqa=True)
                (row["library_ms"], row["library_device_ms"],
                 row["library_backend"]) = library_bwd(
                    [tuple(x.transpose(1, 2) for x in st) for st in sets],
                    **sdpa_kw)
                del sets
                # five products (S, dP, dV, dK, dQ) against the forward's
                # two; q, k, v, out, dout read once, dq, dk, dv written once
                flops = 10 * D * Hq * pairs
                nbytes = 2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel()
                              + q.numel()) + 4 * (2 * lse.numel()
                                                  + q_pos.numel()
                                                  + kv_pos.numel())
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms (device "
                    f"{row['device_ms']:.4f}; {row['variant']}; wgmma "
                    f"{row['ms_wgmma']:.4f} ms, device "
                    f"{row['device_ms_wgmma']:.4f}; mma.sync "
                    f"{row['ms_mma_sync']:.4f} ms, device "
                    f"{row['device_ms_mma_sync']:.4f}), plain "
                    f"{row['plain_ms']:.4f} ms, sdpa backward "
                    f"{row['library_ms']} ms (device "
                    f"{row['library_device_ms']}; "
                    f"{row['library_backend']}, no cap), bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            del q, k, v, dout, out, lse, dlse
        torch.cuda.empty_cache()
        flash_bwd_rows.append(row)
    del bwd_cases

    mx_bwd_rows = []
    for name, B, Mx, Tx, D, dtypes in (
            ("memory_xattn_bwd", 2, m, T, 2304, ("float32", "bfloat16")),
            ("granite_memory_xattn_bwd", 1, m, T, 1536,
             ("float32", "bfloat16")),
            ("mistral_memory_xattn_bwd", 1, 768, 2 * T, 4096,
             ("bfloat16",))):
        row = {"shape": name, "q": [B, Mx, D], "kv": [B, Tx, D]}
        for dn in dtypes:
            dtype = getattr(torch, dn)
            q, dout = (rand(B, Mx, D, dtype=dtype) for _ in range(2))
            k, v = (rand(B, Tx, D, dtype=dtype) for _ in range(2))
            out, lse = mx.memcom_xattn(q, k, v, return_lse=True)
            want = plain.memcom_xattn_bwd_ref(q, k, v, dout)
            variants = ("wgmma", "mma_sync") if dn == "bfloat16" else (None,)
            errs = []
            for vn in variants:
                got = mx.memcom_xattn_bwd(q, k, v, out, lse, dout, variant=vn)
                torch.cuda.synchronize()
                errs.append(grad_check(f"memcom_xattn_bwd {vn or ''}".strip(),
                                       name, dn, got, want))
                del got
            row[f"max_abs_err_{dn}"] = max(e for e, _ in errs)
            row[f"grad_err_{dn}"] = max(g for _, g in errs)
            del want
            if dn == "bfloat16":
                # three input sets past the 50 MB L2 (62 MB each at D 2304)
                bufs = [(q, k, v, dout, out, lse)]
                for _ in range(2):
                    st = tuple(rand(*x.shape, dtype=dtype)
                               for x in (q, k, v, dout))
                    bufs.append(st + mx.memcom_xattn(*st[:3],
                                                     return_lse=True))
                row["variant"] = mx.bwd_variant_for(dtype, B, Mx, Tx, D, True)
                for vn in variants:
                    row[f"ms_{vn}"] = cuda_ms(
                        lambda: mx.memcom_xattn_bwd(q, k, v, out, lse, dout,
                                                    variant=vn))
                    row[f"device_ms_{vn}"] = device_ms(
                        lambda q_, k_, v_, d_, o_, l_: mx.memcom_xattn_bwd(
                            q_, k_, v_, o_, l_, d_, variant=vn), 21, bufs)
                    row[f"workspace_bytes_{vn}"] = mx.bwd_workspace_bytes(
                        B, Mx, Tx, dtype, vn)
                for key in ("ms", "device_ms", "workspace_bytes"):
                    row[key] = row[f"{key}_{row['variant']}"]
                row["nsplit"] = mx.bwd_num_splits(B, Mx, Tx, D, sms)
                row["plain_ms"] = cuda_ms(
                    lambda: plain.memcom_xattn_bwd_ref(q, k, v, dout), reps=3)
                (row["library_ms"], row["library_device_ms"],
                 row["library_backend"]) = library_bwd(
                    [tuple(x[:, None] for x in st[:4]) for st in bufs])
                del bufs
                flops = 10 * B * Mx * Tx * D
                nbytes = 2 * (3 * q.numel() + 4 * k.numel())
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms (device "
                    f"{row['device_ms']:.4f}; {row['variant']}, "
                    f"{row['nsplit']} dQ split(s); wgmma "
                    f"{row['ms_wgmma']:.4f} ms, device "
                    f"{row['device_ms_wgmma']:.4f}; mma.sync "
                    f"{row['ms_mma_sync']:.4f} ms, device "
                    f"{row['device_ms_mma_sync']:.4f}), plain "
                    f"{row['plain_ms']:.4f} ms, sdpa backward "
                    f"{row['library_ms']} ms (device "
                    f"{row['library_device_ms']}; "
                    f"{row['library_backend']}), bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                    f"workspace {row['workspace_bytes_wgmma']} bytes "
                    f"(mma.sync {row['workspace_bytes_mma_sync']})")
            del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
        mx_bwd_rows.append(row)
    log(f"backward kernel phase: {time.perf_counter() - t_phase:.1f}s")

    # ---- 3g. gmm and ssd refuse a call autograd would record ---------
    # neither has a backward kernel yet: a call with gradients enabled
    # where an input requires grad raises; under no_grad the same call
    # runs the kernel (granite's and mamba2's shapes)
    f1 = {}
    gx, gw = (rand(40, 8, 1536, dtype=torch.bfloat16),
              rand(40, 1536, 512, dtype=torch.bfloat16))
    sin = ssd_inputs(1, 300, 32, 64, 1, 128, torch.bfloat16, True, False)
    for name, mod, call, needs in (
            ("gmm", gm, lambda: gm.gmm(gx, gw), gw),
            ("ssd", ss, lambda: ss.ssd(*sin[:5], init_state=sin[5]), sin[0])):
        before = mod.launches
        needs.requires_grad_(True)
        try:
            call()
            raised = False
        except NotImplementedError as e:
            raised, msg = True, str(e)
        needs.requires_grad_(False)
        refused = mod.launches == before
        with torch.no_grad():
            needs.requires_grad_(True)
            res = call()
            needs.requires_grad_(False)
        ran = mod.launches == before + 1
        out0 = res[0] if isinstance(res, tuple) else res
        finite = bool(torch.isfinite(out0).all())
        f1[name] = {"raised": raised, "launched_under_no_grad": ran,
                    "finite": finite}
        log(f"F1 {name} on the card: with grad enabled and an input "
            f"requiring grad raises NotImplementedError: {raised}"
            + (f" ({msg[:60]}...)" if raised else "") + "; under no_grad "
            f"the kernel launched: {ran}, output finite: {finite}")
        if not (raised and refused and ran and finite
                and out0.grad_fn is None):
            raise AssertionError(f"F1 {name}: the wrapper did not refuse "
                                 "the call autograd would record")
    report["f1"] = f1
    del gx, gw, sin

    # ---- 4. the main paths at full width ------------------------------
    counters = {"flash_attention": fa, "memcom_xattn": mx,
                "paged_flash_decode": pa, "gmm": gm, "ssd": ss}

    def set_counts():
        for mod in counters.values():
            mod.launches = 0
        fa.wgmma_launches = gm.wgmma_launches = gm.rows_launches = 0
        mx.wgmma_launches = ss.chunked_launches = 0
        fa.bwd_launches = fa.bwd_wgmma_launches = mx.bwd_launches = 0
        mx.bwd_wgmma_launches = 0

    def counts():
        c = {key: mod.launches for key, mod in counters.items()}
        c["flash_attention_wgmma"] = fa.wgmma_launches
        c["memcom_xattn_wgmma"] = mx.wgmma_launches
        c["gmm_wgmma"] = gm.wgmma_launches
        c["gmm_rows"] = gm.rows_launches
        c["ssd_chunked"] = ss.chunked_launches
        c["flash_attention_bwd"] = fa.bwd_launches
        c["flash_attention_bwd_wgmma"] = fa.bwd_wgmma_launches
        c["memcom_xattn_bwd"] = mx.bwd_launches
        c["memcom_xattn_bwd_wgmma"] = mx.bwd_wgmma_launches
        return c

    class SourcePrefills:
        """Counts the flash calls of a run over the ``T``-token source
        prompt (the Source-LLM's prefill) and how many of them the wgmma
        variant took: every one must."""

        def __init__(self, T):
            self.T = T
            self.calls = self.wgmma = 0

        def __enter__(self):
            self.inner = fa.flash_attention

            def spy(q, k, v, **kw):
                before = fa.wgmma_launches
                out = self.inner(q, k, v, **kw)
                if q.shape[1] == self.T:
                    self.calls += 1
                    self.wgmma += fa.wgmma_launches - before
                return out

            fa.flash_attention = spy
            return self

        def __exit__(self, *exc):
            fa.flash_attention = self.inner

    class GmmByRows:
        """Counts a run's ``gmm`` calls by their rows C and by the kernel
        that took each; ``check`` requires every C = 768 call (the source
        prefill) to go through the wgmma kernel and every C = 8 call (the
        prompt prefill and decode) through the rows kernel."""

        def __init__(self):
            self.by_c = {}

        def __enter__(self):
            self.inner = gm.gmm

            def spy(x, w, **kw):
                before = (gm.launches, gm.wgmma_launches, gm.rows_launches)
                out = self.inner(x, w, **kw)
                c = self.by_c.setdefault(int(x.shape[1]), {
                    "calls": 0, "wgmma": 0, "rows": 0, "other": 0})
                wgmma = gm.wgmma_launches - before[1]
                rows = gm.rows_launches - before[2]
                c["calls"] += 1
                c["wgmma"] += wgmma
                c["rows"] += rows
                c["other"] += gm.launches - before[0] - wgmma - rows
                return out

            gm.gmm = spy
            return self

        def __exit__(self, *exc):
            gm.gmm = self.inner

        def check(self, tag, path):
            log(f"{tag} gmm calls by rows C, {path}: {self.by_c}")
            for C, want in ((768, "wgmma"), (8, "rows")):
                c = self.by_c.get(C)
                if c is not None and c[want] != c["calls"]:
                    raise AssertionError(f"{tag} {path}: {c['calls']} gmm "
                                         f"calls at C = {C}, {c[want]} "
                                         f"through the {want} kernel")
            return self.by_c

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

    vocab = SyntheticVocab()
    rng = np.random.default_rng(0)
    sources = []
    for _ in range(2):
        task = ICLTaskSpec(vocab, num_labels=8, keys_per_label=4)
        sources.append(build_manyshot_prompt(task, make_episode(task, rng),
                                             rng, budget=T))
    prompts = [rng.integers(4, vocab.size, n).astype(np.int32)
               for n in (4, 9, prompt_len, 7)]

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(tag, phase, fn):
        """Wall time, device busy time, idle share and the top kernels of
        one warm call of ``fn`` under the profiler.  Device busy is the
        union of the kernels' time intervals (kernel events only: an aten
        op's own entry repeats the device time of the kernels it
        launched)."""
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
        out = {"wall_s": wall, "device_busy_s": busy, "kernels": len(kernels),
               "idle_share": max(0.0, 1 - busy / wall),
               "top": [(name[:60], us / 1e3, n) for name, (us, n) in top],
               "by_name": {name: (us / 1e3, n)
                           for name, (us, n) in by_name.items()}}
        log(f"{tag} profile {phase}: wall {wall:.4f}s, device busy "
            f"{busy:.4f}s over {len(kernels)} kernels, idle share "
            f"{out['idle_share']:.3f}")
        for name, ms, n in out["top"]:
            log(f"    {ms:9.3f} ms  x{n:<5d} {name}")
        return out

    def main_path(arch, need, geom, then=None):
        """Compress -> dense serve, then a paged serve, of ``arch`` at full
        width and depth; ``need`` names the kernels every path must
        launch beside ``flash_attention``; ``geom`` is (m, T, the task
        sources, max_len).  ``then(cfg, target, compressor, prefixes,
        engine, pengine)`` runs further phases on the same models before
        the profiled runs; what it returns lands under "then"."""
        m, T, sources, max_len = geom
        cfg = get_config(arch)
        tag = f"[{arch}]"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        target = tfm.init_params(cfg, 0)
        compressor = memcom.init_memcom(cfg, target, 1)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in compressor.parameters()) \
            + sum(p.numel() for p in target.parameters())
        log(f"{tag} init: {n_params / 1e9:.3f} B parameters over target, "
            f"source, memory and memx in {time.perf_counter() - t0:.1f}s")
        engine = ServingEngine(cfg, target, slots=slots, max_len=max_len)
        torch.cuda.synchronize()

        set_counts()
        t0 = time.perf_counter()
        prefixes, task_s = [], []
        source_prefills = SourcePrefills(T)
        gmm_dense, gmm_paged = GmmByRows(), GmmByRows()
        with source_prefills, gmm_dense:
            for t, src in enumerate(sources):
                t1 = time.perf_counter()
                prefix, _ = memcom.compress(
                    compressor, cfg, torch.as_tensor(src[None], device=dev))
                kv = materialize_prefix(target, cfg, prefix)
                engine.add_prefix(f"task{t}", kv)
                prefixes.append((prefix, kv))
                torch.cuda.synchronize()
                task_s.append(time.perf_counter() - t1)
        compress_s = time.perf_counter() - t0
        after_compress = counts()
        log(f"{tag} source prefills: {source_prefills.calls} flash calls over "
            f"{T} tokens, {source_prefills.wgmma} through the wgmma variant")
        if not 0 < source_prefills.calls == source_prefills.wgmma:
            raise AssertionError(f"{arch}: {source_prefills.calls} source "
                                 f"prefills, {source_prefills.wgmma} through "
                                 "the wgmma variant")
        reqs = [Request(tokens=p_, max_new=max_new, prefix=f"task{i % 2}")
                for i, p_ in enumerate(prompts)]
        before = dict(engine.counters)
        t0 = time.perf_counter()
        with gmm_dense:
            out = engine.serve(reqs)
        torch.cuda.synchronize()
        dense = serve_numbers(engine, reqs, out, time.perf_counter() - t0,
                              before)
        launches = counts()
        tokens = np.stack([out[r.uid] for r in reqs])
        log(f"{tag} {card}: compress 2x{T} tokens -> m={m}: "
            f"{compress_s:.3f}s (per task {[round(x, 4) for x in task_s]}); "
            f"dense serve {slots}x{max_new}: {dense['serve_s']:.3f}s, decode "
            f"{dense['decode_tok_s']:.1f} tok/s ({dense['decode_step_ms']:.2f}"
            f" ms a step), TTFT mean {dense['ttft_mean_s']:.4f}s max "
            f"{dense['ttft_max_s']:.4f}s")
        log(f"{tag} launches: compress {after_compress}, whole dense path "
            f"{launches}")
        log(f"{tag} memcom_xattn calls on the dense path: "
            f"{launches['memcom_xattn']}, {launches['memcom_xattn_wgmma']} "
            "through the wgmma variant")
        if launches["memcom_xattn"] != launches["memcom_xattn_wgmma"]:
            raise AssertionError(f"{arch}: {launches['memcom_xattn']} "
                                 f"memcom_xattn calls, "
                                 f"{launches['memcom_xattn_wgmma']} through "
                                 "the wgmma variant")
        log(f"{tag} tokens {tokens.tolist()}")
        if tokens.shape != (slots, max_new) or tokens.min() < 0 \
                or tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"bad generated tokens {tokens.shape}")
        for prefix, kv in prefixes:
            if len(prefix) != cfg.num_layers or not all(
                    bool(torch.isfinite(e["h"]).all()) and
                    tuple(e["h"].shape) == (1, m, cfg.d_model)
                    for e in prefix):
                raise AssertionError("compressed prefix is not finite (1, m, D)")
            if not all(bool(torch.isfinite(e["k"]).all() & torch.isfinite(
                    e["v"]).all()) for e in kv):
                raise AssertionError("materialized prefix is not finite")
        for key in ("flash_attention", "memcom_xattn", *need):
            if launches[key] <= 0:
                raise AssertionError(f"{key} was never launched on {arch}'s "
                                     "dense path")
        # -- the same tasks in a paged engine: 12 requests, refills --
        bs = 16
        pengine = ServingEngine(cfg, target, slots=slots, max_len=max_len,
                                kv_layout="paged", block_size=bs,
                                num_blocks=1 + 2 * (m // bs) + slots * 4)
        for t, (_, kv) in enumerate(prefixes):
            pengine.add_prefix(f"task{t}", kv)
        if pengine.alloc.used_count != 2 * (m // bs):
            raise AssertionError(f"{pengine.alloc.used_count} blocks in use "
                                 f"after registering two tasks, want "
                                 f"{2 * (m // bs)}")
        specs = []
        for i in range(12):
            n = int(rng.integers(4, 13))
            specs.append(dict(
                tokens=rng.integers(4, vocab.size, n).astype(np.int32),
                max_new=int(rng.integers(4, 17)), prefix=f"task{i % 2}"))
        # a free-running serve (it also warms the path) gives each
        # request's greedy stream; every third request then stops at the
        # second token of its own stream, so a stop fires and its slot
        # refills early
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
        log(f"{tag} paged first tokens equal to the dense engine's: "
            f"{len(specs) - len(first_diff)}/{len(specs)}; whole streams "
            f"equal: {same_streams}/{len(specs)}")
        if first_diff:
            raise AssertionError(f"paged and dense first tokens differ for "
                                 f"requests {first_diff}")
        preqs = [Request(**s, stop_token=int(free[f.uid][1]) if i % 3 == 0
                         else None)
                 for i, (s, f) in enumerate(zip(specs, free_reqs))]
        torch.cuda.synchronize()
        peak_dense = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        set_counts()
        before = dict(pengine.counters)
        t0 = time.perf_counter()
        with gmm_paged:
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
                raise AssertionError(f"request {r.uid}: {len(got)} tokens for "
                                     f"a budget of {r.max_new}, stop "
                                     f"{r.stop_token}")
        if not stopped:
            raise AssertionError("no stop token fired in the paged serve")
        paged.update(pool_bytes=pool_bytes, dense_cache_bytes=dense_bytes,
                     requests=len(preqs), stopped_early=stopped,
                     streams_equal_to_dense=int(same_streams),
                     admissions=sum(1 for e in pengine.trace
                                    if e[0] == "admit"),
                     pool=pengine.stats()["pool"], launches=paged_launches)
        log(f"{tag} paged {card}: served {len(preqs)} requests "
            f"({paged['tokens']} tokens, {stopped} stopped early) in "
            f"{paged['serve_s']:.3f}s, decode {paged['decode_tok_s']:.1f} "
            f"tok/s over {paged['decode_steps']} steps "
            f"({paged['decode_step_ms']:.2f} ms each, "
            f"{paged['slots_per_step']:.2f} slots a step), TTFT mean "
            f"{paged['ttft_mean_s']:.4f}s max {paged['ttft_max_s']:.4f}s; "
            f"pool {pool_bytes} bytes ({pengine.alloc.num_blocks} blocks of "
            f"{bs}) vs dense cache {dense_bytes} bytes; peak memory "
            f"{peak_dense} bytes through the dense path, "
            f"{paged['peak_bytes']} during the paged serve")
        log(f"{tag} paged launches {paged_launches}")
        log(f"{tag} memcom_xattn calls on the paged path: "
            f"{paged_launches['memcom_xattn']}, "
            f"{paged_launches['memcom_xattn_wgmma']} through the wgmma "
            "variant")
        if paged_launches["memcom_xattn"] \
                != paged_launches["memcom_xattn_wgmma"]:
            raise AssertionError(f"{arch}: memcom_xattn off the wgmma "
                                 "variant on the paged path")
        for key in ("flash_attention", "paged_flash_decode", *need):
            if paged_launches[key] <= 0:
                raise AssertionError(f"{key} was never launched on {arch}'s "
                                     "paged path")
        gmm_by_rows = {"dense": gmm_dense.check(tag, "dense path"),
                       "paged": gmm_paged.check(tag, "paged path")}
        if "gmm" in need and not (768 in gmm_by_rows["dense"]
                                  and 8 in gmm_by_rows["dense"]
                                  and 8 in gmm_by_rows["paged"]):
            raise AssertionError(f"{tag}: no gmm call at C = 768 or C = 8 on "
                                 f"a main path: {gmm_by_rows}")

        after = (then(cfg, target, compressor, prefixes, engine, pengine)
                 if then is not None else None)
        # where the time goes: one warm compress and one warm 4-token serve
        # on each layout under the profiler
        breakdown = {phase: profiled(tag, phase, fn) for phase, fn in (
            ("compress", lambda: memcom.compress(
                compressor, cfg, torch.as_tensor(sources[0][None],
                                                 device=dev))),
            ("serve", lambda: engine.serve(
                [Request(tokens=p_, max_new=4, prefix=f"task{i % 2}")
                 for i, p_ in enumerate(prompts)])),
            ("paged_serve", lambda: pengine.serve(
                [Request(tokens=p_, max_new=4, prefix=f"task{i % 2}")
                 for i, p_ in enumerate(prompts)])))}
        decode = [v for k, v in breakdown["paged_serve"]["by_name"].items()
                  if "paged_decode<" in k]
        decode_ms = sum(ms for ms, _ in decode)
        decode_n = sum(n for _, n in decode)
        log(f"{tag} profile paged_serve: paged_decode {decode_ms:.3f} ms over "
            f"{decode_n} calls")
        for kname in ("xattn_logits_wgmma", "xattn_out_wgmma"):
            hits = [v for k, v in breakdown["compress"]["by_name"].items()
                    if kname + "<" in k]
            log(f"{tag} profile compress: {kname} "
                f"{sum(ms for ms, _ in hits):.3f} ms over "
                f"{sum(n for _, n in hits)} calls")
        return {
            "task_compress_s": task_s, "breakdown": breakdown,
            "compress_s": compress_s, "dense": dense, "paged": paged,
            "peak_bytes": peak_dense, "params": n_params,
            "launches_after_compress": after_compress, "launches": launches,
            "gmm_by_rows": gmm_by_rows, "then": after}

    # ---- 5. kernels vs plain at full width, depth 2 --------------------
    def rel(a, b):
        return err(a, b) / max(float(b.float().abs().max()), 1e-30)

    class Routing:
        """Records the MoE layers' top-k ids of one run and replays them
        in the next, counting the rows whose own choice would differ."""

        def __init__(self):
            self.ids, self.mode, self.i = [], None, 0
            self.rows = self.flips = 0

        def __call__(self, probs, k):
            vals, ids = top_k(probs, k)
            if self.mode == "record":
                self.ids.append(ids)
            elif self.mode == "replay":
                want = self.ids[self.i]
                self.i += 1
                self.rows += ids.shape[0]
                self.flips += int((ids.sort(-1)[0] != want.sort(-1)[0])
                                  .any(-1).sum())
                ids, vals = want, torch.gather(probs, 1, want)
            return vals, ids

        def run(self, mode, fn):
            """``fn`` with the MoE layers' top-k going through this
            object; the port's own function is back when it returns."""
            self.mode, self.i = mode, 0
            if mode == "record":
                self.ids = []
            moe._top_k = self
            try:
                return fn()
            finally:
                moe._top_k = top_k
                self.mode = None

    top_k = moe._top_k
    routing = Routing()

    def kernel_vs_plain(arch, geom):
        m, _, sources, max_len = geom
        cfg = get_config(arch)
        mlp = cfg.layout.period[0].mlp
        cfg2 = cfg.replace(name=f"{arch}-depth2",
                           layout=LayerLayout.uniform(LayerDesc("attn", mlp),
                                                      2))
        tag = f"[{arch} kernel-vs-plain]"
        target2 = tfm.init_params(cfg2, 0)
        compressor2 = memcom.init_memcom(cfg2, target2, 1)
        src = torch.as_tensor(sources[0][None], device=dev)
        prompt = torch.as_tensor(prompts[2][None], dtype=torch.long,
                                 device=dev)

        def pipeline():
            prefix, _ = memcom.compress(compressor2, cfg2, src)
            kv = materialize_prefix(target2, cfg2, prefix)
            with torch.no_grad():
                logits, _ = target2(tokens=prompt, prefix=kv, mask_offset=m)
            return [e["h"] for e in prefix], logits[0, -1]

        def plain_run(fn):
            """``fn`` through the plain versions, on the kernel run's
            expert choices; the count of the plain run's own differing
            choices is printed."""
            routing.rows = routing.flips = 0
            ops.set_default_impl("torch")
            try:
                return routing.run("replay", fn)
            finally:
                ops.set_default_impl(None)

        omega_k, logits_k = routing.run("record", pipeline)
        omega_p, logits_p = plain_run(pipeline)
        flips = (routing.flips, routing.rows)
        rel_omega = max(rel(a, b) for a, b in zip(omega_k, omega_p))
        rel_logits = rel(logits_k, logits_p)
        log(f"{tag} depth 2, bf16: O^i rel err {rel_omega:.3e}, first-step "
            f"logits rel err {rel_logits:.3e} (tol {E2E_REL_TOL:g}); greedy "
            f"token kernel {int(logits_k.argmax())} plain "
            f"{int(logits_p.argmax())}; MoE rows whose plain top-k differs "
            f"(replayed): {flips[0]} of {flips[1]}")
        if not (rel_omega <= E2E_REL_TOL and rel_logits <= E2E_REL_TOL):
            raise AssertionError(f"{arch}: kernel path and plain path "
                                 "disagree end to end")
        # a paged engine at a block size that does not divide m (12 at m
        # 512, 10 at 768: 8 positions either way): the shared tail block
        # is copied on write by both prefills, then one decode step reads
        # both slots through their tables
        cow_bs = 12 if m % 12 else 10
        kv2 = materialize_prefix(target2, cfg2,
                                 memcom.compress(compressor2, cfg2, src)[0])
        ptoks = [prompts[2], prompts[1]]

        def paged_first_step():
            """Two 2-token requests through ``serve``: the last-position
            logits of the two prefills and of the one decode step, and
            whether both slots copied the shared tail block on write."""
            eng = ServingEngine(cfg2, target2, slots=2, max_len=max_len,
                                kv_layout="paged", block_size=cow_bs)
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
            cow = all(int(eng.tables[s_, m // cow_bs]) != tail
                      for s_ in (0, 1))
            return torch.cat(rows[:2]), rows[2], cow

        set_counts()
        pre_k, step_k, cow = routing.run("record", paged_first_step)
        torch.cuda.synchronize()
        e2e_counts = counts()
        pre_p, step_p, _ = plain_run(paged_first_step)
        flips_paged = (routing.flips, routing.rows)
        rel_pre, rel_step = rel(pre_k, pre_p), rel(step_k, step_p)
        log(f"{tag} paged, depth 2, block size {cow_bs} (tail copied on "
            f"write: "
            f"{cow}): prefill logits rel err {rel_pre:.3e}, first decode "
            f"step logits rel err {rel_step:.3e} (tol {E2E_REL_TOL:g}); "
            f"launches {e2e_counts}; MoE rows whose plain top-k differs "
            f"(replayed): {flips_paged[0]} of {flips_paged[1]}")
        if not (cow and rel_pre <= E2E_REL_TOL and rel_step <= E2E_REL_TOL
                and e2e_counts["paged_flash_decode"] > 0
                and (mlp != "moe" or e2e_counts["gmm"] > 0)):
            raise AssertionError(f"{arch}: paged kernel path and plain path "
                                 "disagree")
        out = {"omega_rel_err": rel_omega, "logits_rel_err": rel_logits,
               "paged_prefill_rel_err": rel_pre,
               "paged_step_rel_err": rel_step,
               "moe_rows_replayed": [flips, flips_paged]}
        if mlp != "moe":
            out["fused_steps"] = fused_steps_vs_plain(cfg2, target2, kv2, tag,
                                                      max_len, plain_run)
        if mlp == "moe":
            out["reclaimed_lanes"] = reclaimed_lanes_twice(cfg2, target2,
                                                           kv2, tag)
        return out

    def fused_steps_vs_plain(cfg2, target2, kv2, tag, max_len, plain_run):
        """Two requests on the task through a self-speculative fused engine
        (k = 3) on a virtual clock, dense and paged (blocks of 16): the
        first fused step carries 4 verify lanes (W = 4); the second
        request arrives while the first decodes and joins as one 16-token
        chunk (W = 16).  Each of those two steps' valid lanes' logits,
        through the kernels and through the plain versions, agree within
        the end-to-end bound."""
        j_rng = np.random.default_rng(26)
        join_toks = j_rng.integers(4, vocab.size, 16).astype(np.int32)
        out = {}
        for layout in ("dense", "paged"):
            def run():
                eng = ServingEngine(
                    cfg2, target2, slots=2, max_len=max_len,
                    kv_layout=layout, block_size=16, fused_step=True,
                    fused_chunk_tokens=16, spec_draft="self", spec_k=3,
                    clock=VirtualClock())
                eng.add_prefix("task", kv2)
                steps = []

                def hook(mod, args, kwargs, res):
                    lv, toks = kwargs.get("lane_valid"), kwargs["tokens"]
                    if lv is not None and toks.shape[1] > 1:  # not a draft
                        v = lv.tolist()
                        steps.append((toks.shape[1], v, torch.cat(
                            [res[0][b, :n].float() for b, n in enumerate(v)])))

                h = target2.register_forward_hook(hook, with_kwargs=True)
                try:
                    eng.serve([Request(tokens=prompts[2], max_new=8,
                                       prefix="task"),
                               Request(tokens=join_toks, max_new=2,
                                       prefix="task", arrival_s=0.0015)])
                finally:
                    h.remove()
                return steps[:2]

            set_counts()
            got = run()
            launches = counts()
            want = plain_run(run)
            shapes = [(w, v) for w, v, _ in got]
            errs = [rel(g[2], w_[2]) for g, w_ in zip(got, want)]
            log(f"{tag} fused steps {layout} (W, valid lanes) {shapes}: "
                f"valid lanes' logits rel err {[f'{e:.3e}' for e in errs]} "
                f"(tol {E2E_REL_TOL:g}); launches {launches}")
            if not (shapes == [(w, v) for w, v, _ in want]
                    and [w for w, _ in shapes] == [4, 16]
                    and max(errs) <= E2E_REL_TOL
                    and launches["flash_attention"] > 0
                    and (layout == "dense"
                         or launches["paged_flash_decode"] > 0)):
                raise AssertionError(f"{tag}: the fused {layout} steps "
                                     "disagree with the plain path")
            out[layout] = {"shapes": shapes, "rel_err": errs}
        return out

    def reclaimed_lanes_twice(cfg2, target2, kv2, tag):
        """A 12-slot paged MoE serve whose last requests decode beside 8
        reclaimed slots, run twice on fresh engines: the tokens and the
        trace must be identical.  16 requests of 9 tokens and 4 new ones
        over a pool that holds the prefix and the private blocks of 12
        requests: the first 12 finish together and leave no free block,
        so the engine reclaims every free slot and seats the last 4.
        Each of their decode steps carries 12 lanes, 8 of them idle with
        trash-only tables and one stale length, which write one row of
        block 0 and read it back while their hidden states compete for
        expert capacity."""
        bs = 16
        per_req = -(-(m + 16) // bs) - -(-m // bs)  # a 16-wide prefill
        num_blocks = 1 + -(-m // bs) + 12 * per_req
        rng_ = np.random.default_rng(7)
        toks = [rng_.integers(4, cfg2.vocab_size, 9).astype(np.int32)
                for _ in range(16)]
        shared = []  # per decode step: lanes whose write row another names

        def count_shared(mod, args, kwargs):
            t, lens = kwargs.get("block_tables"), kwargs.get("cache_index")
            if kwargs.get("decode") and t is not None:
                rows = (t.gather(1, (lens // bs).long()[:, None])[:, 0] * bs
                        + lens % bs)
                shared.append(int(rows.numel() - rows.unique().numel()))

        runs = []
        for _ in range(2):
            eng = ServingEngine(cfg2, target2, slots=12, max_len=max_len,
                                kv_layout="paged", block_size=bs,
                                num_blocks=num_blocks)
            eng.add_prefix("task", kv2)
            shared.clear()
            hook = target2.register_forward_pre_hook(count_shared,
                                                     with_kwargs=True)
            try:
                got = eng.serve([Request(tokens=t, max_new=4, prefix="task",
                                         uid=i) for i, t in enumerate(toks)])
            finally:
                hook.remove()
            runs.append(([got[i].tolist() for i in range(16)],
                         list(eng.trace), max(shared)))
        steps = [e[1] for e in runs[0][1] if e[0] == "decode"]
        same = runs[0][:2] == runs[1][:2]
        log(f"{tag} 12-slot paged serve beside reclaimed slots, twice: "
            f"decode steps of {steps} active lanes, up to {runs[0][2]} "
            f"lanes a step writing a row another lane writes; tokens and "
            f"trace identical: {same}")
        if not (same and runs[0][2] >= 7 and steps[-1] == 4):
            raise AssertionError(f"{tag}: the reclaimed-slot serve is not "
                                 "reproducible or did not reclaim")
        return {"decode_lanes": steps, "shared_row_lanes": runs[0][2],
                "identical": same}

    # ---- mamba2-370m: many-shot prompts served in full, through ssd ----
    q_rng = np.random.default_rng(14)
    mamba_prompts = [np.concatenate([sources[i % 2], q_rng.integers(
        4, vocab.size, int(q_rng.integers(4, 13))).astype(np.int32)])
        for i in range(8)]

    def mamba_path():
        """8 requests over 4 slots, each a 3072-token many-shot prompt and
        a 4-12-token query, 16 greedy tokens each, through a dense and a
        paged engine: identical tokens; a request admitted into a refilled
        slot gives the tokens of a fresh engine; every prefill launches
        ``ssd`` once per layer."""
        arch = "mamba2-370m"
        cfg = get_config(arch)
        tag = f"[{arch}]"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        target = tfm.init_params(cfg, 0)
        torch.cuda.synchronize()
        n_params = sum(p_.numel() for p_ in target.parameters())
        log(f"{tag} init: {n_params / 1e9:.3f} B parameters in "
            f"{time.perf_counter() - t0:.1f}s")
        mlen = max(len(p_) for p_ in mamba_prompts) + max_new
        specs = [dict(tokens=p_, max_new=max_new) for p_ in mamba_prompts]

        def engine_for(layout):
            kw = dict(kv_layout="paged", block_size=16) \
                if layout == "paged" else {}
            return ServingEngine(cfg, target, slots=slots, max_len=mlen, **kw)

        def serve(eng, label):
            set_counts()
            reqs = [Request(**s_) for s_ in specs]
            before = dict(eng.counters)
            t0 = time.perf_counter()
            out = eng.serve(reqs)
            torch.cuda.synchronize()
            numbers = serve_numbers(eng, reqs, out, time.perf_counter() - t0,
                                    before)
            numbers["launches"] = counts()
            numbers["prefills"] = eng.counters["prefills"] - before["prefills"]
            tokens = [out[r.uid] for r in reqs]
            log(f"{tag} {label} {card}: served {len(reqs)} x ({len(specs[0]['tokens'])}"
                f"-{max(len(s_['tokens']) for s_ in specs)}-token prompt, "
                f"{max_new} tokens) over {slots} slots in "
                f"{numbers['serve_s']:.3f}s, decode "
                f"{numbers['decode_tok_s']:.1f} tok/s over "
                f"{numbers['decode_steps']} steps "
                f"({numbers['decode_step_ms']:.2f} ms each), TTFT mean "
                f"{numbers['ttft_mean_s']:.4f}s max "
                f"{numbers['ttft_max_s']:.4f}s; launches "
                f"{numbers['launches']}")
            if any(len(t_) != max_new or t_.min() < 0
                   or t_.max() >= cfg.vocab_size for t_ in tokens):
                raise AssertionError(f"{tag} {label}: bad generated tokens")
            want = cfg.num_layers * numbers["prefills"]
            if numbers["launches"]["ssd"] != want \
                    or numbers["launches"]["ssd_chunked"] != want:
                raise AssertionError(
                    f"{tag} {label}: ssd launched "
                    f"{numbers['launches']['ssd']} times, "
                    f"{numbers['launches']['ssd_chunked']} of them chunked; "
                    f"want {want} (one per layer and prefill), all chunked")
            return reqs, tokens, numbers

        engine = engine_for("dense")
        engine.serve([Request(tokens=specs[0]["tokens"][:64], max_new=2)])
        reqs, dense_tokens, dense = serve(engine, "dense")
        log(f"{tag} tokens {[t_.tolist() for t_ in dense_tokens]}")
        # the first request admitted into a slot another one used
        seen, refilled = set(), None
        for _, uid, slot in (e for e in engine.trace if e[0] == "admit"):
            if slot in seen:
                refilled = next(i for i, r in enumerate(reqs) if r.uid == uid)
                break
            seen.add(slot)
        alone = next(iter(engine_for("dense").serve(
            [Request(**specs[refilled])]).values()))
        refill_ok = np.array_equal(alone, dense_tokens[refilled])
        log(f"{tag} request {refilled} in a refilled slot equals a fresh "
            f"engine's: {refill_ok}")
        if not refill_ok:
            raise AssertionError(f"{tag}: a refilled slot kept state")
        peak_dense = torch.cuda.max_memory_allocated()
        pengine = engine_for("paged")
        _, paged_tokens, paged = serve(pengine, "paged")
        same = [np.array_equal(a, b)
                for a, b in zip(dense_tokens, paged_tokens)]
        log(f"{tag} paged tokens equal to dense: {sum(same)}/{len(same)}")
        if not all(same):
            raise AssertionError(f"{tag}: paged and dense tokens differ")
        state_bytes = sum(x.numel() * x.element_size() // slots
                          for c in engine.cache for x in c.values())
        g = get_config("gemma2-2b")
        gemma_kv = g.num_layers * 2 * T * g.num_kv_heads * g.hd * 2
        # one ~3080-token prefill on its own, warm, as the engine runs it
        toks = torch.as_tensor(mamba_prompts[0][None], dtype=torch.long,
                               device=dev)
        prefill_s = []
        for _ in range(3):
            cache1 = tfm.init_cache(cfg, 1, toks.shape[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                target(tokens=toks, cache=cache1, cache_index=0)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        log(f"{tag} {card}: prefill of one {toks.shape[1]}-token prompt "
            f"{[round(x, 4) for x in prefill_s]} s; state per slot "
            f"{state_bytes} bytes (gemma2-2b's K/V for {T} tokens: "
            f"{gemma_kv} bytes); peak memory {peak_dense} bytes")
        breakdown = {phase: profiled(tag, phase, fn) for phase, fn in (
            ("prefill", lambda: target(tokens=toks, cache=tfm.init_cache(
                cfg, 1, toks.shape[1]), cache_index=0)),
            ("serve", lambda: engine.serve(
                [Request(**s_) for s_ in specs[:4]])))}
        ssd_kernels = {k.split("::")[-1].split("(")[0]: v for k, v in
                       breakdown["prefill"]["by_name"].items()
                       if "ssd_" in k}
        for k, (ms, n) in sorted(ssd_kernels.items(), key=lambda kv: -kv[1][0]):
            log(f"{tag} {card}: profiled prefill, ssd kernel {k}: {ms:.4f} "
                f"ms over {n} launches, {ms / n:.4f} ms each")
        breakdown["prefill"]["ssd_kernels"] = ssd_kernels
        return {"params": n_params, "dense": dense, "paged": paged,
                "refilled_request": refilled, "prefill_s": prefill_s,
                "state_bytes_per_slot": state_bytes,
                "gemma2_kv_bytes_3072": gemma_kv, "peak_bytes": peak_dense,
                "breakdown": breakdown,
                "launches": dense["launches"]}

    def mamba_kernel_vs_plain():
        """Depth 2 at full width: a many-shot prompt's last-position logits
        and the final SSM states through ``ssd`` and through the plain
        version."""
        cfg = get_config("mamba2-370m")
        cfg2 = cfg.replace(name="mamba2-370m-depth2",
                           layout=LayerLayout.uniform(
                               LayerDesc("mamba", "none"), 2))
        tag = "[mamba2-370m kernel-vs-plain]"
        target2 = tfm.init_params(cfg2, 0)
        toks = torch.as_tensor(mamba_prompts[0][None], dtype=torch.long,
                               device=dev)

        def run():
            cache = tfm.init_cache(cfg2, 1, toks.shape[1])
            with torch.no_grad():
                logits, _ = target2(tokens=toks, cache=cache, cache_index=0)
            return logits[0, -1], [c["ssm"] for c in cache]

        set_counts()
        logits_k, states_k = run()
        torch.cuda.synchronize()
        n, n_chunked = counts()["ssd"], counts()["ssd_chunked"]
        ops.set_default_impl("torch")
        try:
            logits_p, states_p = run()
        finally:
            ops.set_default_impl(None)
        rel_logits = rel(logits_k, logits_p)
        rel_state = max(rel(a, b) for a, b in zip(states_k, states_p))
        log(f"{tag} depth 2, bf16, {toks.shape[1]} tokens: first-step "
            f"logits rel err {rel_logits:.3e}, final states rel err "
            f"{rel_state:.3e} (tol {E2E_REL_TOL:g}); ssd launches {n} "
            f"({n_chunked} chunked); "
            f"greedy token kernel {int(logits_k.argmax())} plain "
            f"{int(logits_p.argmax())}")
        if not (n == n_chunked == 2 and rel_logits <= E2E_REL_TOL
                and rel_state <= E2E_REL_TOL):
            raise AssertionError(f"{tag}: kernel path and plain path "
                                 "disagree")
        return {"logits_rel_err": rel_logits, "state_rel_err": rel_state}

    # ---- 4d. MemCom Phase-1 training at full width ----------------------
    def train_path():
        """gemma2-2b Phase 1 at full width and depth through the port's
        launcher path (``launch.train.build``: Trainer, AdamW with
        warmup_cosine, clip 1.0): 4 steps of batch 2 x 3584 tokens split at
        3072 (the source) with a checkpoint after step 2, then a second
        Trainer restored from it that must reproduce steps 3-4 exactly."""
        import shutil
        import warnings

        from repro_torch.launch import train as launch_train
        from repro_torch.optim import warmup_cosine
        from repro_torch.train import Trainer, TrainerConfig

        cfg = get_config("gemma2-2b")
        tag = "[gemma2-2b train]"
        ckdir = Path(__file__).resolve().parent / ".chip_smoke_ckpt"
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.use_deterministic_algorithms(True, warn_only=True)
        steps, seq, split, batch = 4, T + m, T, 2
        # warmup over 2 steps: the reference's 500 would keep a bf16
        # parameter's first updates (lr ~ 4e-7) below its rounding step
        lr = warmup_cosine(2e-4, 2, 20_000)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = launch_train.build(cfg, phase=1, batch=batch, seq=seq,
                                 split=split, steps=steps, ckpt=str(ckdir),
                                 ckpt_every=2, codec="raw", log_every=1,
                                 lr=lr)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        trained = run.params
        frozen = {n: p.detach().to("cpu", copy=True)
                  for n, p in list(run.mc.named_parameters())
                  + [("target." + n, p)
                     for n, p in run.target.named_parameters()]
                  if n not in trained}
        start = {n: p.detach().float().clone() for n, p in trained.items()}
        n_trained = sum(p.numel() for p in trained.values())
        state_bytes = sum(t.numel() * t.element_size()
                          for key in ("mu", "nu", "master")
                          for t in run.trainer.opt_state[key].values())
        log(f"{tag} init {init_s:.1f}s: {n_trained / 1e6:.1f}M trained "
            f"parameters (memx, mem_tokens), {len(frozen)} frozen tensors, "
            f"AdamW state {state_bytes} bytes")

        per_step, step_s = [], []

        def counted(inner):
            def step(params, state, batch_):
                before = counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = inner(params, state, batch_)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
                after = counts()
                per_step.append({k: after[k] - before[k] for k in after})
                return out
            return step

        run.trainer.train_step = counted(run.step)
        set_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run.trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        nondet = sorted({str(w.message)[:120] for w in caught
                         if "deterministic" in str(w.message)})
        losses = dict(run.trainer.losses)
        log(f"{tag} losses {losses}; per-step seconds "
            f"{[round(x, 4) for x in step_s]}; whole run with 2 raw "
            f"checkpoints {run_s:.2f}s; peak memory {peak} bytes")
        log(f"{tag} launches per step {per_step}")
        if nondet:
            log(f"{tag} ops without a deterministic implementation: {nondet}")
        L = cfg.num_layers
        # every call of the step is bf16 at head dim 256 over m query rows
        # of each head and m keys: all go where bwd_variant_for sends them
        G = cfg.num_heads // cfg.num_kv_heads
        want_wg = (3 * L - 1 if fa.bwd_variant_for(
            torch.bfloat16, cfg.hd, m * G, m) == "wgmma" else 0)
        # and each layer's memory cross-attention over the split's source
        want_xwg = (L if mx.bwd_variant_for(
            torch.bfloat16, batch, m, split, cfg.d_model, True) == "wgmma"
            else 0)
        for i, c in enumerate(per_step):
            # the Memory-LLM's self-attention and the prompt against the
            # prefix in every layer, the prompt's self-attention in every
            # layer but the first (whose q, k, v come from the frozen
            # token embeddings alone, so autograd records no backward)
            if c["flash_attention_bwd"] != 3 * L - 1 \
                    or c["flash_attention_bwd_wgmma"] != want_wg \
                    or c["memcom_xattn_bwd"] != L \
                    or c["memcom_xattn_bwd_wgmma"] != want_xwg:
                raise AssertionError(
                    f"{tag} step {i + 1}: {c['flash_attention_bwd']} flash "
                    f"backward calls (want {3 * L - 1}), "
                    f"{c['flash_attention_bwd_wgmma']} through the wgmma "
                    f"variant (want {want_wg}), "
                    f"{c['memcom_xattn_bwd']} memcom_xattn backward calls "
                    f"(want {L}), {c['memcom_xattn_bwd_wgmma']} through its "
                    f"wgmma variant (want {want_xwg})")
            if c["memcom_xattn"] != c["memcom_xattn_wgmma"] or \
                    c["memcom_xattn"] != L:
                raise AssertionError(f"{tag} step {i + 1}: memcom_xattn "
                                     f"forward off the wgmma variant: {c}")
        log(f"{tag} flash backward calls a step: "
            f"{[c['flash_attention_bwd'] for c in per_step]}, through the "
            f"wgmma variant "
            f"{[c['flash_attention_bwd_wgmma'] for c in per_step]}; "
            f"memcom_xattn backward calls through its wgmma variant "
            f"{[c['memcom_xattn_bwd_wgmma'] for c in per_step]}")
        if not all(np.isfinite(v) for v in losses.values()) \
                or sorted(losses) != [1, 2, 3, 4]:
            raise AssertionError(f"{tag} losses {losses}")
        moved = {n: not torch.equal(
            run.trainer.opt_state["master"].get(n, p.detach().float()),
            start[n]) for n, p in trained.items()}
        bf16_moved = sum(not torch.equal(p.detach().float(), start[n])
                         for n, p in trained.items())
        if not all(moved.values()):
            raise AssertionError(f"{tag} trained tensors that did not move: "
                                 f"{[n for n, v in moved.items() if not v]}")
        named = dict(run.mc.named_parameters())
        named.update(("target." + n, p)
                     for n, p in run.target.named_parameters())
        changed = [n for n, t in frozen.items()
                   if not torch.equal(named[n].detach().cpu(), t)]
        if changed:
            raise AssertionError(f"{tag} frozen tensors changed: {changed[:5]}")
        log(f"{tag} all {len(moved)} trained tensors moved (their float32 "
            f"masters; {bf16_moved} also in their bf16 values); all "
            f"{len(frozen)} frozen tensors bit-identical to their start")
        del frozen
        final = {n: p.detach().clone() for n, p in trained.items()}
        # restart: a second Trainer on the same modules, its optimizer
        # state fresh, restored from the step-2 checkpoint
        t0 = time.perf_counter()
        again = Trainer(
            run.step, trained, run.opt.init(trained), run.batch_at,
            str(ckdir), TrainerConfig(
                num_steps=steps, ckpt_every=2, log_every=1, codec="raw"))
        restored = again.restore_if_available(step=2)
        restore_s = time.perf_counter() - t0
        again.run()
        torch.cuda.synchronize()
        same_losses = all(again.losses[s] == losses[s] for s in (3, 4))
        same_params = all(torch.equal(p, final[n]) for n, p in trained.items())
        log(f"{tag} restart from step {restored} (restore {restore_s:.2f}s): "
            f"losses of steps 3-4 {[again.losses[s] for s in (3, 4)]} vs "
            f"{[losses[s] for s in (3, 4)]}: identical {same_losses}; "
            f"trained tensors after step 4 identical {same_params}")
        if not (restored == 2 and same_losses and same_params):
            diffs = {s: again.losses[s] - losses[s] for s in (3, 4)}
            raise AssertionError(f"{tag} the restart does not reproduce the "
                                 f"run: loss differences {diffs}")
        ckpt_bytes = sum(f.stat().st_size
                         for f in (ckdir / "step_00000002").iterdir())
        del final, again
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        tokens = batch * seq
        step_mean = float(np.mean(step_s[1:]))
        out = {"losses": losses, "step_s": step_s,
               "s_per_step": step_mean, "tokens_per_s": tokens / step_mean,
               "target_tokens_per_s": batch * (seq - split) / step_mean,
               "peak_bytes": peak, "launches_per_step": per_step,
               "launches": launches, "trained_params": n_trained,
               "adamw_state_bytes": state_bytes, "ckpt_bytes": ckpt_bytes,
               "restart_identical": same_losses and same_params,
               "nondeterministic_ops": nondet, "run_s": run_s}
        log(f"{tag} {card}: {step_mean:.4f} s/step over steps 2-4, "
            f"{out['tokens_per_s']:.1f} tokens/s ({tokens} a step, "
            f"{out['target_tokens_per_s']:.1f} target tokens/s), peak memory "
            f"{peak} bytes, checkpoint {ckpt_bytes} bytes")
        # one profiled step, last: its device busy time, idle share and the
        # kernels' device times
        b = run.batch_at(steps)
        prof = profiled(tag, "step", lambda: run.step(
            trained, run.trainer.opt_state, b))
        kern = {}
        for key, pats in (("flash_fwd", ("flash_fwd",)),
                          ("flash_bwd", ("flash_bwd_",)),
                          ("xattn_fwd", ("xattn_logits_wgmma",
                                         "xattn_out_wgmma")),
                          ("xattn_bwd", ("xattn_bwd_",))):
            hits = [v for k_, v in prof["by_name"].items()
                    if any(p_ in k_ for p_ in pats)]
            kern[key] = (sum(ms for ms, _ in hits), sum(n for _, n in hits))
            log(f"{tag} profile step: {key} {kern[key][0]:.3f} ms over "
                f"{kern[key][1]} kernels")
        out.update(profile=prof, kernel_device_ms=kern)
        for p in trained.values():
            p.requires_grad_(False)
        del run, trained, b
        return out

    def train_kernel_vs_plain():
        """One Phase-1 and one Phase-2 step's loss and gradients at full
        width and depth 2, through the kernels and forced to the plain
        versions: each gradient within 2e-2 of the plain run's largest
        magnitude (Phase 2 adds the Source- and Memory-LLM, and with them
        the 3072-token source's flash backward, in every layer whose
        output some H^i reads)."""
        from repro_torch.data import PretrainStream

        cfg = get_config("gemma2-2b")
        cfg2 = cfg.replace(name="gemma2-2b-depth2",
                           layout=LayerLayout.uniform(LayerDesc("attn",
                                                                "dense"), 2))
        tag = "[gemma2-2b train kernel-vs-plain]"
        target2 = tfm.init_params(cfg2, 0)
        mc2 = memcom.init_memcom(cfg2, target2, 1)
        raw = PretrainStream(vocab, batch=2, seq_len=T + m,
                             split_choices=(T,), seed=0).batch_at(0)
        batch = {k: torch.as_tensor(raw[k], device=dev)
                 for k in ("source", "target", "target_mask")}
        source_bwd = []
        inner_bwd = fa.flash_attention_bwd

        def spy(q, *a, **kw):
            source_bwd.append(int(q.shape[1]) == T)
            return inner_bwd(q, *a, **kw)

        out = {}
        for phase in (1, 2):
            trained = memcom.set_trainable(mc2, phase)

            def grads():
                loss, _ = memcom.memcom_loss(mc2, target2, cfg2, batch)
                g = torch.autograd.grad(loss, list(trained.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
                return float(loss.detach()), g

            set_counts()
            source_bwd.clear()
            fa.flash_attention_bwd = spy
            try:
                loss_k, g_k = grads()
            finally:
                fa.flash_attention_bwd = inner_bwd
            torch.cuda.synchronize()
            c = counts()
            ops.set_default_impl("torch")
            try:
                loss_p, g_p = grads()
            finally:
                ops.set_default_impl(None)
            rels = {n: rel(a, b) for n, a, b in zip(trained, g_k, g_p)}
            worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
            nonzero = sum(float(g.float().abs().max()) > 0 for g in g_k)
            log(f"{tag} phase {phase}, depth 2, bf16: loss kernel {loss_k:.6f}"
                f" plain {loss_p:.6f}; {len(rels)} gradients ({nonzero} "
                f"non-zero), worst rel err {worst} (tol {E2E_REL_TOL:g}); "
                f"flash backward calls {c['flash_attention_bwd']} "
                f"({sum(source_bwd)} over the {T}-token source), "
                f"memcom_xattn backward calls {c['memcom_xattn_bwd']}")
            # Phase 2: the source's flash backward in every layer but the
            # last, whose attention feeds no captured hidden
            want_src = cfg2.num_layers - 1 if phase == 2 else 0
            if not (worst[0][1] <= E2E_REL_TOL
                    and abs(loss_k - loss_p) <= E2E_REL_TOL * abs(loss_p)
                    and sum(source_bwd) == want_src
                    and c["memcom_xattn_bwd"] == 2):
                raise AssertionError(f"{tag} phase {phase}: kernel path and "
                                     "plain path disagree")
            out[f"phase{phase}"] = {
                "loss_kernel": loss_k, "loss_plain": loss_p,
                "worst_rel_err": worst, "launches": c,
                "source_flash_bwd": sum(source_bwd)}
            del g_k, g_p
        for p in mc2.parameters():
            p.requires_grad_(False)
        return out

    # ---- mistral-7b: offline, online compile, prefix tiers -------------
    MT = 2 * T  # the paper's 6144-token many-shot tasks
    m_rng = np.random.default_rng(24)
    msources = []
    for _ in range(3):
        task = ICLTaskSpec(vocab, num_labels=8, keys_per_label=4)
        msources.append(build_manyshot_prompt(task, make_episode(task, m_rng),
                                              m_rng, budget=MT))
    chunk_w = 512  # the online compile's token budget

    def synced(fn, *a):
        """``fn(*a)`` and its host seconds, the card drained on both
        sides."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def gap_serve(eng, specs):
        """Serve ``specs`` on ``eng`` with its gap counters zeroed: the
        tokens, the serve seconds, the longest and the mean decode gap
        (host clock), the compile chunks behind decode steps and each
        request's TTFT."""
        for key in ("decode_gap_max_s", "decode_gap_sum_s", "decode_gaps",
                    "compile_chunks_interleaved",
                    "decode_steps_during_compile"):
            eng.counters[key] = type(eng.counters[key])(0)
        reqs = [Request(**x) for x in specs]
        out, serve_s = synced(eng.serve, reqs)
        c_ = eng.counters
        return out, {
            "serve_s": serve_s, "decode_gap_max_s": c_["decode_gap_max_s"],
            "decode_gap_mean_s": c_["decode_gap_sum_s"]
            / max(1, c_["decode_gaps"]),
            "compile_chunks_interleaved": c_["compile_chunks_interleaved"],
            "decode_steps_during_compile": c_["decode_steps_during_compile"],
            "ttft_s": [eng.request_log[r.uid]["first_token_s"]
                       - eng.request_log[r.uid]["arrival_s"] for r in reqs],
            "uids": [r.uid for r in reqs]}

    def row_err(a, b):
        """The worst ``plain.scaled_err`` over two per-layer K/V rows."""
        return max(plain.scaled_err(x[key], y[key])
                   for x, y in zip(a, b) for key in ("k", "v"))

    def mistral_online(cfg, target, compressor, prefixes, resident):
        """Two 6144-token tasks sent as raw shots, compiled 512 tokens
        behind each decode step of two requests on a resident task;
        against the offline compress, twice, and with a whole-task
        budget."""
        tag = "[mistral-7b online]"
        mlen = cfg.memcom.num_memory_tokens + 24 + 2 * max_new + 16
        out = {}
        # O^i of the online compile's chunking against the offline one
        src0 = torch.as_tensor(msources[0][None], device=dev)
        on = [memcom.compress_chunked(compressor, cfg, src0,
                                      chunk_size=chunk_w)[0]
              for _ in range(2)]
        chunked0 = on[0]  # the classic chunked compile's O^i of task 0
        se = max(plain.scaled_err(a["h"], b["h"])
                 for a, b in zip(on[0], prefixes[0][0]))
        bitwise = all(torch.equal(a["h"], b["h"])
                      for a, b in zip(on[0], prefixes[0][0]))
        same = all(torch.equal(a["h"], b["h"]) for a, b in zip(*on))
        log(f"{tag} O^i of a {chunk_w}-token chunked compile vs the offline "
            f"compress: scaled err {se:.3e} (tol {REL_TOL['bfloat16']:g}), "
            f"bitwise equal {bitwise}; two chunked compiles bitwise equal: "
            f"{same}")
        if not (se <= REL_TOL["bfloat16"] and same):
            raise AssertionError(f"{tag}: the chunked compile disagrees")
        out.update(omega_scaled_err=se, omega_bitwise_offline=bitwise,
                   omega_repeat_equal=same)
        del on, src0

        def engine(budget):
            eng = ServingEngine(cfg, target, slots=slots, max_len=mlen,
                                compressor=compressor,
                                compile_token_budget=budget)
            eng.add_prefix("resident", resident)
            return eng

        warm = [dict(tokens=prompts[i], max_new=2 * max_new,
                     prefix="resident") for i in (0, 1)]
        cold = [dict(tokens=prompts[2 + i], max_new=max_new,
                     prefix=f"online{i}", raw_shots=msources[i])
                for i in (0, 1)]
        eng = engine(chunk_w)
        gap_serve(eng, warm)  # warm-up
        _, out["no_compile"] = gap_serve(eng, warm)
        set_counts()
        toks, out["budgeted"] = gap_serve(eng, warm + cold)
        out["launches"] = counts()
        rows = [[{k: v.clone() for k, v in e.items()}
                 for e in eng.store.get(f"online{i}")] for i in (0, 1)]
        errs = [row_err(rows[i], [{k: v[0] for k, v in e.items()}
                                  for e in prefixes[i][1]]) for i in (0, 1)]
        # the same task compiled again behind the same decode steps
        eng.store.evict("online0")
        gap_serve(eng, warm + cold[:1])
        again = eng.store.get("online0")
        repeat = all(torch.equal(a[k], b[k]) for a, b in zip(rows[0], again)
                     for k in a)
        c_ = eng.stats()["compiler"]
        b_ = out["budgeted"]
        log(f"{tag} {card}: 2 x {MT}-token raw-shot tasks compiled in "
            f"{chunk_w}-token chunks behind the decode steps of 2 requests "
            f"on a resident task: {b_['compile_chunks_interleaved']} chunks "
            f"interleaved, cold TTFT {[round(x, 4) for x in b_['ttft_s'][2:]]}"
            f" s, longest decode gap {b_['decode_gap_max_s']:.4f} s (mean "
            f"{b_['decode_gap_mean_s']:.4f}); without a compile "
            f"{out['no_compile']['decode_gap_max_s']:.4f} s (mean "
            f"{out['no_compile']['decode_gap_mean_s']:.4f}); compiler {c_}")
        log(f"{tag} installed K/V vs the offline prefix: scaled err "
            f"{[f'{e:.3e}' for e in errs]}; a second online compile bitwise "
            f"equal: {repeat}; launches {out['launches']}")
        cold_toks = [toks[u] for u in b_["uids"][2:]]
        if not (b_["compile_chunks_interleaved"] >= 2 * (MT // chunk_w) - 1
                and max(errs) <= REL_TOL["bfloat16"] and repeat
                and all(len(t_) == max_new and t_.min() >= 0
                        and t_.max() < cfg.vocab_size for t_ in cold_toks)
                and out["launches"]["memcom_xattn"] > 0):
            raise AssertionError(f"{tag}: the online compile failed its "
                                 "checks")
        out.update(installed_scaled_err=errs, repeat_equal=repeat,
                   compiler=c_)
        del eng, rows, again
        eng = engine(None)
        gap_serve(eng, warm)  # warm-up
        _, out["whole_task"] = gap_serve(eng, warm + cold)
        w_ = out["whole_task"]
        log(f"{tag} whole-task budget: longest decode gap "
            f"{w_['decode_gap_max_s']:.4f} s, cold TTFT "
            f"{[round(x, 4) for x in w_['ttft_s'][2:]]} s, serve "
            f"{w_['serve_s']:.3f} s (budgeted {b_['serve_s']:.3f} s)")
        del eng
        # the fused compile lane: the same two tasks compile 512 tokens in
        # each fused step of the two warm requests' decoding
        eng = ServingEngine(cfg, target, slots=slots, max_len=mlen,
                            compressor=compressor, compile_token_budget=chunk_w,
                            fused_step=True, fused_chunk_tokens=16)
        eng.add_prefix("resident", resident)
        gap_serve(eng, warm)  # warm-up
        omegas = []
        finish = memcom.finish_compress

        def spy(*a, **k):
            res = finish(*a, **k)
            omegas.append(res[0])
            return res

        memcom.finish_compress = spy
        try:
            set_counts()
            toks, out["fused"] = gap_serve(eng, warm + cold)
            out["fused_launches"] = counts()
        finally:
            memcom.finish_compress = finish
        f_ = out["fused"]
        f_["fused_compile_chunks"] = eng.counters["fused_compile_chunks"]
        errs = [row_err([{k: v for k, v in e.items()}
                         for e in eng.store.get(f"online{i}")],
                        [{k: v[0] for k, v in e.items()}
                         for e in prefixes[i][1]]) for i in (0, 1)]
        bitwise = len(omegas) == 2 and all(
            torch.equal(a["h"], b["h"]) for a, b in zip(omegas[0], chunked0))
        cold_toks = [toks[u] for u in f_["uids"][2:]]
        log(f"{tag} fused compile lane {card}: "
            f"{f_['fused_compile_chunks']} compile chunks in fused steps, "
            f"cold TTFT {[round(x, 4) for x in f_['ttft_s'][2:]]} s, longest "
            f"decode gap {f_['decode_gap_max_s']:.4f} s (mean "
            f"{f_['decode_gap_mean_s']:.4f}); the classic loop at the same "
            f"budget: cold TTFT {[round(x, 4) for x in b_['ttft_s'][2:]]} s, "
            f"longest gap {b_['decode_gap_max_s']:.4f} s; installed K/V vs "
            f"the offline prefix: scaled err {[f'{e:.3e}' for e in errs]}; "
            f"O^i bitwise equal to the classic chunked compile: {bitwise}; "
            f"launches {out['fused_launches']}")
        if not (f_["fused_compile_chunks"] > 0 and bitwise
                and max(errs) <= REL_TOL["bfloat16"]
                and all(len(t_) == max_new for t_ in cold_toks)):
            raise AssertionError(f"{tag}: the fused compile lane failed its "
                                 "checks")
        out.update(fused_installed_scaled_err=errs,
                   fused_omega_bitwise_classic=bitwise)
        del eng, chunked0, omegas
        torch.cuda.empty_cache()
        return out

    def mistral_tiers(cfg, target, kvs):
        """Three tasks served in turns through one HBM slot
        (``prefix_capacity=1``), one host row and a disk tier: demoted,
        spilled and promoted from both tiers; the tokens of an all-HBM
        engine's, dense and paged."""
        import tempfile

        tag = "[mistral-7b tiers]"
        mlen = cfg.memcom.num_memory_tokens + 24 + 2 * max_new + 16
        # after the three adds: t2 in HBM, t1 on host, t0 on disk; t0 comes
        # from disk, t2 from host, t1 from disk, each evicting the last
        order = (0, 2, 1)
        out = {}

        def turns(eng):
            got = []
            for i, t in enumerate(order):
                r = Request(tokens=prompts[i % 4], max_new=8, prefix=f"t{t}")
                got.append(eng.serve([r])[r.uid].tolist())
            return got

        for layout in ("dense", "paged"):
            kw = dict(slots=1, max_len=mlen, kv_layout=layout, block_size=16)
            ref = ServingEngine(cfg, target, **kw)
            for t, kv in enumerate(kvs):
                ref.add_prefix(f"t{t}", kv)
            want = turns(ref)
            del ref
            with tempfile.TemporaryDirectory() as shard_dir:
                eng = ServingEngine(cfg, target, prefix_capacity=1,
                                    host_capacity=1, disk_dir=shard_dir,
                                    promote_layer_budget=4, **kw)
                tiers = eng.tiers
                times = {"gather": [], "to_host": [], "spill": [],
                         "load": [], "promote_host": [], "promote_disk": [],
                         "shard_bytes": []}

                def timed(key, fn):
                    def run(*a, **k):
                        res, sec = synced(lambda: fn(*a, **k))
                        times[key].append(1e3 * sec)
                        return res
                    return run

                tiers._gather_paged = timed("gather", tiers._gather_paged)
                tiers._to_host = timed("to_host", tiers._to_host)
                spill_row = timed("spill", tiers.spill_row)

                def spill(*a):
                    path = spill_row(*a)
                    times["shard_bytes"].append(os.path.getsize(path))
                    return path

                tiers.spill_row = spill
                inner_submit = tiers.submit_promotion

                def submit(name, priority=0):
                    job, sec = synced(inner_submit, name, priority)
                    if job.source == "disk":  # the shard's read
                        times["load"].append(1e3 * sec)
                    return job

                tiers.submit_promotion = submit
                inner = tiers.promote_step

                def promote(budget):
                    src = [j.source for j in tiers._jobs.values()
                           if j.status == "promoting"][0]
                    return timed(f"promote_{src}", inner)(budget)

                tiers.promote_step = promote
                for t, kv in enumerate(kvs):
                    eng.add_prefix(f"t{t}", kv)
                set_counts()
                got = turns(eng)
                launches = counts()
                ts = eng.stats()["prefix_tiers"]
                del eng, tiers
            out[layout] = {"tiers": ts, "times_ms": times,
                           "launches": launches, "identical": got == want}
            log(f"{tag} {layout} {card}: tokens identical to an all-HBM "
                f"engine: {got == want}; counters {ts}")
            log(f"{tag} {layout}: ms of each demotion's pool gather "
                f"{times['gather']} and device-to-host copy "
                f"{times['to_host']}, spill "
                f"{times['spill']} ({times['shard_bytes']} shard bytes), "
                f"disk read {times['load']}, promote from host "
                f"{times['promote_host']}, from disk {times['promote_disk']}")
            if not (got == want and ts["demotes"] > 0 and ts["spills"] > 0
                    and ts["host_promotes"] > 0 and ts["disk_loads"] > 0
                    and times["promote_host"] and times["promote_disk"]):
                raise AssertionError(f"{tag} {layout}: the tier round trip "
                                     "failed its checks")
        torch.cuda.empty_cache()
        return out

    def mistral_then(cfg, target, compressor, prefixes, engine, pengine):
        resident = materialize_prefix(target, cfg, memcom.compress(
            compressor, cfg, torch.as_tensor(msources[2][None],
                                             device=dev))[0])
        out = {"online": mistral_online(cfg, target, compressor, prefixes,
                                        resident)}
        out["tiers"] = mistral_tiers(
            cfg, target, [prefixes[0][1], prefixes[1][1], resident])
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[mistral-7b] peak memory through the online and tier phases "
            f"{out['peak_bytes']} bytes")
        return out

    def trained_target_eval():
        """``eval_accuracy`` on the committed trained target through the
        dense engine's ``score_labels``, on the CPU and on the card (head
        dim 32: the float32 flash kernel): the same labels."""
        from repro_torch import bridge
        from repro_torch.configs import bench_target
        from repro_torch.data import eval_accuracy

        tag = "[bench-target eval]"
        cfg = bench_target.config()
        path = str(Path(__file__).resolve().parent / bench_target.CHECKPOINT)
        task = bench_target.TASKS["hwu64-like"]
        ids = bench_target.VOCAB.label_ids()
        out = {}
        for name, kw in (("full", dict(budget=bench_target.SOURCE_LEN)),
                         ("fewer_shots", dict(
                             budget=bench_target.SOURCE_LEN // 2,
                             query_budget=bench_target.SOURCE_LEN))):
            runs = {}
            for where in ("cpu", "cuda"):
                target, meta = bridge.load_params(cfg, path, device=where)
                eng = ServingEngine(cfg, target, slots=1, max_len=128,
                                    device=where)
                labels = []

                def predict(c_, q_, eng=eng, labels=labels):
                    labels.append(int(eng.score_labels(c_, q_, ids))
                                  - bench_target.VOCAB.label_base)
                    return labels[-1]

                set_counts()
                acc = eval_accuracy(predict, task, n_episodes=4,
                                    queries_per_episode=5, seed=0, **kw)
                runs[where] = (acc, labels, counts())
            same = runs["cpu"][:2] == runs["cuda"][:2]
            out[name] = {"accuracy": runs["cuda"][0], "labels": runs["cuda"][1],
                         "cpu_labels_equal": same,
                         "launches": runs["cuda"][2], "steps": meta["steps"]}
            log(f"{tag} {name} {kw}: accuracy card {runs['cuda'][0]:.3f} / "
                f"cpu {runs['cpu'][0]:.3f}, labels equal {same}; flash "
                f"launches {runs['cuda'][2]['flash_attention']}")
            if not (same and runs["cuda"][2]["flash_attention"] > 0):
                raise AssertionError(f"{tag} {name}: the card's labels are "
                                     "not the CPU's")
        return out

    # ---- 4f-4h. the fused step, speculative decoding and traffic ----
    def fused_serve(eng, specs):
        """Serve ``specs`` on ``eng`` with its counters reset and every
        kernel's launch count set to 0 just before and read just after.
        Required: each request emits its budget (no stop tokens here), the
        decode counter is the output less the first tokens, every joined
        prompt token streamed once and no more drafts accepted than
        proposed.  Returns (tokens by request, numbers)."""
        eng.reset_stats()
        reqs = [Request(**x) for x in specs]
        set_counts()
        out, wall = synced(eng.serve, reqs)
        launches = counts()
        es = eng.stats()["engine"]
        toks = [out[r.uid] for r in reqs]
        joined = sum(e[3] for e in eng.trace if e[0] == "join")
        ttft = [eng.request_log[r.uid]["first_token_s"]
                - eng.request_log[r.uid]["arrival_s"] for r in reqs]
        n_tok = int(sum(len(t_) for t_ in toks))
        ok = (all(len(t_) == r.max_new for t_, r in zip(toks, reqs))
              and es["tokens_generated"] == n_tok - len(reqs)
              and es["fused_prefill_tokens"] == joined
              and es["draft_accepted"] <= es["draft_proposed"])
        nums = {"serve_s": wall, "tokens": n_tok, "tok_s": n_tok / wall,
                "decode_tok_s": es["tokens_generated"] / es["decode_time_s"],
                "decode_steps": es["decode_steps"],
                "fused_steps": es["fused_steps"],
                "fused_prefill_tokens": es["fused_prefill_tokens"],
                "joined_tokens": joined, "joins": sum(
                    1 for e in eng.trace if e[0] == "join"),
                "draft_proposed": es["draft_proposed"],
                "draft_accepted": es["draft_accepted"],
                "accept_rate": es["accept_rate"],
                "decode_gap_max_s": es["decode_gap_max_s"],
                "ttft_mean_s": float(np.mean(ttft)),
                "ttft_max_s": float(np.max(ttft)),
                "jit_compiles": es["jit_compiles"], "launches": launches,
                "conserved": ok}
        return toks, nums

    def gemma_fused(cfg, target, compressor, prefixes, engine, pengine):
        """gemma2-2b at full width: 8 requests over 4 slots (prompts of
        4-33 tokens, budgets of 8-16, so slots free at different steps and
        the later requests join while others decode), through the path's
        classic engines (the baseline), then each through a fused engine
        (chunks of 16), a self-speculative one (k = 3) and
        one drafted by gemma2-2b at depth 2 (full width, seed 5), dense
        and paged (blocks of 16); then the traffic harness."""
        tag = "[gemma2-2b fused]"
        out = {}
        lens = (4, 9, 12, 7, 20, 33, 26, 17)
        budgets = (16, 12, 8, 14, 16, 10, 16, 12)
        f_rng = np.random.default_rng(25)
        specs = [dict(tokens=f_rng.integers(4, vocab.size, n).astype(
            np.int32), max_new=b_, prefix=f"task{i % 2}")
            for i, (n, b_) in enumerate(zip(lens, budgets))]
        # a shorter serve of the same prompts warms each engine's shapes
        # (budgets still staggered, so requests join there too)
        warm = [dict(x, max_new=x["max_new"] // 4 + 1) for x in specs]
        classic = {}
        for layout, eng in (("dense", engine), ("paged", pengine)):
            eng.serve([Request(**x) for x in warm])
            classic[layout], nums = fused_serve(eng, specs)
            out[f"{layout} classic"] = nums
            log(f"{tag} {layout} classic engine, the same requests {card}: "
                f"{nums['tokens']} tokens in {nums['serve_s']:.3f}s "
                f"({nums['tok_s']:.1f} tok/s, decode "
                f"{nums['decode_tok_s']:.1f} tok/s over "
                f"{nums['decode_steps']} steps), TTFT mean "
                f"{nums['ttft_mean_s']:.4f}s max {nums['ttft_max_s']:.4f}s, "
                f"longest decode gap {nums['decode_gap_max_s']:.4f}s")
            if not nums["conserved"]:
                raise AssertionError(f"{tag} {layout} classic: counters "
                                     "not conserved")
        cfg_d = cfg.replace(name="gemma2-2b-depth2", layout=LayerLayout.uniform(
            LayerDesc("attn", "dense"), 2))
        drafter = (cfg_d, tfm.init_params(cfg_d, 5))
        bs = 16
        for layout in ("dense", "paged"):
            for mode, kw in (("fused", {}),
                             ("spec_self", dict(spec_draft="self", spec_k=3)),
                             ("spec_cross", dict(spec_draft=drafter,
                                                 spec_k=3))):
                eng = ServingEngine(
                    cfg, target, slots=slots, max_len=max_len,
                    kv_layout=layout, block_size=bs,
                    num_blocks=1 + 2 * (m // bs) + slots * 4,
                    fused_step=True, fused_chunk_tokens=16, **kw)
                for t, (_, kv) in enumerate(prefixes):
                    eng.add_prefix(f"task{t}", kv)
                eng.serve([Request(**x) for x in warm])
                toks, nums = fused_serve(eng, specs)
                same = sum(np.array_equal(a, b_) for a, b_ in
                           zip(toks, classic[layout]))
                nums["streams_equal_to_classic"] = int(same)
                key = f"{layout} {mode}"
                out[key] = nums
                paths[f"gemma2-2b {key}"] = nums["launches"]
                need = ("flash_attention",) + (
                    ("paged_flash_decode",) if layout == "paged" else ())
                log(f"{tag} {key} {card}: {nums['tokens']} tokens in "
                    f"{nums['serve_s']:.3f}s ({nums['tok_s']:.1f} tok/s, "
                    f"decode {nums['decode_tok_s']:.1f} tok/s over "
                    f"{nums['decode_steps']} steps, {nums['fused_steps']} "
                    f"fused), {nums['joins']} joins streaming "
                    f"{nums['fused_prefill_tokens']} prompt tokens, drafts "
                    f"{nums['draft_accepted']}/{nums['draft_proposed']} "
                    f"accepted ({nums['accept_rate']:.3f}), TTFT mean "
                    f"{nums['ttft_mean_s']:.4f}s max {nums['ttft_max_s']:.4f}"
                    f"s, longest decode gap {nums['decode_gap_max_s']:.4f}s;"
                    f" greedy streams equal to the classic engine's: {same}/"
                    f"{len(specs)}; step functions {nums['jit_compiles']}; "
                    f"launches {nums['launches']}")
                if not (nums["conserved"] and nums["joins"] > 0
                        and all(nums["launches"][k_] > 0 for k_ in need)
                        and (mode == "fused" or nums["draft_proposed"] > 0)):
                    raise AssertionError(f"{tag} {key}: the fused serve "
                                         "failed its checks")
                if key == "dense fused":
                    prof_eng = eng  # profiled last
        out["observability"] = gemma_observability(
            cfg, target, compressor, prefixes, specs, warm)
        out["traffic"] = gemma_traffic(cfg, target, compressor)
        del drafter
        # five fused steps of the dense engine profiled (W = 4, every lane
        # valid, behind 516-524 positions): device busy and idle share a
        # step (last: a profiler session slows the launches after it)
        step = prof_eng._fused_program(4, True, None)
        toks = f_rng.integers(4, vocab.size, (slots, 4)).astype(np.int64)
        lens = np.asarray([m + 8, m + 11, m + 4, m + 12], np.int64)
        valid = np.full((slots,), 4, np.int32)
        step(toks, lens, valid, None)
        prof = profiled(tag, "fused_step_w4", lambda: [
            step(toks, lens, valid, None) for _ in range(5)])
        prof["wall_per_step_s"] = prof["wall_s"] / 5
        prof["kernels_per_step"] = prof["kernels"] / 5
        out["profile_fused_step_w4"] = prof
        log(f"{tag} profiled fused step (W = 4): "
            f"{prof['wall_per_step_s'] * 1e3:.2f} ms a step, "
            f"{prof['kernels_per_step']:.0f} kernels, device busy "
            f"{prof['device_busy_s'] / 5 * 1e3:.3f} ms, idle share "
            f"{prof['idle_share']:.3f}")
        return out

    class TimedTracer(Tracer):
        """A ``Tracer`` that sums the host seconds its recording calls
        take: the tracer's own cost, apart from the serve around it."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.host_s = 0.0

        def _timed(name):
            def call(self, *a, **k):
                t0 = time.perf_counter()
                getattr(Tracer, name)(self, *a, **k)
                self.host_s += time.perf_counter() - t0
            return call

        span = _timed("span")
        instant = _timed("instant")
        begin_async = _timed("begin_async")
        end_async = _timed("end_async")
        del _timed

    def sync_counted(fn):
        """``fn()``, its host seconds (the card drained on both sides) and
        the synchronizing calls it made: torch's sync debug mode warns at
        each one, and the warnings are counted."""
        import warnings

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sum(1 for w in caught if "synchroniz" in str(w.message).lower())
        return res, wall, n

    def http_get(port, path):
        """GET from the telemetry server on this host (no proxy)."""
        import urllib.error
        import urllib.request

        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        try:
            with opener.open(f"http://127.0.0.1:{port}{path}",
                             timeout=30) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def gemma_observability(cfg, target, compressor, prefixes, specs, warm):
        """4i: the serving stack's observability at gemma2-2b's full width
        on the 4f requests.  (a) A classic dense engine and a fused paged
        one, each with the tracer off and on (each run a fresh engine with
        the same history: the 4f warm-up serve, then the requests, since
        the pool and seating a serve leaves change the next serve's copies):
        identical tokens and the same count of synchronizing calls; the
        trace validates, its profile report too.  (b) One serve of a fresh
        classic dense engine with a ``TelemetryServer`` on an ephemeral
        port, scraped on all four routes from a second thread while it
        serves: every answer 200, the tokens of (a).  (c) The
        budget autotuner: the two tasks arrive as raw shots and compile
        512 tokens behind the decode steps of two requests on a resident
        task, the target gap half the fixed budget's mean gap: at least
        one shrink, the installed K/V within 2e-2 of the offline prefix,
        the O^i against the offline compress."""
        import threading

        from repro_torch.serving.telemetry import NULL_TRACER

        tag = "[gemma2-2b observability]"
        out = {}
        bs = 16
        kinds = {"classic dense": {},
                 "fused paged": dict(kv_layout="paged", block_size=bs,
                                     num_blocks=1 + 2 * (m // bs) + slots * 4,
                                     fused_step=True, fused_chunk_tokens=16)}

        def fresh(key):
            """A new engine of ``key`` after the 4f warm-up serve."""
            eng = ServingEngine(cfg, target, slots=slots, max_len=max_len,
                                **kinds[key])
            for t, (_, kv) in enumerate(prefixes):
                eng.add_prefix(f"task{t}", kv)
            eng.serve([Request(**x) for x in warm])
            return eng

        tokens_on = None
        for key, step in (("classic dense", "decode_step"),
                          ("fused paged", "fused_step")):
            runs = {}
            for mode in ("off", "on"):
                eng = fresh(key)
                eng.tracer = (TimedTracer(clock=eng.clock) if mode == "on"
                              else NULL_TRACER)
                eng.reset_stats()
                reqs = [Request(**x) for x in specs]
                set_counts()
                res, wall, syncs = sync_counted(lambda: eng.serve(reqs))
                launches = counts()
                paths[f"gemma2-2b observability {key} tracer {mode}"] = \
                    launches
                runs[mode] = {
                    "tokens": [res[r.uid].tolist() for r in reqs],
                    "syncs": syncs, "serve_s": wall, "launches": launches,
                    "decode_steps": eng.stats()["engine"]["decode_steps"]}
            tr = eng.tracer
            del eng
            trace = tr.chrome_trace()
            terr = validate_chrome_trace(trace, require_spans=("admission",
                                                               step))
            prof = profile_spans(trace)
            perr = validate_profile_report(prof)
            on, off = runs["on"], runs["off"]
            host_ms = 1e3 * tr.host_s / max(1, on["decode_steps"])
            same = on["tokens"] == off["tokens"]
            need = ("flash_attention",) + (
                ("paged_flash_decode",) if "paged" in key else ())
            out[key] = {"identical_tokens": same, "syncs_off": off["syncs"],
                        "syncs_on": on["syncs"], "serve_s_off": off["serve_s"],
                        "serve_s_on": on["serve_s"],
                        "decode_steps": on["decode_steps"],
                        "tracer_host_ms_per_step": host_ms,
                        "events": len(tr.events()), "profile": prof,
                        "trace_errors": terr, "profile_errors": perr}
            log(f"{tag} {key} {card}: tracer off / on: tokens identical "
                f"{same}, synchronizing calls {off['syncs']} / "
                f"{on['syncs']}, serve {off['serve_s']:.3f} / "
                f"{on['serve_s']:.3f} s over {on['decode_steps']} steps; the "
                f"tracer's own host time {host_ms:.4f} ms a step "
                f"({len(tr.events())} events); trace valid {not terr}, "
                f"profile valid {not perr}")
            log(f"{tag} {key} profile report {json.dumps(prof)}")
            if not (same and on["syncs"] == off["syncs"] and not terr
                    and not perr and all(on["launches"][k_] > 0
                                         and off["launches"][k_] > 0
                                         for k_ in need)):
                raise AssertionError(f"{tag} {key}: the tracer changed the "
                                     "serve or its trace is invalid")
            if key == "classic dense":
                tokens_on = on["tokens"]
        # (b) a live scrape of every route from a second thread
        routes = ("/metrics", "/healthz", "/debug/state", "/debug/trace")
        engine = fresh("classic dense")
        engine.tracer = Tracer(clock=engine.clock)
        statuses, rounds = [], [0, 0]
        reqs = [Request(**x) for x in specs]
        with TelemetryServer(engine, port=0) as srv:
            stop = threading.Event()
            serving = threading.Event()

            def scrape():
                while not stop.is_set():
                    rounds[0] += 1
                    rounds[1] += serving.is_set()
                    for path in routes:
                        statuses.append((path, http_get(srv.bound_port,
                                                        path)[0]))

            th = threading.Thread(target=scrape, name="scraper")
            set_counts()
            serving.set()
            th.start()
            res, wall = synced(engine.serve, reqs)
            serving.clear()
            stop.set()
            th.join(60)
            launches = counts()
            port = srv.bound_port
            final = {path: http_get(port, path)[0] for path in routes}
        del engine
        paths["gemma2-2b observability scraped"] = launches
        scraped = [res[r.uid].tolist() for r in reqs]
        ok_http = (all(st == 200 for _, st in statuses)
                   and all(st == 200 for st in final.values())
                   and {p_ for p_, _ in statuses} == set(routes))
        out["scrape"] = {"identical_tokens": scraped == tokens_on,
                         "requests": len(statuses), "rounds": rounds[0],
                         "rounds_started_while_serving": rounds[1],
                         "statuses": sorted({st for _, st in statuses}),
                         "final": final, "serve_s": wall}
        log(f"{tag} live scrape {card}: {len(statuses)} GETs of "
            f"{list(routes)} in {rounds[0]} rounds ({rounds[1]} started "
            f"while serving), statuses {out['scrape']['statuses']}, after "
            f"the serve {final}; tokens identical to the unscraped serve: "
            f"{scraped == tokens_on}; serve {wall:.3f} s")
        if not (ok_http and scraped == tokens_on and rounds[1] > 0
                and launches["flash_attention"] > 0):
            raise AssertionError(f"{tag}: the live scrape failed its checks")
        # (c) the budget autotuner behind decode steps
        mlen = m + 24 + 2 * max_new + 16
        warm2 = [dict(tokens=prompts[i], max_new=2 * max_new,
                      prefix="task0") for i in (0, 1)]
        cold = [dict(tokens=prompts[2 + i], max_new=max_new,
                     prefix=f"online{i}", raw_shots=sources[i])
                for i in (0, 1)]

        def tune_engine(**kw):
            eng = ServingEngine(cfg, target, slots=slots, max_len=mlen,
                                compressor=compressor,
                                compile_token_budget=chunk_w, **kw)
            eng.add_prefix("task0", prefixes[0][1])
            return eng

        eng = tune_engine()
        gap_serve(eng, warm2)  # warm-up
        _, fixed = gap_serve(eng, warm2 + cold)
        del eng
        target_gap = fixed["decode_gap_mean_s"] / 2
        eng = tune_engine(autotune_budgets=True,
                          target_decode_gap_s=target_gap, autotune_interval=2)
        gap_serve(eng, warm2)  # warm-up: no compile, so it may grow
        eng.compile_token_budget = chunk_w
        eng.reset_stats()
        eng.trace = []
        omegas = []
        finish = memcom.finish_compress

        def spy(*a, **k):
            res_ = finish(*a, **k)
            omegas.append(res_[0])
            return res_

        memcom.finish_compress = spy
        try:
            set_counts()
            toks, tuned = gap_serve(eng, warm2 + cold)
            launches = counts()
        finally:
            memcom.finish_compress = finish
        paths["gemma2-2b autotune"] = launches
        es = eng.stats()["engine"]
        trail = [chunk_w] + [e_[2] for e_ in eng.trace
                             if e_[0] == "autotune"]
        errs = [row_err([{k_: v for k_, v in e_.items()}
                         for e_ in eng.store.get(f"online{i}")],
                        [{k_: v[0] for k_, v in e_.items()}
                         for e_ in prefixes[i][1]]) for i in (0, 1)]
        om_err = [max(plain.scaled_err(a["h"], b["h"])
                      for a, b in zip(omegas[i], prefixes[i][0]))
                  for i in range(len(omegas))]
        om_bitwise = [all(torch.equal(a["h"], b["h"])
                          for a, b in zip(omegas[i], prefixes[i][0]))
                      for i in range(len(omegas))]
        cold_toks = [toks[u] for u in tuned["uids"][2:]]
        out["autotune"] = {
            "target_decode_gap_s": target_gap, "fixed": fixed,
            "tuned": tuned, "shrinks": es["autotune_shrinks"],
            "grows": es["autotune_grows"], "budget_trail": trail,
            "installed_scaled_err": errs, "omega_scaled_err": om_err,
            "omega_bitwise_offline": om_bitwise,
            "jit_compiles": es["jit_compiles"], "launches": launches}
        log(f"{tag} autotuner {card}: target gap {target_gap:.4f} s (half "
            f"the fixed {chunk_w}-token budget's mean gap "
            f"{fixed['decode_gap_mean_s']:.4f} s); {es['autotune_shrinks']}"
            f" shrinks, {es['autotune_grows']} grows, compile budget trail "
            f"{trail}; longest decode gap {tuned['decode_gap_max_s']:.4f} s "
            f"(mean {tuned['decode_gap_mean_s']:.4f}) against the fixed "
            f"budget's {fixed['decode_gap_max_s']:.4f} s; cold TTFT "
            f"{[round(x, 4) for x in tuned['ttft_s'][2:]]} s (fixed "
            f"{[round(x, 4) for x in fixed['ttft_s'][2:]]}); installed K/V "
            f"vs the offline prefix: scaled err "
            f"{[f'{e_:.3e}' for e_ in errs]}; O^i vs the offline compress: "
            f"scaled err {[f'{e_:.3e}' for e_ in om_err]}, bitwise "
            f"{om_bitwise}; launches {launches}")
        if not (es["autotune_shrinks"] >= 1 and len(omegas) == 2
                and max(errs) <= REL_TOL["bfloat16"]
                and all(len(t_) == max_new for t_ in cold_toks)
                and launches["memcom_xattn"] > 0
                and launches["flash_attention"] > 0):
            raise AssertionError(f"{tag}: the autotuner failed its checks")
        del eng, omegas
        torch.cuda.empty_cache()
        return out

    def gemma_traffic(cfg, target, compressor):
        """The traffic harness at gemma2-2b's full width on a virtual
        clock: 24 requests over 6 raw-shot tasks of 3072 tokens (Zipf,
        Poisson arrivals at 5 a second, two classes), 2 HBM prefixes and a
        host tier,
        compiles of 512 tokens riding the fused steps; twice from one
        seed, with the tracer on and the SLO watchdog and ``ShedDegrade``
        attached as the launcher attaches them, which must give the same
        tokens, request_log, trace bytes and alert-log bytes."""
        tag = "[gemma2-2b traffic]"
        # 5 requests a simulated second: a task compiles in ~0.6 s of the
        # clock's cost model, so evicted tasks are asked for again and
        # come back from the host tier
        RATE, SLO_TTFT = 5.0, 1.0
        tcfg = TrafficConfig(num_tasks=6, context_tokens=T, num_requests=24,
                             priority_classes=2, rate_rps=RATE)
        runs = []

        class Shedding(engine_mod.Scheduler):
            """Counts the admissions the watchdog's shed floor refused (a
            dense engine's admission gate refuses nothing else)."""
            refused = 0

            def admit(self, can_seat=None):
                if can_seat is None:
                    return super().admit(None)

                def gate(r):
                    ok = can_seat(r)
                    Shedding.refused += not ok
                    return ok

                return super().admit(gate)

        for _ in range(2):
            trace = generate_trace(tcfg, 0, vocab=vocab)
            tracer, reg = Tracer(), MetricsRegistry()
            wd = SLOWatchdog(default_rules(slo_ttft_s=SLO_TTFT),
                             metrics=reg, tracer=tracer,
                             degrade_hook=ShedDegrade())
            eng = ServingEngine(cfg, target, slots=slots, max_len=max_len,
                                compressor=compressor,
                                compile_token_budget=512, prefix_capacity=2,
                                host_capacity=4, fused_step=True,
                                fused_chunk_tokens=16, clock=VirtualClock(),
                                tracer=tracer, metrics=reg, watchdog=wd)
            Shedding.refused = 0
            engine_mod.Scheduler = Shedding
            try:
                set_counts()
                res, wall = synced(eng.serve, list(trace.requests))
                launches = counts()
            finally:
                engine_mod.Scheduler = Shedding.__mro__[1]
            slo = slo_metrics(eng.request_log, slo_ttft_s=SLO_TTFT,
                              gap_samples=eng.gap_samples)
            fires = sum(e["kind"] == "fire" for e in wd.alert_log)
            runs.append(([res[r.uid].tolist() for r in trace.requests],
                         [eng.request_log[r.uid] for r in trace.requests],
                         tracer.dumps(), wd.dumps(),
                         slo, wall, eng.stats(), launches,
                         {"fires": fires,
                          "clears": len(wd.alert_log) - fires,
                          "pages": sum(e["kind"] == "fire"
                                       and e["severity"] == "page"
                                       for e in wd.alert_log),
                          "refused_admissions": Shedding.refused,
                          "events": len(tracer.events()),
                          "alert_log_valid": not validate_alert_log(
                              wd.report())}))
            del eng, tracer, wd
        same = runs[0][:2] == runs[1][:2]
        same_bytes = runs[0][2:4] == runs[1][2:4]
        slo, wall, st, launches, alerts = runs[0][4:]
        paths["gemma2-2b traffic"] = launches
        log(f"{tag} {card}: {slo['completed']}/{slo['requests']} completed "
            f"in {wall:.2f}s wall ({runs[1][5]:.2f}s the second run), "
            f"simulated: TTFT p50 {slo['ttft_p50_s']:.4f} / p99 "
            f"{slo['ttft_p99_s']:.4f} s, goodput {slo['goodput_rps']:.2f} "
            f"r/s at {SLO_TTFT} s, decode-gap p99 {slo['decode_gap_p99_s']:.4f} s,"
            f" {slo['preemptions']} preemptions; compiler {st['compiler']}; "
            f"tiers {st['prefix_tiers']}; fused compile chunks "
            f"{st['engine']['fused_compile_chunks']}; a second run's tokens "
            f"and request_log identical: {same}; launches {launches}")
        log(f"{tag} watchdog and tracer: {alerts['fires']} alerts fired "
            f"({alerts['pages']} page), {alerts['clears']} cleared, "
            f"{alerts['refused_admissions']} admissions refused by the shed "
            f"floor, {alerts['events']} trace events; a second run's "
            f"Tracer.dumps() and SLOWatchdog.dumps() bytes identical: "
            f"{same_bytes} ({len(runs[0][2])} and {len(runs[0][3])} bytes)")
        if not (same and same_bytes and alerts["alert_log_valid"]
                and slo["completed"] == slo["requests"]
                and launches["flash_attention"] > 0
                and launches["memcom_xattn"] > 0):
            raise AssertionError(f"{tag}: the traffic run failed its checks")
        return {"slo": slo, "wall_s": [r[5] for r in runs],
                "identical": same, "identical_bytes": same_bytes,
                "alerts": alerts, "stats": st, "launches": launches}

    def bench_target_exact():
        """The committed trained target (float32, head dim 32: the dense
        layout) serves 8 ICL prompts (a 96-token many-shot context and a
        query, budgets of 4-8 tokens, so that later requests join while
        others decode) greedily over 4 slots four ways: classic, fused
        (chunks of 16), self-speculative (k = 3) and drafted by the same
        config at seed 9.  Required: identical tokens and a self-draft accept rate
        of exactly 1.0."""
        from repro_torch import bridge
        from repro_torch.configs import bench_target

        tag = "[bench-target exact]"
        cfg = bench_target.config()
        path = str(Path(__file__).resolve().parent / bench_target.CHECKPOINT)
        target, _ = bridge.load_params(cfg, path, device="cuda")
        task = bench_target.TASKS["hwu64-like"]
        b_rng = np.random.default_rng(5)
        specs = []
        for _ in range(8):
            episode = make_episode(task, b_rng)
            ctx = build_manyshot_prompt(task, episode, b_rng,
                                        bench_target.SOURCE_LEN)
            q, _ = make_query(task, episode, ctx, b_rng)
            specs.append(dict(tokens=np.concatenate([ctx, q]),
                              max_new=int(b_rng.integers(4, 9))))
        mlen = max(len(x["tokens"]) for x in specs) + 8
        modes = {"classic": {}, "fused": dict(fused_step=True),
                 "spec_self": dict(fused_step=True, spec_draft="self",
                                   spec_k=3),
                 "spec_cross": dict(fused_step=True, spec_k=3, spec_draft=(
                     cfg, tfm.init_params(cfg, 9)))}
        runs, out = {}, {}
        for mode, kw in modes.items():
            eng = ServingEngine(cfg, target, slots=slots, max_len=mlen,
                                fused_chunk_tokens=16, **kw)
            set_counts()
            res = eng.serve([Request(**x) for x in specs])
            paths[f"bench-target {mode}"] = counts()
            runs[mode] = [res[u].tolist() for u in sorted(res)]
            es = eng.stats()["engine"]
            out[mode] = {k_: es[k_] for k_ in (
                "fused_steps", "fused_prefill_tokens", "draft_proposed",
                "draft_accepted", "accept_rate")}
        same = {mode: runs[mode] == runs["classic"] for mode in runs}
        log(f"{tag} {card}: tokens identical to the classic engine's "
            f"{same}; counters {out}")
        if not all(same.values()):
            for mode, toks in runs.items():
                for i, (a, b_) in enumerate(zip(toks, runs["classic"])):
                    d = next((j for j, (x, y) in enumerate(zip(a, b_))
                              if x != y), None)
                    if d is None:
                        continue
                    seq = np.concatenate([specs[i]["tokens"], b_[:d]])
                    with torch.no_grad():
                        lg, _ = target(tokens=torch.as_tensor(
                            seq[None], dtype=torch.long, device=dev))
                    top = torch.topk(lg[0, -1].float(), 2).values
                    log(f"{tag} {mode} request {i} diverges at token {d}: "
                        f"top-2 margin {float(top[0] - top[1]):.3e}")
                    break
        if not (all(same.values()) and out["spec_self"]["accept_rate"] == 1.0
                and out["fused"]["fused_prefill_tokens"] > 0
                and out["spec_cross"]["draft_accepted"]
                < out["spec_cross"]["draft_proposed"]):
            raise AssertionError(f"{tag}: the four ways disagree")
        return {"identical": same, "counters": out}

    paths = {}
    base_geom = (m, T, sources, max_len)
    for arch, need in (("gemma2-2b", ()), ("granite-moe-3b-a800m", ("gmm",))):
        report[arch] = main_path(
            arch, need, base_geom,
            then=gemma_fused if arch == "gemma2-2b" else None)
        paths[f"{arch} dense"] = report[arch]["launches"]
        paths[f"{arch} paged"] = report[arch]["paged"]["launches"]
        gc.collect()  # the models go before the next ones are built
        torch.cuda.empty_cache()
        report[arch]["kernel_vs_plain"] = kernel_vs_plain(arch, base_geom)
        gc.collect()
        torch.cuda.empty_cache()
    report["mamba2-370m"] = mamba_path()
    paths["mamba2-370m dense"] = report["mamba2-370m"]["dense"]["launches"]
    paths["mamba2-370m paged"] = report["mamba2-370m"]["paged"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    report["mamba2-370m"]["kernel_vs_plain"] = mamba_kernel_vs_plain()
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    report["train"] = train_path()
    paths["gemma2-2b train"] = report["train"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    report["train"]["kernel_vs_plain"] = train_kernel_vs_plain()
    report["train"]["phase_s"] = time.perf_counter() - t_phase
    log(f"[gemma2-2b train] phases 4d and 5b: "
        f"{report['train']['phase_s']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mgeom = (768, MT, msources[:2], 768 + 24 + max_new + 16)
    report["mistral-7b"] = main_path("mistral-7b", (), mgeom,
                                     then=mistral_then)
    then = report["mistral-7b"]["then"]
    paths["mistral-7b dense"] = report["mistral-7b"]["launches"]
    paths["mistral-7b paged"] = report["mistral-7b"]["paged"]["launches"]
    paths["mistral-7b online"] = then["online"]["launches"]
    paths["mistral-7b online fused"] = then["online"]["fused_launches"]
    for layout in ("dense", "paged"):
        paths[f"mistral-7b tiers {layout}"] = \
            then["tiers"][layout]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    report["mistral-7b"]["kernel_vs_plain"] = kernel_vs_plain("mistral-7b",
                                                              mgeom)
    gc.collect()
    torch.cuda.empty_cache()
    report["bench-target"] = trained_target_eval()
    for key, run in report["bench-target"].items():
        paths[f"bench-target eval {key}"] = run["launches"]
    report["bench-target"]["exact"] = bench_target_exact()
    report["mistral_phase_s"] = time.perf_counter() - t_phase
    log(f"[mistral-7b] phases 4e, 5 and the trained target's eval: "
        f"{report['mistral_phase_s']:.1f}s")

    # ---- result lines ----------------------------------------------------
    def compile_chunk(rows):
        """The online compiler's flash call at offsets 0, 3072 and 5632
        (w = 512, mistral-7b); the last one's numbers in full."""
        out = {}
        for r in rows:
            if r["shape"].startswith("mistral_chunk_"):
                out[r["shape"]] = {
                    "ms": r["ms"], "device_ms": r[f"device_ms_{r['variant']}"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                    "variant": r["variant"]}
        return dict(out["mistral_chunk_5632"], shape="mistral_chunk_5632",
                    by_offset=out)

    entries = []
    for key, rows, main in (
            ("flash_attention:flash_attention", flash_rows, "source_prefill"),
            ("memcom_xattn:memcom_xattn", mx_rows, "memory_xattn"),
            ("paged_attention:paged_flash_decode", paged_rows, "decode"),
            ("moe_gmm:gmm", gmm_rows, None),
            ("ssd_scan:ssd", ssd_rows, "prefill"),
            ("flash_attention:flash_attention_bwd", flash_bwd_rows,
             "memory_self_bwd"),
            ("memcom_xattn:memcom_xattn_bwd", mx_bwd_rows,
             "memory_xattn_bwd")):
        timed = [r for r in rows if "ms" in r]
        head = (next(r for r in rows if r["shape"] == main) if main
                else max(timed, key=lambda r: r["ms"]))
        name = key.split(":")[1]
        by_path = {path: c[name] for path, c in paths.items()}
        entries.append({
            "name": name, "route": "cuda",
            "source": registry.KERNELS[key]["source"],
            "replaces": registry.KERNELS[key]["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r.get(f"max_abs_err_{dn}", 0.0) for r in rows
                               for dn in ("float32", "bfloat16")),
            "scaled_err": max(r.get("scaled_err_bfloat16",
                                    r.get("grad_err_bfloat16", 0.0))
                              for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rows})
        if name in ("memcom_xattn", "paged_flash_decode",
                    "flash_attention_bwd", "memcom_xattn_bwd"):
            entries[-1]["device_ms"] = head["device_ms"]
        if name.endswith("_bwd"):  # backward calls, the yardstick's backend
            entries[-1].update(library_backend=head["library_backend"],
                               library_device_ms=head["library_device_ms"],
                               grad_err=entries[-1].pop("scaled_err"))
        if name == "memcom_xattn":  # the wgmma variant and the mma.sync one
            entries[-1].update(
                wgmma_launches=sum(c["memcom_xattn_wgmma"]
                                   for c in paths.values()),
                variant=head["variant"], nsplit=head["nsplit"],
                workspace_bytes=head["workspace_bytes"],
                **{k: head[k] for k in head
                   if k.startswith(("ms_", "device_ms_"))})
        if name == "flash_attention_bwd":  # the wgmma and mma.sync variants
            entries[-1].update(
                bwd_wgmma_launches=sum(c["flash_attention_bwd_wgmma"]
                                       for c in paths.values()),
                variant=head["variant"],
                **{k: head[k] for k in head
                   if k.startswith(("ms_", "device_ms_"))})
        if name == "memcom_xattn_bwd":  # the wgmma and mma.sync variants
            entries[-1].update(
                bwd_wgmma_launches=sum(c["memcom_xattn_bwd_wgmma"]
                                       for c in paths.values()),
                variant=head["variant"], nsplit=head["nsplit"],
                **{k: head[k] for k in head
                   if k.startswith(("ms_", "device_ms_", "workspace_"))})
        if name == "flash_attention":  # the wgmma variant and the mma.sync one
            entries[-1].update(
                wgmma_launches=sum(c["flash_attention_wgmma"]
                                   for c in paths.values()),
                ms_wgmma=head["ms_wgmma"], ms_mma_sync=head["ms_mma_sync"],
                compile_chunk=compile_chunk(rows))
        if name == "gmm":  # the wgmma, rows and mma.sync variants
            entries[-1].update(
                wgmma_launches=sum(c["gmm_wgmma"] for c in paths.values()),
                rows_launches=sum(c["gmm_rows"] for c in paths.values()),
                variant=head["variant"],
                library_device_ms=head["library_device_ms"],
                **{k: head[k] for k in head
                   if k.startswith(("ms_", "device_ms_"))})
        if name == "ssd":  # the chunked variant and the sequential one
            entries[-1].update(
                chunked_launches=sum(c["ssd_chunked"]
                                     for c in paths.values()),
                variant=head["variant"], chunk_q=head["chunk_q"],
                design_bytes=head["design_bytes"],
                design_bound_ms=head["design_bound_ms"],
                **{k: head[k] for k in head
                   if k.startswith(("ms_", "device_ms_"))})
    report["kernels"] = entries
    report["total_s"] = time.perf_counter() - t_main
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    log(f"chip_smoke total {report['total_s']:.1f}s")
    log(card)
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"}
                                for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
