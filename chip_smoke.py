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
      ``compile_chunk``); the ICAE step's causal self-attention, batch 2
      (bf16 only): gemma2-2b's compressor over 3072 + 512 positions and
      target over 512 + 512 (``icae_compressor``, ``icae_target``),
      mistral-7b's compressor over 6144 + 768 (``mistral_icae_compressor``;
      the plain version, 12 GB of float32 logits whole, in slices of a
      batch row and a KV-head group); the 3072-token source prefill at
      smollm-360m's 15/5 heads of 64 and stablelm-1.6b's 32/32 heads of 64
      (``smollm_source_prefill``, ``stablelm_source_prefill``); the fused
      step's dense decode over 4 slots with
      W = 4 lanes a slot (the speculative verify lanes at k = 3) and W =
      16 (a join chunk), behind lengths of 516-524 (``fused_decode_w4``,
      ``fused_decode_w16``); and probes (bf16 only): decode over caches of 2048 and 8192 positions and over 32 to
      72 slots, a prompt of 64 (query, head) rows against a 2048-token
      prefix, and causal self-attention short enough to split the KV
      axis; deepseek-v2-236b's MLA at Dv != D (``mla_*``, scale 192^-0.5):
      the non-absorbed source prefill, Memory-LLM (m = 1024), 16-token
      prompt causal and against the 1024-row prefix (float32 too), all
      128 heads of (192, 128), and the absorbed decode, 128 query heads on
      one latent head of (576, 512), one lane and W = 4 a slot, and
      probes of a 4- and a 16-token prompt against 4096 prefix rows at
      (192, 128) (bf16 only); and
      jamba-1.5-large-398b's attention (64/8 heads of 128): its source
      prefill and a prompt against its 1024-row prefix; qwen2-vl-2b's
      12/2 heads of 128 (a GQA group of 6: ``qwen_*``, bf16 only): source
      prefill, Memory-LLM, prompt causal and against the prefix, decode;
      whisper-medium's 16 heads of 64 (``whisper_*``, bf16 only): the
      encoder's 1500 x 1500 self-attention and the cross-attention of the
      512 memory rows, a 12-token prompt and a decode step over the 1500
      frames (not causal, every position 0; 1500 = 23 x 64 + 28), and its
      causal source prefill; and widths no kernel is built for
      (``width_*``, zero-padded to ``fa.tile_dims``' tile, the row's
      ``tile``): 16 and 32 causal over 512 rows, MLA smoke's (24, 16)
      causal and (40, 32) in a decode on one latent head.  Every bf16 shape
      runs through both bf16 kernels (at (576, 512) the mma.sync one
      alone: the wgmma variant takes (192, 128) and Dv == D), the wgmma
      variant and the mma.sync one, each forced and each held to the
      plain version; ``ms``
      is the time of the variant the wrapper picks (``variant``), beside
      ``ms_wgmma`` and ``ms_mma_sync``, and ``device_ms_wgmma`` /
      ``device_ms_mma_sync``: 20 calls captured into a CUDA graph and
      replayed, the time between launches left out (CUDA events around
      few-row calls time mostly the host; ``fa.variant_for``'s rule is
      set from these device times);
   b. ``memcom_xattn`` at 1x512 x 3072 at D = 2304 and D = 1536 (the
      compress paths'; qwen2-vl-2b's too) and whisper-medium's D = 1024
      (bf16 only), and mistral-7b's 1x768 x 6144 x 4096, smollm-360m's
      D = 960 (15 slabs of 64: the last output tile 192 columns wide) and
      stablelm-1.6b's 2048 at 1x512 x 3072, and jamba-1.5-large-398b's
      D = 8192 and deepseek-v2-236b's 5120 at 1x1024 x 3072 (bf16 only).
      Every bf16 shape runs through both
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
      heads of 64), smollm-360m's (15/5 heads of 64) and stablelm-1.6b's
      (32/32 heads of 64), ``long_table``: the main-path shape in
      tables of 4096 positions, deepseek-v2-236b's absorbed decode
      (``mla_decode``, ``mla_decode_w4``: q 4xWx128x576 against latent
      pools of (576, 512), bf16 only, a 1024-row prefix shared by two
      slots), jamba-1.5-large-398b's attention (64/8 heads of 128)
      behind its 1024-row prefix, qwen2-vl-2b's 12/2 heads of 128 (group
      6) at S = 1 and 3, whisper-medium's decoder self-attention (16 x 64),
      and widths run at a wider tile (``pa.tile_dims``: the loads past the
      call's widths skipped, no pool copied): 16, 32 and MLA smoke's
      (40, 32).  ``device_ms``: CUDA-graph replay rotating through
      input sets whose K/V rows read add up past 60 MB (14 at ``decode``),
      so that no call finds its rows in the 50 MB L2.  Its bound counts
      each distinct (pool block, offset) position below some slot's
      length once plus q, out, tables and lengths; no single PyTorch call
      attends through a block table, so it has no library time;
   d. ``gmm`` (the MoE grouped matmul) at granite's E = 40 experts, C =
      768 / 128 / 8 rows (source prefill / Memory-LLM / prompt and decode)
      in both orientations (1536 -> 512 and 512 -> 1536), and probes at C
      = 64, 32 and 16 (bf16 only) that set ``gm.variant_for``'s rule; and
      (bf16 only, two buffer sets) jamba-1.5-large-398b's 16 experts of
      8192 <-> 24576 at C = 480 (its source prefill) and 8, and
      deepseek-v2-236b's 160 experts of 5120 <-> 1536 at C = 144 and 8,
      their plain version one expert at a time.
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
      cross device memory four times).  jamba-1.5-large-398b's Mamba2
      layer (256 heads of 64, bf16 only): the 3072-token source and the
      target's 12-token prompt seeded by the handed-off state.  No
      PyTorch call runs the scan, so it has no library time.
   f. the backward kernels (``fa.flash_attention_bwd``,
      ``mx.memcom_xattn_bwd``) against their plain backward
      (``plain.attention_bwd_ref``, ``plain.memcom_xattn_bwd_ref``) on the
      same inputs: float32 (TF32 off) max abs error at most 1e-4 of max(1,
      the largest gradient), bf16 ``plain.grad_err`` at most 2e-2, per
      gradient.  Flash at the training step's shapes (gemma2-2b, batch 2:
      the Memory-LLM's 512 causal rows, the 512-token prompt at offset
      512 and against the 512 prefix, both with an lse cotangent), the
      3072-token source (Phase 2), fully-masked rows, granite's and
      mistral-7b's widths and float32 at head dim 32, and the ICAE step's
      causal self-attention without an lse cotangent (bf16: gemma2-2b's
      compressor 2x3584 and target 2x1024, mistral-7b's compressor
      2x6912; the plain backward in 3a's slices where its logits pass 6
      GB, and no ``plain.attention_bwd_tiled`` there), and deepseek-v2-
      236b's Phase-1 shapes at (D, Dv) = (192, 128), 128 heads: the
      Memory-LLM's 2x1024 causal rows, the 2x512 prompt at offset 1024
      and against the 1024-row prefix (both with an lse cotangent, float32
      too) and the 3072-token source (Phase 2; bf16 through the wgmma
      kernel, the one bf16 backward that takes the pair, float32 through
      the CUDA cores); whisper-medium's Memory-LLM cross-attention 2 x 512
      over 1500 frames; and the padded widths 16 and (24, 16), both
      dtypes, with an lse cotangent; ``memcom_xattn`` at
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
      ``F.scaled_dot_product_attention`` call (no cap, ``enable_gqa``, the
      call's scale; one head for ``memcom_xattn``) on the first backend
      that takes it,
      printed, by CUDA events, and its device time by graph replay over
      the same three sets (forward and backward less the forward alone).
      Bound: five products against the forward's two.
   g. the ``gmm`` and ``ssd`` backward kernels (``gm.gmm_bwd``,
      ``ss.ssd_bwd``) against ``plain.gmm_bwd_ref`` / ``plain.ssd_bwd_ref``
      on the same inputs, by 3f's rule (float32 ssd inputs widened to
      float64 for the plain version, as the kernel sums them), each call
      repeated and required bit-identical: gmm dX and dW at granite's C =
      256 (Memory-LLM and prompt) and C = 1536 (the source), E = 40, D
      1536 <-> F 512 both ways; ssd at mamba2-370m's training call (2 x
      3072, 32 heads of 64, N 128, no initial state, no final-state
      cotangent), and 1000 tokens in two groups with an initial state and
      a final-state cotangent, at seeded decays and at dt·|A| = 25 a
      token.  Every kernel of a dtype runs, forced and checked: bf16 gmm
      through its wgmma and mma.sync variants, bf16 ssd through its
      chunked and sequential ones (float32: one kernel each).  bf16
      times of both variants side by side (``ms_<variant>``,
      ``device_ms_<variant>``; ``ms`` / ``device_ms`` the picked one's,
      ``gm.bwd_variant_for`` / ``ss.bwd_variant_for``): ``ms`` by CUDA
      events, ``device_ms`` by graph replay over three input sets, the
      plain version's ms, gmm's ``torch.bmm`` of each product
      (``library_ms``; ssd has none), and the bound max(operations / 989
      TFLOP/s, bytes / 3.35 TB/s); gmm's head numbers are dX alone
      (Phase 1's call), with dW and both beside; ssd's workspace bytes
      of both variants.  Then, under ``torch.no_grad``, a call through each wrapper
      on an input that requires grad launches the forward alone.
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
   j. granite-moe-3b-a800m (after the mistral-7b phase and the trained
      target's, so that the profiled steps follow every timed phase):
      MemCom Phase 1 as 4d, at full width and depth (32 layers, 40
      experts top-8), with the same checks, and on every step 3 x (32 +
      31) dX-only ``gmm`` backward calls (each expert product of the
      target's MoE layers and of the Memory-LLM's but its last, whose
      output no loss term reads; the experts are frozen, so no dW) at C =
      256 rows an expert, every one through the wgmma variant; the
      3072-token source's C = 1536 calls run the
      forward alone (no input needs a gradient).
   k. mamba2-370m next-token training at full width and depth (48 Mamba2
      layers) through ``launch.steps.build_lm_train_step`` (every
      parameter, remat) and the Trainer: batch 2 x 3072 tokens, 4 steps,
      checkpoints, restart and profile as 4d; every step one ``ssd``
      backward call a layer (48), every one through the chunked variant,
      and every forward ``ssd`` call through the chunked variant.  4j and 4k print s/step, tokens/s, peak memory
      and each phase's seconds.
   o. deepseek-v2-236b and jamba-1.5-large-398b at full width, depth 2
      (deepseek: its dense-FFN MLA prefix layer and one MLA + MoE layer,
      16.29 B parameters over three stacks and memx; jamba: one Mamba2 +
      MoE layer and its attention + dense layer, 35.98 B, 72 GB in bf16),
      after mamba2-370m's serving, each model freed before the next:
      two 3072-token tasks into m = 1024 (jamba's Mamba2 layer hands the
      target its final SSM state), a dense serve of 4 requests, the
      12-request paged serve with stops and refills (first tokens dense =
      paged), jamba's refilled slot against a fresh engine's tokens
      (exact), then on the same models the kernel path against the plain
      one (phase 5's checks: O^i and the handed-off states, first-step
      logits, a paged engine's prefills and decode step; the MoE top-k
      replayed; jamba's plain expert products one expert at a time and
      its plain attention in slices), and for deepseek-v2-236b the online
      compile of task 0 (``memcom.compress_chunked`` at 512-token slices,
      each MLA layer's chunk a prefill continuation merged by lse through
      the (192, 128) wgmma forward, and ``PrefixCompiler.step(512)``'s
      installed latents) against the offline compress, within 2e-2 of
      the largest magnitude.  Printed: compress s, tok/s, peak
      memory beside the reckoned bytes, the phase's seconds.
   p. deepseek-v2-236b MemCom Phase 1 at full width, depth 2 (4o's cut,
      last in the run): as 4d through ``launch/train.py``'s ``build``,
      batch 2 x 3584 split at 3072 (m = 1024), 4 steps, checkpoints after
      2 and 4, the restart from 2; every step 5 flash backward calls, all
      at (192, 128) through the wgmma variant (the Memory-LLM's self-
      attention and the prompt against the prefix in both layers, the
      prompt's self-attention in layer 1: layer 0's reads only frozen
      embeddings), 2 ``memcom_xattn`` backward calls and 3 dX-only
      ``gmm`` backward calls (the target's one MoE layer; the Memory-
      LLM's is its last).  Printed: s/step, tokens/s, peak memory beside
      the reckoned bytes (weights, bf16 gradients and float32 AdamW state
      of the 215 M trained parameters), one profiled step.
      jamba-1.5-large-398b's Phase 1 is not run: its reckoning (PERF.md
      section 4) passes the card's 80 GB.
   n. smollm-360m (32 layers, d_model 960, 15/5 heads of 64) and
      stablelm-1.6b (24 layers, d_model 2048, 32/32 heads of 64,
      layernorm), both cut to depth 8 since PR 30 (to keep the run within
      its time limit), after 4o: as 4a-b (two 3072-token
      tasks into m = 512, dense serve of 4 requests, the 12-request paged
      serve with stops and refills, the first tokens dense = paged), every
      source prefill and ``memcom_xattn`` call through its wgmma variant,
      each kernel of the path launched, and their depth-2 check (phase 5).
   l. ICAE at gemma2-2b's full width (26 layers, m = 512; last, after 4j
      and 4k): one seeded target, and for icae++, icae and icae+ a
      compressor copied from it (adapters and ``mem_embed`` from seed 1):
      the two 3072-token tasks compressed into 2 x 512 soft tokens (every
      compressor flash call over the 3584 positions through the variant
      ``fa.variant_for`` picks) and the first-step logits of the 4-12-token
      prompts behind them (finite, of their shapes); then
      ``launch.steps.build_icae_train_step`` (AdamW with the reference's
      ``warmup_constant(2e-3, 30)``, clip 1.0, remat) through the Trainer
      on batch 2 x 3584 split at 3072, as 4d: icae++ 4 steps with raw
      checkpoints after steps 2 and 4 and a restart from step 2 that must
      reproduce steps 3-4 exactly, icae and icae+ 2 steps each; losses
      finite, every trained tensor's float32 master moved, every frozen
      tensor (the target, the compressor's untrained ones) bit-identical
      to its seed's draw, and 52
      flash backward calls a step (26 in each stack: ``mem_embed`` trains,
      so the compressor's first layer needs dQ, dK and dV; the soft
      tokens carry the target's gradient back), each through the variant
      ``fa.bwd_variant_for`` picks.  Printed: s/step, tokens/s, peak
      memory, and one profiled icae++ step.
   m. ICAE++ at mistral-7b's full width, depth 8 since PR 30 (its 32
      layers' raw checkpoint, 18.8 GB, took ~80 s to write and restore;
      m = 768): the same on the first two 6144-token tasks and batch 2 x
      6656 split at 6144, 3 steps, a checkpoint after step 1 and the
      restart from it reproducing steps 2-3 exactly; 16 flash backward
      calls a step (8 a stack); the peak memory printed beside its
      reckoning (two bf16 copies of the target's parameters, bf16
      gradients and float32 AdamW moments and master of the trained
      ones, remat's saved block inputs).
      mistral-nemo-12b is CPU-only: its three stacks and memx hold about
      40.9 B parameters (82 GB in bf16).
   In 4d, 4j-4m the frozen tensors are held to their seed's draw, made
   again on the card after the run (no copy is kept through it: 26 GB at
   mistral-7b's ICAE++), and the restart restores a Trainer from the
   checkpoint and then calls its step function on the later steps'
   batches.
   e. mistral-7b (after the training phase, the other models freed; cut
      to 16 of its 32 layers to keep the run within its time limit; d_model 4096, 32/8 heads of 128, m = 768; ~12.35 B parameters
      over its three stacks and memx at that depth, initialised on the
      card):
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
   W = 16), dense and paged, each step rerun forced to the plain versions
   on its own inputs (tokens, positions, a copy of the cache it found):
   the valid lanes' logits agree within the same bound.  For the
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

   After 4l and 4m: for icae, icae+ and icae++ at gemma2-2b and icae++
   at mistral-7b, at full width and depth 2, a task's soft tokens and the
   first-step logits of a prompt behind them, then the loss (gemma2-2b
   batch 2 x 3584, mistral-7b 1 x 6656) and every trained gradient with
   each adapter's ``b`` drawn off zero, through the kernels and forced to
   the plain versions: each within 2e-2 of the plain run's largest
   magnitude, with 4 flash backward calls (2 layers, 2 stacks).
   smollm-360m and stablelm-1.6b at depth 2 as the attention-only models
   above (O^i, logits, paged prefill and decode, the fused steps).

   After 4p: deepseek-v2-236b's Phase-1 and Phase-2 loss and every
   trained gradient at 4o's depth-2 cut as gemma2-2b's above (top-k
   replayed; the plain attention in 1 GiB slices and the plain expert
   products one expert at a time, each recomputed in the backward; the
   kernel run's gradients wait on the host), every flash backward call
   through the wgmma variant.

   After granite-moe-3b-a800m's and mamba2-370m's training phases (4j,
   4k): their loss and every trained gradient at full width and depth 2
   through the kernels and forced to the plain versions, each gradient
   within 2e-2 of the plain run's largest magnitude: granite Phase 1
   (dX-only gmm backward calls) and Phase 2 (the experts train: dW too),
   the plain run replaying the kernel run's top-k ids; mamba2-370m's
   next-token loss over 2 x 3072 tokens (two ``ssd`` backward calls).

   After 4p:
   q. qwen2-vl-2b (28 layers, d_model 1536, 12/2 heads of 128, M-RoPE,
      qkv bias, m = 512; three stacks and memx of ~4.9 B parameters) at
      full width and depth, as 4a-b (two 3072-token tasks, a dense serve
      of 4 requests, the 12-request paged serve with stops and refills,
      the first tokens dense = paged, every source prefill and
      ``memcom_xattn`` call through its wgmma variant) with the profiled
      runs, then its depth-2 check (phase 5, the fused steps included).
   r. whisper-medium (24 decoder and 24 encoder layers, d_model 1024, 16
      heads of 64, 1500 frames, m = 512; ~2.4 B parameters over three
      stacks and memx; a slot's cross entries ~147 MB) at full width and
      depth: (b) the launcher's engine path, which has no frames (as in
      the JAX package: the one-shot compress's cross blocks fall through
      to a causal self-attention; the engine's read zero cross entries),
      as 4a-b; then on the same models (a) the frames path through the
      JAX package's entry points: ``launch.steps.build_compress_step`` on
      the two tasks with 1500 seeded frames each, ``write_prefix_to_cache``,
      a target prefill of a prompt at cache_index = mask_offset = m with
      the encoder output (filling the cross entries) and 16 greedy steps
      of ``build_decode_step``, which read them back: every call over the
      frames (the encoder's 24 layers and each decoder block's cross-
      attention) launches the flash kernel, the encoder's through the
      wgmma variant (printed with its split count), logits finite; then
      (c) the depth-2 check (encoder depth 2 too) of both paths (no fused
      step: enc-dec refuses it, as the JAX engine does).
   s. ``launch/serve.py --smoke`` on the card for whisper-medium,
      qwen2-vl-2b, deepseek-v2-236b and jamba-1.5-large-398b (float32 at
      the widths no kernel is built for: 16, 32, MLA's (24, 16) and (40,
      32)), dense and paged (blocks of 4), each run again forced to the
      plain versions: identical tokens, and the flash (and paged) kernel
      launched in the kernel run.  4h's trained target also serves paged
      (its 32-wide heads on the paged kernel's 64-wide tile), kernel and
      plain: the classic engine's tokens.
   v. tensor-parallel serving (after 4u): gemma2-2b split by head on a
      ``gloo`` mesh of ranks that share the card (``launch/mesh.py``
      ``run_ranks``, ``make_serving_mesh(model=n, backend="gloo")``): 2
      ranks at full width and depth, 4 ranks at depth 2 (2 of the 8 query
      heads and 1 of the 4 KV heads a rank), 2 ranks at depth 2 in
      float32.  Each rank compresses both 3072-token tasks with the whole
      compressor, materializes them through its split target and serves
      the four prompts dense (task 1 compiled online, 1024-token chunks)
      and paged (blocks of 16).  Each run is held to the one-rank engine
      on the same seeded weights: every rank's tokens and first decode
      step's logits the same, the tokens the one-rank engine's, and the
      logits within 1e-4 scaled in float32, in bf16 within 0.3 scaled at
      full depth and 0.05 at depth 2 (twice the one-rank engine's own
      distance from itself when its prompt calls take the other flash
      kernel, a fixed rule; printed with the tokens and each request's
      first differing position).  The three runs' ranks are one spawn
      of 4; ranks 2 and 3 sit out the 2-way runs.  Each rank prints its launches, and each
      kernel call's variant and split count at its local heads, held to
      its plain version; peak memory a rank; the phase's seconds.  Then a
      1x1 ``nccl`` mesh through ``launch/serve.py --mesh 1``: the
      launcher's tokens without a mesh.  The ranks' all_reduce goes
      through the host (gloo), so no time of this phase is a rate of
      tensor-parallel serving.

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
from dataclasses import replace as dc_replace
from pathlib import Path

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
E2E_REL_TOL = 2e-2


def log(*a):
    print(*a, flush=True)


# ---- phase 4v: tensor-parallel serving, one function a rank -------------
# Module-level, so that the ranks ``run_ranks`` spawns can import it (a
# spawned child runs this file again as ``__mp_main__``; main() does not
# run there).


class _KernelSpy:
    """Wraps the flash, paged and memcom_xattn kernels' entry points while
    a run goes: counts each distinct call (shapes, dtype, static
    arguments), records the variant and split count the wrapper picks for
    it at this rank's head counts, and keeps its first inputs, which
    :meth:`check` runs again through the kernel and the plain version
    after the run's launch counts have been read."""

    def __init__(self, fa, pa, mx):
        self.fa, self.pa, self.mx = fa, pa, mx
        self.rows = {}

    def _note(self, key, make_row, inputs):
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = make_row()
            row["calls"] = 0
            row["inputs"] = inputs()
        row["calls"] += 1

    def __enter__(self):
        import torch

        fa, pa, mx = self.fa, self.pa, self.mx
        self.inner = (fa.flash_attention, pa.paged_flash_decode,
                      mx.memcom_xattn)
        flash, paged, xattn = self.inner
        dev = torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def clone(*ts):
            return [t.clone() if torch.is_tensor(t) else t for t in ts]

        def flash_spy(q, k, v, **kw):
            B, Sq, Hq, D = q.shape
            Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
            static = tuple(sorted((n, x) for n, x in kw.items()
                                  if not torch.is_tensor(x)))
            key = ("flash_attention", tuple(q.shape), tuple(k.shape), Dv,
                   str(q.dtype), static)

            def row():
                nsplit = fa._splits(B, Sq, Skv, Hq, Hkv, dev)
                tile = fa.tile_dims(q.dtype, D, Dv) or (D, Dv)
                return {"kernel": "flash_attention", "q": list(q.shape),
                        "kv": list(k.shape), "dtype": str(q.dtype),
                        "nsplit": nsplit,
                        "variant": kw.get("variant") or fa.variant_for(
                            q.dtype, tile[0], Skv, nsplit, tile[1])}

            self._note(key, row, lambda: (clone(q, k, v), {
                n: (x.clone() if torch.is_tensor(x) else x)
                for n, x in kw.items()}))
            return flash(q, k, v, **kw)

        def paged_spy(q, k_pool, v_pool, **kw):
            B, S, Hq, D = q.shape
            Hkv = k_pool.shape[2]
            nb, bs = kw["block_tables"].shape[1], k_pool.shape[1]
            key = ("paged_flash_decode", tuple(q.shape),
                   tuple(k_pool.shape), str(q.dtype), kw.get("softcap"))

            def row():
                return {"kernel": "paged_flash_decode", "q": list(q.shape),
                        "pool": list(k_pool.shape), "dtype": str(q.dtype),
                        "nsplit": pa.num_splits(B, S, Hq, Hkv, nb, bs, sms)}

            self._note(key, row, lambda: (clone(q, k_pool, v_pool), {
                n: (x.clone() if torch.is_tensor(x) else x)
                for n, x in kw.items()}))
            return paged(q, k_pool, v_pool, **kw)

        def xattn_spy(q, k, v, **kw):
            B, M, D = q.shape
            T = k.shape[1]
            key = ("memcom_xattn", tuple(q.shape), tuple(k.shape),
                   str(q.dtype))

            def row():
                return {"kernel": "memcom_xattn", "q": list(q.shape),
                        "kv": list(k.shape), "dtype": str(q.dtype),
                        "variant": mx.variant_for(q.dtype, B, M, T, D, True),
                        "nsplit": mx.num_splits(B, M, T, D, sms)}

            self._note(key, row, lambda: (clone(q, k, v), dict(kw)))
            return xattn(q, k, v, **kw)

        fa.flash_attention = flash_spy
        pa.paged_flash_decode = paged_spy
        mx.memcom_xattn = xattn_spy
        return self

    def __exit__(self, *exc):
        (self.fa.flash_attention, self.pa.paged_flash_decode,
         self.mx.memcom_xattn) = self.inner

    def check(self, plain, tag, quiet=False):
        """Each recorded shape through its kernel again and its plain
        version: max abs error and ``plain.scaled_err`` within the dtype's
        rule (1e-4 float32, 2e-2 bfloat16)."""
        import torch

        flash, paged, xattn = self.inner
        fns = {"flash_attention": (flash, plain.attention_ref),
               "paged_flash_decode": (paged,
                                      plain.paged_decode_attention_ref),
               "memcom_xattn": (xattn, plain.memcom_xattn_ref)}
        out = []
        for row in self.rows.values():
            (args, kw) = row.pop("inputs")
            kernel, ref_fn = fns[row["kernel"]]
            kw_ref = {n: x for n, x in kw.items()
                      if n not in ("variant", "return_lse")}
            got = kernel(*args, **kw)
            want = ref_fn(*args, **kw_ref)
            if isinstance(got, tuple):
                got = got[0]
            if isinstance(want, tuple):
                want = want[0]
            torch.cuda.synchronize()
            dn = row["dtype"].split(".")[1]
            row["max_abs_err"] = float((got.float() - want.float()).abs()
                                       .max())
            row["scaled_err"] = plain.scaled_err(got, want)
            ok = row["max_abs_err"] <= TOL[dn] \
                and row["scaled_err"] <= REL_TOL[dn]
            if not quiet:
                log(f"{tag} {row['kernel']} q {row['q']} "
                    f"{row.get('kv', row.get('pool'))} {dn}: "
                    f"{row['calls']} call(s), variant "
                    f"{row.get('variant', '-')}, nsplit {row['nsplit']}; "
                    f"kernel vs plain max_abs_err {row['max_abs_err']:.3e}, "
                    f"scaled {row['scaled_err']:.3e}")
            if not ok:
                raise AssertionError(f"{tag} {row['kernel']} at {row['q']} "
                                     "disagrees with its plain version")
            out.append(row)
        self.rows = {}
        return out


def tp_runs(rank, world, specs):
    """:func:`tp_serve` for each spec in turn, in one spawn (None from a
    rank that sits out a spec's smaller mesh)."""
    return [tp_serve(rank, world, spec) for spec in specs]


def tp_serve(rank, world, spec):
    """One rank of phase 4v (or, at ``spec["model"]`` 0, the one-rank
    engine without a mesh that the ranks are held to): gemma2-2b from
    seeds at full width (``depth`` cuts the layers), a ``spec["model"]``-
    way gloo mesh of ranks that share the card; both tasks compressed by
    the whole compressor and materialized through the split target, a
    dense engine (task 0 offline, task 1 compiled online from its raw
    shots) and a paged one (blocks of 16, both offline) serve the
    prompts; the first decode step's logits of each, every kernel call
    recorded (variant and split count at the local heads) and held to its
    plain version after the run.  A rank past the mesh (ranks 2 and 3 of
    a 2-way spec) makes the mesh with the others and returns None."""
    import numpy as np
    import torch

    from repro_torch.config import LayerLayout
    from repro_torch.configs import get_config
    from repro_torch.core import memcom
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import memcom_xattn as mx
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import Request, ServingEngine, materialize_prefix

    torch.backends.cuda.matmul.allow_tf32 = False
    tag = (f"[4v {spec['model']}-way rank {rank}]" if spec["model"]
           else "[4v one rank]")
    cfg = get_config(spec["arch"])
    if spec["depth"]:
        cfg = cfg.replace(name=f"{cfg.name}-depth{spec['depth']}",
                          layout=LayerLayout(period=cfg.layout.period,
                                             repeats=spec["depth"]))
    if spec["dtype"]:
        cfg = cfg.replace(dtype=spec["dtype"])
    dev = torch.device("cuda")
    mesh = (make_serving_mesh(model=spec["model"], device=dev,
                              backend="gloo") if spec["model"] else None)
    if mesh is not None and mesh.get_coordinate() is None:
        return None
    t0 = time.perf_counter()  # after the wait for ranks still serving
    torch.cuda.reset_peak_memory_stats()
    target = tfm.init_params(cfg, 0)
    compressor = memcom.init_memcom(cfg, target, 1)
    m, bs = cfg.memcom.num_memory_tokens, 16
    kw = dict(slots=spec["slots"], max_len=spec["max_len"], mesh=mesh)
    dense = ServingEngine(cfg, target, compressor=compressor,
                          compile_token_budget=spec["budget"], **kw)
    paged = ServingEngine(cfg, target, kv_layout="paged", block_size=bs,
                          num_blocks=1 + 2 * (m // bs) + spec["slots"] * 4,
                          **kw)
    torch.cuda.synchronize()
    counters = {"flash_attention": fa, "memcom_xattn": mx,
                "paged_flash_decode": pa}
    for mod in counters.values():
        mod.launches = 0
    fa.wgmma_launches = mx.wgmma_launches = 0
    logits = {}

    def first_decode(name):
        def hook(module, args, kwargs, out):
            if kwargs.get("decode") and name not in logits:
                logits[name] = out[0][:, -1].float().cpu().numpy()
        return hook

    spy = _KernelSpy(fa, pa, mx)
    sources = spec["sources"]
    with spy:
        for t, src in enumerate(sources):
            prefix, _ = memcom.compress(
                compressor, cfg, torch.as_tensor(src[None], device=dev))
            kv = materialize_prefix(target, cfg, prefix)
            paged.add_prefix(f"task{t}", kv)
            if t == 0:
                dense.add_prefix("task0", kv)
        local_kv = int(kv[0]["k"].shape[2])
        runs = {}
        for name, eng in (("dense", dense), ("paged", paged)):
            reqs = [Request(tokens=p, max_new=spec["max_new"], uid=i,
                            **({"raw_shots": sources[1]}
                               if name == "dense" and i % 2
                               else {"prefix": f"task{i % 2}"}))
                    for i, p in enumerate(spec["prompts"])]
            handle = target.register_forward_hook(first_decode(name),
                                                  with_kwargs=True)
            try:
                out = eng.serve(reqs)
            finally:
                handle.remove()
            runs[name] = [out[r.uid].tolist() for r in reqs]
    torch.cuda.synchronize()
    launches = {key: mod.launches for key, mod in counters.items()}
    launches["flash_attention_wgmma"] = fa.wgmma_launches
    launches["memcom_xattn_wgmma"] = mx.wgmma_launches
    serve_s = time.perf_counter() - t0
    quiet = rank > 0  # rank 0 speaks for all
    if not quiet:
        log(f"{tag} {cfg.name} {cfg.dtype}: {local_kv} of "
            f"{cfg.num_kv_heads} KV heads on this rank; launches "
            f"{launches}")
    shapes = spy.check(plain, tag, quiet)
    return {"tokens": runs, "logits": logits, "launches": launches,
            "shapes": shapes, "local_kv_heads": local_kv,
            "compiled": dense.stats()["compiler"]["jobs"],
            "mesh": dense.stats().get("mesh"),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "serve_s": serve_s, "seconds": time.perf_counter() - t0}


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

    def head_slices(B, Sq, Skv, Hkv, G, budget=2 ** 31):
        """(batch row, first KV head, end KV head) slices of a GQA call
        whose float32 logits stay within ``budget`` bytes."""
        n = max(1, min(Hkv, budget // (4 * G * Sq * Skv)))
        return [(b, h, min(h + n, Hkv)) for b in range(B)
                for h in range(0, Hkv, n)]

    def plain_attention(q, k, v, **kw):
        """``plain.attention_ref``; a call whose float32 logits pass 6 GB
        (the ICAE compressor's 2 x 6912 positions at mistral-7b's width,
        12 GB) is computed in (batch row, KV-head group) slices of at most
        2 GB each, which attend independently."""
        B, Sq, Hq, _ = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        G = Hq // Hkv
        if B * Hq * Sq * Skv * 4 <= 6 * 2 ** 30:
            return plain.attention_ref(q, k, v, **kw)
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        for b, h0, h1 in head_slices(B, Sq, Skv, Hkv, G):
            r = plain.attention_ref(
                q[b:b + 1, :, h0 * G:h1 * G], k[b:b + 1, :, h0:h1],
                v[b:b + 1, :, h0:h1], **dict(
                    kw, q_pos=kw["q_pos"][b:b + 1],
                    kv_pos=kw["kv_pos"][b:b + 1]))
            if kw.get("return_lse"):
                r, lse[b:b + 1, :, h0 * G:h1 * G] = r
            out[b:b + 1, :, h0 * G:h1 * G] = r
        return (out, lse) if kw.get("return_lse") else out

    def plain_attention_bwd(q, k, v, out, lse, dout, dlse, **kw):
        """``plain.attention_bwd_ref`` in the slices of
        :func:`plain_attention` where its logits pass 6 GB."""
        B, Sq, Hq, _ = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        G = Hq // Hkv
        if B * Hq * Sq * Skv * 4 <= 6 * 2 ** 30:
            return plain.attention_bwd_ref(q, k, v, out, lse, dout, dlse,
                                           **kw)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        for b, h0, h1 in head_slices(B, Sq, Skv, Hkv, G):
            qs, ks = slice(h0 * G, h1 * G), slice(h0, h1)
            g = plain.attention_bwd_ref(
                q[b:b + 1, :, qs], k[b:b + 1, :, ks], v[b:b + 1, :, ks],
                out[b:b + 1, :, qs], lse[b:b + 1, :, qs],
                dout[b:b + 1, :, qs],
                None if dlse is None else dlse[b:b + 1, :, qs],
                **dict(kw, q_pos=kw["q_pos"][b:b + 1],
                       kv_pos=kw["kv_pos"][b:b + 1]))
            dq[b:b + 1, :, qs], dk[b:b + 1, :, ks], dv[b:b + 1, :, ks] = g
        return dq, dk, dv

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
    smollm_heads = (15, 5, 64, 0.0)    # smollm-360m: GQA group 3
    stablelm_heads = (32, 32, 64, 0.0)  # stablelm-1.6b: MHA
    jamba_heads = (64, 8, 128, 0.0)    # jamba-1.5-large-398b's attention
    qwen_heads = (12, 2, 128, 0.0)     # qwen2-vl-2b: GQA group 6
    whisper_heads = (16, 16, 64, 0.0)  # whisper-medium: MHA
    frames = 1500                      # whisper-medium's encoder frames
    # deepseek-v2-236b's MLA: the non-absorbed prefill, keys 128 nope + 64
    # rope, values 128, 128 heads; the absorbed decode, 128 query heads on
    # one latent head of 576 (key) / 512 (value); both at scale 192^-0.5
    mla_scale = 192 ** -0.5
    mla_heads = (128, 128, 192, 0.0, 128, mla_scale)
    mla_dec_heads = (128, 1, 576, 0.0, 512, mla_scale)
    mla_m = 1024        # memory tokens of jamba-1.5-large-398b / deepseek
    mla_max_len = mla_m + 24 + max_new + 16
    mla_lengths = lengths + (mla_m - m)
    mla_decode_kv = arange(0, mla_max_len)[None].expand(
        slots, mla_max_len).contiguous()
    # the ICAE step's causal self-attention (batch 2): the compressor over
    # source + memory, the target over the soft tokens + 512 target tokens
    icae_gemma = (T + m, m + 512)
    icae_mistral = 2 * T + 768
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
        # the ICAE baselines' training shapes (bf16 only): gemma2-2b's
        # compressor and target, mistral-7b's compressor
        *((name_, 2, S_, S_, arange(0, S_)[None].expand(2, S_).contiguous(),
           arange(0, S_)[None].expand(2, S_).contiguous(), True, heads_)
          for name_, S_, heads_ in (
              ("icae_compressor", icae_gemma[0], gemma_heads),
              ("icae_target", icae_gemma[1], gemma_heads),
              ("mistral_icae_compressor", icae_mistral, mistral_heads))),
        # the 3072-token source prefill at smollm-360m's and stablelm-1.6b's
        # widths (bf16 only)
        ("smollm_source_prefill", 1, T, T, arange(0, T)[None],
         arange(0, T)[None], True, smollm_heads),
        ("stablelm_source_prefill", 1, T, T, arange(0, T)[None],
         arange(0, T)[None], True, stablelm_heads),
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
        # MLA's (192, 128) split further than its main path's 3 ways: a
        # 4-token and a 16-token prompt against 4096 prefix rows
        *((f"probe_mla_prefix_{n}x4096", 1, n, 4096, arange(4096, n)[None],
           arange(0, 4096)[None], False, mla_heads) for n in (4, 16)),
        # deepseek-v2-236b (Dv != D): the MLA source prefill, the Memory-
        # LLM's m = 1024 rows, a 16-token prompt (its MoE bucket) causal and
        # against the 1024-row prefix (with lse), and the absorbed decode,
        # one lane a slot and the fused step's W = 4
        ("mla_source_prefill", 1, T, T, arange(0, T)[None],
         arange(0, T)[None], True, mla_heads),
        ("mla_memory_self", 1, mla_m, mla_m, arange(0, mla_m)[None],
         arange(0, mla_m)[None], True, mla_heads),
        ("mla_prompt_self", 1, 16, 16, arange(mla_m, 16)[None],
         arange(mla_m, 16)[None], True, mla_heads),
        ("mla_prompt_prefix", 1, 16, mla_m, arange(mla_m, 16)[None],
         arange(0, mla_m)[None], False, mla_heads),
        ("mla_decode", slots, 1, mla_max_len, (mla_lengths - 1)[:, None],
         mla_decode_kv, True, mla_dec_heads),
        ("mla_fused_decode_w4", slots, 4, mla_max_len,
         mla_lengths[:, None] + arange(0, 4)[None], mla_decode_kv, True,
         mla_dec_heads),
        # jamba-1.5-large-398b's attention layer (64/8 heads of 128): its
        # source prefill and the prompt against its 1024-row prefix
        ("jamba_source_prefill", 1, T, T, arange(0, T)[None],
         arange(0, T)[None], True, jamba_heads),
        ("jamba_prompt_prefix", 1, prompt_len, mla_m,
         arange(mla_m, prompt_len)[None], arange(0, mla_m)[None], False,
         jamba_heads),
        # qwen2-vl-2b (12/2 x 128, group 6): source prefill, Memory-LLM,
        # prompt causal and against the prefix, decode
        ("qwen_source_prefill", 1, T, T, arange(0, T)[None],
         arange(0, T)[None], True, qwen_heads),
        ("qwen_memory_self", 1, m, m, arange(0, m)[None], arange(0, m)[None],
         True, qwen_heads),
        ("qwen_prompt_self", 1, prompt_len, prompt_len,
         arange(m, prompt_len)[None], arange(m, prompt_len)[None], True,
         qwen_heads),
        ("qwen_prompt_prefix", 1, prompt_len, m, arange(m, prompt_len)[None],
         arange(0, m)[None], False, qwen_heads),
        ("qwen_decode", slots, 1, max_len, (lengths - 1)[:, None], decode_kv,
         True, qwen_heads),
        # whisper-medium (16 x 64): the encoder over 1500 frames and the
        # decoder's cross-attention of the 512 memory rows, a prompt and a
        # decode step over them (not causal, every position 0: 1500 = 23 x
        # 64 + 28, a ragged last tile), and its causal source prefill
        ("whisper_encoder", 1, frames, frames, arange(0, frames)[None] * 0,
         arange(0, frames)[None] * 0, False, whisper_heads),
        ("whisper_memory_cross", 1, m, frames, arange(0, m)[None] * 0,
         arange(0, frames)[None] * 0, False, whisper_heads),
        ("whisper_prompt_cross", 1, prompt_len, frames,
         arange(0, prompt_len)[None] * 0, arange(0, frames)[None] * 0, False,
         whisper_heads),
        ("whisper_decode_cross", slots, 1, frames,
         arange(0, 1)[None].expand(slots, 1) * 0,
         arange(0, frames)[None].expand(slots, frames) * 0, False,
         whisper_heads),
        ("whisper_source_prefill", 1, T, T, arange(0, T)[None],
         arange(0, T)[None], True, whisper_heads),
        # widths no kernel is built for (zero-padded to fa.tile_dims'
        # tile): the smoke configs' 16 (whisper, jamba) and 32 (qwen2-vl,
        # the bench target), MLA smoke's (24, 16) causal and (40, 32) in
        # its absorbed decode (8 query heads on one latent head)
        *((f"width_{D_}", 1, m, m, arange(0, m)[None], arange(0, m)[None],
           True, (8, 4, D_, 0.0)) for D_ in (16, 32)),
        ("width_24_16", 1, m, m, arange(0, m)[None], arange(0, m)[None],
         True, (8, 8, 24, 0.0, 16, 24 ** -0.5)),
        ("width_40_32_decode", slots, 1, max_len, (lengths - 1)[:, None],
         decode_kv, True, (8, 1, 40, 0.0, 32, 24 ** -0.5)),
        # the tensor-parallel target's calls (phase 4v) at gemma2-2b's
        # local heads, 4/2 on 2 ranks and 2/1 on 4: the prompt causal and
        # against its prefix, and the dense decode (bf16 only)
        *((f"tp{n}_{tag}", B_, Sq_, Skv_, qp_, kp_, causal_,
           (8 // n, 4 // n, 256, 50.0))
          for n in (2, 4) for tag, B_, Sq_, Skv_, qp_, kp_, causal_ in (
              ("prompt_self", 1, prompt_len, prompt_len,
               arange(m, prompt_len)[None], arange(m, prompt_len)[None],
               True),
              ("prompt_prefix", 1, prompt_len, m,
               arange(m, prompt_len)[None], arange(0, m)[None], False),
              ("decode", slots, 1, max_len, (lengths - 1)[:, None],
               decode_kv, True))),
    ]
    # shapes held in bf16 alone: the full-width models run bf16 (the
    # float32 kernel at (192, 128) is held at the MLA prompt's shape)
    BF16_ONLY = ("mistral", "probe_", "icae_", "smollm_", "stablelm_",
                 "jamba_", "mla_source", "mla_memory", "mla_decode",
                 "mla_fused", "qwen_", "whisper_", "tp")
    flash_rows = []
    t_phase = time.perf_counter()
    for name, B, Sq, Skv, q_pos, kv_pos, causal, heads in attn_cases:
        t_row = time.perf_counter()
        Hq, Hkv, D, cap = heads[:4]
        Dv, scale = heads[4:] if len(heads) > 4 else (D, None)
        nsplit = fa._splits(B, Sq, Skv, Hq, Hkv, torch.cuda.current_device())
        tile = fa.tile_dims(torch.bfloat16, D, Dv)  # padded widths' kernel
        dispatched = fa.variant_for(torch.bfloat16, tile[0], Skv, nsplit,
                                    tile[1])
        # the bf16 kernels that take the shape (the wgmma one: not at
        # (576, 512))
        bf16_variants = (("wgmma", "mma_sync")
                         if fa.wgmma_takes(torch.bfloat16, tile[0], Skv,
                                           tile[1])
                         else ("mma_sync",))
        row = {"shape": name, "q": [B, Sq, Hq, D], "kv": [B, Skv, Hkv, D],
               "v_width": Dv, "causal": causal, "softcap": cap,
               "variant": dispatched, "nsplit": nsplit, "tile": list(tile)}
        dtypes = ((torch.bfloat16,) if name.startswith(BF16_ONLY)
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            q = rand(B, Sq, Hq, D, dtype=dtype)
            k = rand(B, Skv, Hkv, D, dtype=dtype)
            v = rand(B, Skv, Hkv, Dv, dtype=dtype)
            kw = dict(q_pos=q_pos.contiguous(), kv_pos=kv_pos, causal=causal,
                      softcap=cap, scale=scale, return_lse=True)
            ref, ref_lse = plain_attention(q, k, v, **kw)
            live = ref_lse > plain.NEG_INF / 2
            lse_tol = 1e-4 * max(1.0, float(ref_lse[live].abs().max())) \
                if bool(live.any()) else 0.0
            dead = ~live  # rows that see no key: out 0, lse -1e30
            # every bf16 shape goes through both bf16 kernels (the wgmma
            # one takes all of them when forced), each held to the plain
            # version; float32 through its one kernel
            variants = ((None,) if dtype is torch.float32
                        else bf16_variants)
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
                # the kernels' entries read the worse of the variants
                for key in ("max_abs_err", "scaled_err", "lse_err"):
                    row[f"{key}_{dn}"] = max(row[f"{key}_{dn}_{var}"]
                                             for var in bf16_variants)
            if dtype is torch.bfloat16 and name != "masked_rows":
                row["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
                for var in bf16_variants:
                    row[f"ms_{var}"] = cuda_ms(lambda: fa.flash_attention(
                        q, k, v, variant=var, **kw))
                    # the kernels' own time (a split call: both kernels)
                    row[f"device_ms_{var}"] = device_ms(
                        lambda: fa.flash_attention(q, k, v, variant=var, **kw))
                row["plain_ms"] = cuda_ms(
                    lambda: plain_attention(q, k, v, **kw), reps=3)
                mask = kv_pos[:, None, :] >= 0
                if causal:
                    mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
                else:
                    mask = mask.expand(B, Sq, Skv)
                pairs = int(mask.sum())
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                # SDPA takes Dv != D (its memory-efficient or math backend)
                # and the explicit scale
                if name.endswith(("source_prefill", "memory_self",
                                  "prompt_self", "_compressor", "_target")) \
                        or (causal and Sq == Skv and name.startswith("width")):
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        qt, kt, vt, is_causal=True, enable_gqa=True,
                        scale=scale)
                elif bool(mask.all()):  # every pair visible: no mask
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        qt, kt, vt, enable_gqa=True, scale=scale)
                else:
                    am = mask[:, None]
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                        qt, kt, vt, attn_mask=am, enable_gqa=True,
                        scale=scale)
                row["library_ms"] = cuda_ms(sdpa)
                flops = 2 * (D + Dv) * Hq * pairs
                # q read and out written once, the K/V rows some query
                # sees read once (decode skips the cache's unwritten tail),
                # positions read and lse written
                seen = int(mask.any(dim=1).sum())
                nbytes = (B * Sq * Hq * (D + Dv) * 2
                          + seen * Hkv * (D + Dv) * 2
                          + 4 * (q_pos.numel() + kv_pos.numel() + B * Sq * Hq))
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                row["device_ms"] = row[f"device_ms_{dispatched}"]
                if "wgmma" in bf16_variants:
                    times = (f"wgmma {row['ms_wgmma']:.4f}, mma.sync "
                             f"{row['ms_mma_sync']:.4f}; device wgmma "
                             f"{row['device_ms_wgmma']:.4f}, mma.sync "
                             f"{row['device_ms_mma_sync']:.4f}")
                else:  # no wgmma variant at (576, 512): the ms keys name it
                    row["ms_wgmma"] = row["device_ms_wgmma"] = None
                    times = (f"Dv {Dv}, mma.sync only; device "
                             f"{row['device_ms_mma_sync']:.4f}")
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms "
                    f"({dispatched}, {nsplit} split, tile {tile}; {times}), "
                    f"plain "
                    f"{row['plain_ms']:.4f} ms, sdpa "
                    f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                    f" ms ({row['bound_by']})")
            del q, k, v, ref, ref_lse
        torch.cuda.empty_cache()
        row["row_s"] = time.perf_counter() - t_row
        flash_rows.append(row)
    mla_s = sum(r["row_s"] for r in flash_rows if r["shape"].startswith(
        ("mla_source", "mla_memory", "mla_prompt", "probe_mla")))
    log(f"flash kernel phase (3a): {time.perf_counter() - t_phase:.1f}s, "
        f"the (192, 128) rows {mla_s:.1f}s")

    mx_rows = []
    for name, B, Mx, Tx, D in (("memory_xattn", 1, m, T, 2304),
                               ("granite_memory_xattn", 1, m, T, 1536),
                               # whisper-medium's D = 1024 (qwen2-vl-2b's
                               # 1536 is granite's shape above)
                               ("whisper_memory_xattn", 1, m, T, 1024),
                               ("mistral_memory_xattn", 1, 768, 2 * T, 4096),
                               # smollm-360m's D = 960 (15 slabs of 64: a
                               # last 192-column output tile) and
                               # stablelm-1.6b's 2048
                               ("smollm_memory_xattn", 1, m, T, 960),
                               ("stablelm_memory_xattn", 1, m, T, 2048),
                               # m = 1024 at jamba-1.5-large-398b's and
                               # deepseek-v2-236b's widths
                               ("jamba_memory_xattn", 1, mla_m, T, 8192),
                               ("deepseek_memory_xattn", 1, mla_m, T,
                                5120)):
        picked = mx.variant_for(torch.bfloat16, B, Mx, Tx, D, True)
        row = {"shape": name, "q": [B, Mx, D], "kv": [B, Tx, D],
               "variant": picked,
               "nsplit": mx.num_splits(B, Mx, Tx, D)}
        dtypes = ((torch.bfloat16,)
                  if name.startswith(BF16_ONLY + ("deepseek_",))
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

    def paged_inputs(B, S, Hq, Hkv, Dh, bs, lengths, share, dtype, table,
                     Dv=None):
        """Pools of shuffled blocks; slot b + 2 shares slot b's first
        ``share`` table entries (a task prefix seated in two slots);
        entries past a slot's length name block 0.  The tables hold
        ``table`` positions (an engine's max_len); the value pool is
        ``Dv`` wide (default ``Dh``)."""
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
                rand(N, bs, Hkv, Dv or Dh, dtype=dtype), tables,
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
        # smollm-360m (15 query heads on 5 KV heads of 64: group 3) and
        # stablelm-1.6b (MHA, 32 heads of 64)
        ("smollm_decode", slots, 1, 15, 5, 64, 16, main_lens, pm, 0.0,
         max_len),
        ("stablelm_decode", slots, 1, 32, 32, 64, 16, main_lens, pm, 0.0,
         max_len),
        # an engine with max_len 4096 and young slots: splits follow the
        # slots' lengths, not the table's width
        ("long_table", slots, 1, 8, 4, 256, 16, main_lens, pm, 50.0, 4096),
        # deepseek-v2-236b's absorbed decode (bf16 only: no float32 kernel
        # at (576, 512)): 128 query heads on one latent head, a 1024-row
        # prefix shared by two slots, one lane and the fused W = 4
        *((f"mla_decode{'' if W_ == 1 else f'_w{W_}'}", slots, W_, 128, 1,
           576, 16, [n + W_ for n in mla_lengths.tolist()], mla_m // 16, 0.0,
           mla_max_len, 512, mla_scale) for W_ in (1, 4)),
        # jamba-1.5-large-398b's attention layer behind its 1024-row prefix
        ("jamba_decode", slots, 1, 64, 8, 128, 16, mla_lengths.tolist(),
         mla_m // 16, 0.0, mla_max_len),
        # qwen2-vl-2b (12 query heads on 2 KV heads of 128: group 6, one
        # row group at S = 1, three at S = 3) and whisper-medium's decoder
        # self-attention (16 x 64)
        ("qwen_decode", slots, 1, 12, 2, 128, 16, main_lens, pm, 0.0,
         max_len),
        ("qwen_decode_s3", slots, 3, 12, 2, 128, 16, main_lens, pm, 0.0,
         max_len),
        ("whisper_decode", slots, 1, 16, 16, 64, 16, main_lens, pm, 0.0,
         max_len),
        # widths run at a wider tile with the loads past them skipped (no
        # pool copied): 16 and 32 (smoke configs, the bench target), MLA
        # smoke's absorbed (40, 32) on one latent head
        *((f"width_{D_}", slots, 1, 8, 4, D_, 16, main_lens, pm, 0.0,
           max_len) for D_ in (16, 32)),
        ("width_40_32", slots, 1, 8, 1, 40, 16, main_lens, pm, 0.0, max_len,
         32, 24 ** -0.5),
        # the tensor-parallel target's paged decode (phase 4v) at
        # gemma2-2b's local heads: 4/2 on 2 ranks, 2/1 on 4
        *((f"tp{n}_decode", slots, 1, 8 // n, 4 // n, 256, 16, main_lens, pm,
           50.0, max_len) for n in (2, 4)),
    ]
    paged_rows = []
    for name, B, S, hq, hkv, Dh, bs, lens, share, cap, table, *extra \
            in paged_cases:
        Dv, scale = extra if extra else (Dh, None)
        row = {"shape": name, "q": [B, S, hq, Dh], "v_width": Dv,
               "block_size": bs, "lengths": lens, "shared_blocks": share,
               "softcap": cap, "table": table,
               "tile": list(pa.tile_dims(torch.bfloat16, Dh, Dv))}
        for dtype in ((torch.bfloat16,) if Dh == 576
                      else (torch.float32, torch.bfloat16)):
            dn = str(dtype).split(".")[1]
            inputs = paged_inputs(B, S, hq, hkv, Dh, bs, lens, share, dtype,
                                  table, Dv)
            q, kp, vp, tables, lengths_t = inputs
            kw = dict(block_tables=tables, lengths=lengths_t, softcap=cap,
                      scale=scale)
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
                flops = 2 * (Dh + Dv) * hq * pairs
                nbytes = (len(visible) * hkv * (Dh + Dv) * 2
                          + B * S * hq * (Dh + Dv) * 2
                          + 4 * (tables.numel() + B))
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                row["distinct_rows"] = len(visible)
                row["distinct_blocks"] = len({blk for blk, _ in visible})
                # rotated input sets whose K/V rows read add up past the
                # 50 MB L2, so that no call finds its rows there
                sets = -(-60_000_000 // nbytes)
                bufs = [inputs] + [paged_inputs(B, S, hq, hkv, Dh, bs, lens,
                                                share, dtype, table, Dv)
                                   for _ in range(sets - 1)]
                row["device_ms"] = device_ms(
                    lambda q_, k_, v_, t_, l_: pa.paged_flash_decode(
                        q_, k_, v_, block_tables=t_, lengths=l_, softcap=cap,
                        scale=scale),
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
    def gmm_by_expert(x, w):
        """``plain.gmm_ref`` (float32 products, cast to x's type) one
        expert at a time: at jamba's expert width the whole stack in
        float32 would take 12.9 GB."""
        return torch.stack([(x[e].float() @ w[e].float()).to(x.dtype)
                            for e in range(x.shape[0])])

    # jamba-1.5-large-398b (16 experts of 8192 <-> 24576: 3.2e9 elements a
    # weight stack, past 2^31) and deepseek-v2-236b (160 experts of 5120
    # <-> 1536): the source prefill's C and decode's C = 8, bf16 only
    for tag, E_x, C_src, dm, ff in (("jamba", 16, 480, 8192, 24576),
                                    ("deepseek", 160, 144, 5120, 1536)):
        for C in (C_src, 8):
            for D, Fd in ((dm, ff), (ff, dm)):
                name = f"{tag}_C{C}_{D}to{Fd}"
                dispatched = gm.variant_for(torch.bfloat16, C, D, Fd, True)
                row = {"shape": name, "x": [E_x, C, D], "w": [E_x, D, Fd],
                       "variant": dispatched}
                dn = "bfloat16"
                x = rand(E_x, C, D, dtype=torch.bfloat16)
                w = rand(E_x, D, Fd, dtype=torch.bfloat16, scale=D ** -0.5)
                ref = gmm_by_expert(x, w)
                variants = [v for v in gmm_variants
                            if gm.takes(v, torch.bfloat16, E_x, C, D, Fd,
                                        True)]
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
                flops = 2 * E_x * C * D * Fd
                nbytes = 2 * (x.numel() + w.numel() + E_x * C * Fd)
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                # two weight sets (past the 50 MB L2 either way)
                bufs = [(x, w), (rand(E_x, C, D, dtype=torch.bfloat16),
                                 rand(E_x, D, Fd, dtype=torch.bfloat16,
                                      scale=D ** -0.5))]
                row["ms"] = cuda_ms(lambda: gm.gmm(x, w), reps=5)
                for var in variants:
                    row[f"device_ms_{var}"] = device_ms(
                        lambda a, b: gm.gmm(a, b, variant=var), 6, bufs)
                    row[f"tflops_{var}"] = flops / row[f"device_ms_{var}"] / 1e9
                row["device_ms"] = row[f"device_ms_{dispatched}"]
                row["plain_ms"] = cuda_ms(lambda: gmm_by_expert(x, w),
                                          reps=2, warmup=1)
                row["library_ms"] = cuda_ms(lambda: torch.bmm(x, w), reps=5)
                row["library_device_ms"] = device_ms(torch.bmm, 6, bufs)
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms ({dispatched});"
                    " device (2 buffer sets) "
                    + ", ".join(f"{v} {row[f'device_ms_{v}']:.4f} "
                                f"({row[f'tflops_{v}']:.0f} TFLOP/s)"
                                for v in variants)
                    + f"; bmm {row['library_device_ms']:.4f}; plain (by "
                    f"expert) {row['plain_ms']:.4f} ms; bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
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
        # jamba-1.5-large-398b's Mamba2 layer (256 heads of 64, G 1, N 128):
        # the 3072-token source, and the target's 12-token prompt seeded by
        # the handed-off state (bf16 only)
        ("jamba_source", 1, T, 256, 64, 1, 128, False, False),
        ("jamba_prompt_state", 1, prompt_len, 256, 64, 1, 128, True, False),
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

        for dtype in ((torch.bfloat16,) if name.startswith(("probe", "jamba"))
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
        # the ICAE step: each stack's causal self-attention, no lse
        # cotangent (gemma2-2b's compressor and target, mistral-7b's
        # compressor)
        *((name_, 2, S_, S_, arange(0, S_)[None].expand(2, S_),
           arange(0, S_)[None].expand(2, S_), True, heads_, False,
           ("bfloat16",))
          for name_, S_, heads_ in (
              ("icae_compressor_bwd", icae_gemma[0], gemma_heads),
              ("icae_target_bwd", icae_gemma[1], gemma_heads),
              ("mistral_icae_compressor_bwd", icae_mistral, mistral_heads))),
        # deepseek-v2-236b's Phase 1 at (192, 128), 128 heads, scale
        # 192^-0.5 (bf16 through the wgmma kernel, float32 through the CUDA
        # cores): the Memory-LLM's 2 x 1024 causal rows, the 512-token
        # prompt at offset 1024 and against the 1024-row prefix (both with
        # an lse cotangent), and the 3072-token source (Phase 2)
        ("mla_memory_self_bwd", 2, mla_m, mla_m,
         arange(0, mla_m)[None].expand(2, mla_m),
         arange(0, mla_m)[None].expand(2, mla_m), True, mla_heads, False,
         ("bfloat16",)),
        ("mla_prompt_self_bwd", 2, m, m, arange(mla_m, m)[None].expand(2, m),
         arange(mla_m, m)[None].expand(2, m), True, mla_heads, True,
         ("float32", "bfloat16")),
        ("mla_prompt_prefix_bwd", 2, m, mla_m,
         arange(mla_m, m)[None].expand(2, m),
         arange(0, mla_m)[None].expand(2, mla_m), False, mla_heads, True,
         ("float32", "bfloat16")),
        ("mla_source_bwd", 1, T, T, arange(0, T)[None], arange(0, T)[None],
         True, mla_heads, False, ("bfloat16",)),
        # whisper-medium's Phase 1 (4t): the Memory-LLM's cross-attention
        # over 1500 frames (not causal, every position 0; the 512-row
        # prompt's is the same call), then whisper's and qwen2-vl-2b's
        # (4u) self-attention calls as gemma2-2b's above
        ("whisper_memory_cross_bwd", 2, m, frames,
         arange(0, m)[None].expand(2, m) * 0,
         arange(0, frames)[None].expand(2, frames) * 0, False,
         whisper_heads, False, ("bfloat16",)),
        *((f"{arch_}_{name_}", 2, m, m, arange(q0, m)[None].expand(2, m),
           arange(k0, m)[None].expand(2, m), causal_, heads_, dlse_,
           ("bfloat16",))
          for arch_, heads_ in (("whisper", whisper_heads),
                                ("qwen", qwen_heads))
          for name_, q0, k0, causal_, dlse_ in (
              ("memory_self_bwd", 0, 0, True, False),
              ("prompt_self_bwd", m, m, True, True),
              ("prompt_prefix_bwd", m, 0, False, True))),
        # widths no kernel is built for, zero-padded to fa.tile_dims' tile
        ("width_16_bwd", 2, m, m, arange(0, m)[None].expand(2, m),
         arange(0, m)[None].expand(2, m), True, (8, 4, 16, 0.0), True,
         ("float32", "bfloat16")),
        ("width_24_16_bwd", 2, m, m, arange(0, m)[None].expand(2, m),
         arange(0, m)[None].expand(2, m), True, (8, 8, 24, 0.0, 16,
                                                 24 ** -0.5), True,
         ("float32", "bfloat16")),
    ]
    flash_bwd_rows = []
    for (name, B, Sq, Skv, q_pos, kv_pos, causal, heads, with_dlse,
         dtypes) in bwd_cases:
        t_row = time.perf_counter()
        Hq, Hkv, D, cap = heads[:4]
        Dv, scale = heads[4:] if len(heads) > 4 else (D, None)
        q_pos, kv_pos = q_pos.contiguous(), kv_pos.contiguous()
        row = {"shape": name, "q": [B, Sq, Hq, D], "kv": [B, Skv, Hkv, D],
               "v_width": Dv, "causal": causal, "softcap": cap,
               "dlse": with_dlse}
        for dn in dtypes:
            dtype = getattr(torch, dn)
            q = rand(B, Sq, Hq, D, dtype=dtype)
            dout = rand(B, Sq, Hq, Dv, dtype=dtype)
            k = rand(B, Skv, Hkv, D, dtype=dtype)
            v = rand(B, Skv, Hkv, Dv, dtype=dtype)
            kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, softcap=cap,
                      scale=scale)
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            dlse = (rand(B, Sq, Hq, dtype=torch.float32) if with_dlse
                    else None)
            want = plain_attention_bwd(q, k, v, out, lse, dout, dlse, **kw)
            # queries that see no key and keys that no query sees
            seen = kv_pos[:, None, :] >= 0
            if causal:
                seen = seen & (kv_pos[:, None, :] <= q_pos[:, :, None])
            seen = seen.expand(B, Sq, Skv)
            zero_rows = {"dq": ~seen.any(dim=2), "dk": ~seen.any(dim=1),
                         "dv": ~seen.any(dim=1)}
            # bf16: both kernels, each forced (at (192, 128) the wgmma one
            # alone); the wgmma one also against its own arithmetic
            # (plain.attention_bwd_tiled) in bf16 steps, over the rows
            # grad_err holds by their own scale
            tile = fa.tile_dims(dtype, D, Dv)  # the widths the kernel runs
            variants = ((None,) if dn == "float32"
                        else ("wgmma", "mma_sync") if tile[1] == tile[0]
                        else ("wgmma",))
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
                # the tiled restatement keeps whole float32 matrices: not
                # at the ICAE shapes (12 GB a matrix at mistral-7b's)
                if vn == "wgmma" and tile == (D, Dv) and not name.startswith(
                        ("icae_", "mistral_icae")):
                    tiled = plain.attention_bwd_tiled(
                        *(x.float() for x in (q, k, v, out)), lse,
                        dout.float(), dlse, split_at=fa.bwd_split_at(
                            B, Sq, Skv, Hq, Hkv, D, causal, sms, dv=Dv),
                        **kw)
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
                row["variant"] = fa.bwd_variant_for(
                    dtype, tile[0], Sq * Hq // Hkv, Skv, tile[1])
                row["tile"] = list(tile)
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
                row["plain_ms"] = cuda_ms(lambda: plain_attention_bwd(
                    q, k, v, out, lse, dout, dlse, **kw), reps=3)
                if causal and Sq == Skv:
                    sdpa_kw = dict(is_causal=True, enable_gqa=True)
                else:
                    sdpa_kw = dict(enable_gqa=True)
                if scale is not None:
                    sdpa_kw["scale"] = scale
                (row["library_ms"], row["library_device_ms"],
                 row["library_backend"]) = library_bwd(
                    [tuple(x.transpose(1, 2) for x in st) for st in sets],
                    **sdpa_kw)
                del sets
                # five products (S, dQ, dK over D; dP, dV over Dv) against
                # the forward's two; q, k, v, out, dout read once, dq, dk,
                # dv written once
                flops = 2 * (3 * D + 2 * Dv) * Hq * pairs
                nbytes = 2 * (2 * q.numel() + 2 * dout.numel()
                              + 2 * k.numel() + 2 * v.numel()) + 4 * (
                    2 * lse.numel() + q_pos.numel() + kv_pos.numel())
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                log(f"  {name} bf16: kernel {row['ms']:.4f} ms (device "
                    f"{row['device_ms']:.4f}; {row['variant']}; " + "; ".join(
                        f"{vn} {row[f'ms_{vn}']:.4f} ms, device "
                        f"{row[f'device_ms_{vn}']:.4f}" for vn in variants)
                    + f"), plain "
                    f"{row['plain_ms']:.4f} ms, sdpa backward "
                    f"{row['library_ms']} ms (device "
                    f"{row['library_device_ms']}; "
                    f"{row['library_backend']}, no cap), bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            del q, k, v, dout, out, lse, dlse
        torch.cuda.empty_cache()
        row["row_s"] = time.perf_counter() - t_row
        flash_bwd_rows.append(row)
    del bwd_cases
    mla_s = sum(r["row_s"] for r in flash_bwd_rows
                if r["shape"].startswith("mla_"))
    log(f"flash backward rows: {time.perf_counter() - t_phase:.1f}s, the "
        f"(192, 128) rows {mla_s:.1f}s")

    mx_bwd_rows = []
    for name, B, Mx, Tx, D, dtypes in (
            ("memory_xattn_bwd", 2, m, T, 2304, ("float32", "bfloat16")),
            ("granite_memory_xattn_bwd", 1, m, T, 1536,
             ("float32", "bfloat16")),
            ("mistral_memory_xattn_bwd", 1, 768, 2 * T, 4096,
             ("bfloat16",)),
            # the Phase-1 steps of 4t and 4u
            ("whisper_memory_xattn_bwd", 2, m, T, 1024, ("bfloat16",)),
            ("qwen_memory_xattn_bwd", 2, m, T, 1536, ("bfloat16",))):
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

    # ---- 3g. the gmm and ssd backward kernels ---------------------------
    # Each against its plain backward (explicit formulas) on the same
    # inputs, by 3f's rule: float32 max abs error at most 1e-4 of max(1,
    # the largest gradient), bf16 plain.grad_err at most 2e-2, per
    # gradient; float32 ssd inputs widened to float64 for the plain version
    # (the kernel sums them in float64).  A second call gives the same
    # bits.  Under no_grad a call through the wrapper is the forward alone.
    t_phase = time.perf_counter()

    GMM_BWD_VARIANTS = ("wgmma", "mma_sync")
    SSD_BWD_VARIANTS = ("chunked", "sequential")

    def bwd_check(kernel, name, dn, names, got, want, again):
        errs = {}
        for gname, g, w, a in zip(names, got, want, again):
            if w is None:
                continue
            e, ge = err(g, w), plain.grad_err(g, w)
            scale_ = max(1.0, float(w.float().abs().max()))
            ok = (e <= 1e-4 * scale_) if dn == "float32" \
                else (ge <= REL_TOL["bfloat16"])
            same = torch.equal(g, a)
            finite = bool(torch.isfinite(g.float()).all())
            errs[gname] = (e, ge)
            if not (ok and same and finite):
                raise AssertionError(
                    f"{kernel} {name} {dn} {gname} disagrees with its plain "
                    f"backward: max abs err {e:.3e} (largest |grad| "
                    f"{scale_:.3e}), grad err {ge:.3e}, finite {finite}, "
                    f"bit-identical on a second call {same}")
        log(f"{kernel} {name} {dn}: " + ", ".join(
            f"{k} max_abs_err {e:.3e} grad_err {ge:.3e}"
            for k, (e, ge) in errs.items()) + "; a second call bit-identical")
        return (max(v[0] for v in errs.values()),
                max(v[1] for v in errs.values()))

    gmm_bwd_rows = []
    for name, E_, C_, D_, F_ in (
            # the Memory-LLM's and the prompt's products (Phase 1: dX) and
            # the 3072-token source's (Phase 2), both orientations
            ("memory_bwd_1536_512", 40, 256, 1536, 512),
            ("memory_bwd_512_1536", 40, 256, 512, 1536),
            ("source_bwd_1536_512", 40, 1536, 1536, 512),
            ("source_bwd_512_1536", 40, 1536, 512, 1536)):
        row = {"shape": name, "x": [E_, C_, D_], "w": [E_, D_, F_],
               "variant": gm.bwd_variant_for(torch.bfloat16, C_, D_, F_,
                                             True)}
        for dn in ("float32", "bfloat16"):
            dtype = getattr(torch, dn)
            x = rand(E_, C_, D_, dtype=dtype)
            w = rand(E_, D_, F_, dtype=dtype, scale=D_ ** -0.5)
            dy = rand(E_, C_, F_, dtype=dtype)
            want = plain.gmm_bwd_ref(x, w, dy)
            # every kernel of the dtype, each forced, against the plain
            # backward; float32 has one
            errs = []
            for var in ((None,) if dn == "float32" else GMM_BWD_VARIANTS):
                kw = {} if var is None else {"variant": var}
                got = gm.gmm_bwd(x, w, dy, **kw)
                again = gm.gmm_bwd(x, w, dy, **kw)
                torch.cuda.synchronize()
                errs.append(bwd_check("gmm_bwd", f"{name} {var or dn}", dn,
                                      ("dx", "dw"), got, want, again))
                del got, again
            row[f"max_abs_err_{dn}"] = max(e[0] for e in errs)
            row[f"grad_err_{dn}"] = max(e[1] for e in errs)
            del want
            if dn == "bfloat16":
                # three sets of w, dy and x (63 MB of weights each), so no
                # replayed call reads its operands from the 50 MB L2
                bufs = [(x, w, dy)] + [
                    (rand(E_, C_, D_, dtype=dtype),
                     rand(E_, D_, F_, dtype=dtype, scale=D_ ** -0.5),
                     rand(E_, C_, F_, dtype=dtype)) for _ in range(2)]
                for part, kw, lib in (
                        ("dx", dict(need_dw=False),
                         lambda x_, w_, d_: torch.bmm(d_, w_.transpose(1, 2))),
                        ("dw", dict(need_dx=False),
                         lambda x_, w_, d_: torch.bmm(x_.transpose(1, 2), d_)),
                        ("both", {}, lambda x_, w_, d_: (
                            torch.bmm(d_, w_.transpose(1, 2)),
                            torch.bmm(x_.transpose(1, 2), d_)))):
                    sfx = "" if part == "dx" else f"_{part}"
                    need = dict(need_dx=part != "dw", need_dw=part != "dx")
                    for var in GMM_BWD_VARIANTS:
                        row[f"ms{sfx}_{var}"] = cuda_ms(
                            lambda: gm.gmm_bwd(x, w, dy, variant=var, **kw))
                        row[f"device_ms{sfx}_{var}"] = device_ms(
                            lambda x_, w_, d_: gm.gmm_bwd(
                                x_, w_, d_, variant=var, **kw), 21, bufs)
                    row[f"ms{sfx}"] = row[f"ms{sfx}_{row['variant']}"]
                    row[f"device_ms{sfx}"] = \
                        row[f"device_ms{sfx}_{row['variant']}"]
                    row[f"plain_ms{sfx}"] = cuda_ms(
                        lambda: plain.gmm_bwd_ref(x, w, dy, **need), reps=3)
                    row[f"library_ms{sfx}"] = cuda_ms(lambda: lib(x, w, dy))
                    row[f"library_device_ms{sfx}"] = device_ms(lib, 21, bufs)
                    n_prod = 2 if part == "both" else 1
                    flops = 2 * E_ * C_ * D_ * F_ * n_prod
                    elems = {"dx": E_ * C_ * F_ + E_ * D_ * F_
                             + E_ * C_ * D_,
                             "dw": E_ * C_ * D_ + E_ * C_ * F_ + E_ * D_ * F_,
                             "both": 2 * E_ * C_ * D_ + E_ * C_ * F_
                             + 2 * E_ * D_ * F_}[part]
                    row[f"bound_ms{sfx}"], row[f"bound_by{sfx}"] = bound(
                        flops, 2 * elems)
                row["library_backend"] = "torch.bmm"
                for part, sfx in (("dX", ""), ("dW", "_dw"),
                                  ("both", "_both")):
                    ratio = row[f"device_ms{sfx}_wgmma"] \
                        / row[f"library_device_ms{sfx}"]
                    log(f"  {name} bf16 {part}: device ms wgmma "
                        f"{row[f'device_ms{sfx}_wgmma']:.4f} (events "
                        f"{row[f'ms{sfx}_wgmma']:.4f}), mma.sync "
                        f"{row[f'device_ms{sfx}_mma_sync']:.4f} (events "
                        f"{row[f'ms{sfx}_mma_sync']:.4f}), torch.bmm "
                        f"{row[f'library_device_ms{sfx}']:.4f} (events "
                        f"{row[f'library_ms{sfx}']:.4f}), wgmma / torch.bmm "
                        f"{ratio:.3f}; plain {row[f'plain_ms{sfx}']:.4f} ms;"
                        " bound "
                        f"{row[f'bound_ms{sfx}']:.4f} ms "
                        f"({row[f'bound_by{sfx}']})")
                del bufs
            del x, w, dy
        torch.cuda.empty_cache()
        gmm_bwd_rows.append(row)
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()

    ssd_bwd_rows = []
    ssd_names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    for name, shape_, with_dhf in (
            # mamba2-370m's training call: no initial state, the final
            # state unused (no cotangent)
            ("train", (2, T, 32, 64, 1, 128, False, False), False),
            ("h0_dhf_1000_g2", (1, 1000, 32, 64, 2, 128, True, False), True),
            ("decay25_1000_g2", (1, 1000, 32, 64, 2, 128, True, True),
             True)):
        Bs, S_, H_, P_, G_, N_, init_, big_ = shape_
        row = {"shape": name, "x": [Bs, S_, H_, P_], "G": G_, "N": N_,
               "init_state": init_, "dhf": with_dhf,
               "decay": "dt|A| = 25" if big_ else "seeded",
               "variant": ss.bwd_variant_for(torch.bfloat16, S_, P_, N_,
                                             True)}
        for dn in ("float32", "bfloat16"):
            dtype = getattr(torch, dn)
            ins = ssd_inputs(Bs, S_, H_, P_, G_, N_, dtype, init_, big_)
            dy = rand(Bs, S_, H_, P_, dtype=dtype)
            dhf = rand(Bs, H_, P_, N_, dtype=torch.float32) \
                if with_dhf else None
            wide = [None if a is None else
                    a.double() if dn == "float32" else a
                    for a in (*ins, dy, dhf)]
            want = plain.ssd_bwd_ref(*wide)
            del wide
            errs = []
            for var in (("sequential",) if dn == "float32"
                        else SSD_BWD_VARIANTS):
                got = ss.ssd_bwd(*ins, dy, dhf, variant=var)
                again = ss.ssd_bwd(*ins, dy, dhf, variant=var)
                torch.cuda.synchronize()
                errs.append(bwd_check("ssd_bwd", f"{name} {var}", dn,
                                      ssd_names, got, want, again))
                del got, again
            row[f"max_abs_err_{dn}"] = max(e[0] for e in errs)
            row[f"grad_err_{dn}"] = max(e[1] for e in errs)
            del want
            if dn == "bfloat16" and name == "train":
                bufs = [(*ins, dy, dhf)]
                for _ in range(2):
                    more = ssd_inputs(Bs, S_, H_, P_, G_, N_, dtype, init_,
                                      big_)
                    bufs.append((*more, rand(Bs, S_, H_, P_, dtype=dtype),
                                 dhf))
                for var in SSD_BWD_VARIANTS:
                    row[f"ms_{var}"] = cuda_ms(
                        lambda: ss.ssd_bwd(*ins, dy, dhf, variant=var))
                    row[f"device_ms_{var}"] = device_ms(
                        lambda *a: ss.ssd_bwd(*a, variant=var), 21, bufs)
                    row[f"workspace_bytes_{var}"] = ss.bwd_workspace_bytes(
                        Bs, S_, H_, P_, N_, dtype, G_, var)
                row["ms"] = row[f"ms_{row['variant']}"]
                row["device_ms"] = row[f"device_ms_{row['variant']}"]
                row["workspace_bytes"] = \
                    row[f"workspace_bytes_{row['variant']}"]
                row["plain_ms"] = cuda_ms(
                    lambda: plain.ssd_bwd_ref(*ins, dy, dhf), reps=1,
                    warmup=1)
                row["library_ms"] = row["library_device_ms"] = None
                row["library_backend"] = None
                # the per-token form's least work: 12 P N operations a token
                # and head (the state's recompute, dh, dC, dh B, dhᵀ x and
                # <dh, h>); bytes: x, dy, dx, B, C, dB, dC, dt and ddt once
                flops = 12 * Bs * S_ * H_ * P_ * N_
                nbytes = (3 * Bs * S_ * H_ * P_ * 2 + 4 * Bs * S_ * G_ * N_ * 2
                          + 2 * Bs * S_ * H_ * 4 + 2 * H_ * 4)
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                row["flops"], row["bytes"] = flops, nbytes
                log(f"  {name} bf16: device ms chunked "
                    f"{row['device_ms_chunked']:.4f} (events "
                    f"{row['ms_chunked']:.4f}), sequential "
                    f"{row['device_ms_sequential']:.4f} (events "
                    f"{row['ms_sequential']:.4f}); plain "
                    f"{row['plain_ms']:.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
                    f"workspace chunked {row['workspace_bytes_chunked']} "
                    f"bytes (sequential {row['workspace_bytes_sequential']})")
                del bufs
            del ins, dy, dhf
            torch.cuda.empty_cache()
        ssd_bwd_rows.append(row)

    # under no_grad, or with no input needing a gradient, the wrappers'
    # CUDA call is the forward launch alone
    gx = rand(40, 8, 1536, dtype=torch.bfloat16)
    gw = rand(40, 1536, 512, dtype=torch.bfloat16).requires_grad_(True)
    sin = ssd_inputs(1, 300, 32, 64, 1, 128, torch.bfloat16, True, False)
    sin[0].requires_grad_(True)
    before = (gm.launches, gm.bwd_launches, ss.launches, ss.bwd_launches)
    with torch.no_grad():
        g_out = gm.gmm(gx, gw)
        s_out, _ = ss.ssd(*sin[:5], init_state=sin[5])
    forward_only = (g_out.grad_fn is None and s_out.grad_fn is None
                    and (gm.launches, gm.bwd_launches, ss.launches,
                         ss.bwd_launches) == (before[0] + 1, before[1],
                                              before[2] + 1, before[3]))
    log(f"gmm and ssd under no_grad: the forward launch alone {forward_only}")
    if not forward_only:
        raise AssertionError("a no_grad call did not stay the forward launch")
    del gx, gw, sin, g_out, s_out
    torch.cuda.empty_cache()
    report["bwd_3g_s"] = time.perf_counter() - t_phase
    log(f"gmm / ssd backward kernel phase (3g): {report['bwd_3g_s']:.1f}s")

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
        gm.bwd_launches = gm.bwd_dx_launches = gm.bwd_dw_launches = 0
        gm.bwd_wgmma_launches = ss.bwd_launches = ss.bwd_chunked_launches = 0

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
        c["gmm_bwd"] = gm.bwd_launches
        c["gmm_bwd_dx"] = gm.bwd_dx_launches
        c["gmm_bwd_dw"] = gm.bwd_dw_launches
        c["gmm_bwd_wgmma"] = gm.bwd_wgmma_launches
        c["ssd_bwd"] = ss.bwd_launches
        c["ssd_bwd_chunked"] = ss.bwd_chunked_launches
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

    def cut_depth(cfg, depth):
        """A uniform layout's config at ``depth`` layers (full width)."""
        if depth is None:
            return cfg
        return cfg.replace(name=f"{cfg.name}-depth{depth}",
                           layout=LayerLayout(period=cfg.layout.period,
                                              repeats=depth))

    def main_path(arch, need, geom, then=None, profile=True, depth=None):
        """Compress -> dense serve, then a paged serve, of ``arch`` at full
        width and depth; ``need`` names the kernels every path must
        launch beside ``flash_attention``; ``geom`` is (m, T, the task
        sources, max_len).  ``then(cfg, target, compressor, prefixes,
        engine, pengine)`` runs further phases on the same models before
        the profiled runs (``profile``); what it returns lands under
        "then".  ``depth`` cuts a uniform layout to that many layers."""
        m, T, sources, max_len = geom
        cfg = cut_depth(get_config(arch), depth)
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
        out = {
            "task_compress_s": task_s, "compress_s": compress_s,
            "dense": dense, "paged": paged, "peak_bytes": peak_dense,
            "params": n_params, "launches_after_compress": after_compress,
            "launches": launches, "gmm_by_rows": gmm_by_rows, "then": after}
        if not profile:
            return out
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
        return dict(out, breakdown=breakdown)

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
        cross = cfg.layout.period[0].cross_attn
        cfg2 = cfg.replace(name=f"{arch}-depth2",
                           layout=LayerLayout.uniform(
                               LayerDesc("attn", mlp, cross_attn=cross), 2))
        if cfg.encoder is not None:  # the encoder cut to depth 2 as well
            cfg2 = cfg2.replace(encoder=dc_replace(cfg.encoder, num_layers=2))
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
        frames_errs = None
        if cfg.encoder is not None:
            # the frames path (4r a): the Source-LLM's encoder output
            # threaded to the Memory-LLM and to the target's prefill
            g_fr = torch.Generator(device=dev)
            g_fr.manual_seed(16)
            fr = (0.1 * torch.randn((1, cfg.encoder.num_frames, cfg.d_model),
                                    generator=g_fr, device=dev)).to(
                target2.dtype)

            def frames_pipeline():
                prefix, info = memcom.compress(compressor2, cfg2, src,
                                               encoder_frames=fr)
                kv = materialize_prefix(target2, cfg2, prefix)
                with torch.no_grad():
                    logits, _ = target2(tokens=prompt, prefix=kv,
                                        mask_offset=m,
                                        encoder_out=info["encoder_out"])
                return ([e["h"] for e in prefix], info["encoder_out"],
                        logits[0, -1])

            set_counts()
            om_k, enc_k, lg_k = frames_pipeline()
            torch.cuda.synchronize()
            fr_counts = counts()
            ops.set_default_impl("torch")
            try:
                om_p, enc_p, lg_p = frames_pipeline()
            finally:
                ops.set_default_impl(None)
            frames_errs = {
                "omega_rel_err": max(rel(a, b) for a, b in zip(om_k, om_p)),
                "encoder_out_rel_err": rel(enc_k, enc_p),
                "logits_rel_err": rel(lg_k, lg_p)}
            log(f"{tag} frames path, depth 2 (encoder depth 2), bf16: "
                f"{frames_errs} (tol {E2E_REL_TOL:g}); launches {fr_counts}")
            if not (max(frames_errs.values()) <= E2E_REL_TOL
                    and fr_counts["flash_attention"] > 0):
                raise AssertionError(f"{arch}: the frames path's kernel and "
                                     "plain runs disagree")
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
               "moe_rows_replayed": [flips, flips_paged],
               "frames": frames_errs}
        if mlp != "moe" and not cross:  # enc-dec refuses the fused step
            out["fused_steps"] = fused_steps_vs_plain(cfg2, target2, kv2, tag,
                                                      max_len)
        if mlp == "moe":
            out["reclaimed_lanes"] = reclaimed_lanes_twice(cfg2, target2,
                                                           kv2, tag)
        return out

    def fused_steps_vs_plain(cfg2, target2, kv2, tag, max_len):
        """Two requests on the task through a self-speculative fused engine
        (k = 3) on a virtual clock, dense and paged (blocks of 16): the
        first fused step carries 4 verify lanes (W = 4); the second
        request arrives while the first decodes and joins as one 16-token
        chunk (W = 16).  Each of those two steps is run again, forced to
        the plain versions, on the same inputs (its tokens, positions and
        a copy of the cache as the step found it), and their valid lanes'
        logits agree within the end-to-end bound.  (Two whole serves, one
        each way, would compare different inputs wherever a greedy draft
        lies on a near-tie that the two ways' roundings break apart.)"""
        j_rng = np.random.default_rng(26)
        join_toks = j_rng.integers(4, vocab.size, 16).astype(np.int32)
        out = {}
        for layout in ("dense", "paged"):
            eng = ServingEngine(
                cfg2, target2, slots=2, max_len=max_len, kv_layout=layout,
                block_size=16, fused_step=True, fused_chunk_tokens=16,
                spec_draft="self", spec_k=3, clock=VirtualClock())
            eng.add_prefix("task", kv2)
            steps, inner = [], []

            def hook(mod, args, kwargs, res):
                lv, toks = kwargs.get("lane_valid"), kwargs["tokens"]
                if inner or lv is None or toks.shape[1] == 1 or len(steps) == 2:
                    return  # the plain rerun, a draft, or past two steps
                v = lv.tolist()
                # the cache as the step found it: the step wrote only the
                # valid lanes' rows, at [cache_index, + lane_valid)
                cache = [{k_: t.clone() for k_, t in c.items()}
                         for c in kwargs["cache"]]
                inner.append(True)
                ops.set_default_impl("torch")
                try:
                    with torch.no_grad():
                        ref, _ = mod(*args, **dict(kwargs, cache=cache))
                finally:
                    ops.set_default_impl(None)
                    inner.pop()
                steps.append((toks.shape[1], v, *(torch.cat(
                    [x[b, :n].float() for b, n in enumerate(v)])
                    for x in (res[0], ref))))

            set_counts()
            h = target2.register_forward_hook(hook, with_kwargs=True)
            try:
                eng.serve([Request(tokens=prompts[2], max_new=8,
                                   prefix="task"),
                           Request(tokens=join_toks, max_new=2,
                                   prefix="task", arrival_s=0.0015)])
            finally:
                h.remove()
            launches = counts()
            shapes = [(w, v) for w, v, _, _ in steps]
            errs = [rel(k_, p_) for _, _, k_, p_ in steps]
            log(f"{tag} fused steps {layout} (W, valid lanes) {shapes}: "
                f"valid lanes' logits rel err {[f'{e:.3e}' for e in errs]} "
                f"(tol {E2E_REL_TOL:g}); launches {launches}")
            if not ([w for w, _ in shapes] == [4, 16]
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

    # ---- 4o. deepseek-v2-236b (MLA) and jamba-1.5-large-398b (hybrid) ---
    def family_cfg(arch):
        """The full-width config cut to depth 2: deepseek-v2-236b's dense-
        FFN MLA prefix layer and one MLA + MoE period layer; jamba-1.5-
        large-398b's Mamba2 + MoE layer (period index 1) and its attention
        + dense layer (index 4)."""
        cfg = get_config(arch)
        if arch == "deepseek-v2-236b":
            layout = LayerLayout(prefix=cfg.layout.prefix,
                                 period=cfg.layout.period, repeats=1)
        else:
            layout = LayerLayout(period=(cfg.layout.period[1],
                                         cfg.layout.period[4]), repeats=1)
        return cfg.replace(name=f"{arch}-depth2", layout=layout)

    def mla_online(cfg, target, compressor, offline, chunk=512):
        """Task 0 compiled online at depth 2: its O^i through the online
        compiler's chunking (``memcom.compress_chunked``, ``chunk``-token
        slices, each MLA layer attending to its cached latents as a prefix
        merged by lse: two (192, 128) flash calls a layer and slice) and
        the prefix ``PrefixCompiler`` installs (``step(chunk)`` until done),
        each against the offline compress (``offline``: its O^i and
        materialized latents): within 2e-2 of the largest magnitude."""
        from repro_torch.serving.compiler import PrefixCompiler

        tag = f"[{cfg.name} online]"
        t0 = time.perf_counter()
        src = torch.as_tensor(sources[0][None], device=dev)
        set_counts()
        omega = memcom.compress_chunked(compressor, cfg, src,
                                        chunk_size=chunk)[0]
        torch.cuda.synchronize()
        c = counts()
        errs = [rel(a["h"], b["h"]) for a, b in zip(omega, offline[0])]
        comp = PrefixCompiler(compressor, cfg, target)
        comp.submit("task0", sources[0])
        while comp.has_compile_work():
            comp.step(chunk)
        kv = comp.job("task0").materialized
        kv_errs = [max(rel(a[key], b[key]) for key in b)
                   for a, b in zip(kv, offline[1])]
        torch.cuda.synchronize()
        online_s = time.perf_counter() - t0
        log(f"{tag} O^i of a {chunk}-token chunked compile (prefill "
            f"continuation, lse merge) vs the offline compress: rel err per "
            f"layer {[f'{e:.3e}' for e in errs]}; the compiler's installed "
            f"latents (ckv, kr) {[f'{e:.3e}' for e in kv_errs]} (tol "
            f"{E2E_REL_TOL:g}); flash calls {c['flash_attention']} "
            f"({c['flash_attention_wgmma']} wgmma), {comp.stats['chunks']} "
            f"chunks; {online_s:.1f}s")
        if not (max(errs) <= E2E_REL_TOL and max(kv_errs) <= E2E_REL_TOL
                and c["flash_attention_wgmma"] > 0):
            raise AssertionError(f"{tag}: the online compile disagrees with "
                                 "the offline compress")
        return {"omega_rel_err": errs, "latent_rel_err": kv_errs,
                "launches": c, "chunks": comp.stats["chunks"],
                "online_s": online_s}

    def family_path(arch):
        """Compress two 3072-token tasks into m = 1024 memory slots, serve
        them dense (4 requests) and paged (12 requests over 4 slots, stops
        and refills), then hold the kernel path to the plain one on the
        same models: O^i (and the handed-off SSM states), the first-step
        logits behind the prefix and a paged engine's prefill and first
        decode step, the MoE layers replaying the kernel run's top-k.
        jamba's plain expert products go expert by expert (its whole
        expert stack in float32 would take 12.9 GB), and a request in a
        refilled slot must give a fresh engine's tokens exactly."""
        cfg = family_cfg(arch)
        tag = f"[{arch}]"
        hybrid = any(d.mixer == "mamba" for d in cfg.layout.descriptors())
        need = ("flash_attention", "memcom_xattn", "gmm") + (
            ("ssd",) if hybrid else ())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_phase = t0 = time.perf_counter()
        target = tfm.init_params(cfg, 0)
        compressor = memcom.init_memcom(cfg, target, 1)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p_.numel() for p_ in target.parameters()) + sum(
            p_.numel() for p_ in compressor.parameters())
        reckoned = 2 * n_params  # bf16: three stacks and memx
        weights_peak = torch.cuda.max_memory_allocated()
        log(f"{tag} depth 2 at full width: {n_params / 1e9:.3f} B parameters "
            f"over target, source, memory and memx ({reckoned} bytes "
            f"reckoned in bf16), {weights_peak} bytes allocated at peak, in "
            f"{init_s:.1f}s")
        mlen = mla_max_len
        engine = ServingEngine(cfg, target, slots=slots, max_len=mlen)
        set_counts()
        t0 = time.perf_counter()
        prefixes, task_s = [], []
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
        mb = cfg.mamba
        for prefix, kv in prefixes:
            for e, d in zip(prefix, cfg.layout.descriptors()):
                x_, want = ((e["ssm"], (1, mb.nheads(cfg.d_model),
                                        mb.headdim, mb.d_state))
                            if d.mixer == "mamba"
                            else (e["h"], (1, mla_m, cfg.d_model)))
                if tuple(x_.shape) != want or not bool(
                        torch.isfinite(x_).all()):
                    raise AssertionError(f"{tag}: a {d.mixer} prefix entry "
                                         f"{tuple(x_.shape)} is not finite "
                                         f"{want}")
            if not all(bool(torch.isfinite(x_).all()) for e in kv
                       for x_ in e.values()):
                raise AssertionError(f"{tag}: materialized prefix not finite")
        reqs = [Request(tokens=p_, max_new=max_new, prefix=f"task{i % 2}")
                for i, p_ in enumerate(prompts)]
        before = dict(engine.counters)
        t0 = time.perf_counter()
        out = engine.serve(reqs)
        torch.cuda.synchronize()
        dense = serve_numbers(engine, reqs, out, time.perf_counter() - t0,
                              before)
        launches = counts()
        tokens = np.stack([out[r.uid] for r in reqs])
        log(f"{tag} {card}: compress 2x{T} tokens -> m={mla_m}: "
            f"{compress_s:.3f}s (per task {[round(x, 4) for x in task_s]}); "
            f"dense serve {slots}x{max_new}: {dense['serve_s']:.3f}s, decode "
            f"{dense['decode_tok_s']:.1f} tok/s ({dense['decode_step_ms']:.2f}"
            f" ms a step), TTFT mean {dense['ttft_mean_s']:.4f}s; launches: "
            f"compress {after_compress}, dense path {launches}")
        log(f"{tag} tokens {tokens.tolist()}")
        if tokens.shape != (slots, max_new) or tokens.min() < 0 \
                or tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"{tag}: bad generated tokens")
        for key in need:
            if launches[key] <= 0:
                raise AssertionError(f"{key} was never launched on {arch}'s "
                                     "dense path")
        peak_dense = torch.cuda.max_memory_allocated()
        # -- paged: 12 requests, every third stopping at its second token --
        bs = 16
        pengine = ServingEngine(cfg, target, slots=slots, max_len=mlen,
                                kv_layout="paged", block_size=bs,
                                num_blocks=1 + 2 * (mla_m // bs) + slots * 4)
        for t, (_, kv) in enumerate(prefixes):
            pengine.add_prefix(f"task{t}", kv)
        f_rng = np.random.default_rng(30)
        specs = [dict(tokens=f_rng.integers(4, vocab.size, int(
            f_rng.integers(4, 13))).astype(np.int32),
            max_new=int(f_rng.integers(4, 17)), prefix=f"task{i % 2}")
            for i in range(12)]
        free_reqs = [Request(**s_) for s_ in specs]
        free = pengine.serve(free_reqs)
        dense_reqs = [Request(**s_) for s_ in specs]
        dense_out = engine.serve(dense_reqs)
        first_diff = [i for i, (f_, d_) in enumerate(zip(free_reqs,
                                                         dense_reqs))
                      if int(free[f_.uid][0]) != int(dense_out[d_.uid][0])]
        same_streams = sum(np.array_equal(free[f_.uid], dense_out[d_.uid])
                           for f_, d_ in zip(free_reqs, dense_reqs))
        log(f"{tag} paged first tokens equal to the dense engine's: "
            f"{len(specs) - len(first_diff)}/{len(specs)}; whole streams "
            f"equal: {same_streams}/{len(specs)}")
        if first_diff:
            raise AssertionError(f"{tag}: paged and dense first tokens "
                                 f"differ for requests {first_diff}")
        preqs = [Request(**s_, stop_token=int(free[f_.uid][1])
                         if i % 3 == 0 else None)
                 for i, (s_, f_) in enumerate(zip(specs, free_reqs))]
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
        stopped = 0
        for r in preqs:
            got = pout[r.uid]
            early = len(got) < r.max_new
            stopped += int(early)
            if not 1 <= len(got) <= r.max_new or (
                    early and int(got[-1]) != r.stop_token) or \
                    got.min() < 0 or got.max() >= cfg.vocab_size:
                raise AssertionError(f"{tag} request {r.uid}: {len(got)} "
                                     f"tokens for a budget of {r.max_new}")
        if not stopped:
            raise AssertionError(f"{tag}: no stop token fired")
        paged.update(requests=len(preqs), stopped_early=stopped,
                     streams_equal_to_dense=int(same_streams),
                     launches=paged_launches)
        log(f"{tag} paged {card}: served {len(preqs)} requests "
            f"({paged['tokens']} tokens, {stopped} stopped early) in "
            f"{paged['serve_s']:.3f}s, decode {paged['decode_tok_s']:.1f} "
            f"tok/s over {paged['decode_steps']} steps "
            f"({paged['decode_step_ms']:.2f} ms each); launches "
            f"{paged_launches}")
        for key in need[:1] + need[2:] + ("paged_flash_decode",):
            if paged_launches[key] <= 0:  # no compress on the paged serve
                raise AssertionError(f"{key} was never launched on {arch}'s "
                                     "paged path")
        refill = None
        if hybrid:  # tasks A, B, A on one prompt over 2 slots: the third
            # refills a slot whose recurrent state B's request advanced
            r_toks = prompts[2]
            eng2 = ServingEngine(cfg, target, slots=2, max_len=mlen)
            fresh = ServingEngine(cfg, target, slots=2, max_len=mlen)
            for e_ in (eng2, fresh):
                for t, (_, kv) in enumerate(prefixes):
                    e_.add_prefix(f"task{t}", kv)
            aba = [Request(tokens=r_toks, max_new=6, prefix=f"task{t}")
                   for t in (0, 1, 0)]
            got = eng2.serve(aba)
            alone = next(iter(fresh.serve(
                [Request(tokens=r_toks, max_new=6, prefix="task0")]).values()))
            refill = bool(np.array_equal(got[aba[2].uid], alone)
                          and np.array_equal(got[aba[0].uid], alone))
            log(f"{tag} a request in a refilled slot (tasks A, B, A) gives a "
                f"fresh engine's tokens: {refill}")
            if not refill:
                raise AssertionError(f"{tag}: a refilled slot kept state")
            del eng2, fresh
        online = None
        if cfg.mla is not None:
            online = mla_online(cfg, target, compressor, prefixes[0])
        serve_s = time.perf_counter() - t_phase
        # -- kernels vs plain, on the same models --
        src = torch.as_tensor(sources[0][None], device=dev)
        prompt = torch.as_tensor(prompts[2][None], dtype=torch.long,
                                 device=dev)

        def pipeline():
            prefix, _ = memcom.compress(compressor, cfg, src)
            kv = materialize_prefix(target, cfg, prefix)
            with torch.no_grad():
                logits, _ = target(tokens=prompt, prefix=kv,
                                   mask_offset=mla_m)
            return ([e.get("h", e.get("ssm")) for e in prefix],
                    logits[0, -1])

        real_attn, real_gmm = plain.attention_ref, plain.gmm_ref

        def attn_sliced(q, k, v, **kw):
            """``plain.attention_ref`` in (batch row, KV-head group) slices
            whose float32 logits stay within 1 GiB: beside jamba's 72 GB
            of weights the whole source prefill's (2.4 GB and its
            temporaries) would not fit."""
            B, Sq, Hq, _ = q.shape
            Skv, Hkv = k.shape[1], k.shape[2]
            G = Hq // Hkv
            if B * Hq * Sq * Skv * 4 <= 2 ** 30:
                return real_attn(q, k, v, **kw)
            out = q.new_empty((*q.shape[:3], v.shape[-1]))
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            for b, h0, h1 in head_slices(B, Sq, Skv, Hkv, G, 2 ** 30):
                r = real_attn(
                    q[b:b + 1, :, h0 * G:h1 * G], k[b:b + 1, :, h0:h1],
                    v[b:b + 1, :, h0:h1], **dict(
                        kw, q_pos=kw["q_pos"][b:b + 1],
                        kv_pos=kw["kv_pos"][b:b + 1]))
                if kw.get("return_lse"):
                    r, lse[b:b + 1, :, h0 * G:h1 * G] = r
                out[b:b + 1, :, h0 * G:h1 * G] = r
            return (out, lse) if kw.get("return_lse") else out

        def plain_run(fn):
            """``fn`` through the plain versions on the kernel run's expert
            choices, the expert products one expert at a time and the
            attention in slices."""
            routing.rows = routing.flips = 0
            ops.set_default_impl("torch")
            plain.gmm_ref, plain.attention_ref = gmm_by_expert, attn_sliced
            try:
                return routing.run("replay", fn)
            finally:
                plain.gmm_ref, plain.attention_ref = real_gmm, real_attn
                ops.set_default_impl(None)

        omega_k, logits_k = routing.run("record", pipeline)
        omega_p, logits_p = plain_run(pipeline)
        flips = (routing.flips, routing.rows)
        errs = [rel(a, b) for a, b in zip(omega_k, omega_p)]
        rel_logits = rel(logits_k, logits_p)
        kinds = [d.mixer for d in cfg.layout.descriptors()]
        log(f"{tag} kernel vs plain, bf16: per layer ({kinds}) O^i / SSM "
            f"state rel err {[f'{e:.3e}' for e in errs]}, first-step logits "
            f"rel err {rel_logits:.3e} (tol {E2E_REL_TOL:g}); greedy token "
            f"kernel {int(logits_k.argmax())} plain {int(logits_p.argmax())};"
            f" MoE rows whose plain top-k differs (replayed): {flips[0]} of "
            f"{flips[1]}")
        if not (max(errs) <= E2E_REL_TOL and rel_logits <= E2E_REL_TOL):
            raise AssertionError(f"{tag}: kernel path and plain path "
                                 "disagree end to end")
        del omega_k, omega_p
        kv0 = prefixes[0][1]

        def paged_first_step():
            """Two 2-token requests through a paged ``serve`` (blocks of 12,
            the prefix's tail block shared and copied on write): the
            last-position logits of the two prefills and the one decode
            step."""
            eng = ServingEngine(cfg, target, slots=2, max_len=mlen,
                                kv_layout="paged", block_size=12)
            eng.add_prefix("task", kv0)
            rows = []
            hook = target.register_forward_hook(
                lambda mod, args, out_: rows.append(out_[0][:, -1].float()))
            try:
                eng.serve([Request(tokens=t_, max_new=2, prefix="task")
                           for t_ in (prompts[2], prompts[1])])
            finally:
                hook.remove()
            if len(rows) != 3:
                raise AssertionError(f"{len(rows)} forward passes, want 2 "
                                     "prefills and 1 decode step")
            return torch.cat(rows[:2]), rows[2]

        set_counts()
        pre_k, step_k = routing.run("record", paged_first_step)
        torch.cuda.synchronize()
        e2e_counts = counts()
        pre_p, step_p = plain_run(paged_first_step)
        rel_pre, rel_step = rel(pre_k, pre_p), rel(step_k, step_p)
        log(f"{tag} paged kernel vs plain: prefill logits rel err "
            f"{rel_pre:.3e}, first decode step logits rel err {rel_step:.3e}"
            f" (tol {E2E_REL_TOL:g}); launches {e2e_counts}")
        if not (rel_pre <= E2E_REL_TOL and rel_step <= E2E_REL_TOL
                and e2e_counts["paged_flash_decode"] > 0
                and e2e_counts["gmm"] > 0):
            raise AssertionError(f"{tag}: paged kernel path and plain path "
                                 "disagree")
        torch.cuda.synchronize()
        peak = max(peak_dense, torch.cuda.max_memory_allocated())
        phase_s = time.perf_counter() - t_phase
        log(f"{tag} peak memory {peak} bytes against {reckoned} reckoned "
            f"(three bf16 stacks and memx); phase {phase_s:.1f}s (init "
            f"{init_s:.1f}s, to the end of serving {serve_s:.1f}s)")
        del target, compressor, engine, pengine, prefixes, kv0
        gc.collect()
        torch.cuda.empty_cache()
        return {"params": n_params, "reckoned_bytes": reckoned,
                "peak_bytes": peak, "weights_peak_bytes": weights_peak,
                "init_s": init_s, "task_compress_s": task_s,
                "compress_s": compress_s, "dense": dense, "paged": paged,
                "launches_after_compress": after_compress,
                "launches": launches, "refill_exact": refill,
                "online": online, "kernel_vs_plain": {
                    "omega_or_state_rel_err": errs,
                    "logits_rel_err": rel_logits,
                    "paged_prefill_rel_err": rel_pre,
                    "paged_step_rel_err": rel_step,
                    "moe_rows_replayed": list(flips),
                    "launches": e2e_counts},
                "phase_s": phase_s}

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
                "prefill_tokens": int(toks.shape[1]),
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

    # ---- 4d, 4j, 4k. training at full width ----------------------------
    ckdir = Path(__file__).resolve().parent / ".chip_smoke_ckpt"

    def start_training():
        import shutil
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.cuda.reset_peak_memory_stats()

    def seed_rebuilt(cfg, named, trained):
        """The frozen tensors of ``named`` as their seed draws them: every
        stack of these runs is the seed-0 target or a copy of it, so each
        frozen name less its stack's prefix names a tensor of
        ``tfm.init_params(cfg, 0)``, drawn again on the card."""
        frozen = [n for n in named if n not in trained]
        if not frozen:
            return {}
        ref = dict(tfm.init_params(cfg, 0).named_parameters())
        return {n: ref[n.split(".", 1)[1]] for n in frozen}

    def train_and_restart(tag, run, cfg, named, steps, tokens, check_step,
                          count_keys, kernel_pats, init_s, restart_at=2,
                          profile=True, restart_run=True):
        """``steps`` steps of ``run`` (trainer, step, params, opt,
        batch_at) with raw checkpoints after step ``restart_at`` and the
        last in ``ckdir``, under
        ``torch.use_deterministic_algorithms(True, warn_only=True)``
        (``start_training``): finite losses, every trained tensor's float32
        master moved, every other tensor of ``named`` bit-identical to its
        seed's draw (``seed_rebuilt``: no copy of the frozen tensors is
        kept, 26 GB at mistral-7b's ICAE++), ``check_step(i, counts)`` on
        each step's launch counts; then a second Trainer restored from step
        ``restart_at`` (None: no restart) must reproduce the losses of the
        later steps and the trained tensors exactly, through its own
        ``run`` (``restart_run``) or its step function (``restart_from``).
        Last (``profile``),
        one profiled step: device busy, idle share and the device time of
        the kernels named by ``kernel_pats``."""
        import shutil
        import warnings

        trained = run.params
        n_frozen = sum(n not in trained for n in named)
        start = {n: p.detach().clone() for n, p in trained.items()}
        n_trained = sum(p.numel() for p in trained.values())
        state_bytes = sum(t.numel() * t.element_size()
                          for key in ("mu", "nu", "master")
                          for t in run.trainer.opt_state[key].values())
        log(f"{tag} init {init_s:.1f}s: {n_trained / 1e6:.1f}M trained "
            f"parameters, {n_frozen} frozen tensors, AdamW state "
            f"{state_bytes} bytes")

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
            # a checkpoint after step restart_at, then one after the last
            for leg in ([restart_at] if restart_at else []) + [steps]:
                run.trainer.tc.num_steps = run.trainer.tc.ckpt_every = leg
                run.trainer.run()
                run.trainer.start_step = leg
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        nondet = sorted({str(w.message)[:120] for w in caught
                         if "deterministic" in str(w.message)})
        losses = dict(run.trainer.losses)
        log(f"{tag} losses {losses}; per-step seconds "
            f"{[round(x, 4) for x in step_s]}; whole run with "
            f"{1 + bool(restart_at)} raw checkpoints {run_s:.2f}s; peak "
            f"memory {peak} bytes")
        log(f"{tag} launches per step: " + ", ".join(
            f"{k} {[c[k] for c in per_step]}" for k in count_keys))
        if nondet:
            log(f"{tag} ops without a deterministic implementation: {nondet}")
        for i, c in enumerate(per_step):
            check_step(i, c)
        if not all(np.isfinite(v) for v in losses.values()) \
                or sorted(losses) != list(range(1, steps + 1)):
            raise AssertionError(f"{tag} losses {losses}")
        moved = {n: not torch.equal(
            run.trainer.opt_state["master"].get(n, p.detach().float()),
            start[n].float()) for n, p in trained.items()}
        bf16_moved = sum(not torch.equal(p.detach(), start[n])
                         for n, p in trained.items())
        if not all(moved.values()):
            raise AssertionError(f"{tag} trained tensors that did not move: "
                                 f"{[n for n, v in moved.items() if not v]}")
        del start
        frozen = seed_rebuilt(cfg, named, trained)
        changed = [n for n, t in frozen.items()
                   if not torch.equal(named[n].detach(), t)]
        if changed or len(frozen) != n_frozen:
            raise AssertionError(f"{tag} frozen tensors changed: {changed[:5]}")
        log(f"{tag} all {len(moved)} trained tensors moved (their float32 "
            f"masters; {bf16_moved} also in their bf16 values); all "
            f"{n_frozen} frozen tensors bit-identical to their seed's draw")
        del frozen
        restart = {}
        opt_state = run.trainer.opt_state
        if restart_at:
            restart = restart_from(tag, run, trained, steps, restart_at,
                                   losses, restart_run)
            opt_state = restart.pop("opt_state")
        ckpt_bytes = sum(f.stat().st_size for f in (
            ckdir / f"step_{restart_at or steps:08d}").iterdir())
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        step_mean = float(np.mean(step_s[1:]))
        out = {"losses": losses, "step_s": step_s,
               "s_per_step": step_mean, "tokens_per_s": tokens / step_mean,
               "peak_bytes": peak, "launches_per_step": per_step,
               "launches": launches, "trained_params": n_trained,
               "adamw_state_bytes": state_bytes, "ckpt_bytes": ckpt_bytes,
               "nondeterministic_ops": nondet, "run_s": run_s,
               "init_s": init_s, **restart}
        log(f"{tag} {card}: {step_mean:.4f} s/step over steps 2-{steps}, "
            f"{out['tokens_per_s']:.1f} tokens/s ({tokens} a step), peak "
            f"memory {peak} bytes, checkpoint {ckpt_bytes} bytes")
        # one profiled step, last: its device busy time, idle share and the
        # kernels' device times
        if profile:
            b = run.batch_at(steps)
            prof = profiled(tag, "step", lambda: run.step(trained, opt_state,
                                                          b))
            kern = {}
            for key, pats in kernel_pats.items():
                hits = [v for k_, v in prof["by_name"].items()
                        if any(p_ in k_ for p_ in pats)]
                kern[key] = (sum(ms for ms, _ in hits),
                             sum(n for _, n in hits))
                log(f"{tag} profile step: {key} {kern[key][0]:.3f} ms over "
                    f"{kern[key][1]} kernels")
            out.update(profile=prof, kernel_device_ms=kern)
        del opt_state
        run.trainer.opt_state = None
        for p in trained.values():
            p.requires_grad_(False)
        return out

    def restart_from(tag, run, trained, steps, restart_at, losses,
                     by_run=True):
        """A second Trainer on the same modules restored from the step
        ``restart_at`` checkpoint, then its resume loop (``by_run``:
        ``Trainer.run``, which also writes a last checkpoint) or, where
        that checkpoint is dear (19 GB at mistral-7b's ICAE++), its step
        function on the batches of the steps after it: its losses and the
        trained tensors must equal the first run's.  It starts from the
        first run's optimizer state object, whose every entry the restore
        replaces (one state on the card, not two: mistral-7b's is 16
        GB)."""
        from repro_torch.train import Trainer, TrainerConfig

        final = {n: p.detach().clone() for n, p in trained.items()}
        t0 = time.perf_counter()
        state, run.trainer.opt_state = run.trainer.opt_state, None
        again = Trainer(
            run.step, trained, state, run.batch_at, str(ckdir),
            TrainerConfig(num_steps=steps, ckpt_every=steps, log_every=1,
                          codec="raw"))
        del state
        restored = again.restore_if_available(step=restart_at)
        restore_s = time.perf_counter() - t0
        if by_run:
            again.run()
            again_losses = again.losses
        else:
            again_losses = {}
            for i in range(again.start_step, steps):
                again.params, again.opt_state, m_ = again.train_step(
                    again.params, again.opt_state, run.batch_at(i))
                again_losses[i + 1] = float(m_["loss"])
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
        later = list(range(restart_at + 1, steps + 1))
        same_losses = all(again_losses.get(s_) == losses[s_] for s_ in later)
        same_params = all(torch.equal(p, final[n]) for n, p in trained.items())
        log(f"{tag} restart from step {restored} (restore {restore_s:.2f}s, "
            f"with its steps {restart_s:.2f}s): "
            f"losses of steps {later} {[again_losses.get(s_) for s_ in later]}"
            f" vs {[losses[s_] for s_ in later]}: identical {same_losses}; "
            f"trained tensors after step {steps} identical {same_params}")
        if not (restored == restart_at and same_losses and same_params):
            diffs = {s_: again_losses.get(s_, float("nan")) - losses[s_]
                     for s_ in later}
            raise AssertionError(f"{tag} the restart does not reproduce the "
                                 f"run: loss differences {diffs}")
        return {"restart_identical": True, "restore_s": restore_s,
                "restart_s": restart_s, "opt_state": again.opt_state}

    def frames_at(cfg, i, batch):
        """Step ``i``'s encoder frames (batch, num_frames, d_model) in bf16,
        drawn on the card from seed 1500 + i (the same tensor each time a
        step's batch is made again, as the restart does)."""
        g = torch.Generator(device=dev)
        g.manual_seed(1500 + i)
        return (0.1 * torch.randn((batch, cfg.encoder.num_frames,
                                   cfg.d_model), generator=g, device=dev)
                ).to(torch.bfloat16)

    def frames_train_run(cfg, *, batch, seq, split, steps, lr):
        """``launch.train.build``'s run (seed-0 target, seed-1 compressor,
        Phase 1 without remat, a PretrainStream of seed 0 split at
        ``split``, a Trainer with raw checkpoints every 2 steps) with each
        step's batch also carrying ``frames_at``'s encoder frames: the
        launcher itself passes none, as the reference's does."""
        from types import SimpleNamespace

        from repro_torch.data import PretrainStream
        from repro_torch.launch import steps as launch_steps
        from repro_torch.train import Trainer, TrainerConfig

        target = tfm.init_params(cfg, 0)
        mc = memcom.init_memcom(cfg, target, 1)
        step, opt, params = launch_steps.build_memcom_train_step(
            cfg, mc, target, phase=1, remat=False, lr=lr)
        stream = PretrainStream(vocab, batch=batch, seq_len=seq,
                                split_choices=(split,), seed=0)

        def batch_at(i):
            b = stream.batch_at(i)
            out = {k: torch.as_tensor(b[k]).to(dev)
                   for k in ("source", "target", "target_mask")}
            out["frames"] = frames_at(cfg, i, batch)
            return out

        trainer = Trainer(step, params, opt.init(params), batch_at,
                          str(ckdir), TrainerConfig(
                              num_steps=steps, ckpt_every=2, log_every=1,
                              codec="raw"))
        return SimpleNamespace(trainer=trainer, mc=mc, target=target,
                               params=params, opt=opt, step=step,
                               batch_at=batch_at)

    def memcom_train_path(arch, cfg=None):
        """MemCom Phase 1 at full width and depth (or ``cfg``'s depth)
        through the port's launcher path (``launch.train.build``: Trainer,
        AdamW with warmup_cosine, clip 1.0; an enc-dec model through
        ``frames_train_run``, the same run with encoder frames in every
        batch): 4 steps of batch 2 x 3584
        tokens split at 3072 (the source) with a checkpoint after step 2,
        then a second Trainer restored from it that must reproduce steps
        3-4 exactly (``train_and_restart``).  Every step: the flash and
        memcom_xattn backward calls of the layers, each through the
        variant its rule picks (at MLA's (192, 128) the wgmma one, the
        only bf16 backward that takes the pair; an enc-dec model adds the
        Memory-LLM's and the prompt's cross-attention over the frames in
        every layer, non-causal), and on a MoE model one
        dX-only gmm backward call for each expert product of the target's
        MoE layers and of the Memory-LLM's but its last (whose output no
        loss term reads).  The peak memory is printed beside its
        reckoning: the three stacks and memx in bf16, and for each trained
        parameter its bf16 gradient and float32 AdamW moments and
        master."""
        from repro_torch.launch import train as launch_train
        from repro_torch.optim import warmup_cosine

        cfg = cfg or get_config(arch)
        tag = f"[{arch} train]"
        start_training()
        steps, seq, split, batch = 4, T + m, T, 2
        # warmup over 2 steps: the reference's 500 would keep a bf16
        # parameter's first updates (lr ~ 4e-7) below its rounding step
        lr = warmup_cosine(2e-4, 2, 20_000)
        t0 = time.perf_counter()
        if cfg.encoder is not None:
            run = frames_train_run(cfg, batch=batch, seq=seq, split=split,
                                   steps=steps, lr=lr)
        else:
            run = launch_train.build(cfg, phase=1, batch=batch, seq=seq,
                                     split=split, steps=steps,
                                     ckpt=str(ckdir), ckpt_every=2,
                                     codec="raw", log_every=1, lr=lr)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        named = dict(run.mc.named_parameters())
        named.update(("target." + n, p)
                     for n, p in run.target.named_parameters())
        n_all = sum(p.numel() for p in named.values())
        n_trained = sum(p.numel() for p in run.params.values())
        reckoned = 2 * n_all + (2 + 12) * n_trained
        log(f"{tag} {len(cfg.layout.descriptors())} layers: {n_all / 1e9:.3f}"
            f" B parameters in bf16, {n_trained / 1e6:.1f} M trained (bf16 "
            f"gradients, float32 AdamW moments and master): {reckoned} "
            "bytes reckoned before activations")
        L = cfg.num_layers
        mm = cfg.memcom.num_memory_tokens   # the Memory-LLM's rows
        # every call of the step is bf16: the Memory-LLM's mm rows, the
        # prompt's seq - split rows against themselves and against the mm
        # prefix rows; all go where bwd_variant_for sends them
        if cfg.mla is not None:  # per-head keys and values, no GQA fold
            G, D, Dv = 1, cfg.mla.qk_head_dim, cfg.mla.v_head_dim
        else:
            G, D, Dv = cfg.num_heads // cfg.num_kv_heads, cfg.hd, cfg.hd
        p_rows = seq - split
        calls = ((mm, mm), (p_rows, p_rows), (p_rows, mm))
        # the Memory-LLM's self-attention and the prompt against the prefix
        # in every layer, the prompt's self-attention in every layer but
        # the first (whose q, k, v come from the frozen token embeddings
        # alone, so autograd records no backward); an enc-dec model's
        # Memory-LLM and prompt also cross-attend to the frames in every
        # layer (for dq alone: the frozen encoder's output needs none)
        want_bwd = 3 * L - 1
        if cfg.encoder is not None:
            nf = cfg.encoder.num_frames
            calls += ((mm, nf), (p_rows, nf))
            want_bwd += 2 * L
        want_wg = (want_bwd if all(
            fa.bwd_variant_for(torch.bfloat16, D, rows * G, skv, Dv)
            == "wgmma" for rows, skv in calls) else 0)
        # and each layer's memory cross-attention over the split's source
        want_xwg = (L if mx.bwd_variant_for(
            torch.bfloat16, batch, mm, split, cfg.d_model, True) == "wgmma"
            else 0)
        moe_layers = [d.mlp == "moe" for d in cfg.layout.descriptors()]
        want_gmm = 3 * (2 * sum(moe_layers) - int(moe_layers[-1])) \
            if any(moe_layers) else 0

        def check_step(i, c):
            if c["flash_attention_bwd"] != want_bwd \
                    or c["flash_attention_bwd_wgmma"] != want_wg \
                    or c["memcom_xattn_bwd"] != L \
                    or c["memcom_xattn_bwd_wgmma"] != want_xwg \
                    or c["gmm_bwd"] != want_gmm \
                    or c["gmm_bwd_dx"] != want_gmm or c["gmm_bwd_dw"] != 0 \
                    or c["gmm_bwd_wgmma"] != want_gmm:
                raise AssertionError(
                    f"{tag} step {i + 1}: {c['flash_attention_bwd']} flash "
                    f"backward calls (want {want_bwd}), "
                    f"{c['flash_attention_bwd_wgmma']} through the wgmma "
                    f"variant (want {want_wg}), "
                    f"{c['memcom_xattn_bwd']} memcom_xattn backward calls "
                    f"(want {L}), {c['memcom_xattn_bwd_wgmma']} through its "
                    f"wgmma variant (want {want_xwg}), {c['gmm_bwd']} gmm "
                    f"backward calls (want {want_gmm}: dX {c['gmm_bwd_dx']},"
                    f" dW {c['gmm_bwd_dw']}, want dX alone; "
                    f"{c['gmm_bwd_wgmma']} through its wgmma variant, want "
                    "all)")
            if c["memcom_xattn"] != c["memcom_xattn_wgmma"] or \
                    c["memcom_xattn"] != L:
                raise AssertionError(f"{tag} step {i + 1}: memcom_xattn "
                                     f"forward off the wgmma variant: {c}")

        pats = {"flash_fwd": ("flash_fwd",), "flash_bwd": ("flash_bwd_",),
                "xattn_fwd": ("xattn_logits_wgmma", "xattn_out_wgmma"),
                "xattn_bwd": ("xattn_bwd_",)}
        keys = ["flash_attention_bwd", "flash_attention_bwd_wgmma",
                "memcom_xattn_bwd_wgmma"]
        if want_gmm:
            pats.update(gmm_fwd=("gmm_wgmma", "gmm_rows", "gmm_bf16"),
                        gmm_bwd=("gmm_bwd",))
            keys += ["gmm", "gmm_bwd", "gmm_bwd_dx", "gmm_bwd_dw",
                     "gmm_bwd_wgmma"]
        out = train_and_restart(tag, run, cfg, named, steps, batch * seq,
                                check_step, keys, pats, init_s)
        out["target_tokens_per_s"] = batch * (seq - split) / out["s_per_step"]
        out.update(want_gmm_bwd=want_gmm, want_flash_bwd=want_bwd,
                   batch=batch, seq=seq, split=(split, seq - split))
        out["reckoned_bytes"] = reckoned
        log(f"{tag} peak memory {out['peak_bytes']} bytes against {reckoned}"
            " reckoned before activations")
        del run, named
        return out

    def mamba_train_path():
        """mamba2-370m next-token training at full width and depth through
        ``launch.steps.build_lm_train_step`` (every parameter, AdamW with
        warmup_cosine, clip 1.0, remat) and the Trainer: 4 steps of batch 2
        x 3072 tokens, checkpoints and the exact restart as 4d; every step
        one ``ssd`` backward call a Mamba2 layer and every forward call
        through the chunked variant."""
        from repro_torch.data import PretrainStream
        from repro_torch.launch import steps as launch_steps
        from repro_torch.optim import warmup_cosine
        from repro_torch.train import Trainer, TrainerConfig

        arch = "mamba2-370m"
        cfg = get_config(arch)
        tag = f"[{arch} train]"
        start_training()
        steps, seq, batch = 4, T, 2
        t0 = time.perf_counter()
        model = tfm.init_params(cfg, 0)
        step, opt, params = launch_steps.build_lm_train_step(
            cfg, model, lr=warmup_cosine(1e-4, 2, 20_000))
        stream = PretrainStream(vocab, batch=batch, seq_len=seq,
                                split_choices=(seq // 2,), seed=0)

        def batch_at(i):
            b = stream.batch_at(i)
            return {"tokens": torch.as_tensor(np.concatenate(
                [b["source"], b["target"]], axis=1), device=dev)}

        trainer = Trainer(step, params, opt.init(params), batch_at,
                          str(ckdir), TrainerConfig(
                              num_steps=steps, ckpt_every=2, log_every=1,
                              codec="raw"))
        from types import SimpleNamespace
        run = SimpleNamespace(trainer=trainer, step=step, params=params,
                              opt=opt, batch_at=batch_at)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        L = sum(d.mixer == "mamba" for d in cfg.layout.descriptors())

        def check_step(i, c):
            if c["ssd_bwd"] != L or c["ssd_bwd_chunked"] != L \
                    or c["ssd"] != c["ssd_chunked"] or c["ssd"] < L:
                raise AssertionError(
                    f"{tag} step {i + 1}: {c['ssd_bwd']} ssd backward calls "
                    f"(want {L}), {c['ssd_bwd_chunked']} of them chunked "
                    f"(want all), {c['ssd']} forward calls, "
                    f"{c['ssd_chunked']} of them chunked (want all)")

        # the chunked backward reruns the forward's first two phases (their
        # time counts under ssd_fwd) and then its own four kernels
        out = train_and_restart(
            tag, run, cfg, dict(model.named_parameters()), steps, batch * seq,
            check_step, ["ssd", "ssd_chunked", "ssd_bwd", "ssd_bwd_chunked"],
            {"ssd_fwd": ("ssd_chunk_states<128, 64, 128, false>",
                         "ssd_state_pass<false>", "ssd_chunk_outputs"),
             "ssd_bwd": ("ssd_chunk_states<128, 64, 128, true>",
                         "ssd_state_pass<true>", "ssd_chunk_grads",
                         "ssd_grad_reduce", "ssd_bwd")}, init_s)
        out["mamba_layers"] = L
        del run, model, params, trainer
        return out

    def train_kernel_vs_plain(arch, cfg2=None):
        """One Phase-1 and one Phase-2 step's loss and gradients at full
        width and depth 2, through the kernels and forced to the plain
        versions: each gradient within 2e-2 of the plain run's largest
        magnitude (Phase 2 adds the Source- and Memory-LLM, and with them
        the 3072-token source's flash backward, in every layer whose
        output some H^i reads).  On a MoE model the plain run replays the
        kernel run's top-k choices, and the gmm backward must launch dX
        alone in Phase 1 and dW too in Phase 2 (the experts train).
        ``cfg2`` (deepseek-v2-236b's depth-2 cut, 16.3 B parameters) runs
        the plain attention in slices of at most 1 GiB of float32 logits
        and the plain expert products one expert at a time, each
        recomputed in the backward (``torch.utils.checkpoint``: a float32
        copy of one MoE layer's 160 experts kept for the backward would
        take 15 GB), and keeps the kernel run's gradients on the host
        while the plain run makes its own (a Phase-2 set is 21.7 GB)."""
        from torch.utils.checkpoint import checkpoint

        from repro_torch.data import PretrainStream

        cfg = get_config(arch)
        is_moe = cfg.moe is not None
        lean = cfg2 is not None
        cross = cfg.layout.period[0].cross_attn
        cfg2 = cfg2 or cfg.replace(
            name=f"{arch}-depth2", layout=LayerLayout.uniform(
                LayerDesc("attn", "moe" if is_moe else "dense",
                          cross_attn=cross), 2))
        if cfg2.encoder is not None:
            # the encoder cut to depth 2 as well; the batch carries frames
            cfg2 = cfg2.replace(encoder=dc_replace(cfg2.encoder, num_layers=2))
        moe_layers = [d.mlp == "moe" for d in cfg2.layout.descriptors()]
        # Phase 1: dX of the target's MoE layers and the Memory-LLM's but
        # its last (three expert products each)
        want_dx = 3 * (2 * sum(moe_layers) - int(moe_layers[-1]))
        tag = f"[{arch} train kernel-vs-plain]"
        real_attn, real_gmm = plain.attention_ref, plain.gmm_ref

        def attn_lean(q, k, v, **kw):
            """``plain.attention_ref`` in (batch row, KV-head group)
            slices of at most 1 GiB of float32 logits, each a checkpoint
            (its logits recomputed in the backward, not kept)."""
            B, Sq, Hq, _ = q.shape
            Skv, Hkv = k.shape[1], k.shape[2]
            G = Hq // Hkv
            rows = {}
            for b, h0, h1 in head_slices(B, Sq, Skv, Hkv, G, 2 ** 30):
                def one(q_, k_, v_, qp, kp):
                    return real_attn(q_, k_, v_, **dict(kw, q_pos=qp,
                                                        kv_pos=kp))
                args = (q[b:b + 1, :, h0 * G:h1 * G], k[b:b + 1, :, h0:h1],
                        v[b:b + 1, :, h0:h1], kw["q_pos"][b:b + 1],
                        kw["kv_pos"][b:b + 1])
                r = (checkpoint(one, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else one(*args))
                rows.setdefault(b, []).append(r if kw.get("return_lse")
                                              else (r,))
            parts = [[torch.cat(x, dim=2) for x in zip(*rows[b])]
                     for b in sorted(rows)]
            res = [torch.cat(x, dim=0) for x in zip(*parts)]
            return tuple(res) if kw.get("return_lse") else res[0]

        def gmm_lean(x, w):
            """``gmm_by_expert``, each expert's product a checkpoint."""
            def one(a, b):
                return (a.float() @ b.float()).to(a.dtype)
            if not torch.is_grad_enabled():
                return gmm_by_expert(x, w)
            return torch.stack([checkpoint(one, x[e], w[e],
                                           use_reentrant=False)
                                for e in range(x.shape[0])])
        target2 = tfm.init_params(cfg2, 0)
        mc2 = memcom.init_memcom(cfg2, target2, 1)
        raw = PretrainStream(vocab, batch=2, seq_len=T + m,
                             split_choices=(T,), seed=0).batch_at(0)
        batch = {k: torch.as_tensor(raw[k], device=dev)
                 for k in ("source", "target", "target_mask")}
        if cfg2.encoder is not None:
            batch["frames"] = frames_at(cfg2, 0, 2)
        source_bwd = []
        inner_bwd = fa.flash_attention_bwd

        def spy(q, *a, **kw):
            source_bwd.append(int(q.shape[1]) == T)
            return inner_bwd(q, *a, **kw)

        out = {}
        for phase in (1, 2):
            t_ph = time.perf_counter()
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
                loss_k, g_k = (routing.run("record", grads) if is_moe
                               else grads())
            finally:
                fa.flash_attention_bwd = inner_bwd
            torch.cuda.synchronize()
            c = counts()
            nonzero = sum(float(g.float().abs().max()) > 0 for g in g_k)
            if lean:
                g_k = [g.cpu() for g in g_k]
            routing.rows = routing.flips = 0
            ops.set_default_impl("torch")
            if lean:
                plain.gmm_ref, plain.attention_ref = gmm_lean, attn_lean
            try:
                loss_p, g_p = (routing.run("replay", grads) if is_moe
                               else grads())
            finally:
                plain.gmm_ref, plain.attention_ref = real_gmm, real_attn
                ops.set_default_impl(None)
            rels = {n: rel(a.to(dev), b) for n, a, b in zip(trained, g_k,
                                                          g_p)}
            worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
            log(f"{tag} phase {phase}, depth 2, bf16: loss kernel {loss_k:.6f}"
                f" plain {loss_p:.6f}; {len(rels)} gradients ({nonzero} "
                f"non-zero), worst rel err {worst} (tol {E2E_REL_TOL:g}); "
                f"flash backward calls {c['flash_attention_bwd']} "
                f"({sum(source_bwd)} over the {T}-token source, "
                f"{c['flash_attention_bwd_wgmma']} wgmma), "
                f"memcom_xattn backward calls {c['memcom_xattn_bwd']}"
                + (f"; gmm backward calls {c['gmm_bwd']} (dX "
                   f"{c['gmm_bwd_dx']}, dW {c['gmm_bwd_dw']}, wgmma "
                   f"{c['gmm_bwd_wgmma']}); top-k rows "
                   f"the plain run would have routed otherwise "
                   f"{routing.flips} of {routing.rows}" if is_moe else "")
                + f"; {time.perf_counter() - t_ph:.1f}s")
            # Phase 2: the source's flash backward in every layer but the
            # last, whose attention feeds no captured hidden (an enc-dec
            # layer's self- and cross-attention both)
            want_src = ((cfg2.num_layers - 1) * (2 if cross else 1)
                        if phase == 2 else 0)
            # Phase 1: dX alone (want_dx); Phase 2 trains the experts of
            # both compressor stacks, each MoE layer's but the last's
            # (whose output no captured hidden reads: deepseek's cut has
            # its one MoE layer last, so no expert there gets a gradient)
            gmm_ok = not is_moe or (
                c["gmm_bwd_dx"] == c["gmm_bwd"] == want_dx
                and c["gmm_bwd_dw"] == 0
                if phase == 1
                else (c["gmm_bwd_dw"] > 0) == any(moe_layers[:-1]))
            if not (worst[0][1] <= E2E_REL_TOL
                    and abs(loss_k - loss_p) <= E2E_REL_TOL * abs(loss_p)
                    and sum(source_bwd) == want_src
                    and c["flash_attention_bwd_wgmma"]
                    == c["flash_attention_bwd"]
                    and c["memcom_xattn_bwd"] == 2 and gmm_ok):
                raise AssertionError(f"{tag} phase {phase}: kernel path and "
                                     "plain path disagree")
            out[f"phase{phase}"] = {
                "loss_kernel": loss_k, "loss_plain": loss_p,
                "worst_rel_err": worst, "launches": c,
                "source_flash_bwd": sum(source_bwd)}
            if is_moe:
                out[f"phase{phase}"]["topk_flips"] = [routing.flips,
                                                      routing.rows]
            del g_k, g_p
        for p in mc2.parameters():
            p.requires_grad_(False)
        return out

    def mamba_train_kernel_vs_plain():
        """mamba2-370m at full width and depth 2: one next-token loss and
        every parameter's gradient over batch 2 x 3072 through ``ssd`` and
        its backward kernel and forced to the plain versions: each
        gradient within 2e-2 of the plain run's largest magnitude."""
        from repro_torch.core.memcom import next_token_loss
        from repro_torch.data import PretrainStream

        cfg = get_config("mamba2-370m")
        cfg2 = cfg.replace(name="mamba2-370m-depth2",
                           layout=LayerLayout.uniform(
                               LayerDesc("mamba", "none"), 2))
        tag = "[mamba2-370m train kernel-vs-plain]"
        t_ph = time.perf_counter()
        model = tfm.init_params(cfg2, 0)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        raw = PretrainStream(vocab, batch=2, seq_len=T, split_choices=(
            T // 2,), seed=0).batch_at(0)
        toks = torch.as_tensor(np.concatenate([raw["source"], raw["target"]],
                                              axis=1), device=dev)

        def grads():
            logits, aux = model(tokens=toks)
            loss = next_token_loss(logits, toks) + aux["moe_loss"]
            g = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
            return float(loss.detach()), g

        set_counts()
        loss_k, g_k = grads()
        torch.cuda.synchronize()
        c = counts()
        ops.set_default_impl("torch")
        try:
            loss_p, g_p = grads()
        finally:
            ops.set_default_impl(None)
        rels = {n: rel(a, b) for n, a, b in zip(params, g_k, g_p)}
        worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
        log(f"{tag} depth 2, bf16: loss kernel {loss_k:.6f} plain "
            f"{loss_p:.6f}; {len(rels)} gradients, worst rel err {worst} "
            f"(tol {E2E_REL_TOL:g}); ssd calls {c['ssd']} ({c['ssd_chunked']}"
            f" chunked), ssd backward calls {c['ssd_bwd']} "
            f"({c['ssd_bwd_chunked']} chunked); "
            f"{time.perf_counter() - t_ph:.1f}s")
        model.requires_grad_(False)
        if not (worst[0][1] <= E2E_REL_TOL and c["ssd_bwd"] == 2
                and abs(loss_k - loss_p) <= E2E_REL_TOL * abs(loss_p)):
            raise AssertionError(f"{tag}: kernel path and plain path "
                                 "disagree")
        return {"loss_kernel": loss_k, "loss_plain": loss_p,
                "worst_rel_err": worst, "launches": c}

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
                     cfg, tfm.init_params(cfg, 9))),
                 # the paged layout (head dim 32: the paged kernel at its
                 # 64-wide tile), and the same forced to the plain versions
                 "paged": dict(kv_layout="paged", block_size=16),
                 "paged_plain": dict(kv_layout="paged", block_size=16)}
        runs, out = {}, {}
        for mode, kw in modes.items():
            eng = ServingEngine(cfg, target, slots=slots, max_len=mlen,
                                fused_chunk_tokens=16, **kw)
            set_counts()
            ops.set_default_impl("torch" if mode == "paged_plain" else None)
            try:
                res = eng.serve([Request(**x) for x in specs])
            finally:
                ops.set_default_impl(None)
            paths[f"bench-target {mode}"] = counts()
            if mode == "paged" and not counts()["paged_flash_decode"]:
                raise AssertionError(f"{tag}: the paged serve launched no "
                                     "paged_flash_decode")
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

    # ---- 4l, 4m. the ICAE baselines at full width ------------------------
    from types import SimpleNamespace

    from repro_torch.core import icae
    from repro_torch.data import PretrainStream
    from repro_torch.launch import steps as launch_steps
    from repro_torch.train import Trainer, TrainerConfig

    def icae_soft_and_logits(ic, target, cfg, src, prompt_rows):
        """The soft tokens of ``src`` (B, T) and, behind soft row i % B,
        the last-position logits of each prompt (``benchmarks/common.py``'s
        ``make_icae_predictor``)."""
        with torch.no_grad():
            soft = icae.icae_compress(ic, cfg, src)
            rows = []
            for i, p_ in enumerate(prompt_rows):
                q = torch.as_tensor(p_[None], dtype=torch.long, device=dev)
                emb = F.embedding(q, target.embed.tokens)
                b = i % soft.shape[0]
                lg, _ = target(embeds=torch.cat(
                    [soft[b:b + 1].to(emb.dtype), emb], dim=1))
                rows.append(lg[0, -1].float())
        return soft, torch.stack(rows)

    def icae_compress_run(tag, cfg, ic, target, srcs, m_):
        """Compress the two tasks (one batch of 2) into soft tokens and take
        the first-step logits of the 4-12-token prompts behind them: finite,
        of their shapes, and every compressor flash call over source +
        memory through the variant ``fa.variant_for`` picks."""
        S = srcs[0].shape[0] + m_
        src = torch.as_tensor(np.stack(srcs), device=dev)
        calls = SourcePrefills(S)
        set_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with calls:
            soft, logits = icae_soft_and_logits(ic, target, cfg, src, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        pick = fa.variant_for(torch.bfloat16, cfg.hd, S, fa._splits(
            2, S, S, cfg.num_heads, cfg.num_kv_heads,
            torch.cuda.current_device()))
        ok = (tuple(soft.shape) == (2, m_, cfg.d_model)
              and bool(torch.isfinite(soft).all())
              and tuple(logits.shape) == (len(prompts), cfg.vocab_size)
              and bool(torch.isfinite(logits).all()))
        log(f"{tag} compress 2 x {S - m_} tokens -> 2 x {m_} soft tokens "
            f"and {len(prompts)} first-step logits: {wall:.3f}s; "
            f"{calls.calls} flash calls over the {S} compressor positions, "
            f"{calls.wgmma} through wgmma (the rule picks {pick}); greedy "
            f"tokens {logits.argmax(-1).tolist()}; launches {c}")
        if not ok or calls.calls != cfg.num_layers or calls.wgmma != (
                calls.calls if pick == "wgmma" else 0):
            raise AssertionError(f"{tag}: bad soft tokens or logits, or "
                                 "compressor flash calls off the rule")
        return {"s": wall, "flash_calls": calls.calls,
                "flash_wgmma": calls.wgmma, "launches": c,
                "greedy": logits.argmax(-1).tolist()}

    def icae_train_path(arch, geom, runs, restart_run, depth=None):
        """The ICAE baselines at full width and depth (4l, 4m): for each
        (variant, steps, restart step or None, profile?) in ``runs``, a
        compressor copied from one seeded target (seed 0; adapters and
        ``mem_embed`` from seed 1), the compress check, then
        ``build_icae_train_step`` (AdamW with the reference's
        ``warmup_constant(2e-3, 30)``, clip 1.0, remat) through the Trainer
        on batch 2 x (T + 512) split at T, by ``train_and_restart``:
        checkpoints, an exact restart, the frozen tensors (the target and
        the compressor's untrained ones) checked against their seeds'
        draw; the restart through ``Trainer.run`` where ``restart_run``.
        Every step makes one flash backward call a layer in each
        stack (``mem_embed`` trains, so the compressor's first layer needs
        dQ, dK and dV; the soft tokens carry the target's gradient back),
        each through the variant ``fa.bwd_variant_for`` picks.  ``depth``
        cuts the layout to that many layers."""
        m_, T_, srcs, _ = geom
        cfg = cut_depth(get_config(arch), depth)
        L, G = cfg.num_layers, cfg.num_heads // cfg.num_kv_heads
        batch, seq = 2, T_ + 512
        t0 = time.perf_counter()
        target = tfm.init_params(cfg, 0)
        torch.cuda.synchronize()
        target_s = time.perf_counter() - t0
        lengths = (T_ + m_, m_ + seq - T_)  # compressor, target positions
        want_wg = sum(L for n in lengths if fa.bwd_variant_for(
            torch.bfloat16, cfg.hd, n * G, n) == "wgmma")
        stream = PretrainStream(vocab, batch=batch, seq_len=seq,
                                split_choices=(T_,), seed=0)

        def batch_at(i):
            b = stream.batch_at(i)
            return {k: torch.as_tensor(b[k], device=dev)
                    for k in ("source", "target", "target_mask")}

        out = {}
        for variant, steps, restart_at, prof in runs:
            tag = f"[{arch} {variant}]"
            start_training()
            t0 = time.perf_counter()
            ic = icae.init_icae(cfg, target, variant, seed=1)
            res = {"compress": icae_compress_run(tag, cfg, ic, target, srcs,
                                                 m_)}
            step, opt, params = launch_steps.build_icae_train_step(
                cfg, ic, target)
            trainer = Trainer(step, params, opt.init(params), batch_at,
                              str(ckdir), TrainerConfig(
                                  num_steps=steps, log_every=1, codec="raw"))
            run = SimpleNamespace(trainer=trainer, step=step, params=params,
                                  opt=opt, batch_at=batch_at)
            torch.cuda.synchronize()
            init_s = target_s + time.perf_counter() - t0
            named = dict(ic.named_parameters())
            named.update(("target." + n, p)
                         for n, p in target.named_parameters())

            def check_step(i, c, tag=tag):
                if c["flash_attention_bwd"] != 2 * L \
                        or c["flash_attention_bwd_wgmma"] != want_wg \
                        or c["memcom_xattn"] or c["memcom_xattn_bwd"]:
                    raise AssertionError(
                        f"{tag} step {i + 1}: {c['flash_attention_bwd']} "
                        f"flash backward calls (want {2 * L}), "
                        f"{c['flash_attention_bwd_wgmma']} through the wgmma "
                        f"variant (want {want_wg}); launches {c}")

            res.update(train_and_restart(
                tag, run, cfg, named, steps, batch * seq, check_step,
                ["flash_attention", "flash_attention_wgmma",
                 "flash_attention_bwd", "flash_attention_bwd_wgmma"],
                {"flash_fwd": ("flash_fwd",), "flash_bwd": ("flash_bwd_",)},
                init_s, restart_at=restart_at, profile=prof,
                restart_run=restart_run))
            res["flash_bwd_per_step"] = 2 * L
            res["want_bwd_wgmma"] = want_wg
            out[variant] = res
            del ic, run, trainer, step, opt, params, named
            gc.collect()
            torch.cuda.empty_cache()
        del target
        return out

    def icae_kernel_vs_plain(arch, geom, variants, batch):
        """At full width and depth 2, for each variant: the soft tokens of a
        task and the first-step logits of a prompt behind them, then the
        loss (over ``batch`` rows of T + 512 tokens split at T, remat) and
        every trained gradient with each adapter's ``b`` drawn off zero
        (at init every gradient of ``a`` is 0), through the kernels and
        forced to the plain versions: each within 2e-2 of the plain run's
        largest magnitude; one flash backward call a layer and stack."""
        m_, T_, srcs, _ = geom
        cfg = get_config(arch)
        cfg2 = cfg.replace(name=f"{arch}-depth2", layout=LayerLayout.uniform(
            LayerDesc("attn", "dense"), 2))
        tag = f"[{arch} icae kernel-vs-plain]"
        target2 = tfm.init_params(cfg2, 0)
        src = torch.as_tensor(srcs[0][None], device=dev)
        raw = PretrainStream(vocab, batch=batch, seq_len=T_ + 512,
                             split_choices=(T_,), seed=0).batch_at(0)
        data = {k: torch.as_tensor(raw[k], device=dev)
                for k in ("source", "target", "target_mask")}
        out = {}
        for variant in variants:
            t_ph = time.perf_counter()
            ic2 = icae.init_icae(cfg2, target2, variant, seed=1)
            g_b = torch.Generator(device=dev)
            g_b.manual_seed(29)
            with torch.no_grad():
                for ad in ic2.lora.adapters().values():
                    ad.b.copy_(0.05 * torch.randn(ad.b.shape, generator=g_b,
                                                  device=dev))
            trained = icae.set_trainable(ic2)

            def both():
                soft, logits = icae_soft_and_logits(ic2, target2, cfg2, src,
                                                    [prompts[2]])
                loss, _ = icae.icae_loss(ic2, target2, cfg2, data, remat=True)
                g = torch.autograd.grad(loss, list(trained.values()))
                return soft, logits, float(loss.detach()), g

            set_counts()
            soft_k, lg_k, loss_k, g_k = both()
            torch.cuda.synchronize()
            c = counts()
            ops.set_default_impl("torch")
            try:
                soft_p, lg_p, loss_p, g_p = both()
            finally:
                ops.set_default_impl(None)
            rels = {n: rel(a, b) for n, a, b in zip(trained, g_k, g_p)}
            worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
            r_soft, r_lg = rel(soft_k, soft_p), rel(lg_k, lg_p)
            log(f"{tag} {variant}, depth 2, bf16: soft tokens rel err "
                f"{r_soft:.3e}, first-step logits rel err {r_lg:.3e}; loss "
                f"kernel {loss_k:.6f} plain {loss_p:.6f}; {len(rels)} "
                f"gradients, worst rel err {worst} (tol {E2E_REL_TOL:g}); "
                f"flash backward calls {c['flash_attention_bwd']} "
                f"({c['flash_attention_bwd_wgmma']} wgmma); "
                f"{time.perf_counter() - t_ph:.1f}s")
            if not (r_soft <= E2E_REL_TOL and r_lg <= E2E_REL_TOL
                    and worst[0][1] <= E2E_REL_TOL
                    and abs(loss_k - loss_p) <= E2E_REL_TOL * abs(loss_p)
                    and c["flash_attention_bwd"] == 4):
                raise AssertionError(f"{tag} {variant}: kernel path and "
                                     "plain path disagree")
            out[variant] = {"soft_rel_err": r_soft, "logits_rel_err": r_lg,
                            "loss_kernel": loss_k, "loss_plain": loss_p,
                            "worst_rel_err": worst, "launches": c}
            del ic2, trained, g_k, g_p, soft_k, soft_p
            gc.collect()
            torch.cuda.empty_cache()
        return out

    # ---- 4q, 4r, 4s. qwen2-vl-2b, whisper-medium, the smoke launchers --
    def whisper_frames(cfg, target, compressor, prefixes, engine, pengine):
        """4r (a): whisper-medium's encoder frames through the JAX
        package's own entry points (the engine and the launcher take none):
        ``build_compress_step`` on the two tasks with 1500 seeded frames
        each, ``write_prefix_to_cache``, a target prefill of the prompt at
        cache_index = mask_offset = m with the encoder output (which fills
        the cross entries), and 16 greedy steps of ``build_decode_step``,
        which read them back.  Every call with the frames as keys (the
        encoder's self-attention, the decoder blocks' cross-attention)
        must launch the flash kernel; logits finite."""
        from repro_torch.launch import steps as lsteps
        from repro_torch.serving import write_prefix_to_cache

        tag = "[whisper-medium frames]"
        nf = cfg.encoder.num_frames
        g_fr = torch.Generator(device=dev)
        g_fr.manual_seed(15)
        frames_in = [(0.1 * torch.randn((1, nf, cfg.d_model), generator=g_fr,
                                        device=dev)).to(target.dtype)
                     for _ in sources]
        compress_step = lsteps.build_compress_step(cfg)
        decode_step = lsteps.build_decode_step(cfg)
        calls = []  # (query rows, kernel launches, wgmma launches)
        inner = fa.flash_attention

        def spy(q, k, v, **kw):
            before = (fa.launches, fa.wgmma_launches)
            out = inner(q, k, v, **kw)
            if k.shape[1] == nf:
                calls.append((q.shape[1], fa.launches - before[0],
                              fa.wgmma_launches - before[1]))
            return out

        fa.flash_attention = spy
        try:
            set_counts()
            t0 = time.perf_counter()
            steps_out = [compress_step(compressor, target, {
                "source": torch.as_tensor(src[None], device=dev),
                "frames": fr}) for src, fr in zip(sources, frames_in)]
            torch.cuda.synchronize()
            compress_s = time.perf_counter() - t0
            n_compress = len(calls)
            streams, finite, cross_set = [], True, True
            t0 = time.perf_counter()
            for (kv, enc), p_ in zip(steps_out, prompts[:2]):
                cache = tfm.init_cache(cfg, 1, max_len, device=dev)
                write_prefix_to_cache(cfg, cache, kv)
                with torch.no_grad():
                    logits, _ = target(
                        tokens=torch.as_tensor(p_[None], dtype=torch.long,
                                               device=dev),
                        cache=cache, cache_index=m, mask_offset=m,
                        encoder_out=enc)
                cross_set &= all(bool(c["ck"].ne(0).any()) for c in cache)
                finite &= bool(torch.isfinite(logits).all())
                tok = logits[:, -1].argmax(-1)
                got = [int(tok)]
                n = m + len(p_)
                for i in range(max_new - 1):
                    lg, _ = decode_step(target, cache, {
                        "tokens": tok[:, None],
                        "cache_index": torch.tensor([n + i], dtype=torch.int32,
                                                    device=dev)})
                    finite &= bool(torch.isfinite(lg).all())
                    tok = lg[:, -1].argmax(-1)
                    got.append(int(tok))
                streams.append(got)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches = counts()
        finally:
            fa.flash_attention = inner
        L = cfg.num_layers
        # per task: the source encoder's layers, the source's and the
        # Memory-LLM's cross-attention, the prefill's, and the 15 decode
        # steps' over the cross cache
        want = len(sources) * (cfg.encoder.num_layers + 2 * L + L
                               + L * (max_new - 1))
        enc_calls = [c for c in calls if c[0] == nf]
        nsplit = fa._splits(1, nf, nf, cfg.num_heads, cfg.num_kv_heads,
                            torch.cuda.current_device())
        out = {
            "compress_s": compress_s, "serve_s": serve_s, "tokens": streams,
            "frame_calls": len(calls), "frame_calls_compress": n_compress,
            "frame_calls_launched": sum(c[1] for c in calls),
            "encoder_calls": len(enc_calls),
            "encoder_wgmma": sum(c[2] for c in enc_calls),
            "encoder_variant": fa.variant_for(torch.bfloat16, cfg.hd, nf,
                                              nsplit),
            "encoder_nsplit": nsplit, "launches": launches}
        log(f"{tag} {card}: build_compress_step over 2 x {T} tokens and "
            f"{nf} frames {compress_s:.3f}s; prefill + {max_new - 1} "
            f"build_decode_step steps a task {serve_s:.3f}s; tokens "
            f"{streams}; calls over the frames {len(calls)} (want {want}, "
            f"{out['frame_calls_launched']} launched the kernel; "
            f"{n_compress} in the compress); the encoder's {nf} x {nf} "
            f"calls: {len(enc_calls)}, {out['encoder_wgmma']} through wgmma "
            f"({out['encoder_variant']}, {nsplit} split); cross entries "
            f"written {cross_set}; launches {launches}")
        if not (len(calls) == want == out["frame_calls_launched"]
                and finite and cross_set
                and out["encoder_wgmma"] == len(enc_calls) > 0
                and all(0 <= t_ < cfg.vocab_size for s_ in streams
                        for t_ in s_)):
            raise AssertionError(f"{tag}: the frames path failed its checks")
        return out

    def smoke_launchers():
        """4s: ``launch/serve.py --smoke`` on the card at the widths no
        kernel is built for (float32 smoke configs: whisper-medium 16,
        jamba 16, qwen2-vl 32, deepseek-v2 MLA (24, 16) and (40, 32)),
        dense and paged, each run again forced to the plain versions:
        identical tokens, and every kernel of the path launched in the
        kernel run."""
        from repro_torch.launch import serve as launch_serve

        out = {}
        for arch in ("whisper-medium", "qwen2-vl-2b", "deepseek-v2-236b",
                     "jamba-1.5-large-398b"):
            for layout in ("dense", "paged"):
                argv = ["--arch", arch, "--smoke", "--requests", "4",
                        "--tasks", "2", "--slots", "2", "--max-new", "6"]
                if layout == "paged":
                    argv += ["--kv-layout", "paged", "--block-size", "4"]
                runs = {}
                for impl in (None, "torch"):
                    ops.set_default_impl(impl)
                    set_counts()
                    try:
                        metrics = launch_serve.main(argv)
                    finally:
                        ops.set_default_impl(None)
                    torch.cuda.synchronize()
                    runs[impl] = (metrics["tokens"], counts())
                (toks, c), (ptoks, pc) = runs[None], runs["torch"]
                need = ["flash_attention"] + (["paged_flash_decode"]
                                              if layout == "paged" else [])
                ok = (toks == ptoks and all(c[k_] > 0 for k_ in need)
                      and not any(pc[k_] for k_ in need))
                key = f"{arch} smoke {layout}"
                out[key] = {"tokens_equal_plain": toks == ptoks,
                            "launches": c}
                paths[key] = c
                log(f"[{key}] on the card: tokens {toks}; equal to the "
                    f"plain run's: {toks == ptoks}; launches {c}")
                if not ok:
                    raise AssertionError(f"[{key}]: the kernel run and the "
                                         "plain run disagree, or a kernel "
                                         "was not launched")
        return out

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
    # 4o: deepseek-v2-236b (MLA, Dv != D in the flash and paged kernels)
    # and jamba-1.5-large-398b (the hybrid's SSM-state handoff) at full
    # width, depth 2, each checked against the plain path on its models
    for arch in ("deepseek-v2-236b", "jamba-1.5-large-398b"):
        report[arch] = family_path(arch)
        paths[f"{arch} dense"] = report[arch]["launches"]
        paths[f"{arch} paged"] = report[arch]["paged"]["launches"]
        log(f"[{arch}] phase 4o: {report[arch]['phase_s']:.1f}s")
    # 4n: the dense smollm-360m and stablelm-1.6b, compress -> dense and
    # paged serving at full width and (since PR 30) depth 8, then their
    # depth-2 check (phase 5)
    for arch in ("smollm-360m", "stablelm-1.6b"):
        t_phase = time.perf_counter()
        report[arch] = main_path(arch, (), base_geom, profile=False, depth=8)
        paths[f"{arch} dense"] = report[arch]["launches"]
        paths[f"{arch} paged"] = report[arch]["paged"]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        report[arch]["kernel_vs_plain"] = kernel_vs_plain(arch, base_geom)
        gc.collect()
        torch.cuda.empty_cache()
        report[arch]["phase_s"] = time.perf_counter() - t_phase
        log(f"[{arch}] phases 4n and 5: {report[arch]['phase_s']:.1f}s")
    t_phase = time.perf_counter()
    report["train"] = memcom_train_path("gemma2-2b")
    paths["gemma2-2b train"] = report["train"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    report["train"]["kernel_vs_plain"] = train_kernel_vs_plain("gemma2-2b")
    report["train"]["phase_s"] = time.perf_counter() - t_phase
    log(f"[gemma2-2b train] phases 4d and 5b: "
        f"{report['train']['phase_s']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mgeom = (768, MT, msources[:2], 768 + 24 + max_new + 16)
    # depth 16 of 32, to keep the run within its time limit with 4q-4s
    # (the whole run took 996 s of its 1200 s on an H100 at full depth)
    report["mistral-7b"] = main_path("mistral-7b", (), mgeom,
                                     then=mistral_then, depth=16)
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
    gc.collect()
    torch.cuda.empty_cache()

    # after mistral-7b, so that the profiled training steps come after its
    # timed phases: granite-moe-3b-a800m Phase 1 (4j) and mamba2-370m LM
    # training (4k) at full width, each with its depth-2 kernel-vs-plain
    # gradients (phase 5)
    for key, path, vs_plain in (
            ("granite-moe-3b-a800m train",
             lambda: memcom_train_path("granite-moe-3b-a800m"),
             lambda: train_kernel_vs_plain("granite-moe-3b-a800m")),
            ("mamba2-370m train", mamba_train_path,
             mamba_train_kernel_vs_plain)):
        t_phase = time.perf_counter()
        report[key] = path()
        paths[key] = report[key]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        train_s = time.perf_counter() - t_phase
        report[key]["kernel_vs_plain"] = vs_plain()
        gc.collect()
        torch.cuda.empty_cache()
        report[key]["phase_s"] = time.perf_counter() - t_phase
        log(f"[{key}] training and its depth-2 check: "
            f"{report[key]['phase_s']:.1f}s (training {train_s:.1f}s)")

    # 4l, 4m: the ICAE baselines at full width (gemma2-2b: the three
    # variants; mistral-7b: icae++ at depth 8 since PR 30, the target and
    # compressor 7.7 GB of bf16 weights: its 32 layers' checkpoint write
    # and restore took ~80 s of the run's time limit), each with its depth-2
    # kernel-vs-plain check (phase 5); mistral-7b's restart runs its steps
    # without Trainer.run's last checkpoint
    mgeom = (768, MT, msources[:2], None)
    icae_m_depth = 8
    for arch, geom, runs, vs_batch, restart_run, depth in (
            ("gemma2-2b", base_geom, (("icae++", 4, 2, True),
                                      ("icae", 2, None, False),
                                      ("icae+", 2, None, False)), 2, True,
             None),
            ("mistral-7b", mgeom, (("icae++", 3, 1, True),), 1, False,
             icae_m_depth)):
        t_phase = time.perf_counter()
        key = f"{arch} icae"
        report[key] = icae_train_path(arch, geom, runs, restart_run, depth)
        for variant, res in report[key].items():
            paths[f"{arch} {variant} compress"] = res["compress"]["launches"]
            paths[f"{arch} {variant} train"] = res["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        train_s = time.perf_counter() - t_phase
        report[key]["kernel_vs_plain"] = icae_kernel_vs_plain(
            arch, geom, [r[0] for r in runs], vs_batch)
        gc.collect()
        torch.cuda.empty_cache()
        report[key]["phase_s"] = time.perf_counter() - t_phase
        log(f"[{key}] training and its depth-2 check: "
            f"{report[key]['phase_s']:.1f}s (training {train_s:.1f}s)")
    mcfg = cut_depth(get_config("mistral-7b"), icae_m_depth)
    icpp = report["mistral-7b icae"]["icae++"]
    reckoned = (2 * 2 * mcfg.param_count() + icpp["trained_params"] * (2 + 12)
                + mcfg.num_layers * 2 * (MT + 768) * mcfg.d_model * 2)
    log(f"[mistral-7b icae++] peak memory {icpp['peak_bytes']} bytes against "
        f"{reckoned} reckoned (two bf16 copies of the weights, bf16 "
        f"gradients and float32 AdamW moments and master of the trained "
        f"tensors, remat's saved block inputs)")
    icpp["reckoned_bytes"] = reckoned

    # 4p: deepseek-v2-236b MemCom Phase 1 at full width, depth 2 (its MLA
    # at (192, 128) through the wgmma flash backward), then its depth-2
    # Phase-1 and Phase-2 gradients against the plain path (phase 5)
    key = "deepseek-v2-236b train"
    t_phase = time.perf_counter()
    report[key] = memcom_train_path("deepseek-v2-236b",
                                    family_cfg("deepseek-v2-236b"))
    paths[key] = report[key]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    train_s = time.perf_counter() - t_phase
    report[key]["kernel_vs_plain"] = train_kernel_vs_plain(
        "deepseek-v2-236b", family_cfg("deepseek-v2-236b"))
    gc.collect()
    torch.cuda.empty_cache()
    report[key]["phase_s"] = time.perf_counter() - t_phase
    log(f"[{key}] phases 4p and 5: {report[key]['phase_s']:.1f}s (training "
        f"{train_s:.1f}s)")

    # 4q: qwen2-vl-2b (M-RoPE, 12/2 x 128: a GQA group of 6) and 4r:
    # whisper-medium (enc-dec, 16 x 64, 1500 frames) at full width and
    # depth, each then checked against the plain path at depth 2 (phase
    # 5); whisper's frames path runs on the models of its main path
    for arch, then in (("qwen2-vl-2b", None),
                       ("whisper-medium", whisper_frames)):
        t_phase = time.perf_counter()
        report[arch] = main_path(arch, (), base_geom, then=then)
        paths[f"{arch} dense"] = report[arch]["launches"]
        paths[f"{arch} paged"] = report[arch]["paged"]["launches"]
        if then is not None:
            paths[f"{arch} frames"] = report[arch]["then"]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        report[arch]["kernel_vs_plain"] = kernel_vs_plain(arch, base_geom)
        gc.collect()
        torch.cuda.empty_cache()
        report[arch]["phase_s"] = time.perf_counter() - t_phase
        log(f"[{arch}] phases {'4q' if then is None else '4r'} and 5: "
            f"{report[arch]['phase_s']:.1f}s")
    # 4s: the smoke launchers at the padded widths
    t_phase = time.perf_counter()
    report["smoke_launchers"] = smoke_launchers()
    log(f"[smoke launchers] phase 4s: {time.perf_counter() - t_phase:.1f}s")

    # 4t: whisper-medium MemCom Phase 1 at full width and depth, 1500
    # frames a sample (the flash backward over the frames at 16 x 64, the
    # encoder forward only), and 4u: qwen2-vl-2b's (12/2 x 128, a GQA
    # group of 6), each then its depth-2 Phase-1 and Phase-2 gradients
    # against the plain path (phase 5)
    for arch, phase_name in (("whisper-medium", "4t"), ("qwen2-vl-2b", "4u")):
        key = f"{arch} train"
        t_phase = time.perf_counter()
        report[key] = memcom_train_path(arch)
        paths[key] = report[key]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        train_s = time.perf_counter() - t_phase
        report[key]["kernel_vs_plain"] = train_kernel_vs_plain(arch)
        gc.collect()
        torch.cuda.empty_cache()
        report[key]["phase_s"] = time.perf_counter() - t_phase
        log(f"[{key}] phases {phase_name} and 5: "
            f"{report[key]['phase_s']:.1f}s (training {train_s:.1f}s)")

    # 4v: tensor-parallel serving of gemma2-2b on gloo meshes of ranks
    # that share the card (a rank's all_reduce goes through the host: no
    # rate of this phase is a performance figure), each run held to the
    # one-rank engine on the same seeded weights (docstring, 4v): 2 ranks
    # at full width and depth, 2 ranks at depth 2 in float32, 4 ranks at
    # depth 2, and a 1x1 nccl mesh through launch/serve.py's entry
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import run_ranks

    def tp_phase():
        spec = dict(arch="gemma2-2b", depth=None, dtype=None, model=0,
                    sources=sources, prompts=prompts, slots=slots,
                    max_len=max_len, max_new=max_new, budget=1024)
        zero = {k: 0 for k in counts()}
        # name, overrides, ranks, and the rule on the first decode step's
        # logits (plain.scaled_err against the one-rank engine's).  bf16:
        # twice the largest distance of the one-rank engine from itself
        # when its prompt calls take the wgmma flash kernel in place of
        # mma.sync (0.1205 dense / 0.1441 paged at full depth, 0.0233 /
        # 0.0117 at depth 2; NVIDIA H100 80GB HBM3, 700 W): a split's sums
        # in another order move the logits as far as a kernel choice does.
        runs = (("tp2", {}, 2, 0.3),
                ("tp2_depth2_float32", dict(depth=2, dtype="float32"), 2,
                 REL_TOL["float32"]),
                ("tp4_depth2", dict(depth=2), 4, 0.05))
        refs = {}
        t1 = time.perf_counter()
        for name, over, _, _ in runs:
            gc.collect()
            torch.cuda.empty_cache()
            refs[name] = tp_serve(0, 1, dict(spec, **over))
        gc.collect()
        torch.cuda.empty_cache()
        # every run in one spawn of 4 ranks (a spawn costs ~10 s); ranks 2
        # and 3 sit out the 2-way runs
        per_rank = run_ranks(
            tp_runs, 4, ([dict(spec, model=n, **over)
                          for _, over, n, _ in runs],),
            backend="gloo", device="cuda", timeout=600)
        out = {"seconds_runs": time.perf_counter() - t1}
        for i, (name, over, n, rule) in enumerate(runs):
            ref, ranks = refs[name], [res[i] for res in per_rank[:n]]
            row = {"ranks": n, "depth": over.get("depth"),
                   "dtype": over.get("dtype", "bfloat16"), "rule": rule,
                   "ref_tokens": ref["tokens"], "ref_seconds": ref["seconds"],
                   "rank_seconds": [r["seconds"] for r in ranks],
                   "peak_bytes": [r["peak_bytes"] for r in ranks],
                   "local_kv_heads": [r["local_kv_heads"] for r in ranks],
                   "launches": [r["launches"] for r in ranks],
                   "shapes": ranks[0]["shapes"]}
            for layout in ("dense", "paged"):
                got = ranks[0]["tokens"][layout]
                want = ref["tokens"][layout]
                first = [next((i for i, (a, b) in enumerate(zip(g, w))
                               if a != b), None) for g, w in zip(got, want)]
                same_ranks = all(
                    r["tokens"][layout] == got
                    and np.array_equal(r["logits"][layout],
                                       ranks[0]["logits"][layout])
                    for r in ranks)
                a, b = ranks[0]["logits"][layout], ref["logits"][layout]
                se = plain.scaled_err(torch.from_numpy(a),
                                      torch.from_numpy(b))
                rel_ = float(np.abs(a - b).max() / np.abs(b).max())
                row[layout] = {"tokens": got, "first_diff": first,
                               "logits_scaled_err": se, "logits_rel": rel_,
                               "ranks_agree": same_ranks}
                log(f"[4v {name}] {layout}: tokens {got}; one-rank engine "
                    f"{want}; first differing position per request {first}; "
                    f"first decode step's logits against the one-rank "
                    f"engine's: scaled err {se:.3e}, {rel_:.3e} of the "
                    f"largest; rule scaled err <= {rule:.3e} and the same "
                    f"tokens; every rank's tokens and logits the same: "
                    f"{same_ranks}")
                if not same_ranks or se > rule or got != want:
                    raise AssertionError(f"[4v {name}] {layout}: the ranks "
                                         "disagree, or their tokens or "
                                         "logits leave the one-rank "
                                         "engine's")
            for r, res in enumerate(ranks):
                c = res["launches"]
                paths[f"gemma2-2b {name} rank{r}"] = {**zero, **c}
                if min(c["flash_attention"], c["memcom_xattn"],
                       c["paged_flash_decode"]) <= 0 or res["compiled"] != 1:
                    raise AssertionError(f"[4v {name}] rank {r}: a kernel "
                                         f"was not launched ({c}) or the "
                                         "online task was not compiled")
                log(f"[4v {name}] rank {r}: mesh {res['mesh']}, "
                    f"{res['local_kv_heads']} KV heads, launches {c}, peak "
                    f"memory {res['peak_bytes']} bytes, "
                    f"{res['seconds']:.1f}s in the rank")
                # its kernel calls (each held to plain in the rank): q, the
                # keys or pool, variant, split count, calls, scaled error
                log(f"[4v {name}] rank {r} kernel calls: " + "; ".join(
                    f"{x['kernel']} {x['q']}/{x.get('kv', x.get('pool'))} "
                    f"{x.get('variant', '-')} {x['nsplit']} x{x['calls']} "
                    f"{x['scaled_err']:.1e}" for x in res["shapes"]))
            out[name] = row
        # a 1x1 nccl mesh through the launcher's entry
        t1 = time.perf_counter()
        argv = ["--arch", "gemma2-2b", "--requests", "4", "--tasks", "2",
                "--max-new", "8"]
        runs = {}
        for name, extra in (("plain", []), ("mesh", ["--mesh", "1"])):
            gc.collect()
            torch.cuda.empty_cache()
            set_counts()
            metrics = launch_serve.main(argv + extra)
            torch.cuda.synchronize()
            runs[name] = (metrics["tokens"], counts())
        (toks, _), (mtoks, mc_) = runs["plain"], runs["mesh"]
        paths["gemma2-2b 1x1 nccl mesh"] = mc_
        log(f"[4v 1x1 nccl] launcher tokens {mtoks}; without a mesh "
            f"{toks}; equal {mtoks == toks}; launches {mc_}")
        if mtoks != toks or min(mc_["flash_attention"],
                                mc_["memcom_xattn"]) <= 0:
            raise AssertionError("[4v 1x1 nccl] the launcher's 1x1 mesh "
                                 "left the unsplit tokens or launched no "
                                 "kernel")
        out["mesh_1x1"] = {"tokens_equal": True, "launches": mc_,
                           "phase_s": time.perf_counter() - t1}
        return out

    t_phase = time.perf_counter()
    report["tp"] = tp_phase()
    report["tp"]["phase_s"] = time.perf_counter() - t_phase
    log(f"[4v] tensor-parallel serving phase: "
        f"{report['tp']['phase_s']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. each path's share of the card's peak -------------------------
    from repro_torch.config import ShapeSpec
    from repro_torch.launch import costs, roofline

    def share(path, cfg, objective, batch, seq, seconds, split=None):
        """The analytic FLOPs and bytes of what ``path`` ran in ``seconds``
        (``launch/costs.py`` at the shape, split and depth it ran; a
        compress costed as a prefill, as the reference's dry run maps it;
        a Phase-1 step by ``memcom_train_cost(phase=1, split=)``) through
        ``launch/roofline.py``'s ``analyze`` at one card, and the shares
        of the card's peak that the measured seconds give."""
        shape = ShapeSpec(path, seq, batch, objective)
        if objective == "memcom_train":
            cc = costs.memcom_train_cost(cfg, shape, phase=1, split=split)
        else:
            cc = costs.cell_cost(cfg, shape, {"compress": "prefill"}.get(
                objective, objective))
        rec = roofline.analyze({
            "arch": cfg.name, "shape": f"{batch}x{seq}",
            "objective": objective, "chips": 1,
            "analytic": {"flops": cc.flops, "hbm_bytes": cc.hbm_bytes,
                         "model_flops": cc.model_flops},
            "collectives": {"total": 0.0},
            "collectives_full": {"total": 0.0}})
        out = {"path": path, "arch": cfg.name, "objective": objective,
               "batch": batch, "seq": seq, "split": split,
               "flops": cc.flops, "model_flops": cc.model_flops,
               "hbm_bytes": cc.hbm_bytes, "compute_s": rec["compute_s"],
               "memory_s": rec["memory_s"], "dominant": rec["dominant"],
               "s": seconds,
               "hw_flops_share": cc.flops / (seconds * roofline.PEAK_FLOPS),
               "mfu": cc.model_flops / (seconds * roofline.PEAK_FLOPS),
               "roofline_share": max(rec["compute_s"], rec["memory_s"])
               / seconds}
        return out

    shares = []
    for key, arch, cfg_ in (
            ("train", "gemma2-2b", None),
            ("granite-moe-3b-a800m train", "granite-moe-3b-a800m", None),
            ("deepseek-v2-236b train", "deepseek-v2-236b",
             family_cfg("deepseek-v2-236b")),
            ("whisper-medium train", "whisper-medium", None),
            ("qwen2-vl-2b train", "qwen2-vl-2b", None)):
        r = report[key]
        shares.append(share(f"{arch} Phase-1 step", cfg_ or get_config(arch),
                            "memcom_train", r["batch"], r["seq"],
                            r["s_per_step"], split=r["split"]))
    r = report["mamba2-370m train"]
    shares.append(share("mamba2-370m LM step", get_config("mamba2-370m"),
                        "lm_train", 2, T, r["s_per_step"]))
    # the second task's compress (the first warms the path); whisper's
    # main path runs no encoder (no frames), so its cost leaves the
    # encoder out; its frames path's compress runs it
    for arch, depth, src in (
            ("gemma2-2b", None, sources), ("granite-moe-3b-a800m", None,
                                           sources),
            ("smollm-360m", 8, sources), ("stablelm-1.6b", 8, sources),
            ("mistral-7b", 16, msources), ("qwen2-vl-2b", None, sources),
            ("whisper-medium", None, sources),
            ("deepseek-v2-236b", "family", sources),
            ("jamba-1.5-large-398b", "family", sources)):
        cfg_ = (family_cfg(arch) if depth == "family"
                else cut_depth(get_config(arch), depth))
        if arch == "whisper-medium":
            cfg_ = cfg_.replace(encoder=None)
        shares.append(share(f"{arch} compress", cfg_, "compress", 1,
                            len(src[1]), report[arch]["task_compress_s"][1]))
    wf = report["whisper-medium"]["then"]
    shares.append(share("whisper-medium compress with frames",
                        get_config("whisper-medium"), "compress", 1,
                        len(sources[1]), wf["compress_s"] / len(sources)))
    r = report["mamba2-370m"]
    shares.append(share("mamba2-370m prefill", get_config("mamba2-370m"),
                        "prefill", 1, r["prefill_tokens"],
                        min(r["prefill_s"])))
    # the dense decode: serve seconds over decode steps, at the slots and
    # the cache length the serve reached (m + the longest prompt + max_new)
    d = report["gemma2-2b"]["dense"]
    shares.append(share("gemma2-2b dense decode step", get_config("gemma2-2b"),
                        "decode", slots, m + prompt_len + max_new,
                        d["serve_s"] / d["decode_steps"]))
    report["shares"] = shares
    for sh in shares:
        log("share " + json.dumps(sh))
    over = [sh["path"] for sh in shares
            if max(sh["hw_flops_share"], sh["roofline_share"]) > 1.05]
    if over:
        raise AssertionError(f"a share of the card's peak above 1.05, which "
                             f"no card gives (the cost model or the timing "
                             f"is wrong): {over}")

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
            ("moe_gmm:gmm", gmm_rows, "C768_512to1536"),
            ("ssd_scan:ssd", ssd_rows, "prefill"),
            ("flash_attention:flash_attention_bwd", flash_bwd_rows,
             "memory_self_bwd"),
            ("memcom_xattn:memcom_xattn_bwd", mx_bwd_rows,
             "memory_xattn_bwd"),
            ("moe_gmm:gmm_bwd", gmm_bwd_rows, "memory_bwd_1536_512"),
            ("ssd_scan:ssd_bwd", ssd_bwd_rows, "train")):
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
                    "flash_attention_bwd", "memcom_xattn_bwd", "gmm_bwd",
                    "ssd_bwd"):
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
        if name == "gmm_bwd":  # dX (the Phase-1 path's call) and dW; the
            # wgmma and mma.sync variants
            entries[-1].update(
                dx_launches=sum(c["gmm_bwd_dx"] for c in paths.values()),
                dw_launches=sum(c["gmm_bwd_dw"] for c in paths.values()),
                bwd_wgmma_launches=sum(c["gmm_bwd_wgmma"]
                                       for c in paths.values()),
                variant=head["variant"],
                **{k: head[k] for k in head
                   if k.endswith(("_dw", "_both", "_wgmma", "_mma_sync"))})
        if name == "ssd_bwd":  # the chunked and sequential variants
            entries[-1].update(
                bwd_chunked_launches=sum(c["ssd_bwd_chunked"]
                                         for c in paths.values()),
                variant=head["variant"],
                **{k: head[k] for k in head
                   if k.startswith(("ms_", "device_ms_", "workspace_"))})
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
    # each kernel's numbers at its head shape, and under "shapes" those of
    # every timed shape (the json-out file has each row in full)
    brief = ("shape", "variant", "ms", "device_ms", "bound_ms", "bound_by",
             "plain_ms", "library_ms", "library_device_ms")
    log(json.dumps({"kernels": [
        {**{k: v for k, v in e.items() if k != "shapes"},
         "shapes": [{k: r[k] for k in brief if k in r}
                    for r in e["shapes"] if "ms" in r]}
        for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
