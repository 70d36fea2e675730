#!/usr/bin/env python3
"""Chip smoke test of the PyTorch package on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each fatal on failure:

1. device  — requires CUDA; prints the card's name and power limit
   (nvidia-smi) and pins fp32 products to full fp32 (no TF32).
2. build   — compiles the DPU kernels from src/repro_torch/kernels/csrc
   with nvcc (sm_90a) and loads them.
3. kernels — at the main path's shapes (N in {1, 16} signals of
   L in {48,000, 192,000, 1,440,000} samples: 1, 4 and 30 s at 48 kHz,
   T = 98, 398 and 2,998 feature frames) holds each kernel against its plain
   PyTorch version on the same inputs, and times the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (CUDA events; each sample is one call queued behind a spin kernel,
   so host overhead is not timed; median of 25 after warm-up). bound_ms is
   the larger of bytes / 3.35 TB/s and fp32 operations / 67 TFLOP/s (H100
   SXM data-sheet peaks). The resample kernel reads the unpadded stack and
   zero-pads it itself (pad_left = 72); its library call, F.conv1d with
   padding 72 on the same stack, is checked once against the plain
   version; it is also timed cold (cold_ms, as mel's below) and through
   the serve path's whole call, ops.audio_resample_batch on the unpadded
   stack (path_ms). Its bound counts the unpadded signal. The mel kernel takes the resampled signal and
   frames it itself (one launch: a shared-memory FFT, then each filter's
   band of bins); it is also held against the reference's dense products
   (kernels/ref.py) evaluated in float64, and the fp32 dense products'
   own distance from those is printed as dense32_err (they are timed as
   dense_ms, their bound is dense_bound_ms), and
   torch.fft.rfft -> power -> @ fb -> log on the same frames is timed as
   composite_ms (four calls: context, not a library_ms). Its bound counts
   its own traffic (the samples its frames cover, window, twiddles, band
   weights, output) and its own work (window, a real FFT of 5 n/2 log2 n
   operations a frame, power, band sums, log). Its cold_ms is timed with
   each sample preceded by a write of a 128 MB buffer, which flushes the
   50 MB L2. The normalize kernel (a thread block cluster an utterance)
   takes the mel kernel's features, whose band 2 is empty (a constant
   column: its exact output is 0); it reports that band's error apart
   (band2_max_abs_err against the plain version, band2_max_abs against 0),
   cold_ms, path_ms (ops.audio_normalize_batch) and its plan (cluster size,
   staged); its library call, F.instance_norm, is checked once against the
   plain version; and every row of the N = 16 stack must equal, bit for
   bit, the same utterance normalized alone.
4. serve   — PREBA's audio serving path through the package's entry points:
   16 requests carrying 48 kHz audio through the DPU service (wall clock,
   kernels on the service's stream) into the pipelined runtime over
   full-width tinyllama-1.1b in bf16 with seeded weights. Every request
   must be served, its features finite, [98, 80] and equal to the plain
   CPU pipeline (rtol 1e-3, atol 1e-2); every audio kernel's launch count
   in this run must be > 0 and equal the service's launched groups, and no
   image kernel may launch.
5. image kernels — at N in {1, 16} images of 256 x 256 and 512 x 512, and
   N in {1, 4} of 384 x 512 (the per-FU group of phase 6), holds the IDCT,
   resize (to 256 x 256) and crop-normalize (224 x 224) kernels against
   their plain versions and times them as phase 3 does; the IDCT and
   crop-normalize also cold (cold_ms, as mel's). Crop-normalize must equal
   its plain version bit for bit (a subtract, then a multiply, each rounded
   in fp32). Resize's library
   call is F.interpolate (bilinear, align_corners=False, no antialias),
   checked once against the plain version at each shape. The resize kernel
   (one launch, a two-tap gather) is also held against the dense products
   Ry @ img @ Rx^T (kernels/ref.py, timed as dense_ms); its bytes count
   the image, the output and the taps (16 bytes an output row and column),
   and the dense products' bound is reported beside it as dense_bound_ms.
6. image serve — PREBA's image serving path: 20 requests carrying JPEG
   coefficient payloads through an image DPU service into a second
   pipelined runtime over the same weights: 16 of 512 x 512 sharing the
   luminance table of ITU-T T.81 Annex K (Table K.1), which take the fused
   path, and 4 of 384 x 512 whose tables differ (K.1 x 0.5 and x 2), which
   take the per-functional-unit path. Every request must be served, its
   features finite, [224, 224] and equal to the plain CPU pipeline (rtol
   1e-3, atol 1e-2), and no audio kernel may launch. The image kernels'
   launch counts must equal what the launched groups imply: a group of n
   requests is padded to a stack of m = next_pow2(n); if every qtable of
   the stack equals the first it is fused (ops.image_pipeline_batch), else
   it takes the per-FU path, which decodes request by request. So per group
       jpeg_idct       += 1 if fused else m
       image_resize    += 1          (one launch for the stack)
       image_normalize += 1
7. decode kernel — holds the flash-decode attention kernel against its
   plain version at the JAX package's test shapes (B, H, KH, D, S) =
   (2, 8, 4, 64, 512), (1, 7, 7, 128, 300), (4, 16, 16, 64, 1024), each at
   fp32 and bf16, at the serve shapes (8, 32, 4, 64, 144) and
   (8, 32, 4, 64, 2048) in bf16, and at h2o-danube's decode shape
   (8, 32, 8, 80, 4096) at fp32 and bf16, valid_len drawn in [1, S] (tolerance 2e-4
   at fp32, 3e-2 at bf16), plus one row with valid_len = 0 (the mean of
   V). The serve shape's output at S = 144 must equal, bit for bit, the
   same rows' at S = 2,048 with noise past valid_len (a row's bits depend
   on its valid prefix only). Prints how many of the serve shape's
   clusters the card holds at once and a launch floor (the time of a
   1-element fill). Times the kernel, the plain version and
   F.scaled_dot_product_attention (boolean mask, enable_gqa=True); the
   bound counts the K and V of the valid positions read once. Then times
   one full-width decode step (22 layers, 8 slots, a 144-slot ring) with
   the kernel and with its plain version swapped in, in turns, and
   profiles five steps (torch.profiler): the device time and kernel
   launches a step, decode attention's share of it, and the device's busy
   share of the step.
8. run-to-completion serve — 16 requests (all submitted at once) through
   the engine with continuous=False over the same weights: all served,
   tokens in range; lm.generate must equal the sequential decode loop
   token for token on the card.
9. chunked + prefix serve — continuous batching with chunk_lens (32, 64)
   and a prefix cache over 20 requests of 80-120 prompt tokens, 16 of them
   sharing one 64-token template (a served system prompt) and 4 cold: all
   served, prefix_hits > 0, and per request the tokens of the same 20
   requests served monolithically with no cache. Where they differ, the
   first diverging step must be a near-tie (top-2 logit gap under 3e-2 in
   the monolithic path's logits at that step); the count is printed.

10. fleet — PREBA's multi-slice system shape: 4 slices, each an engine
   with 8 KV slots on its own CUDA stream, all serving one LM, behind
   the pipelined runtime and one wall-clock DpuService. 32 requests carry
   48 kHz audio (1 s) and prompts of 33-63 tokens (mean 48; one prompt
   bucket, so every admission has one shape), 8 new tokens each,
   hedge_factor 3.0. Every request completes exactly once, its features
   are finite [98, 80] and equal the plain CPU pipeline, and its tokens
   equal, bit for bit, a single-slice engine's on the same weights;
   conservation holds, 0 shed, 0 dead, breaker_trips 0, cpu_fallback 0;
   the audio kernels' launches equal the service's groups, and decode
   attention's equal n_layers x the decode steps of every engine built
   (MultiSliceEngine.decode_steps_total).
11. chaos — the same fleet (a virtual-clock DpuService) under
   faults.replay_virtual with a fixed FaultPlan: a dpu_fail of 3 launches
   (breaker_threshold 2), a slice_fail with a heal window (its in-flight
   requests requeued), stragglers, and a resize_abort to 2 slices after
   the slice is readmitted. The
   breaker must trip, serve requests on its CPU path (cpu_fallback > 0),
   and close; the audio kernels must launch again after it closes; the
   failed slice is quarantined, probed and readmitted; every completed
   request's tokens equal the single-slice engine's; conservation holds
   over completed, shed and dead; the injector's log is printed, with the
   bytes of slot pools the warm partition cache holds.
12. knee calibration — launch/serve.py's `_calibrate_knee` (the paper's
   offline profiling pass, §3.2) on full-width tinyllama-1.1b, bf16, seeded
   weights: for each context bucket up to the engine's 128-token prompt
   limit (two 64-token buckets: contexts 32 and 96) a padded context is
   prefilled and one lm.decode timed with the cache resident at batch 1,
   2, 4 and 8 (device-synchronized, best of 3). Prints each point's wall
   ms beside its device ms (torch.profiler over 3 steps), and each
   bucket's Batch_knee and Time_knee; the profiles are written to
   build/knee_profiles.json and must read back equal. Decode attention's
   launches must equal n_layers x the decode steps the pass ran.
13. controller — PREBA's closed partition loop: a fleet that starts at 1
   slice (8 KV slots, segment 8, 16 new tokens, so a request spans two
   engine steps) behind the pipelined runtime and a virtual-clock
   DpuService, with an online PartitionController (menu 1, 2, 4) and
   phase 12's knee profiles, driven by faults.replay_virtual at one tick a
   segment of 8 decode steps (0.036 s). The trace: 48 requests of a phased
   WorkloadSpec, each with 1 s of 48 kHz audio — a quiet phase of long
   prompts (4 /s, mean 100 tokens, 0.5 s), then a burst of short ones
   (400 /s, mean 12 tokens). Replayed twice: the two decision logs and the
   two sets of tokens must be byte-identical; at least one switch;
   fleet_reconfigs_total == decisions == reconfig spans; conservation;
   every rid served once, 0 dead; the audio kernels' launches equal the
   service's groups and decode attention's n_layers x the decode steps of
   every engine built. Prints the switches (t, from, to, reason) and the
   sha256 of decisions_json(). Then the same trace with the analytical knee
   profiles of the reduced model (the port's CPU test's): its log's sha256
   must be ANALYTICAL_LOG_SHA256, which tests/test_torch_partition_controller.py
   pins on the CPU (explicit profiles: the log depends on neither the
   model's width nor the backend).

14. two-model fleet — PREBA's multi-tenant shape, bench part 8's
   (benchmarks/bench_engine.py): full-width tinyllama-1.1b (phase 4's
   weights) and full-width mamba2-370m (48 layers, d_model 1,024, 32 SSM
   heads of 64, state 128; bf16, seed-0 weights), 2 slices each (8 slots,
   segment 8, 16 new tokens), behind the pipelined runtime and a wall-clock
   DpuService. 32 requests with 1 s of 48 kHz audio, one Poisson stream a
   tenant at 40 /s merged by the multi-tenant generator, prompts lognormal
   (mean 24, sigma 0.05) in the one (16, 32] bucket, submitted as their
   arrival times pass. Gates: every request served once per tenant, 0 shed,
   0 dead; every rid's tokens equal its model's single-slice engine bit for
   bit; the routing audit shows no cross-tenant dispatch; no request on
   the CPU path; the audio kernels launch once a DPU group, decode
   attention 22 x the tinyllama tenant's decode steps (a mamba2 step
   launches none). Prints per tenant tokens/s, latency and TTFT p50/p99.
   Before the fleet: ssd_chunked against the sequential ssm_step
   recurrence in fp32 at mamba2's head shapes, L in {32, 64} (rtol = atol
   = 2e-3); the within-port SSM contracts at full width, 2 layers, bf16,
   bit for bit on tokens, conv and state rows and the next step's logits
   (join == alone, chained == sequential and multi-slice == single-slice
   gate; padded == unpadded is printed); and one full-width mamba2 decode
   step at batch 8, its wall ms and a torch.profiler pass.

15. new archs — the rest of the dense family and the MoE family at full
   width, bf16, seed-0 weights, one at a time: h2o-danube-1.8b (24 layers:
   a 4,096 sliding window, head size 80), granite-3-8b (40), yi-34b (8 of
   60), mixtral-8x22b (4 of 56: window 4,096, 8 experts top 2) and
   moonshot-v1-16b-a3b (8 of 48: a dense first layer, 64 experts top 6, 2
   shared); the cuts keep each arch's weights inside the card
   (NEW_ARCH_DEPTH). Per arch it prints the weight bytes and the free
   bytes after them (an 8-slot pool must fit), then serves 8 requests with
   1 s of 48 kHz audio, submitted at once, through a wall-clock DpuService into the pipelined
   runtime's continuous engine (8 slots, segment 8, 8 new tokens): all
   served once, 0 shed, features equal the plain CPU pipeline, tokens in
   the vocabulary, no CPU path, the audio kernels once a DPU group, decode
   attention n_attn_layers x the decode steps; it prints tokens/s and the
   slot pool's bytes. Then one decode step at batch 8 over a 144-slot ring
   (wall ms, best of two runs of 20; torch.profiler: device ms, launches,
   one decode attention a layer), and the within-port contracts in an
   8-slot pool, bit for bit on tokens, K/V and the next logits: join ==
   alone (gated for the dense archs; for MoE printed, not gated: a token's
   expert capacity depends on its decode group, and the JAX package's own
   join holds on tokens but not on logits, tests/test_torch_moe.py) and
   chained == sequential (gated). danube also serves one 4,000-token prompt
   (bucket 4,096 = the window; its prefill takes the blockwise attention)
   with 200 new tokens, so its 4,096-slot ring wraps at decode step 96: at
   step 150 every layer's kernel output must be within 3e-2 of attention
   over the same ring with each slot's true position and the window mask.
   Then the kernel's plain version takes its place, and its greedy tokens'
   agreement with the kernel run's is reported, served alone and fed the
   kernel run's tokens (beside a replay with the kernel, which must
   reproduce them), with the misses' logit margins and the two replays'
   largest logit difference before and after the wrap (random bf16
   weights give flat logits, so near-ties are common).

16. families — the last three families. First decode attention at their
   shapes, held against its plain version (2e-4 fp32, 3e-2 bf16) and
   timed beside SDPA with its bound, as phase 7 does: phi-3-vision's decode
   (B 8, H 32, KH 32: one query head a KV head, head size 96) over a
   144-slot and a 4,096-slot ring, valid_len drawn in [1, S], and
   whisper's cross-attention (B 8, H 8, KH 8, D 64, S 1,500, every
   position valid), fp32 and bf16. Then each arch at full width, bf16,
   seed 0. whisper-base through its model entry points (the engine does
   not serve it): 8 rows of stub frames [8, 1,500, 512] and 8-token
   prompts, prefill, generate 16 tokens; decode attention must launch (6
   self + 6 cross) x 15 decode steps; at step 8 every layer's kernel output
   within 3e-2 of its plain version; the decode loop fed the generated
   tokens must reproduce them, and its logits with the plain version in
   the kernel's place must stay within 3e-2 (the free-run greedy agreement
   is printed). phi-3-vision-4.2b (32 layers) and jamba-v0.1-52b (8 of 32:
   one block of 1 attention, 7 SSM and 4 MoE layers, ~26.5 GB) serve 8
   audio requests as phase 15 does, and hold its contracts (join ==
   alone gated for phi-3-vision, printed for jamba's MoE; chained ==
   sequential gated for both, jamba's SSM rows included); phi-3-vision
   also runs its image path (576 stub patch embeddings in a 608-token
   prompt, prefill, generate 16: 32 x 15 launches) and must refuse
   pos_offset with img_embeds. Per arch: weight bytes, cache bytes, a
   decode step's wall and device ms and its launches.
17. training — tinyllama-1.1b through the port's training path (no kernel
   of its own: loss, backward and AdamW in plain PyTorch, as the JAX
   package leaves them to XLA). (a) At full width cut to 2 layers, fp32,
   TF32 off, batch 2 x 128 of batch_iterator(seed=0): train_loss, every
   gradient leaf and grad_norm on the card against the CPU on the same
   weights (the loss within 1e-5 relative, each leaf's max abs difference
   within 1e-3 of its own max abs, grad_norm within 1e-3); remat off on
   the card is printed beside it. (b) All 22 layers, bf16 compute over an
   fp32 master, remat on, batch 4 x 2,048, seeded init_params, AdamW (lr
   3e-4, 2 warm-up steps) for 20 steps: every loss finite and the mean of
   the last 3 below the first 3; the median step wall ms after step 2,
   tokens/s, one step's device ms, launches and top kernels
   (torch.profiler), max_memory_allocated, and the model-FLOP share (6 N T
   plus 12 L d_model S T over the H100 SXM data-sheet bf16 dense peak of
   989 TFLOP/s). (c) At 2 layers, train() fails at step 6 with checkpoints
   every 5 and restarts in a temporary directory: latest_step 5, the
   restored leaves bit for bit the saved ones, 5 steps on restart. (d) The
   trained weights, cast to bf16 after the moments are freed, serve the
   quickstart's 12 text requests through build_engine: all served once, 0
   shed, decode attention 22 x the engine's decode steps.
18. tensor-parallel serve — tinyllama-1.1b, seed-0 weights, through
   core/steps.py's sharded serve steps on spawned ranks that share the card
   (gloo on CUDA tensors, collectives staged through host memory: NCCL
   refuses two ranks on one GPU; with a card a rank, NCCL): each rank cuts
   the head-padded weights to its shards (shard_params) and runs prefill
   of 8 x 64 prompts and 16 decode steps, the decode kernel on its local
   heads. (a) mesh (1, 2), all 22 layers, bf16, greedy on both sides: the
   first tokens equal the unsharded port's on the card except near-ties
   (top-2 gap < 3e-2), counted; the agreement over all 17 tokens printed.
   (b) mesh (1, 8), 2 layers, fp32: head padding active (4 KV heads
   replicated to 8: H 4, KH 1 a rank); (c) mesh (2, 2), 2 layers, fp32,
   rows split over data. In (b) and (c) the ranks are fed the unsharded
   run's tokens, and every step's logits must lie within 1e-4 of the
   unsharded logits' max abs and their greedy tokens equal except
   near-ties (top-2 gap < 1e-4), counted. The 2-layer model is under 1B
   parameters, which takes the seq-sharded small-serve layout; its ranks
   force that rule off, since the 22-layer model (1.1B) takes this head
   layout. Gated on every rank: decode-attention launches = layers x 16,
   and parameter bytes within 1% of the sharded leaves / tp + the
   replicated leaves. Printed: the backend, the world size, per-rank
   weight bytes, and the decode step's wall ms unsharded (tp 1, in this
   process) and at tp 2 (rank 0 of (a)).
19. tensor-parallel families — the MoE, SSM and hybrid families at full
   width through core/steps.sharded_prefill and sharded_decode on spawned
   gloo ranks that share the card: (d) moonshot-v1-16b-a3b, 2 of 48
   layers (its dense first layer and one MoE layer), mesh (2, 2), its 64 experts over 2 data ranks (expert
   parallel); (e) mixtral-8x22b, 1 of 56 layers and 1 decode step, (3,
   2), weight-gather (8 experts, d_model over 3 data ranks: each forward
   gathers the layer's expert leaves through host memory), 12 rows; (f)
   mamba2-370m, 24 of 48 layers, (1, 2) and (1, 4); (g) jamba-v0.1-52b, 8
   of 32 layers, (2, 2). First decode attention at the ranks' new shapes,
   held, timed and bounded as in phase 7. Each case runs the unsharded
   port in this process, fp32 then bf16 (seed-0 weights, 8 x 32 prompts,
   12 for (e), 8 greedy decode steps, 2 for (e)), each freed before the
   next, then the ranks (CUDA allocator on expandable segments), which
   draw their shards leaf by leaf on the card in turns and run both
   dtypes, fed the unsharded greedy tokens. fp32 runs with capacity factor
   E / top_k (no choice can drop): every step's logits must lie within
   1e-4 of the unsharded logits' max abs and the tokens equal except
   near-ties under it. bf16 runs at the config's capacity (1.25):
   agreement and near-ties printed, gated for mamba2 only (near-ties
   under 3e-2 exempt), since local MoE groups drop other tokens by design.
   Gated on every rank and dtype: decode-attention launches = attention
   layers x decode steps, each of its first and last step's calls held
   against the plain version on the rank's inputs at the rank shape, MoE
   layers run, weight bytes equal to its share of every cut leaf plus the
   replicated leaves, and the peak device bytes while cutting at most its
   shards plus one leaf in flight. `fam_four_card`, not run by default,
   serves jamba at full depth on four cards (NCCL).
20. small-serve on a mesh — the layout of models under 1B parameters
   (whisper-base, tinyllama-1.1b cut to 8 layers): the attention weights
   whole on every rank, no head padding, each attention cache cut along
   its sequence over `model` where the axis divides it, the decode kernel
   over each rank's cut returning each row's log-sum-exp, the ranks'
   outputs merged (distributed.ctx.merge_seq_shards). First decode
   attention with the lse at the ranks' shapes (row 0 with no valid key:
   o 0, lse -inf), held (o at the decode tolerance, lse within 1e-4),
   timed beside the plain version with the lse and SDPA's o, bounded.
   Then on spawned gloo ranks that share the card: (h2), (h4) whisper-base
   at full depth on (1, 2) and (1, 4), its 64-slot ring cut to 32 and 16
   slots, its 1,500-frame cross cache to 750 and 375; (i) tinyllama-1.1b at
   8 layers on (1, 2), its ring cut to 32 (rank 1's cut holds no valid key
   for the first 16 steps). 8 x 16 prompts (whisper with stub frames from
   a seed), 24 decode steps, fp32 then bf16, fed the unsharded port's
   greedy tokens. fp32: every step's logits within 1e-4 of the unsharded
   logits' max abs and tokens equal except near-ties under it. Gated on
   every rank and dtype: decode-attention launches = (self + cross
   attention layers) x steps, every one with the lse; each of the first
   and the last step's calls held against the plain version (a cut with
   no valid key among them); weight and cache bytes equal to its share of
   every cut leaf plus the whole ones. bf16: agreement printed. Printed:
   the decode step's wall ms unsharded and sharded.
21. sharded training — tinyllama-1.1b at full width, 2 of 22 layers,
   through core/steps.make_sharded_train_step on spawned gloo ranks that
   share the card, from the seed-0 state cut by the train rules (FSDP:
   d_model over `data`; TP over `model`: KV heads, or head_dim where the
   4 KV heads do not divide the axis, MLP, vocab), batch 4 x 256 of the
   seeded stream, attention on rows over every mesh axis (attn_dp_axes):
   (a) mesh (2, 2), KV heads cut; (b) (1, 8), head_dim cut, the 4 rows
   padded to 8. Two fp32 steps against make_train_step on one card from
   the same weights on the same batches, gated: the loss within 1e-5
   relative, grad_norm within 1e-4, each rank's cut of every gradient
   leaf handed to AdamW within 1e-4 of the whole leaf's max abs on one
   card, each rank's master and moment bytes exactly its share of every
   cut leaf plus the replicated ones. On (a) also: allreduce_compressed of the embedding,
   final norm and head gradients over `data`, bit for bit the formula on
   the data ranks' gathered int8 values and scales (gated); five bf16
   steps on one batch, the learning rate warming up from 3e-6, whose last
   loss must be below the first (gated), printed beside one card's.
   Printed: the steps' wall ms (after the first) sharded and on one card,
   max_memory_allocated a rank beside the same figure of the tree before
   the carry between blocks was cut over `model` and the loss stopped
   gathering its logits (PHASE21_PEAK_BEFORE). No kernel runs in it.
22. sharded training of the other families — the same step, one spawn of
   gloo ranks on the mesh (2, 2) for every case, batch 4 x 256 of each
   case's seeded stream (with its stub audio frames): (a) moonshot-v1-16b-
   a3b at full width, its dense first layer and one MoE layer (1.345 B
   parameters), 64 experts over `data` (expert parallel: moe_shard_map's
   all-to-alls); (b) mamba2-370m at full width, 8 of 48 layers (the SSM
   block's channels and heads over `model`); (c) whisper-base whole, 6
   encoder and 6 decoder layers over 1,500 frames (the encoder under
   FSDP, cross-attention); (d) mixtral at full width, 1 layer with 3
   experts (1.40 B parameters; weight-gather: the experts' d_model cut
   over `data`) and reduced jamba (one 8-layer block, EP). Phases 21 and
   22 run one harness (train_cases). Two fp32 steps each (lr 1e-4) against
   make_train_step on one card under phase 21's gates, each rank's cut of
   every gradient leaf held against the same cut of one card's (an MoE at
   capacity E / top_k, no drops, the router loss weighing 0: a mesh's is
   the mean of the data ranks' losses over their own tokens); on (a) also
   five bf16 steps on one
   batch on phase 21's schedule at the config's own capacity and router
   loss, whose last loss must be below the first (gated). Printed: each
   rank's master and peak bytes, the steps' wall ms sharded and on one
   card. No kernel runs in it.
23. the GPipe pipeline and the dry run — (a) distributed/pipeline.py on 4
   ranks (gloo sharing the card; NCCL with a card a rank where there are
   4), each stage 2 full-width tinyllama-1.1b decoder layers
   (lm._sublayer), 8 microbatches of [1, 512, 2,048], in fp32 and bf16:
   the outputs must equal (torch.equal) the same 8 layers applied
   microbatch by microbatch on one card, and at fp32 each stage's weight
   gradients of sum(out * r) must lie within 1e-6 of their max abs of one
   card's (gated); printed: the bubble fraction, ms a schedule step, the
   pipeline's wall against one card's. (b) The dry run
   (launch/dryrun.py, a subprocess on the CPU, a fake world of 256 or 512
   ranks) of tinyllama-1.1b train_4k and decode_32k on pod16x16 and
   train_4k on pod2x16x16, each gated on status ok and the JAX package's
   record keys; moonshot-v1-16b-a3b decode_32k on pod2x16x16 printed, not
   gated; printed: each cell's roofline terms, bottleneck, bytes a device,
   logical and sent wire bytes. (c) The count held against the card, on a
   1 x 1 mesh, full-width tinyllama-1.1b in bf16: the train step at 4 x
   2,048 and a decode step at B 8 against a 2,048-slot cache. Gated: the
   lowered step's argument bytes equal the real state's and inputs' bytes
   exactly, and the measured median step is no faster than the roofline's
   t_bound; printed: max_memory_allocated beside the count's
   bytes_per_device, and the step's share of the bf16 peak from the
   counted dot FLOPs. No kernel of the seven runs in (a) or (c)'s train
   step; (c)'s decode step runs decode attention, not counted in the
   kernels line.

24. several cards — (a) each of the seven kernels once at its serve shape
   on the last visible card, cuda:0 current, against its plain version
   on a CPU copy of its inputs at its tolerance; its output must lie on
   that card. (b) Phase 10's fleet (its weights on cuda:0, its 32
   requests) over every visible card, one slice a card, the DPU service
   on cuda:0, then resized N -> N/2 -> N (N = 1 on one card: three rounds
   of one slice), the same requests served after each resize. Gated per
   round: every request once, 0 shed, 0 dead, conservation, no CPU path;
   every slice's engine admitted one or more; the fleet holds one replica
   of the weights a card, each of their bytes, and no card's allocated
   bytes grew by a second copy; tokens equal phase 10's single-slice
   engine's bit for bit per rid; audio launches = the service's groups,
   decode attention = layers x the round's decode steps. (c) The real-DPU
   part of examples/serve_audio_preba_torch.py on the card (one 5 s
   utterance, one launch of each audio kernel), its features within
   rtol 1e-3, atol 1e-2 of the same part on the CPU; printed: the
   example's per-unit whole-call ms on 7.5 s. (d) The dry run of
   tinyllama-1.1b and yi-34b train_4k on pod16x16 (run in phase 23's
   subprocess): bytes a device at most twice the JAX package's record for
   tinyllama, under 80 x 10^9 for yi-34b (gated). Its fleet and example
   launches join the kernels line.

Every phase prints its seconds ("phase N seconds:").

In every serve phase (4, 6, 8-11, 13-17) the decode kernel's launches must
equal n_layers x the decode steps the engines executed (their own stats;
in phase 14 the tinyllama tenant's, in phases 15-16 the attention layers',
whisper's cross-attention sublayers included): every attention decode step
runs it once per layer. Any serve phase that injected no failure fails on a
breaker trip or a request served on the CPU path.

Prints one JSON line {"kernels": [...]} (seven kernels; a kernel's launches
are the sum over the phases that run it — decode_attention's over the seven
serve phases, the knee pass, the controller's first replay, phase 15's
six serves and phase 16's two serves, whisper's generate and phi-3-vision's
image path, phase 17's serve of the trained weights, and phase 18's,
phase 19's and phase 20's ranks' decode steps, summed over ranks, and
phase 24's fleet; the audio kernels' over phases 4, 10, 11, 13, 14, 15,
16 and 24's fleet and example;
its max_abs_err is the largest over all its shapes; worst_library_ratio is the
largest ms / library_ms over a kernel's shapes and worst_library_shape
where it falls, so a kernel that loses off its main shape shows), the
card's name and power limit, and last {"ok": true, "device": {...}}. With --out PATH the
per-shape kernel numbers and the serve statistics are also written to PATH
as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
# H100 SXM data-sheet peaks: HBM3 bytes/s, fp32 FLOP/s on the CUDA cores
from repro_torch.analysis.roofline import FP32_FLOPS as FP32_FLOPS_S  # noqa: E402
from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES_S  # noqa: E402
# audio (N, L) at 48 kHz: 1 s, 4 s and 30 s utterances (T = 98, 398, 2,998 frames)
SHAPES = [(1, 48_000), (16, 48_000), (1, 192_000), (16, 192_000), (1, 1_440_000),
          (16, 1_440_000)]
MAIN_SHAPE = (16, 48_000)  # the serve phase: one group of 16 payloads of 1 s
IMAGE_SHAPES = [(1, 256, 256), (16, 256, 256), (1, 512, 512), (16, 512, 512),
                (1, 384, 512), (4, 384, 512)]
IMAGE_MAIN_SHAPE = (16, 512, 512)  # the image serve phase's fused group
# decode attention (B, H, KH, D, S, dtype): the JAX package's test shapes,
# then the serve shapes of tinyllama-1.1b (8 slots, a 144-slot ring, and a
# 2,048-slot ring that spans many of the kernel's 64-key tiles), then
# h2o-danube-1.8b's (8 slots, its full 4,096-slot window ring, head size 80)
DECODE_SHAPES = [(2, 8, 4, 64, 512, d) for d in ("float32", "bfloat16")] \
    + [(1, 7, 7, 128, 300, d) for d in ("float32", "bfloat16")] \
    + [(4, 16, 16, 64, 1024, d) for d in ("float32", "bfloat16")] \
    + [(8, 32, 4, 64, 144, "bfloat16"), (8, 32, 4, 64, 2048, "bfloat16")] \
    + [(8, 32, 8, 80, 4096, d) for d in ("float32", "bfloat16")]  # h2o-danube's decode
DECODE_MAIN_SHAPE = (8, 32, 4, 64, 144, "bfloat16")
L2_FLUSH_FLOATS = 32 << 20  # 128 MB, written before each cold sample (the L2 holds 50 MB)
BITS_S = 2048  # the ring the serve shape's rows are held bit for bit against
NEAR_TIE = 3e-2  # top-2 logit gap under which a bf16 token flip is a near-tie
RESIZE_TO, CROP_TO, MEAN, STD = 256, 224, 127.5, 64.0
SHAPE_KEYS = ("n", "L", "H", "W", "B", "KH", "D", "S", "dtype")  # a row's shape, in its order
LIBRARY_CALL = {"audio_resample": "F.conv1d", "audio_normalize": "F.instance_norm"}
TOL = {"audio_resample": (1e-4, 1e-5), "mel_spectrogram": (2e-4, 2e-4),
       "audio_normalize": (3e-3, 3e-3), "jpeg_idct": (1e-4, 1e-3),
       "image_resize": (1e-4, 1e-4), "image_normalize": (1e-5, 1e-5),
       "decode_attention/float32": (2e-4, 2e-4), "decode_attention/bfloat16": (3e-2, 3e-2)}
REPLACES = {
    "audio_resample": "src/repro/kernels/audio_resample.py:67",
    "mel_spectrogram": "src/repro/kernels/mel_spectrogram.py:40",
    "audio_normalize": "src/repro/kernels/audio_normalize.py:71",
    "jpeg_idct": "src/repro/kernels/jpeg_idct.py:39",
    "image_resize": "src/repro/kernels/image_resize.py:47",
    "image_normalize": "src/repro/kernels/image_normalize.py:36",
    "decode_attention": "src/repro/kernels/decode_attention.py:72",
}
# ITU-T T.81 Annex K, Table K.1: luminance quantization table
QTABLE_K1 = [
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, n: int = 25, warmup: int = 3, flush=None) -> float:
    """Median device time of one call of fn, in ms. Each sample queues the
    call behind a spin kernel, so the events bracket device work only. With
    `flush` (a tensor larger than the 50 MB L2) every sample is preceded by
    a write of it, so fn finds its inputs cold, in device memory."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def errors(torch, name, got, want):
    """(max abs error, max rel error where |plain| >= 1e-2, allclose at the
    kernel's tolerance)."""
    rtol, atol = TOL[name]
    d = (got.double() - want.double()).abs()
    big = want.double().abs() >= 1e-2
    rel = d[big] / want.double().abs()[big]
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, rtol=rtol, atol=atol)
    return float(d.max()), float(rel.max()) if rel.numel() else 0.0, ok


def check_no_fallback(rt, where: str) -> None:
    """A phase that injected no failure ran every payload through the
    kernels: no breaker trip, no request on the CPU path."""
    if rt.stats["breaker_trips"] or rt.stats["cpu_fallback"]:
        fail(f"{where}: breaker_trips {rt.stats['breaker_trips']}, cpu_fallback "
             f"{rt.stats['cpu_fallback']} with no failure injected")


def check_decode_launches(launches, cfg, engine, where: str, tenant=None) -> int:
    """The decode kernel ran once per layer on every decode step the engine
    (a fleet: every engine it built; with `tenant`, every engine of that
    attention tenant, the fleet's only one) executed; returns that step
    count."""
    total = getattr(engine, "decode_steps_total", None)
    steps = total(tenant) if total is not None else engine.stats["decode_steps"]
    if steps <= 0 or launches["decode_attention"] != cfg.n_layers * steps:
        fail(f"decode_attention: {launches['decode_attention']} launches on the {where}, "
             f"the engine{'' if tenant is None else ' tenant ' + tenant} executed {steps} "
             f"decode steps of {cfg.n_layers} layers")
    return steps


def kernel_phase(torch, F):
    from repro_torch.kernels import audio_normalize as kn
    from repro_torch.kernels import audio_resample as kr
    from repro_torch.kernels import mel_spectrogram as km
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    h = ops.resample_taps(1, 3, 48, dev)
    taps = h.shape[0]
    win, tw, wts, bands = ops.mel_constants(512, 400, 80, 16000, dev)
    cr, ci, fb = ref.mel_dense_operands(512, 80, 16000, dev)
    flush = torch.empty(L2_FLUSH_FLOATS, device=dev)
    rows = []
    for n, length in SHAPES:
        x = torch.randn((n, length), generator=gen, device=dev)
        pad = taps // 2
        n_out = (length + 2) // 3
        # resample: the kernel reads the unpadded stack and pads it itself
        y = kr.audio_resample_batch_kernel(x, h, 3, n_out, pad)
        want = kr.audio_resample_batch_plain(x, h, 3, n_out, pad)

        def conv():
            return F.conv1d(x[:, None], h[None, None], stride=3, padding=pad)[:, 0, :n_out]

        row = dict(name="audio_resample", n=n, L=length,
                   err=errors(torch, "audio_resample", y, want),
                   library_err=errors(torch, "audio_resample", conv(), want))
        row["ms"] = time_ms(torch, lambda: kr.audio_resample_batch_kernel(x, h, 3, n_out, pad))
        row["cold_ms"] = time_ms(
            torch, lambda: kr.audio_resample_batch_kernel(x, h, 3, n_out, pad), flush=flush)
        row["path_ms"] = time_ms(torch, lambda: ops.audio_resample_batch(x, 1, 3))
        row["plain_ms"] = time_ms(
            torch, lambda: kr.audio_resample_batch_plain(x, h, 3, n_out, pad))
        row["library_ms"] = time_ms(torch, conv)
        row["bytes"] = 4 * (x.numel() + taps + n * n_out)
        row["flops"] = 2 * taps * n * n_out
        rows.append(row)
        # mel, on the kernel's resampled signal (the kernel frames it)
        def run_mel():
            return km.mel_spectrogram_batch_kernel(y, win, tw, wts, bands, 160)

        mel = run_mel()
        want = km.mel_spectrogram_batch_plain(y, win, tw, wts, bands, 160)
        frames = km.frames(y, win, 160, 512)
        # the dense products evaluated in float64: in fp32 they are off the
        # exact log-mel by more than 2e-4 where a band's power nears 0 (mel
        # 0 is the DC bin alone, whose power falls near 0 in some frames)
        dense = ref.mel_spectrogram_ref(frames.double(), cr.double(), ci.double(),
                                        fb.double()).reshape(mel.shape)
        dense32 = ref.mel_spectrogram_ref(frames, cr, ci, fb).reshape(mel.shape)
        row = dict(name="mel_spectrogram", n=n, L=length,
                   err=errors(torch, "mel_spectrogram", mel, want),
                   dense_err=errors(torch, "mel_spectrogram", mel.double(), dense),
                   dense32_max_abs_err=float((dense32.double() - dense).abs().max()))

        def composite():
            s = torch.fft.rfft(frames, n=512)
            return torch.log((s.real * s.real + s.imag * s.imag) @ fb + 1e-6)

        row["ms"] = time_ms(torch, run_mel)
        row["cold_ms"] = time_ms(torch, run_mel, flush=flush)
        row["plain_ms"] = time_ms(
            torch, lambda: km.mel_spectrogram_batch_plain(y, win, tw, wts, bands, 160))
        row["dense_ms"] = time_ms(torch, lambda: ref.mel_spectrogram_ref(frames, cr, ci, fb))
        row["composite_ms"] = time_ms(torch, composite)
        row["library_ms"] = None  # no single PyTorch call computes a log-mel spectrogram
        t, nm = mel.shape[1], mel.shape[2]
        m, nb = n * t, cr.shape[1]
        # the kernel's own traffic: the samples its frames cover, window,
        # twiddles, band weights and bands read once, the output written
        # once; its work: window, a real FFT (5 n/2 log2 n), power, the band
        # sums, eps and log. dense_* count the three dense products.
        row["bytes"] = 4 * (n * ((t - 1) * 160 + 400) + win.numel() + tw.numel()
                            + wts.numel() + bands.numel() + m * nm)
        row["flops"] = m * (400 + 5 * 512 * 9 // 2 + 3 * nb + 2 * wts.numel() + 2 * nm)
        row["dense_bytes"] = 4 * (frames.numel() + cr.numel() + ci.numel() + fb.numel()
                                  + m * nm)
        row["dense_flops"] = 2 * 2 * m * 512 * nb + 3 * m * nb + 2 * m * nb * nm + m * nm
        rows.append(row)
        # normalize, on the kernel's log-mel features: mel band 2 is empty,
        # so column 2 is the constant log(1e-6) and its exact output is 0
        feats = mel
        z = kn.audio_normalize_batch_kernel(feats)
        want = kn.audio_normalize_batch_plain(feats)
        ft = feats.transpose(1, 2)

        def inorm():
            return F.instance_norm(ft, eps=1e-5)

        plan = kn.plan(feats.shape[1], feats.shape[2])
        # an utterance's bits do not depend on the stack it arrives in
        bits = all(torch.equal(kn.audio_normalize_batch_kernel(feats[i:i + 1].clone())[0], z[i])
                   for i in range(n))
        row = dict(name="audio_normalize", n=n, L=length, T=feats.shape[1],
                   err=errors(torch, "audio_normalize", z, want),
                   library_err=errors(torch, "audio_normalize", inorm().transpose(1, 2), want),
                   band2_max_abs_err=float((z[..., 2] - want[..., 2]).abs().max()),
                   band2_max_abs=float(z[..., 2].abs().max()), bits_equal_n1=bits,
                   cluster=plan.cluster, staged=plan.staged)
        row["ms"] = time_ms(torch, lambda: kn.audio_normalize_batch_kernel(feats))
        row["cold_ms"] = time_ms(torch, lambda: kn.audio_normalize_batch_kernel(feats),
                                 flush=flush)
        row["path_ms"] = time_ms(torch, lambda: ops.audio_normalize_batch(feats))
        row["plain_ms"] = time_ms(torch, lambda: kn.audio_normalize_batch_plain(feats))
        row["library_ms"] = time_ms(torch, inorm)
        row["bytes"] = 4 * 2 * feats.numel()
        row["flops"] = 5 * feats.numel()
        rows.append(row)
    torch.cuda.synchronize()
    del flush
    for row in rows:
        abs_err, rel_err, ok = row.pop("err")
        row["max_abs_err"], row["max_rel_err"] = abs_err, rel_err
        t_bytes, t_ops = row["bytes"] / HBM_BYTES_S, row["flops"] / FP32_FLOPS_S
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        extra = ""
        if "library_err" in row:
            lib_abs, _, lib_ok = row.pop("library_err")
            row["library_max_abs_err"] = lib_abs
            extra = (f" cold_ms={row['cold_ms']:.4f} path_ms={row['path_ms']:.4f} "
                     f"library_err={lib_abs:.3e}")
            if not lib_ok:
                fail(f"{LIBRARY_CALL[row['name']]} differs from the plain {row['name']} at "
                     f"N={row['n']} L={row['L']} beyond {TOL[row['name']]}")
        if "bits_equal_n1" in row:
            extra += (f" T={row['T']} cluster={row['cluster']} staged={row['staged']} "
                      f"band2_err={row['band2_max_abs_err']:.3e} "
                      f"band2_abs={row['band2_max_abs']:.3e} bits_n1={row['bits_equal_n1']}")
            if not row["bits_equal_n1"]:
                fail(f"audio_normalize N={row['n']} L={row['L']}: a row of the stack differs "
                     f"from the same utterance normalized alone")
        if "dense_err" in row:
            dense_abs, _, dense_ok = row.pop("dense_err")
            row["dense_max_abs_err"] = dense_abs
            row["dense_bound_ms"] = 1e3 * max(row["dense_bytes"] / HBM_BYTES_S,
                                              row["dense_flops"] / FP32_FLOPS_S)
            extra = (f" cold_ms={row['cold_ms']:.4f} dense_err={dense_abs:.3e} "
                     f"dense32_err={row['dense32_max_abs_err']:.3e} "
                     f"dense_ms={row['dense_ms']:.4f} composite_ms={row['composite_ms']:.4f} "
                     f"dense_bound_ms={row['dense_bound_ms']:.4f}")
            if not dense_ok:
                fail(f"the mel kernel differs from the dense products at N={row['n']} "
                     f"L={row['L']} beyond {TOL['mel_spectrogram']}")
        print(f"  {row['name']:16s} N={row['n']:2d} L={row['L']:6d}  "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}) max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e}"
              + extra)
        if not ok:
            fail(f"{row['name']} N={row['n']} L={row['L']} disagrees with its plain "
                 f"version beyond rtol/atol {TOL[row['name']]}")
    return rows


def serve_phase(torch, np):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.requests import WorkloadSpec, generate_requests
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    cfg = get_config("tinyllama-1.1b")
    ec = EngineConfig(max_new_tokens=8, continuous=True, max_slots=8, segment_len=8,
                      max_prompt_len=128)
    spec = WorkloadSpec(modality="text", rate_qps=50.0, mean_len=48, max_len=120,
                        vocab=cfg.vocab, payload_samples=48_000)
    service = DpuService(DpuServiceConfig(clock="wall", dpu=DpuConfig(backend="dpu")),
                         device="cuda")
    feats = {}
    poll = service.poll

    def recording_poll(now, n=None):
        out = poll(now, n)
        for r in out:
            feats[r.rid] = np.array(r.payload)
        return out

    service.poll = recording_poll
    rt = build_pipelined_runtime(cfg, ec=ec, service=service, device="cuda",
                                 rc=RuntimeConfig(clock="wall", max_ingest=64))

    def drive(reqs):
        t0 = time.monotonic()
        for r in reqs:
            r.arrival += t0
        rt.submit(reqs)
        done = rt.run_until_idle()
        torch.cuda.synchronize()
        return done, time.monotonic() - t0

    # warm-up (cuBLAS handles, allocator) with two requests of other rids
    warm = generate_requests(WorkloadSpec(modality="text", rate_qps=50.0, mean_len=48,
                                          max_len=120, vocab=cfg.vocab,
                                          payload_samples=48_000, seed=99), 2)
    for i, r in enumerate(warm):
        r.rid = 10_000 + i
    drive(warm)
    rt.reset_metrics()
    feats.clear()
    groups0 = service.stats["groups"]

    reqs = generate_requests(spec, 16)
    raws = {r.rid: r.payload.copy() for r in reqs}
    kernels.reset_launch_counts()              # the main path starts here
    done, wall = drive(reqs)
    launches = kernels.launch_counts()         # ... and ends here
    groups = service.stats["groups"] - groups0
    rt.close()

    if len(done) != 16 or rt.shed or not rt.conservation_ok():
        fail(f"served {len(done)} of 16, shed {rt.shed_counts()}")
    for r in done:
        f = feats.get(r.rid)
        if f is None or f.shape != (98, 80) or not np.isfinite(f).all():
            fail(f"request {r.rid}: features {None if f is None else f.shape} not finite [98, 80]")
        plain = ops.audio_pipeline_batch(torch.from_numpy(raws[r.rid][None]))[0].numpy()
        if not np.allclose(f, plain, rtol=1e-3, atol=1e-2):
            fail(f"request {r.rid}: features differ from the plain CPU pipeline "
                 f"(max abs {np.abs(f - plain).max():.3e})")
        toks = np.asarray(r.payload)
        if toks.shape != (8,) or toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"request {r.rid}: tokens {toks}")
    for k in kernels.AUDIO_KERNELS:
        if launches[k] <= 0 or launches[k] != groups:
            fail(f"{k}: {launches[k]} launches on the audio path, the service "
                 f"launched {groups} groups")
    for k in kernels.IMAGE_KERNELS:
        if launches[k] != 0:
            fail(f"{k}: {launches[k]} launches on the audio path")
    check_no_fallback(rt, "audio path")
    steps = check_decode_launches(launches, cfg, rt.engine, "audio path")
    lat = np.array([r.completed_at - r.arrival for r in done])
    ttft = np.array([r.first_token_at - r.arrival for r in done])
    n_tok = int(sum(len(r.payload) for r in done))
    stats = dict(served=len(done), shed=rt.shed_counts(), groups=groups, tokens=n_tok,
                 wall_s=wall, tokens_per_s=n_tok / wall,
                 latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
                 latency_p99_ms=1e3 * float(np.percentile(lat, 99)),
                 ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
                 ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
                 decode_steps=steps, launches=launches,
                 stage_occupancy=rt.stage_occupancy())
    print("serve: " + json.dumps(stats))
    return stats, rt.engine.model.tree()


def jpeg_coeffs(np, rng, by: int, bx: int):
    """Seeded quantized DCT coefficients [by, bx, 8, 8] whose magnitude
    falls with frequency, as in a natural image's JPEG stream."""
    j = np.arange(8)
    scale = 10.0 / (1.0 + j[:, None] + j[None, :])
    return np.round(rng.standard_normal((by, bx, 8, 8)) * scale).astype(np.float32)


def image_kernel_phase(torch, F, np):
    from repro_torch.kernels import image_normalize as kin
    from repro_torch.kernels import image_resize as kz
    from repro_torch.kernels import jpeg_idct as kj
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(4321)
    qt = torch.tensor(QTABLE_K1, dtype=torch.float32, device=dev)
    flush = torch.empty(L2_FLUSH_FLOATS, device=dev)
    rows = []
    for n, h, w in IMAGE_SHAPES:
        coeffs = torch.from_numpy(np.stack([jpeg_coeffs(np, rng, h // 8, w // 8)
                                            for _ in range(n)])).to(dev)
        tag = dict(n=n, H=h, W=w)
        # IDCT, straight into image layout
        imgs = kj.jpeg_idct_batch_kernel(coeffs, qt)
        want = kj.jpeg_idct_batch_plain(coeffs, qt)
        row = dict(name="jpeg_idct", **tag, err=errors(torch, "jpeg_idct", imgs, want))
        row["ms"] = time_ms(torch, lambda: kj.jpeg_idct_batch_kernel(coeffs, qt))
        row["cold_ms"] = time_ms(torch, lambda: kj.jpeg_idct_batch_kernel(coeffs, qt),
                                 flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: kj.jpeg_idct_batch_plain(coeffs, qt))
        row["library_ms"] = None  # no single PyTorch call dequantizes and inverts 8x8 DCT blocks
        nb = n * (h // 8) * (w // 8)
        row["bytes"] = 4 * (coeffs.numel() + 64 + 64 + n * h * w)
        row["flops"] = nb * (64 + 2 * 2 * 8 * 8 * 8 + 64)
        rows.append(row)
        # resize to 256 x 256, on the kernel's decoded images
        yt = ops.resize_taps(h, RESIZE_TO, dev)
        xt = ops.resize_taps(w, RESIZE_TO, dev)
        ry = ops.resize_matrix(h, RESIZE_TO, dev)
        rx = ops.resize_matrix(w, RESIZE_TO, dev)
        z = kz.image_resize_batch_kernel(imgs, yt, xt)
        want = kz.image_resize_batch_plain(imgs, yt, xt)
        row = dict(name="image_resize", **tag, err=errors(torch, "image_resize", z, want),
                   dense_err=errors(torch, "image_resize", z, ref.image_resize_ref(imgs, ry, rx)))

        def interp():
            return F.interpolate(imgs[:, None], size=(RESIZE_TO, RESIZE_TO), mode="bilinear",
                                 align_corners=False, antialias=False)[:, 0]

        row["library_err"] = errors(torch, "image_resize", interp(), want)
        row["ms"] = time_ms(torch, lambda: kz.image_resize_batch_kernel(imgs, yt, xt))
        row["plain_ms"] = time_ms(torch, lambda: kz.image_resize_batch_plain(imgs, yt, xt))
        row["library_ms"] = time_ms(torch, interp)
        row["dense_ms"] = time_ms(torch, lambda: ref.image_resize_ref(imgs, ry, rx))
        # the image and the output, and 16 bytes of taps (2 int32 columns,
        # 2 fp32 weights) an output row and column; a bilinear output has 2
        # taps in each pass. dense_bound_ms counts the dense products
        # Ry @ img @ Rx^T (and the matrices in place of the taps).
        row["bytes"] = 4 * (imgs.numel() + n * RESIZE_TO * RESIZE_TO) + 16 * 2 * RESIZE_TO
        row["flops"] = 2 * n * (RESIZE_TO * 2 * w + RESIZE_TO * RESIZE_TO * 2)
        row["dense_bytes"] = 4 * (imgs.numel() + ry.numel() + rx.numel()
                                  + n * RESIZE_TO * RESIZE_TO)
        row["dense_flops"] = 2 * n * (RESIZE_TO * h * w + RESIZE_TO * w * RESIZE_TO)
        rows.append(row)
        # crop-normalize, on the kernel's resized images: bit for bit
        y = kin.image_crop_normalize_batch_kernel(z, CROP_TO, CROP_TO, MEAN, STD)
        want = kin.image_crop_normalize_batch_plain(z, CROP_TO, CROP_TO, MEAN, STD)
        row = dict(name="image_normalize", **tag,
                   err=errors(torch, "image_normalize", y, want),
                   bits_equal=bool(torch.equal(y, want)))
        row["ms"] = time_ms(torch, lambda: kin.image_crop_normalize_batch_kernel(
            z, CROP_TO, CROP_TO, MEAN, STD))
        row["cold_ms"] = time_ms(torch, lambda: kin.image_crop_normalize_batch_kernel(
            z, CROP_TO, CROP_TO, MEAN, STD), flush=flush)
        row["plain_ms"] = time_ms(torch, lambda: kin.image_crop_normalize_batch_plain(
            z, CROP_TO, CROP_TO, MEAN, STD))
        row["library_ms"] = None  # no single PyTorch call crops and normalizes
        row["bytes"] = 4 * 2 * n * CROP_TO * CROP_TO
        row["flops"] = 2 * n * CROP_TO * CROP_TO
        rows.append(row)
    torch.cuda.synchronize()
    del flush
    for row in rows:
        abs_err, rel_err, ok = row.pop("err")
        row["max_abs_err"], row["max_rel_err"] = abs_err, rel_err
        t_bytes, t_ops = row["bytes"] / HBM_BYTES_S, row["flops"] / FP32_FLOPS_S
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        extra = f" cold_ms={row['cold_ms']:.4f}" if "cold_ms" in row else ""
        if "bits_equal" in row:
            extra += f" bits_equal={row['bits_equal']}"
        if "library_err" in row:
            lib_abs, _, lib_ok = row.pop("library_err")
            dense_abs, _, dense_ok = row.pop("dense_err")
            row["library_max_abs_err"] = lib_abs
            row["dense_max_abs_err"] = dense_abs
            row["dense_bound_ms"] = 1e3 * max(row["dense_bytes"] / HBM_BYTES_S,
                                              row["dense_flops"] / FP32_FLOPS_S)
            extra = (f" library_err={lib_abs:.3e} dense_err={dense_abs:.3e} "
                     f"dense_ms={row['dense_ms']:.4f} "
                     f"dense_bound_ms={row['dense_bound_ms']:.4f}")
            if not lib_ok:
                fail(f"F.interpolate differs from the plain resize at N={row['n']} "
                     f"{row['H']}x{row['W']} beyond {TOL['image_resize']}")
            if not dense_ok:
                fail(f"the resize kernel differs from the dense products at N={row['n']} "
                     f"{row['H']}x{row['W']} beyond {TOL['image_resize']}")
        print(f"  {row['name']:16s} N={row['n']:2d} {row['H']}x{row['W']}  "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}) max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e}"
              + extra)
        if not ok:
            fail(f"{row['name']} N={row['n']} {row['H']}x{row['W']} disagrees with its "
                 f"plain version beyond rtol/atol {TOL[row['name']]}")
        if not row.get("bits_equal", True):
            fail(f"{row['name']} N={row['n']} {row['H']}x{row['W']} is not bit for bit "
                 f"equal to its plain version")
    return rows


def image_serve_phase(torch, np, params):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.batching.buckets import next_pow2
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import telemetry as tm
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.requests import WorkloadSpec, generate_requests
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    cfg = get_config("tinyllama-1.1b")
    ec = EngineConfig(max_new_tokens=8, continuous=True, max_slots=8, segment_len=8,
                      max_prompt_len=128)
    service = DpuService(DpuServiceConfig(
        clock="wall", dpu=DpuConfig(modality="image", backend="dpu")), device="cuda")
    feats = {}
    poll = service.poll

    def recording_poll(now, n=None):
        out = poll(now, n)
        for r in out:
            feats[r.rid] = np.array(r.payload)
        return out

    service.poll = recording_poll
    rt = build_pipelined_runtime(cfg, ec=ec, service=service, device="cuda", params=params,
                                 rc=RuntimeConfig(clock="wall", max_ingest=64))
    k1 = np.asarray(QTABLE_K1, np.float32)
    rng = np.random.default_rng(2024)

    def traffic(n_req, seed, rid0):
        """n_req requests: the first min(16, n_req) 512 x 512 with Table K.1,
        the rest 384 x 512 with K.1 x 0.5 or x 2."""
        reqs = generate_requests(WorkloadSpec(modality="text", rate_qps=50.0, mean_len=48,
                                              max_len=120, vocab=cfg.vocab, seed=seed), n_req)
        for i, r in enumerate(reqs):
            r.rid = rid0 + i
            if i < 16:
                r.payload = {"coeffs": jpeg_coeffs(np, rng, 64, 64), "qtable": k1.copy()}
            else:
                r.payload = {"coeffs": jpeg_coeffs(np, rng, 48, 64),
                             "qtable": k1 * (0.5 if i % 2 == 0 else 2.0)}
        return reqs

    def drive(reqs):
        t0 = time.monotonic()
        for r in reqs:
            r.arrival += t0
        rt.submit(reqs)
        done = rt.run_until_idle()
        torch.cuda.synchronize()
        return done, time.monotonic() - t0

    drive(traffic(2, 98, 20_000))  # warm-up, other rids
    rt.reset_metrics()
    feats.clear()

    reqs = traffic(20, 7, 0)
    raws = {r.rid: {k: v.copy() for k, v in r.payload.items()} for r in reqs}
    kernels.reset_launch_counts()              # the image path starts here
    done, wall = drive(reqs)
    launches = kernels.launch_counts()         # ... and ends here
    rt.close()

    if len(done) != 20 or rt.shed or not rt.conservation_ok():
        fail(f"image path: served {len(done)} of 20, shed {rt.shed_counts()}")
    for r in done:
        f = feats.get(r.rid)
        if f is None or f.shape != (CROP_TO, CROP_TO) or not np.isfinite(f).all():
            fail(f"image request {r.rid}: features {None if f is None else f.shape} "
                 f"not finite [{CROP_TO}, {CROP_TO}]")
        raw = raws[r.rid]
        plain = ops.image_pipeline_batch(torch.from_numpy(raw["coeffs"][None]),
                                         torch.from_numpy(raw["qtable"]))[0].numpy()
        if not np.allclose(f, plain, rtol=1e-3, atol=1e-2):
            fail(f"image request {r.rid}: features differ from the plain CPU pipeline "
                 f"(max abs {np.abs(f - plain).max():.3e})")
        toks = np.asarray(r.payload)
        if toks.shape != (8,) or toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"image request {r.rid}: tokens {toks}")
    # the groups the service launched for these requests, and what they imply
    groups, want = [], {"jpeg_idct": 0, "image_resize": 0, "image_normalize": 0}
    for e in service.tracer.of(tm.PREPROCESS_LAUNCH):
        rids = (e.extra or {}).get("rids", [])
        if not rids or rids[0] not in raws:
            continue
        qts = [raws[i]["qtable"] for i in rids]
        m = next_pow2(len(rids))
        qts += [qts[-1]] * (m - len(rids))
        fused = all(np.array_equal(q, qts[0]) for q in qts[1:])
        groups.append(dict(n=len(rids), stack=m, fused=fused))
        want["jpeg_idct"] += 1 if fused else m
        want["image_resize"] += 1
        want["image_normalize"] += 1
    if sum(g["n"] for g in groups) != 20:
        fail(f"image path: the traced groups {groups} do not cover the 20 requests")
    if not any(g["fused"] for g in groups) or all(g["fused"] for g in groups):
        fail(f"image path: groups {groups} did not exercise both the fused and "
             f"the per-FU path")
    for k in kernels.IMAGE_KERNELS:
        if launches[k] <= 0 or launches[k] != want[k]:
            fail(f"{k}: {launches[k]} launches on the image path, its groups "
                 f"{groups} imply {want[k]}")
    for k in kernels.AUDIO_KERNELS:
        if launches[k] != 0:
            fail(f"{k}: {launches[k]} launches on the image path")
    check_no_fallback(rt, "image path")
    steps = check_decode_launches(launches, cfg, rt.engine, "image path")
    lat = np.array([r.completed_at - r.arrival for r in done])
    ttft = np.array([r.first_token_at - r.arrival for r in done])
    n_tok = int(sum(len(r.payload) for r in done))
    stats = dict(served=len(done), shed=rt.shed_counts(), groups=groups, tokens=n_tok,
                 wall_s=wall, tokens_per_s=n_tok / wall,
                 latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
                 latency_p99_ms=1e3 * float(np.percentile(lat, 99)),
                 ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
                 ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
                 decode_steps=steps, launches=launches, launches_implied=want,
                 stage_occupancy=rt.stage_occupancy())
    print("image serve: " + json.dumps(stats))
    return stats


def decode_row(torch, F, np, kd, rng, shape, valid=None):
    """One decode attention shape (B, H, KH, D, S, dtype) on random inputs,
    valid_len drawn in [1, S] (or `valid` on every row): the kernel held
    against its plain version and SDPA (the library yardstick: one call with
    a boolean prefix mask), the three timed, and the bytes and operations
    of its bound (the valid prefix of K and V read once, q read and the
    output written once). Returns (row, its inputs); report_decode_rows
    reads the errors."""
    b, h, kh, d, s_len, dt = shape
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev, dtype)
               for sh in ((b, h, d), (b, s_len, kh, d), (b, s_len, kh, d)))
    vl_np = (rng.integers(1, s_len + 1, b) if valid is None
             else np.full(b, valid)).astype(np.int32)
    vl = torch.from_numpy(vl_np).to(dev)
    name = f"decode_attention/{dt}"
    got = kd.decode_attention_kernel(q, k, v, vl)
    want = kd.decode_attention_plain(q, k, v, vl)
    row = dict(name="decode_attention", B=b, H=h, KH=kh, D=d, S=s_len, dtype=dt,
               tol=name, err=errors(torch, name, got.float(), want.float()))
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(s_len, device=dev)[None] < vl[:, None].long())[:, None, None]

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              enable_gqa=True)[:, :, 0]

    row["library_err"] = errors(torch, name, sdpa().float(), want.float())
    row["ms"] = time_ms(torch, lambda: kd.decode_attention_kernel(q, k, v, vl))
    row["plain_ms"] = time_ms(torch, lambda: kd.decode_attention_plain(q, k, v, vl))
    row["library_ms"] = time_ms(torch, sdpa)
    elt = q.element_size()
    n_valid = int(vl_np.sum())  # the kernel reads the valid prefix of K and V
    row["bytes"] = elt * (2 * b * h * d + 2 * n_valid * kh * d) + 4 * b
    row["flops"] = 4 * n_valid * (h // kh) * kh * d
    return row, (q, k, v, vl)


def report_decode_rows(rows) -> None:
    """Each decode attention row's errors and bound, printed; fails on a row
    whose kernel (or SDPA) differs from the plain version beyond the
    decode tolerance, or whose lse (a row with the lse) beyond LSE_TOL."""
    for row in rows:
        abs_err, rel_err, ok = row.pop("err")
        lib_abs, _, lib_ok = row.pop("library_err")
        row["max_abs_err"], row["max_rel_err"] = abs_err, rel_err
        row["library_max_abs_err"] = lib_abs
        lse_ok = True
        if "lse_err" in row:
            row["lse_max_abs_err"], lse_ok = row.pop("lse_err")
        t_bytes, t_ops = row["bytes"] / HBM_BYTES_S, row["flops"] / FP32_FLOPS_S
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  decode_attention{' (lse)' if row.get('lse') else ''} B={row['B']} "
              f"H={row['H']} KH={row['KH']} D={row['D']} "
              f"S={row['S']:4d} {row['dtype']:8s} ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
              f"max_abs_err={abs_err:.3e} library_err={lib_abs:.3e}"
              + (f" lse max_abs_err={row['lse_max_abs_err']:.3e} nolse_ms={row['nolse_ms']:.4f}"
                 if row.get("lse") else ""))
        if not lse_ok:
            fail(f"decode_attention {row['dtype']} B={row['B']} D={row['D']} S={row['S']}: "
                 f"its lse disagrees with the plain version's beyond {LSE_TOL} (or not -inf "
                 f"at the rows with no valid key)")
        if not ok:
            fail(f"decode_attention {row['dtype']} B={row['B']} D={row['D']} S={row['S']} "
                 f"disagrees with its plain version beyond {TOL[row['tol']]}")
        if not lib_ok:
            fail(f"scaled_dot_product_attention differs from the plain decode attention "
                 f"at {row['dtype']} B={row['B']} D={row['D']} S={row['S']} beyond "
                 f"{TOL[row['tol']]}")


def decode_kernel_phase(torch, F, np):
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as kd

    dev = torch.device("cuda")
    rng = np.random.default_rng(777)
    rows = []
    for shape in DECODE_SHAPES:
        row, (q, k, v, vl) = decode_row(torch, F, np, kd, rng, shape)
        rows.append(row)
        if shape == DECODE_MAIN_SHAPE:
            main_row = row
            main_row["bits_vs_longer_ring"] = decode_bits_check(
                torch, np, kd, q, k, v, vl, np.random.default_rng(778))
    # valid_len = 0: every position weighs the same, the output is mean(V)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev)
               for sh in ((2, 8, 64), (2, 300, 4, 64), (2, 300, 4, 64)))
    vl = torch.tensor([0, 100], dtype=torch.int32, device=dev)
    got = kd.decode_attention_kernel(q, k, v, vl)
    zero = dict(err=errors(torch, "decode_attention/float32", got,
                           kd.decode_attention_plain(q, k, v, vl)),
                mean_err=errors(torch, "decode_attention/float32", got[0],
                                v[0].mean(0).repeat_interleave(2, dim=0)))
    torch.cuda.synchronize()
    report_decode_rows(rows)
    for key, (abs_err, _, ok) in zero.items():
        print(f"  decode_attention valid_len=0 row: {key}={abs_err:.3e}")
        if not ok:
            fail(f"decode_attention at valid_len = 0: {key} {abs_err:.3e}")
    b, h, kh, d = DECODE_MAIN_SHAPE[:4]
    clusters = build.library().preba_decode_attention_max_clusters(d, h // kh, 1, kh, b)
    tiny = torch.zeros(1, device=dev)
    floor_ms = time_ms(torch, tiny.zero_)
    main_row.update(max_active_clusters=clusters, clusters=kh * b, launch_floor_ms=floor_ms)
    print(f"  decode_attention at the serve shape: {kh * b} clusters of 8 blocks, the card "
          f"holds {clusters} at once; launch floor (a 1-element fill) {floor_ms:.4f} ms")
    bits = main_row["bits_vs_longer_ring"]
    print(f"  decode_attention bits at S={DECODE_MAIN_SHAPE[4]} == S={BITS_S} with noise "
          f"past valid_len: {bits['equal']} (differing elements {bits['differing']})")
    if not bits["equal"]:
        fail(f"decode_attention: the serve shape's output at S = {DECODE_MAIN_SHAPE[4]} "
             f"differs from the same rows at S = {BITS_S} ({bits['differing']} elements)")
    return rows


def decode_bits_check(torch, np, kd, q, k, v, vl, rng):
    """The same rows in a BITS_S-slot ring: K and V equal on each row's valid
    prefix, noise past it. A row's bits must depend on its prefix only."""
    b, s_len, kh, d = k.shape
    longer = []
    for t in (k, v):
        t2 = torch.from_numpy(rng.standard_normal((b, BITS_S, kh, d)).astype(np.float32)
                              ).to(t.device, t.dtype)
        for i, n in enumerate(vl.tolist()):
            t2[i, :n] = t[i, :n]
        longer.append(t2)
    got = kd.decode_attention_kernel(q, k, v, vl)
    far = kd.decode_attention_kernel(q, *longer, vl)
    torch.cuda.synchronize()
    return {"equal": bool(torch.equal(got, far)), "differing": int((got != far).sum()),
            "S": BITS_S}


def decode_step_phase(torch, np, params):
    """Wall time of one full-width decode step over 8 slots of a 144-slot
    ring (what a serving segment pays a step, host included), with the
    decode kernel and with its plain version swapped in for the same call,
    in turns (kernel, plain, plain, kernel); then a profile of the kernel's
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.api import LM

    cfg = get_config("tinyllama-1.1b")
    model = LM(cfg, params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    pool = lm.alloc_slot_pool(cfg, 8, 144, torch.device("cuda"))
    for leaf in lm._kv_leaves(pool):
        leaf.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (8, 1), generator=gen, device="cuda")
    clock = 300
    off = clock - torch.tensor([10, 40, 70, 100, 120, 130, 143, 5], device="cuda")
    real = ops.decode_attention

    def steps_ms(n=20):
        for _ in range(3):
            model.decode(pool, tok, clock, pos_offset=off)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model.decode(pool, tok, clock, pos_offset=off)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    times = {"kernel": [], "plain": []}
    try:
        for which in ("kernel", "plain", "plain", "kernel"):
            ops.decode_attention = real if which == "kernel" else kd.decode_attention_plain
            times[which].append(steps_ms())
    finally:
        ops.decode_attention = real
    out = {k: min(v) for k, v in times.items()}
    print(f"decode step ({cfg.n_layers} layers, 8 slots, ring 144, {cfg.dtype}): "
          f"kernel {out['kernel']:.3f} ms, "
          f"plain {out['plain']:.3f} ms (best of two turns each)")
    step = lambda: model.decode(pool, tok, clock, pos_offset=off)  # noqa: E731
    res = {"decode_step_ms": out, "decode_step_ms_turns": times,
           "profile": profile_decode_steps(torch, step, out["kernel"])}
    print("decode step profile: " + json.dumps(res["profile"]))
    # the candidate pin the contract tests were also run under: bf16 GEMM
    # split-K reductions kept in fp32 (torch's default allows bf16), timed
    # in turns against the default, and profiled
    mm = torch.backends.cuda.matmul
    default = mm.allow_bf16_reduced_precision_reduction
    pin = {"default": [], "bf16_reduction_in_fp32": []}
    try:
        for which in ("default", "bf16_reduction_in_fp32", "bf16_reduction_in_fp32",
                      "default"):
            mm.allow_bf16_reduced_precision_reduction = default if which == "default" \
                else False
            pin[which].append(steps_ms())
        mm.allow_bf16_reduced_precision_reduction = False
        pinned = profile_decode_steps(torch, step, min(pin["bf16_reduction_in_fp32"]))
        print("decode step profile: " + json.dumps(pinned))
    finally:
        mm.allow_bf16_reduced_precision_reduction = default
    res["candidate_pin"] = {
        "allow_bf16_reduced_precision_reduction_default": default,
        "wall_ms": {k: min(v) for k, v in pin.items()}, "wall_ms_turns": pin,
        "device_ms": {"default": res["profile"]["device_ms_per_step"],
                      "bf16_reduction_in_fp32": pinned["device_ms_per_step"]}}
    print("decode step, candidate pin: " + json.dumps(res["candidate_pin"]))
    return res


def _traced(torch, warm, run):
    """run() under torch.profiler, after one warm() that the profiler
    traces and throws away (its schedule's warm-up step): CUPTI can miss
    kernels it sees first after tracing starts, so the recorded window
    opens with tracing already on. Every kernel has ended before each
    window closes. Returns (run()'s result, key_averages' CUDA kernel rows:
    the schedule's "ProfilerStep*" annotation, a device row that spans the
    whole window, is left out)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        out = run()
        torch.cuda.synchronize()
        prof.step()
    return out, [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("ProfilerStep")]


def profile_decode_steps(torch, step, wall_ms: float, n: int = 5):
    """torch.profiler over n decode steps: device time a step (the sum of
    its kernels' times), kernel launches a step, the device's busy share of
    the unprofiled wall time a step, and the kernels that take the most."""
    def steps():
        for _ in range(n):
            step()

    _, kernels_ = _traced(torch, step, steps)
    dev_ms = sum(e.self_device_time_total for e in kernels_) / 1e3 / n
    top = sorted(kernels_, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    attn = [e for e in kernels_ if "decode_attention" in e.key]
    res = {"device_ms_per_step": dev_ms,
           "decode_attention_ms_per_step": sum(e.self_device_time_total for e in attn) / 1e3 / n,
           "decode_attention_calls_per_step": sum(e.count for e in attn) / n,
           "kernel_launches_per_step": sum(e.count for e in kernels_) / n,
           "device_busy_share": dev_ms / wall_ms,
           "top_kernels": [{"name": e.key[:90], "calls_per_step": e.count / n,
                            "ms_per_step": e.self_device_time_total / 1e3 / n}
                           for e in top]}
    return res


def _burst(torch, engine, reqs):
    """Submit `reqs` at once on the wall clock and serve them to the end."""
    t0 = time.monotonic()
    for r in reqs:
        r.arrival = t0
    engine.submit_many(reqs)
    done = engine.run_until_idle()
    torch.cuda.synchronize()
    return done, time.monotonic() - t0


def _serve_stats(np, done, wall, launches, steps):
    lat = np.array([r.completed_at - r.arrival for r in done])
    ttft = np.array([r.first_token_at - r.arrival for r in done])
    n_tok = int(sum(len(r.payload) for r in done))
    return dict(served=len(done), shed=0, tokens=n_tok, wall_s=wall,
                tokens_per_s=n_tok / wall,
                latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
                latency_p99_ms=1e3 * float(np.percentile(lat, 99)),
                ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
                ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
                decode_steps=steps, launches=launches)


def _check_tokens(np, done, cfg, n, budget, where):
    if len(done) != n or len({r.rid for r in done}) != n:
        fail(f"{where}: served {len(done)} of {n}")
    for r in done:
        toks = np.asarray(r.payload)
        if toks.shape != (budget,) or toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"{where}: request {r.rid} tokens {toks}")


def rtc_serve_phase(torch, np, params):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.requests import WorkloadSpec, generate_requests

    cfg = get_config("tinyllama-1.1b")
    ec = EngineConfig(continuous=False, max_new_tokens=8)
    engine = build_engine(cfg, ec=ec, device="cuda", params=params)

    def traffic(n, seed, rid0):
        reqs = generate_requests(WorkloadSpec(modality="text", rate_qps=50.0, mean_len=48,
                                              max_len=120, vocab=cfg.vocab, seed=seed), n)
        for i, r in enumerate(reqs):
            r.rid = rid0 + i
        return reqs

    _burst(torch, engine, traffic(2, 97, 30_000))  # warm-up, other rids
    engine.reset_metrics()
    kernels.reset_launch_counts()              # the run-to-completion path starts here
    done, wall = _burst(torch, engine, traffic(16, 11, 0))
    launches = kernels.launch_counts()         # ... and ends here
    _check_tokens(np, done, cfg, 16, 8, "run-to-completion")
    for k in kernels.AUDIO_KERNELS + kernels.IMAGE_KERNELS:
        if launches[k] != 0:
            fail(f"{k}: {launches[k]} launches on the run-to-completion path")
    steps = check_decode_launches(launches, cfg, engine, "run-to-completion path")
    stats = _serve_stats(np, done, wall, launches, steps)
    stats["batches"] = engine.stats["batches"]

    # lm.generate == argmax(prefill) + the sequential decode() loop
    rng = np.random.default_rng(5)
    lens, lp, n_new = [100, 37, 64, 9], 128, 8
    toks = np.zeros((len(lens), lp), np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = rng.integers(0, cfg.vocab, n)
    toks = torch.from_numpy(toks).cuda()
    off = torch.tensor([lp - n for n in lens], device="cuda")
    model = engine.model
    logits, cache = model.prefill(toks, pos_offset=off, cache_len=lp + n_new)
    loop_cache = {"body": {"l0": {"mixer": {
        n: t.clone() for n, t in cache["body"]["l0"]["mixer"].items()}}}}
    gen, _ = model.generate(cache, logits, lp, steps=n_new, pos_offset=off)
    tok = torch.argmax(logits, -1)
    loop = [tok]
    for i in range(n_new - 1):
        lg, loop_cache = model.decode(loop_cache, tok, lp + i, pos_offset=off)
        tok = torch.argmax(lg, -1)
        loop.append(tok)
    if not torch.equal(gen, torch.cat(loop, dim=1)):
        fail("lm.generate differs from the sequential decode loop on the card")
    stats["generate_equals_decode_loop"] = True
    print("run-to-completion serve: " + json.dumps(stats))
    return stats


def chunked_prefix_serve_phase(torch, np, params):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.batching.buckets import Request
    from repro_torch.serving.engine import EngineConfig, build_engine

    cfg = get_config("tinyllama-1.1b")
    base = dict(continuous=True, max_slots=8, segment_len=8, max_new_tokens=8,
                max_prompt_len=128)
    rng = np.random.default_rng(2025)
    template = rng.integers(0, cfg.vocab, 64)     # the shared system prompt
    prompts = []
    for i in range(20):
        n = int(rng.integers(80, 121))
        if i % 5 == 4:                             # 4 cold prompts
            prompts.append(rng.integers(0, cfg.vocab, n))
        else:
            prompts.append(np.concatenate([template, rng.integers(0, cfg.vocab, n - 64)]))

    def traffic(rid0=0):
        return [Request(rid=rid0 + i, arrival=0.0, length=float(len(p)), prompt=p)
                for i, p in enumerate(prompts)]

    engine = build_engine(cfg, ec=EngineConfig(**base, chunk_lens=(32, 64),
                                               prefix_cache_bytes=256 << 20),
                          device="cuda", params=params)
    warm = [Request(rid=40_000 + i, arrival=0.0, length=float(n))
            for i, n in enumerate((90, 100))]
    _burst(torch, engine, warm)                 # warm-up: other prompts
    engine.reset_metrics()
    kernels.reset_launch_counts()               # the chunked + prefix path starts here
    done, wall = _burst(torch, engine, traffic())
    launches = kernels.launch_counts()          # ... and ends here
    _check_tokens(np, done, cfg, 20, 8, "chunked + prefix")
    steps = check_decode_launches(launches, cfg, engine, "chunked + prefix path")
    stats = _serve_stats(np, done, wall, launches, steps)
    stats.update({k: engine.stats[k] for k in (
        "prefix_hits", "prefix_hit_tokens", "prefix_prompt_tokens", "prefix_inserts",
        "admitted", "segments", "prefill_calls")})
    if engine.stats["prefix_hits"] <= 0:
        fail(f"chunked + prefix: no prefix hit on template traffic ({stats})")

    # the same 20 requests, monolithic admission, no cache
    mono = build_engine(cfg, ec=EngineConfig(**base), device="cuda", params=params)
    mono_done, _ = _burst(torch, mono, traffic())
    ref = {r.rid: np.asarray(r.payload) for r in mono_done}
    near_ties = []
    for r in done:
        got, want = np.asarray(r.payload), ref[r.rid]
        if np.array_equal(got, want):
            continue
        k = int(np.flatnonzero(got != want)[0])
        seq = np.concatenate([prompts[r.rid], want[:k]])
        logits, _ = mono.model.prefill(torch.from_numpy(seq[None]).cuda())
        top2 = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top2[0] - top2[1])
        if gap >= NEAR_TIE:
            fail(f"chunked + prefix: request {r.rid} diverges from monolithic admission "
                 f"at step {k} with a top-2 logit gap of {gap:.3e} (>= {NEAR_TIE})")
        near_ties.append(dict(rid=r.rid, step=k, gap=gap))
    stats["near_ties"] = near_ties
    stats["tokens_equal_monolithic"] = len(done) - len(near_ties)
    print(f"chunked + prefix serve: near-ties {len(near_ties)} of {len(done)} requests")
    print("chunked + prefix serve: " + json.dumps(stats))
    return stats


FLEET_SLICES, FLEET_REQUESTS, FLEET_RATE = 4, 32, 50.0


def fleet_traffic(np, cfg, n, seed, rid0=0):
    """n requests at FLEET_RATE per second: 1 s of 48 kHz audio each, a
    prompt of 33-63 tokens (mean 48; every one pads to the 64-token bucket)
    and 8 new tokens."""
    from repro_torch.core.batching.buckets import Request

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = int(rng.integers(33, 64))
        out.append(Request(rid=rid0 + i, arrival=i / FLEET_RATE, length=float(m),
                           prompt=rng.integers(0, cfg.vocab, m), max_new_tokens=8,
                           payload=rng.standard_normal(48_000).astype(np.float32)))
    return out


def fleet_stats(np, rt, done, wall, launches, steps, card):
    """The fleet phases' JSON line: per-slice served (retirements on the
    tracer, by slice id), hedges, requeues, dead letters by reason,
    tokens/s and the card."""
    from repro_torch.serving import telemetry as tm

    ms = rt.engine
    served = {}
    for e in rt.tracer.of(tm.RETIRE):
        served[e.sid] = served.get(e.sid, 0) + 1
    n_tok = int(sum(len(r.payload) for r in done))
    lat = np.array([r.completed_at - r.arrival for r in done]) if done else np.zeros(1)
    return dict(
        card=card, slices=len(ms.engines), served=len(done), shed=rt.shed_counts(),
        dead=rt.dead_counts(),
        served_by_slice=dict(sorted(served.items())),
        hedges=ms.hedges, hedge_wins=ms.stats["hedge_wins"], requeued=ms.stats["requeued"],
        cancelled=ms.stats["cancelled"], quarantined=ms.stats["quarantined"],
        readmitted=ms.stats["readmitted"], resizes=ms.stats["resizes"],
        breaker_trips=rt.stats["breaker_trips"], cpu_fallback=rt.stats["cpu_fallback"],
        pp_retries=rt.stats["pp_retries"], tokens=n_tok, wall_s=wall,
        tokens_per_s=n_tok / wall, latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
        latency_p99_ms=1e3 * float(np.percentile(lat, 99)), decode_steps=steps,
        engines_built=len({id(e) for e in ms._built}), launches=launches)


def single_slice_tokens(torch, np, cfg, ec, model, reqs):
    """The same requests (no payloads) served by one engine on the same
    weights: the fleet phases' reference tokens."""
    from dataclasses import replace

    from repro_torch.serving.engine import build_engine

    engine = build_engine(cfg, ec=ec, device="cuda", params=model.tree())
    done, _ = _burst(torch, engine, [replace(r, payload=None) for r in reqs])
    return {r.rid: np.asarray(r.payload) for r in done}


def check_fleet_tokens(np, done, ref, where):
    for r in done:
        if not np.array_equal(np.asarray(r.payload), ref[r.rid]):
            fail(f"{where}: request {r.rid} tokens {np.asarray(r.payload)} differ from the "
                 f"single-slice engine's {ref[r.rid]}")


def fleet_phase(torch, np, params, card):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.kernels import ops
    from repro_torch.models.api import LM
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    cfg = get_config("tinyllama-1.1b")
    model = LM(cfg, params)  # one LM, every slice serves it
    ec = EngineConfig(max_new_tokens=8, continuous=True, max_slots=8, segment_len=8,
                      max_prompt_len=128)
    service = DpuService(DpuServiceConfig(clock="wall", dpu=DpuConfig(backend="dpu")),
                         device="cuda")
    feats = {}
    poll = service.poll

    def recording_poll(now, n=None):
        out = poll(now, n)
        for r in out:
            feats[r.rid] = np.array(r.payload)
        return out

    service.poll = recording_poll
    rt = build_pipelined_runtime(cfg, n_slices=FLEET_SLICES, ec=ec, service=service,
                                 params=model, hedge_factor=3.0, device="cuda",
                                 rc=RuntimeConfig(clock="wall", max_ingest=64))
    ms = rt.engine
    streams = {id(e.stream) for e in ms.engines.values()}
    if len(streams) != FLEET_SLICES or any(e.model is not model for e in ms.engines.values()):
        fail(f"fleet: {len(streams)} streams for {FLEET_SLICES} slices, or a slice "
             f"serves another LM")

    def drive(reqs):
        t0 = time.monotonic()
        for r in reqs:
            r.arrival += t0
        rt.submit(reqs)
        done = rt.run_until_idle()
        torch.cuda.synchronize()
        return done, time.monotonic() - t0

    # warm-up: one request a slice (cuBLAS handles and workspaces per
    # stream, the slot pools), other rids
    drive(fleet_traffic(np, cfg, FLEET_SLICES, 98, rid0=50_000))
    rt.reset_metrics()
    feats.clear()
    groups0 = service.stats["groups"]

    reqs = fleet_traffic(np, cfg, FLEET_REQUESTS, 2026)
    raws = {r.rid: r.payload.copy() for r in reqs}
    kernels.reset_launch_counts()              # the fleet path starts here
    done, wall = drive(reqs)
    launches = kernels.launch_counts()         # ... and ends here
    groups = service.stats["groups"] - groups0
    rt.close()

    rids = [r.rid for r in done]
    if len(done) != FLEET_REQUESTS or len(set(rids)) != FLEET_REQUESTS:
        fail(f"fleet: served {len(done)} ({len(set(rids))} distinct) of {FLEET_REQUESTS}")
    if rt.shed or rt.dead or not rt.conservation_ok():
        fail(f"fleet: shed {rt.shed_counts()}, dead {rt.dead_counts()}, conservation "
             f"{rt.conservation_ok()}")
    check_no_fallback(rt, "fleet")
    for r in done:
        f = feats.get(r.rid)
        if f is None or f.shape != (98, 80) or not np.isfinite(f).all():
            fail(f"fleet request {r.rid}: features {None if f is None else f.shape}")
        plain = ops.audio_pipeline_batch(torch.from_numpy(raws[r.rid][None]))[0].numpy()
        if not np.allclose(f, plain, rtol=1e-3, atol=1e-2):
            fail(f"fleet request {r.rid}: features differ from the plain CPU pipeline "
                 f"(max abs {np.abs(f - plain).max():.3e})")
    for k in kernels.AUDIO_KERNELS:
        if launches[k] <= 0 or launches[k] != groups:
            fail(f"{k}: {launches[k]} launches on the fleet path, the service launched "
                 f"{groups} groups")
    steps = check_decode_launches(launches, cfg, ms, "fleet path")
    if sum(1 for e in ms.engines.values() if e.stats["admitted"] > 0) < 2:
        fail(f"fleet: the work did not spread over the slices {ms.slice_stats()}")
    ref = single_slice_tokens(torch, np, cfg, ec, model, reqs)
    check_fleet_tokens(np, done, ref, "fleet")
    stats = fleet_stats(np, rt, done, wall, launches, steps, card)
    stats.update(groups=groups, tokens_equal_single_slice=len(done),
                 stage_occupancy=rt.stage_occupancy())
    print("fleet: " + json.dumps(stats))
    return stats, model, ec, ref


def pool_bytes(engines) -> int:
    """Bytes of the slot pools these engines hold on the card (K/V rings,
    or an SSM's conv tails and states, every layer)."""
    return sum(tree_bytes(e._pool) for e in engines
               if e.slot_capacity() and e._pool is not None)


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def chaos_phase(torch, np, model, ec, ref, card):
    from repro_torch import kernels
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.serving import telemetry as tm
    from repro_torch.serving.faults import (DPU_FAIL, RESIZE_ABORT, SLICE_FAIL, STRAGGLER,
                                            FaultEvent, FaultPlan, replay_virtual)
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    cfg = model.cfg
    service = DpuService(DpuServiceConfig(clock="virtual", dpu=DpuConfig(backend="dpu")),
                         device="cuda")
    rt = build_pipelined_runtime(
        cfg, n_slices=FLEET_SLICES, ec=ec, service=service, params=model, hedge_factor=3.0,
        device="cuda", max_retries=10, watchdog_rounds=20, probe_interval_s=0.02,
        rc=RuntimeConfig(clock="virtual", max_ingest=64, preprocess_retries=3,
                         breaker_threshold=2, breaker_probe_s=0.05))
    ms = rt.engine
    # virtual seconds, one tick = 2 ms. Traffic: a burst of 16 at t = 0,
    # then one request every 4 ms from t = 0.2. The burst's launches fail
    # twice and trip the breaker, and it is served on the CPU path; slice 1
    # straggles while its share is dispatched (tick 3) and then fails
    # (tick 4), so that share is requeued; after its 0.04 s heal window a
    # probe readmits it. The breaker's probe at ~0.05 s fails (the third
    # injected failure), the one at 0.2 s closes it, and the second wave
    # meets a straggler on slice 2 and, inside it, a resize to 2 slices
    # aborted straight back to 4
    plan = FaultPlan([
        FaultEvent(at=0.0, kind=DPU_FAIL, param=3),
        FaultEvent(at=0.0, kind=STRAGGLER, target=1, duration=0.0075),
        FaultEvent(at=0.0075, kind=SLICE_FAIL, target=1, duration=0.04),
        FaultEvent(at=0.2, kind=STRAGGLER, target=2, duration=0.03),
        FaultEvent(at=0.22, kind=RESIZE_ABORT, param=2),
    ], seed=18)
    # observers: launch counts when the breaker closes, cache bytes per build
    at_close, cache_bytes = [], []
    event = rt.tracer.event

    def watching_event(kind, t, **kw):
        if kind == tm.BREAKER_CLOSE:
            at_close.append(kernels.launch_counts())
        return event(kind, t, **kw)

    rt.tracer.event = watching_event
    build = ms._build

    def watching_build(n):
        build(n)
        cache_bytes.append(pool_bytes(e for gen in ms._engine_cache.values()
                                      for e in gen.values()))

    ms._build = watching_build
    reqs = fleet_traffic(np, cfg, FLEET_REQUESTS, 2026)  # the fleet phase's requests
    half = FLEET_REQUESTS // 2
    for i, r in enumerate(reqs):               # on the virtual clock
        r.arrival = 0.0 if i < half else 0.2 + 0.004 * (i - half)
    kernels.reset_launch_counts()              # the chaos path starts here
    t0 = time.monotonic()
    done = replay_virtual(rt, reqs, plan)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()         # ... and ends here
    rt.close()

    log = [list(x) for x in rt.injector.log]
    print(f"chaos: injector log {log}")
    if [x[1] for x in log] != [e.kind for e in plan.events] or not rt.injector.done():
        fail(f"chaos: the injector fired {log}, the plan holds {plan.to_json()}")
    if not rt.conservation_ok():
        fail("chaos: conservation does not hold over completed, shed and dead")
    out = [r.rid for r in done] + [r.rid for r in rt.shed] + [r.rid for r in rt.dead]
    if sorted(out) != sorted(r.rid for r in reqs) or not done:
        fail(f"chaos: completed {len(done)}, shed {rt.shed_counts()}, dead "
             f"{rt.dead_counts()} do not partition the {len(reqs)} requests")
    check_fleet_tokens(np, done, ref, "chaos")
    if rt.stats["breaker_trips"] < 1 or rt.stats["cpu_fallback"] < 1 or rt._brk_open \
            or not at_close:
        fail(f"chaos: breaker trips {rt.stats['breaker_trips']}, cpu_fallback "
             f"{rt.stats['cpu_fallback']}, open {rt._brk_open}, closed {len(at_close)} times")
    after = {k: launches[k] - at_close[-1][k] for k in kernels.AUDIO_KERNELS}
    failed_groups = plan.events[0].param
    for k in kernels.AUDIO_KERNELS:
        if after[k] <= 0 or launches[k] != service.stats["groups"] - failed_groups:
            fail(f"{k}: {launches[k]} launches in the chaos run ({after[k]} after the "
                 f"breaker closed), the service formed {service.stats['groups']} groups "
                 f"of which {failed_groups} failed")
    if ms.stats["quarantined"] < 1 or ms.stats["readmitted"] < 1 or ms._quarantined \
            or not all(s.healthy for s in ms.sched.slices.values()):
        fail(f"chaos: quarantined {ms.stats['quarantined']}, readmitted "
             f"{ms.stats['readmitted']}, still quarantined {sorted(ms._quarantined)}")
    if ms.stats["resizes"] != 2 or len(ms.engines) != FLEET_SLICES \
            or ms.stats["requeued"] < 1:
        fail(f"chaos: {ms.stats['resizes']} resizes, {len(ms.engines)} slices at the end, "
             f"{ms.stats['requeued']} requeued")
    steps = check_decode_launches(launches, cfg, ms, "chaos path")
    stats = fleet_stats(np, rt, done, wall, launches, steps, card)
    stats.update(injector_log=log, plan=plan.to_json(), groups=service.stats["groups"],
                 failed_groups=failed_groups, launches_after_breaker_close=after,
                 tokens_equal_single_slice=len(done),
                 slot_pool_bytes_per_engine=pool_bytes(list(ms.engines.values())[:1]),
                 warm_cache_bytes_after_each_build=cache_bytes)
    print("chaos: " + json.dumps(stats))
    return stats

# --- phases 12-13: knee calibration and the partition controller ------------

CONTROLLER_REQUESTS = 48
CONTROLLER_MENU = (1, 2, 4)
# one replay tick is one engine step: a segment of 8 decode steps at the
# card's 4.45 ms of device time a full-width step (PERF.md §5)
CONTROLLER_TICK_S = 0.036
# sha256 of decisions_json() for the controller trace with the reduced
# model's analytical knee profiles (pinned on the CPU by
# tests/test_torch_partition_controller.py)
ANALYTICAL_LOG_SHA256 = "b3a6c0e2297bcad546fca96c6a80fd340588e2f4da80c74c29229107a3908fd4"


def controller_ec():
    """8 KV slots a slice, segment 8, 16 new tokens (two engine steps a
    request, so a switch finds work in flight), prompts up to 128 tokens."""
    from repro_torch.serving.engine import EngineConfig

    return EngineConfig(max_new_tokens=16, continuous=True, max_slots=8, segment_len=8,
                        max_prompt_len=128)


def controller_trace(np, vocab: int):
    """The phased trace: a quiet phase of long prompts (4 /s, mean 100
    tokens, 0.5 s), then a burst of short ones (400 /s, mean 12 tokens);
    1 s of 48 kHz audio each. Arrivals and lengths do not depend on vocab."""
    from repro_torch.serving.requests import Phase, WorkloadSpec, generate_requests

    spec = WorkloadSpec(modality="text", rate_qps=4.0, mean_len=100.0, sigma=0.1,
                        max_len=120.0, vocab=vocab, payload_samples=48_000, seed=19,
                        phases=(Phase(0.5, 4.0, mean_len=100.0),
                                Phase(0.5, 400.0, mean_len=12.0, sigma=0.2, max_len=31.0)))
    return generate_requests(spec, CONTROLLER_REQUESTS)


def analytical_profiles():
    """The knee profiles a fleet of the reduced model derives by default
    (the analytical roofline knee per 64-token bucket): explicit here, so a
    full-width fleet on the card runs the CPU test's cost model."""
    from repro_torch.configs import reduced
    from repro_torch.core.batching import analytical_knee, kv_bytes_per_token

    cfg, ec = reduced("tinyllama-1.1b"), controller_ec()
    return {b: analytical_knee(cfg.active_param_count(), chips=1,
                               context_len=int((b + 0.5) * ec.bucket_width),
                               kv_bytes_per_token=kv_bytes_per_token(cfg))
            for b in range(8)}


def controller_replay(torch, np, model, profiles, device):
    """One virtual-clock replay of the controller trace through a fleet
    that starts at 1 slice; returns (runtime, controller, completed)."""
    from repro_torch.core.control import ControllerConfig, PartitionController
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.serving.faults import replay_virtual
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    service = DpuService(DpuServiceConfig(clock="virtual", dpu=DpuConfig(backend="dpu")),
                         device=device)
    ctl = PartitionController(ControllerConfig(menu=CONTROLLER_MENU))
    rt = build_pipelined_runtime(model.cfg, n_slices=1, ec=controller_ec(), service=service,
                                 params=model, device=device, controller=ctl,
                                 knee_profiles=profiles,
                                 rc=RuntimeConfig(clock="virtual", max_ingest=64))
    rt.engine.fixed_expected_s = 1.0           # no hedge reads the wall clock
    done = replay_virtual(rt, controller_trace(np, model.cfg.vocab), tick=CONTROLLER_TICK_S)
    if device == "cuda":
        torch.cuda.synchronize()
    rt.close()
    return rt, ctl, done


def knee_phase(torch, np, card):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.batching.knee import profiles_from_json
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config("tinyllama-1.1b")
    path = ROOT / "build" / "knee_profiles.json"
    path.parent.mkdir(exist_ok=True)
    points = []

    def on_point(batch, context_len, best_s, step):
        dev = profile_decode_steps(torch, step, 1e3 * best_s, n=3)["device_ms_per_step"]
        points.append(dict(batch=batch, context_len=context_len, wall_ms=1e3 * best_s,
                           device_ms=dev))
        print(f"knee: context {context_len}, batch {batch}: wall {1e3 * best_s:.3f} ms, "
              f"device {dev:.3f} ms")

    steps = [0]
    decode = lm.decode

    def counting_decode(*a, **kw):
        steps[0] += 1
        return decode(*a, **kw)

    lm.decode = counting_decode
    kernels.reset_launch_counts()              # the knee pass starts here
    t0 = time.monotonic()
    try:
        profiles = serve._calibrate_knee(cfg, controller_ec(), str(path), max_batch=8,
                                         device="cuda", on_point=on_point)
    finally:
        lm.decode = decode
    launches = kernels.launch_counts()         # ... and ends here
    wall = time.monotonic() - t0
    if sorted(profiles) != [0, 1] or profiles_from_json(path.read_text()) != profiles:
        fail(f"knee: buckets {sorted(profiles)}, or {path.name} does not read back equal")
    for b, p in profiles.items():
        if p.batch_sizes != (1, 2, 4, 8) or not all(0 < x < 10 for x in p.latencies):
            fail(f"knee: bucket {b} profile {p}")
    if launches["decode_attention"] != cfg.n_layers * steps[0] or steps[0] <= 0:
        fail(f"decode_attention: {launches['decode_attention']} launches in the knee pass, "
             f"{steps[0]} decode steps of {cfg.n_layers} layers")
    knees = {b: dict(batch_knee=p.batch_knee, time_knee_ms=1e3 * p.time_knee)
             for b, p in sorted(profiles.items())}
    for b, k in knees.items():
        print(f"knee: bucket {b} (context {int((b + 0.5) * 64)}): "
              f"Batch_knee={k['batch_knee']} Time_knee={k['time_knee_ms']:.3f} ms")
    stats = dict(card=card, points=points, knees=knees, decode_steps=steps[0],
                 launches=launches, wall_s=wall)
    print("knee: " + json.dumps(stats))
    return stats, profiles


def controller_phase(torch, np, model, profiles, card):
    from repro_torch import kernels
    from repro_torch.serving import telemetry as tm

    cfg = model.cfg
    runs = []
    for _ in range(2):
        kernels.reset_launch_counts()          # the controller path starts here
        t0 = time.monotonic()
        rt, ctl, done = controller_replay(torch, np, model, profiles, "cuda")
        runs.append((rt, ctl, done, kernels.launch_counts(), time.monotonic() - t0))
    (rt, ctl, done, launches, wall), (rt2, ctl2, done2, launches2, _) = runs
    log = ctl.decisions_json()
    if log != ctl2.decisions_json():
        fail(f"controller: the two replays' decision logs differ:\n{log}\n"
             f"{ctl2.decisions_json()}")
    toks2 = {r.rid: np.asarray(r.payload) for r in done2}
    for r in done:
        if r.rid not in toks2 or not np.array_equal(np.asarray(r.payload), toks2[r.rid]):
            fail(f"controller: request {r.rid} tokens differ between the two replays")
    if not ctl.decisions:
        fail("controller: no switch was logged")
    for x, c in ((rt, ctl), (rt2, ctl2)):
        n = len(c.decisions)
        if x.registry.value("fleet_reconfigs_total") != n or len(x.tracer.of(tm.RECONFIG)) != n:
            fail(f"controller: fleet_reconfigs_total {x.registry.value('fleet_reconfigs_total')}"
                 f", reconfig spans {len(x.tracer.of(tm.RECONFIG))}, decisions {n}")
        rids = sorted(r.rid for r in x.completed)
        if rids != list(range(CONTROLLER_REQUESTS)) or x.dead or x.shed \
                or not x.conservation_ok():
            fail(f"controller: served {len(rids)} ({len(set(rids))} distinct) of "
                 f"{CONTROLLER_REQUESTS}, shed {x.shed_counts()}, dead {x.dead_counts()}")
        check_no_fallback(x, "controller")
    for x, _, _, ls, _ in runs:
        groups = x.service.stats["groups"]
        for k in kernels.AUDIO_KERNELS:
            if ls[k] <= 0 or ls[k] != groups:
                fail(f"{k}: {ls[k]} launches on the controller path, the service "
                     f"launched {groups} groups")
        check_decode_launches(ls, cfg, x.engine, "controller path")
    steps = rt.engine.decode_steps_total()
    switches = [(d.t, d.from_slices, d.to_slices, d.reason) for d in ctl.decisions]
    sha = hashlib.sha256(log.encode()).hexdigest()
    print(f"controller: switches (t, from, to, reason) {switches}; "
          f"decisions_json sha256 {sha}")
    rt_a, ctl_a, done_a = controller_replay(torch, np, model, analytical_profiles(), "cuda")
    sha_a = hashlib.sha256(ctl_a.decisions_json().encode()).hexdigest()
    print(f"controller, analytical profiles: switches "
          f"{[(d.t, d.from_slices, d.to_slices, d.reason) for d in ctl_a.decisions]}; "
          f"decisions_json sha256 {sha_a}")
    if sha_a != ANALYTICAL_LOG_SHA256:
        fail(f"controller: the analytical-profile log {ctl_a.decisions_json()} has sha256 "
             f"{sha_a}, the CPU test pins {ANALYTICAL_LOG_SHA256}")
    if len(done_a) != CONTROLLER_REQUESTS or rt_a.dead or not rt_a.conservation_ok():
        fail(f"controller, analytical profiles: served {len(done_a)}, dead "
             f"{rt_a.dead_counts()}")
    ms = rt.engine
    stats = fleet_stats(np, rt, done, wall, launches, steps, card)
    stats.update(decisions=json.loads(log), decisions_sha256=sha, switches=switches,
                 reconfigs_total=rt.registry.value("fleet_reconfigs_total"),
                 reconfig_spans=len(rt.tracer.of(tm.RECONFIG)),
                 groups=rt.service.stats["groups"], slices_at_end=len(ms.pod.slices),
                 tokens_equal_across_replays=len(done),
                 analytical_decisions=json.loads(ctl_a.decisions_json()),
                 analytical_sha256=sha_a, launches_second_replay=launches2,
                 warm_cache_bytes=pool_bytes(e for gen in ms._engine_cache.values()
                                             for e in gen.values()))
    print("controller: " + json.dumps(stats))
    return stats


# --- phase 14: PREBA's two-model fleet (tinyllama + mamba2) at full width ---

MT_TENANT_A, MT_TENANT_B = "tinyllama-1.1b", "mamba2-370m"
MT_REQUESTS, MT_RATE, MT_SLICES_EACH, MT_MAX_NEW = 32, 40.0, 2, 16
MT_MEAN_LEN, MT_SIGMA = 24.0, 0.05   # lognormal prompts, all in the (16, 32] bucket
SSD_TOL = (2e-3, 2e-3)               # rtol, atol: the JAX package's own SSD test tolerance
SSM_CONTRACT_BUDGET = 8
SSM_FLEET_LENS = [24, 17, 31, 20, 28, 19, 32, 22]   # one (16, 32] prompt bucket


def mt_specs(cfgs, seed0: int = 61):
    """Bench part 8's traffic (benchmarks/bench_engine.py, `_mt_specs`): one
    Poisson stream per tenant at 40 /s, tenants in name order with seeds
    seed0 + k, prompts lognormal (mean 24, sigma 0.05) capped at 32 tokens,
    merged by the shared multi-tenant generator; each request also carries
    1 s of 48 kHz audio for the DPU."""
    from repro_torch.serving.requests import WorkloadSpec

    return [(WorkloadSpec(modality="text", rate_qps=MT_RATE, mean_len=MT_MEAN_LEN,
                          sigma=MT_SIGMA, max_len=32.0, vocab=c.vocab, model=name,
                          seed=seed0 + k, payload_samples=48_000), 1.0)
            for k, (name, c) in enumerate(sorted(cfgs.items()))]


def ssd_check(torch, np, cfg):
    """ssd_chunked against the sequential ssm_step recurrence, on the card in
    fp32 at the config's head shapes (h, p, n) and L in {32, 64}: with the
    config's chunk (one chunk) and with 16 (several, the inter-chunk scan).
    Tolerance SSD_TOL on the outputs and the final state."""
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    b, h, p, n, g = 2, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    rows = []
    for length in (32, 64):
        x = torch.randn(b, length, h, p, generator=gen, device=dev)
        dt = 0.001 + 0.1 * torch.rand(b, length, h, generator=gen, device=dev)
        A = -(0.5 + 4.0 * torch.rand(h, generator=gen, device=dev))
        Bm = torch.randn(b, length, g, n, generator=gen, device=dev)
        Cm = torch.randn(b, length, g, n, generator=gen, device=dev)
        st = torch.zeros(b, h, p, n, device=dev)
        ys = []
        for t in range(length):
            y1, st = L.ssm_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], st)
            ys.append(y1)
        y_seq = torch.stack(ys, dim=1)
        for chunk in (cfg.ssm_chunk, 16):
            y, fin = L.ssd_chunked(x, dt, A, Bm, Cm, chunk)
            ok = all(bool(torch.isfinite(a).all()) and torch.allclose(
                a, want, rtol=SSD_TOL[0], atol=SSD_TOL[1]) for a, want in ((y, y_seq), (fin, st)))
            rows.append(dict(L=length, chunk=chunk, h=h, p=p, n=n,
                             y_max_abs_err=float((y - y_seq).abs().max()),
                             y_max_abs=float(y_seq.abs().max()),
                             state_max_abs_err=float((fin - st).abs().max()), ok=ok))
            if not ok:
                fail(f"ssd_chunked differs from the ssm_step recurrence on the card: {rows[-1]}")
    print("ssd vs recurrence: " + json.dumps(rows))
    return rows


# The within-port SSM contracts at full width (d_model 1024, 32 heads of 64,
# state 128; 2 layers, bf16, seeded weights), bit for bit on tokens, the
# conv tail and state rows, and the next step's logits. tests/test_torch_card.py
# runs each of them as a gpu test.


def ssm_contract_model(torch, n_layers: int = 2):
    """(cfg, LM, device): mamba2-370m at full width, n_layers layers, bf16,
    the weights of seed 0."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.api import LM
    from repro_torch.models.params import init_params

    dev = torch.device("cuda")
    cfg = replace(get_config(MT_TENANT_B), n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, LM(cfg, init_params(cfg, gen, dev, cfg.dtype)), dev


def _bits(torch, got, want) -> dict:
    d = (got.float() - want.float()).abs()
    return dict(equal=bool(torch.equal(got, want)), differing=int((got != want).sum()),
                max_diff=float(d.max()))


def _ssm_row(pool, row):
    """Pool row `row` as a one-row pool (its conv tail and state, every layer)."""
    m = pool["body"]["l0"]["mixer"]
    return {"body": {"l0": {"mixer": {k: v[:, row:row + 1].clone() for k, v in m.items()}}}}


def _ssm_compare(torch, model, got_row, want_row, got_tok, want_tok) -> dict:
    """Tokens, conv and state rows, and the logits of one more decode step
    from each row (a copy), bit for bit."""
    gm, wm = got_row["body"]["l0"]["mixer"], want_row["body"]["l0"]["mixer"]
    out = {"tokens": _bits(torch, got_tok, want_tok),
           "conv": _bits(torch, gm["conv"], wm["conv"]),
           "state": _bits(torch, gm["state"], wm["state"])}
    lg = []
    dev = gm["state"].device
    for row, tok in ((got_row, got_tok), (want_row, want_tok)):
        t = tok.reshape(-1)[-1:].reshape(1, 1).to(dev)
        lg.append(model.decode(_ssm_row(row, 0), t, 0)[0][0, 0])
    out["logits"] = _bits(torch, lg[0], lg[1])
    out["equal"] = all(v["equal"] for v in out.values())
    return out


def _ssm_block(torch, np, cfg, lens, lp, seed, dev):
    """Left-padded [len(lens), lp] prompt block and its offsets."""
    toks = np.zeros((len(lens), lp), np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = np.random.default_rng(seed + i).integers(0, cfg.vocab, n)
    off = np.array([lp - n for n in lens], np.int64)
    return torch.from_numpy(toks).to(dev), torch.from_numpy(off).to(dev)


def ssm_contract_padded(torch, np, cfg, model, dev) -> dict:
    """A 20-token prompt prefilled alone == left-padded into a 3 x 32
    bucket next to two others: last-position logits, conv tail and state,
    and generate's 8 tokens."""
    n, lp, steps = 20, 32, SSM_CONTRACT_BUDGET
    alone, _ = _ssm_block(torch, np, cfg, [n], n, 1, dev)
    la, ca = model.prefill(alone)
    toks, off = _ssm_block(torch, np, cfg, [n, 30, 7], lp, 1, dev)
    lb, cb = model.prefill(toks, pos_offset=off)
    ta, _ = model.generate(_ssm_row(ca, 0), la, n, steps=steps)
    tb, _ = model.generate(_ssm_row(cb, 0), lb[:1], lp, steps=steps, pos_offset=off[:1])
    ca_m, cb_m = ca["body"]["l0"]["mixer"], cb["body"]["l0"]["mixer"]
    out = {"last_logits": _bits(torch, lb[0], la[0]),
           "conv": _bits(torch, cb_m["conv"][:, :1], ca_m["conv"]),
           "state": _bits(torch, cb_m["state"][:, :1], ca_m["state"]),
           "tokens_agree": int((ta[0] == tb[0]).sum()), "tokens": steps}
    out["equal"] = all(out[k]["equal"] for k in ("last_logits", "conv", "state"))
    return out


def ssm_contract_join(torch, np, cfg, model, dev) -> dict:
    """Request B admitted into slot 1 while A decodes in slot 0 (slot 1
    already advanced by A's segment: an SSM decode step runs every row)
    == B served alone in a fresh pool: tokens, rows, next logits."""
    from repro_torch.models import lm

    nb, steps = 27, SSM_CONTRACT_BUDGET

    def serve_b(pool, clock, tok, off_a):
        toks, off = _ssm_block(torch, np, cfg, [nb], 32, 5, dev)
        t0b, pool = model.prefill_into_slots(toks, pool, torch.tensor([1], device=dev),
                                             clock, pos_offset=off)
        poff = torch.tensor([off_a, clock - nb], device=dev)
        tok = tok.clone()
        tok[1] = t0b[0]
        seg, pool = model.decode_segment(pool, tok, clock, steps=steps, pos_offset=poff)
        return seg[1], pool

    zero = torch.zeros(2, 1, dtype=torch.long, device=dev)
    solo, pool_s = serve_b(lm.alloc_slot_pool(cfg, 2, 64, dev), 32, zero, 0)
    pool = lm.alloc_slot_pool(cfg, 2, 64, dev)
    toks, off = _ssm_block(torch, np, cfg, [20], 32, 4, dev)
    t0a, pool = model.prefill_into_slots(toks, pool, torch.tensor([0], device=dev), 32,
                                         pos_offset=off)
    tok = torch.cat([t0a, zero[:1]])
    seg, pool = model.decode_segment(pool, tok, 32, steps=3,
                                     pos_offset=torch.tensor([12, 0], device=dev))
    tok = torch.cat([seg[:1, -1:], zero[:1]])
    joined, pool_j = serve_b(pool, 35, tok, 12)
    return _ssm_compare(torch, model, _ssm_row(pool_j, 1), _ssm_row(pool_s, 1), joined, solo)


def ssm_contract_chained(torch, np, cfg, model, dev) -> dict:
    """decode_segment(3) then decode_segment(5) == eight single decode
    steps, for both rows of an admitted pair."""
    from repro_torch.models import lm

    lens, clock = (30, 13), 32

    def admitted():
        pool = lm.alloc_slot_pool(cfg, 2, 64, dev)
        toks, off = _ssm_block(torch, np, cfg, list(lens), 32, 7, dev)
        tok0, pool = model.prefill_into_slots(toks, pool, torch.arange(2, device=dev),
                                              clock, pos_offset=off)
        return tok0, pool, torch.tensor([clock - n for n in lens], device=dev)

    tok0, pool_c, poff = admitted()
    s1, pool_c = model.decode_segment(pool_c, tok0, clock, steps=3, pos_offset=poff)
    s2, pool_c = model.decode_segment(pool_c, s1[:, -1:], clock + 3, steps=5,
                                      pos_offset=poff)
    chained = torch.cat([s1, s2], dim=1)
    tok, pool_s, poff = admitted()
    seq = []
    for i in range(8):
        logits, pool_s = model.decode(pool_s, tok, clock + i, pos_offset=poff)
        tok = torch.argmax(logits, -1)
        seq.append(tok)
    seq = torch.cat(seq, dim=1)
    rows = [_ssm_compare(torch, model, _ssm_row(pool_c, r), _ssm_row(pool_s, r),
                         chained[r], seq[r]) for r in range(2)]
    return {"rows": rows, "equal": all(r["equal"] for r in rows)}


def ssm_contract_multi_slice(torch, np, cfg, model, dev) -> dict:
    """Two slices, each an engine on its own CUDA stream, sharing one LM ==
    one engine: per request its tokens, the conv and state rows it held
    when it retired, and the logits of one more step, bit for bit."""
    from repro_torch.core.batching.buckets import Request
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.multislice import build_multislice_engine

    ec = EngineConfig(continuous=True, max_slots=8, segment_len=SSM_CONTRACT_BUDGET,
                      max_new_tokens=SSM_CONTRACT_BUDGET, max_prompt_len=32)

    def reqs():
        return [Request(rid=i, arrival=0.0, length=float(n)) for i, n in
                enumerate(SSM_FLEET_LENS)]

    def spy_rows(engine, rows):
        """Snapshot each live row as it may retire (an SSM row's state
        keeps moving with the pool's later steps)."""
        orig = engine._retire_finished

        def spy(now):
            for s, st in enumerate(engine._slots):
                if st is not None and st.live:
                    rows[st.req.rid] = _ssm_row(engine._pool, s)
            orig(now)

        engine._retire_finished = spy

    want_rows, got_rows = {}, {}
    single = build_engine(cfg, ec=ec, device=dev, params=model.tree())
    spy_rows(single, want_rows)
    single.submit_many(reqs())
    want = {r.rid: r.payload for r in single.run_until_idle()}
    fleet = build_multislice_engine(cfg, n_slices=2, ec=ec, device=dev, params=model)
    streams = {e.stream for e in fleet.engines.values()}
    for e in fleet.engines.values():
        spy_rows(e, got_rows)
    fleet.submit_many(reqs())
    done = fleet.run_until_idle()
    torch.cuda.synchronize()
    per_rid = {r.rid: _ssm_compare(torch, model, got_rows[r.rid], want_rows[r.rid],
                                   torch.as_tensor(np.asarray(r.payload)),
                                   torch.as_tensor(np.asarray(want[r.rid])))
               for r in done}
    spread = sum(1 for e in fleet.engines.values() if e.stats["admitted"] > 0)
    return {"served": len(done), "slices_used": spread, "streams": len(streams),
            "differing_rids": sorted(rid for rid, v in per_rid.items() if not v["equal"]),
            "equal": len(done) == len(SSM_FLEET_LENS) and spread == 2 and len(streams) == 2
            and all(v["equal"] for v in per_rid.values())}


def ssm_decode_step_profile(torch, model):
    """One full-width mamba2 decode step at batch 8 (random conv and state
    rows): its wall ms (best of two runs of 20 steps) and a torch.profiler
    pass over 5 steps. It must launch no decode-attention kernel."""
    from repro_torch import kernels
    from repro_torch.models import lm

    cfg, dev = model.cfg, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = lm.alloc_slot_pool(cfg, 8, 64, dev)
    for leaf in pool["body"]["l0"]["mixer"].values():
        leaf.normal_(generator=gen).mul_(0.1)
    tok = torch.randint(0, cfg.vocab, (8, 1), generator=gen, device=dev)

    def step():
        model.decode(pool, tok, 0)

    def steps_ms(n=20):
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    before = kernels.launch_counts()["decode_attention"]
    wall = min(steps_ms(), steps_ms())
    prof = profile_decode_steps(torch, step, wall)
    if kernels.launch_counts()["decode_attention"] != before or \
            prof["decode_attention_calls_per_step"]:
        fail("a mamba2 decode step launched the decode attention kernel")
    res = {"layers": cfg.n_layers, "batch": 8, "wall_ms": wall, **prof}
    print(f"mamba2 decode step ({cfg.n_layers} layers, 8 slots, {cfg.dtype}): "
          f"wall {wall:.3f} ms, device {prof['device_ms_per_step']:.3f} ms, "
          f"{prof['kernel_launches_per_step']:.0f} launches")
    print("mamba2 decode step profile: " + json.dumps(res))
    return res


def mt_fleet_phase(torch, np, params, card):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.kernels import ops
    from repro_torch.models.api import LM
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.multislice import TenantSpec
    from repro_torch.serving.requests import generate_requests
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    dev = torch.device("cuda")
    cfgs = {m: get_config(m) for m in (MT_TENANT_A, MT_TENANT_B)}
    cfg_a, cfg_b = cfgs[MT_TENANT_A], cfgs[MT_TENANT_B]
    gen = torch.Generator(device=dev).manual_seed(0)
    models = {MT_TENANT_A: LM(cfg_a, params),
              MT_TENANT_B: LM(cfg_b, init_params(cfg_b, gen, dev, cfg_b.dtype))}
    res = {"card": card, "ssd_vs_recurrence": ssd_check(torch, np, cfg_b)}

    ccfg, cmodel, _ = ssm_contract_model(torch)
    contracts = {name: fn(torch, np, ccfg, cmodel, dev) for name, fn in (
        ("padded_equals_unpadded", ssm_contract_padded),
        ("join_equals_alone", ssm_contract_join),
        ("chained_equals_sequential", ssm_contract_chained),
        ("multi_slice_equals_single_slice", ssm_contract_multi_slice))}
    del cmodel
    print("ssm contracts: " + json.dumps(contracts))
    for name in ("join_equals_alone", "chained_equals_sequential",
                 "multi_slice_equals_single_slice"):
        if not contracts[name]["equal"]:
            fail(f"ssm contract {name} does not hold on the card: {contracts[name]}")
    res["contracts"] = contracts
    res["mamba2_decode_step"] = ssm_decode_step_profile(torch, models[MT_TENANT_B])

    ec = EngineConfig(max_new_tokens=MT_MAX_NEW, continuous=True, max_slots=8, segment_len=8,
                      max_prompt_len=32)
    service = DpuService(DpuServiceConfig(clock="wall", dpu=DpuConfig(backend="dpu")),
                         device="cuda")
    feats = {}
    poll = service.poll

    def recording_poll(now, n=None):
        out = poll(now, n)
        for r in out:
            feats[r.rid] = np.array(r.payload)
        return out

    service.poll = recording_poll
    rt = build_pipelined_runtime(
        None, n_slices=MT_SLICES_EACH * len(cfgs), ec=ec, service=service, device="cuda",
        tenants=[TenantSpec(cfg=cfgs[m], name=m, n_slices=MT_SLICES_EACH, params=models[m])
                 for m in (MT_TENANT_A, MT_TENANT_B)],
        rc=RuntimeConfig(clock="wall", max_ingest=64))
    ms = rt.engine
    streams = {id(e.stream) for e in ms.engines.values()}
    if len(streams) != len(ms.engines) or any(
            e.model is not models[ms.slice_tenant[sid]] for sid, e in ms.engines.items()):
        fail(f"two-model fleet: {len(streams)} streams for {len(ms.engines)} slices, or a "
             f"slice serves another tenant's model")

    def drive(reqs):
        """Bench part 8's wall-clock replay: each request is submitted when
        its arrival time passes (arrivals rebased onto the clock), the
        runtime steps in between; returns (done, makespan)."""
        t0 = time.monotonic()
        for r in reqs:
            r.arrival += t0
        i = 0
        while i < len(reqs) or rt.busy():
            while i < len(reqs) and reqs[i].arrival <= time.monotonic():
                rt.submit(reqs[i])
                i += 1
            if rt.step():
                continue
            if i < len(reqs):
                time.sleep(min(max(reqs[i].arrival - time.monotonic(), 0.0), 0.002))
            elif rt.busy():
                time.sleep(0.0005)            # the DPU worker runs
        torch.cuda.synchronize()
        return list(rt.completed), time.monotonic() - t0

    # warm-up: a full admission group per slice of each tenant, other rids
    warm = generate_requests(mt_specs(cfgs, seed0=161), 8 * len(ms.engines))
    for i, r in enumerate(warm):
        r.rid, r.arrival = 900_000 + i, 0.0
    drive(warm)
    rt.reset_metrics()
    feats.clear()
    groups0 = service.stats["groups"]

    reqs = generate_requests(mt_specs(cfgs), MT_REQUESTS)
    asked = {m: sum(1 for r in reqs if r.model == m) for m in cfgs}
    raws = {r.rid: r.payload.copy() for r in reqs}
    kernels.reset_launch_counts()              # the two-model fleet's path starts here
    done, wall = drive(reqs)
    launches = kernels.launch_counts()         # ... and ends here
    groups = service.stats["groups"] - groups0
    rt.close()

    rids = [r.rid for r in done]
    if len(done) != MT_REQUESTS or len(set(rids)) != MT_REQUESTS:
        fail(f"two-model fleet: served {len(done)} ({len(set(rids))} distinct) of "
             f"{MT_REQUESTS}")
    if rt.shed or rt.dead or not rt.conservation_ok():
        fail(f"two-model fleet: shed {rt.shed_counts()}, dead {rt.dead_counts()}, "
             f"conservation {rt.conservation_ok()}")
    check_no_fallback(rt, "two-model fleet")
    ts = ms.tenant_stats()
    for m in cfgs:
        served = sum(1 for r in done if r.model == m)
        if served != asked[m] or ts[m]["completed"] != asked[m] or ts[m]["dead"]:
            fail(f"two-model fleet, tenant {m}: served {served} of {asked[m]}, {ts[m]}")
        if not set(ts[m]["routed_to"]) <= set(ts[m]["slices"]):
            fail(f"two-model fleet: tenant {m}'s requests ran on {ts[m]['routed_to']}, "
                 f"its slices are {ts[m]['slices']}")
    for r in done:
        f = feats.get(r.rid)
        if f is None or f.shape != (98, 80) or not np.isfinite(f).all():
            fail(f"two-model fleet request {r.rid}: features {None if f is None else f.shape}")
        plain = ops.audio_pipeline_batch(torch.from_numpy(raws[r.rid][None]))[0].numpy()
        if not np.allclose(f, plain, rtol=1e-3, atol=1e-2):
            fail(f"two-model fleet request {r.rid}: features differ from the plain CPU "
                 f"pipeline (max abs {np.abs(f - plain).max():.3e})")
    for k in kernels.AUDIO_KERNELS:
        if launches[k] <= 0 or launches[k] != groups:
            fail(f"{k}: {launches[k]} launches on the two-model fleet's path, the service "
                 f"launched {groups} groups")
    steps = {m: ms.decode_steps_total(m) for m in cfgs}
    check_decode_launches(launches, cfg_a, ms, "two-model fleet's path", tenant=MT_TENANT_A)
    if steps[MT_TENANT_B] <= 0:
        fail(f"two-model fleet: the {MT_TENANT_B} tenant ran no decode step")
    per_tenant = {}
    for m in cfgs:
        mine = [r for r in done if r.model == m]
        ref = single_slice_tokens(torch, np, cfgs[m], ec, models[m], mine)
        check_fleet_tokens(np, mine, ref, f"two-model fleet, tenant {m}")
        lat = np.array([r.completed_at - r.arrival for r in mine])
        ttft = np.array([r.first_token_at - r.arrival for r in mine])
        n_tok = int(sum(len(r.payload) for r in mine))
        per_tenant[m] = dict(
            served=len(mine), tokens=n_tok, tokens_per_s=n_tok / wall,
            latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
            latency_p99_ms=1e3 * float(np.percentile(lat, 99)),
            ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
            ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
            decode_steps=steps[m], slices=sorted(ts[m]["slices"]),
            # the tenant's engine calls (admissions and segments), host copy included
            exec_s=sum(sum(e.batch_exec_s) for e in {id(e): e for e in ms._built}.values()
                       if e._tenant == m),
            routed_to=sorted(set(ts[m]["routed_to"])), tokens_equal_single_slice=len(mine))
        print(f"two-model fleet, {m}: " + json.dumps(per_tenant[m]))
    stats = fleet_stats(np, rt, done, wall, launches, steps[MT_TENANT_A], card)
    stats.update(groups=groups, per_tenant=per_tenant, stage_occupancy=rt.stage_occupancy(),
                 slot_pool_bytes={m: pool_bytes(ms.engines[s] for s in ms.slices_of(m))
                                  for m in cfgs})
    print("two-model fleet: " + json.dumps(stats))
    res.update(stats)
    return res


# --- 15. the rest of the dense family and the MoE family ----------------------

# arch: layers served in phase 15 (None: all of them); the cuts keep the bf16
# weights of each inside one card beside its pools
NEW_ARCH_DEPTH = {"h2o-danube-1.8b": None, "granite-3-8b": None, "yi-34b": 8,
                  "mixtral-8x22b": 4, "moonshot-v1-16b-a3b": 8}
NEW_REQUESTS, NEW_MAX_NEW = 8, 8
CONTRACT_SLOTS, CONTRACT_STEPS = 8, 8
CONTRACT_LENS_A, CONTRACT_LEN_B = [30, 13, 25, 7, 19, 32, 11], 21  # one 32-token bucket
WRAP_ARCH = "h2o-danube-1.8b"  # its window ring is made to wrap on the card
WRAP_PROMPT, WRAP_STEPS, WRAP_CHECK_STEP = 4000, 200, 150  # the ring wraps at step 96


def n_attn_layers(cfg) -> int:
    """Decode attention launches a decode step: the self-attention layers,
    and an encoder-decoder's cross-attention sublayers (one a layer)."""
    return (sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
            + (cfg.n_layers if cfg.enc_layers else 0))


def _map_pool(pool, fn):
    """fn(leaf name, leaf, stacked) over a cache tree's leaves (body leaves
    carry a leading block axis, prefix leaves none)."""
    def walk(t, stacked):
        return {k: walk(v, stacked) if isinstance(v, dict) else fn(k, v, stacked)
                for k, v in t.items()}
    return {top: walk(sub, top == "body") for top, sub in pool.items()}


def _cache_rows(torch, pool, row, n):
    """Row `row` of every layer's cache, flattened into one fp32 tensor (an
    exact copy of its bits): K and V over ring slots [0, n), an SSM layer's
    conv tail and state whole."""
    parts = []

    def take(k, v, stacked):
        r = v[:, row] if stacked else v[row][None]
        parts.append((r[:, :n] if k in ("k", "v") else r).reshape(-1).float())

    _map_pool(pool, take)
    return torch.cat(parts)


def _attn_block(torch, np, cfg, lens, seed, dev, width=CONTRACT_SLOTS, lp=32):
    """A [width, lp] left-padded bucket: rows past len(lens) wholly padding."""
    toks = np.zeros((width, lp), np.int64)
    off = np.full(width, lp, np.int64)
    for i, n in enumerate(lens):
        toks[i, lp - n:] = np.random.default_rng(seed + i).integers(0, cfg.vocab, n)
        off[i] = lp - n
    return torch.from_numpy(toks).to(dev), torch.from_numpy(off).to(dev)


def attn_contracts(torch, np, cfg, model, dev) -> dict:
    """The within-port contracts of an attention model, in a pool of 8 slots
    (ring 64), bit for bit. join == alone: request B (21 tokens) admitted
    into slot 7 at clock 35 while seven others decode in slots 0-6 (three
    steps in) == B admitted into an idle pool: its tokens, its K and V over
    the slots it wrote, and its logits one step later. chained ==
    sequential: decode_segment(3) then (5) == eight decode steps, every
    row. An MoE token's expert capacity depends on its decode group, so
    join may differ there (the JAX package's own contract, tests/
    test_torch_moe.py). A row's state is its K and V over the slots it
    wrote and, in a hybrid, its SSM layers' conv tails and states."""
    from repro_torch.models import lm

    slots, steps = CONTRACT_SLOTS, CONTRACT_STEPS

    def pool0():
        return lm.alloc_slot_pool(cfg, slots, 64, dev)

    def admit(pool, lens, rows, clock, seed):
        toks, off = _attn_block(torch, np, cfg, lens, seed, dev)
        sids = torch.full((slots,), slots, dtype=torch.long, device=dev)
        sids[:len(rows)] = torch.tensor(rows, device=dev)
        t0, pool = model.prefill_into_slots(toks, pool, sids, clock, pos_offset=off)
        return t0[:len(rows)], pool

    def serve_b(pool, clock, tok, poff):
        t0b, pool = admit(pool, [CONTRACT_LEN_B], [slots - 1], clock, 5)
        poff, tok = poff.clone(), tok.clone()
        poff[-1], tok[-1] = clock - CONTRACT_LEN_B, t0b[0]
        seg, pool = model.decode_segment(pool, tok, clock, steps=steps, pos_offset=poff)
        logits, pool = model.decode(pool, seg[:, -1:], clock + steps, pos_offset=poff)
        return torch.cat([t0b[0], seg[-1]]), pool, logits[-1]

    zero_tok = torch.zeros(slots, 1, dtype=torch.long, device=dev)
    zero_off = torch.zeros(slots, dtype=torch.long, device=dev)
    solo, pool_s, lg_s = serve_b(pool0(), 35, zero_tok, zero_off)
    rows_a = list(range(len(CONTRACT_LENS_A)))
    t0a, pool = admit(pool0(), CONTRACT_LENS_A, rows_a, 32, 4)
    poff = zero_off.clone()
    poff[:len(rows_a)] = 32 - torch.tensor(CONTRACT_LENS_A, device=dev)
    tok = zero_tok.clone()
    tok[:len(rows_a)] = t0a
    seg, pool = model.decode_segment(pool, tok, 32, steps=3, pos_offset=poff)
    joined, pool_j, lg_j = serve_b(pool, 35, seg[:, -1:], poff)
    n_kv = CONTRACT_LEN_B + steps + 1
    join = {"tokens": _bits(torch, joined, solo),
            "kv": _bits(torch, _cache_rows(torch, pool_j, slots - 1, n_kv),
                        _cache_rows(torch, pool_s, slots - 1, n_kv)),
            "logits": _bits(torch, lg_j, lg_s)}
    join["equal"] = all(v["equal"] for v in join.values())

    lens = CONTRACT_LENS_A + [CONTRACT_LEN_B]

    def admitted():
        t0, pool = admit(pool0(), lens, list(range(slots)), 32, 7)
        return t0, pool, 32 - torch.tensor(lens, device=dev)

    tok0, pool_c, poff = admitted()
    s1, pool_c = model.decode_segment(pool_c, tok0, 32, steps=3, pos_offset=poff)
    s2, pool_c = model.decode_segment(pool_c, s1[:, -1:], 35, steps=steps - 3,
                                      pos_offset=poff)
    chained = torch.cat([s1, s2], dim=1)
    tok, pool_q, _ = admitted()
    seq = []
    for i in range(steps):
        logits, pool_q = model.decode(pool_q, tok, 32 + i, pos_offset=poff)
        tok = torch.argmax(logits, -1)
        seq.append(tok)
    seq = torch.cat(seq, dim=1)
    lg = [model.decode(p, t[:, -1:], 32 + steps, pos_offset=poff)[0]
          for p, t in ((pool_c, chained), (pool_q, seq))]
    chain = {"tokens": _bits(torch, chained, seq),
             "kv": _bits(torch, torch.cat([_cache_rows(torch, pool_c, r, 32 + steps)
                                           for r in range(slots)]),
                         torch.cat([_cache_rows(torch, pool_q, r, 32 + steps)
                                    for r in range(slots)])),
             "logits": _bits(torch, lg[0], lg[1])}
    chain["equal"] = all(v["equal"] for v in chain.values())
    return {"join_equals_alone": join, "chained_equals_sequential": chain}


def attn_decode_step_profile(torch, model):
    """One decode step at batch 8 over a 144-slot ring of random K/V (rows
    at 10-143 tokens): wall ms (best of two runs of 20 steps) and a
    torch.profiler pass over 5 steps after a warm one, which must show one
    decode attention launch a layer, as the wrapper's count of all 6 must."""
    from repro_torch import kernels
    from repro_torch.models import lm

    cfg, dev = model.cfg, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = lm.alloc_slot_pool(cfg, 8, 144, dev)
    _map_pool(pool, lambda k, v, st: v.normal_(generator=gen))
    tok = torch.randint(0, cfg.vocab, (8, 1), generator=gen, device=dev)
    clock = 300
    off = clock - torch.tensor([10, 40, 70, 100, 120, 130, 143, 5], device=dev)

    def step():
        model.decode(pool, tok, clock, pos_offset=off)

    def steps_ms(n=20):
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    wall = min(steps_ms(), steps_ms())
    before = kernels.launch_counts()["decode_attention"]
    prof = profile_decode_steps(torch, step, wall)
    counted = kernels.launch_counts()["decode_attention"] - before
    if counted != (1 + 5) * n_attn_layers(cfg):
        fail(f"{cfg.name}: the wrapper counted {counted} decode attention launches over 6 "
             f"decode steps, {n_attn_layers(cfg)} attention layers")
    if prof["decode_attention_calls_per_step"] != n_attn_layers(cfg):
        fail(f"{cfg.name}: {prof['decode_attention_calls_per_step']} decode attention "
             f"launches a step, {n_attn_layers(cfg)} attention layers")
    return {"layers": cfg.n_layers, "batch": 8, "ring": 144, "wall_ms": wall, **prof}


def new_arch_serve(torch, np, cfg, model, where):
    """PREBA's audio path over this model: 8 requests with 1 s of 48 kHz
    audio, submitted at once, through a wall-clock DpuService into the
    pipelined runtime's continuous engine (8 slots, segment 8, 8 new
    tokens). Gates: all
    served once, 0 shed, conservation, features equal to the plain CPU
    pipeline, tokens in the vocabulary, no CPU path, the audio kernels once
    a DPU group, decode attention n_attn_layers x the engine's decode
    steps."""
    from repro_torch import kernels
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.requests import WorkloadSpec, generate_requests
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    ec = EngineConfig(max_new_tokens=NEW_MAX_NEW, continuous=True, max_slots=8,
                      segment_len=8, max_prompt_len=128)
    service = DpuService(DpuServiceConfig(clock="wall", dpu=DpuConfig(backend="dpu")),
                         device="cuda")
    feats = {}
    poll = service.poll

    def recording_poll(now, n=None):
        out = poll(now, n)
        for r in out:
            feats[r.rid] = np.array(r.payload)
        return out

    service.poll = recording_poll
    rt = build_pipelined_runtime(cfg, ec=ec, service=service, device="cuda", params=model,
                                 rc=RuntimeConfig(clock="wall", max_ingest=64))

    def drive(reqs):
        """All at once: each request arrives when it is submitted."""
        t0 = time.monotonic()
        for r in reqs:
            r.arrival = t0
        rt.submit(reqs)
        done = rt.run_until_idle()
        torch.cuda.synchronize()
        return done, time.monotonic() - t0

    def spec(seed):
        return WorkloadSpec(modality="text", rate_qps=50.0, mean_len=48, max_len=120,
                            vocab=cfg.vocab, payload_samples=48_000, seed=seed)

    warm = generate_requests(spec(99), 2)  # cuBLAS handles, allocator, other rids
    for i, r in enumerate(warm):
        r.rid = 10_000 + i
    drive(warm)
    rt.reset_metrics()
    feats.clear()
    groups0 = service.stats["groups"]
    reqs = generate_requests(spec(0), NEW_REQUESTS)
    raws = {r.rid: r.payload.copy() for r in reqs}
    kernels.reset_launch_counts()              # this arch's main path starts here
    done, wall = drive(reqs)
    launches = kernels.launch_counts()         # ... and ends here
    groups = service.stats["groups"] - groups0
    pool = tree_bytes(rt.engine._pool)
    rt.close()
    if len(done) != NEW_REQUESTS or rt.shed or not rt.conservation_ok():
        fail(f"{where}: served {len(done)} of {NEW_REQUESTS}, shed {rt.shed_counts()}")
    _check_tokens(np, done, cfg, NEW_REQUESTS, NEW_MAX_NEW, where)
    for r in done:
        f = feats.get(r.rid)
        plain = ops.audio_pipeline_batch(torch.from_numpy(raws[r.rid][None]))[0].numpy()
        if f is None or f.shape != (98, 80) or not np.allclose(f, plain, rtol=1e-3,
                                                                atol=1e-2):
            fail(f"{where}: request {r.rid}'s features are not the plain pipeline's")
    for k in kernels.AUDIO_KERNELS:
        if launches[k] <= 0 or launches[k] != groups:
            fail(f"{k}: {launches[k]} launches on the {where}, the service launched "
                 f"{groups} groups")
    check_no_fallback(rt, where)
    steps = rt.engine.stats["decode_steps"]
    if steps <= 0 or launches["decode_attention"] != n_attn_layers(cfg) * steps:
        fail(f"decode_attention: {launches['decode_attention']} launches on the {where}, "
             f"the engine executed {steps} decode steps of {n_attn_layers(cfg)} "
             f"attention layers")
    stats = _serve_stats(np, done, wall, launches, steps)
    stats.update(groups=groups, slot_pool_bytes=pool)
    return stats


def window_wrap_check(torch, np, cfg, model, dev) -> dict:
    """danube's window on the card: one 4,000-token prompt (bucket 4,096 =
    the window, so the ring holds the padded prompt; its prefill takes the
    blockwise attention) and 200 new tokens through the continuous engine,
    whose 4,304-slot cache makes a 4,096-slot ring that wraps at decode
    step 96. At step 150 every layer's kernel output is held against
    attention over the same ring with each slot's true position and the
    window mask (bf16, 3e-2). Then the kernel's plain version takes its
    place. Served alone, its greedy tokens' agreement with the kernel
    run's is reported (random bf16 weights give flat logits, so one
    near-tie sends two free runs apart). Fed the kernel run's tokens beside
    a replay with the kernel, which must reproduce them: its picks'
    agreement, the margins of its misses, and the largest difference
    between the two replays' logits before and after the ring wraps are
    reported."""
    from repro_torch import kernels
    from repro_torch.core.batching.buckets import Request
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import EngineConfig, build_engine

    W, n_l = cfg.sliding_window, n_attn_layers(cfg)
    ec = EngineConfig(max_new_tokens=WRAP_STEPS, continuous=True, max_slots=1,
                      segment_len=8, max_prompt_len=W)
    real = ops.decode_attention
    calls, rec = [0], []

    def spy(q, k, v, vl):
        out = real(q, k, v, vl)
        if calls[0] // n_l == WRAP_CHECK_STEP:  # the ring as that step reads it
            rec.append([t.clone() for t in (q, k, v, vl, out)])
        calls[0] += 1
        return out

    def serve(attn):
        eng = build_engine(cfg, ec=ec, device=dev, params=model.tree())
        ops.decode_attention = attn
        try:
            kernels.reset_launch_counts()
            done, wall = _burst(torch, eng, [Request(rid=4242, arrival=0.0,
                                                     length=float(WRAP_PROMPT))])
            launches = kernels.launch_counts()
        finally:
            ops.decode_attention = real
        return eng, np.asarray(done[0].payload), wall, launches

    eng, toks, wall, launches = serve(spy)
    ring = eng._pool["body"]["l0"]["mixer"]["k"].shape[2]
    steps = eng.stats["decode_steps"]
    if ring != W or eng.pool_len <= W + WRAP_STEPS or toks.shape != (WRAP_STEPS,) or \
            toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"window wrap: ring {ring}, pool {eng.pool_len}, tokens {toks.shape}")
    if launches["decode_attention"] != n_l * steps or len(rec) != n_l:
        fail(f"window wrap: {launches['decode_attention']} decode attention launches for "
             f"{steps} steps of {n_l} layers, {len(rec)} recorded")
    qpos = WRAP_PROMPT + WRAP_CHECK_STEP
    slot = torch.arange(W, device=dev)
    kpos = qpos - torch.remainder(qpos - slot, W)  # each slot's latest true position
    layer_err = []
    for q, k, v, vl, out in rec:
        if vl.tolist() != [W]:
            fail(f"window wrap: valid_len {vl.tolist()} at true position {qpos}")
        want = L.attention_dense(q[:, None], k, v, torch.tensor([qpos], device=dev), kpos,
                                 causal=True, window=W)[:, 0]
        err = float((out.float() - want.float()).abs().max())
        layer_err.append(err)
        if not torch.allclose(out.float(), want.float(), rtol=3e-2, atol=3e-2):
            fail(f"window wrap: the kernel differs from the window-masked attention over "
                 f"true positions at step {WRAP_CHECK_STEP} by {err:.3e}")
    _, plain_toks, plain_wall, _ = serve(kd.decode_attention_plain)
    rep = replay_both(torch, np, cfg, model, eng, toks, dev)
    if not np.array_equal(rep["kernel_pick"], toks[1:]):
        fail("window wrap: the kernel replay does not reproduce the served tokens")
    miss = rep["plain_pick"] != toks[1:]
    wrap = W - WRAP_PROMPT
    res = {"prompt": WRAP_PROMPT, "bucket": W, "ring": ring, "pool_len": eng.pool_len,
           "decode_steps": steps, "wrap_step": wrap, "check_step": WRAP_CHECK_STEP,
           "kernel_vs_window_mask_max_abs_err": max(layer_err), "wall_s": wall,
           "plain_wall_s": plain_wall, "tokens_agree": float((plain_toks == toks).mean()),
           "first_divergence": int(np.argmax(plain_toks != toks))
           if (plain_toks != toks).any() else None,
           "teacher_forced_agree": float(1.0 - miss.mean()),
           "teacher_forced_misses_before_wrap": int(miss[:wrap].sum()),
           "teacher_forced_misses_after_wrap": int(miss[wrap:].sum()),
           "teacher_forced_miss_margins": [float(m) for m in rep["plain_margin"][miss]],
           "logit_diff_before_wrap": float(rep["logit_diff"][:wrap].max()),
           "logit_diff_after_wrap": float(rep["logit_diff"][wrap:].max()),
           "launches": launches}
    return res


def replay_both(torch, np, cfg, model, eng, toks, dev) -> dict:
    """The request replayed twice in lockstep, both fed the kernel run's
    tokens (the engine's prefill and decode, as one row of a pool like
    its): once with the kernel, once with its plain version. Per step past
    the first: the kernel replay's pick, the plain replay's pick, by how
    much the plain logits prefer their pick to the kernel run's token, and
    the largest difference between the two replays' logits."""
    from repro_torch.core.batching.buckets import Request
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    real = ops.decode_attention
    lp, n = cfg.sliding_window, WRAP_PROMPT
    prompt = eng._prompt_tokens(Request(rid=4242, arrival=0.0, length=float(n)), n)
    row = np.zeros((1, lp), np.int64)
    row[0, lp - n:] = prompt
    off = torch.tensor([lp - n], device=dev)
    pools = {}
    for name in ("kernel", "plain"):
        pool = lm.alloc_slot_pool(cfg, 1, eng.pool_len, dev)
        _, pools[name] = model.prefill_into_slots(torch.from_numpy(row).to(dev), pool,
                                                  torch.tensor([0], device=dev), lp,
                                                  pos_offset=off)
    out = {"kernel_pick": [], "plain_pick": [], "plain_margin": [], "logit_diff": []}
    try:
        for i in range(len(toks) - 1):
            tok = torch.tensor([[int(toks[i])]], device=dev)
            lg = {}
            for name, attn in (("kernel", real), ("plain", kd.decode_attention_plain)):
                ops.decode_attention = attn
                logits, pools[name] = model.decode(pools[name], tok, lp + i, pos_offset=off)
                lg[name] = logits[0, 0].float()
            pick = int(torch.argmax(lg["plain"]))
            out["kernel_pick"].append(int(torch.argmax(lg["kernel"])))
            out["plain_pick"].append(pick)
            out["plain_margin"].append(float(lg["plain"][pick] - lg["plain"][int(toks[i + 1])]))
            out["logit_diff"].append(float((lg["kernel"] - lg["plain"]).abs().max()))
    finally:
        ops.decode_attention = real
    return {k: np.array(v) for k, v in out.items()}


def new_archs_phase(torch, np, card):
    """Phase 15: each arch at full width with seeded bf16 weights, at the
    depth NEW_ARCH_DEPTH gives (the cuts keep it inside the card)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.api import LM
    from repro_torch.models.params import init_params

    dev = torch.device("cuda")
    res = {"card": card}
    for arch, depth in NEW_ARCH_DEPTH.items():
        full = get_config(arch)
        cfg = replace(full, n_layers=depth) if depth else full
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        model = LM(cfg, init_params(cfg, gen, dev, cfg.dtype))
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        out = {"layers": cfg.n_layers, "of_layers": full.n_layers,
               "weight_bytes": tree_bytes(model.tree()), "free_bytes_after_weights": free,
               "init_s": time.perf_counter() - t0}
        pool_need = 8 * 144 * 2 * n_attn_layers(cfg) * cfg.n_kv_heads * cfg.hd * 2
        if pool_need > free:
            fail(f"{arch}: an 8-slot pool needs {pool_need} bytes, {free} are free")
        out["serve"] = new_arch_serve(torch, np, cfg, model, f"{arch} audio path")
        out["decode_step"] = attn_decode_step_profile(torch, model)
        out["contracts"] = attn_contracts(torch, np, cfg, model, dev)
        moe = cfg.n_experts > 0
        for name, c in out["contracts"].items():
            gated = not (moe and name == "join_equals_alone")
            if gated and not c["equal"]:
                fail(f"{arch}: contract {name} does not hold on the card: {c}")
        if arch == WRAP_ARCH:
            out["window_wrap"] = window_wrap_check(torch, np, cfg, model, dev)
        s, st = out["serve"], out["decode_step"]
        print(f"{arch} ({cfg.n_layers} of {full.n_layers} layers, bf16): weights "
              f"{out['weight_bytes']} bytes, {free} free after them, pool "
              f"{s['slot_pool_bytes']} bytes; {s['tokens_per_s']:.2f} tokens/s, "
              f"{s['decode_steps']} decode steps, decode attention "
              f"{s['launches']['decode_attention']} launches; decode step wall "
              f"{st['wall_ms']:.3f} ms, device {st['device_ms_per_step']:.3f} ms, "
              f"{st['kernel_launches_per_step']:.0f} launches")
        print(f"{arch} contracts: " + json.dumps(
            {k: {"equal": v["equal"], **({"gated": False} if moe and k.startswith("join")
                                          else {})} for k, v in out["contracts"].items()}))
        if "window_wrap" in out:
            print(f"{arch} window wrap: " + json.dumps(out["window_wrap"]))
        print(f"{arch}: " + json.dumps(out))
        res[arch] = out
        del model
        torch.cuda.empty_cache()
    return res


# --- 16. the last three families: whisper, phi-3-vision, jamba -----------------

# decode attention (B, H, KH, D, S, dtype, valid_len: None = drawn in [1, S]):
# phi-3-vision's decode (MHA, head size 96) over a 144-slot ring and a
# 4,096-slot one, and whisper's cross-attention over its 1,500 encoder
# positions, every one valid (MHA, head size 64)
FAMILY_DECODE_SHAPES = [(8, 32, 32, 96, s, d, None) for s in (144, 4096)
                        for d in ("float32", "bfloat16")] \
    + [(8, 8, 8, 64, 1500, d, 1500) for d in ("float32", "bfloat16")]
# arch: layers run in phase 16 (None: all); jamba's cut is one whole block of 8
FAMILY_DEPTH = {"whisper-base": None, "phi-3-vision-4.2b": None, "jamba-v0.1-52b": 8}
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_STEPS, WHISPER_CHECK_STEP = 8, 8, 16, 8
PHI3_ROWS, PHI3_TEXT, PHI3_STEPS = 2, 32, 16


def family_kernel_rows(torch, F, np):
    """Decode attention at the new families' shapes, held, timed and
    bounded as phase 7 does."""
    from repro_torch.kernels import decode_attention as kd

    rng = np.random.default_rng(1616)
    rows = [decode_row(torch, F, np, kd, rng, tuple(shape), valid)[0]
            for *shape, valid in FAMILY_DECODE_SHAPES]
    torch.cuda.synchronize()
    report_decode_rows(rows)
    return rows


def family_model(torch, arch):
    """(cfg, LM): the arch at full width, bf16, the weights of seed 0, at
    FAMILY_DEPTH's depth."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.api import LM
    from repro_torch.models.params import init_params

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if FAMILY_DEPTH[arch]:
        cfg = replace(cfg, n_layers=FAMILY_DEPTH[arch])
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, LM(cfg, init_params(cfg, gen, dev, cfg.dtype))


def _decode_swapped(attn, fn):
    """fn() with ops.decode_attention replaced by attn."""
    from repro_torch.kernels import ops

    real = ops.decode_attention
    ops.decode_attention = attn
    try:
        return fn()
    finally:
        ops.decode_attention = real


def _teacher_forced(torch, model, toks, pos0, prefill):
    """Logits [B, n, V] (fp32) of decoding the tokens toks[:, :n] in turn
    after prefill() (cache, first logits): the decode loop fed the given
    tokens."""
    _, cache = prefill()
    out = []
    for i in range(toks.shape[1]):
        logits, cache = model.decode(cache, toks[:, i:i + 1], pos0 + i)
        out.append(logits.float())
    return torch.cat(out, dim=1)


def whisper_check(torch, np, cfg, model) -> dict:
    """whisper-base through its model entry points: 8 rows of stub frames
    [8, 1,500, 512] and 8-token prompts from a seed; prefill, then generate
    16 tokens. Gates: decode attention launches = (6 self + 6 cross) x 15
    decode steps; at step 8 every layer's kernel output within 3e-2 of the
    plain version on its own inputs (the cross layers at valid_len =
    1,500); the decode loop fed the generated tokens reproduces them; its
    logits, with the kernel and with the plain version fed the same tokens,
    within bf16's 3e-2. The plain version's own greedy run is compared with
    the kernel's, and the agreement printed."""
    from repro_torch import kernels
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_ROWS, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)).to(dev, torch.bfloat16)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (WHISPER_ROWS, WHISPER_PROMPT))
                              ).to(dev)
    cache_len = WHISPER_PROMPT + WHISPER_STEPS

    def prefill():
        return model.prefill(prompt, cache_len=cache_len, audio_frames=frames)

    def generate():
        logits, cache = prefill()
        return model.generate(cache, logits, WHISPER_PROMPT, steps=WHISPER_STEPS)

    real, n_l = ops.decode_attention, n_attn_layers(cfg)
    calls, rec = [0], []

    def spy(q, k, v, vl):
        out = real(q, k, v, vl)
        if calls[0] // n_l == WHISPER_CHECK_STEP:
            rec.append([t.clone() for t in (q, k, v, vl, out)])
        calls[0] += 1
        return out

    generate()  # warm-up: cuBLAS handles, the allocator
    torch.cuda.synchronize()
    kernels.reset_launch_counts()               # whisper's main path starts here
    t0 = time.perf_counter()
    toks, cache = _decode_swapped(spy, generate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()          # ... and ends here
    steps = WHISPER_STEPS - 1
    if toks.shape != (WHISPER_ROWS, WHISPER_STEPS) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab:
        fail(f"whisper: generated tokens of shape {tuple(toks.shape)}")
    if launches["decode_attention"] != n_l * steps or len(rec) != n_l:
        fail(f"whisper: {launches['decode_attention']} decode attention launches for "
             f"{steps} decode steps of {n_l} attention layers (self + cross)")
    layer_err = []
    for q, k, v, vl, out in rec:
        want = kd.decode_attention_plain(q, k, v, vl)
        layer_err.append(float((out.float() - want.float()).abs().max()))
        if not torch.allclose(out.float(), want.float(), rtol=3e-2, atol=3e-2):
            fail(f"whisper: a layer's decode attention differs from its plain version by "
                 f"{layer_err[-1]:.3e} at step {WHISPER_CHECK_STEP} (S={k.shape[1]})")
    # each layer calls self-attention, then cross-attention
    qlen = WHISPER_PROMPT + WHISPER_CHECK_STEP + 1
    vls = [r[3].tolist() for r in rec]
    if vls != [[qlen] * WHISPER_ROWS, [cfg.n_audio_ctx] * WHISPER_ROWS] * cfg.n_layers:
        fail(f"whisper: valid_len {vls} at step {WHISPER_CHECK_STEP}")
    kern = _teacher_forced(torch, model, toks[:, :-1], WHISPER_PROMPT, prefill)
    if not torch.equal(kern.argmax(-1), toks[:, 1:]):
        fail("whisper: the decode loop fed the generated tokens does not reproduce them")
    plain = _decode_swapped(kd.decode_attention_plain, lambda: _teacher_forced(
        torch, model, toks[:, :-1], WHISPER_PROMPT, prefill))
    diff = float((kern - plain).abs().max())
    if not torch.allclose(kern, plain, rtol=3e-2, atol=3e-2):
        fail(f"whisper: the kernel path's logits differ from the plain path's by {diff:.3e}")
    plain_toks, _ = _decode_swapped(kd.decode_attention_plain, generate)
    torch.cuda.synchronize()
    return {"rows": WHISPER_ROWS, "frames": cfg.n_audio_ctx, "prompt": WHISPER_PROMPT,
            "new_tokens": WHISPER_STEPS, "decode_steps": steps, "wall_s": wall,
            "tokens_per_s": WHISPER_ROWS * WHISPER_STEPS / wall, "launches": launches,
            "cache_bytes": tree_bytes(cache),
            "layer_max_abs_err": max(layer_err), "logits_max_abs_diff": diff,
            "teacher_forced_agree": float((plain.argmax(-1) == toks[:, 1:]).float().mean()),
            "free_run_agree": float((plain_toks == toks).float().mean())}


def phi3_image_check(torch, np, cfg, model) -> dict:
    """phi-3-vision's image path: 2 rows of 576 stub patch embeddings in
    place of the first 576 of 608 prompt tokens, prefill, then generate 16
    tokens. Gates: tokens in the vocabulary, decode attention = 32 layers x
    15 decode steps, the patch embeddings change the logits, and prefill
    with pos_offset and img_embeds raises ValueError."""
    from repro_torch import kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    n = cfg.n_img_tokens + PHI3_TEXT
    img = torch.from_numpy(rng.standard_normal(
        (PHI3_ROWS, cfg.n_img_tokens, cfg.d_model)).astype(np.float32) * 0.02
        ).to(dev, torch.bfloat16)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (PHI3_ROWS, n))).to(dev)
    kernels.reset_launch_counts()               # the image path starts here
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks, cache_len=n + PHI3_STEPS, img_embeds=img)
    out, cache = model.generate(cache, logits, n, steps=PHI3_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()          # ... and ends here
    steps = PHI3_STEPS - 1
    if out.shape != (PHI3_ROWS, PHI3_STEPS) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab:
        fail(f"phi-3-vision image path: tokens of shape {tuple(out.shape)}")
    if launches["decode_attention"] != n_attn_layers(cfg) * steps:
        fail(f"phi-3-vision image path: {launches['decode_attention']} decode attention "
             f"launches for {steps} steps of {n_attn_layers(cfg)} layers")
    text, _ = model.prefill(toks)
    if torch.equal(text, logits):
        fail("phi-3-vision image path: the patch embeddings did not change the logits")
    try:
        model.prefill(toks, pos_offset=torch.zeros(PHI3_ROWS, dtype=torch.long, device=dev),
                      img_embeds=img)
    except ValueError:
        pass
    else:
        fail("phi-3-vision: prefill took pos_offset with img_embeds")
    return {"rows": PHI3_ROWS, "img_tokens": cfg.n_img_tokens, "prompt": n,
            "new_tokens": PHI3_STEPS, "wall_s": wall, "launches": launches,
            "pos_offset_with_img_embeds_refused": True}


def families_phase(torch, F, np, card):
    """Phase 16: decode attention at the new families' shapes, then each
    arch at full width with seeded bf16 weights: whisper through its model
    entry points (whisper_check), phi-3-vision and jamba (8 of 32 layers:
    one block of 1 attention, 7 SSM and 4 MoE layers) through PREBA's audio
    serve (new_arch_serve) and the within-port contracts, phi-3-vision's
    image path too; for each, one decode step at batch 8 over a 144-slot
    ring (wall ms, device ms, launches)."""
    res = {"card": card, "kernel_rows": family_kernel_rows(torch, F, np)}
    dev = torch.device("cuda")
    for arch in FAMILY_DEPTH:
        t0 = time.perf_counter()
        cfg, model = family_model(torch, arch)
        torch.cuda.synchronize()
        free, _ = torch.cuda.mem_get_info()
        out = {"layers": cfg.n_layers, "weight_bytes": tree_bytes(model.tree()),
               "free_bytes_after_weights": free, "init_s": time.perf_counter() - t0}
        if cfg.enc_layers:
            out["generate"] = whisper_check(torch, np, cfg, model)
            run = out["generate"]
        else:
            out["serve"] = new_arch_serve(torch, np, cfg, model, f"{arch} audio path")
            run = out["serve"]
            run["cache_bytes"] = run["slot_pool_bytes"]
            out["contracts"] = attn_contracts(torch, np, cfg, model, dev)
            moe = cfg.n_experts > 0
            for name, c in out["contracts"].items():
                if not (moe and name == "join_equals_alone") and not c["equal"]:
                    fail(f"{arch}: contract {name} does not hold on the card: {c}")
            print(f"{arch} contracts: " + json.dumps(
                {k: {"equal": v["equal"], **({"gated": False} if moe and k.startswith("join")
                                              else {})}
                 for k, v in out["contracts"].items()}))
        if cfg.n_img_tokens:
            out["image"] = phi3_image_check(torch, np, cfg, model)
        out["decode_step"] = attn_decode_step_profile(torch, model)
        st = out["decode_step"]
        print(f"{arch} ({cfg.n_layers} layers, bf16): weights {out['weight_bytes']} bytes, "
              f"{free} free after them, cache {run['cache_bytes']} bytes; "
              f"{run['tokens_per_s']:.2f} tokens/s, {run['decode_steps']} decode steps, "
              f"decode attention {run['launches']['decode_attention']} launches; decode step "
              f"wall {st['wall_ms']:.3f} ms, device {st['device_ms_per_step']:.3f} ms, "
              f"{st['kernel_launches_per_step']:.0f} launches")
        print(f"{arch}: " + json.dumps(out))
        res[arch] = out
        del model
        torch.cuda.empty_cache()
    return res


# --- 17. training on the card, then serving the trained weights ---------------

TRAIN_ARCH = "tinyllama-1.1b"
CHECK_LAYERS, CHECK_BATCH, CHECK_SEQ = 2, 2, 128   # (a): card against CPU, fp32
GRAD_TOL = 1e-3      # a gradient leaf's max abs difference over its own max abs
LOSS_RTOL = 1e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 20  # (b): 8,192 tokens a step
TRAIN_PROFILED_STEP = 10   # the step run under torch.profiler (not in the median)
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 10, 5, 6  # (c)
QUICK_REQUESTS, QUICK_MAX_NEW = 12, 4                # (d): the quickstart's serve
BF16_PEAK_FLOPS_S = 989e12  # H100 SXM data sheet, bf16 dense (no sparsity)


def _loss_grads(torch, cfg, params, batch, device):
    """train_loss, every gradient leaf (by path) and their global norm, on
    `device`."""
    from repro_torch.models import lm
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.training.optimizer import global_norm

    p = tree_map(lambda v: v.detach().requires_grad_(), params)
    loss, _ = lm.train_loss(p, {k: torch.from_numpy(v).to(device)
                                for k, v in batch.items()}, cfg)
    paths, flat = zip(*leaves(p))
    grads = dict(zip(paths, torch.autograd.grad(loss, flat)))
    return float(loss.detach()), grads, float(global_norm(grads))


def train_check(torch, np) -> dict:
    """(a) One step of tinyllama-1.1b at full width cut to 2 layers, fp32,
    TF32 off, batch 2 x 128 of batch_iterator(seed=0): the loss, every
    gradient leaf and grad_norm on the card against the same weights on the
    CPU. Gates: the loss within 1e-5 relative, each leaf's max abs
    difference within 1e-3 of that leaf's max abs, grad_norm within 1e-3
    relative. The card's step with remat off is printed beside it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.models.params import init_params, tree_map

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CHECK_LAYERS, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = next(batch_iterator(cfg, DataConfig(CHECK_BATCH, CHECK_SEQ, seed=0)))
    t0 = time.perf_counter()
    loss, grads, gnorm = _loss_grads(torch, cfg, params, batch, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, grads_c, gnorm_c = _loss_grads(torch, cfg, tree_map(lambda x: x.cpu(), params),
                                           batch, "cpu")
    cpu_s = time.perf_counter() - t0
    worst, worst_leaf = 0.0, ""
    for path, gc_ in grads_c.items():
        scale = float(gc_.abs().max())
        d = float((grads[path].cpu() - gc_).abs().max())
        if not torch.isfinite(grads[path]).all() or d > GRAD_TOL * scale:
            fail(f"train step: gradient {path} differs card vs CPU by {d:.3e} "
                 f"(its max abs {scale:.3e}, tolerance {GRAD_TOL} of it)")
        if d / max(scale, 1e-30) > worst:
            worst, worst_leaf = d / max(scale, 1e-30), path
    loss_rel = abs(loss - loss_c) / abs(loss_c)
    gnorm_rel = abs(gnorm - gnorm_c) / gnorm_c
    if not np.isfinite(loss) or loss_rel > LOSS_RTOL or gnorm_rel > GRAD_TOL:
        fail(f"train step: loss {loss} vs CPU {loss_c} (rel {loss_rel:.2e}), grad_norm "
             f"{gnorm} vs {gnorm_c} (rel {gnorm_rel:.2e})")
    loss_o, grads_o, _ = _loss_grads(torch, dataclasses.replace(cfg, remat=False), params,
                                     batch, "cuda")
    remat_diff = max(float((grads_o[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                     for k, g in grads.items())
    out = dict(layers=CHECK_LAYERS, batch=[CHECK_BATCH, CHECK_SEQ], loss=loss, loss_cpu=loss_c,
               loss_rel_err=loss_rel, grad_norm=gnorm, grad_norm_cpu=gnorm_c,
               grad_norm_rel_err=gnorm_rel, worst_leaf_rel_err=worst, worst_leaf=worst_leaf,
               leaves=len(grads), remat_off_loss_diff=abs(loss_o - loss),
               remat_off_worst_leaf_rel_diff=remat_diff, card_s=card_s, cpu_s=cpu_s)
    print(f"train check (2 layers, fp32): loss {loss:.6f} vs CPU {loss_c:.6f} (rel "
          f"{loss_rel:.2e}); {len(grads)} gradient leaves, worst {worst:.2e} of its max abs "
          f"({worst_leaf}); grad_norm rel {gnorm_rel:.2e}; remat off: loss diff "
          f"{abs(loss_o - loss):.2e}, worst leaf {remat_diff:.2e}")
    return out


def _profile_once(torch, fn):
    """fn() once under torch.profiler: its device ms, kernel launches and
    the kernels that take the most device time."""
    out, ks = _traced(torch, lambda: torch.ones(1, device="cuda").add_(1), fn)
    top = sorted(ks, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return out, {"device_ms": sum(e.self_device_time_total for e in ks) / 1e3,
                 "kernel_launches": sum(e.count for e in ks),
                 "top_kernels": [{"name": e.key[:90], "calls": e.count,
                                  "ms": e.self_device_time_total / 1e3} for e in top]}


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """PaLM's model FLOPs of one train step: 6 N T for the weight products
    (N = the parameters that multiply: all but the embedding table, which
    is a gather) plus 12 L d_model S T for attention's score and value
    products, forward and backward, with no causal discount and no count
    of the recomputation remat adds."""
    n = cfg.param_count() - cfg.padded_vocab * cfg.d_model
    t = batch * seq
    return 6.0 * n * t + 12.0 * cfg.n_layers * cfg.d_model * seq * t


def full_depth_training(torch, np, card) -> tuple:
    """(b) tinyllama-1.1b, all 22 layers, bf16 compute over an fp32 master,
    remat on, batch 4 x 2,048 (8,192 tokens a step), seeded init_params,
    AdamW(lr 3e-4, 2 warm-up steps, 20 in all) for 20 steps. Gates: every
    loss finite, the mean of the last 3 below the mean of the first 3.
    Returns (stats, the trained state)."""
    from repro_torch.configs import get_config
    from repro_torch.core import steps
    from repro_torch.data.pipeline import DataConfig, batch_iterator
    from repro_torch.training.optimizer import OptConfig

    cfg = get_config(TRAIN_ARCH)
    if not cfg.remat or cfg.dtype != "bfloat16" or cfg.param_dtype != "float32":
        fail(f"train: {TRAIN_ARCH} is not bf16 compute over an fp32 master with remat")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = steps.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = steps.make_train_step(cfg, OptConfig(lr=3e-4, warmup_steps=2,
                                                total_steps=TRAIN_STEPS))
    it = batch_iterator(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed=0))
    losses, walls, prof = [], [], None
    for i in range(TRAIN_STEPS):
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == TRAIN_PROFILED_STEP:
            (state, m), prof = _profile_once(torch, lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        loss = float(m["loss"])  # waits for the step
        walls.append(time.perf_counter() - t0)
        if not np.isfinite(loss):
            fail(f"train: non-finite loss {loss} at step {i}")
        losses.append(loss)
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not last < first:
        fail(f"train: loss did not fall over {TRAIN_STEPS} steps: first 3 {first:.4f}, "
             f"last 3 {last:.4f}")
    timed = [w for i, w in enumerate(walls) if i >= 2 and i != TRAIN_PROFILED_STEP]
    step_s = float(np.median(timed))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out = dict(arch=TRAIN_ARCH, layers=cfg.n_layers, batch=[TRAIN_BATCH, TRAIN_SEQ],
               steps=TRAIN_STEPS, losses=losses, first3=first, last3=last,
               step_wall_ms_median=1e3 * step_s, step_wall_ms=[1e3 * w for w in walls],
               tokens_per_s=tokens / step_s, init_s=init_s,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               model_flops_per_step=flops,
               model_flop_share=flops / step_s / BF16_PEAK_FLOPS_S,
               profiled_step=TRAIN_PROFILED_STEP, profile=prof,
               device_busy_share=prof["device_ms"] / (1e3 * step_s), card=card)
    print(f"train ({cfg.n_layers} layers, bf16 over fp32, remat, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}): loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 3 {first:.4f}, "
          f"last 3 {last:.4f}); step {1e3 * step_s:.1f} ms median after step 2, "
          f"{tokens / step_s:.0f} tokens/s; step {TRAIN_PROFILED_STEP}: device "
          f"{prof['device_ms']:.1f} ms, {prof['kernel_launches']} launches; peak "
          f"{out['max_memory_allocated']} bytes; model FLOP share "
          f"{out['model_flop_share']:.4f} of the H100 SXM data-sheet bf16 dense peak "
          f"(989 TFLOP/s) | {card}")
    print("train top kernels: " + json.dumps(prof["top_kernels"]))
    return out, state


def restart_check(torch, np) -> dict:
    """(c) Full width cut to 2 layers, train() to step 10 with checkpoints
    every 5, failing at step 6, then restarted in a temporary directory
    removed afterwards. Gates: latest_step is 5, the restored tree equals
    the one saved at step 5 bit for bit, and the restart runs 5 steps."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_loop import TrainLoopConfig, train

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CHECK_LAYERS)
    dc = DataConfig(CHECK_BATCH, CHECK_SEQ)
    snaps = {}
    base = ckpt.AsyncCheckpointer

    class Recording(base):
        def save(self, step, tree):
            snaps[step] = tree_map(lambda v: v.detach().to("cpu", copy=True), tree)
            super().save(step, tree)

    with tempfile.TemporaryDirectory() as d:
        tc = TrainLoopConfig(total_steps=RESTART_STEPS, ckpt_dir=d, ckpt_every=RESTART_EVERY,
                             log_every=RESTART_STEPS)
        ckpt.AsyncCheckpointer = Recording
        try:
            t0 = time.perf_counter()
            try:
                train(cfg, dc, tc, fail_at_step=RESTART_FAIL, device="cuda")
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            else:
                fail("restart: the injected failure did not raise")
            latest = ckpt.latest_step(d)
            if latest != RESTART_EVERY:
                fail(f"restart: latest_step {latest}, expected {RESTART_EVERY}")
            saved = dict(leaves(snaps[RESTART_EVERY]))
            restored = dict(leaves(ckpt.restore_checkpoint(d, snaps[RESTART_EVERY],
                                                           device="cpu")))
            bad = [p for p in saved if saved[p].dtype != restored[p].dtype
                   or not torch.equal(saved[p], restored[p])]
            if bad or saved.keys() != restored.keys():
                fail(f"restart: restored leaves differ from the saved ones: {bad[:5]}")
            out = train(cfg, dc, tc, device="cuda")
            wall = time.perf_counter() - t0
        finally:
            ckpt.AsyncCheckpointer = base
        if out["steps"] != RESTART_STEPS - RESTART_EVERY or not np.isfinite(out["losses"]).all():
            fail(f"restart: ran {out['steps']} steps, losses {out['losses']}")
        final = ckpt.latest_step(d)
    res = dict(layers=CHECK_LAYERS, latest_step_after_failure=latest,
               leaves=len(saved), restored_bit_equal=True, restart_steps=out["steps"],
               restart_losses=out["losses"], final_step=final, wall_s=wall)
    print(f"restart (2 layers): failed at step {RESTART_FAIL}, latest_step {latest}, "
          f"{len(saved)} leaves restored bit for bit, restart ran {out['steps']} steps to "
          f"step {final}; {wall:.1f} s")
    return res


def trained_serve(torch, np, state) -> dict:
    """(d) The full-depth state's weights cast to bf16 (the optimizer state
    freed first) served through build_engine: 12 text requests of the
    quickstart's WorkloadSpec, submitted at once, run to completion with 4
    new tokens each. Gates: every request served once, 0 shed, tokens in
    the vocabulary, decode attention 22 x the engine's decode steps."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import EngineConfig, build_engine
    from repro_torch.serving.requests import WorkloadSpec, generate_requests

    cfg = get_config(TRAIN_ARCH)
    master = state.pop("params")
    state.clear()                              # the moments go first
    params = tree_map(lambda p: p.to(torch.bfloat16), master)
    del master
    torch.cuda.empty_cache()
    engine = build_engine(cfg, ec=EngineConfig(max_new_tokens=QUICK_MAX_NEW), device="cuda",
                          params=params)

    def spec(seed):
        return WorkloadSpec(modality="text", rate_qps=200, mean_len=24, max_len=48, seed=seed)

    warm = generate_requests(spec(5), 2)       # cuBLAS handles, allocator, other rids
    for i, r in enumerate(warm):
        r.rid = 40_000 + i
    _burst(torch, engine, warm)
    engine.reset_metrics()
    reqs = generate_requests(spec(0), QUICK_REQUESTS)
    kernels.reset_launch_counts()              # the trained model's serve starts here
    done, wall = _burst(torch, engine, reqs)
    launches = kernels.launch_counts()         # ... and ends here
    shed = QUICK_REQUESTS - len(done)
    if shed:
        fail(f"trained serve: {shed} of {QUICK_REQUESTS} requests not served")
    _check_tokens(np, done, cfg, QUICK_REQUESTS, QUICK_MAX_NEW, "trained serve")
    for k in kernels.AUDIO_KERNELS + kernels.IMAGE_KERNELS:
        if launches[k] != 0:
            fail(f"{k}: {launches[k]} launches on the trained serve")
    steps = check_decode_launches(launches, cfg, engine, "trained serve")
    stats = _serve_stats(np, done, wall, launches, steps)
    stats["shed"] = shed
    print(f"trained serve: {len(done)} served, {shed} shed, {stats['tokens_per_s']:.2f} "
          f"tokens/s, {steps} decode steps, decode attention "
          f"{launches['decode_attention']} launches")
    return stats


def training_phase(torch, np, card) -> dict:
    """Phase 17: (a) card against CPU, (b) full-depth training, (c)
    checkpoint and restart, (d) the trained weights served."""
    t0 = time.perf_counter()
    check = train_check(torch, np)
    full, state = full_depth_training(torch, np, card)
    restart = restart_check(torch, np)
    serve = trained_serve(torch, np, state)
    del state
    torch.cuda.empty_cache()
    out = {"check": check, "full_depth": full, "restart": restart, "serve": serve,
           "phase_s": time.perf_counter() - t0}
    print(f"training phase: {out['phase_s']:.1f} s")
    return out


TP_ARCH = "tinyllama-1.1b"
TP_ROWS, TP_PROMPT, TP_STEPS = 8, 64, 16
TP_FP32_TOL = 1e-4   # max abs logit difference over the unsharded logits' max abs (fp32)
# case: (mesh (data, model), depth or None for all layers, dtype)
TP_CASES = {"a": ((1, 2), None, "bfloat16"), "b": ((1, 8), 2, "float32"),
            "c": ((2, 2), 2, "float32")}
TP_CASE_A4 = ((1, 4), None, "bfloat16")   # case (a) at tp 4: four cards, one a rank, NCCL
# decode attention (B, H, KH, D, S, dtype) at tp 2 on h2o-danube-1.8b's
# heads (head size 80, its 4,096-slot window ring) and phi-3-vision's (head
# size 96, a 144-slot ring): the families the CPU tests serve sharded at
# reduced size, whose rank shapes no phase-18 case runs
TP_FAMILY_DECODE_SHAPES = [(8, 16, 4, 80, 4096, "bfloat16"), (8, 16, 16, 96, 144, "bfloat16")]


def tp_config(case):
    from repro_torch.configs import get_config

    _, depth, dtype = case
    cfg = get_config(TP_ARCH)
    return dataclasses.replace(cfg, n_layers=depth or cfg.n_layers, dtype=dtype)


def tp_weights(torch, cfg, device):
    """Seed-0 weights in cfg.dtype, the same in every process on the card
    (`params.iter_params` draws the same bits leaf by leaf)."""
    from repro_torch.models.params import init_params

    return init_params(cfg, torch.Generator(device).manual_seed(0), device, cfg.dtype)


def tp_rank_shape(case):
    """(B, H, KH, D, S, dtype): the decode attention each rank of a case
    launches: its rows, its share of the head-padded heads, the ring."""
    from repro_torch.configs import serve_config
    from repro_torch.models.params import ring_len

    (data, tp), _, dtype = case
    cfg = tp_config(case)
    scfg = serve_config(cfg, tp)
    return (TP_ROWS // data, scfg.n_heads // tp, scfg.n_kv_heads // tp, cfg.hd,
            ring_len(cfg, TP_PROMPT + TP_STEPS), dtype)


def tp_kernel_rows(torch, F, np, cases):
    """Decode attention at every rank shape of `cases` and the four-card
    case, and at TP_FAMILY_DECODE_SHAPES: held against its plain version,
    timed and bounded as phase 7 does."""
    from repro_torch.kernels import decode_attention as kd

    rng = np.random.default_rng(1818)
    shapes = dict.fromkeys([tp_rank_shape(c) for c in (*cases.values(), TP_CASE_A4)]
                           + TP_FAMILY_DECODE_SHAPES)
    rows = [decode_row(torch, F, np, kd, rng, shape)[0] for shape in shapes]
    torch.cuda.synchronize()
    report_decode_rows(rows)
    return rows


def tp_decode(torch, prefill, decode, params, tokens, forced):
    """Prefill, then TP_STEPS decode steps, step i fed forced[:, i]
    (teacher forcing). Returns (the 17 logits [B, V] on the card, each
    decode step's wall ms)."""
    logits, cache = prefill(params, {"tokens": tokens, "cache_len": TP_PROMPT + TP_STEPS})
    out, walls = [logits[:, 0]], []
    for i in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(params, {"cache": cache, "tokens": forced[:, i:i + 1],
                                        "pos": TP_PROMPT + i})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0])
    return out, walls


def rank_weight_bytes(torch, cfg, scfg, mesh):
    """(the weight bytes a rank holds under the serve placements of `scfg`,
    the serve config of `cfg`: its share of each cut leaf plus every
    replicated leaf; the most that one leaf in flight adds while the rank
    cuts its weights: drawn in fp32, cast, padded, its shard copied)."""
    from repro_torch.core import steps
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.params import leaves, param_specs

    sizes = list(shd.axis_sizes(mesh).values())
    elt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    true_numel = {k: v.numel() for k, v in leaves(param_specs(cfg))}
    pl = steps.serve_param_shardings(scfg, mesh)
    expected = leaf_peak = 0
    for (path, spec), (_, p) in zip(leaves(param_specs(scfg, dtype=scfg.dtype)), leaves(pl)):
        nbytes = spec.numel() * spec.element_size()
        n = math.prod(s for s, x in zip(sizes, p) if x != shd.Replicate())
        expected += nbytes // n
        leaf_peak = max(leaf_peak, true_numel[path] * (4 + elt) + nbytes * (1 + 1 / n))
    return expected, leaf_peak


def held_decode_attention(torch, kernel, dtype, per_step, n_steps, stats=None):
    """A stand-in for ops.decode_attention that calls `kernel` and holds
    every call of the first and the last decode step (per_step calls a
    step) against the plain version on the same inputs: o, and the lse of
    a call that asks for it (the small-serve layout's cuts, within LSE_TOL,
    -inf at the same rows). Returns (the stand-in, the list it fills: ((B,
    H, D, KH, S), max abs error, within tolerance) a held call). `stats`,
    where given, gets the calls, those with the lse, and the held rows with
    no valid key."""
    from repro_torch.kernels import decode_attention as kd

    calls, held = [0], []
    stats = {} if stats is None else stats
    stats.update(calls=0, lse_calls=0, empty_rows=0)

    def decode_attention(q, k, v, valid_len, return_lse=False):
        out = (kernel(q, k, v, valid_len, return_lse=True) if return_lse
               else kernel(q, k, v, valid_len))
        i = calls[0]
        calls[0] += 1
        stats["calls"] += 1
        stats["lse_calls"] += int(return_lse)
        if i < per_step or i >= per_step * (n_steps - 1):   # the first and the last step
            want = kd.decode_attention_plain(q, k, v, valid_len, return_lse)
            o, want_o = (out[0], want[0]) if return_lse else (out, want)
            err = errors(torch, f"decode_attention/{dtype}", o.float(), want_o.float())
            ok = err[2] and (not return_lse or lse_errors(torch, out[1], want[1])[1])
            stats["empty_rows"] += int((valid_len == 0).sum())
            held.append((tuple(q.shape) + (k.shape[2], k.shape[1]), err[0], ok))
        return out

    return decode_attention, held


def tp_rank(rank, world, backend, case, tokens, forced):
    """One rank of a phase-18 case: its mesh; its shards of the seed-0
    weights, cut leaf by leaf as each is drawn on the card, so that besides
    the shards only one full leaf is ever on the card; the sharded prefill
    and decode, with every decode attention of the first and the last step
    held against its plain version on the rank's own q, K/V ring and
    valid_len. Returns plain data."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import kernels
    from repro_torch.core import steps
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models.params import iter_params, leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    shape, depth, dtype = case
    if depth is not None:
        # the depth cut puts the model under 1B parameters, the small-serve
        # layout's rule; the full-depth model (1.1B) takes the head layout
        shd._small_serve = lambda cfg: False
    cfg = tp_config(case)
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    local = steps.shard_params(
        iter_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda", cfg.dtype), cfg, mesh)
    peak = torch.cuda.max_memory_allocated() - base
    scfg = steps.tp_serve_cfg(cfg, mesh)
    expected, leaf_peak = rank_weight_bytes(torch, cfg, scfg, mesh)
    local_bytes = sum(t.numel() * t.element_size() for _, t in leaves(local))
    toks = steps.shard_batch(torch.from_numpy(tokens).cuda(), mesh)
    forced_t = steps.shard_batch(torch.from_numpy(forced).cuda(), mesh)
    prefill, decode = steps.sharded_prefill(cfg, mesh), steps.sharded_decode(cfg, mesh)
    kernel = ops.decode_attention
    ops.decode_attention, held = held_decode_attention(torch, kernel, dtype, cfg.n_layers,
                                                       TP_STEPS)
    kernels.reset_launch_counts()
    try:
        logits, walls = tp_decode(torch, prefill, decode, local, toks, forced_t)
    finally:
        ops.decode_attention = kernel
    launches = kernels.launch_counts()["decode_attention"]
    stacked = torch.stack(logits).float()                     # [17, B_local, V]
    coord = mesh.get_coordinate()
    wq = local["body"]["l0"]["mixer"]["wq"]
    return dict(
        rank=rank, world=world, backend=backend, coord=list(coord),
        heads=int(wq.shape[-3] * wq.shape[-2]), kv_heads=int(wq.shape[-3]),
        serve_heads=(scfg.n_heads, scfg.n_kv_heads), local_bytes=local_bytes,
        expected_bytes=expected, peak_bytes=peak,
        peak_bound=local_bytes + leaf_peak, launches=launches, step_ms=walls,
        # (B, H, D, KH, S) of each held call, its max abs error, within tolerance
        held=[(b, h, d, kh, s) for (b, h, d, kh, s), _, _ in held],
        held_err=max(e for _, e, _ in held), held_ok=all(ok for *_, ok in held),
        tokens=stacked.argmax(-1).cpu().numpy(),
        # every model rank holds the same gathered logits: one a data shard returns them
        logits=stacked.cpu().numpy() if coord[1] == 0 else None)


def tp_case(torch, np, name, case, card):
    """One case: the unsharded port in this process (greedy), then the
    ranks, fed its tokens."""
    from repro_torch.core import steps
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.params import leaves

    shape, _, dtype = case
    cfg = tp_config(case)
    tokens = np.random.default_rng(18).integers(0, cfg.vocab, (TP_ROWS, TP_PROMPT))
    params = tp_weights(torch, cfg, "cuda")
    full_bytes = sum(t.numel() * t.element_size() for _, t in leaves(params))
    prefill, decode = steps.make_prefill(cfg), steps.make_decode(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens).cuda(),
                                     "cache_len": TP_PROMPT + TP_STEPS})
    greedy = [logits.argmax(-1)]
    for i in range(TP_STEPS - 1):
        logits, cache = decode(params, {"cache": cache, "tokens": greedy[-1],
                                        "pos": TP_PROMPT + i})
        greedy.append(logits.argmax(-1))
    forced = torch.cat(greedy, 1).cpu().numpy()                # [B, TP_STEPS]
    del cache
    # the unsharded run on the same inputs as the ranks: teacher-forced
    ref, ref_walls = tp_decode(torch, prefill, decode, params,
                               torch.from_numpy(tokens).cuda(), torch.from_numpy(forced).cuda())
    ref = torch.stack(ref).float()
    ref_top2 = torch.topk(ref, 2, dim=-1).values
    ref_tokens = ref.argmax(-1).cpu().numpy()                  # [17, B]
    ref_gaps = (ref_top2[..., 0] - ref_top2[..., 1]).cpu().numpy()
    ref = ref.cpu().numpy()
    del params
    torch.cuda.empty_cache()
    fp32 = dtype == "float32"
    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, world, (case, tokens, forced), device="cuda", timeout=600)
    wall_s = time.perf_counter() - t0
    rows = TP_ROWS // shape[0]
    rank_shape = tp_rank_shape(case)
    b, h, kh, d, s, _ = rank_shape
    for r in ranks:
        want = cfg.n_layers * TP_STEPS
        if r["launches"] != want:
            fail(f"tensor-parallel ({name}): rank {r['rank']} ran decode attention "
                 f"{r['launches']} times, not {cfg.n_layers} layers x {TP_STEPS} steps")
        if abs(r["local_bytes"] - r["expected_bytes"]) > 0.01 * r["expected_bytes"]:
            fail(f"tensor-parallel ({name}): rank {r['rank']} holds {r['local_bytes']} "
                 f"weight bytes, not {r['expected_bytes']:.0f} (sharded / tp + replicated)")
        if r["peak_bytes"] > r["peak_bound"]:
            fail(f"tensor-parallel ({name}): rank {r['rank']} reached {r['peak_bytes']} "
                 f"bytes on the card while cutting its weights, over its shards and one "
                 f"leaf in flight ({r['peak_bound']:.0f})")
        if len(r["held"]) != 2 * cfg.n_layers or set(r["held"]) != {(b, h, d, kh, s)}:
            fail(f"tensor-parallel ({name}): rank {r['rank']} held {len(r['held'])} decode "
                 f"attention calls at {sorted(set(r['held']))}, not {2 * cfg.n_layers} at "
                 f"the rank shape {rank_shape}")
        if not r["held_ok"]:
            fail(f"tensor-parallel ({name}): rank {r['rank']}'s decode attention differs "
                 f"from its plain version on the rank's inputs by {r['held_err']:.3e}, beyond "
                 f"{TOL[f'decode_attention/{dtype}']}")
    got_tokens = np.zeros_like(ref_tokens)
    logit_err = 0.0
    for r in ranks:
        sl = slice(r["coord"][0] * rows, (r["coord"][0] + 1) * rows)
        if r["coord"][1] != 0 and not np.array_equal(r["tokens"], got_tokens[:, sl]):
            fail(f"tensor-parallel ({name}): the model ranks of data shard "
                 f"{r['coord'][0]} disagree")
        got_tokens[:, sl] = r["tokens"]
        if r["logits"] is not None:
            logit_err = max(logit_err, float(np.abs(r["logits"] - ref[:, sl]).max()))
    tie = NEAR_TIE if not fp32 else TP_FP32_TOL
    # every step's greedy token, both sides teacher-forced
    diff = np.argwhere(got_tokens != ref_tokens)
    for k, row in diff:
        if ref_gaps[k, row] >= tie:
            fail(f"tensor-parallel ({name}): row {row} step {k} token {got_tokens[k, row]} "
                 f"vs unsharded {ref_tokens[k, row]}, top-2 gap {ref_gaps[k, row]:.3e} "
                 f">= {tie}")
    scale = float(np.abs(ref).max())
    if fp32 and not logit_err <= TP_FP32_TOL * scale:
        fail(f"tensor-parallel ({name}): logits {logit_err:.3e} from the unsharded port's "
             f"(max abs {scale:.3e}, tolerance {TP_FP32_TOL} of it)")
    r0 = ranks[0]
    tp = shape[1]
    if r0["kv_heads"] * tp != max(cfg.n_kv_heads, tp) or r0["heads"] * tp < cfg.n_heads:
        fail(f"tensor-parallel ({name}): {r0['heads']} q heads and {r0['kv_heads']} KV "
             f"heads a rank at tp {tp} (serve heads {r0['serve_heads']})")
    out = dict(
        mesh=list(shape), layers=cfg.n_layers, dtype=dtype, backend=r0["backend"],
        world=world, serve_heads=list(r0["serve_heads"]),
        rank_heads=[r0["heads"], r0["kv_heads"]], rank_kernel_shape=list(rank_shape[:5]),
        rank_weight_bytes=[r["local_bytes"] for r in ranks],
        expected_weight_bytes=r0["expected_bytes"],
        rank_peak_bytes_while_cutting=[r["peak_bytes"] for r in ranks],
        peak_bound_bytes=r0["peak_bound"],
        full_weight_bytes=full_bytes,
        launches_per_rank=[r["launches"] for r in ranks],
        launches=sum(r["launches"] for r in ranks),
        held_calls_per_rank=len(r0["held"]),
        held_max_abs_err=max(r["held_err"] for r in ranks),
        near_ties=int(len(diff)), checked_tokens=int(got_tokens.size),
        agreement=float((got_tokens == ref_tokens).mean()),
        max_abs_logit_err=logit_err, ref_max_abs_logit=scale,
        step_ms_tp1=float(np.median(ref_walls[1:-1])),
        step_ms=float(np.median(r0["step_ms"][1:-1])), ranks_wall_s=wall_s, card=card)
    print(f"tensor-parallel ({name}): " + json.dumps(out))
    return out


def tensor_parallel_phase(torch, F, np, card, cases=None) -> dict:
    """Phase 18: decode attention at the ranks' shapes, then the sharded
    serve steps on spawned ranks (TP_CASES)."""
    t0 = time.perf_counter()
    cases = cases or TP_CASES
    out = {"kernel_rows": tp_kernel_rows(torch, F, np, cases)}
    for name, case in cases.items():
        out[name] = tp_case(torch, np, name, case, card)
    out["launches"] = {"decode_attention": sum(out[n]["launches"] for n in cases)}
    out["phase_s"] = time.perf_counter() - t0
    for name in cases:
        v = out[name]
        print(f"tensor-parallel ({name}): backend {v['backend']}, world {v['world']}, "
              f"decode step {v['step_ms_tp1']:.2f} ms at tp 1, {v['step_ms']:.2f} ms at tp "
              f"{v['mesh'][1]} | {card}")
    print(f"tensor-parallel phase: {out['phase_s']:.1f} s")
    return out


# --- phase 19: tensor-parallel serving of the MoE, SSM and hybrid families ---

FAM_TP_PROMPT, FAM_TP_STEPS = 32, 8
# case: (arch, mesh (data, model), layers or None for all of them, rows,
# decode steps). (d) EP: 64 experts over 2 data ranks; (e) weight-gather: 8
# experts, which 3 data ranks do not divide, d_model 6,144 cut over them,
# 12 rows so each data rank routes 4 tokens a decode step (moe_shard_map's
# minimum); one layer and one decode step, since each forward gathers the
# layer's three expert leaves (1.6 GB each a rank in fp32) through gloo's
# host staging, ~4 s a leaf on the card (two steps until phase 21 came:
# the script's time limit); (f) the SSM block's channels and
# heads over 2 and 4 model ranks; (g) one whole block of jamba's 8 layers
# (attention, SSM, MoE, MLP), EP. moonshot at 2 layers (4 until phase 23
# came) and mamba2 at 24 of 48, so that the script stays within its time
# limit. At 12 layers mamba2's bf16 tokens at (1, 4) flipped at a top-2 gap
# of 3.131e-02, just past the 3e-2 near-tie allowance (ROADMAP Queue 3 C).
FAM_TP_CASES = {"d": ("moonshot-v1-16b-a3b", (2, 2), 2, 8, FAM_TP_STEPS),
                "e": ("mixtral-8x22b", (3, 2), 1, 12, 1),
                "f2": ("mamba2-370m", (1, 2), 24, 8, FAM_TP_STEPS),
                "f4": ("mamba2-370m", (1, 4), 24, 8, FAM_TP_STEPS),
                "g": ("jamba-v0.1-52b", (2, 2), 8, 8, FAM_TP_STEPS)}
FAM_TP_DTYPES = ("float32", "bfloat16")
# Not in the default script: jamba at full depth (32 layers, ~103 GB of
# bf16 weights, more than one card holds) on four cards, NCCL, a card a
# rank (`fam_four_card`).
FAM_TP_FOUR_CARD = ("jamba-v0.1-52b", (2, 2), None, 8, FAM_TP_STEPS)


def _fam_case(name):
    return FAM_TP_FOUR_CARD if name == "g4" else FAM_TP_CASES[name]


def fam_config(name, dtype, no_drop=None):
    """A case's config in `dtype`. With no_drop (the default at fp32) an
    MoE's capacity factor is E / top_k, so C >= the group: an expert can
    take every token of its group and no choice drops, in the ranks' local
    groups or the unsharded global ones; otherwise it is the config's own
    (1.25)."""
    from repro_torch.configs import get_config

    arch, _, depth, *_ = _fam_case(name)
    cfg = get_config(arch)
    fields = dict(n_layers=depth or cfg.n_layers, dtype=dtype)
    if (dtype == "float32" if no_drop is None else no_drop) and cfg.n_experts:
        fields["capacity_factor"] = cfg.n_experts / cfg.top_k
    return dataclasses.replace(cfg, **fields)


def fam_rank_shapes(name):
    """The decode attention (B, H, KH, D, S, dtype) each rank of a case
    launches, one a dtype (none for an attention-free model)."""
    from repro_torch.configs import serve_config
    from repro_torch.models.params import ring_len

    _, (data, tp), _, rows, steps = _fam_case(name)
    cfg = fam_config(name, "bfloat16")
    if not n_attn_layers(cfg):
        return []
    scfg = serve_config(cfg, tp)
    return [(rows // data, scfg.n_heads // tp, scfg.n_kv_heads // tp, cfg.hd,
             ring_len(cfg, FAM_TP_PROMPT + steps), dt) for dt in FAM_TP_DTYPES]


def fam_kernel_rows(torch, F, np, cases):
    """Decode attention at every rank shape of `cases`, fp32 and bf16: held
    against its plain version and SDPA, timed and bounded as phase 7 does."""
    from repro_torch.kernels import decode_attention as kd

    rng = np.random.default_rng(1919)
    shapes = dict.fromkeys(s for n in cases for s in fam_rank_shapes(n))
    rows = [decode_row(torch, F, np, kd, rng, shape)[0] for shape in shapes]
    torch.cuda.synchronize()
    report_decode_rows(rows)
    return rows


def fam_unsharded(torch, np, cfg, tokens, n_steps):
    """The unsharded port on the card, seed-0 weights in cfg.dtype: prefill
    and n_steps greedy decode steps. Returns (logits [1 + steps, B, V]
    fp32 numpy, the tokens fed to the steps [B, steps], each step's wall
    ms); the weights are freed before it returns."""
    from repro_torch.core import steps

    params = tp_weights(torch, cfg, "cuda")
    prefill, decode = steps.make_prefill(cfg), steps.make_decode(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens).cuda(),
                                     "cache_len": FAM_TP_PROMPT + n_steps})
    out, toks, walls = [logits[:, 0].float()], [logits.argmax(-1)], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(params, {"cache": cache, "tokens": toks[-1],
                                        "pos": FAM_TP_PROMPT + i})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0].float())
        toks.append(logits.argmax(-1))
    ref = torch.stack(out).cpu().numpy()
    forced = torch.cat(toks[:n_steps], 1).cpu().numpy()
    return ref, forced, walls


def fam_pass(torch, name, dtype, mesh, tokens, forced, no_drop=None) -> dict:
    """One dtype of a case on this rank: its shards of the seed-0 weights,
    cut leaf by leaf as each is drawn on the card, the ranks taking turns
    (a stacked leaf spans every layer: six ranks' leaves in flight at once
    would not fit the card beside the shards); the sharded prefill and
    the case's decode steps fed `forced` (the global rows, or this
    rank's rows as a tensor; None: its own greedy tokens), with every
    decode attention of the first and the last step held against its plain
    version on the rank's own inputs; the MoE layer's dispatches counted.
    Plain data."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import steps
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.params import iter_params, leaves

    _, shape, _, rows, n_steps = _fam_case(name)
    cfg = fam_config(name, dtype, no_drop)
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            free_before = torch.cuda.mem_get_info()[0]
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            local = steps.shard_params(iter_params(cfg, torch.Generator("cuda").manual_seed(0),
                                                   "cuda", cfg.dtype), cfg, mesh)
            peak = torch.cuda.max_memory_allocated() - base
            torch.cuda.synchronize()
            torch.cuda.empty_cache()   # the leaf in flight, back to the card for the next rank
        dist.barrier()
    expected, leaf_peak = rank_weight_bytes(torch, cfg, steps.tp_serve_cfg(cfg, mesh), mesh)
    local_bytes = sum(t.numel() * t.element_size() for _, t in leaves(local))
    toks = steps.shard_batch(torch.from_numpy(tokens).cuda(), mesh)
    forced_t = (forced if forced is None or isinstance(forced, torch.Tensor)
                else steps.shard_batch(torch.from_numpy(forced).cuda(), mesh))
    prefill = steps.sharded_prefill(cfg, mesh, batch=rows)
    decode = steps.sharded_decode(cfg, mesh, batch=rows)
    per_step = n_attn_layers(cfg)
    kernel, shard_map, dispatch = ops.decode_attention, L.moe_shard_map, [0, 0]
    decode_attention, held = held_decode_attention(torch, kernel, dtype, per_step, n_steps)

    def counted_shard_map(*a, **kw):
        dispatch[0] += 1
        return shard_map(*a, **kw)

    moe = L.moe

    def counted_moe(*a, **kw):
        dispatch[1] += 1
        return moe(*a, **kw)

    ops.decode_attention, L.moe_shard_map, L.moe = decode_attention, counted_shard_map, counted_moe
    kernels.reset_launch_counts()
    try:
        logits, walls = [], []
        out, cache = prefill(local, {"tokens": toks,
                                     "cache_len": FAM_TP_PROMPT + n_steps})
        logits.append(out[:, 0].float())
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fed = out.argmax(-1) if forced_t is None else forced_t[:, i:i + 1]
            out, cache = decode(local, {"cache": cache, "tokens": fed,
                                        "pos": FAM_TP_PROMPT + i})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            logits.append(out[:, 0].float())
    finally:
        ops.decode_attention, L.moe_shard_map, L.moe = kernel, shard_map, moe
    launches = kernels.launch_counts()["decode_attention"]
    stacked = torch.stack(logits)                              # [1 + steps, B_local, V]
    coord = mesh.get_coordinate()
    res = dict(
        local_bytes=local_bytes, expected_bytes=expected, peak_bytes=peak,
        card_free_before_draw=free_before,
        peak_bound=local_bytes + leaf_peak, launches=launches, step_ms=walls,
        per_step=per_step, moe_calls=dispatch[1], shard_map_calls=dispatch[0],
        held=[(b, h, d, kh, s) for (b, h, d, kh, s), _, _ in held],
        held_err=max((e for _, e, _ in held), default=0.0),
        held_ok=all(ok for *_, ok in held),
        tokens=stacked.argmax(-1).cpu().numpy(),
        # every model rank holds the same gathered logits: one a data shard returns them
        logits=stacked.cpu().numpy() if coord[1] == 0 else None)
    del local, cache, out, logits, stacked
    torch.cuda.empty_cache()
    return res


def fam_rank(rank, world, backend, name, tokens, forced):
    """One rank of a phase-19 case: its mesh, then each dtype's pass
    (`fam_pass`), fed that dtype's unsharded greedy tokens. The four-card
    case ("g4") instead runs bf16 greedy at the config's capacity, then
    bf16 at capacity E / top_k fed those tokens ("nodrop")."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _, shape, _, _, steps = _fam_case(name)
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    out = dict(rank=rank, world=world, backend=backend, coord=list(mesh.get_coordinate()))
    if name == "g4":
        out["bfloat16"] = fam_pass(torch, name, "bfloat16", mesh, tokens, None, no_drop=False)
        fed = torch.from_numpy(out["bfloat16"]["tokens"][:steps].T.copy()).cuda()
        out["nodrop"] = fam_pass(torch, name, "bfloat16", mesh, tokens, fed, no_drop=True)
        return out
    for dt in FAM_TP_DTYPES:
        out[dt] = fam_pass(torch, name, dt, mesh, tokens, forced[dt])
    return out


def fam_run_ranks(run_ranks, world, args):
    """`run_ranks(fam_rank)` with the ranks' CUDA allocator on expandable
    segments: a rank's shards, carved from the segment of a freed full
    leaf, would otherwise pin the whole segment, and the ranks' pinned
    segments together outgrow the card (they read the setting from the
    environment they are started with)."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    prev = os.environ.get(key)
    os.environ[key] = "expandable_segments:True"
    try:
        return run_ranks(fam_rank, world, args, device="cuda", timeout=1500)
    finally:
        if prev is None:
            del os.environ[key]
        else:
            os.environ[key] = prev


def fam_case(torch, np, name, card) -> dict:
    """One case: the unsharded port in this process, fp32 then bf16, each
    freed before the next; then the ranks, fed its greedy tokens. Gates the
    fp32 logits, mamba2's bf16 tokens, the kernel checks, launches and the
    weight and peak bytes a rank."""
    from repro_torch.launch.mesh import run_ranks

    arch, shape, _, rows, n_steps = FAM_TP_CASES[name]
    tokens = np.random.default_rng(19).integers(
        0, fam_config(name, "float32").vocab, (rows, FAM_TP_PROMPT))
    refs, forced = {}, {}
    for dt in FAM_TP_DTYPES:
        refs[dt] = fam_unsharded(torch, np, fam_config(name, dt), tokens, n_steps)
        forced[dt] = refs[dt][1]
        torch.cuda.empty_cache()   # every tensor of the run is gone: its segments go back
    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    ranks = fam_run_ranks(run_ranks, world, (name, tokens, forced))
    wall_s = time.perf_counter() - t0
    local_rows = rows // shape[0]
    out = dict(arch=arch, mesh=list(shape), world=world, backend=ranks[0]["backend"],
               ranks_wall_s=wall_s, card=card)
    for dt in FAM_TP_DTYPES:
        cfg = fam_config(name, dt)
        ref, _, ref_walls = refs[dt]
        where = f"tensor-parallel families ({name}, {arch}, {dt})"
        # (B, H, D, KH, S), as a held call records it
        want_held = {(b, h, d, kh, s) for b, h, kh, d, s, t in fam_rank_shapes(name) if t == dt}
        for r in ranks:
            v = r[dt]
            if v["launches"] != v["per_step"] * n_steps:
                fail(f"{where}: rank {r['rank']} ran decode attention {v['launches']} times, "
                     f"not {v['per_step']} attention layers x {n_steps} steps")
            if v["local_bytes"] != v["expected_bytes"]:
                fail(f"{where}: rank {r['rank']} holds {v['local_bytes']} weight bytes, not "
                     f"{v['expected_bytes']} (its share of each cut leaf + the replicated)")
            if v["peak_bytes"] > v["peak_bound"]:
                fail(f"{where}: rank {r['rank']} reached {v['peak_bytes']} bytes on the card "
                     f"while cutting its weights, over its shards and one leaf in flight "
                     f"({v['peak_bound']:.0f})")
            # the first and the last step's calls (one step: its own)
            n_held = min(2, n_steps) * v["per_step"]
            if (len(v["held"]) != n_held
                    or (v["held"] and set(v["held"]) != want_held)):
                fail(f"{where}: rank {r['rank']} held {len(v['held'])} decode attention "
                     f"calls at {sorted(set(v['held']))}, not {n_held} at "
                     f"{sorted(want_held)}")
            if not v["held_ok"]:
                fail(f"{where}: rank {r['rank']}'s decode attention differs from its plain "
                     f"version on the rank's inputs by {v['held_err']:.3e}, beyond "
                     f"{TOL[f'decode_attention/{dt}']}")
            moe_layers = sum(1 for _, f in cfg.layer_kinds() if f == "moe")
            if v["moe_calls"] != moe_layers * (1 + n_steps):
                fail(f"{where}: rank {r['rank']} ran {v['moe_calls']} MoE layers, not "
                     f"{moe_layers} x {1 + n_steps} steps")
        ref_tokens = ref.argmax(-1)                                     # [1 + steps, B]
        top2 = np.sort(ref, axis=-1)[..., -2:]
        gaps = top2[..., 1] - top2[..., 0]
        got_tokens = np.zeros_like(ref_tokens)
        logit_err = 0.0
        for r in ranks:
            v = r[dt]
            sl = slice(r["coord"][0] * local_rows, (r["coord"][0] + 1) * local_rows)
            if r["coord"][1] != 0 and not np.array_equal(v["tokens"], got_tokens[:, sl]):
                fail(f"{where}: the model ranks of data shard {r['coord'][0]} disagree")
            got_tokens[:, sl] = v["tokens"]
            if v["logits"] is not None:
                logit_err = max(logit_err, float(np.abs(v["logits"] - ref[:, sl]).max()))
        scale = float(np.abs(ref).max())
        diff = np.argwhere(got_tokens != ref_tokens)
        fp32 = dt == "float32"
        tie = TP_FP32_TOL if fp32 else NEAR_TIE
        gated = fp32 or cfg.family == "ssm"
        if fp32 and not logit_err <= TP_FP32_TOL * scale:
            fail(f"{where}: logits {logit_err:.3e} from the unsharded port's (max abs "
                 f"{scale:.3e}, tolerance {TP_FP32_TOL} of it)")
        if gated:
            for k, row in diff:
                if gaps[k, row] >= tie:
                    fail(f"{where}: row {row} step {k} token {got_tokens[k, row]} vs "
                         f"unsharded {ref_tokens[k, row]}, top-2 gap {gaps[k, row]:.3e} "
                         f">= {tie}")
        r0 = ranks[0][dt]
        out[dt] = dict(
            layers=cfg.n_layers, capacity_factor=cfg.capacity_factor if cfg.n_experts else None,
            rank_weight_bytes=[r[dt]["local_bytes"] for r in ranks],
            expected_weight_bytes=[r[dt]["expected_bytes"] for r in ranks],
            rank_peak_bytes_while_cutting=[r[dt]["peak_bytes"] for r in ranks],
            card_free_bytes_before_draw=[r[dt]["card_free_before_draw"] for r in ranks],
            peak_bound_bytes=[r[dt]["peak_bound"] for r in ranks],
            launches_per_rank=[r[dt]["launches"] for r in ranks],
            launches=sum(r[dt]["launches"] for r in ranks),
            moe_calls=r0["moe_calls"], shard_map_calls=r0["shard_map_calls"],
            held_calls_per_rank=len(r0["held"]),
            held_max_abs_err=max(r[dt]["held_err"] for r in ranks),
            tokens_gated=gated, near_ties=int(len(diff)), checked_tokens=int(got_tokens.size),
            agreement=float((got_tokens == ref_tokens).mean()),
            max_abs_logit_err=logit_err, ref_max_abs_logit=scale,
            # the median past the first and the last step, where there are more than two
            step_ms_unsharded=float(np.median(ref_walls[1:-1] or ref_walls)),
            step_ms=float(np.median(r0["step_ms"][1:-1] or r0["step_ms"])))
    print(f"tensor-parallel families ({name}): " + json.dumps(out))
    return out


def fam_four_card(torch, np, card) -> dict:
    """jamba-v0.1-52b at full depth at (2, 2) on four cards (NCCL, a card a
    rank): no card holds the unsharded model, so nothing is held against
    it. Gated per rank as `fam_case` gates (launches, exact weight bytes,
    the peak while cutting, the held kernel calls); printed: bytes and
    peak a rank, the decode step's ms, and the teacher-forced agreement of
    the no-drop pass (capacity E / top_k) with the greedy tokens of the
    pass at the config's capacity, which is what the dropped choices
    change."""
    from repro_torch.launch.mesh import run_ranks

    arch, shape, _, rows, n_steps = FAM_TP_FOUR_CARD
    tokens = np.random.default_rng(19).integers(
        0, fam_config("g4", "bfloat16").vocab, (rows, FAM_TP_PROMPT))
    t0 = time.perf_counter()
    ranks = fam_run_ranks(run_ranks, 4, ("g4", tokens, None))
    wall_s = time.perf_counter() - t0
    where = f"four-card {arch}"
    if any(r["backend"] != "nccl" for r in ranks):
        fail(f"{where}: ranks on {[r['backend'] for r in ranks]}, not NCCL a card a rank")
    want_held = {(b, h, d, kh, s) for b, h, kh, d, s, t in fam_rank_shapes("g4")
                 if t == "bfloat16"}
    for r in ranks:
        for key in ("bfloat16", "nodrop"):
            v = r[key]
            if v["launches"] != v["per_step"] * n_steps:
                fail(f"{where} ({key}): rank {r['rank']} ran decode attention "
                     f"{v['launches']} times, not {v['per_step']} x {n_steps}")
            if v["local_bytes"] != v["expected_bytes"]:
                fail(f"{where} ({key}): rank {r['rank']} holds {v['local_bytes']} weight "
                     f"bytes, not {v['expected_bytes']}")
            if v["peak_bytes"] > v["peak_bound"]:
                fail(f"{where} ({key}): rank {r['rank']} reached {v['peak_bytes']} bytes "
                     f"while cutting, over {v['peak_bound']:.0f}")
            if len(v["held"]) != 2 * v["per_step"] or set(v["held"]) != want_held \
                    or not v["held_ok"]:
                fail(f"{where} ({key}): rank {r['rank']}'s held decode attention calls "
                     f"{sorted(set(v['held']))} (error {v['held_err']:.3e})")
    free = np.concatenate([r["bfloat16"]["tokens"] for r in ranks if r["coord"][1] == 0], 1)
    forced = np.concatenate([r["nodrop"]["tokens"] for r in ranks if r["coord"][1] == 0], 1)
    r0 = ranks[0]
    out = dict(arch=arch, layers=fam_config("g4", "bfloat16").n_layers, mesh=list(shape),
               backend=r0["backend"], ranks_wall_s=wall_s, card=card,
               rank_weight_bytes=[r["bfloat16"]["local_bytes"] for r in ranks],
               rank_peak_bytes_while_cutting=[r["bfloat16"]["peak_bytes"] for r in ranks],
               peak_bound_bytes=[r["bfloat16"]["peak_bound"] for r in ranks],
               launches=sum(r[k]["launches"] for r in ranks for k in ("bfloat16", "nodrop")),
               held_max_abs_err=max(r[k]["held_err"] for r in ranks
                                    for k in ("bfloat16", "nodrop")),
               step_ms=float(np.median(r0["bfloat16"]["step_ms"][1:-1])),
               step_ms_nodrop=float(np.median(r0["nodrop"]["step_ms"][1:-1])),
               nodrop_agreement=float((free == forced).mean()),
               checked_tokens=int(free.size))
    print(f"four-card: " + json.dumps(out))
    return out


def tp_families_phase(torch, F, np, card, cases=None) -> dict:
    """Phase 19: decode attention at the new rank shapes, then each case of
    FAM_TP_CASES on spawned ranks that share the card (gloo)."""
    t0 = time.perf_counter()
    cases = cases or list(FAM_TP_CASES)
    out = {"kernel_rows": fam_kernel_rows(torch, F, np, cases)}
    for name in cases:
        out[name] = fam_case(torch, np, name, card)
    out["launches"] = {"decode_attention": sum(out[n][dt]["launches"] for n in cases
                                               for dt in FAM_TP_DTYPES)}
    out["phase_s"] = time.perf_counter() - t0
    for name in cases:
        v = out[name]
        for dt in FAM_TP_DTYPES:
            w = v[dt]
            print(f"tensor-parallel families ({name}, {dt}): {v['arch']} {w['layers']} layers "
                  f"on {tuple(v['mesh'])} ({v['backend']}), decode step "
                  f"{w['step_ms_unsharded']:.2f} ms unsharded, {w['step_ms']:.2f} ms sharded; "
                  f"logit err {w['max_abs_logit_err']:.3e} of {w['ref_max_abs_logit']:.3e}, "
                  f"agreement {w['agreement']:.3f} ({w['near_ties']} differ) | {card}")
    print(f"tensor-parallel families phase: {out['phase_s']:.1f} s")
    return out


# --- phase 20: the small-serve layout on a mesh --------------------------------

SS_ROWS, SS_PROMPT, SS_CACHE, SS_STEPS = 8, 16, 64, 24
SS_DTYPES = ("float32", "bfloat16")
LSE_TOL = 1e-4   # a finite lse's max abs difference from the plain version's
# case: (arch, mesh (data, model), layers or None for all of them). (h2),
# (h4) whisper-base at full depth, its 64-slot self-attention ring cut to 32
# and 16 slots a rank, its 1,500-frame cross cache to 750 and 375; (i)
# tinyllama-1.1b at full width and 8 of 22 layers (0.48B parameters, under
# the layout's 1B), its ring cut to 32: with 16-token prompts the cut of
# rank 1 holds no valid key for the first 16 steps, then fills.
SS_CASES = {"h2": ("whisper-base", (1, 2), None), "h4": ("whisper-base", (1, 4), None),
            "i": ("tinyllama-1.1b", (1, 2), 8)}


def ss_config(name, dtype):
    from repro_torch.configs import get_config

    arch, _, depth = SS_CASES[name]
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=depth or cfg.n_layers, dtype=dtype)


def ss_rank_shapes(name):
    """(B, H, KH, D, S, dtype) of each decode attention a rank of a case
    launches: the whole heads over its cut of the ring, and of the cross
    cache (an encoder-decoder), one a dtype."""
    from repro_torch.models.params import ring_len

    _, (data, tp), _ = SS_CASES[name]
    cfg = ss_config(name, "float32")
    rings = [ring_len(cfg, SS_CACHE)] + ([cfg.n_audio_ctx] if cfg.enc_layers else [])
    return [(SS_ROWS // data, cfg.n_heads, cfg.n_kv_heads, cfg.hd, s // tp, dt)
            for s in rings for dt in SS_DTYPES]


def lse_errors(torch, got, want):
    """(max abs difference of the finite lse, allclose within LSE_TOL and
    -inf at the same rows)."""
    fin = torch.isfinite(want)
    same = torch.equal(torch.isneginf(got), torch.isneginf(want)) and bool(
        torch.isfinite(got[fin]).all())
    d = (got[fin].double() - want[fin].double()).abs()
    err = float(d.max()) if d.numel() else 0.0
    return err, same and err <= LSE_TOL


def decode_lse_row(torch, F, np, kd, rng, shape):
    """decode_row with the log-sum-exp (a rank's cut of a ring or a cross
    cache): valid_len drawn in [1, S] and row 0's set to 0 (a cut that
    holds none of the row's keys); the kernel's o held against the plain
    version's at the decode tolerance and its lse within LSE_TOL (-inf at
    the same rows); the kernel and the plain version, both with the lse,
    timed beside SDPA, which computes o alone (its error over the rows
    with a valid key: a fully masked row is NaN there), and the kernel
    without the lse on the same inputs (nolse_ms; row 0 then averages V
    over all S). Its bound counts the lse written too."""
    b, h, kh, d, s_len, dt = shape
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev, dtype)
               for sh in ((b, h, d), (b, s_len, kh, d), (b, s_len, kh, d)))
    vl_np = rng.integers(1, s_len + 1, b).astype(np.int32)
    vl_np[0] = 0
    vl = torch.from_numpy(vl_np).to(dev)
    name = f"decode_attention/{dt}"
    o, lse = kd.decode_attention_kernel(q, k, v, vl, return_lse=True)
    want_o, want_lse = kd.decode_attention_plain(q, k, v, vl, return_lse=True)
    row = dict(name="decode_attention", lse=True, B=b, H=h, KH=kh, D=d, S=s_len, dtype=dt,
               tol=name, err=errors(torch, name, o.float(), want_o.float()),
               lse_err=lse_errors(torch, lse, want_lse))
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(s_len, device=dev)[None] < vl[:, None].long())[:, None, None]

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              enable_gqa=True)[:, :, 0]

    row["library_err"] = errors(torch, name, sdpa()[1:].float(), want_o[1:].float())
    row["ms"] = time_ms(torch, lambda: kd.decode_attention_kernel(q, k, v, vl, return_lse=True))
    row["nolse_ms"] = time_ms(torch, lambda: kd.decode_attention_kernel(q, k, v, vl))
    row["plain_ms"] = time_ms(torch, lambda: kd.decode_attention_plain(q, k, v, vl,
                                                                       return_lse=True))
    row["library_ms"] = time_ms(torch, sdpa)
    elt = q.element_size()
    n_valid = int(vl_np.sum())
    row["bytes"] = elt * (2 * b * h * d + 2 * n_valid * kh * d) + 4 * b + 4 * b * h
    row["flops"] = 4 * n_valid * (h // kh) * kh * d
    return row


def ss_kernel_rows(torch, F, np, cases):
    """Decode attention with the lse at every rank shape of `cases`."""
    from repro_torch.kernels import decode_attention as kd

    rng = np.random.default_rng(2020)
    shapes = dict.fromkeys(s for n in cases for s in ss_rank_shapes(n))
    rows = [decode_lse_row(torch, F, np, kd, rng, shape) for shape in shapes]
    torch.cuda.synchronize()
    report_decode_rows(rows)
    return rows


def ss_inputs(np, cfg):
    """The prompts [SS_ROWS, SS_PROMPT] and, for an encoder-decoder, the
    stub audio frames [SS_ROWS, n_audio_ctx, d_model] fp32, from a seed."""
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, cfg.vocab, (SS_ROWS, SS_PROMPT))
    frames = (rng.standard_normal((SS_ROWS, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
              if cfg.enc_layers else None)
    return tokens, frames


def ss_prefill_inputs(torch, tokens, frames, cut):
    inputs = {"tokens": cut(torch.from_numpy(tokens).cuda()), "cache_len": SS_CACHE}
    if frames is not None:
        inputs["audio_frames"] = cut(torch.from_numpy(frames).cuda())
    return inputs


def ss_unsharded(torch, np, cfg, tokens, frames):
    """The unsharded port on the card, seed-0 weights in cfg.dtype: prefill
    and SS_STEPS greedy decode steps. Returns (logits [1 + steps, B, V]
    fp32 numpy, the tokens fed to the steps [B, steps], each step's wall
    ms); the weights are freed before it returns."""
    from repro_torch.core import steps

    params = tp_weights(torch, cfg, "cuda")
    prefill, decode = steps.make_prefill(cfg), steps.make_decode(cfg)
    logits, cache = prefill(params, ss_prefill_inputs(torch, tokens, frames, lambda t: t))
    out, toks, walls = [logits[:, 0].float()], [logits.argmax(-1)], []
    for i in range(SS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode(params, {"cache": cache, "tokens": toks[-1],
                                        "pos": SS_PROMPT + i})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        out.append(logits[:, 0].float())
        toks.append(logits.argmax(-1))
    ref = torch.stack(out).cpu().numpy()
    forced = torch.cat(toks[:SS_STEPS], 1).cpu().numpy()
    del params, cache
    return ref, forced, walls


def ss_cache_bytes(torch, scfg, mesh):
    """The cache bytes a rank holds under the serve placements: its share
    of each cut leaf plus every whole one."""
    from repro_torch.core import steps
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.params import cache_specs, leaves

    sizes = list(shd.axis_sizes(mesh).values())
    pl = dict(leaves(steps.serve_cache_shardings(scfg, mesh, SS_ROWS, SS_CACHE)))
    total = 0
    for path, spec in leaves(cache_specs(scfg, SS_ROWS, SS_CACHE)):
        n = math.prod(s for s, x in zip(sizes, pl[path]) if x != shd.Replicate())
        total += spec.numel() * spec.element_size() // n
    return total


def ss_pass(torch, name, dtype, mesh, tokens, frames, forced) -> dict:
    """One dtype of a case on this rank: its shards of the seed-0 weights
    (the attention weights whole), the sharded prefill into its cut of
    each cache and SS_STEPS decode steps fed `forced`, with every decode
    attention of the first and the last step held against its plain
    version on the rank's own inputs, the lse included. Plain data."""
    from repro_torch import kernels
    from repro_torch.core import steps
    from repro_torch.kernels import ops
    from repro_torch.models.params import iter_params, leaves

    cfg = ss_config(name, dtype)
    local = steps.shard_params(iter_params(cfg, torch.Generator("cuda").manual_seed(0),
                                           "cuda", cfg.dtype), cfg, mesh)
    scfg = steps.tp_serve_cfg(cfg, mesh)
    expected, _ = rank_weight_bytes(torch, cfg, scfg, mesh)
    local_bytes = sum(t.numel() * t.element_size() for _, t in leaves(local))
    cut = lambda t: steps.shard_batch(t, mesh)
    forced_t = cut(torch.from_numpy(forced).cuda())
    prefill = steps.sharded_prefill(cfg, mesh, batch=SS_ROWS)
    decode = steps.sharded_decode(cfg, mesh, batch=SS_ROWS, cache_len=SS_CACHE)
    per_step = n_attn_layers(cfg)
    kernel, stats = ops.decode_attention, {}
    ops.decode_attention, held = held_decode_attention(torch, kernel, dtype, per_step, SS_STEPS,
                                                       stats)
    kernels.reset_launch_counts()
    try:
        logits, walls = [], []
        out, cache = prefill(local, ss_prefill_inputs(torch, tokens, frames, cut))
        cache_bytes = sum(t.numel() * t.element_size() for _, t in leaves(cache))
        logits.append(out[:, 0].float())
        for i in range(SS_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, cache = decode(local, {"cache": cache, "tokens": forced_t[:, i:i + 1],
                                        "pos": SS_PROMPT + i})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            logits.append(out[:, 0].float())
    finally:
        ops.decode_attention = kernel
    launches = kernels.launch_counts()["decode_attention"]
    stacked = torch.stack(logits)                              # [1 + steps, B_local, V]
    coord = mesh.get_coordinate()
    res = dict(
        local_bytes=local_bytes, expected_bytes=expected, cache_bytes=cache_bytes,
        expected_cache_bytes=ss_cache_bytes(torch, scfg, mesh), launches=launches,
        lse_calls=stats["lse_calls"], calls=stats["calls"], empty_rows=stats["empty_rows"],
        step_ms=walls, per_step=per_step,
        held=[(b, h, d, kh, s) for (b, h, d, kh, s), _, _ in held],
        held_err=max((e for _, e, _ in held), default=0.0),
        held_ok=all(ok for *_, ok in held),
        tokens=stacked.argmax(-1).cpu().numpy(),
        logits=stacked.cpu().numpy() if coord[1] == 0 else None)
    del local, cache, out, logits, stacked
    torch.cuda.empty_cache()
    return res


def ss_rank(rank, world, backend, name, tokens, frames, forced):
    """One rank of a phase-20 case: its mesh, then each dtype's pass, fed
    that dtype's unsharded greedy tokens."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    _, shape, _ = SS_CASES[name]
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    out = dict(rank=rank, world=world, backend=backend, coord=list(mesh.get_coordinate()))
    for dt in SS_DTYPES:
        out[dt] = ss_pass(torch, name, dt, mesh, tokens, frames, forced[dt])
    return out


def ss_case(torch, np, name, card) -> dict:
    """One case: the unsharded port in this process, fp32 then bf16; then
    the ranks, fed its greedy tokens. Gates the fp32 logits and tokens, the
    lse launches, the held kernel calls (a cut with no valid key among
    them), and the weight and cache bytes a rank."""
    from repro_torch.launch.mesh import run_ranks

    arch, shape, _ = SS_CASES[name]
    tokens, frames = ss_inputs(np, ss_config(name, "float32"))
    refs, forced = {}, {}
    for dt in SS_DTYPES:
        refs[dt] = ss_unsharded(torch, np, ss_config(name, dt), tokens, frames)
        forced[dt] = refs[dt][1]
        torch.cuda.empty_cache()
    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    ranks = run_ranks(ss_rank, world, (name, tokens, frames, forced), device="cuda",
                      timeout=600)
    wall_s = time.perf_counter() - t0
    local_rows = SS_ROWS // shape[0]
    out = dict(arch=arch, mesh=list(shape), world=world, backend=ranks[0]["backend"],
               ranks_wall_s=wall_s, card=card)
    for dt in SS_DTYPES:
        cfg = ss_config(name, dt)
        ref, _, ref_walls = refs[dt]
        where = f"small-serve ({name}, {arch}, {dt})"
        want_held = {(b, h, d, kh, s) for b, h, kh, d, s, t in ss_rank_shapes(name) if t == dt}
        for r in ranks:
            v = r[dt]
            if v["lse_calls"] != v["per_step"] * SS_STEPS or v["launches"] != v["calls"]:
                fail(f"{where}: rank {r['rank']} ran decode attention {v['launches']} times "
                     f"({v['calls']} calls, {v['lse_calls']} with the lse), not {v['per_step']} "
                     f"attention layers x {SS_STEPS} steps, each with the lse")
            if v["local_bytes"] != v["expected_bytes"]:
                fail(f"{where}: rank {r['rank']} holds {v['local_bytes']} weight bytes, not "
                     f"{v['expected_bytes']} (its share of each cut leaf + the whole ones)")
            if v["cache_bytes"] != v["expected_cache_bytes"]:
                fail(f"{where}: rank {r['rank']} holds {v['cache_bytes']} cache bytes, not "
                     f"{v['expected_cache_bytes']} (its share of each cut leaf + the whole "
                     f"ones)")
            if len(v["held"]) != 2 * v["per_step"] or set(v["held"]) != want_held:
                fail(f"{where}: rank {r['rank']} held {len(v['held'])} decode attention "
                     f"calls at {sorted(set(v['held']))}, not {2 * v['per_step']} at "
                     f"{sorted(want_held)}")
            if not v["held_ok"]:
                fail(f"{where}: rank {r['rank']}'s decode attention differs from its plain "
                     f"version on the rank's inputs by {v['held_err']:.3e}, beyond "
                     f"{TOL[f'decode_attention/{dt}']} (o) or {LSE_TOL} (lse)")
        if not any(r[dt]["empty_rows"] for r in ranks):
            fail(f"{where}: no held decode attention call had a cut with no valid key")
        ref_tokens = ref.argmax(-1)                                     # [1 + steps, B]
        top2 = np.sort(ref, axis=-1)[..., -2:]
        gaps = top2[..., 1] - top2[..., 0]
        got_tokens = np.zeros_like(ref_tokens)
        logit_err = 0.0
        for r in ranks:
            v = r[dt]
            sl = slice(r["coord"][0] * local_rows, (r["coord"][0] + 1) * local_rows)
            if r["coord"][1] != 0 and not np.array_equal(v["tokens"], got_tokens[:, sl]):
                fail(f"{where}: the model ranks of data shard {r['coord'][0]} disagree")
            got_tokens[:, sl] = v["tokens"]
            if v["logits"] is not None:
                logit_err = max(logit_err, float(np.abs(v["logits"] - ref[:, sl]).max()))
        scale = float(np.abs(ref).max())
        diff = np.argwhere(got_tokens != ref_tokens)
        fp32 = dt == "float32"
        if fp32 and not logit_err <= TP_FP32_TOL * scale:
            fail(f"{where}: logits {logit_err:.3e} from the unsharded port's (max abs "
                 f"{scale:.3e}, tolerance {TP_FP32_TOL} of it)")
        if fp32:
            for k, row in diff:
                if gaps[k, row] >= TP_FP32_TOL:
                    fail(f"{where}: row {row} step {k} token {got_tokens[k, row]} vs "
                         f"unsharded {ref_tokens[k, row]}, top-2 gap {gaps[k, row]:.3e} "
                         f">= {TP_FP32_TOL}")
        r0 = ranks[0][dt]
        out[dt] = dict(
            layers=cfg.n_layers, rank_kernel_shapes=sorted(want_held),
            rank_weight_bytes=[r[dt]["local_bytes"] for r in ranks],
            rank_cache_bytes=[r[dt]["cache_bytes"] for r in ranks],
            launches_per_rank=[r[dt]["launches"] for r in ranks],
            launches=sum(r[dt]["launches"] for r in ranks),
            empty_rows_held=[r[dt]["empty_rows"] for r in ranks],
            held_calls_per_rank=len(r0["held"]),
            held_max_abs_err=max(r[dt]["held_err"] for r in ranks),
            tokens_gated=fp32, near_ties=int(len(diff)), checked_tokens=int(got_tokens.size),
            agreement=float((got_tokens == ref_tokens).mean()),
            max_abs_logit_err=logit_err, ref_max_abs_logit=scale,
            step_ms_unsharded=float(np.median(ref_walls[1:-1])),
            step_ms=float(np.median(r0["step_ms"][1:-1])))
    print(f"small-serve ({name}): " + json.dumps(out))
    return out


def small_serve_phase(torch, F, np, card, cases=None) -> dict:
    """Phase 20: decode attention with the lse at the ranks' shapes, then
    each case of SS_CASES on spawned ranks that share the card (gloo)."""
    t0 = time.perf_counter()
    cases = cases or list(SS_CASES)
    out = {"kernel_rows": ss_kernel_rows(torch, F, np, cases)}
    for name in cases:
        out[name] = ss_case(torch, np, name, card)
    out["launches"] = {"decode_attention": sum(out[n][dt]["launches"] for n in cases
                                               for dt in SS_DTYPES)}
    out["phase_s"] = time.perf_counter() - t0
    for name in cases:
        v = out[name]
        for dt in SS_DTYPES:
            w = v[dt]
            print(f"small-serve ({name}, {dt}): {v['arch']} {w['layers']} layers on "
                  f"{tuple(v['mesh'])} ({v['backend']}), decode step "
                  f"{w['step_ms_unsharded']:.2f} ms unsharded, {w['step_ms']:.2f} ms sharded; "
                  f"logit err {w['max_abs_logit_err']:.3e} of {w['ref_max_abs_logit']:.3e}, "
                  f"agreement {w['agreement']:.3f} ({w['near_ties']} differ) | {card}")
    print(f"small-serve phase: {out['phase_s']:.1f} s")
    return out


# --- phases 21 and 22: the sharded train step ---

SHARD_TRAIN_ARCH = "tinyllama-1.1b"
SHARD_TRAIN_LAYERS = 2   # 4 until phase 23 came: the script's time limit
SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ = 4, 256   # every case's global batch
SHARD_TRAIN_STEPS = 2           # fp32 steps held against one card
SHARD_BF16_STEPS = 5
SHARD_LOSS_RTOL, SHARD_GNORM_RTOL, SHARD_LEAF_TOL = 1e-5, 1e-4, 1e-4
SHARD_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
# the bf16 run: SHARD_BF16_STEPS steps on one batch, the learning rate
# warming up from 3e-6 (at full width AdamW's first sign-like steps at 1.5e-4
# and 3e-4 raise the loss, on one card as sharded, fp32 and bf16 alike:
# tools/train_schedule_check.py)
SHARD_BF16_OPT = dict(lr=3e-4, warmup_steps=100, total_steps=1000)
# A case: arch at full width (reduced: its reduced config); mesh (data,
# model); layers (None: all of them); fields replaced in its config; opt, the fp32 steps' schedule;
# bf16: then SHARD_BF16_STEPS bf16 steps on one batch; compress: then
# `allreduce_compressed` of the last fp32 step's embedding, final norm and
# head gradients over `data`.
# Phase 21: (a) KV heads (4) cut over 2 model ranks, d_model over 2 data
# ranks; (b) 4 KV heads do not cut over 8 model ranks: head_dim is cut, and
# the 4 rows are padded to 8 for attention's batch-DP layout
# each case's max_memory_allocated a rank (bytes, rank order) on the tree
# before the carry between blocks was cut over `model` and the loss stopped
# gathering its logits over the vocab
PHASE21_PEAK_BEFORE = {"a": [1693405184, 1692356608, 1694453760, 1692356608],
                       "b": [1211302912] * 8}
PHASE21_PEAK_ORIGIN = "phase 21 of the tree before, NVIDIA H100 80GB HBM3, 700.00 W"
SHARD_TRAIN_CASES = {
    "a": dict(arch=SHARD_TRAIN_ARCH, mesh=(2, 2), layers=SHARD_TRAIN_LAYERS, opt=SHARD_OPT,
              bf16=True, compress=True),
    "b": dict(arch=SHARD_TRAIN_ARCH, mesh=(1, 8), layers=SHARD_TRAIN_LAYERS, opt=SHARD_OPT)}
# Phase 22: (a) moonshot at full width, its dense first layer and one MoE
# layer, 64 experts over 2 data ranks (expert parallel); (b) mamba2 at full
# width, FAM_TRAIN_MAMBA_LAYERS of its 48 layers; (c) whisper-base whole (6
# encoder and 6 decoder layers, 1,500 audio frames); (d-mixtral) the
# weight-gather MoE at full width: one layer, 3 experts, which 2 data ranks
# do not divide, so their d_model of 6,144 is cut over `data` and gathered
# a leaf at a time (1.40 B parameters, 22.3 GB of fp32 state and gradients
# on one card; 8 experts would be 2.91 B); (d-jamba) the hybrid, reduced:
# one block of 8 layers (attention, SSM, MoE, MLP), 4 experts over 2 data
# ranks. At full width the body comes only in whole blocks of 8, and even
# at 2 experts, the fewest that 2 data ranks divide and top-2 routing
# takes, that is 3.41 B parameters, 54.5 GB of fp32 state and gradients on
# one card before activations (moonshot's 1.34 B peak 11 GB above theirs),
# then four ranks of 13.6 GB each, with 2.0 B parameters of FSDP leaves
# through gloo's host staging (moonshot's 0.79 B take 10.9 s a step)
FAM_TRAIN_MAMBA_LAYERS = 8
# the fp32 steps: phase 21's schedule at lr 1e-4, as the CPU tests take it.
# AdamW moves a weight whose gradient is near 0 by about lr in either
# direction, so the ulps of the first step's gradients move the second
# step's: at phase 21's 3e-4 reduced jamba's second-step wi_up gradient
# drifted 1.279e-04 of its max abs from one card's on an H100, its first
# step within 4.9e-06
FAM_TRAIN_OPT = dict(SHARD_OPT, lr=1e-4)
FAM_TRAIN_CASES = {
    "a": dict(arch="moonshot-v1-16b-a3b", mesh=(2, 2), layers=2, opt=FAM_TRAIN_OPT, bf16=True),
    "b": dict(arch="mamba2-370m", mesh=(2, 2), layers=FAM_TRAIN_MAMBA_LAYERS, opt=FAM_TRAIN_OPT),
    "c": dict(arch="whisper-base", mesh=(2, 2), opt=FAM_TRAIN_OPT),
    "d-mixtral": dict(arch="mixtral-8x22b", mesh=(2, 2), layers=1, fields=dict(n_experts=3),
                      opt=FAM_TRAIN_OPT),
    "d-jamba": dict(arch="jamba-v0.1-52b", mesh=(2, 2), reduced=True, opt=FAM_TRAIN_OPT)}


def train_case_config(case, dtype):
    """A case's config in `dtype`, remat on. At fp32 (the comparison with
    one card) an MoE's capacity factor is E / top_k, so no choice drops in
    the ranks' local groups or one card's, and the router loss weighs 0: a
    mesh's is the mean of the data ranks' losses over their own tokens, one
    card's is over all of them (both packages route so); the bf16 run keeps
    the config's own capacity and router loss."""
    from repro_torch.configs import get_config, reduced

    cfg = (reduced if case.get("reduced") else get_config)(case["arch"])
    cfg = dataclasses.replace(cfg, **case.get("fields", {}))
    cfg = dataclasses.replace(cfg, n_layers=case.get("layers") or cfg.n_layers, dtype=dtype,
                              remat=True)
    if dtype == "float32" and cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k,
                                  router_aux_weight=0.0)
    return cfg


def train_case_batches(np, cfg, dtype):
    """A run's global batches (rank 0's seeded stream, with its stub audio
    frames for an encoder-decoder): SHARD_TRAIN_STEPS at fp32, the first
    SHARD_BF16_STEPS times at bf16."""
    from repro_torch.data.pipeline import DataConfig, batch_iterator

    it = batch_iterator(cfg, DataConfig(SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ, seed=0), rank=0)
    if dtype == "float32":
        return [next(it) for _ in range(SHARD_TRAIN_STEPS)]
    return [next(it)] * SHARD_BF16_STEPS


def train_case_runs(case):
    """(dtype, optimizer settings) of a case's runs: fp32 at its opt, then
    bf16 at SHARD_BF16_OPT where it asks for one."""
    runs = [("float32", case["opt"])]
    return runs + [("bfloat16", SHARD_BF16_OPT)] if case.get("bf16") else runs


def st_capture(steps):
    """Wrap steps.adamw_update so that each call's gradients (the fp32
    tree AdamW is handed) are kept; returns the list they go to."""
    seen = []
    update = steps.adamw_update

    def capture(params, grads, opt, oc, cut=None):
        seen.append(grads)
        return update(params, grads, opt, oc, cut)

    steps.adamw_update = capture
    return seen


def train_one_card(torch, np, name, case, ref_dir):
    """One card: a case's runs of `make_train_step` (one microbatch) from
    the seed-0 state, the fp32 steps' gradients saved to ref_dir with each
    leaf's max abs. Returns each run's metrics and wall ms, its parameter
    count and peak bytes."""
    from repro_torch.core import steps
    from repro_torch.models.params import leaves
    from repro_torch.training.optimizer import OptConfig

    out = {}
    for dtype, opt in train_case_runs(case):
        cfg = train_case_config(case, dtype)
        torch.cuda.reset_peak_memory_stats()
        state = steps.init_train_state(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        step = steps.make_train_step(cfg, OptConfig(**opt), microbatches=1)
        update = steps.adamw_update
        seen = st_capture(steps) if dtype == "float32" else []
        metrics, walls = [], []
        try:
            for i, batch in enumerate(train_case_batches(np, cfg, dtype)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
                if seen:
                    grads = dict(leaves(seen.pop()))
                    torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                                "max_abs": {k: float(v.abs().max()) for k, v in grads.items()}},
                               os.path.join(ref_dir, f"{name}-grads{i}.pt"))
                    del grads
        finally:
            steps.adamw_update = update
        out[dtype] = dict(metrics=metrics, step_ms=walls,
                          params=sum(t.numel() for _, t in leaves(state["params"])),
                          peak_bytes=torch.cuda.max_memory_allocated())
        del state, step
        torch.cuda.empty_cache()
    return out


def compress_check(torch, grads, sizes) -> dict:
    """`allreduce_compressed` of the embedding, final norm and head
    gradients over `data`, against the plain formula on the data ranks'
    gathered int8 values and scales, bit for bit."""
    from repro_torch.distributed import ctx as dctx
    from repro_torch.training.grad_compression import (allreduce_compressed,
                                                        compress_grads, init_error_state)

    grads = {k: v for k, v in grads.items() if k != "body"}   # embed, final_ln, lm_head
    err = init_error_state(grads)
    avg, new_err = allreduce_compressed(grads, err, ("data",))
    qs, ss, errs = compress_grads(grads, err)
    same = True
    for k in sorted(grads):
        q = dctx.gather(qs[k].to(torch.int32)[None], 0, ("data",))
        s = dctx.gather(ss[k].reshape(1), 0, ("data",))
        want = q.sum(0).to(torch.float32) * s.max() / sizes["data"]
        same = same and torch.equal(avg[k], want) and torch.equal(new_err[k], errs[k])
    return dict(bit_equal=bool(same), leaves=sorted(grads),
                elements=sum(int(v.numel()) for v in grads.values()))


def train_case_run(torch, np, name, case, dtype, opt, mesh, ref_dir) -> dict:
    """One run of a case on this rank: its cut of the seed-0 state, drawn
    leaf by leaf on the card; the sharded steps on its rows; at fp32 each
    step's gradients, the rank's cut of every leaf as it hands them to
    AdamW, held against the same cut of the one-card step's (read from the
    saved file, mapped), each leaf's error over the whole leaf's max abs:
    every element is held on the ranks that hold it, with no collective;
    then `compress_check` where the case asks for it. Returns plain data,
    the worst leaf a step."""
    from torch.distributed.tensor import Shard

    from repro_torch.core import steps
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.params import leaves, param_specs
    from repro_torch.training.optimizer import OptConfig

    t_run = time.perf_counter()
    cfg = train_case_config(case, dtype)
    coord = list(mesh.get_coordinate())
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    placements = dict(leaves(steps.train_state_shardings(cfg, mesh)["params"]))
    expected = sum(spec.numel() * 4 // math.prod(sizes[a] for a, p in
                                                   zip(sizes, placements[path])
                                                   if isinstance(p, Shard))
                   for path, spec in leaves(param_specs(cfg)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_sharded_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                                           "cuda", mesh)
    out = {"bytes": {k: sum(t.numel() * t.element_size() for _, t in leaves(tree))
                     for k, tree in (("params", state["params"]), ("mu", state["opt"]["mu"]),
                                     ("nu", state["opt"]["nu"]))},
           "expected_bytes": expected,
           "attn_dp_axes": list(steps._train_cfg(cfg, mesh, SHARD_TRAIN_BATCH).attn_dp_axes)}
    step = steps.make_sharded_train_step(cfg, mesh, OptConfig(**opt), microbatches=1)
    update = steps.adamw_update
    seen = st_capture(steps) if dtype == "float32" else []
    metrics, walls, leaf_err = [], [], []
    try:
        for i, batch in enumerate(train_case_batches(np, cfg, dtype)):
            local = {k: v.cuda() for k, v in steps.shard_train_batch(batch, mesh).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, local)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if not seen:
                continue
            grads = seen.pop()
            ref = torch.load(os.path.join(ref_dir, f"{name}-grads{i}.pt"), mmap=True)
            worst = (0.0, "")
            for path, g in leaves(grads):
                want = shd.local_shard(ref["grads"][path], placements[path], mesh, coord).cuda()
                err = float((g - want).abs().max()) / max(ref["max_abs"][path], 1e-30)
                if not torch.isfinite(g).all():
                    err = float("inf")
                worst = max(worst, (err, path))
                del want
            leaf_err.append(worst)
            del ref
    finally:
        steps.adamw_update = update
    out.update(metrics=metrics, step_ms=walls, leaf_err=leaf_err,
               peak_bytes=torch.cuda.max_memory_allocated(),
               run_s=time.perf_counter() - t_run)
    if dtype == "float32" and case.get("compress"):
        with dctx.mesh_context(mesh):
            out["compress"] = compress_check(torch, grads, sizes)
    del state, step, seen
    torch.cuda.empty_cache()
    return out


def train_cases_rank(rank, world, backend, shape, cases, ref_dir):
    """One rank of a mesh: every case's runs in turn (`train_case_run`)."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    out = {"rank": rank, "backend": backend, "coord": list(mesh.get_coordinate())}
    for name, case in cases.items():
        out[name] = {dtype: train_case_run(torch, np, name, case, dtype, opt, mesh, ref_dir)
                     for dtype, opt in train_case_runs(case)}
    return out


def train_case_check(np, label, name, case, ranks, ref, card) -> dict:
    """The gates of one case against its one-card runs `ref`: the fp32
    loss and grad_norm of every rank, the worst gradient leaf over all
    ranks, each rank's master and moment bytes its share of every cut leaf,
    attention's batch-DP over every mesh axis, and where the case asks for
    them losses that fall in the bf16 run and `allreduce_compressed` bit
    for bit."""
    want = ref["float32"]["metrics"]
    runs = [r[name]["float32"] for r in ranks]
    for r, got in zip(ranks, runs):
        where = f"{label} ({name}) rank {r['rank']} {tuple(r['coord'])}"
        for i, (m, w) in enumerate(zip(got["metrics"], want)):
            loss_rel = abs(m["loss"] - w["loss"]) / abs(w["loss"])
            gnorm_rel = abs(m["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
            if not (loss_rel <= SHARD_LOSS_RTOL and gnorm_rel <= SHARD_GNORM_RTOL):
                fail(f"{where} step {i}: loss {m['loss']} vs one card {w['loss']} (rel "
                     f"{loss_rel:.2e}, tolerance {SHARD_LOSS_RTOL}), grad_norm "
                     f"{m['grad_norm']} vs {w['grad_norm']} (rel {gnorm_rel:.2e}, "
                     f"tolerance {SHARD_GNORM_RTOL})")
        for k, b in got["bytes"].items():
            if b != got["expected_bytes"]:
                fail(f"{where}: {b} {k} bytes, not its share of every cut leaf plus the "
                     f"replicated ones ({got['expected_bytes']})")
        if got["attn_dp_axes"] != ["data", "model"]:
            fail(f"{where}: attn_dp_axes {got['attn_dp_axes']}, not every mesh axis")
        if case.get("compress") and not got["compress"]["bit_equal"]:
            fail(f"{where}: allreduce_compressed over the data axis differs from the formula "
                 f"on the gathered int8 values and scales")
    leaf_err = [max(step) for step in zip(*(got["leaf_err"] for got in runs))]
    for i, (err, path) in enumerate(leaf_err):
        if not err <= SHARD_LEAF_TOL:
            fail(f"{label} ({name}) step {i}: gradient {path} differs from one card's by "
                 f"{err:.3e} of its max abs (tolerance {SHARD_LEAF_TOL})")
    r0 = runs[0]
    out = dict(arch=case["arch"], width="reduced" if case.get("reduced") else "full",
               fields=case.get("fields", {}),
               layers=train_case_config(case, "float32").n_layers, mesh=list(case["mesh"]),
               backend=ranks[0]["backend"], world=len(ranks),
               batch=[SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ], params=ref["float32"]["params"],
               attn_dp_axes=r0["attn_dp_axes"],
               loss=[m["loss"] for m in r0["metrics"]], loss_one_card=[w["loss"] for w in want],
               loss_rel_err=max(abs(m["loss"] - w["loss"]) / abs(w["loss"])
                                for got in runs for m, w in zip(got["metrics"], want)),
               grad_norm_rel_err=max(abs(m["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                                     for got in runs for m, w in zip(got["metrics"], want)),
               worst_leaf_rel_err=max(leaf_err)[0], worst_leaf=max(leaf_err)[1],
               leaf_err_by_step=leaf_err,
               rank_master_bytes=[got["bytes"]["params"] for got in runs],
               rank_moment_bytes=[got["bytes"]["mu"] for got in runs],
               peak_bytes=[got["peak_bytes"] for got in runs],
               peak_bytes_one_card=ref["float32"]["peak_bytes"],
               step_ms=float(np.median([w for got in runs for w in got["step_ms"][1:]])),
               step_ms_one_card=float(np.median(ref["float32"]["step_ms"][1:])),
               ranks_run_s=max(got["run_s"] for got in runs), card=card)
    if case.get("compress"):
        out["compress"] = r0["compress"]
    if case.get("bf16"):
        losses = [m["loss"] for m in ranks[0][name]["bfloat16"]["metrics"]]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"{label} ({name}) bf16: the losses {losses} do not fall")
        one = ref["bfloat16"]
        out.update(bf16_losses=losses, bf16_losses_one_card=[m["loss"] for m in one["metrics"]],
                   bf16_step_ms=float(np.median(ranks[0][name]["bfloat16"]["step_ms"][1:])),
                   bf16_step_ms_one_card=float(np.median(one["step_ms"][1:])),
                   bf16_peak_bytes=[r[name]["bfloat16"]["peak_bytes"] for r in ranks],
                   bf16_ranks_run_s=max(r[name]["bfloat16"]["run_s"] for r in ranks))
    print(f"{label} ({name}): " + json.dumps(out))
    return out


def train_cases(torch, np, card, cases, label) -> dict:
    """The sharded train step of each case on spawned ranks that share the
    card (gloo), one spawn a mesh for all of its cases, each against the
    one-card train step from the same weights on the same batches: the
    one-card runs first, in this process, then the spawns."""
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    out = {"ranks_wall_s": {}}
    with tempfile.TemporaryDirectory() as ref_dir:
        ref = {n: train_one_card(torch, np, n, c, ref_dir) for n, c in cases.items()}
        out["one_card_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        for shape in dict.fromkeys(c["mesh"] for c in cases.values()):
            mine = {n: c for n, c in cases.items() if c["mesh"] == shape}
            ts = time.perf_counter()
            ranks = run_ranks(train_cases_rank, math.prod(shape), (shape, mine, ref_dir),
                              device="cuda", timeout=900)
            out["ranks_wall_s"]["x".join(map(str, shape))] = time.perf_counter() - ts
            for n, c in mine.items():
                out[n] = train_case_check(np, label, n, c, ranks, ref[n], card)
    out["phase_s"] = time.perf_counter() - t0
    for n in cases:
        v = out[n]
        print(f"{label} ({n}): {v['arch']} {v['width']} width {v['fields']}, {v['layers']} "
              f"layers, {v['params'] / 1e9:.3f} B params, batch {v['batch'][0]} x "
              f"{v['batch'][1]}, mesh {tuple(v['mesh'])} ({v['backend']}), fp32 step "
              f"{v['step_ms']:.1f} ms vs {v['step_ms_one_card']:.1f} ms on one card, loss rel "
              f"{v['loss_rel_err']:.2e}, grad_norm rel {v['grad_norm_rel_err']:.2e}, worst "
              f"leaf {v['worst_leaf_rel_err']:.2e} ({v['worst_leaf']}), master "
              f"{max(v['rank_master_bytes']) / 2**30:.3f} GiB and peak "
              f"{max(v['peak_bytes']) / 2**30:.2f} GiB a rank (one card peak "
              f"{v['peak_bytes_one_card'] / 2**30:.2f} GiB) | {card}")
        if "bf16_losses" in v:
            print(f"{label} ({n}, bf16): losses {['%.4f' % x for x in v['bf16_losses']]} vs "
                  f"one card {['%.4f' % x for x in v['bf16_losses_one_card']]}, step "
                  f"{v['bf16_step_ms']:.1f} ms vs {v['bf16_step_ms_one_card']:.1f} ms | {card}")
        if "compress" in v:
            print(f"{label} ({n}): allreduce_compressed bit for bit: "
                  f"{v['compress']['bit_equal']} | {card}")
    print(f"{label} phase: {out['phase_s']:.1f} s (one card {out['one_card_s']:.1f} s, ranks "
          + ", ".join(f"{k} {s:.1f} s" for k, s in out["ranks_wall_s"].items()) + ")")
    return out


def sharded_train_phase(torch, np, card, cases=None) -> dict:
    """Phase 21: full-width tinyllama-1.1b at SHARD_TRAIN_LAYERS layers
    trained sharded on each mesh of SHARD_TRAIN_CASES (or the names in
    `cases`), against the one-card train step (`train_cases`); each rank's
    max_memory_allocated printed beside PHASE21_PEAK_BEFORE's."""
    out = train_cases(torch, np, card, {n: SHARD_TRAIN_CASES[n]
                                        for n in cases or SHARD_TRAIN_CASES},
                      "sharded training")
    for n in cases or SHARD_TRAIN_CASES:
        print(f"sharded training ({n}): max_memory_allocated a rank {out[n]['peak_bytes']} "
              f"bytes; before the carry cut and the vocab-cut loss "
              f"{PHASE21_PEAK_BEFORE[n]} ({PHASE21_PEAK_ORIGIN}) | {card}")
    return out


def sharded_families_train_phase(torch, np, card, cases=None) -> dict:
    """Phase 22: the sharded train step of the MoE, SSM, hybrid and
    encoder-decoder families (FAM_TRAIN_CASES, or the names in `cases`),
    against the one-card train step (`train_cases`)."""
    return train_cases(torch, np, card, {n: FAM_TRAIN_CASES[n]
                                         for n in cases or FAM_TRAIN_CASES},
                       "sharded family training")


# ---------------------------------------------------------------------------
# 23. the GPipe pipeline and the dry-run tooling
# ---------------------------------------------------------------------------

PIPE_ARCH = "tinyllama-1.1b"
PIPE_STAGES, PIPE_LAYERS, PIPE_MICRO, PIPE_SEQ = 4, 8, 8, 512   # 2 layers a stage
PIPE_GRAD_TOL = 1e-6   # a stage's gradient leaf: max abs difference over its max abs
PIPE_DTYPES = ("float32", "bfloat16")
# (arch, shape, multi_pod, gated)
DRYRUN_CELLS = [("tinyllama-1.1b", "train_4k", False, True),
                ("tinyllama-1.1b", "decode_32k", False, True),
                ("tinyllama-1.1b", "train_4k", True, True),
                ("moonshot-v1-16b-a3b", "decode_32k", True, False)]
COUNT_TRAIN = (4, 2048)     # phase 17's batch x sequence
COUNT_DECODE = (8, 2048)    # rows x cache slots
COUNT_TRAIN_STEPS, COUNT_DECODE_STEPS = 3, 10


def pipe_inputs(torch):
    """(cfg, every stage's layers stacked [stages, layers a stage, ...],
    microbatches [micro, 1, seq, d_model], r of their shape), in fp32:
    full-width tinyllama-1.1b cut to PIPE_LAYERS layers, its seed-0 layer
    weights drawn on the card (the body's leaves come first in the draw
    order, so the rest is not drawn), inputs from seeds 1 and 2."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import _set, iter_params, tree_map

    cfg = dataclasses.replace(get_config(PIPE_ARCH), n_layers=PIPE_LAYERS)
    per = PIPE_LAYERS // PIPE_STAGES
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    params = {}
    for path, t in iter_params(cfg, gen(0), "cuda", "float32"):
        if not path.startswith("body."):
            break
        _set(params, path, t)
    stacked = tree_map(lambda *ls: torch.stack(ls).reshape((PIPE_STAGES, per) + ls[0].shape),
                       *lm._layers(cfg, params))
    shape = (PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model)
    mbs = torch.randn(shape, generator=gen(1), device="cuda")
    r = torch.randn(shape, generator=gen(2), device="cuda")
    return cfg, stacked, mbs, r


def pipe_stage_fn(cfg):
    """A stage: its layers (the leading dim of each leaf) in turn."""
    from repro_torch.models import lm
    from repro_torch.models.params import tree_map

    kind = cfg.layer_kinds()[0]

    def stage_fn(sub, x):
        for i in range(PIPE_LAYERS // PIPE_STAGES):
            x, _, _ = lm._sublayer(x, tree_map(lambda t: t[i], sub), None, cfg, kind,
                                   train=True, cache_len=0, pos_offset=None)
        return x

    return stage_fn


def pipe_rank(rank, world, backend, ref_dir):
    """One stage of phase 23 (a): the pipeline's outputs against one card's
    (saved by the parent in `ref_dir`), and at fp32 its stage's weight
    gradients of sum(out * r) against one card's. Each dtype's timed run
    follows a warm-up on one microbatch. Returns plain data."""
    import torch

    from repro_torch.distributed import pipeline as pp
    from repro_torch.models.params import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pp.make_pipe_mesh(world)
    stage = mesh.get_local_rank("pipe")
    cfg, stacked, mbs32, r = pipe_inputs(torch)
    mine32 = pp.stage_params(stacked, mesh)
    del stacked
    out = {"backend": backend, "stage": stage}
    for dtype in PIPE_DTYPES:
        dt, grad = getattr(torch, dtype), dtype == "float32"
        mine = tree_map(lambda t: t.detach().to(dt).requires_grad_(grad), mine32)
        mbs, fn = mbs32.to(dt), pipe_stage_fn(dataclasses.replace(cfg, dtype=dtype))
        with torch.no_grad():
            pp.pipeline_apply(fn, mine, mbs[:1], mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pp.pipeline_apply(fn, mine, mbs, mesh)
        torch.cuda.synchronize()
        out[f"{dtype}_wall_s"] = time.perf_counter() - t0
        want = torch.load(os.path.join(ref_dir, f"{dtype}_out.pt"), map_location="cuda")
        out[f"{dtype}_equal"] = bool(torch.equal(y, want))
        out[f"{dtype}_max_abs_err"] = float((y.detach().float() - want.float()).abs().max())
        if grad:
            (y * r).sum().backward()
            ref = torch.load(os.path.join(ref_dir, "grads.pt"), mmap=True)
            worst, where = 0.0, ""
            for path, p in leaves(mine):
                g = ref[path][stage].to("cuda")
                err = float((p.grad - g).abs().max() / g.abs().max())
                if err >= worst:
                    worst, where = err, path
            out["grad_rel_err"], out["grad_worst_leaf"] = worst, where
        del mine, y, mbs
        torch.cuda.empty_cache()
    return out


def pipeline_check(torch, card) -> dict:
    """Phase 23 (a): one card's reference in this process (outputs of both
    dtypes and the fp32 gradients, saved to a temporary directory), then
    the pipeline on PIPE_STAGES spawned ranks."""
    import tempfile

    from repro_torch.distributed.pipeline import bubble_fraction
    from repro_torch.launch.mesh import backend_for, run_ranks
    from repro_torch.models.params import leaves, tree_map

    out = {"stages": PIPE_STAGES, "layers": PIPE_LAYERS, "micro": PIPE_MICRO,
           "microbatch": [1, PIPE_SEQ], "bubble_fraction": bubble_fraction(PIPE_STAGES,
                                                                          PIPE_MICRO)}
    with tempfile.TemporaryDirectory() as ref_dir:
        cfg, stacked32, mbs32, r = pipe_inputs(torch)
        for dtype in PIPE_DTYPES:
            dt, grad = getattr(torch, dtype), dtype == "float32"
            stacked = tree_map(lambda t: t.detach().to(dt).requires_grad_(grad), stacked32)
            mbs, fn = mbs32.to(dt), pipe_stage_fn(dataclasses.replace(cfg, dtype=dtype))

            def one_card(mbs):
                ys = []
                for mb in mbs:
                    for s in range(PIPE_STAGES):
                        mb = fn(tree_map(lambda t: t[s], stacked), mb)
                    ys.append(mb)
                return torch.stack(ys)

            with torch.no_grad():
                one_card(mbs[:1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = one_card(mbs)
            torch.cuda.synchronize()
            out[f"{dtype}_one_card_wall_s"] = time.perf_counter() - t0
            torch.save(y.detach(), os.path.join(ref_dir, f"{dtype}_out.pt"))
            if grad:
                (y * r).sum().backward()
                torch.save({path: p.grad for path, p in leaves(stacked)},
                           os.path.join(ref_dir, "grads.pt"))
            del stacked, mbs, y
            torch.cuda.empty_cache()
        del stacked32, mbs32, r
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks(pipe_rank, PIPE_STAGES, (ref_dir,), device="cuda", timeout=600)
        out["ranks_wall_s"] = time.perf_counter() - t0
    out["backend"] = backend_for("cuda", PIPE_STAGES)
    steps_n = PIPE_MICRO + PIPE_STAGES - 1
    for dtype in PIPE_DTYPES:
        if not all(rk[f"{dtype}_equal"] for rk in ranks):
            fail(f"pipeline ({dtype}): outputs differ from one card's, max abs "
                 f"{max(rk[f'{dtype}_max_abs_err'] for rk in ranks):.3e}")
        wall = max(rk[f"{dtype}_wall_s"] for rk in ranks)
        out[f"{dtype}_wall_s"] = wall
        out[f"{dtype}_ms_a_step"] = 1e3 * wall / steps_n
    worst = max(ranks, key=lambda rk: rk["grad_rel_err"])
    out["grad_rel_err"], out["grad_worst_leaf"] = worst["grad_rel_err"], (
        f"stage {worst['stage']} {worst['grad_worst_leaf']}")
    if not out["grad_rel_err"] <= PIPE_GRAD_TOL:
        fail(f"pipeline: a stage's gradient is {out['grad_rel_err']:.3e} of its max abs from "
             f"one card's ({out['grad_worst_leaf']}), over {PIPE_GRAD_TOL}")
    print(f"pipeline: {PIPE_ARCH} full width, {PIPE_LAYERS} layers as {PIPE_STAGES} stages "
          f"({out['backend']}), {PIPE_MICRO} microbatches of [1, {PIPE_SEQ}, {cfg.d_model}]: "
          f"outputs equal one card's in fp32 and bf16; fp32 gradients within "
          f"{out['grad_rel_err']:.2e} of their max abs ({out['grad_worst_leaf']}); bubble "
          f"fraction {out['bubble_fraction']:.4f}; {steps_n} schedule steps, fp32 "
          f"{out['float32_ms_a_step']:.1f} ms a step ({1e3 * out['float32_wall_s']:.1f} ms "
          f"against {1e3 * out['float32_one_card_wall_s']:.1f} ms on one card), bf16 "
          f"{out['bfloat16_ms_a_step']:.1f} ms a step ({1e3 * out['bfloat16_wall_s']:.1f} ms "
          f"against {1e3 * out['bfloat16_one_card_wall_s']:.1f} ms) | {card}")
    return out


def dryrun_start(out_dir, cells):
    """Phase 23 (b), started: one subprocess (on the CPU) runs each cell of
    `cells` ((arch, shape, multi_pod, ...) each, run once) through
    launch/dryrun.run_cell."""
    cells = list(dict.fromkeys((a, s, m) for a, s, m, *_ in cells))
    code = ("import json, pathlib, sys; from repro_torch.launch.dryrun import run_cell; "
            f"[run_cell(a, s, m, pathlib.Path({str(out_dir)!r}), force=True) "
            f"for a, s, m in {cells!r}]")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def dryrun_records(proc, out_dir, cells):
    """The records of `dryrun_start`'s subprocess, once it ends: {cell id:
    record} for each (arch, shape, multi_pod, ...) of `cells`."""
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    if proc.returncode != 0:
        fail(f"dryrun: the subprocess failed ({proc.returncode}): {err[-2000:]}")
    out = {}
    for arch, shape, multi, *_ in cells:
        cell = f"{arch}__{shape}__{'pod2x16x16' if multi else 'pod16x16'}"
        out[cell] = json.loads((Path(out_dir) / f"{cell}.json").read_text())
    return out


def dryrun_check(recs, card) -> dict:
    """Phase 23 (b), read: each DRYRUN_CELLS record of `recs`; the gated
    ones must be ok with the JAX package's record keys (but compile_s)."""
    ref = json.loads((ROOT / "results/dryrun/tinyllama-1.1b__train_4k__pod16x16.json")
                     .read_text())
    out = {}
    for arch, shape, multi, gated in DRYRUN_CELLS:
        cell = f"{arch}__{shape}__{'pod2x16x16' if multi else 'pod16x16'}"
        out[cell] = rec = recs[cell]
        if rec["status"] != "ok":
            if gated:
                fail(f"dryrun: {cell} is {rec['status']}: {rec.get('error', '')[:500]}")
            print(f"dryrun {cell}: {rec['status']} ({rec.get('error', '')[:300]}) | {card}")
            continue
        if gated and not (set(ref) - {"compile_s"} <= set(rec)
                          and set(ref["roofline"]) <= set(rec["roofline"])
                          and set(ref["memory_analysis"]) == set(rec["memory_analysis"])):
            fail(f"dryrun: {cell}'s record lacks the JAX package's keys")
        r = rec["roofline"]
        print(f"dryrun {cell}: ok in {rec['lower_s']:.1f} s; t_compute {r['t_compute']:.4e} s, "
              f"t_memory {r['t_memory']:.4e} s, t_collective {r['t_collective']:.4e} s "
              f"(logical {r['t_collective_logical']:.4e}), bottleneck {r['bottleneck']}, "
              f"{rec['bytes_per_device'] / 2**30:.2f} GiB a device, wire "
              f"{r['logical_wire_bytes_per_chip'] / 2**30:.3f} GiB logical / "
              f"{r['wire_bytes_per_chip'] / 2**30:.3f} GiB sent a chip, collectives "
              f"{r['collectives']}{'' if gated else ' (not gated)'} | {card}")
    return out


def _nbytes(tree) -> int:
    from repro_torch.models.params import leaves

    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def _timed_steps(torch, fn, n, warmup):
    walls = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            walls.append(time.perf_counter() - t0)
    return 1e3 * float(sorted(walls)[len(walls) // 2])


def count_check(torch, card) -> dict:
    """Phase 23 (c): the lowered train and decode steps of full-width
    tinyllama-1.1b on a 1 x 1 mesh on the card, their counts against the
    real steps: argument bytes exactly, step ms no faster than t_bound."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.models.params import init_params

    cfg = get_config(PIPE_ARCH)
    mesh = make_local_mesh("cuda")   # a world of one in this process
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    b, s = COUNT_TRAIN
    shape = ShapeConfig("train", "train", s, b)
    low = steps.lower_train_step(cfg, shape, mesh)
    cost = low.analyze()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_train_state(cfg, gen(0), "cuda")
    batch = api.make_train_batch(cfg, b, s, gen(1), "cuda")
    real = _nbytes(state) + _nbytes(batch)
    holder = {"state": state}

    def train_step():
        holder["state"], m = low.fn(holder["state"], batch)
        float(m["loss"])

    ms = _timed_steps(torch, train_step, COUNT_TRAIN_STEPS, 1)
    out["train"] = dict(cost=cost, real_argument_bytes=real, ms=ms,
                        peak=torch.cuda.max_memory_allocated())
    del state, holder, batch
    torch.cuda.empty_cache()
    b, s = COUNT_DECODE
    shape = ShapeConfig("decode", "decode", s, b)
    low = steps.lower_decode(cfg, shape, mesh)
    cost = low.analyze()
    torch.cuda.reset_peak_memory_stats()
    params = steps.shard_params(init_params(cfg, gen(0), "cuda", cfg.dtype), cfg, mesh)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen(1), device="cuda",
                         dtype=torch.int32)
    _, cache = steps.sharded_prefill(cfg, mesh, batch=b)(
        params, {"tokens": toks[:, :s - 1], "cache_len": s})
    inputs = {"cache": cache, "tokens": toks[:, s - 1:].clone(),
              "pos": torch.tensor(s - 1, dtype=torch.int32)}
    real = _nbytes(params) + _nbytes(cache) + _nbytes({"t": inputs["tokens"]}) + 4
    ms = _timed_steps(torch, lambda: low.fn(params, inputs), COUNT_DECODE_STEPS, 3)
    out["decode"] = dict(cost=cost, real_argument_bytes=real, ms=ms,
                         peak=torch.cuda.max_memory_allocated())
    del params, cache, inputs
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    for kind, shp in (("train", COUNT_TRAIN), ("decode", COUNT_DECODE)):
        v = out[kind]
        cost = v.pop("cost")
        shape = ShapeConfig(kind, kind, shp[1], shp[0])
        rep = roofline.build_report(cfg, shape, "1x1", 1, cost)
        v.update(argument_bytes=cost.argument_bytes, bytes_per_device=cost.bytes_per_device,
                 dot_flops=cost.dot_flops, t_bound_ms=1e3 * rep.t_bound,
                 bound_by=rep.bottleneck,
                 peak_flop_share=cost.dot_flops / (v["ms"] / 1e3) / roofline.PEAK_FLOPS)
        if v["argument_bytes"] != v["real_argument_bytes"]:
            fail(f"count ({kind}): the lowered step's argument bytes {v['argument_bytes']:.0f} "
                 f"differ from the real step's {v['real_argument_bytes']}")
        if not v["ms"] >= v["t_bound_ms"]:
            fail(f"count ({kind}): the measured step ({v['ms']:.3f} ms) is faster than its "
                 f"roofline bound ({v['t_bound_ms']:.3f} ms): the count is wrong")
        print(f"count ({kind}, {PIPE_ARCH} bf16, {shp[0]} x {shp[1]}, 1 x 1 mesh): argument "
              f"bytes {v['argument_bytes']:.0f} = the real step's; median step "
              f"{v['ms']:.3f} ms >= t_bound {v['t_bound_ms']:.3f} ms ({v['bound_by']}); "
              f"counted dot FLOPs {v['dot_flops']:.4e}, {100 * v['peak_flop_share']:.2f}% of "
              f"the bf16 peak (989 TFLOP/s, data sheet) at the measured step; "
              f"max_memory_allocated {v['peak']} bytes against the count's bytes_per_device "
              f"{v['bytes_per_device']:.0f} | {card}")
    return out


def pipeline_dryrun_phase(torch, card) -> dict:
    """Phase 23: the dry run (b) starts in a subprocess on the CPU (with
    phase 24's memory cells, returned as "memory_cells"), then (a) the
    pipeline and (c) the count against the card run, then (b) is read."""
    import tempfile

    t0 = time.perf_counter()
    cells = DRYRUN_CELLS + MEMORY_CELLS  # phase 24 reads the memory cells
    with tempfile.TemporaryDirectory() as out_dir:
        proc = dryrun_start(out_dir, cells)
        try:
            out = {"pipeline": pipeline_check(torch, card), "count": count_check(torch, card)}
            recs = dryrun_records(proc, out_dir, cells)
        finally:
            proc.kill()
    out["dryrun"] = dryrun_check(recs, card)
    out["memory_cells"] = recs
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# 24. the fleet over every card, each kernel on the last card, the audio example
# ---------------------------------------------------------------------------

# the dry-run cells phase 24 gates on bytes a device (the train step's
# memory in the JAX package's layout): (arch, shape, multi_pod, limit bytes)
MEMORY_CELLS = [("tinyllama-1.1b", "train_4k", False, None),   # 2x the JAX record's
                ("yi-34b", "train_4k", False, 80e9)]            # fits an 80 GB card


def other_card_kernels(torch, np, dev) -> dict:
    """Phase 24 (a): each of the seven kernels once at its serve shape on
    `dev` while cuda:0 stays the current card, through the ops the serve
    path calls, against its plain version on a CPU copy of the same
    inputs at its tolerance; each output must lie on `dev`. These launches
    compare, so the kernels line does not count them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.image_normalize import image_crop_normalize_batch

    rng = np.random.default_rng(24)
    n, length = MAIN_SHAPE
    x = torch.from_numpy(rng.standard_normal((n, length)).astype(np.float32))
    r = ops.audio_resample_batch(x.to(dev), 1, 3)
    m = ops.mel_spectrogram_batch(r)
    nb, h, w = IMAGE_MAIN_SHAPE
    coeffs = torch.from_numpy(np.stack([jpeg_coeffs(np, rng, h // 8, w // 8)
                                        for _ in range(nb)]))
    qt = torch.tensor(QTABLE_K1, dtype=torch.float32)
    imgs = ops.jpeg_decode_batch(coeffs.to(dev), qt.to(dev))
    small = ops.image_resize_batch(imgs, RESIZE_TO, RESIZE_TO)
    B, H, KH, D, S, dt = DECODE_MAIN_SHAPE
    dtype = getattr(torch, dt)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((B, H, D), (B, S, KH, D), (B, S, KH, D)))
    vl = torch.from_numpy(rng.integers(1, S + 1, B).astype(np.int32))
    cases = [  # name, kernel's output on dev, plain version's on the CPU
        ("audio_resample", r, ops.audio_resample_batch(x, 1, 3)),
        ("mel_spectrogram", m, ops.mel_spectrogram_batch(r.cpu())),
        ("audio_normalize", ops.audio_normalize_batch(m), ops.audio_normalize_batch(m.cpu())),
        ("jpeg_idct", imgs, ops.jpeg_decode_batch(coeffs, qt)),
        ("image_resize", small, ops.image_resize_batch(imgs.cpu(), RESIZE_TO, RESIZE_TO)),
        ("image_normalize", image_crop_normalize_batch(small, CROP_TO, CROP_TO, MEAN, STD),
         image_crop_normalize_batch(small.cpu(), CROP_TO, CROP_TO, MEAN, STD)),
        ("decode_attention", ops.decode_attention(q.to(dev), k.to(dev), v.to(dev), vl.to(dev)),
         ops.decode_attention(q, k, v, vl))]
    torch.cuda.synchronize(dev)
    out = {}
    for name, got, want in cases:
        key = f"{name}/{dt}" if name == "decode_attention" else name
        err, rel, ok = errors(torch, key, got.cpu().float(), want.float())
        if got.device != torch.device(dev) or not ok:
            fail(f"{name} on {dev}: output on {got.device}, max abs error {err:.3e} against "
                 f"the plain version (tolerance {TOL[key]})")
        out[name] = dict(max_abs_err=err, max_rel_err=rel)
    if torch.cuda.current_device() != 0:
        fail(f"the kernels on {dev} left cuda:{torch.cuda.current_device()} current")
    print(f"kernels on {dev} (cuda:0 current): " + ", ".join(
        f"{k} {v['max_abs_err']:.2e}" for k, v in out.items()) + " max abs error, each "
        "within its tolerance of the plain version")
    return out


def multi_card_fleet(torch, np, model, ref, card) -> dict:
    """Phase 24 (b): phase 10's fleet (its weights on cuda:0, its requests)
    over every visible card, one slice a card, fed by the DPU service on
    cuda:0, then resized N -> N/2 -> N (two-card slices in the middle,
    each serving on its first card), the same requests served after each
    resize. Gated per round: every request once, 0 shed, 0 dead,
    conservation; every slice's engine admitted one or more; one replica
    of the weights a card (the fleet's map, and each card's allocated
    bytes grew by less than a second copy); tokens equal phase 10's
    single-slice engine's bit for bit per rid; audio launches equal the
    service's groups and decode attention n_layers x the decode steps of
    every engine of the round."""
    from repro_torch import kernels
    from repro_torch.core.dpu.runtime import DpuConfig
    from repro_torch.core.dpu.service import DpuService, DpuServiceConfig
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.runtime import RuntimeConfig, build_pipelined_runtime

    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n)]
    cfg = model.cfg
    weight_bytes = tree_bytes(model.tree())
    alloc0 = [torch.cuda.memory_allocated(d) for d in devices]
    ec = EngineConfig(max_new_tokens=8, continuous=True, max_slots=8, segment_len=8,
                      max_prompt_len=128)
    service = DpuService(DpuServiceConfig(clock="wall", dpu=DpuConfig(backend="dpu")),
                         device="cuda:0")
    rt = build_pipelined_runtime(cfg, n_slices=n, ec=ec, service=service, params=model,
                                 hedge_factor=3.0, device="cuda:0", devices=devices,
                                 rc=RuntimeConfig(clock="wall", max_ingest=64))
    ms = rt.engine
    if [str(e.device) for e in ms.engines.values()] != devices:
        fail(f"multi-card fleet: slices on {[str(e.device) for e in ms.engines.values()]}, "
             f"not one a card of {devices}")

    def drive(reqs):
        t0 = time.monotonic()
        for r in reqs:
            r.arrival += t0
        rt.submit(reqs)
        done = rt.run_until_idle()
        for d in devices:
            torch.cuda.synchronize(d)
        return done, time.monotonic() - t0

    drive(fleet_traffic(np, cfg, n, 98, rid0=50_000))  # warm-up: one request a slice
    rounds, runs = [n, max(1, n // 2), n], []
    for size in rounds:
        if size != len(ms.engines):
            ms.resize(n_slices=size)
        rt.reset_metrics()
        ms.reset_metrics()  # and the generation the resize stashed, whose steps it counts
        groups0 = service.stats["groups"]
        admitted0 = {sid: e.stats["admitted"] for sid, e in ms.engines.items()}
        reqs = fleet_traffic(np, cfg, FLEET_REQUESTS, 2026)
        kernels.reset_launch_counts()              # the fleet's path starts here
        done, wall = drive(reqs)
        launches = kernels.launch_counts()         # ... and ends here
        groups = service.stats["groups"] - groups0
        where = f"multi-card fleet ({size} slices over {n} cards)"
        rids = [r.rid for r in done]
        if len(done) != FLEET_REQUESTS or len(set(rids)) != FLEET_REQUESTS:
            fail(f"{where}: served {len(done)} ({len(set(rids))} distinct) of {FLEET_REQUESTS}")
        if rt.shed or rt.dead or not rt.conservation_ok():
            fail(f"{where}: shed {rt.shed_counts()}, dead {rt.dead_counts()}, conservation "
                 f"{rt.conservation_ok()}")
        check_no_fallback(rt, where)
        idle = [sid for sid, e in ms.engines.items()
                if e.stats["admitted"] - admitted0.get(sid, 0) <= 0]
        if idle:
            fail(f"{where}: slices {idle} admitted no request {ms.slice_stats()}")
        check_fleet_tokens(np, done, ref, where)
        for k in kernels.AUDIO_KERNELS:
            if launches[k] <= 0 or launches[k] != groups:
                fail(f"{k}: {launches[k]} launches on the {where}, the service launched "
                     f"{groups} groups")
        steps = check_decode_launches(launches, cfg, ms, where)
        held = ms.weights_by_device()
        grown = [torch.cuda.memory_allocated(d) - a for d, a in zip(devices, alloc0)]
        if sorted(held) != sorted(set(devices)) \
                or any(set(v) != {cfg.name} for v in held.values()) \
                or any(tree_bytes(v[cfg.name].tree()) != weight_bytes for v in held.values()) \
                or any(g >= weight_bytes + (weight_bytes if d != "cuda:0" else 0)
                       for d, g in zip(devices, grown)):
            fail(f"{where}: weights held {({d: list(v) for d, v in held.items()})}, "
                 f"allocated bytes grown {grown} against {weight_bytes} weight bytes")
        stats = fleet_stats(np, rt, done, wall, launches, steps, card)
        stats.update(groups=groups, cards=n, slice_cards=[str(e.device)
                                                          for e in ms.engines.values()],
                     weight_bytes=weight_bytes, allocated_grown=grown,
                     tokens_equal_single_slice=len(done))
        runs.append(stats)
        print("multi-card fleet: " + json.dumps(stats))
    rt.close()
    launches = {k: sum(st["launches"][k] for st in runs) for k in kernels.KERNELS}
    return {"runs": runs, "launches": launches}


def audio_example_dpu(torch, np, card) -> dict:
    """Phase 24 (c): the real-DPU part of examples/serve_audio_preba_torch.py
    on the card (one 5 s utterance through DPU(backend="dpu"): the three
    audio kernels), its features against the same part on the CPU (the
    plain versions), rtol 1e-3, atol 1e-2; and the example's per-unit
    costs on the card (each unit's whole call on 7.5 s)."""
    import importlib.util

    from repro_torch import kernels

    spec = importlib.util.spec_from_file_location(
        "serve_audio_preba_torch", ROOT / "examples" / "serve_audio_preba_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    kernels.reset_launch_counts()                  # the example's DPU path starts here
    _, feats = ex.real_dpu("cuda")
    launches = kernels.launch_counts()             # ... and ends here
    _, plain = ex.real_dpu("cpu")
    err = float(np.abs(feats - plain).max())
    if feats.shape != plain.shape or not np.isfinite(feats).all() \
            or not np.allclose(feats, plain, rtol=1e-3, atol=1e-2):
        fail(f"audio example: features {feats.shape} differ from the plain versions' "
             f"{plain.shape} (max abs {err:.3e})")
    if any(launches[k] != 1 for k in kernels.AUDIO_KERNELS):
        fail(f"audio example: launches {launches}, one of each audio kernel expected")
    unit_ms = ex.dpu_unit_ms(torch.device("cuda"))
    print(f"audio example: features {feats.shape} within {err:.2e} of the plain versions; "
          f"unit whole-call ms on 7.5 s: {json.dumps(unit_ms)} | {card}")
    return {"launches": launches, "max_abs_err": err, "unit_ms": unit_ms}


def memory_cells_check(recs, card) -> dict:
    """Phase 24 (d): each MEMORY_CELLS record of `recs` (phase 23's dry
    run) with its bytes a device under its limit (tinyllama's: twice the
    JAX package's record)."""
    ref = json.loads((ROOT / "results/dryrun/tinyllama-1.1b__train_4k__pod16x16.json")
                     .read_text())
    out = {}
    for arch, shape, multi, limit in MEMORY_CELLS:
        cell = f"{arch}__{shape}__{'pod2x16x16' if multi else 'pod16x16'}"
        rec = recs[cell]
        limit = 2 * ref["bytes_per_device"] if limit is None else limit
        if rec["status"] != "ok" or not rec["bytes_per_device"] <= limit:
            fail(f"dryrun {cell}: {rec['status']}, {rec.get('bytes_per_device')} bytes a "
                 f"device against {limit:.0f}")
        out[cell] = rec["bytes_per_device"]
        print(f"dryrun {cell}: {rec['bytes_per_device']:.0f} bytes a device "
              f"({rec['bytes_per_device'] / 2**30:.2f} GiB), limit {limit:.0f} | {card}")
    return out


def multi_card_phase(torch, np, card, model=None, ref=None, dry=None) -> dict:
    """Phase 24: (a) the kernels on the last card, (b) the fleet over every
    card on phase 10's weights and reference tokens (`model`, `ref`; drawn
    and served here when phase 10 did not run), (c) the audio example's
    real-DPU part, (d) the memory cells of phase 23's dry run (`dry`, its
    records; run here, in a subprocess beside (a)-(c), when phase 23 did
    not run)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models.api import LM
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.multislice import _seeded_params

    t0 = time.perf_counter()
    if model is None:
        cfg = get_config("tinyllama-1.1b")
        model = LM(cfg, _seeded_params(cfg, 0, torch.device("cuda")))
        ec = EngineConfig(max_new_tokens=8, continuous=True, max_slots=8, segment_len=8,
                          max_prompt_len=128)
        ref = single_slice_tokens(torch, np, cfg, ec, model,
                                  fleet_traffic(np, cfg, FLEET_REQUESTS, 2026))
    with tempfile.TemporaryDirectory() as out_dir:
        proc = None if dry is not None else dryrun_start(out_dir, MEMORY_CELLS)
        try:
            out = {"kernels": other_card_kernels(
                       torch, np, f"cuda:{torch.cuda.device_count() - 1}"),
                   "fleet": multi_card_fleet(torch, np, model, ref, card),
                   "example": audio_example_dpu(torch, np, card)}
            if proc is not None:
                dry = dryrun_records(proc, out_dir, MEMORY_CELLS)
        finally:
            if proc is not None:
                proc.kill()
    out["dryrun"] = memory_cells_check(dry, card)
    out["phase_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the PyTorch package")
    ap.add_argument("--out", default="", help="also write the detailed numbers here (JSON)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import build

    # 1. device
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s -> {build.library_path().name}")
    entry = ""
    for line in build.ptxas_log.splitlines():
        if "Compiling entry function" in line:  # the mangled name, past its file's hash
            entry = line.split("'")[1].split("_cu_")[-1][8:].lstrip("0123456789")
        elif "Used" in line or "spill" in line:
            print(f"  {entry}: {line.split(':', 1)[-1].strip()}")

    phase_s = {}

    def timed(n, fn, *args):
        """fn(*args), its seconds printed and kept under phase n."""
        t = time.perf_counter()
        result = fn(*args)
        phase_s[n] = phase_s.get(n, 0.0) + time.perf_counter() - t
        print(f"phase {n} seconds: {phase_s[n]:.1f}", flush=True)
        return result

    # 3. kernels
    rows = timed(3, kernel_phase, torch, F)

    # 4. serve
    stats, params = timed(4, serve_phase, torch, np)

    # 5. image kernels
    image_rows = timed(5, image_kernel_phase, torch, F, np)

    # 6. image serve, on the same weights
    image_stats = timed(6, image_serve_phase, torch, np, params)

    # 7. decode kernel
    decode_rows = timed(7, decode_kernel_phase, torch, F, np)

    decode_step = timed(7, decode_step_phase, torch, np, params)

    # 8. run-to-completion serve, on the same weights
    rtc_stats = timed(8, rtc_serve_phase, torch, np, params)

    # 9. chunked prefill + prefix cache serve, on the same weights
    chunk_stats = timed(9, chunked_prefix_serve_phase, torch, np, params)

    # 10. the multi-slice fleet, on the same weights
    fleet_stats_, model, fleet_ec, fleet_ref = timed(10, fleet_phase, torch, np, params, card)

    # 11. the same fleet under a fault plan, on the virtual clock
    chaos_stats = timed(11, chaos_phase, torch, np, model, fleet_ec, fleet_ref, card)

    # 12. knee profiles measured on the card
    knee_stats, profiles = timed(12, knee_phase, torch, np, card)

    # 13. the partition controller resizing the fleet, on phase 12's profiles
    controller_stats = timed(13, controller_phase, torch, np, model, profiles, card)

    # 14. PREBA's two-model fleet: tinyllama and mamba2, one admission queue
    mt_stats = timed(14, mt_fleet_phase, torch, np, params, card)

    # 15. the rest of the dense family and the MoE family, full width
    new_stats = timed(15, new_archs_phase, torch, np, card)
    # each arch's audio serve (the first five), then danube's window run
    new_runs = [new_stats[a]["serve"] for a in NEW_ARCH_DEPTH] + [
        new_stats[a]["window_wrap"] for a in NEW_ARCH_DEPTH if "window_wrap" in new_stats[a]]

    # 16. the last three families: jamba, phi-3-vision, whisper, full width
    family_stats = timed(16, families_phase, torch, F, np, card)
    decode_rows += family_stats["kernel_rows"]
    family_serves = [family_stats[a]["serve"] for a in FAMILY_DEPTH
                     if "serve" in family_stats[a]]
    family_runs = family_serves + [family_stats[a][k] for a in FAMILY_DEPTH
                                   for k in ("generate", "image") if k in family_stats[a]]

    # 17. training on the card (tinyllama-1.1b), then serving the trained weights
    train_stats = timed(17, training_phase, torch, np, card)

    # 18. tensor-parallel serving on ranks that share the card
    tp_stats = timed(18, tensor_parallel_phase, torch, F, np, card)
    decode_rows += tp_stats["kernel_rows"]

    # 19. tensor-parallel serving of the MoE, SSM and hybrid families
    fam_tp_stats = timed(19, tp_families_phase, torch, F, np, card)
    decode_rows += fam_tp_stats["kernel_rows"]

    # 20. the small-serve layout: whisper-base and tinyllama-1.1b at 8 layers
    ss_stats = timed(20, small_serve_phase, torch, F, np, card)
    decode_rows += ss_stats["kernel_rows"]

    # 21. the sharded train step: tinyllama-1.1b at 2 layers on two meshes
    st_stats = timed(21, sharded_train_phase, torch, np, card)

    # 22. the sharded train step of the MoE, SSM, hybrid and encoder-decoder families
    ft_stats = timed(22, sharded_families_train_phase, torch, np, card)

    # 23. the GPipe pipeline, the dry run and the count held against the card
    pd_stats = timed(23, pipeline_dryrun_phase, torch, card)

    # 24. phase 10's fleet over every card, the kernels on the last card, the
    # audio example's real DPU part, the train step's memory by the dry run
    mc_stats = timed(24, multi_card_phase, torch, np, card, model, fleet_ref,
                     pd_stats.pop("memory_cells"))
    audio_run = {"launches": {k: sum(st["launches"][k]
                                     for st in (stats, fleet_stats_, chaos_stats,
                                                controller_stats, mt_stats, *new_runs[:5],
                                                *family_serves, mc_stats["fleet"],
                                                mc_stats["example"]))
                              for k in ("audio_resample", "mel_spectrogram",
                                        "audio_normalize")}}
    decode_run = {"launches": {"decode_attention": sum(
        st["launches"]["decode_attention"]
        for st in (stats, image_stats, rtc_stats, chunk_stats, fleet_stats_, chaos_stats,
                   knee_stats, controller_stats, mt_stats, *new_runs, *family_runs,
                   train_stats["serve"], tp_stats, fam_tp_stats, ss_stats,
                   mc_stats["fleet"]))}}

    line = []
    for name, shape_rows, main_of, run in (
            ("audio_resample", rows, lambda r: (r["n"], r["L"]) == MAIN_SHAPE, audio_run),
            ("mel_spectrogram", rows, lambda r: (r["n"], r["L"]) == MAIN_SHAPE, audio_run),
            ("audio_normalize", rows, lambda r: (r["n"], r["L"]) == MAIN_SHAPE, audio_run),
            ("jpeg_idct", image_rows,
             lambda r: (r["n"], r["H"], r["W"]) == IMAGE_MAIN_SHAPE, image_stats),
            ("image_resize", image_rows,
             lambda r: (r["n"], r["H"], r["W"]) == IMAGE_MAIN_SHAPE, image_stats),
            ("image_normalize", image_rows,
             lambda r: (r["n"], r["H"], r["W"]) == IMAGE_MAIN_SHAPE, image_stats),
            ("decode_attention", decode_rows,
             lambda r: ((r["B"], r["H"], r["KH"], r["D"], r["S"], r["dtype"]) == DECODE_MAIN_SHAPE
                        and not r.get("lse")),
             decode_run)):
        mine = [r for r in shape_rows if r["name"] == name]
        main_row = next(r for r in mine if main_of(r))
        # the shape where the kernel does worst against its library call
        worst = max((r for r in mine if r["library_ms"]),
                    key=lambda r: r["ms"] / r["library_ms"], default=None)
        line.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=REPLACES[name], launches=run["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            worst_library_ratio=worst and worst["ms"] / worst["library_ms"],
            worst_library_shape=worst and " ".join(
                f"{k}={v}" for k, v in worst.items() if k in SHAPE_KEYS)))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"card": card, "kernels_by_shape": rows + image_rows + decode_rows,
             "serve": stats, "image_serve": image_stats, "rtc_serve": rtc_stats,
             "chunked_prefix_serve": chunk_stats, "decode_step": decode_step,
             "fleet": fleet_stats_, "chaos": chaos_stats, "knee": knee_stats,
             "controller": controller_stats, "two_model_fleet": mt_stats,
             "new_archs": new_stats,
             "families": {k: v for k, v in family_stats.items() if k != "kernel_rows"},
             "training": train_stats,
             "tensor_parallel": {k: v for k, v in tp_stats.items() if k != "kernel_rows"},
             "tensor_parallel_families": {k: v for k, v in fam_tp_stats.items()
                                          if k != "kernel_rows"},
             "small_serve": {k: v for k, v in ss_stats.items() if k != "kernel_rows"},
             "sharded_training": st_stats, "sharded_family_training": ft_stats,
             "pipeline_dryrun": pd_stats, "multi_card": mc_stats, "phase_s": phase_s},
            indent=1))
    print(json.dumps({"kernels": line}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
