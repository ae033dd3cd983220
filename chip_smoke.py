#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: torch's name for the card, and nvidia-smi's name and power limit;
2. build: every kernel source of the port compiled with nvcc for sm_90a;
3. kernel vs plain: ``flash_attention_fwd`` on the card against its plain
   version at the main path's prefill shapes (smollm, Mixtral's prefill and
   its window run, llama-3b's at head dim 100, qwen2-vl's at d 128 GQA 8,
   whisper's encoder, decoder and cross-attention) and the edge cases
   (``KERNEL_CASES``), each case with its tolerance;
4. serve: full-width smollm-135m (30 layers, d_model 576, bf16, weights made
   from a seed) answers 8 requests of 512 prompt tokens, 32 new tokens each,
   through ``repro_torch.serve.engine.Batcher``.  The launch counts are set to
   0 just before and read just after: the kernel must have run once per layer
   per prefill batch.  Tokens must be < vocab and all logits finite.  In one
   more prefill the kernel's output at each layer must agree with the plain
   version on that layer's inputs, and the last-position logits must agree
   with a prefill whose attention is pinned to the plain variant;
5. times: CUDA events around back-to-back calls after warm-up, medians, for
   the kernel, its plain version, ``F.scaled_dot_product_attention`` (a
   yardstick the port never calls; with a boolean mask where a window
   binds) and the bound, at smollm's, Mixtral's prefill, Mixtral's window
   and llama-3b's (d 100; with the cost of the wrapper's copy of q, k, v
   into padded rows) shapes, and the kernel's and SDPA's device time from a
   CUDA graph replay
   (host clock for prefill, decode and tokens/s in phase 4); the wrapper's
   host time per call; then the card's busy share in prefill and decode
   from a torch.profiler trace;
6. ring kernels vs plain: the fused ring reduce-scatter and all-gather
   (``csrc/ring_dma.cu``) against the plain versions of their schedules,
   and ``collective_reduce`` against its plain version, case by case, bit
   for bit;
7. collectives at full width: ``hetccl.tree_all_reduce`` of a gradient tree
   shaped like full-width smollm-135m (f32, every parameter, 651 MB per
   rank) on a ThreadMesh of ranks sharing the card: (pod=2, data=2) in modes
   hier and pipelined, backends xla and pallas, and hier/pallas with a bf16
   cross stage; (pod=4, data=1) hier.  The counts are set to 0 just before
   the (pod=2, data=2) hier/pallas run and read just after: the fused
   kernels must have run.  Pallas must equal xla bit for bit in f32, and
   both lie close to a float64 sum over ranks.  One more run pins the rings
   to the emulated schedule, whose accumulate launches ``collective_reduce``.
   Then host-clock times (backends in turns) and the card's busy share;
8. times of the collective kernels at the largest bucket's shape, with
   their bounds and library yardsticks (``collective_reduce`` in turns with
   ``torch.add``, 8 rounds, L2 cold before each reading, back to back and
   from a CUDA graph, the spread printed), and each ring kernel's own traffic
   beside its bound: the all-gather's (4n - 3) c elements per rank, the
   reduce-scatter's 3 (n - 1) c (it pulls its upstream's payload; storing
   into a receive slot moved 5 (n - 1) c);
9. codec kernels vs plain: ``quant_int8`` and ``dq_accum_int8``
   (``csrc/quant.cu``) against their plain versions, case by case, bit for
   bit (NaN where NaN), up to the largest leaf (55296 rows of 512);
10. flash backward vs plain: ``flash_attention_bwd``
   (``csrc/flash_attention_bwd.cu``) against its plain version at the
   training shape, at head dim 100, at whisper's three training shapes
   (the cross-attention's Sq 448 against Sk 1500) and qwen2-vl's (1,
   64/8, 4096, 128), two f32 cases with Sq below and above Sk, and the
   edge cases (``BWD_CASES``), each with its limits, and the forward's row
   logsumexp against its plain version;
11. training at full width: ZeRO-1 steps of full-width smollm-135m (bf16
   parameters, f32 master state, weights from a seed) on a ThreadMesh
   (pod=2, data=2), ``uniform_plan(2, 4, micro_batch=2)``, seq 512, one
   memorize batch, in three runs from the same init: ``backend="pallas",
   wire_quant="int8"`` with error feedback (the main path), ``"pallas"``
   without a codec (the fused ring kernels) and ``"xla"``.  The counts are set
   to 0 just before each run and read just after; each kernel must have run
   the times the step implies, and the int8 run's warm-up step launches the
   codec at the rows ``bench_codec.codec_launch_rows`` counts from the
   model's leaves and buckets.  Step-0 loss is the same in all three, losses
   are finite and fall, and the int8 run ends within a stated limit of the
   run without a codec.  Then ms per step (the checked steps), tokens/s, the
   split of a step, the card's busy share and the peak memory;
12. times of the codec kernels at (6912, 512) and at the largest leaf
   (55296, 512), L2 cold before each reading, back to back and replayed
   from CUDA graphs (so the host's time per call is not in them),
   ``torch.addcmul`` in turns with ``dq_accum_int8``, with the bounds, the
   plain versions and the wrappers' host time per call; the codec's card
   time per int8+EF step, launches x graph time over every shape the step
   launches; and the flash backward at the training shape, at d 100 and
   at the shapes of [36] and [37] (``BWD_TIMED``) against SDPA's autograd
   in turns (also from CUDA graphs);
13. grouped matmul vs plain: ``grouped_matmul`` (``csrc/grouped_matmul.cu``)
   against its plain version, case by case (``GMM_CASES``: the sweep shapes
   of tests/test_kernels.py in f32 and bf16, Mixtral's prefill and decode
   shapes, moonshot's expert shape, zero rows, views of stacked weights, the
   wgmma route's ragged edges), each with its limits (``GMM_LIMITS``) and
   the route it took; every route must be reached;
14. MoE serving at full width: mixtral-8x7b (d_model 4096, 8 experts top-2
   of d_ff 14336, window 4096) cut to 8 of its 32 layers, bf16, weights from
   a seed, answers 8 requests of 512 prompt tokens, 32 new tokens each,
   through ``Batcher``; the counts set to 0 just before and read just after:
   3 x 8 x 33 = 792 grouped-matmul launches (the prefill's 24 on the wgmma
   route, decode's 768 on the mma16 decode route), 8 flash.  In one more prefill
   every grouped matmul and every layer's expert FFN against their plain
   versions on the same inputs (the hard gate); then the last-position
   logits against expert_ffn pinned to the plain composition, gated on the
   requests whose routes and drops agree in every layer; tokens/s, prefill
   and decode ms, busy share, peak memory;
15. the sliding window at full width: the same model, 1 request of 4608
   prompt tokens and 16 new: flash with window 4096 at Sq 4608, the rolling
   cache (4096 slots), decode through ``window_decode_attention``, 408
   grouped-matmul launches (24 wgmma, 384 mma16), and the same comparisons
   but the per-layer one;
16. grouped-matmul times at Mixtral's prefill, decode and window-run prefill
   shapes, with the route taken, the plain version, ``torch.bmm`` (a
   yardstick the port never calls; in turns, and at the decode shapes also
   replayed from CUDA graphs) and the bound;
17. SSD kernel vs plain: ``ssd_scan`` (``csrc/ssd_scan.cu``) against its
   plain version case by case (``SSD_CASES``: both models' prefill shapes,
   f32 and bf16, dt near 20, a slow decay in both types, one chunk, chunks
   of 100 and of 32, G = 2 and G = H, an initial state, the kernel's
   layout), y and the final state each within ``SSD_LIMITS``, with the
   route each case took (bf16: ``mma``, f32: ``f32``; both must be
   reached); and the flash forward at head dim 112 (zamba2's shared
   attention) within ``ATTN_LIMITS``;
18. SSM serving at full width and depth: mamba2-2.7b (64 layers, 2.83 B
   parameters, bf16, weights from a seed) answers 8 requests of 2048 prompt
   tokens, 32 new tokens each, through ``Batcher``; the counts set to 0 just
   before and read just after: 64 SSD launches, all on the ``mma`` route, no
   flash.  The SSD states after prefill are f32; in one more prefill every
   layer's SSD against its plain version on that layer's inputs (y and
   final state, the hard gate); the last-position logits against the SSD op
   pinned to its plain variant,
   in bf16 and over the first 2 layers in f32; prefill and decode ms,
   tokens/s, busy shares, peak memory;
19. hybrid serving at full width and depth: zamba2-7b (81 layers: 13 groups
   of 6 and a tail of 3, the shared attention block after each group; 6.75 B
   parameters), the same traffic and checks: 81 SSD and 13 flash launches
   (d 112); the f32 check over the first group and one tail layer;
20. SSD kernel times at both prefill shapes with the plain version and the
   bounds (bytes and bf16 operations; the f32-FMA bound printed beside),
   the route, its shared memory per block and the blocks an SM holds; and
   the flash forward at d 112 with its plain version, SDPA and bound;
21. the dense configs at full width and depth (``DENSE_ARCHS``: gpt-125m,
   gpt-355m, smollm-360m, llama-1b, llama-3b, starcoder2-7b and
   deepseek-coder-33b, 33.3 B parameters in 66.7 GB of bf16, all whole),
   weights from a seed: 8 x 512 prompt tokens + 32 new through ``Batcher``,
   the counts set to 0 just before and read just after (one flash launch
   per layer at the config's head dim: llama-3b's at d 100), tokens in the
   vocab, finite logits; llama-3b's kernel against its plain version on
   each layer's inputs; tokens/s, prefill and decode ms, busy shares, peak
   memory;
22. llama-1b trained at full width at the paper's shape (micro-batch 1 x
   seq 8192 per rank, remat, hier, pallas) on a (pod=2, data=2) ThreadMesh:
   2 ZeRO-3 steps and 2 ZeRO-1 steps (3 until [36] and [37] joined) from
   one init and the same batches,
   the counts set to 0 just before each run and read just after; step
   losses within 5e-3 of each other; the fused reduce-scatter launched once
   per gathered (leaf, layer) by the fsdp adjoint; ms a step, tokens/s,
   busy share and peak memory of each;
23. gpt-125m trained at full width: 2 ZeRO-1 steps at seq 1024;
24. grouped-matmul backward vs plain: ``grouped_matmul_bwd`` (dx = dy wᵀ,
   dw = xᵀ dy; ``csrc/grouped_matmul.cu``) against its plain version case by
   case (``GMM_BWD_CASES``: Mixtral's prefill shapes at capacity 1280 and
   the window run's 1440, moonshot's at 480 with layer-slice weights, a
   ragged capacity 333, zero rows, the wgmma routes' edges, rows TMA cannot
   describe, M <= 16, K or N not a multiple of 8, f32), dx and dw each
   within GMM_LIMITS, a dropped token's row of dx zero, the same bits on a
   second launch, every backward route reached; and ``ops.expert_ffn_gmm``'s
   gradients (the autograd Function) at moonshot's expert shape against
   autograd of the plain composition within FFN_LIMITS;
25. MoE training at full width: moonshot-v1-16b-a3b (d_model 2048, 16 x 128
   heads, 64 experts top-6 of d_ff 1408, vocab 163840) cut to 1 of its 48
   layers, bf16 parameters with f32 master state, weights from a seed, on a
   (pod=2, data=2) ThreadMesh (MOE_TRAIN_LAYERS' note says what lets four
   ranks fit), two micro-steps of 1 x 4096 tokens a rank, remat, hier,
   pallas, no codec: the step-0 gate (every backward launch's dx and dw
   against the plain backward, the expert leaves' gradients against a run
   with the plain gmm), then 3 ZeRO-3 and 3 ZeRO-1 steps from one init, the
   counts set to 0 just before each run and read just after: 6 forward and
   6 backward gmm launches per layer, micro-step and rank (all wgmma), flash
   at d 128, the fused rings per bucket and leaf (ZeRO-1) or per gathered
   leaf and micro-step in the fsdp adjoint, the expert stacks among them,
   and per leaf (ZeRO-3); finite losses; ZeRO-3 against ZeRO-1 on step 0's
   gradient norm and the parameters after step 0 (the tree and each leaf);
   per stage ms a step, tokens/s, busy share, peak memory and the memory
   at the boundaries of one more step; the adjoint's layout copy at an
   expert stack;
26. grouped-matmul backward times: dx and dw at Mixtral's (capacity 1280)
   and moonshot's (480) shapes, L2 cold, in turns with ``torch.bmm`` on the
   same transposed views (a yardstick the port never calls), back to back
   and from CUDA graphs, beside the plain version and the operations bound;
27. SSD backward vs plain: ``ssd_scan_model_bwd`` (``csrc/ssd_scan_bwd.cu``:
   the state scan, the chunks' gradients, the head sum, on the route the
   dtype picks: bf16 on tensor cores, ``mma``, f32 on the CUDA cores) after
   a forward launch that writes the chunk states, against its plain version
   case by case (``SSD_BWD_CASES``: [28]'s two training shapes, f32, dt
   near 20, a slow decay with an initial state and dfin in either dtype, G
   2 and G = H, chunks of 100 and 32, P 128 and 16), dx, ddt, da, dB, dC
   and d init each within ``SSD_BWD_LIMITS``, the bf16 cases of dt scale 1
   or more also within the mma route's own check (``SSD_BWD_MMA_REL_L2``),
   bit-equal on a second run, the counts (per stage and per route) moved by
   exactly the launches made; and flash's backward at head dim 112
   (``FLASH_D112_BWD_CASES``: zamba2's training shape, a ragged f32 case)
   within ``BWD_LIMITS``;
28. SSM and hybrid training at full width: mamba2-2.7b cut to 4 of 64
   layers and zamba2-7b cut to 7 of 81 (one group of six Mamba2 blocks, the
   shared attention block, one tail block), bf16 parameters with f32 master
   state, weights from a seed, on a (pod=2, data=2) ThreadMesh, two
   micro-steps of 1 x 4096 tokens a rank, remat, hier, pallas, no codec: the
   step-0 gate (every SSD backward launch against the plain backward of its
   inputs, every d-112 flash backward launch against its plain version),
   then 2 ZeRO-3 and 2 ZeRO-1 steps from one init and the same batches, the
   counts set to 0 just before each run and read just after: 2 SSD forward
   launches (remat's recompute the second) and 1 backward call per Mamba2
   block, micro-step and rank, 2 flash forward and 1 backward per shared
   block, the fused rings per bucket and leaf (ZeRO-1) or per gathered key
   and micro-step in the fsdp adjoint, counted against the gather plan, and
   per leaf (ZeRO-3); finite losses; step 0's loss against the same batch
   with every kernel op plain (``SSM_STEP0_LOSS_ATOL``, a sanity check)
   beside planted faults' gaps, one of which it must catch
   (``SSM_LOSS_FAULTS``); ZeRO-3 against ZeRO-1: the step losses, step 0's
   gradient norm, the parameters after step 0 (the tree and each leaf, the
   replicated and the shared block's named); per stage ms a step,
   tokens/s, busy share, peak memory (under ``SSM_TRAIN_PEAK_GIB``), from
   the profile of one more step the SSD backward kernels' card time and the
   five kernels with the most card time;
29. SSD backward times at [28]'s two shapes: each launch of its route
   (``ssd_scan.BWD_LAUNCHES``: the chunks' own terms of the state scan, the
   combine, the chunks, the group sum) and the whole backward, L2 cold,
   back to back and from CUDA graphs, in turns with the plain backward,
   the backward beside the function's bound (its inputs read and outputs
   written once) and each launch beside its own traffic, a diagnostic (no
   library yardstick: no one PyTorch call computes it); and flash's
   backward at
   d 112 against SDPA's;
31. planned training (runs before [30]'s line, which carries its launches):
   full-width smollm-135m on a (pod=2, data=2) ThreadMesh with [11]'s batch,
   configured by the launcher's own code (``launch.train.plan_run``), four
   runs of ``PLANNED_STEPS`` steps from one init (``PLANNED_RUNS``): (a) the
   default ``--policy auto``, the planner's per-op table on H100 islands,
   uniform shares; (b) ``--plan auto`` priced on the paper's V100 + W7800
   testbed: shares (3, 1) (pod 1 masks two of its three micro-steps), int8
   on the large rows beside uncompressed medium and small ones; (c) (b)
   with ``--cross-dtype bfloat16`` (ROADMAP A5b); (d) the oracle, (b)'s
   shares on the legacy facade, hier/xla in f32.  The counts set to 0 just
   before each run and read just after: the collective calls per (op, size
   class, variant, policy) row (``hetccl.dispatches``) and the fused ring
   launches per row and stripes (``tacc.row_launches``) equal what the
   leaves, the buckets and the table imply (``planned_expectations``); the
   codec launches only under int8 rows (and error feedback); flash per
   layer and micro-step.  Step 0's loss of (b) and (c) is (d)'s bit for bit,
   (a)'s (the same tokens under other shares) within
   ``PLANNED_STEP0_LOSS_RTOL``; (b)'s losses within [11]'s int8 limit of
   (d)'s; step 0's reduced gradients of (b) within ``int8_reduction_bound``
   of (d)'s element by element (derived from the codec's step), of (c)
   within ``bf16_cross_bound`` of the f32-accumulate oracle on every rank;
   per run ms a step, tokens/s, peak memory and, for the planned runs, the
   planner's modeled step time of the priced cluster (the busy share of a
   profiled step only for the runs in ``PLANNED_PROFILED``, none since
   [33] joined);
32. checkpoints, telemetry and the roofline (runs after [31], before [30]'s
   line): full-width smollm-135m on (pod=2, data=2) through
   ``launch.train.run`` on [31]'s flags (its run (a): the default table on
   H100 islands) with ``--trace``, ``--metrics-out``, ``--ckpt-dir`` and
   ``--ckpt-every 2``: (a) 4 traced steps, the spans per row equal to
   ``hetccl.dispatches``, every collective span priced by the model, the
   Chrome trace and the flight dump valid, ``rows_from_flight`` equal to
   the tracer's cells, the first calibration rows of the card and the step
   time with and without ``--trace``; (b) (a)'s 2 steps and their save,
   then a fresh program that restores it and runs 2 more steps untraced:
   losses and final state equal to (a)'s 4 straight steps bit for bit; (c) the ZeRO-1 checkpoint restored onto
   (pod=1, data=2) and a ZeRO-3 state saved on (2, 2) restored onto (pod=1,
   data=4), params, master and moments equal to the saved full arrays bit
   for bit; (d) one step counted on the card (CUDA kernels) and on ``meta``
   (plain versions), equal in dot FLOPs and wire bytes, the one-card
   roofline terms and MFU of the measured step, and of [31]'s run (a);
   (e) two dry-run cells (``launch.dryrun.run_cell``): smollm-135m
   ``train_4k`` on the multi mesh with ``--plan auto``, and mamba2-2.7b's
   ``decode_32k`` on one card;
33. the elastic control plane (runs after [32], before [30]'s line):
   full-width smollm-135m on (pod=2, data=2) through ``launch.train.run``
   with ``--elastic --watchdog`` on [31]'s flags and the fused rings
   (``ELASTIC_FLAGS``), two runs of ``ELASTIC_STEPS`` (3) steps from one
   init: (a) ZeRO-3, a collective stall at step 1 (the watchdog's ladder:
   retry, retry, a rebuilt communicator on both pods), pod 1 lost at step 2
   and recovered from pod 0's ranks alone (pod 1's states overwritten with
   NaN first): checkpointless, the survivor program without a "pod" axis,
   steps 0-1 equal to an uninterrupted ``ft.run_supervised`` and step 2 to
   the survivor program stepped from that run's step-2 state, bit for bit;
   (b) ZeRO-1 with a checkpoint every 2 steps, pod 1 lost at step 2: the
   flat optimizer shards gone with it, the step-2 checkpoint restored onto
   the survivors, step 2 equal to that checkpoint restored onto the
   survivor program and stepped, bit for bit.  Each run's launches of the flash
   forward and backward and the fused ring reduce-scatter and all-gather
   equal what its layers, leaves, buckets, gathers and steps imply
   (``elastic_launches``); ms a step on 4 and on 2 ranks, each recovery's
   wall time and each rebuild's modeled recovery times (the simulator's, of
   the H100 islands);
34. the VLM at full width (runs after [33], before [30]'s line):
   qwen2-vl-72b (d_model 8192, 64/8 heads x 128, d_ff 29568, vocab 152064,
   M-RoPE sections (16, 24, 24)) cut to 8 of its 80 layers (9.51 B
   parameters, 19.0 GB of bf16), weights from a seed (the stacked
   projections at std 1/sqrt(fan-in), ``redraw_projections``) and its norm
   scales perturbed from it: 8 requests of 512 prompt tokens and 32 new through
   ``Batcher`` (text-only M-RoPE positions), the counts set to 0 just
   before and read just after: 8 flash launches at d 128, none in decode;
   tokens in the vocab, finite logits; one more prefill on an image block
   laid out by ``mrope_grid`` (64 text tokens, a 16 x 16 grid, text):
   each layer's kernel against its plain version, the last-position logits
   against attention pinned to plain, and against the text-only positions,
   which must differ (the sections act); tokens/s, prefill and decode ms,
   busy shares, peak memory; the flash forward's times at its shape;
35. the encoder-decoder at full width and depth (after [34]):
   whisper-medium (24 encoder + 24 decoder layers, d_model 1024, 16 heads
   x 64, 1500 frames), its projections redrawn as [34]'s and its biases
   and LayerNorms perturbed from the seed:
   8 requests of 1500 frames (seeded normals for the stubbed frontend) and
   64 prompt tokens, 32 new, through ``Batcher``: 72 flash launches a
   prefill (24 encoder bidir 1500 x 1500, 24 decoder causal 64, 24 cross
   bidir 64 x 1500; each counted by shape), none in decode; each kind's
   kernel against its plain version, layer by layer; the whole model's
   logits against attention pinned to plain, in bf16 and in f32;
   the cached ``cross_k`` and ``cross_v`` bit-equal before and after 32
   decode steps; the same figures as [34] and the three shapes' times;
36. the VLM trained (after [35]): qwen2-vl-72b at full width cut to 1 of
   its 80 layers (3.37 B parameters, 60.6 GB of state at 18 bytes a
   parameter: one rank, VLM_TRAIN_LAYERS' note), ZeRO-1 on a one-rank
   ThreadMesh, two micro-steps of 1 x 4096 a step, each sequence holding a
   32 x 32 image grid in its ``mrope`` leaf, remat, hier, pallas, no
   codec, bf16 parameters with f32 master state, its projections redrawn:
   step 0's attention gradients on the grid against text-only positions
   (they must differ by VLM_GRID_GRAD_FLOOR), then 2 steps, the counts set
   to 0 just before and read just after (8 flash forward and 4 backward
   launches at (causal, 4096, 4096), d 128); finite losses and gradient
   norms; ms a step, tokens/s, busy share, peak memory;
37. the encoder-decoder trained (after [36]): whisper-medium whole on a
   (pod=2, data=2) ThreadMesh, two micro-steps of 4 clips (1500 frames,
   448 decoder tokens) a rank, 32 clips a step, remat, hier, pallas, no
   codec, bf16 with f32 master state, projections redrawn and biases and
   norms perturbed as [35]'s: the step-0 gate (each shape's first flash
   backward launch against the plain backward with the kernel's bf16
   rounding points, BWD_BF16_POINTS_LIMITS, the f32 plain printed), then 2
   ZeRO-3 and 2 ZeRO-1 steps from one init on the same batches, the counts
   set to 0 just before each run and read just after: flash forward and
   backward launches by (kind, Sq, Sk), the fused rings, the fsdp
   adjoint's reduce-scatters against the gather plan; finite losses;
   ZeRO-3 against ZeRO-1 ([22]'s loss and gradient-norm limits,
   ENCDEC_ZERO_PARAM_REL_L2 over the tree, ENCDEC_ZERO_LEAF_REL_L2 per
   leaf, and the step-0 update signs that flip between the stages counted
   and held to the difference they predict, ENCDEC_ZERO_FLIP_SHARE and
   ENCDEC_ZERO_PRED_RATIO), with a control run (ZeRO-3's step 0 with one
   rank's gradient lost) that must fail those limits; step 0's wall,
   ZeRO-3's step 1 and tokens/s at it, peak memory, and ZeRO-1's busy share
   from its second step, run under torch.profiler;
38. the fused rings across processes (ROADMAP A3, after [37]): four
   processes spawned by ``launch.mesh.spawn_dist_mesh`` share the card, a
   gloo DistMesh, weights and inputs from seed 0, each rank launching its
   own part of the per-rank ring kernels over peer memory (CUDA IPC
   arenas, ``kernels/peer.py``): (a) R 4 on "pod" at [8]'s ring shape,
   reduce-scatter with an f32 and a bf16 wire and all-gather of 4- and
   2-byte words, stripes 1 and 4, both directions, each process's output
   bit for bit against the plain versions on the same inputs (regenerated
   in every process), and ms a call beside the one-launch route's at the
   same shape ("four processes sharing one card: the protocol, not a
   link"); (b) rank 3 withholds one call: ranks 0-2 must raise the
   kernel's timeout within PEER_FAULT_BOUND_S and no process may hang;
   then on a (pod=2, data=2) DistMesh (c) hier/pallas ``tree_all_reduce``
   of [7]'s f32 gradient trees bit for bit against [7]'s ThreadMesh
   result, each process launching what [7]'s one launch over all ranks
   does; (d) 2 ZeRO-1 steps of full-width smollm-135m ([11]'s pallas run,
   f32 wire) whose losses and parameters equal the same steps on a
   ThreadMesh run in this process before the spawn, bit for bit; (e) the
   processes save a checkpoint after step 1 and this process resumes it on
   a ThreadMesh: its step 2 equals theirs bit for bit.  Times are one
   card's time-sliced processes; memory per process is printed;
30. a JSON line listing every kernel (the flash forward with its nine
   main-path shapes under ``shapes`` and its launches in [36] and [37],
   the backward's d-100, d-112 and [36]'s and [37]'s shapes, its launches
   there and its Sq != Sk cases' errors, the grouped matmul's and the SSD
   scan's launches per route under
   ``routes``, the grouped matmul's backward products with their routes'
   launches in the MoE training run, the SSD backward with its three
   launches under ``stages`` and its launches in [28], and every kernel's
   launches in [31]'s runs under ``planned_launches`` and in [33]'s under
   ``elastic_launches``);
32. the last line, ``{"ok": true, "device": {...}}``.

Each phase prints its wall time.  ``phase_ckpt_obs`` and ``phase_elastic``
take ``flags`` and ``device``, so the tests run them reduced on the CPU.

It needs the repository around it: run alone, or where
``torch.cuda.is_available()`` is false, it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

# H100 SXM data-sheet peaks (dense): device memory rate, bf16 tensor-core
# rate, and the f32 rate of the CUDA cores that the f32 route runs on.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dtype, model_layout)
# Inputs are unit-scale normals.  Every row of every case has a valid key.
KERNEL_CASES = [
    ("serve_prefill", 8, 9, 3, 512, 512, 64, "causal", 0, None, "bfloat16", True),
    ("ragged_s300", 8, 9, 3, 300, 300, 64, "causal", 0, None, "bfloat16", True),
    ("d128_hq36_hkv4", 2, 36, 4, 512, 512, 128, "causal", 0, None, "bfloat16", False),
    ("bidir_klen301", 2, 8, 2, 384, 384, 64, "bidir", 0, 301, "bfloat16", False),
    ("window64", 2, 9, 3, 512, 512, 64, "causal", 64, None, "bfloat16", False),
    ("bidir_sq100_sk300", 2, 4, 2, 100, 300, 64, "bidir", 0, None, "bfloat16", False),
    ("d32_reduced", 2, 4, 2, 200, 200, 32, "causal", 0, None, "bfloat16", True),
    # d 112 with a k_len cut, Sq ragged against the 128-row q tile
    ("d112_klen250_sq333", 2, 8, 2, 333, 400, 112, "bidir", 0, 250, "bfloat16", True),
    # Sq below one consumer warpgroup's 64 rows
    ("causal_sq40_d128", 3, 8, 2, 40, 40, 128, "causal", 0, None, "bfloat16", True),
    ("f32", 2, 9, 3, 512, 512, 64, "causal", 0, None, "float32", True),
    ("f32_d128_bidir_window48_klen150", 1, 4, 1, 150, 200, 128, "bidir", 48, 150, "float32", False),
    # mixtral's prefill (phase 14): d 128, GQA 32/8, its window 4096 > Sq
    ("mixtral_prefill", 8, 32, 8, 512, 512, 128, "causal", 4096, None, "bfloat16", True),
    # mixtral's window prefill (phase 15): d 128, GQA 32/8, window 4096 < Sq
    ("mixtral_window4096", 1, 32, 8, 4608, 4608, 128, "causal", 4096, None, "bfloat16", True),
    # llama-3b's prefill (phase 21): d 100, heads 200 bytes apart in model
    # layout, so the wrapper copies q, k, v into rows of 104 (tma_ready)
    ("llama3b_prefill", 8, 32, 32, 512, 512, 100, "causal", 0, None, "bfloat16", True),
    # d 100 contiguous (rows 200 bytes apart), GQA, a k_len cut, Sq ragged
    ("d100_bidir_klen250_sq333", 2, 8, 2, 333, 400, 100, "bidir", 0, 250, "bfloat16", False),
    ("f32_d100_window40", 2, 4, 2, 200, 200, 100, "causal", 40, None, "float32", True),
    # llama-1b's training forward (phase 22): the paper's 1 x 8192 a rank,
    # GQA 32/4, model layout
    ("llama1b_train", 1, 32, 4, 8192, 8192, 64, "causal", 0, None, "bfloat16", True),
    # qwen2-vl-72b's prefill (phase 34): d 128, GQA 64/8
    ("qwen2vl_prefill", 8, 64, 8, 512, 512, 128, "causal", 0, None, "bfloat16", True),
    # whisper-medium's prefill (phase 35): the encoder over 1500 frames (no
    # tile size divides 1500: ragged tiles), the decoder over 64 prompt
    # tokens, the cross-attention of 64 queries over the 1500 frames
    ("whisper_enc_bidir_1500", 8, 16, 16, 1500, 1500, 64, "bidir", 0, None, "bfloat16", True),
    ("whisper_dec_causal_64", 8, 16, 16, 64, 64, 64, "causal", 0, None, "bfloat16", True),
    ("whisper_cross_sq64_sk1500", 8, 16, 16, 64, 1500, 64, "bidir", 0, None, "bfloat16",
     True),
]
# The flash forward's main-path shapes (the kernel case timed for each, in
# phase 5, and zamba2's in phase 20) and the launch count each one's run reads
FLASH_TIMED = {"smollm": "serve_prefill", "mixtral_prefill": "mixtral_prefill",
               "mixtral_window": "mixtral_window4096", "zamba2": "zamba2_d112",
               "llama3b": "llama3b_prefill", "qwen2vl": "qwen2vl_prefill",
               "whisper_enc": "whisper_enc_bidir_1500", "whisper_dec": "whisper_dec_causal_64",
               "whisper_cross": "whisper_cross_sq64_sk1500"}

# Kernel against its plain version, both errors relative to the plain output:
# (relative L2 of the whole output, worst relative L2 of one output row).  The
# row limit catches a fault confined to a few rows (a tile edge, a window
# boundary).  bf16: the kernel rounds P to bf16 for the P.V product, and both
# sides round the output to bf16 (an ulp is 2**-8 to 2**-7 of the value).
# f32: the same sums in another order.  Each limit is 2 to 5 times the
# largest reading over these cases on an H100 (PERF.md); the faults planted
# by tests/test_torch_cuda.py land 10 times and more above them.
ATTN_LIMITS = {"bfloat16": (5e-3, 1e-2), "float32": (1e-6, 3e-6)}

ARCH = "smollm-135m"
N_REQUESTS, PROMPT_LEN, MAX_NEW, SEED = 8, 512, 32, 0
# Prefill logits (last position, relative L2) through the kernel against
# attention pinned to the plain variant.  bf16: random weights amplify
# rounding over 30 layers, so two bf16 routes that round in different places
# drift apart; the limit is set from the readings on these seeds (0.148 to
# 0.156 on an H100, PERF.md).  The tight
# bf16 check at full depth is per layer (ATTN_LIMITS on each layer's own
# inputs).  f32: the same weights in f32, sums taken in another order only.
BF16_LOGITS_REL_TOL = 0.25
F32_LOGITS_REL_TOL = 1e-4

# Ring kernels against the plain versions of their schedules: both do the
# same adds in the same order, so the limit is bitwise equality.  Cases:
# (kind, ring length n, rings in the launch, direction, stripes, input
# dtype, wire dtype); c elements per chunk, ragged on purpose.
RING_C = 1_000_003
RING_CASES = (
    [("rs", n, 1, d, k, "float32", w) for n in (2, 3, 4, 5) for d in (1, -1)
     for k in (1, 2) for w in ("float32", "bfloat16")]
    + [("rs", 3, 1, 1, 2, "bfloat16", "bfloat16"), ("rs", 4, 1, -1, 1, "bfloat16", "bfloat16"),
       ("rs", 2, 2, 1, 1, "float32", "float32"), ("rs", 3, 2, -1, 2, "float32", "bfloat16")]
    + [("ag", n, 1, d, k, "float32", None) for n in (2, 3, 4, 5) for d in (1, -1)
       for k in (1, 2)]
    + [("ag", 3, 1, 1, 2, "bfloat16", None), ("ag", 2, 2, -1, 1, "float32", None),
       # bf16 at an odd c: 2-byte words, rows 2c bytes apart, so the copies
       # into the output row 1 take the scalar head, stores and tail
       ("ag", 2, 2, 1, 1, "bfloat16", None)])
# collective_reduce: incoming dtype, length
REDUCE_CASES = [("float32", RING_C), ("bfloat16", RING_C), ("float32", 7), ("bfloat16", 4097)]

COLL_ARCH = "smollm-135m"
COLL_SEED = 1000
# relative L2 of the all-reduced tree against a float64 sum over ranks.  f32:
# the ring adds in f32 in its own order; four unit normals per element.
COLL_F32_REL_TOL = 1e-6
# bf16 cross stage: the shard is rounded to bf16 before the ring, each hop
# rounds the running partial, the result is rounded once more.  Twice the
# reading on an H100 (2.45e-3, PERF.md).
COLL_BF16_REL_TOL = 5e-3
COLL_TIMING_REPS = 5

# Flash backward against its plain version (dq, dk, dv, each against the
# plain f32 gradient): relative L2 of the whole tensor, and the worst row's
# error over the larger of its own norm and the mean row norm (a row's own
# norm can be 0: the first query row of a causal mask has dq = 0 exactly).
# bf16: P and dS are rounded to bf16 for the products that take them.
# Limits: about 3 times the largest reading over these cases on an H100
# (1.70e-3 and 3.87e-3 in bf16, 7.80e-7 and 1.22e-6 in f32; PERF.md).
BWD_LIMITS = {"bfloat16": (5e-3, 1e-2), "float32": (3e-6, 4e-6)}
# (name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dtype, model_layout), as
# KERNEL_CASES
BWD_CASES = [
    ("train", 2, 9, 3, 512, 512, 64, "causal", 0, None, "bfloat16", True),
    ("train_f32", 2, 9, 3, 512, 512, 64, "causal", 0, None, "float32", True),
    ("ragged_s300_bidir_klen201", 1, 4, 2, 300, 300, 64, "bidir", 0, 201, "bfloat16", False),
    ("window48_d32", 2, 4, 1, 256, 256, 32, "causal", 48, None, "bfloat16", False),
    ("d128_hq8_hkv2", 1, 8, 2, 200, 200, 128, "causal", 0, None, "bfloat16", False),
    ("f32_d128_bidir_window40_klen130", 1, 4, 1, 150, 150, 128, "bidir", 40, 130, "float32",
     False),
    ("f32_d32_s100", 2, 4, 2, 100, 100, 32, "causal", 0, None, "float32", True),
    # a GQA group of 16: the bf16 dK/dV pass's clusters hold 8 blocks, so
    # each rank takes two heads
    ("gqa16_cluster8", 1, 16, 1, 256, 256, 64, "causal", 0, None, "bfloat16", False),
    # d 100 (llama-3b's heads, 112 wide in shared memory): its training shape
    # at one sequence of 2048, model layout; GQA with a window and a ragged
    # S; the f32 route with a k_len cut
    ("d100_llama3b", 1, 32, 32, 2048, 2048, 100, "causal", 0, None, "bfloat16", True),
    ("d100_gqa4_window64_s300", 2, 8, 2, 300, 300, 100, "causal", 64, None, "bfloat16", False),
    ("f32_d100_bidir_klen101", 1, 4, 2, 130, 130, 100, "bidir", 0, 101, "float32", True),
    # llama-1b's training backward (phase 22): 1 x 8192, GQA group 8 (the
    # dK/dV pass's clusters of 8), model layout
    ("llama1b_train", 1, 32, 4, 8192, 8192, 64, "causal", 0, None, "bfloat16", True),
    # whisper-medium's training shapes (phase 37: 4 clips a micro-step, 448
    # decoder tokens): the encoder over 1500 frames (ragged against every
    # tile), the decoder causal, and the cross-attention, 448 queries over
    # 1500 keys: the first cases with Sq != Sk
    ("whisper_enc_train", 4, 16, 16, 1500, 1500, 64, "bidir", 0, None, "bfloat16", True),
    ("whisper_dec_train", 4, 16, 16, 448, 448, 64, "causal", 0, None, "bfloat16", True),
    ("whisper_cross_train", 4, 16, 16, 448, 1500, 64, "bidir", 0, None, "bfloat16", True),
    # qwen2-vl-72b's training shape (phase 36): 1 x 4096, d 128, GQA 64/8
    ("qwen2vl_train", 1, 64, 8, 4096, 4096, 128, "causal", 0, None, "bfloat16", True),
    # the f32 route with Sq below and above Sk, neither a tile multiple, and
    # a k_len cut: a key-block grid sized from Sq, or a query loop bounded by
    # Sk, fails one of the two
    ("f32_sq70_sk200_bidir_klen150", 1, 4, 2, 70, 200, 64, "bidir", 0, 150, "float32", False),
    ("f32_sq200_sk70_bidir_klen50", 2, 4, 2, 200, 70, 64, "bidir", 0, 50, "float32", True),
]
# The flash backward's times in phase 12 (``phase_train_kernel_times``):
# {label: BWD_CASES name}, beside the training shape's
BWD_TIMED = {"d100": "d100_llama3b", "whisper_enc": "whisper_enc_train",
             "whisper_dec": "whisper_dec_train", "whisper_cross": "whisper_cross_train",
             "qwen2vl": "qwen2vl_train"}
# rounds of turns with SDPA's backward (``in_turns``): two for the shapes
# [36] and [37] brought, whose timing is first readings, for the room
BWD_TIMED_ROUNDS = {"d100": 4, "whisper_enc": 2, "whisper_dec": 2, "whisper_cross": 2,
                    "qwen2vl": 2}
# Codec cases: (name, rows of 512, fill); each also as an odd-width view
QUANT_ROWS = [("one_row", 1, "randn"), ("seven_rows", 7, "randn"), ("zero_chunks", 1000, "zeros"),
              ("half_way", 600, "half"), ("nan_chunk", 300, "nan"), ("wide_range", 5000, "randn")]

TRAIN_SEQ, TRAIN_MICRO_BATCH, TRAIN_STEPS, TRAIN_LR = 512, 2, 2, 1e-3
TRAIN_RUNS = {"int8_ef": dict(backend="pallas", wire_quant="int8"),
              "pallas": dict(backend="pallas"), "xla": dict(backend="xla")}
# The int8 run's final loss against the run without a codec, absolute.  The
# codec quantizes the gradients (with error feedback) and the parameter
# all-gather (ROADMAP C2); TRAIN_STEPS steps at lr 1e-3 from one init (5
# until [33] joined, 3 until [36] and [37] did: the script keeps inside its
# time limit).  About 3 times
# the reading on an H100 after 5 steps (5.25e-2, PERF.md); after 3 it read
# 4.48e-2.
TRAIN_INT8_LOSS_TOL = 0.15


# The MoE slice: full-width mixtral-8x7b cut to 8 of its 32 layers (every
# kernel at its published shape; 23.7 GB of bf16 weights), weights from a seed.
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 8
MOE_REQUESTS, MOE_PROMPT, MOE_NEW = 8, 512, 32
WINDOW_PROMPT, WINDOW_NEW = 4608, 16       # past the 4096 window: rolling cache

# Grouped matmul against its plain version, both errors relative to the plain
# output: (relative L2 of the whole output, worst row's L2 error over the
# larger of its own norm and the mean row norm; a dropped token's row is 0).
# bf16: both sum exact products in f32 and round once, so they differ only
# where the two sums' order flips a rounding, by one ulp (2**-8 to 2**-7 of
# the value).  f32: the same sums in another order (fmaf in the kernel).
GMM_LIMITS = {"bfloat16": (1e-3, 5e-3), "float32": (1e-6, 4e-6)}
# expert_ffn through the kernel against the same composition through the
# plain version: h1 and h3 may differ by an ulp, which SiLU, the product and
# w2 carry into the output.
FFN_LIMITS = {"bfloat16": (5e-3, 2e-2), "float32": (1e-6, 4e-6)}
# Last-position logits (relative L2) of the served model through the kernel
# against expert_ffn pinned to the plain composition: gated on the requests
# whose routes and drops agree in every layer (routing is discontinuous: a
# request whose routes differ anywhere is compared but not gated), and on
# every request of a plain run that replays the kernel run's routes.
# bf16: random weights amplify rounding from layer to layer (the MoE
# outputs' drift is printed per layer), as in the dense serve phase; 0.1 was
# stated before the first reading and missed (0.020 to 0.160 over the 8
# requests, routes replayed, on an H100; PERF.md), so the limit is twice the
# largest reading.  The tight end-to-end check is f32: the same model's
# first MOE_F32_LAYERS layers in f32, where both routes differ only in the
# order of f32 sums.
MOE_LOGITS_REL_TOL = {"bfloat16": 0.3, "float32": 1e-4}
MOE_F32_LAYERS = 2
# (name, G, M, K, N, dtype, layout): "dense"; "zero_rows" (a capacity buffer
# with dropped tokens' rows zero); "layer" (w the last layer of a stacked
# (2, G, K, N) tensor, as the model passes it); "layer_view" (w a layer slice
# of a stacked (2, G, K, N') tensor, columns 24..24+N, 16-byte aligned rows);
# "odd_view" (columns from 3: unaligned rows, the mma.sync routes'
# plain-load path).  Phase 13 prints the route each case takes.
GMM_CASES = [
    *[(f"sweep_{G}x{M}x{K}x{N}_{dt}", G, M, K, N, dt, "dense")
      for G, M, K, N in ((4, 200, 96, 160), (1, 128, 128, 128), (8, 64, 300, 48))
      for dt in ("float32", "bfloat16")],
    ("mixtral_prefill_w13", 8, 1280, 4096, 14336, "bfloat16", "dense"),
    ("mixtral_prefill_w2", 8, 1280, 14336, 4096, "bfloat16", "dense"),
    ("mixtral_decode_w13", 8, 2, 4096, 14336, "bfloat16", "dense"),
    ("mixtral_decode_w2", 8, 2, 14336, 4096, "bfloat16", "dense"),
    ("mixtral_window_w13", 8, 1440, 4096, 14336, "bfloat16", "zero_rows"),
    ("moonshot_expert", 64, 240, 2048, 1408, "bfloat16", "dense"),
    ("zero_rows", 8, 300, 512, 640, "bfloat16", "zero_rows"),
    ("layer_view", 8, 100, 512, 1000, "bfloat16", "layer_view"),
    ("odd_view", 4, 33, 256, 500, "bfloat16", "odd_view"),
    ("ragged_k100_m9", 5, 9, 100, 70, "bfloat16", "dense"),
    ("f32_reduced_expert", 4, 80, 128, 128, "float32", "dense"),
    ("f32_ragged_views", 3, 77, 129, 65, "float32", "odd_view"),
    # the wgmma route's edges: M not a multiple of 128, N not of 256, K not of
    # 64; M below one consumer warpgroup's 64 rows; K below one stage; a
    # layer of Mixtral's stacked weights with a ragged M
    ("wgmma_edges", 3, 200, 264, 392, "bfloat16", "zero_rows"),
    ("wgmma_m40_n136", 2, 40, 128, 136, "bfloat16", "dense"),
    ("wgmma_k24", 2, 100, 24, 64, "bfloat16", "dense"),
    ("mixtral_layer_m1000", 8, 1000, 4096, 14336, "bfloat16", "layer"),
]

# The SSM slice: full-width mamba2-2.7b (64 layers, 2.83 B parameters) and
# zamba2-7b (81 layers, 6.75 B), both whole, bf16, weights from a seed.
SSM_ARCH, HYBRID_ARCH = "mamba2-2.7b", "zamba2-7b"
SSM_REQUESTS, SSM_PROMPT, SSM_NEW = 8, 2048, 32

# SSD kernel against its plain version (ssd_scan_model_plain over
# ref.ssd_scan_states at the model's layout, ref.ssd_scan at the kernel's),
# y and the final state each: (relative L2 of the whole tensor, worst row's L2
# error over the larger of its own norm and the mean row norm), keyed by the
# output's type.  f32 (the model path writes y in f32 whatever its inputs):
# both sum the same f32 products in another order.  bf16 (the kernel layout
# with bf16 inputs): both round their f32 result once, so they differ by an
# ulp where the two sums straddle a rounding.  Stated before the first run on
# the card; the planted faults of tests/test_torch_cuda.py must fail them.
SSD_LIMITS = {"float32": (2e-5, 2e-4), "bfloat16": (2e-3, 8e-3)}
# The mma route's own check, beside SSD_LIMITS (set for a route that rounds no
# operand): the relative L2 of y and of the final state at most
# SSD_MMA_REL_L2, on each bf16 case of dt scale 1 or more (f32 outputs) and
# on the worst layer of each model's prefill.  There the sound kernel reads
# 1.9e-7 to 3.4e-7 and a kernel whose f32 operands keep two bf16 parts of
# three (16 bits) about 2.4e-6.  At dt scale 0.01 the state carries through
# every position and the tensor cores' f32 sums drift from the plain
# version's by 6e-7 to 1.3e-6 with all three parts (by the order of the
# state update's sums), so SSD_LIMITS alone hold slow_decay_bf16.
SSD_MMA_REL_L2 = 1e-6
# (name, B, S, H, P, G, N, chunk Q, dtype, dt scale, initial state, layout).
# Inputs: x unit normals, B and C normals of std 0.5, dt = scale *
# softplus(normal), A = -exp(0.25 * normal).  Scale 8 puts dt near 20 and
# beyond, so a falls by thousands within a chunk, as in the full-width
# models; scale 0.01 decays slowly, so the state carried across chunks
# weighs in every row (f32 and bf16: each takes its own route).
SSD_CASES = [
    ("mamba2_prefill", 8, 2048, 80, 64, 1, 128, 256, "bfloat16", 1.0, False, "model"),
    ("zamba2_prefill", 8, 2048, 112, 64, 1, 64, 256, "bfloat16", 1.0, False, "model"),
    ("mamba2_f32", 2, 2048, 80, 64, 1, 128, 256, "float32", 1.0, False, "model"),
    ("mamba2_dt_to_20", 2, 1024, 80, 64, 1, 128, 256, "bfloat16", 8.0, False, "model"),
    ("slow_decay", 2, 1024, 8, 64, 1, 64, 256, "float32", 0.01, True, "model"),
    ("slow_decay_bf16", 2, 1024, 8, 64, 1, 128, 256, "bfloat16", 0.01, True, "model"),
    ("one_chunk", 4, 256, 16, 64, 1, 128, 256, "bfloat16", 1.0, False, "model"),
    ("q100_one_chunk", 4, 100, 16, 64, 1, 128, 100, "bfloat16", 1.0, False, "model"),
    ("q100_three_chunks", 2, 300, 8, 64, 1, 64, 100, "float32", 1.0, False, "model"),
    # chunks of 32, every head its own group: each tile of the mma route is
    # read right after its copies are issued (a phase of one step)
    ("q32_g16", 4, 2048, 16, 64, 16, 64, 32, "bfloat16", 1.0, False, "model"),
    ("g2_h8", 2, 512, 8, 64, 2, 64, 256, "bfloat16", 1.0, False, "model"),
    ("g2_h8_init_state", 2, 512, 8, 64, 2, 64, 256, "float32", 1.0, True, "model"),
    ("bf16_init_state", 2, 768, 16, 64, 1, 128, 256, "bfloat16", 1.0, True, "model"),
    ("reduced_p32_n16", 2, 96, 8, 32, 1, 16, 32, "float32", 1.0, True, "model"),
    ("p128_n64", 1, 512, 4, 128, 1, 64, 256, "float32", 1.0, False, "model"),
    ("kernel_layout_f32", 2, 256, 3, 32, 3, 16, 64, "float32", 1.0, False, "kernel"),
    ("kernel_layout_bf16", 1, 256, 2, 16, 2, 8, 32, "bfloat16", 1.0, False, "kernel"),
]
# The dense configs of the paper and the rest (ROADMAP A8a), each served at
# full width with weights from a seed, bf16: DENSE_REQUESTS x DENSE_PROMPT
# prompt tokens and DENSE_NEW new ones through ``Batcher``.  Each is served
# whole; deepseek-coder-33b's 66.7 GB of bf16 weights fit the 80 GB card
# (init_params draws its largest leaves one layer at a time).
DENSE_ARCHS = ("gpt-125m", "gpt-355m", "smollm-360m", "llama-1b", "llama-3b",
               "starcoder2-7b", "deepseek-coder-33b")
DENSE_REQUESTS, DENSE_PROMPT, DENSE_NEW = 8, 512, 32
# The serving phases' times ([18], [19], [21], [34], [35]; ``serve_times``):
# decode ms a step is the median of SERVE_DECODE_TIMED steps and the busy
# share is read over SERVE_DECODE_PROFILED steps.  Before [34] and [35]
# joined these were 30 and 16 (new tokens - 2 and new tokens / 2): their
# decode steps alone took 31 s of [21]'s 131.5 s on an H100 (46 steps of the
# seven configs' 0.668 s summed, PERF.md), besides the profiler's
# processing of every kernel event of its steps, and the script needed the
# room for [34] and [35].
SERVE_DECODE_TIMED, SERVE_DECODE_PROFILED = 8, 4
# The paper's training shape for llama-1b (paper_figs.py: micro-batch 1 x
# seq 8192), full width on the (pod=2, data=2) ThreadMesh, remat, hier,
# backend pallas: ZeRO-3 and ZeRO-1 from one init and the same batches.
# Their step losses agree within the reference's bound for this comparison
# (tests/test_train.py::test_zero_stages_and_modes_agree, atol 5e-3).
# 2 steps a stage (3 until [36] and [37] joined: the script keeps inside its
# time limit).
LLAMA_ARCH, LLAMA_SEQ, LLAMA_STEPS, LLAMA_LR = "llama-1b", 8192, 2, 1e-3
ZERO_LOSS_ATOL = 5e-3
# The loss alone moves too little in a few steps to show a gradient that is
# scaled wrongly or misses a rank (Adam ignores the scale), so the two runs
# are also held to each other on step 0's gradient norm (relative) and on
# the parameters after step 0 (ZeRO-3's rebuilt from its "data" shards by
# convert.unshard_params; relative L2 over the whole tree).  Limits: about
# 4 times the readings on an H100 (1.04e-6 and 8.42e-5, PERF.md); a rank's
# gradient dropped or scaled twice would move the norm by tens of percent.
ZERO_GRAD_NORM_RTOL = 5e-6
ZERO_PARAM_REL_L2 = 3e-4
# gpt-125m trains 2 ZeRO-1 steps at full width at its paper sequence (1024)
GPT_ARCH, GPT_SEQ, GPT_STEPS, GPT_MICRO_BATCH = "gpt-125m", 1024, 2, 4
# flash forward at zamba2's shared attention (d 112) and the f32 route at 112
FLASH_D112_CASES = [
    ("zamba2_d112", 8, 32, 32, 2048, 2048, 112, "causal", 0, None, "bfloat16", True),
    ("f32_d112_ragged", 2, 4, 2, 300, 300, 112, "causal", 0, None, "float32", True),
]
# Last-position logits of the served model through the kernel against the
# SSD op pinned to its plain variant (the model's chunk loop).  f32 (the
# model's first layers in f32: SSM_F32_LAYERS of mamba2; one group and one
# tail layer of zamba2): only the order of f32 sums differs, so rel L2 per
# request within SSM_F32_LOGITS_REL_TOL.  bf16 (the whole model): both routes
# round y to bf16 at the same points, but a sum taken in another order flips
# a rounding now and then, and random weights amplify that from layer to
# layer.  A fixed limit of 0.3 on the kernel-vs-plain rel L2 was stated
# before the first run and missed on zamba2 (0.036 to 0.441 over the 8
# requests on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) while every
# layer's SSD agreed with its plain version within 3e-9.  So the bf16 gate holds both
# routes against the same model in f32 (plain SSD): over all requests the
# kernel route's logits lie at most SSM_BF16_RATIO times as far from it
# (rel L2) as the plain route's; the per-request kernel-vs-plain numbers are
# printed beside.
SSM_F32_LOGITS_REL_TOL = 1e-4
SSM_BF16_RATIO = 1.5
SSM_F32_LAYERS = 2

# The MoE training slice: the grouped matmul's backward, dx = dy wᵀ and dw =
# xᵀ dy, against its plain version (ref.grouped_matmul_bwd) case by case.
# (name, G, M, K, N, dtype, layout) as GMM_CASES; dy unit normals, zero in a
# dropped token's row (the combine gathers no gradient into it).  Limits:
# GMM_LIMITS, on dx and dw each: both sum exact products in f32 and round
# once, so they differ by an ulp where the sums' order flips a rounding; f32
# the same sums in another order.  Every backward route must be reached.
GMM_BWD_CASES = [
    ("mixtral_w13_c1280", 8, 1280, 4096, 14336, "bfloat16", "dense"),
    ("mixtral_w2_c1280", 8, 1280, 14336, 4096, "bfloat16", "dense"),
    ("mixtral_w13_c1440", 8, 1440, 4096, 14336, "bfloat16", "zero_rows"),
    ("mixtral_w2_c1440", 8, 1440, 14336, 4096, "bfloat16", "zero_rows"),
    ("moonshot_w13_c480", 64, 480, 2048, 1408, "bfloat16", "layer"),
    ("moonshot_w2_c480", 64, 480, 1408, 2048, "bfloat16", "layer"),
    ("ragged_m333", 4, 333, 512, 640, "bfloat16", "dense"),
    ("zero_rows", 8, 300, 512, 640, "bfloat16", "zero_rows"),
    ("layer_view", 8, 100, 512, 1000, "bfloat16", "layer_view"),
    # the wgmma routes' edges: capacity below one consumer warpgroup's 64
    # rows; K not a multiple of 64, N not of 256
    ("wgmma_m40_n136", 2, 40, 128, 136, "bfloat16", "dense"),
    ("wgmma_edges", 3, 200, 264, 392, "bfloat16", "zero_rows"),
    # the strided route: rows TMA cannot describe, M <= 16, K or N not a
    # multiple of 8, f32
    ("odd_view", 4, 33, 256, 500, "bfloat16", "odd_view"),
    ("m9_k100_n70", 5, 9, 100, 70, "bfloat16", "dense"),
    ("k100_n70", 3, 200, 100, 70, "bfloat16", "dense"),
    ("f32_reduced_expert", 4, 80, 128, 128, "float32", "dense"),
    ("f32_ragged_views", 3, 77, 129, 65, "float32", "odd_view"),
    # the stage depth bwd_schedule picks for dw (grouped_matmul._dw_depth):
    # a capacity of 80 (one stage of 80), 470 (6 stages of 80, the last one
    # ragged); 333 above takes stages of 64.  N and K of 1408 (5.5 tiles of
    # 256); fewer tiles than SMs
    ("capacity_80", 8, 80, 256, 384, "bfloat16", "dense"),
    ("capacity_470", 4, 470, 512, 640, "bfloat16", "zero_rows"),
    ("n1408_k1408", 4, 200, 1408, 1408, "bfloat16", "dense"),
]
# Each backward product timed at Mixtral's prefill shapes (capacity 1280)
# and moonshot's (capacity 480): (G, M, K, N) of the forward x @ w.
GMM_BWD_TIMED = {"mixtral_w13": (8, 1280, 4096, 14336), "mixtral_w2": (8, 1280, 14336, 4096),
                 "moonshot_w13": (64, 480, 2048, 1408), "moonshot_w2": (64, 480, 1408, 2048)}
GMM_BWD_ROUNDS = 4
# moonshot-v1-16b-a3b trained at full width (d_model 2048, 16 x 128 heads, 64
# experts top-6 of d_ff 1408, vocab 163840), cut to 1 of its 48 layers (1.24 B
# parameters, 0.67 B of them the embedding and the untied head), on a
# (pod=2, data=2) ThreadMesh: four ranks, the smallest mesh where the hier
# reduction has both stages (the local stage over "data", the cross-pod ring
# on the fused kernels) and where ZeRO-3 gathers over "data".  ZeRO-3 and
# ZeRO-1 from one init.  Four ZeRO-1 ranks once did not fit the card: at the
# gradient all-reduce each rank held its f32 gradient sum and a reduced
# copy, and the ring kernels kept scratch sized by the largest bucket (10.00
# GiB for the 1.34 GB f32 embedding); the step ran out of memory in its
# optimizer at 75.10 GiB allocated (an H100 80GB HBM3, 700 W; PERF.md).
# Now the sums are views into tree_all_reduce's buckets, reduced in their
# own storage (hetccl.bucket_zeros), each gradient is freed once its update
# has read it, the Adam update runs in pieces (optim.ADAM_PIECE), and the
# rings' scratch is sized by each launch and not kept.
# uniform_plan(2, 4, micro_batch=1): two micro-steps of 1 x 4096 tokens a
# rank, 32768 tokens a step; remat; the loss chunk cut from 8192 to 1024
# tokens (the f32 logits of 4096 tokens over the vocab are 2.7 GB a rank).
# lr 1e-3, 3 steps a stage.
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = \
    "moonshot-v1-16b-a3b", 1, 4096, 3
MOE_TRAIN_MESH = {"pod": 2, "data": 2}
MOE_TRAIN_MICRO = 4
MOE_TRAIN_LR, MOE_TRAIN_LOSS_CHUNK = 1e-3, 1024
# The step-0 gate: on rank 0's first micro-batch, every backward launch's
# dx and dw against the plain backward of the same (x, w, dy) within
# GMM_LIMITS, and the expert-weight leaves' gradients (w1, w3, w2) against
# a run with the grouped matmul pinned to its plain version (forward and
# backward) within FFN_LIMITS: with one layer the routes are the same in
# both (the router sees the same attention output), so the leaves differ
# only by the expert FFN's roundings carried through the loss.
# ZeRO-3 against ZeRO-1 at step 0: [22]'s limits on the gradient norm and on
# the parameters over the whole tree, and MOE_ZERO_LEAF_REL_L2 on each leaf:
# the embedding's gradient sets the norm and the tree's L2, so an expert
# stack reduce-scattered wrongly moves neither (a shard's offset shifted in
# the adjoint moves reduced moonshot's w1 and w3 by 2.2e-3 and the norm by
# 1.1e-7; tests/test_torch_moe_train.py).  About 4 times a probe's readings
# on an H100 (PERF.md: the norms 2.0e-7 apart, the tree 4.8e-6, the worst leaf
# 1.58e-4, the head: ZeRO-3 rounds its reduce-scattered gradient to bf16, as
# the reference does, where ZeRO-1 sums in f32; the expert stacks 2.2e-6).
MOE_ZERO_LEAF_REL_L2 = 6e-4
# The SSD backward (csrc/ssd_scan_bwd.cu) against its plain version
# (ssd_scan.ssd_scan_model_bwd_plain over ref.ssd_scan_bwd), case by case: dx,
# ddt, da, dB, dC and, with an initial state, d init, each as gmm_error and
# held to the limits of its own type (dx, dB and dC in the inputs' type; ddt,
# da and d init f32).  f32: both sum the same f32 products in other orders;
# on these cases' inputs at H 4 to 8 the plain backward in f32 lies 1.5e-7 to
# 5.2e-7 (relative L2) and up to 5.7e-6 (worst row: da at dt near 20) from
# the same in float64 on the CPU, so SSD_LIMITS' f32 values leave a margin of
# 35 and more.  bf16 outputs: both round their f32 sums once.  Stated before
# the first run on the card.
SSD_BWD_LIMITS = SSD_LIMITS
SSD_BWD_OUTPUTS = ("dx", "ddt", "da", "dB", "dC", "dinit")
# The bf16 (mma) route's own check, beside SSD_BWD_LIMITS (set for a route
# that rounds no operand): the relative L2 of its f32 gradients (ddt, da
# and, with an initial state, d init) at most SSD_BWD_MMA_REL_L2, on each
# bf16 case of dt scale 1 or more.  Basis, stated before the check's first
# run: the route's first run on an H100 read 2.1e-7 to 5.1e-7 there over
# the seven bf16 cases (the tensor cores' f32 sums in their own order); its
# arithmetic emulated in plain torch (tests/test_torch_ssm_train.py) reads
# 1.1e-7 to 2.0e-7 against the plain backward, 2.3e-6 to 3.8e-6 with lo
# dropped from every split (16 bits of each f32 operand), and 2.8e-6 to
# 2.9e-6 on ddt with the mid x mid products dropped.  At dt scale 0.01 the
# state carries through every chunk, and SSD_BWD_LIMITS alone hold that
# case, as the forward's SSD_MMA_REL_L2 leaves its slow decay.
SSD_BWD_MMA_REL_L2 = 1e-6
SSD_BWD_MMA_CHECKED = ("ddt", "da", "dinit")
# (name, B, S, H, P, G, N, chunk Q, dtype, dt scale, initial state, dfin):
# ssd_inputs' inputs at the model's layout, dy unit normals, dfin unit
# normals where set.  The two training shapes of [28] (mamba2 H 80 / N 128,
# zamba2 H 112 / N 64, one sequence of 4096); f32; dt near 20 (a falls by
# thousands within a chunk); a slow decay with an initial state and dfin
# (the state's gradient carried through every chunk), in f32 and, since at
# dt scale 1 no chunk of 32 or more carries a state the next can see, in
# bf16 for the mma route; G 2 and G = H; chunks of 100 (not a multiple of
# the 32-row tile or the 16-row strip) and 32; P 128 and P 16.
SSD_BWD_CASES = [
    ("mamba2_train", 1, 4096, 80, 64, 1, 128, 256, "bfloat16", 1.0, False, False),
    ("zamba2_train", 1, 4096, 112, 64, 1, 64, 256, "bfloat16", 1.0, False, False),
    ("mamba2_f32", 1, 1024, 80, 64, 1, 128, 256, "float32", 1.0, False, False),
    ("dt_to_20", 1, 1024, 16, 64, 1, 128, 256, "bfloat16", 8.0, False, False),
    ("slow_decay_init_dfin", 2, 1024, 8, 64, 1, 64, 256, "float32", 0.01, True, True),
    ("slow_decay_init_dfin_bf16", 2, 1024, 8, 64, 1, 64, 256, "bfloat16", 0.01, True, True),
    ("g2_h8_init_dfin", 2, 512, 8, 64, 2, 64, 256, "float32", 1.0, True, True),
    ("g2_h8_init_dfin_bf16", 2, 512, 8, 64, 2, 64, 256, "bfloat16", 1.0, True, True),
    ("q100_three_chunks", 2, 300, 8, 64, 1, 64, 100, "float32", 1.0, True, True),
    ("q100_p32_g2_bf16", 2, 300, 8, 32, 2, 128, 100, "bfloat16", 1.0, False, True),
    ("q32_g16", 2, 512, 16, 64, 16, 64, 32, "bfloat16", 1.0, False, False),
    ("p128_n64_init", 1, 512, 4, 128, 1, 64, 256, "float32", 1.0, True, False),
    ("p16_n8_g4", 2, 256, 8, 16, 4, 8, 64, "bfloat16", 1.0, False, False),
]
# The flash backward at head dim 112 (BWD_CASES' fields): zamba2's shared
# attention at [28]'s shape, and a ragged f32 case with GQA.
FLASH_D112_BWD_CASES = [
    ("zamba2_train_d112", 1, 32, 32, 4096, 4096, 112, "causal", 0, None, "bfloat16", True),
    ("f32_d112_gqa2_s300", 2, 4, 2, 300, 300, 112, "causal", 0, None, "float32", False),
]
# SSM and hybrid training at full width (ROADMAP A7, A7b), ZeRO-3 and
# ZeRO-1 on a (pod=2, data=2) ThreadMesh, ``uniform_plan(2, 4, 1)``: two
# micro-steps of 1 x 4096 tokens a rank, 32768 a step; remat, hier, pallas,
# no codec, bf16 parameters with f32 master state, lr 1e-3, 2 steps a stage
# (3 before [32] joined: the script keeps inside its time limit)
# from one init and the same batches, loss chunks of 1024 tokens.  Depth
# cut to fit four ranks in 75 GiB: mamba2-2.7b 4 of 64 layers (16 until [36]
# and [37] joined: the script keeps inside its time limit); zamba2-7b 7 of
# 81 (one group of six Mamba2 blocks, the shared attention block and one
# tail block, 0.98 B), so the tail path runs.
SSM_TRAIN = {"mamba2-2.7b": 4, "zamba2-7b": 7}
SSM_TRAIN_SEQ, SSM_TRAIN_STEPS, SSM_TRAIN_LR, SSM_TRAIN_LOSS_CHUNK = 4096, 2, 1e-3, 1024
SSM_TRAIN_MESH, SSM_TRAIN_MICRO = {"pod": 2, "data": 2}, 4
SSM_TRAIN_PEAK_GIB = 75.0
# ZeRO-3 against ZeRO-1 at step 0: [22]'s limits on the step losses, the
# gradient norm and the parameters over the whole tree, and
# SSM_ZERO_LEAF_REL_L2 on each leaf, as [25] holds the MoE family.  Stated
# before its first run on the card, from the same comparison of the reduced
# models in bf16 parameters on the CPU (two micro-steps a rank, seq 128):
# the worst leaf 5.5e-4 (the embedding; the shared block's worst 2.5e-4, a
# Mamba2 projection's 9.2e-5, the replicated leaves 0): ZeRO-3 rounds each
# sharded leaf's reduce-scattered gradient to bf16, where ZeRO-1 sums in
# f32, and a bf16 parameter that lands on the other side of a rounding
# boundary moves by an ulp (2^-8 of it).  About 4 times that reading; a
# shard's offset shifted in the shared block's adjoint moves its leaves by
# 9.2e-4 to 1.7e-2 in f32 (tests/test_torch_ssm_train.py), so this limit
# catches the gross faults, and the f32 CPU tests the fine ones.
SSM_ZERO_LEAF_REL_L2 = 2e-3
# The step-0 loss of each run against the same batch's loss with every kernel
# op on its plain version (the SSD op's chunk loop, plain attention), both in
# bf16: the mean of 16384 token losses near ln(vocab).  The limit is about 3x
# the larger of the two models' readings on an H100 (9.8e-5, 1.93e-4).  It is
# a sanity check: at random init a fault moves this mean little, so [28]
# prints planted faults' gaps beside it (``SSM_LOSS_FAULTS``) and requires
# only that the one named by SSM_LOSS_FAULT_CAUGHT be caught; the per-launch
# gates (``ssm_grad_gate``, [27]) are what hold the kernels.
SSM_STEP0_LOSS_ATOL = 6e-4
SSM_LOSS_FAULT_CAUGHT = "ssd_dt_one_late"

# [31] planned training (ROADMAP A10a, A5b): full-width smollm-135m (bf16
# parameters, f32 master state, weights from SEED) on a (pod=2, data=2)
# ThreadMesh with [11]'s batch, 8192 live tokens a step (micro-batch 2 x
# seq 512, two micro-steps a pod under uniform shares), configured by the
# launcher's own code path (``launch.train.plan_run`` on these flags), four
# runs from one init, PLANNED_STEPS steps each on one memorize batch:
#   a: the default, ``--policy auto`` on H100 islands, uniform shares;
#   b: ``--plan auto`` priced on the paper's V100 + W7800 testbed mapped
#      onto the mesh: shares (3, 1), so pod 1 masks two of its three
#      micro-steps, and int8 rows in the large class;
#   c: b with ``--cross-dtype bfloat16`` (A5b; the launcher then prices the
#      rows without a codec, whose all-reduce rows all take the bf16 stage);
#   d: the oracle, b's shares on the legacy facade, hier/xla in f32.
PLANNED_MESH = {"pod": 2, "data": 2}
PLANNED_FLAGS = ["--full-size", "--seq", str(TRAIN_SEQ), "--micro-batch",
                 str(TRAIN_MICRO_BATCH), "--n-micro", "2", "--lr", str(TRAIN_LR)]
PLANNED_RUNS = {"a": [], "b": ["--plan", "auto", "--chips", "v100,w7800"],
                "c": ["--plan", "auto", "--chips", "v100,w7800", "--cross-dtype", "bfloat16"],
                "d": ["--policy", "legacy", "--mode", "hier", "--backend", "xla"]}
# Steps a run (step 0 also keeps the reduced gradients for the gates), and
# the runs whose card time one more step is profiled for (the default's
# until [33] joined, and the planned path's before [32] did): torch.profiler
# triples the wall of these host-bound steps, so the busy share is that
# step's card time over step 1's wall, unprofiled; it adds ~25-35 s a run.
PLANNED_STEPS = 2
PLANNED_PROFILED = ()

# [32] checkpoints, telemetry and the roofline (ROADMAP A10c, A10b's
# checkpoint and observability half): [31]'s run (a) through the launcher,
# CKPT_STEPS traced steps with a checkpoint every CKPT_EVERY, then the steps
# after the first save again, in a fresh program restored from it; the
# reshard targets of (c); and the dry-run cells of (e).
CKPT_STEPS, CKPT_EVERY = 4, 2
RESHARD_ZERO1, RESHARD_ZERO3 = {"pod": 1, "data": 2}, {"pod": 1, "data": 4}
DRYRUN_CELLS = (("smollm-135m", "train_4k", "multi", "auto"),
                ("mamba2-2.7b", "decode_32k", "single", "manual"))
# [33] the elastic control plane (ROADMAP A10b): [31]'s flags on the fused
# rings (hier, pallas: every ring kernel on the path, no codec, so no EF,
# whose residuals would bar a checkpointless recovery) under --elastic
# --watchdog, ELASTIC_STEPS steps a run.  (b) loses its pod where its
# last checkpoint stands, so no step runs twice (4 steps and a loss at 3
# took ~30 s more on a slow host).
ELASTIC_STEPS = 3
ELASTIC_FLAGS = ["--policy", "legacy", "--mode", "hier", "--backend", "pallas", "--elastic",
                 "--watchdog", "--steps", str(ELASTIC_STEPS)]
ELASTIC_RUNS = {"a": ["--zero", "3", "--chaos", "hang:pod0@1;kill:pod1@2"],
                "b": ["--zero", "1", "--ckpt-every", "2", "--chaos", "kill:pod1@2"]}
ELASTIC_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "ring_reduce_scatter",
                   "ring_all_gather")
# Step 0's loss of a against d's: the same 8192 token losses (a's batch
# holds d's live micro-batches, pod 0's third moved to pod 1), summed in
# another grouping over ranks and micro-steps in f32: a few f32 roundings
# of the mean.  b and c run d's shares and batch: their step-0 loss must be
# d's bit for bit (the collectives come after it).
PLANNED_STEP0_LOSS_RTOL = 1e-5
# [34] the VLM (ROADMAP A8b): qwen2-vl-72b at full width cut in depth to
# VLM_LAYERS of its 80 (9.51 B parameters, 19.0 GB of bf16: 8 x 0.878 B in
# the blocks, 2.49 B in the untied embedding and head), its RMSNorm scales
# perturbed from the seed.  Traffic through ``Batcher`` (text-only M-RoPE
# positions), then one prefill on an image block laid out by
# ``mrope_grid``: VLM_GRID_START text tokens, a VLM_GRID_SIDE^2 grid, text.
VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 8
VLM_REQUESTS, VLM_PROMPT, VLM_NEW = 8, 512, 32
VLM_GRID_START, VLM_GRID_SIDE = 64, 16
# [35] the encoder-decoder (ROADMAP A8c): whisper-medium whole (24 + 24
# layers, 0.845 B parameters in its tree), its biases and LayerNorms
# perturbed from the seed: batched transcription of 30-second clips (1500
# frames each, seeded unit normals standing for the stubbed frontend's
# output) with a text prompt.  A prefill launches flash 72 times: the
# encoder's 24 (bidir, 1500 x 1500), the decoder's 24 (causal, 64) and the
# cross-attention's 24 (bidir, 64 x 1500).
ENCDEC_ARCH = "whisper-medium"
ENCDEC_REQUESTS, ENCDEC_PROMPT, ENCDEC_NEW = 8, 64, 32
# [34]'s and [35]'s logits through the kernel against attention pinned to
# plain (last position, rel L2), bf16.  The reference's init reads the
# fan-in of a stacked weight from its layer axis (ROADMAP C5): at std
# 1/sqrt(24) whisper's attention scores had std ~40, the softmax was near
# one-hot and the whole model amplified rounding to O(1) at the logits (0.81
# bf16, 0.73 f32 on an H100, PERF.md).  So both models' stacked projections
# are redrawn at std 1/sqrt(fan-in) (``redraw_projections``): scores of std
# ~1, a softmax spread over many keys, and logits that a rounding
# difference moves in proportion.  Each limit is 3.5 to 4.5 times its
# configuration's own reading on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# qwen2-vl 1.435e-2 over 8 layers, whisper 1.147e-2 over 24 + 24 (plain
# bf16 vs plain f32 1.219e-2).  The f32 gate is F32_LOGITS_REL_TOL (whisper
# read 5.4e-7).
VLM_BF16_LOGITS_REL_TOL = 5e-2
ENCDEC_BF16_LOGITS_REL_TOL = 5e-2
# [36] the VLM trained (ROADMAP A8d): qwen2-vl-72b at full width cut in
# depth to VLM_TRAIN_LAYERS of its 80 (3.37 B parameters, 2.49 B of them
# the untied 152064 x 8192 embedding and head), projections redrawn as
# [34]'s, on a one-rank ThreadMesh under ZeRO-1: bf16 parameters, f32
# gradient sums, f32 master and two moments, 18 bytes a parameter, 60.6
# GB.  Four ranks do not fit one card: under ZeRO-1 they hold four copies of
# the f32 state (36 bytes a parameter over the four: 121 GB), and under
# ZeRO-3 the four ranks' shards add up to the same 60.6 GB on the one card
# while each rank thread also holds the gathered embedding and head (5 GB
# of bf16) and their gradients until the reduce-scatter (about 100 GB in
# all).  Two micro-steps of 1 x VLM_TRAIN_SEQ a step, each sequence an
# image block laid out by ``mrope_grid`` (VLM_TRAIN_GRID_START text tokens,
# a VLM_TRAIN_GRID_SIDE^2 grid, text), VLM_TRAIN_STEPS steps, remat, hier,
# pallas, no codec, loss chunks of TRAIN_LOSS_CHUNK tokens.
VLM_TRAIN_LAYERS, VLM_TRAIN_SEQ, VLM_TRAIN_MICRO, VLM_TRAIN_STEPS = 1, 4096, 2, 2
VLM_TRAIN_GRID_START, VLM_TRAIN_GRID_SIDE = 256, 32
TRAIN_LOSS_CHUNK, FAMILY_TRAIN_LR = 1024, 1e-3
# [36]'s step-0 gate of the sections in training: the gradients of the
# block's attention projections (wq, wk, wv, wo) on the grid positions
# against those on text-only positions, from the same init and tokens.
# Without M-RoPE acting (three equal streams, or the leaf dropped) the two
# are the same bits (the kernels are deterministic); bf16 rounding moves a
# gradient by about the backward's own limit (BWD_LIMITS, 5e-3).  The floor
# is 4 times that, stated before the first run on the card.
VLM_GRID_GRAD_FLOOR = 2e-2
# [37] the encoder-decoder trained (ROADMAP A8d): whisper-medium whole (24 +
# 24 layers, 0.845 B parameters, 15.2 GB of state at 18 bytes a parameter,
# 30.4 GB for four ZeRO-1 ranks), projections redrawn and biases and norms
# perturbed as [35]'s, on a (pod=2, data=2) ThreadMesh, ``uniform_plan(2,
# 4, ENCDEC_TRAIN_CLIPS)``: two micro-steps of ENCDEC_TRAIN_CLIPS clips a
# rank, each clip n_frames (1500) frame embeddings (seeded unit normals in
# bf16, the stubbed frontend's output) and ENCDEC_TRAIN_SEQ decoder tokens
# (whisper's decoder context), 32 clips a step; remat, hier, pallas, no
# codec; ENCDEC_TRAIN_STEPS ZeRO-3 steps, then as many ZeRO-1 steps, from
# one init and on the same batches.
# ZeRO-1's second step runs under torch.profiler (its busy share; its ms a
# step is then step 0's, warm-up in it); ZeRO-3's second step runs
# unprofiled (busy not measured; ms a step its second step's): the steps
# are host-bound and the profiler doubles a step's wall, which the script's
# time limit does not leave room for twice.
ENCDEC_TRAIN_CLIPS, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = 4, 448, 2
# ZeRO-3 against ZeRO-1 at step 0, per leaf (beside [22]'s limits over the
# tree), stated before the first run on the card from [37] itself run at
# reduced whisper's widths in bf16 parameters on the CPU (2 + 4 layers, 64
# or 32 frames, 32 decoder tokens): worst leaf 4.7e-4 and 1.25e-3 (a
# LayerNorm shift of 256 elements).  As SSM_ZERO_LEAF_REL_L2: ZeRO-3
# reduce-scatters each gathered leaf's bf16 gradient in bf16 where ZeRO-1
# sums the ranks' in f32, and Adam's first step moves a parameter by +-lr
# whatever its gradient's size, so an element whose gradient rounds to the
# other sign moves by 2 lr.  About 4 times the larger reading.
ENCDEC_ZERO_LEAF_REL_L2 = 5e-3
# ZeRO-3 against ZeRO-1 at step 0, whisper, from the clipped gradients
# each stage's optimizer took (its first moments) and the parameters after
# the step (``zero_stage_compare``).  ZeRO-3 reduce-scatters each sharded
# leaf's bf16 gradient in bf16 where ZeRO-1 sums in f32: the gradients
# differ by that rounding (ENCDEC_ZERO_GRAD_REL_L2), and the rounding turns
# the sign of the smallest ones (ENCDEC_ZERO_FLIP_SHARE).  Adam's first
# update is u = g / (|g| + eps): +-1 above eps whatever g's size, so a
# flipped element moves 2 lr the other way, and an element with |g| near
# eps moves by an amount its rounding changes.  The parameters' difference
# is then lr ||u3 - u1|| / ||w|| over the tree, up to bf16's rounding of
# the parameters; the reading over that prediction is held to
# ENCDEC_ZERO_PRED_RATIO, stated before the card run that first read it.
# A control run shows what a real fault reads: ZeRO-3's step 0 with rank
# ENCDEC_CONTROL_RANK's gradient zeroed at the fsdp adjoint's
# reduce-scatter (its data lost to every shard of the sharded leaves); it
# must read above all three limits.  On an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md) the parameters read 5.395e-4 over the tree against 5.055e-4
# predicted from the updates (ratio 1.067), the gradients 1.428e-3, the
# flipped share 4.391e-4; the control 2.170e-2, 0.4126 and 0.1220.  The
# limits are about 4 times the readings and 10 to 80 times below the
# control's.  (2 lr sqrt(share) / rms(w), every flip a full step, reads
# 1.407e-3: a flipped gradient is near zero by its nature, often near or
# below eps, where its update is short of a full step.)
ENCDEC_ZERO_PARAM_REL_L2, ENCDEC_ZERO_GRAD_REL_L2, ENCDEC_ZERO_FLIP_SHARE = 2e-3, 5e-3, 2e-3
ENCDEC_ZERO_PRED_RATIO, ENCDEC_CONTROL_RANK = (0.5, 2.0), 3
# [37]'s step-0 gate holds each shape's first backward launch against the
# plain backward with P and dS rounded to bf16 where the kernel rounds them
# (``ref.attention_bwd(..., product_dtype=bfloat16)``): on whisper's own
# inputs the f32 plain backward is not a yardstick for the bf16 route.  Its
# q and k carry a large component common to every position (the LayerNorm
# shifts and biases: |mean| / rms of the rest 15.9 for the cross-attention's
# q), so dK = dS^T Q cancels, and the rounding of dS to bf16 shows at 2.3e-2
# of a row (the cross-attention's dk, worst row) in the kernel, in that
# emulation and in SDPA's backward alike (2.3e-2; its dq 0.23), where
# random inputs read 3.9e-3.  The kernel against the emulation read rel L2
# 5.4e-5 and worst row 1.8e-3 at most over dq, dk, dv (the cross shape, on
# an NVIDIA H100 80GB HBM3 at 700 W, PERF.md): the limits are about 10 and
# 5 times that.
BWD_BF16_POINTS_LIMITS = (5e-4, 1e-2)
# ... and against the f32 plain backward: each of dq, dk, dv on each metric
# within BWD_LIMITS' bf16 limit, or within BWD_SDPA_MARGIN times SDPA's
# backward (``scaled_dot_product_attention`` under autograd) on the same
# inputs against the same f32 plain backward, whichever is larger: the
# kernel may round no worse than the library does.  The margin was stated
# before the card run that first read SDPA there; the inputs are the same
# bits in every run, so SDPA's readings are that run's
# (BWD_ENCDEC_SDPA_F32: (rel L2, worst row) of dq, dk, dv; [37] run alone
# on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  SDPA's backward in the
# whole script is printed, not used: there, after [12] timed it at these
# shapes from CUDA graphs, it read rel L2 1.4 against f32 (not explained).
BWD_SDPA_MARGIN = 1.5
BWD_ENCDEC_SDPA_F32 = {
    ("bidir", 448, 1500): ((3.706e-3, 2.331e-3, 2.336e-3), (2.318e-1, 2.308e-2, 3.968e-3)),
    ("bidir", 1500, 1500): ((3.307e-3, 1.659e-3, 1.660e-3), (2.585e-1, 2.404e-3, 2.411e-3)),
    ("causal", 448, 448): ((5.615e-3, 2.312e-3, 2.257e-3), (4.022e-1, 4.099e-2, 3.471e-3))}


# [34]'s and [35]'s stacked projections and the number of input dims each
# contracts (``wo`` takes heads x head dim): redrawn at std 1/sqrt(fan-in)
PROJ_FAN_IN_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w1": 1, "w2": 1, "w3": 1}
# the leaves of [34]'s and [35]'s models that init leaves at zeros or ones:
# a bias or a norm read from the wrong leaf would not show; each is drawn
# from the seed instead (a bias 0.1 N(0, 1), a norm scale 1 + 0.1 N(0, 1))
BIAS_LEAVES = ("bq", "bv", "bo", "b1", "b2")
NORM_LEAVES = ("ln1", "ln2", "ln3", "enc_norm", "final_norm")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps=20, trials=7, warmup=3):
    """Time of one call on the card: CUDA events around ``reps`` calls made
    back to back, so the queue stays full and the host's time to launch a
    call hides behind the card's work; the median over ``trials``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / reps for s, e in pairs)


def graph_ms(fn, reps=20, stream=None):
    """Device time of one call: ``reps`` calls captured in a CUDA graph and
    replayed (CUDA events, median), so the host's time to launch a call is
    not in it; set beside ``median_ms`` where a call's host time is near its
    device time.  ``stream``: warm up and capture on it (autograd's backward
    runs on its forward's stream, so a backward is captured on that one)."""
    import torch
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    ms = median_ms(graph.replay, reps=3) / reps
    del graph
    return ms


def in_turns(fns, rounds=4, timer=median_ms):
    """Each of ``fns`` ({name: fn}) timed ``rounds`` times by ``timer``, the
    order reversed every other round (A B, B A, ...): {name: [ms, ...]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(timer(fns[n]))
    return out


def mrope_grid(np, B, S, start, side):
    """(3, B, S) int64 M-RoPE positions of a prompt holding one image, laid
    out by qwen2-vl's ``get_rope_index`` rule (arXiv:2409.12191 §2.1): text
    at t = h = w = i before ``start``, then a ``side`` x ``side`` grid of
    vision tokens (t = start; h and w = start + the row and the column),
    then text again from the grid's largest position + 1 (start + side).
    The three streams differ, so M-RoPE's sections act (three equal
    streams are plain RoPE)."""
    n = side * side
    assert start + n <= S, (start, side, S)
    pos = np.tile(np.arange(S, dtype=np.int64), (3, 1))
    cell = np.arange(n)
    pos[0, start:start + n] = start
    pos[1, start:start + n] = start + cell // side
    pos[2, start:start + n] = start + cell % side
    pos[:, start + n:] = start + side + np.arange(S - start - n)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, S)))


def attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype, model_layout):
    """q (B,Hq,Sq,d), k/v (B,Hkv,Sk,d); as transpose views of (B,S,H,d)
    tensors when ``model_layout``, the way the model's prefill passes them."""
    import torch

    def one(H, S):
        if model_layout:
            t = torch.randn(B, S, H, d, generator=gen, device="cuda")
            return t.to(dtype).transpose(1, 2)
        return torch.randn(B, H, S, d, generator=gen, device="cuda").to(dtype)

    return one(Hq, Sq), one(Hkv, Sk), one(Hkv, Sk)


def attention_error(out, want):
    """Errors of ``out`` against ``want`` (..., S, d): max abs, relative L2
    of the whole tensor, and the worst relative L2 of one row."""
    diff = out.float() - want.float()
    ref = want.float()
    rows = diff.norm(dim=-1) / ref.norm(dim=-1)
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / ref.norm()).item(),
            "worst_row_rel_l2": rows.max().item()}


def within_limits(err, dtype_name):
    rel_lim, row_lim = ATTN_LIMITS[dtype_name]
    return err["rel_l2"] <= rel_lim and err["worst_row_rel_l2"] <= row_lim


def format_error(err, dtype_name):
    rel_lim, row_lim = ATTN_LIMITS[dtype_name]
    return (f"max_abs_err {err['max_abs_err']:.3e}  rel_l2 {err['rel_l2']:.3e} "
            f"(limit {rel_lim:.0e})  worst_row {err['worst_row_rel_l2']:.3e} "
            f"(limit {row_lim:.0e})")


def valid_pairs(Sq, Sk, kind, window, k_len):
    import numpy as np
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    valid = (kp < k_len) & (qp >= 0)            # (Sq, Sk) whatever the mask
    if kind == "causal":
        valid = valid & (qp >= kp)
    if window:
        valid = valid & (qp - kp < window)
    return int(valid.sum())


def bound(q, k, v, kind, window, k_len):
    """(bound_ms, bound_by): bytes moved once over the memory rate against
    the valid (q, k) pairs' 4*d operations over the peak rate for the type."""
    B, Hq, Sq, d = q.shape
    Sk = k.shape[2]
    elem = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem      # q, k, v, o
    flops = 4 * d * B * Hq * valid_pairs(Sq, Sk, kind, window, k_len)
    dtype = str(q.dtype).removeprefix("torch.")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(fa, torch):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    failed = []
    for (name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dt,
         model_layout) in KERNEL_CASES:
        dtype = getattr(torch, dt)
        q, k, v = attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype, model_layout)
        kl = Sk if k_len is None else k_len
        out = fa.flash_attention_fwd(q, k, v, kind=kind, window=window, k_len=kl)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window, k_len=kl)
        torch.cuda.synchronize()
        check(out.shape == want.shape and out.dtype == want.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err = attention_error(out, want)
        ok = within_limits(err, dt)
        print(f"  {name:32s} {dt:8s} {format_error(err, dt)}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = {**err, "inputs": (q, k, v), "kind": kind,
                         "window": window, "k_len": kl}
    check(not failed, f"kernel disagrees with its plain version in {failed}")
    return results


def attention_records(torch, tacc, ops, fa, run):
    """Runs ``run()`` with the attention op on a recording variant: each call
    goes through the kernel wrapper and, where it launched the kernel, its
    output is held against the plain version on the same inputs.  Returns
    [(kind, Sq, Sk, d, errors)] in call order."""
    records = []

    def recorded(q, k, v, **kw):
        before = fa.launches
        out = ops.flash_attention(q, k, v, **kw)
        if fa.launches > before:
            want = fa.flash_attention_plain(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                kind=kw["kind"], window=kw.get("window", 0)).transpose(1, 2)
            records.append((kw["kind"], q.shape[1], k.shape[1], q.shape[3],
                            attention_error(out, want)))
        return out

    tacc.register("attention", "cuda_layer_check")(recorded)
    tacc.set_platform("cuda_layer_check")
    try:
        with torch.inference_mode():
            run()
    finally:
        tacc.set_platform(None)
    return records


def worst_by_shape(records, dtype_name, expected):
    """The worst errors of each (kind, Sq, Sk, d) of ``records``: every
    record within ``ATTN_LIMITS``, and each shape launched ``expected[key]``
    times (once a layer)."""
    out, counts = {}, Counter()
    for kind, Sq, Sk, d, err in records:
        key = f"{kind}_sq{Sq}_sk{Sk}_d{d}"
        counts[key] += 1
        out[key] = {k: max(v, out.get(key, {}).get(k, 0.0)) for k, v in err.items()}
        check(within_limits(err, dtype_name),
              f"{key}: the kernel disagrees with its plain version on a layer's inputs: "
              + format_error(err, dtype_name))
    for key, worst in out.items():
        print(f"  per layer, {key} ({counts[key]} layers), worst: "
              f"{format_error(worst, dtype_name)}  ok")
    check(dict(counts) == expected,
          f"kernel launches by shape {dict(counts)}, expected {expected}")
    return out


def last_logits_pinned(torch, tacc, prefill, plain, vocab):
    """Last-position f32 logits over the ``vocab`` real tokens (the padded
    vocab's -1e30 would overflow a norm) of ``prefill()``, attention on the
    kernel route or pinned to the plain variant."""
    tacc.set_platform("cpu" if plain else None)
    try:
        with torch.inference_mode():
            return prefill()[0][:, -1, :vocab].float()
    finally:
        tacc.set_platform(None)


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def served_model(torch, build, cfg):
    """(model, params, init seconds) of ``cfg`` at full width: weights from
    the seed, the stacked projections redrawn (``redraw_projections``),
    biases and norms perturbed (``perturb_leaves``)."""
    model = build(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_proj = redraw_projections(torch, params, SEED + 2)
    n = perturb_leaves(torch, params, SEED + 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    print(f"  {cfg.name}: {model.n_params() / 1e9:.4f}B parameters in the tree (the config's "
          f"analytic count {cfg.n_params() / 1e9:.4f}B), {n_proj} stacked projections "
          f"redrawn at std 1/sqrt(fan-in), {n} bias and norm leaves perturbed; "
          f"init {init_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, params, init_s


def phase_layers(torch, tacc, ops, fa, model, params, batch):
    """The kernel on the inputs each layer of a real prefill gives it, against
    its plain version on the same inputs: the bf16 check at full depth that
    the model's amplification of rounding cannot blur.  One launch a layer."""
    cfg, S = model.cfg, batch["tokens"].shape[1]
    worst = worst_by_shape(
        attention_records(torch, tacc, ops, fa, lambda: model.prefill(params, batch)),
        cfg.dtype, {f"causal_sq{S}_sk{S}_d{cfg.head_dim_}": cfg.n_layers})
    return next(iter(worst.values()))


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def phase_serve(torch, np, fa, ops, tacc, get_config, build, engine):
    cfg = get_config(ARCH)
    dev = torch.device("cuda")
    model = build(cfg)
    max_len = PROMPT_LEN + MAX_NEW
    progs = engine.make_serve_programs(model, seq_len=PROMPT_LEN,
                                       max_len=max_len, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(N_REQUESTS)]
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}, {model.n_params() / 1e6:.1f}M params")

    finite = [torch.ones((), dtype=torch.bool, device=dev)]

    def watched(fn):
        def run(*args):
            logits, cache = fn(*args)
            finite[0] = finite[0] & torch.isfinite(logits).all()
            return logits, cache
        return run

    watched_progs = dataclasses.replace(progs, prefill_fn=watched(progs.prefill_fn),
                                        decode_fn=watched(progs.decode_fn))

    def requests(max_new):
        return [engine.Request(i, p, max_new) for i, p in enumerate(prompts)]

    def batcher():
        return engine.Batcher(watched_progs, params, batch_slots=N_REQUESTS,
                              prompt_len=PROMPT_LEN, max_len=max_len)

    batcher().run(requests(2))            # warm-up: cuBLAS, kernel load
    torch.cuda.synchronize()

    fa.launches = 0
    t0 = time.perf_counter()
    done = batcher().run(requests(MAX_NEW))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = fa.launches

    n_batches = -(-N_REQUESTS // N_REQUESTS)
    check(launches == cfg.n_layers * n_batches,
          f"flash kernel launched {launches} times in the serve run, "
          f"expected {cfg.n_layers} per prefill batch x {n_batches}")
    check(len(done) == N_REQUESTS and all(len(r.out) == MAX_NEW for r in done),
          "not every request got its tokens")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out),
          "a token is outside the vocab")
    check(bool(finite[0]), "non-finite logits in the serve run")
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests, {n_tok} tokens in {serve_s:.3f} s; "
          f"flash kernel launches {launches} "
          f"({cfg.n_layers} layers x {n_batches} prefill batch)")

    # The kernel route against attention pinned to the plain variant: per
    # layer on the layer's own inputs, then at the logits, in bf16 and with
    # the same weights in f32 (BF16_LOGITS_REL_TOL says why both).
    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    batch = {"tokens": toks}
    layers = phase_layers(torch, tacc, ops, fa, model, params, batch)

    def last_logits(m, p, plain):
        return last_logits_pinned(torch, tacc, lambda: m.prefill(p, batch), plain, cfg.vocab)

    lk = last_logits(model, params, plain=False)
    lp = last_logits(model, params, plain=True)
    m32 = build(dataclasses.replace(cfg, dtype="float32"))
    p32 = _tree_map(lambda t: t.float(), params)
    lf = last_logits(m32, p32, plain=True)
    lfk = last_logits(m32, p32, plain=False)
    for t in (lk, lp, lf, lfk):
        check(bool(torch.isfinite(t).all()), "non-finite prefill logits")
    agree = {"bf16_kernel_vs_plain": _rel_l2(lk, lp),
             "bf16_plain_vs_f32": _rel_l2(lp, lf),
             "bf16_kernel_vs_f32": _rel_l2(lk, lf),
             "f32_kernel_vs_plain": _rel_l2(lfk, lf),
             "bf16_same_argmax": (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()}
    print("  prefill last-position logits, rel L2: " + ", ".join(
        f"{k} {v:.3e}" for k, v in agree.items()))
    check(agree["bf16_kernel_vs_plain"] <= BF16_LOGITS_REL_TOL,
          f"bf16 kernel route is {agree['bf16_kernel_vs_plain']:.3e} from the plain "
          f"route, beyond {BF16_LOGITS_REL_TOL}")
    check(agree["f32_kernel_vs_plain"] <= F32_LOGITS_REL_TOL,
          f"f32 kernel route disagrees: {agree['f32_kernel_vs_plain']:.3e}")

    # serving times on the host clock, each ending in a synchronise
    def timed(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)

    prefill_ms = timed(lambda: progs.prefill_fn(params, batch), 5)
    _, cache = progs.prefill_fn(params, batch)
    cur = toks[:, -1:]

    def step():
        nonlocal cache
        _, cache = progs.decode_fn(params, cache, cur)

    decode_ms = timed(step, MAX_NEW - 2)

    def measure_busy():
        """Run last: the profiler's tracing may slow what runs after it."""
        nonlocal cache
        busy_prefill = device_busy_share(torch, lambda: progs.prefill_fn(params, batch), 1)
        _, cache = progs.prefill_fn(params, batch)
        busy_decode = device_busy_share(torch, step, MAX_NEW // 2)
        print(f"  card busy share (torch.profiler kernel time / host wall time): "
              f"prefill {busy_prefill}, decode {busy_decode}")
        return {"device_busy_prefill": busy_prefill, "device_busy_decode": busy_decode}

    serve = {"arch": cfg.name, "requests": len(done), "prompt_len": PROMPT_LEN,
             "new_tokens_per_request": MAX_NEW, "prefill_ms": prefill_ms,
             "decode_ms_per_token": decode_ms, "serve_s": serve_s,
             "tokens_per_s": n_tok / serve_s, "flash_launches": launches,
             "layer_worst_error": layers, "prefill_logits_rel_l2": agree}
    print(f"  prefill {prefill_ms:.3f} ms (batch {N_REQUESTS} x {PROMPT_LEN}), "
          f"decode {decode_ms:.3f} ms per step (batch {N_REQUESTS}), "
          f"{n_tok / serve_s:.1f} tokens/s end to end")
    return serve, launches, measure_busy


def device_busy_share(torch, fn, reps):
    """Kernel time on the card over host wall time for ``reps`` calls of
    ``fn``, from a torch.profiler trace of CUDA activity only (kernels of one
    stream do not overlap, so their sum is the busy time).  None when the
    trace holds no kernel: then the share is not measured."""
    return device_profile(torch, fn, reps)[0]


def device_profile(torch, fn, reps):
    """(``device_busy_share``'s share, {kernel name: card us summed over
    the trace}) for ``reps`` calls of ``fn``, from one torch.profiler trace
    of CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    kernel_us = sum(by_name.values())
    return (kernel_us / wall_us if kernel_us > 0 else None), by_name


def kernel_label(name, width=72):
    """A profiler kernel name without its return type and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:width]


def phase_times(fa, torch, case):
    """Kernel, plain and SDPA times (CUDA events, medians) of one flash case,
    with its bound and errors.  SDPA takes no window: where the window binds
    (window < Sq) it gets the same pairs as an explicit boolean mask, which
    sends it to a kernel other than its flash one, and is labelled so."""
    import torch.nn.functional as F
    q, k, v = case["inputs"]
    kind, window, k_len = case["kind"], case["window"], case["k_len"]
    Sq, Sk = q.shape[2], k.shape[2]
    kernel_ms = median_ms(lambda: fa.flash_attention_fwd(
        q, k, v, kind=kind, window=window, k_len=k_len))
    plain_ms = median_ms(lambda: fa.flash_attention_plain(
        q, k, v, kind=kind, window=window, k_len=k_len), reps=10)
    if window and window < Sq:
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Sk, device=q.device)[None, :]
        mask = (kp < k_len) & (qp - kp < window)
        if kind == "causal":
            mask = mask & (qp >= kp)
        library = "sdpa with a boolean mask"
        library_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), reps=5)
    else:
        library = "sdpa"
        library_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kind == "causal", enable_gqa=True))
    kernel_graph_ms = graph_ms(lambda: fa.flash_attention_fwd(
        q, k, v, kind=kind, window=window, k_len=k_len))
    library_graph_ms = None if window and window < Sq else graph_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=kind == "causal",
                                               enable_gqa=True))
    bound_ms, bound_by = bound(q, k, v, kind, window, k_len)
    # the wrapper's copy of q, k, v into rows padded to a multiple of 8 (d
    # 100), which the kernel time above includes
    copy_ms = None if all(fa._aligned(t) for t in (q, k, v)) else median_ms(
        lambda: [fa.tma_ready(t) for t in (q, k, v)])
    print(f"  flash_attention_fwd at {tuple(q.shape)} / {tuple(k.shape)} "
          f"{str(q.dtype).removeprefix('torch.')} {kind} window {window}: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library ({library}) "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); kernel / bound "
          f"{kernel_ms / bound_ms:.2f}, kernel / library {kernel_ms / library_ms:.2f}; "
          f"replayed in a CUDA graph: kernel {kernel_graph_ms:.4f} ms, library "
          + ("none" if library_graph_ms is None else f"{library_graph_ms:.4f} ms")
          + ("" if copy_ms is None else f"; of the kernel time, the wrapper's copy of q, k, v "
                                        f"into padded rows {copy_ms:.4f} ms"))
    return {"shape": [list(q.shape), list(k.shape)], "kind": kind, "window": window,
            "copy_ms": copy_ms,
            "ms": kernel_ms, "plain_ms": plain_ms, "library": library,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "graph_ms": kernel_graph_ms, "library_graph_ms": library_graph_ms,
            **{key: case[key] for key in ("max_abs_err", "rel_l2", "worst_row_rel_l2")}}


def host_us_per_call(fa, torch, case, calls=200):
    """Host time of one ``flash_attention_fwd`` call (checks, allocations,
    four tensor maps, the launch), enqueued back to back: the host clock
    over ``calls`` calls, without a synchronise inside."""
    q, k, v = case["inputs"]
    kw = {key: case[key] for key in ("kind", "window", "k_len")}
    for _ in range(10):
        fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fa.flash_attention_fwd(q, k, v, **kw)
    host_us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return host_us


# ---------------------------------------------------------------------------
# Collective path: ring kernels, full-width tree_all_reduce, kernel times
# ---------------------------------------------------------------------------

def ring_case_inputs(torch, gen, kind, n, n_rings, in_dtype, c=RING_C):
    """Per-rank inputs of one launch: rings of length n, unit normals."""
    R = n * n_rings
    rings = [list(range(i * n, (i + 1) * n)) for i in range(n_rings)]
    shape = (n, c) if kind == "rs" else (c,)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, in_dtype))
          for _ in range(R)]
    return xs, rings


def run_ring_case(torch, ring_dma, case, xs, rings):
    """(kernel outputs, plain outputs) of one case."""
    kind, n, _, d, k, _, w = case
    if kind == "rs":
        kw = dict(direction=d, n_stripes=k, wire_dtype=getattr(torch, w))
        return (ring_dma.reduce_scatter_fused(xs, rings, **kw),
                ring_dma.reduce_scatter_fused_plain(xs, rings, **kw))
    kw = dict(direction=d, n_stripes=k)
    return (ring_dma.all_gather_fused(xs, rings, **kw),
            ring_dma.all_gather_fused_plain(xs, rings, **kw))


def bitwise_error(outs, wants):
    """(all equal bit for bit, largest absolute difference)."""
    import torch
    same = all(o.shape == w.shape and o.dtype == w.dtype and torch.equal(o, w)
               for o, w in zip(outs, wants))
    diff = max((o.double() - w.double()).abs().max().item() for o, w in zip(outs, wants))
    return same, diff


def phase_ring_kernels(torch, ring_dma, cr):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failed = []
    worst = {"ring_reduce_scatter": 0.0, "ring_all_gather": 0.0, "collective_reduce": 0.0}
    for case in RING_CASES:
        kind, n, n_rings, d, k, dt, w = case
        xs, rings = ring_case_inputs(torch, gen, kind, n, n_rings, dt)
        outs, wants = run_ring_case(torch, ring_dma, case, xs, rings)
        torch.cuda.synchronize()
        same, diff = bitwise_error(outs, wants)
        extra = ""
        if kind == "rs" and dt == w == "float32":
            # and both against the float64 sum over each ring's ranks
            want = [sum(xs[r].double() for r in ring)[ring.index(rk)]
                    for ring in rings for rk in ring]
            rel = max(((o.double() - t).norm() / t.norm()).item()
                      for o, t in zip(outs, want))
            extra = f"  rel_l2 vs f64 sum {rel:.2e}"
            same = same and rel <= COLL_F32_REL_TOL
        name = (f"{kind} n={n} rings={n_rings} dir={d:+d} stripes={k} in={dt}"
                + (f" wire={w}" if w else ""))
        key = "ring_reduce_scatter" if kind == "rs" else "ring_all_gather"
        worst[key] = max(worst[key], diff)
        print(f"  {name:62s} max_abs_err {diff:.3e}{extra}  {'ok' if same else 'FAIL'}")
        if not same:
            failed.append(name)
    for inc_dt, length in REDUCE_CASES:
        acc = torch.randn(length, generator=gen, device="cuda")
        inc = torch.randn(length, generator=gen, device="cuda").to(getattr(torch, inc_dt))
        out, want = cr.collective_reduce(acc, inc), cr.collective_reduce_plain(acc, inc)
        same, diff = bitwise_error([out], [want])
        name = f"collective_reduce f32 + {inc_dt} n={length}"
        worst["collective_reduce"] = max(worst["collective_reduce"], diff)
        print(f"  {name:62s} max_abs_err {diff:.3e}  {'ok' if same else 'FAIL'}")
        if not same:
            failed.append(name)
    check(not failed, f"ring kernels disagree with their plain versions in {failed}")
    return len(RING_CASES) + len(REDUCE_CASES), worst


def grad_shapes(get_config, build):
    """Leaf shapes of full-width smollm-135m's parameter tree."""
    from repro_torch.models.common import tree_map_meta
    model = build(get_config(COLL_ARCH))
    return model, tree_map_meta(lambda m: tuple(m.shape), model.abstract_params())


def _leaves(tree):
    if isinstance(tree, dict):
        return [lf for k in sorted(tree) for lf in _leaves(tree[k])]
    return [tree]


def rank_grads(torch, shapes, r):
    """Rank r's f32 gradient tree, values from a generator seeded for r."""
    gen = torch.Generator(device="cuda").manual_seed(COLL_SEED + r)
    return _tree_map(lambda shp: torch.randn(shp, generator=gen, device="cuda"), shapes)


def make_grads(torch, shapes, R):
    """Per-rank f32 gradient trees (``rank_grads`` of each rank)."""
    return [rank_grads(torch, shapes, r) for r in range(R)]


def tree_rel_err(torch, got, grads):
    """Relative L2 of ``got`` against the float64 sum of every rank's tree."""
    num = den = 0.0
    for i, g in enumerate(_leaves(got)):
        want = sum(_leaves(t)[i].double() for t in grads)
        num += (g.double() - want).norm().item() ** 2
        den += want.norm().item() ** 2
    return (num / den) ** 0.5


def trees_equal(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def phase_collectives(torch, hetccl, tacc, mesh_mod, ring_dma, cr, get_config, build):
    model, shapes = grad_shapes(get_config, build)
    n_params = model.n_params()
    print(f"  gradient tree of {COLL_ARCH}: {n_params} parameters, "
          f"{n_params * 4 / 1e6:.1f} MB of f32 per rank")
    results = {"n_params": n_params, "bytes_per_rank": n_params * 4}

    def run(m, grads, mode, backend, **kw):
        cfg = hetccl.HetCCLConfig(mode=mode, backend=backend, **kw)
        outs = m.run(lambda t: hetccl.tree_all_reduce(t, cfg), grads)
        torch.cuda.synchronize()
        check(all(trees_equal(torch, outs[0], o) for o in outs[1:]),
              f"{mode}/{backend}: the ranks' results differ")
        return outs[0]

    m22 = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    grads = make_grads(torch, shapes, m22.size)
    run(m22, grads, "hier", "pallas")                 # warm-up: kernels, scratch, allocator
    run(m22, grads, "hier", "xla")

    cr.launches = ring_dma.rs_launches = ring_dma.ag_launches = 0
    main = run(m22, grads, "hier", "pallas")
    launches = {"ring_reduce_scatter": ring_dma.rs_launches,
                "ring_all_gather": ring_dma.ag_launches}
    results["hier_pallas_tree"] = [t.cpu() for t in _leaves(main)]     # [38]'s reference
    print(f"  (pod=2, data=2) hier/pallas launches per tree_all_reduce: {launches}")
    check(launches["ring_reduce_scatter"] > 0 and launches["ring_all_gather"] > 0,
          "the fused ring kernels did not run on the collective path")

    readings = {}
    for mode in ("hier", "pipelined"):
        ref = run(m22, grads, mode, "xla")
        got = main if mode == "hier" else run(m22, grads, mode, "pallas")
        same = trees_equal(torch, got, ref)
        rel = {b: tree_rel_err(torch, t, grads) for b, t in (("xla", ref), ("pallas", got))}
        ok = same and max(rel.values()) <= COLL_F32_REL_TOL
        print(f"  (pod=2, data=2) {mode:9s} f32: pallas == xla bit for bit: {same}; "
              f"rel L2 vs f64 sum: xla {rel['xla']:.3e}, pallas {rel['pallas']:.3e} "
              f"(limit {COLL_F32_REL_TOL:.0e})  {'ok' if ok else 'FAIL'}")
        check(ok, f"{mode}: pallas and xla disagree or miss the f64 sum")
        readings[f"{mode}_f32_rel_l2"] = rel
        del ref, got

    bf = run(m22, grads, "hier", "pallas", cross_dtype=torch.bfloat16)
    rel_bf = tree_rel_err(torch, bf, grads)
    del bf
    print(f"  (pod=2, data=2) hier/pallas bf16 cross stage: rel L2 vs f64 sum {rel_bf:.3e} "
          f"(limit {COLL_BF16_REL_TOL:.0e})  {'ok' if rel_bf <= COLL_BF16_REL_TOL else 'FAIL'}")
    check(rel_bf <= COLL_BF16_REL_TOL, "bf16 cross stage beyond its limit")
    readings["hier_bf16_rel_l2"] = rel_bf

    # the emulated schedule on the card: ppermute hops + collective_reduce
    prev = {op: tacc.get_default(op) for op in ring_dma.SCHEDULE_OPS}
    for op in ring_dma.SCHEDULE_OPS:
        tacc.set_default(op, "emulated")
    try:
        cr.launches = ring_dma.rs_launches = ring_dma.ag_launches = 0
        emu = run(m22, grads, "hier", "pallas")
        reduce_launches = cr.launches
        fused_in_pinned = ring_dma.rs_launches + ring_dma.ag_launches
    finally:
        for op, variant in prev.items():
            tacc.set_default(op, variant)
    same = trees_equal(torch, emu, main)
    print(f"  rings pinned to the emulated schedule: collective_reduce launches "
          f"{reduce_launches}, fused launches {fused_in_pinned}; equal to the fused "
          f"run bit for bit: {same}  {'ok' if same else 'FAIL'}")
    check(same and reduce_launches > 0 and fused_in_pinned == 0,
          "the emulated schedule on the card disagrees or did not launch collective_reduce")
    launches["collective_reduce"] = reduce_launches
    del emu, main

    # host-clock times, backends in turns, then the card's busy share
    def timed(mode, backend):
        cfg = hetccl.HetCCLConfig(mode=mode, backend=backend)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m22.run(lambda g: hetccl.tree_all_reduce(g, cfg), grads)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    times = {}
    for mode in ("hier", "pipelined"):
        ms = {"xla": [], "pallas": []}
        for _ in range(COLL_TIMING_REPS):
            for b in ("xla", "pallas"):
                ms[b].append(timed(mode, b))
        times[mode] = {b: statistics.median(v) for b, v in ms.items()}
    busy = {}
    for b in ("xla", "pallas"):
        cfg = hetccl.HetCCLConfig(mode="hier", backend=b)
        busy[b] = device_busy_share(
            torch, lambda: m22.run(lambda g: hetccl.tree_all_reduce(g, cfg), grads), 1)
    print(f"  tree_all_reduce host-clock ms (median of {COLL_TIMING_REPS}, backends in "
          f"turns): {json.dumps(times)}; card busy share hier: {json.dumps(busy)}")
    results.update(readings=readings, launches=launches, host_ms=times, busy=busy)

    buckets = hetccl._make_buckets(_leaves(grads[0]), hetccl.HetCCLConfig().bucket_bytes)
    big = max(sum(_leaves(grads[0])[i].numel() for i in b) for b in buckets)
    results["largest_bucket_elems"] = big
    del grads

    m41 = mesh_mod.ThreadMesh({"pod": 4, "data": 1}, device="cuda")
    grads = make_grads(torch, shapes, m41.size)
    ring_dma.rs_launches = 0
    got = run(m41, grads, "hier", "pallas")
    rs4 = ring_dma.rs_launches
    ref = run(m41, grads, "hier", "xla")
    same = trees_equal(torch, got, ref)
    rel = tree_rel_err(torch, got, grads)
    ok = same and rel <= COLL_F32_REL_TOL and rs4 > 0
    print(f"  (pod=4, data=1) hier f32: {rs4} fused reduce-scatter launches; pallas == xla "
          f"bit for bit: {same}; rel L2 vs f64 sum {rel:.3e}  {'ok' if ok else 'FAIL'}")
    check(ok, "(pod=4, data=1): pallas and xla disagree or miss the f64 sum")
    results["pod4_rel_l2"] = rel
    return results


def phase_collective_times(torch, ring_dma, cr, bench_codec, big):
    """Each collective kernel at the largest bucket's shape in the (pod=2,
    data=2) hier run: ranks 4, rings of 2 over "pod", c = bucket / 2."""
    R, n = 4, 2
    c = big // n
    rings = [[0, 2], [1, 3]]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.randn(n, c, generator=gen, device="cuda") for _ in range(R)]
    ag_in = [torch.randn(c, generator=gen, device="cuda") for _ in range(R)]
    out = {}

    def rs(check=False):
        return ring_dma.reduce_scatter_fused(xs, rings, check=check)

    def ag(check=False):
        return ring_dma.all_gather_fused(ag_in, rings, check=check)

    # f32 throughout: input, wire, output 4 bytes
    rs_bytes = R * n * c * 4 + R * c * 4
    ag_bytes = R * c * 4 + R * n * c * 4
    wire_bytes = (R // n) * n * (n - 1) * c * 4
    # what the all-gather kernel itself moves per rank: step 0 reads the
    # chunk once and writes the own row and the downstream slot; each later
    # step forwards a slot (read c, write c); every step copies a slot out
    # (read c, write c): (2n - 2) c read and (2n - 1) c written, 5c at n = 2
    ag_traffic = R * (4 * n - 3) * c * 4
    # the reduce-scatter's: every step reads the upstream's payload and the
    # own chunk and writes the own partial or the output, 3 (n - 1) c per
    # rank; storing the payload into a receive slot, read back by the
    # receiver, moved 5 (n - 1) c
    rs_traffic = R * 3 * (n - 1) * c * 4
    rs_slot_traffic = R * 5 * (n - 1) * c * 4
    order = [r for ring in rings for r in ring]          # the ranks ring by ring
    stacked = torch.stack([xs[r] for r in order]).view(R // n, n, n, c)
    ag_stack = torch.stack([ag_in[r] for r in order]).view(R // n, 1, n, c)
    for name, fn, plain, lib, nbytes in (
            ("ring_reduce_scatter", rs,
             lambda: ring_dma.reduce_scatter_fused_plain(xs, rings),
             lambda: stacked.sum(1), rs_bytes),
            ("ring_all_gather", ag,
             lambda: ring_dma.all_gather_fused_plain(ag_in, rings),
             lambda: ag_stack.expand(R // n, n, n, c).contiguous(), ag_bytes)):
        fn(check=True)
        ms = median_ms(fn)
        ring_dma.check_errors()
        out[name] = {"ms": ms, "plain_ms": median_ms(plain, reps=3, trials=3, warmup=1),
                     "library_ms": median_ms(lib), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "wire_bound_ms": wire_bytes / HBM_BYTES_PER_S * 1e3,
                     "shape": f"R={R} n={n} c={c} f32"}
    t = out["ring_all_gather"]
    t["traffic_bytes"] = ag_traffic
    t["traffic_ms"] = ag_traffic / HBM_BYTES_PER_S * 1e3
    print(f"  ring_all_gather's own traffic: (4n - 3) c x 4 B x R = {ag_traffic / 1e9:.4f} GB, "
          f"{t['traffic_ms']:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, against the bound's "
          f"{ag_bytes / 1e9:.4f} GB; kernel at {ag_traffic / t['ms'] / 1e9:.3f} TB/s of its "
          f"own traffic; {ring_dma._scratch[('cuda:0', R)].ctas} CTAs per rank")
    t = out["ring_reduce_scatter"]
    t["traffic_bytes"] = rs_traffic
    t["traffic_ms"] = rs_traffic / HBM_BYTES_PER_S * 1e3
    print(f"  ring_reduce_scatter's own traffic: 3 (n - 1) c x 4 B x R = {rs_traffic / 1e9:.4f} "
          f"GB (5 (n - 1) c through receive slots: {rs_slot_traffic / 1e9:.4f} GB), "
          f"{t['traffic_ms']:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s, against the bound's "
          f"{rs_bytes / 1e9:.4f} GB; kernel at {rs_traffic / t['ms'] / 1e9:.3f} TB/s of its "
          f"own traffic")
    m = c // 2                                 # one stream of a chunk, the emulated step
    acc = torch.randn(m, generator=gen, device="cuda")
    inc = torch.randn(m, generator=gen, device="cuda")
    # the kernel against torch.add in turns, 8 rounds, L2 cold before each
    # reading, back to back and from a CUDA graph (bench_codec's protocol),
    # with f32 and with bf16 incoming
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reader = bench_codec.ColdReader()
        rs = {dt: bench_codec.bench_reduce(reader, cr, gen, 8, elems=m,
                                           inc_dtype=getattr(torch, dt))
              for dt in ("float32", "bfloat16")}
    torch.cuda.current_stream().wait_stream(side)
    r = rs["float32"]
    med, reads = r["median_ms"], r["readings"]
    out["collective_reduce"] = {
        "ms": med["kernel"]["stream"], "library_ms": med["torch.add"]["stream"],
        "graph_ms": med["kernel"]["graph"], "library_graph_ms": med["torch.add"]["graph"],
        "ms_readings": reads["kernel"]["stream"],
        "library_ms_readings": reads["torch.add"]["stream"],
        "graph_ms_readings": reads["kernel"]["graph"],
        "library_graph_ms_readings": reads["torch.add"]["graph"],
        "host_us_per_call": r["host_us"]["kernel"],
        "plain_ms": median_ms(lambda: cr.collective_reduce_plain(acc, inc)),
        "bound_ms": r["bound_ms"], "bound_by": "bytes", "shape": f"n={m} f32 + f32",
        "by_incoming": {dt: {"bound_ms": v["bound_ms"], "median_ms": v["median_ms"],
                             "readings": v["readings"]} for dt, v in rs.items()}}
    for dt, v in rs.items():
        check(v["same_bits"], f"collective_reduce at {dt} incoming differs from the plain version")
        for name, modes in v["readings"].items():
            for mode, ms in modes.items():
                print(f"  collective_reduce {dt} incoming, {name}, {mode}: median "
                      f"{statistics.median(ms):.5f} ms, readings {min(ms):.5f}-{max(ms):.5f} "
                      f"(8 rounds in turns, L2 cold; bound {v['bound_ms']:.5f} ms)")
    for name, t in out.items():
        print(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes)"
              + (f", ring wire bytes alone {t['wire_bound_ms']:.4f} ms" if "wire_bound_ms" in t
                 else ""))
    return out


# ---------------------------------------------------------------------------
# Training path: codec kernels, flash backward, full-width ZeRO-1 steps
# ---------------------------------------------------------------------------

def same_bits(a, b):
    """Equal bit for bit (floating point: NaN where NaN, the other bits
    equal); ``b`` may lie on another device."""
    import torch
    b = b.to(a.device)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    word = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(a[~na].view(word),
                                                          b[~nb].view(word)))


def quant_inputs(torch, gen, rows, fill):
    x = torch.randn(rows, 512, generator=gen, device="cuda")
    if fill == "zeros":
        x[::3] = 0.0
    elif fill == "half":                 # absmax 127 -> scale 1; k + 0.5 values
        x = (torch.arange(rows * 512, device="cuda") % 254 - 127).float().reshape(rows, 512) + 0.5
        x[:, 0] = 127.0
    elif fill == "nan":
        x[::7, 11] = float("nan")
    else:                                # chunks at scales from 1e-3 to 1e3
        x = x * torch.exp(torch.randn(rows, 1, generator=gen, device="cuda") * 3)
    return x


def phase_quant_kernels(torch, quant, ref, hop_rows, leaf_rows):
    """Both codec kernels against their plain versions, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failed, n = [], 0
    for name, rows, fill in QUANT_ROWS + [("bucket_hop", hop_rows, "randn"),
                                          ("largest_leaf", leaf_rows, "randn")]:
        x = quant_inputs(torch, gen, rows, fill)
        acc = torch.randn(rows, 512, generator=gen, device="cuda")
        odd = x.reshape(-1)[1:1 + 509 * max(rows - 1, 1)].reshape(-1, 509)   # unaligned
        for label, xx, aa in ((name, x, acc),
                              (name + "_odd509", odd, acc.reshape(-1)[3:3 + odd.numel()]
                               .reshape(odd.shape))):
            c, sc = quant.wire_quantize_int8(xx)
            c2, sc2 = ref.wire_quantize(xx)
            d = quant.wire_dequant_accum_int8(aa, c, sc)
            d2 = ref.wire_dequant_accum(aa, c, sc)
            torch.cuda.synchronize()
            ok = same_bits(c, c2) and same_bits(sc, sc2) and same_bits(d, d2)
            n += 1
            print(f"  {label:28s} ({tuple(xx.shape)[0]} x {xx.shape[1]}) codes, scales, "
                  f"dequantize-accumulate bit for bit: {ok}  {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(label)
    check(not failed, f"codec kernels disagree with their plain versions in {failed}")
    return n


def bwd_error(got, want):
    """Max abs, relative L2, and the worst row's error over the larger of its
    own norm and the mean row norm, of (..., S, d)."""
    diff = got.float() - want.float()
    rows = want.float().norm(dim=-1)
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / want.float().norm()).item(),
            "worst_row": (diff.norm(dim=-1) / rows.clamp(min=rows.mean())).max().item()}


def phase_flash_bwd(torch, fa, ref):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    failed, results = [], {}
    for case in BWD_CASES:
        name, dt = case[0], case[10]
        worst, ok, (q, k, v, o, do, lse, kw) = flash_bwd_case(torch, fa, ref, gen, case)
        lse_err = (lse - ref.attention_lse(q, k, **kw)).abs().max().item()
        ok = ok and lse_err <= 1e-4
        rel_lim, row_lim = BWD_LIMITS[dt]
        print(f"  {name:32s} {dt:8s} Sq {q.shape[2]:5d} Sk {k.shape[2]:5d} dq/dk/dv worst: "
              f"max_abs_err {worst['max_abs_err']:.3e} rel_l2 {worst['rel_l2']:.3e} (limit "
              f"{rel_lim:.0e}) worst_row {worst['worst_row']:.3e} (limit {row_lim:.0e}); lse "
              f"max abs err {lse_err:.2e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = {**worst, "lse_err": lse_err,
                         "inputs": (q, k, v, o, do, lse), "kw": kw}
        gc.collect()
        torch.cuda.empty_cache()
    check(not failed, f"flash backward disagrees with its plain version in {failed}")
    return results


def train_counts(n_layers, n_micro, R, n_leaves, n_buckets, n_pods):
    """Launches one ZeRO-1 step implies on R ranks (remat: the forward runs
    twice per layer).  The codec per rank: error feedback compresses each
    leaf (1 quantize, 1 decode); each bucket's quantized ring reduce-scatter
    quantizes and decodes both streams on each hop, its all-gather encodes
    once and decodes its own chunk and each hop's; each parameter's
    all-gather the same."""
    hops = n_pods - 1
    q = n_leaves + n_buckets * (2 * hops + 1) + n_leaves
    dq = n_leaves + n_buckets * (2 * hops + 1 + hops) + n_leaves * (1 + hops)
    return {"flash_attention_fwd": 2 * n_layers * n_micro * R,
            "flash_attention_bwd": n_layers * n_micro * R,
            "quant_int8": q * R, "dq_accum_int8": dq * R}


def phase_train(torch, np, get_config, build, mesh_mod, hetccl, counters, bench_codec):
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import quant
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_train_program
    cfg = get_config(ARCH)
    model = build(cfg)
    m = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 4, micro_batch=TRAIN_MICRO_BATCH)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    batch = synthetic_batch(SEED, 0, plan.n_micro_max, plan.micro_batch * m.size,
                            TRAIN_SEQ, cfg.vocab)
    n_tokens = int(np.prod(batch["tokens"].shape))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, bf16 params, f32 master "
          f"state; mesh {m.shape}, plan {plan.micro_per_pod} micro-steps of {plan.micro_batch} x "
          f"{TRAIN_SEQ} per rank, {n_tokens} tokens per step; remat on")
    progs = {name: make_train_program(model, m, RunConfig(collective_mode="hier",
                                                          learning_rate=TRAIN_LR, **kw), plan)
             for name, kw in TRAIN_RUNS.items()}
    leaves = tree_leaves(params)
    buckets = hetccl._make_buckets([p.float() for p in leaves],
                                   progs["int8_ef"].comm.bucket_bytes)
    n_buckets = len(buckets)
    want = train_counts(cfg.n_layers, plan.n_micro_max, m.size, len(leaves), n_buckets, 2)
    # the codec's launches by rows of 512, one rank, from the leaves and buckets
    want_rows = bench_codec.codec_launch_rows(
        [p.numel() for p in leaves], [sum(leaves[i].numel() for i in b) for b in buckets],
        m.shape["pod"], m.shape["data"])

    # a warm-up step of the int8 run (cuBLAS, allocator: the other runs share
    # its shapes; their own warm-up steps went to make room for [38]), then
    # the checked runs; the warm-up records the rows of every codec launch
    # (all ranks)
    seen = {k: [] for k in want_rows}

    def recording(kernel, fn):
        def run(a, *rest):
            seen[kernel].append(a.shape[0])          # list.append: one op, thread-safe
            return fn(a, *rest)
        return run

    with patched(quant, "wire_quantize_int8", recording("quant_int8",
                                                      quant.wire_quantize_int8)), \
            patched(quant, "wire_dequant_accum_int8", recording(
                "dq_accum_int8", quant.wire_dequant_accum_int8)):
        progs["int8_ef"].step_fn(progs["int8_ef"].init_fn(params), batch)
    torch.cuda.synchronize()
    got_rows = {k: dict(Counter(v)) for k, v in seen.items()}
    for kernel, rows in want_rows.items():
        print(f"  {kernel} launches per int8 step by rows of 512 (all {m.size} ranks): "
              f"{json.dumps({r: n * m.size for r, n in sorted(rows.items())})}")
    check(got_rows == {k: {r: n * m.size for r, n in v.items()} for k, v in want_rows.items()},
          f"the int8 step's codec launches by rows {got_rows} differ from the count from its "
          f"leaves and buckets {want_rows} (per rank)")
    # each step of the checked runs timed on the host clock, ended by a
    # synchronise (three more steps, the runs in turns, timed them before [34]
    # and [35] joined)
    runs, launches, ms = {}, {}, {}
    for name, prog in progs.items():
        state = prog.init_fn(params)
        if name == "int8_ef":
            check(all("ef" in s["opt"] for s in state), "int8 run: no error-feedback state")
            torch.cuda.reset_peak_memory_stats()
        counters.reset()
        losses, ms[name] = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, met = prog.step_fn(state, batch)
            losses.append(met["loss"].item())
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
        launches[name] = counters.read()
        if name == "int8_ef":
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            int8_state = state
        if name == "pallas":          # [38]'s reference: its losses and rank 0's parameters
            pallas_final = {"losses": list(losses), "params": [
                p.cpu() for p in tree_leaves(state[0]["params"])]}
        runs[name] = {"losses": losses, "grad_norm": met["grad_norm"].item(),
                      "tokens": int(met["tokens"].item())}
        print(f"  {name:8s} losses {['%.6f' % x for x in losses]}; launches {launches[name]}")
        del state
    for name, r in runs.items():
        check(all(np.isfinite(r["losses"])), f"{name}: non-finite loss")
        check(r["losses"][-1] < r["losses"][0], f"{name}: the loss did not fall: {r['losses']}")
        check(r["tokens"] == n_tokens, f"{name}: {r['tokens']} tokens counted, {n_tokens} fed")
    first = {name: r["losses"][0] for name, r in runs.items()}
    check(len(set(first.values())) == 1, f"step-0 losses differ: {first}")
    gap = abs(runs["int8_ef"]["losses"][-1] - runs["pallas"]["losses"][-1])
    print(f"  step-0 loss equal in all three runs: {first['xla']:.6f}; final loss int8 - none: "
          f"{gap:.4e} (limit {TRAIN_INT8_LOSS_TOL})  {'ok' if gap <= TRAIN_INT8_LOSS_TOL else 'FAIL'}")
    check(gap <= TRAIN_INT8_LOSS_TOL, "the int8 run strays beyond its limit")
    steps = TRAIN_STEPS
    for key, per_step in want.items():
        got = launches["int8_ef"][key]
        print(f"  int8_ef {key}: {got} launches in {steps} steps, {per_step} per step expected  "
              f"{'ok' if got == per_step * steps else 'FAIL'}")
        check(got == per_step * steps, f"{key}: {got} launches, {per_step * steps} expected")
    check(launches["pallas"]["ring_reduce_scatter"] == n_buckets * steps
          and launches["pallas"]["ring_all_gather"] == (n_buckets + len(leaves)) * steps,
          f"the run without a codec did not launch the fused rings per bucket and leaf: "
          f"{launches['pallas']}")
    check(launches["xla"]["ring_reduce_scatter"] == 0 and launches["int8_ef"]["quant_int8"] > 0,
          "a run took another route than its backend")

    # host-clock ms per step: the int8 run's checked steps (after its warm-up
    # step); the pallas and xla runs' warm-up steps went to make room for
    # [38], so theirs is their second step's alone (the first carries their
    # first calls); the split of one int8 step
    step_ms = {name: statistics.median(v) if name == "int8_ef" else v[-1]
               for name, v in ms.items()}
    states = {"int8_ef": int8_state}
    split = step_split(torch, mesh_mod, optim, hetccl, progs["int8_ef"], states, batch)
    busy = device_busy_share(
        torch, lambda: progs["int8_ef"].step_fn(states["int8_ef"], batch), 1)
    print(f"  ms per step (host clock; int8_ef the median of its {TRAIN_STEPS} checked steps, "
          f"pallas and xla their second step, each run's first without a warm-up): "
          f"{json.dumps({k: round(v, 1) for k, v in step_ms.items()})}; tokens/s "
          f"{json.dumps({k: round(n_tokens / v * 1e3, 1) for k, v in step_ms.items()})}")
    print(f"  int8 step split (rank 0, ms): {json.dumps(split)}; card busy share of an int8 "
          f"step {busy}; peak memory {peak_gib:.2f} GiB")
    return {"runs": runs, "launches": launches, "expected_per_step": want,
            "n_buckets": n_buckets, "codec_launch_rows": want_rows, "step_ms": step_ms,
            "tokens_per_s": {k: n_tokens / v * 1e3 for k, v in step_ms.items()},
            "split_ms": split, "device_busy": busy, "peak_gib": peak_gib,
            "tokens_per_step": n_tokens, "pallas_final": pallas_final}


def step_split(torch, mesh_mod, optim, hetccl, prog, states, batch):
    """One step with rank 0's phases timed on the host clock, each ended by a
    device synchronise (the ranks share the card, so the others' work counts
    in the phase it overlaps): forward+backward, ef_apply, tree_all_reduce,
    and the optimizer with the parameter all-gather."""
    split = {"forward_backward": 0.0, "ef_apply": 0.0, "tree_all_reduce": 0.0,
             "optimizer_and_param_all_gather": 0.0}
    orig = {"ef_apply": optim.ef_apply, "tree_all_reduce": hetccl.tree_all_reduce,
            "zero1_step": optim.zero1_step}

    def timed(key, fn):
        def run(*a, **kw):
            if mesh_mod.current()[1] != 0:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key] += (time.perf_counter() - t) * 1e3
            return out
        return run

    optim.ef_apply = timed("ef_apply", orig["ef_apply"])
    hetccl.tree_all_reduce = timed("tree_all_reduce", orig["tree_all_reduce"])
    optim.zero1_step = timed("zero1", orig["zero1_step"])
    split["zero1"] = 0.0
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        states["int8_ef"], _ = prog.step_fn(states["int8_ef"], batch)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    finally:
        optim.ef_apply, hetccl.tree_all_reduce, optim.zero1_step = (
            orig["ef_apply"], orig["tree_all_reduce"], orig["zero1_step"])
    zero1 = split.pop("zero1")
    split["optimizer_and_param_all_gather"] = zero1 - split["ef_apply"] - split["tree_all_reduce"]
    split["forward_backward"] = total - zero1
    split["step"] = total
    return {k: round(v, 2) for k, v in split.items()}


def phase_codec_times(torch, quant, ref, bench_codec, step_rows, ranks):
    """Both codec kernels at the hop (6912, 512) and the largest leaf
    (55296, 512), L2 cold before each reading, back to back and from a CUDA
    graph, ``torch.addcmul`` in turns with the decode (bench_codec's
    protocol), the wrapper's host time per call; then the codec's card time
    per int8+EF step: launches x graph time over every shape the step
    launches (``step_rows``, one rank) and its ranks."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = bench_codec.SHAPES["hop"]
    x = quant_inputs(torch, gen, rows, "randn")
    acc = torch.randn(rows, 512, generator=gen, device="cuda")
    codes, scales = quant.wire_quantize_int8(x)
    out = {
        "quant_int8": {"plain_ms": median_ms(lambda: ref.wire_quantize(x)), "library_ms": None,
                       "shape": f"({rows}, 512) f32 -> int8 codes + f32 scales"},
        # the yardstick: one call, acc + codes * scales in f32 (on the card's
        # elementwise kernel an FMA may fuse it; the kernel rounds twice, C4)
        "dq_accum_int8": {"plain_ms": median_ms(lambda: ref.wire_dequant_accum(acc, codes,
                                                                               scales)),
                          "shape": f"({rows}, 512) f32 + int8 codes"}}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reader = bench_codec.ColdReader()
        for label, n in bench_codec.SHAPES.items():
            pre = "" if label == "hop" else label + "_"
            for kernel, t in out.items():
                r = bench_codec.bench_codec_shape(reader, quant, kernel, n, gen,
                                                  {"kernel": None}, rounds=6)
                check(all(r["same_bits"].values()), f"{kernel} at ({n}, 512): outputs differ")
                med, reads = r["median_ms"], r["readings"]
                t[pre + "ms"] = med["kernel"]["stream"]
                t[pre + "graph_ms"] = med["kernel"]["graph"]
                t[pre + "ms_readings"] = reads["kernel"]["stream"]
                t[pre + "graph_ms_readings"] = reads["kernel"]["graph"]
                t[pre + "bound_ms"] = r["bound_ms"]
                t[pre + "host_us_per_call"] = r["host_us"]["kernel"]
                if kernel == "dq_accum_int8":
                    t[pre + "library_ms"] = med["torch.addcmul"]["stream"]
                    t[pre + "library_graph_ms"] = med["torch.addcmul"]["graph"]
                    t[pre + "library_ms_readings"] = reads["torch.addcmul"]["stream"]
                    t[pre + "library_graph_ms_readings"] = reads["torch.addcmul"]["graph"]
                lib = (f", torch.addcmul {med['torch.addcmul']['stream']:.5f} / graph "
                       f"{med['torch.addcmul']['graph']:.5f} ms"
                       if kernel == "dq_accum_int8" else "")
                print(f"  {kernel} at ({n}, 512), L2 cold, in turns: kernel back to back "
                      f"{med['kernel']['stream']:.5f} ms, graph {med['kernel']['graph']:.5f} ms"
                      f"{lib}; bound {r['bound_ms']:.5f} ms (bytes); wrapper host time "
                      f"{r['host_us']['kernel']:.1f} us a call")
        step = bench_codec.step_card_ms(reader, quant, step_rows, gen, {"kernel": None},
                                        ranks=ranks)["kernel"]
    torch.cuda.current_stream().wait_stream(side)
    bound = bench_codec.step_bound_ms(step_rows, ranks)
    for t in out.values():
        t["bound_by"] = "bytes"
        t["step_card_ms"] = step["ms"]
        t["step_bound_ms"] = bound
    out["step"] = {"card_ms": step["ms"], "bound_ms": bound, "ranks": ranks,
                   "launch_rows": step_rows, "graph_ms_by_rows": step["by_shape"]}
    print(f"  codec card time per int8+EF step ({ranks} ranks, launches x graph time over "
          f"{sum(len(v) for v in step_rows.values())} shapes, L2 cold): {step['ms']:.4f} ms "
          f"(bound {bound:.4f} ms)")
    return out


def phase_train_kernel_times(torch, ref, fa, bwd_case, rounds=4):
    import torch.nn.functional as F
    out = {}
    q, k, v, o, do, lse = bwd_case["inputs"]
    kw = bwd_case["kw"]
    B, Hq, Sq, d = q.shape
    Sk = k.shape[2]
    lse_plain = ref.attention_lse(q, k, **kw)
    elem = q.element_size()
    nbytes = (q.numel() * 3 + k.numel() * 2) * elem + lse.numel() * 4         + (q.numel() + 2 * k.numel()) * 4                     # dq, dk, dv written in f32
    flops = 5 * 2 * d * B * Hq * valid_pairs(Sq, Sk, kw["kind"], kw["window"], kw["k_len"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    t = out["flash_attention_bwd"] = {
        "plain_ms": median_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, do, lse_plain,
                                                                   **kw), reps=5),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} {str(q.dtype).removeprefix('torch.')}"
                 f" {kw['kind']}"}
    # the kernel and SDPA's backward (autograd of F.scaled_dot_product_attention,
    # the yardstick) in turns, back to back and replayed from CUDA graphs; all
    # on one side stream, where SDPA's forward ran, so its backward is captured
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=kw["kind"] == "causal",
                                                enable_gqa=True)
        fns = {"": lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, **kw),
               "library_": lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do,
                                                       retain_graph=True)}
        for prefix, ms in in_turns(fns, rounds).items():
            t[prefix + "ms"] = statistics.median(ms)
            t[prefix + "ms_readings"] = ms
        for prefix, ms in in_turns(fns, rounds,
                                   timer=lambda fn: graph_ms(fn, stream=side)).items():
            t[prefix + "graph_ms"] = statistics.median(ms)
            t[prefix + "graph_ms_readings"] = ms
    torch.cuda.current_stream().wait_stream(side)
    for name, t in out.items():
        lib = f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None else "none"
        print(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
              + (f"; CUDA graph: kernel {t['graph_ms']:.4f} ms, library "
                 f"{t['library_graph_ms']:.4f} ms" if "graph_ms" in t else ""))
    return out


# ---------------------------------------------------------------------------
# MoE path: grouped matmul, full-width mixtral serving, sliding window
# ---------------------------------------------------------------------------

def gmm_inputs(torch, gen, G, M, K, N, dtype, layout):
    """x (G, M, K) unit normals, w (G, K, N) normals of std K**-0.5, laid out
    as ``layout`` says (see GMM_CASES)."""
    dt = getattr(torch, dtype)
    x = torch.randn(G, M, K, generator=gen, device="cuda").to(dt)
    if layout == "zero_rows":                        # drops: every 3rd row, the tail
        x[:, ::3] = 0
        x[:, M - M // 5:] = 0
    lead = {"layer_view": 24, "odd_view": 3}.get(layout, 0)
    width = N + lead + (8 if lead else 0)
    layers = 2 if lead or layout == "layer" else 1
    stacked = torch.randn(layers, G, K, width, generator=gen,
                          device="cuda").mul_(K ** -0.5).to(dt)
    w = stacked[-1, :, :, lead:lead + N]
    return x, w


def gmm_error(out, want):
    """Max abs, relative L2, and the worst row's L2 error over the larger of
    its own norm and the mean row norm, of (..., N)."""
    diff = out.float() - want.float()
    rows = want.float().norm(dim=-1)
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / want.float().norm()).item(),
            "worst_row": (diff.norm(dim=-1) / rows.clamp(min=rows.mean())).max().item()}


def gmm_ok(err, dtype_name, limits=GMM_LIMITS):
    rel_lim, row_lim = limits[dtype_name]
    return err["rel_l2"] <= rel_lim and err["worst_row"] <= row_lim


def format_gmm(err, dtype_name, limits=GMM_LIMITS):
    rel_lim, row_lim = limits[dtype_name]
    return (f"max_abs_err {err['max_abs_err']:.3e}  rel_l2 {err['rel_l2']:.3e} "
            f"(limit {rel_lim:.0e})  worst_row {err['worst_row']:.3e} (limit {row_lim:.0e})")


def phase_gmm_kernels(torch, gmm, ref):
    """The kernel against its plain version, case by case."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results, failed = {}, []
    for name, G, M, K, N, dt, layout in GMM_CASES:
        x, w = gmm_inputs(torch, gen, G, M, K, N, dt, layout)
        out = gmm.grouped_matmul(x, w)
        want = ref.grouped_matmul(x, w)
        torch.cuda.synchronize()
        check(out.shape == want.shape and out.dtype == want.dtype,
              f"{name}: output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        err = gmm_error(out, want)
        zero_rows_ok = True
        if layout == "zero_rows":                   # a dropped token's row stays 0
            zero_rows_ok = bool((out[x.abs().amax(-1) == 0] == 0).all())
        ok = gmm_ok(err, dt) and zero_rows_ok
        route = gmm.route(x, w)
        print(f"  {name:22s} ({G},{M},{K})@({G},{K},{N}) {dt:8s} {layout:10s} {route:6s} "
              f"{format_gmm(err, dt)}{'' if zero_rows_ok else ' ZERO ROWS NOT ZERO'}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = {**err, "route": route}
        del x, w, out, want
    check(not failed, f"grouped_matmul disagrees with its plain version in {failed}")
    routes = sorted({v["route"] for v in results.values()})
    check(routes == sorted(gmm.ROUTES), f"the cases reached the routes {routes} only")
    return results


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` inside the block, restored after."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def patched_variant(tacc, op, variant, fn):
    """The TACC registration (op, variant) replaced by ``fn`` inside the block."""
    old = tacc.resolve(op, variant)
    tacc.register(op, variant)(fn)
    try:
        yield
    finally:
        tacc.register(op, variant)(old)


@contextlib.contextmanager
def route_log(torch, moe_mod, log):
    """Appends (expert ids (T, k), kept (T, k), output (T, D)) of every
    moe_ffn call."""
    orig_dispatch, orig_ffn = moe_mod.dispatch_slots, moe_mod.moe_ffn

    def rec(expert_idx, n_experts, capacity):
        order, tok_of, slot, keep = orig_dispatch(expert_idx, n_experts, capacity)
        kept = torch.empty_like(keep)
        kept[order] = keep
        log.append([expert_idx.clone(), kept.reshape(expert_idx.shape)])
        return order, tok_of, slot, keep

    def rec_ffn(*args, **kw):
        out, aux = orig_ffn(*args, **kw)
        log[-1].append(out)
        return out, aux

    with patched(moe_mod, "dispatch_slots", rec), patched(moe_mod, "moe_ffn", rec_ffn):
        yield


def moe_model(torch, get_config, build):
    """Full-width mixtral-8x7b cut to MOE_LAYERS layers, bf16, weights from SEED."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return cfg, model, params


def phase_moe_layers(torch, tacc, gmm, ref, model, params, batch):
    """In one prefill, each grouped matmul against its plain version on the
    same inputs, and each layer's expert_ffn against the same composition
    through the plain version: the hard gate, which routing cannot blur."""
    gmm_errs, ffn_errs = [], []
    kernel_gmm = gmm.grouped_matmul
    kernel_ffn = tacc.resolve("expert_ffn", "cuda")

    def rec_gmm(x, w):
        out = kernel_gmm(x, w)
        gmm_errs.append(gmm_error(out, ref.grouped_matmul(x, w)))
        return out

    def rec_ffn(buf, w1, w3, w2):
        out = kernel_ffn(buf, w1, w3, w2)
        with patched(gmm, "grouped_matmul", ref.grouped_matmul):
            want = kernel_ffn(buf, w1, w3, w2)
        ffn_errs.append(gmm_error(out, want))
        return out

    with patched(gmm, "grouped_matmul", rec_gmm), \
            patched_variant(tacc, "expert_ffn", "cuda", rec_ffn), torch.inference_mode():
        model.prefill(params, batch)
    L = model.cfg.n_layers
    worst_gmm = {key: max(e[key] for e in gmm_errs) for key in gmm_errs[0]}
    worst_ffn = {key: max(e[key] for e in ffn_errs) for key in ffn_errs[0]}
    ok_gmm = len(gmm_errs) == 3 * L and all(gmm_ok(e, "bfloat16") for e in gmm_errs)
    ok_ffn = len(ffn_errs) == L and all(gmm_ok(e, "bfloat16", FFN_LIMITS) for e in ffn_errs)
    print(f"  per layer ({len(gmm_errs)} grouped matmuls), worst: "
          f"{format_gmm(worst_gmm, 'bfloat16')}  {'ok' if ok_gmm else 'FAIL'}")
    print(f"  per layer ({len(ffn_errs)} expert_ffn against the plain composition), worst: "
          f"{format_gmm(worst_ffn, 'bfloat16', FFN_LIMITS)}  {'ok' if ok_ffn else 'FAIL'}")
    check(ok_gmm and ok_ffn, "grouped_matmul or expert_ffn disagrees with its plain "
                             "version on a layer's inputs")
    return {"gmm": worst_gmm, "expert_ffn": worst_ffn}


@contextlib.contextmanager
def replayed_routes(torch, moe_mod, log):
    """moe.route returning, call by call, the expert ids recorded in ``log``,
    with the gates taken from this call's own probabilities at those ids."""
    orig = moe_mod.route
    calls = iter(log)

    def replay(x, router, top_k):
        logits, probs, _, _ = orig(x, router, top_k)
        idx = next(calls)[0]
        gates = probs.gather(1, idx)
        return logits, probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx

    with patched(moe_mod, "route", replay):
        yield


def compare_to_plain(torch, tacc, gmm, ref, moe_mod, model, params, batch):
    """Last-position logits and routes of a prefill through the kernel against
    prefills with expert_ffn pinned to the plain composition.  Free-running,
    the plain run's routes and drops may differ (routing is discontinuous):
    counted and reported, and the requests whose routes and drops agree in
    every layer gated on MOE_LOGITS_REL_TOL.  Replaying the kernel run's
    expert ids (gates from the plain run's own probabilities), every route
    and drop agrees by construction and every request is gated."""
    kernel_ffn = tacc.resolve("expert_ffn", "cuda")

    def plain_ffn(buf, w1, w3, w2):
        with patched(gmm, "grouped_matmul", ref.grouped_matmul):
            return kernel_ffn(buf, w1, w3, w2)

    def run(plain, replay=None):
        log = []
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(patched_variant(tacc, "expert_ffn", "cuda", plain_ffn))
            if replay is not None:
                stack.enter_context(replayed_routes(torch, moe_mod, replay))
            stack.enter_context(route_log(torch, moe_mod, log))
            stack.enter_context(torch.inference_mode())
            logits = model.prefill(params, batch)[0][:, -1].float()
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        return logits, log

    B, S = batch["tokens"].shape

    def differences(ra, rb):
        """(route differences, drop differences where the route agrees) per
        request, summed over layers, and per layer."""
        routes = torch.zeros(B, dtype=torch.long, device=batch["tokens"].device)
        drops = torch.zeros_like(routes)
        per_layer = []
        for (ia, ka, _), (ib, kb, _) in zip(ra, rb):
            r = (ia != ib).sum(-1).reshape(B, S).sum(-1)
            d = ((ia == ib) & (ka != kb)).sum(-1).reshape(B, S).sum(-1)
            routes += r
            drops += d
            per_layer.append((int(r.sum()), int(d.sum())))
        return routes, drops, per_layer

    def rel(a, b):
        return (a - b).norm(dim=-1) / b.norm(dim=-1)

    lk, rk = run(False)
    lp, rp = run(True)
    lr, rr = run(True, replay=rk)
    routes, drops, per_layer = differences(rk, rp)
    agree = (routes + drops) == 0
    free = rel(lk, lp)
    n_agree = int(agree.sum())
    worst_free = free[agree].max().item() if n_agree else None
    r2, d2, _ = differences(rk, rr)
    check(int(r2.sum()) == 0 and int(d2.sum()) == 0, "replayed routes differ")
    replayed = rel(lk, lr)
    drift = [(((a[2].float() - b[2].float()).norm() / b[2].float().norm()).item())
             for a, b in zip(rk, rr)]
    limit = MOE_LOGITS_REL_TOL[model.cfg.dtype]
    out = {"assignments": len(rk) * B * S * rk[0][0].shape[1],
           "routes_differing": int(routes.sum()), "drops_differing": int(drops.sum()),
           "per_layer_routes_drops_differing": per_layer, "rows_agreeing": n_agree, "rows": B,
           "rel_l2_free_rows_agreeing_max": worst_free, "rel_l2_free": free.tolist(),
           "rel_l2_replayed": replayed.tolist(), "rel_l2_replayed_max": replayed.max().item(),
           "moe_output_rel_l2_by_layer_replayed": drift,
           "same_argmax_free": (lk.argmax(-1) == lp.argmax(-1)).float().mean().item(),
           "same_argmax_replayed": (lk.argmax(-1) == lr.argmax(-1)).float().mean().item()}
    print(f"  kernel vs plain expert_ffn, free-running: of {out['assignments']} (token, expert) "
          f"assignments {out['routes_differing']} routes and {out['drops_differing']} drops "
          f"differ (per layer {per_layer}); {n_agree} of {B} requests agree in every layer "
          f"(logits rel L2 there: max {'-' if worst_free is None else f'{worst_free:.3e}'}); "
          f"all requests {['%.3e' % v for v in out['rel_l2_free']]}")
    print(f"  kernel vs plain expert_ffn, kernel routes replayed: last-position logits rel L2 "
          f"{['%.3e' % v for v in out['rel_l2_replayed']]} (limit {limit}); same argmax "
          f"{out['same_argmax_replayed']:.3f}; MoE output rel L2 by layer "
          f"{['%.2e' % v for v in drift]}")
    check(worst_free is None or worst_free <= limit,
          f"logits of requests whose routes agree differ by {worst_free}")
    check(out["rel_l2_replayed_max"] <= limit,
          f"logits with replayed routes differ by {out['rel_l2_replayed_max']:.3e}")
    return out


def phase_moe_serve(torch, np, fa, gmm, ref, tacc, moe_mod, attn_mod, engine, build, counters,
                    cfg, model, params, n_requests, prompt_len, max_new, window_run):
    """``n_requests`` x ``prompt_len`` prompt tokens x ``max_new`` new ones,
    greedy, through ``Batcher``; launch counts from the counters set to 0 just
    before and read just after.  ``window_run``: the prompt is past the window,
    so the cache must be the rolling one and decode go through
    ``window_decode_attention``."""
    dev = torch.device("cuda")
    max_len = prompt_len + max_new
    progs = engine.make_serve_programs(model, seq_len=prompt_len, max_len=max_len,
                                       device=dev)
    rng = np.random.RandomState(SEED + prompt_len)
    prompts = [rng.randint(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(n_requests)]
    finite = [torch.ones((), dtype=torch.bool, device=dev)]

    def watched(fn):
        def run(*args):
            logits, cache = fn(*args)
            finite[0] = finite[0] & torch.isfinite(logits).all()
            return logits, cache
        return run

    watched_progs = dataclasses.replace(progs, prefill_fn=watched(progs.prefill_fn),
                                        decode_fn=watched(progs.decode_fn))

    def serve(new):
        reqs = [engine.Request(i, p, new) for i, p in enumerate(prompts)]
        return engine.Batcher(watched_progs, params, batch_slots=n_requests,
                              prompt_len=prompt_len, max_len=max_len).run(reqs)

    serve(2)                                          # warm-up
    torch.cuda.synchronize()
    window_calls = [0]
    orig_wda = attn_mod.window_decode_attention

    def counted_wda(*a, **kw):
        window_calls[0] += 1
        return orig_wda(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    with patched(attn_mod, "window_decode_attention", counted_wda):
        counters.reset()
        t0 = time.perf_counter()
        done = serve(max_new)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = counters.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.n_layers
    want_gmm = 3 * L * (max_new + 1)
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests x {prompt_len} prompt tokens, {n_tok} new tokens "
          f"in {serve_s:.3f} s; grouped_matmul launches {launches['grouped_matmul']} "
          f"(3 x {L} layers x {max_new + 1} forwards = {want_gmm}), flash "
          f"{launches['flash_attention_fwd']} ({L} per prefill), window_decode_attention "
          f"calls {window_calls[0]}")
    check(launches["grouped_matmul"] == want_gmm,
          f"grouped_matmul launched {launches['grouped_matmul']} times, {want_gmm} expected")
    routes = {r: launches[f"grouped_matmul_{r}"] for r in gmm.ROUTES}
    want_routes = {"f32": 0, "mma16": 3 * L * max_new, "mma128": 0, "wgmma": 3 * L}
    print(f"  grouped_matmul launches per route: {routes} (prefill 3 x {L} on wgmma, decode "
          f"3 x {L} x {max_new} on mma16)")
    check(routes == want_routes, f"grouped_matmul routes {routes}, {want_routes} expected")
    check(launches["flash_attention_fwd"] == L, "flash kernel not launched once per layer")
    check(len(done) == n_requests and all(len(r.out) == max_new for r in done),
          "not every request got its tokens")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "a token is outside the vocab")
    check(bool(finite[0]), "non-finite logits in the serve run")
    check(window_calls[0] == (L * max_new if window_run else 0),
          f"window_decode_attention ran {window_calls[0]} times")

    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    batch = {"tokens": toks}
    out = {"arch": cfg.name, "n_layers": L, "requests": len(done), "prompt_len": prompt_len,
           "new_tokens_per_request": max_new, "serve_s": serve_s,
           "tokens_per_s": n_tok / serve_s, "launches": launches,
           "window_decode_calls": window_calls[0], "peak_gib": peak_gib}
    _, cache = progs.prefill_fn(params, batch)
    W = cfg.window
    rolling = cache["k"].shape[2] == W
    print(f"  cache after prefill: k {tuple(cache['k'].shape)}, pos {cache['pos']}; rolling "
          f"window cache: {rolling}")
    check(rolling == window_run and cache["pos"] == prompt_len,
          "the cache is not the one the prompt length calls for")
    del cache
    if not window_run:
        out["layer_worst_error"] = phase_moe_layers(torch, tacc, gmm, ref, model, params, batch)
    out["vs_plain"] = compare_to_plain(torch, tacc, gmm, ref, moe_mod, model, params, batch)
    if not window_run:                 # the same comparison in f32, first layers only
        cfg32 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS, dtype="float32")
        p32 = _tree_map(lambda t: t.float(), {
            **{k: v for k, v in params.items() if k != "blocks"},
            "blocks": _tree_map(lambda t: t[:MOE_F32_LAYERS], params["blocks"])})
        print(f"  f32, first {MOE_F32_LAYERS} layers:")
        out["vs_plain_f32"] = compare_to_plain(torch, tacc, gmm, ref, moe_mod, build(cfg32),
                                               p32, batch)
        del p32

    def timed(fn, reps):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)

    out["prefill_ms"] = timed(lambda: progs.prefill_fn(params, batch), 3)
    _, cache = progs.prefill_fn(params, batch)
    cur = toks[:, -1:]

    def step():
        nonlocal cache
        _, cache = progs.decode_fn(params, cache, cur)

    out["decode_ms_per_step"] = timed(step, max_new - 2)
    out["device_busy_prefill"] = device_busy_share(
        torch, lambda: progs.prefill_fn(params, batch), 1)
    _, cache = progs.prefill_fn(params, batch)
    out["device_busy_decode"] = device_busy_share(torch, step, max_new // 2)
    del cache
    print(f"  prefill {out['prefill_ms']:.2f} ms (batch {n_requests} x {prompt_len}), decode "
          f"{out['decode_ms_per_step']:.2f} ms per step, {out['tokens_per_s']:.1f} tokens/s end "
          f"to end; card busy share prefill {out['device_busy_prefill']}, decode "
          f"{out['device_busy_decode']}; peak memory {peak_gib:.2f} GiB")
    return out


GMM_TIMED = {"prefill_w13": (8, 1280, 4096, 14336), "prefill_w2": (8, 1280, 14336, 4096),
             "decode_w13": (8, 2, 4096, 14336), "decode_w2": (8, 2, 14336, 4096),
             "window_w13": (8, 1440, 4096, 14336), "window_w2": (8, 1440, 14336, 4096)}


def phase_moe_kernel_times(torch, gmm, ref):
    """The kernel at Mixtral's prefill (C 1280), decode (C 2) and window-run
    prefill (C 1440) shapes, its plain version, torch.bmm (the yardstick; the
    port never calls it) and the
    bound: the larger of FLOPs over the bf16 peak and bytes (x, w read once,
    out written once) over the memory rate."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, (G, M, K, N) in GMM_TIMED.items():
        x, w = gmm_inputs(torch, gen, G, M, K, N, "bfloat16", "dense")
        t_ops = 2 * G * M * K * N / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = (x.numel() + w.numel() + G * M * N) * 2 / HBM_BYTES_PER_S * 1e3
        kernel = lambda: gmm.grouped_matmul(x, w)          # noqa: E731
        library = lambda: torch.bmm(x, w)                  # noqa: E731
        ms = [median_ms(kernel, reps=10), median_ms(library, reps=10)]
        ms += [median_ms(library, reps=10), median_ms(kernel, reps=10)]   # in turns
        out[name] = {"ms": statistics.median([ms[0], ms[3]]),
                     "library_ms": statistics.median([ms[1], ms[2]]),
                     "plain_ms": median_ms(lambda: ref.grouped_matmul(x, w), reps=2,
                                           trials=3, warmup=1),
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "shape": f"({G},{M},{K})@({G},{K},{N}) bf16", "route": gmm.route(x, w),
                     "ms_readings": [ms[0], ms[3]], "library_ms_readings": [ms[1], ms[2]]}
        t = out[name]
        if name.startswith("decode"):      # and replayed from CUDA graphs, in turns
            for key, g in in_turns({"graph_ms": kernel, "library_graph_ms": library},
                                   timer=lambda fn: graph_ms(fn, reps=10)).items():
                t[key] = statistics.median(g)
                t[key + "_readings"] = g
        print(f"  grouped_matmul {name} at {t['shape']} ({t['route']} route): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.bmm {t['library_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); kernel / bound "
              f"{t['ms'] / t['bound_ms']:.2f}, kernel / torch.bmm {t['ms'] / t['library_ms']:.2f}"
              + (f"; CUDA graph: kernel {t['graph_ms']:.4f} ms, torch.bmm "
                 f"{t['library_graph_ms']:.4f} ms" if "graph_ms" in t else ""))
        del x, w
    return out


# ---------------------------------------------------------------------------
# SSM path: the SSD kernel, full-width mamba2 and zamba2 serving
# ---------------------------------------------------------------------------

def ssd_inputs(torch, gen, B, S, H, P, G, N, Q, dtype, dt_scale, with_init, layout):
    """The SSD's inputs at the model's layout (x (B,S,H,P), dt and the
    within-chunk cumsum a of dt*A (B,S,H) f32, B and C (B,S,G,N)), or at the
    kernel's layout (B,H,nc,Q,...), groups repeated to heads."""
    import torch.nn.functional as F
    dt_ = getattr(torch, dtype)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = normal(B, S, H, P).to(dt_)
    dt = dt_scale * F.softplus(normal(B, S, H))
    A = -torch.exp(0.25 * normal(H))
    Bm, Cm = (normal(B, S, G, N).mul_(0.5).to(dt_) for _ in range(2))
    a = torch.cumsum((dt * A).reshape(B, S // Q, Q, H), dim=2).reshape(B, S, H)
    init = normal(B, H, N, P) if with_init else None
    if layout == "kernel":
        nc = S // Q

        def kl(t, heads=False):
            if heads:
                t = t.repeat_interleave(H // G, dim=2)
            return t.reshape(B, nc, Q, *t.shape[2:]).movedim(3, 1).contiguous()

        return {"x": kl(x), "dt": kl(dt), "a": kl(a), "B": kl(Bm, True), "C": kl(Cm, True)}
    return {"x": x, "dt": dt, "a": a, "B": Bm, "C": Cm, "init": init, "Q": Q}


def ssd_run(ssd, ref, inp, plain):
    """(y, final state or None) of the kernel or of its plain version."""
    if "Q" not in inp:                                  # the kernel's layout
        fn = ref.ssd_scan if plain else ssd.ssd_scan
        return fn(inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"]), None
    fn = ssd.ssd_scan_model_plain if plain else ssd.ssd_scan_model
    return fn(inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"], inp["Q"], inp["init"])


def ssd_errors(got, want):
    """gmm_error of y and of the final state (when there is one); ok under
    SSD_LIMITS of the outputs' type."""
    out = {"y": gmm_error(got[0], want[0])}
    if want[1] is not None:
        out["state"] = gmm_error(got[1], want[1])
    dt = str(got[0].dtype).removeprefix("torch.")
    ok = all(gmm_ok(e, dt, SSD_LIMITS) for e in out.values())
    return out, ok, dt


def ssd_mma_ok(errs):
    """The mma route's own check: every output within SSD_MMA_REL_L2."""
    return all(e["rel_l2"] <= SSD_MMA_REL_L2 for e in errs.values())


def phase_ssd_kernels(torch, ssd, ref, fa):
    """The SSD kernel against its plain version, case by case, y and the final
    state; then the flash forward at head dim 112 against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results, failed, routes = {}, [], set()
    for name, B, S, H, P, G, N, Q, dt, scale, init, layout in SSD_CASES:
        inp = ssd_inputs(torch, gen, B, S, H, P, G, N, Q, dt, scale, init, layout)
        got = ssd_run(ssd, ref, inp, plain=False)
        want = ssd_run(ssd, ref, inp, plain=True)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if w is not None:
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"{name}: output {tuple(g.shape)} {g.dtype}")
                check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        errs, ok, out_dt = ssd_errors(got, want)
        text = "  ".join(f"{k} {format_gmm(e, out_dt, SSD_LIMITS)}" for k, e in errs.items())
        route = ssd.route(inp["x"].dtype)
        routes.add(route)
        if route == "mma" and out_dt == "float32" and scale >= 1.0:
            ok = ssd_mma_ok(errs) and ok
            text += f"  (mma limit {SSD_MMA_REL_L2:.0e})"
        print(f"  {name:20s} B{B} S{S} H{H} P{P} G{G} N{N} Q{Q} {dt:8s} {layout:6s} {route:3s} "
              f"{text}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = {**errs, "route": route}
        del inp, got, want
    check(not failed, f"ssd_scan disagrees with its plain version in {failed}")
    check(routes == set(ssd.ROUTES), f"SSD routes reached: {sorted(routes)}")
    flash = {}
    for (name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dt,
         model_layout) in FLASH_D112_CASES:
        q, k, v = attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, getattr(torch, dt), model_layout)
        out = fa.flash_attention_fwd(q, k, v, kind=kind)
        err = attention_error(out, fa.flash_attention_plain(q, k, v, kind=kind))
        ok = within_limits(err, dt)
        print(f"  flash {name:24s} {dt:8s} {format_error(err, dt)}  {'ok' if ok else 'FAIL'}")
        check(ok, f"flash at head dim 112 disagrees with its plain version in {name}")
        flash[name] = {**err, "inputs": (q, k, v), "kind": kind, "window": window,
                       "k_len": Sk}
    return results, flash


def ssm_model(torch, get_config, build, arch):
    """Full-width ``arch`` at full depth, bf16, weights from SEED."""
    cfg = get_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    return cfg, model, params


def phase_ssm_layers(torch, tacc, ssd, model, params, batch):
    """In one prefill, each layer's SSD through the kernel against its plain
    version on the same inputs, y and the final state: the hard gate, which
    the model's amplification of rounding cannot blur."""
    errs = []
    kernel = tacc.resolve("ssd_scan", "cuda")

    def rec(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
        got = kernel(x, dt, a_cum, B_in, C_in, chunk, init_state)
        want = ssd.ssd_scan_model_plain(x, dt, a_cum, B_in, C_in, chunk, init_state)
        errs.append(ssd_errors(got, want))
        return got

    with patched_variant(tacc, "ssd_scan", "cuda", rec), torch.inference_mode():
        model.prefill(params, batch)
    worst = {k: {m: max(e[0][k][m] for e in errs) for m in errs[0][0][k]} for k in errs[0][0]}
    ok = len(errs) == model.cfg.n_layers and all(e[1] for e in errs) and ssd_mma_ok(worst)
    print(f"  per layer ({len(errs)} SSD calls), worst: " + "  ".join(
        f"{k} {format_gmm(e, 'float32', SSD_LIMITS)}" for k, e in worst.items())
        + f"  (mma limit {SSD_MMA_REL_L2:.0e})  {'ok' if ok else 'FAIL'}")
    check(ok, "the SSD kernel disagrees with its plain version on a layer's inputs")
    return worst


def ssm_first_layers(cfg, params):
    """The config and the f32 parameters of the model's first layers: the
    first SSM_F32_LAYERS of mamba2; zamba2's first group (6 layers and the
    shared block) and first tail layer."""
    import torch
    top = {k: v for k, v in params.items() if k not in ("blocks", "groups", "tail")}
    if cfg.family == "ssm":
        n, cut = SSM_F32_LAYERS, {"blocks": _tree_map(lambda t: t[:SSM_F32_LAYERS],
                                                      params["blocks"])}
    else:
        n = cfg.attn_every + 1
        cut = {"groups": _tree_map(lambda t: t[:1], params["groups"]),
               "tail": _tree_map(lambda t: t[:1], params["tail"])}
    p32 = _tree_map(lambda t: t.to(torch.float32), {**top, **cut})
    return dataclasses.replace(cfg, n_layers=n, dtype="float32"), p32


def ssm_vs_plain(torch, tacc, build, model, params, batch):
    """Last-position logits of a prefill through the kernel against one with
    the SSD op pinned to its plain variant (the model's chunk loop); in bf16
    both also against the same model in f32 (SSM_BF16_RATIO says why)."""
    plain = tacc.resolve("ssd_scan", "cpu")

    def run(m, p, pinned):
        with contextlib.ExitStack() as stack:
            if pinned:
                stack.enter_context(patched_variant(tacc, "ssd_scan", "cuda", plain))
            stack.enter_context(torch.inference_mode())
            # the real vocab only: the padding's -1e30 would make every norm inf
            logits = m.prefill(p, batch)[0][:, -1, :m.cfg.vocab].float()
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        return logits

    def rel(a, b):
        return (a - b).norm() / b.norm()

    lk, lp = run(model, params, False), run(model, params, True)
    per_request = ((lk - lp).norm(dim=-1) / lp.norm(dim=-1)).tolist()
    same = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    out = {"rel_l2": per_request, "rel_l2_max": max(per_request), "same_argmax": same}
    head = (f"  {model.cfg.dtype} ({model.cfg.n_layers} layers) kernel vs plain SSD, "
            f"last-position logits rel L2 {['%.3e' % v for v in per_request]}")
    if model.cfg.dtype == "float32":
        print(f"{head} (limit {SSM_F32_LOGITS_REL_TOL}); same argmax {same:.3f}")
        check(max(per_request) <= SSM_F32_LOGITS_REL_TOL,
              f"f32 logits through the kernel differ by {max(per_request):.3e}")
        return out
    m32 = build(dataclasses.replace(model.cfg, dtype="float32"))
    p32 = _tree_map(lambda t: t.float(), params)
    lf = run(m32, p32, True)
    del p32
    out["kernel_vs_f32"], out["plain_vs_f32"] = rel(lk, lf).item(), rel(lp, lf).item()
    print(f"{head}; same argmax {same:.3f}; against the f32 model (plain SSD): kernel route "
          f"{out['kernel_vs_f32']:.3e}, plain route {out['plain_vs_f32']:.3e} (limit "
          f"{SSM_BF16_RATIO} x the plain route's)")
    check(out["kernel_vs_f32"] <= SSM_BF16_RATIO * out["plain_vs_f32"],
          f"bf16 logits through the kernel lie {out['kernel_vs_f32']:.3e} from the f32 model, "
          f"more than {SSM_BF16_RATIO} x the plain route's {out['plain_vs_f32']:.3e}")
    return out


def timed_ms(torch, fn, reps):
    """Median host-clock ms of ``reps`` calls, each ended by a synchronise."""
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def batched_serve(torch, engine, counters, progs, params, prompts, prompt_len, max_len,
                  new_tokens, frames=None):
    """``prompts`` through ``Batcher`` with ``new_tokens`` new each, after a
    warm-up of 2: the counts set to 0 just before the measured run and read
    just after; ``frames``: each request's frame embeddings (an
    encoder-decoder's).  Returns (finished requests, host seconds, launch
    counts, peak GiB, whether every logit was finite)."""
    dev = torch.device("cuda")
    finite = [torch.ones((), dtype=torch.bool, device=dev)]

    def watched(fn):
        def run(*args):
            logits, cache = fn(*args)
            finite[0] = finite[0] & torch.isfinite(logits).all()
            return logits, cache
        return run

    watched_progs = dataclasses.replace(progs, prefill_fn=watched(progs.prefill_fn),
                                        decode_fn=watched(progs.decode_fn))

    def serve(new):
        reqs = [engine.Request(i, p, new, frames=None if frames is None else frames[i])
                for i, p in enumerate(prompts)]
        return engine.Batcher(watched_progs, params, batch_slots=len(prompts),
                              prompt_len=prompt_len, max_len=max_len).run(reqs)

    serve(2)                                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    done = serve(new_tokens)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    return (done, serve_s, counters.read(), torch.cuda.max_memory_allocated() / 2**30,
            bool(finite[0]))


def serve_times(torch, progs, params, toks, extra=None):
    """Prefill ms (median of 3) and decode ms a step (median of
    SERVE_DECODE_TIMED) on the host clock, then the card's busy share of a
    prefill and of SERVE_DECODE_PROFILED decode steps (torch.profiler; run
    last).  ``extra``: the batch's other leaves (``mrope``, ``frames``)."""
    batch = {"tokens": toks, **(extra or {})}
    out = {"prefill_ms": timed_ms(torch, lambda: progs.prefill_fn(params, batch), 3)}
    _, cache = progs.prefill_fn(params, batch)
    cur = toks[:, -1:]

    def step():
        nonlocal cache
        _, cache = progs.decode_fn(params, cache, cur)

    out["decode_ms_per_step"] = timed_ms(torch, step, SERVE_DECODE_TIMED)
    out["device_busy_prefill"] = device_busy_share(
        torch, lambda: progs.prefill_fn(params, batch), 1)
    _, cache = progs.prefill_fn(params, batch)
    out["device_busy_decode"] = device_busy_share(torch, step, SERVE_DECODE_PROFILED)
    return out


def phase_ssm_serve(torch, np, ssd, tacc, engine, build, counters, cfg, model, params):
    """SSM_REQUESTS x SSM_PROMPT prompt tokens x SSM_NEW new ones, greedy,
    through ``Batcher``, the counts set to 0 just before and read just after;
    then the cache, the per-layer gate, the logits against the plain SSD
    (bf16, and f32 over the first layers), and the times."""
    dev = torch.device("cuda")
    max_len = SSM_PROMPT + SSM_NEW
    progs = engine.make_serve_programs(model, seq_len=SSM_PROMPT, max_len=max_len, device=dev)
    rng = np.random.RandomState(SEED + cfg.n_layers)
    prompts = [rng.randint(0, cfg.vocab, SSM_PROMPT).astype(np.int32)
               for _ in range(SSM_REQUESTS)]
    done, serve_s, launches, peak_gib, finite = batched_serve(
        torch, engine, counters, progs, params, prompts, SSM_PROMPT, max_len, SSM_NEW)
    L = cfg.n_layers
    n_attn = L // cfg.attn_every if cfg.family == "hybrid" else 0
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests x {SSM_PROMPT} prompt tokens, {n_tok} new tokens in "
          f"{serve_s:.3f} s; ssd_scan launches {launches['ssd_scan']} ({L} per prefill), "
          f"flash {launches['flash_attention_fwd']} ({n_attn} per prefill)")
    check(launches["ssd_scan"] == L, f"ssd_scan launched {launches['ssd_scan']} times, {L} "
                                     "expected")
    check(launches["ssd_scan_mma"] == L, f"ssd_scan took the mma route "
                                         f"{launches['ssd_scan_mma']} times of {L}")
    check(launches["flash_attention_fwd"] == n_attn,
          f"flash launched {launches['flash_attention_fwd']} times, {n_attn} expected")
    check(len(done) == SSM_REQUESTS and all(len(r.out) == SSM_NEW for r in done),
          "not every request got its tokens")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "a token is outside the vocab")
    check(finite, "non-finite logits in the serve run")

    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    batch = {"tokens": toks}
    out = {"arch": cfg.name, "n_layers": L, "requests": len(done), "prompt_len": SSM_PROMPT,
           "new_tokens_per_request": SSM_NEW, "serve_s": serve_s,
           "tokens_per_s": n_tok / serve_s, "launches": launches, "peak_gib": peak_gib}
    _, cache = progs.prefill_fn(params, batch)
    states = cache["s"] if cfg.family == "ssm" else cache["groups"]["s"]
    print(f"  cache after prefill: SSD states {tuple(states.shape)} {states.dtype}, pos "
          f"{cache['pos']}")
    check(states.dtype == torch.float32 and cache["pos"] == SSM_PROMPT
          and bool(torch.isfinite(states).all()), "the SSD states after prefill are not f32 "
                                                  "and finite, or pos is wrong")
    del cache, states
    out["layer_worst_error"] = phase_ssm_layers(torch, tacc, ssd, model, params, batch)
    out["vs_plain"] = ssm_vs_plain(torch, tacc, build, model, params, batch)
    cfg32, p32 = ssm_first_layers(cfg, params)
    out["vs_plain_f32"] = ssm_vs_plain(torch, tacc, build, build(cfg32), p32, batch)
    del p32
    out.update(serve_times(torch, progs, params, toks))
    print(f"  prefill {out['prefill_ms']:.2f} ms (batch {SSM_REQUESTS} x {SSM_PROMPT}), decode "
          f"{out['decode_ms_per_step']:.2f} ms per step, {out['tokens_per_s']:.1f} tokens/s end "
          f"to end; card busy share prefill {out['device_busy_prefill']}, decode "
          f"{out['device_busy_decode']}; peak memory {peak_gib:.2f} GiB")
    return out


def ssd_bound(inp):
    """(bound_ms, bound_by) of one model-layout call: each input read once and
    each output written once over the memory rate, against the work these
    shapes need (C.B^T and the weighted x on or below the diagonal, C.s and
    the state update, 2 FLOP per multiply-add) over the peak rate of the
    inputs' type."""
    x, Bm = inp["x"], inp["B"]
    B, S, H, P = x.shape
    N, Q = Bm.shape[3], inp["Q"]
    nbytes = (x.numel() * x.element_size() + 2 * Bm.numel() * Bm.element_size()
              + 2 * B * S * H * 4 + B * S * H * P * 4 + B * H * N * P * 4)
    per_chunk = 2 * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * N * P)
    flops = B * H * (S // Q) * per_chunk
    dtype = str(x.dtype).removeprefix("torch.")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_f32 = flops / PEAK_FLOPS["float32"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), t_f32


def phase_ssm_kernel_times(torch, ssd, ref, fa, flash_case):
    """The SSD kernel at both models' prefill shapes against its plain version
    and its bounds (no single PyTorch call computes it: library none); then
    the flash forward at zamba2's d = 112."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name in ("mamba2_prefill", "zamba2_prefill"):
        case = next(c for c in SSD_CASES if c[0] == name)
        inp = ssd_inputs(torch, gen, *case[1:])
        (bound_ms, bound_by), f32_bound_ms = ssd_bound(inp)
        N, P, Q = case[6], case[4], case[7]
        dtype = inp["x"].dtype
        # the shared memory a launch gives a block, from the built library
        occupancy = {"route": ssd.route(dtype),
                     "smem_bytes": ssd.kernel_smem_bytes(N, P, Q, dtype),
                     "blocks_per_sm": ssd.blocks_per_sm(N, P, Q, dtype)}
        print(f"  ssd_scan {name}: route {occupancy['route']}, {occupancy['smem_bytes']} bytes "
              f"of shared memory per block, {occupancy['blocks_per_sm']} blocks per SM")
        check(occupancy["smem_bytes"] == ssd.smem_bytes(N, P, Q, dtype),
              f"ssd_scan {name}: the library gives a block {occupancy['smem_bytes']} bytes, "
              f"kernels/ssd_scan.py's layout {ssd.smem_bytes(N, P, Q, dtype)}")
        out[name] = {**occupancy,
            "ms": median_ms(lambda: ssd_run(ssd, ref, inp, plain=False), reps=10),
            "plain_ms": median_ms(lambda: ssd_run(ssd, ref, inp, plain=True), reps=2, trials=3,
                                  warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "f32_fma_bound_ms": f32_bound_ms,
            "library_ms": None, "shape": "B{} S{} H{} P{} G{} N{} Q{} bf16".format(*case[1:8])}
        t = out[name]
        print(f"  ssd_scan {name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"f32-FMA bound {f32_bound_ms:.4f} ms; kernel / bound {t['ms'] / bound_ms:.2f}")
        del inp
    out["flash_d112"] = phase_times(fa, torch, flash_case)
    return out


# ---------------------------------------------------------------------------
# The dense configs (ROADMAP A8a) served, llama-1b trained under ZeRO-3 and
# ZeRO-1, gpt-125m trained
# ---------------------------------------------------------------------------

def phase_dense_serve(torch, np, fa, ops, tacc, engine, build, counters, cfg):
    """One dense config at full width, weights from the seed:
    DENSE_REQUESTS x DENSE_PROMPT + DENSE_NEW through ``Batcher``, the counts
    set to 0 just before and read just after (one flash launch per layer per
    prefill batch, at the config's head dim); tokens in the vocab, logits
    finite; prefill and decode ms, tokens/s, busy shares, peak memory.  At
    d 100 (llama-3b) also the kernel against its plain version on each
    layer's own inputs (``phase_layers``)."""
    dev = torch.device("cuda")
    model = build(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded "
          f"{cfg.padded_vocab}), {cfg.dtype}, {model.n_params() / 1e9:.3f}B params, whole; "
          f"init {init_s:.2f} s, peak {init_peak:.2f} GiB")
    max_len = DENSE_PROMPT + DENSE_NEW
    progs = engine.make_serve_programs(model, seq_len=DENSE_PROMPT, max_len=max_len,
                                       device=dev)
    rng = np.random.RandomState(SEED + cfg.n_layers)
    prompts = [rng.randint(0, cfg.vocab, DENSE_PROMPT).astype(np.int32)
               for _ in range(DENSE_REQUESTS)]
    done, serve_s, launches, peak_gib, finite = batched_serve(
        torch, engine, counters, progs, params, prompts, DENSE_PROMPT, max_len, DENSE_NEW)
    L, d = cfg.n_layers, cfg.head_dim_
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests x {DENSE_PROMPT} prompt tokens, {n_tok} new tokens in "
          f"{serve_s:.3f} s; flash launches {launches['flash_attention_fwd']} ({L} per prefill), "
          f"at d {d}: {launches[f'flash_attention_fwd_d{d}']}")
    check(launches["flash_attention_fwd"] == L and launches[f"flash_attention_fwd_d{d}"] == L,
          f"{cfg.name}: flash launched {launches['flash_attention_fwd']} times "
          f"({launches[f'flash_attention_fwd_d{d}']} at d {d}), {L} expected")
    check(len(done) == DENSE_REQUESTS and all(len(r.out) == DENSE_NEW for r in done),
          f"{cfg.name}: not every request got its tokens")
    check(all(0 <= tok < cfg.vocab for r in done for tok in r.out),
          f"{cfg.name}: a token is outside the vocab")
    check(finite, f"{cfg.name}: non-finite logits in the serve run")
    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    batch = {"tokens": toks}
    out = {"arch": cfg.name, "n_layers": L, "head_dim": d, "params_b": model.n_params() / 1e9,
           "requests": len(done), "prompt_len": DENSE_PROMPT,
           "new_tokens_per_request": DENSE_NEW, "serve_s": serve_s,
           "tokens_per_s": n_tok / serve_s, "launches": launches, "peak_gib": peak_gib,
           "init_s": init_s}
    if d % 8:
        out["layer_worst_error"] = phase_layers(torch, tacc, ops, fa, model, params, batch)
    out.update(serve_times(torch, progs, params, toks))
    del params
    print(f"  prefill {out['prefill_ms']:.2f} ms (batch {DENSE_REQUESTS} x {DENSE_PROMPT}), "
          f"decode {out['decode_ms_per_step']:.2f} ms per step, {out['tokens_per_s']:.1f} "
          f"tokens/s end to end; card busy share prefill {out['device_busy_prefill']}, decode "
          f"{out['device_busy_decode']}; peak memory {peak_gib:.2f} GiB")
    return out


def zero3_gathers(metas, n_data):
    """The gathered keys of one micro-step under ZeRO-3, from the gather
    plan: each sharded leaf stacked over "layers" (a block tree, the
    hybrid's tail) once per layer, the hybrid's "groups" once per group (a
    group's blocks are gathered at once), any other (the embedding, final
    norm and head, the hybrid's shared block) once.  The fsdp adjoint
    reduce-scatters each key once a micro-step."""
    from repro_torch.models.common import fsdp_dims, make_rules, meta_leaves
    return sum(mt.shape[0] if mt.axes[0] in ("layers", "group") else 1
               for d, mt in zip(fsdp_dims(metas, make_rules(3, n_data)), meta_leaves(metas))
               if d is not None)


def leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves, in flatten order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


@contextlib.contextmanager
def adjoint_rs_counter(collectives, ring_dma):
    """Counts the fused reduce-scatter launches made inside ZeRO-3's fsdp
    adjoint (``collectives.fsdp_reduce_scatter``): every rank of the ring is
    in it when one of them launches, so a launch made by a thread that is
    inside it counts.  Yields a one-element list holding the count."""
    import threading
    inside = threading.local()
    count = [0]
    orig_rs, orig_launch = collectives.fsdp_reduce_scatter, ring_dma.reduce_scatter_fused

    def adjoint(*a, **kw):
        inside.on = True
        try:
            return orig_rs(*a, **kw)
        finally:
            inside.on = False

    def launch(*a, **kw):
        out = orig_launch(*a, **kw)
        if getattr(inside, "on", False) and a[0][0].is_cuda:
            count[0] += 1                 # one launcher thread at a time (rendezvous)
        return out

    collectives.fsdp_reduce_scatter, ring_dma.reduce_scatter_fused = adjoint, launch
    try:
        yield count
    finally:
        collectives.fsdp_reduce_scatter, ring_dma.reduce_scatter_fused = orig_rs, orig_launch


def phase_zero_train(torch, np, get_config, build, mesh_mod, counters):
    """llama-1b at full width, the paper's shape (micro-batch 1 x LLAMA_SEQ
    per rank), remat, hier, backend pallas, on a (pod=2, data=2) ThreadMesh:
    LLAMA_STEPS ZeRO-3 steps, then LLAMA_STEPS ZeRO-1 steps from the same
    init and batches, the counts set to 0 just before each run and read
    just after.  Both runs' losses are finite and agree within
    ZERO_LOSS_ATOL, their step-0 gradient norms within ZERO_GRAD_NORM_RTOL,
    and their parameters after step 0 within ZERO_PARAM_REL_L2; ZeRO-3
    launched the fused reduce-scatter for its fsdp adjoint once per
    gathered (leaf, layer) per micro-step; ms a step (host clock, the steps
    after the first), tokens/s, peak memory of each run, and the card's
    busy share over one more step under torch.profiler until [38] joined
    (now not measured)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import unshard_params
    from repro_torch.core import balance, collectives
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ring_dma
    from repro_torch.models.common import fsdp_dims, make_rules
    from repro_torch.train.trainer import make_train_program
    cfg = get_config(LLAMA_ARCH)
    model = build(cfg)
    m = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 2, micro_batch=1)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    batches = [synthetic_batch(SEED, s, plan.n_micro_max, plan.micro_batch * m.size,
                               LLAMA_SEQ, cfg.vocab) for s in range(LLAMA_STEPS)]
    n_tokens = int(np.prod(batches[0]["tokens"].shape))
    metas = model.abstract_params()
    dims = fsdp_dims(metas, make_rules(3, m.shape["data"]))
    gathers = zero3_gathers(metas, m.shape["data"])
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"{model.n_params() / 1e9:.3f}B params, bf16 params, f32 master state; mesh {m.shape}, "
          f"{plan.n_micro_max} micro-step of {plan.micro_batch} x {LLAMA_SEQ} per rank, "
          f"{n_tokens} tokens per step; remat on; ZeRO-3 shards {sum(d is not None for d in dims)}"
          f" of {len(dims)} leaves over data, {gathers} gathers a micro-step")
    out, after_step0 = {}, {}
    for zero in (3, 1):
        prog = make_train_program(model, m, RunConfig(
            zero_stage=zero, collective_mode="hier", backend="pallas",
            learning_rate=LLAMA_LR), plan)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = prog.init_fn(params)
        counters.reset()
        losses, grad_norms, step_ms = [], [], []
        with adjoint_rs_counter(collectives, ring_dma) as adjoint:
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, met = prog.step_fn(state, batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                losses.append(met["loss"].item())
                grad_norms.append(met["grad_norm"].item())
                if i == 0:                 # full leaves after step 0, on the host
                    full = (unshard_params([state[0]["params"], state[1]["params"]], metas)
                            if zero == 3 else state[0]["params"])
                    after_step0[zero] = [p.to("cpu") for p in tree_leaves(full)]
                    del full
        launches = counters.read()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        shard = sum(p.numel() for p in tree_leaves(state[0]["params"]))
        ms = statistics.median(step_ms[1:])
        busy = None         # one more step under torch.profiler went to make room for [38]
        out[f"zero{zero}"] = {
            "losses": losses, "step_ms": step_ms, "ms_per_step": ms,
            "tokens_per_s": n_tokens / ms * 1e3, "device_busy_one_more_step": busy,
            "peak_gib": peak_gib, "launches": launches, "adjoint_rs_launches": adjoint[0],
            "params_per_rank": shard, "grad_norms": grad_norms}
        print(f"  ZeRO-{zero}: losses {['%.6f' % x for x in losses]}; grad norms "
              f"{['%.6f' % x for x in grad_norms]}; ms per step "
              f"{['%.1f' % x for x in step_ms]}, {n_tokens / ms * 1e3:.1f} tokens/s (steps after "
              f"the first); card busy share not measured; "
              f"peak memory {peak_gib:.2f} GiB; {shard / 1e9:.3f}B parameters per rank; "
              f"launches {launches}; fused reduce-scatter launches in the fsdp adjoint "
              f"{adjoint[0]}")
        check(all(np.isfinite(losses)), f"ZeRO-{zero}: non-finite loss")
        want_fwd = 2 * cfg.n_layers * plan.n_micro_max * m.size * LLAMA_STEPS
        check(launches["flash_attention_fwd"] == want_fwd and
              launches["flash_attention_bwd"] == want_fwd // 2,
              f"ZeRO-{zero}: flash launches {launches['flash_attention_fwd']} / "
              f"{launches['flash_attention_bwd']}, {want_fwd} / {want_fwd // 2} expected")
        if zero == 3:
            want = gathers * plan.n_micro_max * LLAMA_STEPS
            check(adjoint[0] == want, f"ZeRO-3: {adjoint[0]} fused reduce-scatter launches "
                                      f"in the fsdp adjoint, {want} expected")
        else:
            check(adjoint[0] == 0, "ZeRO-1 ran the fsdp adjoint")
        del state, prog
    gap = max(abs(a - b) for a, b in zip(out["zero3"]["losses"], out["zero1"]["losses"]))
    print(f"  step losses ZeRO-3 vs ZeRO-1: largest difference {gap:.3e} (limit "
          f"{ZERO_LOSS_ATOL})  {'ok' if gap <= ZERO_LOSS_ATOL else 'FAIL'}")
    check(gap <= ZERO_LOSS_ATOL, "ZeRO-3 and ZeRO-1 step losses disagree")
    g3, g1 = out["zero3"]["grad_norms"][0], out["zero1"]["grad_norms"][0]
    norm_gap = abs(g3 - g1) / g1
    print(f"  step-0 gradient norm ZeRO-3 {g3:.6f} vs ZeRO-1 {g1:.6f}: relative difference "
          f"{norm_gap:.3e} (limit {ZERO_GRAD_NORM_RTOL})  "
          f"{'ok' if norm_gap <= ZERO_GRAD_NORM_RTOL else 'FAIL'}")
    diff2 = sum((a.cuda().float() - b.cuda().float()).square().sum().item()
                for a, b in zip(after_step0[3], after_step0[1]))
    ref2 = sum(b.cuda().float().square().sum().item() for b in after_step0[1])
    param_gap = (diff2 / ref2) ** 0.5
    print(f"  parameters after step 0, ZeRO-3 (rebuilt from its shards) vs ZeRO-1: relative "
          f"L2 {param_gap:.3e} (limit {ZERO_PARAM_REL_L2})  "
          f"{'ok' if param_gap <= ZERO_PARAM_REL_L2 else 'FAIL'}")
    after_step0.clear()
    check(norm_gap <= ZERO_GRAD_NORM_RTOL, "ZeRO-3 and ZeRO-1 step-0 gradient norms disagree")
    check(param_gap <= ZERO_PARAM_REL_L2, "ZeRO-3 and ZeRO-1 parameters after step 0 disagree")
    out.update(arch=cfg.name, seq=LLAMA_SEQ, tokens_per_step=n_tokens, loss_gap=gap,
               grad_norm_gap=norm_gap, param_rel_l2_after_step0=param_gap,
               gathers_per_micro_step=gathers)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_gpt_train(torch, np, get_config, build, mesh_mod, counters):
    """gpt-125m at full width: GPT_STEPS ZeRO-1 steps on a (pod=2, data=2)
    ThreadMesh, ``uniform_plan(2, 4, GPT_MICRO_BATCH)`` at seq GPT_SEQ,
    remat, hier, backend pallas, one memorize batch: finite losses that
    fall; ms a step and peak memory."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.trainer import make_train_program
    cfg = get_config(GPT_ARCH)
    model = build(cfg)
    m = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 4, micro_batch=GPT_MICRO_BATCH)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    batch = synthetic_batch(SEED, 0, plan.n_micro_max, plan.micro_batch * m.size, GPT_SEQ,
                            cfg.vocab)
    n_tokens = int(np.prod(batch["tokens"].shape))
    prog = make_train_program(model, m, RunConfig(collective_mode="hier", backend="pallas",
                                                  learning_rate=TRAIN_LR), plan)
    torch.cuda.reset_peak_memory_stats()
    state = prog.init_fn(params)
    counters.reset()
    losses, step_ms = [], []
    for _ in range(GPT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = prog.step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(met["loss"].item())
    launches = counters.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{model.n_params() / 1e9:.3f}B params; mesh {m.shape}, plan {plan.micro_per_pod} "
          f"micro-steps of {plan.micro_batch} x {GPT_SEQ} per rank, {n_tokens} tokens per step; "
          f"ZeRO-1 losses {['%.6f' % x for x in losses]}; ms per step "
          f"{['%.1f' % x for x in step_ms]}; peak memory {peak_gib:.2f} GiB; launches {launches}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{cfg.name}: losses not finite or not falling: {losses}")
    check(launches["flash_attention_bwd"] == cfg.n_layers * plan.n_micro_max * m.size * GPT_STEPS,
          f"{cfg.name}: {launches['flash_attention_bwd']} flash backward launches")
    del state, prog, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "seq": GPT_SEQ, "losses": losses, "step_ms": step_ms,
            "tokens_per_step": n_tokens, "peak_gib": peak_gib, "launches": launches}


# ---------------------------------------------------------------------------
# MoE training: the grouped matmul's backward, full-width moonshot under ZeRO-1
# ---------------------------------------------------------------------------

def gmm_bwd_inputs(torch, gen, G, M, K, N, dtype, layout):
    """x, w as ``gmm_inputs``; dy (G, M, N) unit normals, zero in the rows
    where x's row is zero (a dropped token's slot gets no gradient)."""
    x, w = gmm_inputs(torch, gen, G, M, K, N, dtype, layout)
    dy = torch.randn(G, M, N, generator=gen, device="cuda").to(x.dtype)
    dy[x.abs().amax(-1) == 0] = 0
    return x, w, dy


def phase_gmm_bwd_kernels(torch, gmm, ref, ops):
    """The backward kernels against their plain version, case by case
    (``GMM_BWD_CASES``): dx and dw each within GMM_LIMITS, a dropped token's
    row of dx zero, a second launch the same bits, the route of each printed;
    every backward route reached.  Then ``ops.expert_ffn_gmm``'s gradients
    (the autograd Function: 3 forward and 6 backward launches) at moonshot's
    expert shape against autograd of the same composition through the plain
    version, within FFN_LIMITS."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results, failed = {}, []
    for name, G, M, K, N, dt, layout in GMM_BWD_CASES:
        x, w, dy = gmm_bwd_inputs(torch, gen, G, M, K, N, dt, layout)
        before = gmm.bwd_launches
        dx, dw = gmm.grouped_matmul_bwd(x, w, dy)
        want = ref.grouped_matmul_bwd(x, w, dy)
        torch.cuda.synchronize()
        check(gmm.bwd_launches == before + 2, f"{name}: {gmm.bwd_launches - before} launches")
        routes = {which: gmm.bwd_route(x, w, dy, which) for which in ("dx", "dw")}
        scheds = {which: gmm.bwd_schedule(G, M, K, N, which, sms)
                  if routes[which].endswith("wgmma") else None for which in ("dx", "dw")}
        res, ok = {}, True
        for which, got, wnt in (("dx", dx, want[0]), ("dw", dw, want[1])):
            check(got.shape == wnt.shape and got.dtype == wnt.dtype and got.is_contiguous(),
                  f"{name} {which}: {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()), f"{name} {which}: non-finite")
            err = gmm_error(got, wnt)
            good = gmm_ok(err, dt)
            ok &= good
            sched = scheds[which]
            res[which] = {**err, "route": routes[which],
                          "schedule": sched.name if sched else None,
                          "tile_k": sched.tile_k if sched else None}
            print(f"  {name:20s} {which} ({G},{M},{K})x({G},{K},{N}) {dt:8s} {layout:10s} "
                  f"{routes[which]:8s} {sched.name if sched else '':10s} {format_gmm(err, dt)}  "
                  f"{'ok' if good else 'FAIL'}")
        zero_rows_ok = bool((dx[x.abs().amax(-1) == 0] == 0).all())
        again = gmm.grouped_matmul_bwd(x, w, dy)
        repeat_ok = torch.equal(again[0], dx) and torch.equal(again[1], dw)
        if not (ok and zero_rows_ok and repeat_ok):
            failed.append(name)
            print(f"  {name}: zero rows of dx zero {zero_rows_ok}, bit-equal on repeat "
                  f"{repeat_ok}")
        results[name] = res
        del x, w, dy, dx, dw, want, again
    check(not failed, f"the grouped-matmul backward disagrees with its plain version in {failed}")
    reached = sorted({r["route"] for v in results.values() for r in v.values()})
    check(reached == sorted(gmm.BWD_ROUTES), f"the cases reached the routes {reached} only")
    depths = sorted({r["tile_k"] for v in results.values() for r in v.values() if r["tile_k"]})
    print(f"  stage depths bwd_schedule picked: {depths} (it can pick {list(gmm.BWD_TILE_K)})")
    check(depths == sorted(gmm.BWD_TILE_K), f"the cases reached the stage depths {depths} only")

    # the autograd Function at moonshot's expert shape, w a layer slice
    E, C, D, F = 64, 480, 2048, 1408
    buf = torch.randn(E, C, D, generator=gen, device="cuda").bfloat16()
    stacked = [(torch.randn(2, E, a, b, generator=gen, device="cuda") * a ** -0.5).bfloat16()
               for a, b in ((D, F), (D, F), (F, D))]
    ct = torch.randn(E, C, D, generator=gen, device="cuda").bfloat16()

    def grads():
        leaves = [buf.detach().requires_grad_()] + [s.detach().requires_grad_()
                                                     for s in stacked]
        out = ops.expert_ffn_gmm(leaves[0], *(s[1] for s in leaves[1:]))
        return torch.autograd.grad(out, leaves, ct)

    gmm.reset_counts()
    got = grads()
    torch.cuda.synchronize()
    launches = (gmm.launches, gmm.bwd_launches)
    with patched(gmm, "grouped_matmul", ref.grouped_matmul):
        want = grads()
    fn_err = {}
    for name, g, wnt in zip(("buf", "w1", "w3", "w2"), got, want):
        err = gmm_error(g[1] if name != "buf" else g, wnt[1] if name != "buf" else wnt)
        fn_err[name] = err
        print(f"  expert_ffn_gmm gradient of {name}: {format_gmm(err, 'bfloat16', FFN_LIMITS)}"
              f"  {'ok' if gmm_ok(err, 'bfloat16', FFN_LIMITS) else 'FAIL'}")
    print(f"  expert_ffn_gmm forward + backward: {launches[0]} forward, {launches[1]} backward "
          f"launches (3 and 6 expected)")
    check(launches == (3, 6), f"expert_ffn_gmm launched {launches}, (3, 6) expected")
    check(all(gmm_ok(e, "bfloat16", FFN_LIMITS) for e in fn_err.values()),
          "expert_ffn_gmm's gradients disagree with the plain composition's")
    check(all(not g[0].any() for g in got[1:]), "gradient in the stacked leaves' other layer")
    return {"cases": results, "function": fn_err}


def moe_grad_gate(torch, gmm, ref, model, params, batch):
    """The step-0 gate (see MOE_TRAIN_LAYERS' note) on ``batch`` (rank 0's
    first micro-batch), with remat as in the step."""
    from repro_torch.core.tree import flatten
    ps, rebuild = flatten(params)
    log = []
    real_bwd = gmm.grouped_matmul_bwd

    def recording(x, w, dy, need_dx=True, need_dw=True):
        dx, dw = real_bwd(x, w, dy, need_dx, need_dw)
        log.append((x, w, dy, dx, dw))
        return dx, dw

    def leaf_grads():
        req = [p.detach().requires_grad_() for p in ps]
        ls, cnt, aux = model.loss(rebuild(req), batch, remat=True)
        return torch.autograd.grad(ls + aux * cnt, req)

    with patched(gmm, "grouped_matmul_bwd", recording):
        got = leaf_grads()
    torch.cuda.synchronize()
    per_call, ok = [], True
    for i, (x, w, dy, dx, dw) in enumerate(log):
        want = ref.grouped_matmul_bwd(x, w, dy)
        errs = {}
        for which, g, wnt in (("dx", dx, want[0]), ("dw", dw, want[1])):
            if g is None:
                continue
            errs[which] = gmm_error(g, wnt)
            ok &= gmm_ok(errs[which], "bfloat16")
            print(f"  step 0, backward launch pair {i} ({tuple(x.shape)} x {tuple(w.shape)}) "
                  f"{which}: {format_gmm(errs[which], 'bfloat16')}")
        per_call.append(errs)
        del want
    log.clear()
    with patched(gmm, "grouped_matmul", ref.grouped_matmul):
        want = leaf_grads()
    names = {id(p): n for n, p in (("router", params["blocks"]["moe"]["router"]),
                                   ("w1", params["blocks"]["moe"]["w1"]),
                                   ("w3", params["blocks"]["moe"]["w3"]),
                                   ("w2", params["blocks"]["moe"]["w2"]))}
    leaf_err = {}
    for p, g, wnt in zip(ps, got, want):
        name = names.get(id(p))
        if name is None:
            continue
        leaf_err[name] = gmm_error(g.float().flatten(0, -2), wnt.float().flatten(0, -2))
        gated = name != "router"
        print(f"  step 0, gradient of the {name} leaf against the plain gmm's: "
              f"{format_gmm(leaf_err[name], 'bfloat16', FFN_LIMITS)}"
              + (f"  {'ok' if gmm_ok(leaf_err[name], 'bfloat16', FFN_LIMITS) else 'FAIL'}"
                 if gated else "  (printed, not gated)"))
        if gated:
            ok &= gmm_ok(leaf_err[name], "bfloat16", FFN_LIMITS)
    check(len(per_call) == 3 * MOE_TRAIN_LAYERS, f"{len(per_call)} backward launch pairs")
    check(ok, "the step-0 gradient gate failed")
    return {"launch_pairs": per_call, "leaves": leaf_err}


def adjoint_copy_times(torch, E, D, F, n=2):
    """The fsdp adjoint's layout copy at an expert stack (E, D, F) in bf16
    gathered on dim 1 over ``n`` ranks, and the add of its result into the
    rank's f32 shard sum: the port's layout (``collectives.
    fsdp_reduce_scatter``, the reference's: ``dim`` moved first, the result
    a strided view of the shard) and, as a yardstick the port does not run,
    the rank's part taken in the shard's own layout (E contiguous pieces;
    the same elementwise sums without a codec).  ms each, CUDA events,
    medians."""
    g = torch.randn(E, D, F, device="cuda", dtype=torch.bfloat16)
    acc = torch.zeros(E, D // n, F, device="cuda", dtype=torch.float32)
    moved = g.movedim(1, 0).reshape(n, -1).contiguous()[0].reshape(D // n, E, F).movedim(0, 1)
    own = g.reshape(E, n, -1).transpose(0, 1).reshape(n, -1)[0].reshape(E, D // n, F)
    out = {"bytes": g.numel() * g.element_size(),
           "moved_copy_ms": median_ms(lambda: g.movedim(1, 0).reshape(n, -1).contiguous()),
           "own_copy_ms": median_ms(lambda: g.reshape(E, n, -1).transpose(0, 1).reshape(n, -1)),
           "moved_add_ms": median_ms(lambda: acc.add_(moved)),
           "own_add_ms": median_ms(lambda: acc.add_(own))}
    del g, acc, moved, own
    return out


def phase_moe_train(torch, np, get_config, build, mesh_mod, hetccl, gmm, ref, counters):
    """moonshot-v1-16b-a3b at full width, 1 layer (MOE_TRAIN_LAYERS' note),
    on a MOE_TRAIN_MESH ThreadMesh, ``uniform_plan(2, MOE_TRAIN_MICRO,
    micro_batch=1)``, 1 x MOE_TRAIN_SEQ tokens a micro-step and rank, remat,
    hier, backend pallas, no codec: the step-0 gate first, then
    MOE_TRAIN_STEPS ZeRO-3 steps and MOE_TRAIN_STEPS ZeRO-1 steps from one
    init and the same batches, the counts set to 0 just before each run and
    read just after: per layer, micro-step and rank 6 forward gmm launches
    (3, and 3 again in remat's recompute) and 6 backward (dx and dw of
    each), all on the wgmma routes, 2 flash forward and 1 backward at d 128;
    the fused rings under ZeRO-1 once per bucket (reduce-scatter) and per
    bucket and leaf (all-gather), under ZeRO-3 once per gathered (leaf,
    layer) and micro-step in the fsdp adjoint (the expert stacks among
    them) and once per leaf in the pod all-reduce; finite losses; the two
    stages' step-0 gradient norms within ZERO_GRAD_NORM_RTOL, and their
    parameters after step 0 (ZeRO-3's rebuilt by ``unshard_params``) within
    ZERO_PARAM_REL_L2 over the tree and MOE_ZERO_LEAF_REL_L2 per leaf; ms a
    step (host clock, the steps after the first), tokens/s, the card's busy
    share over one more step, the peak memory, and the memory at the
    boundaries of one more step (``launch.memory_breakdown.step_memory``);
    and the fsdp adjoint's layout copy at moonshot's expert stack
    (``adjoint_copy_times``)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import unshard_params
    from repro_torch.core import balance, collectives
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ring_dma
    from repro_torch.launch.memory_breakdown import step_memory
    from repro_torch.models.common import fsdp_dims, make_rules
    from repro_torch.train.trainer import make_train_program
    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), n_layers=MOE_TRAIN_LAYERS,
                              loss_chunk=MOE_TRAIN_LOSS_CHUNK)
    model = build(cfg)
    m = mesh_mod.ThreadMesh(MOE_TRAIN_MESH, device="cuda")
    plan = balance.uniform_plan(2, MOE_TRAIN_MICRO, micro_batch=1)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    batches = [synthetic_batch(SEED, s, plan.n_micro_max, plan.micro_batch * m.size,
                               MOE_TRAIN_SEQ, cfg.vocab) for s in range(MOE_TRAIN_STEPS)]
    n_tokens = int(np.prod(batches[0]["tokens"].shape))
    T = plan.micro_batch * MOE_TRAIN_SEQ
    C = max(int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    metas = model.abstract_params()
    dims = fsdp_dims(metas, make_rules(3, m.shape["data"]))
    gathers = zero3_gathers(metas, m.shape["data"])
    print(f"  {cfg.name}: {cfg.n_layers} of 48 layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads x {cfg.head_dim_}, {cfg.n_experts} experts top-{cfg.top_k} "
          f"of d_ff {cfg.d_ff_expert} (capacity {C}), vocab {cfg.vocab}, "
          f"{model.n_params() / 1e9:.3f}B params, bf16 params, f32 master state; mesh "
          f"{m.shape}, {plan.n_micro_max} micro-steps of {plan.micro_batch} x {MOE_TRAIN_SEQ} "
          f"per rank, {n_tokens} tokens per step; remat on; loss chunk {cfg.loss_chunk}; "
          f"ZeRO-3 shards {sum(d is not None for d in dims)} of {len(dims)} leaves over data, "
          f"{gathers} gathers a micro-step")
    b0 = {k: torch.as_tensor(batches[0][k][0, :plan.micro_batch]).to("cuda", torch.long)
          for k in ("tokens", "labels")}
    gate = moe_grad_gate(torch, gmm, ref, model, params, b0)
    del b0
    shapes = [p.shape for p in tree_leaves(params)]
    out, after_step0 = {"step0_gate": gate}, {}
    for zero in (3, 1):
        prog = make_train_program(model, m, RunConfig(
            zero_stage=zero, collective_mode="hier", backend="pallas",
            learning_rate=MOE_TRAIN_LR), plan)
        n_buckets = len(hetccl._make_buckets(
            [torch.empty(sh, dtype=torch.float32, device="meta") for sh in shapes],
            prog.comm.bucket_bytes))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = prog.init_fn(params)
        if zero == 1:
            del params                  # the ZeRO-1 ranks share the init's tensors
        counters.reset()
        losses, grad_norms, step_ms = [], [], []
        with adjoint_rs_counter(collectives, ring_dma) as adjoint:
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, met = prog.step_fn(state, batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                losses.append(met["loss"].item())
                grad_norms.append(met["grad_norm"].item())
                if i == 0:                 # full leaves after step 0, on the host
                    full = (unshard_params([state[0]["params"], state[1]["params"]], metas)
                            if zero == 3 else state[0]["params"])
                    after_step0[zero] = [p.to("cpu") for p in tree_leaves(full)]
                    del full
        launches = counters.read()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(step_ms[1:])
        busy = None         # one more step under torch.profiler went to make room for [38]
        print(f"  ZeRO-{zero}: losses {['%.6f' % x for x in losses]}; grad norms "
              f"{['%.6f' % x for x in grad_norms]}; ms per step "
              f"{['%.1f' % x for x in step_ms]}, {n_tokens / ms * 1e3:.1f} tokens/s (steps after "
              f"the first); card busy share not measured; peak "
              f"memory {peak_gib:.2f} GiB; launches {launches}; fused reduce-scatter launches "
              f"in the fsdp adjoint {adjoint[0]}")
        print(f"  ZeRO-{zero}: memory at the boundaries of one more step:")
        state, segs, scratch, err = step_memory(torch, mesh_mod, prog, state, batches[-1])
        check(err is None, f"ZeRO-{zero}: the memory step ran out of memory")
        check(all(np.isfinite(losses)), f"ZeRO-{zero}: non-finite loss")
        per = cfg.n_layers * plan.n_micro_max * m.size * MOE_TRAIN_STEPS
        want = {"grouped_matmul": 6 * per, "grouped_matmul_wgmma": 6 * per,
                "grouped_matmul_bwd": 6 * per, "grouped_matmul_bwd_dx_wgmma": 3 * per,
                "grouped_matmul_bwd_dw_wgmma": 3 * per, "flash_attention_fwd": 2 * per,
                "flash_attention_bwd": per, "collective_reduce": 0}
        n_adjoint = gathers * plan.n_micro_max * MOE_TRAIN_STEPS if zero == 3 else 0
        if zero == 3:
            want.update(ring_reduce_scatter=n_adjoint + len(shapes) * MOE_TRAIN_STEPS,
                        ring_all_gather=len(shapes) * MOE_TRAIN_STEPS)
        else:
            want.update(ring_reduce_scatter=n_buckets * MOE_TRAIN_STEPS,
                        ring_all_gather=(n_buckets + len(shapes)) * MOE_TRAIN_STEPS)
        for key, n in want.items():
            print(f"  ZeRO-{zero} {key}: {launches[key]} launches, {n} expected  "
                  f"{'ok' if launches[key] == n else 'FAIL'}")
        print(f"  ZeRO-{zero} fused reduce-scatters in the fsdp adjoint: {adjoint[0]}, "
              f"{n_adjoint} expected  {'ok' if adjoint[0] == n_adjoint else 'FAIL'}")
        check(all(launches[k] == n for k, n in want.items()) and adjoint[0] == n_adjoint,
              f"ZeRO-{zero}: the steps did not launch the kernels they imply")
        out[f"zero{zero}"] = {
            "losses": losses, "grad_norms": grad_norms, "step_ms": step_ms, "ms_per_step": ms,
            "tokens_per_s": n_tokens / ms * 1e3, "device_busy_one_more_step": busy,
            "peak_gib": peak_gib, "memory_step": segs, "scratch_kept_gib": scratch,
            "launches": launches, "expected_launches": want,
            "adjoint_rs_launches": adjoint[0], "n_buckets": n_buckets}
        del state, prog
        gc.collect()
        torch.cuda.empty_cache()
    g3, g1 = out["zero3"]["grad_norms"][0], out["zero1"]["grad_norms"][0]
    norm_gap = abs(g3 - g1) / g1
    rel = [((a.cuda().float() - b.cuda().float()).norm() / b.cuda().float().norm()).item()
           for a, b in zip(after_step0[3], after_step0[1])]
    diff2 = sum((a.cuda().float() - b.cuda().float()).square().sum().item()
                for a, b in zip(after_step0[3], after_step0[1]))
    param_gap = (diff2 / sum(b.cuda().float().square().sum().item()
                             for b in after_step0[1])) ** 0.5
    after_step0.clear()
    worst = max(range(len(rel)), key=rel.__getitem__)
    print(f"  step-0 gradient norm ZeRO-3 {g3:.6f} vs ZeRO-1 {g1:.6f}: relative difference "
          f"{norm_gap:.3e} (limit {ZERO_GRAD_NORM_RTOL})  "
          f"{'ok' if norm_gap <= ZERO_GRAD_NORM_RTOL else 'FAIL'}")
    print(f"  parameters after step 0, ZeRO-3 (rebuilt from its shards) vs ZeRO-1: relative "
          f"L2 {param_gap:.3e} (limit {ZERO_PARAM_REL_L2})  "
          f"{'ok' if param_gap <= ZERO_PARAM_REL_L2 else 'FAIL'}; worst leaf {worst} "
          f"{rel[worst]:.3e} (limit {MOE_ZERO_LEAF_REL_L2})  "
          f"{'ok' if rel[worst] <= MOE_ZERO_LEAF_REL_L2 else 'FAIL'}; per leaf "
          f"{['%.2e' % r for r in rel]}")
    check(norm_gap <= ZERO_GRAD_NORM_RTOL, "ZeRO-3 and ZeRO-1 step-0 gradient norms disagree")
    check(param_gap <= ZERO_PARAM_REL_L2 and rel[worst] <= MOE_ZERO_LEAF_REL_L2,
          "ZeRO-3 and ZeRO-1 parameters after step 0 disagree")
    copy = adjoint_copy_times(torch, cfg.n_experts, cfg.d_model, cfg.d_ff_expert,
                              m.shape["data"])
    print(f"  fsdp adjoint at an expert stack ({cfg.n_experts}, {cfg.d_model}, "
          f"{cfg.d_ff_expert}) bf16, {copy['bytes'] / 1e6:.1f} MB: layout copy "
          f"{copy['moved_copy_ms']:.4f} ms with the dim moved first, "
          f"{copy['own_copy_ms']:.4f} ms into the shard's layout (not run); the add of the "
          f"result into the f32 shard sum {copy['moved_add_ms']:.4f} / "
          f"{copy['own_add_ms']:.4f} ms")
    out.update(arch=cfg.name, layers=cfg.n_layers, capacity=C, seq=MOE_TRAIN_SEQ,
               tokens_per_step=n_tokens, params=model.n_params(), gathers_per_micro_step=gathers,
               grad_norm_gap=norm_gap, param_rel_l2_after_step0=param_gap,
               worst_leaf_rel_l2_after_step0=rel[worst], adjoint_copy=copy)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_gmm_bwd_times(torch, gmm, ref, bench_codec):
    """Each backward product at GMM_BWD_TIMED's shapes: the kernel and
    ``torch.bmm`` on the same transposed views (a yardstick the port never
    calls), L2 cold before each reading (``bench_codec.ColdReader``), in
    turns, back to back and replayed from CUDA graphs; the plain version's
    product (its f32 einsum) and the bound: the larger of 2 G M K N over the
    bf16 peak and the bytes (both operands read once, the output written
    once) over the memory rate."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    reader = bench_codec.ColdReader()
    side = torch.cuda.Stream()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, (G, M, K, N) in GMM_BWD_TIMED.items():
        x, w, dy = gmm_bwd_inputs(torch, gen, G, M, K, N, "bfloat16", "dense")
        for which in ("dx", "dw"):
            a, b = (dy, w.transpose(1, 2)) if which == "dx" else (x.transpose(1, 2), dy)
            chosen = gmm.bwd_schedule(G, M, K, N, which, sms)
            calls = {"kernel": [lambda which=which: gmm.grouped_matmul_bwd(
                         x, w, dy, which == "dx", which == "dw")],
                     "torch.bmm": [lambda a=a, b=b: torch.bmm(a, b)]}
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                r = bench_codec.cold_in_turns(reader, calls, GMM_BWD_ROUNDS)
            torch.cuda.current_stream().wait_stream(side)
            t_ops = 2 * G * M * K * N / PEAK_FLOPS["bfloat16"] * 1e3
            t_bytes = (a.numel() + b.numel() + a.shape[0] * a.shape[1] * b.shape[2]) * 2 \
                / HBM_BYTES_PER_S * 1e3
            t = out[f"{label}_{which}"] = {
                "shape": f"({G},{a.shape[1]},{a.shape[2]})@({G},{b.shape[1]},{b.shape[2]}) bf16",
                "route": gmm.bwd_route(x, w, dy, which), "schedule": chosen.name,
                "ms": statistics.median(r["kernel"]["stream"]),
                "graph_ms": statistics.median(r["kernel"]["graph"]),
                "library_ms": statistics.median(r["torch.bmm"]["stream"]),
                "library_graph_ms": statistics.median(r["torch.bmm"]["graph"]),
                "plain_ms": median_ms(lambda a=a, b=b: ref.grouped_matmul(a, b), reps=2,
                                      trials=3, warmup=1),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "readings": r}
            print(f"  {label} {which} at {t['shape']} ({t['route']}): kernel {t['ms']:.4f} ms "
                  f"(graph {t['graph_ms']:.4f}), torch.bmm {t['library_ms']:.4f} (graph "
                  f"{t['library_graph_ms']:.4f}), plain {t['plain_ms']:.4f}, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}); kernel / bound "
                  f"{t['graph_ms'] / t['bound_ms']:.2f}, kernel / torch.bmm "
                  f"{t['graph_ms'] / t['library_graph_ms']:.3f} (graphs); L2 cold, in turns, "
                  f"{GMM_BWD_ROUNDS} rounds; schedule {chosen.name}")
            for n in calls:
                g = r[n]["graph"]
                print(f"    {n:9s} graph {statistics.median(g):.4f} ms (readings "
                      f"{min(g):.4f}-{max(g):.4f})")
            del r
            gc.collect()
        del x, w, dy
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# SSM and hybrid training: the SSD backward, flash's backward at d 112
# ---------------------------------------------------------------------------

def ssd_bwd_inputs(torch, gen, B, S, H, P, G, N, Q, dtype, dt_scale, with_init, with_dfin):
    """``ssd_inputs`` at the model's layout, with dy (B,S,H,P) f32 and dfin
    (B,H,N,P) f32 or None."""
    inp = ssd_inputs(torch, gen, B, S, H, P, G, N, Q, dtype, dt_scale, with_init, "model")
    inp["dy"] = torch.randn(B, S, H, P, generator=gen, device="cuda")
    inp["dfin"] = (torch.randn(B, H, N, P, generator=gen, device="cuda") if with_dfin
                   else None)
    return inp


def ssd_bwd_run(ssd, inp, plain):
    """The six gradients (``SSD_BWD_OUTPUTS``) of the kernels (one forward
    launch that writes the chunk states, then the backward's launches) or of
    the plain backward."""
    args = (inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"], inp["Q"], inp["dy"],
            inp["dfin"], inp["init"])
    if plain:
        return ssd.ssd_scan_model_bwd_plain(*args)
    states = ssd.ssd_scan_model_states(*args[:6], inp["init"])[2]
    return ssd.ssd_scan_model_bwd(*args, states)


def ssd_bwd_errors(got, want):
    """gmm_error of each gradient both sides have, with its type; ok when each
    is within SSD_BWD_LIMITS of its type."""
    out = {}
    for name, g, w in zip(SSD_BWD_OUTPUTS, got, want):
        if g is not None and w is not None:
            out[name] = {**gmm_error(g, w), "dtype": str(g.dtype).removeprefix("torch.")}
    ok = all(gmm_ok(e, e["dtype"], SSD_BWD_LIMITS) for e in out.values())
    return out, ok


def ssd_bwd_mma_ok(errs):
    """The mma route's own check: every f32 gradient of SSD_BWD_MMA_CHECKED
    that ``errs`` holds within SSD_BWD_MMA_REL_L2."""
    return all(errs[k]["rel_l2"] <= SSD_BWD_MMA_REL_L2 for k in SSD_BWD_MMA_CHECKED if k in errs)


def format_ssd_bwd(errs):
    return "  ".join(f"{k} {e['dtype'][:4]} rel_l2 {e['rel_l2']:.2e} row {e['worst_row']:.2e}"
                     for k, e in errs.items())


def flash_bwd_case(torch, fa, ref, gen, case):
    """One BWD_CASES-style case of the flash backward against its plain
    version: (worst of dq / dk / dv's errors, ok, the inputs)."""
    name, B, Hq, Hkv, Sq, Sk, d, kind, window, k_len, dt, model_layout = case
    dtype = getattr(torch, dt)
    q, k, v = attention_inputs(gen, B, Hq, Hkv, Sq, Sk, d, dtype, model_layout)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    kw = dict(kind=kind, window=window, k_len=Sk if k_len is None else k_len)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, ref.attention_lse(q, k, **kw), **kw)
    torch.cuda.synchronize()
    errs = [bwd_error(g, w) for g, w in zip(got, want)]
    worst = {key: max(e[key] for e in errs) for key in errs[0]}
    rel_lim, row_lim = BWD_LIMITS[dt]
    ok = (worst["rel_l2"] <= rel_lim and worst["worst_row"] <= row_lim
          and all(bool(torch.isfinite(g).all()) for g in got))
    return worst, ok, (q, k, v, o, do, lse, kw)


def ssd_bwd_counted(ssd, before, route):
    """The counts moved by exactly two forward launches and two backward
    calls (three stages each) on ``route`` since ``before`` (ssd_bwd_counts)."""
    now = ssd_bwd_counts(ssd)
    return (now[0] - before[0] == 2 and now[1] - before[1] == 2
            and all(now[2][st] - before[2][st] == 2 for st in ssd.BWD_STAGES)
            and all(now[3][r] - before[3][r] == (2 if r == route else 0) for r in ssd.ROUTES))


def ssd_bwd_counts(ssd):
    return (ssd.launches, ssd.bwd_launches, dict(ssd.bwd_stage_launches),
            dict(ssd.bwd_route_launches))


def phase_ssd_bwd_kernels(torch, ssd, fa, ref):
    """The SSD backward against its plain version case by case
    (SSD_BWD_CASES), each gradient within SSD_BWD_LIMITS, the bf16 cases of
    dt scale 1 or more also within the mma route's own check
    (SSD_BWD_MMA_REL_L2), bit-equal on a second run, the counts moved by
    exactly the launches made (per run one forward launch and one backward
    call of three stages on the route the dtype picks); then the flash
    backward at d 112 (FLASH_D112_BWD_CASES) within BWD_LIMITS."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results, failed = {}, []
    for name, B, S, H, P, G, N, Q, dt, scale, init, dfin in SSD_BWD_CASES:
        inp = ssd_bwd_inputs(torch, gen, B, S, H, P, G, N, Q, dt, scale, init, dfin)
        route = ssd.route(inp["x"].dtype)
        before = ssd_bwd_counts(ssd)
        got = ssd_bwd_run(ssd, inp, plain=False)
        again = ssd_bwd_run(ssd, inp, plain=False)
        torch.cuda.synchronize()
        counted = ssd_bwd_counted(ssd, before, route)
        same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
        del again
        want = ssd_bwd_run(ssd, inp, plain=True)
        shapes = all((g is None) == (w is None) and (g is None or (
            g.shape == w.shape and g.dtype == w.dtype)) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got if g is not None)
        errs, ok = ssd_bwd_errors(got, want)
        mma_checked = route == "mma" and scale >= 1
        mma_ok = ssd_bwd_mma_ok(errs) if mma_checked else None
        ok = ok and same and counted and shapes and finite and mma_ok is not False
        print(f"  {name:25s} B{B} S{S} H{H} P{P} G{G} N{N} Q{Q} {dt:8s} {route:3s} "
              f"{format_ssd_bwd(errs)}; "
              + (f"mma check (rel L2 of {', '.join(SSD_BWD_MMA_CHECKED)} <= "
                 f"{SSD_BWD_MMA_REL_L2:.0e}) {mma_ok}; " if mma_checked else "")
              + f"bit-equal on repeat {same}, counts {counted}  {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        results[name] = {**errs, "route": route, "mma_check": mma_ok,
                         "bit_equal_on_repeat": same}
        del inp, got, want
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  limits (rel L2, worst row) by output type: {SSD_BWD_LIMITS}; the mma route's own "
          f"check {SSD_BWD_MMA_REL_L2:.0e}")
    check(not failed, f"the SSD backward disagrees with its plain version in {failed}")
    flash = {}
    for case in FLASH_D112_BWD_CASES:
        before = fa.bwd_launches
        worst, ok, inputs = flash_bwd_case(torch, fa, ref, gen, case)
        ok = ok and fa.bwd_launches == before + 1
        dt = case[10]
        print(f"  flash backward {case[0]:20s} {dt:8s} dq/dk/dv worst: rel_l2 "
              f"{worst['rel_l2']:.3e} worst_row {worst['worst_row']:.3e} (limits "
              f"{BWD_LIMITS[dt]})  {'ok' if ok else 'FAIL'}")
        check(ok, f"flash's backward at d 112 disagrees with its plain version in {case[0]}")
        flash[case[0]] = {**worst, "inputs": inputs} if case[0] == "zamba2_train_d112" else worst
    return results, flash


def ssm_grad_gate(torch, ssd, fa, ref, model, params, batch):
    """The step-0 gate on ``batch`` (rank 0's micro-batch), remat as in the
    step: every SSD backward launch against the plain backward of the same
    inputs within SSD_BWD_LIMITS, and every flash backward launch (d 112)
    against its plain version within BWD_LIMITS."""
    from repro_torch.core.tree import flatten
    ps, rebuild = flatten(params)
    ssd_log, fa_log = [], []
    real_ssd, real_fa = ssd.ssd_scan_model_bwd, fa.flash_attention_bwd

    def rec_ssd(*a, **kw):
        out = real_ssd(*a, **kw)
        ssd_log.append((a, out))
        return out

    def rec_fa(q, k, v, o, do, lse, **kw):
        out = real_fa(q, k, v, o, do, lse, **kw)
        fa_log.append(((q, k, v, o, do), kw, out))
        return out

    with patched(ssd, "ssd_scan_model_bwd", rec_ssd), patched(fa, "flash_attention_bwd", rec_fa):
        req = [p.detach().requires_grad_() for p in ps]
        ls, cnt, aux = model.loss(rebuild(req), batch, remat=True)
        torch.autograd.grad(ls + aux * cnt, req)
        del req
    torch.cuda.synchronize()
    worst, ok, n_ssd = {}, True, len(ssd_log)
    while ssd_log:
        (x, dt, a, Bm, Cm, chunk, dy, dfin, init, _states), got = ssd_log.pop(0)
        errs, good = ssd_bwd_errors(got, ssd.ssd_scan_model_bwd_plain(x, dt, a, Bm, Cm, chunk,
                                                                      dy, dfin, init))
        ok &= good
        for k, e in errs.items():
            for m in ("rel_l2", "worst_row"):
                worst.setdefault(k, {})[m] = max(worst.get(k, {}).get(m, 0.0), e[m])
            worst[k]["dtype"] = e["dtype"]
    print(f"  step 0, {n_ssd} SSD backward launches against the plain backward, worst: "
          f"{format_ssd_bwd(worst)}  {'ok' if ok else 'FAIL'}")
    flash_worst, n_fa = {"rel_l2": 0.0, "worst_row": 0.0}, len(fa_log)
    while fa_log:
        (q, k, v, o, do), kw, got = fa_log.pop(0)
        lse = ref.attention_lse(q, k, kind=kw["kind"], window=kw["window"], k_len=kw["k_len"],
                                scale=kw["scale"])
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
        for g, w in zip(got, want):
            e = bwd_error(g, w)
            for m in flash_worst:
                flash_worst[m] = max(flash_worst[m], e[m])
        del want, lse
    if n_fa:
        rel_lim, row_lim = BWD_LIMITS["bfloat16"]
        fa_ok = flash_worst["rel_l2"] <= rel_lim and flash_worst["worst_row"] <= row_lim
        ok &= fa_ok
        print(f"  step 0, {n_fa} flash backward launches (d {model.cfg.head_dim_}) against the "
              f"plain backward, worst: rel_l2 {flash_worst['rel_l2']:.3e} worst_row "
              f"{flash_worst['worst_row']:.3e} (limits {BWD_LIMITS['bfloat16']})  "
              f"{'ok' if fa_ok else 'FAIL'}")
    gc.collect()
    torch.cuda.empty_cache()
    check(ok, "the step-0 gradient gate failed")
    return {"ssd_launches": n_ssd, "ssd_worst": worst, "flash_launches": n_fa,
            "flash_worst": flash_worst if n_fa else None}


def forward_step_loss(torch, tacc, model, params, batch, plan, ranks, variants):
    """Step 0's loss over every rank's micro-batches of ``batch`` (the
    trainer's sum of token losses over its token count), forward only, with
    each op of ``variants`` ({op: fn}) in place of its ``cuda`` variant."""
    loss, count = 0.0, 0.0
    with contextlib.ExitStack() as stack:
        for op, fn in variants.items():
            stack.enter_context(patched_variant(tacc, op, "cuda", fn))
        stack.enter_context(torch.inference_mode())
        for i in range(plan.n_micro_max):
            for r in range(ranks):
                mb = {k: torch.as_tensor(batch[k][i, r * plan.micro_batch:(r + 1)
                                                  * plan.micro_batch]).to("cuda", torch.long)
                      for k in ("tokens", "labels")}
                ls, cnt, _ = model.loss(params, mb, remat=False)
                loss += ls.item()
                count += cnt.item()
    return loss / count


def ssd_state_dropped(real):
    """A planted fault of the SSD op, a control of [28]'s loss check:
    ``real`` run on each chunk as a sequence of its own, so that no state
    passes from chunk to chunk (the final state is the last chunk's)."""
    def fn(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
        Bb, S = x.shape[:2]
        nc = S // chunk

        def cut(t):
            return t.reshape(Bb * nc, chunk, *t.shape[2:])

        y, fin = real(cut(x), cut(dt), cut(a_cum), cut(B_in), cut(C_in), chunk)
        return y.reshape(Bb, S, *y.shape[2:]), fin.reshape(Bb, nc, *fin.shape[1:])[:, -1]
    return fn


def ssd_dt_one_late(real):
    """A planted fault of the SSD op: ``real`` reading each position's dt
    one position late (an index off by one)."""
    def fn(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
        return real(x, dt.roll(1, 1), a_cum, B_in, C_in, chunk, init_state)
    return fn


def attention_unmasked(real):
    """A planted fault of the attention op: ``real`` with no causal mask."""
    def fn(q, k, v, **kw):
        return real(q, k, v, **{**kw, "kind": "bidir"})
    return fn


# [28]'s planted faults of the loss check: {name: (op, fault)}; the
# attention fault only where the model has attention
SSM_LOSS_FAULTS = {"ssd_dt_one_late": ("ssd_scan", ssd_dt_one_late),
                   "ssd_state_dropped": ("ssd_scan", ssd_state_dropped),
                   "attention_unmasked": ("attention", attention_unmasked)}


def ssm_stage_run(torch, np, hetccl, ssd, collectives, ring_dma, counters, model, m, plan,
                  batches, zero, init, shapes, gathers):
    """``train_stage_run`` of the SSM and hybrid models (SSM_TRAIN_LR, one
    more step profiled), with the launches expected from the layer count
    and, under ZeRO-3, the gather plan (``zero3_gathers``), and the SSD
    backward's card time and the five kernels with the most card time in
    the profiled step."""
    cfg = model.cfg
    layers = cfg.n_layers
    n_shared = layers // cfg.attn_every if cfg.family == "hybrid" else 0
    run, after_step0 = train_stage_run(torch, np, hetccl, collectives, ring_dma, counters,
                                       model, m, plan, batches, zero, init, lr=SSM_TRAIN_LR)
    kernel_us = run.pop("kernel_us")
    per = plan.n_micro_max * m.size * SSM_TRAIN_STEPS
    n_adjoint = gathers * plan.n_micro_max * SSM_TRAIN_STEPS if zero == 3 else 0
    want = {"ssd_scan": 2 * layers * per, "ssd_scan_mma": 2 * layers * per,
            "ssd_scan_bwd": layers * per, "ssd_scan_bwd_mma": layers * per,
            "ssd_scan_bwd_f32": 0,
            **{f"ssd_scan_bwd_{st}": layers * per for st in ssd.BWD_STAGES},
            "flash_attention_fwd": 2 * n_shared * per,
            "flash_attention_fwd_d112": 2 * n_shared * per,
            "flash_attention_bwd": n_shared * per, "grouped_matmul": 0, "collective_reduce": 0,
            "quant_int8": 0}
    want.update(ring_expectations(zero, n_adjoint, len(shapes), run["n_buckets"],
                                  SSM_TRAIN_STEPS))
    ssd_bwd_us = {k: v for k, v in kernel_us.items() if "ssd_bwd_" in k}
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:5]
    run.update({"ssd_bwd_card_ms_one_more_step": sum(ssd_bwd_us.values()) / 1e3,
                "ssd_bwd_card_ms_by_kernel": {kernel_label(k, 40): v / 1e3
                                              for k, v in ssd_bwd_us.items()},
                "top_kernels_ms": {kernel_label(k): v / 1e3 for k, v in top},
                "expected_launches": want, "expected_adjoint_rs_launches": n_adjoint})
    return run, after_step0


def phase_ssm_train(torch, np, get_config, build, mesh_mod, hetccl, tacc, ssd, fa, ref,
                    counters, arch):
    """``arch`` at full width cut to SSM_TRAIN[arch] layers (SSM_TRAIN's
    note) on a SSM_TRAIN_MESH ThreadMesh: the step-0 gate, then
    SSM_TRAIN_STEPS ZeRO-3 steps and SSM_TRAIN_STEPS ZeRO-1 steps from one
    init and the same batches (``ssm_stage_run``), the counts set to 0 just
    before each run and read just after: per Mamba2 block, micro-step and
    rank 2 SSD forward launches (remat's recompute the second) and 1
    backward call (three launches), per shared attention block 2 flash
    forward and 1 backward at d 112; the fused rings under ZeRO-1 once per
    bucket (reduce-scatter) and per bucket and leaf (all-gather), under
    ZeRO-3 once per gathered key and micro-step in the fsdp adjoint (the
    keys counted from the gather plan, ``zero3_gathers``) and once per leaf
    in the pod all-reduce; finite losses; step 0's loss against the same
    batch with every kernel op plain (SSM_STEP0_LOSS_ATOL), and the planted
    faults' gaps beside it (SSM_LOSS_FAULTS); ZeRO-3 against ZeRO-1: the
    step losses within ZERO_LOSS_ATOL (step 0's difference printed), step
    0's gradient norms within ZERO_GRAD_NORM_RTOL, the parameters after
    step 0 within ZERO_PARAM_REL_L2 over the tree and SSM_ZERO_LEAF_REL_L2
    per leaf; per stage ms a step (the steps after the first), tokens/s,
    the card's busy share over one more step, the peak memory (under
    SSM_TRAIN_PEAK_GIB) and the kernels with the most card time.  Returns
    the ZeRO-1 run's readings at the top level and the ZeRO-3 run's under
    "zero3"."""
    from repro_torch.core import balance, collectives
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ring_dma
    from repro_torch.models.common import fsdp_dims, make_rules
    layers = SSM_TRAIN[arch]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers, loss_chunk=SSM_TRAIN_LOSS_CHUNK)
    model = build(cfg)
    m = mesh_mod.ThreadMesh(SSM_TRAIN_MESH, device="cuda")
    plan = balance.uniform_plan(2, SSM_TRAIN_MICRO, micro_batch=1)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    batches = [synthetic_batch(SEED, s, plan.n_micro_max, plan.micro_batch * m.size,
                               SSM_TRAIN_SEQ, cfg.vocab) for s in range(SSM_TRAIN_STEPS)]
    n_tokens = int(np.prod(batches[0]["tokens"].shape))
    n_shared = layers // cfg.attn_every if cfg.family == "hybrid" else 0
    metas = model.abstract_params()
    dims = fsdp_dims(metas, make_rules(3, m.shape["data"]))
    gathers = zero3_gathers(metas, m.shape["data"])
    names = leaf_names(metas)
    replicated = [n for n, d in zip(names, dims) if d is None]
    print(f"  {cfg.name}: {layers} of {full.n_layers} layers"
          + (f" ({n_shared} group of {cfg.attn_every}, the shared attention block, "
             f"{layers - n_shared * cfg.attn_every} tail)" if n_shared else "")
          + f", d_model {cfg.d_model}, {cfg.n_ssm_heads} SSD heads x {cfg.ssm_headdim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab}, "
          f"{model.n_params() / 1e9:.3f}B params, bf16 params, f32 master state; mesh {m.shape}, "
          f"{plan.n_micro_max} micro-steps of {plan.micro_batch} x {SSM_TRAIN_SEQ} per rank, "
          f"{n_tokens} tokens per step; remat on; hier, pallas, no codec; ZeRO-3 shards "
          f"{len(dims) - len(replicated)} of {len(dims)} leaves over data (replicated: "
          f"{', '.join(replicated)}), {gathers} gathered keys a micro-step")
    b0 = {k: torch.as_tensor(batches[0][k][0, :plan.micro_batch]).to("cuda", torch.long)
          for k in ("tokens", "labels")}
    gate = ssm_grad_gate(torch, ssd, fa, ref, model, params, b0)
    del b0
    plain_loss = forward_step_loss(torch, tacc, model, params, batches[0], plan, m.size,
                                   {op: tacc.resolve(op, "cpu") for op in ("ssd_scan", "attention")})
    kernel_loss = forward_step_loss(torch, tacc, model, params, batches[0], plan, m.size, {})
    fault_losses = {
        name: forward_step_loss(torch, tacc, model, params, batches[0], plan, m.size,
                                {op: fault(tacc.resolve(op, "cuda"))})
        for name, (op, fault) in SSM_LOSS_FAULTS.items() if op != "attention" or n_shared}
    shapes = [p.shape for p in tree_leaves(params)]
    init = [params]
    del params
    runs, after_step0 = {}, {}
    for zero in (3, 1):
        runs[zero], after_step0[zero] = ssm_stage_run(
            torch, np, hetccl, ssd, collectives, ring_dma, counters, model, m, plan, batches,
            zero, init, shapes, gathers)
    out = runs[1]
    gaps = {}
    for zero in (3, 1):
        r = runs[zero]
        gaps[zero] = abs(r["losses"][0] - plain_loss)
        print(f"  ZeRO-{zero}: losses {['%.6f' % x for x in r['losses']]}; grad norms "
              f"{['%.6f' % x for x in r['grad_norms']]}; ms per step "
              f"{['%.1f' % x for x in r['step_ms']]}, {r['tokens_per_s']:.1f} tokens/s (steps "
              f"after the first); card busy share of one more step (torch.profiler) "
              f"{r['device_busy_one_more_step']}; peak memory {r['peak_gib']:.2f} GiB (limit "
              f"{SSM_TRAIN_PEAK_GIB})")
        print(f"  ZeRO-{zero} one more step's profile: {r['card_ms_one_more_step']:.1f} ms of "
              f"card time; the SSD backward's kernels {r['ssd_bwd_card_ms_one_more_step']:.2f} "
              f"ms (" + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                  r["ssd_bwd_card_ms_by_kernel"].items(), key=lambda kv: -kv[1])) + ")")
        for k, v in r["top_kernels_ms"].items():
            print(f"    top kernel {v:9.2f} ms {100 * v / r['card_ms_one_more_step']:5.1f}%  {k}")
        print(f"  ZeRO-{zero} step-0 loss {r['losses'][0]:.6f}; the same batch forward only: "
              f"kernels {kernel_loss:.6f}, every kernel op plain {plain_loss:.6f}; step 0 vs "
              f"plain {gaps[zero]:.3e} (limit {SSM_STEP0_LOSS_ATOL})  "
              f"{'ok' if gaps[zero] <= SSM_STEP0_LOSS_ATOL else 'FAIL'}")
        for key, n in r["expected_launches"].items():
            print(f"  ZeRO-{zero} {key}: {r['launches'][key]} launches, {n} expected  "
                  f"{'ok' if r['launches'][key] == n else 'FAIL'}")
        print(f"  ZeRO-{zero} fused reduce-scatters in the fsdp adjoint: "
              f"{r['adjoint_rs_launches']}, {r['expected_adjoint_rs_launches']} expected"
              + (f" ({gathers} gathered keys x {plan.n_micro_max} micro-steps x "
                 f"{SSM_TRAIN_STEPS} steps)" if zero == 3 else "")
              + f"  {'ok' if r['adjoint_rs_launches'] == r['expected_adjoint_rs_launches'] else 'FAIL'}")
    fault_gaps = {name: abs(v - plain_loss) for name, v in fault_losses.items()}
    for name, v in fault_losses.items():
        caught = fault_gaps[name] > SSM_STEP0_LOSS_ATOL
        print(f"  planted fault {name}: loss {v:.6f}, {fault_gaps[name]:.3e} from plain, "
              f"{'caught' if caught else 'not caught'} by the limit"
              + (("  ok" if caught else "  FAIL") if name == SSM_LOSS_FAULT_CAUGHT else ""))
    print(f"  per step: {2 * layers * plan.n_micro_max * m.size} SSD forward launches, "
          f"{layers * plan.n_micro_max * m.size} SSD backward calls, "
          f"{2 * n_shared * plan.n_micro_max * m.size} flash forward and "
          f"{n_shared * plan.n_micro_max * m.size} flash backward launches (d "
          f"{cfg.head_dim_ if n_shared else '-'}); ZeRO-3 {gathers * plan.n_micro_max} fsdp "
          f"adjoint reduce-scatters")
    r3, r1 = runs[3], runs[1]
    step0_gap = r3["losses"][0] - r1["losses"][0]
    loss_gap = max(abs(a - b) for a, b in zip(r3["losses"], r1["losses"]))
    norm_gap = abs(r3["grad_norms"][0] - r1["grad_norms"][0]) / r1["grad_norms"][0]
    rel, diff2, ref2 = [], 0.0, 0.0
    for a, b in zip(after_step0[3], after_step0[1]):
        a, b = a.cuda().float(), b.cuda().float()
        d2, r2 = (a - b).square().sum().item(), b.square().sum().item()
        rel.append((d2 / r2) ** 0.5)
        diff2, ref2 = diff2 + d2, ref2 + r2
    param_gap = (diff2 / ref2) ** 0.5
    del a, b
    after_step0.clear()
    worst = max(range(len(rel)), key=rel.__getitem__)
    shared = [i for i, n in enumerate(names) if n.startswith("shared.")]
    print(f"  ZeRO-3 vs ZeRO-1: ms per step {r3['ms_per_step']:.1f} / {r1['ms_per_step']:.1f} "
          f"({r3['ms_per_step'] / r1['ms_per_step']:.3f}x), tokens/s {r3['tokens_per_s']:.1f} / "
          f"{r1['tokens_per_s']:.1f}, busy {r3['device_busy_one_more_step']:.3f} / "
          f"{r1['device_busy_one_more_step']:.3f}, peak {r3['peak_gib']:.2f} / "
          f"{r1['peak_gib']:.2f} GiB")
    print(f"  step-0 loss ZeRO-3 - ZeRO-1: {step0_gap:.3e} (the gathers concatenate the shards, "
          f"so the forward is the same: 0 expected); step losses, largest difference "
          f"{loss_gap:.3e} (limit {ZERO_LOSS_ATOL})  {'ok' if loss_gap <= ZERO_LOSS_ATOL else 'FAIL'}")
    print(f"  step-0 gradient norm ZeRO-3 {r3['grad_norms'][0]:.6f} vs ZeRO-1 "
          f"{r1['grad_norms'][0]:.6f}: relative difference {norm_gap:.3e} (limit "
          f"{ZERO_GRAD_NORM_RTOL})  {'ok' if norm_gap <= ZERO_GRAD_NORM_RTOL else 'FAIL'}")
    print(f"  parameters after step 0, ZeRO-3 (rebuilt from its shards) vs ZeRO-1: relative L2 "
          f"{param_gap:.3e} (limit {ZERO_PARAM_REL_L2})  "
          f"{'ok' if param_gap <= ZERO_PARAM_REL_L2 else 'FAIL'}; worst leaf {names[worst]} "
          f"{rel[worst]:.3e} (limit {SSM_ZERO_LEAF_REL_L2})  "
          f"{'ok' if rel[worst] <= SSM_ZERO_LEAF_REL_L2 else 'FAIL'}")
    for label, idx in (("replicated", [names.index(n) for n in replicated]),
                       ("shared block", shared),
                       ("other", [i for i in range(len(names)) if dims[i] is not None
                                  and i not in shared])):
        if idx:
            print(f"    {label} leaves: " + ", ".join(f"{names[i]} {rel[i]:.2e}" for i in idx))
    for zero in (3, 1):
        r = runs[zero]
        check(all(np.isfinite(r["losses"])), f"{arch} ZeRO-{zero}: non-finite loss")
        check(gaps[zero] <= SSM_STEP0_LOSS_ATOL,
              f"{arch} ZeRO-{zero}: step 0's loss is {gaps[zero]:.3e} from the plain ops'")
        check(all(r["launches"][k] == n for k, n in r["expected_launches"].items())
              and r["adjoint_rs_launches"] == r["expected_adjoint_rs_launches"],
              f"{arch} ZeRO-{zero}: the steps did not launch the kernels they imply")
        check(r["peak_gib"] <= SSM_TRAIN_PEAK_GIB,
              f"{arch} ZeRO-{zero}: peak memory {r['peak_gib']:.2f} GiB")
    check(fault_gaps[SSM_LOSS_FAULT_CAUGHT] > SSM_STEP0_LOSS_ATOL,
          f"{arch}: the loss check does not catch {SSM_LOSS_FAULT_CAUGHT} "
          f"({fault_gaps[SSM_LOSS_FAULT_CAUGHT]:.3e})")
    check(loss_gap <= ZERO_LOSS_ATOL, f"{arch}: ZeRO-3 and ZeRO-1 step losses disagree")
    check(norm_gap <= ZERO_GRAD_NORM_RTOL,
          f"{arch}: ZeRO-3 and ZeRO-1 step-0 gradient norms disagree")
    check(param_gap <= ZERO_PARAM_REL_L2 and rel[worst] <= SSM_ZERO_LEAF_REL_L2,
          f"{arch}: ZeRO-3 and ZeRO-1 parameters after step 0 disagree")
    out.update({"arch": cfg.name, "layers": layers, "params": model.n_params(),
                "tokens_per_step": n_tokens, "step0_gate": gate,
                "step0_plain_loss": plain_loss, "step0_kernel_forward_loss": kernel_loss,
                "step0_loss_gap": gaps[1], "step0_fault_losses": fault_losses,
                "step0_fault_gaps": fault_gaps,
                "zero3": {**r3, "step0_loss_gap": gaps[3]},
                "zero3_vs_zero1": {
                    "step0_loss_difference": step0_gap, "loss_gap": loss_gap,
                    "grad_norm_gap": norm_gap, "param_rel_l2_after_step0": param_gap,
                    "leaf_rel_l2_after_step0": dict(zip(names, rel)),
                    "replicated_leaves": replicated, "gathers_per_micro_step": gathers}})
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssd_bwd_bound(inp, states, grads):
    """(bound ms, "bytes" or "operations") of the backward as a function:
    its inputs (x, dt, a, B, C, dy, the chunk-entry states, dfin and init
    where given) read once and its outputs (``grads``: dx, ddt, da, dB, dC,
    d init where asked) written once over the memory rate, against the
    operations this data needs over the bf16 peak: the reverse state scan's
    products, the chunks' products over the causal pairs j <= i of each
    chunk and their state terms, the adds of each group's head sum."""
    B, S, H, P = inp["x"].shape
    G, N = inp["B"].shape[2:]
    Q = inp["Q"]
    tensors = [inp[k] for k in ("x", "dt", "a", "B", "C", "dy", "dfin", "init")]
    nbytes = sum(t.numel() * t.element_size()
                 for t in [*tensors, states, *grads] if t is not None)
    rows, pairs = B * S * H, B * H * (S // Q) * Q * (Q + 1) // 2
    flops = (2 * rows * N * P + 2 * pairs * (3 * N + 2 * P) + 3 * 2 * rows * N * P
             + 2 * B * S * (H - G) * N)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def ssd_bwd_launch_bounds(route, B, S, H, P, G, N, Q, elem, planes):
    """{launch: (ms, "bytes" or "operations")} of ``route``'s launches
    (``ssd_scan.BWD_LAUNCHES``), a diagnostic of the design, not the
    function's bound (``ssd_bwd_bound``): each launch's own inputs read once
    and outputs written once, so what one launch writes and the next reads
    (g of every chunk; dB and dC in ``planes`` f32 planes a batch, per head
    on the f32 route, per cluster of heads on the mma route) counts twice,
    and dy once a launch that reads it; the operations of the causal pairs
    j <= i of each chunk and of the state terms, not the kernel's recomputed
    or split ones, over the bf16 peak."""
    nc = S // Q
    st = B * H * nc * N * P * 4                                 # a (B,H,nc,N,P) f32 tensor
    pairs = B * H * nc * Q * (Q + 1) // 2
    rows = B * S * H
    part = 2 * B * S * planes * N * 4                           # dB and dC scratch, f32
    f_state = 2 * rows * N * P
    b_chunks = (rows * P * elem + 2 * rows * 4 + 2 * B * S * G * N * elem + rows * P * 4
                + 2 * st + rows * P * elem + 2 * rows * 4 + part)
    f_chunks = 2 * pairs * (3 * N + 2 * P) + 3 * 2 * rows * N * P
    b_sum = part + 2 * B * S * G * N * elem
    if route == "f32":
        rows_of = {"state": (B * S * G * N * elem + rows * P * 4 + rows * 4 + st, f_state),
                   "chunks": (b_chunks, f_chunks), "head_sum": (b_sum, 2 * rows * N)}
    else:
        rows_of = {"delta": (B * S * G * N * elem + rows * P * 4 + rows * 4 + st, f_state),
                   "combine": (2 * st + rows * 4 // Q, 2 * st // 4),
                   "chunks": (b_chunks, f_chunks), "group_sum": (b_sum, part // 4)}
    out = {}
    for name, (nbytes, flops) in rows_of.items():
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / PEAK_FLOPS["bfloat16"] * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


def phase_ssd_bwd_times(torch, ssd, bench_codec):
    """The backward's launches at [28]'s two shapes (SSD_BWD_CASES'
    mamba2_train and zamba2_train, bf16: the mma route): each launch of the
    route alone (``ssd_scan.BWD_LAUNCHES``) and the whole backward, L2 cold
    before each reading (``bench_codec.ColdReader``), back to back and
    replayed from CUDA graphs, in turns with the plain backward (back to
    back); the function's bound (``ssd_bwd_bound``) and, as a diagnostic,
    each launch's own (``ssd_bwd_launch_bounds``).  No single PyTorch call
    computes this function: no library yardstick."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    reader = bench_codec.ColdReader()
    side = torch.cuda.Stream()
    out = {}
    for case in SSD_BWD_CASES[:2]:
        name, B, S, H, P, G, N, Q, dt, scale, init, dfin = case
        inp = ssd_bwd_inputs(torch, gen, B, S, H, P, G, N, Q, dt, scale, init, dfin)
        route = ssd.route(inp["x"].dtype)
        states = ssd.ssd_scan_model_states(inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"],
                                           Q, inp["init"])[2]
        buf = ssd.bwd_buffers(inp["x"], inp["B"], inp["init"], Q, (True,) * 6)
        args = ssd._bwd_args(inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"], inp["dy"],
                             states, inp["dfin"], buf, Q)

        def stage(bits):
            return lambda: ssd._launch_bwd(args, bits, inp["x"].device)

        bwd_args = (inp["x"], inp["dt"], inp["a"], inp["B"], inp["C"], Q, inp["dy"],
                    inp["dfin"], inp["init"])
        launches = ssd.BWD_LAUNCHES[route]
        calls = {**{k: [stage(bits)] for k, bits in launches.items()},
                 "backward": [lambda: ssd.ssd_scan_model_bwd(*bwd_args, states)]}
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            stage(7)()                           # gst for the readings of a launch alone
            r = bench_codec.cold_in_turns(reader, calls, 4)
            plain_r = bench_codec.cold_in_turns(
                reader, {"backward": calls["backward"],
                         "plain": [lambda: ssd.ssd_scan_model_bwd_plain(*bwd_args)]}, 3,
                modes=("stream",))
        torch.cuda.current_stream().wait_stream(side)
        grads = ssd.ssd_scan_model_bwd(*bwd_args, states)
        bound_ms, bound_by = ssd_bwd_bound(inp, states, grads)
        del grads
        bounds = ssd_bwd_launch_bounds(route, B, S, H, P, G, N, Q, inp["x"].element_size(),
                                       ssd.bwd_head_planes(H, G, inp["x"].dtype))
        t = out[name] = {
            "shape": f"B {B} S {S} H {H} P {P} G {G} N {N} Q {Q} {dt}", "route": route,
            "launches": list(launches),
            **{f"{k}_ms": statistics.median(r[k]["stream"]) for k in calls},
            **{f"{k}_graph_ms": statistics.median(r[k]["graph"]) for k in calls},
            **{f"{k}_launch_bound_ms": b for k, (b, _) in bounds.items()},
            **{f"{k}_launch_bound_by": by for k, (_, by) in bounds.items()},
            "ms": statistics.median(r["backward"]["graph"]),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "launches_bound_ms": sum(b for b, _ in bounds.values()),
            "plain_ms": statistics.median(plain_r["plain"]["stream"]),
            "backward_in_turns_with_plain_ms": statistics.median(plain_r["backward"]["stream"]),
            "library_ms": None,
            "state_smem_bytes": ssd.bwd_smem_bytes("state", N, P, Q, inp["x"].dtype),
            "chunks_smem_bytes": ssd.bwd_smem_bytes("chunks", N, P, Q, inp["x"].dtype),
            "head_planes": ssd.bwd_head_planes(H, G, inp["x"].dtype),
            "active_clusters": ssd.bwd_active_clusters(H, G, N, P, Q) if route == "mma" else None}
        print(f"  {name} ({t['shape']}, {route} route): backward {t['ms']:.4f} ms from a graph "
              f"(back to back {t['backward_ms']:.4f}), plain {t['plain_ms']:.4f} (kernel in the "
              f"same turns {t['backward_in_turns_with_plain_ms']:.4f}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}; the function's inputs read and outputs "
              f"written once); kernel / bound {t['ms'] / t['bound_ms']:.1f}; L2 cold, in turns")
        for k in launches:
            g = r[k]["graph"]
            print(f"    {k:9s} graph {t[k + '_graph_ms']:.4f} ms (readings {min(g):.4f}-"
                  f"{max(g):.4f}), back to back {t[k + '_ms']:.4f}; the launch's own traffic "
                  f"(a diagnostic) {t[k + '_launch_bound_ms']:.4f} ms "
                  f"({t[k + '_launch_bound_by']})")
        print(f"    the launches' own traffic summed {t['launches_bound_ms']:.4f} ms: "
              f"{t['launches_bound_ms'] / t['bound_ms']:.2f}x the function's bound")
        print(f"    shared memory per block: state {t['state_smem_bytes']} B, chunks "
              f"{t['chunks_smem_bytes']} B; dB and dC scratch {t['head_planes']} f32 planes a "
              f"batch; clusters the card holds at once {t['active_clusters']}")
        del inp, states, buf, args, calls, r, plain_r
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# [31] Planned training: the planner's table and shares on the card
# ---------------------------------------------------------------------------

# bf16's unit roundoff (8 significant bits)
BF16_U = 2.0 ** -8
# The int8 codec: each chunk of QUANT_CHUNK elements is scaled by its absmax
# / 127, so an element rounds to within half a step, absmax / 254
QUANT_CHUNK, INT8_HALF_STEP = 512, 1.0 / 254


def bf16_cross_bound(torch, shards_by_pod):
    """(oracle, bound) of a cross-island reduction in bf16 whose accumulator
    is f32.  ``shards_by_pod[p]`` is pod p's f32 sum over its local ranks.
    The oracle rounds each pod's shard to bf16 and sums those in float64;
    the ring rounds its running partial to bf16 once per hop (P - 1 hops)
    and the gathered result once more, each rounding within u = 2**-8 of
    what it rounds, so every element lies within P u sum_p |bf16(shard_p)|
    of the oracle (P the number of pods, the terms of the sum)."""
    b = [s.to(torch.bfloat16).double() for s in shards_by_pod]
    return sum(b), len(b) * BF16_U * sum(x.abs() for x in b)


def _chunk_absmax(torch, flat):
    """Each element's codec chunk's absmax (chunks of QUANT_CHUNK from the
    start of ``flat``, as the codec pads and splits a flat payload)."""
    n = flat.numel()
    pad = (-n) % QUANT_CHUNK
    a = torch.nn.functional.pad(flat.abs(), (0, pad)).view(-1, QUANT_CHUNK).amax(1)
    return a.repeat_interleave(QUANT_CHUNK)[:n]


def int8_reduction_bound(torch, grads_by_rank, buckets, n_pods):
    """Per leaf, each element's bound on |reduced - f32 sum| of a ZeRO-1
    gradient reduction whose rows carry the int8 codec with error feedback
    at step 0 (residuals zero), from the ranks' local f32 gradients
    ``grads_by_rank[r][leaf]`` and the reduction's ``buckets`` (leaf indices
    in bucket order, ``hetccl._make_buckets``).

    Every quantization rounds an element to within half its chunk's step,
    absmax / 254 (the codec's step is absmax / 127).  Error feedback
    quantizes each rank's gradient per leaf (chunks from the leaf's start):
    M_e / 254 at most, M_e the sum over ranks of e's chunk absmax.  Every
    value a ring hop carries (one rank's quantized gradient, a pod's sum, the
    reduced value) is at most M_e (1 + 1/127) in magnitude, and a hop's
    codec chunk is a contiguous run of QUANT_CHUNK elements of the bucket's
    flat buffer (the pipelined rings' halves on (pod=2, data=2)), so within
    the aligned blocks of QUANT_CHUNK before, at and after e: its absmax is
    at most W_e (1 + 1/127), W_e the largest M there.  Each element crosses
    P - 1 quantized reduce-scatter hops and one quantized all-gather hop, so
    |err_e| <= M_e / 254 + P W_e (1 + 1/127) / 254, plus 4 f32 roundings of
    M_e for the sums' other order."""
    R, L = len(grads_by_rank), len(grads_by_rank[0])
    M = [sum(_chunk_absmax(torch, grads_by_rank[r][j].reshape(-1).float()) for r in range(R))
         for j in range(L)]
    W = [None] * L
    for bucket in buckets:
        flat = torch.cat([M[j] for j in bucket])
        n = flat.numel()
        blocks = torch.nn.functional.pad(flat, (0, (-n) % QUANT_CHUNK)).view(-1, QUANT_CHUNK)
        bm = blocks.amax(1)
        nb = torch.maximum(bm, torch.maximum(torch.nn.functional.pad(bm[1:], (0, 1)),
                                             torch.nn.functional.pad(bm[:-1], (1, 0))))
        wide = nb.repeat_interleave(QUANT_CHUNK)[:n]
        off = 0
        for j in bucket:
            W[j] = wide[off:off + M[j].numel()]
            off += M[j].numel()
    return [(M[j] * INT8_HALF_STEP + n_pods * W[j] * (1 + 1 / 127) * INT8_HALF_STEP
             + 4 * 2.0 ** -24 * M[j]).view(grads_by_rank[0][j].shape) for j in range(L)]


def planned_row(hetccl, comm, op, nbytes):
    """The dispatch row ``hetccl`` counts for one call: (op, size class,
    variant, policy)."""
    from repro_torch.comm.policy import size_class
    pol = comm.policy(op, nbytes)
    return (op, size_class(nbytes, comm.table.bounds), comm.variant_for(op, pol), pol)


def _halves(c):
    """A bidirectional ring's per-direction element counts for c elements."""
    return (c,) if c < 2 else (c // 2, c - c // 2)


def _splits(n, parts):
    """torch.tensor_split's piece lengths of n into ``parts``."""
    q, r = divmod(n, parts)
    return [q + 1] * r + [q] * (parts - r)


def fused_ring_launches(collectives, ring_dma, op, variant, pol, n, esize, n_pods, n_data,
                        chunk_bytes=None):
    """Fused ring kernel launches of one call of ``op`` on every rank of a
    (pod, data) ThreadMesh (one launch covers every rank), under ``pol``
    without a codec: ``{"ring_reduce_scatter/S<k>" | "ring_all_gather/S<k>":
    n}``.  ``n`` is the op's input elements on a rank (the padded bucket, a
    shard), ``esize`` their bytes.  From the schedule each (op, variant)
    runs: pipelined rows split into the channels ``resolve_channels`` gives,
    each on the bidirectional cross-pod rings (two launches, one a
    direction); hier one cross-pod ring; flat pallas a ring on each axis;
    each launch's stripes the row's, clamped to its elements (reduce) or
    words (gather)."""
    out = Counter()
    W, P, D = n_pods * n_data, n_pods, n_data

    def rs(c):                        # c: elements of one ring chunk
        out[f"ring_reduce_scatter/S{ring_dma._clamp_stripes(pol.n_stripes, c)}"] += 1

    def ag(c, eb):                    # c: elements a rank contributes
        words = c * eb // 4 if (c * eb) % 4 == 0 else c * eb // 2
        out[f"ring_all_gather/S{ring_dma._clamp_stripes(pol.n_stripes, words)}"] += 1

    if pol.backend != "pallas" or pol.wire_quant is not None or n == 0:
        return out
    nbytes = n * esize
    if op == "reduce_scatter":
        if variant == "pipelined":
            s = n // W
            C = collectives.resolve_channels(nbytes, pol.n_channels, chunk_bytes, s,
                                             pol.n_stripes)
            for sj in (_splits(s, C) if C > 1 else [s]):
                for h in _halves(W * sj // P):
                    rs(h)
        elif variant == "hier":
            rs(n // P)
        else:
            rs(n // P)
            rs(n // P // D)
    elif op == "all_gather":
        if variant == "pipelined":
            C = collectives.resolve_channels(nbytes, pol.n_channels, chunk_bytes, n,
                                             pol.n_stripes)
            for lj in (_splits(n, C) if C > 1 else [n]):
                for h in _halves(D * lj):
                    ag(h, esize)
        elif variant == "hier":
            ag(D * n, esize)
        else:
            ag(n, esize)
            ag(D * n, esize)
    elif op == "all_reduce":
        wire = 2 if pol.cross_dtype is not None else esize
        if variant == "pipelined":
            C = collectives.resolve_channels(nbytes, pol.n_channels, chunk_bytes,
                                             max(n // (D * P), 1), pol.n_stripes)
            per = (n + (-n) % (C * D * P)) // (C * D * P)
            for _ in range(C):
                for h in _halves(per):
                    rs(h)
                for h in _halves(per):
                    ag(h, wire)
        elif variant == "hier":
            per = (n + (-n) % (D * P)) // (D * P)
            rs(per)
            ag(per, wire)
        else:
            for axis_n in (D, P):
                rs(-(-n // axis_n))
                ag(-(-n // axis_n), esize)
    return out


def planned_expectations(hetccl, collectives, ring_dma, comm, grad_leaves, param_leaves,
                         n_pods, n_data):
    """What one ZeRO-1 step must dispatch and launch on a (pod, data)
    ThreadMesh, derived from the model's leaves, the communicator's buckets
    and its table alone: ``(dispatches, fused)``, ``dispatches[row]`` the
    calls summed over ranks (each bucket's reduce-scatter and all-gather, or
    its all-reduce when the largest bucket's all-reduce row carries a cross
    dtype; each parameter's all-gather), ``fused[(row, kernel)]`` the fused
    ring launches (``fused_ring_launches``)."""
    W = n_pods * n_data
    disp, fused = Counter(), Counter()

    def add(op, n, esize):
        # the payload the table keys on: an all-gather's gathered buffer
        # when the table has rows (hetccl._payload_bytes), else the input
        gathered = op == "all_gather" and comm.table.rows
        row = planned_row(hetccl, comm, op, n * esize * (W if gathered else 1))
        disp[row] += W
        for k, v in fused_ring_launches(collectives, ring_dma, op, row[2], row[3], n, esize,
                                        n_pods, n_data, comm.pipeline_chunk_bytes).items():
            fused[(row, k)] += v

    sizes = []
    for bucket in hetccl._make_buckets(grad_leaves, comm.bucket_bytes):
        n = sum(grad_leaves[i].numel() for i in bucket)
        sizes.append((n + (-n) % W, grad_leaves[bucket[0]].element_size()))
    big = max(n * e for n, e in sizes)
    all_reduce = comm.policy("all_reduce", big).cross_dtype is not None
    for n, e in sizes:
        if all_reduce:
            add("all_reduce", n, e)
        else:
            add("reduce_scatter", n, e)
            add("all_gather", n // W, e)
    for p in param_leaves:
        add("all_gather", (p.numel() + (-p.numel()) % W) // W, p.element_size())
    return disp, fused


def reduction_capture(hetccl, mesh_mod, keep_inputs):
    """A stand-in for ``hetccl.tree_all_reduce`` (the ZeRO-1 gradient
    reduction) that keeps each rank's returned leaves (f32 copies) and, when
    ``keep_inputs``, the leaves it was given; ``(wrapper, seen)``."""
    from repro_torch.core.tree import leaves as tree_leaves
    real = hetccl.tree_all_reduce
    seen = {"in": {}, "out": {}}

    def wrapper(tree, cfg=None, **kw):
        _, r = mesh_mod.current()
        if keep_inputs:
            seen["in"][r] = [t.detach().float().clone() for t in tree_leaves(tree)]
        out = real(tree, cfg, **kw)
        seen["out"][r] = [t.detach().float().clone() for t in tree_leaves(out)]
        return out

    return wrapper, seen


def planned_batches(np, synthetic_batch, vocab, n_ranks):
    """d's batch (3 micro-steps of n_ranks x micro-batch rows, pod-major)
    and a's (2 micro-steps) holding the same live micro-batches under (3, 1)
    and (2, 2) shares: pod 0's third micro-batch becomes pod 1's second."""
    b3 = synthetic_batch(SEED, 0, 3, TRAIN_MICRO_BATCH * n_ranks, TRAIN_SEQ, vocab)
    half = TRAIN_MICRO_BATCH * n_ranks // 2
    b2 = {}
    for k, v in b3.items():
        a = np.array(v[:2])
        a[1, half:] = v[2, :half]
        b2[k] = a
    return b2, b3


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def phase_planned_train(torch, np, get_config, build, mesh_mod, hetccl, tacc, collectives,
                        ring_dma, counters):
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import train as launcher
    from repro_torch.train import optim
    from repro_torch.train.trainer import make_train_program
    cfg = get_config(ARCH)
    model = build(cfg)
    m = mesh_mod.ThreadMesh(PLANNED_MESH, device="cuda")
    P, D = m.shape["pod"], m.shape["data"]
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    p_leaves = tree_leaves(params)
    g_leaves = [torch.empty(p.shape, dtype=torch.float32, device="meta") for p in p_leaves]
    configs = {}
    for name, flags in PLANNED_RUNS.items():
        args = launcher.parser().parse_args(PLANNED_FLAGS + flags)
        configs[name] = list(launcher.plan_run(args, m, cfg))
    configs["d"][1] = configs["b"][1]                   # the oracle takes b's shares
    for name, (rc, plan, tp) in configs.items():
        table = rc.policies
        print(f"  {name}: shares {plan.micro_per_pod} (micro-batch {plan.micro_batch} x "
              f"{TRAIN_SEQ}), bucket {rc.bucket_bytes >> 20} MiB, "
              + (f"{len(table.rows)} policy rows" if table else
                 f"facade {rc.collective_mode}/{rc.backend}")
              + f", cross_dtype {rc.cross_dtype}, error feedback {optim.ef_codec(rc)}")
        if tp is not None:
            print(f"     {launcher.plan_line(tp)} (the planner's model of the priced "
                  f"V100 + W7800 cluster, not this card)")
    check(configs["b"][1].micro_per_pod == configs["c"][1].micro_per_pod == (3, 1),
          f"the planned shares are {configs['b'][1].micro_per_pod}, "
          f"{configs['c'][1].micro_per_pod}; (3, 1) expected")
    batch_a, batch_3 = planned_batches(np, synthetic_batch, cfg.vocab, m.size)
    n_tokens = TRAIN_MICRO_BATCH * m.size // P * TRAIN_SEQ * 4   # 4 live micro-steps a step

    runs, oracle = {}, {}
    for name in ("d", "a", "b", "c"):
        rc, plan, tp = configs[name]
        batch = batch_a if name == "a" else batch_3
        prog = make_train_program(model, m, rc, plan)
        state = prog.init_fn(params)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        hetccl.reset_dispatches()
        tacc.reset_row_launches()
        wrapper, seen = reduction_capture(hetccl, mesh_mod, keep_inputs=name in ("d", "c"))
        losses, ms = [], []
        for step in range(PLANNED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with patched(hetccl, "tree_all_reduce", wrapper) if step == 0 \
                    else contextlib.nullcontext():
                state, met = prog.step_fn(state, batch)
            losses.append(met["loss"].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if step == 0:
                gnorm0, tokens0 = met["grad_norm"].item(), int(met["tokens"].item())
        launches = counters.read()
        disp, rows = Counter(hetccl.dispatches), Counter(tacc.row_launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_ms = statistics.median(ms[1:])
        busy = None
        if name in PLANNED_PROFILED:
            _, by_name = device_profile(torch, lambda: prog.step_fn(state, batch), 1)
            busy = sum(by_name.values()) / 1e3 / step_ms
        runs[name] = {"losses": losses, "grad_norm0": gnorm0, "tokens": tokens0,
                      "launches": launches, "step_ms": ms, "median_ms": step_ms,
                      "tokens_per_s": n_tokens / step_ms * 1e3, "busy": busy, "peak_gib": peak,
                      "modeled_step_s": tp.modeled_step_s if tp is not None else None}
        print(f"  {name}: losses {['%.6f' % x for x in losses]}; step-0 grad norm {gnorm0:.6f}; "
              f"ms per step {[round(x, 1) for x in ms]} (host clock; median after step 0, "
              f"which carries the captures, {step_ms:.1f}: {n_tokens / step_ms * 1e3:.1f} "
              f"tokens/s); busy share (one more, profiled step's card time over step 1's "
              f"wall) "
              f"{'not measured' if busy is None else f'{busy:.4f}'}; peak {peak:.2f} GiB")
        # the dispatch and launch gates
        want_disp, want_fused = planned_expectations(hetccl, collectives, ring_dma, prog.comm,
                                                     g_leaves, p_leaves, P, D)
        want_disp = Counter({k: v * PLANNED_STEPS for k, v in want_disp.items()})
        got_fused = Counter({k: v for k, v in rows.items() if k[1].startswith("ring_")})
        want_fused = Counter({k: v * PLANNED_STEPS for k, v in want_fused.items()})
        for (op, cls, variant, pol), n in sorted(disp.items(), key=lambda kv: str(kv[0][:3])):
            row = (op, cls, variant, pol)
            ring = {k: v for (r, k), v in got_fused.items() if r == row}
            codec = {k: v for (r, k), v in rows.items() if r == row and k in
                     ("quant_int8", "dq_accum_int8")}
            print(f"     {op}/{cls} -> {variant} {pol.backend} C{pol.n_channels} "
                  f"S{pol.n_stripes} codec {pol.wire_quant} cross {pol.cross_dtype}: "
                  f"{n} calls (expected {want_disp.get(row, 0)}); fused {ring} (expected "
                  f"{ {k: v for (r, k), v in want_fused.items() if r == row} }); codec {codec}")
        check(disp == want_disp, f"{name}: the dispatches by row differ from the table's rows "
                                 f"for this step's buckets and leaves")
        check(got_fused == want_fused, f"{name}: the fused ring launches by row differ from "
                                       f"the rows' channels and stripes")
        check(launches["ring_reduce_scatter"] == sum(
            v for (_, k), v in got_fused.items() if k.startswith("ring_reduce_scatter"))
            and launches["ring_all_gather"] == sum(
            v for (_, k), v in got_fused.items() if k.startswith("ring_all_gather")),
            f"{name}: fused ring launches outside a dispatched row")
        codec_rows = {r for (r, k), v in rows.items() if k in ("quant_int8", "dq_accum_int8")}
        int8_rows = {r for r in disp if r[3].wire_quant == "int8"}
        ef = optim.ef_codec(rc) is not None
        check(codec_rows - {None} == int8_rows and ((None in codec_rows) == ef),
              f"{name}: codec launches under rows {codec_rows}; the int8 rows are {int8_rows}, "
              f"error feedback {ef}")
        check(launches["quant_int8"] + launches["dq_accum_int8"] == sum(
            v for (_, k), v in rows.items() if k in ("quant_int8", "dq_accum_int8")),
            f"{name}: codec launches outside the counted rows")
        n_micro = plan.n_micro_max
        for key, per_step in (("flash_attention_fwd", 2 * cfg.n_layers * n_micro * m.size),
                              ("flash_attention_bwd", cfg.n_layers * n_micro * m.size)):
            check(launches[key] == per_step * PLANNED_STEPS,
                  f"{name}: {launches[key]} {key} launches, {per_step * PLANNED_STEPS} expected")
        print(f"     gates: dispatches {sum(disp.values())} calls over {len(disp)} rows, fused "
              f"rings {sum(got_fused.values())} launches, codec "
              f"{launches['quant_int8'] + launches['dq_accum_int8']} launches under "
              f"{len(int8_rows)} int8 rows (error feedback {ef}), flash "
              f"{launches['flash_attention_fwd']} / {launches['flash_attention_bwd']}: ok")
        check(tokens0 == n_tokens, f"{name}: {tokens0} tokens counted, {n_tokens} live")
        # the reduced gradients of step 0 (rank 0's, and every rank's for c)
        if name == "d":
            grads = [seen["in"][r] for r in range(m.size)]
            b_buckets = hetccl._make_buckets(g_leaves, configs["b"][0].bucket_bytes)
            oracle["out"] = seen["out"][0]
            oracle["bound"] = int8_reduction_bound(torch, grads, b_buckets, P)
            del grads
        elif name == "b":
            got, want, bound = seen["out"][0], oracle["out"], oracle["bound"]
            err = [(g - w).abs() for g, w in zip(got, want)]
            over = max(float((e - b).max()) for e, b in zip(err, bound))
            norm_b = float(torch.sqrt(sum((g.double() ** 2).sum() for g in got)))
            norm_d = float(torch.sqrt(sum((w.double() ** 2).sum() for w in want)))
            norm_bound = float(torch.sqrt(sum((b.double() ** 2).sum() for b in bound))) / norm_d
            leaf = [(_rel(g.double(), w.double()), float(b.double().norm() / w.double().norm()),
                     j) for j, (g, w, b) in enumerate(zip(got, want, bound))]
            worst = max(leaf)
            runs["b"]["grads"] = {"norm_rel": abs(norm_b - norm_d) / norm_d,
                                  "norm_bound": norm_bound, "worst_leaf": worst[2],
                                  "worst_leaf_rel_l2": worst[0], "worst_leaf_bound": worst[1],
                                  "elementwise_over": over}
            print(f"  b vs d, step 0's reduced gradients (rank 0; int8 bound from the codec's "
                  f"step, int8_reduction_bound): global norm rel diff {abs(norm_b - norm_d) / norm_d:.3e} "
                  f"(bound {norm_bound:.3e}); worst leaf #{worst[2]} rel L2 {worst[0]:.3e} "
                  f"(its bound {worst[1]:.3e}); every element within its bound "
                  f"(largest excess {over:.3e})  {'ok' if over <= 0 else 'FAIL'}")
            check(over <= 0 and all(r <= b for r, b, _ in leaf)
                  and abs(norm_b - norm_d) / norm_d <= norm_bound,
                  "b's reduced gradients stray beyond the int8 bound")
            del oracle["bound"]
        elif name == "c":
            worst, acted = 0.0, False
            n_leaves = len(seen["in"][0])
            for j in range(n_leaves):
                shards = [seen["in"][D * p][j] + seen["in"][D * p + 1][j] for p in range(P)]
                want, bound = bf16_cross_bound(torch, shards)
                f32_sum = sum(shards).double()
                for r in range(m.size):
                    got = seen["out"][r][j].double()
                    excess = float(((got - want).abs() - bound).max())
                    worst = max(worst, float(((got - want).abs() / bound.clamp(min=1e-30)).max()))
                    check(excess <= 0, f"c: leaf {j} on rank {r} strays beyond the bf16 bound "
                                       f"by {excess:.3e}")
                    acted |= bool((got != f32_sum).any())
            runs["c"]["grads"] = {"worst_over_bound": worst, "bf16_acted": acted}
            print(f"  c vs the f32-accumulate oracle (each pod's shard rounded to bf16, summed; "
                  f"bf16_cross_bound), step 0, every rank: worst |c - oracle| / bound "
                  f"{worst:.3f} (limit 1); the bf16 stage acted: {acted}  "
                  f"{'ok' if worst <= 1 and acted else 'FAIL'}")
            check(acted, "c: the reduction equals the f32 sum: the bf16 stage never ran")
        del seen, state, prog
        gc.collect()
        torch.cuda.empty_cache()
    oracle.clear()
    for name, r in runs.items():
        check(all(np.isfinite(r["losses"])), f"{name}: non-finite loss")
    d0 = runs["d"]["losses"][0]
    rel_a = abs(runs["a"]["losses"][0] - d0) / d0
    print(f"  step-0 losses: d {d0:.7f}; b and c equal to d bit for bit: "
          f"{runs['b']['losses'][0] == runs['c']['losses'][0] == d0}; a (uniform shares, the "
          f"same tokens) {runs['a']['losses'][0]:.7f}, rel {rel_a:.3e} (limit "
          f"{PLANNED_STEP0_LOSS_RTOL})")
    check(runs["b"]["losses"][0] == runs["c"]["losses"][0] == d0, "b's or c's step-0 loss is "
                                                                  "not d's")
    check(rel_a <= PLANNED_STEP0_LOSS_RTOL, "a's step-0 loss strays from d's")
    gaps = [abs(x - y) for x, y in zip(runs["b"]["losses"], runs["d"]["losses"])]
    print(f"  b's losses against d's: largest gap {max(gaps):.4e} (limit "
          f"{TRAIN_INT8_LOSS_TOL})  {'ok' if max(gaps) <= TRAIN_INT8_LOSS_TOL else 'FAIL'}")
    check(max(gaps) <= TRAIN_INT8_LOSS_TOL, "b strays from the oracle beyond the int8 limit")
    return runs


def _states_equal(torch, a, b) -> bool:
    """Two trees of tensors and ints equal bit for bit (dtype included)."""
    from repro_torch.core.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x == y if not isinstance(x, torch.Tensor) else
        (x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.to(y.device), y))
        for x, y in zip(la, lb))


def phase_ckpt_obs(torch, np, get_config, build, mesh_mod, hetccl, planned, card,
                   flags=PLANNED_FLAGS, device="cuda", dryrun_cells=DRYRUN_CELLS):
    """[32]: the launcher's supervised loop with checkpoints and telemetry,
    the resharding restore, the step counter on the card, the dry run.
    ``flags`` and ``device`` let a test run it reduced on the CPU."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import flatten
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launcher
    from repro_torch.plan.measured import flight_cells, rows_from_flight
    from repro_torch.roofline import analysis, hw
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.trainer import make_train_program

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    out = {}
    try:
        def run(extra):
            gc.collect()
            torch.cuda.empty_cache()
            hetccl.reset_dispatches()
            args = launcher.parser().parse_args(flags + ["--device", device] + extra)
            return launcher.run(args)

        t_part = time.perf_counter()

        def part_done(label):
            nonlocal t_part
            print(f"  ({label} took {time.perf_counter() - t_part:.1f} s)")
            t_part = time.perf_counter()

        # (a) traced
        a = run(["--steps", str(CKPT_STEPS), "--ckpt-every", str(CKPT_EVERY),
                 "--ckpt-dir", str(tmp / "a"), "--trace", str(tmp / "trace"),
                 "--metrics-out", str(tmp / "metrics.jsonl")])
        disp = Counter(hetccl.dispatches)
        tel = a["telemetry"]
        rows = tel.tracer.dispatch_rows()
        spans = tel.tracer.collective_spans()
        check(rows == disp, f"(a) spans per row {dict(rows)} differ from hetccl.dispatches")
        check(all(sp.modeled_s and sp.modeled_s > 0 for sp in spans),
              "(a) a collective span without a modeled time")
        obs.load_chrome_trace(tmp / "trace" / "trace.json")
        (dump_path,) = tel.dump_paths
        dump = obs.load_dump(dump_path)
        cal = rows_from_flight(dump)
        check(set(flight_cells(cal)) == tel.tracer.dispatched_cells(),
              "(a) rows_from_flight does not reproduce the tracer's cells")
        (line,) = obs.read_metric_lines(tmp / "metrics.jsonl")
        in_step = [sp for sp in spans if not sp.tags.get("probe")]
        print(f"  (a) {len(spans)} collective spans ({len(in_step)} in the steps, "
              f"{len(spans) - len(in_step)} probes) over {len(rows)} rows, equal to "
              f"hetccl.dispatches; every span priced; trace, flight dump "
              f"({dump['n_total']} entries, {dump['dropped']} dropped) and metric line "
              f"({line['kind']}) valid; rows_from_flight covers the "
              f"{len(tel.tracer.dispatched_cells())} dispatched cells")
        print(f"  first calibration rows of the card ({card['nvidia_smi']}; measured = host "
              f"wall of a dispatch on its rank's thread, enqueue and barrier waits; modeled on "
              f"H100 islands):")
        for r in sorted(cal, key=lambda r: (r.op, r.size_class, r.backend))[:8]:
            print(f"     {r.op:<15} {r.size_class:<7} {r.backend:<7} measured "
                  f"{r.measured_s * 1e3:9.3f} ms  modeled {r.modeled_s * 1e3:8.4f} ms  "
                  f"ratio {r.ratio:9.2f}")
        out["calibration_rows"] = [dataclasses.asdict(r) for r in cal]
        part_done("a")

        # (b) (a)'s first CKPT_EVERY steps and their save, then a fresh
        # program that restores that save and runs the rest untraced
        mid = f"step_{CKPT_EVERY:08d}"
        (tmp / "b" / mid).mkdir(parents=True)
        for f in (tmp / "a" / mid).iterdir():
            os.link(f, tmp / "b" / mid / f.name)
        b2 = run(["--steps", str(CKPT_STEPS), "--ckpt-every", str(CKPT_EVERY),
                  "--ckpt-dir", str(tmp / "b")])
        la = [h["loss"] for h in a["history"]]
        lb = la[:CKPT_EVERY] + [h["loss"] for h in b2["history"]]
        same_losses = la == lb
        same_state = _states_equal(torch, a["state"], b2["state"])
        print(f"  (b) losses straight {la}; resumed {lb} (steps "
              f"{[h['step'] for h in b2['history']]} after the restore): equal bit for bit "
              f"{same_losses}; final states (params, master, moments, EF residuals of every "
              f"rank) equal bit for bit {same_state}")
        check(same_losses and same_state, "(b) the resumed run differs from the straight run")
        traced_ms = statistics.median(h["step_s"] for h in a["history"][1:]) * 1e3
        plain_ms = statistics.median(h["step_s"] for h in b2["history"][1:]) * 1e3
        print(f"  step time (host clock, the metrics' read included; after each run's first "
              f"step): with --trace {traced_ms:.1f} ms (median of {CKPT_STEPS - 1}), without "
              f"{plain_ms:.1f} ms ({CKPT_STEPS - CKPT_EVERY - 1} step)")
        out.update(losses=la, traced_step_ms=traced_ms, step_ms=plain_ms)
        del b2
        part_done("b")

        # (c) reshard: ZeRO-1's checkpoint, and a ZeRO-3 state, onto other meshes
        prog_a = a["prog"]
        cfg = prog_a.model.cfg
        model = prog_a.model
        saved_step = ck.latest_step(str(tmp / "a"))
        # the arrays of (a)'s last save: its final state's (b) read them back
        saved = ck.StateLayout(prog_a).logical_state(a["state"])
        check(saved["step"] == saved_step, "(c) the last save is not of the final state")

        def prog_on(shape, extra):
            m = mesh_mod.ThreadMesh(shape, device=device)
            args = launcher.parser().parse_args(flags + extra)
            rc, plan, _ = launcher.plan_run(args, m, cfg)
            return make_train_program(model, m, rc, plan)

        p1 = prog_on(RESHARD_ZERO1, ["--error-feedback", "off"])
        r1 = ck.restore(str(tmp / "a"), saved_step, None, p1)
        got1 = ck.StateLayout(p1).logical_state(r1)
        ok1 = _states_equal(torch, got1, {**saved, "opt": {k: v for k, v in saved["opt"].items()
                                                            if k != "ef"}})
        try:
            ck.restore(str(tmp / "a"), saved_step, None, prog_on(RESHARD_ZERO1, []))
            ef_refused = False
        except ValueError:
            ef_refused = True
        del r1, got1
        p3 = prog_on(PLANNED_MESH, ["--zero", "3", "--error-feedback", "off"])
        flat = {k: saved["opt"][k] for k in ("m", "v", "master")}
        pl, rebuild = flatten(saved["params"])
        tree3 = {"params": saved["params"], "step": saved["step"],
                 "opt": {k: rebuild([t.reshape(p.shape) for t, p in
                                     zip(flatten(v)[0], pl)]) for k, v in flat.items()}}
        s3 = ck.StateLayout(p3).place(tree3)
        ck.save(str(tmp / "z3"), saved_step, s3, p3)
        want3 = ck.StateLayout(p3).logical_state(s3)
        q3 = prog_on(RESHARD_ZERO3, ["--zero", "3", "--error-feedback", "off"])
        r3 = ck.restore(str(tmp / "z3"), saved_step, None, q3)
        ok3 = _states_equal(torch, ck.StateLayout(q3).logical_state(r3), want3)
        print(f"  (c) ZeRO-1 step {saved_step} of (2, 2) onto {RESHARD_ZERO1}: params, master, "
              f"moments equal to the saved full arrays bit for bit {ok1}; onto the same mesh "
              f"with error feedback on, refused (the residuals are each rank's own) "
              f"{ef_refused}; ZeRO-3 saved on (2, 2) onto {RESHARD_ZERO3}: equal bit for bit "
              f"{ok3}")
        check(ok1 and ok3 and ef_refused, "(c) a resharded restore differs")
        del s3, r3, want3, saved, tree3, flat, pl
        gc.collect()
        torch.cuda.empty_cache()
        part_done("c")

        # (d) the counter: a step on the card and the same step on meta
        prog = a["prog"]
        seq = int(flags[flags.index("--seq") + 1])
        pipe_batch = DataPipeline(seed=SEED, plan=prog.plan, dp_world=prog.dp_world(),
                                  seq_len=seq, vocab=cfg.vocab).batch_at(CKPT_STEPS)
        with analysis.counting() as on_card:
            prog.step_fn(a["state"], pipe_batch)
        del a
        gc.collect()
        shape_mesh = mesh_mod.ShapeMesh(PLANNED_MESH)
        first = {}            # one run for the pods of equal shares
        shape_mesh.same_pods([first.setdefault(tuple(row), p)
                              for p, row in enumerate(prog.plan.live_mask())])
        meta_prog = make_train_program(model, shape_mesh, prog.rc, prog.plan)
        states_m = meta_prog.init_fn(dryrun.meta_params(model, getattr(torch,
                                                                       prog.rc.param_dtype)))
        with analysis.counting() as on_meta:
            meta_prog.step_fn(states_m, {k: np.zeros_like(v) for k, v in pipe_batch.items()})
        # meta runs one rank for the pods of equal shares: each card rank
        # against its pod's stand-in
        per_pod = shape_mesh.per_pod
        for r, c in sorted(on_card.ranks.items()):
            mt = on_meta.ranks[shape_mesh.stand_in[r // per_pod] * per_pod]
            print(f"  (d) rank {r}'s step counted on the card (CUDA kernels): dot "
                  f"{c.dot_flops:.6e} FLOP, wire {c.wire_bytes:.6e} B (cross-pod "
                  f"{c.cross_pod_bytes:.6e}), HBM {c.hbm_bytes:.6e} B; on meta (plain "
                  f"versions): dot {mt.dot_flops:.6e}, wire {mt.wire_bytes:.6e} (cross-pod "
                  f"{mt.cross_pod_bytes:.6e}), HBM {mt.hbm_bytes:.6e}")
            check(c.dot_flops == mt.dot_flops and c.wire_bytes == mt.wire_bytes
                  and c.cross_pod_bytes == mt.cross_pod_bytes,
                  f"(d) rank {r}: the card's count differs from meta's in dot FLOPs or wire "
                  f"bytes")
        rows_per_step = prog.plan.micro_batch * prog.plan.n_micro_max * prog.dp_world()
        shape = ShapeConfig("smollm_step", seq, rows_per_step, "train")
        flops = dryrun.model_flops_spec(cfg, shape)
        roof = analysis.roofline_of(on_card, arch=ARCH, shape=shape.name, mesh="one card",
                                    model_flops=flops, shared=True)
        out["roofline"] = {k: roof.row()[k] for k in (
            "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
            "hlo_dot_flops_per_chip", "hbm_bytes_per_chip", "wire_bytes_per_chip",
            "useful_flops_frac", "roofline_frac")}
        out["meta_hbm_bytes_rank0"] = on_meta.ranks[0].hbm_bytes
        out["card_hbm_bytes_rank0"] = on_card.ranks[0].hbm_bytes
        runs = {"[32]": plain_ms, "[31] a": planned["a"]["median_ms"]}
        out["mfu"] = {}
        for label, ms in runs.items():
            mfu = flops / (hw.H100.peak_flops * ms / 1e3)
            out["mfu"][label] = mfu
            print(f"  one-card roofline ({card['nvidia_smi']}; the 4 ranks' sums on "
                  f"{hw.H100_SHARED.name}): compute {roof.compute_s * 1e3:.3f} ms, memory "
                  f"{roof.memory_s * 1e3:.3f} ms, collective (HBM) {roof.collective_s * 1e3:.3f} "
                  f"ms, dominant {roof.dominant}; {label} measured step {ms:.1f} ms; MFU = "
                  f"model_flops_spec {flops:.4e} / (989e12 x step) = {mfu:.4e}; the step at "
                  f"{roof.step_s / (ms / 1e3):.4e} of its roofline")

        part_done("d")

        # (e) the dry run
        out["dryrun"] = {}
        for arch, shape_name, mesh_kind, plan_mode, *cut in dryrun_cells:
            t = time.perf_counter()
            rec = dryrun.run_cell(arch, shape_name, mesh_kind, plan_mode=plan_mode,
                                  verbose=False, **(cut[0] if cut else {}))
            check(rec["status"] == "ok", f"(e) dry run {arch} {shape_name} {mesh_kind}: "
                                         f"{rec.get('error')}")
            keep = {k: rec[k] for k in ("compute_s", "memory_s", "collective_s", "dominant",
                                        "roofline_frac", "state_bytes_per_rank",
                                        "live_peak_bytes", "fits")}
            out["dryrun"][f"{arch}/{shape_name}/{mesh_kind}"] = keep
            print(f"  (e) dry run {arch} {shape_name} on {mesh_kind} (plan {plan_mode}): ok in "
                  f"{time.perf_counter() - t:.1f} s; {keep}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def elastic_launches(zero, n_layers, n_leaves, n_buckets, gathers, segments):
    """The launches an elastic run of [33] implies, from its segments
    ``[(ranks, micro-steps a rank, steps, has a pod axis)]``: the flash
    forward twice per layer and micro-step on every rank (remat), the
    backward once; under hier/pallas the fused rings run the cross-pod stage
    (one launch for every rank), so a survivor mesh without a pod axis
    launches them only in ZeRO-3's fsdp adjoint (one reduce-scatter over
    "data" per gathered key and micro-step).  ZeRO-3 all-reduces each leaf
    across the pods (one reduce-scatter and one all-gather); ZeRO-1
    reduce-scatters and gathers each bucket and gathers each parameter."""
    out = dict.fromkeys(ELASTIC_KERNELS, 0)
    for ranks, n_micro, steps, pod in segments:
        out["flash_attention_fwd"] += 2 * n_layers * n_micro * ranks * steps
        out["flash_attention_bwd"] += n_layers * n_micro * ranks * steps
        if zero == 3:
            out["ring_reduce_scatter"] += (gathers * n_micro + (n_leaves if pod else 0)) * steps
            out["ring_all_gather"] += (n_leaves if pod else 0) * steps
        elif pod:
            out["ring_reduce_scatter"] += n_buckets * steps
            out["ring_all_gather"] += (n_buckets + n_leaves) * steps
    return out


def phase_elastic(torch, np, mesh_mod, hetccl, counters, card, flags=PLANNED_FLAGS,
                  device="cuda"):
    """[33]: the elastic loop through the launcher, a hang and a pod loss
    under ZeRO-3 and a pod loss under ZeRO-1 (``ELASTIC_RUNS``).  ``flags``
    and ``device`` let a test run it reduced on the CPU, with a ``counters``
    that counts there."""
    import math
    import shutil
    import tempfile

    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.elastic import recover as recover_mod
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import ft
    from repro_torch.train.trainer import make_train_program

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    out = {}

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def batches(p, args):
        cfg = p.model.cfg
        return DataPipeline(seed=args.seed, plan=p.plan, dp_world=p.dp_world(),
                            seq_len=args.seq, vocab=cfg.vocab).batch_at

    def losses_of(hist):
        return [h["loss"] for h in hist]

    def stepped(p, state, args, start):
        """``p`` stepped from ``state`` over steps start.. with the run's
        batches: the losses (no checkpoint written)."""
        losses, batch_at = [], batches(p, args)
        for s in range(start, ELASTIC_STEPS):
            state, met = p.step_fn(state, batch_at(s))
            losses.append(met["loss"].item())
        return losses

    try:
        for name, extra in ELASTIC_RUNS.items():
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
            args = launcher.parser().parse_args(
                flags + ELASTIC_FLAGS + extra + ["--device", device, "--ckpt-dir",
                                                 str(tmp / name)])
            recoveries = []
            real = recover_mod.recover_state

            def nan_then_recover(state, step, new_prog, dead, **kw):
                # the lost pod's ranks to NaN, so a read of them would show;
                # they share no storage with a live rank
                live = {t.untyped_storage().data_ptr() for r, st in enumerate(state)
                        if r not in dead for t in leaves(st) if isinstance(t, torch.Tensor)}
                for r in dead:
                    for t in leaves(state[r]):
                        if isinstance(t, torch.Tensor) and t.is_floating_point():
                            check(t.untyped_storage().data_ptr() not in live,
                                  f"({name}) a lost rank's tensor shares a live rank's storage")
                            t.fill_(float("nan"))
                sync()
                t0 = time.perf_counter()
                rec = real(state, step, new_prog, dead, **kw)
                sync()
                recoveries.append({"wall_s": time.perf_counter() - t0, "dead": list(dead),
                                   "method": rec.method})
                return rec

            counters.reset()
            t_run = time.perf_counter()
            with patched(recover_mod, "recover_state", nan_then_recover):
                res = launcher.run(args)
            wall = time.perf_counter() - t_run
            launches = counters.read()
            report, sprog = res["report"], res["prog"]
            prog0 = None
            hist = report.history
            lost_at = report.recoveries[0].step if report.recoveries else None
            steps_ms = [(h["step"], 4 if h["step"] < lost_at else 2, h["step_s"] * 1e3)
                        for h in hist]
            print(f"  ({name}) {' '.join(extra)}: losses {['%.6f' % x for x in losses_of(hist)]}; "
                  f"ms a step (host clock, the metrics' read included; step, ranks, ms) "
                  f"{[(s, r, round(ms, 1)) for s, r, ms in steps_ms]} ({card['nvidia_smi']}); "
                  f"run wall {wall:.1f} s")
            for ev in report.hang_events:
                print(f"     hang: {ev.op}/{ev.size_class} at step {ev.step} (pod {ev.pod}), "
                      f"elapsed {ev.elapsed_s}, deadline {ev.deadline_s:.4e} s (modeled), "
                      f"breach #{ev.breaches} -> {ev.action}")
            for r in report.rebuilds:
                print(f"     epoch {r.epoch}: {r.event.kind}:{r.event.pod} at step {r.event.step} "
                      f"-> pods {[p.name for p in r.cluster.pods]} shares {r.plan.micro_per_pod}; "
                      f"modeled (simulator, H100 islands, {r.state_bytes / 1e9:.3f} GB of state) "
                      f"checkpointless {r.modeled_checkpointless_s:.4f} s, checkpoint "
                      f"{r.modeled_checkpoint_s:.4f} s")
            for rec, seen in zip(report.recoveries, recoveries):
                print(f"     recovery: {rec.method} at step {rec.step}, lost ranks "
                      f"{seen['dead']} (NaN), wall {seen['wall_s']:.3f} s (measured)"
                      + (f"; missing {len(rec.missing)} leaves, all under ['opt']"
                         if rec.missing else ""))
            check([h["step"] for h in hist] == list(range(ELASTIC_STEPS)),
                  f"({name}) history steps {[h['step'] for h in hist]}")
            check(all(np.isfinite(losses_of(hist))), f"({name}) a non-finite loss")
            check("pod" not in sprog.mesh.axes and sprog.mesh.size == 2,
                  f"({name}) the final mesh is {sprog.mesh.shape}")
            check([s["dead"] for s in recoveries] == [[2, 3]],
                  f"({name}) the recoveries lost {[s['dead'] for s in recoveries]}")
            # what the run's leaves, buckets, gathers and steps imply
            model = sprog.model
            metas = model.abstract_params()
            g_leaves = [torch.empty(t.shape, dtype=torch.float32, device="meta")
                        for t in leaves(metas)]
            zero = sprog.rc.zero_stage
            # steps run on 4 ranks: those before the loss (a stalled step ran
            # not at all; (b) runs step 2 on 4 ranks, then again on 2)
            lost = next(r.event.step for r in report.rebuilds if r.event.kind == "pod-dead")
            want = elastic_launches(
                zero, model.cfg.n_layers, len(g_leaves),
                len(hetccl._make_buckets(g_leaves, sprog.rc.bucket_bytes)),
                zero3_gathers(metas, 2),
                [(4, args.n_micro, lost, True),
                 (2, sprog.plan.n_micro_max, ELASTIC_STEPS - lost_at, False)])
            got = {k: launches[k] for k in ELASTIC_KERNELS}
            print(f"     launches {got}, expected {want}")
            check(got == want and all(got.values()),
                  f"({name}) launches {got} differ from the run's {want}")
            if name == "a":
                check(report.hang_actions == ["retry", "retry", "rebuild"],
                      f"(a) hang actions {report.hang_actions}")
                check(all(math.isinf(e.elapsed_s) and e.pod == "pod0" and e.step == 1
                          for e in report.hang_events),
                      "(a) the watchdog breached on a dispatch, not only the injected stall")
                check([r.event.kind for r in report.rebuilds] == ["comm-rebuild", "pod-dead"]
                      and [p.name for p in report.rebuilds[0].cluster.pods] == ["pod0", "pod1"],
                      "(a) the rebuilds are not a communicator rebuild on both pods, then the "
                      "loss")
                check(report.recovery_methods == ["checkpointless"] and lost_at == 2,
                      f"(a) recoveries {report.recovery_methods} at {lost_at}")
                # the uninterrupted run from the launcher's init
                rc, plan, _ = launcher.plan_run(args, mesh_mod.ThreadMesh(
                    {"pod": 2, "data": 2}, device=device), model.cfg)
                prog0 = make_train_program(model, mesh_mod.ThreadMesh({"pod": 2, "data": 2},
                                                                      device=device), rc, plan)
                state, h01 = ft.run_supervised(prog0.step_fn, prog0.init_fn(),
                                               batches(prog0, args),
                                               ckpt_dir=str(tmp / "a_truth"), ckpt_every=100,
                                               n_steps=lost_at, start_step=0, layout=prog0)
                tree = ck.StateLayout(prog0).gather(state, ())[0]
                del state
                placed = ck.place_tree(leaves(tree), ck.StateLayout(sprog).logical_like(), sprog)
                del tree
                want_l = losses_of(h01) + stepped(sprog, placed, args, lost_at)
            else:
                rec = report.recoveries[0]
                check(report.recovery_methods == ["checkpoint"] and lost_at == 2
                      and rec.missing and all(p.startswith("['opt']") for p in rec.missing),
                      f"(b) recoveries {report.recovery_methods} at {lost_at}, missing "
                      f"{rec.missing[:3]}")
                base = ck.restore(str(tmp / name), lost_at, None, sprog)
                want_l = losses_of(hist[:lost_at]) + stepped(sprog, base, args, lost_at)
            same = losses_of(hist) == want_l
            after = (f"step {lost_at}" if lost_at == ELASTIC_STEPS - 1
                     else f"steps {lost_at}-{ELASTIC_STEPS - 1}")
            print(f"     against the uninterrupted and continued runs: {['%.6f' % x for x in want_l]}"
                  f" ({'steps 0-1 run_supervised from the same init, ' if name == 'a' else ''}"
                  f"{after} the survivor program stepped from "
                  f"{'that run' if name == 'a' else 'the step-2 checkpoint'}): equal bit for bit "
                  f"{same}")
            check(same, f"({name}) the elastic run's losses differ from the uninterrupted and "
                        f"continued runs")
            out[name] = {"losses": losses_of(hist), "launches": got, "steps_ms": steps_ms,
                         "run_wall_s": wall, "recovery_wall_s": [s["wall_s"] for s in recoveries],
                         "hang_actions": report.hang_actions,
                         "recovery_methods": report.recovery_methods,
                         "modeled_s": [(r.event.kind, r.modeled_checkpointless_s,
                                        r.modeled_checkpoint_s) for r in report.rebuilds]}
            del res, report, sprog, prog0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# [34] the VLM and [35] the encoder-decoder served at full width (ROADMAP
# A8b, A8c)
# ---------------------------------------------------------------------------

def perturb_leaves(torch, params, seed):
    """Every bias (``BIAS_LEAVES``, and the LayerNorm shifts ``*_b``) drawn
    as 0.1 N(0, 1) and every norm scale (``NORM_LEAVES``) as 1 + 0.1 N(0,
    1), in place, from ``seed``, leaf by leaf in sorted order.  Returns the
    number of leaves drawn."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 0

    def walk(tree):
        nonlocal n
        for name in sorted(tree):
            t = tree[name]
            if isinstance(t, dict):
                walk(t)
                continue
            bias = name in BIAS_LEAVES or name.endswith("_b")
            if bias or name in NORM_LEAVES:
                draw = torch.randn(t.shape, generator=gen, device="cuda") * 0.1
                t.copy_(draw if bias else draw + 1)
                n += 1

    walk(params)
    return n


def redraw_projections(torch, params, seed):
    """Every projection (``PROJ_FAN_IN_DIMS``) of a stacked block tree
    (``blocks``, ``enc_blocks``, ``dec_blocks``) drawn again as N(0, 1) /
    sqrt(fan-in), the product of the dims it contracts after the layer
    axis, in place on its device, from ``seed``, leaf by leaf in sorted
    order and layer by layer (a transient of one layer).  Returns the number
    of leaves drawn."""
    gen = None
    n = 0

    def walk(tree, stacked):
        nonlocal gen, n
        for name in sorted(tree):
            t = tree[name]
            if isinstance(t, dict):
                walk(t, stacked or name.endswith("blocks"))
                continue
            dims = PROJ_FAN_IN_DIMS.get(name)
            if dims is None or not stacked:
                continue
            gen = gen or torch.Generator(device=t.device).manual_seed(seed)
            std = math.prod(t.shape[1:1 + dims]) ** -0.5
            for layer in t:
                layer.copy_(torch.randn(layer.shape, generator=gen, device=t.device) * std)
            n += 1

    walk(params, False)
    return n


def served_checks(cfg, done, n_requests, new_tokens, finite):
    check(len(done) == n_requests and all(len(r.out) == new_tokens for r in done),
          f"{cfg.name}: not every request got its tokens")
    check(all(0 <= tok < cfg.vocab for r in done for tok in r.out),
          f"{cfg.name}: a token is outside the vocab")
    check(finite, f"{cfg.name}: non-finite logits in the serve run")


def phase_vlm_serve(torch, np, fa, ops, tacc, engine, build, counters, cfg, cases):
    """qwen2-vl-72b cut to ``VLM_LAYERS``: VLM_REQUESTS x VLM_PROMPT +
    VLM_NEW through ``Batcher`` (the counts set to 0 just before and read
    just after: one flash launch per layer at d 128, none in decode), then a
    prefill on the ``mrope_grid`` layout: each layer's kernel against its
    plain version, the last-position logits against attention pinned to
    plain and against the text-only positions (which must differ); times,
    busy shares, peak memory; the kernel's times at this prefill's shape."""
    dev = torch.device("cuda")
    model, params, init_s = served_model(torch, build, cfg)
    L, d = cfg.n_layers, cfg.head_dim_
    max_len = VLM_PROMPT + VLM_NEW
    progs = engine.make_serve_programs(model, seq_len=VLM_PROMPT, max_len=max_len, device=dev)
    rng = np.random.RandomState(SEED + L)
    prompts = [rng.randint(0, cfg.vocab, VLM_PROMPT).astype(np.int32)
               for _ in range(VLM_REQUESTS)]
    done, serve_s, launches, peak_gib, finite = batched_serve(
        torch, engine, counters, progs, params, prompts, VLM_PROMPT, max_len, VLM_NEW)
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests x {VLM_PROMPT} prompt tokens, {n_tok} new tokens in "
          f"{serve_s:.3f} s; flash launches {launches['flash_attention_fwd']} ({L} per prefill, "
          f"none in decode), at d {d}: {launches[f'flash_attention_fwd_d{d}']}")
    check(launches["flash_attention_fwd"] == L and launches[f"flash_attention_fwd_d{d}"] == L,
          f"{cfg.name}: flash launched {launches['flash_attention_fwd']} times, {L} expected")
    served_checks(cfg, done, VLM_REQUESTS, VLM_NEW, finite)

    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    grid = torch.as_tensor(mrope_grid(np, VLM_REQUESTS, VLM_PROMPT, VLM_GRID_START,
                                      VLM_GRID_SIDE), device=dev)
    text = torch.arange(VLM_PROMPT, device=dev)[None, None].expand(3, VLM_REQUESTS, VLM_PROMPT)
    grid_batch = {"tokens": toks, "mrope": grid}
    counters.reset()
    _, cache = progs.prefill_fn(params, grid_batch)
    prefill_launches = counters.read()["flash_attention_fwd"]
    for _ in range(2):
        _, cache = progs.decode_fn(params, cache, toks[:, -1:])
    torch.cuda.synchronize()
    decode_launches = counters.read()["flash_attention_fwd"] - prefill_launches
    del cache
    check(prefill_launches == L and decode_launches == 0,
          f"{cfg.name}: a grid prefill launched flash {prefill_launches} times ({L} expected), "
          f"two decode steps {decode_launches} (0 expected)")
    layers = worst_by_shape(
        attention_records(torch, tacc, ops, fa, lambda: model.prefill(params, grid_batch)),
        cfg.dtype, {f"causal_sq{VLM_PROMPT}_sk{VLM_PROMPT}_d{d}": L})
    V = cfg.vocab
    lk = last_logits_pinned(torch, tacc, lambda: model.prefill(params, grid_batch), False, V)
    lp = last_logits_pinned(torch, tacc, lambda: model.prefill(params, grid_batch), True, V)
    lt = last_logits_pinned(torch, tacc, lambda: model.prefill(
        params, {"tokens": toks, "mrope": text}), False, V)
    for t in (lk, lp, lt):
        check(bool(torch.isfinite(t).all()), f"{cfg.name}: non-finite prefill logits")
    agree = {"bf16_kernel_vs_plain": _rel_l2(lk, lp), "grid_vs_text_only": _rel_l2(lk, lt),
             "bf16_same_argmax": (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()}
    print("  grid prefill's last-position logits, rel L2: " + ", ".join(
        f"{k} {v:.3e}" for k, v in agree.items()))
    check(agree["bf16_kernel_vs_plain"] <= VLM_BF16_LOGITS_REL_TOL,
          f"{cfg.name}: the kernel route is {agree['bf16_kernel_vs_plain']:.3e} from the plain "
          f"route, beyond {VLM_BF16_LOGITS_REL_TOL}")
    check(agree["grid_vs_text_only"] > 2 * agree["bf16_kernel_vs_plain"],
          f"{cfg.name}: the grid's positions move the logits {agree['grid_vs_text_only']:.3e}, "
          "not beyond twice the kernel-vs-plain gap: M-RoPE's sections do not act")
    out = {"arch": cfg.name, "n_layers": L, "head_dim": d, "params_b": model.n_params() / 1e9,
           "requests": len(done), "prompt_len": VLM_PROMPT, "new_tokens_per_request": VLM_NEW,
           "serve_s": serve_s, "tokens_per_s": n_tok / serve_s, "launches": launches,
           "peak_gib": peak_gib, "init_s": init_s, "grid_prefill_launches": prefill_launches,
           "decode_launches": decode_launches, "layer_worst_error": layers,
           "prefill_logits_rel_l2": agree}
    out.update(serve_times(torch, progs, params, toks, {"mrope": text}))
    del params
    print(f"  prefill {out['prefill_ms']:.2f} ms (batch {VLM_REQUESTS} x {VLM_PROMPT}), decode "
          f"{out['decode_ms_per_step']:.2f} ms per step, {out['tokens_per_s']:.1f} tokens/s end "
          f"to end; card busy share prefill {out['device_busy_prefill']}, decode "
          f"{out['device_busy_decode']}; peak memory {peak_gib:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    out["flash_times"] = {"qwen2vl": phase_times(fa, torch, cases[FLASH_TIMED["qwen2vl"]])}
    return out


def phase_encdec_serve(torch, np, fa, ops, tacc, engine, build, counters, cfg, cases):
    """whisper-medium whole: ENCDEC_REQUESTS x (n_frames frames,
    ENCDEC_PROMPT prompt tokens) + ENCDEC_NEW through ``Batcher`` (the counts
    set to 0 just before and read just after: 72 flash launches per prefill,
    none in decode, each shape counted by (kind, Sq, Sk)); then a prefill
    with each of the three attention kinds' kernel output against its plain
    version, layer by layer, the whole model's logits against attention
    pinned to plain in bf16 and in f32, and the cross k and v read by
    ENCDEC_NEW decode steps and left bit-equal; times, busy shares, peak
    memory; the kernel's times at the three shapes."""
    dev = torch.device("cuda")
    model, params, init_s = served_model(torch, build, cfg)
    Le, Ld, F, d = cfg.n_enc_layers, cfg.n_layers, cfg.n_frames, cfg.head_dim_
    n_flash = Le + 2 * Ld
    max_len = ENCDEC_PROMPT + ENCDEC_NEW
    progs = engine.make_serve_programs(model, seq_len=ENCDEC_PROMPT, max_len=max_len,
                                       device=dev)
    P = ENCDEC_PROMPT
    kinds = {"whisper_enc": (f"flash_attention_fwd_bidir_sq{F}_sk{F}", Le),
             "whisper_dec": (f"flash_attention_fwd_causal_sq{P}_sk{P}", Ld),
             "whisper_cross": (f"flash_attention_fwd_bidir_sq{P}_sk{F}", Ld)}
    by_shape = dict(kinds.values())
    rng = np.random.RandomState(SEED + Ld)
    prompts = [rng.randint(0, cfg.vocab, ENCDEC_PROMPT).astype(np.int32)
               for _ in range(ENCDEC_REQUESTS)]
    frames = [rng.randn(F, cfg.d_model).astype(np.float32) for _ in range(ENCDEC_REQUESTS)]
    done, serve_s, launches, peak_gib, finite = batched_serve(
        torch, engine, counters, progs, params, prompts, ENCDEC_PROMPT, max_len, ENCDEC_NEW,
        frames=frames)
    n_tok = sum(len(r.out) for r in done)
    print(f"  served {len(done)} requests x ({F} frames, {ENCDEC_PROMPT} prompt tokens), "
          f"{n_tok} new tokens in {serve_s:.3f} s; flash launches "
          f"{launches['flash_attention_fwd']} ({n_flash} per prefill: {Le} encoder, {Ld} "
          f"decoder, {Ld} cross; none in decode), at d {d}: "
          f"{launches[f'flash_attention_fwd_d{d}']}; by shape "
          f"{ {k: launches.get(k, 0) for k in by_shape} }")
    check(launches["flash_attention_fwd"] == n_flash
          and launches[f"flash_attention_fwd_d{d}"] == n_flash
          and all(launches.get(k, 0) == n for k, n in by_shape.items()),
          f"{cfg.name}: flash launched {launches['flash_attention_fwd']} times, {n_flash} "
          f"expected, by shape {by_shape}")
    served_checks(cfg, done, ENCDEC_REQUESTS, ENCDEC_NEW, finite)

    toks = torch.as_tensor(np.stack(prompts).astype(np.int64), device=dev)
    fr = torch.as_tensor(np.stack(frames), device=dev)
    batch = {"tokens": toks, "frames": fr}
    layers = worst_by_shape(
        attention_records(torch, tacc, ops, fa, lambda: model.prefill(params, batch)),
        cfg.dtype, {f"bidir_sq{F}_sk{F}_d{d}": Le,
                    f"causal_sq{ENCDEC_PROMPT}_sk{ENCDEC_PROMPT}_d{d}": Ld,
                    f"bidir_sq{ENCDEC_PROMPT}_sk{F}_d{d}": Ld})
    # the whole model's logits against attention pinned to plain, in bf16 and
    # with the same weights in f32
    m32 = build(dataclasses.replace(cfg, dtype="float32"))
    p32 = _tree_map(lambda t: t.float(), params)
    ls = [last_logits_pinned(torch, tacc, lambda m=m, q=q: m.prefill(q, batch), plain, cfg.vocab)
          for m, q in ((model, params), (m32, p32)) for plain in (False, True)]
    del p32
    for t in ls:
        check(bool(torch.isfinite(t).all()), f"{cfg.name}: non-finite prefill logits")
    lk, lp, lfk, lf = ls
    agree = {"bf16_kernel_vs_plain": _rel_l2(lk, lp), "bf16_plain_vs_f32": _rel_l2(lp, lf),
             "f32_kernel_vs_plain": _rel_l2(lfk, lf),
             "bf16_same_argmax": (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()}
    print("  prefill last-position logits, rel L2: " + ", ".join(
        f"{k} {v:.3e}" for k, v in agree.items()))
    check(agree["bf16_kernel_vs_plain"] <= ENCDEC_BF16_LOGITS_REL_TOL,
          f"{cfg.name}: the kernel route is {agree['bf16_kernel_vs_plain']:.3e} from the plain "
          f"route, beyond {ENCDEC_BF16_LOGITS_REL_TOL}")
    check(agree["f32_kernel_vs_plain"] <= F32_LOGITS_REL_TOL,
          f"{cfg.name}: the f32 kernel route is {agree['f32_kernel_vs_plain']:.3e} from the "
          f"plain route, beyond {F32_LOGITS_REL_TOL}")

    # decode reads the cached cross k and v and never writes them
    counters.reset()
    _, cache = progs.prefill_fn(params, batch)
    prefill_launches = counters.read()["flash_attention_fwd"]
    cross = (cache["cross_k"].clone(), cache["cross_v"].clone())
    check(cache["cross_k"].dtype == getattr(torch, cfg.dtype)
          and tuple(cache["cross_k"].shape) == (Ld, ENCDEC_REQUESTS, F, cfg.n_kv_heads, d),
          f"{cfg.name}: cross_k {tuple(cache['cross_k'].shape)} {cache['cross_k'].dtype}")
    cur = toks[:, -1:]
    for _ in range(ENCDEC_NEW):
        logits, cache = progs.decode_fn(params, cache, cur)
        cur = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode_launches = counters.read()["flash_attention_fwd"] - prefill_launches
    same = torch.equal(cache["cross_k"], cross[0]) and torch.equal(cache["cross_v"], cross[1])
    print(f"  cache: cross_k and cross_v {tuple(cross[0].shape)} {cross[0].dtype} "
          f"({2 * cross[0].numel() * cross[0].element_size() / 2**30:.3f} GiB), bit-equal after "
          f"{ENCDEC_NEW} decode steps: {same}; flash launches: prefill {prefill_launches}, "
          f"decode {decode_launches}")
    check(same, f"{cfg.name}: decode changed the cached cross k or v")
    check(prefill_launches == n_flash and decode_launches == 0,
          f"{cfg.name}: prefill launched flash {prefill_launches} times ({n_flash} expected), "
          f"decode {decode_launches} (0 expected)")
    del cache, cross
    out = {"arch": cfg.name, "n_enc_layers": Le, "n_layers": Ld, "n_frames": F, "head_dim": d,
           "params_b": model.n_params() / 1e9, "analytic_params_b": cfg.n_params() / 1e9,
           "requests": len(done), "prompt_len": ENCDEC_PROMPT,
           "new_tokens_per_request": ENCDEC_NEW, "serve_s": serve_s,
           "tokens_per_s": n_tok / serve_s, "launches": launches, "peak_gib": peak_gib,
           "init_s": init_s, "decode_launches": decode_launches, "cross_kv_bit_equal": same,
           "launches_by_kind": {name: launches[key] for name, (key, _) in kinds.items()},
           "layer_worst_error": layers, "prefill_logits_rel_l2": agree}
    out.update(serve_times(torch, progs, params, toks, {"frames": fr}))
    del params
    print(f"  prefill {out['prefill_ms']:.2f} ms (batch {ENCDEC_REQUESTS} x ({F} frames, "
          f"{ENCDEC_PROMPT} tokens)), decode {out['decode_ms_per_step']:.2f} ms per step, "
          f"{out['tokens_per_s']:.1f} tokens/s end to end; card busy share prefill "
          f"{out['device_busy_prefill']}, decode {out['device_busy_decode']}; peak memory "
          f"{peak_gib:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    out["flash_times"] = {name: phase_times(fa, torch, cases[FLASH_TIMED[name]])
                          for name in ("whisper_enc", "whisper_dec", "whisper_cross")}
    return out


def ring_expectations(zero, n_adjoint, n_leaves, n_buckets, steps):
    """The fused ring launches of ``steps`` steps on (pod=2, data=2), hier,
    pallas, no codec: under ZeRO-1 the gradient buckets' reduce-scatter and
    all-gather and each leaf's parameter all-gather; under ZeRO-3 the fsdp
    adjoint's reduce-scatters (``n_adjoint``) and each leaf's all-reduce
    across the pods."""
    if zero == 3:
        return {"ring_reduce_scatter": n_adjoint + n_leaves * steps,
                "ring_all_gather": n_leaves * steps}
    return {"ring_reduce_scatter": n_buckets * steps,
            "ring_all_gather": (n_buckets + n_leaves) * steps}


def flash_by_shape(launches, shapes, n_fwd, n_bwd):
    """{launch key: (count, expected)} of the flash forward and backward at
    each (kind, Sq, Sk) of ``shapes`` ({(kind, Sq, Sk): layers}): ``n_fwd``
    and ``n_bwd`` launches per layer."""
    out = {}
    for (kind, sq, sk), layers in shapes.items():
        for way, n in (("fwd", n_fwd), ("bwd", n_bwd)):
            key = f"flash_attention_{way}_{kind}_sq{sq}_sk{sk}"
            out[key] = (launches.get(key, 0), n * layers)
    return out


def train_stage_run(torch, np, hetccl, collectives, ring_dma, counters, model, m, plan,
                    batches, zero, init, profile="extra", lr=FAMILY_TRAIN_LR, moments=None):
    """The steps of ``batches`` under ZeRO-``zero`` (hier, pallas, no codec)
    from ``init[0]`` (ZeRO-1 pops it: its ranks share the init's tensors,
    which go once the first step replaces them), the counts set to 0 just
    before and read just after, the fsdp adjoint's fused reduce-scatters
    counted.  ``profile``: "extra", one more step under torch.profiler;
    "last", the last of the steps under it (ms a step then from the
    unprofiled steps); its card time by kernel under "kernel_us".  Returns
    the run's readings and the full parameters after step 0 on the host
    (ZeRO-3's rebuilt by ``unshard_params``); a list passed as ``moments``
    gets the full first moments after step 0 (``full_moments``)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import unshard_params
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.train.trainer import make_train_program
    prog = make_train_program(model, m, RunConfig(
        zero_stage=zero, collective_mode="hier", backend="pallas", learning_rate=lr), plan)
    n_buckets = len(hetccl._make_buckets(
        [torch.empty(p.shape, dtype=torch.float32, device="meta") for p in tree_leaves(init[0])],
        prog.comm.bucket_bytes))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = prog.init_fn(init[0] if zero == 3 else init.pop())
    counters.reset()
    losses, grad_norms, step_ms, after_step0 = [], [], [], None
    busy, kernel_us = None, {}

    def step(batch):
        nonlocal state
        state, met = prog.step_fn(state, batch)
        losses.append(met["loss"].item())
        grad_norms.append(met["grad_norm"].item())

    with adjoint_rs_counter(collectives, ring_dma) as adjoint:
        for i, batch in enumerate(batches):
            if profile == "last" and i == len(batches) - 1:
                busy, kernel_us = device_profile(torch, lambda: step(batch), 1)
                continue
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if i == 0:                 # full leaves after step 0, on the host
                full = (unshard_params([state[r]["params"] for r in m.group(0, "data")],
                                       model.abstract_params())
                        if zero == 3 else state[0]["params"])
                after_step0 = [p.to("cpu") for p in tree_leaves(full)]
                del full
                if moments is not None:
                    moments.extend(full_moments(torch, state, m, zero, model.abstract_params()))
    launches = counters.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if profile == "extra":
        busy, kernel_us = device_profile(
            torch, lambda: prog.step_fn(state, batches[-1]), 1)
    card_ms = sum(kernel_us.values()) / 1e3 if kernel_us else None
    del state, prog
    gc.collect()
    torch.cuda.empty_cache()
    n_tokens = int(np.prod(batches[0]["tokens"].shape))
    ms = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    return {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms, "ms_per_step": ms,
            "tokens_per_s": n_tokens / ms * 1e3, "device_busy_one_more_step": busy,
            "card_ms_one_more_step": card_ms, "peak_gib": peak_gib, "launches": launches,
            "adjoint_rs_launches": adjoint[0], "n_buckets": n_buckets,
            "kernel_us": kernel_us}, after_step0


def print_stage(label, r):
    print(f"  {label}: losses {['%.6f' % x for x in r['losses']]}; grad norms "
          f"{['%.6f' % x for x in r['grad_norms']]}; ms per unprofiled step "
          f"{['%.1f' % x for x in r['step_ms']]}, {r['tokens_per_s']:.1f} tokens/s; card busy "
          + (f"share of the profiled step (torch.profiler) {r['device_busy_one_more_step']}, its "
             f"card time {r['card_ms_one_more_step']} ms"
             if r["device_busy_one_more_step"] is not None else "share not measured")
          + f"; peak memory {r['peak_gib']:.2f} GiB")


def phase_vlm_train(torch, np, fa, build, mesh_mod, hetccl, counters, cfg):
    """qwen2-vl-72b cut to VLM_TRAIN_LAYERS, trained on one rank (the notes
    of VLM_TRAIN_LAYERS): step 0's attention gradients on the grid positions
    against the text-only ones (VLM_GRID_GRAD_FLOOR), then VLM_TRAIN_STEPS
    ZeRO-1 steps on batches whose ``mrope`` holds the grid, the counts set
    to 0 just before and read just after: 2 flash forward launches (remat's
    recompute the second) and 1 backward per layer and micro-step, at
    (causal, 4096, 4096), d 128; finite losses and gradient norms; ms a
    step, tokens/s, busy share, peak memory."""
    from repro_torch.core import balance, collectives
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ring_dma
    model, params, _ = served_model(torch, build, cfg)
    m = mesh_mod.ThreadMesh({"data": 1}, device="cuda")
    plan = balance.uniform_plan(1, VLM_TRAIN_MICRO, micro_batch=1)
    S, L = VLM_TRAIN_SEQ, cfg.n_layers
    grid = mrope_grid(np, 1, S, VLM_TRAIN_GRID_START, VLM_TRAIN_GRID_SIDE)
    batches = []
    for s in range(VLM_TRAIN_STEPS):
        b = synthetic_batch(SEED, s, plan.n_micro_max, plan.micro_batch, S, cfg.vocab)
        b["mrope"] = np.ascontiguousarray(np.broadcast_to(grid, (plan.n_micro_max, *grid.shape)))
        batches.append(b)
    n_tokens = int(np.prod(batches[0]["tokens"].shape))
    print(f"  {cfg.name}: {L} of 80 layers, {model.n_params() / 1e9:.3f}B params (the "
          f"embedding and head {2 * cfg.vocab * cfg.d_model / 1e9:.3f}B), bf16 params, f32 "
          f"master state: {18 * model.n_params() / 1e9:.1f} GB of state at 18 bytes a "
          f"parameter; mesh {m.shape}, ZeRO-1, {plan.n_micro_max} micro-steps of 1 x {S} "
          f"({VLM_TRAIN_GRID_SIDE} x {VLM_TRAIN_GRID_SIDE} grid from {VLM_TRAIN_GRID_START}), "
          f"{n_tokens} tokens per step; remat on; hier, pallas, no codec")
    # step 0's attention gradients, grid against text-only positions
    attn = params["blocks"]["attn"]
    names = sorted(attn)
    mb = {k: torch.as_tensor(batches[0][k][0]).to("cuda", torch.long)
          for k in ("tokens", "labels", "mrope")}
    grads = {}
    for layout in ("grid", "text"):
        req = {n: attn[n].detach().requires_grad_() for n in names}
        p = {**params, "blocks": {**params["blocks"], "attn": req}}
        batch = mb if layout == "grid" else {k: mb[k] for k in ("tokens", "labels")}
        ls, cnt, _ = model.loss(p, batch, remat=True)
        grads[layout] = torch.autograd.grad(ls, [req[n] for n in names])
        del req, p, ls
    per = {n: ((a.float() - b.float()).norm() / b.float().norm()).item()
           for n, a, b in zip(names, grads["grid"], grads["text"])}
    d2 = sum((a.float() - b.float()).square().sum().item()
             for a, b in zip(grads["grid"], grads["text"]))
    r2 = sum(b.float().square().sum().item() for b in grads["text"])
    grid_gap = (d2 / r2) ** 0.5
    del grads
    print(f"  step 0, the attention projections' gradients on the grid positions against "
          f"text-only: relative L2 {grid_gap:.3e} (floor {VLM_GRID_GRAD_FLOOR})  "
          f"{'ok' if grid_gap >= VLM_GRID_GRAD_FLOOR else 'FAIL'}; per leaf "
          + ", ".join(f"{n} {v:.3e}" for n, v in per.items()))
    check(grid_gap >= VLM_GRID_GRAD_FLOOR,
          f"{cfg.name}: the grid positions do not move the attention gradients")
    run, _ = train_stage_run(torch, np, hetccl, collectives, ring_dma, counters, model, m,
                             plan, batches, 1, [params])
    run.pop("kernel_us")
    del params
    print_stage("ZeRO-1", run)
    per_layer = plan.n_micro_max * m.size * VLM_TRAIN_STEPS
    expect = flash_by_shape(run["launches"], {("causal", S, S): L}, 2 * per_layer, per_layer)
    d_key = f"flash_attention_fwd_d{cfg.head_dim_}"
    expect[d_key] = (run["launches"].get(d_key, 0), 2 * per_layer * L)
    for key, (n, want) in expect.items():
        print(f"  {key}: {n} launches, {want} expected  {'ok' if n == want else 'FAIL'}")
    print(f"  ring launches (one rank: none expected): reduce-scatter "
          f"{run['launches']['ring_reduce_scatter']}, all-gather "
          f"{run['launches']['ring_all_gather']}; peak {run['peak_gib']:.2f} GiB against "
          f"{18 * model.n_params() / 2**30:.2f} GiB of state")
    check(all(n == want for n, want in expect.values()),
          f"{cfg.name}: the steps did not launch the flash kernels they imply")
    check(all(np.isfinite(run["losses"])) and all(np.isfinite(run["grad_norms"])),
          f"{cfg.name}: a loss or a gradient norm is not finite")
    run.update(arch=cfg.name, layers=L, params=model.n_params(), tokens_per_step=n_tokens,
               grid_grad_rel_l2=grid_gap, grid_grad_rel_l2_by_leaf=per,
               expected_launches={k: w for k, (_, w) in expect.items()},
               state_gb_at_18_bytes=18 * model.n_params() / 1e9)
    return run


def sdpa_bwd(torch, q, k, v, do, kw):
    """(dq, dk, dv) of ``scaled_dot_product_attention`` under autograd on
    the flash backward's inputs (no window, every key valid)."""
    import torch.nn.functional as F
    check(not kw["window"] and kw["k_len"] in (None, k.shape[2]),
          "sdpa_bwd takes neither a window nor a key length")
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=kw["kind"] == "causal",
                                       scale=kw["scale"], enable_gqa=True)
    return torch.autograd.grad(o, (qs, ks, vs), do.to(o.dtype))


def encdec_grad_gate(torch, fa, ref, model, params, batch, shapes):
    """The step-0 gate on ``batch`` (rank 0's first micro-batch), remat as
    in the step: the first flash backward launch of each (kind, Sq, Sk) of
    ``shapes`` against the plain backward on the same inputs with the
    kernel's bf16 rounding points, within BWD_BF16_POINTS_LIMITS, and
    against the f32 plain backward within BWD_SDPA_MARGIN of SDPA's backward
    on the same inputs (BWD_ENCDEC_SDPA_F32) or BWD_LIMITS; SDPA's backward
    in this run printed beside them."""
    from repro_torch.core.tree import flatten
    ps, rebuild = flatten(params)
    first = {}
    real = fa.flash_attention_bwd

    def rec(q, k, v, o, do, lse, **kw):
        out = real(q, k, v, o, do, lse, **kw)
        key = (kw["kind"], q.shape[2], k.shape[2])
        if key not in first:
            first[key] = ((q, k, v, o, do), kw, out)
        return out

    with patched(fa, "flash_attention_bwd", rec):
        req = [p.detach().requires_grad_() for p in ps]
        ls, cnt, _ = model.loss(rebuild(req), batch, remat=True)
        torch.autograd.grad(ls, req)
        del req, ls
    torch.cuda.synchronize()
    out, ok = {}, set(first) == set(shapes)
    rel_lim, row_lim = BWD_BF16_POINTS_LIMITS
    for key in sorted(first):
        (q, k, v, o, do), kw, got = first[key]
        lse = ref.attention_lse(q, k, kind=kw["kind"], window=kw["window"], k_len=kw["k_len"],
                                scale=kw["scale"])
        worst = {}
        for name, dtype in (("bf16_points", torch.bfloat16), ("f32", None)):
            want = ref.attention_bwd(q, k, v, o, do, lse, **kw, product_dtype=dtype)
            errs = [bwd_error(g, w) for g, w in zip(got, want)]
            worst[name] = {m: [e[m] for e in errs] for m in ("rel_l2", "worst_row")}
            if dtype is None:
                errs = [bwd_error(g, w) for g, w in zip(sdpa_bwd(torch, q, k, v, do, kw), want)]
                worst["sdpa_f32"] = {m: [e[m] for e in errs] for m in ("rel_l2", "worst_row")}
            del want
        w, w32, sd = worst["bf16_points"], worst["f32"], worst["sdpa_f32"]
        good = max(w["rel_l2"]) <= rel_lim and max(w["worst_row"]) <= row_lim
        lim32 = {m: [max(f, BWD_SDPA_MARGIN * x) for x in xs] for m, f, xs in zip(
            ("rel_l2", "worst_row"), BWD_LIMITS["bfloat16"], BWD_ENCDEC_SDPA_F32[key])}
        good32 = all(x <= y for m in lim32 for x, y in zip(w32[m], lim32[m]))
        ok &= good and good32
        worst["f32_limits"] = lim32
        out["%s_sq%d_sk%d" % key] = worst

        def three(xs):
            return " / ".join("%.3e" % x for x in xs)

        print(f"  step 0, the first flash backward launch at {key}, dq / dk / dv against the "
              f"bf16 rounding points: rel_l2 {three(w['rel_l2'])}, worst_row "
              f"{three(w['worst_row'])} (limits {BWD_BF16_POINTS_LIMITS})  "
              f"{'ok' if good else 'FAIL'}; against the f32 plain backward: rel_l2 "
              f"{three(w32['rel_l2'])} (limits {three(lim32['rel_l2'])}), worst_row "
              f"{three(w32['worst_row'])} (limits {three(lim32['worst_row'])})  "
              f"{'ok' if good32 else 'FAIL'}; SDPA's backward in this run against it "
              f"(printed only): rel_l2 {three(sd['rel_l2'])}, worst_row "
              f"{three(sd['worst_row'])}")
        del lse
    first.clear()
    gc.collect()
    torch.cuda.empty_cache()
    check(ok, f"the step-0 flash backward gate failed (shapes {sorted(out)})")
    return out


def full_moments(torch, state, m, zero, metas):
    """Every leaf's Adam first moment, whole, f32, on the host: ZeRO-3's
    rebuilt from its "data" shards (``unshard_params``), ZeRO-1's per-leaf
    flat shards joined in DP order.  After step 0 it is (1 - beta1) times
    the clipped gradient the optimizer took."""
    from repro_torch.convert import unshard_params
    from repro_torch.core.tree import leaves as tree_leaves
    if zero == 3:
        full = unshard_params([state[r]["opt"]["m"] for r in m.group(0, "data")], metas)
        return [t.to("cpu") for t in tree_leaves(full)]
    shards = [tree_leaves(state[r]["opt"]["m"]) for r in m.group(0, ("pod", "data"))]
    return [torch.cat(parts)[:math.prod(meta.shape)].reshape(meta.shape).to("cpu")
            for parts, meta in zip(zip(*shards), tree_leaves(metas))]


def zero_stage_compare(torch, a3, a1, m3, m1, lr):
    """ZeRO-3's step 0 against ZeRO-1's, leaf by leaf on the card, from the
    parameters after it (``a3``, ``a1``, bf16) and the first moments
    (``m3``, ``m1``, ``full_moments``): the parameters' relative L2 per
    leaf and over the tree; the clipped gradients' relative L2; the
    elements whose gradient sign differs (flipped); and two predictions of
    the parameters' relative L2: lr ||u3 - u1|| / ||w||, Adam's first
    updates u = g / (|g| + eps) taken from the gradients (the f32 masters'
    difference), and 2 lr sqrt(flipped share) / rms(w), every flip a full
    +-lr step each way."""
    from repro_torch.configs.base import RunConfig
    rc = RunConfig()
    rel, flips, sizes = [], [], []
    sums = dict.fromkeys(("d2", "q2", "gd2", "gq2", "ud2", "uf2"), 0.0)
    for x3, x1, g3, g1 in zip(a3, a1, m3, m1):
        x3, x1 = x3.cuda().float(), x1.cuda().float()
        g3, g1 = g3.cuda() / (1 - rc.beta1), g1.cuda() / (1 - rc.beta1)
        flip = torch.sign(g3) != torch.sign(g1)
        du = g3 / (g3.abs() + rc.eps) - g1 / (g1.abs() + rc.eps)
        d2, q2 = (x3 - x1).square().sum().item(), x1.square().sum().item()
        for k, v in (("d2", d2), ("q2", q2), ("gd2", (g3 - g1).square().sum().item()),
                     ("gq2", g1.square().sum().item()), ("ud2", du.square().sum().item()),
                     ("uf2", du[flip].square().sum().item())):
            sums[k] += v
        rel.append((d2 / q2) ** 0.5 if q2 else (0.0 if d2 == 0 else math.inf))
        flips.append(int(flip.sum().item()))
        sizes.append(x1.numel())
    f, q2 = sum(flips), sums["q2"]
    return {"rel": rel, "flips": flips, "sizes": sizes,
            "tree_rel": (sums["d2"] / q2) ** 0.5, "grad_rel": (sums["gd2"] / sums["gq2"]) ** 0.5,
            "tree_flips": f, "tree_share": f / sum(sizes),
            "pred_update": lr * (sums["ud2"] / q2) ** 0.5,
            "flip_part": sums["uf2"] / sums["ud2"] if sums["ud2"] else 0.0,
            "pred_sign": 2 * lr * (f / q2) ** 0.5}


@contextlib.contextmanager
def dropped_rank_gradient(collectives, mesh_mod, rank):
    """ZeRO-3's fsdp adjoint with ``rank``'s gradient zeroed before its
    reduce-scatter: the sharded leaves' gradients lose that rank's data."""
    real = collectives.fsdp_reduce_scatter

    def faulty(g, *a, **kw):
        return real(g.new_zeros(g.shape) if mesh_mod.current()[1] == rank else g, *a, **kw)

    with patched(collectives, "fsdp_reduce_scatter", faulty):
        yield


def phase_encdec_train(torch, np, fa, ref, build, mesh_mod, hetccl, counters, cfg):
    """whisper-medium whole, trained on four ranks (the notes of
    ENCDEC_TRAIN_CLIPS): the step-0 gate (``encdec_grad_gate``), then
    ENCDEC_TRAIN_STEPS ZeRO-3 and ZeRO-1 steps from one init and the same
    batches, the counts set to 0 just before each run and read just after:
    per layer, micro-step and rank 2 flash forward launches and 1 backward
    at each of the three shapes (the encoder's (bidir, 1500, 1500), the
    decoder's (causal, 448, 448), the cross-attention's (bidir, 448,
    1500)); the fused rings (``ring_expectations``), the fsdp adjoint's
    reduce-scatters against the gather plan (``zero3_gathers``); finite
    losses; ZeRO-3 against ZeRO-1: [22]'s limits on the losses and step 0's
    gradient norm, the parameters after step 0 within
    ENCDEC_ZERO_PARAM_REL_L2 over the tree and ENCDEC_ZERO_LEAF_REL_L2 per
    leaf, explained by the update signs flipped (``zero_stage_flips``), and
    a control step that lost a rank's gradient beyond those limits
    (``dropped_rank_gradient``); step 0's wall, tokens/s at step 0, busy
    share, peak memory."""
    from repro_torch.core import balance, collectives
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ring_dma
    from repro_torch.models.common import fsdp_dims, make_rules
    model, params, _ = served_model(torch, build, cfg)
    m = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    plan = balance.uniform_plan(2, 4, micro_batch=ENCDEC_TRAIN_CLIPS)
    Le, Ld, F, S = cfg.n_enc_layers, cfg.n_layers, cfg.n_frames, ENCDEC_TRAIN_SEQ
    rows = plan.micro_batch * m.size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batches = []
    for s in range(ENCDEC_TRAIN_STEPS):
        b = synthetic_batch(SEED, s, plan.n_micro_max, rows, S, cfg.vocab)
        b["frames"] = torch.randn((plan.n_micro_max, rows, F, cfg.d_model), generator=gen,
                                  device="cuda").to(getattr(torch, cfg.dtype))
        batches.append(b)
    metas = model.abstract_params()
    dims = fsdp_dims(metas, make_rules(3, m.shape["data"]))
    gathers = zero3_gathers(metas, m.shape["data"])
    names = leaf_names(metas)
    shapes = {("bidir", F, F): Le, ("causal", S, S): Ld, ("bidir", S, F): Ld}
    print(f"  {cfg.name}: {Le} + {Ld} layers, {model.n_params() / 1e9:.3f}B params, bf16 "
          f"params, f32 master state; mesh {m.shape}, {plan.n_micro_max} micro-steps of "
          f"{plan.micro_batch} clips ({F} frames, {S} decoder tokens) a rank, "
          f"{rows * plan.n_micro_max} clips a step; remat on; hier, pallas, no codec; ZeRO-3 "
          f"shards {sum(d is not None for d in dims)} of {len(dims)} leaves over data, "
          f"{gathers} gathered keys a micro-step")
    mb = {k: torch.as_tensor(batches[0][k][0, :plan.micro_batch]).to("cuda", torch.long)
          for k in ("tokens", "labels")}
    mb["frames"] = batches[0]["frames"][0, :plan.micro_batch]
    gate = encdec_grad_gate(torch, fa, ref, model, params, mb, shapes)
    del mb
    n_leaves = len(tree_leaves(params))
    init = [params]
    del params
    runs, after_step0, moments = {}, {}, {3: [], 1: [], "control": []}
    for zero in (3, 1):
        runs[zero], after_step0[zero] = train_stage_run(
            torch, np, hetccl, collectives, ring_dma, counters, model, m, plan, batches, zero,
            init, profile="last" if zero == 1 else None, moments=moments[zero])
        runs[zero].pop("kernel_us")
        print_stage(f"ZeRO-{zero}", runs[zero])
        if zero == 3:                  # the control, while ZeRO-3 still holds the init
            with dropped_rank_gradient(collectives, mesh_mod, ENCDEC_CONTROL_RANK):
                control, after_step0["control"] = train_stage_run(
                    torch, np, hetccl, collectives, ring_dma, counters, model, m, plan,
                    batches[:1], 3, init, profile=None, moments=moments["control"])
    per = plan.n_micro_max * m.size * ENCDEC_TRAIN_STEPS
    ok_counts = True
    for zero in (3, 1):
        r = runs[zero]
        n_adjoint = gathers * plan.n_micro_max * ENCDEC_TRAIN_STEPS if zero == 3 else 0
        expect = flash_by_shape(r["launches"], shapes, 2 * per, per)
        expect.update({k: (r["launches"][k], n) for k, n in ring_expectations(
            zero, n_adjoint, n_leaves, r["n_buckets"], ENCDEC_TRAIN_STEPS).items()})
        expect["adjoint_rs"] = (r["adjoint_rs_launches"], n_adjoint)
        for key, (n, want) in expect.items():
            print(f"  ZeRO-{zero} {key}: {n} launches, {want} expected  "
                  f"{'ok' if n == want else 'FAIL'}")
        ok_counts &= all(n == want for n, want in expect.values())
        r["expected_launches"] = {k: w for k, (_, w) in expect.items()}
        r["launches_by_shape"] = {k: n for k, (n, _) in expect.items() if k.startswith("flash")}
        check(all(np.isfinite(r["losses"])), f"{cfg.name} ZeRO-{zero}: non-finite loss")
    r3, r1 = runs[3], runs[1]
    loss_gap = max(abs(a - b) for a, b in zip(r3["losses"], r1["losses"]))
    norm_gap = abs(r3["grad_norms"][0] - r1["grad_norms"][0]) / r1["grad_norms"][0]
    st, ct = (zero_stage_compare(torch, after_step0[k], after_step0[1], moments[k], moments[1],
                                 FAMILY_TRAIN_LR) for k in (3, "control"))
    after_step0.clear()
    moments.clear()
    rel, param_gap = st["rel"], st["tree_rel"]
    worst = max(range(len(rel)), key=rel.__getitem__)
    ratio = param_gap / st["pred_update"] if st["pred_update"] else math.inf
    lo, hi = ENCDEC_ZERO_PRED_RATIO
    stage_ok = (st["grad_rel"] <= ENCDEC_ZERO_GRAD_REL_L2
                and st["tree_share"] <= ENCDEC_ZERO_FLIP_SHARE and lo <= ratio <= hi)
    control_seen = (ct["grad_rel"] > ENCDEC_ZERO_GRAD_REL_L2
                    and ct["tree_share"] > ENCDEC_ZERO_FLIP_SHARE
                    and ct["tree_rel"] > ENCDEC_ZERO_PARAM_REL_L2)
    print(f"  ZeRO-3 vs ZeRO-1: step 0's wall (warm-up included) {r3['step_ms'][0]:.1f} / "
          f"{r1['step_ms'][0]:.1f} ms, ZeRO-3's step 1 {r3['step_ms'][1]:.1f} ms (ZeRO-1's runs "
          f"under the profiler: busy {r1['device_busy_one_more_step']}), tokens/s at ZeRO-3's "
          f"step 1 / ZeRO-1's step 0 {r3['tokens_per_s']:.1f} / {r1['tokens_per_s']:.1f}, peak "
          f"{r3['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB (state {18 * model.n_params() / 1e9:.1f}"
          f" / {36 * model.n_params() / 1e9:.1f} GB at 18 / 36 bytes a parameter)")
    print(f"  step losses, largest difference {loss_gap:.3e} (limit {ZERO_LOSS_ATOL})  "
          f"{'ok' if loss_gap <= ZERO_LOSS_ATOL else 'FAIL'}; step-0 gradient norm relative "
          f"difference {norm_gap:.3e} (limit {ZERO_GRAD_NORM_RTOL})  "
          f"{'ok' if norm_gap <= ZERO_GRAD_NORM_RTOL else 'FAIL'}")
    print(f"  parameters after step 0, relative L2 {param_gap:.3e} (limit "
          f"{ENCDEC_ZERO_PARAM_REL_L2:.1e})  "
          f"{'ok' if param_gap <= ENCDEC_ZERO_PARAM_REL_L2 else 'FAIL'}; worst leaf {names[worst]} "
          f"{rel[worst]:.3e} (limit {ENCDEC_ZERO_LEAF_REL_L2})  "
          f"{'ok' if rel[worst] <= ENCDEC_ZERO_LEAF_REL_L2 else 'FAIL'}")
    print(f"  step 0's clipped gradients, relative L2 {st['grad_rel']:.3e} (limit "
          f"{ENCDEC_ZERO_GRAD_REL_L2:.1e}); their signs differ at {st['tree_flips']} of "
          f"{sum(st['sizes'])} elements, share {st['tree_share']:.3e} (limit "
          f"{ENCDEC_ZERO_FLIP_SHARE:.1e}); predicted parameters' relative L2 from Adam's "
          f"updates lr ||u3 - u1|| / ||w|| {st['pred_update']:.3e} ({st['flip_part']:.3f} of its "
          f"square on the flipped elements), reading / prediction {ratio:.3f} (limits "
          f"{ENCDEC_ZERO_PRED_RATIO}); from the flips alone 2 lr sqrt(share) / rms(w) "
          f"{st['pred_sign']:.3e} (reading / it {param_gap / st['pred_sign']:.3f})  "
          f"{'ok' if stage_ok else 'FAIL'}")
    for i in sorted(range(len(rel)), key=rel.__getitem__)[:-5:-1]:
        print(f"    {names[i]}: {rel[i]:.3e}, {st['flips'][i]} of {st['sizes'][i]} flipped")
    print(f"  control (ZeRO-3's step 0 with rank {ENCDEC_CONTROL_RANK}'s gradient zeroed at the "
          f"fsdp adjoint, against ZeRO-1): loss {control['losses'][0]:.6f}, grad norm "
          f"{control['grad_norms'][0]:.6f}; gradients {ct['grad_rel']:.3e}, flipped share "
          f"{ct['tree_share']:.3e}, parameters {ct['tree_rel']:.3e} (from the updates "
          f"{ct['pred_update']:.3e}); above all three limits  {'ok' if control_seen else 'FAIL'}")
    check(ok_counts, f"{cfg.name}: the steps did not launch the kernels they imply")
    check(loss_gap <= ZERO_LOSS_ATOL, f"{cfg.name}: ZeRO-3 and ZeRO-1 step losses disagree")
    check(norm_gap <= ZERO_GRAD_NORM_RTOL,
          f"{cfg.name}: ZeRO-3 and ZeRO-1 step-0 gradient norms disagree")
    check(param_gap <= ENCDEC_ZERO_PARAM_REL_L2 and rel[worst] <= ENCDEC_ZERO_LEAF_REL_L2,
          f"{cfg.name}: ZeRO-3 and ZeRO-1 parameters after step 0 disagree")
    check(stage_ok, f"{cfg.name}: ZeRO-3's step-0 gradients or their updates disagree with "
                    f"ZeRO-1's")
    check(control_seen, f"{cfg.name}: a ZeRO-3 step that lost a rank's gradient passed the "
                        f"stage comparison's limits")
    out = {**r1, "arch": cfg.name, "params": model.n_params(), "step0_gate": gate,
           "zero3": r3, "zero3_vs_zero1": {
               "loss_gap": loss_gap, "grad_norm_gap": norm_gap,
               "param_rel_l2_after_step0": param_gap, "worst_leaf": names[worst],
               "worst_leaf_rel_l2": rel[worst], "gathers_per_micro_step": gathers,
               **{k: st[k] for k in ("grad_rel", "tree_flips", "tree_share", "pred_update",
                                     "flip_part", "pred_sign")},
               "control": {"losses": control["losses"], "grad_norm": control["grad_norms"][0],
                           **{k: ct[k] for k in ("tree_rel", "grad_rel", "tree_share",
                                                 "pred_update", "pred_sign")}}},
           "step0_wall_ms": {"zero3": r3["step_ms"][0], "zero1": r1["step_ms"][0]},
           "clips_per_step": rows * plan.n_micro_max}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# [38] the fused rings across processes: a DistMesh of four processes on the
# one card (ROADMAP A3's peer-memory half; DESIGN_TORCH.md §28)
# ---------------------------------------------------------------------------

# (kind, wire or word size, stripes, direction): every case of (a)
PEER_RING_CASES = [(kind, w, S, d) for kind, ws in (("rs", ("float32", "bfloat16")),
                                                    ("ag", (4, 2)))
                   for w in ws for S in (1, 4) for d in (1, -1)]
PEER_TIMING_REPS = 5
# (b): the kernel's bound on a wait (kSpinTimeoutNs, 2 s) plus a margin for
# the time slices of four processes (a hand-off took up to 27 ms) and the
# host's synchronise
PEER_FAULT_BOUND_S = 3.0
DIST_TIMEOUT_S = 420.0
DIST_COLL_REPS = 1           # (c)'s timed calls after the checked one


def _dist_train_setup(torch, get_config, build, m):
    """[11]'s pallas run (no codec, f32 wire) on mesh ``m``: (cfg, program,
    params from the seed, the memorize batch)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import balance
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.trainer import make_train_program
    cfg = get_config(ARCH)
    model = build(cfg)
    plan = balance.uniform_plan(2, 4, micro_batch=TRAIN_MICRO_BATCH)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED), dtype=torch.bfloat16)
    batch = synthetic_batch(SEED, 0, plan.n_micro_max, plan.micro_batch * m.size, TRAIN_SEQ,
                            cfg.vocab)
    prog = make_train_program(model, m, RunConfig(collective_mode="hier", learning_rate=TRAIN_LR,
                                                  **TRAIN_RUNS["pallas"]), plan)
    return cfg, prog, params, batch


def dist_rank(m, job):
    """One of [38]'s four processes: (a) and (b) on ``m`` (pod=4), then (c),
    (d) and (e) on a (pod=2, data=2) DistMesh of the same processes.
    Returns this rank's readings (gates are judged by the parent)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import hetccl
    from repro_torch.core.mesh import DistMesh
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.kernels import peer, ring_dma
    from repro_torch.models import build
    from repro_torch.train import checkpoint
    me = m.rank
    out = {"rank": me, "local_size": peer.local_ranks(m.device), "cases": {}}
    t_start = time.perf_counter()

    # (a) the rings alone, R 4 on "pod"
    arena = peer.arena_for(m, "pod")
    rings = ring_dma._mesh_rings(m, "pod")
    c, n = job["c"], m.shape["pod"]
    out["ctas"] = arena.ctas
    for i, (kind, w, S, d) in enumerate(PEER_RING_CASES):
        gen = torch.Generator(device="cuda").manual_seed(SEED + i)
        if kind == "rs":
            xs = [torch.randn(n, c, generator=gen, device="cuda") for _ in range(m.size)]
            kw = dict(direction=d, wire_dtype=getattr(torch, w), n_stripes=S)
            got = ring_dma.reduce_scatter_peer(xs[me], arena, **kw)
            want = ring_dma.reduce_scatter_fused_plain(xs, rings, **kw)[me]
        else:
            dt = torch.float32 if w == 4 else torch.bfloat16
            xs = [torch.randn(c, generator=gen, device="cuda").to(dt) for _ in range(m.size)]
            kw = dict(direction=d, n_stripes=S)
            got = ring_dma.all_gather_peer(xs[me], arena, **kw)
            want = ring_dma.all_gather_fused_plain(xs, rings, **kw)[me]
        torch.cuda.synchronize()
        out["cases"][f"{kind} {w} stripes={S} dir={d:+d}"] = {
            "bitwise": same_bits(got, want),
            "max_abs_err": (got.double() - want.double()).abs().max().item()}
        if S == 1 and d == 1 and w in ("float32", 4):
            fn = (lambda: ring_dma.reduce_scatter_peer(xs[me], arena, check=False)) \
                if kind == "rs" else (lambda: ring_dma.all_gather_peer(xs[me], arena, check=False))
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(PEER_TIMING_REPS):
                fn()
            ring_dma.raise_if_peer_failed(arena)       # synchronises
            out[f"{kind}_ms"] = (time.perf_counter() - t) * 1e3 / PEER_TIMING_REPS
        del xs, got, want
    out["a_launches"] = {"ring_reduce_scatter": ring_dma.rs_launches,
                         "ring_all_gather": ring_dma.ag_launches}

    # (b) rank 3 withholds one call (the arena is sized: no call grows it)
    x = torch.ones(n, 4096, device="cuda")
    import torch.distributed as dist
    dist.barrier()
    if me == m.size - 1:
        out["withheld"] = {"outcome": "withheld", "s": 0.0}
    else:
        t = time.perf_counter()
        try:
            ring_dma.reduce_scatter_peer(x, arena)
            out["withheld"] = {"outcome": "no error", "s": time.perf_counter() - t}
        except ring_dma.RingProtocolError as e:
            out["withheld"] = {"outcome": str(e), "s": time.perf_counter() - t}
    dist.barrier()
    peer.close_arenas()       # (a)'s arena carries the fault; (c) on new ones
    out["ab_s"] = time.perf_counter() - t_start

    # (c) HetCCL's collective on (pod=2, data=2)
    m2 = DistMesh({"pod": 2, "data": 2}, device="cuda")
    try:
        t = time.perf_counter()
        model = build(get_config(COLL_ARCH))
        from repro_torch.models.common import tree_map_meta
        shapes = tree_map_meta(lambda mm: tuple(mm.shape), model.abstract_params())
        grads = rank_grads(torch, shapes, m2.rank)
        cfg = hetccl.HetCCLConfig(mode="hier", backend="pallas")
        ring_dma.rs_launches = ring_dma.ag_launches = 0
        got = m2.run(lambda g: hetccl.tree_all_reduce(g, cfg), grads)
        torch.cuda.synchronize()
        out["c_launches"] = {"ring_reduce_scatter": ring_dma.rs_launches,
                             "ring_all_gather": ring_dma.ag_launches}
        want = torch.load(job["coll_want"], weights_only=True)
        got_leaves = _leaves(got)
        out["c_bitwise"] = len(got_leaves) == len(want) and all(
            same_bits(a, b) for a, b in zip(got_leaves, want))
        del got, got_leaves, want
        ms = []
        for _ in range(DIST_COLL_REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m2.run(lambda g: hetccl.tree_all_reduce(g, cfg), grads)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        out["c_ms"] = ms
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        out["c_s"] = time.perf_counter() - t

        # (d) 2 ZeRO-1 steps, (e) a checkpoint after step 1
        t = time.perf_counter()
        _, prog, params, batch = _dist_train_setup(torch, get_config, build, m2)
        state = prog.init_fn(params)
        del params
        torch.cuda.reset_peak_memory_stats()
        ring_dma.rs_launches = ring_dma.ag_launches = 0
        losses, step_ms = [], []
        for step in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, met = prog.step_fn(state, batch)
            losses.append(met["loss"].item())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            if step == 0:
                launches0 = {"ring_reduce_scatter": ring_dma.rs_launches,
                             "ring_all_gather": ring_dma.ag_launches}
                t1 = time.perf_counter()
                checkpoint.save(job["ckpt_dir"], 1, state, layout=prog)
                out["e_save_s"] = time.perf_counter() - t1
                ring_dma.rs_launches = ring_dma.ag_launches = 0
        out["d_launches"] = {k: v + launches0[k] for k, v in {
            "ring_reduce_scatter": ring_dma.rs_launches,
            "ring_all_gather": ring_dma.ag_launches}.items()}
        out["d_losses"], out["d_step_ms"] = losses, step_ms
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        want = torch.load(job["train_want"], weights_only=True)
        params = tree_leaves(state["params"])
        out["d_bitwise"] = len(params) == len(want) and all(
            same_bits(a, b) for a, b in zip(params, want))
        if me == 0:
            torch.save([p.cpu() for p in params], job["dist_params"])
        out["d_s"] = time.perf_counter() - t
    finally:
        peer.close_arenas()
    out["reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    return out


def phase_dist(torch, get_config, build, mesh_mod, ring_dma, root, c, coll_tree,
               coll_launches, train_ref):
    """[38] from this process: the one-launch route's ms at (a)'s shape, then
    the spawn, then the gates.  ``coll_tree``: [7]'s hier/pallas result on
    its ThreadMesh (every rank's alike; host copies of its leaves);
    ``coll_launches``: that run's ring launches (one launch over all ranks
    each); ``train_ref``: [11]'s pallas run on its ThreadMesh (the same two steps
    from the same init on the same batch): its losses and rank 0's
    parameters."""
    from repro_torch.core.tree import leaves as tree_leaves
    from repro_torch.launch.mesh import spawn_dist_mesh
    from repro_torch.train import checkpoint
    work = root / "build" / "dist38"
    if work.exists():
        import shutil
        shutil.rmtree(work)
    work.mkdir(parents=True)
    job = {"c": c, "coll_want": str(work / "coll_want.pt"),
           "train_want": str(work / "train_want.pt"), "ckpt_dir": str(work / "ckpt"),
           "dist_params": str(work / "dist_params.pt")}
    torch.save(coll_tree, job["coll_want"])
    torch.save(train_ref["params"], job["train_want"])
    thread_launches = {k: coll_launches[k] for k in ("ring_reduce_scatter", "ring_all_gather")}
    thread_losses = train_ref["losses"]
    out = {}

    def one_launch_ms():
        """The one-launch route at (a)'s shape (R 4, one ring), this process
        alone on the card."""
        R, n = 4, 4
        rings = [list(range(R))]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        xs = [torch.randn(n, c, generator=gen, device="cuda") for _ in range(R)]
        ag_in = [torch.randn(c, generator=gen, device="cuda") for _ in range(R)]
        got = {"rs": median_ms(lambda: ring_dma.reduce_scatter_fused(xs, rings, check=False)),
               "ag": median_ms(lambda: ring_dma.all_gather_fused(ag_in, rings, check=False))}
        ring_dma.check_errors()
        del xs, ag_in
        gc.collect()
        torch.cuda.empty_cache()
        return got

    out["one_launch_ms"] = one_launch_ms()
    t = time.perf_counter()
    res = spawn_dist_mesh(dist_rank, {"pod": 4}, args=(job,), device="cuda",
                          timeout=DIST_TIMEOUT_S, workdir=str(work / "ranks"))
    out["spawn_s"] = time.perf_counter() - t
    out["one_launch_after_ms"] = one_launch_ms()      # read again, the processes gone

    # (a)
    failed = [f"rank {r['rank']}: {name}" for r in res for name, v in r["cases"].items()
              if not v["bitwise"]]
    for name in res[0]["cases"]:
        worst = max(r["cases"][name]["max_abs_err"] for r in res)
        ok = all(r["cases"][name]["bitwise"] for r in res)
        print(f"  (a) {name:28s} n=4 c={c} four processes: bit for bit {ok}, max_abs_err "
              f"{worst:.3e}  {'ok' if ok else 'FAIL'}")
    check(not failed, f"per-rank ring kernels disagree with their plain versions: {failed}")
    for kind in ("rs", "ag"):
        ms = [r[f"{kind}_ms"] for r in res]
        print(f"  (a) {kind} f32 n=4 c={c}: {statistics.median(ms):.3f} ms a call (ranks "
              f"{', '.join(f'{v:.3f}' for v in ms)}), one-launch route "
              f"{out['one_launch_ms'][kind]:.4f} ms at the same shape (read again after the "
              f"spawn: {out['one_launch_after_ms'][kind]:.4f} ms): four processes sharing "
              "one card: the protocol, not a link")
    out["a"] = {"ms": {k: [r[f"{k}_ms"] for r in res] for k in ("rs", "ag")},
                "cases": len(PEER_RING_CASES), "ctas": res[0]["ctas"],
                "local_size": res[0]["local_size"],
                "launches": [r["a_launches"] for r in res]}
    check(all(r["local_size"] == 4 for r in res), "the processes do not see four ranks on "
          "the card")
    # (b)
    for r in res:
        w = r["withheld"]
        print(f"  (b) rank {r['rank']}: {w['outcome']} ({w['s']:.3f} s)")
    raised = [r["withheld"] for r in res[:-1]]
    ok = (res[-1]["withheld"]["outcome"] == "withheld"
          and all(w["outcome"] != "no error" and "per-rank ring" in w["outcome"]
                  and w["s"] <= PEER_FAULT_BOUND_S for w in raised))
    print(f"  (b) ranks 0-2 raised within {PEER_FAULT_BOUND_S} s and no process hung: {ok}  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the withheld call did not make the other ranks raise within the bound")
    out["b"] = {"s": [w["s"] for w in raised], "outcomes": [w["outcome"] for w in raised]}
    # (c): [7]'s one launch over all ranks of each kernel per bucket
    want_l = thread_launches
    ok = all(r["c_bitwise"] for r in res) and all(r["c_launches"] == want_l for r in res)
    print(f"  (c) hier/pallas tree_all_reduce on a (pod=2, data=2) DistMesh: bit for bit "
          f"against [7]'s ThreadMesh {all(r['c_bitwise'] for r in res)}; launches per process "
          f"{[r['c_launches'] for r in res]} (the ThreadMesh's one launch over all ranks: "
          f"{want_l}); ms a call {[['%.1f' % x for x in r['c_ms']] for r in res]} (time-sliced "
          f"processes)  {'ok' if ok else 'FAIL'}")
    check(ok, "the DistMesh tree_all_reduce differs from [7]'s or launched otherwise")
    out["c"] = {"ms": [r["c_ms"] for r in res], "launches": [r["c_launches"] for r in res]}
    # (d)
    losses = [r["d_losses"] for r in res]
    ok = all(r["d_bitwise"] for r in res) and all(lo == thread_losses for lo in losses)
    print(f"  (d) 2 ZeRO-1 steps of {ARCH} on the DistMesh: losses {losses[0]} (ThreadMesh "
          f"{thread_losses}), parameters bit for bit {[r['d_bitwise'] for r in res]}; "
          f"launches per process {[r['d_launches'] for r in res]}; ms a step "
          f"{[['%.1f' % x for x in r['d_step_ms']] for r in res]} (time-sliced processes); "
          f"peak {max(r['peak_gib'] for r in res):.2f} GiB allocated, "
          f"{max(r['reserved_gib'] for r in res):.2f} GiB reserved per process  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the DistMesh training steps differ from the ThreadMesh's")
    check(all(r["d_launches"]["ring_reduce_scatter"] > 0
              and r["d_launches"]["ring_all_gather"] > 0 for r in res),
          "the DistMesh training step did not launch the per-rank rings")
    out["d"] = {"losses": losses[0], "step_ms": [r["d_step_ms"] for r in res],
                "launches": [r["d_launches"] for r in res],
                "peak_gib": [r["peak_gib"] for r in res],
                "reserved_gib": [r["reserved_gib"] for r in res]}
    # (e)
    m22 = mesh_mod.ThreadMesh({"pod": 2, "data": 2}, device="cuda")
    _, prog, params, batch = _dist_train_setup(torch, get_config, build, m22)
    del params
    step, state = checkpoint.restore_latest(job["ckpt_dir"], layout=prog)
    state, met = prog.step_fn(state, batch)
    theirs = torch.load(job["dist_params"], weights_only=True)
    same = all(len(tree_leaves(s["params"])) == len(theirs) and all(
        same_bits(a, b) for a, b in zip(tree_leaves(s["params"]), theirs))
        for s in state)
    ok = step == 1 and same and met["loss"].item() == losses[0][-1]
    print(f"  (e) the processes' checkpoint at step {step} resumed on a ThreadMesh: step 2 loss "
          f"{met['loss'].item():.6f} (theirs {losses[0][-1]:.6f}), parameters bit for bit "
          f"{same}; save {max(r['e_save_s'] for r in res):.1f} s  {'ok' if ok else 'FAIL'}")
    check(ok, "the ThreadMesh resumed from the DistMesh checkpoint differs")
    out["e"] = {"save_s": [r["e_save_s"] for r in res]}
    out["rank_walls_s"] = {k: [r[k] for r in res] for k in ("ab_s", "c_s", "d_s")}
    print(f"  spawn to results {out['spawn_s']:.1f} s; per process (a)+(b) / (c) / (d)+(e): "
          f"{json.dumps(out['rank_walls_s'])}")
    del state
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


class Counters:
    """The launch counts of every kernel wrapper of the port."""

    def __init__(self, fa, quant, ring_dma, cr, gmm, ssd):
        self.mods = (fa, quant, ring_dma, cr, gmm, ssd)

    def reset(self):
        fa, quant, ring_dma, cr, gmm, ssd = self.mods
        fa.reset_counts()
        quant.quant_launches = quant.dq_launches = 0
        ring_dma.rs_launches = ring_dma.ag_launches = cr.launches = 0
        gmm.reset_counts()
        ssd.reset_counts()

    def read(self):
        fa, quant, ring_dma, cr, gmm, ssd = self.mods
        return {"flash_attention_fwd": fa.launches, "flash_attention_bwd": fa.bwd_launches,
                **{f"flash_attention_fwd_d{d}": fa.d_launches.get(d, 0) for d in fa.HEAD_DIMS},
                **{f"flash_attention_fwd_{kind}_sq{sq}_sk{sk}": n
                   for (kind, sq, sk), n in fa.shape_launches.items()},
                **{f"flash_attention_bwd_{kind}_sq{sq}_sk{sk}": n
                   for (kind, sq, sk), n in fa.bwd_shape_launches.items()},
                "quant_int8": quant.quant_launches, "dq_accum_int8": quant.dq_launches,
                "ring_reduce_scatter": ring_dma.rs_launches,
                "ring_all_gather": ring_dma.ag_launches, "collective_reduce": cr.launches,
                "grouped_matmul": gmm.launches, "ssd_scan": ssd.launches,
                **{f"grouped_matmul_{r}": n for r, n in gmm.route_launches.items()},
                "grouped_matmul_bwd": gmm.bwd_launches,
                **{f"grouped_matmul_bwd_{r}": n for r, n in gmm.bwd_route_launches.items()},
                **{f"ssd_scan_{r}": n for r, n in ssd.route_launches.items()},
                "ssd_scan_bwd": ssd.bwd_launches,
                **{f"ssd_scan_bwd_{r}": n for r, n in ssd.bwd_route_launches.items()},
                **{f"ssd_scan_bwd_{st}": n for st, n in ssd.bwd_stage_launches.items()}}


@contextlib.contextmanager
def phase(label, walls):
    """Prints ``label``, runs the block, prints and records its wall time."""
    print(label)
    t = time.perf_counter()
    try:
        yield
    finally:
        walls[label] = time.perf_counter() - t
        print(f"  ({label.split()[0]} wall time {walls[label]:.1f} s)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import collectives, hetccl, tacc
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels import collective_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ops, quant, ref, ring_dma
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import bench_codec
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import engine

    walls = {}
    with phase("[1] device", walls):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(f"  torch: {name}; torch {torch.__version__}, cuda {torch.version.cuda}")
        print(smi.splitlines()[0])              # nvidia-smi's name, power.limit
    card = {"device": name, "nvidia_smi": smi.splitlines()[0]}

    with phase("[2] build", walls):
        logs = _build.build()
        print(f"  built {', '.join(logs)}")
        for src, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"  {src}: {line.strip()}")

    with phase("[3] kernel vs plain", walls):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}, "
              f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
        cases = phase_kernels(fa, torch)

    with phase("[4] serve", walls):
        serve, launches, measure_busy = phase_serve(torch, np, fa, ops, tacc, get_config,
                                                    build, engine)

    with phase("[5] times", walls):
        main_case = cases["serve_prefill"]
        flash_times = {name: phase_times(fa, torch, cases[FLASH_TIMED[name]])
                       for name in ("smollm", "mixtral_prefill", "mixtral_window", "llama3b")}
        host_us = host_us_per_call(fa, torch, main_case)
        print(f"  flash_attention_fwd host time per call at {FLASH_TIMED['smollm']}: "
              f"{host_us:.1f} us")
        serve.update(measure_busy())
        print(json.dumps({"serve": serve, "flash_times": flash_times,
                          "flash_host_us_per_call": host_us, **card}))

    with phase("[6] ring kernels vs plain", walls):
        n_ring_cases, ring_err = phase_ring_kernels(torch, ring_dma, cr)

    with phase("[7] collectives at full width", walls):
        coll = phase_collectives(torch, hetccl, tacc, mesh_mod, ring_dma, cr, get_config,
                                 build)
        coll_tree = coll.pop("hier_pallas_tree")

    with phase("[8] collective kernel times", walls):
        ctimes = phase_collective_times(torch, ring_dma, cr, bench_codec,
                                        coll["largest_bucket_elems"])
        print(json.dumps({"collectives": coll, "kernel_times": ctimes, **card}))

    # an eighth of the largest bucket: a stream of the quantized cross-pod
    # ring in a hier all_reduce (local shard big/2, pod chunk big/4, a stream
    # big/8), 6912 rows; tree_all_reduce's reduce-scatter runs the ring first,
    # so a training step's streams are a quarter of a bucket
    # (bench_codec.codec_launch_rows lists every shape a step launches)
    hop_rows = -(-coll["largest_bucket_elems"] // 8 // 512)

    with phase("[9] codec kernels vs plain", walls):
        n_quant_cases = phase_quant_kernels(torch, quant, ref, hop_rows,
                                            bench_codec.SHAPES["leaf"])

    with phase("[10] flash backward vs plain", walls):
        bwd = phase_flash_bwd(torch, fa, ref)

    counters = Counters(fa, quant, ring_dma, cr, gmm, ssd)
    with phase("[11] training at full width", walls):
        train = phase_train(torch, np, get_config, build, mesh_mod, hetccl, counters,
                            bench_codec)
        train_ref = train.pop("pallas_final")

    with phase("[12] training kernel times", walls):
        ttimes = phase_codec_times(torch, quant, ref, bench_codec, train["codec_launch_rows"],
                                   4)
        ttimes.update(phase_train_kernel_times(torch, ref, fa, bwd["train"]))
        for label, case in BWD_TIMED.items():
            ttimes[f"flash_attention_bwd_{label}"] = phase_train_kernel_times(
                torch, ref, fa, bwd[case], BWD_TIMED_ROUNDS[label])["flash_attention_bwd"]
        print(json.dumps({"train": train, "flash_bwd_errors": {
            k: {kk: vv for kk, vv in v.items() if kk not in ("inputs", "kw")}
            for k, v in bwd.items()}, "kernel_times": ttimes, **card}))
    for v in bwd.values():                       # the training phases' tensors
        v.pop("inputs")
    gc.collect()
    torch.cuda.empty_cache()

    with phase("[13] grouped matmul vs plain", walls):
        gmm_cases = phase_gmm_kernels(torch, gmm, ref)

    moe = {}
    with phase(f"[14] MoE serve: {MOE_ARCH} at full width, {MOE_LAYERS} layers", walls):
        moe_cfg, moe_model_, moe_params = moe_model(torch, get_config, build)
        print(f"  {moe_cfg.name}: {moe_cfg.n_layers} of 32 layers, d_model {moe_cfg.d_model}, "
              f"{moe_cfg.n_heads}/{moe_cfg.n_kv_heads} heads x {moe_cfg.head_dim_}, "
              f"{moe_cfg.n_experts} experts top-{moe_cfg.top_k} of d_ff {moe_cfg.d_ff_expert}, "
              f"window {moe_cfg.window}, vocab {moe_cfg.vocab}, {moe_cfg.dtype}, "
              f"{moe_model_.n_params() / 1e9:.2f}B params")
        moe["serve"] = phase_moe_serve(
            torch, np, fa, gmm, ref, tacc, moe_mod, attn_mod, engine, build, counters, moe_cfg,
            moe_model_, moe_params, MOE_REQUESTS, MOE_PROMPT, MOE_NEW, window_run=False)

    with phase(f"[15] sliding window at full width: 1 x {WINDOW_PROMPT} + {WINDOW_NEW}", walls):
        moe["window"] = phase_moe_serve(
            torch, np, fa, gmm, ref, tacc, moe_mod, attn_mod, engine, build, counters, moe_cfg,
            moe_model_, moe_params, 1, WINDOW_PROMPT, WINDOW_NEW, window_run=True)
    del moe_params, moe_model_
    gc.collect()
    torch.cuda.empty_cache()

    with phase("[16] MoE kernel times", walls):
        gtimes = phase_moe_kernel_times(torch, gmm, ref)
        print(json.dumps({"moe": moe, "gmm_errors": gmm_cases, "kernel_times": gtimes,
                          "phase_wall_s": walls, **card}))

    with phase("[17] SSD kernel vs plain", walls):
        ssd_cases, flash112 = phase_ssd_kernels(torch, ssd, ref, fa)

    ssm = {}
    for label, arch in (("[18] SSM serve", SSM_ARCH), ("[19] hybrid serve", HYBRID_ARCH)):
        with phase(f"{label}: {arch} at full width and depth", walls):
            cfg, model, params = ssm_model(torch, get_config, build, arch)
            print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner "
                  f"{cfg.d_inner}, {cfg.n_ssm_heads} SSD heads x {cfg.ssm_headdim}, state "
                  f"{cfg.ssm_state}, {cfg.ssm_groups} group, conv {cfg.ssm_conv}, chunk "
                  f"{cfg.ssm_chunk}" + (f", shared attention every {cfg.attn_every} layers "
                                        f"({cfg.n_heads} heads x {cfg.head_dim_}, d_ff "
                                        f"{cfg.d_ff})" if cfg.attn_every else "")
                  + f", vocab {cfg.vocab}, {cfg.dtype}, {model.n_params() / 1e9:.2f}B params")
            ssm[arch] = phase_ssm_serve(torch, np, ssd, tacc, engine, build, counters, cfg,
                                        model, params)
            del params, model
            gc.collect()
            torch.cuda.empty_cache()

    with phase("[20] SSM kernel times", walls):
        stimes = phase_ssm_kernel_times(torch, ssd, ref, fa, flash112["zamba2_d112"])
        print(json.dumps({"ssm": ssm, "ssd_errors": ssd_cases, "flash_d112_errors": {
            k: {kk: vv for kk, vv in v.items() if kk != "inputs"} for k, v in flash112.items()},
            "kernel_times": stimes, "phase_wall_s": walls, **card}))
    flash_times["zamba2"] = stimes["flash_d112"]
    flash112.clear()
    gc.collect()
    torch.cuda.empty_cache()

    dense = {}
    with phase(f"[21] dense serve: {', '.join(DENSE_ARCHS)} at full width and depth", walls):
        for arch in DENSE_ARCHS:
            dense[arch] = phase_dense_serve(torch, np, fa, ops, tacc, engine, build, counters,
                                            get_config(arch))
            gc.collect()
            torch.cuda.empty_cache()

    with phase(f"[22] training {LLAMA_ARCH} at full width: ZeRO-3 and ZeRO-1", walls):
        zero = phase_zero_train(torch, np, get_config, build, mesh_mod, counters)

    with phase(f"[23] training {GPT_ARCH} at full width: ZeRO-1", walls):
        gpt = phase_gpt_train(torch, np, get_config, build, mesh_mod, counters)
        print(json.dumps({"dense_serve": dense, "zero_train": zero, "gpt_train": gpt,
                          "phase_wall_s": walls, **card}))

    with phase("[24] grouped-matmul backward vs plain", walls):
        gmm_bwd = phase_gmm_bwd_kernels(torch, gmm, ref, ops)

    with phase(f"[25] MoE training: {MOE_TRAIN_ARCH} at full width, {MOE_TRAIN_LAYERS} layer, "
               "ZeRO-3 and ZeRO-1 on four ranks", walls):
        moe_train = phase_moe_train(torch, np, get_config, build, mesh_mod, hetccl, gmm, ref,
                                    counters)

    with phase("[26] grouped-matmul backward times", walls):
        btimes = phase_gmm_bwd_times(torch, gmm, ref, bench_codec)
        print(json.dumps({"gmm_bwd_errors": gmm_bwd, "moe_train": moe_train,
                          "kernel_times": {k: {kk: vv for kk, vv in v.items() if kk != "readings"}
                                           for k, v in btimes.items()},
                          "phase_wall_s": walls, **card}))

    with phase("[27] SSD backward vs plain", walls):
        ssd_bwd, flash112_bwd = phase_ssd_bwd_kernels(torch, ssd, fa, ref)

    ssm_train = {}
    for arch, layers in SSM_TRAIN.items():
        with phase(f"[28] SSM training: {arch} at full width, {layers} layers, ZeRO-3 and "
                   "ZeRO-1 on four ranks", walls):
            ssm_train[arch] = phase_ssm_train(torch, np, get_config, build, mesh_mod, hetccl,
                                              tacc, ssd, fa, ref, counters, arch)

    with phase("[29] SSD backward times", walls):
        sbtimes = phase_ssd_bwd_times(torch, ssd, bench_codec)
        case = flash112_bwd["zamba2_train_d112"]
        q, k, v, o, do, lse, kw = case.pop("inputs")
        tb112 = phase_train_kernel_times(torch, ref, fa, {"inputs": (q, k, v, o, do, lse),
                                                          "kw": kw})["flash_attention_bwd"]
        del q, k, v, o, do, lse
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"ssd_bwd_errors": ssd_bwd, "flash_d112_bwd_errors": flash112_bwd,
                          "ssm_train": ssm_train, "kernel_times": {
                              "ssd_scan_bwd": sbtimes,
                              "flash_attention_bwd_d112": {
                                  kk: vv for kk, vv in tb112.items()
                                  if not kk.endswith("readings")}},
                          "phase_wall_s": walls, **card}))

    with phase("[31] planned training: smollm-135m at full width on the planner's tables and "
               "shares, four runs on four ranks", walls):
        planned = phase_planned_train(torch, np, get_config, build, mesh_mod, hetccl, tacc,
                                      collectives, ring_dma, counters)
        print(json.dumps({"planned_train": planned, "phase_wall_s": walls, **card}))

    with phase("[32] checkpoints, telemetry and the roofline: smollm-135m at full width "
               "through the launcher", walls):
        ckpt_obs = phase_ckpt_obs(torch, np, get_config, build, mesh_mod, hetccl, planned, card)
        print(json.dumps({"ckpt_obs": ckpt_obs, "phase_wall_s": walls, **card}))

    with phase("[33] the elastic control plane: smollm-135m at full width through the "
               "launcher, a hang and a pod loss under ZeRO-3, a pod loss under ZeRO-1", walls):
        elastic_out = phase_elastic(torch, np, mesh_mod, hetccl, counters, card)
        print(json.dumps({"elastic": elastic_out, "phase_wall_s": walls, **card}))

    vlm_cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    with phase(f"[34] VLM serve: {VLM_ARCH} at full width, {VLM_LAYERS} of 80 layers", walls):
        print(f"  {vlm_cfg.name}: d_model {vlm_cfg.d_model}, {vlm_cfg.n_heads}/"
              f"{vlm_cfg.n_kv_heads} heads x {vlm_cfg.head_dim_}, d_ff {vlm_cfg.d_ff}, vocab "
              f"{vlm_cfg.vocab}, M-RoPE sections {vlm_cfg.mrope_sections}, theta "
              f"{vlm_cfg.rope_theta:g}, {vlm_cfg.dtype}")
        vlm = phase_vlm_serve(torch, np, fa, ops, tacc, engine, build, counters, vlm_cfg,
                              cases)
        print(json.dumps({"vlm_serve": vlm, "phase_wall_s": walls, **card}))

    encdec_cfg = get_config(ENCDEC_ARCH)
    with phase(f"[35] encoder-decoder serve: {ENCDEC_ARCH} at full width and depth", walls):
        print(f"  {encdec_cfg.name}: {encdec_cfg.n_enc_layers} encoder + {encdec_cfg.n_layers} "
              f"decoder layers, d_model {encdec_cfg.d_model}, {encdec_cfg.n_heads} heads x "
              f"{encdec_cfg.head_dim_}, d_ff {encdec_cfg.d_ff}, {encdec_cfg.n_frames} frames, "
              f"vocab {encdec_cfg.vocab}, {encdec_cfg.dtype}")
        encdec = phase_encdec_serve(torch, np, fa, ops, tacc, engine, build, counters,
                                    encdec_cfg, cases)
        print(json.dumps({"encdec_serve": encdec, "phase_wall_s": walls, **card}))
    flash_times.update(vlm.pop("flash_times"))
    flash_times.update(encdec.pop("flash_times"))
    for c in cases.values():                    # [3]'s inputs: [35] timed the last
        c.pop("inputs")
    gc.collect()
    torch.cuda.empty_cache()
    # [36] holds 56.5 GiB of state and peaks about 17 GiB above it, with
    # head-sized (2.3 GiB) gradients: in segments cut by the earlier phases'
    # allocations it ran out of memory with 5.3 GiB free in pieces (an
    # NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  Expandable segments map what
    # the allocator holds into one range; on for [36] and [37] only, which
    # capture no CUDA graph.
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    print(f"  card memory allocated before [36]: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB (the earlier phases' leftovers)")

    vlm_train_cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_TRAIN_LAYERS,
                                        loss_chunk=TRAIN_LOSS_CHUNK)
    with phase(f"[36] VLM training: {VLM_ARCH} at full width, {VLM_TRAIN_LAYERS} of 80 "
               "layers, ZeRO-1 on one rank", walls):
        vlm_train = phase_vlm_train(torch, np, fa, build, mesh_mod, hetccl, counters,
                                    vlm_train_cfg)
        print(json.dumps({"vlm_train": vlm_train, "phase_wall_s": walls, **card}))

    encdec_train_cfg = dataclasses.replace(encdec_cfg, loss_chunk=TRAIN_LOSS_CHUNK)
    with phase(f"[37] encoder-decoder training: {ENCDEC_ARCH} at full width and depth, ZeRO-3 "
               "and ZeRO-1 on four ranks", walls):
        encdec_train = phase_encdec_train(torch, np, fa, ref, build, mesh_mod, hetccl,
                                          counters, encdec_train_cfg)
        print(json.dumps({"encdec_train": encdec_train, "phase_wall_s": walls, **card}))
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    gc.collect()
    torch.cuda.empty_cache()

    with phase("[38] the fused rings across processes: four processes on the card, a "
               "DistMesh, per-rank launches over CUDA IPC", walls):
        dist_out = phase_dist(torch, get_config, build, mesh_mod, ring_dma, root,
                              coll["largest_bucket_elems"] // 2, coll_tree, coll["launches"],
                              train_ref)
        del coll_tree, train_ref
        print(json.dumps({"dist": dist_out, "phase_wall_s": walls, **card}))

    def planned_launches(key):         # [31]'s runs
        return {run: v["launches"][key] for run, v in planned.items()}

    def elastic_launches_of(key):      # [33]'s runs
        return {run: v["launches"][key] for run, v in elastic_out.items()}

    print("[30] kernels")
    sources = {"collective_reduce": ("collective_reduce.cu",
                                     "src/repro/kernels/collective_reduce.py:84"),
               "ring_reduce_scatter": ("ring_dma.cu", "src/repro/kernels/ring_dma.py:252"),
               "ring_all_gather": ("ring_dma.cu", "src/repro/kernels/ring_dma.py:383")}
    t = flash_times["smollm"]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "rel_l2": main_case["rel_l2"],
        "worst_row_rel_l2": main_case["worst_row_rel_l2"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "check": "pass",
        "cases_checked": len(cases),
        "host_us_per_call": host_us,
    }]
    for kname, (src, replaces) in sources.items():
        t = ctimes[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": coll["launches"][kname], "max_abs_err": ring_err[kname],
            "llama1b_zero3_launches": zero["zero3"]["launches"][kname],
            "ssm_zero3_launches": {a: v["zero3"]["launches"][kname]
                                   for a, v in ssm_train.items()},
            "planned_launches": planned_launches(kname),
            **({"elastic_launches": elastic_launches_of(kname)}
               if kname in ELASTIC_KERNELS else {}),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "check": "pass (bitwise)", "cases_checked": n_ring_cases, "shape": t["shape"],
            **({"dist_launches_per_process": {
                "collective": dist_out["c"]["launches"][0][kname],
                "train": dist_out["d"]["launches"][0][kname]},
                "dist_ms_per_call": dist_out["a"]["ms"]["rs" if "reduce" in kname else "ag"],
                "dist_one_launch_ms": dist_out["one_launch_ms"][
                    "rs" if "reduce" in kname else "ag"],
                "dist_note": "per-rank route, four processes sharing one card (time-sliced): "
                             "the protocol, not a link",
                "dist_cases_checked": dist_out["a"]["cases"]}
               if kname != "collective_reduce" else {})})
    train_launches = train["launches"]["int8_ef"]
    kernels[0]["train_launches"] = train_launches["flash_attention_fwd"]
    kernels[0]["mixtral_launches"] = moe["serve"]["launches"]["flash_attention_fwd"]
    kernels[0]["zamba2_launches"] = ssm[HYBRID_ARCH]["launches"]["flash_attention_fwd"]
    kernels[0]["d112_ms"] = stimes["flash_d112"]["ms"]
    kernels[0]["d112_plain_ms"] = stimes["flash_d112"]["plain_ms"]
    kernels[0]["d112_bound_ms"] = stimes["flash_d112"]["bound_ms"]
    kernels[0]["d112_library_ms"] = stimes["flash_d112"]["library_ms"]
    kernels[0]["dense_launches"] = {a: v["launches"]["flash_attention_fwd"]
                                    for a, v in dense.items()}
    kernels[0]["vlm_launches"] = vlm["launches"]["flash_attention_fwd"]
    kernels[0]["encdec_launches"] = encdec["launches"]["flash_attention_fwd"]
    kernels[0]["vlm_train_launches"] = vlm_train["launches"]["flash_attention_fwd"]
    kernels[0]["encdec_train_launches"] = {
        f"zero{z}": r["launches"]["flash_attention_fwd"]
        for z, r in ((3, encdec_train["zero3"]), (1, encdec_train))}
    kernels[0]["llama1b_zero3_launches"] = zero["zero3"]["launches"]["flash_attention_fwd"]
    kernels[0]["planned_launches"] = planned_launches("flash_attention_fwd")
    kernels[0]["elastic_launches"] = elastic_launches_of("flash_attention_fwd")
    shape_launches = {"smollm": launches,
                      "mixtral_prefill": moe["serve"]["launches"]["flash_attention_fwd"],
                      "mixtral_window": moe["window"]["launches"]["flash_attention_fwd"],
                      "zamba2": ssm[HYBRID_ARCH]["launches"]["flash_attention_fwd"],
                      "llama3b": dense["llama-3b"]["launches"]["flash_attention_fwd_d100"],
                      "qwen2vl": vlm["launches"]["flash_attention_fwd_d128"],
                      # [35]'s three shapes, each counted by (kind, Sq, Sk)
                      **encdec["launches_by_kind"]}
    kernels[0]["shapes"] = {name: {"launches": shape_launches[name], **flash_times[name]}
                            for name in FLASH_TIMED}
    tb = ttimes["flash_attention_bwd"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "note": "backward of the forward kernel; the TPU kernel is forward-only and the "
                "reference differentiates its plain attention",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": bwd["train"]["max_abs_err"], "rel_l2": bwd["train"]["rel_l2"],
        "worst_row": bwd["train"]["worst_row"], "ms": tb["ms"], "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"], "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "graph_ms": tb["graph_ms"], "library_graph_ms": tb["library_graph_ms"],
        "check": "pass", "cases_checked": len(bwd), "shape": tb["shape"],
        "llama1b_zero3_launches": zero["zero3"]["launches"]["flash_attention_bwd"],
        "shapes": {label: {key: tt[key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "graph_ms",
            "library_graph_ms")} for label, tt in (
                *((lb, ttimes[f"flash_attention_bwd_{lb}"]) for lb in BWD_TIMED),
                ("d112", tb112))},
        "vlm_train_launches": vlm_train["launches"]["flash_attention_bwd"],
        "encdec_train_launches": {
            f"zero{z}": r["launches"]["flash_attention_bwd"]
            for z, r in ((3, encdec_train["zero3"]), (1, encdec_train))},
        "sq_ne_sk_cases": {name: {key: bwd[name][key] for key in ("rel_l2", "worst_row")}
                           for name in ("whisper_cross_train", "f32_sq70_sk200_bidir_klen150",
                                        "f32_sq200_sk70_bidir_klen50")},
        "zamba2_train_launches": ssm_train[HYBRID_ARCH]["launches"]["flash_attention_bwd"],
        "planned_launches": planned_launches("flash_attention_bwd"),
        "elastic_launches": elastic_launches_of("flash_attention_bwd"),
        "d112_max_abs_err": flash112_bwd["zamba2_train_d112"]["max_abs_err"],
        "d112_rel_l2": flash112_bwd["zamba2_train_d112"]["rel_l2"]})
    for kname, replaces in (("quant_int8", "src/repro/kernels/quant.py:152"),
                            ("dq_accum_int8", "src/repro/kernels/quant.py:161")):
        t = ttimes[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": "src/repro_torch/kernels/csrc/quant.cu",
            "replaces": replaces, "launches": train_launches[kname], "max_abs_err": 0.0,
            "planned_launches": planned_launches(kname),
            "check": "pass (bitwise)", "cases_checked": n_quant_cases,
            **{key: val for key, val in t.items() if not key.endswith("_readings")}})

    def moe_launches(key):         # [25]'s two stages
        return sum(moe_train[z]["launches"][key] for z in ("zero3", "zero1"))

    tp, td = gtimes["prefill_w13"], gtimes["decode_w13"]
    err = gmm_cases["mixtral_prefill_w13"]
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:25",
        "launches": moe["serve"]["launches"]["grouped_matmul"],
        "max_abs_err": err["max_abs_err"], "rel_l2": err["rel_l2"],
        "worst_row": err["worst_row"], "ms": tp["ms"], "plain_ms": tp["plain_ms"],
        "bound_ms": tp["bound_ms"], "bound_by": tp["bound_by"], "library_ms": tp["library_ms"],
        "shape": tp["shape"], "decode_ms": td["ms"], "decode_plain_ms": td["plain_ms"],
        "decode_bound_ms": td["bound_ms"], "decode_bound_by": td["bound_by"],
        "decode_library_ms": td["library_ms"], "decode_shape": td["shape"],
        "decode_graph_ms": td["graph_ms"], "decode_library_graph_ms": td["library_graph_ms"],
        "decode_w2_ms": gtimes["decode_w2"]["ms"],
        "decode_w2_graph_ms": gtimes["decode_w2"]["graph_ms"],
        "decode_w2_library_graph_ms": gtimes["decode_w2"]["library_graph_ms"],
        "decode_w2_library_ms": gtimes["decode_w2"]["library_ms"],
        "decode_w2_bound_ms": gtimes["decode_w2"]["bound_ms"],
        "window_launches": moe["window"]["launches"]["grouped_matmul"],
        "routes": {r: moe["serve"]["launches"][f"grouped_matmul_{r}"] for r in gmm.ROUTES},
        "prefill_w2_ms": gtimes["prefill_w2"]["ms"],
        "prefill_w2_library_ms": gtimes["prefill_w2"]["library_ms"],
        "moonshot_train_launches": moe_launches("grouped_matmul"),
        "check": "pass", "cases_checked": len(gmm_cases)})
    for which in ("dx", "dw"):
        t = btimes[f"mixtral_w13_{which}"]
        err = gmm_bwd["cases"]["mixtral_w13_c1280"][which]
        kernels.append({
            "name": f"grouped_matmul_bwd_{which}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:25",
            "note": "backward of the forward kernel (dx = dy w^T, dw = x^T dy); the TPU kernel "
                    "is forward-only and the reference differentiates its einsums",
            "launches": moe_launches(f"grouped_matmul_bwd_{which}_wgmma")
            + moe_launches(f"grouped_matmul_bwd_{which}_simt"),
            "routes": {r: moe_launches(f"grouped_matmul_bwd_{r}")
                       for r in gmm.BWD_ROUTES if r.startswith(which)},
            "max_abs_err": err["max_abs_err"], "rel_l2": err["rel_l2"],
            "worst_row": err["worst_row"], "ms": t["ms"], "graph_ms": t["graph_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library_graph_ms": t["library_graph_ms"],
            "shape": t["shape"],
            "schedule": t["schedule"],
            "shapes": {label: {key: btimes[f"{label}_{which}"][key] for key in (
                "shape", "route", "schedule", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_graph_ms")} for label in GMM_BWD_TIMED},
            "check": "pass", "cases_checked": len(gmm_bwd["cases"])})
    tm, tz = stimes["mamba2_prefill"], stimes["zamba2_prefill"]
    err = ssd_cases["mamba2_prefill"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:29",
        "launches": ssm[SSM_ARCH]["launches"]["ssd_scan"],
        "max_abs_err": err["y"]["max_abs_err"], "rel_l2": err["y"]["rel_l2"],
        "worst_row": err["y"]["worst_row"], "state_rel_l2": err["state"]["rel_l2"],
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "f32_fma_bound_ms": tm["f32_fma_bound_ms"],
        "library_ms": None, "shape": tm["shape"], "zamba2_ms": tz["ms"],
        "zamba2_plain_ms": tz["plain_ms"], "zamba2_bound_ms": tz["bound_ms"],
        "zamba2_bound_by": tz["bound_by"], "zamba2_shape": tz["shape"],
        "zamba2_launches": ssm[HYBRID_ARCH]["launches"]["ssd_scan"],
        "routes": {r: ssm[SSM_ARCH]["launches"][f"ssd_scan_{r}"] for r in ssd.ROUTES},
        "smem_bytes": tm["smem_bytes"], "blocks_per_sm": tm["blocks_per_sm"],
        "train_launches": {a: v["launches"]["ssd_scan"] for a, v in ssm_train.items()},
        "zero3_train_launches": {a: v["zero3"]["launches"]["ssd_scan"]
                                 for a, v in ssm_train.items()},
        "check": "pass", "cases_checked": len(ssd_cases)})
    t, tz = sbtimes["mamba2_train"], sbtimes["zamba2_train"]
    err = ssd_bwd["mamba2_train"]
    grads = [e for e in err.values() if isinstance(e, dict)]
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:29",
        "note": "backward of the SSD kernel (dx, ddt, da, dB, dC, d init): the state scan, the "
                "chunks' gradients, the head sum, bf16 on tensor cores (mma), f32 on the CUDA "
                "cores; the TPU kernel is forward-only and the reference differentiates its jnp "
                "scan",
        "launches": sum(v["launches"]["ssd_scan_bwd"] for v in ssm_train.values()),
        "launches_by_arch": {a: v["launches"]["ssd_scan_bwd"] for a, v in ssm_train.items()},
        "zero3_launches_by_arch": {a: v["zero3"]["launches"]["ssd_scan_bwd"]
                                   for a, v in ssm_train.items()},
        "max_abs_err": max(e["max_abs_err"] for e in grads),
        "rel_l2": max(e["rel_l2"] for e in grads),
        "worst_row": max(e["worst_row"] for e in grads),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
        "timed_route": t["route"],
        "routes": {r: sum(v["launches"][f"ssd_scan_bwd_{r}"] for v in ssm_train.values())
                   for r in ssd.ROUTES},
        "stages": {k: {"ms": t[f"{k}_graph_ms"], "back_to_back_ms": t[f"{k}_ms"],
                       "launch_bound_ms": t[f"{k}_launch_bound_ms"],
                       "launch_bound_by": t[f"{k}_launch_bound_by"]}
                   for k in t["launches"]},
        "launches_bound_ms": t["launches_bound_ms"],
        "zamba2": {key: tz[key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                            *(f"{k}_graph_ms" for k in tz["launches"]))},
        "check": "pass (bit-equal on repeat)", "cases_checked": len(ssd_bwd)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
