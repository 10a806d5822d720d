#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``.  It exits non-zero without a card, outside a
checkout of this repository, or when any phase fails; nothing is caught.

Phases (run in the order 1, 2, 9, 16, 17, 18, 19, 3–5, 8, 10–15, 6, 7:
phases 9, 16, 17, 18 and 19 first, while nothing else holds device
memory, because their tables, train states, KV caches and gathered
messages take 65, 52, 51.5, ~57 and ~30 GB; phases 17, 18 and 19 drive
no kernel of ours; phase 19 holds a 1×1 NCCL grid of its own, closed
before phase 5 opens the next; phases 8 and 10–15 share
phase 5's NCCL process group, and phase 7's kernel table carries phase
8's, 10's, 12's and 14's launches, K7's times, which phase 9 takes on
its tables, phase 16's train launches of K7, the acc-mode chains
that phase 12 (b) times, and the arc product's rows, which phase 15
times; a kernel's launches count its plain and its acc mode):
  1. environment: card name and power limit, torch/CUDA versions, TF32 off;
  2. build K1–K7 from kernels/csrc with nvcc, one process per source
     (ptxas report, build seconds);
  3. kernel parity on the card against the plain PyTorch versions: K7 at
     the JAX test grid (V, D, B, L) and a ragged D, f32 and bf16 tables,
     with and without weights, a bag of nothing but padding (rtol 1e-6 /
     atol 1e-6 f32, rtol 2e-2 bf16); with f32 and bf16 adjacency, K1/K2
     at the unit-test shapes and the main-path shapes (depth exact, σ
     rtol 1e-6, δ rtol 1e-5 / atol 1e-6); K3/K4 in
     plain and acc mode at ragged rectangular shapes, at the 1×1 grid's
     [65536, 65536] block and at the [32768, 16384] block of a 2×4 grid
     (K3's integer-valued partial exact, K4 rtol 1e-5 / atol 1e-6); K1
     and K3 (plain and acc) at the main loop's edges, kdim 33 / 130 / 260
     / 4096 by s 64 / 128 / 192 / 130 / 257 / 129 / 193 (the last two the
     ABFT lane's widths), A aligned and at an offset
     (16-byte copies and element loads), σ, depth and t exact, two
     launches bitwise equal; K5/K6
     in plain and acc mode on random tile lists (bm, bk in {5, 8, 32,
     128}, bm != bk, ragged s, fillers, empty tile-rows, trailing pad
     tiles), on a skewed list with one row of 20 480 nonzeros over 160
     tiles (cut into segments) and on the real 1×1 cell layouts of phase
     8 (R-MAT scale 16 at tiles 128 and 32, the strip graph at tile 128):
     K5 exact, K6 rtol 1e-5 / atol 1e-6; the random lists again with
     signed normal tile values (both within 1e-5 of Σ|a·x|, the scale of
     a sum's rounding error, which cancellation does not shrink); for every case
     the nonzero index holds as many entries as the tiles have nonzero
     entries, and two launches give bitwise-equal outputs;
  4. the main path at full width through ``betweenness_centrality``:
     rmat_graph(16, 16, seed=1) (n = 65536, the paper's edge factor),
     batch 128, h0, sampling="fixed" with 512 roots (4 rounds), on the
     fused_bf16, fused and dense engines; the fused runs must launch
     K1 and K2 and match dense to rtol 1e-5 / atol 1e-5; then one more
     fused_bf16 run under torch.profiler for device time per kernel
     (K1, K2 and their operand passes);
  5. the 2-D decomposed path at full width through
     ``distributed_betweenness_centrality`` on a 1×1 grid (one NCCL rank:
     one card holds no larger grid), same graph and roots, engines
     fused_bf16, fused and sparse; the fused runs must launch K3 and K4
     and not K1/K2, and every run must match the single-device dense BC
     to rtol 1e-5 / atol 1e-5; then the fused run once under
     torch.profiler (device busy share; K3, K4, their operand passes and
     NCCL shares);
  6. exact BC against the port's numpy oracle (rmat 10, road 20x20; h0
     and h3t; rtol 1e-5 / atol 1e-5) and h3 on rmat 13 against dense;
  7. kernel times with CUDA events at the main-path shapes (K3/K4 also at
     the 2×4 block, K5/K6 at phase 8's three layouts, K7 at the
     serve_bulk lookup on phase 9's tables with click-log and with
     uniform ids), beside the plain versions, one library call as the
     yardstick (torch.matmul for K1–K4, torch.sparse.mm of the cell as a
     CSR tensor for K5/K6 — also printed with the operand's build
     included —, F.embedding_bag for K7), and the bound (larger of bytes /
     3.35 TB/s and FLOP / 67 TFLOP/s f32; K5/K6's bytes count their
     nonzero index, not the tiles, and the tile-FFMA figure of the TPU
     design is printed beside; K7's bytes count each distinct row once);
     K1 also at the backward width s = 192 and K2/K4 at the forward
     width s = 128 (bound and torch.matmul beside), K3/K4 at the checksum
     lane's widths s = 129 / 193 on the square adjacency (parity, bound,
     torch.matmul, phase 10 (b)'s launches), the per-launch device
     time of K1–K4 on the main path (phase 4's and phase 5's traces, real
     states: main loop plus operand pass; K2/K4 at s = 128 there, the h0
     rounds shipping no derived slot) beside their time on the random
     states, the ptxas registers and spills of every K1–K4 instantiation
     and of the operand passes, and the SM clock and power sampled while
     K2 (f32 A, s = 192) runs 60 times;
  8. the BCSR path at full width through
     ``distributed_betweenness_centrality`` on the 1×1 NCCL grid:
     (a) phase 4's graph and roots on fused_sparse at the default tile
     (128) and at 32×32, and on fused_hybrid at threshold 1.0 (the bytes
     model picks BCSR for this cell), each matching the single-device
     dense BC (rtol 1e-5 / atol 1e-5); (b) 86 disjoint 3×1024 lattices
     (n = 264 192, a long-diameter road-like graph whose 260 GiB dense
     block no card holds): the memory guard must refuse ``fused`` before
     allocating, then fused_sparse, h0, one round of 128 fixed roots,
     matching the arc-list engine (rtol 1e-5 / atol 1e-5); every
     run launches K5 and K6 and none of K1–K4, and prints the size and
     build time of its nonzero index; then (b) once under torch.profiler
     (busy share, K5/K6/NCCL shares);
  9. DLRM-RM2 serving at full width on one card, through the port's
     cells (``build_dlrm_cell``): the [26, 10 485 760, 64] f32 tables
     (65.0 GiB) made on the card from a seeded generator, after checking
     that less than 2 GiB is allocated; click-log requests from
     ``ClickLogStream(cfg, batch, seed=0)``: serve_p99 (512 examples, 50
     steps, latency p50/p99), serve_bulk (262 144 examples, 3 steps,
     examples/s) and retrieval_cand (1 query, 1 000 448 candidates, top
     100).  Every forward must launch K7 exactly once; K7 equals its
     plain version on a serve_p99 and a serve_bulk batch (rtol 1e-6);
     64 requests' logits recomputed in numpy float64 from host copies of
     the rows they touch (rtol 1e-4 / atol 1e-4, TF32 off); peak memory;
     one serve_bulk step under torch.profiler (busy share, K7 and GEMM
     shares);
 10. durable, self-checking and served BC on phase 4's graph and roots
     (batch 128, h0, fused; each leg's launch counts zeroed just before
     it): (a) a BCCheckpoint run stopped by BlockBudgetStop(2) after 2 of
     4 rounds (a snapshot a block), then a fresh call resuming it, which
     must run exactly the 2 uncommitted rounds and equal phase 4's fused
     BC (rtol 1e-5 / atol 1e-5); the sha1 manifest verified with numpy
     and hashlib; one snapshot's save time; (b) BCDriver with
     integrity="checksum" on FusedDenseOperator (K3/K4 at s = 129, the h0
     rounds shipping no derived slot; no K1/K2): residual under
     CHECKSUM_TOL, no failures, BC equal to the unchecked run; (c)
     integrity="audit" with the first block's BC corrupted (2·bc + 1):
     quarantined once, retried once, BC still
     equal; (d) run_serving on one device (1024 roots in 3 slices): every
     query accounted once, the final top 10 equal to a straight sampled
     call's; again on the same checkpoint (the committed generation
     published first, resumed=True, no new round); one adaptive call
     (2048-root pool, top-10 Jaccard >= 0.8 twice), which must stop
     early, and where; (e) run_serving on the
     1×1 NCCL grid, fused and fused_sparse at tile 128, each final BC
     equal to the straight call's;
 11. weighted BC (bucketed delta-stepping; no kernel, in the JAX package
     either, so every run must launch none of K1–K7), TF32 checked off:
     (a) rmat_graph(16, 16, seed=1, weights="dyadic") (phase 4's
     topology, auto_delta 0.25), phase 4's 512 roots, batch 128, h0, on
     the sparse engine, on one device and on the 1×1 NCCL grid (equal
     within rtol 1e-5 / atol 1e-5, same buckets per round), and at 4
     roots against the Dijkstra oracle rescaled by N/k; (b) unit weights
     at Δ = 1 against phase 4's unweighted dense BC (rtol 1e-5 / atol
     1e-5, not bitwise; buckets = levels); (c) road_like_graph(128, 128,
     seed=1, dyadic) (~420 buckets), one round of 64 roots, against the
     oracle (~0.3 s a root on the host); (d) road_like_graph(12, 12, seed=1, dyadic) (n = 232, two
     rounds of 128; the 24 × 24 graph of PR 25, six rounds and ~5 900
     host readbacks a run, took ~113 s of the phase), exact, h1, on
     dense, fused and fused_bf16 and on the 1×1 grid's fused,
     fused_sparse and fused_hybrid (the [n, n, s] forms: small n only),
     each against the full oracle.  Every run prints its wall, buckets
     per round, forward / backward buckets and inner trips, the host
     readbacks, the loops stopped unconverged at their trip cap (which
     must be none) and peak memory beside the card's name and power limit;
     (a) and (c) once more under torch.profiler (busy share, top ops);
 12. the ring schedules and the grid's checked steps, on the 1×1 NCCL
     grid (R − 1 = C − 1 = 0: no hop is posted; each ring runs one acc
     step): (a) phase 4's graph and roots through
     ``distributed_betweenness_centrality`` under overlap="expand" and
     "expand+fold" on fused, fused_bf16, fused_sparse (tile 128),
     fused_hybrid and sparse, and "auto" once on fused (the pick
     printed), each equal to the single-device dense BC (rtol 1e-5 /
     atol 1e-5, same levels per round); the fused runs launch only the
     acc modes of K3/K4 (dense) or K5/K6 (tiled), none of K1/K2; the
     frontier collectives and hops made inside the level steps are
     counted per group and must be none under "expand+fold"; (b) the ring
     steps of a real R > 1 cell in one process: cell (0, 0) of the 2×4
     partition of the same graph ([32768, 16384], 2 column slabs; 2 BCSR
     slots at tile 128, each with its own nonzero index), K3/K4 and K5/K6
     chained in acc mode over the slots with the operand's chunks in ring
     order, against the barrier partial of the whole cell (K3/K5 exact,
     K4/K6 rtol 1e-5 / atol 1e-6) and against the plain versions' chain,
     timed with cuda_time_ms beside the barrier launch, the plain chain,
     one library call and the bound (phase 7's acc rows); (c)
     integrity="checksum" under "expand+fold" on fused (residual under
     CHECKSUM_TOL, BC equal to (a)'s), then integrity="audit" on a
     weighted 1×1 run (phase 11 (a)'s graph and Δ, one round): no block
     quarantined; (d) phase 8 (b)'s strips on fused_sparse under
     "expand+fold", equal to the barrier run, the wall printed beside the
     barrier's (recorded, no claim);
 13. the multi-ledger straggler loop and the grid's recovery knobs (each
     run's launch counts zeroed just before it): (a) phase 4's graph and
     roots through ``BCDriver`` with two lanes a block on one card
     (``make_round_fn`` runs them one after the other, K1/K2) under
     straggler "none", "steal" and "redeal", each equal to phase 4's fused
     BC (rtol 1e-5 / atol 1e-5); (b) skewed_depth_graph(128, 128) (n =
     32 768), the roots of its first 9 components (9 rounds, deep and
     shallow alternating on the dense engine), the same two-lane fused
     driver under "redeal" (at least one redeal) and "steal" (the tail
     duplicate discarded), each equal to the dense engine; (c) (b) under
     "steal" with one dispatch stalled past a watchdog deadline and no
     retry budget: one re-mesh, one dead replica, BC unchanged; (d) on
     the 1×1 NCCL grid "steal" refused (fr = 1), then fused under the
     "auto" watchdog with max_retries=1 and the numeric guard, equal to
     phase 5's fused BC, the logged deadline and expected wall printed.
     Every line carries the card's name and power limit;
 14. measured-cost autotuning and the chaos harness on phase 4's graph and
     roots (each run's launch counts zeroed just before it): (a) on the
     1×1 NCCL grid, fused_hybrid under overlap="auto" with
     autotune="measure" on a fresh cache file (every tile, the dense
     calibration and three policies measured, the sparse calibration a
     hit; the report, the walls by configuration, the planner's wall, the
     resolved policy, tile and hybrid cells), then autotune="cache" on the
     file (no measurement, the same picks, bit-equal BC), then fused with
     autotune="cache" and the "auto" watchdog: the measured round prior
     (16 × the measured s/level) beside the round wall and the roofline
     prior; (b) chaos on the 1×1 grid, fused: transient@1x2 + poison@3
     (two retries, one block quarantined and recomputed through the
     fallback), flip@2 under integrity "audit" and "checksum" (detected,
     re-dispatched), a stall past the deadline with max_retries=1 (one
     watchdog re-dispatch), kill refused (fr = 1: ReplicaLostError), a
     BCCheckpoint crash@1 / torn@0 / resume falling back one generation,
     cache@1 garbling (a)'s file, read back empty with a warning; (c) two
     lanes a block on one card (phase 13's make_round_fn, K1/K2), 640
     roots in 5 rounds under "steal" with audit: kill@1:r1 re-meshed and
     flip@2:d1 (the tail duplicate, its claim forged) caught by the vote
     alone.  Every BC within rtol 1e-5 / atol 1e-5 of phase 5's fused BC
     (of (c)'s clean run in (c), which is held against a one-lane run of
     the same schedule); every run prints its recovery_stats.  Phase 7's
     rows count phase 14's launches by configuration: the planner's
     timings candidate by candidate, the runs by their tile and integrity
     mode; launches at a configuration with no row (acc mode on the 1×1
     grid, tile 64) are printed apart;
 15. the paper's own configuration, bc-rmat:rmat_s23_ef16 (R-MAT scale
     23, EF 16: n = 8 388 608, ~256 M arcs after the 1-degree pass; batch
     16 + 8 derived columns, h3, max_levels 12), through the cell
     (``launch/steps.py:build_cell``) on the 1×1 NCCL grid, sparse engine
     (the arc product's kernel, once a level product, and no other): the
     host seconds of R-MAT generation (seed 1), of the
     h3 schedule, of the partition and of the device copy, each apart;
     round 0 of the schedule at the static 12 levels (once plain, once
     under the work counter: ``roofline_terms(hw=H100)``, memory_s / wall
     as the share of the bytes bound) and with the liveness loop — wall,
     levels, traversed-edge rate (arcs × (s + k) / wall), peak device
     memory beside the footprint the meta prices; (i) the liveness round
     against ``make_round_fn`` on the single-device sparse operator, (ii) a
     round of ORACLE_ROOTS h0 roots (the residual's hub, then round 0's
     first sources, no derived columns) against a float64 scipy oracle,
     both at rtol 1e-5 / atol 1e-5, (iii) the static round against the
     liveness round, bit for bit when the depth is <= 12 (the arc sums
     are row sums in a fixed order; else the truncation printed as a
     finding); the arc product alone on the round's arcs at s = 16 and 24
     (bit-equal to its torch version; kernel, plain and torch.sparse.mm
     times and the bytes bound: phase 7's arc_product rows); the memory
     guard refusing
     fused and fused_sparse with the priced GiB; rmat_s25_ef16's meta, no
     graph made.
 16. DLRM training on one card, after phase 9 has freed its tables (less
     than 1 GiB allocated, checked): dlrm-rm2 at every width and the
     train_batch shape (B = 65 536) with 2^21 rows a table (params,
     grads, μ and ν 4 × 13.0 GiB: the published 10 485 760 rows would
     need 260 GiB), seed 0, ClickLogStream batches: (a) one batch's loss
     and every gradient through K7's autograd Function (K7 forward, the
     order-fixed float64 sum backward) and through the plain version's
     autograd: the table gradient of each within rtol 1e-5 plus, per
     entry, (n − 1)·2^-24·Σ|t| of its n lookups (the bound of any f32
     summation order, which cancellation does not shrink) of the float64
     sum of the same upstream rows, zero in every row no bag reads; the
     MLP gradients of the two paths within rtol 1e-5 / atol 1e-6; two
     backward passes bitwise equal (params and grads only, no optimizer
     state); (b) 20 steps of ``build_cell(bundle, "train_batch")``
     (AdamW, batches from the port's Prefetcher): K7 launched once a
     step, a finite loss whose mean over the last 5 steps is below the
     first 5's; step ms (median of CUDA events around the step), the
     optimizer pass's ms (events around its step), examples/s, peak
     memory beside the reckoned ~56 GiB, and one step under
     torch.profiler (K7, the backward's sort and segment sums, GEMMs and
     the elementwise kernels); (c) at 2^16 rows, 6 steps straight against
     3 steps, a save through CheckpointManager(async_writes=True) into a
     temporary directory (removed), a restore into a cell of other
     weights and 3 more steps: params bitwise equal; the save's ms and
     MB; (d) adamw, adafactor and sgd_momentum under cosine_with_warmup,
     5 steps of identical gradients on a [3, 257, 130] stacked leaf, a
     matrix and a vector, on the card against the CPU (rtol 1e-6 / atol
     1e-7).  Every part prints the card's name and power limit, and the
     phase its wall.
 17. LM serving on one card, after phase 16 (less than 1 GiB allocated,
     checked; bf16 GEMMs reduced in f32, checked), no kernel of ours (the
     JAX LM path reaches no pallas_call): (a) the five LM archs reduced by
     reduced_lm(layers=2, d_model=256, vocab=2048), weights from seed 0 on
     the CPU copied to the card, prefill of 256 tokens and 8
     teacher-forced decode steps on both: logits within 5 % and the cache
     within 2 % of the CPU's largest value (an MoE arch may have 1 % of
     its cache rows past that: a route flipped at a near-tie), the CPU
     tests' tolerances against the JAX package; (b) granite-moe-1b-a400m
     at every published width (1.335 G params, weights from seed 0 on the
     card): serve_loop(batch=4, prompt_len=32768, gen=16); the prefill_32k
     cell at B = 4, cut from 32 (32 × 32 768 tokens need a 51.5 GB cache
     beside > 80 GB of MoE buffers), median of 2 CUDA-event timings; the
     decode_32k cell at B = 32, cut from 128 (a 206 GB cache), and
     long_500k uncut (B = 1, 25.8 GB), each 20 steps at the last position
     on a cache of N(0, 1) bf16, the step replayed as a CUDA graph (its
     op-by-op time and the capture printed beside; the drops counted on
     an op-by-op step); (c) gemma-7b at every published width
     (8.54 G params): serve_loop(batch=1, prompt_len=4096, gen=16), the
     prefill_32k cell at B = 1 (cut from 32: 15.0 GB of cache a
     sequence), and prefill(2048) + decode_step(2048) against
     prefill(2049)'s last logits (5 % of the largest, argmax equal past
     that margin).  Each run prints ms, tokens/s, peak GiB beside the
     cell's reckoned bytes, a decode step's share of its bytes bound
     ((params + cache) / 3.35 TB/s), a prefill's FLOP share of the H100's
     dense bf16 peak (989 TFLOP/s) and the (token, expert) assignments
     dropped, recounted from the router; logits finite, tokens in range;
     one prefill and one decode step of each part once more under
     torch.profiler (device time by kernel family).
 18. LM training on one card, after phase 17 (less than 1 GiB allocated,
     checked; bf16 GEMMs reduced in f32, checked), no kernel of ours:
     (a) the five LM archs reduced by reduced_lm(layers=2, d_model=256,
     vocab=2048), B = 2, S = 256 (a 255-token loss: a chunk of 128 and a
     ragged tail), remat on, weights from seed 0 on the CPU copied to the
     card: lm_loss and every gradient (the score product's f32 backward
     runs only here and in the card tests) on the card against the CPU,
     the card held to the CPU's expert routes (a top-1 route flipped at
     a near-tie moves the whole gradient), at the CPU tests' tolerances
     against the JAX package (loss 1e-2 relative, each gradient 5 % of
     its largest value; at most 1 % of the tokens to other experts on the
     card's own routes); then one train-cell step each (AdamW, Adafactor
     for llama4-maverick) at the cell's lr 1e-4 (checked), card against
     CPU (loss 1e-2, μ 5 %, ν / vr / vc 10 % of their largest value,
     params within 2·lr + one unit, each parameter's update by norms over
     the leaf: the difference within 0.25 and the norm within 5 % of the
     CPU's, tests/torch_lm_routes.py, whose route pinning this phase also
     uses);
     (b) granite-moe-1b-a400m's train_4k at every published width (24
     layers, d 1 024, 32 experts top-8, vocab 49 155 padded to 49 408,
     S = 4 096), the batch cut from 256 to 16 (the largest power of two
     that fits: 16.0 GB of state, ~2.3 GB a sequence), weights from seed
     0 on the card, TokenStream batches through the Prefetcher into
     ``build_cell(..., "train_4k")``: one warm-up and 5 timed steps —
     step ms (median of CUDA events), tokens/s, the share of the dense
     bf16 peak of lm_model_flops(B·S) (and of the reference meta's 3×),
     the optimizer pass's ms, peak GiB beside the cell's reckoned bytes,
     the dropped (token, expert) assignments, each loss finite and below
     2·ln(V_pad); the loss forward alone; one step under torch.profiler
     (device time by kernel family); (c) the launcher train_lm on granite
     at every width cut to 2 layers, B = 2, AdamW at the launcher's lr
     3e-3, on its default device, each process as a user runs it: one
     process trains 6 steps straight, then 4 steps saving every 3 through
     CheckpointManager(async_writes=True) into a temporary directory
     (removed); a new process resumes after step 3 (its Prefetcher
     replays the stream from step 4): the losses and the whole train
     state bitwise equal; one save's ms and MB; (d) gemma-7b's
     train_4k meta only (8.54 G params at 12 bytes are more than a card
     holds).  Every part prints the card's name and power limit, and the
     phase its wall.
 19. GNN training on one card, after phase 18 (less than 1 GiB allocated,
     checked), no kernel of ours (the JAX GNN path reaches no pallas_call;
     its segment sums stay torch ops), on a 1×1 NCCL grid: (a) the four
     GNN archs reduced to 2 layers of width 8, on a Cora-sized
     sized_rmat_graph (2 708 nodes, 10 556 arcs, 1 433 features, 64
     padding arcs), parameters drawn on the CPU and copied: the flat
     path's loss and every gradient on the card against the CPU (loss
     rtol 1e-5, each gradient within 1e-4 of its leaf's largest |value|:
     the CPU tests' rtols against the JAX package) and the 2-D path's
     (f32 payloads) on the grid against the CPU's flat path (loss rtol
     1e-4, gradients 1e-3: tests/test_dist_gnn2d.py's rtols); (b)
     the four archs at their published widths (gat-cora 2 × 8 heads × 8,
     gin-tu 5 × 64, graphcast 16 × 512 with 227 variables, meshgraphnet
     15 × 128) on full_graph_sm through build_gnn_cell (bf16 expand and
     fold, AdamW 1e-3): 8 steps each (AdamW's first steps overshoot on
     graphcast's and meshgraphnet's deep unnormalised stacks), every loss
     finite and the last below the first, step ms and peak GiB; (c) gin-tu:ogb_products at
     full width and full scale through build_gnn_cell: a sized_rmat_graph
     of exactly 2 449 029 vertices and 61 859 140 arcs (R-MAT draws at
     scale 22 below n, skewed degrees), 100 feature columns, 47 classes,
     92 788 720 arc slots (a third of them padding); the host set-up's
     steps timed apart, a warm-up and 5 timed steps (step ms the median of
     CUDA events, nodes/s, arcs/s, the share of the meta's model_flops at
     the f32 peak, the shares of two reckoned bytes floors at 3.35 TB/s,
     peak GiB beside a reckoning), the losses (finite), whether two loss-and-gradient passes from one state give the
     same bits (index_add is atomic on the card), the padding arcs' cost
     (one gather-and-sum over every slot against the real arcs alone) and
     one step under torch.profiler (gathers, index sums, GEMMs,
     collectives, copies); (d) none of K1–K7 launched.  Every part prints
     the card's name and power limit, and the phase its wall.
Each torch.profiler trace opens with 256 spin kernels of ~0.5 ms, which
its numbers leave out: late in the script a trace loses its first device
records, and these take the loss (a trace that kept none of them fails).
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the Tile<BM, BS, BK, STAGES, FAST> arguments of a K1-K4 instantiation
RE_TILE = re.compile(r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense, no tensor cores for f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

MAIN_N_SCALE, MAIN_EF = 16, 16
MAIN_BATCH, MAIN_SAMPLE_K = 128, 512
TEST_SHAPES = [(8, 4), (16, 16), (64, 8), (128, 128), (130, 33), (256, 64)]
# (m, k, s) ragged rectangular blocks for K3/K4: m != k, neither a
# multiple of 128, s not a multiple of 128
PARTIAL_SHAPES = [(8, 16, 4), (130, 70, 33), (300, 1000, 192), (1000, 260, 128), (257, 129, 130)]
BLOCK_GRID = (2, 4)  # K3/K4 are also checked and timed at this grid's per-device block
# K1/K3's edges on the main loop: contraction lengths whose A rows are and
# are not a multiple of 16 bytes, widths that reach each column tile (64,
# 128, 192) and ragged ones over several tiles
# (129, 193: the main path's widths plus the ABFT checksum lane)
EDGE_KDIMS, EDGE_WIDTHS = (33, 130, 260, 4096), (64, 128, 192, 130, 257, 129, 193)
# (tile-rows, tile-cols, bm, bk, s) random BCSR lists for K5/K6: bm != bk,
# each of the kernel's row blocks (32, 64, 128), ragged s
SPARSE_SHAPES = [(6, 5, 5, 8, 33), (4, 7, 8, 5, 130), (40, 30, 32, 128, 128),
                 (20, 50, 128, 32, 192), (12, 9, 128, 8, 257)]
# phase 8 (b): 86 disjoint 3 x 1024 lattices (n = 264 192, ~10^3 levels),
# one round of 128 roots.  Not one 512 x 512 lattice: its path counts reach
# C(1022, 511) ~ 1e306 and overflow f32 σ (BC turns non-finite in the port
# and the JAX package alike); a 3-row strip keeps every count <= C(1025, 2)
# < 2^24, exact in f32.
STRIPS, STRIP_SHAPE, STRIP_SAMPLE_K = 86, (3, 1024), 128
SPARSE_TILE = 32  # phase 8 (a) also runs fused_sparse at this square tile
# phase 3's skewed K5/K6 case: tile-row 0 holds this many 128 x 128 tiles
# whose first row is all ones, one row of 20 480 nonzeros
SKEW_TILES = 160


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> tuple[bool, float]:
    """(all |got - want| <= atol + rtol·|want|, max abs error), in float64,
    2^26 elements at a time (a whole [B·F, 64] lookup in float64 would not
    fit beside the DLRM tables)."""
    got, want = got.reshape(-1), want.reshape(-1)
    ok, worst, step = True, 0.0, 1 << 26
    for i in range(0, got.numel(), step):
        g, w = got[i:i + step].double(), want[i:i + step].double()
        diff = (g - w).abs()
        ok = ok and bool((diff <= atol + rtol * w.abs()).all())
        worst = max(worst, float(diff.max()))
    return ok, worst


def close_to_sum(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor,
                 rtol: float) -> tuple[bool, float]:
    """(all |got - want| <= rtol·scale, max of |got - want| / scale), with
    scale = Σ|a·x| of each output: a sum's rounding error is relative to
    it, which cancellation between signed terms does not shrink."""
    diff = (got - want).abs()
    ok = bool((diff <= rtol * scale).all())
    return ok, float((diff / scale.clamp(min=torch.finfo(torch.float32).tiny)).max())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 5) -> float:
    """Device ms per call of ``fn``: a warm-up, then ``reps`` calls between
    two CUDA events, queued behind a ~25 ms device sleep so that the host
    has enqueued them before the first runs — the events time the card's
    work, not the host's launches (K5/K6 take ~0.2 ms, near a wrapper's
    host time)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_clocks() -> str:
    """SM clock, power draw and temperature now (beside a timing window)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# each trace opens with TRACE_SPINS spin kernels of ~0.5 ms, left out of its numbers: late in
# this script a trace loses its first device records (on the H100: phase 4's first pageable
# copies, fills and one K1 operand pass), and with them it loses spin kernels instead
TRACE_SPINS, TRACE_SPIN_CYCLES = 256, 1_000_000


def trace_run(tag: str, run, shares: dict[str, str] | None = None,
              host_ops: bool = True) -> dict[str, tuple]:
    """``run()`` once more under torch.profiler: device time per kernel and
    the device's busy share of the traced wall time (the untraced runs give
    the end-to-end numbers).  ``shares`` maps a label to a substring (or a
    tuple of substrings, all required) of kernel names whose summed share
    of device time is printed; returns label -> (device ms, launches).
    ``host_ops=False`` records the device activity alone (no host op
    events): a run of ~10^5 ops then takes seconds, not tens of seconds,
    to summarise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_SPINS):
            torch.cuda._sleep(TRACE_SPIN_CYCLES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device activities only, as the profiler's own table sums them: a host
    # op (aten::copy_) and a user annotation on the device timeline
    # (nccl:_all_gather_base) repeat the device time of what they enclose.
    # The annotations still give the collectives' share.
    events = [(ev.key, ev.count, ev.self_device_time_total,
               getattr(ev, "is_user_annotation", False)) for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    spins = sum(e[1] for e in events if "spin_kernel" in e[0])
    check(spins > 0, f"the traced {tag} run lost all {TRACE_SPINS} opening spin kernels: its own "
          f"first records may be lost too")
    events = [e for e in events if "spin_kernel" not in e[0]]
    rows = [r[:3] for r in events if not r[3]]
    busy_us = sum(r[2] for r in rows)
    check(busy_us > 0, f"the traced {tag} run recorded no device time")
    print(f"{tag} traced: wall {wall_us / 1e6:.3f}s, device busy "
          f"{busy_us / 1e6:.3f}s ({100 * busy_us / wall_us:.1f}%), idle "
          f"{100 * (1 - busy_us / wall_us):.1f}%; {spins} of the {TRACE_SPINS} spin kernels "
          f"that open the trace recorded")
    found = {}
    for label, needle in (shares or {}).items():
        needles = (needle,) if isinstance(needle, str) else needle  # all must match
        mine = [r for r in events if all(x in r[0] for x in needles)]
        us = sum(r[2] for r in mine)
        n = sum(r[1] for r in mine)
        found[label] = (us / 1e3, n)
        print(f"{tag}   share {label}: {us / 1e3:.3f} ms, {100 * us / busy_us:.1f}% of "
              f"device time, x{n}")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"{tag}   {us / 1e3:10.3f} ms {100 * us / busy_us:5.1f}%  x{count:<4d} {key[:90]}")
    return found


def dep_operand(sigma, depth, delta, omega) -> torch.Tensor:
    """g of a dependency level at lvl = 1 (the operand K2/K4/K6 write)."""
    return torch.where(depth == 2, (1.0 + delta + omega[:, None])
                       / torch.where(sigma > 0, sigma, 1.0), 0.0)


def ptxas_report(log: str, kernels: tuple[str, ...]) -> list[str]:
    """One line per instantiation of ``kernels`` in the build's ptxas
    report: source, template arguments, registers, spills."""
    lines, out, source = log.splitlines(), [], ""
    for i, line in enumerate(lines):
        if line.startswith("== "):
            source = line[3:]
        name = next((k for k in kernels if f"{k}I" in line), None)
        if name is None or "Compiling entry function" not in line:
            continue
        args = line.split("'")[1].split(f"{name}I", 1)[1]
        tile = RE_TILE.search(args)
        if tile:
            bm, bs, bk, stages, fast = tile.groups()
            label = (f"{'bf16' if args.startswith('13__nv_bfloat16') else 'f32'}, BM {bm} "
                     f"BS {bs} BK {bk}, {stages} stages, "
                     f"{'16-byte copies' if fast == '1' else 'element loads'}")
        else:
            label = next((op for op in ("DependencyOperand", "FrontierOperand") if op in args),
                         args[:40])
        props = " ".join(x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4])
        out.append(f"{source} {name}<{label}>: {props}")
    return out


def clocks_during(fn) -> str:
    """Run ``fn`` while nvidia-smi samples the SM clock and power draw
    every 50 ms; min / median / max of the samples taken while the card
    drew more than 60 % of its power limit (the kernel's window)."""
    cmd = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
           "--format=csv,noheader,nounits", "-lms", "50"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)
        fn()
        time.sleep(0.2)
    finally:
        proc.terminate()
        out = proc.communicate()[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines() if line.strip()]
    busy = sorted((mhz, w) for mhz, w, limit in rows if w > 0.6 * limit)
    if not busy:
        return f"{len(rows)} samples, none above 60 % of the power limit"
    mhz = [b[0] for b in busy]
    watts = sorted(b[1] for b in busy)
    return (f"{len(busy)} of {len(rows)} samples under load: SM clock min {mhz[0]:.0f} / median "
            f"{mhz[len(mhz) // 2]:.0f} / max {mhz[-1]:.0f} MHz, power median "
            f"{watts[len(watts) // 2]:.1f} W")


def tile_list(num_tr: int, num_tc: int, bm: int, bk: int, seed: int, dev, complete: bool,
              pad: int = 3):
    """A row-sorted random BCSR list: 0–3 distinct tiles per tile-row, an
    all-zero filler in an empty row when ``complete`` (else the row stays
    empty), and ``pad`` zero tiles trailing on the last row."""
    rng = np.random.default_rng(seed)
    rows, cols, data = [], [], []
    for r in range(num_tr):
        picks = np.sort(rng.choice(num_tc, size=min(num_tc, int(rng.integers(0, 4))),
                                   replace=False))
        if picks.size == 0 and complete:
            rows.append(r), cols.append(0), data.append(np.zeros((bm, bk), np.float32))
        for c in picks:
            rows.append(r), cols.append(int(c))
            data.append((rng.random((bm, bk)) < 0.3).astype(np.float32))
    for _ in range(pad):
        rows.append(num_tr - 1), cols.append(0), data.append(np.zeros((bm, bk), np.float32))
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (np.stack(data), np.array(rows, np.int32), np.array(cols, np.int32)))


def count_nonzero_tiles(tiles) -> int:
    """Nonzero entries of a tile list, 2^28 elements at a time."""
    step = max(1, (1 << 28) // (tiles.shape[1] * tiles.shape[2]))
    return sum(int(torch.count_nonzero(tiles[t:t + step])) for t in range(0, tiles.shape[0], step))


def skewed_list(dev, seed: int):
    """Phase 3's skewed BCSR list: SKEW_TILES 128 x 128 tiles on tile-row 0
    whose first row is all ones over 2 % random entries, one random tile on
    each of tile-rows 1-3, and a trailing zero pad tile."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles = (torch.rand((SKEW_TILES + 4, 128, 128), generator=gen, device=dev) < 0.02).float()
    tiles[:SKEW_TILES, 0, :] = 1.0
    tiles[-1] = 0.0
    rows = torch.tensor([0] * SKEW_TILES + [1, 2, 3, 3], dtype=torch.int32, device=dev)
    cols = torch.tensor(list(range(SKEW_TILES)) + [5, 6, 7, 0], dtype=torch.int32, device=dev)
    return tiles, rows, cols


def level_state(n: int, s: int, seed: int, lvl: int, dev):
    """A plausible mid-traversal state (as tests/test_kernels.py builds it)."""
    rng = np.random.default_rng(seed)
    sigma = rng.integers(0, 5, size=(n, s)).astype(np.float32)
    depth = rng.integers(-1, lvl + 3, size=(n, s)).astype(np.int32)
    sigma = np.where(depth >= 0, np.maximum(sigma, 1.0), 0.0).astype(np.float32)
    delta = (rng.random((n, s)).astype(np.float32) * (depth >= 0)).astype(np.float32)
    omega = rng.integers(0, 3, size=n).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (sigma, depth, delta, omega))


def at_offset(A: torch.Tensor) -> torch.Tensor:
    """A copy of A whose base lies one element past a 16-byte boundary (a
    contiguous view into a larger buffer): the main loop's element loads."""
    buf = torch.empty(A.numel() + 1, dtype=A.dtype, device=A.device)
    view = buf[1:].view(A.shape)
    view.copy_(A)
    return view


# K7 parity cases (V, D, B, L): the JAX kernel test's grid, then a ragged D
BAG_CASES = [(32, 8, 4, 3), (64, 128, 8, 5), (128, 96, 16, 10), (1000, 64, 32, 26), (50, 13, 6, 4)]
# phase 9: DLRM-RM2 serving at full width
P99_STEPS, BULK_STEPS, RETRIEVAL_REPS = 50, 3, 3
CHECK_REQUESTS = 64  # logits recomputed in float64 on the host
GIB = 2**30


def segment_bag_parity(dev) -> None:
    """Phase 3's K7 cases: f32 and bf16 tables, with and without weights,
    the first bag all padding; rtol 1e-6 / atol 1e-6 (f32), rtol 2e-2
    (bf16)."""
    from repro_torch.kernels import ops, ref

    for V, D, b, L in BAG_CASES:
        rng = np.random.default_rng(V + D + b + L)
        table32 = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(-1, V, size=(b, L)).astype(np.int32)).to(dev)
        idx[0] = -1
        w = torch.from_numpy(rng.random((b, L)).astype(np.float32)).to(dev)
        errs = []
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            rtol, atol = (1e-6, 1e-6) if tag == "f32" else (2e-2, 1e-5)
            for weights in (None, w):
                table = table32.to(dt)
                got = ops.segment_bag(table, idx, weights)
                ok, err = close(got, ref.segment_bag_ref(table, idx, weights), rtol, atol)
                check(ok and float(got[0].abs().sum()) == 0.0,
                      f"K7 parity at V={V} D={D} B={b} L={L} table={tag} "
                      f"weighted={weights is not None}: err {err:.3g}")
                errs.append(err)
        print(f"[3] K7 V={V} D={D} B={b} L={L}: f32/bf16 table, unweighted/weighted, "
              f"an all-padding bag: max err {max(errs):.3g}")


def flat_bags(sparse: torch.Tensor, v: int) -> torch.Tensor:
    """The B·F bags K7 gets from ``embedding_bag_lookup``: ids offset by
    f·V into the flat table, -1 kept."""
    b, f, bag_len = sparse.shape
    offs = (torch.arange(f, dtype=torch.int32, device=sparse.device) * v)[None, :, None]
    return torch.where(sparse >= 0, sparse + offs, -1).reshape(b * f, bag_len)


def logits_float64(model, dense: np.ndarray, sparse: np.ndarray) -> np.ndarray:
    """The DLRM forward in numpy float64, from host copies of only the
    table rows the requests touch and of the MLP weights."""
    cfg = model.cfg
    sp = torch.from_numpy(sparse).to(model.tables.device)
    fields = torch.arange(cfg.n_sparse, device=sp.device)[None, :, None]
    rows = model.tables[fields, sp.clamp(min=0).long()].double().cpu().numpy()  # [B, F, L, D]
    emb = (rows * (sparse >= 0)[..., None]).sum(axis=2)

    def mlp(layers, x, final_act):
        for i, lin in enumerate(layers):
            x = x @ lin.weight.detach().double().cpu().numpy().T + lin.bias.detach().double().cpu().numpy()
            if i < len(layers) - 1 or final_act:
                x = np.maximum(x, 0.0)
        return x

    bot = mlp(model.bot, dense.astype(np.float64), True)
    feats = np.concatenate([bot[:, None, :], emb], axis=1)
    dots = np.einsum("bif,bjf->bij", feats, feats)
    iu, ju = np.triu_indices(feats.shape[1], k=1)
    z = np.concatenate([bot, dots[:, iu, ju]], axis=1)
    return mlp(model.top, z, False)[:, 0]


def dlrm_phase(dev, trace_run) -> list[dict]:
    """Phase 9: DLRM-RM2 serving at full width on one card, and K7's
    times (phase 7's K7 rows) while its tables are on the card.  Returns
    the kernel-table entries of K7."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data import ClickLogStream
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import RETRIEVAL_TOP_K, build_dlrm_cell, pad_mult
    from repro_torch.roofline import counter as work

    t9 = time.perf_counter()
    live = torch.cuda.memory_allocated()
    check(live < 2 * GIB, f"[9] {live / GIB:.2f} GiB still allocated before the tables")
    torch.cuda.reset_peak_memory_stats()
    bundle = get_arch("dlrm-rm2")
    cfg = bundle.arch
    f, v, d = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    table_bytes = f * v * d * 4
    t = time.perf_counter()
    cells = {"serve_p99": build_dlrm_cell(bundle, "serve_p99", device="cuda", seed=0)}
    model = cells["serve_p99"].model
    torch.cuda.synchronize()
    print(f"[9] dlrm-rm2 tables [{f}, {v}, {d}] f32 = {table_bytes / GIB:.2f} GiB and MLPs "
          f"{cfg.n_dense}-{'-'.join(map(str, cfg.bot_mlp))} / "
          f"{sum(p.numel() for p in model.top.parameters()) + sum(p.numel() for p in model.bot.parameters())} "
          f"MLP parameters, created on the card from a seeded CUDA generator in "
          f"{time.perf_counter() - t:.2f}s ({live / GIB:.2f} GiB allocated before)")
    print(f"[9] TF32 matmul={torch.backends.cuda.matmul.allow_tf32} (off, as resolve_device "
          f"sets it: TF32's 10-bit mantissa would not pass the float64 check below)")
    for name in ("serve_bulk", "retrieval_cand"):
        cells[name] = build_dlrm_cell(bundle, name, device="cuda", model=model)
    k7_total = 0

    def forward(cell, batch):
        """One cell call, host clock, ending synchronised; K7 launched once."""
        nonlocal k7_total
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        out = cell.fn(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        n = ops.LAUNCHES["segment_bag"]
        check(n == 1, f"[9] {cell.name}: K7 launched {n} times in one forward, not once")
        k7_total += n
        return out, dt

    def lookup_parity(batch, tag) -> float:
        """K7 against its plain version on this batch's bags (rtol 1e-6;
        L = 1 and weight 1: the sum is exact)."""
        bags = flat_bags(torch.from_numpy(batch["sparse"]).to(dev), v)
        flat = model.tables.view(f * v, d)
        ok, err = close(ops.segment_bag(flat, bags), ref.segment_bag_ref(flat, bags), 1e-6, 0.0)
        check(ok, f"[9] K7 disagrees with its plain version on a {tag} batch: err {err:.3g}")
        print(f"[9] K7 on a {tag} batch ({bags.shape[0]} bags) vs plain version: max err {err:.3g}")
        return err

    # ---- serve_p99: 512 requests a call, 50 consecutive steps after a warm-up
    n_p99, n_bulk = bundle.shapes["serve_p99"].batch, bundle.shapes["serve_bulk"].batch
    stream = ClickLogStream(cfg, n_p99, seed=0)
    batches = [stream.batch_at(step) for step in range(P99_STEPS + 1)]
    forward(cells["serve_p99"], batches[0])  # warm-up (cuBLAS handles, first launches)
    lat, outs = [], []
    for batch in batches[1:]:
        out, dt = forward(cells["serve_p99"], batch)
        check(out.shape == (n_p99,) and bool(torch.isfinite(out).all())
              and bool(((out >= 0) & (out <= 1)).all()), "[9] serve_p99: bad probabilities")
        lat.append(dt)
        outs.append(out)
    lat_ms = np.array(lat) * 1e3
    print(f"[9] serve_p99 ({n_p99} requests, steps 1-{P99_STEPS}, batch from the host): latency "
          f"p50 {np.percentile(lat_ms, 50):.3f} ms, p99 {np.percentile(lat_ms, 99):.3f} ms, "
          f"mean {lat_ms.mean():.3f} ms, min {lat_ms.min():.3f} ms, max {lat_ms.max():.3f} ms; "
          f"{n_p99 / np.median(lat):.0f} examples/s at p50")
    err_p99 = lookup_parity(batches[1], "serve_p99")
    # the independent check: float64 on the host from the touched rows
    req = {k: x[:CHECK_REQUESTS] for k, x in batches[1].items()}
    with torch.inference_mode():
        logit, _ = model(torch.from_numpy(req["dense"]).to(dev), torch.from_numpy(req["sparse"]).to(dev))
    want = logits_float64(model, req["dense"], req["sparse"])
    ok, err = close(logit.cpu(), torch.from_numpy(want), 1e-4, 1e-4)
    ok_p, err_p = close(outs[0][:CHECK_REQUESTS].cpu(), torch.from_numpy(1 / (1 + np.exp(-want))),
                        1e-4, 1e-4)
    print(f"[9] {CHECK_REQUESTS} requests recomputed in float64 on the host: logit max err "
          f"{err:.3g} (|logit| up to {np.abs(want).max():.3g}), served probability max err "
          f"{err_p:.3g} (rtol 1e-4 / atol 1e-4)")
    check(ok and ok_p, "[9] the served logits disagree with the float64 recomputation")
    del batches, outs

    # ---- serve_bulk: 262 144 examples a call, 3 steps after a warm-up
    stream = ClickLogStream(cfg, n_bulk, seed=0)
    t = time.perf_counter()
    batches = [stream.batch_at(step) for step in range(BULK_STEPS + 1)]
    print(f"[9] serve_bulk: {BULK_STEPS + 1} click-log batches made on the host in "
          f"{time.perf_counter() - t:.2f}s (set-up)")
    forward(cells["serve_bulk"], batches[0])
    lat = []
    for batch in batches[1:]:
        out, dt = forward(cells["serve_bulk"], batch)
        check(out.shape == (n_bulk,) and bool(torch.isfinite(out).all()),
              "[9] serve_bulk: bad probabilities")
        lat.append(dt)
    flops = cells["serve_bulk"].static_meta["model_flops"]
    print(f"[9] serve_bulk ({n_bulk} examples, steps 1-{BULK_STEPS}, batch from the host): "
          f"{', '.join(f'{x * 1e3:.3f}' for x in lat)} ms, "
          f"{n_bulk * len(lat) / sum(lat):.0f} examples/s, "
          f"{flops * len(lat) / sum(lat) / 1e12:.2f} TFLOP/s of MLP+interaction "
          f"({flops / 1e9:.1f} GFLOP a call)")
    err_bulk = lookup_parity(batches[1], "serve_bulk")
    trace_run("[9] serve_bulk", lambda: cells["serve_bulk"].fn(batches[1]),
              {"K7": "segment_bag", "GEMM (MLPs, bmm)": "gemm"})

    # ---- retrieval_cand: 1 query against 1 000 448 candidates, top 100
    n_pad = pad_mult(bundle.shapes["retrieval_cand"].n_candidates)
    gen = torch.Generator(device=dev).manual_seed(1)
    cands = torch.randn((n_pad, d), generator=gen, device=dev)
    rbatch = {**ClickLogStream(cfg, 1, seed=0).batch_at(0), "candidates": cands}
    forward(cells["retrieval_cand"], rbatch)
    lat = []
    for _ in range(RETRIEVAL_REPS):
        (scores, ids), dt = forward(cells["retrieval_cand"], rbatch)
        lat.append(dt)
    check(scores.shape == ids.shape == (1, RETRIEVAL_TOP_K), "[9] retrieval: bad top-k shape")
    check(bool((scores[:, :-1] >= scores[:, 1:]).all()) and int(ids.min()) >= 0
          and int(ids.max()) < n_pad, "[9] retrieval: top-k not sorted or ids out of range")
    with torch.inference_mode():
        _, feats = model(torch.from_numpy(rbatch["dense"]).to(dev),
                         torch.from_numpy(rbatch["sparse"]).to(dev))
    full = cands.double() @ feats.sum(dim=1)[0].double()  # every candidate, float64
    rescored = full[ids[0]]
    ok, err = close(scores[0], rescored, 1e-5, 1e-4)
    above = int((full > float(rescored.min()) + 1e-4).sum())  # clearly above the 100th
    check(ok and above < RETRIEVAL_TOP_K,
          f"[9] retrieval disagrees with a float64 rescoring: err {err:.3g}, {above} "
          f"candidates clearly above the lowest returned")
    print(f"[9] retrieval_cand (1 query, {n_pad} candidates, top {RETRIEVAL_TOP_K}): "
          f"{', '.join(f'{x * 1e3:.3f}' for x in lat)} ms; vs float64 scores of every "
          f"candidate: max err {err:.3g}, {above} candidates clearly above the lowest "
          f"returned score (< {RETRIEVAL_TOP_K}: no better candidate was missed)")
    peak = torch.cuda.max_memory_allocated()
    print(f"[9] peak device memory of the serving runs {peak / GIB:.2f} GiB (tables "
          f"{table_bytes / GIB:.2f} GiB); K7 launched once in each of the {k7_total} forwards")
    del cands, full

    # ---- phase 7's K7 rows: the serve_bulk lookup on the full tables
    print(f"[7] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    flat = model.tables.view(f * v, d)
    zipf = flat_bags(torch.from_numpy(batches[1]["sparse"]).to(dev), v)
    gen.manual_seed(2)
    uniform = flat_bags(torch.randint(0, v, (n_bulk, f, 1), generator=gen, device=dev,
                                      dtype=torch.int32), v)
    entries = []
    for tag, bags, err in (("click-log Zipf(1.2) ids", zipf, err_bulk),
                           ("uniform ids", uniform, None)):
        distinct = int(torch.unique(bags[bags >= 0]).numel())
        nbytes = work.segment_bag_bytes(flat, bags, distinct=distinct)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = work.sparse_flops(bags.numel(), d) / PEAK_F32_FLOP_PER_S * 1e3
        if err is None:  # not a click-log batch: hold the kernel here too
            ok, err = close(ops.segment_bag(flat, bags), ref.segment_bag_ref(flat, bags), 1e-6, 0.0)
            check(ok, f"[7] K7 disagrees with its plain version on {tag}")
        safe = bags.clamp(min=0).long()
        mask = (bags >= 0).float()
        ms = cuda_time_ms(lambda: ops.segment_bag(flat, bags), reps=20)
        plain_ms = cuda_time_ms(lambda: ref.segment_bag_ref(flat, bags), reps=20)
        lib_ms = cuda_time_ms(lambda: F.embedding_bag(safe, flat, mode="sum",
                                                      per_sample_weights=mask), reps=20)
        bound = max(t_bytes, t_ops)
        entries.append({
            "name": f"segment_bag[serve_bulk {bags.shape[0]} bags x L={bags.shape[1]}, D={d}, "
                    f"{tag}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_bag.cu",
            "replaces": "src/repro/kernels/segment_bag.py:29",
            "launches": k7_total,
            "max_abs_err": max(err_p99, err),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        print(f"[7] segment_bag serve_bulk {tag}: {distinct} distinct rows of "
              f"{bags.shape[0]} bags; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"F.embedding_bag {lib_ms:.3f} ms, bound {bound:.3f} ms (bytes {t_bytes:.3f}: "
              f"{nbytes / 1e9:.3f} GB / ops {t_ops:.4f}), {100 * bound / ms:.1f}% of bound, "
              f"{nbytes / ms / 1e6:.0f} GB/s effective; 1 launch per forward")
        del safe, mask
    del model, cells, flat, zipf, uniform, batches
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 2 * GIB, "[9] the tables were not released")
    print(f"[9] DLRM serving ok in {time.perf_counter() - t9:.1f}s")
    return entries


# phase 16: DLRM training on the card
TRAIN_ROWS = 1 << 21  # rows per table of the train cell: 4 x 13.0 GiB of state fit one card
RESUME_ROWS = 1 << 16  # (c)'s rows: 1.3 GB of state on disk
TRAIN_STEPS, RESUME_STEPS = 20, 6
TRAIN_PEAK_GIB = 56.0  # reckoned: params, grads, μ, ν 52.0 GiB + activations and temporaries
OPT_PARITY_STEPS = 5


def grad_bound(grad_out: torch.Tensor, bags: torch.Tensor, uniq: torch.Tensor,
               inv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the float64 table gradient at the rows ``uniq`` that the bags
    read, each entry's (n - 1)·2^-24·Σ|t|): the sum of the f32 upstream
    rows ``grad_out[b]`` over each row's n lookups in float64, and the
    worst-case rounding of any float32 summation order of those n terms
    (cancellation does not shrink it).  L = 1: lookup i is bag i."""
    d = grad_out.shape[1]
    g64 = grad_out[bags.reshape(-1) >= 0].double()
    want = torch.zeros((uniq.numel(), d), dtype=torch.float64, device=g64.device)
    want.index_add_(0, inv, g64)
    scale = torch.zeros_like(want).index_add_(0, inv, g64.abs())
    terms = torch.bincount(inv, minlength=uniq.numel()).double()
    return want, (terms - 1).clamp(min=0)[:, None] * 2.0**-24 * scale


def train_phase(dev, trace_run, smi: str) -> int:
    """Phase 16: DLRM training on one card (dlrm-rm2 at every width with
    TRAIN_ROWS rows a table): (a) K7's gradient at full width, (b) the
    train cell, (c) an exact resume at RESUME_ROWS rows, (d) the
    optimizers on the card against the CPU.  Returns (b)'s K7 launches."""
    import dataclasses
    import shutil

    from repro_torch import optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ArchBundle, get_arch
    from repro_torch.data import ClickLogStream, Prefetcher
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import DLRM, dlrm_loss

    t16 = time.perf_counter()
    live = torch.cuda.memory_allocated()
    check(live < GIB, f"[16] {live / GIB:.2f} GiB allocated before the train phase")
    rm2 = get_arch("dlrm-rm2")
    shape = rm2.shapes["train_batch"]
    cfg = dataclasses.replace(rm2.arch, rows_per_table=TRAIN_ROWS)
    f, d, b = cfg.n_sparse, cfg.embed_dim, shape.batch
    print(f"[16] {smi}; dlrm-rm2 train_batch at every width (B = {b}), rows per table "
          f"{TRAIN_ROWS} of {rm2.arch.rows_per_table}: state 4 x {f * TRAIN_ROWS * d * 4 / GIB:.2f}"
          f" GiB ({live / GIB:.2f} GiB allocated before)")
    batch0 = ClickLogStream(cfg, b, seed=0).batch_at(0)

    # ---- (a) K7's gradient at full width: the Function against the plain
    # version's autograd and a float64 sum of the same upstream rows
    t = time.perf_counter()
    model = DLRM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch0.items()}
    captured = []
    kernel_bag = ops.segment_bag

    def capturing(table, indices, weights=None):
        out = kernel_bag(table, indices, weights)
        out.register_hook(captured.append)
        return out

    def grads_of(lookup) -> tuple[float, dict]:
        model.zero_grad(set_to_none=True)
        ops.segment_bag = lookup
        try:
            loss, _ = dlrm_loss(model, tb)
            loss.backward()
        finally:
            ops.segment_bag = kernel_bag
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}

    ops.reset_launches()
    loss_k7, g_k7 = grads_of(capturing)
    check(ops.LAUNCHES["segment_bag"] == 1, "[16] (a) the forward did not launch K7 once")
    _, again = grads_of(kernel_bag)
    same = all(torch.equal(g_k7[n], again[n]) for n in g_k7)
    del again
    check(same, "[16] (a) two backward passes through K7's Function differ")
    loss_plain, g_plain = grads_of(lambda tbl, idx, w=None: ref.segment_bag_ref(tbl, idx, w))
    check(loss_plain == loss_k7, f"[16] (a) loss {loss_k7} through K7, {loss_plain} plain")
    bags = flat_bags(tb["sparse"], cfg.rows_per_table)
    ids = bags[bags >= 0].long()
    uniq, inv = torch.unique(ids, return_inverse=True)
    want, bound = grad_bound(captured[0], bags, uniq, inv)

    def table_grad_check(tag: str, grad: torch.Tensor) -> None:
        flat = grad.view(-1, d)
        got = flat[uniq].double()
        diff = (got - want).abs()
        allowed = 1e-5 * want.abs() + bound
        nonzero_elsewhere = int(torch.count_nonzero(flat)) - int(torch.count_nonzero(got))
        err = float(diff.max())
        check(bool((diff <= allowed).all()) and nonzero_elsewhere == 0,
              f"[16] (a) {tag}: table gradient off the float64 sum (max err {err:.3g}) "
              f"or {nonzero_elsewhere} nonzero entries in rows no bag reads")
        print(f"[16] (a) {tag}: table gradient at the {uniq.numel()} rows read (of "
              f"{f * cfg.rows_per_table}) vs the float64 sum of the same upstream rows: max abs "
              f"err {err:.3g}, max err / (1e-5·|want| + bound) "
              f"{float((diff / allowed.clamp(min=1e-30)).max()):.3g}; every other row exactly 0")

    table_grad_check("K7 Function", g_k7["tables"])
    table_grad_check("plain autograd", g_plain["tables"])
    worst_mlp = 0.0
    for name in g_k7:
        if name == "tables":
            continue
        ok, err = close(g_k7[name], g_plain[name], 1e-5, 1e-6)
        check(ok, f"[16] (a) the {name} gradients of the two paths differ: {err:.3g}")
        worst_mlp = max(worst_mlp, err)
    hot = int(torch.bincount(inv).max())
    print(f"[16] (a) loss {loss_k7:.6f} both paths; MLP gradients K7 path vs plain: max err "
          f"{worst_mlp:.3g} (rtol 1e-5 / atol 1e-6); two backward passes bitwise equal; the "
          f"table's rtol 1e-5 with an atol per entry of (n - 1)·2^-24·Σ|t| over its n lookups "
          f"(the bound of any f32 summation order; the hottest row takes {hot} lookups, whose "
          f"terms cancel); {time.perf_counter() - t:.1f}s")
    del model, g_k7, g_plain, tb, captured, want, bound, uniq, inv, ids, bags
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    check(live < GIB, f"[16] (a) left {live / GIB:.2f} GiB allocated")

    # ---- (b) the train cell, TRAIN_STEPS steps
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cell = build_cell(ArchBundle(cfg, {shape.name: shape}), shape.name, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[16] (b) {cell.name} built in {time.perf_counter() - t:.2f}s (params and AdamW "
          f"state zero: {torch.cuda.memory_allocated() / GIB:.2f} GiB), "
          f"n_params {cell.static_meta['n_params']}, {cell.static_meta['model_flops'] / 1e9:.1f} "
          f"GFLOP a step of MLP+interaction")
    inner_step, opt_events = cell.optimizer.step, []

    def timed_step(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner_step(*args, **kwargs)
        ev[1].record()
        opt_events.append(ev)
        return out

    cell.optimizer.step = timed_step
    stream = ClickLogStream(cfg, b, seed=0)
    pf = Prefetcher(stream.batch_at, depth=2)
    losses, step_ms, wall = [], [], []
    ops.reset_launches()
    try:
        for step in range(TRAIN_STEPS):
            got_step, batch = pf.get()
            check(got_step == step, f"[16] (b) the prefetcher gave step {got_step} for {step}")
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev[0].record()
            out = cell.fn(batch)
            ev[1].record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
            step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(out["loss"]))
    finally:
        pf.close()
    k7_train = ops.LAUNCHES["segment_bag"]
    peak = torch.cuda.max_memory_allocated()
    opt_ms = [s.elapsed_time(e) for s, e in opt_events]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"[16] (b) {smi}: {TRAIN_STEPS} steps, loss {' '.join(f'{x:.4f}' for x in losses)}")
    med = float(np.median(step_ms))
    print(f"[16] (b) step {med:.3f} ms median (CUDA events; min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}; host wall median {1e3 * float(np.median(wall)):.3f} ms), "
          f"{b / (med / 1e3):.0f} examples/s; optimizer pass {float(np.median(opt_ms)):.3f} ms "
          f"median ({100 * float(np.median(opt_ms)) / med:.1f}% of a step); peak "
          f"{peak / GIB:.2f} GiB against the reckoned {TRAIN_PEAK_GIB:.0f} GiB; K7 launched "
          f"{k7_train} times; mean loss of steps 1-5 {first:.5f}, of steps "
          f"{TRAIN_STEPS - 4}-{TRAIN_STEPS} {last:.5f}")
    check(k7_train == TRAIN_STEPS, f"[16] (b) K7 launched {k7_train} times in {TRAIN_STEPS} steps")
    check(all(np.isfinite(losses)) and last < first, "[16] (b) the loss is not finite or did "
          "not fall")
    tbatch = stream.batch_at(TRAIN_STEPS)
    trace_run("[16] (b) one train step", lambda: cell.fn(tbatch),
              {"K7": "segment_bag", "backward sort": ("Sort",), "backward segment sum":
               "segment_reduce", "GEMM (MLPs, bmm)": "gemm", "elementwise (optimizer, "
               "activations, zeroing)": "elementwise"})
    del cell.optimizer.step  # the wrapper, which holds the optimizer: no cycle left
    del cell, inner_step, timed_step, out
    torch.cuda.empty_cache()

    # ---- (c) exact resume at RESUME_ROWS rows
    rcfg = dataclasses.replace(cfg, rows_per_table=RESUME_ROWS)
    rbundle = ArchBundle(rcfg, {shape.name: shape})
    rstream = ClickLogStream(rcfg, b, seed=0)
    rbatches = [rstream.batch_at(step) for step in range(RESUME_STEPS)]
    half = RESUME_STEPS // 2
    straight = build_cell(rbundle, shape.name, device=dev, seed=0)
    for batch in rbatches:
        straight.fn(batch)
    want = {k: v.detach().clone() for k, v in straight.train_state()["params"].items()}
    del straight
    root = tempfile.mkdtemp(prefix="train_resume_")
    try:
        first_leg = build_cell(rbundle, shape.name, device=dev, seed=0)
        for batch in rbatches[:half]:
            first_leg.fn(batch)
        mgr = CheckpointManager(root, keep_last=1, save_every=1, async_writes=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        check(mgr.maybe_save(half - 1, first_leg.train_state(), {"stream_step": half}),
              "[16] (c) no checkpoint written")
        save_ms = (time.perf_counter() - t) * 1e3
        mb = sum(os.path.getsize(os.path.join(dp, fn)) for dp, _, fns in os.walk(root)
                 for fn in fns) / 1e6
        del first_leg
        resumed = build_cell(rbundle, shape.name, device=dev, seed=1)  # other weights
        t = time.perf_counter()
        state, meta, start = mgr.restore_or_init(resumed.train_state())
        resumed.load_train_state(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        mgr.ckpt.close()
        check(start == half and meta == {"stream_step": half}, f"[16] (c) resumed at {start}")
        for batch in rbatches[start:]:
            resumed.fn(batch)
        got = {k: v.detach() for k, v in resumed.train_state()["params"].items()}
        bitwise = all(torch.equal(got[k], want[k]) for k in want)
        worst = max(close(got[k], want[k], 0.0, 0.0)[1] for k in want)
        check(bitwise, f"[16] (c) the resumed params differ from the straight run's: {worst:.3g}")
        print(f"[16] (c) {smi}: {RESUME_STEPS} steps straight vs {half} + save + restore into "
              f"a cell of other weights + {RESUME_STEPS - half} at {RESUME_ROWS} rows: params "
              f"bitwise equal; save {save_ms:.1f} ms through CheckpointManager(async_writes=True)"
              f" ({mb:.1f} MB on disk: host copy, sha1, npz, commit), restore {restore_s:.2f}s")
        del resumed, state, got, want
    finally:
        shutil.rmtree(root)
    torch.cuda.empty_cache()

    # ---- (d) the optimizers on the card against the CPU, identical gradients
    rng = np.random.default_rng(16)
    shapes = {"stack": (3, 257, 130), "w": (33, 17), "b": (17,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (2.0 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(OPT_PARITY_STEPS)]
    for name in ("adamw", "adafactor", "sgd_momentum"):
        runs = {}
        for where in ("cpu", dev):
            params = {k: torch.nn.Parameter(torch.tensor(v, device=where))
                      for k, v in init.items()}
            opt = getattr(optim, name)(list(params.values()),
                                       lr=optim.cosine_with_warmup(1e-2, 2, OPT_PARITY_STEPS))
            for g in grads:
                for k, p in params.items():
                    p.grad = torch.tensor(g[k], device=where)
                opt.step()
            runs[str(where)] = (params, opt)
        (cpu_p, cpu_o), (gpu_p, gpu_o) = runs["cpu"], runs[str(dev)]
        worst = 0.0
        for k in shapes:
            pairs = [(gpu_p[k].detach(), cpu_p[k].detach())]
            pairs += [(gpu_o.state[gpu_p[k]][s], cpu_o.state[cpu_p[k]][s])
                      for s in cpu_o.state[cpu_p[k]] if s != "step"]
            for g_t, c_t in pairs:
                ok, err = close(g_t.cpu(), c_t, 1e-6, 1e-7)
                check(ok, f"[16] (d) {name}: the card's {k} differs from the CPU's: {err:.3g}")
                worst = max(worst, err)
        print(f"[16] (d) {name}, cosine_with_warmup, {OPT_PARITY_STEPS} steps ([3, 257, 130] "
              f"stacked leaf, [33, 17], [17]): card vs CPU max err {worst:.3g} (rtol 1e-6 / "
              f"atol 1e-7)")
    torch.cuda.empty_cache()
    print(f"[16] DLRM training ok in {time.perf_counter() - t16:.1f}s")
    return k7_train


# phase 10: durable, self-checking and served BC on phase 4's graph
SERVE_SAMPLE_K = 1024  # run_serving's sample: 8 rounds at batch 128
ADAPTIVE_SAMPLE_K = 2048  # the adaptive call's pool: at most 16 rounds
ADAPTIVE_THRESHOLD = 0.8  # its stop rule's top-10 Jaccard threshold


def manifest_ok(path: str) -> bool:
    """Whether a BCCheckpoint npz's sha1 manifest verifies, read with plain
    numpy and hashlib (not the port's loader)."""
    import hashlib

    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(str(arrays["manifest"]))
    return bool(manifest["sha1"]) and all(
        hashlib.sha1(np.ascontiguousarray(arrays[k]).tobytes()).hexdigest() == want
        for k, want in manifest["sha1"].items())


def durable_phase(dev, graph, groups, fused_ref) -> dict:
    """Phase 10: (a) kill and resume through a BCCheckpoint, (b) the ABFT
    checksum lane (K3/K4 at s + 1 on the square adjacency), (c) the
    integrity audit quarantining a corrupted block, (d) run_serving on one
    device (and its resume, and one adaptive call), (e) run_serving on the
    1×1 NCCL grid, fused and fused_sparse.  ``fused_ref`` is phase 4's
    uninterrupted fused BCResult.  Returns (b)'s launch counts."""
    from repro_torch.core.bc import (
        apply_sampling_rescale,
        betweenness_centrality,
        make_operator,
        make_round_fn,
    )
    from repro_torch.core.driver import CHECKSUM_TOL, BCDriver
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.distributed import BCCheckpoint, schedule_fingerprint
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_bc import run_serving
    from repro_torch.serving import (
        AdaptiveStopRule,
        BlockBudgetStop,
        eligible_roots,
        plan_sampling,
        top_k_indices,
    )

    t10 = time.perf_counter()
    kw = dict(batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed",
              sample_k=MAIN_SAMPLE_K, sample_seed=0)

    def leg(tag, run):
        """One leg with the launch counts zeroed just before and read just
        after; host wall, synchronised."""
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        print(f"[10] {tag}: wall {wall:.3f}s, launches {counts}")
        return out, wall, dict(ops.LAUNCHES)

    def same_bc(tag, got, want):
        ok, err = close(torch.from_numpy(got), torch.from_numpy(want), 1e-5, 1e-5)
        print(f"[10] {tag}: max abs err {err:.3g} (rtol 1e-5 / atol 1e-5)")
        check(ok, f"[10] {tag}: BC disagrees")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        # ---- (a) kill and resume
        path = os.path.join(tmp, "a.npz")
        part, wall_a1, _ = leg("(a) fused, stopped after 2 of 4 blocks", lambda: (
            betweenness_centrality(graph, engine_kind="fused", checkpoint=BCCheckpoint(path),
                                   checkpoint_every=1, stop_rule=BlockBudgetStop(2),
                                   device="cuda", **kw)))
        check(part.stopped_early and part.rounds_run == 2, "[10] (a) the budget did not stop "
              f"the run after 2 rounds ({part.rounds_run})")
        check(manifest_ok(path), "[10] (a) the snapshot's sha1 manifest does not verify")
        rest, wall_a2, la = leg("(a) fused, a fresh call resuming the snapshot", lambda: (
            betweenness_centrality(graph, engine_kind="fused", checkpoint=BCCheckpoint(path),
                                   checkpoint_every=1, device="cuda", **kw)))
        check(rest.rounds_run == 2 and rest.recovery_stats["resumed_generation"] == 0,
              f"[10] (a) the resumed call ran {rest.rounds_run} rounds, not the 2 uncommitted")
        check(la["frontier_spmm"] > 0 and la["dependency_spmm"] > 0, "[10] (a) no K1/K2")
        check(manifest_ok(path), "[10] (a) the final snapshot's sha1 manifest does not verify")
        same_bc("(a) resumed vs phase 4's uninterrupted fused run", rest.bc, fused_ref.bc)
        snap = BCCheckpoint(os.path.join(tmp, "save.npz"))
        fp = schedule_fingerprint(graph.n, rest.schedule)
        ns = {int(v): 1.0 for v in range(MAIN_SAMPLE_K)}
        snap.save(rest.bc, ns, list(range(4)), fp)  # warm-up (file creation)
        t = time.perf_counter()
        snap.save(rest.bc, ns, list(range(4)), fp)
        save_ms = (time.perf_counter() - t) * 1e3
        print(f"[10] (a) one BCCheckpoint.save of an f64 [{graph.n}] BC, {len(ns)} n_s entries "
              f"and the manifest: {save_ms:.3f} ms ({os.path.getsize(snap.path) / 1e6:.3f} MB, "
              f"{snap.generations} generations rotated); manifest verified with numpy + "
              f"hashlib")

        # ---- (b) the ABFT checksum lane on FusedDenseOperator
        plan = plan_sampling(eligible_roots(graph), "fixed", None, MAIN_SAMPLE_K, 0)
        schedule, prep, residual, omega_np = build_schedule(
            graph, batch_size=MAIN_BATCH, heuristics="h0", roots=plan.roots)
        omega = torch.from_numpy(omega_np).to(dev, torch.float32)

        def driver_run(integrity, round_fn=None):
            """The 4 rounds through BCDriver on the fused operator with
            ``round_fn(op)`` (default: make_round_fn with ``integrity``)."""
            op = make_operator(residual, "fused", dev)
            fn = round_fn(op) if round_fn else make_round_fn(op, omega, integrity=integrity)
            res = BCDriver(fn, schedule, n=graph.n, device=dev, prep=prep,
                           integrity=integrity).run()
            return apply_sampling_rescale(res, plan)

        checked, wall_b, lb = leg("(b) BCDriver integrity='checksum' on FusedDenseOperator",
                                  lambda: driver_run("checksum"))
        ist = checked.recovery_stats["integrity"]
        print(f"[10] (b) max checksum residual {ist['max_checksum_residual']:.3g} (CHECKSUM_TOL "
              f"{CHECKSUM_TOL:g}), checksum failures {ist['checksum_failures']}, audit "
              f"failures {ist['audit_failures']}; K3 (s = {MAIN_BATCH + 1}) "
              f"x{lb['frontier_spmm_partial']}, K4 (s = {MAIN_BATCH + 1}: the h0 rounds ship "
              f"no derived slot) "
              f"x{lb['dependency_spmm_partial']}; levels per round {checked.round_levels}; "
              f"wall {wall_b:.3f}s against (a)'s {wall_a1:.3f} + {wall_a2:.3f}s and phase 4's "
              f"unchecked fused call")
        check(ist["max_checksum_residual"] < CHECKSUM_TOL and ist["checksum_failures"] == 0
              and ist["audit_failures"] == 0, "[10] (b) the checksum lane failed on a clean run")
        check(kernel_launches(lb, "frontier_spmm_partial") > 0
              and kernel_launches(lb, "dependency_spmm_partial") > 0
              and lb["frontier_spmm"] == lb["dependency_spmm"] == 0,
              "[10] (b) the checked steps did not run on K3/K4 alone")
        check(checked.rounds_run == MAIN_SAMPLE_K // MAIN_BATCH, "[10] (b) expected 4 rounds")
        same_bc("(b) checksum run vs phase 4's unchecked fused run", checked.bc, fused_ref.bc)

        # ---- (c) integrity="audit" quarantines a corrupted block
        def corrupt_first(op):
            """The audit round function; its first call's lane-0 BC comes
            back as 2·bc + 1 (tests/test_chaos.py's flip)."""
            base = make_round_fn(op, omega, integrity="audit")
            calls = [0]

            def fn(sources, derived):
                out = base(sources, derived)
                calls[0] += 1
                if calls[0] == 1:
                    out = (2.0 * out[0] + 1.0,) + tuple(out[1:])
                return out

            return fn

        audited, _, _ = leg("(c) BCDriver integrity='audit', first block corrupted",
                            lambda: driver_run("audit", round_fn=corrupt_first))
        rec = audited.recovery_stats
        print(f"[10] (c) audit failures {rec['integrity']['audit_failures']}, retries "
              f"{rec['retries']}, quarantined blocks {rec['quarantined_blocks']}")
        check(rec["integrity"]["audit_failures"] == 1 and rec["retries"] == 1,
              "[10] (c) the audit did not quarantine the corrupted block exactly once")
        same_bc("(c) audited run vs the clean fused run", audited.bc, fused_ref.bc)

        # ---- (d) run_serving on one device
        serve_kw = dict(batch_size=MAIN_BATCH, engine="fused", sampling="fixed",
                        sample_k=SERVE_SAMPLE_K, sample_seed=0, refresh_blocks=2, generations=3)
        straight, _, _ = leg(f"(d) a straight sampled call, k = {SERVE_SAMPLE_K}", lambda: (
            betweenness_centrality(graph, engine_kind="fused", batch_size=MAIN_BATCH,
                                   heuristics="h0", sampling="fixed",
                                   sample_k=SERVE_SAMPLE_K, sample_seed=0, device="cuda")))
        want_top = [int(v) for v in top_k_indices(straight.bc, 10)]

        def served(tag, out, ref_bc):
            st = out["stats"]
            check(st["queries"] == st["hits"] + st["stale_hits"] + st["misses"],
                  f"[10] {tag}: a query was not accounted exactly once ({st})")
            print(f"[10] {tag}: {st['queries']} queries = {st['hits']} hits + "
                  f"{st['stale_hits']} stale + {st['misses']} misses over "
                  f"{out['generations_published']} generations; slices "
                  + ", ".join(f"{r['rounds_run']} rounds {r['wall_s']:.3f}s"
                              for r in out["refresh_runs"]))
            got_top = out["final_top_k"]
            bc = out["final_bc"]
            ties = all(a == b or abs(bc[a] - bc[b]) <= 1e-5 * abs(bc[b])
                       for a, b in zip(got_top, want_top))
            check(got_top == want_top or ties,
                  f"[10] {tag}: final top 10 {got_top} != straight {want_top}")
            same_bc(f"{tag} final generation vs the straight call", bc, ref_bc)

        path_d = os.path.join(tmp, "d.npz")
        out, _, ld = leg("(d) run_serving, one device", lambda: run_serving(
            graph, None, ckpt_path=path_d, device=None, **serve_kw))
        served("(d) run_serving", out, straight.bc)
        check(ld["frontier_spmm"] > 0 and ld["dependency_spmm"] > 0, "[10] (d) no K1/K2")
        again, _, _ = leg("(d) run_serving again on the same checkpoint", lambda: run_serving(
            graph, None, ckpt_path=path_d, device=None, **serve_kw))
        first = again["history"][0]
        check(first["meta"].get("resumed") is True and first["generation"] == 1
              and sum(r["rounds_run"] for r in again["refresh_runs"]) == 0
              and again["stats"]["misses"] == 0,
              "[10] (d) the resumed server did not publish the committed generation first")
        print(f"[10] (d) resumed server: generation 1 published from the checkpoint "
              f"(resumed=True) before any round; {again['stats']}")
        # the default rule (threshold 1.0: the top-10 set unchanged twice
        # in a row) did not fire within 16 rounds on this graph; at 0.8 it
        # tolerates one swap at the set's edge between consecutive blocks
        rule = AdaptiveStopRule(top_k=10, window=2, min_blocks=3, threshold=ADAPTIVE_THRESHOLD)
        adaptive, _, _ = leg(f"(d) sampling='adaptive' over {ADAPTIVE_SAMPLE_K} roots, top-10 "
                             f"Jaccard >= {ADAPTIVE_THRESHOLD} twice", lambda: (
            betweenness_centrality(graph, engine_kind="fused", batch_size=MAIN_BATCH,
                                   heuristics="h0", sampling="adaptive", stop_rule=rule,
                                   sample_k=ADAPTIVE_SAMPLE_K, sample_seed=0, device="cuda")))
        st = adaptive.stop_stats
        print(f"[10] (d) adaptive: stop rule fired at block {st['fired_at_block']} "
              f"({adaptive.rounds_run} of {len(adaptive.schedule.rounds)} rounds, stability "
              f"history {st['stability']}), stopped early {adaptive.stopped_early}; top 10 "
              f"{[int(v) for v in top_k_indices(adaptive.bc, 10)]} against the 1024-root "
              f"straight call's {want_top}")
        check(adaptive.stopped_early and bool(np.isfinite(adaptive.bc).all()),
              "[10] (d) the adaptive stop rule did not fire, or its BC is not finite")

        # ---- (e) run_serving on the 1×1 NCCL grid
        for engine, tile in (("fused", None), ("fused_sparse", (128, 128))):
            kern = ("frontier_spmm_partial", "dependency_spmm_partial") if tile is None else (
                "frontier_spmm_sparse", "dependency_spmm_sparse")
            out, _, le = leg(f"(e) run_serving, 1x1 NCCL grid, {engine}", lambda: run_serving(
                graph, groups, ckpt_path=os.path.join(tmp, f"e_{engine}.npz"), tile=tile,
                device=None, **dict(serve_kw, engine=engine)))
            check(all(le[k] > 0 for k in kern), f"[10] (e) {engine}: {kern} not launched")
            served(f"(e) run_serving 1x1 {engine}", out, straight.bc)
    print(f"[10] durable, self-checking and served BC ok in {time.perf_counter() - t10:.1f}s")
    return lb


# phase 12: the ring schedules and the grid's checked steps
RING_POLICIES = ("expand", "expand+fold")
RING_ENGINES = ("fused", "fused_bf16", "fused_sparse", "fused_hybrid", "sparse")
STRIPS_BARRIER_PR17_S = 3.507  # phase 8 (b)'s fused_sparse strips wall, chip run 3 of PR 17
RING_KERNELS = ("frontier_spmm_partial", "dependency_spmm_partial", "frontier_spmm_sparse",
                "dependency_spmm_sparse")


def kernel_launches(launches: dict, name: str) -> int:
    """A kernel's launches: its plain and its ``acc``-mode count (K3–K6
    count the two apart, ``ops.LAUNCHES``)."""
    return launches[name] + launches.get(name + "_acc", 0)


class LevelCollectives:
    """Counts the collectives made inside the distributed operators' level
    steps (the package's work counter, active while a step runs), per
    group and kind, and the level steps, while entered."""

    KINDS = {"all-gather": "gather", "reduce-scatter": "reduce_scatter",
             "collective-permute": "hops", "all-reduce": "all_reduce"}
    STEPS = ("forward_level", "backward_level", "forward_level_checked",
             "backward_level_checked")

    def __init__(self, groups):
        from repro_torch.core.operators import DistributedFusedOperator, DistributedOperator
        from repro_torch.roofline import WorkCounter

        self.groups = groups
        self.classes = (DistributedOperator, DistributedFusedOperator)
        self.counter = WorkCounter()
        self.counts, self.levels, self.depth = {}, 0, 0

    def _group(self, group) -> str:
        for name in ("column", "row", "grid", "replica"):
            if group is getattr(self.groups, name):
                return name
        return "default" if group is None else "other"

    def __enter__(self):
        self.saved = []
        for cls in self.classes:
            for name in self.STEPS:
                self.saved.append((cls, name, cls.__dict__.get(name)))
                setattr(cls, name, self._step(getattr(cls, name)))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)
        for rec in self.counter.records:
            key = f"{self._group(rec['group'])}/{self.KINDS[rec['class']]}"
            self.counts[key] = self.counts.get(key, 0) + 1

    def _step(self, fn):
        def counted(op, *args, **kwargs):
            self.depth += 1
            self.levels += self.depth == 1
            if self.depth == 1:
                self.counter.__enter__()
            try:
                return fn(op, *args, **kwargs)
            finally:
                if self.depth == 1:
                    self.counter.__exit__()
                self.depth -= 1
        return counted


def ring_phase(dev, graph, groups, dense_ref, part_blk, blk_states, strips, strips_barrier,
               strips_barrier_wall, smi: str) -> list[dict]:
    """Phase 12: (a) phase 4's graph and roots through every distributed
    engine under both ring policies (and "auto" once) on the 1×1 NCCL
    grid, each equal to the single-device dense BC (``dense_ref``), with
    the acc modes of K3–K6 launched and nothing else, and the collectives
    of the level loop counted; (b) the ring steps of a real R > 1 cell in
    one process: cell (0, 0) of the 2×4 partition (``part_blk``, states
    ``blk_states``), K3/K4 chained in acc mode over its 2 column slabs and
    K5/K6 over its 2 tile slots, against the barrier partial, timed; (c)
    integrity="checksum" under "expand+fold", and a weighted
    integrity="audit" run; (d) phase 8 (b)'s strips under "expand+fold"
    against their barrier run (``strips_barrier``).  Returns the acc-mode
    rows of phase 7's kernel table."""
    from repro_torch.core.distributed import distributed_betweenness_centrality
    from repro_torch.core.driver import CHECKSUM_TOL
    from repro_torch.core.operators import auto_delta
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.blocked_spmm import nonzero_index
    from repro_torch.roofline import counter as work

    t12 = time.perf_counter()
    kw = dict(batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed", sample_k=MAIN_SAMPLE_K,
              sample_seed=0, full_result=True)

    def run(tag, g, want, **run_kw):
        """One 2-D call with the launch counts zeroed just before and read
        just after, the level loop's collectives counted; checked against
        ``want`` (a BCResult) to rtol 1e-5 / atol 1e-5."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with LevelCollectives(groups) as coll:
            t = time.perf_counter()
            res = distributed_betweenness_centrality(g, groups, **run_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        ok, err = close(torch.from_numpy(res.bc), torch.from_numpy(want.bc), 1e-5, 1e-5)
        a_level = {k: v / max(coll.levels, 1) for k, v in coll.counts.items()}
        print(f"[12] {tag}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), overlap "
              f"{res.layout_stats['overlap']}, levels per round {res.round_levels}, launches "
              f"{ {k: v for k, v in launches.items() if v} }, {coll.levels} level steps, "
              f"collectives in the level loop {coll.counts} ({a_level} a level), peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; max abs err {err:.3g} "
              f"[{smi}]")
        check(res.bc.shape == (g.n,) and bool(np.isfinite(res.bc).all()),
              f"[12] {tag}: BC must be finite of shape ({g.n},)")
        check(ok, f"[12] {tag}: BC disagrees with its reference")
        check(res.round_levels == want.round_levels, f"[12] {tag}: levels per round differ")
        return res, launches, coll, wall

    # ---- (a) every engine under both rings, on the main path's graph and roots
    ring_launches, ring_res = {}, {}
    for engine in RING_ENGINES:
        for policy in RING_POLICIES:
            tag = f"(a) rmat16 1x1 {engine} {policy}"
            res, launches, coll, _ = run(tag, graph, dense_ref, engine_kind=engine,
                                         overlap=policy, **kw)
            ring_launches[(engine, policy)] = launches
            ring_res[(engine, policy)] = res
            dense_cell = engine in ("fused", "fused_bf16")
            tiled = engine in ("fused_sparse", "fused_hybrid")
            if engine == "fused_hybrid":
                check(res.layout_stats["dense_cells"] == [[0]],
                      "[12] the bytes model should pick BCSR for the 1x1 R-MAT cell")
            check(launches["frontier_spmm"] + launches["dependency_spmm"] == 0,
                  f"[12] {tag}: launched K1/K2")
            for kname in RING_KERNELS:
                want_acc = dense_cell if "partial" in kname else tiled
                check(launches[kname] == 0, f"[12] {tag}: {kname} launched without acc")
                check((launches[kname + "_acc"] > 0) == want_acc,
                      f"[12] {tag}: {kname} acc launches {launches[kname + '_acc']}")
            check(coll.levels > 0, f"[12] {tag}: no level step ran")
            if policy == "expand+fold":
                check(not coll.counts, f"[12] {tag}: the 1x1 ring made collectives "
                      f"{coll.counts} in its level loop")
            torch.cuda.empty_cache()
    auto = run("(a) rmat16 1x1 fused auto", graph, dense_ref, engine_kind="fused",
               overlap="auto", **kw)[0]
    print(f"[12] (a) overlap='auto' on the 1x1 fused cell picked "
          f"{auto.layout_stats['overlap']!r}")

    # ---- (b) the ring steps of a real R > 1 cell, in one process
    R, chunk = part_blk.R, part_blk.chunk
    m = part_blk.C * chunk
    order = [(0 - t) % R for t in range(R)]  # the chunk rank (0, 0) holds at step t
    block = part_blk.cell_dense_block(0, 0, torch.float32, dev)
    slabs = part_blk.cell_dense_slabs(0, 0, torch.float32, dev)
    tiles, rows, cols = part_blk.cell_blocked_sparse(0, 0, 128, 128, device=dev)
    full_index = nonzero_index(tiles, rows, cols, m)
    slots = [slot + (nonzero_index(*slot, m),)
             for slot in part_blk.cell_ring_blocked_sparse(0, 0, 128, 128, device=dev)]
    valid = part_blk.dst_local[0, 0] != m
    idx = torch.from_numpy(np.stack([part_blk.dst_local[0, 0][valid],
                                     part_blk.src_local[0, 0][valid]]).astype(np.int64)).to(dev)
    csr = torch.sparse_coo_tensor(idx, torch.ones(idx.shape[1], device=dev),
                                  (m, R * chunk)).coalesce().to_sparse_csr()
    del idx
    check(slabs.shape == (R, m, chunk) and len(slots) == R,
          "[12] (b) the 2x4 cell should hold 2 slabs and 2 slots")
    print(f"[12] (b) cell (0, 0) of the 2x4 grid: block {tuple(block.shape)}, {R} slabs "
          f"{tuple(slabs.shape[1:])}; BCSR tile 128: {tiles.shape[0]} tiles "
          f"({full_index.col.numel()} nonzeros) against slots of "
          f"{[int(sl[0].shape[0]) for sl in slots]} tiles "
          f"({[int(sl[3].col.numel()) for sl in slots]} nonzeros)")
    entries = []
    for kname, s, replaces in (
        ("frontier_spmm_partial", MAIN_BATCH, "src/repro/kernels/frontier_spmm.py:178"),
        ("dependency_spmm_partial", MAIN_BATCH + MAIN_BATCH // 2,
         "src/repro/kernels/dependency_spmm.py:174"),
        ("frontier_spmm_sparse", MAIN_BATCH, "src/repro/kernels/blocked_spmm.py:144"),
        ("dependency_spmm_sparse", MAIN_BATCH + MAIN_BATCH // 2,
         "src/repro/kernels/blocked_spmm.py:146"),
    ):
        sigma, depth, delta, omega = blk_states[s]
        forward = kname.startswith("frontier")
        state = (sigma, depth) if forward else (sigma, depth, delta, omega)
        lvl = 2 if forward else 1
        parts = [tuple(x[r * chunk:(r + 1) * chunk].contiguous() for x in state) for r in order]
        fn = getattr(ops, kname)
        plain_fn = {"frontier_spmm_partial": ref.frontier_partial_ref,
                    "dependency_spmm_partial": ref.dependency_partial_ref,
                    "frontier_spmm_sparse": ref.frontier_sparse_ref,
                    "dependency_spmm_sparse": ref.dependency_sparse_ref}[kname]
        if "partial" in kname:
            operands = [(slabs[r],) for r in order]
            barrier = lambda: fn(block, *state, lvl)  # noqa: E731
            step = lambda op, st, acc: fn(*op, *st, lvl, acc)  # noqa: E731
            plain_step = lambda op, st, acc: plain_fn(*op, *st, lvl, acc)  # noqa: E731
            nbytes = work.partial_bytes(block, *state)
            nnz = m * R * chunk
        else:
            operands = [slots[r] for r in order]
            barrier = lambda: fn(tiles, rows, cols, *state, lvl, m=m,  # noqa: E731
                                 index=full_index)
            step = lambda op, st, acc: fn(*op[:3], *st, lvl, m=m, acc=acc,  # noqa: E731
                                          index=op[3])
            plain_step = lambda op, st, acc: plain_fn(*op[:3], *st, lvl, m, acc)  # noqa: E731
            nbytes = (sum(sl[3].ptr.nbytes + sl[3].col.nbytes + sl[3].val.nbytes for sl in slots)
                      + sum(x.nbytes for x in state) + m * s * 4)
            nnz = sum(int(sl[3].col.numel()) for sl in slots)

        def chain(step=step):
            acc = torch.zeros((m, s), device=dev)
            for op, st in zip(operands, parts):
                acc = step(op, st, acc)
            return acc

        want = barrier()
        got = chain()
        plain = chain(plain_step)
        exact = forward
        ok, err = close(got, want, 0.0 if exact else 1e-5, 0.0 if exact else 1e-6)
        ok_p, err_p = close(got, plain, 0.0 if exact else 1e-5, 0.0 if exact else 1e-6)
        check(ok, f"[12] (b) {kname}: the acc chain disagrees with the barrier partial "
              f"(err {err:.3g})")
        check(ok_p, f"[12] (b) {kname}: the acc chain disagrees with its plain version "
              f"(err {err_p:.3g})")
        chain_ms = cuda_time_ms(chain)
        barrier_ms = cuda_time_ms(barrier)
        plain_ms = cuda_time_ms(lambda: chain(plain_step))
        if "partial" in kname:
            operand = (sigma * (depth == 1) if forward else dep_operand(*state))
            lib_ms = cuda_time_ms(lambda: torch.matmul(block, operand))
            lib = "torch.matmul of the whole block"
        else:
            operand = (sigma * (depth == 1) if forward else dep_operand(*state))
            lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, operand), reps=20)
            lib = f"torch.sparse.mm of the cell as CSR ({csr.values().numel()} nonzeros)"
        del operand
        t_ops = work.sparse_flops(nnz, s) / PEAK_F32_FLOP_PER_S * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        engine = "fused" if "partial" in kname else "fused_sparse"
        launches = ring_launches[(engine, "expand+fold")][kname + "_acc"]
        entries.append({
            "name": f"{kname}[acc, ring chain over the {R} slots of 2x4 cell (0, 0), "
                    f"m={m}, k={R}x{chunk}, s={s}]",
            "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/partial_spmm.cu" if "partial" in kname
                       else "src/repro_torch/kernels/csrc/sparse_spmm.cu"),
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err_p,
            "ms": chain_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
        print(f"[12] (b) {kname} s={s}: acc chain of {R} launches {chain_ms:.3f} ms against the "
              f"barrier launch {barrier_ms:.3f} ms ({chain_ms / barrier_ms:.2f}x); plain chain "
              f"{plain_ms:.3f} ms; {lib} {lib_ms:.3f} ms; bound {bound:.4f} ms "
              f"({entries[-1]['bound_by']}); vs barrier err {err:.3g}, vs plain err {err_p:.3g}; "
              f"{launches} acc launches in (a)'s {engine} expand+fold run [{smi}]")
    del block, slabs, tiles, rows, cols, full_index, slots, csr
    torch.cuda.empty_cache()

    # ---- (c) checked runs: the checksum lane under a ring, a weighted audit
    checked, launches, _, _ = run("(c) rmat16 1x1 fused expand+fold checksum", graph,
                                  ring_res[("fused", "expand+fold")], engine_kind="fused",
                                  overlap="expand+fold", integrity="checksum", **kw)
    integ = checked.recovery_stats["integrity"]
    print(f"[12] (c) checksum under expand+fold: max residual {integ['max_checksum_residual']:.3g}"
          f" (tol {CHECKSUM_TOL:g}), failures {integ['checksum_failures']}, quarantined "
          f"{checked.recovery_stats['quarantined_blocks']}")
    check(integ["max_checksum_residual"] < CHECKSUM_TOL and integ["checksum_failures"] == 0
          and checked.recovery_stats["quarantined_blocks"] == 0,
          "[12] (c) the checksum run under expand+fold failed its audit")
    check(launches["frontier_spmm_partial_acc"] > 0 and launches["dependency_spmm_partial_acc"] > 0,
          "[12] (c) the checked ring run did not launch K3/K4 in acc mode")
    wgraph = rmat_graph(MAIN_N_SCALE, MAIN_EF, seed=1, weights="dyadic")
    delta = auto_delta(wgraph)
    w_kw = dict(batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed", sample_k=MAIN_BATCH,
                sample_seed=0, full_result=True, weighted=True, delta=delta, engine_kind="sparse")
    w_plain = distributed_betweenness_centrality(wgraph, groups, **w_kw)
    audited = run(f"(c) weighted rmat16 dyadic 1x1 sparse audit, delta {delta}", wgraph, w_plain,
                  integrity="audit", **w_kw)[0]
    print(f"[12] (c) weighted audit: quarantined {audited.recovery_stats['quarantined_blocks']}, "
          f"buckets per round {audited.round_levels}")
    check(audited.recovery_stats["quarantined_blocks"] == 0,
          "[12] (c) the weighted audit quarantined a healthy block")
    del checked, audited, w_plain
    torch.cuda.empty_cache()

    # ---- (d) the strips under expand+fold, against their barrier run
    _, _, coll, wall = run("(d) strips 1x1 fused_sparse expand+fold", strips, strips_barrier,
                           engine_kind="fused_sparse", overlap="expand+fold",
                           batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed",
                           sample_k=STRIP_SAMPLE_K, sample_seed=0, full_result=True)
    print(f"[12] (d) strips fused_sparse: expand+fold wall {wall:.3f}s beside the barrier's "
          f"{strips_barrier_wall:.3f}s in phase 8 (b) of this run and {STRIPS_BARRIER_PR17_S}s "
          f"in chip run 3 of PR 17 (recorded, no claim) [{smi}]")
    print(f"[12] ring phase ok in {time.perf_counter() - t12:.1f}s")
    return entries


# phase 13: the multi-ledger straggler loop and the grid's recovery knobs
SKEW_PAIRS, SKEW_BLOCK = 128, 128  # (b): skewed_depth_graph, n = 32 768
# (b)'s roots: the first 9 components, one round each at batch 128.  An odd
# count: with 8 rounds on 2 lanes neither queue runs dry before the other,
# so "steal" would never run a tail duplicate
SKEW_COMPONENTS = 9
K3_K4 = ("frontier_spmm_partial", "dependency_spmm_partial")


class LogLines(logging.Handler):
    """The messages a logger emits while this handler is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())


class StalledOnce:
    """A round function that sleeps ``seconds`` before its ``at``-th call
    (counted from 0, retries included): one wedged dispatch."""

    def __init__(self, fn, at: int, seconds: float):
        self.fn, self.at, self.seconds, self.calls = fn, at, seconds, 0

    def __call__(self, sources, derived):
        if self.calls == self.at:
            time.sleep(self.seconds)
        self.calls += 1
        return self.fn(sources, derived)


def straggler_phase(dev, graph, groups, fused_ref, fused_2d_bc: np.ndarray, smi: str) -> None:
    """Phase 13: (a) phase 4's graph and roots through ``BCDriver`` with two
    lanes a block on one card (``make_round_fn`` runs the lanes one after
    the other; K1/K2) under "none", "steal" and "redeal", each equal to
    phase 4's fused BC; (b) skewed_depth_graph(128, 128) (n = 32 768,
    128-vertex paths beside 128-cliques), the roots of its first 9
    components (9 rounds, deep and shallow alternating on the dense
    engine), on the same two-lane fused driver under "redeal" (>= 1 redeal)
    and "steal" (the tail duplicate discarded), each equal to the dense
    engine; (c) (b) under "steal" with one dispatch stalled past a
    watchdog deadline of twice (b)'s slowest block + 1 s and no retry: one
    re-mesh, one dead replica, BC unchanged; (d) on the 1×1 NCCL grid,
    "steal" refused (fr = 1), then fused with dispatch_deadline_s="auto",
    max_retries=1 and numeric_guard=True, equal to phase 5's fused BC, the
    logged auto deadline and expected wall printed.  Each run's launch
    counts are zeroed just before it and read just after."""
    from repro_torch.core.bc import apply_sampling_rescale, make_operator, make_round_fn
    from repro_torch.core.distributed import distributed_betweenness_centrality
    from repro_torch.core.driver import BCDriver
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.graphs import skewed_depth_graph
    from repro_torch.kernels import ops
    from repro_torch.serving.sampling import eligible_roots, plan_sampling

    t13 = time.perf_counter()
    print(f"[13] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")

    def drive(tag, fn, schedule, n, prep, **kw):
        """One BCDriver run, two lanes a block, timed and launch-counted."""
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        res = BCDriver(fn, schedule, n=n, device=dev, prep=prep, rounds_per_dispatch=2,
                       **kw).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        k1 = kernel_launches(launches, "frontier_spmm")
        k2 = kernel_launches(launches, "dependency_spmm")
        check(k1 > 0 and k2 > 0, f"[13] {tag}: the run did not launch K1 and K2")
        check(sum(kernel_launches(launches, k) for k in K3_K4) == 0,
              f"[13] {tag}: launched K3/K4")
        st = res.straggler_stats
        policy = ("" if st is None else
                  f", stolen {st['rounds_stolen']}, re-dealt {st['rounds_redealt']} "
                  f"({st['redeal_events']} events), duplicates {st['duplicates_discarded']}/"
                  f"{st['duplicates_dispatched']} discarded, idle_s_est {st['idle_s_est']:.3f}s, "
                  f"rounds per lane {st['per_replica_rounds']}")
        print(f"[13] {tag}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), {res.rounds_run} "
              f"rounds, levels in commit order {res.round_levels}, block_times "
              f"{[round(b, 4) for b in res.block_times]} s{policy}, K1 {k1} / K2 {k2} launches "
              f"({smi})")
        return res

    def held(tag, got, want):
        ok, err = close(torch.from_numpy(got), torch.from_numpy(want), 1e-5, 1e-5)
        print(f"[13] {tag}: max abs err {err:.3g}")
        check(ok, f"[13] {tag}: BC disagrees")

    # (a) phase 4's graph and roots, two lanes a block
    plan = plan_sampling(eligible_roots(graph), "fixed", None, MAIN_SAMPLE_K, 0)
    schedule, prep, residual, omega_np = build_schedule(graph, batch_size=MAIN_BATCH,
                                                        heuristics="h0", roots=plan.roots)
    check(len(schedule.rounds) == MAIN_SAMPLE_K // MAIN_BATCH, "[13] (a) expected 4 rounds")
    omega = torch.from_numpy(omega_np).to(device=dev, dtype=torch.float32)
    fn = make_round_fn(make_operator(residual, "fused", dev), omega)
    for policy in ("none", "steal", "redeal"):
        res = apply_sampling_rescale(
            drive(f"(a) rmat16 {policy}", fn, schedule, graph.n, prep, straggler=policy,
                  profile=policy == "none"), plan)
        check(res.rounds_run == len(schedule.rounds), f"[13] (a) {policy}: rounds run")
        held(f"(a) {policy} vs phase 4's fused", res.bc, fused_ref.bc)
    del fn
    torch.cuda.empty_cache()

    # (b) deep and shallow rounds side by side
    g = skewed_depth_graph(SKEW_PAIRS, SKEW_BLOCK)
    roots = np.arange(SKEW_COMPONENTS * SKEW_BLOCK)
    schedule, prep, residual, omega_np = build_schedule(g, batch_size=MAIN_BATCH,
                                                        heuristics="h0", roots=roots)
    check(len(schedule.rounds) == SKEW_COMPONENTS, f"[13] (b) expected {SKEW_COMPONENTS} rounds")
    omega = torch.from_numpy(omega_np).to(device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dense = BCDriver(make_round_fn(make_operator(residual, "dense", dev), omega), schedule,
                     n=g.n, device=dev, prep=prep).run()
    torch.cuda.synchronize()
    lv = dense.round_levels
    print(f"[13] (b) skewed_depth_graph({SKEW_PAIRS}, {SKEW_BLOCK}): n={g.n} m={g.num_edges}, "
          f"roots of the first {SKEW_COMPONENTS} components; dense engine, one lane: wall "
          f"{time.perf_counter() - t:.3f}s, levels per round {lv} ({smi})")
    check(all(lv[i] > 4 * lv[i + 1] if i % 2 == 0 else 4 * lv[i] < lv[i + 1]
              for i in range(len(lv) - 1)), "[13] (b) rounds do not alternate deep / shallow")
    torch.cuda.empty_cache()
    fn = make_round_fn(make_operator(residual, "fused", dev), omega)
    walls = []
    for policy in ("redeal", "steal"):
        res = drive(f"(b) skewed {policy}", fn, schedule, g.n, prep, straggler=policy)
        st = res.straggler_stats
        check(res.rounds_run == SKEW_COMPONENTS, f"[13] (b) {policy}: rounds run")
        if policy == "redeal":
            check(st["redeal_events"] >= 1, "[13] (b) redeal: no redeal event")
        else:
            check(st["duplicates_discarded"] == st["duplicates_dispatched"] >= 1,
                  "[13] (b) steal: the tail duplicate was not discarded")
        held(f"(b) {policy} vs the dense engine", res.bc, dense.bc)
        walls += res.block_times

    # (c) one dispatch wedged past the watchdog's deadline, no retry budget
    deadline = 2.0 * max(walls) + 1.0
    res = drive("(c) skewed steal, dispatch 1 stalled", StalledOnce(fn, 1, deadline + 0.5),
                schedule, g.n, prep, straggler="steal", dispatch_deadline_s=deadline,
                max_retries=0)
    rec = res.recovery_stats
    integ = rec["integrity"]
    print(f"[13] (c) deadline {deadline:.3f}s (twice (b)'s slowest block {max(walls):.3f}s + 1 s), "
          f"stall {deadline + 0.5:.3f}s: watchdog trips {integ['watchdog_trips']}, escalations "
          f"{integ['watchdog_escalations']}, re-mesh events {rec['remesh_events']}, dead "
          f"replicas {rec['dead_replicas']} ({smi})")
    check(rec["remesh_events"] == 1 and len(rec["dead_replicas"]) == 1,
          "[13] (c) expected one re-mesh and one dead replica")
    check(res.rounds_run == SKEW_COMPONENTS, "[13] (c) rounds run")
    held("(c) after the re-mesh vs the dense engine", res.bc, dense.bc)
    del fn, dense
    torch.cuda.empty_cache()

    # (d) the 1×1 NCCL grid: no replicas to deal between; the auto watchdog
    kw = dict(batch_size=MAIN_BATCH, heuristics="h0", engine_kind="fused", sampling="fixed",
              sample_k=MAIN_SAMPLE_K, sample_seed=0, full_result=True)
    try:
        distributed_betweenness_centrality(graph, groups, straggler="steal", **kw)
        fail("[13] (d) the 1x1 grid accepted a straggler policy")
    except ValueError as err:
        print(f"[13] (d) 1x1 grid, straggler='steal' refused: {err}")
    log = logging.getLogger("repro_torch.core.distributed")
    lines, level = LogLines(), log.level
    log.addHandler(lines)
    log.setLevel(logging.INFO)
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        res = distributed_betweenness_centrality(graph, groups, dispatch_deadline_s="auto",
                                                 max_retries=1, numeric_guard=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        log.removeHandler(lines)
        log.setLevel(level)
    launches = dict(ops.LAUNCHES)
    check(all(kernel_launches(launches, k) > 0 for k in K3_K4)
          and launches["frontier_spmm"] + launches["dependency_spmm"] == 0,
          "[13] (d) expected K3/K4 launches and none of K1/K2")
    for line in lines.lines:
        if line.startswith(("dispatch watchdog", "sampling[")):
            print(f"[13] (d) logged: {line}")
    check(any(line.startswith("dispatch watchdog: auto deadline") for line in lines.lines),
          "[13] (d) no auto deadline was logged")
    rec = res.recovery_stats
    print(f"[13] (d) 1x1 fused, auto watchdog, max_retries=1, numeric_guard: wall {wall:.3f}s "
          f"(round loop {res.wall_s:.3f}s), K3 {kernel_launches(launches, K3_K4[0])} / K4 "
          f"{kernel_launches(launches, K3_K4[1])} launches, retries {rec['retries']}, quarantined "
          f"{rec['quarantined_blocks']}, watchdog trips {rec['integrity']['watchdog_trips']} "
          f"({smi})")
    check(rec["retries"] == 0 and rec["quarantined_blocks"] == 0, "[13] (d) a healthy run retried")
    held("(d) vs phase 5's fused run", res.bc, fused_2d_bc)
    print(f"[13] straggler phase ok in {time.perf_counter() - t13:.1f}s")


# phase 14: measured-cost autotuning and the chaos harness
# (c): five rounds of 128 roots on two lanes, so the last block runs a
# tail duplicate (four rounds fill both lanes to the end)
CHAOS_SAMPLE_K = 640
K1_K6 = ("frontier_spmm", "dependency_spmm", "frontier_spmm_partial", "dependency_spmm_partial",
         "frontier_spmm_sparse", "dependency_spmm_sparse")


def autotune_chaos_phase(dev, graph, groups, fused_2d_bc: np.ndarray, smi: str) -> dict:
    """Phase 14 on phase 4's graph and roots (batch 128, h0, 512 fixed
    roots): (a) on the 1×1 NCCL grid, fused_hybrid under overlap="auto"
    with autotune="measure" on a fresh cache file (the plan's report, its
    per-tile / calibration / per-policy walls, the planner's wall, the
    resolved policy, tile and hybrid cells), then autotune="cache" on the
    file (no measurement, the same picks, bit-equal BC), then fused with
    autotune="cache" and the "auto" watchdog (the measured round prior
    beside the round wall and the roofline prior); (b) chaos on the 1×1
    grid, fused: transient + poison under the numeric guard, flip under
    audit and checksum, a stall past the deadline with one retry, a kill
    refused (fr = 1), crash / torn save / generational resume on a
    BCCheckpoint, a garbled cost cache read back empty; (c) two lanes a
    block on one card (phase 13's make_round_fn driver, K1/K2) under
    "steal" with audit: a replica kill re-meshed, a deep flip of the tail
    duplicate caught by the vote alone.  Every BC is held against its
    reference (phase 5's fused BC, or (c)'s clean run, itself held against
    a one-lane run of the same schedule) at rtol 1e-5 / atol 1e-5; each
    run's launch counts are zeroed just before it and read just after.
    Returns ``(rows, other)``: the launches of K1–K6 by the phase 7 row
    whose configuration they ran at (``{row: {kernel: launches}}``, a row
    named by what follows ``kernel[`` in its name; the planner's timings
    are told apart candidate by candidate through a counting wrapper
    around its bench), and the launches at configurations phase 7 has no
    row for (``acc`` mode on the 1×1 grid, BCSR tile 64)."""
    from repro_torch.autotune import CostCache, measure
    from repro_torch.core.bc import make_operator, make_round_fn
    from repro_torch.core.distributed import (
        PRIOR_LEVELS,
        distributed_betweenness_centrality,
        prior_round_seconds,
    )
    from repro_torch.core.driver import BCDriver
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.distributed import BCCheckpoint
    from repro_torch.distributed.chaos import ChaosCrash, ChaosRoundFn
    from repro_torch.distributed.fault_tolerance import ReplicaLostError
    from repro_torch.graphs import partition_2d
    from repro_torch.kernels import ops
    from repro_torch.serving import BlockBudgetStop
    from repro_torch.serving.sampling import eligible_roots, plan_sampling

    t14 = time.perf_counter()
    print(f"[14] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    total: dict[str, int] = {}
    rows: dict[str, dict[str, int]] = {}
    other: dict[str, int] = {}
    timings: list = []  # (Candidate, launches) of the planner's timings in the current run
    kw = dict(batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed", sample_k=MAIN_SAMPLE_K,
              sample_seed=0, full_result=True)

    def row_of(kname, tile, integrity):
        """Phase 7's row (its name after ``kname[``) at the configuration of
        a plain launch of ``kname`` on phase 4's graph: K1/K2 on the f32
        adjacency, K3/K4 on the 1×1 f32 block (the checksum-lane row under
        integrity="checksum"), K5/K6 at a square tile phase 8 times; None
        where phase 7 has no such row."""
        if kname in ("frontier_spmm", "dependency_spmm"):
            return "f32 A]"
        if kname in ("frontier_spmm_partial", "dependency_spmm_partial"):
            return "f32 A, checksum lane" if integrity == "checksum" else "f32 A, 1x1 block"
        if (kname in ("frontier_spmm_sparse", "dependency_spmm_sparse") and tile is not None
                and tile[0] == tile[1] and tile[0] in (128, SPARSE_TILE)):
            return f"rmat16 1x1 tile {tile[0]}:"
        return None

    def credit(launches, tile, integrity):
        for k, v in launches.items():
            if not v:
                continue
            total[k] = total.get(k, 0) + v
            row = None if k.endswith("_acc") else row_of(k, tile, integrity)
            into = other if row is None else rows.setdefault(row, {})
            into[k] = into.get(k, 0) + v

    def counted(fn, integrity="off"):
        """``fn()`` with the launch counts zeroed just before and read just
        after, credited to phase 7's rows: the planner's timings by their
        candidate's tile, the rest by the run's tile and ``integrity``.
        Returns ``(result, launches, wall)``."""
        torch.cuda.synchronize()
        ops.reset_launches()
        timings.clear()
        out = None
        t = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
            return out, dict(ops.LAUNCHES), time.perf_counter() - t
        finally:
            rest = dict(ops.LAUNCHES)
            for cand, launches in timings:
                credit(launches, cand.tile, "off")
                for k, v in launches.items():
                    rest[k] -= v
            credit(rest, (getattr(out, "layout_stats", None) or {}).get("tile"), integrity)

    real_bench = measure.default_bench

    def counting_bench(*args, **kwargs):
        """The planner's bench, each timing's launches kept with its
        candidate (they still count in the run's total)."""
        bench = real_bench(*args, **kwargs)

        def timed(cand):
            before = dict(ops.LAUNCHES)
            rec = bench(cand)
            timings.append((cand, {k: v - before.get(k, 0) for k, v in ops.LAUNCHES.items()}))
            return rec

        return timed

    measure.default_bench = counting_bench  # restored at the phase's end

    def held(tag, got, want):
        ok, err = close(torch.from_numpy(got), torch.from_numpy(want), 1e-5, 1e-5)
        print(f"[14] {tag}: max abs err {err:.3g}")
        check(ok, f"[14] {tag}: BC disagrees")

    def run(tag, full=True, **extra):
        """One run on the 1×1 grid; a full one is held against phase 5's."""
        res, launches, wall = counted(
            lambda: distributed_betweenness_centrality(graph, groups, **kw, **extra),
            extra.get("integrity", "off"))
        check(res.bc.shape == (graph.n,) and bool(np.isfinite(res.bc).all()),
              f"[14] {tag}: BC must be finite of shape ({graph.n},)")
        print(f"[14] {tag}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), {res.rounds_run} "
              f"rounds, levels {res.round_levels}, overlap {res.layout_stats['overlap']}, "
              f"launches {dict((k, v) for k, v in launches.items() if v)} ({smi})")
        print(f"[14] {tag}: recovery_stats {res.recovery_stats}")
        if full:
            held(f"{tag} vs phase 5's fused", res.bc, fused_2d_bc)
        return res, launches

    def refused(tag, exc, **extra):
        try:
            counted(lambda: distributed_betweenness_centrality(graph, groups, **kw, **extra),
                    extra.get("integrity", "off"))
        except exc as err:
            print(f"[14] {tag}: {type(err).__name__}: {err} ({smi})")
            return
        fail(f"[14] {tag}: expected {exc.__name__}")

    def logged(logger_name, level, fn):
        log = logging.getLogger(logger_name)
        lines, old = LogLines(), log.level
        log.addHandler(lines)
        log.setLevel(level)
        try:
            return fn(), lines.lines
        finally:
            log.removeHandler(lines)
            log.setLevel(old)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        path = os.path.join(tmp, "tune.json")
        # (a) autotune on the 1x1 grid
        tiles = partition_2d(graph, 1, 1).tile_candidates()
        tuned = dict(engine_kind="fused_hybrid", overlap="auto", autotune_cache=path)
        res_m, l_m = run("(a) fused_hybrid auto, autotune=measure (fresh cache)",
                         autotune="measure", **tuned)
        rep, lay = res_m.layout_stats["autotune"], res_m.layout_stats
        recs = CostCache(path).entries[rep["graph_key"]]
        level_s = {ckey: rec.level_s for ckey, rec in recs.items()}
        tile = tuple(rep["tile"])
        cell_costs = (recs[f"fused|none|b{MAIN_BATCH}|t-"].level_s,
                      recs[f"fused_sparse|none|b{MAIN_BATCH}|t{tile[0]}x{tile[1]}"].level_s)
        print(f"[14] (a) plan: {rep}")
        print(f"[14] (a) measured s/level by config: {level_s}; tile candidates {tiles}; "
              f"cell_costs (dense, sparse) {cell_costs}; planner wall {lay['autotune_s']:.3f}s; "
              f"resolved overlap {lay['overlap']}, tile {lay['tile']}, dense cells "
              f"{lay['dense_cells']} ({smi})")
        check(rep["measured"] == len(tiles) + 1 + 3 and rep["hits"] == 1,
              "[14] (a) expected every tile, the dense calibration and three policies measured "
              "and the sparse calibration a hit")
        check(rep["tile_source"] == "measured" and rep["cell_costs_measured"],
              "[14] (a) the tile and the hybrid calibration must be measured")
        check(all(kernel_launches(l_m, k) > 0 for k in K1_K6[2:])
              and l_m["frontier_spmm"] + l_m["dependency_spmm"] == 0,
              "[14] (a) expected K3-K6 launches (the plan's candidates) and none of K1/K2")
        res_c, _ = run("(a) fused_hybrid auto, autotune=cache (the same file)",
                       autotune="cache", **tuned)
        rep_c = res_c.layout_stats["autotune"]
        check(rep_c["measured"] == 0 and rep_c["misses"] == 0
              and rep_c["hits"] == rep["hits"] + rep["measured"],
              "[14] (a) the cache run measured or missed")
        check(all(res_c.layout_stats[k] == lay[k] for k in ("overlap", "tile", "dense_cells"))
              and rep_c["overlap_level_s"] == rep["overlap_level_s"],
              "[14] (a) the cache run picked differently")
        check(bool(np.array_equal(res_c.bc, res_m.bc)), "[14] (a) the cache run's BC differs")
        print(f"[14] (a) cache run: {rep_c['hits']} hits, 0 measured, same picks, BC bit-equal")
        (res_f, _), lines = logged("repro_torch.core.distributed", logging.INFO, lambda: run(
            "(a) fused, autotune=cache, dispatch_deadline_s='auto'", engine_kind="fused",
            autotune="cache", autotune_cache=path, dispatch_deadline_s="auto"))
        rep_f = res_f.layout_stats["autotune"]
        check(rep_f["measured"] == 0 and rep_f["hits"] == 1, "[14] (a) fused: expected one hit")
        for line in lines:
            if line.startswith(("dispatch watchdog", "sampling[")):
                print(f"[14] (a) logged: {line}")
        round_s = res_f.wall_s / res_f.rounds_run
        measured_prior = rep_f["overlap_level_s"]["none"] * PRIOR_LEVELS
        roofline_prior = prior_round_seconds(partition_2d(graph, 1, 1), "fused", MAIN_BATCH, "none")
        print(f"[14] (a) round prior: measured {measured_prior:.4f}s ({PRIOR_LEVELS} x "
              f"{rep_f['overlap_level_s']['none']:.6f} s/level) = {measured_prior / round_s:.2f}x "
              f"the measured round wall {round_s:.4f}s (levels {res_f.round_levels}); the "
              f"roofline prior {roofline_prior:.4f}s = {roofline_prior / round_s:.2f}x ({smi})")

        # (b) chaos on the 1x1 grid, fused
        fused = dict(engine_kind="fused", retry_backoff_s=0.01)
        res, _ = run("(b) transient@1x2 + poison@3:nan", chaos="seed=7;transient@1x2;poison@3:nan",
                     **fused)
        rec = res.recovery_stats
        check(rec["transient_errors"] == 2 and rec["quarantined_blocks"] == 1
              and rec["fallback_recomputes"] == 1 and res.rounds_run == 4,
              "[14] (b) transient + poison: expected 2 transient retries, one block quarantined "
              "and recomputed through the fallback")
        for mode in ("audit", "checksum"):
            res, _ = run(f"(b) flip@2 under integrity={mode}", chaos="seed=7;flip@2",
                         integrity=mode, **fused)
            integ = res.recovery_stats["integrity"]
            check(integ["checksum_failures"] + integ["audit_failures"] >= 1
                  and res.recovery_stats["quarantined_blocks"] >= 1,
                  f"[14] (b) flip under {mode} was not detected")
        deadline = 2.0 * round_s + 1.0
        stall_ms = int((deadline + 0.5) * 1e3)
        res, _ = run(f"(b) stall@3:{stall_ms} (deadline {deadline:.3f}s, max_retries=1)",
                     chaos=f"seed=7;stall@3:{stall_ms}", dispatch_deadline_s=deadline,
                     max_retries=1, **fused)
        integ = res.recovery_stats["integrity"]
        check(integ["watchdog_trips"] == 1 and integ["watchdog_redispatches"] == 1
              and integ["watchdog_escalations"] == 0, "[14] (b) expected one watchdog re-dispatch")
        refused("(b) kill@1:r0 on the 1x1 grid (fr = 1: no replica to re-mesh to)",
                ReplicaLostError, chaos="seed=7;kill@1:r0", **fused)
        ck = BCCheckpoint(os.path.join(tmp, "bc.npz"))
        res, _ = run("(b) checkpoint: the first block (BlockBudgetStop(1))", full=False,
                     checkpoint=ck, stop_rule=BlockBudgetStop(1), **fused)
        check(res.rounds_run == 1, "[14] (b) expected one round committed")
        refused("(b) crash@1 on the checkpointed run", ChaosCrash, checkpoint=ck,
                chaos="seed=7;crash@1", **fused)
        res, _ = run("(b) torn@0: one more block, its save torn", full=False, checkpoint=ck,
                     stop_rule=BlockBudgetStop(1), chaos="seed=3;torn@0", **fused)
        ch = res.recovery_stats["chaos"]
        check(res.rounds_run == 1 and res.recovery_stats["resumed_generation"] == 0
              and ch["checkpoint_saves"] == 1 and ch["files_corrupted"] == [ck.path],
              "[14] (b) expected a resumed run whose one save was torn")
        res, _ = run("(b) resume past the torn snapshot", checkpoint=ck, **fused)
        check(res.recovery_stats["resumed_generation"] == 1 and res.rounds_run == 3,
              "[14] (b) the resume did not fall back one generation")
        res, _ = run("(b) fused auto, autotune=measure, cache@1 on (a)'s file",
                     engine_kind="fused", overlap="auto", autotune="measure", autotune_cache=path,
                     chaos="seed=2;cache@1")
        ch = res.recovery_stats["chaos"]
        check(res.layout_stats["autotune"]["measured"] == 2 and ch["cache_puts"] == 2
              and ch["files_corrupted"] == [path], "[14] (b) expected the second put garbled")
        (res, _), warned = logged("repro_torch.autotune.cache", logging.WARNING, lambda: run(
            "(b) fused, autotune=cache on the garbled file", engine_kind="fused",
            autotune="cache", autotune_cache=path))
        rep_g = res.layout_stats["autotune"]
        print(f"[14] (b) warned: {warned}; plan {rep_g}")
        check(any("unreadable" in w for w in warned) and rep_g["hits"] == 0,
              "[14] (b) the garbled cache was not read back empty with a warning")

    # (c) two lanes a block on one card: replica loss and the duplicate vote
    plan = plan_sampling(eligible_roots(graph), "fixed", None, CHAOS_SAMPLE_K, 0)
    schedule, prep, residual, omega_np = build_schedule(graph, batch_size=MAIN_BATCH,
                                                        heuristics="h0", roots=plan.roots)
    check(len(schedule.rounds) == 5, "[14] (c) expected 5 rounds")
    omega = torch.from_numpy(omega_np).to(device=dev, dtype=torch.float32)
    fn = make_round_fn(make_operator(residual, "fused", dev), omega, integrity="audit")

    def drive(tag, round_fn):
        res, launches, wall = counted(lambda: BCDriver(
            round_fn, schedule, n=graph.n, device=dev, prep=prep, rounds_per_dispatch=2,
            straggler="steal", integrity="audit").run())
        check(launches["frontier_spmm"] > 0 and launches["dependency_spmm"] > 0
              and sum(kernel_launches(launches, k) for k in K1_K6[2:]) == 0,
              f"[14] {tag}: expected K1/K2 launches only")
        st = res.straggler_stats
        print(f"[14] {tag}: wall {wall:.3f}s, {res.rounds_run} rounds, duplicates "
              f"{st['duplicates_discarded']}/{st['duplicates_dispatched']} discarded, rounds per "
              f"lane {st['per_replica_rounds']}, K1 {launches['frontier_spmm']} / K2 "
              f"{launches['dependency_spmm']} launches ({smi})")
        print(f"[14] {tag}: recovery_stats {res.recovery_stats}")
        check(res.rounds_run == 5, f"[14] {tag}: rounds run")
        return res

    one_lane, launches, wall = counted(lambda: BCDriver(
        fn, schedule, n=graph.n, device=dev, prep=prep, rounds_per_dispatch=1,
        integrity="audit").run())
    print(f"[14] (c) one lane, no straggler policy (the reference): wall {wall:.3f}s, "
          f"{one_lane.rounds_run} rounds, K1 {launches['frontier_spmm']} / K2 "
          f"{launches['dependency_spmm']} launches ({smi})")
    check(one_lane.rounds_run == 5, "[14] (c) one lane: rounds run")
    clean = drive("(c) two lanes, steal + audit, no fault", fn)
    held("(c) the clean two-lane run vs the one-lane run", clean.bc, one_lane.bc)
    res = drive("(c) kill@1:r1", ChaosRoundFn(fn, "seed=7;kill@1:r1"))
    check(res.recovery_stats["remesh_events"] == 1 and res.recovery_stats["dead_replicas"] == [1],
          "[14] (c) expected one re-mesh around replica 1")
    held("(c) kill@1:r1 vs the clean run", res.bc, clean.bc)
    res = drive("(c) flip@2:d1 (the tail duplicate, claim forged)",
                ChaosRoundFn(fn, "seed=7;flip@2:d1"))
    integ = res.recovery_stats["integrity"]
    print(f"[14] (c) votes {integ['votes']}, mismatches {integ['vote_mismatches']}, verdicts "
          f"{integ['vote_verdicts']}")
    check(integ["vote_mismatches"] >= 1 and integ["audit_failures"] == 0
          and integ["checksum_failures"] == 0 and integ["vote_verdicts"],
          "[14] (c) the deep flip must be caught by the duplicate vote alone")
    held("(c) flip@2:d1 vs the clean run", res.bc, clean.bc)
    del fn
    torch.cuda.empty_cache()
    measure.default_bench = real_bench
    check(all(kernel_launches(total, k) > 0 for k in K1_K6),
          "[14] the phase did not launch every one of K1-K6")
    print(f"[14] launches over the phase: {dict((k, kernel_launches(total, k)) for k in K1_K6)}; "
          f"by phase 7's row {rows}; at configurations with no row of their own {other}")
    print(f"[14] autotune and chaos phase ok in {time.perf_counter() - t14:.1f}s ({smi})")
    return rows, other


# phase 11: weighted BC (bucketed delta-stepping) at full width
ROAD_SHAPE = (128, 128)  # (c): n = 26 258, about 420 buckets a round
ROAD_ROOTS = 64  # (c): one round of them
DENSE_ROAD_SHAPE = (12, 12)  # (d): n = 232 (2 rounds of 128), where [n, n, s] fits the card
# the arc-list bucket steps' device ops, by kernel name
WEIGHTED_SHARES = {"gathers x[arc]": "vectorized_gather_kernel",
                   "scatter_reduce_ (amin)": "_scatter_gather_elementwise_kernel",
                   "segment_reduce (σ, δ sums)": "segment_reduce_forward_kernel"}


def weighted_phase(graph, groups, dense_ref, smi: str, trace_run) -> None:
    """Phase 11: (a) R-MAT 16 with dyadic weights, the 512 roots of phase
    4, on the sparse engine, on one device and on the 1×1 NCCL grid, and
    at 4 roots against the Dijkstra oracle; (b) unit weights at Δ = 1
    against phase 4's unweighted BC (``dense_ref``); (c) the long-diameter
    road graph against the oracle; (d) the dense-family weighted engines
    on a small road graph, exact, against the oracle.  Every run must
    launch none of K1–K7 (the weighted path has no kernel, in the JAX
    package either).  Prints walls, buckets, inner trips, readbacks and
    peak memory beside ``smi`` (the card's name and power limit)."""
    from repro_torch.core.bc import betweenness_centrality
    from repro_torch.core.brandes_ref import brandes_reference
    from repro_torch.core.distributed import distributed_betweenness_centrality
    from repro_torch.core.engine import BUCKET_TRIPS, reset_bucket_trips
    from repro_torch.core.operators import auto_delta
    from repro_torch.graphs import rmat_graph, road_like_graph, weighted_copy
    from repro_torch.kernels import ops
    from repro_torch.serving import eligible_roots, plan_sampling

    t11 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "[11] TF32 must be off: σ holds exact path counts")
    print(f"[11] card: {smi}")

    def run(tag, call, n):
        """One weighted call with the launch counts, the bucket-trip counts
        and the peak memory zeroed just before and read just after."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        reset_bucket_trips()
        t = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        trips = dict(BUCKET_TRIPS)
        print(f"[11] {tag}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), {res.rounds_run} "
              f"rounds, buckets per round {res.round_levels}, forward {trips['forward_buckets']} "
              f"buckets / {trips['forward_trips']} inner trips, backward "
              f"{trips['backward_buckets']} buckets / {trips['backward_trips']} inner trips, "
              f"{trips['readbacks']} host readbacks, {trips['capped']} capped loops, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
        check(res.bc.shape == (n,) and bool(np.isfinite(res.bc).all()),
              f"[11] {tag}: BC must be finite of shape ({n},)")
        check(not any(ops.LAUNCHES.values()),
              f"[11] {tag}: the weighted path launched a kernel: {ops.LAUNCHES}")
        check(trips["capped"] == 0, f"[11] {tag}: {trips['capped']} bucket loops stopped at "
              f"their trip cap before they converged")
        return res

    def held(tag, got, want):
        ok, err = close(torch.from_numpy(got), torch.from_numpy(want), 1e-5, 1e-5)
        print(f"[11] {tag}: max abs err {err:.3g} (rtol 1e-5 / atol 1e-5)")
        check(ok, f"[11] {tag}: BC disagrees")

    def oracle(tag, g, roots):
        """The Dijkstra oracle on ``roots`` (all when None), rescaled N/k."""
        t = time.perf_counter()
        want = brandes_reference(g, sources=roots)
        if roots is not None:
            want = want * (eligible_roots(g).size / roots.size)
        print(f"[11] {tag}: Dijkstra oracle on the host, "
              f"{g.n if roots is None else roots.size} roots, {time.perf_counter() - t:.1f}s")
        return want

    kw = dict(batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed", sample_seed=0,
              weighted=True)
    # ---- (a) R-MAT 16, dyadic weights: the main weighted run
    wg = rmat_graph(MAIN_N_SCALE, MAIN_EF, seed=1, weights="dyadic")
    check(np.array_equal(wg.src, graph.src) and np.array_equal(wg.dst, graph.dst),
          "[11] the dyadic R-MAT graph's topology differs from phase 4's")
    delta = auto_delta(wg)
    print(f"[11] (a) rmat_graph({MAIN_N_SCALE}, {MAIN_EF}, seed=1, weights='dyadic'): n={wg.n} "
          f"arcs={wg.num_arcs}, auto_delta {delta:g}; batch {MAIN_BATCH}, h0, sampling fixed "
          f"k={MAIN_SAMPLE_K}")
    a_kw = dict(kw, sample_k=MAIN_SAMPLE_K)

    def call_a():
        return betweenness_centrality(wg, engine_kind="sparse", device="cuda", **a_kw)

    single = run("(a) sparse, one device", call_a, wg.n)
    check(single.rounds_run == MAIN_SAMPLE_K // MAIN_BATCH, "[11] (a) expected 4 rounds")
    grid = run("(a) sparse, 1x1 NCCL grid", lambda: distributed_betweenness_centrality(
        wg, groups, engine_kind="sparse", full_result=True, **a_kw), wg.n)
    held("(a) 1x1 grid vs one device", grid.bc, single.bc)
    check(grid.round_levels == single.round_levels, "[11] (a) buckets per round differ")
    del grid
    k4 = run("(a) sparse, 4 roots", lambda: betweenness_centrality(
        wg, engine_kind="sparse", device="cuda", **dict(kw, sample_k=4)), wg.n)
    roots = plan_sampling(eligible_roots(wg), "fixed", None, 4, 0).roots
    held("(a) 4 roots vs the Dijkstra oracle", k4.bc, oracle("(a)", wg, roots))
    trace_run("[11] (a) weighted sparse", call_a, WEIGHTED_SHARES, host_ops=False)
    del single, k4
    torch.cuda.empty_cache()

    # ---- (b) unit weights at Δ = 1 reduce to the unweighted BC
    unit = run("(b) unit weights, Δ = 1, sparse", lambda: betweenness_centrality(
        weighted_copy(graph, "unit"), engine_kind="sparse", device="cuda", delta=1.0, **a_kw),
        graph.n)
    held("(b) unit weights vs phase 4's unweighted dense", unit.bc, dense_ref.bc)
    check(unit.round_levels == dense_ref.round_levels,
          "[11] (b) buckets per round differ from phase 4's levels")
    del unit

    # ---- (c) the long-diameter road regime, one round of ROAD_ROOTS roots
    rg = road_like_graph(*ROAD_SHAPE, seed=1, weights="dyadic")
    print(f"[11] (c) road_like_graph{ROAD_SHAPE}, seed=1, dyadic: n={rg.n} arcs={rg.num_arcs}, "
          f"auto_delta {auto_delta(rg):g}")

    def call_c():
        return betweenness_centrality(rg, engine_kind="sparse", device="cuda",
                                      **dict(kw, sample_k=ROAD_ROOTS))

    road = run("(c) sparse, one device", call_c, rg.n)
    roots = plan_sampling(eligible_roots(rg), "fixed", None, ROAD_ROOTS, 0).roots
    held("(c) vs the Dijkstra oracle", road.bc, oracle("(c)", rg, roots))
    trace_run("[11] (c) weighted sparse, road", call_c, WEIGHTED_SHARES, host_ops=False)

    # ---- (d) the dense-family weighted engines, exact, h1
    dg = road_like_graph(*DENSE_ROAD_SHAPE, seed=1, weights="dyadic")
    want = oracle(f"(d) road_like_graph{DENSE_ROAD_SHAPE}, n={dg.n}", dg, None)
    d_kw = dict(batch_size=MAIN_BATCH, heuristics="h1", weighted=True)
    for engine in ("dense", "fused", "fused_bf16"):
        res = run(f"(d) {engine}, one device", lambda: betweenness_centrality(
            dg, engine_kind=engine, device="cuda", **d_kw), dg.n)
        held(f"(d) {engine} vs the Dijkstra oracle", res.bc, want)
    for engine in ("fused", "fused_sparse", "fused_hybrid"):
        res = run(f"(d) {engine}, 1x1 NCCL grid", lambda: distributed_betweenness_centrality(
            dg, groups, engine_kind=engine, full_result=True, **d_kw), dg.n)
        held(f"(d) {engine} 1x1 grid vs the Dijkstra oracle", res.bc, want)
    print(f"[11] weighted BC ok in {time.perf_counter() - t11:.1f}s [{smi}]")


# --------------------------------------------------------------------------
# phase 15: the paper's own configuration, bc-rmat:rmat_s23_ef16
ORACLE_ROOTS = 1  # (ii): h0 roots of the float64 oracle round (~25 s a root on the host)


def brandes_roots_oracle(src: np.ndarray, dst: np.ndarray, n: int, omega: np.ndarray,
                         roots: list[int]) -> tuple[np.ndarray, int]:
    """One round's BC contributions of ``roots`` (no derived columns) in
    float64, level-synchronous Brandes on a scipy CSR of the arc list
    (sorted by src), with the 1-degree weights ω as the round applies them:
    δ(v) = Σ_{successors w} σ_v/σ_w·(1 + ω_w + δ(w)), each root's column
    times 1 + ω_root, the roots themselves 0.  Independent of both
    packages.  Returns (bc f64 [n], levels = max depth + 1)."""
    import scipy.sparse as sp

    check(bool(np.all(src[1:] >= src[:-1])), "[15] the oracle needs arcs sorted by source")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    adj = sp.csr_matrix((np.ones(src.size), dst, indptr), shape=(n, n))
    k = len(roots)
    cols = np.arange(k)
    sigma = np.zeros((n, k))
    depth = np.full((n, k), -1, np.int64)
    sigma[roots, cols] = 1.0
    depth[roots, cols] = 0
    front, lvl = sigma.copy(), 0
    while True:
        t = adj @ front
        new = (t > 0) & (depth < 0)
        if not new.any():
            break
        lvl += 1
        depth[new] = lvl
        sigma[new] = t[new]
        front = np.where(new, sigma, 0.0)
    delta = np.zeros((n, k))
    safe = np.where(sigma > 0, sigma, 1.0)
    for level in range(lvl - 1, 0, -1):
        g = np.where(depth == level + 1, (1.0 + delta + omega[:, None]) / safe, 0.0)
        t = adj @ g
        on = depth == level
        delta[on] = sigma[on] * t[on]
    contrib = delta * (1.0 + omega[roots])[None, :]
    contrib[roots, cols] = 0.0
    return contrib.sum(axis=1), lvl + 1


def arc_product_entries(cell, dev, smi: str) -> dict[int, dict]:
    """Phase 15's rows of the kernel table by width, their launches left
    to the rounds (:func:`rmat_cell_phase`): the arc product on the s23
    cell's arcs, by destination with their work list, at the round's
    forward (s = 16) and backward (s = 24) widths: the kernel bit-equal to
    its torch version, its time beside that version's and torch.sparse.mm's
    (CSR, f32: the library's SpMM of the same product, which the port never
    calls), and the bytes bound (the index, x and out once), beside the
    bytes of every arc's operand row read once."""
    from repro_torch.core import operators
    from repro_torch.core.distributed import distributed_graph_arrays
    from repro_torch.kernels import ops

    part = cell.partition
    rows, kdim = part.C * part.chunk, part.R * part.chunk
    src, dst = distributed_graph_arrays(part, "sparse", 0, 0, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    src, _, _, lengths = operators._by_destination(src, dst, None, rows)
    del dst
    torch.cuda.synchronize()
    t_sort = time.perf_counter()
    src, pieces, counts, plan = operators._arc_operands(src, lengths, rows)
    torch.cuda.synchronize()
    t_plan = time.perf_counter()
    real = int(lengths[:rows].sum())
    print(f"[15] arc product: {real} arcs into {rows} rows by destination {t_sort - t:.3f}s, "
          f"pieces and work list {t_plan - t_sort:.3f}s ({plan.long_ptr.numel() - 1} long rows "
          f"in {plan.n_long_seg} pieces, {plan.seg.shape[0]} segments, "
          f"{plan.nbytes() / 1e9:.3f} GB)")
    csr = torch.sparse_csr_tensor(torch.cat([lengths.new_zeros(1), lengths[:rows].cumsum(0)]),
                                  src[:real].long(), torch.ones(real, device=dev),
                                  size=(rows, kdim))
    entries = {}
    for s in (16, 24):
        x = torch.rand((kdim, s), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(s))

        def kernel():
            return operators._arc_product(x, src, pieces, counts, rows, plan)

        ops.reset_launches()
        got = kernel()
        want = operators._arc_sum(x, src, pieces, counts, rows)
        err = float((got - want).abs().max())
        check(err == 0.0 and torch.equal(got, want) and ops.LAUNCHES["arc_product"] == 1,
              f"[15] arc product s={s}: the kernel differs from its torch version by {err}")
        ms = cuda_time_ms(kernel, reps=20)
        plain_ms = cuda_time_ms(lambda: operators._arc_sum(x, src, pieces, counts, rows), reps=3)
        lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, x), reps=20)
        nbytes = x.nbytes + plan.src.nbytes + got.nbytes
        row_bytes = real * s * 4 + plan.src.nbytes + got.nbytes
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        rows_ms = row_bytes / PEAK_BYTES_PER_S * 1e3
        entries[s] = {
            "name": f"arc_product[R-MAT 23 residual, {real} arcs, s={s}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/arc_product.cu",
            "replaces": "none (the JAX package leaves it to XLA's gather and segment_sum)",
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": lib_ms,
        }
        print(f"[15] arc product s={s}: bit-equal to its torch version; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, torch.sparse.mm (CSR) {lib_ms:.3f} ms, bound "
              f"{bound:.4f} ms (bytes {nbytes / 1e9:.3f} GB: index, x and out once), "
              f"{100 * bound / ms:.1f}% of bound; every arc's row read once {rows_ms:.3f} ms "
              f"({row_bytes / 1e9:.2f} GB), {100 * rows_ms / ms:.1f}% of that ({smi})")
        del x, got, want
    del src, pieces, counts, plan, csr, lengths
    torch.cuda.empty_cache()
    return entries


def rmat_cell_phase(dev, groups, smi: str) -> list[dict]:
    """Phase 15: bc-rmat:rmat_s23_ef16 (the paper's strong-scaling R-MAT,
    n = 2^23, EF 16, batch 16, h3, max_levels 12) through the cell on the
    1×1 NCCL grid, sparse engine: the host set-up's steps timed apart; the
    first h3 round at the static 12 levels (once plain, once under the
    work counter: the roofline terms) and with the liveness loop (wall,
    levels, traversed-edge rate, peak memory beside the priced footprint);
    (i) the liveness round against the single-device sparse round
    (``make_round_fn``), (ii) a round of ORACLE_ROOTS h0 roots against the
    float64 oracle, (iii) the static against the liveness round, bit for
    bit when the depth is ≤ 12; the arc product alone on the same arcs
    (:func:`arc_product_entries`); the guard refusing fused and
    fused_sparse; s25's meta (no graph made).  Every round launches the
    arc product once a level product and nothing else.  Returns the arc
    product's rows of the kernel table, each with the launches at its
    width in this phase's rounds (the kernel's own timing not counted)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bc import make_operator, make_round_fn
    from repro_torch.core.distributed import check_device_memory
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline import H100, WorkCounter, roofline_terms

    t15 = time.perf_counter()
    arc_widths = collections.Counter()  # the rounds' arc product launches, by width

    @contextlib.contextmanager
    def count_arc_widths():
        launch = ops.arc_product

        def counted(x, plan, rows):
            out = launch(x, plan, rows)
            arc_widths[x.shape[1]] += 1
            return out

        ops.arc_product = counted
        try:
            yield
        finally:
            ops.arc_product = launch
    bundle = get_arch("bc-rmat")
    cfg, shape = bundle.arch, "rmat_s23_ef16"
    spec = bundle.shapes[shape]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the round needs ~50 GiB
    before = torch.cuda.memory_allocated()
    print(f"[15] {before / GIB:.2f} GiB allocated by earlier phases, "
          f"{torch.cuda.memory_reserved() / GIB:.2f} GiB reserved")
    cell = build_cell(bundle, shape, groups, seed=1)
    resident = torch.cuda.memory_allocated() - before
    st, meta = cell.setup, cell.static_meta
    n, arcs = st["n"], st["residual_arcs"]
    print(f"[15] {cell.name} host set-up: rmat_graph({spec.scale}, {spec.edge_factor}, seed=1) "
          f"{st['rmat_s']:.3f}s "
          f"(n={n}, {st['arcs']} arcs), the h3 schedule {st['schedule_s']:.3f}s ({arcs} residual "
          f"arcs, {st['rounds']} rounds), partition_2d 1x1 {st['partition_s']:.3f}s, arc arrays "
          f"and ω to the card {st['device_s']:.3f}s ({resident / GIB:.2f} GiB resident)")
    print(f"[15] static meta (1x1): {json.dumps(meta)}")
    src, der = cell.round_inputs(0)
    s_k = meta["sources_per_round"]
    check(src.shape[1] + der.shape[1] == s_k, "[15] the round's width differs from the meta's")
    # warm-up: an all-padding round stops after one level (the liveness loop)
    t = time.perf_counter()
    cell.fn(np.full_like(src, -1), np.full_like(der, -1), num_levels=None)
    torch.cuda.synchronize()
    print(f"[15] warm-up (an all-padding round, liveness loop) {time.perf_counter() - t:.3f}s")

    def run(tag, sources, derived, num_levels, count=False, width=s_k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        ops.reset_launches()
        wc = WorkCounter()
        t = time.perf_counter()
        with count_arc_widths(), wc if count else contextlib.nullcontext():
            out = cell.fn(sources, derived, num_levels=num_levels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - live
        bc = out[0][0, :n]
        levels = int(out[3][0])
        check(bc.shape == (n,) and bool(torch.isfinite(bc).all()),
              f"[15] {tag}: BC must be finite of shape ({n},)")
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        products = launched.get("arc_product", 0)
        check(set(launched) == {"arc_product"}
              and (num_levels is None or products == 2 * num_levels - 1),
              f"[15] {tag}: the sparse round launched {launched}, not the arc product once a "
              f"level product")
        print(f"[15] {tag}: wall {wall:.3f}s, levels {levels}, {products} arc products, "
              f"traversed-edge rate (residual "
              f"arcs × {width} / wall) {arcs * width / wall / 1e9:.3f} G/s, peak device memory of "
              f"the round {peak / GIB:.2f} GiB above {live / GIB:.2f} GiB live (priced footprint "
              f"{meta['hbm_footprint_bytes']['sparse'] / GIB:.2f} GiB) ({smi})")
        return out, wall, peak, levels, wc

    static, wall_s, peak_s, levels_s, _ = run("round 0 static (12 levels)", src, der,
                                              cfg.max_levels)
    _, wall_c, _, _, wc = run("round 0 static (12 levels), counted", src, der, cfg.max_levels,
                              count=True)
    live, wall_l, peak_l, levels_l, _ = run("round 0 liveness", src, der, None)
    terms = wc.terms()
    rt = roofline_terms(terms, 1, meta["model_flops"], hw=H100)
    print(f"[15] work counter (static round): {json.dumps(wc.by_name())}; collectives "
          f"{json.dumps(terms['collectives'])}")
    print(f"[15] roofline_terms(hw=H100): compute {rt.compute_s:.4f}s, memory {rt.memory_s:.4f}s, "
          f"collective {rt.collective_s:.4f}s (+ α {rt.ring_latency_s:.4f}s over {rt.ring_steps} "
          f"hops), bottleneck {rt.bottleneck}, {rt.flops / 1e9:.1f} GFLOP, {rt.bytes / 1e9:.1f} "
          f"GB, useful fraction {rt.useful_fraction:.4f}; memory_s / wall = "
          f"{rt.memory_s / wall_s:.4f} of the bytes bound; the counted run {wall_c:.3f}s against "
          f"{wall_s:.3f}s")
    print(f"[15] peak device memory: resident {resident / GIB:.2f} GiB + static round "
          f"{peak_s / GIB:.2f} / liveness {peak_l / GIB:.2f} GiB, against the priced "
          f"{meta['hbm_footprint_bytes']['sparse'] / GIB:.2f} GiB (the arc product's work "
          f"lists and f64 scratch are not priced; its kernel holds no [arcs, s] messages)")
    entries = arc_product_entries(cell, dev, smi)

    # (i) the liveness round against the single-device sparse round
    omega_t = torch.from_numpy(cell.omega.astype(np.float32)).to(dev)
    op = make_operator(cell.residual, "sparse", dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with count_arc_widths():
        one = make_round_fn(op, omega_t)(torch.from_numpy(src).to(dev),
                                         torch.from_numpy(der).to(dev))
    torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t
    ok, err = close(live[0][0, :n], one[0][0], 1e-5, 1e-5)
    print(f"[15] (i) liveness round vs the single-device sparse round (make_round_fn, wall "
          f"{wall_1:.3f}s, levels {one[3][0]}): max abs err {err:.3g}")
    check(ok and one[3][0] == levels_l, "[15] (i) the cell's round disagrees with one device's")
    del op, one
    torch.cuda.empty_cache()

    # (iii) static vs liveness: the arc sums are row sums in a fixed order,
    # so one round run twice gives the same bits
    depth = levels_l - 1
    same = all(torch.equal(a, b) for a, b in zip(static, live))
    if depth <= cfg.max_levels:
        print(f"[15] (iii) depth {depth} <= max_levels {cfg.max_levels}: the static and liveness "
              f"rounds are bit-equal: {same}")
        check(same and levels_s == levels_l,
              "[15] (iii) the static round differs from the liveness round")
    else:
        _, err_t = close(static[0], live[0], 0.0, 0.0)
        print(f"[15] (iii) FINDING: depth {depth} > max_levels {cfg.max_levels}: the reference's "
              f"static bound truncates this round (max abs diff {err_t:.3g} against the liveness "
              f"round); max_levels is left as the config has it")
    del static, live

    # (ii) ORACLE_ROOTS h0 roots, no derived columns, against the float64 oracle
    res = cell.residual
    hub = int(np.argmax(res.degrees()))
    roots = [hub] + [int(r) for r in src[0] if r >= 0 and r != hub][:ORACLE_ROOTS - 1]
    sources = np.full_like(src, -1)
    sources[0, :len(roots)] = roots
    derived = np.full_like(der, -1)
    out, _, _, levels_o, _ = run(f"(ii) round of roots {roots}", sources, derived, None,
                                 width=len(roots))
    t = time.perf_counter()
    want, levels_w = brandes_roots_oracle(res.src, res.dst, n, cell.omega, roots)
    ok, err = close(out[0][0, :n].cpu(), torch.from_numpy(want), 1e-5, 1e-5)
    print(f"[15] (ii) vs the float64 oracle (scipy CSR, {time.perf_counter() - t:.1f}s, levels "
          f"{levels_w}): max abs err {err:.3g}, max BC {want.max():.6g}")
    check(ok and levels_o == levels_w, "[15] (ii) the cell's round disagrees with the oracle")
    del out

    # the guard: the dense and BCSR engines do not fit one card at s23
    total_mem = torch.cuda.get_device_properties(0).total_memory
    before = torch.cuda.memory_allocated()
    for engine in ("fused", "fused_sparse"):
        t = time.perf_counter()
        try:
            check_device_memory(cell.partition, engine, cfg.batch_size, total_mem)
            fail(f"[15] the memory guard let {engine} through at scale 23")
        except MemoryError as err:
            check("GiB" in str(err) and torch.cuda.memory_allocated() == before,
                  f"[15] the guard's refusal of {engine}")
            print(f"[15] guard ({time.perf_counter() - t:.1f}s, budget {total_mem / GIB:.2f} "
                  f"GiB) refused {engine}: {err}")
    del cell
    torch.cuda.empty_cache()
    s25 = build_cell(bundle, "rmat_s25_ef16")
    print(f"[15] {s25.name} meta (1x1, no graph made): {json.dumps(s25.static_meta)}")
    print(f"[15] bc-rmat phase ok in {time.perf_counter() - t15:.1f}s ({smi})")
    print(f"[15] the rounds' arc product launches by width: {dict(sorted(arc_widths.items()))}")
    for s, entry in entries.items():
        entry["launches"] = arc_widths[s]
        check(entry["launches"] > 0, f"[15] no round launched the arc product at s={s}")
    return list(entries.values())


# ----------------------------------------------------------------- phase 17
LM_ARCHS = ("gemma-7b", "codeqwen1.5-7b", "deepseek-coder-33b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b")
LM_REDUCED = dict(layers=2, d_model=256, vocab=2048)  # (a): serve_lm --reduced's config
LM_PROMPT, LM_STEPS = 256, 8  # (a): two q-chunks of the reduced config, 8 decode steps
# the CPU tests' tolerances against the JAX package (tests/test_torch_lm_serve.py), each a
# share of the reference's largest |value|: logits and the KV cache; an MoE arch may have
# LM_MOE_ROWS of its cache rows past the cache tolerance (a route flipped at a near-tie by a
# bf16 ulp upstream moves that token's rows, and may move one token across the capacity)
LM_TOL_LOGITS, LM_TOL_CACHE, LM_MOE_ROWS = 5e-2, 2e-2, 0.01
# (c): prefill(P) + decode_step(P) against prefill(P + 1)'s last logits, card against card:
# the logits tolerance of (a), whose two layers' bf16 drift it bounds, held at 28 layers
LM_CONSIST_P, LM_TOL_CONSIST = 2048, LM_TOL_LOGITS
LM_DECODE_STEPS = 20
PREFILL_REPS = 2  # timed prefill_32k calls (~17.6 s each for granite)
# H100 SXM data sheet: dense BF16 tensor-core peak (1 979 TFLOP/s with 2:4 sparsity)
PEAK_BF16_DENSE_FLOP_PER_S = 989e12
LM_SHARES = {"softmax": "SoftMaxForward", "bf16 casts": "bfloat16_copy",
             "cuBLAS GEMMs": "nvjet", "masked fills": "masked_fill", "fills": "FillFunctor",
             "scans (MoE slots)": "scan", "gathers / scatters": "index"}


def lm_forward_flops(cfg, batch: int, seq: int) -> float:
    """FLOP of one prefill as the port computes it: 2 per weight a token in
    the layers (routed experts only), the last position's logits, and the
    score and PV products over every key of every q-chunk (no causal block
    is skipped)."""
    d, hhd, khd = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    ffn = 3 * d * (cfg.d_ff if cfg.moe is None else cfg.moe.d_ff * cfg.moe.top_k)
    per_token = cfg.n_layers * (2 * d * hhd + 2 * d * khd + ffn)
    attn = cfg.n_layers * 4.0 * batch * seq * seq * hhd
    vocab = cfg.vocab + (-cfg.vocab) % 256
    return 2.0 * per_token * batch * seq + attn + 2.0 * batch * d * vocab


def lm_rows_off(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """(largest |got − want| / largest |want|, share of the cache rows — one
    (layer, sequence, position) each — whose largest error passes tol · largest |want|)."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    rows = diff.amax(dim=(-2, -1))
    return diff.max().item() / scale, (rows > tol * scale).float().mean().item()


def lm_card_vs_cpu(dev) -> None:
    """(a): each LM arch, reduced, on the card against the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import TransformerLM

    for name in LM_ARCHS:
        t = time.perf_counter()
        cfg = reduced_lm(get_arch(name).arch, **LM_REDUCED)
        cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        card = TransformerLM(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, LM_PROMPT + LM_STEPS)).astype(np.int32))
        out = {}
        for tag, model in (("cpu", cpu), ("card", card)):
            tk = tokens.to(model.device)
            logits, cache = model.prefill(tk[:, :LM_PROMPT], max_seq=LM_PROMPT + LM_STEPS)
            steps = [logits]
            for i in range(LM_STEPS):  # teacher-forced: both sides read the same tokens
                logits, cache = model.decode_step(cache, tk[:, LM_PROMPT + i], LM_PROMPT + i)
                steps.append(logits)
            out[tag] = (torch.stack(steps).cpu(), {k: v.cpu() for k, v in cache.items()})
        (lg, cg), (lw, cw) = out["card"], out["cpu"]
        check(bool(torch.isfinite(lg).all()), f"[17] (a) {name}: non-finite logits on the card")
        err_l = ((lg - lw).abs().amax(dim=-1) / lw.abs().amax(dim=-1)).max().item()
        err_k, off_k = lm_rows_off(cg["k"], cw["k"], LM_TOL_CACHE)
        err_v, off_v = lm_rows_off(cg["v"], cw["v"], LM_TOL_CACHE)
        allowed = LM_MOE_ROWS if cfg.moe is not None else 0.0
        print(f"[17] (a) {name} reduced (L {cfg.n_layers}, d {cfg.d_model}, H {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, moe {cfg.moe is not None}): prefill {LM_PROMPT} + {LM_STEPS} "
              f"teacher-forced steps, card vs CPU: logits err {err_l:.3g} of the largest "
              f"(tol {LM_TOL_LOGITS}); cache k err {err_k:.3g}, v {err_v:.3g}, rows past "
              f"{LM_TOL_CACHE}: k {off_k:.4f}, v {off_v:.4f} (allowed {allowed}); "
              f"{time.perf_counter() - t:.1f}s")
        check(err_l <= LM_TOL_LOGITS, f"[17] (a) {name}: logits off by {err_l:.3g}")
        check(off_k <= allowed and off_v <= allowed, f"[17] (a) {name}: cache rows off")


class DropCounter:
    """Wraps the transformer's ``moe_ffn`` and recounts, from the router, the
    (token, expert) assignments each call drops: an expert chosen by n
    assignments keeps the first cap and drops max(0, n − cap)."""

    def __init__(self):
        from repro_torch.models import transformer
        from repro_torch.models.moe import capacity

        self.module, self.capacity = transformer, capacity
        self.inner = transformer.moe_ffn
        self.dropped = self.assigned = 0  # summed on the card: no host sync a layer

    def __call__(self, x, router_w, wi, wo, *, top_k, capacity_factor, activation):
        e = router_w.shape[1]
        with torch.no_grad():  # no autograd state of its own inside a train step
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
            chosen = torch.topk(probs, top_k, dim=-1).indices
            counts = torch.bincount(chosen.reshape(-1), minlength=e)
            cap = self.capacity(x.shape[0], top_k, e, capacity_factor)
            self.dropped = self.dropped + (counts - cap).clamp_min(0).sum()
        self.assigned += chosen.numel()
        return self.inner(x, router_w, wi, wo, top_k=top_k, capacity_factor=capacity_factor,
                          activation=activation)

    def __enter__(self):
        self.module.moe_ffn = self
        return self

    def __exit__(self, *exc):
        self.module.moe_ffn = self.inner

    def take(self) -> str:
        line = f"{int(self.dropped)} of {self.assigned} assignments dropped"
        self.dropped = self.assigned = 0
        return line


def lm_full_width(dev, smi: str, name: str, serve: tuple[int, int], prefill_batch: int,
                  decode_cells: dict, consistency: bool) -> None:
    """(b) / (c): one arch at every published width, weights from seed 0 on
    the card: serve_loop, the prefill_32k cell at ``prefill_batch``, the
    decode cells (shape name -> batch) and, with ``consistency``, prefill +
    decode_step against a longer prefill."""
    import dataclasses

    from repro_torch.configs import ArchBundle, get_arch
    from repro_torch.launch.serve_lm import serve_loop
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import TransformerLM, padded_vocab

    bundle = get_arch(name)
    cfg = bundle.arch
    part = "(b)" if cfg.moe is not None else "(c)"
    tag = f"[17] {part} {name}"
    vp = padded_vocab(cfg)
    t_part = time.perf_counter()
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    p_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_par = sum(p.numel() for p in model.parameters())
    print(f"{tag}: L {cfg.n_layers}, d {cfg.d_model}, H {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, {'moe ' + str(cfg.moe) if cfg.moe else f'd_ff {cfg.d_ff}'}, vocab "
          f"{cfg.vocab} padded to {vp}: {n_par} params, {p_bytes / 1e9:.3f} GB, drawn on the card "
          f"in {time.perf_counter() - t_part:.1f}s [{smi}]")
    counter = DropCounter() if cfg.moe is not None else None

    def in_range(tokens: torch.Tensor, where: str) -> None:
        check(bool(((tokens >= 0) & (tokens < vp)).all()), f"{tag} {where}: token out of range")

    def logits_ok(logits: torch.Tensor, rows: int, where: str) -> None:
        check(tuple(logits.shape) == (rows, vp) and logits.dtype == torch.float32,
              f"{tag} {where}: logits {tuple(logits.shape)} {logits.dtype}")
        check(bool(torch.isfinite(logits).all()), f"{tag} {where}: non-finite logits")
        in_range(logits.argmax(dim=-1), where)

    def drops(what: str = "") -> str:
        return f"; {counter.take()}{what}" if counter is not None else ""

    # ---- serve_loop: the entry point end to end
    b, prompt = serve
    gen = 16
    torch.cuda.reset_peak_memory_stats()
    out, t_p, t_d = serve_loop(cfg, b, prompt, gen, device=dev, params=model)
    check(out.shape == (b, gen), f"{tag} serve_loop gave {out.shape}")
    in_range(torch.from_numpy(out), "serve_loop")
    print(f"{tag} serve_loop(batch={b}, prompt_len={prompt}, gen={gen}): prefill "
          f"{t_p * 1e3:.1f} ms ({b * prompt / t_p:.0f} tok/s), decode {t_d * 1e3:.1f} ms for "
          f"{gen - 1} steps ({t_d * 1e3 / (gen - 1):.3f} ms a step, {b * (gen - 1) / t_d:.1f} "
          f"tok/s); peak {torch.cuda.max_memory_allocated() / GIB:.2f} GiB")

    def events(fn) -> float:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop), out

    print(f"{tag} serve_loop done at {time.perf_counter() - t_part:.1f}s of this part")

    # ---- prefill_32k
    shape = dataclasses.replace(bundle.shapes["prefill_32k"], global_batch=prefill_batch)
    cell = build_cell(ArchBundle(cfg, {shape.name: shape}), shape.name, device=dev, model=model)
    tokens = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len), dtype=torch.int32,
                           device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(PREFILL_REPS):
        with counter or contextlib.nullcontext():
            ms, (logits, cache) = events(lambda: cell.fn({"tokens": tokens}))
        times.append(ms)
        logits_ok(logits, shape.global_batch, "prefill_32k")
        del cache
    ms = float(np.median(times))
    n_tok = shape.global_batch * shape.seq_len
    flops = lm_forward_flops(cfg, shape.global_batch, shape.seq_len)
    meta = cell.static_meta
    print(f"{tag} prefill_32k at B = {shape.global_batch} (cut from "
          f"{bundle.shapes['prefill_32k'].global_batch}), S = {shape.seq_len}: {ms:.1f} ms "
          f"(median of {PREFILL_REPS}: {', '.join(f'{x:.1f}' for x in times)}), "
          f"{n_tok / ms * 1e3:.0f} tok/s; "
          f"peak {torch.cuda.max_memory_allocated() / GIB:.2f} GiB against the reckoned "
          f"{meta['analytic_bytes_global'] / GIB:.2f} GiB (the cell's analytic bytes); "
          f"{flops / 1e12:.1f} TFLOP (the meta's 6·N·D: {meta['model_flops'] / 1e12:.1f}) = "
          f"{flops / ms * 1e3 / 1e12:.1f} TFLOP/s, {100 * flops / ms * 1e3 / PEAK_BF16_DENSE_FLOP_PER_S:.2f}"
          f"% of the dense BF16 peak {PEAK_BF16_DENSE_FLOP_PER_S / 1e12:.1f} TFLOP/s"
          f"{drops(f' (the {PREFILL_REPS} calls of the same tokens)')}")
    del logits
    t = time.perf_counter()
    trace_run(f"{tag} prefill_32k B = {shape.global_batch}", lambda: cell.fn({"tokens": tokens}),
              LM_SHARES, host_ops=False)
    print(f"{tag} the traced prefill took {time.perf_counter() - t:.1f}s with its summary; "
          f"prefill_32k done at {time.perf_counter() - t_part:.1f}s of this part")
    del cell
    torch.cuda.empty_cache()

    # ---- decode cells: a cache of N(0, 1) bf16 filled on the card, steps at the last position
    for shape_name, batch in decode_cells.items():
        full = bundle.shapes[shape_name]
        shape = dataclasses.replace(full, global_batch=batch)
        cell = build_cell(ArchBundle(cfg, {shape.name: shape}), shape.name, device=dev,
                          model=model)
        torch.cuda.reset_peak_memory_stats()
        cache = cell.empty_cache()
        gen_c = torch.Generator(device=dev).manual_seed(3)
        for key in cache:
            for layer in range(cfg.n_layers):
                cache[key][layer].normal_(generator=gen_c)
        c_bytes = sum(c.numel() * c.element_size() for c in cache.values())
        tokens = torch.randint(0, cfg.vocab, (batch,), dtype=torch.int32, device=dev,
                               generator=gen_c)
        pos = shape.seq_len - 1
        batch_in = {"tokens": tokens, "pos": pos}
        with counter or contextlib.nullcontext():  # one eager step counts the drops
            logits, cache = model.decode_step(cache, tokens, pos, graph=False)
        eager_ms, _ = events(lambda: model.decode_step(cache, tokens, pos, graph=False))
        capture_ms, _ = events(lambda: cell.fn(cache, batch_in))  # captures the step's graph
        times = []
        for _ in range(LM_DECODE_STEPS):
            ms, (logits, cache) = events(lambda: cell.fn(cache, batch_in))
            times.append(ms)
        logits_ok(logits, batch, shape_name)
        ms = float(np.median(times))
        bound_ms = (p_bytes + c_bytes) / PEAK_BYTES_PER_S * 1e3
        cut = "uncut" if batch == full.global_batch else f"cut from {full.global_batch}"
        print(f"{tag} {shape_name} at B = {batch} ({cut}), cache {shape.seq_len} positions "
              f"({c_bytes / 1e9:.2f} GB), {LM_DECODE_STEPS} steps at pos {pos}: {ms:.3f} ms a step "
              f"(median; min {min(times):.3f}, max {max(times):.3f}), {batch / ms * 1e3:.1f} "
              f"tok/s; bytes bound (params + cache read) / {PEAK_BYTES_PER_S / 1e12:.2f} TB/s = "
              f"{bound_ms:.3f} ms: {100 * bound_ms / ms:.1f}% of it; peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB against the reckoned "
              f"{cell.static_meta['analytic_bytes_global'] / GIB:.2f} GiB{drops(' (one step)')}; "
              f"the step op by op (no graph) {eager_ms:.3f} ms, its graph's capture "
              f"{capture_ms:.3f} ms")
        trace_run(f"{tag} {shape_name} step", lambda: cell.fn(cache, batch_in), LM_SHARES)
        del cache, cell, logits
        torch.cuda.empty_cache()
        print(f"{tag} {shape_name} done at {time.perf_counter() - t_part:.1f}s of this part")

    # ---- prefill(P) then decode_step(P) against prefill(P + 1)'s last logits
    if consistency:
        p = LM_CONSIST_P
        tokens = torch.randint(0, cfg.vocab, (1, p + 1), dtype=torch.int32, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(4))
        want, _ = model.prefill(tokens)
        _, cache = model.prefill(tokens[:, :p], max_seq=p + 1)
        got, _ = model.decode_step(cache, tokens[:, p], p)
        err = ((got - want).abs().max() / want.abs().max()).item()
        top2 = want.topk(2, dim=-1).values[0]
        margin = ((top2[0] - top2[1]) / want.abs().max()).item()
        same = bool(got.argmax() == want.argmax())
        print(f"{tag} prefill({p}) + decode_step({p}) against prefill({p + 1}): logits err "
              f"{err:.3g} of the largest (tol {LM_TOL_CONSIST}); argmax equal {same} (top-2 "
              f"margin {margin:.3g} of the largest)")
        check(err <= LM_TOL_CONSIST, f"{tag}: decode_step disagrees with the longer prefill")
        check(same or margin <= LM_TOL_CONSIST, f"{tag}: argmax differs past a clear margin")
        trace_run(f"{tag} decode step B = 1 at pos {p}",
                  lambda: model.decode_step(cache, tokens[:, p], p), LM_SHARES)
        del cache
    del model
    torch.cuda.empty_cache()
    print(f"{tag} done in {time.perf_counter() - t_part:.1f}s")


def lm_phase(dev, smi: str) -> None:
    """Phase 17: LM serving on one card — (a) the five reduced archs against
    the CPU, (b) granite-moe-1b-a400m and (c) gemma-7b at every published
    width (see the module docstring)."""
    t17 = time.perf_counter()
    live = torch.cuda.memory_allocated()
    check(live < GIB, f"[17] {live / GIB:.2f} GiB allocated before the LM phase")
    print(f"[17] {smi}; {live / GIB:.2f} GiB allocated before; bf16 reduced-precision "
          f"reductions {torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "[17] bf16 GEMMs must reduce in f32")
    lm_card_vs_cpu(dev)
    lm_full_width(dev, smi, "granite-moe-1b-a400m", serve=(4, 32768), prefill_batch=4,
                  decode_cells={"decode_32k": 32, "long_500k": 1}, consistency=False)
    lm_full_width(dev, smi, "gemma-7b", serve=(1, 4096), prefill_batch=1, decode_cells={},
                  consistency=True)
    print(f"[17] LM serving ok in {time.perf_counter() - t17:.1f}s [{smi}]")


# ----------------------------------------------------------------- phase 18
LM_TRAIN_ARCH = "granite-moe-1b-a400m"
# (b): the batch, cut from the published 256 to the largest power of two whose step fits one
# card (reckoned: 16.0 GB of bf16 params and grads and f32 μ and ν, then ~2.3 GB a sequence,
# most of it one layer's recompute: eight q-chunks' f32 and bf16 probabilities, the MoE buffers)
LM_TRAIN_BATCH = 16
LM_TRAIN_STEPS = 5  # timed, after one warm-up step
LM_TRAIN_SHAPE = (2, 256)  # (a): B, S — a 255-token loss, one chunk of 128 and a ragged tail
# (a): the CPU tests' tolerances against the JAX package (tests/test_torch_lm_train.py): the
# loss relative, each gradient leaf a share of its largest |value| with the routes held equal;
# at most LM_MOE_FLIPS of the tokens may go to another set of experts unheld
LM_TOL_LOSS, LM_TOL_GRAD, LM_MOE_FLIPS = 1e-2, 5e-2, 0.01
# (c): granite cut to 2 layers, B = 2; train_lm's straight run of 6 steps against 4 steps
# saving every 3 (at steps 0 and 3) and a rerun that resumes after step 3
LM_RESUME_LAYERS, LM_RESUME_BATCH, LM_RESUME_SEQ = 2, 2, 4096
LM_RESUME_STEPS, LM_RESUME_EVERY = 6, 3
# (b)'s trace, by kernel family (the needles match disjoint kernel names; the rest is the
# elementwise math of the norms, rope, activations, the loss and AdamW)
LM_TRAIN_SHARES = {"bf16 GEMMs (cuBLAS nvjet)": "nvjet",
                   "other GEMMs (the score product's f32 backward)": "gemm",
                   "softmax forward": "SoftMaxForward", "softmax backward": "SoftMaxBackward",
                   "casts to bf16": "bfloat16_copy", "strided copies and casts": "direct_copy",
                   "device-to-device memcpy": "Memcpy DtoD", "the mask fill": "masked_fill",
                   "fills (zeros)": "FillFunctor", "gathers / scatters (MoE, embedding)": "index",
                   "reductions (norms, logsumexp, sums)": "reduce_kernel"}


def share_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want| (want nonzero)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def lm_train_card_vs_cpu(dev) -> None:
    """(a): each LM arch, reduced, trained on the card against the CPU."""
    from repro_torch.configs import ArchBundle, LMShape, get_arch
    from repro_torch.launch.steps import build_lm_cell
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import TransformerLM
    from repro_torch.models.transformer import lm_loss
    from torch_lm_routes import UPDATE_TOL_DIR, UPDATE_TOL_NORM, leaves, port_routes, update_gap

    b, s = LM_TRAIN_SHAPE
    for name in LM_ARCHS:
        t = time.perf_counter()
        cfg = reduced_lm(get_arch(name).arch, **LM_REDUCED)
        cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                            trainable=True)
        card = TransformerLM(cfg, device=dev, trainable=True)
        card.load_state_dict(cpu.state_dict())
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (b, s))
                                  .astype(np.int32))

        def loss_and_grads(model, pinned=None):
            model.zero_grad(set_to_none=True)
            with port_routes(model, pinned) as routes:
                loss, metrics = lm_loss(model, tokens.to(model.device))
                loss.backward()
            grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            return loss.item(), {k: v.item() for k, v in metrics.items()}, grads, routes

        want_loss, want_m, want_g, routes = loss_and_grads(cpu)
        free_loss, _, _, free_routes = loss_and_grads(card)
        loss, metrics, grads, _ = loss_and_grads(card, routes or None)
        flips = float(np.mean([np.any(np.sort(x, -1) != np.sort(y, -1), axis=-1).mean()
                               for x, y in zip(free_routes, routes)])) if routes else 0.0
        errs = {n: share_err(grads[n], want_g[n]) for n in want_g}
        worst = max(errs, key=errs.get)
        rel = max(abs(free_loss - want_loss), abs(loss - want_loss)) / abs(want_loss)
        aux_rel = abs(metrics["aux"] - want_m["aux"]) / abs(want_m["aux"]) if routes else 0.0
        check(all(np.isfinite([loss, free_loss])), f"[18] (a) {name}: non-finite loss")
        check(rel <= LM_TOL_LOSS and aux_rel <= LM_TOL_LOSS, f"[18] (a) {name}: loss off by "
              f"{rel:.3g} (aux {aux_rel:.3g})")
        check(flips <= LM_MOE_FLIPS, f"[18] (a) {name}: {flips:.3g} of the tokens routed to "
              f"other experts than on the CPU")
        check(errs[worst] <= LM_TOL_GRAD, f"[18] (a) {name}: the {worst} gradient is off by "
              f"{errs[worst]:.3g} of its largest value")

        # one train step each, from the same weights and zero state, on the CPU's routes
        bundle = ArchBundle(cfg, {"t": LMShape("t", "train", s, b)})
        cells = {"cpu": build_lm_cell(bundle, "t", device="cpu", model=cpu),
                 "card": build_lm_cell(bundle, "t", device=dev, model=card)}
        start = {k: p.detach().double().clone()
                 for k, p in leaves(cells["cpu"].train_state()["params"])}
        with port_routes(cpu) as routes:
            want_out = cells["cpu"].fn({"tokens": tokens})
        with port_routes(card, routes or None):
            out = cells["card"].fn({"tokens": tokens})
        states = {k: c.train_state() for k, c in cells.items()}
        step_rel = abs(out["loss"].item() - want_out["loss"].item()) / abs(want_out["loss"].item())
        lr = cells["cpu"].optimizer.param_groups[0]["lr"]
        check(lr == 1e-4, f"[18] (a) {name}: the train cell's lr is {lr}, not the reference's")
        p_worst, m_worst, u_worst = 0.0, 0.0, 0.0
        card_params = dict(leaves(states["card"]["params"]))
        for key, want_p in leaves(states["cpu"]["params"]):
            got_p = card_params[key].detach().double().cpu()
            want_p = want_p.detach().double()
            unit = 2.0**-7 if card_params[key].dtype == torch.bfloat16 else 2.0**-22
            over = ((got_p - want_p).abs() - (2 * lr + unit * want_p.abs())).max().item()
            p_worst = max(p_worst, over)
            gap_dir, gap_norm = update_gap(got_p.numpy(), want_p.numpy(), start[key].numpy())
            u_worst = max(u_worst, gap_dir / UPDATE_TOL_DIR, abs(gap_norm) / UPDATE_TOL_NORM)
        for slot, tree in states["cpu"]["opt"].items():
            if slot == "step":
                continue
            card_slot = dict(leaves(states["card"]["opt"][slot]))
            tol = LM_TOL_GRAD if slot == "mu" else 2 * LM_TOL_GRAD
            for key, want_v in leaves(tree):
                if want_v.abs().max() > 0:
                    m_worst = max(m_worst, share_err(card_slot[key], want_v) / tol)
        check(step_rel <= LM_TOL_LOSS, f"[18] (a) {name}: the train step's loss is off by "
              f"{step_rel:.3g}")
        check(p_worst <= 0.0, f"[18] (a) {name}: a parameter moved {p_worst:.3g} past 2·lr "
              f"+ one unit from the CPU's")
        check(m_worst <= 1.0, f"[18] (a) {name}: the optimizer state is off by {m_worst:.3g}× "
              f"its tolerance")
        check(u_worst <= 1.0, f"[18] (a) {name}: a parameter's update is off the CPU's by "
              f"{u_worst:.3g}× its tolerance")
        print(f"[18] (a) {name} reduced (L {cfg.n_layers}, d {cfg.d_model}, moe "
              f"{cfg.moe is not None}, {cfg.optimizer}), B {b} S {s} (255-token loss: a chunk of "
              f"128 and a tail), remat: card vs CPU loss {loss:.6f} / {want_loss:.6f} (rel "
              f"{rel:.3g}, tol {LM_TOL_LOSS}); {flips:.4f} of the tokens to other experts on the "
              f"card's own routes (allowed {LM_MOE_FLIPS}); on the CPU's routes every gradient "
              f"within {errs[worst]:.3g} of its largest value (worst {worst}, tol {LM_TOL_GRAD});"
              f" one {type(cells['card'].optimizer).__name__} step: loss rel {step_rel:.3g}, the "
              f"optimizer state within {m_worst:.3g}× its tolerance, params within 2·lr + one "
              f"unit, the updates within {u_worst:.3g}× theirs; {time.perf_counter() - t:.1f}s")
        del cells, states


def lm_train_full_width(dev, smi: str) -> None:
    """(b): granite-moe-1b-a400m's train_4k at every width, the batch cut."""
    import dataclasses

    from repro_torch.configs import ArchBundle, get_arch
    from repro_torch.data import Prefetcher, TokenStream
    from repro_torch.launch.steps import build_cell, lm_model_flops
    from repro_torch.models import padded_vocab
    from repro_torch.models.transformer import lm_loss

    bundle = get_arch(LM_TRAIN_ARCH)
    cfg, full = bundle.arch, bundle.shapes["train_4k"]
    shape = dataclasses.replace(full, global_batch=LM_TRAIN_BATCH)
    b, s = shape.global_batch, shape.seq_len
    vp = padded_vocab(cfg)
    tag = f"[18] (b) {cfg.name}:{shape.name}"
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cell = build_cell(ArchBundle(cfg, {shape.name: shape}), shape.name, device=dev, seed=0)
    torch.cuda.synchronize()
    meta = cell.static_meta
    print(f"{tag}: L {cfg.n_layers}, d {cfg.d_model}, H {cfg.n_heads}/{cfg.n_kv_heads} x "
          f"{cfg.head_dim}, moe {cfg.moe}, vocab {cfg.vocab} padded to {vp}, remat {cfg.remat}, "
          f"loss_chunk {cfg.loss_chunk}, {cfg.optimizer} lr "
          f"{cell.optimizer.param_groups[0]['lr']}; B = {b} (cut from {full.global_batch}), "
          f"S = {s}; {meta['n_params']} params, built with zero optimizer state in "
          f"{time.perf_counter() - t:.1f}s ({torch.cuda.memory_allocated() / GIB:.2f} GiB) "
          f"[{smi}]")
    inner_step, opt_events = cell.optimizer.step, []

    def timed_step(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner_step(*args, **kwargs)
        ev[1].record()
        opt_events.append(ev)
        return out

    cell.optimizer.step = timed_step
    stream = TokenStream(vocab=cfg.vocab, batch=b, seq_len=s, seed=0)
    pf = Prefetcher(stream.batch_at, depth=2)
    losses, step_ms, wall = [], [], []
    counter = DropCounter()
    try:
        for step in range(1 + LM_TRAIN_STEPS):
            got_step, tokens = pf.get()
            check(got_step == step, f"{tag}: the prefetcher gave step {got_step} for {step}")
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            t = time.perf_counter()
            with counter if step == 0 else contextlib.nullcontext():
                ev[0].record()
                out = cell.fn({"tokens": tokens})
                ev[1].record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
            step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append({k: v.item() for k, v in out.items()})
    finally:
        pf.close()
    peak = torch.cuda.max_memory_allocated()
    timed, opt_ms = step_ms[1:], [a.elapsed_time(z) for a, z in opt_events[1:]]
    med = float(np.median(timed))
    n_tok = b * s
    flops = lm_model_flops(cfg, n_tok)
    dropped, assigned = int(counter.dropped) // 2, counter.assigned // 2  # forward + recompute
    ceiling = 2 * math.log(vp)
    print(f"{tag}: losses (loss / ce / aux) " + "; ".join(
        f"{x['loss']:.5f} / {x['ce']:.5f} / {x['aux']:.5f}" for x in losses))
    print(f"{tag}: step {med:.1f} ms median of {LM_TRAIN_STEPS} after a warm-up of "
          f"{step_ms[0]:.1f} ms (CUDA events; min {min(timed):.1f}, max {max(timed):.1f}; host "
          f"wall median {1e3 * float(np.median(wall[1:])):.1f} ms), {n_tok / med * 1e3:.0f} "
          f"tokens/s; lm_model_flops(B·S) = {flops / 1e12:.1f} TFLOP (6·N_active·D) = "
          f"{flops / med * 1e3 / 1e12:.1f} TFLOP/s, {100 * flops / med * 1e3 / PEAK_BF16_DENSE_FLOP_PER_S:.2f}"
          f"% of the dense BF16 peak {PEAK_BF16_DENSE_FLOP_PER_S / 1e12:.0f} TFLOP/s (the "
          f"reference meta's model_flops, 3x that = {meta['model_flops'] / 1e12:.1f} TFLOP: "
          f"{100 * meta['model_flops'] / med * 1e3 / PEAK_BF16_DENSE_FLOP_PER_S:.2f}%); "
          f"optimizer pass {float(np.median(opt_ms)):.2f} ms median "
          f"({100 * float(np.median(opt_ms)) / med:.2f}% of a step); peak {peak / GIB:.2f} GiB "
          f"against the cell's reckoned {meta['analytic_bytes_global'] / GIB:.2f} GiB (the "
          f"reference's analytic bytes at B = {b}); {dropped} of {assigned} (token, expert) "
          f"assignments dropped in the warm-up step's forward [{smi}]")
    check(all(np.isfinite(x["loss"]) and x["loss"] < ceiling for x in losses),
          f"{tag}: a loss is not finite or not below 2·ln(V_pad) = {ceiling:.3f}")
    with torch.no_grad():
        fwd_ms, _ = events_ms(lambda: lm_loss(cell.model, torch.as_tensor(tokens, device=dev)))
    print(f"{tag}: the loss forward alone (no autograd) {fwd_ms:.1f} ms: the remat backward "
          f"repeats the layers' share of it")
    trace_run(f"{tag} one train step", lambda: cell.fn({"tokens": tokens}), LM_TRAIN_SHARES,
              host_ops=False)
    del cell.optimizer.step  # the wrapper, which holds the optimizer: no cycle left
    del cell, inner_step, timed_step, out
    torch.cuda.empty_cache()


def events_ms(fn) -> tuple[float, object]:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def lm_resume_runs(runs: list) -> None:
    """One process of (c): ``train_lm`` on the cut granite on its default
    device, once for each ``(steps, ckpt_dir or None, timed)`` of ``runs``;
    prints as its last line a JSON list, for each run: its losses, the
    device of its state, the sha1 of every leaf of its final state and,
    where ``timed``, the ms and MB of one more save of that state."""
    import dataclasses
    import hashlib
    import shutil

    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm

    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH).arch, n_layers=LM_RESUME_LAYERS)
    results = []
    for steps, ckpt_dir, timed in runs:
        out = train_lm(cfg, steps, LM_RESUME_BATCH, LM_RESUME_SEQ, ckpt_dir=ckpt_dir,
                       save_every=LM_RESUME_EVERY, log_every=steps)
        leaves = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    leaves[prefix + k] = v

        walk(out["state"])
        res = {"losses": out["losses"], "device": str(out["state"]["params"]["embed"].device),
               "sha1": {k: hashlib.sha1(v.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                                        .tobytes()).hexdigest() for k, v in leaves.items()}}
        if timed:
            mgr = CheckpointManager(tempfile.mkdtemp(), save_every=1, async_writes=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            mgr.maybe_save(steps - 1, out["state"], {"stream_step": steps})
            res["save_ms"] = (time.perf_counter() - t) * 1e3
            mgr.ckpt.close()
            saved = mgr.ckpt.step_dir(steps - 1)
            res["save_mb"] = sum(os.path.getsize(os.path.join(saved, fn))
                                 for fn in os.listdir(saved)) / 1e6
            shutil.rmtree(mgr.ckpt.root)
        results.append(res)
        del out, leaves
    print(json.dumps(results))


def lm_train_resume(smi: str) -> None:
    """(c): the launcher ``train_lm`` on granite at every width cut to
    LM_RESUME_LAYERS layers, B = LM_RESUME_BATCH, as a user runs it: a
    process that trains straight and then trains with checkpoints and
    stops, and a new process that resumes from the checkpoints."""
    import shutil

    from repro_torch.launch.train import LR

    steps, every = LM_RESUME_STEPS, LM_RESUME_EVERY
    stop = every + 1  # the first run's last step saves: the second resumes after it

    def child(runs: list) -> tuple[list, str, float]:
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                f"chip_smoke.lm_resume_runs({runs!r})")
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t
        check(proc.returncode == 0, f"[18] (c) a train_lm process failed (exit "
              f"{proc.returncode}): {proc.stderr[-3000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stdout, wall

    root = tempfile.mkdtemp(prefix="lm_resume_")
    try:
        (straight, first), _, wall_a = child([(steps, None, False), (stop, root, False)])
        check(straight["device"].startswith("cuda"),
              f"[18] (c) train_lm's default device is {straight['device']}, not the card")
        check(first["losses"] == straight["losses"][:stop], "[18] (c) the first run's losses "
              "differ from the straight run's")
        (resumed,), log, wall_b = child([(steps, root, True)])
        check(f"resumed from step {stop}" in log, f"[18] (c) the new process did not resume "
              f"after step {stop - 1}: {log[-2000:]}")
        check(resumed["losses"] == straight["losses"][stop:], f"[18] (c) the resumed run's "
              f"losses {resumed['losses']} are not the straight run's {straight['losses'][stop:]}")
        check(resumed["sha1"] == straight["sha1"], "[18] (c) the resumed train state differs "
              "from the straight run's")
        print(f"[18] (c) {smi}: train_lm (lr {LR}) on {LM_TRAIN_ARCH} at every width cut to "
              f"{LM_RESUME_LAYERS} layers, B = {LM_RESUME_BATCH}, S = {LM_RESUME_SEQ}, on its "
              f"default device ({straight['device']}): one process ran {steps} steps straight, "
              f"then {stop} steps saving every {every} through CheckpointManager(async_writes="
              f"True) into a temporary directory ({wall_a:.1f}s); a new process resumed after "
              f"step {stop - 1} and ran {len(resumed['losses'])} more ({wall_b:.1f}s): losses and "
              f"the whole train state ({len(straight['sha1'])} leaves: params, μ, ν, step) "
              f"bitwise equal; one save of the state {resumed['save_ms']:.1f} ms "
              f"({resumed['save_mb']:.1f} MB on disk)")
    finally:
        shutil.rmtree(root)


def lm_train_phase(dev, smi: str) -> None:
    """Phase 18: LM training on one card — (a) the five reduced archs against
    the CPU, (b) granite-moe-1b-a400m's train_4k at every published width,
    (c) an exact resume, (d) gemma-7b's train meta (see the module
    docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell

    t18 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    live = torch.cuda.memory_allocated()
    check(live < GIB, f"[18] {live / GIB:.2f} GiB allocated before the LM training phase")
    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "[18] bf16 GEMMs must reduce in f32")
    probe = torch.ones((1, 2, 2), dtype=torch.bfloat16, device=dev, requires_grad=True)
    overload = torch.bmm(probe, probe, out_dtype=torch.float32).grad_fn
    print(f"[18] {smi}; {live / GIB:.2f} GiB allocated before; bf16 reduced-precision "
          f"reductions off; torch.bmm(out_dtype=f32)'s own autograd node: "
          f"{type(overload).__name__ if overload is not None else None} (the port's "
          f"attention routes the score product under autograd through its own Function, "
          f"whose backward is the reference's f32 cotangent product)")
    t = time.perf_counter()
    lm_train_card_vs_cpu(dev)
    print(f"[18] (a) done in {time.perf_counter() - t:.1f}s [{smi}]")
    t = time.perf_counter()
    lm_train_full_width(dev, smi)
    print(f"[18] (b) done in {time.perf_counter() - t:.1f}s [{smi}]")
    t = time.perf_counter()
    lm_train_resume(smi)
    print(f"[18] (c) done in {time.perf_counter() - t:.1f}s [{smi}]")
    before = torch.cuda.memory_allocated()
    cell = build_cell(get_arch("gemma-7b"), "train_4k", device="meta")
    check(cell.model is None and torch.cuda.memory_allocated() == before,
          "[18] (d) the meta cell allocated")
    meta = cell.static_meta
    print(f"[18] (d) gemma-7b:train_4k meta only (no model made): {meta['n_params']} params, "
          f"params + grads + AdamW μ, ν = {meta['n_params'] * 12 / 1e9:.1f} GB (> one card's "
          f"80 GB), the reference's analytic bytes {meta['analytic_bytes_global'] / GIB:.1f} GiB "
          f"at B = {meta['tokens'] // 4096}, model_flops {meta['model_flops'] / 1e15:.2f} PFLOP "
          f"a step [{smi}]")
    check(dict(ops.LAUNCHES) == launches, f"[18] the LM training path launched a kernel of ours: "
          f"{ops.LAUNCHES} against {launches} before the phase")
    print(f"[18] LM training ok in {time.perf_counter() - t18:.1f}s, none of K1-K7 launched "
          f"[{smi}]")


# ----------------------------------------------------------------- phase 19
# GNN training on the card: no kernel of ours (the JAX GNN path reaches no
# pallas_call; its segment sums are jax.ops.segment_sum, index_add here)
GNN_ARCHS = ("gat-cora", "gin-tu", "graphcast", "meshgraphnet")
GNN_SM = "full_graph_sm"  # gat-cora's own Cora shape: 2 708 nodes, 10 556 arcs, 1 433 features
GNN_REDUCED = dict(n_layers=2, d_hidden=8)
GNN_PAD_ARCS = 64  # (a)'s flat batch: padding arcs into the sentinel row
# (b): AdamW's first steps overshoot on the 15-16 layer unnormalised residual
# stacks (graphcast on the card: 4 554 -> 471 166 -> 6 655 over 3 steps)
GNN_WIDTH_STEPS = 8
GNN_OGB_STEPS = 5  # timed, after a warm-up step
# (a) card against CPU: the CPU tests' rtols against the JAX package, the
# gradients' as shares of each leaf's largest |value|
GNN_FLAT_TOL = (1e-5, 1e-4)  # loss rtol, gradient share (tests/test_torch_gnn.py)
GNN_2D_TOL = (1e-4, 1e-3)  # tests/test_dist_gnn2d.py:_compare's
GNN_SHARES = {"gathers (index_select)": "gather", "index sums (index_add, atomic)": "indexFunc",
              "GEMMs": "gemm", "collectives (NCCL)": "nccl", "copies and casts": "copy",
              "device memcpy": "Memcpy", "fills (zeros)": "FillFunctor",
              "concatenations (the sentinel row)": "CatArrayBatchedCopy",
              "elementwise": "elementwise"}


def gnn_loss_grads(loss_of, params: dict) -> tuple[float, dict]:
    """(loss, {name: gradient on the CPU}) of ``loss_of(params)``."""
    loss = loss_of(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {k: g.detach().cpu() for k, g in zip(params, grads)}


def gnn_held(tag: str, got: tuple, want: tuple, tol: tuple) -> str:
    """Hold ``got`` = (loss, grads) to ``want`` at ``tol`` = (loss rtol,
    gradient share): every gradient within that share of its leaf's
    largest |value| (the card's atomic sums add in another order, and a
    reordered sum errs on the scale of its terms, which cancellation does
    not shrink).  Returns the largest errors, printed."""
    loss_rtol, share = tol
    check(abs(got[0] - want[0]) <= loss_rtol * abs(want[0]),
          f"{tag}: loss {got[0]!r} against {want[0]!r}")
    errs = {key: ((got[1][key] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            for key, w in want[1].items()}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= share, f"{tag}: gradient {worst} off by {errs[worst]:.3g} of its "
          f"largest value (limit {share})")
    return (f"loss {got[0]:.6f} vs {want[0]:.6f} (rel {abs(got[0] - want[0]) / abs(want[0]):.2e}),"
            f" largest gradient error {errs[worst]:.2e} of its leaf's largest ({worst})")


def gnn_card_vs_cpu(dev, groups, smi: str) -> None:
    """(a): the four reduced archs, flat and 2-D, card against CPU."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import full_graph_batch, to_2d_batch
    from repro_torch.graphs import sized_rmat_graph
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.models.gnn2d import gnn2d_local_batch, make_gnn2d_loss_fn

    spec = get_arch("gat-cora").shapes[GNN_SM]
    graph = sized_rmat_graph(spec.n_nodes, spec.n_edges, seed=0)
    n, d_feat = graph.n, spec.d_feat
    for name in GNN_ARCHS:
        cfg = dataclasses.replace(get_arch(name).arch, **GNN_REDUCED)
        d_out = gnn_mod.output_dim(cfg, spec)
        batch = full_graph_batch(cfg, graph, n, graph.num_arcs + GNN_PAD_ARCS, d_feat, d_out,
                                 spec.n_classes, seed=1)
        cpu_params = gnn_mod.init_params(cfg, d_feat, d_out, torch.Generator().manual_seed(0))
        card_params = {k: v.detach().to(dev).requires_grad_(True) for k, v in cpu_params.items()}
        flat = {k: torch.from_numpy(v) for k, v in batch.items()}
        flat_card = {k: v.to(dev) for k, v in flat.items()}
        want = gnn_loss_grads(lambda p: gnn_mod.gnn_loss(cfg, p, flat, "full_graph")[0],
                              cpu_params)
        got_flat = gnn_loss_grads(lambda p: gnn_mod.gnn_loss(cfg, p, flat_card, "full_graph")[0],
                                  card_params)
        b2d = to_2d_batch(batch, n, 1, 1)
        loss_fn = make_gnn2d_loss_fn(cfg, groups, "full_graph", chunk=n,
                                     max_arcs=b2d["src_local"].shape[2])
        local = gnn2d_local_batch(b2d, groups, dev)
        got_2d = gnn_loss_grads(lambda p: loss_fn(p, local), card_params)
        print(f"[19] (a) {name} (L {cfg.n_layers}, d {cfg.d_hidden}, d_out {d_out}) flat on the "
              f"card vs CPU: {gnn_held(f'[19] (a) {name} flat', got_flat, want, GNN_FLAT_TOL)}")
        print(f"[19] (a) {name} 2-D on the 1x1 NCCL grid vs CPU flat: "
              f"{gnn_held(f'[19] (a) {name} 2-D', got_2d, want, GNN_2D_TOL)} [{smi}]")


def gnn_published_widths(dev, groups, smi: str) -> None:
    """(b): the four archs at their published widths on full_graph_sm."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_gnn_cell

    for name in GNN_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        cell = build_gnn_cell(get_arch(name), GNN_SM, groups, device=dev, seed=0)
        cfg = get_arch(name).arch
        losses, ms = [], []
        for _ in range(GNN_WIDTH_STEPS):
            t_ms, out = events_ms(cell.fn)
            losses.append(out["loss"].item())
            ms.append(t_ms)
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"[19] (b) {cell.name}: the loss is not finite or did not fall: {losses}")
        print(f"[19] (b) {cell.name}: L {cfg.n_layers}, d_hidden {cfg.d_hidden} x {cfg.n_heads} "
              f"heads, {cell.static_meta['n_params']} params; {cell.setup['graph_n']} nodes, "
              f"{cell.setup['real_arcs']} arcs in {cell.max_arcs} slots; losses "
              f"{', '.join(f'{x:.5f}' for x in losses)}; step ms {', '.join(f'{x:.2f}' for x in ms)}"
              f" (CUDA events, the first with its allocations); peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB [{smi}]")
        del cell
    torch.cuda.empty_cache()


def gnn_ogb(dev, groups, smi: str) -> None:
    """(c): gin-tu:ogb_products at full width and full scale."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_gnn_cell
    from repro_torch.models.gnn import segment_sum

    bundle = get_arch("gin-tu")
    cfg, spec = bundle.arch, bundle.shapes["ogb_products"]
    tag = f"[19] (c) {cfg.name}:{spec.name}"
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    cell = build_gnn_cell(bundle, spec.name, groups, device=dev, seed=0)
    host_s = time.perf_counter() - t
    st, meta = cell.setup, cell.static_meta
    resident = torch.cuda.memory_allocated() - before
    n, A, d, L = st["graph_n"], cell.max_arcs, cfg.d_hidden, cfg.n_layers
    real = st["real_arcs"]
    check(n == spec.n_nodes and abs(st["graph_arcs"] - spec.n_edges) <= 0.01 * spec.n_edges
          and real == st["graph_arcs"],
          f"{tag}: the graph has {n} vertices and {st['graph_arcs']} arcs ({real} dealt)")
    print(f"{tag}: host set-up {host_s:.1f}s — sized_rmat_graph({spec.n_nodes}, {spec.n_edges}) "
          f"{st['graph_s']:.1f}s ({st['graph_arcs']} arcs, max degree {st['max_degree']}, "
          f"{st['isolated']} isolated vertices), full_graph_batch {st['batch_s']:.1f}s "
          f"({spec.d_feat} features, {spec.n_classes} classes), to_2d_batch 1x1 "
          f"{st['partition_s']:.1f}s ({A} slots, {A - real} padding), to the card "
          f"{st['device_s']:.1f}s ({resident / GIB:.2f} GiB resident); meta {json.dumps(meta)} "
          f"[{smi}]")
    losses, ms = [], []
    for _ in range(1 + GNN_OGB_STEPS):
        t_ms, out = events_ms(cell.fn)
        losses.append(out["loss"].item())
        ms.append(t_ms)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"{tag}: a loss is not finite: {losses}")
    med = float(np.median(ms[1:]))
    step_s = med / 1e3
    # bytes floors a step: 5 layers x 3 passes (forward, recompute, backward),
    # each moving one [A, d] f32 message block by the two index arrays
    passes = 3 * L
    fused = passes * (A * d * 4 + 2 * A * 4)  # the gathered rows read once
    unfused = passes * (2 * A * d * 4 + 2 * A * 4)  # ... written and read back
    peak_reckoned = resident + A * d * 4 + (L + 2) * n * d * 4
    print(f"{tag}: losses {', '.join(f'{x:.5f}' for x in losses)}; step {med:.1f} ms median of "
          f"{GNN_OGB_STEPS} after a warm-up of {ms[0]:.1f} ms (CUDA events; min "
          f"{min(ms[1:]):.1f}, max {max(ms[1:]):.1f}); {n / step_s:.4g} nodes/s, "
          f"{real / step_s:.4g} arcs/s ({A / step_s:.4g} slots/s); model_flops "
          f"{meta['model_flops']:.4g} = {100 * meta['model_flops'] / step_s / PEAK_F32_FLOP_PER_S:.2f}"
          f"% of the f32 peak {PEAK_F32_FLOP_PER_S / 1e12:.0f} TFLOP/s (the reference prices a "
          f"message MLP GIN does not have); bytes floors {fused / 1e9:.1f} GB (gathered rows read "
          f"once) = {100 * fused / PEAK_BYTES_PER_S / step_s:.1f}% and {unfused / 1e9:.1f} GB (the "
          f"[A, d] block written and read) = {100 * unfused / PEAK_BYTES_PER_S / step_s:.1f}% of "
          f"the step at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; peak {peak / GIB:.2f} GiB against a "
          f"reckoned {peak_reckoned / GIB:.2f} GiB (resident + one [A, d] f32 block + "
          f"{L + 2} [n, d] states) [{smi}]")
    first = gnn_loss_grads(lambda p: cell.loss_fn(p, cell.batch), cell.params)
    second = gnn_loss_grads(lambda p: cell.loss_fn(p, cell.batch), cell.params)
    same = first[0] == second[0] and all(torch.equal(first[1][k], second[1][k])
                                         for k in first[1])
    diff = max(((first[1][k] - second[1][k]).abs().max() / first[1][k].abs().max().clamp_min(
        1e-30)).item() for k in first[1])
    print(f"{tag}: two loss-and-gradient passes from one state: bitwise equal {same} (losses "
          f"{first[0]!r}, {second[0]!r}; largest gradient difference {diff:.2e} of the leaf's "
          f"largest)")
    hc = torch.randn((cell.chunk + 1, d), device=dev)
    src, dst = cell.batch["src_local"], cell.batch["dst_local"]
    every = cuda_time_ms(lambda: segment_sum(hc.index_select(0, src), dst, cell.chunk + 1))
    alone = cuda_time_ms(lambda: segment_sum(hc.index_select(0, src[:real]), dst[:real],
                                             cell.chunk + 1))
    print(f"{tag}: one gather-and-sum over every slot {every:.2f} ms against {alone:.2f} ms over "
          f"the {real} real arcs: the {A - real} padding arcs (source 0, the sentinel row) cost "
          f"{every - alone:.2f} ms a pass, ~{passes * (every - alone):.0f} ms a step")
    del hc
    trace_run(f"{tag} one train step", cell.fn, GNN_SHARES, host_ops=False)
    del cell, first, second
    torch.cuda.empty_cache()


def gnn_phase(dev, smi: str) -> None:
    """Phase 19: GNN training on one card — (a) the reduced archs card
    against CPU, (b) the published widths on full_graph_sm, (c)
    gin-tu:ogb_products at full scale, (d) no kernel of ours (see the
    module docstring)."""
    import torch.distributed as dist

    from repro_torch.distributed import GridGroups
    from repro_torch.kernels import ops

    t19 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    check(live < GIB, f"[19] {live / GIB:.2f} GiB allocated before the GNN phase")
    print(f"[19] {smi}; {live / GIB:.2f} GiB allocated before")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gnn_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            groups = GridGroups(1, 1, 1)
            for part, run in (("(a)", gnn_card_vs_cpu), ("(b)", gnn_published_widths),
                              ("(c)", gnn_ogb)):
                t = time.perf_counter()
                run(dev, groups, smi)
                print(f"[19] {part} done in {time.perf_counter() - t:.1f}s [{smi}]")
        finally:
            dist.destroy_process_group()
    check(dict(ops.LAUNCHES) == launches, f"[19] the GNN path launched a kernel of ours: "
          f"{ops.LAUNCHES} against {launches} before the phase")
    print(f"[19] (d) none of K1-K7 launched; GNN training ok in "
          f"{time.perf_counter() - t19:.1f}s [{smi}]")


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no repro_torch package under {SRC}: run from a checkout of the repository")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT / "tests"))  # torch_lm_routes: phase 18's comparisons
    import torch.distributed as dist

    from repro_torch.core.bc import device_adjacency, betweenness_centrality
    from repro_torch.core.brandes_ref import brandes_reference
    from repro_torch.core.distributed import (
        check_device_memory,
        distributed_betweenness_centrality,
    )
    from repro_torch.device import resolve_device
    from repro_torch.distributed import GridGroups
    from repro_torch.graphs import (
        disjoint_union,
        gnp_graph,
        grid_graph,
        partition_2d,
        rmat_graph,
        road_like_graph,
    )
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.blocked_spmm import nonzero_index
    from repro_torch.kernels.level_gemm import column_tile, fast_copies, operand_stride
    from repro_torch.roofline import counter as work

    t_all = time.perf_counter()
    dev = resolve_device("cuda")  # also switches TF32 off for matmul and cuDNN

    # ------------------------------------------------------ 1. environment
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1] torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"[1] device {kind}, count {torch.cuda.device_count()}, "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"[2] built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f}s")
    print(_build.build_log())
    _build.library()

    # ------------------- 9. DLRM-RM2 serving at full width (and K7's times)
    # first, while nothing else holds memory: the tables take 65 GiB
    k7_entries = dlrm_phase(dev, trace_run)

    # ------------------------------------- 16. DLRM training on the card
    # next, while nothing else holds memory: its state takes 52 GiB
    k7_train = train_phase(dev, trace_run, smi)
    for entry in k7_entries:
        entry["launches"] += k7_train

    # ---------------------------------------- 17. LM serving on the card
    # after phase 16 has freed its state: granite's decode cache takes 51.5 GB
    lm_phase(dev, smi)

    # --------------------------------------- 18. LM training on the card
    # after phase 17 has freed its caches: granite's train step takes ~57 GiB
    lm_train_phase(dev, smi)

    # --------------------------------------- 19. GNN training on the card
    # after phase 18 has freed its state: ogb_products' gathered messages take ~24 GB
    gnn_phase(dev, smi)

    # --------------------------------------------------- 3. kernel parity
    t3 = time.perf_counter()
    segment_bag_parity(dev)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for n, s in TEST_SHAPES:
        A32 = torch.from_numpy(
            gnp_graph(n, min(0.3, 8.0 / n), seed=n + s).dense_adjacency(np.float32)
        ).to(dev)
        sigma, depth, delta, omega = level_state(n, s, n + s, 2, dev)
        for tag, dt in dtypes.items():
            A = A32.to(dt)
            sg, dp = ops.frontier_spmm(A, sigma, depth, 2)
            sg_r, dp_r = ref.frontier_spmm_ref(A, sigma, depth, 2)
            dl = ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
            dl_r = ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1)
            ok_s, err_s = close(sg, sg_r, 1e-6, 0.0)
            ok_d, err_d = close(dl, dl_r, 1e-5, 1e-6)
            ok_dp = bool(torch.equal(dp, dp_r))
            print(f"[3] n={n} s={s} A={tag}: K1 σ err {err_s:.3g} depth exact {ok_dp}; "
                  f"K2 δ err {err_d:.3g}")
            check(ok_s and ok_dp and ok_d, f"kernel parity at n={n} s={s} A={tag}")

    graph = rmat_graph(MAIN_N_SCALE, MAIN_EF, seed=1)
    n_main = graph.n
    s_fwd = MAIN_BATCH
    s_bwd = MAIN_BATCH + MAIN_BATCH // 2  # explicit + derived columns of a round
    A_main = {"f32": device_adjacency(graph, torch.float32, dev)}
    A_main["bf16"] = A_main["f32"].to(torch.bfloat16)
    states = {s: level_state(n_main, s, s, 2, dev) for s in (s_fwd, s_bwd)}
    err_main: dict[tuple[str, str], float] = {}
    for tag in dtypes:
        A = A_main[tag]
        sigma, depth, _, _ = states[s_fwd]
        sg, dp = ops.frontier_spmm(A, sigma, depth, 2)
        sg_r, dp_r = ref.frontier_spmm_ref(A, sigma, depth, 2)
        ok_s, err_main[("frontier_spmm", tag)] = close(sg, sg_r, 1e-6, 0.0)
        check(ok_s and bool(torch.equal(dp, dp_r)), f"K1 parity at n={n_main} A={tag}")
        for s in (s_fwd, s_bwd):
            sigma, depth, delta, omega = states[s]
            dl = ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
            dl_r = ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1)
            ok_d, err = close(dl, dl_r, 1e-5, 1e-6)
            check(ok_d, f"K2 parity at n={n_main} s={s} A={tag}")
            if s == s_bwd:
                err_main[("dependency_spmm", tag)] = err
        del sg, dp, sg_r, dp_r, dl, dl_r
        print(f"[3] n={n_main} A={tag}: K1 σ err {err_main[('frontier_spmm', tag)]:.3g} "
              f"(s={s_fwd}), K2 δ err {err_main[('dependency_spmm', tag)]:.3g} (s={s_bwd})")

    def partial_parity(A, sigma, depth, delta, omega, acc, where) -> tuple[float, float]:
        """K3/K4 against their plain versions in plain and acc mode; returns
        the largest K3 and K4 errors."""
        e3 = e4 = 0.0
        for t_in in (None, acc):
            mode = "plain" if t_in is None else "acc"
            ok3, err3 = close(ops.frontier_spmm_partial(A, sigma, depth, 2, acc=t_in),
                              ref.frontier_partial_ref(A, sigma, depth, 2, t_in), 0.0, 0.0)
            e3 = max(e3, err3)
            ok4, err4 = close(ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1,
                                                          acc=t_in),
                              ref.dependency_partial_ref(A, sigma, depth, delta, omega, 1, t_in),
                              1e-5, 1e-6)
            check(ok3, f"K3 parity ({mode}) at {where}")
            check(ok4, f"K4 parity ({mode}) at {where}: err {err4:.3g}")
            e4 = max(e4, err4)
        return e3, e4

    for m, k, s in PARTIAL_SHAPES:
        A32 = torch.from_numpy(np.ascontiguousarray(
            gnp_graph(max(m, k), min(0.3, 8.0 / max(m, k)), seed=m + k + s)
            .dense_adjacency(np.float32)[:m, :k])).to(dev)
        sigma, depth, delta, omega = level_state(k, s, m + k + s, 2, dev)
        acc = torch.randint(0, 7, (m, s), device=dev).to(torch.float32)
        for tag, dt in dtypes.items():
            _, e4 = partial_parity(A32.to(dt), sigma, depth, delta, omega, acc,
                                   f"m={m} k={k} s={s} A={tag}")
            print(f"[3] K3/K4 m={m} k={k} s={s} A={tag}: K3 exact, K4 δ-side err {e4:.3g} "
                  f"(plain and acc)")
    # K1/K3's edges: every column tile and both copy paths of A (aligned
    # and at an offset), K3 in plain and acc mode; σ, depth and K3's t
    # exact (integer path counts); each launched twice, bitwise equal
    paths = set()
    for kdim in EDGE_KDIMS:
        A32 = torch.from_numpy(
            gnp_graph(kdim, min(0.3, 8.0 / kdim), seed=kdim).dense_adjacency(np.float32)).to(dev)
        for s in EDGE_WIDTHS:
            sigma, depth, _, _ = level_state(kdim, s, kdim + s, 2, dev)
            for tag, dt in dtypes.items():
                A = A32.to(dt)
                blk = A[:200].contiguous()
                acc = torch.randint(0, 7, (blk.shape[0], s), device=dev).to(torch.float32)
                want_s, want_d = ref.frontier_spmm_ref(A, sigma, depth, 2)
                want_t = {t_in is None: ref.frontier_partial_ref(blk, sigma, depth, 2, t_in)
                          for t_in in (None, acc)}
                for a, b in ((A, blk), (at_offset(A), at_offset(blk))):
                    paths.add(fast_copies(a))
                    for _ in range(2):
                        sg, dp = ops.frontier_spmm(a, sigma, depth, 2)
                        check(torch.equal(sg, want_s) and torch.equal(dp, want_d),
                              f"K1 parity at kdim={kdim} s={s} A={tag} "
                              f"fast={fast_copies(a)}")
                        for t_in in (None, acc):
                            check(torch.equal(ops.frontier_spmm_partial(b, sigma, depth, 2,
                                                                        acc=t_in),
                                              want_t[t_in is None]),
                                  f"K3 parity at [{b.shape[0]}, {kdim}] s={s} A={tag} "
                                  f"fast={fast_copies(b)} acc={t_in is not None}")
    check(paths == {True, False}, f"K1/K3 edges took the copy paths {paths} only")
    print(f"[3] K1/K3 edges kdim {EDGE_KDIMS} x s {EDGE_WIDTHS}, f32 and bf16 A, aligned and "
          f"at an offset (16-byte copies and element loads), K3 plain and acc: σ, depth and t "
          f"exact; two launches bitwise equal")
    # the 1×1 grid's block is the whole adjacency
    for tag in dtypes:
        for s in (s_fwd, s_bwd):
            sigma, depth, delta, omega = states[s]
            acc = torch.randint(0, 7, (n_main, s), device=dev).to(torch.float32)
            e3, e4 = partial_parity(A_main[tag], sigma, depth, delta, omega, acc,
                                    f"1x1 block n={n_main} s={s} A={tag}")
            err_main[("partial_1x1", tag, s)] = (e3, e4)
            del acc
        print(f"[3] K3/K4 1x1 block [{n_main}, {n_main}] A={tag}: K3 exact, K4 err "
              f"{err_main[('partial_1x1', tag, s_bwd)][1]:.3g} (s={s_bwd})")
    del A_main
    torch.cuda.empty_cache()
    # the [C·chunk, R·chunk] block of cell (0, 0) of a 2×4 grid, from the main graph
    part = partition_2d(graph, *BLOCK_GRID)
    m_blk, k_blk = part.C * part.chunk, part.R * part.chunk
    A_blk = {"f32": part.cell_dense_block(0, 0, torch.float32, dev)}
    A_blk["bf16"] = A_blk["f32"].to(torch.bfloat16)
    blk_states = {s: level_state(k_blk, s, s + 7, 2, dev) for s in (s_fwd, s_bwd)}
    for tag in dtypes:
        for s in (s_fwd, s_bwd):
            sigma, depth, delta, omega = blk_states[s]
            acc = torch.randint(0, 7, (m_blk, s), device=dev).to(torch.float32)
            err_main[("partial_blk", tag, s)] = partial_parity(
                A_blk[tag], sigma, depth, delta, omega, acc,
                f"2x4 block [{m_blk}, {k_blk}] s={s} A={tag}")
        print(f"[3] K3/K4 2x4 block [{m_blk}, {k_blk}] A={tag}: K3 exact, K4 err "
              f"{err_main[('partial_blk', tag, s_bwd)][1]:.3g} (s={s_bwd}), "
              f"{err_main[('partial_blk', tag, s_fwd)][1]:.3g} (s={s_fwd})")
    del A_blk
    torch.cuda.empty_cache()

    def sparse_parity(layout, m, st, acc, where, signed=False) -> tuple[float, float]:
        """K5/K6 against their plain versions in plain and acc mode (0/1
        tiles: K5 exact, K6 rtol 1e-5 / atol 1e-6; ``signed`` tile values:
        both within 1e-5 of Σ|a·x|, see close_to_sum), launched twice
        (bitwise equal), on a nonzero index with one entry per nonzero
        tile entry; returns the largest K5 and K6 errors."""
        tiles, rows, cols = layout
        sigma, depth, delta, omega = st
        index = nonzero_index(tiles, rows, cols, m)
        check(index.col.numel() == count_nonzero_tiles(tiles),
              f"the nonzero index of {where} does not hold every nonzero tile entry")
        e5 = e6 = 0.0
        for t_in in (None, acc):
            mode = "plain" if t_in is None else "acc"

            def k5():
                return ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m,
                                                acc=t_in, index=index)

            def k6():
                return ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1,
                                                  m=m, acc=t_in, index=index)

            got5, got6 = k5(), k6()
            want5 = ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m, t_in)
            want6 = ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta, omega, 1, m,
                                              t_in)
            if signed:  # σ, g and acc are >= 0: the plain version on |A| gives Σ|a·x|
                pos = tiles.abs()
                ok5, err5 = close_to_sum(got5, want5, ref.frontier_sparse_ref(
                    pos, rows, cols, sigma, depth, 2, m, t_in), 1e-5)
                ok6, err6 = close_to_sum(got6, want6, ref.dependency_sparse_ref(
                    pos, rows, cols, sigma, depth, delta, omega, 1, m, t_in), 1e-5)
            else:
                ok5, err5 = close(got5, want5, 0.0, 0.0)
                ok6, err6 = close(got6, want6, 1e-5, 1e-6)
            check(ok5, f"K5 parity ({mode}) at {where}: err {err5:.3g}")
            check(ok6, f"K6 parity ({mode}) at {where}: err {err6:.3g}")
            check(torch.equal(got5, k5()) and torch.equal(got6, k6()),
                  f"K5/K6 ({mode}) at {where}: two launches differ")
            e5, e6 = max(e5, err5), max(e6, err6)
        return e5, e6

    for num_tr, num_tc, bm, bk, s in SPARSE_SHAPES:
        m, kdim = num_tr * bm, num_tc * bk
        st = level_state(kdim, s, kdim + s, 2, dev)
        acc = torch.randint(0, 7, (m, s), device=dev).to(torch.float32)
        for complete in (True, False):  # fillers, or empty tile-rows
            layout = tile_list(num_tr, num_tc, bm, bk, num_tr + s, dev, complete)
            _, e6 = sparse_parity(layout, m, st, acc, f"{layout[0].shape[0]} tiles of {bm}x{bk}, "
                                  f"m={m} k={kdim} s={s} complete={complete}")
            # the same list with non-0/1 values (weighted tiles)
            gen = torch.Generator(device=dev).manual_seed(num_tr + s)
            weighted = (layout[0] * torch.randn(layout[0].shape, generator=gen, device=dev),)
            e5w, e6w = sparse_parity(weighted + layout[1:], m, st, acc,
                                     f"non-0/1 tiles {bm}x{bk} s={s}", signed=True)
        print(f"[3] K5/K6 random list {num_tr}x{num_tc} tiles of {bm}x{bk}, s={s}: K5 exact, K6 "
              f"err {e6:.3g} (plain and acc; filler rows and empty rows); signed normal tile "
              f"values: K5 {e5w:.3g}, K6 {e6w:.3g} of Σ|a·x|; index nnz = nonzero tile "
              f"entries; two launches bitwise equal")
    skew = skewed_list(dev, seed=3)
    for s in (MAIN_BATCH, MAIN_BATCH + MAIN_BATCH // 2):
        m = 4 * 128
        acc = torch.randint(0, 7, (m, s), device=dev).to(torch.float32)
        _, e6 = sparse_parity(skew, m, level_state(SKEW_TILES * 128, s, s, 2, dev), acc,
                              f"skewed list s={s}")
        index = nonzero_index(*skew, m)
        longest = int((index.ptr[1:] - index.ptr[:-1]).max())
        print(f"[3] K5/K6 skewed list ({SKEW_TILES + 4} tiles of 128x128, longest row {longest} "
              f"nonzeros in {int(index.long_ptr[1])} segments, {index.long_ptr.numel() - 1} long "
              f"rows) s={s}: K5 exact, K6 err {e6:.3g} (plain and acc)")
    del skew, index
    # the 1×1 cell layouts of phase 8, built as the engine builds them
    part_1x1 = partition_2d(graph, 1, 1)
    strips = disjoint_union(*[grid_graph(*STRIP_SHAPE)] * STRIPS)
    part_strips = partition_2d(strips, 1, 1)
    strip_states = {s: level_state(strips.n, s, s + 11, 2, dev) for s in (s_fwd, s_bwd)}
    strip_tag = f"strips {STRIPS}x{STRIP_SHAPE[0]}x{STRIP_SHAPE[1]} 1x1 tile 128"
    layouts = {  # phase 8 run tag -> (graph, partition, tile, states)
        "rmat16 1x1 tile 128": (graph, part_1x1, (None, None), states),
        f"rmat16 1x1 tile {SPARSE_TILE}": (graph, part_1x1, (SPARSE_TILE, SPARSE_TILE), states),
        strip_tag: (strips, part_strips, (None, None), strip_states),
    }
    for tag, (_, part_l, tile, st_map) in layouts.items():
        layout = part_l.cell_blocked_sparse(0, 0, *tile, device=dev)
        m = part_l.C * part_l.chunk
        for s in (s_fwd, s_bwd):
            acc = torch.randint(0, 7, (m, s), device=dev).to(torch.float32)
            err_main[("sparse", tag, s)] = sparse_parity(layout, m, st_map[s], acc, f"{tag} s={s}")
            del acc
        print(f"[3] K5/K6 {tag}: {layout[0].shape[0]} stored tiles of "
              f"{layout[0].shape[1]}x{layout[0].shape[2]} ({layout[0].nbytes / 2**30:.2f} GiB), "
              f"K5 exact, K6 err {err_main[('sparse', tag, s_bwd)][1]:.3g} (s={s_bwd}); index "
              f"nnz = nonzero tile entries; two launches bitwise equal")
        del layout
        torch.cuda.empty_cache()
    print(f"[3] parity ok in {time.perf_counter() - t3:.1f}s")

    # ------------------------------------------------ 4. main path, full width
    print(f"[4] graph rmat_graph({MAIN_N_SCALE}, {MAIN_EF}, seed=1): n={graph.n} "
          f"m={graph.num_edges}; batch {MAIN_BATCH}, h0, sampling fixed k={MAIN_SAMPLE_K}")
    print(f"[4] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    results, launches = {}, {}
    for engine in ("fused_bf16", "fused", "dense"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t = time.perf_counter()
        res = betweenness_centrality(
            graph, batch_size=MAIN_BATCH, heuristics="h0", engine_kind=engine,
            sampling="fixed", sample_k=MAIN_SAMPLE_K, sample_seed=0, device="cuda",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[engine] = dict(ops.LAUNCHES)
        results[engine] = res
        check(res.bc.shape == (graph.n,) and bool(np.isfinite(res.bc).all()),
              f"{engine}: BC must be finite of shape ({graph.n},)")
        check(res.rounds_run == MAIN_SAMPLE_K // MAIN_BATCH, f"{engine}: expected 4 rounds")
        print(f"[4] {engine}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), "
              f"{res.rounds_run} rounds, levels per round {res.round_levels}, "
              f"launches {launches[engine]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"GTEPS_bc (m·n/s, as the CLI reports it) "
              f"{graph.num_edges * graph.n / wall / 1e9:.3f}, GTEPS over the "
              f"{res.roots_accumulated} roots run of {res.sampling_stats['num_eligible']} "
              f"eligible (m·k/s) {graph.num_edges * res.roots_accumulated / wall / 1e9:.4f}")
        if engine != "dense":
            check(launches[engine]["frontier_spmm"] > 0 and launches[engine]["dependency_spmm"] > 0,
                  f"{engine}: the main path did not launch K1 and K2")
        del res
        torch.cuda.empty_cache()
    for engine in ("fused_bf16", "fused"):
        ok, err = close(torch.from_numpy(results[engine].bc),
                        torch.from_numpy(results["dense"].bc), 1e-5, 1e-5)
        print(f"[4] {engine} vs dense: max abs err {err:.3g}")
        check(ok, f"{engine} BC disagrees with dense at full width")
    trace4 = trace_run("[4] fused_bf16", lambda: betweenness_centrality(
        graph, batch_size=MAIN_BATCH, heuristics="h0", engine_kind="fused_bf16",
        sampling="fixed", sample_k=MAIN_SAMPLE_K, sample_seed=0, device="cuda"), {
        "K1": "frontier_spmm_kernel<", "K2": "dependency_spmm_kernel<",
        "K1 operand pass": ("operand_kernel", "FrontierOperand"),
        "K2 operand pass": ("operand_kernel", "DependencyOperand")})

    # ------------------------------------- 5. 2-D path, 1×1 grid, full width
    t5 = time.perf_counter()
    launches_2d = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            groups = GridGroups(1, 1, 1)
            # NCCL sets a communicator up at a group's first collective:
            # pay that once here, outside the timed runs
            t = time.perf_counter()
            warm = torch.zeros(1, device=dev)
            for g in (None, groups.column, groups.row, groups.grid, groups.replica):
                dist.all_reduce(warm, group=g)
            torch.cuda.synchronize()
            print(f"[5] NCCL communicators of the default and the four grid groups set up "
                  f"in {time.perf_counter() - t:.3f}s")

            def run_2d(engine):
                return distributed_betweenness_centrality(
                    graph, groups, batch_size=MAIN_BATCH, heuristics="h0", engine_kind=engine,
                    sampling="fixed", sample_k=MAIN_SAMPLE_K, sample_seed=0, full_result=True,
                )

            for engine in ("fused_bf16", "fused", "sparse"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t = time.perf_counter()
                res = run_2d(engine)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches_2d[engine] = dict(ops.LAUNCHES)
                check(res.bc.shape == (graph.n,) and bool(np.isfinite(res.bc).all()),
                      f"2-D {engine}: BC must be finite of shape ({graph.n},)")
                check(res.rounds_run == MAIN_SAMPLE_K // MAIN_BATCH,
                      f"2-D {engine}: expected 4 rounds")
                ok, err = close(torch.from_numpy(res.bc), torch.from_numpy(results["dense"].bc),
                                1e-5, 1e-5)
                print(f"[5] 2-D 1x1 {engine}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), "
                      f"{res.rounds_run} rounds, levels per round {res.round_levels}, "
                      f"launches {launches_2d[engine]}, peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, GTEPS_bc (m·n/s) "
                      f"{graph.num_edges * graph.n / wall / 1e9:.3f}, GTEPS over the "
                      f"{res.roots_accumulated} roots run (m·k/s) "
                      f"{graph.num_edges * res.roots_accumulated / wall / 1e9:.4f}; "
                      f"vs single-device dense: max abs err {err:.3g}")
                check(ok, f"2-D {engine} BC disagrees with the single-device dense engine")
                if engine == "fused":
                    fused_2d_bc = res.bc  # phase 13 (d)'s reference
                check(res.round_levels == results["dense"].round_levels,
                      f"2-D {engine}: levels per round differ from the single-device run")
                k12 = launches_2d[engine]["frontier_spmm"] + launches_2d[engine]["dependency_spmm"]
                check(k12 == 0, f"2-D {engine}: launched the single-device kernels K1/K2")
                fused = engine != "sparse"
                for kname in ("frontier_spmm_partial", "dependency_spmm_partial"):
                    n_k = kernel_launches(launches_2d[engine], kname)
                    check((n_k > 0) == fused, f"2-D {engine}: {kname} launches {n_k}")
                n_arc = launches_2d[engine]["arc_product"]
                check((n_arc > 0) != fused, f"2-D {engine}: arc_product launches {n_arc}")
                del res
                torch.cuda.empty_cache()
            trace5 = trace_run("[5] 2-D 1x1 fused", lambda: run_2d("fused"), {
                "K3": "frontier_partial_kernel<", "K4": "dependency_partial_kernel<",
                "K3 operand pass": ("operand_kernel", "FrontierOperand"),
                "K4 operand pass": ("operand_kernel", "DependencyOperand"), "NCCL": "nccl"})
            print(f"[5] 2-D path ok in {time.perf_counter() - t5:.1f}s")

            # ------------------------- 8. the BCSR path, 1×1 grid, full width
            t8 = time.perf_counter()
            total_mem = torch.cuda.get_device_properties(0).total_memory
            print(f"[8] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
            k14 = ("frontier_spmm", "dependency_spmm", "frontier_spmm_partial",
                   "dependency_spmm_partial")
            walls_8 = {}

            def run_8(tag, g, want, **kw):
                """One BCSR run, checked against ``want`` (a BCResult)."""
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                live = torch.cuda.memory_allocated()  # held by this script, not the run
                ops.reset_launches()
                t = time.perf_counter()
                res = distributed_betweenness_centrality(
                    g, groups, batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed",
                    sample_seed=0, full_result=True, hbm_limit_bytes=total_mem, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches_2d[tag] = dict(ops.LAUNCHES)
                walls_8[tag] = wall
                check(res.bc.shape == (g.n,) and bool(np.isfinite(res.bc).all()),
                      f"[8] {tag}: BC must be finite of shape ({g.n},)")
                ok, err = close(torch.from_numpy(res.bc), torch.from_numpy(want.bc), 1e-5, 1e-5)
                lay = res.layout_stats
                foot = lay["footprint"]
                ix = lay["index"]
                print(f"[8] {tag} set-up: nonzero index of the rank's tiles, {ix['nnz']} entries, "
                      f"{ix['bytes'] / 2**20:.2f} MiB, built in {ix['build_s']:.3f}s")
                print(f"[8] {tag} ({kw['engine_kind']}): wall {wall:.3f}s (round loop "
                      f"{res.wall_s:.3f}s), {res.rounds_run} rounds, levels per round "
                      f"{res.round_levels}, tile {lay['tile']}, stored tiles "
                      f"{lay['stored_tiles_max']} ({lay['nnz_tiles_total']} nonzero)"
                      + (f", dense cells {lay['dense_cells']}" if "dense_cells" in lay else "")
                      + f", footprint {foot['total_bytes'] / 2**30:.2f} GiB (adjacency "
                      f"{foot['adjacency_bytes'] / 2**30:.2f}) vs peak allocated by the run "
                      f"{(torch.cuda.max_memory_allocated() - live) / 2**30:.2f} GiB (above "
                      f"{live / 2**30:.2f} GiB live before it), launches "
                      f"{launches_2d[tag]}; max abs err {err:.3g}")
                check(ok, f"[8] {tag}: BC disagrees with its reference")
                check(res.round_levels == want.round_levels, f"[8] {tag}: levels per round differ")
                check(sum(kernel_launches(launches_2d[tag], k) for k in k14) == 0,
                      f"[8] {tag}: launched K1-K4")
                check(kernel_launches(launches_2d[tag], "frontier_spmm_sparse") > 0
                      and kernel_launches(launches_2d[tag], "dependency_spmm_sparse") > 0,
                      f"[8] {tag}: the run did not launch K5 and K6")
                return res

            # (a) the main-path graph and roots, against single-device dense
            a_kw = dict(sample_k=MAIN_SAMPLE_K)
            for tag, kw in (("rmat16 1x1 tile 128", dict(engine_kind="fused_sparse")),
                            (f"rmat16 1x1 tile {SPARSE_TILE}",
                             dict(engine_kind="fused_sparse", tile=(SPARSE_TILE, SPARSE_TILE))),
                            ("rmat16 1x1 hybrid", dict(engine_kind="fused_hybrid",
                                                       hybrid_threshold=1.0))):
                res = run_8(tag, graph, results["dense"], **a_kw, **kw)
                if kw["engine_kind"] == "fused_hybrid":
                    check(res.layout_stats["dense_cells"] == [[0]],
                          "[8] the bytes model should pick BCSR for the 1x1 R-MAT cell")
                del res
                torch.cuda.empty_cache()
            # (b) a graph whose dense block no card holds
            b_kw = dict(sample_k=STRIP_SAMPLE_K)
            before = torch.cuda.memory_allocated()
            try:
                check_device_memory(part_strips, "fused", MAIN_BATCH, total_mem)
                fail("[8] the memory guard let fused through on the strip graph")
            except MemoryError as err:
                check("fused_sparse" in str(err), "[8] the guard did not suggest fused_sparse")
                check(torch.cuda.memory_allocated() == before, "[8] the guard allocated")
                print(f"[8] {STRIPS} disjoint grid_graph{STRIP_SHAPE} strips, n={strips.n}, "
                      f"m={strips.num_edges}: memory guard (budget = total_memory "
                      f"{total_mem / 2**30:.2f} GiB) refused fused before allocating: {err}")
            t = time.perf_counter()
            arc = distributed_betweenness_centrality(
                strips, groups, batch_size=MAIN_BATCH, heuristics="h0", engine_kind="sparse",
                sampling="fixed", sample_seed=0, full_result=True, **b_kw)
            print(f"[8] {strip_tag} sparse (arc list, the reference): wall "
                  f"{time.perf_counter() - t:.3f}s (round loop {arc.wall_s:.3f}s), levels per "
                  f"round {arc.round_levels}")
            check(arc.bc.shape == (strips.n,) and bool(np.isfinite(arc.bc).all()),
                  "[8] the arc-list BC of the strip graph must be finite")
            strips_barrier = run_8(strip_tag, strips, arc, engine_kind="fused_sparse", **b_kw)
            torch.cuda.empty_cache()
            trace_run(f"[8] {strip_tag} fused_sparse", lambda: distributed_betweenness_centrality(
                strips, groups, batch_size=MAIN_BATCH, heuristics="h0", engine_kind="fused_sparse",
                sampling="fixed", sample_seed=0, **b_kw), {
                "K5 operand pass": ("operand_kernel", "FrontierOperand"),
                "K6 operand pass": ("operand_kernel", "DependencyOperand"),
                "K5/K6 gather pass": "gather_kernel<", "K5/K6 combine pass": "combine_kernel(",
                "NCCL": "nccl"})
            print(f"[8] BCSR path ok in {time.perf_counter() - t8:.1f}s")

            # ------------- 10. durable, self-checking and served BC
            launches_10 = durable_phase(dev, graph, groups, results["fused"])

            # ------------------------- 11. weighted BC at full width
            weighted_phase(graph, groups, results["dense"], smi, trace_run)

            # ---------- 12. the ring schedules and the grid's checked steps
            ring_entries = ring_phase(dev, graph, groups, results["dense"], part, blk_states,
                                      strips, strips_barrier, walls_8[strip_tag], smi)

            # ------ 13. the straggler loop and the grid's recovery knobs
            straggler_phase(dev, graph, groups, results["fused"], fused_2d_bc, smi)

            # ------- 14. measured-cost autotuning and the chaos harness
            launches_14 = autotune_chaos_phase(dev, graph, groups, fused_2d_bc, smi)

            # -------- 15. the paper's own configuration at R-MAT scale 23
            arc_entries = rmat_cell_phase(dev, groups, smi)
        finally:
            dist.destroy_process_group()

    # ------------------------------------------------------- 6. exact BC
    t6 = time.perf_counter()
    for name, g in (("rmat_graph(10, 16, seed=1)", rmat_graph(10, 16, seed=1)),
                    ("road_like_graph(20, 20, seed=1)", road_like_graph(20, 20, seed=1))):
        want = brandes_reference(g)
        for heur in ("h0", "h3t"):
            for engine in ("fused", "fused_bf16"):
                got = betweenness_centrality(g, batch_size=MAIN_BATCH, heuristics=heur,
                                             engine_kind=engine, device="cuda").bc
                ok, err = close(torch.from_numpy(got), torch.from_numpy(want), 1e-5, 1e-5)
                print(f"[6] {name} {heur} {engine} vs oracle: max abs err {err:.3g}")
                check(ok, f"{name} {heur} {engine} disagrees with brandes_reference")
    g13 = rmat_graph(13, 16, seed=1)
    dense13 = betweenness_centrality(g13, batch_size=MAIN_BATCH, heuristics="h3",
                                     engine_kind="dense", device="cuda").bc
    for engine in ("fused", "fused_bf16"):
        got = betweenness_centrality(g13, batch_size=MAIN_BATCH, heuristics="h3",
                                     engine_kind=engine, device="cuda").bc
        ok, err = close(torch.from_numpy(got), torch.from_numpy(dense13), 1e-5, 1e-5)
        print(f"[6] rmat_graph(13, 16, seed=1) h3 {engine} vs dense: max abs err {err:.3g}")
        check(ok, f"rmat 13 h3 {engine} disagrees with dense")
    print(f"[6] exact BC ok in {time.perf_counter() - t6:.1f}s")

    # ------------------------------------------------------------ 7. times
    A_main = {"f32": device_adjacency(graph, torch.float32, dev)}
    A_main["bf16"] = A_main["f32"].to(torch.bfloat16)
    engine_of = {"f32": "fused", "bf16": "fused_bf16"}
    print(f"[7] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    for line in ptxas_report(_build.build_log(), (
            "frontier_spmm_kernel", "dependency_spmm_kernel", "frontier_partial_kernel",
            "dependency_partial_kernel", "operand_kernel")):
        print(f"[7] ptxas {line}")
    entries = []

    def width_row(kname, where, A, st, s) -> float:
        """K1/K2/K4 at the other width s beside torch.matmul (f32 A) and
        the bound; returns the kernel's ms."""
        sigma, depth, delta, omega = st
        m, k = A.shape
        if kname == "frontier_spmm":
            ms = cuda_time_ms(lambda: ops.frontier_spmm(A, sigma, depth, 2))
            make_operand = lambda: sigma * (depth == 1)
            nbytes = work.frontier_bytes(A, sigma, depth)
        else:
            fn = (ops.dependency_spmm if kname == "dependency_spmm"
                  else ops.dependency_spmm_partial)
            ms = cuda_time_ms(lambda: fn(A, sigma, depth, delta, omega, 1))
            make_operand = lambda: dep_operand(sigma, depth, delta, omega)
            nbytes = work.partial_bytes(A, sigma, depth, delta, omega)
        lib = "n/a (bf16 A)"
        if A.dtype == torch.float32:
            operand = make_operand()
            lib = f"{cuda_time_ms(lambda: torch.matmul(A, operand)):.3f} ms"
            del operand
        t_ops = work.dense_flops(m, k, s) / PEAK_F32_FLOP_PER_S * 1e3
        bound = max(t_ops, nbytes / PEAK_BYTES_PER_S * 1e3)
        tag = "bf16" if A.dtype == torch.bfloat16 else "f32"
        print(f"[7] {kname} A={tag} {where} s={s}: kernel {ms:.3f} ms, torch.matmul {lib}, "
              f"bound {bound:.3f} ms, {100 * bound / ms:.1f}% of bound")
        return ms

    def real_path_row(kname, tag, trace, label, synthetic_ms) -> None:
        """The per-launch device time of a kernel on the main path (a
        traced run's real states) beside its time on phase 7's states."""
        main_ms, n = trace[label]
        operand_ms, n_op = trace[f"{label} operand pass"]
        check(n > 0 and n == n_op, f"{kname}: traced {n} launches and {n_op} operand passes")
        per = (main_ms + operand_ms) / n
        print(f"[7] {kname} A={tag} real path: {per:.3f} ms a launch (main loop "
              f"{main_ms / n:.3f} + operand pass {operand_ms / n:.3f} ms, {n} launches traced) "
              f"against {synthetic_ms:.3f} ms on the random states here")

    for kname, s, src, replaces in (
        ("frontier_spmm", s_fwd, "src/repro_torch/kernels/csrc/frontier_spmm.cu",
         "src/repro/kernels/frontier_spmm.py:40"),
        ("dependency_spmm", s_bwd, "src/repro_torch/kernels/csrc/dependency_spmm.cu",
         "src/repro/kernels/dependency_spmm.py:36"),
    ):
        sigma, depth, delta, omega = states[s]
        for tag in dtypes:
            A = A_main[tag]
            if kname == "frontier_spmm":
                kern = lambda: ops.frontier_spmm(A, sigma, depth, 2)
                plain = lambda: ref.frontier_spmm_ref(A, sigma, depth, 2)
                operand = sigma * (depth == 1)
                nbytes = work.frontier_bytes(A, sigma, depth)
            else:
                kern = lambda: ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
                plain = lambda: ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1)
                operand = dep_operand(sigma, depth, delta, omega)
                nbytes = work.dependency_bytes(A, sigma, depth, delta, omega)
            ms = cuda_time_ms(kern)
            plain_ms = cuda_time_ms(plain)
            # one library call computing the same product: only for an f32
            # adjacency (a bf16 matmul would round σ)
            lib_ms = (cuda_time_ms(lambda: torch.matmul(A, operand))
                      if tag == "f32" else None)
            flops = work.dense_flops(n_main, n_main, s)
            t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            entries.append({
                "name": f"{kname}[{tag} A]",
                "route": "cuda",
                "source": src,
                "replaces": replaces,
                "launches": launches[engine_of[tag]][kname],
                "max_abs_err": err_main[(kname, tag)],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib_ms,
            })
            print(f"[7] {kname} A={tag} n={n_main} s={s}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, torch.matmul {lib_ms if lib_ms is None else f'{lib_ms:.3f}'} ms, "
                  f"bound {bound:.3f} ms ({entries[-1]['bound_by']}; ops {t_ops:.3f} / bytes "
                  f"{t_bytes:.3f}), {100 * bound / ms:.1f}% of bound")
            del operand
            if kname == "dependency_spmm" and tag == "f32":
                print(f"[7] dependency_spmm A=f32 s={s}, 60 launches: "
                      + clocks_during(lambda: cuda_time_ms(kern, reps=60)))
            if tag == "bf16":  # phase 4 traced fused_bf16
                real_path_row(kname, tag, trace4, "K1" if kname == "frontier_spmm" else "K2", ms)
        # K1 also at the backward width, K2 at the forward one
        s_other = s_bwd if kname == "frontier_spmm" else s_fwd
        for tag in dtypes:
            width_row(kname, f"n={n_main}", A_main[tag], states[s_other], s_other)
    # K3/K4 at the 1×1 grid's block (the 2-D main path's shape) and at the
    # per-device block of a 2×4 grid, each at its main-path width
    A_blk = {"f32": part.cell_dense_block(0, 0, torch.float32, dev)}
    A_blk["bf16"] = A_blk["f32"].to(torch.bfloat16)
    partial_engine = {"f32": "fused", "bf16": "fused_bf16"}
    for kname, s, replaces in (
        ("frontier_spmm_partial", s_fwd, "src/repro/kernels/frontier_spmm.py:149"),
        ("dependency_spmm_partial", s_bwd, "src/repro/kernels/dependency_spmm.py:139"),
    ):
        for shape_tag, blocks, st, err_key in (
            ("1x1", A_main, states, "partial_1x1"), ("2x4", A_blk, blk_states, "partial_blk"),
        ):
            sigma, depth, delta, omega = st[s]
            for tag in dtypes:
                A = blocks[tag]
                m, k = A.shape
                if kname == "frontier_spmm_partial":
                    kern = lambda: ops.frontier_spmm_partial(A, sigma, depth, 2)
                    plain = lambda: ref.frontier_partial_ref(A, sigma, depth, 2)
                    operand = sigma * (depth == 1)
                    nbytes = work.partial_bytes(A, sigma, depth)
                    err = err_main[(err_key, tag, s)][0]
                else:
                    kern = lambda: ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1)
                    plain = lambda: ref.dependency_partial_ref(A, sigma, depth, delta, omega, 1)
                    operand = dep_operand(sigma, depth, delta, omega)
                    nbytes = work.partial_bytes(A, sigma, depth, delta, omega)
                    err = err_main[(err_key, tag, s)][1]
                ms = cuda_time_ms(kern)
                plain_ms = cuda_time_ms(plain)
                lib_ms = (cuda_time_ms(lambda: torch.matmul(A, operand))
                          if tag == "f32" else None)
                t_ops = work.dense_flops(m, k, s) / PEAK_F32_FLOP_PER_S * 1e3
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                bound = max(t_ops, t_bytes)
                entries.append({
                    "name": f"{kname}[{tag} A, {shape_tag} block {m}x{k}]",
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/partial_spmm.cu",
                    "replaces": replaces,
                    "launches": kernel_launches(launches_2d[partial_engine[tag]], kname),
                    "max_abs_err": err,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": lib_ms,
                })
                print(f"[7] {kname} A={tag} {shape_tag} block [{m}, {k}] s={s}: kernel "
                      f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul "
                      f"{lib_ms if lib_ms is None else f'{lib_ms:.3f}'} ms, bound {bound:.3f} ms "
                      f"({entries[-1]['bound_by']}; ops {t_ops:.3f} / bytes {t_bytes:.3f}), "
                      f"{100 * bound / ms:.1f}% of bound")
                del operand
                if shape_tag == "1x1" and tag == "f32":  # phase 5 traced the 2-D fused (f32) run
                    real_path_row(kname, tag, trace5,
                                  "K3" if kname == "frontier_spmm_partial" else "K4", ms)
            if kname == "dependency_spmm_partial":  # K4 also at the forward width
                for tag in dtypes:
                    width_row(kname, f"{shape_tag} block", blocks[tag], st[s_fwd], s_fwd)
    # K3/K4 at the ABFT lane's widths s + 1: the checked steps of phase 10
    # (b) on the square adjacency (f32 A, the path's)
    for kname, s, replaces in (
        ("frontier_spmm_partial", s_fwd + 1, "src/repro/kernels/frontier_spmm.py:149"),
        ("dependency_spmm_partial", s_bwd + 1, "src/repro/kernels/dependency_spmm.py:139"),
    ):
        A = A_main["f32"]
        sigma, depth, delta, omega = level_state(n_main, s, s + 3, 2, dev)
        if kname == "frontier_spmm_partial":
            kern = lambda: ops.frontier_spmm_partial(A, sigma, depth, 2)
            plain = lambda: ref.frontier_partial_ref(A, sigma, depth, 2)
            operand = sigma * (depth == 1)
            nbytes = work.partial_bytes(A, sigma, depth)
            ok, err = close(kern(), plain(), 0.0, 0.0)
        else:
            kern = lambda: ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1)
            plain = lambda: ref.dependency_partial_ref(A, sigma, depth, delta, omega, 1)
            operand = dep_operand(sigma, depth, delta, omega)
            nbytes = work.partial_bytes(A, sigma, depth, delta, omega)
            ok, err = close(kern(), plain(), 1e-5, 1e-6)
        check(ok, f"{kname} parity at the lane width s={s}: err {err:.3g}")
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain)
        lib_ms = cuda_time_ms(lambda: torch.matmul(A, operand))
        t_ops = work.dense_flops(n_main, n_main, s) / PEAK_F32_FLOP_PER_S * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        entries.append({
            "name": f"{kname}[f32 A, checksum lane, square {n_main}x{n_main}, s={s}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/partial_spmm.cu",
            "replaces": replaces,
            "launches": kernel_launches(launches_10, kname),
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
        print(f"[7] {kname} A=f32 checksum lane n={n_main} s={s} (column tile "
              f"{column_tile(s)}, operand stride {operand_stride(s)}): kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound {bound:.3f} ms "
              f"({entries[-1]['bound_by']}), {100 * bound / ms:.1f}% of bound, "
              f"{kernel_launches(launches_10, kname)} launches in phase 10 (b); err {err:.3g}")
        del sigma, depth, delta, omega, operand
    del A_main, A_blk
    torch.cuda.empty_cache()
    # K5/K6 at phase 8's three cell layouts, each at its main-path width
    for tag, (g_l, part_l, tile, st_map) in layouts.items():
        tiles, rows, cols = part_l.cell_blocked_sparse(0, 0, *tile, device=dev)
        num_tiles, bm, bk = tiles.shape
        m = part_l.C * part_l.chunk
        index = nonzero_index(tiles, rows, cols, m)
        # the library yardstick: the same 1x1 cell (A[dst, src] = 1) as a CSR tensor
        idx = torch.from_numpy(np.stack([g_l.dst, g_l.src])).to(dev, torch.int64)
        csr = torch.sparse_coo_tensor(idx, torch.ones(idx.shape[1], device=dev),
                                      (m, m)).coalesce().to_sparse_csr()
        del idx
        for kname, s, replaces in (
            ("frontier_spmm_sparse", s_fwd, "src/repro/kernels/blocked_spmm.py:143"),
            ("dependency_spmm_sparse", s_bwd, "src/repro/kernels/blocked_spmm.py:145"),
        ):
            sigma, depth, delta, omega = st_map[s]
            if kname == "frontier_spmm_sparse":
                kern = lambda: ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m,
                                                        index=index)
                plain = lambda: ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m)
                make_operand = lambda: sigma * (depth == 1)
                nbytes = work.sparse_bytes(index, sigma, depth)
                err = err_main[("sparse", tag, s)][0]
            else:
                kern = lambda: ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta,
                                                          omega, 1, m=m, index=index)
                plain = lambda: ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta,
                                                          omega, 1, m)
                make_operand = lambda: dep_operand(sigma, depth, delta, omega)
                nbytes = work.sparse_bytes(index, sigma, depth, delta, omega)
                err = err_main[("sparse", tag, s)][1]
            operand = make_operand()
            ms = cuda_time_ms(kern, reps=20)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                kern()
            host_ms = (time.perf_counter() - t) / 20 * 1e3
            torch.cuda.synchronize()
            plain_ms = cuda_time_ms(plain)
            lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, operand), reps=20)
            lib_build_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, make_operand()), reps=20)
            nnz = index.col.numel()
            t_ops = work.sparse_flops(nnz, s) / PEAK_F32_FLOP_PER_S * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            t_tile = 2.0 * num_tiles * bm * bk * s / PEAK_F32_FLOP_PER_S * 1e3
            entries.append({
                "name": f"{kname}[{tag}: {num_tiles} tiles of {bm}x{bk}, {nnz} nonzeros]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/sparse_spmm.cu",
                "replaces": replaces,
                "launches": kernel_launches(launches_2d[tag], kname),
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms,
            })
            print(f"[7] {kname} {tag} ({num_tiles} tiles of {bm}x{bk}, index {nnz} nonzeros, "
                  f"{index.nbytes() / 1e6:.2f} MB held with its work list) s={s}: the TPU "
                  f"design's tile-FFMA work 2·T·bm·bk·s would take {t_tile:.3f} ms at the f32 "
                  f"rate")
            print(f"[7] {kname} {tag} s={s}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"torch.sparse.mm (CSR, {csr.values().numel()} nonzeros) {lib_ms:.3f} ms "
                  f"({lib_build_ms:.3f} ms with the operand's build), bound {bound:.4f} ms "
                  f"({entries[-1]['bound_by']}; bytes {t_bytes:.4f}: {nbytes / 1e6:.1f} MB / ops "
                  f"{t_ops:.4f}), {100 * bound / ms:.1f}% of bound, {nbytes / ms / 1e6:.0f} GB/s "
                  f"effective; host time to enqueue one call {host_ms:.3f} ms")
            del operand
        del tiles, rows, cols, csr, index
        torch.cuda.empty_cache()
    entries.extend(ring_entries)  # timed in phase 12 (b), on the 2x4 cell's slabs and slots
    rows_14, other_14 = launches_14  # phase 14's launches, each to its configuration's row
    for row, counts in rows_14.items():
        for kname, n in counts.items():
            hit = [e for e in entries if e["name"].startswith(f"{kname}[{row}")]
            check(len(hit) == 1, f"[7] phase 14's {kname} launches at [{row}: {len(hit)} rows")
            hit[0]["launches"] += n
            print(f"[7] {hit[0]['name']}: + {n} launches in phase 14")
    print(f"[7] phase 14's launches at configurations with no row of their own: {other_14}")
    entries.extend(k7_entries)  # timed in phase 9, on its tables
    entries.extend(arc_entries)  # timed in phase 15, on the s23 cell's arcs
    print(f"[7] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    print(f"[7] total {time.perf_counter() - t_all:.1f}s")

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
