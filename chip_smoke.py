#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the TinyLFU engine on one GPU: the device
trace engine (one stream, tenant lanes, sweeps, the sharded sketch, the
adaptive window and its command-line driver, the policy panel,
checkpoint/resume and fault injection, the paper's trace families beside
the host engine), the serving-admission
path (device and host sketch), the LLM serving path (every model family:
dense, MoE, VLM, audio, hybrid SSM and xLSTM) and training (every family,
through the flash forward's training instance and its backward kernel;
sharded over a grid of ranks).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on).
Where a phase holds the step kernel against its plain version over a list of
cases, the plain version of each case runs on the host's CPU in a pool of
six worker processes (started at phase 2, stopped at exit) while the card
runs the kernel, and the plain version at the main run's geometry on the
card, timed:

1. print the card's name and power limit, build the seven kernels, the step
   kernel's adaptive instances (a second build of ``sketch_step.cu`` with
   ``-DSKETCH_STEP_ADAPTIVE``), its policy panel's (a third, with
   ``-DSKETCH_STEP_PANEL``), the reset and estimate in plain stream order
   (``-DSKETCH_NO_PDL``), the empty-launch probe (``l2_chase.cu``) and the
   first designs of the reset, estimate and admit (``sketch_baseline.cu``)
   from ``src/repro_torch/kernels/csrc`` (one nvcc per build, all at once)
   and print each build's nvcc wall time and ptxas register/spill lines
   (nvcc takes ~10-14 s for each of the step kernel's two builds of 20
   instances and ~9.4 s for the panel's 24, side by side: ~15 s for phase
   1 in all on an H100 host);
2. hold the kernel (``step``) against its plain PyTorch version
   (``step_ref``): flat and set-associative tables, 4- and 8-bit
   counters, doorkeeper on and off, resets inside and across chunk
   boundaries, padded tails, the hazard traces of ``check_runs.HAZARD_CASES``
   (runs of one key, one- and two-set tables, alternating keys, resets at
   every chunk boundary and mid-chunk; 4, 8 and 16 ways) and the main run's
   own geometry; every state leaf and hit flag must be equal;
3. run the golden traces G1-G6 through ``simulate_trace`` on the card; hit
   counts (and, for G1/G2/G4, the final registers and a digest of the whole
   state) must equal the values the JAX engine gives on the same traces;
4. run F, the main path at its real size (C=65,536, assoc=8, a 1.2M-access
   Zipf trace), through ``simulate_trace`` with the launch counts set to 0
   just before and read just after; hits, registers and state digest must
   equal the JAX engine's, and the call is timed on the host's clock;
5. run F again through the engine's chunk runner with CUDA events around
   each launch: the kernel's time per launch, and the share of the runner's
   stream time in which no kernel ran; the result must equal the main run's;
6. print the kernel's bound for F's chunks, counted from the words F's keys
   address;
7. hold the four batched sketch kernels (add, estimate, admit, reset)
   against their plain versions on the card: the tests/test_kernels.py
   configurations x batches 1, 7, 128, 300 and 1024, no doorkeeper, cap
   saturation, the automatic reset at W=256, a standalone reset of
   full-range words, and S's geometry; the add on every case of
   ``check_runs.ADD_HAZARD_CASES``; both paths of the admit (a warp per
   pair, a thread per pair) at ``check_runs.ADMIT_SIZES`` pairs, each size
   with the candidates and fresh victims both ways round; the edge
   geometries of ``check_runs.SKETCH_EDGE_CFGS`` (rows 1-8, one- and
   two-word rows, one-word doorkeepers, 0-20 doorkeeper probes): the
   estimate and both paths of the admit at 1, 3, 8 and 50,000 keys and the
   reset on random sketches, the add from zero (past 8 probes by its loop
   instance, also over several tiles at 9, 13 and 20 probes); every leaf
   and output must be equal;
8. run S, the batched sketch ops at F's capacity, through ``DeviceTinyLFU``
   (counts set to 0 just before, read just after): record F's trace in
   4,096-key batches, then estimate and admit 50,000 keys; the state
   digest, the resets, the estimates' digest and the admitted count must
   equal the JAX package's; then time each kernel with CUDA events;
9. run P1 (benchmarks/bench_serving.py's grid: lru at each capacity,
   tinylfu at 1,000; the other host-bound replays are cut for time, their
   pins kept) and P2 (its generator at C=65,536, wtinylfu) through
   ``PrefixCache``, counts set to 0 around each run; every
   ``PrefixCacheStats`` field must equal the JAX cache's; then one
   decision's wall time beside the admit kernel at one pair, the add kernel
   at a 32-block lookup and an empty launch;
10. print the sketch kernels' bounds; run S through the numpy model of the
   add kernel's schedule (``check_runs.add_schedule``; its final state must
   equal S's pin) and print its longest sequential chain beside the bound;
   print the empty-launch floor beside the four sketch kernels; time the
   add and both paths of the admit over a range of batch sizes (where the
   admit wrapper's threshold comes from); time the reset, the estimate
   and the admit (at S's 50,000 pairs and at one) against their first
   designs in turns, by CUDA events around each call and in bursts of 200
   launches between one pair of events, the empty launch both ways, and
   S's (add, reset) and (add, estimate) pairs in bursts with the dependent
   launched programmatically (PDL) and in plain stream order, against adds
   alone;
11. hold the flash-attention kernel against its plain version
   (``flash_attention_ref``) on the card, within max-abs 2e-2 in bf16:
   tests/test_flash_kernel.py's shapes causal and not, ragged lengths,
   q_offset 0, 512 and 1024 at run L's three shapes (K/V read from a slot
   of a KV cache), per-row kv_len, GQA groups 1, 4, 8 and 16, head dims 16
   to 128, softcap 0 and 30, and the serving families' heads (llama4's
   40/8 and llava's 56/8: groups 5 and 7, one head a work item, prefill and
   extend at q_offset 1,024; zamba2's MHA 32x64 extend; musicgen's MHA
   24x64); and cache slots past kv_len holding NaN and +-3e38 must give an
   output bit-equal to a zeroed tail;
12. run L, qwen3-4b at full width (36 layers, random weights from a seed)
   serving 24 prompts of 1,280 tokens through ``ServeEngine`` (counts set
   to 0 just before, read just after); every ``stats`` field must equal the JAX engine's, with 36 flash launches per
   extend and one sketch add per lookup; then the same run again with its
   phases timed, once more under ``torch.profiler`` (device time by kind,
   idle share), and the flash kernel timed at each of L's attention shapes
   against its bound, its plain version and
   ``scaled_dot_product_attention``, every timed launch's output held
   against the plain version's;
13. run qwen3-4b at full width and depth 2 with ``numpy_leaves`` weights
   (D2): prefill 1,280 tokens, decode 4; each step's logits at the JAX
   top-8 ids within 0.05 of the largest (the reference's decode bound);
14. hold the step kernel's lane grid (one CTA per lane, one launch per
   chunk) against ``step_ref`` with lanes over ``check_runs.LANE_CASES`` (4 lanes; flat and set tables, shared and
   per-lane params, a lane with a shorter ``n_valid`` and one with none,
   F's geometry); every state leaf and hit flag must be equal;
15. run T, 64 tenant caches at F's geometry (1.2M accesses per lane, lane 0
   replaying F's trace), through ``simulate_trace(streams=64)`` (counts set
   to 0 just before, read just after: 2,344 launches for all lanes); lane
   0's hits, registers and digest must equal F's JAX pins, lanes 1, 32 and
   63 their solo runs; then the same run with CUDA events around each
   launch (ns per access per lane, device idle share) and its bound (bytes,
   and the latency floor of the lanes' chains side by side);
16. time F's geometry at 1, 8, 64, 132 and 264 lanes over each lane's first
   131,072 accesses, and one lane through the lane kernel (equal to the
   single-stream kernel's run): ns per access per lane, aggregate
   accesses/s, ``scaling_1_to_64`` and the state's bytes against the 50 MB
   L2;
17. run W, ``simulate_sweep`` over F's trace (capacities 32,768 / 65,536 /
   131,072 x window 0.01 / 0.05 / 0.2, assoc=8) as nine lanes of one run
   (counts set to 0 around it) and one configuration after another; the
   sequential (65,536, 0.01) row must equal F, and two lane rows solo runs
   of their padded configuration;
18. run P1's admitting policies through default-constructed
   ``PrefixCache``s (the host sketch, no launch); every stat must equal the
   default JAX cache's;
19. hold the step kernel's sharded instances (kernel mode 1b: shards=4,
   ``[global || delta]`` sketch) against ``step_ref`` over
   ``check_runs.SHARD_CASES``, ``merge_halve`` after every epoch (flat and
   set tables, 4- and 8-bit counters, doorkeeper on and off, W below the
   epoch, 4 lanes with per-lane params and shorter lanes, integrity, one
   epoch at F4's geometry); every state leaf and hit flag must be equal;
   then the fold on the card against the fold on the CPU from one state
   with a flipped global word (the shard must be quarantined);
20. run F4, F with shards=4 (merge epoch 4,096), through ``simulate_trace``
   (launch and fold counts set to 0 just before, read just after: 293
   launches, 292 folds); hits, registers and digest must equal the JAX
   pins, and with ``integrity=True`` its own digest with no shard
   quarantined; G1's trace at 2 and 4 shards against the JAX hits; then the
   run with CUDA events around each launch and fold (ns per access beside
   F's, the fold's ms per epoch and share, device idle share) and its bound;
21. run T4, T's 64 lanes with shards=4 (counts set to 0 around it); lane 0
   must equal F4's pins and lanes 1, 32 and 63 their solo sharded runs;
   then the timed run (ns per access per lane, the fold's share);
22. run W4, ``simulate_sweep`` over F's trace at 32,768 / 65,536 / 131,072
   with shards=4: ``auto`` resolves to sequential, the 65,536 row equals
   F4, ``mode="vmap"`` raises the reference's ``ValueError``;
23. hold the step kernel's adaptive instances (kernel mode 1c) against
   ``step_ref`` over ``check_runs.ADAPT_CASES``, ``rebalance``
   between epochs (after ``merge_halve`` when sharded) to quotas that go up
   and down and cross the window set count (flat, 8 and 16 ways, 4- and
   8-bit counters, doorkeeper on and off, 4 lanes with per-lane params and
   quotas and shorter lanes, shards=4, hazard keys, two epochs at FA's
   geometry); every state leaf and hit flag must be equal; then one climb
   and rebalance on the card against the CPU's from the same state and
   carry (one lane and four);
24. run FA, F's trace and geometry with ``adaptive=True`` and the default
   ``ClimbSpec`` (epoch 4,096), through ``simulate_trace`` (counts set to 0
   just before, read just after: 293 launches, 292 climbs and rebalances);
   hits, registers, digest, final quota and the whole trajectory must equal
   the JAX pins; then the run with CUDA events around each launch and climb
   (ns per access beside F's, the climb and rebalance's ms per epoch and
   share of the stream, device idle share) and its bound;
25. run FA4, FA with shards=4 (the fold rides the climb epochs), the same
   way, with the fold's share;
26. run WA, ``simulate_sweep`` over F's trace at 65,536 with window 0.01 /
   0.05 / 0.2, assoc=8, adaptive: as three lanes (``mode="vmap"``, counts
   set to 0 around it) and one run after another; the rows' hits and final
   quotas must be equal between the modes and to the JAX pins, and the 0.01
   row FA's;
27. run GA, the adaptivity goldens at C=800 (fickle churn, phase shift):
   the five static rows and the adaptive run must equal the JAX hits (the
   adaptive run its quota and digest too), and the adaptive run must come
   within 0.01 of the best static row;
28. hold the step kernel's panel instances (kernel mode 1d: S3-FIFO, ARC,
   LFU) against ``step_ref`` over ``check_runs.PANEL_CASES``:
   1, 4, 8, 16 and 32 ways, one and two main sets, 4- and 8-bit counters,
   doorkeeper on and off, resets inside and across chunk boundaries,
   zero-way window sets, ARC at 256 ghost bits with both halves cleared
   inside a chunk, 4 lanes with per-lane params and shorter lanes, the
   hazard traces' keys and one chunk at FP's geometry; every state leaf
   (ARC's ghost too) and hit flag must be equal;
29. run FP, the panel at real size: F's trace, capacity and warmup through
   ``simulate_trace(..., assoc=8, policy=p)`` for S3-FIFO (window 0.1), ARC
   and LFU (counts set to 0 just before, read just after: 2,344 launches
   each); hits, registers, digest and hit flags must equal the JAX pins;
   then each run with CUDA events around each launch (ms per launch, ns
   per access beside F's, device idle share) and its bound, and the
   slowest competitor against W-TinyLFU's F;
30. run GP, the reference's golden panel: all four policies on the golden
   Zipf (C=200), scan-then-hotspot (C=400) and the golden Zipf at C=1,000
   with sample_factor=16 and 8-bit counters; hits must equal the JAX pins,
   the hit ratios lie within 0.01 of the reference's goldens and at C=1,000
   W-TinyLFU must be at least as good as every competitor; then the four
   policies' rates at the reference benchmark's C=8,192;
31. run WP, policy sweeps over F's trace: the four policies at 65,536
   (window 0.1; ``auto`` resolves to sequential), the competitor rows FP's
   and the W-TinyLFU row its JAX pin; ARC at 32,768 / 65,536 / 131,072 as
   three lanes (counts set to 0 around it) and one after another, the
   sequential 65,536 row FP's and two lane rows their padded solo runs; a
   multi-policy ``mode="vmap"`` raises the reference's ``ValueError``;
32. run F, F4 and FA through ``DeviceWTinyLFU.run(...,
   checkpoint_dir=)`` at the auto cadence (32,768 accesses, 37 saves),
   between plain runs: hits, registers, digest (FA's quota and trajectory)
   must equal the JAX pins, with as many step launches as plain; each then
   resumes on the card from the earliest checkpoint pruning kept and holds
   them again; prints the walls and their ratio (the reference's
   ``checkpoint_overhead_vs_plain``), each save's time on the host and a
   checkpoint's bytes (checkpoints go under ``build/`` and are removed);
33. the SIGKILL drill: a child process that imports only ``repro_torch``
   drives F4 on the card, checkpointing every 32,768 accesses, and is
   killed after 3 checkpoint markers (rc must be -SIGKILL); the resume on
   the card from ``latest_step`` must hold F4's pins;
34. the reference's fault drills at their own sizes
   (``check_runs.FD_DRILLS``): a cache-table flip (a stored doorkeeper
   bit sent far out of range, which the step kernel clamps as the
   reference's gathers do), every stored probe of both tables flipped, a
   flip in a shard's global sketch slice caught by the checksums
   (quarantined once), a shard's global slice lost twice, and (queue 3
   fault 4) every window record's stored main sets flipped out of range
   (W-TinyLFU static and adaptive, S3-FIFO) and every ARC ghost position,
   which the engine then steps on the kernel's exact path; hits and digest
   must equal the JAX engine's under the same hook, and the reference's
   bounds hold;
35. a checkpoint written on the CPU resumes on the card and one written on
   the card resumes on the CPU, both equal to the card's uninterrupted run;
36. hold the step kernel's stale mesh instances (kernel mode 1e: a
   rank's add into its delta blocks, global-only estimates), its wide
   instances (11 and 16 doorkeeper probes, 256 ways; W-TinyLFU static,
   adaptive, sharded and meshed, S3-FIFO, ARC and LFU) and its exact path
   after out-of-range table addresses (which ``step`` finds by itself)
   against ``step_ref`` over ``check_runs.STEP12_CASES``; every state leaf
   and hit flag must be equal; the kernel's ms per access of each;
37. the mesh on the card: a one-rank NCCL group (its start-up timed),
   ``make_shard_mesh(4)``; F4 through ``simulate_trace(mesh=)`` in chunk
   mode must equal F4's JAX pins, and in stale mode (kernel mode 1e and
   ``merge_halve_mesh``, counts set to 0 just before, read just after)
   the JAX pins of the reference's stale step under ``jax.vmap`` over the
   mesh axis (``check_runs.F4S_PINS``); then the stale run with CUDA
   events around each launch and gather-and-fold (ns per access beside
   F4's) and its bound; then two ranks sharing the card over gloo with
   CUDA tensors (F4's first 262,144 accesses, stale), equal to the
   one-rank run of the same accesses;
38. PF, the paper's trace families at the full sizes of the reference's
   benchmark scripts (``check_runs.PF_CELLS``: YouTube-like, Wikipedia-like,
   SPC1-like and OLTP-like; each trace's sha256 the reference's): each
   through ``simulate_trace`` at 8 ways and on the exact flat tables (counts
   set to 0 just before each run, read just after), hits, registers and
   digest equal to the JAX engine's (``PF_PINS``), then again with CUDA
   events around each launch (acc/s, ms per launch, idle share, the set
   runs' bound); meanwhile the port's host engine (``WTinyLFU`` flat and
   at 8 ways, and bench_traces.py's cast on PF-spc1) runs in the pool of
   CPU worker processes: hits equal to the reference host engine's
   (``PF_HOST_PINS``, ``PF_CAST_PINS``) and the device's hit ratios within
   the reference's host-vs-device bands (±0.005 flat, ±0.01 set);
39. FAM: each of the six serving families' smoke configs (llama4 scout and
   maverick, llava-next with 8 vision embeddings, musicgen's codebooks,
   zamba2, xLSTM) in bf16 through ``Model.prefill``, three decodes and an
   ``extend`` after a cached prefix, on the card against the same model and
   ``numpy_params`` weights on the CPU (the plain versions), within 0.05
   of the largest value or 1.5x the CPU's own bf16-vs-fp32 distance;
40. Z7, X8 and M1, full-width depth-cut pins against JAX as D2 is:
   zamba2-1.2b at 7 layers (one group of six Mamba2 layers, the shared
   block, one tail layer), xlstm-1.3b at 8 (seven mLSTM, one sLSTM),
   llama4-scout at 1 (its numpy leaves handed to the card one at a time);
   prefill 1,280 tokens, 4 greedy decodes, the JAX top-8 logits within
   0.05 (X8 in fp32, and in bf16 on its first 64 prompt tokens, X8S; X8
   in bf16 on all 1,280 within 1.5x the JAX bf16 run's own distance from
   its fp32 run, where that is larger); M1 prints how many prompt tokens
   the first MoE layer sends to another expert than JAX's and the
   router's top-2 margins;
41. LZ, LX and LM: zamba2-1.2b (38 layers), xlstm-1.3b (48) and
   llama4-scout at published width and 2 layers serving 12 prompts of
   1,280 tokens (4 tenants' 1,024-token prefixes) through
   ``ServeEngine(device_sketch=True)`` (SSM state snapshots every 16
   blocks for LZ and LX; counts set to 0 just before, read just after),
   every engine phase timed: stats equal to the JAX engine's pins
   (``check_runs.LF_PINS``), tokens in range, 6 flash launches per extend
   for LZ, 0 for LX, 2 for LM, one add per lookup and one admit per
   decision; wall, prefill tokens/s, ms per decode tick, ms per snapshot
   store and restore, peak memory; the flash kernel at LZ's and LM's
   attention shapes against its bound, its plain version and
   ``scaled_dot_product_attention``, every timed launch's output held
   against the plain version's;
   (phase 1 also prints the flash sources' lines by instance: the
   forward's eight serving instances must keep the parent's,
   ``check_runs.FLASH_SERVING_PTXAS``, beside its training instances and
   the backward's kernels;)
42. FB: the flash backward kernel (``flash_attention_bwd.cu``) against
   ``flash_attention_bwd_ref`` and the forward's training instance
   (output and LSE) against ``flash_attention_ref`` on
   ``check_runs.FB_CASES`` (head dims 16-128, GQA 1-8, S 1-2,048, the
   wgmma kernel's tile edges, softcap 0 and 30, batch 1-3, TRP's and TR's
   shapes): dq, dk, dv each within FB_TOL of the plain version's largest,
   and a second call bit-equal to the first (the kernel adds its dQ
   partials in a fixed order), the output within FLASH_TOL, the LSE
   within FB_LSE_TOL; ``torch.autograd.grad`` through
   ``flash_attention`` on CUDA (no gradient None, bit-equal to the
   kernels' direct calls); calls outside the training contract raise;
   both kernels timed at TR's shape against their bounds, plain versions
   and ``scaled_dot_product_attention`` (forward; backward through a
   retained graph, KV heads repeated), every timed backward bit-equal;
43. TF: the six families' smoke configs (qwen3, scout, llava, musicgen,
   zamba2, xLSTM) train four AdamW steps in bf16 on the card from
   ``numpy_leaves`` weights, every loss within 0.05 of the port's CPU run
   (in the pool meanwhile) and the last below the first; the driver's
   ``train()`` on chatglm3's smoke config interrupted at step 3 and
   resumed equals its continuous run within 1e-4;
44. TRP: qwen3-4b at published width and 2 layers, three AdamW steps on
   one 256-token sequence: each step's loss and grad norm against the JAX
   package's pins (``check_runs.TRP_PINS``) within 1.5x the reference's
   own bf16-vs-fp32 distance (``TRP_FP32_PINS``);
45. TR, the training path's main run: qwen3-4b at published width, 12 of
   its 36 layers (1.99 B parameters), batches of 8 x 2,048 tokens from
   ``TokenPipeline`` over the W-TinyLFU shard cache, AdamW with WSD, remat
   on, ten steps (counts set to 0 just before, read just after: 24
   forward and 12 backward flash launches a step): losses finite and
   falling, the pipeline's cache statistics equal to the CPU pipeline's;
   ms per step and tokens/s after one warm-up step, peak memory; one more
   step under torch.profiler (device time by kind of kernel, the flash
   kernels' ms per launch and TFLOP/s); then three Adafactor steps;
46. TRS, the sharded training path on a one-rank NCCL group (a (1, 1)
   ``make_debug_mesh`` grid): qwen3-4b at published width and TR's 12
   layers through ``ShardingPolicy`` (fp32 masters and AdamW state kept
   as this rank's blocks, the masters' bf16 cast gathered into the module
   each step, the gradients reduce-scattered), three AdamW steps from TR's
   seed and batches after the same three steps of the plain step (TR's
   state freed first): losses and a digest of every master leaf bit-equal
   to the plain step's; counts set to 0 just before the sharded run and
   read just after (24 forward and 12 backward flash launches a step); ms
   per step beside the plain step's and TR's, peak memory;
47. on the same group: ``compressed_allreduce_int8`` (a 4,096 x 4,096
   gradient with an error, a 64 x 32 tensor without) bit-equal to its CPU
   result, and ``pipeline_apply`` (8 layers of width 1,024, 2 and 4
   microbatches) within 1e-5 relative of its CPU result; phases 46-47
   print their time;
48. HC, the window-adaptation CLI (``repro_torch.launch.hillclimb.main``
   in process) at its defaults on the card with ``--static-sweep``: C=1,000,
   200,000 accesses, seed 3, 8 ways, climb epochs of 4,096, window 0.01, on
   the phase-shift and fickle-churn traces, and a 50,000-access Zipf trace
   on the flat tables (``check_runs.HC_RUNS``; JSONs into a temporary
   directory under ``build/``); counts set to 0 just before each run and
   read just after (49 adaptive and 5 x 391 static step launches for a
   200,000-access run, 13 and 5 x 98 for the flat one; no other kernel):
   every row's hits, the adaptive runs' final quotas and trajectories equal
   to the current reference CLI's (``HC_PINS``), ``adaptive_table`` over
   the directory equal to the reference's over its own JSONs
   (``HC_TABLE``); each run's wall and accesses per second, the adaptive
   run beside its best static run, the phase's time;
49. PL, the program lint (``repro_torch.analysis.program_lint``) on the
   card, in a fresh process (its profiler sessions drop kernel records
   now and then in a process that has run the earlier phases' long ones),
   on a one-rank NCCL group: ``run_matrix`` over the reference's 15
   configurations, each at chunk lengths 96 and 192 (407 accesses), every
   run recorded (launch events, the aten and c10d ops outside them, the
   chunk loop under ``torch.cuda.set_sync_debug_mode("error")``) and
   profiled; no violation, the profiler's ``sketch_step`` kernels equal to
   the recorded launches in every run, the mesh entries on the group (the
   stale fold's two gathers an epoch, counted there); R7 on the card: the
   five identical-program contracts record the base's program, whose digest
   equals the committed registry's for the card's torch (``analysis/
   fingerprints.json``; pair equality alone for a torch it does not hold);
   and one lint at F's
   geometry (C=65,536, 8 ways, W=524,288, chunks of 512) over F's first
   51,200 accesses: R0-R6 clean, 100 launches and kernels, no host read in
   its chunk loop; a run whose profiler session delivered no device
   activity at all is recorded again on a fresh state (at most twice; the
   count is printed); counts set to 0 just before the phase and read just
   after (the step kernel only); each entry's launches and op counts, and
   the phase's time;
50. print the ``kernels`` JSON line (seven kernels; the step kernel's entry
   with the modes it runs, its lane-grid, sharded, adaptive, panel, mesh
   and wide instances' launches and checks, the CLI's launches (HC), the
   lint's launches (PL) and its checkpointed runs; the
   add's with the
   doorkeeper probe counts it was held at; the reset's and the estimate's
   with their burst times, the empty launch's in a burst, their in-stream
   pairs with and without PDL and their first designs' times; the sketch
   kernels' launches in LZ, LX and LM; the flash kernel's launches in L,
   LZ, LM, TR and TRS, its numbers at L's shapes and, per cell, at LZ's
   and LM's, its training instance's at TR's; the backward kernel's, with
   TR's and TRS's step time and peak memory), the card line and the
   result line.  Lines
   ``elapsed ...`` mark the time taken after each group of phases.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import gc
import json
import math
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.check_runs import (ADAPT_CASES,  # noqa: E402
                                    ADAPT_EPOCH, ADD_HAZARD_CASES,
                                    ADD_TILE, ADMIT_SIZES, F4_DIGEST,
                                    F4_EPOCH, F4_HITS, F4_REGS, F4I_DIGEST,
                                    FA_DIGEST, FA_HITS, FA_QUOTA, FA_REGS,
                                    FA_TRAJ, FA4_DIGEST, FA4_HITS, FA4_QUOTA,
                                    FA4_REGS, FA4_TRAJ, FD_DRILLS,
                                    FD_FLIP_BOUNDED,
                                    FD_FLIP_TOL, FD_GOLDEN, FD_PINS, FD_TAIL,
                                    F4S_PINS, STEP12_CASES, run_step_case,
                                    GA_ACCESSES,
                                    GA_CAPACITY, GA_FRACS, GA_GAP, GA_PINS,
                                    GA_SEED, GA_TRACES, HC_PINS, HC_RUNS,
                                    HC_TABLE, hc_pins,
                                    FLASH_CASES, FLASH_TAIL, FLASH_TAIL_LENS,
                                    FP_PINS, G1_SHARDED_HITS, GP_GOLDENS,
                                    GP_PINS, GP_REF_CAPACITY, GP_RUNS,
                                    GP_TOL, HAZARD_CASES,
                                    LANE_CASES, LANES,
                                    P1_CAPS, P1_HOST_PINS, P1_TRACE, P2_CAP,
                                    P2_TRACE, P_PINS, PANEL_CASES,
                                    PF_ASSOC, PF_CAST, PF_CAST_CELL,
                                    PF_CELLS, PF_CAST_PINS, PF_HOST_PINS,
                                    PF_PINS, PF_TOL, PF_TRACE_SHA256,
                                    pf_host_run, pf_trace, pf_warmup,
                                    trace_sha256,
                                    PANEL_FRACS, PANEL_POLICIES,
                                    S_BATCH, S_BLOCKS, S_DECISIONS, S_PINS,
                                    SHARD_CASES, SHARDS,
                                    SKETCH_CFGS, SKETCH_EDGE_CFGS,
                                    T_ACCESSES, T_LANES,
                                    T_SCALING, T_SCALING_ACCESSES, T_SOLO,
                                    T_TENANTS, W_CAPS, W_FRACS, WA_FRACS,
                                    WA_PINS, WP_ARC_CAPS, WP_WTINYLFU_HITS,
                                    add_hazard_batches, add_schedule,
                                    random_sketch,
                                    cache_tails, digest, fd_hook,
                                    hazard_keys,
                                    lane_keys, lane_n_valid, mixed_keys,
                                    replay, trajectory_digest)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)

# Exact results of the JAX engine (repro.core.device_simulate.simulate_trace,
# backend="jit", bit-identical to its Pallas kernel) on the same traces.
# (name, trace, capacity, assoc, warmup, hits, regs or None, digest or None)
GOLDEN = [
    ("G1", "zipf", 200, None, 10_000, 17488,
     [800, 158, 60000, 17488, 0, 0, 0, 0], "c9eae45be185632d"),
    ("G2", "scanhot", 400, None, 5_000, 26606,
     [2400, 316, 60000, 26606, 0, 0, 0, 0], "7f80aab0884ce4a6"),
    ("G3", "zipf", 1000, 4, 10_000, 23686, None, None),
    ("G4", "zipf", 1000, 8, 10_000, 23876,
     [4000, 0, 60000, 23876, 0, 0, 0, 0], "986da475ed57362b"),
    ("G5", "zipf", 1000, 16, 10_000, 23970, None, None),
    ("G6a", "scanhot", 400, 4, 5_000, 26253, None, None),
    ("G6b", "scanhot", 400, 8, 5_000, 26402, None, None),
    ("G6c", "scanhot", 400, 16, 5_000, 26488, None, None),
]
F_CAPACITY, F_ASSOC, F_WARMUP, F_CHUNK = 65536, 8, 480_000, 512
F_ACCESSES = 1_200_000
F_HITS = 455639
F_REGS = [413568, 0, 1200000, 455639, 0, 0, 0, 0]
F_DIGEST = "822de2a898615740"
# Runs S and P, the serving-admission path, and their JAX pins are defined
# in repro_torch.check_runs, which the CPU tests share.


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# the plain version of most kernel-vs-plain cases runs on the host's CPU in
# a pool of worker processes while the card runs the kernel: one op at a
# time it is faster there than on the card, and the cases run side by side
PLAIN_WORKERS = 6
_POOL = []


def cpu_pool() -> ProcessPoolExecutor:
    """The pool of CPU worker processes (started at the first call)."""
    if not _POOL:
        _POOL.append(ProcessPoolExecutor(
            PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _POOL[0]


def submit_plain(runner, *args):
    """``runner(*args, step_ref, "cpu")`` in the pool: a future of
    :func:`cpu_plain`'s result."""
    return cpu_pool().submit(cpu_plain, runner, *args)


def cpu_plain(runner, *args):
    """``runner(*args, step_ref, "cpu")`` (a case runner of this script or
    of check_runs: the plain version) on one CPU thread of a pool worker:
    (state leaves, hit flags) as numpy, and the seconds it took."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    state, hits = runner(*args, ks.step_ref, "cpu")
    return ({k: np.asarray(v) for k, v in state.items()}, np.asarray(hits),
            time.perf_counter() - t0)


def plain_diff(name, got, want) -> int:
    """The kernel's (state, hits) against the plain version's (numpy, as
    :func:`cpu_plain` returns it): every leaf and hit flag must be equal.
    Returns the max abs difference."""
    state, hits = got
    pstate, phits = want[0], want[1]
    err = 0
    for k, v in pstate.items():
        d = int(np.abs(state[k].cpu().numpy().astype(np.int64) - v).max())
        check(d == 0, f"{name}: kernel and plain differ in state[{k!r}]")
        err = max(err, d)
    d = int(np.abs(hits.cpu().numpy().astype(np.int64) - phits).max())
    check(d == 0, f"{name}: kernel and plain differ in the hit flags")
    return max(err, d)


def numpy_run(state, hits):
    """A (state, hits) run on the card as :func:`cpu_plain` returns one."""
    return ({k: v.cpu().numpy() for k, v in state.items()},
            hits.cpu().numpy())


def chunk_case(cfg, trace, chunk, fn, device):
    """``cfg`` (a DeviceWTinyLFU, or a (StepSpec, make_step_params
    arguments, window_cap, main_cap) tuple) through the engine's chunk
    runner with ``fn`` from a fresh state on ``device``: (state, hits)."""
    from repro_torch.core.device_simulate import _trace_lanes, run_chunks
    from repro_torch.kernels import sketch_step as ks
    if isinstance(cfg, tuple):
        spec, pargs, wcap, mcap = cfg
        params = ks.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                     device=device)
    else:
        spec, params = cfg.spec(), cfg.params(device=device)
        wcap, mcap = cfg.window_cap, cfg.main_cap
    lo, hi = _trace_lanes(trace, device)
    state = ks.init_step_state(spec, wcap, mcap, device=device)
    return run_chunks(spec, params, state, lo, hi, chunk, fn=fn)


def compare_case(name, cfg, trace, chunk, job=None):
    """Kernel vs plain from the same initial state, both driven by the
    engine's chunk runner (:func:`chunk_case`): the plain version is
    ``job``'s (a :func:`submit_plain` future), or without one runs on the
    card, timed by CUDA events.  Returns (max abs difference, the card's
    plain ms per chunk or None)."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    got = chunk_case(cfg, trace, chunk, ks.step, "cuda")
    ms = None
    if job is None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        want = numpy_run(*chunk_case(cfg, trace, chunk, ks.step_ref, "cuda"))
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / math.ceil(len(trace) / chunk)
    else:
        want = job.result()
    err = plain_diff(name, got, want)
    check(int(want[0]["regs"][ks.R_T]) == len(trace),
          f"{name}: the plain run did not advance over the trace")
    sample = cfg[1][3] if isinstance(cfg, tuple) else cfg.sample_size
    spec = cfg[0] if isinstance(cfg, tuple) else cfg.spec()
    where = (f"; plain {ms:.1f} ms/chunk on the card" if job is None
             else "; plain on the CPU")
    print(f"phase 2  {name}: kernel == plain over {len(trace)} accesses "
          f"(chunk {chunk}, W={sample}, {spec.assoc or 'flat'} ways)"
          f"{where}")
    return err, ms


def timed_launches(trace, cfg, chunk, warmup, fn=None):
    """A run through the engine's chunk runner with CUDA events around each
    launch (of ``fn``, default the ``step`` wrapper); with ``cfg.shards >
    1`` one launch per merge epoch and events around each fold too (on a
    stale mesh, ``cfg.mesh`` with ``mesh_exchange="stale"``: this rank's
    step and ``merge_halve_mesh``).  Returns (state, hit flags, per-launch
    kernel ms, the runner's stream ms from its first launch to its last
    event, per-fold ms)."""
    import torch
    from functools import partial
    from repro_torch.core.device_simulate import _trace_lanes, run_chunks
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.kernels.sketch_merge import merge_halve, merge_halve_mesh
    spec = cfg.spec()
    params = cfg.params(warmup=warmup, device="cuda")
    state = ks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                               device="cuda")
    lo, hi = _trace_lanes(trace, "cuda")
    steps, folds, marks = [], [], []

    def timed(f, out):
        def call(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = f(*args)
            e1.record()
            out.append((e0, e1))
            marks.append((e0, e1))
            return r
        return call

    fold = None
    if cfg.shards > 1:
        chunk, fold = cfg.merge_epoch, timed(merge_halve, folds)
    if spec.mesh_devices:
        mesh = cfg.mesh
        fn = fn or partial(ks.step, rank=mesh.rank)
        fold = timed(lambda sp, p, st: merge_halve_mesh(sp, p, st, mesh),
                     folds)
    state, hits = run_chunks(spec, params, state, lo, hi, chunk,
                             fn=timed(fn or ks.step, steps), fold=fold)
    torch.cuda.synchronize()
    return (state, hits, [a.elapsed_time(b) for a, b in steps],
            marks[0][0].elapsed_time(marks[-1][1]),
            [a.elapsed_time(b) for a, b in folds])


def bound_bytes(spec, trace, chunk, sample):
    """Bytes the step kernel must move over the whole trace, chunk by
    chunk: each access's key lanes and probes read and its hit flag written
    once; per chunk the params read and the registers read and written once,
    and every distinct state word its keys address (their window set and two
    main sets, their counter and doorkeeper words) read and written once;
    and the whole sketch read and written once at each section 3.3 reset.
    With the sharded sketch each counter and doorkeeper word is read in both
    halves and written in the delta half, and the kernel does no reset (the
    fold ages the sketch).  With the adaptive window each window set's
    ``wuw`` word is read and its ``wsl`` word read and written.  A
    competitor policy reads the window set only under S3-FIFO; ARC reads no
    sketch (and never resets) but both ghost halves' words of its keys'
    doorkeeper probes.  The candidates' sets, the victims' estimate words
    (LFU: every record's of the key's sets) and ARC's ghost inserts depend
    on the run's decisions and are left out, so this is a lower bound.
    Returns (bytes, number of resets, the size register's model)."""
    import torch
    from repro_torch.core.device_simulate import _trace_lanes
    from repro_torch.kernels import sketch_step as ks
    lo, hi = _trace_lanes(trace, "cuda")
    kidx, kdkb, kwset, kmset = ks.precompute_probes(spec, lo, hi)
    n = lo.shape[0]
    c = torch.arange(n, device=lo.device) // chunk

    def distinct(ids, per_chunk):
        ids = ids.long().reshape(n, -1)
        return int(torch.unique(c[:, None] * per_chunk + ids).numel())

    word_shift = 3 if spec.counter_bits == 4 else 2
    rows = torch.arange(spec.rows, device=lo.device) * spec.words_per_row
    window = spec.policy in ("wtinylfu", "s3fifo")
    words = (window * distinct(kwset, spec.window_sets) * spec.assoc
             * spec.wcols
             + distinct(kmset, spec.main_sets) * spec.assoc * spec.mcols)
    # adaptive: a window set's wuw word read, its wsl word read and written
    load = 3 * distinct(kwset, spec.window_sets) if spec.adaptive else 0
    arc = spec.policy == "arc"
    sketch = 0 if arc else distinct(rows + (kidx >> word_shift),
                                    spec.counter_words)
    if spec.dk_bits and not arc:
        sketch += distinct(kdkb >> 5, spec.dk_words)
    ghost = 2 * distinct(kdkb >> 5, spec.dk_words) if arc else 0
    per_access = 4 * (2 + spec.rows + spec.dkp + 1 + 2) + 4
    nchunks = -(-n // chunk)
    size, resets = 0, 0
    for s in range(0, n, chunk):
        left = min(chunk, n - s)
        while spec.shards == 1 and not arc and size + left >= sample:
            left -= sample - size          # the reset fires at size == W
            size, resets = sample // 2, resets + 1
        size += left
    moves = 3 if spec.shards > 1 else 2    # sharded: global, delta; delta
    total = (2 * 4 * words + 4 * load + moves * 4 * sketch + 4 * ghost
             + n * per_access
             + nchunks * 4 * (ks.NPARAMS + 2 * ks.NREGS)
             + resets * 2 * 4 * (spec.counter_words + spec.dk_words))
    return total, resets, size


SOURCES = ("sketch_step", "sketch_update", "sketch_estimate", "admission",
           "sketch_reset", "flash_attention", "flash_attention_bwd")
# built beside them: the empty-launch floor, and the first designs of the
# reset, estimate and admit (phase 10 times the current kernels against them)
PROBES = ("l2_chase", "sketch_baseline")
SKETCH_KERNELS = ("sketch_update", "sketch_estimate", "admission",
                  "sketch_reset")
REPLACES = {"sketch_update": "src/repro/kernels/sketch_update.py:80",
            "sketch_estimate": "src/repro/kernels/sketch_estimate.py:71",
            "admission": "src/repro/kernels/admission.py:34",
            "sketch_reset": "src/repro/kernels/sketch_reset.py:33"}
# 32-bit integer operations per hashed probe: 20 for the salted hash (two
# mix32 finalizers of 8 each, the salt add and three xors), 5 to mask, index
# and test.  They are counted against the H100 SXM's 67 T/s 32-bit rate
# outside the tensor cores (data sheet, float32), as no integer rate is
# published beside it.
HASH_OPS_PER_PROBE = 25
F32_OPS_PER_S = 67e12


def sketch_fns():
    """name -> (kernel wrapper, plain version) of the four sketch kernels."""
    from repro_torch.kernels import (admission, sketch_estimate,
                                     sketch_reset, sketch_update)
    return {"sketch_update": (sketch_update.add, sketch_update.add_ref),
            "sketch_estimate": (sketch_estimate.estimate,
                                sketch_estimate.estimate_ref),
            "admission": (admission.admit, admission.admission_ref),
            "sketch_reset": (sketch_reset.reset, sketch_reset.reset_ref)}


def set_launches(n: int = 0):
    """Set every kernel wrapper's launch count to ``n``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sketch_step as ks
    ks.step.launches = n
    fa.flash_attention.launches = n
    for kernel, _ in sketch_fns().values():
        kernel.launches = n


def read_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sketch_step as ks
    out = {name: kernel.launches for name, (kernel, _) in sketch_fns().items()}
    out["sketch_step"] = ks.step.launches
    out["flash_attention"] = fa.flash_attention.launches
    return out


def lanes_on_card(keys, device="cuda"):
    import torch
    from repro_torch.kernels.sketch_common import keys_to_lanes
    lo, hi = keys_to_lanes(np.asarray(keys, np.uint64))
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def timed_ms(fn, reps: int = 1) -> float:
    """Mean ms of ``fn()`` on the card: CUDA events around ``reps`` calls,
    after one untimed call."""
    import torch
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def compare_sketch(name, cfg, batches, queries, errs, *, auto_reset=False,
                   plain_ms=None):
    """Kernel vs plain on the card, from two zeroed states: the batches
    added (with ``ops.add``'s automatic reset when ``auto_reset``), then
    estimates and verdicts of ``queries`` against their roll by one, then a
    standalone reset.  Every leaf and output must be equal; ``errs`` keeps
    the largest difference per kernel.  With ``plain_ms`` (a dict), the
    plain version of each kernel is timed on the last batch / the queries."""
    import torch
    from repro_torch.kernels import sketch_common as sc
    fns = sketch_fns()
    add, add_ref = fns["sketch_update"]
    reset, reset_ref = fns["sketch_reset"]
    k_state = sc.init_state(cfg, device="cuda")
    p_state = sc.init_state(cfg, device="cuda")
    resets = 0

    def leaf_err(a, b):
        return max(int((a[k].long() - b[k].long()).abs().max()) for k in a)

    for keys in batches:
        lo, hi = lanes_on_card(keys)
        add(cfg, k_state, lo, hi)
        add_ref(cfg, p_state, lo, hi)
        if auto_reset and int(k_state["size"]) >= cfg.sample_size:
            reset(cfg, k_state)
            reset_ref(cfg, p_state)
            resets += 1
        errs["sketch_update"] = max(errs["sketch_update"],
                                    leaf_err(k_state, p_state))
    if plain_ms is not None:                # zeroed states made untimed
        fresh = [sc.init_state(cfg, device="cuda") for _ in range(2)]
        plain_ms["sketch_update"] = timed_ms(
            lambda: add_ref(cfg, fresh.pop(), lo, hi))
    qlo, qhi = lanes_on_card(queries)
    vlo, vhi = lanes_on_card(np.roll(queries, 1))
    for kname, args in (("sketch_estimate", (qlo, qhi)),
                        ("admission", (qlo, qhi, vlo, vhi))):
        kernel, plain = fns[kname]
        got = kernel(cfg, k_state, *args).long()
        want = plain(cfg, p_state, *args).long()
        errs[kname] = max(errs[kname], int((got - want).abs().max()))
        if plain_ms is not None:
            plain_ms[kname] = timed_ms(lambda: plain(cfg, p_state, *args), 5)
    if plain_ms is not None:                # copies of the state made untimed
        copies = [{k: v.clone() for k, v in p_state.items()}
                  for _ in range(6)]
        plain_ms["sketch_reset"] = timed_ms(
            lambda: reset_ref(cfg, copies.pop()), 5)
    reset(cfg, k_state)
    reset_ref(cfg, p_state)
    errs["sketch_reset"] = max(errs["sketch_reset"],
                               leaf_err(k_state, p_state))
    for kname in SKETCH_KERNELS:
        check(errs[kname] == 0, f"{name}: {kname} kernel and plain differ")
    check(int(k_state["size"]) == int(p_state["size"]),
          f"{name}: sizes differ")
    n = sum(len(b) for b in batches)
    print(f"phase 7  {name}: kernel == plain for add ({n} keys"
          f"{f', {resets} resets' if auto_reset else ''}), estimate, admit "
          f"({len(queries)} keys) and reset")
    return k_state


def sketch_phase7(f_trace):
    """Phase 7: the four sketch kernels against their plain versions on the
    card.  Returns (max abs error per kernel, plain ms per kernel at S's
    shapes, the doorkeeper probe counts the add was held at)."""
    import torch
    from repro_torch.kernels import sketch_common as sc
    from repro_torch.kernels.ops import make_config
    errs = {k: 0 for k in SKETCH_KERNELS}
    for ci, kw in enumerate(SKETCH_CFGS):
        cfg = sc.DeviceSketchConfig(**kw)
        for batch in (1, 7, 128, 300, 1024):
            keys = mixed_keys(ci * 10_000 + batch, batch)
            compare_sketch(f"cfg{ci} batch {batch}", cfg, [keys],
                           np.concatenate([keys[:64], mixed_keys(batch, 64)]),
                           errs)
    for dk in (1024, 0):
        compare_sketch(f"cap saturation dk_bits={dk}",
                       sc.DeviceSketchConfig(width=256, cap=7, dk_bits=dk),
                       [np.full(50, 123456, np.uint64)],
                       np.array([123456, 7], np.uint64), errs)
    w256 = sc.DeviceSketchConfig(width=256, cap=15, dk_bits=1024,
                                 sample_size=256)
    st = compare_sketch("auto-reset W=256", w256,
                        [np.tile(np.arange(100, dtype=np.uint64), 3)],
                        np.arange(128, dtype=np.uint64), errs,
                        auto_reset=True)
    check(int(st["size"]) == 75, "auto-reset: size 300 -> 150 -> reset 75")
    # standalone reset on words with every bit pattern, sign bit included
    cfg = sc.DeviceSketchConfig(width=4096, dk_bits=4096)
    rng = np.random.default_rng(5)
    arrays = {"counters": rng.integers(-2**31, 2**31, (4, 512),
                                       dtype=np.int64).astype(np.int32),
              "doorkeeper": rng.integers(-2**31, 2**31, (1, 128),
                                         dtype=np.int64).astype(np.int32),
              "size": np.array(1001, np.int32)}
    k = sc.sketch_state_from_numpy(cfg, arrays, device="cuda")
    p = sc.sketch_state_from_numpy(cfg, arrays, device="cuda")
    reset, reset_ref = sketch_fns()["sketch_reset"]
    reset(cfg, k)
    reset_ref(cfg, p)
    err = max(int((k[n].long() - p[n].long()).abs().max()) for n in k)
    errs["sketch_reset"] = max(errs["sketch_reset"], err)
    check(err == 0 and int(k["size"]) == 500,
          "standalone reset: kernel and plain differ")
    print("phase 7  standalone reset of random full-range words: kernel == "
          "plain, size 1001 -> 500")
    plain_ms = {}
    s_cfg = make_config(S_BLOCKS)
    compare_sketch("S geometry", s_cfg,
                   [f_trace[:S_BATCH], f_trace[S_BATCH:2 * S_BATCH]],
                   f_trace[:S_DECISIONS], errs, auto_reset=True,
                   plain_ms=plain_ms)
    add_hazards(errs)
    admit_sizes(s_cfg, f_trace, errs)
    add_probes = sketch_edges(errs)
    add_loop_tiles(errs)
    torch.cuda.synchronize()
    return errs, plain_ms, add_probes


EDGE_SIZES = (1, 3, 8, 50_000)
LOOP_PROBES = (9, 13, 20)       # the add's loop instance: 896, 608, 384 keys


def add_loop_tiles(errs):
    """The add's loop instance over several tiles: two batches of 2,000
    keys (repeats among them) from zero at LOOP_PROBES doorkeeper probes,
    kernel against add_ref."""
    from repro_torch.kernels import sketch_update
    from repro_torch.kernels import sketch_common as sc
    for dkp in LOOP_PROBES:
        cfg = sc.DeviceSketchConfig(width=1024, rows=4, cap=15,
                                    dk_bits=4096, dk_probes=dkp)
        kernel = sc.init_state(cfg, device="cuda")
        plain = sc.init_state(cfg, device="cuda")
        for seed in (dkp, dkp + 100):
            lo, hi = lanes_on_card(mixed_keys(seed, 2_000))
            sketch_update.add(cfg, kernel, lo, hi)
            sketch_update.add_ref(cfg, plain, lo, hi)
        e = max(int((kernel[k].long() - plain[k].long()).abs().max())
                for k in ("counters", "doorkeeper"))
        errs["sketch_update"] = max(errs["sketch_update"], e)
        check(e == 0 and int(kernel["counters"].ne(0).sum()) > 0,
              f"add at {dkp} probes over several tiles: kernel and plain "
              "differ")
    print(f"phase 7  add loop instance at {LOOP_PROBES} doorkeeper probes: "
          "two 2,000-key batches (several tiles each) from zero == add_ref")


def edge_sketch(cfg, seed):
    """check_runs.random_sketch on the card."""
    from repro_torch.kernels import sketch_common as sc
    return sc.sketch_state_from_numpy(cfg, random_sketch(cfg, seed),
                                      device="cuda")


def sketch_edges(errs):
    """The four sketch kernels against their plain versions at
    SKETCH_EDGE_CFGS: the estimate and both paths of the admit on a random
    sketch at EDGE_SIZES keys, the reset on it, and two batches added to a
    zeroed one (past 8 doorkeeper probes by the add's loop instance).
    Returns the doorkeeper probe counts the add was held at."""
    import torch
    from repro_torch.kernels import (admission, sketch_estimate,
                                     sketch_reset, sketch_update)
    from repro_torch.kernels import sketch_common as sc

    def err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0
    add_probes = set()
    for case, kw in enumerate(SKETCH_EDGE_CFGS):
        cfg = sc.DeviceSketchConfig(**kw)
        state = edge_sketch(cfg, case)
        for n in EDGE_SIZES:
            keys = np.random.default_rng(n).integers(0, 1 << 63, 2 * n,
                                                     dtype=np.uint64)
            lanes = [*lanes_on_card(keys[:n]), *lanes_on_card(keys[n:])]
            e = err(sketch_estimate.estimate(cfg, state, *lanes[:2]),
                    sketch_estimate.estimate_ref(cfg, state, *lanes[:2]))
            errs["sketch_estimate"] = max(errs["sketch_estimate"], e)
            want = admission.admission_ref(cfg, state, *lanes)
            for per_thread in (False, True):
                out = torch.empty(n, dtype=torch.bool, device="cuda")
                admission._launch(cfg, state, *lanes, out,
                                  per_thread=per_thread)
                errs["admission"] = max(errs["admission"], err(out, want))
        plain = {k: v.clone() for k, v in state.items()}
        sketch_reset.reset(cfg, state)
        sketch_reset.reset_ref(cfg, plain)
        errs["sketch_reset"] = max(errs["sketch_reset"], max(
            err(state[k], plain[k]) for k in ("counters", "doorkeeper")))
        kernel = sc.init_state(cfg, device="cuda")
        plain = sc.init_state(cfg, device="cuda")
        for seed in (case, case + 100):
            lo, hi = lanes_on_card(mixed_keys(seed, 200))
            sketch_update.add(cfg, kernel, lo, hi)
            sketch_update.add_ref(cfg, plain, lo, hi)
            errs["sketch_update"] = max(errs["sketch_update"], max(
                err(kernel[k], plain[k]) for k in ("counters",
                                                   "doorkeeper")))
        add_probes.add(cfg.dk_probes if cfg.dk_bits else 0)
        for k in SKETCH_KERNELS:
            check(errs[k] == 0, f"edge geometry {kw}: {k} kernel and plain "
                  "differ")
    print(f"phase 7  edge geometries: {len(SKETCH_EDGE_CFGS)} (rows 1, 3, 8;"
          f" widths 8, 16; doorkeeper probes 0-20 on 32 or 1,024 bits, and "
          f"none): estimate, admit (both paths) at {EDGE_SIZES} keys and "
          f"reset == plain on random sketches; the add == add_ref from zero "
          f"on all of them, at doorkeeper probes {sorted(add_probes)}")
    return sorted(add_probes)


def add_hazards(errs):
    """The add kernel against add_ref on every case of ADD_HAZARD_CASES,
    the batches added one after another to one sketch each."""
    from repro_torch.kernels import sketch_common as sc
    from repro_torch.kernels import sketch_update as su
    for case, (name, kw, _, sizes) in enumerate(ADD_HAZARD_CASES):
        cfg = sc.DeviceSketchConfig(**kw)
        kernel = sc.init_state(cfg, device="cuda")
        plain = sc.init_state(cfg, device="cuda")
        for keys in add_hazard_batches(case):
            lo, hi = lanes_on_card(keys)
            su._launch(cfg, kernel, lo, hi)
            su.add_ref(cfg, plain, lo, hi)
            err = max(int((kernel[k].long() - plain[k].long()).abs().max())
                      for k in ("counters", "doorkeeper"))
            errs["sketch_update"] = max(errs["sketch_update"], err)
            check(err == 0, f"add hazard {name}: kernel and add_ref differ")
        print(f"phase 7  add hazard {name} (width {cfg.width} rows "
              f"{cfg.rows} cap {cfg.cap} dk_bits {cfg.dk_bits}; batches "
              f"{list(sizes)}, tile {ADD_TILE}): kernel == add_ref")


def admit_pairs(f_trace, n):
    """The admit's two inputs at ``n`` pairs, both ways round: F's first
    ``n`` keys (recorded by S's first batch) and ``n`` keys drawn from a
    seed that no batch recorded.  With victims the candidates do not
    share, a wrong verdict can show at 1 and 2 pairs."""
    cands = f_trace[:n]
    fresh = np.random.default_rng(n).integers(1 << 62, 1 << 63, n,
                                              dtype=np.uint64)
    return [(*lanes_on_card(cands), *lanes_on_card(fresh)),
            (*lanes_on_card(fresh), *lanes_on_card(cands))]


def admit_sizes(cfg, f_trace, errs):
    """The admit kernel's two paths (a warp per pair, a thread per pair)
    against admission_ref at ADMIT_SIZES pairs, on S's geometry after two
    of its batches."""
    import torch
    from repro_torch.kernels import admission, sketch_update
    from repro_torch.kernels.sketch_common import init_state
    state = init_state(cfg, device="cuda")
    for s in (0, S_BATCH):
        sketch_update.add(cfg, state, *lanes_on_card(f_trace[s:s + S_BATCH]))
    admitted = []
    for n in ADMIT_SIZES:
        for args in admit_pairs(f_trace, n):
            want = admission.admission_ref(cfg, state, *args)
            admitted.append(int(want.sum()))
            for per_thread in (False, True):
                out = torch.empty(n, dtype=torch.bool, device="cuda")
                admission._launch(cfg, state, *args, out,
                                  per_thread=per_thread)
                err = int((out.long() - want.long()).abs().max())
                errs["admission"] = max(errs["admission"], err)
                check(err == 0, f"admit at {n} pairs: the "
                      f"{'thread' if per_thread else 'warp'}-per-pair path "
                      f"and admission_ref differ")
    check(admitted[:2] == [1, 0], f"admit at 1 pair: admission_ref admits "
          f"{admitted[:2]} both ways round, so a wrong verdict could hide")
    print(f"phase 7  admit at {', '.join(map(str, ADMIT_SIZES))} pairs, "
          f"candidates and fresh victims both ways round (admission_ref "
          f"admits {admitted}): the warp-per-pair and thread-per-pair paths "
          f"== admission_ref (the wrapper takes the warp path up to "
          f"{admission.WARP_MAX_PAIRS} pairs)")


SPIN_CYCLES = 1_000_000_000      # ~0.5 s of spin at the H100's clock


def kernel_ms(calls):
    """Device ms of each call, for ``calls`` an iterable of (name, function
    that launches one kernel): CUDA events around each call, all queued
    behind a spin kernel, so the events time the kernels back to back and
    not the host's enqueue.  Checks that the host finished queueing before
    the spin ended.  Returns ([(name, ms)], [each call's result])."""
    import torch
    torch.cuda.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    s1.record()
    t0 = time.perf_counter()
    events, outs = [], []
    for name, fn in calls:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs.append(fn())
        e1.record()
        events.append((name, e0, e1))
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = s0.elapsed_time(s1)
    check(enqueue_ms < spin_ms, f"kernel timing: the host took {enqueue_ms:.1f}"
          f" ms to queue the launches, longer than the {spin_ms:.1f} ms spin")
    return [(n, a.elapsed_time(b)) for n, a, b in events], outs


def sketch_bound_bytes(cfg, batches, queries):
    """Bytes each sketch kernel must move at S's shapes, from the words the
    keys address: per add launch, every distinct counter and doorkeeper
    word of its batch read and written once and its lanes read; per
    estimate, the distinct words of the queries read once, their lanes read
    and the int32 estimates written; per admit the same over candidates and
    victims, with one byte out per pair; per reset the whole sketch (counter
    words read and written, doorkeeper words written).  Returns the mean
    bytes per launch of each kernel."""
    import torch
    from repro_torch.kernels.sketch_common import key_probes

    def words(keys):
        lo, hi = lanes_on_card(keys)
        idx, dkb = key_probes(lo, hi, cfg.rows, cfg.width, cfg.dk_bits,
                              cfg.dk_probes)
        rows = torch.arange(cfg.rows, device=idx.device) * cfg.words_per_row
        cw = torch.unique(rows + (idx >> 3)).numel()
        return cw + torch.unique(dkb >> 5).numel()

    add = sum(2 * 4 * words(b) + 8 * len(b) for b in batches) / len(batches)
    est = 4 * words(queries) + 8 * len(queries) + 4 * len(queries)
    both = np.concatenate([queries, np.roll(queries, 1)])
    adm = 4 * words(both) + 16 * len(queries) + len(queries)
    reset = 4 * (2 * cfg.rows * cfg.words_per_row + cfg.dk_words)
    return {"sketch_update": add, "sketch_estimate": est, "admission": adm,
            "sketch_reset": reset}


def sketch_phase8(f_trace, card):
    """Phase 8: run S through DeviceTinyLFU (the launch counts set to 0
    just before and read just after), check its pins, then time every
    kernel with CUDA events around each launch.  Returns (launches, ms per
    launch, the batches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch_common as sc
    batches = [f_trace[s:s + S_BATCH] for s in range(0, len(f_trace),
                                                     S_BATCH)]
    cands = f_trace[:S_DECISIONS]
    victims = np.roll(cands, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = ops.DeviceTinyLFU(S_BLOCKS)
    set_launches(0)
    t0 = time.perf_counter()
    for b in batches:
        t.record(b)
    torch.cuda.synchronize()
    rec_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = t.estimate(cands)
    verdicts = t.admit(cands, victims)
    dec_wall = time.perf_counter() - t0
    launches = read_launches()
    resets = launches["sketch_reset"]
    got = (digest(t.state), resets,
           digest({"estimate": torch.from_numpy(est)}), int(verdicts.sum()))
    check(got == S_PINS, f"S: (state digest, resets, estimate digest, "
          f"admitted) {got} != JAX {S_PINS}")
    check(launches["sketch_update"] == len(batches)
          and launches["sketch_estimate"] == 1
          and launches["admission"] == 1 and resets > 0,
          f"S: launches {launches}")
    print(f"phase 8  S: DeviceTinyLFU({S_BLOCKS}) width {t.cfg.width} rows "
          f"{t.cfg.rows} cap {t.cfg.cap} dk_bits {t.cfg.dk_bits} W "
          f"{t.cfg.sample_size}: state digest, {resets} resets, estimate "
          f"digest and {got[3]} admitted of {S_DECISIONS} == JAX")
    print(f"phase 8  S: record {len(f_trace)} keys in {len(batches)} "
          f"batches {rec_wall:.3f} s wall ({len(f_trace) / rec_wall:,.0f} "
          f"keys/s, host clock, lane upload included); estimate + admit of "
          f"{S_DECISIONS} keys {dec_wall * 1e3:.2f} ms wall; launches "
          f"{launches}; card {card}")

    # the same run again, CUDA events around each kernel launch
    fns = sketch_fns()
    add, reset = fns["sketch_update"][0], fns["sketch_reset"][0]
    cfg = t.cfg
    state = sc.init_state(cfg, device="cuda")
    lanes = [lanes_on_card(b) for b in batches]
    qlo, qhi = lanes_on_card(cands)
    vlo, vhi = lanes_on_card(victims)

    def record_calls():
        for lo, hi in lanes:
            yield "sketch_update", lambda: add(cfg, state, lo, hi)
            if int(state["size"]) >= cfg.sample_size:
                yield "sketch_reset", lambda: reset(cfg, state)

    ms = {k: [] for k in SKETCH_KERNELS}
    peak = {}
    for kinds, calls in (
            (("sketch_update", "sketch_reset"), record_calls()),
            (("sketch_estimate",), [("sketch_estimate", lambda: fns[
                "sketch_estimate"][0](cfg, state, qlo, qhi))] * 20),
            (("admission",), [("admission", lambda: fns["admission"][0](
                cfg, state, qlo, qhi, vlo, vhi))] * 20)):
        torch.cuda.reset_peak_memory_stats()
        timed, outs = kernel_ms(calls)
        for k in kinds:
            peak[k] = torch.cuda.max_memory_allocated()
        for k, v in timed:
            ms[k].append(v)
        if kinds == ("sketch_estimate",):
            e = outs[-1]
        elif kinds == ("admission",):
            a = outs[-1]
    check(digest(state) == got[0], "S: the timed run differs from the "
          "main run")
    check(np.array_equal(e.cpu().numpy(), est)
          and np.array_equal(a.cpu().numpy(), verdicts),
          "S: the timed estimates or verdicts differ from the main run's")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    for k in SKETCH_KERNELS:
        print(f"phase 8  S: {k} {mean[k]:.4f} ms per launch over "
              f"{len(ms[k])} timed launches (min {min(ms[k]):.4f}, max "
              f"{max(ms[k]):.4f}); main-run launches {launches[k]}; "
              f"max_memory_allocated {peak[k]} bytes")
    busy = (sum(ms["sketch_update"]) + sum(ms["sketch_reset"])) / (
        rec_wall * 1e3)
    print(f"phase 8  S: the record kernels' time is a share {busy:.4f} of "
          f"the main run's record wall time")
    return launches, mean, batches


def serving_phase9(card):
    """Phase 9: P1 through PrefixCache on the card (the device sketch),
    each run with the launch counts set to 0 just before and read just
    after; every PrefixCacheStats field must equal the JAX cache's.  The
    replays are host-bound (a decision is ~0.95 host), so lru replays P1
    at each capacity, TinyLFU at its smallest only (W-TinyLFU's P1 replays
    are cut for time, their pins kept), and P2, the replay at S's
    capacity, runs W-TinyLFU in full.  Returns each run's admission
    decisions per second of wall."""
    import dataclasses
    import torch
    from repro_torch.serve import PrefixCache
    from repro_torch.traces.synthetic import multi_tenant_prompt_trace
    p1 = multi_tenant_prompt_trace(**P1_TRACE)
    p2 = multi_tenant_prompt_trace(**P2_TRACE)
    runs = [("P1", "lru", c, p1) for c in P1_CAPS] + [
        ("P1", "tinylfu", P1_CAPS[0], p1), ("P2", "wtinylfu", P2_CAP, p2)]
    totals, rates = {}, {}
    for name, policy, cap, stream in runs:
        pc = PrefixCache(cap, policy=policy, sample_factor=8,
                         device_sketch=True)
        set_launches(0)
        t0 = time.perf_counter()
        stats = replay(pc, stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        got = dataclasses.astuple(stats)
        want = P_PINS[(name, policy, cap)]
        check(got == want, f"{name} {policy} C={cap}: stats {got} != JAX "
              f"{want}")
        decisions = stats.admitted + stats.rejected
        if policy != "lru":
            check(launches["sketch_update"] == stats.lookups
                  and launches["admission"] == decisions,
                  f"{name} {policy} C={cap}: launches {launches}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        rates[(name, policy, cap)] = decisions / wall
        print(f"phase 9  {name} {policy:8s} C={cap:<6d} stats == JAX, hit "
              f"ratio {stats.hit_ratio:.6f}; wall {wall:.3f} s, "
              f"{len(stream) / wall:,.0f} block accesses/s, "
              f"{decisions / wall:,.0f} admission decisions/s; launches add "
              f"{launches['sketch_update']} admit {launches['admission']} "
              f"reset {launches['sketch_reset']}")
    print(f"phase 9  {len(runs)} runs on {card}; launches in all {totals}")
    decision_breakdown(p2)
    return rates


def decision_breakdown(stream, n: int = 2000):
    """Where one serving decision's time goes: wall µs per
    ``DeviceAdmission.admit`` (one batch-of-one launch and one verdict read
    each) against the device µs of the admit kernel at one pair and of the
    add kernel at one 32-block lookup (CUDA events, launches queued behind
    a spin kernel so the events time the kernels, not the enqueue)."""
    import torch
    from repro_torch.kernels import admission, sketch_update
    from repro_torch.serve.prefix_cache import DeviceAdmission
    adm = DeviceAdmission(P2_CAP)
    for s in range(0, 64 * 32, 32):
        adm.record_batch([int(x) for x in stream[s:s + 32]])
    pairs = [(int(stream[i % len(stream)]), int(stream[(i + 7) % len(stream)]))
             for i in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c, v in pairs:
        adm.admit(c, v)
    host_us = (time.perf_counter() - t0) / n * 1e6
    cfg, state = adm.t.cfg, adm.t.state
    lo, hi = lanes_on_card(stream[:32])

    def device_us(name, fn, reps=200):
        timed, _ = kernel_ms([(name, fn)] * reps)
        return sum(v for _, v in timed) / reps * 1e3

    admit_us = device_us("admission", lambda: admission.admit(
        cfg, state, lo[:1], hi[:1], lo[1:2], hi[1:2]))
    add_us = device_us("sketch_update",
                       lambda: sketch_update.add(cfg, state, lo, hi))
    print(f"phase 9  one decision: DeviceAdmission.admit {host_us:.1f} us "
          f"of wall (host clock over {n} calls, one verdict read each); "
          f"admit kernel at 1 pair {admit_us:.2f} us and add kernel at a "
          f"32-block lookup {add_us:.2f} us of device time, against an "
          f"empty launch's {launch_floor_us():.2f} us; the host holds "
          f"{1 - admit_us / host_us:.3f} of a decision")


def launch_floor_us(reps: int = 200) -> float:
    """Device us of an empty launch through the kernels' ctypes path:
    csrc/l2_chase.cu with 0 steps (one thread writes one int), timed by
    kernel_ms like the sketch kernels."""
    import torch
    from repro_torch.kernels._build import launch
    buf = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def empty():
        launch("l2_chase", "l2_chase_launch", buf, 0, out)
    empty()                         # its first launch loads the module
    timed, _ = kernel_ms([("floor", empty)] * reps)
    return sum(v for _, v in timed) / reps * 1e3


def add_schedule_stats(f_trace, cfg):
    """Run S's record loop through check_runs.add_schedule (the numpy model
    of the add kernel's schedule), with the section 3.3 resets; its final
    state must equal S's pin.  Returns per 4,096-key batch the model's
    per-tile statistics (gated keys, components, largest component's keys,
    largest several-key component's keys)."""
    import torch
    from repro_torch.kernels.sketch_common import key_probes, keys_to_lanes
    from repro_torch.kernels.sketch_reset import reset_ref
    lo, hi = (torch.from_numpy(x) for x in keys_to_lanes(f_trace))
    idx, dkb = (x.numpy() for x in key_probes(lo, hi, cfg.rows, cfg.width,
                                              cfg.dk_bits, cfg.dk_probes))
    counters = np.zeros((cfg.rows, cfg.words_per_row), np.int32)
    dk = np.zeros((1, cfg.dk_words), np.int32)
    # CPU tensors over the model's arrays: the plain reset halves them
    state = {"counters": torch.from_numpy(counters),
             "doorkeeper": torch.from_numpy(dk),
             "size": torch.tensor(0, dtype=torch.int32)}
    stats = []
    for s in range(0, len(f_trace), S_BATCH):
        stats.append(add_schedule(counters, dk, idx[s:s + S_BATCH],
                                  dkb[s:s + S_BATCH], width=cfg.width,
                                  cap=cfg.cap, dk_bits=cfg.dk_bits))
        state["size"] = state["size"] + len(idx[s:s + S_BATCH])
        if int(state["size"]) >= cfg.sample_size:
            reset_ref(cfg, state)
    got = digest(state)
    check(got == S_PINS[0], f"S through the add schedule model: state "
          f"digest {got} != JAX {S_PINS[0]}")
    return stats


ADD_SWEEP = (1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096)
ADMIT_SWEEP = (1, 2, 8, 32, 128, 1024, 8192, 50_000)


def path_sweep(f_trace, cfg, card):
    """Device ms per launch of the add and of each path of the admit at a
    range of batch sizes, on S's geometry after 100 of its batches
    (kernel_ms, 20 launches each): where the admit wrapper's threshold
    comes from."""
    import torch
    from repro_torch.kernels import admission, ops, sketch_update
    t = ops.DeviceTinyLFU(S_BLOCKS)
    for s in range(0, 100 * S_BATCH, S_BATCH):
        t.record(f_trace[s:s + S_BATCH])
    state = t.state
    for n in ADD_SWEEP:
        lo, hi = lanes_on_card(f_trace[:n])

        def call():
            sketch_update._launch(cfg, state, lo, hi)
        call()                              # loads the module if first
        timed, _ = kernel_ms([("add", call)] * 20)
        print(f"phase 10 add at {n} keys: "
              f"{sum(v for _, v in timed) / len(timed):.4f} ms per launch; "
              f"card {card}")
    for n in ADMIT_SWEEP:
        args = admit_pairs(f_trace, n)[0]
        out = torch.empty(n, dtype=torch.bool, device="cuda")
        ms = {}
        for path in ("warp", "thread"):
            def call():
                admission._launch(cfg, state, *args, out,
                                  per_thread=path == "thread")
            call()                          # loads the module if first
            timed, _ = kernel_ms([(path, call)] * 20)
            ms[path] = sum(v for _, v in timed) / len(timed)
        print(f"phase 10 admit paths at {n} pairs: warp per pair "
              f"{ms['warp']:.4f} ms, thread per pair {ms['thread']:.4f} ms "
              f"per launch; the wrapper takes the "
              f"{'warp' if n <= admission.WARP_MAX_PAIRS else 'thread'} path;"
              f" card {card}")


BURST = 200                     # launches between one pair of events
BURST_SPIN = 200_000_000        # ~0.1 s of spin: longer than queueing them
NO_PDL = ("SKETCH_NO_PDL",)     # the reset and estimate in stream order


def burst_ms(fn, n: int = BURST) -> float:
    """Device ms per call of ``fn`` (one or two kernel launches, nothing
    else) in a burst: ``n`` calls between one pair of CUDA events, queued
    behind a spin kernel.  No event goes between the calls, so a
    programmatic dependent launch can overlap the grid before it.  Checks
    that the host finished queueing before the spin ended."""
    import torch
    torch.cuda.synchronize()
    s0, s1, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(4))
    s0.record()
    torch.cuda._sleep(BURST_SPIN)
    s1.record()
    t0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = s0.elapsed_time(s1)
    check(enqueue_ms < spin_ms, f"burst timing: the host took "
          f"{enqueue_ms:.1f} ms to queue {n} calls, longer than the "
          f"{spin_ms:.1f} ms spin")
    return e0.elapsed_time(e1) / n


def per_call_ms(fn, n: int = BURST) -> float:
    """Mean device ms of ``fn`` over ``n`` calls with CUDA events around
    each (kernel_ms)."""
    timed, _ = kernel_ms([("call", fn)] * n)
    return sum(v for _, v in timed) / n


PROBE_GEOMETRIES = ((1, 0), (4, 0), (4, 3), (8, 6))     # rows, dk_probes


def estimate_by_probes(qlo, qhi, out, base_lib, card):
    """Device ms per call of the estimate and its first design at S's
    50,000 keys and S's width on random sketches of 1 to 14 probes a key,
    in turns: what the time follows."""
    from repro_torch.kernels import _build, sketch_estimate
    from repro_torch.kernels import sketch_common as sc
    n = qlo.shape[0]
    readings = []
    for rows, dkp in PROBE_GEOMETRIES:
        cfg = sc.DeviceSketchConfig(width=262_144, rows=rows, cap=7,
                                    dk_bits=2_097_152 if dkp else 0,
                                    dk_probes=dkp)
        state = edge_sketch(cfg, rows + dkp)

        def new():
            sketch_estimate._launch(cfg, state, qlo, qhi, out)

        def first():
            _build.launch("sketch_baseline", "baseline_estimate_launch",
                          state["counters"], state["doorkeeper"], qlo, qhi,
                          out, n, cfg.rows, cfg.width, cfg.dk_bits,
                          cfg.dk_probes, lib=base_lib)
        ms = {"first": [], "new": []}
        for which in ("first", "new", "new", "first"):
            ms[which].append(per_call_ms({"first": first, "new": new}[which],
                                         100))
        readings.append(f"{rows + dkp} probes: new {sum(ms['new']) / 2:.4f}"
                        f", first {sum(ms['first']) / 2:.4f}")
    print(f"phase 10 estimate of {n} keys by probes a key (ms per call, "
          f"events around each, in turns): " + "; ".join(readings)
          + f"; card {card}")


def redesign_phase10(f_trace, cfg, card):
    """The redesigned reset and estimate (also in plain stream order) and
    the admit, whose probe limit was lifted, against their first designs
    (csrc/sketch_baseline.cu) at S's shapes on S's sketch after 100
    batches, in turns, by per-call events and by bursts; the empty launch
    by both methods; the estimate by probes a key; and S's in-stream
    sequences as bursts: (add, reset) and (add, estimate) pairs, with the
    dependent launched programmatically, in plain stream order (the
    -DSKETCH_NO_PDL builds) and as its first design, against adds alone.
    The pair's dependent works on a copy of the sketch, so the adds do the
    same work in every burst.  Returns the kernels line's fields for the
    reset and the estimate."""
    import torch
    from repro_torch.kernels import (_build, admission, ops, sketch_estimate,
                                     sketch_reset, sketch_update)
    base_lib = _build.load_library("sketch_baseline")
    no_pdl = {k: _build.load_library(k, NO_PDL)
              for k in ("sketch_reset", "sketch_estimate")}
    t = ops.DeviceTinyLFU(S_BLOCKS)
    for s in range(0, 100 * S_BATCH, S_BATCH):
        t.record(f_trace[s:s + S_BATCH])
    state = t.state
    target = {k: v.clone() for k, v in state.items()}     # the resets' own
    n = S_DECISIONS
    qlo, qhi = lanes_on_card(f_trace[:n])
    vlo, vhi = qlo.roll(1), qhi.roll(1)
    geo = (cfg.rows, cfg.width, cfg.dk_bits, cfg.dk_probes)
    outs = {k: torch.empty(n, dtype=dt, device="cuda")
            for k, dt in (("est_new", torch.int32), ("est_old", torch.int32),
                          ("adm_new", torch.bool), ("adm_old", torch.bool),
                          ("one_new", torch.bool), ("one_old", torch.bool))}

    def old(fn, *args):
        return lambda: _build.launch("sketch_baseline", fn, *args,
                                     lib=base_lib)

    def reset_fns(st):
        return {"first": old("baseline_reset_launch", st["counters"],
                             st["counters"].numel(), st["doorkeeper"],
                             st["doorkeeper"].numel()),
                "new": lambda: sketch_reset._launch(cfg, st),
                "no_pdl": lambda: sketch_reset._launch(
                    cfg, st, lib=no_pdl["sketch_reset"])}

    def estimate_fns(st):
        return {"first": old("baseline_estimate_launch", st["counters"],
                             st["doorkeeper"], qlo, qhi, outs["est_old"], n,
                             *geo),
                "new": lambda: sketch_estimate._launch(cfg, st, qlo, qhi,
                                                       outs["est_new"]),
                "no_pdl": lambda: sketch_estimate._launch(
                    cfg, st, qlo, qhi, outs["est_new"],
                    lib=no_pdl["sketch_estimate"])}

    def admit_fns(m, old_out, new_out):
        return {"first": old("baseline_admission_launch", state["counters"],
                             state["doorkeeper"], qlo, qhi, vlo, vhi,
                             old_out, m, *geo,
                             int(m > admission.WARP_MAX_PAIRS)),
                "new": lambda: admission._launch(
                    cfg, state, qlo[:m], qhi[:m], vlo[:m], vhi[:m],
                    new_out[:m])}

    calls = {"sketch_reset": reset_fns(target),
             "sketch_estimate": estimate_fns(state),
             "admission": admit_fns(n, outs["adm_old"], outs["adm_new"]),
             "admission at 1 pair": admit_fns(1, outs["one_old"],
                                              outs["one_new"])}
    for fns in calls.values():                  # load the modules
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    for a, b in (("est_old", "est_new"), ("adm_old", "adm_new")):
        check(torch.equal(outs[a], outs[b]), f"phase 10: {a} != {b}")
    check(torch.equal(outs["one_old"][:1], outs["one_new"][:1]),
          "phase 10: the admit at one pair differs from its first design")
    fields = {}
    for name, fns in calls.items():
        turns = [*fns, *reversed(fns)]
        per = {w: [] for w in fns}
        burst = {w: [] for w in fns}
        readings = []
        for which in turns:
            per[which].append(per_call_ms(fns[which]))
            burst[which].append(burst_ms(fns[which]))
            readings.append((per[which][-1], burst[which][-1]))
        fields[name] = {f"{method}_{w}": sum(times[w]) / 2 for method, times
                        in (("per", per), ("burst", burst)) for w in fns}
        print(f"phase 10 {name} at S's shapes in turns "
              f"({', '.join(turns)}; first = the first design"
              + (", no_pdl = the new in plain stream order" if "no_pdl" in fns
                 else "") + "): per-call events "
              + " / ".join(f"{p:.4f}" for p, _ in readings)
              + f" ms; bursts of {BURST} "
              + " / ".join(f"{b:.5f}" for _, b in readings)
              + f" ms per launch; card {card}")
    floor_call = launch_floor_us()
    from repro_torch.kernels._build import launch
    buf = torch.zeros(1, dtype=torch.int32, device="cuda")
    floor_burst = burst_ms(lambda: launch("l2_chase", "l2_chase_launch", buf,
                                          0, buf)) * 1e3
    print(f"phase 10 empty launch: {floor_call:.2f} us per call (events "
          f"around each), {floor_burst:.2f} us in a burst of {BURST}; above "
          f"it, per call / in a burst: " + ", ".join(
              f"{k} " + ", ".join(
                  f"{w} {(fields[k]['per_' + w] * 1e3 - floor_call):.2f} / "
                  f"{(fields[k]['burst_' + w] * 1e3 - floor_burst):.2f} us"
                  for w in ("new", "no_pdl", "first"))
              for k in ("sketch_reset", "sketch_estimate")) + f"; card {card}")
    estimate_by_probes(qlo, qhi, outs["est_new"], base_lib, card)

    batch = lanes_on_card(f_trace[100 * S_BATCH:101 * S_BATCH])
    order = ("add_alone", "pdl", "no_pdl", "first", "first", "no_pdl", "pdl",
             "add_alone") * 2
    out = {}
    for name, fns_on in (("sketch_reset", reset_fns),
                         ("sketch_estimate", estimate_fns)):
        runs = {w: [] for w in order}
        readings = []
        for which in order:
            a = {k: v.clone() for k, v in state.items()}
            b = {k: v.clone() for k, v in state.items()}
            dep = fns_on(b).get("new" if which == "pdl" else which)

            def call(a=a, dep=dep):
                sketch_update._launch(cfg, a, *batch)
                if dep is not None:
                    dep()
            runs[which].append(burst_ms(call))
            readings.append(f"{runs[which][-1]:.5f}")
        pair = {k: statistics.median(v) for k, v in runs.items()}
        print(f"phase 10 in-stream (add, {name}) pairs, bursts of {BURST} at "
              f"S's shapes ({' / '.join(order)}): " + " / ".join(readings)
              + " ms per pair; by the medians the dependent adds " + ", ".join(
                  f"{(pair[w] - pair['add_alone']) * 1e3:.2f} us {label}"
                  for w, label in (("pdl", "with PDL"),
                                   ("no_pdl", "without"),
                                   ("first", "as the first design")))
              + f"; card {card}")
        m = fields[name]
        out[name] = {"burst_ms": m["burst_new"],
                     "floor_burst_us": floor_burst,
                     "pdl_pair_ms": pair,
                     "no_pdl_ms": m["per_no_pdl"],
                     "no_pdl_burst_ms": m["burst_no_pdl"],
                     "first_design_ms": m["per_first"],
                     "first_design_burst_ms": m["burst_first"]}
    return out


FLASH_TOL = 2e-2    # max |kernel - plain| in bf16: the reference's bf16 bound
                    # (tests/test_flash_kernel.py)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor rate (data sheet)
D2_TOL = 0.05       # the reference's decode bound (tests/test_models.py)


def flash_inputs(seed, B, Sq, Skv, Hq, Hkv, D):
    """Normal bf16 q (B,Sq,Hq,D) on the card, and k, v (B,Skv,Hkv,D) as
    rows 1.. of a (B+1)-row tensor: slots of a cache, as the engine hands
    them to the kernel."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    return (randn(B, Sq, Hq, D), randn(B + 1, Skv, Hkv, D)[1:],
            randn(B + 1, Skv, Hkv, D)[1:])


def flash_phase11():
    """Phase 11: the flash kernel against its plain version on the card.
    Returns the largest max-abs difference."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    worst = 0.0
    for i, (name, B, Sq, Skv, Hq, Hkv, D, causal, off, kvl,
            cap) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(i, B, Sq, Skv, Hq, Hkv, D)
        if isinstance(kvl, list):
            kvl = torch.tensor(kvl, device="cuda")
        kw = dict(causal=causal, q_offset=off, kv_len=kvl, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == q.shape
              and got.dtype == torch.bfloat16, f"flash {name}: bad output")
        check(err <= FLASH_TOL, f"flash {name}: kernel and plain differ by "
              f"{err} > {FLASH_TOL}")
        worst = max(worst, err)
        lens = kvl.tolist() if isinstance(kvl, torch.Tensor) else kvl
        print(f"phase 11 flash {name}: B={B} Sq={Sq} Skv={Skv} Hq={Hq} "
              f"Hkv={Hkv} D={D} causal={causal} q_offset={off} kv_len="
              f"{lens} softcap={cap}: max |kernel - plain| {err:.6f}")
    c = FLASH_TAIL
    q, k, v = flash_inputs(99, c["B"], c["Sq"], c["Skv"], c["Hq"], c["Hkv"],
                           c["D"])
    for kvl in FLASH_TAIL_LENS:
        lens = [kvl] * c["B"] if isinstance(kvl, int) else kvl
        zeroed, poisoned = cache_tails(k, v, lens)
        if isinstance(kvl, list):
            kvl = torch.tensor(kvl, device="cuda")
        kw = dict(causal=True, q_offset=c["q_offset"], kv_len=kvl)
        want = fa.flash_attention(q, *zeroed, **kw)
        got = fa.flash_attention(q, *poisoned, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
              f"flash: cache slots past kv_len {lens} reach the output")
        print(f"phase 11 flash cache tail: slots past kv_len {lens} hold NaN "
              f"and +-3e38; output bit-equal to a zeroed tail")
    return worst


def flash_work(Sq, q_offset, kv_len, Hq=32, Hkv=8, D=128):
    """(flops, bytes) one causal launch must do at these shapes: 4*D per
    visible (query, key) pair per head; q, k, v (the visible keys) read
    once and the output written once, bf16."""
    pairs = sum(min(kv_len, q_offset + i + 1) for i in range(Sq))
    return (4 * D * Hq * pairs,
            2 * (2 * Sq * Hq * D + 2 * kv_len * Hkv * D))


def time_flash_shape(Sq, q_offset, kv_len, reps=20, Hq=32, Hkv=8, D=128,
                     max_len=None):
    """Device ms per launch of the kernel, the plain version and one
    ``scaled_dot_product_attention`` call (its yardstick: KV heads repeated
    and the mask built before the timer) at one attention shape of a
    serving run (L's heads by default), K/V in a slot of a
    ``max_len``-slot cache (L's).  Every timed launch's output is held
    against the plain version's within FLASH_TOL.  Returns (kernel ms,
    plain ms, library ms, max |kernel - plain|, max |library - plain|)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.check_runs import L_ENGINE
    from repro_torch.kernels import flash_attention as fa
    q, k, v = flash_inputs(7, 1, Sq, max_len or L_ENGINE["max_len"], Hq,
                           Hkv, D)
    kw = dict(q_offset=q_offset, kv_len=kv_len)
    timed, outs = kernel_ms([("flash", lambda: fa.flash_attention(
        q, k, v, **kw))] * reps)
    ms = sum(t for _, t in timed) / reps
    want = fa.flash_attention_ref(q, k, v, **kw).float()
    err = max(float((o.float() - want).abs().max()) for o in outs)
    check(all(bool(torch.isfinite(o).all()) for o in outs)
          and err <= FLASH_TOL, f"flash Hq={Hq} Hkv={Hkv} D={D} Sq={Sq} "
          f"q_offset={q_offset} kv_len={kv_len}: kernel and plain differ by "
          f"{err} > {FLASH_TOL}")
    del outs
    plain = timed_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), 2)
    qt = q.transpose(1, 2)
    kt, vt = (x[:, :kv_len].repeat_interleave(Hq // Hkv, dim=2)
              .transpose(1, 2) for x in (k, v))
    pos = torch.arange(kv_len, device="cuda")
    mask = (q_offset + pos[:Sq, None]) >= pos[None, :]
    lib_kw = (dict(is_causal=True) if q_offset == 0 and Sq == kv_len
              else dict(attn_mask=mask))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
    sdpa()                                  # its first call loads kernels
    timed, outs = kernel_ms([("sdpa", sdpa)] * reps)
    lib = sum(t for _, t in timed) / reps
    lib_err = float((outs[-1].transpose(1, 2).float() - want).abs().max())
    return ms, plain, lib, err, lib_err


TIMED_HOOKS = {"start": "_start", "tick": "_decode_tick",
               "finish": "_finish", "restore": "_restore_snapshot",
               "store": "_offer"}


def timed_engine(spent, sync_before=False):
    """A ServeEngine whose methods named by ``spent``'s keys (TIMED_HOOKS)
    each append the seconds they took on the host clock to ``spent[key]``,
    ending in a sync (``sync_before``: and starting after one, so that no
    earlier work of the card is counted in them)."""
    import torch
    from repro_torch.serve import ServeEngine

    def hook(name, key):
        def timed(self, *a):
            if sync_before:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = getattr(ServeEngine, name)(self, *a)
            torch.cuda.synchronize()
            spent[key].append(time.perf_counter() - t0)
            return out
        return timed
    return type("TimedServeEngine", (ServeEngine,),
                {TIMED_HOOKS[k]: hook(TIMED_HOOKS[k], k) for k in spent})


# the flash backward's kernels (flash_attention_bwd.cu): the wgmma design's
# prep, main and dq passes, and the mma.sync design's three
FLASH_BWD_KERNELS = ("::prep_kernel", "dkdvq_kernel", "dq_out_kernel",
                     "delta_kernel", "dkdv_kernel", "dq_kernel")


def device_time_by_kind(prof):
    """(seconds of device time by kind of kernel, number of device
    activities, seconds by kernel name) of a finished torch.profiler run,
    read from its raw kineto events (building the profiler's Python event
    tree for a whole serving run takes minutes).  The flash backward's
    kind counts the union of its kernels' intervals: its dq pass runs
    beside the main kernel's tail."""
    from torch.autograd import DeviceType
    kinds = {"flash": 0.0, "flash backward": 0.0, "gemm": 0.0, "copy": 0.0,
             "other": 0.0}
    names: dict = {}
    spans = []
    n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        low = name.lower()
        ns = (e.duration_ns() if hasattr(e, "duration_ns")
              else e.duration_us() * 1e3)
        kind = ("flash" if "flash_attention_kernel" in low else
                "flash backward" if any(k in low for k in FLASH_BWD_KERNELS)
                else "gemm" if any(w in low for w in ("gemm", "xmma", "nvjet",
                                                      "cutlass")) else
                "copy" if "memcpy" in low or "memset" in low else "other")
        if kind == "flash backward":
            t0 = (e.start_ns() if hasattr(e, "start_ns")
                  else e.start_us() * 1e3)
            spans.append((t0, t0 + ns))
        else:
            kinds[kind] += ns / 1e9
        names[name] = names.get(name, 0.0) + ns / 1e9
        n += 1
    end = None
    for t0, t1 in sorted(spans):
        if end is not None and t0 < end:
            t0 = end
        if t1 > t0:
            kinds["flash backward"] += (t1 - t0) / 1e9
        end = t1 if end is None else max(end, t1)
    return kinds, n, names


def llm_phase12(card):
    """Phase 12: run L through ServeEngine at full width (counts set to 0
    just before, read just after), then again with its phases timed, once
    more under torch.profiler, and the flash kernel at each of L's
    attention shapes.  Returns (flash launches, the largest max |kernel -
    plain| at L's shapes, the kernel's JSON numbers as means per launch
    over L's launches: ms, plain ms, bound ms, bound_by, library ms)."""
    import torch
    from repro_torch.check_runs import (L_ENGINE, L_NEW_TOKENS, L_PINS,
                                        L_WORKLOAD)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.driver import make_workload
    cfg = get_config("qwen3-4b")
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    wl = dict(L_WORKLOAD)
    prompts = make_workload(cfg, wl.pop("n_requests"), **wl)

    def serve_l(engine_cls):
        eng = engine_cls(model, params, **L_ENGINE, device_sketch=True)
        for pr in prompts:
            eng.submit(pr, L_NEW_TOKENS)
        reqs = list(eng.queue)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return eng, reqs, out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    eng, reqs, out, wall = serve_l(ServeEngine)
    launches = read_launches()
    stats = eng.stats
    check(stats == L_PINS, f"L: stats {stats} != JAX {L_PINS}")
    check(len(out) == len(prompts) and all(
        len(t) == L_NEW_TOKENS and all(0 <= x < cfg.vocab_size for x in t)
        for t in out.values()), "L: missing or bad generated tokens")
    check(launches["flash_attention"] == cfg.n_layers * len(reqs),
          f"L: {launches['flash_attention']} flash launches, expected "
          f"{cfg.n_layers} per extend x {len(reqs)}")
    check(launches["sketch_update"] == eng.prefix_cache.stats.lookups
          and launches["admission"] == stats["admitted"] + stats["rejected"],
          f"L: sketch launches {launches}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 12 L: qwen3-4b full width ({cfg.n_layers} layers, "
          f"{n_params:,} parameters, bf16; init {init_s:.2f} s), "
          f"{len(prompts)} prompts of {len(prompts[0])} tokens: stats == "
          f"JAX {stats}")
    print(f"phase 12 L: wall {wall:.3f} s for {len(prompts)} requests "
          f"(host clock, ends in a sync); {stats['tokens_prefilled']} "
          f"tokens prefilled, {stats['tokens_prefilled'] / wall:,.0f} per "
          f"second of wall; launches {launches}; max_memory_allocated "
          f"{peak} bytes; card {card}")
    del eng

    # the same run with each phase timed on the host clock (each ends in a
    # sync, after the emitted token's read or the offers)
    spent = {"start": [], "tick": [], "finish": []}
    t_eng, _, t_out, t_wall = serve_l(timed_engine(spent))
    check(t_eng.stats == stats and t_out == out,
          "L: the timed run differs from the main run")
    del t_eng

    # and once more under torch.profiler: device time by kind of kernel,
    # and the share of the run's wall time in which the card ran none
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_eng, _, p_out, p_wall = serve_l(ServeEngine)
        t1 = time.perf_counter()
    check(p_eng.stats == stats and p_out == out,
          "L: the profiled run differs from the main run")
    del p_eng
    kinds, n_kernels, _ = device_time_by_kind(prof)
    read_s = time.perf_counter() - t1
    del prof
    busy = sum(kinds.values())
    if busy:
        print(f"phase 12 L profiled run (torch.profiler): wall {p_wall:.3f}"
              f" s with the profiler on (stopping it and reading its "
              f"events {read_s:.1f} s more); {n_kernels} device "
              f"activities, busy {busy:.3f} s: gemm {kinds['gemm']:.3f}, "
              f"flash {kinds['flash']:.3f}, copies {kinds['copy']:.3f}, "
              f"other kernels {kinds['other']:.3f}; device idle share "
              f"{1 - busy / p_wall:.4f} of the profiled wall, "
              f"{1 - busy / t_wall:.4f} of the timed run's, "
              f"{1 - busy / wall:.4f} of the main run's; card {card}")
    else:
        print("phase 12 L profiled run: the profiler saw no device "
              "activity; device time by kind not measured")
    mix = {}
    for r in reqs:
        start = r.prefix_blocks_reused * L_ENGINE["block_size"]
        key = (len(r.prompt) - start, start, len(r.prompt))
        mix[key] = mix.get(key, 0) + cfg.n_layers
    per, worst = {}, 0.0
    for (Sq, off, kvl), n in sorted(mix.items()):
        ms, plain, lib, err, lib_err = time_flash_shape(Sq, off, kvl)
        worst = max(worst, err)
        flops, nbytes = flash_work(Sq, off, kvl)
        o_ms = flops / BF16_FLOPS_PER_S * 1e3
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        per[(Sq, off, kvl)] = (ms, plain, lib, o_ms, b_ms)
        gp = 1                          # the kernel's work items and CTAs
        while gp < 16 and (cfg.n_heads // cfg.n_kv_heads) % (2 * gp) == 0:
            gp *= 2
        items = -(-Sq // (128 // gp)) * (cfg.n_heads // gp)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"phase 12 L flash Sq={Sq} q_offset={off} kv_len={kvl}: "
              f"{items} work items of {128 // gp} positions x {gp} heads on "
              f"{min(items, sms)} persistent CTAs (1 per SM); "
              f"{n} launches; kernel {ms:.4f} ms (max |kernel - plain| "
              f"{err:.4f}); plain {plain:.3f} ms; "
              f"scaled_dot_product_attention {lib:.4f} ms (max |sdpa - "
              f"plain| {lib_err:.4f}); bound: {flops / 1e9:.3f} GFLOP over "
              f"989 TFLOP/s = {o_ms:.4f} ms, {nbytes / 1e6:.2f} MB over "
              f"3.35 TB/s = {b_ms:.4f} ms; kernel at "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{max(o_ms, b_ms) / ms:.3f} of the bound; card {card}")
    total = sum(mix.values())

    def mean(i):
        return sum(per[k][i] * n for k, n in mix.items()) / total

    flash_s = sum(per[k][0] * n for k, n in mix.items()) / 1e3
    start_s, tick_s = sum(spent["start"]), sum(spent["tick"])
    finish_s = sum(spent["finish"])
    print(f"phase 12 L timed run: wall {t_wall:.3f} s; "
          f"{len(spent['start'])}"
          f" starts (lookup, gather, extend, head) {start_s:.3f} s, "
          f"{stats['tokens_prefilled'] / start_s:,.0f} prefill tokens/s; "
          f"{len(spent['tick'])} decode ticks {tick_s:.3f} s, "
          f"{tick_s / len(spent['tick']) * 1e3:.2f} ms per tick; "
          f"{len(spent['finish'])} finishes (offers to the pool) "
          f"{finish_s:.3f} s; the flash kernel's time is a share "
          f"{flash_s / start_s:.4f} of the starts' wall time; card {card}")
    o_ms, b_ms = mean(3), mean(4)
    return launches["flash_attention"], worst, dict(
        ms=mean(0), plain_ms=mean(1), library_ms=mean(2),
        bound_ms=max(o_ms, b_ms),
        bound_by="operations" if o_ms >= b_ms else "bytes")


def llm_phase13(card):
    """Phase 13: qwen3-4b at full width and depth 2 with numpy_params
    weights against the JAX pin D2."""
    from repro_torch.check_runs import D2_PINS
    depth_pin("13", "D2", "qwen3-4b", 2, D2_PINS, card)


def depth_pin(phase, name, arch, n_layers, pins, card, routing=None,
              fp32=False, bounds=None, leaves=None, prompt_len=None):
    """A depth pin: ``arch`` at full width cut to ``n_layers`` with the
    ``numpy_leaves`` weights (handed to the card one leaf at a time, or
    ``leaves`` when given), bf16 compute (``fp32``: fp32): prefill the
    pin's prompt (its first ``prompt_len`` tokens), then decode the JAX model's greedy tokens; each step's
    logits at the pinned top-8 ids within D2_TOL of the largest (or the
    step's entry of ``bounds``).  With ``routing`` (the JAX expert of each
    prompt token at the first MoE layer), prints how many of the port's
    experts differ and the router's top-2 margins.  Returns the seconds it
    took."""
    import torch
    from repro_torch.check_runs import (D2_MAX_LEN, D2_SEED, D2_STEPS,
                                        d2_prompt, numpy_leaves)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    cfg = get_config(arch).replace(n_layers=n_layers)
    if fp32:
        cfg = cfg.replace(compute_dtype=torch.float32)
    t0 = time.perf_counter()
    params = params_from_numpy(cfg, leaves if leaves is not None
                               else numpy_leaves(cfg, D2_SEED))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    m = Model(cfg)
    cache = m.init_cache(1, D2_MAX_LEN)
    prompt = torch.from_numpy(
        d2_prompt(cfg.vocab_size)[None, :prompt_len]).cuda()
    t1 = time.perf_counter()
    cache, h = m.prefill(params, {"tokens": prompt}, cache)
    logits = m.lm_head(params, h)[0, 0]
    worst = 0.0
    for step, (ids, want) in enumerate(pins):
        got = logits[list(ids)].cpu().numpy()
        rel = float(np.max(np.abs(got - np.asarray(want)))
                    / np.max(np.abs(want)))
        top = logits.topk(8).indices.tolist()
        bound = bounds[step] if bounds else D2_TOL
        check(bool(torch.isfinite(logits).all()) and rel < bound,
              f"{name} step {step}: logits at the JAX top-8 differ by "
              f"{rel:.4f} of the largest (> {bound:.4f})")
        worst = max(worst, rel)
        print(f"phase {phase} {name} step {step}: max |port - JAX| over the "
              f"JAX top-8 {rel:.5f} of the largest (bound {bound:.4f}); "
              f"top-1 {top[0]} (JAX {ids[0]}); {len(set(top) & set(ids))} "
              f"of 8 ids shared")
        if step < D2_STEPS:
            tok = torch.tensor([[ids[0]]], device="cuda")
            logits, cache = m.decode(params, tok, cache)
            logits = logits[0, 0]
    check(int(cache["pos"][0]) == len(prompt[0]) + D2_STEPS,
          f"{name}: cache position")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    if routing is not None:
        from repro_torch.models import transformer as T
        routing = "".join(routing)
        blk, j = params.layers[0], cfg.moe_every - 1
        x = T.embed_tokens(params, prompt, cfg)
        pos = torch.arange(x.shape[1], device="cuda")[None]
        for i in range(j + 1):
            x, _ = T.attn_block_train(getattr(blk, f"attn{i}"), x, cfg, pos)
            if i < j:
                x, _ = T.ffn_or_moe(blk, i, x, cfg)
        hm = T.rmsnorm(x, getattr(blk, f"moe{j}_norm"), cfg.norm_eps)
        lg = (hm @ getattr(blk, f"moe{j}").router).float()[0]
        mine = lg.argmax(-1).tolist()
        want = [int(c, 36) for c in routing]
        top2 = lg.topk(2, -1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        flips = [i for i, (a, b) in enumerate(zip(mine, want)) if a != b]
        print(f"phase {phase} {name} routing at the first MoE layer: "
              f"{len(flips)} of {len(want)} prompt tokens sent to another "
              f"expert than JAX's (positions {flips[:8]}); the router's top-2"
              f" margin (bf16 logits) min {margin.min():.6f}, median "
              f"{float(np.median(margin)):.6f}, at the differing tokens "
              f"{[round(float(margin[i]), 6) for i in flips[:8]]}")
    print(f"phase {phase} {name}: {arch} full width, {n_layers} layer(s), "
          f"{n_params:,} parameters, {'fp32' if fp32 else 'bf16'} compute, "
          f"{prompt.shape[1]}-token prompt, "
          f"numpy_leaves loaded in {load_s:.1f} s, prefill and {D2_STEPS} "
          f"decodes {run_s:.2f} s: every step within its bound (worst "
          f"{worst:.5f}); card {card}")
    del params, cache
    return time.perf_counter() - t0


def lane_case(case, fn, device):
    """LANE_CASES[case] through ``fn`` on ``device``, one call per chunk
    for every lane (lane_n_valid's counts): (state, hits)."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    _, kw, prows, wcap, mcap, kind, n, chunk = LANE_CASES[case]
    spec = ks.StepSpec(**kw, streams=LANES)
    lo, hi = lanes_on_card(lane_keys(kind, n), device)
    params = case_params(prows, spec, device)
    state = ks.init_step_state(spec, wcap, mcap, device=device)
    hits = [fn(spec, params, state, lo[:, s:s + chunk], hi[:, s:s + chunk],
               lane_n_valid(chunk, c, n - s))[1]
            for c, s in enumerate(range(0, n, chunk))]
    return state, torch.cat(hits, dim=1)


def lanes_phase14():
    """Phase 14: the step kernel's lane grid (one CTA per lane, one launch
    per chunk) against step_ref with lanes (on the host's CPU, in the
    pool), over check_runs.LANE_CASES: flat and set tables, shared and
    per-lane params, lane_n_valid's shorter and empty lanes, F's geometry;
    every state leaf and hit flag must be equal.  Returns the max abs
    difference."""
    from repro_torch.kernels import sketch_step as ks
    err = 0
    jobs = [submit_plain(lane_case, i) for i in range(len(LANE_CASES))]
    for i, (name, kw, prows, wcap, mcap, kind, n,
            chunk) in enumerate(LANE_CASES):
        spec = ks.StepSpec(**kw, streams=LANES)
        got = lane_case(i, ks.step, "cuda")
        want = jobs[i].result()
        err = max(err, plain_diff(f"lanes {name}", got, want))
        steps = [int(x) for x in np.sum(
            [lane_n_valid(chunk, c, n - s)
             for c, s in enumerate(range(0, n, chunk))], axis=0)]
        check(want[0]["regs"][:, ks.R_T].tolist() == steps,
              f"lanes {name}: the plain run did not take each lane's "
              f"n_valid")
        print(f"phase 14 lanes {name}: kernel == plain, {LANES} lanes x "
              f"{n} accesses (chunk {chunk}, accesses per lane {steps}, "
              f"{len(prows)} params row(s), {spec.assoc or 'flat'} ways)")
    return err


def t_trace(f_trace):
    """Run T's (T_LANES, T_ACCESSES) keys: lane 0 is F's trace."""
    from repro_torch.traces.synthetic import tenant_lanes_trace
    tr = np.empty((T_LANES, T_ACCESSES), np.int64)
    tr[0] = f_trace
    tr[1:] = tenant_lanes_trace(T_LANES - 1, T_ACCESSES, **T_TENANTS)
    return tr


def tenant_phase15(tr, card):
    """Phase 15: run T (T_LANES tenant caches at F's geometry) through
    simulate_trace, the launch counts set to 0 just before and read just
    after: one launch per chunk for all lanes; lane 0 must equal F's JAX
    pins and lanes T_SOLO their solo runs.  Then the same run with CUDA
    events around each launch, and the bound.  Returns (launches, ms per
    launch, bound ms per launch)."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  simulate_trace)
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.phase_timing import RT_HIT, RT_MISS, \
        l2_round_trip_ns
    kw = dict(warmup=F_WARMUP, assoc=F_ASSOC, chunk=F_CHUNK,
              return_state=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    t0 = time.perf_counter()
    res, state, flags = simulate_trace(tr, F_CAPACITY, streams=T_LANES,
                                       trace_name="tenants-64", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    nchunks = math.ceil(T_ACCESSES / F_CHUNK)
    check(launches["sketch_step"] == nchunks
          and sum(launches.values()) == nchunks,
          f"T: launches {launches}, expected {nchunks} step launches")
    lane_hits = res.extra["lane_hits"]

    def lane(b):
        return {k: v[b] for k, v in state.items()}

    check(lane_hits[0] == F_HITS
          and state["regs"][0].cpu().tolist() == F_REGS
          and digest(lane(0)) == F_DIGEST
          and int(flags[0, F_WARMUP:].sum()) == F_HITS,
          f"T: lane 0 (F's trace) hits {lane_hits[0]} regs "
          f"{state['regs'][0].cpu().tolist()} digest {digest(lane(0))} != "
          f"F's JAX pins")
    check(res.hits == sum(lane_hits)
          and res.accesses == (T_ACCESSES - F_WARMUP) * T_LANES
          and flags.shape == tr.shape, "T: aggregate result disagrees")
    state_bytes = sum(v.numel() * v.element_size() for v in state.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 15 T: {T_LANES} lanes x {T_ACCESSES} accesses at F's "
          f"geometry; lane 0 hits, regs and digest == F's JAX pins; hits "
          f"{res.hits}/{res.accesses} ratio {res.hit_ratio:.6f}; lane hits "
          f"min {min(lane_hits)} max {max(lane_hits)}")
    print(f"phase 15 T: wall {wall:.3f} s, {tr.size / wall:,.0f} acc/s "
          f"aggregate (host clock around simulate_trace, upload and hashing "
          f"included); launches {launches['sketch_step']}; state "
          f"{state_bytes} bytes ({state_bytes / 2**20:.1f} MiB); "
          f"max_memory_allocated {peak} bytes; card {card}")
    for b in T_SOLO:
        r, s, h = simulate_trace(tr[b], F_CAPACITY, **kw)
        check(r.hits == lane_hits[b] and bool(torch.equal(h, flags[b]))
              and digest(s) == digest(lane(b)),
              f"T: lane {b} differs from its solo run")
    print(f"phase 15 T: lanes {T_SOLO} == their solo runs (hit flags, "
          f"state digest)")

    # the same run, CUDA events around each launch
    cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, streams=T_LANES)
    t_state, t_hits, launch_ms, stream_ms, _ = timed_launches(
        tr, cfg, F_CHUNK, F_WARMUP)
    check(digest(t_state) == digest(state)
          and bool(torch.equal(t_hits, flags)),
          "T: the timed run differs from the main run")
    del t_state, t_hits
    ms = sum(launch_ms) / len(launch_ms)
    idle = 1.0 - sum(launch_ms) / stream_ms
    print(f"phase 15 T: kernel {ms:.4f} ms per launch (CUDA events around "
          f"each of {len(launch_ms)}; min {min(launch_ms):.4f}, max "
          f"{max(launch_ms):.4f}), {ms * 1e6 / F_CHUNK:.0f} ns per access "
          f"per lane, {T_LANES * F_CHUNK / ms * 1e3:,.0f} acc/s aggregate "
          f"of kernel time; runner stream {stream_ms:.1f} ms, device idle "
          f"share {idle:.6f}")

    # bound: each lane's words (bound_bytes), summed; the latency floor of
    # one lane's chain, the lanes running side by side
    spec1 = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC).spec()
    total = sum(bound_bytes(spec1, tr[b], F_CHUNK, cfg.sample_size)[0]
                for b in range(T_LANES))
    bound_ms = total / nchunks / HBM_BYTES_PER_S * 1e3
    h = float(flags.float().mean())
    rt = l2_round_trip_ns(load_library("l2_chase"))
    trips = RT_HIT * h + RT_MISS * (1 - h)
    floor_ms = F_CHUNK * trips * rt / 1e6
    print(f"phase 15 T: bound {total} bytes over the run = "
          f"{total / nchunks:.0f} bytes per launch over 3.35 TB/s = "
          f"{bound_ms:.6f} ms per launch (the kernel is "
          f"{ms / bound_ms:.0f}x above it); latency floor {trips:.2f} "
          f"dependent L2 round trips per access (hit share {h:.4f}) x "
          f"{rt:.1f} ns = {trips * rt:.0f} ns per access per lane, "
          f"{floor_ms:.4f} ms per launch with the {T_LANES} lanes side by "
          f"side (the kernel is {ms / floor_ms:.1f}x above it)")
    return launches["sketch_step"], ms, bound_ms


def lane_grid_step(spec, params, state, lo, hi, n_valid, probes):
    """One launch of the lane kernel over unbatched inputs: one lane."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    hits = torch.empty_like(lo)
    ks._launch(spec, params, state, lo, hi, probes, n_valid, hits,
               lane_grid=True)
    return state, hits


def scaling_phase16(tr, card):
    """Phase 16: F's geometry at T_SCALING lanes over the first
    T_SCALING_ACCESSES accesses of each lane (lane b replays lane b %
    T_LANES), and at one lane through the lane kernel too: kernel ms per
    launch, ns per access per lane and aggregate accesses per second of
    kernel time, the state's bytes against the 50 MB L2.  Lanes replaying
    one trace, and the lane kernel at one lane, must give equal hit
    flags."""
    import torch
    from repro_torch.core.device_simulate import DeviceWTinyLFU
    agg, one = {}, None
    for B, fn in [(1, None), (1, lane_grid_step)] + [
            (B, None) for B in T_SCALING if B > 1]:
        sub = tr[np.arange(B) % T_LANES, :T_SCALING_ACCESSES]
        cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, streams=B)
        state, hits, launch_ms, stream_ms, _ = timed_launches(
            sub[0] if B == 1 else sub, cfg, F_CHUNK, 0, fn)
        nbytes = sum(v.numel() * v.element_size() for v in state.values())
        if B > T_LANES:
            twins = np.arange(T_LANES, B)
            check(bool(torch.equal(hits[twins], hits[twins % T_LANES])),
                  f"scaling B={B}: lanes replaying one trace differ")
        if B == 1:
            check(one is None or (bool(torch.equal(hits, one[1]))
                                  and digest(state) == one[0]),
                  "scaling: the lane kernel at one lane differs from the "
                  "single-stream kernel")
            one = (digest(state), hits)
        dev_ms = sum(launch_ms)
        agg.setdefault(B, B * T_SCALING_ACCESSES / dev_ms * 1e3)
        kind = "lane kernel" if fn else "kernel"
        print(f"phase 16 B={B:<3d} {kind:11s} {dev_ms / len(launch_ms):.4f} "
              f"ms per launch, {dev_ms * 1e6 / T_SCALING_ACCESSES:.0f} ns per "
              f"access per lane, {B * T_SCALING_ACCESSES / dev_ms * 1e3:,.0f} "
              f"acc/s aggregate (kernel time, {len(launch_ms)} launches); "
              f"idle share {1 - dev_ms / stream_ms:.6f}; state {nbytes} "
              f"bytes ({nbytes / 2**20:.1f} MiB, {nbytes / 50e6:.2f}x the "
              f"50 MB L2)")
        del state, hits
        torch.cuda.empty_cache()
    print(f"phase 16 scaling_1_to_64 {agg[64] / agg[1]:.2f} (aggregate "
          f"acc/s at 64 lanes over 1 stream); card {card}")


def sweep_phase17(f_trace, card):
    """Phase 17: run W, simulate_sweep over F's trace as lanes of one run
    (mode="vmap", the launch counts set to 0 just before and read just
    after) and one configuration after another (mode="sequential"): the
    sequential (65,536, 0.01) row is F; two vmap rows must equal solo runs
    of their padded configuration."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  _padded_grid, _trace_lanes,
                                                  run_chunks, simulate_sweep)
    from repro_torch.kernels import sketch_step as ks
    kw = dict(window_fracs=W_FRACS, assoc=F_ASSOC, warmup=F_WARMUP,
              chunk=F_CHUNK, trace_name="zipf-1.2M")
    seq = simulate_sweep(f_trace, W_CAPS, mode="sequential", **kw)
    set_launches(0)
    vm = simulate_sweep(f_trace, W_CAPS, mode="vmap", **kw)
    launches = read_launches()
    nchunks = math.ceil(len(f_trace) / F_CHUNK)
    check(launches["sketch_step"] == nchunks
          and sum(launches.values()) == nchunks, f"W: launches {launches}")
    key = [(r.cache_size, r.extra["window_frac"]) for r in seq]
    check(seq[key.index((65_536, 0.01))].hits == F_HITS,
          "W: the sequential (65536, 0.01) row differs from F")
    grid = [DeviceWTinyLFU(C, window_frac=wf, assoc=F_ASSOC)
            for C in W_CAPS for wf in W_FRACS]
    spec, states = _padded_grid(grid, "cuda")
    nbytes = sum(v.numel() * v.element_size() for s in states
                 for v in s.values())
    lo, hi = _trace_lanes(f_trace, "cuda")
    for cw in ((32_768, 0.01), (131_072, 0.2)):
        g = key.index(cw)
        st, _ = run_chunks(spec, grid[g].params(warmup=F_WARMUP,
                                                device="cuda"),
                           states[g], lo, hi, F_CHUNK)
        check(int(st["regs"][ks.R_HITS]) == vm[g].hits,
              f"W: the vmap row {cw} differs from its padded solo run")
    for s_row, v_row in zip(seq, vm):
        print(f"phase 17 W: C={s_row.cache_size:<6d} wf="
              f"{s_row.extra['window_frac']:<4} vmap hits {v_row.hits} "
              f"(ratio {v_row.hit_ratio:.6f}), sequential {s_row.hits} "
              f"(ratio {s_row.hit_ratio:.6f})")
    v_wall, s_wall = vm[0].extra["grid_wall_s"], seq[0].extra["grid_wall_s"]
    n = len(grid) * len(f_trace)
    print(f"phase 17 W: vmap {len(grid)} lanes padded to C={max(W_CAPS)}'s "
          f"geometry ({nbytes} bytes of state, {nbytes / 2**20:.1f} MiB): "
          f"wall {v_wall:.3f} s, {n / v_wall:,.0f} acc/s aggregate, "
          f"{launches['sketch_step']} launches; sequential {s_wall:.3f} s, "
          f"{n / s_wall:,.0f} acc/s ({s_wall / v_wall:.2f}x the vmap wall); "
          f"the (65536, 0.01) sequential row == F; vmap rows (32768, 0.01) "
          f"and (131072, 0.2) == their padded solo runs; card {card}")
    del states
    torch.cuda.empty_cache()


def host_phase18(card, device_rates):
    """Phase 18: P1's admitting policies through default-constructed
    caches (the host sketch; no kernel launch, counts set to 0 just before
    and read just after); every PrefixCacheStats field must equal the
    default JAX cache's."""
    import dataclasses
    from repro_torch.serve import PrefixCache
    from repro_torch.traces.synthetic import multi_tenant_prompt_trace
    p1 = multi_tenant_prompt_trace(**P1_TRACE)
    for policy in ("tinylfu", "wtinylfu"):
        for cap in P1_CAPS:
            pc = PrefixCache(cap, policy=policy)
            set_launches(0)
            t0 = time.perf_counter()
            stats = replay(pc, p1)
            wall = time.perf_counter() - t0
            launches = read_launches()
            got = dataclasses.astuple(stats)
            want = P1_HOST_PINS[(policy, cap)]
            check(got == want, f"P1-host {policy} C={cap}: stats {got} != "
                  f"JAX {want}")
            check(sum(launches.values()) == 0,
                  f"P1-host {policy} C={cap}: launches {launches}")
            decisions = stats.admitted + stats.rejected
            rate = device_rates.get(("P1", policy, cap))
            rate = f"{rate:,.0f}" if rate else "not replayed"
            print(f"phase 18 P1-host {policy:8s} C={cap:<5d} stats == JAX "
                  f"(default PrefixCache, host sketch), hit ratio "
                  f"{stats.hit_ratio:.6f}; wall {wall:.3f} s, "
                  f"{len(p1) / wall:,.0f} block accesses/s, "
                  f"{decisions / wall:,.0f} decisions/s (device sketch, "
                  f"phase 9: {rate}); no launch; {card}")


def case_params(prows, spec, device="cuda"):
    """The params of a LANE_CASES / SHARD_CASES case: one row (shared) or
    one per lane."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    params = torch.stack([ks.make_step_params(
        *p, counter_bits=spec.counter_bits, device=device) for p in prows])
    return params[0] if len(prows) == 1 else params


def flip_fold(spec, params, state):
    """The fold on the card against the fold on the CPU, from one state
    with a bit of shard 1's global counter slice flipped: every leaf must be
    equal, the quarantine count must rise by one and shard 1's global slices
    must be zero.  Returns the max abs difference."""
    import torch
    from repro_torch.kernels.sketch_merge import merge_halve
    st = {k: v.clone() for k, v in state.items()}
    word = spec.wps_shard + 5                     # row 0, shard 1
    st["counters"][word] ^= 1 << 3
    before = int(st["csum"][spec.shards])
    cpu = {k: v.cpu() for k, v in st.items()}
    merge_halve(spec, params, st)
    merge_halve(spec, params.cpu(), cpu)
    d = max(int((st[k].cpu().long() - cpu[k].long()).abs().max())
            for k in cpu)
    check(d == 0, "sharded fold: the card and the CPU differ")
    g = st["counters"][:spec.counter_words].reshape(
        spec.rows, spec.shards, spec.wps_shard)
    check(int(st["csum"][spec.shards]) == before + 1
          and not bool(g[:, 1].any())
          and not bool(st["doorkeeper"][spec.dkw_shard:2 * spec.dkw_shard]
                       .any()),
          "sharded fold: shard 1 was not quarantined")
    return d


def sharded_case(case, fn, device, times=None):
    """SHARD_CASES[case] through ``fn`` on ``device``, one call per epoch
    and merge_halve after each: (state, hits); ``times`` (a list) receives
    the ms per epoch by CUDA events."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.kernels.sketch_merge import merge_halve
    _, kw, prows, wcap, mcap, kind, n, epoch = SHARD_CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    spec = ks.StepSpec(**kw, streams=lanes)
    lo, hi = lanes_on_card(lane_keys(kind, n) if lanes > 1
                           else hazard_keys(kind, n, seed=case), device)
    params = case_params(prows, spec, device)
    state = ks.init_step_state(spec, wcap, mcap, device=device)
    starts = range(0, n, epoch)
    if times is not None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
    hits = []
    for c, s in enumerate(starts):
        nv = (lane_n_valid(epoch, c, n - s) if lanes > 1
              else min(epoch, n - s))
        hits.append(fn(spec, params, state, lo[..., s:s + epoch],
                       hi[..., s:s + epoch], nv)[1])
        merge_halve(spec, params, state)
    if times is not None:
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / len(starts))
    return state, torch.cat(hits, dim=-1)


def sharded_phase19():
    """Phase 19: the step kernel's sharded instances (kernel mode 1b)
    against step_ref over check_runs.SHARD_CASES (on the host's CPU, in the
    pool; F4's geometry on the card, timed), merge_halve after every epoch:
    flat and set tables, 4- and 8-bit counters, doorkeeper on and off, W
    below the epoch, 4 lanes with per-lane params and shorter lanes,
    integrity, F4's geometry; every state leaf and hit flag must be equal.
    Then the fold on the card against the fold on the CPU with a flipped
    global word.  Returns (max abs difference, the plain version's ms per
    F4 epoch)."""
    from repro_torch.kernels import sketch_step as ks
    last = len(SHARD_CASES) - 1                       # F4's geometry
    jobs = [submit_plain(sharded_case, i) for i in range(last)]
    err, times = 0, []
    for i, (name, kw, prows, wcap, mcap, kind, n,
            epoch) in enumerate(SHARD_CASES):
        lanes = LANES if len(prows) > 1 else 1
        spec = ks.StepSpec(**kw, streams=lanes)
        got = sharded_case(i, ks.step, "cuda")
        want = (jobs[i].result() if i < last else
                numpy_run(*sharded_case(i, ks.step_ref, "cuda", times)))
        err = max(err, plain_diff(f"sharded {name}", got, want))
        counts = [lane_n_valid(epoch, c, n - s) if lanes > 1
                  else min(epoch, n - s)
                  for c, s in enumerate(range(0, n, epoch))]
        steps = (np.sum(counts, axis=0).tolist() if lanes > 1
                 else sum(counts))
        check(want[0]["regs"][..., ks.R_T].tolist() == steps,
              f"sharded {name}: the plain run did not take every access")
        if i == last:
            err = max(err, flip_fold(spec, case_params(prows, spec), got[0]))
        print(f"phase 19 sharded {name}: kernel == plain, {lanes} lane(s) x "
              f"{n} accesses (epoch {epoch}, {len(counts)} folds, shards "
              f"{spec.shards}, {spec.assoc or 'flat'} ways, "
              f"{spec.counter_bits}-bit, dk_bits {spec.dk_bits}, integrity "
              f"{spec.integrity})")
    plain_ms = times[0]
    print(f"phase 19 sharded fold: the card's merge_halve == the CPU's on "
          f"F4's geometry with a flipped global word (shard 1 quarantined); "
          f"plain {plain_ms:.1f} ms per F4 epoch")
    return err, plain_ms


def f4_phase20(f_trace, zipf, card, f_ns):
    """Phase 20: run F4, the sharded sketch at F's geometry (shards=4, merge
    epoch 4,096), through simulate_trace with the launch and fold counts set
    to 0 just before and read just after: hits, registers and digest must
    equal the JAX pins; then with integrity=True (its own digest, no shard
    quarantined); G1's trace at 2 and 4 shards against the JAX hits; then
    the run with CUDA events around each launch and fold, and the bound.
    Returns (launches, ms per launch, bound ms per launch)."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  simulate_trace)
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.phase_timing import RT_HIT, RT_MISS, \
        l2_round_trip_ns
    from repro_torch.kernels.sketch_merge import merge_halve
    kw = dict(warmup=F_WARMUP, assoc=F_ASSOC, shards=SHARDS,
              trace_name="zipf-1.2M", return_state=True)
    n = len(f_trace)
    nep, nfold = -(-n // F4_EPOCH), n // F4_EPOCH
    torch.cuda.synchronize()
    set_launches(0)
    merge_halve.folds = 0
    t0 = time.perf_counter()
    res, state, flags = simulate_trace(f_trace, F_CAPACITY, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, folds = read_launches(), merge_halve.folds
    check(launches["sketch_step"] == nep and sum(launches.values()) == nep
          and folds == nfold, f"F4: launches {launches}, folds {folds}; "
          f"expected {nep} step launches and {nfold} folds")
    regs = state["regs"].cpu().tolist()
    check(res.hits == F4_HITS and regs == F4_REGS
          and digest(state) == F4_DIGEST
          and int(flags[F_WARMUP:].sum()) == F4_HITS,
          f"F4: hits {res.hits} regs {regs} digest {digest(state)} != JAX "
          f"{F4_HITS} {F4_REGS} {F4_DIGEST}")
    check(res.extra["shards"] == SHARDS
          and res.extra["merge_every"] == F4_EPOCH, f"F4: extra {res.extra}")
    print(f"phase 20 F4: C={F_CAPACITY} assoc={F_ASSOC} shards={SHARDS} "
          f"hits {res.hits}/{res.accesses} ratio {res.hit_ratio:.6f}, regs "
          f"and digest == JAX; wall {wall:.3f} s, {n / wall:,.0f} acc/s "
          f"(host clock around simulate_trace); {launches['sketch_step']} "
          f"launches, {folds} folds; card {card}")
    res_i, st_i, fl_i = simulate_trace(f_trace, F_CAPACITY, integrity=True,
                                       **kw)
    check(res_i.hits == F4_HITS and st_i["regs"].cpu().tolist() == F4_REGS
          and digest(st_i) == F4I_DIGEST and int(st_i["csum"][-1]) == 0
          and bool(torch.equal(fl_i, flags)) and res_i.extra["integrity"],
          f"F4 integrity: hits {res_i.hits} digest {digest(st_i)} csum "
          f"{int(st_i['csum'][-1])} != JAX {F4I_DIGEST}")
    print(f"phase 20 F4 integrity=True: hits, regs, hit flags == F4, digest "
          f"== JAX {F4I_DIGEST}, no shard quarantined")
    del st_i, fl_i
    for S, hits in G1_SHARDED_HITS.items():
        r = simulate_trace(zipf, 200, warmup=10_000, shards=S)
        check(r.hits == hits, f"G1 shards={S}: hits {r.hits} != JAX {hits}")
    print(f"phase 20 G1 sharded: hits at shards 2 and 4 == JAX "
          f"{G1_SHARDED_HITS}")

    cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, shards=SHARDS)
    t_state, t_hits, step_ms, stream_ms, fold_ms = timed_launches(
        f_trace, cfg, None, F_WARMUP)
    check(digest(t_state) == F4_DIGEST and bool(torch.equal(t_hits, flags)),
          "F4: the timed run differs from the main run")
    ms = sum(step_ms) / len(step_ms)
    fold = sum(fold_ms) / len(fold_ms)
    idle = 1.0 - (sum(step_ms) + sum(fold_ms)) / stream_ms
    ns = ms * 1e6 / F4_EPOCH
    print(f"phase 20 F4: kernel {ms:.4f} ms per launch (CUDA events around "
          f"each of {len(step_ms)}; min {min(step_ms):.4f}, max "
          f"{max(step_ms):.4f}), {ns:.0f} ns per access ({ns / f_ns:.3f}x "
          f"F's {f_ns:.0f}); fold {fold:.4f} ms per epoch ({len(fold_ms)} "
          f"folds, min {min(fold_ms):.4f}, max {max(fold_ms):.4f}), "
          f"{sum(fold_ms) / stream_ms:.4f} of the runner's stream "
          f"{stream_ms:.1f} ms; device idle share {idle:.6f}")
    spec = cfg.spec()
    total, _, _ = bound_bytes(spec, f_trace, F4_EPOCH, cfg.sample_size)
    bound_ms = total / nep / HBM_BYTES_PER_S * 1e3
    fold_bytes = 4 * 4 * (spec.counter_words + spec.dk_words)
    h = float(flags.float().mean())
    rt = l2_round_trip_ns(load_library("l2_chase"))
    trips = RT_HIT * h + RT_MISS * (1 - h)
    print(f"phase 20 F4 bound: {total} bytes over the run = {total / nep:.0f}"
          f" bytes per launch over 3.35 TB/s = {bound_ms:.6f} ms (the kernel "
          f"is {ms / bound_ms:.0f}x above it); latency floor {trips:.2f} "
          f"dependent L2 round trips per access x {rt:.1f} ns = "
          f"{trips * rt:.0f} ns per access ({ns / (trips * rt):.1f}x); the "
          f"fold reads and writes both halves, {fold_bytes} bytes = "
          f"{fold_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({fold / (fold_bytes / HBM_BYTES_PER_S * 1e3):.0f}x)")
    return launches["sketch_step"], ms, bound_ms


def t4_phase21(tr, card):
    """Phase 21: run T4, run T's 64 lanes with shards=4, through
    simulate_trace (launch and fold counts set to 0 just before and read
    just after: one launch per epoch for all lanes, a fold after every full
    epoch); lane 0 must equal F4's JAX pins and lanes T_SOLO their solo
    sharded runs; then the run with CUDA events around each launch and
    fold."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  simulate_trace)
    from repro_torch.kernels.sketch_merge import merge_halve
    kw = dict(warmup=F_WARMUP, assoc=F_ASSOC, shards=SHARDS,
              return_state=True)
    nep, nfold = -(-T_ACCESSES // F4_EPOCH), T_ACCESSES // F4_EPOCH
    torch.cuda.synchronize()
    set_launches(0)
    merge_halve.folds = 0
    t0 = time.perf_counter()
    res, state, flags = simulate_trace(tr, F_CAPACITY, streams=T_LANES,
                                       trace_name="tenants-64", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, folds = read_launches(), merge_halve.folds
    check(launches["sketch_step"] == nep and sum(launches.values()) == nep
          and folds == nfold, f"T4: launches {launches}, folds {folds}")
    lane_hits = res.extra["lane_hits"]

    def lane(b):
        return {k: v[b] for k, v in state.items()}

    check(lane_hits[0] == F4_HITS
          and state["regs"][0].cpu().tolist() == F4_REGS
          and digest(lane(0)) == F4_DIGEST
          and int(flags[0, F_WARMUP:].sum()) == F4_HITS,
          f"T4: lane 0 hits {lane_hits[0]} digest {digest(lane(0))} != F4's "
          f"JAX pins")
    check(res.hits == sum(lane_hits) and flags.shape == tr.shape,
          "T4: aggregate result disagrees")
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    print(f"phase 21 T4: {T_LANES} lanes x {T_ACCESSES} accesses, shards "
          f"{SHARDS}; lane 0 hits, regs and digest == F4's JAX pins; hits "
          f"{res.hits}/{res.accesses} ratio {res.hit_ratio:.6f}; wall "
          f"{wall:.3f} s, {tr.size / wall:,.0f} acc/s aggregate (host clock "
          f"around simulate_trace); {launches['sketch_step']} launches, "
          f"{folds} folds; state {nbytes} bytes ({nbytes / 2**20:.1f} MiB); "
          f"card {card}")
    for b in T_SOLO:
        r, s, h = simulate_trace(tr[b], F_CAPACITY, **kw)
        check(r.hits == lane_hits[b] and bool(torch.equal(h, flags[b]))
              and digest(s) == digest(lane(b)),
              f"T4: lane {b} differs from its solo run")
    print(f"phase 21 T4: lanes {T_SOLO} == their solo sharded runs (hit "
          f"flags, state digest)")
    del state
    cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, shards=SHARDS,
                         streams=T_LANES)
    t_state, t_hits, step_ms, stream_ms, fold_ms = timed_launches(
        tr, cfg, None, F_WARMUP)
    check(bool(torch.equal(t_hits, flags)),
          "T4: the timed run differs from the main run")
    del t_state, t_hits, flags
    ms = sum(step_ms) / len(step_ms)
    print(f"phase 21 T4: kernel {ms:.4f} ms per launch for all lanes ("
          f"{len(step_ms)} launches), {ms * 1e6 / F4_EPOCH:.0f} ns per access "
          f"per lane, {T_LANES * F4_EPOCH / ms * 1e3:,.0f} acc/s aggregate of "
          f"kernel time; fold {sum(fold_ms) / len(fold_ms):.4f} ms per epoch "
          f"for all lanes, {sum(fold_ms) / stream_ms:.4f} of the runner's "
          f"stream {stream_ms:.1f} ms; device idle share "
          f"{1 - (sum(step_ms) + sum(fold_ms)) / stream_ms:.6f}")


def w4_phase22(f_trace, card):
    """Phase 22: run W4, simulate_sweep over F's trace at W_CAPS with
    shards=4 on the card: mode="auto" resolves to "sequential", the 65,536
    row equals F4 and mode="vmap" raises the reference's ValueError."""
    from repro_torch.core.device_simulate import simulate_sweep
    kw = dict(window_fracs=(0.01,), assoc=F_ASSOC, shards=SHARDS,
              warmup=F_WARMUP, chunk=F_CHUNK, trace_name="zipf-1.2M")
    rows = simulate_sweep(f_trace, W_CAPS, **kw)
    check(all(r.extra["backend"] == "cuda+sequential"
              and r.extra["shards"] == SHARDS for r in rows),
          f"W4: rows {[r.extra for r in rows]}")
    row = rows[W_CAPS.index(65_536)]
    check(row.hits == F4_HITS, f"W4: the 65536 row {row.hits} != F4")
    try:
        simulate_sweep(f_trace, W_CAPS, mode="vmap", **kw)
        check(False, "W4: mode='vmap' did not raise")
    except ValueError as e:
        check(str(e) == "sharded sweeps run per-config epoch-chunked "
              "programs: use mode='sequential'", f"W4: vmap raised {e}")
    wall = rows[0].extra["grid_wall_s"]
    print(f"phase 22 W4: " + ", ".join(
        f"C={r.cache_size} hits {r.hits} (ratio {r.hit_ratio:.6f})"
        for r in rows) + f"; auto -> sequential, the 65536 row == F4, vmap "
          f"raises the reference's ValueError; grid wall {wall:.3f} s, "
          f"{len(rows) * len(f_trace) / wall:,.0f} acc/s; card {card}")


def adapt_case(case, fn, device, times=None):
    """ADAPT_CASES[case] through ``fn`` (step or step_ref) on ``device`` one
    epoch at a time (per-lane counts with lanes), then merge_halve when
    sharded and rebalance to the case's next quota.  Returns (spec, params,
    state, hit flags); ``times`` (a list) receives the ms of each ``fn``
    call by CUDA events."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.kernels.sketch_common import keys_to_lanes
    from repro_torch.kernels.sketch_merge import merge_halve
    _, kw, prows, wcap, mcap, kind, n, epoch, quotas = ADAPT_CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    spec = ks.StepSpec(**kw, adaptive=True, streams=lanes)
    params = torch.stack([ks.make_step_params(
        *p, counter_bits=spec.counter_bits, device=device) for p in prows])
    params = params[0] if lanes == 1 else params
    state = ks.init_step_state(spec, wcap, mcap, device=device)
    keys = lane_keys(kind, n) if lanes > 1 else hazard_keys(kind, n,
                                                            seed=case)
    lo, hi = (torch.from_numpy(x).to(device) for x in keys_to_lanes(keys))
    hits = []
    for c, s in enumerate(range(0, n, epoch)):
        nv = (lane_n_valid(epoch, c, n - s) if lanes > 1
              else min(epoch, n - s))
        if times is not None:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        hits.append(fn(spec, params, state, lo[..., s:s + epoch],
                       hi[..., s:s + epoch], nv)[1])
        if times is not None:
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        if spec.shards > 1:
            merge_halve(spec, params, state)
        ks.rebalance(spec, params, state, torch.tensor(
            quotas[c % len(quotas)], dtype=torch.int32, device=device))
    return spec, params, state, torch.cat(hits, dim=-1)


def adapt_run(case, fn, device):
    """:func:`adapt_case`'s (state, hits)."""
    return adapt_case(case, fn, device)[2:]


def climb_card_vs_cpu(spec, params, state, name):
    """One climb and rebalance on the card against the same on the CPU, from
    one state and one carry built to move the quota far (not warm, a
    disruption, an improving move): every leaf and the new carry must be
    equal.  Returns the max abs difference and the quotas before and
    after."""
    import torch
    from repro_torch.core.device_simulate import _climb_step
    from repro_torch.kernels import sketch_step as ks
    B = spec.streams
    eh = 100 + state["regs"][..., ks.R_HITS] % 50      # an epoch's hits
    wmax = spec.window_slots
    cv = torch.tensor([max(1, wmax // 16), 1, wmax, 2, 8, 3],
                      dtype=torch.int32)
    carry = torch.stack([eh.cpu() - 5, -torch.ones_like(eh.cpu()),
                         torch.full_like(eh.cpu(), 3),
                         eh.cpu() - 40, torch.zeros_like(eh.cpu()),
                         torch.full_like(eh.cpu(), 4)])
    if B > 1:          # per-lane climb vectors: lane b's tol b + 1
        cv = cv.repeat(B, 1)
        cv[:, 3] = torch.arange(1, B + 1, dtype=torch.int32)
    before = state["regs"][..., ks.R_WQUOTA].cpu().tolist()
    cpu = {k: v.cpu().clone() for k, v in state.items()}
    card = {k: v.clone() for k, v in state.items()}
    c_card = _climb_step(params, spec, card, carry.cuda(), eh, cv.cuda())
    c_cpu = _climb_step(params.cpu(), spec, cpu, carry, eh.cpu(), cv)
    d = max([int((c_card.cpu().long() - c_cpu.long()).abs().max())]
            + [int((card[k].cpu().long() - cpu[k].long()).abs().max())
               for k in cpu])
    check(d == 0, f"adaptive {name}: the card's climb and rebalance differ "
          f"from the CPU's")
    return d, before, card["regs"][..., ks.R_WQUOTA].cpu().tolist()


def adaptive_phase23():
    """Phase 23: the step kernel's adaptive instances (kernel mode 1c)
    against step_ref over check_runs.ADAPT_CASES (on the host's CPU, in the
    pool; FA's geometry on the card, timed), rebalance
    (after merge_halve when sharded) between epochs to quotas that go up and
    down and cross the window set count: flat and 8 and 16 ways, 4- and
    8-bit counters, doorkeeper on and off, 4 lanes with per-lane params and
    quotas and shorter lanes, shards=4, hazard keys, FA's geometry; every
    state leaf and hit flag must be equal.  Then one climb and rebalance on
    the card against the CPU's from the same state and carry.  Returns (max
    abs difference, the plain version's ms per 4,096 accesses at FA's
    geometry)."""
    from repro_torch.kernels import sketch_step as ks
    last = len(ADAPT_CASES) - 1                       # FA's geometry
    jobs = [submit_plain(adapt_run, i) for i in range(last)]
    err, plain_ms = 0, None
    for case, (name, *_, n, epoch, quotas) in enumerate(ADAPT_CASES):
        plain_times = []
        spec, params, k_state, k_hits = adapt_case(case, ks.step, "cuda")
        want = (jobs[case].result() if case < last else numpy_run(
            *adapt_case(case, ks.step_ref, "cuda", plain_times)[2:]))
        err = max(err, plain_diff(f"adaptive {name}", (k_state, k_hits),
                                  want))
        check(int(want[1].sum()) > 0, f"adaptive {name}: no hit at all")
        quota = k_state["regs"][..., ks.R_WQUOTA].tolist()
        print(f"phase 23 adaptive {name}: kernel == plain, {spec.streams} "
              f"lane(s) x {n} accesses (epoch {epoch}, rebalances to "
              f"{quotas}, final quota {quota}; {spec.assoc or 'flat'} ways, "
              f"window sets {spec.window_sets if spec.assoc else '-'}, "
              f"{spec.counter_bits}-bit, dk_bits {spec.dk_bits}, shards "
              f"{spec.shards})")
        if spec.streams > 1 or case == len(ADAPT_CASES) - 1:
            d, q0, q1 = climb_card_vs_cpu(spec, params, k_state, name)
            err = max(err, d)
            print(f"phase 23 adaptive {name}: climb + rebalance on the card "
                  f"== on the CPU (quota {q0} -> {q1})")
        if case == last:
            plain_ms = sum(plain_times) * ADAPT_EPOCH / n
    print(f"phase 23 adaptive: plain step_ref {plain_ms:.1f} ms per "
          f"{ADAPT_EPOCH} accesses at FA's geometry (CUDA events)")
    return err, plain_ms


def timed_adaptive(trace, cfg, warmup, climb):
    """The adaptive runner (device_simulate._run_adaptive's order: step,
    fold when sharded, climb and rebalance) with CUDA events around each
    launch, fold and climb.  Returns (state, hit flags, per-launch ms,
    per-fold ms, per-climb ms, the runner's stream ms, the host's ms per
    climb to enqueue it)."""
    import torch
    from repro_torch.core.device_simulate import (_climb_carry0,
                                                  _climb_step, _trace_lanes,
                                                  run_chunks)
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.kernels.sketch_merge import merge_halve
    spec = cfg.spec()
    params = cfg.params(warmup=warmup, device="cuda")
    state = ks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                               device="cuda")
    lo, hi = _trace_lanes(trace, "cuda")
    cvec = torch.as_tensor(climb.resolve(cfg), device="cuda")
    carry = [_climb_carry0(cvec)]
    steps, folds, climbs, marks, host = [], [], [], [], []

    def timed(f, out):
        def call(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = f(*args)
            e1.record()
            out.append((e0, e1))
            marks.append((e0, e1))
            return r
        return call

    def fold(spec, params, state):
        ehits = state["regs"][..., ks.R_EHITS].clone()
        if spec.shards > 1:
            timed(merge_halve, folds)(spec, params, state)
        t0 = time.perf_counter()
        carry[0] = timed(_climb_step, climbs)(params, spec, state, carry[0],
                                              ehits, cvec)
        host.append(time.perf_counter() - t0)

    state, hits = run_chunks(spec, params, state, lo, hi,
                             int(climb.epoch_len),
                             fn=timed(ks.step, steps), fold=fold)
    torch.cuda.synchronize()

    def ms(pairs):
        return [a.elapsed_time(b) for a, b in pairs]

    return (state, hits, ms(steps), ms(folds), ms(climbs),
            marks[0][0].elapsed_time(marks[-1][1]),
            sum(host) * 1e3 / max(1, len(host)))


def adaptive_run(name, f_trace, card, f_ns, pins, shards=1):
    """Phases 24 and 25: run FA (or FA4, ``shards=4``), F's trace and
    geometry with adaptive=True and the default ClimbSpec, through
    simulate_trace with the launch counts set to 0 just before and read
    just after (293 launches); hits, registers, digest, final quota and the
    whole trajectory must equal the JAX pins; then the run with CUDA events
    around each launch, fold and climb, and the bound.  Returns (launches,
    ms per launch, bound ms per launch, the climb's ms per epoch)."""
    import torch
    from repro_torch.core.device_simulate import (ClimbSpec, DeviceWTinyLFU,
                                                  simulate_trace)
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.phase_timing import RT_HIT, RT_MISS, \
        l2_round_trip_ns
    from repro_torch.kernels.sketch_merge import merge_halve
    hits_pin, regs_pin, digest_pin, quota_pin, (nep_pin, traj_pin) = pins
    kw = dict(shards=shards) if shards > 1 else {}
    n = len(f_trace)
    nep, nclimb = -(-n // ADAPT_EPOCH), n // ADAPT_EPOCH
    torch.cuda.synchronize()
    set_launches(0)
    merge_halve.folds = 0
    t0 = time.perf_counter()
    res, state, flags = simulate_trace(
        f_trace, F_CAPACITY, warmup=F_WARMUP, assoc=F_ASSOC, adaptive=True,
        climb=ClimbSpec(), trace_name="zipf-1.2M", return_state=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, folds = read_launches(), merge_halve.folds
    check(launches["sketch_step"] == nep and sum(launches.values()) == nep
          and folds == (nclimb if shards > 1 else 0),
          f"{name}: launches {launches}, folds {folds}; expected {nep} step "
          f"launches")
    regs = state["regs"].cpu().tolist()
    traj = res.extra["trajectory"]
    check(res.hits == hits_pin and regs == regs_pin
          and digest(state) == digest_pin
          and res.extra["final_quota"] == quota_pin
          and int(flags[F_WARMUP:].sum()) == hits_pin,
          f"{name}: hits {res.hits} regs {regs} digest {digest(state)} "
          f"quota {res.extra['final_quota']} != JAX {hits_pin} {regs_pin} "
          f"{digest_pin} {quota_pin}")
    check(len(traj["quota"]) == nep_pin == nclimb
          and trajectory_digest(traj) == traj_pin,
          f"{name}: trajectory of {len(traj['quota'])} epochs, digest "
          f"{trajectory_digest(traj)} != JAX {nep_pin} {traj_pin}")
    q = traj["quota"]
    nws = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, adaptive=True).spec() \
        .window_sets
    print(f"phase {24 if shards == 1 else 25} {name}: C={F_CAPACITY} "
          f"assoc={F_ASSOC} adaptive shards={shards} hits {res.hits}/"
          f"{res.accesses} ratio {res.hit_ratio:.6f}; regs, digest, final "
          f"quota {res.extra['final_quota']} and the {len(q)}-epoch "
          f"trajectory == JAX (quota {min(q)}..{max(q)} against {nws} window "
          f"sets; {sum(x < nws for x in q)} epochs below them); wall "
          f"{wall:.3f} s, {n / wall:,.0f} acc/s (host clock around "
          f"simulate_trace); {launches['sketch_step']} launches, {len(q)} "
          f"climbs, {folds} folds; card {card}")
    cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, adaptive=True, **kw)
    (t_state, t_hits, step_ms, fold_ms, climb_ms, stream_ms,
     host_ms) = timed_adaptive(f_trace, cfg, F_WARMUP, ClimbSpec())
    check(digest(t_state) == digest_pin and bool(torch.equal(t_hits, flags)),
          f"{name}: the timed run differs from the main run")
    ms = sum(step_ms) / len(step_ms)
    climb = sum(climb_ms) / len(climb_ms)
    fold = sum(fold_ms) / len(fold_ms) if fold_ms else 0.0
    idle = 1.0 - (sum(step_ms) + sum(fold_ms) + sum(climb_ms)) / stream_ms
    ns = ms * 1e6 / ADAPT_EPOCH
    fold_txt = (f"; fold {fold:.4f} ms per epoch, "
                f"{sum(fold_ms) / stream_ms:.4f} of the stream"
                if fold_ms else "")
    print(f"phase {24 if shards == 1 else 25} {name}: kernel {ms:.4f} ms per "
          f"launch (CUDA events around each of {len(step_ms)}; min "
          f"{min(step_ms):.4f}, max {max(step_ms):.4f}), {ns:.0f} ns per "
          f"access ({ns / f_ns:.3f}x F's {f_ns:.0f}); climb + rebalance "
          f"{climb:.4f} ms per epoch ({len(climb_ms)}; min "
          f"{min(climb_ms):.4f}, max {max(climb_ms):.4f}; the host enqueues "
          f"it in {host_ms:.4f} ms), {sum(climb_ms) / stream_ms:.4f} of the "
          f"runner's stream {stream_ms:.1f} ms{fold_txt}; device idle share "
          f"{idle:.6f}")
    profiled_adaptive(name, f_trace, shards, card)
    spec = cfg.spec()
    total, _, _ = bound_bytes(spec, f_trace, ADAPT_EPOCH, cfg.sample_size)
    bound_ms = total / nep / HBM_BYTES_PER_S * 1e3
    h = float(flags.float().mean())
    rt = l2_round_trip_ns(load_library("l2_chase"))
    trips = RT_HIT * h + RT_MISS * (1 - h)
    tables = 4 * (spec.window_slots * spec.wcols
                  + spec.main_slots * spec.mcols + 2 * spec.window_sets)
    print(f"phase {24 if shards == 1 else 25} {name} bound: {total} bytes "
          f"over the run = {total / nep:.0f} bytes per launch over 3.35 TB/s"
          f" = {bound_ms:.6f} ms (the kernel is {ms / bound_ms:.0f}x above "
          f"it); latency floor {trips:.2f} dependent L2 round trips per "
          f"access x {rt:.1f} ns = {trips * rt:.0f} ns per access "
          f"({ns / (trips * rt):.1f}x); the rebalance reads and writes the "
          f"tables, {2 * tables} bytes = "
          f"{2 * tables / HBM_BYTES_PER_S * 1e3:.6f} ms "
          f"({climb / (2 * tables / HBM_BYTES_PER_S * 1e3):.0f}x)")
    return launches["sketch_step"], ms, bound_ms, climb


PROFILED_EPOCHS = 24


def profiled_adaptive(name, f_trace, shards, card):
    """FA's (or FA4's) first PROFILED_EPOCHS epochs through simulate_trace
    under torch.profiler: the device time of the step kernel and of
    everything else (the climb, rebalance and fold's small kernels) per
    epoch, and the share of the run's wall in which the card ran nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.device_simulate import ClimbSpec, simulate_trace
    kw = dict(shards=shards) if shards > 1 else {}
    tr = f_trace[:PROFILED_EPOCHS * ADAPT_EPOCH]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulate_trace(tr, F_CAPACITY, assoc=F_ASSOC, adaptive=True,
                       climb=ClimbSpec(), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_us = other_us = 0.0
    n_other = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        if "sketch_step_kernel" in e.name:
            step_us += us
        else:
            other_us += us
            n_other += 1
    if not step_us:
        print(f"phase {24 if shards == 1 else 25} {name} profiled: the "
              f"profiler saw no device activity; not measured")
        return
    ep = PROFILED_EPOCHS - 1           # climbs: every epoch but the last
    busy = (step_us + other_us) / 1e6
    print(f"phase {24 if shards == 1 else 25} {name} profiled "
          f"(torch.profiler, first {PROFILED_EPOCHS} epochs): wall "
          f"{wall:.3f} s with the profiler on; step kernel "
          f"{step_us / 1e3 / PROFILED_EPOCHS:.4f} ms per epoch; the climb, "
          f"rebalance{' and fold' if shards > 1 else ''}'s "
          f"{n_other / ep:.0f} device activities "
          f"{other_us / 1e3 / ep:.4f} ms per epoch of device time; device "
          f"idle share {1 - busy / wall:.4f} of the profiled wall; card "
          f"{card}")


def wa_phase26(f_trace, card):
    """Phase 26: run WA, simulate_sweep over F's trace at 65,536 with
    window_fracs WA_FRACS, assoc=8, adaptive=True: as three lanes of one run
    (mode="vmap", counts set to 0 around it: one launch per epoch for all
    lanes) and one run after another; the rows' hits and final quotas must
    be equal between the modes and to the JAX pins, the 0.01 row FA's."""
    import torch
    from repro_torch.core.device_simulate import simulate_sweep
    kw = dict(window_fracs=WA_FRACS, assoc=F_ASSOC, adaptive=True,
              warmup=F_WARMUP, trace_name="zipf-1.2M")
    torch.cuda.synchronize()
    set_launches(0)
    lanes = simulate_sweep(f_trace, [F_CAPACITY], mode="vmap", **kw)
    launches = read_launches()
    nep = -(-len(f_trace) // ADAPT_EPOCH)
    check(launches["sketch_step"] == nep and sum(launches.values()) == nep,
          f"WA: launches {launches}, expected {nep}")
    seq = simulate_sweep(f_trace, [F_CAPACITY], mode="sequential", **kw)
    got = {r.extra["window_frac"]: (r.hits, r.extra["final_quota"])
           for r in lanes}
    check(got == {r.extra["window_frac"]: (r.hits, r.extra["final_quota"])
                  for r in seq}, "WA: lanes differ from the sequential rows")
    check(got == WA_PINS, f"WA: rows {got} != JAX {WA_PINS}")
    check(got[0.01] == (FA_HITS, FA_QUOTA), "WA: the 0.01 row is not FA")
    check(all(r.extra["backend"] == "cuda+vmap" for r in lanes)
          and all(r.extra["backend"] == "cuda+sequential" for r in seq),
          "WA: backends")
    wl, ws = lanes[0].extra["grid_wall_s"], seq[0].extra["grid_wall_s"]
    print(f"phase 26 WA: " + ", ".join(
        f"wf={wf} hits {h} quota {q}" for wf, (h, q) in got.items())
        + f" == JAX, lanes == sequential, the 0.01 row == FA; three lanes "
          f"{wl:.3f} s of wall ({launches['sketch_step']} launches), three "
          f"runs one after another {ws:.3f} s ({ws / wl:.2f}x); card {card}")
    return wl, ws


def ga_phase27(card):
    """Phase 27: run GA, the adaptivity goldens at C=800 (fickle churn and
    phase shift, 120,000 accesses, seed 3): the five static rows and the
    adaptive run must equal the JAX hits (and the adaptive run its final
    quota and digest), and the adaptive run must come within 0.01 of the
    best static row."""
    from repro_torch.core.device_simulate import (ClimbSpec, simulate_sweep,
                                                  simulate_trace)
    from repro_torch.traces import synthetic
    for gen in GA_TRACES:
        tr = getattr(synthetic, gen)(GA_ACCESSES, seed=GA_SEED)
        static_pin, hits_pin, quota_pin, digest_pin = GA_PINS[gen]
        rows = simulate_sweep(tr, [GA_CAPACITY], window_fracs=GA_FRACS,
                              mode="sequential", assoc=8)
        check(tuple(r.hits for r in rows) == static_pin,
              f"GA {gen}: static rows {[r.hits for r in rows]} != JAX "
              f"{static_pin}")
        a, st, _ = simulate_trace(tr, GA_CAPACITY, adaptive=True, assoc=8,
                                  climb=ClimbSpec(), return_state=True)
        check(a.hits == hits_pin and a.extra["final_quota"] == quota_pin
              and digest(st) == digest_pin,
              f"GA {gen}: adaptive hits {a.hits} quota "
              f"{a.extra['final_quota']} digest {digest(st)} != JAX "
              f"{hits_pin} {quota_pin} {digest_pin}")
        best = max(r.hit_ratio for r in rows)
        check(a.hit_ratio > best - GA_GAP,
              f"GA {gen}: adaptive {a.hit_ratio} not within {GA_GAP} of the "
              f"best static {best}")
        print(f"phase 27 GA {gen}: static hits {static_pin} at windows "
              f"{GA_FRACS}, adaptive {a.hits} (ratio {a.hit_ratio:.6f}, best "
              f"static {best:.6f}), final quota {a.extra['final_quota']}, "
              f"digest == JAX; card {card}")


def panel_case(case, fn, device, times=None):
    """PANEL_CASES[case] through ``fn`` on ``device``, chunk by chunk:
    (state, hits); ``times`` (a list) receives the ms per chunk by CUDA
    events."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    _, kw, prows, wcap, mcap, kind, n, chunk = PANEL_CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    spec = ks.StepSpec(**kw, streams=lanes)
    lo, hi = lanes_on_card(lane_keys(kind, n) if lanes > 1
                           else hazard_keys(kind, n, seed=case), device)
    starts = range(0, n, chunk)
    params = case_params(prows, spec, device)
    state = ks.init_step_state(spec, wcap, mcap, device=device)
    if times is not None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    hits = [fn(spec, params, state, lo[..., s:s + chunk], hi[..., s:s + chunk],
               lane_n_valid(chunk, c, n - s) if lanes > 1
               else min(chunk, n - s))[1]
            for c, s in enumerate(starts)]
    if times is not None:
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / len(starts))
    return state, torch.cat(hits, dim=-1)


def panel_phase28():
    """Phase 28: the step kernel's panel instances (kernel mode 1d: S3-FIFO,
    ARC, LFU; the third build) against step_ref over check_runs.PANEL_CASES
    (on the host's CPU, in the pool; the FP-geometry chunks on the card,
    timed), chunk by chunk: 1, 4, 8, 16 and 32 ways, one and
    two main sets, 4- and 8-bit counters, the doorkeeper on and off, resets
    inside and across chunk boundaries, zero-way window sets, ARC at 256 ghost
    bits with both halves cleared inside a chunk, four lanes with per-lane
    params and shorter lanes, the hazard traces' keys and one chunk at FP's
    geometry; every state leaf (ARC's ghost too) and hit flag must be equal.
    Returns (max abs difference, the plain version's ms per FP-geometry chunk
    by policy)."""
    from repro_torch.kernels import sketch_step as ks
    on_card = [i for i, c in enumerate(PANEL_CASES) if "FP geometry" in c[0]]
    jobs = {i: submit_plain(panel_case, i) for i in range(len(PANEL_CASES))
            if i not in on_card}
    err, plain_ms = 0, {}
    for case, (name, kw, prows, wcap, mcap, kind, n,
               chunk) in enumerate(PANEL_CASES):
        lanes = LANES if len(prows) > 1 else 1
        spec = ks.StepSpec(**kw, streams=lanes)
        nchunks = -(-n // chunk)
        times = []
        before = ks.step.launches
        got = panel_case(case, ks.step, "cuda", times)
        check(ks.step.launches - before == nchunks,
              f"panel {name}: {ks.step.launches - before} launches")
        if case in jobs:
            want = jobs[case].result()
            plain = (f"plain {want[2] * 1e3 / nchunks:.1f} ms per chunk on "
                     "the CPU")
        else:
            want = numpy_run(*panel_case(case, ks.step_ref, "cuda", times))
            plain_ms[spec.policy] = times[1]
            plain = f"plain {times[1]:.1f} ms per chunk on the card"
        err = max(err, plain_diff(f"panel {name}", got, want))
        check(int(want[1].sum()) > 0, f"panel {name}: no hit at all")
        regs = want[0]["regs"].reshape(-1, ks.NREGS)[0].tolist()
        print(f"phase 28 panel {name}: kernel == plain, {lanes} lane(s) x "
              f"{n} accesses (chunk {chunk}, {spec.assoc} ways, "
              f"{spec.main_sets} main sets, {spec.counter_bits}-bit, "
              f"dk_bits {spec.dk_bits}; lane 0 regs {regs}); kernel "
              f"{times[0]:.4f} ms, {plain}")
    return err, plain_ms


def fp_phase29(f_trace, card, f_wall, f_ns):
    """Phase 29: run FP, the panel at real size: F's trace, capacity and
    warmup through simulate_trace(..., assoc=8, policy=p) for each
    competitor (S3-FIFO at window_frac 0.1), the launch counts set to 0
    just before and read just after (2,344 launches each); hits, registers,
    digest and hit flags must equal the JAX pins.  Then each run with CUDA
    events around each launch (ms per launch, ns per access, device idle
    share) and its bound; and the slowest competitor against W-TinyLFU's
    F (the reference's arm 8).  Returns {policy: (launches, ms per launch,
    bound ms per launch)}."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  simulate_trace)
    n = len(f_trace)
    nchunks = math.ceil(n / F_CHUNK)
    out, rates = {}, {}
    for pol in PANEL_POLICIES:
        hits_pin, regs_pin, digest_pin = FP_PINS[pol]
        kw = dict(assoc=F_ASSOC, policy=pol, window_frac=PANEL_FRACS[pol])
        torch.cuda.synchronize()
        set_launches(0)
        t0 = time.perf_counter()
        res, state, flags = simulate_trace(
            f_trace, F_CAPACITY, warmup=F_WARMUP, chunk=F_CHUNK,
            trace_name="zipf-1.2M", return_state=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(launches["sketch_step"] == nchunks
              and sum(launches.values()) == nchunks,
              f"FP {pol}: launches {launches}, expected {nchunks}")
        regs = state["regs"].cpu().tolist()
        check(res.hits == hits_pin and regs == regs_pin
              and digest(state) == digest_pin
              and int(flags[F_WARMUP:].sum()) == hits_pin,
              f"FP {pol}: hits {res.hits} regs {regs} digest "
              f"{digest(state)} != JAX {hits_pin} {regs_pin} {digest_pin}")
        check(res.policy == f"{pol}(device)" and res.extra["policy"] == pol,
              f"FP {pol}: label {res.policy} extra {res.extra}")
        rates[pol] = n / wall
        print(f"phase 29 FP {pol}: C={F_CAPACITY} assoc={F_ASSOC} window_frac"
              f" {PANEL_FRACS[pol]} hits {res.hits}/{res.accesses} ratio "
              f"{res.hit_ratio:.6f} (F {F_HITS / res.accesses:.6f}); regs, "
              f"digest and hit flags == JAX; wall {wall:.3f} s, "
              f"{n / wall:,.0f} acc/s (F {f_wall:.3f} s, {n / f_wall:,.0f}); "
              f"{launches['sketch_step']} launches; card {card}")
        cfg = DeviceWTinyLFU(F_CAPACITY, **kw)
        t_state, t_hits, step_ms, stream_ms, _ = timed_launches(
            f_trace, cfg, F_CHUNK, F_WARMUP)
        check(digest(t_state) == digest_pin
              and bool(torch.equal(t_hits, flags)),
              f"FP {pol}: the timed run differs from the main run")
        ms = sum(step_ms) / len(step_ms)
        ns = ms * 1e6 / F_CHUNK
        idle = 1.0 - sum(step_ms) / stream_ms
        total, resets, _ = bound_bytes(cfg.spec(), f_trace, F_CHUNK,
                                       cfg.sample_size)
        bound_ms = total / nchunks / HBM_BYTES_PER_S * 1e3
        print(f"phase 29 FP {pol}: kernel {ms:.4f} ms per launch (CUDA "
              f"events around each of {len(step_ms)}; min {min(step_ms):.4f}"
              f", max {max(step_ms):.4f}), {ns:.0f} ns per access "
              f"({ns / f_ns:.3f}x F's {f_ns:.0f}); runner stream "
              f"{stream_ms:.1f} ms, device idle share {idle:.6f}; bound "
              f"{total} bytes over the run ({resets} resets) = "
              f"{total / nchunks:.0f} bytes per launch over 3.35 TB/s = "
              f"{bound_ms:.6f} ms (the kernel is {ms / bound_ms:.0f}x above "
              f"it)")
        out[pol] = (launches["sketch_step"], ms, bound_ms)
        del state, flags, t_state, t_hits
    worst = min(PANEL_POLICIES, key=lambda p: rates[p])
    print(f"phase 29 FP: slowest competitor vs w-tinylfu (acc/s of wall, "
          f"the reference's arm 8): {worst} "
          f"{rates[worst] / (n / f_wall):.3f}x of F's; card {card}")
    return out


def gp_phase30(zipf, scanhot, card):
    """Phase 30: run GP, the reference's golden panel: all four policies on
    the golden Zipf (C=200), scan-then-hotspot (C=400) and the golden Zipf
    at C=1,000 with sample_factor=16 and 8-bit counters; every run's hits
    must equal the JAX pins, the first two runs' hit ratios lie within
    GP_TOL of the reference's goldens, and at C=1,000 W-TinyLFU must be at
    least as good as every competitor.  Then the reference benchmark's own
    point: the four policies at C=8,192 on the golden Zipf (best of two
    walls)."""
    from repro_torch.core.device_simulate import simulate_trace
    traces = {"zipf": zipf, "scanhot": scanhot}
    for g, (tr, cap, warmup, kw) in enumerate(GP_RUNS):
        got = {pol: simulate_trace(traces[tr], cap, assoc=8, policy=pol,
                                   window_frac=PANEL_FRACS[pol],
                                   warmup=warmup, **kw)
               for pol in PANEL_FRACS}
        hits = {pol: r.hits for pol, r in got.items()}
        check(hits == GP_PINS[g], f"GP {tr} C={cap}: hits {hits} != JAX "
              f"{GP_PINS[g]}")
        ratios = {pol: r.hit_ratio for pol, r in got.items()}
        if g < len(GP_GOLDENS):
            check(all(abs(ratios[p] - v) < GP_TOL
                      for p, v in GP_GOLDENS[g].items()),
                  f"GP {tr} C={cap}: ratios {ratios} not within {GP_TOL} of "
                  f"{GP_GOLDENS[g]}")
        else:
            check(all(ratios["wtinylfu"] >= ratios[p]
                      for p in PANEL_POLICIES),
                  f"GP {tr} C={cap}: W-TinyLFU {ratios} is beaten")
        print(f"phase 30 GP {tr} C={cap} {kw or ''}: hits {hits} == JAX; "
              "ratios " + ", ".join(f"{p} {v:.4f}" for p, v in ratios.items())
              + ("; W-TinyLFU >= every competitor" if g == 2 else
                 f" within {GP_TOL} of the goldens"))
    rates = {}
    for pol in PANEL_FRACS:
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            simulate_trace(zipf, GP_REF_CAPACITY, assoc=8, policy=pol,
                           window_frac=PANEL_FRACS[pol])
            walls.append(time.perf_counter() - t0)
        rates[pol] = len(zipf) / min(walls)
    print(f"phase 30 GP C={GP_REF_CAPACITY} (the reference benchmark's "
          f"point, {len(zipf)} accesses, best of 2 walls): "
          + ", ".join(f"{p} {v:,.0f} acc/s" for p, v in rates.items())
          + f"; slowest competitor vs w-tinylfu "
          f"{min(rates[p] for p in PANEL_POLICIES) / rates['wtinylfu']:.3f}x;"
          f" card {card}")


def wp_phase31(f_trace, card):
    """Phase 31: run WP, policy sweeps over F's trace: all four policies at
    65,536 (window_frac 0.1) with mode "auto", which must resolve to
    sequential, its competitor rows FP's and its W-TinyLFU row the JAX pin;
    ARC at WP_ARC_CAPS as three lanes (mode="vmap", counts set to 0 around
    it: one launch per chunk) and one run after another, the sequential
    65,536 row FP's ARC and two lane rows equal to solo runs of their padded
    configuration; a multi-policy mode="vmap" raises the reference's
    ValueError.  Returns (lane wall, sequential wall)."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  _padded_grid, _trace_lanes,
                                                  run_chunks, simulate_sweep)
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.kernels.sketch_common import POLICIES
    kw = dict(assoc=F_ASSOC, warmup=F_WARMUP, chunk=F_CHUNK,
              trace_name="zipf-1.2M")
    rows = simulate_sweep(f_trace, [F_CAPACITY], policies=POLICIES,
                          window_fracs=(0.1,), **kw)
    got = {r.extra.get("policy", "wtinylfu"): r.hits for r in rows}
    want = {p: FP_PINS[p][0] for p in PANEL_POLICIES}
    check(got == {"wtinylfu": WP_WTINYLFU_HITS, **want}
          and all(r.extra["backend"] == "cuda+sequential" for r in rows),
          f"WP: rows {got} ({rows[0].extra['backend']}) != FP's and the "
          f"W-TinyLFU pin {WP_WTINYLFU_HITS}")
    print(f"phase 31 WP policies: rows {got} == FP's and the JAX W-TinyLFU "
          f"pin (auto -> sequential, {rows[0].extra['grid_wall_s']:.3f} s "
          f"for the grid)")
    try:
        simulate_sweep(f_trace[:10], [64], policies=("wtinylfu", "lfu"),
                       assoc=8, mode="vmap")
        check(False, "WP: a multi-policy vmap sweep did not raise")
    except ValueError as e:
        check("use mode='sequential'" in str(e), f"WP: raised {e}")
    akw = dict(kw, policies=("arc",))
    set_launches(0)
    lanes = simulate_sweep(f_trace, WP_ARC_CAPS, mode="vmap", **akw)
    launches = read_launches()
    nchunks = math.ceil(len(f_trace) / F_CHUNK)
    check(launches["sketch_step"] == nchunks
          and sum(launches.values()) == nchunks,
          f"WP arc lanes: launches {launches}, expected {nchunks}")
    seq = simulate_sweep(f_trace, WP_ARC_CAPS, mode="sequential", **akw)
    caps = [r.cache_size for r in seq]
    check(seq[caps.index(F_CAPACITY)].hits == FP_PINS["arc"][0],
          "WP: the sequential 65,536 ARC row differs from FP's")
    grid = [DeviceWTinyLFU(C, assoc=F_ASSOC, policy="arc")
            for C in WP_ARC_CAPS]
    spec, states = _padded_grid(grid, "cuda")
    lo, hi = _trace_lanes(f_trace, "cuda")
    for g in (0, 2):
        st, _ = run_chunks(spec, grid[g].params(warmup=F_WARMUP,
                                                device="cuda"),
                           states[g], lo, hi, F_CHUNK)
        check(int(st["regs"][ks.R_HITS]) == lanes[g].hits,
              f"WP: the lane row {WP_ARC_CAPS[g]} differs from its padded "
              f"solo run")
    wl, ws = lanes[0].extra["grid_wall_s"], seq[0].extra["grid_wall_s"]
    print(f"phase 31 WP arc: " + ", ".join(
        f"C={v.cache_size} lanes {v.hits} sequential {s_.hits}"
        for v, s_ in zip(lanes, seq))
        + f"; the sequential 65,536 row == FP's arc, lane rows "
          f"{WP_ARC_CAPS[0]} and {WP_ARC_CAPS[2]} == their padded solo runs;"
          f" three lanes {wl:.3f} s of wall ({launches['sketch_step']} "
          f"launches), three runs one after another {ws:.3f} s "
          f"({ws / wl:.2f}x); card {card}")
    del states
    torch.cuda.empty_cache()
    return wl, ws


CKPT_WORKDIR = ROOT / "build"          # checkpoints go under build/
KILL_SCRIPT = r"""
import sys
sys.path.insert(0, %(src)r)
for m in ("jax", "jaxlib", "repro"):
    sys.modules[m] = None
from repro_torch.core.device_simulate import DeviceWTinyLFU
from repro_torch.traces.synthetic import zipf_trace

tr = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
cfg = DeviceWTinyLFU(%(cap)d, assoc=%(assoc)d, shards=%(shards)d)
cfg.run(tr, warmup=%(warmup)d, checkpoint_dir=%(dir)r, checkpoint_every=%(every)d,
        on_checkpoint=lambda c: print("CKPT", c, flush=True))
print("DONE", flush=True)
"""
KILL_EVERY = 32_768             # 8 of F4's merge epochs
KILL_AFTER = 3


def hold_f_pins(name, res, state, flags, pins):
    """Hits, registers, digest and hit flags (and, adaptive, the final
    quota and trajectory) of a run at F's trace against its JAX pins."""
    hits, regs_pin, dig, quota, traj = pins
    regs = state["regs"].cpu().tolist()
    check(res.hits == hits and regs == regs_pin and digest(state) == dig
          and int(flags[F_WARMUP:].sum()) == hits
          and flags.shape[0] == F_ACCESSES,
          f"{name}: hits {res.hits} regs {regs} digest {digest(state)} != "
          f"JAX {hits} {regs_pin} {dig}")
    if quota is not None:
        t = res.extra["trajectory"]
        check(res.extra["final_quota"] == quota
              and len(t["quota"]) == traj[0]
              and trajectory_digest(t) == traj[1],
              f"{name}: quota {res.extra['final_quota']}, trajectory "
              f"{trajectory_digest(t)} != JAX {quota} {traj}")


def prune_to_first(d: Path) -> int:
    """Delete every checkpoint in ``d`` but the earliest; returns its
    step."""
    import shutil
    kept = sorted(x for x in d.iterdir() if not x.name.endswith(".tmp"))
    check(len(kept) >= 2, f"{d}: {len(kept)} checkpoints, expected >= 2")
    for x in kept[1:]:
        shutil.rmtree(x)
    return int(kept[0].name[5:])


def ckpt_phase32(f_trace, card, work):
    """Phase 32: F, F4 and FA through ``cfg.run(..., checkpoint_dir=)`` at
    the auto cadence (32,768 accesses: 37 saves) on the card, between plain
    runs; every run holds its JAX pins and launches as many step kernels as
    the plain run; then each resumes from the earliest checkpoint that
    pruning kept and holds them again.  Prints the walls, their ratio (the
    reference's checkpoint_overhead_vs_plain), each save's time on the
    host (the join of the previous write and the copy to host memory) and
    a checkpoint's bytes.  Returns {name: {saves, overhead_vs_plain,
    save_ms, bytes}}."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.core.device_simulate import (ClimbSpec, DeviceWTinyLFU,
                                                  resume_trace)
    from repro_torch.kernels import sketch_step as ks
    runs = [("F", {}, (F_HITS, F_REGS, F_DIGEST, None, None)),
            ("F4", dict(shards=SHARDS),
             (F4_HITS, F4_REGS, F4_DIGEST, None, None)),
            ("FA", dict(adaptive=True),
             (FA_HITS, FA_REGS, FA_DIGEST, FA_QUOTA, FA_TRAJ))]
    save = store.AsyncCheckpointer.save
    out = {}
    for name, kw, pins in runs:
        cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, **kw)
        walls = {"plain": [], "checkpointed": []}
        launches, save_ms, saves = set(), [], []
        for i, kind in enumerate(("plain", "checkpointed", "checkpointed",
                                  "plain")):
            d = work / f"{name}-{i}"
            extra = ({"checkpoint_dir": str(d),
                      "on_checkpoint": saves.append}
                     if kind == "checkpointed" else {})
            if i == 2:            # time each save on the host
                def timed(self, *a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    save(self, *a, **k)
                    save_ms.append((time.perf_counter() - t0) * 1e3)
                store.AsyncCheckpointer.save = timed
            torch.cuda.synchronize()
            ks.step.launches = 0
            t0 = time.perf_counter()
            try:
                res, state, flags = cfg.run(
                    f_trace, warmup=F_WARMUP, chunk=F_CHUNK,
                    climb=ClimbSpec(), trace_name="zipf-1.2M",
                    return_state=True, **extra)
                torch.cuda.synchronize()
            finally:
                store.AsyncCheckpointer.save = save
            walls[kind].append(time.perf_counter() - t0)
            launches.add(ks.step.launches)
            hold_f_pins(f"{name} {kind}", res, state, flags, pins)
            if kind == "checkpointed":
                every, ckdir = res.extra["checkpoint_every"], d
        check(len(launches) == 1, f"{name}: step launches {launches} differ "
              "between the plain and checkpointed runs")
        n_saves = len(saves) // 2
        check(every == 32_768 and n_saves == -(-F_ACCESSES // every)
              and saves[:n_saves] == saves[n_saves:],
              f"{name}: cadence {every}, saves {saves}")
        last = ckdir / f"step_{F_ACCESSES:010d}"
        nbytes = sum(x.stat().st_size for x in last.iterdir())
        state_bytes = sum(v.numel() * 4 for v in state.values())
        cursor = prune_to_first(ckdir)
        ks.step.launches = 0
        res, state, flags = resume_trace(
            f_trace, cfg, checkpoint_dir=str(ckdir), warmup=F_WARMUP,
            chunk=F_CHUNK, climb=ClimbSpec(), return_state=True)
        check(res.extra["resumed_at"] == cursor and ks.step.launches > 0,
              f"{name}: resumed at {res.extra['resumed_at']} != {cursor}")
        hold_f_pins(f"{name} resumed", res, state, flags, pins)
        ratio = statistics.mean(walls["checkpointed"]) / statistics.mean(
            walls["plain"])
        print(f"phase 32 {name}: checkpointed every {every} accesses "
              f"({n_saves} saves a run) and resumed from {cursor} "
              f"({F_ACCESSES - cursor} accesses): hits, regs, digest"
              f"{', quota, trajectory' if kw.get('adaptive') else ''} == "
              f"JAX; step launches {launches.pop()} as plain")
        print(f"phase 32 {name}: wall plain "
              + ", ".join(f"{w:.3f}" for w in walls["plain"])
              + " s, checkpointed " + ", ".join(
                  f"{w:.3f}" for w in walls["checkpointed"])
              + f" s (host clock, in turns): checkpoint_overhead_vs_plain "
              f"{ratio:.4f}; save() on the host after a synchronize "
              f"{statistics.mean(save_ms):.2f} ms mean, "
              f"{max(save_ms):.2f} max over {len(save_ms)}; one checkpoint "
              f"{nbytes} bytes on disk (state {state_bytes}, hit flags "
              f"{F_ACCESSES * 4}); card {card}")
        out[name] = {"saves": n_saves, "overhead_vs_plain": ratio,
                     "save_ms": statistics.mean(save_ms), "bytes": nbytes}
    return out


def kill_phase33(f_trace, card, work):
    """Phase 33: the SIGKILL drill.  A script that imports only repro_torch
    drives F4 on the card with checkpoint_every=KILL_EVERY, printing a
    marker per checkpoint; ``faults.run_to_kill`` kills it after KILL_AFTER
    markers; the parent resumes on the card from the latest durable
    checkpoint and must hold F4's pins."""
    import signal
    from repro_torch.checkpoint.store import latest_step
    from repro_torch.core import faults
    from repro_torch.core.device_simulate import DeviceWTinyLFU, resume_trace
    d = work / "kill"
    t0 = time.perf_counter()
    seen, rc = faults.run_to_kill(
        KILL_SCRIPT % dict(src=str(ROOT / "src"), cap=F_CAPACITY,
                           assoc=F_ASSOC, shards=SHARDS, warmup=F_WARMUP,
                           dir=str(d), every=KILL_EVERY),
        kills=KILL_AFTER, timeout=300)
    child = time.perf_counter() - t0
    step = latest_step(str(d))
    check(seen == KILL_AFTER and rc == -signal.SIGKILL,
          f"kill drill: {seen} markers, rc {rc}")
    check(step is not None and 0 < step < F_ACCESSES
          and step % KILL_EVERY == 0, f"kill drill: latest step {step}")
    cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, shards=SHARDS)
    res, state, flags = resume_trace(
        f_trace, cfg, checkpoint_dir=str(d), warmup=F_WARMUP,
        checkpoint_every=KILL_EVERY, return_state=True)
    check(res.extra["resumed_at"] == step,
          f"kill drill: resumed at {res.extra['resumed_at']} != {step}")
    hold_f_pins("F4 killed and resumed", res, state, flags,
                (F4_HITS, F4_REGS, F4_DIGEST, None, None))
    print(f"phase 33 kill drill: F4 in a child process killed after "
          f"{seen} checkpoint markers (rc {rc}, {child:.1f} s with its start "
          f"on the card); resumed on the card at latest_step {step}: hits, "
          f"regs, digest == F4's JAX pins")
    return True


def fault_phase34(card):
    """Phase 34: the reference's fault drills at their own sizes on the
    card (check_runs.FD_DRILLS): each run under its hook must equal the JAX
    engine's run under the same hook (hits, state digest), and the
    reference's own bounds must hold."""
    from repro_torch.core import faults
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  simulate_trace)
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.traces.synthetic import zipf_trace
    for name, (tkw, cap, kw, warmup, every) in FD_DRILLS.items():
        tr = zipf_trace(**tkw)
        cfg = DeviceWTinyLFU(cap, **kw)
        ks.step.launches = 0
        res, state, flags = cfg.run(
            tr, warmup=warmup, checkpoint_every=every, return_state=True,
            fault_hook=fd_hook(name, faults, cfg.spec()))
        check(ks.step.launches > 0, f"drill {name}: no step launch")
        clean, _, flags0 = simulate_trace(tr, cap, warmup=warmup,
                                          return_state=True, **kw)
        pin = FD_PINS[name]
        check((res.hits, digest(state)) == pin,
              f"drill {name}: hits {res.hits} digest {digest(state)} != JAX "
              f"{pin}")
        also = ""
        if name in FD_FLIP_BOUNDED:
            check(abs(res.hit_ratio - clean.hit_ratio) < FD_FLIP_TOL,
                  f"drill {name}: {res.hit_ratio} vs {clean.hit_ratio}")
        elif name in ("quarantine", "loss"):
            check(abs(res.hit_ratio - FD_GOLDEN) < GP_TOL,
                  f"drill {name}: hit ratio {res.hit_ratio}")
        if name == "quarantine":
            csum = int(state["csum"][-1])
            tails = [float(f[-FD_TAIL:].float().mean()) for f in (flags,
                                                                 flags0)]
            check(csum == 1 and abs(tails[0] - tails[1]) < GP_TOL,
                  f"drill quarantine: csum {csum}, tails {tails}")
            also = (f", csum count {csum}, last {FD_TAIL} accesses "
                    f"{tails[0]:.6f} vs {tails[1]:.6f} without the flip")
        print(f"phase 34 drill {name}: {len(tr)} accesses C={cap} {kw}: "
              f"hits {res.hits}, digest == JAX under the same hook; hit "
              f"ratio {res.hit_ratio:.6f} (without the fault "
              f"{clean.hit_ratio:.6f}){also}")
    return True


def cross_phase35(card, work):
    """Phase 35: a checkpoint written on the CPU (the plain version)
    resumes on the card, and one written on the card resumes on the CPU;
    both equal the card's uninterrupted run."""
    import torch
    from repro_torch.core.device_simulate import DeviceWTinyLFU, resume_trace
    from repro_torch.traces.synthetic import zipf_trace
    tr = zipf_trace(6_000, n_items=2_000, alpha=0.9, seed=4)
    cfg = DeviceWTinyLFU(300, shards=4, merge_every=512)
    kw = dict(warmup=1_000, checkpoint_every=2_048, return_state=True)
    want = cfg.run(tr, warmup=1_000, return_state=True)
    for writer, reader in (("cpu", "cuda"), ("cuda", "cpu")):
        d = work / f"cross-{writer}"
        cfg.run(tr, checkpoint_dir=str(d), device=writer, **kw)
        cursor = prune_to_first(d)
        res, state, flags = resume_trace(tr, cfg, checkpoint_dir=str(d),
                                         device=reader, **kw)
        check(res.extra["resumed_at"] == cursor and res.hits == want[0].hits
              and torch.equal(flags.cpu(), want[2].cpu())
              and all(torch.equal(state[k].cpu(), want[1][k].cpu())
                      for k in state),
              f"cross-device resume {writer} -> {reader} differs")
        print(f"phase 35 written on {writer}, resumed on {reader} from "
              f"{cursor}: hits {res.hits}, hit flags and every state leaf == "
              "the card's uninterrupted run")
    return True


def step12_phase36(card):
    """Phase 36: the step kernel's stale mesh instances (kernel mode 1e),
    wide instances and exact path against step_ref over
    check_runs.STEP12_CASES (run_step_case: the same chunks, folds,
    rebalances and flips through each); every state leaf and hit flag must
    be equal.  The plain version runs on the host's CPU, in the pool,
    while the kernel runs the cases here.  Returns (max abs difference, one
    row per case: kernel and plain ms per launch and the kernel's ns per
    access)."""
    err, rows = 0, []
    jobs = [submit_plain(run_step_case, case) for case in STEP12_CASES]
    for case, job in zip(STEP12_CASES, jobs):
        err = max(err, step12_case(case, job, card, rows))
    return err, rows


def step12_case(case, job, card, rows):
    """One phase 36 case: the kernel's run here against the plain version's
    (``job``, a worker's); appends the case's row and returns its max abs
    difference."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    events = []

    def timed(spec, params, state, lo, hi, n_valid=None, probes=None,
              rank=0):
        if probes is None:              # the keys hashed outside the events
            probes = ks.precompute_probes(spec, lo, hi)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = ks.step(spec, params, state, lo, hi, n_valid, probes,
                      rank=rank)
        e1.record()
        events.append((e0, e1))
        return out
    got = run_step_case(case, timed, "cuda")
    torch.cuda.synchronize()
    *want, plain_s = job.result()
    plain_ms = plain_s * 1e3 / len(events)
    diff = max([int(np.abs(got[1] - want[1]).max())]
               + [int(np.abs(got[0][k].astype(np.int64)
                             - want[0][k].astype(np.int64)).max())
                  for k in want[0]])
    check(diff == 0, f"phase 36 {case[0]}: kernel != plain (max abs "
          f"difference {diff})")
    # the fastest launch: an instance's first launch also loads it
    ms = min(a.elapsed_time(b) for a, b in events)
    rows.append({"case": case[0], "launches": len(events), "ms": ms,
                 "plain_ms": plain_ms, "ns_per_access": ms * 1e6 / case[7]})
    print(f"phase 36 {case[0]}: kernel == plain, every leaf and hit flag; "
          f"kernel {ms:.4f} ms per launch of {case[7]} accesses, the "
          f"fastest of {len(events)} ({ms * 1e6 / case[7]:,.0f} ns per "
          f"access), plain {plain_ms:.1f} ms per launch (one CPU thread of "
          f"a worker process, host clock); card {card}")
    return diff


def gloo_rank_phase37(rank, n):
    """A rank of phase 37's gloo group on the shared card: F4's first n
    accesses in stale mode on its mesh; returns (hits, digest)."""
    from repro_torch.core.device_simulate import simulate_trace
    from repro_torch.distributed.mesh import make_shard_mesh
    from repro_torch.traces.synthetic import zipf_trace
    tr = zipf_trace(F_ACCESSES, n_items=1_000_000, alpha=0.9, seed=11)[:n]
    mesh = make_shard_mesh(SHARDS, device="cuda")
    res, st, _ = simulate_trace(tr, F_CAPACITY, warmup=0, assoc=F_ASSOC,
                                shards=SHARDS, mesh=mesh,
                                mesh_exchange="stale", return_state=True)
    return res.hits, digest(st)


MESH_GLOO_ACCESSES = 262_144


def mesh_phase37(f_trace, card, f4_ms, f4_bound_ms):
    """Phase 37: the mesh at F4's geometry on a one-rank NCCL group: chunk
    mode equals F4's JAX pins, stale mode (kernel mode 1e) F4S_PINS, with
    the launch and fold counts set to 0 just before and read just after;
    the stale run timed per launch and per gather-and-fold against F4's
    sharded kernel, and its bound (F4's, phase 20: the same words, the
    estimates reading one half of them); then two ranks over gloo sharing
    the card.  Returns
    (launches, ms per launch, bound ms per launch, fold ms, NCCL start-up
    s)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  simulate_trace)
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.distributed.mesh import make_shard_mesh
    from repro_torch.kernels.sketch_merge import merge_halve
    n = len(f_trace)
    nep, nfold = -(-n // F4_EPOCH), n // F4_EPOCH
    CKPT_WORKDIR.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh-", dir=CKPT_WORKDIR)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(
        f"{work}/store", 1), rank=0, world_size=1)
    try:
        mesh = make_shard_mesh(SHARDS)
        mesh.all_gather(torch.zeros(1, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        check(mesh.size == 1 and mesh.device.type == "cuda",
              f"phase 37 mesh {mesh}")
        print(f"phase 37 NCCL one-rank group: init and first all_gather "
              f"{start_s:.3f} s; {mesh}")
        kw = dict(warmup=F_WARMUP, assoc=F_ASSOC, shards=SHARDS, mesh=mesh,
                  trace_name="zipf-1.2M", return_state=True)
        out = {}
        for exchange, pins in (("chunk", (F4_HITS, F4_REGS, F4_DIGEST)),
                               ("stale", F4S_PINS)):
            torch.cuda.synchronize()
            set_launches(0)
            merge_halve.folds = 0
            t0 = time.perf_counter()
            res, state, flags = simulate_trace(f_trace, F_CAPACITY,
                                               mesh_exchange=exchange, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, folds = read_launches(), merge_halve.folds
            check(launches["sketch_step"] == nep
                  and sum(launches.values()) == nep and folds == nfold,
                  f"phase 37 {exchange}: launches {launches}, folds {folds}")
            regs = state["regs"].cpu().tolist()
            got = (res.hits, regs, digest(state))
            check(got == tuple(pins) and int(flags[F_WARMUP:].sum())
                  == res.hits, f"phase 37 {exchange}: {got} != JAX {pins}")
            check(res.extra["mesh_devices"] == 1
                  and res.extra["mesh_exchange"] == exchange,
                  f"phase 37 {exchange}: extra {res.extra}")
            out[exchange] = (launches["sketch_step"], res)
            print(f"phase 37 F4 on the mesh, {exchange}: hits {res.hits}/"
                  f"{res.accesses} ratio {res.hit_ratio:.6f}, regs and "
                  f"digest == JAX; {launches['sketch_step']} launches, "
                  f"{folds} folds; wall {wall:.3f} s, {n / wall:,.0f} acc/s "
                  f"(host clock); card {card}")
        cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, shards=SHARDS,
                             mesh=mesh, mesh_exchange="stale")
        t_state, t_hits, step_ms, stream_ms, fold_ms = timed_launches(
            f_trace, cfg, None, F_WARMUP)
        check(int(t_state["regs"][3]) == F4S_PINS[0],
              "phase 37: the timed stale run differs from the main run")
        ms = sum(step_ms) / len(step_ms)
        fold = sum(fold_ms) / len(fold_ms)
        idle = 1.0 - (sum(step_ms) + sum(fold_ms)) / stream_ms
        ns = ms * 1e6 / F4_EPOCH
        bound_ms = f4_bound_ms
        print(f"phase 37 stale (mode 1e): kernel {ms:.4f} ms per launch "
              f"(CUDA events around each of {len(step_ms)}), {ns:.0f} ns per "
              f"access ({ms / f4_ms:.3f}x F4's sharded kernel, phase 20); "
              f"merge_halve_mesh {fold:.4f} ms per epoch (gather, reorder "
              f"and fold; {len(fold_ms)}), {sum(fold_ms) / stream_ms:.4f} of "
              f"the runner's stream {stream_ms:.1f} ms; device idle share "
              f"{idle:.6f}; bound {bound_ms:.6f} ms per launch (F4's words, "
              f"bytes; the kernel {ms / bound_ms:.0f}x above it); card "
              f"{card}")
    finally:
        dist.destroy_process_group()
    m = MESH_GLOO_ACCESSES
    one = simulate_trace(f_trace[:m], F_CAPACITY, warmup=0, assoc=F_ASSOC,
                         shards=SHARDS, mesh=make_shard_mesh(SHARDS),
                         mesh_exchange="stale", return_state=True)
    t0 = time.perf_counter()
    two = run_ranks(gloo_rank_phase37, 2, f"{work}/gloo", m, timeout=300)
    want = (one[0].hits, digest(one[1]))
    check(all(tuple(r) == want for r in two),
          f"phase 37 gloo, two ranks on the card: {two} != one rank {want}")
    print(f"phase 37 two ranks over gloo with CUDA tensors on the one card "
          f"(stale, F4's first {m:,} accesses): both ranks' hits and digest "
          f"== the one-rank run {want}; {time.perf_counter() - t0:.1f} s "
          f"with the ranks' start-up")
    return out["stale"][0], ms, bound_ms, fold, start_s


def pf_phase38(card):
    """Phase 38: PF, the paper's trace families at their scripts' full
    sizes.  The host engine's runs (W-TinyLFU flat and at PF_ASSOC ways on
    every cell, the cast on PF_CAST_CELL) go to the pool of CPU worker
    processes first; meanwhile each cell runs on the card through
    ``simulate_trace`` at PF_ASSOC ways and on the flat tables (counts set
    to 0 just before each run, read just after), held to the JAX pins, and
    again with CUDA events around each launch.  Then the host runs are held
    to the reference host engine's pins and the device's hit ratios to the
    reference's host-vs-device bands."""
    import torch
    from repro_torch.core.device_simulate import DeviceWTinyLFU, simulate_trace
    from repro_torch.kernels import sketch_step as ks
    t_phase = time.perf_counter()
    assocs = (PF_ASSOC, None)
    order = sorted(PF_CELLS, key=lambda c: -PF_CELLS[c][2] * PF_CELLS[c][3])
    jobs = {(c, a): cpu_pool().submit(pf_host_run, c, a)
            for a in assocs for c in order}
    jobs.update({n: cpu_pool().submit(pf_host_run, PF_CAST_CELL, n)
                 for n in PF_CAST if n != "W-TinyLFU"})
    dev = {}
    for cell, (gen, kw, cap, sf, _) in PF_CELLS.items():
        t0 = time.perf_counter()
        tr = pf_trace(cell)
        sha = trace_sha256(tr)
        check(sha == PF_TRACE_SHA256[cell],
              f"{cell}: trace sha256 {sha} != the reference's")
        print(f"phase 38 {cell}: {gen}({kw}) generated in "
              f"{time.perf_counter() - t0:.2f} s, sha256 == the reference's")
        warmup = pf_warmup(cell, tr)
        nchunks = math.ceil(len(tr) / F_CHUNK)
        for assoc in assocs:
            torch.cuda.synchronize()
            ks.step.launches = 0
            t0 = time.perf_counter()
            res, state, flags = simulate_trace(
                tr, cap, sample_factor=sf, warmup=warmup, assoc=assoc,
                chunk=F_CHUNK, trace_name=cell, return_state=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ks.step.launches
            hits, regs, dig = PF_PINS[(cell, assoc)]
            name = f"{cell} {'flat' if assoc is None else f'{assoc} ways'}"
            check(launches == nchunks,
                  f"{name}: {launches} kernel launches, expected {nchunks}")
            got = state["regs"].cpu().tolist()
            check(res.hits == hits, f"{name}: hits {res.hits} != JAX {hits}")
            check(got == regs, f"{name}: regs {got} != JAX {regs}")
            check(digest(state) == dig,
                  f"{name}: state digest {digest(state)} != JAX {dig}")
            check(int(flags[warmup:].sum()) == hits,
                  f"{name}: hit flags disagree with the hit register")
            cfg = DeviceWTinyLFU(cap, sample_factor=sf, assoc=assoc)
            t_state, t_flags, step_ms, stream_ms, _ = timed_launches(
                tr, cfg, F_CHUNK, warmup)
            check(digest(t_state) == dig and bool((t_flags == flags).all()),
                  f"{name}: the timed run differs from the main run")
            ms = sum(step_ms) / len(step_ms)
            idle = 1.0 - sum(step_ms) / stream_ms
            bound = None
            if assoc is not None:
                total, _, size = bound_bytes(cfg.spec(), tr, F_CHUNK,
                                             cfg.sample_size)
                check(size == regs[0], f"{name}: reset model ends at size "
                      f"{size}, the kernel at {regs[0]}")
                bound = total / nchunks / HBM_BYTES_PER_S * 1e3
            dev[(cell, assoc)] = res
            where = ("" if bound is None else
                     f"; bound {bound:.6f} ms per launch (bytes), kernel "
                     f"{ms / bound:.0f}x above it")
            print(f"phase 38 {name}: C={cap} W={cfg.sample_size} hits "
                  f"{res.hits}/{res.accesses} ratio {res.hit_ratio:.6f}, "
                  f"regs and digest == JAX; wall {wall:.3f} s, "
                  f"{len(tr) / wall:,.0f} acc/s (host clock around "
                  f"simulate_trace); launches {launches}; kernel {ms:.4f} ms "
                  f"per launch ({ms * 1e6 / F_CHUNK:.0f} ns/access; CUDA "
                  f"events around each launch), device idle share "
                  f"{idle:.6f}{where}; card {card}")
        del tr
    t_dev = time.perf_counter() - t_phase
    host = {}
    for key in [(c, a) for c in PF_CELLS for a in assocs]:
        cell, assoc = key
        hits, acc, secs = jobs[key].result()
        host[key] = hits / acc
        check(hits == PF_HOST_PINS[key],
              f"{cell} host assoc={assoc}: hits {hits} != the reference "
              f"host engine's {PF_HOST_PINS[key]}")
        d = dev[key].hit_ratio
        check(abs(d - host[key]) <= PF_TOL[assoc],
              f"{cell} assoc={assoc}: device {d:.6f} vs host "
              f"{host[key]:.6f} outside ±{PF_TOL[assoc]}")
        print(f"phase 38 {cell} host WTinyLFU assoc={assoc}: hits {hits}/"
              f"{acc} == the reference host engine's, ratio "
              f"{host[key]:.6f}; device {d:.6f} (|diff| "
              f"{abs(d - host[key]):.6f} <= {PF_TOL[assoc]}); "
              f"{secs:.1f} s on one CPU worker, {acc / secs:,.0f} counted "
              f"acc/s")
    for cell in PF_CELLS:
        d = dev[(cell, PF_ASSOC)].hit_ratio
        check(abs(d - host[(cell, None)]) <= PF_TOL[PF_ASSOC],
              f"{cell}: {PF_ASSOC}-way device {d:.6f} vs the exact host "
              f"{host[(cell, None)]:.6f} outside ±{PF_TOL[PF_ASSOC]}")
    ratios = {}
    for name in PF_CAST:
        if name == "W-TinyLFU":
            hits, acc, secs = jobs[(PF_CAST_CELL, None)].result()
        else:
            hits, acc, secs = jobs[name].result()
        check(hits == PF_CAST_PINS[name],
              f"{PF_CAST_CELL} {name}: hits {hits} != the reference's "
              f"{PF_CAST_PINS[name]}")
        ratios[name] = hits / acc
        print(f"phase 38 {PF_CAST_CELL} cast {name}: hits {hits}/{acc} == "
              f"the reference's, ratio {ratios[name]:.6f} ({secs:.1f} s)")
    best = max(ratios, key=ratios.get)
    spent = time.perf_counter() - t_phase
    print(f"phase 38 {PF_CAST_CELL} cast, best first: " + ", ".join(
        f"{n} {ratios[n]:.6f}" for n in sorted(ratios, key=ratios.get,
                                               reverse=True))
          + f" (best {best}); phase 38 {spent:.1f} s (card runs "
          f"{t_dev:.1f} s, the host runs beside them)")


FAM_ARCHS = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
             "llava-next-34b", "musicgen-medium", "zamba2-1.2b", "xlstm-1.3b")
FAM_TOL = 0.05      # bf16: the reference's bound, or 1.5x the distance of
                    # the CPU's own bf16 run from its fp32 run, if larger


def fam_drive(cfg, params, device, toks, vis):
    """The families' drive: prefill 21 tokens (after the vision
    embeddings), three decodes; then from a fresh cache prefill 16, extend
    12.  Returns the outputs as fp32 CPU tensors."""
    import torch
    from repro_torch.models import Model
    from repro_torch.serve.extend import extend
    m = Model(cfg, device=device)
    t = torch.from_numpy(toks).to(device)
    batch = {"tokens": t[:, :21]}
    if vis is not None:
        batch["vision_embeds"] = torch.from_numpy(vis).to(device)
    out = []
    cache, h = m.prefill(params, batch, m.init_cache(2, 64))
    out.append(h)
    for i in range(21, 24):
        lg, cache = m.decode(params, t[:, i:i + 1], cache)
        out.append(lg)
    cache, _ = m.prefill(params, dict(batch, tokens=t[:, :16]),
                         m.init_cache(2, 64))
    cache, h = extend(m, params, t[:, 16:28], cache, 16 + cfg.n_vis_tokens)
    out.append(h)
    lg, cache = m.decode(params, t[:, 28:29], cache)
    out.append(lg)
    return [o.float().cpu() for o in out]


def fam_phase39(card):
    """Phase 39: each new family's smoke config in bf16 through
    Model.prefill (llava with 8 vision embeddings), three decodes and an
    extend after a cached prefix, on the card against the same model and
    weights on the CPU (the plain versions)."""
    import torch
    from repro_torch.check_runs import numpy_params
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_numpy
    names = ("prefill", "decode 1", "decode 2", "decode 3", "extend",
             "decode after extend")
    for arch in FAM_ARCHS:
        cfg = get_config(arch, smoke=True)
        tree = numpy_params(cfg, seed=3)
        rng = np.random.default_rng(4)
        toks = rng.integers(0, cfg.vocab_size, (2, 29))
        if cfg.n_codebooks:
            toks = (toks[..., None] + np.arange(cfg.n_codebooks)) \
                % cfg.vocab_size
        vis = (rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model),
                                   dtype=np.float32) * 0.02
               if cfg.n_vis_tokens else None)
        got = fam_drive(cfg, params_from_numpy(cfg, tree), "cuda", toks, vis)
        want = fam_drive(cfg, params_from_numpy(cfg, tree, device="cpu"),
                         "cpu", toks, vis)
        cfg32 = cfg.replace(compute_dtype=torch.float32)
        ref = fam_drive(cfg32, params_from_numpy(cfg32, tree, device="cpu"),
                        "cpu", toks, vis)
        worst = []
        for name, g, w, r in zip(names, got, want, ref):
            err = float((g - w).abs().max() / w.abs().max())
            own = float((w - r).abs().max() / r.abs().max())
            bound = max(FAM_TOL, 1.5 * own)
            check(bool(torch.isfinite(g).all()) and g.shape == w.shape
                  and err < bound, f"FAM {arch} {name}: card and CPU differ "
                  f"by {err:.4f} of the largest (bound {bound:.4f})")
            worst.append(f"{name} {err:.4f}/{bound:.4f}")
        print(f"phase 39 FAM {arch} (smoke, bf16): card == CPU within the "
              f"bound (max |card - CPU| / max |CPU| / bound: "
              + ", ".join(worst) + ")")


def fam_phase40(card):
    """Phase 40: Z7, X8 and M1, full-width depth-cut pins against JAX.  X8
    runs three times from one set of leaves: fp32 compute against the JAX
    fp32 pin within D2_TOL; bf16 on the prompt's first X8S_PROMPT_LEN
    tokens against that bf16 pin (X8S) within D2_TOL, where the JAX bf16
    run stands within X8S_BF16_SPREAD of its fp32 run; and bf16 on the
    whole prompt against the bf16 pin within the larger of D2_TOL and 1.5x
    that distance at each step (0.10-0.24: the sLSTM's exponential gating
    carries the bf16 rounding of 1,280 steps, in the reference as in the
    port)."""
    import gc
    import torch
    from repro_torch.check_runs import (D2_SEED, M1_PINS, M1_ROUTING,
                                        X8_BF16_SPREAD, X8_FP32_PINS,
                                        X8_PINS, X8S_BF16_SPREAD,
                                        X8S_PINS, X8S_PROMPT_LEN, Z7_PINS,
                                        numpy_leaves)
    from repro_torch.configs import get_config
    x8_leaves = list(numpy_leaves(get_config("xlstm-1.3b").replace(
        n_layers=8), D2_SEED))
    print(f"phase 40 X8S: the JAX bf16 run on the first {X8S_PROMPT_LEN} "
          f"prompt tokens stands {list(X8S_BF16_SPREAD)} of the largest "
          f"from its fp32 run at each step (on all 1,280: "
          f"{list(X8_BF16_SPREAD)})")
    for name, arch, n, pins, kw in (
            ("Z7", "zamba2-1.2b", 7, Z7_PINS, {}),
            ("X8 fp32", "xlstm-1.3b", 8, X8_FP32_PINS,
             dict(fp32=True, leaves=x8_leaves)),
            ("X8S", "xlstm-1.3b", 8, X8S_PINS,
             dict(leaves=x8_leaves, prompt_len=X8S_PROMPT_LEN)),
            ("X8", "xlstm-1.3b", 8, X8_PINS,
             dict(leaves=x8_leaves, bounds=[max(D2_TOL, 1.5 * d)
                                           for d in X8_BF16_SPREAD])),
            ("M1", "llama4-scout-17b-a16e", 1, M1_PINS,
             dict(routing=M1_ROUTING))):
        torch.cuda.reset_peak_memory_stats()
        s = depth_pin("40", name, arch, n, pins, card, **kw)
        print(f"phase 40 {name}: {s:.1f} s; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} bytes")
        gc.collect()
        torch.cuda.empty_cache()


def flash_extends(eng, reqs):
    """(Sq, q_offset, kv_len) of every extend the engine ran for ``reqs``:
    one per request for an attention family, one per segment of
    ``snapshot_every`` blocks for an SSM one."""
    bs = eng.block_size
    seg = eng.snapshot_every * bs
    out = []
    for r in reqs:
        pos, n = r.prefix_blocks_reused * bs, len(r.prompt)
        step = n - pos if eng.cfg.family not in ("hybrid_ssm", "xlstm") \
            else seg
        while pos < n:
            nxt = min(pos + step, n)
            out.append((nxt - pos, pos, nxt))
            pos = nxt
    return out


def serve_cell(cell, card):
    """One of runs LZ, LX, LM at full width through ServeEngine (counts set
    to 0 just before, read just after), each phase of the engine timed on
    the host clock (each ends in a sync).  Returns (launches, the flash
    shapes' mix {shape: launches}, heads (Hq, Hkv, D))."""
    import torch
    from repro_torch.check_runs import (LF_CELLS, LF_NEW_TOKENS, LF_PINS,
                                        LF_WORKLOAD)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve.driver import make_workload
    arch, engine_kw, n_layers = LF_CELLS[cell]
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    wl = dict(LF_WORKLOAD)
    prompts = make_workload(cfg, wl.pop("n_requests"), **wl)
    spent = {"start": [], "tick": [], "finish": [], "store": [],
             "restore": []}
    eng = timed_engine(spent, sync_before=True)(model, params, **engine_kw, prefix_policy="wtinylfu",
                device_sketch=True)
    for pr in prompts:
        eng.submit(pr, LF_NEW_TOKENS)
    reqs = list(eng.queue)
    set_launches(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = eng.stats
    check(stats == LF_PINS[cell], f"{cell}: stats {stats} != JAX "
          f"{LF_PINS[cell]}")
    check(len(out) == len(prompts) and all(
        len(t) == LF_NEW_TOKENS and all(0 <= x < cfg.vocab_size for x in t)
        for t in out.values()), f"{cell}: missing or bad generated tokens")
    shapes = flash_extends(eng, reqs)
    per_extend = {"hybrid_ssm": cfg.n_layers // max(cfg.attn_every, 1),
                  "xlstm": 0}.get(cfg.family, cfg.n_layers)
    check(launches["flash_attention"] == per_extend * len(shapes),
          f"{cell}: {launches['flash_attention']} flash launches, expected "
          f"{per_extend} per extend x {len(shapes)}")
    check(launches["sketch_update"] == eng.prefix_cache.stats.lookups
          and launches["admission"] == stats["admitted"] + stats["rejected"],
          f"{cell}: sketch launches {launches}")
    peak = torch.cuda.max_memory_allocated()
    ticks, starts = spent["tick"], sum(spent["start"])
    snap = ""
    if spent["restore"] or cfg.family in ("hybrid_ssm", "xlstm"):
        nbytes = sum(a.numel() * a.element_size()
                     for a in _leaves(eng.pool.pool)) // eng.pool.n_slots
        mean_ms = {k: 1e3 * sum(spent[k]) / max(1, len(spent[k]))
                   for k in ("store", "restore")}
        snap = (f"; a snapshot {nbytes} bytes: {len(spent['store'])} stores"
                f" {mean_ms['store']:.3f} ms each (with the admission), "
                f"{len(spent['restore'])} restores "
                f"{mean_ms['restore']:.3f} ms each")
    print(f"phase 41 {cell}: {arch} full width ({cfg.n_layers} layers, "
          f"{n_params:,} parameters, bf16; init {init_s:.2f} s), "
          f"{len(prompts)} prompts of {len(prompts[0])} tokens, engine "
          f"{engine_kw}: stats == JAX {stats}; launches {launches}")
    print(f"phase 41 {cell}: wall {wall:.3f} s (host clock, ends in a "
          f"sync; every engine phase synced); {len(spent['start'])} starts "
          f"{starts:.3f} s, {stats['tokens_prefilled'] / starts:,.0f} "
          f"prefill tokens/s; {len(ticks)} decode ticks "
          f"{1e3 * sum(ticks) / len(ticks):.2f} ms per tick; "
          f"{len(spent['finish'])} finishes {sum(spent['finish']):.3f} s"
          f"{snap}; max_memory_allocated {peak} bytes; card {card}")
    mix = {}
    for shp in shapes if per_extend else ():
        mix[shp] = mix.get(shp, 0) + per_extend
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    del eng, params, model
    return launches, mix, heads


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def flash_cell(cell, mix, heads, card):
    """The flash kernel at each of a run's attention shapes, held against
    its plain version: kernel, plain and scaled_dot_product_attention ms
    against the bound; returns the JSON numbers as means over the run's
    launches, and the largest max |kernel - plain| as max_abs_err."""
    from repro_torch.check_runs import LF_CELLS
    Hq, Hkv, D = heads
    max_len = LF_CELLS[cell][1]["max_len"]
    per, worst = {}, 0.0
    for (Sq, off, kvl), n in sorted(mix.items()):
        ms, plain, lib, err, lib_err = time_flash_shape(
            Sq, off, kvl, Hq=Hq, Hkv=Hkv, D=D, max_len=max_len)
        worst = max(worst, err)
        flops, nbytes = flash_work(Sq, off, kvl, Hq, Hkv, D)
        o_ms = flops / BF16_FLOPS_PER_S * 1e3
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        per[(Sq, off, kvl)] = (ms, plain, lib, o_ms, b_ms)
        print(f"phase 41 {cell} flash Hq={Hq} Hkv={Hkv} D={D} Sq={Sq} "
              f"q_offset={off} kv_len={kvl}: {n} launches; kernel "
              f"{ms:.4f} ms (max |kernel - plain| {err:.4f}); plain "
              f"{plain:.3f} ms; "
              f"scaled_dot_product_attention {lib:.4f} ms (max |sdpa - "
              f"plain| {lib_err:.4f}); bound: {flops / 1e9:.3f} GFLOP over "
              f"989 TFLOP/s = {o_ms:.4f} ms, {nbytes / 1e6:.2f} MB over "
              f"3.35 TB/s = {b_ms:.4f} ms; kernel at "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{max(o_ms, b_ms) / ms:.3f} of the bound; card {card}")
    total = sum(mix.values())

    def mean(i):
        return sum(per[k][i] * n for k, n in mix.items()) / total
    o_ms, b_ms = mean(3), mean(4)
    return dict(ms=mean(0), plain_ms=mean(1), library_ms=mean(2),
                max_abs_err=worst, bound_ms=max(o_ms, b_ms),
                bound_by="operations" if o_ms >= b_ms else "bytes")


def serve_phase41(card):
    """Phase 41: runs LZ, LX and LM; the flash kernel at LZ's and LM's
    shapes.  Returns {cell: (launches, flash numbers or None)}."""
    import gc
    import torch
    out = {}
    for cell in ("LZ", "LX", "LM"):
        launches, mix, heads = serve_cell(cell, card)
        gc.collect()
        torch.cuda.empty_cache()
        out[cell] = (launches, flash_cell(cell, mix, heads, card)
                     if mix else None)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 42-45: training (the flash backward kernel, every family's smoke
# config, the JAX pin, run TR)
# ---------------------------------------------------------------------------

def ptxas_by_instance(log: str) -> dict:
    """Kernel instance (its name and template arguments, read from the
    mangled name) -> its ptxas register and spill lines."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            # the kernel's source name: a length-prefixed identifier
            # ending in _kernel, then its template arguments
            m = next((m for m in re.finditer(
                r"(?=(\d+)([a-z_]+_kernel)I((?:L[ib]\d+E)+))", mangled)
                if int(m.group(1)) == len(m.group(2))), None)
            args = re.findall(r"L[ib](\d+)E", m.group(3)) if m else []
            kind = ("TrainParams" if "TrainParams" in mangled else
                    "Params" if "Params" in mangled else "")
            name = (f"{m.group(2)}<{', '.join(args)}>({kind})" if m
                    else mangled)
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split("ptxas info    : ")[-1].strip())
    return out


def flash_ptxas_phase1():
    """Phase 1's flash lines by instance: the forward's serving instances
    must keep the parent's (check_runs.FLASH_SERVING_PTXAS), beside its
    training (LSE) instances and the backward's kernels."""
    from repro_torch.check_runs import FLASH_SERVING_PTXAS
    from repro_torch.kernels import _build
    fwd = ptxas_by_instance(_build.build_info[("flash_attention", ())]["log"])
    serving = {n: v for n, v in fwd.items() if n.endswith("(Params)")}
    check(len(serving) == 8 and all(tuple(v) == FLASH_SERVING_PTXAS
                                    for v in serving.values()),
          f"flash serving instances' ptxas lines differ from the parent's: "
          f"{serving}")
    print(f"phase 1  flash_attention: its {len(serving)} serving instances' "
          f"ptxas lines == the parent's ({' | '.join(FLASH_SERVING_PTXAS)})")
    for n, v in fwd.items():
        if not n.endswith("(Params)"):
            print(f"phase 1  flash_attention {n}: {' | '.join(v)}")
    bwd = _build.build_info[("flash_attention_bwd", ())]["log"]
    for n, v in ptxas_by_instance(bwd).items():
        print(f"phase 1  flash_attention_bwd {n}: {' | '.join(v)}")


def fb_inputs(seed, B, S, Hq, Hkv, D):
    """Normal bf16 q, dO (B,S,Hq,D) and k, v (B,S,Hkv,D) on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    return (randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D),
            randn(B, S, Hq, D))


def flash_train_work(B, S, Hq, Hkv, D):
    """(forward flops, forward bytes, backward flops, backward bytes) of
    causal attention at these shapes: 4 D flops per visible (query, key)
    pair and head forward, 2.5 times that backward (five products of D
    multiply-adds); forward reads q, k, v and writes the output and the
    LSE; backward reads q, k, v, o, dO and the LSE and writes dq, dk, dv."""
    pairs = B * Hq * S * (S + 1) // 2
    nq, nkv, nlse = B * S * Hq * D * 2, B * S * Hkv * D * 2, B * Hq * S * 4
    return (4 * D * pairs, 2 * nq + 2 * nkv + nlse,
            10 * D * pairs, 4 * nq + 4 * nkv + nlse)


def fb_phase42(card):
    """Phase 42 (FB): the backward kernel against flash_attention_bwd_ref,
    and the forward's training instance (output and LSE) against
    flash_attention_ref, on check_runs.FB_CASES; gradients through
    flash_attention under autograd on the card; calls outside the training
    contract raise; both kernels timed at TR's shape beside their bounds,
    their plain versions and scaled_dot_product_attention.  Returns the
    numbers of the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.check_runs import FB_CASES, FB_LSE_TOL, FB_TOL
    from repro_torch.kernels import flash_attention as fa
    worst = dict(out=0.0, lse=0.0, rel=0.0, abs=0.0)
    for i, (name, B, S, Hq, Hkv, D, cap) in enumerate(FB_CASES):
        q, k, v, do = fb_inputs(i, B, S, Hq, Hkv, D)
        out, lse = fa._launch_train(q, k, v, cap)
        want, want_lse = fa.flash_attention_ref(q, k, v, softcap=cap,
                                                return_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, do, lse, softcap=cap)
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, softcap=cap)
        ref = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, softcap=cap)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"FB {name}: two calls of the backward differ")
        o_err = float((out.float() - want.float()).abs().max())
        l_err = float((lse - want_lse).abs().max())
        check(bool(torch.isfinite(out).all()) and bool(
            torch.isfinite(lse).all()), f"FB {name}: forward not finite")
        check(o_err <= FLASH_TOL and l_err <= FB_LSE_TOL,
              f"FB {name}: training forward differs from plain by {o_err} "
              f"(output) and {l_err} (LSE)")
        parts = []
        for nm, a, b in zip(("dq", "dk", "dv"), got, ref):
            check(a.shape == b.shape and a.dtype == torch.bfloat16
                  and bool(torch.isfinite(a).all()), f"FB {name}: bad {nm}")
            err = float((a.float() - b.float()).abs().max())
            rel = err / max(float(b.float().abs().max()), 1e-30)
            check(rel <= FB_TOL, f"FB {name}: {nm} differs from plain by "
                  f"{rel:.5f} of its largest > {FB_TOL}")
            worst["rel"] = max(worst["rel"], rel)
            worst["abs"] = max(worst["abs"], err)
            parts.append(f"{nm} {rel:.5f}")
        worst["out"] = max(worst["out"], o_err)
        worst["lse"] = max(worst["lse"], l_err)
        print(f"phase 42 FB {name}: B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
              f"softcap={cap}: forward max |kernel - plain| {o_err:.6f}, "
              f"LSE {l_err:.2e}; backward max |kernel - plain| over max "
              f"|plain|: {', '.join(parts)}; a second call bit-equal")
        del q, k, v, do, out, lse, want, want_lse, got, again, ref

    # autograd through flash_attention on the card: the training forward,
    # then the backward kernel, the same numbers as the direct calls
    q, k, v, do = fb_inputs(100, 2, 130, 8, 2, 64)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n_fwd, n_bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    check(out.grad_fn is not None and all(g is not None for g in grads),
          "FB: flash_attention under autograd left a gradient out")
    check(fa.flash_attention.launches == n_fwd + 1
          and fa.flash_attention_bwd.launches == n_bwd + 1,
          "FB: autograd did not go through the two kernels")
    o2, lse2 = fa._launch_train(q, k, v, 0.0)
    direct = fa.flash_attention_bwd(q, k, v, o2, do, lse2)
    check(torch.equal(out.detach(), o2) and all(
        torch.equal(a, b) for a, b in zip(grads, direct)),
        "FB: autograd's gradients differ from the kernels' direct calls")
    for bad in (dict(causal=False), dict(q_offset=3), dict(kv_len=100)):
        try:
            fa.flash_attention(*leaves, **bad)
        except ValueError:
            continue
        check(False, f"FB: a differentiable call with {bad} did not raise")
    print("phase 42 FB autograd: torch.autograd.grad through flash_attention "
          "on CUDA gives q, k and v gradients (none None), bit-equal to the "
          "kernels' direct calls; calls outside the training contract "
          "(not causal, q_offset, kv_len) raise")
    del q, k, v, do, leaves, out, grads, o2, lse2, direct

    # both kernels at TR's shape
    B, S, Hq, Hkv, D = 8, 2048, 32, 8, 128
    q, k, v, do = fb_inputs(7, B, S, Hq, Hkv, D)
    reps = 10
    timed, outs = kernel_ms([("fwd", lambda: fa._launch_train(q, k, v, 0.0))]
                            * reps)
    fwd_ms = sum(t for _, t in timed) / reps
    out, lse = outs[-1]
    del outs
    timed, outs = kernel_ms([("bwd", lambda: fa.flash_attention_bwd(
        q, k, v, out, do, lse))] * reps)
    bwd_ms = sum(t for _, t in timed) / reps
    ref = fa.flash_attention_bwd_ref(q, k, v, out, do, lse)
    for got in outs:
        for a, b in zip(got, ref):
            rel = float((a.float() - b.float()).abs().max()) / float(
                b.float().abs().max())
            check(rel <= FB_TOL, f"FB timed at TR's shape: {rel} > {FB_TOL}")
    check(all(torch.equal(a, b) for got in outs[1:]
              for a, b in zip(got, outs[0])),
          "FB: the timed backward calls at TR's shape differ from each other")
    print(f"phase 42 FB: the {reps} timed backward calls at TR's shape are "
          "bit-equal to each other")
    del outs, ref
    plain_fwd = timed_ms(lambda: fa.flash_attention_ref(
        q, k, v, return_lse=True), 1)
    plain_bwd = timed_ms(lambda: fa.flash_attention_bwd_ref(
        q, k, v, out, do, lse), 1)
    # the library yardstick: scaled_dot_product_attention with the KV heads
    # repeated, forward, and backward through retained graphs
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(Hq // Hkv, dim=1),
            vt.repeat_interleave(Hq // Hkv, dim=1), is_causal=True)
    lib_out = sdpa()
    timed, _ = kernel_ms([("sdpa", sdpa)] * reps)
    lib_fwd = sum(t for _, t in timed) / reps
    dot = do.transpose(1, 2)
    torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
    timed, lib_grads = kernel_ms([("sdpa bwd", lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))] * reps)
    lib_bwd = sum(t for _, t in timed) / reps
    lib_dq = lib_grads[-1][0].transpose(1, 2).float()
    kern_dq = fa.flash_attention_bwd(q, k, v, out, do, lse)[0].float()
    lib_err = float((lib_dq - kern_dq).abs().max()) / float(
        kern_dq.abs().max())
    del lib_grads, lib_out, qt, kt, vt
    f_fl, f_by, b_fl, b_by = flash_train_work(B, S, Hq, Hkv, D)
    res = {}
    for nm, ms, plain, lib, fl, by in (
            ("forward with LSE", fwd_ms, plain_fwd, lib_fwd, f_fl, f_by),
            ("backward", bwd_ms, plain_bwd, lib_bwd, b_fl, b_by)):
        o_ms, b_ms = fl / BF16_FLOPS_PER_S * 1e3, by / HBM_BYTES_PER_S * 1e3
        bound = max(o_ms, b_ms)
        res[nm] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                       bound_by="operations" if o_ms >= b_ms else "bytes",
                       tflops=fl / ms / 1e9)
        print(f"phase 42 FB {nm} at TR's shape (B={B} S={S} Hq={Hq} "
              f"Hkv={Hkv} D={D}): kernel {ms:.4f} ms ({fl / ms / 1e9:.1f} "
              f"TFLOP/s, {bound / ms:.3f} of the bound); bound "
              f"{fl / 1e9:.1f} GFLOP over 989 TFLOP/s = {o_ms:.4f} ms, "
              f"{by / 1e6:.1f} MB over 3.35 TB/s = {b_ms:.4f} ms; plain "
              f"{plain:.3f} ms; scaled_dot_product_attention {lib:.4f} ms "
              f"(KV heads repeated); {card}")
    print(f"phase 42 FB: scaled_dot_product_attention's dq against the "
          f"kernel's at TR's shape: {lib_err:.5f} of its largest")
    res.update(max_abs_err=worst["abs"], max_rel_err=worst["rel"],
               forward_max_abs_err=worst["out"], lse_max_abs_err=worst["lse"])
    return res


TF_ARCHS = ("qwen3-4b", "llama4-scout-17b-a16e", "llava-next-34b",
            "musicgen-medium", "zamba2-1.2b", "xlstm-1.3b")
TF_STEPS, TF_TOL = 4, 0.05       # the reference's bf16 bound
TF_FP32_TOL = 1e-3
TF_LR = (2e-3, 1, 10, 10)


def tf_batch(cfg) -> dict:
    """TF's batch for a smoke config: two 32-token sequences (codebook
    streams distinct), for vlm 0.02-scaled vision embeddings; numpy."""
    rng = np.random.default_rng(11)
    t = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    if cfg.n_codebooks:
        t = ((t[..., None] + np.arange(cfg.n_codebooks)) % cfg.vocab_size
             ).astype(np.int32)
    out = {"tokens": t}
    if cfg.n_vis_tokens:
        out["vision_embeds"] = (rng.standard_normal(
            (2, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32) * 0.02)
    return out


def tf_losses(arch: str, device: str, fp32: bool = False) -> list:
    """TF_STEPS AdamW steps of ``arch``'s smoke config in bf16 (fp32 with
    ``fp32``) from ``numpy_leaves`` weights on ``device``: the losses."""
    import torch
    from repro_torch.check_runs import numpy_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw, wsd
    from repro_torch.train import TrainState, build_train_step
    from repro_torch.models.common import leaf_tree
    if device == "cpu":
        torch.set_num_threads(1)
    cfg = get_config(arch, smoke=True)
    if fp32:
        cfg = cfg.replace(compute_dtype=torch.float32)
    m = build_model(cfg, device=device)
    opt = adamw(wsd(*TF_LR))
    params = params_from_numpy(cfg, numpy_leaves(cfg, 3), device=device,
                               train=True)
    state = TrainState(params=params, opt=opt.init(leaf_tree(params)),
                       step=torch.zeros((), dtype=torch.int32))
    step = build_train_step(m, opt, loss_chunk=16)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in tf_batch(cfg).items()}
    if "vision_embeds" in batch:
        batch["vision_embeds"] = batch["vision_embeds"].to(cfg.compute_dtype)
    return [float(step(state, batch)[1]["loss"]) for _ in range(TF_STEPS)]


def tf_phase43(card, work):
    """Phase 43 (TF): each family's smoke config trains on the card, its
    losses against the port's CPU run (in the pool meanwhile): within
    TF_TOL, or 1.5x the CPU's own bf16-vs-fp32 distance where that is
    larger.  xLSTM, which has no attention, also trains in fp32 on the
    card, within TF_FP32_TOL of the CPU's fp32 run at every step; its bf16
    runs part after two AdamW steps (the sLSTM's exponential gates carry
    each rounding on, as at X8), so each is held to its own distance from
    the fp32 trajectory: |card - CPU| in bf16 within |card bf16 - card
    fp32| + |card fp32 - CPU fp32| + |CPU fp32 - CPU bf16| where that is
    larger.  Then the driver on chatglm3's smoke config interrupted at step
    3 and resumed == its continuous run."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.driver import train
    jobs = {(a, f): cpu_pool().submit(tf_losses, a, "cpu", f)
            for a in TF_ARCHS for f in (False, True)}
    for arch in TF_ARCHS:
        n0, b0 = fa.flash_attention.launches, \
            fa.flash_attention_bwd.launches
        t0 = time.perf_counter()
        card_l = tf_losses(arch, "cuda")
        secs = time.perf_counter() - t0
        cpu_l, cpu32 = jobs[(arch, False)].result(), jobs[(arch, True)].result()
        bounds = [max(TF_TOL, 1.5 * abs(a - b)) for a, b in zip(cpu_l, cpu32)]
        also = ""
        if arch.startswith("xlstm"):
            # fp32 on the card (no attention: no bf16-only kernel) against
            # the CPU's fp32 run; in bf16 each run is held to its own
            # distance from the fp32 trajectory, through the fp32 runs
            card32 = tf_losses(arch, "cuda", True)
            d32 = [abs(a - b) for a, b in zip(card32, cpu32)]
            check(max(d32) <= TF_FP32_TOL, f"TF {arch} fp32: card {card32} "
                  f"against the CPU's {cpu32}")
            bounds = [max(b, abs(c16 - c32) + abs(p16 - p32) + d)
                      for b, c16, c32, p16, p32, d in zip(
                          bounds, card_l, card32, cpu_l, cpu32, d32)]
            also = f"; in fp32 max |card - CPU| {max(d32):.2e}"
        diffs = [abs(a - b) for a, b in zip(card_l, cpu_l)]
        check(all(map(math.isfinite, card_l))
              and all(d <= b for d, b in zip(diffs, bounds)),
              f"TF {arch}: card losses {card_l} against the CPU's {cpu_l} "
              f"(bounds {bounds})")
        check(card_l[-1] < card_l[0], f"TF {arch}: no learning {card_l}")
        print(f"phase 43 TF {arch}: {TF_STEPS} AdamW steps in bf16, losses "
              f"{', '.join(f'{x:.4f}' for x in card_l)} on the card, "
              f"|card - CPU| {', '.join(f'{d:.5f}' for d in diffs)} within "
              f"{', '.join(f'{b:.4f}' for b in bounds)}{also}; flash "
              f"launches {fa.flash_attention.launches - n0} forward, "
              f"{fa.flash_attention_bwd.launches - b0} backward; "
              f"{secs:.1f} s")
    kw = dict(global_batch=4, seq_len=32, ckpt_every=3, device="cuda")
    a, b = work / "tf-continuous", work / "tf-interrupted"
    cont = train("chatglm3-6b", steps=6, out_dir=str(a), **kw)
    train("chatglm3-6b", steps=3, out_dir=str(b), **kw)
    resumed = train("chatglm3-6b", steps=6, out_dir=str(b), **kw)
    diff = abs(cont["loss"] - resumed["loss"])
    check(diff < 1e-4, f"TF driver: interrupted {resumed['loss']} != "
          f"continuous {cont['loss']}")
    print(f"phase 43 TF driver: chatglm3 smoke, 6 steps continuous loss "
          f"{cont['loss']:.6f}, interrupted at 3 and resumed "
          f"{resumed['loss']:.6f} (|diff| {diff:.2e} < 1e-4); {card}")


def trp_phase44(card):
    """Phase 44 (TRP): qwen3-4b at published width, 2 layers, three AdamW
    steps on one 256-token sequence: each step's loss and grad norm
    against the JAX package's pins, within 1.5x the reference's own
    bf16-vs-fp32 distance."""
    import torch
    from repro_torch.check_runs import (TRP_FP32_PINS, TRP_LAYERS, TRP_LR,
                                        TRP_PINS, TRP_SEED, TRP_SEQ,
                                        numpy_leaves, trp_tokens)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import leaf_tree
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw, wsd
    from repro_torch.train import TrainState, build_train_step
    cfg = get_config("qwen3-4b").replace(n_layers=TRP_LAYERS)
    t0 = time.perf_counter()
    params = params_from_numpy(cfg, numpy_leaves(cfg, TRP_SEED),
                               device="cuda", train=True)
    opt = adamw(wsd(*TRP_LR))
    state = TrainState(params=params, opt=opt.init(leaf_tree(params)),
                       step=torch.zeros((), dtype=torch.int32))
    step = build_train_step(build_model(cfg, device="cuda"), opt)
    batch = {"tokens": torch.from_numpy(trp_tokens(cfg)).cuda()}
    for i, (pin, ref32) in enumerate(zip(TRP_PINS, TRP_FP32_PINS)):
        _, metrics = step(state, batch)
        got = (float(metrics["loss"]), float(metrics["grad_norm"]))
        for name, g, p, r in zip(("loss", "grad_norm"), got, pin, ref32):
            bound = 1.5 * abs(p - r)
            check(abs(g - p) <= bound, f"TRP step {i} {name}: port {g} vs "
                  f"JAX {p}, |diff| {abs(g - p)} > 1.5 x the reference's "
                  f"bf16-vs-fp32 {abs(p - r)}")
        print(f"phase 44 TRP step {i}: loss {got[0]:.6f} (JAX bf16 "
              f"{pin[0]:.6f}, fp32 {ref32[0]:.6f}), grad_norm "
              f"{got[1]:.6f} (JAX bf16 {pin[1]:.6f}, fp32 {ref32[1]:.6f})")
    print(f"phase 44 TRP: qwen3-4b full width, {TRP_LAYERS} layers, "
          f"{TRP_SEQ} tokens, 3 AdamW steps within 1.5x the reference's "
          f"own bf16-vs-fp32 distance ({time.perf_counter() - t0:.1f} s); "
          f"{card}")
    del state, params


TR_LAYERS, TR_BATCH, TR_SEQ, TR_STEPS = 12, 8, 2048, 10
TR_LR = (3e-4, 1, TR_STEPS, TR_STEPS)


def tr_phase45(card, fb):
    """Phase 45 (TR), the slice's main run: qwen3-4b at published width,
    12 of its 36 layers, batches of 8 x 2,048 tokens from TokenPipeline
    over the W-TinyLFU shard cache, AdamW with WSD, remat on, ten steps
    (counts set to 0 just before, read just after); one more step
    profiled; then three Adafactor steps.  Returns (the flash kernels'
    launches in the run, per-kernel numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models.common import leaf_tree, param_count
    from repro_torch.optim import adafactor, adamw, wsd
    from repro_torch.train import build_train_step, make_train_state
    from repro_torch.train.driver import make_pipeline, next_batch
    cfg = get_config("qwen3-4b").replace(n_layers=TR_LAYERS)
    dev = torch.device("cuda")
    model = build_model(cfg, dev)
    opt = adamw(wsd(*TR_LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, opt,
                             torch.Generator(device=dev).manual_seed(0))
    n_params = param_count(state.params)
    pipe = make_pipeline(cfg, global_batch=TR_BATCH, seq_len=TR_SEQ, seed=0)
    step = build_train_step(model, opt)
    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    losses, secs = [], []
    for _ in range(TR_STEPS):
        batch = next_batch(pipe, cfg, dev)
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))       # waits for the step
        secs.append(time.perf_counter() - t0)
    launches = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"TR: losses {losses}")
    check(launches == (2 * TR_LAYERS * TR_STEPS, TR_LAYERS * TR_STEPS),
          f"TR: flash launches {launches}, expected "
          f"{2 * TR_LAYERS * TR_STEPS} forward and {TR_LAYERS * TR_STEPS} "
          "backward")
    host = make_pipeline(cfg, global_batch=TR_BATCH, seq_len=TR_SEQ, seed=0)
    for _ in range(TR_STEPS):
        host.next_batch()
    check(pipe.cache_stats == host.cache_stats,
          f"TR: pipeline {pipe.cache_stats} != CPU {host.cache_stats}")
    ms = statistics.mean(secs[1:]) * 1e3
    tokens = TR_BATCH * TR_SEQ
    print(f"phase 45 TR: qwen3-4b full width, {TR_LAYERS} of 36 layers, "
          f"{n_params / 1e9:.3f} B parameters, {TR_BATCH} x {TR_SEQ} "
          f"tokens a step from TokenPipeline (cache {pipe.cache_stats}, == "
          f"the CPU pipeline's), AdamW + WSD, remat on: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}")
    print(f"phase 45 TR: {ms:.1f} ms per step on the host clock (mean of "
          f"steps 2-{TR_STEPS}; min {min(secs[1:]) * 1e3:.1f}, max "
          f"{max(secs[1:]) * 1e3:.1f}; first {secs[0] * 1e3:.1f}), "
          f"{tokens / ms * 1e3:,.0f} tokens/s; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; flash launches {launches[0]} forward "
          f"({launches[0] // TR_STEPS} per step), {launches[1]} backward "
          f"({launches[1] // TR_STEPS} per step); {card}")

    # one more step under the profiler: device time by kind of kernel
    batch = next_batch(pipe, cfg, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        float(metrics["loss"])
        p_wall = time.perf_counter() - t0
    kinds, n, names = device_time_by_kind(prof)
    del prof
    kinds["flash forward"] = kinds.pop("flash")
    top = sorted(((nm, t) for nm, t in names.items() if not any(
        k in nm.lower() for k in ("flash_attention_kernel", "gemm", "xmma",
                                  "nvjet", "cutlass", "memcpy", "memset")
        + FLASH_BWD_KERNELS)), key=lambda kv: -kv[1])[:8]
    busy = sum(kinds.values())
    if busy:
        print(f"phase 45 TR profiled step: wall {p_wall * 1e3:.1f} ms, {n} "
              f"device activities, busy {busy * 1e3:.1f} ms: "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in kinds.items())
              + f"; device idle share {1 - busy / p_wall:.4f}")
        print("phase 45 TR profiled step, the largest other kernels (ms): "
              + "; ".join(f"{nm.replace('void at::native::', '')[:100]} "
                          f"{t * 1e3:.1f}" for nm, t in top))
    else:
        print("phase 45 TR profiled step: the profiler saw no device "
              "activity; device time by kind not measured")
    res = {}
    f_fl, _, b_fl, _ = flash_train_work(TR_BATCH, TR_SEQ, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd)
    for nm, kind, per_step, fl in (
            ("forward with LSE", "flash forward", 2 * TR_LAYERS, f_fl),
            ("backward", "flash backward", TR_LAYERS, b_fl)):
        dev_s = kinds[kind]
        launch_ms = dev_s * 1e3 / per_step if dev_s else float("nan")
        res[nm] = dict(ms_in_tr=launch_ms, launches_per_step=per_step,
                       tflops_in_tr=fl / launch_ms / 1e9 if dev_s else None)
        print(f"phase 45 TR {nm} kernel in the profiled step: "
              f"{launch_ms:.4f} ms per launch, {per_step} launches per "
              f"step, {fl / launch_ms / 1e9:.1f} TFLOP/s; at TR's shape in "
              f"phase 42 {fb[nm]['ms']:.4f} ms, the bound "
              f"{fb[nm]['bound_ms']:.4f} ms, scaled_dot_product_attention "
              f"{fb[nm]['library_ms']:.4f} ms")
    print(f"phase 45 TR: scaled_dot_product_attention forward + backward "
          f"at the same shape (the library yardstick, never on the path) "
          f"{fb['forward with LSE']['library_ms'] + fb['backward']['library_ms']:.4f}"
          f" ms against the kernels' {fb['forward with LSE']['ms'] + fb['backward']['ms']:.4f}"
          " ms")

    # three Adafactor steps on the same model, from its state now
    opt2 = adafactor(wsd(*TR_LR))
    state.opt = opt2.init(leaf_tree(state.params))
    step2 = build_train_step(model, opt2)
    torch.cuda.reset_peak_memory_stats()
    af = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, metrics = step2(state, next_batch(pipe, cfg, dev))
        af.append((float(metrics["loss"]), time.perf_counter() - t0))
    check(all(math.isfinite(x) for x, _ in af), f"TR Adafactor: {af}")
    print(f"phase 45 TR Adafactor: 3 steps, losses "
          f"{', '.join(f'{x:.4f}' for x, _ in af)}, "
          f"{', '.join(f'{s * 1e3:.1f}' for _, s in af)} ms; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    del state, step, step2
    return launches, res, dict(ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
                               peak_gib=peak / 2**30, losses=losses)


# ---------------------------------------------------------------------------
# phases 46-47: sharded training on a one-rank NCCL grid; the collectives
# ---------------------------------------------------------------------------

TRS_STEPS = 3


def master_digest(leaves) -> str:
    """A digest of fp32 tensors' bits computed on their device: per
    tensor its shape and two sums (mod 2**64) of its words as int64, the
    second position-weighted, over 2**24-word chunks."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in leaves:
        v = t.detach().contiguous().view(-1).view(torch.int32)
        w = torch.arange(1 << 24, device=v.device, dtype=torch.int64) % 1021
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=v.device)
        for i, c in enumerate(v.split(1 << 24)):
            q = c.to(torch.int64)
            s1 = s1 + q.sum()
            s2 = s2 + (q * (w[:q.numel()] + 1)).sum() * (i + 1)
        h.update(f"{tuple(t.shape)}:{int(s1)}:{int(s2)};".encode())
    return h.hexdigest()[:16]


def trs_run(model, cfg, policy, dev):
    """TRS_STEPS AdamW steps of TR's setup (seed 0, its first batches) with
    ``policy``, the flash counts set to 0 just before and read just after:
    (losses, seconds per step, (forward, backward) launches, peak bytes,
    digest of the masters)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import NULL_POLICY
    from repro_torch.optim import adamw, wsd
    from repro_torch.train import build_train_step, make_train_state
    from repro_torch.train.driver import make_pipeline, next_batch
    opt = adamw(wsd(*TR_LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, opt,
                             torch.Generator(device=dev).manual_seed(0),
                             policy=policy)
    pipe = make_pipeline(cfg, global_batch=TR_BATCH, seq_len=TR_SEQ, seed=0)
    batches = [next_batch(pipe, cfg, dev) for _ in range(TRS_STEPS)]
    step = build_train_step(model, opt, policy=policy)
    torch.cuda.synchronize()
    fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
    losses, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        _, metrics = step(state, b)
        losses.append(float(metrics["loss"]))       # waits for the step
        secs.append(time.perf_counter() - t0)
    launches = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    if policy is NULL_POLICY:
        dig = master_digest(leaf.value for leaf in state.params.ref_leaves)
    else:
        from repro_torch.optim.optimizers import _leaves
        dig = master_digest(
            policy.gather(m, spec, leaf.value.shape) for leaf, spec, m in zip(
                state.params.ref_leaves, policy.leaf_specs(state.params),
                _leaves(state.master)))
    del state, step, batches
    return losses, secs, launches, peak, dig


def collective_inputs():
    """Phase 47's inputs, from a seed: a gradient-sized tensor and a small
    one with their errors for the compression; a stack of 8 layers of
    tanh(h W + b) at width 1,024 and a batch of 64 for the pipeline."""
    import torch
    g = torch.Generator().manual_seed(47)
    comp = [(torch.randn((4096, 4096), generator=g) * 0.01,
             torch.randn((4096, 4096), generator=g) * 1e-4),
            (torch.randn((64, 32), generator=g), None)]
    params = {"w": torch.randn((8, 1024, 1024), generator=g) / 32.0,
              "b": torch.randn((8, 1024), generator=g) * 0.1}
    x = torch.randn((64, 1024), generator=g)
    return comp, params, x


def pipe_block(p, h):
    import torch
    return torch.tanh(h @ p["w"] + p["b"])


def collectives_cpu():
    """Phase 47's CPU results, before any process group exists."""
    from repro_torch.distributed.compression import compressed_allreduce_int8
    from repro_torch.distributed.mesh import make_debug_mesh
    from repro_torch.distributed.pipeline import pipeline_apply
    comp, params, x = collective_inputs()
    cpu_comp = [compressed_allreduce_int8(t, None, e) for t, e in comp]
    mesh = make_debug_mesh((1,), ("stage",), device="cpu")
    cpu_pipe = {m: pipeline_apply(mesh, "stage", pipe_block, params, x, m)
                for m in (2, 4)}
    return cpu_comp, cpu_pipe


def trs_phase46(card, tr, grid):
    """Phase 46 (TRS), the slice's main run: qwen3-4b at published width,
    TR_LAYERS layers, through ShardingPolicy on the one-rank NCCL grid
    ``grid``: TRS_STEPS AdamW steps from TR's seed and batches, held bit
    for bit to the plain step's (losses and a digest of every master
    leaf), both timed in this call.  Returns the sharded run's flash
    launches and its numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.shardings import ShardingPolicy
    from repro_torch.models import build_model
    from repro_torch.models.common import NULL_POLICY
    cfg = get_config("qwen3-4b").replace(n_layers=TR_LAYERS)
    dev = grid.device
    model = build_model(cfg, dev)
    plain = trs_run(model, cfg, NULL_POLICY, dev)
    gc.collect()
    torch.cuda.empty_cache()
    policy = ShardingPolicy(grid)
    shard = trs_run(model, cfg, policy, dev)
    gc.collect()
    torch.cuda.empty_cache()
    per = (2 * TR_LAYERS * TRS_STEPS, TR_LAYERS * TRS_STEPS)
    check(shard[2] == per, f"TRS: flash launches {shard[2]}, expected {per}")
    check(shard[0] == plain[0] and shard[4] == plain[4],
          f"TRS: sharded losses {shard[0]} digest {shard[4]} != the plain "
          f"step's {plain[0]} {plain[4]}")
    ms = statistics.mean(shard[1][1:]) * 1e3
    plain_ms = statistics.mean(plain[1][1:]) * 1e3
    print(f"phase 46 TRS: qwen3-4b full width, {TR_LAYERS} layers, "
          f"ShardingPolicy on the one-rank NCCL grid {grid.shape}, "
          f"{TRS_STEPS} AdamW steps of {TR_BATCH} x {TR_SEQ} tokens from "
          f"TR's seed and batches: losses "
          f"{', '.join(f'{x:.6f}' for x in shard[0])} and the masters' "
          f"digest {shard[4]} == the plain step's (bit for bit)")
    print(f"phase 46 TRS: {ms:.1f} ms per step (host clock, mean of steps "
          f"2-{TRS_STEPS}; first {shard[1][0] * 1e3:.1f}) against the plain "
          f"step's {plain_ms:.1f} here and TR's {tr['ms_per_step']:.1f} "
          f"(phase 45): {ms - plain_ms:+.1f} ms for the gather and the "
          f"reduce-scatter; max_memory_allocated {shard[3] / 2**30:.2f} GiB "
          f"against {plain[3] / 2**30:.2f} (plain, same steps) and TR's "
          f"{tr['peak_gib']:.2f}; flash launches {shard[2][0]} forward, "
          f"{shard[2][1]} backward ({shard[2][0] // TRS_STEPS} and "
          f"{shard[2][1] // TRS_STEPS} per step); {card}")
    return shard[2], dict(ms_per_step=ms, plain_ms_per_step=plain_ms,
                          peak_gib=shard[3] / 2**30,
                          plain_peak_gib=plain[3] / 2**30,
                          losses=shard[0], digest=shard[4])


def collectives_phase47(card, grid, cpu_comp, cpu_pipe):
    """Phase 47: compressed_allreduce_int8 and pipeline_apply on the
    one-rank NCCL grid against their CPU results: the compression's mean
    and error bit for bit, the pipeline within 1e-5 relative."""
    import torch
    from repro_torch.distributed.compression import compressed_allreduce_int8
    from repro_torch.distributed.mesh import make_debug_mesh
    from repro_torch.distributed.pipeline import pipeline_apply
    comp, params, x = collective_inputs()
    dev = grid.device
    for (t, e), (want_m, want_e) in zip(comp, cpu_comp):
        e_dev = None if e is None else e.to(dev)
        t_dev = t.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, err = compressed_allreduce_int8(t_dev, grid.groups["data"], e_dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(torch.equal(m.cpu(), want_m) and torch.equal(err.cpu(), want_e),
              f"phase 47 compression {tuple(t.shape)}: card != CPU")
        print(f"phase 47 compressed_allreduce_int8 {tuple(t.shape)} on the "
              f"NCCL group: mean and error == the CPU's bit for bit; "
              f"{secs * 1e3:.3f} ms (host clock, one call); {card}")
    mesh = make_debug_mesh((1,), ("stage",))
    p_dev = {k: v.to(dev) for k, v in params.items()}
    for n_micro, want in cpu_pipe.items():
        got = pipeline_apply(mesh, "stage", pipe_block, p_dev, x.to(dev),
                             n_micro).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        check(err <= 1e-5, f"phase 47 pipeline n_micro={n_micro}: {err}")
        print(f"phase 47 pipeline_apply on the NCCL grid {mesh.shape}, "
              f"n_micro={n_micro}: within {err:.2e} of the CPU's (relative)")


def hc_phase48(card):
    """Phase 48: run HC, the window-adaptation CLI (``repro_torch.launch.
    hillclimb.main``, in process) at its own defaults on the card with
    ``--static-sweep``: the phase-shift and fickle-churn traces at 8 ways
    and a 50,000-access Zipf trace on the flat tables (``check_runs.
    HC_RUNS``), JSONs into a temporary directory under ``build/``.  Counts
    set to 0 just before each run and read just after: the adaptive run's
    step launches (one per climb epoch) are read where the CLI enters
    ``simulate_sweep``, the static runs' (one per 512-access chunk) after
    it, and no other kernel may launch.  Every row's hits, the adaptive
    run's final quota and its whole trajectory must equal the current
    reference CLI's (``HC_PINS``), and ``adaptive_table`` over the
    directory the reference's table over its own JSONs (``HC_TABLE``).
    Prints each run's wall and accesses per second, the adaptive run beside
    its best static run, and the phase's time.  Returns the launch counts
    and the checks for the kernels line."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch
    from repro_torch.analysis.report import adaptive_table
    from repro_torch.core import device_simulate
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.launch import hillclimb
    t48 = time.perf_counter()
    real_sweep = device_simulate.simulate_sweep
    at_sweep = []

    def sweep(*args, **kw):         # the adaptive run's launches end here
        torch.cuda.synchronize()
        at_sweep.append((ks.step.launches, time.perf_counter()))
        return real_sweep(*args, **kw)

    launches = {"adaptive": 0, "static": 0, "flat_adaptive": 0,
                "flat_static": 0}
    climbs, bounds = {}, {}
    CKPT_WORKDIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="hillclimb-", dir=CKPT_WORKDIR))
    device_simulate.simulate_sweep = sweep
    try:
        for trace, flags in HC_RUNS:
            argv = ["--trace", trace, *flags, "--static-sweep", "--out",
                    str(work / f"{trace}.json")]
            args = hillclimb.parse_args(argv)
            n, epoch = args.length, args.epoch_len
            at_sweep.clear()
            torch.cuda.synchronize()
            set_launches(0)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rows = hillclimb.main(argv)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = read_launches()
            n_adapt, t_sweep = at_sweep[0]
            n_static = got["sketch_step"] - n_adapt
            a, stat = rows[0], rows[1:]
            nep = len(a["extra"].get("trajectory", {}).get("quota", []))
            expect = (-(-n // epoch), len(stat) * -(-n // 512))
            check(len(at_sweep) == 1 and (n_adapt, n_static) == expect
                  and sum(got.values()) == got["sketch_step"]
                  and nep == n // epoch,
                  f"HC {trace}: launches {got}, {n_adapt} before the "
                  f"sweep, {nep} climbs; expected {expect} step launches "
                  f"and {n // epoch} climbs")
            check(all(r["extra"]["backend"].startswith("cuda")
                      and r["extra"]["device"] == torch.cuda.get_device_name()
                      for r in rows), f"HC {trace}: a row ran off the card")
            pins = hc_pins(rows)
            check(pins == HC_PINS[trace],
                  f"HC {trace}: {pins} != the reference CLI's "
                  f"{HC_PINS[trace]}")
            flat = "flat_" if args.assoc == 0 else ""
            launches[flat + "adaptive"] += n_adapt
            launches[flat + "static"] += n_static
            climbs[trace] = nep
            best = max(stat, key=lambda r: r["hit_ratio"])
            a_wall = a["wall_s"]
            s_wall = stat[0]["extra"]["grid_wall_s"]
            layout = "flat" if args.assoc == 0 else f"{args.assoc} ways"
            print(f"phase 48 HC {trace}: C={args.capacity} {layout}, {n} "
                  f"accesses; adaptive hits {a['hits']} ({a['hit_ratio']:.6f}"
                  f"), final quota {a['extra']['final_quota']}, {nep} climbs, "
                  f"{n_adapt} launches, wall {a_wall:.3f} s, "
                  f"{n / a_wall:,.0f} acc/s; best static wf="
                  f"{best['extra']['window_frac']:.2f} hits {best['hits']} "
                  f"({best['hit_ratio']:.6f}, gap "
                  f"{a['hit_ratio'] - best['hit_ratio']:+.6f}), the five "
                  f"static runs {n_static} launches, wall {s_wall:.3f} s "
                  f"({s_wall / len(stat):.3f} s and "
                  f"{n * len(stat) / s_wall:,.0f} acc/s each); == the "
                  f"reference CLI's hits, quota and trajectory; the CLI "
                  f"{t1 - t0:.3f} s (adaptive part {t_sweep - t0:.3f} s); "
                  f"card {card}")
            print(f"phase 48 HC {trace} CLI: "
                  f"{out.getvalue().splitlines()[-2]}")
            if args.assoc:
                bounds[trace] = hc_bounds(args, n_adapt, n_static // len(stat))
        table = adaptive_table(str(work))
        check(tuple(table.splitlines()) == HC_TABLE,
              f"HC: adaptive_table\n{table}\n!= the reference's\n"
              + "\n".join(HC_TABLE))
    finally:
        device_simulate.simulate_sweep = real_sweep
        shutil.rmtree(work, ignore_errors=True)
    for line in table.splitlines():
        print(f"phase 48 HC adaptive_table: {line}")
    phase_s = time.perf_counter() - t48
    print(f"phase 48 HC: launches {launches}, climbs {climbs}; "
          f"{phase_s:.1f} s")
    return launches, {"pins_equal": True, "table_equal": True,
                      "climbs": climbs, "bound_ms": bounds,
                      "phase_s": phase_s}


def hc_bounds(args, n_adapt, n_static):
    """The step kernel's bound (``bound_bytes``) per launch of an HC run's
    adaptive part (one launch a climb epoch) and of its first static run
    (window 0.01, one launch a 512-access chunk), in ms."""
    from repro_torch.core.device_simulate import DeviceWTinyLFU
    from repro_torch.launch import hillclimb
    tr = hillclimb.make_trace(args.trace, args.length, args.seed)
    out = {}
    for part, adaptive, chunk, nl in (("adaptive", True, args.epoch_len,
                                       n_adapt),
                                      ("static", False, 512, n_static)):
        wf = args.window_frac if adaptive else hillclimb.STATIC_WFS[0]
        cfg = DeviceWTinyLFU(args.capacity, assoc=args.assoc,
                             window_frac=wf, adaptive=adaptive)
        total, _, _ = bound_bytes(cfg.spec(), tr, chunk, cfg.sample_size)
        out[part] = total / nl / HBM_BYTES_PER_S * 1e3
        print(f"phase 48 HC {args.trace} bound, {part}: {total} bytes over "
              f"the run = {total / nl:.0f} bytes per launch over 3.35 TB/s "
              f"= {out[part]:.6f} ms")
    return out


PL_CHUNKS = 100                 # F's chunks that phase 49 lints


def lint_child(out: str) -> int:
    """Phase 49's work, in a fresh process (see :func:`lint_phase49`): on a
    one-rank NCCL group it makes and destroys, as phases 46-47 do, with the
    counts set to 0 just before and read just after, ``run_matrix`` on the
    card, R7 on the card and F's geometry over its first ``PL_CHUNKS``
    chunks; writes what it found to ``out`` as JSON."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.analysis import program_lint as pl
    from repro_torch.traces.synthetic import zipf_trace
    n = PL_CHUNKS * F_CHUNK
    f_trace = zipf_trace(F_ACCESSES, n_items=1_000_000, alpha=0.9,
                         seed=11)[:n]
    CKPT_WORKDIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="lint-", dir=CKPT_WORKDIR))
    dist.init_process_group("nccl", store=dist.FileStore(
        f"{work}/store", 1), rank=0, world_size=1)
    try:
        torch.cuda.synchronize()
        set_launches(0)
        violations, rows = pl.run_matrix(device="cuda")
        fp_violations, notes = pl.check_fingerprints(device="cuda")
        t_f = time.perf_counter()
        (run,), f_bounds = pl.engine_program(
            dict(capacity=F_CAPACITY, assoc=F_ASSOC), "cuda",
            trips=(F_CHUNK,), trace=f_trace)
        f_s = time.perf_counter() - t_f
        torch.cuda.synchronize()
        got = read_launches()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    chunks = pl._scopes(run.events).chunks
    Path(out).write_text(json.dumps({
        "rows": rows, "violations": [v.to_dict() for v in violations],
        "fp_violations": [v.to_dict() for v in fp_violations],
        "notes": notes, "env": pl.env_key("cuda"),
        "contracts": len(pl.FINGERPRINT_CONTRACTS), "launches": got,
        "f": {"violations": [str(v) for v in pl.lint_program(
                  [run], f_bounds, "F geometry")],
              "reads": sum(len(pl._ops(ev, "host_read")) for ev in chunks),
              "launches": len(pl._launches(run.events)),
              "kernels": run.kernels, "aborted": run.aborted,
              "redone": run.redone, "accesses": n,
              "per_chunk": sorted({len(pl._ops(ev)) for ev in chunks}),
              "ops": len(pl._ops(run.events)), "seconds": f_s}}))
    return 0


def lint_phase49(card):
    """Phase 49: PL, the program lint on the card (see the module
    docstring).  Its recordings are profiled, and in a process that has
    run the earlier phases' long profiler sessions a short session lost
    kernel records now and then (one session in 37 in each of two whole
    runs of this script; none in 111 in fresh processes), so the phase runs
    in a fresh process (:func:`lint_child`), which this one waits for.
    Returns the step kernel's launch count over the phase and the checks
    for the kernels line."""
    t49 = time.perf_counter()
    CKPT_WORKDIR.mkdir(exist_ok=True)
    out = CKPT_WORKDIR / "lint49.json"
    out.unlink(missing_ok=True)
    child = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import chip_smoke; sys.exit(chip_smoke.lint_child(sys.argv[2]))",
         str(ROOT), str(out)], capture_output=True, text=True, timeout=600)
    check(child.returncode == 0 and out.exists(),
          f"PL: the lint process exited {child.returncode}:\n"
          f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
    res = json.loads(out.read_text())
    rows, got, f = res["rows"], res["launches"], res["f"]
    for r in rows:
        print(f"phase 49 PL {r['label']}: {r['status']}, chunk lengths "
              f"{r['trips']}, launches {r['launches']}, profiled "
              f"sketch_step kernels {r['kernels']}, recorded ops {r['ops']}, "
              f"profiler sessions redone {r['redone']}, {r['seconds']:.2f} s")
    check(not res["violations"], "PL: the engine on the card breaks a lint "
          "rule:\n" + "\n".join(str(v) for v in res["violations"]))
    check(all(r["status"] == "ok" and r["kernels"] == r["launches"]
              for r in rows), f"PL: a row is not clean or its profiled "
          f"kernels differ from its launches: {rows}")
    check(len(rows) == 15, f"PL: {len(rows)} matrix entries, expected 15")
    for note in res["notes"]:
        print(f"phase 49 PL fingerprints: {note}")
    check(not res["fp_violations"], f"PL R7 on the card: "
          f"{res['fp_violations']}")
    print(f"phase 49 PL R7: the {res['contracts']} contracts record the "
          f"base's program on the card [{res['env']}]")
    check(not f["violations"] and not f["aborted"] and f["reads"] == 0
          and f["launches"] == f["kernels"] == PL_CHUNKS,
          f"PL F geometry: {f}")
    print(f"phase 49 PL F geometry: C={F_CAPACITY} assoc={F_ASSOC} W="
          f"{8 * F_CAPACITY}, {f['accesses']} accesses in chunks of "
          f"{F_CHUNK}: R0-R6 clean, {f['launches']} launches == "
          f"{f['kernels']} profiled sketch_step kernels, {f['reads']} host "
          f"reads in the chunk loop under set_sync_debug_mode('error'), "
          f"engine ops per chunk {f['per_chunk']}, {f['ops']} recorded ops "
          f"in all, profiler sessions redone {f['redone']}; "
          f"{f['seconds']:.2f} s")
    pins = 2 * (1 + res["contracts"])           # two chunks a pin
    want = sum(n * (1 + d) for r in rows
               for n, d in zip(r["launches"], r["redone"]))
    want += pins + PL_CHUNKS * (1 + f["redone"])
    check(got["sketch_step"] == want and sum(got.values()) == want,
          f"PL: launches {got}, expected {want} of the step kernel only "
          f"(the matrix's, {pins} of the R7 pins, {PL_CHUNKS} of F's)")
    phase_s = time.perf_counter() - t49
    print(f"phase 49 PL: {got['sketch_step']} step launches (counted in the "
          f"lint process); {phase_s:.1f} s with the process's start; card "
          f"{card}")
    return got["sketch_step"], {
        "entries": len(rows), "violations": 0,
        "kernels_equal_launches": True, "r7_pairs_equal": True,
        "f_geometry_host_reads": f["reads"],
        "f_geometry_launches": f["launches"], "phase_s": phase_s}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.device_simulate import DeviceWTinyLFU, simulate_trace
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.traces.synthetic import (zipf_trace,
                                              scan_then_hotspot_trace)

    # -- phase 1: card, build --------------------------------------------
    card = card_line()
    print(card)
    t_start = t0 = time.perf_counter()
    # one nvcc per source, all at once; the step kernel's adaptive instances
    # (kernel mode 1c) and its panel's (mode 1d) are a second and a third
    # build of its source
    builds = [(name, ()) for name in SOURCES + PROBES] + [
        ("sketch_step", ks.ADAPTIVE_DEFINES),
        ("sketch_step", ks.PANEL_DEFINES),
        ("sketch_reset", NO_PDL), ("sketch_estimate", NO_PDL)]
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda job: _build.load_library(*job), builds))
    print(f"phase 1  build of {len(builds)} sources in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name, defines in builds:
        info = _build.build_info[(name, defines)]
        label = name + {(): "", ks.ADAPTIVE_DEFINES: " adaptive",
                        ks.PANEL_DEFINES: " panel",
                        NO_PDL: " no-PDL"}[defines]
        nvcc = (f"nvcc {info['seconds']:.1f} s" if info["seconds"]
                else "built before; its ptxas log was kept")
        print(f"phase 1  {label}: {nvcc}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1  {label} ptxas:", line.strip())
    flash_ptxas_phase1()

    def elapsed(what):
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {what}",
              flush=True)

    # -- phase 2: kernel vs plain on the card ------------------------------
    zipf = zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7)
    scanhot = scan_then_hotspot_trace()
    f_trace = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    cases = [
        ("flat cb4 dk", DeviceWTinyLFU(200, sample_factor=2), zipf[:1500],
         256),
        ("flat cb8 no-dk", DeviceWTinyLFU(150, sample_factor=3, counter_bits=8,
                                          doorkeeper=False),
         scanhot[24_500:25_900], 500),
        ("assoc4 cb4 dk", DeviceWTinyLFU(300, sample_factor=1, assoc=4),
         zipf[:1500], 512),
        ("assoc8 cb8 dk", DeviceWTinyLFU(250, sample_factor=2, assoc=8,
                                         counter_bits=8),
         zipf[5000:6300], 256),
        ("assoc8 cb4 no-dk", DeviceWTinyLFU(200, sample_factor=2, assoc=8,
                                            doorkeeper=False),
         scanhot[24_800:26_000], 384),
    ]
    for i, (name, kw, pargs, wcap, mcap, kind, n,
            chunk) in enumerate(HAZARD_CASES):
        cases.append((f"hazard: {name}", (ks.StepSpec(**kw), pargs, wcap,
                                          mcap),
                      hazard_keys(kind, n, seed=i), chunk))
    jobs = [submit_plain(chunk_case, cfg, tr, chunk)
            for _, cfg, tr, chunk in cases]
    max_err = 0
    for (name, cfg, tr, chunk), job in zip(cases, jobs):
        max_err = max(max_err, compare_case(name, cfg, tr, chunk, job)[0])
    f_cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC)
    err, plain_ms = compare_case("F geometry", f_cfg, f_trace[:2 * F_CHUNK],
                                 F_CHUNK)
    max_err = max(max_err, err)

    # -- phase 3: golden traces through the entry point --------------------
    traces = {"zipf": zipf, "scanhot": scanhot}
    ks.step.launches = 0
    for name, tr, cap, assoc, warmup, hits, regs, dig in GOLDEN:
        t0 = time.perf_counter()
        res, state, _ = simulate_trace(traces[tr], cap, warmup=warmup,
                                       assoc=assoc, chunk=F_CHUNK,
                                       trace_name=tr, return_state=True)
        check(res.hits == hits, f"{name}: hits {res.hits} != JAX {hits}")
        if regs is not None:
            got = state["regs"].cpu().tolist()
            check(got == regs, f"{name}: regs {got} != JAX {regs}")
            check(digest(state) == dig,
                  f"{name}: state digest {digest(state)} != JAX {dig}")
        also = "" if regs is None else ", regs and digest equal"
        print(f"phase 3  {name}: C={cap} assoc={assoc} hits {res.hits}/"
              f"{res.accesses} == JAX{also} ({time.perf_counter() - t0:.2f} s)")
    check(ks.step.launches > 0, "golden runs launched no kernel")

    # -- phase 4: F, the main path at its real size ------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ks.step.launches = 0
    t0 = time.perf_counter()
    e0.record()
    res, state, hit_flags = simulate_trace(
        f_trace, F_CAPACITY, warmup=F_WARMUP, assoc=F_ASSOC, chunk=F_CHUNK,
        trace_name="zipf-1.2M", return_state=True)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ks.step.launches
    dev_ms = e0.elapsed_time(e1)
    nchunks = math.ceil(len(f_trace) / F_CHUNK)
    check(launches == nchunks,
          f"F: {launches} kernel launches, expected {nchunks}")
    regs = state["regs"].cpu().tolist()
    check(res.hits == F_HITS, f"F: hits {res.hits} != JAX {F_HITS}")
    check(regs == F_REGS, f"F: regs {regs} != JAX {F_REGS}")
    check(digest(state) == F_DIGEST,
          f"F: state digest {digest(state)} != JAX {F_DIGEST}")
    check(int(hit_flags[F_WARMUP:].sum()) == F_HITS and hit_flags.shape[0]
          == len(f_trace), "F: hit flags disagree with the hit register")
    print(f"phase 4  F: C={F_CAPACITY} assoc={F_ASSOC} hits {res.hits}/"
          f"{res.accesses} ratio {res.hit_ratio:.6f}, regs and digest == JAX")
    print(f"phase 4  F: wall {wall:.3f} s, {len(f_trace) / wall:,.0f} acc/s "
          f"(host clock around simulate_trace, trace upload and hashing "
          f"included); stream {dev_ms:.1f} ms between CUDA events around the "
          f"call; launches {launches}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes; card {card}")

    # -- phase 5: kernel time per launch, device idle share ---------------
    t_state, t_hits, step_launch_ms, stream_ms, _ = timed_launches(
        f_trace, f_cfg, F_CHUNK, F_WARMUP)
    check(t_state["regs"].cpu().tolist() == F_REGS
          and digest(t_state) == F_DIGEST
          and bool((t_hits == hit_flags).all()),
          "F: the timed run differs from the main run")
    ms_chunk = sum(step_launch_ms) / len(step_launch_ms)
    idle = 1.0 - sum(step_launch_ms) / stream_ms
    print(f"phase 5  F: kernel {ms_chunk:.4f} ms per launch (CUDA events "
          f"around each of {len(step_launch_ms)} launches; min "
          f"{min(step_launch_ms):.4f}, max {max(step_launch_ms):.4f}), "
          f"{ms_chunk * 1e6 / F_CHUNK:.0f} ns/access; runner stream "
          f"{stream_ms:.1f} ms, device idle share {idle:.6f}")

    # -- phase 6: bound ----------------------------------------------------
    spec = f_cfg.spec()
    total, resets, size = bound_bytes(spec, f_trace, F_CHUNK,
                                      f_cfg.sample_size)
    check(size == F_REGS[0], f"F: reset count model ends at size {size}, "
          f"the kernel at {F_REGS[0]}")
    bound_ms = total / launches / HBM_BYTES_PER_S * 1e3
    print(f"phase 6  bound: {total} bytes over F ({resets} resets) = "
          f"{total / launches:.0f} bytes/chunk over 3.35 TB/s = "
          f"{bound_ms:.6f} ms/chunk; kernel is {ms_chunk / bound_ms:.0f}x "
          f"above it (a dependent per-access chain: latency-bound)")

    # -- phase 7: the sketch kernels vs plain on the card ------------------
    errs, s_plain_ms, add_probes = sketch_phase7(f_trace)

    # -- phase 8: S, the batched sketch ops at real size ------------------
    s_launches, s_ms, s_batches = sketch_phase8(f_trace, card)

    # -- phase 9: P1 and P2, the serving path through PrefixCache ---------
    p_rates = serving_phase9(card)

    # -- phase 10: the sketch kernels' bounds -------------------------------
    from repro_torch.kernels.ops import make_config
    s_cfg = make_config(S_BLOCKS)
    nbytes = sketch_bound_bytes(s_cfg, s_batches, f_trace[:S_DECISIONS])
    probe_ops = HASH_OPS_PER_PROBE * (s_cfg.rows + s_cfg.dk_probes)
    nops = {"sketch_update": probe_ops * S_BATCH,
            "sketch_estimate": probe_ops * S_DECISIONS,
            "admission": 2 * probe_ops * S_DECISIONS,
            "sketch_reset": 2 * s_cfg.rows * s_cfg.words_per_row}
    bounds = {}
    for k in SKETCH_KERNELS:
        b_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
        o_ms = nops[k] / F32_OPS_PER_S * 1e3
        bounds[k] = (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else
                     "operations")
        print(f"phase 10 bound {k}: {nbytes[k]:.0f} bytes per launch over "
              f"3.35 TB/s = {b_ms:.6f} ms; {nops[k]} 32-bit ops over "
              f"67 T/s = {o_ms:.6f} ms; kernel {s_ms[k]:.4f} ms is "
              f"{s_ms[k] / bounds[k][0]:.0f}x above the larger")
    stats = add_schedule_stats(f_trace, s_cfg)
    tiles = [t for batch in stats for t in batch]
    chain = max(max(t[2] for t in batch) for batch in stats)
    several = max(t[3] for t in tiles)
    print(f"phase 10 add schedule of S (check_runs.add_schedule, the numpy "
          f"model; its final state == S's pin): per {ADD_TILE}-key tile "
          f"{np.mean([t[0] for t in tiles]):.1f} gated keys in "
          f"{np.mean([t[1] for t in tiles]):.1f} components; longest "
          f"sequential chain (the largest component's keys) {chain} in a "
          f"tile, {max(sum(t[2] for t in batch) for batch in stats)} over a "
          f"{S_BATCH}-key batch's {-(-S_BATCH // ADD_TILE)} tiles in order; "
          f"largest component of several keys {several}; beside the bound "
          f"{bounds['sketch_update'][0]:.6f} ms and the kernel's "
          f"{s_ms['sketch_update']:.4f} ms")
    floor = launch_floor_us()
    print(f"phase 10 launch floor: an empty launch (l2_chase, 0 steps) "
          f"{floor:.2f} us of device time; at S's shapes "
          + ", ".join(f"{k} {s_ms[k] * 1e3:.2f} us "
                      f"({s_ms[k] * 1e3 / floor:.1f}x)"
                      for k in SKETCH_KERNELS) + f"; card {card}")
    path_sweep(f_trace, s_cfg, card)
    redesign = redesign_phase10(f_trace, s_cfg, card)
    elapsed("phases 1-10")

    kernels = [{
        "name": "sketch_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_step.cu",
        "replaces": "src/repro/kernels/sketch_step.py:2314",
        "launches": launches, "max_abs_err": max_err,
        "matches_plain": max_err == 0, "ms": ms_chunk,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}]
    for k in SKETCH_KERNELS:
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k}.cu",
            "replaces": REPLACES[k], "launches": s_launches[k],
            "max_abs_err": errs[k], "matches_plain": errs[k] == 0,
            "ms": s_ms[k], "plain_ms": s_plain_ms[k],
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": None, **redesign.get(k, {})})

    # -- phases 11-13: the LLM serving path ------------------------------
    flash_err = flash_phase11()
    flash_launches, l_err, flash = llm_phase12(card)
    flash_err = max(flash_err, l_err)
    gc.collect()
    torch.cuda.empty_cache()
    llm_phase13(card)
    gc.collect()
    torch.cuda.empty_cache()
    elapsed("phases 11-13")

    # -- phases 14-18: tenant lanes, sweeps, the host sketch ---------------
    lane_err = lanes_phase14()
    tr = t_trace(f_trace)
    t_launches, t_ms, t_bound_ms = tenant_phase15(tr, card)
    scaling_phase16(tr, card)
    del tr
    sweep_phase17(f_trace, card)
    host_phase18(card, p_rates)
    elapsed("phases 14-18")

    # -- phases 19-22: the sharded sketch (kernel mode 1b) -----------------
    shard_err, shard_plain_ms = sharded_phase19()
    f4_launches, f4_ms, f4_bound_ms = f4_phase20(
        f_trace, zipf, card, ms_chunk * 1e6 / F_CHUNK)
    tr = t_trace(f_trace)
    t4_phase21(tr, card)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    w4_phase22(f_trace, card)
    elapsed("phases 19-22")

    # -- phases 23-27: the adaptive window (kernel mode 1c) ----------------
    adapt_err, adapt_plain_ms = adaptive_phase23()
    f_ns = ms_chunk * 1e6 / F_CHUNK
    fa_launches, fa_ms, fa_bound_ms, fa_climb_ms = adaptive_run(
        "FA", f_trace, card, f_ns,
        (FA_HITS, FA_REGS, FA_DIGEST, FA_QUOTA, FA_TRAJ))
    adaptive_run("FA4", f_trace, card, f_ns,
                 (FA4_HITS, FA4_REGS, FA4_DIGEST, FA4_QUOTA, FA4_TRAJ),
                 shards=SHARDS)
    wa_phase26(f_trace, card)
    ga_phase27(card)
    elapsed("phases 23-27")

    # -- phases 28-31: the policy panel (kernel mode 1d) -------------------
    panel_err, panel_plain_ms = panel_phase28()
    fp = fp_phase29(f_trace, card, wall, f_ns)
    gp_phase30(zipf, scanhot, card)
    wp_phase31(f_trace, card)
    elapsed("phases 28-31")

    # -- phases 32-35: checkpoint/resume and faults on the step kernel -----
    import shutil
    import tempfile
    CKPT_WORKDIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="checkpoints-", dir=CKPT_WORKDIR))
    try:
        ckpt = ckpt_phase32(f_trace, card, work)
        kill_ok = kill_phase33(f_trace, card, work)
        drills_ok = fault_phase34(card)
        cross_ok = cross_phase35(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    elapsed("phases 32-35")

    # -- phases 36-37: the mesh (kernel mode 1e), wide instances, exact -----
    step12_err, step12_rows = step12_phase36(card)
    mesh_launches, mesh_ms, mesh_bound_ms, mesh_fold_ms, nccl_s = \
        mesh_phase37(f_trace, card, f4_ms, f4_bound_ms)
    elapsed("phases 36-37")

    # -- phase 38: PF, the paper's trace families; the host engine ---------
    pf_phase38(card)
    elapsed("phase 38")

    # -- phases 39-41: the serving families ---------------------------------
    fam_phase39(card)
    fam_phase40(card)
    cells = serve_phase41(card)
    elapsed("phases 39-41")

    # -- phases 42-45: training -------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    fb = fb_phase42(card)
    CKPT_WORKDIR.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train-", dir=CKPT_WORKDIR))
    try:
        tf_phase43(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    trp_phase44(card)
    gc.collect()
    torch.cuda.empty_cache()
    tr_launches, tr_kernels, tr = tr_phase45(card, fb)
    elapsed("phases 42-45")

    # -- phases 46-47: sharded training, the collectives --------------------
    gc.collect()
    torch.cuda.empty_cache()
    t46 = time.perf_counter()
    cpu_comp, cpu_pipe = collectives_cpu()
    import torch.distributed as dist
    from repro_torch.distributed.mesh import make_debug_mesh
    work = Path(tempfile.mkdtemp(prefix="trs-", dir=CKPT_WORKDIR))
    dist.init_process_group("nccl", store=dist.FileStore(
        f"{work}/store", 1), rank=0, world_size=1)
    try:
        grid = make_debug_mesh((1, 1))
        check(grid.device.type == "cuda" and grid.size == 1,
              f"phase 46 grid {grid}")
        trs_launches, trs = trs_phase46(card, tr, grid)
        collectives_phase47(card, grid, cpu_comp, cpu_pipe)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    print(f"phases 46-47: {time.perf_counter() - t46:.1f} s")
    elapsed("phases 46-47")

    # -- phase 48: HC, the window-adaptation CLI at its defaults -----------
    hc_launches, hc_checks = hc_phase48(card)
    elapsed("phase 48")

    # -- phase 49: PL, the program lint on the card --------------------------
    pl_launches, pl_checks = lint_phase49(card)
    elapsed("phase 49")
    err = max(max_err, lane_err, shard_err, adapt_err, panel_err,
              step12_err)
    kernels[0].update(modes=["flat", "set", "1a lanes", "1b sharded",
                             "1c adaptive", "1d panel", "1e stale mesh",
                             "wide (> 8 probes, > 128 ways)",
                             "exact (out-of-range table addresses)"],
                      mesh_launches=mesh_launches, mesh_ms=mesh_ms,
                      mesh_bound_ms=mesh_bound_ms,
                      mesh_fold_ms=mesh_fold_ms, nccl_start_s=nccl_s,
                      mesh_max_abs_err=step12_err,
                      instances=step12_rows,
                      max_abs_err=err, matches_plain=err == 0,
                      lane_launches=t_launches, lane_max_abs_err=lane_err,
                      lane_ms=t_ms, lane_bound_ms=t_bound_ms,
                      sharded_launches=f4_launches,
                      sharded_max_abs_err=shard_err, sharded_ms=f4_ms,
                      sharded_plain_ms=shard_plain_ms,
                      sharded_bound_ms=f4_bound_ms,
                      adaptive_launches=fa_launches,
                      adaptive_max_abs_err=adapt_err, adaptive_ms=fa_ms,
                      adaptive_plain_ms=adapt_plain_ms,
                      adaptive_bound_ms=fa_bound_ms,
                      adaptive_climb_ms=fa_climb_ms,
                      hillclimb_launches=hc_launches, hillclimb=hc_checks,
                      program_lint_launches=pl_launches,
                      program_lint=pl_checks,
                      panel_launches={p: v[0] for p, v in fp.items()},
                      panel_max_abs_err=panel_err,
                      panel_ms={p: v[1] for p, v in fp.items()},
                      panel_plain_ms=panel_plain_ms,
                      panel_bound_ms={p: v[2] for p, v in fp.items()},
                      checkpoint={
                          "saves": {k: v["saves"] for k, v in ckpt.items()},
                          "overhead_vs_plain": {
                              k: v["overhead_vs_plain"]
                              for k, v in ckpt.items()},
                          "save_ms": {k: v["save_ms"]
                                      for k, v in ckpt.items()},
                          "bytes": {k: v["bytes"] for k, v in ckpt.items()},
                          "resume_ok": True, "kill_resume_ok": kill_ok,
                          "fault_drills_ok": drills_ok,
                          "cross_device_ok": cross_ok})
    kernels[1].update(dk_probes_held=sorted(set(add_probes)
                                            | set(LOOP_PROBES)))

    # -- phase 50: the kernels line ----------------------------------------
    flash_err = max([flash_err] + [fl["max_abs_err"]
                                   for _, fl in cells.values() if fl])
    for k in kernels[1:]:
        k["serving_launches"] = {cell: launches[k["name"]]
                                 for cell, (launches, _) in cells.items()}
    from repro_torch.check_runs import FB_TOL
    fwd, bwd = fb["forward with LSE"], fb["backward"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "launches": flash_launches + tr_launches[0] + trs_launches[0] + sum(
            launches["flash_attention"] for launches, _ in cells.values()),
        "max_abs_err": max(flash_err, fb["forward_max_abs_err"]),
        "matches_plain": max(flash_err, fb["forward_max_abs_err"])
        <= FLASH_TOL,
        **flash, "L_launches": flash_launches,
        "cells": {cell: dict(launches=launches["flash_attention"], **fl)
                  for cell, (launches, fl) in cells.items() if fl},
        "train_instance": dict(TR_launches=tr_launches[0],
                               TRS_launches=trs_launches[0],
                               lse_max_abs_err=fb["lse_max_abs_err"],
                               **{k: v for k, v in fwd.items()},
                               **tr_kernels["forward with LSE"])})
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:69",
        "replaces_note": "no TPU kernel: the VJP JAX takes of the "
                         "reference's jnp flash_attention",
        "launches": tr_launches[1] + trs_launches[1],
        "TR_launches": tr_launches[1], "TRS_launches": trs_launches[1],
        "max_abs_err": fb["max_abs_err"],
        "max_rel_err": fb["max_rel_err"],
        "matches_plain": fb["max_rel_err"] <= FB_TOL,
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"], "tflops": bwd["tflops"],
        **tr_kernels["backward"], "TR_run": tr, "TRS_run": trs})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        for pool in _POOL:
            pool.shutdown(cancel_futures=True)
