#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its hand-written
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

It puts `src/` on the import path, builds the CUDA kernels from
`src/repro_torch/kernels/csrc/` with nvcc, and runs these phases, each
printing one JSON line:

  device     the card's name and the nvidia-smi name and power limit
  build      nvcc seconds (one nvcc a source, all started together: abc_sim
             has one source a model; and the CUDA-core float32 kernel of
             experiments/ beside them) and the build's wall, each kernel's
             registers, shared memory, stack and spills (every variant of
             abc_sim for each model, flat and regional: the local memory of
             a regional sample is its stack), ptxas's wgmma warnings, the
             HGMMA instructions in each kernel's SASS (cuobjdump -sass), the
             TF32 ones of the float32 kernel, and the instruction census of
             abc_sim's day loop (kernels/sass.py): the main path's variant
             of both entries for SIARD and of the wave entry for sir, seir
             and seiard (SIARD under a schedule runs the same function), and
             each step of the regional wave entry of metapop_seir on both
             routes (`sass.regional_census`, `sass.regional_warp_census`),
             each a sample-day held to `CENSUS_PER_DAY` (checked after the
             last phase, before the kernels line);
             the warp route's kernels (csrc/abc_sim_regional_warp.cuh) must
             show 0 bytes of stack and no spills
  rng        the kernel's hash bits and normals against the plain twin, and
             its branch-free Box-Muller pieces against logf, sqrtf and cosf
             on every one of the 2^24 uniforms the hash can give (bitwise)
  abc_sim    both entries of the fused kernel against the plain version,
             bitwise: the theta-in entry on the r1 pins (and siard/pallas),
             a synthetic series, Italy at 100,000 x 49 days and every flat
             (summary, distance) pair; the wave entry, which draws theta
             itself, against prior.sample + the plain version on the same
             inputs (theta and distances); block sizes 64/128/256. Then sir,
             seir and seiard, both entries bitwise the plain version on the
             pins (and the theta-in entry `{model}/pallas`), at 1024 x 49
             and 100,000 x 49 (sir and seir on synthetic_small drawn for the
             model, seiard on Italy); each model under two intervention
             schedules at 1024 x 49; a lockdown-day sweep of three
             breakpoint days through the loaded libraries, with no rebuild;
             and SIARD and seiard on Italy at 100,000 x 49 under the
             schedule_path phase's intervention. Then the region axis
             (csrc/abc_sim_regional.cuh), both entries bitwise the plain
             version: metapop_seir (R=4, ring:0.1) at 1024 and 100,000 x 49
             for (identity, euclidean), (region_pooled, euclidean) and
             (log_weekly, mae); under a one-window schedule; seir and siard
             regionalized to R=3 (uncoupled); R=10 and R=100 at 1024 x 49;
             and a sweep of three mobility matrices through the loaded
             library, with no rebuild (each through the route that
             `abc_sim.regional_route` picks); then each route (thread, warp,
             tile), each entry, at R = 4, 10, 100 and 128 (1024 x 49), R=100
             pooled, and R=100 at regions_path's 100,000 x 49
  gate       every gated entry (the flat wave and theta-in entries of each
             model, the regional ones of each route at R=4 and R=100)
             launched with a gate of 0 into buffers filled with a sentinel,
             which stay bitwise unchanged; with a gate of 1 bitwise the
             ungated launch; a gate on the CPU refused
  main_path  `repro_torch.launch.abc_run.main` on Italy at the paper's batch
             and horizon, with the launch counters set to 0 just before:
             on the device wave loop (auto) 1 + waves + gated launches of the
             wave entry, fewer than SEGMENT_WAVES gated and at most
             ceil(waves / SEGMENT_WAVES) host syncs, no theta-in launch, no
             host prior draw on the card, no plain-version call
  models_path  the same CLI with --model seiard: 1 + waves launches of
             abc_sim_wave_seiard and nothing else; a posterior in the box
             whose mean is nearer SIARD's generating parameters than the
             prior mean
  schedule_path  the main path's run with --intervention "alpha0@25=0:2":
             the same counters, 9 posterior columns, the last alpha0_w1
  metapop_path  the CLI with --model metapop_seir on its synthetic_small
             series at the paper's batch: 1 + waves launches of
             abc_sim_regional_wave_metapop_seir and nothing else, a posterior
             in the box
  regions_path  the same run with --regions 100 --mobility ring:0.1 (the
             README's 100-region case, 200 observed channels), the same
             counters, of abc_sim_regional_wave_warp_metapop_seir: the warp
             route carries it (metapop_path, R=4, the thread route)
  wave_loop  each of the five ABC paths above with --wave-loop host and with
             --wave-loop device (host, device, device, host): the posteriors
             bitwise equal (theta, distances, runs, simulations), both times
             to posterior
  profile    the main path's waves once more under torch.profiler, on each
             loop (host, device, device, host): wall time, device busy time,
             idle share, device operations a wave, the kernel's and the
             copies' device ms and the rest (the device loop's gate,
             comparison and compaction) a wave; then the compaction at
             100,000 rows: the kernel (compact_accepted on the card) bitwise
             the plain lines it replaced (core.abc.compact_plain) on the
             wave's accept mask, a gated one and a dense one past the
             capacity, each one's device us by CUDA events (100 calls
             queued behind a sleep of the card), and the kernel's bound
  no_sync    one segment of the main path's device loop under
             torch.cuda.set_sync_debug_mode("error"), its accepted set
             bitwise the main path's
  smc_path   `run_smc_abc` of SIARD on Italy at 100,000 x 49, 1,000
             particles, 4 rounds, quantile 0.5, on the device round: the
             tolerance falls every round, the particles are finite and in the
             box, the posterior mean is nearer the generating parameters
             than the prior mean, and the theta-in entry made waves + gated
             launches (one wave-entry launch for round 0), with no plain
             call and no host prior draw
  campaign_path  `abc_run --campaign` over Italy, New Zealand and the USA x
             (siard, seiard, sir) at 100,000 x 49 with the counters set to 0
             just before: 6 cells ok and 3 skipped (sir observes (I, R)) in 2
             shape-cache entries; each ok cell's launches its pilot, its
             waves and its gated waves, its host syncs one a segment; the
             same command again: every ok cell resumed_complete with 0
             launches; each ok cell's solo run (calibrate_tolerance +
             run_abc on the device loop, its seed) bitwise the cell's
             checkpointed rows, with its tolerance, runs and simulations;
             a lockdown sweep on Italy (alpha0 pinned at 0.4 or 0.8 from day
             20 or 30; 1 shape, the pinned scale back); two seeds of
             metapop_seir at R=100 (ring:0.1) at 20,000 x 49 (1 shape, the
             warp route). Prints each campaign's wall, the resume's, the
             grid's again into a new directory after the solo runs (warm),
             the sum of the solo walls, and each cell's waves, gated
             launches and host syncs
  forecast_path  the README's forecast, `abc_run --dataset italy --days 49
             --intervention "alpha0@20=0:2" --auto-tolerance 1e-3 --forecast
             28` at 100,000 a wave, with the counters set to 0 just before
             (the fit's launches as main_path's; the forecast launches no
             abc_sim entry): its wall, the forecast's seconds and share of
             it; the bands strict JSON of 77 days that do not cross and
             equal to `core.serving.forecast_bands` called directly on the
             posterior; that call again warm and once under torch.profiler
             (kernel launches, device busy time, idle share)
  epi_serve  `serve --epi` and `abc_serve` on the card, each part counted
             from 0, every on-demand fit's launches the device SMC round's
             (a cold fit one wave-entry launch, a warm one one theta-in
             launch, then waves + gated theta-in launches) and the query
             path none: (a) the README's 3-country example (Italy, New
             Zealand, the USA at horizon 14, Italy's counterfactual
             alpha@25=0.5) at the CLI's defaults with a store, cold (3 fits)
             and again (0 fits), 2 batched calls over 2 shapes; (b) the same
             queries at the paper's width (49 days, fits of 1,000 particles
             x 100,000 x 4 rounds, 1,000 forecast particles, 8 slots) for 4
             seeds, 16 queries in 3 batched calls, cold and again; every
             response of (a) and (b) dict-equal to sequential
             `forecast_bands` from the stored posterior (padded chunks
             included); one batched call of 8 lanes alone (wall, launches
             and device busy time under torch.profiler), each lane bitwise
             `simulate_observed` alone, and particle 0's trajectory over
             the 49 fitted days fed to the theta-in entry as the observed
             series: particle 0 at exactly 0.0, every other particle within
             rtol 1e-6 of numpy's norm of its difference; (c) `abc_serve
             --once` over the three countries as dataset files (3 cold
             fits), one file's last day changed, a second sweep: 1 warm
             re-fit, its simulations and final tolerance beside its cold
             fit's; (d) tests/check_epi_serve.py's sir toy: 1 fit (which
             launches abc_sim_distance_sir), 8 queries from the store in at
             most 2 batched calls with 0 fits, bands that do not cross
  npe_path   the amortized backend (`core.npe`, plain PyTorch: `repro`'s
             NPE path reaches no Pallas kernel), each NPE part counted from
             0 and held to no abc_sim launch and no plain-version call: (a)
             `npe_demo` (sir, 15 days; hidden 64, 4 components, batch 256,
             300 steps, pilot 512) trained twice with seed 0, weights and
             256 draws bitwise equal; the card's weights on the CPU: the
             forward (log_pi, mu, sigma) within rtol 1e-5, atol 1e-5,
             log_prob at the draws within rtol 1e-5, atol 1e-4 (a narrow
             component carries mu's rounding times 1/sigma) and the draws
             within atol 1e-5 of the card's; the train wall, a step's wall, kernel
             launches, device busy time and idle share (torch.profiler; the
             simulation alone apart), no host sync in a step
             (torch.cuda.set_sync_debug_mode), and
             `sample_posterior`'s ms for 256 draws; (b)
             tests/test_posterior_recovery.py's bars for sir and seir on the
             port's own series at its truth, population and days: REL_TOL
             0.30, and against the port's CUDA ABC oracle (quantile 5e-3,
             its launches listed apart) ORACLE_DRIFT 0.25 and overlapping
             90% intervals; (c) `abc_serve --once --backend npe` (1 train),
             a second server (0 trains, from the store), a version change
             (1 fine-tune), then `serve --epi --backend npe` from the store
             (4 answers, 0 trains), fits 0 throughout with the SMC fitter
             made to fail; (d) `abc_run --backend npe` on main_path's SIARD
             series (Italy, 49 days) at npe_demo's width, its steps cut to
             `NPE_SIARD_STEPS` (printed)
  scaleout_path  scale-out on torch.distributed (`core.distributed`,
             `core.scaling`), its abc_sim launches counted from 0 a part:
             (a) the main path's config (Italy, 100,000 x 49, main_path's
             tolerance) through `distributed.make_wave_runner` in a world
             of 1 over NCCL: its posterior bitwise main_path's, waves +
             gated launches of abc_sim_wave_siard, one host sync a segment,
             warm time to posterior in turns with the unsharded loop, one
             run of each under torch.profiler (device busy time, idle
             share, device operations), and a count all-reduce's host and
             completion microseconds; (b) the
             lockstep reference on the card at tests/test_scaling.py's size
             (2048 x 12) for N = 2, 4, 8, each digest equal to that of N
             gloo ranks of the plain version on the CPU (8 spawned ranks,
             subgroups of the first N), and at 100,000 a shard x 49 days
             (sims/s a N, every shard on one card); (c) two gloo ranks
             sharing cuda:0 (NCCL refuses two ranks a card) at 100,000 a
             rank: their gathered segments and posterior bitwise the 2-shard
             reference, their walls (not a scaling figure); (d)
             `run_scaling_study` at n=1 (SIARD, 100,000 x 49, 8 waves, 3
             reps): the report; (e) `smc_path`'s SMC round sharded in the
             world of 1: two runs and smc_path's population bitwise equal;
             (f) a campaign of Italy and the USA x siard at 100,000 x 49
             with devices_per_scenario=2 on [cuda:0] * 4: groups "0+1" and
             "2+3", each cell bitwise its 2-shard reference run, the resume
             resumed_complete with 0 launches (writes under
             build/scaleout_path and removes it); then the pjit style
             (rank r draws rows [r·B/n, (r+1)·B/n) of the one wave): (g)
             every wave entry (siard, sir, seir, seiard, SIARD under a
             one-window schedule, metapop_seir on both routes) at sample
             offsets 0, 1, 4,096 and 50,000, 1,024 rows bitwise the rows
             of the offset-0 wave and its plain version at the offset on
             the card, and the wave entry at 100,000 x 49 at offsets 0 and
             50,000 in turns; (h) the main path's config in a world of 1
             over NCCL with style="pjit": its posterior bitwise
             main_path's, timed in turns with (a) and the unsharded loop;
             (i) 2 and 4 gloo ranks sharing cuda:0 in the pjit style, each
             rank's posterior bitwise main_path's; (j) metapop_seir at
             R=20 on 2 such ranks, whose 50,000 rows take the warp route
             where the single device's 100,000 take the thread route:
             bitwise the single-device run
  tuning_path  `core.tuning` and `repro_torch.analysis` on the card, the
             launch counters set to 0 just before: (a) the spec-derived
             cost model of siard, sir, seir, seiard, siard under a window
             and metapop_seir at R = 4 and 100 beside the kernel's hand
             count (`abc_sim.ops_per_sample_day`); (b) `autotune` of SIARD
             at 100,000 x 49 and metapop_seir R=100 at 20,000 x 49 into a
             cache under build/tuning_path: every candidate block's wall,
             the winner, best_batch; every candidate's wave and theta-in
             distances bitwise the default block's; a second call a hit
             with 0 launches; (c) `abc_run ... --autotune` at main_path's
             flags into a fresh cache: its posterior bitwise main_path's,
             then warm in turns with the untuned run; (d) `roofline_metrics`
             of the wave entry at 100,000 x 49 and of the warm main path,
             each efficiency in (0, 1.05]; (e) one device-loop segment under
             torch.cuda.set_sync_debug_mode("warn"): one synchronizing call;
             (f) `python -m repro_torch.analysis`: no finding
  timing     both entries at 100,000 and 1,000,000 x 49 days in turns, the
             wave entry at blocks 64/128/256 in turns, beside the operation
             bound, the issue floor from the census at the SM clock that
             nvidia-smi reads under load, and the plain version; then both
             entries of sir, seir, seiard and of SIARD under a one-window
             inferred schedule at the same sizes, in turns with SIARD's; then
             the regional wave entry of metapop_seir on both routes in turns
             (SIARD's flat one, thread, warp, then back) at R = 4, 10, 32 and
             100 (20,000 x 49) and R = 4 and 100 (100,000 x 49), beside its
             operation bound, each route's issue floor and the plain version
             (R=100 at both batches, R=4 at 100,000)
  flash      the flash-attention kernels against their plain version: bf16
             through the bf16 tensor-core kernel, float32 through the 3xTF32
             one (route counters), on the causal GQA shapes of
             tests/test_kernel_flash.py, window + softcap, non-causal
             cross-length, ragged 2047, rows with no allowed key, gemma-2b's
             prefill shape, D 72 and 20, a ragged Skv != Sq, and the prefill
             shapes of deepseek-moe-16b (16 heads over 16 kv heads, D 128)
             and qwen3-moe-30b-a3b (32 over 4, D 128), zamba2-2.7b's shared
             attention (32 over 32, D 80, padded to 128 in the kernel),
             internvl2-2b's (16 over 8), internlm2-20b's (48 over 8) and
             minitron-8b's (32 over 8, D 128) at 4 x 2048, and
             whisper-large-v3's three (20 over 20, D 64: the encoder's
             1,500 frames and the cross-attention of 187 tokens over them,
             non-causal, and the decoder's 187 causal); then a q sliced
             at an odd offset in each dtype, staged element by element
             (LAUNCHES_STAGED)
  lm_prefill full-width gemma-2b (bf16, weights from a generator seeded 0)
             prefills 4 x 2048 tokens through `ModelDef.prefill` with
             attn_impl="flash", the launch counters set to 0 just before
             (18 tensor-core launches); its logits against the same model
             with attn_impl="dense"
  lm_profile one flash prefill under torch.profiler: the flash kernel's
             device ms against the matrix products, and the idle share
  lm_serve   `repro_torch.launch.serve` LM mode at full width, its defaults
  lm_timing  the bf16 tensor-core kernel at (4, 2048) and (1, 8192) x 8
             heads, 1 kv head, D 256, causal, beside its bound, the plain
             version and torch's scaled_dot_product_attention; at the same
             shapes in float32 the 3xTF32 kernel in turns with the CUDA-core
             one it replaced (experiments/flash_f32_cuda_core.py), beside
             the 3xTF32 bound (and the 67 TFLOP/s one), the plain version
             and SDPA in float32; the kernels SDPA's float32 call launches,
             from one profiled call
  family_prefill  for mamba2-130m (ssm), zamba2-2.7b (hybrid), internvl2-2b
             (vlm), minitron-8b and internlm2-20b in turn, at full width and
             depth (bf16, weights from a generator seeded 0): a prefill of 4 x
             2048 tokens (internvl2-2b: 256 random patch rows, then 1,792
             tokens) through `ModelDef.prefill` with attn_impl="flash", the
             counters set to 0 just before (bf16 launches: one a shared-block
             site, 9, or a layer, 24, 32 and 48; mamba2 none; no float32 one,
             no plain call), its logits against attn_impl="dense" at
             lm_prefill's bar and argmax rule; mamba2-130m's chunked prefill
             against its own token-by-token decode over 128 tokens, in bf16
             and in float32 (`SSM_DECODE_*`)
  family_profile  one such prefill under torch.profiler
  family_flash_timing  the bf16 kernel alone at zamba2-2.7b's attention shape
             (4, 2048, 32, 32, 80) beside the plain version, SDPA, its bound at
             D 80 and at the padded 128
  family_serve  as moe_serve, without the int8 run, each of the two requests
             served alone in 4 slots (a step's floor: each weight once, and for
             the hybrid also with the shared block re-read at each site)
  moe_layer  for deepseek-moe-16b and qwen3-moe-30b-a3b in turn: one
             full-width MoE layer (weights from a generator seeded 0) on 4 x
             2048 tokens at ample capacity against the dense oracle on the
             card (every expert on every token; tests/test_moe.py's bar), the
             share of routed slots dropped at the default capacity factor, its
             ms beside the oracle's
  moe_prefill the model at full width and depth prefills 4 x 2048 tokens
             through `ModelDef.prefill` with attn_impl="flash", the counters
             set to 0 just before (n_layers bf16 launches: 28 and 48, no
             float32 one, no plain call), its logits against attn_impl=
             "dense" at lm_prefill's bar and argmax rule (the flash run
             again, its routing pinned to the dense run's at the tokens
             where a near-tie of the router went the other way, each such
             flip explained by the two router inputs' difference, and
             counted: `RoutingPin`), the dropped share,
             the wall, tokens a second and torch.cuda.max_memory_allocated
  moe_profile one flash prefill under torch.profiler: the flash kernel's
             device ms against the matrix products, and the idle share
  moe_serve  a decode step of 4 slots (CUDA events, and one under
             torch.profiler: device busy, idle share, kernels) beside its weight-read
             floor (every weight but the untied embedding table, over the
             HBM rate: the dispatch runs every routed expert each step), two
             requests served alone, then `repro_torch.launch.serve` at its
             defaults (8 requests, 8 tokens each, 4 slots) whose first two
             requests must equal them; deepseek once more under
             REPRO_KV_QUANT=1 (the int8 KV cache)
  encdec_prefill  whisper-large-v3 at full width (bf16, weights from a
             generator seeded 0) on 4 x 1,500 frames and make_inputs' 187
             decoder tokens through `ModelDef.prefill` with attn_impl=
             "flash", the counters set to 0 just before: exactly 96 bf16
             launches (32 encoder, 32 causal decoder, 32 cross), no float32
             one, no plain call; its logits against attn_impl="dense" at
             lm_prefill's bar and argmax rule
  encdec_profile  one such prefill under torch.profiler
  encdec_flash_timing  the bf16 kernel alone at whisper's three shapes
             beside its bound (4 D operations an allowed pair at 989
             TFLOP/s, or its bytes), the plain version and SDPA
  encdec_decode  the cross cache filled from the encoder's output through
             each layer's cross wk / wv (the caller's work in repro as in
             the port), then 16 greedy decode steps, step t against
             prefill_logits of the first t + 1 tokens at lm_prefill's bar
             and argmax rule; a step's ms (CUDA events), one under
             torch.profiler, beside its weight-read floor with and without
             the two caches
  train_path (a) every arch's smoke model, one build_train_step step and
             its gradient on the card against the CPU from the same
             parameters (MoE routing pinned to the CPU's, each flip
             explained: `RoutingPin`): loss rtol 1e-3, grad norm rtol 1e-2,
             each gradient leaf within 8 bf16 steps, or 8 plus half the
             CPU's own bf16-vs-float32 difference of the leaf, each
             parameter within 2 lr + a bf16 step after the step; (b)
             gemma-2b and (c) mamba2-130m at full width through
             `launch.train.main` on the card, 4 x 2048 tokens, 4 steps,
             remat "full": every loss finite and step 4's below step 1's,
             each step's ms (CUDA events), tokens a second, the peak of
             torch.cuda.max_memory_allocated beside the estimate, the bound
             8 N T operations at 989 TFLOP/s; one more step of each under
             torch.profiler (train_profile); (d) resume: gemma-2b smoke, 4
             steps against 2, a checkpoint, a restore and 2 more, at
             tests/test_checkpoint.py:73's bar (run again under
             torch.use_deterministic_algorithms only if it fails); (e)
             microbatch 2 against 1 at (a)'s bars; (f) a loss through
             attn_impl="flash" refused
  mesh_path  the meshed steps (`launch.steps` on a DeviceMesh): (a) a
             world of 1 over NCCL on a (1, 1) mesh, gemma-2b's train step
             at full width, 4 x 2048, 2 steps, against the single-device
             step from the same parameters and batches (losses and
             parameters bitwise, else within the bars with the cause), each
             step's ms beside the single device's; (b) 2 gloo ranks sharing
             cuda:0 on (1, 2) and (2, 1): gemma2-27b's and
             qwen3-moe-30b-a3b's smoke train steps against the card's
             single-device step (qwen3 on (2, 1) as G = 2 dispatch groups,
             `grouped_moe_reference`; routing pinned, flips explained) at
             train_path's bars, and on (1, 2) gemma-2b's full-width 4 x
             2048 prefill through the bf16 flash kernel on each rank's 4
             query heads, 18 launches a rank, within lm_prefill's bar of
             the single-device dense route
  li2020_path  Li et al. 2020's 375 cities at the benchmark cell
             `li2020_china.b20k`'s shape (20,000 x 14 days a wave), made as
             perfbench makes it (`harness.make_program`: the committed
             traveller and population files, the pilot's tolerance): the
             main path's simulator names the tile route's wave entry; one
             wave of it bitwise prior.sample + the plain version on the card
             (theta and distances); a run_abc on that runner with the
             counters set to 0 just before: waves + gated launches of the
             tile wave entry and nothing else, by entry and by route
             (`abc_sim.route_counts`), and of those the ones with two tiles
             or more in flight an SM (all of them or none, as the wave's
             `Launch.resident`, the occupancy query's blocks an SM printed
             beside it, says); the 16 variants of li2020's tile kernel in
             ptxas's report; the wave's ms by CUDA events in two turns, the
             plain version's, and the bound of the configuration's frozen
             count at 67 TFLOP/s
  kernels    one line for each kernel: abc_sim (each of its eight flat
             entries, with its launches, gated ones included, on the three
             flat ABC paths, smc_path, campaign_path, forecast_path,
             epi_serve, scaleout_path ((a), (d), (e), (f), (h)) and
             tuning_path, and its ms; npe_path's launches, 0 in its fits
             and the ABC oracle's apart), its region axis on the thread
             route (all four regional entries of both routes, with their
             launches on metapop_path, regions_path, campaign_path and
             scaleout_path (j)'s single-device run, the R=100 times at both
             batches and the route chosen at each R and batch;
             tuning_path's autotune of R=100 on the warp route), on the
             warp route and on the tile route (li2020_path's launches, its
             wave's ms, plain ms and bound), the wave loop's compaction
             kernel abc_compact
             (its launches by path, which must reach it on main_path and
             smc_path, and profile's device us against its bound and the
             plain lines'), the bf16 flash route (its launches on lm_prefill,
             every family_prefill, both moe_prefill runs,
             encdec_prefill and mesh_path's two ranks, `launches_by_path`; its zamba2-2.7b cell and
             whisper's three) and the float32 one

`python3 chip_smoke.py --only flash,encdec,train,mesh,li2020` runs the build and
then only those groups of phases, with no kernels line.

then the card's name and power limit as nvidia-smi gives them, and the last
line `{"ok": true, "device": {...}}`. Any failing phase raises and the
script exits non-zero; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the card's ceilings (H100 SXM published peaks), one place for the port
from repro_torch.device import (  # noqa: E402
    BF16_OPS_PER_S,
    F32_OPS_PER_S,
    HBM_BYTES_PER_S,
    TF32_OPS_PER_S,
    TF32_PASSES,
)
from repro_torch.ioutils import atomic_write_text  # noqa: E402

PINS = os.path.join(ROOT, "tests", "data", "r1_pins.npz")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/abc_sim.cuh"
TPU_KERNEL = "src/repro/kernels/abc_sim.py:138"
#: the flat models of the abc_sim kernel, in repro's registry order
ABC_MODELS = ("siard", "sir", "seir", "seiard")
#: the region axis: its template, the TPU kernel body's region geometry it
#: replaces (mobility lanes :95-119, coupled rows :254-260, pooling
#: :287-294), and the structs with a regional library
REGIONAL_SOURCE = "src/repro_torch/kernels/csrc/abc_sim_regional.cuh"
REGIONAL_WARP_SOURCE = "src/repro_torch/kernels/csrc/abc_sim_regional_warp.cuh"
REGIONAL_TPU_KERNEL = "src/repro/kernels/abc_sim.py:195"
REGIONAL_STRUCTS = ABC_MODELS + ("metapop_seir",)
REGIONAL_TILE_SOURCE = "src/repro_torch/kernels/csrc/abc_sim_regional_tile.cuh"
#: the benchmark cell whose shape li2020_path runs (perfbench/workloads/)
LI2020_CELL = "li2020_china.b20k"
#: the (summary, distance) pairs of tests/test_metapop.py:235-239
METAPOP_PAIRS = (("identity", "euclidean"), ("region_pooled", "euclidean"),
                 ("log_weekly", "mae"))
#: the one-window schedule of the regional cases: metapop_seir's contact rate
METAPOP_INTERVENTION = "beta@20=0:2"
#: the scaled parameter of each model in the schedule cases
#: (tests/test_interventions.py:142-170, extended to seir and seiard)
SCHEDULE_TV = {"siard": "alpha", "sir": "beta", "seir": "beta", "seiard": "alpha0"}
#: the intervention of the schedule_path phase and of the timed scheduled SIARD
INTERVENTION = "alpha0@25=0:2"
#: the fit schedule of the README's forecast example (phase forecast_path)
FORECAST_INTERVENTION = "alpha0@20=0:2"
#: instructions a sample-day of the main path's wave variant (PERF.md §6):
#: each flat model, metapop_seir's thread route at R=4 and its warp route at
#: R=100 (warp-instructions). The device gate adds its load and branch
#: outside the day loop; on the warp route ptxas also schedules the day loop
#: 5 warp-instructions shorter (2,938 before the gate) whichever way the
#: gate is read (experiments/abc_sim_gate_census.py)
CENSUS_PER_DAY = {"siard": 660, "sir": 249, "seir": 353, "seiard": 762,
                  "metapop_seir thread R=4": 1671, "metapop_seir warp R=100": 2933}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
FLASH_F32_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_tf32.cu"
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention.py:38"
#: kernel-vs-oracle bar (tests/test_kernel_abc_sim.py:58): repro's pinned
#: oracle distances differ from its pinned Pallas ones, which the kernel
#: equals bitwise, by up to 1.2e-7 relative
BAR = dict(rtol=2e-6, atol=1e-3)
#: flash kernel-vs-plain bars. float32: tests/test_kernel_flash.py:31. bf16:
#: kernel and plain version both compute in float32 from the same bf16
#: inputs (the kernel keeps p to about 16 bits as bf16 hi + lo) and round
#: only the output to bf16, so they may land one bf16 step apart, and a step
#: is at most 2^-7 |want|; atol is the float32 bar's, for the float32
#: arithmetic under that rounding. (The 0.05 of
#: tests/test_kernel_flash.py:64-65 is for dense_attention, which also
#: rounds p to bf16; it stays in the CPU tests against repro.)
FLASH_BARS = {"float32": dict(rtol=3e-4, atol=3e-5), "bfloat16": dict(rtol=2**-7, atol=3e-5)}
#: (b, sq, h, kh, d, skv, causal, window, softcap) of the flash phase; the
#: first three are tests/test_kernel_flash.py:21-25
FLASH_CASES = [
    (1, 64, 2, 2, 16, 64, True, None, None),
    (2, 64, 4, 2, 16, 64, True, None, None),
    (1, 128, 4, 1, 32, 128, True, None, None),
    (1, 64, 2, 2, 16, 64, True, 16, 30.0),  # window and softcap
    (1, 24, 2, 2, 16, 40, False, None, None),  # non-causal, Skv != Sq
    (1, 2047, 8, 1, 256, 2047, True, None, None),  # ragged
    (1, 64, 2, 1, 32, 8, False, 16, None),  # rows 23.. have no allowed key
    (4, 2048, 8, 1, 256, 2048, True, None, None),  # gemma-2b prefill
    (1, 100, 4, 2, 72, 100, True, None, None),  # D a multiple of 8, not of 16
    (2, 50, 2, 1, 20, 50, True, None, None),  # D off the 8 grid: staged by element
    (1, 130, 4, 2, 128, 200, False, None, 30.0),  # Skv no multiple of 64, Sq != Skv
    (4, 2048, 16, 16, 128, 2048, True, None, None),  # deepseek-moe-16b prefill
    (4, 2048, 32, 4, 128, 2048, True, None, None),  # qwen3-moe-30b-a3b prefill (GQA 8)
    (4, 2048, 32, 32, 80, 2048, True, None, None),  # zamba2-2.7b shared attention (D 80)
    (4, 2048, 16, 8, 128, 2048, True, None, None),  # internvl2-2b prefill
    (4, 2048, 48, 8, 128, 2048, True, None, None),  # internlm2-20b prefill
    (4, 2048, 32, 8, 128, 2048, True, None, None),  # minitron-8b prefill
    (4, 1500, 20, 20, 64, 1500, False, None, None),  # whisper-large-v3 encoder (D 64)
    (4, 187, 20, 20, 64, 1500, False, None, None),  # whisper's cross-attention
    (4, 187, 20, 20, 64, 187, True, None, None),  # whisper's decoder self-attention
]
#: gemma-2b prefill through the flash route against the dense route: both
#: round the unembedding product to bf16, so a logit in [2^e, 2^(e+1)) moves
#: in steps of 2^(e-7). The routes differ only in where attention rounds to
#: bf16 (dense rounds p before p @ v, flash only its output), about one
#: bf16 rounding of each layer's attention output; through 18 layers that
#: is expected to move the logits by a few steps. The bar is 16 steps at
#: the largest |logit| (1/8 of its binade), and the argmax must agree on
#: every row whose top-2 gap exceeds twice the bar.
PREFILL_BAR_STEPS = 16
#: the MoE decoders served at full width and depth (moe_layer, moe_prefill,
#: moe_serve), in the order they run: qwen3's 61 GB of weights last
MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b")
#: the capacity dispatch against the dense oracle: tests/test_moe.py:34-37
MOE_ORACLE_BAR = dict(rtol=0.08, atol=0.05)
#: decode steps of 4 slots timed with CUDA events beside the weight-read floor
MOE_DECODE_ITERS = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compare(case: str, got, want, *, rtol: float, atol: float) -> dict:
    """Raise unless |got - want| <= atol + rtol * |want| everywhere."""
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got, np.float64)
    want = np.asarray(want.cpu() if hasattr(want, "cpu") else want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{case}: shape {got.shape} vs {want.shape}, "
                             f"finite={np.isfinite(got).all()}")
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        i = int(np.argmax(bad))
        raise AssertionError(
            f"{case}: {int(bad.sum())}/{bad.size} outside rtol={rtol} atol={atol}; "
            f"first at {i}: got {got.flat[i]!r} want {want.flat[i]!r}")
    rel = err / np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return {"case": case, "n": int(got.size), "max_rel_err": float(rel.max()),
            "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol}


def bitwise(case: str, got, want) -> dict:
    """Raise unless `got` and `want` are the same float32 values bit for bit
    (+inf allowed: the wave entry turns NaN into it)."""
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got, np.float32)
    want = np.asarray(want.cpu() if hasattr(want, "cpu") else want, np.float32)
    if got.shape != want.shape or np.isnan(got).any():
        raise AssertionError(f"{case}: shape {got.shape} vs {want.shape}, "
                             f"NaN={bool(np.isnan(got).any())}")
    differ = got.view(np.uint32) != want.view(np.uint32)
    if differ.any():
        i = int(np.argmax(differ))
        raise AssertionError(f"{case}: {int(differ.sum())}/{differ.size} differ in their bits; "
                             f"first at {i}: got {got.flat[i]!r} want {want.flat[i]!r}")
    return {"case": case, "n": int(got.size), "max_abs_err": 0.0, "bitwise_equal": True,
            "n_inf": int(np.isinf(got).sum())}


def abc_census(build, model, flags, entries=(("wave", True), ("theta_in", False))):
    """The instruction census (kernels/sass.py) of `model`'s abc_sim kernel
    at `flags`, for each (name, wave) of `entries` (by default both, the wave
    entry and the theta-in entry), from the model's own library; None where
    the toolkit has no cuobjdump."""
    from repro_torch.kernels import abc_sim, sass

    text = build.sass_text(abc_sim.library(model))
    if text is None:
        return None
    funcs = sass.parse_functions(text)
    out = {}
    for entry, wave in entries:
        symbol = abc_sim.kernel_symbol(model, flags, wave)
        names = [k for k in funcs if symbol in k]
        if len(names) != 1:
            raise AssertionError(f"build: {len(names)} kernels match {symbol} in the SASS")
        out[entry] = {"function": names[0], **sass.census(funcs[names[0]])}
    return out


def regional_census(build, model, flags, pooled=False, route="thread"):
    """The census of the regional wave entry of `model`'s struct at `flags`
    on `route` (`sass.regional_census`, or `sass.regional_warp_census` for
    "warp"); None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import abc_sim, sass

    text = build.sass_text(abc_sim.library(model))
    if text is None:
        return None
    funcs = sass.parse_functions(text)
    symbol = abc_sim.kernel_symbol(model, flags, True, route)
    names = [k for k in funcs if symbol in k]
    if len(names) != 1:
        raise AssertionError(f"build: {len(names)} kernels match {symbol} in the SASS")
    census = sass.regional_warp_census if route == "warp" else sass.regional_census
    return {"function": names[0], **census(funcs[names[0]], bool(model.coupled), pooled)}


class SmClock:
    """The SM clock as `nvidia-smi --query-gpu=clocks.sm` reads it every 50 ms
    while the block runs; readings count from `start_counting()`."""

    def __enter__(self):
        import threading

        self.readings, self.counting = [], False
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def read():
            for line in self.proc.stdout:
                if self.counting and line.strip().isdigit():
                    self.readings.append(float(line))

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        return self

    def start_counting(self, load=None, seconds: float = 1.0) -> None:
        """Count readings from now on; with `load`, call it in a loop for
        `seconds` first and count only the readings of the second half, so
        that every reading counted is taken under load."""
        import torch

        t0 = time.perf_counter()
        while load is not None and time.perf_counter() < t0 + seconds:
            load()
            torch.cuda.synchronize()
            self.counting = time.perf_counter() >= t0 + seconds / 2
        self.counting = True

    def median(self):
        return float(np.median(self.readings)) if self.readings else None

    def summary(self) -> dict:
        r = self.readings
        return {"median": self.median(), "min": min(r, default=None),
                "max": max(r, default=None), "readings": len(r)}

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)
        return False


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_us(fn, calls: int = 100) -> float:
    """Mean device microseconds per call of `fn`, by CUDA events around
    `calls` calls enqueued behind a sleep of the card: for calls whose host
    enqueue outlasts their device time, the events then time the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def flash_phase(dev):
    """The flash kernels against their plain version on every FLASH_CASES
    case, float32 and bf16; returns the largest absolute error of the bf16
    tensor-core kernel and of the float32 (3xTF32) one."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            b, sq, h, kh, d, skv, causal, window, cap = case
            rng = np.random.default_rng(sq + h)
            q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
                       .to(device=dev, dtype=dtype)
                       for shape in ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d)))
            kw = dict(causal=causal, window=window, softcap=cap)
            before = (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
                      ref.FLASH_CALLS)
            got = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            bf = int(dtype == torch.bfloat16)
            if (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
                    ref.FLASH_CALLS) != (before[0] + 1, before[1] + bf, before[2] + 1 - bf,
                                         before[3]):
                raise AssertionError(f"flash {case} {dtype}: the card did not go through "
                                     f"the {'bf16' if bf else '3xTF32'} tensor-core kernel")
            want = ref.flash_attention_ref(q, k, v, **kw)
            name = str(dtype).split(".")[1]
            r = compare(f"flash {name} {case}", got.float(), want.float(), **FLASH_BARS[name])
            r["route"] = fa.TENSOR_CORE if bf else fa.TENSOR_CORE_F32
            if window is not None and not causal:
                dead = torch.arange(sq, device=dev) - (skv - 1) >= window
                if not bool((got[:, dead] == 0).all()):
                    raise AssertionError(f"flash {case}: rows with no allowed key are not 0")
                r["rows_with_no_key"] = int(dead.sum())
            results.append(r)
    # a q sliced one element past an aligned base, in each dtype: its rows
    # are not 16-byte pieces, so the route's kernel stages them by element
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(5)
        q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
                   .to(device=dev, dtype=dtype)
                   for shape in ((2, 96, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
        q_odd = torch.empty(q.numel() + 1, dtype=dtype, device=dev)[1:].view(q.shape)
        q_odd.copy_(q)
        bf = int(dtype == torch.bfloat16)
        before = (fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32, fa.LAUNCHES_STAGED,
                  ref.FLASH_CALLS)
        got = ops.flash_attention(q_odd, k, v, causal=True)
        torch.cuda.synchronize()
        if (fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32, fa.LAUNCHES_STAGED,
                ref.FLASH_CALLS) != (before[0] + bf, before[1] + 1 - bf, before[2] + 1,
                                     before[3]):
            raise AssertionError(f"flash odd offset {dtype}: not staged by its route's kernel")
        want = ref.flash_attention_ref(q_odd, k, v, causal=True)
        name = str(dtype).split(".")[1]
        r = compare(f"flash {name} q at an odd offset (2, 96, 4, 2, 64)", got.float(),
                    want.float(), **FLASH_BARS[name])
        r.update(route=fa.TENSOR_CORE if bf else fa.TENSOR_CORE_F32, staged=True)
        results.append(r)
    emit("flash", comparisons=results)
    return tuple(max(r["max_abs_err"] for r in results if r["route"] == route)
                 for route in (fa.TENSOR_CORE, fa.TENSOR_CORE_F32))


def tf32_hgmma_counts(sass: str) -> dict:
    """{function: {"all": HGMMA lines, "tf32": those of a .TF32 type}} of a
    `cuobjdump -sass` listing."""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            out[current] = {"all": 0, "tf32": 0}
        elif current is not None and re.search(r"\bHGMMA\.", line):
            out[current]["all"] += 1
            out[current]["tf32"] += bool(re.search(r"\bHGMMA\.\S*TF32", line))
    return out


def profile_device_ms(fn):
    """(wall ms, device busy ms, [(name, count, device ms)] by device time) of
    one call of `fn` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # device-side events only (kernels and copies); the host ops that
    # launched them carry the same time again
    by_op = sorted(((e.key, e.count, device_us(e) / 1e3) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA), key=lambda r: -r[2])
    return wall * 1e3, sum(r[2] for r in by_op), by_op


def strict_loads(text: str):
    """json.loads that refuses NaN and Infinity tokens."""
    def refuse(token):
        raise AssertionError(f"non-strict JSON token {token!r}")

    return json.loads(text, parse_constant=refuse)


def check_bands(case: str, resp: dict, fit_days: int, total: int) -> None:
    """tests/check_epi_serve.py's check of one response: every band of
    `total` finite days, q05 <= q50 <= q95, the observed fit window."""
    if (resp["fit_days"], resp["total_days"]) != (fit_days, total) or not resp["channels"]:
        raise AssertionError(f"{case}: fit/total days {resp['fit_days']}, "
                             f"{resp['total_days']}, channels {list(resp['channels'])}")
    for ch, bands in resp["channels"].items():
        for key in ("mean", "q05", "q25", "q50", "q75", "q95"):
            if len(bands[key]) != total or not np.isfinite(bands[key]).all():
                raise AssertionError(f"{case}: {ch} {key} has {len(bands[key])} days or a "
                                     "non-finite value")
        lo, mid, hi = (np.asarray(bands[k]) for k in ("q05", "q50", "q95"))
        if not ((lo <= mid).all() and (mid <= hi).all()):
            raise AssertionError(f"{case}: {ch}'s quantile bands cross")
    if any(len(v) != fit_days for v in resp["observed"].values()):
        raise AssertionError(f"{case}: an observed series is not {fit_days} days")


class FitLog:
    """Records every on-demand fit of `EpiServer` while it is entered: the
    dataset, cold or warm, wall, the abc_sim launches by C entry (and the
    gated ones) it made, its simulations and waves a round. Raises unless
    the launches are the device SMC round's: a cold fit's one wave-entry
    launch (round 0) or a warm fit's one theta-in launch (the re-simulated
    population), then waves + gated theta-in launches."""

    def __enter__(self):
        import torch

        from repro_torch.core.serving import EpiServer
        from repro_torch.kernels import abc_sim

        self.fits, self.real, log = [], EpiServer._fit, self

        def fit(server, ds, model, warm):
            torch.cuda.synchronize()
            before, gated = dict(abc_sim.ENTRY_LAUNCHES), dict(abc_sim.ENTRY_GATED)
            t0 = time.perf_counter()
            post = log.real(server, ds, model, warm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v - before.get(k, 0) for k, v in abc_sim.ENTRY_LAUNCHES.items()
                        if v != before.get(k, 0)}
            n_gated = {k: v - gated.get(k, 0) for k, v in abc_sim.ENTRY_GATED.items()
                       if v != gated.get(k, 0)}
            kind = "cold" if warm is None else "warm"
            wave, dist = (abc_sim.entry_name(model, e) for e in ("wave", "distance"))
            want = {dist: (kind == "warm") + sum(post.round_waves) + n_gated.get(dist, 0)}
            if kind == "cold":
                want[wave] = 1
            if launches != want:
                raise AssertionError(f"epi_serve {ds.name}/{model} ({kind} fit): launches "
                                     f"{launches}, want {want}")
            log.fits.append({"dataset": ds.name, "model": model, "kind": kind, "wall_s": wall,
                             "launches_by_entry": launches, "gated_by_entry": n_gated,
                             "simulations": post.simulations, "round_waves": post.round_waves,
                             "round_eps": post.round_eps, "particles": len(post)})
            return post

        EpiServer._fit = fit
        return self

    def __exit__(self, *exc):
        from repro_torch.core.serving import EpiServer

        EpiServer._fit = self.real
        return False


def counted(fn):
    """(fn(), counts): the abc_sim launches by entry (and gated), plain-version
    calls, host prior draws, host syncs and compaction-kernel launches of one
    call, the counters set to 0 just before it and read just after (the
    compactions as a difference, which keeps the phases' own count whole)."""
    import torch

    from repro_torch.core import abc as tabc
    from repro_torch.core import priors
    from repro_torch.kernels import abc_sim, ref

    abc_sim.ENTRY_LAUNCHES.clear()
    abc_sim.ENTRY_GATED.clear()
    priors.DEVICE_DRAWS = 0
    ref.CALLS = 0
    tabc.HOST_SYNCS = 0
    compactions = tabc.COMPACT_KERNEL_LAUNCHES
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "entries": dict(abc_sim.ENTRY_LAUNCHES), "gated": dict(abc_sim.ENTRY_GATED),
                 "plain_calls": ref.CALLS, "host_prior_draws": priors.DEVICE_DRAWS,
                 "host_syncs": tabc.HOST_SYNCS,
                 "compactions": tabc.COMPACT_KERNEL_LAUNCHES - compactions}


def epi_serve_phase(dev, name: str, smi: str) -> tuple:
    """Phase epi_serve: `serve --epi` and `abc_serve` on the card, with
    on-demand fits through the theta-in entries. Returns the launches and
    gated launches by entry of its four parts (fits only: the query path
    launches no abc_sim entry) and the bitwise comparisons made."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.core.serving import (
        EpiServer, ForecastQuery, PosteriorStore, ServeConfig, _scalars, forecast_bands,
        forecast_seed, load_dataset_file, save_dataset_file, subsample_particles)
    from repro_torch.core.smc import SMCConfig
    from repro_torch.epi import data, engine
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import EpiModelConfig
    from repro_torch.kernels import abc_sim, ops
    from repro_torch.launch import abc_run, abc_serve, serve

    root = os.path.join(ROOT, "build", "epi_serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    countries = ("italy", "new_zealand", "usa")
    launched, gated, comparisons, out = {}, {}, [], {}

    def add(counts):
        for table, key in ((launched, "entries"), (gated, "gated")):
            for k, v in counts[key].items():
                table[k] = table.get(k, 0) + v

    def no_plain(part, counts, fits):
        """Raise unless the part's launches are its fits' alone, with no
        plain-version call and no host prior draw."""
        want = {}
        for f in fits:
            for k, v in f["launches_by_entry"].items():
                want[k] = want.get(k, 0) + v
        if counts["entries"] != want or (counts["plain_calls"], counts["host_prior_draws"]) != (
                0, 0):
            raise AssertionError(f"epi_serve {part}: counts {counts}, the fits' launches {want}")

    def serve_cli(part, queries, args):
        """`serve --epi` over `queries`, counted; (response payload, counts, fits)."""
        qpath = os.path.join(root, f"{part}_queries.json")
        atomic_write_text(qpath, json.dumps(queries))
        resp = os.path.join(root, f"{part}_responses.json")
        with FitLog() as log:
            answered, counts = counted(lambda: serve.main(
                ["--epi", "--queries", qpath, "--out", resp, "--device", "cuda"] + args))
        no_plain(part, counts, log.fits)
        add(counts)
        with open(resp) as f:
            payload = strict_loads(f.read())
        if answered != len(queries) or len(payload["responses"]) != len(queries):
            raise AssertionError(f"epi_serve {part}: {answered} answers for {len(queries)}")
        return payload, counts, log.fits

    def sequential(part, payload, queries, store, fit_days, particles):
        """Every response dict-equal to sequential forecast_bands on the card
        from the stored posterior, for the same (query, seed)."""
        st = PosteriorStore(store)
        server = EpiServer(ServeConfig(fit=SMCConfig(num_days=fit_days, wave_loop="device"),
                                       store_dir=store), dev)
        for i, (q, resp) in enumerate(zip(queries, payload["responses"])):
            q = ForecastQuery.from_json(q)
            ds, version = server.dataset(q.dataset, q.model)
            post = st.get(server.posterior_key(q.dataset, q.model), version)
            want = forecast_bands(post.theta, ds, model=q.model, fit_days=fit_days,
                                  horizon=q.horizon, schedule=q.schedule, key=q.seed,
                                  quantiles=q.quantiles, max_particles=particles, device=dev)
            if resp != want:
                raise AssertionError(f"epi_serve {part}: response {i} differs from sequential "
                                     "forecast_bands")
            check_bands(f"epi_serve {part} response {i}", resp, fit_days, fit_days + q.horizon)
        comparisons.append({"case": f"{part}: {len(queries)} responses vs sequential "
                                    "forecast_bands", "dict_equal": True})

    readme = [{"dataset": c, "horizon": 14, "seed": 0} for c in countries] + [
        {"dataset": "italy", "horizon": 14, "seed": 0, "schedule": "alpha@25=0.5"}]

    # (a) the README's 3-country example at the CLI's defaults, cold then again
    store_a = os.path.join(root, "store_a")
    args_a = ["--store", store_a, "--days", "21", "--fit-rounds", "3"]
    cold_a, counts_a, fits_a = serve_cli("a cold", readme, args_a)
    again_a, counts_a2, fits_a2 = serve_cli("a again", readme, args_a)
    stats = (cold_a["stats"], again_a["stats"])
    if ([len(fits_a), len(fits_a2)] != [3, 0] or [s["fits"] for s in stats] != [3, 0]
            or [s["batched_calls"] for s in stats] != [2, 2]
            or [s["compiled_shapes"] for s in stats] != [2, 2]):
        raise AssertionError(f"epi_serve a: fits {len(fits_a)}, {len(fits_a2)}; stats {stats}")
    sequential("a", again_a, readme, store_a, 21, 128)
    out["a_readme"] = {"queries": readme, "argv": args_a, "cold_fits": fits_a,
                       "cold_stats": stats[0], "cold_wall_s": counts_a["wall_s"],
                       "again_stats": stats[1], "again_wall_s": counts_a2["wall_s"]}

    # (b) the same queries at the paper's width: 4 seeds x (3 forecasts + 1
    # counterfactual), smc_path's fit
    paper = [dict(q, seed=s) for s in range(4) for q in readme]
    store_b = os.path.join(root, "store_b")
    args_b = ["--store", store_b, "--days", "49", "--fit-batch", "100000", "--fit-particles",
              "1000", "--fit-rounds", "4", "--particles", "1000", "--slots", "8"]
    cold_b, counts_b, fits_b = serve_cli("b cold", paper, args_b)
    again_b, counts_b2, fits_b2 = serve_cli("b again", paper, args_b)
    stats = (cold_b["stats"], again_b["stats"])
    if ([len(fits_b), len(fits_b2)] != [3, 0] or [s["fits"] for s in stats] != [3, 0]
            or [s["batched_calls"] for s in stats] != [3, 3]
            or [s["compiled_shapes"] for s in stats] != [2, 2]):
        raise AssertionError(f"epi_serve b: fits {len(fits_b)}, {len(fits_b2)}; stats {stats}")
    sequential("b", again_b, paper, store_b, 49, 1000)
    # one batched call of 8 forecast lanes (the 3 countries in turn, seeds
    # 0-7) alone: its launches, device busy time and wall; each lane
    # against simulate_observed alone; particle 0 replayed by the kernel
    siard = get_model("siard")
    server = EpiServer(ServeConfig(fit=SMCConfig(num_days=49, wave_loop="device"),
                                   store_dir=store_b), dev)
    lanes = []
    for lane in range(8):
        c = countries[lane % 3]
        post, ds = server.get_posterior(c, "siard")
        lanes.append((subsample_particles(post.theta, lane, 1000), forecast_seed(lane), ds))
    _, batched = server.kernels.get(siard, 63, 1000, 8, None)
    theta = torch.from_numpy(np.stack([t for t, _, _ in lanes])).to(dev)
    seeds = torch.tensor([s for _, s, _ in lanes])
    scalars = torch.from_numpy(np.stack([_scalars(ds) for _, _, ds in lanes])).unbind(1)
    bp = torch.zeros((8, 0), dtype=torch.int64)

    def call():
        return batched(theta, seeds, *scalars, bp)

    traj = call()
    warm_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms, busy_ms, by_op = profile_device_ms(call)
    kernels = sum(c for k, c, _ in by_op if "Memcpy" not in k and "Memset" not in k)
    for lane, (th, seed, ds) in enumerate(lanes):
        solo = engine.simulate_observed(siard, torch.from_numpy(th).to(dev), seed,
                                        EpiModelConfig(population=ds.population, num_days=63,
                                                       a0=ds.a0, r0=ds.r0, d0=ds.d0))
        comparisons.append(bitwise(f"b lane {lane} ({ds.name}) vs simulate_observed alone",
                                   traj[lane], solo))
    replay = []
    for lane in (0, 1, 2):
        th, seed, ds = lanes[lane]
        fit = traj[lane, :, :, :49].cpu().numpy()
        dist = ops.abc_sim_distance(torch.from_numpy(th).to(dev), seed,
                                    torch.from_numpy(fit[0]).to(dev), model=siard,
                                    population=ds.population, a0=ds.a0, r0=ds.r0,
                                    d0=ds.d0).cpu().numpy()
        if dist[0] != 0.0:
            raise AssertionError(f"epi_serve replay {ds.name}: particle 0 at {dist[0]!r}, not 0")
        want = np.sqrt(((fit.astype(np.float64) - fit[0]) ** 2).sum(axis=(1, 2)))
        replay.append(compare(f"replay {ds.name}: theta-in entry vs numpy's norm of "
                              "(traj_b - traj_0)", dist[1:], want[1:], rtol=1e-6, atol=0.0))
    comparisons += replay
    out["b_paper"] = {
        "queries": len(paper), "argv": args_b, "cold_fits": fits_b, "cold_stats": stats[0],
        "cold_wall_s": counts_b["wall_s"], "again_stats": stats[1],
        "again_wall_s": counts_b2["wall_s"],
        "batched_call": {"lanes": 8, "particles": 1000, "days": 63,
                         "warm_wall_ms": warm_ms, "profiled_wall_ms": wall_ms,
                         "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
                         "device_ops": sum(c for _, c, _ in by_op), "kernel_launches": kernels,
                         "kernel_launches_per_day": kernels / 63,
                         "top_device_ops": [{"name": k[:80], "count": c, "device_ms": ms}
                                            for k, c, ms in by_op[:8]]},
        "replay_particle0_distance": 0.0}

    # (c) the daemon over the three countries as dataset files; one file's
    # last fitted day changes and the next sweep re-fits it warm
    data_c, store_c = os.path.join(root, "data_c"), os.path.join(root, "store_c")
    for c in countries:
        save_dataset_file(os.path.join(data_c, f"{c}.json"), data.get_dataset(c, num_days=21))
    daemon = ["--once", "--data-dir", data_c, "--store", store_c, "--models", "siard",
              "--device", "cuda"]
    with FitLog() as log:
        refits, counts_c = counted(lambda: abc_serve.main(daemon))
    no_plain("c cold", counts_c, log.fits)
    add(counts_c)
    cold_c = log.fits
    path = os.path.join(data_c, "italy.json")
    changed = load_dataset_file(path)
    obs = changed.observed.copy()
    obs[:, 20] += 1.0
    save_dataset_file(path, dataclasses.replace(changed, observed=obs))
    with FitLog() as log:
        refits2, counts_c2 = counted(lambda: abc_serve.main(daemon))
    no_plain("c warm", counts_c2, log.fits)
    add(counts_c2)
    # the warm re-fit runs the template's rounds from the stored population,
    # so its cost against the cold fit's is measured, not assumed
    cold_it = next(f for f in cold_c if f["dataset"] == "italy")
    if (refits, refits2, [f["kind"] for f in cold_c], [f["kind"] for f in log.fits],
            log.fits[0]["dataset"]) != (3, 1, ["cold"] * 3, ["warm"], "italy"):
        raise AssertionError(f"epi_serve c: refits {refits}, {refits2}; cold {cold_c}; "
                             f"again {log.fits}")
    out["c_daemon"] = {"argv": daemon, "cold_fits": cold_c, "cold_wall_s": counts_c["wall_s"],
                       "warm_refit": log.fits[0], "warm_wall_s": counts_c2["wall_s"],
                       "cold_simulations_italy": cold_it["simulations"],
                       "warm_over_cold_simulations": log.fits[0]["simulations"]
                       / cold_it["simulations"],
                       "warm_over_cold_final_eps": log.fits[0]["round_eps"][-1]
                       / cold_it["round_eps"][-1]}

    # (d) tests/check_epi_serve.py's toy on the card: sir, 8 queries
    data_d, store_d = os.path.join(root, "data_d"), os.path.join(root, "store_d")
    save_dataset_file(os.path.join(data_d, "toy.json"), data.synthetic_dataset(
        theta=(0.5, 0.2, 1.0), population=1e6, num_days=12, a0=100.0, seed=11, name="toy",
        model="sir"))
    fit_d = ["--days", "8", "--fit-particles", "16", "--fit-batch", "256", "--fit-rounds", "1"]
    with FitLog() as log:
        refits_d, counts_d = counted(lambda: abc_serve.main(
            ["--once", "--data-dir", data_d, "--store", store_d, "--models", "sir",
             "--device", "cuda"] + fit_d))
    no_plain("d fit", counts_d, log.fits)
    add(counts_d)
    toy = ([{"dataset": "toy", "model": "sir", "horizon": 6, "seed": s} for s in range(4)]
           + [{"dataset": "toy", "model": "sir", "horizon": 6, "seed": s,
               "schedule": "beta@4=0.5"} for s in range(4)])
    payload_d, counts_d2, fits_d2 = serve_cli("d", toy, ["--data-dir", data_d, "--store",
                                                          store_d, "--slots", "4",
                                                          "--particles", "16"] + fit_d)
    if (refits_d, len(fits_d2), payload_d["stats"]["fits"]) != (1, 0, 0) or (
            payload_d["stats"]["batched_calls"] > 2) or not log.fits[0]["launches_by_entry"].get(
            "abc_sim_distance_sir"):
        raise AssertionError(f"epi_serve d: refits {refits_d}, fits {log.fits}, stats "
                             f"{payload_d['stats']}")
    for i, resp in enumerate(payload_d["responses"]):
        check_bands(f"epi_serve d response {i}", resp, 8, 14)
        if (resp["schedule"] is None) != (i < 4):
            raise AssertionError(f"epi_serve d: response {i}'s schedule {resp['schedule']}")
    out["d_toy"] = {"fit": log.fits[0], "stats": payload_d["stats"],
                    "wall_s": counts_d2["wall_s"]}
    shutil.rmtree(root, ignore_errors=True)
    emit("epi_serve", **out, launches_by_entry=launched, gated_by_entry=gated,
         comparisons=comparisons, bitwise_comparisons=sum(
             1 for c in comparisons if c.get("bitwise_equal") or c.get("dict_equal")),
         kind=name, nvidia_smi=smi)
    return launched, gated


#: tests/test_posterior_recovery.py's recovery fixtures (truth, population
#: 1e6, 15 days, a0 100, seed 11) and bars, for phase npe_path (b)
NPE_TRUTH = {"sir": (0.5, 0.2, 1.0), "seir": (0.6, 0.3, 0.2, 1.0)}
NPE_REL_TOL, NPE_ORACLE_DRIFT = 0.30, 0.25
#: training steps of phase npe_path (d), SIARD on Italy at 49 days and
#: npe_demo's width: cut from npe_demo's 300 to keep the phase near a minute
NPE_SIARD_STEPS = 50
#: training steps a profiled call of phase npe_path
NPE_PROFILED_STEPS = 5


def npe_phase(dev, name: str, smi: str) -> dict:
    """Phase npe_path: the amortized backend (`core.npe`) on the card, no
    kernel of its own. Returns the abc_sim launches of its NPE fits (0) and
    of the ABC oracle, apart."""
    import dataclasses
    import shutil
    import warnings

    import torch

    from repro_torch.configs.epi_abc import npe_demo, npe_serving_demo
    from repro_torch.core import abc as tabc
    from repro_torch.core import npe as tnpe
    from repro_torch.core import serving
    from repro_torch.core.serving import load_dataset_file, save_dataset_file
    from repro_torch.epi import data, engine
    from repro_torch.epi.models import get_model
    from repro_torch.launch import abc_run, abc_serve, serve
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves, tree_map

    out, fit_launches, oracle_launches = {}, {}, {}

    def no_launch(part, counts):
        """Raise unless an NPE part launched no abc_sim entry and called no
        plain version of it."""
        for k, v in counts["entries"].items():
            fit_launches[k] = fit_launches.get(k, 0) + v
        if counts["entries"] or counts["plain_calls"]:
            raise AssertionError(f"npe_path {part}: abc_sim launches {counts['entries']}, "
                                 f"plain calls {counts['plain_calls']}; an NPE fit makes none")

    # (a) npe_demo twice with one seed: bitwise equal weights and draws; the
    # card's weights on the CPU against the card
    wl = npe_demo("sir", 15)
    cfg, ds = wl.abc, wl.load_dataset()
    obs = ds.observed[:, : cfg.num_days]
    trained = []
    for _ in range(2):
        est, counts = counted(lambda: tnpe.train_npe(ds, cfg, seed=0, device=dev))
        no_launch("a", counts)
        trained.append((est, counts))
    (e1, c1), (e2, c2) = trained
    d1, d2 = (e.sample_posterior(obs, 256, seed=0) for e in (e1, e2))
    comparisons = [bitwise(f"npe_path a leaf {i} of two trainings", a, b) for i, (a, b) in
                   enumerate(zip(tree_leaves(e1.params), tree_leaves(e2.params)))]
    comparisons += [bitwise("npe_path a 256 draws of two trainings", d1.theta, d2.theta),
                    bitwise("npe_path a -log q of two trainings", d1.distances, d2.distances)]
    if e1.final_loss != e2.final_loss or not np.isfinite(e1.final_loss):
        raise AssertionError(f"npe_path a: final losses {e1.final_loss}, {e2.final_loss}")
    e_cpu = dataclasses.replace(e1, params=tree_map(lambda t: t.cpu(), e1.params))
    x = torch.from_numpy(e1.features_of(obs))
    for part, got, want in zip(("log_pi", "mu", "sigma"),
                               tnpe.mdn_forward(e1.params, x.to(dev), e1.npe, e1.n_params),
                               tnpe.mdn_forward(e_cpu.params, x, e1.npe, e1.n_params)):
        comparisons.append(compare(f"npe_path a {part}, card vs CPU forward", got, want,
                                   rtol=1e-5, atol=1e-5))
    # log q at the draws: a trained component's sigma is ~0.01-0.05 of the
    # box, so (theta - mu) / sigma carries mu's float32 rounding times
    # 1/sigma into z^2; atol 1e-4 is ~5x the largest such difference seen
    comparisons.append(compare("npe_path a log_prob at the draws, card vs CPU forward",
                               e1.log_prob(obs, d1.theta), e_cpu.log_prob(obs, d1.theta),
                               rtol=1e-5, atol=1e-4))
    comparisons.append(compare("npe_path a 256 draws, card vs CPU", d1.theta,
                               e_cpu.sample_posterior(obs, 256, seed=0).theta, rtol=0.0,
                               atol=1e-5))
    sample_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        e1.sample_posterior(obs, 256, seed=1)
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    s_wall, s_busy, s_ops = profile_device_ms(lambda: e1.sample_posterior(obs, 256, seed=1))

    # one training step alone: wall by the clock, then under the profiler
    # (kernels a step, device busy time, idle share), the simulation apart
    spec, prior, mcfg, mob, summary, npe_cfg = tnpe._train_setup(ds, cfg, None)
    opt_cfg = AdamWConfig(lr=npe_cfg.lr, weight_decay=npe_cfg.weight_decay,
                          warmup_steps=max(1, npe_cfg.train_steps // 20),
                          total_steps=npe_cfg.train_steps)
    step = tnpe._make_train_step(spec, prior, mcfg, cfg.schedule, summary, mob, npe_cfg,
                                 opt_cfg, e1.lows, e1.highs, e1.feat_mean, e1.feat_std, dev)
    carry = [e1.params, adamw_init(e1.params)]

    def steps(n=NPE_PROFILED_STEPS, first=1):
        for i in range(n):
            carry[0], carry[1], _ = step(carry[0], carry[1], *tnpe.step_seeds(1, first + i))

    def simulations(n=NPE_PROFILED_STEPS):
        with torch.no_grad():
            for i in range(n):
                p_seed, s_seed = tnpe.step_seeds(2, i + 1)
                engine.simulate_features(spec, prior.sample(p_seed, npe_cfg.train_batch, dev),
                                         s_seed, mcfg, cfg.schedule, None, summary, mob)

    steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(20, 10)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    p_wall, p_busy, p_ops = profile_device_ms(steps)
    q_wall, q_busy, q_ops = profile_device_ms(simulations)

    def kernels(by_op):
        return sum(c for k, c, _ in by_op if "Memcpy" not in k and "Memset" not in k)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            steps(1, 100)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:120] for w in caught if "synchroniz" in str(w.message)]
    if syncs:
        raise AssertionError(f"npe_path a: one training step synchronized the host "
                             f"{len(syncs)} times: {syncs[:3]}")
    n = NPE_PROFILED_STEPS
    out["a_npe_demo"] = {
        "config": dataclasses.asdict(npe_cfg), "model": "sir", "days": cfg.num_days,
        "train_wall_s": [c1["wall_s"], c2["wall_s"]], "final_loss": e1.final_loss,
        "train_sims": e1.train_sims, "prior_draws_on_card": c1["host_prior_draws"],
        "bitwise_equal_trainings": True,
        "step_ms": step_ms,
        "step_profile": {"steps": n, "wall_ms": p_wall / n, "device_busy_ms": p_busy / n,
                         "device_idle_share": 1 - p_busy / p_wall,
                         "kernel_launches": kernels(p_ops) / n,
                         "top_device_ops": [{"name": k[:80], "count": c, "device_ms": ms}
                                            for k, c, ms in p_ops[:8]]},
        "simulation_profile": {"wall_ms": q_wall / n, "device_busy_ms": q_busy / n,
                               "kernel_launches": kernels(q_ops) / n,
                               "kernel_launches_per_day": kernels(q_ops) / n / cfg.num_days},
        "host_syncs_in_one_step": len(syncs),
        "sample_posterior_256_ms": sample_ms,
        "sample_profile": {"wall_ms": s_wall, "device_busy_ms": s_busy,
                           "device_idle_share": 1 - s_busy / s_wall,
                           "kernel_launches": kernels(s_ops)}}

    # (b) the recovery bars of tests/test_posterior_recovery.py on the port's
    # own series, against the port's CUDA ABC oracle at quantile 5e-3
    npe_test = tnpe.NPEConfig(train_steps=300, train_batch=256, n_pilot=256)
    out["b_recovery"] = {}
    for m in ("sir", "seir"):
        spec_m = get_model(m)
        ds_m = data.synthetic_dataset(theta=NPE_TRUTH[m], population=1e6, num_days=15,
                                      a0=100.0, seed=11, name=f"recovery_{m}", model=m)
        ncfg = tabc.ABCConfig(num_days=15, backend="npe", model=m, target_accepted=256,
                              npe=npe_test)
        npe_post, counts = counted(lambda: tabc.run_abc(ds_m, ncfg, seed=0, device=dev))
        no_launch(f"b {m}", counts)
        ocfg = tabc.ABCConfig(batch_size=4096, chunk_size=4096, num_days=15, model=m,
                              tolerance=1.0, max_runs=60, target_accepted=60)

        def oracle():
            eps = tabc.calibrate_tolerance(ds_m, ocfg, seed=5, quantile=5e-3, n_pilot=4096,
                                           device=dev)
            return tabc.run_abc(ds_m, dataclasses.replace(ocfg, tolerance=eps), seed=0,
                                device=dev)

        abc_post, ocounts = counted(oracle)
        for k, v in ocounts["entries"].items():
            oracle_launches[k] = oracle_launches.get(k, 0) + v
        lo, hi = np.asarray(spec_m.prior().lows), np.asarray(spec_m.prior().highs)
        width, truth = hi - lo, np.asarray(NPE_TRUTH[m])
        err = np.abs(npe_post.theta.mean(0) - truth) / width
        prior_err = np.abs((hi + lo) / 2 - truth) / width
        drift = np.abs(npe_post.theta.mean(0) - abc_post.theta.mean(0)) / width
        overlap = [min(np.quantile(npe_post.theta[:, j], 0.95),
                       np.quantile(abc_post.theta[:, j], 0.95))
                   - max(np.quantile(npe_post.theta[:, j], 0.05),
                         np.quantile(abc_post.theta[:, j], 0.05)) for j in range(len(truth))]
        row = {"npe_mean": npe_post.theta.mean(0).tolist(),
               "abc_mean": abc_post.theta.mean(0).tolist(), "truth": list(truth),
               "err_over_width": err.tolist(), "drift_over_width": drift.tolist(),
               "overlap_90": [float(o) for o in overlap], "npe_wall_s": counts["wall_s"],
               "oracle_wall_s": ocounts["wall_s"], "oracle_accepted": len(abc_post),
               "oracle_tolerance": abc_post.tolerance, "oracle_launches": ocounts["entries"]}
        out["b_recovery"][m] = row
        if not ((err <= NPE_REL_TOL).all() and err.mean() < prior_err.mean()
                and (drift <= NPE_ORACLE_DRIFT).all() and min(overlap) > 0
                and len(abc_post) >= 60 and npe_post.runs == 0
                and npe_post.theta.shape == (256, len(truth))
                and np.isfinite(npe_post.distances).all()):
            raise AssertionError(f"npe_path b {m}: {row}")

    # (c) abc_serve --once --backend npe, a second server, a version change,
    # then serve --epi from the store; no wave fit may run
    root = os.path.join(ROOT, "build", "npe_path")
    shutil.rmtree(root, ignore_errors=True)
    data_c, store_c = os.path.join(root, "data"), os.path.join(root, "store")
    path = os.path.join(data_c, "served.json")
    save_dataset_file(path, data.synthetic_dataset(
        theta=(0.5, 0.2, 1.0), population=1e6, num_days=15, a0=100.0, seed=3, name="served",
        model="sir"))
    demo = npe_serving_demo()  # the daemon at its template's steps, window and particles
    daemon = ["--once", "--data-dir", data_c, "--store", store_c, "--models", "sir", "--days",
              str(demo.fit.num_days), "--fit-particles", str(demo.fit.n_particles),
              "--backend", "npe", "--npe-steps", str(demo.npe.train_steps),
              "--npe-fine-tune", str(demo.npe.fine_tune_steps), "--device", "cuda"]
    servers, real_server, real_smc = [], serving.EpiServer, serving.run_smc_abc

    class Recorded(real_server):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            servers.append(self)

    def no_waves(*a, **k):
        raise AssertionError("npe_path c: the NPE server entered the SMC wave fitter")

    qpath, rpath = os.path.join(root, "queries.json"), os.path.join(root, "responses.json")
    atomic_write_text(qpath, json.dumps([{"dataset": "served", "model": "sir", "horizon": 7,
                                          "seed": s} for s in range(4)]))
    serving.EpiServer, serving.run_smc_abc = Recorded, no_waves
    try:
        refits, parts = [], []
        for part in ("cold", "second server", "version change"):
            if part == "version change":
                changed = load_dataset_file(path)
                o = changed.observed.copy()
                o[:, -1] += 1.0
                save_dataset_file(path, dataclasses.replace(changed, observed=o))
            r, counts = counted(lambda: abc_serve.main(daemon))
            no_launch(f"c {part}", counts)
            refits.append(r)
            parts.append({"part": part, "refits": r, "wall_s": counts["wall_s"],
                          "stats": servers[-1].stats()})
        n_resp, counts = counted(lambda: serve.main(
            ["--epi", "--device", "cuda", "--queries", qpath, "--data-dir", data_c, "--store",
             store_c, "--days", str(demo.fit.num_days), "--fit-particles",
             str(demo.fit.n_particles), "--particles", "64",
             "--backend", "npe", "--out", rpath]))
        no_launch("c serve --epi", counts)
        with open(rpath) as f:
            payload = strict_loads(f.read())
    finally:
        serving.EpiServer, serving.run_smc_abc = real_server, real_smc
    stats = [p["stats"] for p in parts] + [payload["stats"]]
    got = [(s["npe_trains"], s["npe_fine_tunes"], s["fits"]) for s in stats]
    if refits != [1, 0, 1] or got != [(1, 0, 0), (0, 0, 0), (0, 1, 0), (0, 0, 0)] or n_resp != 4:
        raise AssertionError(f"npe_path c: refits {refits}, (trains, fine-tunes, fits) {got}, "
                             f"{n_resp} responses")
    for i, resp in enumerate(payload["responses"]):
        check_bands(f"npe_path c response {i}", resp, demo.fit.num_days, demo.fit.num_days + 7)
    out["c_serving"] = {"argv": daemon, "parts": parts, "serve_epi_wall_s": counts["wall_s"],
                        "serve_epi_stats": payload["stats"]}
    shutil.rmtree(root, ignore_errors=True)

    # (d) abc_run --backend npe on main_path's SIARD series at npe_demo's width
    argv = ["--backend", "npe", "--dataset", "italy", "--days", "49", "--model", "siard",
            "--accept", "256", "--npe-steps", str(NPE_SIARD_STEPS), "--npe-batch", "256",
            "--npe-hidden", "64", "--npe-components", "4", "--seed", "0", "--device", "cuda"]
    post, counts = counted(lambda: abc_run.main(argv))
    no_launch("d", counts)
    box = get_model("siard").prior()
    lo, hi = np.asarray(box.lows), np.asarray(box.highs)
    if (post.runs, len(post), post.tolerance) != (0, 256, 0.0) or not (
            np.isfinite(post.theta).all() and np.isfinite(post.distances).all()
            and (post.theta >= lo).all() and (post.theta <= hi).all()):
        raise AssertionError(f"npe_path d: {len(post)} draws, runs {post.runs}")
    out["d_siard_italy"] = {"argv": argv, "steps_cut": {"npe_demo": 300,
                                                        "used": NPE_SIARD_STEPS},
                            "wall_s": counts["wall_s"], "simulations": post.simulations,
                            "posterior_mean": post.theta.mean(0).tolist()}
    emit("npe_path", **out, npe_fit_abc_sim_launches=sum(fit_launches.values()),
         oracle_launches_by_entry=oracle_launches, comparisons=comparisons,
         kind=name, nvidia_smi=smi)
    return {"npe_fit_launches": sum(fit_launches.values()),
            "oracle_launches_by_entry": oracle_launches}


#: the lockstep reference at tests/test_scaling.py's size (its `_CFG_KW`)
SCALEOUT_TEST_KW = dict(batch_size=2048, tolerance=3.4e3, target_accepted=60,
                        chunk_size=2048, max_runs=6, num_days=12, wave_loop="device")
#: shard counts of the lockstep reference on the card (b)
SCALEOUT_SHARDS = (2, 4, 8)
#: a rank's join timeout in the spawned parts, seconds
SCALEOUT_TIMEOUT = 120
#: (g) the sample offsets of each wave entry, and the wave entry's time at
#: 100,000 x 49 before the offset (PERF.md §6)
SCALEOUT_OFFSETS = (0, 1, 4096, 50_000)
WAVE_MS_BEFORE_OFFSET = 0.1438
#: (i) gloo ranks sharing cuda:0 in the pjit style
PJIT_SHARED_RANKS = (2, 4)
#: (j) metapop_seir's regions: a wave of 100,000 takes the thread route, a
#: rank's 50,000 the warp route (`abc_sim.regional_route`)
PJIT_ROUTE_REGIONS = 20


def scaleout_digest(runner, out):
    """sha256 of a sharded run's gathered segments, fills, total and waves
    (tests/test_torch_distributed.py's digest)."""
    import hashlib

    waves, n, _ = runner.read(out)
    h = hashlib.sha256()
    for a in runner.segments(out):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.int64(n).tobytes())
    h.update(np.int64(waves).tobytes())
    return h.hexdigest(), n, waves


def scaleout_gloo_rank(rank, world, counts, kw):
    """A gloo rank on the CPU (the plain version): the first N ranks run
    `make_wave_runner` at tests/test_scaling.py's size for each N of
    `counts`; {N: digest} of the ranks in the subgroup."""
    import torch.distributed as dist

    from repro_torch.core import abc as tabc
    from repro_torch.core import distributed, scaling
    from repro_torch.epi.data import get_dataset

    ds = get_dataset("synthetic_small", num_days=kw["num_days"])
    cfg = tabc.ABCConfig(**kw)
    digests = {}
    for n in counts:
        group = scaling.device_mesh(n)
        if rank < n:
            wr = distributed.make_wave_runner(group, ds, cfg, device="cpu")
            digests[n] = scaleout_digest(wr, wr(0, 0, wr.init(tabc.ABCState(n_params=8)),
                                                cfg.max_runs))
        dist.barrier()
    return digests


def scaleout_shared_card_rank(rank, world, kw):
    """A gloo rank on cuda:0 beside another: the sharded device loop on
    Italy at 100,000 a rank; (digest, posterior theta, runs, warm wall s)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import abc as tabc
    from repro_torch.core import distributed
    from repro_torch.epi.data import get_dataset

    ds = get_dataset("italy", num_days=49)
    cfg = tabc.ABCConfig(**kw)
    wr = distributed.make_wave_runner(dist.group.WORLD, ds, cfg, device="cuda:0")
    tabc.run_abc(ds, cfg, seed=0, wave_runner=wr)  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    post = tabc.run_abc(ds, cfg, seed=0, wave_runner=wr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    digest = scaleout_digest(wr, wr(0, 0, wr.init(tabc.ABCState(n_params=8)),
                                    tabc.SEGMENT_WAVES))
    return digest, post.theta, post.runs, wall


def pjit_config(kw, regions=None):
    """(dataset, ABCConfig) of a pjit part: Italy and SIARD, or metapop_seir
    regionalized to `regions` (ring:0.1) on its synthetic_small series."""
    from repro_torch.core import abc as tabc
    from repro_torch.epi.data import get_dataset
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import regionalize

    if regions is None:
        return get_dataset("italy", num_days=49), tabc.ABCConfig(**kw)
    spec = regionalize(get_model("metapop_seir"), regions, "ring:0.1")
    return (get_dataset("synthetic_small", num_days=49, model=spec),
            tabc.ABCConfig(model=spec, **kw))


def pjit_shared_card_rank(rank, world, kw, regions=None):
    """A gloo rank on cuda:0 in the pjit style (`pjit_config`): its
    posterior (theta, distances, runs) and its abc_sim launches by entry."""
    import torch.distributed as dist

    from repro_torch.core import abc as tabc
    from repro_torch.core import distributed
    from repro_torch.kernels import abc_sim

    ds, cfg = pjit_config(kw, regions)
    wr = distributed.make_wave_runner(dist.group.WORLD, ds, cfg, style="pjit",
                                      device="cuda:0")
    abc_sim.ENTRY_LAUNCHES.clear()
    post = tabc.run_abc(ds, cfg, seed=0, wave_runner=wr)
    return post.theta, post.distances, post.runs, dict(abc_sim.ENTRY_LAUNCHES)


def offset_phase(dev) -> dict:
    """Phase scaleout_path (g): every wave entry (the four flat models, SIARD
    under a one-window schedule, metapop_seir on both routes) at each of
    `SCALEOUT_OFFSETS`: b rows at offset o bitwise rows [o, o + b) of the
    offset-0 wave of o + b rows, and bitwise prior.sample + the plain
    version at that offset on the card; then the wave entry at 100,000 x 49
    at offsets 0 and 50,000 in turns."""
    import torch

    from repro_torch.core.abc import ABCConfig, make_simulator
    from repro_torch.core.priors import schedule_prior
    from repro_torch.epi.data import get_dataset
    from repro_torch.epi.models import get_model
    from repro_torch.kernels import abc_sim, ops, ref
    from repro_torch.launch.abc_run import parse_intervention

    def bits(a, b):
        return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                       b.view(torch.int32)))

    b, checked = 1024, []
    for case in ABC_MODELS + ("siard_scheduled", "metapop_seir-thread", "metapop_seir-warp"):
        name, _, route = case.partition("-")
        spec = get_model(name.replace("_scheduled", ""))
        sched = parse_intervention(INTERVENTION) if name.endswith("_scheduled") else None
        ds = get_dataset("synthetic_small", num_days=49, model=spec)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
        sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=dev), model=spec,
                               schedule=sched, **kw)
        box = schedule_prior(spec, sched)

        def wave(offset, batch, sim=sim, box=box, route=route):
            if route:
                return sim.launch("wave", batch, route)(9, 7, box.lows, box.highs, offset=offset)
            return sim.wave(box, 7, 9, batch, offset=offset)

        for offset in SCALEOUT_OFFSETS:
            theta, d = wave(offset, b)
            theta0, d0 = wave(0, offset + b)
            theta_p = box.sample(7, b, dev, offset=offset)
            d_p = ref.abc_sim_distance_ref(theta_p, 9, sim.observed, model=spec,
                                           schedule=sched, sample_offset=offset, **kw)
            d_p = torch.where(torch.isnan(d_p), torch.full_like(d_p, float("inf")), d_p)
            if not (bits(theta, theta0[offset:]) and bits(d, d0[offset:])):
                raise AssertionError(f"scaleout_path (g): {case} at offset {offset} is not "
                                     "the tail of the offset-0 wave")
            if not (bits(theta, theta_p) and bits(d, d_p)):
                raise AssertionError(f"scaleout_path (g): {case} at offset {offset} differs "
                                     "from its plain version")
        checked.append(case)
    # the wave entry at 100,000 x 49 at offsets 0 and 50,000, in turns
    italy = get_dataset("italy", num_days=49)
    siard = get_model("siard")
    sim = make_simulator(italy, ABCConfig(batch_size=100_000, chunk_size=10_000,
                                          num_days=49), dev)
    prior, wave = siard.prior(), sim.launch("wave", 100_000)
    turns = {0: [], 50_000: []}
    for offset in (0, 50_000, 50_000, 0) * 2:
        turns[offset].append(cuda_ms(lambda: wave(99, 12, prior.lows, prior.highs,
                                                  offset=offset), 50))
    return {"bitwise_tail_and_plain": checked, "offsets": list(SCALEOUT_OFFSETS),
            "rows": b, "days": 49,
            "wave_entry_100000x49_ms": {str(o): float(np.mean(v)) for o, v in turns.items()},
            "turns_ms": {str(o): v for o, v in turns.items()},
            "ms_before_the_offset": WAVE_MS_BEFORE_OFFSET}


def scaleout_phase(dev, name: str, smi: str, main_post, smc_post, smc_cfg) -> tuple:
    """Phase `scaleout_path`: (a) the main path's config in a world of 1 over
    NCCL, bitwise `main_path`, timed in turns with the unsharded loop; (b)
    the lockstep reference on the card at the tests' size against gloo
    ranks of the plain version, and at 100,000 a shard x 49 days; (c) two
    gloo ranks sharing cuda:0, bitwise the 2-shard reference; (d) the
    scaling study at n=1; (e) the sharded SMC round in a world of 1,
    bitwise `smc_path`; (f) a campaign with devices_per_scenario=2 on
    [cuda:0] * 4 and its resume; then the pjit style: (g) every wave entry
    at sample offsets (`offset_phase`); (h) the main path's config in a
    world of 1 over NCCL, bitwise `main_path`, timed in turns with (a); (i)
    2 and 4 gloo ranks sharing cuda:0, each bitwise `main_path`; (j)
    metapop_seir at R=20 on 2 gloo ranks, whose shards take the warp route,
    bitwise the single-device run on the thread route. Returns the launches
    and gated launches of (a), (d), (e), (f), (h) and (j)'s single-device
    run, summed."""
    import dataclasses
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core import abc as tabc
    from repro_torch.core import distributed, scaling
    from repro_torch.core.campaign import CampaignConfig, run_campaign
    from repro_torch.core.smc import run_smc_abc
    from repro_torch.epi.data import get_dataset
    from repro_torch.epi.models import get_model
    from repro_torch.kernels import abc_sim

    italy = get_dataset("italy", num_days=49)
    siard = get_model("siard")
    prior = siard.prior()
    launches, gated = {}, {}

    def add(counts):
        for table, key in ((launches, "entries"), (gated, "gated")):
            for e, n in counts[key].items():
                table[e] = table.get(e, 0) + n

    def same(case, a, b):
        if not np.array_equal(np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32)):
            raise AssertionError(f"scaleout_path: {case} differs")

    cfg = tabc.ABCConfig(batch_size=100_000, chunk_size=10_000, num_days=49,
                         tolerance=main_post.tolerance, target_accepted=100)
    with distributed.world("cuda") as group:
        backend = dist.get_backend(group)
        if backend != "nccl" or dist.get_world_size(group) != 1:
            raise AssertionError(f"scaleout_path: a world of {dist.get_world_size(group)} "
                                 f"over {backend}")
        # ---- (a) the main path's config, NCCL world of 1
        runner = distributed.make_wave_runner(group, italy, cfg, device="cuda")
        post_a, counts_a = counted(lambda: tabc.run_abc(italy, cfg, seed=0, wave_runner=runner))
        add(counts_a)
        for case, a, b in (("(a) theta", post_a.theta, main_post.theta),
                           ("(a) distances", post_a.distances, main_post.distances)):
            same(case, a, b)
        g = counts_a["gated"].get("abc_sim_wave_siard", 0)
        if ((post_a.runs, post_a.simulations) != (main_post.runs, main_post.simulations)
                or counts_a["entries"] != {"abc_sim_wave_siard": post_a.runs + g}
                or not 1 <= counts_a["host_syncs"] <= -(-post_a.runs // tabc.SEGMENT_WAVES)):
            raise AssertionError(f"scaleout_path (a): runs {post_a.runs}, {counts_a}")
        # ---- (h) the same config in the pjit style, NCCL world of 1
        pjit_runner = distributed.make_wave_runner(group, italy, cfg, style="pjit",
                                                   device="cuda")
        post_h, counts_h = counted(lambda: tabc.run_abc(italy, cfg, seed=0,
                                                        wave_runner=pjit_runner))
        add(counts_h)
        for case, a, b in (("(h) theta", post_h.theta, main_post.theta),
                           ("(h) distances", post_h.distances, main_post.distances)):
            same(case, a, b)
        g = counts_h["gated"].get("abc_sim_wave_siard", 0)
        if ((post_h.runs, post_h.simulations) != (main_post.runs, main_post.simulations)
                or counts_h["entries"] != {"abc_sim_wave_siard": post_h.runs + g}
                or not 1 <= counts_h["host_syncs"] <= -(-post_h.runs // tabc.SEGMENT_WAVES)):
            raise AssertionError(f"scaleout_path (h): runs {post_h.runs}, {counts_h}")
        # the host's cost of one count all-reduce, and its completion
        count = torch.zeros((1,), dtype=torch.int64, device=dev)
        for _ in range(20):
            dist.all_reduce(count, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            dist.all_reduce(count, group=group)
        enqueue_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        done_us = (time.perf_counter() - t0) / 500 * 1e6
        turns = {"nccl_world_of_1": [], "pjit_world_of_1": [], "unsharded": []}
        for kind in ("nccl_world_of_1", "pjit_world_of_1", "unsharded", "unsharded",
                     "pjit_world_of_1", "nccl_world_of_1") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "unsharded":
                tabc.run_abc(italy, cfg, seed=0, device=dev)
            else:
                tabc.run_abc(italy, cfg, seed=0, wave_runner=runner if kind.startswith(
                    "nccl") else pjit_runner)
            torch.cuda.synchronize()
            turns[kind].append((time.perf_counter() - t0) * 1e3)

        # one run of each under torch.profiler: what the collective adds on
        # the device and how long the device idles
        profiled = {}
        for kind, fn in (("nccl_world_of_1",
                          lambda: tabc.run_abc(italy, cfg, seed=0, wave_runner=runner)),
                         ("unsharded", lambda: tabc.run_abc(italy, cfg, seed=0, device=dev))):
            wall_ms, busy_ms, by_op = profile_device_ms(fn)
            profiled[kind] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                              "device_idle_share": 1.0 - busy_ms / wall_ms,
                              "device_ops": sum(c for _, c, _ in by_op),
                              "top_device_ops": [{"name": k[:80], "count": c, "device_ms": ms}
                                                 for k, c, ms in by_op[:8]]}

        # ---- (b) the lockstep reference on the card: the tests' size against
        # gloo ranks of the plain version, then 100,000 a shard x 49 days
        small = get_dataset("synthetic_small", num_days=12)
        small_cfg = tabc.ABCConfig(**SCALEOUT_TEST_KW)
        small_sim = tabc.make_simulator(small, small_cfg, dev)
        t0 = time.perf_counter()
        gloo = distributed.spawn_ranks(scaleout_gloo_rank, max(SCALEOUT_SHARDS),
                                       SCALEOUT_SHARDS, SCALEOUT_TEST_KW, device="cpu",
                                       timeout=SCALEOUT_TIMEOUT)
        gloo_s = time.perf_counter() - t0
        digests = {}
        for n in SCALEOUT_SHARDS:
            ref = scaling.make_reference_wave_runner(prior, small_sim, small_cfg, n)
            mine = scaleout_digest(ref, ref(0, 0, ref.init(tabc.ABCState(n_params=8)),
                                            small_cfg.max_runs))
            theirs = [d[n] for d in gloo if n in d]
            if len(theirs) != n or any(t != mine for t in theirs) or not mine[1] > 0:
                raise AssertionError(f"scaleout_path (b): {n} shards on the card {mine}, "
                                     f"gloo ranks {theirs}")
            digests[n] = {"sha256": mine[0], "accepted": mine[1], "waves": mine[2]}
        weak = {}
        for n in SCALEOUT_SHARDS:
            b = n * 100_000
            wcfg = tabc.ABCConfig(batch_size=b, chunk_size=b, num_days=49,
                                  tolerance=main_post.tolerance, target_accepted=4 * b + 1,
                                  max_runs=4, wave_loop="device")
            ref = scaling.make_reference_wave_runner(
                prior, tabc.make_simulator(italy, wcfg, dev), wcfg, n)
            tabc.run_abc(italy, wcfg, seed=0, wave_runner=ref)  # warm-up
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                post_w = tabc.run_abc(italy, wcfg, seed=1, wave_runner=ref)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            weak[n] = {"global_batch": b, "waves": post_w.runs, "walls_s": walls,
                       "sims_per_s": post_w.simulations / min(walls),
                       "accepted": len(post_w)}

        # ---- (c) two gloo ranks sharing cuda:0, against the 2-shard reference
        c_kw = dict(batch_size=200_000, chunk_size=10_000, num_days=49,
                    tolerance=main_post.tolerance, target_accepted=100, max_runs=16,
                    wave_loop="device")
        c_cfg = tabc.ABCConfig(**c_kw)
        ref2 = scaling.make_reference_wave_runner(
            prior, tabc.make_simulator(italy, c_cfg, dev), c_cfg, 2)
        want = scaleout_digest(ref2, ref2(0, 0, ref2.init(tabc.ABCState(n_params=8)),
                                          tabc.SEGMENT_WAVES))
        want_post = tabc.run_abc(italy, c_cfg, seed=0, wave_runner=ref2)
        t0 = time.perf_counter()
        shared = distributed.spawn_ranks(scaleout_shared_card_rank, 2, c_kw, device="cuda:0",
                                         backend="gloo", timeout=SCALEOUT_TIMEOUT)
        shared_s = time.perf_counter() - t0
        for r, (digest, theta, runs, _) in enumerate(shared):
            if digest != want or runs != want_post.runs:
                raise AssertionError(f"scaleout_path (c): rank {r} {digest}, {runs} runs; "
                                     f"the 2-shard reference {want}, {want_post.runs}")
            same(f"(c) rank {r} posterior", theta, want_post.theta)

        # ---- (i) gloo ranks sharing cuda:0 in the pjit style: main_path's
        # posterior on every rank
        pjit_kw = dict(batch_size=100_000, chunk_size=10_000, num_days=49,
                       tolerance=main_post.tolerance, target_accepted=100, wave_loop="device")
        shared_pjit = {}
        for n in PJIT_SHARED_RANKS:
            t0 = time.perf_counter()
            got = distributed.spawn_ranks(pjit_shared_card_rank, n, pjit_kw, device="cuda:0",
                                          backend="gloo", timeout=SCALEOUT_TIMEOUT)
            for r, (theta, d, runs, entries) in enumerate(got):
                same(f"(i) {n} ranks, rank {r} theta", theta, main_post.theta)
                same(f"(i) {n} ranks, rank {r} distances", d, main_post.distances)
                if runs != main_post.runs or set(entries) != {"abc_sim_wave_siard"}:
                    raise AssertionError(f"scaleout_path (i): {n} ranks, rank {r}: {runs} "
                                         f"runs, {entries}")
            shared_pjit[n] = {"spawn_wall_s": time.perf_counter() - t0, "runs": got[0][2],
                              "launches_by_rank": [x[3] for x in got]}

        # ---- (j) metapop_seir at R=20: the single device's wave takes the
        # thread route, a rank's half the warp route
        j_ds, j_cal = pjit_config(dict(batch_size=100_000, chunk_size=10_000, num_days=49,
                                       tolerance=1.0), PJIT_ROUTE_REGIONS)
        j_eps = tabc.calibrate_tolerance(j_ds, j_cal, seed=0, quantile=2e-4,
                                         n_pilot=100_000, device=dev)
        j_kw = dict(batch_size=100_000, chunk_size=10_000, num_days=49, tolerance=j_eps,
                    target_accepted=50, max_runs=16, wave_loop="device")
        _, j_cfg = pjit_config(j_kw, PJIT_ROUTE_REGIONS)
        thread, warp = (abc_sim.entry_name(j_cfg.model, "wave", r) for r in ("thread", "warp"))
        j_solo, j_counts = counted(lambda: tabc.run_abc(j_ds, j_cfg, seed=0, device=dev))
        add(j_counts)
        if set(j_counts["entries"]) != {thread} or not len(j_solo):
            raise AssertionError(f"scaleout_path (j): the single device {j_counts}")
        t0 = time.perf_counter()
        got = distributed.spawn_ranks(pjit_shared_card_rank, 2, j_kw, PJIT_ROUTE_REGIONS,
                                      device="cuda:0", backend="gloo", timeout=SCALEOUT_TIMEOUT)
        j_spawn_s = time.perf_counter() - t0
        for r, (theta, d, runs, entries) in enumerate(got):
            same(f"(j) rank {r} theta", theta, j_solo.theta)
            same(f"(j) rank {r} distances", d, j_solo.distances)
            if runs != j_solo.runs or set(entries) != {warp}:
                raise AssertionError(f"scaleout_path (j): rank {r}: {runs} runs, {entries}")

        # ---- (d) the scaling study at n=1
        scfg = scaling.ScalingConfig(device_counts=(1,), models=("siard",),
                                     batch_per_device=100_000, num_days=49, waves=8, reps=3)
        report, counts_d = counted(lambda: scaling.run_scaling_study(scfg, group, device=dev))
        add(counts_d)
        cell = report["cells"]["siard/cuda/b100000/n1"]
        if (cell["simulations"], cell["waves"], cell["parallel_efficiency"]) != (
                800_000, 8, 1.0):
            raise AssertionError(f"scaleout_path (d): {cell}")

        # ---- (e) the sharded SMC round in a world of 1
        smc_a, counts_e = counted(lambda: run_smc_abc(italy, smc_cfg, seed=0, device=dev,
                                                      group=group))
        add(counts_e)
        smc_b = run_smc_abc(italy, smc_cfg, seed=0, device=dev, group=group)
        same("(e) two sharded rounds", smc_a.theta, smc_b.theta)
        same("(e) against smc_path", smc_a.theta, smc_post.theta)
        if (len(smc_a) != smc_cfg.n_particles or not np.isfinite(smc_a.distances).all()
                or not smc_a.tolerance <= 1.5 * smc_post.tolerance):
            raise AssertionError(f"scaleout_path (e): {len(smc_a)} particles, tolerance "
                                 f"{smc_a.tolerance} against {smc_post.tolerance}")

    # ---- (f) a campaign of two-card groups on one card, and its resume
    out_dir = os.path.join(ROOT, "build", "scaleout_path")
    shutil.rmtree(out_dir, ignore_errors=True)
    ccfg = CampaignConfig(datasets=("italy", "usa"), models=("siard",), batch_size=100_000,
                          num_days=49, target_accepted=100, auto_quantile=1e-4,
                          devices_per_scenario=2, out_dir=out_dir)
    rep, counts_f = counted(lambda: run_campaign(ccfg, device=[dev] * 4))
    add(counts_f)
    if [(r.status, r.device) for r in rep.scenarios] != [("ok", "0+1"), ("ok", "2+3")]:
        raise AssertionError(f"scaleout_path (f): {[(r.status, r.device) for r in rep.scenarios]}")
    cells = []
    for r in rep.scenarios:
        ds = get_dataset(r.dataset, num_days=49)
        shape = ccfg.abc_config(ccfg.scenarios()[0], 1.0)
        eps = tabc.calibrate_tolerance(ds, shape, seed=0, quantile=ccfg.auto_quantile,
                                       n_pilot=ccfg.pilot_size, device=dev)
        solo_cfg = dataclasses.replace(shape, tolerance=eps)
        solo = tabc.run_abc(ds, solo_cfg, seed=0, wave_runner=scaling.make_reference_wave_runner(
            prior, tabc.make_simulator(ds, solo_cfg, dev), solo_cfg, 2))
        cap = tabc.wave_capacity(solo_cfg, 50_000)
        tree, meta, _ = load_checkpoint(r.checkpoint_dir, {
            "theta_buf": np.zeros((2 * cap, 8), np.float32),
            "dist_buf": np.zeros((2 * cap,), np.float32)})
        rows = np.concatenate([tree["theta_buf"][s * cap:s * cap + c]
                               for s, c in enumerate(meta["fills"])])
        same(f"(f) {r.name} rows", rows, solo.theta)
        if (eps, solo.runs, solo.simulations) != (r.tolerance, r.runs, r.simulations):
            raise AssertionError(f"scaleout_path (f): {r.name} against its solo run")
        cells.append({"name": r.name, "device": r.device, "runs": r.runs,
                      "accepted": r.n_accepted, "fills": meta["fills"],
                      "tolerance": r.tolerance})
    rep2, counts_f2 = counted(lambda: run_campaign(ccfg, device=[dev] * 4))
    if ([r.status for r in rep2.scenarios] != ["resumed_complete"] * 2
            or counts_f2["entries"]):
        raise AssertionError(f"scaleout_path (f): resume {[r.status for r in rep2.scenarios]}, "
                             f"{counts_f2['entries']}")
    shutil.rmtree(out_dir, ignore_errors=True)

    # ---- (g) every wave entry at sample offsets, and its time at offset 50,000
    offsets = offset_phase(dev)

    emit("scaleout_path", kind=name, nvidia_smi=smi,
         a_nccl_world_of_1={"posterior_bitwise_main_path": True, "waves": post_a.runs,
                            "accepted": len(post_a), "counts": counts_a,
                            "warm_time_to_posterior_ms": {
                                k: float(np.mean(v)) for k, v in turns.items()},
                            "turns_ms": turns,
                            "profiled": profiled,
                            "count_all_reduce_us": {"host_enqueue": enqueue_us,
                                                    "to_completion": done_us,
                                                    "calls": 500}},
         b_reference={"tests_size": {"config": SCALEOUT_TEST_KW, "digests": digests,
                                     "gloo_ranks": max(SCALEOUT_SHARDS),
                                     "gloo_spawn_s": gloo_s},
                      "weak_100k_a_shard_x49": weak,
                      "note": "every shard on one card, lockstep: not a scaling figure"},
         c_two_gloo_ranks_on_cuda0={"bitwise_2_shard_reference": True,
                                    "runs": want_post.runs, "accepted": len(want_post),
                                    "rank_walls_s": [s[3] for s in shared],
                                    "spawn_wall_s": shared_s,
                                    "note": "both ranks share one card: not a scaling figure"},
         d_study=report, d_counts=counts_d,
         e_sharded_smc={"bitwise_smc_path": True, "particles": len(smc_a),
                        "tolerance": smc_a.tolerance, "smc_path_tolerance": smc_post.tolerance,
                        "round_waves": smc_a.round_waves, "counts": counts_e},
         f_campaign={"cells": cells, "wall_s": counts_f["wall_s"], "counts": counts_f,
                     "resume_wall_s": counts_f2["wall_s"], "resume_launches": 0},
         g_offsets=offsets,
         h_pjit_nccl_world_of_1={"posterior_bitwise_main_path": True, "waves": post_h.runs,
                                 "counts": counts_h,
                                 "warm_time_to_posterior_ms": float(np.mean(
                                     turns["pjit_world_of_1"]))},
         i_pjit_gloo_ranks_on_cuda0={
             "posterior_bitwise_main_path": True, "ranks": shared_pjit,
             "note": "every rank shares one card: not a scaling figure"},
         j_pjit_metapop_r20={
             "posterior_bitwise_single_device": True, "regions": PJIT_ROUTE_REGIONS,
             "single_device_route": "thread", "rank_route": "warp", "tolerance": j_eps,
             "runs": j_solo.runs, "accepted": len(j_solo), "single_device_counts": j_counts,
             "spawn_wall_s": j_spawn_s, "launches_by_rank": [x[3] for x in got]})
    return launches, gated


def lm_phases(dev, name: str, smi: str, flash_errs, cuda_core_fn) -> list:
    """lm_prefill, lm_profile, lm_serve and lm_timing; returns the flash
    kernels' lines of the kernels record, bf16 then float32. `cuda_core_fn`
    is the CUDA-core float32 kernel of experiments/flash_f32_cuda_core.py,
    timed in turns with the 3xTF32 one."""
    import torch
    import torch.nn.functional as F

    from flash_f32_cuda_core import run as run_cuda_core
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_model

    model = get_model("gemma-2b")
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init_params(device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(4, 2048)), device=dev)
    flash_model = model.with_cfg(attn_impl="flash")

    # ---- lm_prefill: the main path through the kernel, counters around it
    fa.LAUNCHES = fa.LAUNCHES_TENSOR_CORE = fa.LAUNCHES_TENSOR_CORE_F32 = 0
    ref.FLASH_CALLS = 0
    t0 = time.perf_counter()
    logits = flash_model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = fa.LAUNCHES, ref.FLASH_CALLS
    tc_launches, f32_launches = fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32
    if (launches, tc_launches, f32_launches, plain_calls) != (cfg.n_layers, cfg.n_layers, 0, 0):
        raise AssertionError(f"lm_prefill: {launches} flash launches, {tc_launches} of the "
                             f"bf16 kernel (want {cfg.n_layers} and {cfg.n_layers}), "
                             f"{f32_launches} of the float32 one, {plain_calls} plain-version "
                             f"calls")
    dense = model.with_cfg(attn_impl="dense").prefill(params, {"tokens": tokens})
    if logits.shape != (4, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_prefill: logits {tuple(logits.shape)}, finite="
                             f"{bool(torch.isfinite(logits).all())}")
    diff = float((logits - dense).abs().max())
    top = float(dense.abs().max())
    bar = PREFILL_BAR_STEPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    top2 = torch.topk(dense[:, 0], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
    agree = logits[:, 0].argmax(-1) == dense[:, 0].argmax(-1)
    if not diff <= bar or not bool(agree[decided].all()):
        raise AssertionError(f"lm_prefill: flash vs dense max |diff| {diff} (bar {bar}), "
                             f"argmax agreement {agree.tolist()} on rows {decided.tolist()}")
    emit("lm_prefill", arch=cfg.name, batch=4, prompt_len=2048, params=model.param_count(),
         init_s=init_s, wall_s=wall, flash_launches=launches,
         tensor_core_launches=tc_launches, tensor_core_f32_launches=f32_launches,
         plain_calls=plain_calls,
         max_abs_diff_vs_dense=diff, max_abs_logit=top, bar=bar,
         argmax_agree=agree.tolist(), argmax_decided_rows=decided.tolist(),
         kind=name, nvidia_smi=smi)

    # ---- lm_profile: one flash prefill, device time by kernel
    wall_ms, busy_ms, by_op = profile_device_ms(
        lambda: flash_model.prefill(params, {"tokens": tokens}))
    flash_ms = sum(ms for k, _, ms in by_op if "flash_fwd" in k)
    gemm_ms = sum(ms for k, _, ms in by_op
                  if any(t in k.lower() for t in ("gemm", "xmma", "nvjet", "cutlass")))
    emit("lm_profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms, flash_device_ms=flash_ms,
         matmul_device_ms=gemm_ms, other_device_ms=busy_ms - flash_ms - gemm_ms,
         kind=name, nvidia_smi=smi,
         top_device_ops=[{"name": k[:80], "count": c, "device_ms": ms}
                         for k, c, ms in by_op[:10]])
    del params, logits, dense
    torch.cuda.empty_cache()

    # ---- lm_serve: the serving CLI at full width with its defaults
    stats = serve.main(["--arch", "gemma-2b", "--device", "cuda"])
    if stats["requests"] != 8 or any(len(o) != 8 for o in stats["outputs"]):
        raise AssertionError(f"lm_serve: {stats['requests']} requests answered")
    emit("lm_serve", requests=stats["requests"], decode_steps=stats["steps"],
         seconds=stats["seconds"], tok_per_s=stats["tok_per_s"], kind=name, nvidia_smi=smi)
    torch.cuda.empty_cache()

    # ---- lm_timing: each route's kernel alone beside its bound, plain version, SDPA;
    # in float32 the CUDA-core kernel it replaced in turns with it
    cells = []
    sdpa_f32_ops = None
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, iters in ((4, 2048, 20), (1, 8192, 10)):
            rng = np.random.default_rng(s)
            q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
                       .to(device=dev, dtype=dtype)
                       for shape in ((b, s, 8, 256), (b, s, 1, 256), (b, s, 1, 256)))
            before = (fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32)

            def kernel():
                return fa.flash_attention_kernel(q, k, v, causal=True)

            flops = fa.attention_flops(b, s, s, 8, 256, causal=True)
            n_bytes = fa.attention_bytes(q, k, v)
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            cell = {"dtype": str(dtype).split(".")[1], "batch": b, "seq": s}
            if dtype == torch.bfloat16:
                ms = cuda_ms(kernel, iters)
                ops_ms = flops / BF16_OPS_PER_S * 1e3
                cell.update(peak_ops_per_s=BF16_OPS_PER_S, iters=iters)
            else:
                iters = max(2, iters // 2)
                turns = {"tf32": [], "cuda_core": []}
                for which in ("tf32", "cuda_core", "cuda_core", "tf32"):
                    fn = kernel if which == "tf32" else (
                        lambda: run_cuda_core(cuda_core_fn, q, k, v, causal=True))
                    turns[which].append(cuda_ms(fn, iters))
                ms = float(np.mean(turns["tf32"]))
                cuda_core_ms = float(np.mean(turns["cuda_core"]))
                ops_ms = TF32_PASSES * flops / TF32_OPS_PER_S * 1e3
                cc_bound = max(flops / F32_OPS_PER_S * 1e3, bytes_ms)
                cell.update(peak_ops_per_s=TF32_OPS_PER_S, tf32_passes=TF32_PASSES,
                            turns_ms=turns, cuda_core_ms=cuda_core_ms,
                            bound_ms_cuda_core=cc_bound,
                            cuda_core_share_of_its_bound=cc_bound / cuda_core_ms,
                            speedup_over_cuda_core=cuda_core_ms / ms, iters=iters)
            after = (fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32)
            route = fa.TENSOR_CORE if after[0] > before[0] else fa.TENSOR_CORE_F32
            if after[0] > before[0] and after[1] > before[1]:
                raise AssertionError("lm_timing: one dtype launched both kernels")
            plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 2,
                               warmup=1)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)

            library_ms = cuda_ms(sdpa, iters)
            if dtype == torch.float32 and sdpa_f32_ops is None:
                # the kernels SDPA launches in float32, from one profiled call
                _, _, by_op = profile_device_ms(sdpa)
                sdpa_f32_ops = [{"name": k_[:160], "count": c, "device_ms": t_}
                                for k_, c, t_ in by_op[:6]]
            bound = max(ops_ms, bytes_ms)
            cell.update(route=route, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        flops=flops, bytes=n_bytes, bound_ms=bound,
                        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                        share_of_bound=bound / ms, tflops=flops / (ms * 1e-3) / 1e12)
            cells.append(cell)
            del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    emit("lm_timing", kind=name, nvidia_smi=smi, peak_bf16_ops_per_s=BF16_OPS_PER_S,
         peak_tf32_ops_per_s=TF32_OPS_PER_S, peak_f32_ops_per_s=F32_OPS_PER_S,
         peak_bytes_per_s=HBM_BYTES_PER_S, sdpa_f32_device_ops=sdpa_f32_ops, cells=cells)
    main_cell, f32_cell = cells[0], cells[2]
    if main_cell["route"] != fa.TENSOR_CORE or f32_cell["route"] != fa.TENSOR_CORE_F32:
        raise AssertionError("lm_timing: a dtype did not go through its route's kernel")
    lines = [{"name": f"flash_fwd_{tag}", "route": "cuda", "source": source,
              "replaces": FLASH_TPU_KERNEL, "launches": n, "max_abs_err": err,
              "ms": cell["ms"], "plain_ms": cell["plain_ms"], "bound_ms": cell["bound_ms"],
              "bound_by": cell["bound_by"], "library_ms": cell["library_ms"]}
             for tag, source, n, err, cell in (
                 ("bf16", FLASH_SOURCE, tc_launches, flash_errs[0], main_cell),
                 ("f32", FLASH_F32_SOURCE, f32_launches, flash_errs[1], f32_cell))]
    lines[1].update(bound_ms_cuda_core=f32_cell["bound_ms_cuda_core"],
                    cuda_core_ms=f32_cell["cuda_core_ms"])
    return lines


def decode_weight_bytes(params, cfg) -> int:
    """Bytes of the weights one decode step reads: every parameter but an
    untied embedding table, whose rows a step only gathers. The capacity
    dispatch runs every routed expert at every step, so all of them count.
    A vlm's step is its decoder's: the projector is not read. Each weight
    counts once (the hybrid's shared block too, though a step reads it at
    each of its sites)."""
    import torch

    if hasattr(cfg, "lm"):
        params, cfg = params["lm"], cfg.lm
    skip = None if cfg.tie_embed else params["embed"]
    stack = [params]
    total = 0
    while stack:
        item = stack.pop()
        if isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
        elif isinstance(item, torch.Tensor) and item is not skip:
            total += item.numel() * item.element_size()
    return total


class RoutingPin:
    """Hold one MoE prefill's routing to another's. `record()` keeps the
    router inputs and top_ids of each MoE layer of a reference run; under
    `pin()` each layer of the next run routes as its own router says,
    except at the tokens where it chose another expert set than the
    reference: there it takes the reference's experts (weights from its own
    probabilities), provided the difference of the two router inputs
    explains the flip (the reference's logit gap between a dropped and an
    added expert within sum_i |dx_i| (|R_ia| + |R_ib|)); else it raises."""

    def __init__(self, moe_lib):
        self.moe_lib, self.ref, self.flips, self.worst = moe_lib, [], 0, 0.0

    @classmethod
    def around(cls, moe_lib, reference, run, enabled=True):
        """(reference(), run()) with `run`'s routing pinned to
        `reference`'s (its own if not `enabled`), and the pin."""
        if not enabled:
            return reference(), run(), None
        pin = cls(moe_lib)
        with pin.record():
            want = reference()
        with pin.pin():
            got = run()
        return want, got, pin

    def _patched(self, fn):
        import contextlib

        @contextlib.contextmanager
        def cm():
            route = self.moe_lib.route
            self.moe_lib.route = fn(route)
            try:
                yield self
            finally:
                self.moe_lib.route = route
        return cm()

    def record(self):
        def wrap(route):
            def recording(xf, router, cfg, c):
                r = route(xf, router, cfg, c)
                self.ref.append((xf.detach().clone(), r.top_ids.clone()))
                return r
            return recording
        return self._patched(wrap)

    def pin(self, index=None):
        """Pin each call to the reference's; `index(n)` names the reference
        call of this run's call n (the same n by default)."""
        import torch

        calls = iter(range(10**9))
        index = index or (lambda n: n)

        def wrap(route):
            def pinned(xf, router, cfg, c):
                xr, ids_ref = (t.to(xf.device) for t in self.ref[index(next(calls))])
                r = route(xf, router, cfg, c)
                differ = (r.top_ids.sort(-1).values != ids_ref.sort(-1).values).any(-1)
                tokens = torch.nonzero(differ).flatten().tolist()
                if not tokens:
                    return r
                rf = router.detach().to(torch.float32)
                for t in tokens:
                    ref_logits = xr[t].to(torch.float32) @ rf
                    slack = (xf[t].detach().to(torch.float32)
                             - xr[t].to(torch.float32)).abs() @ rf.abs()
                    for a in set(ids_ref[t].tolist()) - set(r.top_ids[t].tolist()):
                        for b in set(r.top_ids[t].tolist()) - set(ids_ref[t].tolist()):
                            gap = float(ref_logits[a] - ref_logits[b])
                            bound = float(slack[a] + slack[b]) + 1e-5
                            if gap > bound:
                                raise AssertionError(
                                    f"routing: token {t} goes to expert {b} instead of {a}; "
                                    f"the logit gap {gap} is more than the router inputs' "
                                    f"difference explains ({bound})")
                            self.worst = max(self.worst, gap / bound)
                self.flips += len(tokens)
                select = self.moe_lib.select_experts

                def take_reference(probs, k):
                    w, ids = select(probs, k)
                    w, ids = w.clone(), ids.clone()  # top-k's backward reads its own
                    ids[differ] = ids_ref[differ]
                    picked = torch.gather(probs[differ], 1, ids[differ])
                    w[differ] = picked / picked.sum(-1, keepdim=True)
                    return w, ids

                self.moe_lib.select_experts = take_reference
                try:
                    return route(xf, router, cfg, c)
                finally:
                    self.moe_lib.select_experts = select
            return pinned
        return self._patched(wrap)


def moe_phases(dev, name: str, smi: str) -> dict:
    """moe_layer, moe_prefill, moe_profile and moe_serve for each of
    MOE_ARCHS; returns the bf16 flash kernel's launches on each prefill."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.registry import get_model

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9

    launches = {}
    for arch in MOE_ARCHS:
        model = get_model(arch)
        cfg, mcfg = model.cfg, model.cfg.moe
        torch.cuda.empty_cache()
        # ---- moe_layer: one full-width layer against the dense oracle
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        p = moe_lib.init_moe(gen, cfg.d_model, mcfg)
        x = torch.randn((4, 2048, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        n = x.shape[0] * x.shape[1]
        ample = dataclasses.replace(mcfg, capacity_factor=mcfg.n_experts / mcfg.top_k)
        y, aux = moe_lib.moe_ffn(x, p, ample)
        want = moe_lib.dense_reference(x, p, mcfg)
        r = compare(f"moe_layer {arch}: ample capacity vs the dense oracle", y.float(),
                    want.float(), **MOE_ORACLE_BAR)
        c = moe_lib.capacity(n, mcfg)
        routing = moe_lib.route(x.reshape(n, -1), p["router"], mcfg, c)
        dropped = float((~routing.keep).double().mean())
        layer_ms = cuda_ms(lambda: moe_lib.moe_ffn(x, p, mcfg), 5)
        oracle_ms = cuda_ms(lambda: moe_lib.dense_reference(x, p, mcfg), 3, warmup=1)
        emit("moe_layer", arch=arch, tokens=n, experts=mcfg.n_experts, top_k=mcfg.top_k,
             capacity=c, capacity_ample=moe_lib.capacity(n, ample),
             dropped_share_default_capacity=dropped, aux=float(aux), comparison=r,
             ms_default_capacity=layer_ms, dense_oracle_ms=oracle_ms,
             max_memory_allocated_gb=peak_gb(), kind=name, nvidia_smi=smi)
        del p, x, y, want, routing
        torch.cuda.empty_cache()

        # ---- moe_prefill: full width and depth through the flash kernel
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = model.init_params(device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, size=(4, 2048)), device=dev)
        flash_model = model.with_cfg(attn_impl="flash")
        dropped_slots = []
        route = moe_lib.route

        def counting_route(xf, router, mcfg_, c_):
            out = route(xf, router, mcfg_, c_)
            dropped_slots.append((~out.keep).sum())
            return out

        moe_lib.route = counting_route
        try:
            fa.LAUNCHES = fa.LAUNCHES_TENSOR_CORE = fa.LAUNCHES_TENSOR_CORE_F32 = 0
            ref.FLASH_CALLS = 0
            t0 = time.perf_counter()
            logits = flash_model.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
                      ref.FLASH_CALLS)
        finally:
            moe_lib.route = route
        if counts != (cfg.n_layers, cfg.n_layers, 0, 0):
            raise AssertionError(f"moe_prefill {arch}: (flash, bf16 kernel, float32 kernel, "
                                 f"plain) launches {counts}, want ({cfg.n_layers}, "
                                 f"{cfg.n_layers}, 0, 0)")
        launches[f"moe_prefill {arch}"] = counts[1]
        n_moe = cfg.n_layers - cfg.n_dense_prefix
        if len(dropped_slots) != n_moe:
            raise AssertionError(f"moe_prefill {arch}: {len(dropped_slots)} MoE layers routed, "
                                 f"want {n_moe}")
        dropped_share = float(torch.stack(dropped_slots).sum()) / (n_moe * n * mcfg.top_k)
        prefill_peak = peak_gb()
        # the dense route as the reference; the flash route again, its routing
        # pinned to the dense run's where the two tell a near-tie apart otherwise
        pin = RoutingPin(moe_lib)
        with pin.record():
            dense = model.with_cfg(attn_impl="dense").prefill(params, {"tokens": tokens})
        with pin.pin():
            pinned = flash_model.prefill(params, {"tokens": tokens})
        del pin.ref
        unpinned_diff = float((logits - dense).abs().max())
        logits = pinned
        if logits.shape != (4, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"moe_prefill {arch}: logits {tuple(logits.shape)}, finite="
                                 f"{bool(torch.isfinite(logits).all())}")
        diff = float((logits - dense).abs().max())
        top = float(dense.abs().max())
        bar = PREFILL_BAR_STEPS * 2.0 ** (np.floor(np.log2(top)) - 7)
        top2 = torch.topk(dense[:, 0], 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
        agree = logits[:, 0].argmax(-1) == dense[:, 0].argmax(-1)
        if not diff <= bar or not bool(agree[decided].all()):
            raise AssertionError(f"moe_prefill {arch}: flash vs dense max |diff| {diff} (bar "
                                 f"{bar}), argmax agreement {agree.tolist()} on rows "
                                 f"{decided.tolist()}")
        emit("moe_prefill", arch=arch, batch=4, prompt_len=2048, params=model.param_count(),
             active_params=model.active_param_count(), init_s=init_s, wall_s=wall,
             tok_per_s=n / wall, flash_launches=counts[0], tensor_core_launches=counts[1],
             tensor_core_f32_launches=counts[2], plain_calls=counts[3],
             dropped_share=dropped_share, capacity=moe_lib.capacity(n, mcfg),
             routing_flips_pinned=pin.flips, routing_flip_worst_gap_over_bound=pin.worst,
             max_abs_diff_vs_dense_unpinned=unpinned_diff,
             max_abs_diff_vs_dense=diff, max_abs_logit=top, bar=bar,
             argmax_agree=agree.tolist(), argmax_decided_rows=decided.tolist(),
             max_memory_allocated_gb=prefill_peak, kind=name, nvidia_smi=smi)
        del dense, logits, pinned

        # ---- moe_profile: one flash prefill, device time by kernel
        wall_ms, busy_ms, by_op = profile_device_ms(
            lambda: flash_model.prefill(params, {"tokens": tokens}))
        flash_ms = sum(ms for k, _, ms in by_op if "flash_fwd" in k)
        gemm_ms = sum(ms for k, _, ms in by_op
                      if any(t in k.lower() for t in ("gemm", "xmma", "nvjet", "cutlass")))
        emit("moe_profile", arch=arch, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=1.0 - busy_ms / wall_ms, flash_device_ms=flash_ms,
             matmul_device_ms=gemm_ms, other_device_ms=busy_ms - flash_ms - gemm_ms,
             kind=name, nvidia_smi=smi,
             top_device_ops=[{"name": k[:80], "count": c_, "device_ms": ms}
                             for k, c_, ms in by_op[:10]])

        # ---- moe_serve: a decode step of 4 slots beside its weight-read floor,
        # two requests served alone, then the serving CLI with its defaults
        cache = model.init_cache(4, 24, dev)
        step = {"tokens": tokens[:, :1].contiguous(),
                "pos": torch.full((4,), 16, dtype=torch.long, device=dev)}
        step_ms = cuda_ms(lambda: model.decode_step(params, cache, step), MOE_DECODE_ITERS)
        step_wall_ms, step_busy_ms, step_ops = profile_device_ms(
            lambda: model.decode_step(params, cache, step))
        weight_bytes = decode_weight_bytes(params, cfg)
        floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
        rng = np.random.default_rng(0)  # the prompts of serve.run_lm_cli
        prompts = [rng.integers(0, cfg.vocab, size=16).astype(np.int32).tolist()
                   for _ in range(8)]
        alone = [serve.run_lm_server(model, [prompts[i]], 8, 1, 24, params=params,
                                     device=dev)[0][0] for i in (0, 1)]
        del params, cache, step, tokens
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        runs = {"bf16 cache": ()}
        if arch == MOE_ARCHS[0]:
            runs["int8 cache"] = (("REPRO_KV_QUANT", "1"),)
        for tag, env in runs.items():
            os.environ.update(env)
            try:
                stats = serve.main(["--arch", arch, "--device", "cuda"])
            finally:
                for key, _ in env:
                    del os.environ[key]
            torch.cuda.empty_cache()
            outs = stats["outputs"]
            if stats["requests"] != 8 or len(outs) != 8 or any(len(o) != 8 for o in outs):
                raise AssertionError(f"moe_serve {arch} {tag}: {stats['requests']} requests, "
                                     f"lengths {[len(o) for o in outs]}")
            if tag == "bf16 cache" and outs[:2] != alone:
                raise AssertionError(f"moe_serve {arch}: batched {outs[:2]} != alone {alone}")
            emit("moe_serve", arch=arch, cache=tag, requests=stats["requests"],
                 decode_steps=stats["steps"], seconds=stats["seconds"],
                 tok_per_s=stats["tok_per_s"],
                 cli_ms_per_step=stats["seconds"] / stats["steps"] * 1e3,
                 decode_step_ms=step_ms if tag == "bf16 cache" else None,
                 decode_step_iters=MOE_DECODE_ITERS,
                 decode_step_profile=None if tag != "bf16 cache" else {
                     "wall_ms": step_wall_ms, "device_busy_ms": step_busy_ms,
                     "device_idle_share": 1.0 - step_busy_ms / step_wall_ms,
                     "kernels": sum(c_ for _, c_, _ in step_ops),
                     "top_device_ops": [{"name": k[:80], "count": c_, "device_ms": ms}
                                        for k, c_, ms in step_ops[:6]]},
                 weight_read_bytes=weight_bytes,
                 weight_read_floor_ms=floor_ms, alone_equal_batched=tag == "bf16 cache",
                 max_memory_allocated_gb=peak_gb(), kind=name, nvidia_smi=smi)
    return launches


#: the ssm, hybrid and vlm families and the dense configs internlm2-20b and
#: minitron-8b, prefilled and served at full width and depth (family_prefill,
#: family_profile, family_serve), in the order they run: internlm2-20b's 40 GB
#: of weights last, before the MoE phases
FAMILY_ARCHS = ("mamba2-130m", "zamba2-2.7b", "internvl2-2b", "minitron-8b", "internlm2-20b")
#: mamba2-130m's chunked prefill against its own decode, one token at a time,
#: over the first SSM_DECODE_TOKENS tokens of each prompt. The two forms are one
#: recurrence: in float32 (the same weights, cast) they agree to float32
#: rounding, held at SSM_DECODE_F32_REL of the largest |logit|. In bf16 the
#: chunked form rounds the decay-weighted scores and x * dt to bf16 where the
#: recurrence keeps float32; over 24 layers that moved the logits by 10.9 bf16
#: steps at 128 tokens and 20.2 at 256 on the CPU (the same model, seeded 0), so
#: the bf16 bar is SSM_DECODE_BAR_STEPS steps at the largest |logit|, with no
#: argmax rule
SSM_DECODE_TOKENS = 128
SSM_DECODE_F32_REL = 1e-4
SSM_DECODE_BAR_STEPS = 32
#: decode steps of 4 slots timed with CUDA events beside the weight-read floor
FAMILY_DECODE_ITERS = 10


def family_flash_cell(dev, b, s, h, kh, d, iters=20) -> dict:
    """The bf16 flash kernel alone at (b, s, h, kh, d), causal, beside the
    plain version and SDPA; its bound from 4 * d operations a pair, and from
    4 * DP at the head dim DP the kernel pads d to (a multiple of 64)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(s + h)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
               .to(device=dev, dtype=torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    before = fa.LAUNCHES_TENSOR_CORE
    ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, causal=True), iters)
    if fa.LAUNCHES_TENSOR_CORE == before:
        raise AssertionError(f"family_flash_timing: ({b}, {s}, {h}, {kh}, {d}) did not "
                             f"launch the bf16 kernel")
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=h != kh), iters)
    dp = -(-d // 64) * 64
    bytes_ms = fa.attention_bytes(q, k, v) / HBM_BYTES_PER_S * 1e3
    ops_ms = fa.attention_flops(b, s, s, h, d, causal=True) / BF16_OPS_PER_S * 1e3
    padded_ms = fa.attention_flops(b, s, s, h, dp, causal=True) / BF16_OPS_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    return {"shape": [b, s, h, kh, d], "padded_head_dim": dp, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_padded": max(padded_ms, bytes_ms), "share_of_bound": bound / ms,
            "iters": iters}


def ssm_decode_check(dev, model, params, tokens) -> dict:
    """mamba2-130m's chunked prefill of `tokens`' first SSM_DECODE_TOKENS
    columns against its decode_step fed the same tokens one at a time, in
    bf16 and in float32 (weights cast); raises past the bars above."""
    import torch

    from repro_torch.models import common as cm

    toks = tokens[:, :SSM_DECODE_TOKENS].contiguous()

    def run(p):
        pre = model.prefill(p, {"tokens": toks})
        cache = model.init_cache(toks.shape[0], 0, dev)
        for i in range(toks.shape[1]):
            logits, cache = model.decode_step(p, cache, {"tokens": toks[:, i:i + 1], "pos": i})
        return pre, logits

    def to_f32(t):
        if isinstance(t, dict):
            return {k: to_f32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_f32(v) for v in t]
        return t.to(torch.float32)

    out = {"decode_check_tokens": toks.shape[1]}
    pre, dec = run(params)
    top, diff = float(pre.abs().max()), float((dec - pre).abs().max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    if not diff <= SSM_DECODE_BAR_STEPS * step:
        raise AssertionError(f"family_prefill mamba2-130m: bf16 decode vs chunked prefill "
                             f"{diff} ({diff / step} steps, bar {SSM_DECODE_BAR_STEPS})")
    out.update(decode_vs_prefill_bf16_max_abs=diff, decode_vs_prefill_bf16_steps=diff / step,
               decode_vs_prefill_bf16_bar=SSM_DECODE_BAR_STEPS * step,
               decode_vs_prefill_bf16_argmax_agree=(dec[:, 0].argmax(-1) ==
                                                    pre[:, 0].argmax(-1)).tolist())
    bf16 = cm.DEFAULT_DTYPE
    cm.DEFAULT_DTYPE = torch.float32  # embeddings and the conv cache in float32
    try:
        pre, dec = run(to_f32(params))
    finally:
        cm.DEFAULT_DTYPE = bf16
    top, diff = float(pre.abs().max()), float((dec - pre).abs().max())
    if pre.dtype != torch.float32 or not diff <= SSM_DECODE_F32_REL * top:
        raise AssertionError(f"family_prefill mamba2-130m: float32 decode vs chunked prefill "
                             f"{diff}, bar {SSM_DECODE_F32_REL * top}")
    out.update(decode_vs_prefill_f32_max_abs=diff,
               decode_vs_prefill_f32_bar=SSM_DECODE_F32_REL * top)
    return out


def family_phases(dev, name: str, smi: str) -> tuple:
    """family_prefill, family_profile and family_serve for each of
    FAMILY_ARCHS, and family_flash_timing at zamba2-2.7b's attention shape;
    returns (the bf16 flash kernel's launches on each prefill, the timing
    cell)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_model

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9

    launches, zamba_cell = {}, None
    for arch in FAMILY_ARCHS:
        model = get_model(arch)
        cfg = model.cfg
        lm = cfg.lm if model.family == "vlm" else cfg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = model.init_params(device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        if model.family == "vlm":  # 256 image rows, then 1,792 text tokens
            gen = torch.Generator(device=dev).manual_seed(0)
            batch = {"patch_embeds": torch.randn((4, cfg.n_patches, cfg.vit_dim), generator=gen,
                                                 device=dev).to(torch.bfloat16),
                     "tokens": torch.as_tensor(rng.integers(
                         0, lm.vocab, size=(4, 2048 - cfg.n_patches)), device=dev)}
        else:
            batch = {"tokens": torch.as_tensor(rng.integers(0, lm.vocab, size=(4, 2048)),
                                               device=dev)}
        sites = {"ssm": 0, "hybrid": getattr(cfg, "n_super", 0)}.get(model.family, lm.n_layers)
        run = model if model.family == "ssm" else model.with_cfg(attn_impl="flash")

        # ---- family_prefill: full width and depth, the counters around it
        fa.LAUNCHES = fa.LAUNCHES_TENSOR_CORE = fa.LAUNCHES_TENSOR_CORE_F32 = 0
        ref.FLASH_CALLS = 0
        t0 = time.perf_counter()
        logits = run.prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
                  ref.FLASH_CALLS)
        if counts != (sites, sites, 0, 0):
            raise AssertionError(f"family_prefill {arch}: (flash, bf16 kernel, float32 kernel, "
                                 f"plain) launches {counts}, want ({sites}, {sites}, 0, 0)")
        launches[f"family_prefill {arch}"] = counts[1]
        if logits.shape != (4, 1, lm.vocab) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"family_prefill {arch}: logits {tuple(logits.shape)}, "
                                 f"finite={bool(torch.isfinite(logits).all())}")
        prefill_peak = peak_gb()
        if model.family == "ssm":
            checks = ssm_decode_check(dev, model, params, batch["tokens"])
        else:
            dense = model.with_cfg(attn_impl="dense").prefill(params, batch)
            diff = float((logits - dense).abs().max())
            top = float(dense.abs().max())
            bar = PREFILL_BAR_STEPS * 2.0 ** (np.floor(np.log2(top)) - 7)
            top2 = torch.topk(dense[:, 0], 2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
            agree = logits[:, 0].argmax(-1) == dense[:, 0].argmax(-1)
            if not diff <= bar or not bool(agree[decided].all()):
                raise AssertionError(f"family_prefill {arch}: flash vs dense max |diff| {diff} "
                                     f"(bar {bar}), argmax agreement {agree.tolist()} on rows "
                                     f"{decided.tolist()}")
            checks = dict(max_abs_diff_vs_dense=diff, max_abs_logit=top, bar=bar,
                          argmax_agree=agree.tolist(), argmax_decided_rows=decided.tolist())
            del dense
        emit("family_prefill", arch=arch, family=model.family, batch=4, prompt_len=2048,
             patches=getattr(cfg, "n_patches", 0), params=model.param_count(), init_s=init_s,
             wall_s=wall, tok_per_s=4 * 2048 / wall, flash_launches=counts[0],
             tensor_core_launches=counts[1], tensor_core_f32_launches=counts[2],
             plain_calls=counts[3], max_memory_allocated_gb=prefill_peak, kind=name,
             nvidia_smi=smi, **checks)
        del logits

        # ---- family_profile: one prefill, device time by kernel
        wall_ms, busy_ms, by_op = profile_device_ms(lambda: run.prefill(params, batch))
        flash_ms = sum(ms for k, _, ms in by_op if "flash_fwd" in k)
        gemm_ms = sum(ms for k, _, ms in by_op
                      if any(t in k.lower() for t in ("gemm", "xmma", "nvjet", "cutlass")))
        emit("family_profile", arch=arch, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=1.0 - busy_ms / wall_ms, flash_device_ms=flash_ms,
             matmul_device_ms=gemm_ms, other_device_ms=busy_ms - flash_ms - gemm_ms,
             kernels=sum(c for _, c, _ in by_op), kind=name, nvidia_smi=smi,
             top_device_ops=[{"name": k[:80], "count": c, "device_ms": ms}
                             for k, c, ms in by_op[:10]])
        if model.family == "hybrid":
            zamba_cell = family_flash_cell(dev, 4, 2048, cfg.n_heads, cfg.n_kv_heads,
                                           cfg.head_dim)
            emit("family_flash_timing", arch=arch, kind=name, nvidia_smi=smi,
                 peak_bf16_ops_per_s=BF16_OPS_PER_S, peak_bytes_per_s=HBM_BYTES_PER_S,
                 **zamba_cell)

        # ---- family_serve: a decode step of 4 slots beside its weight-read
        # floor, two requests served alone, then the serving CLI's defaults
        cache = model.init_cache(4, 24, dev)
        step = {"tokens": batch["tokens"][:, :1].contiguous(),
                "pos": torch.full((4,), 16, dtype=torch.long, device=dev)}
        step_ms = cuda_ms(lambda: model.decode_step(params, cache, step), FAMILY_DECODE_ITERS)
        step_wall_ms, step_busy_ms, step_ops = profile_device_ms(
            lambda: model.decode_step(params, cache, step))
        weight_bytes = decode_weight_bytes(params, cfg)
        reread = ((cfg.n_super - 1) * decode_weight_bytes(params["shared"], cfg)
                  if model.family == "hybrid" else 0)
        rng = np.random.default_rng(0)  # the prompts of serve.run_lm_cli
        prompts = [rng.integers(0, lm.vocab, size=16).astype(np.int32).tolist()
                   for _ in range(8)]
        # alone: one request in the CLI's 4 slots, the others idle. cuBLAS
        # picks its product kernels by the row count, so a 1-slot server
        # rounds the projections otherwise than a 4-slot one (zamba2's first
        # request took another token at a near-tie, step 8, in a first run)
        alone = [serve.run_lm_server(model, [prompts[i]], 8, 4, 24, params=params,
                                     device=dev)[0][0] for i in (0, 1)]
        del params, cache, step, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        stats = serve.main(["--arch", arch, "--device", "cuda"])
        torch.cuda.empty_cache()
        outs = stats["outputs"]
        if stats["requests"] != 8 or len(outs) != 8 or any(len(o) != 8 for o in outs):
            raise AssertionError(f"family_serve {arch}: {stats['requests']} requests, "
                                 f"lengths {[len(o) for o in outs]}")
        if outs[:2] != alone:
            raise AssertionError(f"family_serve {arch}: batched {outs[:2]} != alone {alone}")
        emit("family_serve", arch=arch, requests=stats["requests"],
             decode_steps=stats["steps"], seconds=stats["seconds"],
             tok_per_s=stats["tok_per_s"],
             cli_ms_per_step=stats["seconds"] / stats["steps"] * 1e3,
             decode_step_ms=step_ms, decode_step_iters=FAMILY_DECODE_ITERS,
             decode_step_profile={
                 "wall_ms": step_wall_ms, "device_busy_ms": step_busy_ms,
                 "device_idle_share": 1.0 - step_busy_ms / step_wall_ms,
                 "kernels": sum(c for _, c, _ in step_ops),
                 "top_device_ops": [{"name": k[:80], "count": c, "device_ms": ms}
                                    for k, c, ms in step_ops[:6]]},
             weight_read_bytes=weight_bytes,
             weight_read_floor_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
             shared_block_reread_bytes=reread,
             weight_read_floor_ms_with_rereads=(weight_bytes + reread) / HBM_BYTES_PER_S * 1e3,
             alone_equal_batched=True, max_memory_allocated_gb=peak_gb(), kind=name,
             nvidia_smi=smi)
    return launches, zamba_cell


#: whisper-large-v3's prefill on the card: 4 windows of 1,500 frames (30 s
#: of audio after the stubbed frontend) and make_inputs' 1500 // 8 = 187
#: decoder tokens; its flash shapes (b, sq, h, kh, d, skv, causal), timed
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_TOKENS = 4, 1500, 187
ENCDEC_FLASH_SHAPES = ((4, 1500, 20, 20, 64, 1500, False), (4, 187, 20, 20, 64, 1500, False),
                       (4, 187, 20, 20, 64, 187, True))
#: greedy decode steps of encdec_decode, each against prefill_logits
ENCDEC_DECODE_STEPS = 16


def flash_cell(dev, b, sq, h, kh, d, skv, causal, iters=20) -> dict:
    """The bf16 flash kernel alone at one shape beside the plain version and
    SDPA; its bound from 4 * d operations an allowed pair at the bf16 peak,
    or its bytes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(sq + skv + h)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
               .to(device=dev, dtype=torch.bfloat16)
               for shape in ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d)))
    before = fa.LAUNCHES_TENSOR_CORE
    ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, causal=causal), iters)
    if fa.LAUNCHES_TENSOR_CORE == before:
        raise AssertionError(f"flash_cell ({b}, {sq}, {h}, {kh}, {d}, {skv}): no bf16 launch")
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), 2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=h != kh), iters)
    flops = fa.attention_flops(b, sq, skv, h, d, causal=causal)
    bytes_ms = fa.attention_bytes(q, k, v) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    return {"shape": [b, sq, h, kh, d, skv], "causal": causal, "flops": flops, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": bound / ms, "tflops": flops / (ms * 1e-3) / 1e12, "iters": iters}


def logits_check(phase: str, got, want) -> dict:
    """lm_prefill's rule: |got - want| within PREFILL_BAR_STEPS bf16 steps
    at the largest |want|, the argmax equal on every row whose top two are
    more than twice the bar apart."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{phase}: logits {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"finite={bool(torch.isfinite(got).all())}")
    diff = float((got - want).abs().max())
    top = float(want.abs().max())
    bar = PREFILL_BAR_STEPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    top2 = torch.topk(want[:, 0], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
    agree = got[:, 0].argmax(-1) == want[:, 0].argmax(-1)
    if not diff <= bar or not bool(agree[decided].all()):
        raise AssertionError(f"{phase}: max |diff| {diff} (bar {bar}), argmax agreement "
                             f"{agree.tolist()} on rows {decided.tolist()}")
    return {"max_abs_diff": diff, "max_abs_logit": top, "bar": bar,
            "argmax_agree": agree.tolist(), "argmax_decided_rows": decided.tolist()}


def fill_cross_cache(params, cache, enc_out, cfg) -> None:
    """The encdec cross cache's rows: the encoder's output through each
    decoder layer's cross wk / wv. `decode_step` reads a cross cache its
    caller fills, in `repro` as in the port; this is that caller."""
    import torch

    b, t, _ = enc_out.shape
    with torch.no_grad():
        for i, lp in enumerate(params["dec_layers"]):
            for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
                cache[name][i].copy_((enc_out @ lp["cross"][w]).reshape(
                    b, t, cfg.n_kv_heads, cfg.head_dim))


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts and lists."""
    import torch

    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def encdec_phases(dev, name: str, smi: str) -> tuple:
    """encdec_prefill, encdec_profile, encdec_flash_timing and encdec_decode
    of whisper-large-v3 at full width; returns (the bf16 flash launches of
    its prefill, the timing cells)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import encdec
    from repro_torch.models.registry import get_model

    model = get_model("whisper-large-v3")
    cfg = model.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(ENCDEC_BATCH, ENCDEC_TOKENS)), device=dev)
    batch = {"frames": frames, "tokens": tokens}
    spec, _ = model.make_inputs("prefill", ENCDEC_BATCH, ENCDEC_FRAMES)
    if (tuple(spec["frames"].shape), tuple(spec["tokens"].shape)) != (
            tuple(frames.shape), tuple(tokens.shape)):
        raise AssertionError(f"encdec_prefill: make_inputs gives {spec}")
    flash = model.with_cfg(attn_impl="flash")
    want = cfg.n_enc_layers + 2 * cfg.n_dec_layers

    # ---- encdec_prefill: the counters set to 0 just before
    fa.LAUNCHES = fa.LAUNCHES_TENSOR_CORE = fa.LAUNCHES_TENSOR_CORE_F32 = 0
    ref.FLASH_CALLS = 0
    t0 = time.perf_counter()
    logits = flash.prefill(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
              ref.FLASH_CALLS)
    if counts != (want, want, 0, 0):
        raise AssertionError(f"encdec_prefill: (flash, bf16 kernel, float32 kernel, plain) "
                             f"launches {counts}, want ({want}, {want}, 0, 0)")
    dense = model.with_cfg(attn_impl="dense").prefill(params, batch)
    checks = logits_check("encdec_prefill flash vs dense", logits, dense)
    emit("encdec_prefill", arch=cfg.name, batch=ENCDEC_BATCH, frames=ENCDEC_FRAMES,
         decoder_tokens=ENCDEC_TOKENS, params=model.param_count(), init_s=init_s, wall_s=wall,
         flash_launches=counts[0], tensor_core_launches=counts[1],
         tensor_core_f32_launches=counts[2], plain_calls=counts[3],
         launches_by_attention={"encoder": cfg.n_enc_layers, "decoder_self": cfg.n_dec_layers,
                                "cross": cfg.n_dec_layers},
         max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9, kind=name,
         nvidia_smi=smi, **checks)
    del dense

    # ---- encdec_profile: one flash prefill, device time by kernel
    wall_ms, busy_ms, by_op = profile_device_ms(lambda: flash.prefill(params, batch))
    flash_ms = sum(ms for k, _, ms in by_op if "flash_fwd" in k)
    gemm_ms = sum(ms for k, _, ms in by_op
                  if any(t in k.lower() for t in ("gemm", "xmma", "nvjet", "cutlass")))
    emit("encdec_profile", arch=cfg.name, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms, flash_device_ms=flash_ms,
         matmul_device_ms=gemm_ms, other_device_ms=busy_ms - flash_ms - gemm_ms,
         kernels=sum(c for _, c, _ in by_op), kind=name, nvidia_smi=smi,
         top_device_ops=[{"name": k[:80], "count": c, "device_ms": ms}
                         for k, c, ms in by_op[:10]])

    # ---- encdec_flash_timing: the kernel alone at whisper's three shapes
    cells = [flash_cell(dev, *shape) for shape in ENCDEC_FLASH_SHAPES]
    emit("encdec_flash_timing", arch=cfg.name, kind=name, nvidia_smi=smi,
         peak_bf16_ops_per_s=BF16_OPS_PER_S, peak_bytes_per_s=HBM_BYTES_PER_S, cells=cells)

    # ---- encdec_decode: the cross cache filled from the encoder's output,
    # then greedy steps, step t against prefill_logits of the first t + 1 tokens
    with torch.no_grad():
        enc_out = encdec.encode(params, frames, flash.cfg)
    cache = model.init_cache(ENCDEC_BATCH, ENCDEC_FRAMES, dev)
    fill_cross_cache(params, cache, enc_out, cfg)
    seq = tokens[:, :1]
    steps = []
    for t in range(ENCDEC_DECODE_STEPS):
        got, cache = model.decode_step(params, cache, {"tokens": seq[:, t:t + 1], "pos": t})
        want_t = flash.prefill(params, {"frames": frames, "tokens": seq})
        steps.append(logits_check(f"encdec_decode step {t}", got, want_t))
        seq = torch.cat([seq, got[:, 0].argmax(-1, keepdim=True)], dim=1)
    step = {"tokens": seq[:, -1:].contiguous(), "pos": ENCDEC_DECODE_STEPS}
    step_ms = cuda_ms(lambda: model.decode_step(params, cache, step), FAMILY_DECODE_ITERS)
    step_wall_ms, step_busy_ms, step_ops = profile_device_ms(
        lambda: model.decode_step(params, cache, step))
    weights = tensor_bytes({k: params[k] for k in ("embed", "dec_layers", "dec_norm")})
    caches = tensor_bytes(cache)
    emit("encdec_decode", arch=cfg.name, batch=ENCDEC_BATCH, cache_len=ENCDEC_FRAMES,
         steps=ENCDEC_DECODE_STEPS, tokens=seq.tolist(),
         max_steps_off=max(s["max_abs_diff"] / s["bar"] * PREFILL_BAR_STEPS for s in steps),
         per_step=steps, decode_step_ms=step_ms, decode_step_iters=FAMILY_DECODE_ITERS,
         decode_step_profile={
             "wall_ms": step_wall_ms, "device_busy_ms": step_busy_ms,
             "device_idle_share": 1.0 - step_busy_ms / step_wall_ms,
             "kernels": sum(c for _, c, _ in step_ops),
             "top_device_ops": [{"name": k[:80], "count": c, "device_ms": ms}
                                for k, c, ms in step_ops[:6]]},
         weight_read_bytes=weights, weight_read_floor_ms=weights / HBM_BYTES_PER_S * 1e3,
         cache_read_bytes=caches,
         weight_and_cache_floor_ms=(weights + caches) / HBM_BYTES_PER_S * 1e3,
         kind=name, nvidia_smi=smi)
    del params, cache, enc_out, logits
    torch.cuda.empty_cache()
    return counts[1], cells


#: the full-width training runs of train_path (b, c): (arch, batch, seq, steps)
TRAIN_RUNS = (("gemma-2b", 4, 2048, 4), ("mamba2-130m", 4, 2048, 4))
#: the smoke train step on the card against the CPU (train_path a, e): loss,
#: grad norm (tests/test_torch_train_families.py's bars), each gradient leaf
#: within 8 bf16 steps of its largest |value| or, past that, 8 steps plus
#: half the CPU's own bf16-vs-float32 difference of that leaf; after one
#: AdamW step each parameter within 2 lr + one bf16 step (a step-1 update
#: is lr (g / |g| + wd p): a gradient near 0 may take the other sign)
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_LEAF_STEPS = 1e-3, 1e-2, 8
TRAIN_LR = 1e-3


def _to(tree, dev, dtype=None):
    """A tree of dicts and lists of tensors on `dev` (floats cast to `dtype`)."""
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev, dtype) for v in tree]
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=dev, dtype=dtype)
    return tree.to(dev)


def smoke_train_check(dev, arch: str) -> dict:
    """One build_train_step step of `arch`'s smoke model on the card against
    the same step on the CPU (parameters made on the CPU, seeded 0), and the
    gradients leaf by leaf (the bars above)."""
    import torch

    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import common as cm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    model = get_model(arch, smoke=True)
    moe = getattr(model.cfg, "moe", None) is not None
    params = model.init_params(device="cpu")
    batch = model.example_inputs("train", 2, 64, "cpu", seed=1)
    # an MoE model routes on the card as on the CPU, each flip explained
    # and pinned (RoutingPin), in the gradient, its float32 noise and the step
    (loss_c, grads_c), (loss_g, grads_g), pin = RoutingPin.around(
        moe_lib, lambda: tsteps.value_and_grad(model, params, batch),
        lambda: tsteps.value_and_grad(model, _to(params, dev), _to(batch, dev)), moe)
    flips = pin.flips if pin else 0
    worst, over = 0.0, []
    f32 = None
    for i, (c, g) in enumerate(zip(tree_leaves(grads_c), tree_leaves(grads_g))):
        c, g = c.float(), g.float().cpu()
        top = float(c.abs().max())
        step = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        diff = float((g - c).abs().max())
        if diff > TRAIN_LEAF_STEPS * step:
            if f32 is None:  # the CPU's float32 gradient: its bf16 rounding noise
                keep = cm.DEFAULT_DTYPE
                cm.DEFAULT_DTYPE = torch.float32
                try:
                    f32 = tree_leaves(RoutingPin.around(
                        moe_lib, lambda: tsteps.value_and_grad(model, params, batch),
                        lambda: tsteps.value_and_grad(model, _to(params, "cpu", torch.float32),
                                                      _to(batch, "cpu", torch.float32)),
                        moe)[1][1])
                finally:
                    cm.DEFAULT_DTYPE = keep
            noise = float((c - f32[i]).abs().max())
            if diff > TRAIN_LEAF_STEPS * step + noise / 2:
                raise AssertionError(f"train_path {arch}: gradient leaf {i} {diff / step:.1f} "
                                     f"bf16 steps from the CPU's (its bf16 noise "
                                     f"{noise / step:.1f} steps)")
            over.append({"leaf": i, "steps": diff / step, "cpu_bf16_noise_steps": noise / step})
        worst = max(worst, diff / step if step else 0.0)
    norm_c = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in tree_leaves(grads_c))))
    norm_g = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in tree_leaves(grads_g))))
    if abs(float(loss_g) - float(loss_c)) > TRAIN_LOSS_RTOL * abs(float(loss_c)) or \
            abs(norm_g - norm_c) > TRAIN_NORM_RTOL * norm_c:
        raise AssertionError(f"train_path {arch}: loss {float(loss_g)} vs {float(loss_c)}, "
                             f"grad norm {norm_g} vs {norm_c}")
    # one build_train_step step on each device
    shape = InputShape("smoke", "train", 64, 2)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    fn = tsteps.build_train_step(model, shape, opt_cfg=opt_cfg).fn
    pg = _to(model.init_params(device="cpu"), dev)
    (pc, _, mc), (pg, _, mg), pin = RoutingPin.around(
        moe_lib, lambda: fn(params, adamw_init(params), batch),
        lambda: fn(pg, adamw_init(pg), _to(batch, dev)), moe)
    flips += pin.flips if pin else 0
    for k in ("loss", "grad_norm"):
        rtol = TRAIN_LOSS_RTOL if k == "loss" else TRAIN_NORM_RTOL
        if abs(float(mg[k]) - float(mc[k])) > rtol * abs(float(mc[k])):
            raise AssertionError(f"train_path {arch}: step {k} {float(mg[k])} vs {float(mc[k])}")
    moved = 0.0
    for c, g in zip(tree_leaves(pc), tree_leaves(pg)):
        c, g = c.float(), g.float().cpu()
        bad = (g - c).abs() > 2 * TRAIN_LR + 2.0 ** -7 * c.abs()
        if bool(bad.any()):
            raise AssertionError(f"train_path {arch}: {int(bad.sum())} parameters off after "
                                 f"one step")
        moved = max(moved, float((g - c).abs().max()))
    return {"arch": arch, "loss_card": float(loss_g), "loss_cpu": float(loss_c),
            "grad_norm_card": norm_g, "grad_norm_cpu": norm_c, "worst_leaf_steps": worst,
            "leaves_past_8_steps": over, "routing_flips_pinned": flips,
            "step_loss_card": float(mg["loss"]),
            "step_loss_cpu": float(mc["loss"]), "max_param_diff_after_step": moved}


def train_phases(dev, name: str, smi: str) -> dict:
    """train_path (a)-(f): every smoke model's step on the card against the
    CPU, gemma-2b and mamba2-130m at full width through
    `launch.train.main`, resume, microbatch and the flash refusal; returns
    the full-width runs' records."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.kernels.ops import FlashBackwardError
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.registry import get_model, list_archs
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    # ---- (a) every arch's smoke model: the card against the CPU
    t0 = time.perf_counter()
    smoke = [smoke_train_check(dev, arch) for arch in list_archs()]
    emit("train_path_smoke", archs=smoke, seconds=time.perf_counter() - t0, kind=name,
         nvidia_smi=smi)

    # ---- (b), (c) full width through the training CLI
    runs = {}
    for arch, b, s, n in TRAIN_RUNS:
        model = get_model(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        stats = train.main(["--arch", arch, "--steps", str(n), "--batch", str(b), "--seq",
                            str(s), "--log-every", "1", "--device", "cuda"])
        peak = torch.cuda.max_memory_allocated(dev)
        losses = stats["losses"]
        if len(losses) != n or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"train_path {arch}: losses {losses}")
        n_params = model.param_count()
        tokens = b * s
        flops = 8 * n_params * tokens  # 6 N T, and the forward again under remat "full"
        step_ms = float(np.median(stats["step_ms"][1:]))
        bound_ms = flops / BF16_OPS_PER_S * 1e3
        param_bytes = 2 * n_params  # bf16 (the norms' float32 are a rounding error)
        runs[arch] = {
            "arch": arch, "batch": b, "seq": s, "steps": n, "remat": model.cfg.remat,
            "params": n_params, "losses": losses, "step_ms": stats["step_ms"],
            "median_step_ms_after_first": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "cli_tokens_per_s": stats["tokens_per_s"], "max_memory_allocated_gb": peak / 1e9,
            "estimate_gb": {"params": param_bytes / 1e9, "grads": param_bytes / 1e9,
                            "moments_f32": 8 * n_params / 1e9},
            "bound_flops": flops, "bound_ms": bound_ms, "share_of_bound": bound_ms / step_ms}
        emit("train_path_full", kind=name, nvidia_smi=smi, **runs[arch])
        # ---- train_profile: one more step of the same model under torch.profiler
        params = model.init_params(device=dev)
        opt = adamw_init(params)
        step_fn = tsteps.build_train_step(model, InputShape("cli", "train", s, b)).fn
        raw = SyntheticTokenDataset(model.vocab, s, seed=0).batch(0, b)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        step_fn(params, opt, batch)  # warm
        wall_ms, busy_ms, by_op = profile_device_ms(lambda: step_fn(params, opt, batch))
        gemm_ms = sum(ms for k, _, ms in by_op
                      if any(t in k.lower() for t in ("gemm", "xmma", "nvjet", "cutlass")))
        emit("train_profile", arch=arch, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=1.0 - busy_ms / wall_ms, matmul_device_ms=gemm_ms,
             other_device_ms=busy_ms - gemm_ms, kernels=sum(c for _, c, _ in by_op),
             kind=name, nvidia_smi=smi,
             top_device_ops=[{"name": k[:80], "count": c, "device_ms": ms}
                             for k, c, ms in by_op[:12]])
        del params, opt, batch, step_fn
        torch.cuda.empty_cache()

    # ---- (d) resume: 4 steps against 2, a checkpoint, a restore and 2 more
    model = get_model("gemma-2b", smoke=True)
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    ds = SyntheticTokenDataset(vocab=model.vocab, seq_len=16, seed=1)
    fn = tsteps.build_train_step(model, InputShape("t", "train", 16, 4), opt_cfg=opt_cfg).fn

    def run(params, opt, start, stop):
        for s_ in range(start, stop):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(s_, 4).items()}
            params, opt, _ = fn(params, opt, batch)
        return params, opt

    def resume_diff():
        p0 = model.init_params(device=dev)
        pa, _ = run(p0, adamw_init(p0), 0, 4)
        p1 = model.init_params(device=dev)
        pb, ob = run(p1, adamw_init(p1), 0, 2)
        directory = os.path.join(ROOT, "build", "train_resume")
        ck = Checkpointer(directory)
        ck.save_async(2, train.state_arrays(pb, ob))
        like = model.init_params(device=dev)
        arrays, _, step = ck.restore(train.state_arrays(like, adamw_init(like)))
        pc, oc = run(*train.state_from_arrays(arrays, like, adamw_init(like)), 2, 4)
        import shutil

        shutil.rmtree(directory, ignore_errors=True)
        worst = 0.0
        for a, c in zip(tree_leaves(pa), tree_leaves(pc)):
            a, c = a.float(), c.float()
            excess = (a - c).abs() - (1e-6 + 1e-5 * c.abs())
            worst = max(worst, float(excess.max()))
        return step, worst <= 0, max(float((a.float() - c.float()).abs().max())
                                     for a, c in zip(tree_leaves(pa), tree_leaves(pc)))

    step, ok, diff = resume_diff()
    deterministic = False
    if not ok:  # the card's atomics: run again with deterministic algorithms
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        try:
            step, ok, diff2 = resume_diff()
        finally:
            torch.use_deterministic_algorithms(False)
        deterministic = {"first_max_abs_diff": diff}
        diff = diff2
        if not ok:
            raise AssertionError(f"train_path resume: 4 steps vs 2 + restore + 2 differ by {diff}")

    # ---- (e) microbatch 2 against 1 on the card
    big = get_model("gemma-2b", smoke=True)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in
           SyntheticTokenDataset(big.vocab, 64, seed=2).batch(0, 4).items()}
    mb = {}
    for m in (1, 2):
        p = big.init_params(device=dev)
        step_fn = tsteps.build_train_step(big, InputShape("t", "train", 64, 4), microbatch=m,
                                          opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=1)).fn
        p, _, met = step_fn(p, adamw_init(p), raw)
        mb[m] = (p, met)
    for k in ("loss", "grad_norm"):
        a, c = float(mb[2][1][k]), float(mb[1][1][k])
        if abs(a - c) > (TRAIN_LOSS_RTOL if k == "loss" else TRAIN_NORM_RTOL) * abs(c):
            raise AssertionError(f"train_path microbatch: {k} {a} vs {c}")
    for a, c in zip(tree_leaves(mb[2][0]), tree_leaves(mb[1][0])):
        if bool(((a.float() - c.float()).abs() > 2 * TRAIN_LR + 2.0 ** -7 * c.float().abs()).any()):
            raise AssertionError("train_path microbatch: parameters off after one step")

    # ---- (f) a loss through the flash route raises on the card
    flash = dataclasses.replace(big, cfg=dataclasses.replace(big.cfg, attn_impl="flash"))
    try:
        tsteps.value_and_grad(flash, big.init_params(device=dev),
                              big.example_inputs("train", 2, 64, dev))
        raise AssertionError("train_path: a loss through the flash route did not raise")
    except FlashBackwardError as e:
        refusal = str(e)
    emit("train_path_checks", resume_step=step, resume_max_abs_diff=diff,
         resume_deterministic=deterministic,
         microbatch={str(m): {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
                     for m, (_, met) in mb.items()},
         flash_refusal=refusal, kind=name, nvidia_smi=smi)
    return runs


#: mesh_path (b): the smoke train steps' shape (name, mode, seq, batch) and
#: the full-width prefill's (batch 4, prompt 2048)
MESH_TRAIN = ("t", "train", 64, 4)
MESH_PREFILL = ("p", "prefill", 2048, 4)
#: mesh_path (a): gemma-2b's meshed train step at full width, 4 x 2048, 2
#: steps, beside the single-device step of train_path
MESH_FULL = ("gemma-2b", 4, 2048, 2)


def grouped_moe_reference(groups):
    """`models.moe.moe_ffn` on one device as G = `groups` dispatch groups
    compute it (`repro`'s grouped form on a mesh of G data ranks): each
    group's consecutive tokens routed and dispatched with capacity(n / G),
    the aux loss over every token. The plain reference of a meshed MoE step
    on G data ranks."""
    import torch

    from repro_torch.models import moe as moe_lib

    def ffn(x, p, cfg, act="silu"):
        b, s, d = x.shape
        n = b * s
        m = n // groups
        xf = x.reshape(n, d)
        ys = [moe_lib._moe(xf[i * m:(i + 1) * m].reshape(1, m, d), p, cfg, act, True)[0]
              for i in range(groups)]
        probs = torch.softmax(xf.to(torch.float32) @ p["router"].to(torch.float32), dim=-1)
        _, top_ids = moe_lib.select_experts(probs, cfg.top_k)
        counts = moe_lib.expert_counts(top_ids.reshape(-1), cfg.n_experts).to(torch.float32)
        aux = cfg.router_aux_weight * cfg.n_experts * torch.sum(
            (counts / top_ids.numel()) * probs.mean(dim=0))
        return torch.cat(ys, dim=1).reshape(b, s, d), aux
    return ffn


def gloo_cuda_all_gather() -> None:
    """mesh_path (b)'s two gloo ranks on one card: gloo's all-gather crashes
    its process on CUDA tensors (torch 2.11; its all-reduce, reduce-scatter
    and all-to-all take them), so this process's functional all-gathers
    (`all_gather_tensor`, `all_gather_single`, which DTensor's
    redistributions call) run, for a gloo group and a CUDA tensor, as an
    all-reduce of a buffer zero but for this rank's block: the same values,
    on the card, n times an all-gather's wire. Every other call goes to
    torch's own. A layout of this smoke test only: a deployment's ranks
    each have a card and NCCL."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group

    def by_all_reduce(fn):
        def all_gather(t, gather_dim, group, tag=""):
            pg = _resolve_process_group(funcol._resolve_group_name(group, tag))
            if not t.is_cuda or dist.get_backend(pg) != "gloo":
                return fn(t, gather_dim, group, tag)
            buf = t.new_zeros((pg.size(),) + tuple(t.shape))
            buf[dist.get_rank(pg)] = t  # x + 0 is x (a -0.0 comes back +0.0)
            out = funcol.wait_tensor(funcol.all_reduce(buf, "sum", group, tag))
            return torch.cat(list(out.unbind(0)), dim=gather_dim)
        return all_gather

    for name in ("all_gather_tensor", "all_gather_single"):
        fn = getattr(funcol, name, None)
        if fn is not None:
            setattr(funcol, name, by_all_reduce(fn))


def mesh_rank(rank, world, cases):
    """A gloo rank on cuda:0 beside another: each case of `cases` on its
    mesh, in order. A train case ({"case": "train", "arch", "shape",
    "ref"}) runs the meshed smoke train step, its MoE routing pinned to the
    reference's (`RoutingPin`, call n of this rank's group g taken from the
    reference's call n G + g); a prefill case runs gemma-2b's full-width
    prefill through the flash kernel on this rank's heads, its launches
    counted from 0."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.mesh import make_compat_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import build_step, full_tree, shard_tree
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    dev = torch.device("cuda:0")
    gloo_cuda_all_gather()
    out = []
    for case in cases:
        mesh = make_compat_mesh(case["shape"], ("data", "model"), "cuda")
        if case["case"] == "prefill":
            model = get_model("gemma-2b").with_cfg(attn_impl="flash")
            params = model.init_params(device=dev)
            built = build_step(model, InputShape(*MESH_PREFILL), mesh)
            tokens = torch.as_tensor(np.random.default_rng(0).integers(
                0, model.vocab, size=(MESH_PREFILL[3], MESH_PREFILL[2])), device=dev)
            p = shard_tree(params, built.in_shardings[0])
            batch = shard_tree({"tokens": tokens}, built.in_shardings[1])
            del params
            torch.cuda.synchronize()
            fa.LAUNCHES = fa.LAUNCHES_TENSOR_CORE = fa.LAUNCHES_TENSOR_CORE_F32 = 0
            kref.FLASH_CALLS = 0
            t0 = time.perf_counter()
            logits = built.fn(p, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = (fa.LAUNCHES, fa.LAUNCHES_TENSOR_CORE, fa.LAUNCHES_TENSOR_CORE_F32,
                      kref.FLASH_CALLS)
            full = logits.full_tensor().cpu()
            out.append({"case": "prefill", "shape": case["shape"], "launches": counts,
                        "wall_s": wall, "logits": full if rank == 0 else None,
                        "local_q_heads": model.cfg.n_heads // case["shape"][1]})
            del p, batch, logits
            torch.cuda.empty_cache()
            continue
        model = get_model(case["arch"], smoke=True)
        params = _to(model.init_params(device="cpu"), dev)
        batch = _to(model.example_inputs("train", MESH_TRAIN[3], MESH_TRAIN[2], "cpu", seed=1),
                    dev)
        built = build_step(model, InputShape(*MESH_TRAIN), mesh,
                           opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10))
        p_sh, o_sh, b_sh = built.in_shardings
        dp = shard_tree(params, p_sh)
        do = shard_tree(adamw_init(params), o_sh)
        db = shard_tree(batch, b_sh)
        flips = 0
        if case.get("ref") is not None:
            pin = RoutingPin(moe_lib)
            pin.ref = case["ref"]
            groups, g = case["shape"][0], mesh.get_coordinate()[0]
            with pin.pin(lambda n: n * groups + g):
                dp, do, met = built.fn(dp, do, db)
            flips = pin.flips
        else:
            dp, do, met = built.fn(dp, do, db)
        leaves = [t.float().cpu() for t in tree_leaves(full_tree(dp))]
        mu = [t.float().cpu() for t in tree_leaves(full_tree(do["mu"]))]
        nu = [t.float().cpu() for t in tree_leaves(full_tree(do["nu"]))]
        out.append({"case": "train", "arch": case["arch"], "shape": case["shape"],
                    "loss": float(met["loss"].full_tensor()),
                    "grad_norm": float(met["grad_norm"].full_tensor()), "flips": flips,
                    "params": leaves if rank == 0 else None, "mu": mu if rank == 0 else None,
                    "nu": nu if rank == 0 else None,
                    "mu_local": [tuple(t.to_local().shape) for t in tree_leaves(do["mu"])]})
    return out


def mesh_train_reference(dev, arch: str, groups: int, f32: bool = False):
    """The card's single-device smoke train step of `arch` on mesh_path
    (b)'s inputs: an MoE as `groups` dispatch groups (`grouped_moe_reference`),
    its routing recorded (`RoutingPin`). With `f32`, the parameters widened
    and `common.DEFAULT_DTYPE` float32 (the bf16 reference's noise)."""
    import torch

    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import common as cm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    model = get_model(arch, smoke=True)
    moe = getattr(model.cfg, "moe", None) is not None
    dtype = torch.float32 if f32 else None
    params = _to(model.init_params(device="cpu"), dev, dtype)
    batch = _to(model.example_inputs("train", MESH_TRAIN[3], MESH_TRAIN[2], "cpu", seed=1),
                dev, dtype)
    fn = tsteps.build_train_step(model, InputShape(*MESH_TRAIN), opt_cfg=AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=10), donate=False).fn
    keep_ffn, keep_dtype = moe_lib.moe_ffn, cm.DEFAULT_DTYPE
    if moe and groups > 1:
        moe_lib.moe_ffn = grouped_moe_reference(groups)
    if f32:
        cm.DEFAULT_DTYPE = torch.float32
    pin = RoutingPin(moe_lib)
    try:
        with pin.record():
            p2, opt, met = fn(params, adamw_init(params), batch)
    finally:
        moe_lib.moe_ffn, cm.DEFAULT_DTYPE = keep_ffn, keep_dtype
    return {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "params0": [t.float().cpu() for t in tree_leaves(params)],
            "params": [t.float().cpu() for t in tree_leaves(p2)],
            "mu": [t.float().cpu() for t in tree_leaves(opt["mu"])],
            "nu": [t.float().cpu() for t in tree_leaves(opt["nu"])],
            "ref": [(x.cpu(), i.cpu()) for x, i in pin.ref] if moe else None}


def _bf16_step(t):
    """The bf16 step (unit in the last place) at each |value| of `t`, 0 at 0."""
    import torch

    _, e = torch.frexp(t.double())
    return torch.where(t != 0, torch.ldexp(torch.ones_like(t, dtype=torch.float64), e - 8),
                       torch.zeros_like(t, dtype=torch.float64))


def check_mesh_train(dev, got: dict, want: dict, groups: int) -> dict:
    """mesh_path (b)'s bars, tests/test_torch_steps_mesh.py's: loss rtol
    1e-3, grad norm rtol 1e-2, each first moment within 8 bf16 steps (or 8
    plus half the reference's own bf16-vs-float32 noise there), each second
    moment, read as the |gradient| it holds, at the first's bar, and each
    parameter's change against the reference's: where the reference's
    first moment exceeds the two moments' difference and both gradients
    exceed 1000 eps, equal but for lr eps / min |g| and one bf16 rounding
    (where neither has a gradient, but for the rounding); at least 90% of
    the parameters held so and at most 1% of those not equal."""
    import torch

    from repro_torch.optim import AdamWConfig

    cfg = AdamWConfig()
    what = f"mesh_path {got['arch']} on {got['shape']}"
    if abs(got["loss"] - want["loss"]) > TRAIN_LOSS_RTOL * abs(want["loss"]) or \
            abs(got["grad_norm"] - want["grad_norm"]) > TRAIN_NORM_RTOL * want["grad_norm"]:
        raise AssertionError(f"{what}: loss {got['loss']} vs {want['loss']}, grad norm "
                             f"{got['grad_norm']} vs {want['grad_norm']}")
    f32, worst, over = None, 0.0, []
    decided = rounded = total = 0
    for i, (g, w) in enumerate(zip(got["mu"], want["mu"])):
        top = float(w.abs().max())
        step = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        diff = float((g - w).abs().max())
        worst = max(worst, diff / step if step else 0.0)
        bar = TRAIN_LEAF_STEPS * step
        if diff > bar:
            if f32 is None:
                f32 = mesh_train_reference(dev, got["arch"], groups, f32=True)["mu"]
            noise = float((w - f32[i]).abs().max())
            if diff > bar + noise / 2:
                raise AssertionError(f"{what}: first moment leaf {i} {diff / step:.1f} bf16 "
                                     f"steps from the single-device step's (its bf16 noise "
                                     f"{noise / step:.1f} steps)")
            over.append({"leaf": i, "steps": diff / step,
                         "reference_bf16_noise_steps": noise / step})
            bar += noise / 2
        held = [torch.sqrt(t["nu"][i].double() / (1 - cfg.b2)) * (1 - cfg.b1)
                for t in (got, want)]
        nu_diff = float((held[0] - held[1]).abs().max())
        if nu_diff > bar:
            raise AssertionError(f"{what}: second moment leaf {i}: its |gradient| "
                                 f"{nu_diff / step:.1f} bf16 steps from the reference's")
        gs = torch.minimum(g.abs(), w.abs()).double() / (1 - cfg.b1)
        sure = ((w.abs() > (g - w).abs()) & (gs > 1e3 * cfg.eps))
        slack = TRAIN_LR * cfg.eps / torch.where(sure, gs, torch.full_like(gs, float("inf")))
        sure |= (g == 0) & (w == 0)
        p0 = want["params0"][i]
        moved = got["params"][i] - p0, want["params"][i] - p0
        off = sure & (moved[0] != moved[1])
        apart = (moved[0] - moved[1]).abs().double()
        one = _bf16_step(torch.maximum(got["params"][i].abs(), want["params"][i].abs()))
        if bool((off & (apart > one + slack)).any()):
            raise AssertionError(f"{what}: parameter leaf {i}: updates more than a bf16 step "
                                 f"from the single-device step's where its gradient decides "
                                 f"their sign")
        decided += int(sure.sum())
        rounded += int(off.sum())
        total += sure.numel()
    if decided < 0.9 * total or rounded > 0.01 * decided:
        raise AssertionError(f"{what}: updates held at {decided} of {total} parameters, "
                             f"{rounded} of them not equal")
    return {"arch": got["arch"], "mesh": list(got["shape"]), "groups": groups,
            "loss": got["loss"], "reference_loss": want["loss"], "grad_norm": got["grad_norm"],
            "reference_grad_norm": want["grad_norm"], "routing_flips": got["flips"],
            "worst_moment_steps": worst, "moment_leaves_over_8_steps": over,
            "updates_held": decided, "parameters": total, "updates_held_not_equal": rounded}


def mesh_phases(dev, name: str, smi: str) -> dict:
    """mesh_path: the meshed steps (`launch.steps` on a `DeviceMesh`).
    (a) a world of 1 over NCCL on a (1, 1) mesh: gemma-2b's meshed train
    step at full width, 4 x 2048, 2 steps, against the single-device step
    from the same parameters and batches, losses and parameters bit for bit,
    each step's ms (CUDA events) beside the single device's in this run;
    (b) 2 gloo ranks sharing cuda:0 on a (1, 2) model mesh and a (2, 1)
    data mesh: gemma2-27b's and qwen3-moe-30b-a3b's smoke train steps
    against the card's single-device step (qwen3 on (2, 1) against the
    single device as G = 2 dispatch groups, `grouped_moe_reference`; its
    routing pinned to the reference's, each flip explained), and on (1, 2)
    gemma-2b's full-width 4 x 2048 prefill through the bf16 flash kernel on
    each rank's 4 local query heads, its launches counted for each rank and
    its logits within lm_prefill's bar of the single-device dense route.
    Gloo on CUDA tensors: its all-gather runs as an all-reduce in the rank
    processes (`gloo_cuda_all_gather`, on the card); any other collective it
    lacks fails the phase, with its error. Returns {path: flash launches}
    for the kernels line."""
    import torch

    from repro_torch.core import distributed
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_compat_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    t_start = time.perf_counter()
    # ---- (a) a world of 1 over NCCL, (1, 1), gemma-2b at full width
    arch, b, s, n_steps = MESH_FULL
    model = get_model(arch)
    shape = InputShape("mesh", "train", s, b)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=n_steps, warmup_steps=1)
    ds = SyntheticTokenDataset(vocab=model.vocab, seq_len=s, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in ds.batch(i, b).items()}
               for i in range(n_steps)]
    runs = {}
    with distributed.world("cuda"):
        mesh = make_compat_mesh((1, 1), ("data", "model"), "cuda")
        # the single device twice: its own run-to-run bits are the yardstick
        for which in ("single", "mesh", "single_again"):
            torch.cuda.empty_cache()
            built = tsteps.build_train_step(model, shape, mesh if which == "mesh" else None,
                                            opt_cfg=opt_cfg)
            params = model.init_params(device=dev)
            opt = adamw_init(params)
            if which == "mesh":
                params = tsteps.shard_tree(params, built.in_shardings[0])
                opt = tsteps.shard_tree(opt, built.in_shardings[1])
            losses, ms = [], []
            for batch in batches:
                if which == "mesh":
                    batch = tsteps.shard_tree(batch, built.in_shardings[2])
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                params, opt, met = built.fn(params, opt, batch)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
                loss = met["loss"]
                losses.append(float(loss.full_tensor() if which == "mesh" else loss))
            leaves = [t.to_local() if which == "mesh" else t for t in tree_leaves(params)]
            runs[which] = {"losses": losses, "step_ms": ms, "leaves": leaves}
            del opt, built
        single, meshed, again = runs["single"], runs["mesh"], runs["single_again"]
        bitwise_losses = single["losses"] == meshed["losses"]
        same_leaves = sum(bool(torch.equal(a, c)) for a, c in zip(single["leaves"],
                                                                  meshed["leaves"]))
        rerun_leaves = sum(bool(torch.equal(a, c)) for a, c in zip(single["leaves"],
                                                                   again["leaves"]))
        worst = max(float((a.float() - c.float()).abs().max())
                    for a, c in zip(single["leaves"], meshed["leaves"]))
        if not bitwise_losses or same_leaves != len(single["leaves"]):
            # not bit for bit: then within the bars, the cause recorded
            for x, y in zip(meshed["losses"], single["losses"]):
                if abs(x - y) > TRAIN_LOSS_RTOL * abs(y):
                    raise AssertionError(f"mesh_path (a): losses {meshed['losses']} vs "
                                         f"{single['losses']}")
            for a, c in zip(meshed["leaves"], single["leaves"]):
                a, c = a.float(), c.float()
                if bool(((a - c).abs() > 2 * 3e-4 * n_steps * (1 + 2.0 ** -7)
                         + 2.0 ** -7 * c.abs()).any()):
                    raise AssertionError("mesh_path (a): parameters off the single-device "
                                         f"step's after {n_steps} steps (worst {worst})")
        emit("mesh_world_of_one", arch=arch, batch=b, seq=s, steps=n_steps,
             backend="nccl", mesh=[1, 1], losses=meshed["losses"],
             single_device_losses=single["losses"], bitwise_losses=bitwise_losses,
             bitwise_leaves=same_leaves, leaves=len(single["leaves"]),
             max_abs_leaf_diff=worst, step_ms=meshed["step_ms"],
             single_device_step_ms=single["step_ms"],
             single_device_again_step_ms=again["step_ms"],
             single_device_again_losses=again["losses"],
             single_device_again_bitwise_leaves=rerun_leaves,
             single_device_again_max_abs_leaf_diff=max(
                 float((a.float() - c.float()).abs().max())
                 for a, c in zip(single["leaves"], again["leaves"])),
             mesh_over_single_step2=meshed["step_ms"][-1] / single["step_ms"][-1],
             kind=name, nvidia_smi=smi)
        del runs, single, meshed, again
        torch.cuda.empty_cache()

    # ---- (b) 2 gloo ranks sharing cuda:0
    t0 = time.perf_counter()
    refs, checks = {}, []
    for arch in ("gemma2-27b", "qwen3-moe-30b-a3b"):
        for groups in (1, 2):
            refs[(arch, groups)] = mesh_train_reference(dev, arch, groups)
    by_path = {}
    for mesh_shape in ((1, 2), (2, 1)):
        groups = mesh_shape[0]
        cases = [{"case": "train", "arch": a, "shape": mesh_shape,
                  "ref": refs[(a, groups)]["ref"]} for a in ("gemma2-27b", "qwen3-moe-30b-a3b")]
        if mesh_shape == (1, 2):
            cases.append({"case": "prefill", "shape": mesh_shape})
        try:
            ranks = distributed.spawn_ranks(mesh_rank, 2, cases, device="cuda:0",
                                            backend="gloo", timeout=600)
        except Exception as e:
            raise AssertionError(f"mesh_path (b) on {mesh_shape} over gloo on cuda:0 failed "
                                 f"(a collective gloo lacks on CUDA tensors fails here): "
                                 f"{type(e).__name__}: {str(e)[-1500:]}") from e
        for i, case in enumerate(cases):
            got = [r[i] for r in ranks]
            if case["case"] == "train":
                checks.append(check_mesh_train(dev, got[0], refs[(case["arch"], groups)],
                                               groups))
                checks[-1]["rank_flips"] = [g["flips"] for g in got]
                continue
            # the prefill: every rank launched the bf16 kernel once a layer
            n_layers = get_model("gemma-2b").cfg.n_layers
            for r, g in enumerate(got):
                launches, tc, f32, plain = g["launches"]
                if (launches, tc, f32, plain) != (n_layers, n_layers, 0, 0):
                    raise AssertionError(f"mesh_path prefill rank {r}: {launches} flash "
                                         f"launches, {tc} bf16, {f32} float32, {plain} plain")
                by_path[f"mesh_prefill gemma-2b rank {r}"] = launches
            model = get_model("gemma-2b").with_cfg(attn_impl="dense")
            params = model.init_params(device=dev)
            tokens = torch.as_tensor(np.random.default_rng(0).integers(
                0, model.vocab, size=(MESH_PREFILL[3], MESH_PREFILL[2])), device=dev)
            dense = model.prefill(params, {"tokens": tokens}).float().cpu()
            del params
            torch.cuda.empty_cache()
            logits = got[0]["logits"].float()
            diff, top = float((logits - dense).abs().max()), float(dense.abs().max())
            bar = PREFILL_BAR_STEPS * 2.0 ** (np.floor(np.log2(top)) - 7)
            top2 = torch.topk(dense[:, 0], 2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > 2 * bar
            agree = logits[:, 0].argmax(-1) == dense[:, 0].argmax(-1)
            if not diff <= bar or not bool(agree[decided].all()):
                raise AssertionError(f"mesh_path prefill: 2 ranks' flash logits vs the single "
                                     f"device's dense max |diff| {diff} (bar {bar})")
            emit("mesh_prefill", arch="gemma-2b", batch=MESH_PREFILL[3],
                 prompt_len=MESH_PREFILL[2], mesh=list(mesh_shape), backend="gloo",
                 flash_launches_by_rank=[g["launches"][0] for g in got],
                 local_q_heads=got[0]["local_q_heads"], wall_s=[g["wall_s"] for g in got],
                 max_abs_diff_vs_dense=diff, bar=bar, argmax_agree=agree.tolist(),
                 kind=name, nvidia_smi=smi)
    emit("mesh_gloo_train", checks=checks, all_gather="all-reduce (gloo_cuda_all_gather)",
         seconds=time.perf_counter() - t0, kind=name, nvidia_smi=smi)
    emit("mesh_path", seconds=time.perf_counter() - t_start, kind=name, nvidia_smi=smi)
    return by_path


#: tuning_path's autotuned cells: (tag, model, regions, dataset, batch, chunk)
TUNING_CELLS = (("siard 100000x49", "siard", 1, "italy", 100_000, 10_000),
                ("metapop_seir R=100 20000x49", "metapop_seir", 100, "synthetic_small",
                 20_000, 2_000))
#: the cost-model cases of tuning_path (a): (tag, model, regions, schedule)
COST_CASES = (("siard", "siard", 1, ""), ("sir", "sir", 1, ""), ("seir", "seir", 1, ""),
              ("seiard", "seiard", 1, ""), (f"siard {INTERVENTION}", "siard", 1, INTERVENTION),
              ("metapop_seir R=4", "metapop_seir", 4, ""),
              ("metapop_seir R=100", "metapop_seir", 100, ""))


def tuning_phase(dev, name: str, smi: str, italy_argv, main_post, main_tolerance) -> tuple:
    """Phase tuning_path (`core.tuning` and `repro_torch.analysis` on the
    card), its abc_sim launches counted from 0: (a) the cost model of each
    of `COST_CASES` beside the kernel's hand count; (b) `autotune` of each
    of `TUNING_CELLS` into a cache under build/tuning_path: every
    candidate's wall, the winner and best_batch, every candidate block's
    wave and theta-in distances bitwise the default block's, a second call a
    hit with 0 launches; (c) `abc_run ... --autotune` at main_path's flags
    into a fresh cache, its posterior bitwise main_path's, then warm in
    turns with the untuned run (a warm tuned run launches as main_path
    does: the hit measures nothing); (d) the roofline fields of the wave
    entry at 100,000 x 49 and of main_path's warm run, each efficiency in
    (0, 1.05]; (e) one device-loop segment, enqueue and read, under
    torch.cuda.set_sync_debug_mode("warn"): one synchronizing call, the
    count read (the harvest's row copies counted apart); (f) `python -m
    repro_torch.analysis` on the tree: no finding. Returns (launches,
    gated) by entry."""
    import dataclasses
    import pathlib
    import shutil
    import warnings

    import torch

    from repro_torch.core import abc as tabc
    from repro_torch.core import tuning
    from repro_torch.core.priors import schedule_prior
    from repro_torch.core.summaries import get_summary, lower_summary
    from repro_torch.epi import data
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import regionalize
    from repro_torch.kernels import abc_sim
    from repro_torch.launch import abc_run

    root = os.path.join(ROOT, "build", "tuning_path")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    abc_sim.ENTRY_LAUNCHES.clear()
    abc_sim.ENTRY_GATED.clear()

    def spec_of(model, regions):
        spec = get_model(model)
        return spec if regions == spec.n_regions else regionalize(spec, regions, "ring:0.1")

    # (a) the cost model, spec-derived, beside the kernel's hand count
    costs = {}
    for tag, model, regions, iv in COST_CASES:
        spec = spec_of(model, regions)
        sched = abc_run.parse_intervention(iv)
        cm = tuning.cost_model(spec, 49, schedule=sched)
        obs = torch.as_tensor(data.get_dataset(
            "italy" if model in ("siard", "seiard") else "synthetic_small", num_days=49,
            model=spec).observed, device=dev)
        hand = abc_sim.ops_per_sample_day(spec, lower_summary(get_summary(None), "euclidean",
                                                              obs, n_regions=spec.n_regions))
        costs[tag] = {**dataclasses.asdict(cm), "hand_count_ops_per_sample_day": hand,
                      "traced_over_hand": cm.flops_per_sample_day / hand,
                      "arithmetic_intensity_fused": cm.arithmetic_intensity_fused}

    # (b) autotune each cell into a temporary cache; the blocks bitwise
    cache = tuning.TuningCache(os.path.join(root, "cache.json"))
    tuned, wave_ms = {}, None
    for tag, model, regions, ds_name, batch, chunk in TUNING_CELLS:
        spec = spec_of(model, regions)
        ds = data.get_dataset(ds_name, num_days=49, model=spec)
        cfg = tabc.ABCConfig(batch_size=batch, chunk_size=chunk, num_days=49,
                             tolerance=main_tolerance, model=spec, autotune=True)
        t0 = time.perf_counter()
        entry = tuning.autotune(ds, cfg, cache=cache, device=dev)
        search_s = time.perf_counter() - t0
        before = sum(abc_sim.ENTRY_LAUNCHES.values())
        if tuning.autotune(ds, cfg, cache=cache, device=dev) != entry:
            raise AssertionError(f"tuning_path {tag}: the second autotune is not the hit")
        hit_launches = sum(abc_sim.ENTRY_LAUNCHES.values()) - before
        if hit_launches:
            raise AssertionError(f"tuning_path {tag}: a cache hit launched {hit_launches}")
        prior = schedule_prior(spec)
        base = dataclasses.replace(cfg, autotune=False)
        sim0 = tabc.make_simulator(ds, base, dev)
        th0, d0 = sim0.wave(prior, 7, 8, batch)
        din0 = sim0(th0, 9)
        checks = []
        for block in tuning.block_candidates(spec, batch):
            sim = tabc.make_simulator(ds, dataclasses.replace(base, block=block), dev)
            th, d = sim.wave(prior, 7, 8, batch)
            checks.append(bitwise(f"tuning_path {tag} block {block} wave theta", th, th0))
            checks.append(bitwise(f"tuning_path {tag} block {block} wave distances", d, d0))
            checks.append(bitwise(f"tuning_path {tag} block {block} theta-in distances",
                                  sim(th0, 9), din0))
        if model == "siard":
            wave_ms = cuda_ms(lambda: sim0.wave(prior, 12, 99, batch), 50)
        tuned[tag] = {"key": tuning.cfg_cache_key(cfg), "entry": entry, "search_s": search_s,
                      "route": abc_sim.regional_route(spec, batch) if spec.is_regional
                      else "flat", "default_block": abc_sim.route_block(
                          abc_sim.regional_route(spec, batch) if spec.is_regional
                          else "thread"),
                      "hit_launches": hit_launches, "bitwise_blocks": checks}

    # (c) the main path autotuned, cold into a fresh cache, then warm in turns
    default_cache = tuning.DEFAULT_CACHE_PATH
    tuning.DEFAULT_CACHE_PATH = pathlib.Path(root) / "main.json"
    argv_t = italy_argv + ["--autotune"]
    t0 = time.perf_counter()
    post_t = abc_run.main(argv_t)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    same = {"theta": bitwise("tuning_path autotuned main_path theta", post_t.theta,
                             main_post.theta),
            "distances": bitwise("tuning_path autotuned main_path distances",
                                 post_t.distances, main_post.distances)}
    if (post_t.runs, post_t.simulations) != (main_post.runs, main_post.simulations):
        raise AssertionError(f"tuning_path: the autotuned run's runs/simulations "
                             f"{post_t.runs}/{post_t.simulations} differ from main_path's")
    main_cfg = tabc.ABCConfig(batch_size=100_000, chunk_size=10_000, num_days=49,
                              tolerance=main_tolerance, target_accepted=100)
    main_entry = tuning.TuningCache(tuning.DEFAULT_CACHE_PATH).get(
        tuning.cfg_cache_key(main_cfg))
    if main_entry is None:
        raise AssertionError("tuning_path: abc_run --autotune left no entry in its cache")
    walls = {"untuned": [], "autotuned": []}
    # calibrate_tolerance's pilot: 65,536 samples in waves of at most a batch
    pilot = min(65_536, main_cfg.batch_size)
    pilot_waves = 65_536 // pilot
    for which in ("untuned", "autotuned", "autotuned", "untuned"):
        waves0 = abc_sim.run_launches("wave")
        t0 = time.perf_counter()
        p = abc_run.main(italy_argv if which == "untuned" else argv_t)
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
        made = abc_sim.run_launches("wave") - waves0
        if made != pilot_waves + p.runs:
            raise AssertionError(f"tuning_path: a warm {which} run made {made} wave launches "
                                 f"that ran, want {pilot_waves} + {p.runs}")

    tuning.DEFAULT_CACHE_PATH = default_cache

    # (d) roofline fields of the wave entry and of the warm main path
    cm = tuning.cost_model("siard", 49)
    roofline = {
        "wave_entry_100000x49": {"ms": wave_ms, **tuning.roofline_metrics(
            cm, main_cfg.batch_size, wave_ms * 1e-3)},
        "main_path_warm": {"wall_s": min(walls["autotuned"]),
                           "simulations": main_post.simulations + pilot * pilot_waves,
                           **tuning.roofline_metrics(
                               cm, main_post.simulations + pilot * pilot_waves,
                               min(walls["autotuned"]))},
    }
    for k, v in roofline.items():
        if not 0 < v["roofline_efficiency"] <= 1.05:
            raise AssertionError(f"tuning_path: roofline_efficiency of {k} is "
                                 f"{v['roofline_efficiency']}, not in (0, 1.05]")

    # (e) the card-side audit: the syncs of one segment of the device loop
    italy = data.get_dataset("italy", num_days=49)
    runner = tabc.make_wave_runner(get_model("siard").prior(),
                                   tabc.make_simulator(italy, main_cfg, dev), main_cfg)
    carry = runner.init(tabc.ABCState(n_params=8))
    torch.cuda.synchronize()

    def synchronizing(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        msgs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
        return out, msgs

    def segment():
        seg = runner(0, 0, carry, tabc.SEGMENT_WAVES)
        return seg, runner.read(seg)

    (seg, (waves, n_acc, fill)), seg_syncs = synchronizing(segment)
    state = tabc.ABCState(n_params=8)
    _, harvest_syncs = synchronizing(lambda: runner.harvest(seg, state, fill))
    if len(seg_syncs) != 1:
        raise AssertionError(f"tuning_path: a device-loop segment made {len(seg_syncs)} "
                             f"synchronizing calls, the contract is 1: {seg_syncs[:4]}")
    seg_same = bitwise("tuning_path audited segment theta", state.to_arrays()[0],
                       main_post.theta)

    # (f) the static analysis of the tree: no finding
    report_path = os.path.join(root, "analysis.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--report",
                           report_path], cwd=ROOT, capture_output=True, text=True,
                          timeout=900, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    analysis_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"tuning_path: python -m repro_torch.analysis exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    with open(report_path) as f:
        report = json.load(f)
    launches, gated = dict(abc_sim.ENTRY_LAUNCHES), dict(abc_sim.ENTRY_GATED)
    emit("tuning_path", cost_model=costs, autotune=tuned,
         autotuned_main_path={"argv": argv_t, "cold_s": cold_s, "entry": main_entry,
                              "bitwise_main_path": same, "runs": post_t.runs,
                              "warm_wall_s": {k: float(np.mean(v)) for k, v in walls.items()},
                              "turns_s": walls},
         roofline=roofline,
         sync_audit={"sync_debug_mode": "warn", "enqueued_waves": tabc.SEGMENT_WAVES,
                     "waves": waves, "accepted": n_acc, "segment_syncs": len(seg_syncs),
                     "segment_sync_messages": seg_syncs[:2],
                     "harvest_syncs": len(harvest_syncs), "rows_bitwise_main_path": seg_same},
         analysis={"returncode": proc.returncode, "findings": report["counts"]["total"],
                   "passes": report["passes"], "wall_s": analysis_s},
         launches=launches, gated_launches=gated, kind=name, nvidia_smi=smi)
    shutil.rmtree(root, ignore_errors=True)
    return launches, gated


#: the phase groups `--only` can run after the build, in this order
ONLY_GROUPS = ("flash", "encdec", "train", "mesh", "li2020")


def li2020_phase(dev, name: str, smi: str, info: dict) -> dict:
    """Phase li2020_path (see the docstring): Li et al. 2020's cities on the
    tile route at the benchmark cell's shape. Returns the tile route's
    `kernels` line."""
    import torch

    from perfbench import harness
    from repro_torch.core import abc as tabc
    from repro_torch.kernels import abc_sim, ref

    t0 = time.perf_counter()
    _, entry, workload, config = harness.cell_files(LI2020_CELL)
    cell = harness.make_cell(LI2020_CELL, entry, workload, config)
    ds, cfg, runner, wave_entry = harness.make_program(cell, dev)
    setup_s = time.perf_counter() - t0
    sim, prior, spec, batch = runner.sim, runner.prior, cfg.model, cell.batch
    if wave_entry != abc_sim.entry_name(spec, "wave", "tile") or spec.n_regions != 375:
        raise AssertionError(f"li2020_path: the main path launches {wave_entry} at "
                             f"R = {spec.n_regions}, not the tile route at 375 cities")
    lib = info[abc_sim.library(spec)]
    variants = {str(v): lib.kernels[k] for v in range(16) for k in lib.kernels
                if abc_sim.variant_symbol(spec, v, "tile") in k}
    if len(variants) != 16:
        raise AssertionError(f"li2020_path: {len(variants)} tile variants of li2020 in "
                             f"{abc_sim.library(spec)}'s ptxas report, want 16")

    def plain(theta, seed):
        """The plain version of the simulator's arguments on the card."""
        return ref.abc_sim_distance_ref(theta, seed, sim.observed, model=spec, summary=sim.spec,
                                        distance=sim.distance, schedule=sim.schedule,
                                        mobility=sim.mobility, **sim.scalars)

    # one wave of the main path's simulator against the plain version
    theta, dist = sim.wave(prior, 21, 22, batch)
    want = plain(theta, 22)
    want = torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)
    cases = [bitwise(f"li2020 R=375 {batch}x14 tile wave theta vs prior.sample", theta,
                     prior.sample(21, batch, dev)),
             bitwise(f"li2020 R=375 {batch}x14 tile wave vs plain", dist, want)]

    # the main path's loop, the counters set to 0 just before (`counted`)
    post, counts = counted(lambda: tabc.run_abc(ds, cfg, seed=3535, wave_runner=runner))
    gated = counts["gated"].get(wave_entry, 0)
    routes = abc_sim.route_counts()
    resident = sim.launch("wave", batch).resident
    overlapped = post.runs + gated if resident >= 2 else 0
    if (counts["entries"] != {wave_entry: post.runs + gated}
            or routes != ({"tile": post.runs + gated}, {"tile": gated} if gated else {})
            or overlapped != (post.runs + gated if resident >= 2 else 0)
            or (counts["plain_calls"], counts["host_prior_draws"]) != (0, 0)
            or len(post) < int(config["target_accepted"])):
        raise AssertionError(f"li2020_path: launches {counts}, routes {routes}, "
                             f"{overlapped} with two tiles or more an SM, "
                             f"{len(post)} accepted in {post.runs} waves")

    # the wave entry alone at the cell's batch, CUDA events, two turns
    buf = (torch.empty((batch, spec.n_params), device=dev), torch.empty((batch,), device=dev))
    turns = [cuda_ms(lambda: sim.wave(prior, 1, 2, batch, out=buf), 20) for _ in range(2)]
    ms = float(np.mean(turns))
    th_plain = prior.sample(3, batch, dev)
    plain_ms = cuda_ms(lambda: plain(th_plain, 4), 1, warmup=1)
    wave_ops = batch * (int(config["days"]) * config["ops_per_sample_day"]
                        + config["ops_per_sample"])
    bound_ms = wave_ops / F32_OPS_PER_S * 1e3
    emit("li2020_path", cell=LI2020_CELL, regions=spec.n_regions, batch=batch,
         days=int(config["days"]), entry=wave_entry, setup_s=setup_s,
         tolerance=float(cfg.tolerance), comparisons=cases, accepted=len(post),
         waves=post.runs, counts=counts, route_launches=routes[0], route_gated=routes[1],
         tile_overlapped_launches=overlapped, resident_blocks_per_sm=resident,
         ptxas_wave_variant=variants["8"], turns_ms=turns, ms=ms, plain_ms=plain_ms,
         wave_ops=wave_ops, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
         memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)), kind=name,
         nvidia_smi=smi)
    return {
        "name": "abc_sim_regional_tile", "route": "cuda", "source": REGIONAL_TILE_SOURCE,
        "replaces": None, "launches": post.runs + gated, "gated_launches": gated,
        "entries": [{"entry": wave_entry, "source": "src/repro_torch/kernels/csrc/"
                     f"{abc_sim.library(spec)}.cu", "launches": post.runs + gated,
                     "gated_launches": gated}],
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations", "issue_floor_ms": None, "library_ms": None,
        "shape": {"regions": spec.n_regions, "batch": batch, "days": int(config["days"])},
    }


def partial_run(dev, name: str, smi: str, only, t_start: float, info: dict) -> int:
    """`--only`: the named groups of phases after the build, for work on
    one part (no kernels line: that is the whole run's)."""
    import torch

    if "flash" in only:
        flash_phase(dev)
    if "encdec" in only:
        encdec_phases(dev, name, smi)
    if "train" in only:
        train_phases(dev, name, smi)
    if "mesh" in only:
        mesh_phases(dev, name, smi)
    if "li2020" in only:
        li2020_phase(dev, name, smi, info)
    emit("total", wall_s=time.perf_counter() - t_start, only=sorted(only))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one card (see the docstring).")
    ap.add_argument("--only", default="",
                    help=f"comma list of {', '.join(ONLY_GROUPS)}: run only these phases "
                    "after the build (the default runs everything)")
    only = {g for g in ap.parse_args(argv).only.split(",") if g}
    if not only <= set(ONLY_GROUPS):
        ap.error(f"--only takes {ONLY_GROUPS}, got {sorted(only)}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "experiments"))
    import flash_f32_cuda_core
    from repro_torch.core import abc as tabc
    from repro_torch.core import priors
    from repro_torch.core.priors import paper_prior, schedule_prior
    from repro_torch.core.smc import SMCConfig, run_smc_abc
    from repro_torch.core.summaries import lower_summary, get_summary, summary_pairs
    from repro_torch.epi import data
    from repro_torch.epi.models import get_model
    from repro_torch.epi.spec import InterventionSchedule, make_mobility, regionalize
    from repro_torch.kernels import abc_sim, build, ops, ref, sass
    from repro_torch.kernels import rng as krng
    from repro_torch.launch import abc_run

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 references run in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=name, count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build
    t0 = time.perf_counter()
    cuda_core_build = flash_f32_cuda_core.start_build()
    info = build.build_all()
    cuda_core_fn, cuda_core_ptxas = flash_f32_cuda_core.finish_build(cuda_core_build)
    build_wall = time.perf_counter() - t0
    hgmma = build.sass_counts("flash_attention_wgmma", "HGMMA")
    if hgmma is not None and not all(hgmma.values()):
        raise AssertionError(f"build: a tensor-core flash kernel issues no HGMMA: {hgmma}")
    tf32_text = build.sass_text("flash_attention_tf32")
    hgmma_tf32 = None if tf32_text is None else tf32_hgmma_counts(tf32_text)
    attention = {k: n for k, n in (hgmma_tf32 or {}).items() if "flash_fwd_tf32_kernel" in k}
    if hgmma_tf32 is not None and not (attention and all(
            n["tf32"] > 0 and n["tf32"] == n["all"] for n in attention.values())):
        raise AssertionError(f"build: a float32 flash kernel issues no TF32 HGMMA, or "
                             f"another kind: {hgmma_tf32}")
    # ptxas warns (C7515, "Potential Performance Loss") where it serialises wgmma
    ptxas_notes = {k: [line.strip() for line in v.path.with_suffix(".ptxas.txt").read_text()
                       .splitlines() if "Performance Loss" in line]
                   for k, v in info.items()}
    siard = get_model("siard")
    models = {m: get_model(m) for m in ABC_MODELS}
    main_flags = lower_summary(get_summary(None), "euclidean", torch.ones(3, 49)).flags
    census = abc_census(build, siard, main_flags)
    model_census = {m: (census["wave"] if m == "siard" else
                        abc_census(build, spec, main_flags, (("wave", True),))["wave"])
                    if census else None for m, spec in models.items()}
    metapop = get_model("metapop_seir")
    regional_specs = {m: get_model(m) if m == "metapop_seir" else regionalize(models[m], 2)
                      for m in REGIONAL_STRUCTS}
    variants, regional_variants, warp_variants = {}, {}, {}
    for table, specs, route in ((variants, models, None),
                                (regional_variants, regional_specs, "thread"),
                                (warp_variants, regional_specs, "warp")):
        for m, spec in specs.items():
            lib = info[abc_sim.library(spec)]
            table[m] = {str(v): lib.kernels[k] for v in range(16) for k in lib.kernels
                        if abc_sim.variant_symbol(spec, v, route) in k}
            if len(table[m]) != 16:
                raise AssertionError(f"build: {len(table[m])} variants of {m} in "
                                     f"{abc_sim.library(spec)}'s ptxas report, want 16")
    local = {m: [v for v, k in t.items() if k["stack_bytes"] or k["spill_stores"]
                 or k["spill_loads"]] for m, t in warp_variants.items()}
    if any(local.values()):
        raise AssertionError(f"build: warp-route variants with stack or spills: {local}")
    mp_census = regional_census(build, metapop, main_flags)
    mp_warp_census = regional_census(build, metapop, main_flags, route="warp")
    for c in (mp_census, mp_warp_census):
        if c is not None and not c["shape_ok"]:
            raise AssertionError(f"build: the regional census found no day of its shape: {c}")
    census_per_day = None
    if census and mp_census and mp_warp_census:
        census_per_day = {m: model_census[m]["per_day"]["total"] for m in ABC_MODELS}
        census_per_day["metapop_seir thread R=4"] = sass.regional_per_day(mp_census, 4, 4)["total"]
        census_per_day["metapop_seir warp R=100"] = sass.regional_warp_per_day(
            mp_warp_census, 100, 2 * 100)["total"]
    emit("build", wall_s=build_wall,
         nvcc_s={k: v.seconds for k, v in info.items()},
         libraries={k: {"nvcc_s": v.seconds, "cached": v.cached,
                        "nvcc_flags": list(build.flags(k)), "kernels": v.kernels,
                        "ptxas_wgmma_notes": ptxas_notes[k]}
                    for k, v in info.items()},
         abc_sim_variants=variants,
         abc_sim_regional_variants=regional_variants,
         abc_sim_regional_local_bytes={
             m: sorted({k["stack_bytes"] for k in v.values()})
             for m, v in regional_variants.items()},
         abc_sim_regional_wave_census_metapop_seir=mp_census
         or "not measured: the toolkit has no cuobjdump",
         abc_sim_regional_warp_variants={
             m: {key: sorted({k[key] for k in v.values()})
                 for key in ("registers", "stack_bytes", "spill_stores", "spill_loads")}
             for m, v in warp_variants.items()},
         abc_sim_regional_warp_wave_census_metapop_seir=mp_warp_census
         or "not measured: the toolkit has no cuobjdump",
         abc_sim_wave_census_per_model={
             m: {k: c[k] for k in ("function", "per_day", "per_sample_outside_loop")}
             if c else "not measured: the toolkit has no cuobjdump"
             for m, c in model_census.items()},
         abc_sim_scheduled_siard_census="the same function as siard's wave entry: the "
         "schedule's breakpoints, scaled parameters and scales are run-time values",
         cuda_core_f32_experiment={"source": "experiments/flash_f32_cuda_core.cu",
                                   "kernels": cuda_core_ptxas},
         hgmma_in_sass=hgmma if hgmma is not None else
         "not measured: the toolkit has no cuobjdump",
         tf32_hgmma_in_sass=hgmma_tf32 if hgmma_tf32 is not None else
         "not measured: the toolkit has no cuobjdump",
         abc_sim_census=census or "not measured: the toolkit has no cuobjdump",
         census_per_sample_day=census_per_day or "not measured: the toolkit has no cuobjdump")

    if only:
        return partial_run(dev, name, smi, only, t_start, info)

    # ---- rng: the kernel's hash bits and normals against the plain twin
    B, C, seed = 1_000_000, 10, 0x5EED1234
    idx = torch.arange(B, device=dev)[:, None]
    ctr = torch.arange(C, device=dev)[None, :]
    bits_k = abc_sim.rng_normals(seed, B, C, bits=True, device=dev)
    bits_p = krng.hash_u32(seed, idx, ctr)
    if not torch.equal(bits_k, bits_p):
        raise AssertionError(f"rng: {int((bits_k != bits_p).sum())} hash words differ")
    z_k = abc_sim.rng_normals(seed, B, C, device=dev)
    z_p = krng.normal(seed, idx, ctr)
    z_err = float((z_k - z_p).abs().max())
    if not z_err <= 1e-6:
        raise AssertionError(f"rng: normals differ by {z_err} > 1e-6")
    # the kernel's branch-free Box-Muller pieces against logf, sqrtf and cosf
    # on all 2^24 uniforms the hash can give
    unit_math = abc_sim.unit_math_mismatches(dev)
    if unit_math != (0, 0):
        raise AssertionError(f"rng: the branch-free log/sqrt and cos differ from logf/sqrtf "
                             f"and cosf on {unit_math} of the 2^24 uniforms")
    emit("rng", shape=[B, C], hash_bits_equal=True, normals_max_abs_err=z_err,
         normals_atol=1e-6, normals_bitwise_equal_share=float((z_k == z_p).double().mean()),
         unit_math_mismatches_of_2_24=list(unit_math))

    # ---- abc_sim: both entries against the plain version on the card, bitwise
    prior = paper_prior()
    results = []

    def on_card(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def theta_in(case, theta, seed, observed, kw, model=siard, **extra):
        """The theta-in entry against the plain version, bitwise."""
        th, ob = on_card(theta), on_card(observed)
        d_k = ops.abc_sim_distance(th, seed, ob, model=model, **kw, **extra)
        d_p = ref.abc_sim_distance_ref(th, seed, ob, model=model, **kw, **extra)
        results.append(bitwise(f"{case} theta-in entry vs plain", d_k, d_p))
        return d_k

    def wave(case, batch, prior_seed, sim_seed, observed, kw, model=siard, **extra):
        """The wave entry against prior.sample + the plain version, bitwise."""
        wave_prior = schedule_prior(model, extra.get("schedule"))
        sim = ops.make_abc_sim(on_card(observed), model=model, **kw, **extra)
        entry = abc_sim.entry_name(model, "wave")
        before = (abc_sim.ENTRY_LAUNCHES.get(entry, 0), priors.DEVICE_DRAWS, ref.CALLS)
        th_k, d_k = sim.wave(wave_prior, prior_seed, sim_seed, batch)
        if (abc_sim.ENTRY_LAUNCHES.get(entry, 0), priors.DEVICE_DRAWS, ref.CALLS) != (
                before[0] + 1, before[1], before[2]):
            raise AssertionError(f"{case}: the wave did not go through {entry} alone")
        th_p = wave_prior.sample(prior_seed, batch, dev)
        d_p = ref.abc_sim_distance_ref(th_p, sim_seed, on_card(observed), model=model,
                                       **kw, **extra)
        d_p = torch.where(torch.isnan(d_p), torch.full_like(d_p, float("inf")), d_p)
        if not torch.equal(th_k, th_p):
            raise AssertionError(f"{case}: the wave entry's theta differs from prior.sample "
                                 f"in {int((th_k != th_p).sum())} elements")
        results.append(bitwise(f"{case} wave entry vs plain", d_k, d_p))
        return th_k, d_k

    pins = np.load(PINS)
    pop, a0, r0, d0, _ = data.SYNTH_SMALL_META
    small_kw = dict(population=pop, a0=a0, r0=r0, d0=d0)
    d_k = theta_in("pins 16x14", pins["siard/theta"], 123, pins["siard/observed"], small_kw)
    results.append(bitwise("pins 16x14 theta-in entry vs siard/pallas", d_k,
                           pins["siard/pallas"]))
    results.append(compare("pins 16x14 theta-in entry vs siard/oracle", d_k,
                           pins["siard/oracle"], **BAR))
    wave("pins 16x14", 16, 123, 123, pins["siard/observed"], small_kw)

    small = data.get_dataset("synthetic_small", num_days=49)
    th_small = prior.sample(11, 1024, dev)
    theta_in("synthetic_small 1024x49", th_small, 77, small.observed, small_kw)
    wave("synthetic_small 1024x49", 1024, 11, 77, small.observed, small_kw)

    italy = data.get_dataset("italy", num_days=49)
    it_kw = dict(population=italy.population, a0=italy.a0, r0=italy.r0, d0=italy.d0)
    th_it = prior.sample(12, 100_000, dev)
    d_it = theta_in("italy 100000x49", th_it, 99, italy.observed, it_kw)
    _, w_it = wave("italy 100000x49", 100_000, 12, 99, italy.observed, it_kw)
    ob_it = torch.as_tensor(italy.observed, device=dev)
    for block in (64, 128, 256):
        d_b = ops.abc_sim_distance(th_it, 99, ob_it, model=siard, block=block, **it_kw)
        _, w_b = ops.make_abc_sim(ob_it, model=siard, block=block, **it_kw).wave(
            prior, 12, 99, 100_000)
        if not (torch.equal(d_b, d_it) and torch.equal(w_b, w_it)):
            raise AssertionError(f"block {block}: distances differ from block 128")
    for s, dist in summary_pairs():
        theta_in(f"{s}/{dist} 1024x49", th_small, 77, small.observed, small_kw,
                 summary=s, distance=dist)
        wave(f"{s}/{dist} 1024x49", 1024, 11, 77, small.observed, small_kw,
             summary=s, distance=dist)

    # the other flat models: pins, then 1024 and 100,000 x 49 on their series
    series = {}
    for m in ABC_MODELS[1:]:
        spec = models[m]
        d_k = theta_in(f"{m} pins 16x14", pins[f"{m}/theta"], 123, pins[f"{m}/observed"],
                       small_kw, model=spec)
        results.append(bitwise(f"{m} pins 16x14 theta-in entry vs {m}/pallas", d_k,
                               pins[f"{m}/pallas"]))
        wave(f"{m} pins 16x14", 16, 123, 123, pins[f"{m}/observed"], small_kw, model=spec)
        ds = data.get_dataset("italy" if m == "seiard" else "synthetic_small", num_days=49,
                              model=m)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
        series[m] = (ds, kw)
        for batch in (1024, 100_000):
            th = spec.prior().sample(batch + 1, batch, dev)
            theta_in(f"{m} {ds.name} {batch}x49", th, 77, ds.observed, kw, model=spec)
            wave(f"{m} {ds.name} {batch}x49", batch, batch + 1, 77, ds.observed, kw, model=spec)
    series["siard"] = (italy, it_kw)

    # every model under the two schedules of tests/test_interventions.py:142-170
    for m in ABC_MODELS:
        spec, tv = models[m], SCHEDULE_TV[m]
        obs_m = data.get_dataset("synthetic_small", num_days=49, model=m).observed
        for tag, sched in (("one fixed window", InterventionSchedule.fixed((tv,), (4,), (0.3,))),
                           ("two inferred windows",
                            InterventionSchedule.inferred((tv,), (3, 8), 0.2, 1.5))):
            th = schedule_prior(spec, sched).sample(21, 1024, dev)
            theta_in(f"{m} {tag} 1024x49", th, 7, obs_m, small_kw, model=spec, schedule=sched)
            wave(f"{m} {tag} 1024x49", 1024, 21, 7, obs_m, small_kw, model=spec,
                 schedule=sched)

    # a lockdown-day sweep: the breakpoint is a run-time value, so the loaded
    # libraries serve every day and nothing is built again
    libs, built = dict(build._LIBS), dict(build._INFO)
    for day in (10, 20, 30):
        sched = InterventionSchedule.fixed(("alpha0",), (day,), (0.3,))
        th = schedule_prior(siard, sched).sample(day, 1024, dev)
        theta_in(f"sweep day {day} 1024x49", th, 5, small.observed, small_kw, schedule=sched)
        wave(f"sweep day {day} 1024x49", 1024, day, 5, small.observed, small_kw,
             schedule=sched)
    if build._LIBS != libs or build._INFO != built:
        raise AssertionError("abc_sim: the lockdown-day sweep built or loaded a library")

    # the schedule_path phase's shapes: Italy at 100,000 x 49 under its
    # intervention, for SIARD (the phase's model) and seiard
    sched_it = abc_run.parse_intervention(INTERVENTION)
    for m in ("siard", "seiard"):
        spec = models[m]
        ds, kw = (italy, it_kw) if m == "siard" else series[m]
        th = schedule_prior(spec, sched_it).sample(31, 100_000, dev)
        theta_in(f"{m} italy {INTERVENTION} 100000x49", th, 99, ds.observed, kw, model=spec,
                 schedule=sched_it)
        wave(f"{m} italy {INTERVENTION} 100000x49", 100_000, 31, 99, ds.observed, kw,
             model=spec, schedule=sched_it)
    # the region axis: metapop_seir (R=4, ring:0.1) at both sizes for the
    # three pairs of tests/test_metapop.py, under a one-window schedule
    n_flat = len(results)
    mp_ds = data.get_dataset("synthetic_small", num_days=49, model=metapop)
    mp_kw = dict(population=mp_ds.population, a0=mp_ds.a0, r0=mp_ds.r0, d0=mp_ds.d0)
    for batch in (1024, 100_000):
        th = metapop.prior().sample(batch + 3, batch, dev)
        for s_, dist in METAPOP_PAIRS:
            tag = f"metapop_seir R=4 {s_}/{dist} {batch}x49"
            theta_in(tag, th, 77, mp_ds.observed, mp_kw, model=metapop, summary=s_,
                     distance=dist)
            wave(tag, batch, batch + 3, 77, mp_ds.observed, mp_kw, model=metapop, summary=s_,
                 distance=dist)
    sched_mp = abc_run.parse_intervention(METAPOP_INTERVENTION)
    th = schedule_prior(metapop, sched_mp).sample(23, 1024, dev)
    theta_in(f"metapop_seir R=4 {METAPOP_INTERVENTION} 1024x49", th, 7, mp_ds.observed,
             mp_kw, model=metapop, schedule=sched_mp)
    wave(f"metapop_seir R=4 {METAPOP_INTERVENTION} 1024x49", 1024, 23, 7, mp_ds.observed,
         mp_kw, model=metapop, schedule=sched_mp)
    # seir and siard regionalized without coupling (3 independent copies),
    # metapop_seir at R=10 and R=100
    for spec in (regionalize(models["seir"], 3), regionalize(siard, 3),
                 regionalize(metapop, 10, "ring:0.1"), regionalize(metapop, 100, "ring:0.1")):
        ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
        th = spec.prior().sample(spec.n_regions, 1024, dev)
        for s_, dist in (("identity", "euclidean"), ("region_pooled", "euclidean")):
            tag = f"{spec.name} {s_}/{dist} 1024x49"
            theta_in(tag, th, 11, ds.observed, kw, model=spec, summary=s_, distance=dist)
            wave(tag, 1024, spec.n_regions, 11, ds.observed, kw, model=spec, summary=s_,
                 distance=dist)
    # a mobility sweep: the matrix is a run-time value in a device buffer, so
    # the loaded library serves every matrix and nothing is built again
    libs, built = dict(build._LIBS), dict(build._INFO)
    th = metapop.prior().sample(31, 1024, dev)
    sweep = {}
    for grammar in ("identity", "ring:0.1", "uniform:0.2"):
        mob = make_mobility(grammar, metapop.n_regions)
        sweep[grammar] = theta_in(f"metapop_seir mobility {grammar} 1024x49", th, 5,
                                  mp_ds.observed, mp_kw, model=metapop, mobility=mob)
        wave(f"metapop_seir mobility {grammar} 1024x49", 1024, 31, 5, mp_ds.observed, mp_kw,
             model=metapop, mobility=mob)
    if build._LIBS != libs or build._INFO != built:
        raise AssertionError("abc_sim: the mobility sweep built or loaded a library")
    if torch.equal(sweep["identity"], sweep["ring:0.1"]) or torch.equal(
            sweep["ring:0.1"], sweep["uniform:0.2"]):
        raise AssertionError("abc_sim: two mobility matrices gave the same distances")

    # both routes of the region axis, each entry, whatever route R picks
    def both_routes(spec, summary="identity", batch=1024, seed=11, prior_seed=7):
        ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
        ob = torch.as_tensor(ds.observed, device=dev)
        sim = ops.make_abc_sim(ob, model=spec, summary=summary, **kw)
        box = spec.prior()
        th = box.sample(prior_seed, batch, dev)
        want = ref.abc_sim_distance_ref(th, seed, ob, model=spec, summary=summary, **kw)
        want_w = torch.where(torch.isnan(want), torch.full_like(want, float("inf")), want)
        for route in abc_sim.ROUTES:
            tag = f"{spec.name} {summary} {batch}x49 {route} route"
            d = sim.launch("distance", batch, route)(seed, abc_sim.theta_to_soa(th))
            th_w, d_w = sim.launch("wave", batch, route)(seed, prior_seed, box.lows, box.highs)
            if not torch.equal(th_w, th):
                raise AssertionError(f"{tag}: the wave entry's theta differs from prior.sample")
            results.append(bitwise(f"{tag} theta-in entry vs plain", d, want))
            results.append(bitwise(f"{tag} wave entry vs plain", d_w, want_w))

    n_routes = len(results)
    for R in (4, 10, 100, 128):
        both_routes(metapop if R == 4 else regionalize(metapop, R, "ring:0.1"))
    both_routes(regionalize(metapop, 100, "ring:0.1"), "region_pooled")
    # regions_path's own shape: R=100 on a ring, 100,000 a wave
    both_routes(regionalize(metapop, 100, "ring:0.1"), batch=100_000)
    regional_err = max(r["max_abs_err"] for r in results[n_flat:])
    warp_err = max(r["max_abs_err"] for r in results[n_routes:] if " warp route " in r["case"])
    emit("abc_sim", comparisons=results, block_sizes_bitwise_equal=[64, 128, 256],
         lockdown_sweep_rebuilds=0, mobility_sweep_rebuilds=0,
         regional_comparisons=len(results) - n_flat,
         regional_route_comparisons=len(results) - n_routes,
         regional_routes={R: {b: abc_sim.regional_route(regionalize(metapop, R, "ring:0.1"), b)
                              for b in (20_000, 100_000)} for R in (2, 4, 10, 12, 32, 100, 128)})
    max_abs_err = max(r["max_abs_err"] for r in results[:n_flat]
                      if r["case"].endswith("vs plain"))

    # ---- gate: a launch whose gate reads 0 writes nothing, on every entry
    gate_cases = []
    g0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    g1 = torch.ones((1,), dtype=torch.int32, device=dev)
    for spec in (*models.values(), metapop, regionalize(metapop, 100, "ring:0.1")):
        ds = data.get_dataset("italy" if spec.name in ("siard", "seiard") else "synthetic_small",
                              num_days=49, model=spec)
        kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
        sim = ops.make_abc_sim(torch.as_tensor(ds.observed, device=dev), model=spec, **kw)
        box, batch = spec.prior(), 4096
        soa = abc_sim.theta_to_soa(box.sample(3, batch, dev))
        for route in abc_sim.ROUTES if spec.is_regional else (None,):
            wave_ln, in_ln = (sim.launch(e, batch, route) for e in ("wave", "distance"))

            def run_wave(gate=None, out=None, ln=wave_ln):
                return ln(5, 9, box.lows, box.highs, gate=gate, out=out)

            def run_in(gate=None, out=None, ln=in_ln):
                return ln(5, soa, gate=gate, out=out)
            for entry, fn, outs in (
                    ("wave", run_wave, lambda: (torch.full((batch, box.dim), 7.5, device=dev),
                                                torch.full((batch,), -3.25, device=dev))),
                    ("distance", run_in, lambda: torch.full((batch,), -3.25, device=dev))):
                tag = f"{abc_sim.entry_name(spec, entry, route)} R={spec.n_regions}"
                sentinel = outs()
                buffers = outs()
                before = abc_sim.ENTRY_LAUNCHES.get(abc_sim.entry_name(spec, entry, route), 0)
                fn(g0, buffers)
                torch.cuda.synchronize()
                if abc_sim.ENTRY_LAUNCHES.get(abc_sim.entry_name(spec, entry, route)) != \
                        before + 1:
                    raise AssertionError(f"gate {tag}: the gated call launched no kernel")
                for got, want in zip(*((buffers, sentinel) if entry == "wave"
                                       else ((buffers,), (sentinel,)))):
                    gate_cases.append(bitwise(f"{tag} gate 0: buffer unchanged", got, want))
                opened = fn(g1, outs())
                plain = fn()
                for got, want in zip(*((opened, plain) if entry == "wave"
                                       else ((opened,), (plain,)))):
                    gate_cases.append(bitwise(f"{tag} gate 1 vs no gate", got, want))
                try:
                    fn(torch.zeros((1,), dtype=torch.int32))
                except ValueError as e:
                    if "gate must be an int32 tensor" not in str(e):
                        raise
                else:
                    raise AssertionError(f"gate {tag}: a gate on the CPU was taken")
    emit("gate", comparisons=gate_cases, cpu_gate_refused=True)

    def abc_path(phase, argv, model, intervention="", min_accepted=100):
        """`abc_run.main(argv)` with the counters set to 0 just before; raises
        unless the model's wave entry made every launch, 1 + waves + gated
        (the pilot, the waves, and on the device loop fewer than
        SEGMENT_WAVES gated ones in at most ceil(waves / SEGMENT_WAVES) host
        syncs; none on the host loop), with no host prior draw and no
        plain-version call, and the posterior holds `min_accepted` samples
        inside the box. Its compaction-kernel launches go to
        `path_compactions`."""
        abc_sim.ENTRY_LAUNCHES.clear()
        abc_sim.ENTRY_GATED.clear()
        priors.DEVICE_DRAWS = 0
        ref.CALLS = 0
        tabc.HOST_SYNCS = 0
        compactions = tabc.COMPACT_KERNEL_LAUNCHES
        t0 = time.perf_counter()
        post = abc_run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path_compactions[phase] = tabc.COMPACT_KERNEL_LAUNCHES - compactions
        entries = dict(abc_sim.ENTRY_LAUNCHES)
        gated = abc_sim.gated_launches("wave")
        counts = dict(wave_launches=abc_sim.launches("wave"), gated_wave_launches=gated,
                      theta_in_launches=abc_sim.launches("distance"),
                      host_prior_draws=priors.DEVICE_DRAWS, plain_calls=ref.CALLS,
                      host_syncs=tabc.HOST_SYNCS, compactions=path_compactions[phase])
        host_loop = "--wave-loop" in argv and argv[argv.index("--wave-loop") + 1] == "host"
        segments = 0 if host_loop else -(-post.runs // tabc.SEGMENT_WAVES)
        entry = abc_sim.entry_name(model, "wave")
        if (entries != {entry: 1 + post.runs + gated}
                or (counts["theta_in_launches"], counts["host_prior_draws"],
                    counts["plain_calls"]) != (0, 0, 0)
                or not 0 <= gated <= (0 if host_loop else tabc.SEGMENT_WAVES - 1)
                or not (1 if segments else 0) <= tabc.HOST_SYNCS <= segments):
            raise AssertionError(f"{phase}: launches {entries} (want {entry}: 1 + "
                                 f"{post.runs} waves + {gated} gated), {counts}")
        box = schedule_prior(model, abc_run.parse_intervention(intervention))
        lo, hi = np.asarray(box.lows), np.asarray(box.highs)
        theta = post.theta
        if (len(post) < min_accepted or theta.shape[1] != box.dim or not np.isfinite(theta).all()
                or not np.isfinite(post.distances).all()
                or (post.distances > post.tolerance).any()
                or (theta < lo).any() or (theta > hi).any()):
            raise AssertionError(f"{phase}: bad posterior ({len(post)} samples, "
                                 f"{theta.shape[1]} columns)")
        return post, wall, entries, counts, lo, hi

    def against_truth(theta, lo, hi):
        """Normalized error of the posterior mean and of the prior mean
        against Italy's generating parameters (SIARD's 8, which seiard
        shares), over those 8 columns."""
        truth = np.asarray(data.TABLE8_THETA["italy"])
        lo, hi = lo[:8], hi[:8]
        err = np.abs(theta[:, :8].mean(axis=0) - truth) / (hi - lo)
        prior_err = np.abs((hi + lo) / 2 - truth) / (hi - lo)
        return err.mean().item(), prior_err.mean().item()

    path_launches, path_gated = {}, {}
    #: compaction-kernel launches by path (`core.abc.COMPACT_KERNEL_LAUNCHES`)
    path_compactions = {}

    def compacting(phase, fn):
        """fn(), its compaction-kernel launches kept under `phase`."""
        compactions = tabc.COMPACT_KERNEL_LAUNCHES
        out = fn()
        path_compactions[phase] = tabc.COMPACT_KERNEL_LAUNCHES - compactions
        return out

    italy_argv = ["--dataset", "italy", "--days", "49", "--batch", "100000",
                  "--chunk", "10000", "--auto-tolerance", "1e-4", "--accept", "100",
                  "--device", "cuda"]

    # ---- main_path: the port's CLI on the card, counters read around it
    argv = italy_argv
    post, wall, entries, counts, lo, hi = abc_path("main_path", argv, siard)
    path_launches["main_path"] = entries
    path_gated["main_path"] = dict(abc_sim.ENTRY_GATED)
    theta = post.theta
    err, prior_err = against_truth(theta, lo, hi)
    if not err < prior_err:
        raise AssertionError(f"main path: posterior mean error {err} is not "
                             f"below the prior mean's {prior_err}")
    truth = np.asarray(data.TABLE8_THETA["italy"])
    emit("main_path", argv=argv, **counts,
         accepted=len(post), waves=post.runs, simulations=post.simulations,
         tolerance=post.tolerance, wall_s=wall, kind=name, nvidia_smi=smi,
         posterior_mean=dict(zip(siard.param_names, theta.mean(axis=0).tolist())),
         generating_theta=dict(zip(siard.param_names, truth.tolist())),
         normalized_mean_error=err, prior_mean_normalized_error=prior_err)

    # ---- models_path: seiard on the same series through the same CLI
    seiard = models["seiard"]
    argv = italy_argv + ["--model", "seiard"]
    post_m, wall, entries, counts, lo, hi = abc_path("models_path", argv, seiard)
    path_launches["models_path"] = entries
    path_gated["models_path"] = dict(abc_sim.ENTRY_GATED)
    err, prior_err = against_truth(post_m.theta, lo, hi)
    if not err < prior_err:
        raise AssertionError(f"models_path: posterior mean error {err} over SIARD's "
                             f"parameters is not below the prior mean's {prior_err}")
    emit("models_path", argv=argv, **counts, accepted=len(post_m), waves=post_m.runs,
         simulations=post_m.simulations, tolerance=post_m.tolerance, wall_s=wall, kind=name,
         nvidia_smi=smi,
         posterior_mean=dict(zip(post_m.param_names, post_m.theta.mean(axis=0).tolist())),
         normalized_mean_error_siard_params=err, prior_mean_normalized_error=prior_err)

    # ---- schedule_path: the main path's run with an inferred contact-rate window
    argv = italy_argv + ["--intervention", INTERVENTION]
    post_s, wall, entries, counts, lo, hi = abc_path("schedule_path", argv, siard, INTERVENTION)
    path_launches["schedule_path"] = entries
    path_gated["schedule_path"] = dict(abc_sim.ENTRY_GATED)
    if post_s.theta.shape[1] != 9 or post_s.param_names[-1] != "alpha0_w1":
        raise AssertionError(f"schedule_path: columns {post_s.param_names}")
    err, prior_err = against_truth(post_s.theta, lo, hi)
    emit("schedule_path", argv=argv, **counts, accepted=len(post_s), waves=post_s.runs,
         simulations=post_s.simulations, tolerance=post_s.tolerance, wall_s=wall, kind=name,
         nvidia_smi=smi,
         posterior_mean=dict(zip(post_s.param_names, post_s.theta.mean(axis=0).tolist())),
         normalized_mean_error_siard_params=err, prior_mean_normalized_error=prior_err)

    # ---- metapop_path: the 4-region metapopulation SEIR through the same CLI
    mp_argv = ["--model", "metapop_seir", "--dataset", "synthetic_small", "--days", "49",
               "--batch", "100000", "--chunk", "10000", "--auto-tolerance", "1e-4",
               "--accept", "100", "--device", "cuda"]

    def mean_error(post, model, truth):
        lo, hi = np.asarray(model.prior().lows), np.asarray(model.prior().highs)
        err = np.abs(post.theta.mean(axis=0) - np.asarray(truth)) / (hi - lo)
        return err.mean().item(), (np.abs((hi + lo) / 2 - np.asarray(truth)) / (hi - lo)).mean().item()

    for phase, argv, spec in (
            ("metapop_path", mp_argv, metapop),
            ("regions_path", mp_argv + ["--regions", "100", "--mobility", "ring:0.1"],
             regionalize(metapop, 100, "ring:0.1"))):
        route = abc_sim.regional_route(spec, 100_000)
        if route != ("thread" if phase == "metapop_path" else "warp"):
            raise AssertionError(f"{phase}: R={spec.n_regions} takes the {route} route")
        post_r, wall, entries, counts, lo, hi = abc_path(phase, argv, spec)
        path_launches[phase] = entries
        path_gated[phase] = dict(abc_sim.ENTRY_GATED)
        err, prior_err = mean_error(post_r, spec, spec.default_theta)
        emit(phase, argv=argv, **counts, accepted=len(post_r), waves=post_r.runs,
             simulations=post_r.simulations, tolerance=post_r.tolerance, wall_s=wall,
             regions=spec.n_regions, observed_channels=spec.total_observed, route=route,
             entry=abc_sim.entry_name(spec, "wave"), kind=name,
             nvidia_smi=smi,
             posterior_mean=dict(zip(post_r.param_names, post_r.theta.mean(axis=0).tolist())),
             generating_theta=dict(zip(spec.param_names, spec.default_theta)),
             normalized_mean_error=err, prior_mean_normalized_error=prior_err)

    # ---- wave_loop: each ABC path under both wave loops in turns, bitwise
    mp100 = regionalize(metapop, 100, "ring:0.1")
    loop_paths = {
        "main_path": (italy_argv, siard, ""),
        "models_path": (italy_argv + ["--model", "seiard"], seiard, ""),
        "schedule_path": (italy_argv + ["--intervention", INTERVENTION], siard, INTERVENTION),
        "metapop_path": (mp_argv, metapop, ""),
        "regions_path": (mp_argv + ["--regions", "100", "--mobility", "ring:0.1"], mp100, ""),
    }
    loops = {}
    for phase, (argv, spec, iv) in loop_paths.items():
        walls, posts, counted = {"host": [], "device": []}, {}, {}
        for wl in ("host", "device", "device", "host"):
            post_w, wall, _, counts, _, _ = abc_path(f"wave_loop {phase} {wl}",
                                                     argv + ["--wave-loop", wl], spec, iv)
            walls[wl].append(wall)
            posts.setdefault(wl, post_w)
            counted.setdefault(wl, counts)
        h, d = posts["host"], posts["device"]
        if (h.runs, h.simulations) != (d.runs, d.simulations):
            raise AssertionError(f"wave_loop {phase}: runs and simulations {h.runs}, "
                                 f"{h.simulations} (host) vs {d.runs}, {d.simulations}")
        loops[phase] = {
            "theta": bitwise(f"{phase} theta, device vs host loop", d.theta, h.theta),
            "distances": bitwise(f"{phase} distances, device vs host loop", d.distances,
                                 h.distances),
            "runs": h.runs, "simulations": h.simulations, "accepted": len(h),
            "wall_s": {wl: float(np.mean(v)) for wl, v in walls.items()}, "turns_s": walls,
            "counts": counted}
    emit("wave_loop", paths=loops, segment_waves=tabc.SEGMENT_WAVES, kind=name,
         nvidia_smi=smi)

    # ---- profile: where the main path's waves spend their time, on each loop
    import dataclasses

    cfg = tabc.ABCConfig(batch_size=100_000, chunk_size=10_000, num_days=49,
                         tolerance=post.tolerance, target_accepted=100)
    profiled = {"host": [], "device": []}
    for wl in ("host", "device", "device", "host"):
        runs = []
        syncs = tabc.HOST_SYNCS
        wall_ms, busy_ms, by_op = profile_device_ms(lambda: runs.append(tabc.run_abc(
            italy, dataclasses.replace(cfg, wave_loop=wl), seed=0, device=dev)))
        again = runs[0]
        enqueued = (-(-again.runs // tabc.SEGMENT_WAVES) * tabc.SEGMENT_WAVES
                    if wl == "device" else again.runs)
        kernel_ms = sum(ms for k, _, ms in by_op if "abc_sim_kernel" in k)
        copy_rows = [(k, c, ms) for k, c, ms in by_op if "Memcpy" in k or "Memset" in k]
        copy_ms = sum(ms for _, _, ms in copy_rows)
        profiled[wl].append({
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "waves": again.runs,
            "enqueued_waves": enqueued, "accepted": len(again),
            "host_syncs": tabc.HOST_SYNCS - syncs,
            "device_ops": sum(c for _, c, _ in by_op),
            "device_ops_per_wave": sum(c for _, c, _ in by_op) / again.runs,
            "abc_sim_device_ms": kernel_ms,
            "copies": sum(c for _, c, _ in copy_rows), "copies_device_ms": copy_ms,
            "other_device_ms_per_enqueued_wave": (busy_ms - kernel_ms - copy_ms) / enqueued,
            "top_device_ops": [{"name": k[:80], "count": c, "device_ms": ms}
                               for k, c, ms in by_op[:10]]})
    # the same runs unprofiled (the profiler adds host time to every
    # operation), host clock, in turns
    unprofiled = {"host": [], "device": []}
    for wl in ("host", "device", "device", "host") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tabc.run_abc(italy, dataclasses.replace(cfg, wave_loop=wl), seed=0, device=dev)
        torch.cuda.synchronize()
        unprofiled[wl].append((time.perf_counter() - t0) * 1e3)
    # the compaction at the main path's shape: the kernel (compact_accepted
    # on CUDA tensors) against the plain lines it replaced on the card
    # (core.abc.compact_plain) on fresh buffers alike, rows [0, cap) and new
    # fill bit for bit, for the wave's accept mask, a gated (all false) one
    # and a dense one whose accepts overflow the capacity from a fill of
    # cap - 40; then the device time of each (`queued_us`)
    th_w, d_w = ops.make_abc_sim(ob_it, model=siard, **it_kw).wave(prior, 3, 4, 100_000)
    cap = tabc.wave_capacity(cfg)
    masks = {"wave": (d_w <= tabc.tolerance32(post.tolerance), 0),
             "gated": (torch.zeros_like(d_w, dtype=torch.bool), 0),
             "dense_overflow": (d_w <= d_w.median(), cap - 40)}
    compaction = {}
    for case, (accept, fill) in masks.items():
        fill0 = torch.full((1,), fill, dtype=torch.int64, device=dev)
        bufs = {}
        for path, fn in (("kernel", tabc.compact_accepted), ("plain", tabc.compact_plain)):
            bufs[path] = fn(torch.full((cap + 1, 8), -7.5, device=dev),
                            torch.full((cap + 1,), float("inf"), device=dev), fill0, th_w, d_w,
                            accept, cap)
        n = int(accept.sum())
        (k_th, k_d, k_fill), (p_th, p_d, p_fill) = bufs["kernel"], bufs["plain"]
        if not int(k_fill) == int(p_fill) == fill + n:
            raise AssertionError(f"profile compaction {case}: new fill {int(k_fill)} (kernel), "
                                 f"{int(p_fill)} (plain), want {fill + n}")
        checks = [bitwise(f"compaction {case} rows, kernel vs plain", k_th[:cap], p_th[:cap]),
                  bitwise(f"compaction {case} distances, kernel vs plain", k_d[:cap], p_d[:cap])]
        timed = {path: queued_us(lambda: fn(k_th, k_d, fill0, th_w, d_w, accept, cap))
                 for path, fn in (("kernel", tabc.compact_accepted),
                                  ("plain", tabc.compact_plain))}
        written = min(n, max(cap - fill, 0))
        # the mask read once, and each written row's p + 1 floats read and written
        bound_us = ((accept.numel() + written * (th_w.shape[1] + 1) * 4 * 2)
                    / HBM_BYTES_PER_S * 1e6)
        compaction[case] = {"accepted": n, "fill": fill, "rows_written": written,
                            "checks": checks, "kernel_device_us": timed["kernel"],
                            "plain_device_us": timed["plain"], "bound_us": bound_us}
    emit("profile", loops={wl: {"runs": v, **{k: float(np.mean([r[k] for r in v])) for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "abc_sim_device_ms",
        "copies_device_ms", "other_device_ms_per_enqueued_wave")},
        "unprofiled_wall_ms": float(np.mean(unprofiled[wl])), "unprofiled_turns_ms": unprofiled[wl],
        "busy_share_of_unprofiled_wall": float(np.mean([r["device_busy_ms"] for r in v]))
        / float(np.mean(unprofiled[wl]))}
        for wl, v in profiled.items()},
        compaction_100k=compaction, kind=name, nvidia_smi=smi)
    compaction_100k = compaction

    # ---- no_sync: one segment of the main path's device loop enqueues no sync
    runner = tabc.make_wave_runner(siard.prior(), tabc.make_simulator(italy, cfg, dev), cfg)
    carry = runner.init(tabc.ABCState(n_params=8))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        seg = runner(0, 0, carry, tabc.SEGMENT_WAVES)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    waves, n_acc, fill = runner.read(seg)
    seg_state = tabc.ABCState(n_params=8)
    runner.harvest(seg, seg_state, fill)
    seg_theta, seg_dist = seg_state.to_arrays()
    emit("no_sync", sync_debug_mode="error", enqueued_waves=tabc.SEGMENT_WAVES, waves=waves,
         accepted=n_acc, theta=bitwise("no_sync segment theta vs main_path", seg_theta,
                                       post.theta),
         distances=bitwise("no_sync segment distances vs main_path", seg_dist,
                           post.distances), kind=name, nvidia_smi=smi)

    # ---- smc_path: SMC-ABC of SIARD on Italy through the theta-in entry
    smc_cfg = SMCConfig(n_particles=1000, batch_size=100_000, n_rounds=4, quantile=0.5,
                        num_days=49, wave_loop="device")
    abc_sim.ENTRY_LAUNCHES.clear()
    abc_sim.ENTRY_GATED.clear()
    priors.DEVICE_DRAWS = 0
    ref.CALLS = 0
    tabc.HOST_SYNCS = 0
    t0 = time.perf_counter()
    post_smc = compacting("smc_path", lambda: run_smc_abc(italy, smc_cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entries = dict(abc_sim.ENTRY_LAUNCHES)
    gated = dict(abc_sim.ENTRY_GATED)
    smc_waves = sum(post_smc.round_waves)
    want = {"abc_sim_wave_siard": 1, "abc_sim_distance_siard": smc_waves
            + gated.get("abc_sim_distance_siard", 0)}
    if entries != want or (priors.DEVICE_DRAWS, ref.CALLS) != (0, 0):
        raise AssertionError(f"smc_path: launches {entries}, want {want}; host prior draws "
                             f"{priors.DEVICE_DRAWS}, plain calls {ref.CALLS}")
    eps = post_smc.round_eps
    lo, hi = np.asarray(prior.lows, np.float32), np.asarray(prior.highs, np.float32)
    err, prior_err = against_truth(post_smc.theta, lo, hi)
    if (not all(a > b for a, b in zip(eps, eps[1:])) or len(post_smc) != 1000
            or not np.isfinite(post_smc.theta).all() or not np.isfinite(post_smc.distances).all()
            or (post_smc.theta < lo).any() or (post_smc.theta > hi).any()
            or not err < prior_err):
        raise AssertionError(f"smc_path: eps {eps}, {len(post_smc)} particles, error {err} "
                             f"against the prior mean's {prior_err}")
    path_launches["smc_path"] = entries
    path_gated["smc_path"] = gated
    emit("smc_path", n_particles=1000, batch=100_000, days=49, rounds=smc_cfg.n_rounds,
         quantile=smc_cfg.quantile, wave_loop="device", round_eps=eps,
         round_waves=post_smc.round_waves, waves=smc_waves, simulations=post_smc.simulations,
         theta_in_launches=want["abc_sim_distance_siard"], gated_theta_in_launches=gated,
         wave_launches=1, host_syncs=tabc.HOST_SYNCS, plain_calls=ref.CALLS,
         compactions=path_compactions["smc_path"],
         host_prior_draws=priors.DEVICE_DRAWS, wall_s=wall,
         posterior_mean=dict(zip(post_smc.param_names, post_smc.theta.mean(axis=0).tolist())),
         normalized_mean_error=err, prior_mean_normalized_error=prior_err,
         ess=float(1.0 / np.sum(post_smc.weights.astype(np.float64) ** 2)), kind=name,
         nvidia_smi=smi)

    # ---- campaign_path: the campaign CLI, its resume, each cell against its
    # solo run, a lockdown sweep and two seeds of the 100-region model
    import shutil

    from repro_torch.checkpoint import load_checkpoint

    camp_root = os.path.join(ROOT, "build", "campaign_path")
    shutil.rmtree(camp_root, ignore_errors=True)
    camp_common = ["--days", "49", "--auto-tolerance", "1e-4", "--accept", "100",
                   "--device", "cuda"]

    def campaign_cli(phase, argv):
        """`abc_run.main(["--campaign", ...])` with the counters set to 0
        just before; its report, wall and counts."""
        abc_sim.ENTRY_LAUNCHES.clear()
        abc_sim.ENTRY_GATED.clear()
        priors.DEVICE_DRAWS = 0
        ref.CALLS = 0
        tabc.HOST_SYNCS = 0
        t0 = time.perf_counter()
        report = compacting(phase, lambda: abc_run.main(["--campaign"] + argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return report, wall, {"entries": dict(abc_sim.ENTRY_LAUNCHES),
                              "gated": dict(abc_sim.ENTRY_GATED),
                              "host_syncs": tabc.HOST_SYNCS, "plain_calls": ref.CALLS,
                              "host_prior_draws": priors.DEVICE_DRAWS,
                              "compactions": path_compactions[phase]}

    def segments_of(runs, max_runs=10_000, every=32):
        """(segments, enqueued waves) of a scenario that ran `runs` waves:
        its segments end at SEGMENT_WAVES and at multiples of `every`."""
        done = segments = 0
        while done < runs:
            done += min(tabc.SEGMENT_WAVES, max_runs - done, every - done % every)
            segments += 1
        return segments, done

    def check_campaign(phase, report, counts, specs, batch, ok, skipped, shapes):
        """Raise unless the campaign finished `ok` cells and skipped
        `skipped`, in `shapes` shape-cache entries, and its launches are each
        ok cell's pilot, waves and gated waves on the wave entry of its
        model's route, its host syncs one a segment; returns the cells."""
        statuses = [r.status for r in report.scenarios]
        if (statuses.count("ok"), statuses.count("skipped"), len(statuses),
                report.compiled_shapes) != (ok, skipped, ok + skipped, shapes):
            raise AssertionError(f"{phase}: statuses {statuses}, compiled_shapes "
                                 f"{report.compiled_shapes}")
        want, want_gated, cells = {}, {}, []
        for r in report.scenarios:
            if r.status != "ok":
                continue
            spec = specs[r.model]
            segments, enqueued = segments_of(r.runs)
            entry = abc_sim.entry_name(spec, "wave", abc_sim.regional_route(spec, batch)
                                       if spec.is_regional else None)
            # calibrate_tolerance's pilot: 8,192 samples in waves of at most `batch`
            per_wave = min(8192, batch)
            pilot = abc_sim.entry_name(spec, "wave", abc_sim.regional_route(
                spec, per_wave) if spec.is_regional else None)
            want[pilot] = want.get(pilot, 0) + max(1, 8192 // per_wave)
            want[entry] = want.get(entry, 0) + enqueued
            want_gated[entry] = want_gated.get(entry, 0) + enqueued - r.runs
            cells.append({"name": r.name, "waves": r.runs, "accepted": r.n_accepted,
                          "simulations": r.simulations, "tolerance": r.tolerance,
                          "gated_launches": enqueued - r.runs, "host_syncs": segments,
                          "entry": entry, "wall_s": r.wall_time_s})
        if (counts["entries"] != want
                or {k: v for k, v in counts["gated"].items() if v} != {
                    k: v for k, v in want_gated.items() if v}
                or counts["host_syncs"] != sum(c["host_syncs"] for c in cells)
                or (counts["plain_calls"], counts["host_prior_draws"]) != (0, 0)):
            raise AssertionError(f"{phase}: counts {counts}, want launches {want}, gated "
                                 f"{want_gated}, host syncs "
                                 f"{sum(c['host_syncs'] for c in cells)}")
        return cells

    def cell_rows(r, cap, width):
        """The accepted rows of a cell, from its newest checkpoint."""
        tree, meta, _ = load_checkpoint(r.checkpoint_dir, {
            "theta_buf": np.zeros((cap, width), np.float32),
            "dist_buf": np.zeros((cap,), np.float32)})
        return tree["theta_buf"][:meta["fill"]], tree["dist_buf"][:meta["fill"]]

    grid_specs = {m: get_model(m) for m in ("siard", "seiard", "sir")}
    camp_argv = (["--datasets", "italy", "new_zealand", "usa", "--models", "siard", "seiard",
                  "sir", "--batch", "100000", "--out", os.path.join(camp_root, "grid")]
                 + camp_common)
    report, camp_wall, counts = campaign_cli("campaign_path", camp_argv)
    path_launches["campaign_path"] = dict(counts["entries"])
    path_gated["campaign_path"] = dict(counts["gated"])
    cells = check_campaign("campaign_path", report, counts, grid_specs, 100_000, 6, 3, 2)
    if any("observes" not in r.detail for r in report.scenarios if r.status == "skipped"):
        raise AssertionError("campaign_path: a cell was skipped for another reason")
    resumed, resume_wall, resume_counts = campaign_cli("campaign_path resume", camp_argv)
    if ([r.status for r in resumed.scenarios]
            != [("resumed_complete" if r.status == "ok" else r.status)
                for r in report.scenarios]
            or resume_counts["entries"] or resume_counts["host_syncs"]
            or resume_counts["plain_calls"]):
        raise AssertionError(f"campaign_path: the resume gave "
                             f"{[r.status for r in resumed.scenarios]}, {resume_counts}")
    # each ok cell against its solo run, on the card, bitwise
    camp_cmp, solo_walls = [], {}
    for r in report.scenarios:
        if r.status != "ok":
            continue
        ds = data.get_dataset(r.dataset, num_days=49, model=r.model)
        solo_cfg = tabc.ABCConfig(batch_size=100_000, tolerance=1.0, target_accepted=100,
                                  strategy="outfeed", chunk_size=100_000, max_runs=10_000,
                                  num_days=49, model=r.model, wave_loop="device")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eps = tabc.calibrate_tolerance(ds, solo_cfg, seed=r.seed, quantile=1e-4, n_pilot=8192,
                                       device=dev)
        solo = tabc.run_abc(ds, dataclasses.replace(solo_cfg, tolerance=eps), seed=r.seed,
                            device=dev)
        torch.cuda.synchronize()
        solo_walls[r.name] = time.perf_counter() - t0
        if (eps, solo.runs, solo.simulations, len(solo)) != (
                r.tolerance, r.runs, r.simulations, r.n_accepted):
            raise AssertionError(f"campaign_path {r.name}: solo tolerance, runs, simulations, "
                                 f"accepted {eps, solo.runs, solo.simulations, len(solo)} vs "
                                 f"the cell's {r.tolerance, r.runs, r.simulations, r.n_accepted}")
        theta_c, dist_c = cell_rows(r, tabc.wave_capacity(solo_cfg), solo.theta.shape[1])
        camp_cmp += [bitwise(f"{r.name} theta, cell vs solo", theta_c, solo.theta),
                     bitwise(f"{r.name} distances, cell vs solo", dist_c, solo.distances),
                     {"case": f"{r.name} tolerance, runs, simulations", "bitwise_equal": True}]

    # the same grid again into a new directory, after the solo runs (every
    # series made and every library loaded): the campaign's own cost
    warm_argv = [a.replace(os.path.join(camp_root, "grid"), os.path.join(camp_root, "warm"))
                 for a in camp_argv]
    warm_report, warm_wall, warm_counts = campaign_cli("campaign_path warm", warm_argv)
    path_launches["campaign_path warm"] = dict(warm_counts["entries"])
    path_gated["campaign_path warm"] = dict(warm_counts["gated"])
    check_campaign("campaign_path warm", warm_report, warm_counts, grid_specs, 100_000, 6, 3, 2)

    # a lockdown sweep on Italy: four pinned schedules, one shape
    sweep = ("alpha0@20=0.4", "alpha0@20=0.8", "alpha0@30=0.4", "alpha0@30=0.8")
    sweep_argv = (["--datasets", "italy", "--models", "siard", "--batch", "100000",
                   "--interventions", *sweep, "--out", os.path.join(camp_root, "sweep")]
                  + camp_common)
    sweep_report, sweep_wall, sweep_counts = campaign_cli("campaign_path sweep", sweep_argv)
    path_launches["campaign_path sweep"] = dict(sweep_counts["entries"])
    path_gated["campaign_path sweep"] = dict(sweep_counts["gated"])
    sweep_cells = check_campaign("campaign_path sweep", sweep_report, sweep_counts,
                                 {"siard": siard}, 100_000, 4, 0, 1)
    for r, iv in zip(sweep_report.scenarios, sweep):
        want = float(iv.split("=")[1])
        if abs(r.posterior_mean["alpha0_w1"] - want) > 1e-5 * want:
            raise AssertionError(f"campaign_path sweep {r.name}: alpha0_w1 "
                                 f"{r.posterior_mean['alpha0_w1']}, pinned {want}")

    # two seeds of the 100-region metapopulation: one shape, the warp route
    mp100_argv = ["--datasets", "synthetic_small", "--models", "metapop_seir", "--regions",
                  "100", "--mobility", "ring:0.1", "--seeds", "0", "1", "--days", "49",
                  "--batch", "20000", "--auto-tolerance", "1e-3", "--accept", "20",
                  "--out", os.path.join(camp_root, "regions"), "--device", "cuda"]
    mp100_spec = regionalize(metapop, 100, "ring:0.1")
    if abc_sim.regional_route(mp100_spec, 20_000) != "warp":
        raise AssertionError("campaign_path: R=100 at 20,000 does not take the warp route")
    mp_report, mp_wall, mp_counts = campaign_cli("campaign_path regions", mp100_argv)
    path_launches["campaign_path regions"] = dict(mp_counts["entries"])
    path_gated["campaign_path regions"] = dict(mp_counts["gated"])
    mp_cells = check_campaign("campaign_path regions", mp_report, mp_counts,
                              {mp100_spec.name: mp100_spec}, 20_000, 2, 0, 1)
    if any(r.model != mp100_spec.name for r in mp_report.scenarios):
        raise AssertionError("campaign_path regions: a cell is not tagged by its spec's name")
    emit("campaign_path", argv=camp_argv, cells=cells, compiled_shapes=report.compiled_shapes,
         statuses={r.name: r.status for r in report.scenarios}, wall_s=camp_wall,
         launches_by_entry=counts["entries"], gated_by_entry=counts["gated"],
         host_syncs=counts["host_syncs"], warm_wall_s=warm_wall, resume_wall_s=resume_wall,
         resume_launches=sum(resume_counts["entries"].values()),
         solo_wall_s=solo_walls, solo_wall_sum_s=sum(solo_walls.values()),
         comparisons=camp_cmp, bitwise_comparisons=len(camp_cmp),
         sweep={"argv": sweep_argv, "cells": sweep_cells, "wall_s": sweep_wall,
                "compiled_shapes": sweep_report.compiled_shapes,
                "launches_by_entry": sweep_counts["entries"],
                "host_syncs": sweep_counts["host_syncs"],
                "alpha0_w1": [r.posterior_mean["alpha0_w1"] for r in sweep_report.scenarios]},
         regions={"argv": mp100_argv, "cells": mp_cells, "wall_s": mp_wall,
                  "compiled_shapes": mp_report.compiled_shapes,
                  "launches_by_entry": mp_counts["entries"],
                  "host_syncs": mp_counts["host_syncs"]},
         kind=name, nvidia_smi=smi)
    shutil.rmtree(camp_root, ignore_errors=True)

    # ---- forecast_path: the README's forecast through the port's CLI, the
    # forecast timed inside it, its bands against forecast_bands called
    # directly, then one forecast call profiled
    from repro_torch.core import serving as tserving

    fc_root = os.path.join(ROOT, "build", "forecast_path")
    shutil.rmtree(fc_root, ignore_errors=True)
    fc_out = os.path.join(fc_root, "bands.json")
    fc_argv = ["--dataset", "italy", "--days", "49", "--batch", "100000", "--chunk", "10000",
               "--intervention", FORECAST_INTERVENTION, "--auto-tolerance", "1e-3",
               "--accept", "100", "--forecast", "28", "--forecast-out", fc_out,
               "--device", "cuda"]
    fc_seconds, real_bands = [], tserving.forecast_bands

    def timed_bands(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bands = real_bands(*args, **kw)
        torch.cuda.synchronize()
        fc_seconds.append(time.perf_counter() - t0)
        return bands

    tserving.forecast_bands = timed_bands
    try:
        post_fc, fc_wall, entries, counts, _, _ = abc_path("forecast_path", fc_argv, siard,
                                                           FORECAST_INTERVENTION)
    finally:
        tserving.forecast_bands = real_bands
    path_launches["forecast_path"] = entries
    path_gated["forecast_path"] = dict(abc_sim.ENTRY_GATED)
    with open(fc_out) as f:
        fc_bands = strict_loads(f.read())
    fc_kw = dict(model="siard", fit_days=49, horizon=28, key=1, device=dev,
                 fit_schedule=abc_run.parse_intervention(FORECAST_INTERVENTION))

    def direct_bands():
        return tserving.forecast_bands(post_fc.theta, italy, **fc_kw)

    if len(fc_seconds) != 1 or fc_bands != direct_bands():
        raise AssertionError(f"forecast_path: {len(fc_seconds)} forecasts; the CLI's bands "
                             "differ from forecast_bands on its posterior")
    check_bands("forecast_path", fc_bands, 49, 77)
    if fc_bands["n_particles"] != len(post_fc) or fc_bands["schedule"] is None:
        raise AssertionError(f"forecast_path: {fc_bands['n_particles']} particles of "
                             f"{len(post_fc)}, schedule {fc_bands['schedule']}")
    fc_warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        direct_bands()
        fc_warm.append((time.perf_counter() - t0) * 1e3)
    fc_ms, fc_busy, fc_ops = profile_device_ms(direct_bands)
    fc_kernels = sum(c for k, c, _ in fc_ops if "Memcpy" not in k and "Memset" not in k)
    emit("forecast_path", argv=fc_argv, **counts, accepted=len(post_fc), waves=post_fc.runs,
         tolerance=post_fc.tolerance, wall_s=fc_wall, forecast_s=fc_seconds[0],
         forecast_share_of_wall=fc_seconds[0] / fc_wall, bands_equal_forecast_bands=True,
         n_particles=fc_bands["n_particles"], total_days=fc_bands["total_days"],
         forecast_warm_ms=fc_warm,
         forecast_profile={"wall_ms": fc_ms, "device_busy_ms": fc_busy,
                           "device_idle_share": 1 - fc_busy / fc_ms,
                           "device_ops": sum(c for _, c, _ in fc_ops),
                           "kernel_launches": fc_kernels,
                           "kernel_launches_per_day": fc_kernels / 77,
                           "top_device_ops": [{"name": k[:80], "count": c, "device_ms": ms}
                                              for k, c, ms in fc_ops[:8]]},
         kind=name, nvidia_smi=smi)
    shutil.rmtree(fc_root, ignore_errors=True)

    # ---- epi_serve: serve --epi and abc_serve, fits through the theta-in entries
    path_launches["epi_serve"], path_gated["epi_serve"] = compacting(
        "epi_serve", lambda: epi_serve_phase(dev, name, smi))

    # ---- npe_path: the amortized backend; its fits launch no abc_sim entry
    npe_counts = npe_phase(dev, name, smi)

    # ---- scaleout_path: torch.distributed (NCCL world of 1, gloo ranks),
    # the lockstep reference, the study, the sharded SMC round, device groups
    path_launches["scaleout_path"], path_gated["scaleout_path"] = compacting(
        "scaleout_path", lambda: scaleout_phase(dev, name, smi, post, post_smc, smc_cfg))

    # ---- tuning_path: the cost model, the autotuner, the audit of a segment's
    # syncs and the static analysis, on the card
    path_launches["tuning_path"], path_gated["tuning_path"] = compacting(
        "tuning_path", lambda: tuning_phase(dev, name, smi, italy_argv, post, post.tolerance))

    # ---- timing: both entries alone, in turns, beside the operation bound,
    # the issue floor at the SM clock read under load, and the plain version
    lowered = lower_summary(get_summary(None), "euclidean", ob_it)
    fconst, iconst = abc_sim.pack_consts(
        mean_scale=lowered.mean_scale, weights=lowered.weights.cpu().numpy(),
        flags=lowered.flags, seed=99, **it_kw)
    obs = lowered.obs_summary.contiguous()
    ops_sd = abc_sim.ops_per_sample_day(siard, lowered)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    timing = []
    def flat(spec, entry, batch, block=None, obs=obs, fconst=fconst, iconst=iconst):
        return abc_sim.launch(spec, entry, batch, obs=obs, fconst=fconst, iconst=iconst,
                              block=block)

    with SmClock() as clock:
        load = flat(siard, "wave", 1_000_000)
        clock.start_counting(lambda: load(99, 13, prior.lows, prior.highs))
        for batch, kernel_iters, plain_iters in ((100_000, 50, 2), (1_000_000, 20, 1)):
            th = th_it if batch == 100_000 else prior.sample(13, batch, dev)
            soa = abc_sim.theta_to_soa(th)
            theta_in = flat(siard, "distance", batch)
            waves = {b: flat(siard, "wave", batch, b) for b in (64, 128, 256)}

            def run_theta_in():
                return theta_in(99, soa)

            def run_wave(block=abc_sim.DEFAULT_BLOCK):
                return waves[block](99, 12, prior.lows, prior.highs)

            turns = {"theta_in": [], "wave": []}
            for entry in ("theta_in", "wave", "wave", "theta_in"):
                fn = run_theta_in if entry == "theta_in" else run_wave
                turns[entry].append(cuda_ms(fn, kernel_iters))
            blocks = {b: [] for b in (64, 128, 256)}
            for b in (64, 128, 256, 256, 128, 64):
                blocks[b].append(cuda_ms(lambda: run_wave(b), kernel_iters))
            plain_ms = cuda_ms(lambda: ref.abc_sim_distance_ref(
                prior.sample(12, batch, dev), 99, ob_it, model=siard, **it_kw),
                plain_iters, warmup=1)
            ms_in, ms_wave = (float(np.mean(turns[e])) for e in ("theta_in", "wave"))
            n_ops = ops_sd * batch * 49
            wave_ops = abc_sim.wave_ops(siard, lowered, batch)
            n_bytes = abc_sim.bytes_moved(siard, batch, 49)
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms, wave_ops_ms = n_ops / F32_OPS_PER_S * 1e3, wave_ops / F32_OPS_PER_S * 1e3
            mhz = clock.median()
            floors = {e: sass.issue_floor_ms(census[e], batch, 49, n_sm, mhz)
                      if census and mhz else None for e in ("wave", "theta_in")}
            timing.append({
                "batch": batch, "days": 49, "ms_wave": ms_wave, "ms_theta_in": ms_in,
                "turns_ms": turns, "block_ms": {str(b): float(np.mean(v))
                                                for b, v in blocks.items()},
                "plain_ms": plain_ms, "ops": n_ops, "wave_ops": wave_ops, "bytes": n_bytes,
                "ops_per_sample_day": ops_sd,
                "bound_ms": max(ops_ms, bytes_ms), "wave_bound_ms": max(wave_ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound_theta_in": max(ops_ms, bytes_ms) / ms_in,
                "share_of_bound_wave": max(wave_ops_ms, bytes_ms) / ms_wave,
                "issue_floor": floors,
                "share_of_issue_floor": {
                    e: floors[e]["floor_ms"] / m if floors[e] else None
                    for e, m in (("wave", ms_wave), ("theta_in", ms_in))},
                "sample_days_per_s_wave": batch * 49 / (ms_wave * 1e-3),
                "iters": kernel_iters, "plain_iters": plain_iters})

        # every model's entries, and SIARD under a one-window inferred
        # schedule, in turns with SIARD's (forward, then backward)
        cases = {}
        for case in ABC_MODELS + ("siard_scheduled",):
            m = case.split("_")[0]
            spec = models[m]
            sched = abc_run.parse_intervention(INTERVENTION) if case != m else None
            ds, kw = series[m]
            low = lower_summary(get_summary(None), "euclidean",
                                torch.as_tensor(ds.observed, device=dev))
            fc, ic = abc_sim.pack_consts(
                mean_scale=low.mean_scale, weights=low.weights.cpu().numpy(),
                flags=low.flags, seed=99, model=spec, schedule=sched, **kw)
            cases[case] = dict(spec=spec, sched=sched, box=schedule_prior(spec, sched),
                               lowered=low, fconst=fc, iconst=ic,
                               obs=low.obs_summary.contiguous())
        model_cells = []
        for batch, kernel_iters in ((100_000, 50), (1_000_000, 20)):
            turns = {c: {"wave": [], "theta_in": []} for c in cases}
            soas = {c: abc_sim.theta_to_soa(x["box"].sample(14, batch, dev))
                    for c, x in cases.items()}
            lns = {c: {e: flat(x["spec"], e, batch, obs=x["obs"], fconst=x["fconst"],
                               iconst=x["iconst"]) for e in ("wave", "distance")}
                   for c, x in cases.items()}
            order = list(cases) + list(cases)[::-1]
            for c in order:
                x = cases[c]

                def run_wave(x=x, ln=lns[c]["wave"]):
                    return ln(99, 12, x["box"].lows, x["box"].highs)

                def run_theta_in(ln=lns[c]["distance"], soa=soas[c]):
                    return ln(99, soa)

                turns[c]["wave"].append(cuda_ms(run_wave, kernel_iters))
                turns[c]["theta_in"].append(cuda_ms(run_theta_in, kernel_iters))
            mhz = clock.median()
            for c, x in cases.items():
                spec, low = x["spec"], x["lowered"]
                ms_w, ms_i = (float(np.mean(turns[c][e])) for e in ("wave", "theta_in"))
                w_ops = abc_sim.wave_ops(spec, low, batch, x["sched"])
                n_bytes = abc_sim.bytes_moved(spec, batch, 49, x["box"].dim)
                bound = max(w_ops / F32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
                cen = model_census[spec.name]
                floor = sass.issue_floor_ms(cen, batch, 49, n_sm, mhz) if cen and mhz else None
                model_cells.append({
                    "case": c, "batch": batch, "days": 49, "ms_wave": ms_w,
                    "ms_theta_in": ms_i, "turns_ms": turns[c],
                    "ratio_to_siard_wave": ms_w / float(np.mean(turns["siard"]["wave"])),
                    "wave_ops": w_ops, "bytes": n_bytes, "wave_bound_ms": bound,
                    "bound_by": "operations" if w_ops / F32_OPS_PER_S >=
                    n_bytes / HBM_BYTES_PER_S else "bytes",
                    "census_per_day": cen["per_day"]["total"] if cen else None,
                    "issue_floor_ms": floor["floor_ms"] if floor else None,
                    "share_of_issue_floor": floor["floor_ms"] / ms_w if floor else None,
                    "iters": kernel_iters})

        # the region axis: metapop_seir's regional wave entry on both routes
        # in turns with SIARD's flat wave entry (forward, then back)
        regional_cells = []
        siard_x = cases["siard"]
        for R, batch, plain in ((4, 20_000, False), (10, 20_000, False), (32, 20_000, False),
                                (100, 20_000, True), (4, 100_000, True), (100, 100_000, True)):
            spec = metapop if R == 4 else regionalize(metapop, R, "ring:0.1")
            ds = data.get_dataset("synthetic_small", num_days=49, model=spec)
            kw = dict(population=ds.population, a0=ds.a0, r0=ds.r0, d0=ds.d0)
            ob = torch.as_tensor(ds.observed, device=dev)
            sim = ops.make_abc_sim(ob, model=spec, **kw)
            box = spec.prior()
            low = lower_summary(get_summary(None), "euclidean", ob, n_regions=R)
            lns = {"siard": flat(siard, "wave", batch, obs=siard_x["obs"],
                                 fconst=siard_x["fconst"], iconst=siard_x["iconst"]),
                   **{r: sim.launch("wave", batch, r) for r in ("thread", "warp")}}

            def run(which, box=box, lns=lns):
                if which == "siard":
                    box = siard_x["box"]
                return lns[which](99, 12, box.lows, box.highs)

            turns = {"siard": [], "thread": [], "warp": []}
            for which in ("siard", "thread", "warp", "warp", "thread", "siard"):
                once = cuda_ms(lambda: run(which), 1, warmup=1)
                iters = max(1, min(50, int(250 / max(once, 1e-3))))
                turns[which].append(cuda_ms(lambda: run(which), iters, warmup=0))
            plain_ms = cuda_ms(lambda: ref.abc_sim_distance_ref(
                box.sample(12, batch, dev), 99, ob, model=spec, **kw), 1, warmup=0) \
                if plain else None
            ms = {r: float(np.mean(turns[r])) for r in turns}
            route = abc_sim.regional_route(spec, batch)
            w_ops = abc_sim.wave_ops(spec, low, batch)
            n_bytes = abc_sim.bytes_moved(spec, batch, 49)
            ops_ms, bytes_ms = w_ops / F32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
            bound = max(ops_ms, bytes_ms)
            mhz = clock.median()
            floors = {
                "thread": sass.regional_issue_floor_ms(mp_census, R, R, batch, 49, n_sm, mhz)
                if mp_census and mhz else None,
                "warp": sass.regional_warp_issue_floor_ms(
                    mp_warp_census, R, spec.total_observed, batch, 49, n_sm, mhz)
                if mp_warp_census and mhz else None}
            regional_cells.append({
                "model": spec.name, "regions": R, "batch": batch, "days": 49,
                "route_chosen": route, "ms_wave": ms[route],
                "ms": {r: ms[r] for r in ("thread", "warp")}, "turns_ms": turns,
                "siard_wave_ms": ms["siard"], "ratio_to_siard_wave": ms[route] / ms["siard"],
                "plain_ms": plain_ms,
                "ops_per_sample_day": abc_sim.ops_per_sample_day(spec, low),
                "wave_ops": w_ops, "bytes": n_bytes, "bound_ms": bound,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": {r: bound / ms[r] for r in ("thread", "warp")},
                "issue_floor_ms": {r: f["floor_ms"] if f else None for r, f in floors.items()},
                "share_of_issue_floor": {r: f["floor_ms"] / ms[r] if f else None
                                         for r, f in floors.items()},
                "census_per_day": {
                    "thread": sass.regional_per_day(mp_census, R, R)["total"]
                    if mp_census else None,
                    "warp": sass.regional_warp_per_day(mp_warp_census, R,
                                                       spec.total_observed)["total"]
                    if mp_warp_census else None},
                "issue_floor": floors,
                "sample_days_per_s": batch * 49 / (ms[route] * 1e-3)})
    emit("timing", kind=name, nvidia_smi=smi, peak_ops_per_s=F32_OPS_PER_S,
         peak_bytes_per_s=HBM_BYTES_PER_S, library_ms=None, sms=n_sm,
         sm_clock_mhz=clock.summary(), default_block=abc_sim.DEFAULT_BLOCK, cells=timing,
         model_cells=model_cells, intervention=INTERVENTION, regional_cells=regional_cells)

    # ---- li2020_path: Li et al. 2020's 375 cities on the tile route
    tile_line = li2020_phase(dev, name, smi, info)

    main_cell = timing[0]
    # launches of each entry on the ABC paths, and its time at 100k x 49
    launched = {}
    for counts in path_launches.values():
        for entry, n in counts.items():
            launched[entry] = launched.get(entry, 0) + n
    gated_on_paths = {}
    for counts in path_gated.values():
        for entry, n in counts.items():
            gated_on_paths[entry] = gated_on_paths.get(entry, 0) + n
    if not (launched.get("abc_sim_distance_siard") and launched.get("abc_sim_distance_sir")):
        raise AssertionError(f"kernels: smc_path or epi_serve launched no theta-in entry: "
                             f"{launched}")
    at_100k = {c["case"]: c for c in model_cells if c["batch"] == 100_000}
    entries = []
    for m in ABC_MODELS:
        for entry, key in (("wave", "ms_wave"), ("distance", "ms_theta_in")):
            symbol = f"abc_sim_{entry}_{m}"
            entries.append({"entry": symbol, "source": "src/repro_torch/kernels/csrc/"
                            f"{abc_sim.library(m)}.cu", "launches": launched.get(symbol, 0),
                            "gated_launches": gated_on_paths.get(symbol, 0),
                            "ms": main_cell[key] if m == "siard" else at_100k[m][key]})
    if not (launched.get("abc_sim_wave_siard") and launched.get("abc_sim_wave_seiard")
            and launched.get(abc_sim.entry_name(metapop, "wave", "thread"))
            and launched.get(abc_sim.entry_name(metapop, "wave", "warp"))):
        raise AssertionError(f"kernels: a path's wave entry was not launched: {launched}")
    abc_line = {
        "name": "abc_sim_distance", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": sum(n for e, n in launched.items() if not e.startswith("abc_sim_regional_")),
        "gated_launches": sum(n for e, n in gated_on_paths.items()
                              if not e.startswith("abc_sim_regional_")),
        "entries": entries,
        "scheduled_siard_wave_ms": at_100k["siard_scheduled"]["ms_wave"],
        "max_abs_err": max_abs_err,
        "ms": main_cell["ms_wave"], "plain_ms": main_cell["plain_ms"],
        "bound_ms": main_cell["wave_bound_ms"], "bound_by": main_cell["bound_by"],
        "issue_floor_ms": (main_cell["issue_floor"]["wave"] or {}).get("floor_ms"),
        "library_ms": None,
        "npe_path": npe_counts,
    }
    cell = {(c["regions"], c["batch"]): c for c in regional_cells}
    r4, r100 = cell[(4, 100_000)], cell[(100, 100_000)]
    regional_entries = [
        {"entry": abc_sim.entry_name(metapop, e, r),
         "source": f"src/repro_torch/kernels/csrc/{abc_sim.library(metapop)}.cu",
         "kernel": REGIONAL_SOURCE if r == "thread" else REGIONAL_WARP_SOURCE,
         "launches": launched.get(abc_sim.entry_name(metapop, e, r), 0),
         "gated_launches": gated_on_paths.get(abc_sim.entry_name(metapop, e, r), 0)}
        for r in ("thread", "warp") for e in ("wave", "distance")]

    def route_launches(route):
        return sum(x["launches"] for x in regional_entries if x["kernel"] == (
            REGIONAL_SOURCE if route == "thread" else REGIONAL_WARP_SOURCE))

    r100_times = {str(b): {
        "ms": cell[(100, b)]["ms"], "plain_ms": cell[(100, b)]["plain_ms"],
        "bound_ms": cell[(100, b)]["bound_ms"], "bound_by": cell[(100, b)]["bound_by"],
        "issue_floor_ms": cell[(100, b)]["issue_floor_ms"]} for b in (20_000, 100_000)}
    regional_line = {
        "name": "abc_sim_regional", "route": "cuda", "source": REGIONAL_SOURCE,
        "replaces": REGIONAL_TPU_KERNEL, "launches": route_launches("thread"),
        "entries": regional_entries, "max_abs_err": regional_err,
        "ms": r4["ms"]["thread"], "plain_ms": r4["plain_ms"], "bound_ms": r4["bound_ms"],
        "bound_by": r4["bound_by"], "issue_floor_ms": r4["issue_floor_ms"]["thread"],
        "library_ms": None, "r100": r100_times,
        "route_by_regions": {b: {R: abc_sim.regional_route(regionalize(metapop, R, "ring:0.1"), b)
                                 for R in (4, 10, 12, 16, 24, 32, 100, 128)}
                             for b in (20_000, 50_000, 100_000)},
    }
    warp_line = {
        "name": "abc_sim_regional_warp", "route": "cuda", "source": REGIONAL_WARP_SOURCE,
        "replaces": REGIONAL_TPU_KERNEL, "launches": route_launches("warp"),
        "max_abs_err": warp_err, "ms": r100["ms"]["warp"], "plain_ms": r100["plain_ms"],
        "bound_ms": r100["bound_ms"], "bound_by": r100["bound_by"],
        "issue_floor_ms": r100["issue_floor_ms"]["warp"], "library_ms": None,
        "shape": {"regions": 100, "batch": 100_000, "days": 49},
    }

    if not (path_compactions.get("main_path") and path_compactions.get("smc_path")):
        raise AssertionError(f"kernels: a device loop took no compaction kernel: "
                             f"{path_compactions}")
    compact_line = {
        "name": "abc_compact", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/abc_compact.cu",
        "replaces": None, "plain": "src/repro_torch/core/abc.py compact_plain",
        "launches": sum(path_compactions.values()), "launches_by_path": path_compactions,
        "us": {case: c["kernel_device_us"] for case, c in compaction_100k.items()},
        "plain_us": {case: c["plain_device_us"] for case, c in compaction_100k.items()},
        "bound_us": {case: c["bound_us"] for case, c in compaction_100k.items()},
        "shape": {"batch": 100_000, "params": 8}, "library_us": None,
    }

    # ---- flash, lm_prefill, lm_profile, lm_serve, lm_timing
    flash_lines = lm_phases(dev, name, smi, flash_phase(dev), cuda_core_fn)
    # ---- family_prefill, family_profile, family_flash_timing, family_serve;
    # then moe_layer, moe_prefill, moe_profile, moe_serve: the bf16 flash
    # kernel's launches on each prefill join lm_prefill's
    family_launches, zamba_cell = family_phases(dev, name, smi)
    by_path = {"lm_prefill gemma-2b": flash_lines[0]["launches"], **family_launches,
               **moe_phases(dev, name, smi)}
    # ---- encdec_prefill, encdec_profile, encdec_flash_timing, encdec_decode;
    # then train_path
    by_path["encdec_prefill whisper-large-v3"], whisper_cells = encdec_phases(dev, name, smi)
    train_phases(dev, name, smi)
    # ---- mesh_path: the N-rank steps; its 2 ranks' flash launches join
    by_path.update(mesh_phases(dev, name, smi))
    flash_lines[0].update(launches=sum(by_path.values()), launches_by_path=by_path,
                          zamba2_shape=zamba_cell, whisper_shapes=whisper_cells)

    # the census a sample-day, read in `build`, held last so that a drift
    # still leaves every other phase measured
    if census_per_day is not None and census_per_day != CENSUS_PER_DAY:
        raise AssertionError(f"census: instructions a sample-day {census_per_day}, want "
                             f"{CENSUS_PER_DAY}")
    emit("total", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [abc_line, regional_line, warp_line, tile_line, compact_line,
                                  *flash_lines]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
