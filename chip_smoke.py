"""Smoke run of the torch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths on the card -- the online-Cori paged serving loop
(decode through the paged kernels, prefill through the flash kernel) and
the paper's offline Cori pipeline -- and checks every kernel they run
against the kernel's plain PyTorch version (the five ports of the
reference's Pallas kernels and the port's own routed-expert kernel and
mLSTM, sLSTM and RG-LRU recurrence kernels).
Phases (each prints its
own lines and its seconds; any failure raises and the script exits
non-zero):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: ``nvcc`` compiles the nine kernels for sm_90a from
     ``src/repro_torch/kernels/csrc``, one process per source, all at once
     (each -Xptxas -v report is printed);
  3. kernel vs plain version on the card: the main-path shape, olmoe's
     decode shape (16/16 heads of 128: a GQA group of one), gemma3's
     decode shape (16/8 heads, D 256, window 1024), recurrentgemma's (10/1
     heads, D 256, window 2048, rows past the window, a row without a
     request and a state page in the tables' last column, past every
     length), musicgen's (32/32 heads of 64), nemotron's (96/8 heads of
     192: six head groups a KV head), stablelm's (32/8 heads of 160) and
     paligemma's (8/1 heads of 256: four head groups of two, every row's
     first 16 columns the same shared prefix pages, whose mass must be
     positive in every live row), the edges of the kernel's split over
     pages
     (``SPLIT_EDGES``) and a GQA / window / softcap grid, float32 and
     bfloat16, with stated tolerances, each active row's mass summing to
     1, and two calls on the same inputs bit-identical;
  4. full-width qwen3-14b (all 40 layers, float32 weights from a seeded
     init) served by the macro-step ``ContinuousBatcher`` over
     ``SharedPagedPools`` + ``TieringManager`` + ``OnlineTuner``: 8
     requests until drained, first by the graph route (one captured decode
     step replayed ``n_steps`` times a macro, one host sync a macro: the
     main path), then by the eager route (the same step body from Python)
     over fresh pools.  The kernel's launch count must equal 40 x the
     steps the device ran (every replayed step; on the eager route those
     must be the decode steps), the two routes' streams (greedy and
     sampled), migrations, hits, misses and tuner history must be
     identical, and each route prints its tokens/s, macro wall p50,
     device vs decode steps and one profiled macro (ms/step, busy and
     idle share);
  5. parity on the card: on a reduced GQA config, the batcher's greedy
     streams (macro and per-token) equal ``generate``'s (dense attention,
     no kernel);
  6. paged kernel timing at the eight served decode shapes (qwen3-14b's,
     gemma3-12b's with window 1024, recurrentgemma-2b's with 10/1
     heads and window 2048, olmoe-1b-7b's with 16/16 heads,
     musicgen-large's with 32/32 heads of 64, nemotron-4-340b's with
     96/8 heads of 192, paligemma-3b's with 8/1 heads of 256 and 16
     shared columns, read once in its bound, and stablelm-12b's with 32/8
     heads of 160), split as the wrapper
     plans it (head groups
     counted): per call (CUDA events) and on
     the device alone (profiler kernel durations), L2 flushed before each
     call, beside its plain version, one SDPA call (the yardstick, which
     the kernel must beat) and the bandwidth bound;
  7. the offline path's kernels vs their plain versions on the card:
     ``page_hist`` over an alpha/threshold grid with -1 padding, odd
     footprints and out-of-range ids (bit-equal); ``bin_trace`` of all
     nine full-size traces (array-equal to numpy's bincount); ``sim_scan``
     bit-equal to ``sim_scan_plain`` on full-size backprop's exhaustive
     candidate stack (its largest group and its longest candidate) and on
     a tie-heavy 20-page toy, both schedulers (and the toy against the
     numpy oracle ``simulate_reference``);
  8. the paper's pipeline at full size: ``study`` and
     ``baseline_trials_all`` for backprop, lud and kmeans under both
     schedulers, held to the bars of tests/test_claims.py, with the
     kernels' launch counts (one ``page_hist`` per study, one ``sim_scan``
     per ``simulate`` and per ``sweep_launches`` entry of each ``sweep``:
     one launch a sweep at these sizes);
  9. timing of the offline kernels at the main-path shapes: ``page_hist``
     at backprop's ``bin_trace`` shape, a call and on the device, beside
     its plain version,
     ``torch.bincount`` and its bound; ``sim_scan`` over backprop's whole
     exhaustive sweep (reactive) as ``sweep`` launches it (one
     ``sim_scan_rows`` launch of 75 candidates), beside the per-chunk loop
     of ``sim_scan`` launches (11), the longest candidate alone (us per
     serial period), the plain sweep, the bytes bound and the serial
     path's length in periods; the one-launch results bit-equal to the
     plain sweep's and the loop's;
 10. the MLA kernel ``paged_attention_mla`` vs its plain version on the
     card: the main-path shape (128 heads, kv_lora 512, rope 64), a grid
     over 16 and 128 heads, ragged -1 rows and a length-0 row, and the
     edges of the kernel's split over pages (``MLA_SPLIT_EDGES``), float32
     and bfloat16, with stated tolerances (bfloat16 also each output row
     within ``BF16_ROW_TOL`` of its norm), each active row's mass summing
     to 1 and a second call on the same inputs bit-identical;
 11. full-width deepseek-v3-671b (MLA + MoE; depth cut from 61 layers to
     2, one dense-MLP and one MoE layer, float32 weights from a seeded
     init) served by the macro-step batcher with phase 4's request mix,
     after phase 4's qwen3-14b is freed, by the graph route and then the
     eager route, as phase 4 (the routed MoE groups its tokens by expert
     on the device, so its step is captured).  The MLA kernel's launch
     count must equal 2 x the device steps and the routed-expert kernel's
     1 x the device steps; one decode macro a route is profiled as in
     phase 4;
 12. parity on the card: on reduced deepseek-v3-671b and olmoe-1b-7b, the
     batcher's greedy streams (macro and per-token) equal ``generate``'s
     (dense decode, no paged kernel);
 13. the MLA kernel's timing at the main-path shape, per call (CUDA
     events) and on the device (profiler), beside its plain version, one
     SDPA call over the gathered rows (the yardstick, which the kernel must
     beat a call) and its bound: operations as 3xTF32 at 495 TFLOP/s, with
     the ``mma.sync`` floor and the 67 TFLOP/s CUDA-core figure beside it;
 14. the flash kernel ``flash_attention`` vs its plain version on the
     card: float32 and bfloat16, GQA 4/4, 4/2, 8/1, 16/8 and 40/8, every
     head dim it takes (``HEAD_DIMS``: 16 and the multiples of 32 up to
     256), causal, window 64, window 1024 and non-causal, S = T in {1, 37,
     256, 2048}, plus the shapes phase 15 gives it (B = 4 and 2, S = T =
     2048, 16/8 heads, D 256, causal and window 1024), phase 24 gives it
     (B = 4, 2 and 1, S = T = 512, 32/32 heads, D 64, causal), phase 51
     gives it (the same B and S, 32/8 heads of 160) and phase 25 gives it
     (96/8 heads of 192) in float32 and bfloat16, with stated tolerances
     (bfloat16 also each output row within ``BF16_ROW_TOL`` of its norm);
 15. full-width, full-depth gemma3-12b (48 layers, 40 of them sliding
     window 1024; float32 weights from a seeded init) with
     ``attention_impl="pallas"``, served by the macro-step batcher after
     deepseek is freed: 6 requests with prompts of 1040-1600 tokens,
     longer than the window, by the graph route and then by the eager
     route, as phase 4 (both serve the whole mix).  The flash kernel's
     launches must equal 48 x admissions and the paged kernel's 48 x the
     device steps, and the Cori loop must act: hits counted and the tuner
     out of its profile window (a page counts as accessed while inside
     the window, ``GEMMA_ACCESS_THRESHOLD``);
 16. parity on the card: on reduced gemma3-12b (window 8) the batcher's
     greedy streams equal ``generate``'s under both ``attention_impl``
     settings, and the settings agree; at full width, phase 15's first
     admission through ``prefill_batched`` under both settings gives the
     same argmax in every row and last-position logits within
     ``GEMMA_LOGIT_TOL``;
 17. the flash kernel's timing at the main-path shape (B=4, S=T=2048,
     16/8 heads, D=256), float32 and bfloat16, with window 1024 and causal,
     per call and on the device, beside its plain version (held to it
     first at 1e-4 in float32, 2e-2 and ``BF16_ROW_TOL`` in bfloat16), one
     SDPA call and the bound of the route the kernel takes: operations at
     3 x TF32's 495 TFLOP/s in float32 (3xTF32; the 67 TFLOP/s CUDA-core
     figure printed beside it), at 989 TFLOP/s in bfloat16; in float32
     at musicgen-large's prefill shape (B=4, S=T=512, 32/32 heads, D=64,
     causal); and in float32 and bfloat16 at stablelm-12b's (32/8 heads of
     160) and nemotron-4-340b's (96/8 heads of 192) prefill shapes (B=4,
     S=T=512, causal).  The float32 kernel must beat SDPA a call at the
     main-path shape (the yardstick); elsewhere the two are recorded side
     by side;
 18. full-width, full-depth recurrentgemma-2b (26 layers: 18 RG-LRU, 8
     local attention of window 2048 with 10 query heads over 1 KV head of
     256; float32 weights from a seeded init, every conv tap drawn from
     N(0, 0.5) since the reference's zero taps make each cell an
     identity), served after gemma3-12b is freed: 6 requests with prompts
     of 2100-2600 tokens, longer than the window, one prefill per request
     (a recurrent cell cannot take a padded batch), by the graph route
     and then the eager route, as phase 4.  The paged kernel's launches
     must equal 8 x the device steps, the RG-LRU kernel's
     (``rglru_scan``) 18 x (device steps + prefills), and the Cori loop
     must act (hits counted, the tuner out of its profile window; a page
     counts as accessed while inside the window,
     ``RGEMMA_ACCESS_THRESHOLD``).  Prints one 2600-token prefill timed
     cell by cell (RG-LRU cells and the rest), and again with the RG-LRU
     recurrence through its plain version (the before);
 19. full-width, full-depth xlstm-1.3b (48 layers: 42 mLSTM, 6 sLSTM, no
     MLP sublayer; conv taps as phase 18): 8 requests with prompts of
     64-256 tokens over pools of 8 logical / 6 HBM pages, each page one
     request's packed cell states (~707 MB), by both routes.  No paged
     kernel runs.  Under the admission gate a pool of state pages alone
     never runs out of HBM slots, so every few steps the oldest active
     request's page is demoted (what a preemption does) and the next
     macro fetches it back from the host tier: the fetched bytes must
     equal those resident before, and both routes must agree.  Every
     mLSTM layer runs ``mlstm_scan`` once a prefill (from the zero state:
     the pre-pass and the chunkwise kernel) and once a device step (in
     place on the state pages: the strip kernel): its kernel launches
     must equal 42 x (device steps + 2 x prefills) on each route, and the
     sLSTM kernel's (``slstm_scan``) 6 x (device steps + prefills).
     Prints the admissions' wall a request and one 256-token prefill
     timed cell by cell (mLSTM, sLSTM, the rest: the sLSTM's share), one
     mLSTM cell of it profiled alone (the kernel, the matrix products,
     the rest on the device, beside its wall), and the split again with
     the sLSTM recurrence through its plain version (the before);
 20. parity on the card: on reduced recurrentgemma-2b and xlstm-1.3b with
     non-zero conv taps, the batcher's greedy streams (macro and
     per-token) equal ``generate``'s (dense decode; every recurrence
     through its kernel on both sides);
 21. the routed-expert kernel ``routed_experts`` vs its plain version on
     the card, after xlstm-1.3b is freed: olmoe-1b-7b's and
     deepseek-v3-671b's decode widths (all 64 / 256 experts), 4 tokens
     and 1, all four tokens on the same experts, and tied router
     probabilities (the route's stable sort must pick the experts
     ``lax.top_k`` would: a stable descending argsort of the same
     probabilities), each within ``ROUTED_TOL`` of the largest output
     magnitude and a second call bit-identical;
 22. the routed-expert kernel's timing at both decode shapes (4 tokens,
     top-8): per call (CUDA events) and on the device (profiler), beside
     its plain version, the number of distinct experts, its bound (the
     distinct experts' bytes plus the tokens' in and out, at 3.35 TB/s)
     and the yardstick, the expert loop a sequence takes
     (``moe._expert_loop``: a host read of the counts, then
     ``torch.matmul``s over the chosen experts) on the same inputs;
 23. full-width, full-depth olmoe-1b-7b (16 layers, every one GQA 16/16
     heads of 128 + 64 experts top-8; float32 weights from a seeded init,
     27.7 GB) served with phase 4's pools and request mix by the graph
     route and then the eager route, as phase 4.  The paged kernel's
     launches must equal 16 x the device steps, and the routed-expert
     kernel's too;
 24. full-width, full-depth musicgen-large (48 layers, each
     self-attention 32/32 heads of 64, cross-attention to a conditioning
     of 64 positions, a GELU MLP; float32 weights from a seeded init,
     12.9 GB; the conditioning [1, 64, 2048] drawn N(0, 1) from the seed:
     the EnCodec and T5 encoders are stubs) with
     ``attention_impl="pallas"``, served with phase 4's pools and request
     mix (ids below its vocabulary of 2048) by the graph route and then
     the eager route, as phase 4.  The paged kernel's launches must equal
     48 x the device steps and the flash kernel's 48 x the admissions;
     the cross-attention K/V projections, which every decode step
     recomputes from the conditioning as the reference does, are timed
     alone on the device beside the profiled step;
 25. nemotron-4-340b at full width (d_model 18432, 96/8 heads of 192, a
     squared-ReLU MLP of 73728, vocabulary 256000, untied), depth cut
     from 96 layers to ``NEMOTRON_LAYERS`` (16.35 B float32 parameters,
     65.4 GB, on an otherwise empty card) under
     ``attention_impl="pallas"``, served with phase 4's pools and mix by
     both routes; the paged kernel's launches must equal the layers x the
     device steps and the flash kernel's the layers x the admissions (its
     GQA group of 12 does not divide the kernel's 128 rows: one head a
     block);
 26. parity on the card: on reduced musicgen-large (its conditioning
     given to both, ``attention_impl="pallas"``) and nemotron-4-340b, the
     batcher's greedy streams (macro and per-token) equal ``generate``'s
     (dense decode, no paged kernel);
 27. full-width, full-depth paligemma-3b (18 layers, 8/1 heads of 256, a
     SwiGLU MLP of 16384, a tied vocabulary of 257216; float32 weights
     from a seeded init, 10.0 GB; its 256-position image prefix [1, 256,
     2048] drawn N(0, 1) from the seed: the SigLIP tower is a stub),
     served after nemotron is freed over pools of 512 logical / 128 HBM
     pages with phase 4's mix, by the graph route and then the eager
     route, as phase 4.  The prefix is prefilled once into 16 shared
     read-only pages that every row's table maps; the paged kernel's
     launches must equal 18 x the device steps, no flash launch, the
     Cori loop must act (``PALIGEMMA_ACCESS_THRESHOLD``), and the
     demand fetches of prefix pages are counted;
 28. the single-stream tiered path (``examples/serve_tiered.py``'s loop)
     at full width on phase 27's parameters: ``monitored_generate`` (4
     prompts of 16 tokens after the prefix, 48 steps, pages of 16, masses
     held to probability-like bounds), ``cori_tune_period`` (DR, period,
     trials, the modeled time at fixed periods 1, 4 and 16), physical
     passes over ``PagedPools`` made of the monitor layer's own k/v (row
     0's timeline cut into pages) at Cori's period and under a drifting
     ``workload.attention_sink`` pattern that must move pages (accounting
     equal to the symbolic ``replay``, every resident HBM page bit-equal
     to its host page), the paged kernel over the HBM tier through
     ``slot_of`` against its plain version over the host pages through
     the logical ids, and the online tuner in the loop through
     ``on_mass`` (the same tokens and masses);
 29. parity on the card: on reduced paligemma-3b with its prefix, the
     batcher's greedy streams (macro and per-token) equal ``generate``'s,
     and ``monitored_generate``'s tokens equal ``generate``'s;
 30. (run right after phase 4, on its parameters) the dense batcher:
     phase 4's mix through ``ContinuousBatcher(paged=False,
     mirror_pages=True)`` with phase 4's tiering and tuner over a legacy
     single-layer pool of 256 logical / 128 HBM pages
     (``SharedPagedPools.create(..., page_size=16, kv_heads=8,
     head_dim=128)``), eagerly; its greedy streams equal phase 4's graph
     route's and its sampled streams too, or part from them only where
     the draw lies on a boundary (``_compare_streams``); the run drains
     and every page returns; at four points ``paged_context`` of every
     in-flight request on a seeded q [1, 40, 128] is within 1e-5 of the
     plain kernel over the host pages through the request's ids, each
     probe one kernel launch, the launches of the run = the probes; then
     the same probes at three points of a short fully-paged batcher
     (graph route, the mix's first 4 requests) over the layered host
     leaf, its launches = 40 x device steps + probes.  Prints tokens/s,
     step wall p50, the monitor's share of the steps, peak memory, the
     tiering and the tuner history, and kernel 1's time a probe beside
     its plain version, SDPA and its bound;
 31. (host only: no kernel, no device) the model-free ``TrafficScheduler``
     at the traffic benchmark's full size (``benchmarks/traffic.py``
     ``run``: SHORT + LONG, 2 x 700 steps, online and the fixed ladder
     1-200; ``hostile``: four phases of 600 steps, online and its fixed
     ladder), held to the benchmark's bars: online steady <= 1.05 x the
     best fixed, peak cache pages >= 25% below the dense provisioning,
     each hostile phase's regret <= 1.15;
 32. (right after phase 30, on phase 4's parameters) phase 4's mix
     through the pipelined loop (``pipeline=True``, graph route): streams
     held to phase 4's (``_compare_streams``), one decision a completed
     macro, a quiet boundary's tables reused, tokens/s beside phase 4's;
 33. (right after phase 16, on phase 15's parameters) phase 15's mix
     pipelined with ``admit_chunk_tokens=512``: every admission in
     chunks, the flash kernel's launches 48 x the chunks, streams held to
     phase 15's, the admission stall beside phase 15's admission wall;
 34. (right after phase 32, on phase 4's parameters) the degradation
     ladder: phase 4's mix plus three sacrificial submissions through the
     pipelined graph route under a seeded plan that fires every fault
     kind (``_chaos_plan``: a squeeze to ``CHAOS_SQUEEZE`` HBM pages,
     failing and slow migrations, a hung then crashed decision worker,
     corrupted masses, an admission flood), with ``max_queue``, a
     watchdog far above phase 32's longest decision wait and three
     restarts.  Fails unless every kind fired, the run drained with
     every page and the batcher's memory back, every submission has a
     typed status (the mix completed, one expired, two shed), the
     streams are phase 4's, the watchdog restarted for a hang and a
     crash and then decided in line for good, and kernel 1 launched 40 x
     the device steps;
 35. phase 4's mix by phase 4's synchronous graph route under a squeeze
     alone: at least one preemption, every frozen request thawed, one
     admission a request, streams held to phase 4's;
 36. (right after phase 23, on its parameters) olmoe-1b-7b's mix through
     the pipelined loop, packed and then chunked (``OLMOE_CHUNK``):
     streams held to phase 23's graph route's, both kernels' launches,
     the "admit" stage's wall (a MoE chunk reads the host);
 37. full-width, full-depth paligemma-3b trained through
     ``train.step.make_train_step`` (remat, float32 AdamW state; 10.0 GB of
     float32 weights from a seeded init): ``DataConfig(global_batch=4,
     seq_len=256)`` with the seeded 256-position image prefix, 512
     positions a row.  Two steps on batch 0 (the second's loss must be
     below the first's), then batches 1-4; every loss and gradient norm
     finite; the step wall p50, positions/s, one more step's
     forward+backward and optimizer on CUDA events, peak memory and the
     share of 67 TFLOP/s float32 that 8 N T reaches (remat: the forward
     twice; TF32 off);
 38. olmoe-1b-7b at full width, depth cut 16 -> 4 (7.5 GB): int8 AdamW
     state, ``accum_steps=2``, the MoE backward through the expert loop;
     4 steps with phase 37's checks and numbers (8 N_active T);
 39. the train step on the card against the CPU on every registered
     architecture's reduced config (the same seeded weights and batch):
     loss, gradient norm and every parameter after one step within the
     stated bars (``PARITY_*``), float32 state, plus int8 state on
     olmoe-1b-7b (its codes too);
 40. the restart drill (``tests/test_substrate.py``'s): ``ft.supervisor``
     relaunches ``python -m repro_torch.launch.train --arch olmoe-1b-7b
     --reduced --steps 12 --batch 2 --seq 16 --ckpt-every 4`` on the card
     after ``REPRO_FAIL_AT_STEP=8``; exit 0, one restart, the resume at
     step 8 with 4 steps run, and the resumed losses within
     ``DRILL_RTOL`` of an uninterrupted run's (in this process); the
     checkpoint directory is a temporary one, removed afterwards.
     Under autograd the mLSTM's dense form and the sLSTM run their
     forward kernels with the saves and their backward kernels, so phase
     39's xlstm-1.3b step launches all four (its counts printed); the
     RG-LRU and the mLSTM's paged branch take their plain versions.
     Phases 37, 38, 40 and 41 launch no hand-written kernel (the
     reference's training path reaches no ``pallas_call``): their counts
     must stay 0, as must every other config's recurrence counts in 39;
 41. phase 37's cell through the mesh step (``train.step.make_train_step``
     with a ``DeviceMesh``): a one-rank NCCL process group, the (1, 1)
     ("data", "model") mesh of ``launch.mesh.make_host_mesh``, the state
     as DTensors; its losses within ``MESH_LOSS_RTOL`` of phase 37's, its
     parameters' per-leaf float64 sums within ``MESH_SUM_RTOL`` (and
     whether every leaf's bit sum is phase 37's), the step wall p50, the
     split step's forward+backward and optimizer, the peak memory; no
     kernel launched (the mesh path reaches no ``pallas_call``);
 42. the dry-run (``launch.dryrun``), traced in a process of its own on
     the CPU beside phases 37-41 (meta tensors over a fake process
     group): phase 37's cell on (1, 1), whose predicted peak must lie
     within ``DRYRUN_PEAK_BAR`` of phase 41's measured
     ``max_memory_allocated``, and ``DRYRUN_CELLS`` at full size on the
     production (16, 16) mesh (per-device bytes against 80 GB, FLOPs,
     collective bytes by kind, trace seconds); the card must be the
     records' 80 GB H100;
 43. (right after phase 35, on phase 4's parameters) the batcher's
     ``macro_steps=4`` on phase 4's mix: streams held to phase 4's, every
     macro 4 steps but where the remaining work caps it, kernel 1 a layer
     a device step;
 44. (right before phase 19) the mLSTM recurrence kernel ``mlstm_scan``
     vs its plain version at xlstm-1.3b's full width (4 heads of 1024):
     a 256-position prefill from the zero state and from the state it
     leaves, B = 2 at S = 1, 3 and 17 from a carried state, and a decode
     step of B = 4 in place over pool pages of both tiers (one row
     dropped to the sinks, each HBM slot another host page).  S = 1 (the
     strip kernel): C, n and m bit-equal to the plain version (every byte
     of the state buffers); S > 1 (the chunkwise form): m bit-equal, each
     destination row's C and n within their bounds (``tolerances``),
     every other byte the plain version's, h within its bound
     (``tolerances``; S = 1 ``h_tolerance``), each call two kernel
     launches (S = 1: one), the rows no destination names untouched, a
     second call bit-identical.  Then its
     time at the decode and prefill shapes, a call and on the device,
     beside its plain version and its bound (the decode's bytes at 3.35
     TB/s; the prefill's chunkwise products as 3xTF32 at 495 TFLOP/s,
     with the recurrent form's 6 float32 operations an element of C a
     position at 67 TFLOP/s beside it), the prefill also through the
     strip kernel; no PyTorch call computes it (``library_ms`` null);
 45. (right after phase 44) the sLSTM recurrence kernel ``slstm_scan`` vs
     its plain version at xlstm-1.3b's full width (4 heads of 512): a
     256-position prefill from the zero state and from the state it
     leaves, a decode step of B = 4 from a carried state, and a grid of
     reduced shapes (4 heads of 16, 64 and 128; S 1, 7 and 256).  Each
     case: every position run as one position from the plain version's
     state (teacher-forced; at S = 1 the one step) and from the kernel's
     own, within the one-step bound (``slstm_scan.tolerance``: the
     float32 dot-product bound carried through the cell); the sequence
     launch bit-identical to one-position launches chained on its own
     state and to a second call; the whole sequence's deviation printed
     and held to the carried bound (the recurrence is chaotic at the
     model's initialisation).  Then its time at the prefill and decode
     shapes, a call and on the device (us a position of the serial
     chain), beside its plain version and its bound; no PyTorch call
     computes it (``library_ms`` null);
 46. (right before phase 18) the RG-LRU kernel ``rglru_scan`` vs its
     plain version at recurrentgemma-2b's width (2560): B = 1, S = 2600
     from a carried h, B = 4 at S = 1, a grid around the kernel's chunk
     of 64 positions and B = 4 at S = 4096 (more tiles than the card
     holds at once); h within ``h_tolerance``, a second call
     bit-identical, also after a call on other data, and three CUDA
     graph replays of the call (on its data, on other data, on its data)
     each bit-identical to the eager call on the same data.  Then its
     time at both shapes beside its plain version and its bytes bound,
     and an empty kernel's device time beside the decode's (the floor a
     standalone launch cannot go under); ``library_ms`` null;
 47. (right after phase 45) the mLSTM and sLSTM backward kernels
     (``mlstm_scan_backward``, ``slstm_scan_backward``) vs their plain
     versions at phase 48's shape (B = 4, S = 256: the mLSTM's 4 heads of
     1024 from the zero state and a carried one, the sLSTM's 4 heads of
     512 from both with r_gates at fan-in hd) and at reduced
     xlstm-1.3b's (4 heads of 32 and of 16, S = 16, r_gates at the
     reference's fan-in nh): each forward with its saves bit-identical
     to the forward without, each gradient within ``grad_check``'s bar
     (the distance from float64 runs of the plain forward and backward
     at most ``GRAD_MULT`` times the float32 plain run's), the backward's
     launches counted (4 and 1 a call) and a second call bit-identical;
     the sLSTM at the reference's init and full width (chaotic: its
     gradient leaves float32's range over the sequence) one position at
     a time, B (S - 1) rows of two positions from the saved states with
     seeded incoming gradients.  Then each backward's time a call and on
     the device beside its plain version and its bound (float32 products
     at 67 TFLOP/s; bytes at 3.35 TB/s), the mLSTM's forward with and
     without the saves, and autograd of the per-position mLSTM loop (the
     route training took before) at S = ``MLSTM_LOOP_S``; ``library_ms``
     null;
 48. (after phase 41) full-width, full-depth xlstm-1.3b (48 layers,
     3.47 B parameters) trained as phase 37: remat, ``XLSTM_TRAIN_STATE``
     (float32) AdamW state, B = 4, S = 256, six steps, the second on
     batch 0 again, every sLSTM's r_gates redrawn at fan-in hd
     (``SLSTM_FAN_IN_REF``: at the reference's the backward overflows
     float32); phase 37's bars and numbers, and each recurrence kernel's
     launches over its seven steps (each must be > 0);
 49. (right after phase 48) the RG-LRU backward kernel
     ``rglru_scan_backward`` vs float64 at recurrentgemma-2b's width, and
     its time at phase 50's shape beside its bound and its plain version;
 50. full-width, full-depth recurrentgemma-2b trained as phase 37, the
     RG-LRU through its forward and backward kernels;
 51. (right after phase 25) full-width, full-depth stablelm-12b (40
     layers, 32/8 heads of 160, a SwiGLU MLP of 13824, vocabulary 100352,
     untied; float32 weights from a seeded init, 48.6 GB) with
     ``attention_impl="pallas"``, served with phase 4's pools and mix by
     the graph route and then the eager route, as phase 4: the paged
     kernel's launches must equal 40 x the device steps, the flash
     kernel's 40 x the admissions, and the Cori loop must act (hits
     counted, the tuner out of its profile window);
 52. parity on the card: reduced stablelm-12b at head dim 160 and reduced
     nemotron-4-340b at 192, each under both ``attention_impl`` settings:
     the batcher's greedy streams (macro and per-token) equal
     ``generate``'s, the flash kernel launched, and ``generate``'s streams
     the same under both settings.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 without tensor
# cores, dense TF32 and bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
# the TF32 rate mma.sync reached on an H100 80GB HBM3 at 700 W with 8 warps
# an SM (PERF.md, the flash kernel's throughput probe): the floor of a
# kernel whose products run on it
MMA_SYNC_TF32_FLOPS_PER_S = 278.5e12
SEED = 0
DEV = torch.device("cuda")


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def phase_device() -> str:
    print("== phase 1: device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}", flush=True)
    return smi.splitlines()[0]


def phase_build(build, kernels) -> None:
    """Build every kernel's library at once (one nvcc per source)."""
    print("== phase 2: build", flush=True)
    t0 = time.monotonic()
    libs = build.build_many([(k.NAME, k.NVCC_FLAGS) for k in kernels])
    print(f"built {len(libs)} kernels in {time.monotonic() - t0:.1f} s",
          flush=True)
    for k, lib in zip(kernels, libs):
        print(f"-- {lib.name} (nvcc {' '.join(k.NVCC_FLAGS)})", flush=True)
        print(lib.with_suffix(".log").read_text().strip(), flush=True)


# recurrentgemma-2b's local layers at phase 18's serving shape: B 4, 10
# query heads over 1 KV head of 256, window 2048, tables of max_len 3072 /
# 16 = 192 token pages plus the state page's column
RGEMMA_DECODE = dict(b=4, h=10, kv=1, d=256, page=16, n=193, p_phys=800,
                     window=2048, state_col=True)


# where the kernel's split over pages can go wrong (``split_plan`` gives
# 4 pages a split at B=4, KV=8, n=64 or window 1000; 3 at n=50): spans that
# end inside the first split or on a split boundary (64 = 4 pages, 320 = 5
# splits) beside a row that fills every split; -1 slots inside a split and
# a split whose slots are all -1; windows whose span starts past page 0 or
# at it, so the splits past a short span are empty; n not a multiple of
# the split (50 = 16 x 3 + 2); a length-0 row
SPLIT_EDGES = [
    dict(b=4, h=40, kv=8, d=128, page=16, n=64, p_phys=256,
         lengths=[1024, 20, 64, 320], holes=[(0, 5), (3, 2)]),
    dict(b=4, h=40, kv=8, d=128, page=16, n=64, p_phys=256,
         lengths=[1024, 777, 0, 301], holes=[(0, 8), (0, 9), (0, 10),
                                             (0, 11)]),
    dict(b=4, h=16, kv=8, d=256, page=16, n=128, p_phys=512,
         lengths=[2048, 1030, 700, 1], window=1000, holes=[(1, 40)]),
    dict(b=4, h=40, kv=8, d=128, page=16, n=50, p_phys=256,
         lengths=[800, 799, 48, 0], softcap=5.0),
]


def _kernel_case(pa, *, b, h, kv, d, page, n, p_phys, lengths, dtype,
                 window=0, softcap=0.0, ragged=True, holes=(),
                 state_col=False, shared=0, seed=0):
    """Random q / pools / table on the card; returns the inputs.  ``holes``
    lists (row, page) table entries set to -1 inside a row's span;
    ``state_col`` puts a real page in the last column of every row with a
    request, as the served tables of a recurrent config hold its state
    page there, past every length; ``shared`` makes every row's first
    ``shared`` columns row 0's pages, as the served tables of a prefix
    config map the shared prefix pages there."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dtype)
    perm = torch.randperm(p_phys, generator=g, device=dev).to(torch.int32)
    table = perm[: b * n].reshape(b, n).clone()
    table[:, :shared] = table[0, :shared].clone()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if ragged:   # rows shorter than the table are padded with -1
        for row, length in enumerate(lengths):
            table[row, -(-length // page):] = -1
    for row, pg in holes:
        table[row, pg] = -1
    if state_col:
        live = ln > 0
        table[live, -1] = perm[b * n: b * n + int(live.sum())]
    return dict(q=q, k_pages=kp, v_pages=vp, page_table=table, lengths=ln,
                window=window, softcap=softcap)


def phase_kernel_check(pa) -> float:
    """Kernel vs plain version; returns the largest float32 error seen."""
    print("== phase 3: kernel vs plain version on the card", flush=True)
    tol = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2e-2, 1e-5)}
    main = dict(b=4, h=40, kv=8, d=128, page=16, n=64, p_phys=256,
                lengths=[1024, 777, 0, 301])
    # olmoe-1b-7b's: 16 query heads over 16 KV heads of 128 (a group of one)
    olmoe = dict(PAGED_SHAPES["olmoe-1b-7b"], lengths=[1024, 600, 0, 129])
    # gemma3-12b's decode shape: the window path at D = 256
    gemma = dict(b=4, h=16, kv=8, d=256, page=16, n=128, p_phys=512,
                 lengths=[2048, 1500, 1025, 0], window=1024)
    # recurrentgemma-2b's: 10 query heads over 1 KV head (five groups of
    # two at D 256), window 2048, rows past the window, a row without a
    # request, and its tables' 193rd column holding the state page
    rgemma = dict(RGEMMA_DECODE, lengths=[3000, 2100, 2049, 0])
    # musicgen-large's (a GQA group of one at D 64), nemotron-4-340b's
    # (six head groups of two a KV head; D 192 fills half of the second
    # 128-column chunk) and stablelm-12b's (D 160)
    musicgen = dict(PAGED_SHAPES["musicgen-large"],
                    lengths=[1024, 777, 0, 129])
    nemotron = dict(PAGED_SHAPES["nemotron-4-340b"],
                    lengths=[1024, 600, 301, 0])
    stablelm = dict(b=4, h=32, kv=8, d=160, page=16, n=64, p_phys=256,
                    lengths=[1000, 1024, 0, 17])
    # paligemma-3b's: 8 query heads over 1 KV head of 256 (four head
    # groups of two), every row's first 16 columns the shared prefix pages
    paligemma = dict(PAGED_SHAPES["paligemma-3b"],
                     lengths=[1024, 640, 257, 0])
    grid = [dict(main), olmoe, gemma, rgemma, musicgen, nemotron,
            stablelm, paligemma] + SPLIT_EDGES
    for h, kv in ((4, 4), (8, 2), (8, 1)):
        for window, softcap in ((0, 0.0), (3, 0.0), (0, 5.0), (3, 5.0)):
            grid.append(dict(b=3, h=h, kv=kv, d=64, page=16, n=6, p_phys=32,
                             lengths=[96, 37, 5], window=window,
                             softcap=softcap))
    worst_f32 = 0.0
    for i, case in enumerate(grid):
        for dtype in (torch.float32, torch.bfloat16):
            args = _kernel_case(pa, dtype=dtype, seed=i, **case)
            out, mass = pa.paged_attention(**args)
            again = pa.paged_attention(**args)
            torch.cuda.synchronize()
            if not (torch.equal(out, again[0])
                    and torch.equal(mass, again[1])):
                _fail(f"two calls on the same inputs differ (case {i})")
            ref_o, ref_m = pa.paged_attention_plain(**args)
            err_o = float((out.float() - ref_o.float()).abs().max())
            err_m = float((mass - ref_m).abs().max())
            active = args["lengths"] > 0
            err_sum = float((mass.sum(dim=1)[active] - 1).abs().max())
            t_o, t_m = tol[dtype]
            ok = err_o <= t_o and err_m <= t_m and err_sum <= 1e-5
            if case.get("state_col"):     # the state page is never read
                ok = ok and not bool(mass[:, -1].any())
            if case.get("shared"):        # every live row reads the prefix
                ok = ok and bool((mass[active, : case["shared"]] > 0).all())
            plan = _plan(pa, case)
            print(f"case {i} {str(dtype)[6:]} H={case['h']} KV={case['kv']} "
                  f"D={case['d']} n={case['n']} lengths {case['lengths']} "
                  f"holes {list(case.get('holes', ()))} shared columns "
                  f"{case.get('shared', 0)} (pages a split, "
                  f"splits, head groups) {plan} "
                  f"window={case.get('window', 0)} "
                  f"softcap={case.get('softcap', 0.0)}: out err {err_o:.3g} "
                  f"(tol {t_o}), mass err {err_m:.3g} (tol {t_m}), "
                  f"|row mass sum - 1| {err_sum:.3g} (tol 1e-5) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                _fail(f"kernel disagrees with its plain version (case {i})")
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err_o, err_m)
            if not bool(torch.all(mass[~active] == 0)) \
                    or not bool(torch.all(out[~active] == 0)):
                _fail("a length-0 row must give zeros")
    return worst_f32


def _plan(pa, case):
    """The paged kernel's (pages a split, splits, head groups) at a case's
    shape, as its wrapper plans the launch."""
    groups = pa.head_groups(case["h"], case["kv"], case["d"])
    return pa.split_plan(case["n"], case.get("window", 0), case["page"],
                         case["b"], case["kv"], groups) + (groups,)


def _wrappers(kernels) -> dict:
    """{name: wrapper} of every counted wrapper: each kernel module's, and
    its backward's where it has one."""
    out = {}
    for k in kernels:
        for name in (k.NAME, k.NAME + "_backward"):
            if hasattr(k, name):
                out[name] = getattr(k, name)
    return out


def _reset_counts(kernels) -> None:
    for fn in _wrappers(kernels).values():
        fn.launches = 0


def _mix_requests(S, cfg, rng, n_req, prompt, new):
    """``n_req`` requests drawn from ``rng``: prompt and new-token counts
    from the half-open ranges ``prompt`` and ``new``, requests 2 and 5
    sampled at temperature 0.8 (printed)."""
    reqs = []
    for i in range(n_req):
        plen = int(rng.integers(*prompt))
        reqs.append(S.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, plen).astype(
                np.int32),
            max_new_tokens=int(rng.integers(*new)),
            temperature=0.8 if i in (2, 5) else 0.0, seed=SEED + i))
    print("requests (prompt, new, temperature): "
          + ", ".join(f"({len(r.prompt)}, {r.max_new_tokens}, "
                      f"{r.temperature})" for r in reqs), flush=True)
    return reqs


def _serve_mix(params, cfg, S, memtier, cori, telemetry, kernels, *,
               n_logical=256, hbm_pages=128, max_len=1024, n_req=8,
               prompt=(128, 513), new=(48, 97), access_threshold=0.05,
               eager=False, between=None, cond=None, extra_embeds=None,
               keep=None, **batcher_kw):
    """Serve a request mix with the macro-step batcher over
    ``SharedPagedPools`` + ``TieringManager`` + ``OnlineTuner`` until
    drained, with every kernel's launch count set to 0 just before:
    ``n_req`` requests with prompt and new-token counts drawn from the
    half-open ranges ``prompt`` and ``new``, requests 2 and 5 sampled at
    temperature 0.8.  A page counts as accessed in a step when its
    layer-averaged attention mass reaches ``access_threshold`` (the
    manager's hits and the tuner's reuse gaps).  ``eager`` asks the
    batcher for the eager route; otherwise it takes the route its config
    and the card give it (printed).  ``between``, if given, takes the
    batcher and returns a callable that is called with it after every
    scheduler step.  ``cond`` is the session's conditioning (``.xattn``
    configs), ``extra_embeds`` its shared prefix (``prefix_len``
    configs: the demand fetches of the prefix pages are counted).
    ``batcher_kw`` goes to the batcher (``pipeline``,
    ``admit_chunk_tokens``, ``fault_plan``, ``max_queue``, ``watchdog_s``,
    ``max_worker_restarts``); ``keep``, a dict, receives the run's flight
    recorder as ``keep["recorder"]``.  The streams are those of the
    requests that completed (a shed or expired submission has none).
    Prints and checks what every served model shares, and the merged
    page masses the monitor saw (the access threshold is set from them);
    returns (batcher, result, rng, requests), the result with the route's
    streams, tiering counts and tuner history."""
    page = 16
    pools = memtier.SharedPagedPools.create(n_logical, hbm_pages)
    mgr = memtier.TieringManager(n_logical, memtier.TierConfig(
        page_size=page, hbm_pages=hbm_pages, period_steps=8,
        access_threshold=access_threshold))
    tuner = cori.OnlineTuner(n_logical, default_period=8,
                             access_threshold=access_threshold)
    mon = S.TrafficMonitor(pools, mgr, tuner)
    merged = []
    merge = mon.merge
    mon.merge = lambda c: merged.append(merge(c)) or merged[-1]
    t0 = time.monotonic()
    b = S.ContinuousBatcher(params, cfg, monitor=mon, max_active=4,
                            max_len=max_len, page_size=page, eager=eager,
                            cond=cond, extra_embeds=extra_embeds,
                            **batcher_kw)
    prefix_pages = (cfg.prefix_len or 0) // page
    fetches = {"all": 0, "prefix": 0}
    if prefix_pages:
        ensure = pools.ensure_resident

        def counted(gids):
            gids = np.asarray(gids)
            fetches["prefix"] += int(
                (pools.slot_of[gids[gids < prefix_pages]] < 0).sum())
            n = ensure(gids)
            fetches["all"] += n
            return n
        pools.ensure_resident = counted
    torch.cuda.synchronize()
    print(f"route {b.route} (eager asked: {eager}; graph capture included: "
          f"batcher built in {time.monotonic() - t0:.2f} s)"
          + (f"; {batcher_kw}" if batcher_kw else ""), flush=True)
    leaves = [k[:-4] for k in pools.kv_layers if k.endswith("_hbm")]
    pool_bytes = sum(t.numel() * t.element_size()
                     for ts in pools.kv_layers.values() for t in ts
                     if t is not None)
    print(f"pools: {n_logical} logical pages, {hbm_pages} HBM slots, page "
          f"{page}: {pool_bytes / 1e9:.3f} GB of float32 {'/'.join(leaves)} "
          f"rows over {len(pools.layer_meta)} slot(s) x repeats "
          f"{pools.layer_meta}, {pools.move_planes} planes per migrated "
          "page", flush=True)

    rng = np.random.default_rng(SEED)
    reqs = _mix_requests(S, cfg, rng, n_req, prompt, new)

    rec = telemetry.install(telemetry.Recorder())
    for r in reqs:
        b.submit(r)
    hook = between(b) if between else None
    _reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if hook is None:
        b.run()
    else:
        while not b.idle:
            b.step()
            hook(b)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    # the streams of the requests served (a fault plan's shed and expired
    # submissions end with no tokens; the phase checks their statuses)
    out = {r.rid: list(r.tokens) for r in b.completed
           if r.status == "completed"}

    n_tok = sum(len(v) for v in out.values())
    macros = rec.events("serve.macro")
    walls = sorted(e["wall_ms"] for e in macros)
    admits = rec.events("serve.admit")
    print(f"served {len(out)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.2f} tokens/s end to end (prefill included)",
          flush=True)
    print(f"macros {len(macros)}, decode steps {b.decode_steps}, device "
          f"steps {b.device_steps}, macro wall p50 "
          f"{float(np.median(walls)):.1f} ms (min {walls[0]:.1f}, max "
          f"{walls[-1]:.1f}), admissions {len(admits)} taking "
          f"{sum(e['wall_ms'] for e in admits) / 1e3:.2f} s", flush=True)
    print(f"tiering (access threshold {access_threshold}): migrations "
          f"{mgr.migrations}, hits {mgr.hits}, misses "
          f"{mgr.misses}, modeled time {mgr.modeled_time:.0f}, pages moved "
          f"{mgr.data_moved_pages}, period {mgr.period}", flush=True)
    print(f"tuner: state {tuner.state}, period {tuner.period}, steps "
          f"{tuner.step}, retunes {tuner.retunes}, dominant reuse "
          f"{tuner.dominant_reuse}, candidates {tuner.candidates.tolist()}, "
          f"tried {tuner.tried}, history {tuner.history}", flush=True)
    print(f"macro lengths: {[e['n_steps'] for e in macros]}", flush=True)
    # a fault plan's ``mass.nonfinite`` corrupts feeds in place: those
    # entries are counted and left out
    bad = sum(int((~np.isfinite(m)).sum()) for m in merged)
    pos = np.concatenate([m[np.isfinite(m) & (m > 0)] for m in merged])
    q = np.quantile(pos, [0.0, 0.01, 0.1, 0.5, 0.9, 1.0])
    print(f"merged page mass over {len(merged)} feeds, {pos.size} positive "
          f"entries: min {q[0]:.3g}, p1 {q[1]:.3g}, p10 {q[2]:.3g}, p50 "
          f"{q[3]:.3g}, p90 {q[4]:.3g}, max {q[5]:.3g}; "
          f"{float((pos >= access_threshold).mean()) * 100:.1f}% at or "
          f"above the access threshold {access_threshold}"
          + (f"; {bad} non-finite entries left out" if bad else ""),
          flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"peak device memory {peak_gb:.2f} GB", flush=True)
    if prefix_pages:
        print(f"shared prefix: {prefix_pages} pages (owner -1, never ranked "
              f"into the desired set): {fetches['prefix']} of the "
              f"{fetches['all']} demand-fetched pages (misses "
              f"{mgr.misses}) were prefix pages evicted by a tier and "
              "fetched back", flush=True)

    if sorted(out) != list(range(n_req)):
        _fail(f"not every request completed: {sorted(out)}")
    for r in reqs:
        toks = out[r.rid]
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            _fail(f"request {r.rid}: {len(toks)} tokens, expected "
                  f"{r.max_new_tokens} in [0, {cfg.vocab_size})")
    if b.decode_steps <= 0:
        _fail("no decode step ran")
    if not all(math.isfinite(c) for c in tuner.cost_log):
        _fail("non-finite tuner cost")
    if pools.free_pages != n_logical - prefix_pages:
        _fail("pages leaked after the drain")
    telemetry.install(telemetry.Recorder())
    if keep is not None:
        keep["recorder"] = rec
    result = dict(route=b.route, tokens=n_tok, wall_s=wall,
                  tokens_per_s=n_tok / wall,
                  macro_p50_ms=float(np.median(walls)), macros=len(macros),
                  decode_steps=b.decode_steps, device_steps=b.device_steps,
                  peak_gb=peak_gb, admissions=len(admits),
                  admit_wall_ms=[e["wall_ms"] for e in admits],
                  prefills=sum(e["joiners"] for e in admits),
                  first_joiners=admits[0]["joiners"] if admits else 0)
    same = dict(streams=out, migrations=mgr.migrations, hits=mgr.hits,
                misses=mgr.misses, tuner_history=list(tuner.history))
    if prefix_pages:
        result.update(prefix_fetched=fetches["prefix"],
                      fetched=fetches["all"])
        same["prefix_fetched"] = fetches["prefix"]
    return b, result, same, rng, reqs


def _check_launches(name, launches, layers, b, eager) -> None:
    """A decode kernel's launches in a served mix: layers x the steps the
    device ran (every replayed step of a graphed macro), and on the eager
    route those steps are the decode steps (no step without a live
    row)."""
    ok = launches == layers * b.device_steps
    print(f"{name} launches {launches} = {layers} layers x "
          f"{b.device_steps} device steps -> {ok} ({b.route} route; "
          f"decode steps {b.decode_steps})", flush=True)
    if not ok:
        _fail(f"{name}'s launches do not match {layers} x the device steps")
    if eager and b.device_steps != b.decode_steps:
        _fail(f"the eager route ran {b.device_steps} device steps for "
              f"{b.decode_steps} decode steps")
    if b.device_steps < b.decode_steps:
        _fail("fewer device steps than decode steps")


def _serve_routes(params, cfg, S, memtier, cori, telemetry, kernels, check,
                  **mix):
    """Serve the mix by the graph route (the main path), then by the eager
    route over fresh pools; ``check(b, result, eager)`` checks each
    route's launches before one macro is profiled (``_profile_macro``)
    and the batcher is freed.  Fails unless the two routes' streams,
    migrations, hits, misses and tuner history are identical.  Returns
    ({route: result}, requests)."""
    results, same = {}, {}
    for eager in (False, True):
        print(f"-- the {'eager' if eager else 'graph'} route", flush=True)
        b, res, same[eager], rng, reqs = _serve_mix(
            params, cfg, S, memtier, cori, telemetry, kernels, eager=eager,
            **mix)
        if b.route != ("eager" if eager else "graph"):
            _fail(f"{cfg.name}: the batcher took the {b.route} route")
        check(b, res, eager)
        res["profile"] = _profile_macro(b, S, cfg, rng)
        results[b.route] = res
        held = torch.cuda.memory_allocated()
        del b
        gc.collect()
        torch.cuda.empty_cache()
        print(f"batcher freed: allocated {held / 1e9:.2f} GB -> "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    for key in same[False]:
        ok = same[False][key] == same[True][key]
        print(f"graph == eager: {key} {ok}", flush=True)
        if not ok:
            _fail(f"{cfg.name}: the graph and eager routes differ in {key}")
    results["graph"].update((k, v) for k, v in same[False].items()
                            if k != "streams")
    for route, res in results.items():
        prof = res["profile"]
        busy = ("busy/idle not measured" if prof["busy_pct"] is None else
                f"busy {prof['busy_pct']:.1f}% / idle {prof['idle_pct']:.1f}%")
        print(f"{cfg.name} {route} route: {res['tokens_per_s']:.2f} tokens/s, "
              f"macro wall p50 {res['macro_p50_ms']:.1f} ms, profiled "
              f"{prof['ms_per_step']:.1f} ms/step, {busy}, device steps "
              f"{res['device_steps']} vs decode steps {res['decode_steps']}",
              flush=True)
    return results, reqs


def _check_freed(held: int, kept: int = 0) -> None:
    """After a served model's (or a batcher's) last reference is
    dropped: collect it, return its memory to the card, and fail unless
    the allocated memory fell from ``held`` to near ``kept`` (what stays:
    0 for a model, the parameters for a batcher on them)."""
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"freed: allocated {held / 1e9:.2f} GB -> {left / 1e9:.2f} GB "
          f"(kept {kept / 1e9:.2f} GB)", flush=True)
    if left > kept + 2e9:
        _fail("the served model was not freed")


def phase_serve(C, mdl, pa, S, memtier, cori, telemetry, kernels):
    print("== phase 4: full-width qwen3-14b serving (macro-step batcher)",
          flush=True)
    cfg = C.get("qwen3-14b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = mdl.init(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"init: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {n_params / 1e9:.3f} B "
          f"float32 params ({cfg.param_count() / 1e9:.3f} B without norms) "
          f"in {time.monotonic() - t0:.1f} s", flush=True)

    streams = {}

    def check(b, result, eager):
        result["launches"] = pa.paged_attention.launches
        _check_launches("paged_attention", result["launches"],
                        cfg.num_layers, b, eager)
        if not eager:
            streams.update((r.rid, list(r.tokens)) for r in b.completed)

    results, _ = _serve_routes(params, cfg, S, memtier, cori, telemetry,
                               kernels, check)
    # phase 30 serves the same mix densely on these parameters
    return results, cfg, params, streams


def _profile_macro(b, S, cfg, rng) -> dict:
    """Where one full-width decode macro's time goes: four fresh requests
    are admitted (unprofiled step), then one decode macro runs under
    ``torch.profiler``.  Prints the macro's wall time, the device time the
    profiler attributes to kernels (busy share = device time / wall) and
    the kernels that take the most of it; then drains the batcher.
    Returns ms/step (wall, per decode step), busy and idle percent (None
    when the profiler saw no device time) and each group's ms/step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(4):
        b.submit(S.Request(rid=100 + i, prompt=rng.integers(
            0, cfg.vocab_size, 256).astype(np.int32), max_new_tokens=40))
    b.step()                                   # admission + first macro
    torch.cuda.synchronize()
    steps0, dsteps0 = b.decode_steps, b.device_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        b.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    steps, dsteps = b.decode_steps - steps0, b.device_steps - dsteps0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {"matmul (cuBLAS)": 0.0, "paged_attention (this repo)": 0.0,
              "routed_experts (this repo)": 0.0,
              "mlstm_scan (this repo)": 0.0, "slstm_scan (this repo)": 0.0,
              "rglru_scan (this repo)": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = ("paged_attention (this repo)"
               if "paged_attention" in name or "page_mass" in name
               else "routed_experts (this repo)" if "routed_" in name
               else "mlstm_scan (this repo)" if "mlstm_scan" in name
               else "slstm_scan (this repo)" if "slstm_scan" in name
               else "rglru_scan (this repo)" if "rglru_" in name
               else "matmul (cuBLAS)" if "gemm" in name or "gemv" in name
               else "other")
        groups[key] += e.self_device_time_total / 1e3
    print(f"profiled decode macro ({b.route} route): {steps} steps ({dsteps} "
          f"on the device) in {wall_ms:.1f} ms wall "
          f"({wall_ms / max(1, steps):.1f} ms/step); device time "
          f"{dev_ms:.1f} ms -> busy {dev_ms / wall_ms * 100:.1f}%, idle "
          f"{100 - dev_ms / wall_ms * 100:.1f}%"
          if dev_ms > 0 else "profiled decode macro: the profiler saw no "
          "device time (not measured)", flush=True)
    for key, ms in groups.items():
        print(f"  {key}: {ms:.1f} ms ({ms / max(1, steps):.2f} ms/step)",
              flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    b.run()
    busy = dev_ms / wall_ms * 100 if dev_ms > 0 else None
    return dict(ms_per_step=wall_ms / max(1, steps), steps=steps,
                device_steps=dsteps,
                busy_pct=busy, idle_pct=None if busy is None else 100 - busy,
                **{f"{k.split()[0]}_ms_per_step": ms / max(1, steps)
                   for k, ms in groups.items()})


def _parity(cfg, mdl, S, memtier, cori, engine) -> dict:
    """On a small float32 config: the batcher's greedy streams (macro and
    per-token, staggered admission over two rows) equal ``generate``'s
    (dense decode, no kernel), both given the same conditioning
    (``_session_cond``) and shared prefix (``_session_prefix``) when the
    config has one.  Returns ``generate``'s streams."""
    params = mdl.init(cfg, seed=SEED)
    _perturb_conv(params)
    cond = _session_cond(cfg)
    ex = _session_prefix(cfg)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 5, 11)]
    new = (6, 4, 9, 7)
    ref = {i: engine.generate(params, cfg, p[None], steps=new[i],
                              cond=cond, extra_embeds=ex)[0].tolist()
           for i, p in enumerate(prompts)}
    for macro in (True, False):
        mon = S.TrafficMonitor(
            memtier.SharedPagedPools.create(48, 10),
            memtier.TieringManager(48, memtier.TierConfig(
                page_size=4, hbm_pages=10, period_steps=2)),
            cori.OnlineTuner(48, default_period=2, profile_steps=8,
                             trial_steps=4))
        b = S.ContinuousBatcher(params, cfg, monitor=mon, max_active=2,
                                max_len=32, page_size=4, macro=macro,
                                cond=cond, extra_embeds=ex)
        for i in (0, 1):
            b.submit(S.Request(rid=i, prompt=prompts[i],
                               max_new_tokens=new[i]))
        steps = 0
        while not b.idle:
            if steps in (1, 3):
                i = 2 if steps == 1 else 3
                b.submit(S.Request(rid=i, prompt=prompts[i],
                                   max_new_tokens=new[i]))
            b.step()
            steps += 1
        got = {r.rid: r.tokens for r in b.completed}
        same = got == ref
        print(f"{'macro' if macro else 'per-token'} batcher greedy streams "
              f"== generate: {same} (migrations {mon.manager.migrations}, "
              f"tuner history {mon.tuner.history})", flush=True)
        if not same:
            _fail(f"batcher streams {got} differ from generate {ref}")
    return ref


def phase_parity(C, mdl, S, memtier, cori, engine):
    print("== phase 5: parity on the card (reduced GQA config, float32)",
          flush=True)
    _parity(dataclasses.replace(C.reduced("qwen3-14b"), num_kv_heads=2,
                                segments=((("attn",), 2),), dtype="float32"),
            mdl, S, memtier, cori, engine)


def _time(fn, iters, flush_buf):
    """Mean ms per call over ``iters`` calls, each timed with its own CUDA
    event pair after a write that flushes the 50 MB L2."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush_buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def _device_ms(fn, iters, flush_buf):
    """Device-only ms per call: the durations of the kernels ``fn``
    launches, from ``torch.profiler``, over ``iters`` calls each after the
    same L2 flush as ``_time`` (the flush's own kernels, found by
    profiling it alone and by the uint8 fill's name, are left out).  Each
    kernel counts at its mean duration times its launches per call (its
    count over ``iters``, rounded: a profiler that drops some events
    still gives the right sum).  Where the profiler sees no device time, CUDA events around
    ``iters`` back-to-back (flush, call) pairs less the flushes' own event
    time.  Returns (ms, how, {kernel: ms a call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(body):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count}

    def flushes():
        for _ in range(iters):
            flush_buf.zero_()

    def pairs():
        for _ in range(iters):
            flush_buf.zero_()
            fn()

    for _ in range(3):
        fn()
    flush_names = set(kernels(flushes))
    split, partial = {}, 0
    for k, (us, count) in sorted(kernels(pairs).items()):
        # the flush's own fill also where the profiler lost its events
        # when it profiled the flushes alone
        if k in flush_names or "FillFunctor<unsigned char>" in k:
            continue
        partial += count % iters != 0
        found = re.search(r"(\w+)\s*[<(]",
                          k.replace("(anonymous namespace)", ""))
        name = found.group(1) if found else k[:40]
        per_call = us / count * max(1, round(count / iters)) / 1e3
        split[name] = split.get(name, 0.0) + per_call
    if sum(split.values()) > 0:
        how = "profiler" + (f", {partial} kernel(s) with events lost"
                            if partial else "")
        return sum(split.values()), how, split
    walls = []
    for body in (flushes, pairs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        body()
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
    return (walls[1] - walls[0]) / iters, "events less flush", {}


def _ms_list(named):
    return ", ".join(f"{k} {v:.4f} ms" for k, v in named.items())


# the paged kernel's served decode shapes (float32): qwen3-14b's (phase 4),
# gemma3-12b's sliding-window layers (phase 15, 40 of its 48 launches a
# step), recurrentgemma-2b's local layers (phase 18), olmoe-1b-7b's (phase
# 23), musicgen-large's (phase 24), nemotron-4-340b's (phase 25),
# paligemma-3b's (phase 27: 8/1 heads of 256, the first 16 columns of
# every row the shared prefix pages; full rows, 8.4 MB of k/v) and
# stablelm-12b's (phase 51: 32/8 heads of 160)
PAGED_SHAPES = {
    "qwen3-14b": dict(b=4, h=40, kv=8, d=128, page=16, n=64, p_phys=256,
                      lengths=[1024, 777, 513, 301]),
    "gemma3-12b": dict(b=4, h=16, kv=8, d=256, page=16, n=128, p_phys=512,
                       lengths=[1664, 1500, 1200, 1040], window=1024),
    "recurrentgemma-2b": dict(RGEMMA_DECODE,
                              lengths=[2600, 2400, 2200, 2100]),
    "olmoe-1b-7b": dict(b=4, h=16, kv=16, d=128, page=16, n=64, p_phys=256,
                        lengths=[1024, 777, 513, 301]),
    "musicgen-large": dict(b=4, h=32, kv=32, d=64, page=16, n=64,
                           p_phys=256, lengths=[1024, 777, 513, 301]),
    "nemotron-4-340b": dict(b=4, h=96, kv=8, d=192, page=16, n=64,
                            p_phys=256, lengths=[1024, 777, 513, 301]),
    "paligemma-3b": dict(b=4, h=8, kv=1, d=256, page=16, n=64, p_phys=256,
                         shared=16, lengths=[1024, 1024, 1024, 1024]),
    "stablelm-12b": dict(b=4, h=32, kv=8, d=160, page=16, n=64, p_phys=256,
                         lengths=[1024, 777, 513, 301]),
}


def _paged_timing(pa, args, flush, *, window=0, shared=0):
    """The paged kernel (float32) on one call's inputs ``args``: a call
    (CUDA events) and on the device (profiler), its plain version, one
    SDPA call over the same K/V gathered beforehand with the row's span as
    its mask (the yardstick), and the bound (``shared`` leading pages that
    every row maps are read once).  Returns (times, detail text)."""
    import torch.nn.functional as F
    b, h, d = args["q"].shape
    page, kv = args["k_pages"].shape[1:3]
    n = args["page_table"].shape[1]
    lengths = args["lengths"].tolist()
    kernel = lambda: pa.paged_attention(**args)
    ms = _time(kernel, 50, flush)
    dev_ms, how, names = _device_ms(kernel, 50, flush)
    plain_ms = _time(lambda: pa.paged_attention_plain(**args), 20, flush)

    t = n * page
    idx = args["page_table"].clamp_min(0).long()
    k = args["k_pages"][idx].reshape(b, t, kv, d).transpose(1, 2) \
        .contiguous()
    v = args["v_pages"][idx].reshape(b, t, kv, d).transpose(1, 2) \
        .contiguous()
    qs = args["q"][:, :, None, :]
    pos = torch.arange(t, device="cuda")[None, :]
    ln = args["lengths"][:, None].long()
    span = pos < ln
    if window:
        span &= pos >= ln - window
    mask = span[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=True)
    library_ms = _time(sdpa, 50, flush)
    lib_dev_ms, lib_how, lib_names = _device_ms(sdpa, 50, flush)

    rows = sum(min(x, window) if window else x for x in lengths)
    # a shared page is an input read once, however many rows map it
    spans = [min(x, shared * page) for x in lengths]
    read = rows - sum(spans) + max(spans)
    kv_bytes = 2 * read * kv * d * 4
    io_bytes = (b * h * d * 4 * 2 + b * n * 4        # q + out, mass
                + b * n * 4 + b * 4)                 # table, lengths
    flops = 4 * rows * h * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    text = (f"kernel {ms:.4f} ms a call (events), {dev_ms:.4f} ms on the "
            f"device ({how}: {_ms_list(names)}); plain {plain_ms:.4f} ms; "
            f"SDPA over pre-gathered K/V {library_ms:.4f} ms a call, "
            f"{lib_dev_ms:.4f} ms on the device ({lib_how}: "
            f"{_ms_list(lib_names)}); bound {bound_ms:.4f} ms ({bound_by}: "
            f"{rows} attended rows, {read} distinct, "
            f"{(kv_bytes + io_bytes) / 1e6:.2f} MB at 3.35 TB/s; "
            f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s) -> "
            f"{bound_ms / dev_ms * 100:.1f}% of the bound on the device, "
            f"{bound_ms / ms * 100:.1f}% a call")
    return dict(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                bound_by=bound_by), text


def phase_timing(pa):
    print("== phase 6: paged_attention timing at the served decode shapes",
          flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    before = pa.paged_attention.launches
    res = {}
    for model, case in PAGED_SHAPES.items():
        b, h, kv, d, page, n = (case[k] for k in ("b", "h", "kv", "d",
                                                  "page", "n"))
        window, lengths = case.get("window", 0), case["lengths"]
        args = _kernel_case(pa, dtype=torch.float32, seed=11, **case)
        out, mass = pa.paged_attention(**args)
        ref_o, ref_m = pa.paged_attention_plain(**args)
        err = max(float((out - ref_o).abs().max()),
                  float((mass - ref_m).abs().max()))
        if not err <= 1e-5:
            _fail(f"paged_attention at the {model} timed shape: err "
                  f"{err:.3g} against its plain version (tol 1e-5)")
        times, text = _paged_timing(pa, args, flush, window=window,
                                    shared=case.get("shared", 0))
        pps, splits, groups = _plan(pa, case)
        print(f"{model}: B={b} H={h} KV={kv} D={d} page={page} n={n} "
              f"window={window} lengths {lengths} float32, {pps} pages a "
              f"split x {splits} splits x {groups} head group(s) = "
              f"{b * kv * groups * splits} blocks (err "
              f"{err:.3g} vs plain): {text}", flush=True)
        if not times["ms"] < times["library_ms"]:
            _fail(f"paged_attention ({times['ms']:.4f} ms) is not below its "
                  f"SDPA yardstick ({times['library_ms']:.4f} ms) at the "
                  f"{model} shape")
        res[model] = dict(times, max_abs_err=err)
    pa.paged_attention.launches = before      # timing launches not counted
    return res


def _scan_kw(sim, cfg, num_pages, scheduler):
    return dict(predictive=(scheduler == "predictive"),
                capacity=cfg.fast_capacity(num_pages), lat_fast=cfg.lat_fast,
                lat_slow=cfg.lat_slow, bw_slow=cfg.bw_slow,
                bw_penalty=cfg.bw_penalty, mig_cost=cfg.mig_cost,
                period_overhead=cfg.period_overhead(num_pages),
                ema_alpha=cfg.ema_alpha)


def _sweep_stacks(sim, bins, periods):
    """What ``sim.sweep`` launches for ``periods``: [(ks, stack, nreals)],
    one per chunk, with ``nreals`` an int32 tensor on the card."""
    return [(ks, stack, torch.tensor(nr, dtype=torch.int32, device=DEV))
            for ks, stack, nr in sim.sweep_stacks(bins, periods)]


def phase_offline_kernels(ph, ss, sim, traces) -> dict:
    """page_hist / bin_trace / sim_scan against their plain versions."""
    print("== phase 7: offline kernels vs plain versions on the card",
          flush=True)
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst_ph = 0.0
    for rows, width, n in ((3277, 100, 4096), (4800, 100, 4096),
                           (1, 100, 512), (9, 1000, 1000), (5, 257, 300)):
        ids = torch.randint(-1, n, (rows, width), generator=g, device=dev,
                            dtype=torch.int32)
        ids[0, :3] = torch.tensor([n, n + 7, -3], dtype=torch.int32)
        hot = torch.rand((n,), generator=g, device=dev) * 3
        for alpha, thr in ((0.5, 1.0), (0.3, 0.7), (0.9, 2.5)):
            got = ph.page_hist(ids, hot, alpha=alpha, threshold=thr)
            torch.cuda.synchronize()
            ref = ph.page_hist_plain(ids, hot, alpha=alpha, threshold=thr)
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref))
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            worst_ph = max(worst_ph, err)
            if not same:
                _fail(f"page_hist [{rows}, {width}] over {n} pages, alpha "
                      f"{alpha}: differs from its plain version by {err}")
        print(f"page_hist ids [{rows}, {width}], {n} pages, alpha/threshold "
              f"grid of 3: bit-equal to the plain version", flush=True)
    for app in traces.available_traces():
        tr = traces.generate(app)
        bins = sim.bin_trace(tr)
        nb = bins.num_blocks
        ref = np.bincount(np.arange(len(tr.pages)) // bins.block * tr.num_pages
                          + tr.pages, minlength=nb * tr.num_pages)
        same = np.array_equal(bins.block_hist.cpu().numpy(),
                              ref.reshape(nb, tr.num_pages))
        print(f"bin_trace {app}: {len(tr.pages)} accesses, [{nb}, "
              f"{tr.num_pages}] ({nb * tr.num_pages * 4 / 1e6:.1f} MB) == "
              f"numpy bincount: {same}", flush=True)
        if not same:
            _fail(f"bin_trace({app}) differs from numpy's bincount")

    cfg = sim.SimConfig()
    cases = []
    bp = sim.bin_trace(traces.generate("backprop"))
    stacks = _sweep_stacks(sim, bp, sim.exhaustive_periods(bp, 96))
    longest = min(stacks, key=lambda st: min(st[0]))
    largest = max(stacks, key=lambda st: len(st[0]))
    cases += [("backprop longest candidate", bp, longest),
              ("backprop largest group", bp, largest)]
    rng = np.random.default_rng(7)
    toy_tr = traces.Trace("toy", rng.integers(0, 20, 3000).astype(np.int64),
                          20, np.asarray([50]))
    toy = sim.bin_trace(toy_tr, block=50)
    toy_periods = [100, 250, 600, 1500]
    cases += [("toy 20 pages", toy, st)
              for st in _sweep_stacks(sim, toy, toy_periods)]
    for sched in ("reactive", "predictive"):
        for label, bins, (ks, stack, nreals) in cases:
            kw = _scan_kw(sim, cfg, bins.num_pages, sched)
            init = torch.from_numpy(sim._interleaved_init(
                bins.num_pages, kw["capacity"])).to(dev)
            t0 = time.monotonic()
            got = ss.sim_scan(stack, nreals, init, **kw)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            ref = ss.sim_scan_plain(stack, nreals, init, **kw)
            torch.cuda.synchronize()
            t2 = time.monotonic()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            print(f"sim_scan {sched} {label}: {len(ks)} candidate(s) x "
                  f"{stack.shape[1]} periods (real {nreals.tolist()}), "
                  f"{bins.num_pages} pages: bit-equal {same} (runtime "
                  f"{got[0].tolist()}, swaps {got[1].tolist()}, hits "
                  f"{got[2].tolist()}); kernel {t1 - t0:.3f} s, plain "
                  f"{t2 - t1:.3f} s", flush=True)
            if not same:
                _fail(f"sim_scan differs from its plain version ({label}, "
                      f"{sched}): {got} vs {ref}")
        res = sim.sweep(toy, toy_periods, sched)
        for period, r in res.items():
            o = sim.simulate_reference(toy, period, sched)
            if (r.migrations, r.fast_hits) != (o.migrations, o.fast_hits) \
                    or abs(r.runtime - o.runtime) > 1e-5 * o.runtime:
                _fail(f"toy sweep {sched} at {period} disagrees with the "
                      f"numpy oracle: {r} vs {o}")
        print(f"toy sweep {sched} == numpy simulate_reference (migrations, "
              f"hits exact; runtime rtol 1e-5)", flush=True)
    return dict(page_hist=worst_ph, sim_scan=0.0)


def phase_offline_pipeline(sim, pipeline, traces, kernels, ph, ss) -> dict:
    """The paper's evaluation at full size, on the card."""
    print("== phase 8: the paper's offline Cori pipeline at full size",
          flush=True)
    apps, scheds = ("backprop", "lud", "kmeans"), ("reactive", "predictive")
    calls = {"simulate": 0, "sweep": 0}
    simulate, sweep = sim.simulate, sim.sweep

    def counting_simulate(*args, **kw):
        calls["simulate"] += 1
        return simulate(*args, **kw)

    def counting_sweep(bins, periods, *args, **kw):
        calls["sweep"] += len(sim.sweep_launches(bins, periods))
        return sweep(bins, periods, *args, **kw)

    sim.simulate, sim.sweep = counting_simulate, counting_sweep
    studies, base, walls = {}, [], []
    total = {"page_hist": 0, "sim_scan": 0}
    try:
        for app in apps:
            for sched in scheds:
                _reset_counts(kernels)
                calls.update(simulate=0, sweep=0)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                st = pipeline.study(app, sched)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                n_ph, n_ss = ph.page_hist.launches, ss.sim_scan.launches
                expect = calls["simulate"] + calls["sweep"]
                if n_ph != 1 or n_ss != expect:
                    _fail(f"{app}/{sched}: launches page_hist {n_ph} (want "
                          f"1), sim_scan {n_ss} (want {calls['simulate']} "
                          f"simulate + {calls['sweep']} sweep launches)")
                total["page_hist"] += n_ph
                total["sim_scan"] += n_ss
                studies[(app, sched)] = st
                walls.append(wall)
                gaps = st.table_i_slowdowns()
                worst = max(gaps, key=gaps.get)
                print(f"{app}/{sched}: optimal period {st.optimal_period:.0f}"
                      f" (runtime {st.optimal_runtime:.1f}), Cori chose "
                      f"{st.cori.chosen_period:.0f} after {st.cori.trials} "
                      f"trials (DR {st.cori.dominant_reuse:.0f}, "
                      f"trials-to-best {st.cori_trials_to_best}), slack vs "
                      f"optimal {st.cori_slowdown_vs_optimal * 100:.2f}%, "
                      f"worst Table-I gap {gaps[worst] * 100:.1f}% ({worst}); "
                      f"study wall {wall:.2f} s; launches page_hist {n_ph}, "
                      f"sim_scan {n_ss} = {calls['simulate']} simulate + "
                      f"{calls['sweep']} sweep launch(es)", flush=True)
            bins = sim.bin_trace(traces.generate(app))
            for sched in scheds:
                t0 = time.monotonic()
                b = pipeline.baseline_trials_all(bins, sched, seeds=3)
                base.extend(b.values())
                print(f"{app}/{sched} Eq.-3 baselines trials-to-best "
                      f"{b} in {time.monotonic() - t0:.2f} s", flush=True)
    finally:
        sim.simulate, sim.sweep = simulate, sweep
    slacks = [st.cori_slowdown_vs_optimal for st in studies.values()]
    worst_gaps = [max(st.table_i_slowdowns().values())
                  for st in studies.values()]
    near = None
    for st in studies.values():
        gaps = st.table_i_slowdowns()
        best = min(gaps.values())
        cell = {k for k, v in gaps.items() if v <= best + 0.01}
        near = cell if near is None else near & cell
    cori_trials = [st.cori_trials_to_best for st in studies.values()]
    ratio = float(np.mean(base) / np.mean(cori_trials))
    print(f"claims: mean slack {np.mean(slacks) * 100:.2f}% (bar 5%), max "
          f"{max(slacks) * 100:.2f}% (bar 15%); worst Table-I gap per cell "
          f"{[round(g * 100, 1) for g in worst_gaps]}% (bars >= 10% each, "
          f">= 80% somewhere); Table-I values near-best everywhere: "
          f"{sorted(near)} (bar: none); trials-to-best Cori "
          f"{np.mean(cori_trials):.2f} (bar <= 8) vs baselines "
          f"{np.mean(base):.2f}: {ratio:.2f}x (bar >= 3x); study wall "
          f"mean {np.mean(walls):.2f} s, max {max(walls):.2f} s", flush=True)
    if not (np.mean(slacks) <= 0.05 and max(slacks) <= 0.15):
        _fail("Cori is not within the slack bars of optimal")
    if min(worst_gaps) < 0.10 or max(worst_gaps) < 0.80:
        _fail("the Table-I gap bars do not hold")
    if near:
        _fail(f"a single Table-I value is near-best everywhere: {near}")
    if ratio < 3.0 or np.mean(cori_trials) > 8.0:
        _fail("Cori does not need several-fold fewer trials")
    return dict(launches=total, slack_mean=float(np.mean(slacks)),
                slack_max=max(slacks), trials_ratio=ratio,
                study_wall_mean_s=float(np.mean(walls)))


def _time_once(fn, flush_buf):
    """ms of one call (CUDA events, L2 flushed before it)."""
    flush_buf.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_offline_timing(ph, ss, sim, traces, kernels) -> dict:
    print("== phase 9: offline kernel timing at the main-path shapes",
          flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    before = {k.NAME: getattr(k, k.NAME).launches for k in kernels}
    tr = traces.generate("backprop")
    n, block = tr.num_pages, sim.DEFAULT_BLOCK
    rows = -(-len(tr.pages) // block)
    ids = np.full(rows * block, -1, np.int32)
    ids[: len(tr.pages)] = tr.pages
    ids = torch.from_numpy(ids).to(DEV).reshape(rows, block)
    zeros = torch.zeros((n,), device=DEV)
    ms = _time(lambda: ph.page_hist(ids, zeros), 20, flush)
    dev_ms, how, _ = _device_ms(lambda: ph.page_hist(ids, zeros), 20, flush)
    plain_ms = _time(lambda: ph.page_hist_plain(ids, zeros), 20, flush)
    flat = (torch.arange(rows, device=DEV)[:, None] * n
            + ids.long())[ids >= 0]
    library_ms = _time(lambda: torch.bincount(flat, minlength=rows * n), 20,
                       flush)
    nbytes = rows * block * 4 + n * 4 + rows * n * (4 + 4 + 1)
    flops = 3 * rows * n + rows * block
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    hist = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"page_hist ids [{rows}, {block}] over {n} pages (backprop's "
          f"bin_trace): kernel {ms:.4f} ms a call, {dev_ms:.4f} ms on the "
          f"device ({how}), plain {plain_ms:.4f} ms, one torch.bincount "
          f"(counts only) {library_ms:.4f} ms, bound "
          f"{hist['bound_ms']:.4f} ms ({hist['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB at 3.35 TB/s; {flops / 1e6:.1f} MFLOP at "
          f"67 TFLOP/s) -> {hist['bound_ms'] / dev_ms * 100:.1f}% of the "
          f"bound on the device, {hist['bound_ms'] / ms * 100:.1f}% a call",
          flush=True)

    bins = sim.bin_trace(tr)
    cfg = sim.SimConfig()
    kw = _scan_kw(sim, cfg, n, "reactive")
    init = torch.from_numpy(sim._interleaved_init(n, kw["capacity"])).to(DEV)
    periods = sim.exhaustive_periods(bins, 96)
    stacks = _sweep_stacks(sim, bins, periods)
    groups = list(sim.sweep_groups(bins, periods))
    longest = min(stacks, key=lambda st: min(st[0]))
    one = longest[1][:1].contiguous()              # its candidate alone
    one_nr = longest[2][:1].contiguous()

    def one_launch():                  # the sweep as ``sim.sweep`` runs it
        return [ss.sim_scan_rows(rows, starts, nreals, init, **kw)
                for _, rows, starts, nreals in groups]

    def loop_sweep():                  # one launch per ``sweep_plan`` chunk
        return [ss.sim_scan(stack, nreals, init, **kw)
                for _, stack, nreals in stacks]

    def plain_sweep():
        return [ss.sim_scan_plain(stack, nreals, init, **kw)
                for _, stack, nreals in stacks]

    def by_k(out, ks_of):
        res = {}
        for ks, (rt, sw, fh) in zip(ks_of, out):
            for j, k in enumerate(ks):
                res[k] = (rt[j].item(), sw[j].item(), fh[j].item())
        return res

    got = by_k(one_launch(), [g[0] for g in groups])
    loop = by_k(loop_sweep(), [st[0] for st in stacks])
    plain_out = []
    plain_sweep_ms = _time_once(lambda: plain_out.append(plain_sweep()),
                                flush)
    plain = by_k(plain_out[0], [st[0] for st in stacks])
    same_plain = bool(got) and got == plain
    same_loop = got == loop
    one_ms = [_time_once(one_launch, flush) for _ in range(3)]
    loop_ms = [_time_once(loop_sweep, flush) for _ in range(3)]
    alone_ms = [_time_once(lambda: ss.sim_scan(one, one_nr, init, **kw),
                           flush) for _ in range(3)]
    real = sum(sum(g[3]) for g in groups)
    cands = sum(len(g[0]) for g in groups)
    serial = max(max(g[3]) for g in groups)      # one launch: the longest
    serial_loop = sum(int(nr.max()) for _, _, nr in stacks)
    nbytes = real * n * 4 + n + cands * (4 + 8 + 3 * 4)
    flops = 10 * real * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    ms = float(np.mean(one_ms))
    scan = dict(ms=ms, plain_ms=plain_sweep_ms, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                launches_per_sweep=len(groups),
                loop_ms=float(np.mean(loop_ms)), loop_launches=len(stacks),
                longest_ms=float(np.mean(alone_ms)), serial_periods=serial,
                loop_serial_periods=serial_loop,
                us_per_period=float(np.mean(alone_ms)) * 1e3 / serial)
    print(f"sim_scan over backprop's exhaustive sweep (reactive): {cands} "
          f"candidates, {real} real period rows of {n} pages.  One launch "
          f"as sim.sweep runs it ({len(groups)} launch(es), serial path "
          f"{serial} periods): {ms:.3f} ms (runs "
          f"{[round(t, 3) for t in one_ms]}); the {len(stacks)}-launch "
          f"per-chunk loop (serial path {serial_loop} periods): "
          f"{scan['loop_ms']:.3f} ms (runs "
          f"{[round(t, 3) for t in loop_ms]}); the longest candidate alone "
          f"({serial} periods): {scan['longest_ms']:.3f} ms = "
          f"{scan['us_per_period']:.3f} us per serial period; plain "
          f"{plain_sweep_ms:.1f} ms; library none; bound "
          f"{scan['bound_ms']:.4f} ms ({scan['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.2f} GFLOP at "
          f"67 TFLOP/s) -> {scan['bound_ms'] / ms * 100:.2f}% of the bound "
          f"in one launch, {scan['bound_ms'] / scan['loop_ms'] * 100:.2f}% "
          f"in the loop; one launch bit-equal to the plain sweep "
          f"{same_plain}, to the per-chunk loop {same_loop}", flush=True)
    if not (same_plain and same_loop):
        _fail("the one-launch sweep differs from the plain sweep or the "
              "per-chunk loop")
    for k in kernels:                          # timing launches not counted
        getattr(k, k.NAME).launches = before[k.NAME]
    return dict(page_hist=hist, sim_scan=scan)


# ---------------------------------------------------------------------------
# MLA + MoE: deepseek-v3-671b
# ---------------------------------------------------------------------------

# the MLA kernel's shape on the serving path at full width
MLA_MAIN = dict(b=4, h=128, r=512, k=64, page=16, n=64, p_phys=256)


def _mla_case(*, b, h, r, k, page, n, p_phys, lengths, dtype, holes=(),
              seed=0):
    """Random MLA operands on the card; rows padded with -1 past their
    length, and -1 at each (row, first page, last page) of ``holes``.
    ``scale`` is deepseek's 1/sqrt(128 + 64)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=g, device=DEV).to(dtype)
    table = torch.randperm(p_phys, generator=g, device=DEV)[: b * n] \
        .reshape(b, n).to(torch.int32)
    for row, length in enumerate(lengths):
        table[row, -(-length // page):] = -1
    for row, lo, hi in holes:
        table[row, lo:hi] = -1
    return dict(q_abs=f(b, h, r), q_rope=f(b, h, k),
                ckv_pages=f(p_phys, page, r), krope_pages=f(p_phys, page, k),
                page_table=table,
                lengths=torch.tensor(lengths, dtype=torch.int32, device=DEV),
                scale=1.0 / math.sqrt(192))


# where the kernel's split over pages can go wrong, at the served widths
# (``mla_split_plan``: 8 pages a split at n=64, 7 at n=50, whose last split
# holds one page): spans ending on a split boundary (128 tokens), one past
# it, inside the first tile and inside a page; -1 slots inside a split, a
# split of -1 slots only, a row whose splits are all empty but one; n not a
# multiple of the split; a length-0 row; pages of 48 tokens that straddle
# the kernel's 32-token tiles, with a partial last head group (40 heads)
MLA_SPLIT_EDGES = [
    dict(MLA_MAIN, lengths=[128, 129, 1, 1024],
         holes=[(0, 3, 4), (3, 8, 16)]),
    dict(MLA_MAIN, lengths=[1024, 777, 1000, 16],
         holes=[(2, 0, 16), (2, 24, 64)]),
    dict(MLA_MAIN, n=50, lengths=[800, 112, 113, 0], holes=[(0, 48, 49)]),
    dict(MLA_MAIN, n=50, lengths=[799, 17, 785, 33], holes=[(2, 0, 49)]),
    dict(b=4, h=40, r=256, k=64, page=48, n=12, p_phys=64,
         lengths=[576, 333, 0, 49], holes=[(1, 2, 3)]),
]


def phase_mla_check(pam) -> float:
    """The MLA kernel vs its plain version: the main-path shape, a grid,
    the edges of the split over pages (``MLA_SPLIT_EDGES``), float32 and
    bfloat16 (each output row also within ``BF16_ROW_TOL`` of its norm),
    and a repeat of every call bit-identical; returns the largest float32
    error seen."""
    print("== phase 10: paged_attention_mla vs plain version on the card",
          flush=True)
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-5)}
    grid = [dict(MLA_MAIN, lengths=[1024, 777, 0, 301]),
            dict(MLA_MAIN, h=16, lengths=[1024, 5, 513, 0]),
            dict(b=3, h=128, r=512, k=64, page=16, n=6, p_phys=32,
                 lengths=[96, 37, 1]),
            dict(b=3, h=16, r=512, k=64, page=16, n=6, p_phys=32,
                 lengths=[0, 17, 80])] + MLA_SPLIT_EDGES
    worst_f32 = 0.0
    for i, case in enumerate(grid):
        for dtype in (torch.float32, torch.bfloat16):
            args = _mla_case(dtype=dtype, seed=100 + i, **case)
            out, mass = pam.paged_attention_mla(**args)
            again = pam.paged_attention_mla(**args)
            torch.cuda.synchronize()
            same = torch.equal(out, again[0]) and torch.equal(mass, again[1])
            ref_o, ref_m = pam.paged_attention_mla_plain(**args)
            err_o = float((out.float() - ref_o.float()).abs().max())
            err_m = float((mass - ref_m).abs().max())
            row = 0.0 if dtype == torch.float32 else _row_err(out, ref_o)
            active = args["lengths"] > 0
            err_sum = float((mass.sum(dim=1)[active] - 1).abs().max())
            t_o, t_m = tol[dtype]
            ok = (err_o <= t_o and err_m <= t_m and err_sum <= 1e-5
                  and row <= BF16_ROW_TOL and same and out.dtype == dtype)
            print(f"case {i} {str(dtype)[6:]} B={case['b']} H={case['h']} "
                  f"R={case['r']} K={case['k']} page={case['page']} "
                  f"n={case['n']} lengths {case['lengths']} holes "
                  f"{case.get('holes', [])}: out err {err_o:.3g} (tol "
                  f"{t_o}), row err {row:.3g} of its norm (tol "
                  f"{BF16_ROW_TOL:.4g} in bfloat16), mass err {err_m:.3g} "
                  f"(tol {t_m}), |row mass sum - 1| {err_sum:.3g} (tol "
                  f"1e-5), repeat bit-identical {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                _fail(f"paged_attention_mla disagrees with its plain version "
                      f"or with itself (case {i})")
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err_o, err_m)
            if not bool(torch.all(mass[~active] == 0)) \
                    or not bool(torch.all(out[~active] == 0)):
                _fail("a length-0 row must give zeros")
    return worst_f32


def deepseek_cut(C):
    """deepseek-v3-671b at full width, its depth cut from 61 layers to
    one dense-MLP MLA layer and one MoE MLA layer."""
    cfg = C.get("deepseek-v3-671b")
    return dataclasses.replace(
        cfg, segments=((("attn.mla",), 1), (("attn.mla.moe",), 1)))


def phase_deepseek(C, mdl, pa, pam, re_, S, memtier, cori, telemetry,
                   kernels):
    print("== phase 11: full-width deepseek-v3-671b serving (MLA + MoE, "
          "macro-step batcher)", flush=True)
    full = C.get("deepseek-v3-671b")
    cfg = deepseek_cut(C)
    mo, m = cfg.moe, cfg.mla
    expert_gb = cfg.d_model * mo.d_expert * 3 * mo.num_experts * 4 / 1e9
    print(f"reduced: depth {full.num_layers} -> {cfg.num_layers} layers "
          f"(segments {cfg.segments}), widths unchanged: one MoE layer is "
          f"{expert_gb:.1f} GB of float32 experts, so the 2 layers and the "
          f"embeddings ({cfg.param_count() * 4 / 1e9:.1f} GB) are what "
          f"fits one 80 GB card beside the pools", flush=True)
    left = torch.cuda.memory_allocated()
    if left > 2e9:
        _fail(f"{left / 1e9:.2f} GB still allocated before deepseek's init")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = mdl.init(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"init: {cfg.name}, d_model {cfg.d_model}, {cfg.num_heads} heads, "
          f"MLA ranks q {m.q_lora_rank} / kv {m.kv_lora_rank} / rope "
          f"{m.qk_rope_dim}, d_ff {cfg.d_ff}, {mo.num_experts} experts "
          f"top-{mo.top_k} of {mo.d_expert} + {mo.num_shared} shared, vocab "
          f"{cfg.vocab_size}: {n_params / 1e9:.3f} B float32 params in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    def check(b, result, eager):
        result["launches"] = pam.paged_attention_mla.launches
        result["routed_launches"] = re_.routed_experts.launches
        _check_launches("paged_attention_mla", result["launches"],
                        cfg.num_layers, b, eager)
        _check_launches("routed_experts", result["routed_launches"],
                        _moe_layers(mdl, cfg), b, eager)
        kv_launches = pa.paged_attention.launches
        print(f"k/v paged_attention launches {kv_launches}", flush=True)
        if kv_launches:
            _fail("the k/v kernel ran in an MLA model")

    results, _ = _serve_routes(params, cfg, S, memtier, cori, telemetry,
                               kernels, check)
    held = torch.cuda.memory_allocated()
    del params
    _check_freed(held)
    return results


def _moe_layers(mdl, cfg) -> int:
    return sum(r for *_, r, _, k in mdl.state_slot_meta(cfg) if k.moe)


def phase_deepseek_parity(C, mdl, S, memtier, cori, engine):
    print("== phase 12: parity on the card (reduced deepseek-v3-671b and "
          "olmoe-1b-7b, float32)", flush=True)
    for name in ("deepseek-v3-671b", "olmoe-1b-7b"):
        print(f"reduced {name}:", flush=True)
        _parity(dataclasses.replace(C.reduced(name), dtype="float32"), mdl,
                S, memtier, cori, engine)


def phase_mla_timing(pam):
    """The MLA kernel at the main-path shape (float32): per call (CUDA
    events) and on the device (profiler), beside its plain version, one
    SDPA call over the gathered rows (the yardstick, which the kernel must
    beat a call) and its bound: operations as 3xTF32 (three TF32 passes at
    495 TFLOP/s), with the floor at ``mma.sync``'s measured TF32 rate and
    the 67 TFLOP/s CUDA-core figure beside it."""
    print("== phase 13: paged_attention_mla timing at the main-path shape",
          flush=True)
    import torch.nn.functional as F
    c = MLA_MAIN
    b, h, r, k, page, n = c["b"], c["h"], c["r"], c["k"], c["page"], c["n"]
    lengths = [1024, 777, 513, 301]
    args = _mla_case(lengths=lengths, dtype=torch.float32, **c)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    before = pam.paged_attention_mla.launches
    out, mass = pam.paged_attention_mla(**args)
    ref_o, ref_m = pam.paged_attention_mla_plain(**args)
    err = max(float((out - ref_o).abs().max()),
              float((mass - ref_m).abs().max()))
    if not err <= 1e-5:
        _fail(f"paged_attention_mla at the timed shape: err {err:.3g} "
              f"against its plain version (tol 1e-5)")
    kernel = lambda: pam.paged_attention_mla(**args)
    ms = _time(kernel, 50, flush)
    dev_ms, how, names = _device_ms(kernel, 50, flush)
    plain_ms = _time(lambda: pam.paged_attention_mla_plain(**args), 20, flush)
    pam.paged_attention_mla.launches = before  # timing launches not counted

    # yardstick: one SDPA call over the same rows, gathered beforehand:
    # q = q_abs ++ q_rope, k = ckv ++ krope (one KV head), v = ckv
    t = n * page
    idx = args["page_table"].clamp_min(0).long()
    ckv = args["ckv_pages"][idx].reshape(b, 1, t, r)
    kr = args["krope_pages"][idx].reshape(b, 1, t, k)
    kk = torch.cat([ckv, kr], dim=-1).contiguous()
    qq = torch.cat([args["q_abs"], args["q_rope"]], dim=-1)[:, :, None, :]
    mask = (torch.arange(t, device=DEV)[None, :]
            < args["lengths"][:, None].long())[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(
        qq, kk, ckv, attn_mask=mask, scale=args["scale"], enable_gqa=True)
    library_ms = _time(sdpa, 50, flush)
    lib_dev_ms, lib_how, _ = _device_ms(sdpa, 20, flush)

    tokens = sum(lengths)
    row_bytes = tokens * (r + k) * 4
    io_bytes = (b * h * (r + k) * 4 + b * h * r * 4      # q, out
                + 2 * b * n * 4 + b * 4)                 # mass, table, lens
    flops = 2 * (r + k + r) * h * tokens
    t_bytes = (row_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3
    mma_ms = 3 * flops / MMA_SYNC_TF32_FLOPS_PER_S * 1e3
    cuda_core_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    hb = pam.HEADS_PER_BLOCK
    pps, splits = pam.mla_split_plan(n, page, b, h)
    print(f"B={b} H={h} R={r} K={k} page={page} n={n} lengths {lengths} "
          f"float32, {hb} heads a block, {pps} pages a split x {splits} "
          f"splits = {b * -(-h // hb) * splits} blocks (err {err:.3g} vs "
          f"plain): kernel {ms:.4f} ms a call, {dev_ms:.4f} ms on the "
          f"device ({how}: {_ms_list(names)}); plain {plain_ms:.4f} ms; "
          f"SDPA over pre-gathered rows {library_ms:.4f} ms a call, "
          f"{lib_dev_ms:.4f} ms on the device ({lib_how}); bound "
          f"{bound_ms:.4f} ms ({bound_by}; 3xTF32: 3 x {flops / 1e9:.3f} "
          f"GFLOP at 495 TFLOP/s -> {t_ops:.4f} ms; bytes "
          f"{(row_bytes + io_bytes) / 1e6:.2f} MB -> {t_bytes:.4f} ms at "
          f"3.35 TB/s) -> {bound_ms / dev_ms * 100:.1f}% of the bound on "
          f"the device, {bound_ms / ms * 100:.1f}% a call; mma.sync floor "
          f"(TF32 at {MMA_SYNC_TF32_FLOPS_PER_S / 1e12:.1f} TFLOP/s) "
          f"{mma_ms:.4f} ms; CUDA-core float32 figure (67 TFLOP/s) "
          f"{cuda_core_ms:.4f} ms", flush=True)
    if not ms < library_ms:
        _fail(f"paged_attention_mla ({ms:.4f} ms) is not below its SDPA "
              f"yardstick ({library_ms:.4f} ms) a call")
    return dict(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


# ---------------------------------------------------------------------------
# flash prefill: gemma3-12b (sliding window)
# ---------------------------------------------------------------------------

# the flash kernel's shape on the serving path at full width: one packed
# admission of four gemma3-12b prompts, bucketed to 2048 positions
FLASH_MAIN = dict(b=4, s=2048, h=16, kv=8, d=256)
# musicgen-large's prefill (phase 24): an admission packs up to 4 prompts of
# 128-512 tokens into 512 positions, 32 query heads over 32 KV heads of 64
MUSICGEN_PREFILL = dict(b=4, s=512, h=32, kv=32, d=64)
# stablelm-12b's (phase 51) and nemotron-4-340b's (phase 25): the same
# packing, 32 query heads over 8 KV heads of 160 and 96 over 8 of 192
STABLELM_PREFILL = dict(b=4, s=512, h=32, kv=8, d=160)
NEMOTRON_PREFILL = dict(b=4, s=512, h=96, kv=8, d=192)
# the served cell's access threshold: under near-uniform attention (random
# weights) a page inside the 1024-token window draws about (40/48)/64 +
# (8/48)/n ~ 0.015 of its row's layer-averaged mass and a page outside it
# (8/48)/n <= 0.0026 (n = 66-104 pages a row); 0.01 sits between, so a
# page counts as accessed while it is inside the window.  The default 0.05
# is set for rows of a few tens of pages, and no page of these rows
# reaches it.
GEMMA_ACCESS_THRESHOLD = 0.01
# full-width last-position logits, flash route vs reference route: float32
# summation order over 48 layers
GEMMA_LOGIT_TOL = 1e-3
# the flash kernel's bfloat16 outputs, beside the 2e-2 absolute bar: each
# output row (b, i, h) within 2^-6 of its norm.  Rounding the output to
# bfloat16 moves an element by at most one ulp, <= 2^-7 of it, and p rounded
# against a running (kernel) or final (plain) row max adds far less; on
# rows of many keys |out| is small, and 2e-2 alone would pass a kv tile
# dropped or counted twice.
BF16_ROW_TOL = 2.0 ** -6


def _flash_case(*, b, s, h, kv, d, dtype, seed=0):
    """Random q [B, S, H, D] and k/v [B, S, KV, D] on the card."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=g, device=DEV).to(dtype)
    return f(b, s, h, d), f(b, s, kv, d), f(b, s, kv, d)


# an admission chunk of phase 33 (gemma3-12b, admit_chunk_tokens=512): B=1,
# S=512 queries over the keys so far, 16/8 heads of 256, at the starts the
# served prompts (1040-1600 tokens) reach
FLASH_CHUNK = dict(b=1, s=512, h=16, kv=8, d=256)
FLASH_CHUNK_STARTS = (0, 512, 1024, 1536)


def _flash_offset_case(*, b, s, t, h, kv, d, dtype, seed=0):
    """Random q [B, S, H, D] and k/v [B, T, KV, D] on the card."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=g, device=DEV).to(dtype)
    return f(b, s, h, d), f(b, t, kv, d), f(b, t, kv, d)


def _row_err(out, ref) -> float:
    """The largest ||out - ref|| / ||ref|| over the rows of the last dim."""
    e = (out.float() - ref.float()).norm(dim=-1)
    return float((e / ref.float().norm(dim=-1).clamp_min(1e-30)).max())


def phase_flash_check(fa) -> float:
    """The flash kernel vs its plain version over the grid; returns the
    largest float32 error seen."""
    print("== phase 14: flash_attention vs plain version on the card",
          flush=True)
    # float32: summation order only, longer sums drift further; bfloat16:
    # p is rounded to bfloat16 against a running (kernel) or final (plain)
    # row max
    tol = lambda dtype, s: (2e-2 if dtype == torch.bfloat16
                            else 2e-5 if s <= 512 else 1e-4)
    grid = [dict(b=2 if s < 2048 else 1, s=s, h=h, kv=kv, d=d, dtype=dtype,
                 masks=((True, 0), (True, 64), (True, 1024), (False, 0)))
            for dtype in (torch.float32, torch.bfloat16)
            for h, kv in ((4, 4), (4, 2), (8, 1), (16, 8), (40, 8))
            for d in fa.HEAD_DIMS for s in (1, 37, 256, 2048)]
    # the shapes the served path gives the kernel: phase 15's admissions
    # pack 4 and then 2 gemma3-12b prompts into 2048 positions (float32;
    # bfloat16 as item 13b's residual stream will)
    grid += [dict(FLASH_MAIN, b=b, dtype=dtype,
                  masks=((True, 0), (True, 1024)))
             for dtype in (torch.float32, torch.bfloat16)
             for b in (FLASH_MAIN["b"], 2)]
    # and phases 24, 51 and 25's: musicgen-large's, stablelm-12b's and
    # nemotron-4-340b's admissions of 4, 2 and 1 prompts
    grid += [dict(c, b=b, dtype=dtype, masks=((True, 0),))
             for c in (MUSICGEN_PREFILL, STABLELM_PREFILL, NEMOTRON_PREFILL)
             for dtype in (torch.float32, torch.bfloat16) for b in (4, 2, 1)]
    worst, worst_f32, worst_row, n_cases = {}, 0.0, {}, 0
    for c in grid:
        b, s, h, kv, d, dtype = (c[k] for k in ("b", "s", "h", "kv", "d",
                                                 "dtype"))
        args = _flash_case(b=b, s=s, h=h, kv=kv, d=d, dtype=dtype,
                           seed=b + s + h + kv + d)
        for causal, window in c["masks"]:
            out = fa.flash_attention(*args, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(*args, causal=causal,
                                           window=window)
            err = float((out.float() - ref.float()).abs().max())
            n_cases += 1
            key = (str(dtype)[6:], s)
            worst[key] = max(worst.get(key, 0.0), err)
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err)
            row = (_row_err(out, ref) if dtype == torch.bfloat16
                   else 0.0)
            worst_row[key] = max(worst_row.get(key, 0.0), row)
            if not (err <= tol(dtype, s) and row <= BF16_ROW_TOL) \
                    or out.dtype != dtype:
                _fail(f"flash_attention disagrees with its plain version: "
                      f"{str(dtype)[6:]} B={b} H={h} KV={kv} D={d} S=T={s} "
                      f"causal={causal} window={window}: err {err:.3g} (tol "
                      f"{tol(dtype, s)}), row err {row:.3g} of its norm "
                      f"(bfloat16 tol {BF16_ROW_TOL})")
    for (dt, s), err in worst.items():
        row = (f"; worst row err {worst_row[dt, s]:.3g} of its norm (tol "
               f"{BF16_ROW_TOL})" if dt == "bfloat16" else "")
        print(f"{dt} S=T={s}: worst err {err:.3g} (tol "
              f"{tol(getattr(torch, dt), s)}){row} ok", flush=True)
    # the query offset (phase 33's chunks): S=512 at each served start and
    # at 496 (no multiple of the kernel's 32-key tile), and S=1 at the last
    # position, causal and window 1024; the tolerance of T keys
    c = FLASH_CHUNK
    offsets = [(c["s"], st) for st in FLASH_CHUNK_STARTS + (496,)] \
        + [(1, 2047)]
    for dtype in (torch.float32, torch.bfloat16):
        for s, start in offsets:
            t = start + s
            args = _flash_offset_case(b=c["b"], s=s, t=t, h=c["h"],
                                      kv=c["kv"], d=c["d"], dtype=dtype,
                                      seed=start + s)
            for window in (0, 1024):
                out = fa.flash_attention(*args, window=window,
                                         q_offset=start)
                torch.cuda.synchronize()
                ref = fa.flash_attention_plain(*args, window=window,
                                               q_offset=start)
                err = float((out.float() - ref.float()).abs().max())
                row = _row_err(out, ref) if dtype == torch.bfloat16 else 0.0
                n_cases += 1
                if dtype == torch.float32:
                    worst_f32 = max(worst_f32, err)
                print(f"{str(dtype)[6:]} B=1 S={s} q_offset={start} T={t} "
                      f"16/8 heads D=256 "
                      f"{'window 1024' if window else 'causal'}: err "
                      f"{err:.3g} (tol {tol(dtype, t)})"
                      + (f", row err {row:.3g}" if row else ""), flush=True)
                if not (err <= tol(dtype, t) and row <= BF16_ROW_TOL) \
                        or out.dtype != dtype:
                    _fail(f"flash_attention with q_offset={start} disagrees "
                          f"with its plain version: {str(dtype)[6:]} S={s} "
                          f"T={t} window={window}: err {err:.3g} (tol "
                          f"{tol(dtype, t)}), row err {row:.3g}")
    print(f"{n_cases} cases (GQA 4/4, 4/2, 8/1, 16/8, 40/8; D "
          f"{', '.join(map(str, fa.HEAD_DIMS))}; causal, window 64, window "
          f"1024, non-causal; and the served shapes B=4 and 2, S=T=2048, "
          f"16/8 heads, D=256, float32 and bfloat16, causal and window "
          f"1024, and B=4, 2 and 1, S=T=512, causal, 32/32 heads of 64, "
          f"32/8 of 160 and 96/8 of 192; and the chunk shapes with a query "
          f"offset): worst float32 error {worst_f32:.3g}", flush=True)
    return worst_f32


def _check_flash_launches(fa, cfg, result) -> int:
    """The flash kernel's launches in a served mix, which must be one a
    layer for each admission (every admission's packed prefill runs every
    layer once); returns them."""
    launches = fa.flash_attention.launches
    adm = result["admissions"]
    print(f"flash_attention launches {launches} = {cfg.num_layers} "
          f"layers x {adm} admissions -> "
          f"{launches == cfg.num_layers * adm}", flush=True)
    if launches != cfg.num_layers * adm or adm <= 0:
        _fail(f"the flash kernel's launches do not match "
              f"{cfg.num_layers} x the admissions")
    return launches


def _check_cori_acted(b) -> None:
    """The Cori loop acted in a served mix: hits counted and the tuner out
    of its profile window."""
    mgr, tuner = b.monitor.manager, b.monitor.tuner
    if mgr.hits <= 0 or tuner.dominant_reuse is None:
        _fail(f"the Cori loop did not act: {mgr.hits} hits, dominant "
              f"reuse {tuner.dominant_reuse} (the tuner never left "
              "profile)")


def _flash_route_check(fa, pa, cfg):
    """A ``_serve_routes`` check for a config served under
    ``attention_impl="pallas"``: the flash kernel's launches one a layer
    an admission, the paged kernel's one a layer a device step."""
    def check(b, result, eager):
        result["flash_launches"] = _check_flash_launches(fa, cfg, result)
        result["launches"] = pa.paged_attention.launches
        _check_launches("paged_attention", result["launches"],
                        cfg.num_layers, b, eager)
    return check


def _first_admission(S, reqs, joiners):
    """The (tokens, lengths, joiners) that the first admission's
    ``prefill_batched`` call took: its ``joiners`` requests (the queue's
    head, in arrival order) packed by the batcher's own ``pack_prompts``."""
    toks, lens = S.pack_prompts([r.prompt for r in reqs[:joiners]])
    return (torch.as_tensor(toks, device=DEV),
            torch.as_tensor(lens, device=DEV), joiners)


def phase_gemma(C, mdl, pa, fa, S, memtier, cori, telemetry, kernels):
    """Serve full-width gemma3-12b with flash prefill; returns (result,
    params, ``_first_admission``, the graph route's streams)."""
    print("== phase 15: full-width gemma3-12b serving (sliding window, "
          "flash prefill, macro-step batcher)", flush=True)
    cfg = dataclasses.replace(C.get("gemma3-12b"), attention_impl="pallas")
    left = torch.cuda.memory_allocated()
    if left > 2e9:
        _fail(f"{left / 1e9:.2f} GB still allocated before gemma3's init")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = mdl.init(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    windows = [w for *_, w, _ in mdl.state_slot_meta(cfg)]
    print(f"init: {cfg.name}, {cfg.num_layers} layers (pattern windows "
          f"{windows} x {cfg.segments[0][1]}), d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied embeddings: "
          f"{n_params / 1e9:.3f} B float32 params ({n_params * 4 / 1e9:.2f} "
          f"GB) in {time.monotonic() - t0:.1f} s; attention_impl "
          f"{cfg.attention_impl}", flush=True)

    streams = {}

    def check(b, result, eager):
        result["launches"] = _check_flash_launches(fa, cfg, result)
        result["paged_launches"] = pa.paged_attention.launches
        _check_launches("paged_attention", result["paged_launches"],
                        cfg.num_layers, b, eager)
        if not eager:
            streams.update((r.rid, list(r.tokens)) for r in b.completed)
        _check_cori_acted(b)

    results, reqs = _serve_routes(
        params, cfg, S, memtier, cori, telemetry, kernels, check,
        n_logical=512, hbm_pages=384, max_len=2048, n_req=6,
        prompt=(1040, 1601), new=(32, 65),
        access_threshold=GEMMA_ACCESS_THRESHOLD)
    first = _first_admission(S, reqs, results["graph"]["first_joiners"])
    print(f"first admission: {first[2]} joiners packed as "
          f"{tuple(first[0].shape)}, lengths {first[1].tolist()}",
          flush=True)
    return results, params, first, streams


def phase_gemma_parity(C, mdl, S, memtier, cori, engine, params, first):
    print("== phase 16: parity on the card (gemma3-12b: reduced streams, "
          "full-width prefill)", flush=True)
    small = dataclasses.replace(C.reduced("gemma3-12b"), dtype="float32")
    streams = {}
    for impl in ("reference", "pallas"):
        print(f"reduced gemma3-12b (window {small.window_size}), "
              f"attention_impl {impl}:", flush=True)
        streams[impl] = _parity(dataclasses.replace(
            small, attention_impl=impl), mdl, S, memtier, cori, engine)
    same = streams["pallas"] == streams["reference"]
    print(f"generate's greedy streams, pallas == reference: {same}",
          flush=True)
    if not same:
        _fail(f"the flash route's streams {streams['pallas']} differ from "
              f"the reference route's {streams['reference']}")

    cfg = C.get("gemma3-12b")
    toks, lens, rows = first
    last = {}
    with torch.no_grad():
        for impl in ("pallas", "reference"):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits = mdl.prefill_batched(
                params, dataclasses.replace(cfg, attention_impl=impl), toks,
                lens)[0]          # the cache rows go at once
            torch.cuda.synchronize()
            last[impl] = logits[:, 0].float()
            print(f"full-width prefill_batched {tuple(toks.shape)}, "
                  f"attention_impl {impl}: {time.monotonic() - t0:.2f} s",
                  flush=True)
    diff = float((last["pallas"] - last["reference"])[:rows].abs().max())
    argmax_same = bool(torch.equal(last["pallas"][:rows].argmax(-1),
                                   last["reference"][:rows].argmax(-1)))
    print(f"full-width last-position logits over {rows} rows: largest "
          f"|delta logit| {diff:.3g} (tol {GEMMA_LOGIT_TOL}), argmax equal "
          f"in every row: {argmax_same}", flush=True)
    if not argmax_same:
        _fail("the flash route's prefill argmax differs from the reference "
              "route's")
    if not diff <= GEMMA_LOGIT_TOL:
        _fail(f"the flash route's prefill logits differ from the reference "
              f"route's by {diff:.3g} (tol {GEMMA_LOGIT_TOL})")
    return diff


def phase_flash_timing(fa):
    """The flash kernel at the main-path shape, float32 and bfloat16, window
    1024 and causal: per call (CUDA events) and on the device (profiler),
    beside its plain version, one SDPA call and the bound of the route it
    takes (float32: 3xTF32, three TF32 passes at 495 TFLOP/s, with the 67
    TFLOP/s CUDA-core figure beside it; bfloat16: one pass at 989
    TFLOP/s); then musicgen-large's prefill shape in float32, causal, and
    stablelm-12b's and nemotron-4-340b's (head dims 160 and 192) in both
    dtypes, causal.  Fails when the float32 kernel is not faster than
    SDPA a call at the main-path shape; in bfloat16, and at the prefill
    shapes, the two are recorded side by side (in bfloat16 SDPA may take
    PyTorch's own flash backend)."""
    print("== phase 17: flash_attention timing at the main-path shape and "
          "the musicgen-large, stablelm-12b and nemotron-4-340b prefills",
          flush=True)
    import torch.nn.functional as F
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    before = fa.flash_attention.launches
    out = {}
    # (shape, dtype, windows, name prefix): the main-path shape in both
    # dtypes, window 1024 and causal; musicgen-large's prefill in float32
    cases = [(FLASH_MAIN, dtype, (1024, 0), "") for dtype in
             (torch.float32, torch.bfloat16)]
    cases.append((MUSICGEN_PREFILL, torch.float32, (0,),
                  "musicgen-large prefill "))
    cases += [(c, dtype, (0,), f"{name} prefill ")
              for name, c in (("stablelm-12b", STABLELM_PREFILL),
                              ("nemotron-4-340b", NEMOTRON_PREFILL))
              for dtype in (torch.float32, torch.bfloat16)]
    for c, dtype, windows, prefix in cases:
        b, s, h, kv, d = c["b"], c["s"], c["h"], c["kv"], c["d"]
        pos = torch.arange(s, device=DEV)
        q, k, v = _flash_case(dtype=dtype, seed=7, **c)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        f32 = dtype == torch.float32
        tol = (1e-4 if s > 512 else 2e-5) if f32 else 2e-2
        nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * q.element_size()
        for window in windows:
            name = (f"{prefix}{str(dtype)[6:]} "
                    f"{'window ' + str(window) if window else 'causal'}")
            call = lambda: fa.flash_attention(q, k, v, window=window)
            got = call()
            ref = fa.flash_attention_plain(q, k, v, window=window)
            err = float((got.float() - ref.float()).abs().max())
            row = 0.0 if f32 else _row_err(got, ref)
            del got, ref
            if not (err <= tol and row <= BF16_ROW_TOL):
                _fail(f"flash_attention at the timed shape, {name}: err "
                      f"{err:.3g} against its plain version (tol {tol}), "
                      f"row err {row:.3g} of its norm (bfloat16 tol "
                      f"{BF16_ROW_TOL})")
            ms = _time(call, 20, flush)
            device_ms, how, _ = _device_ms(call, 10, flush)
            plain_ms = _time(lambda: fa.flash_attention_plain(
                q, k, v, window=window), 5, flush)
            # yardstick: one SDPA call over the same q, k, v
            if window:
                mask = (pos[None, :] <= pos[:, None]) \
                    & (pos[None, :] > pos[:, None] - window)
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            else:
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            library_ms = _time(sdpa, 10, flush)
            # attended (query, key) pairs of these inputs
            qi = pos.double()
            pairs = int((torch.clamp(qi + 1, max=window) if window
                         else qi + 1).sum())
            flops = 4 * b * h * d * pairs
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = (3 * flops / TF32_FLOPS_PER_S if f32
                     else flops / BF16_FLOPS_PER_S) * 1e3
            cuda_core_ms = flops / F32_FLOPS_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            route = ("3xTF32: 3 x the flops at 495 TFLOP/s" if f32
                     else "bf16: one pass at 989 TFLOP/s")
            # the kernel's grid: a block takes the whole GQA group where it
            # divides the block's rows, else one head (each K/V tile then
            # staged once a head of the group)
            plan = fa.block_plan(b, s, s, h, kv)
            print(f"B={b} S=T={s} H={h} KV={kv} D={d} {name}: {len(plan)} "
                  f"blocks of {len(plan[0][2])} head(s) x "
                  f"{len(plan[0][1])} positions", flush=True)
            print(f"B={b} S=T={s} H={h} KV={kv} D={d} {name} (err "
                  f"{err:.3g} vs plain, tol {tol}"
                  f"{'' if f32 else f'; row err {row:.3g}'}): kernel {ms:.4f} ms a "
                  f"call, {device_ms:.4f} ms on the device ({how}); plain "
                  f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms; bound "
                  f"{bound_ms:.4f} ms ({bound_by}; {route}): {pairs} "
                  f"attended pairs, {flops / 1e9:.2f} GFLOP -> {t_ops:.4f} "
                  f"ms, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms at 3.35 "
                  f"TB/s -> {bound_ms / device_ms * 100:.1f}% of the bound "
                  f"on the device; CUDA-core float32 figure (67 TFLOP/s) "
                  f"{cuda_core_ms:.4f} ms", flush=True)
            out[name] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by, max_abs_err=err)
            if f32 and c is FLASH_MAIN and not ms < library_ms:
                _fail(f"flash_attention ({name}) is not faster than its "
                      f"SDPA yardstick: {ms:.4f} ms against "
                      f"{library_ms:.4f} ms a call")
    fa.flash_attention.launches = before    # timing launches not counted
    return out


# ---------------------------------------------------------------------------

CONV_STD = 0.5
# recurrentgemma-2b's access threshold: a row's layer-averaged mass puts
# 18/26 ~ 0.69 on its state page (each RG-LRU layer a unit touch) and
# spreads the 8 local layers' 8/26 over the ~129 pages inside the window:
# ~0.0024 a page under near-uniform attention (random weights), 0 outside
# the window.  0.001 sits between, so a page counts as accessed while it
# is inside the window (phase 18 prints the merged masses it saw).
RGEMMA_ACCESS_THRESHOLD = 0.001
# the prefill phase 18 times cell by cell: its longest prompt
RGEMMA_SPLIT_PLEN = 2600
# xlstm-1.3b: demote the oldest active request's state page every this many
# scheduler steps (phase 19)
XLSTM_DEMOTE_EVERY = 3
# phase 19's depth: all 6 repeats of its 7 mLSTM : 1 sLSTM block, 48
# layers (the mLSTM recurrence runs through mlstm_scan, in place on the
# state pages)
XLSTM_REPEATS = 6


def _perturb_conv(params, seed=SEED) -> None:
    """Draw every recurrent cell's conv taps from N(0, ``CONV_STD``) (a
    no-op without recurrent cells): the reference initialises them to
    zero, and with zero taps each cell outputs exactly zero and keeps a
    zero state, so a served model would never run the cells' arithmetic."""
    g = torch.Generator(device=params.tok.device).manual_seed(seed + 17)
    with torch.no_grad():
        for seg in params.segments:
            for slot in seg:
                if slot.kind.is_recurrent:
                    slot.cell.conv.normal_(generator=g).mul_(CONV_STD)


def _init_full(C, mdl, name, **change):
    """A full-width config (with ``change``, e.g. a depth cut) and its
    seeded float32 weights on a card that holds nothing else, conv taps
    perturbed; prints what was built."""
    left = torch.cuda.memory_allocated()
    if left > 2e9:
        _fail(f"{left / 1e9:.2f} GB still allocated before {name}'s init")
    cfg = dataclasses.replace(C.get(name), **change)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = mdl.init(cfg, seed=SEED)
    _perturb_conv(params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    kinds = [k.base for *_, k in mdl.state_slot_meta(cfg)]
    print(f"init: {cfg.name}, {cfg.num_layers} layers (pattern {kinds}, "
          f"repeats {[r for _, r in cfg.segments]}), d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff} ({cfg.mlp_kind}), vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B float32 params ({n_params * 4 / 1e9:.2f} "
          f"GB) in {time.monotonic() - t0:.1f} s; attention_impl "
          f"{cfg.attention_impl}"
          + (f"; conv taps N(0, {CONV_STD})" if mdl.has_state_pages(cfg)
             else ""), flush=True)
    return cfg, params


def _check_cell_launches(name, launches, layers, b, result,
                         per_prefill=1) -> None:
    """A recurrence kernel's launches in a served mix: one a layer of its
    cell a device step and ``per_prefill`` a prefill."""
    want = layers * (b.device_steps + per_prefill * result["prefills"])
    ok = launches == want
    times = f"{per_prefill} x " if per_prefill != 1 else ""
    print(f"{name} launches {launches} = {layers} layers x "
          f"({b.device_steps} device steps + {times}{result['prefills']} "
          f"prefills) -> {ok} ({b.route} route)", flush=True)
    if not ok:
        _fail(f"{name}'s launches do not match the layers x (device steps "
              f"+ {times}prefills)")


def phase_rgemma(C, mdl, pa, rg_, S, memtier, cori, telemetry, kernels):
    print("== phase 18: full-width recurrentgemma-2b serving (RG-LRU state "
          "pages, local attention, macro-step batcher)", flush=True)
    cfg, params = _init_full(C, mdl, "recurrentgemma-2b")
    local = sum(r for _, _, r, w, _ in mdl.state_slot_meta(cfg) if w > 0)
    n_rglru = sum(r for _, _, r, _, k in mdl.state_slot_meta(cfg)
                  if k.base == "rglru")

    def check(b, result, eager):
        result["launches"] = pa.paged_attention.launches
        result["rglru_launches"] = rg_.rglru_scan.launches
        _check_launches("paged_attention", result["launches"], local, b,
                        eager)
        _check_cell_launches("rglru_scan", result["rglru_launches"], n_rglru,
                             b, result)
        _check_cori_acted(b)

    results, _ = _serve_routes(
        params, cfg, S, memtier, cori, telemetry, kernels, check,
        n_logical=1024, hbm_pages=640, max_len=3072, n_req=6,
        prompt=(2100, 2601), new=(32, 65),
        access_threshold=RGEMMA_ACCESS_THRESHOLD)
    results["prefill_split"] = _prefill_split(
        mdl, params, cfg, np.random.default_rng(SEED + 18),
        plen=RGEMMA_SPLIT_PLEN, plain=("rglru",))
    held = torch.cuda.memory_allocated()
    del params
    _check_freed(held)
    return results


class _Demoter:
    """Every ``every`` scheduler steps, demote the state page of the
    oldest active request (``SharedPagedPools.demote``, the step a
    preemption takes) after keeping its HBM bytes; the pool's
    ``migrate_slots`` is wrapped so that when the next macro fetches the
    page back from the host tier, the fetched bytes are held to the kept
    ones (they must be equal: the host copy is written through every
    step)."""

    def __init__(self, b, every: int):
        self.pools, self.every, self.steps = b.monitor.pools, every, 0
        self.kept, self.demoted, self.fetched = {}, 0, 0
        migrate = self.pools.migrate_slots

        def checked(slots, logicals):
            migrate(slots, logicals)
            for slot, gid in zip(np.asarray(slots).tolist(),
                                 np.asarray(logicals).tolist()):
                if gid not in self.kept:
                    continue
                for leaf, kept in zip(self._leaves(), self.kept.pop(gid)):
                    if not torch.equal(leaf[:, slot], kept):
                        _fail(f"state page {gid} came back from the host "
                              "tier with other bytes")
                self.fetched += 1
        self.pools.migrate_slots = checked

    def _leaves(self):
        return [t for t in self.pools.kv_layers["state_hbm"]
                if t is not None]

    def __call__(self, b) -> None:
        self.steps += 1
        if self.steps % self.every or not b.active:
            return
        req = min(b.active.values(), key=lambda r: r.rid)
        gid = int(req.gids[-1])
        slot = int(self.pools.slot_of[gid])
        self.kept[gid] = [t[:, slot].clone() for t in self._leaves()]
        self.demoted += self.pools.demote(req.gids[-1:])


def _profile_cell(R, apply, mdl, params, cfg, tokens) -> dict:
    """One mLSTM cell of a prefill, profiled: its arguments are kept from
    the first mLSTM cell the prefill runs, then the cell runs alone
    (after two warm calls) under ``torch.profiler`` and its device time is
    split into the recurrence kernel (``mlstm_scan``), the matrix products
    (cuBLAS) and the rest.  Returns ms: wall (host clock around the
    synchronized call) and each part's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kept = []

    def keep(*args, **kw):
        if not kept:
            kept.append((args, kw))
        return apply(*args, **kw)
    R._APPLY["mlstm"] = keep
    try:
        mdl.prefill(params, cfg, tokens)
    finally:
        R._APPLY["mlstm"] = apply
    args, kw = kept[0]
    for _ in range(2):
        apply(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply(*args, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        apply(*args, **kw)
        torch.cuda.synchronize()
    parts = {"kernel": 0.0, "matmuls": 0.0, "rest": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.count:
            continue
        name = e.key.lower()
        key = ("kernel" if "mlstm_scan" in name else "matmuls"
               if any(w in name for w in ("gemm", "gemv", "xmma", "cutlass"))
               else "rest")
        parts[key] += e.self_device_time_total / 1e3
    print(f"  one mLSTM cell of it, profiled alone: {wall:.2f} ms wall; on "
          f"the device the kernel {parts['kernel']:.3f} ms, the matrix "
          f"products {parts['matmuls']:.3f} ms, the rest {parts['rest']:.3f} "
          f"ms ({sum(parts.values()):.3f} ms)", flush=True)
    return dict(wall_ms=wall, **{f"{k}_ms": v for k, v in parts.items()})


def _prefill_split(mdl, params, cfg, rng, plen=256, plain=()) -> dict:
    """One request's prefill at full depth (``plen`` tokens, after a warm
    call): its wall, then the same prefill with each recurrent kind's
    sequence form (``recurrent._APPLY``) timed between two synchronizes
    -- the cells of each kind and the rest (projections outside the
    cells, norms, attention layers, the unembedding).  For each kind in
    ``plain`` the split is taken once more with that cell's recurrence
    through its plain version (the port's code before its kernel), for
    the before and after.  Returns the walls in ms and each kind's
    share."""
    from repro_torch.models import recurrent as R
    kinds = sorted({k.base for *_, k in mdl.state_slot_meta(cfg)
                    if k.is_recurrent})
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen))) \
        .to(DEV)
    mdl.prefill(params, cfg, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mdl.prefill(params, cfg, tokens)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    orig = dict(R._APPLY)

    def split():
        spent = dict.fromkeys(kinds, 0.0)

        def timed(kind):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig[kind](*args, **kw)
                torch.cuda.synchronize()
                spent[kind] += (time.perf_counter() - t) * 1e3
                return out
            return run
        R._APPLY.update((k, timed(k)) for k in kinds)
        try:
            t0 = time.perf_counter()
            mdl.prefill(params, cfg, tokens)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        finally:
            R._APPLY.update(orig)
        return total, spent

    split_wall, spent = split()
    out = dict(prefill_ms=wall, split_wall_ms=split_wall,
               rest_ms=split_wall - sum(spent.values()))
    for k in kinds:
        out[f"{k}_ms"] = spent[k]
        out[f"{k}_share"] = spent[k] / split_wall
    print(f"one {plen}-token prefill at {cfg.num_layers} layers: {wall:.1f} "
          f"ms wall; timed cell by cell ({split_wall:.1f} ms): "
          + ", ".join(f"{k} cells {spent[k]:.1f} ms "
                      f"({out[f'{k}_share'] * 100:.1f}%)" for k in kinds)
          + f", the rest {out['rest_ms']:.1f} ms", flush=True)
    if "mlstm" in kinds:
        out["mlstm_cell"] = _profile_cell(R, orig["mlstm"], mdl, params, cfg,
                                          tokens)
    scans = {"slstm": ("slstm_scan", "slstm_scan_plain"),
             "rglru": ("rglru_scan", "rglru_scan_plain")}
    for kind in plain:
        name, plain_name = scans[kind]
        kernel = getattr(R, name)
        setattr(R, name, getattr(R, plain_name))
        try:
            total, before = split()
        finally:
            setattr(R, name, kernel)
        out[f"{kind}_plain_ms"] = before[kind]
        out[f"{kind}_plain_share"] = before[kind] / total
        print(f"  the same split with the {kind} recurrence through its "
              f"plain version ({name}'s before): {kind} cells "
              f"{before[kind]:.1f} ms of {total:.1f} ms "
              f"({before[kind] / total * 100:.1f}%)", flush=True)
    return out


def phase_xlstm(C, mdl, pa, ms_, ss_, S, memtier, cori, telemetry,
                kernels):
    print("== phase 19: full-width xlstm-1.3b serving (mLSTM / sLSTM state "
          f"pages only, macro-step batcher; {XLSTM_REPEATS} of its 6 "
          "blocks)", flush=True)
    pattern = C.get("xlstm-1.3b").segments[0][0]
    cfg, params = _init_full(C, mdl, "xlstm-1.3b",
                             segments=((pattern, XLSTM_REPEATS),))
    page_mb = sum(r * lv["state"][0] * 4
                  for r, lv in mdl.slot_leaf_specs(cfg, 16)) / 1e6
    print(f"one request's state page over {cfg.num_layers} layers: "
          f"{page_mb:.1f} MB", flush=True)
    n_mlstm = sum(r for _, _, r, _, k in mdl.state_slot_meta(cfg)
                  if k.base == "mlstm")
    n_slstm = sum(r for _, _, r, _, k in mdl.state_slot_meta(cfg)
                  if k.base == "slstm")
    demoters = []

    def between(b):
        demoters.append(_Demoter(b, XLSTM_DEMOTE_EVERY))
        return demoters[-1]

    def check(b, result, eager):
        d = demoters.pop()        # it holds the pools: let them go with b
        result.update(launches=pa.paged_attention.launches,
                      mlstm_launches=ms_.mlstm_scan.launches,
                      slstm_launches=ss_.slstm_scan.launches,
                      demoted=d.demoted, fetched_back=d.fetched,
                      misses=b.monitor.manager.misses)
        print(f"state pages demoted {d.demoted}, fetched back from the host "
              f"tier and equal to the bytes kept {d.fetched}; paged_attention "
              f"launches {result['launches']} (no attention layer)",
              flush=True)
        if d.demoted <= 0 or d.fetched != d.demoted or d.kept:
            _fail("a demoted state page was not fetched back")
        if result["launches"]:
            _fail("xlstm-1.3b launched the paged kernel")
        # a prefill: the pre-pass and the chunkwise kernel
        _check_cell_launches("mlstm_scan", result["mlstm_launches"],
                             n_mlstm, b, result, per_prefill=2)
        _check_cell_launches("slstm_scan", result["slstm_launches"],
                             n_slstm, b, result)
        if eager and b.device_steps != b.decode_steps:
            _fail(f"the eager route ran {b.device_steps} device steps for "
                  f"{b.decode_steps} decode steps")

    results, _ = _serve_routes(
        params, cfg, S, memtier, cori, telemetry, kernels, check,
        n_logical=8, hbm_pages=6, max_len=512, n_req=8, prompt=(64, 257),
        new=(32, 65), between=between)
    for res in results.values():
        res["prefill_ms_per_request"] = sum(res["admit_wall_ms"]) \
            / max(1, res["prefills"])
        print(f"{res['route']} route: admissions "
              f"{sum(res['admit_wall_ms']):.1f} ms for {res['prefills']} "
              f"prefills, {res['prefill_ms_per_request']:.1f} ms a request",
              flush=True)
    results["prefill_split"] = _prefill_split(
        mdl, params, cfg, np.random.default_rng(SEED + 19),
        plain=("slstm",))
    held = torch.cuda.memory_allocated()
    del params
    _check_freed(held)
    return results


def phase_recurrent_parity(C, mdl, S, memtier, cori, engine):
    print("== phase 20: parity on the card (reduced recurrentgemma-2b and "
          "xlstm-1.3b, conv taps N(0, 0.5), float32)", flush=True)
    for name in ("recurrentgemma-2b", "xlstm-1.3b"):
        print(f"reduced {name}:", flush=True)
        _parity(dataclasses.replace(C.reduced(name), dtype="float32"), mdl,
                S, memtier, cori, engine)


# ---------------------------------------------------------------------------
# the mLSTM recurrence: the kernel at xlstm-1.3b's full width
# ---------------------------------------------------------------------------

# xlstm-1.3b's mLSTM at full width: 4 heads of 1024 (dm 4096; C 16.8 MB a
# row); phase 19's prefills run up to 256 positions from the zero state,
# its decode steps B = 4, S = 1 over the state pages
MLSTM_NH, MLSTM_HD = 4, 1024
MLSTM_PREFILL_S = 256
# a state page of xlstm-1.3b's mLSTM: C, conv [3, 4096], m [4], n [4, 1024]
MLSTM_PAGE = MLSTM_NH * MLSTM_HD * MLSTM_HD + 3 * 4096 + MLSTM_NH \
    + MLSTM_NH * MLSTM_HD


def _mlstm_data(b, s, seed):
    """Seeded q, k, v [B, S, 4, 1024] ~ N(0, 1), input gates ~ N(0, 1),
    log forget gates logsigmoid(N(2, 1)), and a carried n ~ N(0, 0.3^2),
    m ~ N(0, 1)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    nh, hd = MLSTM_NH, MLSTM_HD
    q, k, v, i = r(b, s, nh, hd), r(b, s, nh, hd), r(b, s, nh, hd), \
        r(b, s, nh)
    f = torch.nn.functional.logsigmoid(r(b, s, nh) + 2.0)
    return (q, k, v, i, f, r(b, nh, hd).mul_(0.3), r(b, nh))


def _mlstm_case(ms_, name, data, src, src_rows, dsts) -> float:
    """The kernel against its plain version on one case: the plain version
    runs on copies of the state buffers, the kernel twice from their
    starting bytes.  S = 1 (the strip kernel): fails unless C (every byte
    of every buffer), n and m are bit-equal to the plain version's and h
    is within ``h_tolerance``.  S > 1 (the chunkwise form): fails unless
    m is bit-equal, the C each destination row gets, n and h are within
    their bounds (``tolerances``: one replay), and every other byte of
    every buffer is the plain version's.  Either way each call launches
    its kernels once each (the pre-pass and the chunkwise kernel, or the
    strip kernel), the rows no destination names keep their bytes and
    the second call is bit-identical to the first.  Returns h's largest
    error."""
    bufs = list({id(t): t for t in [src] + [b for b, _ in dsts]}.values())
    start = [t.clone() for t in bufs]
    twin = {id(t): c.clone() for t, c in zip(bufs, start)}
    h_p, n_p, m_p = ms_.mlstm_scan_plain(
        *data, twin[id(src)], src_rows, [(twin[id(b)], r) for b, r in dsts])
    seq = data[0].shape[1]
    runs, counted = [], []
    for _ in range(2):
        for t, c in zip(bufs, start):
            t.copy_(c)
        launched = ms_.mlstm_scan.launches
        out = ms_.mlstm_scan(*data, src, src_rows, dsts)
        torch.cuda.synchronize()
        counted.append(ms_.mlstm_scan.launches - launched)
        runs.append([x.clone() for x in out] + [t.clone() for t in bufs])
    bits = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    h, n, m, *after = runs[0]
    if seq == 1:
        tol = ms_.h_tolerance(*data, start[0], src_rows)
        same = bits(n, n_p) and bits(m, m_p) and all(
            bits(a, twin[id(t)]) for a, t in zip(after, bufs))
        state = f"C, n, m bit-equal {same}"
    else:
        tol, tol_c, tol_n = ms_.tolerances(*data, start[0], src_rows)
        cols = tol_c[0].numel()
        tol_c = tol_c.reshape(tol_c.shape[0], cols)
        c_ratio, c_ok, rest = 0.0, True, True
        for t, a in zip(bufs, after):
            want = twin[id(t)]
            written = torch.zeros(t.shape[0], dtype=torch.bool, device=DEV)
            for b, r in dsts:
                if b is t:
                    dc = (a[r, :cols] - want[r, :cols]).abs()
                    c_ok &= bool((dc <= tol_c).all())
                    c_ratio = max(c_ratio, float((dc.double() / tol_c).max()))
                    written[r] = True
            rest &= bits(a[:, cols:], want[:, cols:]) and bits(
                a[~written], want[~written])
        dn = (n - n_p).abs()
        n_ok = bool((dn <= tol_n).all())
        same = bits(m, m_p) and c_ok and n_ok and rest
        state = (f"m bit-equal {bits(m, m_p)}; C within its bound {c_ok} "
                 f"(at most {c_ratio:.3g} of it), n within {n_ok} (at most "
                 f"{float((dn.double() / tol_n).max()):.3g}); every other "
                 f"byte the plain version's {rest}")
    err = float((h - h_p).abs().max())
    within = bool(((h - h_p).abs() <= tol).all())
    untouched = True
    for t, a, c in zip(bufs, after, start):
        written = torch.zeros(t.shape[0], dtype=torch.bool, device=DEV)
        for b, r in dsts:
            if b is t:
                written[r] = True
        untouched &= torch.equal(a[~written], c[~written])
    again = all(bits(a, b) for a, b in zip(runs[0], runs[1]))
    kernels = 1 if seq == 1 else 2
    launches = counted == [kernels, kernels]
    ok = same and within and untouched and again and launches
    print(f"{name}: {state}; h max err {err:.3g} (tolerance "
          f"{float(tol.min()):.3g}-{float(tol.max()):.3g}, at most "
          f"{float(((h - h_p).abs().double() / tol).max()):.3g} of it, "
          f"within {within}); other rows untouched {untouched}; repeat "
          f"bit-identical {again}; kernel launches a call {counted} "
          f"(want {kernels}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"mlstm_scan disagrees with its plain version or with itself "
              f"({name})")
    return err


def _mlstm_bound(b, s, c_read, c_writes, chunk):
    """The bounds of one call, each (bound ms, bound_by, GB, GFLOP): its
    bytes (C read ``c_read`` times and written ``c_writes`` times, q, k, v
    and h, the gates, n and m in and out) at 3.35 TB/s against

    * "recurrent": the position-by-position form's operations, 6 float32
      operations an element of C a position (k*v, i_p *, f_p * C, +, and
      C^T q's multiply-add) and 7 an element of n, at 67 TFLOP/s (the
      strip kernel's form; the bound of the S > 1 rows before the
      chunkwise kernel);
    * "chunkwise": the chunkwise form's matrix products at ``chunk``
      positions a chunk, C^T q and the update (2 hd hd each a position and
      head) and, within a chunk, q . k~ and its product with v (2 hd each
      an attended pair j <= t), times 3 for 3xTF32 at 495 TFLOP/s."""
    nh, hd = MLSTM_NH, MLSTM_HD
    c_bytes = b * nh * hd * hd * 4
    io = 4 * b * s * nh * hd * 4 + 2 * b * s * nh * 4 + 2 * 2 * b * nh * \
        (hd + 1) * 4
    gb = (c_bytes * (c_read + c_writes) + io) / 1e9
    t_bytes = gb * 1e9 / HBM_BYTES_PER_S * 1e3
    pairs = sum(min(chunk, s - c) * (min(chunk, s - c) + 1) // 2
                for c in range(0, s, chunk))
    forms = {"recurrent": (b * s * nh * (6 * hd * hd + 7 * hd),
                           F32_FLOPS_PER_S),
             "chunkwise": (3 * b * nh * (4 * s * hd * hd + 4 * pairs * hd),
                           TF32_FLOPS_PER_S)}
    out = {}
    for key, (flops, rate) in forms.items():
        t_ops = flops / rate * 1e3
        out[key] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                    else "operations", gb, flops / 1e9)
    return out


def phase_mlstm(ms_) -> dict:
    """Phase 44: the mLSTM kernels against their plain version at
    xlstm-1.3b's full width, then their timing at phase 19's two shapes,
    the prefill also through the strip kernel (the route before the
    chunkwise kernel) for a same-run comparison."""
    print("== phase 44: mlstm_scan vs plain version on the card, and its "
          "timing (xlstm-1.3b's full width: 4 heads of 1024)", flush=True)
    nh, hd = MLSTM_NH, MLSTM_HD
    cols = nh * hd * hd
    before = ms_.mlstm_scan.launches
    one = torch.arange(1, device=DEV)
    two = torch.arange(2, device=DEV)
    worst = 0.0
    # prefill from the zero state (as mlstm_apply gives it: a zero C), then
    # from the state it leaves
    q, k, v, i, f, _, _ = _mlstm_data(1, MLSTM_PREFILL_S, SEED + 40)
    zero = torch.zeros((1, cols), device=DEV)
    n0 = torch.zeros((1, nh, hd), device=DEV)
    m0 = torch.full((1, nh), -1e30, device=DEV)
    carried = torch.zeros((1, cols), device=DEV)
    worst = max(worst, _mlstm_case(
        ms_, f"prefill B=1 S={MLSTM_PREFILL_S} from the zero state",
        (q, k, v, i, f, n0, m0), zero, one, [(carried, one)]))
    _, n1, m1 = ms_.mlstm_scan(q, k, v, i, f, n0, m0, zero, one,
                               [(carried, one)])
    prefill = _mlstm_data(1, MLSTM_PREFILL_S, SEED + 41)[:5] + (n1, m1)
    out = torch.zeros((1, cols), device=DEV)
    worst = max(worst, _mlstm_case(
        ms_, f"prefill B=1 S={MLSTM_PREFILL_S} from a carried state", prefill,
        carried, one, [(out, one)]))
    # short sequences from a random carried state: one position, a part of
    # a chunk, one past a chunk
    for s in (1, 3, ms_.CHUNK + 1):
        data = _mlstm_data(2, s, SEED + 42 + s)
        src = torch.randn((2, cols), generator=torch.Generator(
            device=DEV).manual_seed(s), device=DEV).mul_(0.3)
        worst = max(worst, _mlstm_case(
            ms_, f"B=2 S={s} from a carried state", data, src, two,
            [(torch.zeros_like(src), two)]))
    # decode over pool pages: 6 HBM slots and 8 host pages of xlstm-1.3b's
    # state page, each tier's sink last; row 2 dropped (no source, the
    # sinks), the others in place, each HBM slot another host page
    g = torch.Generator(device=DEV).manual_seed(SEED + 45)
    hbm = torch.randn((7, MLSTM_PAGE), generator=g, device=DEV).mul_(0.3)
    host = torch.randn((9, MLSTM_PAGE), generator=g, device=DEV).mul_(0.3)
    i64 = lambda *xs: torch.tensor(xs, dtype=torch.int64, device=DEV)
    src, at_hbm, at_host = i64(2, 0, -1, 4), i64(2, 0, 6, 4), i64(5, 3, 8, 1)
    decode = _mlstm_data(4, 1, SEED + 46)
    dsts = [(hbm, at_hbm), (host, at_host)]
    worst = max(worst, _mlstm_case(
        ms_, "decode B=4 S=1 over state pages (row 2 dropped to the sinks)",
        decode, hbm, src, dsts))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    res = {}
    shapes = {
        "decode": ("B=4 S=1 over state pages, C read once and written to "
                   "both tiers", decode, hbm, src, dsts, 4, 1, 1, 2),
        "prefill": (f"B=1 S={MLSTM_PREFILL_S} from a carried state",
                    prefill, carried, one, [(out, one)], 1, MLSTM_PREFILL_S,
                    1, 1)}
    for key, (label, data, src_, rows, dsts_, b, s, reads, writes) \
            in shapes.items():
        kernel = lambda: ms_.mlstm_scan(*data, src_, rows, dsts_)
        ms = _time(kernel, 30, flush)
        dev_ms, how, names = _device_ms(kernel, 30, flush)
        plain_ms = _time(lambda: ms_.mlstm_scan_plain(*data, src_, rows,
                                                      dsts_), 3, flush)
        bounds = _mlstm_bound(b, s, reads, writes, ms_.CHUNK)
        form = "chunkwise" if s > 1 else "recurrent"
        bound_ms, bound_by, gb, gflop = bounds[form]
        print(f"{key} ({label}): kernel {ms:.4f} ms a call (events), "
              f"{dev_ms:.4f} ms on the device ({how}: {_ms_list(names)}); "
              f"plain {plain_ms:.4f} ms; bound ({form} form) {bound_ms:.4f} "
              f"ms ({bound_by}: {gb:.4f} GB at 3.35 TB/s; {gflop:.3f} GFLOP "
              f"at {'3 x 495 TFLOP/s' if s > 1 else '67 TFLOP/s'}) -> "
              f"{bound_ms / dev_ms * 100:.1f}% of the bound on the device, "
              f"{bound_ms / ms * 100:.1f}% a call; no single PyTorch call "
              "computes it (library_ms null)", flush=True)
        res[key] = dict(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
                        plain_ms=plain_ms, library_ms=None,
                        bound_ms=bound_ms, bound_by=bound_by)
        if s > 1:
            old_ms, old_by, _, old_gflop = bounds["recurrent"]
            strip = lambda: ms_._launch(*data, src_, rows, dsts_,
                                        chunked=False)
            strip_ms, _, strip_names = _device_ms(strip, 10, flush)
            print(f"  the same call through the strip kernel (the S > 1 "
                  f"route before the chunkwise kernel): {strip_ms:.4f} ms "
                  f"on the device ({_ms_list(strip_names)}), against its "
                  f"recurrent-form bound {old_ms:.4f} ms ({old_by}: "
                  f"{old_gflop:.3f} GFLOP at 67 TFLOP/s) -> chunkwise "
                  f"{strip_ms / dev_ms:.2f}x faster", flush=True)
            res[key].update(strip_device_ms=strip_ms,
                            recurrent_bound_ms=old_ms)
    ms_.mlstm_scan.launches = before     # checks and timing not counted
    res["max_abs_err"] = worst
    return res


# ---------------------------------------------------------------------------
# the sLSTM recurrence: the kernel at xlstm-1.3b's full width
# ---------------------------------------------------------------------------

# xlstm-1.3b's sLSTM at full width: 4 heads of 512 (d 2048; r_gates 16.8 MB
# a layer); phase 19's prefills run up to 256 positions, its decode steps
# B = 4, S = 1
SLSTM_NH, SLSTM_HD = 4, 512
SLSTM_PREFILL_S = 256
# the reduced shapes' grid (4 heads, B = 2, from a carried state)
SLSTM_GRID_HD = (16, 64, 128)
SLSTM_GRID_S = (1, 7, 256)


def _slstm_data(b, s, nh, hd, seed):
    """Seeded wx [B, S, nh, 4 hd] ~ N(0, 1) and r_gates [nh, hd, 4 hd] ~
    N(0, 1/nh), the model's init."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    wx = torch.randn((b, s, nh, 4 * hd), generator=g, device=DEV)
    r = torch.randn((nh, hd, 4 * hd), generator=g, device=DEV) \
        .mul_(nh ** -0.5)
    return wx, r


def _slstm_start(ss_, b, nh, hd, r, seed, carried):
    """The zero state, or the state the plain version reaches from it over
    8 positions of other seeded data (a carried state)."""
    full = lambda v: torch.full((b, nh, hd), v, device=DEV)
    st = (full(0.0), full(1e-6), full(-1e30), full(0.0))
    if carried:
        wx = _slstm_data(b, 8, nh, hd, seed)[0]
        st = ss_.slstm_scan_plain(wx, r, *st)[1:]
    return st


def _slstm_forced(ss_, wx, r, starts):
    """Every position run as one position from ``starts[t]`` (a state a
    position), all in one launch of B S rows, against the plain cell from
    the same states: (largest |h| error, within the one-step bound)."""
    b, s = wx.shape[:2]
    rows = tuple(torch.cat([st[i] for st in starts]) for i in range(4))
    wx_rows = wx.transpose(0, 1).reshape(s * b, 1, *wx.shape[2:])
    got = ss_.slstm_scan(wx_rows, r, *rows)
    want = ss_.slstm_scan_plain(wx_rows, r, *rows)
    tol_h, tol_st = ss_.tolerance(wx_rows, r, *rows)
    within = bool(((got[0] - want[0]).abs() <= tol_h).all()) and all(
        bool(((got[i] - want[i]).abs() <= tol_st[k]).all())
        for i, k in ((1, "c"), (2, "n"), (3, "m")))
    return float((got[0] - want[0]).abs().max()), within


def _slstm_case(ss_, name, wx, r, start) -> dict:
    """The kernel against its plain version on one case (module
    docstring of ``kernels/slstm_scan.py``): teacher-forced (every
    position from the plain version's state; at S = 1 the one step) and
    kernel-forced (from the kernel's own states) within the one-step
    bound; the sequence launch bit-identical to one-position launches
    chained on its own state, and to a second call; the whole sequence's
    deviation from the plain version printed and held to the carried
    bound.  Returns the errors."""
    s = wx.shape[1]
    bits = lambda x, y: torch.equal(x.view(torch.int32), y.view(torch.int32))
    want = ss_.slstm_scan_plain(wx, r, *start)
    runs = [ss_.slstm_scan(wx, r, *start) for _ in range(2)]
    torch.cuda.synchronize()
    again = all(bits(x, y) for x, y in zip(*runs))
    got = runs[0]
    plain_starts, kernel_starts, hs = [start], [start], []
    p_st = k_st = start
    for t in range(s):
        out = ss_.slstm_scan(wx[:, t:t + 1].contiguous(), r, *k_st)
        hs.append(out[0])
        k_st = out[1:]
        if t + 1 < s:
            p_st = ss_.slstm_scan_plain(wx[:, t:t + 1], r, *p_st)[1:]
            plain_starts.append(p_st)
            kernel_starts.append(k_st)
    chained = bits(torch.cat(hs, dim=1), got[0]) and all(
        bits(x, y) for x, y in zip(k_st, got[1:]))
    teacher, teacher_ok = _slstm_forced(ss_, wx, r, plain_starts)
    own, own_ok = _slstm_forced(ss_, wx, r, kernel_starts)
    dev = (got[0] - want[0]).abs()
    tol = ss_.tolerance(wx, r, *start, carry=True)[0]
    seq_ok = bool((dev <= tol).all())
    per_pos = dev.amax(dim=(0, 2, 3))
    apart = (per_pos > 1e-3).nonzero()
    first = int(apart[0]) if apart.numel() else None
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    ok = again and chained and teacher_ok and own_ok and seq_ok and finite
    print(f"{name}: teacher-forced h max err {teacher:.3g} within the "
          f"one-step bound {teacher_ok}; kernel-forced {own:.3g} within "
          f"{own_ok}; sequence launch == chained one-position launches "
          f"{chained}; repeat bit-identical {again}; whole sequence: h max "
          f"deviation {float(dev.max()):.3g} (first position past 1e-3: "
          f"{first}), within the carried bound {seq_ok} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"slstm_scan disagrees with its plain version or with itself "
              f"({name})")
    return dict(forced=max(teacher, own), sequence=float(dev.max()),
                first_apart=first)


def _slstm_bound(b, s, nh, hd):
    """(bound ms, bound_by, GB, GFLOP) of one call: r_gates read once, wx
    read, h written, the state in and out; 2 B S nh hd 4hd operations of
    the recurrent dot products (the cell's few dozen a unit aside)."""
    d = nh * hd
    gb = (nh * hd * 4 * hd + b * s * 4 * d + b * s * d + 8 * b * d) * 4 / 1e9
    flops = 2 * b * s * nh * hd * 4 * hd
    t_bytes = gb * 1e9 / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", gb, flops / 1e9)


def phase_slstm(ss_) -> dict:
    """Phase 45: the sLSTM kernel against its plain version at
    xlstm-1.3b's full width and over a grid of reduced shapes, then its
    timing at phase 19's two shapes."""
    print("== phase 45: slstm_scan vs plain version on the card, and its "
          "timing (xlstm-1.3b's full width: 4 heads of 512)", flush=True)
    nh, hd = SLSTM_NH, SLSTM_HD
    before = ss_.slstm_scan.launches
    errs = []
    wx, r = _slstm_data(1, SLSTM_PREFILL_S, nh, hd, SEED + 50)
    zero = _slstm_start(ss_, 1, nh, hd, r, 0, carried=False)
    errs.append(_slstm_case(ss_, f"prefill B=1 S={SLSTM_PREFILL_S} from the "
                            "zero state", wx, r, zero))
    carried = ss_.slstm_scan_plain(wx, r, *zero)[1:]
    wx2 = _slstm_data(1, SLSTM_PREFILL_S, nh, hd, SEED + 51)[0]
    errs.append(_slstm_case(ss_, f"prefill B=1 S={SLSTM_PREFILL_S} from a "
                            "carried state", wx2, r, carried))
    wx4 = _slstm_data(4, 1, nh, hd, SEED + 52)[0]
    start4 = _slstm_start(ss_, 4, nh, hd, r, SEED + 53, carried=True)
    errs.append(_slstm_case(ss_, "decode B=4 S=1 from a carried state", wx4,
                            r, start4))
    for g_hd in SLSTM_GRID_HD:
        for g_s in SLSTM_GRID_S:
            gwx, gr = _slstm_data(2, g_s, 4, g_hd, SEED + g_hd + g_s)
            gst = _slstm_start(ss_, 2, 4, g_hd, gr, SEED + 7, carried=True)
            errs.append(_slstm_case(ss_, f"B=2 S={g_s} 4 heads of {g_hd} "
                                    "from a carried state", gwx, gr, gst))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    res = {}
    shapes = {"prefill": (f"B=1 S={SLSTM_PREFILL_S} from the zero state",
                          wx, zero),
              "decode": ("B=4 S=1 from a carried state", wx4, start4)}
    for key, (label, x, st) in shapes.items():
        b, s = x.shape[:2]
        kernel = lambda: ss_.slstm_scan(x, r, *st)
        ms = _time(kernel, 20, flush)
        dev_ms, how, names = _device_ms(kernel, 20, flush)
        plain_ms = _time(lambda: ss_.slstm_scan_plain(x, r, *st), 3, flush)
        bound_ms, bound_by, gb, gflop = _slstm_bound(b, s, nh, hd)
        print(f"{key} ({label}): kernel {ms:.4f} ms a call (events), "
              f"{dev_ms:.4f} ms on the device ({how}: {_ms_list(names)}), "
              f"{dev_ms * 1e3 / s:.3f} us a position of the serial chain; "
              f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({bound_by}: {gb:.4f} GB at 3.35 TB/s; {gflop:.3f} GFLOP at "
              f"67 TFLOP/s) -> {bound_ms / dev_ms * 100:.1f}% of the bound "
              f"on the device, {bound_ms / ms * 100:.1f}% a call; no single "
              "PyTorch call computes it (library_ms null)", flush=True)
        res[key] = dict(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
                        us_per_position=dev_ms * 1e3 / s, plain_ms=plain_ms,
                        library_ms=None, bound_ms=bound_ms,
                        bound_by=bound_by)
    ss_.slstm_scan.launches = before     # checks and timing not counted
    res["max_abs_err"] = max(e["forced"] for e in errs)
    res["sequence_max_dev"] = max(e["sequence"] for e in errs)
    return res


# ---------------------------------------------------------------------------
# the RG-LRU recurrence: the kernel at recurrentgemma-2b's width
# ---------------------------------------------------------------------------

# recurrentgemma-2b's RG-LRU: lru_width 2560; phase 18's prefills run
# 2100-2600 positions, its decode steps B = 4, S = 1
RGLRU_W = 2560
RGLRU_PREFILL_S = 2600
# (B, S, w): one position, a full chunk and one past it, several chunks,
# and B = 4 at S = 4096, more tiles than the card holds at once (671 MB)
RGLRU_GRID = ((1, 1, 64), (3, 64, 64), (2, 65, 64), (2, 300, 64),
              (2, 7, RGLRU_W), (1, 700, RGLRU_W), (4, 4096, RGLRU_W))


def _rglru_data(b, s, w, seed):
    """Seeded gate products ra, ia ~ N(0, 1), xc ~ N(0, 1), lam as the
    model's init (a = exp(-8 softplus(lam)) in [0.9, 0.999]) and a
    carried h0 ~ N(0, 1)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    u = torch.rand((w,), generator=g, device=DEV) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    return r(b, s, w), r(b, s, w), r(b, s, w), lam, r(b, w)


def _rglru_case(rg_, name, args, other) -> float:
    """The kernel against its plain version on one case: h within
    ``h_tolerance``, a second call bit-identical.  Then a call on
    ``other`` (other data of the same shape) and one on ``args`` again,
    and the call captured in a CUDA graph and replayed three times: on
    ``args``, on ``other`` copied into its inputs, on ``args`` again; each
    bit-identical to the eager call on the same data (a word left by an
    earlier call or replay would show).  Returns the largest error."""
    bits = lambda x, y: torch.equal(x.view(torch.int32), y.view(torch.int32))
    want = rg_.rglru_scan_plain(*args)
    runs = [rg_.rglru_scan(*args) for _ in range(2)]
    torch.cuda.synchronize()
    again = bits(runs[0], runs[1])
    tol = rg_.h_tolerance(*args)
    err = (runs[0] - want).abs()
    within = bool((err <= tol).all())
    ratio = float((err.double() / tol).max())
    eager_other = rg_.rglru_scan(*other)
    again = again and bits(rg_.rglru_scan(*args), runs[0])
    saved = [t.clone() for t in args]
    captured = rg_.rglru_scan.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rg_.rglru_scan(*args)
    rg_.rglru_scan.captured = captured
    replays = []
    for data, ref in ((saved, runs[0]), (other, eager_other),
                      (saved, runs[0])):
        for dst, src in zip(args, data):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        replays.append(bits(out, ref))
    del graph
    ok = within and again and all(replays)
    print(f"{name}: h max err {float(err.max()):.3g} (at most {ratio:.3g} "
          f"of h_tolerance, {float(tol.min()):.3g}-{float(tol.max()):.3g}; "
          f"within {within}); repeat bit-identical, also after a call on "
          f"other data, {again}; graph replays on this data, other data, "
          f"this data bit-identical to the eager calls {replays} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"rglru_scan disagrees with its plain version or with itself "
              f"({name})")
    return float(err.max())


def phase_rglru(rg_) -> dict:
    """Phase 46: the RG-LRU kernel against its plain version at
    recurrentgemma-2b's shapes and over a grid, then its timing at phase
    18's two shapes."""
    print("== phase 46: rglru_scan vs plain version on the card, and its "
          "timing (recurrentgemma-2b's lru_width 2560)", flush=True)
    before = rg_.rglru_scan.launches
    w = RGLRU_W
    prefill = _rglru_data(1, RGLRU_PREFILL_S, w, SEED + 60)
    decode = _rglru_data(4, 1, w, SEED + 61)
    worst = max(_rglru_case(rg_, f"prefill B=1 S={RGLRU_PREFILL_S} w={w} "
                            "from a carried h", prefill,
                            _rglru_data(1, RGLRU_PREFILL_S, w, SEED + 90)),
                _rglru_case(rg_, f"decode B=4 S=1 w={w}", decode,
                            _rglru_data(4, 1, w, SEED + 91)))
    for i, (b, s, gw) in enumerate(RGLRU_GRID):
        worst = max(worst, _rglru_case(rg_, f"B={b} S={s} w={gw}",
                                       _rglru_data(b, s, gw, SEED + 62 + i),
                                       _rglru_data(b, s, gw, SEED + 92 + i)))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    # the floor a standalone launch cannot go under: an empty kernel
    # (torch.cuda._sleep of 0 cycles) on the same stream
    empty_ms, how, _ = _device_ms(lambda: torch.cuda._sleep(0), 30, flush)
    print(f"an empty kernel on the same stream: {empty_ms:.4f} ms on the "
          f"device ({how})", flush=True)
    res = {}
    for key, args in (("prefill", prefill), ("decode", decode)):
        b, s, _ = args[0].shape
        kernel = lambda: rg_.rglru_scan(*args)
        ms = _time(kernel, 30, flush)
        dev_ms, how, names = _device_ms(kernel, 30, flush)
        plain_ms = _time(lambda: rg_.rglru_scan_plain(*args), 5, flush)
        # ra, ia, xc read and h written once; lam and h0 read
        gb = (4 * b * s * w + w + b * w) * 4 / 1e9
        bound_ms = gb * 1e9 / HBM_BYTES_PER_S * 1e3
        print(f"{key} (B={b} S={s} w={w}): kernel {ms:.4f} ms a call "
              f"(events), {dev_ms:.4f} ms on the device ({how}: "
              f"{_ms_list(names)}); plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms (bytes: {gb:.4f} GB at 3.35 TB/s) -> "
              f"{bound_ms / dev_ms * 100:.1f}% of the bound on the device, "
              f"{bound_ms / ms * 100:.1f}% a call; no single PyTorch call "
              "computes it (library_ms null)", flush=True)
        if key == "decode":
            print(f"  the decode's device time is {dev_ms / empty_ms:.2f} x "
                  f"an empty kernel's ({empty_ms:.4f} ms)", flush=True)
        res[key] = dict(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
                        plain_ms=plain_ms, library_ms=None,
                        bound_ms=bound_ms, bound_by="bytes")
    res["decode"]["empty_kernel_ms"] = empty_ms
    rg_.rglru_scan.launches = before     # checks and timing not counted
    res["max_abs_err"] = worst
    return res


# ---------------------------------------------------------------------------
# the recurrences' backward kernels, at xlstm-1.3b's training shape
# ---------------------------------------------------------------------------

# phase 48's batch (TRAIN_BATCH x TRAIN_SEQ); reduced xlstm-1.3b's cells
# (d 64: the mLSTM's 4 heads of 32, the sLSTM's 4 heads of 16) at phase
# 39's 16 positions
BWD_REDUCED_S = 16
MLSTM_REDUCED_HD, SLSTM_REDUCED_HD = 32, 16
# the sLSTM's r_gates: the reference's init draws them with fan-in nh
# (std 0.5 at 4 heads of 512), where the recurrence is chaotic and its
# backward leaves float32's range within some 100 positions (gradients
# NaN over 256 positions, from wx = 0 too: measured on the CPU in
# float32); phase 48 draws them with fan-in hd (std 0.044), where a
# float32 forward stays within 5e-7 of float64 over 256 positions and the
# gradients stay O(1).  At the reference's scale the backward is held one
# position at a time (``_slstm_windows``), at phase 48's over a sequence
SLSTM_FAN_IN_REF = SLSTM_NH
# autograd of the mLSTM's per-position loop (the route training took
# before the backward kernel) is timed at this S: at S = 256 its tape is
# 2 x 16.8 MB a row and position, 34 GB a call at B = 4
MLSTM_LOOP_S = 64


def _bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _counters(ms_, ss_) -> dict:
    """The four wrappers the recurrences' training path counts in."""
    return {"mlstm_scan": ms_.mlstm_scan,
            "mlstm_scan_backward": ms_.mlstm_scan_backward,
            "slstm_scan": ss_.slstm_scan,
            "slstm_scan_backward": ss_.slstm_scan_backward}


def _mlstm_bwd_data(b, s, hd, seed, carried):
    """Seeded q, k, v [B, S, 4, hd] ~ N(0, 1), input gates ~ N(0, 1), log
    forget gates logsigmoid(N(2, 1)) (``_mlstm_data``'s draws), the zero
    state or a carried one (C, n ~ N(0, 0.3^2), m ~ N(0, 1)), and the
    output gradient dh ~ N(0, 1)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    nh = MLSTM_NH
    q, k, v, i = r(b, s, nh, hd), r(b, s, nh, hd), r(b, s, nh, hd), \
        r(b, s, nh)
    f = torch.nn.functional.logsigmoid(r(b, s, nh) + 2.0)
    if carried:
        st = (r(b, nh, hd, hd).mul_(0.3), r(b, nh, hd).mul_(0.3), r(b, nh))
    else:
        st = (torch.zeros((b, nh, hd, hd), device=DEV),
              torch.zeros((b, nh, hd), device=DEV),
              torch.full((b, nh), -1e30, device=DEV))
    return (q, k, v, i, f) + st, r(b, s, nh, hd)


def _mlstm_forward_saved(ms_, args, save):
    """The chunkwise forward on a dense state, with or without the
    backward's saves: (h, C, n, m, saves)."""
    q, k, v, i, f, C, n, m = args
    b, _, nh, hd = q.shape
    rows = torch.arange(b, device=DEV)
    out = torch.empty((b, nh * hd * hd), device=DEV)
    saves = ms_._saves(q) if save else None
    h, n1, m1 = ms_._launch(q, k, v, i, f, n, m,
                            C.reshape(b, -1).contiguous(), rows,
                            [(out, rows)], chunked=True, save=saves)
    return h, out, n1, m1, saves


def _grad_line(chk) -> tuple:
    """(text, all within, largest distance, largest share of the bar)."""
    ok = all(d <= bar for d, bar in chk.values())
    text = ", ".join(f"{k} {d:.3g} (bar {bar:.3g})" for k, (d, bar)
                     in chk.items())
    return (text, ok, max(d for d, _ in chk.values()),
            max(d / bar for d, bar in chk.values()))


def _mlstm_bwd_case(ms_, name, b, s, hd, seed, carried) -> dict:
    """The mLSTM backward kernel on one case: the forward with its saves
    bit-identical to the forward without; the backward's four launches,
    a second call bit-identical; each gradient within ``grad_check``'s bar
    against float32 and float64 runs of the plain forward and backward
    (``mlstm_save_plain``, ``mlstm_backward_plain``)."""
    args, dh = _mlstm_bwd_data(b, s, hd, seed, carried)
    plain_fwd = _mlstm_forward_saved(ms_, args, False)
    h, C1, n1, m1, saves = _mlstm_forward_saved(ms_, args, True)
    same = all(_bits(x, y) for x, y in zip(plain_fwd[:4], (h, C1, n1, m1)))
    before = ms_.mlstm_scan_backward.launches
    q, k, v, i, f, _, _, m0 = args
    runs = [ms_.mlstm_scan_backward(q, k, v, i, f, m0, h, dh, saves)
            for _ in range(2)]
    torch.cuda.synchronize()
    launches = ms_.mlstm_scan_backward.launches - before
    again = all(_bits(x, y) for x, y in zip(*runs))

    def plain(dt):
        x = [t.to(dt) for t in args]
        _, _, _, hp, sv = ms_.mlstm_save_plain(*x)
        return ms_.mlstm_backward_plain(*x[:5], x[7], hp, dh.to(dt), sv)

    chk = ms_.grad_check(runs[0], plain(torch.float32), plain(torch.float64))
    text, within, err, share = _grad_line(chk)
    binds = float((saves[2].abs() < 1).float().mean())
    ok = same and launches == 8 and again and within
    print(f"mlstm {name}: forward with saves bit-identical {same}; "
          f"|n . q| < 1 (the clamp binds) at {binds:.3f} of the positions; "
          f"{text}; within {within} (at most {share:.3g} of a bar); "
          f"repeat bit-identical {again}; launches {launches} (want 8) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"the mLSTM backward kernel disagrees ({name})")
    return dict(err=err, share=share, clamp_binds=binds, args=args, dh=dh,
                h=h, saves=saves)


def _slstm_fwd_saved(ss_, wx, r, st, save):
    saves = ss_._saves(wx) if save else None
    return ss_._launch(wx, r, *st, save=saves), saves


def _slstm_r(nh, hd, fan_in, seed):
    """Seeded r_gates [nh, hd, 4 hd] ~ N(0, 1 / fan_in): the reference's
    init takes fan-in nh (``SLSTM_FAN_IN_REF``), phase 48 hd."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((nh, hd, 4 * hd), generator=g, device=DEV) \
        .mul_(fan_in ** -0.5)


def _slstm_bwd_case(ss_, name, b, s, hd, seed, fan_in, carried) -> dict:
    """The sLSTM backward kernel over a whole sequence: the forward with
    its saves bit-identical to the forward without; one launch a call, a
    second call bit-identical; dwx and dr within ``grad_check``'s bar
    against float32 and float64 runs of the plain forward and backward."""
    nh = SLSTM_NH
    wx = _slstm_data(b, s, nh, hd, seed)[0]
    r = _slstm_r(nh, hd, fan_in, seed + 1)
    st = _slstm_start(ss_, b, nh, hd, r, seed + 2, carried)
    dh = torch.randn((b, s, nh, hd), generator=torch.Generator(
        device=DEV).manual_seed(seed + 3), device=DEV)
    out0, _ = _slstm_fwd_saved(ss_, wx, r, st, False)
    out1, saves = _slstm_fwd_saved(ss_, wx, r, st, True)
    same = all(_bits(x, y) for x, y in zip(out0, out1))
    before = ss_.slstm_scan_backward.launches
    runs = [ss_.slstm_scan_backward(wx, r, *st, out1[0], saves, dh)
            for _ in range(2)]
    torch.cuda.synchronize()
    launches = ss_.slstm_scan_backward.launches - before
    again = all(_bits(x, y) for x, y in zip(runs[0][:2], runs[1][:2]))

    def plain(dt):
        x = [t.to(dt) for t in (wx, r) + tuple(st)]
        hs, *_, sv = ss_.slstm_save_plain(*x)
        return ss_.slstm_backward_plain(*x, hs, sv, dh.to(dt))[:2]

    chk = ss_.grad_check(runs[0][:2], plain(torch.float32),
                         plain(torch.float64))
    text, within, err, share = _grad_line(chk)
    ok = same and launches == 2 and again and within
    print(f"slstm {name}: forward with saves bit-identical {same}; {text}; "
          f"within {within} (at most {share:.3g} of a bar); repeat "
          f"bit-identical {again}; launches {launches} (want 2) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"the sLSTM backward kernel disagrees ({name})")
    return dict(err=err, share=share, wx=wx, r=r, st=st, h=out1[0],
                saves=saves, dh=dh)


def _slstm_windows(ss_, name, b, s, hd, seed) -> dict:
    """The sLSTM backward one position at a time from the same saved
    states, at the reference's init (r_gates fan-in nh), where the
    recurrence is chaotic and its gradient over a long sequence leaves
    float32's range: the kernel's forward saves a sequence; then every
    pair of positions (t, t + 1) is a row of one launch of B (S - 1) rows
    of two positions, from the saved state before t, with seeded incoming
    gradients (the output's at t and t + 1, the carried dc, dn, dm), so
    t's gate gradients take one recurrent product of the kernel's own;
    dwx is held to ``grad_check``'s bar against the plain backward on the
    same rows in float32 and float64."""
    nh = SLSTM_NH
    wx = _slstm_data(b, s, nh, hd, seed)[0]
    r = _slstm_r(nh, hd, SLSTM_FAN_IN_REF, seed + 1)
    st = _slstm_start(ss_, b, nh, hd, r, seed + 2, False)
    (hs, *_), saves = _slstm_fwd_saved(ss_, wx, r, st, True)
    win = lambda x: torch.stack([x[:, t:t + 2] for t in range(s - 1)]) \
        .reshape(-1, 2, *x.shape[2:])
    before = lambda x, x0: torch.stack(
        [x0] + [x[:, t - 1] for t in range(1, s - 1)]).reshape(
            -1, *x0.shape[1:])
    sv = [win(x) for x in saves]
    c0, n0, m0 = (before(saves[j + 1], st[j]) for j in (0, 1, 2))
    h0 = before(hs, st[3])
    g = torch.Generator(device=DEV).manual_seed(seed + 3)
    rows = c0.shape[0]
    dh_w = torch.randn((rows, 2) + c0.shape[1:], generator=g, device=DEV)
    carries = tuple(torch.randn(c0.shape, generator=g, device=DEV)
                    for _ in range(3))
    args = (win(wx), r, c0, n0, m0, h0, win(hs))
    got = ss_.slstm_scan_backward(*args, sv, dh_w, carries)[0]

    def plain(dt):
        x = [t.to(dt) for t in args]
        return ss_.slstm_backward_plain(*x, [t.to(dt) for t in sv],
                                        dh_w.to(dt),
                                        tuple(t.to(dt) for t in carries))[0]

    chk = ss_.grad_check((got,), (plain(torch.float32),),
                         (plain(torch.float64),))
    text, within, err, share = _grad_line(chk)
    print(f"slstm {name}, one position at a time ({rows} rows of two "
          f"positions): {text}; within {within} (at most {share:.3g} of a "
          f"bar) {'ok' if within else 'FAIL'}", flush=True)
    if not within:
        _fail(f"the sLSTM backward kernel disagrees one position at a time "
              f"({name})")
    return dict(err=err, share=share)


def _mlstm_bwd_bound(b, s, nh, hd):
    """The bounds of one mLSTM backward call, each (bound ms, bound_by,
    GB, GFLOP): its bytes (q, k, v, h, dh read and dq, dk, dv written,
    the saved C boundaries read, nch hd^2 a row and head, the gates and
    saved n, n . q) at 3.35 TB/s against

    * "cuda_cores": the chunk products, dC^T k~ and the carried update
      (the dv pass), C dnum and dC v (the dq / dk pass), 2 hd^2 each a
      position, row and head, and the in-chunk pair terms (2 hd each a
      pair) in float32 at 67 TFLOP/s (the kernel's earlier form);
    * "tensor_cores": the same operations times 3 for 3xTF32 at 495
      TFLOP/s (the form the kernel runs);
    * "two_pass": the tensor-core form with the dce scratch the dv pass
      writes and the dq / dk pass reads (nch hd^2 a row and head, each
      way) among its bytes: the floor of the two-pass design."""
    nch = -(-s // 16)
    pairs = sum(min(16, s - c) * (min(16, s - c) + 1) // 2
                for c in range(0, s, 16))
    gb = (8 * b * s * nh * hd + b * nh * nch * (hd * hd + hd)
          + 6 * b * s * nh) * 4 / 1e9
    scratch_gb = 2 * b * nh * nch * hd * hd * 4 / 1e9
    flops = b * nh * (8 * s * hd * hd + 8 * pairs * hd)
    forms = {"cuda_cores": (gb, flops, F32_FLOPS_PER_S),
             "tensor_cores": (gb, 3 * flops, TF32_FLOPS_PER_S),
             "two_pass": (gb + scratch_gb, 3 * flops, TF32_FLOPS_PER_S)}
    out = {}
    for key, (g, fl, rate) in forms.items():
        t_bytes = g * 1e9 / HBM_BYTES_PER_S * 1e3
        t_ops = fl / rate * 1e3
        out[key] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                    else "operations", g, fl / 1e9)
    return out


def _slstm_bwd_bound(b, s, nh, hd):
    """(bound ms, bound_by, GB, GFLOP) of the sLSTM backward kernel: r
    read once, the output gradient, the saved pre-activations and state
    read, dwx written; the recurrent products, 2 B S nh hd 4hd, in
    float32 at 67 TFLOP/s (d r_gates, a plain product after the kernel,
    is not the kernel's)."""
    d = nh * hd
    gb = (nh * hd * 4 * hd + b * s * (d + 4 * d + 3 * d + 4 * d)
          + 3 * b * d) * 4 / 1e9
    flops = 2 * b * s * nh * hd * 4 * hd
    t_bytes = gb * 1e9 / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", gb, flops / 1e9)


def _bwd_timing(name, kernel, plain, bound, flush, iters=10, rate="67",
                others=None) -> dict:
    """A backward kernel's time a call and on the device (by kernel)
    against ``bound`` (its operations at ``rate`` TFLOP/s), and against
    each of ``others`` ({form: bound}, returned as ``<form>_bound_ms``)."""
    ms = _time(kernel, iters, flush)
    dev_ms, how, names = _device_ms(kernel, iters, flush)
    plain_ms = _time(plain, 2, flush)
    bound_ms, bound_by, gb, gflop = bound
    print(f"{name}: kernel {ms:.4f} ms a call (events), {dev_ms:.4f} ms on "
          f"the device ({how}: {_ms_list(names)}); plain backward "
          f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{gb:.4f} GB at 3.35 TB/s, {gflop:.3f} GFLOP at {rate} TFLOP/s) "
          f"-> {bound_ms / dev_ms * 100:.1f}% of the bound on the device; no "
          "single PyTorch call computes it (library_ms null)", flush=True)
    out = dict(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
               bound_by=bound_by)
    for form, (o_ms, o_by, o_gb, o_gflop) in (others or {}).items():
        print(f"  against the {form} figure {o_ms:.4f} ms ({o_by}: "
              f"{o_gb:.4f} GB, {o_gflop:.3f} GFLOP): "
              f"{o_ms / dev_ms * 100:.1f}% of it on the device", flush=True)
        out[f"{form}_bound_ms"] = o_ms
    return out


def _slstm_chain(ss_, case, bwd, flush) -> dict:
    """The sLSTM's serial chain at phase 48's shape: the forward kernel on
    ``case``'s inputs timed a call with and without its saves and on the
    device, beside the backward kernel alone on the device (``bwd``:
    ``_bwd_timing``'s), each in us a position."""
    wx, r, st = case["wx"], case["r"], case["st"]
    b, s = wx.shape[:2]
    out = {}
    for key in (False, True):
        fn = lambda: _slstm_fwd_saved(ss_, wx, r, st, key)
        tag = "forward_saves" if key else "forward"
        out[f"{tag}_ms"] = _time(fn, 10, flush)
        dev_ms, _, names = _device_ms(fn, 10, flush)
        out[f"{tag}_device_ms"] = names.get("slstm_scan_kernel", dev_ms)
    bwd_ms = bwd["device_kernels_ms"].get("slstm_bwd_kernel",
                                          bwd["device_ms"])
    out.update(kernel_device_ms=bwd_ms,
               forward_us_per_position=out["forward_device_ms"] / s * 1e3,
               us_per_position=bwd_ms / s * 1e3)
    print(f"slstm forward B={b} S={s}: {out['forward_ms']:.4f} ms a call "
          f"without the saves, {out['forward_saves_ms']:.4f} ms with them "
          f"(pre-activations and c, n, m a position: "
          f"{sum(t.numel() for t in case['saves']) * 4 / 1e9:.4f} GB); the "
          f"kernel on the device {out['forward_device_ms']:.4f} / "
          f"{out['forward_saves_device_ms']:.4f} ms", flush=True)
    print(f"slstm chain B={b} S={s}, us a position on the device: forward "
          f"{out['forward_us_per_position']:.3f} (with saves "
          f"{out['forward_saves_device_ms'] / s * 1e3:.3f}), backward "
          f"kernel {out['us_per_position']:.3f} ({bwd_ms:.4f} ms)",
          flush=True)
    return out


def phase_backward(ms_, ss_) -> dict:
    """Phase 47: the mLSTM and sLSTM backward kernels against their plain
    versions at xlstm-1.3b's width and at the reduced config's, then
    their timing at phase 48's shape (B = 4, S = 256)."""
    print("== phase 47: the mLSTM and sLSTM backward kernels vs their "
          "plain versions on the card, and their timing (xlstm-1.3b's "
          "training shape)", flush=True)
    counted = {k: c.launches for k, c in _counters(ms_, ss_).items()}
    b, s = TRAIN_BATCH, TRAIN_SEQ
    res = {"mlstm": {}, "slstm": {}}
    full = {}
    for carried in (False, True):
        state = "a carried state" if carried else "the zero state"
        full[carried] = _mlstm_bwd_case(
            ms_, f"B={b} S={s} 4 heads of {MLSTM_HD} from {state}", b, s,
            MLSTM_HD, SEED + 470 + carried, carried)
        _mlstm_bwd_case(ms_, f"reduced B={b} S={BWD_REDUCED_S} 4 heads of "
                        f"{MLSTM_REDUCED_HD} from {state}", b, BWD_REDUCED_S,
                        MLSTM_REDUCED_HD, SEED + 472 + carried, carried)
    res["mlstm"]["max_abs_err"] = max(c["err"] for c in full.values())
    seq = {}
    for carried in (False, True):
        state = "a carried state" if carried else "the zero state"
        seq[carried] = _slstm_bwd_case(
            ss_, f"B={b} S={s} 4 heads of {SLSTM_HD} from {state}, r_gates "
            f"fan-in hd (phase 48's; the whole sequence)", b, s, SLSTM_HD,
            SEED + 475 + carried, SLSTM_HD, carried)
        _slstm_bwd_case(ss_, f"reduced B={b} S={BWD_REDUCED_S} 4 heads of "
                        f"{SLSTM_REDUCED_HD} from {state}, r_gates fan-in "
                        "nh (the reference's init; the whole sequence)", b,
                        BWD_REDUCED_S, SLSTM_REDUCED_HD, SEED + 477 + carried,
                        SLSTM_FAN_IN_REF, carried)
    win = _slstm_windows(ss_, f"B={b} S={s} 4 heads of {SLSTM_HD}, r_gates "
                         "fan-in nh (the reference's init)", b, s, SLSTM_HD,
                         SEED + 479)
    res["slstm"]["max_abs_err"] = max(win["err"], *(c["err"] for c in
                                                     seq.values()))
    calm = seq[False]

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    case = full[False]
    q, k, v, i, f, _, _, m0 = case["args"]
    mb = (q, k, v, i, f, m0, case["h"], case["dh"], case["saves"])
    fwd = {key: _time(lambda: _mlstm_forward_saved(ms_, case["args"], key),
                      10, flush) for key in (False, True)}
    print(f"mlstm forward B={b} S={s}: {fwd[False]:.4f} ms a call without "
          f"the saves, {fwd[True]:.4f} ms with them (C and n before each of "
          f"{-(-s // 16)} chunks: "
          f"{case['saves'][0].numel() * 4 / 1e9:.3f} GB)", flush=True)
    bounds = _mlstm_bwd_bound(b, s, MLSTM_NH, MLSTM_HD)
    res["mlstm"].update(_bwd_timing(
        f"mlstm backward B={b} S={s} 4 heads of {MLSTM_HD} (3xTF32 form)",
        lambda: ms_.mlstm_scan_backward(*mb),
        lambda: ms_.mlstm_backward_plain(*mb), bounds["tensor_cores"], flush,
        rate="3 x 495", others={"cuda_cores": bounds["cuda_cores"],
                                "two_pass": bounds["two_pass"]}))
    res["mlstm"].update(forward_ms=fwd[False], forward_saves_ms=fwd[True],
                        saves_gb=case["saves"][0].numel() * 4 / 1e9)
    # the route training took before: autograd of the per-position loop
    sl = MLSTM_LOOP_S
    cut = lambda t: t[:, :sl].contiguous() if t.dim() > 2 and \
        t.shape[1] == s else t
    args = [cut(t) for t in case["args"]]
    loop = []
    for _ in range(3):
        ins = [t.clone().requires_grad_(j < 5) for j, t in enumerate(args)]
        _, _, _, hl = ms_.mlstm_loop(ins[5], ins[6], ins[7], *ins[:5])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        hl.backward(case["dh"][:, :sl])
        ev[1].record()
        torch.cuda.synchronize()
        loop.append(ev[0].elapsed_time(ev[1]))
        del ins, hl
    kern = _time(lambda: ms_.mlstm_scan_backward(
        *[cut(t) for t in mb[:8]], _mlstm_forward_saved(ms_, args, True)[4]),
        5, flush)
    print(f"  at S={sl}: autograd of the per-position loop (the route "
          f"training took before) {np.median(loop[1:]):.3f} ms a backward, "
          f"the backward kernel with the forward that saves for it "
          f"{kern:.4f} ms", flush=True)
    res["mlstm"].update(loop_autograd_ms=float(np.median(loop[1:])),
                        loop_s=sl)
    sb = (calm["wx"], calm["r"], *calm["st"], calm["h"], calm["saves"],
          calm["dh"])
    res["slstm"].update(_bwd_timing(
        f"slstm backward B={b} S={s} 4 heads of {SLSTM_HD}",
        lambda: ss_.slstm_scan_backward(*sb),
        lambda: ss_.slstm_backward_plain(*sb),
        _slstm_bwd_bound(b, s, SLSTM_NH, SLSTM_HD), flush))
    res["slstm"].update(_slstm_chain(ss_, calm, res["slstm"], flush))
    for key, c in _counters(ms_, ss_).items():
        c.launches = counted[key]       # checks and timing not counted
    del full, seq, calm, case, mb, sb, flush
    _check_freed(torch.cuda.memory_allocated())
    return res


# ---------------------------------------------------------------------------
# the RG-LRU's backward kernel, at recurrentgemma-2b's training shape
# ---------------------------------------------------------------------------

# phase 49's cases (B, S, from a carried h) at lru_width 2560: phase 50's
# batch (B = 4, S = 256) from the zero state and a carried h, one chunk
# (the short kernel) and a ragged S (not a multiple of 64)
RGLRU_BWD_CASES = ((4, 256, False), (4, 256, True), (4, 40, True),
                   (2, 300, True))
# the backward's float32 operations an element, counted from
# ``grad_factors`` and the scan in csrc/rglru_scan.cu: the gates 14 (two
# sigmoids of 3 each with their exp, log a, 2 log a, exp, 1 - e2, the max,
# sqrt, exp), the factors 14 (gx, 1 - a^2 and its test, gx e2 / beta,
# a h_{t-1} and the difference, kl, kr's 3, kx, ki's 3), the scan 8 (g,
# three outputs, dlam's product and sum, u)
RGLRU_BWD_OPS = 36


def _rglru_counters(rg_) -> dict:
    """The two wrappers the RG-LRU's training path counts in."""
    return {"rglru_scan": rg_.rglru_scan,
            "rglru_scan_backward": rg_.rglru_scan_backward}


def _rglru_bwd_case(rg_, name, b, s, carried, seed) -> dict:
    """The backward kernel from the forward kernel's h on one case: the
    five gradients within ``grad_check``'s bar, a second call and the call
    captured in a CUDA graph and replayed twice bit-identical to the
    first.  Returns the case's tensors and its largest distance."""
    args = list(_rglru_data(b, s, RGLRU_W, seed))
    if not carried:
        args[4].zero_()
    dh = torch.randn((b, s, RGLRU_W), device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(seed))
    h = rg_.rglru_scan(*args)
    runs = [rg_.rglru_scan_backward(*args, h, dh) for _ in range(2)]
    torch.cuda.synchronize()
    again = all(_bits(x, y) for x, y in zip(*runs))
    captured = rg_.rglru_scan_backward.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rg_.rglru_scan_backward(*args, h, dh)
    rg_.rglru_scan_backward.captured = captured
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(all(_bits(x, y) for x, y in zip(out, runs[0])))
    del graph, out
    text, within, err, share = _grad_line(
        rg_.grad_check(runs[0], *args, dh))
    ok = within and again and all(replays)
    print(f"{name}: {text}; at most {share:.3g} of the bar; repeat "
          f"bit-identical {again}; graph replays bit-identical {replays} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"rglru_scan_backward disagrees with float64 or with itself "
              f"({name})")
    return dict(args=args, h=h, dh=dh, err=err, share=share)


def phase_rglru_backward(rg_) -> dict:
    """Phase 49: the RG-LRU backward kernel against float64 at
    recurrentgemma-2b's width (``RGLRU_BWD_CASES``), then its timing at
    phase 50's shape beside its bound, its plain version, and autograd of
    the plain scan (the route training took before the kernel); and the
    tiles an SM the card holds of it (failing below what it is built
    for) with the waves phase 50's tiles take."""
    print("== phase 49: rglru_scan_backward vs float64 on the card, and "
          "its timing (recurrentgemma-2b's training shape)", flush=True)
    counted = {k: c.launches for k, c in _rglru_counters(rg_).items()}
    cases = []
    for i, (b, s, carried) in enumerate(RGLRU_BWD_CASES):
        state = "a carried h" if carried else "the zero state"
        cases.append(_rglru_bwd_case(rg_, f"B={b} S={s} w={RGLRU_W} from "
                                     f"{state}", b, s, carried,
                                     SEED + 490 + i))
    res = dict(max_abs_err=max(c["err"] for c in cases),
               max_share_of_bar=max(c["share"] for c in cases))
    case = cases[0]
    args, h, dh = case["args"], case["h"], case["dh"]
    del cases
    b, s, w = h.shape
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    kernel = lambda: rg_.rglru_scan_backward(*args, h, dh)
    ms = _time(kernel, 30, flush)
    dev_ms, how, names = _device_ms(kernel, 30, flush)
    fwd_ms, _, _ = _device_ms(lambda: rg_.rglru_scan(*args), 30, flush)
    plain_ms = _time(lambda: rg_.rglru_backward_plain(*args, h, dh), 5,
                     flush)

    def autograd_plain():
        x = [t.detach().requires_grad_() for t in args]
        rg_.rglru_scan_plain(*x).backward(dh)

    def kernels():
        rg_.rglru_scan_backward(*args, rg_.rglru_scan(*args), dh)

    auto_ms = _time(autograd_plain, 5, flush)
    both_ms = _time(kernels, 10, flush)
    # ra, ia, xc, h and dh read, dra, dia and dxc written; lam, h0 read,
    # dlam and dh0 written
    gb = (8 * b * s * w + 2 * w + 2 * b * w) * 4 / 1e9
    t_bytes = gb * 1e9 / HBM_BYTES_PER_S * 1e3
    gflop = RGLRU_BWD_OPS * b * s * w / 1e9
    t_ops = gflop * 1e9 / F32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"rglru backward B={b} S={s} w={w}: kernel {ms:.4f} ms a call "
          f"(events), {dev_ms:.4f} ms on the device ({how}: "
          f"{_ms_list(names)}); plain backward {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}: {gb:.4f} GB at 3.35 TB/s; "
          f"{gflop:.4f} GFLOP at 67 TFLOP/s take {t_ops:.4f}) -> "
          f"{bound_ms / dev_ms * 100:.1f}% of the bound on the device, "
          f"{bound_ms / ms * 100:.1f}% a call; no single PyTorch call "
          "computes it (library_ms null)", flush=True)
    print(f"  forward + backward: the two kernels {both_ms:.4f} ms a call "
          f"(the forward {fwd_ms:.4f} ms on the device); autograd of the "
          f"plain scan (the route training took before) {auto_ms:.4f} ms "
          f"-> {auto_ms / both_ms:.1f}x", flush=True)
    plan = rg_.backward_plan(b, s, w)
    per_sm = rg_.backward_blocks_per_sm()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-plan["blocks"] // (per_sm * sms))
    print(f"  tiles an SM: {per_sm} as the card computes them (built for "
          f"{plan['per_sm']}, {plan['smem']} bytes of shared memory a "
          f"tile): {plan['blocks']} tiles on {sms} SMs take {waves} "
          f"wave(s)", flush=True)
    if per_sm < plan["per_sm"]:
        _fail(f"rglru_scan_backward holds {per_sm} tiles an SM, not the "
              f"{plan['per_sm']} it is built for")
    res.update(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
               plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
               bound_by=bound_by, forward_device_ms=fwd_ms,
               kernel_fwd_bwd_ms=both_ms, autograd_plain_fwd_bwd_ms=auto_ms,
               blocks_per_sm=per_sm, waves=waves)
    for key, c in _rglru_counters(rg_).items():
        c.launches = counted[key]       # checks and timing not counted
    del case, args, h, dh, flush
    _check_freed(torch.cuda.memory_allocated())
    return res


# ---------------------------------------------------------------------------
# routed MoE: the routed-expert kernel, olmoe-1b-7b
# ---------------------------------------------------------------------------

# the routed-expert kernel's decode shapes on the served paths: (tokens,
# top-k, experts, d_model, d_expert) of a 4-row batch
ROUTED_SHAPES = {"olmoe-1b-7b": (4, 8, 64, 2048, 1024),
                 "deepseek-v3-671b": (4, 8, 256, 7168, 2048)}
# the kernel against its plain version: max |y - y_plain| within this share
# of max |y_plain| (float32 sums of up to 7168 products, in other orders)
ROUTED_TOL = 1e-5


def _routed_weights(shape, seed):
    """One repeat's router and experts at ``shape``, N(0, 1/fan-in), so
    outputs are O(1); and the generator that drew them."""
    _, _, e, d, f = shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    mat = lambda fan, *dims: torch.randn(dims, generator=g,
                                         device=DEV).div_(fan ** 0.5)
    return dict(router=mat(d, d, e), wi_gate=mat(d, e, d, f),
                wi_up=mat(d, e, d, f), wo=mat(f, e, f, d)), g


def _routed_inputs(moe, weights, shape, t, case, g):
    """(x, idx, w, probs) of ``t`` tokens routed by ``moe.route``:
    ``random`` tokens; ``same``, where the router makes experts 0..k-1
    lead for every token by far; ``tied``, where the second half of the
    experts ties with the first and a zero token ties all of them."""
    _, k, e, d, _ = shape
    x = torch.randn((t, d), generator=g, device=DEV)
    router = weights["router"]
    if case == "same":
        u = torch.full((d,), d ** -0.5, device=DEV)
        x = x + 3.0 * d ** 0.5 * u
        router = router.clone()
        for j in range(k):
            router[:, j] = 50.0 * (j + 1) * u
    elif case == "tied":
        router = torch.cat([router[:, : e // 2], router[:, : e // 2]], dim=1)
        x[0] = 0.0
    w, idx, probs = moe.route(x, router, k)
    return x, idx.contiguous(), w.contiguous(), probs


def phase_routed_check(moe, re_, weights):
    """The routed-expert kernel vs its plain version at both decode
    widths; returns the largest absolute error seen."""
    print("== phase 21: routed_experts vs plain version on the card",
          flush=True)
    worst = 0.0
    for model, shape in ROUTED_SHAPES.items():
        wts, g = weights[model]
        k = shape[1]
        for t, case in ((4, "random"), (1, "random"), (4, "same"),
                        (4, "tied")):
            x, idx, w, probs = _routed_inputs(moe, wts, shape, t, case, g)
            args = (x, idx, w, wts["wi_gate"], wts["wi_up"], wts["wo"])
            y = re_.routed_experts(*args)
            again = re_.routed_experts(*args)
            ref = re_.routed_experts_plain(*args)
            torch.cuda.synchronize()
            same = torch.equal(y, again)
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            picked = idx.cpu().numpy()
            ok = same and err <= ROUTED_TOL * scale and scale > 0
            note = ""
            if case == "tied":
                # lax.top_k's order: a stable descending sort of the probs
                want = np.argsort(-probs.cpu().numpy(), axis=1,
                                  kind="stable")[:, :k]
                ties = (np.array_equal(picked, want)
                        and np.array_equal(picked[0], np.arange(k)))
                ok = ok and ties
                note = f", experts as lax.top_k's {ties}"
            elif case == "same":
                same_e = bool((np.sort(picked, axis=1)
                               == np.arange(k)).all())
                ok = ok and same_e
                note = f", every token on experts 0..{k - 1} {same_e}"
            distinct = len(np.unique(picked))
            print(f"{model} T={t} {case}: {distinct} distinct experts, err "
                  f"{err:.3g} of max |y| {scale:.3g} (tol {ROUTED_TOL} of "
                  f"it), repeat bit-identical {same}{note} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                _fail(f"routed_experts disagrees with its plain version or "
                      f"with itself ({model} T={t} {case})")
            worst = max(worst, err)
    return worst


def phase_routed_timing(moe, re_, weights):
    """The routed-expert kernel at both decode shapes (4 tokens): per call
    and on the device, beside its plain version, its bound and the expert
    loop a sequence takes (the yardstick)."""
    print("== phase 22: routed_experts timing at the served decode shapes",
          flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    before = re_.routed_experts.launches
    res = {}
    for model, shape in ROUTED_SHAPES.items():
        wts, g = weights[model]
        t, k, e, d, f = shape
        x, idx, w, _ = _routed_inputs(moe, wts, shape, t, "random", g)
        args = (x, idx, w, wts["wi_gate"], wts["wi_up"], wts["wo"])
        y = re_.routed_experts(*args)
        ref = re_.routed_experts_plain(*args)
        err = float((y - ref).abs().max())
        if not err <= ROUTED_TOL * float(ref.abs().max()):
            _fail(f"routed_experts at the {model} timed shape: err {err:.3g}")
        kernel = lambda: re_.routed_experts(*args)
        ms = _time(kernel, 30, flush)
        dev_ms, how, names = _device_ms(kernel, 30, flush)
        plain_ms = _time(lambda: re_.routed_experts_plain(*args), 5, flush)
        # yardstick: the expert loop a sequence takes, on the same inputs
        # (its host read of the counts included)
        p = types.SimpleNamespace(wi_gate=wts["wi_gate"][None],
                                  wi_up=wts["wi_up"][None],
                                  wo=wts["wo"][None])
        loop = lambda: moe._expert_loop(p, 0, x, w, idx, e)
        loop_err = float((loop() - ref).abs().max())
        loop_ms = _time(loop, 20, flush)
        loop_dev_ms, loop_how, _ = _device_ms(loop, 20, flush)
        distinct = len(np.unique(idx.cpu().numpy()))
        w_bytes = distinct * 3 * d * f * 4
        io_bytes = 2 * t * d * 4 + t * k * (8 + 4)   # x, y; idx, w
        flops = 6 * d * f * t * k
        t_bytes = (w_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{model}: T={t} k={k} E={e} d={d} f={f} float32, {distinct} "
              f"distinct experts (err {err:.3g} vs plain): kernel {ms:.4f} "
              f"ms a call (events), {dev_ms:.4f} ms on the device ({how}: "
              f"{_ms_list(names)}); plain {plain_ms:.4f} ms; the expert loop "
              f"(host read + torch.matmul) {loop_ms:.4f} ms a call, "
              f"{loop_dev_ms:.4f} ms on the device ({loop_how}; err "
              f"{loop_err:.3g} vs plain); bound {bound_ms:.4f} ms "
              f"({bound_by}: {(w_bytes + io_bytes) / 1e9:.4f} GB at 3.35 "
              f"TB/s; {flops / 1e9:.3f} GFLOP at 67 TFLOP/s) -> "
              f"{bound_ms / dev_ms * 100:.1f}% of the bound on the device, "
              f"{bound_ms / ms * 100:.1f}% a call; faster than the loop a "
              f"call: {ms < loop_ms}", flush=True)
        res[model] = dict(ms=ms, device_ms=dev_ms, device_kernels_ms=names,
                          plain_ms=plain_ms, library_ms=None,
                          loop_ms=loop_ms, loop_device_ms=loop_dev_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          distinct_experts=distinct, max_abs_err=err)
    re_.routed_experts.launches = before     # timing launches not counted
    return res


def phase_olmoe(C, mdl, pa, re_, S, memtier, cori, telemetry, kernels):
    print("== phase 23: full-width olmoe-1b-7b serving (GQA + routed MoE, "
          "macro-step batcher)", flush=True)
    cfg, params = _init_full(C, mdl, "olmoe-1b-7b")
    mo = cfg.moe
    moe_layers = _moe_layers(mdl, cfg)
    print(f"{mo.num_experts} experts top-{mo.top_k} of {mo.d_expert} in "
          f"{moe_layers} MoE layers: "
          f"{cfg.d_model * mo.d_expert * 3 * 4 / 1e6:.1f} MB an expert",
          flush=True)

    streams = {}

    def check(b, result, eager):
        result["launches"] = pa.paged_attention.launches
        result["routed_launches"] = re_.routed_experts.launches
        _check_launches("paged_attention", result["launches"],
                        cfg.num_layers, b, eager)
        _check_launches("routed_experts", result["routed_launches"],
                        moe_layers, b, eager)
        if not eager:
            streams.update((r.rid, list(r.tokens)) for r in b.completed)

    results, _ = _serve_routes(params, cfg, S, memtier, cori, telemetry,
                               kernels, check)
    results["pipelined"] = _olmoe_pipelined(mdl, pa, re_, S, memtier, cori,
                                            telemetry, kernels, cfg, params,
                                            streams, results["graph"],
                                            moe_layers)
    held = torch.cuda.memory_allocated()
    del params
    _check_freed(held)
    return results


# phase 36's chunk: prompts of 128-512 positions take 1-2 chunks
OLMOE_CHUNK = 256


def _olmoe_pipelined(mdl, pa, re_, S, memtier, cori, telemetry, kernels,
                     cfg, params, want, sync, moe_layers) -> dict:
    """Phase 36: phase 23's mix on its parameters through the pipelined
    loop (graph route), with packed admission and then with
    ``admit_chunk_tokens=OLMOE_CHUNK``: streams held to phase 23's graph
    route's (``_compare_streams``), both kernels' launches, the
    pipeline's records.  A MoE admission chunk reads the host
    (``moe._expert_loop``'s counts), so the "admit" stage's wall shows
    what that read costs in an overlap window; nothing here makes it
    faster."""
    print("== phase 36: olmoe-1b-7b pipelined at full width (packed, then "
          f"chunked admission of {OLMOE_CHUNK})", flush=True)
    out = {}
    for name, chunk in (("packed", None), ("chunked", OLMOE_CHUNK)):
        keep = {}
        b, res, same, _, reqs = _serve_mix(
            params, cfg, S, memtier, cori, telemetry, kernels, keep=keep,
            pipeline=True, admit_chunk_tokens=chunk)
        res.update(launches=pa.paged_attention.launches,
                   routed_launches=re_.routed_experts.launches)
        _check_launches("paged_attention", res["launches"], cfg.num_layers,
                        b, False)
        _check_launches("routed_experts", res["routed_launches"],
                        moe_layers, b, False)
        _compare_streams(mdl, cfg, params, reqs, same["streams"], want,
                         f"olmoe pipelined {name}", ref="phase 23's")
        rec = keep.pop("recorder")
        st = _pipeline_stats(rec)
        _check_pipeline(f"olmoe pipelined {name}", b, st)
        admit = [e["wall_ms"] for e in rec.events("serve.pipeline.stage")
                 if e["stage"] == "admit"]
        chunks = rec.events("serve.pipeline.admit_chunk")
        # a prompt longer than a chunk is admitted in chunks, a shorter
        # one packed
        want_chunks = sum(-(-len(r.prompt) // chunk) for r in reqs
                          if len(r.prompt) > chunk) if chunk else 0
        if len(chunks) != want_chunks:
            _fail(f"{len(chunks)} admission chunks, expected {want_chunks}")
        res.update(st, chunks=len(chunks), admit_stage_ms=admit,
                   stall_ms=[e["stall_ms"] for e in rec.events(
                       "serve.admit")])
        print(f"olmoe-1b-7b pipelined {name}: {res['tokens_per_s']:.2f} "
              f"tokens/s (phase 23's graph route: "
              f"{sync['tokens_per_s']:.2f}), macro wall p50 "
              f"{res['macro_p50_ms']:.1f} ms (phase 23: "
              f"{sync['macro_p50_ms']:.1f}); admission chunks {len(chunks)}"
              + (f", the \"admit\" stage wall p50 "
                 f"{float(np.median(admit)):.1f} ms (max "
                 f"{max(admit):.1f}) over {len(admit)} windows"
                 if admit else "")
              + f"; admission stall p50 "
              f"{float(np.median(res['stall_ms'])):.1f} ms; tiering "
              f"{same['migrations']} migrations, {same['hits']} hits, "
              f"{same['misses']} misses", flush=True)
        b.close()
        del b
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# cross-attention conditioning and the GELU / squared-ReLU MLPs:
# musicgen-large, nemotron-4-340b
# ---------------------------------------------------------------------------

# nemotron-4-340b's depth on one 80 GB card: 2 of its 96 layers (3.454 B
# parameters each) beside its untied embedding and unembedding (4.719 B
# each) are 16.35 B float32 parameters, 65.4 GB
NEMOTRON_LAYERS = 2


def _session_cond(cfg):
    """A serving session's conditioning [1, cond_len, cond_dim] drawn
    N(0, 1) from the seed on the card (the encoders that would make it are
    stubs in the reference too), or None for a config without one."""
    if not cfg.cond_len:
        return None
    g = torch.Generator(device=DEV).manual_seed(SEED + 29)
    return torch.randn((1, cfg.cond_len, cfg.cond_dim or cfg.d_model),
                       generator=g, device=DEV)


def _session_prefix(cfg):
    """A serving session's shared prefix [1, prefix_len, d_model] drawn
    N(0, 1) from the seed on the card (the SigLIP tower that would make
    it is a stub in the reference too), or None for a config without
    one."""
    if not cfg.prefix_len:
        return None
    g = torch.Generator(device=DEV).manual_seed(SEED + 31)
    return torch.randn((1, cfg.prefix_len, cfg.d_model), generator=g,
                       device=DEV)


def _cross_kv_ms(params, cond, rows, step_ms) -> dict:
    """One decode step's cross-attention K/V projections alone on the
    device: every ``.xattn`` layer's conditioning rows [rows, T, cond_dim]
    times its ``wk`` and ``wv``, which each step recomputes as the
    reference does; printed beside ``step_ms``, the graph route's
    profiled ms a step."""
    x = cond.expand((rows,) + tuple(cond.shape[1:])).contiguous()
    layers = [(slot.xattn, r) for seg in params.segments for slot in seg
              if slot.kind.xattn for r in range(slot.norm1.shape[0])]

    def step():
        for p, r in layers:
            x @ p.wk[r]
            x @ p.wv[r]

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    ms, how, _ = _device_ms(step, 5, flush)
    flops = sum(2 * 2 * x.shape[0] * x.shape[1] * p.wk.shape[1]
                * p.wk.shape[2] for p, _ in layers)
    share = ms / step_ms
    print(f"cross-attention K/V projections of one decode step ({len(layers)} "
          f"layers x 2 of [{rows} x {x.shape[1]}, {x.shape[2]}] @ "
          f"[{x.shape[2]}, {layers[0][0].wk.shape[2]}], {flops / 1e9:.1f} "
          f"GFLOP): {ms:.3f} ms on the device ({how}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {share * 100:.1f}% of the "
          f"graph route's profiled {step_ms:.2f} ms a step", flush=True)
    return dict(ms=ms, share=share, gflop=flops / 1e9)


def phase_musicgen(C, mdl, pa, fa, S, memtier, cori, telemetry, kernels):
    print("== phase 24: full-width musicgen-large serving (cross-attention "
          "conditioning, GELU MLP, flash prefill, macro-step batcher)",
          flush=True)
    cfg, params = _init_full(C, mdl, "musicgen-large",
                             attention_impl="pallas")
    cond = _session_cond(cfg)
    print(f"conditioning {tuple(cond.shape)} drawn N(0, 1) from the seed, "
          f"attended by every layer's cross-attention", flush=True)

    results, _ = _serve_routes(params, cfg, S, memtier, cori, telemetry,
                               kernels, _flash_route_check(fa, pa, cfg),
                               cond=cond)
    results["graph"]["cross_kv"] = _cross_kv_ms(
        params, cond, 4, results["graph"]["profile"]["ms_per_step"])
    held = torch.cuda.memory_allocated()
    del params, cond
    _check_freed(held)
    return results


def phase_nemotron(C, mdl, pa, fa, S, memtier, cori, telemetry, kernels):
    print("== phase 25: nemotron-4-340b at full width serving (96/8 heads of "
          "192, squared-ReLU MLP, depth cut, flash prefill, macro-step "
          "batcher)", flush=True)
    full = C.get("nemotron-4-340b")
    cfg, params = _init_full(C, mdl, "nemotron-4-340b", segments=(
        (("attn",), NEMOTRON_LAYERS),), attention_impl="pallas")
    layer = sum(p.numel() for p in params.segments.parameters())
    print(f"reduced: depth {full.num_layers} -> {cfg.num_layers} layers "
          f"(segments {cfg.segments}), widths unchanged: "
          f"{layer / cfg.num_layers / 1e9:.3f} B parameters a layer, the "
          f"untied embedding and unembedding "
          f"{cfg.vocab_size * cfg.d_model / 1e9:.3f} B each", flush=True)

    results, _ = _serve_routes(params, cfg, S, memtier, cori, telemetry,
                               kernels, _flash_route_check(fa, pa, cfg))
    held = torch.cuda.memory_allocated()
    del params
    _check_freed(held)
    return results


def phase_stablelm(C, mdl, pa, fa, S, memtier, cori, telemetry, kernels):
    print("== phase 51: full-width, full-depth stablelm-12b serving (32/8 "
          "heads of 160, SwiGLU MLP, flash prefill, macro-step batcher)",
          flush=True)
    cfg, params = _init_full(C, mdl, "stablelm-12b", attention_impl="pallas")

    launches = _flash_route_check(fa, pa, cfg)

    def check(b, result, eager):
        launches(b, result, eager)
        _check_cori_acted(b)

    results, _ = _serve_routes(params, cfg, S, memtier, cori, telemetry,
                               kernels, check)
    held = torch.cuda.memory_allocated()
    del params
    _check_freed(held)
    return results


def phase_cond_parity(C, mdl, S, memtier, cori, engine):
    print("== phase 26: parity on the card (reduced musicgen-large with its "
          "conditioning and flash prefill, reduced nemotron-4-340b, "
          "float32)", flush=True)
    for name, impl in (("musicgen-large", "pallas"),
                       ("nemotron-4-340b", "reference")):
        print(f"reduced {name}, attention_impl {impl}:", flush=True)
        _parity(dataclasses.replace(C.reduced(name), dtype="float32",
                                    attention_impl=impl), mdl, S, memtier,
                cori, engine)


def phase_flash_parity(C, mdl, S, memtier, cori, engine, fa):
    print("== phase 52: parity on the card (reduced stablelm-12b at head "
          "dim 160 and nemotron-4-340b at 192, float32)", flush=True)
    for name, hd in (("stablelm-12b", 160), ("nemotron-4-340b", 192)):
        streams = {}
        for impl in ("pallas", "reference"):
            print(f"reduced {name}, head dim {hd}, attention_impl {impl}:",
                  flush=True)
            fa.flash_attention.launches = 0
            streams[impl] = _parity(dataclasses.replace(
                C.reduced(name), head_dim=hd, dtype="float32",
                attention_impl=impl), mdl, S, memtier, cori, engine)
            launches = fa.flash_attention.launches
            print(f"flash_attention launches {launches}", flush=True)
            if (launches > 0) != (impl == "pallas"):
                _fail(f"reduced {name} under {impl}: {launches} flash "
                      "launches")
        same = streams["pallas"] == streams["reference"]
        print(f"generate's greedy streams, pallas == reference: {same}",
              flush=True)
        if not same:
            _fail(f"reduced {name}: the flash route's streams "
                  f"{streams['pallas']} differ from the reference route's "
                  f"{streams['reference']}")


# ---------------------------------------------------------------------------
# shared prefix pages and the single-stream tiered path: paligemma-3b
# ---------------------------------------------------------------------------

# paligemma-3b's access threshold: under near-uniform attention (random
# weights) a row spreads its layer-averaged mass over the 16 prefix pages
# and its 8-40 own pages, ~0.02-0.04 a page (merged: 0.005-0.038, p50
# 0.024 on an H100 at full width), below the default of 0.05, where no
# page would count as accessed and the tuner would never leave its
# profile window.  0.01 counts a page as accessed while its row attends
# it (phase 27 prints the merged masses it saw)
PALIGEMMA_ACCESS_THRESHOLD = 0.01
# the single-stream path (phase 28): 4 prompts of 16 tokens after the
# prefix, 48 decode steps, pages of 16 (examples/serve_tiered.py's loop)
STREAM_BATCH, STREAM_PROMPT, STREAM_STEPS, STREAM_PAGE = 4, 16, 48, 16


def phase_paligemma(C, mdl, pa, fa, S, memtier, cori, telemetry, kernels):
    print("== phase 27: full-width paligemma-3b serving (shared prefix "
          "pages, bidirectional prefix, macro-step batcher)", flush=True)
    cfg, params = _init_full(C, mdl, "paligemma-3b")
    ex = _session_prefix(cfg)
    page_bytes = 2 * cfg.num_layers * 16 * cfg.num_kv_heads * cfg.head_dim * 4
    print(f"prefix {tuple(ex.shape)} drawn N(0, 1) from the seed (the "
          f"SigLIP tower is a stub): {cfg.prefix_len // 16} shared pages of "
          f"16, each {page_bytes / 2 ** 10:.0f} KiB of k and v over "
          f"{cfg.num_layers} layers; tied embedding "
          f"{cfg.vocab_size * cfg.d_model * 4 / 1e9:.2f} GB", flush=True)

    def check(b, result, eager):
        result["launches"] = pa.paged_attention.launches
        _check_launches("paged_attention", result["launches"],
                        cfg.num_layers, b, eager)
        if fa.flash_attention.launches:
            _fail("paligemma-3b (attention_impl 'reference': the flash "
                  "kernel has no prefix-LM mask) launched the flash kernel")
        _check_cori_acted(b)

    results, _ = _serve_routes(params, cfg, S, memtier, cori, telemetry,
                               kernels, check, n_logical=512,
                               access_threshold=PALIGEMMA_ACCESS_THRESHOLD,
                               extra_embeds=ex)
    return cfg, params, ex, results


def phase_single_stream(mdl, pa, memtier, engine, cfg, params, ex) -> dict:
    """The port's counterpart of examples/serve_tiered.py at full width,
    on phase 27's parameters and prefix."""
    print("== phase 28: the single-stream tiered path at full width "
          "(paligemma-3b: monitored_generate, cori_tune_period, a physical "
          "pass over PagedPools, the online tuner in the loop)", flush=True)
    import torch.nn.functional as F
    from repro_torch.memtier import workload as TW
    page, steps = STREAM_PAGE, STREAM_STEPS
    rng = np.random.default_rng(SEED + 3)
    prompts = rng.integers(0, cfg.vocab_size,
                           (STREAM_BATCH, STREAM_PROMPT)).astype(np.int32)
    rows = ex.expand((STREAM_BATCH,) + tuple(ex.shape[1:]))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    toks, mass = engine.monitored_generate(params, cfg, prompts, steps,
                                           page_size=page, extra_embeds=rows)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_pages = mass.shape[1]
    sums = mass.sum(axis=1)
    print(f"monitored_generate: {STREAM_BATCH} x {steps} tokens in "
          f"{wall:.2f} s ({STREAM_BATCH * steps / wall:.1f} tokens/s, prefill "
          f"and the monitor included), masses {mass.shape[0]} steps x "
          f"{n_pages} pages, per-step sums {sums.min():.3f}-{sums.max():.3f} "
          f"(bounds (0.5, {2 * cfg.num_heads}])", flush=True)
    if tuple(toks.shape) != (STREAM_BATCH, steps) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        _fail(f"monitored_generate gave tokens {tuple(toks.shape)}")
    if mass.shape != (steps - 1, -(-(cfg.prefix_len + STREAM_PROMPT + steps)
                                   // page)):
        _fail(f"monitored_generate gave masses {mass.shape}")
    if not (np.isfinite(mass).all() and (mass >= 0).all()
            and (sums <= 2 * cfg.num_heads + 1e-3).all()
            and (sums > 0.5).all()):
        _fail("the monitor's masses are not probability-like")

    tc = memtier.TierConfig(page_size=page, hbm_pages=max(2, n_pages // 4),
                            period_steps=4)
    res, dr = memtier.cori_tune_period(mass, tc)
    fixed = {p: memtier.replay(mass, dataclasses.replace(
        tc, period_steps=p)).modeled_time for p in (1, 4, 16)}
    print(f"Cori: dominant reuse {dr:.1f} decode steps, chose period "
          f"{res.chosen_period:.0f} in {res.trials} trials (modeled time "
          f"{res.chosen_runtime:.0f}); fixed periods 1 / 4 / 16: "
          + " / ".join(f"{t:.0f}" for t in fixed.values())
          + f" ({tc.hbm_pages} of {n_pages} pages in HBM)", flush=True)

    # the monitor layer's own k/v (its last repeat), row 0's timeline cut
    # into pages: the host tier of the physical pass
    si, sj = engine.monitor_slot(cfg)
    full = torch.cat([torch.as_tensor(prompts[:1], dtype=torch.int64,
                                      device=DEV), toks[:1, :-1]], dim=1)
    _, cache = mdl.prefill(params, cfg, full, extra_embeds=ex)
    c = cache["segments"][si][sj]
    pad = n_pages * page - c["k"].shape[2]
    host = [F.pad(c[n][-1, 0], (0, 0, 0, 0, 0, pad)).reshape(
        (n_pages, page) + tuple(c[n].shape[3:])).contiguous()
        for n in ("k", "v")]
    del cache, c

    def physical(name, seq, period):
        """A physical pass over fresh pools of those pages; fails unless
        its accounting equals the symbolic replay's and every resident
        HBM page equals its host page bit for bit."""
        cfg_p = dataclasses.replace(tc, period_steps=period)
        pools = memtier.PagedPools.create(host[0].clone(), host[1].clone(),
                                          tc.hbm_pages)
        mgr = memtier.TieringManager(n_pages, cfg_p)
        t0 = time.monotonic()
        for t in range(seq.shape[0]):
            mgr.on_step(seq[t], memtier.resident_mask(mgr, pools))
            pools = mgr.maybe_tier(pools)
        torch.cuda.synchronize()
        pass_s = time.monotonic() - t0
        sym = memtier.replay(seq, cfg_p)
        same = all(getattr(mgr, k) == getattr(sym, k) for k in (
            "migrations", "modeled_time", "data_moved_pages", "hits",
            "misses"))
        resident = np.nonzero(pools.slot_of >= 0)[0]
        slot = torch.as_tensor(pools.slot_of[resident].astype(np.int64),
                               device=DEV)
        gid = torch.as_tensor(resident, device=DEV)
        bit_equal = (torch.equal(pools.k_hbm[slot], pools.k_host[gid])
                     and torch.equal(pools.v_hbm[slot], pools.v_host[gid]))
        print(f"physical pass ({name}) at period {period}: "
              f"{mgr.migrations} page swaps, {mgr.data_moved_pages} pages "
              f"moved, resident {resident.tolist()} at slots "
              f"{pools.slot_of[resident].tolist()}, in {pass_s * 1e3:.1f} "
              f"ms; accounting == the symbolic replay: {same}; every "
              f"resident HBM page bit-equal to its host page: {bit_equal}",
              flush=True)
        if not (same and bit_equal):
            _fail(f"the physical pass ({name}) disagrees with the symbolic "
                  "replay, or an HBM page differs from its host page")
        return mgr, pools, resident, slot, gid

    period = max(1, int(res.chosen_period))
    physical("the monitor's masses, Cori's period", mass, period)
    # a drifting sink-and-window pattern over the same pages, which must
    # move some of them (under near-uniform attention the monitor's
    # masses may rank every page alike and move none)
    sink = TW.attention_sink(steps - 1, n_pages, drift_every=1,
                             seed=SEED)
    mgr, pools, resident, slot, gid = physical(
        "workload.attention_sink", sink, 1)
    if mgr.migrations <= 0:
        _fail("the attention_sink pass moved no page")

    # kernel 1 over the HBM tier through slot_of == its plain version over
    # the host tier through the logical ids, on the resident pages
    g = torch.Generator(device=DEV).manual_seed(SEED + 37)
    q = torch.randn((1, cfg.num_heads, cfg.head_dim), generator=g,
                    device=DEV)
    ln = torch.tensor([len(resident) * page], dtype=torch.int32, device=DEV)
    out, m = pa.paged_attention(q, pools.k_hbm, pools.v_hbm,
                                slot.to(torch.int32)[None], ln)
    ref_o, ref_m = pa.paged_attention_plain(q, pools.k_host, pools.v_host,
                                            gid.to(torch.int32)[None], ln)
    err = max(float((out - ref_o).abs().max()),
              float((m - ref_m).abs().max()))
    print(f"paged_attention over the HBM tier after the attention_sink "
          f"pass (slots "
          f"{pools.slot_of[resident].tolist()}) vs its plain version over "
          f"the host pages (ids {resident.tolist()}): err {err:.3g} (tol "
          "1e-5)", flush=True)
    if not err <= 1e-5:
        _fail("the kernel over the tiered pool disagrees with its plain "
              "version over the host pages")

    # examples/serve_tiered.py --online: the tiering and an online tuner
    # in the decode loop, through on_mass
    from repro_torch.core.cori import OnlineTuner
    pools = memtier.PagedPools.create(host[0].clone(), host[1].clone(),
                                      tc.hbm_pages)
    mgr = memtier.TieringManager(n_pages, tc)
    tuner = OnlineTuner(n_pages, default_period=tc.period_steps,
                        profile_steps=max(8, steps // 4),
                        trial_steps=max(4, steps // 8),
                        access_threshold=tc.access_threshold)

    def on_mass(i, mass_i):
        nonlocal pools
        before = mgr.modeled_time
        mgr.on_step(mass_i, pools.slot_of >= 0)
        pools = mgr.maybe_tier(pools)
        mgr.set_period(tuner.on_step(mass_i, cost=mgr.modeled_time - before))

    toks2, mass2 = engine.monitored_generate(
        params, cfg, prompts, steps, page_size=page, extra_embeds=rows,
        on_mass=on_mass)
    online_same = bool(torch.equal(toks2, toks)) and bool(
        np.abs(mass2 - mass).max() <= 1e-5)
    print(f"online: state {tuner.state}, period {tuner.period}, dominant "
          f"reuse {tuner.dominant_reuse}, {len(tuner.tried)} live trials, "
          f"{tuner.retunes} tune cycles, history {tuner.history}; tiering "
          f"{mgr.migrations} swaps, {mgr.data_moved_pages} pages moved, "
          f"modeled time {mgr.modeled_time:.0f}; tokens equal and masses "
          f"within 1e-5 of the offline run: {online_same}", flush=True)
    if not online_same:
        _fail("the online run's tokens or masses differ from the offline "
              "run's")
    return dict(tokens_per_s=STREAM_BATCH * steps / wall, n_pages=n_pages,
                dominant_reuse=float(dr), period=float(res.chosen_period),
                trials=res.trials, chosen_time=float(res.chosen_runtime),
                fixed_time=fixed, online_migrations=mgr.migrations,
                kernel_err=err)


def phase_prefix_parity(C, mdl, S, memtier, cori, engine):
    print("== phase 29: parity on the card (reduced paligemma-3b with its "
          "prefix, float32)", flush=True)
    cfg = dataclasses.replace(C.reduced("paligemma-3b"), dtype="float32")
    _parity(cfg, mdl, S, memtier, cori, engine)
    params = mdl.init(cfg, seed=SEED)
    ex = _session_prefix(cfg).expand(2, -1, -1)
    prompts = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    toks, mass = engine.monitored_generate(params, cfg, prompts, 8,
                                           page_size=4, extra_embeds=ex)
    want = engine.generate(params, cfg, prompts, 8, extra_embeds=ex)
    same = bool(torch.equal(toks, want))
    print(f"monitored_generate's tokens == generate's: {same} (masses "
          f"{mass.shape})", flush=True)
    if not same:
        _fail("monitored_generate's tokens differ from generate's")


# the scheduler steps after which phase 30 probes every in-flight request
# with ``paged_context`` (a run of 8 requests on 4 rows takes ~150 steps)
DENSE_PROBE_STEPS = (2, 40, 80, 120)
PROBE_TOL = 1e-5


def _probe_contexts(b, pa, mdl, engine, g) -> list:
    """``paged_context`` of every in-flight request of ``b`` on a seeded q
    [1, H, D], held within ``PROBE_TOL`` of ``paged_attention_plain`` over
    the host tier through the request's logical page ids (the legacy pair
    on the dense path, the monitor slot's layered host leaf, last repeat,
    on the paged one); each probe must launch kernel 1 once and charge its
    demand fetches as misses.  Returns one record a probe, with the
    kernel's inputs."""
    cfg, pools, mgr = b.cfg, b.monitor.pools, b.monitor.manager
    page = b.page_size
    out = []
    for req in sorted(b.active.values(), key=lambda r: r.rid):
        q = torch.randn((1, cfg.num_heads, cfg.head_dim), generator=g,
                        device=DEV)
        before, misses = pa.paged_attention.launches, mgr.misses
        ctx, fetched = b.paged_context(req.rid, q)
        torch.cuda.synchronize()
        launched = pa.paged_attention.launches - before
        length = int(b.pos[req.row])
        n = -(-length // page)
        if b.paged:
            li = mdl.attn_slot_index(cfg, *engine.monitor_slot(cfg))
            k_host, v_host = (pools.kv_layers[f"{x}_host"][li][-1]
                              for x in ("k", "v"))
            k_hbm, v_hbm = (pools.kv_layers[f"{x}_hbm"][li][-1]
                            for x in ("k", "v"))
            gids = req.table_gids[:n]
        else:
            k_host, v_host, k_hbm, v_hbm = (pools.k_host, pools.v_host,
                                            pools.k_hbm, pools.v_hbm)
            gids = req.gids[:n]
        as_table = lambda a: torch.as_tensor(
            np.asarray(a, np.int32)[None], device=DEV)
        lengths = torch.tensor([length], dtype=torch.int32, device=DEV)
        ref, _ = pa.paged_attention_plain(q, k_host, v_host, as_table(gids),
                                          lengths)
        err = float((ctx - ref).abs().max())
        rec = dict(step=b.step_idx, rid=req.rid, length=length, pages=n,
                   fetched=fetched, err=err,
                   args=dict(q=q, k_pages=k_hbm, v_pages=v_hbm,
                             page_table=as_table(pools.table(gids)),
                             lengths=lengths, window=0, softcap=0.0))
        out.append(rec)
        if launched != 1:
            _fail(f"paged_context launched kernel 1 {launched} times")
        if not err <= PROBE_TOL:
            _fail(f"paged_context of request {req.rid} at step "
                  f"{b.step_idx}: err {err:.3g} against the plain version "
                  f"over the host pages (tol {PROBE_TOL})")
        if mgr.misses - misses != fetched:
            _fail("paged_context did not charge its demand fetches")
    return out


# how far (as a share of the distribution's mass) a sampled token's CDF
# interval may lie from the draw where two paths' sampled streams part:
# a few times the flip measured on the card (2.98e-07) and well under one
# token's interval of a near-uniform 151936-way draw (6.6e-06)
SAMPLED_FLIP_TOL = 1e-6


def _compare_streams(mdl, cfg, params, reqs, got, want, what,
                     ref="phase 4's") -> None:
    """Fail unless ``got`` equals ``want`` request for request, but for at
    most one sampled stream that parts from ``want`` where the draw lands
    on a boundary: at the first token t where they differ, the next-token
    distribution after their common prefix (one ``prefill`` over prompt
    + prefix, softmax at the request's temperature, as ``model.sample``)
    must put the draw ``uniform(seed, t)`` within ``SAMPLED_FLIP_TOL`` of
    the mass of both tokens' CDF intervals.  Two float32 paths that
    compute attention in another order give logits that differ by
    rounding, and a near-uniform 151936-way draw then lands on the other
    side of a boundary; past that token the two streams are different
    samples, so only their lengths are held.  Greedy streams are held
    exactly, and a second parted stream fails."""
    parted = []
    for r in reqs:
        a, b = got[r.rid], want[r.rid]
        if a == b:
            continue
        if r.temperature == 0 or len(a) != len(b):
            _fail(f"{what}: request {r.rid}'s stream differs from {ref} "
                  f"(temperature {r.temperature})")
        parted.append(r.rid)
        if len(parted) > 1:
            _fail(f"{what}: sampled requests {parted} all part from {ref} "
                  "streams; one rounding flip a run is allowed")
        t = next(i for i in range(len(a)) if a[i] != b[i])
        toks = np.concatenate([r.prompt, np.asarray(a[:t], np.int32)])
        logits, _ = mdl.prefill(params, cfg,
                                torch.as_tensor(toks, device=DEV)[None])
        cdf = torch.softmax(logits[0, 0].float() / r.temperature, dim=-1) \
            .cumsum(dim=-1)
        u = mdl.uniform(torch.tensor([r.seed], device=DEV),
                        torch.tensor([t], device=DEV))
        x = float(u[0] * cdf[-1])
        cdf = cdf.double().cpu().numpy()

        def off(k):
            lo = cdf[k - 1] if k else 0.0
            return max(0.0, lo - x, x - cdf[k]) / cdf[-1]

        print(f"{what}: sampled request {r.rid} parts from {ref} at "
              f"token {t} of {len(a)} ({a[t]} vs {b[t]}; the first {t} "
              f"equal): the draw {x / cdf[-1]:.7f} of the mass lies "
              f"{off(a[t]):.2e} and {off(b[t]):.2e} from the two tokens' "
              f"intervals (tol {SAMPLED_FLIP_TOL})", flush=True)
        if max(off(a[t]), off(b[t])) > SAMPLED_FLIP_TOL:
            _fail(f"{what}: request {r.rid} parts at token {t} away from "
                  "the draw's boundary")


def _print_probes(probes) -> None:
    print(f"paged_context: {len(probes)} probes at steps "
          f"{sorted({p['step'] for p in probes})}: (step, rid, length, "
          f"pages, fetched, max abs err) "
          + ", ".join(f"({p['step']}, {p['rid']}, {p['length']}, "
                      f"{p['pages']}, {p['fetched']}, {p['err']:.3g})"
                      for p in probes), flush=True)


def phase_dense(mdl, pa, S, memtier, cori, engine, telemetry, kernels, cfg,
                params, want):
    """Phase 4's mix served by the dense batcher on phase 4's parameters,
    with the monitor and ``mirror_pages`` over physical single-layer
    pools; ``paged_context`` probes on it and on a short fully-paged
    batcher.  ``want`` is phase 4's graph-route streams."""
    print("== phase 30: the dense batcher at full width (qwen3-14b, "
          "paged=False, mirror_pages over the legacy single-layer pools)",
          flush=True)
    page, n_logical, hbm_pages = 16, 256, 128
    torch.cuda.reset_peak_memory_stats()

    def stack(pools):
        mgr = memtier.TieringManager(n_logical, memtier.TierConfig(
            page_size=page, hbm_pages=hbm_pages, period_steps=8,
            access_threshold=0.05))
        tuner = cori.OnlineTuner(n_logical, default_period=8,
                                 access_threshold=0.05)
        return S.TrafficMonitor(pools, mgr, tuner)

    pools = memtier.SharedPagedPools.create(
        n_logical, hbm_pages, page_size=page, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim)
    mon = stack(pools)
    b = S.ContinuousBatcher(params, cfg, monitor=mon, max_active=4,
                            max_len=1024, page_size=page, paged=False,
                            mirror_pages=True)
    if b.paged or not b.mirror_pages or b.route != "eager":
        _fail(f"the dense batcher is paged={b.paged}, mirror_pages="
              f"{b.mirror_pages}, route {b.route}")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    cache_gb = nbytes([a for seg in b.cache["segments"] for e in seg
                       for a in e.values()]) / 1e9
    print(f"packed cache {cache_gb:.3f} GB (4 rows x 1024 positions x "
          f"{cfg.num_layers} layers, k/v float32 + int64 positions); pools: "
          f"{n_logical} logical pages, {hbm_pages} HBM slots, page {page}: "
          f"{nbytes([pools.k_host, pools.v_host, pools.k_hbm, pools.v_hbm]) / 1e6:.1f}"
          " MB of float32 k/v of the monitor layer", flush=True)
    reqs = _mix_requests(S, cfg, np.random.default_rng(SEED), 8, (128, 513),
                         (48, 97))
    rec = telemetry.install(telemetry.Recorder())
    for r in reqs:
        b.submit(r)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    probes, walls = [], []
    _reset_counts(kernels)
    torch.cuda.synchronize()
    while not b.idle:
        t0 = time.monotonic()
        b.step()
        walls.append(time.monotonic() - t0)
        if b.step_idx in DENSE_PROBE_STEPS:
            probes += _probe_contexts(b, pa, mdl, engine, g)
    launches = pa.paged_attention.launches
    counts = {k.NAME: getattr(k, k.NAME).launches for k in kernels}
    out = {r.rid: list(r.tokens) for r in b.completed}
    n_tok = sum(len(v) for v in out.values())
    wall = float(sum(walls))
    mon_s = rec.hists["serve.monitor_s"].total
    step_s = rec.hists["serve.step_s"].total
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mgr, tuner = mon.manager, mon.tuner
    print(f"served {len(out)} requests, {n_tok} tokens in {wall:.2f} s of "
          f"scheduler steps: {n_tok / wall:.2f} tokens/s (prefill "
          f"included); {len(walls)} steps, {b.decode_steps} decode steps, "
          f"step wall p50 {float(np.median(walls)) * 1e3:.1f} ms (max "
          f"{max(walls) * 1e3:.1f}); the monitor (its masses, one host read, "
          f"the merge and the tiering feed) {mon_s:.3f} s of {step_s:.3f} "
          f"s: {mon_s / step_s * 100:.1f}% of the steps", flush=True)
    print(f"tiering: migrations {mgr.migrations}, hits {mgr.hits}, misses "
          f"{mgr.misses}, modeled time {mgr.modeled_time:.0f}; tuner: state "
          f"{tuner.state}, period {tuner.period}, history {tuner.history}; "
          f"peak device memory {peak_gb:.2f} GB (the weights included)",
          flush=True)
    _print_probes(probes)
    print(f"kernel launches in the run: {counts}", flush=True)
    telemetry.install(telemetry.Recorder())
    if sorted(out) != sorted(want):
        _fail(f"the dense run completed requests {sorted(out)}")
    _compare_streams(mdl, cfg, params, reqs, out, want, "dense")
    same = sorted(r for r in want if out[r] == want[r])
    print(f"dense streams == phase 4's graph-route streams: requests "
          f"{same} of {sorted(want)}", flush=True)
    if pools.free_pages != n_logical or pools.allocated_pages:
        _fail("pages leaked after the dense drain")
    if len({p["step"] for p in probes}) < 3:
        _fail("fewer than three probe points in the dense run")
    if launches != len(probes) or any(
            v for k, v in counts.items() if k != "paged_attention"):
        _fail(f"kernel launches {counts} in the dense run, expected "
              f"paged_attention = {len(probes)} probes and nothing else")
    print(f"paged_attention launches {launches} = {len(probes)} probes -> "
          "True", flush=True)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    longest = max(probes, key=lambda p: p["length"])
    times, text = _paged_timing(pa, longest["args"], flush)
    print(f"kernel 1 a probe (B=1, H={cfg.num_heads}, KV="
          f"{cfg.num_kv_heads}, D={cfg.head_dim}, {longest['pages']} pages "
          f"of the {hbm_pages}-slot single-layer pool, length "
          f"{longest['length']}): {text}", flush=True)
    pa.paged_attention.launches = launches    # timing launches not counted
    result = dict(tokens=n_tok, tokens_per_s=n_tok / wall,
                  step_p50_ms=float(np.median(walls)) * 1e3,
                  monitor_share=mon_s / step_s, peak_gb=peak_gb,
                  migrations=mgr.migrations, hits=mgr.hits,
                  misses=mgr.misses, tuner_history=list(tuner.history),
                  probe=dict(times, launches=launches,
                             max_abs_err=max(p["err"] for p in probes)))
    del b, probes, longest
    gc.collect()
    torch.cuda.empty_cache()

    print("-- paged_context on a fully-paged batcher (graph route, the "
          "first 4 requests of the mix, fresh pools)", flush=True)
    mon = stack(memtier.SharedPagedPools.create(n_logical, hbm_pages))
    b = S.ContinuousBatcher(params, cfg, monitor=mon, max_active=4,
                            max_len=1024, page_size=page)
    if b.route != "graph":
        _fail(f"the paged batcher took the {b.route} route")
    reqs = _mix_requests(S, cfg, np.random.default_rng(SEED), 8,
                         (128, 513), (48, 97))[:4]
    for r in reqs:
        b.submit(r)
    _reset_counts(kernels)
    probes = []
    while not b.idle:
        b.step()
        if b.step_idx <= 3 and b.active:
            probes += _probe_contexts(b, pa, mdl, engine, g)
    _print_probes(probes)
    launches = pa.paged_attention.launches
    expect = cfg.num_layers * b.device_steps + len(probes)
    print(f"paged_attention launches {launches} = {cfg.num_layers} layers x "
          f"{b.device_steps} device steps + {len(probes)} probes -> "
          f"{launches == expect}", flush=True)
    if launches != expect:
        _fail("paged_context's launches on the paged batcher")
    if len({p["step"] for p in probes}) < 3:
        _fail("fewer than three probe points on the paged batcher")
    _compare_streams(mdl, cfg, params, reqs,
                     {r.rid: list(r.tokens) for r in b.completed}, want,
                     "paged")
    result["paged_probes"] = len(probes)
    result["paged_probe_err"] = max(p["err"] for p in probes)
    del b, probes
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_traffic(TR) -> dict:
    """The traffic benchmark's replays at full size (host only), from
    ``repro_torch.serve.traffic_replay``, against the benchmark's bars."""
    print("== phase 31: the model-free traffic replay at the benchmark's "
          "full size (host only: TrafficScheduler over symbolic pools, no "
          "kernel and no device)", flush=True)
    t0 = time.monotonic()
    r = TR.run()
    run_s = time.monotonic() - t0
    sched, tuner, mgr = r["sched"], r["tuner"], r["sched"].monitor.manager
    online = TR.window_cost(r["online"])
    steady = {p: TR.window_cost(tr) for p, tr in r["fixed"].items()}
    best = min(steady.values())
    reduction = 1.0 - sched.peak_cache_pages / sched.dense_cache_pages
    print(f"stream: {len(r['specs'])} requests over {len(r['online']) - 1} "
          f"steps; admitted {sched.admitted}, completed {sched.completed}; "
          f"online + {len(steady)} fixed replays {run_s:.2f} s", flush=True)
    print(f"online: total {mgr.modeled_time:.2f}, steady {online:.4f} a "
          f"step (last {TR.STEADY} steps); migrations {mgr.migrations}, "
          f"hits {mgr.hits}, misses {mgr.misses}; tuner {tuner.state}, "
          f"period {tuner.period}, history {tuner.history}", flush=True)
    print("fixed (period: total, steady): " + ", ".join(
        f"{p}: {tr[-1]:.2f}, {steady[p]:.4f}" for p, tr in
        r["fixed"].items()), flush=True)
    print(f"online steady / best fixed steady = {online / best:.4f} "
          f"(bar 1.05); peak cache pages {sched.peak_cache_pages} vs dense "
          f"{sched.dense_cache_pages}: {reduction * 100:.1f}% reduction "
          "(bar 25%)", flush=True)

    h = TR.hostile()
    hsched, htuner = h["sched"], h["tuner"]
    regrets = {}
    for i, name in enumerate(TR.HOSTILE_PHASES):
        e = (i + 1) * TR.HOSTILE_PHASE_STEPS
        cost = {p: TR.window_cost(tr, e) for p, tr in h["fixed"].items()}
        best_p = min(cost.values())
        regrets[name] = TR.window_cost(h["online"], e) / best_p
        print(f"hostile {name}: online {TR.window_cost(h['online'], e):.4f}"
              f" a step vs best fixed {best_p:.4f} (" + ", ".join(
                  f"{p}: {c:.4f}" for p, c in cost.items())
              + f"): regret {regrets[name]:.4f}", flush=True)
    print(f"hostile: {len(h['specs'])} requests, admitted "
          f"{hsched.admitted}, completed {hsched.completed}; tuner "
          f"{htuner.state}, period {htuner.period}, {htuner.retunes} tune "
          f"cycles, {htuner.guard_trips} guard trips, history "
          f"{htuner.history}; max regret {max(regrets.values()):.4f} "
          "(bar 1.15)", flush=True)
    if not online <= 1.05 * best:
        _fail(f"online steady {online:.4f} above 1.05 x the best fixed "
              f"{best:.4f}")
    if not reduction >= 0.25:
        _fail(f"cache reduction {reduction:.3f} below 25%")
    if not max(regrets.values()) <= 1.15:
        _fail(f"hostile regret {max(regrets.values()):.4f} above 1.15")
    return dict(online_steady=online, best_fixed_steady=best,
                history=list(tuner.history),
                peak_pages=sched.peak_cache_pages,
                dense_pages=sched.dense_cache_pages,
                hostile_max_regret=max(regrets.values()))


def _pipeline_stats(rec) -> dict:
    """The pipelined loop's records in a run: table uploads performed and
    skipped, decisions, completed macros, each stage's wall p50 and the
    decisions' wait p50 (ms)."""
    counters = rec.summary()["counters"]
    stages = {}
    for e in rec.events("serve.pipeline.stage"):
        stages.setdefault(e["stage"], []).append(e["wall_ms"])
    waits = [e["wait_ms"] for e in rec.events("serve.pipeline.decision")]
    return dict(
        uploads=int(counters.get("pool.table_upload.performed", 0)),
        skipped=int(counters.get("pool.table_upload.skipped", 0)),
        decisions=len(waits), macros=len(rec.events("serve.macro")),
        stage_p50_ms={k: float(np.median(v)) for k, v in stages.items()},
        decision_wait_p50_ms=float(np.median(waits)),
        decision_wait_max_ms=float(max(waits)))


def _check_pipeline(name, b, st) -> None:
    """What every pipelined run must show: the graph route, one decision
    a completed macro (the boundaries less the first, which has nothing
    to decide), a table upload skipped at a quiet boundary, and the
    closed set of stages."""
    boundaries = st["macros"] + 1
    print(f"{name}: route {b.route}; decisions {st['decisions']} = "
          f"{boundaries} macro boundaries - 1 -> "
          f"{st['decisions'] == boundaries - 1}; table uploads "
          f"{st['uploads']} performed, {st['skipped']} skipped; stage wall "
          f"p50 (ms) {st['stage_p50_ms']}; decision wait p50 "
          f"{st['decision_wait_p50_ms']:.3f} ms (max "
          f"{st['decision_wait_max_ms']:.3f})", flush=True)
    if b.route != "graph":
        _fail(f"{name}: the pipelined batcher took the {b.route} route")
    if st["decisions"] != boundaries - 1:
        _fail(f"{name}: {st['decisions']} decisions for {st['macros']} "
              "macros")
    if st["skipped"] < 1:
        _fail(f"{name}: no boundary reused the staged tables")
    if not {"decision_wait", "prefetch", "tables"} <= set(
            st["stage_p50_ms"]):
        _fail(f"{name}: stages {sorted(st['stage_p50_ms'])}")


def phase_pipelined(mdl, pa, S, memtier, cori, telemetry, kernels, cfg,
                    params, want, serve):
    """Phase 4's mix through ``ContinuousBatcher(pipeline=True)`` on phase
    4's parameters, pools, tiering and tuner (the graph route): streams
    held to phase 4's graph route's (``_compare_streams``), the drain,
    kernel 1's launches, the pipeline's records, and tokens/s beside phase
    4's in this run; one pipelined macro profiled."""
    print("== phase 32: the pipelined macro loop at full width (qwen3-14b, "
          "pipeline=True, graph route)", flush=True)
    keep = {}
    b, res, same, rng, reqs = _serve_mix(params, cfg, S, memtier, cori,
                                         telemetry, kernels, keep=keep,
                                         pipeline=True)
    res["launches"] = pa.paged_attention.launches
    _check_launches("paged_attention", res["launches"], cfg.num_layers, b,
                    False)
    _compare_streams(mdl, cfg, params, reqs, same["streams"], want,
                     "pipelined")
    print(f"pipelined streams == phase 4's graph-route streams: requests "
          f"{sorted(r for r in want if same['streams'][r] == want[r])} of "
          f"{sorted(want)}", flush=True)
    st = _pipeline_stats(keep.pop("recorder"))
    _check_pipeline("pipelined", b, st)
    res.update(st, migrations=same["migrations"], hits=same["hits"],
               misses=same["misses"], tuner_history=same["tuner_history"])
    res["profile"] = _profile_macro(b, S, cfg, rng)
    b.close()
    prof = res["profile"]
    busy = ("busy/idle not measured" if prof["busy_pct"] is None else
            f"busy {prof['busy_pct']:.1f}% / idle {prof['idle_pct']:.1f}%")
    print(f"qwen3-14b pipelined: {res['tokens_per_s']:.2f} tokens/s "
          f"(phase 4's graph route in this run: "
          f"{serve['graph']['tokens_per_s']:.2f}), macro wall p50 "
          f"{res['macro_p50_ms']:.1f} ms (phase 4: "
          f"{serve['graph']['macro_p50_ms']:.1f}), decision wait p50 "
          f"{st['decision_wait_p50_ms']:.3f} ms, one profiled pipelined "
          f"macro {prof['ms_per_step']:.1f} ms/step, {busy}; tiering "
          f"{same['migrations']} migrations, {same['hits']} hits, "
          f"{same['misses']} misses (phase 4: "
          f"{serve['graph']['migrations']}, {serve['graph']['hits']}, "
          f"{serve['graph']['misses']}); tuner history "
          f"{same['tuner_history']}", flush=True)
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return res


# the degradation ladder at full width (phases 34-35): windows in
# scheduler steps (phase 4's mix takes ~20), as tests/test_faults.py's
# chaos plan counts them.  The squeeze holds 48 of the 128 HBM pages,
# below four rows of 8-38 pages each.  The watchdog's deadline sits far
# above every decision wait of phase 32 (checked), and the injected delay
# far above the deadline, so only the delay trips it.
CHAOS_SQUEEZE = 48
CHAOS_WATCHDOG_S = 1.0
CHAOS_DELAY_S = 4.0
CHAOS_MAX_QUEUE = 2
CHAOS_RESTARTS = 3
CHAOS_MAX_STEPS = 400


def _chaos_plan(inject):
    """A plan that fires every kind in ``inject.FAULT_KINDS``: the flood
    over the submissions made before the first step, a squeeze, failing
    and slow migrations, a hung worker for three decisions and a crashed
    one for two (restarts 4 > 3: degraded for good), corrupted masses."""
    P = inject.FaultPoint
    return inject.FaultPlan([
        P("pool.squeeze", start=4, stop=8, value=CHAOS_SQUEEZE),
        P("pool.migrate_fail", start=2, stop=20, prob=0.7),
        P("pool.migrate_slow", start=2, stop=20, prob=0.3, value=0.002),
        P("worker.delay", start=3, stop=6, prob=1.0, value=CHAOS_DELAY_S),
        P("worker.crash", start=8, stop=10, prob=1.0),
        P("mass.nonfinite", start=2, stop=30, prob=0.5),
        P("admit.flood", start=0, stop=2, prob=1.0),
    ], seed=SEED + 7)


def _sacrificial(S, cfg, rng):
    """The reference test's sacrificial submissions: rid 100 (ttl 1)
    floods past the queue bound before the first step and expires
    queued; rids 101 and 102 arrive after step 4, the queue over its
    bound, and are shed.  Returns (at step, request) pairs."""
    return [(at, S.Request(
        rid=rid, prompt=rng.integers(0, cfg.vocab_size, 5).astype(np.int32),
        max_new_tokens=4, ttl_steps=ttl, seed=SEED + rid))
        for rid, at, ttl in ((100, 0, 1), (101, 4, None), (102, 4, None))]


def _arrivals(subs, counts):
    """A ``_serve_mix`` ``between`` hook: submits the (step, request)
    pairs due at step 0 before the first step and the others after that
    many steps, counts the steps in ``counts["steps"]`` and fails past
    ``CHAOS_MAX_STEPS`` (a hang)."""
    def between(b):
        counts["steps"] = 0
        for at, req in subs:
            if at == 0:
                b.submit(req)

        def hook(b):
            counts["steps"] += 1
            for at, req in subs:
                if at == counts["steps"]:
                    b.submit(req)
            if counts["steps"] > CHAOS_MAX_STEPS:
                _fail(f"no drain after {CHAOS_MAX_STEPS} steps")
        return hook
    return between


def _wait_workers(timeout: float = 10.0) -> int:
    """Wait for abandoned decision-worker threads (a hung worker sleeps
    out its injected delay, then exits); returns how many were left."""
    end = time.monotonic() + timeout
    while True:
        alive = [t for t in threading.enumerate()
                 if t.name == "decision-worker" and t.is_alive()]
        if not alive or time.monotonic() > end:
            return len(alive)
        time.sleep(0.05)


def phase_chaos(mdl, pa, S, memtier, cori, telemetry, kernels, inject,
                cfg, params, want, piped):
    """Phase 4's mix plus the sacrificial submissions through the
    pipelined graph route under ``_chaos_plan``, with a bounded queue, a
    watchdog and three restarts, on phase 4's parameters (pools, tiering
    and tuner as phase 4's).  Fails unless every fault kind fired, the
    run drained with every page back and the batcher's memory returned,
    every submission has a typed status (the mix completed, rid 100
    expired, 101-102 shed), the mix's streams are phase 4's graph
    route's (``_compare_streams``), the watchdog restarted for a hang and
    a crash and then decided in line for good, and kernel 1 launched 40
    x the device steps."""
    print("== phase 34: the degradation ladder under a chaos plan at full "
          "width (qwen3-14b, pipeline=True, graph route)", flush=True)
    longest = piped["decision_wait_max_ms"]
    print(f"watchdog {CHAOS_WATCHDOG_S * 1e3:.0f} ms against phase 32's "
          f"longest decision wait {longest:.3f} ms (p50 "
          f"{piped['decision_wait_p50_ms']:.3f}); injected delay "
          f"{CHAOS_DELAY_S * 1e3:.0f} ms", flush=True)
    if CHAOS_WATCHDOG_S * 1e3 < 5 * longest:
        _fail("the watchdog's deadline is not far above phase 32's waits")
    plan = _chaos_plan(inject)
    rng = np.random.default_rng(SEED + 34)
    subs = _sacrificial(S, cfg, rng)
    counts, keep = {}, {}
    kept = torch.cuda.memory_allocated()
    b, res, same, _, reqs = _serve_mix(
        params, cfg, S, memtier, cori, telemetry, kernels, keep=keep,
        between=_arrivals(subs, counts), pipeline=True, fault_plan=plan,
        max_queue=CHAOS_MAX_QUEUE, watchdog_s=CHAOS_WATCHDOG_S,
        max_worker_restarts=CHAOS_RESTARTS)
    rec = keep.pop("recorder")
    counters = rec.summary()["counters"]
    res["launches"] = pa.paged_attention.launches
    if b.route != "graph":
        _fail(f"the chaos run took the {b.route} route")
    _check_launches("paged_attention", res["launches"], cfg.num_layers, b,
                    False)
    fired = dict(sorted(plan.fired.items()))
    print(f"fault kinds fired (times): {fired}; scheduler steps "
          f"{counts['steps']}", flush=True)
    if set(fired) != set(inject.FAULT_KINDS):
        _fail(f"kinds that never fired: "
              f"{sorted(set(inject.FAULT_KINDS) - set(fired))}")
    statuses = {r.rid: r.status for r in b.completed}
    print(f"statuses {statuses}; shed {b.shed}, expired {b.expired}",
          flush=True)
    expect = {r.rid: "completed" for r in reqs}
    expect.update({100: "expired", 101: "shed", 102: "shed"})
    if statuses != expect:
        _fail(f"statuses {statuses}, expected {expect}")
    _compare_streams(mdl, cfg, params, reqs, same["streams"], want,
                     "chaos")
    restarts = rec.events("serve.worker_restart")
    reasons = [e["reason"] for e in restarts]
    print(f"worker restarts {b._worker_restarts} ({reasons}); degraded for "
          f"good {b._worker_degraded}; preemptions {b.preemptions} (thawed "
          f"{int(counters.get('serve.thawed', 0))}); migrate fails "
          f"{fired['pool.migrate_fail']}, degraded fetches "
          f"{int(counters.get('pool.degraded_fetches', 0))}, tier moves "
          f"failed {int(counters.get('tier.moves_failed', 0))}; "
          f"nan'd feeds {fired['mass.nonfinite']}", flush=True)
    if not {"hang", "crash"} <= set(reasons):
        _fail(f"the watchdog's restarts {reasons} lack a hang or a crash")
    if not b._worker_degraded or b._decision_worker is not None:
        _fail("the spent restarts did not leave the loop deciding in line")
    if b.preemptions < 1 or counters.get("serve.thawed") != b.preemptions:
        _fail(f"{b.preemptions} preemptions, "
              f"{counters.get('serve.thawed')} thawed")
    if not all(math.isfinite(c) for c in b.monitor.tuner.cost_log):
        _fail("a non-finite cost reached the tuner")
    res.update(fired=fired, steps=counts["steps"], shed=b.shed,
               expired=b.expired, preemptions=b.preemptions,
               restarts=b._worker_restarts, reasons=reasons,
               degraded_fetches=int(counters.get("pool.degraded_fetches",
                                                 0)),
               migrations=same["migrations"], hits=same["hits"],
               misses=same["misses"], tuner_history=same["tuner_history"])
    print(f"qwen3-14b under chaos: {res['tokens_per_s']:.2f} tokens/s "
          f"(phase 32 pipelined in this run: {piped['tokens_per_s']:.2f}), "
          f"wall {res['wall_s']:.2f} s, macro wall p50 "
          f"{res['macro_p50_ms']:.1f} ms; tiering {same['migrations']} "
          f"migrations, {same['hits']} hits, {same['misses']} misses; "
          f"tuner history {same['tuner_history']}", flush=True)
    b.close()
    held = torch.cuda.memory_allocated()
    del b
    left = _wait_workers(2 * CHAOS_DELAY_S + 5)
    if left:
        _fail(f"{left} decision-worker threads still alive")
    _check_freed(held, kept)
    return res


def phase_squeeze(mdl, pa, S, memtier, cori, telemetry, kernels, inject,
                  cfg, params, want):
    """Phase 4's mix by phase 4's route (synchronous, graph) under a
    ``pool.squeeze`` to ``CHAOS_SQUEEZE`` HBM pages from step 4 to step
    10: at least one preemption, every frozen request thawed, one
    admission a request (a thaw never prefills), streams held to phase
    4's, kernel 1's launches 40 x the device steps."""
    print("== phase 35: a capacity squeeze on the synchronous graph route "
          "(qwen3-14b, preempt and thaw)", flush=True)
    plan = inject.FaultPlan([inject.FaultPoint(
        "pool.squeeze", start=4, stop=10, value=CHAOS_SQUEEZE)], seed=SEED)
    keep = {}
    kept = torch.cuda.memory_allocated()
    b, res, same, _, reqs = _serve_mix(params, cfg, S, memtier, cori,
                                       telemetry, kernels, keep=keep,
                                       fault_plan=plan)
    rec = keep.pop("recorder")
    counters = rec.summary()["counters"]
    res["launches"] = pa.paged_attention.launches
    if b.route != "graph":
        _fail(f"the squeezed run took the {b.route} route")
    _check_launches("paged_attention", res["launches"], cfg.num_layers, b,
                    False)
    preempts = [(e["step"], e["rid"], e["pages"], e["hbm_need"])
                for e in rec.events("serve.preempt")]
    thawed = int(counters.get("serve.thawed", 0))
    admitted = int(counters.get("serve.admitted", 0))
    print(f"preemptions {b.preemptions} (step, rid, pages released, "
          f"need after): {preempts}; thawed {thawed}; admitted {admitted} "
          f"of {len(reqs)}", flush=True)
    if b.preemptions < 1 or thawed != b.preemptions:
        _fail(f"{b.preemptions} preemptions, {thawed} thawed")
    if admitted != len(reqs):
        _fail(f"{admitted} admissions for {len(reqs)} requests")
    _compare_streams(mdl, cfg, params, reqs, same["streams"], want,
                     "squeezed")
    res.update(preemptions=b.preemptions, preempts=preempts,
               migrations=same["migrations"], hits=same["hits"],
               misses=same["misses"], tuner_history=same["tuner_history"])
    print(f"qwen3-14b squeezed: {res['tokens_per_s']:.2f} tokens/s, wall "
          f"{res['wall_s']:.2f} s, macro wall p50 {res['macro_p50_ms']:.1f} "
          f"ms; tiering {same['migrations']} migrations, {same['hits']} "
          f"hits, {same['misses']} misses", flush=True)
    held = torch.cuda.memory_allocated()
    del b
    _check_freed(held, kept)
    return res


def _flash_chunk_timing(fa, start, window, flush) -> dict:
    """The flash kernel at one admission chunk of phase 33 (float32, B=1,
    S=512 at ``q_offset`` = ``start`` over T = start + 512 keys, 16/8
    heads of 256): per call (CUDA events) and on the device (profiler),
    beside its plain version, one SDPA call over the same mask and the
    3xTF32 bound."""
    import torch.nn.functional as F
    c = FLASH_CHUNK
    b, s, h, kv, d = c["b"], c["s"], c["h"], c["kv"], c["d"]
    t = start + s
    q, k, v = _flash_offset_case(b=b, s=s, t=t, h=h, kv=kv, d=d,
                                 dtype=torch.float32, seed=11)
    call = lambda: fa.flash_attention(q, k, v, window=window,
                                      q_offset=start)
    err = float((call() - fa.flash_attention_plain(
        q, k, v, window=window, q_offset=start)).abs().max())
    tol = 1e-4 if t > 512 else 2e-5
    if not err <= tol:
        _fail(f"flash_attention at the chunk shape q_offset={start}: err "
              f"{err:.3g} (tol {tol})")
    ms = _time(call, 20, flush)
    device_ms, how, _ = _device_ms(call, 10, flush)
    plain_ms = _time(lambda: fa.flash_attention_plain(
        q, k, v, window=window, q_offset=start), 5, flush)
    qp = start + torch.arange(s, device=DEV)[:, None]
    kp = torch.arange(t, device=DEV)[None, :]
    mask = (kp <= qp) & ((kp > qp - window) if window else True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = _time(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 10, flush)
    pairs = int(mask.sum())
    flops = 4 * b * h * d * pairs
    nbytes = (2 * b * s * h * d + 2 * b * t * kv * d) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"admission chunk B=1 S={s} q_offset={start} T={t} 16/8 heads "
          f"D=256 float32 {'window ' + str(window) if window else 'causal'}"
          f" (err {err:.3g}, tol {tol}): kernel {ms:.4f} ms a call, "
          f"{device_ms:.4f} ms on the device ({how}); plain {plain_ms:.4f} "
          f"ms, SDPA {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}; 3xTF32): {pairs} attended pairs, "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB -> "
          f"{bound_ms / device_ms * 100:.1f}% of the bound on the device",
          flush=True)
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err)


def phase_gemma_pipelined(C, mdl, pa, fa, S, memtier, cori, telemetry,
                          kernels, params, want, sync):
    """Phase 15's mix through ``pipeline=True, admit_chunk_tokens=512`` on
    phase 15's parameters (the flash route, the graph route): every
    admission in chunks, each chunk one flash launch a layer with its
    start as the query offset; streams held to phase 15's graph route's;
    the admission stall beside phase 15's synchronous admission wall; the
    flash kernel a chunk call at start 0 and 1536."""
    print("== phase 33: the pipelined loop with chunked admission at full "
          "width (gemma3-12b, pipeline=True, admit_chunk_tokens=512, flash "
          "prefill with a query offset)", flush=True)
    cfg = dataclasses.replace(C.get("gemma3-12b"), attention_impl="pallas")
    keep = {}
    retries = torch.cuda.memory_stats()["num_alloc_retries"]
    b, res, same, rng, reqs = _serve_mix(
        params, cfg, S, memtier, cori, telemetry, kernels, keep=keep,
        n_logical=512, hbm_pages=384, max_len=2048, n_req=6,
        prompt=(1040, 1601), new=(32, 65),
        access_threshold=GEMMA_ACCESS_THRESHOLD, pipeline=True,
        admit_chunk_tokens=FLASH_CHUNK["s"])
    rec = keep.pop("recorder")
    chunk_events = rec.events("serve.pipeline.admit_chunk")
    want_chunks = sum(-(-len(r.prompt) // FLASH_CHUNK["s"]) for r in reqs)
    starts = sorted({e["chunk"] * FLASH_CHUNK["s"] for e in chunk_events})
    res.update(launches=fa.flash_attention.launches,
               paged_launches=pa.paged_attention.launches,
               chunks=len(chunk_events))
    ok = (len(chunk_events) == want_chunks
          and res["launches"] == cfg.num_layers * want_chunks)
    print(f"admission chunks {len(chunk_events)} (prompts "
          f"{[len(r.prompt) for r in reqs]} in chunks of "
          f"{FLASH_CHUNK['s']}: {want_chunks}; starts {starts}); "
          f"flash_attention launches {res['launches']} = {cfg.num_layers} "
          f"layers x {want_chunks} chunks -> {ok}", flush=True)
    if not ok:
        _fail("the flash kernel's launches do not match 48 x the chunks")
    _check_launches("paged_attention", res["paged_launches"],
                    cfg.num_layers, b, False)
    _compare_streams(mdl, cfg, params, reqs, same["streams"], want,
                     "pipelined chunked", ref="phase 15's")
    print(f"pipelined chunked streams == phase 15's graph-route streams: "
          f"requests "
          f"{sorted(r for r in want if same['streams'][r] == want[r])} of "
          f"{sorted(want)}", flush=True)
    st = _pipeline_stats(rec)
    _check_pipeline("pipelined chunked", b, st)
    if "admit" not in st["stage_p50_ms"]:
        _fail("no overlap window ran an admission chunk")
    stall = [e["stall_ms"] for e in rec.events("serve.admit")]
    # a chunk's host dispatch: ~2000 launches queued behind the macro in
    # flight (nothing reads back: tests/test_torch_gpu.py); the allocator's
    # retries (cudaFree of cached blocks, a device sync) counted beside it
    chunk_ms = [e["wall_ms"] for e in chunk_events]
    retries = torch.cuda.memory_stats()["num_alloc_retries"] - retries
    print(f"chunk dispatch host wall p50 {float(np.median(chunk_ms)):.1f} ms "
          f"(min {min(chunk_ms):.1f}, max {max(chunk_ms):.1f}) over "
          f"{len(chunk_ms)} chunks; allocator retries in the run "
          f"{retries}", flush=True)
    res.update(st, stall_ms=stall, chunk_dispatch_p50_ms=float(
                   np.median(chunk_ms)), alloc_retries=retries,
               migrations=same["migrations"],
               hits=same["hits"], misses=same["misses"],
               tuner_history=same["tuner_history"])
    print(f"gemma3-12b pipelined chunked: {res['tokens_per_s']:.2f} tokens/s "
          f"(phase 15's graph route: {sync['tokens_per_s']:.2f}); admission "
          f"stall (reservation to activation) p50 "
          f"{float(np.median(stall)):.1f} ms, max {max(stall):.1f} ms over "
          f"{len(stall)} activations, beside phase 15's synchronous "
          f"admission wall p50 {float(np.median(sync['admit_wall_ms'])):.1f}"
          f" ms, max {max(sync['admit_wall_ms']):.1f} ms over "
          f"{len(sync['admit_wall_ms'])} admissions; macro wall p50 "
          f"{res['macro_p50_ms']:.1f} ms (phase 15: "
          f"{sync['macro_p50_ms']:.1f}); tiering {same['migrations']} "
          f"migrations, {same['hits']} hits, {same['misses']} misses; tuner "
          f"history {same['tuner_history']}", flush=True)
    b.close()
    del b
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    before = fa.flash_attention.launches
    res["chunk_timing"] = {
        f"start {start}": _flash_chunk_timing(fa, start, 1024, flush)
        for start in (0, 1536)}
    fa.flash_attention.launches = before    # timing launches not counted
    return res


# ---------------------------------------------------------------------------
# training: paligemma-3b, olmoe-1b-7b, reduced parity, the restart drill
# ---------------------------------------------------------------------------

# phases 37-38's batches: 4 rows of 256 tokens (paligemma-3b's rows carry
# its 256-position image prefix too, whose targets are IGNORE)
TRAIN_BATCH, TRAIN_SEQ = 4, 256
# a step small enough that the second step on the first batch must lower
# its loss at full width (the reference's test takes 1e-3 on its reduced
# configs)
FULL_OPT = dict(lr=1e-4, warmup_steps=1, decay_steps=8)
OLMOE_TRAIN_LAYERS = 4
# phase 39: the reference test's optimizer, one step on 4 x 16 tokens; the
# card against the CPU: float32 sums in other orders (TF32 off), the token
# table's gradient summed in bfloat16 in another order; AdamW's first step
# ~ sign(g), so an element whose gradient is float32 noise can move its
# step by a large part of it: every parameter within 0.1 of a step, at most
# 0.1% of them beyond 1e-3 of a step
PARITY_OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
PARITY_LOSS_RTOL, PARITY_GNORM_RTOL = 1e-5, 1e-4
PARITY_STEP_TOL, PARITY_STEP_FINE, PARITY_FINE_SHARE = 0.1, 1e-3, 1e-3
# phase 40: the resumed steps against the uninterrupted run's on one card
# (the expert loop's index_add_ sums with atomics, in any order)
DRILL_RTOL = 1e-5


def _leaf_sums(params) -> dict:
    """{leaf: (float64 sum, int64 sum of the float32 bit patterns)} of
    every parameter, gathered whole (a DTensor's ``full_tensor``) and
    kept on the host: equal bit sums on every leaf are near-proof of
    bit-equal parameters."""
    out = {}
    for n, p in params.named_parameters():
        t = p.detach()
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        out[n] = (float(t.double().sum()),
                  int(t.contiguous().view(torch.int32).long().sum()))
    return out


def _train_cell(TS, TO, data, name, cfg, ocfg, *, accum, batches,
                moe_active=1.0, mesh=None, mesh_fwd=None, prepare=None,
                after=None):
    """Train ``cfg`` from a seeded init through ``make_train_step`` on
    ``batches`` (indices of ``batch_at``): every loss and gradient norm
    finite, the second step's loss (the first batch again) below the
    first's, the parameters' per-leaf sums (``_leaf_sums``) after those
    steps, then one more step split into ``_grads`` and ``optim.update``
    timed on CUDA events.  With a ``mesh`` the state and the step are the
    mesh step's (DTensors; ``mesh_fwd`` maps the parameters to
    ``forward``'s mesh arguments for the split step; ``prepare``
    changes the initialised parameters in place; ``after(state, cfg,
    batch)`` runs on the split step's batch before the state is freed and
    returns numbers to add).  Returns the cell's numbers."""
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_state(cfg, ocfg, seed=SEED, device=DEV, mesh=mesh)
    params = state["params"]
    if prepare is not None:
        prepare(params)
    n = sum(p.numel() for p in params.parameters())
    n_expert = sum(p.numel() for nm, p in params.named_parameters()
                   if nm.split(".")[-1] in ("wi_gate", "wi_up", "wo")
                   and ".moe." in nm and ".shared." not in nm)
    n_active = n - n_expert * (1 - moe_active)
    fwd = mesh_fwd(params) if mesh is not None else None
    step = TS.make_train_step(
        cfg, ocfg, mesh, fwd and fwd["shard"], accum_steps=accum,
        param_specs=fwd and fwd["param_specs"])
    dcfg = data.DataConfig(seed=SEED, global_batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ)
    positions = TRAIN_BATCH * ((cfg.prefix_len or 0) + TRAIN_SEQ)
    losses, gnorms, walls = [], [], []
    for index in batches:
        batch = data.batch_at(dcfg, cfg, index)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        print(f"{name} step {len(losses)} (batch {index}): loss {loss:.5f} "
              f"grad norm {gnorm:.4f} lr {float(m['lr']):.2e} wall "
              f"{walls[-1]:.3f} s", flush=True)
    if not all(math.isfinite(v) for v in losses + gnorms):
        _fail(f"{name}: a loss or gradient norm is not finite")
    if not losses[1] < losses[0]:
        _fail(f"{name}: the second step on batch {batches[0]} did not "
              f"lower its loss ({losses[0]} -> {losses[1]})")
    sums = _leaf_sums(params)
    batch = TS.to_device(data.batch_at(dcfg, cfg, max(batches) + 1), DEV)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    if mesh is None:
        ev[0].record()
        grads, _ = TS._grads(params, cfg, batch, accum, False)
        ev[1].record()
        TO.update(grads, state["opt"], params, ocfg)
        ev[2].record()
    else:
        # the mesh step's two halves, as ``train.step._mesh_step`` runs them
        from repro_torch.distributed.compat import implicit_replication
        named = dict(params.named_parameters())
        with implicit_replication():
            micro = [TS.shard_batch(mb, mesh) for mb in
                     TS._micro(batch, accum)]
            ev[0].record()
            grads, _ = TS._grads(params, cfg, micro, accum, False, fwd=fwd)
            grads = {k: g.redistribute(mesh, named[k].placements)
                     for k, g in grads.items()}
            ev[1].record()
            TO.update(grads, state["opt"], params, ocfg)
            ev[2].record()
        del named, micro
    torch.cuda.synchronize()
    del grads
    p50 = float(np.median(walls[1:]))
    flops = (8 if cfg.remat else 6) * n_active * positions
    out = dict(params=n, active_params=int(n_active), remat=cfg.remat,
               accum_steps=accum, state_dtype=ocfg.state_dtype,
               positions_per_step=positions, losses=losses,
               grad_norms=gnorms, step_walls_s=walls, step_wall_p50_s=p50,
               positions_per_s=positions / p50,
               fwd_bwd_ms=ev[0].elapsed_time(ev[1]),
               optimizer_ms=ev[1].elapsed_time(ev[2]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_bytes=torch.cuda.max_memory_allocated(),
               f32_share=flops / p50 / F32_FLOPS_PER_S)
    print(f"{name}: {out}", flush=True)
    if after is not None:
        out.update(after(state, cfg, batch))
    out["leaf_sums"] = sums
    held = torch.cuda.memory_allocated()
    del state, params, step
    _check_freed(held)
    return out


def phase_train_paligemma(C, TS, TO, data):
    print("== phase 37: full-width, full-depth paligemma-3b training "
          "(remat, float32 AdamW state)", flush=True)
    cfg = C.get("paligemma-3b")
    return _train_cell(TS, TO, data, "paligemma-3b", cfg,
                       TO.OptConfig(**FULL_OPT), accum=1,
                       batches=[0, 0, 1, 2, 3, 4])


def phase_train_olmoe(C, TS, TO, data):
    print(f"== phase 38: olmoe-1b-7b training at full width, "
          f"{OLMOE_TRAIN_LAYERS} of 16 layers (int8 AdamW state, "
          f"accum_steps=2)", flush=True)
    full = C.get("olmoe-1b-7b")
    (pattern, _), = full.segments
    cfg = dataclasses.replace(full, segments=((pattern,
                                               OLMOE_TRAIN_LAYERS),))
    return _train_cell(TS, TO, data, "olmoe-1b-7b", cfg,
                       TO.OptConfig(**FULL_OPT, state_dtype="int8"),
                       accum=2, batches=[0, 0, 1, 2],
                       moe_active=cfg.moe.top_k / cfg.moe.num_experts)


# phase 48's AdamW state: float32 (weights, gradients, m and v: 4 x 13.88
# GB = 55.5 GB of 80), reckoned to leave room for one repeat's mLSTM saves
# (7 layers x 1.07 GB at B = 4, S = 256) and the step's activations
XLSTM_TRAIN_STATE = "float32"


def _slstm_fan_in_hd(params) -> None:
    """Redraw every sLSTM cell's r_gates from N(0, 1 / hd), seeded (the
    reference's fan-in nh makes the backward leave float32's range:
    ``SLSTM_FAN_IN_REF``)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 48)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith("r_gates"):
                p.normal_(0.0, p.shape[-2] ** -0.5, generator=g)


def phase_train_xlstm(C, TS, TO, data, ms_, ss_):
    print("== phase 48: full-width, full-depth xlstm-1.3b training (remat, "
          f"{XLSTM_TRAIN_STATE} AdamW state; the mLSTM and sLSTM through "
          "their backward kernels)", flush=True)
    counters = _counters(ms_, ss_)
    for c in counters.values():
        c.launches = 0
    out = _train_cell(TS, TO, data, "xlstm-1.3b", C.get("xlstm-1.3b"),
                      TO.OptConfig(**FULL_OPT, state_dtype=XLSTM_TRAIN_STATE),
                      accum=1, batches=[0, 0, 1, 2, 3, 4],
                      prepare=_slstm_fan_in_hd)
    out.pop("leaf_sums")
    out["launches"] = {k: c.launches for k, c in counters.items()}
    print(f"xlstm-1.3b: kernel launches over its 7 steps (6 and the timed "
          f"one): {out['launches']}", flush=True)
    if not all(out["launches"].values()):
        _fail(f"xlstm-1.3b training did not run every recurrence kernel: "
              f"{out['launches']}")
    return out


# phase 50's AdamW state: float32 (weights, gradients, m and v: 4 x 10.87
# GB = 43.5 GB of 80); the step's largest activations are the tied
# 256000-entry vocabulary's logits, their log-sum-exp and their gradient
# (4 x 256 x 256000 float32: 1.05 GB each)
RGEMMA_TRAIN_STATE = "float32"


def _rglru_route_ab(TS, TO, R, rg_, ocfg):
    """``_train_cell``'s ``after`` for phase 50: the split step's forward +
    backward timed on CUDA events with the RG-LRU through its kernels and
    on the route before the backward kernel (``R.rglru_scan_grad``
    swapped for ``rglru_scan_plain``, which autograd differentiates), in
    turns (kernels, plain, plain, kernels); then what sets the peak: the
    peak of a forward+backward, the memory its gradients hold, and the
    peak of an optimizer update on them.  The launch counts are left as
    they were before it."""
    def run(state, cfg, batch):
        params = state["params"]
        counters = _rglru_counters(rg_)
        counted = {k: c.launches for k, c in counters.items()}
        times = {"kernels": [], "plain": []}
        for route in ("kernels", "plain", "plain", "kernels"):
            if route == "plain":
                R.rglru_scan_grad = rg_.rglru_scan_plain
            try:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                ev[0].record()
                grads, _ = TS._grads(params, cfg, batch, 1, False)
                ev[1].record()
                torch.cuda.synchronize()
                del grads
            finally:
                R.rglru_scan_grad = rg_.rglru_scan_grad
            times[route].append(ev[0].elapsed_time(ev[1]))
        print(f"recurrentgemma-2b forward+backward in turns (kernels, "
              f"plain, plain, kernels): RG-LRU kernels {times['kernels']} "
              f"ms, autograd of the plain scan {times['plain']} ms",
              flush=True)
        gb = lambda fn: fn() / 1e9
        torch.cuda.reset_peak_memory_stats()
        mem = dict(state=gb(torch.cuda.memory_allocated))
        grads, _ = TS._grads(params, cfg, batch, 1, False)
        torch.cuda.synchronize()
        mem.update(fwd_bwd_peak=gb(torch.cuda.max_memory_allocated),
                   with_grads=gb(torch.cuda.memory_allocated))
        torch.cuda.reset_peak_memory_stats()
        TO.update(grads, state["opt"], params, ocfg)
        torch.cuda.synchronize()
        mem["optimizer_peak"] = gb(torch.cuda.max_memory_allocated)
        del grads
        for key, c in counters.items():
            c.launches = counted[key]
        print(f"recurrentgemma-2b memory, GB: {mem}", flush=True)
        return dict(route_ab_fwd_bwd_ms=times, memory_gb=mem)
    return run


def phase_train_rgemma(C, TS, TO, data, rg_, R, rglru_bwd):
    print("== phase 50: full-width, full-depth recurrentgemma-2b training "
          f"(remat, {RGEMMA_TRAIN_STATE} AdamW state; the RG-LRU through its "
          "forward and backward kernels)", flush=True)
    counters = _rglru_counters(rg_)
    for c in counters.values():
        c.launches = 0
    cfg = C.get("recurrentgemma-2b")
    ocfg = TO.OptConfig(**FULL_OPT, state_dtype=RGEMMA_TRAIN_STATE)
    out = _train_cell(TS, TO, data, "recurrentgemma-2b", cfg, ocfg, accum=1,
                      batches=[0, 0, 1, 2, 3, 4],
                      after=_rglru_route_ab(TS, TO, R, rg_, ocfg))
    out.pop("leaf_sums")
    out["launches"] = {k: c.launches for k, c in counters.items()}
    print(f"recurrentgemma-2b: kernel launches over its 7 steps (6 and the "
          f"timed one): {out['launches']}", flush=True)
    if not all(out["launches"].values()):
        _fail(f"recurrentgemma-2b training did not run both RG-LRU kernels: "
              f"{out['launches']}")
    # the RG-LRU's share of a step: its kernels' device time reckoned from
    # phase 49's times and this run's launches a step (two forwards a
    # layer under remat); the plain route's, that time plus what the
    # forward+backward took longer on it (measured in turns)
    layers = sum(rep * sum(k == "rglru" for k in pat)
                 for pat, rep in cfg.segments)
    steps = len(out["step_walls_s"]) + 1
    fwd, bwd = (out["launches"][k] / steps for k in
                ("rglru_scan", "rglru_scan_backward"))
    rglru_ms = fwd * rglru_bwd["forward_device_ms"] + \
        bwd * rglru_bwd["device_ms"]
    step_ms = out["step_wall_p50_s"] * 1e3
    ab = out["route_ab_fwd_bwd_ms"]
    extra = float(np.mean(ab["plain"])) - float(np.mean(ab["kernels"]))
    out.update(rglru_layers=layers, rglru_launches_per_step=[fwd, bwd],
               rglru_ms_per_step=rglru_ms, rglru_share=rglru_ms / step_ms,
               plain_route_extra_ms=extra,
               plain_route_share=(rglru_ms + extra) / (step_ms + extra))
    print(f"recurrentgemma-2b: {layers} RG-LRU layers, {fwd:g} forward and "
          f"{bwd:g} backward launches a step: {rglru_ms:.3f} ms of a "
          f"{step_ms:.1f} ms step ({out['rglru_share'] * 100:.2f}%, "
          f"reckoned from phase 49's device times); the plain route's "
          f"forward+backward {extra:.1f} ms longer (in turns), its RG-LRU "
          f"share {out['plain_route_share'] * 100:.2f}%", flush=True)
    return out


def _params_on_card(mdl, params, cfg):
    """A copy of the CPU parameters ``params`` on the card."""
    card = mdl.Transformer(cfg, DEV)
    with torch.no_grad():
        for n, p in card.named_parameters():
            p.copy_(params.get_parameter(n))
    return card


def phase_train_parity(C, mdl, TS, TO, data, counters, expect):
    print("== phase 39: the train step on the card vs the CPU (every "
          "reduced architecture; int8 state on olmoe-1b-7b)", flush=True)
    out = {}
    cases = [(name, "float32") for name in C.ARCHS] + \
        [("olmoe-1b-7b", "int8")]
    for name, dtype in cases:
        cfg = C.reduced(name)
        ocfg = TO.OptConfig(**PARITY_OPT, state_dtype=dtype)
        cpu = TS.init_state(cfg, ocfg, seed=SEED, device="cpu")
        params = TS.trainable(_params_on_card(mdl, cpu["params"], cfg))
        card = {"params": params, "opt": TO.init(params, ocfg),
                "step": torch.zeros((), dtype=torch.int32, device=DEV)}
        batch = data.batch_at(data.DataConfig(seed=SEED, global_batch=4,
                                              seq_len=16), cfg, 0)
        step = TS.make_train_step(cfg, ocfg)
        cpu, mc = step(cpu, batch)
        before = {k: c.launches for k, c in counters.items()}
        card, mg = step(card, batch)
        ran = {k: c.launches - before[k] for k, c in counters.items()}
        # the recurrent configs' recurrences through their kernels, forward
        # and backward (``expect``: the counters each config must move);
        # no other counter moves
        want = expect.get(name, ())
        if any(bool(n) != (k in want) for k, n in ran.items()):
            _fail(f"{name}: recurrence kernel launches {ran}")
        lr = float(mc["lr"])
        loss_d = abs(float(mg["loss"]) - float(mc["loss"]))
        gn_d = abs(float(mg["grad_norm"]) - float(mc["grad_norm"]))
        if loss_d > PARITY_LOSS_RTOL * abs(float(mc["loss"])) or \
                gn_d > PARITY_GNORM_RTOL * float(mc["grad_norm"]):
            _fail(f"{name} ({dtype}): loss or gradient norm parted: "
                  f"{float(mg['loss'])} / {float(mc['loss'])}, "
                  f"{float(mg['grad_norm'])} / {float(mc['grad_norm'])}")
        worst, far, total = 0.0, 0, 0
        same = {"m": 0, "v": 0}
        for n, p in card["params"].named_parameters():
            d = (p.detach().cpu() -
                 cpu["params"].get_parameter(n).detach()).abs()
            worst = max(worst, float(d.max()) / lr)
            far += int((d > PARITY_STEP_FINE * lr).sum())
            total += d.numel()
            if dtype == "int8":
                for key in ("m", "v"):
                    a = card["opt"][key][n].q.cpu().int()
                    b = cpu["opt"][key][n].q.int()
                    same[key] += int((a == b).sum())
                    if key == "m" and int((a - b).abs().max()) > 1:
                        _fail(f"{name}: an int8 m code moved by more "
                              "than one")
        if worst > PARITY_STEP_TOL or far > PARITY_FINE_SHARE * total:
            _fail(f"{name} ({dtype}): parameters parted after the step "
                  f"(worst {worst} of a step, {far} of {total} beyond "
                  f"{PARITY_STEP_FINE})")
        n_codes = sum(q.q.numel() for q in card["opt"]["m"].values()) \
            if dtype == "int8" else 0
        if dtype == "int8" and (same["m"] < 0.999 * n_codes
                                or same["v"] < 0.995 * n_codes):
            _fail(f"{name}: int8 codes parted: {same} of {n_codes}")
        out[f"{name} {dtype}"] = dict(
            loss=float(mg["loss"]), loss_delta=loss_d, grad_norm_delta=gn_d,
            **({"launches": ran} if any(ran.values()) else {}),
            worst_param_delta_of_step=worst, beyond_fine=far,
            **({"codes_equal": {k: v / n_codes for k, v in same.items()}}
               if dtype == "int8" else {}))
        print(f"{name} ({dtype}): {out[f'{name} {dtype}']}", flush=True)
        del card, params, cpu
    _check_freed(torch.cuda.memory_allocated())
    return out


# phase 41: the mesh step's losses against phase 37's, relative; its
# parameters' per-leaf float64 sums against phase 37's, relative to the
# leaf's float64 sum of magnitudes
MESH_LOSS_RTOL, MESH_SUM_RTOL = 1e-6, 1e-6


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def phase_train_mesh(C, mdl, TS, TO, SH, LM, data, card, want):
    """Phase 37's cell through the mesh step on a one-rank NCCL
    ``DeviceMesh`` (1, 1) ("data", "model"), the state as DTensors:
    losses within ``MESH_LOSS_RTOL`` of phase 37's, the parameters' leaf
    sums within ``MESH_SUM_RTOL`` (and whether every leaf's bit sum is
    phase 37's), the step wall p50, the split step's halves and the peak
    memory.  Phase 37 freed its state before (both do not fit)."""
    import torch.distributed as dist
    print("== phase 41: the mesh step at full width (paligemma-3b, full "
          "depth, phase 37's cell on a one-rank NCCL (1, 1) DeviceMesh)",
          flush=True)
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = LM.make_host_mesh(1, 1)
        fwd = lambda params: dict(
            mesh=mesh, shard=SH.make_shard_fn(mesh),
            param_specs=mdl.param_specs(params),
            pshard=SH.make_param_shard_fn(mesh, gather=("data",)))
        out = _train_cell(TS, TO, data, "paligemma-3b mesh (1, 1)",
                          C.get("paligemma-3b"), TO.OptConfig(**FULL_OPT),
                          accum=1, batches=[0, 0, 1, 2, 3, 4], mesh=mesh,
                          mesh_fwd=fwd)
    finally:
        dist.destroy_process_group()
    loss_d = max(abs(a - b) / abs(b) for a, b in zip(out["losses"],
                                                      want["losses"]))
    got, ref = out.pop("leaf_sums"), want["leaf_sums"]
    if sorted(got) != sorted(ref):
        _fail("the mesh step's parameters are not phase 37's leaves")
    sum_d = max(abs(got[n][0] - ref[n][0]) / max(abs(ref[n][0]), 1e-30)
                for n in ref)
    bit_equal = all(got[n][1] == ref[n][1] for n in ref)
    out.update(loss_max_rel_delta=loss_d, leaf_sum_max_rel_delta=sum_d,
               leaf_bit_sums_equal=bit_equal,
               phase37=dict(step_wall_p50_s=want["step_wall_p50_s"],
                            fwd_bwd_ms=want["fwd_bwd_ms"],
                            optimizer_ms=want["optimizer_ms"],
                            peak_gb=want["peak_gb"]))
    print(f"mesh step vs phase 37 ({card}): losses {out['losses']} (max "
          f"relative delta {loss_d:.3g}, bar {MESH_LOSS_RTOL}); leaf sums "
          f"max relative delta {sum_d:.3g} (bar {MESH_SUM_RTOL}); every "
          f"leaf's bit sum equal: {bit_equal}; step wall p50 "
          f"{out['step_wall_p50_s']:.3f} s (phase 37 "
          f"{want['step_wall_p50_s']:.3f}), forward+backward "
          f"{out['fwd_bwd_ms']:.1f} ms (phase 37 {want['fwd_bwd_ms']:.1f}), "
          f"optimizer {out['optimizer_ms']:.1f} ms (phase 37 "
          f"{want['optimizer_ms']:.1f}), max_memory_allocated "
          f"{out['peak_gb']:.2f} GB (phase 37 {want['peak_gb']:.2f})",
          flush=True)
    if loss_d > MESH_LOSS_RTOL:
        _fail(f"the mesh step's losses part from phase 37's by {loss_d}")
    if sum_d > MESH_SUM_RTOL:
        _fail(f"the mesh step's parameters part from phase 37's: leaf sums "
              f"by {sum_d}")
    return out


# phase 42: the dry-run's traces, one process on the CPU (meta tensors
# over a fake process group) started before the training phases; the
# (1, 1) cell is phase 37's (accum 1, no cast, float32 state), the
# (16, 16) cells are registered ones.  Its peak is held to phase 41's
# measured max_memory_allocated within DRYRUN_PEAK_BAR (relative).
DRYRUN_PEAK_BAR = 0.25
DRYRUN_CELLS = (("qwen3-14b", "train_4k"), ("olmoe-1b-7b", "train_4k"))
DRYRUN_TIMEOUT_S = 420
_DRYRUN = """
import json, sys
sys.path.insert(0, {src!r})
import repro_torch.configs as C
from repro_torch.launch import dryrun as D, specs as SP
cfg = C.get("paligemma-3b")
c = SP.Cell("paligemma-3b", "phase 37", cfg, "train",
            cfg.prefix_len + {seq}, {batch})
print("RECORD " + json.dumps(D.lower_cell(
    "paligemma-3b", "phase 37", cell=c, verbose=False,
    mesh_shape=((1, 1), ("data", "model")),
    overrides=dict(accum=1, cast_params=False))), flush=True)
for arch, shape in {cells!r}:
    print("RECORD " + json.dumps(D.lower_cell(arch, shape, verbose=False)),
          flush=True)
"""


def start_dryrun(src) -> subprocess.Popen:
    """Start the dry-run traces (``_DRYRUN``) in a process of their own,
    with no card visible (meta tensors need none)."""
    code = _DRYRUN.format(src=str(src), seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                          cells=DRYRUN_CELLS)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def phase_dryrun(proc, D, card, mesh41):
    """The dry-run against the card: the (1, 1) trace's predicted peak
    beside phase 41's measured ``max_memory_allocated`` (within
    ``DRYRUN_PEAK_BAR``), each (16, 16) cell's per-device bytes against
    the 80 GB the records name, FLOPs, collective bytes by kind and trace
    seconds; the card's memory must be the records' 80 GB card."""
    print("== phase 42: the dry-run against the card (meta tensors over a "
          "fake process group, one CPU process)", flush=True)
    props = torch.cuda.get_device_properties(0)
    name = torch.cuda.get_device_name(0)
    print(f"card memory {props.total_memory} bytes "
          f"({props.total_memory / 1e9:.2f} GB); the records name "
          f"{D.TARGET_DEVICE} with {D.TARGET_HBM_BYTES / 1e9:.0f} GB",
          flush=True)
    if name != D.TARGET_DEVICE or not (
            D.TARGET_HBM_BYTES <= props.total_memory
            < 1.1 * D.TARGET_HBM_BYTES):
        _fail(f"the card ({name}, {props.total_memory} bytes) is not the "
              f"records' {D.TARGET_DEVICE} of {D.TARGET_HBM_BYTES} bytes")
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        _fail(f"the dry-run traces outlasted {DRYRUN_TIMEOUT_S} s")
    if proc.returncode != 0:
        _fail(f"the dry-run failed:\n{err[-4000:]}")
    recs = [json.loads(line[7:]) for line in out.splitlines()
            if line.startswith("RECORD ")]
    if len(recs) != 1 + len(DRYRUN_CELLS):
        _fail(f"the dry-run printed {len(recs)} records:\n{err[-4000:]}")
    one, cells = recs[0], recs[1:]
    measured = mesh41["peak_bytes"]
    ratio = one["peak_bytes_per_device"] / measured
    print(f"paligemma-3b phase 37 cell on (1, 1) ({card}): predicted peak "
          f"{one['peak_bytes_per_device'] / 1e9:.2f} GB (arguments "
          f"{one['argument_bytes'] / 1e9:.2f}, temporaries "
          f"{one['temp_bytes'] / 1e9:.2f}), phase 41 measured "
          f"max_memory_allocated {measured / 1e9:.2f} GB: ratio "
          f"{ratio:.4f} (bar +-{DRYRUN_PEAK_BAR}); predicted FLOPs "
          f"{one['flops']:.4g} a step; traced in {one['trace_s']} s",
          flush=True)
    if abs(ratio - 1) > DRYRUN_PEAK_BAR:
        _fail(f"the dry-run's peak is {ratio:.3f}x the measured one")
    for r in cells:
        print(f"{r['arch']} x {r['shape']} on {r['mesh']}: per device "
              f"{r['peak_bytes_per_device'] / 1e9:.2f} GB of "
              f"{r['target_hbm_bytes'] / 1e9:.0f} GB (fits: {r['fits']}; "
              f"arguments {r['argument_bytes'] / 1e9:.2f} GB), FLOPs "
              f"{r['flops']:.4g} a device, collectives "
              f"{ {k: round(v / 1e9, 3) for k, v in r['collective_bytes'].items()} } "
              f"GB (total {r['collective_bytes_total'] / 1e9:.2f}), traced "
              f"in {r['trace_s']} s; torch {r['torch']}", flush=True)
    return dict(one=one, ratio=ratio, cells=cells)


def phase_batcher_options(mdl, pa, S, memtier, cori, telemetry, kernels,
                          cfg, params, want, serve, card):
    """Phase 4's mix on phase 4's parameters with the batcher's
    ``macro_steps=4``: greedy streams equal phase 4's, every macro (the
    flight recorder's ``serve.macro`` events) 4 steps but where the
    remaining work caps it, kernel 1 a layer a device step."""
    print("== phase 43: the batcher's macro_steps option (qwen3-14b, phase "
          "4's mix)", flush=True)
    tag, keep = "macro_steps=4", {}
    b, res, same, _, reqs = _serve_mix(params, cfg, S, memtier, cori,
                                       telemetry, kernels, keep=keep,
                                       macro_steps=4)
    res["launches"] = pa.paged_attention.launches
    _compare_streams(mdl, cfg, params, reqs, same["streams"], want, tag)
    lens = [e["n_steps"] for e in keep["recorder"].events("serve.macro")]
    if any(n > 4 for n in lens) or lens.count(4) < len(lens) // 2:
        _fail(f"{tag}: macro lengths {lens}")
    _check_launches("paged_attention", res["launches"], cfg.num_layers, b,
                    False)
    res.update(macro_lens=lens, migrations=same["migrations"],
               hits=same["hits"], misses=same["misses"])
    print(f"{tag} ({card}): {res['tokens_per_s']:.2f} tokens/s (phase 4's "
          f"graph route {serve['graph']['tokens_per_s']:.2f}), macro wall "
          f"p50 {res['macro_p50_ms']:.1f} ms (phase 4 "
          f"{serve['graph']['macro_p50_ms']:.1f}), paged_attention launches "
          f"{res['launches']} (phase 4's default: "
          f"{serve['graph']['launches']}), streams equal phase 4's: "
          f"{sorted(r for r in want if same['streams'][r] == want[r])} of "
          f"{sorted(want)}", flush=True)
    del b
    gc.collect()
    torch.cuda.empty_cache()
    return {tag: res}


def phase_restart_drill(src, launch_train, supervisor):
    print("== phase 40: the supervised restart drill on the card "
          "(olmoe-1b-7b reduced, a crash injected at step 8)", flush=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="repro_drill_"))
    try:
        args = ["--arch", "olmoe-1b-7b", "--reduced", "--steps", "12",
                "--batch", "2", "--seq", "16", "--ckpt-every", "4"]
        env = dict(os.environ, PYTHONPATH=str(src),
                   REPRO_FAIL_AT_STEP="8")
        t0 = time.monotonic()
        rep = supervisor.supervise(
            [sys.executable, "-m", "repro_torch.launch.train", *args,
             "--ckpt-dir", str(tmp / "run"), "--metrics-out",
             str(tmp / "m.json")], workdir=tmp / "run",
            cfg=supervisor.SupervisorConfig(max_restarts=2), env=env)
        drill_s = time.monotonic() - t0
        if rep.exit_code != 0 or rep.restarts != 1:
            _fail(f"the drill: exit {rep.exit_code}, {rep.restarts} "
                  f"restarts (history {rep.history})")
        rpt = json.loads((tmp / "m.json").read_text())
        if rpt["start"] != 8 or rpt["steps_run"] != 4 or \
                not rpt["device"].startswith("cuda"):
            _fail(f"the drill resumed wrongly: {rpt}")
        whole = launch_train.main(args + ["--ckpt-dir", str(tmp / "whole"),
                                          "--metrics-out",
                                          str(tmp / "w.json")])
        want = json.loads((tmp / "w.json").read_text())["losses"][8:]
        got = rpt["losses"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if worst > DRILL_RTOL:
            _fail(f"resumed losses {got} part from the uninterrupted "
                  f"run's {want}")
        out = dict(exit_code=rep.exit_code, restarts=rep.restarts,
                   history=rep.history, start=rpt["start"],
                   steps_run=rpt["steps_run"], resumed_losses=got,
                   uninterrupted_losses=want, worst_rel_delta=worst,
                   bit_equal=got == want, drill_s=drill_s,
                   uninterrupted_device=whole["device"])
        print(f"drill: {out}", flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is visible", flush=True)
        return 1
    root = pathlib.Path(__file__).resolve().parent
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        print(f"FAIL: the port's sources are not beside this script "
              f"({src / 'repro_torch'})", flush=True)
        return 1
    sys.path.insert(0, str(src))
    import repro_torch.configs as C
    from repro_torch import resolve_device
    from repro_torch.core import cori, pipeline, sim, traces
    from repro_torch.ft import inject
    from repro_torch import memtier
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ms_
    from repro_torch.kernels import page_hist as ph
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_mla as pam
    from repro_torch.kernels import rglru_scan as rg_
    from repro_torch.kernels import routed_experts as re_
    from repro_torch.kernels import sim_step as ss
    from repro_torch.kernels import slstm_scan as ss_
    from repro_torch.models import model as mdl
    from repro_torch.models import moe
    from repro_torch.models import recurrent as R
    from repro_torch.obs import telemetry
    from repro_torch.serve import engine
    from repro_torch.serve import sched as S
    from repro_torch.serve import traffic_replay as TR
    from repro_torch.data import pipeline as data
    from repro_torch.ft import supervisor
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optim as TO
    from repro_torch.train import step as TS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as LM

    kernels = (pa, ph, ss, pam, fa, re_, ms_, ss_, rg_)
    secs = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        secs[name] = round(time.monotonic() - t0, 1)
        print(f"-- {name}: {secs[name]} s", flush=True)
        return out

    resolve_device()                       # pins float32 matmuls (no TF32)
    card = timed("device", phase_device)
    timed("build", phase_build, _build, kernels)
    err = timed("paged_attention check", phase_kernel_check, pa)
    serve, qcfg, params, streams = timed(
        "serving", phase_serve, C, mdl, pa, S, memtier, cori, telemetry,
        kernels)
    dense = timed("dense batcher", phase_dense, mdl, pa, S, memtier, cori,
                  engine, telemetry, kernels, qcfg, params, streams)
    piped = timed("pipelined loop", phase_pipelined, mdl, pa, S, memtier,
                  cori, telemetry, kernels, qcfg, params, streams, serve)
    chaos = timed("chaos", phase_chaos, mdl, pa, S, memtier, cori,
                  telemetry, kernels, inject, qcfg, params, streams, piped)
    squeeze = timed("squeeze", phase_squeeze, mdl, pa, S, memtier, cori,
                    telemetry, kernels, inject, qcfg, params, streams)
    options = timed("batcher options", phase_batcher_options, mdl, pa, S,
                    memtier, cori, telemetry, kernels, qcfg, params, streams,
                    serve, card)
    held = torch.cuda.memory_allocated()
    del params       # the deepseek phase needs the card
    _check_freed(held)
    timed("parity", phase_parity, C, mdl, S, memtier, cori, engine)
    timing = timed("paged_attention timing", phase_timing, pa)
    errs = timed("offline kernels check", phase_offline_kernels, ph, ss,
                 sim, traces)
    offline = timed("offline pipeline", phase_offline_pipeline, sim,
                    pipeline, traces, kernels, ph, ss)
    off_timing = timed("offline timing", phase_offline_timing, ph, ss, sim,
                       traces, kernels)
    mla_err = timed("paged_attention_mla check", phase_mla_check, pam)
    deepseek = timed("deepseek serving", phase_deepseek, C, mdl, pa, pam,
                     re_, S, memtier, cori, telemetry, kernels)
    timed("deepseek parity", phase_deepseek_parity, C, mdl, S, memtier, cori,
          engine)
    mla_timing = timed("paged_attention_mla timing", phase_mla_timing, pam)
    flash_err = timed("flash_attention check", phase_flash_check, fa)
    gemma, params, first, gstreams = timed(
        "gemma3 serving", phase_gemma, C, mdl, pa, fa, S, memtier, cori,
        telemetry, kernels)
    gemma["graph"]["full_width_logit_delta"] = timed(
        "gemma3 parity", phase_gemma_parity, C, mdl, S, memtier, cori,
        engine, params, first)
    gpiped = timed("gemma3 pipelined chunked", phase_gemma_pipelined, C,
                   mdl, pa, fa, S, memtier, cori, telemetry, kernels,
                   params, gstreams, gemma["graph"])
    held = torch.cuda.memory_allocated()
    del params
    _check_freed(held)
    flash_timing = timed("flash_attention timing", phase_flash_timing, fa)
    rglru = timed("rglru_scan check and timing", phase_rglru, rg_)
    rgemma = timed("recurrentgemma serving", phase_rgemma, C, mdl, pa, rg_,
                   S, memtier, cori, telemetry, kernels)
    mlstm = timed("mlstm_scan check and timing", phase_mlstm, ms_)
    slstm = timed("slstm_scan check and timing", phase_slstm, ss_)
    bwd = timed("backward kernels check and timing", phase_backward, ms_,
                ss_)
    xlstm = timed("xlstm serving", phase_xlstm, C, mdl, pa, ms_, ss_, S,
                  memtier, cori, telemetry, kernels)
    timed("recurrent parity", phase_recurrent_parity, C, mdl, S, memtier,
          cori, engine)
    weights = {model: _routed_weights(shape, SEED + i)
               for i, (model, shape) in enumerate(ROUTED_SHAPES.items())}
    routed_err = timed("routed_experts check", phase_routed_check, moe, re_,
                       weights)
    routed = timed("routed_experts timing", phase_routed_timing, moe, re_,
                   weights)
    del weights
    _check_freed(torch.cuda.memory_allocated())
    olmoe = timed("olmoe serving", phase_olmoe, C, mdl, pa, re_, S, memtier,
                  cori, telemetry, kernels)
    musicgen = timed("musicgen serving", phase_musicgen, C, mdl, pa, fa, S,
                     memtier, cori, telemetry, kernels)
    nemotron = timed("nemotron serving", phase_nemotron, C, mdl, pa, fa, S,
                     memtier, cori, telemetry, kernels)
    stablelm = timed("stablelm serving", phase_stablelm, C, mdl, pa, fa, S,
                     memtier, cori, telemetry, kernels)
    timed("conditioning parity", phase_cond_parity, C, mdl, S, memtier, cori,
          engine)
    timed("flash parity at head dims 160 and 192", phase_flash_parity, C,
          mdl, S, memtier, cori, engine, fa)
    pcfg, params, ex, paligemma = timed(
        "paligemma serving", phase_paligemma, C, mdl, pa, fa, S, memtier,
        cori, telemetry, kernels)
    paligemma["graph"]["single_stream"] = timed(
        "single-stream tiered path", phase_single_stream, mdl, pa, memtier,
        engine, pcfg, params, ex)
    held = torch.cuda.memory_allocated()
    del params, ex
    _check_freed(held)
    timed("prefix parity", phase_prefix_parity, C, mdl, S, memtier, cori,
          engine)
    traffic = timed("traffic replay", phase_traffic, TR)
    # the dry-run traces on the CPU beside the training phases (phase 42)
    dryrun_proc = start_dryrun(src)
    try:
        # training reaches no pallas_call in the reference: phases 37, 38,
        # 40 and 41 launch none of the hand-written kernels (the counts
        # stay 0); only the recurrences have backward kernels of the
        # port's own (phase 39 counts them, 48 the xLSTM's, 50 the
        # RG-LRU's)
        def none_launched(what):
            launched = {k: fn.launches for k, fn in
                        _wrappers(kernels).items()}
            if any(launched.values()):
                _fail(f"{what} launched a kernel: {launched}")

        _reset_counts(kernels)
        train = {
            "paligemma-3b": timed("paligemma training",
                                  phase_train_paligemma, C, TS, TO, data),
            "olmoe-1b-7b": timed("olmoe training", phase_train_olmoe, C, TS,
                                 TO, data)}
        none_launched("phases 37-38")
        train["parity"] = timed(
            "train parity", phase_train_parity, C, mdl, TS, TO, data,
            {**_counters(ms_, ss_), **_rglru_counters(rg_)},
            {"xlstm-1.3b": set(_counters(ms_, ss_)),
             "recurrentgemma-2b": set(_rglru_counters(rg_))})
        _reset_counts(kernels)
        train["drill"] = timed("restart drill", phase_restart_drill, src,
                               launch_train, supervisor)
        train["mesh"] = timed("mesh step", phase_train_mesh, C, mdl, TS, TO,
                              SH, LM, data, card, train["paligemma-3b"])
        train["paligemma-3b"].pop("leaf_sums")
        train["olmoe-1b-7b"].pop("leaf_sums")
        none_launched("phases 40-41")
        train["xlstm-1.3b"] = timed("xlstm training", phase_train_xlstm, C,
                                    TS, TO, data, ms_, ss_)
        rglru_bwd = timed("rglru_scan_backward check and timing",
                          phase_rglru_backward, rg_)
        train["recurrentgemma-2b"] = timed(
            "recurrentgemma training", phase_train_rgemma, C, TS, TO, data,
            rg_, R, rglru_bwd)
        dry = timed("dry-run", phase_dryrun, dryrun_proc, D, card,
                    train["mesh"])
    finally:
        if dryrun_proc.poll() is None:     # a phase failed: stop it
            dryrun_proc.kill()
            dryrun_proc.communicate()
    main_case = flash_timing.pop("float32 window 1024")
    musicgen_flash = flash_timing.pop("musicgen-large prefill float32 causal")
    # the new head dims' prefill shapes, each with the launches of the phase
    # that serves it (float32)
    served = {"stablelm-12b": (STABLELM_PREFILL, stablelm, 51),
              "nemotron-4-340b": (NEMOTRON_PREFILL, nemotron, 25)}
    wide_flash = {}
    for name, (c, res, ph) in served.items():
        for dt in ("float32", "bfloat16"):
            key = (f"{name} prefill B={c['b']} S=T={c['s']} {c['h']}/"
                   f"{c['kv']} heads D={c['d']} {dt} causal (phase 17"
                   + (f", {ph})" if dt == "float32" else ")"))
            wide_flash[key] = flash_timing.pop(f"{name} prefill {dt} causal")
            if dt == "float32":
                wide_flash[key]["launches"] = res["graph"]["flash_launches"]
    main_routed = routed.pop("deepseek-v3-671b")
    chunk_timing = gpiped.pop("chunk_timing")
    print(f"card: {card}; serving {serve}; dense {dense}; pipelined "
          f"{piped}; chaos {chaos}; squeeze {squeeze}; gemma3 pipelined "
          f"chunked {gpiped}; traffic "
          f"{traffic}; offline {offline}; deepseek "
          f"{deepseek}; gemma3 {gemma}; recurrentgemma {rgemma}; xlstm "
          f"{xlstm}; mlstm_scan {mlstm}; slstm_scan {slstm}; backward "
          f"kernels {bwd}; rglru_scan "
          f"{rglru}; rglru_scan_backward {rglru_bwd}; olmoe {olmoe}; "
          f"musicgen "
          f"{musicgen}; nemotron "
          f"{nemotron}; stablelm {stablelm}; paligemma {paligemma}; "
          f"training {train}; batcher "
          f"options {options}; dry-run {dry}; flash "
          f"timing beside float32 "
          f"window "
          f"1024: {flash_timing}; phase seconds {secs}", flush=True)
    print(json.dumps({"kernels": [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:121",
             launches=serve["graph"]["launches"],
             max_abs_err=max(err, timing["qwen3-14b"]["max_abs_err"]),
             **{k: v for k, v in timing["qwen3-14b"].items()
                if k != "max_abs_err"},
             shape="qwen3-14b decode (phase 4)",
             also={"gemma3-12b decode (phase 15)": dict(
                 timing["gemma3-12b"],
                 launches=gemma["graph"]["paged_launches"]),
                 "recurrentgemma-2b decode (phase 18)": dict(
                 timing["recurrentgemma-2b"],
                 launches=rgemma["graph"]["launches"]),
                 "olmoe-1b-7b decode (phase 23)": dict(
                 timing["olmoe-1b-7b"],
                 launches=olmoe["graph"]["launches"]),
                 "musicgen-large decode (phase 24)": dict(
                 timing["musicgen-large"],
                 launches=musicgen["graph"]["launches"]),
                 "nemotron-4-340b decode (phase 25)": dict(
                 timing["nemotron-4-340b"],
                 launches=nemotron["graph"]["launches"]),
                 "stablelm-12b decode (phase 51)": dict(
                 timing["stablelm-12b"],
                 launches=stablelm["graph"]["launches"]),
                 "paligemma-3b decode (phase 27)": dict(
                 timing["paligemma-3b"],
                 launches=paligemma["graph"]["launches"]),
                 "qwen3-14b paged_context over the mirrored single-layer "
                 "pool, B=1 (phase 30)": dense["probe"],
                 "qwen3-14b decode, pipelined under the chaos plan "
                 "(phase 34)": dict(launches=chaos["launches"]),
                 "qwen3-14b decode under a capacity squeeze (phase 35)":
                 dict(launches=squeeze["launches"]),
                 "olmoe-1b-7b decode, pipelined, packed and chunked "
                 "admission (phase 36)": dict(launches=[
                     olmoe["pipelined"][k]["launches"]
                     for k in ("packed", "chunked")])}),
        dict(name="page_hist", route="cuda",
             source="src/repro_torch/kernels/csrc/page_hist.cu",
             replaces="src/repro/kernels/page_hist.py:45",
             launches=offline["launches"]["page_hist"],
             max_abs_err=errs["page_hist"], **off_timing["page_hist"]),
        dict(name="sim_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/sim_scan.cu",
             replaces="src/repro/kernels/sim_step.py:104",
             launches=offline["launches"]["sim_scan"],
             max_abs_err=errs["sim_scan"], **off_timing["sim_scan"]),
        dict(name="paged_attention_mla", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention_mla.cu",
             replaces="src/repro/kernels/paged_attention.py:230",
             launches=deepseek["graph"]["launches"],
             max_abs_err=max(mla_err, mla_timing.pop("max_abs_err")),
             **mla_timing),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:73",
             launches=gemma["graph"]["launches"],
             max_abs_err=max(flash_err, main_case.pop("max_abs_err")),
             **main_case, shape="B=4 S=T=2048 16/8 heads D=256 float32 "
             "window 1024 (phase 17)",
             also=dict(flash_timing, **{
                 "musicgen-large prefill B=4 S=T=512 32/32 heads D=64 "
                 "float32 causal (phases 17, 24)": dict(
                     musicgen_flash,
                     launches=musicgen["graph"]["flash_launches"])},
                 **wide_flash, **{
                 f"gemma3-12b admission chunk B=1 S=512 q_offset={k[6:]} "
                 "16/8 heads D=256 float32 window 1024 (phase 33; launches: "
                 "every chunk of the run)": dict(
                     v, launches=gpiped["launches"])
                 for k, v in chunk_timing.items()})),
        dict(name="routed_experts", route="cuda",
             source="src/repro_torch/kernels/csrc/routed_experts.cu",
             replaces="src/repro/models/moe.py:85",
             note="no Pallas kernel: moe_apply_dense's einsums",
             launches=deepseek["graph"]["routed_launches"],
             max_abs_err=max(routed_err, main_routed.pop("max_abs_err")),
             **main_routed, shape="deepseek-v3-671b decode: T=4 top-8 of "
             "256 experts, d 7168, f 2048 (phases 11, 22)",
             also={"olmoe-1b-7b decode (phases 22, 23)": dict(
                 routed["olmoe-1b-7b"],
                 launches=olmoe["graph"]["routed_launches"]),
                 "olmoe-1b-7b decode, pipelined, packed and chunked "
                 "admission (phase 36)": dict(launches=[
                     olmoe["pipelined"][k]["routed_launches"]
                     for k in ("packed", "chunked")])}),
        dict(name="mlstm_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/mlstm_scan.cu",
             replaces="src/repro/models/recurrent.py:140",
             note="no Pallas kernel: mlstm_apply's lax.scan (:116-140) and "
             "mlstm_step's cell (:149)",
             launches=xlstm["graph"]["mlstm_launches"],
             max_abs_err=mlstm["max_abs_err"], **mlstm["decode"],
             shape="xlstm-1.3b decode: B=4, S=1, 4 heads of 1024, in place "
             "over the state pages of both tiers (phases 19, 44; kernel "
             "launches: 42 a device step, the strip kernel, and 84 a "
             "prefill, the pre-pass and the chunkwise kernel)",
             also={f"xlstm-1.3b prefill B=1 S={MLSTM_PREFILL_S} from a "
                   "carried state (phase 44; the chunkwise kernel, "
                   "strip_device_ms the strip kernel on the same call)":
                   mlstm["prefill"],
                   "xlstm-1.3b eager route (phase 19)": dict(
                       launches=xlstm["eager"]["mlstm_launches"])}),
        dict(name="slstm_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/slstm_scan.cu",
             replaces="src/repro/models/recurrent.py:237",
             note="no Pallas kernel: slstm_apply's lax.scan over "
             "_slstm_cell (:204) and slstm_step's cell (:245-251)",
             launches=xlstm["graph"]["slstm_launches"],
             max_abs_err=slstm["max_abs_err"],
             sequence_max_dev=slstm["sequence_max_dev"], **slstm["prefill"],
             shape=f"xlstm-1.3b prefill: B=1, S={SLSTM_PREFILL_S}, 4 heads "
             "of 512, from the zero state (phases 19, 45; launches: 6 a "
             "device step and 6 a prefill; max_abs_err: each position from "
             "the plain version's state and from the kernel's own; "
             "sequence_max_dev: the whole sequence, a chaotic recurrence)",
             also={"xlstm-1.3b decode B=4 S=1 (phase 45)": slstm["decode"],
                   "xlstm-1.3b eager route (phase 19)": dict(
                       launches=xlstm["eager"]["slstm_launches"])}),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/rglru_scan.cu",
             replaces="src/repro/models/recurrent.py:326",
             note="no Pallas kernel: rglru_apply's lax.associative_scan and "
             "rglru_step's update (:337-338)",
             launches=rgemma["graph"]["rglru_launches"],
             max_abs_err=rglru["max_abs_err"], **rglru["prefill"],
             shape=f"recurrentgemma-2b prefill: B=1, S={RGLRU_PREFILL_S}, "
             "w=2560, from a carried h (phases 18, 46; launches: 18 a "
             "device step and 18 a prefill)",
             also={"recurrentgemma-2b decode B=4 S=1 (phase 46)":
                   rglru["decode"],
                   "recurrentgemma-2b eager route (phase 18)": dict(
                       launches=rgemma["eager"]["rglru_launches"]),
                   "recurrentgemma-2b training B=4 S=256 (phase 50; 2 a "
                   "RG-LRU layer and step under remat)": dict(
                       launches=train["recurrentgemma-2b"]["launches"][
                           "rglru_scan"],
                       device_ms=rglru_bwd["forward_device_ms"])}),
        dict(name="mlstm_scan_backward", route="cuda",
             source="src/repro_torch/kernels/csrc/mlstm_scan.cu",
             replaces="src/repro/models/recurrent.py:140",
             note="no Pallas kernel: jax.grad of mlstm_apply's lax.scan "
             "(:140) over _mlstm_cell (:85-99)",
             launches=train["xlstm-1.3b"]["launches"]["mlstm_scan_backward"],
             **bwd["mlstm"],
             shape=f"xlstm-1.3b training: B={TRAIN_BATCH}, "
             f"S={TRAIN_SEQ}, 4 heads of {MLSTM_HD} (phases 47, 48; "
             "launches: phase 48's 7 steps, 4 a layer and step; "
             "max_abs_err: the largest gradient distance from the float64 "
             "plain run)"),
        dict(name="slstm_scan_backward", route="cuda",
             source="src/repro_torch/kernels/csrc/slstm_scan.cu",
             replaces="src/repro/models/recurrent.py:237",
             note="no Pallas kernel: jax.grad of slstm_apply's lax.scan "
             "(:237) over _slstm_cell (:204-221); a block a head's 16 "
             "units' 64 gate columns of r_gates, partial recurrent "
             "gradients exchanged as tagged words, one round of reads a "
             "position",
             launches=train["xlstm-1.3b"]["launches"]["slstm_scan_backward"],
             **bwd["slstm"],
             shape=f"xlstm-1.3b training: B={TRAIN_BATCH}, "
             f"S={TRAIN_SEQ}, 4 heads of {SLSTM_HD} (phases 47, 48; "
             "launches: phase 48's 7 steps, 1 a layer and step; "
             "max_abs_err: the largest gradient distance from the float64 "
             "plain run; kernel_device_ms and us_per_position: the kernel "
             "alone, beside the forward's on the same inputs)"),
        dict(name="rglru_scan_backward", route="cuda",
             source="src/repro_torch/kernels/csrc/rglru_scan.cu",
             replaces="src/repro/models/recurrent.py:326",
             note="no Pallas kernel: jax.grad of rglru_apply's "
             "lax.associative_scan (:326) over _rglru_gates (:296-306); one "
             "pass, the forward's turned round: a tile keeps only a and dh "
             "in shared memory (32 KB, six tiles an SM: phase 50's 640 "
             "tiles in one wave), its scan writes g over dh, then all four "
             "warps form the factors from the inputs read again and write "
             "every gradient; dlam's partials reduced in a fixed order by "
             "the last tile of a strip",
             launches=train["recurrentgemma-2b"]["launches"][
                 "rglru_scan_backward"],
             **{k: v for k, v in rglru_bwd.items()
                if k != "max_share_of_bar"},
             shape=f"recurrentgemma-2b training: B={TRAIN_BATCH}, "
             f"S={TRAIN_SEQ}, w={RGLRU_W} (phases 49, 50; launches: phase "
             "50's 7 steps, 1 a RG-LRU layer and step; max_abs_err: the "
             "largest gradient distance from the float64 plain run)")]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
