#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failure:

1. environment: torch/CUDA versions, the card, its power limit;
2. build: the kernels are compiled by ``nvcc`` from ``repro_torch/kernels/
   csrc`` (one process per source, in parallel) and each kernel's
   registers, shared memory and spills from ``-Xptxas -v`` are printed;
3. every kernel against its plain PyTorch version on the card, at the
   main path's shapes on MNIST-sized data (plus the other metrics at a
   smaller n), with the tolerance stated below, the kernel's time, the
   plain version's time, the library call's time where there is one,
   and the bound.  The two streaming kernels (``stream_build_g``,
   ``stream_swap_g``) are checked at the exact pass's full shape
   (m = r = 60,000, d = 784, k = 10, l2) and at ``N_SMALL`` for l2sq, l1
   and cosine, with a non-zero leader row, weight-0 slots, a finite and
   an all-inf ``dnear`` and r not a multiple of 512; being 0.5 s a
   launch, they are timed over fewer repetitions.  ``swap_g_from_cache``
   is checked at a PIC fit's cached round (m = 60,000, B = 100, k = 10),
   on a column slice of the default ring (row stride != B), at k = 1,
   64, 65 and 200 and at the carried-moment repair's shape (the whole
   3,200-column ring, 5 % of the weights set), and timed at the round and
   over the full 60,000-column ring with 5 % of the weights set
   (``cached_checks``).  top2 is also checked and timed at n = 60,000,
   k = 65 and 200 (``top2_large_k``).  Bit checks, which raise when the
   bits differ: build_g equals stream_build_g over yref = the batch
   (r = B) for every metric and both dnear cases; the two smallest
   entries of each row of pairwise(x, medoids) equal top2's d1 and d2
   (k = 10 for every metric; k = 65 and 200, l2); swap_g equals
   swap_g_from_cache fed pairwise's distances (B = 100) and stream_swap_g
   over yref = the batch (r = B) at B = 100 and 300, each at k = 10, 64,
   65 and 200 (no SWAP kernel caps k).  pairwise is also held to
   its plain version at a PIC round's [60,000 x 100] and the ring fill's
   [60,000 x 3,200], and timed at [60,000 x 100], [1 x 60,000] (a BUILD
   d_near row) and [1 x 100] (a leader row) beside ``torch.cdist``.
   The run flag (``run_flag_checks``): build_g, swap_g, pairwise (into a
   slot of a ring, row stride 3,200), swap_g_from_cache and the two
   streaming kernels (m = r = 60,000) with the flag at 1 give the bits of
   no flag (raising), pairwise with it at 0 leaves its ring untouched
   (raising), and a masked launch (flag 0) is timed beside a real one;
4. fit parity on the card: ``backend="cuda"`` against ``backend="torch"``
   on the same draws must give identical medoids, swap history and
   build rounds, and a loss within rtol 1e-5, for the default fit
   (permutation sampling: the ledger equal too), for
   ``sampling="replacement", baseline="leader"`` and for
   ``sampling="replacement", swap_early_stop=True`` (exact-fallback
   counts equal; each phase's ledger within 10 arm-rounds, 10·B
   evaluations: the kernels and cuBLAS round their float32 batch sums
   differently, which can move a kill on an exact margin by a round;
   whether the ledger is exactly equal is printed);
   PAM (``pam(backend="cuda")`` against ``"torch"``: identical
   medoids, swaps and ledger); and five cache configurations over one
   fixed permutation (``reuse="pic"`` at the default ring, at
   ``cache_width=200`` and at the full width n, ``reuse="pic",
   cache_cols=1000``, and the warm block ``cache_cols=1000``): every
   ledger entry within two rounds at full width, 2·n·B evaluations
   (a kill on an exact float32 margin can end a search a round later,
   which moves one round of fresh columns, n·B, one round of cached
   reads, at most n·B, or one round of the carried prefix, at most B
   repaired points at n each); and the default fit at k = 65 on
   ``N_PARITY`` integer points in 65 blobs (``code_blobs``; the
   replacement fits' allowance; the cuda fit's launch counts are
   printed); then the two drivers (``driver_parity``): ``backend="cuda"``
   with ``fused=True`` (device-resident searches) against
   ``fused=False`` (stepped) for the defaults, the leader, the early stop,
   the warm block ``cache_cols=1000``, replacement sampling with the
   leader and with the early stop, and ``reuse="pic"`` at the default
   ring, at ``cache_width=200`` and at the full width with
   ``cache_cols=1000``, whose reports must be identical, the loss bits
   included (host reads printed);
5. the main path at full size: ``KMedoids(k=10, solver="banditpam",
   metric="l2").fit`` on 60,000 MNIST-like points of d=784, then
   ``predict`` on 10,000 more, with every kernel's launch count from that
   run, which must be >= 1, and its host reads by phase; then the same
   fit with ``fused=False`` (``driver_paths``), counted on its own, whose
   report must be the main path's, with both drivers' walls, host reads,
   ledgers and launches, and one ``torch.profiler`` run of each (the
   device's busy and idle share over the fit, kernel time by name, the
   unprofiled walls beside them); then the exact paths on the same rows, each
   counted on its own: ``KMedoids(k=10, sampling="replacement",
   baseline="leader").fit`` (every kernel, the two streaming ones
   included, launched >= 1 times) and ``KMedoids(k=10,
   solver="pam").fit`` (exactly 10 streaming BUILD passes and one
   streaming SWAP pass per iteration), with wall by phase, ledger,
   fallbacks, launches and peak memory (the replacement + leader fit
   again under the stepped driver, whose report must be the fused one's,
   with both drivers' walls and host reads), whether each BanditPAM fit's
   medoids equal PAM's (the paper's claim, measured and not asserted)
   and the loss ratios; PAM's loss is checked against a plain
   ``total_loss``; then BanditPAM++ (``pic_paths``): the default ring
   and the full 60,000-column ring with a warm block, each counted on
   its own, each launching ``swap_g_from_cache``, the full ring running
   the carried-moment repair, and each again under the stepped driver
   (the same report and repairs, raising; both drivers' walls and host
   reads).

6. the other solvers, the threefry draws and the non-kernel metrics
   (``threefry_answers``, ``solver_paths``, ``solver_parity``): (a) the
   port's threefry on the card and on the CPU against jax 0.9.0's known
   answers (``KA_*``: split, fold_in, randint, a 60,000-point
   permutation, choice, uniform), raising; (b) ``KMedoids(k=10,
   solver=s).fit`` on the main path's 60,000 rows for FasterPAM,
   Voronoi iteration, CLARANS, CLARA and OneBatchPAM, each counted on
   its own, with wall, ledger, swaps, host reads, the loss against a
   plain ``total_loss`` and over PAM's, and each kernel's launches
   (its path's kernels must have run); (c) ``backend="cuda"`` against
   ``"torch"`` for each of them on ``N_PARITY`` integer points in 10
   blobs (``code_blobs``): medoids, swap history and ledger equal,
   raising; (d) a ``"precomputed"`` fit on the card equal to the ``l2``
   fit's medoids on those points, and a callable metric fitting on the
   card through ``"torch"`` (no kernel launched) as on the CPU; and
   (``solver_kernel_times``) ``pairwise``, ``swap_g_from_cache`` and
   ``stream_swap_g`` at the shapes these solvers give them, each held
   to its plain version with phase 3's tolerances and timed beside it.
   (c) and (d) run in a process of their own beside phase 11 (a)
   (``PARTS``); the phase prints its wall without them.
7. the serving layer (``serve_path``, ``serve_parity``):
   ``MedoidService(10, "l2")`` on the card with the JAX service's
   defaults, fitted on the main path's 60,000 rows; 200 predict requests
   of 256 rows (p50 / p99 ms, upload and read included); 20,000 drifted
   rows ingested in chunks of 1,000 (rows a second, each refit's
   position, wall, ledger and host reads), counted from 0 before the fit
   (top2, pairwise and swap_g_from_cache must run); each request both
   through the service's assignment, its row bucket's CUDA graph
   (``api.predict.get_assign_fn``), and through an eager ``top2`` launch,
   in turns: labels and dmin bits equal, ``top2`` counted once a request
   on each path, p50 / p99 of each side by side, and ragged requests
   (``RAGGED_ROWS``, ten passes) whose later passes capture no graph;
   the 256-row graph's replay timed beside the eager launch, the plain
   version and the bound (``graph_top2_row``); the warm / cold
   refit pair against the reference's gates; snapshots after the first
   chunk and after half of the stream, each restored on the card, which
   must end where the service that never stopped ended (the early one
   through a refit); and a ``"cuda"`` against a ``"torch"``
   service on ``N_PARITY`` integer points (same refit positions,
   labels, dmin bits and medoids).  All raising; the phase prints its
   wall and launches.
8. batched multi-fit (``batch_paths``, ``lane_kernel_checks``,
   ``batch_parity``; ``[batch]`` lines), ``KMedoids(...,
   solver_params=default_params(s)).fit_batch`` (the leader): (a) the JAX
   package's multi-fit benchmark shape, 64 fits of ``mnist_like(256,
   seed=i)``, d = 784, k = 5, seeds 0-63, for ``banditpam`` and
   ``banditpam_pp`` (both in lockstep lanes, the latter each lane with
   its PIC ring); (b) 8 ragged fits of ``mnist_like`` with n_i = 5,000 +
   1,037·i, d = 784, k = 10, ``banditpam`` and ``banditpam_pp`` (a ring
   of 32 rounds, so every lane's ring recycles); each batch against the
   loop of its single fits (every report identical, the loss bits
   included), both paths' walls by phase, host reads by phase and
   launches by kernel, counted from 0 on each, every lane kernel of the
   batch's path launched; (c) the lane kernels (``build_g_lanes``,
   ``swap_g_lanes`` at k = 10 and 65, ``top2_lanes``, and the PIC
   batch's ``pairwise_lanes`` into (b)'s ring and
   ``swap_g_from_cache_lanes`` from it, at a round's and at the repair's
   shape) at (b)'s padded shape with one lane's run flag at 0: every
   running lane equal bit for bit to the single launch on its slice,
   within phase 3's tolerances of the plain lane version, each timed
   beside the loop of single launches and the plain version, with its
   bound over the running lanes (``pairwise_lanes`` also beside a
   batched ``torch.cdist``); (d) ``backend="cuda"``
   against ``"torch"`` ``fit_batch`` on 4 ragged ``code_blobs`` lanes:
   each equal to its own loop exactly, the two within phase 4's
   allowance.  All raising; the phase prints its wall.
9. the sharded fit (``dist_paths``; ``[dist]`` lines): (a) at world size
   1 on nccl, ``KMedoids(k=10, solver="banditpam_dist",
   metric="l2").fit`` on the main path's 60,000 rows, then with
   ``reuse="pic"`` (the default ring), each on the device-resident loop
   (the default) and then with ``fused=False`` (the stepped loop), each
   counted from 0: wall, host reads and all-reduces by phase, ledger,
   fallbacks, peak memory, launches (pairwise, swap_g_from_cache and
   top2 must run in the resident fit), the two reports identical, the
   resident fit reading fewer times (BUILD under 300 reads) with its
   all-reduces within one a BUILD round run and 31 more a search, the
   stepped fit's exactly one a round run, the loss against a plain
   ``total_loss`` and whether the medoids are PAM's; one
   ``torch.profiler`` run of the resident ``reuse="none"`` fit on the
   first 20,000 rows (busy and idle share, device time by kernel, host
   time by operator);
   ``pairwise`` and ``swap_g_from_cache`` at its round's [60,000 x 128]
   held to their plain versions and timed; (b) ``backend="cuda"``
   against ``"torch"`` at world size 1 on ``N_PARITY`` ``code_blobs``
   (the ledger within 0.1 %, the leader's allowance); (c) two gloo ranks
   spawned on the one card, on the first 8,000 rows and on (b)'s
   ``code_blobs``, ``reuse="none"`` and ``"pic"``, cuda and torch:
   every rank's report identical, cuda's medoids, swaps, build rounds,
   fallbacks and loss those of torch, the ledger within (b)'s allowance
   on ``code_blobs`` (logged only on the 8,000 rows); (c) runs in a
   process of its own beside phase 11 (a) (``PARTS``).  Every process
   group has a timeout and is destroyed at its part's end.  All
   raising; the phase prints its wall without (c).
10. the tile tuner (``tile_paths``, ``repro_torch/core/tuning.py``;
   ``[tiles]`` lines): (a) every compiled shape of every kernel against
   the default shape's bits (the shape the unchanged ``rt_*`` entries
   take) at the main path's shapes and at row 1e's [60,000 x 128] for
   ``pairwise``, with the run flag at 1 (equal bits) and at 0 (outputs
   untouched), the lane forms on a ragged lane set with one lane
   masked, and an index the library lacks raising in every kernel;
   (b) each shape timed beside its bound, the card's name and power
   limit beside, the wave model's table (``TILE_US``) as JSON, the
   configs the heuristic picks at 60,000 and 8,000 rows and the fastest
   shape measured; (c) the default fit under the floor config (the
   ``rt_*`` shapes, the parent's), the heuristic's and two more forced
   through ``tuning.observe``, and the sharded fit at world size 1 on
   nccl (B = 128) under the floor and the heuristic's: every report
   identical to the floor's, the launch counts too.  All raising; the
   phase prints its wall.
11. the runtime guard and the peak-memory budgets (``guard_paths``,
   ``repro_torch/analysis/``; ``[guard]`` and ``[budget]`` lines): (a)
   every device-resident driver under ``FitGuard``, which runs a warm-up
   fit and then the same fit under ``torch.cuda.set_sync_debug_mode
   ("error")`` (any sync but ``engine.host_read``'s reads, the input
   uploads of ``engine.host_stage`` and the phase walls raises), the data
   given as numpy: the default fit, a warm start from its medoids, the
   default-ring PIC fit and the sharded fit at world size 1 on nccl in
   both reuse modes at the main path's 60,000 x 784, the replacement +
   leader fit on 20,000 rows, and phase 8 (a)'s batch in both reuse
   modes; each guarded fit equal to its warm-up (report, reads, launches,
   the kernel library and the tuner's ledger; the sharded fits' warm-up
   is phase 9 (a)'s resident fit, whose launches include the facade's
   labels, so theirs are printed only), its reads printed beside
   ``expected_reads`` and within it, the batches reading fewer times than
   their stepped twins' loops; (b) every budget key of
   ``analysis/budgets.py`` measured at its canonical shapes: the entry
   point's peak temporaries under its bound, its materialised form over
   it, beside the JAX bound where the key carries one over.  (b), phase
   6 (c) and (d) and phase 9 (c) run beside (a), each a process of its
   own (``python3 chip_smoke.py --part NAME``, ``PARTS``: checks whose
   figures are not times, and a peak of temporaries is a process's own),
   their output printed after (a)'s; a part that fails or runs past 600
   s raises, and every part's process is ended before the phase ends.
   All raising; the phase prints (a)'s wall and its own.
12. the LM curation path (``lm_paths``, ``repro_torch/configs``,
   ``models``, ``train``, ``runtime/fault.py``; ``[lm]`` lines): (a)
   ``get_config("qwen3_1_7b")`` at its full width, float32, initialised
   on the card from a seeded ``torch.Generator``, its parameter count
   beside ``param_count()``; (b) ``train.curated.curate_weights`` at
   step 0 (the 64 x 32 pool embedded by the model, 151,936 features a
   point, clustered by ``MedoidCurator``, cosine, the leader baseline)
   with its launch counts (at least one launch, each of the path's
   kernels at least once), then the same fit on ``backend="torch"`` on
   the card over the same embeddings (medoids, swap history, build
   rounds and assignment identical, the loss within rtol 1e-5, each
   phase's ledger within 10·B: phase 4's standard for leader fits), and
   ``build_g``, ``swap_g``, ``top2`` and ``pairwise`` (a leader's row)
   against their plain versions at [64 x 151,936], cosine, within
   ``4·sqrt(d)·2^-24·dmax``, below ``dtol = d·2^-24·dmax`` (phase 3's
   derivation at this d), each timed beside its plain version and its
   bound; (c) three ``make_train_step`` steps at batch 8, seq 64
   (``OptConfig(lr=3e-3, warmup_steps=20)``): finite losses and grad
   norms, the parameters moved, the first loss beside ln(vocab), step
   wall, tokens/s and ``max_memory_allocated``; (d)
   ``FaultTolerantLoop`` at the ``cpu-small`` preset on the card: 6 steps,
   a checkpoint every 2, one injected transient failure, equal bits to an
   uninterrupted run, ``restore_or`` fast-forwarding to step 6; (e) the
   card against the CPU at ``get_reduced("qwen3_1_7b")`` on the same
   weights: logits within 1e-5·max|logits|, three steps' losses within
   rtol 1e-5.  All raising; the phase prints its wall.
13. LM serving (``lm_serve_full_width``, ``lm_serve_card_vs_cpu``,
   ``repro_torch/serve/lm.py``; ``[lm-serve]`` lines) on phase 12's
   model: (a) the prefill of 8 x 64 synthetic prompts into caches of 80
   positions and 16 greedy decode steps at qwen3-1.7B's width in
   float32, the prefill's last logits and every step's logits against
   the model's own full forward over the prompt and the fed tokens,
   within 1e-5·max|logits| (the CPU tests' standard); (b) prefill ms,
   decode p50 / p99 ms a step, tokens/s, ``max_memory_allocated`` and
   the card's name and power limit; (c) the card against the CPU at
   reduced width for qwen3 (global), gemma3 (local, window 16, a prompt
   of 24: the cache rolls) and a ``("chunked",)`` config: greedy tokens
   equal, logits within that tolerance.  All raising; the phase prints
   its wall.
14. the paper's other datasets (``data_paths``, ``core/datasets.py``;
   ``[data]`` lines): the default l1 fit ``KMedoids(k, solver=
   "banditpam", metric="l1")`` on ``scrna_like(10_000, seed=0)`` (d =
   1,000, k = 5: ``benchmarks/scaling_n.py``'s ``fig3b_scrna_l1_k5``) and
   on ``hoc4_like(20_000, seed=0)`` (d = 32, k = 2: ``fig1b_hoc4_tree_k2``)
   on ``backend="cuda"`` and ``"torch"``: the same medoids, swap history,
   build rounds and fallbacks, the loss within rtol 1e-5 and the ledger
   within phase 4's 10·B; ``build_g`` and ``swap_g`` at the scRNA round's
   [10,000 x 100], d = 1,000, l1, held to their plain versions and timed
   beside them and the bound.  All raising; the phase prints its wall.
15. the MoE and SSM/hybrid families (``lm_families``, ``models/moe.py``,
   ``models/ssm.py``; ``[lm-family]`` lines), one model at a time, each
   freed before the next, float32, initialised on the card from a seeded
   ``torch.Generator``: (a) llama4-scout-17b-16e at its published widths
   (d 5120, 40 heads over 8, d_ff 8192, 16 experts top-1 with the shared
   expert, vocab 202,048) at one pattern group (4 layers: 3 chunked, 1
   global); (b) falcon-mamba-7b (64 Mamba-1 layers, tied embeddings) and
   (c) zamba2-2.7b (54 Mamba-2 layers, the shared block called 9 times)
   at full width and depth.  Each: the prefill of 8 x 64 prompts into
   states of 80 positions and 16 greedy steps, the prefill's last logits
   and every step's held against the model's own full forward within
   1e-5·max|logits| or, where larger, twice the full forward's own
   spread between the batch and one sequence a call (float32 rounding
   that grows with depth: 1.285 times 1e-5·max|logits| at falcon-mamba's
   64 layers, ``chip_lm_spread.py``; ``_serve_and_check``), llama4 at
   ``capacity_factor = n_experts / top_k``, where nothing is dropped at
   any token count; prefill ms, decode p50 / p99 ms a step, tokens/s
   and ``max_memory_allocated`` beside the card's name and power limit
   (llama4 at its default capacity factor, timed again, with the
   assignments its prefill drops, counted outside the timed calls).
   (d) the reduced arctic (top-2, dense residual), llama4, falcon-mamba
   and zamba2 configs card against CPU on the same weights: greedy
   tokens equal, logits within 1e-5·max|logits|; (e) one
   decode step of each of (a)–(c) under
   ``torch.cuda.set_sync_debug_mode("error")``: no step may synchronise.
   All raising; each model and the phase print their walls, and the run
   ends with its whole wall.  The phase launches none of the hand-written
   kernels: the JAX package runs MoE dispatch, the scans and SSD in plain
   ``jnp`` outside any Pallas kernel.
16. the frontends and the compressed train step (``lm_frontends``,
   ROADMAP A17e; ``[lm-frontend]`` lines), one model at a time, each
   freed before the next, float32, initialised on the card from a seeded
   ``torch.Generator``: (a) phi-3-vision-4.2B at its published widths
   and depth (32 layers, d 3072, 32 heads, d_ff 8192, vocab 32,064,
   ``vision_proj`` [3072 x 3072]), 8 prompts of 576 patch embeddings
   (``threefry.normal`` draws on the card) and 64 text tokens prefilled
   into states of 656 positions, then 16 greedy text steps; (b)
   musicgen-large (48 layers, d 2048, vocab 2,048 x 4 codebooks), 8 x 64
   x 4 code prompts into states of 80, 16 greedy steps taken per
   codebook; each held to the model's full forward with phase 15's rule,
   with prefill ms, decode p50 / p99 ms, tokens/s and
   ``max_memory_allocated`` beside the card's name and power limit, and
   (e) one decode step under ``torch.cuda.set_sync_debug_mode("error")``;
   (c) the reduced configs of both card against CPU on the same weights
   (greedy tokens equal, logits within 1e-5·max|logits|; a train step's
   loss within rtol 1e-4 and gradients within rtol 1e-4, atol 1e-6),
   and ``patch_emb`` drawn on the card against the CPU draw at the
   reduced shape and at (a)'s [8, 576, 3072], 0 ulps apart; (d) the int8
   error-feedback compressed step (``train.compressed``) at qwen3-1.7B's
   width, 8 x 64, world size 1 on nccl, 4 steps beside 4 uncompressed
   ones from the same weights: every leaf of the JAX tree all-gathered
   as one int8 tensor and its scale, the last losses within 5 %, step
   walls and peaks; then, at that width cut to 4 layers, the compressed
   step in lockstep with its replay (the plain step fed each stacked
   leaf's quantized-then-dequantized gradient, the residual carried),
   parameters, residuals and moments equal bit for bit after each of 4
   steps.  All raising; the phase
   launches none of the hand-written kernels.
17. the mesh layer (ROADMAP A17f; ``[mesh]`` lines): (a)
   ``launch.train.main`` at qwen3-1.7B's full width cut to 2 layers (a
   call may write 45 GiB to the machine's disk; a whole float32
   checkpoint is 24.4 GB) on one rank (no mesh, float32), 8 x 64, 6
   steps checkpointed every 2, then a second
   call resuming from step 4 after the last checkpoint is removed: the
   resumed losses equal the straight run's bit for bit; step wall p50,
   tokens/s and peak memory of each call; (b) the same train step with
   the parameters, the optimizer state and the batch as DTensors placed
   by ``launch.specs`` on a (1, 1) mesh over a world size 1 ``nccl``
   group, beside the plain step in this process: step walls side by
   side, losses within rtol 1e-4 and whether their bits are equal; (c)
   in a part of its own (``PARTS``, beside phase 11 (a)), the dry run
   (``launch.dryrun``, a fake group of 512 ranks, meta tensors) of
   qwen3-1.7B x train_4k on 16 x 16 and llama4-scout x decode_32k on
   2 x 16 x 16: status ``ok``, per-device bytes, FLOPs, collectives by
   kind and seconds.  All raising; the phase launches none of the
   hand-written kernels (the JAX mesh layer runs no Pallas kernel).
18. the graph contracts of the hot entry points (``graph_paths``,
   ``repro_torch/analysis/graph/``, ROADMAP A32; ``[graph]`` lines): the
   whole registry (``python -m repro_torch.analysis.graph``'s 17 specs,
   the JAX registry's names) run once each on the card with
   ``backend="cuda"`` at the canonical small shapes, the two sharded
   specs on a world size 1 ``nccl`` group, every launch in the pinned
   tile config: one line for each entry with its kernel launches by
   name, its transfers, collectives and narrowing casts, its ops and its
   wall.  Raising on any finding of GRC000 (drift against the committed
   golden for this torch and ``cuda``, which must exist), GRC002-GRC006;
   GRC001 is phase 11 (b)'s budgets part, which measured the 11 budget
   keys (the phase counts its passing ``[budget]`` lines, and raises
   unless all 11 passed).  Raising unless the union of the census
   launches all seven kernels.

The ``kernels`` line takes the lane kernels' launches from phase 8's
ragged batch (b) (``pairwise_lanes`` and ``swap_g_from_cache_lanes``
from its ``banditpam_pp`` run, the others from its ``banditpam`` run)
and pairwise/build_g/swap_g/top2's from
the default fit + predict (pairwise's row is timed at predict's
[10,000 x 10] and says so under ``shape``), the streaming kernels' from the replacement
+ leader fit and ``swap_g_from_cache``'s from the full-ring PIC fit;
PAM's and the default-ring PIC fit's are printed above it.  Phase 12
adds one row per kernel its curation launches, at the curation's
[64 x 151,936] cosine shape (``"path": "lm"``), its launches those of
the ``curate_weights`` call.  Phase 7 adds ``top2`` replayed from the
256-row bucket's graph (``"path": "serve-graph"``, its launches the
graph's replays in the phase), and phase 14 ``build_g`` and ``swap_g``
at the scRNA round's l1 shape (``"path": "data"``, its launches the
cuda fit's).  A graph's replay counts as one launch of each kernel it
holds, in every count above.

The last two lines are one JSON object per kernel and the device line.
Without a CUDA device, or without the package beside this script, it
exits with an error and prints no result.

Tolerances (kernel against plain, both float32 on the card).  The two
sum their dot products in different orders; over d = 784 terms the
worst-case relative error of a dot product or abs-sum is about
d·2^-24 < 1e-4, so a distance may differ by ``dtol = 1e-4·dmax``
(l2sq, l1, cosine) and, since sqrt turns an error e near 0 into sqrt(e),
by ``dtol = 1e-2·dmax`` for l2.  Distances are held to
``dtol + 1e-5·|ref|``, and the top-2 labels must agree wherever the two
nearest distances are more than ``2·dtol`` apart (for l2: their squares
more than ``2·1e-4·dmax²``, the l2sq tolerance).  A sum over r reference
columns (r = B for build_g/swap_g, r = all rows for the streaming
kernels) is held to ``L + 1e-5·|ref|`` for Σg, ``2·dmax·L`` for Σg² and
Σg·g_lead in BUILD, and ``2L`` / ``4·dmax·L`` in SWAP (where g adds two
terms), with ``L`` the limit on the row's summed distance error:
``r·dtol`` for l2sq, l1 and cosine, and for l2, per row,
``Σ_j min(sqrt(e), e/d_ij)`` with ``e = 1e-4·dmax²`` and ``d_ij`` the
plain distances (sqrt's residue sqrt(e) is paid only where a distance
is near 0; ``sum_err_limit``).  At the streaming kernels' full shape
this is far below one skipped 64- or 512-column tile's share of Σg.
``swap_g_from_cache`` and its plain version read the same distances, so
they differ only in summation order: ``2·B·2^-24·Σ_j|t_j|`` per row and
arm, ``t_j`` the plain version's terms (``swap_abs_sums``).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3
B = 100                     # reference batch (BanditPAM's default)
N_FIT, N_QUERY = 60000, 10000   # MNIST's train / test split
N_SMALL = 8192              # rows for the other metrics' checks
N_PARITY = 4096             # rows of the cuda-vs-torch fit parity
# The kernels of the default fit + predict; the streaming kernels run on
# the exact paths (replacement sampling's fallback, PAM).
MAIN_KERNELS = ("pairwise", "build_g", "swap_g", "top2")

# Phase 6's threefry known answers, computed with jax 0.9.0
# (jax.random, partitionable threefry, 64-bit types off): split(PRNGKey(0)),
# fold_in(PRNGKey(7), 3), randint(PRNGKey(1), (100,), 0, 60000), the first
# 16 entries and the checksum sum(p[i]·i) of permutation(PRNGKey(0), 60000),
# choice(PRNGKey(0), 60000, (256,), replace=False) and the float32 bits of
# uniform(PRNGKey(2), (8,)).
KA_SPLIT = ((1797259609, 2579123966), (928981903, 3453687069))
KA_FOLD_IN = (276534068, 1641862660)
KA_RANDINT = (
    7996, 2927, 43040, 21353, 4768, 52684, 438, 27381, 47506, 30946, 29408,
    24033, 39874, 12930, 36398, 31226, 40081, 21591, 44603, 2202, 43960,
    15092, 25496, 55114, 36646, 59199, 42426, 67, 34472, 27462, 4644, 39655,
    16307, 57787, 3573, 7153, 30937, 31562, 57804, 14754, 29334, 52154, 7010,
    4624, 55239, 24722, 12301, 12930, 27007, 28017, 40407, 1543, 14556, 9669,
    51209, 39455, 55913, 46339, 6396, 44535, 48380, 53042, 25804, 2883,
    36757, 52965, 7848, 778, 49752, 16298, 20534, 54966, 15971, 28688, 59530,
    48282, 44239, 8114, 4170, 55457, 59028, 54209, 20510, 57573, 13491,
    33185, 47925, 41996, 41781, 35469, 58001, 56915, 9392, 43132, 46386,
    10857, 36662, 56322, 36827, 2005)
KA_PERM_HEAD = (48820, 47051, 9095, 5778, 25367, 40208, 19520, 18286, 34087,
                34222, 28766, 9011, 9052, 31243, 52793, 36801)
KA_PERM_CHECKSUM = 53940813614023
KA_CHOICE = (
    48820, 47051, 9095, 5778, 25367, 40208, 19520, 18286, 34087, 34222,
    28766, 9011, 9052, 31243, 52793, 36801, 28761, 3850, 15391, 58251, 53521,
    14902, 24741, 51056, 26838, 41122, 16388, 46125, 13342, 4602, 32982,
    12917, 54008, 25602, 37036, 34016, 59257, 29841, 25400, 2332, 47971,
    10974, 1547, 153, 161, 22646, 7844, 43607, 4834, 9741, 22752, 43187,
    51739, 59864, 48457, 17201, 2031, 48194, 27632, 49316, 23281, 28711,
    33967, 41688, 10687, 8590, 49534, 7319, 37126, 17521, 713, 22725, 20519,
    28904, 55487, 40246, 581, 56375, 41311, 57586, 22249, 56327, 17546, 3231,
    19745, 42406, 45993, 9138, 49309, 16477, 23543, 39725, 668, 45820, 35287,
    15335, 11538, 6195, 1910, 54826, 54808, 52711, 4003, 43228, 11855, 34771,
    12631, 28541, 47474, 35626, 16647, 44147, 48578, 5554, 35863, 58104,
    47518, 50185, 2646, 13274, 33530, 11977, 23311, 47234, 14047, 9537,
    36924, 53056, 11986, 36229, 41489, 53179, 18193, 57265, 11647, 24031,
    12769, 5025, 45013, 36357, 43308, 14960, 19862, 23481, 18888, 26087,
    11765, 31480, 3121, 39823, 30446, 31094, 17381, 43530, 24482, 53959,
    33818, 58669, 20241, 53823, 56538, 16181, 45053, 59397, 19080, 41223,
    21285, 50869, 49013, 25706, 29076, 52390, 53040, 46746, 21023, 24611,
    13873, 27164, 42793, 18165, 24054, 12141, 4336, 35561, 52340, 41771,
    27764, 59862, 30985, 36173, 57729, 35595, 5485, 24637, 47811, 59943,
    35174, 2072, 37572, 32547, 693, 35676, 10166, 31169, 3139, 48788, 55560,
    8224, 58650, 42122, 33375, 18398, 22326, 32884, 13789, 3189, 59775,
    18938, 29019, 34236, 57754, 58718, 24293, 56675, 10068, 5531, 29818,
    14132, 8254, 20751, 3664, 54273, 52979, 38621, 19450, 7653, 17914, 11859,
    27657, 12961, 6846, 27445, 47065, 42139, 52239, 4511, 27067, 45120,
    23989, 42693, 41226, 56960, 39826, 53146, 59831, 26682)
KA_UNIFORM_BITS = (1059326690, 1063685594, 1047236112, 1063366964, 1054220920,
                   1045376368, 1060881616, 1044380424)


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# Parts that run in a process of their own on the card while phase 11 (a)
# runs (``start_parts`` / ``finish_parts``): each is a check that needs no
# state of this process and whose figures are not times, so a concurrent
# fit does not change them (peak temporaries are per process).
PARTS = ("solver_parity", "dist_ranks", "budgets", "dryrun")


def run_part(name: str) -> int:
    """``python3 chip_smoke.py --part NAME``: one part of ``PARTS`` alone
    (the kernels as the parent built them), raising on a failure."""
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    from repro_torch.kernels import build
    build.lib()
    t0 = time.perf_counter()
    if name == "solver_parity":
        solver_parity(torch, dev)
    elif name == "dist_ranks":
        from repro_torch.core.datasets import mnist_like
        dist_ranks(torch, mnist_like(N_FIT + N_QUERY, seed=0))
    elif name == "budgets":
        guard_budgets(torch, dev, smi())
    elif name == "dryrun":
        mesh_dryrun()
    else:
        raise ValueError(f"no part {name!r}")
    log(f"[part] {name}: {time.perf_counter() - t0:.1f} s in its own "
        f"process")
    return 0


def start_parts():
    """Start every part of ``PARTS``, each ``python3 chip_smoke.py --part
    NAME`` in a process of its own, its output into a temporary file (a
    pipe would stall a part whose output outgrew it while another is
    awaited); returns the processes and their files."""
    import tempfile
    procs = {}
    for name in PARTS:
        out = tempfile.TemporaryFile(mode="w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--part",
             name], cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            text=True), out)
    return procs, time.perf_counter()


def stop_parts(started) -> None:
    """End every part still running and close its output file."""
    for p, out in started[0].values():
        if p.poll() is None:
            p.kill()
            p.wait()
        out.close()


def finish_parts(started, timeout: float = 600.0):
    """Wait for the parts, print each one's output in ``PARTS``' order,
    and raise if one failed or ran past ``timeout`` s; every process is
    ended before returning.  Returns each part's output lines."""
    procs, t0 = started
    failed = []
    lines = {}
    try:
        for name in PARTS:
            p, out = procs[name]
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                failed.append(f"{name} (past {timeout} s)")
            out.seek(0)
            lines[name] = out.read().splitlines()
            for line in lines[name]:
                log(line)
            if p.returncode:
                failed.append(f"{name} (exit {p.returncode})")
    finally:
        stop_parts(started)
    log(f"[part] {', '.join(PARTS)} done {time.perf_counter() - t0:.1f} s "
        f"after their start")
    if failed:
        raise AssertionError(f"parts failed: {failed}")
    return lines


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean ms of ``fn`` over ``reps`` launches, CUDA events, after
    ``warm`` warm-up launches."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(flops: float, nbytes: float):
    tc = flops / PEAK_F32_FLOPS * 1e3
    tb = nbytes / PEAK_BYTES * 1e3
    return (tc, "operations") if tc >= tb else (tb, "bytes")


def dist_tol(metric: str, dmax: float) -> float:
    return (1e-2 if metric == "l2" else 1e-4) * dmax


def check_close(name, got, want, atol, rtol=1e-5):
    """Max abs error of ``got`` against ``want``; raises past
    ``atol + rtol·|want|`` or where the two differ in finiteness.
    ``atol`` is a number or a per-row tensor of the last axis's length."""
    import torch
    fin = want.isfinite()
    if not torch.equal(got.isfinite(), fin) or not torch.equal(got[~fin],
                                                               want[~fin]):
        raise AssertionError(f"{name}: non-finite entries differ")
    g, w = got[fin].double(), want[fin].double()
    a = torch.as_tensor(atol, dtype=torch.float64,
                        device=want.device).expand(want.shape)[fin]
    err = (g - w).abs()
    # An exact match passes a zero limit (0/0 would read as NaN, which
    # max() propagates and no comparison catches).
    ratio = (float(torch.where(err == 0, 0.0, err / (a + rtol * w.abs()))
                   .max()) if err.numel() else 0.0)
    worst = float(err.max()) if err.numel() else 0.0
    lim = (f"{float(a.min()):.3e}..{float(a.max()):.3e}" if a.numel()
           else "-")
    log(f"[check] {name:28s} max_abs_err {worst:.3e}  atol {lim}  "
        f"err/limit {ratio:.3f}")
    if ratio > 1.0:
        raise AssertionError(f"{name}: beyond tolerance (atol {lim})")
    return worst


def require_equal(name, got, want):
    """Raise unless two tuples of tensors are equal bit for bit."""
    import torch
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    log(f"[check] {name:44s} equal bits: {same}")
    if not same:
        raise AssertionError(f"{name}: the bits differ")


def sum_err_limit(x, y, metric: str, dmax: float):
    """Limit on Σ_j |Δd(x_i, y_j)|, the kernel-vs-plain error of a sum of
    distances over the rows of ``y``.  ``r·dtol`` for l2sq, l1 and cosine.
    For l2, per row of ``x`` ([m]): the squared distances differ by at
    most ``e = 1e-4·dmax²`` (l2sq's tolerance), so each distance differs
    by at most ``min(sqrt(e), e/d_ij)`` with ``d_ij`` the plain one: sqrt's
    large residue is paid only where a distance is near 0."""
    import torch
    if metric != "l2":
        return y.shape[0] * dist_tol(metric, dmax)
    from repro_torch.kernels import pairwise
    e = 1e-4 * dmax * dmax
    out = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    for lo in range(0, x.shape[0], 2048):
        dd = pairwise.pairwise_torch(x[lo:lo + 2048], y, metric="l2")
        out[lo:lo + 2048] = torch.clamp_max(e / dd, e ** 0.5).sum(
            dim=1, dtype=torch.float64)
    return out


def clear_of_ties(metric, d1, d2, dmax):
    """Rows whose two nearest distances differ by more than twice the
    tolerance (in l2sq for l2, where the tolerance is stated)."""
    if metric == "l2":
        return (d2 * d2 - d1 * d1) > 2 * 1e-4 * dmax * dmax
    return (d2 - d1) > 2 * dist_tol(metric, dmax)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.lib()
    log(f"[build] nvcc compile {build.build_info.get('compile_s', 0):.1f} s, "
        f"link {build.build_info.get('link_s', 0):.1f} s, total "
        f"{time.perf_counter() - t0:.1f} s (cached={build.build_info['cached']})")
    for src, out in sorted(build.build_info.get("ptxas", {}).items()):
        fn = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif fn and ("Used" in line or "spill" in line):
                log(f"[build] {src} {fn}: {line.split(':', 1)[-1].strip()}")


def kernel_checks(torch, X, dev):
    """Phase 3: each kernel against its plain version at the main path's
    shapes; returns the timing rows (l2, the main path's metric)."""
    from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}

    def stats_case(metric, n, k, d_all):
        x = d_all[:n].contiguous()
        ref = torch.randperm(n, generator=gen)[:B].to(dev)
        y = x[ref].contiguous()
        w = torch.ones(B, device=dev)
        w[-7:] = 0.0                                    # padded slots
        med = x[torch.randperm(n, generator=gen)[:k].to(dev)].contiguous()
        dxy = pairwise.pairwise_torch(y, med, metric=metric)
        dmax = float(pairwise.pairwise_torch(x[:2048], y, metric=metric).max())
        tol = dist_tol(metric, dmax)
        lim = sum_err_limit(x, y, metric, dmax)
        res = {}
        # BUILD, once with the first selection's dnear = inf, once finite.
        for label, dn in (("inf", torch.full((B,), float("inf"), device=dev)),
                          ("finite", dxy.min(dim=1).values.contiguous())):
            lg = (torch.clamp_max(dxy[:, 0] - dn, 0.0) if label == "finite"
                  else dxy[:, 0]).contiguous() * w
            got = ops.build_g_stats(x, y, dn, w, lg, metric=metric)
            want = build_g.build_g_torch(x, y, dn, w, lg, metric)
            e = [check_close(f"build_g[{metric},{label}] {nm}", g, wv, a)
                 for nm, g, wv, a in zip(("sums", "sq", "cross"), got, want,
                                         (lim, 2 * dmax * lim,
                                          2 * dmax * lim))]
            res[f"build_g/{label}"] = (max(e), x, y, dn, w, lg)
            # The streaming kernel over yref = the batch (r = B, one
            # 512-column reference tile) folds the same distance bits in
            # the same order.
            stream = ops.stream_build_g_stats(x, y, dn, w, lg, metric=metric)
            require_equal(f"build_g[{metric},{label}] == stream_build_g",
                          got, stream)
        # SWAP, with d1/d2/assign of the batch from the top-2 kernel.
        d1, d2, a = ops.stream_top2(y, med, metric=metric)
        lg = dxy[:, 0].contiguous()                     # a leader's g-row
        got = ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric=metric)
        want = swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg, metric)
        e = [check_close(f"swap_g[{metric}] {nm}", g, wv, at)
             for nm, g, wv, at in zip(("sums", "sq", "cross"), got, want,
                                      (2 * lim, 4 * dmax * lim,
                                       4 * dmax * lim))]
        res["swap_g"] = (max(e), x, y, d1, d2, a, w, k, lg)
        # top-2 over all n rows.
        got = ops.stream_top2(x, med, metric=metric)
        want = stream_g.top2_torch(x, med, metric)
        e1 = check_close(f"top2[{metric}] d1", got[0], want[0], tol)
        e2 = check_close(f"top2[{metric}] d2", got[1], want[1], tol)
        clear = clear_of_ties(metric, want[0], want[1], dmax)
        if not bool((got[2] == want[2])[clear].all()):
            raise AssertionError(f"top2[{metric}] labels differ off near-ties")
        res["top2"] = (max(e1, e2), x, med)
        # The pairwise kernel and top2 run the same mainloop chains
        # (dist_math.cuh), so a row's two smallest entries are d1 and d2.
        two = torch.topk(ops.pairwise_distance(x, med, metric), 2, dim=1,
                         largest=False).values
        require_equal(f"pairwise[{metric}] row minima == top2 d1, d2",
                      (two[:, 0].contiguous(), two[:, 1].contiguous()),
                      got[:2])
        return res, tol

    for metric, n in (("l2", N_FIT), ("l2sq", N_SMALL), ("l1", N_SMALL),
                      ("cosine", N_SMALL)):
        res, tol = stats_case(metric, n, 10, X)
        # pairwise at predict's shape: 10,000 queries x 10 medoids.
        q = (X[N_FIT:N_FIT + N_QUERY] if metric == "l2" else X[:2000]).contiguous()
        med = res["top2"][2]
        got = ops.pairwise_distance(q, med, metric)
        want = pairwise.pairwise_torch(q, med, metric=metric)
        ep = check_close(f"pairwise[{metric}]", got, want, tol)
        # and at the BUILD d_near update's shape: one medoid row x all n.
        x = res["top2"][1]
        ep = max(ep, check_close(
            f"pairwise[{metric}] d_near", ops.pairwise_distance(
                x[:1], x, metric), pairwise.pairwise_torch(x[:1], x,
                                                           metric=metric), tol))
        log(f"[kernel] {metric}: all kernels within tolerance (distance "
            f"tolerance {tol:.3e}, max distance {float(want.max()):.3e})")
        if metric == "l2":
            rows = time_rows(torch, res, q, med, ep)
            run_flag_checks(torch, res, dev)
            top2_large_k(torch, res["top2"][1], med, dev)
    return rows


def run_flag_checks(torch, res, dev):
    """Phase 3, the run flag at the main path's shapes (l2): with the flag
    at 1, build_g, swap_g, pairwise (into a slot of the default PIC ring,
    row stride 3,200), swap_g_from_cache (a cached round) and the two
    streaming kernels (the exact fallbacks, m = r = 60,000) give the bits
    of no flag (equal bits, raising); with it at 0 pairwise leaves its
    ring, sentinel-filled, untouched (raising); a masked launch (flag 0:
    a round enqueued after its search stopped, a round that is not
    written through, a search with no fallback) is timed beside the real
    one."""
    from repro_torch.kernels import ops
    flag = {v: torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (0, 1)}
    _, x, y, dn, w, lg = res["build_g/finite"]
    _, _, _, d1, d2, a, ws, k, lgs = res["swap_g"]
    n = x.shape[0]
    ring = torch.full((n, 32 * B), float("nan"), device=dev)
    slot = ring[:, 5 * B:6 * B]
    dxy = ops.pairwise_distance(x, y, "l2")
    full = {"dn": torch.full((n,), float("inf"), device=dev),
            "w": torch.ones(n, device=dev), "lg": torch.zeros(n, device=dev)}
    full["d1"], full["d2"], full["a"] = ops.stream_top2(
        x, x[:k].contiguous(), metric="l2")
    calls = {
        "build_g": lambda run: ops.build_g_stats(x, y, dn, w, lg,
                                                 metric="l2", run=run),
        "swap_g": lambda run: ops.swap_g_stats(x, y, d1, d2, a, ws, k, lgs,
                                               metric="l2", run=run),
        "pairwise": lambda run: (ops.pairwise_distance(
            x, y, "l2", out=slot, run=run).clone(),),
        "swap_g_from_cache": lambda run: ops.swap_g_stats_cached(
            dxy, d1, d2, a, ws, k, lgs, run=run),
        "stream_build_g": lambda run: ops.stream_build_g_stats(
            x, x, full["dn"], full["w"], full["lg"], metric="l2", run=run),
        "stream_swap_g": lambda run: ops.stream_swap_g_stats(
            x, x, full["d1"], full["d2"], full["a"], full["w"], k,
            full["lg"], metric="l2", run=run)}
    ops.pairwise_distance(x, y, "l2", out=slot, run=flag[0])
    torch.cuda.synchronize()
    if not bool(ring.isnan().all()):
        raise AssertionError("pairwise with run flag 0 wrote into the ring")
    log("[check] pairwise[l2] run flag 0 leaves its ring slot untouched: "
        "True")
    for name, call in calls.items():
        stream = name.startswith("stream_")
        require_equal(f"{name}[l2] run flag 1 == no flag", call(flag[1]),
                      call(None))
        reps = (3, 1) if stream else (20, 3)
        real = time_ms(lambda: call(flag[1]), *reps)
        masked = time_ms(lambda: call(flag[0]))
        log(f"[time] {name:17s} masked launch (flag 0) {masked:.4f} ms  "
            f"beside the real launch (flag 1) {real:.4f} ms")
    del ring


def top2_large_k(torch, x, med10, dev):
    """Phase 3, top2 past the narrow tile at the main path's n = 60,000:
    k = 65 (one 72-column tile) and k = 200 (two 104-column tiles), l2,
    each against its plain version (the distance tolerance, the labels
    off near-ties), against pairwise's row minima (equal bits, raising)
    and timed beside its bound.  ``torch.cdist`` + ``torch.topk`` is
    timed too, at k = 10 (the medoids of ``kernel_checks``), 65 and 200,
    as a note only: two calls, so no library yardstick."""
    from repro_torch.kernels import ops, pairwise, stream_g
    gen = torch.Generator(device="cpu").manual_seed(3)
    n, d = x.shape
    for k in (10, 65, 200):
        med = med10 if k == 10 else x[torch.randperm(
            n, generator=gen)[:k].to(dev)].contiguous()
        cms = time_ms(lambda: torch.topk(torch.cdist(x, med), 2, dim=1,
                                         largest=False))
        if k == 10:
            log(f"[time] top2 k=10: torch.cdist + torch.topk {cms:.4f} ms "
                f"(two calls, a note, not a library yardstick)")
            continue
        got = ops.stream_top2(x, med, metric="l2")
        want = stream_g.top2_torch(x, med, "l2")
        dmax = float(pairwise.pairwise_torch(x[:2048], med, metric="l2").max())
        tol = dist_tol("l2", dmax)
        err = max(check_close(f"top2[l2,k={k}] d1", got[0], want[0], tol),
                  check_close(f"top2[l2,k={k}] d2", got[1], want[1], tol))
        clear = clear_of_ties("l2", want[0], want[1], dmax)
        if not bool((got[2] == want[2])[clear].all()):
            raise AssertionError(f"top2[l2,k={k}] labels differ off near-ties")
        two = torch.topk(ops.pairwise_distance(x, med, "l2"), 2, dim=1,
                         largest=False).values
        require_equal(f"pairwise[l2] row minima == top2 d1, d2 [k={k}]",
                      (two[:, 0].contiguous(), two[:, 1].contiguous()),
                      got[:2])
        del two
        ms = time_ms(lambda: ops.stream_top2(x, med, metric="l2"))
        pms = time_ms(lambda: stream_g.top2_torch(x, med, "l2"), reps=5,
                      warm=1)
        bms, bby = bound_ms(2.0 * n * k * d, 4.0 * (n * d + k * d + 3 * n))
        log(f"[time] top2 k={k}: kernel {ms:.4f} ms  plain {pms:.4f} ms  "
            f"library -  bound {bms * 1e3:.1f} us ({bby})  share of bound "
            f"{bms / ms:.3f}  max_abs_err {err:.3e}  torch.cdist + "
            f"torch.topk {cms:.4f} ms (a note)")


def time_rows(torch, res, q, med, pairwise_err):
    from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g
    out = []
    _, x, y, dn, w, lg = res["build_g/finite"]
    n, d = x.shape
    fl, by = 2.0 * n * B * d, 4.0 * (n * d + B * d + 3 * B + 3 * n)
    out.append(("build_g", "repro_torch/kernels/csrc/build_g.cu",
                "src/repro/kernels/build_g.py:42",
                max(res["build_g/inf"][0], res["build_g/finite"][0]),
                lambda: ops.build_g_stats(x, y, dn, w, lg, metric="l2"),
                lambda: build_g.build_g_torch(x, y, dn, w, lg, "l2"),
                None, fl, by))
    err, x, y, d1, d2, a, w, k, lg = res["swap_g"]
    fl, by = 2.0 * n * B * d, 4.0 * (n * d + B * d + 5 * B + 3 * k * n)
    out.append(("swap_g", "repro_torch/kernels/csrc/swap_g.cu",
                "src/repro/kernels/swap_g.py:85", err,
                lambda: ops.swap_g_stats(x, y, d1, d2, a, w, k, lg, metric="l2"),
                lambda: swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg, "l2"),
                None, fl, by))
    err, x, m = res["top2"]
    k = m.shape[0]
    fl, by = 2.0 * n * k * d, 4.0 * (n * d + k * d + 3 * n)
    out.append(("top2", "repro_torch/kernels/csrc/stream_g.cu",
                "src/repro/kernels/stream_g.py:165", err,
                lambda: ops.stream_top2(x, m, metric="l2"),
                lambda: stream_g.top2_torch(x, m, "l2"),
                None, fl, by))
    mq, k = q.shape[0], med.shape[0]
    fl, by = 2.0 * mq * k * d, 4.0 * (mq * d + k * d + mq * k)
    out.append(("pairwise", "repro_torch/kernels/csrc/pairwise.cu",
                "src/repro/kernels/pairwise.py:74", pairwise_err,
                lambda: ops.pairwise_distance(q, med, "l2"),
                lambda: pairwise.pairwise_torch(q, med, metric="l2"),
                lambda: torch.cdist(q, med), fl, by))
    rows = []
    for name, src, rep, err, kern, plain, lib, fl, by in out:
        ms = time_ms(kern)
        pms = time_ms(plain)
        lms = time_ms(lib) if lib is not None else None
        bms, bby = bound_ms(fl, by)
        log(f"[time] {name:9s} kernel {ms:.4f} ms  plain {pms:.4f} ms  "
            f"library {'-' if lms is None else f'{lms:.4f} ms'}  bound "
            f"{bms * 1e3:.1f} us ({bby})  share of bound {bms / ms:.3f}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0, "max_abs_err": err,
                     "ms": ms, "plain_ms": pms, "bound_ms": bms,
                     "bound_by": bby, "library_ms": lms})
        if name == "pairwise":
            rows[-1]["shape"] = f"{mq}x{k}x{d}"
    return rows


def stream_checks(torch, X, dev):
    """Phase 3, streaming kernels: each against its plain version at the
    exact pass's shapes (x = yref = the data); returns their timing rows
    (l2 at full size, the main path's metric)."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops, pairwise, stream_g
    gen = torch.Generator(device="cpu").manual_seed(1)
    rows = []
    for metric, n, r in (("l2", N_FIT, N_FIT), ("l2sq", N_SMALL, N_SMALL - 37),
                         ("l1", N_SMALL, N_SMALL - 37),
                         ("cosine", N_SMALL, N_SMALL - 37)):
        x = X[:n].contiguous()
        y = x if r == n else X[:r].contiguous()
        k = 10
        med = x[torch.randperm(n, generator=gen)[:k].to(dev)].contiguous()
        d1, d2, a = ops.stream_top2(y, med, metric=metric)
        dmax = float(pairwise.pairwise_torch(x[:2048], y, metric=metric).max())
        tol = dist_tol(metric, dmax)
        lim = sum_err_limit(x, y, metric, dmax)
        w = torch.ones(r, device=dev)
        w[::97] = 0.0                                   # weight-0 slots
        lead = int(torch.randint(n, (1,), generator=gen))
        dl = ops.pairwise_distance(x[lead:lead + 1], y, metric)[0]
        errs = {}
        for label, dn in (("inf", torch.full((r,), float("inf"), device=dev)),
                          ("finite", d1)):
            lg = engine._build_g(dl[None, :], dn)[0] * w   # a leader's g-row
            args = (x, y, dn, w, lg)
            got = ops.stream_build_g_stats(*args, metric=metric)
            want = stream_g.stream_build_g_torch(*args, metric)
            errs[f"build/{label}"] = max(
                check_close(f"stream_build_g[{metric},{label}] {nm}", g, wv, at)
                for nm, g, wv, at in zip(("sums", "sq", "cross"), got, want,
                                         (lim, 2 * dmax * lim,
                                          2 * dmax * lim)))
        lg = engine._swap_lead_g(dl, d1, d2, a, 3)      # arm (medoid 3, lead)
        sargs = (x, y, d1, d2, a, w, k, lg)
        got = ops.stream_swap_g_stats(*sargs, metric=metric)
        want = stream_g.stream_swap_g_torch(*sargs, metric)
        errs["swap"] = max(
            check_close(f"stream_swap_g[{metric}] {nm}", g, wv, at)
            for nm, g, wv, at in zip(("sums", "sq", "cross"), got, want,
                                     (2 * lim, 4 * dmax * lim,
                                      4 * dmax * lim)))
        log(f"[kernel] {metric}: stream kernels within tolerance over r={r} "
            f"(distance tolerance {tol:.3e}, Σg limit "
            f"{float(torch.as_tensor(lim).max()):.3e})")
        if metric != "l2":
            continue
        d = x.shape[1]
        fl = 2.0 * n * r * d
        by_x = 4.0 * n * d                              # x, also yref here
        for name, src, rep, err, kern, plain, by in (
                ("stream_build_g", "repro_torch/kernels/csrc/stream_stats.cu",
                 "src/repro/kernels/stream_g.py:65",
                 max(errs["build/inf"], errs["build/finite"]),
                 lambda: ops.stream_build_g_stats(*args, metric="l2"),
                 lambda: stream_g.stream_build_g_torch(*args, "l2"),
                 by_x + 4.0 * (3 * r + 3 * n)),
                ("stream_swap_g", "repro_torch/kernels/csrc/swap_g.cu",
                 "src/repro/kernels/stream_g.py:115", errs["swap"],
                 lambda: ops.stream_swap_g_stats(*sargs, metric="l2"),
                 lambda: stream_g.stream_swap_g_torch(*sargs, "l2"),
                 by_x + 4.0 * (5 * r + 3 * k * n))):
            ms = time_ms(kern, reps=3, warm=1)
            pms = time_ms(plain, reps=3, warm=1)
            bms, bby = bound_ms(fl, by)
            log(f"[time] {name:14s} kernel {ms:.3f} ms  plain {pms:.3f} ms  "
                f"library -  bound {bms:.3f} ms ({bby})  share of bound "
                f"{bms / ms:.3f}")
            rows.append({"name": name, "route": "cuda", "source": src,
                         "replaces": rep, "launches": 0, "max_abs_err": err,
                         "ms": ms, "plain_ms": pms, "bound_ms": bms,
                         "bound_by": bby, "library_ms": None})
    return rows


def swap_abs_sums(dxy, d1, d2, a, w, k, lg):
    """Per row and arm, the sums of the magnitudes of the plain version's
    terms (``Σ_j |t_j|``) for Σg, Σg² and Σg·g_lead, each [k, m]: the
    scale of their float32 summation error."""
    import torch
    from repro_torch.core import engine
    base, corr = engine._swap_terms(dxy, d1, d2)
    base = base * w[None, :]
    oh = torch.nn.functional.one_hot(a.long(), k).to(torch.float32)
    oh = oh * w[:, None]
    ab, ac = base.abs(), corr.abs()
    s = ab.sum(dim=1)[None, :] + (ac @ oh).T
    q = (base * base).sum(dim=1)[None, :] + (
        (2.0 * base * corr + corr * corr).abs() @ oh).T
    lga = lg.abs()
    c = (ab @ lga)[None, :] + ((ac * lga[None, :]) @ oh).T
    return s, q, c


def cached_checks(torch, X, dev):
    """Phase 3, ``swap_g_from_cache`` against its plain version on the
    card: at a fit's cached round (m = 60,000, B = 100, k = 10, l2
    distances of the data; a leader row and weight-0 slots), on a column
    slice of the default PIC ring (row stride 3,200 != B), at the
    carried-moment repair's shape (the whole default ring, B = 3,200,
    about 5 % of the weights set) and at k = 1 and k = 64.  Both read the
    same distances, so they differ only in summation order: each sum is
    held to ``2·B·2^-24·Σ_j|t_j|`` per row and arm, ``t_j`` the plain
    version's terms.  Also times the kernel over the full 60,000-column
    ring of fit (b) below (14.4 GB, the repair's real width) and
    ``pairwise`` at a PIC round's fresh shape [60,000 × 100] beside
    ``torch.cdist``.  Returns the kernel's timing row (the cached-round
    slice, the shape of most of its launches)."""
    from repro_torch.kernels import ops, pairwise, swap_g
    gen = torch.Generator(device="cpu").manual_seed(2)
    x = X[:N_FIT].contiguous()
    n = x.shape[0]
    width = 32 * B                                  # the default ring
    refs = x[torch.randperm(n, generator=gen)[:width].to(dev)].contiguous()
    ring = ops.pairwise_distance(x, refs, "l2")
    med = x[torch.randperm(n, generator=gen)[:200].to(dev)].contiguous()

    def vectors(lo, b, k, w_share=1.0):
        d1, d2, a = ops.stream_top2(refs[lo:lo + b].contiguous(), med[:k],
                                    metric="l2")
        w = (torch.rand(b, generator=gen) < w_share).float().to(dev)
        w[-7:] = 0.0                                # padded slots
        lg = (torch.randn(b, generator=gen) * 3).to(dev)
        return d1, d2, a, w, lg

    def case(name, dxy, k, w_share=1.0, lo=0):
        b = dxy.shape[1]
        d1, d2, a, w, lg = vectors(lo, b, k, w_share)
        got = ops.swap_g_stats_cached(dxy, d1, d2, a, w, k, lg)
        want = swap_g.swap_g_from_cache_torch(dxy, d1, d2, a, w, k, lg)
        lim = swap_abs_sums(dxy, d1, d2, a, w, k, lg)
        err = max(check_close(f"swap_g_from_cache[{name}] {nm}", g, wv,
                              2 * b * 2.0 ** -24 * at, rtol=0.0)
                  for nm, g, wv, at in zip(("sums", "sq", "cross"), got,
                                           want, lim))
        return err, (dxy, d1, d2, a, w, k, lg)

    lo = 5 * B
    fresh = ops.pairwise_distance(x, refs[lo:lo + B].contiguous(), "l2")
    # pairwise at a PIC round's fresh shape and at the ring fill's, against
    # its plain version (l2: the distance tolerance of kernel_checks).
    pw_err = 0.0
    for name, got, yy in (("[60000 x 100]", fresh, refs[lo:lo + B]),
                          ("[60000 x 3200]", ring, refs)):
        want = pairwise.pairwise_torch(x, yy.contiguous(), metric="l2")
        pw_err = max(pw_err, check_close(f"pairwise[l2] {name}", got, want,
                                         dist_tol("l2", float(want.max()))))
        del want
    errs = {}
    errs["round"], _ = case("round,k=10", fresh, 10, lo=lo)
    errs["slice"], sl_args = case("ring slice,k=10", ring[:, lo:lo + B], 10,
                                  lo=lo)
    errs["k1"], _ = case("ring slice,k=1", ring[:, lo:lo + B], 1, lo=lo)
    for k in (64, 65, 200):
        errs[f"k{k}"], _ = case(f"ring slice,k={k}", ring[:, lo:lo + B], k,
                                lo=lo)
    errs["repair"], rp_args = case("repair,B=3200,k=10", ring, 10,
                                   w_share=0.05)
    # swap_g, stream_swap_g over yref = the batch (one kernel, one
    # reference tile) and swap_g_from_cache fed pairwise's distances of
    # the batch share one column routine and fold order: equal bits at
    # every k.
    for b in (B, 3 * B):
        yb = refs[lo:lo + b].contiguous()
        for k in (10, 64, 65, 200):
            d1, d2, a, w, lg = vectors(lo, b, k)
            args = (x, yb, d1, d2, a, w, k, lg)
            got = ops.swap_g_stats(*args, metric="l2")
            require_equal(f"swap_g == stream_swap_g [B={b}, k={k}]", got,
                          ops.stream_swap_g_stats(*args, metric="l2"))
            if b == B:
                require_equal(f"swap_g == swap_g_from_cache(pairwise) "
                              f"[k={k}]", got,
                              ops.swap_g_stats_cached(fresh, d1, d2, a, w,
                                                      k, lg))
    log("[kernel] swap_g_from_cache within tolerance at every shape")

    def bytes_of(dxy, w, k):
        # The block's columns that the run's weights need, each read once,
        # the [B] vectors once, three [k, m] outputs written once.
        m, b = dxy.shape
        cols = float((w != 0).sum())
        return 4.0 * (m * cols + 5 * b + 3 * k * m)

    row = None
    for label, args in (("ring slice B=100", sl_args),
                        ("repair B=3200, 5% w", rp_args)):
        dxy, d1, d2, a, w, k, lg = args
        ms = time_ms(lambda: ops.swap_g_stats_cached(dxy, d1, d2, a, w, k,
                                                     lg))
        pms = time_ms(lambda: swap_g.swap_g_from_cache_torch(
            dxy, d1, d2, a, w, k, lg), reps=5, warm=1)
        bms, bby = bound_ms(0.0, bytes_of(dxy, w, k))
        log(f"[time] swap_g_from_cache {label}: kernel {ms:.4f} ms  plain "
            f"{pms:.4f} ms  library -  bound {bms * 1e3:.1f} us ({bby})  "
            f"share of bound {bms / ms:.3f}")
        if row is None:
            row = {"name": "swap_g_from_cache", "route": "cuda",
                   "source": "repro_torch/kernels/csrc/swap_g_from_cache.cu",
                   "replaces": "src/repro/kernels/swap_g.py:118",
                   "launches": 0, "max_abs_err": max(errs.values()),
                   "ms": ms, "plain_ms": pms, "bound_ms": bms,
                   "bound_by": bby, "library_ms": None}
    # The repair's real width: fit (b)'s 60,000-column ring, filled with
    # copies of the default ring (the plain version's [m, B] temporaries
    # would not fit beside it).
    full = torch.empty((n, n), dtype=torch.float32, device=dev)
    for j in range(0, n, width):
        full[:, j:j + width] = ring[:, :min(width, n - j)]
    idx = torch.arange(n, device=dev) % width
    d1, d2, a, _, _ = vectors(0, width, 10)
    d1, d2, a = d1[idx].contiguous(), d2[idx].contiguous(), a[idx].contiguous()
    w = (torch.rand(n, generator=gen) < 0.05).float().to(dev)
    ms = time_ms(lambda: ops.swap_g_stats_cached(full, d1, d2, a, w, 10),
                 reps=5, warm=1)
    bms, bby = bound_ms(0.0, bytes_of(full, w, 10))
    bfull, _ = bound_ms(0.0, 4.0 * n * n)
    log(f"[time] swap_g_from_cache repair B=60000, 5% w: kernel {ms:.4f} ms  "
        f"plain - (no room)  bound {bms:.4f} ms ({bby}; {bfull:.4f} ms to "
        f"read the whole ring)  share of bound {bms / ms:.3f}")
    del full
    # pairwise at a PIC round's fresh shape.
    y = refs[:B].contiguous()
    ms = time_ms(lambda: ops.pairwise_distance(x, y, "l2"))
    pms = time_ms(lambda: pairwise.pairwise_torch(x, y, metric="l2"))
    lms = time_ms(lambda: torch.cdist(x, y))
    d = x.shape[1]
    bms, bby = bound_ms(2.0 * n * B * d, 4.0 * (n * d + B * d + n * B))
    log(f"[time] pairwise [60000 x 100] (a PIC round's fresh block): kernel "
        f"{ms:.4f} ms  plain {pms:.4f} ms  torch.cdist {lms:.4f} ms  bound "
        f"{bms * 1e3:.1f} us ({bby})  share of bound {bms / ms:.3f}  "
        f"max_abs_err {pw_err:.3e}")
    # and at a BUILD d_near row and a leader row (one x row).
    for name, xx, yy in (("[1 x 60000] (a d_near row)", x[:1], x),
                         ("[1 x 100] (a leader row)", x[5:6], y)):
        ms = time_ms(lambda: ops.pairwise_distance(xx, yy, "l2"))
        lms = time_ms(lambda: torch.cdist(xx, yy))
        r = yy.shape[0]
        bms, bby = bound_ms(2.0 * r * d, 4.0 * (d + r * d + r))
        log(f"[time] pairwise {name}: kernel {ms:.4f} ms  torch.cdist "
            f"{lms:.4f} ms  bound {bms * 1e3:.3f} us ({bby})")
    del ring
    torch.cuda.empty_cache()
    return [row]


def fit_parity(torch, X, dev):
    """Phase 4: backend="cuda" against backend="torch" on the card."""
    import numpy as np
    from repro_torch.core import BanditPAM, pam, rng
    n, k = N_PARITY, 5
    data = X[:n].contiguous()
    prng = np.random.default_rng(1)
    perms = (np.stack([prng.permutation(n) for _ in range(k)]),
             np.stack([prng.permutation(n) for _ in range(4 * k + 10)]))
    fits = {}
    for be in ("cuda", "torch"):
        t0 = time.perf_counter()
        fits[be] = BanditPAM(k, metric="l2", backend=be, device=dev).fit(
            data, layouts=rng.from_numpy(*perms))
        log(f"[parity] backend={be:5s} medoids {fits[be].medoids.tolist()} "
            f"loss {fits[be].loss!r} swaps {fits[be].n_swaps} evals "
            f"{fits[be].evals_by_phase} ({time.perf_counter() - t0:.2f} s)")
    a, b = fits["cuda"], fits["torch"]
    same = (a.medoids.tolist() == b.medoids.tolist()
            and [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
            and a.evals_by_phase == b.evals_by_phase
            and a.build_rounds == b.build_rounds and a.n_swaps == b.n_swaps
            and a.converged == b.converged)
    if not same or abs(a.loss - b.loss) > 1e-5 * abs(b.loss):
        raise AssertionError("cuda and torch fits differ")
    log("[parity] cuda == torch: medoids, swap history, ledger, build rounds, "
        f"n_swaps, converged; loss rel diff {abs(a.loss - b.loss) / abs(b.loss):.2e}")
    # The exact paths: replacement sampling (leader, early stop) and PAM.
    r = -(-n // B)
    draws = (prng.integers(0, n, (k, r, B)),
             prng.integers(0, n, (4 * k + 10, r, B)))
    for kw in ({"sampling": "replacement", "baseline": "leader"},
               {"sampling": "replacement", "swap_early_stop": True}):
        for be in ("cuda", "torch"):
            t0 = time.perf_counter()
            fits[be] = BanditPAM(k, metric="l2", backend=be, device=dev,
                                 **kw).fit(data, layouts=rng.from_numpy(
                                     build_draws=draws[0],
                                     swap_draws=draws[1]))
            log(f"[parity] {kw} backend={be:5s} medoids "
                f"{fits[be].medoids.tolist()} swaps {fits[be].n_swaps} "
                f"fallbacks {fits[be].swap_exact_fallbacks} evals "
                f"{fits[be].evals_by_phase} rounds {fits[be].build_rounds} "
                f"({time.perf_counter() - t0:.2f} s)")
        same_fit(fits["cuda"], fits["torch"], str(kw), ledger_slack=10 * B)
    for be in ("cuda", "torch"):
        t0 = time.perf_counter()
        fits[be] = pam(data, k, metric="l2", backend=be, device=dev)
        log(f"[parity] pam backend={be:5s} medoids {fits[be].medoids.tolist()}"
            f" swaps {fits[be].n_swaps} evals {fits[be].evals_by_phase} "
            f"({time.perf_counter() - t0:.2f} s)")
    same_fit(fits["cuda"], fits["torch"], "pam", ledger_slack=0)
    # The cache regimes, over one fixed permutation: the default ring
    # (41 rounds > 32: it recycles), a narrow one, the full ring (the
    # carried-moment repair runs), the ring's warm block, and warm mode.
    fixed = prng.permutation(n)
    for kw in ({"reuse": "pic"}, {"reuse": "pic", "cache_width": 200},
               {"reuse": "pic", "cache_width": n},
               {"reuse": "pic", "cache_cols": 1000},
               {"reuse": "none", "cache_cols": 1000}):
        for be in ("cuda", "torch"):
            t0 = time.perf_counter()
            fits[be] = BanditPAM(k, metric="l2", backend=be, device=dev,
                                 **kw).fit(data, layouts=rng.from_numpy(
                                     fixed_perm=fixed))
            log(f"[parity] {kw} backend={be:5s} medoids "
                f"{fits[be].medoids.tolist()} swaps {fits[be].n_swaps} evals "
                f"{fits[be].evals_by_phase} rounds {fits[be].build_rounds} "
                f"({time.perf_counter() - t0:.2f} s)")
        same_fit(fits["cuda"], fits["torch"], str(kw),
                 ledger_slack=2 * n * B)
    # No SWAP kernel caps k: at k = 65 the bins are held in chunks of 32
    # clusters.  On integer blobs (datasets.code_blobs) both backends get
    # the same distances, so no decision of the k = 65 fit sits on a
    # float32 margin that the kernels and cuBLAS round differently (a
    # draw of its own, so the fits above keep their draws).
    from repro_torch.core.datasets import code_blobs
    k65 = 65
    blobs = torch.from_numpy(code_blobs(n, k65, seed=65)).to(dev)
    p65 = np.random.default_rng(65)
    perms = (np.stack([p65.permutation(n) for _ in range(k65)]),
             np.stack([p65.permutation(n) for _ in range(4 * k65 + 10)]))
    from repro_torch.kernels import ops
    for be in ("cuda", "torch"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fits[be] = BanditPAM(k65, metric="l2", backend=be, device=dev).fit(
            blobs, layouts=rng.from_numpy(*perms))
        log(f"[parity] k={k65} backend={be:5s} swaps {fits[be].n_swaps} "
            f"evals {fits[be].evals_by_phase} loss {fits[be].loss!r} "
            f"({time.perf_counter() - t0:.2f} s)")
        if be == "cuda":
            log(f"[parity] k={k65} backend=cuda kernel launches "
                f"{ops.launch_counts()}")
    # Each medoid's distance to itself is the square root of the l2sq
    # cancellation noise, at most sqrt(2·d·2^-24)·|x|, rounded differently
    # by the kernels and cuBLAS; over 65 medoids it can exceed rtol 1e-5.
    med = blobs[torch.as_tensor(fits["torch"].medoids, device=dev)].double()
    noise = float((2 * blobs.shape[1] * 2.0 ** -24) ** 0.5
                  * med.norm(dim=1).sum())
    same_fit(fits["cuda"], fits["torch"], f"k={k65}", ledger_slack=10 * B,
             loss_atol=noise)


def driver_parity(torch, X, dev):
    """Phase 4, the two drivers on the card: ``backend="cuda"`` with
    ``fused=True`` (device-resident searches, masked rounds through the
    kernels' run flag) against ``fused=False`` (one read a round), on the
    same draws, for the defaults, the leader, the early stop, the warm
    block ``cache_cols=1000``, replacement sampling with the leader and
    with the early stop (the exact fallback decided on the device), and
    the PIC ring at the default width (41 rounds in 32: it recycles), at
    ``cache_width=200`` and at the full width with ``cache_cols=1000``
    (the carried repair).  The reports must be identical (raising):
    medoids, swap history with its losses, build rounds, ledger,
    fallbacks, swaps, convergence and the loss bits; each fit's host
    reads are printed."""
    import numpy as np
    from repro_torch.core import BanditPAM, rng
    n, k = N_PARITY, 5
    data = X[:n].contiguous()
    prng = np.random.default_rng(18)
    perms = [np.stack([prng.permutation(n) for _ in range(k)]),
             np.stack([prng.permutation(n) for _ in range(4 * k + 10)]),
             prng.permutation(n)]
    r = -(-n // B)
    perms[2:2] = [prng.integers(0, n, (k, r, B)),
                  prng.integers(0, n, (4 * k + 10, r, B))]
    for kw in ({}, {"baseline": "leader"}, {"swap_early_stop": True},
               {"cache_cols": 1000},
               {"sampling": "replacement", "baseline": "leader"},
               {"sampling": "replacement", "swap_early_stop": True},
               {"reuse": "pic"}, {"reuse": "pic", "cache_width": 200},
               {"reuse": "pic", "cache_width": n, "cache_cols": 1000}):
        fits = {}
        for fused in (True, False):
            t0 = time.perf_counter()
            fits[fused] = BanditPAM(k, metric="l2", backend="cuda",
                                    device=dev, fused=fused, **kw).fit(
                data, layouts=rng.from_numpy(*perms))
            log(f"[driver] {kw} fused={fused!s:5s} medoids "
                f"{fits[fused].medoids.tolist()} rounds "
                f"{fits[fused].build_rounds} evals "
                f"{fits[fused].evals_by_phase} host reads "
                f"{fits[fused].host_reads_by_phase} "
                f"({time.perf_counter() - t0:.2f} s)")
        same_report(fits[True], fits[False], f"fused vs stepped {kw}")


def same_report(a, b, what):
    """Raise unless two fit reports are identical, the loss bits
    included."""
    fields = ("swap_history", "build_rounds", "evals_by_phase",
              "swap_exact_fallbacks", "n_swaps", "converged", "loss")
    same = a.medoids.tolist() == b.medoids.tolist() and all(
        getattr(a, f) == getattr(b, f) for f in fields)
    log(f"[driver] {what}: identical reports: {same}")
    if not same:
        raise AssertionError(f"{what}: the reports differ")


def same_fit(a, b, what, ledger_slack, loss_atol=0.0, ledger_rtol=0.0,
             ledger=True):
    """Raise unless two fits agree: medoids, swap history, build rounds,
    fallbacks, swaps and convergence equal, each phase's ledger within
    ``ledger_slack`` evaluations plus ``ledger_rtol`` of its value (the
    ledger only logged with ``ledger=False``), the loss within rtol 1e-5
    plus ``loss_atol``."""
    same = (a.medoids.tolist() == b.medoids.tolist()
            and [h[:2] for h in a.swap_history] == [h[:2] for h in b.swap_history]
            and a.build_rounds == b.build_rounds
            and a.swap_exact_fallbacks == b.swap_exact_fallbacks
            and a.n_swaps == b.n_swaps and a.converged == b.converged
            and a.evals_by_phase.keys() == b.evals_by_phase.keys()
            and (not ledger
                 or all(abs(a.evals_by_phase[p] - v)
                        <= ledger_slack + ledger_rtol * v
                        for p, v in b.evals_by_phase.items())))
    if not same or abs(a.loss - b.loss) > 1e-5 * abs(b.loss) + loss_atol:
        raise AssertionError(f"{what}: cuda and torch fits differ")
    ratio = {p: a.evals_by_phase[p] / max(v, 1)
             for p, v in b.evals_by_phase.items()}
    log(f"[parity] {what}: cuda == torch (medoids, swaps, build rounds, "
        f"fallbacks); ledger exactly equal: "
        f"{a.evals_by_phase == b.evals_by_phase}"
        + ("" if ledger else f" (not held; cuda / torch by phase {ratio})")
        + f"; loss rel diff {abs(a.loss - b.loss) / abs(b.loss):.2e}")


def main_path(torch, X, dev, Xnp):
    """Phase 5: the user's call at full size; returns launch counts."""
    import numpy as np
    from repro_torch.api import KMedoids
    from repro_torch.core import total_loss
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    est = KMedoids(k=10, solver="banditpam", metric="l2", seed=0)
    est.fit(Xnp[:N_FIT])
    fit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = est.predict(Xnp[N_FIT:N_FIT + N_QUERY])
    predict_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # Again, not counted: the two buckets' graphs (8,192 and 2,048 rows)
    # are replayed, not captured.
    t0 = time.perf_counter()
    again = est.predict(Xnp[N_FIT:N_FIT + N_QUERY])
    again_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(again, labels):
        raise AssertionError("a replayed predict changed the labels")
    r = est.report_
    log(f"[main] medoids {r.medoids.tolist()}")
    log(f"[main] loss {r.loss!r} n_swaps {r.n_swaps} converged {r.converged}")
    log(f"[main] evals_by_phase {r.evals_by_phase} build_rounds {r.build_rounds}")
    log(f"[main] wall_by_phase {r.wall_by_phase} fit {fit_s:.3f} s "
        f"(data upload included); host_reads_by_phase "
        f"{r.host_reads_by_phase}")
    log(f"[main] predict {N_QUERY} rows {predict_ms:.3f} ms (the chunks' "
        f"graphs captured), again {again_ms:.3f} ms (replayed); peak device "
        f"memory {peak} bytes")
    log(f"[main] kernel launches {counts}")
    if min(counts[k] for k in MAIN_KERNELS) < 1:
        raise AssertionError(f"a kernel of the main path never ran: {counts}")
    # Output checks: shapes, finiteness, the loss against a plain pass, the
    # labels against the plain argmin off near-ties.
    if len(set(r.medoids.tolist())) != 10 or est.labels_.shape != (N_FIT,):
        raise AssertionError("bad medoids or labels")
    data = X[:N_FIT].contiguous()
    med_t = torch.as_tensor(r.medoids, device=dev)
    plain_loss = float(total_loss(data, med_t, metric="l2", backend="torch"))
    if abs(plain_loss - r.loss) > 1e-5 * abs(plain_loss):
        raise AssertionError(f"loss {r.loss} != plain {plain_loss}")
    from repro_torch.core.distances import l2
    dq = l2(X[N_FIT:N_FIT + N_QUERY], data[med_t])
    want = torch.argmin(dq, dim=1).cpu().numpy()
    top = torch.topk(dq, 2, dim=1, largest=False).values
    clear = clear_of_ties("l2", top[:, 0], top[:, 1],
                          float(dq.max())).cpu().numpy()
    if labels.shape != (N_QUERY,) or not (labels == want)[clear].all():
        raise AssertionError("predict labels differ from the plain argmin")
    log(f"[main] predict labels == plain argmin on {int(clear.sum())} of "
        f"{N_QUERY} rows (the rest are near-ties)")
    return counts, r


def driver_paths(torch, X, Xnp, fused_fit, fused_counts):
    """Phase 5, the default fit's two drivers at full size.  The stepped
    fit (``fused=False``), counted from 0, must give the main path's
    fused report (identical, raising); both print wall by phase, host
    reads, ledger and launches (the fused fit's include predict's and
    its masked rounds: fused minus stepped).  Then one ``torch.profiler``
    run of each driver's fit (CPU and CUDA activities, the data already
    on the card) gives the device's busy and idle share over the fit's
    wall and the kernel time by name, with the unprofiled walls beside
    them."""
    from repro_torch.api import KMedoids
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    est = KMedoids(k=10, solver="banditpam", metric="l2", seed=0,
                   fused=False).fit(Xnp[:N_FIT])
    counts = ops.launch_counts()
    stepped = est.report_
    same_report(fused_fit, stepped, "default fit at full size, fused vs "
                "stepped")
    for name, rep, c in (("fused", fused_fit, fused_counts),
                         ("stepped", stepped, counts)):
        log(f"[driver] {name}: wall_by_phase {rep.wall_by_phase} "
            f"host_reads_by_phase {rep.host_reads_by_phase} evals_by_phase "
            f"{rep.evals_by_phase} launches {c}")
    log("[driver] masked launches of the fused fit (fused - stepped): "
        + ", ".join(f"{nm} {fused_counts[nm] - counts[nm]}"
                    for nm in ("build_g", "swap_g")))
    for name, rep in (("fused", fused_fit), ("stepped", stepped)):
        profile_fit(torch, X[:N_FIT].contiguous(), name == "fused", name,
                    rep)


def _trace_events(torch, prof):
    """A profiler's raw events: the device's activity intervals, device
    time by kernel name ``{name: (count, ns)}``, the host's events
    ``(thread, start, -end, name)``, and the union of the device
    intervals in ns (its busy time)."""
    ivs, by_name, host = [], {}, []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append((e.start_thread_id(), start, -end, e.name()))
            continue
        # A range of the host's annotations mirrored on the device
        # timeline is no device activity.
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        ivs.append((start, end))
        cnt, tot = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (cnt + 1, tot + end - start)
    busy, last = 0, None
    for a, b in sorted(ivs):
        if last is None or a > last:
            busy += b - a
            last = b
        elif b > last:
            busy += b - last
            last = b
    return ivs, by_name, host, busy


def profile_fit(torch, data, fused, name, unprofiled, solver="banditpam"):
    """One fit of the default configuration of ``solver`` under
    ``torch.profiler``: the union of the device's activity intervals
    (kernels, copies, memsets) over the fit's host wall is its busy share,
    the rest its idle share; the device time by kernel name follows,
    longest first, then the host's self time by operator.  The tables are
    read from the profiler's raw events (its ``key_averages`` takes
    minutes over the million events of a fit)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import KMedoids
    est = KMedoids(k=10, solver=solver, metric="l2", seed=0, fused=fused)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.fit(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    ivs, by_name, host, busy = _trace_events(torch, prof)
    r = est.report_
    log(f"[profile] {name}: fit of {data.shape[0]} rows, wall {wall:.3f} s "
        f"under the profiler (wall_by_phase {r.wall_by_phase}; rounds "
        f"{sum(r.build_rounds)} BUILD, host reads {r.host_reads_by_phase}"
        + ("" if unprofiled is None
           else f"; unprofiled {unprofiled.wall_by_phase}")
        + f"); {len(ivs)} device activities")
    if not ivs:
        raise AssertionError(f"{name}: the profiler recorded no device "
                             "activity")
    log(f"[profile] {name}: device busy {busy / 1e9:.3f} s, busy share "
        f"{busy / 1e9 / wall:.4f}, idle share {1 - busy / 1e9 / wall:.4f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for nm, (cnt, tot) in top:
        log(f"[profile] {name}:   {tot / 1e6:10.3f} ms  {cnt:7d} x  "
            f"{nm[:90]}")
    # Host time by operator, self (less the operators and runtime calls
    # nested in it on its thread).
    own, stack = {}, []
    for tid, a, neg_b, nm in sorted(host):
        while stack and (stack[-1][0] != tid or stack[-1][1] <= a):
            stack.pop()
        if stack:
            parent = stack[-1][2]
            own[parent][1] -= -neg_b - a
        ent = own.setdefault(nm, [0, 0])
        ent[0] += 1
        ent[1] += -neg_b - a
        stack.append((tid, -neg_b, nm))
    host_s = sum(v[1] for v in own.values()) / 1e9
    log(f"[profile] {name}: host time by operator, self ({host_s:.3f} s "
        f"in all), longest first:")
    for nm, (cnt, tot) in sorted(own.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"[profile] {name}:   {tot / 1e6:10.3f} ms  {cnt:7d} x  "
            f"{tot / 1e3 / cnt:7.2f} us  {nm[:60]}")
    same = ("" if unprofiled is None else f"same report as unprofiled: "
            f"{r.evals_by_phase == unprofiled.evals_by_phase}; ")
    log(f"[profile] {name}: {same}trace read in "
        f"{time.perf_counter() - t1:.1f} s")


def exact_paths(torch, X, dev, Xnp, perm_fit):
    """Phase 5, the exact paths at full size: the paper's literal
    Algorithm 1 (replacement sampling, leader baseline) and PAM on the
    main path's rows, each with the launch counts set to 0 just before
    it and read just after; returns the counts of each."""
    import numpy as np
    from repro_torch.api import KMedoids
    from repro_torch.core import total_loss
    from repro_torch.kernels import ops
    fits, counts = {}, {}
    for name, kw in (("replacement+leader",
                      dict(solver="banditpam", sampling="replacement",
                           baseline="leader")),
                     ("pam", dict(solver="pam"))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        est = KMedoids(k=10, metric="l2", seed=0, **kw).fit(Xnp[:N_FIT])
        fit_s = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        r = est.report_
        fits[name] = r
        log(f"[exact] {name}: medoids {r.medoids.tolist()}")
        log(f"[exact] {name}: loss {r.loss!r} n_swaps {r.n_swaps} converged "
            f"{r.converged} swap_exact_fallbacks {r.swap_exact_fallbacks}")
        log(f"[exact] {name}: evals_by_phase {r.evals_by_phase} build_rounds "
            f"{r.build_rounds}")
        log(f"[exact] {name}: wall_by_phase {r.wall_by_phase} fit "
            f"{fit_s:.3f} s (data upload included)")
        log(f"[exact] {name}: kernel launches {counts[name]}; peak device "
            f"memory {torch.cuda.max_memory_allocated()} bytes")
    # Algorithm 1 ran its bandit rounds and its exact fallbacks on the
    # kernels; PAM is one streaming pass per BUILD step and per SWAP
    # iteration (the last one finds no improving swap).
    c = counts["replacement+leader"]
    if min(c[nm] for nm in MAIN_KERNELS + ("stream_build_g",
                                           "stream_swap_g")) < 1:
        raise AssertionError(f"a kernel of the replacement fit never ran: {c}")
    stepped_driver(torch, Xnp, "replacement+leader",
                   dict(solver="banditpam", sampling="replacement",
                        baseline="leader"), fits["replacement+leader"])
    p = fits["pam"]
    c = counts["pam"]
    n_passes = p.n_swaps + int(p.converged)
    if c["stream_build_g"] != 10 or c["stream_swap_g"] != n_passes:
        raise AssertionError(f"PAM ran {c['stream_build_g']} BUILD and "
                             f"{c['stream_swap_g']} SWAP passes, want 10 "
                             f"and {n_passes}")
    if len(set(p.medoids.tolist())) != 10:
        raise AssertionError("bad PAM medoids")
    data = X[:N_FIT].contiguous()
    med_t = torch.as_tensor(p.medoids, device=dev)
    plain_loss = float(total_loss(data, med_t, metric="l2", backend="torch"))
    if not np.isfinite(p.loss) or abs(plain_loss - p.loss) > 1e-5 * abs(plain_loss):
        raise AssertionError(f"PAM loss {p.loss} != plain {plain_loss}")
    for name, r in (("permutation", perm_fit),
                    ("replacement+leader", fits["replacement+leader"])):
        log(f"[claim] BanditPAM ({name}) medoids == PAM's: "
            f"{sorted(r.medoids.tolist()) == sorted(p.medoids.tolist())}; "
            f"loss / PAM loss {r.loss / p.loss!r}")
    return counts, p


def stepped_driver(torch, Xnp, name, kw, fused_fit):
    """Phase 5, a full-size fit again under the stepped driver
    (``fused=False``, one read a round), counted from 0: its report must
    be the fused fit's (identical, raising); both print wall and host
    reads by phase."""
    from repro_torch.api import KMedoids
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    est = KMedoids(k=10, metric="l2", seed=0, fused=False, **kw).fit(
        Xnp[:N_FIT])
    fit_s = time.perf_counter() - t0
    stepped = est.report_
    same_report(fused_fit, stepped, f"{name} at full size, fused vs stepped")
    for drv, rep in (("fused", fused_fit), ("stepped", stepped)):
        log(f"[driver] {name} {drv}: wall_by_phase {rep.wall_by_phase} "
            f"host_reads_by_phase {rep.host_reads_by_phase}")
    log(f"[driver] {name} stepped: fit {fit_s:.3f} s (data upload "
        f"included); launches {ops.launch_counts()}")


def pic_paths(torch, X, dev, Xnp, pam_fit):
    """Phase 5, BanditPAM++ at full size on the main path's rows, each
    fit with the launch counts set to 0 just before it and read just
    after: (a) ``KMedoids(k=10, reuse="pic")``, the default ring of 32
    rounds (768 MB), which recycles, so every SWAP search starts cold;
    (b) ``KMedoids(k=10, reuse="pic", cache_width=60000,
    cache_cols=3200)``, the full 60,000 × 60,000 ring (14.4 GB) with a
    32-round warm block: no round is recycled, so the carried-moment
    repair (``_carry_delta``, two full-ring passes of
    ``swap_g_from_cache``) runs in every SWAP iteration after the first.
    The repairs are counted by wrapping ``banditpam._carry_delta``.  Each
    fit must launch ``swap_g_from_cache``; (b) must report a non-zero
    ``swap_cached`` and at least one repair.  Each is then fitted again
    under the stepped driver (``stepped_driver``), which must give its
    report and its repairs.  Returns the counts."""
    from repro_torch.api import KMedoids
    from repro_torch.core import banditpam, total_loss
    from repro_torch.kernels import ops
    repairs = []
    orig = banditpam._carry_delta

    def counted(*a, **kw):
        out = orig(*a, **kw)
        repairs.append(out[2])
        return out

    counts, fits = {}, {}
    banditpam._carry_delta = counted
    try:
        for name, kw in (("pic", dict(reuse="pic")),
                         ("pic_full", dict(reuse="pic", cache_width=N_FIT,
                                           cache_cols=32 * B))):
            repairs.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            est = KMedoids(k=10, metric="l2", seed=0, **kw).fit(Xnp[:N_FIT])
            fit_s = time.perf_counter() - t0
            counts[name] = ops.launch_counts()
            r = fits[name] = est.report_
            changed = [int(v) for v in repairs]
            log(f"[pic] {name} {kw}: medoids {r.medoids.tolist()}")
            log(f"[pic] {name}: loss {r.loss!r} n_swaps {r.n_swaps} "
                f"converged {r.converged}")
            log(f"[pic] {name}: evals_by_phase {r.evals_by_phase} fresh "
                f"{r.distance_evals} cached {r.cached_evals} build_rounds "
                f"{r.build_rounds}")
            log(f"[pic] {name}: wall_by_phase {r.wall_by_phase} fit "
                f"{fit_s:.3f} s (data upload and cache set-up included)")
            log(f"[pic] {name}: carried-moment repairs {len(changed)}, "
                f"changed points {changed}")
            log(f"[pic] {name}: kernel launches {counts[name]}; peak device "
                f"memory {torch.cuda.max_memory_allocated()} bytes")
            if counts[name]["swap_g_from_cache"] < 1:
                raise AssertionError(f"{name} never launched "
                                     f"swap_g_from_cache: {counts[name]}")
            if len(set(r.medoids.tolist())) != 10:
                raise AssertionError(f"bad {name} medoids")
            data = X[:N_FIT].contiguous()
            med_t = torch.as_tensor(r.medoids, device=dev)
            plain = float(total_loss(data, med_t, metric="l2",
                                     backend="torch"))
            if abs(plain - r.loss) > 1e-5 * abs(plain):
                raise AssertionError(f"{name} loss {r.loss} != plain {plain}")
            log(f"[claim] BanditPAM++ ({name}) medoids == PAM's: "
                f"{sorted(r.medoids.tolist()) == sorted(pam_fit.medoids.tolist())}"
                f"; loss / PAM loss {r.loss / pam_fit.loss!r}")
            if name == "pic_full" and not (
                    r.evals_by_phase["swap_cached"] > 0 and changed):
                raise AssertionError("the full ring ran no carried repair")
            repairs.clear()
            stepped_driver(torch, Xnp, name, kw, r)
            if [int(v) for v in repairs] != changed:
                raise AssertionError(f"{name}: the stepped fit repaired "
                                     f"{[int(v) for v in repairs]}")
    finally:
        banditpam._carry_delta = orig
    return counts


NEW_SOLVERS = ("fasterpam", "voronoi", "clarans", "clara", "onebatchpam")
# The kernels each new solver must launch on the card.
SOLVER_KERNELS = {"fasterpam": ("stream_swap_g", "top2"),
                  "voronoi": ("pairwise", "top2"),
                  "clarans": ("top2",),
                  "clara": ("stream_build_g", "stream_swap_g", "top2"),
                  "onebatchpam": ("pairwise", "swap_g_from_cache", "top2")}


def threefry_answers(torch, dev):
    """Phase 6 (a): the port's threefry on the card and on the CPU
    against jax 0.9.0's known answers (raising), and the time of one
    n = 60,000 permutation on the card (a search's draw)."""
    from repro_torch.core import threefry as tf
    key0 = tf.PRNGKey(0)
    keys_ok = (tuple(map(tuple, tf.split(key0))) == KA_SPLIT
               and tuple(tf.fold_in(tf.PRNGKey(7), 3)) == KA_FOLD_IN)
    log(f"[threefry] split / fold_in (host ints) == jax: {keys_ok}")
    if not keys_ok:
        raise AssertionError("threefry keys differ from jax's")
    for where in (dev, torch.device("cpu")):
        ri = tf.randint(tf.PRNGKey(1), (100,), 0, 60000, where).cpu()
        p = tf.permutation(key0, 60000, where).cpu()
        c = tf.choice(key0, 60000, (256,), replace=False, device=where).cpu()
        u = tf.uniform(tf.PRNGKey(2), (8,), device=where).cpu()
        got = {"randint": ri.tolist() == list(KA_RANDINT),
               "permutation": (p[:16].tolist() == list(KA_PERM_HEAD)
                               and int((p * torch.arange(60000)).sum())
                               == KA_PERM_CHECKSUM),
               "choice": c.tolist() == list(KA_CHOICE),
               "uniform": u.view(torch.int32).tolist()
               == list(KA_UNIFORM_BITS)}
        log(f"[threefry] {where.type}: equal to jax's known answers: {got}")
        if not all(got.values()):
            raise AssertionError(f"threefry on {where} differs from jax")
    ms = time_ms(lambda: tf.permutation(key0, 60000, dev), reps=10, warm=2)
    log(f"[threefry] permutation(n=60000) on the card {ms:.4f} ms")


def solver_paths(torch, X, dev, Xnp, pam_fit):
    """Phase 6 (b): every new solver through ``KMedoids(k=10,
    solver=s).fit`` on the main path's 60,000 rows (d = 784, l2), each
    counted on its own: wall, ledger, swaps, host reads, loss against a
    plain ``total_loss`` (raising) and over PAM's, and the launches of
    each kernel it ran (its kernels must have run).  Returns the
    counts."""
    from repro_torch.api import KMedoids
    from repro_torch.core import total_loss
    from repro_torch.kernels import ops
    counts = {}
    data = X[:N_FIT].contiguous()
    for name in NEW_SOLVERS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        est = KMedoids(k=10, solver=name, metric="l2", seed=0).fit(
            Xnp[:N_FIT])
        fit_s = time.perf_counter() - t0
        c = counts[name] = ops.launch_counts()
        r = est.report_
        log(f"[solvers] {name}: n {N_FIT} d {X.shape[1]} k 10 medoids "
            f"{r.medoids.tolist()} loss {r.loss!r} n_swaps {r.n_swaps} "
            f"converged {r.converged}")
        log(f"[solvers] {name}: evals_by_phase {r.evals_by_phase} "
            f"wall_by_phase {r.wall_by_phase} fit {fit_s:.3f} s (data "
            f"upload included) host_reads_by_phase {r.host_reads_by_phase}"
            f"; peak device memory {torch.cuda.max_memory_allocated()} "
            f"bytes")
        log(f"[solvers] {name}: kernel launches "
            f"{ {nm: v for nm, v in c.items() if v} }")
        if min(c[nm] for nm in SOLVER_KERNELS[name]) < 1:
            raise AssertionError(f"{name}: a kernel of its path never ran: "
                                 f"{c}")
        if len(set(r.medoids.tolist())) != 10:
            raise AssertionError(f"bad {name} medoids")
        med_t = torch.as_tensor(r.medoids, device=dev)
        plain = float(total_loss(data, med_t, metric="l2", backend="torch"))
        if not abs(plain - r.loss) <= 1e-5 * abs(plain):
            raise AssertionError(f"{name} loss {r.loss} != plain {plain}")
        log(f"[claim] {name}: loss / PAM loss {r.loss / pam_fit.loss!r}; "
            f"medoids == PAM's: "
            f"{sorted(r.medoids.tolist()) == sorted(pam_fit.medoids.tolist())}")
    return counts


def solver_kernel_times(torch, X, dev):
    """Phase 6, the kernels at the shapes the new solvers give them (l2,
    d = 784, k = 10): ``pairwise`` at OneBatchPAM's [60,000 x 256] block
    and Voronoi's [60,000 x 4,096] tile, ``swap_g_from_cache`` over
    OneBatchPAM's block with unit weights, ``stream_swap_g`` at a
    FasterPAM block of 32,768 candidates against all 60,000 references;
    each held to its plain version with phase 3's tolerances (raising)
    and timed beside it, the library call where there is one, and its
    bound."""
    from repro_torch.core import baselines, onebatch, threefry
    from repro_torch.kernels import ops, pairwise, stream_g, swap_g
    from repro_torch.core.engine import _swap_batch_stats
    x = X[:N_FIT].contiguous()
    n, d, k = x.shape[0], x.shape[1], 10
    ref = threefry.choice(threefry.PRNGKey(0), n, (onebatch.DEFAULT_REF_SIZE,),
                          replace=False, device=dev)
    for label, y in (("OneBatchPAM block", x[ref].contiguous()),
                     ("Voronoi tile", x[:baselines.VORONOI_TILE])):
        r = y.shape[0]
        got = ops.pairwise_distance(x, y, "l2")
        want = pairwise.pairwise_torch(x, y, metric="l2")
        err = check_close(f"pairwise[{n}x{r}]", got, want,
                          dist_tol("l2", float(want.max())))
        del got, want
        ms = time_ms(lambda: ops.pairwise_distance(x, y, "l2"), reps=5)
        pms = time_ms(lambda: pairwise.pairwise_torch(x, y, metric="l2"),
                      reps=5)
        lms = time_ms(lambda: torch.cdist(x, y), reps=5)
        bms, bby = bound_ms(2.0 * n * r * d, 4.0 * (n * d + r * d + n * r))
        log(f"[time6] pairwise [{n} x {r}] ({label}): kernel {ms:.4f} ms  "
            f"plain {pms:.4f} ms  torch.cdist {lms:.4f} ms  bound "
            f"{bms:.4f} ms ({bby})  share of bound {bms / ms:.3f}  "
            f"max_abs_err {err:.3e}")
    D = ops.pairwise_distance(x, x[ref].contiguous(), "l2")
    b = D.shape[1]
    Dm = D[:k]                                  # the block rows of 10 medoids
    a_b = torch.argmin(Dm, dim=0)
    d1 = Dm.gather(0, a_b[None])[0]
    d2 = torch.min(Dm.scatter(0, a_b[None], float("inf")), dim=0).values
    a_b = a_b.to(torch.int32)
    w = torch.ones(b, device=dev)
    lg = torch.zeros(b, device=dev)
    got = ops.swap_g_stats_cached(D, d1, d2, a_b, w, k)
    want = _swap_batch_stats(D, d1, d2, a_b, w, k, None)
    lim = swap_abs_sums(D, d1, d2, a_b, w, k, lg)
    err = max(check_close(f"swap_g_from_cache[{n}x{b}] {nm}", g, wv,
                          2 * b * 2.0 ** -24 * li, rtol=0.0)
              for nm, g, wv, li in zip(("sums", "sq"), got[:2], want[:2],
                                       lim[:2]))
    ms = time_ms(lambda: ops.swap_g_stats_cached(D, d1, d2, a_b, w, k))
    pms = time_ms(lambda: swap_g.swap_g_from_cache_torch(D, d1, d2, a_b, w, k,
                                                         lg))
    bms, bby = bound_ms(0.0, 4.0 * (n * b + 5 * b + 3 * k * n))
    log(f"[time6] swap_g_from_cache [{n} x {b}] (OneBatchPAM SWAP, unit "
        f"weights, k={k}): kernel {ms:.4f} ms  plain {pms:.4f} ms  bound "
        f"{bms:.4f} ms ({bby})  share of bound {bms / ms:.3f}  max_abs_err "
        f"{err:.3e}")
    m = baselines.FASTERPAM_BLOCK
    med = x[torch.arange(0, n, n // k, device=dev)[:k]].contiguous()
    d1, d2, a = ops.stream_top2(x, med, metric="l2")
    rows = x[n - m:].contiguous()               # a block's candidate rows
    sargs = (rows, x, d1, d2, a, torch.ones(n, device=dev), k,
             torch.zeros(n, device=dev))
    got = ops.stream_swap_g_stats(*sargs, metric="l2")
    want = stream_g.stream_swap_g_torch(*sargs, "l2")
    dmax = float(pairwise.pairwise_torch(rows[:2048], x, metric="l2").max())
    slim = sum_err_limit(rows, x, "l2", dmax)
    err = check_close(f"stream_swap_g[{m}x{n}] sums", got[0], want[0],
                      2 * slim)
    del got, want
    ms = time_ms(lambda: ops.stream_swap_g_stats(*sargs, metric="l2"),
                 reps=3, warm=1)
    pms = time_ms(lambda: stream_g.stream_swap_g_torch(*sargs, "l2"), reps=2,
                  warm=1)
    bms, bby = bound_ms(2.0 * m * n * d,
                        4.0 * (m * d + n * d + 5 * n + 3 * k * m))
    log(f"[time6] stream_swap_g [{m} x {n}] (a FasterPAM block, k={k}): "
        f"kernel {ms:.3f} ms  plain {pms:.3f} ms  bound {bms:.3f} ms "
        f"({bby})  share of bound {bms / ms:.3f}  max_abs_err {err:.3e}")
    torch.cuda.empty_cache()


def solver_parity(torch, dev):
    """Phase 6 (c) and (d) on ``N_PARITY`` integer points in 10 blobs
    (``code_blobs``: both backends compute the same distances):
    ``backend="cuda"`` against ``"torch"`` for each new solver (medoids,
    swap history, swaps, convergence and ledger equal, the loss within
    rtol 1e-5; raising), FasterPAM's card route (candidate blocks
    through ``stream_swap_g``) against its plain route (one candidate at
    a time); then a ``"precomputed"`` fit on the card against the
    ``l2`` fit (equal medoids, raising) and a callable metric's fit on
    the card (through ``"torch"``: no stats kernel launched) against
    the same fit on the CPU."""
    from repro_torch.api import KMedoids
    from repro_torch.core import baselines, onebatch
    from repro_torch.core.datasets import code_blobs
    from repro_torch.core.distances import l2
    from repro_torch.kernels import ops
    k = 10
    blobs = torch.from_numpy(code_blobs(N_PARITY, k, seed=6)).to(dev)
    run = {"fasterpam": lambda be: baselines.fasterpam(
               blobs, k, seed=0, backend=be, device=dev),
           "voronoi": lambda be: baselines.voronoi_iteration(
               blobs, k, seed=0, backend=be, device=dev),
           "clarans": lambda be: baselines.clarans(
               blobs, k, seed=0, backend=be, device=dev),
           "clara": lambda be: baselines.clara(
               blobs, k, seed=0, backend=be, device=dev),
           "onebatchpam": lambda be: onebatch.onebatchpam(
               blobs, k, seed=0, backend=be, device=dev)}
    for name in NEW_SOLVERS:
        fits = {}
        for be in ("cuda", "torch"):
            t0 = time.perf_counter()
            fits[be] = run[name](be)
            log(f"[parity6] {name} backend={be:5s} medoids "
                f"{fits[be].medoids.tolist()} swaps {fits[be].n_swaps} "
                f"evals {fits[be].evals_by_phase} host reads "
                f"{fits[be].host_reads_by_phase} "
                f"({time.perf_counter() - t0:.2f} s)")
        a, b = fits["cuda"], fits["torch"]
        same = (a.medoids.tolist() == b.medoids.tolist()
                and [h[:2] for h in a.swap_history]
                == [h[:2] for h in b.swap_history]
                and a.evals_by_phase == b.evals_by_phase
                and (a.n_swaps, a.converged) == (b.n_swaps, b.converged))
        if not same or abs(a.loss - b.loss) > 1e-5 * abs(b.loss):
            raise AssertionError(f"{name}: cuda and torch fits differ")
        log(f"[parity6] {name}: cuda == torch (medoids, swaps, ledger); loss "
            f"rel diff {abs(a.loss - b.loss) / abs(b.loss):.2e}")
    # The metrics: the lookup of the exact l2 block, and a callable.
    D = l2(blobs, blobs)
    a = KMedoids(k, metric="precomputed", seed=0, device=dev).fit(D)
    b = KMedoids(k, metric="l2", seed=0, device=dev).fit(blobs)
    log(f"[metrics] precomputed fit medoids {a.medoids_.tolist()} evals "
        f"{a.report_.evals_by_phase}; l2 fit {b.medoids_.tolist()} evals "
        f"{b.report_.evals_by_phase}")
    if a.medoids_.tolist() != b.medoids_.tolist():
        raise AssertionError("the precomputed fit's medoids differ from the "
                             "l2 fit's")

    def chebyshev(x, y):
        return torch.amax(torch.abs(x[:, None, :] - y[None, :, :]), dim=-1)
    ops.reset_launch_counts()
    c = KMedoids(k, metric=chebyshev, seed=0, device=dev).fit(blobs[:1024])
    launched = ops.launch_counts()
    d = KMedoids(k, metric=chebyshev, seed=0, device="cpu").fit(
        blobs[:1024].cpu())
    log(f"[metrics] callable {c.report_.metric!r} on the card: medoids "
        f"{c.medoids_.tolist()} evals {c.report_.evals_by_phase}; launches "
        f"{ {nm: v for nm, v in launched.items() if v} }; cpu medoids "
        f"{d.medoids_.tolist()}")
    if (c.medoids_.tolist() != d.medoids_.tolist()
            or any(launched.values())):
        raise AssertionError("the callable metric's card fit differs from "
                             "the CPU's or launched a kernel")


SERVE_KERNELS = ("top2", "pairwise", "swap_g_from_cache")
N_REQUESTS, REQUEST_ROWS = 200, 256
N_STREAM, STREAM_CHUNK = 20000, 1000


def _same_serving(a, b, what):
    """Raise unless two services are in the same state: medoid bits,
    ``stats()``, reservoir state and refit records (walls aside)."""
    import numpy as np
    ra, rb = a.reservoir.state(), b.reservoir.state()
    strip = [[{f: v for f, v in r.items() if f != "wall_s"}
              for r in s.ledger.refits] for s in (a, b)]
    same = (a.medoid_points.cpu().numpy().tobytes()
            == b.medoid_points.cpu().numpy().tobytes()
            and a.stats() == b.stats() and strip[0] == strip[1]
            and all(np.asarray(ra[k]).tobytes() == np.asarray(rb[k]).tobytes()
                    for k in ra))
    log(f"[serve] {what}: medoids, stats, reservoir state and refit "
        f"records equal: {same}")
    if not same:
        raise AssertionError(f"{what}: the services differ")


def _ingest_all(svc, rows, chunk):
    """Ingest ``rows`` in chunks; returns labels, dmin, and (offset,
    report) for each refit."""
    import numpy as np
    labels, dmin, refits = [], [], []
    for lo in range(0, rows.shape[0], chunk):
        r = svc.ingest(rows[lo:lo + chunk])
        labels.append(r.labels)
        dmin.append(r.dmin)
        if r.refit is not None:
            refits.append((lo, r.refit))
    return np.concatenate(labels), np.concatenate(dmin), refits


def serve_path(torch, X, dev, Xnp):
    """Phase 7, the serving layer at MNIST's size: ``MedoidService(10,
    "l2")`` on the card with the reference's defaults (``banditpam_pp``
    fit, warm refits, a 2,048-point reservoir, drift threshold 0.25 over
    256 points), fitted on the main path's 60,000 rows; 200 ``predict``
    requests of 256 of the 10,000 predict rows (p50 / p99 ms a request,
    upload and read included; labels against the plain argmin off
    near-ties); 20,000 drifted rows (``mnist_like(20000, seed=3) + 0.5``)
    ingested in chunks of 1,000 (rows a second with every refit
    included; each refit's position, wall, ledger and host reads; at
    least one refit, each with BUILD 0, each that swaps with cached
    reads, since its later searches replay the ring its first filled);
    the counts set
    to 0 before the fit and read after the stream, which must have
    launched top2, pairwise and swap_g_from_cache.  Then (not counted)
    ``refit_report_pair()`` against the reference's gates, and snapshots
    taken after the first chunk and after half of the stream, each
    restored on the card and fed the rest, which must end where the
    service that never stopped ended (the early one through a refit).
    Returns the counts."""
    import tempfile

    import numpy as np
    from repro_torch.core.datasets import mnist_like
    from repro_torch.core.distances import l2
    from repro_torch.kernels import ops
    from repro_torch.serve import MedoidService
    stream = mnist_like(N_STREAM, seed=3) + np.float32(0.5)
    half = N_STREAM // 2
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    svc = MedoidService(10, "l2").fit(Xnp[:N_FIT])
    fit_s = time.perf_counter() - t0
    rep = svc.last_report
    log(f"[serve] fit banditpam_pp {svc.solver_params}: {fit_s:.3f} s (data "
        f"upload and reservoir seeding included) medoids "
        f"{rep.medoids.tolist()} loss {rep.loss!r} evals "
        f"{rep.evals_by_phase} host reads {rep.host_reads_by_phase}; "
        f"stats {svc.stats()}")
    queries = Xnp[N_FIT:N_FIT + N_QUERY]
    got = serve_graphs(torch, svc, queries)
    # The labels against the plain argmin off near-ties.
    dq = l2(torch.from_numpy(queries).to(dev), svc.medoid_points)
    want = torch.argmin(dq, dim=1).cpu().numpy()
    top = torch.topk(dq, 2, dim=1, largest=False).values
    clear = clear_of_ties("l2", top[:, 0], top[:, 1],
                          float(dq.max())).cpu().numpy()
    bad = sum(int(((lab != want[lo:lo + REQUEST_ROWS])
                   & clear[lo:lo + REQUEST_ROWS]).sum()) for lo, lab in got)
    if bad:
        raise AssertionError(f"{bad} request labels differ from the plain "
                             f"argmin")
    # Snapshots after the first chunk (before the later refits, so the
    # service resumed from it has to refit as the one that never stopped
    # did) and after half of the stream.
    cuts = (STREAM_CHUNK, half)
    with tempfile.TemporaryDirectory() as snap_root:
        t1 = time.perf_counter()
        snap_s, parts, lo = 0.0, [], 0
        for cut in cuts + (N_STREAM,):
            lab, dmin, refs = _ingest_all(svc, stream[lo:cut], STREAM_CHUNK)
            parts.append((lab, dmin, [(lo + p, r) for p, r in refs]))
            if cut < N_STREAM:
                t_snap = time.perf_counter()
                svc.snapshot(os.path.join(snap_root, f"at_{cut}"))
                snap_s += time.perf_counter() - t_snap
            lo = cut
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t1 - snap_s
        counts = ops.launch_counts()
        labels = np.concatenate([p[0] for p in parts])
        dmins = np.concatenate([p[1] for p in parts])
        refits = [x for p in parts for x in p[2]]
        log(f"[serve] stream: {N_STREAM} rows in chunks of {STREAM_CHUNK}, "
            f"{stream_s:.3f} s, {N_STREAM / stream_s:.1f} rows/s (refits "
            f"included; the snapshots after {list(cuts)} rows, "
            f"{snap_s:.3f} s, not); reservoir {len(svc.reservoir)} of "
            f"{svc.reservoir_size}; stats {svc.stats()}")
        for (pos, r), rec in zip(refits, svc.ledger.refits[1:]):
            log(f"[serve] refit at row {pos + STREAM_CHUNK} of the stream: "
                f"{rec['kind']} wall {rec['wall_s']:.4f} s medoids "
                f"{r.medoids.tolist()} loss {r.loss!r} swaps {r.n_swaps} "
                f"evals {r.evals_by_phase} host reads "
                f"{r.host_reads_by_phase}")
        log(f"[serve] kernel launches, fit + requests + stream: {counts}")
        # A warm refit pays no BUILD.  Its first SWAP search fills the
        # empty ring, so a refit that swaps reads cached columns in its
        # later searches, and one that converges in its first search
        # reads none (the JAX package's warm fit does the same:
        # tests/test_torch_serve.py::test_warm_fit_from_the_optimum_reads_no_cached_column).
        if not refits:
            raise AssertionError("the drifted stream never tripped a refit")
        for pos, r in refits:
            if r.evals_by_phase["build"] != 0 or (
                    r.n_swaps > 0 and r.ledger()["cached"] <= 0):
                raise AssertionError(f"the warm refit at {pos} paid BUILD or "
                                     f"swapped and read no cached column")
        if not any(r.ledger()["cached"] > 0 for _, r in refits):
            raise AssertionError("no warm refit read a cached column")
        if min(counts[nm] for nm in SERVE_KERNELS) < 1:
            raise AssertionError(f"a kernel of the serving path never ran: "
                                 f"{counts}")
        # Snapshot and resume: each restored service, fed the rest of the
        # stream, gives the same labels, dmin bits and refits and ends
        # where the service that never stopped ended.  The early one must
        # refit on the way.
        for cut in cuts:
            back = MedoidService.restore(os.path.join(snap_root, f"at_{cut}"))
            lab_c, dmin_c, refs_c = _ingest_all(back, stream[cut:],
                                                STREAM_CHUNK)
            refs_c = [(cut + p, r) for p, r in refs_c]
            after = [(p, r) for p, r in refits if p >= cut]
            same = (np.array_equal(labels[cut:], lab_c)
                    and dmins[cut:].tobytes() == dmin_c.tobytes()
                    and [p for p, _ in after] == [p for p, _ in refs_c]
                    and all(x.medoids.tolist() == y.medoids.tolist()
                            for (_, x), (_, y) in zip(after, refs_c)))
            log(f"[serve] resumed after {cut} rows: labels, dmin bits, refit "
                f"positions {[p + STREAM_CHUNK for p, _ in refs_c]} and "
                f"their medoids equal: {same}")
            if not same:
                raise AssertionError(f"the service resumed after {cut} rows "
                                     f"went another way")
            if cut == STREAM_CHUNK and not refs_c:
                raise AssertionError("the service resumed after the first "
                                     "chunk never refitted")
            _same_serving(svc, back, f"resumed after {cut} rows vs never "
                          f"stopped")
    # Warm against cold on the same sample and seed (the reference's
    # gates: benchmarks/serve_bench.py, tests/test_serve.py).
    warm, cold = svc.refit_report_pair()
    for name, r in (("warm", warm), ("cold", cold)):
        led = r.ledger()
        log(f"[serve] refit pair, {name}: ledger {led} loss {r.loss!r} swaps "
            f"{r.n_swaps} wall {r.wall_by_phase} cached fraction "
            f"{led['cached'] / (led['fresh'] + led['cached'])!r}")
    gates = {"warm cached > 0": warm.ledger()["cached"] > 0,
             "warm build == 0": warm.evals_by_phase["build"] == 0,
             "cold build > 0": cold.evals_by_phase["build"] > 0,
             "warm fresh < cold fresh":
                 warm.ledger()["fresh"] < cold.ledger()["fresh"],
             "warm loss <= cold loss (rtol 1e-5)":
                 warm.loss <= cold.loss + 1e-5 * abs(cold.loss)}
    log(f"[serve] refit pair gates: {gates}")
    if not all(gates.values()):
        raise AssertionError(f"the warm refit failed a gate: {gates}")
    return counts, graph_top2_row(torch, svc, queries)


# Phase 7's ragged requests: each size's bucket is captured in the first
# pass and replayed in the others.
RAGGED_ROWS = (1, 3, 100, 256, 257, 1000, 4097)
RAGGED_PASSES = 10


def _eager_assign(torch, q, med):
    """The eager request the graphs replace: the queries uploaded from
    pageable memory, one ``top2`` launch, labels and dmin read in one copy
    as int32 words."""
    import numpy as np
    from repro_torch.kernels import ops
    x = torch.as_tensor(q, dtype=torch.float32).to(med.device).contiguous()
    d1, _, labels = ops.stream_top2(x, med, metric="l2")
    host = torch.stack([labels.to(torch.int32),
                        d1.view(torch.int32)]).cpu().numpy()
    return host[0], host[1].view(np.float32)


def serve_graphs(torch, svc, queries):
    """Phase 7 (b): each request through the service's assignment (the
    bucket's CUDA graph, ``api.predict.get_assign_fn``) and through the
    eager ``top2`` launch, in turns in one process: labels and dmin bits
    equal, ``top2`` counted once a request on each path (raising);
    ``N_REQUESTS`` requests of ``REQUEST_ROWS`` rows, then
    ``RAGGED_PASSES`` passes over ``RAGGED_ROWS``, whose first pass
    captures each new bucket and whose later passes must capture none.
    p50 / p99 ms a request, upload and read included, of each path side
    by side (the first 256-row request, which captures its bucket,
    apart).  Returns (offset, labels) of the 256-row requests."""
    import numpy as np
    from repro_torch.api import predict
    from repro_torch.kernels import ops
    med = svc.medoid_points

    def one(q, path):
        c0 = ops.launch_counts()["top2"]
        t = time.perf_counter()
        out = (svc._assign(q) if path == "graph"
               else _eager_assign(torch, q, med))
        ms = (time.perf_counter() - t) * 1e3
        if ops.launch_counts()["top2"] != c0 + 1:
            raise AssertionError(f"a {path} request of {q.shape[0]} rows "
                                 f"counted {ops.launch_counts()['top2'] - c0}"
                                 f" top2 launches")
        return out, ms

    def pair(q, what):
        (gl, gd), gms = one(q, "graph")
        (el, ed), ems = one(q, "eager")
        if not (np.array_equal(gl, el) and gd.tobytes() == ed.tobytes()):
            raise AssertionError(f"{what}: the graph's labels or dmin bits "
                                 f"differ from the eager launch's")
        return gl, gms, ems

    def pct(ms):
        p50, p99 = np.percentile(ms, [50, 99])
        return f"p50 {p50:.4f} ms p99 {p99:.4f} ms"

    got, ms = [], {"graph": [], "eager": []}
    for i in range(N_REQUESTS):
        lo = (i * REQUEST_ROWS) % (N_QUERY - REQUEST_ROWS)
        labels, gms, ems = pair(queries[lo:lo + REQUEST_ROWS],
                                f"request {i}")
        got.append((lo, labels))
        ms["graph"].append(gms)
        ms["eager"].append(ems)
    log(f"[serve] predict: {N_REQUESTS} requests of {REQUEST_ROWS} rows, "
        f"upload and read included, requests 2-{N_REQUESTS}: graph "
        f"{pct(ms['graph'][1:])} | eager top2 {pct(ms['eager'][1:])}; the "
        f"first request: graph {ms['graph'][0]:.3f} ms (its bucket "
        f"captured), eager {ms['eager'][0]:.3f} ms; labels and dmin bits "
        f"equal on every request, top2 counted once a request on each path")
    rag, first = {"graph": [], "eager": []}, {}
    for p_i in range(RAGGED_PASSES):
        for m in RAGGED_ROWS:
            lo = (p_i * 1013) % (N_QUERY - m)
            misses = predict.get_assign_fn.cache_info().misses
            _, gms, ems = pair(queries[lo:lo + m], f"ragged request of {m}")
            new = predict.get_assign_fn.cache_info().misses - misses
            if p_i == 0:
                first[m] = (new, round(gms, 3))
            elif new:
                raise AssertionError(f"a repeated bucket ({m} rows) was "
                                     f"captured again")
            else:
                rag["graph"].append(gms)
                rag["eager"].append(ems)
    log(f"[serve] ragged requests {list(RAGGED_ROWS)}, {RAGGED_PASSES} "
        f"passes: first pass (rows: (graphs captured, graph ms)) {first}; "
        f"passes 2-{RAGGED_PASSES}, no capture: graph {pct(rag['graph'])} | "
        f"eager top2 {pct(rag['eager'])}; labels and dmin bits equal, top2 "
        f"counted once a request; assign graphs cached "
        f"{predict.get_assign_fn.cache_info().currsize}")
    return got


def graph_top2_row(torch, svc, queries):
    """Phase 7 (c), not counted: the 256-row bucket's graph replayed
    alone (``top2`` and the words' stack) beside the eager ``top2``
    launch and the plain version on the same request; its ``dmin`` held
    to the plain d1 within phase 3's l2 tolerance.  Returns the kernels
    line's row, its launches the graph's replays in this phase."""
    from repro_torch.api import predict
    from repro_torch.kernels import ops, stream_g
    med = svc.medoid_points
    k, d = med.shape
    dev = predict._device_key(med.device)
    fn = predict.get_assign_fn(k, d, svc.metric, predict.resolve_backend(
        svc.backend, svc.metric, dev), REQUEST_ROWS, dev)
    replays = fn.replays
    q = queries[:REQUEST_ROWS]
    x = torch.from_numpy(q).to(dev)
    _, dmin = fn(q, med)
    want = stream_g.top2_torch(x, med, "l2")[0]
    dmax = float(torch.cdist(x, med).max())
    err = check_close("top2 graph replay d1", torch.from_numpy(dmin).to(dev),
                      want, dist_tol("l2", dmax))
    ms = time_ms(fn.graph.replay)
    ems = time_ms(lambda: ops.stream_top2(x, med, metric="l2"))
    pms = time_ms(lambda: stream_g.top2_torch(x, med, "l2"))
    bms, bby = bound_ms(2.0 * REQUEST_ROWS * k * d,
                        4.0 * (REQUEST_ROWS * d + k * d + 3 * REQUEST_ROWS))
    log(f"[serve] [time] top2 [{REQUEST_ROWS}x{k}x{d}] graph replay "
        f"{ms:.4f} ms (top2 and the words' stack) eager launch {ems:.4f} ms "
        f"plain {pms:.4f} ms bound {bms * 1e3:.2f} us ({bby}); the graph "
        f"replayed {replays} times in the phase")
    return {"name": "top2", "route": "cuda",
            "source": "repro_torch/kernels/csrc/stream_g.cu",
            "replaces": "src/repro/kernels/stream_g.py:165",
            "launches": replays, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None, "shape": f"{REQUEST_ROWS}x{k}x{d}",
            "path": "serve-graph"}


def serve_parity(torch, dev):
    """Phase 7, ``backend="cuda"`` against ``"torch"`` services on the
    card, on ``N_PARITY`` integer points in 10 blobs (``code_blobs``:
    both backends compute the same distances), fed ``N_PARITY`` points of
    other blobs in chunks of 500: the same refit positions, labels, dmin bits
    and medoids, ledgers within phase 4's cache-mode allowance (2·n·B per
    entry); raising."""
    import numpy as np
    from repro_torch.core.datasets import code_blobs
    from repro_torch.serve import MedoidService
    fit_rows = code_blobs(N_PARITY, 10, seed=6)
    stream = code_blobs(N_PARITY, 10, seed=7)
    out = {}
    for be in ("cuda", "torch"):
        t0 = time.perf_counter()
        svc = MedoidService(10, "l2", backend=be).fit(fit_rows)
        out[be] = (svc, *_ingest_all(svc, stream, 500))
        log(f"[serve] parity {be:5s}: refits at "
            f"{[p for p, _ in out[be][3]]} medoids "
            f"{[r.medoids.tolist() for _, r in out[be][3]]} ledgers "
            f"{[r.evals_by_phase for _, r in out[be][3]]} "
            f"({time.perf_counter() - t0:.2f} s)")
    (a, la, da, ra), (b, lb, db, rb) = out["cuda"], out["torch"]
    n = 10 + len(a.reservoir)
    same = (bool(ra) and [p for p, _ in ra] == [p for p, _ in rb]
            and np.array_equal(la, lb) and da.tobytes() == db.tobytes()
            and all(x.medoids.tolist() == y.medoids.tolist()
                    and x.evals_by_phase.keys() == y.evals_by_phase.keys()
                    and all(abs(v - y.evals_by_phase[p]) <= 2 * n * B
                            for p, v in x.evals_by_phase.items())
                    for (_, x), (_, y) in zip(ra, rb))
            and a.medoid_points.cpu().numpy().tobytes()
            == b.medoid_points.cpu().numpy().tobytes())
    log(f"[serve] parity: cuda == torch (refit positions, labels, dmin bits, "
        f"medoids; ledgers within 2·n·B): {same}; ledgers exactly equal: "
        f"{[x.evals_by_phase == y.evals_by_phase for (_, x), (_, y) in zip(ra, rb)]}")
    if not same:
        raise AssertionError("the cuda and torch services differ")


# Phase 8: the JAX package's multi-fit benchmark shape (benchmarks/
# multifit_bench.py: 64 fits, n = 256, k = 5) and a ragged batch of
# MNIST-sized fits (n_i = 5,000 + 1,037·i, no n_i a multiple of B).
BATCH_FITS, BATCH_N, BATCH_K = 64, 256, 5
RAGGED_N = tuple(5000 + 1037 * i for i in range(8))
RAGGED_K = 10
LANE_KERNELS = ("build_g_lanes", "swap_g_lanes", "top2_lanes")
# The PIC batch's (banditpam_pp) lane kernels, and its ring at (b): the
# default 32 rounds of B columns and the scratch, [8, 12,272, 33·B].
PIC_LANE_KERNELS = ("pairwise_lanes", "swap_g_from_cache_lanes",
                    "top2_lanes")
PIC_RING_ROUNDS = 32


def _sum_phases(reports, field):
    out = {}
    for r in reports:
        for ph, v in getattr(r, field).items():
            out[ph] = out.get(ph, 0) + v
    return out


def batch_vs_loop(torch, what, solver, Xs, seeds, k):
    """Phase 8 (a, b): ``KMedoids.fit_batch`` against the loop of its
    single fits, each counted from 0; raises unless every report is
    identical (loss bits included).  Prints both paths' walls, host reads
    and launches; returns the batch's launch counts and report."""
    from repro_torch.api import KMedoids
    from repro_torch.api.registry import default_params
    from repro_torch.kernels import ops
    params = default_params(solver)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = KMedoids(k, solver=solver, metric="l2", seed=0,
                   **params).fit_batch(Xs, seeds=seeds)
    batch_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loop = [KMedoids(k, solver=solver, metric="l2", seed=s, **params).fit(
        X).report_ for X, s in zip(Xs, seeds)]
    loop_s = time.perf_counter() - t0
    loop_counts = ops.launch_counts()
    for i, (a, b) in enumerate(zip(rep, loop)):
        same = (a.medoids.tolist() == b.medoids.tolist() and all(
            getattr(a, f) == getattr(b, f)
            for f in ("swap_history", "build_rounds", "evals_by_phase",
                      "n_swaps", "converged", "loss")))
        if not same:
            raise AssertionError(f"{what}: fit {i} of the batch differs from "
                                 f"its single fit")
    labels_ok = all((rep.labels[i, :X.shape[0]] == b.labels).all()
                    for i, (X, b) in enumerate(zip(Xs, loop)))
    if not labels_ok:
        raise AssertionError(f"{what}: batch labels differ from the loop's")
    log(f"[batch] {what}: {len(Xs)} fits, batch == loop (medoids, swaps, "
        f"build rounds, ledger, loss bits, labels): True; swaps "
        f"{sum(r.n_swaps for r in rep)}, ledger "
        f"{sum(r.distance_evals for r in rep)} fresh "
        f"{sum(r.cached_evals for r in rep)} cached")
    log(f"[batch] {what}: batch wall_by_phase {rep.wall_by_phase} call "
        f"{batch_s:.3f} s (upload and labels included); host_reads_by_phase "
        f"{rep.host_reads_by_phase}; dispatches_by_phase "
        f"{rep.dispatches_by_phase}; launches "
        f"{ {nm: v for nm, v in counts.items() if v} }")
    log(f"[batch] {what}: loop wall_by_phase {_sum_phases(loop, 'wall_by_phase')}"
        f" calls {loop_s:.3f} s; host_reads_by_phase "
        f"{_sum_phases(loop, 'host_reads_by_phase')} (one fit: "
        f"{loop[0].host_reads_by_phase}); launches "
        f"{ {nm: v for nm, v in loop_counts.items() if v} }")
    return counts, rep


def lane_kernel_checks(torch, Xs, dev):
    """Phase 8 (c): the lane kernels at the ragged batch's padded shape,
    lane 3's run flag at 0; returns their ``kernels`` rows."""
    from repro_torch.core.engine import LaneData
    from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g
    lanes = LaneData.pad([torch.from_numpy(X).to(dev) for X in Xs], dev)
    L, n_pad, d = lanes.data.shape
    gen = torch.Generator(device="cpu").manual_seed(8)
    ref = torch.stack([torch.randperm(n, generator=gen)[:B]
                       for n in lanes.ns]).to(dev)
    y = lanes.gather(ref).contiguous()
    w = torch.ones((L, B), device=dev)
    w[:, -7:] = 0.0
    run = torch.ones((L,), dtype=torch.int32, device=dev)
    run[3] = 0
    live = [i for i in range(L) if i != 3]
    med = {k: torch.stack([lanes.lane(i)[torch.randperm(n, generator=gen)[
        :k].to(dev)] for i, n in enumerate(lanes.ns)]).contiguous()
        for k in (10, 65)}
    dn = torch.stack([pairwise.pairwise_torch(y[i], med[10][i],
                                              metric="l2").min(dim=1).values
                      for i in range(L)]).contiguous()
    lg = torch.clamp_max(torch.stack([pairwise.pairwise_torch(
        y[i], med[10][i, :1], metric="l2")[:, 0] for i in range(L)]) - dn,
        0.0).contiguous() * w
    dmax = max(float(pairwise.pairwise_torch(lanes.lane(i)[:2048], y[i],
                                             metric="l2").max())
               for i in range(L))
    lims = [sum_err_limit(lanes.lane(i), y[i], "l2", dmax) for i in range(L)]
    nlive = sum(lanes.ns[i] for i in live)
    rows = []

    def lane_row(name, src, replaces, lane_fn, single_fns, plain_fn,
                 scale, outs, fl, by, names=("sums", "sq", "cross")):
        got = lane_fn()
        for i in live:
            one = single_fns[i]()
            require_equal(f"{name} lane {i} (n={lanes.ns[i]}) == single "
                          f"launch", tuple(g[i, ..., :lanes.ns[i]]
                                           for g in got[:outs]), one[:outs])
        want = plain_fn()
        err = 0.0
        for i in live:
            n = lanes.ns[i]
            for nm, g, wv, a in zip(names, got, want, scale(i)):
                if a is not None:
                    err = max(err, check_close(
                        f"{name}[{i}] {nm}", g[i, ..., :n], wv[i, ..., :n],
                        a))
        ms = time_ms(lane_fn)
        loop_ms = time_ms(lambda: [single_fns[i]() for i in range(L)])
        pms = time_ms(plain_fn, reps=3, warm=1)
        bms, bby = bound_ms(fl, by)
        log(f"[batch] time {name:14s} lanes {ms:.4f} ms  loop of {L} single "
            f"launches {loop_ms:.4f} ms  plain {pms:.4f} ms  bound "
            f"{bms * 1e3:.1f} us ({bby})  share of bound {bms / ms:.3f}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": bby, "library_ms": None,
                     "loop_ms": loop_ms,
                     "shape": f"{L} lanes, n {min(lanes.ns)}-{max(lanes.ns)}"
                              f" (pad {n_pad}), B {B}, d {d}"})

    def x_of(i):
        return lanes.lane(i).contiguous()

    lane_row("build_g_lanes", "repro_torch/kernels/csrc/build_g.cu",
             "src/repro/kernels/build_g.py:42",
             lambda: ops.build_g_lanes_stats(lanes.data, y, dn, w, lg,
                                             rows=lanes.rows, metric="l2",
                                             run=run),
             [lambda i=i: ops.build_g_stats(x_of(i), y[i], dn[i], w[i], lg[i],
                                            metric="l2",
                                            run=run[i:i + 1])
              for i in range(L)],
             lambda: build_g.build_g_lanes_torch(lanes.data, y, dn, w, lg,
                                                 lanes.rows.cpu(), "l2"),
             lambda i: (lims[i], 2 * dmax * lims[i], 2 * dmax * lims[i]), 3,
             2.0 * nlive * B * d,
             4.0 * (nlive * d + len(live) * (B * d + 3 * B) + 3 * nlive))
    for k in (10, 65):
        d1, d2, a = ops.stream_top2_lanes(y, med[k], metric="l2")
        lead = lg
        lane_row(f"swap_g_lanes" if k == 10 else f"swap_g_lanes[k={k}]",
                 "repro_torch/kernels/csrc/swap_g.cu",
                 "src/repro/kernels/swap_g.py:85",
                 lambda: ops.swap_g_lanes_stats(lanes.data, y, d1, d2, a, w, k,
                                                lead, rows=lanes.rows,
                                                metric="l2", run=run),
                 [lambda i=i: ops.swap_g_stats(x_of(i), y[i], d1[i], d2[i],
                                               a[i], w[i], k, lead[i],
                                               metric="l2", run=run[i:i + 1])
                  for i in range(L)],
                 lambda: swap_g.swap_g_lanes_torch(lanes.data, y, d1, d2, a, w,
                                                   k, lead, lanes.rows.cpu(),
                                                   "l2"),
                 lambda i: (2 * lims[i], 4 * dmax * lims[i],
                            4 * dmax * lims[i]), 3,
                 2.0 * nlive * B * d,
                 4.0 * (nlive * d + len(live) * (B * d + 5 * B)
                        + 3 * k * nlive))
    tol = dist_tol("l2", dmax)
    lane_row("top2_lanes", "repro_torch/kernels/csrc/stream_g.cu",
             "src/repro/kernels/stream_g.py:165",
             lambda: ops.stream_top2_lanes(lanes.data, med[10],
                                           rows=lanes.rows, metric="l2"),
             [lambda i=i: ops.stream_top2(x_of(i), med[10][i], metric="l2")
              for i in range(L)],
             lambda: stream_g.top2_lanes_torch(lanes.data, med[10],
                                               lanes.rows.cpu(), "l2"),
             lambda i: (tol, tol), 3,
             2.0 * sum(lanes.ns) * 10 * d,
             4.0 * (sum(lanes.ns) * d + L * 10 * d + 3 * sum(lanes.ns)),
             names=("d1", "d2"))
    rows += pic_lane_kernel_checks(torch, lanes, y, w, lg, run, live, dmax,
                                   gen, dev)
    # The k = 65 SWAP row is printed; the kernels line keeps one row per
    # lane kernel.
    return [r for r in rows if "[" not in r["name"]]


def pic_lane_kernel_checks(torch, lanes, y, w, lg, run, live, dmax, gen,
                           dev):
    """Phase 8 (c), the PIC batch's lane kernels on (b)'s ring ``[L,
    n_pad, 33·B]``: ``pairwise_lanes`` writes each lane's fresh block at
    its column (slot 5, lane 1 in the scratch, lane 3 at flag 0), then
    ``swap_g_from_cache_lanes`` reads them back (k = 10), and the repair's
    shape (every lane's whole ring, about 5 % of the weights set); each
    running lane equal to the single launch on its block bit for bit, and
    within phase 3's tolerances of the plain lane version (the distance
    tolerance; the SWAP sums ``2·B·2^-24·Σ|t_j|``).  The ``d_near`` rows
    ([1 × n_l] a lane) are held and timed too.  Returns the two rows."""
    from repro_torch.kernels import ops, pairwise, swap_g
    L, n_pad, d = lanes.data.shape
    W = PIC_RING_ROUNDS
    store = torch.zeros((L, n_pad, (W + 1) * B), device=dev)
    # Every slot holds distances of its own batch, as a filled ring does.
    for r in range(W):
        refs = torch.stack([torch.randint(0, n, (B,), generator=gen)
                            for n in lanes.ns]).to(dev)
        ops.pairwise_lanes(lanes.data, lanes.gather(refs).contiguous(), "l2",
                           out=store, col=torch.full((L,), r * B,
                                                     dtype=torch.int64,
                                                     device=dev),
                           xrows=lanes.rows)
    col = torch.full((L,), (5 % W) * B, dtype=torch.int64, device=dev)
    col[1] = W * B
    cols = col.tolist()
    kept = store[3, :, cols[3]:cols[3] + B].clone()
    pw_kw = dict(out=store, col=col, xrows=lanes.rows, run=run)
    ops.pairwise_lanes(lanes.data, y, "l2", **pw_kw)

    def single_pw(i):
        n, c = lanes.ns[i], cols[i]
        return ops.pairwise_distance(lanes.lane(i), y[i], "l2",
                                     out=store[i, :n, c:c + B],
                                     run=run[i:i + 1])

    blocks = [store[i, :lanes.ns[i], cols[i]:cols[i] + B].clone()
              for i in range(L)]
    for i in live:
        require_equal(f"pairwise_lanes lane {i} (n={lanes.ns[i]}, col "
                      f"{cols[i]}) == single launch", (blocks[i],),
                      (ops.pairwise_distance(lanes.lane(i), y[i], "l2"),))
    require_equal("pairwise_lanes lane 3 at flag 0 keeps its slot",
                  (store[3, :, cols[3]:cols[3] + B],), (kept,))
    plain = pairwise.pairwise_lanes_plain(lanes.data, y, "l2",
                                          torch.zeros_like(store), col,
                                          lanes.rows, None, run)
    tol = dist_tol("l2", dmax)
    pw_err = max(check_close(f"pairwise_lanes[{i}]", blocks[i],
                             plain[i, :lanes.ns[i], cols[i]:cols[i] + B],
                             tol) for i in live)
    del plain
    nlive = sum(lanes.ns[i] for i in live)
    ms = time_ms(lambda: ops.pairwise_lanes(lanes.data, y, "l2", **pw_kw))
    loop_ms = time_ms(lambda: [single_pw(i) for i in range(L)])
    pms = time_ms(lambda: pairwise.pairwise_lanes_plain(
        lanes.data, y, "l2", None, None, lanes.rows, None, run), reps=3,
        warm=1)
    lms = time_ms(lambda: torch.cdist(lanes.data, y))
    bms, bby = bound_ms(2.0 * nlive * B * d,
                        4.0 * (nlive * d + len(live) * B * d + nlive * B))
    log(f"[batch] time pairwise_lanes  lanes {ms:.4f} ms  loop of {L} single "
        f"launches {loop_ms:.4f} ms  plain {pms:.4f} ms  batched torch.cdist "
        f"{lms:.4f} ms  bound {bms * 1e3:.1f} us ({bby})  share of bound "
        f"{bms / ms:.3f}")
    rows = [{"name": "pairwise_lanes", "route": "cuda",
             "source": "repro_torch/kernels/csrc/pairwise.cu",
             "replaces": "src/repro/kernels/pairwise.py:74", "launches": 0,
             "max_abs_err": pw_err, "ms": ms, "plain_ms": pms,
             "bound_ms": bms, "bound_by": bby, "library_ms": lms,
             "loop_ms": loop_ms,
             "shape": f"{L} lanes [n_l x {B}] into a ring slot, n "
                      f"{min(lanes.ns)}-{max(lanes.ns)} (pad {n_pad}), d {d}"}]
    # The d_near rows: each lane's pick against its own rows.
    picks = torch.stack([torch.randint(0, n, (1,), generator=gen)
                         for n in lanes.ns]).to(dev)
    xp = lanes.gather(picks).contiguous()
    dn = ops.pairwise_lanes(xp, lanes.data, "l2", yrows=lanes.rows)
    for i in range(L):
        require_equal(f"pairwise_lanes d_near row lane {i} == single launch",
                      (dn[i, 0, :lanes.ns[i]],),
                      (ops.pairwise_distance(xp[i], lanes.lane(i), "l2")[0],))
    dms = time_ms(lambda: ops.pairwise_lanes(xp, lanes.data, "l2",
                                             yrows=lanes.rows))
    dloop = time_ms(lambda: [ops.pairwise_distance(xp[i], lanes.lane(i),
                                                   "l2") for i in range(L)])
    log(f"[batch] time pairwise_lanes d_near rows [1 x n_l] x {L}: lanes "
        f"{dms:.4f} ms  loop of {L} single launches {dloop:.4f} ms")

    # swap_g_from_cache over the same blocks, then at the repair's shape.
    k = 10
    med = torch.stack([lanes.lane(i)[torch.randperm(n, generator=gen)[
        :k].to(dev)] for i, n in enumerate(lanes.ns)]).contiguous()
    d1, d2, a = ops.stream_top2_lanes(y, med, metric="l2")
    lead = lg.contiguous()

    def swap_case(name, b, c, vecs, run_, timed):
        d1_, d2_, a_, w_, lg_ = vecs
        kw = dict(col=c, rows=lanes.rows, run=run_)
        got = ops.swap_g_from_cache_lanes_stats(store, d1_, d2_, a_, w_, k,
                                                lg_, **kw)
        cs = [0] * L if c is None else c.tolist()

        def single(i):
            n = lanes.ns[i]
            return ops.swap_g_stats_cached(
                store[i, :n, cs[i]:cs[i] + b], d1_[i], d2_[i], a_[i], w_[i],
                k, lg_[i], run=None if run_ is None else run_[i:i + 1])

        on = [i for i in range(L) if run_ is None or int(run_[i])]
        for i in on:
            require_equal(f"swap_g_from_cache_lanes[{name}] lane {i} == "
                          f"single launch", tuple(g[i, :, :lanes.ns[i]]
                                                  for g in got), single(i))
        want = swap_g.swap_g_from_cache_lanes_torch(store, d1_, d2_, a_, w_,
                                                    k, lg_, c, lanes.rows)
        err = 0.0
        for i in on:
            n = lanes.ns[i]
            lim = swap_abs_sums(store[i, :n, cs[i]:cs[i] + b], d1_[i],
                                d2_[i], a_[i], w_[i], k, lg_[i])
            err = max([err] + [check_close(
                f"swap_g_from_cache_lanes[{name}][{i}] {nm}", g[i, :, :n],
                wv[i, :, :n], 2 * b * 2.0 ** -24 * at, rtol=0.0)
                for nm, g, wv, at in zip(("sums", "sq", "cross"), got, want,
                                         lim)])
        del want
        if not timed:
            return err
        ms = time_ms(lambda: ops.swap_g_from_cache_lanes_stats(
            store, d1_, d2_, a_, w_, k, lg_, **kw))
        loop_ms = time_ms(lambda: [single(i) for i in range(L)])
        pms = time_ms(lambda: swap_g.swap_g_from_cache_lanes_torch(
            store, d1_, d2_, a_, w_, k, lg_, c, lanes.rows), reps=3, warm=1)
        nb = sum(4.0 * (lanes.ns[i] * float((w_[i] != 0).sum()) + 5 * b
                        + 3 * k * lanes.ns[i]) for i in on)
        bms, bby = bound_ms(0.0, nb)
        log(f"[batch] time swap_g_from_cache_lanes[{name}]  lanes {ms:.4f} ms"
            f"  loop of {L} single launches {loop_ms:.4f} ms  plain "
            f"{pms:.4f} ms  library -  bound {bms * 1e3:.1f} us ({bby})  "
            f"share of bound {bms / ms:.3f}")
        return {"name": "swap_g_from_cache_lanes", "route": "cuda",
                "source": "repro_torch/kernels/csrc/swap_g_from_cache.cu",
                "replaces": "src/repro/kernels/swap_g.py:118", "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": bby, "library_ms": None,
                "loop_ms": loop_ms,
                "shape": f"{L} lanes [n_l x {b}] ring blocks, k {k}, n "
                         f"{min(lanes.ns)}-{max(lanes.ns)} (pad {n_pad})"}

    row = swap_case("round", B, col, (d1, d2, a, w, lead), run, True)
    # The repair: each lane's whole ring, its positions' medoid cache and
    # about 5 % of the weights set; lanes 2 and 6 carry nothing.
    pos = torch.stack([torch.randint(0, n, (W * B,), generator=gen)
                       for n in lanes.ns]).to(dev)
    rd1, rd2, ra = ops.stream_top2_lanes(lanes.gather(pos).contiguous(), med,
                                         metric="l2")
    rw = (torch.rand((L, W * B), generator=gen) < 0.05).float().to(dev)
    rrun = torch.ones((L,), dtype=torch.int32, device=dev)
    rrun[2] = rrun[6] = 0
    rep_err = swap_case("repair", W * B, None,
                        (rd1, rd2, ra, rw, torch.zeros_like(rw)), rrun, False)
    row["max_abs_err"] = max(row["max_abs_err"], rep_err)
    del store
    torch.cuda.empty_cache()
    return rows + [row]


def batch_parity(torch, dev):
    """Phase 8 (d): ``backend="cuda"`` against ``"torch"`` ``fit_batch``
    on 4 ragged ``code_blobs`` lanes, each backend's batch equal to its
    own loop of single fits exactly.  The two backends must agree on
    medoids, swaps and build rounds; the ledger without the leader within
    phase 4's ``code_blobs`` allowance, 10·B (the kernels and the plain
    versions round batch sums differently, which can move a kill on an
    exact margin by a round), and with ``default_params`` (the leader)
    within 0.1 % (the allowance of the card tests' cuda-against-torch
    fits: the leader's cross sums are added in different orders too, and
    on blobs whose duplicate rows tie with the leader that moves
    differenced kills)."""
    from repro_torch.api import KMedoids
    from repro_torch.api.registry import default_params
    from repro_torch.core import datasets
    ns = (3000, 4096, 2500, 3701)
    Xs = [datasets.code_blobs(n, 10, seed=i) for i, n in enumerate(ns)]
    seeds = [0, 1, 2, 3]
    for label, params in (("leader", default_params("banditpam")),
                          ("no leader", {})):
        reps = {}
        for be in ("cuda", "torch"):
            t0 = time.perf_counter()
            reps[be] = KMedoids(10, metric="l2", seed=0, backend=be,
                                **params).fit_batch(Xs, seeds=seeds)
            for i, (X, s) in enumerate(zip(Xs, seeds)):
                one = KMedoids(10, metric="l2", seed=s, backend=be,
                               **params).fit(X).report_
                same_report(reps[be][i], one, f"code_blobs ({label}) lane "
                            f"{i}, {be} batch vs its single fit")
            log(f"[batch] (d) {label} backend={be:5s} medoids "
                f"{[r.medoids.tolist() for r in reps[be]]} build rounds "
                f"{[r.build_rounds for r in reps[be]]} swaps "
                f"{[r.n_swaps for r in reps[be]]} evals "
                f"{[r.evals_by_phase for r in reps[be]]} "
                f"({time.perf_counter() - t0:.2f} s with the loop)")
        for i in range(len(ns)):
            a, b = reps["cuda"][i], reps["torch"][i]
            same_fit(a, b, f"(d) fit_batch {label} lane {i} on code_blobs",
                     0 if params else 10 * B,
                     ledger_rtol=1e-3 if params else 0.0)


def batch_paths(torch, dev):
    """Phase 8: (a) and (b), then (c) and (d); returns the lane kernels'
    rows with their launches from (b)."""
    from repro_torch.core.datasets import mnist_like
    t0 = time.perf_counter()
    small = [mnist_like(BATCH_N, seed=i) for i in range(BATCH_FITS)]
    ragged = [mnist_like(n, seed=100 + i) for i, n in enumerate(RAGGED_N)]
    log(f"[batch] data made in {time.perf_counter() - t0:.1f} s")
    for solver, kernels in (("banditpam", LANE_KERNELS),
                            ("banditpam_pp", PIC_LANE_KERNELS)):
        counts, _ = batch_vs_loop(torch, f"(a) {solver} {BATCH_FITS} x "
                                  f"mnist_like({BATCH_N}), k={BATCH_K}",
                                  solver, small, list(range(BATCH_FITS)),
                                  BATCH_K)
        if min(counts[nm] for nm in kernels) < 1:
            raise AssertionError(f"a lane kernel never ran in (a) {solver}: "
                                 f"{counts}")
    counts = {}
    for solver, kernels in (("banditpam", LANE_KERNELS),
                            ("banditpam_pp", PIC_LANE_KERNELS)):
        counts[solver], _ = batch_vs_loop(
            torch, f"(b) {solver} ragged n={RAGGED_N}, k={RAGGED_K}", solver,
            ragged, list(range(len(RAGGED_N))), RAGGED_K)
        if min(counts[solver][nm] for nm in kernels) < 1:
            raise AssertionError(f"a lane kernel never ran in (b) {solver}: "
                                 f"{counts[solver]}")
    rows = lane_kernel_checks(torch, ragged, dev)
    # Each row's launches come from (b)'s batch that runs it: the PIC
    # kernels from banditpam_pp's, the others from banditpam's.
    for row in rows:
        solver = ("banditpam_pp" if row["name"] in PIC_LANE_KERNELS[:2]
                  else "banditpam")
        row["launches"] = counts[solver][row["name"]]
    batch_parity(torch, dev)
    return rows


# Phase 9: the sharded fit (ROADMAP A13).  NCCL takes one rank a device,
# so the card runs world size 1 on nccl at the main path's size, and two
# gloo ranks on the one card on the first DIST_ROWS rows.
DIST_ROWS = 8000
DIST_B = 128                # the sharded fit's default batch (b_loc at S=1)
DIST_KERNELS = ("pairwise", "swap_g_from_cache", "top2")
DIST_TIMEOUT = 600          # s: each process group's collectives, the ranks
DIST_MAX_BUILD_READS = 300  # (a): the resident BUILD's reads stay below
# Rows of the profiled resident fit: a round's host work does not depend on
# n, and a third of the main path's rows reads its trace in a third of the
# time.
DIST_PROFILE_ROWS = 20000


def _dist_world1():
    """A one-rank nccl group on the card: the default group of this
    process, with a timeout; one all-reduce starts its communicator, so
    that no fit's wall holds the start."""
    import datetime
    import socket
    import torch.distributed as dist
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    import torch
    dist.all_reduce(torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()
    log(f"[dist] nccl group: world size {dist.get_world_size()}, backend "
        f"{dist.get_backend()}")


def dist_fits(torch, X, dev, Xnp, pam_fit):
    """Phase 9 (a): ``KMedoids(k=10, solver="banditpam_dist",
    metric="l2").fit`` on the main path's 60,000 rows at world size 1 on
    nccl, then the same fit with ``reuse="pic"`` (the default ring), each
    on the device-resident loop (the default, the main path) and then
    with ``fused=False``, each with the launch and all-reduce counts set
    to 0 just before it: wall, host reads and all-reduces by phase,
    ledger, fallbacks, peak memory and launches (pairwise,
    swap_g_from_cache and top2 must run in the resident fit); the two
    reports identical, the resident fit's reads fewer in each phase and
    under ``DIST_MAX_BUILD_READS`` in BUILD, its BUILD all-reduces within
    one a round run and ``ROUNDS_PER_READ − 1`` more a search, the
    stepped fit's one a round run; the loss against a plain
    ``total_loss`` (all raising), and whether its medoids equal PAM's
    (measured, not asserted).  Returns each resident fit's counts."""
    from repro_torch.api import KMedoids
    from repro_torch.core import adaptive, distributed, total_loss
    from repro_torch.kernels import ops
    per = adaptive.ROUNDS_PER_READ
    counts, reports = {}, {}
    for name, kw in (("none", {}), ("pic", {"reuse": "pic"})):
        fits = {}
        for loop, fused in (("resident", True), ("stepped", False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            distributed.reset_allreduce_counts()
            t0 = time.perf_counter()
            est = KMedoids(k=10, solver="banditpam_dist", metric="l2",
                           seed=0, fused=fused, **kw).fit(Xnp[:N_FIT])
            fit_s = time.perf_counter() - t0
            c = ops.launch_counts()
            ar = distributed.allreduce_counts()
            r = est.report_
            fits[loop] = (r, ar)
            what = f"(a) {name} {loop}"
            log(f"[dist] {what}: medoids {r.medoids.tolist()} loss "
                f"{r.loss!r} n_swaps {r.n_swaps} converged {r.converged} "
                f"swap_exact_fallbacks {r.swap_exact_fallbacks}")
            log(f"[dist] {what}: evals_by_phase {r.evals_by_phase} fresh "
                f"{r.distance_evals} cached {r.cached_evals} build_rounds "
                f"{r.build_rounds}")
            log(f"[dist] {what}: wall_by_phase {r.wall_by_phase} fit "
                f"{fit_s:.3f} s (data upload included); host_reads_by_phase "
                f"{r.host_reads_by_phase}; allreduces_by_phase {ar}")
            log(f"[dist] {what}: kernel launches {c}; peak device memory "
                f"{torch.cuda.max_memory_allocated()} bytes")
            rounds = sum(r.build_rounds)
            if fused:
                counts[name] = c
                if min(c[nm] for nm in DIST_KERNELS) < 1:
                    raise AssertionError(f"a kernel of the sharded fit "
                                         f"never ran: {c}")
                if not (rounds <= ar.get("build", 0)
                        <= rounds + (per - 1) * 10):
                    raise AssertionError(f"all-reduces {ar} outside one a "
                                         f"BUILD round run and {per - 1} "
                                         f"more a search")
                if r.host_reads_by_phase["build"] >= DIST_MAX_BUILD_READS:
                    raise AssertionError(f"resident BUILD read "
                                         f"{r.host_reads_by_phase} times")
            elif ar.get("build", 0) != rounds:
                raise AssertionError(f"all-reduces {ar} != one a BUILD "
                                     f"round")
        (r, ar), (rs, ars) = fits["resident"], fits["stepped"]
        reports[name] = r
        same_report(r, rs, f"(a) sharded {name}: resident vs stepped")
        log(f"[dist] (a) {name}: resident / stepped: wall build "
            f"{r.wall_by_phase['build']:.3f} / {rs.wall_by_phase['build']:.3f}"
            f" s, swap {r.wall_by_phase['swap']:.3f} / "
            f"{rs.wall_by_phase['swap']:.3f} s; host reads "
            f"{r.host_reads_by_phase} / {rs.host_reads_by_phase}; "
            f"all-reduces {ar} / {ars}")
        if any(r.host_reads_by_phase[ph] >= rs.host_reads_by_phase[ph]
               for ph in ("build", "swap")):
            raise AssertionError(f"(a) {name}: the resident fit reads as "
                                 f"often as the stepped one")
        if len(set(r.medoids.tolist())) != 10:
            raise AssertionError("bad sharded-fit medoids")
        data = X[:N_FIT].contiguous()
        med_t = torch.as_tensor(r.medoids, device=dev)
        plain = float(total_loss(data, med_t, metric="l2", backend="torch"))
        if not abs(plain - r.loss) <= 1e-5 * abs(plain):
            raise AssertionError(f"sharded loss {r.loss} != plain {plain}")
        log(f"[claim] sharded BanditPAM ({name}) medoids == PAM's: "
            f"{sorted(r.medoids.tolist()) == sorted(pam_fit.medoids.tolist())}"
            f"; loss / PAM loss {r.loss / pam_fit.loss!r}")
    return counts, reports


def dist_kernel_times(torch, X, dev):
    """Phase 9, the kernels at the sharded round's shapes at world size 1
    (B = 128, l2, k = 10): ``pairwise`` at [60,000 x 128] and
    ``swap_g_from_cache`` over that block with a leader row and weight-0
    slots, each held to its plain version with phase 3's tolerances
    (raising) and timed beside it, the library call where there is one,
    and its bound."""
    from repro_torch.kernels import ops, pairwise, swap_g
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = X[:N_FIT].contiguous()
    n, d, k, b = x.shape[0], x.shape[1], 10, DIST_B
    y = x[torch.randint(0, n, (b,), generator=gen).to(dev)].contiguous()
    got = ops.pairwise_distance(x, y, "l2")
    want = pairwise.pairwise_torch(x, y, metric="l2")
    err = check_close(f"pairwise[{n}x{b}]", got, want,
                      dist_tol("l2", float(want.max())))
    ms = time_ms(lambda: ops.pairwise_distance(x, y, "l2"))
    pms = time_ms(lambda: pairwise.pairwise_torch(x, y, metric="l2"))
    lms = time_ms(lambda: torch.cdist(x, y))
    bms, bby = bound_ms(2.0 * n * b * d, 4.0 * (n * d + b * d + n * b))
    log(f"[dist] pairwise [{n} x {b}] (a sharded round's block): kernel "
        f"{ms:.4f} ms  plain {pms:.4f} ms  torch.cdist {lms:.4f} ms  bound "
        f"{bms:.4f} ms ({bby})  max_abs_err {err:.3e}")
    med = x[torch.randperm(n, generator=gen)[:k].to(dev)].contiguous()
    d1, d2, a = ops.stream_top2(y, med, metric="l2")
    w = torch.ones(b, device=dev)
    w[-5:] = 0.0
    lg = (torch.randn(b, generator=gen) * 3).to(dev)
    dxy = got
    got = ops.swap_g_stats_cached(dxy, d1, d2, a, w, k, lg)
    want = swap_g.swap_g_from_cache_torch(dxy, d1, d2, a, w, k, lg)
    lim = swap_abs_sums(dxy, d1, d2, a, w, k, lg)
    err = max(check_close(f"swap_g_from_cache[{n}x{b}] {nm}", g, wv,
                          2 * b * 2.0 ** -24 * li, rtol=0.0)
              for nm, g, wv, li in zip(("sums", "sq", "cross"), got, want,
                                       lim))
    ms = time_ms(lambda: ops.swap_g_stats_cached(dxy, d1, d2, a, w, k, lg))
    pms = time_ms(lambda: swap_g.swap_g_from_cache_torch(dxy, d1, d2, a, w,
                                                         k, lg), reps=5)
    cols = float((w != 0).sum())
    bms, bby = bound_ms(0.0, 4.0 * (n * cols + 5 * b + 3 * k * n))
    log(f"[dist] swap_g_from_cache [{n} x {b}] (a sharded SWAP round, "
        f"k={k}): kernel {ms:.4f} ms  plain {pms:.4f} ms  library -  bound "
        f"{bms:.4f} ms ({bby})  max_abs_err {err:.3e}")
    del dxy, got, want
    torch.cuda.empty_cache()


def dist_parity(torch, dev):
    """Phase 9 (b): ``backend="cuda"`` against ``"torch"`` at world size 1
    on ``N_PARITY`` integer points in 10 blobs (``code_blobs``), both
    reuse modes: medoids, swaps, build rounds and fallbacks equal, the
    ledger within 0.1 % (the leader's allowance, ROADMAP §C: the sharded
    fit always runs the leader).  Raising."""
    from repro_torch.api import KMedoids
    from repro_torch.core import datasets
    Xb = datasets.code_blobs(N_PARITY, 10, seed=0)
    for name, kw in (("none", {}), ("pic", {"reuse": "pic"})):
        fits = {}
        for be in ("cuda", "torch"):
            t0 = time.perf_counter()
            fits[be] = KMedoids(10, solver="banditpam_dist", metric="l2",
                                seed=0, backend=be, **kw).fit(Xb).report_
            log(f"[dist] (b) {name} backend={be:5s} medoids "
                f"{fits[be].medoids.tolist()} swaps {fits[be].n_swaps} "
                f"evals {fits[be].evals_by_phase} "
                f"({time.perf_counter() - t0:.2f} s)")
        same_fit(fits["cuda"], fits["torch"], f"(b) sharded {name} on "
                 f"code_blobs", 0, ledger_rtol=1e-3)


def dist_ranks(torch, Xnp):
    """Phase 9 (c): two gloo ranks spawned on the one card (one set of
    processes), ``reuse="none"`` and ``"pic"``, ``backend="cuda"`` and
    ``"torch"``, on the first ``DIST_ROWS`` rows and on (b)'s
    ``code_blobs``: every rank's report identical (the loss bits
    included), and each cuda fit against the two-rank torch fit:
    medoids, swaps, build rounds, fallbacks and the loss (rtol 1e-5)
    equal, the ledger within (b)'s 0.1 % on ``code_blobs`` and logged
    only on the real-valued rows.  (There the kernels' and cuBLAS's last
    bits move kills, and a SWAP exact fallback pays n per surviving
    candidate: on an H100 the two-rank SWAP ledgers at 8,000 rows were
    71,272,192 against 70,612,928.)  Raising."""
    from repro_torch.core import datasets, distributed
    sets = {f"{DIST_ROWS} rows": Xnp[:DIST_ROWS],
            "code_blobs": datasets.code_blobs(N_PARITY, 10, seed=0)}
    cases, names = [], []
    for data, X in sets.items():
        for name, kw in (("none", {}), ("pic", {"reuse": "pic"})):
            for be in ("cuda", "torch"):
                cases.append((X, 10, dict(kw, backend=be)))
                names.append((data, name, be))
    t0 = time.perf_counter()
    out = distributed.spawn_fits(cases, 2, device="cuda",
                                 timeout=DIST_TIMEOUT)
    log(f"[dist] (c) 2 gloo ranks, {len(cases)} fits: "
        f"{time.perf_counter() - t0:.1f} s (spawn and the kernels' load "
        f"included)")
    reps = {}
    for (data, name, be), ranks in zip(names, out):
        what = f"(c) {data} {name} {be}"
        for i, rf in enumerate(ranks):
            same_report(rf.report, ranks[0].report, f"{what} rank {i} vs "
                        f"rank 0")
            if rf.allreduces != ranks[0].allreduces:
                raise AssertionError(f"{what}: the ranks' all-reduces differ")
        r = reps[data, name, be] = ranks[0].report
        log(f"[dist] {what}: medoids {r.medoids.tolist()} loss {r.loss!r} "
            f"swaps {r.n_swaps} fallbacks {r.swap_exact_fallbacks} evals "
            f"{r.evals_by_phase} wall_by_phase {r.wall_by_phase} "
            f"host_reads_by_phase {r.host_reads_by_phase} "
            f"allreduces_by_phase {ranks[0].allreduces}")
    for data in sets:
        for name in ("none", "pic"):
            same_fit(reps[data, name, "cuda"], reps[data, name, "torch"],
                     f"(c) 2 ranks {name} on {data}", 0, ledger_rtol=1e-3,
                     ledger=data == "code_blobs")


def dist_paths(torch, X, dev, Xnp, pam_fit):
    """Phase 9: (a), one ``torch.profiler`` run of its resident
    ``reuse="none"`` fit on the first ``DIST_PROFILE_ROWS`` rows
    (``profile_fit``: busy and idle share, device time by kernel, host
    time by operator), the kernels at (a)'s shapes and
    (b) on one nccl rank (the group destroyed at the phase's end, raising
    or not); (c), on two spawned gloo ranks, runs beside phase 11
    (``PARTS``).  Returns (a)'s launch counts and its resident reports by
    reuse mode."""
    import torch.distributed as dist
    _dist_world1()
    try:
        counts, reports = dist_fits(torch, X, dev, Xnp, pam_fit)
        profile_fit(torch, X[:DIST_PROFILE_ROWS].contiguous(), True,
                    "sharded resident", None, solver="banditpam_dist")
        dist_kernel_times(torch, X, dev)
        dist_parity(torch, dev)
    finally:
        dist.destroy_process_group()
    return counts, reports


# Phase 10: the tile tuner (repro_torch/core/tuning.py, ROADMAP A14): every
# kernel's compiled shapes, held to the default shape's bits, timed, and the
# fits under several configs.
TILE_KERNELS = ("pairwise", "build_g", "swap_g", "stream_build_g",
                "stream_swap_g", "top2", "swap_g_from_cache")
TILE_LANES = (3000, 2345, 1111, 17)     # a ragged lane set, lane 3 masked
TILE_RANK_ROWS = 8000                   # phase 9 (c)'s rank: every arm, 8,000 rows


def _bits(t):
    """A tensor's bits (NaNs compare equal to themselves)."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(name, got, want):
    require_equal(name, tuple(_bits(g) for g in got),
                  tuple(_bits(w) for w in want))


def _must_raise(name, fn):
    """Raise unless ``fn`` raises: a shape index the library lacks."""
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        log(f"[tiles] {name}: raises ({str(e).splitlines()[0]})")
        return
    raise AssertionError(f"{name}: an unknown shape index did not raise")


def _nan_outs(torch, dev, *shapes):
    return [torch.full(sh, float("nan"), device=dev) for sh in shapes]


def tile_bits(torch, X, dev):
    """Phase 10 (a): every compiled shape of every kernel gives the
    default shape's bits (the shape the unchanged ``rt_*`` entries take)
    at the main path's shapes (60,000 x 784, B = 100, k = 10, l2; the
    SWAP kernels at k = 65 too, swap_g at B = 300, top2 at k = 65 and
    predict's [10,000 x 10]) and at row 1e's [60,000 x 128] for
    pairwise; with the run flag at 1 (equal bits) and at 0 (outputs,
    NaN-filled, untouched); the lane forms on a ragged lane set with one
    lane masked; and an index the library lacks raises for every
    kernel.  Raising."""
    from repro_torch.core import tuning
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import build_g, pairwise, stream_g, swap_g
    gen = torch.Generator(device="cpu").manual_seed(10)
    flag = {v: torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (0, 1)}
    lib, p = kbuild.lib(), (lambda t: t.data_ptr())
    st = torch.cuda.current_stream(dev).cuda_stream
    x = X[:N_FIT].contiguous()
    n, d = x.shape

    def pick(m):
        return x[torch.randperm(n, generator=gen)[:m].to(dev)].contiguous()

    def shapes(kernel):
        return range(len(tuning.KERNEL_SHAPES[kernel]))

    checked = [0]

    def each(name, kernel, default, call):
        want = call(default)
        for s in shapes(kernel):
            if s != default:
                _same_bits(f"{name} shape {s} == {default}", call(s), want)
                checked[0] += 1
        return want

    def untouched(name, outs):
        if not all(bool(torch.isnan(o).all()) for o in outs):
            raise AssertionError(f"{name}: a masked launch wrote")

    # pairwise: the PIC round, row 1e's block, predict, a d_near row.
    y100, y128, med10, med65 = pick(B), pick(DIST_B), pick(10), pick(65)
    q = X[N_FIT:N_FIT + N_QUERY].contiguous()
    for a, b, nm in ((x, y100, "PIC round"), (x, y128, "row 1e"),
                     (q, med10, "predict"), (x[:1], x, "d_near row")):
        default = tuning.pairwise_index(128, 104, a.shape[0], b.shape[0])
        each(f"pairwise [{a.shape[0]} x {b.shape[0]}] ({nm})", "pairwise",
             default, lambda s: (pairwise.launch(a, b, "l2", shape=s),))
    want = pairwise.launch(x, y100, "l2", shape=2)
    for s in shapes("pairwise"):
        ring = torch.full((n, 3 * B), float("nan"), device=dev)
        pairwise.launch(x, y100, "l2", ring[:, B:2 * B], flag[1], shape=s)
        _same_bits(f"pairwise shape {s} flag 1 into a ring slot",
                   (ring[:, B:2 * B],), (want,))
        ring.fill_(float("nan"))
        pairwise.launch(x, y100, "l2", ring[:, B:2 * B], flag[0], shape=s)
        untouched(f"pairwise shape {s} flag 0", (ring,))
    L, n_pad = len(TILE_LANES), TILE_LANES[0]
    xl = torch.stack([pick(n_pad) for _ in range(L)])
    yl = torch.stack([pick(B) for _ in range(L)])
    rows = torch.tensor(TILE_LANES, dtype=torch.int32, device=dev)
    runl = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    yrows = torch.tensor([B, B, 63, B], dtype=torch.int32, device=dev)
    col = torch.tensor([0, B, 37, 2 * B], dtype=torch.int64, device=dev)

    def pw_lanes(s):
        out = torch.full((L, n_pad, 4 * B), float("nan"), device=dev)
        return (pairwise.launch_lanes(xl, yl, "l2", out, col, rows, yrows,
                                      runl, shape=s),)
    each("pairwise_lanes (ragged, lane 3 masked)", "pairwise", 2, pw_lanes)

    # build_g, its lane form and stream_build_g.
    dn = pairwise.pairwise_torch(y100, med10, metric="l2").min(dim=1).values
    dn[:5] = float("inf")
    w = torch.ones(B, device=dev)
    w[-7:] = 0.0
    lg = (torch.randn(B, generator=gen) * 3).to(dev)
    for run in (None, flag[1]):
        each(f"build_g [{n} x {B}] flag {None if run is None else 1}",
             "build_g", 0, lambda s: build_g.launch(x, y100, dn, w, lg, "l2",
                                                    run, shape=s))
    for s in shapes("build_g"):
        outs = _nan_outs(torch, dev, (n,), (n,), (n,))
        kbuild.check(lib.rt_build_g_tiled(
            p(x), p(y100), p(dn), p(w), p(lg), *map(p, outs), n, B, d, 0,
            p(flag[0]), s, st), "build_g")
        torch.cuda.synchronize()
        untouched(f"build_g shape {s} flag 0", outs)
    dnl = dn.expand(L, B).contiguous()
    wl, lgl = w.expand(L, B).contiguous(), lg.expand(L, B).contiguous()

    def ragged(outs):
        # The running lanes' rows only: the rest are unwritten.
        return tuple(o[..., i, :int(r)] if o.dim() == 2
                     else o[i, ..., :int(r)]
                     for o in outs for i, r in enumerate(TILE_LANES[:3]))
    each("build_g_lanes (ragged, lane 3 masked)", "build_g", 0,
         lambda s: ragged(build_g.launch_lanes(xl, yl, dnl, wl, lgl, rows,
                                               "l2", runl, shape=s)))
    for run in (None, flag[1]):
        each(f"stream_build_g [{n} x {n}] flag "
             f"{None if run is None else 1}", "stream_build_g", 0,
             lambda s: stream_g.launch_stream_build(
                 x, x, torch.full((n,), float("inf"), device=dev),
                 torch.ones(n, device=dev), torch.zeros(n, device=dev), "l2",
                 run, shape=s))
    ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    for s in shapes("stream_build_g"):
        outs = _nan_outs(torch, dev, (n,), (n,), (n,))
        kbuild.check(lib.rt_stream_build_g_tiled(
            p(x), p(x), p(ones), p(ones), p(zeros), *map(p, outs), n, n, d,
            0, p(flag[0]), s, st), "stream_build_g")
        torch.cuda.synchronize()
        untouched(f"stream_build_g shape {s} flag 0", outs)

    # swap_g (B = 100 at k = 10 and 65, B = 300), its lane form,
    # stream_swap_g.
    for k, b in ((10, B), (65, B), (10, 3 * B)):
        y = y100 if b == B else pick(b)
        med = med10 if k == 10 else med65
        d1, d2, a = stream_g.launch_top2(y, med, "l2",
                                         shape=tuning.top2_index(
                                             tuning.top2_tile(k)))
        wb = torch.ones(b, device=dev)
        wb[-5:] = 0.0
        lgb = (torch.randn(b, generator=gen) * 3).to(dev)
        for run in (None, flag[1]):
            each(f"swap_g [{n} x {b}] k={k} flag "
                 f"{None if run is None else 1}", "swap_g", 0,
                 lambda s: swap_g.launch(x, y, d1, d2, a, wb, k, lgb, "l2",
                                         run, shape=s))
        for s in shapes("swap_g"):
            outs = _nan_outs(torch, dev, *[(k, n)] * 3)
            sc, fl = swap_g.bin_scratch(dev, n, b, k, b, "l2", 1, s)
            kbuild.check(lib.rt_swap_g_tiled(
                p(x), p(y), p(d1), p(d2), p(a), p(wb), p(lgb),
                *map(p, outs), n, b, d, k, 0, p(flag[0]),
                None if sc is None else p(sc), fl, s, st), "swap_g")
            torch.cuda.synchronize()
            untouched(f"swap_g shape {s} k={k} B={b} flag 0", outs)
    d1, d2, a = stream_g.launch_top2(yl.reshape(L * B, d), med10, "l2",
                                     shape=0)
    d1l, d2l, al = (v.view(L, B) for v in (d1, d2, a))
    each("swap_g_lanes (ragged, lane 3 masked) k=10", "swap_g", 0,
         lambda s: ragged(swap_g.launch_lanes(xl, yl, d1l, d2l, al, wl, 10,
                                              lgl, rows, "l2", runl,
                                              shape=s)))
    d1, d2, a = stream_g.launch_top2(x, med10, "l2", shape=0)
    for run in (None, flag[1]):
        each(f"stream_swap_g [{n} x {n}] k=10 flag "
             f"{None if run is None else 1}", "stream_swap_g", 0,
             lambda s: stream_g.launch_stream_swap(x, x, d1, d2, a, ones, 10,
                                                   zeros, "l2", run,
                                                   shape=s))
    for s in shapes("stream_swap_g"):
        outs = _nan_outs(torch, dev, *[(10, n)] * 3)
        sc, fl = swap_g.bin_scratch(dev, n, n, 10, tuning.REF_TILE, "l2", 1,
                                    s)
        kbuild.check(lib.rt_stream_swap_g_tiled(
            p(x), p(x), p(d1), p(d2), p(a), p(ones), p(zeros),
            *map(p, outs), n, n, d, 10, 0, p(flag[0]), p(sc), fl, s, st),
            "stream_swap_g")
        torch.cuda.synchronize()
        untouched(f"stream_swap_g shape {s} flag 0", outs)

    # top2 (no run flag) and its lane form.
    for xx, med in ((x, med10), (x, med65), (q, med10)):
        each(f"top2 [{xx.shape[0]} x {med.shape[0]}]", "top2",
             tuning.top2_index(tuning.top2_tile(med.shape[0])),
             lambda s: stream_g.launch_top2(xx, med, "l2", shape=s))
    medl = torch.stack([pick(10) for _ in range(L)])
    each("top2_lanes (ragged)", "top2", 0,
         lambda s: ragged(stream_g.launch_top2_lanes(xl, medl, rows, "l2",
                                                     shape=s)))

    # swap_g_from_cache: its one shape, the entries the rt_* ones call.
    dxy = pairwise.launch(x, y100, "l2", shape=2)
    d1, d2, a = stream_g.launch_top2(y100, med10, "l2", shape=0)
    got = swap_g.launch_cached(dxy, d1, d2, a, w, 10, lg, None, shape=0)
    outs = _nan_outs(torch, dev, *[(10, n)] * 3)
    kbuild.check(lib.rt_swap_g_from_cache(
        p(dxy), B, p(d1), p(d2), p(a), p(w), p(lg), *map(p, outs), n, B, 10,
        None, st), "swap_g_from_cache")
    _same_bits("swap_g_from_cache shape 0 == rt_swap_g_from_cache", got,
               tuple(outs))
    # Unknown indices raise, in every kernel's entry (and its lane form).
    for kernel in TILE_KERNELS:
        bad = len(tuning.KERNEL_SHAPES[kernel])
        calls = {
            "pairwise": lambda: pairwise.launch(x, y100, "l2", shape=bad),
            "build_g": lambda: build_g.launch(x, y100, dn, w, lg, "l2",
                                              shape=bad),
            "swap_g": lambda: swap_g.launch(x, y100, d1, d2, a, w, 10, lg,
                                            "l2", shape=bad),
            "stream_build_g": lambda: stream_g.launch_stream_build(
                x[:B], y100, dn, w, lg, "l2", shape=bad),
            "stream_swap_g": lambda: stream_g.launch_stream_swap(
                x[:B], y100, d1, d2, a, w, 10, lg, "l2", shape=bad),
            "top2": lambda: stream_g.launch_top2(x, med10, "l2", shape=bad),
            "swap_g_from_cache": lambda: swap_g.launch_cached(
                dxy, d1, d2, a, w, 10, lg, shape=bad)}
        _must_raise(f"{kernel} shape {bad}", calls[kernel])
    _must_raise("build_g_lanes shape 3", lambda: build_g.launch_lanes(
        xl, yl, dnl, wl, lgl, rows, "l2", runl, shape=3))
    log(f"[tiles] (a) {checked[0]} candidate launches held to the default "
        f"shape's bits; every unknown index raised")


def tile_times(torch, X, dev, card):
    """Phase 10 (b): each compiled shape of each kernel timed at the main
    path's shapes beside its bound (CUDA events; the card's name and
    power limit printed beside), ``pairwise`` also at row 1e's
    [60,000 x 128] and at phase 9 (c)'s rank, [8,000 x 64]; the
    per-tile table the wave model reads (``tuning.TILE_US``: build_g and
    each wide pairwise shape over one block an SM and over one full wave,
    top2's one column tile over 60,000 rows), printed as JSON; the
    config the heuristic picks and the fastest one measured."""
    from repro_torch.core import tuning
    from repro_torch.kernels import build_g, pairwise, stream_g, swap_g
    gen = torch.Generator(device="cpu").manual_seed(11)
    x = X[:N_FIT].contiguous()
    n, d = x.shape
    sms = tuning.sm_count()

    def pick(m):
        return x[torch.randperm(n, generator=gen)[:m].to(dev)].contiguous()

    y100, y128, y64, med10 = pick(B), pick(DIST_B), pick(64), pick(10)
    dn = pairwise.pairwise_torch(y100, med10, metric="l2").min(dim=1).values
    w = torch.ones(B, device=dev)
    lg = torch.zeros(B, device=dev)
    d1, d2, a = stream_g.launch_top2(y100, med10, "l2", shape=0)
    log(f"[tiles] (b) {card}; {sms} SMs; times in ms, CUDA events")

    def row(kernel, what, s, ms, flops, nbytes):
        bms, bby = bound_ms(flops, nbytes)
        bm, bn = tuning.KERNEL_SHAPES[kernel][s]
        per = tuning.blocks_per_sm(kernel, s, 10)
        log(f"[tiles] {kernel} {what} shape {s} ({bm} x {bn}, {per} blocks "
            f"an SM): {ms:.4f} ms  bound {bms:.4f} ms ({bby})")
        return ms

    best = {}
    for m, yy, what in ((n, y100, "PIC round"), (n, y128, "row 1e"),
                        (TILE_RANK_ROWS, y64, "8,000-row rank")):
        a_ = x[:m]
        r = yy.shape[0]
        ts = {s: row("pairwise", f"[{m} x {r}] ({what})", s,
                     time_ms(lambda: pairwise.launch(a_, yy, "l2", shape=s)),
                     2.0 * m * r * d, 4.0 * (m * d + r * d + m * r))
              for s in range(2, len(tuning.PAIRWISE_SHAPES))}
        best[f"pairwise {m} x {r}"] = min(ts, key=ts.get)
    for m in (n, TILE_RANK_ROWS):
        a_ = x[:m]
        ts = {s: row("build_g", f"[{m} x {B}]", s,
                     time_ms(lambda: build_g.launch(a_, y100, dn, w, lg, "l2",
                                                    shape=s)),
                     2.0 * m * B * d, 4.0 * (m * d + B * d + 3 * m))
              for s in range(3)}
        best[f"build_g {m}"] = min(ts, key=ts.get)
        ts = {s: row("swap_g", f"[{m} x {B}] k=10", s,
                     time_ms(lambda: swap_g.launch(a_, y100, d1, d2, a, w, 10,
                                                   lg, "l2", shape=s)),
                     2.0 * m * B * d, 4.0 * (m * d + B * d + 30 * m))
              for s in range(3)}
        best[f"swap_g {m}"] = min(ts, key=ts.get)
    ts = {s: row("top2", f"[{n} x 10]", s,
                 time_ms(lambda: stream_g.launch_top2(x, med10, "l2",
                                                      shape=s)),
                 2.0 * n * 10 * d, 4.0 * (n * d + 10 * d + 3 * n))
          for s in range(4)}
    best["top2 k=10"] = min(ts, key=ts.get)
    ones, zeros, inf = (torch.ones(n, device=dev), torch.zeros(n, device=dev),
                        torch.full((n,), float("inf"), device=dev))
    for s in range(3):
        row("stream_build_g", f"[{n} x {n}]", s, time_ms(
            lambda: stream_g.launch_stream_build(x, x, inf, ones, zeros, "l2",
                                                 shape=s), reps=2, warm=1),
            2.0 * n * n * d, 4.0 * (2 * n * d + 6 * n))
    dd1, dd2, aa = stream_g.launch_top2(x, med10, "l2", shape=0)
    for s in range(3):
        row("stream_swap_g", f"[{n} x {n}] k=10", s, time_ms(
            lambda: stream_g.launch_stream_swap(x, x, dd1, dd2, aa, ones, 10,
                                                zeros, "l2", shape=s),
            reps=2, warm=1),
            2.0 * n * n * d, 4.0 * (2 * n * d + 35 * n))
    dxy = pairwise.launch(x, y100, "l2", shape=2)
    row("swap_g_from_cache", f"[{n} x {B}] k=10", 0, time_ms(
        lambda: swap_g.launch_cached(dxy, d1, d2, a, w, 10, lg, shape=0)),
        0.0, 4.0 * (n * B + 5 * B + 30 * n))
    # The wave model's table: one block an SM, then every SM full.
    table = {"rows": {}, "pairwise": {}, "top2": {}}
    for s, bm in enumerate(tuning.ROW_TILES):
        per = tuning.blocks_per_sm("build_g", s)
        one, full = (time_ms(lambda: build_g.launch(
            x[:sms * c * bm], y100, dn, w, lg, "l2", shape=s)) * 1e3
            for c in (1, per))
        table["rows"][bm] = (round(one, 1), round(full, 1))
    for s in range(2, len(tuning.PAIRWISE_SHAPES)):
        bm, bn = tuning.PAIRWISE_SHAPES[s]
        per = tuning.blocks_per_sm("pairwise", s)
        yy = pick(bn)
        one, full = (time_ms(lambda: pairwise.launch(
            x[:sms * c * bm], yy, "l2", shape=s)) * 1e3 for c in (1, per))
        table["pairwise"][f"{bm}x{bn}"] = (round(one, 1), round(full, 1))
    for s, (bm, bn) in enumerate(tuning.TOP2_SHAPES):
        med = pick(bn)
        table["top2"][bn] = round(time_ms(lambda: stream_g.launch_top2(
            x, med, "l2", shape=s)) * 1e3, 1)
    log(f"[tiles] TILE_US {card}: {json.dumps(table)}")
    for nn, what in ((n, "the main path"), (TILE_RANK_ROWS, "an 8,000-row "
                                                           "rank")):
        cfg = tuning.heuristic(nn, d, 10, tuning.current_device_kind(dev),
                               "cuda")
        log(f"[tiles] heuristic at n={nn} ({what}), d={d}, k=10: {cfg}")
    log(f"[tiles] fastest measured shape by case: {best}")


def tile_fits(torch, X, dev, Xnp):
    """Phase 10 (c): the default fit (``KMedoids(k=10, solver=
    "banditpam")``, 60,000 x 784, l2, seed 0) under the floor config
    (the shapes of the unchanged ``rt_*`` entries, the parent's), under
    the heuristic's and under two others forced through
    ``tuning.observe``; the sharded fit (``solver="banditpam_dist"``,
    B = 128) at world size 1 on nccl under the floor and the
    heuristic's.  Each
    report identical to the floor's (raising); the launch counts of each
    fit equal too."""
    from repro_torch.api import KMedoids
    from repro_torch.core import tuning
    from repro_torch.kernels import ops
    kind = tuning.current_device_kind(dev)
    n, d, k = N_FIT, X.shape[1], 10
    heur = tuning.heuristic(n, d, k, kind, "cuda")
    floor = tuning.TileConfig(tm=128, tr=104, tk=tuning.top2_tile(k, kind),
                              dk=heur.dk)
    others = [c for c in (tuning.TileConfig(tm=64, tr=128, tk=40, dk=heur.dk),
                          tuning.TileConfig(tm=32, tr=104, tk=104,
                                            dk=heur.dk))
              if c not in (floor, heur)]

    def fit(cfg, solver):
        tuning.clear_ledger()
        # A measured wall no fit beats: every resolve of the bucket takes
        # cfg.
        tuning.observe(n, d, k, cfg, {"build": 1e-9}, kind, "cuda")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = KMedoids(k=k, solver=solver, metric="l2", seed=0).fit(
            Xnp[:N_FIT])
        wall = time.perf_counter() - t0
        got = tuning.resolve_tile_config(n, d, k, kind, "cuda")
        if got != cfg:
            raise AssertionError(f"the ledger resolved {got}, not {cfg}")
        r, c = est.report_, ops.launch_counts()
        log(f"[tiles] (c) {solver} under {cfg}: medoids "
            f"{r.medoids.tolist()} loss {r.loss!r} wall_by_phase "
            f"{r.wall_by_phase} fit {wall:.3f} s; host_reads_by_phase "
            f"{r.host_reads_by_phase}; launches "
            f"{ {nm: v for nm, v in c.items() if v} }")
        return r, c

    import torch.distributed as dist
    try:
        for solver, cfgs in (("banditpam", [heur] + others),
                             ("banditpam_dist", [heur])):
            if solver == "banditpam_dist":
                _dist_world1()
            r0, c0 = fit(floor, solver)
            for cfg in cfgs:
                r, c = fit(cfg, solver)
                same_report(r, r0, f"(c) {solver} under {cfg} vs the floor")
                if c != c0:
                    raise AssertionError(f"(c) {solver}: launches {c} != the "
                                         f"floor's {c0}")
    finally:
        tuning.clear_ledger()
        if dist.is_initialized():
            dist.destroy_process_group()


def tile_paths(torch, X, dev, Xnp, card):
    """Phase 10: (a), (b), (c)."""
    t0 = time.perf_counter()
    tile_bits(torch, X, dev)
    tile_times(torch, X, dev, card)
    tile_fits(torch, X, dev, Xnp)
    log(f"[tiles] phase 10 wall {time.perf_counter() - t0:.1f} s")


# Phase 11: the runtime guard and the peak-memory budgets (ROADMAP A15).
GUARD_ROWS = 20000          # the replacement + leader fit's rows in (a)


def _guard_fit(torch, guard, what, est, data, earlier=None, **kw):
    """One fit under ``FitGuard`` (raising), its reads printed beside
    ``expected_reads``; returns the report.  The guard's warm-up fit is
    ``earlier`` where given: the same fit's report from an earlier phase,
    which the guarded report must equal (medoids, loss, ledger, swaps,
    build rounds, reads), the kernel library and the tuner's ledger left
    as they were."""
    from repro_torch.analysis.guard import expected_reads, kernel_state
    state = kernel_state()
    t0 = time.perf_counter()
    r = guard.fit(est, data, warmup=earlier is None, **kw)
    wall = time.perf_counter() - t0
    if earlier is not None:
        same_report(r, earlier, f"(a) {what}: guarded vs phase 9's")
        if (r.host_reads_by_phase != earlier.host_reads_by_phase
                or kernel_state() != state):
            raise AssertionError(f"(a) {what}: the guarded fit read "
                                 f"{r.host_reads_by_phase} or moved the "
                                 f"kernel state")
    log(f"[guard] (a) {what}: guarded == "
        f"{'warm-up' if earlier is None else 'phase 9'} (medoids, loss, "
        f"ledger, swaps, build rounds, reads, "
        f"{'launches, ' if earlier is None else ''}kernel state): True; "
        f"host_reads_by_phase {r.host_reads_by_phase} expected_reads "
        f"{expected_reads(r, est, len(data))}; launches "
        f"{guard.last_launches}; medoids {r.medoids.tolist()} loss "
        f"{r.loss!r}; {wall:.1f} s")
    return r


def guard_fits(torch, Xnp, dist_reports):
    """Phase 11 (a): every device-resident driver under ``FitGuard``
    (``set_sync_debug_mode("error")``; the data given as numpy, so its
    upload goes through ``host_stage``): at the main path's 60,000 x 784,
    k = 10, l2, ``backend="cuda"`` the default fit, the default-ring PIC
    fit, a warm start from the default fit's medoids and the sharded fit
    at world size 1 on nccl in both reuse modes (its warm-up phase 9
    (a)'s resident fit, ``dist_reports``); the replacement + leader fit
    on the first ``GUARD_ROWS`` rows; phase 8 (a)'s batch (64 x
    ``mnist_like(256)``, k = 5, the leader) in both reuse modes, each
    reading fewer times than its stepped twin's loop.  All raising."""
    import torch.distributed as dist
    from repro_torch.analysis import FitGuard
    from repro_torch.api.registry import default_params
    from repro_torch.core import BanditPAM
    from repro_torch.core import distributed as tdist
    from repro_torch.core.datasets import mnist_like
    guard = FitGuard()
    X = Xnp[:N_FIT]
    kw = dict(metric="l2", seed=0, backend="cuda")
    r = _guard_fit(torch, guard, "default fit", BanditPAM(10, **kw), X)
    _guard_fit(torch, guard, "warm start from the default fit's medoids",
               BanditPAM(10, **kw), X, warm_start=r.medoids)
    _guard_fit(torch, guard, "PIC fit, the default ring",
               BanditPAM(10, reuse="pic", **kw), X)
    _guard_fit(torch, guard, f"replacement + leader fit, {GUARD_ROWS} rows",
               BanditPAM(10, sampling="replacement", baseline="leader", **kw),
               X[:GUARD_ROWS])
    try:
        _dist_world1()
        for reuse in ("none", "pic"):
            _guard_fit(torch, guard, f"sharded fit, world size 1 on nccl, "
                       f"reuse={reuse}",
                       tdist.DistributedBanditPAM(10, reuse=reuse, **kw), X,
                       earlier=dist_reports[reuse])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    small = [mnist_like(BATCH_N, seed=i) for i in range(BATCH_FITS)]
    for solver, reuse in (("banditpam", "none"), ("banditpam_pp", "pic")):
        t0 = time.perf_counter()
        b = guard.fit_batch(BanditPAM(BATCH_K, reuse=reuse, **kw,
                                      **default_params(solver)),
                            small, seeds=list(range(BATCH_FITS)))
        log(f"[guard] (a) batch {solver}, {BATCH_FITS} x mnist_like("
            f"{BATCH_N}), k={BATCH_K}: guarded == warm-up (every fit, reads, "
            f"round launches, launches, kernel state): True; "
            f"host_reads_by_phase {b.host_reads_by_phase}, fewer than the "
            f"stepped twin's loop in each phase: True; dispatches_by_phase "
            f"{b.dispatches_by_phase}; launches {guard.last_launches}; "
            f"{time.perf_counter() - t0:.1f} s with the twin")


def guard_budgets(torch, dev, card):
    """Phase 11 (b): every budget key measured on the card at its
    canonical shapes (``analysis.budgets.measure``): the entry point's
    peak temporaries under its bound, the materialised form's over it,
    each beside the JAX bound where the key carries one over (the port's
    bound less the buffer it names).  Raising."""
    from repro_torch.analysis import budgets
    log(f"[budget] card: {card}; temporaries = peak of "
        f"max_memory_allocated over the call - allocated before - returned")
    for name in budgets.budget_names():
        t0 = time.perf_counter()
        m = budgets.measure(name, device=dev)
        jkey = budgets.counterpart(name)
        jax_bound = (budgets.budget_bytes(name)
                     - budgets.card_buffer_bytes(name) if jkey else None)
        under, over = 0 <= m.temp <= m.bound, m.materialised > m.bound
        log(f"[budget] {name}: temp {m.temp} B, bound {m.bound} B "
            f"({budgets.budget_doc(name)}; at {m.shape}); JAX bound "
            f"{jax_bound} ({jkey}); materialised "
            f"({budgets.materialised_doc(name)}) {m.materialised} B; "
            f"under the bound: {under}; materialised over it: {over} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not (under and over):
            raise AssertionError(f"budget {name}: {m}")


def guard_paths(torch, dev, Xnp, card, dist_reports):
    """Phase 11: (a) in this process while the parts of ``PARTS`` (phase
    6 (c) and (d), phase 9 (c) and phase 11 (b)) run in processes of
    their own beside it.  Returns the parts' output lines."""
    t0 = time.perf_counter()
    started = start_parts()
    try:
        guard_fits(torch, Xnp, dist_reports)
    except BaseException:
        stop_parts(started)
        raise
    log(f"[guard] (a) wall {time.perf_counter() - t0:.1f} s")
    lines = finish_parts(started)
    log(f"[guard] phase 11 wall {time.perf_counter() - t0:.1f} s (with the "
        f"parts)")
    return lines


# Phase 12: the LM curation path (ROADMAP A17a) at qwen3-1.7B's width.
LM_ARCH = "qwen3_1_7b"
LM_BATCH, LM_SEQ, LM_STEPS = 8, 64, 3       # the example's batch and seq
LM_POOL, LM_POOL_SEQ, LM_K = 64, 32, 8      # curate_weights' defaults
# The kernels a 64-row cosine leader fit and its top-2 pass launch
# (pairwise: the leader's row, [1 x the batch]).
LM_KERNELS = ("pairwise", "build_g", "swap_g", "top2")


def lm_full_width(torch, dev, card, cfg):
    """Phase 12 (a), (b), (c) at ``cfg``'s width (qwen3-1.7B's in the
    run); returns the kernel rows of (b) and the model, which phase 13
    serves."""
    import numpy as np
    from repro_torch.core import BanditPAM
    from repro_torch.core.engine import medoid_cache
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import curated, init_opt_state, make_train_step
    from repro_torch.train.data import synthetic_batch
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_norm = cfg.d_model * (2 * cfg.n_layers + 1) + 2 * cfg.hd * cfg.n_layers
    log(f"[lm] (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_par} parameters = param_count() "
        f"{int(cfg.param_count()['total'])} + {n_norm} norm weights; "
        f"float32, initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    if n_par != int(cfg.param_count()["total"]) + n_norm:
        raise AssertionError("(a) parameter count")

    # (b) the curation, counted from 0.
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, w = curated.curate_weights(cfg, model, 0, pool=LM_POOL, k=LM_K,
                                  seq=LM_POOL_SEQ, device=dev)
    torch.cuda.synchronize()
    cur_s = time.perf_counter() - t0
    counts = {nm: c for nm, c in ops.launch_counts().items() if c}
    log(f"[lm] (b) curate_weights(step 0, pool {LM_POOL} x {LM_POOL_SEQ}, "
        f"k {LM_K}): {cur_s:.3f} s (embedding forward, fit and top-2 pass); "
        f"launches {counts}; max_w/min_w {w.max() / w.min():.1f}")
    missing = [nm for nm in LM_KERNELS if not counts.get(nm)]
    if not counts or missing:
        raise AssertionError(f"(b) the curation launched {counts}; "
                             f"never: {missing}")
    t0 = time.perf_counter()
    _, emb = curated.embed_pool(cfg, model, 0, LM_POOL, LM_POOL_SEQ, dev)
    torch.cuda.synchronize()
    emb_s = time.perf_counter() - t0
    fits, assign = {}, {}
    for be in ("cuda", "torch"):
        t0 = time.perf_counter()
        fits[be] = BanditPAM(LM_K, metric="cosine", seed=0, baseline="leader",
                             backend=be, device=dev).fit(emb)
        med = torch.as_tensor(fits[be].medoids, device=dev)
        assign[be] = medoid_cache(emb, med, metric="cosine",
                                  backend=be)[2].cpu()
        log(f"[lm] (b) fit {be}: medoids {fits[be].medoids.tolist()} loss "
            f"{fits[be].loss!r} swaps {fits[be].n_swaps} build_rounds "
            f"{fits[be].build_rounds} evals {fits[be].evals_by_phase} "
            f"({time.perf_counter() - t0:.2f} s)")
    same_fit(fits["cuda"], fits["torch"], "(b) lm curation fit, cosine, "
             f"[{LM_POOL} x {cfg.vocab}]", 10 * B)
    if not torch.equal(assign["cuda"], assign["torch"]):
        raise AssertionError("(b) the assignments differ")
    _, _, w_re = curated.cluster_weights(emb, LM_K, 0)
    if not np.array_equal(w_re, w):
        raise AssertionError("(b) the curation's weights are not those of "
                             "its embeddings' clustering")
    log(f"[lm] (b) embedding forward alone {emb_s:.3f} s; cuda == torch "
        f"assignments: True; curate_weights == cluster_weights of the "
        f"re-embedded pool: True")
    rows = lm_kernel_checks(torch, emb, fits["cuda"].medoids, counts, dev)

    # (c) three train steps.
    opt_cfg = curated.OPT
    params = M.params_of(model)
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    probe = {nm: params[nm].detach()[:2].clone() for nm in (
        "embed.weight", "layers.0.attn.wq.weight",
        f"layers.{cfg.n_layers - 1}.mlp.wo.weight")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for i in range(LM_STEPS):
        batch = synthetic_batch(cfg, LM_BATCH, LM_SEQ, i, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = step(model, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        log(f"[lm] (c) step {i}: loss {loss!r} grad_norm {gn!r} lr "
            f"{float(m['lr'])!r} wall {walls[-1] * 1e3:.1f} ms")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"(c) step {i}: loss {loss}, grad norm {gn}")
    moved = {nm: bool((p0 != params[nm].detach()[:2]).any())
             for nm, p0 in probe.items()}
    peak = torch.cuda.max_memory_allocated()
    tok = LM_BATCH * LM_SEQ
    log(f"[lm] (c) {card}: first loss {losses[0]!r} beside ln(vocab) "
        f"{math.log(cfg.vocab):.4f}; step walls {[round(x * 1e3, 1) for x in walls]} "
        f"ms; steps 1-{LM_STEPS - 1}: {1e3 * sum(walls[1:]) / (LM_STEPS - 1):.1f} "
        f"ms a step, {tok * (LM_STEPS - 1) / sum(walls[1:]):.0f} tokens/s; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); "
        f"parameters moved {moved}")
    if not all(moved.values()):
        raise AssertionError(f"(c) parameters did not move: {moved}")
    del params, state, step, probe, emb
    torch.cuda.empty_cache()
    return rows, model


def lm_kernel_checks(torch, emb, medoids, counts, dev):
    """Phase 12 (b): build_g, swap_g, top2 and pairwise (a leader's row)
    against their plain versions on the curation's embeddings ([64 x
    151,936], cosine), the batch all 64 rows, the fit's medoids; timed
    beside the plain version and the bound (no library call computes
    these statistics; ``torch.cdist`` has no cosine).  A dot product over
    d terms errs by at most ``d·2^-24`` of its magnitude, so ``dtol =
    d·2^-24·dmax`` bounds a distance's error (phase 3's derivation, there
    1e-4·dmax at d = 784).  At d = 151,936 that bound is 1 % of a
    distance, loose enough to pass a kernel that skipped a chunk of the
    walk, so each distance is held to how rounding errors actually grow,
    ``tol = 4·sqrt(d)·2^-24·dmax`` (below dtol), and the sums to phase
    3's limits with ``L = r·tol``.  Top-2 labels must agree off the
    ``2·tol`` near-tie band, and on every row the kernel's label must name
    a medoid whose plain distance is within ``tol`` of the nearest."""
    from repro_torch.kernels import build_g, ops, pairwise, stream_g, swap_g
    x = emb.contiguous()
    n, d = x.shape
    y = x                                    # the batch: every row, r = n
    r = y.shape[0]
    med = x[torch.as_tensor(medoids, device=dev)].contiguous()
    k = med.shape[0]
    dmax = float(pairwise.pairwise_torch(x, y, metric="cosine").max())
    dtol = d * 2.0 ** -24 * dmax
    tol = 4.0 * math.sqrt(d) * 2.0 ** -24 * dmax
    lim = r * tol
    w = torch.ones(r, device=dev)
    w[-5:] = 0.0                             # padded slots
    dxy = pairwise.pairwise_torch(y, med, metric="cosine")
    dn = dxy.min(dim=1).values.contiguous()
    lg = torch.clamp_max(dxy[:, 0] - dn, 0.0).contiguous() * w
    got = ops.build_g_stats(x, y, dn, w, lg, metric="cosine")
    want = build_g.build_g_torch(x, y, dn, w, lg, "cosine")
    eb = max(check_close(f"lm build_g {nm}", g, wv, a)
             for nm, g, wv, a in zip(("sums", "sq", "cross"), got, want,
                                     (lim, 2 * dmax * lim, 2 * dmax * lim)))
    d1, d2, a = stream_g.top2_torch(y, med, "cosine")
    lg2 = dxy[:, 0].contiguous()
    got = ops.swap_g_stats(x, y, d1, d2, a, w, k, lg2, metric="cosine")
    want = swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg2, "cosine")
    es = max(check_close(f"lm swap_g {nm}", g, wv, at)
             for nm, g, wv, at in zip(("sums", "sq", "cross"), got, want,
                                      (2 * lim, 4 * dmax * lim,
                                       4 * dmax * lim)))
    got = ops.stream_top2(x, med, metric="cosine")
    want = stream_g.top2_torch(x, med, "cosine")
    et = max(check_close("lm top2 d1", got[0], want[0], tol),
             check_close("lm top2 d2", got[1], want[1], tol))
    clear = (want[1] - want[0]) > 2 * tol
    if not bool((got[2] == want[2])[clear].all()):
        raise AssertionError("lm top2: labels differ off near-ties")
    named = pairwise.pairwise_torch(x, med, metric="cosine").gather(
        1, got[2].long()[:, None])[:, 0]
    et = max(et, check_close("lm top2 label's distance", named, want[0],
                             tol))
    lead = x[:1].contiguous()                # a leader's row
    ep = check_close("lm pairwise leader row", ops.pairwise_distance(
        lead, y, "cosine"), pairwise.pairwise_torch(lead, y, metric="cosine"),
        tol)
    log(f"[lm] (b) kernels at [{n} x {d}] (pairwise [1 x {r}]), cosine: "
        f"within tol {tol:.3e} (4·sqrt(d)·2^-24·dmax, dmax {dmax:.4f}), "
        f"below dtol {dtol:.3e} (d·2^-24·dmax); top-2 labels equal on "
        f"{int(clear.sum())} of {n} rows clear of near-ties, and every "
        f"row's label within tol of the nearest plain distance")
    cases = (
        ("build_g", "repro_torch/kernels/csrc/build_g.cu",
         "src/repro/kernels/build_g.py:42", eb,
         lambda: ops.build_g_stats(x, y, dn, w, lg, metric="cosine"),
         lambda: build_g.build_g_torch(x, y, dn, w, lg, "cosine"),
         2.0 * n * r * d, 4.0 * (n * d + r * d + 3 * r + 3 * n)),
        ("swap_g", "repro_torch/kernels/csrc/swap_g.cu",
         "src/repro/kernels/swap_g.py:85", es,
         lambda: ops.swap_g_stats(x, y, d1, d2, a, w, k, lg2,
                                  metric="cosine"),
         lambda: swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg2, "cosine"),
         2.0 * n * r * d, 4.0 * (n * d + r * d + 5 * r + 3 * k * n)),
        ("top2", "repro_torch/kernels/csrc/stream_g.cu",
         "src/repro/kernels/stream_g.py:165", et,
         lambda: ops.stream_top2(x, med, metric="cosine"),
         lambda: stream_g.top2_torch(x, med, "cosine"),
         2.0 * n * k * d, 4.0 * (n * d + k * d + 3 * n)),
        ("pairwise", "repro_torch/kernels/csrc/pairwise.cu",
         "src/repro/kernels/pairwise.py:74", ep,
         lambda: ops.pairwise_distance(lead, y, "cosine"),
         lambda: pairwise.pairwise_torch(lead, y, metric="cosine"),
         2.0 * r * d, 4.0 * (d + r * d + r)))
    rows = []
    for name, src, rep, err, kern, plain, fl, by in cases:
        ms, pms = time_ms(kern), time_ms(plain)
        bms, bby = bound_ms(fl, by)
        shape = {"top2": f"{n}x{k}x{d}",
                 "pairwise": f"1x{r}x{d}"}.get(name, f"{n}x{r}x{d}")
        log(f"[lm] (b) [time] {name} [{shape}] kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms bound {bms * 1e3:.1f} us ({bby}) share of bound "
            f"{bms / ms:.3f}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts.get(name, 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": bby, "library_ms": None,
                     "shape": shape, "path": "lm"})
    return rows


def _lm_train(torch, cfg, dev, ckpt_dir, fail_at=None, n_steps=6):
    """``n_steps`` train steps of a seeded model under
    ``FaultTolerantLoop(save_every=2)``, one transient failure injected
    at ``fail_at``; returns the final state and the loop."""
    from repro_torch.models import model as M
    from repro_torch.runtime.fault import FaultTolerantLoop
    from repro_torch.train import curated, init_opt_state, make_train_step
    from repro_torch.train.data import synthetic_batch
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    step_fn = make_train_step(cfg, curated.OPT)
    failed = []

    def one_step(st, i):
        M.load_params(model, st["params"])
        if i == fail_at and not failed:
            failed.append(i)
            raise RuntimeError("injected transient failure")
        batch = synthetic_batch(cfg, LM_BATCH, LM_SEQ, i, device=dev)
        _, opt, m = step_fn(model, st["opt"], batch)
        return {"params": M.params_of(model), "opt": opt}, m

    loop = FaultTolerantLoop(ckpt_dir, save_every=2, install_sigterm=False)
    state = {"params": M.params_of(model),
             "opt": init_opt_state(M.params_of(model), curated.OPT)}
    return loop.run(state, one_step, n_steps=n_steps), loop


def lm_fault_loop(torch, dev):
    """Phase 12 (d): the loop at the cpu-small preset on the card."""
    import tempfile
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.train import curated
    cfg = curated.preset_config("cpu-small")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        want, _ = _lm_train(torch, cfg, dev, os.path.join(tmp, "a"))
        got, loop = _lm_train(torch, cfg, dev, os.path.join(tmp, "b"),
                              fail_at=3)
        flat_w, flat_g = ckpt._flatten(want), ckpt._flatten(got)
        same = ([k for k, _ in flat_w] == [k for k, _ in flat_g] and all(
            torch.equal(g, w) for (_, g), (_, w) in zip(flat_g, flat_w)))
        restored, start = loop.restore_or(want)
        ff = start == 6 and all(torch.equal(r_, w) for (_, r_), (_, w) in
                                zip(ckpt._flatten(restored), flat_w))
        log(f"[lm] (d) FaultTolerantLoop, cpu-small "
            f"({int(cfg.param_count()['total'])} parameters), 6 steps, a "
            f"checkpoint every 2, a failure injected at step 3: equal bits "
            f"to the uninterrupted run ({len(flat_w)} tensors): {same}; "
            f"restore_or fast-forwards to step {start} with those bits: {ff}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not (same and ff):
            raise AssertionError("(d) the replay is not exact")


def lm_card_vs_cpu(torch, dev):
    """Phase 12 (e): the reduced config on the card and on the CPU from the
    same weights (made on the CPU): logits within 1e-5·max|logits|, three
    steps' losses within rtol 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.train import curated, init_opt_state, make_train_step
    from repro_torch.train.data import synthetic_batch
    cfg = get_reduced(LM_ARCH)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        cpu = M.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        card = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        card.load_state_dict(cpu.state_dict())
        toks = synthetic_batch(cfg, 2, 32, 0, device="cpu")["tokens"]
        with torch.no_grad():
            want = cpu({"tokens": toks})[0]
            got = card({"tokens": toks.to(dev)})[0].cpu()
        lim = 1e-5 * float(want.abs().max())
        err = float((got - want).abs().max())
        losses = {}
        for name, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
            st = init_opt_state(M.params_of(model), curated.OPT)
            step = make_train_step(cfg, curated.OPT)
            losses[name] = []
            for i in range(3):
                _, st, m = step(model, st, synthetic_batch(cfg, 2, 32, i,
                                                           device=d))
                losses[name].append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                      losses["cpu"]))
        log(f"[lm] (e) {cfg.name} reduced, card vs CPU: logits max abs err "
            f"{err:.3e} (limit {lim:.3e}); losses card {losses['card']} cpu "
            f"{losses['cpu']} (max rel diff {rel:.2e}, limit 1e-5)")
        if err > lim or rel > 1e-5:
            raise AssertionError("(e) the card and the CPU differ")
    finally:
        torch.set_float32_matmul_precision(old)


def lm_paths(torch, dev, card):
    """Phase 12: (a)–(e), then phase 13 on (c)'s model; returns (b)'s
    kernel rows."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    rows, model = lm_full_width(torch, dev, card, cfg)
    lm_fault_loop(torch, dev)
    lm_card_vs_cpu(torch, dev)
    log(f"[lm] phase 12 wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_serve_full_width(torch, dev, card, cfg, model)
    del model
    torch.cuda.empty_cache()
    lm_serve_card_vs_cpu(torch, dev)
    log(f"[lm-serve] phase 13 wall {time.perf_counter() - t0:.1f} s")
    return rows


# Phase 13: LM serving at qwen3-1.7B's width; prompts of LM_SEQ tokens,
# LM_SERVE_NEW greedy steps into a cache of LM_SERVE_CACHE positions.
LM_SERVE_NEW = 16
LM_SERVE_CACHE = LM_SEQ + LM_SERVE_NEW
LM_SERVE_PROFILED = 3       # (b): decode steps under the profiler
# (c): the reduced configs (name, prompt length), each decoded
# LM_SERVE_CPU_STEPS steps on the card and on the CPU.
LM_SERVE_REDUCED = (("qwen3_1_7b", 32), ("gemma3_12b", 24), ("chunked", 28))
LM_SERVE_CPU_STEPS = 12


def _logit_err(got, want):
    """Max abs error and the limit 1e-5·max|want| (the CPU tests'
    standard for logits)."""
    return (float((got.double() - want.double()).abs().max()),
            1e-5 * float(want.abs().max()))


def _serve_and_check(torch, dev, cfg, model, tag, self_floor=False,
                     seq=LM_SEQ):
    """``serve.lm``'s prefill of ``LM_BATCH`` x ``seq`` synthetic
    prompts (a vision prompt its patches, then text) into states of
    ``seq + LM_SERVE_NEW`` positions, then
    ``LM_SERVE_NEW`` greedy decode steps (a device synchronisation after
    each, for its latency), at ``cfg`` (the model's forward runs at
    ``model.cfg``); the prefill's last logits and every step's logits
    held against the model's own full forward over the prompt and the fed
    tokens (teacher-forced), within 1e-5·max|logits|, the CPU tests'
    standard; raising.  With ``self_floor`` (phase 15) the limit is the
    larger of that and twice the full forward's own spread: the largest
    difference between the forward over the batch and the same forward
    one sequence a call, whose matrix products round in another order.
    That spread grows with depth (``chip_lm_spread.py``, falcon-mamba-7b
    on an H100 80GB HBM3 at 700.00 W: 0.299, 0.469, 0.894, 1.285 times
    1e-5·max|logits| at 8, 16, 32, 64 layers), and decode stays within
    1.3 times it.  Returns the run: prefill walls
    (first call, second), step walls, the final state, the fed tokens,
    the next position and ``max_memory_allocated`` over the run."""
    from repro_torch.train.data import synthetic_batch
    full_b = synthetic_batch(cfg, LM_BATCH, seq, 0, device=dev)
    prompts = {k: full_b[k] for k in ("tokens", "patch_emb") if k in full_b}
    del full_b
    run = _serve_run(torch, dev, cfg, model, prompts, seq)
    logits, state, fed = run["logits"], run["state"], run["fed"]
    step_logits = run["step_logits"]
    shapes = [[tuple(a.shape) for a in entry] for entry in state]
    # Teacher-forced: the full forward over the prompt and the fed tokens
    # gives, at position p, the logits of the step that read p.
    toks = prompts["tokens"]
    forced = dict(prompts, tokens=torch.cat(
        [toks, torch.cat(fed, dim=1).to(toks.dtype)], 1))
    n_pos = seq + len(fed)
    with torch.no_grad():
        full = model(forced)[0]
        spread, floor_txt = 0.0, ""
        if self_floor:
            one = torch.cat([model({k: v[i:i + 1] for k, v in
                                    forced.items()})[0]
                             for i in range(LM_BATCH)])
            spread = float((full.double() - one.double()).abs().max())
            del one
            ratio = spread / (1e-5 * float(full.abs().max()))
            floor_txt = (f"; the full forward's own spread (the batch "
                         f"against one sequence a call) {spread:.3e}, "
                         f"{ratio:.3f} times 1e-5·max|logits|, the limit "
                         f"the larger of 1e-5·max|logits| and twice it")
    e_pre, lim = _logit_err(logits[:, 0], full[:, seq - 1])
    e_dec = [_logit_err(g, full[:, seq + i])
             for i, g in enumerate(step_logits)]
    del full
    flat = max([e_pre / lim] + [e / l for e, l in e_dec])
    lim = max(lim, 2 * spread)
    e_dec = [(e, max(l, 2 * spread)) for e, l in e_dec]
    worst = max([e_pre / lim] + [e / l for e, l in e_dec])
    log(f"{tag} {cfg.name} at full width, float32: prefill "
        f"{LM_BATCH} x {seq} into states {shapes}, {LM_SERVE_NEW} greedy "
        f"steps; against the full forward over the {n_pos} positions "
        f"(teacher-forced): prefill logits max abs err {e_pre:.3e} (limit "
        f"{lim:.3e}), decode steps' max abs err "
        f"{[float(f'{e:.3e}') for e, _ in e_dec]} (limits "
        f"{min(l for _, l in e_dec):.3e}..{max(l for _, l in e_dec):.3e}); "
        f"worst err/limit {worst:.3f}"
        + (f" (err / 1e-5·max|logits| {flat:.3f}){floor_txt}"
           if self_floor else ""))
    if worst > 1.0:
        raise AssertionError(f"{tag} prefill or decode logits differ from "
                             f"the full forward")
    if n_pos != seq + LM_SERVE_NEW:
        raise AssertionError(f"{tag} {n_pos} positions, not "
                             f"{seq + LM_SERVE_NEW}")
    run["shapes"] = shapes
    return run


def _serve_run(torch, dev, cfg, model, prompts, seq=LM_SEQ):
    """``serve.lm``'s prefill of ``prompts`` (token ids, or a batch of
    ``tokens`` and a vision prompt's ``patch_emb``; ``seq`` positions in
    all) into states of ``seq + LM_SERVE_NEW`` positions (twice, each
    call timed), then
    ``LM_SERVE_NEW`` greedy decode steps from the second, a device
    synchronisation after each for its latency, at ``cfg``.  Returns the
    prefill's logits, walls and state, each step's logits and wall, the
    fed tokens, the next token and position and
    ``max_memory_allocated`` over the run."""
    from repro_torch.serve import lm
    prefill = lm.make_prefill_step(cfg, seq + LM_SERVE_NEW)
    decode = lm.make_decode_step(cfg)
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pre_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, state = prefill(model, batch)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.full((), seq, dtype=torch.int64, device=dev)
    fed, step_logits, step_ms = [], [], []
    for _ in range(LM_SERVE_NEW):
        fed.append(tok)
        t0 = time.perf_counter()
        lg, state = decode(model, state, {"tokens": tok}, pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_logits.append(lg[:, 0])
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        pos = pos + 1
    return {"logits": logits, "pre_ms": pre_ms, "state": state,
            "step_logits": step_logits, "step_ms": step_ms, "fed": fed,
            "tok": tok, "pos": pos, "peak": torch.cuda.max_memory_allocated()}


def lm_serve_full_width(torch, dev, card, cfg, model):
    """Phase 13 (a), (b) at ``cfg``'s width in float32 on phase 12's
    model: (a) ``_serve_and_check``, the caches' shapes [G, B, S_c, KVH,
    hd] as ``init_decode_state`` makes them; raising.  (b) Prefill ms
    (its first call and a second), decode p50 / p99 ms a step over steps
    2 on (the JAX driver's window), tokens/s at p50,
    ``max_memory_allocated``, the card's name and power limit, and
    ``LM_SERVE_PROFILED`` steps under ``torch.profiler``: the device's
    busy and idle share and its time by kernel."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.serve import lm
    run = _serve_and_check(torch, dev, cfg, model, "[lm-serve] (a)")
    decode = lm.make_decode_step(cfg)
    state, fed, pos = run["state"], run["fed"], run["pos"]
    pre_ms, step_ms, peak = run["pre_ms"], run["step_ms"], run["peak"]
    shapes = [s[0] for s in run["shapes"]]
    want = [(cfg.n_groups, LM_BATCH, M._cache_len(cfg, kind, LM_SERVE_CACHE),
             cfg.n_kv_heads, cfg.hd) for kind in cfg.layer_pattern]
    if shapes != want:
        raise AssertionError(f"(a) cache shapes {shapes}, not {want}")
    # Where a step's time goes: LM_SERVE_PROFILED more steps under the
    # profiler, each decoding the last position again from the final
    # state (a step's shapes and work).
    from torch.profiler import ProfilerActivity, profile
    last = (fed[-1], pos - 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_SERVE_PROFILED):
            decode(model, state, {"tokens": last[0]}, last[1])
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    ivs, by_name, _, busy = _trace_events(torch, prof)
    if not ivs:
        raise AssertionError("(b) the profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"[lm-serve] (b) {LM_SERVE_PROFILED} decode steps under the "
        f"profiler: wall {prof_s * 1e3 / LM_SERVE_PROFILED:.3f} ms a step, "
        f"device busy {busy / 1e6 / LM_SERVE_PROFILED:.3f} ms a step, idle "
        f"share {1 - busy / 1e9 / prof_s:.4f}, {len(ivs) // LM_SERVE_PROFILED}"
        f" device activities a step; device time by kernel, a step: "
        + "; ".join(f"{tot / 1e6 / LM_SERVE_PROFILED:.3f} ms "
                    f"{cnt // LM_SERVE_PROFILED} x {nm[:70]}"
                    for nm, (cnt, tot) in top))
    p50, p99 = np.percentile(step_ms[1:], [50, 99])
    log(f"[lm-serve] (b) {card}: prefill {pre_ms[0]:.2f} ms (first call), "
        f"{pre_ms[1]:.2f} ms (second) for {LM_BATCH}x{LM_SEQ}; decode p50 "
        f"{p50:.3f} ms p99 {p99:.3f} ms a step (steps 2-{LM_SERVE_NEW}), "
        f"{LM_BATCH / (p50 / 1e3):.1f} tokens/s at p50; step walls "
        f"{[round(x, 3) for x in step_ms]} ms; max_memory_allocated {peak} B "
        f"({peak / 2**30:.2f} GiB, the model's float32 weights included)")


def _reduced_serving_config(name):
    import dataclasses
    from repro_torch.configs import get_reduced
    if name == "chunked":
        return dataclasses.replace(get_reduced("qwen3_1_7b"),
                                   name="chunked-reduced",
                                   layer_pattern=("chunked",), window=16)
    return get_reduced(name)


def lm_serve_card_vs_cpu(torch, dev, cases=LM_SERVE_REDUCED,
                         tag="[lm-serve] (c)"):
    """Phase 13 (c) (and phase 15 (d) on ``LM_FAMILY_REDUCED``): the
    reduced configs of ``cases`` (phase 13: qwen3's global layers;
    gemma3's local layers at window 16 with a prompt of 24, so the cache
    rolls; one ``chunked`` kind at window 16 with a prompt of 28, decoding
    across the chunk boundary at 32) on the card and on the CPU from the
    same weights (made on the CPU): the greedy tokens equal, and the
    prefill's and every teacher-forced step's logits within
    1e-5·max|logits|; raising.  The smallest top-2 logit gap is printed
    beside the limit."""
    from repro_torch.models import model as M
    from repro_torch.serve import lm
    from repro_torch.train.data import synthetic_batch
    cpu_dev = torch.device("cpu")
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for name, prompt in cases:
            cfg = _reduced_serving_config(name)
            steps = LM_SERVE_CPU_STEPS
            cpu = M.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
            card = M.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev)
            card.load_state_dict(cpu.state_dict())
            full = synthetic_batch(cfg, 2, prompt, 0, device="cpu")
            prompts = {k: full[k] for k in ("tokens", "patch_emb")
                       if k in full}
            prefill = lm.make_prefill_step(cfg, prompt + steps + 1)
            decode = lm.make_decode_step(cfg)
            out = {}
            for side, model, d in (("cpu", cpu, cpu_dev), ("card", card, dev)):
                logits, state = prefill(model, {k: v.to(d) for k, v in
                                                prompts.items()})
                first = torch.argmax(logits, dim=-1).to(torch.int32)
                gen, _ = lm.greedy_decode(cfg, model, state, first, prompt,
                                          steps)
                out[side] = (logits.cpu(), torch.cat([first, gen], 1).cpu(),
                             state)
            same_tokens = torch.equal(out["card"][1], out["cpu"][1])
            errs = [_logit_err(out["card"][0], out["cpu"][0])]
            gaps = []
            states = {side: out[side][2] for side in out}
            seq = out["cpu"][1]
            for i in range(steps):
                lg = {}
                for side, model, d in (("cpu", cpu, cpu_dev),
                                       ("card", card, dev)):
                    lg[side], states[side] = decode(
                        model, states[side], {"tokens": seq[:, i:i + 1].to(d)},
                        torch.tensor(prompt + i, device=d))
                errs.append(_logit_err(lg["card"].cpu(), lg["cpu"]))
                top = torch.topk(lg["cpu"][:, 0], 2, dim=-1).values
                gaps.append(float((top[..., 0] - top[..., 1]).min()))
            worst = max(e / lim for e, lim in errs)
            log(f"{tag} {cfg.name} reduced, layer kinds "
                f"{sorted(set(cfg.layer_pattern))}, window {cfg.window}, "
                f"prompt {prompt}, {steps} steps: card vs CPU greedy tokens "
                f"equal: {same_tokens}; logits worst err/limit {worst:.3f} "
                f"(max abs err {max(e for e, _ in errs):.3e}); smallest "
                f"top-2 logit gap {min(gaps):.3e}")
            if not same_tokens or worst > 1.0:
                raise AssertionError(f"{tag} {cfg.name}: the card and the "
                                     f"CPU differ")
    finally:
        torch.set_float32_matmul_precision(old)


# Phase 14: the paper's other datasets (``core.datasets``), the benchmark
# cases ``benchmarks/scaling_n.py`` fits for Fig. 3b and Fig. 1b, each a
# default l1 fit: (name, generator, n, k).
DATA_CASES = (("fig3b_scrna_l1_k5", "scrna_like", 10_000, 5),
              ("fig1b_hoc4_tree_k2", "hoc4_like", 20_000, 2))
DATA_KERNELS = ("build_g", "swap_g", "top2")


def data_paths(torch, dev, card):
    """Phase 14: ``KMedoids(k, solver="banditpam", metric="l1")`` on
    ``scrna_like(10_000, seed=0)`` (d = 1,000) at k = 5 and on
    ``hoc4_like(20_000, seed=0)`` (d = 32) at k = 2, each on
    ``backend="cuda"`` and ``"torch"``, counted from 0: wall, ledger,
    host reads, peak memory and launches (the cuda fit must launch
    build_g, swap_g and top2, the torch fit none); the two fits the same
    (medoids, swap history, build rounds, fallbacks, the loss within rtol
    1e-5, each phase's ledger within phase 4's allowance of 10·B: a kill
    on an exact float32 margin can move a round), raising.  Before each,
    the plain l1 path's peak at the round's shape is reckoned from
    ``distances._L1_CHUNK_ELEMS``.  Then the scRNA round's kernels
    (``data_kernel_checks``).  Returns the kernel rows."""
    from repro_torch.api import KMedoids
    from repro_torch.core import datasets
    from repro_torch.core.distances import _L1_CHUNK_ELEMS
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    rows = []
    for name, gen, n, k in DATA_CASES:
        t1 = time.perf_counter()
        Xnp = datasets.make(gen, n, seed=0)
        d = Xnp.shape[1]
        chunk = max(1, min(B, _L1_CHUNK_ELEMS // (n * d)))
        log(f"[data] {name}: {gen}({n}, seed=0) d={d} made in "
            f"{time.perf_counter() - t1:.1f} s, zeros {float((Xnp == 0).mean()):.3f}; "
            f"the plain l1 block of a round [{n} x {B}] walks {chunk}-column "
            f"chunks, {n * chunk * d * 4 / 2**20:.1f} MiB a temporary (the "
            f"whole [n, B, d] difference would be {n * B * d * 4 / 1e9:.2f} GB)")
        X = torch.from_numpy(Xnp).to(dev)
        fits, counts = {}, {}
        for be in ("cuda", "torch"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            est = KMedoids(k, solver="banditpam", metric="l1", backend=be,
                           device=dev).fit(X)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            r = est.report_
            counts[be] = {nm: c for nm, c in ops.launch_counts().items() if c}
            fits[be] = r
            log(f"[data] {name} backend={be}: medoids {r.medoids.tolist()} "
                f"loss {r.loss!r} swaps {r.n_swaps} build_rounds "
                f"{r.build_rounds} evals {r.evals_by_phase} wall_by_phase "
                f"{r.wall_by_phase} fit {wall:.3f} s host reads "
                f"{r.host_reads_by_phase} peak memory "
                f"{torch.cuda.max_memory_allocated()} B launches "
                f"{counts[be]}")
        same_fit(fits["cuda"], fits["torch"], f"[data] {name}", 10 * B)
        missing = [nm for nm in DATA_KERNELS if not counts["cuda"].get(nm)]
        if missing or counts["torch"]:
            raise AssertionError(f"{name}: the cuda fit never launched "
                                 f"{missing}, or the torch fit launched "
                                 f"{counts['torch']}")
        log(f"[data] {name}: cuda == torch (medoids, swap history, build "
            f"rounds, fallbacks; the loss within rtol 1e-5; the ledger "
            f"within 10·B, exactly equal: "
            f"{fits['cuda'].evals_by_phase == fits['torch'].evals_by_phase})")
        if gen == "scrna_like":
            rows = data_kernel_checks(torch, X, fits["cuda"].medoids,
                                      counts["cuda"], dev, card)
        del X
    log(f"[data] phase 14 wall {time.perf_counter() - t0:.1f} s")
    return rows


def data_kernel_checks(torch, X, medoids, counts, dev, card):
    """Phase 14, the scRNA round's shape: ``build_g`` and ``swap_g`` at
    [10,000 x 100], d = 1,000, l1, against their plain versions with
    phase 3's tolerances (the distance tolerance ``1e-4·dmax`` holds since
    d·2^-24 = 6e-5 < 1e-4 at d = 1,000), a batch of 100 rows with 7
    padded slots, the fit's medoids; each timed beside its plain version
    and its bound, max(2·n·B·d / 67 TFLOP/s, bytes / 3.35 TB/s).  Returns
    the kernels line's rows, their launches the cuda fit's."""
    from repro_torch.kernels import build_g, ops, pairwise, swap_g
    x = X.contiguous()
    n, d = x.shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    y = x[torch.randperm(n, generator=gen)[:B].to(dev)].contiguous()
    w = torch.ones(B, device=dev)
    w[-7:] = 0.0                                    # padded slots
    med = x[torch.as_tensor(medoids, device=dev)].contiguous()
    k = med.shape[0]
    dxy = pairwise.pairwise_torch(y, med, metric="l1")
    dmax = float(pairwise.pairwise_torch(x[:2048], y, metric="l1").max())
    lim = sum_err_limit(x, y, "l1", dmax)
    dn = dxy.min(dim=1).values.contiguous()
    lg = (torch.clamp_max(dxy[:, 0] - dn, 0.0) * w).contiguous()
    eb = max(check_close(f"data build_g[l1] {nm}", g, wv, a)
             for nm, g, wv, a in zip(
                 ("sums", "sq", "cross"),
                 ops.build_g_stats(x, y, dn, w, lg, metric="l1"),
                 build_g.build_g_torch(x, y, dn, w, lg, "l1"),
                 (lim, 2 * dmax * lim, 2 * dmax * lim)))
    d1, d2, a = ops.stream_top2(y, med, metric="l1")
    lg2 = dxy[:, 0].contiguous()
    es = max(check_close(f"data swap_g[l1] {nm}", g, wv, at)
             for nm, g, wv, at in zip(
                 ("sums", "sq", "cross"),
                 ops.swap_g_stats(x, y, d1, d2, a, w, k, lg2, metric="l1"),
                 swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg2, "l1"),
                 (2 * lim, 4 * dmax * lim, 4 * dmax * lim)))
    cases = (
        ("build_g", "repro_torch/kernels/csrc/build_g.cu",
         "src/repro/kernels/build_g.py:42", eb,
         lambda: ops.build_g_stats(x, y, dn, w, lg, metric="l1"),
         lambda: build_g.build_g_torch(x, y, dn, w, lg, "l1"),
         4.0 * (n * d + B * d + 3 * B + 3 * n)),
        ("swap_g", "repro_torch/kernels/csrc/swap_g.cu",
         "src/repro/kernels/swap_g.py:85", es,
         lambda: ops.swap_g_stats(x, y, d1, d2, a, w, k, lg2, metric="l1"),
         lambda: swap_g.swap_g_torch(x, y, d1, d2, a, w, k, lg2, "l1"),
         4.0 * (n * d + B * d + 5 * B + 3 * k * n)))
    rows = []
    for name, src, rep, err, kern, plain, nbytes in cases:
        ms, pms = time_ms(kern), time_ms(plain, reps=5, warm=1)
        bms, bby = bound_ms(2.0 * n * B * d, nbytes)
        log(f"[data] [time] {card}: {name} [{n}x{B}x{d}] l1 kernel "
            f"{ms:.4f} ms plain {pms:.4f} ms bound {bms * 1e3:.1f} us "
            f"({bby}) share of bound {bms / ms:.3f}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts.get(name, 0),
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": bms, "bound_by": bby, "library_ms": None,
                     "shape": f"{n}x{B}x{d}", "metric": "l1",
                     "path": "data"})
    return rows


# Phase 15: the MoE and SSM/hybrid families (ROADMAP A17c, A17d) at their
# published widths: (arch, layers kept or None for the full depth).
LM_FAMILIES = (("(a)", "llama4_scout_17b", 4),
               ("(b)", "falcon_mamba_7b", None), ("(c)", "zamba2_2_7b", None))
# (d): the reduced configs and their prompts, card against CPU.
LM_FAMILY_REDUCED = (("arctic_480b", 12), ("llama4_scout_17b", 28),
                     ("falcon_mamba_7b", 12), ("zamba2_2_7b", 12))


def _count_drops(torch, model, prefill, prompts):
    """The assignments each MoE layer drops in one prefill of ``prompts``
    (an extra, untimed call): ``models.moe.moe_layer`` wrapped to count
    ``moe.dropped`` on its input, the counts read after the call."""
    from repro_torch.models import moe
    counts, layer = [], moe.moe_layer

    def counting(p, x, **kw):
        counts.append(moe.dropped(p, x, **kw))
        return layer(p, x, **kw)

    moe.moe_layer = counting
    try:
        prefill(model, {"tokens": prompts})
    finally:
        moe.moe_layer = layer
    return [int(c) for c in torch.stack(counts).cpu()]


def lm_family(torch, dev, card, part, arch, n_layers, seq=LM_SEQ,
              tag="[lm-family]"):
    """Phase 15 (a), (b) or (c) (``part``) for one family at its published
    widths (phase 16 (a), (b) for a frontend, ``tag`` its lines' tag),
    float32, initialised on the card from a seeded ``torch.Generator``
    (``n_layers`` layers where given, else the full depth), over prompts
    of ``seq`` positions (a vision prompt's patches, then text):
    ``_serve_and_check`` (for an
    MoE model at ``capacity_factor = n_experts / top_k``, where no
    assignment can be dropped at any token count, so that decode and the
    full forward route alike); then prefill ms, decode p50 / p99 ms a
    step, tokens/s and ``max_memory_allocated`` (an MoE model at its
    default capacity, timed again, with the assignments its prefill drops
    counted outside the timed calls); and (e) one more decode step under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    synchronisation.  The model is freed before returning."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import lm
    from repro_torch.train.data import synthetic_batch
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    check_cfg = cfg
    if cfg.n_experts:
        check_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    t0 = time.perf_counter()
    model = M.init_params(check_cfg, torch.Generator(device=dev)
                          .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    fe = {"vision_stub": f", {cfg.n_patches} patches through vision_proj",
          "audio_stub": f", {cfg.n_codebooks} codebooks, one head each"
          }.get(cfg.frontend, "")
    log(f"{tag} {part} {cfg.name}: {cfg.n_layers} layers "
        f"{sorted(set(cfg.layer_pattern))}, d_model {cfg.d_model}, "
        f"experts {cfg.n_experts} top-{cfg.top_k}, ssm_state "
        f"{cfg.ssm_state}, vocab {cfg.vocab}{fe}: {n_par} parameters "
        f"({n_par * 4 / 1e9:.2f} GB float32; param_count() "
        f"{int(cfg.param_count()['total'])}), initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    if cfg.n_experts and n_par != int(cfg.param_count()["total"]) + (
            cfg.d_model * (2 * cfg.n_layers + 1)):
        raise AssertionError(f"{part} parameter count")
    run = _serve_and_check(torch, dev, check_cfg, model, f"{tag} {part}",
                           self_floor=True, seq=seq)
    drops = None
    if cfg.n_experts:
        del run
        model.cfg = cfg
        prompts = synthetic_batch(cfg, LM_BATCH, LM_SEQ, 0,
                                  device=dev)["tokens"]
        drops = _count_drops(torch, model,
                             lm.make_prefill_step(cfg, LM_SERVE_CACHE),
                             prompts)
        run = _serve_run(torch, dev, cfg, model, prompts)
    p50, p99 = np.percentile(run["step_ms"][1:], [50, 99])
    pre_ms, peak = run["pre_ms"], run["peak"]
    drop_txt = ""
    if drops is not None:
        from repro_torch.models.moe import capacity
        t = LM_BATCH * LM_SEQ
        c = capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        drop_txt = (f"; the prefill at capacity factor {cfg.capacity_factor} "
                    f"({c} slots an expert for {t} tokens) dropped "
                    f"{sum(drops)} of "
                    f"{t * cfg.top_k * cfg.n_layers} assignments, by layer "
                    f"{drops}")
    codes = (f" ({LM_BATCH * cfg.n_codebooks / (p50 / 1e3):.1f} codes/s, "
             f"{cfg.n_codebooks} a token)" if cfg.frontend == "audio_stub"
             else "")
    log(f"{tag} {part} {card}: {cfg.name}: prefill {pre_ms[0]:.2f} ms "
        f"(first call), {pre_ms[1]:.2f} ms (second) for "
        f"{LM_BATCH}x{seq}; decode p50 {p50:.3f} ms p99 {p99:.3f} ms a "
        f"step (steps 2-{LM_SERVE_NEW}), {LM_BATCH / (p50 / 1e3):.1f} "
        f"tokens/s at p50{codes}; step walls "
        f"{[round(x, 3) for x in run['step_ms']]} ms; max_memory_allocated "
        f"{peak} B ({peak / 2**30:.2f} GiB, the weights included)"
        + drop_txt)
    decode = lm.make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, _ = decode(model, run["state"], {"tokens": run["tok"]},
                       run["pos"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = bool(torch.isfinite(lg).all())
    log(f"{tag} (e) {cfg.name}: one decode step under "
        f"set_sync_debug_mode('error'): no synchronisation; logits "
        f"{tuple(lg.shape)} finite: {ok}")
    if not ok:
        raise AssertionError(f"(e) {cfg.name}: non-finite logits")
    del model, run, lg
    torch.cuda.empty_cache()


def lm_families(torch, dev, card):
    """Phase 15: (a)–(c), each with its (e), for ``LM_FAMILIES`` in turn
    (``lm_family``), then (d) the reduced MoE, Mamba-1 and hybrid configs
    card against CPU (``lm_serve_card_vs_cpu``)."""
    t0 = time.perf_counter()
    for part, arch, n_layers in LM_FAMILIES:
        t1 = time.perf_counter()
        lm_family(torch, dev, card, part, arch, n_layers)
        log(f"[lm-family] {arch} wall {time.perf_counter() - t1:.1f} s")
    lm_serve_card_vs_cpu(torch, dev, LM_FAMILY_REDUCED, "[lm-family] (d)")
    log(f"[lm-family] phase 15 wall {time.perf_counter() - t0:.1f} s")


# Phase 16: the frontends (ROADMAP A17e) at their published widths and
# depths: (part, arch, prompt positions: phi-3-vision's 576 patches, then
# LM_SEQ text tokens; musicgen's LM_SEQ steps of 4 codebooks).
LM_FRONTENDS = (("(a)", "phi3_vision_4_2b", 576 + LM_SEQ),
                ("(b)", "musicgen_large", LM_SEQ))
# (c): the reduced configs and their prompts (positions), card against CPU.
LM_FRONTEND_REDUCED = (("phi3_vision_4_2b", 20), ("musicgen_large", 12))
# (d): the compressed train step's steps, beside as many uncompressed ones,
# and the depth at which two models step in lockstep against the replay.
LM_COMPRESSED_STEPS = 4
LM_REPLAY_LAYERS = 4


def _ulps(torch, a, b):
    """The largest distance in float32 ulps between two float32 tensors
    (their bits as ordered integers: a negative float's magnitude
    negated)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def lm_frontend_card_vs_cpu(torch, dev):
    """Phase 16 (c): the reduced frontends card against CPU on the same
    weights: serving (``lm_serve_card_vs_cpu``: greedy tokens equal,
    logits within 1e-5·max|logits|); a train step's loss (rtol 1e-4) and
    gradients (rtol 1e-4, atol 1e-6, the CPU tests' tolerances); and the
    vision batch's ``patch_emb`` drawn on the card against the CPU draw,
    at the reduced shape and at phase 16 (a)'s [8, 576, 3072], within 0
    ulps (``threefry.normal`` is IEEE operations only); raising."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core import threefry
    from repro_torch.models import model as M
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.train_step import accumulate_grads
    lm_serve_card_vs_cpu(torch, dev, LM_FRONTEND_REDUCED, "[lm-frontend] (c)")
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for arch, _ in LM_FRONTEND_REDUCED:
            cfg = get_reduced(arch)
            cpu = M.init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
            card = M.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(1), device=dev)
            card.load_state_dict(cpu.state_dict())
            got = {}
            for side, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
                batch = synthetic_batch(cfg, 2, 32, 5, device=d)
                loss, _, grads = accumulate_grads(cfg, model, batch, 1)
                got[side] = (float(loss), {k: g.cpu() for k, g in
                                           grads.items()}, batch)
            l_cpu, l_card = got["cpu"][0], got["card"][0]
            worst = 0.0
            for k, g in got["cpu"][1].items():
                err = (got["card"][1][k].double() - g.double()).abs()
                lim = 1e-6 + 1e-4 * g.double().abs()
                worst = max(worst, float((err / lim).max()))
            same_batch = all(torch.equal(got["card"][2][k].cpu(), v)
                             for k, v in got["cpu"][2].items())
            rel = abs(l_card - l_cpu) / abs(l_cpu)
            log(f"[lm-frontend] (c) {cfg.name} reduced, a train step's "
                f"loss and gradients, card vs CPU: batch bits equal "
                f"{same_batch}; loss {l_card!r} vs {l_cpu!r} (rel err "
                f"{rel:.2e}, limit 1e-4); gradients' worst err/limit "
                f"{worst:.3f} (rtol 1e-4, atol 1e-6) over "
                f"{len(got['cpu'][1])} tensors")
            if not same_batch or rel > 1e-4 or worst > 1.0:
                raise AssertionError(f"(c) {cfg.name}: the card's train step "
                                     f"differs from the CPU's")
    finally:
        torch.set_float32_matmul_precision(old)
    full = get_config("phi3_vision_4_2b")
    for shape in ((2, 8, 64), (LM_BATCH, full.n_patches, full.d_model)):
        key = threefry.split(threefry.fold_in(threefry.PRNGKey(0), 0), 4)[3]
        t0 = time.perf_counter()
        on_card = threefry.normal(key, shape, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        on_cpu = threefry.normal(key, shape, device="cpu")
        ulps = _ulps(torch, on_card.cpu(), on_cpu)
        log(f"[lm-frontend] (c) patch_emb {list(shape)} (synthetic_batch's "
            f"step-0 key k4): card vs CPU normal draws, max {ulps} ulps "
            f"(limit 0); {on_card.numel()} draws on the card in "
            f"{card_s * 1e3:.1f} ms")
        if ulps:
            raise AssertionError("(c) the card's normal draws differ")
        del on_card, on_cpu


def _replay_compressed_step(torch, cfg, model, opt, residuals, batch):
    """``train.compressed``'s step at world size 1, written out: the plain
    gradient, each leaf of the JAX tree (``reference_leaves``) stacked,
    quantized and dequantized (``quantize_int8`` on the stack), its
    residual carried and rewritten as ``xr - q·s`` rounded once (in
    float64, where it is exact), then ``apply_updates`` on the
    gradients in the parameters' order.  Returns the new optimizer
    state."""
    from repro_torch.distributed import compression as comp
    from repro_torch.models import model as M
    from repro_torch.train import curated
    from repro_torch.train.optimizer import apply_updates
    from repro_torch.train.train_step import value_and_grad
    _, grads = value_and_grad(cfg, model, batch)
    order, deq = list(grads), {}
    for leaf in M.reference_leaves(cfg, order):
        xr = torch.stack([grads.pop(n) + residuals[n] for n in leaf])
        q, s = comp.quantize_int8(xr)
        new = (xr.double() - q.double() * s.double()).float()
        for n, r, d in zip(leaf, new, comp.dequantize_int8(q, s)):
            residuals[n].copy_(r)
            deq[n] = d
        del xr, q, new
    _, opt, _ = apply_updates(M.params_of(model), {n: deq[n] for n in order},
                              opt, curated.OPT)
    return opt


def lm_compressed_replay(torch, dev):
    """Phase 16 (d), its replay: at qwen3-1.7B's width cut to
    ``LM_REPLAY_LAYERS`` layers, two models from one seed step in
    lockstep, one through ``train.compressed``'s step at world size 1,
    the other through :func:`_replay_compressed_step`; after every step
    their parameters, residuals and moments must be equal bit for bit
    (as ``tests/test_torch_compression.py`` holds them on the CPU);
    raising."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import curated, init_opt_state
    from repro_torch.train.compressed import (init_pod_residuals,
                                              make_compressed_train_step)
    from repro_torch.train.data import synthetic_batch
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_REPLAY_LAYERS)
    sides = []
    for _ in range(2):
        model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        params = M.params_of(model)
        sides.append([model, init_opt_state(params, curated.OPT),
                      init_pod_residuals(params)])
    step = make_compressed_train_step(cfg, curated.OPT)
    equal, worst = [], []
    t0 = time.perf_counter()
    for i in range(LM_COMPRESSED_STEPS):
        batch = synthetic_batch(cfg, LM_BATCH, LM_SEQ, i, device=dev)
        a, b = sides
        a[0], a[1], a[2], _ = step(a[0], a[1], a[2], batch)
        b[1] = _replay_compressed_step(torch, cfg, b[0], b[1], b[2], batch)
        pairs = [(M.params_of(a[0]), M.params_of(b[0])), (a[2], b[2]),
                 (a[1]["m"], b[1]["m"]), (a[1]["v"], b[1]["v"])]
        with torch.no_grad():
            equal.append(all(torch.equal(x[k], y[k]) for x, y in pairs
                             for k in x))
            worst.append(max(float((x[k] - y[k]).abs().max())
                             for x, y in pairs for k in x))
    torch.cuda.synchronize()
    n = len(M.params_of(sides[0][0]))
    log(f"[lm-frontend] (d) the compressed step against its replay at world "
        f"size 1 ({cfg.name}'s width, {LM_REPLAY_LAYERS} layers, "
        f"{LM_BATCH}x{LM_SEQ}, {n} tensors in "
        f"{len(M.reference_leaves(cfg, M.params_of(sides[0][0])))} leaves): "
        f"parameters, residuals and moments equal bit for bit after each "
        f"step {equal}; max abs diff {worst}; "
        f"{time.perf_counter() - t0:.1f} s")
    del sides, step, batch, a, b, pairs
    torch.cuda.empty_cache()
    if not all(equal):
        raise AssertionError("(d) the compressed step differs from its "
                             "replay")


def lm_compressed(torch, dev, card):
    """Phase 16 (d): ``train.compressed`` at qwen3-1.7B's width, world
    size 1 on ``nccl``: ``LM_COMPRESSED_STEPS`` steps of the uncompressed
    step, then as many compressed ones, each from the same weights
    (drawn again from the seeded generator) at ``LM_BATCH`` x ``LM_SEQ``;
    every leaf of the JAX tree all-gathered as int8 (with its float32
    scale), the last losses within 5 % (``tests/test_compressed_train.py``'s
    bound); step walls and ``max_memory_allocated``; then
    :func:`lm_compressed_replay`.  The group is made here when none is,
    and destroyed after; raising."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as comp
    from repro_torch.models import model as M
    from repro_torch.train import curated, init_opt_state, make_train_step
    from repro_torch.train.compressed import (init_pod_residuals,
                                              make_compressed_train_step)
    from repro_torch.train.data import synthetic_batch
    cfg = get_config(LM_ARCH)
    own = not dist.is_initialized()
    if own:
        _dist_world1()
    try:
        losses, walls, peaks, gathers = {}, {}, {}, {}
        for mode in ("plain", "compressed"):
            model = M.init_params(cfg, torch.Generator(device=dev)
                                  .manual_seed(0), device=dev)
            params = M.params_of(model)
            opt = init_opt_state(params, curated.OPT)
            res = None
            if mode == "plain":
                step = make_train_step(cfg, curated.OPT)
            else:
                res = init_pod_residuals(params)
                step = make_compressed_train_step(cfg, curated.OPT)
            del params
            comp.reset_gather_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses[mode], walls[mode] = [], []
            for i in range(LM_COMPRESSED_STEPS):
                batch = synthetic_batch(cfg, LM_BATCH, LM_SEQ, i, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "plain":
                    model, opt, m = step(model, opt, batch)
                else:
                    model, opt, res, m = step(model, opt, res, batch)
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
                losses[mode].append(float(m["loss"]))
            peaks[mode] = torch.cuda.max_memory_allocated()
            gathers[mode] = {str(k): v for k, v in
                             comp.gather_counts().items()}
            n_leaves = len(M.reference_leaves(cfg, M.params_of(model)))
            del model, opt, res, step, batch, m
            torch.cuda.empty_cache()
        want = {"torch.int8": n_leaves * LM_COMPRESSED_STEPS,
                "torch.float32": n_leaves * LM_COMPRESSED_STEPS}
        base, got = losses["plain"], losses["compressed"]
        rel = abs(got[-1] - base[-1]) / base[-1]
        for mode in ("plain", "compressed"):
            w = walls[mode]
            log(f"[lm-frontend] (d) {card}: {cfg.name} {mode} step, "
                f"{LM_BATCH}x{LM_SEQ}, world size {dist.get_world_size()} on "
                f"{dist.get_backend()}: losses {losses[mode]}; step "
                f"walls {[round(x * 1e3, 1) for x in w]} ms (steps 2-: "
                f"{1e3 * sum(w[1:]) / (len(w) - 1):.1f} ms a step); "
                f"max_memory_allocated {peaks[mode]} B "
                f"({peaks[mode] / 2**30:.2f} GiB); all-gathers by dtype "
                f"{gathers[mode]}")
        log(f"[lm-frontend] (d) the last compressed loss against the "
            f"uncompressed: rel diff {rel:.3e} (limit 0.05); {n_leaves} "
            f"leaves of the JAX tree a step, each gathered as one int8 "
            f"tensor and its scale: {gathers['compressed'] == want}")
        if gathers["compressed"] != want or rel >= 0.05 or not all(
                math.isfinite(x) for x in got):
            raise AssertionError("(d) the compressed step")
        lm_compressed_replay(torch, dev)
    finally:
        if own:
            dist.destroy_process_group()


def lm_frontends(torch, dev, card):
    """Phase 16: (a) and (b) in turn, each with its (e) (``lm_family``),
    (c) the reduced configs card against CPU, (d) the compressed train
    step."""
    t0 = time.perf_counter()
    for part, arch, seq in LM_FRONTENDS:
        t1 = time.perf_counter()
        lm_family(torch, dev, card, part, arch, None, seq, "[lm-frontend]")
        log(f"[lm-frontend] {arch} wall {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    lm_frontend_card_vs_cpu(torch, dev)
    log(f"[lm-frontend] (c) wall {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    lm_compressed(torch, dev, card)
    log(f"[lm-frontend] (d) wall {time.perf_counter() - t1:.1f} s")
    log(f"[lm-frontend] phase 16 wall {time.perf_counter() - t0:.1f} s")


MESH_STEPS = 6          # (a): the straight run; its checkpoints every 2
MESH_RESUME = 4         # (a): the second call resumes from this step
# (a): qwen3-1.7B's width at 2 layers.  A chip call may write 45 GiB to
# its disk, freed blocks included; a float32 checkpoint of the whole
# model with its moments is 24.4 GB, at 2 layers 4.9 GB (the tied
# [151,936 x 2,048] embedding is most of it), 5 of them 24.6 GB.
MESH_LAYERS = 2
MESH_DT_STEPS = 4       # (b): steps of each of the two train steps
MESH_DRYRUN = (("qwen3_1_7b", "train_4k", "16x16"),
               ("llama4_scout_17b", "decode_32k", "2x16x16"))


def mesh_train_resume(torch, dev, card, arch=LM_ARCH, extra=(),
                      layers=MESH_LAYERS):
    """Phase 17 (a): ``launch.train.main`` at ``arch`` (qwen3-1.7B at
    full width, cut to ``layers`` layers: one rank, no mesh, float32),
    ``LM_BATCH`` x ``LM_SEQ``, ``MESH_STEPS`` steps checkpointed every 2
    (and at step 0); then the last checkpoint is removed and a second
    call resumes from step ``MESH_RESUME``: its losses must equal the
    straight run's bit for bit.  Prints each call's step wall p50,
    tokens/s and peak memory and its whole wall (the checkpoints' writes
    and read included); the checkpoints are removed after.  Raising."""
    import dataclasses
    import shutil
    import signal
    import numpy as np
    from repro_torch.launch import train
    get_config, get_reduced = train.get_config, train.get_reduced
    ck = os.path.join(ROOT, "build", "mesh_train_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    args = ["--arch", arch, "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
            "--save-every", "2", "--steps", str(MESH_STEPS), "--ckpt-dir",
            ck, *extra]
    handler = signal.getsignal(signal.SIGTERM)
    runs, walls = {}, {}
    # The driver's config, depth cut (MESH_LAYERS).
    train.get_config = lambda a: dataclasses.replace(get_config(a),
                                                     n_layers=layers)
    train.get_reduced = lambda a: dataclasses.replace(get_reduced(a),
                                                      n_layers=layers)
    try:
        for name in ("straight", "resumed"):
            if name == "resumed":
                shutil.rmtree(os.path.join(ck, f"step_{MESH_STEPS:08d}"))
            t0 = time.perf_counter()
            runs[name] = train.main(args)
            walls[name] = time.perf_counter() - t0
    finally:
        train.get_config, train.get_reduced = get_config, get_reduced
        signal.signal(signal.SIGTERM, handler)
        shutil.rmtree(ck, ignore_errors=True)
    for name, r in runs.items():
        peak = r["peak_bytes"]
        log(f"[mesh] (a) {card}: launch.train.main {arch} at {layers} "
            f"layers, {name} from step "
            f"{r['start']}, {LM_BATCH}x{LM_SEQ}, {r['device']}, mesh "
            f"{r['mesh']}: losses {r['losses']}; step wall p50 "
            f"{r['p50_s'] * 1e3:.2f} ms ({[round(x * 1e3, 2) for x in r['step_s']]}"
            f" ms); {r['tokens_per_s']:.0f} tokens/s at p50; peak "
            + ("n/a" if peak is None else f"{peak} B ({peak / 2**30:.2f} GiB)")
            + f"; call wall {walls[name]:.1f} s (checkpoints included)")
    want = runs["straight"]["losses"][MESH_RESUME:]
    got = runs["resumed"]["losses"]
    same = (runs["resumed"]["start"] == MESH_RESUME and len(got) == len(want)
            and all(np.float32(a).tobytes() == np.float32(b).tobytes()
                    for a, b in zip(got, want)))
    log(f"[mesh] (a) resumed at step {runs['resumed']['start']}: losses "
        f"{got} against the straight run's {want}: equal bit for bit {same}")
    if not same or not all(math.isfinite(x)
                           for x in runs["straight"]["losses"]):
        raise AssertionError("(a) the resumed run differs from the straight "
                             "run")


def mesh_dtensor_step(torch, dev, card, cfg=None):
    """Phase 17 (b): the train step (``train.make_train_step``, the
    driver's optimizer) at qwen3-1.7B's width, float32, ``LM_BATCH`` x
    ``LM_SEQ``, ``MESH_DT_STEPS`` steps from the same seeded weights,
    first on plain tensors, then with the parameters, the optimizer state
    and every batch DTensors placed by ``launch.specs`` on a (1, 1)
    ``("data", "model")`` mesh over a world size 1 ``nccl`` group (the
    mesh set): step walls side by side (the difference is DTensor's host
    dispatch), losses within rtol 1e-4 (the CPU tests' train bound;
    raising) and whether their bits are equal.  The group is made here
    when none is, and destroyed after."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import specs
    from repro_torch.models import model as M
    from repro_torch.train import (OptConfig, init_opt_state,
                                   make_train_step, synthetic_batch)
    cfg = cfg or get_config(LM_ARCH)
    ocfg = OptConfig(lr=1e-3, warmup_steps=20, moment_dtype=cfg.moment_dtype)
    shape = ShapeConfig("train", LM_SEQ, LM_BATCH, "train")
    own = not dist.is_initialized()
    if own:
        _dist_world1()
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        losses, walls = {}, {}
        for mode in ("plain", "dtensor"):
            model = M.init_params(cfg, torch.Generator(device=dev)
                                  .manual_seed(0), device=dev)
            opt = init_opt_state(M.params_of(model), ocfg)
            if mode == "dtensor":
                sharding.set_mesh(mesh)
                specs.place_model(model, specs.param_shardings(cfg, model,
                                                               mesh))
                opt = specs.place_tree(opt, specs.opt_shardings(cfg, opt,
                                                                mesh))
            step = make_train_step(cfg, ocfg)
            losses[mode], walls[mode] = [], []
            try:
                for i in range(MESH_DT_STEPS):
                    batch = synthetic_batch(cfg, LM_BATCH, LM_SEQ, i,
                                            device=dev)
                    if mode == "dtensor":
                        batch = specs.place_tree(batch, specs.batch_shardings(
                            cfg, shape, batch, mesh))
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, opt, m = step(model, opt, batch)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    walls[mode].append(time.perf_counter() - t0)
                    losses[mode].append(float(sharding.to_local_full(
                        m["loss"])))
            finally:
                sharding.clear()
            del model, opt, step, batch, m
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        p50 = {k: float(np.median(v[1:])) for k, v in walls.items()}
        for mode in ("plain", "dtensor"):
            log(f"[mesh] (b) {card}: {cfg.name} train step, {mode}, "
                f"{LM_BATCH}x{LM_SEQ}, float32, world size "
                f"{dist.get_world_size()} on {dist.get_backend()}: losses "
                f"{losses[mode]}; step walls "
                f"{[round(x * 1e3, 2) for x in walls[mode]]} ms, p50 of "
                f"steps 2- {p50[mode] * 1e3:.2f} ms")
        bits = losses["plain"] == losses["dtensor"]
        log(f"[mesh] (b) DTensor on the (1, 1) mesh against plain tensors: "
            f"step p50 {p50['dtensor'] * 1e3:.2f} ms against "
            f"{p50['plain'] * 1e3:.2f} ms ({p50['dtensor'] / p50['plain']:.3f}"
            f"x); losses equal bit for bit {bits}")
        np.testing.assert_allclose(losses["dtensor"], losses["plain"],
                                   rtol=1e-4)
    finally:
        if own:
            dist.destroy_process_group()


def mesh_dryrun(cells=MESH_DRYRUN, reduced=False):
    """Phase 17 (c), a part of its own (``PARTS``): ``launch.dryrun``'s
    cells ``cells`` on a fake group of 512 ranks (meta tensors; no card
    needed): status ``ok`` (raising otherwise), per-device argument
    bytes, FLOPs and collectives by kind, and each cell's seconds."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    dryrun.init_fake_group(512)
    try:
        for arch, shape, mesh in cells:
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, mesh, reduced=reduced)
            rec.pop("trace", None)
            log(f"[mesh] (c) dry run {arch} x {shape} on {mesh}: "
                f"{json.dumps(rec)}; {time.perf_counter() - t0:.1f} s")
            if rec["status"] != "ok":
                raise AssertionError(f"(c) dry run {arch} {shape} {mesh}: "
                                     f"{rec.get('error')}")
    finally:
        dist.destroy_process_group()


def mesh_paths(torch, dev, card):
    """Phase 17: the mesh layer, (a) and (b); (c) runs beside phase 11
    (a) as a part."""
    t0 = time.perf_counter()
    mesh_train_resume(torch, dev, card)
    log(f"[mesh] (a) wall {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    mesh_dtensor_step(torch, dev, card)
    log(f"[mesh] (b) wall {time.perf_counter() - t1:.1f} s")
    log(f"[mesh] phase 17 wall {time.perf_counter() - t0:.1f} s (its (c) "
        f"runs beside phase 11)")


# Phase 18: the graph contracts of the hot entry points (ROADMAP A32).
GRAPH_KERNELS = ("pairwise", "build_g", "swap_g", "swap_g_from_cache",
                 "stream_build_g", "stream_swap_g", "top2")


def budgets_held(budget_lines) -> int:
    """The budget keys phase 11 (b) measured under their bounds (its
    ``[budget]`` lines that say so)."""
    return sum(1 for ln in budget_lines
               if ln.startswith("[budget] ") and "under the bound: True; "
               "materialised over it: True" in ln)


def graph_paths(torch, dev, card, budget_lines):
    """Phase 18: the graph registry on the card (``backend="cuda"``),
    raising on any finding, on a missing golden for this key, on fewer
    than every budget key held by phase 11 (b), and unless the census
    launches all seven kernels."""
    from repro_torch.analysis import budgets
    from repro_torch.analysis.graph import rules, survey
    t0 = time.perf_counter()
    golden = survey.load_golden(survey.default_golden_path())
    key = survey.golden_key(dev)
    if survey.golden_for_key(golden, key) is None:
        raise AssertionError(f"no committed graph golden for {key}; "
                             f"have {sorted(golden['goldens'])}")
    # backend "cuda" on the card (the plain "torch" where a rehearsal
    # runs it on the CPU)
    report, prints = rules.analyze(device=dev,
                                   backend=rules.default_backend(dev),
                                   golden_doc=golden, with_budgets=False)
    launched = {}
    for name in report.entrypoints:
        d = report.details[name]
        for kn, v in d["launches"].items():
            launched[kn] = launched.get(kn, 0) + v
        counts = ", ".join(f"{kn} {v}"
                           for kn, v in sorted(d["launches"].items()))
        log(f"[graph] {name}: launches {counts or 'none'}"
            + f"; transfers {d['transfers']}; collectives "
            f"{d['collectives'] or 'none'}; narrowing casts "
            f"{d['narrowing']}; ops {d['ops']}; hash "
            f"{prints[name]['hash']}; wall {d['wall_s']:.3f} s")
    for note in report.notes:
        log(f"[graph] note: {note}")
    held = budgets_held(budget_lines)
    n_keys = len(budgets.budget_names())
    log(f"[graph] GRC001: phase 11 (b) measured {held} of {n_keys} budget "
        f"keys under their bounds (the budgets part)")
    log(f"[graph] census launches over the registry: "
        + ", ".join(f"{kn} {launched.get(kn, 0)}" for kn in GRAPH_KERNELS))
    if report.findings:
        raise AssertionError("graph findings:\n"
                             + rules.format_human(report))
    if held != n_keys:
        raise AssertionError(f"GRC001: {held} of {n_keys} budget keys held")
    missing = [kn for kn in GRAPH_KERNELS if not launched.get(kn)]
    if missing:
        raise AssertionError(f"the registry launched no {missing}")
    log(f"[graph] 0 findings across {len(report.entrypoints)} entrypoints "
        f"({key}; {card}); phase 18 wall {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "repro_torch", "kernels", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(repro_torch/ not found)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--part"]:
        return run_part(sys.argv[2])
    sys.path.insert(0, ROOT)
    import numpy as np
    from repro_torch.core.datasets import mnist_like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {card}")
    phase_build()
    t0 = time.perf_counter()
    Xnp = mnist_like(N_FIT + N_QUERY, seed=0)
    X = torch.from_numpy(Xnp).to(dev)
    log(f"[data] mnist_like({N_FIT + N_QUERY}, d=784) made in "
        f"{time.perf_counter() - t0:.1f} s")
    t3 = time.perf_counter()
    rows = (kernel_checks(torch, X, dev) + stream_checks(torch, X, dev)
            + cached_checks(torch, X, dev))
    log(f"[kernel] phase 3 wall {time.perf_counter() - t3:.1f} s")
    t4 = time.perf_counter()
    fit_parity(torch, X, dev)
    driver_parity(torch, X, dev)
    log(f"[parity] phase 4 wall {time.perf_counter() - t4:.1f} s")
    t5 = time.perf_counter()
    counts, perm_fit = main_path(torch, X, dev, Xnp)
    driver_paths(torch, X, Xnp, perm_fit, counts)
    counts_exact, pam_fit = exact_paths(torch, X, dev, Xnp, perm_fit)
    counts_pic = pic_paths(torch, X, dev, Xnp, pam_fit)
    log(f"[main] phase 5 wall {time.perf_counter() - t5:.1f} s")
    t6 = time.perf_counter()
    threefry_answers(torch, dev)
    counts_solvers = solver_paths(torch, X, dev, Xnp, pam_fit)
    solver_kernel_times(torch, X, dev)
    log(f"[solvers] phase 6 wall {time.perf_counter() - t6:.1f} s (its "
        f"parity, (c) and (d), runs beside phase 11)")
    t7 = time.perf_counter()
    counts_serve, graph_row = serve_path(torch, X, dev, Xnp)
    serve_parity(torch, dev)
    # serve_path set the counts to 0 before the phase's first launch.
    from repro_torch.kernels import ops
    counts_phase7 = ops.launch_counts()
    log(f"[serve] phase 7 wall {time.perf_counter() - t7:.1f} s")
    t8 = time.perf_counter()
    lane_rows = batch_paths(torch, dev)
    log(f"[batch] phase 8 wall {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    counts_dist, dist_reports = dist_paths(torch, X, dev, Xnp, pam_fit)
    log(f"[dist] phase 9 wall {time.perf_counter() - t9:.1f} s")
    tile_paths(torch, X, dev, Xnp, card)
    part_lines = guard_paths(torch, dev, Xnp, card, dist_reports)
    lm_rows = lm_paths(torch, dev, card)
    data_rows = data_paths(torch, dev, card)
    lm_families(torch, dev, card)
    lm_frontends(torch, dev, card)
    mesh_paths(torch, dev, card)
    graph_paths(torch, dev, card, part_lines["budgets"])
    # Each kernel's launches come from one run of its own path: the
    # default fit + predict, (streaming kernels) the replacement + leader
    # fit, or (swap_g_from_cache) the full-ring PIC fit; PAM's and the
    # default-ring PIC fit's counts are printed beside them.
    for row in rows:
        src = (counts_exact["replacement+leader"]
               if row["name"].startswith("stream_")
               else counts_pic["pic_full"]
               if row["name"] == "swap_g_from_cache" else counts)
        row["launches"] = src[row["name"]]
    log("[launches] kernels line: fit + predict (pairwise, build_g, swap_g, "
        "top2); replacement+leader fit (stream_build_g, stream_swap_g); "
        "full-ring PIC fit (swap_g_from_cache); PAM: "
        + ", ".join(f"{nm} {counts_exact['pam'][nm]}"
                    for nm in ("stream_build_g", "stream_swap_g"))
        + "; default-ring PIC fit: swap_g_from_cache "
        + str(counts_pic["pic"]["swap_g_from_cache"]))
    log("[launches] phase 6, each solver's full-size fit: " + "; ".join(
        f"{name} " + ", ".join(f"{nm} {c[nm]}" for nm in sorted(c) if c[nm])
        for name, c in counts_solvers.items()))
    log("[launches] phase 7, the service's fit, requests and stream: "
        + ", ".join(f"{nm} {counts_serve[nm]}" for nm in sorted(counts_serve)
                    if counts_serve[nm])
        + "; the whole phase (with the refit pair, the two resumed services "
        "and the cuda service on code_blobs): "
        + ", ".join(f"{nm} {counts_phase7[nm]}"
                    for nm in sorted(counts_phase7) if counts_phase7[nm]))
    log("[launches] phase 8, the ragged batch (b): " + ", ".join(
        f"{r['name']} {r['launches']}" for r in lane_rows))
    log("[launches] phase 9, the resident sharded fits at world size 1 (a): "
        + "; ".join(f"{name} " + ", ".join(f"{nm} {c[nm]}" for nm in sorted(c)
                                          if c[nm])
                    for name, c in counts_dist.items()))
    log("[launches] phase 12, curate_weights at qwen3-1.7B's width: "
        + ", ".join(f"{r['name']} {r['launches']}" for r in lm_rows))
    log(f"[launches] phase 7, the 256-row bucket's graph: top2 "
        f"{graph_row['launches']} replays; phase 14, the scRNA l1 fit: "
        + ", ".join(f"{r['name']} {r['launches']}" for r in data_rows))
    log(f"[env] whole run wall {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows + lane_rows + lm_rows + [graph_row]
                    + data_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
