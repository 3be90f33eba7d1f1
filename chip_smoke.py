#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py [--seed 0] [--against DIR]

Phases (each raises on failure; nothing catches it, so a failed phase
never exits 0):

1. Environment: the card's name and power limit (nvidia-smi), the
   device name and compute capability, which must be (9, 0).
2. Build: every kernel source under ``ccsc_code_iccv2017_torch/csrc/``
   (K1 ``solve_z_rank1.cu``, K2 ``fused_z.cu``) with nvcc, one process
   per source, and the native preprocessing library
   (``native/ccsc_data.cpp``, g++, into the port's build directory), all
   started together, timed; the ``-Xptxas -v`` registers, shared memory
   and spills.
3. K1 vs plain: K1 against its plain torch version on the card at the
   serving slice's full shapes (K=100, F=266*134, N in {1, 4}; dinv =
   1/rho and with one raised row as the Poisson dirac regularization
   makes it), at the learner composition path's (N=800, K=100,
   F=110*56), and at one case per branch of ``k1_launch_plan``: K in
   {1, 7, 100, 105, 300} at N=45, F=6161 (each register
   instantiation's edge and the generic loop, a partial frequency
   tile, one image per block), and K in {100, 300} at N=13, F=266*134
   (8 images per block, the last chunk partial), and at the serving
   engine's other slot counts, N in {2, 8} at the serve shape: max|dz|/
   max|z| <= 1e-5 and two launches bitwise equal in every case; each
   case prints its plan and its kernel, plain-version, bound and
   xi2-copy times. With
   ``--against DIR`` the K1 of the checkout at DIR (an older commit
   unpacked there) is timed beside this one at the main path's shapes
   (N in {1, 4, 800}), for an A/B in one process. Then K1 at the two
   W == 1 apps' shapes, on the filter spectra and dinv their own solves
   build: Poisson deconvolution (N=1, K=101 with the appended dirac,
   F=266*134, dinv with the dirac row's gradient diagonal) and video
   deblurring (N=1, K=50 with the prepended dirac, the 3x3x3 blur
   composed in, F=138*138*22 = 418,968 over a 3D spectrum: dhat and dinv
   exceed half the L2), held and timed the same way.
4. Slice 1 serves requests: the repo's k=100 11x11 bank, 4 synthetic
   256x256 images (Gaussian-smoothed noise from --seed), 50% masks and
   the smooth-fill warm start, one ``build_plan``, then 4 requests
   through ``reconstruct(plan=...)`` at max_it=100, tol=1e-3. K1's
   launch count is set to 0 just before and must grow by exactly the
   iterations served.
5. Slice 1 card vs CPU: request 0 at max_it=10, tol=0 on both devices;
   the objective traces agree to rtol 1e-4 and the reconstructions to
   1e-4 * max|b|.
6. K2 vs plain: the fused z-iteration (K2a + K2b) against its plain
   torch version on the card, at (N=4, K=100, 110x110) in float32 and
   bfloat16 state, and in float32 at shapes that take each branch of
   the kernels' P x Q split plan: (N=3, K=6, 9x9) splits 3x3 on both
   axes; (N=2, K=5, 15x12) has an odd Sy (an unpaired packed row) and
   splits 3x5 and 3x4; (N=2, K=3, 13x11) is prime on both axes (the
   dense routines); (N=2, K=3, 38x20) is dense on y (38 = 2x19) and
   splits 4x5 on x. The main path's filters and data throughout, but
   for one case, (N=2, K=3, 12x10), with random complex dhat and bhat:
   spectra that are not Hermitian, whose DC and Nyquist bins carry
   imaginary parts that the inverse row transform drops, as irfft does.
   Limits: float32 max|dz'|/max|z'| <=
   1e-5 and max|ddual'|/max|dual'| <= 1e-6; bfloat16 |dz'| <= 0.02
   max|z'|; two launches on the same inputs give the same bits. One
   more case at (N=4, K=100, 110x110) takes noise spectra over the whole
   plane, where the rank-1 correction cancels by orders of magnitude:
   there the kernels are held to the plain version run in float64,
   max|dz'|/max|z'| <= 3e-5 (float32 reaches ~0.8e-5 by FFT). Then, at
   the learner's full launch shape (N=800, K=100, 110x110, float32), K2a
   and K2b each timed against their plain passes and their bounds
   (formulas printed), and one z-iteration of the composition path
   (cuFFT + K1 + elementwise) as the yardstick; and at a rank's launch
   shape on ``block_mesh(4)`` (N=200, phase 15 (a)), held at the same
   limits and timed the same way.
7. Slice 2 learns at full width: k=100 11x11 filters, 8 consensus
   blocks x 100 synthetic 100x100 images (Gaussian-smoothed noise from
   --seed, local_cn and zero mean by the native library), max_it_d=5,
   max_it_z=10, fused_z,
   3 outer steps at tol=0 through ``parallel.consensus.learn``. K2a's
   and K2b's launch counts are set to 0 just before and must each equal
   max_it_z x the steps adopted; every trace value is finite, obj_z
   falls from step 1 to step 3 and every filter norm is <= 1 + 1e-5.
8. Fused vs composition: the same configuration on 2 blocks x 8
   images, 2 outer steps, fused_z True and False from the same init:
   objective traces within rtol 1e-4, filters within 1e-4 max|d|; K1
   launches only in the composition run, K2 only in the fused one.
9. Slice 2 card vs CPU: k=16 11x11, 2 blocks x 2 images of 48x48, 2
   outer steps, fused on both devices (the kernels on the card, their
   plain version on the CPU) from one init: objective rtol 1e-4,
   filters 1e-4 max|d|.
10. Slice 3 serves through the engine: the k=100 11x11 bank behind a
   ``CodecEngine`` with one bucket of 4 slots at 256x256 (warmed at
   construction); 40 requests of 256x256 and 2 of 240x240 (padded into
   the bucket), Gaussian-smoothed noise from --seed, 50% masks, the
   smooth-fill warm start, max_it=100, tol=1e-3, all submitted at once:
   10 full dispatches and one with 2 filler slots (first or last, as the
   submits arrive within ``max_wait_ms``).
   K1's launch count is set to 0 just before and must equal the sum
   over dispatches of the iterations each ran. Then the same requests
   through one ``reconstruct(plan=...)`` call each (``serve/bench.py``'s
   direct-call loop): every 256x256 request stops at the same iteration and
   agrees within 1e-4 * max|b|, every padded one within 1e-3 * max|b|
   on its valid region, and every served PSNR beats its smooth fill.
   The record gives requests/s over the window and over the full
   dispatches alone, and latency p50, p90 and max.
11. The four other reconstruction apps at full width, each through its
   ``run`` (what its ``main`` calls) with the repo's banks and the
   reference protocol's parameters (the apps' defaults): Poisson
   deconvolution (the k=100 11x11 bank plus its dirac, 4 synthetic
   256x256 images from a .mat stack, 50 iterations), video deblurring
   (the k=49 11x11x11 bank, a synthetic 128x128x32 clip, 120
   iterations), hyperspectral demosaicing (the k=100 11x11x31 bank, a
   synthetic 31x256x256 cube, W=31, 200 iterations) and lightfield view
   synthesis (the k=49 5x5x11x11 bank, a synthetic 5x5x256x256
   lightfield, W=25, 200 iterations); data from --seed. Each: finite
   recon and objective, the objective at the last iteration below
   iteration 0's; K1's launch count set to 0 just before each app and
   equal to its iterations for Poisson and deblurring (0 for the W > 1
   apps); wall, solve time, ms an iteration, PSNR beside the app's own
   baseline and peak device memory; for the W > 1 apps one iteration's
   z-solve and the one-off build of its factors by CUDA events, beside
   the solve's byte bound. Then each app again at a reduced size
   (Poisson 64x64, deblurring 32x32x12, demosaicing 31x48x48, view
   synthesis 5x5x48x48), 20 iterations at tol=0, on the card and on
   the CPU: the same iterations, objective traces within rtol 1e-4 and
   reconstructions within 1e-4 of the CPU reconstruction's scale.
12. The learners at the reference protocol's widths, data from --seed,
   each cut to 2 outer steps at tol=0 (the reference runs 20 or 40),
   every launch count set to 0 just before each learner and read just
   after: the 3D video learner through ``learn_3d.main`` (k=49
   11x11x11, 64 synthetic clips of 50^3 in 8 blocks, rho 5000/1,
   max_it_d=5, max_it_z=10; its filters and codes saved to a .mat): K1
   launched 10 times a step and K2 never, obj_z falls from step 1 to
   step 2; then K1 at its z-solve shape (N=64, K=49, F=60*60*31 =
   111,600) on the learned filters' and the clips' spectra, held and
   timed as in phase 3, and for K1_F64_DRAWS draws of the code target
   both K1 and its plain version held to the same solve in float64. The
   4D lightfield learner through
   ``learn_4d.main`` (k=49 11x11 over 5x5 views, 64 patches of 50x50 in
   8 blocks, rho 500/50; W = 25, no K1): obj_z falls, and the W = 25
   z-solve of the 64 patches timed as in phase 11. The hyperspectral
   masked learner through ``learn_hyperspectral.main`` (k=100 11x11x31,
   gamma divisors 5000/500, the Gaussian smooth_init offset) on 16
   synthetic cubes of 31x100x100 (the cut: the reference's training data
   is absent) read from a .mat: whether its rollback fired, and the W =
   31 z-solve of the 16 cubes timed. ``learn_2d --masked`` (k=100 11x11,
   16 synthetic 100x100 images): K1 launched 10 times each step it ran.
   Each: finite traces, every filter (or filter slice) in the unit ball,
   steps/s, d-pass and z-pass ms, peak memory. Then each of the three at
   a reduced size (3D 4 clips of 12^3, 4D 4 patches of 16x16x5x5, HS 2
   cubes of 31x48x48; k=8 5x5(x5)) for 2 steps from one init drawn on
   the CPU, on the card and on the CPU: objective traces within rtol
   1e-4 and filters within 1e-4 of their scale, or 4x the spread one
   float32 ulp of the initial dictionary puts into the CPU run where
   that is larger. These card runs of the 3D and 4D learners set
   fused_z=True: the gate routes both to the composition path, so K1
   launches 10 times a step for 3D, never for 4D, and K2 never.
13. The host-streaming learner (``parallel.streaming``). The rate of a
   blocking 1 GiB copy from pageable host memory each way. The 2D north
   star of phase 7 (fused_z off: the streaming learner never runs K2),
   STREAM_STEPS outer step through the in-memory learner and then in
   each placement tier (device, kern, paged), from one host init: the
   tiers within 1e-6 of each other, the streamed run within 2e-5 of
   max(1, each field's scale) (d, z, Dz) and rtol 1e-4 (objectives) of
   the in-memory one, K1 launched max_it_z x 8 blocks x steps in each
   tier and K2 never; per tier steps/s, d-pass and z-pass ms, peak
   memory and the bytes copied each way a step. K1 at a 2D block's
   shape (N=100, K=100, F=110*56), held and timed as in phase 3. The 3D
   learner of phase 12 through ``learn_3d.main --streaming --stream-mode
   paged`` for one step: its peak memory below phase 12's in-memory
   peak, K1 launched max_it_z x 8 times; then K1 at a block's shape
   (N=8, K=49, F=111,600) on the learned filters and block 0's clips,
   held and timed as in phase 3. The hyperspectral app at phase 12's
   width with ``--streaming --streaming-blocks 4`` (the W = 31 solve,
   the auto tier): no K1, Dz finite and within 1e-4 of the returned
   codes' reconstruction plus the smooth_init offset. Both learners
   paged on the card against the CPU at reduced sizes, at phase 12's
   card-vs-CPU limits. The native library: available, its local_cn
   (64 images of 100x100) within 5e-3 and its smooth fill (phase 4's
   requests) within 2e-5 of numpy, both timed beside numpy.
15. The meshes (``parallel.mesh``, ``parallel.distributed``; run before
   the output of 14), as SPMD ranks started by ``distributed.launch``:
   (a) the north star of phase 7 (8 blocks x 100 images, fused_z) for 2
   outer steps on ``block_mesh(4)``, four ``gloo`` ranks sharing cuda:0
   (2 blocks each, K2 at N=200), beside the one-card learner from the
   same init (``parallel.mesh_check.run``): filters within 2e-5, traces
   rtol 1e-4, the codes gathered on rank 0 within 2e-5 of max(1, max|z|),
   K2a/K2b launched max_it_z x steps on every rank; per rank peak memory,
   d-pass and z-pass ms, the consensus all-reduce's ms per d-iteration.
   (b) The 4 requests of phase 4 (max_it=100, tol=1e-3) solved as one
   batch by ``reconstruct(mesh=)`` on ``block_mesh(4)`` and on a (2, 2)
   batch x freq mesh against the one-device solve: the same iterations
   on every rank, K1 launched once an iteration on every rank, objective
   rtol 1e-4, reconstructions 1e-4 x max|b|; then K1 at the per-rank
   shapes (N=1 of F=266*134; N=2 of F/2) held and timed as in phase 3.
   (c) The consensus learner on ``block_freq_mesh(2, 2)`` (K1 on F/2 bins
   per rank) and ``block_filter_mesh(2, 2)`` (the plain z-solve body, no
   K1) at the north star's widths (k=100 11x11, images of 100x100) on
   4 blocks x 10 images, and the masked learner on ``freq_mesh(4)`` at
   the hyperspectral app's (k=100 11x11x31, cubes of 31x100x100) on 4
   cubes, 2 steps each against the one-device runs at (a)'s limits,
   K1's launches per rank exact; per rank time and peak memory. (d) One NCCL process group of world size 1 in this
   process (``block_mesh(1)``): one learner step (K2) and one
   reconstruct through the mesh code, within 1e-6 of the mesh-less
   calls. Every group has a timeout and ``launch`` a join deadline; a
   failed rank fails the phase.
16. Mesh serving (``serve.CodecEngine`` with ``ServeConfig.mesh_shape``;
   run after 15, before the output of 14): (a) phase 10's 42 requests
   through the single-device engine, a (2,) engine with
   ``mesh_devices=(0, 0)`` and a (2, 2) batch x freq engine with
   ``mesh_devices=(0, 0, 0, 0)``: the positions share cuda:0, each on
   its own thread and stream. Each request of a mesh engine against the
   single-device engine's: the same iterations and within 1e-4 *
   max|b| at the bucket's shape, 1e-3 * max|b| padded. K1's count is
   set to 0 just before each engine's stream and must equal the sum
   over dispatches and positions of the positions' loop iterations;
   on (2, 2) every position all-gathers once an iteration, on (2,)
   never. Requests/s over the window and over full dispatches, latency
   p50/p90/max, per engine. (b) K1 at the positions' shapes (N=2 of
   F=266*134 for (2,); N=2 of F/2 for (2, 2)) held and timed as in
   phase 3. (c) K2's plane-size gate: ``ops.fused_z.smem_bytes`` equals
   the library's ``ccsc_fused_z_smem_bytes`` for every Sy, Sx in
   16..300 and both passes; one ``learn_2d``-configured consensus step
   (k=100 11x11, 2 blocks x 4 images of 256x256: 266x266 planes, above
   K2's limit) with fused_z=True runs without raising, launches K1
   max_it_z times and K2 never, and its filters and obj_z equal, bit
   for bit, the same step with fused_z=False.
17. Run telemetry (``utils.obs``; run after 16, before the output of
   14): (a) phase 7's learner (its configuration and seed) for
   TEL_STEPS=2 steps five times: plain, with ``metrics_dir`` twice,
   plain again (ABBA: the mean step of each pair), and with
   ``metrics_dir`` and ``profile_dir``; the step's telemetry scalars
   (``learn.obs_extras``) are timed alone on the card. K2a and K2b
   launch max_it_z x 2 times in each; every record carries the fields
   ``analysis/obs_schema.py`` requires; 2 ``step`` records with
   ``nonfinite_z`` 0 and obj_fid + obj_l1 = obj_z (rel 1e-5); each
   ``roofline`` record on the ``h100`` row with 0 < hbm_frac <= 1.05 and a
   positive bound; one ``mem_watermark`` whose ``peak_hbm_bytes`` equals
   ``torch.cuda.max_memory_allocated()`` read right after the run (the
   phase resets the peak before it); one ``summary`` with status ok; d
   and the traces bitwise the plain run's, and the plain run's traces
   bitwise phase 7's first 2 steps (if phase 7 does not repeat bit for
   bit, the telemetry runs are held to the plain run's spread from it
   and the finding printed); the profiler trace holds as many K2a and
   K2b kernel events (``profile_solve.kernel_kind``) as the counters.
   (b) Phase 10's 42 requests through a 4-slot 256x256 engine three
   times: plain (this phase's baseline), with ``metrics_dir``, and with
   ``metrics_dir``, ``slo_p99_ms=0.001``, ``slo_check_s=0.001`` and
   ``slo_profile_dir``. Each: K1 launched the dispatches' iterations,
   every request bitwise phase 10's, ``stats()`` p50 and p99 each
   within one histogram bucket of the exact value (the p50 lies below
   the max, where the clamp does not answer); with a stream, 42 complete span
   trees {request, engine_queue, solve}, one ``serve_request`` per
   request and one ``serve_dispatch`` per dispatch, matching the
   dispatch log; with the SLO, exactly one ``slo_profile``, whose trace
   holds as many K1 kernel events as its dispatch's iterations.
   Requests/s over the window and over the dispatches beside phase
   10's. (c) One 256x256 request through
   ``reconstruct(plan=...)`` untraced and with ``SolveConfig(
   metrics_dir=)``: bitwise the same, K1 launched its iterations both
   times, ``step`` records 1..n_it and ``summary.iterations`` n_it. (d)
   ``learn_3d --synthetic --metrics-dir`` in a fresh process (1 step):
   its stream validates and holds one ``compile`` record, kind
   ``load``, for ``solve_z_rank1`` (built in phase 2), and no ``build``.
18. Robustness (``utils.watchdog``, ``utils.faults``, the degrade ladder
   of ``apps._common.dispatch_learn``, the ``supervise`` module,
   ``serve.capture``, ``analysis.ledger``; run after 17, before the
   output of 14): (a) phase 17's learner (phase 7's configuration and
   seed, TEL_STEPS steps) plain, with ``watchdog=True`` twice and plain
   again (ABBA), ``CCSC_WATCHDOG_ACTION=event``: every run bitwise phase
   17's plain run, K2a/K2b launched as in it, no stall; the derived
   per-iteration deadline printed. (b) The same learner with
   ``CCSC_FAULT_NAN_IT=2`` and ``max_recoveries=1`` for ROB_NAN_STEPS
   steps: one entry in ``trace['recoveries']``, one ``fault_fired`` and
   one ``recovery`` record, a retried step's K2 launches, finite results;
   phase 9's reduced problem under the same fault on the card and the
   CPU from one init within 1e-4. (c) ``CCSC_FAULT_HANG_IT=1`` sleeping
   ROB_HANG_S under a watchdog whose deadline is ROB_HANG_MIN_S, event
   mode: exactly one ``stall`` record and the run bitwise the plain
   one. (d) ``python -m ...supervise -- ...apps.learn_2d --watchdog``
   at the north star's width on ROB_SUP_NI images a block (data the
   phase writes as a .mat stack): a hang at step 2 is aborted with exit
   87 and resumed from the step-1 checkpoint; a SIGTERM at step 1
   checkpoints, exits 0 and is resumed; both final filters bitwise the
   unfaulted ``learn_2d`` run's; the supervisor trace's attempts and
   the restart gap printed. (e) ``learn_2d --auto-degrade`` on phase
   7's data (1 step) in a child whose allocator is capped at
   ROB_OOM_CAP_GIB (``torch.cuda.set_per_process_memory_fraction``): the
   in-memory learner raises ``torch.OutOfMemoryError``, the forensic
   dump and its ``mem_oom_dump`` record, one ``degrade`` record
   (``streaming``, ``dispatch``), the run completes as
   ``consensus_streaming`` (``CCSC_STREAM_MODE=device``) with filters
   bitwise a direct ``learn_streaming`` run of that tier; with
   ``CCSC_INMEM_HBM_GB=1`` the ladder steps down at the preflight and no
   in-memory run starts. (f) Phase 10's 42 requests through a 4-slot
   256x256 engine with ``capture_dir``: 42 request records whose payload
   SHAs are the inputs', ``load_payload`` round-trips, outcome digests
   the results', every result bitwise phase 10's, K1 launched the
   dispatches' iterations; the captured payloads replayed under the
   captured solve params through a fresh engine, every result bitwise
   phase 10's; requests/s beside phase 10's and the capture's ms a
   request. (g) With ``CCSC_PERF_LEDGER`` a temporary file during (a)'s
   second armed run and (f)'s engine: one ``learn`` record keyed
   ``h100`` with ``roofline_frac`` and ``peak_hbm_bytes``, one
   ``warmup`` record, ``Ledger`` reads both, ``gate`` passes, the repo's
   ``perf_ledger.jsonl`` untouched.
19. The serving fleet (``serve.ServeFleet``, ``serve.registry``,
   ``serve.tenancy``, ``serve.quality``, ``serve.metricsd``,
   ``apps.serve``; run after 18, before the output of 14), its
   replicas sharing cuda:0, every replica engine the fleets build
   (restarts included) recorded so K1's count, set to 0 just before
   each part, is held to their dispatch iterations plus one warm
   iteration for each engine built inside the part. (a) Two replicas
   serve phase 10's 42 requests, each under an idempotency key: every
   result bitwise phase 10's; requests/s, latency p50/p90/max (submit
   to result), each replica's served count. (c) The ceiling the
   monitor derives from ``fleet_serving_bound`` over the replicas'
   measured iteration rates. (d) ``publish_bank`` of a second k=100
   11x11 bank (a seeded perturbation of the first, renormalized into
   the unit ball) between two submits of 12 requests: the first 12
   bitwise phase 10's, the next 12 bitwise a fresh engine on the new
   bank, one fleet ``bank_swap`` record with both digests. (g) The
   fleet's ``MetricsD`` on 127.0.0.1:<ephemeral>, scraped over HTTP:
   its counters equal ``stats()``. (b) A fresh fleet with
   ``CCSC_FAULT_ENGINE_KILL_REQ`` on replica 0 and
   ``CCSC_FAULT_ENGINE_HANG_REQ`` (FLEET_HANG_S) on replica 1, the
   watchdog's floor and first-fence allowance FLEET_MIN_S: the
   42 keys delivered once each, bitwise phase 10's; ``fleet_replica_
   dead`` (crash, stall), ``fleet_requeue``, ``fleet_replica_restart``
   / ``_ready`` and ``fleet_duplicate_suppressed`` read back from the
   stream; the restart's wall time. (c) ``max_queue_depth``
   FLEET_QUEUE_DEPTH: the burst refused with ``Overloaded`` and a
   positive ``retry_after_s``, the admitted requests bitwise phase
   10's, the ladder's ``fleet_overload`` transitions through ``reject``
   back to ``normal``. (e) Tenants steady (weight 2) and burst (weight
   1, quota FLEET_BURST_QUOTA), the burst submitted first: only the
   burst is refused, every result bitwise phase 10's, both tenants' SLO
   percentiles in ``stats()``. (f) On that fleet the quality plane: its
   ``quality_*`` records, and the golden probes (``probe_dir``, a sweep
   every FLEET_PROBE_S s while idle) sealed, then judged exact. (j)
   Bank rot on the same fleet with a temporary perf ledger: a bank id
   published with the first bank and its served dB (FLEET_ROT_REQS
   requests of ``quality.synth_probe`` content) seeded as ledger
   history, then a degraded bank (every atom one blur) published on it:
   a ``quality_probe_breach``, a probe advisory naming the good digest,
   a ``quality_drift``; swapped back, the requests bitwise their
   pre-rot results. (i) A gray replica: replica 0 FLEET_SLOW_S slower a
   request (far under the watchdog's floor), hedging after
   FLEET_HEDGE_MS: hedges fire, the healthy replica wins some
   (``hedge_win``), every won hedge's original and every losing clone a
   ``hedge_lost``, no stall, the keys delivered once, bitwise phase
   10's. (h) ``python -m ...apps.serve --replicas 2`` in a child on
   phase 4's images (a .mat stack): exit 0 and every PSNR above the
   smooth fill's (the app's own masks, seed 0). Then K1 at a replica
   dispatch's shape (N=4, K=100, F=266*134), held and timed as in
   phase 3.
14. Output: a
   ``{"slice": ...}`` line (serving), a ``{"learn": ...}`` line, a
   ``{"serve_engine": ...}`` line (the engine phase and the
   ``serve/bench.py`` record), an ``{"apps": ...}`` line, a
   ``{"learners": ...}`` line, a ``{"streaming": ...}`` line, a
   ``{"mesh": ...}`` line, a ``{"serve_mesh": ...}`` line, a
   ``{"telemetry": ...}`` line (17's counts and seconds, with and
   without telemetry and the profiler), a ``{"robustness": ...}`` line
   (18's counts and seconds, the armed learner's step beside the plain
   one), a ``{"serve_fleet": ...}`` line (19's records), a
   ``{"kernels": [...]}`` line (K1, K2a, K2b; K1's launches by path:
   reconstruct, engine, poisson, deblur, learn_3d, learn_2d_masked,
   learn_streaming_2d, learn_streaming_3d, mesh_reconstruct,
   mesh_learn_freq, serve_mesh, learn_2d_256_gate, telemetry_engine,
   telemetry_reconstruct, capture_engine, capture_replay,
   degrade_streaming_cli, degrade_streaming_direct, fleet; K2's: learn,
   learn_telemetry, mesh_learn_block4, mesh_learn_nccl1, learn_watchdog,
   learn_nan_recovery, learn_hang), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when CUDA is absent or the
port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "ccsc_code_iccv2017_torch"
if not os.path.isdir(os.path.join(HERE, PACKAGE)):
    sys.exit(f"chip_smoke: {PACKAGE}/ is not beside this script — run it "
             "from a checkout of the repository")
# the north star's problem, its settings and its images are defined once,
# in the four-rank check module; the learner phases use them too
from ccsc_code_iccv2017_torch.parallel import mesh_check  # noqa: E402

BANK = os.path.join(HERE, "artifacts_2d", "learned_bank.mat")
FAMILY = os.path.join(HERE, "artifacts_family_cpu")
BANK_3D = os.path.join(FAMILY, "bank_3d.mat")  # k=49 11x11x11
BANK_HS = os.path.join(FAMILY, "bank_hs.mat")  # k=100 11x11, 31 bands
BANK_4D = os.path.join(FAMILY, "bank_4d.mat")  # k=49 11x11, 5x5 views

# Datasheet memory bandwidth (bytes/s) and float32 non-tensor-core peak
# (flop/s) by card name (NVIDIA H100/H200 data sheets). The more
# specific names come first.
DATASHEET = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),  # SXM5, "NVIDIA H100 80GB HBM3"
)

K, S, R = 100, 256, 5  # filters, image side, psf radius of the 11x11 bank
F = (S + 2 * R) * ((S + 2 * R) // 2 + 1)  # 266 * 134 rfft bins
RHO = 100.0  # SolveConfig.gamma_ratio: the z-solve's coupling constant
# the Poisson and deblurring apps' problems and the solve settings their
# z-solve factors read (apps/poisson_2d.py, apps/deblur_video.py)
POISSON_PROB = dict(data_term="poisson", dirac="append", grad_reg_dirac=True,
                    sparsify_dirac=False, clamp_nonneg=True)
POISSON_CFG = dict(lambda_smooth=0.5, gamma_factor=20.0, gamma_ratio=5.0)
DEBLUR_CFG = dict(gamma_factor=500.0, gamma_ratio=1.0)
DEBLUR_SHAPE = (128, 128, 32)  # the clip: 128x128, 32 frames


def _datasheet(name: str):
    for key, bw, flops in DATASHEET:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no datasheet bandwidth for card {name!r}")


def phase_environment(torch, device_report, card_line):
    smi = card_line()
    rep = device_report("cuda:0")
    print(f"[1] nvidia-smi: {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {rep['name']}, capability {rep['capability']}, "
          f"{rep['sm_count']} SMs, {torch.cuda.device_count()} device(s)")
    if tuple(rep["capability"]) != (9, 0):
        raise RuntimeError(
            f"expected a Hopper card (9, 0), got {rep['capability']}"
        )
    return smi, rep["name"]


def phase_build(kernels, native):
    """Every kernel source, one nvcc each, and the native preprocessing
    library (g++) beside them, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.build)
        infos = kernels.build_all()
        infos["native_ccsc_data"] = native_build.result()
    wall = time.perf_counter() - t0
    for name, info in infos.items():
        print(f"[2] {name} built in {info['seconds']:.2f} s "
              f"(compiled={info['compiled']}): {info['path']}")
        for line in info["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"[2]   {line.strip()}")
    print(f"[2] all kernels and the native library built in {wall:.2f} s "
          "(parallel nvcc, g++)")
    return infos


# phase 3's K1 cases: (N, K, F, raised dirac row). The serve
# path's shapes; the learner composition path's (N = 8 blocks x 100
# images, 110x56 bins); then one case per branch of k1_launch_plan: each
# register instantiation's edge and the generic loop (K = 300), at an F
# that is not a multiple of the tile, where dhat/dinv fit in L2 (one image
# per block); and at the serve path's F, where they do not, an N whose
# last chunk of images is partial
K1_CASES = (
    [(n, K, F, raised) for n in (1, 4) for raised in (False, True)]
    + [(800, 100, 110 * 56, False)]
    + [(45, k, 6161, k == 105) for k in (1, 7, 100, 105, 300)]
    + [(13, k, F, k == 300) for k in (100, 300)]
    + [(n, K, F, False) for n in (2, 8)]
)
K1_MAIN_N = (1, 4, 800)  # the main path's image counts, timed --against


def _load_kernels(root):
    """``ops/kernels.py`` of the checkout at ``root``, as a module of its
    own (it builds that checkout's kernel sources there)."""
    import importlib.util

    path = os.path.join(root, PACKAGE, "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("against_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k1_case(torch, kernels, time_ms, bw, flops, card, args, label,
             against=None):
    """K1 against its plain version on ``args`` = (dhat [K, F], xi1
    [N, F], xi2 [N, K, F], rho, dinv [K, F]): the error relative to
    max|z|, two launches' bits, its time beside the plain version's, its
    bound and a plain copy of xi2; raises past 1e-5 or on unequal bits."""
    dhat, xi1, xi2, rho, dinv = args
    n, k, f = xi2.shape
    plan = kernels.k1_launch_plan(n, k, f, *card)
    z = kernels.solve_z_rank1(*args)
    z2 = kernels.solve_z_rank1(*args)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(z, z2))
    del z2
    ref = kernels.solve_z_rank1_reference(*args)
    abs_err = float((z - ref).abs().max())
    rel_err = abs_err / float(ref.abs().max())
    # each input read once, the output written once
    nbytes = (k * (12 + 16 * n) + 8 * n) * f
    # ~35 real operations per (n, k, f) and 4 per (n, f)
    nops = n * f * (35 * k + 4)
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * nops / flops
    case = dict(label, n=n, k=k, f=f, plan=plan, max_abs_err=abs_err,
                max_rel_err=rel_err, bitwise_repeatable=bitwise,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes)
    if against is not None and n in K1_MAIN_N:
        za = against.solve_z_rank1(*args)
        case["against_rel_err"] = float((za - ref).abs().max()) / float(
            ref.abs().max())
        del za
    del z, ref
    case["kernel_ms"] = time_ms(lambda: kernels.solve_z_rank1(*args))
    if "against_rel_err" in case:
        case["against_ms"] = time_ms(lambda: against.solve_z_rank1(*args))
    case["plain_ms"] = time_ms(
        lambda: kernels.solve_z_rank1_reference(*args), warmup=1,
        reps=5 if n * k * f > 1e8 else 30)
    # a plain copy of xi2, the N K F complex64 read and written that
    # dominate K1's bytes: the card's practical rate for that traffic
    dst = torch.empty_like(xi2)
    case["copy_xi2_ms"] = time_ms(lambda: dst.copy_(xi2))
    del dst
    print(f"[3] K1 {' '.join(f'{a}={b}' for a, b in label.items())} N={n} "
          f"K={k} F={f} plan kpt={plan['kpt']} nc={plan['nc']} grid="
          f"{plan['grid']}: rel err {rel_err:.2e}, bitwise repeat {bitwise}, "
          f"kernel {case['kernel_ms']:.4f} ms, plain {case['plain_ms']:.4f} "
          f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}), copy "
          f"of xi2 {case['copy_xi2_ms']:.4f} ms"
          + (f"; --against: kernel {case['against_ms']:.4f} ms, rel err "
             f"{case['against_rel_err']:.2e}" if "against_ms" in case
             else ""))
    if not (rel_err <= 1e-5 and bitwise):
        raise RuntimeError(f"K1 disagrees with its plain version or "
                           f"with itself: {case}")
    return case


def _card(torch):
    props = torch.cuda.get_device_properties(torch.device("cuda", 0))
    return props.multi_processor_count, props.L2_cache_size


def _random_k1_args(torch, gen, n, k, f, raised):
    """K1's arguments for N=n, K=k, F=f drawn from ``gen`` (on the card):
    complex normal dhat, xi1 and xi2, rho = RHO and dinv = 1/rho, with
    the last row raised as the Poisson dirac's gradient regularization
    raises it when ``raised``."""
    dev = gen.device

    def cplx(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev),
        )

    dhat, xi1, xi2 = cplx(k, f), cplx(n, f), cplx(n, k, f)
    gamma = torch.full((k, f), RHO, device=dev)
    if raised:  # the dirac row's gradient regularization
        gamma[k - 1] += 4.0 * torch.rand(f, generator=gen, device=dev)
    return (dhat, xi1, xi2, RHO, 1.0 / gamma)


def phase_kernel_vs_plain(torch, kernels, time_ms, bw, flops, seed,
                          against=None):
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(seed)
    cases = []
    for n, k, f, raised in K1_CASES:
        args = _random_k1_args(torch, gen, n, k, f, raised)
        cases.append(_k1_case(torch, kernels, time_ms, bw, flops,
                              _card(torch), args, {"raised_row": raised},
                              against))
        del args
        torch.cuda.empty_cache()
    return cases


def _app_plans(torch, port):
    """The z-solve factors of the two W == 1 apps at full width, as their
    solves build them: Poisson deconvolution (the 2D bank plus its
    appended, gradient-regularized dirac, K = 101, 256x256) and video
    deblurring (the 3D bank plus its prepended dirac, the 3x3x3 blur
    composed in, K = 50, a 128x128x32 clip): {app: (kern, rho)}."""
    rec, cfg_of = port["reconstruct"], port["config"].SolveConfig
    geom = port["config"].ProblemGeom
    d2 = port["io_mat"].load_filters_2d(BANK)
    d3 = port["io_mat"].load_filters_3d(BANK_3D)
    plans = {
        "poisson": rec.build_plan(
            d2, rec.ReconstructionProblem(
                geom(d2.shape[1:], d2.shape[0]), **POISSON_PROB),
            cfg_of(**POISSON_CFG), (S, S), device="cuda"),
        "deblur": rec.build_plan(
            d3, rec.ReconstructionProblem(
                geom(d3.shape[1:], d3.shape[0]), dirac="prepend"),
            cfg_of(**DEBLUR_CFG), DEBLUR_SHAPE,
            blur_psf=port["deblur_video"].build_psf(None), device="cuda"),
    }
    return {app: (p.kern, p.rho) for app, p in plans.items()}


def phase_k1_app_shapes(torch, port, time_ms, bw, flops, seed):
    """K1 at the two W == 1 apps' shapes, on their own filter spectra
    and dinv (Poisson's with the dirac row's gradient diagonal): the
    checks and timings of phase 3."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    cases = {}
    for app, (kern, rho) in _app_plans(torch, port).items():
        dhat, dinv = kern.dhat[:, 0, :].contiguous(), kern.dinv
        k, f = dhat.shape

        def cplx(*shape):
            return torch.complex(
                torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev),
            )

        args = (dhat, cplx(1, f), cplx(1, k, f), rho, dinv)
        cases[app] = _k1_case(
            torch, port["kernels"], time_ms, bw, flops, _card(torch), args,
            {"app": app, "dinv_uniform": bool((dinv == dinv[0, 0]).all())})
        del kern, dhat, dinv, args
        torch.cuda.empty_cache()
    if cases["poisson"]["dinv_uniform"]:
        raise RuntimeError("Poisson's dinv lost its dirac row")
    return cases


def _images(port, seed):
    """4 synthetic 256x256 images in [0, 1] (Gaussian-smoothed noise)
    and their 50% masks."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = port["images"].smooth_noise_images(rng, 4, S)
    mask = (rng.random(b.shape) < 0.5).astype(np.float32)
    return b, mask


def phase_serve(torch, port, seed):
    import numpy as np

    cfg_kw = dict(lambda_residual=5.0, lambda_prior=2.0, max_it=100,
                  tol=1e-3)
    d = port["io_mat"].load_filters_2d(BANK)
    b, mask = _images(port, seed)
    sm = port["images"].smooth_fill_batch(b, mask)
    rec = port["reconstruct"]
    prob = rec.ReconstructionProblem(port["config"].ProblemGeom((11, 11), K))
    cfg = port["config"].SolveConfig(**cfg_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = rec.build_plan(d, prob, cfg, (S, S), device="cuda")
    torch.cuda.synchronize()
    plan_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[4] build_plan: {plan_ms:.1f} ms, F={plan.fg.num_freq}")
    if plan.fg.num_freq != F:
        raise RuntimeError(f"plan has {plan.fg.num_freq} bins, expected {F}")

    def request(i, c=cfg):
        return rec.reconstruct(
            b[i:i + 1] * mask[i:i + 1], d, prob, c, mask=mask[i:i + 1],
            smooth_init=sm[i:i + 1], x_orig=b[i:i + 1], plan=plan,
            device="cuda",
        )

    # warm cuFFT plans and the allocator once, like a server's warmup
    request(0, dataclasses.replace(cfg, max_it=2))
    torch.cuda.synchronize()

    kernels = port["kernels"]
    kernels.solve_z_rank1.launches = 0
    served = []
    for i in range(b.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = request(i)
        recon = res.recon.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
        it = int(res.trace.num_iters)
        if not np.isfinite(recon).all() or recon.shape != (1, S, S):
            raise RuntimeError(f"request {i}: bad recon {recon.shape}")
        served.append({
            "iters": it,
            "psnr_db": float(res.trace.psnr_vals[it]),
            "smooth_fill_psnr_db": float(port["common"].psnr(
                torch.from_numpy(sm[i]), torch.from_numpy(b[i]), (R, R)
            )),
            "latency_ms": ms,
        })
        print(f"[4] request {i}: {it} iterations, PSNR "
              f"{served[-1]['psnr_db']:.2f} dB (smooth fill "
              f"{served[-1]['smooth_fill_psnr_db']:.2f} dB), {ms:.1f} ms")
    launches = kernels.solve_z_rank1.launches
    total = sum(s["iters"] for s in served)
    if launches != total:
        raise RuntimeError(
            f"K1 launched {launches} times for {total} iterations served"
        )
    print(f"[4] K1 launches {launches} == iterations served {total}")
    return {"plan_ms": plan_ms, "requests": served, "launches": launches,
            "data": (b, mask, sm, d, prob, cfg_kw)}


def phase_card_vs_cpu(torch, port, data):
    import numpy as np

    b, mask, sm, d, prob, cfg_kw = data
    cfg = port["config"].SolveConfig(**dict(cfg_kw, max_it=10, tol=0.0))
    out = {}
    for dev in ("cuda", "cpu"):
        res = port["reconstruct"].reconstruct(
            b[:1] * mask[:1], d, prob, cfg, mask=mask[:1],
            smooth_init=sm[:1], x_orig=b[:1], device=dev,
        )
        out[dev] = (res.trace.obj_vals.cpu().numpy().astype(np.float64),
                    res.recon.cpu().numpy())
    obj_c, rec_c = out["cuda"]
    obj_p, rec_p = out["cpu"]
    obj_rel = float(np.max(np.abs(obj_c - obj_p) / np.abs(obj_p)))
    rec_abs = float(np.abs(rec_c - rec_p).max())
    b_max = float(np.abs(b[:1] * mask[:1]).max())
    print(f"[5] card vs CPU, 10 iterations: obj max rel diff {obj_rel:.2e}, "
          f"recon max abs diff {rec_abs:.2e} (b max {b_max:.3f})")
    if not obj_rel <= 1e-4:
        raise RuntimeError(f"objective traces differ: {obj_rel:.3e} > 1e-4")
    if not rec_abs <= 1e-4 * b_max:
        raise RuntimeError(
            f"reconstructions differ: {rec_abs:.3e} > 1e-4 * {b_max:.3f}"
        )
    return {"obj_max_rel_diff": obj_rel, "recon_max_abs_diff": rec_abs,
            "b_max": b_max}


_NS = mesh_check.NORTH_STAR  # the BASELINE learner
LEARN_K, LEARN_SUPPORT, LEARN_SIDE = _NS["k"], _NS["support"], _NS["side"]
LEARN_S = LEARN_SIDE + 2 * (LEARN_SUPPORT // 2)  # 110: padded plane side
LEARN_BLOCKS, LEARN_NI = _NS["blocks"], _NS["ni"]  # N = 800, K = 100


def _fused_inputs(torch, gen, N, Kf, Sy, Sx, dtype, rho=1.0,
                  whole_plane=False):
    """Random state and spectra for one fused z-iteration on the card.
    By default with the main path's structure: unit-norm filters on an
    11x11 support (the learner's projected dictionary) and data on the
    interior of the padded plane. ``whole_plane`` takes noise over the
    whole plane for both instead: there the rank-1 correction cancels
    by orders of magnitude, and even the plain float32 version lands
    ~1e-5 from float64."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    z = randn(N, Kf, Sy, Sx).to(dtype)
    du = randn(N, Kf, Sy, Sx).to(dtype)
    if whole_plane:
        d, b = randn(Kf, Sy, Sx), randn(N, Sy, Sx)
    else:
        s = min(LEARN_SUPPORT, Sy, Sx)
        d = torch.zeros(Kf, Sy, Sx, device=dev)
        d[:, :s, :s] = randn(Kf, s, s)
        d /= d.flatten(1).norm(dim=1)[:, None, None]
        r = LEARN_SUPPORT // 2 if min(Sy, Sx) > 2 * LEARN_SUPPORT else 0
        b = torch.zeros(N, Sy, Sx, device=dev)
        b[:, r:Sy - r, r:Sx - r] = randn(N, Sy - 2 * r, Sx - 2 * r)
    dhat, bhat = torch.fft.rfft2(d), torch.fft.rfft2(b)
    minv = 1.0 / (1.0 + torch.sum(dhat.abs() ** 2, 0) / rho)
    return z, du, bhat, dhat, minv


def _split(S):
    """The kernels' split of an axis of length S (``plan_axis`` in
    csrc/fused_z.cu): (P, Q) with P the largest divisor of S that is at
    most sqrt(S) and Q = S / P, when Q <= 16; else (1, S), the dense
    routine."""
    import math

    P = max((p for p in range(2, math.isqrt(S) + 1) if S % p == 0),
            default=1)
    return (P, S // P) if P > 1 and S // P <= 16 else (1, S)


def _k2_cost(N, Kf, Sy, Sx, itemsize):
    """Operations and bytes of the work K2a and K2b do, per pass, and the
    operations of the kernels' own split-DFT formulation beside them.

    Per [Sy, Sx] plane (Fx = Sx/2 + 1), the work is one real 2D transform
    in pass A and two in pass B (forward and inverse), counted at the
    usual 5 n log2 n flops for a complex FFT of length n and half that
    for a real one: Sy real rows (2.5 Sx log2 Sx) and Fx complex columns
    (5 Sy log2 Sy). Elementwise work is ~8 flops per pixel (prox, dual,
    xi) and 18 (pass A: g and the t accumulation) or 22 (pass B: g, s
    and the correction) per bin. Bytes: each input read once, each
    output written once. The kernels (csrc/fused_z.cu) split each axis
    S = P Q into two stages of small DFTs, P sub-DFTs of length Q and Q
    of length P, each taken by the DFT matrix's cos/sin symmetry:
    sub(L) = 8 H^2 + 10 H flops, H = (L - 1) / 2, plus 4 H + 4 for an
    even L; a complex line adds 6 S for the twiddle between the stages
    and 4 S for the scaling, and costs 8 S^2 on an axis that keeps the
    dense routine. A real row costs half a complex line (two rows per
    complex transform) plus 4 flops per bin to unpack, or 4 Sx Fx dense
    ("formulation_ops"). That is how far their formulation sits above
    the work, not a floor of the work."""
    import math

    Fx = Sx // 2 + 1
    P, Fp, planes = Sy * Sx, Sy * Fx, N * Kf
    fft = 2.5 * Sy * Sx * math.log2(Sx) + 5 * Fx * Sy * math.log2(Sy)

    def sub(L):
        H = (L - 1) // 2
        return 8 * H * H + 10 * H + (4 * H + 4 if L % 2 == 0 else 0)

    def line(S):
        p, q = _split(S)
        return p * sub(q) + q * sub(p) + 10 * S if p > 1 else 8 * S * S

    (py, qy), (px, qx) = _split(Sy), _split(Sx)
    col = Fx * line(Sy)
    row = Sy * (line(Sx) / 2 + 4 * Fx) if px > 1 else 4 * Sy * Sx * Fx
    ops_a = planes * (fft + 8 * P + 18 * Fp)
    ops_b = planes * (2 * fft + 6 * P + 22 * Fp)
    form_a = planes * (row + col + 8 * P + 18 * Fp)
    form_b = planes * (2 * row + 2 * col + 6 * P + 22 * Fp)
    state = planes * P * itemsize  # one state plane set
    bytes_a = 3 * state + 8 * Fp * (Kf + 2 * N)  # z, du, dual'; dhat, bhat, t
    bytes_b = 3 * state + 8 * Fp * (Kf + 2 * N) + 4 * Fp  # ... z'; t, minv
    split = (f"col(S) = P sub(Q) + Q sub(P) + 10 S for a split S = P Q, "
             f"8 S^2 dense; sub(L) = 8 H^2 + 10 H (+ 4 H + 4 for even L), "
             f"H = (L - 1) / 2; row = col(Sx) / 2 + 4 Fx split, 4 Sx Fx "
             f"dense; here Sy = {py}x{qy}, Sx = {px}x{qx} (1xS: dense)")
    formulas = {
        "ops_a": "N K (2.5 Sy Sx log2 Sx + 5 Fx Sy log2 Sy + 8 Sy Sx "
                 "+ 18 Sy Fx)",
        "ops_b": "N K (5 Sy Sx log2 Sx + 10 Fx Sy log2 Sy + 6 Sy Sx "
                 "+ 22 Sy Fx)",
        "formulation_ops_a": "N K (Sy row + Fx col(Sy) + 8 Sy Sx "
                             f"+ 18 Sy Fx); {split}",
        "formulation_ops_b": "N K (2 Sy row + 2 Fx col(Sy) + 6 Sy Sx "
                             f"+ 22 Sy Fx); {split}",
        "bytes_a": "3 N K Sy Sx e + 8 Sy Fx (K + 2N)",
        "bytes_b": "3 N K Sy Sx e + 8 Sy Fx (K + 2N) + 4 Sy Fx",
    }
    return (ops_a, bytes_a, form_a), (ops_b, bytes_b, form_b), formulas


def _bound(ops, nbytes, formulation_ops, bw, flops):
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * ops / flops
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops": ops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "formulation_ops": formulation_ops,
            "formulation_ops_ms": 1e3 * formulation_ops / flops}


def phase_k2_vs_plain(torch, port, bw, flops, seed):
    fz = port["fused_z"]
    time_ms = port["device"].device_time_ms
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rho, theta = 1.0, 1.0  # the learner's rho_z and lambda / rho_z
    cases = []
    for (N, Kf, Sy, Sx, dtype, hermitian) in (
        (4, 100, LEARN_S, LEARN_S, torch.float32, True),
        (4, 100, LEARN_S, LEARN_S, torch.bfloat16, True),
        (3, 6, 9, 9, torch.float32, True),
        (2, 5, 15, 12, torch.float32, True),
        (2, 3, 13, 11, torch.float32, True),
        (2, 3, 38, 20, torch.float32, True),
        (2, 3, 12, 10, torch.float32, False),
    ):
        args = _fused_inputs(torch, gen, N, Kf, Sy, Sx, dtype, rho)
        if not hermitian:  # DC and Nyquist bins with imaginary parts
            z, du, bhat, dhat, _ = args
            bhat, dhat = (torch.complex(torch.randn(a.shape, generator=gen,
                                                    device=dev),
                                        torch.randn(a.shape, generator=gen,
                                                    device=dev))
                          for a in (bhat, dhat))
            minv = 1.0 / (1.0 + torch.sum(dhat.abs() ** 2, 0) / rho)
            args = (z, du, bhat, dhat, minv)
        z1, d1 = fz.fused_z_iter(*args, rho, theta)
        z2, d2 = fz.fused_z_iter(*args, rho, theta)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(z1, z2) and torch.equal(d1, d2))
        zr, dr = fz.fused_z_iter_reference(*args, rho, theta)
        z1f, zrf = z1.float(), zr.float()
        z_abs = float((z1f - zrf).abs().max())
        d_abs = float((d1.float() - dr.float()).abs().max())
        z_scale = float(zrf.abs().max())
        d_scale = float(dr.float().abs().max())
        case = {
            "N": N, "K": Kf, "Sy": Sy, "Sx": Sx, "split_y": _split(Sy),
            "split_x": _split(Sx), "hermitian": hermitian,
            "dtype": str(dtype).split(".")[-1],
            "z_max_abs_err": z_abs, "z_rel_err": z_abs / z_scale,
            "dual_max_abs_err": d_abs, "dual_rel_err": d_abs / d_scale,
            "bitwise_repeatable": bitwise,
        }
        print(f"[6] K2 N={N} K={Kf} {Sy}x{Sx} (split {case['split_y']} x "
              f"{case['split_x']}{'' if hermitian else ', not Hermitian'}) "
              f"{case['dtype']}: z' rel err "
              f"{case['z_rel_err']:.2e}, dual' rel err "
              f"{case['dual_rel_err']:.2e}, bitwise repeat {bitwise}")
        if not bitwise:
            raise RuntimeError(f"K2 is not bitwise repeatable: {case}")
        if dtype == torch.float32:
            ok = case["z_rel_err"] <= 1e-5 and case["dual_rel_err"] <= 1e-6
        else:
            ok = z_abs <= 0.02 * z_scale and d_abs <= 0.02 * d_scale
        if not ok:
            raise RuntimeError(f"K2 disagrees with its plain version: {case}")
        cases.append(case)
        del args, z1, d1, z2, d2, zr, dr, z1f, zrf

    # noise spectra over the whole plane: float32 itself lands ~1e-5
    # from float64 there, so the kernels are held to the plain version
    # run in float64 (dual' is elementwise, held to the float32 plain)
    args = _fused_inputs(torch, gen, 4, LEARN_K, LEARN_S, LEARN_S,
                         torch.float32, rho, whole_plane=True)
    z1, d1 = fz.fused_z_iter(*args, rho, theta)
    z2, d2 = fz.fused_z_iter(*args, rho, theta)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(z1, z2) and torch.equal(d1, d2))
    wide = [a.to(torch.complex128) if a.is_complex() else a.double()
            for a in args]
    z64 = fz.fused_z_iter_reference(*wide, rho, theta)[0]
    zr, dr = fz.fused_z_iter_reference(*args, rho, theta)
    z_scale = float(z64.abs().max())
    whole = {
        "N": 4, "K": LEARN_K, "Sy": LEARN_S, "Sx": LEARN_S,
        "dtype": "float32", "inputs": "whole_plane_noise",
        "bitwise_repeatable": bitwise,
        "z_rel_err_vs_f64": float((z1.double() - z64).abs().max()) / z_scale,
        "plain_z_rel_err_vs_f64":
            float((zr.double() - z64).abs().max()) / z_scale,
        "z_rel_err_vs_plain":
            float((z1 - zr).abs().max()) / float(zr.abs().max()),
        "dual_rel_err": float((d1 - dr).abs().max()) / float(dr.abs().max()),
        "limit_vs_f64": 3e-5,
    }
    print(f"[6] K2 N=4 K={LEARN_K} {LEARN_S}x{LEARN_S} float32, whole-plane "
          f"noise: z' rel err vs float64 {whole['z_rel_err_vs_f64']:.2e} "
          f"(plain float32 {whole['plain_z_rel_err_vs_f64']:.2e}; kernel vs "
          f"plain {whole['z_rel_err_vs_plain']:.2e}), dual' rel err "
          f"{whole['dual_rel_err']:.2e}, bitwise repeat {bitwise}")
    if not (bitwise and whole["z_rel_err_vs_f64"] <= 3e-5
            and whole["dual_rel_err"] <= 1e-6):
        raise RuntimeError(f"K2 off float64 on whole-plane noise: {whole}")
    del args, wide, z1, d1, z2, d2, z64, zr, dr

    # the learner's full launch shape: N*K = 800*100 planes of 110x110
    N, Kf, S = LEARN_BLOCKS * LEARN_NI, LEARN_K, LEARN_S
    z, du, bhat, dhat, minv = _fused_inputs(torch, gen, N, Kf, S, S,
                                            torch.float32, rho)
    cost_a, cost_b, formulas = _k2_cost(N, Kf, S, S, 4)
    # the comparison at the main path's own launch shape too
    zk, dk = fz.fused_z_iter(z, du, bhat, dhat, minv, rho, theta)
    zr, dr = fz.fused_z_iter_reference(z, du, bhat, dhat, minv, rho, theta)
    full = {
        "N": N, "K": Kf, "Sy": S, "Sx": S, "dtype": "float32",
        "z_max_abs_err": float((zk - zr).abs().max()),
        "dual_max_abs_err": float((dk - dr).abs().max()),
    }
    full["z_rel_err"] = full["z_max_abs_err"] / float(zr.abs().max())
    full["dual_rel_err"] = full["dual_max_abs_err"] / float(dr.abs().max())
    print(f"[6] K2 N={N} K={Kf} {S}x{S} float32: z' rel err "
          f"{full['z_rel_err']:.2e}, dual' rel err {full['dual_rel_err']:.2e}")
    if not (full["z_rel_err"] <= 1e-5 and full["dual_rel_err"] <= 1e-6):
        raise RuntimeError(f"K2 disagrees with its plain version: {full}")
    cases.append(full)
    del zk, dk, zr, dr
    # a rank's launch shape on block_mesh(4) (phase 15 (a)): its 2 blocks
    # of the same planes, held and timed as the full shape
    nr = N // MESH_RANKS
    part = (z[:nr], du[:nr], bhat[:nr], dhat, minv)
    zk, dk = fz.fused_z_iter(*part, rho, theta)
    zr, dr = fz.fused_z_iter_reference(*part, rho, theta)
    rank = {
        "N": nr, "K": Kf, "Sy": S, "Sx": S, "dtype": "float32",
        "mesh": "block4 rank",
        "z_max_abs_err": float((zk - zr).abs().max()),
        "dual_max_abs_err": float((dk - dr).abs().max()),
    }
    rank["z_rel_err"] = rank["z_max_abs_err"] / float(zr.abs().max())
    rank["dual_rel_err"] = rank["dual_max_abs_err"] / float(dr.abs().max())
    del zk, dk, zr, dr
    _, tr = fz.pass_a(*part[:4], rho, theta)
    ra, rb, _ = _k2_cost(nr, Kf, S, S, 4)
    rank["pass_a"] = dict(
        kernel_ms=time_ms(lambda: fz.pass_a(*part[:4], rho, theta),
                          warmup=2, reps=7),
        plain_ms=time_ms(lambda: fz.reference_pass_a(*part[:4], rho, theta),
                         warmup=1, reps=5), **_bound(*ra, bw, flops))
    rank["pass_b"] = dict(
        kernel_ms=time_ms(lambda: fz.pass_b(*part, tr, rho, theta),
                          warmup=2, reps=7),
        plain_ms=time_ms(lambda: fz.reference_pass_b(*part, tr, rho, theta),
                         warmup=1, reps=5), **_bound(*rb, bw, flops))
    print(f"[6] K2 N={nr} K={Kf} {S}x{S} float32 (a rank of block_mesh(4)):"
          f" z' rel err {rank['z_rel_err']:.2e}, dual' rel err "
          f"{rank['dual_rel_err']:.2e}; pass A "
          f"{rank['pass_a']['kernel_ms']:.3f} ms (plain "
          f"{rank['pass_a']['plain_ms']:.3f}, bound "
          f"{rank['pass_a']['bound_ms']:.3f}), pass B "
          f"{rank['pass_b']['kernel_ms']:.3f} ms (plain "
          f"{rank['pass_b']['plain_ms']:.3f}, bound "
          f"{rank['pass_b']['bound_ms']:.3f})")
    if not (rank["z_rel_err"] <= 1e-5 and rank["dual_rel_err"] <= 1e-6):
        raise RuntimeError(f"K2 disagrees with its plain version: {rank}")
    cases.append(rank)
    del part, tr
    torch.cuda.empty_cache()
    _, t = fz.pass_a(z, du, bhat, dhat, rho, theta)
    kernel_a = time_ms(lambda: fz.pass_a(z, du, bhat, dhat, rho, theta),
                       warmup=2, reps=7)
    kernel_b = time_ms(lambda: fz.pass_b(z, du, bhat, dhat, minv, t, rho,
                                         theta), warmup=2, reps=7)
    plain_a = time_ms(lambda: fz.reference_pass_a(
        z, du, bhat, dhat, rho, theta), warmup=1, reps=5)
    plain_b = time_ms(lambda: fz.reference_pass_b(
        z, du, bhat, dhat, minv, t, rho, theta), warmup=1, reps=5)
    # the yardstick: one z-iteration of the composition path
    # (models/learn.py z_iter_composition: cuFFT + K1 + elementwise)
    fg = port["common"].FreqGeom.create(
        port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, Kf),
        (LEARN_SIDE, LEARN_SIDE),
    )
    zkern = port["freq_solvers"].precompute_z_kernel(
        dhat.reshape(Kf, 1, -1), rho
    )
    b3 = bhat.reshape(N, 1, -1)
    comp = time_ms(lambda: port["learn"].z_iter_composition(
        z, du, b3, zkern, rho, theta, fg), warmup=1, reps=5)
    timing = {
        "shape": {"N": N, "K": Kf, "Sy": S, "Sx": S, "dtype": "float32"},
        "pass_a": dict(kernel_ms=kernel_a, plain_ms=plain_a,
                       **_bound(*cost_a, bw, flops)),
        "pass_b": dict(kernel_ms=kernel_b, plain_ms=plain_b,
                       **_bound(*cost_b, bw, flops)),
        "fused_iter_ms": kernel_a + kernel_b,
        "composition_iter_ms": comp,
        "formulas": formulas,
    }
    for p in ("pass_a", "pass_b"):
        r = timing[p]
        print(f"[6] K2 {p} at N={N} K={Kf} {S}x{S}: kernel "
              f"{r['kernel_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}: {r['ops']:.4g} flop "
              f"-> {r['ops_ms']:.3f} ms, {r['bytes']:.4g} B -> "
              f"{r['bytes_ms']:.3f} ms); the kernels' split-DFT formulation "
              f"{r['formulation_ops']:.4g} flop -> "
              f"{r['formulation_ops_ms']:.3f} ms")
    print(f"[6] formulas: {json.dumps(formulas)}")
    print(f"[6] one z-iteration: fused {kernel_a + kernel_b:.3f} ms, "
          f"composition (cuFFT + K1 + elementwise) {comp:.3f} ms")
    del z, du, bhat, dhat, minv, t, zkern, b3
    torch.cuda.empty_cache()
    return {"cases": cases, "whole_plane": whole, "timing": timing}


def _learn_cfg(port, **kw):
    return port["config"].LearnConfig(**{**mesh_check.CFG, **kw})


def phase_learn(torch, port, seed):
    import math

    import numpy as np

    n = LEARN_BLOCKS * LEARN_NI
    t0 = time.perf_counter()
    b = mesh_check.training_images(seed, n, LEARN_SIDE)
    data_s = time.perf_counter() - t0
    cfg = _learn_cfg(port, num_blocks=LEARN_BLOCKS, max_it=3, fused_z=True)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    fz = port["fused_z"].fused_z_iter
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fz.launches_a = fz.launches_b = 0
    t0 = time.perf_counter()
    res = port["consensus"].learn(b, geom, cfg, generator=gen,
                                  device="cuda")
    d = res.d.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = {"fused_z_pass_a": fz.launches_a,
                "fused_z_pass_b": fz.launches_b}
    tr = res.trace
    steps = len(tr["obj_vals_z"]) - 1
    want = cfg.max_it_z * steps
    print(f"[7] learn n={n} {LEARN_SIDE}x{LEARN_SIDE}, k={LEARN_K} "
          f"{LEARN_SUPPORT}x{LEARN_SUPPORT}, {LEARN_BLOCKS} blocks: {steps} "
          f"steps in {wall:.2f} s (data {data_s:.2f} s); K2 launches "
          f"{launches} (want {want} each)")
    if steps != cfg.max_it or any(v != want for v in launches.values()):
        raise RuntimeError(f"learner ran {steps} steps with K2 launches "
                           f"{launches}, want {cfg.max_it} steps, {want}")
    vals = [v for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff",
                        "tim_vals", "d_pass_ms", "z_pass_ms")
            for v in tr[k]]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"non-finite learner trace: {tr}")
    if not tr["obj_vals_z"][3] < tr["obj_vals_z"][1]:
        raise RuntimeError(f"obj_z did not fall: {tr['obj_vals_z']}")
    norms = np.sqrt((d.reshape(LEARN_K, -1) ** 2).sum(1))
    if not (np.isfinite(d).all() and norms.max() <= 1 + 1e-5):
        raise RuntimeError(f"filter norms out of the unit ball: {norms.max()}")
    step_s = np.diff(tr["tim_vals"]).tolist()
    out = {
        "n": n, "side": LEARN_SIDE, "k": LEARN_K, "support": LEARN_SUPPORT,
        "blocks": LEARN_BLOCKS, "max_it_d": cfg.max_it_d,
        "max_it_z": cfg.max_it_z, "steps": steps, "launches": launches,
        "step_s": step_s, "d_pass_ms": tr["d_pass_ms"],
        "z_pass_ms": tr["z_pass_ms"],
        "steps_per_s": steps / tr["tim_vals"][-1],
        "steps_per_s_after_first": (steps - 1) / sum(step_s[1:]),
        "obj_vals_z": tr["obj_vals_z"], "obj_vals_d": tr["obj_vals_d"],
        "filter_norm_max": float(norms.max()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "wall_s": wall, "data_s": data_s,
    }
    for i in range(steps):
        print(f"[7] step {i + 1}: {step_s[i]:.3f} s (d-pass "
              f"{tr['d_pass_ms'][i]:.1f} ms, z-pass {tr['z_pass_ms'][i]:.1f} "
              f"ms), obj_d {tr['obj_vals_d'][i + 1]:.6g}, obj_z "
              f"{tr['obj_vals_z'][i + 1]:.6g}")
    print(f"[7] {out['steps_per_s']:.3f} outer steps/s "
          f"({out['steps_per_s_after_first']:.3f} after the first), max "
          f"memory allocated {out['max_memory_allocated_bytes'] / 2**30:.2f}"
          f" GiB, filter norm max {out['filter_norm_max']:.6f}")
    del res
    torch.cuda.empty_cache()
    return out


def _compare_learns(tag, ra, rb):
    import numpy as np

    obj_rel = max(
        float(np.max(np.abs(np.subtract(ra.trace[k], rb.trace[k]))
                     / np.abs(rb.trace[k])))
        for k in ("obj_vals_d", "obj_vals_z")
    )
    da, db = ra.d.cpu().numpy(), rb.d.cpu().numpy()
    d_abs = float(np.abs(da - db).max())
    d_max = float(np.abs(db).max())
    print(f"{tag}: objective max rel diff {obj_rel:.2e}, filters max abs "
          f"diff {d_abs:.2e} (max|d| {d_max:.3f})")
    if not (obj_rel <= 1e-4 and d_abs <= 1e-4 * d_max):
        raise RuntimeError(f"{tag}: traces or filters disagree "
                           f"({obj_rel:.3e}, {d_abs:.3e})")
    return {"obj_max_rel_diff": obj_rel, "d_max_abs_diff": d_abs,
            "d_max": d_max}


def phase_fused_vs_composition(torch, port, seed):
    b = mesh_check.training_images(seed + 2, 16, LEARN_SIDE)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    fz, k1 = port["fused_z"].fused_z_iter, port["kernels"].solve_z_rank1
    runs, counts = {}, {}
    for fused in (True, False):
        cfg = _learn_cfg(port, num_blocks=2, max_it=2, fused_z=fused)
        before = (k1.launches, fz.launches_a, fz.launches_b)
        runs[fused] = port["consensus"].learn(
            b, geom, cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(seed),
        )
        counts[fused] = [a - c for a, c in zip(
            (k1.launches, fz.launches_a, fz.launches_b), before)]
    want = 10 * 2
    print(f"[8] launches (K1, K2a, K2b): fused {counts[True]}, composition "
          f"{counts[False]}")
    if counts[True] != [0, want, want] or counts[False] != [want, 0, 0]:
        raise RuntimeError(f"unexpected launches {counts}")
    out = _compare_learns("[8] fused vs composition", runs[True], runs[False])
    out["launches"] = {"fused": counts[True], "composition": counts[False]}
    return out


def phase_learn_card_vs_cpu(torch, port, seed):
    b = mesh_check.training_images(seed + 3, 4, 48)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, 16)
    cfg = _learn_cfg(port, num_blocks=2, max_it=2, fused_z=True)
    lm, cm = port["learn"], port["common"]
    fg = cm.FreqGeom.create(geom, (48, 48))
    init = lm.init_state(torch.Generator().manual_seed(seed), geom, fg, 2, 2)
    runs = {dev: port["consensus"].learn(b, geom, cfg, device=dev,
                                         initial_state=init)
            for dev in ("cuda", "cpu")}
    return _compare_learns("[9] learner card vs CPU", runs["cuda"],
                           runs["cpu"])


ENGINE_SLOTS = 4
# 42 requests fill 10 dispatches; one more holds 2 beside 2 filler slots
ENGINE_SIDES = [S] * 40 + [S - 16] * 2  # 2 padded into the bucket


def phase_engine(torch, port, seed):
    import numpy as np

    bench, kernels = port["serve_bench"], port["kernels"]
    cfg_kw = dict(lambda_residual=5.0, lambda_prior=2.0, max_it=100,
                  tol=1e-3)
    d = port["io_mat"].load_filters_2d(BANK)
    prob = port["reconstruct"].ReconstructionProblem(
        port["config"].ProblemGeom((11, 11), K))
    cfg = port["config"].SolveConfig(**cfg_kw)
    reqs = bench.make_requests(ENGINE_SIDES, seed + 4)
    t0 = time.perf_counter()
    with port["serve"].CodecEngine(
            d, prob, cfg, port["config"].ServeConfig(
                buckets=((ENGINE_SLOTS, (S, S)),)),
            device="cuda") as eng:
        warm_s = time.perf_counter() - t0
        kernels.solve_z_rank1.launches = 0
        served, engine_s, submit_s = bench.run_engine(eng, reqs)
        launches = kernels.solve_z_rank1.launches
        dispatch_iters = eng.dispatch_iters
        looped, loop_s = bench.run_direct_loop(d, prob, cfg, reqs, "cuda")
        record = bench.record(eng, served, engine_s, submit_s, looped,
                              loop_s, "cuda")
    print(f"[10] engine warm in {warm_s:.2f} s; {len(reqs)} requests in "
          f"{engine_s * 1e3:.1f} ms (the submit loop {submit_s * 1e3:.1f} "
          f"ms) over {len(dispatch_iters)} dispatches "
          f"of {record['dispatch_requests']} requests, {dispatch_iters} "
          f"iterations and {[round(t, 1) for t in record['dispatch_ms']]} "
          f"ms; K1 launches {launches}")
    if launches != sum(dispatch_iters):
        raise RuntimeError(f"K1 launched {launches} times for dispatches "
                           f"of {dispatch_iters} iterations")
    out = []
    for i, (q, s, (rec, it)) in enumerate(zip(reqs, served, looped)):
        side = q["b"].shape[0]
        b_max = float(np.abs(q["b"]).max())
        err = float(np.abs(s.recon - rec).max())
        fill = port["serve"].valid_region_psnr(q["smooth_init"],
                                               q["x_orig"], (R, R))
        row = {"side": side, "iters": int(s.trace.num_iters),
               "loop_iters": it, "max_abs_diff": err, "b_max": b_max,
               "psnr_db": s.psnr, "smooth_fill_psnr_db": fill,
               "latency_ms": 1e3 * s.latency_s, "wait_ms": 1e3 * s.wait_s}
        out.append(row)
        print(f"[10] request {i} ({side}x{side}): {row['iters']} iterations "
              f"(loop {it}), max|diff| {err:.2e} (b max {b_max:.3f}), PSNR "
              f"{s.psnr:.2f} dB (smooth fill {fill:.2f} dB), latency "
              f"{row['latency_ms']:.1f} ms")
        if not (np.isfinite(s.recon).all() and s.recon.shape == (side, side)):
            raise RuntimeError(f"request {i}: bad recon {s.recon.shape}")
        exact = side == S
        if exact and (row["iters"] != it or not err <= 1e-4 * b_max):
            raise RuntimeError(f"request {i}: served {row['iters']} "
                               f"iterations vs {it}, diff {err:.3e}")
        # the pad's coupling at 240-in-256 measured ~1.5e-5 max|b|
        if not exact and not err <= 1e-3 * b_max:
            raise RuntimeError(f"padded request {i}: diff {err:.3e}")
        if not s.psnr > fill:
            raise RuntimeError(f"request {i}: PSNR {s.psnr:.2f} dB is not "
                               f"above the smooth fill's {fill:.2f} dB")
    print(f"[10] engine {record['engine_requests_per_sec']:.3f} requests/s "
          f"over the window, {record['full_dispatch_requests_per_sec']:.3f} "
          f"over its {record['full_dispatches']} full dispatches (latency "
          f"p50 {record['p50_ms']:.1f} ms, p90 {record['p90_ms']:.1f} ms, "
          f"max {record['max_ms']:.1f} ms) vs direct-call loop "
          f"{record['loop_requests_per_sec']:.3f} requests/s")
    return {"slots": ENGINE_SLOTS, "warm_s": warm_s, "launches": launches,
            "dispatch_iters": dispatch_iters, "requests": out,
            "bench": record, "served": served}


def _app_argv(port, tmp, seed):
    """Each app's argv at full width (the reference protocol's parameters
    are the apps' defaults) and at the reduced size the card-vs-CPU
    check runs, 20 iterations at tol=0. Poisson reads 4 synthetic
    256x256 images (Gaussian-smoothed noise from ``seed``) from a .mat
    stack written into ``tmp``."""
    import numpy as np
    import scipy.io

    stack = os.path.join(tmp, "poisson_images.mat")
    imgs = port["images"].smooth_noise_images(
        np.random.default_rng(seed + 6), 4, S)
    scipy.io.savemat(stack, {"b": imgs})
    seed_arg = ["--seed", str(seed)]
    full = {
        "poisson": ["--data", stack, "--filters", BANK] + seed_arg,
        "deblur_video": ["--synthetic", "--filters", BANK_3D, "--side",
                         str(DEBLUR_SHAPE[0]), "--frames",
                         str(DEBLUR_SHAPE[2])] + seed_arg,
        "demosaic_hyperspectral": ["--synthetic", "--filters", BANK_HS,
                                   "--side", str(S)] + seed_arg,
        "view_synthesis": ["--synthetic", "--filters", BANK_4D, "--side",
                           str(S)] + seed_arg,
    }
    short = ["--max-it", "20", "--tol", "0"]
    small = {
        "poisson": full["poisson"] + ["--size", "64", "--limit", "1"],
        # 12 frames, not 8: the bank's 11-frame support needs >= 11
        "deblur_video": full["deblur_video"][:3] + [
            "--side", "32", "--frames", "12"] + seed_arg,
        "demosaic_hyperspectral": full["demosaic_hyperspectral"][:3] + [
            "--side", "48"] + seed_arg,
        "view_synthesis": full["view_synthesis"][:3] + [
            "--side", "48"] + seed_arg,
    }
    return full, {a: v + short for a, v in small.items()}


def _results(run):
    """The ReconResults of an app's run (Poisson's: one per image)."""
    return run.result if isinstance(run.result, list) else [run.result]


BANK_LOADERS = ("load_filters_2d", "load_filters_3d",
                "load_filters_hyperspectral", "load_filters_lightfield")


def _run_app(torch, port, app, argv, device, perturb=False):
    """One app's ``run`` (what its ``main`` calls) on ``device``: the run,
    the wall of the whole run, and the wall of its solves alone (each
    between two synchronizations), read through a wrapper around
    ``models.reconstruct.reconstruct``, which the app calls by name. On
    the card a second wrapper, around ``ops.freq_solvers.
    precompute_z_kernel``, keeps the last z-solve factors a solve built,
    their coupling constant and the build's time by CUDA events.
    ``perturb`` moves every filter of the bank the app loads by one
    float32 ulp (a relative 2^-24, seeded): the rounding a second
    device's FFTs put into the same spectra."""
    import numpy as np

    mod, rec, fs = port[app], port["reconstruct"], port["freq_solvers"]
    io = port["io_mat"]
    real_rec, real_pre = rec.reconstruct, fs.precompute_z_kernel
    real_load = {name: getattr(io, name) for name in BANK_LOADERS}
    solves, built = [], {}
    if perturb:
        def nudged(load):
            def wrapped(path):
                d = load(path)
                r = np.random.default_rng(1).standard_normal(d.shape)
                return (d * (1.0 + 2.0**-24 * r)).astype(np.float32)
            return wrapped

        for name, load in real_load.items():
            setattr(io, name, nudged(load))

    def timed(*a, **kw):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_rec(*a, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        solves.append(time.perf_counter() - t0)
        return res

    def kept(dhat, rho, *a, **kw):
        if device != "cuda":
            return real_pre(dhat, rho, *a, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kern = real_pre(dhat, rho, *a, **kw)
        end.record()
        torch.cuda.synchronize()
        built.update(kern=kern, rho=rho, ms=start.elapsed_time(end))
        return kern

    rec.reconstruct, fs.precompute_z_kernel = timed, kept
    try:
        t0 = time.perf_counter()
        run = mod.run(mod.build_parser().parse_args(argv + ["--device",
                                                            device]))
        wall = time.perf_counter() - t0
    finally:
        rec.reconstruct, fs.precompute_z_kernel = real_rec, real_pre
        for name, load in real_load.items():
            setattr(io, name, load)
    return run, wall, sum(solves), built


def _check_run(app, run):
    """Finite recon and objective trace; the objective at the last
    iteration below its value at iteration 0. One case is told apart
    and held exactly instead: an objective that is 0 at iteration 0 (the
    warm start already fits every observed entry, as view synthesis's
    interpolation does on the border views it copies) must stay 0 with
    every code 0, the exact minimizer; returns whether that case held."""
    import math

    zero = []
    for i, res in enumerate(_results(run)):
        n = int(res.trace.num_iters)
        obj = res.trace.obj_vals[: n + 1].cpu().tolist()
        if not bool(res.recon.isfinite().all()):
            raise RuntimeError(f"{app} image {i}: non-finite recon")
        if not all(math.isfinite(v) for v in obj):
            raise RuntimeError(f"{app} image {i}: non-finite objective")
        zero.append(obj[0] == 0.0)
        if zero[-1]:
            if any(obj) or bool(res.z.any()):
                raise RuntimeError(f"{app} image {i}: the objective starts "
                                   f"at 0 but moved: {obj}")
        elif not obj[-1] < obj[0]:
            raise RuntimeError(f"{app} image {i}: objective did not fall "
                               f"({obj[0]:.6g} -> {obj[-1]:.6g})")
    return all(zero)


def _woodbury_timing(torch, port, built, time_ms, bw, n=1):
    """One iteration's W > 1 z-solve of ``n`` images (an app's one, a
    learner's batch) at full width, by CUDA events, on the factors the
    solve built (random targets), beside the one-off build of those
    factors (the W x W Gram and its batched complex Cholesky inverse)
    and the solve's byte bound: dhat, minv, dinv, xi1 and xi2 read once
    and z written once. The solve is held to the same solve on the CPU
    (same factors and targets) at 1e-5 of max|z|."""
    kern, rho = built["kern"], built["rho"]
    K, W, F = kern.dhat.shape
    dev = kern.dhat.device
    gen = torch.Generator(device=dev).manual_seed(7)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen, device=dev))

    xi1, xi2 = cplx(n, W, F), cplx(n, K, F)
    solve = port["freq_solvers"].solve_z
    z = solve(kern, xi1, xi2, rho)
    # the same solve on the CPU, from the same factors and targets
    host = type(kern)(*(None if t is None else t.cpu() for t in kern))
    zc = solve(host, xi1.cpu(), xi2.cpu(), rho)
    rel = float((z.cpu() - zc).abs().max()) / float(zc.abs().max())
    del host, zc, z
    ms = time_ms(lambda: solve(kern, xi1, xi2, rho), warmup=2, reps=10)
    nbytes = (8 * K * W * F + 8 * F * W * W + 4 * K * F
              + n * (8 * W * F + 16 * K * F))
    if not rel <= 1e-5:
        raise RuntimeError(f"W={W} z-solve: card vs CPU {rel:.3e} > 1e-5")
    return {"N": n, "K": K, "W": W, "F": F, "solve_z_ms": ms,
            "card_vs_cpu_rel_err": rel,
            "precompute_z_kernel_ms": built["ms"], "bytes": nbytes,
            "bound_ms": 1e3 * nbytes / bw, "bound_by": "bytes"}


def _spread(a_run, b_run):
    """How far two runs of one app lie apart: their iterations (which
    must agree), the objective traces' largest relative difference and
    the reconstructions' largest difference over the second's scale."""
    import numpy as np

    out = {"obj_max_rel_diff": 0.0, "recon_max_rel_diff": 0.0}
    for a, b in zip(_results(a_run), _results(b_run)):
        n = int(b.trace.num_iters)
        if int(a.trace.num_iters) != n:
            raise RuntimeError(f"{int(a.trace.num_iters)} iterations "
                               f"against {n}")
        oa = a.trace.obj_vals[: n + 1].cpu().numpy().astype(np.float64)
        ob = b.trace.obj_vals[: n + 1].cpu().numpy().astype(np.float64)
        ra, rb = a.recon.cpu().numpy(), b.recon.cpu().numpy()
        # an objective of 0 (a warm start that fits every observation)
        # is held to 0 exactly
        rel = np.abs(oa - ob) / np.where(ob == 0, 1.0, np.abs(ob))
        out["obj_max_rel_diff"] = max(out["obj_max_rel_diff"],
                                      float(np.max(rel)))
        out["recon_max_rel_diff"] = max(
            out["recon_max_rel_diff"],
            float(np.abs(ra - rb).max()) / float(np.abs(rb).max()))
    out["iters"] = n
    return out


AGREE = 1e-4  # card vs CPU: objective rtol, and recon over its scale
FLOOR_FACTOR = 4  # how far past the one-ulp spread rounding may carry


def _compare_runs(app, card, cpu, nudged):
    """Card vs CPU on the same argv: the same iterations, objective
    traces within rtol 1e-4 and reconstructions within 1e-4 of the CPU
    reconstruction's scale. Where one float32 ulp of the bank already
    moves the CPU run further (``nudged``: the CPU run with the bank
    moved by 2^-24), the problem itself is that sensitive and any two
    float32 implementations differ by as much (the JAX package against
    the port, both on the CPU, at these inputs: Poisson's objective
    8.8e-3 and recon 1.5e-4, deblurring's 1.5e-4 and 2.3e-4); there each
    limit is FLOOR_FACTOR times that one-ulp spread."""
    diff = _spread(card, cpu)
    floor = _spread(nudged, cpu)
    limits = {k: max(AGREE, FLOOR_FACTOR * floor[k])
              for k in ("obj_max_rel_diff", "recon_max_rel_diff")}
    ok = all(diff[k] <= limits[k] for k in limits)
    print(f"[11] {app} card vs CPU, {diff['iters']} iterations: objective "
          f"max rel diff {diff['obj_max_rel_diff']:.2e} (limit "
          f"{limits['obj_max_rel_diff']:.2e}), recon max diff "
          f"{diff['recon_max_rel_diff']:.2e} of its scale (limit "
          f"{limits['recon_max_rel_diff']:.2e}); one ulp of the bank moves "
          f"the CPU run {floor['obj_max_rel_diff']:.2e} / "
          f"{floor['recon_max_rel_diff']:.2e}")
    return dict(diff, one_ulp_spread=floor, limits=limits, ok=ok)


APP_BASELINE = {"poisson": "noisy input", "deblur_video": "blurred clip",
                "demosaic_hyperspectral": "smooth fill",
                "view_synthesis": "interpolated views"}
K1_APPS = ("poisson", "deblur_video")  # W == 1: K1 once per iteration


def phase_apps(torch, port, time_ms, bw, seed):
    import tempfile

    kernels = port["kernels"]
    out, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        full, small = _app_argv(port, tmp, seed)
        for app in APP_BASELINE:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.solve_z_rank1.launches = 0
            run, wall, solve_s, built = _run_app(torch, port, app, full[app],
                                                 "cuda")
            launches = kernels.solve_z_rank1.launches
            zero_objective = _check_run(app, run)
            res = _results(run)
            rec = {
                "argv": full[app], "images": len(res),
                "shape": list(res[0].recon.shape[1:]),
                "K": int(res[0].z.shape[1]), "wall_s": wall,
                "solve_s": solve_s, "iters": run.iters,
                "ms_per_iter": 1e3 * solve_s / run.iters,
                "psnr_db": run.psnr_db,
                "baseline": APP_BASELINE[app],
                "baseline_psnr_db": run.baseline_psnr_db,
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated(),
                "k1_launches": launches,
                "objective_zero_throughout": zero_objective,
                "obj_first_last": [
                    [float(r.trace.obj_vals[0]),
                     float(r.trace.obj_vals[int(r.trace.num_iters)])]
                    for r in res],
            }
            want = run.iters if app in K1_APPS else 0
            if launches != want:
                failures.append(f"{app}: K1 launched {launches} times, "
                                f"want {want}")
            if app not in K1_APPS:
                rec["woodbury"] = _woodbury_timing(torch, port, built,
                                                   time_ms, bw)
            built.clear()
            del run, res
            print(f"[11] {app} {rec['shape']} K={rec['K']}: {rec['iters']} "
                  f"iterations, wall {wall:.2f} s (solves {solve_s:.3f} s, "
                  f"{rec['ms_per_iter']:.3f} ms an iteration), PSNR "
                  f"{rec['psnr_db']:.2f} dB ({rec['baseline']} "
                  f"{rec['baseline_psnr_db']:.2f} dB), peak memory "
                  f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB, K1 "
                  f"launches {launches}"
                  + (f"; W > 1 z-solve {rec['woodbury']['solve_z_ms']:.3f} ms "
                     f"an iteration (bound {rec['woodbury']['bound_ms']:.3f} "
                     f"ms), factors built in "
                     f"{rec['woodbury']['precompute_z_kernel_ms']:.2f} ms"
                     if "woodbury" in rec else ""))
            torch.cuda.empty_cache()
            runs = [_run_app(torch, port, app, small[app], dev,
                             perturb=nudge)[0]
                    for dev, nudge in (("cuda", False), ("cpu", False),
                                       ("cpu", True))]
            rec["card_vs_cpu"] = _compare_runs(app, *runs)
            rec["card_vs_cpu"]["argv"] = small[app]
            if not rec["card_vs_cpu"]["ok"]:
                failures.append(f"{app}: card vs CPU {rec['card_vs_cpu']}")
            del runs
            out[app] = rec
    if failures:
        raise RuntimeError("apps phase: " + "; ".join(failures))
    return out


# the learner phase (12): the configurations at the reference protocol's
# widths (SURVEY.md rows 3-5, 26, 28, 30), data from --seed (the
# reference's movie, lightfield and training_data.mat are absent), each
# cut to LEARNER_STEPS outer steps at tol=0 instead of 20 or 40
LEARNER_STEPS = 2
L3D_ARGV = ["--synthetic", "--clips", "64", "--clip-size", "50",
            "--blocks", "8"]  # k=49 11x11x11, rho 5000/1: the defaults
L4D_ARGV = ["--synthetic", "--patches", "64", "--patch-size", "50",
            "--blocks", "8"]  # k=49 11x11 over 5x5 views, rho 500/50
LHS_CUBES, LHS_SIDE = 16, 100  # this script's choice: no training data
L2D_MASKED = (16, LEARN_SIDE)  # learn_2d --masked: images, side
# the same problems cut down for card vs CPU
L3D_SMALL = ["--synthetic", "--clips", "4", "--clip-size", "12",
             "--filters", "8", "--support", "5", "--support-t", "5",
             "--blocks", "2"]
L4D_SMALL = ["--synthetic", "--patches", "4", "--patch-size", "16",
             "--filters", "8", "--support", "5", "--blocks", "2"]
LHS_SMALL = ["--synthetic", "--limit", "2", "--filters", "8", "--support",
             "5"]  # 2 cubes of 31x48x48
STEPS_ARGV = ["--max-it", str(LEARNER_STEPS), "--tol", "0"]


def _learner_check(tag, res, geom, masked):
    """Finite traces, filters in the unit ball (each filter's, or each
    (filter, band/view) slice's, spatial norm <= 1 + 1e-5); returns
    (steps adopted, the largest filter norm)."""
    import math

    import numpy as np

    tr = res.trace
    vals = [v for k in ("obj_vals_d", "obj_vals_z", "d_diff", "z_diff",
                        "tim_vals", "d_pass_ms", "z_pass_ms")
            for v in tr.get(k, [])]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"{tag}: non-finite trace {tr}")
    d = res.d.cpu().numpy()
    norms = np.sqrt((d.reshape(-1, math.prod(geom.spatial_support)) ** 2)
                    .sum(1))
    if not (np.isfinite(d).all() and norms.max() <= 1 + 1e-5):
        raise RuntimeError(f"{tag}: filter norms out of the unit ball "
                           f"({norms.max()})")
    steps = len(tr["obj_vals_z"]) - (0 if masked else 1)
    return steps, float(norms.max())


def _learner_record(torch, tag, res, geom, masked, wall, data_s, launches,
                    phase=12):
    steps, norm_max = _learner_check(tag, res, geom, masked)
    tr = res.trace
    step_s = [b - a for a, b in zip(tr["tim_vals"], tr["tim_vals"][1:])]
    rec = {
        "geom": dataclasses.asdict(geom), "data_shape": list(res.Dz.shape),
        "steps": steps, "launches": launches, "step_s": step_s,
        "steps_per_s": steps / tr["tim_vals"][-1],
        "d_pass_ms": tr.get("d_pass_ms"), "z_pass_ms": tr.get("z_pass_ms"),
        "obj_vals_d": tr["obj_vals_d"], "obj_vals_z": tr["obj_vals_z"],
        "filter_norm_max": norm_max,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "wall_s": wall, "data_s": data_s,
        "rolled_back_at": tr.get("rolled_back_at"),
    }
    for i in range(steps):
        print(f"[{phase}] {tag} step {i + 1}: {step_s[i]:.3f} s (d-pass "
              f"{tr['d_pass_ms'][i]:.1f} ms, z-pass {tr['z_pass_ms'][i]:.1f}"
              f" ms), obj_d {tr['obj_vals_d'][-steps + i]:.6g}, obj_z "
              f"{tr['obj_vals_z'][-steps + i]:.6g}")
    print(f"[{phase}] {tag}: {steps} steps, {rec['steps_per_s']:.4f} steps/s, "
          f"wall {wall:.2f} s (data {data_s:.2f} s), max memory allocated "
          f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB, filter norm "
          f"max {norm_max:.6f}, launches {launches}"
          + (f", rolled back at step {rec['rolled_back_at']}"
             if masked else ""))
    return rec


def _counts(port):
    k1, fz = port["kernels"].solve_z_rank1, port["fused_z"].fused_z_iter
    return {"solve_z_rank1": k1.launches, "fused_z_pass_a": fz.launches_a,
            "fused_z_pass_b": fz.launches_b}


def _zero_counts(torch, port):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1, fz = port["kernels"].solve_z_rank1, port["fused_z"].fused_z_iter
    k1.launches = fz.launches_a = fz.launches_b = 0


def _learn_3d(torch, port, seed, tmp):
    """The 3D video learner through ``learn_3d.main`` (its wall includes
    making the clips, ``data_s``); the clips are made again here for the
    K1 case that follows."""
    app = port["learn_3d"]
    argv = L3D_ARGV + STEPS_ARGV + ["--seed", str(seed), "--device", "cuda",
                                    "--out", os.path.join(tmp, "3d.mat")]
    args = app.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    b = app.load_data(args)
    data_s = time.perf_counter() - t0
    geom, cfg = app.problem(args)
    _zero_counts(torch, port)
    t0 = time.perf_counter()
    res = app.main(argv)
    res.d.cpu()
    wall = time.perf_counter() - t0
    launches = _counts(port)
    rec = _learner_record(torch, "3D", res, geom, False, wall, data_s,
                          launches)
    want = {"solve_z_rank1": cfg.max_it_z * rec["steps"],
            "fused_z_pass_a": 0, "fused_z_pass_b": 0}
    if rec["steps"] != LEARNER_STEPS or launches != want:
        raise RuntimeError(f"3D learner: {rec['steps']} steps, launches "
                           f"{launches}, want {want}")
    if not rec["obj_vals_z"][2] < rec["obj_vals_z"][1]:
        raise RuntimeError(f"3D learner: obj_z did not fall "
                           f"{rec['obj_vals_z']}")
    return rec, res, b, geom, cfg


def _k1_at_3d_learner(torch, port, time_ms, bw, flops, res, b, geom, cfg,
                      f64=True, path="learn_3d"):
    """K1 at the 3D learner's z-solve shape (N = the clips of ``b``,
    K = 49, F = 60*60*31), on the learned filters' spectra and the clips'
    data spectra, random code targets, dinv = 1/rho_z: phase 3's checks,
    and with ``f64`` the float64 comparison."""
    cm, fourier = port["common"], port["fourier"]
    dev = torch.device("cuda", 0)
    bt = torch.from_numpy(b).to(dev)
    fg = cm.FreqGeom.create(geom, bt.shape[-3:])
    dhat = cm.filters_to_freq(res.d.to(dev), fg)[:, 0, :].contiguous()
    bhat = cm.data_to_freq(fourier.pad_spatial(bt, geom.psf_radius), fg)
    xi1 = bhat[:, 0, :].contiguous()
    del bt, bhat
    gen = torch.Generator(device=dev).manual_seed(11)
    n, (k, f) = xi1.shape[0], dhat.shape
    xi2 = torch.complex(torch.randn((n, k, f), generator=gen, device=dev),
                        torch.randn((n, k, f), generator=gen, device=dev))
    dinv = torch.full((k, f), 1.0 / cfg.rho_z, device=dev)
    case = _k1_case(torch, port["kernels"], time_ms, bw, flops, _card(torch),
                    (dhat, xi1, xi2, float(cfg.rho_z), dinv),
                    {"path": path})
    del xi2
    torch.cuda.empty_cache()
    if f64:
        case["against_f64"] = [
            _k1_against_f64(torch, port["kernels"], dhat, xi1, dinv,
                            float(cfg.rho_z), 11 + i)
            for i in range(K1_F64_DRAWS)]
    del dhat, xi1, dinv
    torch.cuda.empty_cache()
    return case


K1_F64_DRAWS = 3  # code targets drawn for the float64 comparison


def _k1_against_f64(torch, kernels, dhat, xi1, dinv, rho, draw):
    """K1 and its plain version, both in float32, against the plain
    version computed in float64, for one draw of the code target xi2
    (seeded by ``draw``): each side's largest error relative to max|z|
    of the float64 solve, and max|g| / max|z| for g = dinv (conj(d) xi1
    + rho xi2), how much of g the rank-1 correction cancels. Fatal when K1 lies farther than 1e-5 from its plain
    version or farther from the float64 solve than max(1e-5, twice the
    plain version's distance)."""
    dev = dhat.device
    gen = torch.Generator(device=dev).manual_seed(draw)
    n, (k, f) = xi1.shape[0], dhat.shape
    xi2 = torch.complex(torch.randn((n, k, f), generator=gen, device=dev),
                        torch.randn((n, k, f), generator=gen, device=dev))
    args = (dhat, xi1, xi2, rho, dinv)
    z = kernels.solve_z_rank1(*args)
    plain = kernels.solve_z_rank1_reference(*args)
    d64, di64 = dhat.to(torch.complex128), dinv.to(torch.float64)
    err_k1 = err_plain = err_kp = scale = 0.0
    g_over_z = 0.0
    for i in range(0, n, 4):  # float64 in slices of 4 clips
        sl = slice(i, i + 4)
        x1, x2 = xi1[sl].to(torch.complex128), xi2[sl].to(torch.complex128)
        ref = kernels.solve_z_rank1_reference(d64, x1, x2, rho, di64)
        g = di64[None] * (d64.conj()[None] * x1[:, None, :] + rho * x2)
        scale = max(scale, float(ref.abs().max()))
        err_k1 = max(err_k1, float((z[sl] - ref).abs().max()))
        err_plain = max(err_plain, float((plain[sl] - ref).abs().max()))
        err_kp = max(err_kp, float((z[sl] - plain[sl]).abs().max()))
        g_over_z = max(g_over_z, float(g.abs().max() / ref.abs().max()))
        del x1, x2, ref, g
    del z, plain, xi2, d64, di64
    torch.cuda.empty_cache()
    out = {"draw": draw, "k1_vs_plain": err_kp / scale,
           "k1_vs_f64": err_k1 / scale, "plain_vs_f64": err_plain / scale,
           "max_g_over_max_z": g_over_z}
    print(f"[12] K1 at the 3D learner's shape, draw {draw}: K1 vs plain "
          f"{out['k1_vs_plain']:.2e}, K1 vs float64 {out['k1_vs_f64']:.2e},"
          f" plain vs float64 {out['plain_vs_f64']:.2e} (of max|z|); "
          f"max|g| / max|z| {g_over_z:.3g}")
    if not (out["k1_vs_plain"] <= 1e-5 and out["k1_vs_f64"]
            <= max(1e-5, 2 * out["plain_vs_f64"])):
        raise RuntimeError(f"K1 at the 3D learner's shape: {out}")
    return out


def _woodbury_of(torch, port, res, geom, spatial, rho, n, time_ms, bw):
    """The W > 1 z-solve of a learner's batch on its learned filters."""
    cm = port["common"]
    fg = cm.FreqGeom.create(geom, spatial)
    dhat = cm.filters_to_freq(res.d, fg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    kern = port["freq_solvers"].precompute_z_kernel(dhat, rho)
    end.record()
    torch.cuda.synchronize()
    return _woodbury_timing(torch, port, {"kern": kern, "rho": rho,
                                          "ms": start.elapsed_time(end)},
                            time_ms, bw, n=n)


def _learn_4d(torch, port, seed, tmp, time_ms, bw):
    """The 4D lightfield learner through ``learn_4d.main`` (its wall
    includes making the patches, ``data_s``)."""
    app = port["learn_4d"]
    argv = L4D_ARGV + STEPS_ARGV + ["--seed", str(seed), "--device", "cuda",
                                    "--out", os.path.join(tmp, "4d.mat")]
    args = app.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    b = app.load_data(args)
    data_s = time.perf_counter() - t0
    geom, cfg = app.problem(args, b)
    _zero_counts(torch, port)
    t0 = time.perf_counter()
    res = app.main(argv)
    res.d.cpu()
    wall = time.perf_counter() - t0
    launches = _counts(port)
    rec = _learner_record(torch, "4D", res, geom, False, wall, data_s,
                          launches)
    if rec["steps"] != LEARNER_STEPS or any(launches.values()):
        raise RuntimeError(f"4D learner: {rec['steps']} steps, launches "
                           f"{launches} (W = 25: want none)")
    if not rec["obj_vals_z"][2] < rec["obj_vals_z"][1]:
        raise RuntimeError(f"4D learner: obj_z did not fall "
                           f"{rec['obj_vals_z']}")
    rec["woodbury"] = _woodbury_of(torch, port, res, geom, b.shape[-2:],
                                   cfg.rho_z, b.shape[0], time_ms, bw)
    print(f"[12] 4D W=25 z-solve of {b.shape[0]} patches: "
          f"{rec['woodbury']['solve_z_ms']:.3f} ms (bound "
          f"{rec['woodbury']['bound_ms']:.3f} ms), factors built in "
          f"{rec['woodbury']['precompute_z_kernel_ms']:.2f} ms")
    return rec


def _learn_hs(torch, port, seed, tmp, time_ms, bw):
    """The hyperspectral learner through ``learn_hyperspectral.main`` on
    LHS_CUBES synthetic cubes of 31 x LHS_SIDE x LHS_SIDE, written as the
    reference's .mat layout ('b' [x y w n])."""
    import numpy as np
    import scipy.io

    app = port["learn_hyperspectral"]
    t0 = time.perf_counter()
    cubes = port["volumes"].synthetic_hyperspectral(
        n=LHS_CUBES, bands=31, side=LHS_SIDE, seed=seed)
    path = os.path.join(tmp, "hs_cubes.mat")
    scipy.io.savemat(path, {"b": np.transpose(cubes, (2, 3, 1, 0))})
    data_s = time.perf_counter() - t0
    argv = ["--mat", path] + STEPS_ARGV + [
        "--seed", str(seed), "--device", "cuda",
        "--out", os.path.join(tmp, "hs.mat")]
    geom, cfg = app.problem(app.build_parser().parse_args(argv), cubes)
    _zero_counts(torch, port)
    t0 = time.perf_counter()
    res = app.main(argv)
    res.d.cpu()
    wall = time.perf_counter() - t0
    launches = _counts(port)
    rec = _learner_record(torch, "hyperspectral", res, geom, True, wall,
                          data_s, launches)
    if not 1 <= rec["steps"] <= LEARNER_STEPS or any(launches.values()):
        raise RuntimeError(f"hyperspectral learner: {rec['steps']} steps, "
                           f"launches {launches} (W = 31: want none)")
    rec["cut"] = (f"{LHS_CUBES} synthetic cubes of 31x{LHS_SIDE}x{LHS_SIDE}"
                  " (the reference's training data is absent)")
    # the z-solve's rho is the gamma divisor (learn_masked's default)
    rec["woodbury"] = _woodbury_of(torch, port, res, geom, cubes.shape[-2:],
                                   500.0, LHS_CUBES, time_ms, bw)
    print(f"[12] hyperspectral W=31 z-solve of {LHS_CUBES} cubes: "
          f"{rec['woodbury']['solve_z_ms']:.3f} ms (bound "
          f"{rec['woodbury']['bound_ms']:.3f} ms), factors built in "
          f"{rec['woodbury']['precompute_z_kernel_ms']:.2f} ms; cut: "
          f"{rec['cut']}")
    return rec


def _learn_2d_masked(torch, port, seed, tmp):
    """``learn_2d --masked`` (the masked learner at reduce_shape=(),
    whose z-solve is K1) on L2D_MASKED synthetic images read from a .mat
    stack: K1 launched max_it_z times each outer step it ran (a step the
    rollback reverts ran too)."""
    import numpy as np
    import scipy.io

    n, side = L2D_MASKED
    path = os.path.join(tmp, "masked_images.mat")
    scipy.io.savemat(path, {"b": port["images"].smooth_noise_images(
        np.random.default_rng(seed + 9), n, side)})
    argv = ["--data", path, "--mat-layout", "framework", "--masked",
            "--seed", str(seed), "--device", "cuda",
            "--out", os.path.join(tmp, "masked.mat")] + STEPS_ARGV
    _zero_counts(torch, port)
    t0 = time.perf_counter()
    res = port["learn_2d"].main(argv)
    res.d.cpu()
    wall = time.perf_counter() - t0
    launches = _counts(port)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    rec = _learner_record(torch, "2D masked", res, geom, True, wall, 0.0,
                          launches)
    ran = rec["steps"] + (1 if rec["rolled_back_at"] else 0)
    want = {"solve_z_rank1": 10 * ran, "fused_z_pass_a": 0,
            "fused_z_pass_b": 0}
    if launches != want:
        raise RuntimeError(f"2D masked learner: launches {launches}, "
                           f"want {want}")
    return rec


def _learner_spread(ra, rb, skip=0):
    """How far two learns lie apart: the objective traces' largest
    relative difference (past their first ``skip`` entries: the streaming
    learner's trace opens with 0.0) and the filters' largest difference
    over the second's scale."""
    import numpy as np

    out = {"obj_max_rel_diff": 0.0}
    for k in ("obj_vals_d", "obj_vals_z"):
        a, b = np.asarray(ra.trace[k][skip:]), np.asarray(rb.trace[k][skip:])
        if a.shape != b.shape:
            raise RuntimeError(f"{k}: {len(a)} steps against {len(b)}")
        out["obj_max_rel_diff"] = max(out["obj_max_rel_diff"], float(
            np.max(np.abs(a - b) / np.abs(b))))
    da, db = ra.d.cpu().numpy(), rb.d.cpu().numpy()
    out["d_max_rel_diff"] = float(np.abs(da - db).max() / np.abs(db).max())
    return out


def _learners_card_vs_cpu(torch, port, seed):
    """Each learner at a reduced size, LEARNER_STEPS steps from one init
    drawn on the CPU, on the card and on the CPU: objective traces within
    rtol 1e-4 and filters within 1e-4 of their scale, or within
    FLOOR_FACTOR times the spread that one float32 ulp of the initial
    dictionary puts into the CPU run, where that is larger."""
    import math

    lm, tlm, cm = port["learn"], port["learn_masked"], port["common"]
    out = {}
    for tag, app, argv in (("3D", "learn_3d", L3D_SMALL),
                           ("4D", "learn_4d", L4D_SMALL),
                           ("hyperspectral", "learn_hyperspectral",
                            LHS_SMALL)):
        mod = port[app]
        args = mod.build_parser().parse_args(
            argv + STEPS_ARGV + ["--seed", str(seed)])
        b = mod.load_data(args)
        geom, cfg = (mod.problem(args) if app == "learn_3d"
                     else mod.problem(args, b))
        gen = torch.Generator().manual_seed(seed + 4)
        fg = cm.FreqGeom.create(geom, b.shape[-geom.ndim_spatial:])
        if app == "learn_hyperspectral":
            sm = mod.gaussian_smooth_init(b)
            init = tlm.init_state(gen, geom, fg, b.shape[0])
            nudged = init._replace(d_full=torch.nextafter(
                init.d_full, torch.tensor(math.inf)))

            def run(dev, st):
                return tlm.learn_masked(b, geom, cfg, smooth_init=sm,
                                        device=dev, initial_state=st)
        else:
            N = cfg.num_blocks
            init = lm.init_state(gen, geom, fg, N, b.shape[0] // N)
            up = torch.tensor(math.inf)
            nudged = init._replace(
                d_local=torch.nextafter(init.d_local, up),
                dbar=torch.nextafter(init.dbar, up))
            cfg = dataclasses.replace(cfg, fused_z=True)

            def run(dev, st):
                return port["consensus"].learn(b, geom, cfg, device=dev,
                                               initial_state=st)
        _zero_counts(torch, port)
        card = run("cuda", init)
        launches = _counts(port)
        cpu, moved = run("cpu", init), run("cpu", nudged)
        if app != "learn_hyperspectral":
            # the fused_z gate on the card: composition, K1 only at W == 1
            k1 = cfg.max_it_z * LEARNER_STEPS if app == "learn_3d" else 0
            want = {"solve_z_rank1": k1, "fused_z_pass_a": 0,
                    "fused_z_pass_b": 0}
            if launches != want:
                raise RuntimeError(f"{tag} learner with fused_z=True on the "
                                   f"card: launches {launches}, want {want}")
        diff, floor = _learner_spread(card, cpu), _learner_spread(moved, cpu)
        limits = {k: max(AGREE, FLOOR_FACTOR * floor[k]) for k in diff}
        ok = all(diff[k] <= limits[k] for k in diff)
        print(f"[12] {tag} learner card vs CPU ({list(b.shape)}, k="
              f"{geom.num_filters}): objective max rel diff "
              f"{diff['obj_max_rel_diff']:.2e} (limit "
              f"{limits['obj_max_rel_diff']:.2e}), filters "
              f"{diff['d_max_rel_diff']:.2e} of their scale (limit "
              f"{limits['d_max_rel_diff']:.2e}); one ulp of the initial "
              f"dictionary moves the CPU run {floor['obj_max_rel_diff']:.2e}"
              f" / {floor['d_max_rel_diff']:.2e}")
        out[tag] = dict(diff, one_ulp_spread=floor, limits=limits, ok=ok,
                        data_shape=list(b.shape), k=geom.num_filters,
                        card_launches=launches)
        if not ok:
            raise RuntimeError(f"{tag} learner card vs CPU: {out[tag]}")
    return out


def phase_learners(torch, port, time_ms, bw, flops, seed):
    import tempfile

    out = {"steps_cut": f"{LEARNER_STEPS} outer steps at tol=0 each "
                        "(the reference runs 20 or 40)"}
    print(f"[12] cut: {out['steps_cut']}")
    with tempfile.TemporaryDirectory() as tmp:
        rec, res, b, geom, cfg = _learn_3d(torch, port, seed, tmp)
        rec["k1_case"] = _k1_at_3d_learner(torch, port, time_ms, bw, flops,
                                           res, b, geom, cfg)
        out["3d"] = rec
        del res, b
        torch.cuda.empty_cache()
        out["4d"] = _learn_4d(torch, port, seed, tmp, time_ms, bw)
        torch.cuda.empty_cache()
        out["hyperspectral"] = _learn_hs(torch, port, seed, tmp, time_ms, bw)
        torch.cuda.empty_cache()
        out["2d_masked"] = _learn_2d_masked(torch, port, seed, tmp)
        torch.cuda.empty_cache()
    out["card_vs_cpu"] = _learners_card_vs_cpu(torch, port, seed)
    return out


# the streaming phase (13): the 2D north star of phase 7 in each
# placement tier, then the 3D learner of phase 12 paged through
# ``learn_3d.main --streaming``, the hyperspectral app streamed, both
# learners card vs CPU at reduced sizes, and the native library
STREAM_TIERS = ("device", "kern", "paged")
# one outer step a run: the paged 2D step moves 72 GB through pageable
# copies (~19 s on the first run, PR 9)
STREAM_STEPS = 1
STREAM_STEPS_ARGV = ["--max-it", str(STREAM_STEPS), "--tol", "0"]
STREAM_TIER_AGREE = 1e-6  # the tiers: JAX's tests/test_streaming.py
# d/z/Dz vs the in-memory learner: JAX's atol 2e-5, on fields of O(1)
# there; here of max(1, the field's max), as Dz reaches ~10
STREAM_VS_INMEM = 2e-5
L3D_STREAM = L3D_ARGV + ["--streaming", "--stream-mode", "paged"]
LHS_STREAM_BLOCKS = 4
L2D_STREAM_SMALL = (4, 48, 16)  # card vs CPU: images, side, filters
NATIVE_LCN = (64, LEARN_SIDE)  # local_cn: images of the learner's side
NATIVE_FILL = (4, S)  # the smooth fill: phase 4's requests


def _copy_rate(torch, nbytes):
    """Host-to-device and device-to-host rates (bytes/s) of one blocking
    copy of ``nbytes`` from pageable host memory, as the streaming
    learner's copies are: the median of 3, host clock around a
    synchronised copy."""
    import statistics

    host = torch.empty(nbytes // 4, dtype=torch.float32).uniform_()
    dev = host.to("cuda")
    rates = {"h2d": [], "d2h": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = host.to("cuda")
        torch.cuda.synchronize()
        rates["h2d"].append(nbytes / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        host = dev.to("cpu")
        rates["d2h"].append(nbytes / (time.perf_counter() - t0))
    del host, dev
    torch.cuda.empty_cache()
    return {k: statistics.median(v) for k, v in rates.items()}


def _max_abs(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def _stream_tier_record(torch, tag, res, geom, wall, launches):
    rec = _learner_record(torch, tag, res, geom, False, wall, 0.0, launches,
                          phase=13)
    tr = res.trace
    rec.update(stream_mode=tr["stream_mode"], h2d_bytes=tr["h2d_bytes"],
               d2h_bytes=tr["d2h_bytes"])
    print(f"[13] {tag}: tier {tr['stream_mode']}, host-to-device "
          f"{[f'{x / 1e9:.2f}' for x in tr['h2d_bytes']]} GB a step, "
          f"device-to-host {[f'{x / 1e9:.2f}' for x in tr['d2h_bytes']]} GB")
    return rec


def _stream_2d(torch, port, seed):
    """The 2D north star (phase 7's configuration, fused_z off: the
    streaming learner never takes K2), the in-memory learner and then
    each tier from one host init: the tiers within
    STREAM_TIER_AGREE of each other, the streamed run within JAX's
    tolerances of the in-memory one, K1 launched max_it_z times a block
    and a step."""
    n = LEARN_BLOCKS * LEARN_NI
    b = mesh_check.training_images(seed, n, LEARN_SIDE)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    cfg = _learn_cfg(port, num_blocks=LEARN_BLOCKS, max_it=STREAM_STEPS)
    fg = port["common"].FreqGeom.create(geom, (LEARN_SIDE,) * 2)
    init = port["learn"].init_state(torch.Generator().manual_seed(seed),
                                    geom, fg, LEARN_BLOCKS, LEARN_NI)
    # the in-memory learner from the same init, first: its first step
    # pays the cuFFT plans and the allocator's growth
    _zero_counts(torch, port)
    t0 = time.perf_counter()
    mem = port["consensus"].learn(b, geom, cfg, initial_state=init,
                                  device="cuda")
    # to the host: the tiers' peaks below count their own tensors only
    mem = mem._replace(d=mem.d.cpu(), z=mem.z.cpu(), Dz=mem.Dz.cpu())
    out = {"in_memory": {
        "wall_s": time.perf_counter() - t0,
        "steps_per_s": STREAM_STEPS / mem.trace["tim_vals"][-1],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "d_pass_ms": mem.trace.get("d_pass_ms"),
        "z_pass_ms": mem.trace.get("z_pass_ms"),
    }, "tiers": {}}
    runs = {}
    for tier in STREAM_TIERS:
        _zero_counts(torch, port)
        t0 = time.perf_counter()
        res = port["streaming"].learn_streaming(
            b, geom, cfg, stream_mode=tier, initial_state=init,
            device="cuda")
        wall = time.perf_counter() - t0
        launches = _counts(port)
        rec = _stream_tier_record(torch, f"2D {tier}", res, geom, wall,
                                  launches)
        want = {"solve_z_rank1": cfg.max_it_z * LEARN_BLOCKS * rec["steps"],
                "fused_z_pass_a": 0, "fused_z_pass_b": 0}
        if rec["steps"] != STREAM_STEPS or launches != want:
            raise RuntimeError(f"2D {tier}: {rec['steps']} steps, launches "
                               f"{launches}, want {want}")
        out["tiers"][tier], runs[tier] = rec, res
    ref = runs["device"]
    tiers = {t: {f: _max_abs(getattr(runs[t], f), getattr(ref, f))
                 for f in ("d", "z", "Dz")} for t in ("kern", "paged")}
    vs_mem = {f: _max_abs(getattr(ref, f), getattr(mem, f))
              for f in ("d", "z", "Dz")}
    scale = {f: max(1.0, float(getattr(mem, f).abs().max()))
             for f in ("d", "z", "Dz")}
    vs_mem["obj_max_rel_diff"] = max(
        abs(a - c) / abs(c) for k in ("obj_vals_d", "obj_vals_z")
        for a, c in zip(ref.trace[k][1:], mem.trace[k][1:]))
    out.update(tier_max_abs_diff=tiers, vs_in_memory=vs_mem,
               vs_in_memory_scale=scale)
    print(f"[13] 2D tiers vs device: {tiers}; streamed vs in-memory: "
          f"{vs_mem} (limit {STREAM_VS_INMEM} x {scale}); in-memory "
          f"{out['in_memory']['steps_per_s']:.3f} "
          f"steps/s, peak {out['in_memory']['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    if any(v > STREAM_TIER_AGREE for t in tiers.values() for v in t.values()):
        raise RuntimeError(f"the placement tiers disagree: {tiers}")
    if not (all(vs_mem[f] <= STREAM_VS_INMEM * scale[f] for f in scale)
            and vs_mem["obj_max_rel_diff"] <= AGREE):
        raise RuntimeError(f"streamed vs in-memory learner: {vs_mem}")
    out["launches"] = sum(r["launches"]["solve_z_rank1"]
                          for r in out["tiers"].values())
    del runs, mem, ref
    torch.cuda.empty_cache()
    return out


def _stream_3d(torch, port, seed, tmp, time_ms, bw, flops, inmem_peak):
    """The 3D learner paged through ``learn_3d.main --streaming``: its
    peak device memory below phase 12's in-memory peak, K1 launched
    max_it_z times a block and a step; then K1 at a block's z-solve
    shape (N = 8 clips, K = 49, F = 111,600) on the learned filters' and
    block 0's spectra, as phase 12 holds it at N = 64."""
    app = port["learn_3d"]
    argv = L3D_STREAM + STREAM_STEPS_ARGV + [
        "--seed", str(seed), "--device", "cuda",
        "--out", os.path.join(tmp, "3ds.mat")]
    args = app.build_parser().parse_args(argv)
    b = app.load_data(args)
    geom, cfg = app.problem(args)
    _zero_counts(torch, port)
    t0 = time.perf_counter()
    res = app.main(argv)
    res.d.cpu()
    wall = time.perf_counter() - t0
    launches = _counts(port)
    rec = _stream_tier_record(torch, "3D paged", res, geom, wall, launches)
    want = {"solve_z_rank1": cfg.max_it_z * cfg.num_blocks * rec["steps"],
            "fused_z_pass_a": 0, "fused_z_pass_b": 0}
    if (rec["steps"] != STREAM_STEPS or launches != want
            or rec["stream_mode"] != "paged"):
        raise RuntimeError(f"3D streamed: {rec['steps']} steps, launches "
                           f"{launches} (want {want}), {rec['stream_mode']}")
    rec["in_memory_peak_bytes"] = inmem_peak
    print(f"[13] 3D paged peak {rec['max_memory_allocated_bytes'] / 2**30:.2f}"
          f" GiB against the in-memory learner's {inmem_peak / 2**30:.2f} GiB "
          "(phase 12)")
    if not rec["max_memory_allocated_bytes"] < inmem_peak:
        raise RuntimeError("the paged 3D learner's peak is not below the "
                           "in-memory learner's")
    ni = b.shape[0] // cfg.num_blocks
    rec["k1_case"] = _k1_at_3d_learner(torch, port, time_ms, bw, flops, res,
                                       b[:ni], geom, cfg, f64=False,
                                       path="learn_streaming_3d")
    del res, b
    torch.cuda.empty_cache()
    return rec


def _stream_hs(torch, port, seed, tmp):
    """``learn_hyperspectral --streaming --streaming-blocks 4`` at phase
    12's width (the W = 31 Woodbury z-solve, auto tier): Dz finite and
    equal, within 1e-4 of its scale, to the reconstruction of the
    returned codes by the returned filters plus the smooth_init offset
    the app subtracted."""
    import numpy as np
    import scipy.io

    app, cm, lm = port["learn_hyperspectral"], port["common"], port["learn"]
    cubes = port["volumes"].synthetic_hyperspectral(
        n=LHS_CUBES, bands=31, side=LHS_SIDE, seed=seed)
    path = os.path.join(tmp, "hs_cubes_stream.mat")
    scipy.io.savemat(path, {"b": np.transpose(cubes, (2, 3, 1, 0))})
    argv = ["--mat", path, "--streaming", "--streaming-blocks",
            str(LHS_STREAM_BLOCKS)] + STEPS_ARGV + [
        "--seed", str(seed), "--device", "cuda",
        "--out", os.path.join(tmp, "hs_stream.mat")]
    geom, _ = app.problem(app.build_parser().parse_args(argv), cubes)
    _zero_counts(torch, port)
    t0 = time.perf_counter()
    res = app.main(argv)
    res.d.cpu()
    wall = time.perf_counter() - t0
    launches = _counts(port)
    rec = _stream_tier_record(torch, "hyperspectral streamed", res, geom,
                              wall, launches)
    if rec["steps"] != LEARNER_STEPS or any(launches.values()):
        raise RuntimeError(f"hyperspectral streamed: {rec['steps']} steps, "
                           f"launches {launches} (W = 31: want none)")
    sm = torch.from_numpy(app.gaussian_smooth_init(cubes))
    fg = cm.FreqGeom.create(geom, (LHS_SIDE,) * 2)
    dhat = cm.filters_to_freq(res.d.cuda(), fg)
    raw = torch.cat([lm.f_dz_block(zb.cuda(), dhat, geom, fg,
                                   (LHS_SIDE,) * 2).cpu() for zb in res.z])
    err = float((res.Dz - (raw + sm)).abs().max())
    scale = float(res.Dz.abs().max())
    rec.update(blocks=res.z.shape[0], offset_max_abs_err=err, dz_max=scale)
    print(f"[13] hyperspectral streamed ({res.z.shape[0]} blocks, tier "
          f"{rec['stream_mode']}): Dz vs recon + offset {err:.2e} (max|Dz| "
          f"{scale:.3f})")
    if not (torch.isfinite(res.Dz).all() and err <= 1e-4 * scale):
        raise RuntimeError(f"hyperspectral streamed: Dz lost its offset "
                           f"({err})")
    return rec


def _stream_card_vs_cpu(torch, port, seed):
    """The streaming learner paged on the card against the CPU at reduced
    sizes (2D: 2 blocks of 2 48x48 images, k=16 11x11; 3D: phase 12's
    L3D_SMALL), from one host init: objective traces and filters within
    AGREE, or FLOOR_FACTOR times the spread one float32 ulp of the
    initial dictionary puts into the CPU run where that is larger."""
    import math

    lm, cm = port["learn"], port["common"]
    n, side, k = L2D_STREAM_SMALL
    app = port["learn_3d"]
    args = app.build_parser().parse_args(
        L3D_SMALL + STEPS_ARGV + ["--seed", str(seed)])
    geom3, cfg3 = app.problem(args)
    cases = {
        "2D": (mesh_check.training_images(seed + 3, n, side),
               port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, k),
               _learn_cfg(port, num_blocks=2, max_it=LEARNER_STEPS)),
        "3D": (app.load_data(args), geom3, dataclasses.replace(
            cfg3, track_objective=True, verbose="none")),
    }
    out = {}
    for tag, (b, geom, cfg) in cases.items():
        fg = cm.FreqGeom.create(geom, b.shape[-geom.ndim_spatial:])
        N = cfg.num_blocks
        init = lm.init_state(torch.Generator().manual_seed(seed + 4), geom,
                             fg, N, b.shape[0] // N)
        up = torch.tensor(math.inf)
        nudged = init._replace(d_local=torch.nextafter(init.d_local, up),
                               dbar=torch.nextafter(init.dbar, up))

        def run(dev, st, tier="paged"):
            return port["streaming"].learn_streaming(
                b, geom, cfg, stream_mode=tier, device=dev, initial_state=st)

        card, cpu, moved = run("cuda", init), run("cpu", init), \
            run("cpu", nudged)
        diff = _learner_spread(card, cpu, skip=1)
        floor = _learner_spread(moved, cpu, skip=1)
        limits = {key: max(AGREE, FLOOR_FACTOR * floor[key]) for key in diff}
        ok = all(diff[key] <= limits[key] for key in diff)
        print(f"[13] {tag} streaming card vs CPU ({list(b.shape)}, k="
              f"{geom.num_filters}): objective {diff['obj_max_rel_diff']:.2e}"
              f" (limit {limits['obj_max_rel_diff']:.2e}), filters "
              f"{diff['d_max_rel_diff']:.2e} (limit "
              f"{limits['d_max_rel_diff']:.2e})")
        out[tag] = dict(diff, one_ulp_spread=floor, limits=limits, ok=ok,
                        data_shape=list(b.shape), k=geom.num_filters)
        if not ok:
            raise RuntimeError(f"{tag} streaming card vs CPU: {out[tag]}")
    return out


def _native_check(port, seed, build):
    """The native preprocessing library: built (phase 2) and loaded, and
    its local_cn (images of the learner's, NATIVE_LCN) and smooth fill (the
    requests of phase 4, NATIVE_FILL) within the JAX package's
    tolerances of their numpy versions (tests/test_native.py: 5e-3 and
    2e-5), each timed on the host against its numpy version."""
    import numpy as np

    native, im = port["native"], port["images"]
    if not native.available():
        raise RuntimeError("the native preprocessing library is not "
                           f"available ({build})")
    rng = np.random.default_rng(seed + 13)
    raw = im.smooth_noise_images(rng, NATIVE_LCN[0], NATIVE_LCN[1])
    x, mask = _images(port, seed)
    out = {"build_s": build["seconds"], "compiled": build["compiled"],
           "path": os.path.relpath(build["path"], HERE)}
    for name, fn, ref, tol in (
        ("local_cn", lambda: native.local_cn_batch(raw),
         lambda: np.stack([im.local_contrast_normalize(i) for i in raw]),
         5e-3),
        ("smooth_fill", lambda: native.smooth_fill_batch(x, mask),
         lambda: im.smooth_fill_batch(x, mask), 2e-5),
    ):
        t0 = time.perf_counter()
        got = fn()
        t1 = time.perf_counter()
        want = ref()
        t2 = time.perf_counter()
        err = float(np.abs(got - want).max())
        out[name] = {"shape": list(got.shape), "max_abs_err": err,
                     "native_s": t1 - t0, "numpy_s": t2 - t1}
        print(f"[13] native {name} {list(got.shape)}: max abs err {err:.2e}"
              f" (limit {tol}), native {t1 - t0:.3f} s, numpy "
              f"{t2 - t1:.3f} s")
        if not err <= tol:
            raise RuntimeError(f"native {name} disagrees with numpy: {err}")
    return out


def phase_streaming(torch, port, time_ms, bw, flops, seed, inmem_3d_peak,
                    native_build):
    import tempfile

    t0 = time.perf_counter()
    out = {"copy_rate_bytes_per_s": _copy_rate(torch, 1 << 30)}
    print(f"[13] pageable copies of 1 GiB: host-to-device "
          f"{out['copy_rate_bytes_per_s']['h2d'] / 1e9:.2f} GB/s, "
          f"device-to-host {out['copy_rate_bytes_per_s']['d2h'] / 1e9:.2f} "
          "GB/s")
    out["2d"] = _stream_2d(torch, port, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    f2 = LEARN_S * (LEARN_S // 2 + 1)
    out["2d"]["k1_case"] = _k1_case(
        torch, port["kernels"], time_ms, bw, flops, _card(torch),
        _random_k1_args(torch, gen, LEARN_NI, LEARN_K, f2, False),
        {"path": "learn_streaming_2d"})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["3d"] = _stream_3d(torch, port, seed, tmp, time_ms, bw, flops,
                               inmem_3d_peak)
        out["hyperspectral"] = _stream_hs(torch, port, seed, tmp)
    out["card_vs_cpu"] = _stream_card_vs_cpu(torch, port, seed)
    out["native"] = _native_check(port, seed, native_build)
    out["seconds"] = time.perf_counter() - t0
    print(f"[13] streaming phase {out['seconds']:.1f} s")
    return out


# the mesh phase (15): SPMD ranks (parallel.distributed.launch), four
# gloo ranks sharing cuda:0 (the one-card seam of parallel.mesh.Mesh),
# then one NCCL rank
MESH_RANKS = 4
MESH_STEPS = 2  # (a): the north star's outer steps on block_mesh(4)
MESH_TRACE_RTOL, MESH_D_ATOL = 1e-4, 2e-5  # the JAX package's mesh limits
# (c): the learner meshes at phase 12's widths, cut in depth only: the
# consensus learner at the north star's (k=100 11x11, images of 100x100,
# F = 110 x 56 = 6160 bins) on 4 blocks x 10 images; the masked learner
# at the hyperspectral app's (k=100 11x11x31, cubes of 31x100x100,
# max_it_d = max_it_z = 10) on 4 cubes
MESH_LEARN_BLOCKS, MESH_LEARN_NI = 4, 10
MESH_HS_CUBES = 4


def _mesh_devices(torch):
    return [torch.device("cuda", 0)] * MESH_RANKS


def _mesh_recon_rank(rank, data, cfg_kw):
    """(b) on one rank: the sharded reconstruct of the 4 requests on
    block_mesh(4) and on a (2, 2) batch x freq mesh; K1's launches."""
    import torch

    from ccsc_code_iccv2017_torch.config import ProblemGeom, SolveConfig
    from ccsc_code_iccv2017_torch.models import reconstruct as rec
    from ccsc_code_iccv2017_torch.ops import kernels
    from ccsc_code_iccv2017_torch.parallel import mesh as mesh_lib

    b, mask, sm, d = data
    prob = rec.ReconstructionProblem(ProblemGeom((11, 11), d.shape[0]))
    cfg = SolveConfig(**cfg_kw)
    devs = _mesh_devices(torch)
    out = {}
    for tag, mesh in (
        ("block4", mesh_lib.block_mesh(MESH_RANKS, devices=devs)),
        ("batch2_freq2", mesh_lib.make_mesh((2, 2), ("batch", "freq"),
                                            devices=devs)),
    ):
        torch.cuda.synchronize()
        kernels.solve_z_rank1.launches = 0
        t0 = time.perf_counter()
        res = rec.reconstruct(b * mask, d, prob, cfg, mask=mask,
                              smooth_init=sm, x_orig=b, mesh=mesh,
                              device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.solve_z_rank1.launches
        recon = mesh_lib.gather_blocks(res.recon, mesh)
        out[tag] = dict(
            wall_s=wall, launches=launches, iters=int(res.trace.num_iters),
            obj=res.trace.obj_vals.cpu(), psnr=res.trace.psnr_vals.cpu(),
            local_n=int(res.recon.shape[0]),
            recon=None if recon is None else recon.cpu(),
        )
    return out


def _mesh_learn_rank(rank, data, seed):
    """(c) on one rank: the consensus learner on block_freq_mesh(2, 2) and
    block_filter_mesh(2, 2), the masked learner on freq_mesh(4)."""
    import torch

    from ccsc_code_iccv2017_torch.models import learn_masked as lm
    from ccsc_code_iccv2017_torch.ops import kernels
    from ccsc_code_iccv2017_torch.parallel import consensus
    from ccsc_code_iccv2017_torch.parallel import mesh as mesh_lib

    b2d, geom, cfg, bhs, sm, mgeom, mcfg = data
    devs = _mesh_devices(torch)
    out = {}
    for tag, mesh in (
        ("block2_freq2", mesh_lib.block_freq_mesh(2, 2, devices=devs)),
        ("block2_filter2", mesh_lib.block_filter_mesh(2, 2, devices=devs)),
        ("masked_freq4", mesh_lib.freq_mesh(MESH_RANKS, devices=devs)),
    ):
        kernels.solve_z_rank1.launches = 0
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if tag.startswith("masked"):
            res = lm.learn_masked(bhs, mgeom, mcfg, smooth_init=sm, mesh=mesh,
                                  generator=gen, device="cuda")
        else:
            res = consensus.learn(b2d, geom, cfg, mesh=mesh, generator=gen,
                                  device="cuda")
        torch.cuda.synchronize()
        out[tag] = dict(d=res.d.cpu(), trace=res.trace,
                        launches=kernels.solve_z_rank1.launches,
                        wall_s=time.perf_counter() - t0,
                        peak_bytes=torch.cuda.max_memory_allocated())
        del res
        torch.cuda.empty_cache()
    return out


def _mesh_compare(tag, got_d, got_tr, ref_d, ref_tr):
    import numpy as np

    d_err = float((got_d - ref_d).abs().max())
    rel = max(float(np.max(np.abs(np.subtract(got_tr[k], ref_tr[k]))
                           / np.maximum(np.abs(ref_tr[k]), 1e-30)))
              for k in ("obj_vals_d", "obj_vals_z"))
    print(f"[15] {tag}: filters {d_err:.2e} from one device, traces "
          f"{rel:.2e} (rel)")
    if not (d_err <= MESH_D_ATOL and rel <= MESH_TRACE_RTOL):
        raise RuntimeError(f"{tag}: mesh run off the one-device run "
                           f"(filters {d_err:.3e}, traces {rel:.3e})")
    return {"d_max_abs_err": d_err, "trace_max_rel_err": rel}


def _mesh_north_star(torch, port, seed):
    """(a) the north star on block_mesh(4), four gloo ranks on cuda:0,
    beside the one-card learner from the same init."""
    b = mesh_check.training_images(seed, LEARN_BLOCKS * LEARN_NI, LEARN_SIDE)
    rec = mesh_check.run(b, ranks=MESH_RANKS, steps=MESH_STEPS, seed=seed,
                         shared=True, log=lambda m: print(f"[15] (a) {m}"))
    m = rec["mesh"]
    for r in m["per_rank"]:
        print(f"[15] (a) rank {r['rank']}: K2 launches {r['launches']}, "
              f"peak {r['peak_bytes'] / 2**30:.2f} GiB, d-pass "
              f"{r['d_pass_ms']} ms, z-pass {r['z_pass_ms']} ms")
    print(f"[15] (a) {rec['steps']} steps: mesh {m['steps_per_s']:.3f} "
          f"steps/s ({m['steps_per_s_after_first']:.3f} after the first) vs "
          f"one card {rec['one_card']['steps_per_s']:.3f} "
          f"({rec['one_card']['steps_per_s_after_first']:.3f}); "
          f"consensus all-reduce {m['consensus_allreduce_ms_per_d_iter']} "
          f"ms; d {rec['d_max_abs_err']:.2e}, traces "
          f"{rec['trace_max_rel_err']:.2e}, z {rec['z_max_abs_err']:.2e} "
          f"(limit {rec['z_limit']:.2e})")
    if not rec["ok"]:
        raise RuntimeError("(a) " + "; ".join(rec["failures"]))
    return rec


def _mesh_reconstruct(torch, port, time_ms, bw, flops, seed):
    """(b) the sharded reconstruct at the serve shape against the
    one-device solve of the same 4 requests, and K1 at each per-rank
    shape against its plain version."""
    import numpy as np

    cfg_kw = dict(lambda_residual=5.0, lambda_prior=2.0, max_it=100,
                  tol=1e-3)
    d = port["io_mat"].load_filters_2d(BANK)
    b, mask = _images(port, seed)
    sm = port["images"].smooth_fill_batch(b, mask)
    rec = port["reconstruct"]
    prob = rec.ReconstructionProblem(port["config"].ProblemGeom((11, 11), K))
    cfg = port["config"].SolveConfig(**cfg_kw)
    k1 = port["kernels"].solve_z_rank1
    k1.launches = 0
    one = rec.reconstruct(b * mask, d, prob, cfg, mask=mask, smooth_init=sm,
                          x_orig=b, device="cuda")
    one_launches = k1.launches
    it = int(one.trace.num_iters)
    ref_obj = one.trace.obj_vals.cpu().numpy().astype(np.float64)
    ref_rec = one.recon.cpu().numpy()
    del one
    torch.cuda.empty_cache()
    outs = port["distributed"].launch(
        _mesh_recon_rank, MESH_RANKS, args=((b, mask, sm, d), cfg_kw),
        device="cuda:0", backend="gloo", threads=None, timeout=300.0,
        join_timeout=600.0,
    )
    b_max = float(np.abs(b * mask).max())
    out = {"one_device": {"iters": it, "launches": one_launches}}
    for tag in ("block4", "batch2_freq2"):
        got = [o[tag] for o in outs]
        obj = got[0]["obj"].numpy().astype(np.float64)
        obj_rel = float(np.max(np.abs(obj[:it + 1] - ref_obj[:it + 1])
                               / np.abs(ref_obj[:it + 1])))
        rec_abs = float(np.abs(got[0]["recon"].numpy() - ref_rec).max())
        launches = [g["launches"] for g in got]
        iters = [g["iters"] for g in got]
        print(f"[15] (b) {tag}: iterations {iters} (one device {it}), K1 "
              f"launches per rank {launches}, obj {obj_rel:.2e} (rel), recon "
              f"{rec_abs:.2e} (b max {b_max:.3f}), wall "
              f"{max(g['wall_s'] for g in got):.2f} s")
        if iters != [it] * MESH_RANKS or launches != iters:
            raise RuntimeError(f"(b) {tag}: iterations {iters} / K1 launches "
                               f"{launches}, want {it} each")
        if not (obj_rel <= 1e-4 and rec_abs <= 1e-4 * b_max):
            raise RuntimeError(f"(b) {tag}: off the one-device solve "
                               f"({obj_rel:.3e}, {rec_abs:.3e})")
        out[tag] = {"iters": iters, "launches": launches,
                    "local_n": got[0]["local_n"], "obj_max_rel_diff": obj_rel,
                    "recon_max_abs_diff": rec_abs,
                    "wall_s": [g["wall_s"] for g in got]}
    # K1 at the per-rank shapes: N=1 of the whole spectrum, N=2 of half
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(seed)
    out["k1_cases"] = []
    for n, f, tag in ((1, F, "block4"), (2, F // 2, "batch2_freq2")):
        args = _random_k1_args(torch, gen, n, K, f, False)
        out["k1_cases"].append(_k1_case(
            torch, port["kernels"], time_ms, bw, flops, _card(torch), args,
            {"mesh": tag}))
        del args
    torch.cuda.empty_cache()
    out["k1_launches"] = sum(sum(out[t]["launches"])
                             for t in ("block4", "batch2_freq2"))
    return out


def _mesh_learners(torch, port, seed):
    """(c) the 'freq' and 'filter' learner meshes and the masked learner
    on freq_mesh(4) against their one-device runs, at phase 12's widths
    (the one-device runs' peaks and time beside them)."""
    b2d = mesh_check.training_images(
        seed + 5, MESH_LEARN_BLOCKS * MESH_LEARN_NI, LEARN_SIDE)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    cfg = _learn_cfg(port, num_blocks=MESH_LEARN_BLOCKS, max_it=MESH_STEPS)
    app = port["learn_hyperspectral"]
    bhs = port["volumes"].synthetic_hyperspectral(
        n=MESH_HS_CUBES, bands=31, side=LHS_SIDE, seed=seed + 6)
    sm = app.gaussian_smooth_init(bhs)
    mgeom, mcfg = app.problem(app.build_parser().parse_args(
        ["--synthetic"] + STEPS_ARGV), bhs)
    mcfg = dataclasses.replace(mcfg, verbose="none", track_objective=True)
    data = (b2d, geom, cfg, bhs, sm, mgeom, mcfg)
    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)
    k1 = port["kernels"].solve_z_rank1
    k1.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = port["consensus"].learn(b2d, geom, cfg, generator=gen(),
                                  device="cuda")
    ref_launches = k1.launches
    ref_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mref = port["learn_masked"].learn_masked(
        bhs, mgeom, mcfg, smooth_init=sm, generator=gen(), device="cuda")
    mref_peak = torch.cuda.max_memory_allocated()
    print(f"[15] (c) one device: consensus {list(b2d.shape)} k={LEARN_K} "
          f"peak {ref_peak / 2**30:.2f} GiB, masked {list(bhs.shape)} peak "
          f"{mref_peak / 2**30:.2f} GiB")
    outs = port["distributed"].launch(
        _mesh_learn_rank, MESH_RANKS, args=(data, seed), device="cuda:0",
        backend="gloo", threads=None, timeout=300.0, join_timeout=600.0,
    )
    out = {}
    want_k1 = {"block2_freq2": cfg.max_it_z * MESH_STEPS,
               "block2_filter2": 0, "masked_freq4": 0}
    for tag in ("block2_freq2", "block2_filter2", "masked_freq4"):
        got = [o[tag] for o in outs]
        r = ref if not tag.startswith("masked") else mref
        out[tag] = _mesh_compare(f"(c) {tag}", got[0]["d"], got[0]["trace"],
                                 r.d.cpu(), r.trace)
        launches = [g["launches"] for g in got]
        out[tag].update(k1_launches=launches,
                        wall_s=[g["wall_s"] for g in got],
                        peak_bytes=[g["peak_bytes"] for g in got])
        print(f"[15] (c) {tag}: {max(out[tag]['wall_s']):.2f} s, peak "
              f"{max(out[tag]['peak_bytes']) / 2**30:.2f} GiB a rank")
        if launches != [want_k1[tag]] * MESH_RANKS:
            raise RuntimeError(f"(c) {tag}: K1 launches {launches}, want "
                               f"{want_k1[tag]} on each rank")
        if any(not torch.equal(g["d"], got[0]["d"]) for g in got):
            raise RuntimeError(f"(c) {tag}: the ranks' filters differ")
    out["one_device"] = {"k1_launches": ref_launches,
                         "consensus_peak_bytes": ref_peak,
                         "masked_peak_bytes": mref_peak,
                         "consensus_shape": list(b2d.shape),
                         "masked_shape": list(bhs.shape)}
    print(f"[15] (c) K1 launches per rank: "
          f"{ {t: out[t]['k1_launches'] for t in want_k1} }")
    return out


def _mesh_nccl_one(torch, port, seed):
    """(d) one NCCL process group of world size 1 (block_mesh(1) in this
    process): one learner step and one reconstruct through the mesh
    code, against the mesh-less calls (bitwise, or within 1e-6)."""
    import numpy as np

    mesh_lib, dist_lib = port["mesh"], port["distributed"]
    b = mesh_check.training_images(seed + 3, 4, 48)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, 16)
    cfg = _learn_cfg(port, num_blocks=2, max_it=1, fused_z=True)
    fz = port["fused_z"].fused_z_iter
    mesh = mesh_lib.block_mesh(1)
    try:
        if mesh.backend != "nccl":
            raise RuntimeError(f"(d) backend {mesh.backend}, want nccl")
        runs = {}
        for tag, m in (("plain", None), ("mesh1", mesh)):
            fz.launches_a = fz.launches_b = 0
            if m is not None:
                m.time_collectives = True
            runs[tag] = port["consensus"].learn(
                b, geom, cfg, mesh=m, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(seed))
            runs[tag + "_k2"] = [fz.launches_a, fz.launches_b]
        cons = mesh.collective_ms()
        mesh.time_collectives = False
        d_err = float((runs["mesh1"].d - runs["plain"].d).abs().max())
        z_err = float((runs["mesh1"].z - runs["plain"].z).abs().max())
        bitwise = bool(torch.equal(runs["mesh1"].d, runs["plain"].d)
                       and torch.equal(runs["mesh1"].z, runs["plain"].z))
        ri, rm = _images(port, seed)
        rec = port["reconstruct"]
        prob = rec.ReconstructionProblem(
            port["config"].ProblemGeom((11, 11), K))
        rcfg = port["config"].SolveConfig(lambda_residual=5.0,
                                          lambda_prior=2.0, max_it=10,
                                          tol=0.0)
        d = port["io_mat"].load_filters_2d(BANK)
        rr = {t: rec.reconstruct(ri[:1] * rm[:1], d, prob, rcfg,
                                 mask=rm[:1], x_orig=ri[:1], mesh=m,
                                 device="cuda")
              for t, m in (("plain", None), ("mesh1", mesh))}
        r_err = float((rr["mesh1"].recon - rr["plain"].recon).abs().max())
        r_bitwise = bool(torch.equal(rr["mesh1"].recon, rr["plain"].recon))
    finally:
        dist_lib.shutdown()
    out = {"backend": "nccl", "world_size": 1,
           "learn_d_max_abs_diff": d_err, "learn_z_max_abs_diff": z_err,
           "learn_bitwise": bitwise, "k2_launches": runs["mesh1_k2"],
           "consensus_allreduce_ms": cons.get("consensus", []),
           "learn_step_s": {t: runs[t].trace["tim_vals"][-1]
                            for t in ("plain", "mesh1")},
           "recon_max_abs_diff": r_err, "recon_bitwise": r_bitwise}
    print(f"[15] (d) NCCL world 1: learner step bitwise {bitwise} (d "
          f"{d_err:.1e}, z {z_err:.1e}), K2 {runs['mesh1_k2']}, step "
          f"{out['learn_step_s']} s, consensus all-reduce "
          f"{np.median(out['consensus_allreduce_ms']):.4f} ms (median); "
          f"reconstruct bitwise {r_bitwise} ({r_err:.1e})")
    if not (d_err <= 1e-6 and z_err <= 1e-6 and r_err <= 1e-6):
        raise RuntimeError(f"(d) the mesh of one is off the mesh-less call: "
                           f"{out}")
    if runs["mesh1_k2"] != [cfg.max_it_z] * 2:
        raise RuntimeError(f"(d) K2 launches {runs['mesh1_k2']}")
    return out


def phase_mesh(torch, port, time_ms, bw, flops, seed):
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"north_star": _mesh_north_star(torch, port, seed)}
    out["reconstruct"] = _mesh_reconstruct(torch, port, time_ms, bw, flops,
                                           seed)
    out["learners"] = _mesh_learners(torch, port, seed)
    out["nccl_world_1"] = _mesh_nccl_one(torch, port, seed)
    out["seconds"] = time.perf_counter() - t0
    print(f"[15] mesh phase {out['seconds']:.1f} s")
    return out


# the mesh serving phase (16): phase 10's stream through engines whose
# mesh positions share cuda:0 (repeated mesh_devices), beside the
# single-device engine; then K2's plane-size gate at 256²
SERVE_MESHES = (((2,), (0, 0)), ((2, 2), (0, 0, 0, 0)))
GATE_BLOCKS, GATE_NI = 2, 4  # (c): the learn_2d step at 256²
SMEM_SIDES = range(16, 301)


def _serve_mesh_engine(torch, port, seed, mesh_shape, mesh_devices):
    """One engine over phase 10's requests, K1's count set to 0 just
    before the stream and read just after: (served, record)."""
    import numpy as np

    bench, kernels = port["serve_bench"], port["kernels"]
    d = port["io_mat"].load_filters_2d(BANK)
    prob = port["reconstruct"].ReconstructionProblem(
        port["config"].ProblemGeom((11, 11), K))
    cfg = port["config"].SolveConfig(lambda_residual=5.0, lambda_prior=2.0,
                                     max_it=100, tol=1e-3)
    reqs = bench.make_requests(ENGINE_SIDES, seed + 4)
    t0 = time.perf_counter()
    with port["serve"].CodecEngine(
            d, prob, cfg, port["config"].ServeConfig(
                buckets=((ENGINE_SLOTS, (S, S)),), verbose="none",
                mesh_shape=mesh_shape, mesh_devices=mesh_devices),
            device="cuda") as eng:
        warm_s = time.perf_counter() - t0
        kernels.solve_z_rank1.launches = 0
        served, engine_s, submit_s = bench.run_engine(eng, reqs)
        launches = kernels.solve_z_rank1.launches
        log = eng.dispatch_log
        devices = [str(v) for v in eng.position_devices]
    full = [e for e in log if e["requests"] == ENGINE_SLOTS]
    lat = 1e3 * np.array([r.latency_s for r in served])
    rec = {
        "mesh": list(mesh_shape), "position_devices": devices,
        "warm_s": warm_s, "engine_wall_s": engine_s,
        "submit_wall_s": submit_s,
        "requests_per_sec": len(served) / engine_s,
        "full_dispatch_requests_per_sec": (
            sum(e["requests"] for e in full) / sum(e["wall_s"] for e in full)
            if full else None),
        "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)), "max_ms": float(lat.max()),
        "k1_launches": launches,
        "dispatch_requests": [e["requests"] for e in log],
        "dispatch_iters": [e["iters"] for e in log],
        "position_iters": [e["position_iters"] for e in log],
        "gathers": [e["gathers"] for e in log],
        "dispatch_ms": [1e3 * e["wall_s"] for e in log],
    }
    want = sum(sum(e["position_iters"]) for e in log)
    tag = "x".join(map(str, mesh_shape)) or "one device"
    print(f"[16] (a) {tag} on {devices}: warm {warm_s:.2f} s; "
          f"{len(served)} requests in {engine_s * 1e3:.1f} ms over "
          f"{len(log)} dispatches ({rec['requests_per_sec']:.3f} requests/s,"
          f" {rec['full_dispatch_requests_per_sec']:.3f} over full "
          f"dispatches; p50 {rec['p50_ms']:.1f} ms, p90 {rec['p90_ms']:.1f}"
          f" ms, max {rec['max_ms']:.1f} ms); K1 launches {launches} (sum of "
          f"the positions' iterations {want}); gathers {rec['gathers']}")
    if launches != want:
        raise RuntimeError(f"{tag}: K1 launched {launches} times for "
                           f"position iterations {rec['position_iters']}")
    for e in log:
        gathers_want = (e["position_iters"] if len(mesh_shape) == 2
                        else [0] * len(e["position_iters"]))
        if e["gathers"] != gathers_want:
            raise RuntimeError(f"{tag}: gathers {e['gathers']} for position "
                               f"iterations {e['position_iters']}")
    return reqs, served, rec


def _serve_mesh_vs_one(tag, reqs, served, ref):
    """Each request of a mesh engine against the single-device engine's:
    phase 10's limits."""
    import numpy as np

    worst = {"exact": 0.0, "padded": 0.0}
    for i, (q, s, r) in enumerate(zip(reqs, served, ref)):
        side = q["b"].shape[0]
        b_max = float(np.abs(q["b"]).max())
        err = float(np.abs(s.recon - r.recon).max()) / b_max
        exact = side == S
        if not (np.isfinite(s.recon).all() and s.recon.shape == (side, side)):
            raise RuntimeError(f"{tag} request {i}: bad recon "
                               f"{s.recon.shape}")
        if exact and (int(s.trace.num_iters) != int(r.trace.num_iters)
                      or not err <= 1e-4):
            raise RuntimeError(
                f"{tag} request {i}: {int(s.trace.num_iters)} iterations vs "
                f"{int(r.trace.num_iters)}, diff {err:.3e} of max|b|")
        if not exact and not err <= 1e-3:
            raise RuntimeError(f"{tag} padded request {i}: diff {err:.3e}")
        key = "exact" if exact else "padded"
        worst[key] = max(worst[key], err)
    print(f"[16] (a) {tag} vs one device: max|diff| / max|b| "
          f"{worst['exact']:.2e} (exact), {worst['padded']:.2e} (padded), "
          f"the same iterations")
    return worst


def _fused_gate(torch, port, seed):
    """(c) K2's plane-size gate: the smem twin against the library, then
    one learn_2d-configured consensus step at 256² (266² planes, above
    K2's limit) with fused_z on and off from one init."""
    import numpy as np

    fz, lib = port["fused_z"], port["fused_z"]._library()
    bad = [(sy, sx, pb) for sy in SMEM_SIDES for sx in SMEM_SIDES
           for pb in (0, 1)
           if fz.smem_bytes(sy, sx, bool(pb))
           != lib.ccsc_fused_z_smem_bytes(sy, sx, pb)]
    if bad:
        raise RuntimeError(f"smem_bytes twin differs from the library at "
                           f"{bad[:5]} ({len(bad)} cases)")
    n_pairs = len(SMEM_SIDES) ** 2
    side = S
    b = mesh_check.training_images(seed + 16, GATE_BLOCKS * GATE_NI, side)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    fg = port["common"].FreqGeom.create(geom, (side, side))
    k1, fzi = port["kernels"].solve_z_rank1, fz.fused_z_iter
    runs, counts, wall = {}, {}, {}
    for fused in (True, False):
        cfg = _learn_cfg(port, num_blocks=GATE_BLOCKS, max_it=1,
                         fused_z=fused)
        k1.launches = fzi.launches_a = fzi.launches_b = 0
        t0 = time.perf_counter()
        runs[fused] = port["consensus"].learn(
            b, geom, cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(seed),
        )
        wall[fused] = time.perf_counter() - t0
        counts[fused] = [k1.launches, fzi.launches_a, fzi.launches_b]
    want = _learn_cfg(port).max_it_z
    da, db = (runs[f].d.cpu().numpy() for f in (True, False))
    za, zb = (runs[f].trace["obj_vals_z"] for f in (True, False))
    print(f"[16] (c) smem twin == library for {n_pairs} planes x 2 passes; "
          f"a {fg.spatial_shape[0]}x{fg.spatial_shape[1]} plane: fits "
          f"{fz.fits(*fg.spatial_shape)}; one step fused_z=True in "
          f"{wall[True]:.2f} s, launches (K1, K2a, K2b) {counts[True]}, "
          f"fused_z=False {counts[False]}; filters bitwise "
          f"{bool(np.array_equal(da, db))}, obj_z {za} vs {zb}")
    if fz.fits(*fg.spatial_shape):
        raise RuntimeError(f"{fg.spatial_shape} should exceed K2's limit")
    if counts[True] != [want, 0, 0] or counts[False] != [want, 0, 0]:
        raise RuntimeError(f"gate launches {counts}, want [{want}, 0, 0]")
    if not (np.array_equal(da, db) and za == zb):
        raise RuntimeError("fused_z=True at 266² is not the composition's "
                           "bits")
    return {"smem_pairs_checked": n_pairs, "plane": list(fg.spatial_shape),
            "launches": {"fused_z_true": counts[True],
                         "fused_z_false": counts[False]},
            "obj_vals_z": za, "wall_s": wall[True], "bitwise": True}


def phase_serve_mesh(torch, port, time_ms, bw, flops, seed):
    """16: mesh serving on one card, then K1 at the positions' shapes,
    then K2's gate."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reqs, ref, one = _serve_mesh_engine(torch, port, seed, (), None)
    out = {"one_device": one, "meshes": {}}
    for shape, devs in SERVE_MESHES:
        tag = "x".join(map(str, shape))
        _, served, rec = _serve_mesh_engine(torch, port, seed, shape, devs)
        rec["vs_one_device"] = _serve_mesh_vs_one(tag, reqs, served, ref)
        rec["speedup_vs_one_device"] = (rec["requests_per_sec"]
                                        / one["requests_per_sec"])
        out["meshes"][tag] = rec
        del served
        torch.cuda.empty_cache()
    # (b) K1 at each position's shape: N=2 slots of the whole spectrum
    # ((2,)), N=2 of half of it ((2, 2))
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(seed)
    out["k1_cases"] = []
    for n, f, tag in ((2, F, "serve_mesh_2"), (2, F // 2, "serve_mesh_2x2")):
        args = _random_k1_args(torch, gen, n, K, f, False)
        out["k1_cases"].append(_k1_case(
            torch, port["kernels"], time_ms, bw, flops, _card(torch), args,
            {"mesh": tag}))
        del args
    torch.cuda.empty_cache()
    out["fused_gate"] = _fused_gate(torch, port, seed)
    out["k1_launches"] = sum(r["k1_launches"] for r in
                             [one, *out["meshes"].values()])
    out["seconds"] = time.perf_counter() - t0
    print(f"[16] mesh serving phase {out['seconds']:.1f} s")
    return out


# the telemetry phase (17): phase 7's learner instrumented and profiled,
# phase 10's stream through instrumented engines, one direct request and
# a learner CLI in a fresh process
TEL_STEPS = 2
TEL_CLI = ["--synthetic", "--clips", "4", "--clip-size", "16",
           "--clip-frames", "12", "--filters", "8", "--support", "5",
           "--support-t", "5", "--blocks", "2", "--max-it", "1", "--tol",
           "0", "--verbose", "none"]


def _stream(port, path):
    """The records of a metrics dir, each held to the declared schema."""
    schema = port["obs_schema"]
    events = port["obs"].read_events(path)
    for e in events:
        missing = schema.required_fields(e["type"]) - set(e)
        if missing:
            raise RuntimeError(f"{path}: a {e['type']} record lacks "
                               f"{sorted(missing)}")
    by = {}
    for e in events:
        by.setdefault(e["type"], []).append(e)
    return events, by


def _trace_kernels(port, path):
    """Kernel events of the one profiler trace in ``path`` by
    profile_solve.kernel_kind: {kind: count}."""
    names = [n for n in os.listdir(path) if n.endswith(".pt.trace.json")]
    if len(names) != 1:
        raise RuntimeError(f"{path}: expected one trace file, got {names}")
    with open(os.path.join(path, names[0])) as f:
        events = json.load(f)["traceEvents"]
    kinds = {}
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel":
            k = port["profile_solve"].kernel_kind(e.get("name", ""))
            kinds[k] = kinds.get(k, 0) + 1
    if not kinds:
        raise RuntimeError(f"{path}: the trace holds no kernel events")
    return kinds


def _tel_extras_ms(torch, port, z):
    """Device ms of the step's telemetry scalars (``learn.obs_extras``)
    on the learner's codes ``z`` and a random per-block dictionary of
    the north star's shape: what ``metrics_dir`` adds inside a step."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    d_local = torch.randn((LEARN_BLOCKS, LEARN_K, *z.shape[-2:]),
                          generator=gen, device="cuda")
    dbar = d_local.mean(0)
    zero = torch.zeros((), device="cuda")
    return port["device"].device_time_ms(
        lambda: port["learn"].obs_extras(z, d_local, dbar, zero, zero,
                                         LEARN_BLOCKS))


def _tel_learn(torch, port, seed, phase7, tmp):
    """(a) phase 7's learner for TEL_STEPS steps: plain, with metrics_dir,
    again with metrics_dir, plain again (the two pairs in ABBA order, so
    a drift of the card's clock over the runs cancels in the mean), and
    with metrics_dir and profile_dir. The device time of the step's
    telemetry scalars alone is measured on the first plain run's codes."""
    import numpy as np

    b = mesh_check.training_images(seed, LEARN_BLOCKS * LEARN_NI, LEARN_SIDE)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    fz = port["fused_z"].fused_z_iter
    want = mesh_check.CFG["max_it_z"] * TEL_STEPS
    runs = {}
    extras_ms = None
    for tag in ("plain", "metrics", "metrics_2", "plain_2", "profiled"):
        mdir = None if tag.startswith("plain") else \
            os.path.join(tmp, f"a_{tag}")
        pdir = os.path.join(tmp, "a_trace") if tag == "profiled" else None
        cfg = _learn_cfg(port, num_blocks=LEARN_BLOCKS, max_it=TEL_STEPS,
                         fused_z=True, metrics_dir=mdir)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fz.launches_a = fz.launches_b = 0
        t0 = time.perf_counter()
        res = port["consensus"].learn(b, geom, cfg, generator=gen,
                                      device="cuda", profile_dir=pdir)
        peak = torch.cuda.max_memory_allocated()
        wall = time.perf_counter() - t0
        launches = (fz.launches_a, fz.launches_b)
        tr = res.trace
        rec = {"wall_s": wall, "launches": list(launches),
               "steps_per_s": TEL_STEPS / tr["tim_vals"][-1],
               "step_s": np.diff(tr["tim_vals"]).tolist(),
               "max_memory_allocated_bytes": peak,
               "d": res.d.cpu().numpy(),
               "traces": {k: tr[k] for k in ("obj_vals_d", "obj_vals_z",
                                              "d_diff", "z_diff")}}
        if extras_ms is None:
            extras_ms = _tel_extras_ms(torch, port, res.z)
        del res
        print(f"[17] (a) {tag}: {TEL_STEPS} steps in {wall:.2f} s "
              f"({rec['steps_per_s']:.3f} steps/s, steps "
              f"{[round(x, 3) for x in rec['step_s']]} s); K2 launches "
              f"{launches}, peak {peak / 2**30:.2f} GiB")
        if launches != (want, want):
            raise RuntimeError(f"(a) {tag}: K2 launches {launches}, want "
                               f"{want} each")
        if mdir is not None:
            _, by = _stream(port, mdir)
            steps = by.get("step", [])
            if [s["it"] for s in steps] != list(range(1, TEL_STEPS + 1)):
                raise RuntimeError(f"(a) {tag}: step records {steps}")
            for s in steps:
                if s["nonfinite_z"] != 0 or not abs(
                        s["obj_fid"] + s["obj_l1"] - s["obj_z"]) <= \
                        1e-5 * abs(s["obj_z"]):
                    raise RuntimeError(f"(a) {tag}: step record {s}")
            roofs = by.get("roofline", [])
            if len(roofs) != TEL_STEPS or not all(
                    r["chip"] == "h100" and 0 < r["hbm_frac"] <= 1.05
                    and r["bound_it_per_sec"] > 0 for r in roofs):
                raise RuntimeError(f"(a) {tag}: roofline records {roofs}")
            wm = by.get("mem_watermark", [])
            if len(wm) != 1 or wm[0]["peak_hbm_bytes"] != peak:
                raise RuntimeError(f"(a) {tag}: mem_watermark {wm} vs "
                                   f"max_memory_allocated {peak}")
            summ = by.get("summary", [])
            if [x["status"] for x in summ] != ["ok"]:
                raise RuntimeError(f"(a) {tag}: summaries {summ}")
            rec["roofline"] = [{k: r[k] for k in (
                "it_per_sec", "hbm_frac", "mfu", "achieved_gbps",
                "achieved_tflops", "bound_it_per_sec", "roofline_frac")}
                for r in roofs]
            rec["modeled_hbm_bytes"] = wm[0]["modeled_hbm_bytes"]
            rec["n_records"] = summ[0]["n_events"]
            print(f"[17] (a) {tag}: roofline hbm_frac "
                  f"{[r['hbm_frac'] for r in roofs]}, bound "
                  f"{roofs[0]['bound_it_per_sec']:.3f} it/s; "
                  f"mem_watermark {peak} bytes = max_memory_allocated")
        if pdir is not None:
            kinds = _trace_kernels(port, pdir)
            rec["trace_kernels"] = kinds
            print(f"[17] (a) profiler trace kernels by kind: {kinds}")
            if (kinds.get("K2a"), kinds.get("K2b")) != launches:
                raise RuntimeError(f"(a) the trace holds K2a/K2b "
                                   f"{kinds.get('K2a')}/{kinds.get('K2b')} "
                                   f"kernel events, the counters {launches}")
        runs[tag] = rec
    # the trajectory: bitwise phase 7's first steps and the plain run's
    n = TEL_STEPS + 1
    ref7 = {k: phase7[k][:n] for k in ("obj_vals_d", "obj_vals_z")}
    plain = runs["plain"]
    repeatable = all(plain["traces"][k] == ref7[k] for k in ref7)
    spread = max(max(abs(a - c) for a, c in zip(plain["traces"][k], ref7[k]))
                 for k in ref7)
    for tag in ("metrics", "metrics_2", "plain_2", "profiled"):
        r = runs[tag]
        d_diff = float(np.abs(r["d"] - plain["d"]).max())
        tr_diff = max(max(abs(a - c) for a, c in zip(r["traces"][k],
                                                     plain["traces"][k]))
                      for k in plain["traces"])
        r["d_max_abs_diff_vs_plain"] = d_diff
        r["trace_max_abs_diff_vs_plain"] = tr_diff
        ok = (d_diff == 0.0 and tr_diff == 0.0) if repeatable else \
            tr_diff <= spread
        if not ok:
            raise RuntimeError(f"(a) {tag}: d {d_diff:.3e}, traces "
                               f"{tr_diff:.3e} from the plain run "
                               f"(phase 7 repeatable: {repeatable}, "
                               f"spread {spread:.3e})")
    print(f"[17] (a) plain run bitwise phase 7's first {TEL_STEPS} steps: "
          f"{repeatable} (spread {spread:.3e}); the telemetry runs bitwise "
          "the plain run")
    plain_d = runs["plain"]["d"]
    for r in runs.values():
        del r["d"]
    # a step's mean seconds over both runs of each ABBA pair, and what
    # the telemetry scalars' device time explains of their difference
    step_s = {arm: float(np.mean(runs[arm]["step_s"] + runs[f"{arm}_2"][
        "step_s"])) for arm in ("plain", "metrics")}
    added_ms = 1e3 * (step_s["metrics"] - step_s["plain"])
    print(f"[17] (a) a step: {step_s['plain']:.4f} s plain, "
          f"{step_s['metrics']:.4f} s with metrics_dir (ABBA means, "
          f"{added_ms:+.2f} ms); the telemetry scalars alone "
          f"{extras_ms:.3f} ms of device time")
    return {"repeatable_vs_phase7": repeatable, "spread_vs_phase7": spread,
            "runs": runs, "mean_step_s": step_s, "plain_d": plain_d,
            "metrics_added_ms_per_step": added_ms,
            "obs_extras_ms": extras_ms,
            "slowdown_metrics": runs["metrics"]["wall_s"]
            / runs["plain"]["wall_s"],
            "slowdown_profiled": runs["profiled"]["wall_s"]
            / runs["plain"]["wall_s"]}


def _tel_engine(torch, port, seed, phase10, tmp, tag):
    """(b) phase 10's 42 requests through a 4-slot 256² engine: ``plain``
    (the same phase's baseline), ``metrics`` (metrics_dir) and
    ``slo_profiled`` (metrics_dir and a 1 µs p99 target that arms the
    one-shot capture). Every request bitwise phase 10's; with a stream,
    its spans and records."""
    import numpy as np

    bench, kernels = port["serve_bench"], port["kernels"]
    d = port["io_mat"].load_filters_2d(BANK)
    prob = port["reconstruct"].ReconstructionProblem(
        port["config"].ProblemGeom((11, 11), K))
    cfg = port["config"].SolveConfig(lambda_residual=5.0, lambda_prior=2.0,
                                     max_it=100, tol=1e-3)
    reqs = bench.make_requests(ENGINE_SIDES, seed + 4)
    mdir = None if tag == "plain" else os.path.join(tmp, f"b_{tag}")
    pdir = os.path.join(tmp, f"b_{tag}_trace")
    slo_kw = (dict(slo_p99_ms=0.001, slo_check_s=0.001,
                   slo_profile_dir=pdir) if tag == "slo_profiled" else {})
    with port["serve"].CodecEngine(
            d, prob, cfg, port["config"].ServeConfig(
                buckets=((ENGINE_SLOTS, (S, S)),), verbose="none",
                metrics_dir=mdir, **slo_kw),
            device="cuda") as eng:
        kernels.solve_z_rank1.launches = 0
        served, engine_s, submit_s = bench.run_engine(eng, reqs)
        launches = kernels.solve_z_rank1.launches
    # read once close() has drained the worker: the stream is complete
    log, st = eng.dispatch_log, eng.stats()
    if launches != sum(e["iters"] for e in log):
        raise RuntimeError(f"(b) {tag}: K1 launched {launches} times for "
                           f"dispatches of {[e['iters'] for e in log]}")
    for i, (s, r) in enumerate(zip(served, phase10["served"])):
        if not (np.array_equal(s.recon, r.recon)
                and int(s.trace.num_iters) == int(r.trace.num_iters)):
            raise RuntimeError(f"(b) {tag}: request {i} differs from phase "
                               f"10's: max|diff| "
                               f"{float(np.abs(s.recon - r.recon).max()):.3e}")
    # the p99 of 42 latencies is their max (the histogram's clamp); the
    # p50 lies below it and is answered from a bucket's edge
    lat_ms = [1e3 * s.latency_s for s in served]
    hist = port["slo"].Histogram.of(lat_ms)
    rec = {"requests_per_sec": len(served) / engine_s,
           "engine_wall_s": engine_s, "submit_wall_s": submit_s,
           "k1_launches": launches, "dispatches": len(log),
           "dispatch_ms": [1e3 * e["wall_s"] for e in log]}
    for name, q in (("p50", 0.50), ("p99", 0.99)):
        exact = port["obs"].percentile(lat_ms, q)
        got = 1e3 * st[f"{name}_latency_s"]
        if not abs(got - exact) <= hist.bucket_width_ms(exact):
            raise RuntimeError(f"(b) {tag}: stats() {name} {got:.3f} ms vs "
                               f"exact {exact:.3f} ms (bucket "
                               f"{hist.bucket_width_ms(exact)})")
        rec[f"stats_{name}_ms"], rec[f"exact_{name}_ms"] = got, exact
    walls = [e["wall_s"] for e in log]
    reqs_n = [e["requests"] for e in log]
    if mdir is not None:
        events, by = _stream(port, mdir)
        traces = port["trace"].assemble(events)
        full = [t for t in traces.values() if t.complete and {
            s.name for s in t.spans.values()} == {"request", "engine_queue",
                                                  "solve"}]
        if len(full) != len(reqs) or len(traces) != len(reqs):
            raise RuntimeError(f"(b) {tag}: {len(full)} complete traces of "
                               f"{len(traces)}, want {len(reqs)}")
        disp = by.get("serve_dispatch", [])
        if len(by.get("serve_request", [])) != len(reqs) or [
                (e["n"], e["max_iters"]) for e in disp] != [
                (e["requests"], e["iters"]) for e in log]:
            raise RuntimeError(f"(b) {tag}: serve_dispatch records "
                               f"{[(e['n'], e['max_iters']) for e in disp]}"
                               " vs the dispatch log")
        rec["n_records"] = len(events)
        if slo_kw:
            profs = by.get("slo_profile", [])
            if len(profs) != 1 or not by.get("slo_breach"):
                raise RuntimeError(f"(b) {tag}: slo_profile records {profs}")
            # the dispatch the capture held: the first serve_dispatch
            # record after the slo_profile record
            i0 = events.index(profs[0])
            profiled = next(e for e in events[i0:]
                            if e["type"] == "serve_dispatch")
            kinds = _trace_kernels(port, pdir)
            rec.update(profiled_dispatch_iters=profiled["max_iters"],
                       trace_kernels=kinds)
            print(f"[17] (b) {tag}: the SLO capture holds {kinds} for a "
                  f"dispatch of {profiled['max_iters']} iterations")
            if kinds.get("K1") != profiled["max_iters"]:
                raise RuntimeError(f"(b) the SLO capture holds "
                                   f"{kinds.get('K1')} K1 kernel events for "
                                   f"{profiled['max_iters']} iterations")
            # the rate without the captured dispatch
            j = disp.index(profiled)
            walls, reqs_n = walls[:j] + walls[j + 1:], \
                reqs_n[:j] + reqs_n[j + 1:]
    rec["dispatch_requests_per_sec"] = sum(reqs_n) / sum(walls)
    b10 = phase10["bench"]
    rate10 = 1e3 * sum(b10["dispatch_requests"]) / sum(b10["dispatch_ms"])
    print(f"[17] (b) {tag}: {rec['requests_per_sec']:.3f} requests/s over "
          f"the window (submits {1e3 * submit_s:.0f} ms), "
          f"{rec['dispatch_requests_per_sec']:.3f} over its unprofiled "
          f"dispatches, vs phase 10's {b10['engine_requests_per_sec']:.3f} "
          f"and {rate10:.3f}; stats() p50 {rec['stats_p50_ms']:.1f} ms vs "
          f"exact {rec['exact_p50_ms']:.1f} ms, p99 "
          f"{rec['stats_p99_ms']:.1f} vs {rec['exact_p99_ms']:.1f}; every "
          "request bitwise phase 10's"
          + ("" if mdir is None else f"; {len(reqs)} complete span trees"))
    return rec


def _tel_reconstruct(torch, port, seed, tmp):
    """(c) one 256² request through reconstruct(plan=...), untraced and
    with SolveConfig(metrics_dir=)."""
    import numpy as np

    kernels = port["kernels"]
    rmod = port["reconstruct"]
    d = port["io_mat"].load_filters_2d(BANK)
    prob = rmod.ReconstructionProblem(port["config"].ProblemGeom((11, 11), K))
    kw = dict(lambda_residual=5.0, lambda_prior=2.0, max_it=100, tol=1e-3)
    q = port["serve_bench"].make_requests([S], seed + 4)[0]
    plan = rmod.build_plan(d, prob, port["config"].SolveConfig(**kw), (S, S),
                           device="cuda")
    mdir = os.path.join(tmp, "c")
    out = {}
    for tag, cfg in (("plain", port["config"].SolveConfig(**kw)),
                     ("metrics", port["config"].SolveConfig(
                         **kw, metrics_dir=mdir))):
        torch.cuda.synchronize()
        kernels.solve_z_rank1.launches = 0
        t0 = time.perf_counter()
        res = rmod.reconstruct(
            q["b"][None], d, prob, cfg, mask=q["mask"][None],
            smooth_init=q["smooth_init"][None], x_orig=q["x_orig"][None],
            plan=plan, device="cuda")
        recon = res.recon.cpu().numpy()
        out[tag] = {"wall_s": time.perf_counter() - t0,
                    "k1_launches": kernels.solve_z_rank1.launches,
                    "iters": int(res.trace.num_iters), "recon": recon}
    p, m = out["plain"], out["metrics"]
    _, by = _stream(port, mdir)
    steps = [s["it"] for s in by.get("step", [])]
    summ = by.get("summary", [{}])[-1]
    print(f"[17] (c) direct request: {p['iters']} iterations, K1 "
          f"{p['k1_launches']} / {m['k1_launches']} launches, "
          f"{p['wall_s']:.3f} s untraced, {m['wall_s']:.3f} s traced; steps "
          f"{steps[:1]}..{steps[-1:]}, summary iterations "
          f"{summ.get('iterations')}")
    if not (np.array_equal(p["recon"], m["recon"])
            and p["k1_launches"] == m["k1_launches"] == p["iters"]
            and steps == list(range(1, p["iters"] + 1))
            and summ.get("iterations") == p["iters"]):
        raise RuntimeError(f"(c) the traced request differs: {out}")
    for r in out.values():
        del r["recon"]
    # the fixed cost of a run: open it (run_meta, git_sha, memwatch) and
    # close it (the summary, an fsync)
    t0 = time.perf_counter()
    sha = port["obs"].git_sha()
    t1 = time.perf_counter()
    run = port["obs"].start_run(os.path.join(tmp, "c_empty"),
                                algorithm="reconstruct", verbose="none",
                                device="cuda")
    run.close(status="ok")
    out["git_sha_s"] = t1 - t0
    out["empty_run_s"] = time.perf_counter() - t1
    print(f"[17] (c) an empty run opens and closes in "
          f"{out['empty_run_s']:.4f} s (git_sha {out['git_sha_s']:.4f} s, "
          f"{sha})")
    return out


def _tel_cli(port, tmp):
    """(d) learn_3d in a fresh process with --metrics-dir: its stream
    validates, and its one compile record loads K1 (built in phase 2)."""
    import subprocess

    mdir = os.path.join(tmp, "d")
    cmd = [sys.executable, "-m", f"{PACKAGE}.apps.learn_3d", *TEL_CLI,
           "--metrics-dir", mdir, "--device", "cuda",
           "--out", os.path.join(tmp, "d_filters.mat")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=HERE))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"(d) learn_3d exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    _, by = _stream(port, mdir)
    comp = [(c["kind"], c["fun_name"]) for c in by.get("compile", [])]
    algo = [m["algorithm"] for m in by.get("run_meta", [])]
    print(f"[17] (d) learn_3d --metrics-dir in a fresh process: {wall:.1f} s,"
          f" runs {algo}, compile records {comp}")
    if comp != [("load", "solve_z_rank1")] or algo != ["consensus"] or [
            x["status"] for x in by.get("summary", [])] != ["ok"]:
        raise RuntimeError(f"(d) compile records {comp}, runs {algo}")
    return {"wall_s": wall, "compile": comp,
            "steps": len(by.get("step", []))}


def phase_telemetry(torch, port, seed, phase7, phase10):
    """17: the run telemetry on the card: (a) the learner, (b) the
    engine, (c) the direct reconstruct, (d) a learner CLI."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ccsc-telemetry-")
    try:
        out = {"learn": _tel_learn(torch, port, seed, phase7, tmp)}
        torch.cuda.empty_cache()
        out["engine"] = {
            tag: _tel_engine(torch, port, seed, phase10, tmp, tag)
            for tag in ("plain", "metrics", "slo_profiled")}
        out["engine"]["phase10_requests_per_sec"] = \
            phase10["bench"]["engine_requests_per_sec"]
        # phase 10's rate over its dispatches' summed walls: the
        # telemetry engines' dispatch_requests_per_sec compares with it
        bench10 = phase10["bench"]
        out["engine"]["phase10_dispatch_requests_per_sec"] = (
            1e3 * sum(bench10["dispatch_requests"])
            / sum(bench10["dispatch_ms"]))
        out["reconstruct"] = _tel_reconstruct(torch, port, seed, tmp)
        out["cli"] = _tel_cli(port, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[17] telemetry phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------
# 18: robustness (the watchdog, chaos faults, the degrade ladder, the
# supervisor, workload capture, the perf ledger)
# ---------------------------------------------------------------------

ROB_HANG_MIN_S = 3.0  # (c): the lowered CCSC_WATCHDOG_MIN_S
ROB_HANG_S = 6.0  # (c): the hang, a few seconds above it
ROB_HANG_SLACK = 2.0  # (c): a per-iteration budget under MIN_S
ROB_NAN_STEPS = 3  # (b)
ROB_SUP_NI = 4  # (d): images a block of the supervised learner
ROB_SUP_STEPS = 3
ROB_SUP_MIN_S = 5.0  # (d): the child's CCSC_WATCHDOG_MIN_S
# (e): the allocator cap, between the north star's peaks in the
# streaming device tier (~16.2 GiB) and in memory (~26.2 GiB)
ROB_OOM_CAP_GIB = 22.0
ROB_PREFLIGHT_GB = 1  # (e): the CCSC_INMEM_HBM_GB of the preflight run
# the child of (e): learn_2d under a capped allocator, its result and
# kernel counts as one JSON line
OOM_CHILD = """
import json, sys, time
import torch
torch.cuda.set_per_process_memory_fraction(float(sys.argv[1]))
from ccsc_code_iccv2017_torch.apps import learn_2d
from ccsc_code_iccv2017_torch.ops import fused_z, kernels
t0 = time.perf_counter()
res = learn_2d.main(sys.argv[2:])
tr = res.trace
print(json.dumps({"oom_child": {
    "wall_s": time.perf_counter() - t0,
    "algorithm": tr["algorithm"], "stream_mode": tr.get("stream_mode"),
    "degrades": tr.get("degrades"), "steps": len(tr["obj_vals_z"]) - 1,
    "max_memory_allocated": torch.cuda.max_memory_allocated(),
    "k1": kernels.solve_z_rank1.launches,
    "k2": [fused_z.fused_z_iter.launches_a, fused_z.fused_z_iter.launches_b],
}}))
"""


class _Env:
    """Set env knobs (None: unset) for a block; restore them after."""

    def __init__(self, **kv):
        self.kv = {k: None if v is None else str(v) for k, v in kv.items()}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        for k, v in self.kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rob_learn(torch, port, seed, steps, **cfg_kw):
    """Phase 7's learner (its data and seed) for ``steps`` steps with
    ``cfg_kw``: a dict of d (host), traces, step seconds, K2 launches,
    wall and the result's trace."""
    import numpy as np

    b = mesh_check.training_images(seed, LEARN_BLOCKS * LEARN_NI, LEARN_SIDE)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    cfg = _learn_cfg(port, num_blocks=LEARN_BLOCKS, max_it=steps,
                     fused_z=True, **cfg_kw)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fz = port["fused_z"].fused_z_iter
    fz.launches_a = fz.launches_b = 0
    t0 = time.perf_counter()
    res = port["consensus"].learn(b, geom, cfg, generator=gen, device="cuda")
    d = res.d.cpu().numpy()
    wall = time.perf_counter() - t0
    tr = res.trace
    return {"d": d, "wall_s": wall,
            "launches": [fz.launches_a, fz.launches_b],
            "traces": {k: tr[k] for k in ("obj_vals_d", "obj_vals_z",
                                           "d_diff", "z_diff")},
            "step_s": np.diff(tr["tim_vals"]).tolist(), "trace": tr}


def _bitwise(tag, run, ref_d, ref_traces):
    import numpy as np

    if not (np.array_equal(run["d"], ref_d) and run["traces"] == ref_traces):
        raise RuntimeError(
            f"{tag}: not bitwise phase 17's plain run: max|dd| "
            f"{float(np.abs(run['d'] - ref_d).max()):.3e}, traces "
            f"{run['traces']} vs {ref_traces}")


def _rob_watchdog(torch, port, seed, tel, ledger_path):
    """(a) the north star for TEL_STEPS steps: plain, armed, armed,
    plain (ABBA), the watchdog in event mode; each bitwise phase 17's
    plain run, no stall, K2 as often as plain. The second armed run also
    appends its ledger record for (g)."""
    import numpy as np

    wdmod = port["watchdog"]
    made = []
    real = wdmod.maybe_start

    def spy(*a, **kw):
        wd = real(*a, **kw)
        made.append(wd)
        return wd

    want = mesh_check.CFG["max_it_z"] * TEL_STEPS
    ref_d, ref_tr = tel["plain_d"], tel["runs"]["plain"]["traces"]
    runs = {}
    wdmod.maybe_start = spy
    try:
        for tag in ("plain", "armed", "armed_2", "plain_2"):
            armed = tag.startswith("armed")
            n0 = len(made)
            with _Env(CCSC_WATCHDOG_ACTION="event",
                      CCSC_PERF_LEDGER=(ledger_path if tag == "armed_2"
                                        else None)):
                run = _rob_learn(torch, port, seed, TEL_STEPS, watchdog=armed)
            _bitwise(f"(a) {tag}", run, ref_d, ref_tr)
            if run["launches"] != [want, want]:
                raise RuntimeError(f"(a) {tag}: K2 launches {run['launches']}")
            rec = {k: run[k] for k in ("wall_s", "launches", "step_s")}
            wds = made[n0:]
            if armed:
                wd = wds[0] if len(wds) == 1 else None
                if wd is None or wd.stalls or wd._fences != TEL_STEPS:
                    raise RuntimeError(f"(a) {tag}: watchdogs {wds}, stalls "
                                       f"{getattr(wd, 'stalls', None)}")
                rec.update(per_iter_s=wd.per_iter_s, stalls=wd.stalls,
                           fences=wd._fences, action=wd.action,
                           min_s=wd.min_s, compile_s=wd.compile_s,
                           steady_deadline_s=wd.timeout_for(1))
            elif wds != [None]:
                raise RuntimeError(f"(a) {tag}: watchdogs {wds}")
            runs[tag] = rec
            print(f"[18] (a) {tag}: {TEL_STEPS} steps, steps "
                  f"{[round(x, 4) for x in rec['step_s']]} s, K2 "
                  f"{rec['launches']}" + (
                      f"; deadline {rec['per_iter_s']:.3f} s an iteration "
                      f"(slack / the h100 bound), a steady fence "
                      f"{rec['steady_deadline_s']:.1f} s (MIN_S floor), the "
                      f"first {max(rec['min_s'], rec['per_iter_s']) + rec['compile_s']:.1f}"
                      f" s; {rec['stalls']} stalls" if armed else ""))
    finally:
        wdmod.maybe_start = real
    step = {arm: float(np.mean(runs[arm]["step_s"] + runs[f"{arm}_2"][
        "step_s"])) for arm in ("plain", "armed")}
    added = 1e3 * (step["armed"] - step["plain"])
    print(f"[18] (a) a step: {step['plain']:.4f} s plain, {step['armed']:.4f}"
          f" s armed (ABBA means, {added:+.2f} ms); every run bitwise phase "
          "17's plain run")
    return {"runs": runs, "mean_step_s": step, "watchdog_added_ms": added,
            "launches": sum(sum(r["launches"]) for r in runs.values())}


def _rob_nan(torch, port, seed, tmp):
    """(b) the north star for ROB_NAN_STEPS steps with the NaN fault at
    step 2 and one recovery; then a reduced size on the card and the
    CPU from one init."""
    import math

    import numpy as np

    faults = port["faults"]
    mdir, sdir = os.path.join(tmp, "b_metrics"), os.path.join(tmp, "b_state")
    faults.reset()
    with _Env(CCSC_FAULT_NAN_IT=2, CCSC_FAULT_STATE_DIR=sdir):
        run = _rob_learn(torch, port, seed, ROB_NAN_STEPS, max_recoveries=1,
                         metrics_dir=mdir)
    faults.reset()
    tr = run["trace"]
    _, by = _stream(port, mdir)
    fired = by.get("fault_fired", [])
    recs = by.get("recovery", [])
    want = mesh_check.CFG["max_it_z"] * (ROB_NAN_STEPS + 1)
    vals = [v for k in run["traces"] for v in run["traces"][k]]
    print(f"[18] (b) NaN at step 2: recoveries {tr.get('recoveries')}, "
          f"{len(fired)} fault_fired and {len(recs)} recovery records, K2 "
          f"{run['launches']} (want {want} each: a retried step)")
    if (len(tr.get("recoveries", [])) != 1
            or tr["recoveries"][0]["iteration"] != 2
            or [f["fault"] for f in fired] != ["nan"] or len(recs) != 1
            or len(tr["obj_vals_z"]) != ROB_NAN_STEPS + 1
            or run["launches"] != [want, want]
            or not all(math.isfinite(v) for v in vals)
            or not np.isfinite(run["d"]).all()):
        raise RuntimeError(f"(b) NaN recovery: {tr}, records {fired} {recs}")
    # reduced: phase 9's problem from one CPU init, card and CPU
    b = mesh_check.training_images(seed + 3, 4, 48)
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, 16)
    cfg = _learn_cfg(port, num_blocks=2, max_it=ROB_NAN_STEPS, fused_z=True,
                     max_recoveries=1)
    fg = port["common"].FreqGeom.create(geom, (48, 48))
    init = port["learn"].init_state(torch.Generator().manual_seed(seed), geom,
                                    fg, 2, 2)
    small = {}
    k2 = port["fused_z"].fused_z_iter
    a0, b0 = k2.launches_a, k2.launches_b
    for i, dev in enumerate(("cuda", "cpu")):
        faults.reset()
        with _Env(CCSC_FAULT_NAN_IT=2,
                  CCSC_FAULT_STATE_DIR=os.path.join(tmp, f"b_small_{i}")):
            small[dev] = port["consensus"].learn(b, geom, cfg, device=dev,
                                                 initial_state=init)
    faults.reset()
    small_launches = [k2.launches_a - a0, k2.launches_b - b0]
    if small["cuda"].trace["recoveries"] != small["cpu"].trace["recoveries"]:
        raise RuntimeError("(b) the reduced runs recovered differently")
    agree = _compare_learns("[18] (b) reduced NaN recovery card vs CPU",
                            small["cuda"], small["cpu"])
    return {"recoveries": tr["recoveries"], "fault_fired": len(fired),
            "recovery_records": len(recs), "launches": run["launches"],
            "wall_s": run["wall_s"], "reduced_card_vs_cpu": agree,
            "reduced_k2_launches": small_launches}


def _rob_hang(torch, port, seed, tel, tmp):
    """(c) a hang of ROB_HANG_S at step 1 under a watchdog in event mode
    whose deadline is ROB_HANG_MIN_S: one stall, the run completes
    bitwise."""
    faults = port["faults"]
    mdir = os.path.join(tmp, "c_metrics")
    faults.reset()
    with _Env(CCSC_FAULT_HANG_IT=1, CCSC_FAULT_HANG_S=ROB_HANG_S,
              CCSC_FAULT_STATE_DIR=os.path.join(tmp, "c_state"),
              CCSC_WATCHDOG_ACTION="event",
              CCSC_WATCHDOG_MIN_S=ROB_HANG_MIN_S,
              CCSC_WATCHDOG_COMPILE_S=0):
        run = _rob_learn(torch, port, seed, TEL_STEPS, watchdog=True,
                         watchdog_slack=ROB_HANG_SLACK, metrics_dir=mdir)
    faults.reset()
    _, by = _stream(port, mdir)
    stalls = by.get("stall", [])
    print(f"[18] (c) hang {ROB_HANG_S:g} s at step 1, MIN_S "
          f"{ROB_HANG_MIN_S:g} s: stalls {[s['label'] for s in stalls]}, "
          f"wall {run['wall_s']:.2f} s, K2 {run['launches']}")
    want = mesh_check.CFG["max_it_z"] * TEL_STEPS
    if [s["label"] for s in stalls] != ["ccsc_outer_0"] or \
            run["launches"] != [want, want]:
        raise RuntimeError(f"(c) stalls {stalls}, launches {run['launches']}")
    _bitwise("(c) hang", run, tel["plain_d"], tel["runs"]["plain"]["traces"])
    return {"stalls": len(stalls), "stall": stalls[0], "wall_s": run["wall_s"],
            "step_s": run["step_s"], "launches": run["launches"]}


def _child_env(**kv):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CCSC_FAULT_", "CCSC_WATCHDOG_"))}
    env.update(PYTHONPATH=HERE, **{k: str(v) for k, v in kv.items()})
    return env


def _run_child(cmd, env, timeout=600):
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    return proc, wall


def _mat_d(path):
    import scipy.io

    return scipy.io.loadmat(path)["d"]


def _rob_supervise(torch, port, seed, tmp):
    """(d) learn_2d at the north star's width (k=100 11x11, 8 blocks) on
    ROB_SUP_NI images a block under the supervisor: a hang at step 2
    (the watchdog aborts with 87, the supervisor resumes from the step-1
    checkpoint), and a SIGTERM at step 1 (checkpoint, exit 0, resume);
    both bitwise the unfaulted CLI run."""
    import numpy as np
    import scipy.io

    data = os.path.join(tmp, "d_data.mat")
    scipy.io.savemat(data, {"b": mesh_check.training_images(
        seed + 5, LEARN_BLOCKS * ROB_SUP_NI, LEARN_SIDE)})
    argv = ["--data", data, "--mat-layout", "framework", "--contrast", "none",
            "--filters", str(LEARN_K), "--support", str(LEARN_SUPPORT),
            "--blocks", str(LEARN_BLOCKS), "--fused-z", "--max-it",
            str(ROB_SUP_STEPS), "--tol", "0", "--verbose", "none",
            "--device", "cuda", "--seed", str(seed), "--checkpoint-every",
            "1"]
    ref_out = os.path.join(tmp, "d_ref.mat")
    t0 = time.perf_counter()
    port["learn_2d"].main(argv + ["--out", ref_out])
    ref_s = time.perf_counter() - t0
    ref = _mat_d(ref_out)
    out = {"unfaulted_in_process_s": ref_s}
    for tag, fault in (("hang", dict(CCSC_FAULT_HANG_IT=2,
                                     CCSC_FAULT_HANG_S=600,
                                     CCSC_WATCHDOG_MIN_S=ROB_SUP_MIN_S)),
                       ("sigterm", dict(CCSC_FAULT_SIGTERM_IT=1))):
        ck, m = os.path.join(tmp, f"d_{tag}_ck"), os.path.join(tmp,
                                                               f"d_{tag}_m")
        res_out = os.path.join(tmp, f"d_{tag}.mat")
        cmd = [sys.executable, "-m", f"{PACKAGE}.supervise",
               "--checkpoint-dir", ck, "--metrics-dir", m, "--max-restarts",
               "3", "--backoff", "0", "--",
               sys.executable, "-m", f"{PACKAGE}.apps.learn_2d", *argv,
               "--watchdog", "--checkpoint-dir", ck, "--metrics-dir", m,
               "--out", res_out]
        proc, wall = _run_child(cmd, _child_env(**fault))
        if proc.returncode != 0:
            raise RuntimeError(f"(d) {tag}: supervise exited "
                               f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        with open(os.path.join(m, "supervisor_trace.json")) as f:
            strace = json.load(f)
        attempts = [{k: a.get(k) for k in ("attempt", "reason", "rc",
                                           "start_t", "end_t",
                                           "checkpoint_at_start",
                                           "checkpoint_present")}
                    for a in strace["attempts"]]
        reasons = [a["reason"] for a in attempts]
        events, by = _stream(port, m)
        want = (["stall_abort", "completed"] if tag == "hang"
                else ["preempted", "completed"])
        d = _mat_d(res_out)
        gap = attempts[1]["start_t"] - attempts[0]["end_t"]
        print(f"[18] (d) supervised {tag}: attempts "
              f"{[(a['reason'], a['rc'], round(a['end_t'] - a['start_t'], 2)) for a in attempts]}"
              f", restart gap {gap:.3f} s, supervisor wall {wall:.1f} s; "
              f"filters bitwise the unfaulted run: {np.array_equal(d, ref)}")
        if reasons != want or (tag == "hang" and attempts[0]["rc"] != 87):
            raise RuntimeError(f"(d) {tag}: attempts {attempts}")
        if tag == "hang" and not by.get("stall"):
            raise RuntimeError("(d) hang: no stall record in the stream")
        if tag == "sigterm" and not by.get("preemption"):
            raise RuntimeError("(d) sigterm: no preemption record")
        if not np.array_equal(d, ref):
            raise RuntimeError(f"(d) {tag}: filters differ from the "
                               f"unfaulted run by "
                               f"{float(np.abs(d - ref).max()):.3e}")
        out[tag] = {"attempts": attempts, "supervisor_wall_s": wall,
                    "restart_gap_s": gap, "outcome": strace["outcome"],
                    "fault_fired": [e["fault"] for e in by.get(
                        "fault_fired", [])]}
    return out


def _rob_degrade(torch, port, seed, tmp):
    """(e) learn_2d --auto-degrade at the north star (8 x 100 images of
    100^2, 1 step) in a child whose allocator is capped at
    ROB_OOM_CAP_GIB: a real torch.OutOfMemoryError in the in-memory
    learner, the forensic dump, one degrade record (streaming,
    dispatch), and the run completes streamed, bitwise a direct
    learn_streaming run of the same tier; then CCSC_INMEM_HBM_GB=1 steps
    down at the preflight."""
    import numpy as np
    import scipy.io

    data = os.path.join(tmp, "e_data.mat")
    scipy.io.savemat(data, {"b": mesh_check.training_images(
        seed, LEARN_BLOCKS * LEARN_NI, LEARN_SIDE)})
    total = torch.cuda.get_device_properties(0).total_memory
    frac = ROB_OOM_CAP_GIB * 2**30 / total
    argv = ["--data", data, "--mat-layout", "framework", "--contrast", "none",
            "--filters", str(LEARN_K), "--support", str(LEARN_SUPPORT),
            "--blocks", str(LEARN_BLOCKS), "--fused-z", "--max-it", "1",
            "--tol", "0", "--verbose", "none", "--device", "cuda", "--seed",
            str(seed), "--auto-degrade"]
    out = {"cap_gib": ROB_OOM_CAP_GIB, "cap_fraction": frac}
    for tag, extra in (("oom", {}),
                       ("preflight", {"CCSC_INMEM_HBM_GB": ROB_PREFLIGHT_GB})):
        m = os.path.join(tmp, f"e_{tag}_m")
        res_out = os.path.join(tmp, f"e_{tag}.mat")
        cmd = [sys.executable, "-c", OOM_CHILD, repr(frac), *argv,
               "--metrics-dir", m, "--out", res_out]
        proc, wall = _run_child(
            cmd, _child_env(CCSC_STREAM_MODE="device", **extra))
        if proc.returncode != 0:
            raise RuntimeError(f"(e) {tag}: learn_2d exited "
                               f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        child = next(json.loads(x)["oom_child"] for x in
                     proc.stdout.splitlines() if x.startswith('{"oom_child"'))
        events, by = _stream(port, m)
        degr = by.get("degrade", [])
        dumps = by.get("mem_oom_dump", [])
        algos = [e["algorithm"] for e in by.get("run_meta", [])]
        t_meta = [e["t"] for e in by.get("run_meta", [])]
        rec = {"wall_s": wall, "child": child, "algorithms": algos,
               "degrades": degr, "oom_dumps": dumps,
               "streaming_start_after_first_s": (t_meta[-1] - t_meta[0]
                                                 if len(t_meta) > 1 else None)}
        print(f"[18] (e) {tag}: runs {algos}, degrade "
              f"{[(x['rung'], x['stage']) for x in degr]}, OOM dumps "
              f"{len(dumps)}, {child['algorithm']} tier "
              f"{child['stream_mode']}, peak "
              f"{child['max_memory_allocated'] / 2**30:.2f} GiB, K1 "
              f"{child['k1']}, K2 {child['k2']}, child wall {wall:.1f} s")
        if tag == "oom":
            ok = (algos == ["consensus", "consensus_streaming"]
                  and [(x["rung"], x["stage"]) for x in degr]
                  == [("streaming", "dispatch")]
                  and "out of memory" in degr[0]["error"].lower()
                  and len(dumps) == 1 and os.path.exists(dumps[0]["path"])
                  and [s["status"] for s in by.get("summary", [])]
                  == ["error", "ok"])
            if ok:
                with open(dumps[0]["path"]) as f:
                    dump = json.load(f)
                rec["oom_dump_error"] = dump["error"][:200]
                ok = dump["error"].startswith("OutOfMemoryError")
        else:
            ok = (algos == ["consensus_streaming"] and not dumps
                  and [(x["rung"], x["stage"]) for x in degr]
                  == [("streaming", "preflight")]
                  and child["max_memory_allocated"]
                  < out["oom"]["child"]["max_memory_allocated"] + 1)
        if not ok or child["algorithm"] != "consensus_streaming" or \
                child["stream_mode"] != "device":
            raise RuntimeError(f"(e) {tag}: {rec}")
        rec["d"] = np.asarray(port["io_mat"].load_filters_2d(res_out))
        out[tag] = rec
    # the direct streaming run of the same tier on the same data
    b = port["images"].load_images(data, contrast_normalize="none",
                                   zero_mean=True, square=True,
                                   mat_layout="framework")
    geom = port["config"].ProblemGeom((LEARN_SUPPORT,) * 2, LEARN_K)
    cfg = port["config"].LearnConfig(
        num_blocks=LEARN_BLOCKS, max_it=1, tol=0.0, verbose="none",
        fused_z=True)
    k1 = port["kernels"].solve_z_rank1
    k0 = k1.launches
    t0 = time.perf_counter()
    direct = port["streaming"].learn_streaming(
        b, geom, cfg, generator=torch.Generator().manual_seed(seed),
        stream_mode="device", device="cuda")
    out["direct_streaming_s"] = time.perf_counter() - t0
    out["direct_k1_launches"] = k1.launches - k0
    dd = direct.d.numpy()
    for tag in ("oom", "preflight"):
        d = out[tag].pop("d")
        same = d.shape == dd.shape and np.array_equal(d, dd)
        print(f"[18] (e) {tag}: filters bitwise the direct learn_streaming "
              f"run: {same}")
        if not same:
            raise RuntimeError(f"(e) {tag}: filters differ by "
                               f"{float(np.abs(d - dd).max()):.3e}")
    return out


def _rob_capture(torch, port, seed, phase10, tmp, ledger_path):
    """(f) phase 10's 42 requests through a 4-slot 256^2 engine with
    capture_dir (and the ledger of (g) armed): the capture's records,
    payloads and outcome digests, and a replay of the captured payloads
    under the captured solve params through a fresh engine, every
    result bitwise phase 10's."""
    import numpy as np

    bench, kernels, cap = port["serve_bench"], port["kernels"], \
        port["capture"]
    d = port["io_mat"].load_filters_2d(BANK)
    prob = port["reconstruct"].ReconstructionProblem(
        port["config"].ProblemGeom((11, 11), K))
    cfg = port["config"].SolveConfig(lambda_residual=5.0, lambda_prior=2.0,
                                     max_it=100, tol=1e-3)
    reqs = bench.make_requests(ENGINE_SIDES, seed + 4)
    cdir = os.path.join(tmp, "f_capture")
    with _Env(CCSC_PERF_LEDGER=ledger_path):
        eng = port["serve"].CodecEngine(d, prob, cfg, port["config"].ServeConfig(
            buckets=((ENGINE_SLOTS, (S, S)),), verbose="none",
            capture_dir=cdir), device="cuda")
    with eng:
        kernels.solve_z_rank1.launches = 0
        served, engine_s, submit_s = bench.run_engine(eng, reqs)
        launches = kernels.solve_z_rank1.launches
    rec = eng._capture
    log = eng.dispatch_log
    if launches != sum(e["iters"] for e in log):
        raise RuntimeError(f"(f) K1 {launches} for {[e['iters'] for e in log]}")
    for i, (s, r) in enumerate(zip(served, phase10["served"])):
        if not (np.array_equal(s.recon, r.recon)
                and int(s.trace.num_iters) == int(r.trace.num_iters)):
            raise RuntimeError(f"(f) request {i} differs from phase 10's")
    wl = sorted(cap.read_workload(cdir), key=lambda r: r["key"])
    meta = cap.read_meta(cdir)
    if len(wl) != len(reqs) or any(w["outcome"] is None for w in wl):
        raise RuntimeError(f"(f) {len(wl)} request records")
    fields = ("b", "mask", "smooth_init", "x_orig")
    for i, (w, q, s) in enumerate(zip(wl, reqs, served)):
        for f in fields:
            a = np.asarray(q[f], np.float32)
            if w[f] != cap.payload_sha(a) or not np.array_equal(
                    cap.load_payload(cdir, w[f]), a):
                raise RuntimeError(f"(f) request {i}: payload {f}")
        if w["outcome"]["digest"] != cap.payload_sha(s.recon):
            raise RuntimeError(f"(f) request {i}: outcome digest")
    solve = meta["solve"]
    print(f"[18] (f) capture: {len(wl)} request records (payload SHAs = the "
          f"inputs', load_payload round-trips, outcome digests = the "
          f"results'), {rec.n_payloads} payloads ({rec.n_dedup_hits} dedup "
          f"hits, {rec.payload_bytes / 2**20:.1f} MiB), capture overhead "
          f"{1e3 * rec.overhead_s / len(reqs):.3f} ms a request; K1 "
          f"{launches}; {len(reqs) / engine_s:.3f} requests/s vs phase 10's "
          f"{phase10['bench']['engine_requests_per_sec']:.3f}")
    # replay: the captured payloads, the captured solve params, a fresh
    # engine without capture
    rcfg = port["config"].SolveConfig(**solve)
    with port["serve"].CodecEngine(d, prob, rcfg, port["config"].ServeConfig(
            buckets=((ENGINE_SLOTS, (S, S)),), verbose="none",
            capture_dir=""), device="cuda") as reng:
        kernels.solve_z_rank1.launches = 0
        t0 = time.perf_counter()
        futs = [reng.submit(**{f: cap.load_payload(cdir, w[f])
                               for f in fields}) for w in wl]
        replayed = [fu.result(timeout=600) for fu in futs]
        replay_s = time.perf_counter() - t0
        r_launches = kernels.solve_z_rank1.launches
    if r_launches != sum(e["iters"] for e in reng.dispatch_log):
        raise RuntimeError("(f) replay K1 launches")
    for i, (s, r, w) in enumerate(zip(replayed, phase10["served"], wl)):
        if not (np.array_equal(s.recon, r.recon)
                and cap.payload_sha(s.recon) == w["outcome"]["digest"]):
            raise RuntimeError(f"(f) replayed request {i} differs")
    print(f"[18] (f) replay of the capture: {len(replayed)} results bitwise "
          f"phase 10's and their recorded digests; K1 {r_launches}")
    return {"requests": len(wl), "engine_requests_per_sec":
            len(reqs) / engine_s, "submit_wall_s": submit_s,
            "phase10_requests_per_sec":
            phase10["bench"]["engine_requests_per_sec"],
            "capture_overhead_ms_per_request":
            1e3 * rec.overhead_s / len(reqs),
            "payloads": rec.n_payloads, "dedup_hits": rec.n_dedup_hits,
            "payload_bytes": rec.payload_bytes, "k1_launches": launches,
            "replay_k1_launches": r_launches, "replay_s": replay_s,
            "solve": solve}


def _rob_ledger(port, ledger_path, tracked_before):
    """(g) the ledger (a)'s armed run and (f)'s engine appended to."""
    led = port["ledger"]
    L = led.Ledger(ledger_path)
    recs = L.read()
    kinds = sorted(r["kind"] for r in recs)
    learn = next((r for r in recs if r["kind"] == "learn"), {})
    verdicts = led.gate(L)
    tracked_after = _tracked_ledger_stat()
    print(f"[18] (g) ledger {ledger_path}: kinds {kinds}, learn record chip "
          f"{learn.get('chip')}, {learn.get('value', 0):.3f} it/s, "
          f"roofline_frac {learn.get('roofline_frac')}, peak "
          f"{learn.get('peak_hbm_bytes')} bytes; gate "
          f"{[(v['ok'], v['skipped']) for v in verdicts]}")
    if (kinds != ["learn", "warmup"] or learn.get("chip") != "h100"
            or not learn.get("roofline_frac")
            or not learn.get("peak_hbm_bytes")
            or not all(v["ok"] for v in verdicts) or len(verdicts) != 2
            or tracked_after != tracked_before):
        raise RuntimeError(f"(g) ledger {recs}, verdicts {verdicts}, the "
                           f"repo's ledger {tracked_before} -> "
                           f"{tracked_after}")
    return {"records": [{k: r.get(k) for k in (
        "chip", "kind", "workload", "shape_key", "value", "unit",
        "roofline_frac", "peak_hbm_bytes", "source")} for r in recs],
        "keys": [led.record_key(r) for r in recs], "gate": verdicts}


def _tracked_ledger_stat():
    p = os.path.join(HERE, "perf_ledger.jsonl")
    try:
        st = os.stat(p)
    except OSError:
        return None
    return [st.st_size, st.st_mtime_ns]


def phase_robustness(torch, port, seed, tel, phase10):
    """18: the robustness hooks on the card, (a)-(g)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ccsc-robustness-")
    ledger_path = os.path.join(tmp, "perf_ledger.jsonl")
    tracked = _tracked_ledger_stat()
    out, secs = {}, {}
    try:
        for key, fn in (
            ("watchdog", lambda: _rob_watchdog(torch, port, seed, tel,
                                               ledger_path)),
            ("nan_recovery", lambda: _rob_nan(torch, port, seed, tmp)),
            ("hang", lambda: _rob_hang(torch, port, seed, tel, tmp)),
            ("supervise", lambda: _rob_supervise(torch, port, seed, tmp)),
            ("degrade", lambda: _rob_degrade(torch, port, seed, tmp)),
            ("capture", lambda: _rob_capture(torch, port, seed, phase10, tmp,
                                             ledger_path)),
            ("ledger", lambda: _rob_ledger(port, ledger_path, tracked)),
        ):
            t1 = time.perf_counter()
            torch.cuda.empty_cache()
            out[key] = fn()
            secs[key] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t0
    print(f"[18] robustness phase {out['seconds']:.1f} s "
          f"({ {k: round(v, 1) for k, v in secs.items()} })")
    return out


# the serving fleet (19): phase 10's stream through a 2-replica
# ServeFleet whose replicas share cuda:0, under faults, overload, a hot
# swap and tenants, with its quality plane, endpoint and CLI
FLEET_REPLICAS = 2
FLEET_KILL_REQ = 6  # (b): replica 0 dies taking its 6th request
FLEET_HANG_REQ = 1  # (b): replica 1 hangs on its first request
FLEET_HANG_S = 10.0
# (b): the watchdog's floor and first-fence allowance. A replica's first
# fence, the hung one, gets MIN_S a request + COMPILE_S: 5 s for a batch
# of 4, whatever the host's pace (later fences calibrate on the measured
# one, which two replicas on one card under one GIL make vary by 2x)
FLEET_MIN_S = 1.0
FLEET_QUEUE_DEPTH = 8  # (c): the explicit admission ceiling
FLEET_SWAP_AT = 12  # (d): requests admitted before and after the swap
FLEET_BANK_NOISE = 0.05  # (d): the second bank's perturbation scale
FLEET_BURST_QUOTA = 4  # (e): the bursting tenant's quota
FLEET_PROBE_S = 1.0  # (f): the golden-probe sweep interval
FLEET_GRAY_REQS = 8  # (i): the gray replica's stream
# (i): replica 0's extra seconds a request, and the age past which an
# attempt is hedged: above a healthy attempt (a 4-request dispatch,
# 0.35-0.7 s with two replicas on the card), well below the gray
# replica's shortest (one request: FLEET_SLOW_S before its dispatch).
# Hedge clones queue behind the stream, which the healthy replica has
# drained by then, so a clone lands ~1 s before its original
FLEET_SLOW_S = 3.0
FLEET_HEDGE_MS = 1000.0
FLEET_ROT_REQS = 6  # (j): requests a phase of the rot episode


class _FleetEngines:
    """Every replica engine the fleets build while active (restarts
    included), so K1's launches can be held to the dispatch iterations
    of all of them: each engine built inside a counting window also ran
    one warm dispatch of one iteration per bucket."""

    def __init__(self):
        import importlib

        self.mod = importlib.import_module(f"{PACKAGE}.serve.fleet")
        self.engines = []

    def __enter__(self):
        self.orig = orig = self.mod.CodecEngine

        def build(*a, **kw):
            eng = orig(*a, **kw)
            self.engines.append(eng)
            return eng

        self.mod.CodecEngine = build
        return self

    def __exit__(self, *exc):
        self.mod.CodecEngine = self.orig

    def mark(self):
        return ({id(e): len(e.dispatch_log) for e in self.engines},
                len(self.engines))

    def expected_k1(self, mark, n_buckets=1):
        """The K1 launches since ``mark``: each engine's dispatch
        iterations after it, plus the warm dispatch of each engine built
        after it."""
        seen, n_built = mark
        its = sum(sum(e.dispatch_iters[seen.get(id(e), 0):])
                  for e in self.engines)
        return its + n_buckets * (len(self.engines) - n_built)


def _fleet(port, d, cfg, tmp, tag, **fkw):
    kw = dict(replicas=FLEET_REPLICAS, min_queue_depth=64, verbose="none",
              metrics_dir=os.path.join(tmp, tag))
    kw.update(fkw)
    prob = port["reconstruct"].ReconstructionProblem(
        port["config"].ProblemGeom((11, 11), K))
    return port["serve"].ServeFleet(
        d, prob, cfg, port["config"].ServeConfig(
            buckets=((ENGINE_SLOTS, (S, S)),), verbose="none"),
        port["config"].FleetConfig(**kw), device="cuda")


def _fleet_stream(fleet, reqs, prefix, idx=None, timeout=600, **kw):
    """Submit ``reqs`` at once under keys ``prefix<i>`` and wait for all:
    (results by index, the window's seconds, each request's submit to
    result seconds). ``Overloaded`` refusals are returned by index as the
    exception."""
    import threading

    ov = __import__(f"{PACKAGE}.serve", fromlist=["Overloaded"]).Overloaded
    idx = list(range(len(reqs))) if idx is None else idx
    t_sub, t_done, futs, refused = {}, {}, {}, {}
    lock = threading.Lock()

    def stamp(i):
        def cb(_f):
            with lock:
                t_done[i] = time.perf_counter()
        return cb

    t0 = time.perf_counter()
    for i in idx:
        t_sub[i] = time.perf_counter()
        try:
            futs[i] = fleet.submit(key=f"{prefix}{i}", **reqs[i], **kw)
        except ov as e:
            refused[i] = e
            continue
        futs[i].add_done_callback(stamp(i))
    res = {i: f.result(timeout=timeout) for i, f in futs.items()}
    window = time.perf_counter() - t0
    lat = {i: t_done[i] - t_sub[i] for i in res}
    res.update(refused)
    return res, window, lat


def _fleet_bitwise(tag, res, ref):
    """Every served result of ``res`` (index -> result) bitwise ``ref``'s
    result of the same index."""
    import numpy as np

    for i, r in res.items():
        if isinstance(r, Exception):
            continue
        if not (np.array_equal(r.recon, ref[i].recon)
                and int(r.trace.num_iters) == int(ref[i].trace.num_iters)):
            raise RuntimeError(f"[19] {tag}: request {i} is not bitwise "
                               "the single engine's")


def _pcts(vals):
    import numpy as np

    v = np.sort(np.asarray(list(vals), np.float64)) * 1e3
    return {"p50_ms": float(np.percentile(v, 50)),
            "p90_ms": float(np.percentile(v, 90)), "max_ms": float(v[-1])}


def _events(port, path, type_=None):
    recs = port["obs"].read_events(path, recursive=True)
    return [e for e in recs if type_ is None or e.get("type") == type_]


def _wait_for(pred, timeout, what):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"[19] timed out waiting for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _scrape(url):
    import urllib.request

    body = urllib.request.urlopen(url, timeout=10).read().decode()
    out = {}
    for line in body.splitlines():
        if line.startswith("ccsc_") and "{" not in line:
            name, _, val = line.partition(" ")
            out[name[len("ccsc_"):]] = float(val)
    return out


def _fleet_stream_part(torch, port, seed, phase10, tmp, log, d, cfg, reqs):
    """(a) the stream through fleet A (derived ceiling, endpoint on),
    then (d) its hot swap and (g) its endpoint, on the same fleet."""
    import numpy as np

    kernels, ref = port["kernels"], phase10["served"]
    t0 = time.perf_counter()
    fleet = _fleet(port, d, cfg, tmp, "a", metricsd_port=0)
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s}
    try:
        mark = log.mark()
        kernels.solve_z_rank1.launches = 0
        res, window, lat = _fleet_stream(fleet, reqs, "a")
        launches = kernels.solve_z_rank1.launches
        expected = log.expected_k1(mark)
        st = fleet.stats()
        served = [r["served"] for r in st["replicas"]]
        _fleet_bitwise("(a)", res, ref)
        if launches != expected:
            raise RuntimeError(f"[19] (a) K1 {launches} != the replicas' "
                               f"dispatch iterations {expected}")
        if st["n_requests"] != len(reqs) or sum(served) != len(reqs):
            raise RuntimeError(f"[19] (a) served {served}: {st}")
        p = _pcts(lat.values())
        out["stream"] = dict(
            requests=len(reqs), window_s=window,
            requests_per_sec=len(reqs) / window, k1_launches=launches,
            served_by_replica=served,
            dispatch_iters_by_engine=[e.dispatch_iters for e in log.engines],
            phase10_requests_per_sec=phase10["bench"][
                "engine_requests_per_sec"], **p)
        print(f"[19] (a) 2-replica fleet built in {build_s:.2f} s; "
              f"{len(reqs)} requests in {window * 1e3:.1f} ms = "
              f"{len(reqs) / window:.3f} requests/s (phase 10's engine "
              f"{out['stream']['phase10_requests_per_sec']:.3f}), latency "
              f"p50 {p['p50_ms']:.1f} ms, p90 {p['p90_ms']:.1f} ms, max "
              f"{p['max_ms']:.1f} ms; served by replica {served}; every "
              f"result bitwise phase 10's; K1 {launches} = the replicas' "
              "dispatch iterations")
        # (c) the derived ceiling: fleet_serving_bound over the replicas'
        # measured iteration rates, from the monitor's first derivation
        _wait_for(lambda: _events(port, os.path.join(tmp, "a"),
                                  "fleet_ceiling"), 30, "fleet_ceiling")
        ceil = _events(port, os.path.join(tmp, "a"), "fleet_ceiling")[-1]
        rates = [(e.last_it_rate, e.devices) for e in log.engines]
        bound = port["perfmodel"].fleet_serving_bound(
            rates, cfg.max_it, ENGINE_SLOTS)
        if ceil["source"] != "serving_bound":
            raise RuntimeError(f"[19] (c) ceiling record {ceil}")
        out["derived_ceiling"] = dict(
            ceiling=ceil["ceiling"],
            bound_requests_per_sec=ceil["bound_requests_per_sec"],
            live_replicas=ceil["live_replicas"],
            last_it_rates=[r for r, _ in rates],
            bound_now_requests_per_sec=bound["requests_per_sec"])
        print(f"[19] (c) derived ceiling {ceil['ceiling']} from "
              f"fleet_serving_bound {ceil['bound_requests_per_sec']:.3f} "
              f"requests/s over {ceil['live_replicas']} live replicas "
              f"(max_queue_s 2; now {bound['requests_per_sec']:.3f} at it/s "
              f"{[round(r, 1) for r, _ in rates]})")

        # (d) hot swap mid-stream to a second bank: a seeded perturbation
        # of the first, renormalized into the unit ball
        rng = np.random.default_rng(seed + 19)
        d2 = d + FLEET_BANK_NOISE * float(np.abs(d).max()) * \
            rng.standard_normal(d.shape).astype(np.float32)
        norms = np.sqrt((d2.reshape(K, -1) ** 2).sum(1))
        d2 = (d2 / np.maximum(norms, 1.0)[:, None, None]).astype(np.float32)
        digest = port["serve"].bank_digest
        old_dg, new_dg = digest(d), digest(d2)
        sub = reqs[:FLEET_SWAP_AT]
        mark = log.mark()
        kernels.solve_z_rank1.launches = 0
        t1 = time.perf_counter()
        pre = {i: fleet.submit(key=f"d-pre{i}", **q)
               for i, q in enumerate(sub)}
        swap = fleet.publish_bank(None, d2)
        swap_s = time.perf_counter() - t1
        post = {i: fleet.submit(key=f"d-post{i}", **q)
                for i, q in enumerate(sub)}
        pre = {i: f.result(timeout=600) for i, f in pre.items()}
        post = {i: f.result(timeout=600) for i, f in post.items()}
        d_launches = kernels.solve_z_rank1.launches
        if d_launches != log.expected_k1(mark):
            raise RuntimeError(f"[19] (d) K1 {d_launches}")
        if swap != (old_dg, new_dg):
            raise RuntimeError(f"[19] (d) publish_bank returned {swap}")
        _fleet_bitwise("(d) before the swap", pre, ref)
        prob = port["reconstruct"].ReconstructionProblem(
            port["config"].ProblemGeom((11, 11), K))
        with port["serve"].CodecEngine(d2, prob, cfg, port[
                "config"].ServeConfig(buckets=((ENGINE_SLOTS, (S, S)),),
                                      verbose="none"),
                device="cuda") as eng2:
            want = {i: f.result(timeout=600) for i, f in
                    {i: eng2.submit(**q) for i, q in enumerate(sub)}.items()}
        _fleet_bitwise("(d) after the swap (the new bank's engine)", post,
                       want)
        if any(np.array_equal(post[i].recon, pre[i].recon) for i in post):
            raise RuntimeError("[19] (d) a post-swap result equals the "
                               "old bank's")
        swaps = [e for e in _events(port, os.path.join(tmp, "a"),
                                    "bank_swap")
                 if e["replica_id"] is None]
        if [(e["old_digest"], e["new_digest"]) for e in swaps] != [swap]:
            raise RuntimeError(f"[19] (d) bank_swap records {swaps}")
        out["hot_swap"] = dict(old_digest=old_dg, new_digest=new_dg,
                               publish_s=swap_s, requests=2 * len(sub),
                               k1_launches=d_launches,
                               replicas=swaps[0]["replicas"])
        print(f"[19] (d) publish_bank mid-stream {old_dg[:12]} -> "
              f"{new_dg[:12]} in {swap_s:.3f} s across "
              f"{swaps[0]['replicas']} replicas: {len(sub)} requests "
              f"admitted before it bitwise phase 10's (old digest), "
              f"{len(sub)} after bitwise a fresh engine on the new bank; "
              f"one bank_swap record with both digests; K1 {d_launches}")

        # (g) the endpoint: MetricsD on 127.0.0.1:<ephemeral>, scraped
        st = fleet.stats()
        url = f"http://127.0.0.1:{fleet._metricsd.port}/metrics"
        got = _scrape(url)
        pairs = {"requests_total": st["n_requests"],
                 "rejected_total": st["n_rejected"],
                 "requeued_total": st["n_requeued"],
                 "duplicates_suppressed_total":
                     st["n_duplicates_suppressed"],
                 "failed_total": st["n_failed"],
                 "queue_depth": st["queue_depth"],
                 "queue_ceiling": st["queue_ceiling"],
                 "live_replicas": FLEET_REPLICAS}
        bad = {k: (got.get(k), v) for k, v in pairs.items()
               if got.get(k) != v}
        if bad:
            raise RuntimeError(f"[19] (g) scrape vs stats(): {bad}")
        out["metricsd"] = dict(port=fleet._metricsd.port, scraped={
            k: got[k] for k in pairs})
        print(f"[19] (g) MetricsD on 127.0.0.1:{fleet._metricsd.port}: "
              f"the scrape's counters equal stats() ({ {k: int(v) for k, v in pairs.items()} })")
        out["k1_launches"] = launches + d_launches
    finally:
        fleet.close(drain_timeout_s=120)
    return out


def _fleet_chaos(torch, port, phase10, tmp, log, d, cfg, reqs):
    """(b) kill on replica 0 and hang on replica 1, mid-stream."""
    kernels, faults = port["kernels"], port["faults"]
    mdir = os.path.join(tmp, "b")
    env = dict(CCSC_FAULT_ENGINE_KILL_REQ=FLEET_KILL_REQ,
               CCSC_FAULT_ENGINE_KILL_REPLICA=0,
               CCSC_FAULT_ENGINE_HANG_REQ=FLEET_HANG_REQ,
               CCSC_FAULT_ENGINE_HANG_REPLICA=1,
               CCSC_FAULT_ENGINE_HANG_S=FLEET_HANG_S,
               CCSC_FAULT_STATE_DIR=os.path.join(tmp, "b_faults"),
               CCSC_WATCHDOG_MIN_S=FLEET_MIN_S,
               CCSC_WATCHDOG_COMPILE_S=FLEET_MIN_S)
    with _Env(**env):
        faults.reset()
        fleet = _fleet(port, d, cfg, tmp, "b", restart_backoff_s=0.25)
        try:
            mark = log.mark()
            kernels.solve_z_rank1.launches = 0
            res, window, lat = _fleet_stream(fleet, reqs, "b")
            # the hung straggler wakes FLEET_HANG_S after its take and
            # delivers late: wait for its suppression and for both
            # casualties to serve again before the fleet closes
            _wait_for(lambda: _events(port, mdir,
                                      "fleet_duplicate_suppressed"),
                      FLEET_HANG_S + 60, "the straggler's suppression")
            _wait_for(lambda: all(
                r is not None and r["state"] == "live"
                for r in fleet.stats()["replicas"]), 60, "both replicas")
            launches_b = kernels.solve_z_rank1.launches
            expected = log.expected_k1(mark)
            st = fleet.stats()
        finally:
            fleet.close(drain_timeout_s=120)
            faults.reset()
    _fleet_bitwise("(b)", res, phase10["served"])
    if launches_b != expected:
        raise RuntimeError(f"[19] (b) K1 {launches_b} != {expected}")
    ev = _events(port, mdir)
    by = {}
    for e in ev:
        by.setdefault(e.get("type"), []).append(e)
    served = [e["key"] for e in by.get("fleet_request", [])]
    if sorted(served) != sorted(f"b{i}" for i in range(len(reqs))):
        raise RuntimeError(f"[19] (b) delivered keys {sorted(served)}")
    dead = {e["replica_id"]: e["reason"]
            for e in by.get("fleet_replica_dead", [])}
    if dead != {0: "crash", 1: "stall"}:
        raise RuntimeError(f"[19] (b) fleet_replica_dead {dead}")
    for t in ("fleet_requeue", "fleet_replica_restart",
              "fleet_replica_ready", "fleet_duplicate_suppressed"):
        if not by.get(t):
            raise RuntimeError(f"[19] (b) no {t} record")
    restart = {}
    for rid in (0, 1):
        t_dead = min(e["t"] for e in by["fleet_replica_dead"]
                     if e["replica_id"] == rid)
        t_rs = min(e["t"] for e in by["fleet_replica_restart"]
                   if e["replica_id"] == rid)
        t_ready = min(e["t"] for e in by["fleet_replica_ready"]
                      if e["replica_id"] == rid)
        restart[rid] = dict(build_s=t_ready - t_rs,
                            dead_to_ready_s=t_ready - t_dead)
    requeued = sum(1 for e in by["fleet_request"] if e["attempts"] > 1)
    out = dict(requests=len(reqs), window_s=window,
               requests_per_sec=len(reqs) / window, k1_launches=launches_b,
               requeues=len(by["fleet_requeue"]), requeued_delivered=requeued,
               duplicates_suppressed=len(by["fleet_duplicate_suppressed"]),
               restarts=restart, n_failed=st["n_failed"],
               **_pcts(lat.values()))
    print(f"[19] (b) chaos: replica 0 killed at its request "
          f"{FLEET_KILL_REQ}, replica 1 hung {FLEET_HANG_S:.0f} s at its "
          f"request {FLEET_HANG_REQ}: {len(reqs)} of {len(reqs)} keys "
          f"delivered once, bitwise phase 10's ({requeued} after a requeue, "
          f"{out['requeues']} fleet_requeue, {out['duplicates_suppressed']} "
          f"fleet_duplicate_suppressed); restart (restart -> ready) "
          f"{ {r: round(v['build_s'], 3) for r, v in restart.items()} } s, "
          f"dead -> ready "
          f"{ {r: round(v['dead_to_ready_s'], 3) for r, v in restart.items()} }"
          f" s; {len(reqs) / window:.3f} requests/s over the window; K1 "
          f"{launches_b} = every engine's dispatch iterations + the "
          "restarts' warm dispatches")
    return out


def _fleet_overload(torch, port, phase10, tmp, log, d, cfg, reqs):
    """(c) an explicit ceiling refuses the burst with Overloaded."""
    kernels = port["kernels"]
    mdir = os.path.join(tmp, "c")
    fleet = _fleet(port, d, cfg, tmp, "c", max_queue_depth=FLEET_QUEUE_DEPTH)
    try:
        mark = log.mark()
        kernels.solve_z_rank1.launches = 0
        res, window, lat = _fleet_stream(fleet, reqs, "c")
        _wait_for(lambda: fleet.overload_rung == "normal", 30,
                  "the ladder's return to normal")
        launches = kernels.solve_z_rank1.launches
        expected = log.expected_k1(mark)
        st = fleet.stats()
    finally:
        fleet.close(drain_timeout_s=120)
    refused = {i: e for i, e in res.items() if isinstance(e, Exception)}
    hints = [e.retry_after_s for e in refused.values()]
    _fleet_bitwise("(c)", res, phase10["served"])
    if launches != expected:
        raise RuntimeError(f"[19] (c) K1 {launches} != {expected}")
    trans = [(e["rung_from"], e["rung_to"])
             for e in _events(port, mdir, "fleet_overload")]
    rejects = _events(port, mdir, "fleet_admission_reject")
    if not (refused and all(h > 0 for h in hints)
            and st["n_rejected"] == len(refused) == len(rejects)
            and all(e["queue_depth"] <= FLEET_QUEUE_DEPTH for e in rejects)):
        raise RuntimeError(f"[19] (c) refusals {len(refused)}, hints "
                           f"{hints}, stats {st['n_rejected']}, records "
                           f"{len(rejects)}")
    if not trans or "reject" not in {t for _, t in trans} \
            or trans[-1][1] != "normal":
        raise RuntimeError(f"[19] (c) ladder transitions {trans}")
    out = dict(max_queue_depth=FLEET_QUEUE_DEPTH, admitted=len(res) -
               len(refused), refused=len(refused),
               retry_after_s=dict(min=min(hints), max=max(hints)),
               rungs=trans, k1_launches=launches)
    print(f"[19] (c) max_queue_depth {FLEET_QUEUE_DEPTH}: {out['refused']} "
          f"of {len(reqs)} refused with Overloaded (retry_after_s "
          f"{min(hints):.3f}..{max(hints):.3f}), {out['admitted']} admitted "
          f"and bitwise phase 10's; rung transitions {trans}; K1 {launches}")
    return out


def _fleet_tenants(torch, port, seed, phase10, tmp, log, d, cfg, reqs):
    """(e) two tenants with weights and a quota, then (f) the quality
    plane and the golden probes on the same fleet."""
    import numpy as np

    kernels, tcls = port["kernels"], port["config"].TenantSpec
    mdir = os.path.join(tmp, "e")
    pdir = os.path.join(tmp, "probes")
    tenants = (tcls(tenant="steady", weight=2.0, slo_p99_ms=60_000.0,
                    quota=64),
               tcls(tenant="burst", weight=1.0, quota=FLEET_BURST_QUOTA))
    lpath = os.path.join(tmp, "quality_ledger.jsonl")
    with _Env(CCSC_PERF_LEDGER=lpath, CCSC_QUALITY_DRIFT_WINDOW=3):
        fleet = _fleet(port, d, cfg, tmp, "e", tenants=tenants,
                       probe_dir=pdir, probe_interval_s=FLEET_PROBE_S)
    try:
        mark = log.mark()
        kernels.solve_z_rank1.launches = 0
        steady = [i for i in range(len(reqs)) if i % 2 == 0]
        burst = [i for i in range(len(reqs)) if i % 2 == 1]
        # the burst all at once, then the steady tenant's stream while
        # the burst is still queued; then both are waited for
        ov = port["serve"].Overloaded
        res_b, futs = {}, {}
        t1 = time.perf_counter()
        for i in burst:
            try:
                futs[i] = fleet.submit(key=f"burst{i}", tenant="burst",
                                       **reqs[i])
            except ov as e:
                res_b[i] = e
        res_s, window, lat = _fleet_stream(fleet, reqs, "steady",
                                           idx=steady, tenant="steady")
        res_b.update({i: f.result(timeout=600) for i, f in futs.items()})
        window = time.perf_counter() - t1
        # (f) the probe thread sweeps while the queue is idle: the first
        # sweep seals the probe's reference, the next judges it
        _wait_for(lambda: len(_events(port, mdir, "quality_probe")) >= 2,
                  60, "two probe sweeps")
        st = fleet.stats()
        launches = kernels.solve_z_rank1.launches
        expected = log.expected_k1(mark)
        with _Env(CCSC_PERF_LEDGER=lpath):
            rot = _fleet_rot(port, fleet, seed, d, cfg, lpath)
        rot["k1_launches"] = kernels.solve_z_rank1.launches - launches
        rot_expected = log.expected_k1(mark) - expected
    finally:
        fleet.close(drain_timeout_s=120)
    if rot["k1_launches"] != rot_expected:
        raise RuntimeError(f"[19] (j) K1 {rot['k1_launches']} != "
                           f"{rot_expected}")
    if launches != expected:
        raise RuntimeError(f"[19] (e) K1 {launches} != {expected}")
    refused = [i for i, r in res_b.items() if isinstance(r, Exception)]
    _fleet_bitwise("(e) burst", res_b, phase10["served"])
    _fleet_bitwise("(e) steady", res_s, phase10["served"])
    ts = st["tenants"]
    if not (refused and ts["burst"]["rejected"] == len(refused)
            and ts["steady"]["rejected"] == 0
            and ts["steady"]["delivered"] == len(steady)
            and ts["burst"]["delivered"] == len(burst) - len(refused)
            and all(ts[t]["p50_latency_s"] is not None
                    and ts[t]["p99_latency_s"] is not None
                    for t in ("steady", "burst"))):
        raise RuntimeError(f"[19] (e) tenants {ts}, refused {refused}")
    rej = _events(port, mdir, "tenant_reject")
    if {e["tenant"] for e in rej} != {"burst"} or len(rej) != len(refused):
        raise RuntimeError(f"[19] (e) tenant_reject records {rej}")
    out = {"tenants": ts, "burst_refused": len(refused),
           "k1_launches": launches,
           "requests_per_sec": (len(reqs) - len(refused)) / window,
           "steady_latency": _pcts(lat.values())}
    print(f"[19] (e) tenants steady (weight 2, quota 64) and burst (weight 1,"
          f" quota {FLEET_BURST_QUOTA}): burst refused {len(refused)} of "
          f"{len(burst)}, steady refused 0 of {len(steady)}; per-tenant SLO "
          f"histograms p50/p99 "
          f"{ {t: (round(1e3 * v['p50_latency_s'], 1), round(1e3 * v['p99_latency_s'], 1)) for t, v in ts.items()} }"
          f" ms; every result bitwise phase 10's; K1 {launches}")
    # (f) the quality records, fleet and replica scope
    ev = _events(port, mdir)
    kinds = {}
    for e in ev:
        if e.get("type", "").startswith("quality_"):
            kinds[e["type"]] = kinds.get(e["type"], 0) + 1
    probes = [e for e in ev if e["type"] == "quality_probe"
              and e["t"] < rot["t_rot"] and e["bank_id"] is None]
    stat = [p["status"] for p in probes]
    hist = [e for e in ev if e["type"] == "quality_histogram"
            and e["replica_id"] is None and e.get("tenant") == "steady"]
    if not (stat[0] == "reference" and "exact" in stat[1:]
            and set(stat) <= {"reference", "exact"}
            and kinds.get("quality_solve_diag") and hist):
        raise RuntimeError(f"[19] (f) probes {stat}, quality records {kinds}")
    ps = port["quality"].ProbeSet(pdir)
    if len(ps) != 1 or ps.reference(ps.probes()[0]["name"],
                                    probes[0]["digest"]) is None:
        raise RuntimeError("[19] (f) the probe store holds no sealed "
                           "reference")
    out["quality"] = dict(records=kinds, probe_statuses=stat,
                          probe_db=probes[0]["db"],
                          steady_median_db=hist[-1].get("p50_ms"))
    breach = [e for e in ev if e["type"] == "quality_probe_breach"
              and e["digest"] == rot["rot_digest"]]
    drift = [e for e in ev if e["type"] == "quality_drift"
             and e["digest"] == rot["rot_digest"]]
    if not (breach and drift):
        raise RuntimeError(f"[19] (j) probe breaches {breach}, drift {drift}")
    out["rot"] = dict(rot, probe_breaches=len(breach), drifts=len(drift))
    print(f"[19] (f) quality records {kinds}; probe sweeps {stat} (sealed "
          f"at {probes[0]['db']:.2f} dB, then judged exact); the steady "
          f"tenant's served median {hist[-1].get('p50_ms')} dB (histogram "
          "upper edge)")
    return out


def _fleet_gray(torch, port, phase10, tmp, log, d, cfg, reqs):
    """(i) a gray replica: replica 0 slow on every request (far under
    the watchdog floor), hedged attempts route around it."""
    kernels, faults = port["kernels"], port["faults"]
    mdir = os.path.join(tmp, "i")
    sub = reqs[:FLEET_GRAY_REQS]
    with _Env(CCSC_FAULT_ENGINE_SLOW_REQ=1, CCSC_FAULT_ENGINE_SLOW_S=
              FLEET_SLOW_S, CCSC_FAULT_ENGINE_SLOW_REPLICA=0,
              CCSC_FAULT_STATE_DIR=os.path.join(tmp, "i_faults")):
        faults.reset()
        fleet = _fleet(port, d, cfg, tmp, "i", hedge_after_ms=FLEET_HEDGE_MS,
                       hedge_max_frac=0.5, health_interval_s=0.01)
        try:
            mark = log.mark()
            kernels.solve_z_rank1.launches = 0
            res, window, lat = _fleet_stream(fleet, sub, "i")
            snap = fleet.control_snapshot()
        finally:
            # close joins the workers: the slow losers settle first
            fleet.close(drain_timeout_s=120)
            faults.reset()
        launches = kernels.solve_z_rank1.launches
    if launches != log.expected_k1(mark):
        raise RuntimeError(f"[19] (i) K1 {launches}")
    _fleet_bitwise("(i)", res, phase10["served"])
    ev = _events(port, mdir)
    keys = [e["key"] for e in ev if e["type"] == "fleet_request"]
    spawns = {e["key"] for e in ev if e["type"] == "hedge_spawn"}
    wins = {e["key"] for e in ev if e["type"] == "hedge_win"}
    losses = {e["key"] for e in ev if e["type"] == "hedge_lost"}
    dead = [e for e in ev if e["type"] in ("stall", "fleet_replica_dead")]
    # every won hedge's original is suppressed as hedge_lost when it
    # lands (close joins the slow worker); a clone that lost is one too
    if not (sorted(keys) == sorted(f"i{i}" for i in range(len(sub)))
            and spawns and len(spawns) <= 0.5 * len(sub) and wins
            and wins <= losses <= spawns and not dead):
        raise RuntimeError(f"[19] (i) keys {sorted(keys)}, hedges "
                           f"{spawns}, wins {wins}, lost {losses}, "
                           f"stalls/deaths {dead}")
    p = _pcts(lat.values())
    out = dict(requests=len(sub), slow_s=FLEET_SLOW_S,
               hedge_after_ms=FLEET_HEDGE_MS, hedges=len(spawns),
               hedge_wins=len(wins), hedge_lost=len(losses),
               gray_replicas=snap["gray_replicas"],
               requests_per_sec=len(sub) / window, k1_launches=launches,
               **p)
    print(f"[19] (i) gray replica 0 (+{FLEET_SLOW_S} s a request): "
          f"{len(spawns)} hedges after {FLEET_HEDGE_MS:.0f} ms, {len(wins)} "
          f"won by replica 1, {len(losses)} losers suppressed; {len(sub)} keys "
          f"delivered once, bitwise phase 10's; no stall; latency p50 "
          f"{p['p50_ms']:.1f} ms, max {p['max_ms']:.1f} ms; K1 {launches}")
    return out


def _fleet_rot(port, fleet, seed, d, cfg, lpath):
    """(j) bank rot on a fleet with probes and an armed ledger: a bank
    id published with the good bank, its served dB seeded as the
    ledger's quality history; then a degraded bank (every atom one
    blur) published on it. The probes flag the rot digest, the drift
    watch its served dB; the advisory names the good digest; swapping
    it back serves the pre-rot bits again."""
    import numpy as np

    quality, ledger = port["quality"], port["ledger"]
    geom = port["config"].ProblemGeom((11, 11), K)
    xs = [quality.synth_probe(d, (S, S), seed=300 + i)
          for i in range(FLEET_ROT_REQS)]

    def serve(tag):
        futs = [fleet.submit(x, x_orig=x, bank_id="bank-live",
                             key=f"rot-{tag}{i}") for i, x in enumerate(xs)]
        return [f.result(timeout=600) for f in futs]

    def probed(bank_id, digest):
        return any(e.get("bank_id") == bank_id and e.get("digest") == digest
                   for e in _events(port, fleet.fleet_cfg.metrics_dir,
                                    "quality_probe"))

    _, good = fleet.publish_bank("bank-live", d)
    pre = serve("pre")
    led = ledger.Ledger(lpath)
    for r in pre:
        rec = ledger.normalize_record(
            kind="quality", value=round(float(r.psnr), 4), unit="db",
            knobs={"bank": "bank-live"}, source="chip_smoke",
            **quality._quality_key_fields(geom, fleet.buckets, "cuda"))
        led.append(rec)
    # a probe sweep on the good digest links bank-live's standing
    # reference before the rot lands
    _wait_for(lambda: probed("bank-live", good), 60, "bank-live's probe")
    rng = np.random.default_rng(seed + 99)
    blur = np.ones((K, 11, 11), np.float32) + 0.01 * rng.standard_normal(
        (K, 11, 11)).astype(np.float32)
    rot = blur / np.linalg.norm(blur.reshape(K, -1), axis=1)[:, None, None]
    t_rot = time.time()
    _, rot_dg = fleet.publish_bank("bank-live", rot.astype(np.float32))
    detect_s = _wait_for(lambda: any(
        a["from_digest"] == rot_dg and a["reason"] == "probe"
        for a in fleet.quality_advice()), 60, "the rot's probe advisory")
    mid = serve("mid")
    _wait_for(lambda: any(
        e["digest"] == rot_dg for e in _events(
            port, fleet.fleet_cfg.metrics_dir, "quality_drift")), 30,
        "the drift watch's fire")
    advice = [a for a in fleet.quality_advice()
              if a["from_digest"] == rot_dg and a["reason"] == "probe"][0]
    _, back = fleet.publish_bank("bank-live", d)
    post = serve("post")
    for i, (a, b) in enumerate(zip(post, pre)):
        if not np.array_equal(a.recon, b.recon):
            raise RuntimeError(f"[19] (j) post-demotion request {i} is not "
                               "bitwise its pre-rot result")
    if advice["to_digest"] != good or back != good:
        raise RuntimeError(f"[19] (j) advisory {advice}, swap-back {back}")
    out = dict(good_digest=good, rot_digest=rot_dg, detect_s=detect_s,
               probe_interval_s=FLEET_PROBE_S, t_rot=t_rot,
               pre_db=[r.psnr for r in pre], rot_db=[r.psnr for r in mid])
    print(f"[19] (j) bank rot on bank-live ({good[:12]} -> {rot_dg[:12]}): "
          f"probe advisory after {detect_s:.2f} s (sweeps every "
          f"{FLEET_PROBE_S} s) naming {good[:12]}; served dB "
          f"{np.median(out['pre_db']):.2f} -> {np.median(out['rot_db']):.2f}"
          f" (median), quality_drift fired; swapped back, {len(post)} "
          "requests bitwise the pre-rot results")
    return out


def _fleet_app(port, seed, tmp):
    """(h) ``apps.serve --replicas 2`` as a child on phase 4's images."""
    import re

    import numpy as np
    import scipy.io

    b, _ = _images(port, seed)
    stack = os.path.join(tmp, "fleet_app_images.mat")
    scipy.io.savemat(stack, {"b": b})
    cmd = [sys.executable, "-m", f"{PACKAGE}.apps.serve", "--replicas", "2",
           "--data", stack, "--filters", BANK, "--bucket",
           f"{S}:{ENGINE_SLOTS}", "--metrics-dir",
           os.path.join(tmp, "h_metrics")]
    proc, wall = _run_child(cmd, _child_env(), timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"[19] (h) exit {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    got = [float(m.group(1)) for m in
           re.finditer(r"^  img\d+: .*PSNR ([0-9.]+) dB", proc.stdout, re.M)]
    # the app's baseline: its own masks (--seed 0) and smooth fill
    rng = np.random.default_rng(0)
    base = []
    for x in b:
        m = (rng.random(x.shape) < 0.5).astype(np.float32)
        sm = port["native"].smooth_fill_batch(x[None], m[None])[0]
        base.append(port["serve"].valid_region_psnr(sm, x, (R, R)))
    if len(got) != len(b) or not all(g > f for g, f in zip(got, base)) \
            or "over 2 replica(s)" not in proc.stdout:
        raise RuntimeError(f"[19] (h) PSNR {got} vs smooth fill {base}: "
                           f"{proc.stdout[-2000:]}")
    print(f"[19] (h) apps.serve --replicas 2 in a child: exit 0 in "
          f"{wall:.1f} s, PSNR {[round(v, 2) for v in got]} dB above the "
          f"smooth fill's {[round(v, 2) for v in base]}")
    return dict(wall_s=wall, psnr_db=got, smooth_fill_psnr_db=base,
                summary=[ln for ln in proc.stdout.splitlines()
                         if "replica(s)" in ln])


def phase_fleet(torch, port, time_ms, bw, flops, seed, phase10):
    """19: the serving fleet on one card, (a)-(h)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    card = port["serve_bench"].card_line()
    print(f"[19] card: {card}")
    bench = port["serve_bench"]
    d = port["io_mat"].load_filters_2d(BANK)
    cfg = port["config"].SolveConfig(lambda_residual=5.0, lambda_prior=2.0,
                                     max_it=100, tol=1e-3)
    reqs = bench.make_requests(ENGINE_SIDES, seed + 4)
    tmp = tempfile.mkdtemp(prefix="ccsc-fleet-")
    out, secs = {"card": card}, {}
    try:
        with _FleetEngines() as log:
            for key, fn in (
                ("stream", lambda: _fleet_stream_part(
                    torch, port, seed, phase10, tmp, log, d, cfg, reqs)),
                ("chaos", lambda: _fleet_chaos(
                    torch, port, phase10, tmp, log, d, cfg, reqs)),
                ("overload", lambda: _fleet_overload(
                    torch, port, phase10, tmp, log, d, cfg, reqs)),
                ("tenants", lambda: _fleet_tenants(
                    torch, port, seed, phase10, tmp, log, d, cfg, reqs)),
                ("gray", lambda: _fleet_gray(
                    torch, port, phase10, tmp, log, d, cfg, reqs)),
            ):
                t1 = time.perf_counter()
                torch.cuda.empty_cache()
                out[key] = fn()
                secs[key] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["app"] = _fleet_app(port, seed, tmp)
        secs["app"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # K1 at a replica dispatch's shape: the bucket's 4 slots of the
    # 266x134 spectrum
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(seed)
    args = _random_k1_args(torch, gen, ENGINE_SLOTS, K, F, False)
    out["k1_cases"] = [_k1_case(torch, port["kernels"], time_ms, bw, flops,
                                _card(torch), args, {"fleet": "replica"})]
    del args
    torch.cuda.empty_cache()
    out["k1_launches"] = sum(out[k]["k1_launches"] for k in
                             ("stream", "chaos", "overload", "tenants",
                              "gray")) + out["tenants"]["rot"]["k1_launches"]
    out["seconds_by_part"] = secs
    out["seconds"] = time.perf_counter() - t0
    print(f"[19] fleet phase {out['seconds']:.1f} s "
          f"({ {k: round(v, 1) for k, v in secs.items()} })")
    return out


def _kernel_entry(name, source, replaces, launches, kernel_ms, plain_ms,
                  bound, build_s, **extra):
    return dict(
        name=name, route="cuda", source=f"{PACKAGE}/csrc/{source}",
        replaces=replaces, launches=launches, ms=kernel_ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
        bound_by=bound["bound_by"], library_ms=None, build_s=build_s,
        **extra,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--against", metavar="DIR",
                   help="root of another checkout whose K1 phase 3 times "
                        "beside this one")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available — this script drives "
              "the port on an NVIDIA card", file=sys.stderr)
        return 2
    import importlib

    port = {
        name: importlib.import_module(f"{PACKAGE}.{mod}")
        for name, mod in (
            ("config", "config"), ("kernels", "ops.kernels"),
            ("fused_z", "ops.fused_z"), ("freq_solvers", "ops.freq_solvers"),
            ("reconstruct", "models.reconstruct"),
            ("learn", "models.learn"), ("common", "models.common"),
            ("consensus", "parallel.consensus"),
            ("streaming", "parallel.streaming"), ("native", "data.native"),
            ("io_mat", "utils.io_mat"), ("images", "data.images"),
            ("device", "utils.device"), ("serve", "serve"),
            ("serve_bench", "serve.bench"),
            ("poisson", "apps.poisson_2d"),
            ("learn_masked", "models.learn_masked"),
            ("fourier", "ops.fourier"), ("volumes", "data.volumes"),
            ("learn_2d", "apps.learn_2d"), ("learn_3d", "apps.learn_3d"),
            ("learn_4d", "apps.learn_4d"),
            ("learn_hyperspectral", "apps.learn_hyperspectral"),
            ("deblur_video", "apps.deblur_video"),
            ("demosaic_hyperspectral", "apps.demosaic_hyperspectral"),
            ("view_synthesis", "apps.view_synthesis"),
            ("mesh", "parallel.mesh"), ("distributed", "parallel.distributed"),
            ("obs", "utils.obs"), ("obs_schema", "analysis.obs_schema"),
            ("trace", "utils.trace"), ("slo", "serve.slo"),
            ("profile_solve", "profile_solve"),
            ("watchdog", "utils.watchdog"), ("faults", "utils.faults"),
            ("capture", "serve.capture"), ("ledger", "analysis.ledger"),
            ("perfmodel", "utils.perfmodel"), ("quality", "serve.quality"),
        )
    }

    t_start = time.perf_counter()
    smi, name = phase_environment(torch, port["device"].device_report,
                                  port["serve_bench"].card_line)
    bw, flops = _datasheet(name)
    build = phase_build(port["kernels"], port["native"])
    time_ms = port["device"].device_time_ms
    cases = phase_kernel_vs_plain(
        torch, port["kernels"], time_ms, bw, flops, args.seed,
        _load_kernels(args.against) if args.against else None)
    app_cases = phase_k1_app_shapes(torch, port, time_ms, bw, flops,
                                    args.seed)
    served = phase_serve(torch, port, args.seed)
    agree = phase_card_vs_cpu(torch, port, served.pop("data"))
    k2 = phase_k2_vs_plain(torch, port, bw, flops, args.seed)
    learn = phase_learn(torch, port, args.seed)
    fused_vs_comp = phase_fused_vs_composition(torch, port, args.seed)
    learn_agree = phase_learn_card_vs_cpu(torch, port, args.seed)
    engine = phase_engine(torch, port, args.seed)
    apps = phase_apps(torch, port, time_ms, bw, args.seed)
    learners = phase_learners(torch, port, time_ms, bw, flops, args.seed)
    streamed = phase_streaming(
        torch, port, time_ms, bw, flops, args.seed,
        learners["3d"]["max_memory_allocated_bytes"],
        build["native_ccsc_data"])
    mesh = phase_mesh(torch, port, time_ms, bw, flops, args.seed)
    serve_mesh = phase_serve_mesh(torch, port, time_ms, bw, flops,
                                  args.seed)
    telemetry = phase_telemetry(torch, port, args.seed, learn, engine)
    robust = phase_robustness(torch, port, args.seed, telemetry["learn"],
                              engine)
    fleet = phase_fleet(torch, port, time_ms, bw, flops, args.seed, engine)
    engine.pop("served")
    telemetry["learn"].pop("plain_d")
    seconds = time.perf_counter() - t_start
    print(f"[14] total {seconds:.1f} s")

    main_case = next(c for c in cases if c["n"] == 1 and not c["raised_row"])
    all_cases = cases + list(app_cases.values()) + [
        learners["3d"]["k1_case"], streamed["2d"]["k1_case"],
        streamed["3d"]["k1_case"]] + mesh["reconstruct"]["k1_cases"] + \
        serve_mesh["k1_cases"] + fleet["k1_cases"]
    k1_paths = {"reconstruct": served["launches"],
                "engine": engine["launches"],
                "poisson": apps["poisson"]["k1_launches"],
                "deblur": apps["deblur_video"]["k1_launches"],
                "learn_3d": learners["3d"]["launches"]["solve_z_rank1"],
                "learn_2d_masked":
                    learners["2d_masked"]["launches"]["solve_z_rank1"],
                "learn_streaming_2d": streamed["2d"]["launches"],
                "learn_streaming_3d":
                    streamed["3d"]["launches"]["solve_z_rank1"],
                "mesh_reconstruct": mesh["reconstruct"]["k1_launches"],
                "mesh_learn_freq": sum(
                    mesh["learners"]["block2_freq2"]["k1_launches"]),
                "serve_mesh": serve_mesh["k1_launches"],
                "learn_2d_256_gate": sum(
                    serve_mesh["fused_gate"]["launches"][k][0]
                    for k in ("fused_z_true", "fused_z_false")),
                "telemetry_engine": sum(
                    r["k1_launches"] for k, r in telemetry["engine"].items()
                    if isinstance(r, dict)),
                "telemetry_reconstruct": sum(
                    telemetry["reconstruct"][k]["k1_launches"]
                    for k in ("plain", "metrics")),
                "capture_engine": robust["capture"]["k1_launches"],
                "capture_replay": robust["capture"]["replay_k1_launches"],
                "degrade_streaming_cli":
                    robust["degrade"]["oom"]["child"]["k1"]
                    + robust["degrade"]["preflight"]["child"]["k1"],
                "degrade_streaming_direct":
                    robust["degrade"]["direct_k1_launches"],
                "fleet": fleet["k1_launches"]}
    ns_ranks = mesh["north_star"]["mesh"]["per_rank"]
    k2_paths = {p: {
        "learn": learn["launches"][f"fused_z_{p}"],
        "learn_telemetry": sum(r["launches"][i] for r in
                               telemetry["learn"]["runs"].values()),
        "mesh_learn_block4": sum(r["launches"][i] for r in ns_ranks),
        "mesh_learn_nccl1": mesh["nccl_world_1"]["k2_launches"][i],
        "learn_watchdog": sum(r["launches"][i] for r in
                              robust["watchdog"]["runs"].values()),
        "learn_nan_recovery": robust["nan_recovery"]["launches"][i]
        + robust["nan_recovery"]["reduced_k2_launches"][i],
        "learn_hang": robust["hang"]["launches"][i],
    } for i, p in enumerate(("pass_a", "pass_b"))}
    k2_rank = next(c for c in k2["cases"] if c.get("mesh"))
    k2_rank_shape = {k: k2_rank[k] for k in ("N", "K", "Sy", "Sx", "dtype")}
    k2_err = {
        "max_abs_err": max(c["z_max_abs_err"] for c in k2["cases"]),
        "max_rel_err": max(c["z_rel_err"] for c in k2["cases"]),
        "cases": k2["cases"],
    }
    kernels_line = {"kernels": [
        _kernel_entry(
            "solve_z_rank1", "solve_z_rank1.cu",
            "ccsc_code_iccv2017_tpu/ops/pallas_kernels.py:51",
            sum(k1_paths.values()), main_case["kernel_ms"],
            main_case["plain_ms"], main_case,
            build["solve_z_rank1"]["seconds"],
            launches_by_path=k1_paths,
            max_abs_err=max(c["max_abs_err"] for c in all_cases),
            max_rel_err=max(c["max_rel_err"] for c in all_cases),
            cases=all_cases,
        ),
    ] + [
        _kernel_entry(
            f"fused_z_{p}", "fused_z.cu",
            f"ccsc_code_iccv2017_tpu/ops/pallas_fused_z.py:{line}",
            sum(k2_paths[p].values()),
            k2["timing"][p]["kernel_ms"], k2["timing"][p]["plain_ms"],
            k2["timing"][p], build["fused_z"]["seconds"],
            max_abs_err=k2_err["max_abs_err"],
            max_rel_err=k2_err["max_rel_err"],
            timing_shape=k2["timing"]["shape"],
            composition_iter_ms=k2["timing"]["composition_iter_ms"],
            formulation_ops_ms=k2["timing"][p]["formulation_ops_ms"],
            launches_by_path=k2_paths[p],
            mesh_rank_timing=dict(shape=k2_rank_shape, **k2_rank[p]),
        )
        for p, line in (("pass_a", 235), ("pass_b", 280))
    ]}
    kernels_line["kernels"][1]["cases"] = k2_err["cases"]
    kernels_line["kernels"][1]["whole_plane_vs_f64"] = k2["whole_plane"]
    print(json.dumps({"slice": dict(served, card_vs_cpu=agree)}))
    print(json.dumps({"learn": dict(
        learn, fused_vs_composition=fused_vs_comp, card_vs_cpu=learn_agree,
        k2_formulas=k2["timing"]["formulas"], seconds=seconds,
    )}))
    print(json.dumps({"serve_engine": engine}))
    print(json.dumps({"apps": dict(apps, k1_app_shapes=app_cases)}))
    print(json.dumps({"learners": learners}))
    print(json.dumps({"streaming": streamed}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"serve_mesh": serve_mesh}))
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"robustness": robust}))
    print(json.dumps({"serve_fleet": fleet}))
    # the kernels line last but two: the end of the output carries it
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
